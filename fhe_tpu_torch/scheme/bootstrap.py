"""Bootstrapping — counterpart of ``fhe_tpu/scheme/bootstrap.py``.

The pipeline extract_lsb -> blind_rotate -> modulus_raise -> key_switch,
with the same arithmetic as the JAX package:

  * ``extract_payload`` / ``extract_lsb`` move a w-bit payload in the
    constant coefficient to the top bits, round the RLWE pair to the small
    modulus 2n exactly (``rns.decrypt_scale`` at t = 2n) and sample-extract
    coefficient ``index`` as an LWE sample over Z_2n.
  * ``blind_rotate`` multiplies a trivial encryption of a test polynomial
    by X^{-phase}, one secret coefficient at a time: two CMUX gates per
    coefficient (s = s+ - s-), each an RGSW external product.  The gadget
    is the per-prime RNS digit decomposition of relinearization, so an
    external product INTT(sum_j NTT([d_j]_{p_i}) ⊙ row_j) over the 2kl
    digits of both accumulator components is exactly the function of the
    key-switch kernel: ``_external_product`` is one ``keyswitch_fused``
    launch (B7's classic lane), or one ``keyswitch_fused_batch`` launch for
    B accumulators sharing the key (B12).  The digits are the classic per-prime ones at every
    ks_omega, as in the JAX package.
  * ``bootstrap_binary``, ``bootstrap_lut`` (the programmable bootstrap)
    and ``bootstrap_binary_batch`` compose the steps; a leveled input is
    raised back to level 0 (``bfv.modulus_raise``, then the q_drop scalar
    multiply) before the final key switch.

The CMUX's rotation by X^{±a_j} (a gather from the negacyclic extension
[x, -x]), the subtraction, the digits and the addition are elementwise
torch ops around each kernel launch, as the JAX package computes them in
jnp.  The rotation loop runs on the host: n steps, one per secret
coefficient, of two CMUX gates, so a bootstrap launches the key-switch
kernel 2n + 1 times (the last the final key switch).  It reads the LWE mask
to the host once per call (it is public).

Randomness: ``make_bootstrap_key`` and ``keyswitch_keygen`` draw from a
``torch.Generator`` and call ``make_bootstrap_key_from_noise`` /
``keyswitch_keygen_from_noise``, which take the draws as arguments so that
the JAX package's draws can be fed in.  With ``bsk`` and ``ks_keys`` given
the pipeline draws nothing.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import ntt_cuda
from ..ops import poly as _poly
from ..ops import rns as _rns
from ..ops import sampling
from . import bfv as _bfv
from . import noise as _noise
from .context import SchemeContext
from .types import BootstrapKey, Ciphertext, LWECiphertext, SecretKey


# ---------------------------------------------------------------------------
# extract_lsb
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _small_mod_cached(primes: tuple[int, ...], two_n: int, gamma: int,
                      device: torch.device) -> _rns.DecryptConsts:
    return _rns._consts(_rns.DecryptConsts, _rns._decrypt_host(primes, two_n, gamma),
                        _rns.ARRAY_FIELDS, device)


def _small_mod_consts(ctx: SchemeContext, level: int) -> _rns.DecryptConsts:
    """decrypt_scale constants rounding q_level -> 2n (the gamma-trick
    decryption at t = 2n), made once per (level, device).  ``rns.make_decrypt``
    would refuse t = 2n, below the plaintext moduli it checks for."""
    primes_l = tuple(int(p) for p in ctx.params.q_primes[:ctx.k - level])
    return _small_mod_cached(primes_l, 2 * ctx.n, int(ctx.params.gamma), ctx.device)


def extract_lsb(ctx: SchemeContext, ct: Ciphertext, index: int = 0) -> LWECiphertext:
    """RLWE -> LWE over Z_2n of a bit: ``extract_payload`` with w = 1."""
    return extract_payload(ctx, ct, 1, index)


def extract_payload(ctx: SchemeContext, ct: Ciphertext, payload_bits: int = 1,
                    index: int = 0) -> LWECiphertext:
    """RLWE -> LWE over Z_2n carrying a w-bit payload in the top bits:

    1. multiply by floor(t / 2^w), which moves a plaintext m in [0, 2^w)
       from the Delta position to the top: phase ~ (q/2^w) m;
    2. round both components exactly to the modulus 2n;
    3. extract coefficient ``index``: b = c0[index], and a_i = c1[index - i]
       for i <= index, -c1[n + index - i] for i > index (the negacyclic
       wrap), in one gather.

    w = 1 is the binary pipeline; a wider w feeds ``bootstrap_lut``."""
    n = ctx.n
    ct = _bfv.to_coeff(ctx, ct)
    if ct.num_components != 2:
        raise ValueError(f"extract needs a 2-component ciphertext, got {ct.num_components}")
    if not 0 <= index < n:
        raise ValueError(f"index {index} outside [0, {n})")
    half_t = ctx.params.t >> payload_bits
    if half_t <= 0:
        raise ValueError("payload wider than the plaintext modulus")
    tb = _bfv._tb(ctx, ct.level)
    scaled = _poly.mul_scalar(ct.data, half_t, tb)
    small = _rns.decrypt_scale(scaled, _small_mod_consts(ctx, ct.level))   # [2, n] mod 2n
    i = torch.arange(n, device=small.device)
    a = small[1].index_select(0, (index - i) % n)
    a = torch.where(i > index, (2 * n - a) % (2 * n), a)
    return LWECiphertext(a=a, b=small[0, index])


# ---------------------------------------------------------------------------
# RGSW bootstrap keys
# ---------------------------------------------------------------------------


def _draw_count(ctx: SchemeContext, level: int) -> int:
    """RLWE rows of a bootstrap key: n coefficients x 2 signs x 2kl rows."""
    return ctx.n * 2 * 2 * (ctx.k - level)


def make_bootstrap_key_from_noise(ctx: SchemeContext, sk: SecretKey, a: torch.Tensor,
                                  e: torch.Tensor, level: int = 0) -> BootstrapKey:
    """RGSW(s+_j), RGSW(s-_j) for every secret coefficient j at ``level``,
    from explicit draws a (uniform) and e (Gaussian), [kl, n*2*2kl, n]
    residues of the level's primes in the JAX package's order (row
    (j*2 + sign)*2kl + r).

    Row r < kl of coefficient j multiplies acc0's digit r and encrypts
    bit * W_r; row kl + r multiplies acc1's digit r and encrypts
    bit * W_r * s, W_r = q_l / q_r: together an external product gives
    bit * (acc0 + acc1 * s) plus gadget noise.  The bits come from the
    first prime's residues of s (1 -> s+, p0 - 1 -> s-)."""
    n = ctx.n
    tb = _bfv._tb(ctx, level)
    kl, rows, total = tb.k, 2 * tb.k, _draw_count(ctx, level)
    if a.shape != (kl, total, n) or e.shape != a.shape:
        raise ValueError(f"bootstrap key draws {list(a.shape)} and {list(e.shape)}, "
                         f"expected [{kl}, {total}, {n}]")
    primes_l = tb.primes
    q_l = math.prod(primes_l)
    p3, p64 = _bfv._p3(tb), tb.p.to(torch.int64).view(-1, 1, 1)
    sk_l = sk.data[:kl]
    s_coeff = _bfv._inv_q(ctx, sk_l, level)[:, 0]                      # [kl, n]
    pos_bits = (s_coeff[0] == 1).to(torch.int32)
    neg_bits = (s_coeff[0] == primes_l[0] - 1).to(torch.int32)
    # targets [kl, 2kl, n]: W_r mod p_i (a constant transforms to itself),
    # then W_r * s in NTT form
    w = torch.tensor([[q_l // pd % pi for pd in primes_l] for pi in primes_l],
                     dtype=torch.int64, device=tb.device)[:, :, None]   # [kl, kl, 1]
    tgt = torch.cat([w.expand(kl, kl, n), w * sk_l.to(torch.int64) % p64],
                    dim=1).to(torch.int32)
    # b = e - a*s in NTT form, in four chunks of rows to bound the int64
    # temporaries
    a_ntt = _bfv._fwd_q(ctx, a.contiguous(), level)
    b_ntt = _bfv._fwd_q(ctx, e.contiguous(), level)
    step = -(-total // 4)
    for c in range(0, total, step):
        rs = slice(c, c + step)
        b_ntt[:, rs] = mm.sub_mod(b_ntt[:, rs], _ntt.pointwise_mul(
            a_ntt[:, rs], sk_l.expand(kl, a_ntt[:, rs].shape[1], n), tb), p3)
    b5 = b_ntt.view(kl, n, 2, rows, n)
    a5 = a_ntt.view(kl, n, 2, rows, n)
    p4 = tb.p.view(-1, 1, 1, 1)

    def pack(sign: int, bits: torch.Tensor) -> torch.Tensor:
        b = mm.add_mod(b5[:, :, sign], tgt[:, None] * bits.view(1, n, 1, 1), p4)
        return torch.stack([b.permute(1, 2, 0, 3), a5[:, :, sign].permute(1, 2, 0, 3)],
                           dim=3)                                   # [n, 2kl, kl, 2, n]

    return BootstrapKey(pos=pack(0, pos_bits), neg=pack(1, neg_bits), level=level)


def make_bootstrap_key(ctx: SchemeContext, gen: torch.Generator, sk: SecretKey,
                       level: int = 0) -> BootstrapKey:
    """``make_bootstrap_key_from_noise`` with the port's samplers."""
    tb = _bfv._tb(ctx, level)
    total = _draw_count(ctx, level)
    a = sampling.uniform_rns(gen, tb.p, total, ctx.n)
    e = sampling.gaussian_rns(gen, tb.p, ctx.params.security.sigma, total, ctx.n)
    return make_bootstrap_key_from_noise(ctx, sk, a, e, level)


# ---------------------------------------------------------------------------
# external product / CMUX / blind rotation
# ---------------------------------------------------------------------------


def _keys_t(rows: torch.Tensor) -> torch.Tensor:
    """[2kl, kl, 2, n] RGSW rows as the [kl, 2kl, 2, n] prime-major view the
    key-switch kernels read in place."""
    return rows.permute(1, 0, 2, 3)


@functools.lru_cache(maxsize=8)
def _shift_table(n: int, device: torch.device) -> torch.Tensor:
    """[2n, n] int64: row r holds (j - r) mod 2n, the gather that takes x *
    X^r from the negacyclic extension [x, -x] of x (X^n = -1)."""
    j = torch.arange(n, device=device)
    r = torch.arange(2 * n, device=device)
    return (j[None] - r[:, None]) % (2 * n)


def _extend(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[x, p - x] along the last axis; the negated half is unreduced (p where
    x = 0), which every caller reduces."""
    return torch.cat([x, p - x], dim=-1)


def _monomial_mul(x: torch.Tensor, r: int, n: int, p: torch.Tensor) -> torch.Tensor:
    """x * X^r in Z_p[X]/(X^n + 1) for a host int r in [0, 2n): out[..., j] =
    x[..., (j - r) mod n], negated where (j - r) mod 2n >= n."""
    g = _extend(x, p).index_select(-1, _shift_table(n, x.device)[r])
    return torch.remainder(g, p)


def _monomial_mul_batch(x: torch.Tensor, r: torch.Tensor, n: int,
                        p: torch.Tensor) -> torch.Tensor:
    """x * X^{r_b} per sample: x [..., B, C, n], r [B] in [0, 2n) on x's
    device, through one gather with a [B, n] index."""
    idx = _shift_table(n, x.device).index_select(0, r.to(torch.int64))
    g = torch.gather(_extend(x, p), -1, idx[:, None].expand(x.shape))
    return torch.remainder(g, p)


def _cmux_consts(tb: _ntt.NTTTables, inv_qhat: torch.Tensor,
                 ndim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The primes and (q_l/q_j)^-1 (int64) shaped for a component-major
    accumulator of ``ndim`` dimensions, made once per rotation."""
    shape = (1, -1) + (1,) * (ndim - 2)
    return tb.p.view(shape), inv_qhat.to(torch.int64).view(shape)


def _external_product(x: torch.Tensor, keys_t: torch.Tensor, tb: _ntt.NTTTables,
                      p: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """x (x) RGSW: x [2, kl, *B, n] component-major in the coefficient
    domain, residues in (-p, p], against the rows as the [kl, 2kl, 2, n]
    view ``_keys_t`` gives -> [2, kl, *B, n] in [0, p).  The digits
    [x * (q_l/q_j)^-1]_{q_j} of both components, in the order (component,
    digit), go through one keyswitch_fused launch, or one
    keyswitch_fused_batch launch for B accumulators sharing the key; p and
    inv come from ``_cmux_consts``."""
    d = torch.remainder(x * inv, p).to(torch.int32)
    if x.dim() == 3:
        out = ntt_cuda.keyswitch_fused(d.reshape(2 * tb.k, -1), keys_t, tb)
    else:
        out = ntt_cuda.keyswitch_fused_batch(d.reshape(2 * tb.k, *x.shape[2:]), keys_t, tb)
    return out.transpose(0, 1)


def _cmux(acc: torch.Tensor, idx: torch.Tensor, keys_t: torch.Tensor,
          tb: _ntt.NTTTables, p: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """One CMUX gate on the component-major accumulator acc [2, kl, *B, n]:
    acc + (acc * X^r - acc) (x) RGSW, idx the gather of X^r ([n], or
    [B, n] per sample).  The difference is left unreduced: its digits are
    those of the reduced one (the map is linear mod q_j)."""
    ext = _extend(acc, p)
    if idx.dim() == 1:
        rot = ext.index_select(-1, idx)
    else:
        rot = torch.gather(ext, -1, idx.expand(acc.shape))
    return torch.remainder(acc + _external_product(rot - acc, keys_t, tb, p, inv), p)


def _rotation_budget(ctx: SchemeContext, level: int) -> float:
    lv = math.log2(4 * ctx.n) + _noise.keyswitch_add(ctx.params, level)
    return max(0.0, _noise.bfv_budget(ctx.params, level, lv))


def _check_test_poly(ctx: SchemeContext, test_poly: torch.Tensor, level: int) -> None:
    want = (ctx.k - level, 1, ctx.n)
    if tuple(test_poly.shape) != want or test_poly.dtype != torch.int32:
        raise ValueError(f"test_poly must be an int32 {list(want)} tensor, got "
                         f"{test_poly.dtype} {list(test_poly.shape)}")


def blind_rotate(ctx: SchemeContext, lwe: LWECiphertext, bsk: BootstrapKey | None = None,
                 *, sk: SecretKey | None = None, gen: torch.Generator | None = None,
                 test_poly: torch.Tensor | None = None, offset: int | None = None,
                 level: int = 0) -> Ciphertext:
    """Accumulator blind rotation: an RLWE encryption, under the scheme key,
    of X^{offset - phase(lwe)} * test_poly.

    Pass a precomputed ``bsk`` (make_bootstrap_key), or ``sk`` and a
    generator ``gen`` to make one at ``level`` on the fly.  test_poly is
    [kl, 1, n] residues, by default the sign test vector floor(Delta/2) *
    (1 + X + ... + X^{n-1}); offset defaults to n/2, the half plateau of
    the binary pipeline (bootstrap_lut passes its own)."""
    n = ctx.n
    if bsk is None:
        if sk is None or gen is None:
            raise ValueError("blind_rotate needs bsk, or sk + gen")
        bsk = make_bootstrap_key(ctx, gen, sk, level)
    elif bsk.level != level:
        raise ValueError(
            f"bootstrap key was generated at level {bsk.level} but the "
            f"rotation was requested at level {level}; regenerate with "
            f"make_bootstrap_key(..., level={level})")
    level = bsk.level
    tb = _bfv._tb(ctx, level)
    if test_poly is None:
        test_poly = _sign_test_poly(ctx, level)
    _check_test_poly(ctx, test_poly, level)
    off = n // 2 if offset is None else int(offset)
    # the mask is public: one read to the host per rotation, not one per step
    *a_host, b_host = torch.cat([lwe.a, lwe.b.view(1)]).tolist()
    table = _shift_table(n, tb.device)
    acc0 = _monomial_mul(test_poly, (off - b_host) % (2 * n), n, _bfv._p3(tb))
    acc = torch.cat([acc0.transpose(0, 1), torch.zeros_like(acc0).transpose(0, 1)])
    p, inv = _cmux_consts(tb, ctx.inv_qhat_levels[level], acc.dim())
    for j, a_j in enumerate(a_host):
        # CMUX with s+: acc += (X^{-a_j} acc - acc) (x) RGSW(s+_j); then with
        # s-: acc += (X^{+a_j} acc - acc) (x) RGSW(s-_j)
        acc = _cmux(acc, table[(2 * n - a_j) % (2 * n)], _keys_t(bsk.pos[j]), tb, p, inv)
        acc = _cmux(acc, table[a_j], _keys_t(bsk.neg[j]), tb, p, inv)
    return Ciphertext(data=acc.transpose(0, 1).contiguous(), level=level,
                      is_ntt_form=False, noise_budget=_rotation_budget(ctx, level))


def blind_rotate_batch(ctx: SchemeContext, a_batch: torch.Tensor, b_batch: torch.Tensor,
                       bsk: BootstrapKey, test_poly: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """B rotations sharing one bootstrap key: a_batch [B, n], b_batch [B]
    (stacked LWE samples), offset n/2.  Returns the raw accumulators
    [kl, B, 2, n]; sample i equals blind_rotate of (a_batch[i], b_batch[i]).
    Each CMUX gathers every sample's rotation through one [B, n] index and
    runs one keyswitch_fused_batch launch; nothing is read to the host."""
    n = ctx.n
    level = bsk.level
    tb = _bfv._tb(ctx, level)
    kl, batch = tb.k, a_batch.shape[0]
    if test_poly is None:
        test_poly = _sign_test_poly(ctx, level)
    _check_test_poly(ctx, test_poly, level)
    a64, two_n = a_batch.to(torch.int64), 2 * n
    shift0 = (n // 2 - b_batch.to(torch.int64)) % two_n
    acc0 = _monomial_mul_batch(test_poly[:, None].expand(kl, batch, 1, n), shift0, n,
                               tb.p.view(-1, 1, 1, 1))             # [kl, B, 1, n]
    acc0 = acc0.permute(2, 0, 1, 3)
    acc = torch.cat([acc0, torch.zeros_like(acc0)])               # [2, kl, B, n]
    table = _shift_table(n, tb.device)
    idx_neg = table[((two_n - a64) % two_n).T]                    # [n, B, n]
    idx_pos = table[a64.T]
    p, inv = _cmux_consts(tb, ctx.inv_qhat_levels[level], acc.dim())
    for j in range(a_batch.shape[1]):
        acc = _cmux(acc, idx_neg[j], _keys_t(bsk.pos[j]), tb, p, inv)
        acc = _cmux(acc, idx_pos[j], _keys_t(bsk.neg[j]), tb, p, inv)
    return acc.permute(1, 2, 0, 3).contiguous()


def _sign_test_poly(ctx: SchemeContext, level: int) -> torch.Tensor:
    """floor(Delta_level/2) * (1 + X + ... + X^{n-1}) as [kl, 1, n] residues."""
    p = ctx.params
    primes_l = p.q_primes[:ctx.k - level]
    c = (math.prod(primes_l) // p.t) // 2
    vals = np.stack([np.full(p.n, c % int(pi), dtype=np.uint32) for pi in primes_l])
    return mm.u32_tensor(vals[:, None, :], ctx.device)


def _lut_test_poly(ctx: SchemeContext, level: int, lut, payload_bits: int) -> torch.Tensor:
    """Plateau test polynomial of the programmable bootstrap.  With offset
    S/2 (S = 2n / 2^w) coefficient 0 of the rotated accumulator reads
    G(phase - S/2), G the negacyclic extension of the coefficients; a
    payload m has phase ~ m*S, so

        T[(m-1)S : mS] = Delta * lut[m]   for m = 1 .. 2^(w-1) - 1
        T[n-S : n]     = -Delta * lut[0]  (m = 0 wraps negacyclically).

    The top payload bit is the padding bit: plaintexts stay below len(lut)."""
    p = ctx.params
    n, w = p.n, payload_bits
    S = (2 * n) >> w
    if S < 2:
        raise ValueError("payload too wide for the ring degree")
    m_max = 1 << (w - 1)
    if len(lut) != m_max:
        raise ValueError(f"lut has {len(lut)} entries, expected {m_max}")
    primes_l = p.q_primes[:ctx.k - level]
    delta = math.prod(primes_l) // p.t
    vals = [delta * (int(v) % p.t) for v in lut]
    tc = np.zeros((len(primes_l), n), dtype=np.uint32)
    for i, pi in enumerate(primes_l):
        pi = int(pi)
        for m in range(1, m_max):
            tc[i, (m - 1) * S: m * S] = vals[m] % pi
        tc[i, n - S:] = (-vals[0]) % pi
    return mm.u32_tensor(tc[:, None, :], ctx.device)


# ---------------------------------------------------------------------------
# the composed pipeline
# ---------------------------------------------------------------------------


def keyswitch_keygen_from_noise(ctx: SchemeContext, sk_from: SecretKey, sk_to: SecretKey,
                                a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Keys encrypting (q/q_j) * s_from under s_to from explicit [kd, k, 1, n]
    draws (``bfv._keyswitch_keygen_from_noise``), for the pipeline's final
    key switch."""
    return _bfv._keyswitch_keygen_from_noise(ctx, sk_to, sk_from.data[:ctx.k], a, e)


def keyswitch_keygen(ctx: SchemeContext, gen: torch.Generator, sk_from: SecretKey,
                     sk_to: SecretKey) -> torch.Tensor:
    return keyswitch_keygen_from_noise(ctx, sk_from, sk_to, *_bfv._keyswitch_draws(ctx, gen))


def _check_bsk_level(bsk: BootstrapKey | None, level: int, detail: str = "") -> None:
    if bsk is not None and bsk.level != level:
        raise ValueError(f"bootstrap key level {bsk.level} != ciphertext level {level}"
                         + detail)


def _recentre(ctx: SchemeContext, data: torch.Tensor, level: int) -> torch.Tensor:
    """data [kl, 2, n] with c = floor(Delta/2) added to coefficient 0 of c0:
    the sign test vector's plateaus {-c, +c} become {0, 2c ~ Delta}."""
    p = ctx.params
    primes_l = p.q_primes[:ctx.k - level]
    c = (math.prod(primes_l) // p.t) // 2
    cvec = torch.tensor([c % int(pi) for pi in primes_l], dtype=torch.int32,
                        device=data.device)
    out = data.clone(memory_format=torch.contiguous_format)
    out[:, 0, 0] = mm.add_mod(data[:, 0, 0], cvec, _bfv._tb(ctx, level).p)
    return out


def _raise_and_switch(ctx: SchemeContext, out: Ciphertext, ks_keys: torch.Tensor) -> Ciphertext:
    """The pipeline's last steps.  A leveled accumulator is raised to all k
    primes and multiplied by q_drop = q_0 / q_level, which rescales the
    plaintext from Delta_level to about Delta_0 and annihilates the raise's
    alpha * q_level term; then the key switch under ks_keys.  Budgets follow
    the JAX package's formulas."""
    p = ctx.params
    level = out.level
    if level:
        lv_rot = _noise.bfv_variance(p, level, out.noise_budget)
        out = _bfv.modulus_raise(ctx, out)
        q_drop = math.prod(p.q_primes[ctx.k - level:])
        out = out.replace(data=_poly.mul_scalar(out.data, q_drop, ctx.ntt_q),
                          noise_budget=max(0.0, _noise.bfv_budget(
                              p, 0, 2.0 * math.log2(q_drop) + lv_rot)))
    out = _bfv.key_switch(ctx, out, ks_keys)
    return out.replace(noise_budget=max(0.0, _noise.bfv_budget(
        p, 0, _noise.add(_noise.bfv_variance(p, 0, out.noise_budget),
                         _noise.keyswitch_add(p, 0)))))


def bootstrap_binary(ctx: SchemeContext, gen: torch.Generator | None, ct: Ciphertext,
                     sk: SecretKey, bsk: BootstrapKey | None = None,
                     ks_keys: torch.Tensor | None = None) -> Ciphertext:
    """Noise refresh of a binary plaintext (constant coefficient in {0, 1}):
    extract_lsb -> blind_rotate -> (modulus_raise) -> key_switch.  The bit
    never leaves the ciphertext; sk serves key generation only, from
    ``gen``, when bsk or ks_keys is not given.  Returns a level-0
    ciphertext of the same bit with noise independent of the input's."""
    level = ct.level
    _check_bsk_level(bsk, level, ": the accumulator ring and the offset/raise "
                     "arithmetic must use the same modulus chain position")
    lwe = extract_lsb(ctx, ct, index=0)
    out = blind_rotate(ctx, lwe, bsk, sk=sk, gen=gen, level=level)
    out = out.replace(data=_recentre(ctx, out.data, level))
    if ks_keys is None:
        ks_keys = keyswitch_keygen(ctx, gen, sk, sk)
    return _raise_and_switch(ctx, out, ks_keys)


def bootstrap_binary_batch(ctx: SchemeContext, cts: list, bsk: BootstrapKey,
                           ks_keys: torch.Tensor) -> list:
    """B binary bootstraps through one batched blind rotation (B12 for each
    external product); element i equals bootstrap_binary(cts[i]) bit for
    bit."""
    level = _bfv._check_pairs(cts, "bootstrap_binary_batch")
    _check_bsk_level(bsk, level)
    lwes = [extract_lsb(ctx, ct, index=0) for ct in cts]
    acc = blind_rotate_batch(ctx, torch.stack([lwe.a for lwe in lwes]),
                             torch.stack([lwe.b for lwe in lwes]), bsk)
    budget = _rotation_budget(ctx, level)
    return [_raise_and_switch(ctx, Ciphertext(
        data=_recentre(ctx, acc[:, i], level), level=level, is_ntt_form=False,
        noise_budget=budget), ks_keys) for i in range(len(cts))]


def bootstrap_lut(ctx: SchemeContext, gen: torch.Generator | None, ct: Ciphertext, lut,
                  sk: SecretKey, payload_bits: int | None = None,
                  bsk: BootstrapKey | None = None,
                  ks_keys: torch.Tensor | None = None) -> Ciphertext:
    """Programmable bootstrap: the output encrypts lut[m] at fresh noise for
    a constant-coefficient plaintext m in [0, len(lut)).

        extract_payload -> blind_rotate(plateau test vector) -> key_switch

    ``lut``: 2^(w-1) values mod t (w = payload_bits, by default the smallest
    width that fits the table, plus the padding bit); a shorter table is
    padded with zeros.  lut = [0, 1] is the binary refresh, [1, 0] an
    encrypted NOT."""
    n, level = ctx.n, ct.level
    if payload_bits is None:
        payload_bits = max(1, (len(lut) - 1).bit_length()) + 1
    m_max = 1 << (payload_bits - 1)
    if len(lut) != m_max:
        lut = list(lut) + [0] * (m_max - len(lut))
    _check_bsk_level(bsk, level)
    lwe = extract_payload(ctx, ct, payload_bits, index=0)
    tv = _lut_test_poly(ctx, level, lut, payload_bits)
    out = blind_rotate(ctx, lwe, bsk, sk=sk, gen=gen, test_poly=tv,
                       offset=((2 * n) >> payload_bits) // 2, level=level)
    if ks_keys is None:
        ks_keys = keyswitch_keygen(ctx, gen, sk, sk)
    return _raise_and_switch(ctx, out, ks_keys)
