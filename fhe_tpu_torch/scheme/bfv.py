"""BFV operations at level 0 — counterpart of ``fhe_tpu/scheme/bfv.py``.

keygen, relinkey_gen, encrypt, decrypt (2 or 3 components), add / sub,
add_plain / sub_plain, multiply_plain (with a cached NTT-form operand), the
domain changes to_ntt / to_coeff, and the ciphertext multiply: the BEHZ
multiply_no_relin, relinearize (RNS-digit key switching) and multiply.
Rotations and modulus switching come in later slices.

Every transform goes through the kernel wrappers of ``ops/ntt_cuda.py``,
``ops/rns_cuda.py`` and ``ops/decrypt_cuda.py``: CUDA kernels for tensors on
the card, their plain PyTorch versions for tensors on the CPU.  The
elementwise modular ops stay plain PyTorch on either device.

Randomness comes from an explicit ``torch.Generator``.  ``keygen``,
``relinkey_gen`` and ``encrypt`` draw with the port's samplers and call
``keygen_from_noise``, ``relinkey_gen_from_noise`` and
``encrypt_from_noise``, which take the draws as arguments so that the same
draws can be fed to the JAX package and to the port.
"""

from __future__ import annotations

import torch

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import ntt_cuda
from ..ops import decrypt_cuda
from ..ops import poly as _poly
from ..ops import rns as _rns
from ..ops import rns_cuda
from ..ops import sampling
from . import noise as _noise
from .context import SchemeContext
from .types import Ciphertext, Plaintext, PublicKey, RelinKeys, SecretKey


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _tb(ctx: SchemeContext, level: int = 0) -> _ntt.NTTTables:
    if level != 0:
        raise NotImplementedError(
            f"level {level}: modulus switching is not ported yet")
    return ctx.ntt_q


def _p3(tb: _ntt.NTTTables) -> torch.Tensor:
    return tb.p.view(-1, 1, 1)


def _fresh_noise_budget(ctx: SchemeContext) -> float:
    return max(0.0, _noise.bfv_budget(ctx.params, 0,
                                      _noise.fresh_variance(ctx.params)))


def _v_of(ctx: SchemeContext, ct: Ciphertext) -> float:
    return _noise.bfv_variance(ctx.params, ct.level, ct.noise_budget)


def _b_of(ctx: SchemeContext, level: int, log2_var: float) -> float:
    return max(0.0, _noise.bfv_budget(ctx.params, level, log2_var))


def to_ntt(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    if ct.is_ntt_form:
        return ct
    return ct.replace(data=ntt_cuda.ntt_forward(ct.data, _tb(ctx, ct.level)),
                      is_ntt_form=True)


def to_coeff(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    if not ct.is_ntt_form:
        return ct
    return ct.replace(data=ntt_cuda.ntt_inverse(ct.data, _tb(ctx, ct.level)),
                      is_ntt_form=False)


def _lift_plain(ctx: SchemeContext, pt: Plaintext, level: int = 0) -> torch.Tensor:
    """pt coefficients mod t (< t < every q_i) as residues: [k, 1, n]."""
    k = _tb(ctx, level).k
    return pt.data.view(1, 1, ctx.n).expand(k, 1, ctx.n).contiguous()


def _scale_by_delta(ctx: SchemeContext, pt: Plaintext, level: int = 0) -> torch.Tensor:
    """Δ_L * m as residues [k, 1, n], Δ_L = floor(q_L / t)."""
    delta, _ = ctx.delta_levels[level]
    return mm.mul_mod(_lift_plain(ctx, pt, level), delta.view(-1, 1, 1),
                      _p3(_tb(ctx, level)))


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------


def keygen_from_noise(ctx: SchemeContext, s: torch.Tensor, a: torch.Tensor,
                      e: torch.Tensor) -> tuple[PublicKey, SecretKey]:
    """RLWE keypair from explicit draws, each a [k, 1, n] residue tensor:
    s ternary, a uniform, e Gaussian.  pk = (e - a*s, a), NTT form."""
    tb = ctx.ntt_q
    x = ntt_cuda.ntt_forward(torch.cat([s, a, e], dim=1), tb)   # [k, 3, n]
    s_ntt, a_ntt, e_ntt = x[:, 0:1], x[:, 1:2], x[:, 2:3]
    b_ntt = mm.sub_mod(e_ntt, _ntt.pointwise_mul(a_ntt, s_ntt, tb), _p3(tb))
    return (PublicKey(data=torch.cat([b_ntt, a_ntt], dim=1)),
            SecretKey(data=s_ntt.contiguous()))


def keygen(ctx: SchemeContext, gen: torch.Generator) -> tuple[PublicKey, SecretKey]:
    p = ctx.params
    primes = ctx.ntt_q.p
    s = sampling.ternary_rns(gen, primes, 1, p.n, p.security.hamming_weight)
    a = sampling.uniform_rns(gen, primes, 1, p.n)
    e = sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
    return keygen_from_noise(ctx, s, a, e)


def _digit_count(ctx: SchemeContext) -> int:
    """Gadget digits of the key switch: one per q prime (ks_omega = 1)."""
    omega = ctx.params.security.ks_omega
    if omega != 1:
        raise NotImplementedError(
            f"ks_omega={omega}: grouped gadget digits (the prereduced lane of "
            "keyswitch_fused) are not ported yet; use ks_omega=1")
    return ctx.k


def relinkey_gen_from_noise(ctx: SchemeContext, sk: SecretKey, a: torch.Tensor,
                            e: torch.Tensor) -> RelinKeys:
    """Relinearization keys from explicit draws: a (uniform) and e
    (Gaussian) are [kd, k, 1, n] residues, one [k, 1, n] draw per gadget
    digit.  Digit j is (b_j, a_j) with b_j = e_j - a_j*s + (q/q_j)*s^2, in
    NTT form; returns [kd, k, 2, n]."""
    tb = ctx.ntt_q
    k, n = tb.k, tb.n
    kd = _digit_count(ctx)
    if a.shape != (kd, k, 1, n) or e.shape != a.shape:
        raise ValueError(f"relinkey_gen_from_noise: draws {list(a.shape)} and "
                         f"{list(e.shape)}, expected [{kd}, {k}, 1, {n}]")
    p3 = _p3(tb)
    # every draw in one batched transform: [k, 2*kd, n]
    x = ntt_cuda.ntt_forward(
        torch.cat([a, e], dim=0)[:, :, 0].permute(1, 0, 2).contiguous(), tb)
    a_ntt, e_ntt = x[:, :kd], x[:, kd:]
    s = sk.data[:k]
    s2 = _ntt.pointwise_mul(s, s, tb)                            # [k, 1, n]
    q = ctx.params.q
    gadget = torch.tensor([[q // qj % qi for qj in tb.primes] for qi in tb.primes],
                          dtype=torch.int64, device=tb.device)   # [k, kd]
    b_ntt = mm.add_mod(
        mm.sub_mod(e_ntt, _ntt.pointwise_mul(a_ntt, s.expand_as(a_ntt), tb), p3),
        mm.mul_mod(s2.expand_as(a_ntt), gadget[:, :, None], p3), p3)
    data = torch.stack([b_ntt, a_ntt], dim=2)                    # [k, kd, 2, n]
    return RelinKeys(data=data.permute(1, 0, 2, 3).contiguous())


def relinkey_gen(ctx: SchemeContext, gen: torch.Generator,
                 sk: SecretKey) -> RelinKeys:
    """Keys for s^2 -> s switching, with the port's samplers."""
    p = ctx.params
    primes = ctx.ntt_q.p
    kd = _digit_count(ctx)
    a = torch.stack([sampling.uniform_rns(gen, primes, 1, p.n)
                     for _ in range(kd)])
    e = torch.stack([sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
                     for _ in range(kd)])
    return relinkey_gen_from_noise(ctx, sk, a, e)


# ---------------------------------------------------------------------------
# encrypt / decrypt
# ---------------------------------------------------------------------------


def encrypt_from_noise(ctx: SchemeContext, pk: PublicKey, pt: Plaintext,
                       u: torch.Tensor, e1: torch.Tensor,
                       e2: torch.Tensor) -> Ciphertext:
    """ct = (pk0*u + e1 + Δm, pk1*u + e2) in the coefficient domain, from
    explicit [k, 1, n] draws: u ternary, e1 and e2 Gaussian."""
    tb = ctx.ntt_q
    p3 = _p3(tb)
    pk_u = ntt_cuda.mul_by_ntt_operand(u, pk.data, tb)          # [k, 2, n]
    c0 = mm.add_mod(mm.add_mod(pk_u[:, :1], e1, p3),
                    _scale_by_delta(ctx, pt), p3)
    c1 = mm.add_mod(pk_u[:, 1:], e2, p3)
    return Ciphertext(data=torch.cat([c0, c1], dim=1), level=0,
                      is_ntt_form=False, noise_budget=_fresh_noise_budget(ctx))


def encrypt(ctx: SchemeContext, gen: torch.Generator, pk: PublicKey,
            pt: Plaintext) -> Ciphertext:
    p = ctx.params
    primes = ctx.ntt_q.p
    u = sampling.ternary_rns(gen, primes, 1, p.n, p.security.hamming_weight)
    e1 = sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
    e2 = sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
    return encrypt_from_noise(ctx, pk, pt, u, e1, e2)


def _phase(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> torch.Tensor:
    """[k, n] coefficient-domain c0 + c1*s + c2*s^2 + ... mod q; each term
    is one mul_by_ntt_operand launch on a view of its component."""
    ct = to_coeff(ctx, ct)
    tb = _tb(ctx, ct.level)
    s = sk.data[:tb.k]
    p2 = tb.p.view(-1, 1)
    acc = ct.data[:, 0]
    s_pow = s
    for idx in range(1, ct.num_components):
        term = ntt_cuda.mul_by_ntt_operand(ct.data[:, idx:idx + 1], s_pow, tb)
        acc = mm.add_mod(acc, term[:, 0], p2)
        if idx + 1 < ct.num_components:
            s_pow = _ntt.pointwise_mul(s_pow, s, tb)
    return acc


def decrypt(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> Plaintext:
    """m = round(t/q * [ct(s)]_q) mod t.  A 2-component ciphertext runs
    phase and exact scaling in one fused kernel (ops/decrypt_cuda.py); a
    longer one composes the phase (_phase) with the exact scaling of
    ops/rns.py, as the JAX package does."""
    if ct.num_components == 2:
        ct = to_coeff(ctx, ct)
        tb = _tb(ctx, ct.level)
        m = decrypt_cuda.decrypt_fused(ct.data[:, 0:1], ct.data[:, 1:2],
                                       sk.data[:tb.k], tb,
                                       ctx.dec_levels[ct.level])
        return Plaintext(data=m[0])
    x = _phase(ctx, ct, sk)
    return Plaintext(data=_rns.decrypt_scale(x[:, None, :],
                                             ctx.dec_levels[ct.level])[0])


# ---------------------------------------------------------------------------
# additive ops
# ---------------------------------------------------------------------------


def _check_compat(a: Ciphertext, b: Ciphertext) -> None:
    if a.level != b.level or a.is_ntt_form != b.is_ntt_form:
        raise ValueError("ciphertext level/domain mismatch")


def add(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    return a.replace(
        data=_poly.add(a.data, b.data, _tb(ctx, a.level)),
        noise_budget=_b_of(ctx, a.level,
                           _noise.add(_v_of(ctx, a), _v_of(ctx, b))))


def sub(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    return a.replace(
        data=_poly.sub(a.data, b.data, _tb(ctx, a.level)),
        noise_budget=_b_of(ctx, a.level,
                           _noise.add(_v_of(ctx, a), _v_of(ctx, b))))


def _plain_c0_op(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> torch.Tensor:
    """Δ_L * m in the ciphertext's domain: an NTT-form ciphertext stays in
    the evaluation domain (one [k, 1, n] forward transform)."""
    op = _scale_by_delta(ctx, pt, ct.level)
    if ct.is_ntt_form:
        op = ntt_cuda.ntt_forward(op, _tb(ctx, ct.level))
    return op


def add_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """c0 += Δ_L * m."""
    c0 = _poly.add(ct.data[:, :1], _plain_c0_op(ctx, ct, pt), _tb(ctx, ct.level))
    return ct.replace(data=torch.cat([c0, ct.data[:, 1:]], dim=1))


def sub_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    c0 = _poly.sub(ct.data[:, :1], _plain_c0_op(ctx, ct, pt), _tb(ctx, ct.level))
    return ct.replace(data=torch.cat([c0, ct.data[:, 1:]], dim=1))


def plain_ntt_operand(ctx: SchemeContext, pt: Plaintext,
                      level: int = 0) -> torch.Tensor:
    """NTT-form multiply_plain operand [k, 1, n]; compute once and pass as
    ``pt_ntt`` when a plaintext is reused across many products."""
    return ntt_cuda.ntt_forward(_lift_plain(ctx, pt, level), _tb(ctx, level))


def multiply_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext,
                   pt_ntt: torch.Tensor | None = None) -> Ciphertext:
    """c_i *= m (negacyclic), no rescale.  An NTT-form input with a given
    ``pt_ntt`` costs no transform at all: the pattern for plaintext dot
    products is to_ntt once, multiply and accumulate, to_coeff once."""
    tb = _tb(ctx, ct.level)
    ct_ntt = to_ntt(ctx, ct)
    if pt_ntt is None:
        pt_ntt = plain_ntt_operand(ctx, pt, ct.level)
    out = ct_ntt.replace(
        data=_ntt.pointwise_mul(ct_ntt.data, pt_ntt.expand_as(ct_ntt.data), tb),
        noise_budget=_b_of(ctx, ct.level, _noise.multiply_plain(
            ctx.params, _v_of(ctx, ct))))
    return out if ct.is_ntt_form else to_coeff(ctx, out)


# ---------------------------------------------------------------------------
# ciphertext multiply (BEHZ) and relinearization
# ---------------------------------------------------------------------------


def multiply_no_relin(ctx: SchemeContext, a: Ciphertext,
                      b: Ciphertext) -> Ciphertext:
    """BEHZ RNS tensor product and t/q scaling -> 3-component ciphertext:
    the t-scaled q-side tensor product (one kernel), the whole Bsk branch
    (lift, Bsk tensor product, floor: one kernel) and the exact
    Shenoy-Kumaresan conversion back to q (one kernel)."""
    if a.level != b.level:
        raise ValueError("ciphertext level mismatch")
    if a.num_components != 2 or b.num_components != 2:
        raise ValueError(
            "multiply needs 2-component ciphertexts; relinearize first "
            f"(got {a.num_components} and {b.num_components})")
    _tb(ctx, a.level)                      # raises above level 0
    if ctx.n < 1024:
        raise NotImplementedError(
            f"n={ctx.n}: the n < 1024 multiply runs sm_mrq_fused and "
            "fast_floor_fused, which are not ported yet; use n >= 1024")
    a, b = to_coeff(ctx, a), to_coeff(ctx, b)
    tq, tbsk = ctx.mul_tables
    tx_q = ntt_cuda.tensor_product(a.data, b.data, tq)           # [k, 3, n]
    floored = rns_cuda.bsk_branch_fused(
        torch.cat([a.data, b.data], dim=1), tx_q, ctx.smq, ctx.floor_c, tbsk)
    return Ciphertext(
        data=rns_cuda.fast_bconv_sk_fused(floored, ctx.sk_c), level=0,
        is_ntt_form=False,
        noise_budget=_b_of(ctx, 0, _noise.bfv_multiply(
            ctx.params, _v_of(ctx, a), _v_of(ctx, b))))


def _keyswitch_delta(ctx: SchemeContext, poly: torch.Tensor,
                     ks_keys: torch.Tensor) -> torch.Tensor:
    """Coefficient-domain key-switch correction INTT(sum_j NTT(D_j) ⊙ key_j)
    for a [k, n] component: the digits D_j = [poly_j * (q/q_j)^-1]_{q_j}
    are one elementwise step, the rest is one keyswitch_fused launch reading
    the stored [kd, k, 2, n] keys in place.  Returns [k, 2, n]."""
    _digit_count(ctx)
    tb = ctx.ntt_q
    d = mm.mul_mod(poly, ctx.inv_qhat.view(-1, 1), tb.p.view(-1, 1))
    return ntt_cuda.keyswitch_fused(d, ks_keys.permute(1, 0, 2, 3), tb)


def relinearize(ctx: SchemeContext, ct: Ciphertext, rlk: RelinKeys) -> Ciphertext:
    """3 -> 2 components by RNS-digit key switching of c2 onto s."""
    if ct.num_components != 3:
        raise ValueError(f"relinearize needs 3 components, got "
                         f"{ct.num_components}")
    tb = _tb(ctx, ct.level)
    ct = to_coeff(ctx, ct)
    delta = _keyswitch_delta(ctx, ct.data[:, 2], rlk.data)
    return ct.replace(
        data=mm.add_mod(ct.data[:, :2], delta, _p3(tb)),
        noise_budget=_b_of(ctx, 0, _noise.add(
            _v_of(ctx, ct), _noise.keyswitch_add(ctx.params, 0))))


def multiply(ctx: SchemeContext, a: Ciphertext, b: Ciphertext,
             rlk: RelinKeys) -> Ciphertext:
    """Full homomorphic multiply: tensor product, scaling, relinearization."""
    return relinearize(ctx, multiply_no_relin(ctx, a, b), rlk)
