"""BFV operations at every level — counterpart of ``fhe_tpu/scheme/bfv.py``.

keygen, relinkey_gen, galoiskey_gen, encrypt, decrypt (2 or 3 components),
add / sub, add_plain / sub_plain, multiply_plain (with a cached NTT-form
operand), the domain changes to_ntt / to_coeff, the ciphertext multiply
(the BEHZ multiply_no_relin, relinearize by RNS-digit key switching, and
multiply), key_switch and the Galois rotations (apply_galois, rotate_rows,
rotate_columns), the serving batches (encrypt_batch, decrypt_batch,
multiply_batch, apply_galois_batch and rotate_rows_batch) and the hoisted
rotations (hoisted_galois_keys, apply_galois_hoisted, its accumulating
form apply_galois_hoisted_sum and its multi-ciphertext form
apply_galois_hoisted_batch), and modulus switching (mod_switch_to_next,
mod_switch_to_level, modulus_raise, the trusted-refresh bootstrap), and the
noise-budget diagnostics (estimate_noise_budget, exact_noise_budget: the
phase's exact CRT on the host).  Every key switch takes the grouped gadget
digits of ks_omega > 1 as well as the classic per-prime ones.  The
key-switching ops and the key down-switch take ``bgv=True`` for BGV keys
(``scheme/bgv.py``), which switch down with the t-corrected modulus switch.

Every op runs at any level L of the modulus chain (the first k - L q
primes), reading the level's constants from the context.  Keys are made at
level 0; a key-switching op at level L switches them down on the fly
(_switch_keys_down: inverse transform, L roundings, forward transform at
level L), unless the caller passes ``keys_at_level=True`` with keys that
``switch_relin_keys`` / ``switch_galois_keys`` made for that level (the
FHE facade caches those per level).

Every transform goes through the kernel wrappers of ``ops/ntt_cuda.py``,
``ops/rns_cuda.py``, ``ops/galois_cuda.py`` and ``ops/decrypt_cuda.py``:
CUDA kernels for tensors on the card, their plain PyTorch versions for
tensors on the CPU.  The elementwise modular ops stay plain PyTorch on
either device.  A batch op stacks its B ciphertexts once, [B, k, c, n], and
hands the kernels permuted views of the stack, which they read in place.

Randomness comes from an explicit ``torch.Generator``.  ``keygen``,
``relinkey_gen``, ``galoiskey_gen``, ``encrypt`` and ``encrypt_batch`` draw
with the port's samplers and call the matching ``*_from_noise`` function,
which takes the draws as arguments so that the same draws can be fed to the
JAX package and to the port.
"""

from __future__ import annotations

import math

import torch

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import ntt_cuda
from ..ops import ntt_mxu
from ..ops import decrypt_cuda
from ..ops import galois_cuda
from ..ops import poly as _poly
from ..ops import rns as _rns
from ..ops import rns_cuda
from ..ops import sampling
from . import noise as _noise
from .context import SchemeContext, default_galois_elements, eval_perm_inv
from .types import (Ciphertext, GaloisKeys, Plaintext, PublicKey, RelinKeys,
                    SecretKey)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _tb(ctx: SchemeContext, level: int = 0) -> _ntt.NTTTables:
    """The q tables of level L: row views of its first k - L primes."""
    return _ntt.slice_tables(ctx.ntt_q, ctx.k - level)


def _fwd_q(ctx: SchemeContext, x: torch.Tensor, level: int = 0) -> torch.Tensor:
    return ntt_cuda.ntt_forward(x, _tb(ctx, level))


def _inv_q(ctx: SchemeContext, x: torch.Tensor, level: int = 0) -> torch.Tensor:
    return ntt_cuda.ntt_inverse(x, _tb(ctx, level))


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
    return ct.replace(data=_fwd_q(ctx, ct.data, ct.level), is_ntt_form=True)


def to_coeff(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    if not ct.is_ntt_form:
        return ct
    return ct.replace(data=_inv_q(ctx, ct.data, ct.level), is_ntt_form=False)


def _lift_plain(ctx: SchemeContext, pt: Plaintext, level: int = 0) -> torch.Tensor:
    """pt coefficients mod t (< t < every q_i) as residues: [k-L, 1, n]."""
    k = _tb(ctx, level).k
    return pt.data.view(1, 1, ctx.n).expand(k, 1, ctx.n).contiguous()


def _scale_by_delta(ctx: SchemeContext, pt: Plaintext, level: int = 0) -> torch.Tensor:
    """Δ_L * m as residues [k-L, 1, n], Δ_L = floor(q_L / t)."""
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


def _keygen_draws(ctx: SchemeContext, gen: torch.Generator) -> tuple:
    """A keypair's draws with the port's samplers: s, a, e, [k, 1, n] each."""
    p = ctx.params
    primes = ctx.ntt_q.p
    s = sampling.ternary_rns(gen, primes, 1, p.n, p.security.hamming_weight)
    a = sampling.uniform_rns(gen, primes, 1, p.n)
    e = sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
    return s, a, e


def keygen(ctx: SchemeContext, gen: torch.Generator) -> tuple[PublicKey, SecretKey]:
    return keygen_from_noise(ctx, *_keygen_draws(ctx, gen))


def _omega(ctx: SchemeContext) -> int:
    """Key-switch gadget rank: q primes per gadget digit (1 = classic)."""
    return ctx.params.security.ks_omega


def _digit_count(ctx: SchemeContext) -> int:
    """Gadget digits of the key switch: ceil(k / ks_omega), one per group
    of ks_omega q primes (one per prime at ks_omega = 1)."""
    return -(-ctx.k // _omega(ctx))


def _grouped_digit_residues(ctx: SchemeContext, y: torch.Tensor,
                            level: int = 0) -> torch.Tensor:
    """Grouped gadget digits (ks_omega > 1) from the per-prime digits
    y [k-L, *B, n], y[j] = [c * (q_L/q_j)^-1]_{q_j}: returns [k-L, kd, *B, n],
    the residue of digit D_g mod every prime, D_g + alpha*q_Jg =
    sum_{j in J_g} y_j * (q_Jg/q_j) (``context.ks_group_conv_tables`` of the
    level's primes).  A short last group (k-L not a multiple of ks_omega) is
    padded with zero digits, which contribute nothing."""
    cw = ctx.ks_conv_levels[level]
    k, kd, omega = cw.shape
    pad = kd * omega - k
    if pad:
        y = torch.cat([y, y.new_zeros((pad, *y.shape[1:]))])
    extra = (1,) * (y.dim() - 1)
    p = _tb(ctx, level).p.to(torch.int64).view(k, 1, *extra)
    yg = y.to(torch.int64).reshape(1, kd, omega, *y.shape[1:])
    prod = yg * cw.to(torch.int64).view(k, kd, omega, *extra) % p[:, None]
    return (prod.sum(2) % p).to(torch.int32)


def _gadget_digits(ctx: SchemeContext, d: torch.Tensor, level: int = 0) -> torch.Tensor:
    """Per-prime residues [k-L, kd, *B, n] of the gadget digits of the
    per-prime digits d [k-L, *B, n]: the grouped digits at ks_omega > 1,
    else digit j reduced mod every prime p_i."""
    if _omega(ctx) > 1:
        return _grouped_digit_residues(ctx, d, level)
    p = _tb(ctx, level).p.to(torch.int64).view(-1, *([1] * d.dim()))
    return torch.remainder(d.to(torch.int64)[None], p).to(torch.int32)


def _digits(ctx: SchemeContext, polys: torch.Tensor, level: int) -> torch.Tensor:
    """Per-prime gadget digits [c_j * (q_L/q_j)^-1]_{q_j} of [k-L, *B, n]
    coefficient-domain components."""
    return _rns.relin_digits(polys, ctx.inv_qhat_levels[level], _tb(ctx, level).p)


def _digit_consts(ctx: SchemeContext, level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_L/q_j)^-1 mod q_j and its Shoup companions: the digits lane of the
    multiply's conversion kernels, which store ``_digits`` of c2 beside it."""
    return ctx.inv_qhat_levels[level], ctx.inv_qhat_shoup_levels[level]


# the gadget digits a key generator forms at a time
KEYGEN_DIGITS = 16


def _keyswitch_keygen_from_noise(ctx: SchemeContext, sk: SecretKey,
                                 target_ntt: torch.Tensor, a: torch.Tensor,
                                 e: torch.Tensor) -> torch.Tensor:
    """Keys switching target -> s from explicit draws: a (uniform) and e
    (Gaussian) are [kd, k, 1, n] residues, one [k, 1, n] draw per gadget
    digit; target_ntt is the [k, 1, n] NTT-form polynomial to switch from
    (s^2 for relinearization, s(x^g) for a Galois key).  Digit j is
    (b_j, a_j) with b_j = e_j - a_j*s + (q/q_Jj)*target, in NTT form, q_Jj
    the product of the j-th group of ks_omega primes (q_j itself at
    ks_omega = 1); returns [kd, k, 2, n], kd = ceil(k / ks_omega)."""
    tb = ctx.ntt_q
    k, n = tb.k, tb.n
    kd = _digit_count(ctx)
    if a.shape != (kd, k, 1, n) or e.shape != a.shape:
        raise ValueError(f"keyswitch key draws {list(a.shape)} and "
                         f"{list(e.shape)}, expected [{kd}, {k}, 1, {n}]")
    p3 = _p3(tb)
    s = sk.data[:k]
    q, omega = ctx.params.q, _omega(ctx)
    groups = [math.prod(tb.primes[j * omega:(j + 1) * omega]) for j in range(kd)]
    gadget = torch.tensor([[q // qj % qi for qj in groups] for qi in tb.primes],
                          dtype=torch.int64, device=tb.device)   # [k, kd]
    # KEYGEN_DIGITS digits at a time, each group's draws in one batched
    # transform ([k, 2 * digits, n]): the int64 products of all kd digits
    # at once take 60 GB at k = kd = 102, n = 131072.  Each group's keys are
    # made in one block and the groups joined at the end: on the H100 a key
    # written into a preallocated tensor moved the buffers of later
    # launches, and the batched multiply at n = 8192 ran 4.8 % slower (its
    # bsk_branch_fused launch is sensitive to where its buffers lie)
    chunks = []
    for j0 in range(0, kd, KEYGEN_DIGITS):
        j1 = min(j0 + KEYGEN_DIGITS, kd)
        x = ntt_cuda.ntt_forward(
            torch.cat([a[j0:j1], e[j0:j1]], dim=0)[:, :, 0].permute(1, 0, 2).contiguous(), tb)
        a_ntt, e_ntt = x[:, :j1 - j0], x[:, j1 - j0:]
        b_ntt = mm.add_mod(
            mm.sub_mod(e_ntt, _ntt.pointwise_mul(a_ntt, s.expand_as(a_ntt), tb), p3),
            mm.mul_mod(target_ntt.expand_as(a_ntt), gadget[:, j0:j1, None], p3), p3)
        data = torch.stack([b_ntt, a_ntt], dim=2)                # [k, digits, 2, n]
        chunks.append(data.permute(1, 0, 2, 3).contiguous())
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks)


def _keyswitch_draws(ctx: SchemeContext,
                     gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """One key's draws with the port's samplers: a and e, [kd, k, 1, n]."""
    p = ctx.params
    primes = ctx.ntt_q.p
    kd = _digit_count(ctx)
    a = torch.stack([sampling.uniform_rns(gen, primes, 1, p.n)
                     for _ in range(kd)])
    e = torch.stack([sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
                     for _ in range(kd)])
    return a, e


def relinkey_gen_from_noise(ctx: SchemeContext, sk: SecretKey, a: torch.Tensor,
                            e: torch.Tensor) -> RelinKeys:
    """Relinearization keys (s^2 -> s) from explicit [kd, k, 1, n] draws;
    see ``_keyswitch_keygen_from_noise``.  Returns [kd, k, 2, n]."""
    s = sk.data[:ctx.k]
    return RelinKeys(data=_keyswitch_keygen_from_noise(
        ctx, sk, _ntt.pointwise_mul(s, s, ctx.ntt_q), a, e))


def relinkey_gen(ctx: SchemeContext, gen: torch.Generator,
                 sk: SecretKey) -> RelinKeys:
    """Keys for s^2 -> s switching, with the port's samplers."""
    return relinkey_gen_from_noise(ctx, sk, *_keyswitch_draws(ctx, gen))


def galoiskey_gen_from_noise(ctx: SchemeContext, sk: SecretKey, elements,
                             a: torch.Tensor, e: torch.Tensor) -> GaloisKeys:
    """Keys for s(x^g) -> s switching, one per Galois element g of
    ``elements``, from explicit draws a and e [len(elements), kd, k, 1, n]
    (element i's key takes a[i] and e[i]).  The target of g is
    s(x^g) = NTT(phi_g(INTT(s)))."""
    elements = tuple(int(g) for g in elements)
    if a.shape[0] != len(elements) or e.shape[0] != len(elements):
        raise ValueError(f"galoiskey_gen_from_noise: {len(elements)} elements, "
                         f"draws {list(a.shape)} and {list(e.shape)}")
    tb = ctx.ntt_q
    s_coeff = ntt_cuda.ntt_inverse(sk.data[:tb.k], tb)          # [k, 1, n]
    keys = {}
    for i, g in enumerate(elements):
        s_g = ntt_cuda.ntt_forward(_apply_galois_coeff(ctx, s_coeff, g), tb)
        keys[g] = _keyswitch_keygen_from_noise(ctx, sk, s_g, a[i], e[i])
    return GaloisKeys(data=keys)


def _galois_draws(ctx: SchemeContext, gen: torch.Generator, elements) -> tuple:
    """(elements, a, e): the Galois elements (by default the power-of-two
    row rotations in both directions and the column swap,
    ``context.default_galois_elements``) and their keys' draws,
    [E, kd, k, 1, n] each."""
    elements = (tuple(elements) if elements is not None
                else default_galois_elements(ctx.n))
    draws = [_keyswitch_draws(ctx, gen) for _ in elements]
    return (elements, torch.stack([a for a, _ in draws]),
            torch.stack([e for _, e in draws]))


def galoiskey_gen(ctx: SchemeContext, gen: torch.Generator, sk: SecretKey,
                  elements=None) -> GaloisKeys:
    """Galois keys with the port's samplers (``_galois_draws``)."""
    return galoiskey_gen_from_noise(ctx, sk, *_galois_draws(ctx, gen, elements))


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


def _encrypt_draws(ctx: SchemeContext, gen: torch.Generator) -> tuple:
    """An encryption's draws with the port's samplers: u, e1, e2, [k, 1, n]
    each."""
    p = ctx.params
    primes = ctx.ntt_q.p
    u = sampling.ternary_rns(gen, primes, 1, p.n, p.security.hamming_weight)
    e1 = sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
    e2 = sampling.gaussian_rns(gen, primes, p.security.sigma, 1, p.n)
    return u, e1, e2


def encrypt(ctx: SchemeContext, gen: torch.Generator, pk: PublicKey,
            pt: Plaintext) -> Ciphertext:
    return encrypt_from_noise(ctx, pk, pt, *_encrypt_draws(ctx, gen))


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


def _split_batch(data: torch.Tensor, budgets, level: int = 0, scales=None) -> list:
    """[k-L, c, B, n] coefficient-domain results -> B ciphertexts at level
    L, each a contiguous [k-L, c, n] slice of one [B, k-L, c, n] tensor,
    with BGV's scale_t of each (``scales``; 1 without)."""
    data = data.permute(2, 0, 1, 3).contiguous()
    scales = scales or [1] * len(budgets)
    return [Ciphertext(data=data[i], level=level, is_ntt_form=False, noise_budget=nb,
                       scale_t=st)
            for i, (nb, st) in enumerate(zip(budgets, scales))]


def encrypt_batch_from_noise(ctx: SchemeContext, pk: PublicKey, pts: list,
                             u: torch.Tensor, e1: torch.Tensor,
                             e2: torch.Tensor) -> list:
    """B fresh encryptions from explicit [k, B, n] draws (element i takes
    column i of u, e1 and e2): one mul_by_ntt_operand_batch launch forms all
    B products pk*u_i.  Element i equals ``encrypt_from_noise`` of pts[i]
    with its own column of draws."""
    tb = ctx.ntt_q
    shape = (tb.k, len(pts), tb.n)
    if not pts or any(x.shape != shape for x in (u, e1, e2)):
        raise ValueError(f"encrypt_batch_from_noise: {len(pts)} plaintexts, draws "
                         f"{[list(x.shape) for x in (u, e1, e2)]}, expected "
                         f"{list(shape)} each")
    p3 = _p3(tb)
    pk_u = ntt_cuda.mul_by_ntt_operand_batch(u, pk.data, tb)     # [k, 2, B, n]
    delta, _ = ctx.delta_levels[0]
    dm = mm.mul_mod(torch.stack([pt.data for pt in pts])[None],
                    delta.view(-1, 1, 1), p3)                    # [k, B, n]
    c0 = mm.add_mod(mm.add_mod(pk_u[:, 0], e1, p3), dm, p3)
    c1 = mm.add_mod(pk_u[:, 1], e2, p3)
    return _split_batch(torch.stack([c0, c1], dim=1),
                        [_fresh_noise_budget(ctx)] * len(pts))


def encrypt_batch(ctx: SchemeContext, gen: torch.Generator, pk: PublicKey,
                  pts: list) -> list:
    """Encrypt B plaintexts at once, each with its own draws from ``gen``."""
    p = ctx.params
    primes = ctx.ntt_q.p
    batch = len(pts)
    u = sampling.ternary_rns(gen, primes, batch, p.n, p.security.hamming_weight)
    e1 = sampling.gaussian_rns(gen, primes, p.security.sigma, batch, p.n)
    e2 = sampling.gaussian_rns(gen, primes, p.security.sigma, batch, p.n)
    return encrypt_batch_from_noise(ctx, pk, pts, u, e1, e2)


def decrypt_batch(ctx: SchemeContext, cts: list, sk: SecretKey) -> list:
    """Decrypt B two-component ciphertexts in one decrypt_fused launch: the
    ciphertexts are stacked once and the kernel reads c0 and c1 as [k, B, n]
    views of the stack.  One ciphertext, mixed levels or another component
    count fall back to ``decrypt`` per element, as in the JAX package;
    element i equals decrypt(cts[i])."""
    level = cts[0].level if cts else 0
    if (len(cts) <= 1
            or any(c.level != level or c.num_components != 2 for c in cts)):
        return [decrypt(ctx, ct, sk) for ct in cts]
    tb = _tb(ctx, level)
    data = torch.stack([to_coeff(ctx, ct).data for ct in cts])  # [B, k, 2, n]
    m = decrypt_cuda.decrypt_fused(data[:, :, 0].transpose(0, 1),
                                   data[:, :, 1].transpose(0, 1),
                                   sk.data[:tb.k], tb, ctx.dec_levels[level])
    return [Plaintext(data=m[i]) for i in range(len(cts))]


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
        op = _fwd_q(ctx, op, ct.level)
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
    """NTT-form multiply_plain operand [k-L, 1, n]; compute once and pass as
    ``pt_ntt`` when a plaintext is reused across many products."""
    return _fwd_q(ctx, _lift_plain(ctx, pt, level), level)


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


def _multiply_budget(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> float:
    return _b_of(ctx, a.level, _noise.bfv_multiply(ctx.params, _v_of(ctx, a),
                                                    _v_of(ctx, b)))


def _keyswitch_budget(ctx: SchemeContext, log2_var: float, level: int) -> float:
    """Budget at level L after a key switch adds its noise to variance
    2^log2_var."""
    return _b_of(ctx, level, _noise.add(log2_var, _noise.keyswitch_add(ctx.params, level)))


def _mxu_tensor_product(ctx: SchemeContext, x: torch.Tensor, y: torch.Tensor,
                        level: int, base: str = "q") -> torch.Tensor:
    """(c0, c1, c2) = x (x) y of [k, 2, n] coefficient-domain halves over
    level L's q base or its Bsk base (``base="bsk"``) on the four-step
    engine (``ops/ntt_mxu.py``; ``ctx.use_mxu``): both operands through one
    forward call, the pointwise products, one inverse call; [k, 3, n], not
    scaled by t.  A closed loop, so the engine's own NTT order never leaves
    it.  BFV (both bases) and BGV (q) multiply through it."""
    tbm = (ntt_mxu.slice_tables(ctx.ntt_q_mxu, ctx.k - level) if base == "q"
           else ntt_mxu.slice_tables_last(ctx.ntt_bsk_mxu, ctx.bsk_counts[level]))
    a0, a1, b0, b1 = ntt_mxu.ntt_forward(torch.cat([x, y], dim=1), tbm).unbind(1)
    mul = lambda u, v: ntt_mxu.pointwise_mul(u, v, tbm)
    # a0 b1 + a1 b0 mod p, summed exactly in int64
    c1 = torch.remainder(a0.to(torch.int64) * b1 + a1.to(torch.int64) * b0,
                         tbm.p.view(-1, 1)).to(torch.int32)
    return ntt_mxu.ntt_inverse(torch.stack([mul(a0, b0), c1, mul(a1, b1)], dim=1), tbm)


def _multiply_scaled(ctx: SchemeContext, a: Ciphertext, b: Ciphertext,
                     digits: bool) -> tuple[Ciphertext, torch.Tensor | None]:
    """``multiply_no_relin``, and with ``digits`` also the gadget digits
    [k-L, 1, n] of its c2 (``_digits``), which the conversion kernel stores
    beside c2 (None without)."""
    if a.level != b.level:
        raise ValueError("ciphertext level mismatch")
    if a.num_components != 2 or b.num_components != 2:
        raise ValueError(
            "multiply needs 2-component ciphertexts; relinearize first "
            f"(got {a.num_components} and {b.num_components})")
    level = a.level
    a, b = to_coeff(ctx, a), to_coeff(ctx, b)
    tq, tbsk = ctx.mul_levels[level]
    smq, floor_c, sk = ctx.smq_levels[level], ctx.floor_levels[level], ctx.sk_levels[level]
    dig = _digit_consts(ctx, level) if digits else None
    if ctx.use_mxu:
        # JAX's non-Pallas chain: the centred lift into Bsk, both tensor
        # products on the engine, times t (t < every prime), then the floor
        # and the conversion to q in one launch (fast_floor_fused with sk)
        lift = _rns.sm_mrq(torch.cat([a.data, b.data], dim=1), smq)   # [kb_L, 4, n]
        t = ctx.params.t
        tx_q = mm.mul_mod(_mxu_tensor_product(ctx, a.data, b.data, level), t, _p3(tq))
        tx_bsk = mm.mul_mod(_mxu_tensor_product(ctx, lift[:, :2], lift[:, 2:], level, "bsk"),
                            t, _p3(tbsk))
        out = rns_cuda.fast_floor_fused(tx_q, tx_bsk, floor_c, sk, dig)
    elif ctx.n >= 1024:
        tx_q = ntt_cuda.tensor_product(a.data, b.data, tq)       # [k-L, 3, n]
        ab = torch.cat([a.data, b.data], dim=1)                  # [k-L, 4, n]
        floored = rns_cuda.bsk_branch_fused(ab, tx_q, smq, floor_c, tbsk)
        out = rns_cuda.fast_bconv_sk_fused(floored, sk, dig)
    else:
        # [k-L, 3, n] and [kb_L, 3, n] in one launch
        tx_q, tx_bsk = ntt_cuda.tensor_product(a.data, b.data, tq, lift=(smq, tbsk))
        out = rns_cuda.fast_floor_fused(tx_q, tx_bsk, floor_c, sk, dig)
    data, d = out if digits else (out, None)
    return Ciphertext(data=data, level=level, is_ntt_form=False,
                      noise_budget=_multiply_budget(ctx, a, b)), d


def multiply_no_relin(ctx: SchemeContext, a: Ciphertext,
                      b: Ciphertext) -> Ciphertext:
    """BEHZ RNS tensor product and t/q_L scaling -> 3-component ciphertext,
    at the operands' level with that level's constants and its Bsk base.
    The t-scaled q-side tensor product, the Bsk branch, and the exact
    Shenoy-Kumaresan conversion back to q_L.  At n >= 1024 the
    Bsk branch (lift, Bsk tensor product, floor) is one kernel and the
    conversion another; below, where the JAX package runs the q-side
    product, the lift of both operands (sm_mrq_fused) and the Bsk tensor
    product as three kernels, both products and the lift are one launch
    (tensor_product's Lift lane, reading a and b in place), then the floor
    and the conversion one more (fast_floor_fused with sk): the same
    residues.  With ``ctx.use_mxu`` the lift is ``rns.sm_mrq`` in torch ops,
    both tensor products run on the four-step engine, and the floor and the
    conversion are one fast_floor_fused launch, at any n."""
    return _multiply_scaled(ctx, a, b, digits=False)[0]


def _delta_from_digits(ctx: SchemeContext, d: torch.Tensor, ks_keys: torch.Tensor,
                       level: int = 0) -> torch.Tensor:
    """Coefficient-domain key-switch correction INTT(sum_j NTT(D_j) ⊙ key_j)
    from the per-prime digits d (``_digits``): one keyswitch_fused launch
    for one component (d [k-L, n], returns [k-L, 2, n]) or one
    keyswitch_fused_batch launch for B (d [k-L, B, n], returns
    [k-L, 2, B, n]), reading the stored [kd, k-L, 2, n] keys (keys of the
    level) in place.  At ks_omega > 1 the grouped digits' per-prime
    residues go through the kernels' prereduced lane."""
    tb = _tb(ctx, level)
    keys_t = ks_keys.permute(1, 0, 2, 3)
    fn = ntt_cuda.keyswitch_fused if d.dim() == 2 else ntt_cuda.keyswitch_fused_batch
    if _omega(ctx) > 1:
        return fn(_grouped_digit_residues(ctx, d, level), keys_t, tb, prereduced=True)
    return fn(d, keys_t, tb)


def _keyswitch_delta(ctx: SchemeContext, polys: torch.Tensor,
                     ks_keys: torch.Tensor, level: int = 0) -> torch.Tensor:
    """The key-switch correction of one component [k-L, n] ([k-L, 2, n]) or
    of B components [k-L, B, n] ([k-L, 2, B, n]): their digits (one
    elementwise step), then ``_delta_from_digits``."""
    return _delta_from_digits(ctx, _digits(ctx, polys, level), ks_keys, level)


def _switch_keys_down(ctx: SchemeContext, ks_keys: torch.Tensor,
                      level: int, bgv: bool = False) -> torch.Tensor:
    """Level-0 key-switching keys [kd, k, 2, n] (NTT form) -> keys of level
    L, [kd_L, k-L, 2, n]: digit j encrypts (q/q_j) * target mod q, and
    rounding it down L primes gives an encryption of (q_L/q_j) * target mod
    q_L for every surviving digit (the gadget coefficient divides exactly)
    plus a small rounding error.  One inverse transform of the surviving
    digits, L roundings (mod_switch_drop_last), one forward transform at
    level L; the result is a view of a prime-major tensor, as the kernels
    read it.  At ks_omega > 1 only a level whose k-L primes form whole
    gadget groups has such keys.  BGV keys (``bgv``), whose error is t*e,
    take the t-corrected switch (bgv_mod_switch_drop_last) at every dropped
    prime: the plain rounding breaks that structure, and a BGV multiply
    with such keys decodes wrong from level 1 on."""
    if level == 0:
        return ks_keys
    k, n = ctx.k, ctx.n
    kl, omega = k - level, _omega(ctx)
    if omega > 1 and kl % omega:
        raise ValueError(
            f"ks_omega={omega} keys cannot be switched to level {level} "
            f"({kl} surviving primes is not a whole number of gadget "
            f"groups); use an aligned level or omega=1 keys")
    kd_l = kl // omega
    coeff = _inv_q(ctx, ks_keys[:kd_l].permute(1, 0, 2, 3).reshape(k, kd_l * 2, n))
    for lvl in range(level):
        coeff = (_rns.bgv_mod_switch_drop_last(coeff, ctx.bgv_mod_switch[lvl]) if bgv
                 else _rns.mod_switch_drop_last(coeff, ctx.mod_switch[lvl]))
    return _fwd_q(ctx, coeff, level).view(kl, kd_l, 2, n).permute(1, 0, 2, 3)


def switch_relin_keys(ctx: SchemeContext, rlk: RelinKeys, level: int,
                      bgv: bool = False) -> RelinKeys:
    """Relinearization keys of level L from level-0 keys (see
    _switch_keys_down); pass them with ``keys_at_level=True``.  The FHE
    facade caches them per level."""
    return RelinKeys(data=_switch_keys_down(ctx, rlk.data, level, bgv))


def switch_galois_keys(ctx: SchemeContext, gal_keys: GaloisKeys,
                       level: int, bgv: bool = False) -> GaloisKeys:
    """Galois keys of level L from level-0 keys, every element."""
    return GaloisKeys(data={g: _switch_keys_down(ctx, keys, level, bgv)
                            for g, keys in gal_keys.data.items()})


def _keys_of(ctx: SchemeContext, keys: torch.Tensor, level: int,
             keys_at_level: bool, bgv: bool = False) -> torch.Tensor:
    return keys if keys_at_level else _switch_keys_down(ctx, keys, level, bgv)


def _relinearize_from_digits(ctx: SchemeContext, ct3: Ciphertext, d: torch.Tensor,
                             keys: torch.Tensor, level: int) -> Ciphertext:
    """3 -> 2 components of the coefficient-form ct3 at level L, given the
    gadget digits d [k-L, n] of its c2 and the level's keys."""
    delta = _delta_from_digits(ctx, d, keys, level)
    return ct3.replace(data=mm.add_mod(ct3.data[:, :2], delta, _p3(_tb(ctx, level))),
                       noise_budget=_keyswitch_budget(ctx, _v_of(ctx, ct3), level))


def relinearize(ctx: SchemeContext, ct: Ciphertext, rlk: RelinKeys,
                keys_at_level: bool = False, bgv: bool = False) -> Ciphertext:
    """3 -> 2 components by RNS-digit key switching of c2 onto s, at the
    ciphertext's level; level-0 keys are switched down (t-corrected for
    BGV keys, ``bgv``) unless ``keys_at_level`` says rlk is already the
    level's."""
    if ct.num_components != 3:
        raise ValueError(f"relinearize needs 3 components, got "
                         f"{ct.num_components}")
    level = ct.level
    ct = to_coeff(ctx, ct)
    keys = _keys_of(ctx, rlk.data, level, keys_at_level, bgv)
    return _relinearize_from_digits(ctx, ct, _digits(ctx, ct.data[:, 2], level), keys, level)


def multiply(ctx: SchemeContext, a: Ciphertext, b: Ciphertext,
             rlk: RelinKeys, keys_at_level: bool = False) -> Ciphertext:
    """Full homomorphic multiply: tensor product, scaling, relinearization;
    relinearize(multiply_no_relin(a, b)) bit for bit.  The conversion
    kernel of the scaling stores c2's gadget digits as it stores c2, so no
    digit step runs between the halves."""
    ct3, d = _multiply_scaled(ctx, a, b, digits=True)
    keys = _keys_of(ctx, rlk.data, ct3.level, keys_at_level)
    return _relinearize_from_digits(ctx, ct3, d[:, 0], keys, ct3.level)


def _check_pairs(cts: list, name: str) -> int:
    """Raise unless cts is a non-empty list of 2-component ciphertexts at one
    level; return that level."""
    if not cts:
        raise ValueError(f"{name} needs a non-empty list of ciphertexts")
    for ct in cts:
        if ct.num_components != 2:
            raise ValueError(f"{name} needs 2-component ciphertexts, got "
                             f"{ct.num_components}")
    if any(ct.level != cts[0].level for ct in cts):
        raise ValueError(f"{name}: all ciphertexts at one level")
    return cts[0].level


def multiply_batch(ctx: SchemeContext, cts_a: list, cts_b: list,
                   rlk: RelinKeys, keys_at_level: bool = False) -> list:
    """B independent multiply + relinearize ops at one level through the
    batched kernels: the ciphertexts are stacked once as [B, k-L, 4, n]
    (a || b per element); then tensor_product_batch (q side),
    bsk_branch_fused_batch (lift, Bsk tensor product and floor of all B
    pairs), one fast_bconv_sk_fused over the 3B rows, which also stores the
    gadget digits of the B c2 rows, and one keyswitch_fused_batch for the B
    relinearizations.  Element i equals
    multiply(cts_a[i], cts_b[i], rlk) bit for bit, noise budget included.

    The JAX package runs the Bsk branch here as vmapped jnp chains around
    tensor_product_batch, at every n, because XLA fused them well on the
    TPU; on the card each eager op is a launch, so the port runs the fused
    kernel with a batch axis, which computes the same residues.  With
    ``ctx.use_mxu`` it runs ``multiply`` per pair, as the JAX package does."""
    if len(cts_a) != len(cts_b) or not cts_a:
        raise ValueError("multiply_batch needs equal-length non-empty lists")
    level = _check_pairs(cts_a + cts_b, "multiply_batch")
    if ctx.use_mxu:
        return [multiply(ctx, a, b, rlk, keys_at_level) for a, b in zip(cts_a, cts_b)]
    batch, n = len(cts_a), ctx.n
    ab = torch.cat([torch.stack([to_coeff(ctx, a).data for a in cts_a]),
                    torch.stack([to_coeff(ctx, b).data for b in cts_b])],
                   dim=2).permute(1, 2, 0, 3)                    # [k-L, 4, B, n]
    tq, tbsk = ctx.mul_levels[level]
    tx_q = ntt_cuda.tensor_product_batch(ab[:, :2], ab[:, 2:], tq)
    floored = rns_cuda.bsk_branch_fused_batch(
        ab, tx_q, ctx.smq_levels[level], ctx.floor_levels[level], tbsk)  # [kb, 3, B, n]
    out3, d = rns_cuda.fast_bconv_sk_fused(floored.view(tbsk.k, 3 * batch, n),
                                           ctx.sk_levels[level], _digit_consts(ctx, level))
    out3 = out3.view(tq.k, 3, batch, n)
    delta = _delta_from_digits(ctx, d, _keys_of(ctx, rlk.data, level, keys_at_level),
                               level)                            # [k-L, 2, B, n]
    data = mm.add_mod(out3[:, :2], delta, tq.p.view(-1, 1, 1, 1))
    # the same two-step bookkeeping as multiply_no_relin -> relinearize (the
    # budget <-> variance round trip clamps at the 0 floor)
    budgets = [_keyswitch_budget(ctx, _noise.bfv_variance(
        ctx.params, level, _multiply_budget(ctx, a, b)), level)
        for a, b in zip(cts_a, cts_b)]
    return _split_batch(data, budgets, level)


# ---------------------------------------------------------------------------
# key switching and Galois rotations
# ---------------------------------------------------------------------------


def key_switch(ctx: SchemeContext, ct: Ciphertext, ks_keys: torch.Tensor,
               keys_at_level: bool = False, bgv: bool = False) -> Ciphertext:
    """Switch a 2-component ciphertext under s' to one under s, where
    ks_keys [kd, k, 2, n] encrypt (q/q_j) * s' (a Galois key, or keys from
    ``_keyswitch_keygen_from_noise``): (c0 + delta0, delta1), delta the
    key-switch correction of c1 (one keyswitch_fused launch).  Level-0 keys
    are switched down to the ciphertext's level unless ``keys_at_level``."""
    if ct.num_components != 2:
        raise ValueError(f"key_switch needs 2 components, got {ct.num_components}")
    level = ct.level
    ct = to_coeff(ctx, ct)
    delta = _keyswitch_delta(ctx, ct.data[:, 1],
                             _keys_of(ctx, ks_keys, level, keys_at_level, bgv), level)
    c0 = mm.add_mod(ct.data[:, :1], delta[:, :1], _p3(_tb(ctx, level)))
    return ct.replace(data=torch.cat([c0, delta[:, 1:]], dim=1))


def _apply_galois_coeff(ctx: SchemeContext, data: torch.Tensor, g: int) -> torch.Tensor:
    """a(x) -> a(x^g) on [k-L, C, n] coefficient-domain residues for any odd
    g: the automorphism_single kernel, on the card at every n."""
    return galois_cuda.automorphism_single(data, g, ctx.ntt_q.p[:data.shape[0]])


def _galois_budget(ctx: SchemeContext, ct: Ciphertext) -> float:
    return _keyswitch_budget(ctx, _noise.galois(_v_of(ctx, ct)), ct.level)


def apply_galois(ctx: SchemeContext, ct: Ciphertext, g: int, gal_keys: GaloisKeys,
                 keys_at_level: bool = False, bgv: bool = False) -> Ciphertext:
    """Automorphism phi_g, then the key switch s(x^g) -> s.  At ks_omega = 1
    one launch, keyswitch_fused's Galois lane, does both from the digits of
    the un-permuted c1 (the digits of phi_g(c1) are theirs gathered, with
    the sign flips negated mod q_j); at ks_omega > 1 the grouped digits are
    a CRT interpolation of the per-prime ones, with which the negation does
    not commute, so phi_g runs first (automorphism_single), then
    key_switch."""
    _check_pairs([ct], "apply_galois")
    ct = to_coeff(ctx, ct)
    budget = _galois_budget(ctx, ct)
    if _omega(ctx) > 1:
        permuted = ct.replace(data=_apply_galois_coeff(ctx, ct.data, g))
        return key_switch(ctx, permuted, gal_keys.data[g], keys_at_level, bgv).replace(
            noise_budget=budget)
    level = ct.level
    keys = _keys_of(ctx, gal_keys.data[int(g)], level, keys_at_level, bgv)
    data = ntt_cuda.keyswitch_fused(_digits(ctx, ct.data[:, 1], level),
                                    keys.permute(1, 0, 2, 3), _tb(ctx, level),
                                    g=int(g), c0=ct.data[:, 0])
    return ct.replace(data=data, noise_budget=budget)


def _row_elements(ctx: SchemeContext, steps: int, gal_keys: GaloisKeys) -> list:
    """The power-of-two Galois elements 3^(2^i) mod 2n that rotate the slot
    rows by ``steps``, in order; raise KeyError for a missing key."""
    m = 2 * ctx.n
    steps = steps % (ctx.n // 2)
    elements = []
    bit = 1
    while steps:
        if steps & bit:
            g = pow(3, bit, m)
            if g not in gal_keys.data:
                raise KeyError(f"no galois key for element {g} (step {bit})")
            elements.append(g)
            steps ^= bit
        bit <<= 1
    return elements


def rotate_rows(ctx: SchemeContext, ct: Ciphertext, steps: int, gal_keys: GaloisKeys,
                keys_at_level: bool = False, bgv: bool = False) -> Ciphertext:
    """Cyclic slot rotation within each row of the 2 x (n/2) slot matrix:
    one apply_galois per power-of-two hop of |steps|."""
    for g in _row_elements(ctx, steps, gal_keys):
        ct = apply_galois(ctx, ct, g, gal_keys, keys_at_level, bgv)
    return ct


def rotate_columns(ctx: SchemeContext, ct: Ciphertext, gal_keys: GaloisKeys,
                   keys_at_level: bool = False, bgv: bool = False) -> Ciphertext:
    """Swap the two slot rows: g = 2n - 1."""
    return apply_galois(ctx, ct, 2 * ctx.n - 1, gal_keys, keys_at_level, bgv)


def apply_galois_batch(ctx: SchemeContext, cts: list, g: int, gal_keys: GaloisKeys,
                       keys_at_level: bool = False, bgv: bool = False) -> list:
    """The same automorphism on B ciphertexts at one level, from views of
    their [B, k-L, 2, n] stack: at ks_omega = 1 one keyswitch_fused_batch
    launch in its Galois lane (as apply_galois); at ks_omega > 1 one
    automorphism_fused launch, then one keyswitch_fused_batch launch for the
    B key switches.  Element i equals apply_galois(cts[i], g).  Mixed
    levels fall back to apply_galois per element, as in the JAX package.
    Each element keeps its own scale_t (BGV)."""
    if cts and any(ct.level != cts[0].level for ct in cts):
        return [apply_galois(ctx, ct, g, gal_keys, keys_at_level, bgv) for ct in cts]
    level = _check_pairs(cts, "apply_galois_batch")
    g = int(g)
    keys = _keys_of(ctx, gal_keys.data[g], level, keys_at_level, bgv)
    tb = _tb(ctx, level)
    data = torch.stack([to_coeff(ctx, ct).data for ct in cts]).permute(1, 2, 0, 3)
    budgets = [_galois_budget(ctx, ct) for ct in cts]
    scales = [ct.scale_t for ct in cts]
    if _omega(ctx) == 1:                                          # [k-L, 2, B, n]
        out = ntt_cuda.keyswitch_fused_batch(_digits(ctx, data[:, 1], level),
                                             keys.permute(1, 0, 2, 3), tb, g=g,
                                             c0=data[:, 0])
        return _split_batch(out, budgets, level, scales)
    h = pow(g, -1, 2 * ctx.n)
    permuted = galois_cuda.automorphism_fused(data, (h,) * len(cts), tb.p)
    delta = _keyswitch_delta(ctx, permuted[:, 1], keys, level)
    c0 = mm.add_mod(permuted[:, 0], delta[:, 0], _p3(tb))
    return _split_batch(torch.stack([c0, delta[:, 1]], dim=1), budgets, level, scales)


def rotate_rows_batch(ctx: SchemeContext, cts: list, steps: int, gal_keys: GaloisKeys,
                      keys_at_level: bool = False, bgv: bool = False) -> list:
    """rotate_rows over B ciphertexts: one apply_galois_batch per
    power-of-two hop."""
    for g in _row_elements(ctx, steps, gal_keys):
        cts = apply_galois_batch(ctx, cts, g, gal_keys, keys_at_level, bgv)
    return cts


# ---------------------------------------------------------------------------
# hoisted rotations
# ---------------------------------------------------------------------------


def _digits_ntt(ctx: SchemeContext, poly: torch.Tensor, level: int = 0) -> torch.Tensor:
    """Gadget decomposition of a [k-L, n] coefficient-domain component,
    reduced mod every prime and transformed: [k-L, kd, n] NTT form, one
    ntt_forward launch.  The expensive half of a key switch, which hoisted
    rotations share across many automorphisms."""
    return _fwd_q(ctx, _gadget_digits(ctx, _digits(ctx, poly, level), level), level)


def hoisted_galois_keys(ctx: SchemeContext, gal_keys: GaloisKeys, elements,
                        level: int = 0, keys_at_level: bool = False,
                        bgv: bool = False) -> torch.Tensor:
    """The pre-permuted key stack of the hoisted rotations at level L:
    [k-L, kd, E, 2, n], element e's keys (switched down to the level unless
    ``keys_at_level``) prime-major and gathered along n with
    ``eval_perm_inv(n, g_e)``, since sum_j perm_g(F_j) K_j ==
    perm_g(sum_j F_j inv_perm_g(K_j)).  The gathers are the expensive part
    of a hoisted call: build once per (keys, elements, level) and pass as
    ``pre_keys`` (the FHE facade caches it)."""
    stack = []
    for g in elements:
        keys = _keys_of(ctx, gal_keys.data[int(g)], level, keys_at_level, bgv)
        idx = torch.tensor(eval_perm_inv(ctx.n, int(g)), dtype=torch.int64,
                           device=keys.device)
        stack.append(keys.permute(1, 0, 2, 3).index_select(3, idx))
    return torch.stack(stack, dim=2)


def _hoisted_digits(ctx: SchemeContext, ct: Ciphertext, elements, gal_keys: GaloisKeys,
                    pre_keys, keys_at_level: bool, bgv: bool) -> tuple:
    """(coefficient-domain ct, the [k-L, kd, 1, n] NTT-domain digits of its
    c1, the pre-permuted keys of the elements): the shared half of the
    hoisted rotations."""
    level = _check_pairs([ct], "hoisted rotation")
    ct = to_coeff(ctx, ct)
    keys = (pre_keys if pre_keys is not None
            else hoisted_galois_keys(ctx, gal_keys, elements, level, keys_at_level, bgv))
    return ct, _digits_ntt(ctx, ct.data[:, 1], level)[:, :, None], keys


def apply_galois_hoisted(ctx: SchemeContext, ct: Ciphertext, elements,
                         gal_keys: GaloisKeys, pre_keys: torch.Tensor | None = None,
                         keys_at_level: bool = False, bgv: bool = False) -> list:
    """Many automorphisms of one ciphertext sharing a single gadget
    decomposition: the digits and their transform once, then one
    ks_inner_batch launch in its Galois lane against the pre-permuted keys
    (``hoisted_galois_keys`` of the ciphertext's level), which gathers each
    element's inner products by its automorphism before the inverse and
    adds phi_g(c0).  Returns one ciphertext per Galois element, in order.

    Each output decrypts as apply_galois(ct, g) does, with the same noise
    budget, but is not bit-identical to it: the sign-flipped coefficients
    carry the -d rather than the q_j - d digit representative.  It equals
    the JAX package's apply_galois_hoisted bit for bit."""
    elements = tuple(int(g) for g in elements)
    if not elements:
        return []
    ct, d_ntt, keys = _hoisted_digits(ctx, ct, elements, gal_keys, pre_keys,
                                      keys_at_level, bgv)
    data = ntt_cuda.ks_inner_batch(d_ntt, keys, _tb(ctx, ct.level), elements,
                                   c0=ct.data[:, 0])
    return _split_batch(data, [_galois_budget(ctx, ct)] * len(elements), ct.level,
                        [ct.scale_t] * len(elements))


def apply_galois_hoisted_sum(ctx: SchemeContext, ct: Ciphertext, elements,
                             gal_keys: GaloisKeys,
                             pre_keys: torch.Tensor | None = None,
                             keys_at_level: bool = False, bgv: bool = False) -> Ciphertext:
    """ct + sum_g apply_galois(ct, g) as one hoisted chain: the digits and
    their transform once, one ks_inner_batch launch of the plain inner
    products against the pre-permuted keys, then the automorphism_fused_sum
    launch, which adds c0, applies every element's automorphism and
    accumulates the rotations without writing them out: the sum_slots
    stage.  (Sum lanes of ks_inner that did all of it in one launch ran
    longer than these two launches: PERF.md.)  Decrypts as the composition
    of apply_galois_hoisted with adds, and equals it bit for bit."""
    elements = tuple(int(g) for g in elements)
    level = ct.level
    v = _v_of(ctx, ct)
    v_rot = _noise.add(_noise.galois(v), _noise.keyswitch_add(ctx.params, level))
    acc_v = v
    for _ in elements:
        acc_v = _noise.add(acc_v, v_rot)
    if not elements:
        return ct.replace(noise_budget=_b_of(ctx, level, acc_v))
    ct, d_ntt, keys = _hoisted_digits(ctx, ct, elements, gal_keys, pre_keys,
                                      keys_at_level, bgv)
    tb = _tb(ctx, level)
    delta = ntt_cuda.ks_inner_batch(d_ntt, keys, tb)
    hs = tuple(pow(g, -1, 2 * ctx.n) for g in elements)
    data = galois_cuda.automorphism_fused_sum(delta, hs, tb.p, ct.data[:, 0], ct.data)
    return ct.replace(data=data, noise_budget=_b_of(ctx, level, acc_v))


def apply_galois_hoisted_batch(ctx: SchemeContext, cts: list, elements,
                               gal_keys: GaloisKeys,
                               pre_keys: torch.Tensor | None = None,
                               keys_at_level: bool = False, bgv: bool = False) -> list:
    """Hoisted rotations of C independent ciphertexts by the same elements,
    sharing every launch: one batched digit decomposition (kd * C rows
    through one ntt_forward), then one ks_inner_grouped launch in its Galois
    lane pairing digit stack c with key set e (element c*E + e) and adding
    phi_{g_e}(c0_c).  Returns outs[c][e], equal to
    apply_galois_hoisted(cts[c], elements)[e] bit for bit.  One ciphertext
    or mixed levels fall back to apply_galois_hoisted per ciphertext, as in
    the JAX package (``pre_keys``, made for the first ciphertext's level,
    only serves the ciphertexts at that level)."""
    if not cts:
        return []
    elements = tuple(int(g) for g in elements)
    level = cts[0].level
    if len(cts) == 1 or any(ct.level != level for ct in cts):
        return [apply_galois_hoisted(ctx, ct, elements, gal_keys,
                                     pre_keys if ct.level == level else None,
                                     keys_at_level, bgv)
                for ct in cts]
    _check_pairs(cts, "apply_galois_hoisted_batch")
    num_e = len(elements)
    if not num_e:
        return [[] for _ in cts]
    tb = _tb(ctx, level)
    k, n = tb.k, tb.n
    data = torch.stack([to_coeff(ctx, ct).data for ct in cts], dim=2)   # [k-L, 2, C, n]
    keys = (pre_keys if pre_keys is not None
            else hoisted_galois_keys(ctx, gal_keys, elements, level, keys_at_level, bgv))
    d_all = _gadget_digits(ctx, _digits(ctx, data[:, 1], level), level)  # [k-L, kd, C, n]
    kd = d_all.shape[1]
    d_ntt = ntt_cuda.ntt_forward(d_all.reshape(k, kd * len(cts), n), tb)
    out = ntt_cuda.ks_inner_grouped(d_ntt.view(k, kd, len(cts), n), keys, tb, elements,
                                    c0=data[:, 0])
    flat = _split_batch(out, [_galois_budget(ctx, ct) for ct in cts for _ in range(num_e)],
                        level, [ct.scale_t for ct in cts for _ in range(num_e)])
    return [flat[c * num_e:(c + 1) * num_e] for c in range(len(cts))]


# ---------------------------------------------------------------------------
# modulus switching and the trusted refresh
# ---------------------------------------------------------------------------


def mod_switch_to_next(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    """Drop the level's last prime with exact rounding (round(ct / q_last)
    in the remaining primes): level L -> L + 1.  The noise divides by
    q_last as q does, and the budget gains the rounding and eps * m terms
    of noise.bfv_mod_switch."""
    ct = to_coeff(ctx, ct)
    if ct.level >= ctx.k - 1:
        raise ValueError("already at the last level")
    data = _rns.mod_switch_drop_last(ct.data, ctx.mod_switch[ct.level])
    v = _noise.bfv_mod_switch(ctx.params, ct.level, _v_of(ctx, ct))
    return ct.replace(data=data, level=ct.level + 1,
                      noise_budget=_b_of(ctx, ct.level + 1, v))


def mod_switch_to_level(ctx: SchemeContext, ct: Ciphertext, target: int) -> Ciphertext:
    """mod_switch_to_next until the ciphertext is at level ``target`` (a
    ciphertext already at or below it is returned as it is)."""
    while ct.level < target:
        ct = mod_switch_to_next(ctx, ct)
    return ct


def modulus_raise(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    """Approximate base extension of a leveled ciphertext back to all k
    primes (a bootstrapping step): the fast base conversion q_L -> q adds
    alpha * q_L, alpha < k - L, which the caller absorbs as noise.  The
    noise budget is carried over unchanged, as in the JAX package."""
    if ct.level == 0:
        return ct
    ct = to_coeff(ctx, ct)
    src = ctx.params.q_primes[:ctx.k - ct.level]
    cc = _rns.make_base_conv(src, ctx.params.q_primes, ctx.device)
    return ct.replace(data=_rns.fast_base_conv(ct.data, cc), level=0)


def bootstrap(ctx: SchemeContext, gen: torch.Generator, ct: Ciphertext,
              sk: SecretKey, pk: PublicKey) -> Ciphertext:
    """Trusted noise refresh with the secret key: decrypt (at the
    ciphertext's level) and encrypt the plaintext afresh at level 0 with
    draws from ``gen``, recovering the fresh noise budget."""
    return encrypt(ctx, gen, pk, decrypt(ctx, ct, sk))


# ---------------------------------------------------------------------------
# noise-budget diagnostics (host-exact)
# ---------------------------------------------------------------------------


def _modulus(ctx: SchemeContext, level: int) -> int:
    """q_L, the product of the level's primes, as a Python int."""
    return math.prod(ctx.params.q_primes[:ctx.k - level])


def _max_noise(ctx: SchemeContext, level: int, x: torch.Tensor, expected) -> int:
    """The largest centred |[x_j - expected_j]_{q_L}| over the coefficients
    of the phase x [k-L, n] (at least 1), against the Python ints
    ``expected`` [n]: the one big-integer step, the exact CRT on the host."""
    q = _modulus(ctx, level)
    worst = 1
    for c, m in zip(_rns.from_rns_host(x, ctx.params.q_primes[:ctx.k - level]), expected):
        v = (c - m) % q
        worst = max(worst, q - v if v > q // 2 else v)
    return worst


def estimate_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> float:
    """Remaining noise budget in bits, log2(q_L / (2t)) - log2(||v||_inf)
    for the noise v of the phase against Δ_L times the plaintext the
    ciphertext decrypts to.  Once the noise passes the decryption bound the
    decryption flips and the residual against it can still be small, so
    budgets under about 2 bits are unreliable (``exact_noise_budget``
    measures against a known plaintext)."""
    q, t = _modulus(ctx, ct.level), ctx.params.t
    x = _phase(ctx, ct, sk)
    m = _rns.decrypt_scale(x[:, None, :], ctx.dec_levels[ct.level])[0]
    worst = _max_noise(ctx, ct.level, x, [q // t * mj for mj in m.tolist()])
    return max(0.0, math.log2(q / (2 * t)) - math.log2(worst))


def exact_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey,
                       pt: Plaintext) -> float:
    """The noise budget against a known plaintext pt (coefficients mod t):
    it goes negative once the noise crosses the decryption bound.  Residues
    mod q cannot tell noise v from v - q, so past q/2 the reading wraps and
    may look small and positive again: a reading under about 1 bit means at
    or past exhaustion; the tracked noise_budget tells which."""
    q, t = _modulus(ctx, ct.level), ctx.params.t
    worst = _max_noise(ctx, ct.level, _phase(ctx, ct, sk),
                       [q // t * mj for mj in pt.data.tolist()])
    return math.log2(q / (2 * t)) - math.log2(worst)
