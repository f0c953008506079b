"""BFV linear operations — counterpart of ``fhe_tpu/scheme/bfv.py``.

keygen, encrypt, decrypt, add / sub, add_plain / sub_plain, multiply_plain
(with a cached NTT-form operand) and the domain changes to_ntt / to_coeff.
The ciphertext multiply, relinearization, rotations and modulus switching
come in later slices.

Every transform goes through the kernel wrappers of ``ops/ntt_cuda.py`` and
``ops/decrypt_cuda.py``: CUDA kernels for tensors on the card, their plain
PyTorch versions for tensors on the CPU.  The elementwise modular ops stay
plain PyTorch on either device.

Randomness comes from an explicit ``torch.Generator``.  ``keygen`` and
``encrypt`` draw with the port's samplers and call ``keygen_from_noise`` and
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
from ..ops import sampling
from . import noise as _noise
from .context import SchemeContext
from .types import Ciphertext, Plaintext, PublicKey, SecretKey


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


def decrypt(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> Plaintext:
    """m = round(t/q * [c0 + c1*s]_q) mod t, phase and exact scaling in one
    fused kernel (ops/decrypt_cuda.py)."""
    if ct.num_components != 2:
        raise NotImplementedError(
            f"{ct.num_components}-component ciphertexts need the multiply "
            "path, which is not ported yet")
    ct = to_coeff(ctx, ct)
    tb = _tb(ctx, ct.level)
    m = decrypt_cuda.decrypt_fused(ct.data[:, 0:1], ct.data[:, 1:2],
                                   sk.data[:tb.k], tb, ctx.dec_levels[ct.level])
    return Plaintext(data=m[0])


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
