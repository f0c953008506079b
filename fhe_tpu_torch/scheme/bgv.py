"""BGV operations at every level — counterpart of ``fhe_tpu/scheme/bgv.py``.

BGV keeps the plaintext in the low bits of the phase:

    phase = c0 + c1*s = m + t*e   (mod q)

so keys and encryption carry t-scaled errors, the ciphertext multiply is a
plain tensor product mod q (no BEHZ scaling: ``tensor_product`` on the
level's plain q tables, not the t-folded ``ctx.mul_levels``), decryption is
the exact centred reduction [phase]_q mod t (``rns.sm_mrq`` onto the base
{t}, in torch ops, as the JAX package computes it in jnp), and noise is
managed by the t-corrected modulus switch (``rns.bgv_mod_switch_drop_last``).
Each dropped prime divides the plaintext the phase holds by q_last mod t;
a ciphertext carries the product of those factors as ``scale_t`` and
decrypt multiplies it back.

``scale_t`` is always a host int reduced mod t here: the port traces
nothing, so the JAX package's branches for a traced scale_t
(``_t_var_consts``, ``mul_mod_var``, ``pow_mod_var``) reduce to their
host-int branches.

Everything that does not depend on the scheme (the phase, the domain
changes, the key switch, the Galois rotations) is ``scheme/bfv.py``'s,
called with ``bgv=True`` wherever keys are switched down a level.  Each
random entry point has a ``*_from_noise`` twin that takes its draws as
arguments, as in ``scheme/bfv.py``.  Bit for bit equal to
``fhe_tpu.scheme.bgv`` (tests/test_torch_bgv.py).
"""

from __future__ import annotations

import math

import torch

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import ntt_cuda
from ..ops import poly as _poly
from ..ops import rns as _rns
from . import bfv as _bfv
from . import noise as _noise
from .bfv import _lift_plain, _p3, _tb
from .context import SchemeContext
from .types import (Ciphertext, GaloisKeys, Plaintext, PublicKey, RelinKeys,
                    SecretKey)

# the same in both schemes
to_ntt = _bfv.to_ntt
to_coeff = _bfv.to_coeff
plain_ntt_operand = _bfv.plain_ntt_operand


def _t_scale(ctx: SchemeContext, e: torch.Tensor, level: int = 0) -> torch.Tensor:
    """t * e mod q_i on [k-L, B, n] residues."""
    return _poly.mul_scalar(e, ctx.params.t, _tb(ctx, level))


def _fresh_noise_budget(ctx: SchemeContext) -> float:
    """BGV noise is t-scaled from birth: log2(q/2) - log2(t D sqrt(V_fresh))."""
    return max(0.0, _noise.bgv_budget(ctx.params, 0, _noise.fresh_variance(ctx.params)))


def _b_of(ctx: SchemeContext, level: int, log2_var: float) -> float:
    return max(0.0, _noise.bgv_budget(ctx.params, level, log2_var))


def _v_of(ctx: SchemeContext, ct: Ciphertext) -> float:
    return _noise.bgv_variance(ctx.params, ct.level, ct.noise_budget)


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------


def keygen_from_noise(ctx: SchemeContext, s: torch.Tensor, a: torch.Tensor,
                      e: torch.Tensor) -> tuple[PublicKey, SecretKey]:
    """pk = (t*e - a*s, a) in NTT form, so pk0 + pk1*s = t*e, from explicit
    [k, 1, n] draws: s ternary, a uniform, e Gaussian."""
    return _bfv.keygen_from_noise(ctx, s, a, _t_scale(ctx, e))


def keygen(ctx: SchemeContext, gen: torch.Generator) -> tuple[PublicKey, SecretKey]:
    return keygen_from_noise(ctx, *_bfv._keygen_draws(ctx, gen))


def _t_scale_draws(ctx: SchemeContext, e: torch.Tensor) -> torch.Tensor:
    """t * e for key-switch draws [..., k, 1, n]: the t-scaled error of BGV
    keys (the JAX package's ``t_scale_error=True``)."""
    flat = e.reshape(-1, *e.shape[-3:])
    return torch.stack([_t_scale(ctx, x) for x in flat]).view(e.shape)


def relinkey_gen_from_noise(ctx: SchemeContext, sk: SecretKey, a: torch.Tensor,
                            e: torch.Tensor) -> RelinKeys:
    """Relinearization keys from explicit [kd, k, 1, n] draws, error t*e
    (``bfv.relinkey_gen_from_noise``)."""
    return _bfv.relinkey_gen_from_noise(ctx, sk, a, _t_scale_draws(ctx, e))


def relinkey_gen(ctx: SchemeContext, gen: torch.Generator, sk: SecretKey) -> RelinKeys:
    return relinkey_gen_from_noise(ctx, sk, *_bfv._keyswitch_draws(ctx, gen))


def galoiskey_gen_from_noise(ctx: SchemeContext, sk: SecretKey, elements,
                             a: torch.Tensor, e: torch.Tensor) -> GaloisKeys:
    """Galois keys from explicit [E, kd, k, 1, n] draws, error t*e
    (``bfv.galoiskey_gen_from_noise``)."""
    return _bfv.galoiskey_gen_from_noise(ctx, sk, elements, a, _t_scale_draws(ctx, e))


def galoiskey_gen(ctx: SchemeContext, gen: torch.Generator, sk: SecretKey,
                  elements=None) -> GaloisKeys:
    """Galois keys with the port's samplers (``bfv._galois_draws``)."""
    return galoiskey_gen_from_noise(ctx, sk, *_bfv._galois_draws(ctx, gen, elements))


# ---------------------------------------------------------------------------
# encrypt / decrypt
# ---------------------------------------------------------------------------


def encrypt_from_noise(ctx: SchemeContext, pk: PublicKey, pt: Plaintext,
                       u: torch.Tensor, e1: torch.Tensor,
                       e2: torch.Tensor) -> Ciphertext:
    """ct = (pk0*u + t*e1 + m, pk1*u + t*e2) in the coefficient domain, from
    explicit [k, 1, n] draws: u ternary, e1 and e2 Gaussian; pk*u is one
    mul_by_ntt_operand launch."""
    tb = ctx.ntt_q
    p3 = _p3(tb)
    pk_u = ntt_cuda.mul_by_ntt_operand(u, pk.data, tb)          # [k, 2, n]
    c0 = mm.add_mod(mm.add_mod(pk_u[:, :1], _t_scale(ctx, e1), p3),
                    _lift_plain(ctx, pt), p3)
    c1 = mm.add_mod(pk_u[:, 1:], _t_scale(ctx, e2), p3)
    return Ciphertext(data=torch.cat([c0, c1], dim=1), level=0, is_ntt_form=False,
                      noise_budget=_fresh_noise_budget(ctx), scale_t=1)


def encrypt(ctx: SchemeContext, gen: torch.Generator, pk: PublicKey,
            pt: Plaintext) -> Ciphertext:
    return encrypt_from_noise(ctx, pk, pt, *_bfv._encrypt_draws(ctx, gen))


def _mul_mod_t(ctx: SchemeContext, m: torch.Tensor, c: int) -> torch.Tensor:
    """m * c mod t on plaintext coefficients; m itself where c = 1 mod t."""
    t = ctx.params.t
    c %= t
    return m if c == 1 else mm.mul_mod(m, c, t)


def decrypt(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> Plaintext:
    """m = [phase]_q mod t, times the accumulated scale_t: the phase (one
    mul_by_ntt_operand launch per component after c0, ``bfv._phase``), its
    exact centred reduction onto {t} (``rns.sm_mrq``), then scale_t."""
    x = _bfv._phase(ctx, ct, sk)                                 # [k-L, n]
    m = _rns.sm_mrq(x[:, None, :], ctx.bgv_dec_levels[ct.level])[0, 0]
    return Plaintext(data=_mul_mod_t(ctx, m, ct.scale_t))


# ---------------------------------------------------------------------------
# additive and plain ops
# ---------------------------------------------------------------------------


def _check_compat(a: Ciphertext, b: Ciphertext) -> None:
    """Level and domain as in BFV, and one scale_t: a sum of differently
    scaled plaintexts would decrypt wrong."""
    _bfv._check_compat(a, b)
    if a.scale_t != b.scale_t:
        raise ValueError(f"BGV scale_t mismatch ({a.scale_t} vs {b.scale_t}): "
                         "mod-switch both operands to the same level first")


def add(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    return _bfv.add(ctx, a, b)


def sub(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    return _bfv.sub(ctx, a, b)


def _pt_for_scale(ctx: SchemeContext, pt: Plaintext, scale_t: int) -> Plaintext:
    """The phase holds m * scale_t^-1, so a plain operand is divided by
    scale_t first: the sum then decrypts to m_ct + m_pt."""
    t = ctx.params.t
    if scale_t % t == 1:
        return pt
    return Plaintext(data=_mul_mod_t(ctx, pt.data, pow(scale_t, -1, t)),
                     is_ntt_form=pt.is_ntt_form)


def _plain_c0_op(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> torch.Tensor:
    """m / scale_t lifted to the level's primes, in the ciphertext's domain
    (no Δ: BGV's plaintext sits in the low bits)."""
    op = _lift_plain(ctx, _pt_for_scale(ctx, pt, ct.scale_t), ct.level)
    if ct.is_ntt_form:
        op = _bfv._fwd_q(ctx, op, ct.level)
    return op


def add_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    c0 = _poly.add(ct.data[:, :1], _plain_c0_op(ctx, ct, pt), _tb(ctx, ct.level))
    return ct.replace(data=torch.cat([c0, ct.data[:, 1:]], dim=1))


def sub_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    c0 = _poly.sub(ct.data[:, :1], _plain_c0_op(ctx, ct, pt), _tb(ctx, ct.level))
    return ct.replace(data=torch.cat([c0, ct.data[:, 1:]], dim=1))


def multiply_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext,
                   pt_ntt: torch.Tensor | None = None) -> Ciphertext:
    """c_i *= m, BFV's arithmetic (the phase scales by m in both schemes);
    scale_t is multiplicative, so the operand needs no correction."""
    return _bfv.multiply_plain(ctx, ct, pt, pt_ntt)


# ---------------------------------------------------------------------------
# multiply and relinearize
# ---------------------------------------------------------------------------


def _check_product(a: Ciphertext, b: Ciphertext) -> None:
    if a.level != b.level:
        raise ValueError("ciphertext level mismatch")
    if a.scale_t != b.scale_t:
        raise ValueError("BGV scale_t mismatch")
    if a.num_components != 2 or b.num_components != 2:
        raise ValueError(
            "multiply needs 2-component ciphertexts; relinearize first "
            f"(got {a.num_components} and {b.num_components})")


def _product_budget(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> float:
    return _b_of(ctx, a.level, _noise.bgv_multiply(ctx.params, _v_of(ctx, a), _v_of(ctx, b)))


def multiply_no_relin(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """The plain tensor product mod q_L -> 3 components, no rescaling.
    Coefficient-domain operands go through one tensor_product launch on the
    level's plain q tables; two NTT-form operands skip the forward
    transforms: pointwise products, then one ntt_inverse launch."""
    _check_product(a, b)
    level = a.level
    tb = _tb(ctx, level)
    if a.is_ntt_form and b.is_ntt_form:
        af, bf = a.data, b.data
        c0 = _ntt.pointwise_mul(af[:, :1], bf[:, :1], tb)
        c2 = _ntt.pointwise_mul(af[:, 1:], bf[:, 1:], tb)
        c1 = mm.add_mod(_ntt.pointwise_mul(af[:, :1], bf[:, 1:], tb),
                        _ntt.pointwise_mul(af[:, 1:], bf[:, :1], tb), _p3(tb))
        data = _bfv._inv_q(ctx, torch.cat([c0, c1, c2], dim=1), level)
    else:
        data = ntt_cuda.tensor_product(to_coeff(ctx, a).data, to_coeff(ctx, b).data, tb)
    return Ciphertext(data=data, level=level, is_ntt_form=False,
                      scale_t=a.scale_t * b.scale_t % ctx.params.t,
                      noise_budget=_product_budget(ctx, a, b))


def relinearize(ctx: SchemeContext, ct: Ciphertext, rlk: RelinKeys,
                keys_at_level: bool = False) -> Ciphertext:
    """BFV's key switch of c2 onto s (the keys' t-scaled error keeps the
    added term 0 mod t); level-0 keys are switched down t-corrected."""
    return _bfv.relinearize(ctx, ct, rlk, keys_at_level, bgv=True)


def multiply(ctx: SchemeContext, a: Ciphertext, b: Ciphertext, rlk: RelinKeys,
             keys_at_level: bool = False) -> Ciphertext:
    return relinearize(ctx, multiply_no_relin(ctx, a, b), rlk, keys_at_level)


def multiply_batch(ctx: SchemeContext, cts_a: list, cts_b: list, rlk: RelinKeys,
                   keys_at_level: bool = False) -> list:
    """B independent multiply + relinearize ops at one level through the
    batched kernels: the pairs are stacked once as [k-L, 4, B, n], then one
    tensor_product_batch launch on the plain q tables, the gadget digits of
    the B c2 rows, one keyswitch_fused_batch launch and one add_mod.
    Element i equals multiply(cts_a[i], cts_b[i], rlk) bit for bit, budget
    and scale_t included.  One pair, mixed levels or an NTT-form operand
    fall back to multiply per pair, as in the JAX package."""
    if len(cts_a) != len(cts_b) or not cts_a:
        raise ValueError("multiply_batch needs equal-length non-empty lists")
    level = cts_a[0].level
    if len(cts_a) == 1 or any(ct.level != level or ct.is_ntt_form for ct in cts_a + cts_b):
        return [multiply(ctx, a, b, rlk, keys_at_level) for a, b in zip(cts_a, cts_b)]
    for a, b in zip(cts_a, cts_b):
        _check_product(a, b)
    tb = _tb(ctx, level)
    ab = torch.cat([torch.stack([a.data for a in cts_a]),
                    torch.stack([b.data for b in cts_b])],
                   dim=2).permute(1, 2, 0, 3)                    # [k-L, 4, B, n]
    tens = ntt_cuda.tensor_product_batch(ab[:, :2], ab[:, 2:], tb)  # [k-L, 3, B, n]
    keys = _bfv._keys_of(ctx, rlk.data, level, keys_at_level, bgv=True)
    delta = _bfv._delta_from_digits(ctx, _bfv._digits(ctx, tens[:, 2], level), keys,
                                    level)                       # [k-L, 2, B, n]
    data = mm.add_mod(tens[:, :2], delta, tb.p.view(-1, 1, 1, 1))
    # the bookkeeping of multiply_no_relin, then relinearize (the budget <->
    # variance round trip clamps at the 0 floor)
    budgets = [_bfv._keyswitch_budget(ctx, _noise.bfv_variance(
        ctx.params, level, _product_budget(ctx, a, b)), level)
        for a, b in zip(cts_a, cts_b)]
    t = ctx.params.t
    return _bfv._split_batch(data, budgets, level,
                             [a.scale_t * b.scale_t % t for a, b in zip(cts_a, cts_b)])


def switch_relin_keys(ctx: SchemeContext, rlk: RelinKeys, level: int) -> RelinKeys:
    """Relinearization keys of level L, switched down t-corrected: BGV keys
    must never take BFV's rounding switch (their t*e error would break and
    decryptions go wrong without any shape error)."""
    return _bfv.switch_relin_keys(ctx, rlk, level, bgv=True)


def switch_galois_keys(ctx: SchemeContext, gal_keys: GaloisKeys,
                       level: int) -> GaloisKeys:
    """Galois keys of level L, switched down t-corrected."""
    return _bfv.switch_galois_keys(ctx, gal_keys, level, bgv=True)


# ---------------------------------------------------------------------------
# key switching and rotations: BFV's, with BGV keys
# ---------------------------------------------------------------------------


def key_switch(ctx: SchemeContext, ct: Ciphertext, ks_keys: torch.Tensor,
               keys_at_level: bool = False) -> Ciphertext:
    return _bfv.key_switch(ctx, ct, ks_keys, keys_at_level, bgv=True)


def apply_galois(ctx: SchemeContext, ct: Ciphertext, g: int, gal_keys: GaloisKeys,
                 keys_at_level: bool = False) -> Ciphertext:
    return _bfv.apply_galois(ctx, ct, g, gal_keys, keys_at_level, bgv=True)


def rotate_rows(ctx: SchemeContext, ct: Ciphertext, steps: int, gal_keys: GaloisKeys,
                keys_at_level: bool = False) -> Ciphertext:
    return _bfv.rotate_rows(ctx, ct, steps, gal_keys, keys_at_level, bgv=True)


def rotate_columns(ctx: SchemeContext, ct: Ciphertext, gal_keys: GaloisKeys,
                   keys_at_level: bool = False) -> Ciphertext:
    return _bfv.rotate_columns(ctx, ct, gal_keys, keys_at_level, bgv=True)


def hoisted_galois_keys(ctx: SchemeContext, gal_keys: GaloisKeys, elements,
                        level: int = 0, keys_at_level: bool = False) -> torch.Tensor:
    return _bfv.hoisted_galois_keys(ctx, gal_keys, elements, level, keys_at_level,
                                    bgv=True)


def apply_galois_hoisted(ctx: SchemeContext, ct: Ciphertext, elements,
                         gal_keys: GaloisKeys, pre_keys: torch.Tensor | None = None,
                         keys_at_level: bool = False) -> list:
    return _bfv.apply_galois_hoisted(ctx, ct, elements, gal_keys, pre_keys,
                                     keys_at_level, bgv=True)


def apply_galois_hoisted_sum(ctx: SchemeContext, ct: Ciphertext, elements,
                             gal_keys: GaloisKeys, pre_keys: torch.Tensor | None = None,
                             keys_at_level: bool = False) -> Ciphertext:
    return _bfv.apply_galois_hoisted_sum(ctx, ct, elements, gal_keys, pre_keys,
                                         keys_at_level, bgv=True)


def apply_galois_hoisted_batch(ctx: SchemeContext, cts: list, elements,
                               gal_keys: GaloisKeys, pre_keys: torch.Tensor | None = None,
                               keys_at_level: bool = False) -> list:
    return _bfv.apply_galois_hoisted_batch(ctx, cts, elements, gal_keys, pre_keys,
                                           keys_at_level, bgv=True)


# ---------------------------------------------------------------------------
# modulus switching, the trusted refresh, the noise diagnostics
# ---------------------------------------------------------------------------


def mod_switch_to_next(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    """Drop the level's last prime with the mod-t correction, level L ->
    L + 1: BGV's noise management (the noise divides by q_last).  scale_t
    takes the factor q_last mod t."""
    ct = to_coeff(ctx, ct)
    if ct.level >= ctx.k - 1:
        raise ValueError("already at the last level")
    data = _rns.bgv_mod_switch_drop_last(ct.data, ctx.bgv_mod_switch[ct.level])
    q_last = ctx.params.q_primes[ctx.k - 1 - ct.level]
    v = _noise.bgv_mod_switch(ctx.params, ct.level, _v_of(ctx, ct))
    return ct.replace(data=data, level=ct.level + 1,
                      scale_t=ct.scale_t * q_last % ctx.params.t,
                      noise_budget=_b_of(ctx, ct.level + 1, v))


def mod_switch_to_level(ctx: SchemeContext, ct: Ciphertext, target: int) -> Ciphertext:
    while ct.level < target:
        ct = mod_switch_to_next(ctx, ct)
    return ct


def bootstrap(ctx: SchemeContext, gen: torch.Generator, ct: Ciphertext,
              sk: SecretKey, pk: PublicKey) -> Ciphertext:
    """Trusted refresh with the secret key: decrypt, then encrypt afresh at
    level 0."""
    return encrypt(ctx, gen, pk, decrypt(ctx, ct, sk))


def _raw_plaintext(ctx: SchemeContext, ct: Ciphertext, m: torch.Tensor) -> list:
    """The plaintext as the phase holds it, m * scale_t^-1 mod t."""
    t = ctx.params.t
    inv = pow(ct.scale_t, -1, t) if ct.scale_t != 1 else 1
    return [mj * inv % t for mj in m.tolist()]


def estimate_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> float:
    """log2(q_L / 2) - log2(||phase - m||_inf) against the plaintext the
    ciphertext decrypts to (the host CRT of ``bfv.estimate_noise_budget``)."""
    q = _bfv._modulus(ctx, ct.level)
    worst = _bfv._max_noise(ctx, ct.level, _bfv._phase(ctx, ct, sk),
                            _raw_plaintext(ctx, ct, decrypt(ctx, ct, sk).data))
    return max(0.0, math.log2(q / 2.0) - math.log2(worst))


def exact_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey,
                       pt: Plaintext) -> float:
    """The budget against a known plaintext pt (decode side, mod t): negative
    once the noise crosses the decryption bound, with the wrap-around caveat
    of ``bfv.exact_noise_budget``."""
    q = _bfv._modulus(ctx, ct.level)
    worst = _bfv._max_noise(ctx, ct.level, _bfv._phase(ctx, ct, sk),
                            _raw_plaintext(ctx, ct, pt.data))
    return math.log2(q / 2.0) - math.log2(worst)
