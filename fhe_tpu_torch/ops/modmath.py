"""Modular arithmetic on residue tensors — counterpart of ``fhe_tpu/ops/modmath.py``.

Residues are ``torch.int32`` tensors: every modulus here is below 2^30, so
each residue is non-negative and exact in int32, sums stay below 2^31, and
products are formed in int64 (below 2^60) and reduced with an exact ``%``.
Every output is fully reduced, so it matches the JAX package's Shoup and
Barrett results bit for bit.  The CUDA kernels read the same bits as
``uint32`` and do their own Shoup/Barrett arithmetic (``csrc/modmath.cuh``).

Host precomputes (``shoup_precompute``, ``barrett_precompute``) are the
JAX package's formulas; tables holding values up to 2^32 (Shoup companions,
Barrett constants) are stored as int32 tensors carrying the uint32 bits.
"""

from __future__ import annotations

import numpy as np
import torch


def shoup_precompute(w: int, p: int) -> int:
    """Companion constant w' = floor(w * 2^32 / p) (fits uint32 for w < p)."""
    return (w << 32) // p


def barrett_precompute(p: int) -> int:
    """mu = floor(2^61 / p); requires 2^29 < p < 2^30 so mu < 2^32."""
    if not (1 << 29) < p < (1 << 30):
        raise ValueError(f"Barrett constant needs a 30-bit prime, got {p}")
    return (1 << 61) // p


def shoup_array(vals, mods) -> np.ndarray:
    """Elementwise host Shoup companions as uint32 (numpy broadcasting of
    vals against mods): ``shoup_precompute`` for each w < p < 2^32, exact
    in uint64 since w * 2^32 < 2^64."""
    w = np.asarray(vals, dtype=np.uint64)
    p = np.asarray(mods, dtype=np.uint64)
    if np.any(w >= p):
        raise ValueError("shoup_array: every value must be below its modulus")
    return ((w << np.uint64(32)) // p).astype(np.uint32)


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA request without a card raises (there is
    no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def u32_tensor(arr, device) -> torch.Tensor:
    """numpy uint32 -> a new int32 tensor with the same bits, on ``device``."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.tensor(a.view(np.int32), device=resolve_device(device))


def add_mod(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    """(a + b) mod p for a, b in [0, p)."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b
    return torch.where(d < 0, d + p, d)


def mul_mod(a: torch.Tensor, b, p) -> torch.Tensor:
    """a * b mod p, exact through an int64 product (any a, b < 2^31)."""
    b64 = b.to(torch.int64) if isinstance(b, torch.Tensor) else b
    p64 = p.to(torch.int64) if isinstance(p, torch.Tensor) else p
    return torch.remainder(a.to(torch.int64) * b64, p64).to(a.dtype)


def neg_mod(a: torch.Tensor, p) -> torch.Tensor:
    """(-a) mod p for a in [0, p)."""
    return torch.where(a == 0, a, p - a)


def add_mod_tree(x: torch.Tensor, p, axis: int) -> torch.Tensor:
    """Modular sum over ``axis`` by a balanced tree of ``add_mod`` steps
    (the axis keeps length 1), as the JAX package reduces it."""
    while x.shape[axis] > 1:
        m = x.shape[axis]
        half = m // 2
        s = add_mod(x.narrow(axis, 0, half), x.narrow(axis, half, half), p)
        if m % 2:
            s = torch.cat([s, x.narrow(axis, 2 * half, 1)], dim=axis)
        x = s
    return x


# ---------------------------------------------------------------------------
# uint32 twins: the JAX package's word-level arithmetic on int64 tensors
# ---------------------------------------------------------------------------
#
# Each function below takes tensors of any integer dtype (an int32 tensor
# carries uint32 bits; the constants may be Python ints), reads them as
# uint32 values, and returns int64 tensors holding the uint32 results: the
# same values, for the same inputs, as the function of the same name in
# ``fhe_tpu/ops/modmath.py``, including its wraparound mod 2^32 and its lazy
# ranges (``mul_mod_shoup_lazy`` returns r in [0, 2p)).  Every 32 x 32-bit
# product is formed from 16-bit halves, so no int64 intermediate overflows.
# They are plain torch ops on either device, not kernels.

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _u32(x):
    """x as uint32 values: an int64 tensor, or a Python int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul_lo(a, b):
    """(a * b) mod 2^32 of uint32 values a, b."""
    return ((((a >> 16) * b) & _M16) << 16) + (a & _M16) * b & _M32


def umul32_wide(a, b):
    """Full 64-bit product of uint32 values as the (hi, lo) uint32 pair."""
    a, b = _u32(a), _u32(b)
    low = (a & _M16) * b                      # < 2^48
    mid = (a >> 16) * b + (low >> 16)         # < 2^49: a*b = mid*2^16 + low mod 2^16
    return mid >> 16, ((mid & _M16) << 16) | (low & _M16)


def umul32_hi(a, b):
    """High 32 bits of the 64-bit product."""
    return umul32_wide(a, b)[0]


def mul_mod_shoup(x, w, w_shoup, p):
    """x*w mod p for any uint32 x, (w, w_shoup) a ``shoup_precompute`` pair."""
    x, w, w_shoup, p = _u32(x), _u32(w), _u32(w_shoup), _u32(p)
    r = (_mul_lo(x, w) - _mul_lo(umul32_hi(x, w_shoup), p)) & _M32
    return torch.where(r >= p, r - p, r)


def reduce_mod_shoup(x, p, one_shoup):
    """x mod p for any uint32 x and p < 2^31; one_shoup = floor(2^32 / p)."""
    x, p = _u32(x), _u32(p)
    r = (x - _mul_lo(umul32_hi(x, one_shoup), p)) & _M32
    return torch.where(r >= p, r - p, r)


def mul_mod_shoup_lazy(x, w, w_shoup, p):
    """``mul_mod_shoup`` without its last subtraction: r in [0, 2p)."""
    x, w, p = _u32(x), _u32(w), _u32(p)
    return (_mul_lo(x, w) - _mul_lo(umul32_hi(x, w_shoup), p)) & _M32


def mul_mod_barrett(a, b, p, mu):
    """a*b mod p for a, b in [0, p), 2^29 < p < 2^30, mu = floor(2^61/p):
    the quotient estimate from floor(ab / 2^29) * mu, then two conditional
    subtractions."""
    p, mu = _u32(p), _u32(mu)
    hi, lo = umul32_wide(a, b)
    s = ((hi << 3) & _M32) | (lo >> 29)
    r = (lo - _mul_lo(umul32_hi(s, mu), p)) & _M32
    r = torch.where(r >= 2 * p, r - 2 * p, r)
    return torch.where(r >= p, r - p, r)


def barrett_reduce_u32(x, p, mu):
    """x mod p for any uint32 x (p in (2^29, 2^30))."""
    x, p = _u32(x), _u32(p)
    r = (x - _mul_lo(umul32_hi(x >> 29, mu), p)) & _M32
    r = torch.where(r >= 2 * p, r - 2 * p, r)
    return torch.where(r >= p, r - p, r)


def reduce_u64_mod(hi, lo, p, mu, two32_mod_p):
    """(hi * 2^32 + lo) mod p for uint32 hi, lo; two32_mod_p = 2^32 mod p."""
    hi_red = barrett_reduce_u32(hi, p, mu)
    lo_red = barrett_reduce_u32(lo, p, mu)
    return add_mod(mul_mod_barrett(hi_red, two32_mod_p, p, mu), lo_red, _u32(p))


def montgomery_precompute(p: int) -> tuple[int, int, int]:
    """(-p^-1 mod 2^32, 2^64 mod p, 2^32 mod p)."""
    p_inv = pow(p, -1, 1 << 32)
    return ((1 << 32) - p_inv) % (1 << 32), (1 << 64) % p, (1 << 32) % p


def mul_mod_montgomery(a, b, p, p_neg_inv):
    """REDC(a*b) = a*b*2^-32 mod p for a, b in [0, p), p < 2^31."""
    p = _u32(p)
    hi, lo = umul32_wide(a, b)
    mp_hi, _ = umul32_wide(_mul_lo(lo, _u32(p_neg_inv)), p)
    # lo + (m*p mod 2^32) == 0 mod 2^32 by construction: a carry iff lo != 0
    t = (hi + mp_hi + torch.where(lo != 0, 1, 0)) & _M32
    return torch.where(t >= p, t - p, t)


def pow_mod(base: torch.Tensor, exp: int, p, mu) -> torch.Tensor:
    """base^exp mod p (Barrett), square and multiply over a host exponent."""
    result = torch.ones_like(base, dtype=torch.int64)
    acc = _u32(base)
    e = int(exp)
    while e:
        if e & 1:
            result = mul_mod_barrett(result, acc, p, mu)
        acc = mul_mod_barrett(acc, acc, p, mu)
        e >>= 1
    return result


def mul_mod_var(a, b, p, one_shoup, two32_mod_p, two32_shoup):
    """a*b mod p for variable a, b in [0, p), any p < 2^29: both halves of
    the 64-bit product reduced by Shoup with w = 1, recombined through
    2^32 mod p."""
    hi, lo = umul32_wide(a, b)
    hi_c = mul_mod_shoup(reduce_mod_shoup(hi, p, one_shoup), two32_mod_p, two32_shoup, p)
    return add_mod(hi_c, reduce_mod_shoup(lo, p, one_shoup), _u32(p))


def pow_mod_var(base: torch.Tensor, exp: int, p, one_shoup, two32_mod_p,
                two32_shoup) -> torch.Tensor:
    """base^exp mod p through ``mul_mod_var`` (small moduli)."""
    result = torch.ones_like(base, dtype=torch.int64)
    acc = _u32(base)
    e = int(exp)
    while e:
        if e & 1:
            result = mul_mod_var(result, acc, p, one_shoup, two32_mod_p, two32_shoup)
        acc = mul_mod_var(acc, acc, p, one_shoup, two32_mod_p, two32_shoup)
        e >>= 1
    return result


def reduce_mod_fermat16(x):
    """Any uint32 x mod 65537, through 2^16 = -1 (mod 65537)."""
    x = _u32(x)
    r = (x & _M16) + 65537 - (x >> 16)
    return torch.where(r >= 65537, r - 65537, r)


def mul_mod_fermat16(a, b):
    """a*b mod 65537 for a, b in [0, 65537): 2^32 = 1 (mod 65537), so the
    product is hi + lo."""
    hi, lo = umul32_wide(a, b)
    s = reduce_mod_fermat16(hi) + reduce_mod_fermat16(lo)
    return torch.where(s >= 65537, s - 65537, s)
