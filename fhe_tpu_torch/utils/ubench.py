"""Modmul roofline probe — counterpart of ``fhe_tpu/utils/ubench.py``.

``modmul_chain`` applies ``reps`` dependent modular products by one
constant to every element of a [rows, n] block: the hand-written CUDA
kernel of ``csrc/ubench.cu`` for a CUDA tensor (design and bound: the note
at the top of that file), ``modmul_chain_plain`` for a CPU tensor; any
other device raises.  Launches are counted in ``modmul_chain.launches``.
The slope of the kernel's time over ``reps`` is the card's rate for one
step (chip_smoke.py's roofline phase).

The steps are those of the JAX package, in uint32 arithmetic that wraps
mod 2^32: ``exact`` (Shoup), ``lazy`` (Shoup without the closing
subtract, output in [0, 2p)), ``barrett``, and two calibration chains,
``cheap17`` (17 adds, shifts and masks shaped like the lazy product) and
``mul17`` (16 squarings and a product by w).  With ``ilp`` > 1 each
element carries that many independent chains, seeded x, x + 1, ..., and
the result is their XOR.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import _build
from ..ops.ntt_cuda import on_card

VARIANTS = ("exact", "lazy", "barrett", "cheap17", "mul17")
ILPS = (1, 2, 4)
UNROLLS = (1, 8)          # the kernel's unrolled loop bodies

_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_U = ctypes.c_uint32
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ubench")
    lib.fhe_modmul_chain.argtypes = [_P, _P, _I] + [_U] * 4 + [_I] * 4 + [_P]
    lib.fhe_modmul_chain.restype = ctypes.c_int
    return lib


def _mul_lo(a, b):
    """(a * b) mod 2^32 for a, b in [0, 2^32) (int64 tensors or ints),
    through 16-bit halves of b so that no int64 product overflows."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def _mul_hi(a, b):
    """floor(a * b / 2^32) for a, b in [0, 2^32), as __umulhi."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def _step(variant: str, v, w: int, w_sh: int, p: int, mu: int):
    if variant in ("exact", "lazy"):
        r = (_mul_lo(v, w) - _mul_lo(_mul_hi(v, w_sh), p)) & _M32
        return r if variant == "lazy" else torch.where(r >= p, r - p, r)
    if variant == "barrett":
        s = ((_mul_hi(v, w) << 3) | (_mul_lo(v, w) >> 29)) & _M32
        r = (_mul_lo(v, w) - _mul_lo(_mul_hi(s, mu), p)) & _M32
        r = torch.where(r >= 2 * p, r - 2 * p, r)
        return torch.where(r >= p, r - p, r)
    if variant == "cheap17":
        a0, a1 = v & 0xFFFF, v >> 16
        ll, lh, hl, hh = ((a + c) & _M32 for a, c in ((a0, w), (a0, w_sh), (a1, w),
                                                      (a1, w_sh)))
        mid = (lh + (ll >> 16)) & _M32
        mid2 = (hl + (mid & 0xFFFF)) & _M32
        hi = (hh + (mid >> 16) + (mid2 >> 16)) & _M32
        return (((v + w) & _M32) - ((hi + p) & _M32)) & _M32
    for _ in range(16):                                   # mul17
        v = _mul_lo(v, v)
    return _mul_lo(v, w)


def modmul_chain_plain(x: torch.Tensor, w: int, w_sh: int, p: int, mu: int,
                       reps: int, variant: str = "exact", ilp: int = 1) -> torch.Tensor:
    """Plain version: the same steps in int64, masked to 32 bits after every
    operation.  x and the result are int32 tensors carrying uint32 bits."""
    x64 = x.to(torch.int64) & _M32
    vs = [(x64 + j) & _M32 for j in range(ilp)]
    for _ in range(reps):
        vs = [_step(variant, v, w, w_sh, p, mu) for v in vs]
    acc = vs[0]
    for v in vs[1:]:
        acc = acc ^ v
    return (acc - ((acc >> 31) << 32)).to(torch.int32)


def modmul_chain(x: torch.Tensor, w: int, w_sh: int, p: int, mu: int, reps: int,
                 variant: str = "exact", unroll: int = 8, ilp: int = 1) -> torch.Tensor:
    """``reps`` dependent products of every element of x [rows, n] (int32,
    uint32 bits) by the constant (w, w_sh) mod p (mu: p's Barrett constant,
    read by ``barrett``), each element carrying ``ilp`` chains; reps must
    be a multiple of ``unroll``.  Returns [rows, n]."""
    if variant not in VARIANTS or ilp not in ILPS or unroll not in UNROLLS:
        raise ValueError(f"modmul_chain: variant {variant!r}, ilp {ilp}, unroll "
                         f"{unroll}; expected one of {VARIANTS}, {ILPS}, {UNROLLS}")
    if reps < 0 or reps % unroll:
        raise ValueError(f"modmul_chain: reps {reps} is not a multiple of {unroll}")
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"modmul_chain: expected a contiguous int32 [rows, n] "
                         f"tensor, got {x.dtype} {list(x.shape)}")
    if not 0 < x.numel() < 1 << 31:
        raise ValueError(f"modmul_chain: {x.numel()} elements")
    if not on_card(x, "modmul_chain"):
        return modmul_chain_plain(x, w, w_sh, p, mu, reps, variant, ilp)
    out = torch.empty_like(x)
    _build.launch(_lib().fhe_modmul_chain, "modmul_chain", x.device, _build.ptr(x),
                  _build.ptr(out), x.numel(), w, w_sh, p, mu, reps,
                  VARIANTS.index(variant), ilp, unroll)
    modmul_chain.launches += 1
    return out


modmul_chain.launches = 0
