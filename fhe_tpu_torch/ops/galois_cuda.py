"""Galois automorphism kernel wrappers — counterpart of ``fhe_tpu/ops/galois_pallas.py``.

``automorphism_fused``, ``automorphism_single`` and
``automorphism_fused_sum`` launch the hand-written CUDA kernels of
``csrc/galois.cu`` (design and bound: the note at the top of that file) for
CUDA tensors and use the plain PyTorch versions of
``ops/galois.py`` for CPU tensors; any other device raises.  Each wrapper
counts only its own launches, in ``<wrapper>.launches``.  The rotations at
ks_omega = 1 and the hoisted ones run their automorphisms inside the
key-switch kernels instead (``ops/ntt_cuda.py``: the Galois lanes of
``keyswitch_fused`` and ``ks_inner_batch``); ``automorphism_fused_sum``
closes each sum_slots stage.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import galois as _galois
from .ntt_cuda import log2_exact, on_card

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("galois")
    lib.fhe_automorphism.argtypes = ([_P] + [_L] * 3 + [_P] + [_L] * 2 + [_P] * 3
                                     + [_I] * 4 + [_P])
    lib.fhe_automorphism.restype = ctypes.c_int
    lib.fhe_automorphism_sum.argtypes = ([_P] + [_L] * 3 + [_P] + [_L] + [_P] + [_L] * 2
                                         + [_P] * 3 + [_I] * 4 + [_P])
    lib.fhe_automorphism_sum.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _multipliers(hs: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The [B] multipliers on the card, built once per (hs, device)."""
    return torch.tensor(hs, dtype=torch.int32, device=device)


def _check(x: torch.Tensor, hs: tuple[int, ...], p: torch.Tensor,
           c0: torch.Tensor | None, name: str) -> None:
    if x.dtype != torch.int32 or p.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues and primes")
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError(f"{name}: expected [k, C, B, n] with rows of n "
                         f"contiguous, got {list(x.shape)} strides {x.stride()}")
    k, _, batch, n = x.shape
    log2_exact(n)
    if p.shape != (k,):
        raise ValueError(f"{name}: primes {list(p.shape)}, expected [{k}]")
    if len(hs) != batch or not all(0 < h < 2 * n and h % 2 for h in hs):
        raise ValueError(f"{name}: need {batch} odd multipliers in (0, {2 * n}), "
                         f"got {hs}")
    if c0 is not None:
        if c0.dtype != torch.int32 or c0.stride(-1) != 1:
            raise ValueError(f"{name}: c0 must be int32 with rows of n contiguous")
        if tuple(c0.shape) not in ((k, n), (k, batch, n)):
            raise ValueError(f"{name}: c0 {list(c0.shape)}, expected [{k}, {n}] "
                             f"or [{k}, {batch}, {n}]")
    if any(t.device != x.device for t in (p, c0) if t is not None):
        raise ValueError(f"{name}: tensors on different devices")


def _launch(x: torch.Tensor, hs: tuple[int, ...], p: torch.Tensor,
            c0: torch.Tensor | None, name: str) -> torch.Tensor:
    k, num_c, batch, n = x.shape
    out = torch.empty((k, num_c, batch, n), dtype=torch.int32, device=x.device)
    if c0 is None:
        c0_args = (None, 0, 0)
    elif c0.dim() == 2:
        c0_args = (_build.ptr(c0), c0.stride(0), 0)
    else:
        c0_args = (_build.ptr(c0), c0.stride(0), c0.stride(1))
    ptr = _build.ptr
    _build.launch(_lib().fhe_automorphism, name, x.device, ptr(x), *x.stride()[:3],
                  *c0_args, ptr(out), ptr(p), ptr(_multipliers(hs, x.device)),
                  k, num_c, batch, log2_exact(n))
    return out


def automorphism_fused(x: torch.Tensor, hs: tuple[int, ...], p: torch.Tensor,
                       c0: torch.Tensor | None = None) -> torch.Tensor:
    """Per-element coefficient automorphisms in one launch.

    x:  [k, C, B, n] residues, rows of n contiguous (a view of a
        [B, k, C, n] stack is read in place); element b gets the
        multiplier hs[b] = g_b^-1 mod 2n: out[j] = +-x[hs[b]*j mod n]
    p:  [k] primes
    c0: optional [k, n] (shared) or [k, B, n] (per element) residues added
        mod p to component 0 before the permutation
    Returns [k, C, B, n]."""
    hs = tuple(int(h) for h in hs)
    _check(x, hs, p, c0, "automorphism_fused")
    if not on_card(x, "automorphism_fused"):
        return _galois.automorphism_fused(x, hs, p, c0)
    out = _launch(x, hs, p, c0, "automorphism_fused")
    automorphism_fused.launches += 1
    return out


automorphism_fused.launches = 0


def automorphism_fused_sum(x: torch.Tensor, hs: tuple[int, ...], p: torch.Tensor,
                           c0: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """base + sum_b phi_{hs[b]}((x_b0 + c0, x_b1, ...)) in one launch: the
    accumulating epilogue of a hoisted rotate-and-sum.

    x:    [k, C, B, n] residues, rows of n contiguous (element b gets the
          multiplier hs[b] = g_b^-1 mod 2n, as in ``automorphism_fused``)
    c0:   [k, n] added mod p to component 0 of every element before its
          permutation
    base: [k, C, n] (rows of n contiguous) accumulated into the output
    Returns [k, C, n]."""
    hs = tuple(int(h) for h in hs)
    _check(x, hs, p, c0, "automorphism_fused_sum")
    k, num_c, batch, n = x.shape
    if c0.shape != (k, n):
        raise ValueError(f"automorphism_fused_sum: c0 {list(c0.shape)}, expected "
                         f"[{k}, {n}]")
    if (base.dtype != torch.int32 or base.shape != (k, num_c, n)
            or base.stride(2) != 1 or base.device != x.device):
        raise ValueError(f"automorphism_fused_sum: base must be an int32 "
                         f"[{k}, {num_c}, {n}] tensor on {x.device} with rows of n "
                         f"contiguous, got {base.dtype} {list(base.shape)}")
    if not on_card(x, "automorphism_fused_sum"):
        return _galois.automorphism_fused_sum(x, hs, p, c0, base)
    out = torch.empty((k, num_c, n), dtype=torch.int32, device=x.device)
    ptr = _build.ptr
    _build.launch(_lib().fhe_automorphism_sum, "automorphism_fused_sum", x.device,
                  ptr(x), *x.stride()[:3], ptr(c0), c0.stride(0), ptr(base),
                  base.stride(0), base.stride(1), ptr(out), ptr(p),
                  ptr(_multipliers(hs, x.device)), k, num_c, batch, log2_exact(n))
    automorphism_fused_sum.launches += 1
    return out


automorphism_fused_sum.launches = 0


def automorphism_single(x: torch.Tensor, g: int, p: torch.Tensor) -> torch.Tensor:
    """a(x) -> a(x^g) on [k, C, n] residues (rows of n contiguous) for any
    odd Galois element g: h = g^-1 mod 2n, then the automorphism_fused
    kernel with one element."""
    if x.dim() != 3:
        raise ValueError(f"automorphism_single: expected [k, C, n], got "
                         f"{list(x.shape)}")
    h = pow(int(g), -1, 2 * x.shape[-1])
    _check(x[:, :, None], (h,), p, None, "automorphism_single")
    if not on_card(x, "automorphism_single"):
        return _galois.automorphism_single(x, g, p)
    out = _launch(x[:, :, None], (h,), p, None, "automorphism_single")
    automorphism_single.launches += 1
    return out[:, :, 0]


automorphism_single.launches = 0
