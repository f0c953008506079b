"""NTT kernel wrappers — counterpart of ``fhe_tpu/ops/ntt_pallas.py``.

``ntt_forward``, ``ntt_inverse`` and ``mul_by_ntt_operand`` launch the
hand-written CUDA kernels of ``csrc/ntt.cu`` (design and bound: the note at
the top of that file) for CUDA tensors and use the plain PyTorch versions of
``ops/ntt.py`` for CPU tensors; any other device raises.  Each wrapper counts
its kernel launches in ``<wrapper>.launches``.

Residues are int32 ``[k, batch, n]`` tensors; the kernels read the same bits
as uint32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import ntt as _ntt
from .ntt import NTTTables

_P = ctypes.c_void_p
_I = ctypes.c_int

# the kernel keeps a polynomial (or two, for mul_by_ntt_operand) in shared
# memory; a block may use at most 227 KB of it on Hopper
MAX_SMEM = 232448


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ntt")
    lib.fhe_ntt_forward.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.fhe_ntt_inverse.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    lib.fhe_mul_by_ntt_operand.argtypes = [_P] * 11 + [_I] * 3 + [_P]
    for f in (lib.fhe_ntt_forward, lib.fhe_ntt_inverse,
              lib.fhe_mul_by_ntt_operand):
        f.restype = ctypes.c_int
    return lib


def log2_exact(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"n must be a power of two >= 2, got {n}")
    return n.bit_length() - 1


def check_residues(x: torch.Tensor, tb: NTTTables, name: str,
                   strided: bool = False) -> None:
    """Raise unless x is a contiguous int32 [k, *, n] tensor matching tb.
    ``strided=True`` also takes a view whose rows of n are contiguous, for
    a kernel that reads its input through strides."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != tb.k or x.shape[2] != tb.n:
        raise ValueError(f"{name}: expected shape [{tb.k}, *, {tb.n}], "
                         f"got {list(x.shape)}")
    if not (x.stride(2) == 1 if strided else x.is_contiguous()):
        raise ValueError(f"{name}: tensor must be contiguous"
                         + (" along n" if strided else ""))
    if x.device != tb.device:
        raise ValueError(f"{name}: tensor on {x.device}, tables on {tb.device}")


def on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); raise for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _check_smem(n: int, polys: int, name: str) -> None:
    if polys * 4 * n > MAX_SMEM:
        raise ValueError(f"{name}: n={n} needs {polys * 4 * n} bytes of shared "
                         f"memory per block, more than {MAX_SMEM}")


def ntt_forward(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """[k, batch, n] forward NTT, natural -> bit-reversed order."""
    check_residues(a, tb, "ntt_forward")
    if not on_card(a, "ntt_forward"):
        return _ntt.ntt_forward(a, tb)
    k, batch, n = a.shape
    _check_smem(n, 1, "ntt_forward")
    out = torch.empty_like(a)
    p = _build.ptr
    _build.launch(_lib().fhe_ntt_forward, "ntt_forward", a.device,
                  p(a), p(out), p(tb.p), p(tb.psi_br), p(tb.psi_br_shoup),
                  k, batch, log2_exact(n))
    ntt_forward.launches += 1
    return out


ntt_forward.launches = 0


def ntt_inverse(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """[k, batch, n] inverse NTT, bit-reversed -> natural order, times n^-1."""
    check_residues(a, tb, "ntt_inverse")
    if not on_card(a, "ntt_inverse"):
        return _ntt.ntt_inverse(a, tb)
    k, batch, n = a.shape
    _check_smem(n, 1, "ntt_inverse")
    out = torch.empty_like(a)
    p = _build.ptr
    _build.launch(_lib().fhe_ntt_inverse, "ntt_inverse", a.device,
                  p(a), p(out), p(tb.p), p(tb.ipsi_br), p(tb.ipsi_br_shoup),
                  p(tb.n_inv), p(tb.n_inv_shoup), k, batch, log2_exact(n))
    ntt_inverse.launches += 1
    return out


ntt_inverse.launches = 0


def mul_by_ntt_operand(u: torch.Tensor, w_ntt: torch.Tensor,
                       tb: NTTTables) -> torch.Tensor:
    """INTT(NTT(u) ⊙ w_c): u a [k, 1, n] coefficient-domain polynomial, w_ntt
    a [k, c, n] NTT-form operand (the public key in encrypt); returns
    [k, c, n].  The pointwise product is a Barrett multiply, so every prime
    of tb must be a 30-bit prime (mu != 0)."""
    check_residues(u, tb, "mul_by_ntt_operand")
    check_residues(w_ntt, tb, "mul_by_ntt_operand")
    if u.shape[1] != 1:
        raise ValueError(f"mul_by_ntt_operand: u must be [k, 1, n], got "
                         f"{list(u.shape)}")
    if not on_card(u, "mul_by_ntt_operand"):
        return _ntt.mul_by_ntt_operand(u, w_ntt, tb)
    if not all((1 << 29) < q < (1 << 30) for q in tb.primes):
        raise ValueError("mul_by_ntt_operand: needs 30-bit primes (Barrett)")
    k, c, n = w_ntt.shape
    _check_smem(n, 2, "mul_by_ntt_operand")
    out = torch.empty_like(w_ntt)
    p = _build.ptr
    _build.launch(_lib().fhe_mul_by_ntt_operand, "mul_by_ntt_operand",
                  u.device, p(u), p(w_ntt), p(out), p(tb.p), p(tb.mu),
                  p(tb.psi_br), p(tb.psi_br_shoup), p(tb.ipsi_br),
                  p(tb.ipsi_br_shoup), p(tb.n_inv), p(tb.n_inv_shoup), k, c,
                  log2_exact(n))
    mul_by_ntt_operand.launches += 1
    return out


mul_by_ntt_operand.launches = 0
