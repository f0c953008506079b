"""Ring ops on [k, batch, n] residues — counterpart of ``fhe_tpu/ops/poly.py``:
the coefficient-wise ``add``, ``sub``, ``mul_scalar`` and ``add_scalar``, the
negacyclic products ``mul_ntt`` (through the NTT) and ``mul_negacyclic``
(the O(n^2) schoolbook check), ``negacyclic_reduce``, ``mod_switch`` and
``estimate_noise``.  Plain PyTorch code on any device; ``mul_ntt``'s
transforms go through the kernel wrappers (``ntt_cuda``)."""

from __future__ import annotations

import math

import torch

from . import modmath as mm
from . import ntt_cuda
from . import rns as _rns
from .ntt import NTTTables


def _p3(tb: NTTTables) -> torch.Tensor:
    return tb.p.view(-1, 1, 1)


def add(a: torch.Tensor, b: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    return mm.add_mod(a, b, _p3(tb))


def sub(a: torch.Tensor, b: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    return mm.sub_mod(a, b, _p3(tb))


def mul_scalar(a: torch.Tensor, scalar: int, tb: NTTTables) -> torch.Tensor:
    """a * c mod p per prime, for any Python int c (reduced per prime)."""
    c = torch.tensor([int(scalar) % p for p in tb.primes], dtype=torch.int64,
                     device=a.device)
    return mm.mul_mod(a, c.view(-1, 1, 1), _p3(tb))


def _scalar_residues(scalar, tb: NTTTables) -> torch.Tensor:
    """A Python int (reduced per prime on the host) or [k] residues -> [k]."""
    if isinstance(scalar, torch.Tensor):
        return scalar
    return torch.tensor([int(scalar) % p for p in tb.primes], dtype=torch.int32,
                        device=tb.device)


def add_scalar(a: torch.Tensor, scalar, tb: NTTTables) -> torch.Tensor:
    """a + c mod p added to every coefficient; c a Python int or [k] residues."""
    return mm.add_mod(a, _scalar_residues(scalar, tb).view(-1, 1, 1), _p3(tb))


def mul_ntt(a: torch.Tensor, b: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """Negacyclic product through the NTT (``ntt_cuda.polymul_negacyclic``)."""
    return ntt_cuda.polymul_negacyclic(a, b, tb)


def mul_negacyclic(a: torch.Tensor, b: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """O(n^2) schoolbook negacyclic product, the exact-by-construction check
    of ``mul_ntt`` (small n only: it forms a [k, batch, n, n] tensor):
    c[j] = sum_{i <= j} a_{j-i} b_i - sum_{i > j} a_{n+j-i} b_i."""
    k, batch, n = a.shape
    j = torch.arange(n, device=a.device)
    idx = (j[:, None] - j[None, :]) % n                       # [j, i] -> j - i
    p = tb.p.to(torch.int64).view(k, 1, 1, 1)
    prod = a.to(torch.int64)[:, :, idx] * b.to(torch.int64)[:, :, None, :] % p
    prod = torch.where(j[None, :] > j[:, None], mm.neg_mod(prod, p), prod)
    return (prod.sum(-1) % p.view(k, 1, 1)).to(torch.int32)


def negacyclic_reduce(coeffs2n: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """A [k, B, 2n] raw product reduced mod x^n + 1: c_i - c_{n+i}."""
    n = coeffs2n.shape[-1] // 2
    return mm.sub_mod(coeffs2n[..., :n], coeffs2n[..., n:], _p3(tb))


def mod_switch(a: torch.Tensor, tb_from, tb_to, mc: _rns.ModSwitchConsts) -> torch.Tensor:
    """Exact rounding q'/q * a dropping the last prime: the scheme's
    ``rns.mod_switch_drop_last`` (the tables are not read)."""
    return _rns.mod_switch_drop_last(a, mc)


def estimate_noise(a: torch.Tensor, tb: NTTTables, q_primes: tuple = ()) -> float:
    """log2 of the centred infinity norm of the residues (at least 0).  The
    norm is rounded to float32 as the JAX package rounds it, and its log2
    taken on the host in double precision, so the card and the CPU return
    the same float; it is within one float32 step of the JAX package's
    float32 log2."""
    p = _p3(tb)
    mag = torch.where(a > p // 2, p - a, a)
    return math.log2(max(float(mag.max().cpu().to(torch.float32)), 1.0))
