"""Coefficient-wise ring ops on [k, batch, n] residues — the ``add`` / ``sub``
/ ``mul_scalar`` of ``fhe_tpu/ops/poly.py``.  Plain PyTorch elementwise code
on any device."""

from __future__ import annotations

import torch

from . import modmath as mm
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
