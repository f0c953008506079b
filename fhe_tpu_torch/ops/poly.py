"""Coefficient-wise ring ops on [k, batch, n] residues — the ``add`` / ``sub``
of ``fhe_tpu/ops/poly.py``.  Plain PyTorch elementwise code on any device."""

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
