"""Key / ciphertext / plaintext types — counterpart of ``fhe_tpu/scheme/types.py``.

Frozen dataclasses over int32 residue tensors, prime-major ``[k, ..., n]``.
``noise_budget`` is a host float following the variance model of
``scheme/noise.py``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Plaintext:
    """Polynomial mod t."""

    data: torch.Tensor  # [n] int32, coefficients mod t
    is_ntt_form: bool = False


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """(c0, c1, ...) residue stack."""

    data: torch.Tensor  # [k, num_components, n] int32
    level: int = 0
    is_ntt_form: bool = False
    noise_budget: float = 0.0

    @property
    def num_components(self) -> int:
        return self.data.shape[1]

    def replace(self, **changes) -> "Ciphertext":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class PublicKey:
    """(b, a) = (e - a*s, a) in NTT form."""

    data: torch.Tensor  # [k, 2, n] int32, NTT domain


@dataclasses.dataclass(frozen=True)
class SecretKey:
    """Ternary secret in NTT form per prime."""

    data: torch.Tensor  # [k, 1, n] int32, NTT domain
