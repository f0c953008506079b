"""Key / ciphertext / plaintext types — counterpart of ``fhe_tpu/scheme/types.py``,
and the bootstrapping types of ``fhe_tpu/scheme/bootstrap.py``.

Frozen dataclasses over int32 residue tensors, prime-major ``[k, ..., n]``.
``noise_budget`` is a host float following the variance model of
``scheme/noise.py``; BGV's ``scale_t`` is a host int.
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
    # BGV: each mod switch divides the plaintext the phase holds by q_last
    # mod t; decrypt multiplies back by scale_t = prod(dropped primes) mod t,
    # kept reduced below t.  Always 1 for BFV.
    scale_t: int = 1

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


@dataclasses.dataclass(frozen=True)
class RelinKeys:
    """RNS-digit key-switching keys: digit j is a (b, a) pair encrypting
    (q/q_j) * s^2, in NTT form."""

    data: torch.Tensor  # [kd, k, 2, n] int32, NTT domain


@dataclasses.dataclass(frozen=True)
class GaloisKeys:
    """Key-switching keys per Galois element g: digit j of data[g] is a
    (b, a) pair encrypting (q/q_j) * s(x^g), in NTT form."""

    data: dict[int, torch.Tensor]  # g -> [kd, k, 2, n] int32, NTT domain


@dataclasses.dataclass(frozen=True)
class LWECiphertext:
    """LWE sample over Z_{2n}: phase = b + <a, s> = (2n/2^w) * m + e (mod 2n),
    the output of ``bootstrap.extract_payload``."""

    a: torch.Tensor  # [n] int32 in [0, 2n)
    b: torch.Tensor  # [] int32 in [0, 2n)


@dataclasses.dataclass(frozen=True)
class BootstrapKey:
    """RGSW encryptions of the ternary secret's bits s = s+ - s-, RNS-digit
    gadget, at one level: for each secret coefficient j and each of the
    2*kl gadget rows (kl digits of acc0, kl of acc1) an RLWE pair in NTT
    form.  pos[j] and neg[j] are the [2kl, kl, 2, n] rows of one external
    product."""

    pos: torch.Tensor  # [n, 2kl, kl, 2, n] int32, NTT domain
    neg: torch.Tensor  # [n, 2kl, kl, 2, n] int32, NTT domain
    level: int = 0
