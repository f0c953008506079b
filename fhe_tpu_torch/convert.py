"""Carry keys, ciphertexts and plaintexts between this package and numpy.

The JAX package holds residues as uint32 arrays in prime-major layout
(``[k, c, n]`` for keys and ciphertexts, ``[kd, k, 2, n]`` for
relinearization keys and for each Galois key, ``[n]`` for plaintexts,
``[n, 2kl, kl, 2, n]`` for each half of a bootstrap key, ``[n]`` and ``[]``
for an LWE sample over Z_2n); these
functions take and return exactly that, so the same state can go through
both packages.  Residues are below 2^31, so the int32 tensors of this
package hold the same values.  State goes to the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.modmath import resolve_device
from .scheme.types import (BootstrapKey, Ciphertext, GaloisKeys, LWECiphertext,
                           Plaintext, PublicKey, RelinKeys, SecretKey)


def _tensor(arr, ndim: int, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.ndim != ndim:
        raise ValueError(f"expected a {ndim}-d array, got shape {a.shape}")
    if a.size and int(a.max()) >= 1 << 31:
        raise ValueError("residue does not fit int32")
    return torch.tensor(a.astype(np.int32), device=resolve_device(device))


def keys_from_numpy(pk_np, sk_np, device="cuda") -> tuple[PublicKey, SecretKey]:
    """pk [k, 2, n] and sk [k, 1, n] NTT-form residues."""
    return (PublicKey(data=_tensor(pk_np, 3, device)),
            SecretKey(data=_tensor(sk_np, 3, device)))


def relin_keys_from_numpy(data, device="cuda") -> RelinKeys:
    """[kd, k, 2, n] NTT-form relinearization keys."""
    return RelinKeys(data=_tensor(data, 4, device))


def galois_keys_from_numpy(data: dict, device="cuda") -> GaloisKeys:
    """A dict of Galois element g -> [kd, k, 2, n] NTT-form keys."""
    return GaloisKeys(data={int(g): _tensor(arr, 4, device)
                            for g, arr in data.items()})


def ciphertext_from_numpy(data, level: int = 0, is_ntt_form: bool = False,
                          noise_budget: float = 0.0, device="cuda",
                          scale_t: int = 1) -> Ciphertext:
    """A [k, c, n] residue stack; ``scale_t`` (BGV's correction factor) may be
    any integer or a 0-d array, as the JAX package carries it."""
    return Ciphertext(data=_tensor(data, 3, device), level=level,
                      is_ntt_form=is_ntt_form, noise_budget=float(noise_budget),
                      scale_t=int(scale_t))


def plaintext_from_numpy(data, device="cuda") -> Plaintext:
    return Plaintext(data=_tensor(data, 1, device))


def lwe_from_numpy(a, b, device="cuda") -> LWECiphertext:
    """An LWE sample over Z_2n: mask a [n] and body b (0-d), both in [0, 2n)."""
    return LWECiphertext(a=_tensor(a, 1, device), b=_tensor(b, 0, device))


def bootstrap_key_from_numpy(pos, neg, level: int = 0, device="cuda") -> BootstrapKey:
    """The RGSW rows of s+ (pos) and s- (neg), [n, 2kl, kl, 2, n] NTT-form
    residues each, made at ``level``."""
    return BootstrapKey(pos=_tensor(pos, 5, device), neg=_tensor(neg, 5, device),
                        level=int(level))


def to_numpy(obj) -> np.ndarray:
    """uint32 residues of a tensor, key, ciphertext or plaintext."""
    data = obj if isinstance(obj, torch.Tensor) else obj.data
    return data.detach().cpu().numpy().astype(np.uint32)
