"""Carry keys, ciphertexts and plaintexts between this package and numpy.

The JAX package holds residues as uint32 arrays in prime-major layout
(``[k, c, n]`` for keys and ciphertexts, ``[n]`` for plaintexts); these
functions take and return exactly that, so the same state can go through
both packages.  Residues are below 2^31, so the int32 tensors of this
package hold the same values.  State goes to the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.modmath import resolve_device
from .scheme.types import Ciphertext, Plaintext, PublicKey, SecretKey


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


def ciphertext_from_numpy(data, level: int = 0, is_ntt_form: bool = False,
                          noise_budget: float = 0.0, device="cuda") -> Ciphertext:
    return Ciphertext(data=_tensor(data, 3, device), level=level,
                      is_ntt_form=is_ntt_form, noise_budget=float(noise_budget))


def plaintext_from_numpy(data, device="cuda") -> Plaintext:
    return Plaintext(data=_tensor(data, 1, device))


def to_numpy(obj) -> np.ndarray:
    """uint32 residues of a tensor, key, ciphertext or plaintext."""
    data = obj if isinstance(obj, torch.Tensor) else obj.data
    return data.detach().cpu().numpy().astype(np.uint32)
