"""Modular arithmetic on residue tensors — counterpart of ``fhe_tpu/ops/modmath.py``.

Residues are ``torch.int32`` tensors: every modulus here is below 2^30, so
each residue is non-negative and exact in int32, sums stay below 2^31, and
products are formed in int64 (below 2^60) and reduced with an exact ``%``.
Every output is fully reduced, so it matches the JAX package's Shoup and
Barrett results bit for bit.  The CUDA kernels read the same bits as
``uint32`` and do their own Shoup/Barrett arithmetic (``csrc/modmath.cuh``).

Host precomputes (``shoup_precompute``, ``barrett_precompute``) are the
JAX package's formulas; tables holding values up to 2^32 (Shoup companions,
Barrett constants) are stored as int32 tensors carrying the uint32 bits.
"""

from __future__ import annotations

import numpy as np
import torch


def shoup_precompute(w: int, p: int) -> int:
    """Companion constant w' = floor(w * 2^32 / p) (fits uint32 for w < p)."""
    return (w << 32) // p


def barrett_precompute(p: int) -> int:
    """mu = floor(2^61 / p); requires 2^29 < p < 2^30 so mu < 2^32."""
    if not (1 << 29) < p < (1 << 30):
        raise ValueError(f"Barrett constant needs a 30-bit prime, got {p}")
    return (1 << 61) // p


def shoup_array(vals, mods) -> np.ndarray:
    """Elementwise host Shoup companions as uint32."""
    return np.array([shoup_precompute(int(v), int(p))
                     for v, p in zip(vals, mods)], dtype=np.uint32)


def resolve_device(device) -> torch.device:
    """The requested device; a CUDA request without a card raises (there is
    no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def u32_tensor(arr, device) -> torch.Tensor:
    """numpy uint32 -> a new int32 tensor with the same bits, on ``device``."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.tensor(a.view(np.int32), device=resolve_device(device))


def add_mod(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    """(a + b) mod p for a, b in [0, p)."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b
    return torch.where(d < 0, d + p, d)


def mul_mod(a: torch.Tensor, b, p) -> torch.Tensor:
    """a * b mod p, exact through an int64 product (any a, b < 2^31)."""
    b64 = b.to(torch.int64) if isinstance(b, torch.Tensor) else b
    p64 = p.to(torch.int64) if isinstance(p, torch.Tensor) else p
    return torch.remainder(a.to(torch.int64) * b64, p64).to(a.dtype)
