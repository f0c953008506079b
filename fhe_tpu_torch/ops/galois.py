"""Coefficient Galois automorphisms — counterpart of ``fhe_tpu/ops/galois_pallas.py``.

a(x) -> a(x^g) on Z_p[x]/(x^n + 1) is a signed permutation: with
h = g^-1 mod 2n, out[j] = x[h*j mod n], negated where h*j mod 2n >= n.
These are the plain PyTorch versions of the CUDA kernels in
``ops/galois_cuda.py``: the source index and sign come from the same
formula, as int64 tensors, and ``torch.gather`` does the permutation.
"""

from __future__ import annotations

import torch

from . import modmath as mm


def automorphism_fused(x: torch.Tensor, hs: tuple[int, ...], p: torch.Tensor,
                       c0: torch.Tensor | None = None) -> torch.Tensor:
    """Element b of x [k, C, B, n] gets the automorphism with multiplier
    hs[b] (h = g^-1 mod 2n).  c0, if given, is added mod p to component 0
    before the permutation: [k, n] for every element, [k, B, n] per element.
    p: the [k] primes.  Returns [k, C, B, n]."""
    k, num_c, batch, n = x.shape
    j = torch.arange(n, dtype=torch.int64, device=x.device)
    h = torch.tensor(hs, dtype=torch.int64, device=x.device).view(batch, 1)
    hj = h * j % (2 * n)                                       # [B, n]
    p4 = p.view(k, 1, 1, 1)
    if c0 is not None:
        c0 = c0.view(k, 1, 1, n) if c0.dim() == 2 else c0[:, None]
        x = torch.cat([mm.add_mod(x[:, :1], c0, p4), x[:, 1:]], dim=1)
    out = torch.gather(x, 3, (hj % n).expand(k, num_c, batch, n))
    return torch.where(hj >= n, mm.sub_mod(torch.zeros_like(out), out, p4), out)


def automorphism_fused_sum(x: torch.Tensor, hs: tuple[int, ...], p: torch.Tensor,
                           c0: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """base + sum_b phi_{hs[b]}(x_b with c0 added to component 0): x
    [k, C, B, n], c0 [k, n], base [k, C, n]; returns [k, C, n]."""
    rot = automorphism_fused(x, hs, p, c0)
    p3 = p.view(-1, 1, 1)
    acc = base
    for b in range(rot.shape[2]):
        acc = mm.add_mod(acc, rot[:, :, b], p3)
    return acc


def automorphism_single(x: torch.Tensor, g: int, p: torch.Tensor) -> torch.Tensor:
    """a(x) -> a(x^g) on [k, C, n] residues (any odd g)."""
    h = pow(int(g), -1, 2 * x.shape[-1])
    return automorphism_fused(x[:, :, None], (h,), p)[:, :, 0]
