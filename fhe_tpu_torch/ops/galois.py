"""Coefficient Galois automorphisms — counterpart of ``fhe_tpu/ops/galois_pallas.py``.

a(x) -> a(x^g) on Z_p[x]/(x^n + 1) is a signed permutation: with
h = g^-1 mod 2n, out[j] = x[h*j mod n], negated where h*j mod 2n >= n.
These are the plain PyTorch versions of the CUDA kernels in
``ops/galois_cuda.py``: the source index and sign come from the same
formula, as int64 tensors, and ``torch.gather`` does the permutation.

``coeff_source`` and ``ntt_source`` are the index formulas the key-switch
kernels' Galois lanes (``csrc/ntt.cu``) compute in place of index tables,
written out the kernels' way; the plain versions of those lanes
(``ops/ntt.py``) take their indices from them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modmath as mm


def coeff_source(n: int, h: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, neg) of the coefficient automorphism with multiplier h =
    g^-1 mod 2n: out[x] = +-a[src[x]], src = h x mod n, negated where
    h x mod 2n >= n.  The kernels form h x in 32 bits, which wraps exactly
    mod 2n since 2n divides 2^32."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    hx = (h * x) % (1 << 32) % (2 * n)
    return hx % n, hx >= n


@functools.lru_cache(maxsize=None)
def _brev(bits: int) -> np.ndarray:
    """The bit reversal of every value below 2^bits over ``bits`` bits."""
    v = np.arange(1 << bits, dtype=np.int64)
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def ntt_source(n: int, g: int, device=None) -> torch.Tensor:
    """src [n] of the automorphism phi_g in the merged-psi NTT domain,
    out[x] = in[src[x]] (``scheme.context.eval_perm``), formed as the
    kernels form it for the 16 consecutive positions x = 16 q + l of a
    group: with g brv'(q) + (g - 1) / 2 = Q 2^(log n - 4) + R (brv'
    reversing log n - 4 bits), src = 16 brv'(R) + brv4((g brv4(l) + Q) mod
    16), one aligned source block of 16, permuted.  Needs n >= 32."""
    lq = n.bit_length() - 5
    if n < 32 or n & (n - 1):
        raise ValueError(f"ntt_source: n must be a power of two >= 32, got {n}")
    brv_q, brv_4 = _brev(lq), _brev(4)
    x = np.arange(n, dtype=np.int64)
    t = g * brv_q[x >> 4] + (g >> 1)
    top = (t >> lq) & 15
    low = brv_4[(g * brv_4[x & 15] + top) & 15]
    src = (brv_q[t & ((1 << lq) - 1)] << 4) | low
    return torch.as_tensor(src, device=device)


def automorphism_fused(x: torch.Tensor, hs: tuple[int, ...], p: torch.Tensor,
                       c0: torch.Tensor | None = None) -> torch.Tensor:
    """Element b of x [k, C, B, n] gets the automorphism with multiplier
    hs[b] (h = g^-1 mod 2n).  c0, if given, is added mod p to component 0
    before the permutation: [k, n] for every element, [k, B, n] per element.
    p: the [k] primes.  Returns [k, C, B, n]."""
    k, num_c, batch, n = x.shape
    src, neg = zip(*(coeff_source(n, h, x.device) for h in hs))
    src, neg = torch.stack(src), torch.stack(neg)                # [B, n]
    p4 = p.view(k, 1, 1, 1)
    if c0 is not None:
        c0 = c0.view(k, 1, 1, n) if c0.dim() == 2 else c0[:, None]
        x = torch.cat([mm.add_mod(x[:, :1], c0, p4), x[:, 1:]], dim=1)
    out = torch.gather(x, 3, src.expand(k, num_c, batch, n))
    return torch.where(neg, mm.sub_mod(torch.zeros_like(out), out, p4), out)


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
