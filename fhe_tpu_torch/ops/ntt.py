"""Negacyclic NTT over RNS prime stacks — counterpart of ``fhe_tpu/ops/ntt.py``.

Order: merged-ψ Cooley–Tukey forward, natural order in, bit-reversed order
out; Gentleman–Sande inverse, bit-reversed in, natural out, ending with the
×n⁻¹ scale.  NTT-form keys, ciphertexts and plain operands cross between the
two packages, so this order is fixed, not a free choice.

Layout: residue tensors are ``[k, batch, n]`` int32, prime-major.  Tables
keep the compact ``psi_br [k, n]`` form (stage m reads entries m..2m-1);
the CUDA kernels (``ops/ntt_cuda.py``) index the same tables.

The functions here are the plain PyTorch versions of those kernels: exact
int64 products reduced with ``%``.  They run on any device; the package
routes to them only for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import primes as _primes
from . import modmath as mm


@dataclasses.dataclass(frozen=True)
class NTTTables:
    """Per-prime constants on one device.  Tables are [k, n], scalars [k];
    int32 tensors carrying uint32 bits (Shoup companions and Barrett
    constants use the full 32 bits)."""

    p: torch.Tensor              # [k] primes
    mu: torch.Tensor             # [k] Barrett floor(2^61/p); 0 for small p (t)
    psi_br: torch.Tensor         # [k, n] psi^brv(i)
    psi_br_shoup: torch.Tensor
    ipsi_br: torch.Tensor        # [k, n] psi^-brv(i)
    ipsi_br_shoup: torch.Tensor
    n_inv: torch.Tensor          # [k]
    n_inv_shoup: torch.Tensor
    primes: tuple[int, ...] = ()  # the same primes as host ints

    @property
    def k(self) -> int:
        return self.p.shape[0]

    @property
    def n(self) -> int:
        return self.psi_br.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.p.device


FIELDS = tuple(f.name for f in dataclasses.fields(NTTTables)
               if f.name != "primes")


@functools.lru_cache(maxsize=None)
def _build_tables_np(n: int, prime_tuple: tuple[int, ...]) -> dict:
    """Host-side table build, exact Python ints -> numpy uint32."""
    bits = n.bit_length() - 1
    brv = np.array([_primes.bit_reverse(i, bits) for i in range(n)])
    rows = {f: [] for f in FIELDS}
    for p in prime_tuple:
        psi = _primes.negacyclic_psi(n, p)
        ipsi = pow(psi, -1, p)
        pows = np.empty(n, dtype=object)
        ipows = np.empty(n, dtype=object)
        x = y = 1
        for i in range(n):
            pows[i] = x
            ipows[i] = y
            x = x * psi % p
            y = y * ipsi % p
        psi_br = pows[brv]
        ipsi_br = ipows[brv]
        n_inv = pow(n, -1, p)
        rows["p"].append(p)
        # small moduli (t for the encoder) only use Shoup butterflies
        rows["mu"].append(
            mm.barrett_precompute(p) if (1 << 29) < p < (1 << 30) else 0)
        rows["psi_br"].append(psi_br.astype(np.uint32))
        rows["psi_br_shoup"].append(mm.shoup_array(psi_br, [p] * n))
        rows["ipsi_br"].append(ipsi_br.astype(np.uint32))
        rows["ipsi_br_shoup"].append(mm.shoup_array(ipsi_br, [p] * n))
        rows["n_inv"].append(n_inv)
        rows["n_inv_shoup"].append(mm.shoup_precompute(n_inv, p))
    return {f: np.stack(v).astype(np.uint32) for f, v in rows.items()}


def build_tables(n: int, primes_list, device="cuda") -> NTTTables:
    """NTT tables for ``primes_list`` on ``device`` (default the card)."""
    primes = tuple(int(p) for p in primes_list)
    host = _build_tables_np(n, primes)
    return NTTTables(**{f: mm.u32_tensor(v, device) for f, v in host.items()},
                     primes=primes)


def _p(tb: NTTTables, ndim: int) -> torch.Tensor:
    """[k, 1, ...] int64 prime broadcast for an ndim-dimensional tensor."""
    return tb.p.to(torch.int64).view(-1, *([1] * (ndim - 1)))


def ntt_forward(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT of [k, batch, n] residues, natural ->
    bit-reversed order."""
    k, b, n = a.shape
    p = _p(tb, 4)
    x = a.to(torch.int64)
    m = 1
    while m < n:
        t = n // (2 * m)
        w = tb.psi_br[:, m:2 * m].to(torch.int64).view(k, 1, m, 1)
        x = x.view(k, b, m, 2, t)
        u = x[:, :, :, 0]
        v = (x[:, :, :, 1] * w) % p
        x = torch.stack((mm.add_mod(u, v, p), mm.sub_mod(u, v, p)),
                        dim=3).view(k, b, n)
        m *= 2
    return x.to(torch.int32)


def ntt_inverse(a: torch.Tensor, tb: NTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-reversed -> natural order, times n^-1."""
    k, b, n = a.shape
    p = _p(tb, 4)
    x = a.to(torch.int64)
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        w = tb.ipsi_br[:, m:2 * m].to(torch.int64).view(k, 1, m, 1)
        x = x.view(k, b, m, 2, t)
        u = x[:, :, :, 0]
        v = x[:, :, :, 1]
        x = torch.stack((mm.add_mod(u, v, p), (mm.sub_mod(u, v, p) * w) % p),
                        dim=3).view(k, b, n)
        m //= 2
    return ((x * tb.n_inv.to(torch.int64).view(k, 1, 1)) % _p(tb, 3)
            ).to(torch.int32)


def pointwise_mul(a: torch.Tensor, b: torch.Tensor,
                  tb: NTTTables) -> torch.Tensor:
    """Hadamard product of [k, ..., n] NTT-domain residues."""
    return mm.mul_mod(a, b, _p(tb, a.dim()))


def mul_by_ntt_operand(u: torch.Tensor, w_ntt: torch.Tensor,
                       tb: NTTTables) -> torch.Tensor:
    """INTT(NTT(u) ⊙ w_c) for a [k, 1, n] coefficient-domain u against the
    c rows of a [k, c, n] NTT-form operand; returns [k, c, n]."""
    return ntt_inverse(pointwise_mul(ntt_forward(u, tb).expand_as(w_ntt),
                                     w_ntt, tb), tb)
