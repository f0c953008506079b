"""BatchEncoder — SIMD slot packing via the mod-t negacyclic NTT.
Counterpart of ``fhe_tpu/scheme/encoder.py``.

slot_count = n/2 in a 2 x (n/2) matrix; slot j of row 0 holds the evaluation
at zeta^(3^j), row 1 at zeta^(-3^j), zeta a primitive 2n-th root of unity
mod t.  The mod-t transforms go through the same NTT wrappers as the
ciphertext primes, with tables for the single modulus t: the CUDA kernels on
the card, the plain versions on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import primes as _primes
from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import ntt_cuda
from ..params import SchemeParams
from .types import Plaintext


def slot_orbit_indices(n: int) -> tuple[list[int], list[int]]:
    """For each slot, the forward-NTT output position holding its evaluation,
    given output[i] = a(psi^(2*brv(i)+1)) (copy of
    ``fhe_tpu.oracle.slot_orbit_indices``)."""
    bits = n.bit_length() - 1
    half = n // 2
    row0, row1 = [], []
    g = 1
    m = 2 * n
    for _ in range(half):
        row0.append(_primes.bit_reverse((g - 1) // 2, bits))
        row1.append(_primes.bit_reverse((m - g - 1) // 2, bits))
        g = g * 3 % m
    return row0, row1


@functools.lru_cache(maxsize=None)
def _slot_positions(n: int) -> np.ndarray:
    """slot j -> evaluation position; encode scatters to and decode gathers
    from the same positions."""
    row0, row1 = slot_orbit_indices(n)
    return np.array(row0 + row1, dtype=np.int64)


def _coeff_vector(values, n: int, t: int) -> np.ndarray:
    """Up to n integers -> [n] representatives mod t (negatives wrap)."""
    arr = np.asarray(values, dtype=np.int64) % t
    if arr.shape[0] > n:
        raise ValueError(f"{arr.shape[0]} values for {n} slots")
    vals = np.zeros(n, dtype=np.int64)
    vals[: arr.shape[0]] = arr
    return vals


class BatchEncoder:
    """Slot encoder on one device (default the card)."""

    def __init__(self, params: SchemeParams, device="cuda"):
        self.params = params
        self.n = params.n
        self.t = params.t
        self.slot_count = params.slot_count
        self.device = mm.resolve_device(device)
        self._tb = _ntt.build_tables(self.n, (self.t,), self.device)
        self._pos = torch.from_numpy(_slot_positions(self.n)).to(self.device)

    def encode(self, values) -> Plaintext:
        """values: up to n integers, row-major over the 2 x n/2 matrix."""
        slots = torch.from_numpy(_coeff_vector(values, self.n, self.t))
        evals = torch.zeros(self.n, dtype=torch.int32, device=self.device)
        evals[self._pos] = slots.to(device=self.device, dtype=torch.int32)
        coeffs = ntt_cuda.ntt_inverse(evals.view(1, 1, self.n), self._tb)
        return Plaintext(data=coeffs.view(self.n))

    def decode(self, pt: Plaintext) -> np.ndarray:
        """All n slot values as uint32."""
        evals = ntt_cuda.ntt_forward(pt.data.reshape(1, 1, self.n).contiguous(),
                                     self._tb)
        return evals.view(self.n)[self._pos].cpu().numpy().astype(np.uint32)


def encode_coeff(params: SchemeParams, values, device="cuda") -> Plaintext:
    """Value i -> coefficient of x^i (products are negacyclic convolutions)."""
    vals = _coeff_vector(values, params.n, params.t)
    return Plaintext(data=torch.from_numpy(vals).to(
        device=mm.resolve_device(device), dtype=torch.int32))


def decode_coeff(params: SchemeParams, pt: Plaintext) -> np.ndarray:
    return pt.data.cpu().numpy().astype(np.uint32)
