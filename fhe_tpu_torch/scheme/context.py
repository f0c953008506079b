"""SchemeContext: the precomputed constants on one device.

Counterpart of ``fhe_tpu/scheme/context.py:make_context``, restricted to what
the linear-ops path (keygen, encrypt, add, plain multiply, decrypt) reads:
the q-basis NTT tables and the level-0 decryption and Δ constants.  The rest
of the JAX context (Bsk tables, BEHZ and key-switch constants, the lower
levels of the modulus chain, Galois tables) comes with the ops that read it.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import rns as _rns
from ..params import SchemeParams, SecurityParams, make_scheme_params


@dataclasses.dataclass(frozen=True)
class SchemeContext:
    params: SchemeParams
    ntt_q: _ntt.NTTTables                          # q basis
    # per-level constants, index = level; only level 0 exists so far
    dec_levels: tuple[_rns.DecryptConsts, ...]     # gamma-trick decryption
    delta_levels: tuple[tuple[torch.Tensor, torch.Tensor], ...]  # (Δ mod q_i, Shoup)

    @property
    def k(self) -> int:
        return self.params.k

    @property
    def n(self) -> int:
        return self.params.n

    @property
    def device(self) -> torch.device:
        return self.ntt_q.device


@functools.lru_cache(maxsize=None)
def _level_host(primes: tuple[int, ...], t: int) -> tuple[np.ndarray, np.ndarray]:
    """(Δ_L mod q_i, Shoup companions) for one level, Δ_L = floor(q_L / t)."""
    delta = math.prod(primes) // t
    delta_mod = [delta % p for p in primes]
    return np.array(delta_mod, dtype=np.uint32), mm.shoup_array(delta_mod, primes)


def make_context(params: SchemeParams | None = None, device="cuda",
                 **security_kw) -> SchemeContext:
    """Build the constants on ``device`` (default the card)."""
    dev = mm.resolve_device(device)
    if params is None:
        params = make_scheme_params(SecurityParams(**security_kw))
    chain = params.q_primes
    delta, delta_sh = _level_host(chain, params.t)
    return SchemeContext(
        params=params,
        ntt_q=_ntt.build_tables(params.n, chain, dev),
        dec_levels=(_rns.make_decrypt(chain, params.t, params.gamma, dev),),
        delta_levels=((mm.u32_tensor(delta, dev), mm.u32_tensor(delta_sh, dev)),),
    )
