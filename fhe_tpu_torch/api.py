"""High-level FHE API — counterpart of the ``FHE`` facade in ``fhe_tpu/api.py``,
restricted to the ops this package has so far, at level 0.

    from fhe_tpu_torch import FHE
    fhe = FHE(poly_degree=8192, log_q=90, hamming_weight=64)   # on the card
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct = fhe.encrypt(fhe.encode([1, 2, 3]), pk)
    out = fhe.decode(fhe.decrypt(fhe.multiply(ct, fhe.add(ct, ct), rlk), sk))

Everything runs on ``device`` ("cuda" by default; a CUDA request without a
card raises).  ``device="cpu"`` runs the plain PyTorch versions of the
kernels.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .params import SchemeParams, SecurityParams, make_scheme_params
from .scheme import bfv
from .scheme import encoder as _encoder
from .scheme.context import SchemeContext, make_context
from .scheme.types import Ciphertext, Plaintext, PublicKey, RelinKeys, SecretKey


class FHE:
    """Stateful convenience wrapper.  Mutable state: the random generator and
    the cache of NTT-form plain operands; all scheme values are immutable."""

    def __init__(self, params: SchemeParams | None = None, seed: int = 0,
                 device="cuda", **security_kw):
        if params is None:
            params = make_scheme_params(SecurityParams(**security_kw))
        self.params = params
        self.ctx: SchemeContext = make_context(params, device=device)
        self.device = self.ctx.device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.encoder = _encoder.BatchEncoder(params, self.device)
        self._plain_ntt_cache: dict = {}

    # -- keys --
    def keygen(self) -> tuple[PublicKey, SecretKey]:
        return bfv.keygen(self.ctx, self.gen)

    def relinkey_gen(self, sk: SecretKey) -> RelinKeys:
        return bfv.relinkey_gen(self.ctx, self.gen, sk)

    # -- encoding (slot semantics by default) --
    def encode(self, values) -> Plaintext:
        return self.encoder.encode(values)

    def decode(self, pt: Plaintext) -> np.ndarray:
        return self.encoder.decode(pt)

    def encode_coeff(self, values) -> Plaintext:
        return _encoder.encode_coeff(self.params, values, self.device)

    def decode_coeff(self, pt: Plaintext) -> np.ndarray:
        return _encoder.decode_coeff(self.params, pt)

    @property
    def slot_count(self) -> int:
        return self.encoder.slot_count

    # -- encrypt / decrypt --
    def encrypt(self, pt: Plaintext, pk: PublicKey) -> Ciphertext:
        return bfv.encrypt(self.ctx, self.gen, pk, pt)

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> Plaintext:
        return bfv.decrypt(self.ctx, ct, sk)

    # -- homomorphic ops --
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return bfv.add(self.ctx, a, b)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return bfv.sub(self.ctx, a, b)

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        return bfv.add_plain(self.ctx, ct, pt)

    def sub_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        return bfv.sub_plain(self.ctx, ct, pt)

    def multiply(self, a: Ciphertext, b: Ciphertext, rlk: RelinKeys) -> Ciphertext:
        return bfv.multiply(self.ctx, a, b, rlk)

    def multiply_no_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return bfv.multiply_no_relin(self.ctx, a, b)

    def relinearize(self, ct: Ciphertext, rlk: RelinKeys) -> Ciphertext:
        return bfv.relinearize(self.ctx, ct, rlk)

    def multiply_plain(self, ct: Ciphertext, pt: Plaintext,
                       cache_operand: bool = False) -> Ciphertext:
        """cache_operand=True computes the NTT-form operand once per
        (pt, level) and reuses it, so a K-term plaintext dot product on an
        NTT-form ciphertext costs no transform per term."""
        op = self.plain_operand(pt, ct.level) if cache_operand else None
        return bfv.multiply_plain(self.ctx, ct, pt, op)

    # -- NTT-form residency --
    def to_ntt(self, ct: Ciphertext) -> Ciphertext:
        return bfv.to_ntt(self.ctx, ct)

    def to_coeff(self, ct: Ciphertext) -> Ciphertext:
        return bfv.to_coeff(self.ctx, ct)

    def plain_operand(self, pt: Plaintext, level: int = 0) -> torch.Tensor:
        """Cached NTT-form multiply_plain operand for a reused Plaintext,
        evicted when the caller drops the Plaintext object."""
        ck = (id(pt), level)
        op = self._plain_ntt_cache.get(ck)
        if op is None:
            op = bfv.plain_ntt_operand(self.ctx, pt, level)
            self._plain_ntt_cache[ck] = op
            weakref.finalize(pt, _evict, self._plain_ntt_cache, id(pt))
        return op


def _evict(cache: dict, obj_id: int) -> None:
    for key in [k for k in cache if k[0] == obj_id]:
        cache.pop(key, None)
