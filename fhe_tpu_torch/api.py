"""High-level FHE API — counterpart of the ``FHE`` facade in ``fhe_tpu/api.py``,
restricted to the ops this package has so far, at level 0.

    from fhe_tpu_torch import FHE
    fhe = FHE(poly_degree=8192, log_q=90, hamming_weight=64)   # on the card
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=(3, 2 * 8192 - 1))
    ct = fhe.encrypt(fhe.encode([1, 2, 3]), pk)
    out = fhe.decode(fhe.decrypt(fhe.multiply(ct, fhe.add(ct, ct), rlk), sk))
    rot = fhe.decode(fhe.decrypt(fhe.rotate_rows(ct, 1, gk), sk))  # [2, 3, ...]
    cts = fhe.encrypt_batch([fhe.encode([i]) for i in range(8)], pk)
    prods = fhe.multiply_batch(cts, cts, rlk)                      # serving batch

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
from .scheme.types import (Ciphertext, GaloisKeys, Plaintext, PublicKey,
                           RelinKeys, SecretKey)


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

    def galoiskey_gen(self, sk: SecretKey, elements=None) -> GaloisKeys:
        """Galois keys for ``elements`` (default: the power-of-two row
        rotations both ways and the column swap)."""
        return bfv.galoiskey_gen(self.ctx, self.gen, sk, elements)

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

    def encrypt_batch(self, pts: list, pk: PublicKey) -> list:
        """Encrypt B plaintexts in one batched pk*u launch; element i is an
        independent fresh encryption."""
        return bfv.encrypt_batch(self.ctx, self.gen, pk, pts)

    def decrypt_batch(self, cts: list, sk: SecretKey) -> list:
        """Decrypt B ciphertexts in one fused launch; element i equals
        decrypt(cts[i], sk)."""
        return bfv.decrypt_batch(self.ctx, cts, sk)

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

    def multiply_batch(self, cts_a: list, cts_b: list, rlk: RelinKeys) -> list:
        """Multiply + relinearize B independent pairs through the batched
        kernels (the serving path); element i equals
        multiply(cts_a[i], cts_b[i], rlk)."""
        return bfv.multiply_batch(self.ctx, cts_a, cts_b, rlk)

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

    # -- rotations and key switching --
    def rotate_rows(self, ct: Ciphertext, steps: int,
                    gal_keys: GaloisKeys) -> Ciphertext:
        return bfv.rotate_rows(self.ctx, ct, steps, gal_keys)

    def rotate_rows_batch(self, cts: list, steps: int,
                          gal_keys: GaloisKeys) -> list:
        """Rotate B ciphertexts by the same step count, one batched
        automorphism and key switch per hop; element i equals
        rotate_rows(cts[i], steps)."""
        return bfv.rotate_rows_batch(self.ctx, cts, steps, gal_keys)

    def rotate_columns(self, ct: Ciphertext, gal_keys: GaloisKeys) -> Ciphertext:
        return bfv.rotate_columns(self.ctx, ct, gal_keys)

    def key_switch(self, ct: Ciphertext, ks_keys: torch.Tensor) -> Ciphertext:
        """Switch a 2-component ciphertext under s' to one under s; ks_keys
        [kd, k, 2, n] encrypt (q/q_j) * s'."""
        return bfv.key_switch(self.ctx, ct, ks_keys)

    def rotate_rows_hoisted(self, ct, steps_list, gal_keys):
        raise NotImplementedError(
            "hoisted rotations (ks_inner_batch, automorphism_fused_sum) are not "
            "ported yet; use rotate_rows per step")

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
