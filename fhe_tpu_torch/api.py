"""High-level FHE API — counterpart of the ``FHE`` facade in ``fhe_tpu/api.py``,
for BFV (``scheme="bfv"``, the default) and BGV (``scheme="bgv"``), at every
level.

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
    gh = fhe.galoiskey_gen(sk, elements=[pow(3, s, 2 * 8192) for s in (1, 2, 3)])
    rots = fhe.rotate_rows_hoisted(ct, (1, 2, 3), gh)              # one decomposition
    gs = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    total = fhe.sum_slots(ct, gs)                                  # every slot: 6

``SecurityParams(ks_omega=2)`` (``FHE(..., ks_omega=2)``) groups two q
primes per gadget digit in every key switch.  ``FHE(..., use_mxu=True)``
runs the ciphertext multiply's tensor products on the four-step int8 GEMM
engine (``ops/ntt_mxu.py``) instead of the NTT kernels: the same residues.

``FHE(..., scheme="bgv")`` runs the same calls on BGV (``scheme/bgv.py``):
the plaintext in the low bits of the phase, t-scaled key and encryption
errors, a plain tensor product mod q, and the t-corrected modulus switch,
which a ciphertext tracks as ``scale_t``.  BGV has no batched
encrypt / decrypt or rotate_rows_batch: those calls run the single op per
ciphertext, as in the JAX facade; modulus_raise is BFV's alone.
``estimate_noise_budget`` and ``exact_noise_budget`` measure a ciphertext's
budget with the secret key in either scheme.

BFV bootstrapping (``scheme/bootstrap.py``; BGV raises NotImplementedError):

    bsk = fhe.make_bootstrap_key(sk)                # RGSW keys of s's bits
    ct = fhe.encrypt(fhe.encode_coeff([1]), pk)
    fresh = fhe.bootstrap_binary(ct, sk, bsk)       # decodes [1], fresh noise
    f = fhe.bootstrap_lut(ct, [0, 1, 4, 4], sk, bsk)  # m -> lut[m], m < 4
    outs = fhe.bootstrap_binary_batch(cts, sk, bsk)   # one batched rotation

The pipeline's final key-switching keys are made once per secret key and
cached (evicted when the caller drops the key).  ``fhe.monitor`` (a
``utils.perf.PerformanceMonitor``) times every op under the JAX facade's
names.

Leveled use: ``mod_switch_to_next`` drops the last q prime with rounding
(``mod_switch_to_level`` several), which keeps the noise of a deep circuit
in check; every op then runs at the ciphertext's level:

    ab = fhe.mod_switch_to_next(fhe.multiply(a, b, rlk))        # level 1
    abc = fhe.multiply(ab, fhe.mod_switch_to_next(c), rlk)
    rot = fhe.rotate_rows(ab, 1, gk)

Keys are made once, at level 0.  A key-switching op at level L switches
them down to L the first time (``bfv.switch_relin_keys`` /
``switch_galois_keys``) and caches the result per (keys, level); the entry
goes when the caller drops the keys.

Everything runs on ``device`` ("cuda" by default; a CUDA request without a
card raises).  ``device="cpu"`` runs the plain PyTorch versions of the
kernels.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .params import SchemeParams, SecurityParams, make_scheme_params
from .scheme import bfv, bgv
from .scheme import bootstrap as _bs
from .scheme import encoder as _encoder
from .scheme.context import SchemeContext, default_galois_elements, make_context
from .scheme.types import (BootstrapKey, Ciphertext, GaloisKeys, LWECiphertext,
                           Plaintext, PublicKey, RelinKeys, SecretKey)
from .utils.perf import PerformanceMonitor


class FHE:
    """Stateful convenience wrapper.  Mutable state: the random generator,
    the performance monitor, the cache of NTT-form plain operands, the
    per-level caches of switched relinearization and Galois keys, the cache
    of pre-permuted hoisted-rotation keys and the bootstrap's key-switching
    keys per secret key; all scheme values are immutable.  The key caches
    belong to the instance, so keys of one scheme are only ever switched
    down with that scheme's constants."""

    def __init__(self, params: SchemeParams | None = None, seed: int = 0,
                 scheme: str = "bfv", device="cuda", use_mxu: bool = False,
                 **security_kw):
        if scheme not in ("bfv", "bgv"):
            raise ValueError(f"unknown scheme {scheme!r}; use 'bfv' or 'bgv'")
        if params is None:
            params = make_scheme_params(SecurityParams(**security_kw))
        self.scheme_name = scheme
        self._scheme = bfv if scheme == "bfv" else bgv
        self.params = params
        self.ctx: SchemeContext = make_context(params, device=device, use_mxu=use_mxu)
        self.device = self.ctx.device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.encoder = _encoder.BatchEncoder(params, self.device)
        self._plain_ntt_cache: dict = {}
        self._hoist_cache: dict = {}
        self._rlk_cache: dict = {}
        self._gal_cache: dict = {}
        self._bootstrap_ks_cache: dict = {}
        self.monitor = PerformanceMonitor()

    # -- keys --
    def keygen(self) -> tuple[PublicKey, SecretKey]:
        with self.monitor.time("keygen"):
            return self._scheme.keygen(self.ctx, self.gen)

    def relinkey_gen(self, sk: SecretKey) -> RelinKeys:
        with self.monitor.time("relinkey_gen"):
            return self._scheme.relinkey_gen(self.ctx, self.gen, sk)

    def galoiskey_gen(self, sk: SecretKey, elements=None) -> GaloisKeys:
        """Galois keys for ``elements`` (default: the power-of-two row
        rotations both ways and the column swap)."""
        with self.monitor.time("galoiskey_gen"):
            return self._scheme.galoiskey_gen(self.ctx, self.gen, sk, elements)

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
        with self.monitor.time("encrypt"):
            return self._scheme.encrypt(self.ctx, self.gen, pk, pt)

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> Plaintext:
        with self.monitor.time("decrypt"):
            return self._scheme.decrypt(self.ctx, ct, sk)

    def encrypt_batch(self, pts: list, pk: PublicKey) -> list:
        """Encrypt B plaintexts in one batched pk*u launch; element i is an
        independent fresh encryption (BGV: one encrypt each)."""
        fn = getattr(self._scheme, "encrypt_batch", None)
        if fn is None:
            return [self.encrypt(pt, pk) for pt in pts]
        with self.monitor.time("encrypt_batch"):
            return fn(self.ctx, self.gen, pk, pts)

    def decrypt_batch(self, cts: list, sk: SecretKey) -> list:
        """Decrypt B ciphertexts in one fused launch; element i equals
        decrypt(cts[i], sk) (BGV: one decrypt each)."""
        fn = getattr(self._scheme, "decrypt_batch", None)
        if fn is None:
            return [self.decrypt(ct, sk) for ct in cts]
        with self.monitor.time("decrypt_batch"):
            return fn(self.ctx, cts, sk)

    # -- homomorphic ops --
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        with self.monitor.time("add"):
            return self._scheme.add(self.ctx, a, b)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        with self.monitor.time("sub"):
            return self._scheme.sub(self.ctx, a, b)

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        return self._scheme.add_plain(self.ctx, ct, pt)

    def sub_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        return self._scheme.sub_plain(self.ctx, ct, pt)

    # -- keys switched down to a level, cached per (keys, level) --
    def _keys_at(self, cache: dict, keys, level: int, switch, label: str):
        """keys switched to ``level`` by ``switch(ctx, keys, level)`` (timed
        as ``label``), made once per (keys, level) and evicted when the
        caller drops the keys; level 0 keys as they are."""
        if level == 0:
            return keys
        ck = (id(keys), level)
        switched = cache.get(ck)
        if switched is None:
            with self.monitor.time(label):
                switched = switch(self.ctx, keys, level)
            cache[ck] = switched
            weakref.finalize(keys, _evict, cache, id(keys))
        return switched

    def _rlk_at(self, rlk: RelinKeys, level: int) -> RelinKeys:
        return self._keys_at(self._rlk_cache, rlk, level, self._scheme.switch_relin_keys,
                             "switch_relin_keys")

    def _gal_at(self, gal_keys: GaloisKeys, level: int) -> GaloisKeys:
        return self._keys_at(self._gal_cache, gal_keys, level,
                             self._scheme.switch_galois_keys, "switch_galois_keys")

    def multiply(self, a: Ciphertext, b: Ciphertext, rlk: RelinKeys) -> Ciphertext:
        rlk_l = self._rlk_at(rlk, a.level)
        with self.monitor.time("multiply"):
            return self._scheme.multiply(self.ctx, a, b, rlk_l, keys_at_level=True)

    def multiply_batch(self, cts_a: list, cts_b: list, rlk: RelinKeys) -> list:
        """Multiply + relinearize B independent pairs at one level through
        the batched kernels (the serving path); element i equals
        multiply(cts_a[i], cts_b[i], rlk)."""
        level = cts_a[0].level if cts_a else 0
        rlk_l = self._rlk_at(rlk, level)
        with self.monitor.time("multiply_batch"):
            return self._scheme.multiply_batch(self.ctx, cts_a, cts_b, rlk_l,
                                               keys_at_level=True)

    def multiply_no_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._scheme.multiply_no_relin(self.ctx, a, b)

    def relinearize(self, ct: Ciphertext, rlk: RelinKeys) -> Ciphertext:
        rlk_l = self._rlk_at(rlk, ct.level)
        with self.monitor.time("relinearize"):
            return self._scheme.relinearize(self.ctx, ct, rlk_l, keys_at_level=True)

    def multiply_plain(self, ct: Ciphertext, pt: Plaintext,
                       cache_operand: bool = False) -> Ciphertext:
        """cache_operand=True computes the NTT-form operand once per
        (pt, level) and reuses it, so a K-term plaintext dot product on an
        NTT-form ciphertext costs no transform per term."""
        op = self.plain_operand(pt, ct.level) if cache_operand else None
        return self._scheme.multiply_plain(self.ctx, ct, pt, op)

    # -- rotations and key switching --
    def rotate_rows(self, ct: Ciphertext, steps: int,
                    gal_keys: GaloisKeys) -> Ciphertext:
        gk = self._gal_at(gal_keys, ct.level)
        with self.monitor.time("rotate"):
            return self._scheme.rotate_rows(self.ctx, ct, steps, gk, keys_at_level=True)

    def rotate_rows_batch(self, cts: list, steps: int,
                          gal_keys: GaloisKeys) -> list:
        """Rotate B ciphertexts at one level by the same step count, one
        batched automorphism and key switch per hop; element i equals
        rotate_rows(cts[i], steps) (BGV: one rotate_rows each)."""
        fn = getattr(self._scheme, "rotate_rows_batch", None)
        if fn is None:
            return [self.rotate_rows(ct, steps, gal_keys) for ct in cts]
        level = cts[0].level if cts else 0
        gk = self._gal_at(gal_keys, level)
        with self.monitor.time("rotate_batch"):
            return fn(self.ctx, cts, steps, gk, keys_at_level=True)

    def rotate_columns(self, ct: Ciphertext, gal_keys: GaloisKeys) -> Ciphertext:
        return self._scheme.rotate_columns(self.ctx, ct, self._gal_at(gal_keys, ct.level),
                                           keys_at_level=True)

    def key_switch(self, ct: Ciphertext, ks_keys: torch.Tensor,
                   keys_at_level: bool = False) -> Ciphertext:
        """Switch a 2-component ciphertext under s' to one under s; ks_keys
        [kd, k, 2, n] encrypt (q/q_j) * s' (switched down to the
        ciphertext's level on each call unless ``keys_at_level``)."""
        with self.monitor.time("key_switch"):
            return self._scheme.key_switch(self.ctx, ct, ks_keys, keys_at_level)

    def _hoist_elements(self, steps_list, gal_keys: GaloisKeys) -> tuple:
        """The Galois elements 3^s mod 2n of the steps; KeyError unless each
        has a direct key."""
        m = 2 * self.params.n
        elements = tuple(pow(3, int(s), m) for s in steps_list)
        for g in elements:
            if g not in gal_keys.data:
                raise KeyError(
                    f"no galois key for element {g}; generate with "
                    f"galoiskey_gen(sk, elements={list(elements)})")
        return elements

    def _hoisted_pre(self, gal_keys: GaloisKeys, elements: tuple,
                     level: int) -> torch.Tensor:
        """The pre-permuted key stack (bfv.hoisted_galois_keys) of the level,
        from the level's cached keys, cached per (level-0 keys, elements,
        level) and evicted when the caller drops the keys."""
        ck = (id(gal_keys), elements, level)
        pre = self._hoist_cache.get(ck)
        if pre is None:
            gk = self._gal_at(gal_keys, level)
            with self.monitor.time("hoisted_galois_keys"):
                pre = self._scheme.hoisted_galois_keys(self.ctx, gk, elements, level,
                                                       keys_at_level=True)
            self._hoist_cache[ck] = pre
            weakref.finalize(gal_keys, _evict, self._hoist_cache, id(gal_keys))
        return pre

    def rotate_rows_hoisted(self, ct: Ciphertext, steps_list,
                            gal_keys: GaloisKeys) -> list:
        """Many row rotations of one ciphertext sharing a single hoisted
        gadget decomposition; element e equals rotate_rows(ct,
        steps_list[e]) by decryption.  Each step needs a direct Galois key:
        galoiskey_gen(sk, elements=[pow(3, s, 2n) for s in steps_list])."""
        elements = self._hoist_elements(steps_list, gal_keys)
        pre = self._hoisted_pre(gal_keys, elements, ct.level)
        with self.monitor.time("rotate_hoisted"):
            return self._scheme.apply_galois_hoisted(self.ctx, ct, elements, gal_keys,
                                                     pre_keys=pre)

    def rotate_rows_hoisted_batch(self, cts: list, steps_list,
                                  gal_keys: GaloisKeys) -> list:
        """Hoisted rotations of C independent ciphertexts by the same steps
        through one kernel chain (bfv.apply_galois_hoisted_batch):
        outs[c][e] equals rotate_rows_hoisted(cts[c], steps_list)[e].
        Ciphertexts at mixed levels go one rotate_rows_hoisted each."""
        elements = self._hoist_elements(steps_list, gal_keys)
        if not cts:
            return []
        if any(ct.level != cts[0].level for ct in cts):
            return [self.rotate_rows_hoisted(ct, steps_list, gal_keys) for ct in cts]
        pre = self._hoisted_pre(gal_keys, elements, cts[0].level)
        with self.monitor.time("rotate_hoisted_batch"):
            return self._scheme.apply_galois_hoisted_batch(self.ctx, cts, elements, gal_keys,
                                                           pre_keys=pre)

    def sum_slots_elements(self) -> tuple:
        """Galois elements of the fast sum_slots: the default power-of-two
        set plus the 3 * 4^i hops that each radix-4 stage hoists.  Pass to
        galoiskey_gen(sk, elements=fhe.sum_slots_elements())."""
        m = 2 * self.params.n
        half = self.params.n // 2
        elems = list(default_galois_elements(self.params.n))
        step = 1
        while step < half:
            for j in (2, 3):
                if j * step < half:
                    elems.append(pow(3, j * step, m))
            step *= 4
        return tuple(dict.fromkeys(elems))

    def sum_slots(self, ct: Ciphertext, gal_keys: GaloisKeys) -> Ciphertext:
        """Every slot becomes the sum of all slots.  With keys for
        sum_slots_elements(), each stage hoists the rotations {s, 2s, 3s} of
        the running sum through one shared decomposition (radix 4);
        otherwise a stage is rotate_rows by s and an add (radix 2).  Then
        the two slot rows are added through rotate_columns."""
        m = 2 * self.params.n
        half = self.params.n // 2
        with self.monitor.time("sum_slots"):
            step = 1
            while step < half:
                group = [j * step for j in (1, 2, 3) if j * step < half]
                if len(group) > 1 and all(pow(3, s, m) in gal_keys.data for s in group):
                    ct = self._rotate_accumulate(ct, group, gal_keys)
                    step *= len(group) + 1
                else:
                    ct = self.add(ct, self.rotate_rows(ct, step, gal_keys))
                    step *= 2
            return self.add(ct, self.rotate_columns(ct, gal_keys))

    def _rotate_accumulate(self, ct: Ciphertext, steps_list,
                           gal_keys: GaloisKeys) -> Ciphertext:
        """ct + sum_s rotate_rows(ct, s) through one hoisted accumulating
        chain (bfv.apply_galois_hoisted_sum): the sum_slots stage."""
        elements = self._hoist_elements(steps_list, gal_keys)
        return self._scheme.apply_galois_hoisted_sum(
            self.ctx, ct, elements, gal_keys,
            pre_keys=self._hoisted_pre(gal_keys, elements, ct.level))

    # -- noise management --
    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """Drop the last q prime with rounding (BGV: with the mod-t
        correction, tracked in scale_t): level L -> L + 1."""
        return self._scheme.mod_switch_to_next(self.ctx, ct)

    def mod_switch_to_level(self, ct: Ciphertext, level: int) -> Ciphertext:
        return self._scheme.mod_switch_to_level(self.ctx, ct, level)

    def modulus_raise(self, ct: Ciphertext) -> Ciphertext:
        """Base-extend a leveled BFV ciphertext back to all k primes (adds an
        alpha * q_L term the caller absorbs as noise)."""
        if self.scheme_name != "bfv":
            raise NotImplementedError("modulus_raise is BFV-only")
        with self.monitor.time("modulus_raise"):
            return bfv.modulus_raise(self.ctx, ct)

    def bootstrap(self, ct: Ciphertext, sk: SecretKey, pk: PublicKey) -> Ciphertext:
        """Trusted refresh with the secret key: decrypt, then encrypt afresh
        at level 0 with the facade's generator."""
        with self.monitor.time("bootstrap"):
            return self._scheme.bootstrap(self.ctx, self.gen, ct, sk, pk)

    # -- the bootstrapping pipeline (scheme/bootstrap.py): extract_lsb ->
    # blind_rotate -> modulus_raise -> key_switch.  BFV only.
    def _bfv_only(self) -> None:
        if self.scheme_name != "bfv":
            raise NotImplementedError("bootstrap pipeline is BFV-only")

    def _bootstrap_ks(self, sk: SecretKey) -> torch.Tensor:
        """The pipeline's final key-switching keys (s -> s), made once per
        secret key and evicted when the caller drops the key."""
        ck = id(sk)
        ks = self._bootstrap_ks_cache.get(ck)
        if ks is None:
            ks = _bs.keyswitch_keygen(self.ctx, self.gen, sk, sk)
            self._bootstrap_ks_cache[ck] = ks
            weakref.finalize(sk, dict.pop, self._bootstrap_ks_cache, ck, None)
        return ks

    def make_bootstrap_key(self, sk: SecretKey, level: int = 0) -> BootstrapKey:
        """RGSW bootstrap keys of the secret's bits at ``level`` (the level of
        the ciphertexts they will refresh)."""
        self._bfv_only()
        with self.monitor.time("make_bootstrap_key"):
            return _bs.make_bootstrap_key(self.ctx, self.gen, sk, level)

    def bootstrap_binary(self, ct: Ciphertext, sk: SecretKey,
                         bsk: BootstrapKey | None = None) -> Ciphertext:
        """Refresh a ciphertext whose constant coefficient is a bit, through
        the whole pipeline; returns a level-0 ciphertext of the same bit at
        fresh noise.  Without ``bsk`` one is made from sk for this call."""
        self._bfv_only()
        ks = self._bootstrap_ks(sk)
        with self.monitor.time("bootstrap_binary"):
            return _bs.bootstrap_binary(self.ctx, self.gen, ct, sk, bsk, ks_keys=ks)

    def bootstrap_lut(self, ct: Ciphertext, lut, sk: SecretKey,
                      bsk: BootstrapKey | None = None,
                      payload_bits: int | None = None) -> Ciphertext:
        """Programmable bootstrap: the output encrypts lut[m] at fresh noise
        for a constant-coefficient plaintext m < len(lut).  lut = [0, 1]
        is the binary refresh, [1, 0] an encrypted NOT."""
        self._bfv_only()
        ks = self._bootstrap_ks(sk)
        with self.monitor.time("bootstrap_lut"):
            return _bs.bootstrap_lut(self.ctx, self.gen, ct, lut, sk,
                                     payload_bits=payload_bits, bsk=bsk, ks_keys=ks)

    def bootstrap_binary_batch(self, cts: list, sk: SecretKey, bsk: BootstrapKey) -> list:
        """B binary bootstraps through one batched blind rotation; element i
        equals bootstrap_binary(cts[i], sk, bsk)."""
        self._bfv_only()
        ks = self._bootstrap_ks(sk)
        with self.monitor.time("bootstrap_binary_batch"):
            return _bs.bootstrap_binary_batch(self.ctx, cts, bsk, ks)

    def extract_lsb(self, ct: Ciphertext, index: int = 0) -> LWECiphertext:
        """RLWE -> LWE over Z_2n of the bit in coefficient ``index``."""
        self._bfv_only()
        with self.monitor.time("extract_lsb"):
            return _bs.extract_lsb(self.ctx, ct, index)

    def blind_rotate(self, lwe: LWECiphertext, bsk: BootstrapKey | None = None,
                     sk: SecretKey | None = None, test_poly: torch.Tensor | None = None,
                     level: int = 0) -> Ciphertext:
        """The accumulator blind rotation: pass a ``bsk`` (make_bootstrap_key)
        or ``sk`` to make one for this call."""
        self._bfv_only()
        with self.monitor.time("blind_rotate"):
            return _bs.blind_rotate(self.ctx, lwe, bsk, sk=sk,
                                    gen=None if sk is None else self.gen,
                                    test_poly=test_poly, level=level)

    def estimate_noise_budget(self, ct: Ciphertext, sk: SecretKey) -> float:
        """The remaining budget in bits, measured with the secret key (a host
        CRT of the phase) against what the ciphertext decrypts to."""
        return self._scheme.estimate_noise_budget(self.ctx, ct, sk)

    def exact_noise_budget(self, ct: Ciphertext, sk: SecretKey, pt: Plaintext) -> float:
        """The budget against a known plaintext: negative once the ciphertext
        is corrupted."""
        return self._scheme.exact_noise_budget(self.ctx, ct, sk, pt)

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
            with self.monitor.time("plain_ntt_operand"):
                op = bfv.plain_ntt_operand(self.ctx, pt, level)
            self._plain_ntt_cache[ck] = op
            weakref.finalize(pt, _evict, self._plain_ntt_cache, id(pt))
        return op


def _evict(cache: dict, obj_id: int) -> None:
    for key in [k for k in cache if k[0] == obj_id]:
        cache.pop(key, None)
