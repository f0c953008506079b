"""The bootstrapping pipeline at level 1 (a leveled input: the rotation over
the level's primes, modulus_raise and the q_drop multiply back to level 0)
held bit for bit against fhe_tpu.scheme.bootstrap, and the FHE facade's
bootstrap methods on the CPU.  Same configuration and tolerances as
test_torch_bootstrap.py, whose state constructor this file shares."""

import gc

import jax.random as jrandom
import numpy as np
import pytest
import torch

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.scheme import bootstrap as tbs
from fhe_tpu_torch.scheme.types import BootstrapKey, LWECiphertext

from test_torch_bootstrap import (_boot, _boot_lut, _np, assert_ct_equal, build_state,
                                  decode0, encrypt_coeff, want_budget)

KW = dict(poly_degree=256, log_q=120, lambda_=0, hamming_weight=16)


@pytest.fixture(scope="module")
def s():
    return build_state(5, (1,))


def test_bootstrap_key_level1_matches_jax(s):
    np.testing.assert_array_equal(convert.to_numpy(s.tbsk[1].pos), _np(s.jbsk[1].pos))
    np.testing.assert_array_equal(convert.to_numpy(s.tbsk[1].neg), _np(s.jbsk[1].neg))
    assert s.tbsk[1].level == 1 and s.tbsk[1].pos.shape == (256, 6, 3, 2, 256)


def test_bootstrap_binary_level1_matches_jax(s):
    """A level-1 input refreshes to level 0 and decodes its bit."""
    jct, tct = encrypt_coeff(s, 1, jrandom.fold_in(s.kb, 30), level=1)
    want = _boot(s.jctx, jrandom.fold_in(s.kb, 31), jct, s.jsk, s.jbsk[1], s.jks)
    got = tbs.bootstrap_binary(s.tctx, None, tct, s.tsk, s.tbsk[1], s.tks)
    assert_ct_equal(got, want, want_budget(s.jp, 1))
    assert got.level == 0 and decode0(s, got) == 1


def test_bootstrap_lut_level1_matches_jax(s):
    jct, tct = encrypt_coeff(s, 2, jrandom.fold_in(s.kb, 32), level=1)
    lut = (0, 1, 4, 4)
    want = _boot_lut(s.jctx, jrandom.fold_in(s.kb, 33), jct, lut, s.jsk, None, s.jbsk[1],
                     s.jks)
    got = tbs.bootstrap_lut(s.tctx, None, tct, list(lut), s.tsk, bsk=s.tbsk[1], ks_keys=s.tks)
    assert_ct_equal(got, want, want_budget(s.jp, 1))
    assert decode0(s, got) == 4


@pytest.fixture(scope="module")
def fhe():
    f = FHE(seed=7, device="cpu", **KW)
    pk, sk = f.keygen()
    return f, pk, sk


def test_facade_bootstrap(fhe):
    """make_bootstrap_key, bootstrap_binary, bootstrap_lut, extract_lsb and
    blind_rotate through FHE(device="cpu"); the monitor counts each call."""
    f, pk, sk = fhe
    bsk = f.make_bootstrap_key(sk)
    assert isinstance(bsk, BootstrapKey) and bsk.level == 0
    ct = f.encrypt(f.encode_coeff([1]), pk)
    out = f.bootstrap_binary(ct, sk, bsk)
    assert out.level == 0 and int(f.decode_coeff(f.decrypt(out, sk))[0]) == 1
    assert out.noise_budget > 40
    nots = f.bootstrap_lut(ct, [1, 0], sk, bsk)
    assert int(f.decode_coeff(f.decrypt(nots, sk))[0]) == 0
    lwe = f.extract_lsb(ct)
    assert isinstance(lwe, LWECiphertext) and lwe.a.shape == (256,)
    acc = f.blind_rotate(lwe, bsk)
    assert acc.num_components == 2 and acc.level == 0
    stats = f.monitor.get_stats()
    for op in ("make_bootstrap_key", "bootstrap_binary", "bootstrap_lut", "extract_lsb",
               "blind_rotate", "encrypt", "decrypt", "keygen"):
        assert stats.counts[op] >= 1, op
        assert stats.mean_ms(op) > 0.0
    assert len(f._bootstrap_ks_cache) == 1      # one set of switching keys per sk


def test_facade_bootstrap_batch_and_cache_eviction():
    """bootstrap_binary_batch decodes every bit; the cached key-switching
    keys go when the secret key is dropped."""
    f = FHE(seed=9, device="cpu", **KW)
    pk, sk = f.keygen()
    bsk = f.make_bootstrap_key(sk)
    cts = [f.encrypt(f.encode_coeff([i % 2]), pk) for i in range(2)]
    outs = f.bootstrap_binary_batch(cts, sk, bsk)
    assert [int(f.decode_coeff(f.decrypt(o, sk))[0]) for o in outs] == [0, 1]
    assert len(f._bootstrap_ks_cache) == 1
    del sk, bsk, outs
    gc.collect()
    assert not f._bootstrap_ks_cache


def test_facade_bootstrap_bgv_raises():
    f = FHE(seed=1, scheme="bgv", device="cpu", **KW)
    pk, sk = f.keygen()
    ct = f.encrypt(f.encode([1]), pk)
    for call in (lambda: f.make_bootstrap_key(sk), lambda: f.bootstrap_binary(ct, sk),
                 lambda: f.bootstrap_lut(ct, [0, 1], sk), lambda: f.extract_lsb(ct),
                 lambda: f.bootstrap_binary_batch([ct], sk, None),
                 lambda: f.blind_rotate(LWECiphertext(a=torch.zeros(256, dtype=torch.int32),
                                                      b=torch.tensor(0)), sk=sk)):
        with pytest.raises(NotImplementedError, match="BFV-only"):
            call()
