"""The multiply at n = 65536, held bit for bit against the JAX package.

The ring after the 128-bit security table's last row, which both packages
take (JAX's params accept any power of two n >= 8): n = 65536, log_q = 90
(k = 3, kb = 5, kd = 3), plain_modulus = 786433 (65537 is not 1 mod 2n
here, so batching needs another t), lambda_ = 0, h = 16, seed 11.  JAX's
facade makes the keys and the two ciphertexts of [4, 5, 6] and [7, 8, 9];
convert.py carries them to the port on the CPU, where the kernel wrappers
run their plain twins (the twins of B4, B5, B6, B7 and B8, whose kernels
take this ring on the compact split: tests/test_torch_cluster.py).  The
port's multiply equals fhe_tpu.scheme.bfv.multiply (jitted), residues with
tolerance 0 and the noise budget, which the JAX package carries in
float32, to 1e-4 bits; its decrypt equals JAX's, and both decode
[28, 40, 54].  From JAX's Galois keys for the rotations by 1 and 2
(g = 3, 9), the port's hoisted rotations (apply_galois_hoisted, two
elements: the twin of B17's Galois lane) and their sum
(apply_galois_hoisted_sum: B17's Inner lane and B15) equal JAX's
(fhe_tpu/scheme/bfv.py apply_galois_hoisted, apply_galois_hoisted_sum,
jitted).  chip_smoke.py's n65536 phase holds the card against the port's
CPU path at this shape, at log_q = 900 (k = 30) and at log_q = 1770
(k = 59).

One module-scoped state: JAX's context, keys, ciphertexts and product
take most of this file's time on the CPU, the port's multiply a few
seconds."""

import types

import jax
import numpy as np
import pytest

from fhe_tpu import FHE as JFHE
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import context as jcontext

from fhe_tpu_torch import convert
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder

KW = dict(poly_degree=65536, log_q=90, lambda_=0, hamming_weight=16, plain_modulus=786433)
VALS = ([4, 5, 6], [7, 8, 9])
PRODUCT = [28, 40, 54]
ELEMS = (3, 9)                  # the rotations by 1 and 2


def _np(x):
    return np.asarray(x).astype(np.uint32)


@pytest.fixture(scope="module")
def state():
    """JAX's facade at seed 11 (its keys, ciphertexts and jitted product)
    and the same keys and ciphertexts in the port, on the CPU, with the
    port's product of them."""
    jfhe = JFHE(jmake_params(JSecurity(**KW)), seed=11)
    pk, sk = jfhe.keygen()
    rlk = jfhe.relinkey_gen(sk)
    cts = [jfhe.encrypt(jfhe.encode(v), pk) for v in VALS]
    jprod = jax.jit(jbfv.multiply)(jfhe.ctx, *cts, rlk)
    # galois_fold_tables caches the arrays of its first call; made under a
    # jit trace they would be tracers that leak into the next trace
    for g in ELEMS:
        jcontext.galois_fold_tables(KW["poly_degree"], g)
    # jitted: the facade's eager galoiskey_gen takes three times as long here
    jgk = jax.jit(jbfv.galoiskey_gen, static_argnums=3)(jfhe.ctx, jax.random.PRNGKey(12), sk,
                                                         ELEMS)
    jhoist = jax.jit(jbfv.apply_galois_hoisted, static_argnums=2)(jfhe.ctx, cts[0], ELEMS, jgk)
    jsum = jax.jit(jbfv.apply_galois_hoisted_sum, static_argnums=2)(jfhe.ctx, cts[1], ELEMS,
                                                                   jgk)
    params = make_scheme_params(SecurityParams(**KW))
    tcts = [convert.ciphertext_from_numpy(_np(c.data), noise_budget=float(c.noise_budget),
                                          device="cpu") for c in cts]
    _, tsk = convert.keys_from_numpy(_np(pk.data), _np(sk.data), device="cpu")
    trlk = convert.relin_keys_from_numpy(_np(rlk.data), device="cpu")
    tgk = convert.galois_keys_from_numpy({g: _np(v) for g, v in jgk.data.items()},
                                         device="cpu")
    ctx = make_context(params, device="cpu")
    return types.SimpleNamespace(jfhe=jfhe, jsk=sk, jprod=jprod, params=params, ctx=ctx,
                                 sk=tsk, rlk=trlk, prod=tbfv.multiply(ctx, *tcts, trlk),
                                 jhoist=jhoist, jsum=jsum,
                                 hoist=tbfv.apply_galois_hoisted(ctx, tcts[0], ELEMS, tgk),
                                 sum=tbfv.apply_galois_hoisted_sum(ctx, tcts[1], ELEMS, tgk))


def test_both_packages_pick_the_same_primes(state):
    """k = 3 q primes, kb = 5 Bsk primes and kd = 3 digits at n = 65536, the
    same q and Bsk primes in both packages."""
    assert (state.params.n, state.params.k, state.ctx.mul_tables[1].k) == (65536, 3, 5)
    assert state.params.q_primes == tuple(int(q) for q in state.jfhe.params.q_primes)
    assert state.params.bsk_primes == tuple(int(p) for p in state.jfhe.params.bsk_primes)
    assert tuple(state.ctx.mul_tables[1].primes) == state.params.bsk_primes
    assert tuple(state.rlk.data.shape) == (3, 3, 2, 65536)


def test_multiply_matches_jax(state):
    """The port's multiply (the twins of B4-B7 on CPU tensors) equals
    fhe_tpu's, residues and noise budget."""
    got = state.prod
    np.testing.assert_array_equal(convert.to_numpy(got), _np(state.jprod.data))
    assert got.level == 0 and not got.is_ntt_form
    assert abs(got.noise_budget - float(state.jprod.noise_budget)) < 1e-4


def test_decrypt_matches_jax_and_decodes_the_product(state):
    """The port's decrypt (B8's twin) of its product equals JAX's decrypt of
    JAX's, and both decode [28, 40, 54]."""
    got = tbfv.decrypt(state.ctx, state.prod, state.sk)
    want = state.jfhe.decrypt(state.jprod, state.jsk)
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert [int(v) for v in BatchEncoder(state.params, "cpu").decode(got)[:3]] == PRODUCT
    assert [int(v) for v in state.jfhe.decode(want)[:3]] == PRODUCT


def test_hoisted_rotations_and_their_sum_match_jax(state):
    """From JAX's Galois keys for g = 3 and 9: the port's
    apply_galois_hoisted of two elements (B17's Galois lane's twin) and
    apply_galois_hoisted_sum (B17's Inner lane and B15) equal fhe_tpu's,
    residues and noise budget; the rotations decode to the row rotated by
    1 and 2, and the sum to v[j] + v[j+1] + v[j+2]."""
    assert len(state.hoist) == len(state.jhoist) == 2
    for got, want in zip(state.hoist + [state.sum], list(state.jhoist) + [state.jsum]):
        np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
        assert got.level == 0 and not got.is_ntt_form
        assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4
    enc = BatchEncoder(state.params, "cpu")
    dec = lambda ct: [int(v) for v in enc.decode(tbfv.decrypt(state.ctx, ct, state.sk))[:3]]
    assert dec(state.hoist[0]) == [5, 6, 0] and dec(state.hoist[1]) == [6, 0, 0]
    assert dec(state.sum) == [7 + 8 + 9, 8 + 9, 9]
