"""The multiply at n = 262144, held bit for bit against the JAX package.

The ring after n = 131072, which both packages take (JAX's params accept any
power of two n >= 8), and the first where the port's cluster kernels run in
the column form (ordinary launches that meet in global memory:
tests/test_torch_cluster.py, tests/test_torch_column.py): n = 262144,
log_q = 90 (k = 3, kb = 5, kd = 3), plain_modulus = 5767169 (786433 is not
1 mod 2n here; 5767169 = 22 * 2^18 + 1 is prime), lambda_ = 0, h = 16,
seed 11.  JAX's facade makes the keys and the two
ciphertexts of [4, 5, 6] and [7, 8, 9]; convert.py carries them to the port
on the CPU, where the kernel wrappers run their plain twins (those of B4,
B5, B6, B7 and B8).  The port's multiply equals
fhe_tpu.scheme.bfv.multiply (jitted), residues with tolerance 0 and the
noise budget, which the JAX package carries in float32, to 1e-4 bits; its
decrypt equals JAX's, and both decode [28, 40, 54].  chip_smoke.py's
n262144 phase holds the card against the port's CPU path at this shape and
at log_q = 900 (k = 30), and runs the multiply's kernels at log_q = 1560
(k = 52, JAX's largest set here); its n_large phase the rings up to
n = 2097152.

One session-scoped state: JAX's context, keys, ciphertexts and product take
most of this file's time on the CPU, the port's multiply a few seconds."""

import types

import jax
import numpy as np
import pytest

from fhe_tpu import FHE as JFHE
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv

from fhe_tpu_torch import convert
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder

KW = dict(poly_degree=262144, log_q=90, lambda_=0, hamming_weight=16, plain_modulus=5767169)
VALS = ([4, 5, 6], [7, 8, 9])
PRODUCT = [28, 40, 54]


def _np(x):
    return np.asarray(x).astype(np.uint32)


@pytest.fixture(scope="session")
def state():
    """JAX's facade at seed 11 (its keys, ciphertexts and jitted product)
    and the same keys and ciphertexts in the port, on the CPU, with the
    port's product of them."""
    jfhe = JFHE(jmake_params(JSecurity(**KW)), seed=11)
    pk, sk = jfhe.keygen()
    rlk = jfhe.relinkey_gen(sk)
    cts = [jfhe.encrypt(jfhe.encode(v), pk) for v in VALS]
    jprod = jax.jit(jbfv.multiply)(jfhe.ctx, *cts, rlk)
    params = make_scheme_params(SecurityParams(**KW))
    tcts = [convert.ciphertext_from_numpy(_np(c.data), noise_budget=float(c.noise_budget),
                                          device="cpu") for c in cts]
    _, tsk = convert.keys_from_numpy(_np(pk.data), _np(sk.data), device="cpu")
    trlk = convert.relin_keys_from_numpy(_np(rlk.data), device="cpu")
    ctx = make_context(params, device="cpu")
    return types.SimpleNamespace(jfhe=jfhe, jsk=sk, jprod=jprod, params=params, ctx=ctx,
                                 sk=tsk, rlk=trlk, prod=tbfv.multiply(ctx, *tcts, trlk))


def test_both_packages_pick_the_same_primes(state):
    """k = 3 q primes, kb = 5 Bsk primes and kd = 3 digits at n = 262144,
    the same q and Bsk primes in both packages."""
    assert (state.params.n, state.params.k, state.ctx.mul_tables[1].k) == (262144, 3, 5)
    assert state.params.q_primes == tuple(int(q) for q in state.jfhe.params.q_primes)
    assert state.params.bsk_primes == tuple(int(p) for p in state.jfhe.params.bsk_primes)
    assert tuple(state.ctx.mul_tables[1].primes) == state.params.bsk_primes
    assert tuple(state.rlk.data.shape) == (3, 3, 2, 262144)


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
