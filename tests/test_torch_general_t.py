"""The ciphertext multiply and the rotations at a non-Fermat plaintext
modulus, held bit for bit against the JAX package.

tests/test_general_t.py's BFV tests and BGV pipeline, at its configuration: n = 1024,
log_q = 90 (k = 3), t = 786433 = 3 * 2^18 + 1, lambda_ = 0.  At this t the
t-folded tables (t * n^-1 in the inverse normalisation of the q and Bsk
tensor products) differ from those of t = 65537, so the multiply's kernel
modules are held against the Pallas kernels in interpreter mode on the same
random residues: ntt_pallas.tensor_product and rns_pallas.bsk_branch_fused.

The slice: multiply_no_relin, relinearize, multiply, rotate_rows and the
decrypt of each result against fhe_tpu.scheme.bfv, jitted, on a
use_pallas=False context (pinned equal to the Pallas path by
tests/test_pallas.py).  And BGV's pipeline of tests/test_general_t.py:
multiply, mod_switch_to_next (scale_t != 1, the generic-t correction in
decrypt) and add_plain on the switched ciphertext (the inverse of scale_t
mod t), against fhe_tpu.scheme.bgv.  Every input is made from one numpy seed and fed to
both packages: the secret key, the relinearization and Galois keys and the
two ciphertexts come from the port's _from_noise entry points on numpy
draws, and cross to JAX as arrays.  Residues are compared with tolerance
0; the noise budget, which the JAX package carries in float32, to 1e-4
bits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.ops import rns_pallas as rpal
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import bgv as jbgv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import convert
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import ntt_cuda, rns_cuda
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import bgv as tbgv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder

T_ALT = 786433
N = 1024
KW = dict(poly_degree=N, log_q=90, lambda_=0, plain_modulus=T_ALT)
# row rotation by 1 and by 4 (so 5 = 1 + 4 needs both), and the column swap
ELEMENTS = (3, pow(3, 4, 2 * N), 2 * N - 1)
VALS = ([5, 10, 15, 20, 70000], [3, 6, 9, 12, 11])
PRODUCT = [15, 60, 135, 240, 70000 * 11 % T_ALT]
RNG = np.random.default_rng(786433)

J = dataclasses.make_dataclass("J", ["decrypt", "multiply_no_relin", "relinearize",
                                     "multiply", "rotate_rows"])(
    jax.jit(jbfv.decrypt), jax.jit(jbfv.multiply_no_relin), jax.jit(jbfv.relinearize),
    jax.jit(jbfv.multiply), jax.jit(jbfv.rotate_rows, static_argnums=2))


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _residues(moduli, shape):
    return np.stack([RNG.integers(0, p, shape, dtype=np.uint32) for p in moduli])


def _signed_to_rns(v, primes):
    """[..., n] small signed integers -> [k, ..., n] residues."""
    return np.stack([np.mod(v, p) for p in primes]).astype(np.uint32)


def _ternary(primes, h):
    v = np.zeros(N, dtype=np.int64)
    v[RNG.choice(N, h, replace=False)] = RNG.choice([-1, 1], h)
    return _signed_to_rns(v[None], primes)                       # [k, 1, n]


def _gaussian(primes, sigma, shape=(1,)):
    return _signed_to_rns(np.rint(RNG.normal(0.0, sigma, (*shape, N))).astype(np.int64),
                          primes)


def _uniform(primes, shape=(1,)):
    return _residues(primes, (*shape, N))


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


def _rotated(vals, steps, half=N // 2):
    row = list(vals) + [0] * (half - len(vals))
    return row[steps:] + row[:steps]


@pytest.fixture(scope="module")
def g():
    """The port's keys and two encryptions of VALS from numpy draws, the
    same arrays as JAX objects, and each package's context."""
    jp = jmake_params(JSecurity(**KW))
    jctx = jcontext.make_context(jp, use_pallas=False, use_mxu=False)
    tctx = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    assert tctx.params.t == jp.t == T_ALT and tctx.k == jp.k == 3
    # galois_fold_tables caches the arrays of its first call; made under a
    # jit trace they are tracers that leak into the next trace, so the cache
    # is filled here, outside any trace
    jcontext.galois_fold_tables.cache_clear()
    for e in ELEMENTS:
        jcontext.galois_fold_tables(N, e)
    qs, k = jp.q_primes, jp.k
    h, sig = jp.security.hamming_weight, jp.security.sigma
    tpk, tsk = tbfv.keygen_from_noise(tctx, _t(_ternary(qs, h)), _t(_uniform(qs)),
                                      _t(_gaussian(qs, sig)))
    trlk = tbfv.relinkey_gen_from_noise(
        tctx, tsk, _t(_uniform(qs, (k, 1)).transpose(1, 0, 2, 3)),
        _t(_gaussian(qs, sig, (k, 1)).transpose(1, 0, 2, 3)))
    tgk = tbfv.galoiskey_gen_from_noise(
        tctx, tsk, ELEMENTS,
        _t(_uniform(qs, (len(ELEMENTS), k, 1)).transpose(1, 2, 0, 3, 4)),
        _t(_gaussian(qs, sig, (len(ELEMENTS), k, 1)).transpose(1, 2, 0, 3, 4)))
    tenc = BatchEncoder(tctx.params, "cpu")
    tcts = [tbfv.encrypt_from_noise(tctx, tpk, tenc.encode(v), _t(_ternary(qs, h)),
                                    _t(_gaussian(qs, sig)), _t(_gaussian(qs, sig)))
            for v in VALS]
    jsk = jtypes.SecretKey(data=jnp.asarray(convert.to_numpy(tsk)))
    jrlk = jtypes.RelinKeys(data=jnp.asarray(convert.to_numpy(trlk)))
    jgk = jtypes.GaloisKeys(data={e: jnp.asarray(convert.to_numpy(a))
                                  for e, a in tgk.data.items()})
    jcts = [jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)),
                              noise_budget=ct.noise_budget) for ct in tcts]
    jm3 = J.multiply_no_relin(jctx, *jcts)
    tm3 = tbfv.multiply_no_relin(tctx, *tcts)
    return dataclasses.make_dataclass("G", [
        "jctx", "tctx", "jsk", "tsk", "jrlk", "trlk", "jgk", "tgk", "tenc", "jcts",
        "tcts", "m3"])(
        jctx, tctx, jsk, tsk, jrlk, trlk, jgk, tgk, tenc, jcts, tcts, (jm3, tm3))


def _decode(g, ct):
    """The port's decrypt equals the JAX decrypt; returns the decoded slots."""
    got = tbfv.decrypt(g.tctx, ct, g.tsk)
    jct = jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=ct.level,
                            noise_budget=ct.noise_budget)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  _np(J.decrypt(g.jctx, jct, g.jsk).data))
    return [int(x) for x in g.tenc.decode(got)]


# ---------------------------------------------------------------------------
# the t-folded kernel modules against the Pallas kernels in interpreter mode
# ---------------------------------------------------------------------------


def test_tensor_product_t_folded_matches_pallas():
    prm = jmake_params(JSecurity(**KW))
    qs = prm.q_primes
    pt = npal.build_mul_tables(N, qs, prm.bsk_primes, prm.t, prm.k,
                               len(prm.bsk_primes))[0]
    tb = tntt.build_mul_tables(tntt.build_tables(N, qs, "cpu"),
                               tntt.build_tables(N, prm.bsk_primes, "cpu"), prm.t)[0]
    x, y = _residues(qs, (2, N)), _residues(qs, (2, N))
    want = np.asarray(npal.tensor_product(jnp.asarray(x), jnp.asarray(y), pt,
                                          interpret=True))
    np.testing.assert_array_equal(
        convert.to_numpy(ntt_cuda.tensor_product(_t(x), _t(y), tb)), want)


def test_bsk_branch_t_folded_matches_pallas(g):
    prm, jctx, tctx = g.jctx.params, g.jctx, g.tctx
    kb = jctx.bsk_counts[0]
    tbsk_pl = npal.build_mul_tables(N, prm.q_primes, prm.bsk_primes, prm.t, prm.k, kb)[1]
    ab, tx_q = _residues(prm.q_primes, (4, N)), _residues(prm.q_primes, (3, N))
    want = np.asarray(rpal.bsk_branch_fused(
        jnp.asarray(ab), jnp.asarray(tx_q), jctx.smq, jctx.floor_c, tbsk_pl,
        interpret=True))
    got = rns_cuda.bsk_branch_fused(_t(ab), _t(tx_q), tctx.smq, tctx.floor_c,
                                    tctx.mul_tables[1])
    np.testing.assert_array_equal(convert.to_numpy(got), want)


# ---------------------------------------------------------------------------
# the slice against fhe_tpu.scheme.bfv
# ---------------------------------------------------------------------------


def test_inputs_decrypt_as_jax(g):
    for ct, vals in zip(g.tcts, VALS):
        assert _decode(g, ct)[:len(vals)] == vals


def test_multiply_no_relin_matches_jax(g):
    jm3, tm3 = g.m3
    assert tm3.num_components == 3
    assert_ct_equal(tm3, jm3)
    assert _decode(g, tm3)[:len(PRODUCT)] == PRODUCT


def test_relinearize_matches_jax(g):
    jm3, tm3 = g.m3
    got = tbfv.relinearize(g.tctx, tm3, g.trlk)
    assert_ct_equal(got, J.relinearize(g.jctx, jm3, g.jrlk))
    assert _decode(g, got)[:len(PRODUCT)] == PRODUCT


def test_multiply_matches_jax(g):
    got = tbfv.multiply(g.tctx, *g.tcts, g.trlk)
    assert_ct_equal(got, J.multiply(g.jctx, *g.jcts, g.jrlk))
    assert _decode(g, got)[:len(PRODUCT)] == PRODUCT


@pytest.mark.parametrize("steps", [1, 5])
def test_rotate_rows_matches_jax(g, steps):
    got = tbfv.rotate_rows(g.tctx, g.tcts[0], steps, g.tgk)
    assert_ct_equal(got, J.rotate_rows(g.jctx, g.jcts[0], steps, g.jgk))
    assert _decode(g, got)[:N // 2] == _rotated(VALS[0], steps)


# ---------------------------------------------------------------------------
# BGV's pipeline against fhe_tpu.scheme.bgv
# ---------------------------------------------------------------------------

JB = dataclasses.make_dataclass("JB", ["multiply", "mod_switch_to_next", "decrypt",
                                       "add_plain"])(
    jax.jit(jbgv.multiply), jax.jit(jbgv.mod_switch_to_next), jax.jit(jbgv.decrypt),
    jax.jit(jbgv.add_plain))


def _jct_bgv(ct):
    return jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=ct.level,
                             noise_budget=ct.noise_budget, scale_t=ct.scale_t)


@pytest.fixture(scope="module")
def gb(g):
    """BGV keys and two encryptions of VALS[:4] from numpy draws (the port's
    *_from_noise entry points), and the product switched down a level, in
    both packages."""
    tctx, qs, k = g.tctx, g.tctx.params.q_primes, g.tctx.k
    h, sig = tctx.params.security.hamming_weight, tctx.params.security.sigma
    tpk, tsk = tbgv.keygen_from_noise(tctx, _t(_ternary(qs, h)), _t(_uniform(qs)),
                                      _t(_gaussian(qs, sig)))
    trlk = tbgv.relinkey_gen_from_noise(
        tctx, tsk, _t(_uniform(qs, (k, 1)).transpose(1, 0, 2, 3)),
        _t(_gaussian(qs, sig, (k, 1)).transpose(1, 0, 2, 3)))
    tcts = [tbgv.encrypt_from_noise(tctx, tpk, g.tenc.encode(v[:4]), _t(_ternary(qs, h)),
                                    _t(_gaussian(qs, sig)), _t(_gaussian(qs, sig)))
            for v in VALS]
    jsk = jtypes.SecretKey(data=jnp.asarray(convert.to_numpy(tsk)))
    jrlk = jtypes.RelinKeys(data=jnp.asarray(convert.to_numpy(trlk)))
    prod = tbgv.multiply(tctx, *tcts, trlk)
    jprod = JB.multiply(g.jctx, *[_jct_bgv(c) for c in tcts], jrlk)
    return dataclasses.make_dataclass("GB", ["tsk", "jsk", "prod", "jprod"])(
        tsk, jsk, prod, jprod)


def _assert_bgv_equal(got, want):
    assert_ct_equal(got, want)
    assert got.scale_t == int(want.scale_t)


def _decode_bgv(g, gb, ct):
    got = tbgv.decrypt(g.tctx, ct, gb.tsk)
    np.testing.assert_array_equal(
        convert.to_numpy(got), _np(JB.decrypt(g.jctx, _jct_bgv(ct), gb.jsk).data))
    return [int(x) for x in g.tenc.decode(got)[:4]]


def test_bgv_multiply_matches_jax(g, gb):
    _assert_bgv_equal(gb.prod, gb.jprod)
    assert _decode_bgv(g, gb, gb.prod) == PRODUCT[:4]


def test_bgv_mod_switch_and_add_plain_match_jax(g, gb):
    """The switched product's scale_t is q_last mod t != 1; add_plain divides
    its operand by it (the inverse mod t = 786433, not Fermat's 65537)."""
    switched = tbgv.mod_switch_to_next(g.tctx, gb.prod)
    jswitched = JB.mod_switch_to_next(g.jctx, gb.jprod)
    _assert_bgv_equal(switched, jswitched)
    assert switched.scale_t == g.tctx.params.q_primes[-1] % T_ALT != 1
    assert _decode_bgv(g, gb, switched) == PRODUCT[:4]
    pt = g.tenc.encode([1, 2, 3, 4])
    got = tbgv.add_plain(g.tctx, switched, pt)
    _assert_bgv_equal(got, JB.add_plain(g.jctx, jswitched, jtypes.Plaintext(
        data=jnp.asarray(convert.to_numpy(pt)))))
    assert _decode_bgv(g, gb, got) == [16, 62, 138, 244]
