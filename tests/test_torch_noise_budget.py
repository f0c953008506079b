"""The noise-budget diagnostics of both schemes, held against the JAX package.

estimate_noise_budget and exact_noise_budget measure the noise of the
phase with the secret key through an exact host CRT (the one big-integer
step); the port's and fhe_tpu's, bfv and bgv, must give the same floats
(to 1e-9) on shared ciphertexts: fresh ones, products, mod-switched ones
(BGV: scale_t != 1), 3-component ones and corrupted ones, on which BFV's
exact budget is negative in both packages.  Also the host CRT helpers
to_rns_host / from_rns_host and the BGV noise model against fhe_tpu's, and
the facade methods.  n = 256, log_q = 120 (k = 4), h = 32; keys and
ciphertexts come from the port's *_from_noise entry points on numpy draws
and cross to the JAX package as arrays."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fhe_tpu.ops import rns as jrns
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import bgv as jbgv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import noise as jnoise
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import bgv as tbgv
from fhe_tpu_torch.scheme import noise as tnoise
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder

KW = dict(poly_degree=256, log_q=120, hamming_weight=32)
N = 256
VALS = ([5, 10, 15, 20], [3, 6, 9, 12])
RNG = np.random.default_rng(1376)
SCHEMES = {"bfv": (tbfv, jbfv), "bgv": (tbgv, jbgv)}


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _rns(v, primes):
    """[..., n] signed integers -> [k, ..., n] residues."""
    return _t(np.stack([np.mod(v, p) for p in primes]))


def _ternary(primes, h):
    v = np.zeros((1, N), dtype=np.int64)
    v[0, RNG.choice(N, h, replace=False)] = RNG.choice([-1, 1], h)
    return _rns(v, primes)


def _gaussian(primes, shape=(1,)):
    return _rns(np.rint(RNG.normal(0.0, 3.2, (*shape, N))).astype(np.int64), primes)


def _uniform(primes, shape=(1,)):
    return _t(np.stack([RNG.integers(0, p, (*shape, N)) for p in primes]))


@pytest.fixture(scope="module", params=list(SCHEMES))
def st(request):
    """One scheme's keys, ciphertexts (fresh, product, switched, 3
    components, corrupted) and plaintexts, in the port and as JAX values."""
    name = request.param
    tmod, jmod = SCHEMES[name]
    jctx = jcontext.make_context(jmake_params(JSecurity(**KW)), use_pallas=False,
                                 use_mxu=False)
    tctx = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    qs, k, h = tctx.params.q_primes, tctx.k, tctx.params.security.hamming_weight
    pk, sk = tmod.keygen_from_noise(tctx, _ternary(qs, h), _uniform(qs), _gaussian(qs))
    rlk = tmod.relinkey_gen_from_noise(tctx, sk, _uniform(qs, (k, 1)).transpose(0, 1),
                                       _gaussian(qs, (k, 1)).transpose(0, 1))
    enc = BatchEncoder(tctx.params, "cpu")
    pts = [enc.encode(v) for v in VALS]
    a, b = (tmod.encrypt_from_noise(tctx, pk, pt, _ternary(qs, h), _gaussian(qs),
                                    _gaussian(qs)) for pt in pts)
    prod = tmod.multiply(tctx, a, b, rlk)
    m3 = tmod.multiply_no_relin(tctx, a, b)
    switched = tmod.mod_switch_to_next(tctx, prod)
    # c0 plus a third of q in every coefficient: far past the decryption bound
    third = _t(trns.to_rns_host([tctx.params.q // 3], qs)).to(torch.int64)   # [k, 1]
    bad = a.data.clone()
    bad[:, 0] = ((bad[:, 0].to(torch.int64) + third) % torch.tensor(qs).view(-1, 1)).to(
        torch.int32)
    corrupted = a.replace(data=bad)
    prod_pt = enc.encode([x * y for x, y in zip(*VALS)])
    cases = {"fresh": (a, pts[0]), "product": (prod, prod_pt), "three": (m3, prod_pt),
             "switched": (switched, prod_pt), "corrupted": (corrupted, pts[0])}
    return dataclasses.make_dataclass("S", ["name", "tmod", "jmod", "tctx", "jctx", "sk",
                                            "jsk", "cases"])(
        name, tmod, jmod, tctx, jctx, sk, jtypes.SecretKey(data=jnp.asarray(
            convert.to_numpy(sk))), cases)


def _jct(ct):
    return jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=ct.level,
                             is_ntt_form=ct.is_ntt_form, noise_budget=ct.noise_budget,
                             scale_t=ct.scale_t)


def _jpt(pt):
    return jtypes.Plaintext(data=jnp.asarray(convert.to_numpy(pt)))


# ---------------------------------------------------------------------------
# the host CRT and the noise model
# ---------------------------------------------------------------------------


def test_to_rns_host_matches_jax():
    primes = make_scheme_params(SecurityParams(**KW)).q_primes
    q = int(np.prod([float(p) for p in primes]))
    coeffs = [int(x) for x in RNG.integers(-(1 << 62), 1 << 62, 64)] + [0, -1, q, 3 * q + 7]
    got = trns.to_rns_host(coeffs, primes)
    assert got.dtype == np.uint32 and got.shape == (len(primes), len(coeffs))
    np.testing.assert_array_equal(got, jrns.to_rns_host(coeffs, primes))


def test_from_rns_host_matches_jax():
    primes = make_scheme_params(SecurityParams(**KW)).q_primes
    res = np.stack([RNG.integers(0, p, 64, dtype=np.uint32) for p in primes])
    want = jrns.from_rns_host(res, primes)
    assert trns.from_rns_host(res, primes) == want
    assert trns.from_rns_host(_t(res), primes) == want          # a tensor too
    np.testing.assert_array_equal(trns.to_rns_host(want, primes), res)


def test_bgv_noise_model_matches_jax():
    prm = make_scheme_params(SecurityParams(**KW))
    jprm = jmake_params(JSecurity(**KW))
    for level in range(prm.k - 1):
        for lv in (-3.0, 10.5, 61.25):
            assert abs(tnoise.bgv_budget(prm, level, lv)
                       - jnoise.bgv_budget(jprm, level, lv)) < 1e-9
            assert abs(tnoise.bgv_variance(prm, level, lv)
                       - jnoise.bgv_variance(jprm, level, lv)) < 1e-9
            assert abs(tnoise.bgv_mod_switch(prm, level, lv)
                       - jnoise.bgv_mod_switch(jprm, level, lv)) < 1e-9
            for lv2 in (4.0, 33.0):
                assert abs(tnoise.bgv_multiply(prm, lv, lv2)
                           - jnoise.bgv_multiply(jprm, lv, lv2)) < 1e-9


# ---------------------------------------------------------------------------
# the diagnostics, both schemes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fresh", "product", "three", "switched", "corrupted"])
def test_budgets_match_jax(st, case):
    ct, pt = st.cases[case]
    est = st.tmod.estimate_noise_budget(st.tctx, ct, st.sk)
    exact = st.tmod.exact_noise_budget(st.tctx, ct, st.sk, pt)
    assert abs(est - st.jmod.estimate_noise_budget(st.jctx, _jct(ct), st.jsk)) < 1e-9
    assert abs(exact - st.jmod.exact_noise_budget(st.jctx, _jct(ct), st.jsk,
                                                  _jpt(pt))) < 1e-9
    if case == "corrupted":
        if st.name == "bfv":
            assert exact < -10 < 0 <= est
        else:   # log2(q/2) - log2(|noise|) of a noise near q/3: about 0.6 bit
            assert 0 <= exact < 1
    else:
        assert est == pytest.approx(exact) and exact > 10
        # the tracked budget is a lower estimate of the measured one
        assert ct.noise_budget < exact + 10


def test_budgets_fall_with_depth(st):
    c = st.cases
    budgets = [st.tmod.estimate_noise_budget(st.tctx, c[x][0], st.sk)
               for x in ("fresh", "product")]
    assert budgets[0] > budgets[1] > 10


def test_facade_budgets_on_cpu():
    for scheme in SCHEMES:
        fhe = FHE(seed=2, scheme=scheme, device="cpu", **KW)
        pk, sk = fhe.keygen()
        pt = fhe.encode([1, 2, 3])
        ct = fhe.encrypt(pt, pk)
        est = fhe.estimate_noise_budget(ct, sk)
        assert est == fhe.exact_noise_budget(ct, sk, pt) > 40
        # against another plaintext: BFV's residual is a multiple of Δ (past
        # the bound); BGV's is below t (its phase holds m in the low bits)
        wrong = fhe.exact_noise_budget(ct, sk, fhe.encode([2, 2, 3]))
        assert wrong < 0 if scheme == "bfv" else 40 < wrong < est
