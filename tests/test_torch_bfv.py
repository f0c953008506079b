"""The linear-ops slice end to end, held bit for bit against fhe_tpu.scheme.bfv
on a use_pallas=False context (that context is pinned equal to the Pallas
path by tests/test_pallas.py::test_scheme_pallas_dispatch_interpreted).

n = 1024, k = 3, h = 16, lambda_ = 0.  The JAX draws are re-derived with the
same key splits as bfv.keygen / bfv.encrypt and fed to the port's
explicit-noise twins; keys and ciphertexts cross through convert.py.
Residues are compared with tolerance 0; the float noise budget, which the
JAX package carries in float32, to 1e-4 bits.  Also checks the port's own
samplers' distributions and the facade on the CPU."""

import dataclasses
import types

import numpy as np
import pytest
import jax
import jax.random as jrandom
import torch

from fhe_tpu.ops import sampling as jsampling
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme.context import make_context as jmake_context
from fhe_tpu.scheme.encoder import BatchEncoder as JEncoder

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.ops import sampling as tsampling
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder, encode_coeff

# the reference functions, jitted: eager dispatch on the CPU costs minutes
J = types.SimpleNamespace(**{f: jax.jit(getattr(jbfv, f)) for f in (
    "keygen", "encrypt", "decrypt", "add", "sub", "add_plain", "sub_plain",
    "to_ntt", "to_coeff", "plain_ntt_operand", "multiply_plain")})
KW = dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0)
VALS = [[i + 1, 2 * i + 1, 3, 4] for i in range(8)]


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _draws(x):
    return convert._tensor(np.asarray(x), 3, "cpu")


_ternary = jax.jit(jsampling.ternary_rns, static_argnums=(2, 3, 4))
_uniform = jax.jit(jsampling.uniform_rns, static_argnums=(3, 4))
_gaussian = jax.jit(jsampling.gaussian_rns, static_argnums=(2, 3, 4))


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


@pytest.fixture(scope="module")
def s():
    """JAX reference state and the port's state built from the same draws."""
    jp = jmake_params(JSecurity(**KW))
    jctx = jmake_context(jp, use_pallas=False, use_mxu=False)
    tctx = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    tb = jctx.ntt_q
    n, h, sig = jp.n, jp.security.hamming_weight, jp.security.sigma
    key = jrandom.PRNGKey(11)
    k_key, k_e1, k_e2 = jrandom.split(key, 3)

    jpk, jsk = J.keygen(jctx, k_key)
    k_s, k_a, k_e = jrandom.split(k_key, 3)
    tpk, tsk = tbfv.keygen_from_noise(
        tctx, _draws(_ternary(k_s, tb.p, 1, n, h)),
        _draws(_uniform(k_a, tb.p, tb.mu, 1, n)),
        _draws(_gaussian(k_e, tb.p, sig, 1, n)))

    jenc, tenc = JEncoder(jp), BatchEncoder(tctx.params, "cpu")
    jpts = [jenc.encode([5, 10, 15, 20]), jenc.encode([3, 6, 9, 12])]
    tpts = [tenc.encode([5, 10, 15, 20]), tenc.encode([3, 6, 9, 12])]

    def enc_both(k, i):
        ku, k1, k2 = jrandom.split(k, 3)
        want = J.encrypt(jctx, k, jpk, jpts[i])
        got = tbfv.encrypt_from_noise(
            tctx, tpk, tpts[i],
            _draws(_ternary(ku, tb.p, 1, n, h)),
            _draws(_gaussian(k1, tb.p, sig, 1, n)),
            _draws(_gaussian(k2, tb.p, sig, 1, n)))
        return want, got

    return dataclasses.make_dataclass("S", [
        "jctx", "tctx", "jpk", "jsk", "tpk", "tsk", "jenc", "tenc", "jpts",
        "tpts", "cts"])(jctx, tctx, jpk, jsk, tpk, tsk, jenc, tenc, jpts,
                        tpts, [enc_both(k_e1, 0), enc_both(k_e2, 1)])


def test_keygen_matches_jax(s):
    np.testing.assert_array_equal(convert.to_numpy(s.tpk), _np(s.jpk.data))
    np.testing.assert_array_equal(convert.to_numpy(s.tsk), _np(s.jsk.data))


def test_encode_matches_jax(s):
    for jpt, tpt in zip(s.jpts, s.tpts):
        np.testing.assert_array_equal(convert.to_numpy(tpt), _np(jpt.data))
        np.testing.assert_array_equal(s.tenc.decode(tpt), s.jenc.decode(jpt))


def test_encrypt_matches_jax(s):
    for want, got in s.cts:
        assert_ct_equal(got, want)


def test_add_sub_match_jax(s):
    (ja, ta), (jb, tb) = s.cts
    assert_ct_equal(tbfv.add(s.tctx, ta, tb), J.add(s.jctx, ja, jb))
    assert_ct_equal(tbfv.sub(s.tctx, ta, tb), J.sub(s.jctx, ja, jb))


@pytest.mark.parametrize("ntt_form", [False, True])
def test_add_plain_sub_plain_match_jax(s, ntt_form):
    ja, ta = s.cts[0]
    if ntt_form:
        ja, ta = J.to_ntt(s.jctx, ja), tbfv.to_ntt(s.tctx, ta)
    assert_ct_equal(tbfv.add_plain(s.tctx, ta, s.tpts[1]),
                    J.add_plain(s.jctx, ja, s.jpts[1]))
    assert_ct_equal(tbfv.sub_plain(s.tctx, ta, s.tpts[1]),
                    J.sub_plain(s.jctx, ja, s.jpts[1]))


def test_to_ntt_to_coeff_match_jax(s):
    ja, ta = s.cts[0]
    jn, tn = J.to_ntt(s.jctx, ja), tbfv.to_ntt(s.tctx, ta)
    assert_ct_equal(tn, jn)
    assert_ct_equal(tbfv.to_coeff(s.tctx, tn), J.to_coeff(s.jctx, jn))


def test_multiply_plain_matches_jax(s):
    """Coefficient-domain input, no cached operand: one round trip."""
    ja, ta = s.cts[1]
    assert_ct_equal(tbfv.multiply_plain(s.tctx, ta, s.tpts[0]),
                    J.multiply_plain(s.jctx, ja, s.jpts[0]))


def test_resident_mac_matches_jax(s):
    """bench.py g_residency: to_ntt once, 8 multiply_plain with cached
    operands, add-accumulate, to_coeff, decrypt -> slot 0 == 180."""
    ja, ta = s.cts[0]
    jpts = [s.jenc.encode(v) for v in VALS]
    tpts = [s.tenc.encode(v) for v in VALS]
    jct, tct = J.to_ntt(s.jctx, ja), tbfv.to_ntt(s.tctx, ta)
    jacc = tacc = None
    for jpt, tpt in zip(jpts, tpts):
        jop = J.plain_ntt_operand(s.jctx, jpt)
        top = tbfv.plain_ntt_operand(s.tctx, tpt)
        np.testing.assert_array_equal(convert.to_numpy(top), _np(jop))
        jterm = J.multiply_plain(s.jctx, jct, jpt, jop)
        tterm = tbfv.multiply_plain(s.tctx, tct, tpt, pt_ntt=top)
        assert_ct_equal(tterm, jterm)
        jacc = jterm if jacc is None else J.add(s.jctx, jacc, jterm)
        tacc = tterm if tacc is None else tbfv.add(s.tctx, tacc, tterm)
    jacc, tacc = J.to_coeff(s.jctx, jacc), tbfv.to_coeff(s.tctx, tacc)
    assert_ct_equal(tacc, jacc)
    got = tbfv.decrypt(s.tctx, tacc, s.tsk)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  _np(J.decrypt(s.jctx, jacc, s.jsk).data))
    assert int(s.tenc.decode(got)[0]) == sum(5 * v[0] for v in VALS) == 180


def test_decrypt_matches_jax_and_decodes(s):
    (ja, ta), (jb, tb) = s.cts
    for jct, tct, want in ((ja, ta, [5, 10, 15, 20]),
                           (J.add(s.jctx, ja, jb), tbfv.add(s.tctx, ta, tb),
                            [8, 16, 24, 32]),
                           (J.to_ntt(s.jctx, ja), tbfv.to_ntt(s.tctx, ta),
                            [5, 10, 15, 20])):
        got = tbfv.decrypt(s.tctx, tct, s.tsk)
        np.testing.assert_array_equal(
            convert.to_numpy(got), _np(J.decrypt(s.jctx, jct, s.jsk).data))
        assert list(s.tenc.decode(got)[:4]) == want


def test_jax_ciphertext_decrypts_in_port(s):
    """State carried across by convert.py decrypts the same in the port."""
    jct = s.cts[1][0]
    ct = convert.ciphertext_from_numpy(_np(jct.data), jct.level,
                                       jct.is_ntt_form,
                                       float(jct.noise_budget), "cpu")
    pk, sk = convert.keys_from_numpy(_np(s.jpk.data), _np(s.jsk.data), "cpu")
    np.testing.assert_array_equal(convert.to_numpy(pk), _np(s.jpk.data))
    got = tbfv.decrypt(s.tctx, ct, sk)
    np.testing.assert_array_equal(
        convert.to_numpy(got), _np(J.decrypt(s.jctx, jct, s.jsk).data))
    pt = convert.plaintext_from_numpy(_np(s.jpts[0].data), "cpu")
    np.testing.assert_array_equal(convert.to_numpy(pt), _np(s.jpts[0].data))


def test_facade_slice_on_cpu():
    """The FHE facade with the port's own samplers: add, add_plain and the
    resident MAC decode to the expected slots."""
    fhe = FHE(seed=3, device="cpu", **KW)
    pk, sk = fhe.keygen()
    p1, p2 = fhe.encode([5, 10, 15, 20]), fhe.encode([3, 6, 9, 12])
    c1, c2 = fhe.encrypt(p1, pk), fhe.encrypt(p2, pk)
    dec = lambda ct: list(fhe.decode(fhe.decrypt(ct, sk))[:4])
    assert dec(fhe.add(c1, c2)) == [8, 16, 24, 32]
    assert dec(fhe.add_plain(c1, p2)) == [8, 16, 24, 32]
    assert dec(fhe.sub_plain(fhe.add_plain(c1, p2), p2)) == [5, 10, 15, 20]
    assert dec(fhe.sub(c1, c1)) == [0, 0, 0, 0]
    ct = fhe.to_ntt(c1)
    pts = [fhe.encode(v) for v in VALS]
    acc = None
    for pt in pts:
        term = fhe.multiply_plain(ct, pt, cache_operand=True)
        acc = term if acc is None else fhe.add(acc, term)
    assert len(fhe._plain_ntt_cache) == len(pts)
    assert dec(fhe.to_coeff(acc))[0] == 180
    assert acc.noise_budget > 0
    assert list(fhe.decode_coeff(fhe.encode_coeff([1, -1, 7]))[:3]) == [
        1, fhe.params.t - 1, 7]
    del pts, pt
    assert not fhe._plain_ntt_cache


def test_samplers_distribution():
    prm = make_scheme_params(SecurityParams(**KW))
    primes = torch.tensor(prm.q_primes, dtype=torch.int32)
    q = np.array(prm.q_primes, dtype=np.int64)[:, None, None]
    gen = torch.Generator().manual_seed(5)
    n, h, batch = prm.n, 16, 64

    def signed(x):
        v = x.numpy().astype(np.int64)
        v = np.where(v > q // 2, v - q, v)
        assert (v == v[:1]).all()          # same small value in every prime
        return v[0]

    tern = signed(tsampling.ternary_rns(gen, primes, batch, n, h))
    assert ((tern != 0).sum(axis=1) == h).all()
    assert set(np.unique(tern)) <= {-1, 0, 1}
    assert abs((tern == 1).sum() - (tern == -1).sum()) < 4 * np.sqrt(batch * h)
    assert len(np.unique(np.nonzero(tern)[1])) > n // 2   # positions spread

    g = signed(tsampling.gaussian_rns(gen, primes, 3.2, batch, n))
    assert abs(g.std() - 3.2) < 0.32 and abs(g.mean()) < 0.1
    assert np.abs(g).max() < 3.2 * 8

    uni = tsampling.uniform_rns(gen, primes, batch, n).numpy().astype(np.int64)
    assert ((uni >= 0) & (uni < q)).all()
    assert (np.abs(uni.mean(axis=(1, 2)) / q[:, 0, 0] - 0.5) < 0.01).all()


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is tested on it")
    with pytest.raises(RuntimeError, match="cuda"):
        FHE(device="cuda", **KW)
    prm = make_scheme_params(SecurityParams(**KW))
    one = np.zeros((prm.k, 1, prm.n), dtype=np.uint32)
    for default_device in (
            lambda: make_context(prm),
            lambda: BatchEncoder(prm),
            lambda: encode_coeff(prm, [1, 2, 3]),
            lambda: tntt.build_tables(prm.n, prm.q_primes),
            lambda: trns.make_decrypt(prm.q_primes, prm.t, prm.gamma),
            lambda: convert.keys_from_numpy(one, one),
            lambda: convert.ciphertext_from_numpy(one),
            lambda: convert.plaintext_from_numpy(one[0, 0])):
        with pytest.raises(RuntimeError, match="cuda"):
            default_device()
