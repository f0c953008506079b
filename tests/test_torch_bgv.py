"""BGV in the port, held bit for bit against fhe_tpu.scheme.bgv.

At tests/test_bgv_scheme.py's configuration, n = 256, log_q = 120 (k = 4),
h = 32.  The JAX references are jitted on a use_pallas=False context (its
composed paths are pinned equal to the Pallas ones by tests/test_pallas.py).
The keys and ciphertexts of both packages come from the same JAX draws:
each JAX entry point runs on its key, and its draws, re-derived with the
same key splits (bgv.keygen, bfv._keyswitch_keygen per digit,
bgv.galoiskey_gen per element, bgv.encrypt), go to the port's
*_from_noise twins.

Covered here: keygen, relinkey_gen, galoiskey_gen, encrypt, decrypt,
add / sub, multiply_no_relin in the coefficient and the NTT-resident
branch, relinearize and multiply at levels 0-2 (keys switched down
t-corrected), multiply_batch, the mod switches with scale_t; the tensor
product and the mod switch against oracle.BGVOracle; the pieces BGV adds
below the scheme (mul_scalar, bgv_mod_switch_drop_last, sm_mrq onto {t});
the scale mismatch errors; the facade with scheme="bgv" on the CPU.
tests/test_torch_bgv_ops.py holds the plain ops, the switched keys and the
rotations on this module's state.  Residues and
scale_t are compared with tolerance 0; the noise budget, which the JAX
package carries in float32, to 1e-4 bits."""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jrandom
import torch

from fhe_tpu import oracle
from fhe_tpu.ops import poly as jpoly
from fhe_tpu.ops import rns as jrns
from fhe_tpu.ops import sampling as jsampling
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bgv as jbgv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes
from fhe_tpu.scheme.encoder import BatchEncoder as JEncoder

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import poly as tpoly
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import bgv as tbgv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder
from fhe_tpu_torch.scheme.types import Ciphertext, Plaintext

KW = dict(poly_degree=256, log_q=120, hamming_weight=32)
N = 256
# row rotations by 1 and 2 (so 3 = 1 + 2 needs both; hoisted: both), and
# the column swap
ELEMENTS = (3, 9, 2 * N - 1)
HOIST = (3, 9)
VALS = ([5, 10, 15, 20], [3, 6, 9, 12], [7, 1, 2, 3])
PRODUCT = [15, 60, 135, 240]
RNG = np.random.default_rng(20261017)

_ternary = jax.jit(jsampling.ternary_rns, static_argnums=(2, 3, 4))
_uniform = jax.jit(jsampling.uniform_rns, static_argnums=(3, 4))
_gaussian = jax.jit(jsampling.gaussian_rns, static_argnums=(2, 3, 4))

_bgv = functools.partial
J = dataclasses.make_dataclass("J", [
    "keygen", "relinkey_gen", "galoiskey_gen", "encrypt", "decrypt", "add", "sub",
    "add_plain", "sub_plain", "multiply_plain", "to_ntt", "multiply_no_relin",
    "relinearize", "multiply", "mod_switch_to_next",
    "switch_relin_keys", "switch_galois_keys", "rotate_rows", "rotate_columns",
    "apply_galois_hoisted", "apply_galois_hoisted_sum", "apply_galois_hoisted_batch"])(
    jax.jit(jbgv.keygen), jax.jit(jbgv.relinkey_gen),
    jax.jit(jbgv.galoiskey_gen, static_argnames=("elements",)),
    jax.jit(jbgv.encrypt), jax.jit(jbgv.decrypt), jax.jit(jbgv.add), jax.jit(jbgv.sub),
    jax.jit(jbgv.add_plain), jax.jit(jbgv.sub_plain), jax.jit(jbgv.multiply_plain),
    jax.jit(jbgv.to_ntt), jax.jit(jbgv.multiply_no_relin), jax.jit(jbgv.relinearize),
    jax.jit(jbgv.multiply),
    jax.jit(jbgv.mod_switch_to_next),
    jax.jit(jbgv.switch_relin_keys, static_argnums=2),
    jax.jit(jbgv.switch_galois_keys, static_argnums=2),
    jax.jit(jbgv.rotate_rows, static_argnums=2), jax.jit(jbgv.rotate_columns),
    jax.jit(_bgv(jbgv.apply_galois_hoisted, bgv=True), static_argnums=2),
    jax.jit(_bgv(jbgv.apply_galois_hoisted_sum, bgv=True), static_argnums=2),
    jax.jit(_bgv(jbgv.apply_galois_hoisted_batch, bgv=True), static_argnums=2))


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert got.scale_t == int(want.scale_t)
    assert isinstance(got.scale_t, int)
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


def _jct(ct: Ciphertext):
    return jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=ct.level,
                             is_ntt_form=ct.is_ntt_form, noise_budget=ct.noise_budget,
                             scale_t=ct.scale_t)


def _jpt(pt: Plaintext):
    return jtypes.Plaintext(data=jnp.asarray(convert.to_numpy(pt)))


def _keyswitch_draws(key, tb, k, n, sig):
    """bfv._keyswitch_keygen's draws: split(3) per digit, [kd, k, 1, n] each."""
    da, de = [], []
    for _ in range(k):
        key, k_a, k_e = jrandom.split(key, 3)
        da.append(_uniform(k_a, tb.p, tb.mu, 1, n))
        de.append(_gaussian(k_e, tb.p, sig, 1, n))
    return _t(np.stack(da)), _t(np.stack(de))


@pytest.fixture(scope="module")
def b():
    """The JAX reference state and the port's from the same draws: keys,
    relinearization and Galois keys, and three encryptions of VALS."""
    jp = jmake_params(JSecurity(**KW))
    jctx = jcontext.make_context(jp, use_pallas=False, use_mxu=False)
    tctx = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    assert tctx.k == jp.k == 4
    # galois_fold_tables and galois_perm_tables cache the arrays of their
    # first call; made under a jit trace they are tracers that leak into the
    # next trace, so the caches are filled here, outside any trace
    jcontext.galois_fold_tables.cache_clear()
    jcontext.galois_perm_tables.cache_clear()
    for g in ELEMENTS:
        jcontext.galois_fold_tables(N, g)
        jcontext.galois_perm_tables(N, g)
    tb = jctx.ntt_q
    k, h, sig = jp.k, jp.security.hamming_weight, jp.security.sigma
    k_key, k_rlk, k_gal, k_enc = jrandom.split(jrandom.PRNGKey(13), 4)

    jpk, jsk = J.keygen(jctx, k_key)
    k_s, k_a, k_e = jrandom.split(k_key, 3)
    tpk, tsk = tbgv.keygen_from_noise(
        tctx, _t(_ternary(k_s, tb.p, 1, N, h)), _t(_uniform(k_a, tb.p, tb.mu, 1, N)),
        _t(_gaussian(k_e, tb.p, sig, 1, N)))

    jrlk = J.relinkey_gen(jctx, k_rlk, jsk)
    trlk = tbgv.relinkey_gen_from_noise(tctx, tsk, *_keyswitch_draws(k_rlk, tb, k, N, sig))

    jgk = J.galoiskey_gen(jctx, k_gal, jsk, elements=ELEMENTS)
    key, draws = k_gal, []
    for _ in ELEMENTS:                    # bgv.galoiskey_gen's splits
        key, sub = jrandom.split(key)
        draws.append(_keyswitch_draws(sub, tb, k, N, sig))
    tgk = tbgv.galoiskey_gen_from_noise(tctx, tsk, ELEMENTS,
                                        torch.stack([a for a, _ in draws]),
                                        torch.stack([e for _, e in draws]))

    jenc, tenc = JEncoder(jp), BatchEncoder(tctx.params, "cpu")
    cts = []
    for kk, v in zip(jrandom.split(k_enc, len(VALS)), VALS):
        ku, k1, k2 = jrandom.split(kk, 3)
        want = J.encrypt(jctx, kk, jpk, jenc.encode(v))
        got = tbgv.encrypt_from_noise(
            tctx, tpk, tenc.encode(v), _t(_ternary(ku, tb.p, 1, N, h)),
            _t(_gaussian(k1, tb.p, sig, 1, N)), _t(_gaussian(k2, tb.p, sig, 1, N)))
        cts.append((want, got))
    return dataclasses.make_dataclass("B", [
        "jp", "jctx", "tctx", "jpk", "jsk", "tpk", "tsk", "jrlk", "trlk", "jgk", "tgk",
        "tenc", "cts"])(jp, jctx, tctx, jpk, jsk, tpk, tsk, jrlk, trlk, jgk, tgk, tenc,
                        cts)


def _dec(b, ct, count=4):
    """The port's decoded slots (test_decrypt_matches_jax holds the decrypt
    against the JAX one)."""
    return [int(x) for x in b.tenc.decode(tbgv.decrypt(b.tctx, ct, b.tsk))[:count]]


def _rotated(vals, steps, half=N // 2):
    row = list(vals) + [0] * (half - len(vals))
    return row[steps:] + row[:steps]


def _switched(b, level):
    """The first two ciphertexts switched down to ``level`` in both packages."""
    (ja, ta), (jb, tb_) = b.cts[:2]
    for _ in range(level):
        ja, jb = J.mod_switch_to_next(b.jctx, ja), J.mod_switch_to_next(b.jctx, jb)
        ta, tb_ = tbgv.mod_switch_to_next(b.tctx, ta), tbgv.mod_switch_to_next(b.tctx, tb_)
    return (ja, jb), (ta, tb_)


# ---------------------------------------------------------------------------
# the pieces BGV adds below the scheme
# ---------------------------------------------------------------------------


def test_mul_scalar_matches_jax(b):
    x = np.stack([RNG.integers(0, p, (2, N), dtype=np.uint32) for p in b.jp.q_primes])
    for c in (b.jp.t, 786433, -5, 3 << 40):
        np.testing.assert_array_equal(
            convert.to_numpy(tpoly.mul_scalar(_t(x), c, b.tctx.ntt_q)),
            _np(jpoly.mul_scalar(jnp.asarray(x), c, b.jctx.ntt_q)))


@pytest.mark.parametrize("level", [0, 2])
def test_bgv_mod_switch_drop_last_matches_jax(b, level):
    mc_t, mc_j = b.tctx.bgv_mod_switch[level], b.jctx.bgv_mod_switch[level]
    primes = b.jp.q_primes[:b.jp.k - level]
    x = np.stack([RNG.integers(0, p, (3, N), dtype=np.uint32) for p in primes])
    x[-1, 0, :4] = [0, 1, mc_t.q_last - 1, mc_t.q_last // 2]   # centring edges
    np.testing.assert_array_equal(
        convert.to_numpy(trns.bgv_mod_switch_drop_last(_t(x), mc_t)),
        _np(jrns.bgv_mod_switch_drop_last(jnp.asarray(x), mc_j)))
    assert mc_t.q_last == int(mc_j.q_last) and mc_t.inv_t_qlast == int(mc_j.inv_t_qlast)


@pytest.mark.parametrize("t", [65537, 786433])
def test_sm_mrq_onto_t_matches_jax(b, t):
    """BGV decryption's centred lift q_L -> {t}: a 17- or 20-bit destination,
    not a 30-bit prime; the centred alpha p_dst - (2^16 - alpha) included."""
    for level in (0, 1, 3):
        primes = b.jp.q_primes[:b.jp.k - level]
        tc = trns.make_sm_mrq(primes, (t,), device="cpu")
        jc = jrns.make_sm_mrq(primes, (t,), b.jp.m_tilde)
        x = np.stack([RNG.integers(0, p, (2, N), dtype=np.uint32) for p in primes])
        x[:, 0, :2] = 0
        x[:, 0, 2] = [p - 1 for p in primes]                    # -1: the top half
        np.testing.assert_array_equal(convert.to_numpy(trns.sm_mrq(_t(x), tc)),
                                      _np(jrns.sm_mrq(jnp.asarray(x), jc)))


def test_context_bgv_constants_match_jax(b):
    assert len(b.tctx.bgv_dec_levels) == b.jp.k
    assert len(b.tctx.bgv_mod_switch) == b.jp.k - 1
    for tc, jc in zip(b.tctx.bgv_dec_levels, b.jctx.bgv_dec_levels):
        np.testing.assert_array_equal(convert.to_numpy(tc.conv.p_dst), [b.jp.t])
        np.testing.assert_array_equal(convert.to_numpy(tc.mt_times_inv_phat),
                                      _np(jc.mt_times_inv_phat))
        assert tc.inv_q_mt == int(jc.inv_q_mt)


# ---------------------------------------------------------------------------
# keys, encrypt, decrypt, the additive ops
# ---------------------------------------------------------------------------


def test_keys_match_jax(b):
    np.testing.assert_array_equal(convert.to_numpy(b.tpk), _np(b.jpk.data))
    np.testing.assert_array_equal(convert.to_numpy(b.tsk), _np(b.jsk.data))
    np.testing.assert_array_equal(convert.to_numpy(b.trlk), _np(b.jrlk.data))
    assert b.trlk.data.shape == (4, 4, 2, N)
    assert set(b.tgk.data) == set(ELEMENTS)
    for g in ELEMENTS:
        np.testing.assert_array_equal(convert.to_numpy(b.tgk.data[g]),
                                      _np(b.jgk.data[g]))


def test_keys_differ_from_bfv_by_t_e(b):
    """pk0 + pk1*s is t*e where BFV's is e: with a = 0 and e = 1 (the
    constant polynomial) pk0 is NTT(t) = t in BGV and NTT(1) = 1 in BFV."""
    s = tbfv.to_coeff(b.tctx, Ciphertext(data=b.tsk.data, is_ntt_form=True)).data
    e = torch.zeros_like(s)
    e[:, :, 0] = 1
    pk_bfv, _ = tbfv.keygen_from_noise(b.tctx, s, torch.zeros_like(s), e)
    pk_bgv, sk_bgv = tbgv.keygen_from_noise(b.tctx, s, torch.zeros_like(s), e)
    assert torch.equal(sk_bgv.data, b.tsk.data)
    assert torch.equal(pk_bfv.data[:, 0], torch.ones_like(pk_bfv.data[:, 0]))
    assert torch.equal(pk_bgv.data[:, 0], torch.full_like(pk_bgv.data[:, 0], b.jp.t))


def test_encrypt_matches_jax(b):
    for (want, got), vals in zip(b.cts, VALS):
        assert_ct_equal(got, want)
        assert got.scale_t == 1
        assert _dec(b, got) == vals


def test_decrypt_matches_jax(b):
    """Fresh (scale_t 1), switched down twice (scale_t != 1, the Shoup
    multiply mod t) and 3-component (two phase terms)."""
    (ja, jb), (ta, tb_) = _switched(b, 2)
    assert ta.scale_t != 1
    for jct, tct in ((b.cts[0][0], b.cts[0][1]), (ja, ta),
                     (J.multiply_no_relin(b.jctx, ja, jb),
                      tbgv.multiply_no_relin(b.tctx, ta, tb_))):
        got = tbgv.decrypt(b.tctx, tct, b.tsk)
        np.testing.assert_array_equal(convert.to_numpy(got),
                                      _np(J.decrypt(b.jctx, jct, b.jsk).data))
    assert [int(x) for x in b.tenc.decode(got)[:4]] == PRODUCT


def test_add_sub_match_jax(b):
    (ja, ta), (jb, tb_) = b.cts[:2]
    for jf, tf, want in ((J.add, tbgv.add, [8, 16, 24, 32]),
                         (J.sub, tbgv.sub, [2, 4, 6, 8])):
        got = tf(b.tctx, ta, tb_)
        assert_ct_equal(got, jf(b.jctx, ja, jb))
        assert _dec(b, got) == want


# ---------------------------------------------------------------------------
# the multiply
# ---------------------------------------------------------------------------


def test_multiply_no_relin_matches_jax(b):
    (ja, ta), (jb, tb_) = b.cts[:2]
    got = tbgv.multiply_no_relin(b.tctx, ta, tb_)
    assert_ct_equal(got, J.multiply_no_relin(b.jctx, ja, jb))
    assert got.num_components == 3 and _dec(b, got) == PRODUCT


def test_multiply_no_relin_resident_matches_jax(b):
    """Two NTT-form operands: pointwise products and one inverse transform;
    the same residues as the coefficient branch."""
    (ja, ta), (jb, tb_) = b.cts[:2]
    got = tbgv.multiply_no_relin(b.tctx, tbgv.to_ntt(b.tctx, ta), tbgv.to_ntt(b.tctx, tb_))
    want = J.multiply_no_relin(b.jctx, J.to_ntt(b.jctx, ja), J.to_ntt(b.jctx, jb))
    assert_ct_equal(got, want)
    assert torch.equal(got.data, tbgv.multiply_no_relin(b.tctx, ta, tb_).data)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_relinearize_and_multiply_match_jax(b, level):
    """Level-0 keys switched down on the fly with the t-corrected switch
    (BFV's rounding switch gives keys that decode wrong from level 1 on)."""
    (ja, jb), (ta, tb_) = _switched(b, level)
    m3, jm3 = tbgv.multiply_no_relin(b.tctx, ta, tb_), J.multiply_no_relin(b.jctx, ja, jb)
    relin = tbgv.relinearize(b.tctx, m3, b.trlk)
    assert_ct_equal(relin, J.relinearize(b.jctx, jm3, b.jrlk))
    prod = tbgv.multiply(b.tctx, ta, tb_, b.trlk)
    assert_ct_equal(prod, J.multiply(b.jctx, ja, jb, b.jrlk))
    assert torch.equal(prod.data, relin.data)
    assert _dec(b, m3) == _dec(b, prod) == PRODUCT
    rlk_l = tbgv.switch_relin_keys(b.tctx, b.trlk, level)
    assert torch.equal(tbgv.multiply(b.tctx, ta, tb_, rlk_l, keys_at_level=True).data,
                       prod.data)


def test_multiply_batch_matches_jax(b):
    """The batched path (tensor_product_batch on the plain tables, one
    keyswitch_fused_batch) against the JAX multiply and the port's single
    multiply, pair by pair; at level 1 too, where scale_t != 1."""
    jcs = [c[0] for c in b.cts]
    tcs = [c[1] for c in b.cts]
    for level in (0, 1):
        if level:
            jcs = [J.mod_switch_to_next(b.jctx, c) for c in jcs]
            tcs = [tbgv.mod_switch_to_next(b.tctx, c) for c in tcs]
        got = tbgv.multiply_batch(b.tctx, tcs, tcs[1:] + tcs[:1], b.trlk)
        # on a use_pallas=False context the JAX multiply_batch is multiply per
        # pair (and its batched kernels equal that bit for bit)
        for i, gi in enumerate(got):
            assert_ct_equal(gi, J.multiply(b.jctx, jcs[i], jcs[(i + 1) % 3], b.jrlk))
            single = tbgv.multiply(b.tctx, tcs[i], tcs[(i + 1) % 3], b.trlk)
            assert torch.equal(gi.data, single.data)
            assert (gi.noise_budget, gi.scale_t) == (single.noise_budget, single.scale_t)
        assert [_dec(b, c, 2) for c in got] == [[15, 60], [21, 6], [35, 10]]
    # one pair and an NTT-form operand fall back to multiply
    one = tbgv.multiply_batch(b.tctx, tcs[:1], tcs[1:2], b.trlk)
    assert torch.equal(one[0].data, got[0].data)


# ---------------------------------------------------------------------------
# modulus switching and switched keys
# ---------------------------------------------------------------------------


def test_mod_switch_matches_jax(b):
    (ja, ta) = b.cts[0]
    for level in (1, 2, 3):
        ja, ta = J.mod_switch_to_next(b.jctx, ja), tbgv.mod_switch_to_next(b.tctx, ta)
        assert_ct_equal(ta, ja)
        assert _dec(b, ta) == VALS[0]
    want_scale = b.jp.q_primes[3] * b.jp.q_primes[2] * b.jp.q_primes[1] % b.jp.t
    assert ta.scale_t == want_scale
    assert torch.equal(tbgv.mod_switch_to_level(b.tctx, b.cts[0][1], 3).data, ta.data)
    with pytest.raises(ValueError, match="last level"):
        tbgv.mod_switch_to_next(b.tctx, ta)


# ---------------------------------------------------------------------------
# the oracle, the errors, the facade
# ---------------------------------------------------------------------------


def _bigint(ct, primes):
    return [trns.from_rns_host(ct.data[:, c], primes) for c in range(ct.num_components)]


def test_tensor_product_and_mod_switch_match_oracle(b):
    (_, ta), (_, tb_) = b.cts[:2]
    qs = b.jp.q_primes
    o = oracle.BGVOracle(b.jp, seed=0)
    got = tbgv.multiply_no_relin(b.tctx, ta, tb_)
    assert _bigint(got, qs) == o.multiply_no_relin(_bigint(ta, qs), _bigint(tb_, qs))
    switched = tbgv.mod_switch_to_next(b.tctx, ta)
    assert _bigint(switched, qs[:-1]) == o.mod_switch_drop_last(_bigint(ta, qs))


def test_scale_mismatch_raises_as_jax(b):
    """Operands at one level with different scale_t: add, sub and the
    multiply raise in both packages (the JAX guard runs eagerly)."""
    (ja, _), (ta, _) = _switched(b, 1)
    jm = J.multiply(b.jctx, ja, ja, b.jrlk)       # scale_t q_last^2, level 1
    tm = tbgv.multiply(b.tctx, ta, ta, b.trlk)
    assert tm.scale_t != ta.scale_t and tm.scale_t == int(jm.scale_t)
    for fn in ("add", "sub", "multiply_no_relin"):
        with pytest.raises(ValueError, match="scale_t"):
            getattr(tbgv, fn)(b.tctx, tm, ta)
        with pytest.raises(ValueError, match="scale_t"):
            getattr(jbgv, fn)(b.jctx, jm, ja)
    with pytest.raises(ValueError, match="level"):
        tbgv.add(b.tctx, b.cts[0][1], ta)
    with pytest.raises(ValueError, match="2-component"):
        tbgv.multiply_no_relin(b.tctx, tbgv.multiply_no_relin(b.tctx, ta, ta), tm)


def test_facade_bgv_round_trip_on_cpu():
    fhe = FHE(seed=5, scheme="bgv", device="cpu", **KW)
    assert fhe.scheme_name == "bgv"
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=(3, 2 * N - 1))
    dec = lambda ct, c=4: [int(x) for x in fhe.decode(fhe.decrypt(ct, sk))[:c]]
    c1, c2 = fhe.encrypt(fhe.encode(VALS[0]), pk), fhe.encrypt(fhe.encode(VALS[1]), pk)
    assert dec(c1) == VALS[0]
    prod = fhe.multiply(c1, c2, rlk)
    assert dec(prod) == dec(fhe.relinearize(fhe.multiply_no_relin(c1, c2), rlk)) == PRODUCT
    s1 = fhe.mod_switch_to_next(prod)
    assert s1.scale_t != 1 and dec(s1) == PRODUCT
    assert dec(fhe.add_plain(s1, fhe.encode([1, 2, 3, 4]))) == [16, 62, 138, 244]
    assert dec(fhe.multiply_plain(s1, fhe.encode([2, 2, 2, 2]))) == [30, 120, 270, 480]
    assert dec(fhe.rotate_rows(s1, 1, gk), 3) == [60, 135, 240]
    # the per-level key cache holds t-corrected keys
    assert torch.equal(fhe._rlk_at(rlk, 1).data, tbgv.switch_relin_keys(fhe.ctx, rlk, 1).data)
    s1b = fhe.mod_switch_to_next(fhe.multiply(c2, c1, rlk))
    assert dec(fhe.multiply(s1, s1b, rlk)) == [225, 3600, 18225, 57600 % 65537]
    # ops BGV lacks run the single op per ciphertext
    cts = fhe.encrypt_batch([fhe.encode(v) for v in VALS], pk)
    assert [dec(c) for c in cts] == list(VALS)
    assert [[int(x) for x in fhe.decode(p)[:4]] for p in fhe.decrypt_batch(cts, sk)] \
        == list(VALS)
    assert [dec(c, 3) for c in fhe.rotate_rows_batch(cts[:2], 1, gk)] == [
        VALS[0][1:], VALS[1][1:]]
    with pytest.raises(NotImplementedError):
        fhe.modulus_raise(s1)
    fresh = fhe.bootstrap(s1, sk, pk)
    assert fresh.level == 0 and fresh.scale_t == 1 and dec(fresh) == PRODUCT
    assert fhe.estimate_noise_budget(fresh, sk) > fhe.estimate_noise_budget(prod, sk) > 0
    with pytest.raises(ValueError, match="unknown scheme 'ckks'; use 'bfv' or 'bgv'"):
        FHE(scheme="ckks", device="cpu", **KW)


def test_facade_bgv_hoisted_and_sum_slots_on_cpu():
    fhe = FHE(seed=6, scheme="bgv", device="cpu", **KW)
    pk, sk = fhe.keygen()
    gk = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    ct = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk))
    outs = fhe.rotate_rows_hoisted(ct, (1, 2, 3), gk)
    for s, out in enumerate(outs, 1):
        assert out.scale_t == ct.scale_t
        assert [int(x) for x in fhe.decode(fhe.decrypt(out, sk))[:N // 2]] == \
            _rotated([5, 10, 15, 20], s)
    rows = fhe.rotate_rows_hoisted_batch([ct, ct], (1, 2, 3), gk)
    assert all(torch.equal(x.data, y.data) for row in rows for x, y in zip(row, outs))
    total = fhe.sum_slots(ct, gk)
    assert total.scale_t == ct.scale_t
    assert set(int(x) for x in fhe.decode(fhe.decrypt(total, sk))) == {50}
