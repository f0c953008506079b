"""The ciphertext multiply slice, held bit for bit against the JAX package.

Kernel modules: the port's wrappers on CPU tensors (their plain PyTorch
versions) against the Pallas kernels in interpreter mode, on the same random
residues: ntt_pallas.tensor_product (with and without the t fold),
rns_pallas.bsk_branch_fused, tensor_product's Lift lane (rns_pallas.sm_mrq_fused
then ntt_pallas.tensor_product on the Bsk base), rns_pallas.fast_bconv_sk_fused
and ntt_pallas.keyswitch_fused.  tests/test_torch_cuda.py holds the CUDA kernels
against the same plain versions on the card.

The slice: relinkey_gen_from_noise, multiply_no_relin, relinearize,
multiply and the 3-component decrypt against fhe_tpu.scheme.bfv, jitted, on
a use_pallas=False context (pinned equal to the Pallas path by
tests/test_pallas.py), with the JAX draws re-derived from the same key
splits as bfv.keygen, bfv.encrypt and bfv._keyswitch_keygen.  Also
multiply_no_relin against fhe_tpu.oracle.behz_multiply_no_relin.

n = 1024, k = 3, h = 16, lambda_ = 0 (n >= 1024 takes the headline
branch).  Residues are compared with tolerance 0; the noise budget, which
the JAX package carries in float32, to 1e-4 bits."""

import dataclasses
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jrandom
import torch

from fhe_tpu import oracle
from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.ops import rns as jrns
from fhe_tpu.ops import rns_pallas as rpal
from fhe_tpu.ops import sampling as jsampling
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import types as jtypes
from fhe_tpu.scheme.context import make_context as jmake_context
from fhe_tpu.scheme.encoder import BatchEncoder as JEncoder

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import ntt_cuda, rns_cuda
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder
from fhe_tpu_torch.scheme.types import RelinKeys

J = types.SimpleNamespace(**{f: jax.jit(getattr(jbfv, f)) for f in (
    "keygen", "relinkey_gen", "encrypt", "decrypt", "multiply_no_relin",
    "relinearize", "multiply")})
KW = dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0)
RNG = np.random.default_rng(20261016)

_ternary = jax.jit(jsampling.ternary_rns, static_argnums=(2, 3, 4))
_uniform = jax.jit(jsampling.uniform_rns, static_argnums=(3, 4))
_gaussian = jax.jit(jsampling.gaussian_rns, static_argnums=(2, 3, 4))


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _residues(moduli, shape):
    return np.stack([RNG.integers(0, p, shape, dtype=np.uint32) for p in moduli])


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


@pytest.fixture(scope="module")
def s():
    """JAX reference state and the port's state built from the same draws:
    keys, relinearization keys, two ciphertexts of [5,10,15,20] and
    [3,6,9,12], and each package's multiply of them."""
    jp = jmake_params(JSecurity(**KW))
    jctx = jmake_context(jp, use_pallas=False, use_mxu=False)
    tctx = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    tb = jctx.ntt_q
    n, h, sig = jp.n, jp.security.hamming_weight, jp.security.sigma
    k_key, k_rlk, k_e1, k_e2 = jrandom.split(jrandom.PRNGKey(23), 4)

    jpk, jsk = J.keygen(jctx, k_key)
    k_s, k_a, k_e = jrandom.split(k_key, 3)
    tpk, tsk = tbfv.keygen_from_noise(
        tctx, _t(_ternary(k_s, tb.p, 1, n, h)), _t(_uniform(k_a, tb.p, tb.mu, 1, n)),
        _t(_gaussian(k_e, tb.p, sig, 1, n)))

    jrlk = J.relinkey_gen(jctx, k_rlk, jsk)
    key, draws_a, draws_e = k_rlk, [], []
    for _ in range(jp.k):                 # bfv._keyswitch_keygen's splits
        key, k_a, k_e = jrandom.split(key, 3)
        draws_a.append(_uniform(k_a, tb.p, tb.mu, 1, n))
        draws_e.append(_gaussian(k_e, tb.p, sig, 1, n))
    trlk = tbfv.relinkey_gen_from_noise(tctx, tsk, _t(np.stack(draws_a)),
                                        _t(np.stack(draws_e)))

    jenc, tenc = JEncoder(jp), BatchEncoder(tctx.params, "cpu")
    vals = ([5, 10, 15, 20], [3, 6, 9, 12])

    def enc_both(k, v):
        ku, k1, k2 = jrandom.split(k, 3)
        want = J.encrypt(jctx, k, jpk, jenc.encode(v))
        got = tbfv.encrypt_from_noise(
            tctx, tpk, tenc.encode(v), _t(_ternary(ku, tb.p, 1, n, h)),
            _t(_gaussian(k1, tb.p, sig, 1, n)), _t(_gaussian(k2, tb.p, sig, 1, n)))
        return want, got

    (ja, ta), (jb, tb_) = enc_both(k_e1, vals[0]), enc_both(k_e2, vals[1])
    jm3, tm3 = J.multiply_no_relin(jctx, ja, jb), tbfv.multiply_no_relin(tctx, ta, tb_)
    return dataclasses.make_dataclass("S", [
        "jctx", "tctx", "jsk", "tsk", "jrlk", "trlk", "tenc", "cts", "m3"])(
        jctx, tctx, jsk, tsk, jrlk, trlk, tenc, ((ja, ta), (jb, tb_)), (jm3, tm3))


# ---------------------------------------------------------------------------
# kernel modules against the Pallas kernels in interpreter mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_folded", [True, False])
def test_tensor_product_matches_pallas(t_folded):
    prm = jmake_params(JSecurity(**KW))
    n, qs = prm.n, prm.q_primes
    if t_folded:
        pt = npal.build_mul_tables(n, qs, prm.bsk_primes, prm.t, prm.k,
                                   len(prm.bsk_primes))[0]
        tb = tntt.build_mul_tables(tntt.build_tables(n, qs, "cpu"),
                                   tntt.build_tables(n, prm.bsk_primes, "cpu"),
                                   prm.t)[0]
    else:
        pt, tb = npal.build_pallas_tables(n, qs), tntt.build_tables(n, qs, "cpu")
    x, y = _residues(qs, (2, n)), _residues(qs, (2, n))
    want = np.asarray(npal.tensor_product(jnp.asarray(x), jnp.asarray(y), pt,
                                          interpret=True))
    got = ntt_cuda.tensor_product(_t(x), _t(y), tb)
    np.testing.assert_array_equal(convert.to_numpy(got), want)


def test_bsk_branch_matches_pallas(s):
    prm, jctx, tctx = s.jctx.params, s.jctx, s.tctx
    n, kb = prm.n, jctx.bsk_counts[0]
    tbsk_pl = npal.build_mul_tables(n, prm.q_primes, prm.bsk_primes, prm.t,
                                    prm.k, kb)[1]
    ab, tx_q = _residues(prm.q_primes, (4, n)), _residues(prm.q_primes, (3, n))
    want = np.asarray(rpal.bsk_branch_fused(
        jnp.asarray(ab), jnp.asarray(tx_q), jctx.smq, jctx.floor_c, tbsk_pl,
        interpret=True))
    got = rns_cuda.bsk_branch_fused(_t(ab), _t(tx_q), tctx.smq, tctx.floor_c,
                                    tctx.mul_tables[1])
    np.testing.assert_array_equal(convert.to_numpy(got), want)


def test_tensor_product_lift_matches_pallas(s):
    """tensor_product's Lift lane (the n < 1024 multiply's two products) at
    n = 1024, where the multiply runs bsk_branch_fused instead: the
    product in q equals ntt_pallas.tensor_product, and that of the lifts of
    x || y into Bsk rns_pallas.sm_mrq_fused, then ntt_pallas.tensor_product
    on the Bsk base."""
    prm, jctx, tctx = s.jctx.params, s.jctx, s.tctx
    n, kb = prm.n, jctx.bsk_counts[0]
    tq_pl, tbsk_pl = npal.build_mul_tables(n, prm.q_primes, prm.bsk_primes, prm.t,
                                           prm.k, kb)
    x, y = _residues(prm.q_primes, (2, n)), _residues(prm.q_primes, (2, n))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    lift = rpal.sm_mrq_fused(jnp.concatenate([jx, jy], axis=1), jctx.smq, interpret=True)
    tq, tbsk = tctx.mul_tables
    got_q, got = ntt_cuda.tensor_product(_t(x), _t(y), tq, lift=(tctx.smq, tbsk))
    np.testing.assert_array_equal(
        convert.to_numpy(got_q), np.asarray(npal.tensor_product(jx, jy, tq_pl, interpret=True)))
    np.testing.assert_array_equal(
        convert.to_numpy(got),
        np.asarray(npal.tensor_product(lift[:, :2], lift[:, 2:], tbsk_pl, interpret=True)))
    assert got.shape == (kb, 3, n)


def test_fast_bconv_sk_matches_pallas(s):
    prm = s.jctx.params
    xb = _residues(prm.bsk_primes, (3, prm.n))
    want = np.asarray(rpal.fast_bconv_sk_fused(jnp.asarray(xb), s.jctx.sk_c,
                                               interpret=True))
    got = rns_cuda.fast_bconv_sk_fused(_t(xb), s.tctx.sk_c)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # the composed jnp conversion agrees too (one more reference)
    np.testing.assert_array_equal(
        want, np.asarray(jax.jit(jrns.fast_bconv_sk)(jnp.asarray(xb), s.jctx.sk_c)))


def test_keyswitch_matches_pallas(s):
    prm = s.jctx.params
    n, qs = prm.n, prm.q_primes
    d = np.stack([RNG.integers(0, p, n, dtype=np.uint32) for p in qs])  # [kd, n]
    keys_t = _residues(qs, (prm.k, 2, n))                                # [k, kd, 2, n]
    want = np.asarray(npal.keyswitch_fused(
        jnp.asarray(d), jnp.asarray(keys_t), npal.build_pallas_tables(n, qs),
        interpret=True))
    got = ntt_cuda.keyswitch_fused(_t(d), _t(keys_t), s.tctx.ntt_q)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # the stored [digit, prime, 2, n] layout, read through a permuted view
    view = _t(keys_t.transpose(1, 0, 2, 3).copy()).permute(1, 0, 2, 3)
    got = ntt_cuda.keyswitch_fused(_t(d), view, s.tctx.ntt_q)
    np.testing.assert_array_equal(convert.to_numpy(got), want)


# ---------------------------------------------------------------------------
# the slice against fhe_tpu.scheme.bfv
# ---------------------------------------------------------------------------


def test_relinkey_gen_matches_jax(s):
    np.testing.assert_array_equal(convert.to_numpy(s.trlk), _np(s.jrlk.data))
    assert s.trlk.data.shape == (3, 3, 2, 1024)


def test_multiply_no_relin_matches_jax(s):
    jm3, tm3 = s.m3
    assert tm3.num_components == 3
    assert_ct_equal(tm3, jm3)


def test_relinearize_matches_jax(s):
    jm3, tm3 = s.m3
    assert_ct_equal(tbfv.relinearize(s.tctx, tm3, s.trlk),
                    J.relinearize(s.jctx, jm3, s.jrlk))


def test_multiply_matches_jax(s):
    (ja, ta), (jb, tb) = s.cts
    assert_ct_equal(tbfv.multiply(s.tctx, ta, tb, s.trlk),
                    J.multiply(s.jctx, ja, jb, s.jrlk))


def test_decrypt_three_components_matches_jax(s):
    jm3, tm3 = s.m3
    got = tbfv.decrypt(s.tctx, tm3, s.tsk)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  _np(J.decrypt(s.jctx, jm3, s.jsk).data))
    assert list(s.tenc.decode(got)[:4]) == [15, 60, 135, 240]
    relin = tbfv.relinearize(s.tctx, tm3, s.trlk)
    assert list(s.tenc.decode(tbfv.decrypt(s.tctx, relin, s.tsk))[:4]) == [
        15, 60, 135, 240]
    # an NTT-form 3-component ciphertext decrypts the same
    ntt = tbfv.to_ntt(s.tctx, tm3)
    assert torch.equal(tbfv.decrypt(s.tctx, ntt, s.tsk).data, got.data)


def test_multiply_no_relin_matches_oracle_behz(s):
    prm = s.jctx.params
    (_, ta), (_, tb) = s.cts

    def bigint(ct):
        data = convert.to_numpy(ct)
        return [jrns.from_rns_host(data[:, c, :], prm.q_primes)
                for c in range(data.shape[1])]

    want = oracle.behz_multiply_no_relin(prm, bigint(ta), bigint(tb))
    assert bigint(s.m3[1]) == want


def test_jax_relin_keys_cross_to_port(s):
    """JAX relinearization keys carried across by convert.py relinearize
    the same in the port."""
    rlk = convert.relin_keys_from_numpy(_np(s.jrlk.data), "cpu")
    np.testing.assert_array_equal(convert.to_numpy(rlk), _np(s.jrlk.data))
    tm3 = s.m3[1]
    assert torch.equal(tbfv.relinearize(s.tctx, tm3, rlk).data,
                       tbfv.relinearize(s.tctx, tm3, s.trlk).data)


def test_facade_multiply_on_cpu():
    """The FHE facade with the port's own samplers: multiply, and its two
    halves, decode to the slotwise product."""
    fhe = FHE(seed=7, device="cpu", **KW)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    c1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    c2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    dec = lambda ct: list(fhe.decode(fhe.decrypt(ct, sk))[:4])
    m3 = fhe.multiply_no_relin(c1, c2)
    relin = fhe.relinearize(m3, rlk)
    prod = fhe.multiply(c1, c2, rlk)
    assert dec(m3) == dec(relin) == dec(prod) == [15, 60, 135, 240]
    assert torch.equal(prod.data, relin.data)
    assert 0 < prod.noise_budget < m3.noise_budget < c1.noise_budget
    assert dec(fhe.multiply(fhe.add(c1, c2), c2, rlk)) == [24, 96, 216, 384]


def test_small_ring_multiply_matches_jax_and_foreign_keys_raise():
    """n < 1024 takes the multiply's tensor_product Lift lane /
    fast_floor_fused branch:
    it decodes and equals fhe_tpu's multiply_no_relin on the same
    ciphertext (tests/test_torch_leveled.py holds it at every level).
    Grouped gadget digits (ks_omega > 1) are ported
    (tests/test_torch_omega.py); relinearization keys of another gadget
    raise."""
    small = FHE(seed=1, device="cpu", poly_degree=256, log_q=60,
                hamming_weight=16, lambda_=0)
    pk, sk = small.keygen()
    ct = small.encrypt(small.encode([1, 2, 3]), pk)
    m3 = small.multiply_no_relin(ct, ct)
    assert list(small.decode(small.decrypt(m3, sk))[:3]) == [1, 4, 9]
    jctx = jmake_context(jmake_params(JSecurity(poly_degree=256, log_q=60,
                                                hamming_weight=16, lambda_=0)),
                         use_pallas=False, use_mxu=False)
    jct = jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)),
                            noise_budget=ct.noise_budget)
    assert_ct_equal(m3, J.multiply_no_relin(jctx, jct, jct))
    grouped = FHE(seed=1, device="cpu", ks_omega=2, **KW)
    pk, sk = grouped.keygen()
    assert grouped.relinkey_gen(sk).data.shape == (2, 3, 2, 1024)
    ct = grouped.encrypt(grouped.encode([1, 2]), pk)
    classic = RelinKeys(data=torch.zeros((3, 3, 2, 1024), dtype=torch.int32))
    with pytest.raises(ValueError, match="keys"):
        grouped.multiply(ct, ct, classic)
