"""The serving batch path, held bit for bit against the JAX package.

Kernel modules: the port's batch wrappers on CPU tensors (their plain
PyTorch versions) against the Pallas kernels in interpreter mode, on the
same random residues: ntt_pallas.tensor_product_batch (t-folded),
keyswitch_fused_batch and mul_by_ntt_operand_batch; the batched
bsk_branch_fused against the single one per element and against the JAX
composition it replaces in bfv.multiply_batch (vmapped sm_mrq ->
tensor_product_batch on the Bsk base -> vmapped fast_floor).
tests/test_torch_cuda.py holds the CUDA kernels against the same plain
versions on the card.

The slice: encrypt_batch_from_noise, decrypt_batch and multiply_batch
against fhe_tpu.scheme.bfv's encrypt_batch, decrypt_batch and
multiply_batch on a use_pallas=False context (pinned equal to the Pallas
path by tests/test_pallas.py), with the JAX draws re-derived from the same
key splits (fold_in(key, i), then split(3), as bfv.encrypt_batch).  Element
i of every batch op also equals the port's single op.

n = 1024, k = 3, h = 16, lambda_ = 0, B = 3.  Residues are compared with
tolerance 0; the noise budget, which the JAX package carries in float32, to
1e-4 bits."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jrandom
import torch

from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.ops import rns as jrns
from fhe_tpu.ops import sampling as jsampling
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme.context import make_context as jmake_context
from fhe_tpu.scheme.encoder import BatchEncoder as JEncoder

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import ntt_cuda, rns_cuda
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder

KW = dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0)
B = 3
VALS_A = ([5, 10, 15, 20], [1, 2, 3, 4], [7, 0, 65536, 9])
VALS_B = ([3, 6, 9, 12], [2, 2, 2, 2], [1, 5, 2, 100])
RNG = np.random.default_rng(20261017)

# the JAX references, jitted once (eager JAX costs minutes at n = 1024)
J_ENCRYPT_BATCH = jax.jit(jbfv.encrypt_batch)
J_DECRYPT_BATCH = jax.jit(jbfv.decrypt_batch)
J_MULTIPLY_BATCH = jax.jit(jbfv.multiply_batch)
J_LIFT = jax.jit(jax.vmap(jrns.sm_mrq, in_axes=(0, None)))
J_FLOOR = jax.jit(jax.vmap(jrns.fast_floor, in_axes=(0, 0, None)))

_ternary = jax.jit(jsampling.ternary_rns, static_argnums=(2, 3, 4))
_uniform = jax.jit(jsampling.uniform_rns, static_argnums=(3, 4))
_gaussian = jax.jit(jsampling.gaussian_rns, static_argnums=(2, 3, 4))


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _residues(moduli, shape):
    return np.stack([RNG.integers(0, p, shape, dtype=np.uint32) for p in moduli])


def _slots(vals_a, vals_b, t=65537):
    return [[x * y % t for x, y in zip(a, b)] for a, b in zip(vals_a, vals_b)]


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


@pytest.fixture(scope="module")
def s():
    """JAX reference state and the port's, built from the same draws: keys,
    relinearization keys, two batches of B encryptions (VALS_A, VALS_B) and
    each package's multiply_batch of them."""
    jp = jmake_params(JSecurity(**KW))
    jctx = jmake_context(jp, use_pallas=False, use_mxu=False)
    tctx = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    tb = jctx.ntt_q
    n, h, sig = jp.n, jp.security.hamming_weight, jp.security.sigma
    k_key, k_rlk, k_a, k_b = jrandom.split(jrandom.PRNGKey(31), 4)

    jpk, jsk = jax.jit(jbfv.keygen)(jctx, k_key)
    k_s, k_pa, k_e = jrandom.split(k_key, 3)
    tpk, tsk = tbfv.keygen_from_noise(
        tctx, _t(_ternary(k_s, tb.p, 1, n, h)), _t(_uniform(k_pa, tb.p, tb.mu, 1, n)),
        _t(_gaussian(k_e, tb.p, sig, 1, n)))

    jrlk = jax.jit(jbfv.relinkey_gen)(jctx, k_rlk, jsk)
    key, draws_a, draws_e = k_rlk, [], []
    for _ in range(jp.k):                 # bfv._keyswitch_keygen's splits
        key, kk_a, kk_e = jrandom.split(key, 3)
        draws_a.append(_uniform(kk_a, tb.p, tb.mu, 1, n))
        draws_e.append(_gaussian(kk_e, tb.p, sig, 1, n))
    trlk = tbfv.relinkey_gen_from_noise(tctx, tsk, _t(np.stack(draws_a)),
                                        _t(np.stack(draws_e)))

    jenc, tenc = JEncoder(jp), BatchEncoder(tctx.params, "cpu")

    def enc_both(key, vals):
        want = J_ENCRYPT_BATCH(jctx, key, jpk, [jenc.encode(v) for v in vals])
        cols = []
        for i in range(len(vals)):        # bfv.encrypt_batch's derivation
            ku, k1, k2 = jrandom.split(jrandom.fold_in(key, i), 3)
            cols.append((_ternary(ku, tb.p, 1, n, h), _gaussian(k1, tb.p, sig, 1, n),
                         _gaussian(k2, tb.p, sig, 1, n)))
        u, e1, e2 = (_t(np.concatenate([c[j] for c in cols], axis=1)) for j in range(3))
        got = tbfv.encrypt_batch_from_noise(tctx, tpk, [tenc.encode(v) for v in vals],
                                            u, e1, e2)
        return want, got, (u, e1, e2)

    ja, ta, draws = enc_both(k_a, VALS_A)
    jb, tb_, _ = enc_both(k_b, VALS_B)
    jprod = J_MULTIPLY_BATCH(jctx, ja, jb, jrlk)
    tprod = tbfv.multiply_batch(tctx, ta, tb_, trlk)
    return dataclasses.make_dataclass("S", [
        "jctx", "tctx", "jpk", "tpk", "jsk", "tsk", "jrlk", "trlk", "jenc", "tenc",
        "a", "b", "draws", "prod"])(
        jctx, tctx, jpk, tpk, jsk, tsk, jrlk, trlk, jenc, tenc, (ja, ta), (jb, tb_),
        draws, (jprod, tprod))


# ---------------------------------------------------------------------------
# kernel modules against the Pallas kernels in interpreter mode
# ---------------------------------------------------------------------------


def test_tensor_product_batch_matches_pallas():
    prm = jmake_params(JSecurity(**KW))
    n, qs = prm.n, prm.q_primes
    pt = npal.build_mul_tables(n, qs, prm.bsk_primes, prm.t, prm.k,
                               len(prm.bsk_primes))[0]
    tb = make_context(make_scheme_params(SecurityParams(**KW)), device="cpu").mul_tables[0]
    x, y = _residues(qs, (2, B, n)), _residues(qs, (2, B, n))
    want = np.asarray(npal.tensor_product_batch(jnp.asarray(x), jnp.asarray(y), pt,
                                                interpret=True))
    got = ntt_cuda.tensor_product_batch(_t(x), _t(y), tb)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # the multiply_batch layout: x and y as views of one [B, k, 4, n] stack
    stack = _t(np.concatenate([x, y], axis=1).transpose(2, 0, 1, 3).copy())
    view = stack.permute(1, 2, 0, 3)
    got = ntt_cuda.tensor_product_batch(view[:, :2], view[:, 2:], tb)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # slice b is the single tensor product of pair b
    for b in range(B):
        np.testing.assert_array_equal(
            convert.to_numpy(ntt_cuda.tensor_product(_t(x[:, :, b]), _t(y[:, :, b]), tb)),
            want[:, :, b])


def test_keyswitch_batch_matches_pallas(s):
    prm = s.jctx.params
    n, qs = prm.n, prm.q_primes
    d = np.stack([RNG.integers(0, p, (B, n), dtype=np.uint32) for p in qs])  # [kd, B, n]
    keys_t = _residues(qs, (prm.k, 2, n))                                 # [k, kd, 2, n]
    want = np.asarray(npal.keyswitch_fused_batch(
        jnp.asarray(d), jnp.asarray(keys_t), npal.build_pallas_tables(n, qs),
        interpret=True))
    view = _t(keys_t.transpose(1, 0, 2, 3).copy()).permute(1, 0, 2, 3)   # stored layout
    got = ntt_cuda.keyswitch_fused_batch(_t(d), view, s.tctx.ntt_q)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    for b in range(B):
        np.testing.assert_array_equal(convert.to_numpy(
            ntt_cuda.keyswitch_fused(_t(d[:, b]), view, s.tctx.ntt_q)), want[:, :, b])


def test_mul_by_ntt_operand_batch_matches_pallas(s):
    prm = s.jctx.params
    n, qs = prm.n, prm.q_primes
    u, w = _residues(qs, (B, n)), _residues(qs, (2, n))
    want = np.asarray(npal.mul_by_ntt_operand_batch(
        jnp.asarray(u), jnp.asarray(w), npal.build_pallas_tables(n, qs), interpret=True))
    got = ntt_cuda.mul_by_ntt_operand_batch(_t(u), _t(w), s.tctx.ntt_q)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # u as a strided [k, B, n] view (component 0 of a [B, k, 2, n] stack)
    stack = torch.stack([_t(u).permute(1, 0, 2), _t(u).permute(1, 0, 2)], dim=2)
    got = ntt_cuda.mul_by_ntt_operand_batch(stack[:, :, 0].transpose(0, 1), _t(w),
                                            s.tctx.ntt_q)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    for b in range(B):
        np.testing.assert_array_equal(convert.to_numpy(ntt_cuda.mul_by_ntt_operand(
            _t(u[:, b:b + 1]), _t(w), s.tctx.ntt_q)), want[:, :, b])


def test_bsk_branch_batch_matches_single_and_jax_composition(s):
    prm, jctx, tctx = s.jctx.params, s.jctx, s.tctx
    n, kb = prm.n, len(prm.bsk_primes)
    ab = _residues(prm.q_primes, (B, 4, n)).transpose(1, 0, 2, 3).copy()   # [B, k, 4, n]
    tx_q = _residues(prm.q_primes, (B, 3, n)).transpose(1, 0, 2, 3).copy()  # [B, k, 3, n]
    got = rns_cuda.bsk_branch_fused_batch(
        _t(ab).permute(1, 2, 0, 3), _t(tx_q).permute(1, 2, 0, 3), tctx.smq,
        tctx.floor_c, tctx.mul_tables[1])                                  # [kb, 3, B, n]
    assert got.shape == (kb, 3, B, n)
    for b in range(B):
        single = rns_cuda.bsk_branch_fused(_t(ab[b]), _t(tx_q[b]), tctx.smq,
                                           tctx.floor_c, tctx.mul_tables[1])
        assert torch.equal(got[:, :, b], single)
    # bfv.multiply_batch's composition on the same residues
    tbsk_pl = npal.build_mul_tables(n, prm.q_primes, prm.bsk_primes, prm.t, prm.k, kb)[1]
    lift = J_LIFT(jnp.asarray(ab), jctx.smq)
    to_k = lambda t: jnp.transpose(t, (1, 2, 0, 3))
    tx_bsk = npal.tensor_product_batch(to_k(lift[:, :, :2]), to_k(lift[:, :, 2:]),
                                       tbsk_pl, interpret=True)
    floored = J_FLOOR(jnp.asarray(tx_q), jnp.transpose(tx_bsk, (2, 0, 1, 3)),
                      jctx.floor_c)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  _np(jnp.transpose(floored, (1, 2, 0, 3))))


# ---------------------------------------------------------------------------
# the slice against fhe_tpu.scheme.bfv
# ---------------------------------------------------------------------------


def test_encrypt_batch_matches_jax(s):
    ja, ta = s.a
    assert len(ta) == B
    for got, want in zip(ta, ja):
        assert_ct_equal(got, want)
        assert got.data.is_contiguous() and got.data.shape == (3, 2, 1024)


def test_encrypt_batch_element_equals_single(s):
    _, ta = s.a
    u, e1, e2 = s.draws
    for i, v in enumerate(VALS_A):
        col = lambda x: x[:, i:i + 1]
        single = tbfv.encrypt_from_noise(s.tctx, s.tpk, s.tenc.encode(v), col(u),
                                         col(e1), col(e2))
        assert torch.equal(single.data, ta[i].data)
        assert single.noise_budget == ta[i].noise_budget


def test_decrypt_batch_matches_jax(s):
    ja, ta = s.a
    want = J_DECRYPT_BATCH(s.jctx, ja, s.jsk)
    got = tbfv.decrypt_batch(s.tctx, ta, s.tsk)
    for g, w, v in zip(got, want, VALS_A):
        np.testing.assert_array_equal(convert.to_numpy(g), _np(w.data))
        assert list(s.tenc.decode(g)[:4]) == v
    # JAX ciphertexts carried across decrypt the same in the port
    crossed = [convert.ciphertext_from_numpy(_np(c.data), noise_budget=float(c.noise_budget),
                                             device="cpu") for c in ja]
    for g, c in zip(got, tbfv.decrypt_batch(s.tctx, crossed, s.tsk)):
        assert torch.equal(g.data, c.data)


def test_decrypt_batch_falls_back_per_element(s):
    """One ciphertext, an NTT-form one, or a 3-component one: every element
    still equals decrypt."""
    _, ta = s.a
    m3 = tbfv.multiply_no_relin(s.tctx, ta[0], s.b[1][0])
    for cts in ([ta[0]], [tbfv.to_ntt(s.tctx, ta[1]), ta[2]], [ta[1], m3]):
        got = tbfv.decrypt_batch(s.tctx, cts, s.tsk)
        for g, ct in zip(got, cts):
            assert torch.equal(g.data, tbfv.decrypt(s.tctx, ct, s.tsk).data)
    assert list(s.tenc.decode(got[1])[:4]) == [15, 60, 135, 240]
    assert tbfv.decrypt_batch(s.tctx, [], s.tsk) == []


def test_multiply_batch_matches_jax(s):
    jprod, tprod = s.prod
    assert len(tprod) == B
    for got, want, slots in zip(tprod, jprod, _slots(VALS_A, VALS_B)):
        assert_ct_equal(got, want)
        assert [int(x) for x in s.tenc.decode(tbfv.decrypt(s.tctx, got, s.tsk))[:4]] == slots


def test_multiply_batch_element_equals_single(s):
    (_, ta), (_, tb) = s.a, s.b
    for i, got in enumerate(s.prod[1]):
        single = tbfv.multiply(s.tctx, ta[i], tb[i], s.trlk)
        assert torch.equal(single.data, got.data)
        assert single.noise_budget == got.noise_budget


def test_facade_serving_on_cpu():
    """The FHE facade with the port's own samplers: a batch encrypts,
    multiplies and decrypts to the slotwise products."""
    fhe = FHE(seed=4, device="cpu", **KW)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    cts_a = fhe.encrypt_batch([fhe.encode(v) for v in VALS_A], pk)
    cts_b = fhe.encrypt_batch([fhe.encode(v) for v in VALS_B], pk)
    assert not torch.equal(cts_a[0].data, cts_a[1].data)
    dec = [list(fhe.decode(pt)[:4]) for pt in fhe.decrypt_batch(cts_a, sk)]
    assert dec == [list(v) for v in VALS_A]
    prods = fhe.multiply_batch(cts_a, cts_b, rlk)
    dec = [[int(x) for x in fhe.decode(pt)[:4]] for pt in fhe.decrypt_batch(prods, sk)]
    assert dec == _slots(VALS_A, VALS_B)
    assert all(0 < p.noise_budget < c.noise_budget for p, c in zip(prods, cts_a))


J_MOD_SWITCH = jax.jit(jbfv.mod_switch_to_next)


def test_serving_at_level_one_and_malformed_batches(s):
    """multiply_batch and decrypt_batch at level 1 equal fhe_tpu's (each
    ciphertext switched down by its own package; the JAX relinearization
    keys switched down on the fly); at n = 256 multiply_batch takes the
    batched Bsk branch and equals the single multiply, which takes the
    n < 1024 branch.  Mixed levels, malformed batches and relinearization
    keys of another gadget (ks_omega = 2 takes kd = 2 digits, these keys
    have 3) raise."""
    (ja, ta), (jb, tb) = s.a, s.b
    deep_a = [tbfv.mod_switch_to_next(s.tctx, ct) for ct in ta]
    deep_b = [tbfv.mod_switch_to_next(s.tctx, ct) for ct in tb]
    jdeep_a = [J_MOD_SWITCH(s.jctx, ct) for ct in ja]
    jdeep_b = [J_MOD_SWITCH(s.jctx, ct) for ct in jb]
    for got, want in zip(deep_a, jdeep_a):
        assert_ct_equal(got, want)
    prods = tbfv.multiply_batch(s.tctx, deep_a, deep_b, s.trlk)
    for got, want in zip(prods, J_MULTIPLY_BATCH(s.jctx, jdeep_a, jdeep_b, s.jrlk)):
        assert_ct_equal(got, want)
    dec = tbfv.decrypt_batch(s.tctx, prods, s.tsk)
    assert [[int(x) for x in s.tenc.decode(pt)[:4]] for pt in dec] == _slots(VALS_A, VALS_B)
    for got, want in zip(tbfv.decrypt_batch(s.tctx, deep_a, s.tsk),
                         J_DECRYPT_BATCH(s.jctx, jdeep_a, s.jsk)):
        np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    with pytest.raises(ValueError, match="one level"):
        tbfv.multiply_batch(s.tctx, [deep_a[0], ta[1]], tb[:2], s.trlk)
    with pytest.raises(ValueError, match="equal-length"):
        tbfv.multiply_batch(s.tctx, ta, tb[:2], s.trlk)
    m3 = tbfv.multiply_no_relin(s.tctx, ta[0], tb[0])
    with pytest.raises(ValueError, match="2-component"):
        tbfv.multiply_batch(s.tctx, [m3], [tb[0]], s.trlk)
    grouped = make_context(make_scheme_params(SecurityParams(ks_omega=2, **KW)),
                           device="cpu")
    with pytest.raises(ValueError, match="keys"):
        tbfv.multiply_batch(grouped, ta, tb, s.trlk)
    small = FHE(seed=1, device="cpu", poly_degree=256, log_q=60, hamming_weight=16,
                lambda_=0)
    pk, sk = small.keygen()
    rlk = small.relinkey_gen(sk)
    cts = small.encrypt_batch([small.encode([1, 2]), small.encode([3])], pk)
    prods = small.multiply_batch(cts, cts, rlk)
    assert [list(small.decode(pt)[:2]) for pt in small.decrypt_batch(prods, sk)] == \
        [[1, 4], [9, 0]]
    assert all(torch.equal(p.data, small.multiply(c, c, rlk).data)
               for p, c in zip(prods, cts))
    with pytest.raises(ValueError, match="expected"):
        tbfv.encrypt_batch_from_noise(s.tctx, s.tpk, [s.tenc.encode([1])], *s.draws)
