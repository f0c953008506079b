"""Grouped gadget key switching (SecurityParams.ks_omega = 2), held bit for bit
against the JAX package.

Kernel modules: the prereduced lane of the port's keyswitch_fused and
keyswitch_fused_batch on CPU tensors (their plain PyTorch versions) against
ntt_pallas.keyswitch_fused / keyswitch_fused_batch(prereduced=True) in
interpreter mode.  The host table ks_group_conv_tables against
fhe_tpu.scheme.context's, and _grouped_digit_residues against
bfv._grouped_digit_residues.  tests/test_torch_cuda.py holds the CUDA lanes
against the same plain versions on the card.

The slice, as tests/test_ks_omega.py sets it: n = 1024, h = 16,
lambda_ = 0, ks_omega = 2, with log_q = 120 (k = 4, kd = 2) and
log_q = 90 (k = 3, kd = 2: a short last group).  relinkey_gen_from_noise
and galoiskey_gen_from_noise from the JAX package's own draws (re-derived
from the same key splits as bfv.relinkey_gen / galoiskey_gen and
bfv._keyswitch_keygen); relinearize, multiply, multiply_batch, key_switch,
rotate_rows, apply_galois_batch, apply_galois_hoisted and
apply_galois_hoisted_sum (a sum_slots stage on grouped digits) against
fhe_tpu.scheme.bfv, jitted, on a use_pallas=False context (where
bfv.multiply_batch is the single multiply per pair).  The secret key
and the ciphertexts come from the port's *_from_noise entry points with
numpy draws and are carried to the JAX package as arrays.  Residues are
compared with tolerance 0; the noise budget, which the JAX package carries
in float32, to 1e-4 bits."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jrandom
import torch

from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.ops import sampling as jsampling
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import ntt_cuda
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import context as tcontext
from fhe_tpu_torch.scheme.encoder import BatchEncoder
from fhe_tpu_torch.scheme.types import Ciphertext

N = 1024
ELEMS = (3, 9)                  # row rotations by 1 and by 2
VALS = ([5, 10, 15, 20], [3, 6, 9, 12])
RNG = np.random.default_rng(20261020)

_uniform = jax.jit(jsampling.uniform_rns, static_argnums=(3, 4))
_gaussian = jax.jit(jsampling.gaussian_rns, static_argnums=(2, 3, 4))

# the JAX references, jitted once (eager JAX costs minutes at n = 1024)
J = dataclasses.make_dataclass("J", [
    "relinkey_gen", "galoiskey_gen", "multiply_no_relin", "relinearize",
    "key_switch", "rotate_rows", "apply_galois_batch",
    "apply_galois_hoisted", "apply_galois_hoisted_sum", "grouped_digit_residues"])(
    jax.jit(jbfv.relinkey_gen),
    jax.jit(jbfv.galoiskey_gen, static_argnames=("elements",)),
    jax.jit(jbfv.multiply_no_relin),
    jax.jit(jbfv.relinearize),
    jax.jit(jbfv.key_switch),
    jax.jit(jbfv.rotate_rows, static_argnums=2),
    jax.jit(jbfv.apply_galois_batch, static_argnums=2),
    jax.jit(jbfv.apply_galois_hoisted, static_argnums=2),
    jax.jit(jbfv.apply_galois_hoisted_sum, static_argnums=2),
    jax.jit(jbfv._grouped_digit_residues, static_argnums=2))


def _kw(log_q):
    return dict(poly_degree=N, log_q=log_q, hamming_weight=16, lambda_=0, ks_omega=2)


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _residues(moduli, shape):
    return np.stack([RNG.integers(0, p, shape, dtype=np.uint32) for p in moduli])


def _small(moduli, shape, bound=6):
    """Residues of integers in [-bound, bound]: a stand-in for the error draws."""
    x = RNG.integers(-bound, bound + 1, shape)
    return np.stack([x % p for p in moduli]).astype(np.uint32)


def _ternary(moduli, n, h):
    s = np.zeros(n, dtype=np.int64)
    s[RNG.choice(n, h, replace=False)] = RNG.choice([-1, 1], h)
    return np.stack([(s % p)[None] for p in moduli]).astype(np.uint32)


def _jct(ct: Ciphertext):
    return jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=ct.level,
                             is_ntt_form=ct.is_ntt_form, noise_budget=ct.noise_budget)


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


def _keyswitch_draws(key, tb, kd):
    """bfv._keyswitch_keygen's draws: split(3) per gadget digit."""
    draws_a, draws_e = [], []
    for _ in range(kd):
        key, k_a, k_e = jrandom.split(key, 3)
        draws_a.append(_uniform(k_a, tb.p, tb.mu, 1, N))
        draws_e.append(_gaussian(k_e, tb.p, 3.2, 1, N))
    return _t(np.stack(draws_a)), _t(np.stack(draws_e))


@pytest.fixture(scope="module", params=[120, 90], ids=["k4", "k3_short_group"])
def w(request):
    """Each package's relinearization keys and Galois keys for ELEMS from
    the JAX draws, on one secret key; two ciphertexts of VALS."""
    kw = _kw(request.param)
    jp = jmake_params(JSecurity(**kw))
    jctx = jcontext.make_context(jp, use_pallas=False, use_mxu=False)
    jcontext.galois_fold_tables.cache_clear()   # filled outside any trace
    for g in ELEMS:
        jcontext.galois_fold_tables(N, g)
    fhe = FHE(device="cpu", seed=0, **kw)
    tctx, qs, kd = fhe.ctx, fhe.params.q_primes, -(-fhe.params.k // 2)
    pk, sk = tbfv.keygen_from_noise(tctx, _t(_ternary(qs, N, 16)),
                                    _t(_residues(qs, (1, N))), _t(_small(qs, (1, N))))
    jsk = jtypes.SecretKey(data=jnp.asarray(convert.to_numpy(sk)))
    k_rlk, k_gal = jrandom.split(jrandom.PRNGKey(61))
    jrlk = J.relinkey_gen(jctx, k_rlk, jsk)
    trlk = tbfv.relinkey_gen_from_noise(tctx, sk, *_keyswitch_draws(k_rlk, jctx.ntt_q, kd))
    jgk = J.galoiskey_gen(jctx, k_gal, jsk, elements=ELEMS)
    key, draws = k_gal, []
    for _ in ELEMS:                       # bfv.galoiskey_gen's splits
        key, sub = jrandom.split(key)
        draws.append(_keyswitch_draws(sub, jctx.ntt_q, kd))
    tgk = tbfv.galoiskey_gen_from_noise(tctx, sk, ELEMS,
                                        torch.stack([a for a, _ in draws]),
                                        torch.stack([e for _, e in draws]))
    enc = BatchEncoder(tctx.params, "cpu")
    cts = [tbfv.encrypt_from_noise(tctx, pk, enc.encode(v), _t(_ternary(qs, N, 16)),
                                   _t(_small(qs, (1, N))), _t(_small(qs, (1, N))))
           for v in VALS]
    return dataclasses.make_dataclass("W", [
        "fhe", "jctx", "tctx", "kd", "sk", "jrlk", "trlk", "jgk", "tgk", "enc", "cts"])(
        fhe, jctx, tctx, kd, sk, jrlk, trlk, jgk, tgk, enc, cts)


def _decode(w, ct):
    return [int(x) for x in w.enc.decode(tbfv.decrypt(w.tctx, ct, w.sk))]


# ---------------------------------------------------------------------------
# host tables and kernel modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("omega", [1, 2, 3])
@pytest.mark.parametrize("log_q", [90, 120, 150, 218])
def test_ks_group_conv_tables_match_jax(log_q, omega):
    qs = jmake_params(JSecurity(poly_degree=8192, log_q=log_q, lambda_=0)).q_primes
    got = tcontext.ks_group_conv_tables(qs, omega)
    np.testing.assert_array_equal(got, jcontext.ks_group_conv_tables(qs, omega))
    assert got.shape == (len(qs), -(-len(qs) // omega), omega) and not got.flags.writeable


@pytest.mark.parametrize("batch", [None, 3])
def test_keyswitch_prereduced_matches_pallas(batch):
    qs = jmake_params(JSecurity(**_kw(120))).q_primes
    k, kd = len(qs), 2
    pt, tb = npal.build_pallas_tables(N, qs), tntt.build_tables(N, qs, "cpu")
    keys_t = _residues(qs, (kd, 2, N))
    if batch is None:
        d = _residues(qs, (kd, N))
        want = npal.keyswitch_fused(jnp.asarray(d), jnp.asarray(keys_t), pt,
                                    interpret=True, prereduced=True)
        got = ntt_cuda.keyswitch_fused(_t(d), _t(keys_t), tb, prereduced=True)
    else:
        d = _residues(qs, (kd, batch, N))
        want = npal.keyswitch_fused_batch(jnp.asarray(d), jnp.asarray(keys_t), pt,
                                          interpret=True, prereduced=True)
        got = ntt_cuda.keyswitch_fused_batch(_t(d), _t(keys_t), tb, prereduced=True)
        single = ntt_cuda.keyswitch_fused(_t(d[:, :, 1]), _t(keys_t), tb, prereduced=True)
        assert torch.equal(single, got[:, :, 1])
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want))
    with pytest.raises(ValueError, match="expected"):
        ntt_cuda.keyswitch_fused(_t(d[0]), _t(keys_t), tb, prereduced=True)
    assert k == 4


def test_grouped_digit_residues_match_jax(w):
    qs = w.tctx.params.q_primes
    for shape in ((N,), (3, N)):
        y = _residues(qs, shape)
        got = tbfv._grouped_digit_residues(w.tctx, _t(y))
        assert got.shape == (len(qs), w.kd, *shape)
        np.testing.assert_array_equal(
            convert.to_numpy(got), _np(J.grouped_digit_residues(w.jctx, jnp.asarray(y), 0)))


# ---------------------------------------------------------------------------
# the slice against fhe_tpu.scheme.bfv
# ---------------------------------------------------------------------------


def test_keys_match_jax(w):
    k = w.tctx.k
    assert w.trlk.data.shape == (w.kd, k, 2, N) and w.kd == 2
    np.testing.assert_array_equal(convert.to_numpy(w.trlk), _np(w.jrlk.data))
    for g in ELEMS:
        np.testing.assert_array_equal(convert.to_numpy(w.tgk.data[g]),
                                      _np(w.jgk.data[g]))
    # JAX keys carried across by convert are the same keys
    rlk = convert.relin_keys_from_numpy(_np(w.jrlk.data), device="cpu")
    gk = convert.galois_keys_from_numpy({g: _np(a) for g, a in w.jgk.data.items()},
                                        device="cpu")
    assert torch.equal(rlk.data, w.trlk.data) and torch.equal(gk.data[3], w.tgk.data[3])


def test_relinearize_and_multiply_match_jax(w):
    a, b = w.cts
    jm3 = J.multiply_no_relin(w.jctx, _jct(a), _jct(b))
    want = J.relinearize(w.jctx, jm3, w.jrlk)
    m3 = tbfv.multiply_no_relin(w.tctx, a, b)
    assert_ct_equal(m3, jm3)
    assert_ct_equal(tbfv.relinearize(w.tctx, m3, w.trlk), want)
    prod = w.fhe.multiply(a, b, w.trlk)
    assert_ct_equal(prod, want)
    assert _decode(w, prod)[:4] == [15, 60, 135, 240]


def test_multiply_batch_matches_jax(w):
    """On a use_pallas=False context bfv.multiply_batch is the single
    multiply, relinearize(multiply_no_relin), per pair: compared so, it
    reuses the references compiled above."""
    a, b = w.cts
    got = tbfv.multiply_batch(w.tctx, [a, b], [b, b], w.trlk)
    want = [J.relinearize(w.jctx, J.multiply_no_relin(w.jctx, _jct(x), _jct(b)), w.jrlk)
            for x in (a, b)]
    for gi, wi in zip(got, want):
        assert_ct_equal(gi, wi)
    assert torch.equal(got[0].data, tbfv.multiply(w.tctx, a, b, w.trlk).data)
    assert _decode(w, got[1])[:4] == [9, 36, 81, 144]


def test_key_switch_matches_jax(w):
    want = J.key_switch(w.jctx, _jct(w.cts[0]), w.jgk.data[9])
    assert_ct_equal(tbfv.key_switch(w.tctx, w.cts[0], w.tgk.data[9]), want)


def test_rotate_rows_matches_jax(w):
    got = w.fhe.rotate_rows(w.cts[0], 3, w.tgk)
    assert_ct_equal(got, J.rotate_rows(w.jctx, _jct(w.cts[0]), 3, w.jgk))
    assert _decode(w, got)[:2] == [20, 0]


def test_apply_galois_batch_matches_jax(w):
    got = tbfv.apply_galois_batch(w.tctx, w.cts, 3, w.tgk)
    want = J.apply_galois_batch(w.jctx, [_jct(c) for c in w.cts], 3, w.jgk)
    for gi, wi, ct in zip(got, want, w.cts):
        assert_ct_equal(gi, wi)
        assert torch.equal(gi.data, tbfv.apply_galois(w.tctx, ct, 3, w.tgk).data)


def test_apply_galois_hoisted_matches_jax(w):
    got = tbfv.apply_galois_hoisted(w.tctx, w.cts[1], ELEMS, w.tgk)
    want = J.apply_galois_hoisted(w.jctx, _jct(w.cts[1]), ELEMS, w.jgk)
    for s, (gi, wi) in enumerate(zip(got, want), start=1):
        assert_ct_equal(gi, wi)
        assert _decode(w, gi) == _decode(w, w.fhe.rotate_rows(w.cts[1], s, w.tgk))
    batch = w.fhe.rotate_rows_hoisted_batch(w.cts, (1, 2), w.tgk)
    assert all(torch.equal(x.data, y.data) for x, y in zip(batch[1], got))


def test_apply_galois_hoisted_sum_matches_jax(w):
    """A sum_slots stage on the grouped digits of ks_omega = 2 (prereduced
    per-prime residues, transformed): ct + both rotations, bit for bit."""
    ct = w.cts[0]
    got = tbfv.apply_galois_hoisted_sum(w.tctx, ct, ELEMS, w.tgk)
    assert_ct_equal(got, J.apply_galois_hoisted_sum(w.jctx, _jct(ct), ELEMS, w.jgk))
    # slot j of the sum is v[j] + v[j+1] + v[j+2]
    assert _decode(w, got)[:2] == [5 + 10 + 15, 10 + 15 + 20]
