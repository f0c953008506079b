"""Galois rotations and key switching, held bit for bit against the JAX package.

Kernel modules: the port's automorphism wrappers on CPU tensors (their
plain PyTorch versions) against galois_pallas.automorphism_fused in
interpreter mode, in each of its three lanes (no c0, a shared c0, a c0 per
element), and against galois_pallas.automorphism_single; both also against
the gather tables of context.galois_permutation.  The host tables
(galois_permutation, galois_perm_tables, default_galois_elements) against
fhe_tpu.scheme.context's.  tests/test_torch_cuda.py holds the CUDA kernel
against the same plain version on the card.

The slice: galoiskey_gen_from_noise, key_switch, apply_galois, rotate_rows,
rotate_columns, apply_galois_batch and rotate_rows_batch against
fhe_tpu.scheme.bfv on a use_pallas=False context, with the JAX draws
re-derived from the same key splits (split per element, then
bfv._keyswitch_keygen's split(3) per digit; fold_in(key, i) and split(3)
per ciphertext, as bfv.encrypt_batch).  Element i of every batch op also
equals the single op, JAX keys carried across by convert rotate the same,
and a JAX ciphertext rotated in the port decrypts right.

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

from fhe_tpu.ops import galois_pallas as gp
from fhe_tpu.ops import sampling as jsampling
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme.encoder import BatchEncoder as JEncoder

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import galois_cuda
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import context as tcontext
from fhe_tpu_torch.scheme.encoder import BatchEncoder
from fhe_tpu_torch.scheme.types import GaloisKeys

KW = dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0)
N = 1024
B = 3
# row rotation by 1 and by 4 (so 5 = 1 + 4 needs both), and the column swap
ELEMENTS = (3, pow(3, 4, 2 * N), 2 * N - 1)
VALS = ([5, 10, 15, 20, 25], [1, 2, 3, 4, 5], [9, 8, 7, 6, 5])
RNG = np.random.default_rng(20261018)

_ternary = jax.jit(jsampling.ternary_rns, static_argnums=(2, 3, 4))
_uniform = jax.jit(jsampling.uniform_rns, static_argnums=(3, 4))
_gaussian = jax.jit(jsampling.gaussian_rns, static_argnums=(2, 3, 4))

# the JAX references, jitted once (eager JAX costs minutes at n = 1024)
J = dataclasses.make_dataclass("J", ["keygen", "galoiskey_gen", "encrypt_batch",
                                     "decrypt", "key_switch", "apply_galois",
                                     "rotate_rows", "rotate_columns",
                                     "apply_galois_batch", "rotate_rows_batch"])(
    jax.jit(jbfv.keygen),
    jax.jit(jbfv.galoiskey_gen, static_argnames=("elements",)),
    jax.jit(jbfv.encrypt_batch),
    jax.jit(jbfv.decrypt),
    jax.jit(jbfv.key_switch),
    jax.jit(jbfv.apply_galois, static_argnums=2),
    jax.jit(jbfv.rotate_rows, static_argnums=2),
    jax.jit(jbfv.rotate_columns),
    jax.jit(jbfv.apply_galois_batch, static_argnums=2),
    jax.jit(jbfv.rotate_rows_batch, static_argnums=2))


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


def _rotated(vals, steps, half=N // 2):
    row = list(vals) + [0] * (half - len(vals))
    return row[steps:] + row[:steps]


@pytest.fixture(scope="module")
def r():
    """JAX reference state and the port's, from the same draws: keys, Galois
    keys for ELEMENTS and B encryptions of VALS."""
    jp = jmake_params(JSecurity(**KW))
    jctx = jcontext.make_context(jp, use_pallas=False, use_mxu=False)
    tctx = tcontext.make_context(make_scheme_params(SecurityParams(**KW)), device="cpu")
    # galois_fold_tables caches the arrays of its first call; made under a
    # jit trace they are tracers that leak into the next trace, so the cache
    # is filled here, outside any trace
    jcontext.galois_fold_tables.cache_clear()
    for g in ELEMENTS:
        jcontext.galois_fold_tables(N, g)
    tb = jctx.ntt_q
    n, h, sig = jp.n, jp.security.hamming_weight, jp.security.sigma
    k_key, k_gal, k_enc = jrandom.split(jrandom.PRNGKey(41), 3)

    jpk, jsk = J.keygen(jctx, k_key)
    k_s, k_a, k_e = jrandom.split(k_key, 3)
    tpk, tsk = tbfv.keygen_from_noise(
        tctx, _t(_ternary(k_s, tb.p, 1, n, h)), _t(_uniform(k_a, tb.p, tb.mu, 1, n)),
        _t(_gaussian(k_e, tb.p, sig, 1, n)))

    jgk = J.galoiskey_gen(jctx, k_gal, jsk, elements=ELEMENTS)
    key, draws_a, draws_e = k_gal, [], []
    for _ in ELEMENTS:                    # bfv.galoiskey_gen's splits
        key, sub = jrandom.split(key)
        da, de = [], []
        for _ in range(jp.k):             # bfv._keyswitch_keygen's splits
            sub, kk_a, kk_e = jrandom.split(sub, 3)
            da.append(_uniform(kk_a, tb.p, tb.mu, 1, n))
            de.append(_gaussian(kk_e, tb.p, sig, 1, n))
        draws_a.append(np.stack(da))
        draws_e.append(np.stack(de))
    tgk = tbfv.galoiskey_gen_from_noise(tctx, tsk, ELEMENTS, _t(np.stack(draws_a)),
                                        _t(np.stack(draws_e)))

    jenc, tenc = JEncoder(jp), BatchEncoder(tctx.params, "cpu")
    jcts = J.encrypt_batch(jctx, k_enc, jpk, [jenc.encode(v) for v in VALS])
    cols = []
    for i in range(B):                    # bfv.encrypt_batch's derivation
        ku, k1, k2 = jrandom.split(jrandom.fold_in(k_enc, i), 3)
        cols.append((_ternary(ku, tb.p, 1, n, h), _gaussian(k1, tb.p, sig, 1, n),
                     _gaussian(k2, tb.p, sig, 1, n)))
    tcts = tbfv.encrypt_batch_from_noise(
        tctx, tpk, [tenc.encode(v) for v in VALS],
        *(_t(np.concatenate([c[j] for c in cols], axis=1)) for j in range(3)))
    for got, want in zip(tcts, jcts):
        assert_ct_equal(got, want)
    return dataclasses.make_dataclass("R", [
        "jctx", "tctx", "jsk", "tsk", "jgk", "tgk", "tenc", "jcts", "tcts"])(
        jctx, tctx, jsk, tsk, jgk, tgk, tenc, jcts, tcts)


def _decode(r, ct):
    return [int(x) for x in r.tenc.decode(tbfv.decrypt(r.tctx, ct, r.tsk))]


# ---------------------------------------------------------------------------
# host tables and kernel modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 1024, 8192])
def test_galois_tables_match_jax(n):
    elements = tcontext.default_galois_elements(n)
    assert elements == jcontext.default_galois_elements(n)
    if n == 8192:
        # 3^(±2^i) for 2^i < n/2 and 2n - 1, less one: 3^(n/4) = 3^(-n/4)
        # mod 2n, since 3 has order n/2
        assert len(elements) == 24 and elements[-1] == 2 * n - 1
    for g in (3, 2 * n - 1, elements[-2]):
        want = jcontext.galois_permutation(n, g)
        for got in (tcontext.galois_permutation(n, g), tcontext.galois_perm_tables(n, g)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="odd"):
        tcontext.galois_permutation(n, 4)


def _by_tables(x, hs, p):
    """Reference: the gather tables of galois_permutation, one element at a
    time, with neg(0) = 0."""
    out = np.empty_like(x)
    for b, h in enumerate(hs):
        src, neg = tcontext.galois_perm_tables(x.shape[-1], pow(h, -1, 2 * x.shape[-1]))
        g = x[:, :, b][..., src].astype(np.int64)
        pc = p.astype(np.int64)[:, None, None]
        out[:, :, b] = np.where(neg, (pc - g) % pc, g)
    return out


@pytest.mark.parametrize("lane", ["none", "shared", "per_element"])
def test_automorphism_matches_pallas(lane):
    prm = jmake_params(JSecurity(**KW))
    qs = prm.q_primes
    p = np.array(qs, dtype=np.uint32)
    hs = tuple(pow(g, -1, 2 * N) for g in ELEMENTS)
    x = _residues(qs, (2, B, N))
    x[:, :, :, :4] = 0                    # neg(0) must stay 0
    c0 = {"none": None, "shared": _residues(qs, (N,)),
          "per_element": _residues(qs, (B, N))}[lane]
    want = np.asarray(gp.automorphism_fused(
        jnp.asarray(x), hs, jnp.asarray(p), None if c0 is None else jnp.asarray(c0),
        interpret=True))
    tp = _t(p)
    tc0 = None if c0 is None else _t(c0)
    got = galois_cuda.automorphism_fused(_t(x), hs, tp, tc0)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # x as a view of a [B, k, 2, n] stack
    view = _t(x.transpose(2, 0, 1, 3).copy()).permute(1, 2, 0, 3)
    np.testing.assert_array_equal(
        convert.to_numpy(galois_cuda.automorphism_fused(view, hs, tp, tc0)), want)
    # c0 is added before the permutation
    xc = x.copy()
    if c0 is not None:
        xc[:, 0] = (x[:, 0].astype(np.int64) + (c0[:, None] if c0.ndim == 2 else c0)
                    ) % p.astype(np.int64)[:, None, None]
    np.testing.assert_array_equal(_by_tables(xc, hs, p), want)


def test_automorphism_single_matches_pallas():
    prm = jmake_params(JSecurity(**KW))
    p = np.array(prm.q_primes, dtype=np.uint32)
    x = _residues(prm.q_primes, (2, N))
    for g in (3, 2 * N - 1, 12345):
        want = np.asarray(gp.automorphism_single(jnp.asarray(x), g, 2 * N,
                                                 jnp.asarray(p), interpret=True))
        got = galois_cuda.automorphism_single(_t(x), g, _t(p))
        np.testing.assert_array_equal(convert.to_numpy(got), want)
    with pytest.raises(ValueError):
        galois_cuda.automorphism_single(_t(x), 2, _t(p))


# ---------------------------------------------------------------------------
# the slice against fhe_tpu.scheme.bfv
# ---------------------------------------------------------------------------


def test_galoiskey_gen_matches_jax(r):
    assert set(r.tgk.data) == set(ELEMENTS)
    for g in ELEMENTS:
        np.testing.assert_array_equal(convert.to_numpy(r.tgk.data[g]),
                                      _np(r.jgk.data[g]))
        assert r.tgk.data[g].shape == (3, 3, 2, N)


def test_key_switch_matches_jax(r):
    g = ELEMENTS[1]
    want = J.key_switch(r.jctx, r.jcts[0], r.jgk.data[g])
    got = tbfv.key_switch(r.tctx, r.tcts[0], r.tgk.data[g])
    assert_ct_equal(got, want)


@pytest.mark.parametrize("g", [ELEMENTS[0], ELEMENTS[2]])
def test_apply_galois_matches_jax(r, g):
    got = tbfv.apply_galois(r.tctx, r.tcts[0], g, r.tgk)
    assert_ct_equal(got, J.apply_galois(r.jctx, r.jcts[0], g, r.jgk))
    assert got.noise_budget < r.tcts[0].noise_budget


@pytest.mark.parametrize("steps", [1, 5])
def test_rotate_rows_matches_jax(r, steps):
    got = tbfv.rotate_rows(r.tctx, r.tcts[0], steps, r.tgk)
    assert_ct_equal(got, J.rotate_rows(r.jctx, r.jcts[0], steps, r.jgk))
    assert _decode(r, got)[:N // 2] == _rotated(VALS[0], steps)


def test_rotate_columns_matches_jax(r):
    got = tbfv.rotate_columns(r.tctx, r.tcts[0], r.tgk)
    assert_ct_equal(got, J.rotate_columns(r.jctx, r.jcts[0], r.jgk))
    slots = _decode(r, got)
    assert slots[N // 2:N // 2 + 5] == VALS[0] and slots[:5] == [0] * 5


def test_apply_galois_batch_matches_jax(r):
    g = ELEMENTS[2]
    got = tbfv.apply_galois_batch(r.tctx, r.tcts, g, r.tgk)
    want = J.apply_galois_batch(r.jctx, r.jcts, g, r.jgk)
    for i, (gi, wi) in enumerate(zip(got, want)):
        assert_ct_equal(gi, wi)
        single = tbfv.apply_galois(r.tctx, r.tcts[i], g, r.tgk)
        assert torch.equal(single.data, gi.data)
        assert single.noise_budget == gi.noise_budget


def test_rotate_rows_batch_matches_jax(r):
    got = tbfv.rotate_rows_batch(r.tctx, r.tcts, 5, r.tgk)
    want = J.rotate_rows_batch(r.jctx, r.jcts, 5, r.jgk)
    for i, (gi, wi) in enumerate(zip(got, want)):
        assert_ct_equal(gi, wi)
        assert torch.equal(gi.data, tbfv.rotate_rows(r.tctx, r.tcts[i], 5, r.tgk).data)
        assert _decode(r, gi)[:N // 2] == _rotated(VALS[i], 5)
    assert tbfv.rotate_rows_batch(r.tctx, r.tcts, N // 2, r.tgk) is r.tcts


def test_jax_keys_and_ciphertexts_cross_to_port(r):
    """JAX Galois keys carried across by convert rotate the same in the
    port, and a JAX ciphertext rotated in the port decrypts right."""
    gk = convert.galois_keys_from_numpy({g: _np(a) for g, a in r.jgk.data.items()},
                                        device="cpu")
    assert isinstance(gk, GaloisKeys)
    rot = tbfv.rotate_rows(r.tctx, r.tcts[1], 1, gk)
    assert torch.equal(rot.data, tbfv.rotate_rows(r.tctx, r.tcts[1], 1, r.tgk).data)
    jct = r.jcts[2]
    ct = convert.ciphertext_from_numpy(_np(jct.data), noise_budget=float(jct.noise_budget),
                                       device="cpu")
    got = tbfv.rotate_rows(r.tctx, ct, 1, gk)
    assert_ct_equal(got, J.rotate_rows(r.jctx, jct, 1, r.jgk))
    assert _decode(r, got)[:N // 2] == _rotated(VALS[2], 1)
    np.testing.assert_array_equal(
        convert.to_numpy(tbfv.decrypt(r.tctx, got, r.tsk)),
        _np(J.decrypt(r.jctx, J.rotate_rows(r.jctx, jct, 1, r.jgk), r.jsk).data))


def test_facade_rotations_on_cpu():
    """The FHE facade with the port's own samplers and the default Galois
    elements of a small ring."""
    fhe = FHE(seed=8, device="cpu", poly_degree=256, log_q=60, hamming_weight=16,
              lambda_=0)
    pk, sk = fhe.keygen()
    gk = fhe.galoiskey_gen(sk)
    assert tuple(gk.data) == tcontext.default_galois_elements(256)
    ct = fhe.encrypt(fhe.encode([1, 2, 3, 4]), pk)
    dec = lambda c: [int(x) for x in fhe.decode(fhe.decrypt(c, sk))]
    assert dec(fhe.rotate_rows(ct, 3, gk))[:2] == [4, 0]
    assert dec(fhe.rotate_rows(ct, -1, gk))[:3] == [0, 1, 2]
    assert dec(fhe.rotate_columns(ct, gk))[128:132] == [1, 2, 3, 4]
    batch = fhe.rotate_rows_batch([ct, ct], 2, gk)
    assert [dec(c)[:2] for c in batch] == [[3, 4], [3, 4]]
    switched = fhe.key_switch(fhe.rotate_columns(ct, gk), gk.data[2 * 256 - 1])
    assert switched.num_components == 2


J_MOD_SWITCH = jax.jit(jbfv.mod_switch_to_next)
J_HOISTED = jax.jit(jbfv.apply_galois_hoisted, static_argnums=2)


def test_rotations_at_level_one_and_errors(r):
    """rotate_rows, apply_galois_batch, key_switch and apply_galois_hoisted
    at level 1 equal fhe_tpu's (each ciphertext switched down by its own
    package, the level-0 Galois keys switched down on the fly); a missing
    Galois key and keys of another gadget (ks_omega) raise."""
    deep = [tbfv.mod_switch_to_next(r.tctx, ct) for ct in r.tcts[:2]]
    jdeep = [J_MOD_SWITCH(r.jctx, ct) for ct in r.jcts[:2]]
    got = tbfv.rotate_rows(r.tctx, deep[0], 1, r.tgk)
    assert_ct_equal(got, J.rotate_rows(r.jctx, jdeep[0], 1, r.jgk))
    assert _decode(r, got)[:N // 2] == _rotated(VALS[0], 1)
    for got, want in zip(tbfv.apply_galois_batch(r.tctx, deep, 3, r.tgk),
                         J.apply_galois_batch(r.jctx, jdeep, 3, r.jgk)):
        assert_ct_equal(got, want)
    assert_ct_equal(tbfv.key_switch(r.tctx, deep[1], r.tgk.data[3]),
                    J.key_switch(r.jctx, jdeep[1], r.jgk.data[3]))
    (got,), (want,) = (tbfv.apply_galois_hoisted(r.tctx, deep[1], (3,), r.tgk),
                       J_HOISTED(r.jctx, jdeep[1], (3,), r.jgk))
    assert_ct_equal(got, want)
    assert _decode(r, got)[:N // 2] == _rotated(VALS[1], 1)
    with pytest.raises(KeyError, match="element"):
        tbfv.rotate_rows(r.tctx, r.tcts[0], 2, r.tgk)
    grouped = FHE(seed=1, device="cpu", ks_omega=2, **KW)
    _, sk = grouped.keygen()
    assert grouped.galoiskey_gen(sk, elements=(3,)).data[3].shape == (2, 3, 2, N)
    with pytest.raises(ValueError, match="keys"):
        grouped.rotate_rows(r.tcts[0], 1, r.tgk)
    with pytest.raises(KeyError, match="no galois key"):
        grouped.rotate_rows_hoisted(r.tcts[0], (1, 2), r.tgk)
