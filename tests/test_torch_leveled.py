"""Leveled BFV and the n < 1024 multiply, held bit for bit against the JAX package.

Kernel modules: the plain twins of tensor_product's Lift lane and of
fast_floor_fused (the port's wrappers on CPU tensors) against
ntt_pallas.tensor_product on the level's q base, rns_pallas.sm_mrq_fused
followed by ntt_pallas.tensor_product on its Bsk base, and
rns_pallas.fast_floor_fused, in interpreter mode with
the level-0, level-1 and level-2 constants; mod_switch_drop_last against
fhe_tpu.ops.rns's.
tests/test_torch_cuda.py holds the CUDA kernels against the same plain
versions on the card.

The slice at tests/test_leveled.py's configuration, n = 256, log_q = 150
(k = 5), h = 32: mod_switch_to_next, mod_switch_to_level, modulus_raise,
decrypt at every level, and switch_relin_keys and switch_galois_keys at
levels 1 and 2, against fhe_tpu.scheme.bfv, jitted, on a use_pallas=False
context (which tests/test_pallas.py pins equal to the Pallas path; the
ops at a level are in tests/test_torch_leveled_ops.py, which shares this
file's state); ks_omega = 2 at k = 6, where level 2 has keys and level 1
raises (at k = 6: with k = 4, the one gadget group of level 2 spans all of
q_L and its key-switch noise leaves no budget).  Keys and ciphertexts come from the port's *_from_noise entry points
with numpy draws and are carried to the JAX package as arrays.  Then the
FHE facade on the CPU replays tests/test_leveled.py's BFV scenarios,
per-level key cache included.

Residues are compared with tolerance 0; the noise budget, which the JAX
package carries in float32, to 1e-4 bits."""

import dataclasses
import gc

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.ops import rns as jrns
from fhe_tpu.ops import rns_pallas as rpal
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import ntt_cuda
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.ops import rns_cuda
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.types import Ciphertext

N = 256
KW = dict(poly_degree=N, log_q=150, hamming_weight=32)           # k = 5
ELEMENTS = (3, 2 * N - 1)                 # rotate_rows by 1, rotate_columns
VALS = {"a": [5, 10, 15, 20], "b": [3, 6, 9, 12], "x": [2, 3], "y": [5, 7],
        "z": [11, 13]}
PRODUCT = [15, 60, 135, 240]
RNG = np.random.default_rng(20261021)

# the JAX references, jitted once
J = dataclasses.make_dataclass("J", [
    "decrypt", "mod_switch_to_next", "modulus_raise", "switch_relin_keys",
    "switch_galois_keys", "multiply_no_relin", "relinearize", "multiply",
    "multiply_batch", "multiply_plain", "add_plain", "rotate_rows",
    "rotate_columns"])(
    jax.jit(jbfv.decrypt),
    jax.jit(jbfv.mod_switch_to_next),
    jax.jit(jbfv.modulus_raise),
    jax.jit(jbfv.switch_relin_keys, static_argnums=2),
    jax.jit(jbfv.switch_galois_keys, static_argnums=2),
    jax.jit(jbfv.multiply_no_relin),
    jax.jit(jbfv.relinearize),
    jax.jit(jbfv.multiply),
    jax.jit(jbfv.multiply_batch),
    jax.jit(jbfv.multiply_plain),
    jax.jit(jbfv.add_plain),
    jax.jit(jbfv.rotate_rows, static_argnums=2),
    jax.jit(jbfv.rotate_columns))


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


def torch_equal(x, y):
    return np.array_equal(convert.to_numpy(x), convert.to_numpy(y))


def _keys_from_noise(fhe: FHE, kw: dict):
    """The port's keys from numpy draws and the same keys as JAX values:
    (pk, sk, rlk, Galois keys for ELEMENTS, jsk, jrlk, jgk)."""
    tctx, qs, k = fhe.ctx, fhe.params.q_primes, fhe.params.k
    kd = -(-k // fhe.params.security.ks_omega)
    pk, sk = tbfv.keygen_from_noise(tctx, _t(_ternary(qs, N, kw["hamming_weight"])),
                                    _t(_residues(qs, (1, N))), _t(_small(qs, (1, N))))
    draws = lambda: (_t(_residues(qs, (kd, 1, N)).transpose(1, 0, 2, 3)),
                     _t(_small(qs, (kd, 1, N)).transpose(1, 0, 2, 3)))
    rlk = tbfv.relinkey_gen_from_noise(tctx, sk, *draws())
    gal = [draws() for _ in ELEMENTS]
    gk = tbfv.galoiskey_gen_from_noise(tctx, sk, ELEMENTS,
                                       _t(np.stack([a for a, _ in gal])),
                                       _t(np.stack([e for _, e in gal])))
    jsk = jtypes.SecretKey(data=jnp.asarray(convert.to_numpy(sk)))
    jrlk = jtypes.RelinKeys(data=jnp.asarray(convert.to_numpy(rlk)))
    jgk = jtypes.GaloisKeys(data={g: jnp.asarray(convert.to_numpy(v))
                                  for g, v in gk.data.items()})
    return pk, sk, rlk, gk, jsk, jrlk, jgk


@pytest.fixture(scope="module")
def s():
    """The JAX context and the port's facade at n = 256, k = 5; keys from
    numpy draws; fresh ciphertexts of VALS at level 0 and the a, b pair
    switched down to levels 1 and 2 by each package."""
    jctx = jcontext.make_context(jmake_params(JSecurity(**KW)), use_pallas=False,
                                 use_mxu=False)
    jcontext.galois_fold_tables.cache_clear()   # filled outside any trace
    for g in ELEMENTS:
        jcontext.galois_fold_tables(N, g)
    fhe = FHE(device="cpu", seed=0, **KW)
    tctx, qs = fhe.ctx, fhe.params.q_primes
    pk, sk, rlk, gk, jsk, jrlk, jgk = _keys_from_noise(fhe, KW)
    cts = {name: tbfv.encrypt_from_noise(
        tctx, pk, fhe.encode(v), _t(_ternary(qs, N, 32)), _t(_small(qs, (1, N))),
        _t(_small(qs, (1, N)))) for name, v in VALS.items()}
    levels = {0: (cts["a"], cts["b"])}
    jlevels = {0: (_jct(cts["a"]), _jct(cts["b"]))}
    for lv in (1, 2):
        levels[lv] = tuple(tbfv.mod_switch_to_next(tctx, c) for c in levels[lv - 1])
        jlevels[lv] = tuple(J.mod_switch_to_next(jctx, c) for c in jlevels[lv - 1])
    return dataclasses.make_dataclass("S", [
        "jctx", "fhe", "tctx", "pk", "sk", "rlk", "gk", "jsk", "jrlk", "jgk", "cts",
        "levels", "jlevels"])(
        jctx, fhe, tctx, pk, sk, rlk, gk, jsk, jrlk, jgk, cts, levels, jlevels)


def _dec(s, ct, m=4):
    return [int(v) for v in s.fhe.decode(tbfv.decrypt(s.tctx, ct, s.sk))[:m]]


# ---------------------------------------------------------------------------
# kernel modules and the modulus switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 1, 2])
def test_sm_mrq_and_fast_floor_match_pallas(s, level):
    """The n < 1024 multiply's products in q and, of the lifts, in Bsk (one
    launch on the card: tensor_product's Lift lane) and its floor, with the
    level's constants."""
    k = 5 - level
    prm = s.jctx.params
    qs = prm.q_primes[:k]
    tq, tbsk = s.tctx.mul_levels[level]
    bsk = tbsk.primes
    assert len(bsk) == s.jctx.bsk_counts[level]
    tq_pl, tbsk_pl = npal.build_mul_tables(N, prm.q_primes, prm.bsk_primes, prm.t, k,
                                           len(bsk))
    x, y = _residues(qs, (2, N)), _residues(qs, (2, N))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    lift = rpal.sm_mrq_fused(jnp.concatenate([jx, jy], axis=1), s.jctx.smq_levels[level],
                             interpret=True)
    got_q, got = ntt_cuda.tensor_product(_t(x), _t(y), tq,
                                         lift=(s.tctx.smq_levels[level], tbsk))
    np.testing.assert_array_equal(
        convert.to_numpy(got_q), np.asarray(npal.tensor_product(jx, jy, tq_pl, interpret=True)))
    np.testing.assert_array_equal(
        convert.to_numpy(got),
        np.asarray(npal.tensor_product(lift[:, :2], lift[:, 2:], tbsk_pl, interpret=True)))
    assert got.shape == (len(bsk), 3, N)
    tx_q, tx_bsk = _residues(qs, (3, N)), _residues(bsk, (3, N))
    want = np.asarray(rpal.fast_floor_fused(jnp.asarray(tx_q), jnp.asarray(tx_bsk),
                                            s.jctx.floor_levels[level], interpret=True))
    got = rns_cuda.fast_floor_fused(_t(tx_q), _t(tx_bsk), s.tctx.floor_levels[level])
    np.testing.assert_array_equal(convert.to_numpy(got), want)


@pytest.mark.parametrize("level", [0, 1, 3])
def test_mod_switch_drop_last_matches_jax(s, level):
    chain = s.fhe.params.q_primes[:5 - level]
    x = _residues(chain, (2, N))
    want = jax.jit(jrns.mod_switch_drop_last)(jnp.asarray(x), s.jctx.mod_switch[level])
    got = trns.mod_switch_drop_last(_t(x), s.tctx.mod_switch[level])
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want))
    assert got.shape == (4 - level, 2, N)


def test_mod_switch_to_next_and_level_match_jax(s):
    for lv in (1, 2):
        for got, want in zip(s.levels[lv], s.jlevels[lv]):
            assert_ct_equal(got, want)
    assert _dec(s, s.levels[2][0]) == VALS["a"]
    # mod_switch_to_level: a fresh ciphertext to level 4, the last one
    got = tbfv.mod_switch_to_level(s.tctx, s.cts["x"], 4)
    want = _jct(s.cts["x"])
    for _ in range(4):
        want = J.mod_switch_to_next(s.jctx, want)
    assert_ct_equal(got, want)
    assert _dec(s, got, 2) == VALS["x"] and got.data.shape == (1, 2, N)
    assert tbfv.mod_switch_to_level(s.tctx, got, 2) is got
    with pytest.raises(ValueError, match="last level"):
        tbfv.mod_switch_to_next(s.tctx, got)
    # an NTT-form ciphertext switches from the coefficient domain
    ntt = tbfv.mod_switch_to_next(s.tctx, tbfv.to_ntt(s.tctx, s.cts["a"]))
    assert_ct_equal(ntt, s.jlevels[1][0])


def test_modulus_raise_matches_jax(s):
    for ct, jct in zip(s.levels[2], s.jlevels[2]):
        got = tbfv.modulus_raise(s.tctx, ct)
        assert_ct_equal(got, J.modulus_raise(s.jctx, jct))
        assert got.level == 0 and got.data.shape == (5, 2, N)
    assert tbfv.modulus_raise(s.tctx, s.cts["a"]) is s.cts["a"]


def test_decrypt_at_every_level_matches_jax(s):
    """B8 down to one prime: decrypt of a ciphertext at each level."""
    ct, jct = s.cts["a"], _jct(s.cts["a"])
    for level in range(5):
        got = tbfv.decrypt(s.tctx, ct, s.sk)
        np.testing.assert_array_equal(convert.to_numpy(got),
                                      _np(J.decrypt(s.jctx, jct, s.jsk).data))
        assert [int(v) for v in s.fhe.decode(got)[:4]] == VALS["a"]
        if level < 4:
            ct, jct = tbfv.mod_switch_to_next(s.tctx, ct), J.mod_switch_to_next(s.jctx, jct)


# ---------------------------------------------------------------------------
# key down-switching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 2])
def test_switch_keys_match_jax(s, level):
    got = tbfv.switch_relin_keys(s.tctx, s.rlk, level)
    want = J.switch_relin_keys(s.jctx, s.jrlk, level)
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.data.shape == (5 - level, 5 - level, 2, N)
    got = tbfv.switch_galois_keys(s.tctx, s.gk, level)
    want = J.switch_galois_keys(s.jctx, s.jgk, level)
    assert set(got.data) == set(ELEMENTS)
    for g in ELEMENTS:
        np.testing.assert_array_equal(convert.to_numpy(got.data[g]), _np(want.data[g]))
    assert tbfv.switch_relin_keys(s.tctx, s.rlk, 0).data is s.rlk.data


def test_omega_two_levels_match_jax():
    """ks_omega = 2 at k = 6: level 2 (four primes, two gadget groups) has
    keys and multiplies as JAX does; level 1 (five primes) raises JAX's
    error."""
    kw = dict(poly_degree=N, log_q=180, hamming_weight=16, ks_omega=2)
    jctx = jcontext.make_context(jmake_params(JSecurity(**kw)), use_pallas=False,
                                 use_mxu=False)
    fhe = FHE(device="cpu", seed=0, **kw)
    pk, sk, rlk, _, jsk, jrlk, _ = _keys_from_noise(fhe, kw)
    qs = fhe.params.q_primes
    fresh = [tbfv.encrypt_from_noise(fhe.ctx, pk, fhe.encode(v), _t(_ternary(qs, N, 16)),
                                     _t(_small(qs, (1, N))), _t(_small(qs, (1, N))))
             for v in (VALS["a"], VALS["b"])]
    a, b = (fhe.mod_switch_to_level(c, 2) for c in fresh)
    got = tbfv.switch_relin_keys(fhe.ctx, rlk, 2)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  _np(J.switch_relin_keys(jctx, jrlk, 2).data))
    assert got.data.shape == (2, 4, 2, N)
    prod = fhe.multiply(a, b, rlk)
    assert_ct_equal(prod, J.multiply(jctx, _jct(a), _jct(b), jrlk))
    assert [int(v) for v in fhe.decode(fhe.decrypt(prod, sk))[:4]] == PRODUCT
    with pytest.raises(ValueError, match="not a whole number of gadget groups"):
        tbfv.switch_relin_keys(fhe.ctx, rlk, 1)
    a1 = fhe.mod_switch_to_next(fresh[0])
    with pytest.raises(ValueError, match="not a whole number of gadget groups"):
        fhe.multiply(a1, a1, rlk)


# ---------------------------------------------------------------------------
# the facade: tests/test_leveled.py's BFV scenarios on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f():
    fhe = FHE(device="cpu", seed=13, **KW)
    pk, sk = fhe.keygen()
    return fhe, pk, sk, fhe.relinkey_gen(sk)


def _fdec(fhe, sk, ct, m):
    return [int(v) for v in fhe.decode(fhe.decrypt(ct, sk))[:m]]


def test_facade_multiply_at_levels_one_and_two(f):
    fhe, pk, sk, rlk = f
    ct1 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode(VALS["a"]), pk))
    ct2 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode(VALS["b"]), pk))
    assert ct1.level == 1
    prod = fhe.multiply(ct1, ct2, rlk)
    assert prod.level == 1 and _fdec(fhe, sk, prod, 4) == PRODUCT
    c1 = fhe.mod_switch_to_level(fhe.encrypt(fhe.encode([7, 2]), pk), 2)
    c2 = fhe.mod_switch_to_level(fhe.encrypt(fhe.encode([4, 5]), pk), 2)
    assert _fdec(fhe, sk, fhe.multiply(c1, c2, rlk), 2) == [28, 10]
    assert _fdec(fhe, sk, fhe.relinearize(fhe.multiply_no_relin(c1, c2), rlk), 2) == [28, 10]
    assert [_fdec(fhe, sk, c, 2) for c in fhe.multiply_batch([c1, c2], [c2, c2], rlk)] == \
        [[28, 10], [16, 25]]


def test_facade_depth_two_circuit_and_plain_ops(f):
    fhe, pk, sk, rlk = f
    a, b, c = (fhe.encrypt(fhe.encode(VALS[x]), pk) for x in "xyz")
    ab = fhe.mod_switch_to_next(fhe.multiply(a, b, rlk))
    assert _fdec(fhe, sk, fhe.multiply(ab, fhe.mod_switch_to_next(c), rlk), 2) == [110, 273]
    ct = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([10, 20, 30]), pk))
    pt = fhe.encode([4, 4, 4])
    assert _fdec(fhe, sk, fhe.add_plain(ct, pt), 3) == [14, 24, 34]
    assert _fdec(fhe, sk, fhe.sub_plain(ct, pt), 3) == [6, 16, 26]
    assert _fdec(fhe, sk, fhe.multiply_plain(ct, pt), 3) == [40, 80, 120]
    assert _fdec(fhe, sk, fhe.multiply_plain(ct, pt, cache_operand=True), 3) == [40, 80, 120]
    assert (id(pt), 1) in fhe._plain_ntt_cache


def test_facade_rotation_at_level_and_refresh(f):
    fhe, pk, sk, rlk = f
    gal = fhe.galoiskey_gen(sk)
    half = fhe.params.slot_count
    vals = list(range(1, half + 1))
    ct = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode(vals), pk))
    assert _fdec(fhe, sk, fhe.rotate_rows(ct, 1, gal), half) == vals[1:] + vals[:1]
    assert (id(gal), 1) in fhe._gal_cache
    cached = fhe._gal_cache[(id(gal), 1)]
    assert all(torch_equal(cached.data[g], tbfv.switch_galois_keys(fhe.ctx, gal, 1).data[g])
               for g in (3, 2 * N - 1))
    assert _fdec(fhe, sk, fhe.rotate_columns(ct, gal), half) == [0] * half
    assert [_fdec(fhe, sk, c, 2) for c in fhe.rotate_rows_batch([ct, ct], 2, gal)] == \
        [[3, 4], [3, 4]]
    deep = fhe.mod_switch_to_level(ct, 3)
    fresh = fhe.bootstrap(deep, sk, pk)
    assert fresh.level == 0 and fresh.noise_budget > deep.noise_budget
    assert _fdec(fhe, sk, fresh, 4) == [1, 2, 3, 4]


def test_facade_relin_key_cache(f):
    """Cached down-switched keys give the bits of on-the-fly switching;
    the cache holds one entry per (rlk, level) and drops it with the keys."""
    fhe, pk, sk, rlk = f
    ct1 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([5, 6]), pk))
    ct2 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([7, 8]), pk))
    via_cache = fhe.multiply(ct1, ct2, rlk)
    assert torch_equal(via_cache, tbfv.multiply(fhe.ctx, ct1, ct2, rlk))
    cached = fhe._rlk_cache[(id(rlk), 1)]
    assert torch_equal(cached, tbfv.switch_relin_keys(fhe.ctx, rlk, 1))
    fhe.multiply(ct1, ct2, rlk)
    assert fhe._rlk_cache[(id(rlk), 1)] is cached
    other = fhe.relinkey_gen(sk)
    fhe.multiply(ct1, ct2, other)
    kid = id(other)
    assert (kid, 1) in fhe._rlk_cache
    del other
    gc.collect()
    assert (kid, 1) not in fhe._rlk_cache and (id(rlk), 1) in fhe._rlk_cache
