"""Hoisted rotations and sum_slots, held bit for bit against the JAX package.

Kernel modules: the port's wrappers on CPU tensors (their plain PyTorch
versions) against the Pallas kernels in interpreter mode, on the same
random residues: ntt_pallas.ks_inner_batch with a shared and with
per-element digit stacks, ntt_pallas.ks_inner_grouped at C = 2, E = 8 (the
grouped kernel, not its E % 8 fallback), galois_pallas.automorphism_fused_sum.
The host tables eval_perm / eval_perm_inv against bfv._eval_perm_host /
_eval_perm_inv_host.  tests/test_torch_cuda.py holds the CUDA kernels
against the same plain versions on the card.

The slice: hoisted_galois_keys, apply_galois_hoisted, apply_galois_hoisted_sum
and apply_galois_hoisted_batch (C = 2) against fhe_tpu.scheme.bfv, jitted,
on a use_pallas=False context, whose composed hoisted path
tests/test_pallas.py pins equal to the Pallas fast path; FHE.sum_slots
against the same stage sequence composed from fhe_tpu.scheme.bfv
functions; hoisted against sequential rotation by decryption only (the
hoisted digits carry -d representatives, so the bits differ by design).
Keys and ciphertexts come from the port's *_from_noise entry points with
numpy draws and are carried to the JAX package as arrays.

n = 1024, k = 3, h = 16, lambda_ = 0.  Residues are compared with
tolerance 0; the noise budget, which the JAX package carries in float32, to
1e-4 bits."""

import dataclasses
import gc

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fhe_tpu.ops import galois_pallas as gp
from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import galois_cuda, ntt_cuda
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme import context as tcontext
from fhe_tpu_torch.scheme.encoder import BatchEncoder
from fhe_tpu_torch.scheme.types import Ciphertext, GaloisKeys

KW = dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0)
N = 1024
STEPS = (1, 2, 3)
ELEMS = tuple(pow(3, s, 2 * N) for s in STEPS)
VALS = ([5, 10, 15, 20], [1, 2, 3, 4, 5, 6])
RNG = np.random.default_rng(20261019)

# the JAX references, jitted once (eager JAX costs minutes at n = 1024)
J = dataclasses.make_dataclass("J", [
    "hoisted_galois_keys", "apply_galois_hoisted", "apply_galois_hoisted_sum",
    "apply_galois_hoisted_batch", "rotate_rows", "rotate_columns", "add"])(
    jax.jit(jbfv.hoisted_galois_keys, static_argnums=2),
    jax.jit(jbfv.apply_galois_hoisted, static_argnums=2),
    jax.jit(jbfv.apply_galois_hoisted_sum, static_argnums=2),
    jax.jit(jbfv.apply_galois_hoisted_batch, static_argnums=2),
    jax.jit(jbfv.rotate_rows, static_argnums=2),
    jax.jit(jbfv.rotate_columns),
    jax.jit(jbfv.add))


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _residues(moduli, shape):
    return np.stack([RNG.integers(0, p, shape, dtype=np.uint32) for p in moduli])


def _small(moduli, shape, bound):
    """Residues of integers in [-bound, bound]: a stand-in for the error draws."""
    x = RNG.integers(-bound, bound + 1, shape)
    return np.stack([x % p for p in moduli]).astype(np.uint32)


def _ternary(moduli, n, h):
    s = np.zeros(n, dtype=np.int64)
    s[RNG.choice(n, h, replace=False)] = RNG.choice([-1, 1], h)
    return np.stack([(s % p)[None] for p in moduli]).astype(np.uint32)


def assert_ct_equal(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert got.level == want.level and got.is_ntt_form == want.is_ntt_form
    assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4


def _jct(ct: Ciphertext):
    return jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=ct.level,
                             is_ntt_form=ct.is_ntt_form, noise_budget=ct.noise_budget)


def _rotated(vals, steps, half=N // 2):
    row = list(vals) + [0] * (half - len(vals))
    return row[steps:] + row[:steps]


@pytest.fixture(scope="module")
def h():
    """The port's keys (sk, Galois keys for the sum_slots elements) and two
    ciphertexts of VALS, from numpy draws; the same keys and ciphertexts as
    JAX values, and the JAX context."""
    jctx = jcontext.make_context(jmake_params(JSecurity(**KW)), use_pallas=False,
                                 use_mxu=False)
    fhe = FHE(device="cpu", seed=0, **KW)
    tctx, qs = fhe.ctx, fhe.params.q_primes
    sig = lambda *shape: _t(_small(qs, shape, 6))
    pk, sk = tbfv.keygen_from_noise(tctx, _t(_ternary(qs, N, 16)),
                                    _t(_residues(qs, (1, N))), sig(1, N))
    elements = fhe.sum_slots_elements()
    # galois_fold_tables caches the arrays of its first call; made under a
    # jit trace they are tracers that leak into the next trace, so the cache
    # is filled here, outside any trace
    jcontext.galois_fold_tables.cache_clear()
    for g in elements:
        jcontext.galois_fold_tables(N, g)
    kd = tctx.k
    gk = tbfv.galoiskey_gen_from_noise(
        tctx, sk, elements, _t(np.stack([_residues(qs, (kd, 1, N)).transpose(1, 0, 2, 3)
                                         for _ in elements])),
        _t(np.stack([_small(qs, (kd, 1, N), 6).transpose(1, 0, 2, 3)
                     for _ in elements])))
    enc = BatchEncoder(tctx.params, "cpu")
    cts = [tbfv.encrypt_from_noise(tctx, pk, enc.encode(v), _t(_ternary(qs, N, 16)),
                                   sig(1, N), sig(1, N)) for v in VALS]
    jgk = jtypes.GaloisKeys(data={g: jnp.asarray(convert.to_numpy(k))
                                  for g, k in gk.data.items()})
    return dataclasses.make_dataclass("H", [
        "fhe", "tctx", "jctx", "sk", "gk", "jgk", "enc", "cts"])(
        fhe, tctx, jctx, sk, gk, jgk, enc, cts)


def _decode(h, ct):
    return [int(x) for x in h.enc.decode(tbfv.decrypt(h.tctx, ct, h.sk))]


# ---------------------------------------------------------------------------
# host tables and kernel modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 1024, 8192])
def test_eval_perm_tables_match_jax(n):
    for g in (3, pow(3, 5, 2 * n), 2 * n - 1):
        src, inv = tcontext.eval_perm(n, g), tcontext.eval_perm_inv(n, g)
        np.testing.assert_array_equal(src, jbfv._eval_perm_host(n, g))
        np.testing.assert_array_equal(inv, jbfv._eval_perm_inv_host(n, g))
        assert src.dtype == inv.dtype == np.int32 and not src.flags.writeable
        np.testing.assert_array_equal(src[inv], np.arange(n))
    with pytest.raises(ValueError, match="odd"):
        tcontext.eval_perm(n, 2)


def _tables():
    qs = jmake_params(JSecurity(**KW)).q_primes
    return qs, npal.build_pallas_tables(N, qs), tntt.build_tables(N, qs, "cpu")


@pytest.mark.parametrize("stacks", ["shared", "per_element"])
def test_ks_inner_batch_matches_pallas(stacks):
    qs, pt, tb = _tables()
    batch, kd = 3, 3
    dg = _residues(qs, (kd, 1 if stacks == "shared" else batch, N))
    keys = _residues(qs, (kd, batch, 2, N))
    want = np.asarray(npal.ks_inner_batch(jnp.asarray(dg), jnp.asarray(keys), pt,
                                          interpret=True))
    got = ntt_cuda.ks_inner_batch(_t(dg), _t(keys), tb)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    assert got.shape == (3, 2, batch, N)


def test_ks_inner_grouped_matches_pallas():
    qs, pt, tb = _tables()
    num_c, num_e, kd = 2, 8, 3
    dg = _residues(qs, (kd, num_c, N))
    keys = _residues(qs, (kd, num_e, 2, N))
    want = np.asarray(npal.ks_inner_grouped(jnp.asarray(dg), jnp.asarray(keys), pt,
                                            interpret=True))
    got = ntt_cuda.ks_inner_grouped(_t(dg), _t(keys), tb)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # element c*E + e is stack c against key set e
    np.testing.assert_array_equal(
        convert.to_numpy(ntt_cuda.ks_inner_batch(_t(dg[:, :, 1:2]), _t(keys), tb)),
        want[:, :, num_e:])


def test_automorphism_fused_sum_matches_pallas():
    qs = jmake_params(JSecurity(**KW)).q_primes
    p = np.array(qs, dtype=np.uint32)
    hs = tuple(pow(g, -1, 2 * N) for g in ELEMS)
    x = _residues(qs, (2, len(hs), N))
    x[:, :, :, :4] = 0                    # neg(0) must stay 0
    c0, base = _residues(qs, (N,)), _residues(qs, (2, N))
    c0[:, :64] = 0
    want = np.asarray(gp.automorphism_fused_sum(
        jnp.asarray(x), hs, jnp.asarray(p), jnp.asarray(c0), jnp.asarray(base),
        interpret=True))
    got = galois_cuda.automorphism_fused_sum(_t(x), hs, _t(p), _t(c0), _t(base))
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # the sum of the separate automorphisms
    rot = convert.to_numpy(galois_cuda.automorphism_fused(_t(x), hs, _t(p), _t(c0)))
    pc = p.astype(np.int64)[:, None, None]
    np.testing.assert_array_equal((base + rot.astype(np.int64).sum(2)) % pc, want)


# ---------------------------------------------------------------------------
# the slice against fhe_tpu.scheme.bfv
# ---------------------------------------------------------------------------


def test_hoisted_galois_keys_match_jax(h):
    got = tbfv.hoisted_galois_keys(h.tctx, h.gk, ELEMS)
    assert got.shape == (3, 3, len(ELEMS), 2, N)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  _np(J.hoisted_galois_keys(h.jctx, h.jgk, ELEMS)))


def test_apply_galois_hoisted_matches_jax(h):
    want = J.apply_galois_hoisted(h.jctx, _jct(h.cts[0]), ELEMS, h.jgk)
    got = tbfv.apply_galois_hoisted(h.tctx, h.cts[0], ELEMS, h.gk)
    pre = tbfv.hoisted_galois_keys(h.tctx, h.gk, ELEMS)
    again = tbfv.apply_galois_hoisted(h.tctx, h.cts[0], ELEMS, h.gk, pre_keys=pre)
    assert len(got) == len(want) == len(ELEMS)
    for gi, ai, wi in zip(got, again, want):
        assert_ct_equal(gi, wi)
        assert torch.equal(gi.data, ai.data)
    assert tbfv.apply_galois_hoisted(h.tctx, h.cts[0], (), h.gk) == []


def test_hoisted_decrypts_as_sequential(h):
    """Each hoisted element decrypts to the sequential rotate_rows, and to
    the rotated slots."""
    for ct, vals in zip(h.cts, VALS):
        outs = h.fhe.rotate_rows_hoisted(ct, STEPS, h.gk)
        for s, out in zip(STEPS, outs):
            seq = h.fhe.rotate_rows(ct, s, h.gk)
            assert _decode(h, out) == _decode(h, seq)
            assert _decode(h, out)[:N // 2] == _rotated(vals, s)
            assert out.noise_budget >= seq.noise_budget - 1e-9


def test_apply_galois_hoisted_sum_matches_jax(h):
    ct = h.cts[1]
    got = tbfv.apply_galois_hoisted_sum(h.tctx, ct, ELEMS, h.gk)
    assert_ct_equal(got, J.apply_galois_hoisted_sum(h.jctx, _jct(ct), ELEMS, h.jgk))
    data = ct.data
    for part in tbfv.apply_galois_hoisted(h.tctx, ct, ELEMS, h.gk):
        data = (data + part.data) % h.tctx.ntt_q.p.view(-1, 1, 1)
    assert torch.equal(got.data, data)
    # slot j of the sum is v[j] + v[j+1] + v[j+2] + v[j+3]
    assert _decode(h, got)[:3] == [1 + 2 + 3 + 4, 2 + 3 + 4 + 5, 3 + 4 + 5 + 6]


def test_apply_galois_hoisted_batch_matches_jax(h):
    got = tbfv.apply_galois_hoisted_batch(h.tctx, h.cts, ELEMS, h.gk)
    want = J.apply_galois_hoisted_batch(h.jctx, [_jct(c) for c in h.cts], ELEMS, h.jgk)
    assert len(got) == len(h.cts)
    for c, (row, wrow) in enumerate(zip(got, want)):
        single = tbfv.apply_galois_hoisted(h.tctx, h.cts[c], ELEMS, h.gk)
        for gi, wi, si in zip(row, wrow, single):
            assert_ct_equal(gi, wi)
            assert torch.equal(gi.data, si.data) and gi.noise_budget == si.noise_budget
    # one ciphertext falls back to apply_galois_hoisted
    one = tbfv.apply_galois_hoisted_batch(h.tctx, h.cts[:1], ELEMS, h.gk)
    assert all(torch.equal(a.data, b.data) for a, b in zip(one[0], got[0]))


def _jax_sum_slots(h, ct):
    """FHE.sum_slots' stage sequence composed from fhe_tpu.scheme.bfv."""
    m, half, step = 2 * N, N // 2, 1
    while step < half:
        group = [j * step for j in (1, 2, 3) if j * step < half]
        if len(group) > 1 and all(pow(3, s, m) in h.jgk.data for s in group):
            ct = J.apply_galois_hoisted_sum(h.jctx, ct, tuple(pow(3, s, m) for s in group),
                                            h.jgk)
            step *= len(group) + 1
        else:
            ct = J.add(h.jctx, ct, J.rotate_rows(h.jctx, ct, step, h.jgk))
            step *= 2
    return J.add(h.jctx, ct, J.rotate_columns(h.jctx, ct, h.jgk))


def test_sum_slots_matches_jax(h):
    elements = h.fhe.sum_slots_elements()
    assert elements[:len(tcontext.default_galois_elements(N))] == \
        tcontext.default_galois_elements(N)
    assert len(elements) == 22 and set(elements) == set(h.gk.data)
    got = h.fhe.sum_slots(h.cts[0], h.gk)
    assert_ct_equal(got, _jax_sum_slots(h, _jct(h.cts[0])))
    assert set(_decode(h, got)) == {sum(VALS[0])}
    assert got.noise_budget > 0


def test_sum_slots_power_of_two_keys(h):
    """With the default elements only, every stage is rotate_rows and add;
    the sum is the same."""
    default = GaloisKeys(data={g: h.gk.data[g]
                               for g in tcontext.default_galois_elements(N)})
    got = h.fhe.sum_slots(h.cts[1], default)
    assert set(_decode(h, got)) == {sum(VALS[1])}


def test_facade_hoisted_cache_and_errors(h):
    fhe = h.fhe
    outs = fhe.rotate_rows_hoisted(h.cts[0], STEPS, h.gk)
    key = (id(h.gk), ELEMS, 0)
    pre = fhe._hoist_cache[key]
    assert torch.equal(pre, tbfv.hoisted_galois_keys(h.tctx, h.gk, ELEMS))
    again = fhe.rotate_rows_hoisted(h.cts[0], STEPS, h.gk)
    assert fhe._hoist_cache[key] is pre
    assert all(torch.equal(a.data, b.data) for a, b in zip(outs, again))
    batch = fhe.rotate_rows_hoisted_batch(h.cts, STEPS, h.gk)
    assert all(torch.equal(a.data, b.data) for a, b in zip(batch[0], outs))
    assert fhe.rotate_rows_hoisted_batch([], STEPS, h.gk) == []
    with pytest.raises(KeyError, match="no galois key"):
        fhe.rotate_rows_hoisted(h.cts[0], (1, 5), h.gk)
    with pytest.raises(KeyError, match="no galois key"):
        fhe.rotate_rows_hoisted_batch(h.cts, (5,), h.gk)
    # the cache entry goes with the keys
    keys = GaloisKeys(data={g: h.gk.data[g] for g in ELEMS})
    fhe.rotate_rows_hoisted(h.cts[0], STEPS, keys)
    kid = id(keys)
    assert any(k[0] == kid for k in fhe._hoist_cache)
    del keys
    gc.collect()
    assert not any(k[0] == kid for k in fhe._hoist_cache)
    # at level 1 the facade switches the keys down once and caches the
    # level's stack beside level 0's (tests/test_torch_leveled_n1024.py
    # holds the level-1 hoisted path against fhe_tpu)
    deep = fhe.mod_switch_to_next(h.cts[0])
    outs = fhe.rotate_rows_hoisted(deep, STEPS, h.gk)
    pre1 = fhe._hoist_cache[(id(h.gk), ELEMS, 1)]
    assert fhe._hoist_cache[key] is pre and pre1.shape == (2, 2, 3, 2, N)
    keys1 = tbfv.switch_galois_keys(h.tctx, h.gk, 1)
    want = tbfv.apply_galois_hoisted(h.tctx, deep, ELEMS, keys1, keys_at_level=True)
    assert all(torch.equal(a.data, b.data) and a.level == 1 for a, b in zip(outs, want))
    assert [_decode(h, o)[:N // 2] for o in outs] == [_rotated(VALS[0], s) for s in STEPS]
