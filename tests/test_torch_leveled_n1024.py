"""Leveled BFV at n = 1024, k = 3, level 1, held bit for bit against the JAX package.

At n >= 1024 the multiply's Bsk branch is one kernel (bsk_branch_fused, B5);
at level 1 it reads the last bsk_counts[1] rows of the Bsk tables, row
views that start mid-tensor.  The slice: multiply at level 1, and the
hoisted rotations (rotate_rows_hoisted, rotate_rows_hoisted_batch) and
sum_slots of a level-1 ciphertext through the FHE facade, which switches the
Galois keys down and caches them per level, against fhe_tpu.scheme.bfv,
jitted, on a use_pallas=False context (whose composed hoisted path
tests/test_pallas.py pins equal to the Pallas fast path).  Keys and
ciphertexts come from the port's *_from_noise entry points with numpy draws
and are carried to the JAX package as arrays.

n = 1024, log_q = 90 (k = 3), h = 16, lambda_ = 0.  Residues are compared
with tolerance 0; the noise budget, which the JAX package carries in
float32, to 1e-4 bits."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fhe_tpu.ops import rns_pallas as rpal
from fhe_tpu.ops import ntt_pallas as npal
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv
from fhe_tpu.scheme import context as jcontext
from fhe_tpu.scheme import types as jtypes

from fhe_tpu_torch import FHE, convert
from fhe_tpu_torch.ops import rns_cuda
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.types import Ciphertext

N = 1024
KW = dict(poly_degree=N, log_q=90, hamming_weight=16, lambda_=0)
STEPS = (1, 2, 3)
ELEMS = tuple(pow(3, s, 2 * N) for s in STEPS)
VALS = ([5, 10, 15, 20], [3, 6, 9, 12])
RNG = np.random.default_rng(20261022)

# the JAX references, jitted once (eager JAX costs minutes at n = 1024)
J = dataclasses.make_dataclass("J", [
    "mod_switch_to_next", "multiply", "apply_galois_hoisted",
    "apply_galois_hoisted_sum", "rotate_rows", "rotate_columns", "add"])(
    jax.jit(jbfv.mod_switch_to_next),
    jax.jit(jbfv.multiply),
    jax.jit(jbfv.apply_galois_hoisted, static_argnums=2),
    jax.jit(jbfv.apply_galois_hoisted_sum, static_argnums=2),
    jax.jit(jbfv.rotate_rows, static_argnums=2),
    jax.jit(jbfv.rotate_columns),
    jax.jit(jbfv.add))


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


@pytest.fixture(scope="module")
def h():
    """The port's keys (sk, rlk, Galois keys for the sum_slots elements) and
    two ciphertexts of VALS switched to level 1; the same as JAX values."""
    jctx = jcontext.make_context(jmake_params(JSecurity(**KW)), use_pallas=False,
                                 use_mxu=False)
    fhe = FHE(device="cpu", seed=0, **KW)
    tctx, qs, k = fhe.ctx, fhe.params.q_primes, fhe.params.k
    elements = fhe.sum_slots_elements()
    jcontext.galois_fold_tables.cache_clear()   # filled outside any trace
    for g in elements:
        jcontext.galois_fold_tables(N, g)
    pk, sk = tbfv.keygen_from_noise(tctx, _t(_ternary(qs, N, 16)),
                                    _t(_residues(qs, (1, N))), _t(_small(qs, (1, N))))
    draws = lambda: (_t(_residues(qs, (k, 1, N)).transpose(1, 0, 2, 3)),
                     _t(_small(qs, (k, 1, N)).transpose(1, 0, 2, 3)))
    rlk = tbfv.relinkey_gen_from_noise(tctx, sk, *draws())
    gal = [draws() for _ in elements]
    gk = tbfv.galoiskey_gen_from_noise(tctx, sk, elements,
                                       _t(np.stack([a for a, _ in gal])),
                                       _t(np.stack([e for _, e in gal])))
    cts = [tbfv.mod_switch_to_next(tctx, tbfv.encrypt_from_noise(
        tctx, pk, fhe.encode(v), _t(_ternary(qs, N, 16)), _t(_small(qs, (1, N))),
        _t(_small(qs, (1, N))))) for v in VALS]
    jrlk = jtypes.RelinKeys(data=jnp.asarray(convert.to_numpy(rlk)))
    jgk = jtypes.GaloisKeys(data={g: jnp.asarray(convert.to_numpy(v))
                                  for g, v in gk.data.items()})
    return dataclasses.make_dataclass("H", [
        "jctx", "fhe", "tctx", "sk", "rlk", "gk", "cts", "jrlk", "jgk"])(
        jctx, fhe, tctx, sk, rlk, gk, cts, jrlk, jgk)


def _decode(h, ct):
    return [int(v) for v in h.fhe.decode(tbfv.decrypt(h.tctx, ct, h.sk))]


def _rotated(vals, steps, half=N // 2):
    row = list(vals) + [0] * (half - len(vals))
    return row[steps:] + row[:steps]


def test_bsk_branch_with_level_suffix_matches_pallas(h):
    """B5's plain twin at level 1: the last bsk_counts[1] Bsk rows of the
    t-folded tables (views at an offset) and the level's constants."""
    prm, jctx = h.jctx.params, h.jctx
    kb = jctx.bsk_counts[1]
    tbsk = h.tctx.mul_levels[1][1]
    assert tbsk.k == kb < len(prm.bsk_primes) and tbsk.primes[-1] == prm.m_sk
    assert tbsk.psi_br.data_ptr() > h.tctx.mul_levels[0][1].psi_br.data_ptr()
    tbsk_pl = npal.build_mul_tables(N, prm.q_primes, prm.bsk_primes, prm.t, 2, kb)[1]
    ab, tx_q = _residues(prm.q_primes[:2], (4, N)), _residues(prm.q_primes[:2], (3, N))
    want = np.asarray(rpal.bsk_branch_fused(
        jnp.asarray(ab), jnp.asarray(tx_q), jctx.smq_levels[1], jctx.floor_levels[1],
        tbsk_pl, interpret=True))
    got = rns_cuda.bsk_branch_fused(_t(ab), _t(tx_q), h.tctx.smq_levels[1],
                                    h.tctx.floor_levels[1], tbsk)
    np.testing.assert_array_equal(convert.to_numpy(got), want)


def test_multiply_at_level_one_matches_jax(h):
    a, b = h.cts
    got = h.fhe.multiply(a, b, h.rlk)
    assert_ct_equal(got, J.multiply(h.jctx, _jct(a), _jct(b), h.jrlk))
    assert got.level == 1 and _decode(h, got)[:4] == [15, 60, 135, 240]


def test_rotate_rows_hoisted_at_level_one_matches_jax(h):
    ct = h.cts[0]
    outs = h.fhe.rotate_rows_hoisted(ct, STEPS, h.gk)
    want = J.apply_galois_hoisted(h.jctx, _jct(ct), ELEMS, h.jgk)
    for s, got, w in zip(STEPS, outs, want):
        assert_ct_equal(got, w)
        assert _decode(h, got)[:N // 2] == _rotated(VALS[0], s)
    pre = h.fhe._hoist_cache[(id(h.gk), ELEMS, 1)]
    assert torch.equal(pre, tbfv.hoisted_galois_keys(h.tctx, h.gk, ELEMS, level=1))
    # the batch of both level-1 ciphertexts: element [c][e] is the single call's
    batch = h.fhe.rotate_rows_hoisted_batch(h.cts, STEPS, h.gk)
    for c, row in enumerate(batch):
        single = outs if c == 0 else h.fhe.rotate_rows_hoisted(h.cts[c], STEPS, h.gk)
        assert all(torch.equal(x.data, y.data) and x.level == 1
                   for x, y in zip(row, single))


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


def test_sum_slots_at_level_one_matches_jax(h):
    """Bits and tracked budget equal JAX's.  Two primes leave the 5 key
    switches of sum_slots no budget to decode with (the tracked budget runs
    to 0, in both packages), so the decode is checked on one hoisted stage."""
    got = h.fhe.sum_slots(h.cts[1], h.gk)
    assert_ct_equal(got, _jax_sum_slots(h, _jct(h.cts[1])))
    assert (id(h.gk), 1) in h.fhe._gal_cache
    stage = h.fhe._rotate_accumulate(h.cts[1], STEPS, h.gk)
    assert _decode(h, stage)[:4] == [3 + 6 + 9 + 12, 6 + 9 + 12, 9 + 12, 12]
