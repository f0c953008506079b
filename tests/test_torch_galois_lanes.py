"""The key-switch kernels' Galois lanes, held bit for bit against the JAX
package's separate kernels.

The lanes fold the automorphisms of galois_pallas.py into the key switch
around them (csrc/ntt.cu).  On CPU tensors the wrappers run their plain
PyTorch versions (ops/ntt.py), which compute the lanes' way: the hoisted
lanes gather the NTT-domain inner products by each automorphism before the
inverse, and the key switch's Galois lane gathers, and negates mod q_j, the
digits of the un-permuted c1.  Here:

- a sum_slots stage (ks_inner_batch then automorphism_fused_sum, and the
  sum of the Galois lane's rotations) against ntt_pallas.ks_inner_batch
  then galois_pallas.automorphism_fused_sum (interpreter mode) at E = 1, 3,
  8;
- the Galois lanes of ks_inner_batch (a shared c0, and a stack and a c0 per
  element) and ks_inner_grouped (a c0 per ciphertext) against
  ks_inner_batch / ks_inner_grouped then galois_pallas.automorphism_fused;
- keyswitch_fused's Galois lane against fhe_tpu.scheme.bfv.apply_galois at
  ks_omega = 1 for g = 3, 3^4 mod 2n and 2n - 1, on keys and a ciphertext
  made by the port from numpy draws and carried across as arrays;
- a model of the indices the lanes compute in place of tables
  (ops/galois.py: ntt_source and coeff_source, the kernels' formulas)
  against fhe_tpu's eval_perm and galois_permutation tables at n = 32 to
  32768.

n = 1024, k = 3 (log_q = 90), h = 16, lambda_ = 0.  Residues are compared
with tolerance 0.  tests/test_torch_cuda.py holds the CUDA lanes against the
same plain versions on the card; tests/test_torch_hoisted.py,
test_torch_rotate.py and test_torch_omega.py hold the rotations built on
them against fhe_tpu.scheme.bfv."""

import dataclasses

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
from fhe_tpu_torch.ops import galois as tgalois
from fhe_tpu_torch.ops import galois_cuda
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import ntt_cuda
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.encoder import BatchEncoder

KW = dict(poly_degree=1024, log_q=90, hamming_weight=16, lambda_=0)
N = 1024
HOIST = tuple(pow(3, s, 2 * N) for s in range(1, 9))
ROTATIONS = (3, pow(3, 4, 2 * N), 2 * N - 1)
RNG = np.random.default_rng(20261021)

_apply_galois = jax.jit(jbfv.apply_galois, static_argnums=2)


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


def _tables():
    qs = jmake_params(JSecurity(**KW)).q_primes
    return qs, npal.build_pallas_tables(N, qs), tntt.build_tables(N, qs, "cpu")


def _pallas_deltas(dg, keys, pt, grouped=False):
    fn = npal.ks_inner_grouped if grouped else npal.ks_inner_batch
    return fn(jnp.asarray(dg), jnp.asarray(keys), pt, interpret=True)


@pytest.mark.parametrize("num_e", [1, 3, 8])
def test_sum_stage_matches_pallas(num_e):
    """A sum_slots stage, base + sum_e phi_e(delta_e + (c0, 0)): the port's
    two launches (ks_inner_batch, then automorphism_fused_sum) against the
    JAX package's two kernels, and base plus the sum of the Galois lane's
    hoisted rotations (each gathered in the NTT domain before its inverse)
    equal to both.  A run of c0 and of the digits is zero."""
    qs, pt, tb = _tables()
    p = np.array(qs, dtype=np.uint32)
    elements = HOIST[:num_e]
    hs = tuple(pow(g, -1, 2 * N) for g in elements)
    dg, keys = _residues(qs, (3, 1, N)), _residues(qs, (3, num_e, 2, N))
    c0, base = _residues(qs, (N,)), _residues(qs, (2, N))
    c0[:, :64] = 0
    dg[..., :64] = 0
    want = np.asarray(gp.automorphism_fused_sum(
        _pallas_deltas(dg, keys, pt), hs, jnp.asarray(p), jnp.asarray(c0),
        jnp.asarray(base), interpret=True))
    got = galois_cuda.automorphism_fused_sum(ntt_cuda.ks_inner_batch(_t(dg), _t(keys), tb),
                                             hs, _t(p), _t(c0), _t(base))
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    rot = convert.to_numpy(ntt_cuda.ks_inner_batch(_t(dg), _t(keys), tb, elements, _t(c0)))
    pc = p.astype(np.int64)[:, None, None]
    np.testing.assert_array_equal((base + rot.astype(np.int64).sum(2)) % pc, want)


@pytest.mark.parametrize("lane", ["shared", "per_element", "grouped"])
def test_ks_inner_galois_lane_matches_pallas(lane):
    """The hoisted rotations' lane: phi_g(delta + (c0, 0)) per element, for a
    digit stack and c0 shared by E = 3 elements, a stack and a c0 per
    element, and C = 2 ciphertexts by E = 3 elements."""
    qs, pt, tb = _tables()
    p = jnp.asarray(np.array(qs, dtype=np.uint32))
    elements = HOIST[:3]
    hs = tuple(pow(g, -1, 2 * N) for g in elements)
    keys = _residues(qs, (3, 3, 2, N))
    if lane == "grouped":
        dg, c0 = _residues(qs, (3, 2, N)), _residues(qs, (2, N))
        want = gp.automorphism_fused(_pallas_deltas(dg, keys, pt, grouped=True), hs * 2, p,
                                     jnp.asarray(np.repeat(c0, 3, axis=1)), interpret=True)
        got = ntt_cuda.ks_inner_grouped(_t(dg), _t(keys), tb, elements, _t(c0))
    else:
        stacks = 1 if lane == "shared" else 3
        dg = _residues(qs, (3, stacks, N))
        c0 = _residues(qs, (N,)) if lane == "shared" else _residues(qs, (3, N))
        want = gp.automorphism_fused(_pallas_deltas(dg, keys, pt), hs, p, jnp.asarray(c0),
                                     interpret=True)
        got = ntt_cuda.ks_inner_batch(_t(dg), _t(keys), tb, elements, _t(c0))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@pytest.fixture(scope="module")
def rot():
    """The port's keys and a ciphertext from numpy draws, and the same as
    JAX values on a use_pallas=False context."""
    jctx = jcontext.make_context(jmake_params(JSecurity(**KW)), use_pallas=False,
                                 use_mxu=False)
    # galois_fold_tables caches the arrays of its first call; made under a
    # jit trace they are tracers that leak into the next trace, so the cache
    # is filled here, outside any trace
    jcontext.galois_fold_tables.cache_clear()
    for g in ROTATIONS:
        jcontext.galois_fold_tables(N, g)
    fhe = FHE(device="cpu", seed=0, **KW)
    tctx, qs = fhe.ctx, fhe.params.q_primes
    pk, sk = tbfv.keygen_from_noise(tctx, _t(_ternary(qs, N, 16)),
                                    _t(_residues(qs, (1, N))), _t(_small(qs, (1, N))))
    gk = tbfv.galoiskey_gen_from_noise(
        tctx, sk, ROTATIONS,
        _t(np.stack([_residues(qs, (3, 1, N)).transpose(1, 0, 2, 3) for _ in ROTATIONS])),
        _t(np.stack([_small(qs, (3, 1, N)).transpose(1, 0, 2, 3) for _ in ROTATIONS])))
    enc = BatchEncoder(tctx.params, "cpu")
    ct = tbfv.encrypt_from_noise(tctx, pk, enc.encode([5, 10, 15, 20]),
                                 _t(_ternary(qs, N, 16)), _t(_small(qs, (1, N))),
                                 _t(_small(qs, (1, N))))
    jgk = jtypes.GaloisKeys(data={g: jnp.asarray(convert.to_numpy(k))
                                  for g, k in gk.data.items()})
    jct = jtypes.Ciphertext(data=jnp.asarray(convert.to_numpy(ct)), level=0,
                            is_ntt_form=False, noise_budget=ct.noise_budget)
    return dataclasses.make_dataclass("Rot", ["tctx", "jctx", "gk", "jgk", "ct", "jct"])(
        tctx, jctx, gk, jgk, ct, jct)


@pytest.mark.parametrize("g", ROTATIONS)
def test_keyswitch_galois_lane_matches_apply_galois(rot, g):
    """One launch of keyswitch_fused's Galois lane, on the digits of the
    un-permuted c1, is the JAX package's apply_galois: phi_g of both
    components, the digits of the permuted c1, the key switch and the add.
    A run of both components is zero, so the negations of c0 and of the
    digits meet zeros (neg(0) must stay 0)."""
    data = rot.ct.data.clone()
    data[..., :64] = 0
    jct = rot.jct.replace(data=jnp.asarray(convert.to_numpy(data)))
    d = tbfv._digits(rot.tctx, data[:, 1], 0)
    got = ntt_cuda.keyswitch_fused(d, rot.gk.data[g].permute(1, 0, 2, 3), rot.tctx.ntt_q,
                                   g=g, c0=data[:, 0])
    want = _apply_galois(rot.jctx, jct, g, rot.jgk)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  np.asarray(want.data).astype(np.uint32))


@pytest.mark.parametrize("n", [32, 64, 256, 1024, 8192, 32768])
def test_lane_indices_match_tables(n):
    """The kernels' index formulas: the NTT-domain source of phi_g (one
    aligned block of 16 per group of 16, permuted) against eval_perm, and
    the coefficient source and sign of h = g^-1 mod 2n against
    galois_permutation."""
    for g in (3, pow(3, 5, 2 * n), pow(3, n // 4 - 1, 2 * n), 2 * n - 1):
        src = tgalois.ntt_source(n, g).numpy()
        np.testing.assert_array_equal(src, jbfv._eval_perm_host(n, g))
        np.testing.assert_array_equal(src >> 4, src[::16].repeat(16) >> 4)
        csrc, neg = tgalois.coeff_source(n, pow(g, -1, 2 * n))
        want_src, want_neg = jcontext.galois_permutation(n, g)
        np.testing.assert_array_equal(csrc.numpy(), want_src)
        np.testing.assert_array_equal(neg.numpy(), want_neg)
