"""The multiply past 16 primes, held bit for bit against the JAX package.

The 128-bit parameter set at n = 32768, log_q = 870, has k = 29 q primes
and a Bsk base of kb = 32 (30 at level 1): more than the 16 terms a 64-bit
sum of the base-conversion kernel holds, and more than the 16 source primes
the Lift lane used to load at once.  Its counts at a CPU-sized ring:
n = 2048, log_q = 870, lambda_ = 0, h = 16, seed 11 (k = 29, kb = 32, and
kb = 29 at level 1; n = 1024 gives kb = 31 at level 0).  JAX's facade makes the keys
and the two ciphertexts of [4, 5, 6] and [7, 8, 9]; convert.py carries them
to the port on the CPU, where the kernel wrappers run their plain twins.
The port's multiply, and its multiply at level 1 after mod_switch_to_next,
equal fhe_tpu.scheme.bfv.multiply (jitted): residues with tolerance 0, the
noise budget, which the JAX package carries in float32, to 1e-4 bits; the
decrypts equal JAX's and decode [28, 40, 54].

The plain twins of the base conversion (the SK conversion with the
relinearization digits, the floor) and of the SmMRq lift are held against
fhe_tpu/oracle.py's arbitrary-precision algorithms at kb = 32 and 33, on
random residues, on every residue p - 1 and on the residues whose
conversion digits are all p - 1 (the largest terms of the kernel's
unreduced sums); the conversion takes any base past its deep instance in
the tiled one and raises only on a base of one Bsk prime, the Lift lane
takes any k, and the launch shape of the fixed instances (kb <= 17) is as
it was.  chip_smoke.py's secure128 phase and
tests/test_torch_cuda.py hold the card against these twins.

One module-scoped state: JAX's context, keys, ciphertexts and the two
jitted products take about 50 s of this file's time on the CPU."""

import math
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from fhe_tpu import oracle
from fhe_tpu import FHE as JFHE
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv

from fhe_tpu_torch import convert, primes
from fhe_tpu_torch.ops import modmath as tmm
from fhe_tpu_torch.ops import ntt_cuda, rns_cuda
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder

KW = dict(poly_degree=2048, log_q=870, lambda_=0, hamming_weight=16)
SECURE = dict(poly_degree=32768, log_q=870)          # the 128-bit set, h = 64
VALS = ([4, 5, 6], [7, 8, 9])
PRODUCT = [28, 40, 54]
RNG = np.random.default_rng(20261018)

_jmultiply = jax.jit(jbfv.multiply)


def _np(x):
    return np.asarray(x).astype(np.uint32)


@pytest.fixture(scope="module")
def state():
    """JAX's facade at seed 11 (keys, ciphertexts, their products at levels
    0 and 1) and the same keys and ciphertexts in the port, on the CPU, with
    the port's products of them."""
    jfhe = JFHE(jmake_params(JSecurity(**KW)), seed=11)
    pk, sk = jfhe.keygen()
    rlk = jfhe.relinkey_gen(sk)
    cts = [jfhe.encrypt(jfhe.encode(v), pk) for v in VALS]
    jprod = _jmultiply(jfhe.ctx, *cts, rlk)
    jcts1 = [jfhe.mod_switch_to_next(c) for c in cts]
    jprod1 = _jmultiply(jfhe.ctx, *jcts1, rlk)
    params = make_scheme_params(SecurityParams(**KW))
    tcts = [convert.ciphertext_from_numpy(_np(c.data), noise_budget=float(c.noise_budget),
                                          device="cpu") for c in cts]
    _, tsk = convert.keys_from_numpy(_np(pk.data), _np(sk.data), device="cpu")
    trlk = convert.relin_keys_from_numpy(_np(rlk.data), device="cpu")
    ctx = make_context(params, device="cpu")
    tcts1 = [tbfv.mod_switch_to_next(ctx, c) for c in tcts]
    return types.SimpleNamespace(
        jfhe=jfhe, jsk=sk, jprod=jprod, jcts1=jcts1, jprod1=jprod1, params=params, ctx=ctx,
        sk=tsk, rlk=trlk, prod=tbfv.multiply(ctx, *tcts, trlk), cts1=tcts1,
        prod1=tbfv.multiply(ctx, *tcts1, trlk))


def test_configuration_has_the_128_bit_sets_counts(state):
    """k = 29 and kb = 32 (kb = 29 at level 1), as the 128-bit set at
    n = 32768 (which both packages accept at lambda_ = 128 without their
    warning; kb = 30 at its level 1); both packages pick the same primes."""
    ctx = state.ctx
    counts = (state.params.k, ctx.mul_levels[0][1].k, ctx.mul_levels[1][1].k)
    assert counts == (29, 32, 29)
    assert state.params.q_primes == tuple(int(q) for q in state.jfhe.params.q_primes)
    assert state.params.bsk_primes == tuple(int(p) for p in state.jfhe.params.bsk_primes)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        secure = make_scheme_params(SecurityParams(**SECURE))
        jsecure = jmake_params(JSecurity(**SECURE))
    assert (secure.k, len(secure.bsk_primes)) == (29, 32)
    assert (jsecure.k, len(jsecure.bsk_primes)) == (29, 32)
    assert tuple(state.rlk.data.shape) == (29, 29, 2, 2048)


def test_multiply_matches_jax(state):
    """The port's multiply (the twins of B4-B7 on CPU tensors) equals
    fhe_tpu's, residues and noise budget."""
    got = state.prod
    np.testing.assert_array_equal(convert.to_numpy(got), _np(state.jprod.data))
    assert got.level == 0 and not got.is_ntt_form
    assert abs(got.noise_budget - float(state.jprod.noise_budget)) < 1e-4


def test_decrypt_matches_jax_and_decodes_the_product(state):
    """The port's decrypt (B8's twin) of its product equals JAX's decrypt of
    JAX's, and both decode [28, 40, 54]."""
    got = tbfv.decrypt(state.ctx, state.prod, state.sk)
    want = state.jfhe.decrypt(state.jprod, state.jsk)
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert [int(v) for v in BatchEncoder(state.params, "cpu").decode(got)[:3]] == PRODUCT
    assert [int(v) for v in state.jfhe.decode(want)[:3]] == PRODUCT


def test_level_1_multiply_matches_jax(state):
    """mod_switch_to_next, then the multiply at level 1 (28 q primes, kb =
    29, the keys switched down on the call): each equals JAX's, residues and
    noise budget, and the product decodes [28, 40, 54]."""
    for got, want in zip(state.cts1, state.jcts1):
        np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
        assert abs(got.noise_budget - float(want.noise_budget)) < 1e-4
    got = state.prod1
    np.testing.assert_array_equal(convert.to_numpy(got), _np(state.jprod1.data))
    assert got.level == 1
    assert abs(got.noise_budget - float(state.jprod1.noise_budget)) < 1e-4
    plain = tbfv.decrypt(state.ctx, got, state.sk)
    np.testing.assert_array_equal(convert.to_numpy(plain),
                                  _np(state.jfhe.decrypt(state.jprod1, state.jsk).data))
    assert [int(v) for v in BatchEncoder(state.params, "cpu").decode(plain)[:3]] == PRODUCT


# ---------------------------------------------------------------------------
# the plain twins of the base conversion and the lift against the oracle
# ---------------------------------------------------------------------------

COLS = 8


def _bases(log_q: int):
    """(q primes, Bsk primes) of n = 2048 at log_q: kb = 32 at 870, 33 at 881."""
    prm = make_scheme_params(SecurityParams(**{**KW, "log_q": log_q}))
    return prm.q_primes, prm.bsk_primes


def _rows(moduli, inputs: str) -> list[list[int]]:
    """COLS residues per prime: random ("random"), every residue p - 1
    ("p-1"), or ("max digits") those whose conversion digits
    [x_i * (P/p_i)^-1]_{p_i} over the base P of ``moduli`` are all p_i - 1."""
    if inputs == "random":
        return [[int(v) for v in RNG.integers(0, p, COLS)] for p in moduli]
    big = math.prod(moduli)
    return [[p - 1 if inputs == "p-1" else (p - 1) * (big // p) % p] * COLS for p in moduli]


def _t(rows) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64).to(torch.int32)[:, None]


def _ints(x: torch.Tensor) -> list[list[int]]:
    return [[int(v) % (1 << 32) for v in row] for row in x[:, 0].tolist()]


@pytest.mark.parametrize("inputs", ["random", "p-1", "max digits"])
@pytest.mark.parametrize("log_q,kb", [(870, 32), (881, 33)])
def test_base_conversion_twins_match_the_oracle(log_q, kb, inputs):
    """At kb = 32 and 33: the SK conversion Bsk -> q and the relinearization
    digits of its rows, the floor q -> Bsk, and the SmMRq lift q -> Bsk,
    each equal to the oracle's arbitrary-precision result, on random
    residues, on every residue p - 1 and on the largest digits (the m_sk
    row and the floor's Bsk rows, which are no digits, at p - 1 then)."""
    qs, bsk = _bases(log_q)
    assert len(bsk) == kb and len(qs) == kb - 3
    plain = "random" if inputs == "random" else "p-1"
    sk = trns.make_sk(bsk[:-1], bsk[-1], qs, "cpu")
    x_bsk = _rows(bsk[:-1], inputs) + _rows(bsk[-1:], plain)
    inv_qhat = [pow(math.prod(qs) // p, -1, p) for p in qs]
    out, dig = trns.fast_bconv_sk_digits(_t(x_bsk).repeat(1, 3, 1), sk,
                                         tmm.u32_tensor(np.array(inv_qhat, np.uint32), "cpu"))
    want = oracle.fast_bconv_sk(x_bsk, bsk[:-1], bsk[-1], qs)
    assert _ints(out) == want
    assert _ints(dig) == [[v * w % p for v in row] for row, w, p in zip(want, inv_qhat, qs)]
    fc = trns.make_fast_floor(qs, bsk, "cpu")
    tx_q, tx_bsk = _rows(qs, inputs), _rows(bsk, plain)
    assert _ints(trns.fast_floor(_t(tx_q), _t(tx_bsk), fc)) == oracle.fast_floor(
        tx_q, tx_bsk, oracle.RNSBasis(qs), bsk)
    sc = trns.make_sm_mrq(qs, bsk, device="cpu")
    x_q = _rows(qs, inputs)
    assert _ints(trns.sm_mrq(_t(x_q), sc)) == oracle.sm_mrq(x_q, oracle.RNSBasis(qs), 1 << 16,
                                                           bsk)


# ---------------------------------------------------------------------------
# the wrappers' limits and the launch shape of the fixed instances
# ---------------------------------------------------------------------------


def test_conversion_wrappers_raise_above_their_caps():
    """The base conversion has no prime cap left: past the deep instance's
    108 q and 112 Bsk primes (csrc/rns.cu kDeepMaxK, kDeepMaxKb, where its
    shared memory still fits a block) the tiled instance takes the call,
    k = 109 or kb = 113 in every lane, in two launches (four for FloorSK),
    each product over whole tiles of destination primes and words; at the
    caps the deep instance still does.  A base of one Bsk prime raises a
    ValueError naming the wrapper, before any launch (the checks run on the
    host)."""
    assert not hasattr(rns_cuda, "CONV_MAX_K") and not hasattr(rns_cuda, "CONV_KB")
    assert (rns_cuda.CONV_MIN_KB, rns_cuda.CONV_DEEP_KB, rns_cuda.CONV_DEEP_K) == (2, 112, 108)
    for lane in rns_cuda.CONV_LANES:
        assert rns_cuda.conv_tiled(lane, 113, 3) and rns_cuda.conv_tiled(lane, 113, 109)
        assert rns_cuda.conv_tiled(lane, 112, 109) and not rns_cuda.conv_tiled(lane, 112, 108)
        assert rns_cuda.conv_deep(lane, 112, 108) and not rns_cuda.conv_tiled(lane, 68, 64)
    count = 3 * 4
    for lane, (kb, k), launches in (("sk", (113, 3), 2), ("floor", (113, 109), 2),
                                    ("floor_sk", (113, 109), 4)):
        geo = rns_cuda.conv_tiled_geometry(count, lane, kb, k)
        assert len(geo["steps"]) == launches and geo["pitch"] == rns_cuda.CONV_TILE_WORDS
        for step in geo["steps"]:
            if step["kernel"] == "product":
                assert step["blocks"] == -(-step["dst"] // rns_cuda.CONV_TILE_PRIMES)
    ps = primes.find_ntt_primes(2048, 4)
    sk1 = trns.make_sk(ps[:0], ps[3], ps[:3], "cpu")                   # kb = 1
    x1 = torch.zeros((1, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="fast_bconv_sk_fused: the kernel takes at least 2 Bsk "
                                         "primes, got 1"):
        rns_cuda._conv_launch("sk", x1, None, sk1, None, None, 3, "fast_bconv_sk_fused")


def test_lift_lane_raises_above_its_cap():
    """tensor_product's Lift lane loads its source rows 16 at a time in a
    loop over k at run time, so it has no cap left: at k = 64 (log_q =
    1920, n = 32) its host checks pass and it returns both products, [64,
    3, n] in q and [68, 3, n] in Bsk; lift constants that do not match the
    tables still raise a ValueError naming tensor_product, on the host."""
    assert not hasattr(ntt_cuda, "LIFT_MAX_K")
    prm = make_scheme_params(SecurityParams(poly_degree=32, log_q=1920, lambda_=0,
                                            hamming_weight=4))
    ctx = make_context(prm, device="cpu")
    (tq, tbsk), sc = ctx.mul_levels[0], ctx.smq_levels[0]
    x = torch.zeros((64, 2, 32), dtype=torch.int32)
    tx_q, tx_bsk = ntt_cuda.tensor_product(x, x, tq, lift=(sc, tbsk))
    assert tuple(tx_q.shape) == (64, 3, 32) and tuple(tx_bsk.shape) == (68, 3, 32)
    with pytest.raises(ValueError, match="tensor_product: lift constants from 64 into 68"):
        ntt_cuda.tensor_product(x[:63], x[:63], ctx.mul_levels[1][0], lift=(sc, tbsk))


# (count, lane) -> (per_thread, threads, blocks) of the fixed instances, as
# scripts/conv_geometry_sweep.py chose them: [5,3,8192], [5,24,8192], n = 256, 16384
FIXED_SHAPES = {(3 * 8192, "sk"): (1, 128, 192), (24 * 8192, "sk"): (2, 256, 384),
                (24 * 8192, "floor_sk"): (1, 256, 768), (3 * 256, "floor_sk"): (1, 128, 6),
                (3 * 256, "floor"): (1, 128, 6), (3 * 16384, "sk"): (1, 256, 192)}


@pytest.mark.parametrize("count,lane", list(FIXED_SHAPES))
def test_fixed_instances_keep_their_launch_shape(count, lane):
    """conv_geometry of a base the fixed instances take (kb <= 17, a floor
    from at most 16 q primes) is what it was; the wide instance takes one
    word per thread and otherwise the same CTA size."""
    for kb, k in ((5, 3), (10, 8), (16, 14), (17, 15), (17, 16)):
        assert not rns_cuda.conv_wide(lane, kb, k)
    geo = rns_cuda.conv_geometry(count, lane)
    assert (geo["per_thread"], geo["threads"], geo["blocks"]) == FIXED_SHAPES[count, lane]
    assert geo == rns_cuda.conv_geometry(count, lane, wide=False)
    wide = rns_cuda.conv_geometry(count, lane, wide=True)
    assert wide["per_thread"] == 1 and wide["blocks"] * wide["threads"] >= count
    assert rns_cuda.conv_wide(lane, 18, 15) and rns_cuda.conv_wide("sk", 32, 29)
    assert rns_cuda.conv_wide(lane, 17, 17) == (lane != "sk")
