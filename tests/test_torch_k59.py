"""The multiply past 30 primes, held bit for bit against the JAX package.

The deepest sets the port runs at n = 65536 are log_q = 1770 (k = 59 q
primes, kb = 63 Bsk primes) and log_q = 1920 (k = 64, kb = 68): past the
33 Bsk primes and the floor from 32 q primes that the base-conversion
kernel's register form holds, and past the 32 source primes the Lift lane
used to load.  Their counts at a CPU-sized ring: n = 1024, log_q = 1770,
lambda_ = 0, h = 16, seed 11 (k = 59, kb = 63, and kb = 59 at level 1).
JAX's facade makes the keys and the two ciphertexts of [4, 5, 6] and
[7, 8, 9]; convert.py carries them to the port on the CPU, where the
kernel wrappers run their plain twins.  The port's multiply, and its
multiply at level 1 after mod_switch_to_next, equal
fhe_tpu.scheme.bfv.multiply (jitted): residues with tolerance 0, the noise
budget, which the JAX package carries in float32, to 1e-4 bits or one
float32 step, whichever is larger (the step is 1.2e-4 at the level-1
ciphertexts' 1681 bits); the decrypts equal JAX's and decode [28, 40, 54].

The plain twins of the base conversion (the SK conversion with the
relinearization digits, the floor) and of the SmMRq lift are held against
fhe_tpu/oracle.py's arbitrary-precision algorithms at kb = 63 and 68 (from
k = 59 and 64 q primes), on random residues, on every residue p - 1 and
on the residues whose conversion digits are all p - 1 (the largest terms
of the kernel's unreduced sums, which fold every 16 terms).
chip_smoke.py's n65536 phase holds the card's wide instance and Lift lane
against these twins, and the card's multiply at n = 65536, log_q = 1770
against the port's CPU path.

One module-scoped state: JAX's keys (its jitted relinearization key
generator compiles a loop of 59 digits), ciphertexts and the two jitted
products take about a minute of this file's time on the CPU."""

import math
import types

import jax
import numpy as np
import pytest
import torch

from fhe_tpu import oracle
from fhe_tpu import FHE as JFHE
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params
from fhe_tpu.scheme import bfv as jbfv

from fhe_tpu_torch import convert
from fhe_tpu_torch.ops import modmath as tmm
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv as tbfv
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder

KW = dict(poly_degree=1024, log_q=1770, lambda_=0, hamming_weight=16)
VALS = ([4, 5, 6], [7, 8, 9])
PRODUCT = [28, 40, 54]
RNG = np.random.default_rng(20261019)

_jmultiply = jax.jit(jbfv.multiply)


def _np(x):
    return np.asarray(x).astype(np.uint32)


def _budget_close(got: float, want) -> bool:
    """The port's noise budget (host floats) against JAX's float32 one: to
    1e-4 bits, or to one float32 step at JAX's value where that is larger
    (above 1024 bits a float32 step is 1.2e-4)."""
    want = np.float32(want)
    return abs(got - float(want)) <= max(1e-4, float(np.spacing(want)))


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


def test_configuration_has_the_deep_sets_counts(state):
    """k = 59 and kb = 63 (kb = 59 at level 1), as log_q = 1770 has at
    n = 65536 (where t = 786433; the counts do not depend on t), and both
    packages pick the same q and Bsk primes; log_q = 1920 gives k = 64,
    kb = 68 in both."""
    ctx = state.ctx
    counts = (state.params.k, ctx.mul_levels[0][1].k, ctx.mul_levels[1][1].k)
    assert counts == (59, 63, 59)
    assert state.params.q_primes == tuple(int(q) for q in state.jfhe.params.q_primes)
    assert state.params.bsk_primes == tuple(int(p) for p in state.jfhe.params.bsk_primes)
    assert tuple(state.rlk.data.shape) == (59, 59, 2, 1024)
    for log_q, k, kb in ((1770, 59, 63), (1920, 64, 68)):
        big = dict(poly_degree=65536, log_q=log_q, lambda_=0, hamming_weight=16,
                   plain_modulus=786433)
        prm, jprm = make_scheme_params(SecurityParams(**big)), jmake_params(JSecurity(**big))
        assert (prm.k, len(prm.bsk_primes)) == (jprm.k, len(jprm.bsk_primes)) == (k, kb)
        assert prm.bsk_primes == tuple(int(p) for p in jprm.bsk_primes)


def test_multiply_matches_jax(state):
    """The port's multiply (the twins of B4-B7 on CPU tensors: the wide
    base conversion's with kb = 63) equals fhe_tpu's, residues and noise
    budget."""
    got = state.prod
    np.testing.assert_array_equal(convert.to_numpy(got), _np(state.jprod.data))
    assert got.level == 0 and not got.is_ntt_form
    assert _budget_close(got.noise_budget, state.jprod.noise_budget)


def test_decrypt_matches_jax_and_decodes_the_product(state):
    """The port's decrypt (B8's twin) of its product equals JAX's decrypt of
    JAX's, and both decode [28, 40, 54]."""
    got = tbfv.decrypt(state.ctx, state.prod, state.sk)
    want = state.jfhe.decrypt(state.jprod, state.jsk)
    np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
    assert [int(v) for v in BatchEncoder(state.params, "cpu").decode(got)[:3]] == PRODUCT
    assert [int(v) for v in state.jfhe.decode(want)[:3]] == PRODUCT


def test_level_1_multiply_matches_jax(state):
    """mod_switch_to_next, then the multiply at level 1 (58 q primes, kb =
    59, the keys switched down on the call): each equals JAX's, residues and
    noise budget, and the product decodes [28, 40, 54]."""
    for got, want in zip(state.cts1, state.jcts1):
        np.testing.assert_array_equal(convert.to_numpy(got), _np(want.data))
        assert _budget_close(got.noise_budget, want.noise_budget)
    got = state.prod1
    np.testing.assert_array_equal(convert.to_numpy(got), _np(state.jprod1.data))
    assert got.level == 1
    assert _budget_close(got.noise_budget, state.jprod1.noise_budget)
    plain = tbfv.decrypt(state.ctx, got, state.sk)
    np.testing.assert_array_equal(convert.to_numpy(plain),
                                  _np(state.jfhe.decrypt(state.jprod1, state.jsk).data))
    assert [int(v) for v in BatchEncoder(state.params, "cpu").decode(plain)[:3]] == PRODUCT


# ---------------------------------------------------------------------------
# the plain twins of the base conversion and the lift against the oracle
# ---------------------------------------------------------------------------

COLS = 8


def _bases(log_q: int):
    """(q primes, Bsk primes) of n = 1024 at log_q: k = 59, kb = 63 at 1770,
    k = 64, kb = 68 at 1920."""
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
@pytest.mark.parametrize("log_q,k,kb", [(1770, 59, 63), (1920, 64, 68)])
def test_base_conversion_twins_match_the_oracle(log_q, k, kb, inputs):
    """At kb = 63 and 68: the SK conversion Bsk -> q and the relinearization
    digits of its rows, the floor from k = 59 and 64 q primes into Bsk, the
    floor then the SK conversion (FloorSK) and the SmMRq lift q -> Bsk from
    k primes, each equal to the oracle's arbitrary-precision result, on
    random residues, on every residue p - 1 and on the largest digits (the
    m_sk row and the floor's Bsk rows, which are no digits, at p - 1
    then)."""
    qs, bsk = _bases(log_q)
    assert (len(qs), len(bsk)) == (k, kb)
    plain = "random" if inputs == "random" else "p-1"
    sk = trns.make_sk(bsk[:-1], bsk[-1], qs, "cpu")
    x_bsk = _rows(bsk[:-1], inputs) + _rows(bsk[-1:], plain)
    inv_qhat = [pow(math.prod(qs) // p, -1, p) for p in qs]
    w = tmm.u32_tensor(np.array(inv_qhat, np.uint32), "cpu")
    out, dig = trns.fast_bconv_sk_digits(_t(x_bsk).repeat(1, 3, 1), sk, w)
    want = oracle.fast_bconv_sk(x_bsk, bsk[:-1], bsk[-1], qs)
    assert _ints(out) == want
    assert _ints(dig) == [[v * c % p for v in row] for row, c, p in zip(want, inv_qhat, qs)]
    fc = trns.make_fast_floor(qs, bsk, "cpu")
    tx_q, tx_bsk = _rows(qs, inputs), _rows(bsk, plain)
    floored = oracle.fast_floor(tx_q, tx_bsk, oracle.RNSBasis(qs), bsk)
    assert _ints(trns.fast_floor(_t(tx_q), _t(tx_bsk), fc)) == floored
    assert _ints(trns.fast_floor_sk(_t(tx_q), _t(tx_bsk), fc, sk)) == oracle.fast_bconv_sk(
        floored, bsk[:-1], bsk[-1], qs)
    sc = trns.make_sm_mrq(qs, bsk, device="cpu")
    x_q = _rows(qs, inputs)
    assert _ints(trns.sm_mrq(_t(x_q), sc)) == oracle.sm_mrq(x_q, oracle.RNSBasis(qs), 1 << 16,
                                                           bsk)
