"""The base conversion past the deep instance's caps, held on the CPU at the
conversion level.

JAX's make_scheme_params takes k = ceil(log_q / 30) 30-bit primes for as
long as they last, so at n <= 65536 it gives sets past the 108 q and 112
Bsk primes that the base conversion's deep instance holds in shared memory
(csrc/rns.cu kDeepMaxK, kDeepMaxKb).  The tiled instance takes them: the
first past the caps, k = 109, kb = 114 (log_q = 3270), and the largest set
at n = 65536 (log_q = 5790: k = 193, kb = 201), n = 256 (log_q = 12000:
k = 400, kb = 415) and n = 8192 (log_q = 46170: k = 1539, kb = 1594), at
t = 786433, lambda_ = 0.  A JAX key or multiply there takes minutes on the
CPU, so this file holds the port where its path past the caps differs, the
conversion, and chip_smoke.py's deep phase holds the card's multiply there:

* both packages pick the same primes;
* the plain twins (fast_bconv_sk with the relinearization digits,
  fast_floor, fast_floor_sk and sm_mrq) equal fhe_tpu/oracle.py and the JAX
  package's fast_bconv_sk and fast_floor (jitted) at (109, 114) and
  (193, 201), on random residues, every residue p - 1 and the residues
  whose conversion digits are all p - 1 (the largest terms of the kernel's
  unreduced sums), residues with tolerance 0;
* ops/rns.py's plain model of the tiled instance's order of work (its
  digits launch, its chunks of 16 source primes and the folds between
  them, alpha before any destination prime) equals the twins at all four
  sets, each unreduced sum exactly below 2^64 on max-digit inputs;
* the tiled instance's launch shape at k = 109, 193, 384 and 1539: its
  shared memory the same at every k, every destination prime and word in a
  tile; and the fixed, wide and deep instances keep their shapes below the
  caps.
"""

import math

import jax
import numpy as np
import pytest
import torch

from fhe_tpu import oracle
from fhe_tpu.ops import rns as jrns
from fhe_tpu.params import SecurityParams as JSecurity
from fhe_tpu.params import make_scheme_params as jmake_params

from fhe_tpu_torch.ops import modmath as tmm
from fhe_tpu_torch.ops import ntt_cuda, rns_cuda
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.params import SecurityParams, make_scheme_params

# (k, kb) -> (n, log_q) of the sets past the caps
SETS = {(109, 114): (1024, 3270), (193, 201): (65536, 5790), (400, 415): (256, 12000),
        (1539, 1594): (8192, 46170)}
KW = dict(lambda_=0, hamming_weight=16, plain_modulus=786433)
COLS = 8
RNG = np.random.default_rng(20261023)

_jsk = jax.jit(jrns.fast_bconv_sk)
_jfloor = jax.jit(jrns.fast_floor)


def _bases(k: int, kb: int):
    """(q primes, Bsk primes) of the set with k and kb primes."""
    n, log_q = SETS[k, kb]
    prm = make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q, **KW))
    assert (prm.k, len(prm.bsk_primes)) == (k, kb)
    return prm.q_primes, prm.bsk_primes


def _rows(moduli, inputs: str, cols: int = COLS) -> np.ndarray:
    """[len(moduli), cols] residues: random ("random"), every residue p - 1
    ("p-1"), or ("max digits") those whose conversion digits
    [x_i * (P/p_i)^-1]_{p_i} over the base P of ``moduli`` are all p_i - 1."""
    if inputs == "random":
        return np.stack([RNG.integers(0, p, cols) for p in moduli]).astype(np.int64)
    big = math.prod(moduli)
    vals = [p - 1 if inputs == "p-1" else (p - 1) * (big // p) % p for p in moduli]
    return np.repeat(np.array(vals, dtype=np.int64)[:, None], cols, axis=1)


def _mixed(moduli, digits: bool) -> np.ndarray:
    """COLS random residues per prime, then one column of every residue
    p - 1 and, where the rows are conversion digits (``digits``), one of
    max digits (else a second of p - 1: the m_sk row and the floor's Bsk
    rows are no digits)."""
    return np.concatenate([_rows(moduli, "random"), _rows(moduli, "p-1", 1),
                           _rows(moduli, "max digits" if digits else "p-1", 1)], axis=1)


def _t(rows: np.ndarray, comps: int = 1) -> torch.Tensor:
    """[r, comps * cols] residues as an int32 [r, comps, cols] tensor."""
    return torch.from_numpy(rows).to(torch.int32).view(rows.shape[0], comps, -1)


def _ints(x: torch.Tensor) -> list[list[int]]:
    return (x.reshape(x.shape[0], -1).to(torch.int64) & 0xFFFFFFFF).tolist()


def _u32(rows: np.ndarray) -> np.ndarray:
    return rows.astype(np.uint32)[:, None]


@pytest.mark.parametrize("k,kb", list(SETS))
def test_both_packages_pick_the_same_primes(k, kb):
    """The port's make_scheme_params gives JAX's q and Bsk primes at each
    set past the caps."""
    n, log_q = SETS[k, kb]
    qs, bsk = _bases(k, kb)
    jprm = jmake_params(JSecurity(poly_degree=n, log_q=log_q, **KW))
    assert (tuple(jprm.q_primes), tuple(jprm.bsk_primes)) == (tuple(qs), tuple(bsk))


@pytest.mark.parametrize("k,kb", [(109, 114), (193, 201)])
def test_host_tables_match_jax(k, kb):
    """The conversions' host tables, which the port builds with numpy scans
    of prefix and suffix products (rns.phat_mod) and vectorised Shoup
    companions, equal the JAX package's big-integer builders: (B/b_i) mod
    q_j and (q/q_i) mod c_j with their Shoup companions, and the rest of
    each SK and floor constant."""
    qs, bsk = _bases(k, kb)
    sk, fc = trns.make_sk(bsk[:-1], bsk[-1], qs, "cpu"), trns.make_fast_floor(qs, bsk, "cpu")
    jsk, jfc = jrns.make_sk(bsk[:-1], bsk[-1], qs), jrns.make_fast_floor(qs, bsk)
    u32 = lambda x: (x.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)
    for got, want in ((sk.conv_q, jsk.conv_q), (sk.conv_sk, jsk.conv_sk), (fc.conv, jfc.conv)):
        for f in want._fields:
            np.testing.assert_array_equal(u32(getattr(got, f)), np.asarray(getattr(want, f)),
                                          err_msg=f)
    for f in ("B_mod_q", "B_shoup_q"):
        np.testing.assert_array_equal(u32(getattr(sk, f)), np.asarray(getattr(jsk, f)))
    for f in ("inv_q_dst", "inv_q_shoup_dst"):
        np.testing.assert_array_equal(u32(getattr(fc, f)), np.asarray(getattr(jfc, f)))


@pytest.mark.parametrize("lane", ["sk", "floor", "floor_sk", "sm_mrq"])
@pytest.mark.parametrize("k,kb", [(109, 114), (193, 201)])
def test_twins_match_the_oracle_and_jax(k, kb, lane):
    """Each twin equals the oracle's arbitrary-precision result on COLS
    random coefficients, one of every residue p - 1 and one of max digits:
    the SK conversion Bsk -> q with the relinearization digits of its rows
    and the floor from k q primes into Bsk (each also equal to the JAX
    package's, jitted), the floor then the SK conversion (FloorSK) and the
    SmMRq lift q -> Bsk."""
    qs, bsk = _bases(k, kb)
    sk_oracle = lambda x: oracle.fast_bconv_sk(x, bsk[:-1], bsk[-1], qs)
    if lane == "sk":
        x_bsk = np.concatenate([_mixed(bsk[:-1], True), _mixed(bsk[-1:], False)])
        inv_qhat = [pow(math.prod(qs) // p, -1, p) for p in qs]
        w = tmm.u32_tensor(np.array(inv_qhat, np.uint32), "cpu")
        sk = trns.make_sk(bsk[:-1], bsk[-1], qs, "cpu")
        want = sk_oracle(x_bsk.tolist())
        out, dig = trns.fast_bconv_sk_digits(_t(np.tile(x_bsk, 3), 3), sk, w)
        assert _ints(out) == [row * 3 for row in want]
        assert _ints(dig) == [[v * c % p for v in row] for row, c, p in zip(want, inv_qhat, qs)]
        jsk = jrns.make_sk(bsk[:-1], bsk[-1], qs)
        assert np.asarray(_jsk(_u32(x_bsk), jsk))[:, 0].tolist() == want
        return
    tx_q = _mixed(qs, True)
    if lane == "sm_mrq":
        sc = trns.make_sm_mrq(qs, bsk, device="cpu")
        assert _ints(trns.sm_mrq(_t(tx_q), sc)) == oracle.sm_mrq(
            tx_q.tolist(), oracle.RNSBasis(qs), 1 << 16, bsk)
        return
    tx_bsk = _mixed(bsk, False)
    fc = trns.make_fast_floor(qs, bsk, "cpu")
    floored = oracle.fast_floor(tx_q.tolist(), tx_bsk.tolist(), oracle.RNSBasis(qs), bsk)
    if lane == "floor":
        assert _ints(trns.fast_floor(_t(tx_q), _t(tx_bsk), fc)) == floored
        jfc = jrns.make_fast_floor(qs, bsk)
        assert np.asarray(_jfloor(_u32(tx_q), _u32(tx_bsk), jfc))[:, 0].tolist() == floored
        return
    sk = trns.make_sk(bsk[:-1], bsk[-1], qs, "cpu")
    assert _ints(trns.fast_floor_sk(_t(tx_q), _t(tx_bsk), fc, sk)) == sk_oracle(floored)


@pytest.mark.parametrize("k,kb", list(SETS))
def test_tiled_model_matches_the_twins(k, kb):
    """rns.tiled_conv, the tiled instance's order of work, equals the
    twins in each lane (SK and FloorSK with the digits of their c2 rows,
    Floor) on random and on max-digit inputs ([rows, 3, cols]: three
    components, as the multiply's digits lane takes them), and every
    unreduced sum it formed stayed below 2^64 (it raises otherwise)."""
    qs, bsk = _bases(k, kb)
    sk, fc = trns.make_sk(bsk[:-1], bsk[-1], qs, "cpu"), trns.make_fast_floor(qs, bsk, "cpu")
    w = tmm.u32_tensor(np.array([pow(math.prod(qs) // p, -1, p) for p in qs], np.uint32), "cpu")
    cols = 2 if k > 1000 else COLS
    for inputs in ("random", "max digits"):
        plain = "random" if inputs == "random" else "p-1"
        x_bsk = _t(np.concatenate([_rows(bsk[:-1], inputs, 3 * cols),
                                   _rows(bsk[-1:], plain, 3 * cols)]), 3)
        tx_q, tx_bsk = _t(_rows(qs, inputs, 3 * cols), 3), _t(_rows(bsk, plain, 3 * cols), 3)
        got = [trns.tiled_conv("sk", x_bsk, sk=sk, inv_qhat=w),
               trns.tiled_conv("floor", tx_q, tx_bsk, fc=fc),
               trns.tiled_conv("floor_sk", tx_q, tx_bsk, sk=sk, fc=fc, inv_qhat=w)]
        want = [trns.fast_bconv_sk_digits(x_bsk, sk, w), trns.fast_floor(tx_q, tx_bsk, fc),
                trns.fast_floor_sk(tx_q, tx_bsk, fc, sk, w)]
        for (result, largest), twin in zip(got, want):
            for a, b in zip(*((result, twin) if isinstance(twin, tuple)
                              else ((result,), (twin,)))):
                assert a.shape == b.shape and torch.equal(a, b)
            assert 1 << 62 < largest < 1 << 64


@pytest.mark.parametrize("k,kb", [(109, 114), (193, 201), (384, 399), (1539, 1594)])
def test_tiled_launch_shape(k, kb):
    """The tiled instance's launch shape at the multiply's [kb, 3, n] and
    [k, 3, n] rows: each lane in the tiled instance; the same shared memory
    and threads at every k, within a block; the scratch rows whole tiles of
    words; a digits launch a thread per word; each product launch over
    every destination prime and word, in tiles; the scratch the lane's
    digit rows (SK: l and alpha; Floor: k; FloorSK: both and the floored
    kb)."""
    n = {109: 1024, 193: 65536, 384: 32768, 1539: 8192}[k]
    count, l = 3 * n, kb - 1
    tile_e, tile_j = rns_cuda.CONV_TILE_WORDS, rns_cuda.CONV_TILE_PRIMES
    rows = {"sk": l + 1, "floor": k, "floor_sk": k + kb + l + 1}
    for lane in rns_cuda.CONV_LANES:
        assert rns_cuda.conv_tiled(lane, kb, k)
        geo = rns_cuda.conv_tiled_geometry(count, lane, kb, k)
        assert (geo["threads"], geo["smem"]) == (256, rns_cuda.CONV_TILED_SMEM) == (256, 10496)
        assert geo["smem"] <= ntt_cuda.MAX_SMEM
        assert geo["pitch"] % tile_e == 0 and count <= geo["pitch"] < count + tile_e
        assert geo["scratch"] == rows[lane] * geo["pitch"]
        kinds = [s["kernel"] for s in geo["steps"]]
        assert kinds == ["digits", "product"] * (2 if lane == "floor_sk" else 1)
        for step in geo["steps"]:
            if step["kernel"] == "digits":
                assert step["blocks"] * geo["threads"] >= count > (step["blocks"] - 1) * 256
            else:
                tiles_j = -(-step["dst"] // tile_j)
                assert step["blocks"] == tiles_j * geo["pitch"] // tile_e
                assert tiles_j * tile_j >= step["dst"] > (tiles_j - 1) * tile_j
        products = [(s["src"], s["dst"]) for s in geo["steps"] if s["kernel"] == "product"]
        assert products == {"sk": [(l, k)], "floor": [(k, kb)],
                            "floor_sk": [(k, kb), (l, k)]}[lane]


# (lane, kb, k) -> the instance and its (per_thread, threads, blocks) at
# [kb, 3, 65536], as the parent's wrappers launched them
BELOW_CAPS = {("sk", 5, 3): ("fixed", (2, 256, 384)), ("floor", 5, 3): ("fixed", (1, 256, 768)),
              ("floor_sk", 17, 16): ("fixed", (1, 256, 768)),
              ("sk", 33, 30): ("wide", (1, 256, 768)), ("floor", 33, 32): ("wide", (1, 256, 768)),
              ("sk", 112, 108): ("deep", (1, 128, 1536)),
              ("floor", 112, 108): ("deep", (1, 128, 1536)),
              ("floor_sk", 68, 64): ("deep", (1, 128, 1536))}


@pytest.mark.parametrize("lane,kb,k", list(BELOW_CAPS))
def test_instances_below_the_caps_keep_their_shape(lane, kb, k):
    """Up to 108 q and 112 Bsk primes a call takes the fixed, wide or deep
    instance as before, with the same launch shape, and not the tiled one."""
    kind, shape = BELOW_CAPS[lane, kb, k]
    wide, deep = rns_cuda.conv_wide(lane, kb, k), rns_cuda.conv_deep(lane, kb, k)
    assert not rns_cuda.conv_tiled(lane, kb, k)
    assert (wide, deep) == {"fixed": (False, False), "wide": (True, False),
                            "deep": (True, True)}[kind]
    geo = rns_cuda.conv_geometry(3 * 65536, lane, wide, deep)
    assert (geo["per_thread"], geo["threads"], geo["blocks"]) == shape


def test_forced_tiled_takes_every_base_and_restores():
    """Inside forced_tiled() every call takes the tiled instance (the card's
    comparison of the tiled and deep instances below the caps); outside it
    and after an exception inside, the instances are as before."""
    assert not rns_cuda.conv_tiled("sk", 63, 59)
    with rns_cuda.forced_tiled():
        assert rns_cuda.conv_tiled("sk", 63, 59) and rns_cuda.conv_tiled("floor", 5, 3)
    assert not rns_cuda.conv_tiled("sk", 63, 59)
    with pytest.raises(RuntimeError), rns_cuda.forced_tiled():
        raise RuntimeError
    assert not rns_cuda.conv_tiled("floor", 5, 3)
    with pytest.raises(ValueError, match="unknown base-conversion lane"):
        rns_cuda.conv_tiled("lift", 5, 3)


def test_wrappers_take_the_largest_n65536_set_on_the_cpu():
    """fast_bconv_sk_fused (with the digits) and fast_floor_fused (with the
    conversion to q) at k = 193, kb = 201 on CPU tensors: no cap raises,
    the plain twins' residues come back, and no kernel launch is counted."""
    qs, bsk = _bases(193, 201)
    sk, fc = trns.make_sk(bsk[:-1], bsk[-1], qs, "cpu"), trns.make_fast_floor(qs, bsk, "cpu")
    inv_qhat = [pow(math.prod(qs) // p, -1, p) for p in qs]
    w = tmm.u32_tensor(np.array(inv_qhat, np.uint32), "cpu")
    digits = (w, tmm.u32_tensor(tmm.shoup_array(inv_qhat, qs), "cpu"))
    x_bsk = _t(_rows(bsk, "random", 6), 3)
    tx_q, tx_bsk = _t(_rows(qs, "random", 6), 3), _t(_rows(bsk, "random", 6), 3)
    before = (rns_cuda.fast_bconv_sk_fused.tiled_launches,
              rns_cuda.fast_floor_fused.tiled_launches)
    out, dig = rns_cuda.fast_bconv_sk_fused(x_bsk, sk, digits)
    want = trns.fast_bconv_sk_digits(x_bsk, sk, w)
    assert torch.equal(out, want[0]) and torch.equal(dig, want[1])
    got = rns_cuda.fast_floor_fused(tx_q, tx_bsk, fc, sk, digits)
    want = trns.fast_floor_sk(tx_q, tx_bsk, fc, sk, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (rns_cuda.fast_bconv_sk_fused.tiled_launches,
            rns_cuda.fast_floor_fused.tiled_launches) == before
