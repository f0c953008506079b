"""CUDA kernels of fhe_tpu_torch against their plain PyTorch versions, on the
card, at the slice's width (n = 8192, k = 3).  Integers, tolerance 0.

Every test here is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor fhe_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import functools
import math
import warnings

import numpy as np
import pytest
import torch

from fhe_tpu_torch import FHE, primes
from fhe_tpu_torch.ops import _build, decrypt_cuda, galois_cuda, ntt_cuda, ntt_mxu, rns_cuda
from fhe_tpu_torch.ops import galois as tgalois
from fhe_tpu_torch.ops import modmath as tmm
from fhe_tpu_torch.ops import ntt as tntt
from fhe_tpu_torch.ops import rns as trns
from fhe_tpu_torch.parallel import launch
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme import bfv, bgv
from fhe_tpu_torch.scheme import bootstrap as tbs
from fhe_tpu_torch.scheme.context import make_context
from fhe_tpu_torch.scheme.encoder import BatchEncoder
from fhe_tpu_torch.scheme.types import GaloisKeys, RelinKeys, SecretKey
from fhe_tpu_torch.utils import ubench

import torch_ranks

pytestmark = pytest.mark.cuda

N = 8192
RNG = np.random.default_rng(8192)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(t=65537):
    return make_scheme_params(SecurityParams(
        poly_degree=N, log_q=90, hamming_weight=64, plain_modulus=t))


def _residues(moduli, rows, dev, n=N):
    a = np.stack([RNG.integers(0, p, (rows, n), dtype=np.uint32)
                  for p in moduli])
    return torch.from_numpy(a.astype(np.int32)).to(dev)


@pytest.mark.parametrize("batch", [1, 16])
def test_ntt_kernels_match_plain(dev, batch):
    qs = _params().q_primes
    tb = tntt.build_tables(N, qs, dev)
    a = _residues(qs, batch, dev)
    assert torch.equal(ntt_cuda.ntt_forward(a, tb), tntt.ntt_forward(a, tb))
    assert torch.equal(ntt_cuda.ntt_inverse(a, tb), tntt.ntt_inverse(a, tb))


def test_ntt_kernels_mod_t_match_plain(dev):
    tt = tntt.build_tables(N, (65537,), dev)
    a = _residues((65537,), 1, dev)
    assert torch.equal(ntt_cuda.ntt_forward(a, tt), tntt.ntt_forward(a, tt))
    assert torch.equal(ntt_cuda.ntt_inverse(a, tt), tntt.ntt_inverse(a, tt))


def test_mul_by_ntt_operand_kernel_matches_plain(dev):
    qs = _params().q_primes
    tb = tntt.build_tables(N, qs, dev)
    u, w = _residues(qs, 1, dev), _residues(qs, 2, dev)
    assert torch.equal(ntt_cuda.mul_by_ntt_operand(u, w, tb),
                       tntt.mul_by_ntt_operand(u, w, tb))


@pytest.mark.parametrize("t", [65537, 786433])
@pytest.mark.parametrize("batch", [1, 8])
def test_decrypt_kernel_matches_plain(dev, t, batch):
    prm = _params(t)
    tb = tntt.build_tables(N, prm.q_primes, dev)
    dc = trns.make_decrypt(prm.q_primes, t, prm.gamma, dev)
    args = (_residues(prm.q_primes, batch, dev),
            _residues(prm.q_primes, batch, dev),
            _residues(prm.q_primes, 1, dev), tb, dc)
    assert torch.equal(decrypt_cuda.decrypt_fused(*args),
                       decrypt_cuda.decrypt_fused_plain(*args))


def test_decrypt_kernel_reads_component_views(dev):
    """The main path's decrypt: c0 and c1 as views of one [k, 2, n] tensor."""
    prm = _params()
    tb = tntt.build_tables(N, prm.q_primes, dev)
    dc = trns.make_decrypt(prm.q_primes, prm.t, prm.gamma, dev)
    ct = _residues(prm.q_primes, 2, dev)
    args = (ct[:, 0:1], ct[:, 1:2], _residues(prm.q_primes, 1, dev), tb, dc)
    assert torch.equal(decrypt_cuda.decrypt_fused(*args),
                       decrypt_cuda.decrypt_fused_plain(*args))


def test_slice_on_card(dev):
    fhe = FHE(poly_degree=N, log_q=90, hamming_weight=64, seed=5, device=dev)
    pk, sk = fhe.keygen()
    p1, p2 = fhe.encode([5, 10, 15, 20]), fhe.encode([3, 6, 9, 12])
    c1, c2 = fhe.encrypt(p1, pk), fhe.encrypt(p2, pk)
    assert list(fhe.decode(fhe.decrypt(fhe.add(c1, c2), sk))[:4]) == [8, 16, 24, 32]
    ct = fhe.to_ntt(c1)
    acc = None
    for i in range(8):
        term = fhe.multiply_plain(ct, fhe.encode([i + 1, 2 * i + 1, 3, 4]),
                                  cache_operand=True)
        acc = term if acc is None else fhe.add(acc, term)
    assert int(fhe.decode(fhe.decrypt(fhe.to_coeff(acc), sk))[0]) == 180


@pytest.fixture(scope="module")
def ctx(dev):
    return make_context(_params(), device=dev)


@pytest.mark.parametrize("t_folded", [True, False])
def test_tensor_product_kernel_matches_plain(ctx, dev, t_folded):
    tb = ctx.mul_tables[0] if t_folded else ctx.ntt_q
    x, y = _residues(tb.primes, 2, dev), _residues(tb.primes, 2, dev)
    assert torch.equal(ntt_cuda.tensor_product(x, y, tb),
                       tntt.tensor_product(x, y, tb))


def test_bsk_branch_kernel_matches_plain(ctx, dev):
    qs, tbsk = ctx.ntt_q.primes, ctx.mul_tables[1]
    assert tbsk.k == 5
    ab, tx_q = _residues(qs, 4, dev), _residues(qs, 3, dev)
    args = (ab, tx_q, ctx.smq, ctx.floor_c, tbsk)
    assert torch.equal(rns_cuda.bsk_branch_fused(*args), trns.bsk_branch_fused(*args))


@pytest.mark.parametrize("batch", [1, 3])
def test_fast_bconv_sk_kernel_matches_plain(ctx, dev, batch):
    xb = _residues(ctx.params.bsk_primes, batch, dev)
    assert torch.equal(rns_cuda.fast_bconv_sk_fused(xb, ctx.sk_c),
                       trns.fast_bconv_sk(xb, ctx.sk_c))


def test_keyswitch_kernel_matches_plain(ctx, dev):
    """Digits of every q prime against keys in the stored [kd, k, 2, n]
    layout, read through the prime-major view the relinearization passes."""
    qs = ctx.ntt_q.primes
    d = torch.cat([_residues((q,), 1, dev)[0] for q in qs])
    keys_t = torch.stack([_residues(qs, 2, dev) for _ in qs]).permute(1, 0, 2, 3)
    assert torch.equal(ntt_cuda.keyswitch_fused(d, keys_t, ctx.ntt_q),
                       tntt.keyswitch_fused(d, keys_t, ctx.ntt_q))


def test_multiply_on_card(dev):
    fhe = FHE(poly_degree=N, log_q=90, hamming_weight=64, seed=6, device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    c1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    c2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    m3 = fhe.multiply_no_relin(c1, c2)
    prod = fhe.multiply(c1, c2, rlk)
    for ct in (m3, fhe.relinearize(m3, rlk), prod):
        assert list(fhe.decode(fhe.decrypt(ct, sk))[:4]) == [15, 60, 135, 240]


# ---------------------------------------------------------------------------
# serving batches (B = 8) and rotations
# ---------------------------------------------------------------------------

BATCH = 8


def test_batch_ntt_kernels_match_plain(ctx, dev):
    """tensor_product_batch on views of a [B, k, 4, n] stack,
    keyswitch_fused_batch against the stored key layout, and
    mul_by_ntt_operand_batch on a strided [k, B, n] view."""
    qs, tq = ctx.ntt_q.primes, ctx.mul_tables[0]
    stack = _residues(qs, 4 * BATCH, dev).view(3, BATCH, 4, N).transpose(0, 1)
    ab = stack.contiguous().permute(1, 2, 0, 3)                  # [k, 4, B, n]
    assert torch.equal(ntt_cuda.tensor_product_batch(ab[:, :2], ab[:, 2:], tq),
                       tntt.tensor_product_batch(ab[:, :2], ab[:, 2:], tq))
    d = torch.stack([_residues((q,), BATCH, dev)[0] for q in qs])   # [kd, B, n]
    keys_t = torch.stack([_residues(qs, 2, dev) for _ in qs]).permute(1, 0, 2, 3)
    assert torch.equal(ntt_cuda.keyswitch_fused_batch(d, keys_t, ctx.ntt_q),
                       tntt.keyswitch_fused_batch(d, keys_t, ctx.ntt_q))
    u, w = ab[:, 1], _residues(qs, 2, dev)
    assert torch.equal(ntt_cuda.mul_by_ntt_operand_batch(u, w, ctx.ntt_q),
                       tntt.mul_by_ntt_operand_batch(u, w, ctx.ntt_q))


def test_bsk_branch_batch_kernel_matches_plain(ctx, dev):
    qs = ctx.ntt_q.primes
    ab = _residues(qs, 4 * BATCH, dev).view(3, 4, BATCH, N)
    tx_q = _residues(qs, 3 * BATCH, dev).view(3, 3, BATCH, N)
    args = (ab, tx_q, ctx.smq, ctx.floor_c, ctx.mul_tables[1])
    assert torch.equal(rns_cuda.bsk_branch_fused_batch(*args),
                       trns.bsk_branch_fused_batch(*args))


@pytest.mark.parametrize("lane", ["none", "shared", "per_element"])
def test_automorphism_kernel_matches_plain(ctx, dev, lane):
    qs, p = ctx.ntt_q.primes, ctx.ntt_q.p
    x = _residues(qs, 2 * BATCH, dev).view(3, 2, BATCH, N)
    hs = tuple(pow(g, -1, 2 * N) for g in range(3, 3 + 2 * BATCH, 2))
    c0 = {"none": None, "shared": _residues(qs, 1, dev)[:, 0],
          "per_element": _residues(qs, BATCH, dev)}[lane]
    assert torch.equal(galois_cuda.automorphism_fused(x, hs, p, c0),
                       tgalois.automorphism_fused(x, hs, p, c0))
    xs = x[:, :, 0].contiguous()
    assert torch.equal(galois_cuda.automorphism_single(xs, 2 * N - 1, p),
                       tgalois.automorphism_single(xs, 2 * N - 1, p))


def test_serving_and_rotations_on_card(dev):
    fhe = FHE(poly_degree=N, log_q=90, hamming_weight=64, seed=7, device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=(3, 2 * N - 1))
    vals = [[5 * (i + 1), 10, 15, 20] for i in range(BATCH)]
    cts = fhe.encrypt_batch([fhe.encode(v) for v in vals], pk)
    dec = lambda pts: [[int(x) for x in fhe.decode(pt)[:4]] for pt in pts]
    assert dec(fhe.decrypt_batch(cts, sk)) == vals
    prods = fhe.multiply_batch(cts, cts, rlk)
    assert dec(fhe.decrypt_batch(prods, sk)) == [[x * x for x in v] for v in vals]
    assert torch.equal(prods[3].data, fhe.multiply(cts[3], cts[3], rlk).data)
    rot = fhe.rotate_rows_batch(cts, 1, gk)
    assert dec(fhe.decrypt_batch(rot, sk)) == [v[1:] + [0] for v in vals]
    assert torch.equal(rot[2].data, fhe.rotate_rows(cts[2], 1, gk).data)
    cols = fhe.decode(fhe.decrypt(fhe.rotate_columns(cts[0], gk), sk))
    assert [int(x) for x in cols[N // 2:N // 2 + 4]] == vals[0]


# ---------------------------------------------------------------------------
# hoisted rotations (ks_inner_batch, ks_inner_grouped and their Galois lanes,
# automorphism_fused_sum), keyswitch_fused's Galois lane, and the prereduced
# lanes of keyswitch_fused / keyswitch_fused_batch
# ---------------------------------------------------------------------------

HOIST = tuple(pow(3, s, 2 * N) for s in range(1, 9))


@pytest.mark.parametrize("stacks", ["shared", "per_element"])
def test_ks_inner_batch_kernel_matches_plain(ctx, dev, stacks):
    """A shared digit stack against E = 8 key sets (the hoisted rotation),
    and one stack per element at B = 8."""
    qs, tb = ctx.ntt_q.primes, ctx.ntt_q
    dg = _residues(qs, 3 * (1 if stacks == "shared" else BATCH), dev).view(3, 3, -1, N)
    keys = _residues(qs, 3 * BATCH * 2, dev).view(3, 3, BATCH, 2, N)
    assert torch.equal(ntt_cuda.ks_inner_batch(dg, keys, tb),
                       tntt.ks_inner_batch(dg, keys, tb))


def test_ks_inner_grouped_kernel_matches_plain(ctx, dev):
    qs, tb = ctx.ntt_q.primes, ctx.ntt_q
    dg = _residues(qs, 3 * 4, dev).view(3, 3, 4, N)
    keys = _residues(qs, 3 * BATCH * 2, dev).view(3, 3, BATCH, 2, N)
    assert torch.equal(ntt_cuda.ks_inner_grouped(dg, keys, tb),
                       tntt.ks_inner_grouped(dg, keys, tb))


def _sum_stage_case(qs, tb, kd, elements, dev, n=N):
    """A sum_slots stage on the card (ks_inner_batch's Inner lane, then
    automorphism_fused_sum) and its plain chain; a run of c0 and of the
    digits is zero."""
    dg = _residues(qs, kd, dev, n).view(len(qs), kd, 1, n)
    keys = _residues(qs, kd * len(elements) * 2, dev, n).view(len(qs), kd, len(elements), 2, n)
    c0, base = _residues(qs, 1, dev, n)[:, 0], _residues(qs, 2, dev, n)
    c0[:, :64] = 0
    dg[..., :64] = 0
    hs = tuple(pow(g, -1, 2 * n) for g in elements)
    got = galois_cuda.automorphism_fused_sum(ntt_cuda.ks_inner_batch(dg, keys, tb), hs, tb.p,
                                             c0, base)
    want = tgalois.automorphism_fused_sum(tntt.ks_inner_batch(dg, keys, tb), hs, tb.p, c0, base)
    return got, want


def test_automorphism_sum_kernel_matches_plain(ctx, dev):
    """B15 at a sum_slots stage's E = 3; a run of x and of c0 is zero, so
    the negations meet zeros."""
    qs, p = ctx.ntt_q.primes, ctx.ntt_q.p
    hs = tuple(pow(g, -1, 2 * N) for g in HOIST[:3])
    x = _residues(qs, 2 * 3, dev).view(3, 2, 3, N)
    c0, base = _residues(qs, 1, dev)[:, 0], _residues(qs, 2, dev)
    x[..., :64] = 0
    c0[:, :64] = 0
    assert torch.equal(galois_cuda.automorphism_fused_sum(x, hs, p, c0, base),
                       tgalois.automorphism_fused_sum(x, hs, p, c0, base))


@pytest.mark.parametrize("case", ["E1", "E3", "E8", "k8_omega"])
def test_sum_stage_chain_matches_plain(ctx, dev, case):
    """A sum_slots stage, B17 then B15, at E = 1, 3 and 8, and at
    k8_omega's shapes (k = 8, the grouped digits' kd = 4), E = 3."""
    if case == "k8_omega":
        qs = _params_k8().q_primes
        tb, kd, elements = tntt.build_tables(N, qs, dev), 4, HOIST[:3]
    else:
        qs, tb, kd = ctx.ntt_q.primes, ctx.ntt_q, 3
        elements = HOIST[:int(case[1:])]
    got, want = _sum_stage_case(qs, tb, kd, elements, dev)
    assert got.shape == (len(qs), 2, N) and torch.equal(got, want)


@pytest.mark.parametrize("lane", ["shared", "per_element", "grouped"])
def test_ks_inner_galois_lane_matches_plain(ctx, dev, lane):
    """The hoisted rotations' lane: one stack and one c0 shared by E = 8
    elements, a stack and a c0 per element (B = 8), and C = 4 ciphertexts
    by E = 8 elements; a run of each c0 and digit row is zero."""
    qs, tb = ctx.ntt_q.primes, ctx.ntt_q
    keys = _residues(qs, 3 * BATCH * 2, dev).view(3, 3, BATCH, 2, N)
    if lane == "grouped":
        dg = _residues(qs, 3 * 4, dev).view(3, 3, 4, N)
        c0 = _residues(qs, 4, dev)
        c0[..., :64] = 0
        dg[..., :64] = 0
        got = ntt_cuda.ks_inner_grouped(dg, keys, tb, HOIST, c0)
        want = tntt.ks_inner_grouped(dg, keys, tb, HOIST, c0)
    else:
        stacks = 1 if lane == "shared" else BATCH
        dg = _residues(qs, 3 * stacks, dev).view(3, 3, stacks, N)
        c0 = _residues(qs, 1, dev)[:, 0] if lane == "shared" else _residues(qs, BATCH, dev)
        c0[..., :64] = 0
        dg[..., :64] = 0
        got = ntt_cuda.ks_inner_batch(dg, keys, tb, HOIST, c0)
        want = tntt.ks_inner_batch(dg, keys, tb, HOIST, c0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lane", ["galois", "sum"])
def test_ks_inner_lanes_at_n32768_match_plain(dev, lane):
    """At n = 32768 the Galois lane reads c0 in place (GaloisInPlace), so
    the hoisted rotation runs there, as does the sum_slots stage (k = 3,
    E = 3)."""
    n = 32768
    qs = primes.find_ntt_primes(n, 3)
    tb = tntt.build_tables(n, qs, dev)
    elements = tuple(pow(3, s, 2 * n) for s in range(1, 4))
    if lane == "sum":
        got, want = _sum_stage_case(qs, tb, 3, elements, dev, n)
    else:
        dg = _residues(qs, 3, dev, n).view(3, 3, 1, n)
        keys = _residues(qs, 3 * 3 * 2, dev, n).view(3, 3, 3, 2, n)
        c0 = _residues(qs, 1, dev, n)[:, 0]
        got = ntt_cuda.ks_inner_batch(dg, keys, tb, elements, c0)
        want = tntt.ks_inner_batch(dg, keys, tb, elements, c0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [None, BATCH])
def test_keyswitch_galois_lane_matches_plain(ctx, dev, batch):
    """A rotation in one launch: the digits of an un-permuted c1, g = 3,
    3^4 and 2n - 1, at B = 1 and 8; c0 read through a view of a
    [B, k, 2, n] stack; a run of c0 and of the digits is zero, so the
    negations meet zeros."""
    qs, tb = ctx.ntt_q.primes, ctx.ntt_q
    keys_t = torch.stack([_residues(qs, 2, dev) for _ in qs]).permute(1, 0, 2, 3)
    rows = batch or 1
    ct = _residues(qs, 2 * rows, dev).view(3, rows, 2, N).transpose(0, 1).contiguous()
    ct[..., :64] = 0
    c0 = ct.permute(1, 2, 0, 3)[:, 0]                                 # [k, B, n]
    d = torch.stack([_residues((q,), rows, dev)[0] for q in qs])      # [kd, B, n]
    d[..., :64] = 0
    for g in (3, pow(3, 4, 2 * N), 2 * N - 1):
        if batch is None:
            got = ntt_cuda.keyswitch_fused(d[:, 0], keys_t, tb, g=g, c0=c0[:, 0])
            want = tntt.keyswitch_fused(d[:, 0], keys_t, tb, g=g, c0=c0[:, 0])
        else:
            got = ntt_cuda.keyswitch_fused_batch(d, keys_t, tb, g=g, c0=c0)
            want = tntt.keyswitch_fused_batch(d, keys_t, tb, g=g, c0=c0)
        assert torch.equal(got, want), g


def _quiet_params(n, log_q, **kw):
    """Parameters below 128-bit security at this n are accepted here, as the
    JAX bench accepts them (the warning silenced)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q,
                                                 hamming_weight=64, **kw))


def _params_k8():
    """The JAX bench's k8_omega configuration."""
    return _quiet_params(N, 218, ks_omega=2)


@pytest.mark.parametrize("batch", [None, BATCH])
def test_keyswitch_prereduced_kernels_match_plain(dev, batch):
    """k = 8, kd = 4: the grouped digits of ks_omega = 2 at log_q = 218."""
    qs = _params_k8().q_primes
    tb = tntt.build_tables(N, qs, dev)
    keys_t = torch.stack([_residues(qs, 2, dev) for _ in range(4)]).permute(1, 0, 2, 3)
    if batch is None:
        d = _residues(qs, 4, dev)
        got = ntt_cuda.keyswitch_fused(d, keys_t, tb, prereduced=True)
    else:
        d = _residues(qs, 4 * batch, dev).view(8, 4, batch, N)
        got = ntt_cuda.keyswitch_fused_batch(d, keys_t, tb, prereduced=True)
    assert torch.equal(got, tntt.keyswitch_fused_batch(
        d if batch else d[:, :, None], keys_t, tb, prereduced=True).view(got.shape))


def test_hoisted_and_omega_on_card(dev):
    fhe = FHE(poly_degree=N, log_q=90, hamming_weight=64, seed=8, device=dev)
    pk, sk = fhe.keygen()
    gk = fhe.galoiskey_gen(sk, elements=HOIST[:3])
    ct = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    outs = fhe.rotate_rows_hoisted(ct, (1, 2, 3), gk)
    assert [int(fhe.decode(fhe.decrypt(o, sk))[0]) for o in outs] == [10, 15, 20]
    fhe8 = FHE(_params_k8(), seed=9, device=dev)
    pk8, sk8 = fhe8.keygen()
    rlk8 = fhe8.relinkey_gen(sk8)
    a, b = fhe8.encrypt(fhe8.encode([5, 10]), pk8), fhe8.encrypt(fhe8.encode([3, 6]), pk8)
    assert list(fhe8.decode(fhe8.decrypt(fhe8.multiply(a, b, rlk8), sk8))[:2]) == [15, 60]


# ---------------------------------------------------------------------------
# leveled BFV: the n < 1024 multiply's tensor_product Lift lane and
# fast_floor_fused, the modmul roofline probe, and a multiply at level 1
# against the CPU plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,log_q,level", [(N, 90, 0), (N, 90, 1), (256, 150, 2)])
def test_sm_mrq_and_fast_floor_kernels_match_plain(dev, n, log_q, level):
    """The products in q and, of the lifts, in Bsk (tensor_product's Lift
    lane) and the floor, at the headline shapes (k = 3, kb = 5, the halves
    of a multiply, also as views of one [k, 4, n] tensor) and at n = 256,
    k = 5 with the level's constants."""
    ctx = make_context(make_scheme_params(SecurityParams(
        poly_degree=n, log_q=log_q, hamming_weight=32)), device=dev)
    qs, (tq, tbsk) = ctx.ntt_q.primes[:ctx.k - level], ctx.mul_levels[level]
    bsk = tbsk.primes
    gen = np.random.default_rng(n + level)
    res = lambda moduli, rows: torch.from_numpy(np.stack(
        [gen.integers(0, p, (rows, n), dtype=np.uint32) for p in moduli]
    ).astype(np.int32)).to(dev)
    x = res(qs, 4)
    sc, fc = ctx.smq_levels[level], ctx.floor_levels[level]
    for a, b in ((x[:, :2].contiguous(), x[:, 2:].contiguous()), (x[:, :2], x[:, 2:])):
        got_q, got = ntt_cuda.tensor_product(a, b, tq, lift=(sc, tbsk))
        assert torch.equal(got_q, tntt.tensor_product(a, b, tq))
        assert torch.equal(got, trns.tensor_product_lift(a, b, sc, tbsk))
    tx_q, tx_bsk = res(qs, 3), res(bsk, 3)
    assert torch.equal(rns_cuda.fast_floor_fused(tx_q, tx_bsk, fc),
                       trns.fast_floor(tx_q, tx_bsk, fc))


@pytest.mark.parametrize("ilp", ubench.ILPS)
@pytest.mark.parametrize("variant", ubench.VARIANTS)
def test_modmul_chain_kernel_matches_plain(dev, variant, ilp):
    p = _params().q_primes[0]
    w = 123456789 % p
    x = _residues((p,), 64, dev)[0]
    args = (w, (w << 32) // p, p, (1 << 61) // p, 16, variant)
    assert torch.equal(ubench.modmul_chain(x, *args, unroll=8, ilp=ilp),
                       ubench.modmul_chain_plain(x, *args, ilp=ilp))
    if ilp == 1:
        assert torch.equal(ubench.modmul_chain(x, *args, unroll=1),
                           ubench.modmul_chain_plain(x, *args))


def test_leveled_multiply_on_card_matches_cpu(dev):
    """n = 8192, k = 3: mod_switch_to_next, the relinearization keys switched
    to level 1 and multiply at level 1 on the card equal the CPU plain path
    bit for bit, and decode."""
    fhe = FHE(poly_degree=N, log_q=90, hamming_weight=64, seed=10, device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk))
    b = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk))
    prod = fhe.multiply(a, b, rlk)
    assert list(fhe.decode(fhe.decrypt(prod, sk))[:4]) == [15, 60, 135, 240]
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    assert torch.equal(fhe._rlk_cache[(id(rlk), 1)].data.cpu(),
                       bfv.switch_relin_keys(cpu, rlk_cpu, 1).data)
    assert torch.equal(prod.data.cpu(),
                       bfv.multiply(cpu, to_cpu(a), to_cpu(b), rlk_cpu).data)


# ---------------------------------------------------------------------------
# bsk_branch_fused and decrypt_fused as thread-block clusters with the
# register-blocked sweep: more primes, batches, level views, t = 786433,
# n = 256 and n = 16384
# ---------------------------------------------------------------------------


# (n, log_q, t, level, batch): k = 8 (kb = 10), B = 8, level 1 (the Bsk
# suffix starts mid-tensor), t = 786433 tables, n = 256 batched (k = 5, the
# small path's multiply_batch), n = 16384 (the JAX bench's g_n16384)
BSK_CASES = [(N, 218, 65537, 0, None), (N, 218, 65537, 0, BATCH), (N, 90, 65537, 1, None),
             (N, 218, 65537, 2, BATCH), (N, 90, 786433, 0, None),
             (N, 90, 786433, 0, BATCH), (256, 150, 65537, 1, BATCH),
             (256, 150, 65537, 0, BATCH), (16384, 90, 65537, 0, None),
             (16384, 90, 65537, 0, 2), (32768, 90, 65537, 0, None), (32768, 90, 65537, 0, 2)]


@pytest.mark.parametrize("n,log_q,t,level,batch", BSK_CASES)
def test_bsk_branch_cluster_kernel_matches_plain(dev, n, log_q, t, level, batch):
    ctx = make_context(_quiet_params(n, log_q, plain_modulus=t), device=dev)
    qs = ctx.ntt_q.primes[:ctx.k - level]
    tbsk = ctx.mul_levels[level][1]
    sc, fc = ctx.smq_levels[level], ctx.floor_levels[level]
    if batch is None:
        ab, tx_q = _residues(qs, 4, dev, n), _residues(qs, 3, dev, n)
        args = (ab, tx_q, sc, fc, tbsk)
        assert torch.equal(rns_cuda.bsk_branch_fused(*args), trns.bsk_branch_fused(*args))
    else:
        # ab as views of a [B, k, 4, n] stack, as multiply_batch passes it
        stack = _residues(qs, 4 * batch, dev, n).view(len(qs), batch, 4, n).transpose(0, 1)
        ab = stack.contiguous().permute(1, 2, 0, 3)
        tx_q = _residues(qs, 3 * batch, dev, n).view(len(qs), 3, batch, n)
        args = (ab, tx_q, sc, fc, tbsk)
        assert torch.equal(rns_cuda.bsk_branch_fused_batch(*args),
                           trns.bsk_branch_fused_batch(*args))


# (n, log_q, t, level, batch): k = 8 and k = 12 (more primes than a
# cluster's 8 CTAs), B = 8, level 1 views, t = 786433, n = 16384, n = 256
DEC_CASES = [(N, 218, 65537, 0, 1), (N, 360, 65537, 0, 1), (N, 360, 786433, 0, BATCH),
             (N, 90, 65537, 1, 1), (N, 218, 65537, 3, BATCH), (N, 90, 786433, 0, BATCH),
             (16384, 90, 65537, 0, 1), (16384, 90, 786433, 0, BATCH),
             (256, 150, 65537, 2, BATCH), (32768, 90, 65537, 0, 1),
             (32768, 90, 786433, 0, BATCH)]


@pytest.mark.parametrize("n,log_q,t,level,batch", DEC_CASES)
def test_decrypt_cluster_kernel_matches_plain(dev, n, log_q, t, level, batch):
    prm = _quiet_params(n, log_q, plain_modulus=t)
    k = prm.k - level
    tb = tntt.slice_tables(tntt.build_tables(n, prm.q_primes, dev), k)
    dc = trns.make_decrypt(prm.q_primes[:k], t, prm.gamma, dev)
    ct = _residues(tb.primes, 2 * batch, dev, n).view(k, batch, 2, n)
    args = (ct[:, :, 0], ct[:, :, 1], _residues(tb.primes, 1, dev, n), tb, dc)
    assert torch.equal(decrypt_cuda.decrypt_fused(*args),
                       decrypt_cuda.decrypt_fused_plain(*args))


# ---------------------------------------------------------------------------
# mul_by_ntt_operand and tensor_product as thread-block clusters with the
# register-blocked sweep, and the n = 16384 multiply they let run
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cached_ctx(n, log_q, t, dev):
    return make_context(_quiet_params(n, log_q, plain_modulus=t), device=dev)


def _level_tables(ctx, level, tables):
    """The level-L tables a path passes: "q" the q primes' row views (encrypt,
    decrypt), "mul" the t-folded q tables (the multiply), "bsk" the
    t-folded Bsk suffix, mid-tensor (the n < 1024 multiply)."""
    if tables == "q":
        return tntt.slice_tables(ctx.ntt_q, ctx.k - level)
    return ctx.mul_levels[level][0 if tables == "mul" else 1]


# (n, log_q, t, level, batch, tables): n = 256 (k = 5), 8192 and 16384;
# level 1 of k = 3 and level 2 of k = 8 (row views of the tables); t = 786433
# (t-folded n^-1); B = 1, 2 and 8 (None: the single function)
PRODUCT_CASES = [(256, 150, 65537, 0, None, "q"), (256, 150, 65537, 1, None, "bsk"),
                 (256, 150, 65537, 1, BATCH, "mul"), (N, 90, 65537, 0, None, "q"),
                 (N, 90, 65537, 0, None, "mul"), (N, 90, 65537, 1, 2, "mul"),
                 (N, 218, 65537, 2, None, "q"), (N, 218, 65537, 2, BATCH, "mul"),
                 (N, 90, 786433, 0, None, "mul"), (N, 90, 786433, 0, BATCH, "mul"),
                 (16384, 90, 65537, 0, None, "q"), (16384, 90, 65537, 0, 2, "mul"),
                 (16384, 90, 786433, 0, BATCH, "mul"), (32768, 90, 65537, 0, None, "mul"),
                 (32768, 90, 65537, 0, 2, "mul")]


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("n,log_q,t,level,batch,tables", PRODUCT_CASES)
def test_mul_by_ntt_operand_cluster_kernel_matches_plain(dev, n, log_q, t, level, batch,
                                                         tables, c):
    """u read in place as one component of a [k, B, 2, n] stack (the decrypt
    of a 3-component ciphertext passes such a view), against c operand
    rows."""
    tb = _level_tables(_cached_ctx(n, log_q, t, dev), level, tables)
    rows = batch or 1
    u = _residues(tb.primes, 2 * rows, dev, n).view(tb.k, rows, 2, n)[:, :, 1]
    w = _residues(tb.primes, c, dev, n)
    if batch is None:
        assert torch.equal(ntt_cuda.mul_by_ntt_operand(u, w, tb),
                           tntt.mul_by_ntt_operand(u, w, tb))
    else:
        assert torch.equal(ntt_cuda.mul_by_ntt_operand_batch(u, w, tb),
                           tntt.mul_by_ntt_operand_batch(u, w, tb))


@pytest.mark.parametrize("n,log_q,t,level,batch,tables", PRODUCT_CASES)
def test_tensor_product_cluster_kernel_matches_plain(dev, n, log_q, t, level, batch,
                                                     tables):
    """The single function on two tensors (the multiply) or on the halves of
    one [k, 4, n] tensor (the n < 1024 multiply's Bsk side); the batch form
    on views of a [B, k, 4, n] stack (multiply_batch)."""
    tb = _level_tables(_cached_ctx(n, log_q, t, dev), level, tables)
    if batch is None:
        if tables == "bsk":
            lift = _residues(tb.primes, 4, dev, n)
            x, y = lift[:, :2], lift[:, 2:]
        else:
            x, y = _residues(tb.primes, 2, dev, n), _residues(tb.primes, 2, dev, n)
        assert torch.equal(ntt_cuda.tensor_product(x, y, tb), tntt.tensor_product(x, y, tb))
    else:
        stack = _residues(tb.primes, 4 * batch, dev, n).view(tb.k, batch, 4, n)
        ab = stack.transpose(0, 1).contiguous().permute(1, 2, 0, 3)
        assert torch.equal(ntt_cuda.tensor_product_batch(ab[:, :2], ab[:, 2:], tb),
                           tntt.tensor_product_batch(ab[:, :2], ab[:, 2:], tb))


@pytest.mark.parametrize("prereduced", [False, True])
def test_keyswitch_kernel_n16384_matches_plain(dev, prereduced):
    """B7 and B12, whose two padded rows per CTA fit at n = 16384, at that n
    (the relinearization of the n = 16384 multiply): kd = 3 digits of k = 3
    primes, or the grouped gadget's kd = 2 prereduced digits."""
    tb = _cached_ctx(16384, 90, 65537, dev).ntt_q
    qs, kd = tb.primes, 2 if prereduced else 3
    keys_t = torch.stack([_residues(qs, 2, dev, 16384) for _ in range(kd)]).permute(1, 0, 2, 3)
    if prereduced:
        d = _residues(qs, kd * 2, dev, 16384).view(3, kd, 2, 16384)
    else:
        d = torch.stack([_residues((q,), 2, dev, 16384)[0] for q in qs])
    assert torch.equal(ntt_cuda.keyswitch_fused(d[..., 0, :], keys_t, tb, prereduced),
                       tntt.keyswitch_fused(d[..., 0, :], keys_t, tb, prereduced))
    assert torch.equal(ntt_cuda.keyswitch_fused_batch(d, keys_t, tb, prereduced),
                       tntt.keyswitch_fused_batch(d, keys_t, tb, prereduced))


@pytest.mark.parametrize("lane", ["classic", "prereduced", "galois"])
def test_keyswitch_kernel_n32768_matches_plain(dev, lane):
    """B7 and B12 in their wide form at n = 32768 (partials in global
    scratch; the Galois lane reads its rows in place): kd = 3 digits of
    k = 3 primes, the grouped gadget's kd = 2 prereduced digits, and the
    Galois lane of a rotation by g = 3, single and at B = 2."""
    n = 32768
    tb = _cached_ctx(n, 90, 65537, dev).ntt_q
    qs, kd = tb.primes, 2 if lane == "prereduced" else 3
    keys_t = torch.stack([_residues(qs, 2, dev, n) for _ in range(kd)]).permute(1, 0, 2, 3)
    if lane == "prereduced":
        d = _residues(qs, kd * 2, dev, n).view(3, kd, 2, n)
    else:
        d = torch.stack([_residues((q,), 2, dev, n)[0] for q in qs])
    kw = dict(prereduced=lane == "prereduced")
    if lane == "galois":
        c0 = _residues(qs, 2, dev, n)
        kw = dict(g=3, c0=c0)
    one = {**kw, "c0": kw["c0"][:, 0]} if lane == "galois" else kw
    assert torch.equal(ntt_cuda.keyswitch_fused(d[..., 0, :], keys_t, tb, **one),
                       tntt.keyswitch_fused(d[..., 0, :], keys_t, tb, **one))
    assert torch.equal(ntt_cuda.keyswitch_fused_batch(d, keys_t, tb, **kw),
                       tntt.keyswitch_fused_batch(d, keys_t, tb, **kw))


def test_multiply_n32768_on_card_matches_cpu(dev):
    """tests/test_parallel.py:168-189's configuration (n = 32768,
    log_q = 90, k = 3, lambda_ = 0, h = 16, seed 11): [4, 5, 6] x [7, 8, 9]
    decodes [28, 40, 54], rotate_rows by 1 decodes, and the card's product
    and rotation equal the plain path's on the CPU bit for bit."""
    prm = make_scheme_params(SecurityParams(poly_degree=32768, log_q=90, lambda_=0,
                                            hamming_weight=16))
    fhe = FHE(prm, seed=11, device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=(3,))
    a = fhe.encrypt(fhe.encode([4, 5, 6]), pk)
    b = fhe.encrypt(fhe.encode([7, 8, 9]), pk)
    prod, rot = fhe.multiply(a, b, rlk), fhe.rotate_rows(a, 1, gk)
    assert list(fhe.decode(fhe.decrypt(prod, sk))[:3]) == [28, 40, 54]
    assert list(fhe.decode(fhe.decrypt(rot, sk))[:3]) == [5, 6, 0]
    cpu = make_context(prm, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    want = bfv.multiply(cpu, to_cpu(a), to_cpu(b), RelinKeys(data=rlk.data.cpu()))
    assert torch.equal(prod.data.cpu(), want.data)
    gk_cpu = GaloisKeys(data={g: v.cpu() for g, v in gk.data.items()})
    assert torch.equal(rot.data.cpu(), bfv.rotate_rows(cpu, to_cpu(a), 1, gk_cpu).data)


@pytest.mark.parametrize("omega", [1, 2])
def test_multiply_n16384_on_card_matches_cpu(dev, omega):
    """The JAX bench's g_n16384 (bench.py: log_q = 90, k = 3, seed 4) at
    ks_omega = 1 and 2: [5, 10] x [3, 6] decodes [15, 60], and the card's
    product equals the plain path's on the CPU bit for bit."""
    fhe = FHE(_quiet_params(16384, 90, ks_omega=omega), seed=4, device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([5, 10]), pk)
    b = fhe.encrypt(fhe.encode([3, 6]), pk)
    prod = fhe.multiply(a, b, rlk)
    assert list(fhe.decode(fhe.decrypt(prod, sk))[:2]) == [15, 60]
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    want = bfv.multiply(cpu, to_cpu(a), to_cpu(b), RelinKeys(data=rlk.data.cpu()))
    assert torch.equal(prod.data.cpu(), want.data)


# ---------------------------------------------------------------------------
# ntt_forward and keyswitch_fused as thread-block clusters with the
# register-blocked sweep
# ---------------------------------------------------------------------------


# (n, log_q, level, batch): n = 256 (k = 5), 8192, 16384; level 1 of k = 3
# and level 2 of k = 8 (row views of the tables); B = 1, 3 (keygen's
# [k, 3, n]) and 16
NTT_FORWARD_CASES = [(256, 150, 0, 1), (256, 150, 2, 3), (N, 90, 0, 3), (N, 90, 1, 16),
                     (N, 218, 2, 3), (16384, 90, 0, 1), (16384, 90, 0, 16)]


@pytest.mark.parametrize("n,log_q,level,batch", NTT_FORWARD_CASES)
def test_ntt_forward_cluster_kernel_matches_plain(dev, n, log_q, level, batch):
    tb = _level_tables(_cached_ctx(n, log_q, 65537, dev), level, "q")
    a = _residues(tb.primes, batch, dev, n)
    assert torch.equal(ntt_cuda.ntt_forward(a, tb), tntt.ntt_forward(a, tb))


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("t", [65537, 786433])
def test_ntt_forward_mod_t_matches_plain(dev, t, batch):
    """The encoder's transform mod the plaintext modulus: a 1-prime table of
    t, Shoup twiddles below 2^31."""
    tt = tntt.build_tables(N, (t,), dev)
    a = _residues((t,), batch, dev)
    assert torch.equal(ntt_cuda.ntt_forward(a, tt), tntt.ntt_forward(a, tt))


def test_ntt_forward_n32768_matches_plain(dev):
    """The JAX bench's g_n32768 input (bench.py: 3 NTT primes for n = 32768,
    one [1, 32768] row per prime from numpy seed 5)."""
    ps = primes.find_ntt_primes(32768, 3)
    x = np.stack([np.random.default_rng(5).integers(0, p, (1, 32768), dtype=np.uint32)
                  for p in ps])
    tb = tntt.build_tables(32768, ps, dev)
    a = torch.from_numpy(x.astype(np.int32)).to(dev)
    assert torch.equal(ntt_cuda.ntt_forward(a, tb), tntt.ntt_forward(a, tb))


# (n, log_q, level, kd, batch, prereduced): the headline kd = 3, its top
# level kd = 1 and level 1; k = 8 at kd = 8 (two digits per pair) and its
# level 2 (kd = 6); the grouped gadget's prereduced kd = 4 (k8_omega) and
# kd = 3 at its level 2; n = 256 (k = 5) at levels 0, 2 and 4 (kd = 1);
# n = 16384; B = 1 (None: the single function), 2 and 8
KEYSWITCH_CASES = [(N, 90, 0, 3, None, False), (N, 90, 0, 3, 2, False),
                   (N, 90, 0, 3, BATCH, False), (N, 90, 2, 1, None, False),
                   (N, 90, 2, 1, BATCH, False), (N, 90, 1, 2, None, False),
                   (N, 218, 0, 8, None, False), (N, 218, 0, 8, BATCH, False),
                   (N, 218, 2, 6, 2, False), (N, 218, 0, 4, None, True),
                   (N, 218, 0, 4, BATCH, True), (N, 218, 2, 3, 2, True),
                   (256, 150, 0, 5, None, False), (256, 150, 2, 3, BATCH, False),
                   (256, 150, 4, 1, None, False), (16384, 90, 0, 3, None, False),
                   (16384, 90, 0, 3, 2, False), (16384, 90, 0, 2, 2, True)]


def keyswitch_inputs(tb, kd: int, batch: int, prereduced: bool, n: int, dev):
    """Digits and keys as the key switch passes them: keys in the stored
    [kd, k, 2, n] layout read through the prime-major view; digit j mod its
    own q_j ([kd, B, n]), or per-prime residues ([k, kd, B, n])."""
    qs = tb.primes
    keys_t = torch.stack([_residues(qs, 2, dev, n) for _ in range(kd)]).permute(1, 0, 2, 3)
    if prereduced:
        d = _residues(qs, kd * batch, dev, n).view(tb.k, kd, batch, n)
    else:
        d = torch.stack([_residues((q,), batch, dev, n)[0] for q in qs[:kd]])
    return d, keys_t


@pytest.mark.parametrize("n,log_q,level,kd,batch,prereduced", KEYSWITCH_CASES)
def test_keyswitch_cluster_kernel_matches_plain(dev, n, log_q, level, kd, batch, prereduced):
    tb = _level_tables(_cached_ctx(n, log_q, 65537, dev), level, "q")
    d, keys_t = keyswitch_inputs(tb, kd, batch or 1, prereduced, n, dev)
    if batch is None:
        d = d[..., 0, :]
        assert torch.equal(ntt_cuda.keyswitch_fused(d, keys_t, tb, prereduced),
                           tntt.keyswitch_fused(d, keys_t, tb, prereduced))
    else:
        assert torch.equal(ntt_cuda.keyswitch_fused_batch(d, keys_t, tb, prereduced),
                           tntt.keyswitch_fused_batch(d, keys_t, tb, prereduced))


# ---------------------------------------------------------------------------
# ntt_inverse and ks_inner_batch / ks_inner_grouped as thread-block clusters
# with the register-blocked sweep
# ---------------------------------------------------------------------------


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of x whose storage starts one word past a 16-byte boundary, so
    the kernels read its rows a word at a time."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("n,log_q,level,batch", NTT_FORWARD_CASES)
def test_ntt_inverse_cluster_kernel_matches_plain(dev, n, log_q, level, batch):
    """B1's cases: n = 256, 8192 and 16384, level views, B = 1, 3 and 16."""
    tb = _level_tables(_cached_ctx(n, log_q, 65537, dev), level, "q")
    a = _residues(tb.primes, batch, dev, n)
    assert torch.equal(ntt_cuda.ntt_inverse(a, tb), tntt.ntt_inverse(a, tb))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [32, 32768])
def test_ntt_inverse_smallest_and_largest_n(dev, n, batch):
    """The sweep's smallest ring (one pass and a short one) and n = 32768
    (135 KB of shared memory per CTA), three NTT primes."""
    ps = primes.find_ntt_primes(n, 3)
    tb = tntt.build_tables(n, ps, dev)
    a = _residues(ps, batch, dev, n)
    assert torch.equal(ntt_cuda.ntt_inverse(a, tb), tntt.ntt_inverse(a, tb))


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("t", [65537, 786433])
def test_ntt_inverse_mod_t_matches_plain(dev, t, batch):
    tt = tntt.build_tables(N, (t,), dev)
    a = _residues((t,), batch, dev)
    assert torch.equal(ntt_cuda.ntt_inverse(a, tt), tntt.ntt_inverse(a, tt))


@pytest.mark.parametrize("t", [65537, 786433])
def test_ntt_inverse_encoder_view_and_unaligned_rows(dev, t):
    """The encoder's [1, 1, n] view of its slot row mod t, encode itself
    against the CPU encoder, and rows that start off a 16-byte boundary
    (read a word at a time)."""
    tt = tntt.build_tables(N, (t,), dev)
    row = _residues((t,), 1, dev)[0, 0]
    view = row.view(1, 1, N)
    assert torch.equal(ntt_cuda.ntt_inverse(view, tt), tntt.ntt_inverse(view, tt))
    odd = _unaligned(_residues((t,), 3, dev))
    assert torch.equal(ntt_cuda.ntt_inverse(odd, tt), tntt.ntt_inverse(odd, tt))
    prm = _params(t)
    vals = [int(v) for v in RNG.integers(0, t, 64)]
    card = BatchEncoder(prm, device=dev).encode(vals)
    assert torch.equal(card.data.cpu(), BatchEncoder(prm, device="cpu").encode(vals).data)


@pytest.mark.parametrize("log_q,level", [(90, 1), (218, 2)])
def test_ntt_inverse_key_down_switch_rows(dev, log_q, level):
    """The key down-switch's [k, 2 kd_l, n] rows: the stored [kd, k, 2, n]
    keys' first kd_l digits, prime-major, at level 0's tables."""
    ctx = _cached_ctx(N, log_q, 65537, dev)
    k = ctx.k
    kd_l = k - level
    keys = torch.stack([_residues(ctx.ntt_q.primes, 2, dev) for _ in range(k)])
    rows = keys[:kd_l].permute(1, 0, 2, 3).reshape(k, kd_l * 2, N)
    assert torch.equal(ntt_cuda.ntt_inverse(rows, ctx.ntt_q), tntt.ntt_inverse(rows, ctx.ntt_q))


# (n, log_q, level, kd, stacks, elements, grouped): kd = 1 (level 2 of
# k = 3), 3, 4 (level 4 of k = 8; level 1 of n = 256, k = 5) and 8 (k = 8);
# one digit stack shared by every element (stride 0) or one per element;
# C x E = 4 x 8 stacks by key sets (ks_inner_grouped); n = 256, 1024, 8192
# and 16384
KS_INNER_CASES = [(N, 90, 0, 3, 1, BATCH, False), (N, 90, 0, 3, BATCH, BATCH, False),
                  (N, 90, 2, 1, 1, BATCH, False), (N, 218, 0, 8, 1, BATCH, False),
                  (N, 218, 4, 4, 1, BATCH, False), (N, 218, 0, 8, BATCH, BATCH, False),
                  (N, 90, 0, 3, 4, BATCH, True), (N, 218, 4, 4, 4, BATCH, True),
                  (256, 150, 1, 4, 1, BATCH, False), (256, 150, 1, 4, 4, BATCH, True),
                  (1024, 90, 0, 3, 1, 3, False), (1024, 90, 0, 3, 2, 3, True),
                  (16384, 90, 0, 3, 1, BATCH, False), (16384, 90, 0, 3, 4, 2, True)]


def ks_inner_inputs(tb, kd: int, stacks: int, elements: int, dev):
    n = tb.n
    dg = _residues(tb.primes, kd * stacks, dev, n).view(tb.k, kd, stacks, n)
    keys = _residues(tb.primes, kd * elements * 2, dev, n).view(tb.k, kd, elements, 2, n)
    return dg, keys


@pytest.mark.parametrize("n,log_q,level,kd,stacks,elements,grouped", KS_INNER_CASES)
def test_ks_inner_cluster_kernel_matches_plain(dev, n, log_q, level, kd, stacks, elements,
                                               grouped):
    tb = _level_tables(_cached_ctx(n, log_q, 65537, dev), level, "q")
    dg, keys = ks_inner_inputs(tb, kd, stacks, elements, dev)
    name = "ks_inner_grouped" if grouped else "ks_inner_batch"
    assert torch.equal(getattr(ntt_cuda, name)(dg, keys, tb), getattr(tntt, name)(dg, keys, tb))


@pytest.mark.parametrize("grouped", [False, True])
def test_ks_inner_unaligned_rows_match_plain(ctx, dev, grouped):
    """Digits and keys that start off a 16-byte boundary, read a word at a
    time."""
    dg, keys = ks_inner_inputs(ctx.ntt_q, 3, 4 if grouped else 1, BATCH, dev)
    dg, keys = _unaligned(dg), _unaligned(keys)
    name = "ks_inner_grouped" if grouped else "ks_inner_batch"
    assert torch.equal(getattr(ntt_cuda, name)(dg, keys, ctx.ntt_q),
                       getattr(tntt, name)(dg, keys, ctx.ntt_q))


# ---------------------------------------------------------------------------
# the base-conversion kernel: fast_bconv_sk_fused (with the digits lane) and
# fast_floor_fused (the floor lane, and the floor with the conversion to q)
# ---------------------------------------------------------------------------


def _conv_equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


# (log_q, rows): [5,3,n] the multiply, [5,24,n] multiply_batch at B = 8,
# [10,3,n] the k8 multiply, [10,24,n] its batch; odd B = 3 and 9
@pytest.mark.parametrize("log_q,rows", [(90, 3), (90, 24), (218, 3), (218, 24), (90, 9),
                                        (218, 27)])
def test_fast_bconv_sk_digits_kernel_matches_plain(dev, log_q, rows):
    ctx = _cached_ctx(N, log_q, 65537, dev)
    xb = _residues(ctx.params.bsk_primes, rows, dev)
    digits = (ctx.inv_qhat, ctx.inv_qhat_shoup_levels[0])
    want = trns.fast_bconv_sk_digits(xb, ctx.sk_c, ctx.inv_qhat)
    assert _conv_equal(rns_cuda.fast_bconv_sk_fused(xb, ctx.sk_c, digits), want)
    assert torch.equal(rns_cuda.fast_bconv_sk_fused(xb, ctx.sk_c), want[0])


@pytest.mark.parametrize("rows", [3, 24])
def test_fast_bconv_sk_unaligned_rows_match_plain(ctx, dev, rows):
    """Rows that start off an 8-byte boundary, read a word at a time, at a
    shape that takes one word per thread and at one that takes two."""
    xb = _unaligned(_residues(ctx.params.bsk_primes, rows, dev))
    digits = (ctx.inv_qhat, ctx.inv_qhat_shoup_levels[0])
    assert _conv_equal(rns_cuda.fast_bconv_sk_fused(xb, ctx.sk_c, digits),
                       trns.fast_bconv_sk_digits(xb, ctx.sk_c, ctx.inv_qhat))


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("unaligned", [False, True])
def test_floor_sk_kernel_matches_plain(dev, level, unaligned):
    """The n = 256, k = 5 multiply's floor and conversion at the level's
    constants, with and without digits, and the floor lane alone."""
    ctx = _cached_ctx(256, 150, 65537, dev)
    qs, bsk = ctx.ntt_q.primes[:ctx.k - level], ctx.mul_levels[level][1].primes
    tx_q, tx_b = _residues(qs, 3, dev, 256), _residues(bsk, 3, dev, 256)
    if unaligned:
        tx_q, tx_b = _unaligned(tx_q), _unaligned(tx_b)
    fc, sk = ctx.floor_levels[level], ctx.sk_levels[level]
    w = ctx.inv_qhat_levels[level]
    digits = (w, ctx.inv_qhat_shoup_levels[level])
    assert _conv_equal(rns_cuda.fast_floor_fused(tx_q, tx_b, fc, sk, digits),
                       trns.fast_floor_sk(tx_q, tx_b, fc, sk, w))
    assert torch.equal(rns_cuda.fast_floor_fused(tx_q, tx_b, fc, sk),
                       trns.fast_floor_sk(tx_q, tx_b, fc, sk))
    assert torch.equal(rns_cuda.fast_floor_fused(tx_q, tx_b, fc), trns.fast_floor(tx_q, tx_b, fc))


# (k q primes, kb Bsk primes): the fixed instances' largest bases (kb = 16
# and 17, a floor from 16 q primes), the wide instance just above them
# (kb = 18; a floor from 17 q primes), the 128-bit n = 32768 set (k = 29,
# kb = 32), the top of the JAX package's security table (k = 30, kb = 33),
# a floor from 32 q primes (the wide instance's cap), and the deep instance
# from a floor from 33 (kb = 34) to the n = 65536 sets log_q = 1770 (k = 59,
# kb = 63) and 1920 (k = 64, kb = 68)
CONV_BASES = [(13, 16), (14, 17), (16, 17), (15, 18), (17, 18), (29, 32), (30, 33),
              (32, 33), (33, 34), (59, 63), (64, 68)]


@functools.lru_cache(maxsize=None)
def _conv_base(k, kb, dev):
    """k q primes and kb Bsk primes (kb - 1 aux, then m_sk), their SK and
    FastFloor constants, and the digits' (q/q_j)^-1 mod q_j with Shoup
    companions."""
    ps = primes.find_ntt_primes(N, k + kb)
    qs, bsk = ps[:k], ps[k:]
    inv_qhat = [pow(math.prod(qs) // p, -1, p) for p in qs]
    digits = (tmm.u32_tensor(np.array(inv_qhat, dtype=np.uint32), dev),
              tmm.u32_tensor(tmm.shoup_array(inv_qhat, qs), dev))
    return (qs, bsk, trns.make_sk(bsk[:-1], bsk[-1], qs, dev),
            trns.make_fast_floor(qs, bsk, dev), digits)


def _conv_rows(moduli, rows, inputs, dev, n=N):
    """Random residues ("random"), every residue p - 1 ("p-1"), or
    ("max digits") the residues whose conversion digits
    [x_i * (P/p_i)^-1]_{p_i} over the base P of ``moduli`` are all p_i - 1,
    the largest terms an unreduced sum of the kernel meets."""
    if inputs == "random":
        return _residues(moduli, rows, dev, n)
    big = math.prod(moduli)
    vals = [p - 1 if inputs == "p-1" else (p - 1) * (big // p) % p for p in moduli]
    return torch.stack([torch.full((rows, n), v, dtype=torch.int64)
                        for v in vals]).to(torch.int32).to(dev)


@pytest.mark.parametrize("inputs", ["random", "p-1", "max digits"])
@pytest.mark.parametrize("rows", [3, 24])
@pytest.mark.parametrize("k,kb", CONV_BASES)
def test_base_conv_kernel_every_base_matches_plain(dev, k, kb, rows, inputs):
    """Every lane of base_conv_kernel, fixed and wide instances, against its
    plain twin: the SK conversion with and without digits, the floor, and
    the floor with the conversion to q, on random residues, on every
    residue p - 1 and on the residues whose digits are all p - 1 (the aux
    rows of the SK input, the q rows of the floor's).  At 3 rows of
    n = 8192 a thread takes one word; at 24 the SK lane of a fixed instance
    takes two, the wide instance one."""
    qs, bsk, sk, fc, digits = _conv_base(k, kb, dev)
    wide = rns_cuda.conv_wide("sk", kb, k)
    assert wide == (kb > 17)
    assert rns_cuda.conv_geometry(rows * N, "sk", wide)["per_thread"] == (
        2 if rows == 24 and not wide else 1)
    # the m_sk row and the floor's Bsk rows are no digits: p - 1 stands for them
    plain = "random" if inputs == "random" else "p-1"
    xb = torch.cat([_conv_rows(bsk[:-1], rows, inputs, dev),
                    _conv_rows(bsk[-1:], rows, plain, dev)])
    want = trns.fast_bconv_sk_digits(xb, sk, digits[0])
    assert _conv_equal(rns_cuda.fast_bconv_sk_fused(xb, sk, digits), want)
    assert torch.equal(rns_cuda.fast_bconv_sk_fused(xb, sk), want[0])
    tx_q = _conv_rows(qs, rows, inputs, dev)
    tx_b = _conv_rows(bsk, rows, plain, dev)
    assert torch.equal(rns_cuda.fast_floor_fused(tx_q, tx_b, fc), trns.fast_floor(tx_q, tx_b, fc))
    assert _conv_equal(rns_cuda.fast_floor_fused(tx_q, tx_b, fc, sk, digits),
                       trns.fast_floor_sk(tx_q, tx_b, fc, sk, digits[0]))
    assert torch.equal(rns_cuda.fast_floor_fused(tx_q, tx_b, fc, sk),
                       trns.fast_floor_sk(tx_q, tx_b, fc, sk))


@pytest.mark.parametrize("inputs", ["random", "p-1"])
@pytest.mark.parametrize("log_q", [480, 510, 870, 1770])
def test_lift_lane_past_16_primes_matches_plain(dev, log_q, inputs):
    """tensor_product's Lift lane at n = 256 from k = 16, 17, 29 and 59 q
    primes (the lift loads them 16 at a time, in a loop over k) against its
    plain twins, on random residues and on every residue p - 1."""
    ctx = make_context(_quiet_params(256, log_q, lambda_=0), device=dev)
    assert ctx.k == -(-log_q // 30)
    (tq, tbsk), sc = ctx.mul_levels[0], ctx.smq_levels[0]
    x = _conv_rows(tq.primes, 4, inputs, dev, 256)
    a, b = x[:, :2], x[:, 2:]
    got_q, got = ntt_cuda.tensor_product(a, b, tq, lift=(sc, tbsk))
    assert torch.equal(got_q, tntt.tensor_product(a, b, tq))
    assert torch.equal(got, trns.tensor_product_lift(a, b, sc, tbsk))


def test_small_multiply_past_16_primes_on_card_matches_cpu(dev):
    """The n < 1024 multiply (the Lift lane and the FloorSK lane) at n = 256,
    log_q = 870 (k = 29), lambda_ = 0: [4, 5, 6] x [7, 8, 9] decodes
    [28, 40, 54] and equals the CPU plain path bit for bit."""
    prm = make_scheme_params(SecurityParams(poly_degree=256, log_q=870, lambda_=0,
                                            hamming_weight=16))
    fhe = FHE(prm, seed=11, device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a, b = (fhe.encrypt(fhe.encode(v), pk) for v in ([4, 5, 6], [7, 8, 9]))
    lifts = ntt_cuda.tensor_product.lift_launches
    prod = fhe.multiply(a, b, rlk)
    assert ntt_cuda.tensor_product.lift_launches == lifts + 1
    assert list(fhe.decode(fhe.decrypt(prod, sk))[:3]) == [28, 40, 54]
    cpu = make_context(prm, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    want = bfv.multiply(cpu, to_cpu(a), to_cpu(b), RelinKeys(data=rlk.data.cpu()))
    assert torch.equal(prod.data.cpu(), want.data)


def test_small_multiply_floors_and_converts_in_one_launch(dev):
    """The n = 256 multiply launches tensor_product's Lift lane once (both
    products and the lift), fast_floor_fused once, and neither
    tensor_product's plain lane nor a fast_bconv_sk_fused of its own, and
    equals the CPU plain path."""
    fhe = FHE(poly_degree=256, log_q=150, hamming_weight=32, seed=12, device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    b = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    fhe.multiply(a, b, rlk)
    torch.cuda.synchronize()
    floor0, sk0 = rns_cuda.fast_floor_fused.launches, rns_cuda.fast_bconv_sk_fused.launches
    lift0, plain0 = ntt_cuda.tensor_product.lift_launches, ntt_cuda.tensor_product.launches
    prod = fhe.multiply(a, b, rlk)
    torch.cuda.synchronize()
    assert ntt_cuda.tensor_product.lift_launches - lift0 == 1
    assert ntt_cuda.tensor_product.launches == plain0
    assert rns_cuda.fast_floor_fused.launches - floor0 == 1
    assert rns_cuda.fast_bconv_sk_fused.launches == sk0
    assert list(fhe.decode(fhe.decrypt(prod, sk))[:4]) == [15, 60, 135, 240]
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    assert torch.equal(prod.data.cpu(), bfv.multiply(cpu, to_cpu(a), to_cpu(b),
                                                     RelinKeys(data=rlk.data.cpu())).data)


def test_bgv_on_card(dev):
    """BGV through the facade at the headline width: the multiply (B4 on the
    plain q tables, then B7), multiply_batch (B11, B12), the mod switch and
    a rotation at level 1 (scale_t != 1) decode, launch no BFV-only kernel
    (B5, B6, B8), and equal the CPU plain path."""
    fhe = FHE(poly_degree=N, log_q=90, hamming_weight=64, seed=14, scheme="bgv",
              device=dev)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=(3,))
    dec = lambda ct: [int(x) for x in fhe.decode(fhe.decrypt(ct, sk))[:4]]
    a = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    b = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    torch.cuda.synchronize()
    before = (rns_cuda.bsk_branch_fused.launches, rns_cuda.fast_bconv_sk_fused.launches,
              decrypt_cuda.decrypt_fused.launches, ntt_cuda.tensor_product.launches)
    prod = fhe.multiply(a, b, rlk)
    batch = fhe.multiply_batch([a, b], [b, a], rlk)
    low = fhe.mod_switch_to_next(prod)
    rot = fhe.rotate_rows(low, 1, gk)
    assert dec(prod) == dec(low) == [15, 60, 135, 240] and dec(rot)[:3] == [60, 135, 240]
    assert [dec(c) for c in batch] == [[15, 60, 135, 240]] * 2
    torch.cuda.synchronize()
    after = (rns_cuda.bsk_branch_fused.launches, rns_cuda.fast_bconv_sk_fused.launches,
             decrypt_cuda.decrypt_fused.launches, ntt_cuda.tensor_product.launches)
    assert after[:3] == before[:3] and after[3] == before[3] + 1
    assert low.scale_t == fhe.params.q_primes[-1] % fhe.params.t
    cpu = make_context(fhe.params, device="cpu")
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    rlk_cpu = RelinKeys(data=rlk.data.cpu())
    prod_cpu = bgv.multiply(cpu, to_cpu(a), to_cpu(b), rlk_cpu)
    assert torch.equal(prod.data.cpu(), prod_cpu.data)
    assert all(torch.equal(x.data.cpu(), y.data) for x, y in zip(
        batch, bgv.multiply_batch(cpu, [to_cpu(a), to_cpu(b)], [to_cpu(b), to_cpu(a)],
                                  rlk_cpu)))
    low_cpu = bgv.mod_switch_to_next(cpu, prod_cpu)
    assert torch.equal(low.data.cpu(), low_cpu.data) and low.scale_t == low_cpu.scale_t
    rot_cpu = bgv.rotate_rows(cpu, low_cpu, 1, GaloisKeys(data={3: gk.data[3].cpu()}))
    assert torch.equal(rot.data.cpu(), rot_cpu.data)
    sk_cpu = SecretKey(data=sk.data.cpu())
    assert torch.equal(fhe.decrypt(low, sk).data.cpu(), bgv.decrypt(cpu, low_cpu, sk_cpu).data)
    assert fhe.estimate_noise_budget(prod, sk) == bgv.estimate_noise_budget(cpu, prod_cpu,
                                                                           sk_cpu)


def test_bootstrap_on_card(dev):
    """The bootstrapping pipeline at n = 256 (tests/test_bootstrap.py's
    configuration): bootstrap_binary (2n + 1 launches of keyswitch_fused: two
    external products per secret coefficient and the final key switch) and
    bootstrap_binary_batch (keyswitch_fused_batch for the external products)
    decode their bits and equal the CPU plain path bit for bit."""
    fhe = FHE(poly_degree=256, log_q=120, lambda_=0, hamming_weight=16, seed=21, device=dev)
    n = fhe.params.n
    pk, sk = fhe.keygen()
    bsk = fhe.make_bootstrap_key(sk)
    ks = tbs.keyswitch_keygen(fhe.ctx, fhe.gen, sk, sk)
    cts = [fhe.encrypt(fhe.encode_coeff([i % 2]), pk) for i in range(3)]
    torch.cuda.synchronize()
    ks_before = (ntt_cuda.keyswitch_fused.launches, ntt_cuda.keyswitch_fused_batch.launches)
    out = tbs.bootstrap_binary(fhe.ctx, None, cts[1], sk, bsk, ks)
    torch.cuda.synchronize()
    assert (ntt_cuda.keyswitch_fused.launches - ks_before[0],
            ntt_cuda.keyswitch_fused_batch.launches - ks_before[1]) == (2 * n + 1, 0)
    outs = tbs.bootstrap_binary_batch(fhe.ctx, cts, bsk, ks)
    assert ntt_cuda.keyswitch_fused_batch.launches - ks_before[1] == 2 * n
    assert [int(fhe.decode_coeff(fhe.decrypt(o, sk))[0]) for o in [out] + outs] == [1, 0, 1, 0]
    assert torch.equal(outs[1].data, out.data)
    cpu = make_context(fhe.params, device="cpu")
    sk_cpu = SecretKey(data=sk.data.cpu())
    bsk_cpu = tbs.BootstrapKey(pos=bsk.pos.cpu(), neg=bsk.neg.cpu(), level=0)
    to_cpu = lambda ct: ct.replace(data=ct.data.cpu())
    out_cpu = tbs.bootstrap_binary(cpu, None, to_cpu(cts[1]), sk_cpu, bsk_cpu, ks.cpu())
    assert torch.equal(out.data.cpu(), out_cpu.data) and out.noise_budget == out_cpu.noise_budget
    outs_cpu = tbs.bootstrap_binary_batch(cpu, [to_cpu(c) for c in cts], bsk_cpu, ks.cpu())
    assert all(torch.equal(x.data.cpu(), y.data) for x, y in zip(outs, outs_cpu))


@pytest.mark.parametrize("batch", [1, 2])
def test_polymul_negacyclic_on_card(dev, batch):
    """ntt_cuda.polymul_negacyclic (ntt_forward twice, ntt_inverse once)
    equals the plain twin on the same inputs."""
    qs = _params().q_primes
    tb = tntt.build_tables(N, qs, dev)
    a, b = _residues(qs, batch, dev), _residues(qs, batch, dev)
    fwd, inv = ntt_cuda.ntt_forward.launches, ntt_cuda.ntt_inverse.launches
    got = ntt_cuda.polymul_negacyclic(a, b, tb)
    assert (ntt_cuda.ntt_forward.launches - fwd, ntt_cuda.ntt_inverse.launches - inv) == (2, 1)
    assert torch.equal(got, tntt.polymul_negacyclic(a, b, tb))


@pytest.mark.parametrize("n,batch", [(256, 2), (N, 1), (N, 16), (16384, 1)])
def test_ntt_mxu_engine_on_card(dev, n, batch):
    """The four-step engine (torch._int_mm on the card) equals its CPU run,
    round-trips, and its polymul equals ntt_cuda.polymul_negacyclic."""
    qs = primes.find_ntt_primes(n, 3)
    tbm = ntt_mxu.build_mxu_tables(n, qs, device=dev)
    tbm_cpu = ntt_mxu.build_mxu_tables(n, qs, device="cpu")
    x, y = _residues(qs, batch, dev, n), _residues(qs, batch, dev, n)
    f = ntt_mxu.ntt_forward(x, tbm)
    assert torch.equal(f.cpu(), ntt_mxu.ntt_forward(x.cpu(), tbm_cpu))
    assert torch.equal(ntt_mxu.ntt_inverse(x, tbm).cpu(), ntt_mxu.ntt_inverse(x.cpu(), tbm_cpu))
    assert torch.equal(ntt_mxu.ntt_inverse(f, tbm), x)
    tb = tntt.build_tables(n, qs, dev)
    assert torch.equal(ntt_mxu.polymul_negacyclic(x, y, tbm),
                       ntt_cuda.polymul_negacyclic(x, y, tb))


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_mxu_multiply_on_card(dev, scheme):
    """FHE(use_mxu=True)'s multiply equals the default multiply's residues on
    the card and decodes; one BFV multiply launches the FloorSK lane and the
    key switch once each and no other conversion or product kernel."""
    fhe = FHE(_params(), seed=3, scheme=scheme, device=dev)
    fm = FHE(fhe.params, seed=3, scheme=scheme, device=dev, use_mxu=True)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a, b = (fhe.encrypt(fhe.encode(v), pk) for v in ([5, 10, 15, 20], [3, 6, 9, 12]))
    want = fhe.multiply(a, b, rlk)
    counters = (rns_cuda.fast_floor_fused, ntt_cuda.keyswitch_fused, ntt_cuda.tensor_product,
                rns_cuda.bsk_branch_fused, rns_cuda.fast_bconv_sk_fused)
    before = [f.launches for f in counters]
    got = fm.multiply(a, b, rlk)
    launched = [f.launches - b0 for f, b0 in zip(counters, before)]
    assert torch.equal(got.data, want.data)
    assert [int(v) for v in fm.decode(fm.decrypt(got, sk))[:4]] == [15, 60, 135, 240]
    assert launched == ([1, 1, 0, 0, 0] if scheme == "bfv" else [0, 1, 0, 0, 0])


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_sharded_multiply_on_card(dev, tmp_path, backend, world):
    """The rns-sharded multiply (fhe_tpu_torch.parallel.shard_scheme) and the
    coefficient-sharded one on the card, in an NCCL world of one rank and a
    gloo world of two ranks sharing the card, at n = 8192, k = 4: each
    equals the card's single-device multiply on every rank and decodes, and
    each rank launches tensor_product twice and keyswitch_fused once."""
    kw = dict(poly_degree=N, log_q=120, hamming_weight=64)
    make_context(make_scheme_params(SecurityParams(**kw)), device=dev)
    _build.load_all()                  # the kernels are built before any rank starts
    results = launch.start(torch_ranks.card_world, world, backend, args=(kw,),
                           workdir=tmp_path).wait(timeout=300)
    for res in results:
        assert res["backend"] == backend and res["device"].startswith("cuda")
        assert res["rns_equal"] and res["coeff_equal"]
        assert res["rns_decoded"] == [28, 40, 54]
        assert (res["tensor_product"], res["keyswitch_fused"]) == (2, 1)
