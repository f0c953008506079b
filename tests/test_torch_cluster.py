"""Launch geometry of the cluster kernels, on the host: ntt_forward (B1),
ntt_inverse (B2), mul_by_ntt_operand (B3, B13), tensor_product (B4, B11,
and B4's Lift lane at the n < 1024 multiply's rings),
bsk_branch_fused (B5), keyswitch_fused (B7, B12), decrypt_fused (B8),
ks_inner_batch / ks_inner_grouped (B17, B18), and the Galois lanes of B7
and B17.

The wrappers choose each launch's shape in plain Python (the C entry points
take it as given), so the choices are held here without a card: B8's
cluster size and primes per CTA, B3's CTAs per (element, operand row,
prime), B1's and B2's per row, B17's per (element, output row, prime), B4's
and B5's CTAs per prime, B7's digit pairs per (element, prime), threads and
shared memory per CTA, and the shared-memory checks that decide which n
each kernel takes, with the forms that take n = 32768 where the n <= 16384
layout does not fit a block (B4's and B5's half row, B7's and B8's wide
form), the compact split at n = 65536, where one padded row does not
fit (a padded half row per CTA; B4's and B5's transformed half rows and
B7's and B8's partials in global scratch), and the quarter split at
n = 131072, where a padded half row does not fit either (four CTAs a row,
a padded quarter row each); and from n = 262144, where no share of a row
fits a block, the column form: ordinary launches that meet in global
memory (csrc/column.cuh), up to n = 2097152, the largest ring the params
take.
tests/test_torch_cuda.py runs the kernels themselves."""

import numpy as np
import pytest

from fhe_tpu_torch.ops import decrypt_cuda, ntt_cuda, rns_cuda
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme.context import make_context

MAX_SMEM = ntt_cuda.MAX_SMEM


def padded(n: int) -> int:
    """Words of a padded row of n (one pad word in 32)."""
    return n + n // 32


def assert_owned_once(n: int, parts: int) -> None:
    """The positions [h n/parts, (h+1) n/parts) that CTA h of ``parts``
    sharing a row keeps (a pair's half rows; B8's epilogue, floor division)
    take every coefficient of the row exactly once."""
    hits = np.zeros(n, dtype=np.int64)
    for h in range(parts):
        hits[h * n // parts:(h + 1) * n // parts] += 1
    assert (hits == 1).all()


def assert_compact_form(geo: dict, n: int, scratch_per_cta: int) -> None:
    """The compact split at n = 65536: two CTAs per row, each holding its
    own half of the row in a padded half row (132 KB), inside a block and a
    portable cluster, every position owned by one CTA of the pair, and
    ``scratch_per_cta`` words of global scratch per CTA."""
    assert geo["compact"] and geo["ctas_per_row"] == 2 and geo["cluster"][0] <= 8
    assert geo["smem"] == 4 * padded(n // 2) <= MAX_SMEM < 4 * padded(n)
    assert geo["threads"] == 512
    assert geo.get("scratch", 0) == geo["ctas"] * scratch_per_cta
    assert_owned_once(n, geo["ctas_per_row"])


def assert_quarter_form(geo: dict, n: int, scratch_per_cta: int) -> None:
    """The quarter split at n = 131072: four CTAs per row, each holding its
    own quarter of the row in a padded quarter row (132 KB, where a padded
    half row takes 264 KB), inside a block and a portable cluster, every
    position owned by one CTA of the four, and ``scratch_per_cta`` words of
    global scratch per CTA."""
    assert geo["compact"] and geo["ctas_per_row"] == 4 and geo["cluster"][0] <= 8
    assert geo["smem"] == 4 * padded(n // 4) <= MAX_SMEM < 4 * padded(n // 2)
    assert geo["threads"] == 512
    assert geo.get("scratch", 0) == geo["ctas"] * scratch_per_cta
    assert_owned_once(n, geo["ctas_per_row"])


def assert_column_form(geo: dict, n: int, k: int, launches: int, scratch: int) -> None:
    """The column form at n: a block of b = 8192 positions (n/2 below
    n = 16384), s = log2(n / b) column stages on tiles of 2^13 words (at
    least a warp of adjacent columns), ``launches`` launches, none a
    cluster, each inside a block's shared memory and the grid, over k
    primes, and ``scratch`` words of rows between them."""
    b = min(8192, n // 2)
    s = (n // b).bit_length() - 1
    assert geo["column"] and geo["block"] == b and geo["column_stages"] == s
    assert geo["tile_columns"] == min(b, 8192 >> s) >= 32
    assert geo["launches"] == len(geo["steps"]) == launches
    assert geo["scratch"] == scratch
    assert "cluster" not in geo
    for step in geo["steps"]:
        assert step["smem"] <= geo["smem"] <= MAX_SMEM
        assert 32 <= step["threads"] <= 512 and step["grid"][1] <= 65535
        if step["kind"] in ("column", "decrypt"):
            tiles = step["grid"][0]
            rows = 3 if step["kind"] == "decrypt" else 1     # the tile (and two accumulators)
            assert tiles * geo["tile_columns"] == b and step["smem"] == 4 * rows * (n // tiles)
        else:
            assert step["grid"][0] == n // b and step["threads"] == min(b // 16, 512)
        assert step["grid"][2:] in ((), (k,))


def assert_half_row_form(geo: dict, n: int) -> None:
    """B4's and B5's shape at n = 32768: two CTAs per input row, each keeping
    its half of the transformed row in a padded half row beside the padded
    working row, inside a block and a portable cluster."""
    assert geo["half_row"] and geo["ctas_per_row"] == 2 and geo["cluster"] == (8, 1, 1)
    assert geo["smem"] == 4 * (padded(n) + padded(n // 2)) <= MAX_SMEM
    assert geo["threads"] == 512
    assert_owned_once(n, geo["ctas_per_row"])


@pytest.mark.parametrize("k", range(1, 17))
def test_decrypt_cluster_takes_every_prime_once(k):
    """C = min(k, 8) CTAs per ciphertext row; CTA r takes the primes
    r, r + C, ...: every prime exactly once, no CTA without one, and at most
    primes_per_cta each."""
    geo = decrypt_cuda.decrypt_geometry(8192, k, batch=3)
    c = min(k, 8)
    assert geo["cluster"] == (c, 1, 1) and geo["grid"] == (c, 3)
    assert geo["ctas"] == 3 * c
    taken = [list(range(r, k, c)) for r in range(c)]
    assert sorted(i for primes in taken for i in primes) == list(range(k))
    assert min(map(len, taken)) >= 1
    assert max(map(len, taken)) == geo["primes_per_cta"] == -(-k // c)


@pytest.mark.parametrize("n", [256, 1024, 4096, 8192, 16384, 32768])
def test_bsk_branch_cluster_per_prime(n):
    """A cluster of 8 CTAs, two per input row, for each (element, Bsk
    prime), each with two padded rows of shared memory (at n = 32768 a
    padded row and a padded half row) and a thread per group of 16 of its
    half row."""
    geo = rns_cuda.bsk_branch_geometry(n, kb=5, batch=8)
    assert geo["cluster"] == (8, 1, 1) and geo["ctas_per_prime"] == 8
    assert geo["ctas_per_row"] == 2
    assert geo["grid"] == (8, 8, 5) and geo["ctas"] == 8 * 8 * 5
    if n <= 16384:
        assert geo["smem"] == 2 * 4 * (n + n // 32) <= MAX_SMEM and not geo["half_row"]
    else:
        assert_half_row_form(geo, n)
    assert geo["threads"] == min(max(n // 32, 32), 512)


def test_n32768_does_not_fit_either_kernel():
    """At n = 32768 neither B5's two padded rows (270 KB) nor B8's three
    (396 KB) fit a block: B5 keeps only its half of the transformed row
    (198 KB), B8 its working row (132 KB) with the two accumulators of
    each CTA (2n words) in a global scratch buffer, and CTA r of B8's
    cluster sums coefficients [r n / C, (r + 1) n / C) in the epilogue.  At
    n = 65536 neither form fits: both take the compact split (B5 its
    transformed half rows in scratch, n/2 words per CTA; B8 a pair of CTAs
    per prime, 2 min(k, 4) per cluster, its accumulators n words per CTA);
    at n = 131072 the quarter split (B5 the same scratch, B8 four CTAs per
    prime, 4 min(k, 2) per cluster, its accumulators n/2 words per CTA);
    at n = 262144 each takes the column form (B5 three launches, its
    [kb, 4 + 3, B, n] rows between them; B8 three, 2 k B n words)."""
    n = 32768
    assert 2 * 4 * padded(n) > MAX_SMEM and 3 * 4 * padded(n) > MAX_SMEM
    assert_half_row_form(rns_cuda.bsk_branch_geometry(n, kb=5), n)
    for k, batch in ((3, 1), (3, 8), (8, 2), (12, 1)):
        geo = decrypt_cuda.decrypt_geometry(n, k=k, batch=batch)
        c = min(k, 8)
        assert geo["wide"] and geo["cluster"] == (c, 1, 1) and geo["grid"] == (c, batch)
        assert geo["smem"] == 4 * padded(n) <= MAX_SMEM and geo["threads"] == 512
        assert geo["scratch"] == 2 * n * c * batch
        assert_owned_once(n, c)
    assert_compact_form(rns_cuda.bsk_branch_geometry(65536, kb=5), 65536, 32768)
    for k in (1, 3, 8):
        geo = decrypt_cuda.decrypt_geometry(65536, k=k)
        assert geo["cluster"] == (2 * min(k, 4), 1, 1)
        assert_compact_form(geo, 65536, 65536)
    assert_quarter_form(rns_cuda.bsk_branch_geometry(131072, kb=5), 131072, 65536)
    for k in (1, 3, 8):
        geo = decrypt_cuda.decrypt_geometry(131072, k=k)
        assert geo["cluster"] == (4 * min(k, 2), 1, 1)
        assert_quarter_form(geo, 131072, 65536)
    n = 262144
    assert_column_form(rns_cuda.bsk_branch_geometry(n, kb=5), n, 5, 3, 7 * 5 * n)
    assert_column_form(decrypt_cuda.decrypt_geometry(n, k=3), n, 3, 3, 2 * 3 * n)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("n", [256, 1024, 8192, 16384])
def test_mul_by_ntt_operand_cluster_per_operand_row(n, c, batch):
    """A cluster of 2 CTAs for each (element, operand row, prime), sharing
    the row's transforms, each with one padded row of shared memory and a
    thread per group of 16 of its half row: 12 CTAs for encrypt's pk * u
    (k = 3, c = 2, B = 1), where one block per prime ran 3."""
    geo = ntt_cuda.mul_by_ntt_operand_geometry(n, k=3, c=c, batch=batch)
    assert geo["cluster"] == (2, 1, 1) and geo["ctas_per_row"] == 2
    assert geo["grid"] == (2, c * batch, 3) and geo["ctas"] == 2 * c * batch * 3
    assert geo["smem"] == 4 * (n + n // 32) <= MAX_SMEM
    assert geo["threads"] == min(max(n // 32, 32), 512)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("n", [256, 1024, 8192, 16384, 32768])
def test_tensor_product_cluster_per_prime(n, batch):
    """B5's shape: a cluster of 8 CTAs, two per input row x0, x1, y0, y1,
    for each (element, prime), two padded rows of shared memory each (at
    n = 32768 a padded row and a padded half row): 24 CTAs for the
    multiply's q side (k = 3), where one block per prime ran 3."""
    geo = ntt_cuda.tensor_product_geometry(n, k=3, batch=batch)
    assert geo == rns_cuda.bsk_branch_geometry(n, kb=3, batch=batch)
    assert geo["cluster"] == (8, 1, 1) and geo["ctas_per_prime"] == 8
    assert geo["grid"] == (8, batch, 3) and geo["ctas"] == 8 * batch * 3
    if n <= 16384:
        assert geo["smem"] == 2 * 4 * (n + n // 32) <= MAX_SMEM and not geo["half_row"]
    else:
        assert_half_row_form(geo, n)


@pytest.mark.parametrize("n", [32, 64, 128, 256, 512])
def test_tensor_product_lift_lane_takes_every_small_ring(n):
    """The n < 1024 multiply's products (B4's Lift lane: the q side and the
    lifted Bsk side in one launch) at every ring below 1024 the sweep takes
    (32 to 512) and every level of the leveled configuration (n = 256,
    log_q = 150, k = 5): B4's shape on the level's k + kb primes, a cluster
    of 8 CTAs per prime with two padded rows each, and a thread per
    coefficient of the CTA's half row for the lift; rings of 8 and 16
    raise, as for B4 alone."""
    ctx = make_context(make_scheme_params(SecurityParams(
        poly_degree=256, log_q=150, hamming_weight=32)), device="cpu")
    assert len(ctx.bsk_counts) == ctx.k == 5
    for level, kb in enumerate(ctx.bsk_counts):
        primes = ctx.k - level + kb
        geo = ntt_cuda.tensor_product_geometry(n, primes, lift=True)
        assert geo["grid"] == (8, 1, primes) and geo["cluster"] == (8, 1, 1)
        assert geo["ctas"] == 8 * primes and geo["threads"] == max(n // 2, 32)
        assert geo["smem"] == 2 * 4 * (n + n // 32) <= MAX_SMEM
        assert geo == {**ntt_cuda.tensor_product_geometry(n, primes), "threads": geo["threads"]}
    for small in (8, 16):
        with pytest.raises(ValueError, match="below 32"):
            ntt_cuda.tensor_product_geometry(small, ctx.k + ctx.bsk_counts[0], lift=True)


def test_n16384_fits_b3_b4_b5_and_b8_but_not_b4_at_n32768():
    """At n = 16384, B3's one, B4's and B5's two and B8's three padded rows
    fit a CTA, so the whole multiply runs there in that layout; B4's two
    rows at n = 32768 do not (B3's one row does), so there B4 keeps only
    its half of the transformed row (the multiply's and multiply_batch's
    shapes, k = 3); the Lift lane (n < 1024) has no half-row form; at
    n = 65536 B4 takes the compact form (the transformed half rows in
    scratch), at n = 131072 the compact form on the quarter split (the same
    scratch: the cluster's four transformed rows), and at n = 262144 the
    column form (four launches, no cluster; the Lift lane has none)."""
    assert ntt_cuda.mul_by_ntt_operand_geometry(16384, k=3, c=2)["smem"] == 67584
    assert ntt_cuda.tensor_product_geometry(16384, k=3)["smem"] == 135168
    assert rns_cuda.bsk_branch_geometry(16384, kb=5)["smem"] == 135168
    assert decrypt_cuda.decrypt_geometry(16384, k=3)["smem"] == 202752
    assert not decrypt_cuda.decrypt_geometry(16384, k=3)["wide"]
    assert 2 * 4 * padded(32768) > MAX_SMEM
    for batch in (1, 2):
        geo = ntt_cuda.tensor_product_geometry(32768, k=3, batch=batch)
        assert_half_row_form(geo, 32768)
        assert geo["smem"] == 202752 and geo["grid"] == (8, batch, 3)
    with pytest.raises(ValueError, match="tensor_product: n=32768 needs"):
        ntt_cuda.tensor_product_geometry(32768, k=3, lift=True)
    assert_compact_form(ntt_cuda.tensor_product_geometry(65536, k=3), 65536, 32768)
    assert_quarter_form(ntt_cuda.tensor_product_geometry(131072, k=3), 131072, 65536)
    assert_column_form(ntt_cuda.tensor_product_geometry(262144, k=3), 262144, 3, 4,
                       7 * 3 * 262144)
    assert ntt_cuda.mul_by_ntt_operand_geometry(32768, k=3, c=2)["smem"] == 135168


@pytest.mark.parametrize("n", [2, 16])
def test_cluster_ntt_kernels_need_n_of_32(n):
    """The register-blocked sweep takes n >= 32: B3 and B4 raise below, as
    B5 and B8 do, before any launch."""
    with pytest.raises(ValueError, match="mul_by_ntt_operand: n=.* below 32"):
        ntt_cuda.mul_by_ntt_operand_geometry(n, k=3, c=2)
    with pytest.raises(ValueError, match="tensor_product: n=.* below 32"):
        ntt_cuda.tensor_product_geometry(n, k=3)


@pytest.mark.parametrize("n,threads,split_threads", [
    (32, 32, 32), (256, 32, 32), (1024, 64, 32), (8192, 512, 256), (16384, 512, 512)])
def test_register_sweep_threads(n, threads, split_threads):
    """One group of 16 coefficients per thread and full pass, at least a
    warp and at most 512 threads (up to 128 registers each); where two CTAs
    share the row, one group of each CTA's half."""
    assert ntt_cuda.regs_threads(n, "x") == threads
    assert ntt_cuda.regs_threads(n, "x", split=2) == split_threads


def test_register_sweep_needs_n_of_32():
    for n in (2, 16):
        with pytest.raises(ValueError, match="below 32"):
            ntt_cuda.regs_threads(n, "decrypt_fused")
    with pytest.raises(ValueError, match="power of two"):
        ntt_cuda.regs_threads(24, "decrypt_fused")


def test_batch_outside_the_grid_raises():
    with pytest.raises(ValueError, match="batch"):
        ntt_cuda.mul_by_ntt_operand_geometry(8192, k=3, c=2, batch=32768)
    for batch in (0, 65536):
        with pytest.raises(ValueError, match="batch"):
            ntt_cuda.tensor_product_geometry(8192, k=3, batch=batch)
        with pytest.raises(ValueError, match="batch"):
            rns_cuda.bsk_branch_geometry(8192, kb=5, batch=batch)
        with pytest.raises(ValueError, match="batch"):
            decrypt_cuda.decrypt_geometry(8192, k=3, batch=batch)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("kd", [1, 3, 4, 8])
@pytest.mark.parametrize("n", [256, 1024, 8192, 16384, 32768])
def test_keyswitch_cluster_of_digit_pairs(n, kd, batch):
    """A cluster of 2R CTAs per (element, prime), R = clamp(kd, 2, 4) digit
    pairs: two pairs at least (one per output row), at most 8 CTAs (the
    portable cluster size), so kd = 8 takes two digits per pair; two padded
    rows of shared memory (at n = 32768 the wide form: one, and n words of
    global scratch per CTA) and a thread per group of 16 of a half row: 18
    CTAs for the headline relinearization (k = 3, kd = 3), where one block
    per prime ran 3."""
    geo = ntt_cuda.keyswitch_geometry(n, k=3, kd=kd, batch=batch)
    pairs = min(max(kd, 2), 4)
    assert geo["pairs"] == pairs
    assert geo["cluster"] == (2 * pairs, 1, 1) and geo["ctas_per_row"] == 2
    assert geo["grid"] == (2 * pairs, batch, 3) and geo["ctas"] == 2 * pairs * batch * 3
    if n <= 16384:
        assert geo["smem"] == 2 * 4 * (n + n // 32) <= MAX_SMEM
        assert not geo["wide"] and geo["scratch"] == 0
    else:
        assert geo["wide"] and geo["smem"] == 4 * padded(n) <= MAX_SMEM
        assert geo["scratch"] == geo["ctas"] * n
    assert geo["threads"] == min(max(n // 32, 32), 512)
    # pair r takes digits r, r + R, ...: every digit exactly once, in at
    # most two rounds (kd <= 8)
    taken = [list(range(r, kd, pairs)) for r in range(pairs)]
    assert sorted(j for ds in taken for j in ds) == list(range(kd))
    assert max(map(len, taken)) == -(-kd // pairs) <= 2


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("n", [256, 1024, 8192, 16384, 32768])
def test_ntt_forward_cluster_per_row(n, batch):
    """A cluster of 2 CTAs for each (row, prime), the batch on grid x, one
    padded row of shared memory each: 6 CTAs at [3, 1, 8192], where one
    block per row ran 3; n = 32768 fits (135 KB)."""
    geo = ntt_cuda.ntt_forward_geometry(n, k=3, batch=batch)
    assert geo["cluster"] == (2, 1, 1) and geo["ctas_per_row"] == 2
    assert geo["grid"] == (2 * batch, 3) and geo["ctas"] == 2 * batch * 3
    assert geo["smem"] == 4 * (n + n // 32) <= MAX_SMEM
    assert geo["threads"] == min(max(n // 32, 32), 512)


def test_n32768_fits_b1_but_not_b7():
    """B1's one padded row fits at n = 32768; B7's two do not, so there it
    takes its wide form: the working row alone in shared memory (B1's
    135 KB) and the two partial half rows of each CTA (n words: positions
    [h n/2, (h+1) n/2) of both output rows) in a global scratch buffer, for
    the relinearization (kd = 3) and multiply_batch's B = 2 alike; at
    n = 65536 it takes the wide form on the compact split (a padded half
    row per CTA, the same scratch), at n = 131072 the wide form on the
    quarter split (two digit groups of four CTAs, n/2 words of scratch per
    CTA), and at n = 262144 the column form (the kd digits' rows and the two
    partial rows in scratch)."""
    n = 32768
    assert ntt_cuda.ntt_forward_geometry(n, k=3)["smem"] == 135168
    assert ntt_cuda.keyswitch_geometry(16384, k=3, kd=3)["smem"] == 135168
    assert 2 * 4 * padded(n) > MAX_SMEM
    for batch in (1, 2):
        geo = ntt_cuda.keyswitch_geometry(n, k=3, kd=3, batch=batch)
        assert geo["wide"] and geo["smem"] == 135168 and geo["cluster"] == (6, 1, 1)
        assert geo["scratch"] == 6 * batch * 3 * n and geo["threads"] == 512
        assert_owned_once(n, geo["ctas_per_row"])
    geo = ntt_cuda.keyswitch_geometry(65536, k=3, kd=3)
    assert geo["wide"] and geo["cluster"] == (6, 1, 1)
    assert_compact_form(geo, 65536, 65536)
    geo = ntt_cuda.keyswitch_geometry(131072, k=3, kd=3)
    assert geo["wide"] and geo["pairs"] == 2 and geo["cluster"] == (8, 1, 1)
    assert_quarter_form(geo, 131072, 65536)
    assert_column_form(ntt_cuda.keyswitch_geometry(262144, k=3, kd=3), 262144, 3, 3,
                       3 * (3 + 2) * 262144)


@pytest.mark.parametrize("n", [2, 16])
def test_b1_and_b7_need_n_of_32(n):
    """The register-blocked sweep takes n >= 32: B1 and B7 raise below, as
    B3 and B4 do, before any launch."""
    with pytest.raises(ValueError, match="ntt_forward: n=.* below 32"):
        ntt_cuda.ntt_forward_geometry(n, k=3)
    with pytest.raises(ValueError, match="keyswitch_fused: n=.* below 32"):
        ntt_cuda.keyswitch_geometry(n, k=3, kd=3)
    with pytest.raises(ValueError, match="keyswitch_fused_batch: n=.* below 32"):
        ntt_cuda.keyswitch_geometry(n, k=3, kd=3, batch=8, name="keyswitch_fused_batch")


def test_b1_and_b7_batch_and_digits_outside_the_grid_raise():
    for batch in (0, 2 ** 30):
        with pytest.raises(ValueError, match="ntt_forward: batch"):
            ntt_cuda.ntt_forward_geometry(8192, k=3, batch=batch)
    for batch in (0, 65536):
        with pytest.raises(ValueError, match="keyswitch_fused: batch"):
            ntt_cuda.keyswitch_geometry(8192, k=3, kd=3, batch=batch)
    with pytest.raises(ValueError, match="kd=0"):
        ntt_cuda.keyswitch_geometry(8192, k=3, kd=0)


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("n", [256, 8192, 16384, 32768])
def test_ntt_inverse_cluster_per_row(n, batch):
    """B1's shape, the mirror transform: a cluster of 2 CTAs for each (row,
    prime), the batch on grid x, one padded row of shared memory each: 6
    CTAs at the encoder's [1, 1, 8192] x 3 rows, where one block per row
    ran 3; n = 32768 fits (135 KB)."""
    geo = ntt_cuda.ntt_inverse_geometry(n, k=3, batch=batch)
    assert geo == ntt_cuda.ntt_forward_geometry(n, k=3, batch=batch)
    assert geo["cluster"] == (2, 1, 1) and geo["ctas_per_row"] == 2
    assert geo["grid"] == (2 * batch, 3) and geo["ctas"] == 2 * batch * 3
    assert geo["smem"] == 4 * (n + n // 32) <= MAX_SMEM
    assert geo["threads"] == min(max(n // 32, 32), 512)


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("n", [256, 8192, 16384, 32768])
def test_ks_inner_cluster_per_output_row(n, batch):
    """A cluster of 2 CTAs for each (element, output row, prime), grid
    (2, 2B, k), one padded row of shared memory each: 96 CTAs for the
    hoisted rotations' 8 elements at k = 3, where one block per (element,
    prime) ran 24, and 384 for the hoisted batch's 4 x 8."""
    geo = ntt_cuda.ks_inner_geometry(n, k=3, batch=batch)
    assert geo["cluster"] == (2, 1, 1) and geo["ctas_per_row"] == 2
    assert geo["grid"] == (2, 2 * batch, 3) and geo["ctas"] == 2 * 2 * batch * 3
    assert geo["smem"] == 4 * (n + n // 32) <= MAX_SMEM
    assert geo["threads"] == min(max(n // 32, 32), 512)


GEOMETRY_OF = {"ntt_inverse": lambda n, batch=1: ntt_cuda.ntt_inverse_geometry(n, 3, batch),
               "ks_inner_batch": lambda n, batch=1: ntt_cuda.ks_inner_geometry(n, 3, batch),
               "ks_inner_grouped": lambda n, batch=1: ntt_cuda.ks_inner_geometry(
                   n, 3, batch, name="ks_inner_grouped")}


@pytest.mark.parametrize("name", sorted(GEOMETRY_OF))
@pytest.mark.parametrize("n,match", [(2, "below 32"), (16, "below 32"),
                                     (65536, "n=65536 needs")])
def test_b2_and_b17_n_outside_32_to_32768_raises(name, n, match):
    """The register-blocked sweep takes n >= 32, and one padded row fits a
    CTA up to n = 32768: below 32 B2 and B17/B18 raise, naming the
    function, before any launch.  Both take n = 65536 on the compact split
    (a padded half row per CTA), n = 131072 on the quarter split (a padded
    quarter row) and n = 262144 in the column form (two launches, 1 or 2
    rows of scratch per input row); their top case is the ring past the
    params', n = 4194304, where the column form's tile holds fewer than a
    warp of columns and they raise."""
    if n == 65536:
        assert_compact_form(GEOMETRY_OF[name](n), n, 0)
        assert_quarter_form(GEOMETRY_OF[name](2 * n), 2 * n, 0)
        rows = 1 if name == "ntt_inverse" else 2
        assert_column_form(GEOMETRY_OF[name](4 * n), 4 * n, 3, 2, rows * 3 * 4 * n)
        n, match = 64 * n, "n=4194304 has no column form"
    with pytest.raises(ValueError, match=f"{name}: .*{match}"):
        GEOMETRY_OF[name](n)


@pytest.mark.parametrize("name,batch", [("ntt_inverse", 0), ("ntt_inverse", 2 ** 30),
                                        ("ks_inner_batch", 0), ("ks_inner_batch", 32768),
                                        ("ks_inner_grouped", 32768)])
def test_b2_and_b17_batch_outside_the_grid_raises(name, batch):
    with pytest.raises(ValueError, match=f"{name}: batch {batch} outside"):
        GEOMETRY_OF[name](8192, batch)


@pytest.mark.parametrize("n", [32, 256, 8192, 16384, 32768])
@pytest.mark.parametrize("elems", [1, 2, 3, 8])
def test_ks_inner_galois_lane_cluster_per_element_row(n, elems):
    """The Galois lane of ks_inner (the hoisted rotations) keeps the Inner
    lane's grid, a cluster of 2 CTAs per (element, output row, prime), and
    adds the staged c0 row to its shared memory where both fit a block."""
    geo = ntt_cuda.ks_inner_geometry(n, k=3, batch=elems, c0=True)
    inner = ntt_cuda.ks_inner_geometry(n, k=3, batch=elems)
    assert {key: geo[key] for key in ("grid", "cluster", "ctas", "threads")} == {
        key: inner[key] for key in ("grid", "cluster", "ctas", "threads")}
    padded = n + n // 32
    staged = 4 * (-(-padded // 4) * 4 + n)
    assert geo["stage_c0"] == (staged <= MAX_SMEM) == (n <= 16384)
    assert geo["smem"] == (staged if n <= 16384 else 4 * padded)


def test_galois_lanes_stage_a_row_and_ks_inner_runs_at_n32768():
    """keyswitch_fused's Galois lane stages the digit row it gathers from
    beside its two padded rows up to n = 16384; at n = 32768 it takes the
    classic lane's wide form (the working row alone, partials in global
    scratch) and reads the digit rows and c0 in place; at n = 65536 the
    classic lane's wide form on the compact split, at n = 131072 on the
    quarter split, and at n = 262144 the classic lane's column form; its
    classic lane keeps its shape.
    ks_inner's Galois lane stages c0 where it fits and reads it in place at
    n = 32768."""
    n = 16384
    padded = n + n // 32
    assert ntt_cuda.keyswitch_geometry(n, 3, 3, galois=True)["smem"] == 4 * (2 * padded + n)
    assert ntt_cuda.keyswitch_geometry(n, 3, 3)["smem"] == 4 * 2 * padded
    assert not ntt_cuda.keyswitch_geometry(n, 3, 3, galois=True)["wide"]
    for batch in (1, 2):
        geo = ntt_cuda.keyswitch_geometry(32768, 3, 3, batch, galois=True)
        assert geo == ntt_cuda.keyswitch_geometry(32768, 3, 3, batch)
        assert geo["wide"] and geo["smem"] == 4 * (32768 + 32768 // 32) <= MAX_SMEM
    geo = ntt_cuda.keyswitch_geometry(65536, 3, 3, 2, "keyswitch_fused_batch", galois=True)
    assert geo == ntt_cuda.keyswitch_geometry(65536, 3, 3, 2)
    assert_compact_form(geo, 65536, 65536)
    geo = ntt_cuda.keyswitch_geometry(131072, 3, 3, 2, "keyswitch_fused_batch", galois=True)
    assert geo == ntt_cuda.keyswitch_geometry(131072, 3, 3, 2)
    assert_quarter_form(geo, 131072, 65536)
    geo = ntt_cuda.keyswitch_geometry(262144, 3, 3, 2, "keyswitch_fused_batch", galois=True)
    assert geo == ntt_cuda.keyswitch_geometry(262144, 3, 3, 2)
    assert_column_form(geo, 262144, 3, 3, 3 * (3 + 2) * 2 * 262144)
    # ks_inner stages its c0 row where it fits (n <= 16384), and reads it in
    # place above
    geo = ntt_cuda.ks_inner_geometry(n, 3, 8, c0=True)
    assert geo["stage_c0"] and geo["smem"] == 4 * (padded + n)
    geo = ntt_cuda.ks_inner_geometry(32768, 3, 8, c0=True)
    assert not geo["stage_c0"] and geo["smem"] == 4 * (32768 + 32768 // 32)
    assert not ntt_cuda.ks_inner_geometry(n, 3, 8)["stage_c0"]


N65536 = 65536


@pytest.mark.parametrize("batch,name", [(1, "ks_inner_batch"), (8, "ks_inner_batch"),
                                        (4 * 8, "ks_inner_grouped")])
@pytest.mark.parametrize("c0", [False, True])
def test_ks_inner_compact_split_at_n65536(batch, name, c0):
    """B17/B18 at n = 65536, both lanes, for the hoisted rotations' B = 1
    and 8 elements and the hoisted batch's S = 4 stacks x 8: the compact
    split, a 135168-byte padded half row per CTA, c0 read in place (never
    staged) and no scratch, in the Inner lane's grid; every n <= 32768
    keeps its one padded row (and its staged c0 up to 16384); n = 131072
    takes the quarter split (clusters of 4), and n = 262144 the column
    form (the c0 add in its column launch)."""
    geo = ntt_cuda.ks_inner_geometry(N65536, 3, batch, name=name, c0=c0)
    assert geo["smem"] == 135168 == 4 * padded(N65536 // 2)
    assert not geo["stage_c0"] and "scratch" not in geo
    assert geo["grid"] == (2, 2 * batch, 3) and geo["cluster"] == (2, 1, 1)
    assert_compact_form(geo, N65536, 0)
    for n in (256, 8192, 16384, 32768):
        small = ntt_cuda.ks_inner_geometry(n, 3, batch, name=name, c0=c0)
        assert not small["compact"] and small["stage_c0"] == (c0 and n <= 16384)
        assert small["smem"] == (4 * (-(-padded(n) // 4) * 4 + n) if small["stage_c0"]
                                 else 4 * padded(n))
    geo = ntt_cuda.ks_inner_geometry(2 * N65536, 3, batch, name=name, c0=c0)
    assert geo["grid"] == (4, 2 * batch, 3) and geo["cluster"] == (4, 1, 1)
    assert not geo["stage_c0"]
    assert_quarter_form(geo, 2 * N65536, 0)
    geo = ntt_cuda.ks_inner_geometry(4 * N65536, 3, batch, name=name, c0=c0)
    assert_column_form(geo, 4 * N65536, 3, 2, 2 * 3 * batch * 4 * N65536)


@pytest.mark.parametrize("kb", [34, 63, 68])
@pytest.mark.parametrize("lane", ["sk", "floor", "floor_sk"])
def test_base_conversion_wide_instance_past_33_primes(lane, kb):
    """The base conversion at kb = 34 (the first past the wide instance's
    33), 63 (log_q = 1770) and 68 (log_q = 1920), each lane from k = kb - 4
    q primes: the deep instance, one word per thread, 128 threads per CTA,
    the grid over every word of [kb, 3, 65536], not the tiled instance
    (csrc/rns.cu asserts at compile time that the deep instance's shared
    memory fits a block up to 108 q and 112 Bsk primes); the fixed instances (kb <= 17, a floor from
    at most 16 q primes) and the wide one (kb <= 33, a floor from at most
    32) keep their instance and shape."""
    k, count = kb - 4, 3 * N65536
    assert rns_cuda.conv_wide(lane, kb, k) and rns_cuda.conv_deep(lane, kb, k)
    assert not rns_cuda.conv_tiled(lane, kb, k)
    geo = rns_cuda.conv_geometry(count, lane, wide=True, deep=True)
    assert (geo["per_thread"], geo["threads"]) == (1, rns_cuda.CONV_DEEP_THREADS) == (1, 128)
    assert geo["blocks"] * geo["threads"] == count
    wide = rns_cuda.conv_geometry(count, lane, wide=True)
    assert (wide["per_thread"], wide["threads"], wide["blocks"]) == (1, 256, count // 256)
    for kb_fixed, k_fixed in ((5, 3), (17, 16)):
        assert not rns_cuda.conv_wide(lane, kb_fixed, k_fixed)
    for kb_wide, k_wide in ((18, 15), (33, 29), (33, 32)):
        assert rns_cuda.conv_wide(lane, kb_wide, k_wide)
        assert not rns_cuda.conv_deep(lane, kb_wide, k_wide)
    assert rns_cuda.conv_deep(lane, 33, 33) == (lane != "sk")
    assert rns_cuda.conv_geometry(count, lane) == rns_cuda.conv_geometry(count, lane, False, False)


@pytest.mark.parametrize("k,kd,batch", [(3, 3, 1), (3, 3, 2), (30, 30, 1), (30, 30, 2)])
def test_n65536_compact_forms(k, kd, batch):
    """Every cluster kernel of the BFV path at n = 65536, at log_q = 90
    (k = 3) and log_q = 900 (k = kd = 30, kb = 33), single and B = 2: B1,
    B2 and B3 on the compact split alone (no scratch); B4 and B5 with the
    transformed half rows in scratch (n/2 words per CTA); B7/B12 (every
    lane) in the wide form on the compact split (n words per CTA); B8 a
    pair of CTAs per prime, min(k, 4) pairs per cluster (n words per CTA).
    Every cluster is portable (at most 8 CTAs) and no block exceeds its
    shared memory.  B4's Lift lane has no such form (n < 1024 only)."""
    n = N65536
    for geo in (ntt_cuda.ntt_forward_geometry(n, k, batch),
                ntt_cuda.ntt_inverse_geometry(n, k, batch),
                ntt_cuda.mul_by_ntt_operand_geometry(n, k, c=2, batch=batch)):
        assert_compact_form(geo, n, 0)
    kb = 33 if k == 30 else 5
    for geo in (ntt_cuda.tensor_product_geometry(n, k, batch),
                rns_cuda.bsk_branch_geometry(n, kb, batch)):
        assert not geo["half_row"] and geo["cluster"] == (8, 1, 1)
        assert_compact_form(geo, n, n // 2)
    for galois in (False, True):
        geo = ntt_cuda.keyswitch_geometry(n, k, kd, batch, galois=galois)
        assert geo["wide"] and geo["pairs"] == min(kd, 4)
        assert_compact_form(geo, n, n)
    geo = decrypt_cuda.decrypt_geometry(n, k, batch)
    pairs = min(k, 4)
    assert geo["cluster"] == (2 * pairs, 1, 1) and geo["grid"] == (2 * pairs, batch)
    assert geo["primes_per_cta"] == -(-k // pairs)
    # pair q takes the primes q, q + P, ...: every prime once, ceil(k / P)
    # rounds for every pair (a pair without a prime in a round idles)
    taken = [list(range(q, k, pairs)) for q in range(pairs)]
    assert sorted(i for primes in taken for i in primes) == list(range(k))
    assert_compact_form(geo, n, n)
    with pytest.raises(ValueError, match="tensor_product: n=65536 needs"):
        ntt_cuda.tensor_product_geometry(n, k, lift=True)


def test_n65536_scratch_of_the_k30_multiply():
    """The global scratch the k = 30 multiply's kernels ask for at
    n = 65536: B4 and B5 n/2 words for each CTA of a cluster of 8 per
    prime, B8 n words for each of its 8 CTAs, and B7 at kd = 30 240 CTAs x
    n words, 63 MB: more than the card's 50 MB L2."""
    n, k = N65536, 30
    assert ntt_cuda.keyswitch_geometry(n, k, k)["scratch"] * 4 == 8 * k * n * 4 == 62914560
    assert ntt_cuda.tensor_product_geometry(n, k)["scratch"] == 8 * k * n // 2
    assert rns_cuda.bsk_branch_geometry(n, 33)["scratch"] == 8 * 33 * n // 2
    assert decrypt_cuda.decrypt_geometry(n, k)["scratch"] == 8 * n


@pytest.mark.parametrize("col", [0, 1, 2047, 2048, 4095])
def test_decrypt_compact_accumulator_index(col):
    """B8's compact form accumulates element base + (g << (log n - 4)) of
    column base (the inverse's last pass; CTA h holds columns
    [h n/32, (h+1) n/32)) at g n/32 + base - h n/32 of its n/2-word
    accumulator, and its epilogue finds coefficient j at the same word of
    CTA hj: the two index maps agree, and every coefficient of the row has
    one (CTA, word)."""
    n = N65536
    logc = n.bit_length() - 1 - 5
    seen = set()
    for g in range(16):
        j = col + (g << (logc + 1))
        h = col >> logc
        e_pass = (g << logc) + col - (h << logc)
        cols = j & ((2 << logc) - 1)
        hj = cols >> logc
        e_epi = ((j >> (logc + 1)) << logc) + (cols & ((1 << logc) - 1))
        assert (h, e_pass) == (hj, e_epi) and 0 <= e_pass < n // 2
        seen.add((hj, e_epi))
    assert len(seen) == 16
    j = np.arange(n)
    cols = j & ((2 << logc) - 1)
    word = (cols >> logc) * (n // 2) + ((j >> (logc + 1)) << logc) + (cols & ((1 << logc) - 1))
    assert np.array_equal(np.sort(word), j)


# every geometry at n = 8192, 32768 and 65536 as the pair split returned it
# before the quarter split was added (k = 3, and k = 30 at B = 2; B5 at
# kb = 5 and 33; B7 also at the prereduced k = 4, kd = 2; B17 with 8
# elements, and 32 with c0)
GEOMETRY_TODAY = {
    ('ntt_forward', 8192): [{'grid': (2, 3), 'cluster': (2, 1, 1), 'ctas': 6, 'ctas_per_row': 2, 'threads': 256, 'smem': 33792, 'compact': False}, {'grid': (4, 30), 'cluster': (2, 1, 1), 'ctas': 120, 'ctas_per_row': 2, 'threads': 256, 'smem': 33792, 'compact': False}],
    ('ntt_forward', 32768): [{'grid': (2, 3), 'cluster': (2, 1, 1), 'ctas': 6, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': False}, {'grid': (4, 30), 'cluster': (2, 1, 1), 'ctas': 120, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': False}],
    ('ntt_forward', 65536): [{'grid': (2, 3), 'cluster': (2, 1, 1), 'ctas': 6, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': True}, {'grid': (4, 30), 'cluster': (2, 1, 1), 'ctas': 120, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': True}],
    ('ntt_inverse', 8192): [{'grid': (2, 3), 'cluster': (2, 1, 1), 'ctas': 6, 'ctas_per_row': 2, 'threads': 256, 'smem': 33792, 'compact': False}],
    ('ntt_inverse', 32768): [{'grid': (2, 3), 'cluster': (2, 1, 1), 'ctas': 6, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': False}],
    ('ntt_inverse', 65536): [{'grid': (2, 3), 'cluster': (2, 1, 1), 'ctas': 6, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': True}],
    ('mul_by_ntt_operand', 8192): [{'grid': (2, 2, 3), 'cluster': (2, 1, 1), 'ctas': 12, 'ctas_per_row': 2, 'threads': 256, 'smem': 33792, 'compact': False}, {'grid': (2, 4, 30), 'cluster': (2, 1, 1), 'ctas': 240, 'ctas_per_row': 2, 'threads': 256, 'smem': 33792, 'compact': False}],
    ('mul_by_ntt_operand', 32768): [{'grid': (2, 2, 3), 'cluster': (2, 1, 1), 'ctas': 12, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': False}, {'grid': (2, 4, 30), 'cluster': (2, 1, 1), 'ctas': 240, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': False}],
    ('mul_by_ntt_operand', 65536): [{'grid': (2, 2, 3), 'cluster': (2, 1, 1), 'ctas': 12, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': True}, {'grid': (2, 4, 30), 'cluster': (2, 1, 1), 'ctas': 240, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'compact': True}],
    ('tensor_product', 8192): [{'grid': (8, 1, 3), 'cluster': (8, 1, 1), 'ctas': 24, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 256, 'smem': 67584, 'half_row': False, 'compact': False, 'scratch': 0}, {'grid': (8, 2, 30), 'cluster': (8, 1, 1), 'ctas': 480, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 256, 'smem': 67584, 'half_row': False, 'compact': False, 'scratch': 0}],
    ('tensor_product', 32768): [{'grid': (8, 1, 3), 'cluster': (8, 1, 1), 'ctas': 24, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 202752, 'half_row': True, 'compact': False, 'scratch': 0}, {'grid': (8, 2, 30), 'cluster': (8, 1, 1), 'ctas': 480, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 202752, 'half_row': True, 'compact': False, 'scratch': 0}],
    ('tensor_product', 65536): [{'grid': (8, 1, 3), 'cluster': (8, 1, 1), 'ctas': 24, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'half_row': False, 'compact': True, 'scratch': 786432}, {'grid': (8, 2, 30), 'cluster': (8, 1, 1), 'ctas': 480, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'half_row': False, 'compact': True, 'scratch': 15728640}],
    ('bsk_branch_fused', 8192): [{'grid': (8, 1, 5), 'cluster': (8, 1, 1), 'ctas': 40, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 256, 'smem': 67584, 'half_row': False, 'compact': False, 'scratch': 0}, {'grid': (8, 2, 33), 'cluster': (8, 1, 1), 'ctas': 528, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 256, 'smem': 67584, 'half_row': False, 'compact': False, 'scratch': 0}],
    ('bsk_branch_fused', 32768): [{'grid': (8, 1, 5), 'cluster': (8, 1, 1), 'ctas': 40, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 202752, 'half_row': True, 'compact': False, 'scratch': 0}, {'grid': (8, 2, 33), 'cluster': (8, 1, 1), 'ctas': 528, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 202752, 'half_row': True, 'compact': False, 'scratch': 0}],
    ('bsk_branch_fused', 65536): [{'grid': (8, 1, 5), 'cluster': (8, 1, 1), 'ctas': 40, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'half_row': False, 'compact': True, 'scratch': 1310720}, {'grid': (8, 2, 33), 'cluster': (8, 1, 1), 'ctas': 528, 'ctas_per_prime': 8, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'half_row': False, 'compact': True, 'scratch': 17301504}],
    ('keyswitch_fused', 8192): [{'grid': (6, 1, 3), 'cluster': (6, 1, 1), 'ctas': 18, 'pairs': 3, 'ctas_per_row': 2, 'threads': 256, 'smem': 67584, 'wide': False, 'compact': False, 'scratch': 0}, {'grid': (8, 2, 30), 'cluster': (8, 1, 1), 'ctas': 480, 'pairs': 4, 'ctas_per_row': 2, 'threads': 256, 'smem': 100352, 'wide': False, 'compact': False, 'scratch': 0}, {'grid': (4, 1, 4), 'cluster': (4, 1, 1), 'ctas': 16, 'pairs': 2, 'ctas_per_row': 2, 'threads': 256, 'smem': 67584, 'wide': False, 'compact': False, 'scratch': 0}],
    ('keyswitch_fused', 32768): [{'grid': (6, 1, 3), 'cluster': (6, 1, 1), 'ctas': 18, 'pairs': 3, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': False, 'scratch': 589824}, {'grid': (8, 2, 30), 'cluster': (8, 1, 1), 'ctas': 480, 'pairs': 4, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': False, 'scratch': 15728640}, {'grid': (4, 1, 4), 'cluster': (4, 1, 1), 'ctas': 16, 'pairs': 2, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': False, 'scratch': 524288}],
    ('keyswitch_fused', 65536): [{'grid': (6, 1, 3), 'cluster': (6, 1, 1), 'ctas': 18, 'pairs': 3, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': True, 'scratch': 1179648}, {'grid': (8, 2, 30), 'cluster': (8, 1, 1), 'ctas': 480, 'pairs': 4, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': True, 'scratch': 31457280}, {'grid': (4, 1, 4), 'cluster': (4, 1, 1), 'ctas': 16, 'pairs': 2, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': True, 'scratch': 1048576}],
    ('ks_inner_batch', 8192): [{'grid': (2, 16, 3), 'cluster': (2, 1, 1), 'ctas': 96, 'ctas_per_row': 2, 'threads': 256, 'smem': 33792, 'stage_c0': False, 'compact': False}, {'grid': (2, 64, 3), 'cluster': (2, 1, 1), 'ctas': 384, 'ctas_per_row': 2, 'threads': 256, 'smem': 66560, 'stage_c0': True, 'compact': False}],
    ('ks_inner_batch', 32768): [{'grid': (2, 16, 3), 'cluster': (2, 1, 1), 'ctas': 96, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'stage_c0': False, 'compact': False}, {'grid': (2, 64, 3), 'cluster': (2, 1, 1), 'ctas': 384, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'stage_c0': False, 'compact': False}],
    ('ks_inner_batch', 65536): [{'grid': (2, 16, 3), 'cluster': (2, 1, 1), 'ctas': 96, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'stage_c0': False, 'compact': True}, {'grid': (2, 64, 3), 'cluster': (2, 1, 1), 'ctas': 384, 'ctas_per_row': 2, 'threads': 512, 'smem': 135168, 'stage_c0': False, 'compact': True}],
    ('decrypt_fused', 8192): [{'grid': (3, 1), 'cluster': (3, 1, 1), 'ctas': 3, 'ctas_per_row': 1, 'primes_per_cta': 1, 'threads': 512, 'smem': 101376, 'wide': False, 'compact': False, 'scratch': 0}, {'grid': (8, 2), 'cluster': (8, 1, 1), 'ctas': 16, 'ctas_per_row': 1, 'primes_per_cta': 4, 'threads': 512, 'smem': 101376, 'wide': False, 'compact': False, 'scratch': 0}],
    ('decrypt_fused', 32768): [{'grid': (3, 1), 'cluster': (3, 1, 1), 'ctas': 3, 'ctas_per_row': 1, 'primes_per_cta': 1, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': False, 'scratch': 196608}, {'grid': (8, 2), 'cluster': (8, 1, 1), 'ctas': 16, 'ctas_per_row': 1, 'primes_per_cta': 4, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': False, 'scratch': 1048576}],
    ('decrypt_fused', 65536): [{'grid': (6, 1), 'cluster': (6, 1, 1), 'ctas': 6, 'ctas_per_row': 2, 'primes_per_cta': 1, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': True, 'scratch': 393216}, {'grid': (8, 2), 'cluster': (8, 1, 1), 'ctas': 16, 'ctas_per_row': 2, 'primes_per_cta': 8, 'threads': 512, 'smem': 135168, 'wide': True, 'compact': True, 'scratch': 1048576}],
}
GEOMETRY_CALLS = {
    "ntt_forward": lambda n: [ntt_cuda.ntt_forward_geometry(n, 3, 1),
                              ntt_cuda.ntt_forward_geometry(n, 30, 2)],
    "ntt_inverse": lambda n: [ntt_cuda.ntt_inverse_geometry(n, 3, 1)],
    "mul_by_ntt_operand": lambda n: [ntt_cuda.mul_by_ntt_operand_geometry(n, 3, 2, 1),
                                     ntt_cuda.mul_by_ntt_operand_geometry(n, 30, 2, 2)],
    "tensor_product": lambda n: [ntt_cuda.tensor_product_geometry(n, 3, 1),
                                 ntt_cuda.tensor_product_geometry(n, 30, 2)],
    "bsk_branch_fused": lambda n: [rns_cuda.bsk_branch_geometry(n, 5, 1),
                                   rns_cuda.bsk_branch_geometry(n, 33, 2)],
    "keyswitch_fused": lambda n: [ntt_cuda.keyswitch_geometry(n, 3, 3, 1),
                                  ntt_cuda.keyswitch_geometry(n, 30, 30, 2, galois=True),
                                  ntt_cuda.keyswitch_geometry(n, 4, 2, 1)],
    "ks_inner_batch": lambda n: [ntt_cuda.ks_inner_geometry(n, 3, 8),
                                 ntt_cuda.ks_inner_geometry(n, 3, 32, c0=True)],
    "decrypt_fused": lambda n: [decrypt_cuda.decrypt_geometry(n, 3, 1),
                                decrypt_cuda.decrypt_geometry(n, 30, 2)],
}
N131072 = 131072


@pytest.mark.parametrize("name,n", sorted(GEOMETRY_TODAY))
def test_geometry_up_to_n65536_unchanged(name, n):
    """The quarter split leaves every launch shape at n <= 65536 as it was:
    each geometry at n = 8192, 32768 and 65536 equals its dict of before."""
    assert GEOMETRY_CALLS[name](n) == GEOMETRY_TODAY[(name, n)]


# each cluster kernel's column form (GEOMETRY_CALLS' shapes: k = 3 at B = 1
# and k = 30 at B = 2, ...): its launches, and the scratch words between
# them for k primes (kb = 5 and 33 for B5), B elements and n
COLUMN_LAUNCHES = {"ntt_forward": (2, lambda k, b, n: 0),
                   "ntt_inverse": (2, lambda k, b, n: k * b * n),
                   "mul_by_ntt_operand": (3, lambda k, b, n: 3 * k * b * n),
                   "tensor_product": (4, lambda k, b, n: 7 * k * b * n),
                   "bsk_branch_fused": (3, lambda k, b, n: 7 * k * b * n),
                   "keyswitch_fused": (3, None),
                   "ks_inner_batch": (2, lambda k, b, n: 2 * k * b * n),
                   "decrypt_fused": (3, lambda k, b, n: 2 * k * b * n)}
LARGE_RINGS = (262144, 524288, 1048576, 2097152)


@pytest.mark.parametrize("n", LARGE_RINGS)
@pytest.mark.parametrize("name", sorted(GEOMETRY_CALLS))
def test_rings_past_n131072_take_the_column_form(name, n):
    """From n = 262144 even the quarter split's padded quarter row exceeds
    a block (270336 bytes at n = 262144), so every cluster kernel's
    geometry returns the column form: a block of 8192 positions, its
    launches (none a cluster), the scratch rows between them, and every
    launch's shared memory within a block's."""
    assert 4 * padded(n // 4) >= 270336 > MAX_SMEM
    launches, scratch = COLUMN_LAUNCHES[name]
    geos = GEOMETRY_CALLS[name](n)
    shapes = {"keyswitch_fused": ((3, 3, 1), (30, 30, 2), (4, 2, 1)),
              "ks_inner_batch": ((3, 3, 8), (3, 3, 32)),
              "ntt_inverse": ((3, 3, 1),)}.get(name, ((3, 3, 1), (30, 30, 2)))
    for geo, (k, kd, batch) in zip(geos, shapes):
        if name == "bsk_branch_fused":
            k = 5 if k == 3 else 33
        words = (k * (kd + 2) * batch * n if name == "keyswitch_fused"
                 else scratch(k, batch, n))
        assert_column_form(geo, n, k, launches, words)
    assert len(geos) == len(shapes)


@pytest.mark.parametrize("k,kd,batch", [(3, 3, 1), (3, 3, 2), (30, 30, 1), (30, 30, 2),
                                        (59, 59, 1), (102, 102, 1), (4, 2, 1)])
def test_n131072_quarter_forms(k, kd, batch):
    """Every cluster kernel of the BFV path at n = 131072, at log_q = 90
    (k = 3), 900 (k = kd = 30), 1770 (k = 59), 3060 (k = 102, the largest
    set JAX takes there) and the ks_omega = 2 set's k = 4, kd = 2, single and
    B = 2: B1, B2, B3 and B17/B18 in clusters of 4 on the quarter split (no
    scratch); B4 and B5 in a portable cluster of 8, the four input rows in
    rounds, the transformed rows in scratch (n/2 words per CTA); B7/B12
    (every lane) in the wide form with R = 2 digit groups of four (a cluster
    of 8, n/2 words of scratch per CTA); B8 four CTAs per prime, min(k, 2)
    groups per cluster (n/2 words per CTA).  Every cluster is portable and
    no block exceeds its shared memory.  B4's Lift lane has no such form."""
    n = N131072
    for geo in (ntt_cuda.ntt_forward_geometry(n, k, batch),
                ntt_cuda.ntt_inverse_geometry(n, k, batch),
                ntt_cuda.mul_by_ntt_operand_geometry(n, k, c=2, batch=batch),
                ntt_cuda.ks_inner_geometry(n, k, batch),
                ntt_cuda.ks_inner_geometry(n, k, batch, c0=True)):
        assert geo["cluster"] == (4, 1, 1)
        assert_quarter_form(geo, n, 0)
    kb = len(make_scheme_params(SecurityParams(
        poly_degree=n, log_q=30 * k, lambda_=0, hamming_weight=16,
        plain_modulus=786433)).bsk_primes)
    for geo in (ntt_cuda.tensor_product_geometry(n, k, batch),
                rns_cuda.bsk_branch_geometry(n, kb, batch)):
        assert not geo["half_row"] and geo["cluster"] == (8, 1, 1)
        assert ntt_cuda.product_form(geo) == 3
        assert_quarter_form(geo, n, n // 2)
    for galois in (False, True):
        geo = ntt_cuda.keyswitch_geometry(n, k, kd, batch, galois=galois)
        assert geo["wide"] and geo["pairs"] == 2 and geo["cluster"] == (8, 1, 1)
        assert_quarter_form(geo, n, n // 2)
        # group r takes digits r, r + 2, ...: every digit once
        taken = [list(range(r, kd, 2)) for r in range(2)]
        assert sorted(j for ds in taken for j in ds) == list(range(kd))
    geo = decrypt_cuda.decrypt_geometry(n, k, batch)
    groups = min(k, 2)
    assert geo["cluster"] == (4 * groups, 1, 1) and geo["grid"] == (4 * groups, batch)
    assert geo["primes_per_cta"] == -(-k // groups)
    assert_quarter_form(geo, n, n // 2)
    for geo in (ntt_cuda.ntt_forward_geometry(n, k, batch),
                ntt_cuda.keyswitch_geometry(n, k, kd, batch),
                decrypt_cuda.decrypt_geometry(n, k, batch)):
        assert ntt_cuda.compact_arg(geo) == 4
    with pytest.raises(ValueError, match="tensor_product: n=131072 needs"):
        ntt_cuda.tensor_product_geometry(n, k, lift=True)


def test_n131072_scratch_of_the_k102_multiply():
    """The global scratch of the k = 102 multiply's kernels at n = 131072
    (log_q = 3060, kb = 107): B4 and B5 the cluster's four transformed rows,
    4n words per (element, prime); B7 at kd = 102 n/2 words for each of 8
    CTAs per prime, 214 MB; B8 n/2 words for each of its 8 CTAs."""
    n, k, kb = N131072, 102, 107
    assert ntt_cuda.keyswitch_geometry(n, k, k)["scratch"] * 4 == 8 * k * n // 2 * 4 == 213909504
    assert ntt_cuda.tensor_product_geometry(n, k)["scratch"] == 4 * k * n
    assert rns_cuda.bsk_branch_geometry(n, kb)["scratch"] == 4 * kb * n
    assert decrypt_cuda.decrypt_geometry(n, k)["scratch"] == 8 * n // 2


def test_n131072_sets_reach_the_largest_k_jax_takes():
    """At n = 131072 the 30-bit primes p = 1 mod 2n give log_q up to 3060
    (k = 102, kb = 107) and no further, in the port's params as in JAX's."""
    prm = make_scheme_params(SecurityParams(poly_degree=N131072, log_q=3060, lambda_=0,
                                            hamming_weight=16, plain_modulus=786433))
    assert (prm.k, len(prm.bsk_primes)) == (102, 107)
    with pytest.raises(ValueError, match="not enough 30-bit NTT primes"):
        make_scheme_params(SecurityParams(poly_degree=N131072, log_q=3090, lambda_=0,
                                          hamming_weight=16, plain_modulus=786433))


@pytest.mark.parametrize("col", [0, 1, 1023, 1024, 2047, 2048, 6143, 8191])
def test_decrypt_quarter_accumulator_index(col):
    """B8 on the quarter split (H = 4) accumulates element base +
    (g << (log n - 4)) of column base (the inverse's last pass; CTA h holds
    columns [h n/64, (h+1) n/64)) at g n/64 + base - h n/64 of its
    n/4-word accumulator, and its epilogue finds coefficient j at the same
    word of CTA hj: the two index maps agree, and every coefficient of the
    row has one (CTA, word)."""
    n, log_h = N131072, 2
    logc = n.bit_length() - 1 - 4 - log_h
    h = col >> logc
    seen = set()
    for g in range(16):
        j = col + (g << (logc + log_h))
        e_pass = (g << logc) + col - (h << logc)
        cols = j & ((4 << logc) - 1)
        hj = cols >> logc
        e_epi = ((j >> (logc + log_h)) << logc) + (cols & ((1 << logc) - 1))
        assert (h, e_pass) == (hj, e_epi) and 0 <= e_pass < n // 4
        seen.add((hj, e_epi))
    assert len(seen) == 16
    j = np.arange(n)
    cols = j & ((4 << logc) - 1)
    word = (cols >> logc) * (n // 4) + ((j >> (logc + log_h)) << logc) + (cols & ((1 << logc) - 1))
    assert np.array_equal(np.sort(word), j)



# each ring past n = 131072 with a batching t (a prime, t = 1 mod 2n) and
# the largest set JAX's 30-bit primes give there: (n, t, log_q, k, kb)
LARGEST_SETS = ((262144, 5767169, 1560, 52, 56), (524288, 7340033, 780, 26, 29),
                (1048576, 23068673, 390, 13, 16), (2097152, 104857601, 120, 4, 6))


@pytest.mark.parametrize("n,t,log_q,k,kb", LARGEST_SETS)
def test_every_geometry_takes_each_rings_largest_set(n, t, log_q, k, kb):
    """At each ring's largest set (the port's params give the k and kb of
    JAX's, and 30 bits more raise) every cluster kernel's geometry returns
    a column-form launch shape at the multiply's and the rotation's shapes,
    single and B = 2: B7/B12 with kd = k (the whole [k, kd, B, n] digit
    stack in scratch, 2.84 GB at n = 262144, B = 1), B5 on the kb Bsk
    primes."""
    prm = make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q, lambda_=0,
                                            hamming_weight=16, plain_modulus=t))
    assert (prm.k, len(prm.bsk_primes)) == (k, kb)
    with pytest.raises(ValueError, match="not enough 30-bit NTT primes"):
        make_scheme_params(SecurityParams(poly_degree=n, log_q=log_q + 30, lambda_=0,
                                          hamming_weight=16, plain_modulus=t))
    for batch in (1, 2):
        shapes = ((ntt_cuda.ntt_forward_geometry(n, k, 3 * batch), k, 2, 0),
                  (ntt_cuda.ntt_inverse_geometry(n, k, batch), k, 2, k * batch * n),
                  (ntt_cuda.mul_by_ntt_operand_geometry(n, k, 2, batch), k, 3,
                   3 * k * batch * n),
                  (ntt_cuda.tensor_product_geometry(n, k, batch), k, 4, 7 * k * batch * n),
                  (rns_cuda.bsk_branch_geometry(n, kb, batch), kb, 3, 7 * kb * batch * n),
                  (ntt_cuda.keyswitch_geometry(n, k, k, batch), k, 3,
                   k * (k + 2) * batch * n),
                  (ntt_cuda.keyswitch_geometry(n, k, k, batch, galois=True), k, 3,
                   k * (k + 2) * batch * n),
                  (ntt_cuda.ks_inner_geometry(n, k, 8 * batch, c0=True), k, 2,
                   2 * k * 8 * batch * n),
                  (decrypt_cuda.decrypt_geometry(n, k, batch), k, 3, 2 * k * batch * n))
        for geo, primes, launches, scratch in shapes:
            assert_column_form(geo, n, primes, launches, scratch)
    if n == 262144:         # the digits 2.84 GB, the two partial rows 109 MB
        assert ntt_cuda.keyswitch_geometry(n, k, k)["scratch"] * 4 == 2944401408


def test_n4194304_has_no_set():
    """At n = 4194304 one 30-bit prime is 1 mod 2n (998244353), so no set
    has the q and Bsk primes a multiply needs: the port's params raise as
    JAX's do, with a batching t = 167772161, and the column form has no
    shape there (the tile would hold fewer than a warp of columns)."""
    from fhe_tpu import primes as jprimes
    from fhe_tpu.params import SecurityParams as JSecurity
    from fhe_tpu.params import make_scheme_params as jmake_params

    from fhe_tpu_torch import primes as tprimes
    n, t = 4194304, 167772161
    assert tprimes.is_prime(t) and t % (2 * n) == 1
    assert (list(tprimes.find_ntt_primes(n, 1)) == list(jprimes.find_ntt_primes(n, 1))
            == [998244353])
    for security, make in ((SecurityParams, make_scheme_params), (JSecurity, jmake_params)):
        with pytest.raises(ValueError, match="not enough 30-bit NTT primes"):
            make(security(poly_degree=n, log_q=30, lambda_=0, hamming_weight=16,
                          plain_modulus=t))
    with pytest.raises(ValueError, match="ntt_forward: n=4194304 has no column form"):
        ntt_cuda.ntt_forward_geometry(n, 1)


@pytest.mark.parametrize("name", sorted(GEOMETRY_CALLS))
def test_forced_column_form_at_n8192(name):
    """Inside ntt_cuda.forced_form("column") every geometry returns the
    column form where the cluster forms fit (chip_smoke.py holds the two
    against each other at n = 8192 and 131072: b = 4096, one column stage,
    one tile a row), and on leaving it the cluster shape of before."""
    n = 8192
    with ntt_cuda.forced_form("column"):
        for geo in GEOMETRY_CALLS[name](n):
            assert geo["column"] and geo["block"] == 4096 and geo["column_stages"] == 1
            assert geo["launches"] == COLUMN_LAUNCHES[name][0]
            assert all(step["grid"][0] in (1, 2) for step in geo["steps"])
    assert GEOMETRY_CALLS[name](n) == GEOMETRY_TODAY[(name, n)]
    with pytest.raises(ValueError, match="forced_form: 'quarter'"):
        with ntt_cuda.forced_form("quarter"):
            pass
