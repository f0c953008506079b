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
each kernel takes.
tests/test_torch_cuda.py runs the kernels themselves."""

import pytest

from fhe_tpu_torch.ops import decrypt_cuda, ntt_cuda, rns_cuda
from fhe_tpu_torch.params import SecurityParams, make_scheme_params
from fhe_tpu_torch.scheme.context import make_context

MAX_SMEM = ntt_cuda.MAX_SMEM


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


@pytest.mark.parametrize("n", [256, 1024, 4096, 8192, 16384])
def test_bsk_branch_cluster_per_prime(n):
    """A cluster of 8 CTAs, two per input row, for each (element, Bsk
    prime), each with two padded rows of shared memory and a thread per
    group of 16 of its half row."""
    geo = rns_cuda.bsk_branch_geometry(n, kb=5, batch=8)
    assert geo["cluster"] == (8, 1, 1) and geo["ctas_per_prime"] == 8
    assert geo["ctas_per_row"] == 2
    assert geo["grid"] == (8, 8, 5) and geo["ctas"] == 8 * 8 * 5
    assert geo["smem"] == 2 * 4 * (n + n // 32) <= MAX_SMEM
    assert geo["threads"] == min(max(n // 32, 32), 512)


def test_n32768_does_not_fit_either_kernel():
    with pytest.raises(ValueError, match="bsk_branch_fused: n=32768"):
        rns_cuda.bsk_branch_geometry(32768, kb=5)
    with pytest.raises(ValueError, match="decrypt_fused: n=32768"):
        decrypt_cuda.decrypt_geometry(32768, k=3)


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
@pytest.mark.parametrize("n", [256, 1024, 8192, 16384])
def test_tensor_product_cluster_per_prime(n, batch):
    """B5's shape: a cluster of 8 CTAs, two per input row x0, x1, y0, y1,
    for each (element, prime), two padded rows of shared memory each: 24
    CTAs for the multiply's q side (k = 3), where one block per prime ran 3."""
    geo = ntt_cuda.tensor_product_geometry(n, k=3, batch=batch)
    assert geo == rns_cuda.bsk_branch_geometry(n, kb=3, batch=batch)
    assert geo["cluster"] == (8, 1, 1) and geo["ctas_per_prime"] == 8
    assert geo["grid"] == (8, batch, 3) and geo["ctas"] == 8 * batch * 3
    assert geo["smem"] == 2 * 4 * (n + n // 32) <= MAX_SMEM


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
    fit a CTA, so the whole multiply runs there; B4's two rows at n = 32768
    do not (B3's one row does)."""
    assert ntt_cuda.mul_by_ntt_operand_geometry(16384, k=3, c=2)["smem"] == 67584
    assert ntt_cuda.tensor_product_geometry(16384, k=3)["smem"] == 135168
    assert rns_cuda.bsk_branch_geometry(16384, kb=5)["smem"] == 135168
    assert decrypt_cuda.decrypt_geometry(16384, k=3)["smem"] == 202752
    with pytest.raises(ValueError, match="tensor_product: n=32768"):
        ntt_cuda.tensor_product_geometry(32768, k=3)
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
@pytest.mark.parametrize("n", [256, 1024, 8192, 16384])
def test_keyswitch_cluster_of_digit_pairs(n, kd, batch):
    """A cluster of 2R CTAs per (element, prime), R = clamp(kd, 2, 4) digit
    pairs: two pairs at least (one per output row), at most 8 CTAs (the
    portable cluster size), so kd = 8 takes two digits per pair; two padded
    rows of shared memory and a thread per group of 16 of a half row: 18
    CTAs for the headline relinearization (k = 3, kd = 3), where one block
    per prime ran 3."""
    geo = ntt_cuda.keyswitch_geometry(n, k=3, kd=kd, batch=batch)
    pairs = min(max(kd, 2), 4)
    assert geo["pairs"] == pairs
    assert geo["cluster"] == (2 * pairs, 1, 1) and geo["ctas_per_row"] == 2
    assert geo["grid"] == (2 * pairs, batch, 3) and geo["ctas"] == 2 * pairs * batch * 3
    assert geo["smem"] == 2 * 4 * (n + n // 32) <= MAX_SMEM
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
    """B1's one padded row fits at n = 32768; B7's two do not (nor did its
    three plain rows before)."""
    assert ntt_cuda.ntt_forward_geometry(32768, k=3)["smem"] == 135168
    assert ntt_cuda.keyswitch_geometry(16384, k=3, kd=3)["smem"] == 135168
    with pytest.raises(ValueError, match="keyswitch_fused: n=32768"):
        ntt_cuda.keyswitch_geometry(32768, k=3, kd=3)


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
    CTA up to n = 32768: B2 and B17/B18 raise outside, naming the
    function, before any launch."""
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
    beside its two padded rows: it fits up to n = 16384 and raises above,
    naming the function; its classic lane keeps its shape.  ks_inner's
    Galois lane stages c0 where it fits and reads it in place at
    n = 32768."""
    n = 16384
    padded = n + n // 32
    assert ntt_cuda.keyswitch_geometry(n, 3, 3, galois=True)["smem"] == 4 * (2 * padded + n)
    assert ntt_cuda.keyswitch_geometry(n, 3, 3)["smem"] == 4 * 2 * padded
    with pytest.raises(ValueError, match="keyswitch_fused: n=32768 needs"):
        ntt_cuda.keyswitch_geometry(32768, 3, 3, galois=True)
    # ks_inner stages its c0 row where it fits (n <= 16384), and reads it in
    # place above
    geo = ntt_cuda.ks_inner_geometry(n, 3, 8, c0=True)
    assert geo["stage_c0"] and geo["smem"] == 4 * (padded + n)
    geo = ntt_cuda.ks_inner_geometry(32768, 3, 8, c0=True)
    assert not geo["stage_c0"] and geo["smem"] == 4 * (32768 + 32768 // 32)
    assert not ntt_cuda.ks_inner_geometry(n, 3, 8)["stage_c0"]
