// BEHZ base-conversion kernels of the ciphertext multiply for Hopper (sm_90a).
//
// Replaces fhe_tpu/ops/rns_pallas.py: bsk_branch_fused (body
// _bsk_branch_kernel), fast_bconv_sk_fused (body _sk_kernel) and the n < 1024
// multiply's fast_floor_fused (body _floor_kernel).  Plain versions:
// fhe_tpu_torch/ops/rns.py (bsk_branch_fused and bsk_branch_fused_batch,
// fast_bconv_sk, fast_floor).  The n < 1024 multiply's sm_mrq_fused is the
// Lift lane of tensor_product (csrc/ntt.cu), with the lift of csrc/lift.cuh
// that bsk_branch_fused runs too.  The JAX multiply_batch runs the Bsk
// branch as vmapped jnp chains around tensor_product_batch; here it is this
// one kernel with a batch grid axis, which computes the same residues.
//
// bsk_branch_fused, for element b and Bsk prime c_j (B = 1 for the single
// multiply, the batch size for multiply_batch):
//   1. SmMRq lift of the four rows a0, a1, b0, b1 from q into c_j
//      (csrc/lift.cuh);
//   2. forward NTT of the four rows, tensor product, inverse NTT of three
//      rows with t * n^-1 (the Bsk half of the multiply's tables);
//   3. FastFloor: (tx_bsk - conv(tx_q)) * q^-1 mod c_j, with tx_q [k, 3, n]
//      the t-scaled q-side product, its digits converted to c_j.
// The lift and the Bsk product never leave shared memory (at n = 65536,
// the compact form, the transformed half rows pass through a global
// scratch buffer; at n = 131072, the quarter form, four CTAs share each row
// and the cluster runs its rows in rounds, csrc/quarter.cuh).  The TPU grid ran
// the Bsk primes in order on one core.  Here each (b, j) is a thread-block
// cluster of 8 CTAs, two per input row (kRowSplit), grid (8, B, kb): the two
// CTAs of row r lift it and run its forward transform between them (the
// register-blocked sweep of modmath.cuh, the row split as its RowSplit
// note says), each keeping half of the NTT-form row; after a cluster
// barrier, the CTAs of rows 0 to 2 form product row r of their half from
// the four rows' CTAs through distributed shared memory, run its inverse
// transform between them and floor it.  The CTAs of row 3 have no output
// row and stay (cluster barriers) until the peers have read their rows.
//
// fast_bconv_sk_fused, the exact Shenoy-Kumaresan conversion Bsk -> q, and
// fast_floor_fused, the FastFloor step of bsk_branch_fused on its own, are
// lanes of one kernel template, base_conv_kernel<Lane, V, KB>.  Both are
// elementwise over coefficients with sums over the source primes, and the
// TPU kernels (grid over destination primes) formed every source digit again
// for each destination prime: k times over for the conversion to q, kb times
// for the floor.  Here one thread owns V consecutive coefficients of every
// row: it forms each source digit once, keeps the digits in registers (KB,
// the Bsk prime count, is a template parameter, so their arrays are indexed
// at compile time) and loops over the destination primes.  The instances for
// KB = 2 .. 17 serve every base up to k = 15; one wide instance, with room
// for 33 Bsk primes and the actual kb given at run time, takes the larger
// bases up to the top of the JAX package's security table (n = 32768,
// log_q = 881: k = 30, kb = 33); past it a deep instance,
// base_conv_deep_kernel, keeps a thread's digits in its own row of shared
// memory and takes k and kb at run time up to kDeepMaxK and kDeepMaxKb
// (log_q = 1920 at n = 65536 is k = 64, kb = 68); past those, a tiled
// instance runs each lane as a modular matrix product through global
// scratch, with no cap (log_q = 5790 at n = 65536 is k = 193, kb = 201;
// 46170 at n = 8192 is k = 1539, kb = 1594).  The lanes are
// template parameters: SK (Bsk -> q; given the relinearization's inv_qhat it
// also stores the gadget digits [c2_j * (q/q_j)^-1]_{q_j} of the c2 rows
// beside them, which spares the multiply a chain of elementwise launches),
// Floor (t*x in q and in Bsk -> floor(t*x/q) in Bsk) and FloorSK (the floor
// into every Bsk prime, its residues kept in registers and converted to q
// at once: the n < 1024 multiply's floor and conversion in one launch).  The
// lanes' constant tables (a few hundred words) are staged once per CTA in
// shared memory while the thread's input words are in flight.
//
// Every digit of the floor and the conversions is a residue mod its own
// source prime and may exceed the destination prime (m_sk and several aux
// primes are below some q_i), so every product with a digit is a Shoup
// multiply, exact for any x < 2^32, or (base_conv_kernel) an unreduced
// 64-bit product of two words below 2^30, at most 16 of them in one sum
// between reductions; mul_barrett only ever sees reduced operands.
//
// What bounds them on the H100.  bsk_branch_fused at n = 8192, k = 3,
// kb = 5 reads 7 * 96 KB of residues and 5 * 128 KB of tables and writes
// 480 KB: about 0.5 us by memory rate; its 44.5 M integer instructions (the
// OPS count) take 1.3 us at the whole card's issue rate.  What bounds it is
// how few SMs one multiply's work spreads over and how fast one SM runs its
// share, which is latency-bound: a run of dependent passes, each ended by a
// barrier.  The design spreads it over kb clusters of 8 CTAs (40 CTAs at
// kb = 5, on 20 to 40 SMs: a CTA's 128 registers and 256 threads leave room
// for two per SM) and cuts the latency per SM: 4 passes per transform, not
// 13, the lift and the floor fused into the transforms' first and last
// passes a group of 16 coefficients at a time (16 loads in flight per
// thread), and the product read from the peers with consecutive threads on
// consecutive coefficients (the remote reads coalesced).  What each step of
// the design bought: PERF.md.
// base_conv_kernel moves little: fast_bconv_sk_fused at [5, 3, 8192] reads
// 480 KB and writes 288 KB (0.23 us by memory rate), so one launch of it is
// bound by launch latency; at [10, 24, 8192] (the k = 8 multiply_batch) it
// reads 7.9 MB and writes 6.3 MB, and there the memory rate and the digit
// arithmetic bound it, which forming each digit once cuts k-fold.  The
// n < 1024 multiply gives the FloorSK lane 1.5 K coefficients or fewer: it
// is bound by launch latency.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "column.cuh"
#include "lift.cuh"
#include "modmath.cuh"
#include "quarter.cuh"

namespace {

namespace cg = cooperative_groups;

// CTAs per input row of bsk_branch_fused (ops/rns_cuda.py: BSK_ROW_SPLIT)
constexpr int kRowSplit = 2;

// FastFloor in the destination prime c (bsk_branch_fused step 3,
// fast_floor_fused), one source prime at a time: fast_floor_step folds in
// the residue tx_i of t*x mod q_i, conv += [tx_i * (q/q_i)^-1]_{q_i} *
// (q/q_i) mod c; fast_floor_close takes tx_c, the residue of t*x mod c,
// to (tx_c - conv) * q^-1 mod c (iq = q^-1 mod c).
__device__ __forceinline__ void fast_floor_step(uint32_t tx_i, uint32_t qi, uint32_t w,
                                                uint32_t w_sh, uint32_t phat,
                                                uint32_t phat_sh, uint32_t c,
                                                uint32_t& conv) {
  const uint32_t y = fhe::mul_shoup(tx_i, w, w_sh, qi);
  conv = fhe::add_mod(conv, fhe::mul_shoup(y, phat, phat_sh, c), c);
}

__device__ __forceinline__ uint32_t fast_floor_close(uint32_t tx_c, uint32_t conv, uint32_t c,
                                                     uint32_t iq, uint32_t iq_sh) {
  return fhe::mul_shoup(fhe::sub_mod(tx_c, conv, c), iq, iq_sh, c);
}

// bsk_branch_fused's step 1 on a group of G coefficients: x[g] = the SmMRq
// lift into c of element base + (g << logs) of the row at src, whose
// residue mod source prime q_i lies at src + i * sp; lp, lp_sh: c's row of
// the lift's [kb, k] tables.  A group at once, source prime by source
// prime, so that a thread has a whole group's loads in flight.
template <int G>
__device__ __forceinline__ void lift_group(
    uint32_t (&x)[G], const uint32_t* __restrict__ src, int sp, int base, int logs, int k,
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ mt_inv_phat,
    const uint32_t* __restrict__ mt_inv_phat_sh, const uint32_t* __restrict__ lp,
    const uint32_t* __restrict__ lp_sh, const uint32_t* __restrict__ phat_mt, uint32_t c,
    uint32_t inv_q_mt, uint32_t qc, uint32_t qc_sh, uint32_t imt, uint32_t imt_sh) {
  uint32_t conv[G], lane[G];
#pragma unroll
  for (int g = 0; g < G; ++g) conv[g] = lane[g] = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t* si = src + i * sp + base;
    const uint32_t qi = q[i], w = mt_inv_phat[i], w_sh = mt_inv_phat_sh[i];
    const uint32_t ph = lp[i], ph_sh = lp_sh[i], pm = phat_mt[i];
#pragma unroll
    for (int g = 0; g < G; ++g)
      fhe::sm_mrq_step(si[g << logs], qi, w, w_sh, ph, ph_sh, pm, c, conv[g], lane[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    x[g] = fhe::sm_mrq_close(conv[g], lane[g], inv_q_mt, c, qc, qc_sh, imt, imt_sh);
}

// bsk_branch_fused's step 3 on a group: dst[base + (g << logs)] = the
// FastFloor of x[g] (product row r in c, times t) against the q-side
// product row at tsrc (source prime q_i at tsrc + i * sp); fp, fp_sh: c's
// row of the floor's [kb, k] table.
template <int G>
__device__ __forceinline__ void floor_group(
    const uint32_t (&x)[G], const uint32_t* __restrict__ tsrc, int sp,
    uint32_t* __restrict__ dst, int base, int logs, int k, const uint32_t* __restrict__ q,
    const uint32_t* __restrict__ floor_inv_phat, const uint32_t* __restrict__ floor_inv_phat_sh,
    const uint32_t* __restrict__ fp, const uint32_t* __restrict__ fp_sh, uint32_t c,
    uint32_t iq, uint32_t iq_sh) {
  uint32_t conv[G];
#pragma unroll
  for (int g = 0; g < G; ++g) conv[g] = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t* ti = tsrc + i * sp + base;
    const uint32_t qi = q[i], w = floor_inv_phat[i], w_sh = floor_inv_phat_sh[i];
    const uint32_t ph = fp[i], ph_sh = fp_sh[i];
#pragma unroll
    for (int g = 0; g < G; ++g)
      fast_floor_step(ti[g << logs], qi, w, w_sh, ph, ph_sh, c, conv[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    dst[base + (g << logs)] = fast_floor_close(x[g], conv[g], c, iq, iq_sh);
}

// ab: [k, 4, B, n] (a0, a1, b0, b1 in q), element (i, c, b, x) at
// i * ab_sp + c * ab_sc + b * ab_sb + x; txq: [k, 3, B, n] with its own
// strides; so both may be views of per-ciphertext stacks, read in place.
// The strides are 32-bit (the wrapper checks that every offset fits): 64-bit
// index products in the lift and floor loops cost the single kernel 2 %.
// out: [kb, 3, B, n].  Per-prime constant arrays follow ops/rns.py
// (SmMRqConsts, FastFloorConsts); [kb, k] tables are row-major by
// destination prime.  Grid (8, B, kb) in clusters of (8, 1, 1): CTA 2r + h
// of the cluster of (element b, Bsk prime c_j) shares input row r, and for
// r < 3 output row r, with CTA 2r + 1 - h, and keeps positions
// [h n/2, (h+1) n/2) of the transformed row.  Shared memory: two padded
// rows, the transformed input row (read by the peers) and the sweeps'
// working row (read by the partner); with HALF (n = 32768) the transformed
// row holds only those positions, as in tensor_product (csrc/ntt.cu).  FORM:
// 0 the two padded rows, 1 HALF, 2 COMPACT (n = 65536), tensor_product's
// compact form: the working row the compact split's padded half row, the
// transformed half rows in `scratch` (n/2 words per CTA, CTA `rank` of
// cluster (b, j) at scratch + ((j * B + b) * 8 + rank) * n/2).
template <int FORM>
__global__ void __launch_bounds__(512)
bsk_branch_kernel(const uint32_t* __restrict__ ab, int ab_sp, int ab_sc, int ab_sb,
                  const uint32_t* __restrict__ txq, int tx_sp, int tx_sc, int tx_sb,
                  uint32_t* __restrict__ out, const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ mt_inv_phat,
                  const uint32_t* __restrict__ mt_inv_phat_sh,
                  const uint32_t* __restrict__ lift_phat,
                  const uint32_t* __restrict__ lift_phat_sh,
                  const uint32_t* __restrict__ phat_mt,
                  const uint32_t* __restrict__ q_mod_c,
                  const uint32_t* __restrict__ q_mod_c_sh,
                  const uint32_t* __restrict__ inv_mt_c,
                  const uint32_t* __restrict__ inv_mt_c_sh, uint32_t inv_q_mt,
                  const uint32_t* __restrict__ floor_inv_phat,
                  const uint32_t* __restrict__ floor_inv_phat_sh,
                  const uint32_t* __restrict__ floor_phat,
                  const uint32_t* __restrict__ floor_phat_sh,
                  const uint32_t* __restrict__ inv_q_c,
                  const uint32_t* __restrict__ inv_q_c_sh,
                  const uint32_t* __restrict__ cp, const uint32_t* __restrict__ mu,
                  const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                  const uint32_t* __restrict__ ipsi,
                  const uint32_t* __restrict__ ipsi_sh,
                  const uint32_t* __restrict__ n_inv,
                  const uint32_t* __restrict__ n_inv_sh, int k, int logn,
                  uint32_t* scratch) {
  constexpr bool HALF = FORM >= 1, COMPACT = FORM == 2;
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int half = n / kRowSplit;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = rank / kRowSplit, h = rank % kRowSplit;
  // input row r, NTT form (with HALF its positions from `first` on only;
  // COMPACT: in global scratch, unpadded, the cluster's rows together)
  uint32_t* ours = COMPACT ? scratch + (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y)
                                           * (4 * kRowSplit) * half
                           : nullptr;
  uint32_t* row = COMPACT ? ours + static_cast<size_t>(rank) * half : sm;
  const int first = HALF ? h * half : 0;
  // the sweeps' passes
  uint32_t* work = COMPACT ? sm : sm + fhe::padded(HALF ? half : n);
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int batch = gridDim.y;
  const uint32_t c = cp[j];
  const size_t tab = static_cast<size_t>(j) * n;
  // the two CTAs of row r share its transforms through their work rows
  static_assert(kRowSplit == 2, "the split below names both CTAs of a row");
  const fhe::RowSplit<kRowSplit> split{{cluster.map_shared_rank(work, r * kRowSplit),
                                        cluster.map_shared_rank(work, r * kRowSplit + 1)},
                                       h};
  auto sync = [&] { cluster.sync(); };
  // 1. SmMRq lift of row r into c_j (lift.cuh's steps), fused into the
  // forward transform's first pass: a group of coefficients at once,
  // source prime by source prime, so that a thread has a whole group's
  // loads in flight
  const uint32_t qc = q_mod_c[j], qc_sh = q_mod_c_sh[j];
  const uint32_t imt = inv_mt_c[j], imt_sh = inv_mt_c_sh[j];
  const uint32_t* src = ab + r * ab_sc + b * ab_sb;
  const uint32_t* lp = lift_phat + j * k;
  const uint32_t* lp_sh = lift_phat_sh + j * k;
  auto lift = [&](auto& x, int base, int logs) {
    lift_group(x, src, ab_sp, base, logs, k, q, mt_inv_phat, mt_inv_phat_sh, lp, lp_sh, phat_mt,
               c, inv_q_mt, qc, qc_sh, imt, imt_sh);
  };
  auto kept = [&] {
    if constexpr (COMPACT)   // the last pass's group is consecutive (logs = 0)
      return [=](auto& v, int base, int) { fhe::store_run(row, base - first, v); };
    else
      return fhe::SmemStoreFrom{row, first};
  }();
  fhe::fwd_ntt_regs_split<kRowSplit, COMPACT>(work, split, sync, logn, c, psi + tab,
                                              psi_sh + tab, lift, kept);
  if constexpr (COMPACT) __threadfence();    // the transformed rows, to the peers
  cluster.sync();
  if (r < 3) {
    // 2. tensor product row r, positions [h n/2, (h+1) n/2), from the
    // peers' rows (x0, x1, y0, y1 = a0, a1, b0, b1) into the working row:
    // c0 = x0*y0, c1 = x0*y1 + x1*y0, c2 = x1*y1.  Consecutive threads read
    // consecutive coefficients of a peer, which keeps the remote reads
    // coalesced; read group-wise in the inverse's first pass instead, 16
    // consecutive words per thread, every remote request scatters, and the
    // kernel took 1.5 times as long (PERF.md).  t is folded into n_inv.
    const uint32_t muj = mu[j];
    auto peer_row = [&](int q) -> const uint32_t* {
      const int peer = q * kRowSplit + h;
      return COMPACT ? ours + static_cast<size_t>(peer) * half : cluster.map_shared_rank(row, peer);
    };
    const uint32_t* x0 = peer_row(0);
    const uint32_t* x1 = peer_row(1);
    const uint32_t* y0 = peer_row(2);
    const uint32_t* y1 = peer_row(3);
    const uint32_t* pa = r == 0 ? x0 : x1;
    const uint32_t* pb = r == 0 ? y0 : y1;
    // position x of the half: work[e] (e from `first` on where COMPACT),
    // the peers' rows at f (unpadded in scratch)
    const int end = (h + 1) * half;
#pragma unroll 8
    for (int x = h * half + threadIdx.x; x < end; x += blockDim.x) {
      const int e = fhe::padded_index(COMPACT ? x - first : x);
      const int f = COMPACT ? x - first : fhe::padded_index(x - first);
      work[e] = r == 1 ? fhe::add_mod(fhe::mul_barrett(x0[f], y1[f], c, muj),
                                      fhe::mul_barrett(x1[f], y0[f], c, muj), c)
                       : fhe::mul_barrett(pa[f], pb[f], c, muj);
    }
    __syncthreads();
    // 3. FastFloor against row r of the q-side product, fused into the
    // inverse's last pass
    const uint32_t iq = inv_q_c[j], iq_sh = inv_q_c_sh[j];
    const uint32_t* tsrc = txq + r * tx_sc + b * tx_sb;
    const uint32_t* fp = floor_phat + j * k;
    const uint32_t* fp_sh = floor_phat_sh + j * k;
    uint32_t* dst = out + ((static_cast<size_t>(j) * 3 + r) * batch + b) * n;
    auto floored = [&](auto& x, int base, int logs) {
      floor_group(x, tsrc, tx_sp, dst, base, logs, k, q, floor_inv_phat, floor_inv_phat_sh, fp,
                  fp_sh, c, iq, iq_sh);
    };
    fhe::inv_ntt_regs_split<kRowSplit, COMPACT>(work, split, sync, logn, c, ipsi + tab,
                                                ipsi_sh + tab, n_inv[j], n_inv_sh[j],
                                                fhe::own_load<COMPACT>(work, first), floored);
  } else {
    cluster.sync();      // the barrier inside the output rows' inverse
  }
  // the peers read this CTA's rows above: no CTA leaves (and frees its
  // shared memory) before all have
  cluster.sync();
}

// bsk_branch_kernel's QUARTER form (3; n = 131072, where even the compact
// split's padded half row exceeds a block): the same three steps on
// quarter.cuh's schedule, a portable cluster of 8 CTAs per (element, Bsk
// prime c_j) that shares each row over four CTAs (a padded quarter row
// each), lifting input row r in the first pass of its forward transform
// (two rounds of two rows) and flooring product row r in the last pass of
// its inverse (two rounds); the transformed rows go to `scratch`, 4n words
// per cluster, that of cluster (b, j) at scratch + (j * B + b) * 4n.
// bsk_branch_kernel's parameters, so one entry point takes both.
__global__ void __launch_bounds__(512)
bsk_branch_quarter_kernel(const uint32_t* __restrict__ ab, int ab_sp, int ab_sc, int ab_sb,
                          const uint32_t* __restrict__ txq, int tx_sp, int tx_sc, int tx_sb,
                          uint32_t* __restrict__ out, const uint32_t* __restrict__ q,
                          const uint32_t* __restrict__ mt_inv_phat,
                          const uint32_t* __restrict__ mt_inv_phat_sh,
                          const uint32_t* __restrict__ lift_phat,
                          const uint32_t* __restrict__ lift_phat_sh,
                          const uint32_t* __restrict__ phat_mt,
                          const uint32_t* __restrict__ q_mod_c,
                          const uint32_t* __restrict__ q_mod_c_sh,
                          const uint32_t* __restrict__ inv_mt_c,
                          const uint32_t* __restrict__ inv_mt_c_sh, uint32_t inv_q_mt,
                          const uint32_t* __restrict__ floor_inv_phat,
                          const uint32_t* __restrict__ floor_inv_phat_sh,
                          const uint32_t* __restrict__ floor_phat,
                          const uint32_t* __restrict__ floor_phat_sh,
                          const uint32_t* __restrict__ inv_q_c,
                          const uint32_t* __restrict__ inv_q_c_sh,
                          const uint32_t* __restrict__ cp, const uint32_t* __restrict__ mu,
                          const uint32_t* __restrict__ psi,
                          const uint32_t* __restrict__ psi_sh,
                          const uint32_t* __restrict__ ipsi,
                          const uint32_t* __restrict__ ipsi_sh,
                          const uint32_t* __restrict__ n_inv,
                          const uint32_t* __restrict__ n_inv_sh, int k, int logn,
                          uint32_t* scratch) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int batch = gridDim.y;
  const uint32_t c = cp[j];
  const size_t tab = static_cast<size_t>(j) * n;
  uint32_t* ours = scratch + (static_cast<size_t>(j) * batch + b) * 4 * n;
  const uint32_t qc = q_mod_c[j], qc_sh = q_mod_c_sh[j];
  const uint32_t imt = inv_mt_c[j], imt_sh = inv_mt_c_sh[j];
  const uint32_t iq = inv_q_c[j], iq_sh = inv_q_c_sh[j];
  const uint32_t* lp = lift_phat + j * k;
  const uint32_t* lp_sh = lift_phat_sh + j * k;
  const uint32_t* fp = floor_phat + j * k;
  const uint32_t* fp_sh = floor_phat_sh + j * k;
  fhe::quarter_product(
      cluster, sm, ours, logn, c, mu[j], psi + tab, psi_sh + tab, ipsi + tab, ipsi_sh + tab,
      n_inv[j], n_inv_sh[j],
      [&](int r, auto& x, int base, int logs) {
        lift_group(x, ab + r * ab_sc + b * ab_sb, ab_sp, base, logs, k, q, mt_inv_phat,
                   mt_inv_phat_sh, lp, lp_sh, phat_mt, c, inv_q_mt, qc, qc_sh, imt, imt_sh);
      },
      [&](int r, auto& x, int base, int logs) {
        floor_group(x, txq + r * tx_sc + b * tx_sb, tx_sp,
                    out + ((static_cast<size_t>(j) * 3 + r) * batch + b) * n, base, logs, k, q,
                    floor_inv_phat, floor_inv_phat_sh, fp, fp_sh, c, iq, iq_sh);
      });
}

// The base-conversion kernel: fast_bconv_sk_fused (lane SK, with or without
// the digits lane) and fast_floor_fused (lane Floor alone, and lane FloorSK,
// the floor with the Shenoy-Kumaresan conversion after it).  One thread owns
// V consecutive coefficients of every row: it forms each source digit once
// and reuses it for every destination prime.  A conversion sum
// sum_i y_i * w_i mod c of digits y_i < 2^30 and table words w_i < 2^30
// accumulates unreduced in 64 bits (one IMAD.WIDE a term) and is reduced
// once (fhe::reduce_wide): the Shoup product and modular add per term of
// the TPU kernels' form take ten instructions, and the sum in that form is
// one dependent chain of modular adds.  Sixteen such products stay below
// 2^64 and seventeen can wrap, so a longer sum is folded with reduce_wide
// after every kFold terms and goes on adding: a value below 2^30 plus 16
// products below 2^60 is still below 2^64.
enum Lane : int { kLaneSK = 0, kLaneFloor = 1, kLaneFloorSK = 2 };

// The fixed instances: KB = kMinKb .. kMaxKb Bsk primes (KB - 1 aux + m_sk;
// their aux sums have at most 16 terms and never fold) and a floor from at
// most kMaxFloorK q primes (one group of loads).  The wide instance (WIDE,
// one word per thread) has room for kWideKb Bsk primes and takes kb at run
// time; its floor loads the q rows in groups of kFold, up to kWideFloorK.
// Past either, the deep instance takes up to kDeepMaxK q primes and
// kDeepMaxKb Bsk primes (DeepSmem at these counts fits a block), and past
// those the tiled instance (conv_tiled_product_kernel) takes the rest.
// ops/rns_cuda.py (CONV_MIN_KB, CONV_FIXED_KB, CONV_FIXED_FLOOR_K,
// CONV_WIDE_KB, CONV_WIDE_FLOOR_K, CONV_DEEP_KB, CONV_DEEP_K) picks the
// instance and checks a call against them.
constexpr int kMinKb = 2;
constexpr int kMaxKb = 17;
constexpr int kMaxFloorK = 16;
constexpr int kWideKb = 33;
constexpr int kWideFloorK = 32;
constexpr int kDeepMaxK = 108;
constexpr int kDeepMaxKb = 112;
constexpr int kFold = 16;
static_assert(kMaxKb - 1 <= kFold && kMaxFloorK == kFold && kWideFloorK % kFold == 0,
              "the fixed instances' sums must not fold; the wide floor loads whole groups");

// The lanes' constants: pointers to the wrapper's per-prime tensors
// (ops/rns.py SKConsts, FastFloorConsts, the relinearization's inv_qhat),
// passed by value.  A lane stages what it reads in shared memory, so every
// thread reads each table word from there, not from global memory.
struct ConvConsts {
  const uint32_t* aux;              // [L] aux primes b_i (Bsk = aux + m_sk)
  const uint32_t* aux_inv_phat;     // [L] (B/b_i)^-1 mod b_i, Shoup
  const uint32_t* aux_inv_phat_sh;
  const uint32_t* phat_q;           // [k, L] (B/b_i) mod q_j
  const uint32_t* phat_sk;          // [L] (B/b_i) mod m_sk
  const uint32_t* q;                // [k] SK destination primes
  const uint32_t* q_wide;           // [k, 3] 2^32 mod q_j, Shoup, floor(2^32/q_j)
  const uint32_t* msk_wide;         // [1, 3] the same for m_sk
  const uint32_t* b_mod_q;          // [k] B mod q_j, Shoup
  const uint32_t* b_mod_q_sh;
  const uint32_t* w;                // [k] digits: (q/q_j)^-1 mod q_j, Shoup
  const uint32_t* w_sh;
  const uint32_t* fq;               // [k] floor source primes
  const uint32_t* f_inv_phat;       // [k] (q/q_i)^-1 mod q_i, Shoup
  const uint32_t* f_inv_phat_sh;
  const uint32_t* f_phat;           // [KB, k] (q/q_i) mod c_j
  const uint32_t* cp;               // [KB] floor destination primes
  const uint32_t* c_wide;           // [KB, 3] as q_wide
  const uint32_t* inv_q_c;          // [KB] q^-1 mod c_j, Shoup
  const uint32_t* inv_q_c_sh;
  uint32_t m_sk, inv_b, inv_b_sh;   // B^-1 mod m_sk, Shoup
  int k;
  int kb;                           // Bsk primes (the wide instance reads it)
};

// Where a lane's staged constants lie in shared memory: 16-byte quads
// (p, 2^32 mod p, its Shoup companion, floor(2^32/p)) of the destination
// primes, then 8-byte pairs (value, Shoup companion), then single words.
// Offsets in quads, pairs and words.
struct ConvSmem {
  int qw, cw, quads;
  int ainv, bq, w, finv, iq, pairs;
  int phq, psk, fph, aux, fq, words;
  __host__ __device__ ConvSmem(int lane, int k, int kb, bool digits) {
    const bool sk = lane != kLaneFloor, fl = lane != kLaneSK;
    const int l = kb - 1;
    int u = 0;
    qw = u;   u += sk ? k + 1 : 0;      // the k q primes, then m_sk
    cw = u;   u += fl ? kb : 0;
    quads = u;
    int p = 0;
    ainv = p; p += sk ? l : 0;
    bq = p;   p += sk ? k : 0;
    w = p;    p += sk && digits ? k : 0;
    finv = p; p += fl ? k : 0;
    iq = p;   p += fl ? kb : 0;
    pairs = p;
    int o = 0;
    phq = o;  o += sk ? k * l : 0;
    psk = o;  o += sk ? l : 0;
    fph = o;  o += fl ? kb * k : 0;
    aux = o;  o += sk ? l : 0;
    fq = o;   o += fl ? k : 0;
    words = o;
  }
  __host__ __device__ size_t bytes() const {
    return 16 * static_cast<size_t>(quads) + 8 * pairs + 4 * words;
  }
};

__device__ __forceinline__ void stage_quads(uint4* dst, const uint32_t* p, const uint32_t* wide,
                                            int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x)
    dst[t] = make_uint4(p[t], wide[3 * t], wide[3 * t + 1], wide[3 * t + 2]);
}

__device__ __forceinline__ void stage_pairs(uint2* dst, const uint32_t* v, const uint32_t* sh,
                                            int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = make_uint2(v[t], sh[t]);
}

__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* v, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = v[t];
}

// V consecutive words at p: one 8-byte access where `vec` says p is aligned
// to it, else a word at a time.
template <int V>
__device__ __forceinline__ void load_words(uint32_t (&x)[V], const uint32_t* p, bool vec) {
  if constexpr (V == 2) {
    if (vec) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      x[0] = u.x; x[1] = u.y;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = p[v];
}

// The outputs the wrapper allocates start 16-byte aligned, and every offset
// a thread stores at is a multiple of V words.
template <int V>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// Lane SK: src [kb, count] (the l = kb - 1 aux rows, then the m_sk row),
// out [k, count] in q; with the digits lane (dig not null), also
// dig [k, count - dstart]: the digits [out_j * (q/q_j)^-1]_{q_j} of the
// words from dstart on (the c2 rows, component-major).  Lane Floor: src
// [k, count] the residues of t*x in q, txb [kb, count] those in Bsk, out
// [kb, count] = (txb - conv(src)) * q^-1.  Lane FloorSK: the floored
// residues stay in registers and go through lane SK, out [k, count] (and
// dig).  Thread t of block b owns words e .. e + V - 1, e = (b * blockDim
// + t) * V, of every row.  The wrapper keeps every offset below 2^31.
// kb is KB, or with WIDE cc.kb <= KB: the register arrays are sized by KB
// and indexed at compile time, each loop over them stopping at kb or l.
template <int LaneT, int V, int KB, bool WIDE>
__global__ void __launch_bounds__(256)
base_conv_kernel(const uint32_t* __restrict__ src, const uint32_t* __restrict__ txb,
                 uint32_t* __restrict__ out, uint32_t* __restrict__ dig, const ConvConsts cc,
                 int count, int dstart, int vec) {
  constexpr int L = KB - 1;
  constexpr bool kSK = LaneT != kLaneFloor;
  constexpr bool kFloor = LaneT != kLaneSK;
  extern __shared__ uint4 conv_quads[];
  const int k = cc.k;
  const int kb = WIDE ? cc.kb : KB;
  const int l = kb - 1;
  const bool digits = kSK && dig != nullptr;
  const ConvSmem lay(LaneT, k, kb, digits);
  uint2* pairs = reinterpret_cast<uint2*>(conv_quads + lay.quads);
  uint32_t* words = reinterpret_cast<uint32_t*>(pairs + lay.pairs);
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool active = e < count;
  // 1. this thread's kb rows first (the aux and m_sk rows, or t*x in Bsk),
  // so that their loads are in flight while the constants are staged
  const uint32_t* rows = kFloor ? txb : src;
  uint32_t x[KB][V];
  if (active) {
#pragma unroll
    for (int r = 0; r < KB; ++r)
      if (r < kb) load_words<V>(x[r], rows + r * count + e, vec);
  }
  if constexpr (kSK) {
    stage_quads(conv_quads + lay.qw, cc.q, cc.q_wide, k);
    if (threadIdx.x == 0)
      conv_quads[lay.qw + k] = make_uint4(cc.m_sk, cc.msk_wide[0], cc.msk_wide[1],
                                          cc.msk_wide[2]);
    stage_pairs(pairs + lay.ainv, cc.aux_inv_phat, cc.aux_inv_phat_sh, l);
    stage_pairs(pairs + lay.bq, cc.b_mod_q, cc.b_mod_q_sh, k);
    if (digits) stage_pairs(pairs + lay.w, cc.w, cc.w_sh, k);
    stage_words(words + lay.phq, cc.phat_q, k * l);
    stage_words(words + lay.psk, cc.phat_sk, l);
    stage_words(words + lay.aux, cc.aux, l);
  }
  if constexpr (kFloor) {
    stage_quads(conv_quads + lay.cw, cc.cp, cc.c_wide, kb);
    stage_pairs(pairs + lay.finv, cc.f_inv_phat, cc.f_inv_phat_sh, k);
    stage_pairs(pairs + lay.iq, cc.inv_q_c, cc.inv_q_c_sh, kb);
    stage_words(words + lay.fph, cc.f_phat, kb * k);
    stage_words(words + lay.fq, cc.fq, k);
  }
  __syncthreads();
  if (!active) return;
  const uint2* ainv = pairs + lay.ainv;
  const uint32_t* aux = words + lay.aux;
  uint32_t y[L][V];   // the aux digits [x_i * (B/b_i)^-1]_{b_i}
  uint32_t xm[V];     // the m_sk residue
  if constexpr (kFloor) {
    // 2a. FastFloor into all kb primes: each digit of t*x in q once, its
    // products with every Bsk prime's table word summed unreduced
    const uint4* cw = conv_quads + lay.cw;
    const uint2* finv = pairs + lay.finv;
    const uint2* iq = pairs + lay.iq;
    const uint32_t* fph = words + lay.fph;
    const uint32_t* fq = words + lay.fq;
    uint64_t acc[KB][V];
#pragma unroll
    for (int c = 0; c < KB; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] = 0;
    // the k source rows in groups of kFold (the fixed instances: one group),
    // every load of a group in flight at once; the sums fold between groups
    constexpr int kGroups = WIDE ? kWideFloorK / kFold : 1;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int i0 = g * kFold;
      if (g > 0 && i0 >= k) break;
      uint32_t t[kFold][V];
#pragma unroll
      for (int i = 0; i < kFold; ++i)
        if (i0 + i < k) load_words<V>(t[i], src + (i0 + i) * count + e, vec);
#pragma unroll
      for (int i = 0; i < kFold; ++i) {
        if (i0 + i >= k) break;
        const uint2 fi = finv[i0 + i];
        const uint32_t qi = fq[i0 + i];
#pragma unroll
        for (int v = 0; v < V; ++v) t[i][v] = fhe::mul_shoup(t[i][v], fi.x, fi.y, qi);
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          if (c >= kb) break;
          const uint32_t ph = fph[c * k + i0 + i];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[c][v] += static_cast<uint64_t>(t[i][v]) * ph;
        }
      }
      if (g + 1 < kGroups && i0 + kFold < k) {
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          if (c >= kb) break;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[c][v] = fhe::reduce_wide(acc[c][v], cw[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      if (c >= kb) break;
      const uint4 pw = cw[c];
      const uint2 iqc = iq[c];
      uint32_t fl[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        fl[v] = fhe::mul_shoup(fhe::sub_mod(x[c][v], fhe::reduce_wide(acc[c][v], pw), pw.x),
                               iqc.x, iqc.y, pw.x);
      if constexpr (LaneT == kLaneFloor) {
        store_words<V>(out + c * count + e, fl);
      } else if (c < l) {
        // 2b. the floored residue goes straight into its aux digit
#pragma unroll
        for (int v = 0; v < V; ++v) y[c][v] = fhe::mul_shoup(fl[v], ainv[c].x, ainv[c].y, aux[c]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xm[v] = fl[v];
      }
    }
    if constexpr (LaneT == kLaneFloor) return;
  } else {
    // 2. the aux digits, once per coefficient, and the m_sk residue (row l)
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (i >= l) break;
#pragma unroll
      for (int v = 0; v < V; ++v) y[i][v] = fhe::mul_shoup(x[i][v], ainv[i].x, ainv[i].y, aux[i]);
    }
#pragma unroll
    for (int r = 0; r < KB; ++r)
      if (r == l)
#pragma unroll
        for (int v = 0; v < V; ++v) xm[v] = x[r][v];
  }
  if constexpr (kSK) {
    // 3. alpha = (conv_sk - x_msk) * B^-1 mod m_sk, once per coefficient
    const uint4* qw = conv_quads + lay.qw;
    const uint32_t* psk = words + lay.psk;
    const uint4 mw = qw[k];
    const uint32_t msk = mw.x;
    uint32_t alpha[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint64_t s = 0;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i >= l) break;
        s += static_cast<uint64_t>(y[i][v]) * psk[i];
        if (i % kFold == kFold - 1 && i + 1 < l) s = fhe::reduce_wide(s, mw);
      }
      alpha[v] = fhe::mul_shoup(fhe::sub_mod(fhe::reduce_wide(s, mw), xm[v], msk), cc.inv_b,
                                cc.inv_b_sh, msk);
    }
    // 4. every destination prime q_j from the same digits: the conversion,
    // the centred correction alpha * B, and the relinearization digit
    const uint32_t* phq = words + lay.phq;
    const uint2* bq = pairs + lay.bq;
    const uint2* wd = pairs + lay.w;
    const bool dig_word = digits && e >= dstart;
    const int dcount = count - dstart;
    for (int j = 0; j < k; ++j) {
      const uint4 pw = qw[j];
      const uint32_t qj = pw.x;
      const uint32_t* ph = phq + j * l;
      const uint2 b = bq[j];
      uint32_t o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint64_t s = 0;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          if (i >= l) break;
          s += static_cast<uint64_t>(y[i][v]) * ph[i];
          if (i % kFold == kFold - 1 && i + 1 < l) s = fhe::reduce_wide(s, pw);
        }
        // centred alpha mod q_j: alpha itself, or q_j - (m_sk - alpha)
        const uint32_t aq = alpha[v] <= (msk >> 1) ? alpha[v] : qj - (msk - alpha[v]);
        o[v] = fhe::sub_mod(fhe::reduce_wide(s, pw), fhe::mul_shoup(aq, b.x, b.y, qj), qj);
      }
      store_words<V>(out + j * count + e, o);
      if (dig_word) {
        const uint2 wj = wd[j];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = fhe::mul_shoup(o[v], wj.x, wj.y, qj);
        store_words<V>(dig + j * dcount + (e - dstart), o);
      }
    }
  }
}

// The deep instance of the base-conversion kernel's lanes, for the bases
// past the wide instance (kb > kWideKb, or a floor from more than
// kWideFloorK q primes): k and kb at run time, up to kDeepMaxK and
// kDeepMaxKb.  A thread owns one word of every row, as the wide instance,
// but keeps its digits in its own row of shared memory, not in registers
// (at kb = 68 the register form would need 135 words of digits and 136 of
// floor sums a thread): the floor's digits of t*x in q (lanes Floor and
// FloorSK) and the aux digits (SK, FloorSK).  Every sum over them is a
// wide_dot against a staged table row, a 16-byte word of each at a time.
constexpr bool conv_deep(int lane, int kb, int k) {
  return kb > kWideKb || (lane != kLaneSK && k > kWideFloorK);
}

// Threads per CTA of the deep instance (ops/rns_cuda.py: CONV_DEEP_THREADS),
// and the shared memory a block may have on sm_90
constexpr int kDeepThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;

// The deep instance's row stride for `count` words: the least number at
// least count that is 4 mod 8, so a row is read in 16-byte words and the
// rows of 8 consecutive threads start in 8 distinct quarters of the banks
// (a quarter warp's 16-byte loads without a conflict).
__host__ __device__ constexpr int deep_stride(int count) { return (count + 3) / 8 * 8 + 4; }

// Where the deep instance's staged constants and digit rows lie in shared
// memory: ConvSmem's quads, then its pairs (rounded up to whole 16-byte
// words), then words: the [k, l] and [kb, k] tables (phat_q, f_phat) and
// phat_sk with rows of deep_stride words, zero past the last term; aux and
// fq; then from a 16-byte boundary each thread's row of `row` words: its
// floor digits (stride_k words) and its aux digits.
struct DeepSmem {
  int stride_l = 0, stride_k = 0, row = 0;
  int qw = 0, cw = 0, quads = 0;
  int ainv = 0, bq = 0, w = 0, finv = 0, iq = 0, pairs = 0;
  int phq = 0, psk = 0, fph = 0, aux = 0, fq = 0, words = 0;
  __host__ __device__ constexpr DeepSmem(int lane, int k, int kb, bool digits) {
    const bool sk = lane != kLaneFloor, fl = lane != kLaneSK;
    const int l = kb - 1;
    stride_l = deep_stride(l);
    stride_k = deep_stride(k);
    row = deep_stride((fl ? stride_k : 0) + (sk ? stride_l : 0));
    int u = 0;
    qw = u;   u += sk ? k + 1 : 0;      // the k q primes, then m_sk
    cw = u;   u += fl ? kb : 0;
    quads = u;
    int p = 0;
    ainv = p; p += sk ? l : 0;
    bq = p;   p += sk ? k : 0;
    w = p;    p += sk && digits ? k : 0;
    finv = p; p += fl ? k : 0;
    iq = p;   p += fl ? kb : 0;
    pairs = (p + 1) & ~1;
    int o = 0;
    phq = o;  o += sk ? k * stride_l : 0;
    psk = o;  o += sk ? stride_l : 0;
    fph = o;  o += fl ? kb * stride_k : 0;
    aux = o;  o += sk ? l : 0;
    fq = o;   o += fl ? k : 0;
    words = (o + 3) & ~3;
  }
  __host__ __device__ constexpr size_t bytes() const {
    return 16 * static_cast<size_t>(quads) + 8 * static_cast<size_t>(pairs)
           + 4 * (static_cast<size_t>(words) + static_cast<size_t>(kDeepThreads) * row);
  }
};
// FloorSK with the digits at the caps is the largest layout of all
static_assert(DeepSmem(kLaneFloorSK, kDeepMaxK, kDeepMaxKb, true).bytes() <= kMaxSmem,
              "the deep instance must fit a block at its caps");

// A row-major [rows, cols] table into rows of `stride` words, zero from
// column cols on.
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* v, int rows, int cols,
                                           int stride) {
  for (int t = threadIdx.x; t < rows * stride; t += blockDim.x) {
    const int r = t / stride, c = t - r * stride;
    dst[t] = c < cols ? v[r * cols + c] : 0u;
  }
}

// sum_i y[i] * w[i] mod pw.x over i < count: y and w 16-byte aligned rows,
// w zero from count on to the next multiple of 4.  A 16-byte word of each
// at a time into four unreduced 64-bit sums of a term each, which fold
// into one with reduce_wide after every kFold terms while more follow: the
// four together hold a value below 2^30 and at most 16 products below 2^60.
__device__ __forceinline__ uint32_t wide_dot(const uint32_t* y, const uint32_t* w, int count,
                                             uint4 pw) {
  uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 4
  for (int i = 0; i < count; i += 4) {
    if (i > 0 && i % kFold == 0) {
      s0 = fhe::reduce_wide(s0 + s1 + s2 + s3, pw);
      s1 = s2 = s3 = 0;
    }
    const uint4 a = *reinterpret_cast<const uint4*>(y + i);
    const uint4 b = *reinterpret_cast<const uint4*>(w + i);
    s0 += static_cast<uint64_t>(a.x) * b.x;
    s1 += static_cast<uint64_t>(a.y) * b.y;
    s2 += static_cast<uint64_t>(a.z) * b.z;
    s3 += static_cast<uint64_t>(a.w) * b.w;
  }
  return fhe::reduce_wide(s0 + s1 + s2 + s3, pw);
}

// f(i, src[i * count + e]) for each of `rows` rows, the loads of a group
// of 8 in flight at once.
template <class F>
__device__ __forceinline__ void each_row(const uint32_t* __restrict__ src, int rows, int count,
                                         int e, F f) {
  constexpr int kGroup = 8;
  for (int i0 = 0; i0 < rows; i0 += kGroup) {
    uint32_t x[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i0 + i < rows) x[i] = __ldg(src + (i0 + i) * count + e);
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i0 + i < rows) f(i0 + i, x[i]);
  }
}

// The lanes as base_conv_kernel computes them, with one word per thread,
// e = blockIdx.x * blockDim.x + threadIdx.x, and the digits in shared memory.
template <int LaneT>
__global__ void __launch_bounds__(256)
base_conv_deep_kernel(const uint32_t* __restrict__ src, const uint32_t* __restrict__ txb,
                      uint32_t* __restrict__ out, uint32_t* __restrict__ dig,
                      const ConvConsts cc, int count, int dstart, int) {
  constexpr bool kSK = LaneT != kLaneFloor;
  constexpr bool kFloor = LaneT != kLaneSK;
  extern __shared__ uint4 conv_quads[];
  const int k = cc.k, kb = cc.kb, l = kb - 1;
  const bool digits = kSK && dig != nullptr;
  const DeepSmem lay(LaneT, k, kb, digits);
  uint2* pairs = reinterpret_cast<uint2*>(conv_quads + lay.quads);
  uint32_t* words = reinterpret_cast<uint32_t*>(pairs + lay.pairs);
  if constexpr (kSK) {
    stage_quads(conv_quads + lay.qw, cc.q, cc.q_wide, k);
    if (threadIdx.x == 0)
      conv_quads[lay.qw + k] = make_uint4(cc.m_sk, cc.msk_wide[0], cc.msk_wide[1],
                                          cc.msk_wide[2]);
    stage_pairs(pairs + lay.ainv, cc.aux_inv_phat, cc.aux_inv_phat_sh, l);
    stage_pairs(pairs + lay.bq, cc.b_mod_q, cc.b_mod_q_sh, k);
    if (digits) stage_pairs(pairs + lay.w, cc.w, cc.w_sh, k);
    stage_rows(words + lay.phq, cc.phat_q, k, l, lay.stride_l);
    stage_rows(words + lay.psk, cc.phat_sk, 1, l, lay.stride_l);
    stage_words(words + lay.aux, cc.aux, l);
  }
  if constexpr (kFloor) {
    stage_quads(conv_quads + lay.cw, cc.cp, cc.c_wide, kb);
    stage_pairs(pairs + lay.finv, cc.f_inv_phat, cc.f_inv_phat_sh, k);
    stage_pairs(pairs + lay.iq, cc.inv_q_c, cc.inv_q_c_sh, kb);
    stage_rows(words + lay.fph, cc.f_phat, kb, k, lay.stride_k);
    stage_words(words + lay.fq, cc.fq, k);
  }
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  uint32_t* fd = words + lay.words + threadIdx.x * lay.row;   // the floor's digits
  uint32_t* yd = fd + (kFloor ? lay.stride_k : 0);             // the aux digits
  const uint2* ainv = pairs + lay.ainv;
  const uint32_t* aux = words + lay.aux;
  [[maybe_unused]] uint32_t xm = 0;                            // the m_sk residue
  if constexpr (kFloor) {
    // 1a. the digits of t*x in q, then FastFloor into each Bsk prime c
    const uint4* cw = conv_quads + lay.cw;
    const uint2* finv = pairs + lay.finv;
    const uint2* iq = pairs + lay.iq;
    const uint32_t* fq = words + lay.fq;
    each_row(src, k, count, e, [&](int i, uint32_t x) {
      fd[i] = fhe::mul_shoup(x, finv[i].x, finv[i].y, fq[i]);
    });
    for (int c = 0; c < kb; ++c) {
      const uint32_t xc = __ldg(txb + c * count + e);
      const uint4 pw = cw[c];
      const uint32_t conv = wide_dot(fd, words + lay.fph + c * lay.stride_k, k, pw);
      const uint32_t fl = fhe::mul_shoup(fhe::sub_mod(xc, conv, pw.x), iq[c].x, iq[c].y, pw.x);
      if constexpr (LaneT == kLaneFloor) {
        out[c * count + e] = fl;
      } else if (c < l) {
        // 1b. the floored residue goes straight into its aux digit
        yd[c] = fhe::mul_shoup(fl, ainv[c].x, ainv[c].y, aux[c]);
      } else {
        xm = fl;
      }
    }
    if constexpr (LaneT == kLaneFloor) return;
  } else {
    // 1. the aux digits and the m_sk residue (row l)
    each_row(src, kb, count, e, [&](int i, uint32_t x) {
      if (i < l)
        yd[i] = fhe::mul_shoup(x, ainv[i].x, ainv[i].y, aux[i]);
      else
        xm = x;
    });
  }
  if constexpr (kSK) {
    // 2. alpha = (conv_sk - x_msk) * B^-1 mod m_sk
    const uint4* qw = conv_quads + lay.qw;
    const uint4 mw = qw[k];
    const uint32_t msk = mw.x;
    const uint32_t alpha = fhe::mul_shoup(
        fhe::sub_mod(wide_dot(yd, words + lay.psk, l, mw), xm, msk), cc.inv_b, cc.inv_b_sh, msk);
    // 3. every destination prime q_j from the same digits: the conversion,
    // the centred correction alpha * B, and the relinearization digit
    const uint2* bq = pairs + lay.bq;
    const uint2* wd = pairs + lay.w;
    const bool dig_word = digits && e >= dstart;
    const int dcount = count - dstart;
    for (int j = 0; j < k; ++j) {
      const uint4 pw = qw[j];
      const uint32_t qj = pw.x;
      const uint2 b = bq[j];
      // centred alpha mod q_j: alpha itself, or q_j - (m_sk - alpha)
      const uint32_t aq = alpha <= (msk >> 1) ? alpha : qj - (msk - alpha);
      uint32_t o = fhe::sub_mod(wide_dot(yd, words + lay.phq + j * lay.stride_l, l, pw),
                                fhe::mul_shoup(aq, b.x, b.y, qj), qj);
      out[j * count + e] = o;
      if (dig_word) dig[j * dcount + (e - dstart)] = fhe::mul_shoup(o, wd[j].x, wd[j].y, qj);
    }
  }
}

// The fixed instance for kb Bsk primes, or null outside [kMinKb, kMaxKb].
template <int LaneT, int V, int KB = kMinKb>
const void* fixed_conv_kernel(int kb) {
  if constexpr (KB > kMaxKb) {
    return nullptr;
  } else {
    return kb == KB ? reinterpret_cast<const void*>(base_conv_kernel<LaneT, V, KB, false>)
                    : fixed_conv_kernel<LaneT, V, KB + 1>(kb);
  }
}

// The instance for kb Bsk primes and k q primes: the fixed one where kb <=
// kMaxKb and a floor lane sums at most kMaxFloorK q primes, else the wide
// one (one word per thread) up to kWideKb and kWideFloorK, else the deep
// one up to kDeepMaxKb and kDeepMaxK; null outside.
template <int LaneT, int V>
const void* conv_kernel(int kb, int k) {
  const bool fixed_k = LaneT == kLaneSK || k <= kMaxFloorK;
  if (kb >= kMinKb && kb <= kMaxKb && fixed_k) return fixed_conv_kernel<LaneT, V>(kb);
  if constexpr (V == 1) {
    if (kb >= kMinKb && kb <= kWideKb && (LaneT == kLaneSK || k <= kWideFloorK))
      return reinterpret_cast<const void*>(base_conv_kernel<LaneT, 1, kWideKb, true>);
    if (kb >= kMinKb && kb <= kDeepMaxKb && k <= kDeepMaxK)
      return reinterpret_cast<const void*>(base_conv_deep_kernel<LaneT>);
  }
  return nullptr;
}

// The lanes and words per thread the wrapper may ask for: SK at 1 or 2 (the
// wide instance at 1), the floor lanes at 1 (ops/rns_cuda.py:
// conv_geometry).
const void* pick_conv_kernel(int lane, int per_thread, int kb, int k) {
  switch (lane * 8 + per_thread) {
    case kLaneSK * 8 + 1: return conv_kernel<kLaneSK, 1>(kb, k);
    case kLaneSK * 8 + 2: return conv_kernel<kLaneSK, 2>(kb, k);
    case kLaneFloor * 8 + 1: return conv_kernel<kLaneFloor, 1>(kb, k);
    case kLaneFloorSK * 8 + 1: return conv_kernel<kLaneFloorSK, 1>(kb, k);
    default: return nullptr;
  }
}

// The tiled instance of the base-conversion kernel's lanes, for the bases
// past the deep instance (kb > kDeepMaxKb or k > kDeepMaxK, where the deep
// instance's tables and digit rows no longer fit a block), and for any base
// the wrapper forces onto it (ops/rns_cuda.py forced_tiled): k and kb at
// run time with no cap, and shared memory that does not depend on them.
// Each lane is a modular matrix product over each word e,
//   conv[j, e] = sum_i y[i, e] * T[j, i] mod p_j,
// with an epilogue: SK (y the l aux digits, T = phat_q [k, l]) subtracts the
// centred alpha * B; Floor (y the digits of t*x in q, T = f_phat [kb, k])
// takes (tx_c - conv) * q^-1.  alpha needs every aux digit of a word before
// any destination prime (the deep instance kept them in the thread's own
// row of shared memory, a row that grows with kb), so the lane runs as two
// launches that meet in global memory: conv_tiled_digits_kernel forms each
// word's digits once into scratch [rows, pitch] (SK: also the m_sk sum and
// alpha [pitch]); conv_tiled_product_kernel runs the product on tiles of
// kTileJ destination primes x kTileE words, the source digits and the table
// slice streaming through shared memory kFold source primes at a time
// (10 KB whatever k), each thread's kTileRegJ x kTileRegE unreduced 64-bit
// sums in registers, folded with reduce_wide after every kFold terms (the
// bound wide_dot relies on).  FloorSK is the floor into scratch [kb, pitch],
// then SK's two launches from there: four launches.
//
// What bounds it: the product's k * l 64-bit multiply-adds a word (7.6 G
// IMAD.WIDE for B6 at [201, 3, 65536]) and their folds, on the integer
// pipes; the digits are read from L2 once per tile of primes (the CTAs of a
// column of tiles run next to each other), the tables once per CTA.
constexpr int kTileJ = 32;                 // destination primes per CTA
constexpr int kTileE = 128;                // words per CTA
constexpr int kTileRegJ = 4;               // a thread's primes
constexpr int kTileRegE = 4;               // and words (one 16-byte word)
constexpr int kTiledThreads = 256;
constexpr int kTableStride = kTileJ + 4;   // a staged table row, 16-byte words, 2-way stores
static_assert(kTileJ * kTileE == kTiledThreads * kTileRegJ * kTileRegE
                  && kTileE / kTileRegE == 32,
              "a warp covers a row of the tile, 4 words a thread");
static_assert(kFold * kTileE / 4 == 2 * kTiledThreads && kFold * kTileJ == 2 * kTiledThreads,
              "each thread stages two 16-byte digit words and two table words a chunk");

// f(i, src[i * pitch + e]) for each of `rows` rows, the loads of a group of
// 8 in flight at once (each_row with 64-bit row offsets).
template <class F>
__device__ __forceinline__ void each_row_pitched(const uint32_t* __restrict__ src, int rows,
                                                 size_t pitch, int e, F f) {
  constexpr int kGroup = 8;
  for (int i0 = 0; i0 < rows; i0 += kGroup) {
    uint32_t x[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i0 + i < rows) x[i] = __ldg(src + (i0 + i) * pitch + e);
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i0 + i < rows) f(i0 + i, x[i]);
  }
}

// One word a thread, e < count.  Lane SK: src [kb, src_pitch] (the aux
// rows, then the m_sk row) -> y [l, pitch] the aux digits
// [x_i * (B/b_i)^-1]_{b_i}, and alpha[e] = (conv_sk - x_msk) * B^-1 mod m_sk
// (the m_sk sum folded every kFold terms).  Lane Floor: src [k, src_pitch]
// (t*x in q) -> y [k, pitch] the digits [x_i * (q/q_i)^-1]_{q_i}.
template <int LaneT>
__global__ void __launch_bounds__(kTiledThreads)
conv_tiled_digits_kernel(const uint32_t* __restrict__ src, size_t src_pitch,
                         uint32_t* __restrict__ y, uint32_t* __restrict__ alpha, size_t pitch,
                         const ConvConsts cc, int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  if constexpr (LaneT == kLaneSK) {
    const int l = cc.kb - 1;
    const uint4 mw = make_uint4(cc.m_sk, cc.msk_wide[0], cc.msk_wide[1], cc.msk_wide[2]);
    uint64_t s = 0;
    uint32_t xm = 0;
    each_row_pitched(src, cc.kb, src_pitch, e, [&](int i, uint32_t x) {
      if (i < l) {
        const uint32_t d = fhe::mul_shoup(x, __ldg(cc.aux_inv_phat + i),
                                          __ldg(cc.aux_inv_phat_sh + i), __ldg(cc.aux + i));
        y[i * pitch + e] = d;
        s += static_cast<uint64_t>(d) * __ldg(cc.phat_sk + i);
        if (i % kFold == kFold - 1 && i + 1 < l) s = fhe::reduce_wide(s, mw);
      } else {
        xm = x;
      }
    });
    alpha[e] = fhe::mul_shoup(fhe::sub_mod(fhe::reduce_wide(s, mw), xm, cc.m_sk), cc.inv_b,
                              cc.inv_b_sh, cc.m_sk);
  } else {
    each_row_pitched(src, cc.k, src_pitch, e, [&](int i, uint32_t x) {
      y[i * pitch + e] = fhe::mul_shoup(x, __ldg(cc.f_inv_phat + i), __ldg(cc.f_inv_phat_sh + i),
                                        __ldg(cc.fq + i));
    });
  }
}

// The product launch's operands: the digits y [src_rows, pitch] (pitch a
// multiple of kTileE), the table [dst_rows, src_rows] row-major, each
// destination prime's quad constants (p, 2^32 mod p, Shoup, floor(2^32/p))
// and scale (SK: B mod q_j; Floor: q^-1 mod c_j) with its Shoup companion;
// SK: alpha [pitch] and, with dig, the relinearization digits' (q/q_j)^-1
// mod q_j for the words from dstart on; Floor: txb [dst_rows, count].  out
// rows are out_pitch words apart; `vec`: count and dstart are multiples of
// 4 and out, dig and txb 16-byte aligned.
struct TiledProduct {
  const uint32_t* y;
  const uint32_t* table;
  const uint32_t* p;
  const uint32_t* wide;
  const uint32_t* scale;
  const uint32_t* scale_sh;
  const uint32_t* w;
  const uint32_t* w_sh;
  const uint32_t* alpha;
  const uint32_t* txb;
  uint32_t* out;
  uint32_t* dig;
  size_t pitch, out_pitch;
  int src_rows, dst_rows, count, dstart;
  uint32_t m_sk;
  int vec;
};

// Block b: the tile of primes b % tiles_j (tiles_j = ceil(dst_rows /
// kTileJ)) and of words b / tiles_j, so that the CTAs that read the same
// digits run next to each other.  Thread t: primes jt .. jt + 3 (its warp's
// four) and words et .. et + 3.
template <int LaneT>
__global__ void __launch_bounds__(kTiledThreads)
conv_tiled_product_kernel(const TiledProduct a) {
  __shared__ uint4 ds[kFold][kTileE / 4];
  __shared__ __align__(16) uint32_t ts[kFold][kTableStride];
  const int tid = threadIdx.x;
  const int tiles_j = (a.dst_rows + kTileJ - 1) / kTileJ;
  const int j0 = (blockIdx.x % tiles_j) * kTileJ;
  const int e0 = (blockIdx.x / tiles_j) * kTileE;
  const int pg = tid / 32, wq = tid % 32;
  const int jt = j0 + pg * kTileRegJ, et = e0 + wq * kTileRegE;
  uint4 pw[kTileRegJ];
#pragma unroll
  for (int r = 0; r < kTileRegJ; ++r) {
    const int j = min(jt + r, a.dst_rows - 1);   // a prime past the last folds its own sums
    pw[r] = make_uint4(__ldg(a.p + j), __ldg(a.wide + 3 * j), __ldg(a.wide + 3 * j + 1),
                       __ldg(a.wide + 3 * j + 2));
  }
  // chunk i0's share of this thread: digit word q of the [kFold, kTileE]
  // slice (row q / 32, 16-byte column q % 32) and table word q of the
  // [kTileJ, kFold] slice (prime q / kFold, source prime q % kFold), q = tid
  // and tid + 256; zero past the last source prime and destination prime
  uint4 rd[2];
  uint32_t rt[2];
  auto load = [&](int i0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + h * kTiledThreads;
      const int row = i0 + q / 32, jj = q / kFold, ii = i0 + q % kFold;
      rd[h] = row < a.src_rows
                  ? __ldg(reinterpret_cast<const uint4*>(a.y + row * a.pitch + e0) + q % 32)
                  : make_uint4(0, 0, 0, 0);
      rt[h] = j0 + jj < a.dst_rows && ii < a.src_rows
                  ? __ldg(a.table + static_cast<size_t>(j0 + jj) * a.src_rows + ii)
                  : 0u;
    }
  };
  uint64_t acc[kTileRegJ][kTileRegE];
#pragma unroll
  for (int r = 0; r < kTileRegJ; ++r)
#pragma unroll
    for (int v = 0; v < kTileRegE; ++v) acc[r][v] = 0;
  const int chunks = (a.src_rows + kFold - 1) / kFold;
  load(0);
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();    // every thread has read the last chunk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + h * kTiledThreads;
      ds[q / 32][q % 32] = rd[h];
      ts[q % kFold][q / kFold] = rt[h];
    }
    __syncthreads();
    if (c + 1 < chunks) load((c + 1) * kFold);    // in flight during the sums
#pragma unroll
    for (int i = 0; i < kFold; ++i) {
      const uint4 dv = ds[i][wq];
      const uint4 tv = *reinterpret_cast<const uint4*>(&ts[i][pg * kTileRegJ]);
      const uint32_t dw[kTileRegE] = {dv.x, dv.y, dv.z, dv.w};
      const uint32_t tw[kTileRegJ] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
      for (int r = 0; r < kTileRegJ; ++r)
#pragma unroll
        for (int v = 0; v < kTileRegE; ++v) acc[r][v] += static_cast<uint64_t>(tw[r]) * dw[v];
    }
    if (c + 1 < chunks) {
#pragma unroll
      for (int r = 0; r < kTileRegJ; ++r)
#pragma unroll
        for (int v = 0; v < kTileRegE; ++v) acc[r][v] = fhe::reduce_wide(acc[r][v], pw[r]);
    }
  }
  if (et >= a.count) return;
  const int words = min(kTileRegE, a.count - et);
  [[maybe_unused]] uint32_t al[kTileRegE];
  if constexpr (LaneT == kLaneSK) {
    const uint4 av = *reinterpret_cast<const uint4*>(a.alpha + et);
    al[0] = av.x; al[1] = av.y; al[2] = av.z; al[3] = av.w;
  }
  const int dcount = a.count - a.dstart;
#pragma unroll
  for (int r = 0; r < kTileRegJ; ++r) {
    const int j = jt + r;
    if (j >= a.dst_rows) break;
    const uint4 p4 = pw[r];
    const uint32_t pj = p4.x, sc = __ldg(a.scale + j), sc_sh = __ldg(a.scale_sh + j);
    uint32_t o[kTileRegE];
    if constexpr (LaneT == kLaneSK) {
      const uint32_t msk = a.m_sk;
#pragma unroll
      for (int v = 0; v < kTileRegE; ++v) {
        // centred alpha mod q_j: alpha itself, or q_j - (m_sk - alpha)
        const uint32_t aq = al[v] <= (msk >> 1) ? al[v] : pj - (msk - al[v]);
        o[v] = fhe::sub_mod(fhe::reduce_wide(acc[r][v], p4), fhe::mul_shoup(aq, sc, sc_sh, pj),
                            pj);
      }
    } else {
      const uint32_t* xr = a.txb + static_cast<size_t>(j) * a.count + et;
      uint32_t x[kTileRegE];
      if (a.vec) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xr);
        x[0] = xv.x; x[1] = xv.y; x[2] = xv.z; x[3] = xv.w;
      } else {
#pragma unroll
        for (int v = 0; v < kTileRegE; ++v) x[v] = v < words ? xr[v] : 0u;
      }
#pragma unroll
      for (int v = 0; v < kTileRegE; ++v)
        o[v] = fhe::mul_shoup(fhe::sub_mod(x[v], fhe::reduce_wide(acc[r][v], p4), pj), sc, sc_sh,
                              pj);
    }
    uint32_t* orow = a.out + j * a.out_pitch + et;
    if (a.vec) {
      *reinterpret_cast<uint4*>(orow) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int v = 0; v < kTileRegE; ++v)
        if (v < words) orow[v] = o[v];
    }
    if constexpr (LaneT == kLaneSK) {
      if (a.dig != nullptr && et + words > a.dstart) {
        const uint32_t wj = __ldg(a.w + j), wj_sh = __ldg(a.w_sh + j);
#pragma unroll
        for (int v = 0; v < kTileRegE; ++v) o[v] = fhe::mul_shoup(o[v], wj, wj_sh, pj);
        uint32_t* drow = a.dig + static_cast<size_t>(j) * dcount + (et - a.dstart);
        if (a.vec) {
          *reinterpret_cast<uint4*>(drow) = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int v = 0; v < kTileRegE; ++v)
            if (v < words && et + v >= a.dstart) drow[v] = o[v];
        }
      }
    }
  }
}

// bsk_branch_fused's column form (n >= 262144; csrc/column.cuh): three
// launches that meet in global memory.  column_lift_kernel lifts each
// coefficient of the four rows a0, a1, b0, b1 into the Bsk prime c_j
// (lift.cuh, the steps lift_group runs) and runs the forward's column
// stages; ntt.cu's block_product_kernel, on the Bsk tables, the block
// stages, the product and the block's inverse stages; column_floor_kernel
// the inverse's column stages, t n^-1 and the FastFloor against tx_q.

// y[j, r, b] (y [kb, 4, B, n]) = the top forward stages of the lift into
// c_j of row (r, b) of ab (ab's strides as bsk_branch_kernel's).  Grid
// (b / C, 4 B, kb), blockIdx.y = r * B + b, one tile per CTA.
__global__ void __launch_bounds__(256)
column_lift_kernel(const uint32_t* __restrict__ ab, int ab_sp, int ab_sc, int ab_sb,
                   uint32_t* __restrict__ y, const fhe::SmMRqOperands lo,
                   const uint32_t* __restrict__ cp, const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_sh, int logn, int logb, int logc) {
  extern __shared__ uint32_t t[];
  const int n = 1 << logn;
  const int batch = gridDim.y / 4;
  const int r = blockIdx.y / batch, b = blockIdx.y - r * batch;
  const int j = blockIdx.z;
  const uint32_t c = cp[j];
  const size_t tab = static_cast<size_t>(j) * n;
  const fhe::SmMRqLift lift(lo, j, c);
  const uint32_t* src = ab + r * ab_sc + b * ab_sb;
  const fhe::ColumnTile tile = fhe::column_tile(logn, logb, logc);
  fhe::column_load(t, tile, [&](int x) { return lift.one(src + x, ab_sp); });
  fhe::column_forward(t, tile, c, psi + tab, psi_sh + tab);
  uint32_t* yr = y + ((static_cast<size_t>(j) * 4 + r) * batch + b) * n;
  fhe::column_store(t, tile, [&](int x, uint32_t v, int) { yr[x] = v; });
}

// out[j, r, b] = FastFloor of t n^-1 times the last inverse stages of row
// (j, r, b) of x (x, out [kb, 3, B, n]) against row (r, b) of tx_q (its
// strides as bsk_branch_kernel's; floor_group's steps, one coefficient a
// thread).  Grid (b / C, 3 B, kb), blockIdx.y = r * B + b.
__global__ void __launch_bounds__(256)
column_floor_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ txq, int tx_sp,
                    int tx_sc, int tx_sb, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ floor_inv_phat,
                    const uint32_t* __restrict__ floor_inv_phat_sh,
                    const uint32_t* __restrict__ floor_phat,
                    const uint32_t* __restrict__ floor_phat_sh,
                    const uint32_t* __restrict__ inv_q_c,
                    const uint32_t* __restrict__ inv_q_c_sh, const uint32_t* __restrict__ cp,
                    const uint32_t* __restrict__ ipsi, const uint32_t* __restrict__ ipsi_sh,
                    const uint32_t* __restrict__ n_inv, const uint32_t* __restrict__ n_inv_sh,
                    int k, int logn, int logb, int logc) {
  extern __shared__ uint32_t t[];
  const int n = 1 << logn;
  const int batch = gridDim.y / 3;
  const int r = blockIdx.y / batch, b = blockIdx.y - r * batch;
  const int j = blockIdx.z;
  const uint32_t c = cp[j], ni = n_inv[j], ni_sh = n_inv_sh[j];
  const uint32_t iq = inv_q_c[j], iq_sh = inv_q_c_sh[j];
  const size_t tab = static_cast<size_t>(j) * n;
  const size_t row = ((static_cast<size_t>(j) * 3 + r) * batch + b) * n;
  const uint32_t* tsrc = txq + r * tx_sc + b * tx_sb;
  const uint32_t* fp = floor_phat + j * k;
  const uint32_t* fp_sh = floor_phat_sh + j * k;
  const fhe::ColumnTile tile = fhe::column_tile(logn, logb, logc);
  fhe::column_load(t, tile, [&](int e) { return x[row + e]; });
  fhe::column_inverse(t, tile, c, ipsi + tab, ipsi_sh + tab);
  fhe::column_store(t, tile, [&](int e, uint32_t v, int) {
    uint32_t conv = 0;
    for (int i = 0; i < k; ++i)
      fast_floor_step(tsrc[i * tx_sp + e], q[i], floor_inv_phat[i], floor_inv_phat_sh[i], fp[i],
                      fp_sh[i], c, conv);
    out[row + e] = fast_floor_close(fhe::mul_shoup(v, ni, ni_sh, c), conv, c, iq, iq_sh);
  });
}

}  // namespace

extern "C" {

// The launch geometry comes from the wrapper (ops/rns_cuda.py,
// bsk_branch_geometry): `threads` per CTA and `smem` bytes per CTA, at least
// the rows the kernel's form uses (fhe::product_words): form 0 two padded
// rows, 1 (half_row) a padded row and a padded half row, 2 (compact) a
// padded half row, 3 (quarter) a padded quarter row, with `scratch` in the
// last two (n/2 words per CTA).
int fhe_bsk_branch(const void* ab, int ab_sp, int ab_sc, int ab_sb, const void* txq,
                   int tx_sp, int tx_sc, int tx_sb,
                   void* out, const void* q,
                   const void* mt_inv_phat, const void* mt_inv_phat_sh,
                   const void* lift_phat, const void* lift_phat_sh, const void* phat_mt,
                   const void* q_mod_c, const void* q_mod_c_sh, const void* inv_mt_c,
                   const void* inv_mt_c_sh, uint32_t inv_q_mt, const void* floor_inv_phat,
                   const void* floor_inv_phat_sh, const void* floor_phat,
                   const void* floor_phat_sh, const void* inv_q_c, const void* inv_q_c_sh,
                   const void* cp, const void* mu, const void* psi, const void* psi_sh,
                   const void* ipsi, const void* ipsi_sh, const void* n_inv,
                   const void* n_inv_sh, int k, int kb, int batch, int logn, int threads,
                   int smem, int form, void* scratch, void* stream) {
  const int n = 1 << logn;
  if (logn <= fhe::kRegLog || form < 0 || form > 3 || smem < 4 * fhe::product_words(form, n)
      || (form >= 2) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // each instantiation keeps its own records (launch_tensor_product's way)
  static std::atomic<size_t> granted[4][fhe::kMaxDevices];
  static std::atomic<size_t> placed[4][fhe::kMaxDevices];
  auto* fn = form == 3 ? &bsk_branch_quarter_kernel
             : form == 2 ? &bsk_branch_kernel<2>
             : form == 1 ? &bsk_branch_kernel<1>
                         : &bsk_branch_kernel<0>;
  const void* kernel = reinterpret_cast<const void*>(fn);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(4 * kRowSplit, batch, kb), threads, smem, 4 * kRowSplit,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(
      &cfg, fn, u(ab), ab_sp,
      ab_sc, ab_sb, u(txq), tx_sp, tx_sc, tx_sb, static_cast<uint32_t*>(out), u(q), u(mt_inv_phat),
      u(mt_inv_phat_sh), u(lift_phat), u(lift_phat_sh), u(phat_mt), u(q_mod_c),
      u(q_mod_c_sh), u(inv_mt_c), u(inv_mt_c_sh), inv_q_mt, u(floor_inv_phat),
      u(floor_inv_phat_sh), u(floor_phat), u(floor_phat_sh), u(inv_q_c), u(inv_q_c_sh),
      u(cp), u(mu), u(psi), u(psi_sh), u(ipsi), u(ipsi_sh), u(n_inv), u(n_inv_sh), k,
      logn, static_cast<uint32_t*>(scratch));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One launch of base_conv_kernel: lane (kLaneSK, kLaneFloor, kLaneFloorSK),
// per_thread words per thread, kb Bsk primes, k q primes, count words per
// row, the digits from word dstart on (dig null: no digits lane), vec where
// every input row starts aligned to per_thread words, threads per CTA (the
// wrapper's conv_geometry); kb and k pick the fixed, the wide or the deep
// instance, which takes kDeepThreads threads.  Unused constants may be null.
int fhe_base_conv(int lane, int per_thread, int kb, int k, int count, int dstart, int vec,
                  int threads, const void* src, const void* txb, void* out, void* dig,
                  const void* aux, const void* aux_inv_phat, const void* aux_inv_phat_sh,
                  const void* phat_q, const void* phat_sk, const void* q, const void* q_wide,
                  const void* msk_wide, const void* b_mod_q, const void* b_mod_q_sh,
                  const void* w, const void* w_sh, const void* fq, const void* f_inv_phat,
                  const void* f_inv_phat_sh, const void* f_phat, const void* cp,
                  const void* c_wide, const void* inv_q_c, const void* inv_q_c_sh,
                  uint32_t m_sk, uint32_t inv_b, uint32_t inv_b_sh, void* stream) {
  const void* kernel = pick_conv_kernel(lane, per_thread, kb, k);
  if (kernel == nullptr || k < 1 || count < 1 || count % per_thread || threads < 32
      || threads > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool deep = conv_deep(lane, kb, k);
  if (deep && threads != kDeepThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = deep ? DeepSmem(lane, k, kb, dig != nullptr).bytes()
                           : ConvSmem(lane, k, kb, dig != nullptr).bytes();
  if (!deep && smem > fhe::kDefaultSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the deep instance of each lane keeps its own record
  static std::atomic<size_t> granted[3][fhe::kMaxDevices];
  if (deep) {
    const cudaError_t err = fhe::allow_smem(kernel, smem, granted[lane]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  ConvConsts cc{u(aux), u(aux_inv_phat), u(aux_inv_phat_sh), u(phat_q), u(phat_sk), u(q),
                u(q_wide), u(msk_wide), u(b_mod_q), u(b_mod_q_sh), u(w), u(w_sh), u(fq),
                u(f_inv_phat), u(f_inv_phat_sh), u(f_phat), u(cp), u(c_wide), u(inv_q_c),
                u(inv_q_c_sh), m_sk, inv_b, inv_b_sh, k, kb};
  const uint32_t* src_p = u(src);
  const uint32_t* txb_p = u(txb);
  uint32_t* out_p = static_cast<uint32_t*>(out);
  uint32_t* dig_p = static_cast<uint32_t*>(dig);
  void* args[] = {&src_p, &txb_p, &out_p, &dig_p, &cc, &count, &dstart, &vec};
  const int groups = count / per_thread;
  const dim3 grid((groups + threads - 1) / threads);
  const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(threads), args, smem,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The lane's launches of the tiled instance (ops/rns_cuda.py
// conv_tiled_geometry gives the same shapes): src, txb, out, dig and the
// constants as fhe_base_conv takes them; pitch a multiple of kTileE, at
// least count; scratch the lane's digits, in this order: the floor's
// [k, pitch] (Floor, FloorSK), FloorSK's floored [kb, pitch], the aux
// digits [kb - 1, pitch] and alpha [pitch] (SK, FloorSK).  Returns the
// first failed launch's error.
int fhe_base_conv_tiled(int lane, int kb, int k, int count, int dstart, int pitch, int vec,
                        const void* src, const void* txb, void* out, void* dig, void* scratch,
                        const void* aux, const void* aux_inv_phat, const void* aux_inv_phat_sh,
                        const void* phat_q, const void* phat_sk, const void* q,
                        const void* q_wide, const void* msk_wide, const void* b_mod_q,
                        const void* b_mod_q_sh, const void* w, const void* w_sh, const void* fq,
                        const void* f_inv_phat, const void* f_inv_phat_sh, const void* f_phat,
                        const void* cp, const void* c_wide, const void* inv_q_c,
                        const void* inv_q_c_sh, uint32_t m_sk, uint32_t inv_b,
                        uint32_t inv_b_sh, void* stream) {
  const bool sk = lane == kLaneSK || lane == kLaneFloorSK;
  const bool fl = lane == kLaneFloor || lane == kLaneFloorSK;
  if (!(sk || fl) || kb < kMinKb || k < 1 || count < 1 || pitch < count || pitch % kTileE
      || scratch == nullptr || (fl && txb == nullptr) || (!sk && dig != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const ConvConsts cc{u(aux), u(aux_inv_phat), u(aux_inv_phat_sh), u(phat_q), u(phat_sk), u(q),
                      u(q_wide), u(msk_wide), u(b_mod_q), u(b_mod_q_sh), u(w), u(w_sh), u(fq),
                      u(f_inv_phat), u(f_inv_phat_sh), u(f_phat), u(cp), u(c_wide), u(inv_q_c),
                      u(inv_q_c_sh), m_sk, inv_b, inv_b_sh, k, kb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t wp = static_cast<size_t>(pitch);
  uint32_t* next = static_cast<uint32_t*>(scratch);
  auto take = [&](int rows) {
    uint32_t* at = next;
    next += rows * wp;
    return at;
  };
  const dim3 digits_grid((count + kTiledThreads - 1) / kTiledThreads);
  auto product_grid = [&](int dst_rows) {
    return dim3(((dst_rows + kTileJ - 1) / kTileJ) * (pitch / kTileE));
  };
  const uint32_t* sk_src = u(src);
  size_t sk_pitch = count;
  if (fl) {
    uint32_t* fy = take(k);
    uint32_t* floored = lane == kLaneFloorSK ? take(kb) : static_cast<uint32_t*>(out);
    conv_tiled_digits_kernel<kLaneFloor><<<digits_grid, kTiledThreads, 0, st>>>(
        u(src), count, fy, nullptr, wp, cc, count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const TiledProduct fp{fy, u(f_phat), u(cp), u(c_wide), u(inv_q_c), u(inv_q_c_sh), nullptr,
                          nullptr, nullptr, u(txb), floored, nullptr, wp,
                          lane == kLaneFloor ? static_cast<size_t>(count) : wp, k, kb, count,
                          0, 0, vec};
    conv_tiled_product_kernel<kLaneFloor><<<product_grid(kb), kTiledThreads, 0, st>>>(fp);
    err = cudaGetLastError();
    if (err != cudaSuccess || !sk) return static_cast<int>(err);
    sk_src = floored;
    sk_pitch = wp;
  }
  uint32_t* yd = take(kb - 1);
  uint32_t* alpha = take(1);
  conv_tiled_digits_kernel<kLaneSK><<<digits_grid, kTiledThreads, 0, st>>>(
      sk_src, sk_pitch, yd, alpha, wp, cc, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const TiledProduct sp{yd, u(phat_q), u(q), u(q_wide), u(b_mod_q), u(b_mod_q_sh), u(w), u(w_sh),
                        alpha, nullptr, static_cast<uint32_t*>(out), static_cast<uint32_t*>(dig),
                        wp, static_cast<size_t>(count), kb - 1, k, count, dstart, m_sk, vec};
  conv_tiled_product_kernel<kLaneSK><<<product_grid(k), kTiledThreads, 0, st>>>(sp);
  return static_cast<int>(cudaGetLastError());
}


// bsk_branch_fused's column launches (ops/column_cuda.py gives every
// shape: a block of 2^logb positions, tiles of 2^logc columns, `threads`
// per CTA); the lift's and the floor's constants as fhe_bsk_branch takes
// them.
int fhe_column_lift(const void* ab, int ab_sp, int ab_sc, int ab_sb, void* y, const void* q,
                    const void* mt_inv_phat, const void* mt_inv_phat_sh, const void* lift_phat,
                    const void* lift_phat_sh, const void* phat_mt, const void* q_mod_c,
                    const void* q_mod_c_sh, const void* inv_mt_c, const void* inv_mt_c_sh,
                    uint32_t inv_q_mt, const void* cp, const void* psi, const void* psi_sh,
                    int k, int kb, int batch, int logn, int logb, int logc, int threads,
                    void* stream) {
  if (!fhe::column_args_ok(logn, logb, logc) || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const fhe::SmMRqOperands lo{u(q), u(mt_inv_phat), u(mt_inv_phat_sh), u(lift_phat),
                              u(lift_phat_sh), u(phat_mt), u(q_mod_c), u(q_mod_c_sh),
                              u(inv_mt_c), u(inv_mt_c_sh), inv_q_mt, k};
  return static_cast<int>(fhe::PlainLaunch<&column_lift_kernel>{}(
      dim3(1 << (logb - logc), 4 * batch, kb), threads, 4 << (logn - logb + logc),
      static_cast<cudaStream_t>(stream), u(ab), ab_sp, ab_sc, ab_sb, static_cast<uint32_t*>(y),
      lo, u(cp), u(psi), u(psi_sh), logn, logb, logc));
}

int fhe_column_floor(const void* x, const void* txq, int tx_sp, int tx_sc, int tx_sb, void* out,
                     const void* q, const void* floor_inv_phat, const void* floor_inv_phat_sh,
                     const void* floor_phat, const void* floor_phat_sh, const void* inv_q_c,
                     const void* inv_q_c_sh, const void* cp, const void* ipsi,
                     const void* ipsi_sh, const void* n_inv, const void* n_inv_sh, int k,
                     int kb, int batch, int logn, int logb, int logc, int threads,
                     void* stream) {
  if (!fhe::column_args_ok(logn, logb, logc) || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  return static_cast<int>(fhe::PlainLaunch<&column_floor_kernel>{}(
      dim3(1 << (logb - logc), 3 * batch, kb), threads, 4 << (logn - logb + logc),
      static_cast<cudaStream_t>(stream), u(x), u(txq), tx_sp, tx_sc, tx_sb,
      static_cast<uint32_t*>(out), u(q), u(floor_inv_phat), u(floor_inv_phat_sh), u(floor_phat),
      u(floor_phat_sh), u(inv_q_c), u(inv_q_c_sh), u(cp), u(ipsi), u(ipsi_sh), u(n_inv),
      u(n_inv_sh), k, logn, logb, logc));
}

}  // extern "C"
