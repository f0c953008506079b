// Whole-polynomial negacyclic NTT kernels for Hopper (sm_90a).
//
// Replaces fhe_tpu/ops/ntt_pallas.py: ntt_forward, ntt_inverse,
// mul_by_ntt_operand and mul_by_ntt_operand_batch, tensor_product and
// tensor_product_batch, keyswitch_fused and keyswitch_fused_batch (both
// lanes), ks_inner_batch and ks_inner_grouped; and, as lanes of the
// key-switch kernels, fhe_tpu/ops/galois_pallas.py: automorphism_fused /
// automorphism_single where a rotation's key switch consumes or produces
// their rows (the Galois lanes of keyswitch_fused at ks_omega = 1 and of
// ks_inner).  Plain versions: fhe_tpu_torch/ops/ntt.py.
//
// Each single function and its _batch form share one kernel, with the
// batch on a grid axis, and the single function launches B = 1.  Inputs are
// read through the strides the wrapper passes, so a [B, k, c, n] stack of
// ciphertexts is read in place, not transposed; outputs are [k, c, B, n].
// The Pallas batch tiles, padding and lazy sweeps are Mosaic artifacts and
// have no counterpart here.  Twiddles come straight from the compact
// psi_br [k, n] table and its Shoup companions: stage m reads entry
// m + j / (2t).  The Pallas kernels' [k, log2(n), n] stage-expanded tables
// exist only because Mosaic cannot index a lane by stage; a GPU thread can,
// so they are not ported (13x less table memory at n = 8192).
//
// What bounds them on the H100.  At n = 8192, k = 3 one batch row of a
// transform moves 96 KB of residues in and 96 KB out, plus 192 KB of
// twiddles and their Shoup companions, and does 3 * 13 * 4096 butterflies
// of 14 integer operations each: about 0.12 us by memory rate and about
// 0.05 us by the integer issue rate.  Neither is what limits them: at the
// main path's shapes a few dozen CTAs run on 132 SMs, so the time is the
// latency of one (element, prime)'s chain of dependent passes on the SMs
// it spreads over, plus the launch (measured times: PERF.md).
//
// mul_by_ntt_operand (the pk * u product of encrypt, and each c_j * s^j
// term of a longer ciphertext's decrypt) and tensor_product (the q-side
// product of the ciphertext multiply, and the Bsk side at n < 1024) answer
// that with thread-block clusters on the register-blocked sweep of
// modmath.cuh: 16 coefficients per thread in registers between barriers,
// 4 passes per 8192-point transform instead of 13, the load fused into the
// first pass and the epilogue into the last, and every row split over two
// CTAs of a cluster (RowSplit), which halves each CTA's chain for one
// cluster barrier per transform.  mul_by_ntt_operand runs a cluster of 2
// CTAs per (element, operand row, prime), grid (2, C * B, k): 12 CTAs in
// encrypt, where one block per (element, prime) ran 3.  Each cluster
// transforms u again for its own operand row, on other SMs at the same
// time, and forms the product in the forward's last pass, where the CTA
// holds its own positions: no peer read, one padded row of shared memory.
// tensor_product runs the design of bsk_branch_fused's step 2 (csrc/rns.cu),
// which is the same computation on the Bsk base: a cluster of 8 CTAs per
// (element, prime), two per input row, grid (8, B, k): 24 CTAs where 3 ran,
// two padded rows each, so n = 16384 fits (135 KB), where the old four rows
// per block (256 KB) did not; at n = 32768, where two padded rows take
// 264 KB, a CTA keeps only its half of the transformed row (HALF, 198 KB);
// at n = 65536, where one padded row takes 264 KB, every kernel here runs
// on modmath.cuh's compact split (each CTA of a pair holds
// only its half of the row, 132 KB), and what a CTA kept beside its working
// row (B4's transformed half row, B7's partials) lies in global scratch; at
// n = 131072, where a padded half row takes 264 KB, four CTAs share each
// row (the quarter split, a padded quarter row each, 132 KB; the split is
// each kernel's template parameter H), in clusters of 4 (ntt_forward,
// ntt_inverse, mul_by_ntt_operand, ks_inner) or 8 (keyswitch_fused with two
// digit groups; tensor_product in rounds, quarter.cuh).  From n = 262144,
// where even a padded quarter row exceeds a block, each of them runs in the
// column form (column.cuh, the kernels at the end of this file): plain
// launches that meet in global memory, no cluster.
// The two kernels keep two bodies: with one
// __device__ template for both, parameterised by the load and epilogue
// hooks (a strided read and store here, the lift and the floor there),
// bsk_branch_fused ran 1.3 % slower than the parent at the headline shape
// and 2.7 % at kb = 10, where its own body ran 0.6 % slower, in the same
// call (PERF.md).  So a change to the product or to the pass schedule
// is made in both kernels.  The n < 1024 multiply's two products are
// tensor_product's Lift lane (a template parameter, so the plain lane's
// code is what it was): one launch of k + kb clusters, the q side's beside
// the Bsk side's, whose CTAs first lift their input row from the k q
// primes into the cluster's Bsk prime with the lift of csrc/lift.cuh that
// bsk_branch_fused runs.  That replaces fhe_tpu/ops/rns_pallas.py
// sm_mrq_fused, which wrote a [kb, 4, n] lift that a second tensor_product
// launch read back after the q side's; the floor and the conversion to q
// follow in one base_conv_kernel launch (csrc/rns.cu, FloorSK lane).
//
// keyswitch_fused (the relinearization and every key switch of a rotation)
// and ntt_forward (every domain change: keygen, the key generators, the
// plaintext operand, key down-switching, the hoisted digits) run the same
// clusters, every row split over two CTAs.  keyswitch_fused is B3's forward
// with a fused product done kd times, then B4's DSMEM sum and split
// inverse: a cluster of 2R CTAs per (element, prime), R = clamp(kd, 2, 4)
// digit pairs; pair r transforms digits r, r + R, ... and keeps, for its
// half of the positions, two partial sums of digit x key (output rows 0 and
// 1) in its own shared memory; after a cluster barrier pairs 0 and 1 sum
// the R partials of their output row through distributed shared memory and
// run its inverse.  At kd = 3 that is 18 CTAs where one block per prime
// (3 in all) ran three forwards and a two-row inverse in series.  At
// n = 32768 its WIDE form keeps the partial sums in global scratch.
// R stops at 4, a cluster of 8 (the portable size): at kd = 8 a cluster of
// 16, one digit per pair, was 2.5 % faster alone and 35 % slower at B = 8.
// ntt_forward is B3's split forward alone: a cluster of 2 CTAs per (row,
// prime), the load fused into the first pass and the store into the last
// (one CTA per row was slower at every B measured, up to 48 rows).
//
// ntt_inverse (the encoder, to_coeff, the Galois key generator, key
// down-switching) is ntt_forward's mirror: a cluster of 2 CTAs per (row,
// prime) on the split inverse, the load fused into the first pass (16
// consecutive words of the CTA's own half per group, 16-byte loads where
// the row is aligned) and the n^-1 multiply and the store into the last.
// ks_inner_batch and ks_inner_grouped (the hoisted rotations) are the back
// half of the key switch: their digits arrive already transformed, so all
// that is left per output row is sum_j dg_j . key_j,c and one inverse.  The
// two output rows never meet, so each (element, output row, prime) is a
// split inverse of its own, a cluster of 2 CTAs (B3's shape), whose first
// pass forms the inner product of its group in registers as it loads it:
// kd digit and kd key words per position, Barrett products summed mod p.
// The digits are read once per output row, as B3 transforms u once per
// operand row.  The digits and the keys are read through strides and two
// index maps (digit stack b / dg_div, key set b % key_mod), so a digit stack
// shared by all elements, or by the E elements of one ciphertext, is read
// in place and never repeated in memory, nor are the keys tiled.
//
// The automorphisms that follow or precede a key switch ride in its
// passes.  A rotation at ks_omega = 1 is keyswitch_fused's Galois lane: the
// first pass loads each digit of c1 at phi's source (negated mod q_j where
// the sign flips), the last adds phi(c0) to output row 0, so phi, the key
// switch and the add are one launch.  The hoisted rotations are ks_inner's
// Galois lane: phi is a sign-free gather in the NTT domain, so the first
// pass gathers each element's inner products by its automorphism before
// the inverse, and the last adds phi(c0).  A sum_slots stage stays
// ks_inner's Inner lane and galois.cu's automorphism_sum_kernel: every sum
// lane tried here (one inverse of the summed products, the E inverses
// summed through distributed shared memory, or by the last CTA to finish)
// ran longer than those two launches (PERF.md).
//
// The register-blocked kernels are large: about 4 K (ntt_forward) to 11 K
// (keyswitch_fused) SASS instructions, and each warp runs a pass's
// straight-line code once or twice.  So a kernel that follows another one
// of them on the same SMs fetches its code cold: keyswitch_fused takes 2.5
// us more behind tensor_product at n = 8192, 4.3 us more at n = 256
// (PERF.md, which also times it behind ntt_inverse and ks_inner).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "column.cuh"
#include "lift.cuh"
#include "modmath.cuh"
#include "quarter.cuh"

namespace {

namespace cg = cooperative_groups;

// CTAs per row of every cluster kernel here up to n = 65536 (each kernel
// takes it as its template parameter H: 2, or 4 on the quarter split at
// n = 131072), per cluster of tensor_product (one pair per input row x0,
// x1, y0, y1), and at most per cluster (the portable size: a
// keyswitch_fused cluster holds up to kMaxCluster / H digit groups)
// (ops/ntt_cuda.py: ROW_SPLIT, PRODUCT_CLUSTER, MAX_CLUSTER)
constexpr int kRowSplit = 2;
constexpr int kProductCluster = 4 * kRowSplit;
constexpr int kMaxCluster = 8;

// Cluster (b, i) of H CTAs: y[i, b] = NTT(x[i, b]) for x, y [k, batch, n],
// grid (H * batch, k) in clusters of (H, 1, 1).  CTA h runs 1/H of each
// pass (modmath.cuh's RowSplit note): it loads its columns of the row in the
// first pass and stores positions [h n/H, (h+1) n/H), 16 consecutive words
// per group, in the last.  Shared memory: one padded row, or with COMPACT
// (n = 65536, where one padded row exceeds a block's shared memory) the
// CTA's padded half row, the compact split of modmath.cuh; at n = 131072
// (H = 4, the quarter split) its padded quarter row.
template <bool COMPACT, int H>
__global__ void __launch_bounds__(512)
ntt_forward_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ p, const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_sh, int batch, int logn) {
  extern __shared__ uint32_t a[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int b = blockIdx.x / H;
  const int i = blockIdx.y;
  const size_t tab = static_cast<size_t>(i) * n;
  const size_t row = (static_cast<size_t>(i) * batch + b) * n;
  const uint32_t* src = x + row;
  uint32_t* dst = y + row;
  const auto split = fhe::row_split<H>(cluster, a, 0, static_cast<int>(cluster.block_rank()));
  fhe::fwd_ntt_regs_split<H, COMPACT>(
      a, split, [&] { cluster.sync(); }, logn, p[i], psi + tab, psi_sh + tab,
      [&](auto& v, int base, int logs) {
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
          v[g] = src[base + (g << logs)];
      },
      // the last pass's group is consecutive (logs = 0, base a multiple of its size)
      [&](auto& v, int base, int) { fhe::store_run(dst, base, v); });
  // the peers read this CTA's row in the second pass: none leaves (and
  // frees its shared memory) before all have
  cluster.sync();
}

// Cluster (b, i) of H CTAs: y[i, b] = n^-1 INTT(x[i, b]) for x, y [k, batch,
// n], grid (H * batch, k) in clusters of (H, 1, 1): ntt_forward's mirror.
// CTA h runs 1/H of each pass (modmath.cuh's RowSplit note): it loads
// positions [h n/H, (h+1) n/H), 16 consecutive words per group, in the
// first pass (16-byte loads where `vec`: x starts 16-byte aligned) and
// stores its share of the row's columns, times n^-1, in the last.  Shared
// memory: one padded row, or with COMPACT (n = 65536) the padded half row
// (n = 131072, H = 4: the padded quarter row).
template <bool COMPACT, int H>
__global__ void __launch_bounds__(512)
ntt_inverse_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ p, const uint32_t* __restrict__ ipsi,
                   const uint32_t* __restrict__ ipsi_sh,
                   const uint32_t* __restrict__ n_inv,
                   const uint32_t* __restrict__ n_inv_sh, int batch, int logn, int vec) {
  extern __shared__ uint32_t a[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int b = blockIdx.x / H;
  const int i = blockIdx.y;
  const size_t tab = static_cast<size_t>(i) * n;
  const size_t row = (static_cast<size_t>(i) * batch + b) * n;
  const uint32_t* src = x + row;
  uint32_t* dst = y + row;
  const auto split = fhe::row_split<H>(cluster, a, 0, static_cast<int>(cluster.block_rank()));
  fhe::inv_ntt_regs_split<H, COMPACT>(
      a, split, [&] { cluster.sync(); }, logn, p[i], ipsi + tab, ipsi_sh + tab, n_inv[i],
      n_inv_sh[i],
      // the first pass's group is consecutive (logs = 0, base a multiple of its size)
      [&](auto& v, int base, int) { fhe::load_run(src, base, vec, v); },
      [&](auto& v, int base, int logs) {
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
          dst[base + (g << logs)] = v[g];
      });
  // the peers read this CTA's row in the last pass: none leaves (and frees
  // its shared memory) before all have
  cluster.sync();
}

// Cluster (i, c, b) of H CTAs: out[i, c, b] = INTT(NTT(u[i, b]) . w[i, c]).
// Row (i, b) of u starts at u + i * u_sp + b * u_sb, so a view of one
// ciphertext component, or the rows of a stack, is read in place; w is the
// shared [k, num_c, n] operand, each row 16-byte aligned (the wrapper
// checks); out is [k, num_c, B, n].  Grid (H, num_c * B, k) in clusters of
// (H, 1, 1), blockIdx.y = c * B + b.  CTA h runs 1/H of each pass of the
// two transforms (the row split of modmath.cuh's RowSplit note) and keeps
// positions [h n/H, (h+1) n/H) of NTT(u) between them, where it multiplies
// them by w[i, c] in the forward's last pass.  Shared memory: one padded row,
// or with COMPACT (n = 65536) the padded half row of those positions, which
// is all the CTA keeps between the transforms (n = 131072, H = 4: the padded
// quarter row).
template <bool COMPACT, int H>
__global__ void __launch_bounds__(512)
mul_by_ntt_operand_kernel(const uint32_t* __restrict__ u, long long u_sp, long long u_sb,
                          const uint32_t* __restrict__ w, uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ p, const uint32_t* __restrict__ mu,
                          const uint32_t* __restrict__ psi,
                          const uint32_t* __restrict__ psi_sh,
                          const uint32_t* __restrict__ ipsi,
                          const uint32_t* __restrict__ ipsi_sh,
                          const uint32_t* __restrict__ n_inv,
                          const uint32_t* __restrict__ n_inv_sh, int num_c, int logn) {
  extern __shared__ uint32_t sm[];
  uint32_t* a = sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int h = static_cast<int>(cluster.block_rank());
  const int cb = blockIdx.y;
  const int batch = gridDim.y / num_c;
  const int c = cb / batch, b = cb - c * batch;
  const int i = blockIdx.z;
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const auto split = fhe::row_split<H>(cluster, a, 0, h);
  auto sync = [&] { cluster.sync(); };
  const uint32_t* ur = u + i * u_sp + b * u_sb;
  const uint32_t* wr = w + (static_cast<size_t>(i) * num_c + c) * n;
  const int first = COMPACT ? h * (n / H) : 0;   // a[]'s first position
  fhe::fwd_ntt_regs_split<H, COMPACT>(
      a, split, sync, logn, pi, psi + tab, psi_sh + tab,
      [&](auto& x, int base, int logs) {
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g)
          x[g] = ur[base + (g << logs)];
      },
      [&](auto& x, int base, int logs) {
        // the last pass's group is consecutive (logs = 0, base a multiple of
        // its size), and its positions are this CTA's: w's words come in
        // 16-byte loads, and the product goes back in place
        constexpr int G = sizeof(x) / sizeof(x[0]);
        uint32_t wv[G];
        fhe::load_twiddles(wr, base, wv);
#pragma unroll
        for (int g = 0; g < G; ++g)
          a[fhe::padded_index(base - first + g)] = fhe::mul_barrett(x[g], wv[g], pi, mui);
      });
  uint32_t* dst = out + (static_cast<size_t>(i) * gridDim.y + cb) * n;
  fhe::inv_ntt_regs_split<H, COMPACT>(
      a, split, sync, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i],
      fhe::own_load<COMPACT>(a, first), [&](auto& x, int base, int logs) {
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g)
          dst[base + (g << logs)] = x[g];
      });
  // the peers read this CTA's row in the inverse's last pass: none leaves
  // (and frees its shared memory) before all have
  cluster.sync();
}

// The lanes of tensor_product_kernel: Plain (x and y residues in the
// tables' primes, row i of each for prime i) and Lift (the n < 1024
// multiply's two products in one launch: that of x and y in q, and that of
// their lifts into the Bsk base).
enum class ProductLane { Plain, Lift };

// The tables of one base (ops/ntt.py NTTTables, in table_ptrs' order).
struct ProductTables {
  const uint32_t* p;
  const uint32_t* mu;
  const uint32_t* psi;
  const uint32_t* psi_sh;
  const uint32_t* ipsi;
  const uint32_t* ipsi_sh;
  const uint32_t* n_inv;
  const uint32_t* n_inv_sh;
};

// Cluster (b, i) of 8 CTAs: out[i, :, b] = INTT(c0, c1, c2) with (c0, c1,
// c2) = (x0*y0, x0*y1 + x1*y0, x1*y1) the tensor product of NTT(x[i, :, b])
// and NTT(y[i, :, b]) (Barrett, 30-bit p).  Element (i, c, b, j) of x and of
// y sits at i * s_p + c * s_c + b * s_b + j, so the [k, 2, B, n] halves may
// be views of a [B, k, 4, n] stack, read in place; each CTA forms its row
// pointer once, so the 64-bit strides cost no index product in the passes.
// out is [k, 3, B, n].  With the multiply's tables n_inv is t * n^-1, so
// the scale by t costs nothing.  Grid (8, B, k) in clusters of (8, 1, 1):
// CTA 2r + h (r = 0..3: x0, x1, y0, y1) runs the forward transform of input
// row r with CTA 2r + 1 - h (RowSplit) and keeps positions
// [h n/2, (h+1) n/2) of the NTT-form row; after a cluster barrier the CTAs
// of rows 0 to 2 form product row r of their half from the four rows' CTAs
// through distributed shared memory, consecutive threads on consecutive
// words (coalesced remote reads), and run its inverse transform with their
// partner.  The CTAs of row 3 have no output row: they take the inverse's
// cluster barrier and stay until the peers have read their rows.  Shared
// memory: two padded rows, the transformed input row (read by the peers)
// and the sweeps' working row (read by the partner).  With HALF (n = 32768,
// where two padded rows exceed a block's shared memory) the transformed
// input row holds only the CTA's own positions [h n/2, (h+1) n/2), the only
// ones it keeps after the forward and the only ones its peers read:
// padded(n) + padded(n/2) words, 198 KB.  The form is FORM: 0 the two
// padded rows, 1 HALF, 2 COMPACT (n = 65536, where even a padded half row
// beside the working row exceeds a block: two padded half rows are 264 KB):
// the working row is the compact split's half row (modmath.cuh), 132 KB,
// and the transformed half row goes to `scratch`, a global buffer of n/2
// words per CTA (the wrapper's), CTA `rank` of cluster (b, z) at scratch +
// ((z * B + b) * 8 + rank) * n/2, published to the peers by the cluster
// barrier after a __threadfence.
//
// The Lift lane: x and y hold residues in the k = lo.k q primes, and the
// grid's k + kb clusters per element form both products of the n < 1024
// multiply side by side, on other SMs at the same time.  Cluster z < k is
// the q side, on the tables tq; cluster z >= k the Bsk side: its CTAs lift
// their input row from the k q primes into the Bsk prime c_i, i = z - k
// (row i of the kernel's tables and of lo's [l] and [l, k] tables), with
// lift.cuh's lift, before the forward transform.  out is [k + kb, 3, B, n]:
// t x (x) y in q, then in Bsk.  The source prime of the lift runs over x's
// rows (stride s_p), the output prime i over the tables and constants.
template <ProductLane LANE, int FORM>
__global__ void __launch_bounds__(512)
tensor_product_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                      long long s_p, long long s_c, long long s_b,
                      uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                      const uint32_t* __restrict__ mu, const uint32_t* __restrict__ psi,
                      const uint32_t* __restrict__ psi_sh,
                      const uint32_t* __restrict__ ipsi,
                      const uint32_t* __restrict__ ipsi_sh,
                      const uint32_t* __restrict__ n_inv,
                      const uint32_t* __restrict__ n_inv_sh, int logn,
                      const fhe::SmMRqOperands lo, const ProductTables tq,
                      uint32_t* scratch) {
  constexpr bool lifted = LANE == ProductLane::Lift;
  constexpr bool HALF = FORM >= 1, COMPACT = FORM == 2;
  static_assert(!(lifted && HALF), "the Lift lane runs at n < 1024 only");
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int half = n / kRowSplit;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = rank / kRowSplit, h = rank % kRowSplit;
  // input row r, NTT form (with HALF its positions from `first` on only;
  // COMPACT: in global scratch, unpadded, the cluster's rows together)
  uint32_t* ours = COMPACT ? scratch + (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y)
                                           * kProductCluster * half
                           : nullptr;
  uint32_t* row = COMPACT ? ours + static_cast<size_t>(rank) * half : sm;
  const int first = HALF ? h * half : 0;
  // the sweeps' passes
  uint32_t* work = COMPACT ? sm : sm + fhe::padded(HALF ? half : n);
  const int b = blockIdx.y;
  const int z = blockIdx.z;                  // the output prime
  // the Lift lane's q side takes tq; its Bsk side, prime i of the tables,
  // lifts (in the Plain lane both are false and i = z)
  const bool qside = lifted && z < lo.k;
  const bool lift_row = lifted && !qside;
  const int i = lift_row ? z - lo.k : z;
  const uint32_t* __restrict__ tp = qside ? tq.p : p;
  const uint32_t* __restrict__ tmu = qside ? tq.mu : mu;
  const uint32_t* __restrict__ tpsi = qside ? tq.psi : psi;
  const uint32_t* __restrict__ tpsi_sh = qside ? tq.psi_sh : psi_sh;
  const uint32_t* __restrict__ tipsi = qside ? tq.ipsi : ipsi;
  const uint32_t* __restrict__ tipsi_sh = qside ? tq.ipsi_sh : ipsi_sh;
  const uint32_t* __restrict__ tn_inv = qside ? tq.n_inv : n_inv;
  const uint32_t* __restrict__ tn_inv_sh = qside ? tq.n_inv_sh : n_inv_sh;
  const uint32_t pi = tp[i];
  const size_t tab = static_cast<size_t>(i) * n;
  static_assert(kRowSplit == 2, "the split below names both CTAs of a row");
  const fhe::RowSplit<kRowSplit> split{{cluster.map_shared_rank(work, r * kRowSplit),
                                        cluster.map_shared_rank(work, r * kRowSplit + 1)},
                                       h};
  auto sync = [&] { cluster.sync(); };
  // a lifting CTA reads source prime 0's row and steps by s_p over the k
  const uint32_t* src = (r < 2 ? x : y) + (lift_row ? 0 : z * s_p) + (r & 1) * s_c + b * s_b;
  if (lift_row) {
    // the first pass's elements of row r for this CTA (its columns j mod
    // n/16, modmath.cuh's RowSplit note) lifted into c_i and staged in the
    // working row by every thread of the CTA, a coefficient each with its
    // source loads in flight (16 primes at a time, lift.cuh): at n < 1024
    // the first pass has n/32 groups per CTA, and lifting a group of 16 in
    // one thread, k loads after one another, took 3 us (PERF.md)
    const fhe::SmMRqLift lift(lo, i, pi);
    const int cols = (n >> fhe::kRegLog) / kRowSplit;
    const int logc = logn - fhe::kRegLog - 1;
    for (int e = threadIdx.x; e < n / kRowSplit; e += blockDim.x) {
      const int j = ((e >> logc) << (logn - fhe::kRegLog)) + h * cols + (e & (cols - 1));
      work[fhe::padded_index(j)] = lift.one(src + j, s_p);
    }
    __syncthreads();
  }
  auto kept = [&] {
    if constexpr (COMPACT)   // the last pass's group is consecutive (logs = 0)
      return [=](auto& v, int base, int) { fhe::store_run(row, base - first, v); };
    else
      return fhe::SmemStoreFrom{row, first};
  }();
  fhe::fwd_ntt_regs_split<kRowSplit, COMPACT>(
      work, split, sync, logn, pi, tpsi + tab, tpsi_sh + tab,
      [&](auto& v, int base, int logs) {
        if (lift_row) {
          fhe::SmemLoad{work}(v, base, logs);
        } else {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
            v[g] = src[base + (g << logs)];
        }
      },
      kept);
  if constexpr (COMPACT) __threadfence();    // the transformed rows, to the peers
  cluster.sync();
  if (r < 3) {
    const uint32_t mui = tmu[i];
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
    // position j of the half: work[e] (e from `first` on where COMPACT),
    // the peers' rows at f (unpadded in scratch)
    const int end = (h + 1) * half;
#pragma unroll 8
    for (int j = h * half + threadIdx.x; j < end; j += blockDim.x) {
      const int e = fhe::padded_index(COMPACT ? j - first : j);
      const int f = COMPACT ? j - first : fhe::padded_index(j - first);
      work[e] = r == 1 ? fhe::add_mod(fhe::mul_barrett(x0[f], y1[f], pi, mui),
                                      fhe::mul_barrett(x1[f], y0[f], pi, mui), pi)
                       : fhe::mul_barrett(pa[f], pb[f], pi, mui);
    }
    __syncthreads();
    uint32_t* dst = out + ((static_cast<size_t>(z) * 3 + r) * gridDim.y + b) * n;
    fhe::inv_ntt_regs_split<kRowSplit, COMPACT>(
        work, split, sync, logn, pi, tipsi + tab, tipsi_sh + tab, tn_inv[i], tn_inv_sh[i],
        fhe::own_load<COMPACT>(work, first), [&](auto& v, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
            dst[base + (g << logs)] = v[g];
        });
  } else {
    cluster.sync();      // the barrier inside the output rows' inverse
  }
  // the peers read this CTA's rows above: no CTA leaves (and frees its
  // shared memory) before all have
  cluster.sync();
}

// tensor_product_kernel's QUARTER form (3; n = 131072, where even the
// compact split's padded half row exceeds a block): the same product on
// quarter.cuh's schedule, a portable cluster of 8 CTAs per (element, prime)
// that shares each row over four CTAs (a padded quarter row each, 132 KB)
// and runs the four input rows in two forward rounds and the three product
// rows in two inverse rounds; the transformed rows go to `scratch`, 4n
// words per cluster, that of cluster (b, z) at scratch + (z * B + b) * 4n.
// tensor_product_kernel's parameters, so one launcher takes both; the
// Plain lane only (the Lift lane runs at n < 1024).
__global__ void __launch_bounds__(512)
tensor_product_quarter_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                              long long s_p, long long s_c, long long s_b,
                              uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                              const uint32_t* __restrict__ mu,
                              const uint32_t* __restrict__ psi,
                              const uint32_t* __restrict__ psi_sh,
                              const uint32_t* __restrict__ ipsi,
                              const uint32_t* __restrict__ ipsi_sh,
                              const uint32_t* __restrict__ n_inv,
                              const uint32_t* __restrict__ n_inv_sh, int logn,
                              const fhe::SmMRqOperands, const ProductTables,
                              uint32_t* scratch) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const size_t tab = static_cast<size_t>(z) * n;
  uint32_t* ours = scratch + (static_cast<size_t>(z) * gridDim.y + b) * 4 * n;
  fhe::quarter_product(
      cluster, sm, ours, logn, p[z], mu[z], psi + tab, psi_sh + tab, ipsi + tab, ipsi_sh + tab,
      n_inv[z], n_inv_sh[z],
      [&](int r, auto& v, int base, int logs) {
        const uint32_t* src = (r < 2 ? x : y) + z * s_p + (r & 1) * s_c + b * s_b;
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
          v[g] = src[base + (g << logs)];
      },
      [&](int r, auto& v, int base, int logs) {
        uint32_t* dst = out + ((static_cast<size_t>(z) * 3 + r) * gridDim.y + b) * n;
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
          dst[base + (g << logs)] = v[g];
      });
}

// The lanes of keyswitch_kernel: Classic (digit j a residue mod its own
// q_j, reduced mod p_i as it loads), Prereduced (per-prime residues, used as
// they are) and Galois (a rotation: the digits of the un-permuted c1, each
// read at its automorphism's source and negated mod q_j where the sign
// flips, and phi(c0) added to output row 0 as it is stored).
enum class KsLane { Classic, Prereduced, Galois };

// n words from src to the unpadded shared row dst (16-byte aligned), by the
// whole CTA, as asynchronous copies (cp.async, every copy of a thread in
// flight at once): 16 bytes each where `vec` (src starts 16-byte aligned),
// a word each otherwise.  Each thread waits for its copies (stage_wait)
// before the barrier that publishes dst.
__device__ __forceinline__ void stage_row(uint32_t* dst, const uint32_t* __restrict__ src,
                                          int n, bool vec) {
  if (vec) {
    for (int q = 4 * threadIdx.x; q < n; q += 4 * blockDim.x)
      __pipeline_memcpy_async(dst + q, src + q, 16);
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x) __pipeline_memcpy_async(dst + q, src + q, 4);
  }
  __pipeline_commit();
}

__device__ __forceinline__ void stage_wait() { __pipeline_wait_prior(0); }

// The words of shared memory before a staged row: the kernel's `words`
// rounded up to whole 16-byte words (ops/ntt_cuda.py: staged_bytes).
__host__ __device__ constexpr int stage_offset(int words) { return (words + 3) & ~3; }

// The coefficient automorphism a(x) -> a(x^g) in gather form, h = g^-1 mod
// 2n: out[x] = +-a[src], src = h x mod n, negated where h x mod 2n >= n.
// h < 2n and 2n divides 2^32, so the 32-bit product wraps exactly mod 2n
// (modmath.cuh's OPS galois_index).
__device__ __forceinline__ uint32_t coeff_source(uint32_t h, int x, int logn, bool& neg) {
  const uint32_t hx = (h * static_cast<uint32_t>(x)) & ((2u << logn) - 1);
  neg = hx >> logn;
  return hx & ((1u << logn) - 1);
}

// Key-switch inner product, cluster (b, i) for element b and prime p_i:
//   out[i, c, b] = INTT( sum_j NTT([d_j,b]_{p_i}) . key[i, j, c] ),  c = 0, 1.
// Digit j of element b for prime i is the row at d + i * d_sp + j * d_sj +
// b * d_sb.  In the Classic and Galois lanes it is a residue mod its own q_j
// (< 2^30, q_j = p[j]), the same row for every prime (d_sp = 0), so it is
// reduced mod p_i first: mul_barrett is exact only below p.  In the
// Prereduced lane (grouped gadget digits, ks_omega > 1) the rows are
// per-prime residues, already below p_i, and are used as they are.  Key
// element (i, j, c, x) sits at keys + i * key_sp + j * key_sj + c * n + x,
// so the stored [digit, prime, 2, n] keys are read in place and shared by
// all B elements; every key row starts 16-byte aligned (the wrapper
// checks).  out: [k, 2, B, n].
//
// The Galois lane is a whole rotation phi_g then key switch (apply_galois
// at ks_omega = 1): d holds the digits of the un-permuted c1, and digit j of
// phi_g(c1) at x is d_j[src] negated mod q_j where the sign flips
// (coeff_source, h = g^-1 mod 2n), the same bits as the digits of the
// permuted c1; output row 0 is stored as delta0 + phi_g(c0), with c0 of
// element b for prime i the row at c0 + i * c0_sp + b * c0_sb (mod p_i), and
// row 1 as delta1, so out is the rotated ciphertext.  The gathers are
// scattered over a whole row, so each CTA first stages the row it gathers
// from (digit j before its forward, c0 before output row 0's inverse) in a
// shared row of n words, coalesced (16-byte loads where `vec`), and reads it
// there: consecutive threads hold consecutive positions, whose sources lie
// h words apart, h odd, so the reads hit 32 distinct banks.
//
// Grid (2R, B, k) in clusters of (2R, 1, 1), R = `pairs` digit pairs.  CTA
// 2r + h of pair r runs, with its partner 2r + 1 - h (RowSplit), the split
// forward transform of digits r, r + R, ... in turn; in each forward's last
// pass it holds 16 consecutive positions of its half [h n/2, (h+1) n/2),
// multiplies them by key[i, j, 0] and key[i, j, 1] (16-byte loads) and
// stores, then adds, them into the pair's two partial half rows in its own
// shared memory.  A CTA whose pair has no digit in a round takes the
// barrier of the peers' forward.  After a cluster barrier, pair c = 0, 1
// sums output row c's R partials over its half through distributed shared
// memory, consecutive threads on consecutive words (coalesced remote
// reads), into its working row, and runs that row's inverse with the store
// to out in the last pass.  Pairs r >= 2 take the inverse's cluster barrier
// and stay until the peers have read their partials.  Mod-add is exact, so
// this order of summation gives the reference's bits.  Shared memory: two
// padded rows, the sweeps' working row (read by the partner) and the two
// partial half rows (read by pairs 0 and 1); the Galois lane adds the
// staged row.
//
// WIDE (n = 32768, where the working row and the partials exceed a block's
// shared memory, 264 KB): shared memory is the working row alone (132 KB).
// Each CTA keeps its two partial half rows in `scratch`, a global buffer of
// n words per CTA (the wrapper's; 2.4 MB at k = 3, kd = 3, inside L2):
// CTA `rank` of cluster (b, i) at scratch + ((i * B + b) * 2R + rank) * n,
// output row c's half at + c * n/2.  Each word of it is written and read
// back by one thread in every round (the forward's last pass maps the same
// positions to the same thread), and the cluster barrier after the last
// round publishes it to pairs 0 and 1.  The Galois lane reads the digit
// row and c0 in place, each word a scattered L2 read, as ks_inner's
// GaloisInPlace lane does.  FORM: 0 the rows in shared memory, 1 WIDE, 2
// WIDE on the compact split (n = 65536, where the working row alone
// exceeds a block): the working row is the CTA's padded half row (132 KB),
// the scratch as WIDE's (n words per CTA: 63 MB at k = kd = 30, more than
// L2).  H: the CTAs that share a row, 2 above; at n = 131072 (the quarter
// split, FORM 2 only) H = 4 and R = 2 (a cluster of 8): CTA 4r + h of digit
// group r keeps positions [h n/4, (h+1) n/4) of both output rows' partial
// sums, n/2 words of scratch per CTA (2n/H in every WIDE form), and group
// c = 0, 1 sums and inverts output row c.
template <KsLane LANE, int FORM, int H>
__global__ void __launch_bounds__(512)
keyswitch_kernel(const uint32_t* __restrict__ d, long long d_sp, long long d_sj,
                 long long d_sb, const uint32_t* __restrict__ keys, long long key_sp,
                 long long key_sj, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ p, const uint32_t* __restrict__ mu,
                 const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                 const uint32_t* __restrict__ ipsi, const uint32_t* __restrict__ ipsi_sh,
                 const uint32_t* __restrict__ n_inv,
                 const uint32_t* __restrict__ n_inv_sh, int kd, int pairs, int logn,
                 uint32_t h_gal, const uint32_t* __restrict__ c0, long long c0_sp,
                 long long c0_sb, int vec, uint32_t* scratch) {
  constexpr bool WIDE = FORM >= 1, COMPACT = FORM == 2;
  constexpr bool staged = LANE == KsLane::Galois && !WIDE;
  static_assert(H == kRowSplit || COMPACT, "four CTAs a row only on the compact split");
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int half = n / H;                     // a CTA's share of the row
  const int cta_words = n / (H / kRowSplit);  // WIDE: a CTA's two partial rows
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = rank / H, h = rank % H;
  const int b = blockIdx.y;
  const int i = blockIdx.z;
  // the cluster's partials in global memory (WIDE), cta_words per CTA
  uint32_t* ours = WIDE
                       ? scratch + (static_cast<size_t>(i) * gridDim.y + b) * gridDim.x * cta_words
                       : nullptr;
  // partial sum of output row c, own share, at part + c * part_row; position
  // e of the share at part[at(e)]
  const int part_row = WIDE ? half : fhe::padded(half);
  auto at = [](int e) { return WIDE ? e : fhe::padded_index(e); };
  uint32_t* work = sm;                        // the sweeps' passes
  uint32_t* part = WIDE ? ours + static_cast<size_t>(rank) * cta_words : sm + fhe::padded(n);
  uint32_t* stage = sm + stage_offset(2 * fhe::padded(n));  // Galois: the row gathered from
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const auto split = fhe::row_split<H>(cluster, work, r * H, h);
  auto sync = [&] { cluster.sync(); };
  const uint32_t* d_ib = d + i * d_sp + b * d_sb;
  const uint32_t* key_i = keys + i * key_sp;
  for (int m = 0, j = r; m * pairs < kd; ++m, j += pairs) {
    // the partner's second pass of the last round read this CTA's row (and,
    // in the Galois lane, this CTA's first pass its staged row); the
    // compact forward begins with that barrier itself
    if (m > 0 && !COMPACT) cluster.sync();
    if (j >= kd) {
      cluster.sync();    // the barriers inside the peers' forward
      if constexpr (COMPACT) cluster.sync();
      continue;
    }
    const uint32_t* dr = d_ib + j * d_sj;
    const uint32_t* k0 = key_i + j * key_sj;
    const uint32_t* k1 = k0 + n;
    const bool first = m == 0;
    if constexpr (staged) {
      stage_row(stage, dr, n, vec);
      stage_wait();
      __syncthreads();
    }
    const uint32_t qj = LANE == KsLane::Galois ? p[j] : 0;
    fhe::fwd_ntt_regs_split<H, COMPACT>(
        work, split, sync, logn, pi, psi + tab, psi_sh + tab,
        [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g) {
            if constexpr (LANE == KsLane::Galois) {
              bool neg;
              const uint32_t src = coeff_source(h_gal, base + (g << logs), logn, neg);
              uint32_t v = staged ? stage[src] : __ldg(dr + src);
              if (neg) v = fhe::neg_mod(v, qj);
              x[g] = fhe::reduce_barrett(v, pi, mui);
            } else {
              const uint32_t v = dr[base + (g << logs)];
              x[g] = LANE == KsLane::Prereduced ? v : fhe::reduce_barrett(v, pi, mui);
            }
          }
        },
        [&](auto& x, int base, int) {
          // the last pass's group is consecutive (logs = 0, base a multiple
          // of its size) and its positions are this CTA's
          constexpr int G = sizeof(x) / sizeof(x[0]);
          uint32_t* acc = part + at(base - h * half);
          uint32_t kv[G];
          fhe::load_twiddles(k0, base, kv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const uint32_t t = fhe::mul_barrett(x[g], kv[g], pi, mui);
            acc[g] = first ? t : fhe::add_mod(acc[g], t, pi);
          }
          fhe::load_twiddles(k1, base, kv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const uint32_t t = fhe::mul_barrett(x[g], kv[g], pi, mui);
            acc[part_row + g] = first ? t : fhe::add_mod(acc[part_row + g], t, pi);
          }
        });
  }
  if constexpr (WIDE) __threadfence();    // the partials, to the peers
  cluster.sync();        // every partial sum is complete
  if (r < 2) {
    const bool add_c0 = LANE == KsLane::Galois && r == 0;
    const uint32_t* c0r = c0 + i * c0_sp + b * c0_sb;
    // the forwards are over, so the staged row is free for c0, copied while
    // the partials are summed (the __syncthreads below publishes it)
    if (staged && add_c0) stage_row(stage, c0r, n, vec);
    const int summed = kd < pairs ? kd : pairs;    // the pairs that had a digit
    const uint32_t* mine = part + r * part_row;
#pragma unroll 4
    for (int e = threadIdx.x; e < half; e += blockDim.x) {
      uint32_t s = 0;
#pragma unroll
      for (int q = 0; q < kMaxCluster / H; ++q) {
        if (q >= summed) continue;
        const int peer = q * H + h;
        const uint32_t* theirs = WIDE ? ours + static_cast<size_t>(peer) * cta_words + r * half
                                      : cluster.map_shared_rank(mine, peer);
        s = fhe::add_mod(s, theirs[at(e)], pi);
      }
      work[fhe::padded_index(COMPACT ? e : h * half + e)] = s;
    }
    if (staged && add_c0) stage_wait();
    __syncthreads();
    uint32_t* dst = out + ((static_cast<size_t>(i) * 2 + r) * gridDim.y + b) * n;
    fhe::inv_ntt_regs_split<H, COMPACT>(
        work, split, sync, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i],
        fhe::own_load<COMPACT>(work, COMPACT ? h * half : 0), [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g) {
            const int pos = base + (g << logs);
            uint32_t v = x[g];
            if (add_c0) {
              bool neg;
              const uint32_t src = coeff_source(h_gal, pos, logn, neg);
              const uint32_t w = staged ? stage[src] : __ldg(c0r + src);
              v = fhe::add_mod(v, neg ? fhe::neg_mod(w, pi) : w, pi);
            }
            dst[pos] = v;
          }
        });
  } else {
    cluster.sync();      // the barrier inside the output rows' inverse
  }
  // the peers read this CTA's rows above: no CTA leaves (and frees its
  // shared memory) before all have
  cluster.sync();
}

// The lanes of ks_inner_kernel: Inner (the key-switch inner products of
// ks_inner_batch and ks_inner_grouped, one per element), Galois (each
// element's products also gathered by its automorphism, with phi(c0) added
// to output row 0: a hoisted rotation each; c0 staged in shared memory) and
// GaloisInPlace (the same with c0 read in place, where the staged row does
// not fit: n = 32768).
enum class InnerLane { Inner, Galois, GaloisInPlace };

// The Galois elements gs[e] of the key sets and their inverses hs[e] =
// g_e^-1 mod 2n; c0 of digit stack s for prime i at c0 + i * c0_sp + s *
// c0_ss (mod p_i).
struct GaloisOperands {
  const uint32_t* gs;
  const uint32_t* hs;
  const uint32_t* c0;
  long long c0_sp, c0_ss;
};

__host__ __device__ constexpr int brev4(int l) {
  return ((l & 1) << 3) | ((l & 2) << 1) | ((l & 4) >> 1) | ((l & 8) >> 3);
}

// v[l] = P_g(sum_j D_j . K'_j)[base + l], l < 16, for the 16 consecutive
// NTT-domain positions from base (a multiple of 16): P_g the sign-free
// gather of the automorphism phi_g (eval_perm), D_j the digit row at dgb +
// j * dg_sj, K'_j the pre-permuted key row at ke + j * key_sj (Barrett
// products added mod p).  For x = 16 q + l, 2 brv(src) + 1 = g (2 brv(x) +
// 1) mod 2n gives src = 16 brv'(R) + brv4((g brv4(l) + Q) mod 16), with g
// brv'(q) + (g - 1) / 2 = Q 2^(log n - 4) + R (brv' reverses log n - 4
// bits): one aligned source block of 16, permuted.  So the block's digit and
// key runs come in with 16-byte loads (where `vec`), the 16 sums of
// products are formed in source order, and the permutation goes through
// `slot`, 16 words of shared memory that no other thread touches
// meanwhile.
__device__ __forceinline__ void gathered_products(
    uint32_t (&v)[16], int base, int logn, const uint32_t* __restrict__ dgb,
    long long dg_sj, const uint32_t* __restrict__ ke, long long key_sj, int kd, uint32_t ge,
    bool vec, uint32_t pi, uint32_t mui, uint32_t* slot) {
  constexpr int G = 16;
  const int lq = logn - 4;                                // >= 1: log n > kRegLog
  const uint32_t q_rev = __brev(static_cast<uint32_t>(base) >> 4) >> (32 - lq);
  const uint32_t t = ge * q_rev + (ge >> 1);
  const uint32_t qtop = (t >> lq) & 15;
  const int src = static_cast<int>(__brev(t & ((1u << lq) - 1)) >> (32 - lq)) << 4;
  uint32_t acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0;
  for (int j = 0; j < kd; ++j) {
    uint32_t f[G], kv[G];
    fhe::load_run(dgb + j * dg_sj, src, vec, f);
    fhe::load_run(ke + j * key_sj, src, vec, kv);
#pragma unroll
    for (int g = 0; g < G; ++g)
      acc[g] = fhe::add_mod(acc[g], fhe::mul_barrett(f[g], kv[g], pi, mui), pi);
  }
  // slot[brv4(l)] = the sum at source position src + l; position base + l
  // reads slot[(g brv4(l) + Q) mod 16]
#pragma unroll
  for (int g = 0; g < G; ++g) slot[brev4(g)] = acc[g];
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = slot[(ge * brev4(g) + qtop) & 15];
}

// Hoisted key-switch inner product, cluster (i, c, b) of 2 CTAs for element
// b, output row c and prime p_i:
//   out[i, c, b] = INTT( sum_j dg[i, j, b / dg_div] . keys[i, j, b % key_mod, c] ).
// The digits are NTT-domain residues mod p_i: row (i, j, s) at dg + i *
// dg_sp + j * dg_sj + s * dg_sb (dg_sb = 0 for one stack shared by every
// element).  Key element (i, j, e, c, x) at keys + i * key_sp + j * key_sj
// + e * key_se + c * n + x.  ks_inner_batch passes dg_div = 1 and key_mod =
// B; ks_inner_grouped, element b = s * E + e, dg_div = key_mod = E.  out:
// [k, 2, B, n].  Grid (2, 2 * B, k) in clusters of (2, 1, 1), blockIdx.y =
// c * B + b.  CTA h runs half of each pass of output row c's split inverse
// (modmath.cuh's RowSplit note): the first pass's load forms the sum for
// its 16 consecutive positions, kd digit runs and kd key runs (16-byte
// loads where `vec`: every row starts 16-byte aligned), Barrett products
// added mod p_i in registers, so nothing is written before the first pass;
// the last pass stores.  Mod-add is exact, so this order of summation gives
// the reference's bits.  Shared memory: one padded row.
//
// The Galois lanes fold in the automorphism that follows a hoisted key
// switch (galois_pallas.py's automorphism_fused, c0 shared by the elements
// of one digit stack), with the keys pre-permuted as hoisted_galois_keys
// makes them (K'_e = K_e gathered by eval_perm_inv).  In the NTT domain
// phi_g is the sign-free gather P_g(Y)[x] = Y[src_g(x)], so phi_g(INTT(Y)) =
// INTT(P_g(Y)), and the first pass gathers the element's products by its
// automorphism (gathered_products; the slot is the 16 words of the working
// row that the group's own first-pass store fills next).  The last pass
// adds phi_g(c0)[x] = +-c0[h x mod n] (coeff_source) to output row 0.  In
// the Galois lane c0 is first copied into shared memory behind the working
// row, coalesced, while the first passes run, and read there (sources h
// apart, h odd: 32 distinct banks); that row does not fit beside the
// working row at n = 32768, where GaloisInPlace reads c0 in place, each
// word a scattered L2 read (at n = 8192 1.4 us slower than staged, PERF.md).
//
// COMPACT (n = 65536, where one padded row exceeds a block's shared memory):
// the working row is the compact split's padded half row (modmath.cuh), the
// CTA's own positions [h n/2, (h+1) n/2) from `first` on; the inverse's first
// pass forms exactly those positions' sums, and its last reads the peer's
// half through distributed shared memory.  The Galois lane's gather reads
// its digit and key runs from global memory in every form, so only its slot
// moves with the row; c0 is read in place (GaloisInPlace).  At n = 131072
// H = 4 CTAs share the row (the quarter split), a padded quarter row each,
// in clusters of (4, 1, 1); H = 2 below.
template <InnerLane LANE, bool COMPACT, int H>
__global__ void __launch_bounds__(512)
ks_inner_kernel(const uint32_t* __restrict__ dg, long long dg_sp, long long dg_sj,
                long long dg_sb, int dg_div, const uint32_t* __restrict__ keys,
                long long key_sp, long long key_sj, long long key_se, int key_mod,
                uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                const uint32_t* __restrict__ mu, const uint32_t* __restrict__ ipsi,
                const uint32_t* __restrict__ ipsi_sh, const uint32_t* __restrict__ n_inv,
                const uint32_t* __restrict__ n_inv_sh, int kd, int logn, int vec,
                GaloisOperands go) {
  constexpr bool galois = LANE != InnerLane::Inner;
  constexpr bool staged = LANE == InnerLane::Galois;
  static_assert(!(staged && COMPACT), "the compact split reads c0 in place");
  extern __shared__ uint32_t a[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int cb = blockIdx.y;
  const int batch = gridDim.y / 2;
  const int c = cb / batch, b = cb - c * batch;
  const int i = blockIdx.z;
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const uint32_t* dgb = dg + i * dg_sp + (b / dg_div) * dg_sb;
  const int e = b % key_mod;                        // the element's key set
  const uint32_t* ke = keys + i * key_sp + c * n + e * key_se;
  uint32_t* dst = out + (static_cast<size_t>(i) * gridDim.y + cb) * n;
  const auto split = fhe::row_split<H>(cluster, a, 0, static_cast<int>(cluster.block_rank()));
  const int first = COMPACT ? split.h * (n / H) : 0;   // a[]'s first position
  const bool add_c0 = galois && c == 0;
  const uint32_t* c0 = galois ? go.c0 + i * go.c0_sp + (b / dg_div) * go.c0_ss : nullptr;
  uint32_t* c0s = a + stage_offset(fhe::padded(n));
  // copied while the first passes run; the cluster barrier before the last
  // pass publishes it
  if (staged && add_c0) stage_row(c0s, c0, n, vec);
  fhe::inv_ntt_regs_split<H, COMPACT>(
      a, split,
      [&] {
        if (staged && add_c0) stage_wait();
        cluster.sync();
      },
      logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i],
      // the first pass's group is consecutive (logs = 0, base a multiple of its size)
      [&](auto& v, int base, int) {
        constexpr int G = sizeof(v) / sizeof(v[0]);
        if constexpr (galois) {
          gathered_products(v, base, logn, dgb, dg_sj, ke, key_sj, kd, __ldg(go.gs + e), vec,
                            pi, mui, a + fhe::padded_index(base - first));
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) v[g] = 0;
          for (int j = 0; j < kd; ++j) {
            uint32_t f[G], kv[G];
            fhe::load_run(dgb + j * dg_sj, base, vec, f);
            fhe::load_run(ke + j * key_sj, base, vec, kv);
#pragma unroll
            for (int g = 0; g < G; ++g)
              v[g] = fhe::add_mod(v[g], fhe::mul_barrett(f[g], kv[g], pi, mui), pi);
          }
        }
      },
      [&](auto& v, int base, int logs) {
        const uint32_t he = add_c0 ? __ldg(go.hs + e) : 0;
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g) {
          const int pos = base + (g << logs);
          uint32_t val = v[g];
          if (add_c0) {
            bool neg;
            const int src = coeff_source(he, pos, logn, neg);
            const uint32_t w = staged ? c0s[src] : __ldg(c0 + src);
            val = fhe::add_mod(val, neg ? fhe::neg_mod(w, pi) : w, pi);
          }
          dst[pos] = val;
        }
      });
  // the peers read this CTA's row in the last pass: none leaves (and frees
  // its shared memory) before all have
  cluster.sync();
}

// Shared memory of `words` words of rows and, where a lane gathers, a
// staged row of n words behind them (stage_offset).
inline int lane_smem(int words, int n, bool staged) {
  return 4 * (staged ? stage_offset(words) + n : words);
}

template <ProductLane LANE, int FORM>
cudaError_t launch_tensor_product(const void* x, const void* y, long long s_p, long long s_c,
                                  long long s_b, void* out, const void* p, const void* mu,
                                  const void* psi, const void* psi_sh, const void* ipsi,
                                  const void* ipsi_sh, const void* n_inv,
                                  const void* n_inv_sh, int k, int batch, int logn,
                                  int threads, int smem, const fhe::SmMRqOperands& lo,
                                  const ProductTables& tq, void* scratch,
                                  cudaStream_t stream) {
  static_assert(FORM < 3 || LANE == ProductLane::Plain, "the Lift lane has no quarter form");
  // the QUARTER form (3) is its own kernel with the same parameters
  auto* const fn = FORM == 3 ? &tensor_product_quarter_kernel
                             : &tensor_product_kernel<LANE, FORM < 3 ? FORM : 0>;
  const int n = 1 << logn;
  if (logn <= fhe::kRegLog || smem < 4 * fhe::product_words(FORM, n)
      || (FORM >= 2) != (scratch != nullptr)
      || (LANE == ProductLane::Lift
          && (lo.k < 1 || k <= lo.k || tq.p == nullptr)))
    return cudaErrorInvalidValue;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(fn);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(kProductCluster, batch, k), threads, smem, kProductCluster, stream, attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return err;
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, fn, c(x), c(y), s_p, s_c, s_b,
                           static_cast<uint32_t*>(out), c(p), c(mu), c(psi), c(psi_sh),
                           c(ipsi), c(ipsi_sh), c(n_inv), c(n_inv_sh), logn, lo, tq,
                           static_cast<uint32_t*>(scratch));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <KsLane LANE, int FORM, int H = kRowSplit>
cudaError_t launch_keyswitch(const void* d, long long d_sp, long long d_sj, long long d_sb,
                             const void* keys, long long key_sp, long long key_sj, void* out,
                             const void* p, const void* mu, const void* psi,
                             const void* psi_sh, const void* ipsi, const void* ipsi_sh,
                             const void* n_inv, const void* n_inv_sh, int k, int kd,
                             int batch, int logn, int pairs, int threads, int smem,
                             unsigned h_gal, const void* c0, long long c0_sp, long long c0_sb,
                             int vec, void* scratch, cudaStream_t stream) {
  constexpr bool galois = LANE == KsLane::Galois;
  const int n = 1 << logn;
  const int words = FORM == 2 ? fhe::padded(n / H) : fhe::padded(n);   // a wide form's
  if (logn <= fhe::kRegLog || kd < 1 || pairs < 2 || pairs * H > kMaxCluster
      || smem < (FORM ? 4 * words : lane_smem(2 * fhe::padded(n), n, galois))
      || (FORM && scratch == nullptr) || (galois && (kd > k || c0 == nullptr)))
    return cudaErrorInvalidValue;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(keyswitch_kernel<LANE, FORM, H>);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(H * pairs, batch, k), threads, smem, H * pairs, stream, attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return err;
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, keyswitch_kernel<LANE, FORM, H>, c(d), d_sp, d_sj, d_sb,
                           c(keys), key_sp, key_sj, static_cast<uint32_t*>(out), c(p), c(mu),
                           c(psi), c(psi_sh), c(ipsi), c(ipsi_sh), c(n_inv), c(n_inv_sh), kd, pairs,
                           logn, static_cast<uint32_t>(h_gal), c(c0), c0_sp, c0_sb, vec,
                           static_cast<uint32_t*>(scratch));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <InnerLane LANE, bool COMPACT, int H = kRowSplit>
cudaError_t launch_ks_inner(const void* dg, long long dg_sp, long long dg_sj,
                            long long dg_sb, int dg_div, const void* keys, long long key_sp,
                            long long key_sj, long long key_se, int key_mod, void* out,
                            const void* p, const void* mu, const void* ipsi,
                            const void* ipsi_sh, const void* n_inv, const void* n_inv_sh,
                            int k, int kd, int batch, int logn, int threads, int smem,
                            int vec, const GaloisOperands& go, cudaStream_t stream) {
  constexpr bool galois = LANE != InnerLane::Inner;
  const int n = 1 << logn;
  if (logn <= fhe::kRegLog || kd < 1
      || smem < lane_smem(fhe::padded(COMPACT ? n / H : n), n,
                          LANE == InnerLane::Galois)
      || (galois && (go.gs == nullptr || go.hs == nullptr || go.c0 == nullptr)))
    return cudaErrorInvalidValue;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(ks_inner_kernel<LANE, COMPACT, H>);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(H, 2 * batch, k), threads, smem, H, stream, attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return err;
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, ks_inner_kernel<LANE, COMPACT, H>, c(dg), dg_sp, dg_sj, dg_sb, dg_div,
                           c(keys), key_sp, key_sj, key_se, key_mod,
                           static_cast<uint32_t*>(out), c(p), c(mu), c(ipsi), c(ipsi_sh),
                           c(n_inv), c(n_inv_sh), kd, logn, vec, go);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launcher of keyswitch_fused's lane for its form (fhe_keyswitch;
// `compact`: 0, or the CTAs of the compact split).
template <KsLane LANE>
auto keyswitch_form(bool wide, int compact) {
  return compact == 4 ? &launch_keyswitch<LANE, 2, 4>
         : compact    ? &launch_keyswitch<LANE, 2>
         : wide       ? &launch_keyswitch<LANE, 1>
                      : &launch_keyswitch<LANE, 0>;
}

// The instance of a kernel template for a C entry point's `compact`
// argument: 0 (a padded row per CTA, a pair of CTAs a row), 2 (the compact
// split over a pair) or 4 (over four CTAs, the quarter split); its index
// into the entry point's records; and the CTAs that share a row.
inline int split_form(int compact) { return compact == 4 ? 2 : compact ? 1 : 0; }
inline int split_ctas(int compact) { return compact ? compact : kRowSplit; }

// ---------------------------------------------------------------------------
// The column form (column.cuh): each kernel above as a chain of ordinary
// launches that meet in global memory, for n >= 262144, where no share of a
// row that a cluster splits fits a block.  ntt_forward is a column launch
// and a block launch (in place), ntt_inverse a block launch and a column
// launch; mul_by_ntt_operand, tensor_product, keyswitch_fused (every lane)
// and, with decrypt.cu's and rns.cu's column launches, decrypt_fused and
// bsk_branch_fused are a forward column launch, a block launch that runs the
// block's forward stages, the body and the block's inverse stages, and an
// inverse column launch; ks_inner (both lanes) a block launch and an
// inverse column launch.  The wrappers (ops/column_cuda.py) allocate the
// rows between the launches.  New kernels: those above keep their code.

// The loads of column_forward_kernel: Plain (the row as it is), Reduce
// (keyswitch_fused's classic digits, reduced mod p_i) and Galois (its
// Galois lane: digit c at phi's source, negated mod its own q_c where the
// sign flips, then reduced: the bits of keyswitch_kernel's Galois load).
enum class ColumnLane { Plain, Reduce, Galois };

// The forward's column launch: y[i, y_off + c, b] = the top s stages of the
// forward transform of row (i, c, b) of x, whose element j lies at x + i *
// x_sp + c * x_sc + b * x_sb + j (x_sp = 0: the classic digits, one row for
// every prime); y is [k, y_comps, B, n].  Grid (b / C, comps * B, k),
// blockIdx.y = c * B + b, one tile of C columns per CTA (column.cuh), its
// 2^s C words in shared memory.
template <ColumnLane LANE>
__global__ void __launch_bounds__(256)
column_forward_kernel(const uint32_t* __restrict__ x, long long x_sp, long long x_sc,
                      long long x_sb, int comps, uint32_t* __restrict__ y, int y_comps,
                      int y_off, const uint32_t* __restrict__ p,
                      const uint32_t* __restrict__ mu, const uint32_t* __restrict__ psi,
                      const uint32_t* __restrict__ psi_sh, int logn, int logb, int logc,
                      uint32_t h_gal) {
  extern __shared__ uint32_t t[];
  const int n = 1 << logn;
  const int batch = gridDim.y / comps;
  const int c = blockIdx.y / batch, b = blockIdx.y - c * batch;
  const int i = blockIdx.z;
  const uint32_t pi = p[i];
  const uint32_t mui = LANE == ColumnLane::Plain ? 0 : mu[i];
  const uint32_t qc = LANE == ColumnLane::Galois ? p[c] : 0;
  const size_t tab = static_cast<size_t>(i) * n;
  const uint32_t* xr = x + i * x_sp + c * x_sc + b * x_sb;
  const fhe::ColumnTile tile = fhe::column_tile(logn, logb, logc);
  fhe::column_load(t, tile, [&](int j) -> uint32_t {
    if constexpr (LANE == ColumnLane::Plain) {
      return xr[j];
    } else if constexpr (LANE == ColumnLane::Reduce) {
      return fhe::reduce_barrett(xr[j], pi, mui);
    } else {
      bool neg;
      const uint32_t v = __ldg(xr + coeff_source(h_gal, j, logn, neg));
      return fhe::reduce_barrett(neg ? fhe::neg_mod(v, qc) : v, pi, mui);
    }
  });
  fhe::column_forward(t, tile, pi, psi + tab, psi_sh + tab);
  uint32_t* yr = y + ((static_cast<size_t>(i) * y_comps + y_off + c) * batch + b) * n;
  fhe::column_store(t, tile, [&](int j, uint32_t v, int) { yr[j] = v; });
}

// The inverse's column launch: y[i, c, b] = n^-1 (t n^-1 with the
// multiply's tables) times the last s stages of the inverse transform of
// row (i, c, b) of x; x, y [k, comps, B, n].  GALOIS (the Galois lanes of
// keyswitch_fused and ks_inner): row c = 0 of element b is stored plus
// phi_h(c0_b) (coeff_source; h = hs[b % h_mod], or h_gal where hs is null;
// c0_b of prime i at c0 + i * c0_sp + (b / c0_div) * c0_sb).  Grid (b / C,
// comps * B, k), one tile per CTA.
template <bool GALOIS>
__global__ void __launch_bounds__(256)
column_inverse_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, int comps,
                      const uint32_t* __restrict__ p, const uint32_t* __restrict__ ipsi,
                      const uint32_t* __restrict__ ipsi_sh,
                      const uint32_t* __restrict__ n_inv,
                      const uint32_t* __restrict__ n_inv_sh, int logn, int logb, int logc,
                      const uint32_t* __restrict__ hs, uint32_t h_gal, int h_mod,
                      const uint32_t* __restrict__ c0, long long c0_sp, long long c0_sb,
                      int c0_div) {
  extern __shared__ uint32_t t[];
  const int n = 1 << logn;
  const int batch = gridDim.y / comps;
  const int c = blockIdx.y / batch, b = blockIdx.y - c * batch;
  const int i = blockIdx.z;
  const uint32_t pi = p[i], ni = n_inv[i], ni_sh = n_inv_sh[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const size_t row = ((static_cast<size_t>(i) * comps + c) * batch + b) * n;
  const fhe::ColumnTile tile = fhe::column_tile(logn, logb, logc);
  fhe::column_load(t, tile, [&](int j) { return x[row + j]; });
  fhe::column_inverse(t, tile, pi, ipsi + tab, ipsi_sh + tab);
  const bool add_c0 = GALOIS && c == 0;
  const uint32_t h = add_c0 ? (hs != nullptr ? __ldg(hs + b % h_mod) : h_gal) : 0;
  const uint32_t* c0r = add_c0 ? c0 + i * c0_sp + (b / c0_div) * c0_sb : nullptr;
  fhe::column_store(t, tile, [&](int j, uint32_t v, int) {
    v = fhe::mul_shoup(v, ni, ni_sh, pi);
    if (add_c0) {
      bool neg;
      const uint32_t w = __ldg(c0r + coeff_source(h, j, logn, neg));
      v = fhe::add_mod(v, neg ? fhe::neg_mod(w, pi) : w, pi);
    }
    y[row + j] = v;
  });
}

// A group of a row in global memory, element base + (g << logs), and to it.
template <class V>
__device__ __forceinline__ void row_group_load(V& v, const uint32_t* __restrict__ row, int base,
                                               int logs) {
#pragma unroll
  for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
    v[g] = row[base + (g << logs)];
}
template <class V>
__device__ __forceinline__ void row_group_store(const V& v, uint32_t* __restrict__ row, int base,
                                                int logs) {
#pragma unroll
  for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
    row[base + (g << logs)] = v[g];
}

// ntt_forward's block launch, in place on y [k, B, n] after its column
// launch: block h = blockIdx.x of row (i, b) through the forward stages
// below the column ones.  Grid (n / b, B, k); one padded block row of
// shared memory.
__global__ void __launch_bounds__(512)
block_forward_kernel(uint32_t* __restrict__ y, const uint32_t* __restrict__ p,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                     int logn, int logb) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int h = blockIdx.x, i = blockIdx.z;
  const size_t tab = static_cast<size_t>(i) * n;
  uint32_t* row = y + (static_cast<size_t>(i) * gridDim.y + blockIdx.y) * n;
  fhe::block_forward(
      a, logn, logb, h, p[i], psi + tab, psi_sh + tab,
      [&](auto& v, int base, int logs) { row_group_load(v, row, base, logs); },
      [&](auto& v, int base, int) { fhe::store_run(row, base, v); });
}

// ntt_inverse's block launch: block h of y[i, b] = the inverse stages below
// the column ones of row (i, b) of x; x, y [k, B, n], the first pass's 16
// consecutive words in 16-byte loads where `vec` (x starts 16-byte
// aligned).  Grid (n / b, B, k); one padded block row.
__global__ void __launch_bounds__(512)
block_inverse_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ p, const uint32_t* __restrict__ ipsi,
                     const uint32_t* __restrict__ ipsi_sh, int logn, int logb, int vec) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int h = blockIdx.x, i = blockIdx.z;
  const size_t tab = static_cast<size_t>(i) * n;
  const size_t row = (static_cast<size_t>(i) * gridDim.y + blockIdx.y) * n;
  const uint32_t* src = x + row;
  fhe::block_inverse(
      a, logn, logb, h, p[i], ipsi + tab, ipsi_sh + tab,
      [&](auto& v, int base, int) { fhe::load_run(src, base, vec, v); },
      [&](auto& v, int base, int logs) { row_group_store(v, y + row, base, logs); });
}

// mul_by_ntt_operand's block launch (and decrypt_fused's, w = s): block h of
// out[i, c, b] = the block's forward stages of row (i, b) of u (the column
// launch's [k, B, n]), times w[i, c] (Barrett, in the last pass, w's words
// in 16-byte loads), then the block's inverse stages.  w [k, num_c, n]
// with 16-byte aligned rows, out [k, num_c, B, n].  Grid (n / b, num_c * B,
// k), blockIdx.y = c * B + b; one padded block row.
__global__ void __launch_bounds__(512)
block_mul_kernel(const uint32_t* __restrict__ u, const uint32_t* __restrict__ w,
                 uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                 const uint32_t* __restrict__ mu, const uint32_t* __restrict__ psi,
                 const uint32_t* __restrict__ psi_sh, const uint32_t* __restrict__ ipsi,
                 const uint32_t* __restrict__ ipsi_sh, int num_c, int logn, int logb) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int h = blockIdx.x, cb = blockIdx.y, i = blockIdx.z;
  const int batch = gridDim.y / num_c;
  const int c = cb / batch, b = cb - c * batch;
  const uint32_t pi = p[i], mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const int first = h << logb;
  const uint32_t* ur = u + (static_cast<size_t>(i) * batch + b) * n;
  const uint32_t* wr = w + (static_cast<size_t>(i) * num_c + c) * n;
  fhe::block_forward(
      a, logn, logb, h, pi, psi + tab, psi_sh + tab,
      [&](auto& x, int base, int logs) { row_group_load(x, ur, base, logs); },
      [&](auto& x, int base, int) {
        constexpr int G = sizeof(x) / sizeof(x[0]);
        uint32_t wv[G];
        fhe::load_twiddles(wr, base, wv);
#pragma unroll
        for (int g = 0; g < G; ++g)
          a[fhe::padded_index(base - first + g)] = fhe::mul_barrett(x[g], wv[g], pi, mui);
      });
  uint32_t* dst = out + (static_cast<size_t>(i) * gridDim.y + cb) * n;
  fhe::block_inverse(a, logn, logb, h, pi, ipsi + tab, ipsi_sh + tab, fhe::SmemLoadFrom{a, first},
                     [&](auto& x, int base, int logs) { row_group_store(x, dst, base, logs); });
}

// tensor_product's block launch (and bsk_branch_fused's, on the Bsk
// tables): block h of element b over prime i runs the block's forward
// stages of the four rows x0, x1, y0, y1 of x ([k, 4, B, n], the column
// launches'), each in a padded block row of its own; forms the product rows
// c0 = x0 y0, c1 = x0 y1 + x1 y0, c2 = x1 y1 (Barrett) in place of the
// first three, each position by one thread; and runs the block's inverse
// stages of each into out [k, 3, B, n].  Grid (n / b, B, k); four padded
// block rows of shared memory (135 KB at b = 8192).
__global__ void __launch_bounds__(512)
block_product_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ p, const uint32_t* __restrict__ mu,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                     const uint32_t* __restrict__ ipsi, const uint32_t* __restrict__ ipsi_sh,
                     int logn, int logb) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn, bs = 1 << logb;
  const int words = fhe::padded(bs);
  const int h = blockIdx.x, b = blockIdx.y, i = blockIdx.z;
  const int batch = gridDim.y;
  const uint32_t pi = p[i], mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const int first = h << logb;
  for (int r = 0; r < 4; ++r) {
    uint32_t* a = sm + r * words;
    const uint32_t* src = x + ((static_cast<size_t>(i) * 4 + r) * batch + b) * n;
    fhe::block_forward(a, logn, logb, h, pi, psi + tab, psi_sh + tab,
                       [&](auto& v, int base, int logs) { row_group_load(v, src, base, logs); },
                       fhe::SmemStoreFrom{a, first});
  }
  uint32_t* r0 = sm;
  uint32_t* r1 = sm + words;
  uint32_t* r2 = sm + 2 * words;
  const uint32_t* r3 = sm + 3 * words;
  for (int e = threadIdx.x; e < bs; e += blockDim.x) {
    const int q = fhe::padded_index(e);
    const uint32_t x0 = r0[q], x1 = r1[q], y0 = r2[q], y1 = r3[q];
    r0[q] = fhe::mul_barrett(x0, y0, pi, mui);
    r1[q] = fhe::add_mod(fhe::mul_barrett(x0, y1, pi, mui), fhe::mul_barrett(x1, y0, pi, mui), pi);
    r2[q] = fhe::mul_barrett(x1, y1, pi, mui);
  }
  __syncthreads();
  for (int r = 0; r < 3; ++r) {
    uint32_t* a = sm + r * words;
    uint32_t* dst = out + ((static_cast<size_t>(i) * 3 + r) * batch + b) * n;
    fhe::block_inverse(a, logn, logb, h, pi, ipsi + tab, ipsi_sh + tab,
                       fhe::SmemLoadFrom{a, first},
                       [&](auto& v, int base, int logs) { row_group_store(v, dst, base, logs); });
  }
}

// keyswitch_fused's block launch (every lane: the column launch has reduced
// or gathered the digits): block h of element b over prime i.  For each
// digit j, the block's forward stages of row (i, j, b) of x ([k, kd, B,
// n]); the last pass's 16 consecutive positions times key[i, j, 0] and
// key[i, j, 1] (16-byte loads; key element (i, j, c, x) at keys + i *
// key_sp + j * key_sj + c * n + x) are added into the two partial rows.
// Then the block's inverse stages of each partial row into out [k, 2, B,
// n].  The forward's last pass and the inverse's first map the same
// positions to the same thread, so each partial word is written and read
// by one thread.  Mod-add is exact, so the digits' order gives the
// reference's bits.  Grid (n / b, B, k); shared memory: the padded block
// row and the two partial rows, unpadded (99 KB at b = 8192).
__global__ void __launch_bounds__(512)
block_keyswitch_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ keys,
                       long long key_sp, long long key_sj, uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ p, const uint32_t* __restrict__ mu,
                       const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                       const uint32_t* __restrict__ ipsi,
                       const uint32_t* __restrict__ ipsi_sh, int kd, int logn, int logb) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn, bs = 1 << logb;
  const int h = blockIdx.x, b = blockIdx.y, i = blockIdx.z;
  const int batch = gridDim.y;
  const uint32_t pi = p[i], mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const int first = h << logb;
  uint32_t* a = sm;
  uint32_t* part = sm + fhe::padded(bs);     // output row c's at part + c * bs
  const uint32_t* key_i = keys + i * key_sp;
  for (int j = 0; j < kd; ++j) {
    const uint32_t* src = x + ((static_cast<size_t>(i) * kd + j) * batch + b) * n;
    const uint32_t* k0 = key_i + j * key_sj;
    const uint32_t* k1 = k0 + n;
    const bool lead = j == 0;
    fhe::block_forward(
        a, logn, logb, h, pi, psi + tab, psi_sh + tab,
        [&](auto& v, int base, int logs) { row_group_load(v, src, base, logs); },
        [&](auto& v, int base, int) {
          constexpr int G = sizeof(v) / sizeof(v[0]);
          uint32_t* acc = part + (base - first);
          uint32_t kv[G];
          fhe::load_twiddles(k0, base, kv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const uint32_t t = fhe::mul_barrett(v[g], kv[g], pi, mui);
            acc[g] = lead ? t : fhe::add_mod(acc[g], t, pi);
          }
          fhe::load_twiddles(k1, base, kv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const uint32_t t = fhe::mul_barrett(v[g], kv[g], pi, mui);
            acc[bs + g] = lead ? t : fhe::add_mod(acc[bs + g], t, pi);
          }
        });
  }
  for (int c = 0; c < 2; ++c) {
    const uint32_t* mine = part + c * bs;
    uint32_t* dst = out + ((static_cast<size_t>(i) * 2 + c) * batch + b) * n;
    fhe::block_inverse(
        a, logn, logb, h, pi, ipsi + tab, ipsi_sh + tab,
        [&](auto& v, int base, int) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
            v[g] = mine[base - first + g];
        },
        [&](auto& v, int base, int logs) { row_group_store(v, dst, base, logs); });
  }
}

// ks_inner's block launch (ks_inner_batch and ks_inner_grouped; GALOIS:
// their Galois lane): block h of out[i, c, b] = the block's inverse stages
// of sum_j dg[i, j, b / dg_div] . keys[i, j, b % key_mod, c], the sums
// formed in the first pass as ks_inner_kernel forms them (GALOIS: gathered
// by the element's automorphism, gathered_products, whose source block
// lies anywhere in the row: it reads global memory); the inverse column
// launch adds phi(c0).  Operands as ks_inner_kernel's; out [k, 2, B, n].
// Grid (n / b, 2 B, k), blockIdx.y = c * B + b; one padded block row.
template <bool GALOIS>
__global__ void __launch_bounds__(512)
block_inner_kernel(const uint32_t* __restrict__ dg, long long dg_sp, long long dg_sj,
                   long long dg_sb, int dg_div, const uint32_t* __restrict__ keys,
                   long long key_sp, long long key_sj, long long key_se, int key_mod,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                   const uint32_t* __restrict__ mu, const uint32_t* __restrict__ ipsi,
                   const uint32_t* __restrict__ ipsi_sh, int kd, int logn, int logb, int vec,
                   const uint32_t* __restrict__ gs) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int h = blockIdx.x, cb = blockIdx.y, i = blockIdx.z;
  const int batch = gridDim.y / 2;
  const int c = cb / batch, b = cb - c * batch;
  const uint32_t pi = p[i], mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const int first = h << logb;
  const uint32_t* dgb = dg + i * dg_sp + (b / dg_div) * dg_sb;
  const int e = b % key_mod;
  const uint32_t* ke = keys + i * key_sp + c * n + e * key_se;
  uint32_t* dst = out + (static_cast<size_t>(i) * gridDim.y + cb) * n;
  fhe::block_inverse(
      a, logn, logb, h, pi, ipsi + tab, ipsi_sh + tab,
      [&](auto& v, int base, int) {
        constexpr int G = sizeof(v) / sizeof(v[0]);
        if constexpr (GALOIS) {
          gathered_products(v, base, logn, dgb, dg_sj, ke, key_sj, kd, __ldg(gs + e), vec, pi,
                            mui, a + fhe::padded_index(base - first));
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) v[g] = 0;
          for (int j = 0; j < kd; ++j) {
            uint32_t f[G], kv[G];
            fhe::load_run(dgb + j * dg_sj, base, vec, f);
            fhe::load_run(ke + j * key_sj, base, vec, kv);
#pragma unroll
            for (int g = 0; g < G; ++g)
              v[g] = fhe::add_mod(v[g], fhe::mul_barrett(f[g], kv[g], pi, mui), pi);
          }
        }
      },
      [&](auto& v, int base, int logs) { row_group_store(v, dst, base, logs); });
}

// The block launches' common checks: smem for `rows` padded block rows
// and `words` more.
inline bool block_args_ok(int logn, int logb, int smem, int rows, int words = 0) {
  return fhe::column_args_ok(logn, logb, 0) && smem >= 4 * (rows * fhe::padded(1 << logb) + words);
}

}  // namespace

extern "C" {

// The launch geometry of every kernel here comes from the wrapper
// (ops/ntt_cuda.py: ntt_forward_geometry, ntt_inverse_geometry,
// mul_by_ntt_operand_geometry, tensor_product_geometry, keyswitch_geometry
// and ks_inner_geometry): `threads` per CTA and `smem` bytes per CTA, at
// least the padded rows the kernel uses, and keyswitch_fused's digit pairs.
// `vec` (ntt_inverse, ks_inner) says that every input row starts 16-byte
// aligned, so the first pass may load it in 16-byte words.  `compact`
// (ntt_forward, ntt_inverse, mul_by_ntt_operand, keyswitch_fused, ks_inner)
// picks the compact split: 0 none, 2 a padded half row per CTA (n = 65536),
// 4 a padded quarter row per CTA, four CTAs a row (n = 131072).
int fhe_ntt_forward(const void* x, void* y, const void* p, const void* psi,
                    const void* psi_sh, int k, int batch, int logn, int threads, int smem,
                    int compact, void* stream) {
  if (logn <= fhe::kRegLog || (compact != 0 && compact != 2 && compact != 4)
      || smem < 4 * fhe::padded((1 << logn) / (compact ? compact : 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // each instantiation keeps its own records
  static std::atomic<size_t> granted[3][fhe::kMaxDevices];
  static std::atomic<size_t> placed[3][fhe::kMaxDevices];
  const int form = split_form(compact), split = split_ctas(compact);
  auto* fn = form == 2 ? &ntt_forward_kernel<true, 4>
             : form    ? &ntt_forward_kernel<true, kRowSplit>
                       : &ntt_forward_kernel<false, kRowSplit>;
  const void* kernel = reinterpret_cast<const void*>(fn);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(split * batch, k), threads, smem, split,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, fn, c(x), static_cast<uint32_t*>(y), c(p), c(psi), c(psi_sh),
                           batch, logn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fhe_ntt_inverse(const void* x, void* y, const void* p, const void* ipsi,
                    const void* ipsi_sh, const void* n_inv, const void* n_inv_sh,
                    int k, int batch, int logn, int threads, int smem, int vec, int compact,
                    void* stream) {
  if (logn <= fhe::kRegLog || (compact != 0 && compact != 2 && compact != 4)
      || smem < 4 * fhe::padded((1 << logn) / (compact ? compact : 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<size_t> granted[3][fhe::kMaxDevices];
  static std::atomic<size_t> placed[3][fhe::kMaxDevices];
  const int form = split_form(compact), split = split_ctas(compact);
  auto* fn = form == 2 ? &ntt_inverse_kernel<true, 4>
             : form    ? &ntt_inverse_kernel<true, kRowSplit>
                       : &ntt_inverse_kernel<false, kRowSplit>;
  const void* kernel = reinterpret_cast<const void*>(fn);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(split * batch, k), threads, smem, split,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, fn, c(x), static_cast<uint32_t*>(y), c(p), c(ipsi),
                           c(ipsi_sh), c(n_inv), c(n_inv_sh), batch, logn, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fhe_mul_by_ntt_operand(const void* u, long long u_sp, long long u_sb, const void* w,
                           void* out, const void* p, const void* mu, const void* psi,
                           const void* psi_sh, const void* ipsi, const void* ipsi_sh,
                           const void* n_inv, const void* n_inv_sh, int k, int num_c,
                           int batch, int logn, int threads, int smem, int compact,
                           void* stream) {
  if (logn <= fhe::kRegLog || (compact != 0 && compact != 2 && compact != 4)
      || smem < 4 * fhe::padded((1 << logn) / (compact ? compact : 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<size_t> granted[3][fhe::kMaxDevices];
  static std::atomic<size_t> placed[3][fhe::kMaxDevices];
  const int form = split_form(compact), split = split_ctas(compact);
  auto* fn = form == 2 ? &mul_by_ntt_operand_kernel<true, 4>
             : form    ? &mul_by_ntt_operand_kernel<true, kRowSplit>
                       : &mul_by_ntt_operand_kernel<false, kRowSplit>;
  const void* kernel = reinterpret_cast<const void*>(fn);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(split, num_c * batch, k), threads, smem, split,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, fn, c(u), u_sp, u_sb, c(w), static_cast<uint32_t*>(out),
                           c(p), c(mu), c(psi), c(psi_sh), c(ipsi), c(ipsi_sh), c(n_inv),
                           c(n_inv_sh), num_c, logn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// tensor_product's lanes: Plain where lift_q is null, else Lift, with the
// lift's constants (lift.cuh SmMRqOperands: lift_k source primes) and the
// q tables (tq_*, table_ptrs' order); then k counts the lift_k q primes and
// the Bsk primes of the tables p .. n_inv_sh.  form: the Plain lane's 0 (two
// padded rows), 1 (half_row: only the CTA's half of the transformed row,
// n = 32768), 2 (compact: the compact working row, the transformed half
// rows in `scratch`, n/2 words per CTA; n = 65536) or 3 (quarter: the
// padded quarter row, four CTAs a row, the transformed rows in `scratch`,
// n/2 words per CTA; n = 131072).
int fhe_tensor_product(const void* x, const void* y, long long s_p, long long s_c,
                       long long s_b, void* out, const void* p, const void* mu,
                       const void* psi, const void* psi_sh, const void* ipsi,
                       const void* ipsi_sh, const void* n_inv, const void* n_inv_sh, int k,
                       int batch, int logn, int threads, int smem, int form,
                       const void* lift_q,
                       const void* lift_w, const void* lift_w_sh, const void* lift_phat,
                       const void* lift_phat_sh, const void* lift_phat_mt,
                       const void* lift_q_mod_c, const void* lift_q_mod_c_sh,
                       const void* lift_inv_mt_c, const void* lift_inv_mt_c_sh,
                       unsigned lift_inv_q_mt, int lift_k, const void* tq_p,
                       const void* tq_mu, const void* tq_psi, const void* tq_psi_sh,
                       const void* tq_ipsi, const void* tq_ipsi_sh, const void* tq_n_inv,
                       const void* tq_n_inv_sh, void* scratch, void* stream) {
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const fhe::SmMRqOperands lo{c(lift_q), c(lift_w), c(lift_w_sh), c(lift_phat),
                              c(lift_phat_sh), c(lift_phat_mt), c(lift_q_mod_c),
                              c(lift_q_mod_c_sh), c(lift_inv_mt_c), c(lift_inv_mt_c_sh),
                              static_cast<uint32_t>(lift_inv_q_mt), lift_k};
  const ProductTables tq{c(tq_p), c(tq_mu), c(tq_psi), c(tq_psi_sh), c(tq_ipsi),
                         c(tq_ipsi_sh), c(tq_n_inv), c(tq_n_inv_sh)};
  if ((lift_q != nullptr && form != 0) || form < 0 || form > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = lift_q != nullptr ? &launch_tensor_product<ProductLane::Lift, 0>
                 : form == 3       ? &launch_tensor_product<ProductLane::Plain, 3>
                 : form == 2       ? &launch_tensor_product<ProductLane::Plain, 2>
                 : form == 1       ? &launch_tensor_product<ProductLane::Plain, 1>
                                   : &launch_tensor_product<ProductLane::Plain, 0>;
  return static_cast<int>(launch(x, y, s_p, s_c, s_b, out, p, mu, psi, psi_sh, ipsi, ipsi_sh,
                                 n_inv, n_inv_sh, k, batch, logn, threads, smem, lo, tq,
                                 scratch, static_cast<cudaStream_t>(stream)));
}

// keyswitch_fused's lanes: 0 Classic, 1 Prereduced, 2 Galois (h_gal =
// g^-1 mod 2n, c0 of element b for prime i at c0 + i * c0_sp + b * c0_sb).
// A scratch buffer (2n/H words per CTA, H the CTAs a row) picks the WIDE
// form: the partials in it, one padded row of shared memory (n = 32768);
// with `compact` too, the working row on the compact split, a padded half
// row (compact = 2, n = 65536) or quarter row (4, n = 131072).
int fhe_keyswitch(const void* d, long long d_sp, long long d_sj, long long d_sb,
                  const void* keys, long long key_sp, long long key_sj, void* out,
                  const void* p, const void* mu, const void* psi, const void* psi_sh,
                  const void* ipsi, const void* ipsi_sh, const void* n_inv,
                  const void* n_inv_sh, int k, int kd, int batch, int logn, int pairs,
                  int threads, int smem, int lane, unsigned h_gal, const void* c0,
                  long long c0_sp, long long c0_sb, int vec, void* scratch, int compact,
                  void* stream) {
  const bool wide = scratch != nullptr;
  if ((compact && !wide) || (compact != 0 && compact != 2 && compact != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = lane == 2   ? keyswitch_form<KsLane::Galois>(wide, compact)
                 : lane == 1 ? keyswitch_form<KsLane::Prereduced>(wide, compact)
                             : keyswitch_form<KsLane::Classic>(wide, compact);
  return static_cast<int>(launch(d, d_sp, d_sj, d_sb, keys, key_sp, key_sj, out, p, mu, psi,
                                 psi_sh, ipsi, ipsi_sh, n_inv, n_inv_sh, k, kd, batch, logn,
                                 pairs, threads, smem, h_gal, c0, c0_sp, c0_sb, vec, scratch,
                                 static_cast<cudaStream_t>(stream)));
}

// ks_inner's lanes: 0 Inner, 1 Galois, 2 GaloisInPlace (gs, hs: the key
// sets' Galois elements and their inverses mod 2n; c0 of digit stack s for
// prime i at c0 + i * c0_sp + s * c0_ss; lane 1 stages it behind the padded
// row in smem).  `compact` picks the compact split (2, n = 65536: a padded
// half row per CTA; 4, n = 131072: a padded quarter row), which lanes 0 and
// 2 take.
int fhe_ks_inner(const void* dg, long long dg_sp, long long dg_sj, long long dg_sb,
                 int dg_div, const void* keys, long long key_sp, long long key_sj,
                 long long key_se, int key_mod, void* out, const void* p, const void* mu,
                 const void* ipsi, const void* ipsi_sh, const void* n_inv,
                 const void* n_inv_sh, int k, int kd, int batch, int logn, int threads,
                 int smem, int vec, int lane, const void* gs, const void* hs,
                 const void* c0, long long c0_sp, long long c0_ss, int compact,
                 void* stream) {
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const GaloisOperands go{c(gs), c(hs), c(c0), c0_sp, c0_ss};
  if ((compact && lane == 1) || (compact != 0 && compact != 2 && compact != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* launch = lane == 2      ? compact == 4 ? &launch_ks_inner<InnerLane::GaloisInPlace, true, 4>
                                  : compact    ? &launch_ks_inner<InnerLane::GaloisInPlace, true>
                                               : &launch_ks_inner<InnerLane::GaloisInPlace, false>
                 : lane == 1    ? &launch_ks_inner<InnerLane::Galois, false>
                 : compact == 4 ? &launch_ks_inner<InnerLane::Inner, true, 4>
                 : compact      ? &launch_ks_inner<InnerLane::Inner, true>
                                : &launch_ks_inner<InnerLane::Inner, false>;
  return static_cast<int>(launch(dg, dg_sp, dg_sj, dg_sb, dg_div, keys, key_sp, key_sj,
                                 key_se, key_mod, out, p, mu, ipsi, ipsi_sh, n_inv, n_inv_sh,
                                 k, kd, batch, logn, threads, smem, vec, go,
                                 static_cast<cudaStream_t>(stream)));
}

// The column form's launches (ops/column_cuda.py gives every shape): a
// block of 2^logb positions, tiles of 2^logc columns, `threads` per CTA and
// `smem` bytes (the block launches; a column launch's is its tile's words).
// Residue rows [k, comps, B, n] between the launches are the wrapper's.

// lane: 0 Plain, 1 Reduce, 2 Galois (h_gal = g^-1 mod 2n).
int fhe_column_forward(int lane, const void* x, long long x_sp, long long x_sc, long long x_sb,
                       int comps, void* y, int y_comps, int y_off, const void* p, const void* mu,
                       const void* psi, const void* psi_sh, int k, int batch, int logn,
                       int logb, int logc, int threads, unsigned h_gal, void* stream) {
  if (!fhe::column_args_ok(logn, logb, logc) || lane < 0 || lane > 2 || comps < 1
      || y_off + comps > y_comps)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const dim3 grid(1 << (logb - logc), comps * batch, k);
  const int smem = 4 << (logn - logb + logc);
  auto run = [&](auto launch) {
    return launch(grid, threads, smem, static_cast<cudaStream_t>(stream), u(x), x_sp, x_sc,
                  x_sb, comps, static_cast<uint32_t*>(y), y_comps, y_off, u(p), u(mu), u(psi),
                  u(psi_sh), logn, logb, logc, static_cast<uint32_t>(h_gal));
  };
  return static_cast<int>(
      lane == 2   ? run(fhe::PlainLaunch<&column_forward_kernel<ColumnLane::Galois>>{})
      : lane == 1 ? run(fhe::PlainLaunch<&column_forward_kernel<ColumnLane::Reduce>>{})
                  : run(fhe::PlainLaunch<&column_forward_kernel<ColumnLane::Plain>>{}));
}

// The Galois add where c0 is given (hs: [h_mod] inverses g^-1 mod 2n, or
// null for h_gal alone).
int fhe_column_inverse(const void* x, void* y, int comps, const void* p, const void* ipsi,
                       const void* ipsi_sh, const void* n_inv, const void* n_inv_sh, int k,
                       int batch, int logn, int logb, int logc, int threads, const void* hs,
                       unsigned h_gal, int h_mod, const void* c0, long long c0_sp,
                       long long c0_sb, int c0_div, void* stream) {
  if (!fhe::column_args_ok(logn, logb, logc) || comps < 1
      || (c0 != nullptr && (h_mod < 1 || c0_div < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const dim3 grid(1 << (logb - logc), comps * batch, k);
  const int smem = 4 << (logn - logb + logc);
  auto run = [&](auto launch) {
    return launch(grid, threads, smem, static_cast<cudaStream_t>(stream), u(x),
                  static_cast<uint32_t*>(y), comps, u(p), u(ipsi), u(ipsi_sh), u(n_inv),
                  u(n_inv_sh), logn, logb, logc, u(hs), static_cast<uint32_t>(h_gal), h_mod,
                  u(c0), c0_sp, c0_sb, c0_div);
  };
  return static_cast<int>(c0 != nullptr
                              ? run(fhe::PlainLaunch<&column_inverse_kernel<true>>{})
                              : run(fhe::PlainLaunch<&column_inverse_kernel<false>>{}));
}

int fhe_block_forward(void* y, const void* p, const void* psi, const void* psi_sh, int k,
                      int batch, int logn, int logb, int threads, int smem, void* stream) {
  if (!block_args_ok(logn, logb, smem, 1)) return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  return static_cast<int>(fhe::PlainLaunch<&block_forward_kernel>{}(
      dim3(1 << (logn - logb), batch, k), threads, smem, static_cast<cudaStream_t>(stream),
      static_cast<uint32_t*>(y), u(p), u(psi), u(psi_sh), logn, logb));
}

int fhe_block_inverse(const void* x, int vec, void* y, const void* p, const void* ipsi,
                      const void* ipsi_sh, int k, int batch, int logn, int logb, int threads,
                      int smem, void* stream) {
  if (!block_args_ok(logn, logb, smem, 1)) return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  return static_cast<int>(fhe::PlainLaunch<&block_inverse_kernel>{}(
      dim3(1 << (logn - logb), batch, k), threads, smem, static_cast<cudaStream_t>(stream),
      u(x), static_cast<uint32_t*>(y), u(p), u(ipsi), u(ipsi_sh), logn, logb, vec));
}

int fhe_block_mul(const void* x, const void* w, void* y, const void* p, const void* mu,
                  const void* psi, const void* psi_sh, const void* ipsi, const void* ipsi_sh,
                  int k, int num_c, int batch, int logn, int logb, int threads, int smem,
                  void* stream) {
  if (!block_args_ok(logn, logb, smem, 1) || num_c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  return static_cast<int>(fhe::PlainLaunch<&block_mul_kernel>{}(
      dim3(1 << (logn - logb), num_c * batch, k), threads, smem,
      static_cast<cudaStream_t>(stream), u(x), u(w), static_cast<uint32_t*>(y), u(p), u(mu),
      u(psi), u(psi_sh), u(ipsi), u(ipsi_sh), num_c, logn, logb));
}

int fhe_block_product(const void* x, void* y, const void* p, const void* mu, const void* psi,
                      const void* psi_sh, const void* ipsi, const void* ipsi_sh, int k,
                      int batch, int logn, int logb, int threads, int smem, void* stream) {
  if (!block_args_ok(logn, logb, smem, 4)) return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  return static_cast<int>(fhe::PlainLaunch<&block_product_kernel>{}(
      dim3(1 << (logn - logb), batch, k), threads, smem, static_cast<cudaStream_t>(stream),
      u(x), static_cast<uint32_t*>(y), u(p), u(mu), u(psi), u(psi_sh), u(ipsi), u(ipsi_sh),
      logn, logb));
}

int fhe_block_keyswitch(const void* x, const void* keys, long long key_sp, long long key_sj,
                        void* y, const void* p, const void* mu, const void* psi,
                        const void* psi_sh, const void* ipsi, const void* ipsi_sh, int k, int kd,
                        int batch, int logn, int logb, int threads, int smem, void* stream) {
  if (!block_args_ok(logn, logb, smem, 1, 2 << logb) || kd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  return static_cast<int>(fhe::PlainLaunch<&block_keyswitch_kernel>{}(
      dim3(1 << (logn - logb), batch, k), threads, smem, static_cast<cudaStream_t>(stream),
      u(x), u(keys), key_sp, key_sj, static_cast<uint32_t*>(y), u(p), u(mu), u(psi), u(psi_sh),
      u(ipsi), u(ipsi_sh), kd, logn, logb));
}

// lane: 0 Inner, 1 Galois (gs: the key sets' Galois elements).
int fhe_block_inner(int lane, const void* dg, long long dg_sp, long long dg_sj, long long dg_sb,
                    int dg_div, const void* keys, long long key_sp, long long key_sj,
                    long long key_se, int key_mod, void* y, const void* p, const void* mu,
                    const void* ipsi, const void* ipsi_sh, int k, int kd, int batch, int logn,
                    int logb, int threads, int smem, int vec, const void* gs, void* stream) {
  if (!block_args_ok(logn, logb, smem, 1) || kd < 1 || dg_div < 1 || key_mod < 1
      || (lane != 0 && lane != 1) || (lane == 1 && gs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  auto run = [&](auto launch) {
    return launch(dim3(1 << (logn - logb), 2 * batch, k), threads, smem,
                  static_cast<cudaStream_t>(stream), u(dg), dg_sp, dg_sj, dg_sb, dg_div, u(keys),
                  key_sp, key_sj, key_se, key_mod, static_cast<uint32_t*>(y), u(p), u(mu),
                  u(ipsi), u(ipsi_sh), kd, logn, logb, vec, u(gs));
  };
  return static_cast<int>(lane == 1 ? run(fhe::PlainLaunch<&block_inner_kernel<true>>{})
                                    : run(fhe::PlainLaunch<&block_inner_kernel<false>>{}));
}

}  // extern "C"
