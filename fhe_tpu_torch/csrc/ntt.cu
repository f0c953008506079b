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
// per block (256 KB) did not.  The two kernels keep two bodies: with one
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
// (3 in all) ran three forwards and a two-row inverse in series.
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

#include "lift.cuh"
#include "modmath.cuh"

namespace {

namespace cg = cooperative_groups;

// CTAs per row of every cluster kernel here, per cluster of tensor_product
// (one pair per input row x0, x1, y0, y1), and the most digit pairs of a
// keyswitch_fused cluster (ops/ntt_cuda.py: ROW_SPLIT, PRODUCT_CLUSTER,
// KEYSWITCH_PAIRS)
constexpr int kRowSplit = 2;
constexpr int kProductCluster = 4 * kRowSplit;
constexpr int kKeyswitchPairs = 4;

// Cluster (b, i) of 2 CTAs: y[i, b] = NTT(x[i, b]) for x, y [k, batch, n],
// grid (2 * batch, k) in clusters of (2, 1, 1).  CTA h runs half of each
// pass (modmath.cuh's RowSplit note): it loads its columns of the row in the
// first pass and stores positions [h n/2, (h+1) n/2), 16 consecutive words
// per group, in the last.  Shared memory: one padded row.
__global__ void __launch_bounds__(512)
ntt_forward_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ p, const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_sh, int batch, int logn) {
  extern __shared__ uint32_t a[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int b = blockIdx.x / kRowSplit;
  const int i = blockIdx.y;
  const size_t tab = static_cast<size_t>(i) * n;
  const size_t row = (static_cast<size_t>(i) * batch + b) * n;
  const uint32_t* src = x + row;
  uint32_t* dst = y + row;
  static_assert(kRowSplit == 2, "the split below names both CTAs of a row");
  const fhe::RowSplit<kRowSplit> split{
      {cluster.map_shared_rank(a, 0), cluster.map_shared_rank(a, 1)},
      static_cast<int>(cluster.block_rank())};
  fhe::fwd_ntt_regs_split(
      a, split, [&] { cluster.sync(); }, logn, p[i], psi + tab, psi_sh + tab,
      [&](auto& v, int base, int logs) {
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
          v[g] = src[base + (g << logs)];
      },
      // the last pass's group is consecutive (logs = 0, base a multiple of its size)
      [&](auto& v, int base, int) { fhe::store_run(dst, base, v); });
  // the partner read this CTA's row in the second pass: neither leaves (and
  // frees its shared memory) before both have
  cluster.sync();
}

// Cluster (b, i) of 2 CTAs: y[i, b] = n^-1 INTT(x[i, b]) for x, y [k, batch,
// n], grid (2 * batch, k) in clusters of (2, 1, 1): ntt_forward's mirror.
// CTA h runs half of each pass (modmath.cuh's RowSplit note): it loads
// positions [h n/2, (h+1) n/2), 16 consecutive words per group, in the
// first pass (16-byte loads where `vec`: x starts 16-byte aligned) and
// stores its share of the row's columns, times n^-1, in the last.  Shared
// memory: one padded row.
__global__ void __launch_bounds__(512)
ntt_inverse_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ p, const uint32_t* __restrict__ ipsi,
                   const uint32_t* __restrict__ ipsi_sh,
                   const uint32_t* __restrict__ n_inv,
                   const uint32_t* __restrict__ n_inv_sh, int batch, int logn, int vec) {
  extern __shared__ uint32_t a[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int b = blockIdx.x / kRowSplit;
  const int i = blockIdx.y;
  const size_t tab = static_cast<size_t>(i) * n;
  const size_t row = (static_cast<size_t>(i) * batch + b) * n;
  const uint32_t* src = x + row;
  uint32_t* dst = y + row;
  static_assert(kRowSplit == 2, "the split below names both CTAs of a row");
  const fhe::RowSplit<kRowSplit> split{
      {cluster.map_shared_rank(a, 0), cluster.map_shared_rank(a, 1)},
      static_cast<int>(cluster.block_rank())};
  fhe::inv_ntt_regs_split(
      a, split, [&] { cluster.sync(); }, logn, p[i], ipsi + tab, ipsi_sh + tab, n_inv[i],
      n_inv_sh[i],
      // the first pass's group is consecutive (logs = 0, base a multiple of its size)
      [&](auto& v, int base, int) { fhe::load_run(src, base, vec, v); },
      [&](auto& v, int base, int logs) {
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(v) / sizeof(v[0])); ++g)
          dst[base + (g << logs)] = v[g];
      });
  // the partner read this CTA's row in the last pass: neither leaves (and
  // frees its shared memory) before both have
  cluster.sync();
}

// Cluster (i, c, b) of 2 CTAs: out[i, c, b] = INTT(NTT(u[i, b]) . w[i, c]).
// Row (i, b) of u starts at u + i * u_sp + b * u_sb, so a view of one
// ciphertext component, or the rows of a stack, is read in place; w is the
// shared [k, num_c, n] operand, each row 16-byte aligned (the wrapper
// checks); out is [k, num_c, B, n].  Grid (2, num_c * B, k) in clusters of
// (2, 1, 1), blockIdx.y = c * B + b.  CTA h runs half of each pass of the
// two transforms (the row split of modmath.cuh's RowSplit note) and keeps
// positions [h n/2, (h+1) n/2) of NTT(u) between them, where it multiplies
// them by w[i, c] in the forward's last pass.  Shared memory: one padded row.
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
  const fhe::RowSplit<kRowSplit> split{
      {cluster.map_shared_rank(a, 0), cluster.map_shared_rank(a, 1)}, h};
  auto sync = [&] { cluster.sync(); };
  const uint32_t* ur = u + i * u_sp + b * u_sb;
  const uint32_t* wr = w + (static_cast<size_t>(i) * num_c + c) * n;
  fhe::fwd_ntt_regs_split(
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
          a[fhe::padded_index(base + g)] = fhe::mul_barrett(x[g], wv[g], pi, mui);
      });
  uint32_t* dst = out + (static_cast<size_t>(i) * gridDim.y + cb) * n;
  fhe::inv_ntt_regs_split(
      a, split, sync, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i],
      fhe::SmemLoad{a}, [&](auto& x, int base, int logs) {
#pragma unroll
        for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g)
          dst[base + (g << logs)] = x[g];
      });
  // the partner read this CTA's row in the inverse's last pass: neither
  // leaves (and frees its shared memory) before both have
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
// and the sweeps' working row (read by the partner).
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
template <ProductLane LANE>
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
                      const fhe::SmMRqOperands lo, const ProductTables tq) {
  constexpr bool lifted = LANE == ProductLane::Lift;
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  uint32_t* row = sm;                        // input row r, NTT form
  uint32_t* work = sm + fhe::padded(n);      // the sweeps' passes
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = rank / kRowSplit, h = rank % kRowSplit;
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
    // k source loads in flight: at n < 1024 the first pass has n/32 groups
    // per CTA, and lifting a group of 16 in one thread, k loads after one
    // another, took 3 us (PERF.md)
    const fhe::SmMRqLift lift(lo, i, pi);
    const int cols = (n >> fhe::kRegLog) / kRowSplit;
    const int logc = logn - fhe::kRegLog - 1;
    for (int e = threadIdx.x; e < n / kRowSplit; e += blockDim.x) {
      const int j = ((e >> logc) << (logn - fhe::kRegLog)) + h * cols + (e & (cols - 1));
      work[fhe::padded_index(j)] = lift.one(src + j, s_p);
    }
    __syncthreads();
  }
  fhe::fwd_ntt_regs_split(
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
      fhe::SmemStore{row});
  cluster.sync();
  if (r < 3) {
    const uint32_t mui = tmu[i];
    const uint32_t* x0 = cluster.map_shared_rank(row, 0 * kRowSplit + h);
    const uint32_t* x1 = cluster.map_shared_rank(row, 1 * kRowSplit + h);
    const uint32_t* y0 = cluster.map_shared_rank(row, 2 * kRowSplit + h);
    const uint32_t* y1 = cluster.map_shared_rank(row, 3 * kRowSplit + h);
    const uint32_t* pa = r == 0 ? x0 : x1;
    const uint32_t* pb = r == 0 ? y0 : y1;
    const int end = (h + 1) * (n / kRowSplit);
#pragma unroll 8
    for (int j = h * (n / kRowSplit) + threadIdx.x; j < end; j += blockDim.x) {
      const int e = fhe::padded_index(j);
      work[e] = r == 1 ? fhe::add_mod(fhe::mul_barrett(x0[e], y1[e], pi, mui),
                                      fhe::mul_barrett(x1[e], y0[e], pi, mui), pi)
                       : fhe::mul_barrett(pa[e], pb[e], pi, mui);
    }
    __syncthreads();
    uint32_t* dst = out + ((static_cast<size_t>(z) * 3 + r) * gridDim.y + b) * n;
    fhe::inv_ntt_regs_split(
        work, split, sync, logn, pi, tipsi + tab, tipsi_sh + tab, tn_inv[i], tn_inv_sh[i],
        fhe::SmemLoad{work}, [&](auto& v, int base, int logs) {
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
// rounded up to whole 16-byte words (ops/ntt_cuda.py: staged_smem).
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
template <KsLane LANE>
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
                 long long c0_sb, int vec) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int half = n / kRowSplit;
  const int part_row = fhe::padded(half);
  uint32_t* work = sm;                        // the sweeps' passes
  uint32_t* part = sm + fhe::padded(n);       // partial sums of rows 0 and 1, own half
  uint32_t* stage = sm + stage_offset(2 * fhe::padded(n));  // Galois: the row gathered from
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = rank / kRowSplit, h = rank % kRowSplit;
  const int b = blockIdx.y;
  const int i = blockIdx.z;
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  static_assert(kRowSplit == 2, "the split below names both CTAs of a row");
  const fhe::RowSplit<kRowSplit> split{{cluster.map_shared_rank(work, r * kRowSplit),
                                        cluster.map_shared_rank(work, r * kRowSplit + 1)},
                                       h};
  auto sync = [&] { cluster.sync(); };
  const uint32_t* d_ib = d + i * d_sp + b * d_sb;
  const uint32_t* key_i = keys + i * key_sp;
  for (int m = 0, j = r; m * pairs < kd; ++m, j += pairs) {
    // the partner's second pass of the last round read this CTA's row (and,
    // in the Galois lane, this CTA's first pass its staged row)
    if (m > 0) cluster.sync();
    if (j >= kd) {
      cluster.sync();    // the barrier inside the peers' forward
      continue;
    }
    const uint32_t* dr = d_ib + j * d_sj;
    const uint32_t* k0 = key_i + j * key_sj;
    const uint32_t* k1 = k0 + n;
    const bool first = m == 0;
    if constexpr (LANE == KsLane::Galois) {
      stage_row(stage, dr, n, vec);
      stage_wait();
      __syncthreads();
    }
    const uint32_t qj = LANE == KsLane::Galois ? p[j] : 0;
    fhe::fwd_ntt_regs_split(
        work, split, sync, logn, pi, psi + tab, psi_sh + tab,
        [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g) {
            if constexpr (LANE == KsLane::Galois) {
              bool neg;
              uint32_t v = stage[coeff_source(h_gal, base + (g << logs), logn, neg)];
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
          uint32_t* acc = part + fhe::padded_index(base - h * half);
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
  cluster.sync();        // every partial sum is complete
  if (r < 2) {
    const bool add_c0 = LANE == KsLane::Galois && r == 0;
    // the forwards are over, so the staged row is free for c0, copied while
    // the partials are summed (the __syncthreads below publishes it)
    if (add_c0) stage_row(stage, c0 + i * c0_sp + b * c0_sb, n, vec);
    const int summed = kd < pairs ? kd : pairs;    // the pairs that had a digit
    const uint32_t* mine = part + r * part_row;
#pragma unroll 4
    for (int e = threadIdx.x; e < half; e += blockDim.x) {
      const int pe = fhe::padded_index(e);
      uint32_t s = 0;
#pragma unroll
      for (int q = 0; q < kKeyswitchPairs; ++q)
        if (q < summed)
          s = fhe::add_mod(s, cluster.map_shared_rank(mine, q * kRowSplit + h)[pe], pi);
      work[fhe::padded_index(h * half + e)] = s;
    }
    if (add_c0) stage_wait();
    __syncthreads();
    uint32_t* dst = out + ((static_cast<size_t>(i) * 2 + r) * gridDim.y + b) * n;
    fhe::inv_ntt_regs_split(
        work, split, sync, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i],
        fhe::SmemLoad{work}, [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g) {
            const int pos = base + (g << logs);
            uint32_t v = x[g];
            if (add_c0) {
              bool neg;
              uint32_t w = stage[coeff_source(h_gal, pos, logn, neg)];
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
template <InnerLane LANE>
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
  static_assert(kRowSplit == 2, "the split below names both CTAs of a row");
  const fhe::RowSplit<kRowSplit> split{
      {cluster.map_shared_rank(a, 0), cluster.map_shared_rank(a, 1)},
      static_cast<int>(cluster.block_rank())};
  const bool add_c0 = galois && c == 0;
  const uint32_t* c0 = galois ? go.c0 + i * go.c0_sp + (b / dg_div) * go.c0_ss : nullptr;
  uint32_t* c0s = a + stage_offset(fhe::padded(n));
  // copied while the first passes run; the cluster barrier before the last
  // pass publishes it
  if (staged && add_c0) stage_row(c0s, c0, n, vec);
  fhe::inv_ntt_regs_split(
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
                            pi, mui, a + fhe::padded_index(base));
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
  // the partner read this CTA's row in the last pass: neither leaves (and
  // frees its shared memory) before both have
  cluster.sync();
}

// Shared memory of `words` words of rows and, where a lane gathers, a
// staged row of n words behind them (stage_offset).
inline int lane_smem(int words, int n, bool staged) {
  return 4 * (staged ? stage_offset(words) + n : words);
}

template <ProductLane LANE>
cudaError_t launch_tensor_product(const void* x, const void* y, long long s_p, long long s_c,
                                  long long s_b, void* out, const void* p, const void* mu,
                                  const void* psi, const void* psi_sh, const void* ipsi,
                                  const void* ipsi_sh, const void* n_inv,
                                  const void* n_inv_sh, int k, int batch, int logn,
                                  int threads, int smem, const fhe::SmMRqOperands& lo,
                                  const ProductTables& tq, cudaStream_t stream) {
  if (logn <= fhe::kRegLog || smem < 2 * 4 * fhe::padded(1 << logn)
      || (LANE == ProductLane::Lift
          && (lo.k < 1 || lo.k > fhe::kMaxLiftK || k <= lo.k || tq.p == nullptr)))
    return cudaErrorInvalidValue;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(tensor_product_kernel<LANE>);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(kProductCluster, batch, k), threads, smem, kProductCluster, stream, attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return err;
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, tensor_product_kernel<LANE>, c(x), c(y), s_p, s_c, s_b,
                           static_cast<uint32_t*>(out), c(p), c(mu), c(psi), c(psi_sh),
                           c(ipsi), c(ipsi_sh), c(n_inv), c(n_inv_sh), logn, lo, tq);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <KsLane LANE>
cudaError_t launch_keyswitch(const void* d, long long d_sp, long long d_sj, long long d_sb,
                             const void* keys, long long key_sp, long long key_sj, void* out,
                             const void* p, const void* mu, const void* psi,
                             const void* psi_sh, const void* ipsi, const void* ipsi_sh,
                             const void* n_inv, const void* n_inv_sh, int k, int kd,
                             int batch, int logn, int pairs, int threads, int smem,
                             unsigned h_gal, const void* c0, long long c0_sp, long long c0_sb,
                             int vec, cudaStream_t stream) {
  constexpr bool galois = LANE == KsLane::Galois;
  if (logn <= fhe::kRegLog || kd < 1 || pairs < 2 || pairs > kKeyswitchPairs
      || smem < lane_smem(2 * fhe::padded(1 << logn), 1 << logn, galois)
      || (galois && (kd > k || c0 == nullptr)))
    return cudaErrorInvalidValue;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(keyswitch_kernel<LANE>);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(kRowSplit * pairs, batch, k), threads, smem, kRowSplit * pairs, stream, attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return err;
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, keyswitch_kernel<LANE>, c(d), d_sp, d_sj, d_sb, c(keys),
                           key_sp, key_sj, static_cast<uint32_t*>(out), c(p), c(mu), c(psi),
                           c(psi_sh), c(ipsi), c(ipsi_sh), c(n_inv), c(n_inv_sh), kd, pairs,
                           logn, static_cast<uint32_t>(h_gal), c(c0), c0_sp, c0_sb, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <InnerLane LANE>
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
      || smem < lane_smem(fhe::padded(n), n, LANE == InnerLane::Galois)
      || (galois && (go.gs == nullptr || go.hs == nullptr || go.c0 == nullptr)))
    return cudaErrorInvalidValue;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(ks_inner_kernel<LANE>);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(kRowSplit, 2 * batch, k), threads, smem, kRowSplit, stream, attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return err;
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, ks_inner_kernel<LANE>, c(dg), dg_sp, dg_sj, dg_sb, dg_div,
                           c(keys), key_sp, key_sj, key_se, key_mod,
                           static_cast<uint32_t*>(out), c(p), c(mu), c(ipsi), c(ipsi_sh),
                           c(n_inv), c(n_inv_sh), kd, logn, vec, go);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch geometry of every kernel here comes from the wrapper
// (ops/ntt_cuda.py: ntt_forward_geometry, ntt_inverse_geometry,
// mul_by_ntt_operand_geometry, tensor_product_geometry, keyswitch_geometry
// and ks_inner_geometry): `threads` per CTA and `smem` bytes per CTA, at
// least the padded rows the kernel uses, and keyswitch_fused's digit pairs.
// `vec` (ntt_inverse, ks_inner) says that every input row starts 16-byte
// aligned, so the first pass may load it in 16-byte words.
int fhe_ntt_forward(const void* x, void* y, const void* p, const void* psi,
                    const void* psi_sh, int k, int batch, int logn, int threads, int smem,
                    void* stream) {
  if (logn <= fhe::kRegLog || smem < 4 * fhe::padded(1 << logn))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(ntt_forward_kernel);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(kRowSplit * batch, k), threads, smem, kRowSplit,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, ntt_forward_kernel, c(x), static_cast<uint32_t*>(y), c(p),
                           c(psi), c(psi_sh), batch, logn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fhe_ntt_inverse(const void* x, void* y, const void* p, const void* ipsi,
                    const void* ipsi_sh, const void* n_inv, const void* n_inv_sh,
                    int k, int batch, int logn, int threads, int smem, int vec,
                    void* stream) {
  if (logn <= fhe::kRegLog || smem < 4 * fhe::padded(1 << logn))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(ntt_inverse_kernel);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(kRowSplit * batch, k), threads, smem, kRowSplit,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, ntt_inverse_kernel, c(x), static_cast<uint32_t*>(y), c(p),
                           c(ipsi), c(ipsi_sh), c(n_inv), c(n_inv_sh), batch, logn, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fhe_mul_by_ntt_operand(const void* u, long long u_sp, long long u_sb, const void* w,
                           void* out, const void* p, const void* mu, const void* psi,
                           const void* psi_sh, const void* ipsi, const void* ipsi_sh,
                           const void* n_inv, const void* n_inv_sh, int k, int num_c,
                           int batch, int logn, int threads, int smem, void* stream) {
  if (logn <= fhe::kRegLog || smem < 4 * fhe::padded(1 << logn))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(mul_by_ntt_operand_kernel);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(kRowSplit, num_c * batch, k), threads, smem, kRowSplit,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(&cfg, mul_by_ntt_operand_kernel, c(u), u_sp, u_sb, c(w),
                           static_cast<uint32_t*>(out), c(p), c(mu), c(psi), c(psi_sh),
                           c(ipsi), c(ipsi_sh), c(n_inv), c(n_inv_sh), num_c, logn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// tensor_product's lanes: Plain where lift_q is null, else Lift, with the
// lift's constants (lift.cuh SmMRqOperands: lift_k source primes) and the
// q tables (tq_*, table_ptrs' order); then k counts the lift_k q primes and
// the Bsk primes of the tables p .. n_inv_sh.
int fhe_tensor_product(const void* x, const void* y, long long s_p, long long s_c,
                       long long s_b, void* out, const void* p, const void* mu,
                       const void* psi, const void* psi_sh, const void* ipsi,
                       const void* ipsi_sh, const void* n_inv, const void* n_inv_sh, int k,
                       int batch, int logn, int threads, int smem, const void* lift_q,
                       const void* lift_w, const void* lift_w_sh, const void* lift_phat,
                       const void* lift_phat_sh, const void* lift_phat_mt,
                       const void* lift_q_mod_c, const void* lift_q_mod_c_sh,
                       const void* lift_inv_mt_c, const void* lift_inv_mt_c_sh,
                       unsigned lift_inv_q_mt, int lift_k, const void* tq_p,
                       const void* tq_mu, const void* tq_psi, const void* tq_psi_sh,
                       const void* tq_ipsi, const void* tq_ipsi_sh, const void* tq_n_inv,
                       const void* tq_n_inv_sh, void* stream) {
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const fhe::SmMRqOperands lo{c(lift_q), c(lift_w), c(lift_w_sh), c(lift_phat),
                              c(lift_phat_sh), c(lift_phat_mt), c(lift_q_mod_c),
                              c(lift_q_mod_c_sh), c(lift_inv_mt_c), c(lift_inv_mt_c_sh),
                              static_cast<uint32_t>(lift_inv_q_mt), lift_k};
  const ProductTables tq{c(tq_p), c(tq_mu), c(tq_psi), c(tq_psi_sh), c(tq_ipsi),
                         c(tq_ipsi_sh), c(tq_n_inv), c(tq_n_inv_sh)};
  auto* launch = lift_q != nullptr ? &launch_tensor_product<ProductLane::Lift>
                                   : &launch_tensor_product<ProductLane::Plain>;
  return static_cast<int>(launch(x, y, s_p, s_c, s_b, out, p, mu, psi, psi_sh, ipsi, ipsi_sh,
                                 n_inv, n_inv_sh, k, batch, logn, threads, smem, lo, tq,
                                 static_cast<cudaStream_t>(stream)));
}

// keyswitch_fused's lanes: 0 Classic, 1 Prereduced, 2 Galois (h_gal =
// g^-1 mod 2n, c0 of element b for prime i at c0 + i * c0_sp + b * c0_sb).
int fhe_keyswitch(const void* d, long long d_sp, long long d_sj, long long d_sb,
                  const void* keys, long long key_sp, long long key_sj, void* out,
                  const void* p, const void* mu, const void* psi, const void* psi_sh,
                  const void* ipsi, const void* ipsi_sh, const void* n_inv,
                  const void* n_inv_sh, int k, int kd, int batch, int logn, int pairs,
                  int threads, int smem, int lane, unsigned h_gal, const void* c0,
                  long long c0_sp, long long c0_sb, int vec, void* stream) {
  auto* launch = lane == 2   ? &launch_keyswitch<KsLane::Galois>
                 : lane == 1 ? &launch_keyswitch<KsLane::Prereduced>
                             : &launch_keyswitch<KsLane::Classic>;
  return static_cast<int>(launch(d, d_sp, d_sj, d_sb, keys, key_sp, key_sj, out, p, mu, psi,
                                 psi_sh, ipsi, ipsi_sh, n_inv, n_inv_sh, k, kd, batch, logn,
                                 pairs, threads, smem, h_gal, c0, c0_sp, c0_sb, vec,
                                 static_cast<cudaStream_t>(stream)));
}

// ks_inner's lanes: 0 Inner, 1 Galois, 2 GaloisInPlace (gs, hs: the key
// sets' Galois elements and their inverses mod 2n; c0 of digit stack s for
// prime i at c0 + i * c0_sp + s * c0_ss; lane 1 stages it behind the padded
// row in smem).
int fhe_ks_inner(const void* dg, long long dg_sp, long long dg_sj, long long dg_sb,
                 int dg_div, const void* keys, long long key_sp, long long key_sj,
                 long long key_se, int key_mod, void* out, const void* p, const void* mu,
                 const void* ipsi, const void* ipsi_sh, const void* n_inv,
                 const void* n_inv_sh, int k, int kd, int batch, int logn, int threads,
                 int smem, int vec, int lane, const void* gs, const void* hs,
                 const void* c0, long long c0_sp, long long c0_ss, void* stream) {
  auto c = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const GaloisOperands go{c(gs), c(hs), c(c0), c0_sp, c0_ss};
  auto* launch = lane == 2   ? &launch_ks_inner<InnerLane::GaloisInPlace>
                 : lane == 1 ? &launch_ks_inner<InnerLane::Galois>
                             : &launch_ks_inner<InnerLane::Inner>;
  return static_cast<int>(launch(dg, dg_sp, dg_sj, dg_sb, dg_div, keys, key_sp, key_sj,
                                 key_se, key_mod, out, p, mu, ipsi, ipsi_sh, n_inv, n_inv_sh,
                                 k, kd, batch, logn, threads, smem, vec, go,
                                 static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
