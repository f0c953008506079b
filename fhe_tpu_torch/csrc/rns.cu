// BEHZ base-conversion kernels of the ciphertext multiply for Hopper (sm_90a).
//
// Replaces fhe_tpu/ops/rns_pallas.py: bsk_branch_fused (body
// _bsk_branch_kernel), fast_bconv_sk_fused (body _sk_kernel), and the n < 1024
// multiply's sm_mrq_fused (body _smq_kernel) and fast_floor_fused (body
// _floor_kernel).  Plain versions: fhe_tpu_torch/ops/rns.py (bsk_branch_fused
// and bsk_branch_fused_batch, fast_bconv_sk, sm_mrq, fast_floor).  The JAX
// multiply_batch runs the Bsk branch as vmapped jnp chains around
// tensor_product_batch; here it is this one kernel with a batch grid axis,
// which computes the same residues.
//
// bsk_branch_fused, for element b and Bsk prime c_j (B = 1 for the single
// multiply, the batch size for multiply_batch):
//   1. SmMRq lift of the four rows a0, a1, b0, b1 from q into c_j: digits
//      y_i = [x_i * m~ * (q/q_i)^-1]_{q_i}, conv = sum_i y_i * (q/q_i) mod c_j
//      and the m~ = 2^16 lane sum_i (y_i & 0xFFFF) * (q/q_i) mod 2^16; alpha =
//      lane * q^-1 mod 2^16, centred; lift = (conv - alpha*q) * m~^-1 mod c_j;
//   2. forward NTT of the four rows, tensor product, inverse NTT of three
//      rows with t * n^-1 (the Bsk half of the multiply's tables);
//   3. FastFloor: (tx_bsk - conv(tx_q)) * q^-1 mod c_j, with tx_q [k, 3, n]
//      the t-scaled q-side product, its digits converted to c_j.
// The lift and the Bsk product never leave shared memory.  The TPU grid ran
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
// fast_bconv_sk_fused: exact Shenoy-Kumaresan conversion Bsk -> q.  It is
// elementwise over coefficients with a sum over the kb - 1 aux rows, so one
// thread per output element (q prime, row, coefficient) recomputes the aux
// digits it needs; no shared memory.
//
// sm_mrq_fused and fast_floor_fused are steps 1 and 3 of bsk_branch_fused on
// their own, for the n < 1024 multiply, which runs the Bsk tensor product as
// a separate tensor_product launch, as the JAX package does.  They are built
// like fast_bconv_sk_fused: one thread per output residue (Bsk prime j, row,
// coefficient) recomputes the k source digits it needs, and the arithmetic
// is the same __device__ function that bsk_branch_fused calls (sm_mrq_coeff,
// fast_floor_coeff), so the two paths cannot drift.
//
// Every digit y_i is a residue mod its own source prime and may exceed the
// destination prime (m_sk and several aux primes are below some q_i), so
// every product with a digit is a Shoup multiply, exact for any x < 2^32;
// mul_barrett only ever sees reduced operands.  The m~ lane is arithmetic
// mod 2^16 in uint32 with a mask: (2^16 - 1)^2 + 2^16 < 2^32.
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
// fast_bconv_sk_fused moves 480 KB + 288 KB and runs 74 K threads: it is
// bound by launch latency.  So are sm_mrq_fused and fast_floor_fused: at
// n = 8192, k = 3, kb = 5 the lift of the four rows reads 393 KB and writes
// 655 KB (0.3 us by memory rate, about 1 us by the issue rate) in 164 K
// threads, and the n = 256 multiply that runs them gives them 7 K or fewer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "modmath.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr uint32_t kMask16 = 0xFFFFu;
// CTAs per input row of bsk_branch_fused (ops/rns_cuda.py: BSK_ROW_SPLIT)
constexpr int kRowSplit = 2;

// The SmMRq centred lift into the destination prime c (bsk_branch_fused
// step 1, sm_mrq_fused), one source prime at a time.  sm_mrq_step folds in
// the residue x_i of source prime q_i: the digit y_i = [x_i * m~ *
// (q/q_i)^-1]_{q_i} (w, w_sh), conv += y_i * (q/q_i) mod c (phat, phat_sh:
// c's entry of the [l, k] table) and the m~ = 2^16 lane, lane += (y_i &
// 0xFFFF) * (q/q_i) mod 2^16 (phat_mt).  sm_mrq_close: alpha = lane * q^-1
// mod 2^16, centred; the lift is (conv - alpha*q) * m~^-1 mod c, with qc, imt
// = q mod c and m~^-1 mod c and their Shoup companions.
__device__ __forceinline__ void sm_mrq_step(uint32_t x_i, uint32_t qi, uint32_t w,
                                            uint32_t w_sh, uint32_t phat, uint32_t phat_sh,
                                            uint32_t phat_mt, uint32_t c, uint32_t& conv,
                                            uint32_t& lane) {
  const uint32_t y = fhe::mul_shoup(x_i, w, w_sh, qi);
  conv = fhe::add_mod(conv, fhe::mul_shoup(y, phat, phat_sh, c), c);
  lane = (lane + (y & kMask16) * phat_mt) & kMask16;
}

__device__ __forceinline__ uint32_t sm_mrq_close(uint32_t conv, uint32_t lane,
                                                 uint32_t inv_q_mt, uint32_t c, uint32_t qc,
                                                 uint32_t qc_sh, uint32_t imt,
                                                 uint32_t imt_sh) {
  const uint32_t alpha = (lane * inv_q_mt) & kMask16;
  const uint32_t alpha_c = alpha < (1u << 15) ? alpha : c - ((1u << 16) - alpha);
  const uint32_t centred = fhe::sub_mod(conv, fhe::mul_shoup(alpha_c, qc, qc_sh, c), c);
  return fhe::mul_shoup(centred, imt, imt_sh, c);
}

// The lift of one coefficient whose residue mod q_i is src[i * sp], i < k.
__device__ __forceinline__ uint32_t sm_mrq_coeff(
    const uint32_t* __restrict__ src, int sp, int k, const uint32_t* __restrict__ q,
    const uint32_t* __restrict__ mt_inv_phat, const uint32_t* __restrict__ mt_inv_phat_sh,
    const uint32_t* __restrict__ phat, const uint32_t* __restrict__ phat_sh,
    const uint32_t* __restrict__ phat_mt, uint32_t inv_q_mt, uint32_t c, uint32_t qc,
    uint32_t qc_sh, uint32_t imt, uint32_t imt_sh) {
  uint32_t conv = 0, lane = 0;
  for (int i = 0; i < k; ++i)
    sm_mrq_step(src[i * sp], q[i], mt_inv_phat[i], mt_inv_phat_sh[i], phat[i], phat_sh[i],
                phat_mt[i], c, conv, lane);
  return sm_mrq_close(conv, lane, inv_q_mt, c, qc, qc_sh, imt, imt_sh);
}

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

// The floor of one coefficient whose residues of t*x mod q_i are
// src[i * sp], i < k; phat / phat_sh are c's row of the [l, k] table.
__device__ __forceinline__ uint32_t fast_floor_coeff(
    const uint32_t* __restrict__ src, int sp, int k, const uint32_t* __restrict__ q,
    const uint32_t* __restrict__ inv_phat, const uint32_t* __restrict__ inv_phat_sh,
    const uint32_t* __restrict__ phat, const uint32_t* __restrict__ phat_sh,
    uint32_t tx_c, uint32_t c, uint32_t iq, uint32_t iq_sh) {
  uint32_t conv = 0;
  for (int i = 0; i < k; ++i)
    fast_floor_step(src[i * sp], q[i], inv_phat[i], inv_phat_sh[i], phat[i], phat_sh[i], c,
                    conv);
  return fast_floor_close(tx_c, conv, c, iq, iq_sh);
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
// working row (read by the partner).
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
                  const uint32_t* __restrict__ n_inv_sh, int k, int logn) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  uint32_t* row = sm;                        // input row r, NTT form
  uint32_t* work = sm + fhe::padded(n);      // the sweeps' passes
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = rank / kRowSplit, h = rank % kRowSplit;
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
  // 1. SmMRq lift of row r into c_j, fused into the forward transform's
  // first pass: a group of coefficients at once, source prime by source
  // prime, so that a thread has a whole group's loads in flight
  const uint32_t qc = q_mod_c[j], qc_sh = q_mod_c_sh[j];
  const uint32_t imt = inv_mt_c[j], imt_sh = inv_mt_c_sh[j];
  const uint32_t* src = ab + r * ab_sc + b * ab_sb;
  const uint32_t* lp = lift_phat + j * k;
  const uint32_t* lp_sh = lift_phat_sh + j * k;
  auto lift = [&](auto& x, int base, int logs) {
    constexpr int G = sizeof(x) / sizeof(x[0]);
    uint32_t conv[G], lane[G];
#pragma unroll
    for (int g = 0; g < G; ++g) conv[g] = lane[g] = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t* si = src + i * ab_sp + base;
      const uint32_t qi = q[i], w = mt_inv_phat[i], w_sh = mt_inv_phat_sh[i];
      const uint32_t ph = lp[i], ph_sh = lp_sh[i], pm = phat_mt[i];
#pragma unroll
      for (int g = 0; g < G; ++g)
        sm_mrq_step(si[g << logs], qi, w, w_sh, ph, ph_sh, pm, c, conv[g], lane[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      x[g] = sm_mrq_close(conv[g], lane[g], inv_q_mt, c, qc, qc_sh, imt, imt_sh);
  };
  fhe::fwd_ntt_regs_split(work, split, sync, logn, c, psi + tab, psi_sh + tab, lift,
                          fhe::SmemStore{row});
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
    const uint32_t* x0 = cluster.map_shared_rank(row, 0 * kRowSplit + h);
    const uint32_t* x1 = cluster.map_shared_rank(row, 1 * kRowSplit + h);
    const uint32_t* y0 = cluster.map_shared_rank(row, 2 * kRowSplit + h);
    const uint32_t* y1 = cluster.map_shared_rank(row, 3 * kRowSplit + h);
    const uint32_t* pa = r == 0 ? x0 : x1;
    const uint32_t* pb = r == 0 ? y0 : y1;
    const int end = (h + 1) * (n / kRowSplit);
#pragma unroll 8
    for (int x = h * (n / kRowSplit) + threadIdx.x; x < end; x += blockDim.x) {
      const int e = fhe::padded_index(x);
      work[e] = r == 1 ? fhe::add_mod(fhe::mul_barrett(x0[e], y1[e], c, muj),
                                      fhe::mul_barrett(x1[e], y0[e], c, muj), c)
                       : fhe::mul_barrett(pa[e], pb[e], c, muj);
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
      constexpr int G = sizeof(x) / sizeof(x[0]);
      uint32_t conv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) conv[g] = 0;
      for (int i = 0; i < k; ++i) {
        const uint32_t* ti = tsrc + i * tx_sp + base;
        const uint32_t qi = q[i], w = floor_inv_phat[i], w_sh = floor_inv_phat_sh[i];
        const uint32_t ph = fp[i], ph_sh = fp_sh[i];
#pragma unroll
        for (int g = 0; g < G; ++g)
          fast_floor_step(ti[g << logs], qi, w, w_sh, ph, ph_sh, c, conv[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        dst[base + (g << logs)] = fast_floor_close(x[g], conv[g], c, iq, iq_sh);
    };
    fhe::inv_ntt_regs_split(work, split, sync, logn, c, ipsi + tab, ipsi_sh + tab, n_inv[j],
                            n_inv_sh[j], fhe::SmemLoad{work}, floored);
  } else {
    cluster.sync();      // the barrier inside the output rows' inverse
  }
  // the peers read this CTA's rows above: no CTA leaves (and frees its
  // shared memory) before all have
  cluster.sync();
}

// x: [l + 1, count] (aux rows, then the m_sk row), out: [k, count] in q.
// Thread (j, e) computes out[j, e].
__global__ void __launch_bounds__(256)
fast_bconv_sk_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ aux,
                     const uint32_t* __restrict__ inv_phat,
                     const uint32_t* __restrict__ inv_phat_sh,
                     const uint32_t* __restrict__ phat_q,
                     const uint32_t* __restrict__ phat_q_sh,
                     const uint32_t* __restrict__ phat_sk,
                     const uint32_t* __restrict__ phat_sk_sh,
                     const uint32_t* __restrict__ q, const uint32_t* __restrict__ b_mod_q,
                     const uint32_t* __restrict__ b_mod_q_sh, uint32_t m_sk,
                     uint32_t inv_b, uint32_t inv_b_sh, int l, int k, long long count) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= k * count) return;
  const int j = static_cast<int>(idx / count);
  const long long e = idx - j * count;
  const uint32_t qj = q[j];
  uint32_t conv_q = 0, conv_sk = 0;
  for (int i = 0; i < l; ++i) {
    const uint32_t y = fhe::mul_shoup(x[i * count + e], inv_phat[i], inv_phat_sh[i], aux[i]);
    conv_q = fhe::add_mod(conv_q, fhe::mul_shoup(y, phat_q[j * l + i],
                                                 phat_q_sh[j * l + i], qj), qj);
    conv_sk = fhe::add_mod(conv_sk, fhe::mul_shoup(y, phat_sk[i], phat_sk_sh[i], m_sk),
                           m_sk);
  }
  const uint32_t alpha =
      fhe::mul_shoup(fhe::sub_mod(conv_sk, x[l * count + e], m_sk), inv_b, inv_b_sh, m_sk);
  // centred alpha mod q_j: alpha itself, or q_j - (m_sk - alpha) when negative
  const uint32_t alpha_q = alpha <= (m_sk >> 1) ? alpha : qj - (m_sk - alpha);
  out[idx] = fhe::sub_mod(conv_q, fhe::mul_shoup(alpha_q, b_mod_q[j], b_mod_q_sh[j], qj),
                          qj);
}

// sm_mrq_fused.  x: [k, count] residues in q, out: [l, count] in the dst
// primes cp; block (e-block, j), thread e lifts element e into c_j.  The
// wrapper keeps k * count below 2^31 (32-bit offsets).
__global__ void __launch_bounds__(256)
sm_mrq_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              const uint32_t* __restrict__ q, const uint32_t* __restrict__ mt_inv_phat,
              const uint32_t* __restrict__ mt_inv_phat_sh,
              const uint32_t* __restrict__ phat, const uint32_t* __restrict__ phat_sh,
              const uint32_t* __restrict__ phat_mt, const uint32_t* __restrict__ cp,
              const uint32_t* __restrict__ q_mod_c, const uint32_t* __restrict__ q_mod_c_sh,
              const uint32_t* __restrict__ inv_mt_c,
              const uint32_t* __restrict__ inv_mt_c_sh, uint32_t inv_q_mt, int k,
              int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const int j = blockIdx.y;
  out[static_cast<size_t>(j) * count + e] =
      sm_mrq_coeff(x + e, count, k, q, mt_inv_phat, mt_inv_phat_sh, phat + j * k,
                   phat_sh + j * k, phat_mt, inv_q_mt, cp[j], q_mod_c[j], q_mod_c_sh[j],
                   inv_mt_c[j], inv_mt_c_sh[j]);
}

// fast_floor_fused.  txq: [k, count] residues of t*x in q, txb: [l, count] in
// the dst primes cp, out: [l, count]; block (e-block, j), thread e floors
// element e in c_j.
__global__ void __launch_bounds__(256)
fast_floor_kernel(const uint32_t* __restrict__ txq, const uint32_t* __restrict__ txb,
                  uint32_t* __restrict__ out, const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ inv_phat,
                  const uint32_t* __restrict__ inv_phat_sh,
                  const uint32_t* __restrict__ phat, const uint32_t* __restrict__ phat_sh,
                  const uint32_t* __restrict__ cp, const uint32_t* __restrict__ inv_q_c,
                  const uint32_t* __restrict__ inv_q_c_sh, int k, int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const int j = blockIdx.y;
  const size_t o = static_cast<size_t>(j) * count + e;
  out[o] = fast_floor_coeff(txq + e, count, k, q, inv_phat, inv_phat_sh, phat + j * k,
                            phat_sh + j * k, txb[o], cp[j], inv_q_c[j], inv_q_c_sh[j]);
}

constexpr int kConvThreads = 256;

}  // namespace

extern "C" {

// The launch geometry comes from the wrapper (ops/rns_cuda.py,
// bsk_branch_geometry): `threads` per CTA and `smem` bytes per CTA, at least
// the two padded rows the kernel uses.
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
                   int smem, void* stream) {
  if (logn <= fhe::kRegLog || smem < 2 * 4 * fhe::padded(1 << logn))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(bsk_branch_kernel);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(4 * kRowSplit, batch, kb), threads, smem, 4 * kRowSplit,
      static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(
      &cfg, bsk_branch_kernel, u(ab), ab_sp, ab_sc, ab_sb, u(txq), tx_sp, tx_sc, tx_sb,
      static_cast<uint32_t*>(out), u(q), u(mt_inv_phat),
      u(mt_inv_phat_sh), u(lift_phat), u(lift_phat_sh), u(phat_mt), u(q_mod_c),
      u(q_mod_c_sh), u(inv_mt_c), u(inv_mt_c_sh), inv_q_mt, u(floor_inv_phat),
      u(floor_inv_phat_sh), u(floor_phat), u(floor_phat_sh), u(inv_q_c), u(inv_q_c_sh),
      u(cp), u(mu), u(psi), u(psi_sh), u(ipsi), u(ipsi_sh), u(n_inv), u(n_inv_sh), k,
      logn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fhe_fast_bconv_sk(const void* x, void* out, const void* aux, const void* inv_phat,
                      const void* inv_phat_sh, const void* phat_q, const void* phat_q_sh,
                      const void* phat_sk, const void* phat_sk_sh, const void* q,
                      const void* b_mod_q, const void* b_mod_q_sh, uint32_t m_sk,
                      uint32_t inv_b, uint32_t inv_b_sh, int l, int k, long long count,
                      void* stream) {
  constexpr int kThreads = 256;
  const long long total = k * count;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  fast_bconv_sk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u(x), static_cast<uint32_t*>(out), u(aux), u(inv_phat), u(inv_phat_sh), u(phat_q),
      u(phat_q_sh), u(phat_sk), u(phat_sk_sh), u(q), u(b_mod_q), u(b_mod_q_sh), m_sk,
      inv_b, inv_b_sh, l, k, count);
  return static_cast<int>(cudaGetLastError());
}

int fhe_sm_mrq(const void* x, void* out, const void* q, const void* mt_inv_phat,
               const void* mt_inv_phat_sh, const void* phat, const void* phat_sh,
               const void* phat_mt, const void* cp, const void* q_mod_c,
               const void* q_mod_c_sh, const void* inv_mt_c, const void* inv_mt_c_sh,
               uint32_t inv_q_mt, int k, int l, int count, void* stream) {
  const dim3 grid((count + kConvThreads - 1) / kConvThreads, l);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  sm_mrq_kernel<<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u(x), static_cast<uint32_t*>(out), u(q), u(mt_inv_phat), u(mt_inv_phat_sh), u(phat),
      u(phat_sh), u(phat_mt), u(cp), u(q_mod_c), u(q_mod_c_sh), u(inv_mt_c),
      u(inv_mt_c_sh), inv_q_mt, k, count);
  return static_cast<int>(cudaGetLastError());
}

int fhe_fast_floor(const void* txq, const void* txb, void* out, const void* q,
                   const void* inv_phat, const void* inv_phat_sh, const void* phat,
                   const void* phat_sh, const void* cp, const void* inv_q_c,
                   const void* inv_q_c_sh, int k, int l, int count, void* stream) {
  const dim3 grid((count + kConvThreads - 1) / kConvThreads, l);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  fast_floor_kernel<<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u(txq), u(txb), static_cast<uint32_t*>(out), u(q), u(inv_phat), u(inv_phat_sh),
      u(phat), u(phat_sh), u(cp), u(inv_q_c), u(inv_q_c_sh), k, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
