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
// bsk_branch_fused, block (b, j) for element b and Bsk prime c_j (shared
// memory: 4 * 32 KB at n = 8192; B = 1 for the single multiply, the batch
// size for multiply_batch):
//   1. SmMRq lift of the four rows a0, a1, b0, b1 from q into c_j: digits
//      y_i = [x_i * m~ * (q/q_i)^-1]_{q_i}, conv = sum_i y_i * (q/q_i) mod c_j
//      and the m~ = 2^16 lane sum_i (y_i & 0xFFFF) * (q/q_i) mod 2^16; alpha =
//      lane * q^-1 mod 2^16, centred; lift = (conv - alpha*q) * m~^-1 mod c_j;
//   2. forward NTT of the four rows, tensor product, inverse NTT of three
//      rows with t * n^-1 (the Bsk half of the multiply's tables);
//   3. FastFloor: (tx_bsk - conv(tx_q)) * q^-1 mod c_j, with tx_q [k, 3, n]
//      the t-scaled q-side product, its digits converted to c_j.
// The lift and the Bsk product never leave shared memory.  The TPU grid ran
// the Bsk primes in order on one core; here they are kb independent blocks.
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
// 480 KB: about 0.5 us by memory rate, and about 10 M integer instructions
// per block, 49 M in all: about 3 us at the whole card's issue rate.  It
// runs on 5 blocks, one per SM, so what bounds it is the issue rate of
// those 5 SMs (about half of it is reached; times: PERF.md).  The batch axis
// of multiply_batch gives kb * B blocks (40 at B = 8), each doing one
// element's work on its own SM.
// fast_bconv_sk_fused moves 480 KB + 288 KB and runs 74 K threads: it is
// bound by launch latency.  So are sm_mrq_fused and fast_floor_fused: at
// n = 8192, k = 3, kb = 5 the lift of the four rows reads 393 KB and writes
// 655 KB (0.3 us by memory rate, about 1 us by the issue rate) in 164 K
// threads, and the n = 256 multiply that runs them gives them 7 K or fewer.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "modmath.cuh"

namespace {

constexpr uint32_t kMask16 = 0xFFFFu;

// SmMRq centred lift of one coefficient into the destination prime c
// (bsk_branch_fused step 1, sm_mrq_fused): its residue mod q_i is
// src[i * sp], i < k; phat / phat_sh are c's row of the [l, k] (q/q_i) mod c
// table; qc, imt: q mod c and m~^-1 mod c with their Shoup companions.
// Digits y_i = [x_i * m~ * (q/q_i)^-1]_{q_i}; conv = sum_i y_i * (q/q_i) mod c
// and the m~ = 2^16 lane sum_i (y_i & 0xFFFF) * (q/q_i) mod 2^16; alpha =
// lane * q^-1 mod 2^16, centred; the lift is (conv - alpha*q) * m~^-1 mod c.
__device__ __forceinline__ uint32_t sm_mrq_coeff(
    const uint32_t* __restrict__ src, int sp, int k, const uint32_t* __restrict__ q,
    const uint32_t* __restrict__ mt_inv_phat, const uint32_t* __restrict__ mt_inv_phat_sh,
    const uint32_t* __restrict__ phat, const uint32_t* __restrict__ phat_sh,
    const uint32_t* __restrict__ phat_mt, uint32_t inv_q_mt, uint32_t c, uint32_t qc,
    uint32_t qc_sh, uint32_t imt, uint32_t imt_sh) {
  uint32_t conv = 0, lane = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t y = fhe::mul_shoup(src[i * sp], mt_inv_phat[i], mt_inv_phat_sh[i], q[i]);
    conv = fhe::add_mod(conv, fhe::mul_shoup(y, phat[i], phat_sh[i], c), c);
    lane = (lane + (y & kMask16) * phat_mt[i]) & kMask16;
  }
  const uint32_t alpha = (lane * inv_q_mt) & kMask16;
  const uint32_t alpha_c = alpha < (1u << 15) ? alpha : c - ((1u << 16) - alpha);
  const uint32_t centred = fhe::sub_mod(conv, fhe::mul_shoup(alpha_c, qc, qc_sh, c), c);
  return fhe::mul_shoup(centred, imt, imt_sh, c);
}

// FastFloor of one coefficient in the destination prime c (bsk_branch_fused
// step 3, fast_floor_fused): the residues of t*x mod q_i are src[i * sp],
// i < k, and tx_c its residue mod c; phat / phat_sh are c's row of the
// [l, k] table; iq = q^-1 mod c.  (tx_c - conv(t*x)) * q^-1 mod c.
__device__ __forceinline__ uint32_t fast_floor_coeff(
    const uint32_t* __restrict__ src, int sp, int k, const uint32_t* __restrict__ q,
    const uint32_t* __restrict__ inv_phat, const uint32_t* __restrict__ inv_phat_sh,
    const uint32_t* __restrict__ phat, const uint32_t* __restrict__ phat_sh,
    uint32_t tx_c, uint32_t c, uint32_t iq, uint32_t iq_sh) {
  uint32_t conv = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t y = fhe::mul_shoup(src[i * sp], inv_phat[i], inv_phat_sh[i], q[i]);
    conv = fhe::add_mod(conv, fhe::mul_shoup(y, phat[i], phat_sh[i], c), c);
  }
  return fhe::mul_shoup(fhe::sub_mod(tx_c, conv, c), iq, iq_sh, c);
}

// ab: [k, 4, B, n] (a0, a1, b0, b1 in q), element (i, c, b, x) at
// i * ab_sp + c * ab_sc + b * ab_sb + x; txq: [k, 3, B, n] with its own
// strides; so both may be views of per-ciphertext stacks, read in place.
// The strides are 32-bit (the wrapper checks that every offset fits): 64-bit
// index products in the lift and floor loops cost the single kernel 2 %.
// out: [kb, 3, B, n], B = gridDim.x.  Per-prime constant arrays follow
// ops/rns.py (SmMRqConsts, FastFloorConsts); [kb, k] tables are row-major by
// destination prime.
__global__ void __launch_bounds__(1024)
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
  const int n = 1 << logn;
  const int j = blockIdx.y;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const uint32_t c = cp[j];
  const size_t tab = static_cast<size_t>(j) * n;
  // 1. SmMRq lift of the four rows into c_j
  const uint32_t qc = q_mod_c[j], qc_sh = q_mod_c_sh[j];
  const uint32_t imt = inv_mt_c[j], imt_sh = inv_mt_c_sh[j];
  // row by row, so that each row's base address is formed once; element
  // row * n + x stays with thread x mod blockDim.x, as in the sweeps
  for (int row = 0; row < 4; ++row) {
    const uint32_t* src = ab + row * ab_sc + b * ab_sb;
    for (int x = threadIdx.x; x < n; x += blockDim.x)
      sm[row * n + x] = sm_mrq_coeff(src + x, ab_sp, k, q, mt_inv_phat, mt_inv_phat_sh,
                                     lift_phat + j * k, lift_phat_sh + j * k, phat_mt,
                                     inv_q_mt, c, qc, qc_sh, imt, imt_sh);
  }
  __syncthreads();
  // 2. tensor product at c_j, t folded into the inverse normalisation
  fhe::fwd_ntt_smem<4>(sm, logn, c, psi + tab, psi_sh + tab);
  fhe::tensor_product_smem(sm, logn, c, mu[j]);
  fhe::inv_ntt_smem<3>(sm, logn, c, ipsi + tab, ipsi_sh + tab, n_inv[j], n_inv_sh[j]);
  // 3. FastFloor against the q-side product
  const uint32_t iq = inv_q_c[j], iq_sh = inv_q_c_sh[j];
  for (int row = 0; row < 3; ++row) {
    const uint32_t* src = txq + row * tx_sc + b * tx_sb;
    uint32_t* dst = out + ((static_cast<size_t>(j) * 3 + row) * batch + b) * n;
    for (int x = threadIdx.x; x < n; x += blockDim.x)
      dst[x] = fast_floor_coeff(src + x, tx_sp, k, q, floor_inv_phat, floor_inv_phat_sh,
                                floor_phat + j * k, floor_phat_sh + j * k,
                                sm[row * n + x], c, iq, iq_sh);
  }
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
                   const void* n_inv_sh, int k, int kb, int batch, int logn,
                   void* stream) {
  const size_t smem = 4 * (sizeof(uint32_t) << logn);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  const cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(bsk_branch_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  bsk_branch_kernel<<<dim3(batch, kb), fhe::ntt_threads(logn), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      u(ab), ab_sp, ab_sc, ab_sb, u(txq), tx_sp, tx_sc, tx_sb,
      static_cast<uint32_t*>(out), u(q), u(mt_inv_phat),
      u(mt_inv_phat_sh), u(lift_phat), u(lift_phat_sh), u(phat_mt), u(q_mod_c),
      u(q_mod_c_sh), u(inv_mt_c), u(inv_mt_c_sh), inv_q_mt, u(floor_inv_phat),
      u(floor_inv_phat_sh), u(floor_phat), u(floor_phat_sh), u(inv_q_c), u(inv_q_c_sh),
      u(cp), u(mu), u(psi), u(psi_sh), u(ipsi), u(ipsi_sh), u(n_inv), u(n_inv_sh), k,
      logn);
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
