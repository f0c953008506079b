// Whole-polynomial negacyclic NTT kernels for Hopper (sm_90a).
//
// Replaces fhe_tpu/ops/ntt_pallas.py: ntt_forward, ntt_inverse,
// mul_by_ntt_operand and mul_by_ntt_operand_batch, tensor_product and
// tensor_product_batch, keyswitch_fused and keyswitch_fused_batch (both
// lanes), ks_inner_batch and ks_inner_grouped.  Plain versions:
// fhe_tpu_torch/ops/ntt.py.
//
// Each single function and its _batch form share one kernel: grid
// (B, primes), block (b, i) does element b on prime i, and the single
// function launches B = 1.  Inputs are read through the strides the wrapper
// passes, so a [B, k, c, n] stack of ciphertexts is read in place, not
// transposed; outputs are [k, c, B, n].  The Pallas batch tiles, padding
// and lazy sweeps are Mosaic artifacts and have no counterpart here.
//
// Design.  One block per (prime, polynomial) holds the whole n-point
// polynomial in shared memory (32 KB at n = 8192) and runs all log2(n)
// radix-2 stages with a __syncthreads() between them.  Twiddles come straight
// from the compact psi_br [k, n] table and its Shoup companions: stage m reads
// entry m + j / (2t).  The Pallas kernels' [k, log2(n), n] stage-expanded
// tables exist only because Mosaic cannot index a lane by stage; a GPU thread
// can, so they are not ported (13x less table memory at n = 8192).
//
// What bounds it on the H100.  At n = 8192, k = 3 one batch row moves
// 96 KB of residues in and 96 KB out, plus 192 KB of twiddles and their
// Shoup companions, and does 3 * 13 * 4096 butterflies of about 12 integer
// operations each: about 0.12 us by memory rate and about 0.1 us by the
// integer issue rate.  Neither is what limits it: 13 dependent stages each
// end in a block-wide barrier, and at the slice's shapes only k * B = 3 .. 48
// blocks run on 132 SMs, so the kernels are launch- and latency-bound
// (measured times: PERF.md).  The design answers with the fewest launches:
// one launch for the whole [k, B, n] batch, and mul_by_ntt_operand keeps NTT(u) in shared
// memory across all c operand rows, so the encrypt product is one launch in
// place of three.  Register-resident radix-16 stages and warp shuffles,
// which cut the barrier count, are later work.
//
// tensor_product and keyswitch_fused (the ciphertext multiply and the
// relinearization) follow the same plan: one block per prime keeps every
// polynomial of the step in shared memory from the first forward stage to
// the last inverse one, and transforms its rows together, so one barrier per
// stage serves 4 (tensor product) or 2 (key-switch accumulators) rows.  At
// n = 8192, k = 3 they run on 3 blocks, one per SM, and are bound by the
// issue rate of those SMs rather than by the barriers (bounds and times:
// PERF.md).  The batch axis is the answer to that at serving batches: B = 8
// runs 24 blocks on 24 SMs, each doing the single function's work.
//
// ks_inner_batch and ks_inner_grouped (the hoisted rotations) are the back
// half of the key switch: their digits arrive already transformed, so a
// block (b, i) only forms the two sums sum_j dg_j . key_j, one coefficient
// per thread in registers with no barrier between digits, and runs the
// two-row inverse sweep.  The digits and the keys are read through strides
// and two index maps (digit stack b / dg_div, key set b % key_mod), so a
// digit stack shared by all elements, or by the E elements of one
// ciphertext, is read in place and never repeated in memory, nor are the
// keys tiled.  A block reads kd digit rows and 2 kd key rows and runs 13
// inverse stages on 2 rows; like the key switch it is bound by the issue
// rate of the k * B SMs it runs on (bound and times: PERF.md).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "modmath.cuh"

namespace {

// x, y: [k, batch, n]; block (b, i) transforms row (i, b) with prime i.
__global__ void __launch_bounds__(1024)
ntt_forward_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ p, const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_sh, int batch, int logn) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int i = blockIdx.y;
  const size_t row = (static_cast<size_t>(i) * batch + blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) a[j] = x[row + j];
  __syncthreads();
  fhe::fwd_ntt_smem(a, logn, p[i], psi + static_cast<size_t>(i) * n,
                    psi_sh + static_cast<size_t>(i) * n);
  for (int j = threadIdx.x; j < n; j += blockDim.x) y[row + j] = a[j];
}

__global__ void __launch_bounds__(1024)
ntt_inverse_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ p, const uint32_t* __restrict__ ipsi,
                   const uint32_t* __restrict__ ipsi_sh,
                   const uint32_t* __restrict__ n_inv,
                   const uint32_t* __restrict__ n_inv_sh, int batch, int logn) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int i = blockIdx.y;
  const size_t row = (static_cast<size_t>(i) * batch + blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) a[j] = x[row + j];
  __syncthreads();
  fhe::inv_ntt_smem(a, logn, p[i], ipsi + static_cast<size_t>(i) * n,
                    ipsi_sh + static_cast<size_t>(i) * n, n_inv[i], n_inv_sh[i]);
  for (int j = threadIdx.x; j < n; j += blockDim.x) y[row + j] = a[j];
}

// Block (b, i): out[i, c, b] = INTT(NTT(u[i, b]) . w[i, c]) for c = 0 .. num_c-1.
// Row (i, b) of u starts at u + i * u_sp + b * u_sb, so a view of one
// ciphertext component, or the rows of a stack, is read in place; w is the
// shared [k, num_c, n] operand; out is [k, num_c, B, n] (B = gridDim.x, 1 for
// the single function).  Shared memory: NTT(u) (kept for every c) and one
// working polynomial.
__global__ void __launch_bounds__(1024)
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
  const int n = 1 << logn;
  uint32_t* un = sm;
  uint32_t* a = sm + n;
  const int i = blockIdx.y;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const uint32_t* ur = u + i * u_sp + b * u_sb;
  for (int j = threadIdx.x; j < n; j += blockDim.x) un[j] = ur[j];
  __syncthreads();
  fhe::fwd_ntt_smem(un, logn, pi, psi + tab, psi_sh + tab);
  for (int c = 0; c < num_c; ++c) {
    const size_t row = (static_cast<size_t>(i) * num_c + c) * n;
    const size_t orow = ((static_cast<size_t>(i) * num_c + c) * batch + b) * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      a[j] = fhe::mul_barrett(un[j], w[row + j], pi, mui);
    __syncthreads();
    fhe::inv_ntt_smem(a, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i]);
    for (int j = threadIdx.x; j < n; j += blockDim.x) out[orow + j] = a[j];
    __syncthreads();
  }
}

// Block (b, i): out[i, :, b] = INTT(c0, c1, c2) with (c0, c1, c2) the tensor
// product of NTT(x[i, :, b]) and NTT(y[i, :, b]).  Element (i, c, b, j) of x
// and of y sits at i * s_p + c * s_c + b * s_b + j, so the [k, 2, B, n] halves
// may be views of a [B, k, 4, n] stack, read in place; out is [k, 3, B, n]
// (B = gridDim.x, 1 for the single function).  With the multiply's tables
// n_inv is t * n^-1, so the scale by t costs nothing.  Shared memory: the
// four input rows (4 * 32 KB at n = 8192).
__global__ void __launch_bounds__(1024)
tensor_product_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                      long long s_p, long long s_c, long long s_b,
                      uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                      const uint32_t* __restrict__ mu, const uint32_t* __restrict__ psi,
                      const uint32_t* __restrict__ psi_sh,
                      const uint32_t* __restrict__ ipsi,
                      const uint32_t* __restrict__ ipsi_sh,
                      const uint32_t* __restrict__ n_inv,
                      const uint32_t* __restrict__ n_inv_sh, int logn) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn;
  const int i = blockIdx.y;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const uint32_t pi = p[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const long long in = i * s_p + b * s_b;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sm[j] = x[in + j];
    sm[n + j] = x[in + s_c + j];
    sm[2 * n + j] = y[in + j];
    sm[3 * n + j] = y[in + s_c + j];
  }
  __syncthreads();
  fhe::fwd_ntt_smem<4>(sm, logn, pi, psi + tab, psi_sh + tab);
  fhe::tensor_product_smem(sm, logn, pi, mu[i]);
  fhe::inv_ntt_smem<3>(sm, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i]);
  // element c * n + j stays with thread j mod blockDim.x, as the inverse left it
  for (int c = 0; c < 3; ++c) {
    const size_t orow = ((static_cast<size_t>(i) * 3 + c) * batch + b) * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) out[orow + j] = sm[c * n + j];
  }
}

// Key-switch inner product, block (b, i) for element b and prime p_i:
//   out[i, c, b] = INTT( sum_j NTT([d_j,b]_{p_i}) . key[i, j, c] ),  c = 0, 1.
// Digit j of element b for prime i is the row at d + i * d_sp + j * d_sj +
// b * d_sb.  Without PREREDUCED it is a residue mod its own q_j (< 2^30), the
// same row for every prime (d_sp = 0), so it is reduced mod p_i first:
// mul_barrett is exact only below p.  With PREREDUCED (grouped gadget
// digits, ks_omega > 1) the rows are per-prime residues, already below p_i,
// and are used as they are.  Key element (i, j, c, x) sits at
// keys[i * key_prime_stride + j * key_digit_stride + c * n + x], so the
// stored [digit, prime, 2, n] keys are read in place and shared by all B
// elements.  The digits go through one working row in turn; the two sums
// live in shared memory (3 * 32 KB at n = 8192).  Mod-add is exact, so the
// sequential sum equals the reference's add tree bit for bit.  out:
// [k, 2, B, n] (B = gridDim.x, 1 for the single function).
template <bool PREREDUCED>
__global__ void __launch_bounds__(1024)
keyswitch_kernel(const uint32_t* __restrict__ d, long long d_sp, long long d_sj,
                 long long d_sb, const uint32_t* __restrict__ keys,
                 long long key_prime_stride,
                 long long key_digit_stride, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ p, const uint32_t* __restrict__ mu,
                 const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                 const uint32_t* __restrict__ ipsi, const uint32_t* __restrict__ ipsi_sh,
                 const uint32_t* __restrict__ n_inv,
                 const uint32_t* __restrict__ n_inv_sh, int kd, int logn) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn;
  uint32_t* a = sm;
  uint32_t* acc = sm + n;
  const int i = blockIdx.y;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  for (int j = 0; j < kd; ++j) {
    const uint32_t* dr = d + i * d_sp + j * d_sj + b * d_sb;
    for (int x = threadIdx.x; x < n; x += blockDim.x)
      a[x] = PREREDUCED ? dr[x] : fhe::reduce_barrett(dr[x], pi, mui);
    __syncthreads();
    fhe::fwd_ntt_smem(a, logn, pi, psi + tab, psi_sh + tab);
    const uint32_t* key = keys + i * key_prime_stride + j * key_digit_stride;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const uint32_t t0 = fhe::mul_barrett(a[x], key[x], pi, mui);
      const uint32_t t1 = fhe::mul_barrett(a[x], key[n + x], pi, mui);
      acc[x] = j == 0 ? t0 : fhe::add_mod(acc[x], t0, pi);
      acc[n + x] = j == 0 ? t1 : fhe::add_mod(acc[n + x], t1, pi);
    }
    __syncthreads();
  }
  fhe::inv_ntt_smem<2>(acc, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i]);
  // element c * n + x stays with thread x mod blockDim.x, as the inverse left it
  for (int c = 0; c < 2; ++c) {
    const size_t orow = ((static_cast<size_t>(i) * 2 + c) * batch + b) * n;
    for (int x = threadIdx.x; x < n; x += blockDim.x) out[orow + x] = acc[c * n + x];
  }
}

// Hoisted key-switch inner product, block (b, i) for element b and prime p_i:
//   out[i, c, b] = INTT( sum_j dg[i, j, b / dg_div] . keys[i, j, b % key_mod, c] )
// for c = 0, 1.  The digits are NTT-domain residues mod p_i: row (i, j, s)
// at dg + i * dg_sp + j * dg_sj + s * dg_sb (dg_sb = 0 for one stack shared
// by every element).  Key element (i, j, e, c, x) at keys + i * key_sp +
// j * key_sj + e * key_se + c * n + x.  ks_inner_batch passes dg_div = 1 and
// key_mod = B; ks_inner_grouped, element b = s * E + e, dg_div = key_mod = E.
// Each thread sums its own coefficients in registers and writes the two
// accumulator rows (2 * 32 KB at n = 8192) once; the one barrier before the
// inverse sweep is the only one outside it.  out: [k, 2, B, n].
__global__ void __launch_bounds__(1024)
ks_inner_kernel(const uint32_t* __restrict__ dg, long long dg_sp, long long dg_sj,
                long long dg_sb, int dg_div, const uint32_t* __restrict__ keys,
                long long key_sp, long long key_sj, long long key_se, int key_mod,
                uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                const uint32_t* __restrict__ mu, const uint32_t* __restrict__ ipsi,
                const uint32_t* __restrict__ ipsi_sh, const uint32_t* __restrict__ n_inv,
                const uint32_t* __restrict__ n_inv_sh, int kd, int logn) {
  extern __shared__ uint32_t acc[];
  const int n = 1 << logn;
  const int i = blockIdx.y;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  const uint32_t* dgb = dg + i * dg_sp + (b / dg_div) * dg_sb;
  const uint32_t* kb = keys + i * key_sp + (b % key_mod) * key_se;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    uint32_t s0 = 0, s1 = 0;
    for (int j = 0; j < kd; ++j) {
      const uint32_t f = dgb[j * dg_sj + x];
      const uint32_t* key = kb + j * key_sj;
      s0 = fhe::add_mod(s0, fhe::mul_barrett(f, key[x], pi, mui), pi);
      s1 = fhe::add_mod(s1, fhe::mul_barrett(f, key[n + x], pi, mui), pi);
    }
    acc[x] = s0;
    acc[n + x] = s1;
  }
  __syncthreads();
  fhe::inv_ntt_smem<2>(acc, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i]);
  // element c * n + x stays with thread x mod blockDim.x, as the inverse left it
  for (int c = 0; c < 2; ++c) {
    const size_t orow = ((static_cast<size_t>(i) * 2 + c) * batch + b) * n;
    for (int x = threadIdx.x; x < n; x += blockDim.x) out[orow + x] = acc[c * n + x];
  }
}

template <bool PREREDUCED>
cudaError_t launch_keyswitch(const void* d, long long d_sp, long long d_sj, long long d_sb,
                             const void* keys, long long key_prime_stride,
                             long long key_digit_stride, void* out, const void* p,
                             const void* mu, const void* psi, const void* psi_sh,
                             const void* ipsi, const void* ipsi_sh, const void* n_inv,
                             const void* n_inv_sh, int k, int kd, int batch, int logn,
                             cudaStream_t stream) {
  const size_t smem = 3 * (sizeof(uint32_t) << logn);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(keyswitch_kernel<PREREDUCED>), smem, granted);
  if (err != cudaSuccess) return err;
  keyswitch_kernel<PREREDUCED><<<dim3(batch, k), fhe::ntt_threads(logn), smem, stream>>>(
      static_cast<const uint32_t*>(d), d_sp, d_sj, d_sb, static_cast<const uint32_t*>(keys),
      key_prime_stride, key_digit_stride, static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(mu),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_sh),
      static_cast<const uint32_t*>(ipsi), static_cast<const uint32_t*>(ipsi_sh),
      static_cast<const uint32_t*>(n_inv), static_cast<const uint32_t*>(n_inv_sh), kd,
      logn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fhe_ntt_forward(const void* x, void* y, const void* p, const void* psi,
                    const void* psi_sh, int k, int batch, int logn, void* stream) {
  const size_t smem = sizeof(uint32_t) << logn;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(ntt_forward_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_forward_kernel<<<dim3(batch, k), fhe::ntt_threads(logn), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_sh), batch, logn);
  return static_cast<int>(cudaGetLastError());
}

int fhe_ntt_inverse(const void* x, void* y, const void* p, const void* ipsi,
                    const void* ipsi_sh, const void* n_inv, const void* n_inv_sh,
                    int k, int batch, int logn, void* stream) {
  const size_t smem = sizeof(uint32_t) << logn;
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(ntt_inverse_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inverse_kernel<<<dim3(batch, k), fhe::ntt_threads(logn), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(ipsi),
      static_cast<const uint32_t*>(ipsi_sh), static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_sh), batch, logn);
  return static_cast<int>(cudaGetLastError());
}

int fhe_mul_by_ntt_operand(const void* u, long long u_sp, long long u_sb, const void* w,
                           void* out, const void* p, const void* mu, const void* psi,
                           const void* psi_sh, const void* ipsi, const void* ipsi_sh,
                           const void* n_inv, const void* n_inv_sh, int k, int num_c,
                           int batch, int logn, void* stream) {
  const size_t smem = 2 * (sizeof(uint32_t) << logn);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(mul_by_ntt_operand_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  mul_by_ntt_operand_kernel<<<dim3(batch, k), fhe::ntt_threads(logn), smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(u), u_sp, u_sb, static_cast<const uint32_t*>(w),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(mu), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_sh), static_cast<const uint32_t*>(ipsi),
      static_cast<const uint32_t*>(ipsi_sh), static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_sh), num_c, logn);
  return static_cast<int>(cudaGetLastError());
}

int fhe_tensor_product(const void* x, const void* y, long long s_p, long long s_c,
                       long long s_b, void* out, const void* p, const void* mu,
                       const void* psi, const void* psi_sh, const void* ipsi,
                       const void* ipsi_sh, const void* n_inv, const void* n_inv_sh, int k,
                       int batch, int logn, void* stream) {
  const size_t smem = 4 * (sizeof(uint32_t) << logn);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(tensor_product_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  tensor_product_kernel<<<dim3(batch, k), fhe::ntt_threads(logn), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y), s_p, s_c, s_b,
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(mu), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_sh), static_cast<const uint32_t*>(ipsi),
      static_cast<const uint32_t*>(ipsi_sh), static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_sh), logn);
  return static_cast<int>(cudaGetLastError());
}

int fhe_keyswitch(const void* d, long long d_sp, long long d_sj, long long d_sb,
                  const void* keys, long long key_prime_stride, long long key_digit_stride,
                  void* out, const void* p, const void* mu, const void* psi,
                  const void* psi_sh, const void* ipsi, const void* ipsi_sh,
                  const void* n_inv, const void* n_inv_sh, int k, int kd, int batch,
                  int logn, int prereduced, void* stream) {
  auto* launch = prereduced ? &launch_keyswitch<true> : &launch_keyswitch<false>;
  return static_cast<int>(launch(d, d_sp, d_sj, d_sb, keys, key_prime_stride,
                                 key_digit_stride, out, p, mu, psi, psi_sh, ipsi, ipsi_sh,
                                 n_inv, n_inv_sh, k, kd, batch, logn,
                                 static_cast<cudaStream_t>(stream)));
}

int fhe_ks_inner(const void* dg, long long dg_sp, long long dg_sj, long long dg_sb,
                 int dg_div, const void* keys, long long key_sp, long long key_sj,
                 long long key_se, int key_mod, void* out, const void* p, const void* mu,
                 const void* ipsi, const void* ipsi_sh, const void* n_inv,
                 const void* n_inv_sh, int k, int kd, int batch, int logn, void* stream) {
  const size_t smem = 2 * (sizeof(uint32_t) << logn);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(ks_inner_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  ks_inner_kernel<<<dim3(batch, k), fhe::ntt_threads(logn), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dg), dg_sp, dg_sj, dg_sb, dg_div,
      static_cast<const uint32_t*>(keys), key_sp, key_sj, key_se, key_mod,
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(mu), static_cast<const uint32_t*>(ipsi),
      static_cast<const uint32_t*>(ipsi_sh), static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_sh), kd, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
