// Whole-polynomial negacyclic NTT kernels for Hopper (sm_90a).
//
// Replaces fhe_tpu/ops/ntt_pallas.py: ntt_forward, ntt_inverse and
// mul_by_ntt_operand.  Plain versions: fhe_tpu_torch/ops/ntt.py.
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

// out[i, c] = INTT(NTT(u[i]) . w[i, c]) for c = 0 .. num_c-1; block i per prime.
// Shared memory: NTT(u) (kept for every c) and one working polynomial.
__global__ void __launch_bounds__(1024)
mul_by_ntt_operand_kernel(const uint32_t* __restrict__ u,
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
  const int i = blockIdx.x;
  const uint32_t pi = p[i];
  const uint32_t mui = mu[i];
  const size_t tab = static_cast<size_t>(i) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) un[j] = u[tab + j];
  __syncthreads();
  fhe::fwd_ntt_smem(un, logn, pi, psi + tab, psi_sh + tab);
  for (int c = 0; c < num_c; ++c) {
    const size_t row = (static_cast<size_t>(i) * num_c + c) * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      a[j] = fhe::mul_barrett(un[j], w[row + j], pi, mui);
    __syncthreads();
    fhe::inv_ntt_smem(a, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i]);
    for (int j = threadIdx.x; j < n; j += blockDim.x) out[row + j] = a[j];
    __syncthreads();
  }
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

int fhe_mul_by_ntt_operand(const void* u, const void* w, void* out, const void* p,
                           const void* mu, const void* psi, const void* psi_sh,
                           const void* ipsi, const void* ipsi_sh, const void* n_inv,
                           const void* n_inv_sh, int k, int num_c, int logn,
                           void* stream) {
  const size_t smem = 2 * (sizeof(uint32_t) << logn);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(mul_by_ntt_operand_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  mul_by_ntt_operand_kernel<<<k, fhe::ntt_threads(logn), smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(u), static_cast<const uint32_t*>(w),
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(mu), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_sh), static_cast<const uint32_t*>(ipsi),
      static_cast<const uint32_t*>(ipsi_sh), static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_sh), num_c, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
