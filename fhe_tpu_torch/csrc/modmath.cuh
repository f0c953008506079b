// Modular arithmetic on uint32 residues, and the in-shared-memory NTT sweeps
// that every kernel of the package shares.
//
// Counterpart of fhe_tpu/ops/modmath.py and of the stage sweeps in
// fhe_tpu/ops/ntt_pallas.py (_fwd_sweep / _inv_sweep).  Hopper multiplies
// 32x32 -> 64 natively (__umulhi, mul.wide.u32), so the 16-bit-limb emulation
// of the TPU path is gone.  Every helper returns a fully reduced residue, so
// results match the JAX package bit for bit.
//
// Integer instructions each helper issues per call, counted from its source
// below (a conditional subtract is compare, subtract and select: 3; a
// 32x32 -> 64 product is one IMAD.WIDE).  chip_smoke.py reads this block
// for the operation side of each kernel's bound, so keep it next to the
// helpers and change it with them:
//   OPS add_mod 4
//   OPS sub_mod 4
//   OPS mul_shoup 6
//   OPS reduce_shoup 5
//   OPS mul_barrett 11
//   OPS reduce_barrett 10
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace fhe {

constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

// Raise a kernel's dynamic shared-memory limit to `bytes` where that is above
// the 48 KB default.  `granted` is the calling kernel's record of what each
// device already allows (a function-local static), so the attribute is set
// once per kernel and device, and again only for a larger request.
inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              std::atomic<size_t> (&granted)[kMaxDevices]) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= granted[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev].store(bytes);
  return err;
}

// (a + b) mod p for a, b in [0, p), p < 2^31.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  uint32_t s = a + b;
  return s >= p ? s - p : s;
}

// (a - b) mod p for a, b in [0, p).
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// x * w mod p with the Shoup companion w_sh = floor(w * 2^32 / p).
// Valid for any x < 2^32 and any p < 2^31 (the encoder's t included):
// x*w - q*p lies in [0, 2p) < 2^32, so the low 32 bits are exact.
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
  uint32_t q = __umulhi(x, w_sh);
  uint32_t r = x * w - q * p;
  return r >= p ? r - p : r;
}

// x mod p for any x < 2^32 and p < 2^31; one_sh = floor(2^32 / p).
__device__ __forceinline__ uint32_t reduce_shoup(uint32_t x, uint32_t p,
                                                 uint32_t one_sh) {
  uint32_t q = __umulhi(x, one_sh);
  uint32_t r = x - q * p;
  return r >= p ? r - p : r;
}

// a * b mod p for a, b in [0, p), 2^29 < p < 2^30, mu = floor(2^61 / p).
// q_hat = floor(floor(ab / 2^29) * mu / 2^32) undershoots ab/p by < 2.5.
__device__ __forceinline__ uint32_t mul_barrett(uint32_t a, uint32_t b,
                                                uint32_t p, uint32_t mu) {
  uint64_t ab = static_cast<uint64_t>(a) * b;
  uint32_t s = static_cast<uint32_t>(ab >> 29);
  uint32_t r = static_cast<uint32_t>(ab) - __umulhi(s, mu) * p;
  uint32_t two_p = p + p;
  if (r >= two_p) r -= two_p;
  return r >= p ? r - p : r;
}

// x mod p for any x < 2^32, 2^29 < p < 2^30.
__device__ __forceinline__ uint32_t reduce_barrett(uint32_t x, uint32_t p,
                                                   uint32_t mu) {
  uint32_t r = x - __umulhi(x >> 29, mu) * p;
  uint32_t two_p = p + p;
  if (r >= two_p) r -= two_p;
  return r >= p ? r - p : r;
}

// Forward negacyclic NTT of the n = 2^logn residues at a[] (shared memory),
// in place: merged-psi Cooley-Tukey, natural order in, bit-reversed out.
// Stage m (m = 1, 2, ..., n/2) pairs j1 = 2*g*t + r with j2 = j1 + t,
// t = n / (2m), twiddle psi_br[m + g].  All threads of the block take part;
// the caller synchronises after filling a[], and the sweep synchronises
// after every stage, so a[] is complete when it returns.
__device__ __forceinline__ void fwd_ntt_smem(uint32_t* a, int logn, uint32_t p,
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ w_sh) {
  const int half = 1 << (logn - 1);
  for (int logt = logn - 1, m = 1; logt >= 0; --logt, m <<= 1) {
    const int t = 1 << logt;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int g = b >> logt;
      const int j1 = (g << (logt + 1)) | (b & (t - 1));
      const int j2 = j1 + t;
      const uint32_t u = a[j1];
      const uint32_t v = mul_shoup(a[j2], __ldg(w + m + g), __ldg(w_sh + m + g), p);
      a[j1] = add_mod(u, v, p);
      a[j2] = sub_mod(u, v, p);
    }
    __syncthreads();
  }
}

// Inverse: Gentleman-Sande stages m = n/2 .. 1, bit-reversed in, natural
// out, then the x n^-1 Shoup multiply.  Same synchronisation contract.
__device__ __forceinline__ void inv_ntt_smem(uint32_t* a, int logn, uint32_t p,
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ w_sh,
                                             uint32_t n_inv, uint32_t n_inv_sh) {
  const int n = 1 << logn;
  const int half = n >> 1;
  for (int logt = 0, m = half; m >= 1; ++logt, m >>= 1) {
    const int t = 1 << logt;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int g = b >> logt;
      const int j1 = (g << (logt + 1)) | (b & (t - 1));
      const int j2 = j1 + t;
      const uint32_t u = a[j1];
      const uint32_t v = a[j2];
      a[j1] = add_mod(u, v, p);
      a[j2] = mul_shoup(sub_mod(u, v, p), __ldg(w + m + g), __ldg(w_sh + m + g), p);
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) a[j] = mul_shoup(a[j], n_inv, n_inv_sh, p);
  __syncthreads();
}

// Threads per block for one n-point transform: one butterfly per thread and
// stage up to the 1024-thread limit.
inline int ntt_threads(int logn) {
  const int half = 1 << (logn - 1);
  return half < 1024 ? half : 1024;
}

}  // namespace fhe
