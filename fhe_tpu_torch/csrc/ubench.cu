// Modmul roofline probe for Hopper (sm_90a).
//
// Replaces fhe_tpu/utils/ubench.py: modmul_chain (body _chain_kernel).  Plain
// version: fhe_tpu_torch/utils/ubench.py (modmul_chain_plain, an int64
// emulation of the same uint32 arithmetic).
//
// Each element of a [rows, n] block goes through `reps` dependent modular
// products by one constant (w, w_sh), p, mu.  One thread per element keeps its
// chain in registers: no shared memory and no traffic that grows with reps,
// so the slope of the time over reps is the issue rate of the step (the TPU
// kernel kept the block in VMEM for the same reason).  reps is a runtime
// argument, so nvcc cannot fold the chain; the loop over it is unrolled by
// UNROLL (1 or 8), and ILP (1, 2 or 4) independent chains per element, seeded
// x, x + 1, ..., step in program order and are XOR-folded at the end, as the
// TPU kernel does.  The steps, each exactly the JAX package's:
//   exact    mul_shoup                      (OPS mul_shoup in modmath.cuh)
//   lazy     mul_shoup_lazy, out in [0, 2p)  (OPS mul_shoup_lazy)
//   barrett  mul_barrett                    (OPS mul_barrett)
//   cheap17  17 adds, shifts and masks shaped like the lazy product
//   mul17    16 squarings and one multiply by w: 17 multiplies
// All arithmetic wraps mod 2^32 as uint32 does in JAX.  cheap17 and mul17
// measure the card's add/logic and integer-multiply issue rates, which check
// the integer peak the other kernels' bounds divide by.
//
// What bounds it: operations, by design.  At [256, 8192] and reps = 64 the
// exact chain issues 2 M x 64 x 6 = 805 M integer instructions (24 us at the
// 33.4 T op/s of the two integer pipes, multiplies and adds) against 16 MB
// of memory traffic (5 us at 3.35 TB/s).

#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace {

enum Variant { kExact = 0, kLazy = 1, kBarrett = 2, kCheap17 = 3, kMul17 = 4 };

template <int VARIANT>
__device__ __forceinline__ uint32_t chain_step(uint32_t v, uint32_t w, uint32_t w_sh,
                                               uint32_t p, uint32_t mu) {
  if constexpr (VARIANT == kExact) {
    return fhe::mul_shoup(v, w, w_sh, p);
  } else if constexpr (VARIANT == kLazy) {
    return fhe::mul_shoup_lazy(v, w, w_sh, p);
  } else if constexpr (VARIANT == kBarrett) {
    return fhe::mul_barrett(v, w, p, mu);
  } else if constexpr (VARIANT == kCheap17) {
    // the lazy product's op count and dependency shape, every multiply an add
    const uint32_t a0 = v & 0xFFFFu, a1 = v >> 16;
    const uint32_t ll = a0 + w, lh = a0 + w_sh, hl = a1 + w, hh = a1 + w_sh;
    const uint32_t mid = lh + (ll >> 16);
    const uint32_t mid2 = hl + (mid & 0xFFFFu);
    const uint32_t hi = hh + (mid >> 16) + (mid2 >> 16);
    return (v + w) - (hi + p);
  } else {
    // squarings, not products by a constant, which would fold into one
#pragma unroll
    for (int i = 0; i < 16; ++i) v = v * v;
    return v * w;
  }
}

// x, out: [count]; thread e runs element e's ILP chains.
template <int VARIANT, int ILP, int UNROLL>
__global__ void __launch_bounds__(256)
modmul_chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int count,
                    uint32_t w, uint32_t w_sh, uint32_t p, uint32_t mu, int reps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  uint32_t v[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) v[j] = x[e] + j;
#pragma unroll 1
  for (int r = 0; r < reps; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < ILP; ++j) v[j] = chain_step<VARIANT>(v[j], w, w_sh, p, mu);
    }
  }
  uint32_t acc = v[0];
#pragma unroll
  for (int j = 1; j < ILP; ++j) acc ^= v[j];
  out[e] = acc;
}

constexpr int kThreads = 256;

template <int VARIANT, int ILP>
cudaError_t launch_ilp(int unroll, const uint32_t* x, uint32_t* out, int count, uint32_t w,
                       uint32_t w_sh, uint32_t p, uint32_t mu, int reps,
                       cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((count + kThreads - 1) / kThreads);
  if (unroll == 8)
    modmul_chain_kernel<VARIANT, ILP, 8><<<blocks, kThreads, 0, stream>>>(
        x, out, count, w, w_sh, p, mu, reps);
  else if (unroll == 1)
    modmul_chain_kernel<VARIANT, ILP, 1><<<blocks, kThreads, 0, stream>>>(
        x, out, count, w, w_sh, p, mu, reps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int VARIANT>
cudaError_t launch_variant(int ilp, int unroll, const uint32_t* x, uint32_t* out, int count,
                           uint32_t w, uint32_t w_sh, uint32_t p, uint32_t mu, int reps,
                           cudaStream_t stream) {
  switch (ilp) {
    case 1: return launch_ilp<VARIANT, 1>(unroll, x, out, count, w, w_sh, p, mu, reps, stream);
    case 2: return launch_ilp<VARIANT, 2>(unroll, x, out, count, w, w_sh, p, mu, reps, stream);
    case 4: return launch_ilp<VARIANT, 4>(unroll, x, out, count, w, w_sh, p, mu, reps, stream);
    default: return cudaErrorInvalidValue;
  }
}

using Launch = cudaError_t (*)(int, int, const uint32_t*, uint32_t*, int, uint32_t, uint32_t,
                               uint32_t, uint32_t, int, cudaStream_t);
constexpr Launch kLaunch[] = {launch_variant<kExact>, launch_variant<kLazy>,
                              launch_variant<kBarrett>, launch_variant<kCheap17>,
                              launch_variant<kMul17>};

}  // namespace

extern "C" {

// variant: 0 exact, 1 lazy, 2 barrett, 3 cheap17, 4 mul17; ilp 1, 2 or 4;
// unroll 1 or 8, dividing reps.
int fhe_modmul_chain(const void* x, void* out, int count, uint32_t w, uint32_t w_sh,
                     uint32_t p, uint32_t mu, int reps, int variant, int ilp, int unroll,
                     void* stream) {
  if (count <= 0 || reps < 0 || (unroll != 1 && unroll != 8) || reps % unroll ||
      variant < kExact || variant > kMul17)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunch[variant](
      ilp, unroll, static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), count, w,
      w_sh, p, mu, reps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
