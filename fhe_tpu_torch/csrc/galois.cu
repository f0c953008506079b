// Coefficient Galois automorphism for Hopper (sm_90a): a signed gather.
//
// Replaces fhe_tpu/ops/galois_pallas.py: automorphism_fused, in all three of
// its lanes (no c0, a c0 shared by every element, a c0 per element),
// automorphism_single, which launches it with B = 1, and
// automorphism_fused_sum (automorphism_sum_kernel, the same signed gather
// accumulated over the elements; the Pallas _MAX_ELEMS chunking is a VMEM
// artifact and is not carried over).  Plain versions:
// fhe_tpu_torch/ops/galois.py.  The port launches automorphism_kernel for
// the Galois key generator and the rotations at ks_omega >= 2, whose grouped
// digits are a CRT interpolation of the per-prime digits, with which the
// automorphism's negation does not commute; at ks_omega = 1 a rotation and
// the hoisted rotations run it inside the key switch (the Galois lanes of
// keyswitch_fused and ks_inner, csrc/ntt.cu).  automorphism_sum_kernel
// closes every sum_slots stage, after ks_inner's plain inner products: sum
// lanes of ks_inner that did its work in the same launch ran longer
// (PERF.md).
//
// a(x) -> a(x^g) on Z_p[x]/(x^n + 1) is a permutation with sign flips: with
// h = g^-1 mod 2n, out[j] = x[h*j mod n], negated where h*j mod 2n >= n.
// Element b of a [k, C, B, n] stack gets its own multiplier h_b.  When c0 is
// given it is added to component 0 before the permutation, so it is read at
// the source index, not at j.
//
// Design.  One thread per output residue computes its source index and sign
// and reads the source residue directly.  The Pallas kernel's iota fold and
// masked sublane rolls (galois_pallas.py:65-111) exist only because Mosaic
// has no lane gather; a GPU thread can read any address, so none of that is
// carried over, and no index table is stored or loaded.  The index is formed
// in 64 bits: h < 2n and j < n, so h*j needs more than 31 bits from
// n = 32768 on.
//
// What bounds it on the H100.  It does a handful of integer operations per
// residue and moves each residue once in and once out (plus c0): at n = 8192,
// k = 3, C = 2, B = 8 that is 1.5 MB in and 1.5 MB out, about 0.9 us at the
// memory rate, so it is bound by bytes.  The reads are scattered, but the
// source rows are 32 KB each and stay in L2; the writes are coalesced.  The
// sum kernel reads the same B * C rows (plus c0 and the base) and writes only
// C rows: at n = 8192, k = 3, C = 2, B = 3 about 0.8 MB, 0.25 us at the
// memory rate, so at the slice's shapes both are bound by launch latency.

#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace {

// x: element (i, c, b, j) at i * x_sp + c * x_sc + b * x_sb + j.  c0 (may be
// null): element (i, b, j) at i * c0_sp + b * c0_sb + j (c0_sb = 0 for a c0
// shared by every element).  hs: [B] multipliers, each in [1, 2n).
// out: [k, C, B, n].  Grid (n / blockDim.x, B, k * C).
__global__ void __launch_bounds__(256)
automorphism_kernel(const uint32_t* __restrict__ x, long long x_sp, long long x_sc,
                    long long x_sb, const uint32_t* __restrict__ c0, long long c0_sp,
                    long long c0_sb, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ p, const uint32_t* __restrict__ hs,
                    int num_c, int logn) {
  const int n = 1 << logn;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int b = blockIdx.y;
  const int i = blockIdx.z / num_c;
  const int c = blockIdx.z - i * num_c;
  const uint32_t pi = p[i];
  const uint64_t hj = (static_cast<uint64_t>(hs[b]) * j) & ((2ull << logn) - 1);
  const long long src = static_cast<long long>(hj & (n - 1));
  uint32_t v = x[i * x_sp + c * x_sc + b * x_sb + src];
  if (c0 != nullptr && c == 0) v = fhe::add_mod(v, c0[i * c0_sp + b * c0_sb + src], pi);
  if (hj >= static_cast<uint64_t>(n)) v = fhe::neg_mod(v, pi);
  out[((static_cast<size_t>(i) * num_c + c) * gridDim.y + b) * n + j] = v;
}

// The accumulating epilogue of a hoisted rotate-and-sum (a sum_slots stage):
// out[i, c, j] = base[i, c, j] + sum_b phi_{hs[b]}(x_b + c0)[i, c, j] mod p_i,
// c0 added to component 0 only.  x as in automorphism_kernel; c0: element
// (i, j) at i * c0_sp + j; base: element (i, c, j) at i * base_sp + c * base_sc
// + j.  Each thread owns one output residue and loops over the B elements,
// so the B rotations are never written out.  out: [k, C, n].  Grid
// (n / blockDim.x, k * C).
__global__ void __launch_bounds__(256)
automorphism_sum_kernel(const uint32_t* __restrict__ x, long long x_sp, long long x_sc,
                        long long x_sb, const uint32_t* __restrict__ c0, long long c0_sp,
                        const uint32_t* __restrict__ base, long long base_sp,
                        long long base_sc, uint32_t* __restrict__ out,
                        const uint32_t* __restrict__ p, const uint32_t* __restrict__ hs,
                        int num_c, int batch, int logn) {
  const int n = 1 << logn;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int i = blockIdx.y / num_c;
  const int c = blockIdx.y - i * num_c;
  const uint32_t pi = p[i];
  const uint32_t* xr = x + i * x_sp + c * x_sc;
  const uint32_t* c0r = c0 + i * c0_sp;
  uint32_t acc = base[i * base_sp + c * base_sc + j];
  for (int b = 0; b < batch; ++b) {
    const uint64_t hj = (static_cast<uint64_t>(hs[b]) * j) & ((2ull << logn) - 1);
    const long long src = static_cast<long long>(hj & (n - 1));
    uint32_t v = xr[b * x_sb + src];
    if (c == 0) v = fhe::add_mod(v, c0r[src], pi);
    if (hj >= static_cast<uint64_t>(n)) v = fhe::neg_mod(v, pi);
    acc = fhe::add_mod(acc, v, pi);
  }
  out[(static_cast<size_t>(i) * num_c + c) * n + j] = acc;
}

}  // namespace

extern "C" {

int fhe_automorphism(const void* x, long long x_sp, long long x_sc, long long x_sb,
                     const void* c0, long long c0_sp, long long c0_sb, void* out,
                     const void* p, const void* hs, int k, int num_c, int batch, int logn,
                     void* stream) {
  constexpr int kThreads = 256;
  const int n = 1 << logn;
  const dim3 grid((n + kThreads - 1) / kThreads, batch, k * num_c);
  automorphism_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), x_sp, x_sc, x_sb, static_cast<const uint32_t*>(c0),
      c0_sp, c0_sb, static_cast<uint32_t*>(out), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(hs), num_c, logn);
  return static_cast<int>(cudaGetLastError());
}

int fhe_automorphism_sum(const void* x, long long x_sp, long long x_sc, long long x_sb,
                         const void* c0, long long c0_sp, const void* base,
                         long long base_sp, long long base_sc, void* out, const void* p,
                         const void* hs, int k, int num_c, int batch, int logn,
                         void* stream) {
  constexpr int kThreads = 256;
  const int n = 1 << logn;
  const dim3 grid((n + kThreads - 1) / kThreads, k * num_c);
  automorphism_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), x_sp, x_sc, x_sb, static_cast<const uint32_t*>(c0),
      c0_sp, static_cast<const uint32_t*>(base), base_sp, base_sc,
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(hs), num_c, batch, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
