// The column form of the NTT kernels: a transform as a chain of ordinary
// launches that meet in global memory, for the rings where no share of a
// row that a cluster splits fits a block (n >= 262144: even a padded
// quarter row takes 264 KB), and on request at smaller n (the wrappers'
// geometries, form="column"), where it must give the cluster forms' bits.
//
// Let n = 2^L and b = 2^logb, the block (ops/column_cuda.py picks it: at
// most 8192 positions, so four padded block rows fit a block's shared
// memory).  The top s = L - logb stages of the forward transform, and the
// last s of the inverse, pair elements across blocks; every other stage
// keeps to one block.  So:
//   - a column launch runs the top s forward stages (or the last s inverse
//     stages) on columns of 2^s elements at stride b: element j belongs to
//     column j mod b, as element i of it (j = c + i b).  A CTA takes a tile
//     of C = 2^logc adjacent columns, all 2^s elements of each, in shared
//     memory at t[(i << logc) + c], so consecutive threads hold
//     consecutive positions (coalesced loads and stores, conflict-free
//     banks).  Stage l of the forward pairs i with i + 2^(s-1-l) under
//     psi_br[2^l + g], g = i >> (s - l), the same twiddle for every column;
//     the inverse's stage l (distance 2^l) uses ipsi_br[2^(s-1-l) + g],
//     g = i >> (l + 1).  These are the butterflies of ops/ntt.py's stages
//     m = 1 .. 2^(s-1) (inverse: 2^(s-1) .. 1), element for element.
//   - a block launch runs the remaining stages on positions [h b, (h+1) b):
//     exactly the passes that CTA h of a row split over H = 2^s CTAs runs
//     (modmath.cuh's ntt_regs_pass takes h and log H at run time, so the
//     sweep and its twiddle indexing are the split's), in one padded block
//     row a[] of shared memory, element j at padded_index(j - h b).
// Between the launches the rows lie in global scratch the wrapper
// allocates.  The kernels that fuse work into their transforms (ntt.cu,
// rns.cu, decrypt.cu) run their coefficient-domain prologue in the forward
// column launch, their NTT-domain body in the block launch, and their
// epilogue in the inverse column launch.  Every stage is the one the other
// forms run, in the same order on the same operands, so the bits are theirs.
//
// What bounds it on the H100: each launch reads and writes every row once,
// so a transform moves 2 (forward) or 4 (both) row-sized passes through
// device memory where the cluster forms moved one; at n >= 262144 a row is
// 1 MB and more, and the chains are bound by those bytes plus the column
// stages' shared-memory round trips (a barrier per stage).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace fhe {

// A column launch's tile: C = 2^logc adjacent columns from col0 of a row
// of n = 2^logn, all 2^s elements of each (s = logn - logb).
struct ColumnTile {
  int logn, logb, logc, col0;

  __device__ __forceinline__ int steps() const { return logn - logb; }
  __device__ __forceinline__ int words() const { return 1 << (logn - logb + logc); }
  // the row position of tile word e
  __device__ __forceinline__ int position(int e) const {
    return col0 + (e & ((1 << logc) - 1)) + ((e >> logc) << logb);
  }
};

// The tile of CTA blockIdx.x: tiles of C columns in order along the row.
__device__ __forceinline__ ColumnTile column_tile(int logn, int logb, int logc) {
  return ColumnTile{logn, logb, logc, static_cast<int>(blockIdx.x) << logc};
}

// t[e] = in(position of word e), for the whole tile, then a barrier.
template <class In>
__device__ __forceinline__ void column_load(uint32_t* t, const ColumnTile& tile, In in) {
  for (int e = threadIdx.x; e < tile.words(); e += blockDim.x) t[e] = in(tile.position(e));
  __syncthreads();
}

// out(position, t[e], e) for every word of the tile.
template <class Out>
__device__ __forceinline__ void column_store(const uint32_t* t, const ColumnTile& tile, Out out) {
  for (int e = threadIdx.x; e < tile.words(); e += blockDim.x) out(tile.position(e), t[e], e);
}

// The top s stages of the forward transform (distances n/2 .. b) on the
// tile, each ended by a barrier.
__device__ __forceinline__ void column_forward(uint32_t* t, const ColumnTile& tile, uint32_t p,
                                               const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ w_sh) {
  const int s = tile.steps(), logc = tile.logc;
  const int half = tile.words() >> 1;
  for (int l = 0; l < s; ++l) {
    const int logd = s - 1 - l;        // the distance in i
    for (int q = threadIdx.x; q < half; q += blockDim.x) {
      const int c = q & ((1 << logc) - 1), bi = q >> logc;
      const int g = bi >> logd;
      const int i1 = (g << (logd + 1)) | (bi & ((1 << logd) - 1));
      const int e1 = (i1 << logc) | c, e2 = e1 + (1 << (logd + logc));
      const int m = (1 << l) + g;
      const uint32_t u = t[e1];
      const uint32_t v = mul_shoup(t[e2], __ldg(w + m), __ldg(w_sh + m), p);
      t[e1] = add_mod(u, v, p);
      t[e2] = sub_mod(u, v, p);
    }
    __syncthreads();
  }
}

// The last s stages of the inverse transform (distances b .. n/2) on the
// tile, each ended by a barrier; the caller multiplies by n^-1 as it stores.
__device__ __forceinline__ void column_inverse(uint32_t* t, const ColumnTile& tile, uint32_t p,
                                               const uint32_t* __restrict__ iw,
                                               const uint32_t* __restrict__ iw_sh) {
  const int s = tile.steps(), logc = tile.logc;
  const int half = tile.words() >> 1;
  for (int l = 0; l < s; ++l) {        // the distance in i is 2^l
    for (int q = threadIdx.x; q < half; q += blockDim.x) {
      const int c = q & ((1 << logc) - 1), bi = q >> logc;
      const int g = bi >> l;
      const int i1 = (g << (l + 1)) | (bi & ((1 << l) - 1));
      const int e1 = (i1 << logc) | c, e2 = e1 + (1 << (l + logc));
      const int m = (1 << (s - 1 - l)) + g;
      const uint32_t u = t[e1], v = t[e2];
      t[e1] = add_mod(u, v, p);
      t[e2] = mul_shoup(sub_mod(u, v, p), __ldg(iw + m), __ldg(iw_sh + m), p);
    }
    __syncthreads();
  }
}

// The forward stages below the column ones (distances b/2 .. 1) on block
// h, positions [h b, (h+1) b), in the padded block row a[]: a lead pass of
// logb mod kRegLog stages (kRegLog where that is 0), then passes of
// kRegLog; the lead pass gets its groups from in(x, base, logs), and the
// last hands out() 16 consecutive positions (logs = 0, base a multiple of
// 16) of the CTA's block.  Needs logb > kRegLog.
template <class In, class Out>
__device__ __forceinline__ void block_forward(uint32_t* a, int logn, int logb, int h, uint32_t p,
                                              const uint32_t* __restrict__ w,
                                              const uint32_t* __restrict__ w_sh, In in,
                                              Out out) {
  const int logH = logn - logb, first = h << logb;
  const SmemLoadFrom load{a, first};
  const SmemStoreFrom store{a, first};
  const int rem = logb % kRegLog;
  const int lead = rem ? rem : kRegLog;
  int logT = logb - 1;
  ntt_regs_any<false>(lead, logn, logT, p, w, w_sh, in, store, h, logH);
  for (logT -= lead; logT >= kRegLog; logT -= kRegLog)
    ntt_regs_pass<kRegLog, false>(logn, logT, p, w, w_sh, load, store, h, logH);
  ntt_regs_pass<kRegLog, false>(logn, kRegLog - 1, p, w, w_sh, load, out, h, logH);
}

// The inverse stages below the column ones (distances 1 .. b/2) on block
// h, its mirror: a pass of kRegLog stages whose groups are 16 consecutive
// positions from in(x, base, 0), then one of logb mod kRegLog stages where
// that is not 0, then passes of kRegLog; the last hands its groups to
// out(x, base, logs), not yet times n^-1.  Needs logb > kRegLog.
template <class In, class Out>
__device__ __forceinline__ void block_inverse(uint32_t* a, int logn, int logb, int h, uint32_t p,
                                              const uint32_t* __restrict__ iw,
                                              const uint32_t* __restrict__ iw_sh, In in,
                                              Out out) {
  const int logH = logn - logb, first = h << logb;
  const SmemLoadFrom load{a, first};
  const SmemStoreFrom store{a, first};
  const int rem = logb % kRegLog;
  ntt_regs_pass<kRegLog, true>(logn, kRegLog - 1, p, iw, iw_sh, in, store, h, logH);
  int lo = kRegLog;                    // the lowest stage not yet run
  if (rem) {
    if (lo + rem == logb) {
      ntt_regs_any<true>(rem, logn, logb - 1, p, iw, iw_sh, load, out, h, logH);
      return;
    }
    ntt_regs_any<true>(rem, logn, lo + rem - 1, p, iw, iw_sh, load, store, h, logH);
    lo += rem;
  }
  for (; lo + kRegLog < logb; lo += kRegLog)
    ntt_regs_pass<kRegLog, true>(logn, lo + kRegLog - 1, p, iw, iw_sh, load, store, h, logH);
  ntt_regs_pass<kRegLog, true>(logn, logb - 1, p, iw, iw_sh, load, out, h, logH);
}

// A plain (non-cluster) launch of KERNEL: raise its dynamic shared-memory
// limit where `smem` needs it (once per device and size), launch on
// `stream`, and return the launch's error.  A type per kernel, so an entry
// point picks its lane's instance at run time: run(PlainLaunch<&k<A>>{}).
template <auto KERNEL>
struct PlainLaunch {
  template <class... Args>
  cudaError_t operator()(dim3 grid, int threads, int smem, cudaStream_t stream,
                         Args... args) const {
    static std::atomic<size_t> granted[kMaxDevices];
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(KERNEL), smem, granted);
    if (err != cudaSuccess) return err;
    KERNEL<<<grid, threads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
};

// The launch arguments every column-form entry point checks: a block of
// more than 2^kRegLog positions inside the row, a tile of whole columns.
inline bool column_args_ok(int logn, int logb, int logc) {
  return logb > kRegLog && logb < logn && logc >= 0 && logc <= logb;
}

}  // namespace fhe
