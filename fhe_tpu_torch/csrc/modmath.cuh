// Modular arithmetic on uint32 residues, and the register-blocked NTT sweep
// that every transforming kernel of the package shares.
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
//   OPS mul_shoup_lazy 3
//   OPS reduce_shoup 5
//   OPS mul_barrett 11
//   OPS reduce_barrett 10
//   OPS neg_mod 3
//   OPS reduce_wide 15
// and one term of an unreduced 64-bit sum of products, s += (uint64) y * w
// (one IMAD.WIDE), which reduce_wide closes:
//   OPS mac_wide 1
// and the steps rns.cu and lift.cuh write inline: centring a correction
// alpha into the destination prime (compare; add of a per-prime constant,
// c - 2^16 or q_j - m_sk; select), one step of the m~ = 2^16 lane,
// (lane + (y & 0xFFFF) * w) & 0xFFFF (mask, multiply-add, mask), and the
// lane's closing (lane * q^-1) & 0xFFFF (multiply, mask):
//   OPS select 3
//   OPS lane16 3
//   OPS mul16 2
// and the source index of a coefficient automorphism that galois.cu and the
// Galois lanes of ntt.cu (coeff_source) compute inline for each residue,
// hj = (h * j) & (2n - 1), src = hj & (n - 1) and the test hj >= n (a
// multiply, two masks and a compare or shift):
//   OPS galois_index 4
// and the in-block source of the NTT-domain automorphism that ntt.cu's
// gathered_products (the Galois lanes of ks_inner) computes
// for each position and element, (g * brv4(l) + Q) & 15 (a multiply-add and
// a mask; the source block, formed once per group of 16, is not counted):
//   OPS galois_ntt_index 2
// and one butterfly of the register-blocked NTT sweep fwd_ntt_regs /
// inv_ntt_regs (mul_shoup, add_mod and sub_mod; the sweep's index and
// address arithmetic is not counted):
//   OPS ntt_butterfly 14
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

// A launch of `grid` in clusters of `cluster` CTAs along x; `attr` is the
// caller's storage for the one launch attribute the config points to.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, int cluster,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaErrorLaunchOutOfResources unless the device can hold at least one
// cluster of cfg's shape (threads, shared memory, cluster size).  `placed`
// is the calling kernel's record of the last shape found to fit on each
// device, so the occupancy query runs again only when the shape changes.
inline cudaError_t check_cluster(const void* kernel, const cudaLaunchConfig_t& cfg,
                                 std::atomic<size_t> (&placed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const size_t shape = (cfg.dynamicSmemBytes << 20) | (static_cast<size_t>(cfg.blockDim.x) << 4)
                       | cfg.attrs[0].val.clusterDim.x;
  if (dev < kMaxDevices && placed[dev].load() == shape) return cudaSuccess;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if (dev < kMaxDevices) placed[dev].store(shape);
  return cudaSuccess;
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

// mul_shoup without its closing subtract: x * w mod p in [0, 2p), for any
// x < 2^32 (the Harvey lazy form, a valid input to the next product).
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t x, uint32_t w,
                                                   uint32_t w_sh, uint32_t p) {
  return x * w - __umulhi(x, w_sh) * p;
}

// x mod p for any x < 2^32 and p < 2^31; one_sh = floor(2^32 / p).
__device__ __forceinline__ uint32_t reduce_shoup(uint32_t x, uint32_t p,
                                                 uint32_t one_sh) {
  uint32_t q = __umulhi(x, one_sh);
  uint32_t r = x - q * p;
  return r >= p ? r - p : r;
}

// x mod p for any x < 2^64 and p < 2^31, with pw = (p, r, r_sh, one_sh):
// r = 2^32 mod p and its Shoup companion, one_sh = floor(2^32 / p).  The
// high word goes through the Shoup product by r, the low word through
// reduce_shoup.  A sum of up to 16 products of residues below 2^30 stays
// below 2^64, so the base-conversion kernels accumulate such sums with
// 32x32 -> 64 multiply-adds and reduce once.
__device__ __forceinline__ uint32_t reduce_wide(uint64_t x, uint4 pw) {
  const uint32_t hi = static_cast<uint32_t>(x >> 32), lo = static_cast<uint32_t>(x);
  return add_mod(mul_shoup(hi, pw.y, pw.z, pw.x), reduce_shoup(lo, pw.x, pw.w), pw.x);
}

// (-a) mod p for a in [0, p): p - a, and 0 (not p) for a = 0.
__device__ __forceinline__ uint32_t neg_mod(uint32_t a, uint32_t p) {
  return a == 0 ? 0u : p - a;
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

// ---------------------------------------------------------------------------
// The register-blocked sweep (every NTT kernel: ntt_forward, ntt_inverse,
// mul_by_ntt_operand, tensor_product, keyswitch_fused, ks_inner,
// bsk_branch_fused and decrypt_fused).
//
// The radix-2 butterflies of the merged-psi transforms (ops/ntt.py), grouped
// so that a thread runs up to kRegLog stages on 2^kRegLog coefficients in
// registers between barriers: an n = 8192 transform is 4 passes through
// shared memory (4 barriers), not one per stage (13).  The forward stage m
// (m = 1, 2, ..., n/2; distance t = n / (2m)) pairs j1 = 2 g t + r with
// j1 + t under twiddle psi_br[m + g] (Cooley-Tukey, natural order in,
// bit-reversed out); the inverse runs the Gentleman-Sande stages m = n/2
// .. 1 on the same pairs (bit-reversed in, natural out).  A pass of L
// stages whose largest butterfly distance is T works on groups of G = 2^L
// coefficients, base + i * s (i < G, s = 2T / G), one group per thread and
// loop step; group g0 * s + r (r < s) has base g0 * 2T + r.  Within the
// group, stage l (distance
// T >> l) pairs i with i + 2^(L-1-l) in sub-block b of 2^(L-l) elements, and
// its twiddle is psi_br[(M0 << l) + b] with M0 = n / (2T) + g0, the
// butterfly of stage m = n / (2t), group g = (g0 << l) + b.  So the pass
// loads G - 1 twiddle pairs for L * G / 2 butterflies, and the output bits
// are those of the stage-by-stage transform.
//
// Passes.  The first and the last pass have kRegLog stages; where kRegLog
// does not divide log n, the second pass takes the log n mod kRegLog
// stages left over (for log n < 2 kRegLog: a full pass, then the rest).
// The first pass gets its group from `in(x, base, logs)`, which fills x[i]
// with element base + (i << logs) (natural order for the forward
// transform), and the last hands its group to `out(x, base, logs)` (the
// inverse's already times n_inv), so a caller fuses its load and its
// epilogue into the sweep, a whole group at a time; the passes between use
// a[], a row padded to padded(n) words, element j at j + j / 32.  The
// padding leaves every pass free of bank conflicts except one whose stride
// s is 2 to 16 (two-way).
//
// Which thread gets what.  Thread t takes the groups grp = t,
// t + blockDim.x, ... of every pass (of its share, where CTAs split the
// row).  In the inverse's first pass and, for log n >= 2 kRegLog, in the
// forward transform's last pass (s = 1), group grp is the 16 consecutive
// elements from 16 grp; in the inverse's last pass (s = n / 16) it is
// grp + i * n / 16.  That mapping is the same
// in every call with the same n and blockDim, so a caller that accumulates
// through out() across calls reads and writes each element from one
// thread; any other reader of what out() stored synchronises first.  Every
// pass ends with a barrier, so a[] may be written again when the sweep
// returns (but see the compact split below).  Needs log n > kRegLog; the
// wrappers pick blockDim (ops/ntt_cuda.py, regs_threads).
// ---------------------------------------------------------------------------

constexpr int kRegLog = 4;

__device__ __forceinline__ int padded_index(int j) { return j + (j >> 5); }
__host__ __device__ constexpr int padded(int n) { return n + (n >> 5); }

// The shared-memory words of the cluster tensor products (ntt.cu's
// tensor_product and rns.cu's bsk_branch_fused) in each form: two padded
// rows (0), a padded row and a padded half row (1, HALF), the padded half
// row alone (2, COMPACT) or the padded quarter row alone (3, QUARTER).
__host__ __device__ constexpr int product_words(int form, int n) {
  return form == 3   ? padded(n / 4)
         : form == 2 ? padded(n / 2)
                     : padded(n) + padded(form == 1 ? n / 2 : n);
}

// A group from, and to, a padded shared row.
struct SmemLoad {
  const uint32_t* a;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&x)[G], int base, int logs) const {
#pragma unroll
    for (int i = 0; i < G; ++i) x[i] = a[padded_index(base + (i << logs))];
  }
};
struct SmemStore {
  uint32_t* a;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&x)[G], int base, int logs) const {
#pragma unroll
    for (int i = 0; i < G; ++i) a[padded_index(base + (i << logs))] = x[i];
  }
};
// A group to a padded shared row that holds only positions from `first` on
// (a multiple of 32, so its padding is the whole row's): a CTA of a
// RowSplit that keeps just its own positions of the forward's result.
struct SmemStoreFrom {
  uint32_t* a;
  int first;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&x)[G], int base, int logs) const {
#pragma unroll
    for (int i = 0; i < G; ++i) a[padded_index(base + (i << logs) - first)] = x[i];
  }
};

// The twiddles w[idx .. idx + CNT) of one stage (or the words of an
// operand row under a consecutive group), CNT a power of two: a run that
// starts at a multiple of CNT, so it is read with 16-byte (or 8-byte) loads
// where CNT allows; every table and operand row starts 16-byte aligned (the
// wrappers check).
template <int CNT>
__device__ __forceinline__ void load_twiddles(const uint32_t* __restrict__ w, int idx,
                                              uint32_t (&v)[CNT]) {
  if constexpr (CNT >= 4) {
#pragma unroll
    for (int c = 0; c < CNT; c += 4) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(w + idx + c));
      v[c] = t.x;
      v[c + 1] = t.y;
      v[c + 2] = t.z;
      v[c + 3] = t.w;
    }
  } else if constexpr (CNT == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(w + idx));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(w + idx);
  }
}

// The words src[idx .. idx + CNT) of a run that starts at a multiple of
// CNT: load_twiddles's vector loads where `vec` (src starts 16-byte aligned
// and idx is a multiple of 4, as the wrappers report), a word at a time
// otherwise.
template <int CNT>
__device__ __forceinline__ void load_run(const uint32_t* __restrict__ src, int idx, bool vec,
                                         uint32_t (&v)[CNT]) {
  if (vec) {
    load_twiddles(src, idx, v);
  } else {
#pragma unroll
    for (int c = 0; c < CNT; ++c) v[c] = __ldg(src + idx + c);
  }
}

// The words v[0 .. CNT) to dst[idx .. idx + CNT), a run that starts at a
// multiple of CNT in a 16-byte aligned row: 16-byte (or 8-byte) stores
// where CNT allows, the mirror of load_twiddles.
template <int CNT>
__device__ __forceinline__ void store_run(uint32_t* __restrict__ dst, int idx,
                                          const uint32_t (&v)[CNT]) {
  if constexpr (CNT >= 4) {
#pragma unroll
    for (int c = 0; c < CNT; c += 4)
      *reinterpret_cast<uint4*>(dst + idx + c) = make_uint4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (CNT == 2) {
    *reinterpret_cast<uint2*>(dst + idx) = make_uint2(v[0], v[1]);
  } else {
    dst[idx] = v[0];
  }
}

// Stage l of a pass over the G coefficients x[] of one group: in each of
// its 2^l sub-blocks b, pairs at distance G >> (l + 1), twiddle index
// (m0 << l) + b.  Every bound is a template constant, so the loops unroll
// fully and x[] stays in registers.
template <int G, int l, bool INVERSE>
__device__ __forceinline__ void ntt_regs_stage(uint32_t (&x)[G], int m0, uint32_t p,
                                               const uint32_t* __restrict__ w,
                                               const uint32_t* __restrict__ w_sh) {
  constexpr int half = G >> (l + 1);
  uint32_t wv[1 << l], ws[1 << l];
  load_twiddles(w, m0 << l, wv);
  load_twiddles(w_sh, m0 << l, ws);
#pragma unroll
  for (int b = 0; b < (1 << l); ++b) {
#pragma unroll
    for (int q = 0; q < half; ++q) {
      const int i1 = 2 * b * half + q, i2 = i1 + half;
      const uint32_t u = x[i1];
      if (INVERSE) {
        const uint32_t v = x[i2];
        x[i1] = add_mod(u, v, p);
        x[i2] = mul_shoup(sub_mod(u, v, p), wv[b], ws[b], p);
      } else {
        const uint32_t v = mul_shoup(x[i2], wv[b], ws[b], p);
        x[i1] = add_mod(u, v, p);
        x[i2] = sub_mod(u, v, p);
      }
    }
  }
}

// Stages s, s + 1, ..., L - 1 of a pass, in the order of the transform:
// l = s for the forward one (distance T down), l = L - 1 - s for the
// inverse (distance up to T).
template <int G, int L, int s, bool INVERSE>
__device__ __forceinline__ void ntt_regs_stages(uint32_t (&x)[G], int m0, uint32_t p,
                                                const uint32_t* __restrict__ w,
                                                const uint32_t* __restrict__ w_sh) {
  if constexpr (s < L) {
    ntt_regs_stage<G, INVERSE ? L - 1 - s : s, INVERSE>(x, m0, p, w, w_sh);
    ntt_regs_stages<G, L, s + 1, INVERSE>(x, m0, p, w, w_sh);
  }
}

// One pass of L stages with largest distance 2^logT over an n-point row,
// by CTA h of the 2^logH that share the row: it takes the h-th 2^-logH of
// the pass's groups.
template <int L, bool INVERSE, class In, class Out>
__device__ __forceinline__ void ntt_regs_pass(int logn, int logT, uint32_t p,
                                              const uint32_t* __restrict__ w,
                                              const uint32_t* __restrict__ w_sh, In in,
                                              Out out, int h, int logH) {
  constexpr int G = 1 << L;
  const int logs = logT + 1 - L;
  const int per = 1 << (logn - L - logH);
  for (int grp = h * per + threadIdx.x; grp < (h + 1) * per; grp += blockDim.x) {
    const int g0 = grp >> logs;
    const int base = (g0 << (logT + 1)) | (grp & ((1 << logs) - 1));
    uint32_t x[G];
    in(x, base, logs);
    ntt_regs_stages<G, L, 0, INVERSE>(x, (1 << (logn - 1 - logT)) + g0, p, w, w_sh);
    out(x, base, logs);
  }
  __syncthreads();
}

// A pass of L = 1 .. kRegLog stages chosen at run time.
template <bool INVERSE, class In, class Out>
__device__ __forceinline__ void ntt_regs_any(int L, int logn, int logT, uint32_t p,
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ w_sh, In in,
                                             Out out, int h, int logH) {
  static_assert(kRegLog == 4, "ntt_regs_any lists the pass sizes 1..4");
  switch (L) {
    case 1: ntt_regs_pass<1, INVERSE>(logn, logT, p, w, w_sh, in, out, h, logH); break;
    case 2: ntt_regs_pass<2, INVERSE>(logn, logT, p, w, w_sh, in, out, h, logH); break;
    case 3: ntt_regs_pass<3, INVERSE>(logn, logT, p, w, w_sh, in, out, h, logH); break;
    default: ntt_regs_pass<4, INVERSE>(logn, logT, p, w, w_sh, in, out, h, logH); break;
  }
}

// A row shared by H = 2^logH CTAs of a cluster (H = 1: one CTA).  CTA h
// runs the h-th 2^-logH of every pass's groups.  The first pass of the
// forward transform splits the row by column (element j goes with column
// j mod n/16 and CTA (j >> (log n - 4 - logH)) mod H); every later pass
// keeps to blocks of at most n/16 elements, and CTA h's groups are then those
// of positions [h n/H, (h+1) n/H).  So the second pass reads each element
// from its column's CTA, after a cluster barrier, and writes its own
// positions, which no peer reads; the forward result of positions
// [h n/H, (h+1) n/H) stays with CTA h.  The inverse mirrors it: every pass
// but the last keeps to CTA h's positions, and the last (the top kRegLog
// stages, across the row) reads each element from the CTA of its position,
// after a cluster barrier.  `peer[c]` is CTA c's a[] (distributed shared
// memory), `sync` the cluster barrier; for H = 1 neither is used.
template <int H>
struct RowSplit {
  const uint32_t* peer[H];
  int h;
};

// The RowSplit of CTA h of the H CTAs of `cluster` (cooperative groups),
// ranks first .. first + H - 1, that share a row through their rows at `a`.
template <int H, class Cluster>
__device__ __forceinline__ RowSplit<H> row_split(Cluster cluster, uint32_t* a, int first, int h) {
  RowSplit<H> sp;
#pragma unroll
  for (int c = 0; c < H; ++c) sp.peer[c] = cluster.map_shared_rank(a, first + c);
  sp.h = h;
  return sp;
}

// A group from the padded rows of the CTAs sharing a row: element j from
// peer[(j >> shift) & (H - 1)].  The pointers are picked with constant
// indices, so they stay in registers.
template <int H>
struct PeerLoad {
  RowSplit<H> sp;
  int shift;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&x)[G], int base, int logs) const {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int j = base + (i << logs);
      const int owner = (j >> shift) & (H - 1);
      const uint32_t* src = sp.peer[0];
#pragma unroll
      for (int c = 1; c < H; ++c)
        if (owner == c) src = sp.peer[c];
      x[i] = src[padded_index(j)];
    }
  }
};

template <int H>
__device__ __forceinline__ auto split_load(const RowSplit<H>& sp, uint32_t* a, int shift) {
  if constexpr (H == 1)
    return SmemLoad{a};
  else
    return PeerLoad<H>{sp, shift};
}

// The compact split (n = 65536 with H = 2, where one padded row exceeds a
// block's shared memory, and n = 131072 with H = 4, the quarter split, where
// a padded half row does too): CTA h's a[] holds only positions
// [h n/H, (h+1) n/H),
// element j at padded_index(j - h n/H).  A group of the forward's first
// pass and of the inverse's last (the top stages, across the row) is a
// column, elements base + (i << logs) with base < n/G and span = n/H =
// (G/H) << logs, so element i lies with CTA i / (G/H), at base + ((i mod
// G/H) << logs) of its row: the owner of every element is a constant, and
// the pointers are picked at compile time.
struct SmemLoadFrom {
  const uint32_t* a;
  int first;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&x)[G], int base, int logs) const {
#pragma unroll
    for (int i = 0; i < G; ++i) x[i] = a[padded_index(base + (i << logs) - first)];
  }
};

// The forward's first pass: each element straight into its owner's row.
template <int H>
struct ColumnToOwner {
  RowSplit<H> sp;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&x)[G], int base, int logs) const {
    constexpr int per = G / H;
    static_assert(per >= 1, "a column group spans every CTA of the split");
#pragma unroll
    for (int i = 0; i < G; ++i)
      const_cast<uint32_t*>(sp.peer[i / per])[padded_index(base + ((i % per) << logs))] = x[i];
  }
};

// The inverse's last pass: each element from its owner's row.
template <int H>
struct ColumnFromOwner {
  RowSplit<H> sp;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&x)[G], int base, int logs) const {
    constexpr int per = G / H;
    static_assert(per >= 1, "a column group spans every CTA of the split");
#pragma unroll
    for (int i = 0; i < G; ++i) x[i] = sp.peer[i / per][padded_index(base + ((i % per) << logs))];
  }
};

// The loads and stores of the passes a CTA keeps to its own positions:
// the whole padded row, or (COMPACT) the row from `first` on.
template <bool COMPACT>
__device__ __forceinline__ auto own_load(uint32_t* a, int first) {
  if constexpr (COMPACT)
    return SmemLoadFrom{a, first};
  else
    return SmemLoad{a};
}
template <bool COMPACT>
__device__ __forceinline__ auto own_store(uint32_t* a, int first) {
  if constexpr (COMPACT)
    return SmemStoreFrom{a, first};
  else
    return SmemStore{a};
}

template <int H>
__host__ __device__ constexpr int log2_of() {
  static_assert(H >= 1 && H <= 16 && (H & (H - 1)) == 0, "H: a power of two up to 16");
  if constexpr (H == 1)
    return 0;
  else
    return 1 + log2_of<H / 2>();
}

// Forward negacyclic NTT of one row, merged-psi Cooley-Tukey, natural order
// in (through in), bit-reversed order out (through out); a[] holds the
// passes between.  Passes from distance n/2 down.  COMPACT (the compact
// split above): the first pass stores each element into its owner's row,
// a cluster barrier publishes them, and every later pass is local, so
// out() gets positions [h n/H, (h+1) n/H) as in the full-row split.  The
// sweep then begins with a cluster barrier: the peers' rows are written
// in the first pass, so every CTA of the cluster must have started, and
// no peer may still be reading its row (the last pass of an inverse
// before); a caller that hands out() a[] addresses it from h n/H on.
template <int H, bool COMPACT = false, class In, class Out, class Sync>
__device__ __forceinline__ void fwd_ntt_regs_split(uint32_t* a, const RowSplit<H>& sp,
                                                   Sync sync, int logn, uint32_t p,
                                                   const uint32_t* __restrict__ w,
                                                   const uint32_t* __restrict__ w_sh, In in,
                                                   Out out) {
  static_assert(!COMPACT || H > 1, "a compact row is a share of a split row");
  constexpr int logH = log2_of<H>();
  const int h = sp.h;
  const int rem = logn % kRegLog;
  const auto load = own_load<COMPACT>(a, h << (logn - logH));
  const auto store = own_store<COMPACT>(a, h << (logn - logH));
  if constexpr (COMPACT) {
    sync();
    ntt_regs_pass<kRegLog, false>(logn, logn - 1, p, w, w_sh, in, ColumnToOwner<H>{sp}, h,
                                  logH);
  } else {
    ntt_regs_pass<kRegLog, false>(logn, logn - 1, p, w, w_sh, in, SmemStore{a}, h, logH);
  }
  if constexpr (H > 1) sync();
  const auto by_column = [&] {
    if constexpr (COMPACT)
      return load;
    else
      return split_load(sp, a, logn - kRegLog - logH);
  }();
  int logT = logn - 1 - kRegLog;
  int left = logn - kRegLog;            // stages still to run
  const int second = logn < 2 * kRegLog ? left : rem ? rem : kRegLog;
  if (second == left) {
    ntt_regs_any<false>(second, logn, logT, p, w, w_sh, by_column, out, h, logH);
    return;
  }
  ntt_regs_any<false>(second, logn, logT, p, w, w_sh, by_column, store, h, logH);
  logT -= second;
  left -= second;
  for (; left > kRegLog; logT -= kRegLog, left -= kRegLog)
    ntt_regs_pass<kRegLog, false>(logn, logT, p, w, w_sh, load, store, h, logH);
  ntt_regs_pass<kRegLog, false>(logn, logT, p, w, w_sh, load, out, h, logH);
}

// Inverse: Gentleman-Sande, bit-reversed in (through in), natural out,
// each result times n_inv (n^-1, or t * n^-1 with the multiply's tables)
// before out.  Passes from distance 1 up.  COMPACT: every pass but the last
// keeps to the CTA's own row, and the last reads each element from its
// owner's row after the cluster barrier; a[] may not be written again
// before a cluster barrier (a peer may still read it).
template <int H, bool COMPACT = false, class In, class Out, class Sync>
__device__ __forceinline__ void inv_ntt_regs_split(uint32_t* a, const RowSplit<H>& sp,
                                                   Sync sync, int logn, uint32_t p,
                                                   const uint32_t* __restrict__ w,
                                                   const uint32_t* __restrict__ w_sh,
                                                   uint32_t n_inv, uint32_t n_inv_sh, In in,
                                                   Out out) {
  static_assert(!COMPACT || H > 1, "a compact row is a share of a split row");
  constexpr int logH = log2_of<H>();
  const int h = sp.h;
  auto scaled = [&](auto& x, int base, int logs) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(x) / sizeof(x[0])); ++i)
      x[i] = mul_shoup(x[i], n_inv, n_inv_sh, p);
    out(x, base, logs);
  };
  const auto load = own_load<COMPACT>(a, h << (logn - logH));
  const auto store = own_store<COMPACT>(a, h << (logn - logH));
  const auto by_position = [&] {
    if constexpr (COMPACT)
      return ColumnFromOwner<H>{sp};
    else
      return split_load(sp, a, logn - logH);
  }();
  const int rem = logn % kRegLog;
  ntt_regs_pass<kRegLog, true>(logn, kRegLog - 1, p, w, w_sh, in, store, h, logH);
  if (logn < 2 * kRegLog) {
    if constexpr (H > 1) sync();
    // a group of the top pass spans the row's H CTAs: a row split four
    // ways (n = 131072) is never this short
    if constexpr (H <= 2)
      ntt_regs_any<true>(logn - kRegLog, logn, logn - 1, p, w, w_sh, by_position, scaled, h,
                         logH);
    else
      __trap();
    return;
  }
  int lo = kRegLog;                     // the lowest stage not yet run
  if (rem) {
    ntt_regs_any<true>(rem, logn, lo + rem - 1, p, w, w_sh, load, store, h, logH);
    lo += rem;
  }
  for (; lo + kRegLog < logn; lo += kRegLog)
    ntt_regs_pass<kRegLog, true>(logn, lo + kRegLog - 1, p, w, w_sh, load, store, h, logH);
  if constexpr (H > 1) sync();
  ntt_regs_pass<kRegLog, true>(logn, logn - 1, p, w, w_sh, by_position, scaled, h, logH);
}

struct NoSync {
  __device__ __forceinline__ void operator()() const {}
};

// The sweeps of a row that one CTA holds alone.
template <class In, class Out>
__device__ __forceinline__ void fwd_ntt_regs(uint32_t* a, int logn, uint32_t p,
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ w_sh, In in,
                                             Out out) {
  fwd_ntt_regs_split<1>(a, RowSplit<1>{{a}, 0}, NoSync{}, logn, p, w, w_sh, in, out);
}

template <class In, class Out>
__device__ __forceinline__ void inv_ntt_regs(uint32_t* a, int logn, uint32_t p,
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ w_sh,
                                             uint32_t n_inv, uint32_t n_inv_sh, In in,
                                             Out out) {
  inv_ntt_regs_split<1>(a, RowSplit<1>{{a}, 0}, NoSync{}, logn, p, w, w_sh, n_inv, n_inv_sh,
                        in, out);
}

}  // namespace fhe
