// BEHZ base-conversion kernels of the ciphertext multiply for Hopper (sm_90a).
//
// Replaces fhe_tpu/ops/rns_pallas.py: bsk_branch_fused (body
// _bsk_branch_kernel), fast_bconv_sk_fused (body _sk_kernel) and the n < 1024
// multiply's fast_floor_fused (body _floor_kernel).  Plain versions:
// fhe_tpu_torch/ops/rns.py (bsk_branch_fused and bsk_branch_fused_batch,
// fast_bconv_sk, fast_floor).  The n < 1024 multiply's sm_mrq_fused is the
// Lift lane of tensor_product (csrc/ntt.cu), with the lift of csrc/lift.cuh
// that bsk_branch_fused runs too.  The JAX multiply_batch runs the Bsk
// branch as vmapped jnp chains around tensor_product_batch; here it is this
// one kernel with a batch grid axis, which computes the same residues.
//
// bsk_branch_fused, for element b and Bsk prime c_j (B = 1 for the single
// multiply, the batch size for multiply_batch):
//   1. SmMRq lift of the four rows a0, a1, b0, b1 from q into c_j
//      (csrc/lift.cuh);
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
// fast_bconv_sk_fused, the exact Shenoy-Kumaresan conversion Bsk -> q, and
// fast_floor_fused, the FastFloor step of bsk_branch_fused on its own, are
// lanes of one kernel template, base_conv_kernel<Lane, V, KB>.  Both are
// elementwise over coefficients with sums over the source primes, and the
// TPU kernels (grid over destination primes) formed every source digit again
// for each destination prime: k times over for the conversion to q, kb times
// for the floor.  Here one thread owns V consecutive coefficients of every
// row: it forms each source digit once, keeps the digits in registers (KB,
// the Bsk prime count, is a template parameter, so their arrays are indexed
// at compile time) and loops over the destination primes.  The lanes are
// template parameters: SK (Bsk -> q; given the relinearization's inv_qhat it
// also stores the gadget digits [c2_j * (q/q_j)^-1]_{q_j} of the c2 rows
// beside them, which spares the multiply a chain of elementwise launches),
// Floor (t*x in q and in Bsk -> floor(t*x/q) in Bsk) and FloorSK (the floor
// into every Bsk prime, its residues kept in registers and converted to q
// at once: the n < 1024 multiply's floor and conversion in one launch).  The
// lanes' constant tables (a few hundred words) are staged once per CTA in
// shared memory while the thread's input words are in flight.
//
// Every digit of the floor and the conversions is a residue mod its own
// source prime and may exceed the destination prime (m_sk and several aux
// primes are below some q_i), so every product with a digit is a Shoup
// multiply, exact for any x < 2^32, or (base_conv_kernel) an unreduced
// 64-bit product of two words below 2^30; mul_barrett only ever sees
// reduced operands.
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
// base_conv_kernel moves little: fast_bconv_sk_fused at [5, 3, 8192] reads
// 480 KB and writes 288 KB (0.23 us by memory rate), so one launch of it is
// bound by launch latency; at [10, 24, 8192] (the k = 8 multiply_batch) it
// reads 7.9 MB and writes 6.3 MB, and there the memory rate and the digit
// arithmetic bound it, which forming each digit once cuts k-fold.  The
// n < 1024 multiply gives the FloorSK lane 1.5 K coefficients or fewer: it
// is bound by launch latency.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "lift.cuh"
#include "modmath.cuh"

namespace {

namespace cg = cooperative_groups;

// CTAs per input row of bsk_branch_fused (ops/rns_cuda.py: BSK_ROW_SPLIT)
constexpr int kRowSplit = 2;

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
  // 1. SmMRq lift of row r into c_j (lift.cuh's steps), fused into the
  // forward transform's first pass: a group of coefficients at once,
  // source prime by source prime, so that a thread has a whole group's
  // loads in flight
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
        fhe::sm_mrq_step(si[g << logs], qi, w, w_sh, ph, ph_sh, pm, c, conv[g], lane[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      x[g] = fhe::sm_mrq_close(conv[g], lane[g], inv_q_mt, c, qc, qc_sh, imt, imt_sh);
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

// The base-conversion kernel: fast_bconv_sk_fused (lane SK, with or without
// the digits lane) and fast_floor_fused (lane Floor alone, and lane FloorSK,
// the floor with the Shenoy-Kumaresan conversion after it).  One thread owns
// V consecutive coefficients of every row: it forms each source digit once
// and reuses it for every destination prime.  A conversion sum
// sum_i y_i * w_i mod c of L <= 16 digits y_i < 2^30 and table words
// w_i < 2^30 accumulates unreduced in 64 bits (one IMAD.WIDE a term) and is
// reduced once (fhe::reduce_wide): the Shoup product and modular add per
// term of the TPU kernels' form take ten instructions, and the sum in that
// form is one dependent chain of modular adds.
enum Lane : int { kLaneSK = 0, kLaneFloor = 1, kLaneFloorSK = 2 };

// Bsk bases the kernel is instantiated for (KB primes: KB - 1 aux + m_sk;
// the aux sum has KB - 1 <= 16 terms), and the most q primes the floor
// sums; ops/rns_cuda.py (CONV_KB, CONV_MAX_FLOOR_K) checks a call against
// them.
constexpr int kMinKb = 2;
constexpr int kMaxKb = 17;
constexpr int kMaxFloorK = 16;

// The lanes' constants: pointers to the wrapper's per-prime tensors
// (ops/rns.py SKConsts, FastFloorConsts, the relinearization's inv_qhat),
// passed by value.  A lane stages what it reads in shared memory, so every
// thread reads each table word from there, not from global memory.
struct ConvConsts {
  const uint32_t* aux;              // [L] aux primes b_i (Bsk = aux + m_sk)
  const uint32_t* aux_inv_phat;     // [L] (B/b_i)^-1 mod b_i, Shoup
  const uint32_t* aux_inv_phat_sh;
  const uint32_t* phat_q;           // [k, L] (B/b_i) mod q_j
  const uint32_t* phat_sk;          // [L] (B/b_i) mod m_sk
  const uint32_t* q;                // [k] SK destination primes
  const uint32_t* q_wide;           // [k, 3] 2^32 mod q_j, Shoup, floor(2^32/q_j)
  const uint32_t* msk_wide;         // [1, 3] the same for m_sk
  const uint32_t* b_mod_q;          // [k] B mod q_j, Shoup
  const uint32_t* b_mod_q_sh;
  const uint32_t* w;                // [k] digits: (q/q_j)^-1 mod q_j, Shoup
  const uint32_t* w_sh;
  const uint32_t* fq;               // [k] floor source primes
  const uint32_t* f_inv_phat;       // [k] (q/q_i)^-1 mod q_i, Shoup
  const uint32_t* f_inv_phat_sh;
  const uint32_t* f_phat;           // [KB, k] (q/q_i) mod c_j
  const uint32_t* cp;               // [KB] floor destination primes
  const uint32_t* c_wide;           // [KB, 3] as q_wide
  const uint32_t* inv_q_c;          // [KB] q^-1 mod c_j, Shoup
  const uint32_t* inv_q_c_sh;
  uint32_t m_sk, inv_b, inv_b_sh;   // B^-1 mod m_sk, Shoup
  int k;
};

// Where a lane's staged constants lie in shared memory: 16-byte quads
// (p, 2^32 mod p, its Shoup companion, floor(2^32/p)) of the destination
// primes, then 8-byte pairs (value, Shoup companion), then single words.
// Offsets in quads, pairs and words.
struct ConvSmem {
  int qw, cw, quads;
  int ainv, bq, w, finv, iq, pairs;
  int phq, psk, fph, aux, fq, words;
  __host__ __device__ ConvSmem(int lane, int k, int kb, bool digits) {
    const bool sk = lane != kLaneFloor, fl = lane != kLaneSK;
    const int l = kb - 1;
    int u = 0;
    qw = u;   u += sk ? k + 1 : 0;      // the k q primes, then m_sk
    cw = u;   u += fl ? kb : 0;
    quads = u;
    int p = 0;
    ainv = p; p += sk ? l : 0;
    bq = p;   p += sk ? k : 0;
    w = p;    p += sk && digits ? k : 0;
    finv = p; p += fl ? k : 0;
    iq = p;   p += fl ? kb : 0;
    pairs = p;
    int o = 0;
    phq = o;  o += sk ? k * l : 0;
    psk = o;  o += sk ? l : 0;
    fph = o;  o += fl ? kb * k : 0;
    aux = o;  o += sk ? l : 0;
    fq = o;   o += fl ? k : 0;
    words = o;
  }
  __host__ __device__ size_t bytes() const {
    return 16 * static_cast<size_t>(quads) + 8 * pairs + 4 * words;
  }
};

__device__ __forceinline__ void stage_quads(uint4* dst, const uint32_t* p, const uint32_t* wide,
                                            int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x)
    dst[t] = make_uint4(p[t], wide[3 * t], wide[3 * t + 1], wide[3 * t + 2]);
}

__device__ __forceinline__ void stage_pairs(uint2* dst, const uint32_t* v, const uint32_t* sh,
                                            int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = make_uint2(v[t], sh[t]);
}

__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* v, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = v[t];
}

// V consecutive words at p: one 8-byte access where `vec` says p is aligned
// to it, else a word at a time.
template <int V>
__device__ __forceinline__ void load_words(uint32_t (&x)[V], const uint32_t* p, bool vec) {
  if constexpr (V == 2) {
    if (vec) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      x[0] = u.x; x[1] = u.y;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = p[v];
}

// The outputs the wrapper allocates start 16-byte aligned, and every offset
// a thread stores at is a multiple of V words.
template <int V>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// Lane SK: src [KB, count] (the L = KB - 1 aux rows, then the m_sk row),
// out [k, count] in q; with the digits lane (dig not null), also
// dig [k, count - dstart]: the digits [out_j * (q/q_j)^-1]_{q_j} of the
// words from dstart on (the c2 rows, component-major).  Lane Floor: src
// [k, count] the residues of t*x in q, txb [KB, count] those in Bsk, out
// [KB, count] = (txb - conv(src)) * q^-1.  Lane FloorSK: the floored
// residues stay in registers and go through lane SK, out [k, count] (and
// dig).  Thread t of block b owns words e .. e + V - 1, e = (b * blockDim
// + t) * V, of every row.  The wrapper keeps every offset below 2^31.
template <int LaneT, int V, int KB>
__global__ void __launch_bounds__(256)
base_conv_kernel(const uint32_t* __restrict__ src, const uint32_t* __restrict__ txb,
                 uint32_t* __restrict__ out, uint32_t* __restrict__ dig, const ConvConsts cc,
                 int count, int dstart, int vec) {
  constexpr int L = KB - 1;
  constexpr bool kSK = LaneT != kLaneFloor;
  constexpr bool kFloor = LaneT != kLaneSK;
  extern __shared__ uint4 conv_quads[];
  const int k = cc.k;
  const bool digits = kSK && dig != nullptr;
  const ConvSmem lay(LaneT, k, KB, digits);
  uint2* pairs = reinterpret_cast<uint2*>(conv_quads + lay.quads);
  uint32_t* words = reinterpret_cast<uint32_t*>(pairs + lay.pairs);
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool active = e < count;
  // 1. this thread's KB rows first (the aux and m_sk rows, or t*x in Bsk),
  // so that their loads are in flight while the constants are staged
  const uint32_t* rows = kFloor ? txb : src;
  uint32_t x[KB][V];
  if (active) {
#pragma unroll
    for (int r = 0; r < KB; ++r) load_words<V>(x[r], rows + r * count + e, vec);
  }
  if constexpr (kSK) {
    stage_quads(conv_quads + lay.qw, cc.q, cc.q_wide, k);
    if (threadIdx.x == 0)
      conv_quads[lay.qw + k] = make_uint4(cc.m_sk, cc.msk_wide[0], cc.msk_wide[1],
                                          cc.msk_wide[2]);
    stage_pairs(pairs + lay.ainv, cc.aux_inv_phat, cc.aux_inv_phat_sh, L);
    stage_pairs(pairs + lay.bq, cc.b_mod_q, cc.b_mod_q_sh, k);
    if (digits) stage_pairs(pairs + lay.w, cc.w, cc.w_sh, k);
    stage_words(words + lay.phq, cc.phat_q, k * L);
    stage_words(words + lay.psk, cc.phat_sk, L);
    stage_words(words + lay.aux, cc.aux, L);
  }
  if constexpr (kFloor) {
    stage_quads(conv_quads + lay.cw, cc.cp, cc.c_wide, KB);
    stage_pairs(pairs + lay.finv, cc.f_inv_phat, cc.f_inv_phat_sh, k);
    stage_pairs(pairs + lay.iq, cc.inv_q_c, cc.inv_q_c_sh, KB);
    stage_words(words + lay.fph, cc.f_phat, KB * k);
    stage_words(words + lay.fq, cc.fq, k);
  }
  __syncthreads();
  if (!active) return;
  const uint2* ainv = pairs + lay.ainv;
  const uint32_t* aux = words + lay.aux;
  uint32_t y[L][V];   // the aux digits [x_i * (B/b_i)^-1]_{b_i}
  uint32_t xm[V];     // the m_sk residue
  if constexpr (kFloor) {
    // 2a. FastFloor into all KB primes: each digit of t*x in q once, its
    // products with every Bsk prime's table word summed unreduced
    const uint4* cw = conv_quads + lay.cw;
    const uint2* finv = pairs + lay.finv;
    const uint2* iq = pairs + lay.iq;
    const uint32_t* fph = words + lay.fph;
    const uint32_t* fq = words + lay.fq;
    uint64_t acc[KB][V];
#pragma unroll
    for (int c = 0; c < KB; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] = 0;
    // the k <= kMaxFloorK source rows: every load in flight at once
    uint32_t t[kMaxFloorK][V];
#pragma unroll
    for (int i = 0; i < kMaxFloorK; ++i)
      if (i < k) load_words<V>(t[i], src + i * count + e, vec);
#pragma unroll
    for (int i = 0; i < kMaxFloorK; ++i) {
      if (i >= k) break;
      const uint2 fi = finv[i];
      const uint32_t qi = fq[i];
#pragma unroll
      for (int v = 0; v < V; ++v) t[i][v] = fhe::mul_shoup(t[i][v], fi.x, fi.y, qi);
#pragma unroll
      for (int c = 0; c < KB; ++c) {
        const uint32_t ph = fph[c * k + i];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[c][v] += static_cast<uint64_t>(t[i][v]) * ph;
      }
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      const uint4 pw = cw[c];
      const uint2 iqc = iq[c];
      uint32_t fl[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        fl[v] = fhe::mul_shoup(fhe::sub_mod(x[c][v], fhe::reduce_wide(acc[c][v], pw), pw.x),
                               iqc.x, iqc.y, pw.x);
      if constexpr (LaneT == kLaneFloor) {
        store_words<V>(out + c * count + e, fl);
      } else if (c < L) {
        // 2b. the floored residue goes straight into its aux digit
#pragma unroll
        for (int v = 0; v < V; ++v) y[c][v] = fhe::mul_shoup(fl[v], ainv[c].x, ainv[c].y, aux[c]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xm[v] = fl[v];
      }
    }
    if constexpr (LaneT == kLaneFloor) return;
  } else {
    // 2. the aux digits, once per coefficient
#pragma unroll
    for (int i = 0; i < L; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) y[i][v] = fhe::mul_shoup(x[i][v], ainv[i].x, ainv[i].y, aux[i]);
#pragma unroll
    for (int v = 0; v < V; ++v) xm[v] = x[L][v];
  }
  if constexpr (kSK) {
    // 3. alpha = (conv_sk - x_msk) * B^-1 mod m_sk, once per coefficient
    const uint4* qw = conv_quads + lay.qw;
    const uint32_t* psk = words + lay.psk;
    const uint4 mw = qw[k];
    const uint32_t msk = mw.x;
    uint32_t alpha[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint64_t s = 0;
#pragma unroll
      for (int i = 0; i < L; ++i) s += static_cast<uint64_t>(y[i][v]) * psk[i];
      alpha[v] = fhe::mul_shoup(fhe::sub_mod(fhe::reduce_wide(s, mw), xm[v], msk), cc.inv_b,
                                cc.inv_b_sh, msk);
    }
    // 4. every destination prime q_j from the same digits: the conversion,
    // the centred correction alpha * B, and the relinearization digit
    const uint32_t* phq = words + lay.phq;
    const uint2* bq = pairs + lay.bq;
    const uint2* wd = pairs + lay.w;
    const bool dig_word = digits && e >= dstart;
    const int dcount = count - dstart;
    for (int j = 0; j < k; ++j) {
      const uint4 pw = qw[j];
      const uint32_t qj = pw.x;
      const uint32_t* ph = phq + j * L;
      const uint2 b = bq[j];
      uint32_t o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint64_t s = 0;
#pragma unroll
        for (int i = 0; i < L; ++i) s += static_cast<uint64_t>(y[i][v]) * ph[i];
        // centred alpha mod q_j: alpha itself, or q_j - (m_sk - alpha)
        const uint32_t aq = alpha[v] <= (msk >> 1) ? alpha[v] : qj - (msk - alpha[v]);
        o[v] = fhe::sub_mod(fhe::reduce_wide(s, pw), fhe::mul_shoup(aq, b.x, b.y, qj), qj);
      }
      store_words<V>(out + j * count + e, o);
      if (dig_word) {
        const uint2 wj = wd[j];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = fhe::mul_shoup(o[v], wj.x, wj.y, qj);
        store_words<V>(dig + j * dcount + (e - dstart), o);
      }
    }
  }
}

// The instance for kb Bsk primes, or null outside [kMinKb, kMaxKb].
template <int LaneT, int V, int KB = kMinKb>
const void* conv_kernel(int kb) {
  if constexpr (KB > kMaxKb) {
    return nullptr;
  } else {
    return kb == KB ? reinterpret_cast<const void*>(base_conv_kernel<LaneT, V, KB>)
                    : conv_kernel<LaneT, V, KB + 1>(kb);
  }
}

// The lanes and words per thread the wrapper may ask for: SK at 1 or 2, the
// floor lanes at 1 (ops/rns_cuda.py: conv_geometry).
const void* pick_conv_kernel(int lane, int per_thread, int kb) {
  switch (lane * 8 + per_thread) {
    case kLaneSK * 8 + 1: return conv_kernel<kLaneSK, 1>(kb);
    case kLaneSK * 8 + 2: return conv_kernel<kLaneSK, 2>(kb);
    case kLaneFloor * 8 + 1: return conv_kernel<kLaneFloor, 1>(kb);
    case kLaneFloorSK * 8 + 1: return conv_kernel<kLaneFloorSK, 1>(kb);
    default: return nullptr;
  }
}

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

// One launch of base_conv_kernel: lane (kLaneSK, kLaneFloor, kLaneFloorSK),
// per_thread words per thread, kb Bsk primes, k q primes, count words per
// row, the digits from word dstart on (dig null: no digits lane), vec where
// every input row starts aligned to per_thread words, threads per CTA (the
// wrapper's conv_geometry).  Unused constants may be null.
int fhe_base_conv(int lane, int per_thread, int kb, int k, int count, int dstart, int vec,
                  int threads, const void* src, const void* txb, void* out, void* dig,
                  const void* aux, const void* aux_inv_phat, const void* aux_inv_phat_sh,
                  const void* phat_q, const void* phat_sk, const void* q, const void* q_wide,
                  const void* msk_wide, const void* b_mod_q, const void* b_mod_q_sh,
                  const void* w, const void* w_sh, const void* fq, const void* f_inv_phat,
                  const void* f_inv_phat_sh, const void* f_phat, const void* cp,
                  const void* c_wide, const void* inv_q_c, const void* inv_q_c_sh,
                  uint32_t m_sk, uint32_t inv_b, uint32_t inv_b_sh, void* stream) {
  const void* kernel = pick_conv_kernel(lane, per_thread, kb);
  if (kernel == nullptr || k < 1 || count < 1 || count % per_thread || threads < 32
      || threads > 256 || (lane != kLaneSK && k > kMaxFloorK))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvSmem lay(lane, k, kb, dig != nullptr);
  if (lay.bytes() > fhe::kDefaultSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  ConvConsts cc{u(aux), u(aux_inv_phat), u(aux_inv_phat_sh), u(phat_q), u(phat_sk), u(q),
                u(q_wide), u(msk_wide), u(b_mod_q), u(b_mod_q_sh), u(w), u(w_sh), u(fq),
                u(f_inv_phat), u(f_inv_phat_sh), u(f_phat), u(cp), u(c_wide), u(inv_q_c),
                u(inv_q_c_sh), m_sk, inv_b, inv_b_sh, k};
  const uint32_t* src_p = u(src);
  const uint32_t* txb_p = u(txb);
  uint32_t* out_p = static_cast<uint32_t*>(out);
  uint32_t* dig_p = static_cast<uint32_t*>(dig);
  void* args[] = {&src_p, &txb_p, &out_p, &dig_p, &cc, &count, &dstart, &vec};
  const int groups = count / per_thread;
  const dim3 grid((groups + threads - 1) / threads);
  const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(threads), args, lay.bytes(),
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
