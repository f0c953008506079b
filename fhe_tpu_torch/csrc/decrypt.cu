// Fused BFV decryption for Hopper (sm_90a): phase and exact gamma-trick
// scaling in one kernel.
//
// Replaces fhe_tpu/ops/decrypt_pallas.py:decrypt_fused (body _decrypt_kernel).
// Plain version: fhe_tpu_torch/ops/decrypt_cuda.py:decrypt_fused_plain.
//
// For ciphertext row b and each prime i:
//   phase_i = c0_i + INTT_i(NTT_i(c1_i) . s_i)
//   z_i     = [phase_i * gamma*t*(q/q_i)^-1]_{q_i}
//   acc_t  += [z_i * (q/q_i)]_t ;  acc_g += [z_i * (q/q_i)]_gamma
// then m = (s_t - e_hat) * gamma^-1 mod t with s_t = [-acc_t/q]_t,
// s_g = [-acc_g/q]_gamma and e_hat the centred s_g (s_g <= gamma/2 is e >= 0).
//
// Design.  The Pallas grid runs the prime axis in order on one TPU core and
// carries acc_t / acc_g across grid steps in VMEM scratch.  Here each
// ciphertext row is a thread-block cluster of C = min(k, 8) CTAs, grid
// (C, B): CTA r takes the primes r, r + C, ... (more than one where k > 8)
// and adds their terms into its own partial acc_t / acc_g in shared memory
// (3 padded rows: 99 KB at n = 8192, 198 KB at n = 16384; at n = 32768,
// where they would take 396 KB, the WIDE form keeps the two accumulators in
// a global scratch buffer, 2n words per CTA, well inside L2, and shared
// memory holds the working row alone, 132 KB).  The transforms
// are the register-blocked sweep of modmath.cuh with the loads and the
// epilogues fused into their first and last passes: c1 in, the key product
// in the forward transform's last pass, c0 and the two lanes' terms in the
// inverse's.  After a cluster barrier, CTA r owns n / C coefficients: it
// sums the C partials of each through distributed shared memory (mod add is
// exact, so the order does not matter), scales and writes them; a closing
// barrier keeps every CTA's accumulators alive until the peers have read
// them.  One launch, one write of [B, n].  c0 and c1 are read through
// strides, so a ciphertext's [k, 2, n] data goes in as two views, with no
// copy.  The t lane uses the generic Shoup reduction for every t; the
// t = 65537 Fermat fold of the TPU path is an optimisation that gives the
// same bits.
//
// What bounds it on the H100.  At n = 8192, k = 3, B = 1 it reads 192 KB of
// ciphertext, 96 KB of key and 384 KB of twiddle tables and writes 32 KB:
// about 0.2 us by memory rate, and 6.3 M integer instructions (the OPS
// count), 0.2 us at the card's issue rate.  What bounds it is the latency
// of one prime's two transforms on one SM (8 dependent passes, each ended
// by a barrier), with C SMs working at once: 3 for the headline k = 3.
// The register-blocked sweep is what shortens that chain (times: PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "column.cuh"
#include "modmath.cuh"

namespace {

namespace cg = cooperative_groups;

// CTAs per prime's row of the compact form (ops/decrypt_cuda.py: ROW_SPLIT)
constexpr int kRowSplit = 2;

struct DecryptScalars {
  uint32_t t, gamma, gamma_mu;
  uint32_t neg_inv_q_t, neg_inv_q_t_sh, neg_inv_q_g;
  uint32_t inv_gamma_t, inv_gamma_t_sh, gamma_mod_t, one_sh_t;
};

// One prime's constants: z = [phase * gt]_{p} (Shoup), its terms
// [z * pt]_t (Shoup) and [z * pg]_gamma.
struct PrimeTerms {
  uint32_t p, gt, gt_sh, pt, pt_sh, pg;
};

// The two lanes' terms of one coefficient's phase: acc_t += term_t mod t,
// acc_g += term_g mod gamma (first: the accumulators start here).
__device__ __forceinline__ void add_terms(uint32_t phase, const PrimeTerms& c,
                                          const DecryptScalars& sc, bool first,
                                          uint32_t& acc_t, uint32_t& acc_g) {
  const uint32_t z = fhe::mul_shoup(phase, c.gt, c.gt_sh, c.p);
  const uint32_t term_t = fhe::mul_shoup(z, c.pt, c.pt_sh, sc.t);
  const uint32_t term_g = fhe::mul_barrett(fhe::reduce_barrett(z, sc.gamma, sc.gamma_mu), c.pg,
                                           sc.gamma, sc.gamma_mu);
  acc_t = first ? term_t : fhe::add_mod(acc_t, term_t, sc.t);
  acc_g = first ? term_g : fhe::add_mod(acc_g, term_g, sc.gamma);
}

// m = (s_t - e_hat) * gamma^-1 mod t from the summed accumulators.
__device__ __forceinline__ uint32_t scaled_message(uint32_t sum_t, uint32_t sum_g,
                                                   const DecryptScalars& sc) {
  const uint32_t s_t = fhe::mul_shoup(sum_t, sc.neg_inv_q_t, sc.neg_inv_q_t_sh, sc.t);
  const uint32_t s_g = fhe::mul_barrett(sum_g, sc.neg_inv_q_g, sc.gamma, sc.gamma_mu);
  const uint32_t s_g_t = fhe::reduce_shoup(s_g, sc.t, sc.one_sh_t);
  const uint32_t e_mod_t =
      s_g <= (sc.gamma >> 1) ? s_g_t : fhe::sub_mod(s_g_t, sc.gamma_mod_t, sc.t);
  const uint32_t num = fhe::sub_mod(s_t, e_mod_t, sc.t);
  return fhe::mul_shoup(num, sc.inv_gamma_t, sc.inv_gamma_t_sh, sc.t);
}

// The key product of the forward's last pass: a[at + g] = x[g] * s[base + g]
// for the group's consecutive positions (logs = 0, base a multiple of its
// size), the key's words in 16-byte loads.
template <int G>
__device__ __forceinline__ void key_product(const uint32_t (&x)[G], const uint32_t* si, int base,
                                            uint32_t* a, int at, uint32_t p, uint32_t mu) {
  uint32_t sv[G];
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int g = 0; g < G; g += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(si + base + g));
      sv[g] = v.x;
      sv[g + 1] = v.y;
      sv[g + 2] = v.z;
      sv[g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) sv[g] = si[base + g];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) a[fhe::padded_index(at + g)] = fhe::mul_barrett(x[g], sv[g], p, mu);
}

// c0, c1: [k, batch, n] with element strides (prime_stride, batch_stride, 1);
// s: [k, 1, n] NTT form, contiguous; out: [batch, n] mod t.  Grid
// (C, batch) in clusters of (C, 1, 1): CTA r of ciphertext b's cluster takes
// the primes i = r, r + C, ...  Shared memory: three padded rows, the
// working polynomial and the CTA's partial acc_t and acc_g.  WIDE: the
// working polynomial only; CTA r's acc_t at scratch + (b * C + r) * 2n and
// its acc_g n words further.  Each word of them is written and read back
// by one thread for every prime, and the cluster barrier before the
// epilogue publishes them to the peers.
template <bool WIDE>
__global__ void __launch_bounds__(512)
decrypt_fused_kernel(const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
                     long long prime_stride, long long batch_stride,
                     const uint32_t* __restrict__ s, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ p, const uint32_t* __restrict__ mu,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_sh,
                     const uint32_t* __restrict__ ipsi,
                     const uint32_t* __restrict__ ipsi_sh,
                     const uint32_t* __restrict__ n_inv,
                     const uint32_t* __restrict__ n_inv_sh,
                     const uint32_t* __restrict__ gt_inv_phat,
                     const uint32_t* __restrict__ gt_inv_phat_sh,
                     const uint32_t* __restrict__ phat_t,
                     const uint32_t* __restrict__ phat_t_sh,
                     const uint32_t* __restrict__ phat_g, DecryptScalars sc, int k,
                     int logn, uint32_t* scratch) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  const int r = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y;
  // coefficient j of an accumulator at acc[at(j)]; the cluster's in global
  // memory (WIDE), 2n words per CTA
  auto at = [](int j) { return WIDE ? j : fhe::padded_index(j); };
  const int acc_row = WIDE ? n : fhe::padded(n);
  uint32_t* ours = WIDE ? scratch + static_cast<size_t>(b) * csize * 2 * n : nullptr;
  uint32_t* a = sm;
  uint32_t* acc_t = WIDE ? ours + static_cast<size_t>(r) * 2 * n : sm + acc_row;
  uint32_t* acc_g = acc_t + acc_row;
  for (int i = r; i < k; i += csize) {
    const uint32_t pi = p[i];
    const uint32_t mui = mu[i];
    const size_t tab = static_cast<size_t>(i) * n;
    const long long row = i * prime_stride + b * batch_stride;
    // NTT(c1_i) . s_i, the key product fused into the forward's last pass
    const uint32_t* c1r = c1 + row;
    const uint32_t* si = s + tab;
    fhe::fwd_ntt_regs(
        a, logn, pi, psi + tab, psi_sh + tab,
        [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g)
            x[g] = c1r[base + (g << logs)];
        },
        [&](auto& x, int base, int) { key_product(x, si, base, a, base, pi, mui); });
    // INTT, then phase_i, z_i and the two lanes' terms, fused into the
    // inverse's last pass.  Each j reaches out() from the same thread for
    // every prime, so acc_t / acc_g need no barrier between primes.
    const PrimeTerms pc{pi, gt_inv_phat[i], gt_inv_phat_sh[i], phat_t[i], phat_t_sh[i],
                        phat_g[i]};
    const uint32_t* c0r = c0 + row;
    const bool first = i == r;
    fhe::inv_ntt_regs(
        a, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i], fhe::SmemLoad{a},
        [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g) {
            const int j = base + (g << logs);
            const int e = at(j);
            add_terms(fhe::add_mod(c0r[j], x[g], pi), pc, sc, first, acc_t[e], acc_g[e]);
          }
        });
  }
  if constexpr (WIDE) __threadfence();    // the accumulators, to the peers
  cluster.sync();
  // Epilogue: CTA r owns coefficients [r n / C, (r + 1) n / C).  It sums the
  // C partial accumulators of each through distributed shared memory (mod
  // add is exact, so the order does not matter) and scales.
  const int lo = static_cast<int>((static_cast<long long>(r) << logn) / csize);
  const int hi = static_cast<int>((static_cast<long long>(r + 1) << logn) / csize);
#pragma unroll 4
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const int e = at(j);
    uint32_t sum_t = 0, sum_g = 0;
    for (int c = 0; c < csize; ++c) {
      const uint32_t* their_t = WIDE ? ours + static_cast<size_t>(c) * 2 * n
                                     : cluster.map_shared_rank(acc_t, c);
      const uint32_t* their_g = WIDE ? their_t + n : cluster.map_shared_rank(acc_g, c);
      sum_t = fhe::add_mod(sum_t, their_t[e], sc.t);
      sum_g = fhe::add_mod(sum_g, their_g[e], sc.gamma);
    }
    out[static_cast<size_t>(b) * n + j] = scaled_message(sum_t, sum_g, sc);
  }
  // the peers read this CTA's accumulators above: no CTA leaves (and frees
  // its shared memory) before all have
  cluster.sync();
}

// The compact form (n = 65536, where one padded row exceeds a block's
// shared memory): each prime's row is split over a pair of CTAs (H = 2) on
// the compact split of modmath.cuh, a padded half row each (132 KB); at
// n = 131072 over four (H = 4, the quarter split), a padded quarter row
// each.  Cluster of C = H P CTAs per ciphertext row b, P = min(k, 8 / H)
// groups (a portable cluster of 8 at most), grid (C, batch); CTA H q + h
// of group q takes, with its peers, the primes q, q + P, ... in
// ceil(k / P) rounds (a group without a prime in the last round takes the
// three cluster barriers of the peers' transforms).  The inverse's last
// pass hands CTA h the columns [h n/16H, (h+1) n/16H) of the row, element
// base + (g << (log n - 4)) of column base, which it accumulates at
// g n/16H + base - h n/16H of its acc_t and acc_g, n/H words each at
// scratch + (b * C + rank) * 2n/H (and + n/H): the same words from the
// same thread for every prime.  After the cluster barrier, CTA `rank` owns
// coefficients [rank n / C, (rank + 1) n / C) and sums the P partials of
// each (from the groups' CTAs of its column share).
template <int H>
__global__ void __launch_bounds__(512)
decrypt_fused_compact_kernel(const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
                             long long prime_stride, long long batch_stride,
                             const uint32_t* __restrict__ s, uint32_t* __restrict__ out,
                             const uint32_t* __restrict__ p, const uint32_t* __restrict__ mu,
                             const uint32_t* __restrict__ psi,
                             const uint32_t* __restrict__ psi_sh,
                             const uint32_t* __restrict__ ipsi,
                             const uint32_t* __restrict__ ipsi_sh,
                             const uint32_t* __restrict__ n_inv,
                             const uint32_t* __restrict__ n_inv_sh,
                             const uint32_t* __restrict__ gt_inv_phat,
                             const uint32_t* __restrict__ gt_inv_phat_sh,
                             const uint32_t* __restrict__ phat_t,
                             const uint32_t* __restrict__ phat_t_sh,
                             const uint32_t* __restrict__ phat_g, DecryptScalars sc, int k,
                             int logn, uint32_t* scratch) {
  extern __shared__ uint32_t a[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  constexpr int logH = fhe::log2_of<H>();
  const int half = n / H;                        // a CTA's share of the row
  const int cta_words = n / (H / kRowSplit);     // a CTA's acc_t and acc_g
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int pairs = csize / H;
  const int q = rank / H, h = rank % H;
  const int b = blockIdx.y;
  const int first = h * half;                    // a[]'s first position
  const int logc = logn - fhe::kRegLog - logH;   // log2 of a CTA's columns, n/16H
  uint32_t* ours = scratch + static_cast<size_t>(b) * csize * cta_words;
  uint32_t* acc_t = ours + static_cast<size_t>(rank) * cta_words;
  uint32_t* acc_g = acc_t + half;
  const auto split = fhe::row_split<H>(cluster, a, q * H, h);
  auto sync = [&] { cluster.sync(); };
  const int rounds = (k + pairs - 1) / pairs;
  for (int m = 0; m < rounds; ++m) {
    const int i = q + m * pairs;
    if (i >= k) {
      // the barriers inside the peers' forward (2) and inverse (1)
      cluster.sync();
      cluster.sync();
      cluster.sync();
      continue;
    }
    const uint32_t pi = p[i];
    const uint32_t mui = mu[i];
    const size_t tab = static_cast<size_t>(i) * n;
    const long long row = i * prime_stride + b * batch_stride;
    const uint32_t* c1r = c1 + row;
    const uint32_t* si = s + tab;
    fhe::fwd_ntt_regs_split<H, true>(
        a, split, sync, logn, pi, psi + tab, psi_sh + tab,
        [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g)
            x[g] = c1r[base + (g << logs)];
        },
        [&](auto& x, int base, int) { key_product(x, si, base, a, base - first, pi, mui); });
    const PrimeTerms pc{pi, gt_inv_phat[i], gt_inv_phat_sh[i], phat_t[i], phat_t_sh[i],
                        phat_g[i]};
    const uint32_t* c0r = c0 + row;
    fhe::inv_ntt_regs_split<H, true>(
        a, split, sync, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i],
        fhe::SmemLoadFrom{a, first}, [&](auto& x, int base, int logs) {
          // a column group: base in [h n/16H, (h+1) n/16H), logs = log n - 4
          const int col = base - (h << logc);
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g) {
            const int e = (g << logc) + col;
            add_terms(fhe::add_mod(c0r[base + (g << logs)], x[g], pi), pc, sc, m == 0,
                      acc_t[e], acc_g[e]);
          }
        });
  }
  __threadfence();    // the accumulators, to the peers
  cluster.sync();
  const int lo = static_cast<int>((static_cast<long long>(rank) << logn) / csize);
  const int hi = static_cast<int>((static_cast<long long>(rank + 1) << logn) / csize);
#pragma unroll 4
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    // coefficient j: column j mod n/16 of CTA hj of every group, at e
    const int cols = j & ((H << logc) - 1);
    const int hj = cols >> logc;
    const int e = ((j >> (logc + logH)) << logc) + (cols & ((1 << logc) - 1));
    uint32_t sum_t = 0, sum_g = 0;
    for (int c = 0; c < pairs; ++c) {
      const uint32_t* their_t = ours + static_cast<size_t>(c * H + hj) * cta_words;
      sum_t = fhe::add_mod(sum_t, their_t[e], sc.t);
      sum_g = fhe::add_mod(sum_g, their_t[half + e], sc.gamma);
    }
    out[static_cast<size_t>(b) * n + j] = scaled_message(sum_t, sum_g, sc);
  }
  // the partners read this CTA's row in the inverse's last pass: no CTA
  // leaves (and frees its shared memory) before all have
  cluster.sync();
}

// The column form (n >= 262144, csrc/column.cuh): ntt.cu's column launch
// of c1 and its block_mul_kernel (w = s) leave the block stages of
// NTT(c1_i) . s_i in x ([k, 1, B, n]); this launch runs, for a tile of
// columns of ciphertext row b, each prime's last inverse stages, times
// n^-1, adds c0 and folds the prime's two terms into the tile's acc_t and
// acc_g (each word by one thread for every prime), then scales them.  One
// launch of B n / W CTAs, no cluster, one write of [B, n].  Grid (b / C,
// B); shared memory: the tile and its two accumulators, 3 W words.
__global__ void __launch_bounds__(256)
decrypt_column_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ c0,
                      long long prime_stride, long long batch_stride,
                      uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
                      const uint32_t* __restrict__ ipsi, const uint32_t* __restrict__ ipsi_sh,
                      const uint32_t* __restrict__ n_inv,
                      const uint32_t* __restrict__ n_inv_sh,
                      const uint32_t* __restrict__ gt_inv_phat,
                      const uint32_t* __restrict__ gt_inv_phat_sh,
                      const uint32_t* __restrict__ phat_t,
                      const uint32_t* __restrict__ phat_t_sh,
                      const uint32_t* __restrict__ phat_g, DecryptScalars sc, int k, int logn,
                      int logb, int logc) {
  extern __shared__ uint32_t t[];
  const int n = 1 << logn;
  const int b = blockIdx.y, batch = gridDim.y;
  const fhe::ColumnTile tile = fhe::column_tile(logn, logb, logc);
  uint32_t* acc_t = t + tile.words();
  uint32_t* acc_g = acc_t + tile.words();
  for (int i = 0; i < k; ++i) {
    const uint32_t pi = p[i], ni = n_inv[i], ni_sh = n_inv_sh[i];
    const size_t tab = static_cast<size_t>(i) * n;
    const uint32_t* xr = x + (static_cast<size_t>(i) * batch + b) * n;
    const uint32_t* c0r = c0 + i * prime_stride + b * batch_stride;
    const PrimeTerms pc{pi, gt_inv_phat[i], gt_inv_phat_sh[i], phat_t[i], phat_t_sh[i],
                        phat_g[i]};
    fhe::column_load(t, tile, [&](int j) { return xr[j]; });
    fhe::column_inverse(t, tile, pi, ipsi + tab, ipsi_sh + tab);
    fhe::column_store(t, tile, [&](int j, uint32_t v, int e) {
      add_terms(fhe::add_mod(c0r[j], fhe::mul_shoup(v, ni, ni_sh, pi), pi), pc, sc, i == 0,
                acc_t[e], acc_g[e]);
    });
    __syncthreads();    // the next prime's load overwrites the tile
  }
  fhe::column_store(t, tile, [&](int j, uint32_t, int e) {
    out[static_cast<size_t>(b) * n + j] = scaled_message(acc_t[e], acc_g[e], sc);
  });
}

}  // namespace

// The launch geometry comes from the wrapper (ops/decrypt_cuda.py,
// decrypt_geometry): clusters of `cluster` CTAs (1 <= cluster <= min(k, 8)),
// `threads` per CTA and `smem` bytes per CTA, at least the three padded rows
// the kernel uses; a scratch buffer (2n words per CTA) picks the WIDE form,
// which uses one; `compact` = H (2 or 4) with a scratch buffer (2n/H words
// per CTA) the compact form, clusters of H min(k, 8/H) CTAs and a padded
// 1/H row each.
extern "C" int fhe_decrypt_fused(
    const void* c0, const void* c1, long long prime_stride, long long batch_stride,
    const void* s, void* out, const void* p,
    const void* mu, const void* psi, const void* psi_sh, const void* ipsi,
    const void* ipsi_sh, const void* n_inv, const void* n_inv_sh,
    const void* gt_inv_phat, const void* gt_inv_phat_sh, const void* phat_t,
    const void* phat_t_sh, const void* phat_g, uint32_t t, uint32_t gamma,
    uint32_t gamma_mu, uint32_t neg_inv_q_t, uint32_t neg_inv_q_t_sh,
    uint32_t neg_inv_q_g, uint32_t inv_gamma_t, uint32_t inv_gamma_t_sh,
    uint32_t gamma_mod_t, uint32_t one_sh_t, int k, int batch, int logn, int cluster,
    int threads, int smem, void* scratch, int compact, void* stream) {
  const bool wide = scratch != nullptr;
  const int n = 1 << logn;
  if (logn <= fhe::kRegLog || cluster < 1 || cluster > 8
      || (compact ? (compact != 2 && compact != 4) || !wide || cluster % compact
                        || cluster > compact * k || smem < 4 * fhe::padded(n / compact)
                  : cluster > k || smem < (wide ? 1 : 3) * 4 * fhe::padded(n)))
    return static_cast<int>(cudaErrorInvalidValue);
  // each form keeps its own records
  static std::atomic<size_t> granted[4][fhe::kMaxDevices];
  static std::atomic<size_t> placed[4][fhe::kMaxDevices];
  const int form = compact == 4 ? 3 : compact ? 2 : wide ? 1 : 0;
  auto* fn = compact == 4 ? &decrypt_fused_compact_kernel<4>
             : compact    ? &decrypt_fused_compact_kernel<kRowSplit>
             : wide       ? &decrypt_fused_kernel<true>
                          : &decrypt_fused_kernel<false>;
  const void* kernel = reinterpret_cast<const void*>(fn);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(cluster, batch), threads, smem, cluster, static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed[form]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecryptScalars sc{t, gamma, gamma_mu, neg_inv_q_t, neg_inv_q_t_sh,
                          neg_inv_q_g, inv_gamma_t, inv_gamma_t_sh, gamma_mod_t,
                          one_sh_t};
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(
      &cfg, fn, u(c0), u(c1),
      prime_stride, batch_stride, u(s), static_cast<uint32_t*>(out), u(p), u(mu), u(psi),
      u(psi_sh), u(ipsi), u(ipsi_sh), u(n_inv), u(n_inv_sh), u(gt_inv_phat),
      u(gt_inv_phat_sh), u(phat_t), u(phat_t_sh), u(phat_g), sc, k, logn,
      static_cast<uint32_t*>(scratch));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// decrypt_fused's column launch (ops/column_cuda.py gives its shape: a block
// of 2^logb positions, tiles of 2^logc columns, `threads` per CTA); x the
// block launch's [k, 1, B, n], the rest as fhe_decrypt_fused takes them.
extern "C" int fhe_decrypt_column(
    const void* x, const void* c0, long long prime_stride, long long batch_stride, void* out,
    const void* p, const void* ipsi, const void* ipsi_sh, const void* n_inv,
    const void* n_inv_sh, const void* gt_inv_phat, const void* gt_inv_phat_sh,
    const void* phat_t, const void* phat_t_sh, const void* phat_g, uint32_t t, uint32_t gamma,
    uint32_t gamma_mu, uint32_t neg_inv_q_t, uint32_t neg_inv_q_t_sh, uint32_t neg_inv_q_g,
    uint32_t inv_gamma_t, uint32_t inv_gamma_t_sh, uint32_t gamma_mod_t, uint32_t one_sh_t,
    int k, int batch, int logn, int logb, int logc, int threads, void* stream) {
  if (!fhe::column_args_ok(logn, logb, logc) || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecryptScalars sc{t, gamma, gamma_mu, neg_inv_q_t, neg_inv_q_t_sh,
                          neg_inv_q_g, inv_gamma_t, inv_gamma_t_sh, gamma_mod_t,
                          one_sh_t};
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  return static_cast<int>(fhe::PlainLaunch<&decrypt_column_kernel>{}(
      dim3(1 << (logb - logc), batch), threads, 3 * (4 << (logn - logb + logc)),
      static_cast<cudaStream_t>(stream), u(x), u(c0), prime_stride, batch_stride,
      static_cast<uint32_t*>(out), u(p), u(ipsi), u(ipsi_sh), u(n_inv), u(n_inv_sh),
      u(gt_inv_phat), u(gt_inv_phat_sh), u(phat_t), u(phat_t_sh), u(phat_g), sc, k, logn, logb,
      logc));
}
