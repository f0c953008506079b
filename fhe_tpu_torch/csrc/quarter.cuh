// The cluster tensor product on the quarter split (n = 131072), shared by
// ntt.cu's tensor_product_quarter_kernel and rns.cu's
// bsk_branch_quarter_kernel.
//
// At n = 131072 even the compact split's padded half row (264 KB) exceeds a
// block's shared memory, so four CTAs share each row (modmath.cuh's compact
// split with H = 4: CTA h holds positions [h n/4, (h+1) n/4), a padded
// quarter row, 132 KB).  Four input rows of four CTAs would be a cluster of
// 16, past the portable 8, so the product keeps the portable cluster of 8
// CTAs per (element, prime) and runs its rows in rounds: CTA 4s + h is CTA h
// of slot s (s = 0, 1).  In forward round m slot s transforms input row
// 2m + s (x0, x1, then y0, y1), and CTA h stores its quarter of the
// NTT-form row in `ours`, the cluster's 4n words of global scratch, row r
// at ours + r n, unpadded.  After a __threadfence and a cluster barrier the
// three product rows take two inverse rounds: in round m slot s forms
// product row r = 2m + s (r < 3) of its quarter from the scratch rows into
// its working row, consecutive threads on consecutive words, and runs the
// row's inverse transform; in the last round slot 1 has no row and takes
// the inverse's barrier.  Every forward begins with a cluster barrier (the
// compact split's), and a cluster barrier between the inverse rounds keeps
// a working row alive until its slot's peers have read it in the inverse's
// last pass.  So a CTA runs two forwards and up to two inverses in series
// where the pair split's CTA runs one of each: the price of a portable
// cluster (a cluster of 16 would hold 16 x 132 KB of shared memory at once).
#pragma once

#include "modmath.cuh"

namespace fhe {

// CTAs per row of the quarter split
constexpr int kQuarterSplit = 4;

// The product of one (element, prime) cluster: `in(r, x, base, logs)`
// fills a forward first-pass group of input row r (0..3: x0, x1, y0, y1),
// `out(r, x, base, logs)` takes an inverse last-pass group of product row r
// (0..2), already times n_inv.  work: the CTA's padded quarter row; ours:
// the cluster's scratch rows; p, mu and the tables of the cluster's prime.
template <class Cluster, class In, class Out>
__device__ __forceinline__ void quarter_product(Cluster cluster, uint32_t* work,
                                                uint32_t* ours, int logn, uint32_t p,
                                                uint32_t mu, const uint32_t* __restrict__ psi,
                                                const uint32_t* __restrict__ psi_sh,
                                                const uint32_t* __restrict__ ipsi,
                                                const uint32_t* __restrict__ ipsi_sh,
                                                uint32_t n_inv, uint32_t n_inv_sh, In in,
                                                Out out) {
  constexpr int H = kQuarterSplit;
  const int n = 1 << logn;
  const int share = n / H;
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = rank / H, h = rank % H;
  const int first = h * share;               // work[]'s first position
  const RowSplit<H> split = row_split<H>(cluster, work, s * H, h);
  auto sync = [&] { cluster.sync(); };
  for (int m = 0; m < 2; ++m) {
    const int r = 2 * m + s;
    uint32_t* row = ours + static_cast<size_t>(r) * n;
    fwd_ntt_regs_split<H, true>(
        work, split, sync, logn, p, psi, psi_sh,
        [&](auto& x, int base, int logs) { in(r, x, base, logs); },
        // the last pass's group is consecutive (logs = 0)
        [&](auto& x, int base, int) { store_run(row, base, x); });
  }
  __threadfence();    // the transformed rows, to the peers
  cluster.sync();
  const uint32_t* x0 = ours;
  const uint32_t* x1 = x0 + n;
  const uint32_t* y0 = x1 + n;
  const uint32_t* y1 = y0 + n;
  for (int m = 0; m < 2; ++m) {
    const int r = 2 * m + s;
    // the slot's peers read this CTA's working row in the last round's
    // inverse
    if (m > 0) cluster.sync();
    if (r >= 3) {
      cluster.sync();    // the barrier inside the peers' inverse
      continue;
    }
    const uint32_t* pa = r == 0 ? x0 : x1;
    const uint32_t* pb = r == 0 ? y0 : y1;
#pragma unroll 8
    for (int j = first + threadIdx.x; j < first + share; j += blockDim.x)
      work[padded_index(j - first)] =
          r == 1 ? add_mod(mul_barrett(x0[j], y1[j], p, mu), mul_barrett(x1[j], y0[j], p, mu), p)
                 : mul_barrett(pa[j], pb[j], p, mu);
    __syncthreads();
    inv_ntt_regs_split<H, true>(work, split, sync, logn, p, ipsi, ipsi_sh, n_inv, n_inv_sh,
                                own_load<true>(work, first),
                                [&](auto& x, int base, int logs) { out(r, x, base, logs); });
  }
  // the slot's peers read this CTA's row in the last inverse: no CTA leaves
  // (and frees its shared memory) before all have
  cluster.sync();
}

}  // namespace fhe
