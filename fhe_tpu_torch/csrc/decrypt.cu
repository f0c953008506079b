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
// (3 padded rows: 99 KB at n = 8192, 198 KB at n = 16384).  The transforms
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

#include "modmath.cuh"

namespace {

namespace cg = cooperative_groups;

struct DecryptScalars {
  uint32_t t, gamma, gamma_mu;
  uint32_t neg_inv_q_t, neg_inv_q_t_sh, neg_inv_q_g;
  uint32_t inv_gamma_t, inv_gamma_t_sh, gamma_mod_t, one_sh_t;
};

// c0, c1: [k, batch, n] with element strides (prime_stride, batch_stride, 1);
// s: [k, 1, n] NTT form, contiguous; out: [batch, n] mod t.  Grid
// (C, batch) in clusters of (C, 1, 1): CTA r of ciphertext b's cluster takes
// the primes i = r, r + C, ...  Shared memory: three padded rows, the
// working polynomial and the CTA's partial acc_t and acc_g.
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
                     int logn) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << logn;
  uint32_t* a = sm;
  uint32_t* acc_t = sm + fhe::padded(n);
  uint32_t* acc_g = sm + 2 * fhe::padded(n);
  const int r = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y;
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
        [&](auto& x, int base, int logs) {
          // the last pass's group is consecutive (logs = 0, base a multiple
          // of its size): the key's words come in 16-byte loads
          constexpr int G = sizeof(x) / sizeof(x[0]);
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
          for (int g = 0; g < G; ++g)
            a[fhe::padded_index(base + g)] = fhe::mul_barrett(x[g], sv[g], pi, mui);
        });
    // INTT, then phase_i, z_i and the two lanes' terms, fused into the
    // inverse's last pass.  Each j reaches out() from the same thread for
    // every prime, so acc_t / acc_g need no barrier between primes.
    const uint32_t gt = gt_inv_phat[i], gt_sh = gt_inv_phat_sh[i];
    const uint32_t pt = phat_t[i], pt_sh = phat_t_sh[i], pg = phat_g[i];
    const uint32_t* c0r = c0 + row;
    const bool first = i == r;
    fhe::inv_ntt_regs(
        a, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i], fhe::SmemLoad{a},
        [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g) {
            const int j = base + (g << logs);
            const uint32_t phase = fhe::add_mod(c0r[j], x[g], pi);
            const uint32_t z = fhe::mul_shoup(phase, gt, gt_sh, pi);
            const uint32_t term_t = fhe::mul_shoup(z, pt, pt_sh, sc.t);
            const uint32_t term_g = fhe::mul_barrett(
                fhe::reduce_barrett(z, sc.gamma, sc.gamma_mu), pg, sc.gamma, sc.gamma_mu);
            const int e = fhe::padded_index(j);
            acc_t[e] = first ? term_t : fhe::add_mod(acc_t[e], term_t, sc.t);
            acc_g[e] = first ? term_g : fhe::add_mod(acc_g[e], term_g, sc.gamma);
          }
        });
  }
  cluster.sync();
  // Epilogue: CTA r owns coefficients [r n / C, (r + 1) n / C).  It sums the
  // C partial accumulators of each through distributed shared memory (mod
  // add is exact, so the order does not matter) and scales.
  const int lo = static_cast<int>((static_cast<long long>(r) << logn) / csize);
  const int hi = static_cast<int>((static_cast<long long>(r + 1) << logn) / csize);
#pragma unroll 4
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const int e = fhe::padded_index(j);
    uint32_t sum_t = 0, sum_g = 0;
    for (int c = 0; c < csize; ++c) {
      sum_t = fhe::add_mod(sum_t, cluster.map_shared_rank(acc_t, c)[e], sc.t);
      sum_g = fhe::add_mod(sum_g, cluster.map_shared_rank(acc_g, c)[e], sc.gamma);
    }
    const uint32_t s_t = fhe::mul_shoup(sum_t, sc.neg_inv_q_t, sc.neg_inv_q_t_sh, sc.t);
    const uint32_t s_g = fhe::mul_barrett(sum_g, sc.neg_inv_q_g, sc.gamma, sc.gamma_mu);
    const uint32_t s_g_t = fhe::reduce_shoup(s_g, sc.t, sc.one_sh_t);
    const uint32_t e_mod_t =
        s_g <= (sc.gamma >> 1) ? s_g_t : fhe::sub_mod(s_g_t, sc.gamma_mod_t, sc.t);
    const uint32_t num = fhe::sub_mod(s_t, e_mod_t, sc.t);
    out[static_cast<size_t>(b) * n + j] =
        fhe::mul_shoup(num, sc.inv_gamma_t, sc.inv_gamma_t_sh, sc.t);
  }
  // the peers read this CTA's accumulators above: no CTA leaves (and frees
  // its shared memory) before all have
  cluster.sync();
}

}  // namespace

// The launch geometry comes from the wrapper (ops/decrypt_cuda.py,
// decrypt_geometry): clusters of `cluster` CTAs (1 <= cluster <= min(k, 8)),
// `threads` per CTA and `smem` bytes per CTA, at least the three padded rows
// the kernel uses.
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
    int threads, int smem, void* stream) {
  if (logn <= fhe::kRegLog || cluster < 1 || cluster > 8 || cluster > k
      || smem < 3 * 4 * fhe::padded(1 << logn))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  static std::atomic<size_t> placed[fhe::kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(decrypt_fused_kernel);
  cudaError_t err = fhe::allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fhe::cluster_config(
      dim3(cluster, batch), threads, smem, cluster, static_cast<cudaStream_t>(stream), attr);
  err = fhe::check_cluster(kernel, cfg, placed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecryptScalars sc{t, gamma, gamma_mu, neg_inv_q_t, neg_inv_q_t_sh,
                          neg_inv_q_g, inv_gamma_t, inv_gamma_t_sh, gamma_mod_t,
                          one_sh_t};
  auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  err = cudaLaunchKernelEx(
      &cfg, decrypt_fused_kernel, u(c0), u(c1), prime_stride, batch_stride, u(s),
      static_cast<uint32_t*>(out), u(p), u(mu), u(psi), u(psi_sh), u(ipsi), u(ipsi_sh),
      u(n_inv), u(n_inv_sh), u(gt_inv_phat), u(gt_inv_phat_sh), u(phat_t), u(phat_t_sh),
      u(phat_g), sc, k, logn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
