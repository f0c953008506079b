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
// carries acc_t / acc_g across grid steps in VMEM scratch.  GPU blocks run in
// no order and carry nothing to each other, so one block per ciphertext row
// loops over the k primes itself: the working polynomial and both
// accumulators live in shared memory (3 * 32 KB at n = 8192), and the
// epilogue runs after the last prime.  One launch, one write of [B, n].
// c0 and c1 are read through strides, so a ciphertext's [k, 2, n] data goes
// in as two views, with no copy.
// The t lane uses the generic Shoup reduction for every t; the t = 65537
// Fermat fold of the TPU path is an optimisation that gives the same bits.
//
// What bounds it on the H100.  At n = 8192, k = 3, B = 1 it reads 192 KB of
// ciphertext, 96 KB of key and 384 KB of twiddle tables and writes 32 KB:
// about 0.2 us by memory rate, against 2 * 3 * 13 dependent NTT stages run by
// ONE block, each closed by a barrier.  It is latency-bound on a single SM.
// Spreading the primes over a cluster of k blocks that meet through
// distributed shared memory is the next step.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "modmath.cuh"

namespace {

struct DecryptScalars {
  uint32_t t, gamma, gamma_mu;
  uint32_t neg_inv_q_t, neg_inv_q_t_sh, neg_inv_q_g;
  uint32_t inv_gamma_t, inv_gamma_t_sh, gamma_mod_t, one_sh_t;
};

// c0, c1: [k, batch, n] with element strides (prime_stride, batch_stride, 1);
// s: [k, 1, n] NTT form, contiguous; out: [batch, n] mod t.
__global__ void __launch_bounds__(1024)
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
                     int batch, int logn) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << logn;
  uint32_t* a = sm;
  uint32_t* acc_t = sm + n;
  uint32_t* acc_g = sm + 2 * n;
  const int b = blockIdx.x;
  for (int i = 0; i < k; ++i) {
    const uint32_t pi = p[i];
    const uint32_t mui = mu[i];
    const size_t tab = static_cast<size_t>(i) * n;
    const long long row = i * prime_stride + b * batch_stride;
    for (int j = threadIdx.x; j < n; j += blockDim.x) a[j] = c1[row + j];
    __syncthreads();
    fhe::fwd_ntt_smem(a, logn, pi, psi + tab, psi_sh + tab);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      a[j] = fhe::mul_barrett(a[j], s[tab + j], pi, mui);
    __syncthreads();
    fhe::inv_ntt_smem(a, logn, pi, ipsi + tab, ipsi_sh + tab, n_inv[i], n_inv_sh[i]);
    const uint32_t gt = gt_inv_phat[i], gt_sh = gt_inv_phat_sh[i];
    const uint32_t pt = phat_t[i], pt_sh = phat_t_sh[i], pg = phat_g[i];
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const uint32_t phase = fhe::add_mod(c0[row + j], a[j], pi);
      const uint32_t z = fhe::mul_shoup(phase, gt, gt_sh, pi);
      const uint32_t term_t = fhe::mul_shoup(z, pt, pt_sh, sc.t);
      const uint32_t term_g = fhe::mul_barrett(
          fhe::reduce_barrett(z, sc.gamma, sc.gamma_mu), pg, sc.gamma, sc.gamma_mu);
      acc_t[j] = i == 0 ? term_t : fhe::add_mod(acc_t[j], term_t, sc.t);
      acc_g[j] = i == 0 ? term_g : fhe::add_mod(acc_g[j], term_g, sc.gamma);
    }
    __syncthreads();
  }
  // Epilogue: each thread reads back only the accumulator entries it wrote.
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const uint32_t s_t = fhe::mul_shoup(acc_t[j], sc.neg_inv_q_t, sc.neg_inv_q_t_sh, sc.t);
    const uint32_t s_g = fhe::mul_barrett(acc_g[j], sc.neg_inv_q_g, sc.gamma, sc.gamma_mu);
    const uint32_t s_g_t = fhe::reduce_shoup(s_g, sc.t, sc.one_sh_t);
    const uint32_t e_mod_t =
        s_g <= (sc.gamma >> 1) ? s_g_t : fhe::sub_mod(s_g_t, sc.gamma_mod_t, sc.t);
    const uint32_t num = fhe::sub_mod(s_t, e_mod_t, sc.t);
    out[static_cast<size_t>(b) * n + j] =
        fhe::mul_shoup(num, sc.inv_gamma_t, sc.inv_gamma_t_sh, sc.t);
  }
}

}  // namespace

extern "C" int fhe_decrypt_fused(
    const void* c0, const void* c1, long long prime_stride, long long batch_stride,
    const void* s, void* out, const void* p,
    const void* mu, const void* psi, const void* psi_sh, const void* ipsi,
    const void* ipsi_sh, const void* n_inv, const void* n_inv_sh,
    const void* gt_inv_phat, const void* gt_inv_phat_sh, const void* phat_t,
    const void* phat_t_sh, const void* phat_g, uint32_t t, uint32_t gamma,
    uint32_t gamma_mu, uint32_t neg_inv_q_t, uint32_t neg_inv_q_t_sh,
    uint32_t neg_inv_q_g, uint32_t inv_gamma_t, uint32_t inv_gamma_t_sh,
    uint32_t gamma_mod_t, uint32_t one_sh_t, int k, int batch, int logn,
    void* stream) {
  const size_t smem = 3 * (sizeof(uint32_t) << logn);
  static std::atomic<size_t> granted[fhe::kMaxDevices];
  const cudaError_t err = fhe::allow_smem(
      reinterpret_cast<const void*>(decrypt_fused_kernel), smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecryptScalars sc{t, gamma, gamma_mu, neg_inv_q_t, neg_inv_q_t_sh,
                          neg_inv_q_g, inv_gamma_t, inv_gamma_t_sh, gamma_mod_t,
                          one_sh_t};
  decrypt_fused_kernel<<<batch, fhe::ntt_threads(logn), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1), prime_stride,
      batch_stride, static_cast<const uint32_t*>(s), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(mu),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_sh),
      static_cast<const uint32_t*>(ipsi), static_cast<const uint32_t*>(ipsi_sh),
      static_cast<const uint32_t*>(n_inv), static_cast<const uint32_t*>(n_inv_sh),
      static_cast<const uint32_t*>(gt_inv_phat),
      static_cast<const uint32_t*>(gt_inv_phat_sh), static_cast<const uint32_t*>(phat_t),
      static_cast<const uint32_t*>(phat_t_sh), static_cast<const uint32_t*>(phat_g), sc,
      k, batch, logn);
  return static_cast<int>(cudaGetLastError());
}
