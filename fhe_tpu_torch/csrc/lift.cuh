// The SmMRq centred lift q -> Bsk of the ciphertext multiply, formed in
// the kernels that transform its result, so the lift never reaches device
// memory: bsk_branch_fused (csrc/rns.cu, step 1: n >= 1024) lifts a group
// of 16 coefficients per thread in its forward transform's first pass, and
// the Lift lane of tensor_product (csrc/ntt.cu: the n < 1024 multiply,
// where it replaces fhe_tpu/ops/rns_pallas.py sm_mrq_fused) one
// coefficient per thread into shared memory before it (SmMRqLift::one).
// Both take their arithmetic from here (sm_mrq_step, sm_mrq_close), so the
// two lifts cannot drift apart.  Plain version: fhe_tpu_torch/ops/rns.py
// sm_mrq.
//
// For a coefficient with residues x_i mod the k source primes q_i and one
// destination prime c: digits y_i = [x_i * m~ * (q/q_i)^-1]_{q_i}, conv =
// sum_i y_i * (q/q_i) mod c and the m~ = 2^16 lane sum_i (y_i & 0xFFFF) *
// (q/q_i) mod 2^16; alpha = lane * q^-1 mod 2^16, centred; the lift is
// (conv - alpha*q) * m~^-1 mod c, the residue of x or of x - q, whichever is
// centred.  Every digit y_i is a residue mod its own source prime and may
// exceed c (m_sk and several aux primes are below some q_i), so every
// product with a digit is a Shoup multiply, exact for any x < 2^32.  The m~
// lane is arithmetic mod 2^16 in uint32 with a mask: (2^16 - 1)^2 + 2^16 <
// 2^32.
#pragma once

#include <cstdint>

#include "modmath.cuh"

namespace fhe {

constexpr uint32_t kMask16 = 0xFFFFu;
// SmMRqLift::one loads the source rows in groups of kLiftGroup, in a loop
// over the groups at run time, so it takes any number of source primes;
// sm_mrq_step reduces at every step, so nothing but the loads depends on the
// group.
constexpr int kLiftGroup = 16;

// sm_mrq_step folds in the residue x_i of source prime q_i: the digit y_i
// (w, w_sh = [m~ (q/q_i)^-1]_{q_i} and its Shoup companion), conv += y_i *
// (q/q_i) mod c (phat, phat_sh: c's entry of the [l, k] table) and the m~
// lane, lane += (y_i & 0xFFFF) * (q/q_i) mod 2^16 (phat_mt).
__device__ __forceinline__ void sm_mrq_step(uint32_t x_i, uint32_t qi, uint32_t w,
                                            uint32_t w_sh, uint32_t phat, uint32_t phat_sh,
                                            uint32_t phat_mt, uint32_t c, uint32_t& conv,
                                            uint32_t& lane) {
  const uint32_t y = mul_shoup(x_i, w, w_sh, qi);
  conv = add_mod(conv, mul_shoup(y, phat, phat_sh, c), c);
  lane = (lane + (y & kMask16) * phat_mt) & kMask16;
}

// alpha = lane * q^-1 mod 2^16, centred into c; the lift (conv - alpha*q) *
// m~^-1 mod c, with qc, imt = q mod c and m~^-1 mod c and their Shoup
// companions.
__device__ __forceinline__ uint32_t sm_mrq_close(uint32_t conv, uint32_t lane,
                                                 uint32_t inv_q_mt, uint32_t c, uint32_t qc,
                                                 uint32_t qc_sh, uint32_t imt,
                                                 uint32_t imt_sh) {
  const uint32_t alpha = (lane * inv_q_mt) & kMask16;
  const uint32_t alpha_c = alpha < (1u << 15) ? alpha : c - ((1u << 16) - alpha);
  const uint32_t centred = sub_mod(conv, mul_shoup(alpha_c, qc, qc_sh, c), c);
  return mul_shoup(centred, imt, imt_sh, c);
}

// The lift's constants for every destination prime, as tensor_product's
// wrapper passes them (ops/rns.py SmMRqConsts): the k source primes q,
// [m~ (q/q_i)^-1]_{q_i} (w, w_sh) and (q/q_i) mod 2^16 (phat_mt), each [k];
// the [l, k] table (q/q_i) mod c_j, row-major by destination prime (phat,
// phat_sh); q mod c_j and m~^-1 mod c_j, each [l], with their Shoup
// companions; q^-1 mod 2^16.
struct SmMRqOperands {
  const uint32_t* q;
  const uint32_t* w;
  const uint32_t* w_sh;
  const uint32_t* phat;
  const uint32_t* phat_sh;
  const uint32_t* phat_mt;
  const uint32_t* q_mod_c;
  const uint32_t* q_mod_c_sh;
  const uint32_t* inv_mt_c;
  const uint32_t* inv_mt_c_sh;
  uint32_t inv_q_mt;
  int k;
};

// The lift into destination prime c = c_j (j the prime's row in the
// operands' [l] and [l, k] tables).
struct SmMRqLift {
  SmMRqOperands op;
  const uint32_t* phat;       // c_j's row of the [l, k] tables
  const uint32_t* phat_sh;
  uint32_t c, qc, qc_sh, imt, imt_sh;

  __device__ __forceinline__ SmMRqLift(const SmMRqOperands& o, int j, uint32_t cj)
      : op(o), phat(o.phat + j * o.k), phat_sh(o.phat_sh + j * o.k), c(cj),
        qc(__ldg(o.q_mod_c + j)), qc_sh(__ldg(o.q_mod_c_sh + j)),
        imt(__ldg(o.inv_mt_c + j)), imt_sh(__ldg(o.inv_mt_c_sh + j)) {}

  // The lift of the one coefficient whose residue mod q_i is src[i * sp],
  // i < k, with the source loads of a group of kLiftGroup primes in flight
  // at once.
  __device__ __forceinline__ uint32_t one(const uint32_t* __restrict__ src, long long sp) const {
    uint32_t conv = 0, lane = 0;
#pragma unroll 1
    for (int i0 = 0; i0 < op.k; i0 += kLiftGroup) {
      uint32_t x[kLiftGroup];
#pragma unroll
      for (int i = 0; i < kLiftGroup; ++i)
        if (i0 + i < op.k) x[i] = __ldg(src + (i0 + i) * sp);
#pragma unroll
      for (int i = 0; i < kLiftGroup; ++i) {
        const int s = i0 + i;
        if (s >= op.k) break;
        sm_mrq_step(x[i], __ldg(op.q + s), __ldg(op.w + s), __ldg(op.w_sh + s), __ldg(phat + s),
                    __ldg(phat_sh + s), __ldg(op.phat_mt + s), c, conv, lane);
      }
    }
    return sm_mrq_close(conv, lane, op.inv_q_mt, c, qc, qc_sh, imt, imt_sh);
  }
};

}  // namespace fhe
