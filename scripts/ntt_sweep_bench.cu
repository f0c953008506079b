// Time per SM of the register-blocked NTT sweep of
// fhe_tpu_torch/csrc/modmath.cuh (fwd_ntt_regs / inv_ntt_regs, the sweep of
// every NTT kernel), and of its butterflies alone.  Build and run on the
// card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I fhe_tpu_torch/csrc -o ntt_sweep_bench scripts/ntt_sweep_bench.cu
//   ./ntt_sweep_bench
//
// Each kernel runs `reps` forward + inverse pairs of an n = 8192 row in one
// CTA of 512 threads, on 1 CTA and on 132 (one per SM); the slope between
// reps = 1 and reps = 11 is the time of one pair on one SM, launch
// excluded.  "butterflies" runs the sweep's 4-stage groups on registers
// only (twiddles at one broadcast address, no shared memory, no barriers):
// 6 groups per pair (26 stages / 4), so its slope is the butterflies' share
// of a pair.  The twiddles are random residues: the timing does not depend
// on them.

#include <cstdio>
#include <cstdlib>
#include <vector>

#include "modmath.cuh"

namespace {

constexpr int kLogn = 13;
constexpr uint32_t kPrime = 1073479681u;   // 2^30 - 2^18 + 1, = 1 mod 2^14

__global__ void __launch_bounds__(512)
regs_kernel(const uint32_t* in, uint32_t* out, const uint32_t* w, const uint32_t* w_sh,
            int reps) {
  extern __shared__ uint32_t sm[];
  const int n = 1 << kLogn;
  const uint32_t* src = in + static_cast<size_t>(blockIdx.x) * n;
  uint32_t* dst = out + static_cast<size_t>(blockIdx.x) * n;
  for (int r = 0; r < reps; ++r) {
    fhe::fwd_ntt_regs(
        sm, kLogn, kPrime, w, w_sh,
        [&](auto& x, int base, int logs) {
#pragma unroll
          for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g)
            x[g] = src[base + (g << logs)];
        },
        fhe::SmemStore{sm});
    fhe::inv_ntt_regs(sm, kLogn, kPrime, w, w_sh, 12345u, 67890u, fhe::SmemLoad{sm},
                      [&](auto& x, int base, int logs) {
#pragma unroll
                        for (int g = 0; g < static_cast<int>(sizeof(x) / sizeof(x[0])); ++g)
                          dst[base + (g << logs)] = x[g];
                      });
  }
}

__global__ void __launch_bounds__(512)
butterflies_kernel(const uint32_t* in, uint32_t* out, const uint32_t* w,
                   const uint32_t* w_sh, int reps) {
  const size_t row = static_cast<size_t>(blockIdx.x) << kLogn;
  uint32_t x[16];
  for (int i = 0; i < 16; ++i) x[i] = in[row + threadIdx.x * 16 + i];
  for (int r = 0; r < reps * 2 * kLogn / 4; ++r)
    fhe::ntt_regs_stages<16, 4, 0, false>(x, 1, kPrime, w, w_sh);
  for (int i = 0; i < 16; ++i) out[row + threadIdx.x * 16 + i] = x[i];
}

}  // namespace

int main() {
  const int n = 1 << kLogn, blocks = 132;
  std::vector<uint32_t> h(static_cast<size_t>(n) * blocks), tw(n), tws(n);
  srand(1);
  for (auto& v : h) v = rand() % kPrime;
  for (int i = 0; i < n; ++i) {
    tw[i] = rand() % kPrime;
    tws[i] = static_cast<uint32_t>((static_cast<uint64_t>(tw[i]) << 32) / kPrime);
  }
  uint32_t *din, *dout, *dw, *dws;
  cudaMalloc(&din, 4 * h.size());
  cudaMalloc(&dout, 4 * h.size());
  cudaMalloc(&dw, 4 * n);
  cudaMalloc(&dws, 4 * n);
  cudaMemcpy(din, h.data(), 4 * h.size(), cudaMemcpyHostToDevice);
  cudaMemcpy(dw, tw.data(), 4 * n, cudaMemcpyHostToDevice);
  cudaMemcpy(dws, tws.data(), 4 * n, cudaMemcpyHostToDevice);
  const int smem_regs = 4 * fhe::padded(n);
  cudaFuncSetAttribute(regs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_regs);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  auto time = [&](const char* name, auto launch) {
    float ms[2];
    const int reps[2] = {1, 11};
    for (int i = 0; i < 2; ++i) {
      for (int nb : {1, blocks}) {
        launch(nb, reps[i]);
        cudaEventRecord(a);
        for (int it = 0; it < 20; ++it) launch(nb, reps[i]);
        cudaEventRecord(b);
        cudaEventSynchronize(b);
        float t;
        cudaEventElapsedTime(&t, a, b);
        if (nb == blocks) ms[i] = t / 20;
        printf("%-12s blocks=%3d reps=%2d  %.4f ms per launch\n", name, nb, reps[i], t / 20);
      }
    }
    printf("%-12s one forward + inverse pair on one SM: %.2f us\n", name,
           (ms[1] - ms[0]) / 10 * 1e3);
  };
  time("register", [&](int nb, int reps) {
    regs_kernel<<<nb, 512, smem_regs>>>(din, dout, dw, dws, reps);
  });
  time("butterflies", [&](int nb, int reps) {
    butterflies_kernel<<<nb, 512>>>(din, dout, dw, dws, reps);
  });
  const cudaError_t err = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
