// The card's FP32 FMA roof: kernel K2.
//
// Replaces the Pallas TPU kernel raytracingpbr_tpu/utils/speedlight.py
// ::_fma_chains_kernel, the microbenchmark that gives the march kernels
// their flop bound (utils/speedlight.measure_vpu_peak). On the H100 it
// measures the FP32 FFMA roof. Per thread: CHAINS accumulators start at
// x (1 + 0.001 k); a = x 0.25 + 0.5; `iters` trips of UNROLL dependent
// fmaf(acc, a, 0.125) on every chain; the chains are summed and stored.
//
// Bound: FFMA issue, 128 FP32 lanes an SM a clock at 2 flops each; a thread
// reads and writes one float. fmaf is explicit, so FFMA is issued whatever
// -fmad says. The CHAINS independent chains give each warp scheduler the
// instruction-level parallelism that hides the FFMA latency, and the
// launch fills all 132 SMs. The accumulators live in registers (65,536 an
// SM), so the sweep trades chains against resident threads.

#include <cuda_runtime.h>

namespace {

template <int CHAINS, int UNROLL>
__global__ void fma_chains_kernel(const float* x, float* out, int n,
                                  int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) acc[k] = xv * (float)(1.0 + 0.001 * k);
  const float a = xv * 0.25f + 0.5f;  // 0.5..0.75: no overflow over iters
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) acc[k] = fmaf(acc[k], a, 0.125f);
    }
  }
  float s = acc[0];
#pragma unroll
  for (int k = 1; k < CHAINS; ++k) s = s + acc[k];
  out[i] = s;
}

template <int C, int U>
int launch(const float* x, float* out, int n, int iters, int block,
           cudaStream_t s) {
  fma_chains_kernel<C, U><<<(n + block - 1) / block, block, 0, s>>>(
      x, out, n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = the summed chains for x[i], i < n; (chains, unroll) one of
// (8, 4), (16, 4), (32, 4), (32, 1). Returns cudaGetLastError().
int rt_fma_chains(const float* x, float* out, int n, int iters, int chains,
                  int unroll, int block, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (chains == 8 && unroll == 4) return launch<8, 4>(x, out, n, iters,
                                                      block, s);
  if (chains == 16 && unroll == 4) return launch<16, 4>(x, out, n, iters,
                                                        block, s);
  if (chains == 32 && unroll == 4) return launch<32, 4>(x, out, n, iters,
                                                        block, s);
  if (chains == 32 && unroll == 1) return launch<32, 1>(x, out, n, iters,
                                                        block, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
