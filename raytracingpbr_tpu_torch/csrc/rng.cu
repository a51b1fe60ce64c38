// The counter RNG: one launch a draw of core/rng.uniform4, uniform and
// r2_uniform4.
//
// Replaces no TPU kernel: the JAX package's raytracingpbr_tpu/core/rng.py
// is XLA. The port's plain version (core/rng.py, the *_plain functions)
// holds each uint32 word in an int64 tensor, masked after every add and
// multiply with each product split into 16-bit halves: about 140
// elementwise kernels a draw. Here one thread hashes one lane's counter
// (pixel_id, step, stream, seed) with pcg4d in native uint32_t, whose
// wrap-around is exactly the plain path's `& 0xFFFFFFFF`, adds the R2
// rotation where asked, and stores the top 24 bits of each word as a float
// in [0, 1): (u >> 8) is exact in float32 and the scale by 2^-24 is a
// power of two, so the output is bit-equal to the plain path's.
//
// Bound: bytes. A lane reads its pixel id (4 or 8 B, and 4 or 8 B more
// for a per-lane step) and writes 1 or 4 floats; the hash is about 30
// integer operations, far below the byte line. Each output word is a
// contiguous tensor of its own, as the plain draw's are (a caller that
// keeps one holds no more than with the plain draw), so each of a warp's
// stores is one 128 B line; a step held on the card (a 0-dim tensor) is read by every thread from
// the same address, from cache, so no host sync ever reads it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PCG_MULT = 1664525u;
constexpr uint32_t PCG_INC = 1013904223u;
// the R2 draw's second counter word, in place of the step
constexpr uint32_t R2_Y = 0x9E3779B9u;
// the 4D R2 sequence's steps: frac(phi4^-(k+1)) in 32-bit fixed point
constexpr uint32_t R2_A0 = 0xDB4F0B91u;
constexpr uint32_t R2_A1 = 0xBBE05633u;
constexpr uint32_t R2_A2 = 0xA0F2EC76u;
constexpr uint32_t R2_A3 = 0x89E18285u;

// where a draw's step word comes from
enum StepKind { STEP_VALUE = 0, STEP_I32 = 1, STEP_I64 = 2 };

constexpr int BLOCK = 256;

struct Args {
  const void* pid;
  const void* step;
  long long step_stride;  // 0: one step for every lane; 1: one a lane
  uint32_t step_value;
  uint32_t stream;
  uint32_t seed;
  void* out[4];  // one row of n floats each; rows 1-3 null: the first only
  long long n;
};

__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  x = x * PCG_MULT + PCG_INC;
  y = y * PCG_MULT + PCG_INC;
  z = z * PCG_MULT + PCG_INC;
  w = w * PCG_MULT + PCG_INC;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

template <typename OutT>
__device__ __forceinline__ OutT unit(uint32_t u);

template <>
__device__ __forceinline__ float unit<float>(uint32_t u) {
  return (float)(u >> 8) * 0x1p-24f;
}

template <>
__device__ __forceinline__ double unit<double>(uint32_t u) {
  return (double)(u >> 8) * 0x1p-24;
}

// One lane a thread. An id's or a step's word is its low 32 bits: the
// conversion to unsigned is modulo 2^32, as the plain path's
// `.to(int64) & 0xFFFFFFFF`.
template <typename PidT, int STEP, typename OutT, bool R2>
__global__ void __launch_bounds__(BLOCK) rng_kernel(Args a) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s = a.step_value;
  if (STEP == STEP_I32)
    s = (uint32_t)static_cast<const int32_t*>(a.step)[i * a.step_stride];
  if (STEP == STEP_I64)
    s = (uint32_t)static_cast<const int64_t*>(a.step)[i * a.step_stride];
  uint32_t x = (uint32_t)static_cast<const PidT*>(a.pid)[i];
  uint32_t y = R2 ? R2_Y : s;
  uint32_t z = a.stream;
  uint32_t w = a.seed;
  pcg4d(x, y, z, w);
  if (R2) {
    x += s * R2_A0;
    y += s * R2_A1;
    z += s * R2_A2;
    w += s * R2_A3;
  }
  static_cast<OutT*>(a.out[0])[i] = unit<OutT>(x);
  if (a.out[1] != nullptr) {
    static_cast<OutT*>(a.out[1])[i] = unit<OutT>(y);
    static_cast<OutT*>(a.out[2])[i] = unit<OutT>(z);
    static_cast<OutT*>(a.out[3])[i] = unit<OutT>(w);
  }
}

template <typename PidT, int STEP, typename OutT, bool R2>
int launch(const Args& a, cudaStream_t s) {
  const long long blocks = (a.n + BLOCK - 1) / BLOCK;
  rng_kernel<PidT, STEP, OutT, R2><<<(unsigned)blocks, BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename PidT, int STEP, typename OutT>
int by_mode(const Args& a, int r2, cudaStream_t s) {
  return r2 ? launch<PidT, STEP, OutT, true>(a, s)
            : launch<PidT, STEP, OutT, false>(a, s);
}

template <typename PidT, int STEP>
int by_out(const Args& a, int r2, int out_is64, cudaStream_t s) {
  return out_is64 ? by_mode<PidT, STEP, double>(a, r2, s)
                  : by_mode<PidT, STEP, float>(a, r2, s);
}

template <typename PidT>
int by_step(const Args& a, int step_kind, int r2, int out_is64,
            cudaStream_t s) {
  switch (step_kind) {
    case STEP_VALUE: return by_out<PidT, STEP_VALUE>(a, r2, out_is64, s);
    case STEP_I32: return by_out<PidT, STEP_I32>(a, r2, out_is64, s);
    case STEP_I64: return by_out<PidT, STEP_I64>(a, r2, out_is64, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One draw over n lanes: the float (float32, or float64 where out_is64) of
// word k of each lane into out_k[i], the words 1-3 only where out1, out2
// and out3 are not null. pid: n int32 or int64 (pid_is64) ids. The step: step_value where step_kind is 0,
// else read from step (int32: 1, int64: 2) at step[i * step_stride]. r2:
// the R2 point of that step rotated by pcg4d(pid, 0x9E3779B9, stream,
// seed), else pcg4d(pid, step, stream, seed). Launches on `stream_handle`
// and returns cudaGetLastError().
int rt_rng(const void* pid, int pid_is64, const void* step, int step_kind,
           long long step_stride, unsigned int step_value, unsigned int stream, unsigned int seed,
           int r2, void* out0, void* out1, void* out2, void* out3,
           int out_is64, long long n, void* stream_handle) {
  if (n <= 0) return 0;
  const bool four = out1 != nullptr;
  if (four != (out2 != nullptr) || four != (out3 != nullptr) ||
      (n + BLOCK - 1) / BLOCK > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const Args a{pid, step, step_stride, step_value, stream, seed,
               {out0, out1, out2, out3}, n};
  cudaStream_t s = (cudaStream_t)stream_handle;
  return pid_is64 ? by_step<int64_t>(a, step_kind, r2, out_is64, s)
                  : by_step<int32_t>(a, step_kind, r2, out_is64, s);
}

}  // extern "C"
