// Resumable march with the neural bunny's MLP on Hopper's tensor cores
// (sm_90a): kernel K1d.
//
// Replaces raytracingpbr_tpu/pallas/march_kernel.py::_bunny_tile_mxu (with
// pack_bunny_mxu and the tile skip of _nearest_tile), the march kernel's
// cfg.bunny_mxu variant. Its contract is K1c's (march.cu): every omega
// policy, hit test and the escape bound, the active gate, the resume from
// (t, w, s, d) and the same eight outputs; analytic objects as in K1a-K1c.
//
// Design. The march is pool_kernel<POLICY, CRIT, BOUND, MxuMlp> of
// march_pool.cuh, K1c's persistent lane pool with a compacted MLP queue;
// this engine evaluates the queue a warp at a time: entries
// 32 w .. 32 w + 31 are the 32 rows (M) of warp w's products, the last
// warp padded with zero points. The queue is contiguous, so "warp w has
// entries" is uniform over the warp and mma.sync sees a converged warp;
// the MLP runs only for points inside the support, not for every lane of
// a warp that holds one. (One M-tile a warp for short queues, twice the
// warps on half the rows, measured 5% slower on the metal frame's calls.)
// Of the MLP:
//   - 3 -> 16 and 16 -> 1 stay on the FP32 pipes (48 and 16 products a
//     point: no tensor-core shape is that thin);
//   - the two 16 x 16 layers are mma.sync.m16n8k8 TF32 products, 2 M-tiles
//     x 2 N-tiles x 2 K-tiles, each in three passes (a_big b_big + a_big
//     b_small + a_small b_big, the 3xTF32 split): f32 accuracy (~3e-7 on
//     the SDF), where one TF32 pass errs by ~1e-3;
//   - the activations stay in the accumulator layout throughout: a thread
//     holds 4 points x 4 features. The accumulator's columns (2t, 2t+1) are
//     the A fragment's (t, t+4) once the K index is permuted, and
//     pack_bunny_mxu folds that permutation into the weights, so no shuffle
//     or shared-memory relayout sits between the layers. 12 shuffles bring
//     each thread its 4 points before the first layer; after the last, 8
//     add up the quads' partial sums and 1 brings each lane its own value.
// Row m of an m16n8k8 product depends only on row m of A, and every other
// step is per point or a fixed-order sum within the point's quad, so a
// point's value does not depend on its queue neighbours (nor on the zero
// rows that pad a warp): where a lane's point lands in the queue does not
// change its result.
//
// Bound. The two contractions are 1,024 of the ~1,250 flops of a bunny
// lane-trip inside the support (utils/speedlight.py); on the tensor cores
// they cost ~6 ps a lane-trip even in three passes. What stays on the FP32
// pipes is dominated by the 48 libdevice sinf (range reduction and a
// polynomial each, tens of instructions), then the first layer, the
// residuals and the loop: FP32 issue, with the pool's notes on how the
// slots are kept busy.
//
// Numerics: -fmad=false as march.cu; the analytic parts round as the plain
// march does, the MLP differs from the plain K1d march (the matmul form,
// sdf.bunny_mlp_eval) in summation order and in the TF32 split.

#include "march_common.cuh"
#include "march_pool.cuh"

namespace {

using namespace rt;

constexpr unsigned kFull = 0xffffffffu;

// Rows of pack_bunny_mxu (kernels/march_kernel.py), each one float per lane.
// Lane L = 4 g + t; feature slot q = 2 nt + j is feature f = 8 nt + 2 t + j.
constexpr int kRowIn = 0;      // 4 q + c: w_in[c][f] (c < 3), b_in[f] (c = 3)
constexpr int kRowH1 = 16;     // 4 m + (b0, b1 big; b0, b1 small), then 4 b
constexpr int kRowH2 = 36;     //   (m = 2 kk + nt; see hidden_layer)
constexpr int kRowOut = 56;    // q: w_out[f]
constexpr int kRowBias = 60;   // bias_out
constexpr int kPackRows = 64;  // 3 zero rows pad it to 64 x 32 floats

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += A (16 x 8, row) B (8 x 8, col) on the tensor cores, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// act = sin(act @ W + b) (x 1/1.4 when SCALED) + act for one 16 x 16 layer.
// act[mt][nt][i] is point 16 mt + g + 8 (i >> 1), feature 8 nt + 2 t +
// (i & 1): the accumulator layout of m16n8k8. As the A fragment of K-tile
// kk it is (act[mt][kk][0], [2], [1], [3]) with the logical k = t, t + 4
// standing for features 8 kk + 2 t, 8 kk + 2 t + 1; the B fragment rows of
// the pack follow that order: b0 = W[8 kk + 2 t][8 nt + g], b1 = W[8 kk +
// 2 t + 1][8 nt + g]. wl: this layer's first pack row, at this lane.
template <bool SCALED>
__device__ __forceinline__ void hidden_layer(const float* wl,
                                             float act[2][2][4]) {
  float pre[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pre[mt][nt][i] = wl[32 * (16 + 2 * nt + (i & 1))];  // the bias
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float av[4] = {act[mt][kk][0], act[mt][kk][2], act[mt][kk][1],
                           act[mt][kk][3]};
      uint32_t big[4], small[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        big[r] = to_tf32(av[r]);
        small[r] = to_tf32(av[r] - __uint_as_float(big[r]));
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* wm = wl + 32 * 4 * (2 * kk + nt);
        const uint32_t b0 = __float_as_uint(wm[0]);
        const uint32_t b1 = __float_as_uint(wm[32]);
        const uint32_t s0 = __float_as_uint(wm[64]);
        const uint32_t s1 = __float_as_uint(wm[96]);
        mma_tf32(pre[mt][nt], small, b0, b1);
        mma_tf32(pre[mt][nt], big, s0, s1);
        mma_tf32(pre[mt][nt], big, b0, b1);
      }
    }
  }
  constexpr float kInv14 = (float)(1.0 / 1.4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f = sinf(pre[mt][nt][i]);
        act[mt][nt][i] = (SCALED ? f * kInv14 : f) + act[mt][nt][i];
      }
    }
  }
}

// The raw bunny MLP (no support test) of each lane's own point, evaluated by
// the whole warp together: all 32 lanes must call it converged. w: the pack
// in shared memory.
__device__ __forceinline__ float bunny_mlp_warp(const float* w, float px,
                                                float py, float pz) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const float* wl = w + lane;
  float act[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int src = 16 * mt + 8 * hi + g;
      const float x = __shfl_sync(kFull, px, src);
      const float y = __shfl_sync(kFull, py, src);
      const float z = __shfl_sync(kFull, pz, src);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wq = wl + 32 * (kRowIn + 4 * q);
        act[mt][q >> 1][2 * hi + (q & 1)] =
            sinf(x * wq[0] + y * wq[32] + z * wq[64] + wq[96]);
      }
    }
  }
  hidden_layer<false>(wl + 32 * kRowH1, act);
  hidden_layer<true>(wl + 32 * kRowH2, act);
  // 16 -> 1: this thread's 4 features of each of its points, then the sum
  // over the quad; part[2 mt + hi] is point g + 8 (2 mt + hi)
  float part[4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float s = act[mt][0][2 * hi] * wl[32 * kRowOut];
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        s = s + act[mt][q >> 1][2 * hi + (q & 1)] * wl[32 * (kRowOut + q)];
      }
      s = s + __shfl_xor_sync(kFull, s, 1);
      s = s + __shfl_xor_sync(kFull, s, 2);
      part[2 * mt + hi] = s;
    }
  }
  // thread t of quad g keeps point g + 8 t; lane p fetches point p's sum
  const int t = lane & 3;
  const float keep = t == 0 ? part[0] : t == 1 ? part[1]
                   : t == 2 ? part[2] : part[3];
  return __shfl_sync(kFull, keep, 4 * (lane & 7) + (lane >> 3)) +
         wl[32 * kRowBias];
}

// K1d's engine for the pool: queue entries 32 w .. 32 w + 31 on warp w,
// the last warp padded with zero points.
struct MxuMlp {
  static constexpr int kWeights = kPackRows * 32;
  // 4 blocks an SM, 64 registers with a few spilled: the fastest of 2-5
  // on the H100 (the MLP's latency wants the warps more than registers)
  static constexpr int kMinBlocks = 4;
  __device__ static void run(const float* w, const float* qx,
                             const float* qy, const float* qz, float* qr,
                             int nq) {
    const int q = threadIdx.x;
    if ((q & ~31) >= nq) return;  // uniform over the warp
    const bool real = q < nq;
    const float m = bunny_mlp_warp(w, real ? qx[q] : 0.0f,
                                   real ? qy[q] : 0.0f, real ? qz[q] : 0.0f);
    if (real) qr[q] = m;
  }
  // rows run(nq) issues: whole warps
  __device__ static int rows(int nq) { return (nq + 31) & ~31; }
};

__global__ void __launch_bounds__(256)
    bunny_mlp_kernel(const float* pack, const float* p, float* out, int n) {
  __shared__ float sw[kPackRows * 32];
  for (int k = threadIdx.x; k < kPackRows * 32; k += blockDim.x) {
    sw[k] = pack[k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < n;
  const float m = bunny_mlp_warp(sw, real ? p[3 * i] : 0.0f,
                                 real ? p[3 * i + 1] : 0.0f,
                                 real ? p[3 * i + 2] : 0.0f);
  if (real) out[i] = m;
}

}  // namespace

extern "C" {

int rt_march_max_objects() { return rt::kMaxObjects; }

// K1d's persistent grid: blocks of 256 slots that fit on an SM, and SMs.
int rt_pool_occupancy(int* per_sm, int* sms) {
  return rt::pool_occupancy<MxuMlp>(per_sm, sms);
}

// K1d, with march.cu's C entry: bunny is the (64, 32) f32 block of
// pack_bunny_mxu and may not be null; next_lane, counts and block as K1c's.
int rt_march(RT_MARCH_PARAMS) {
  return rt::march_entry<rt::PoolLaunch<MxuMlp>>(RT_MARCH_ARGS);
}

// K1d's device MLP alone over n points (n, 3) f32 -> out (n,) f32, the raw
// MLP value with no support test; for checking the kernel's MLP only.
int rt_bunny_mlp_mxu(const float* pack, const float* points, float* out,
                     int n, int block, void* stream) {
  if (n <= 0) return 0;
  if (block % 32 != 0) return (int)cudaErrorInvalidValue;
  bunny_mlp_kernel<<<(n + block - 1) / block, block, 0,
                     (cudaStream_t)stream>>>(pack, points, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
