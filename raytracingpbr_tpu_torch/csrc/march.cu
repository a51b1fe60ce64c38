// Resumable enhanced-sphere-trace march for Hopper (sm_90a): kernels K1a,
// K1b and K1c.
//
// Replaces the Pallas TPU kernel raytracingpbr_tpu/pallas/march_kernel.py
// ::_march_kernel (with _sd_tile, _nearest_tile and _bunny_tile):
//   K1a  CONSTANT omega, ABSOLUTE hit test, no escape bound, analytic shapes
//        (the Cornell wavefront's march);
//   K1b  the ROLLBACK_TO_ONE / ROLLBACK_HALF_UP omega policies, the CONE /
//        RELATIVE hit tests and the escape bound (bound^2 in column 18 of
//        the packed scene), analytic shapes;
//   K1c  any of those with the neural bunny: the sin-activated MLP
//        3 -> 16 -> 16 (+res) -> 16 (+res, x 1/1.4) -> 1 inside the unit
//        sphere, r - 0.8 outside it.
// Every variant has the active gate and the resume from (t, w, s, d).
//
// K1a/K1b: march_kernel<POLICY, CRIT, BOUND>, one thread per ray lane with
// its own loop exit. SIMT gives the per-lane early exit the TPU kernel
// approximated with (8|32, 128) tiles and a 32-trip unroll between
// cross-lane convergence checks; a lane that stops early writes the same
// outputs as the lock-step plain march, whose done lanes are frozen. Each
// block stages the packed scene (n_obj x 18 floats plus the shape types) in
// shared memory once; the object loop reads it with a type switch that is
// uniform across the warp. Bound: FP32 issue, about 25 flops per object a
// lane-trip against ~70 bytes a lane once, and the divergence of trip
// counts within a warp.
//
// K1c: pool_kernel<POLICY, CRIT, BOUND, Fp32Mlp> of march_pool.cuh, the
// persistent lane pool with a compacted MLP queue, whose notes say what
// bounds it and what the design does about it. The MLP is FP32 chains
// on the CUDA cores, a queue entry a thread, the (40, 16) weights in shared
// memory; it keeps 32 activations live in registers.
//
// Numerics (march_common.cuh): every add and multiply rounds on its own and
// sinf is libdevice's full-range sinf, as PyTorch's elementwise CUDA ops
// do; the bunny follows sdf.bunny_mlp_eval_unrolled's order, so the kernel
// and the plain PyTorch march agree bit for bit on the card. The pool moves
// a lane's work between threads and changes none of its arithmetic.

#include "march_common.cuh"
#include "march_pool.cuh"

namespace {

using namespace rt;

constexpr int kBunnyWeights = 40 * 16;  // kernels/march_kernel.pack_bunny

// The raw bunny MLP (no support test) at the local point p; w is the (40,
// 16) block of pack_bunny: rows 0-2 w_in, 3 b_in, 4-19 w_h1, 20 b_h1, 21-36
// w_h2, 37 b_h2, 38 w_out, 39 [bias_out, 0, ...]. The operation order is
// _bunny_tile's (and sdf.bunny_mlp_eval_unrolled's).
__device__ __forceinline__ float bunny_mlp(const float* w, float px,
                                           float py, float pz) {
  constexpr float kInv14 = (float)(1.0 / 1.4);
  float f0[16], f1[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    f0[k] = sinf(px * w[k] + py * w[16 + k] + pz * w[32 + k] + w[48 + k]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float acc = f0[0] * w[4 * 16 + k];
#pragma unroll
    for (int j = 1; j < 16; ++j) acc = acc + f0[j] * w[(4 + j) * 16 + k];
    f1[k] = sinf(acc + w[20 * 16 + k]) + f0[k];
  }
  float sd = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float acc = f1[0] * w[21 * 16 + k];
#pragma unroll
    for (int j = 1; j < 16; ++j) acc = acc + f1[j] * w[(21 + j) * 16 + k];
    const float f2 = sinf(acc + w[37 * 16 + k]) * kInv14 + f1[k];
    sd = k == 0 ? f2 * w[38 * 16] : sd + f2 * w[38 * 16 + k];
  }
  return sd + w[39 * 16];
}

// K1c's engine for the pool: queue entry q on thread q.
struct Fp32Mlp {
  static constexpr int kWeights = kBunnyWeights;
  // 4 blocks an SM, 64 registers: the fastest of 2-5 on the H100
  static constexpr int kMinBlocks = 4;
  __device__ static void run(const float* w, const float* qx,
                             const float* qy, const float* qz, float* qr,
                             int nq) {
    const int q = threadIdx.x;
    if (q < nq) qr[q] = bunny_mlp(w, qx[q], qy[q], qz[q]);
  }
  // rows run(nq) issues: whole warps
  __device__ static int rows(int nq) { return (nq + 31) & ~31; }
};

template <int POLICY, int CRIT, bool BOUND>
__global__ void march_kernel(const MarchArgs a) {
  __shared__ float sp[kMaxObjects * kParamUsed];
  __shared__ int st[kMaxObjects];
  stage_scene(a, sp, st);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;

  const float bound2 = BOUND ? a.params[kBoundCol] : 0.0f;
  Lane L = load_lane(a, lane);
  for (int i = 0; i < a.budget && !L.done; ++i) {
    const float x = L.ox + L.t * L.dx, y = L.oy + L.t * L.dy,
                z = L.oz + L.t * L.dz;
    float best = 1e3f;  // running min of |sd|: first object wins ties
    int best_i = 0;
    for (int o = 0; o < a.n_obj; ++o) {
      const float* pr = sp + o * kParamUsed;
      float px, py, pz;
      to_local(pr, x, y, z, px, py, pz);
      const float dist = fabsf(sd_shape(st[o], px, py, pz, pr[3], pr[4],
                                        pr[5], a.box_round));
      if (dist < best) {
        best = dist;
        best_i = o;
      }
    }
    advance<POLICY, CRIT, BOUND>(L, a, bound2, x, y, z, best, best_i, i);
  }
  store_lane(a, lane, L);
}

// K1a/K1b on a scene without the bunny (a.bunny null), K1c with it.
struct Launch {
  template <int P, int C, bool B>
  static int launch(const MarchArgs& a, int block, cudaStream_t s) {
    if (a.bunny) return PoolLaunch<Fp32Mlp>::launch<P, C, B>(a, block, s);
    const int grid = (a.n + block - 1) / block;
    march_kernel<P, C, B><<<grid, block, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int rt_march_max_objects() { return rt::kMaxObjects; }

// K1c's persistent grid: blocks of 256 slots that fit on an SM, and SMs.
int rt_pool_occupancy(int* per_sm, int* sms) {
  return rt::pool_occupancy<Fp32Mlp>(per_sm, sms);
}

// Launches the march variant (policy, crit, has_bound, bunny given) on
// `stream` and returns cudaGetLastError(). Optional inputs (active, the
// four init arrays, bunny when the scene has none) may be null. Pointers
// are device pointers to contiguous arrays: params (n_obj, 32) f32 with
// bound^2 in row 0 column 18 when has_bound, types (n_obj,) i32, bunny
// (40, 16) f32, origin and direction (n, 3) f32, active (n,) bool, init
// (n,) f32; outputs (n,). With the bunny (K1c): next_lane, one i32 the
// caller zeroed, and block 256; counts, two u64 to add to, or null: the
// MLP evaluations run (queue entries, with a warp's padding) and the lane
// slots of the warps' march steps (32 a warp step). Without the bunny both
// are ignored.
int rt_march(RT_MARCH_PARAMS) {
  return rt::march_entry<Launch>(RT_MARCH_ARGS);
}

}  // extern "C"
