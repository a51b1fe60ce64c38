// Resumable enhanced-sphere-trace march for Hopper (sm_90a): kernels K1a,
// K1b and K1c.
//
// Replaces the Pallas TPU kernel raytracingpbr_tpu/pallas/march_kernel.py
// ::_march_kernel (with _sd_tile, _nearest_tile and _bunny_tile):
//   K1a  CONSTANT omega, ABSOLUTE hit test, no escape bound, analytic shapes
//        (the Cornell wavefront's march);
//   K1b  the ROLLBACK_TO_ONE / ROLLBACK_HALF_UP omega policies, the CONE /
//        RELATIVE hit tests and the escape bound (bound^2 in the header of
//        the grouped pack), analytic shapes;
//   K1c  any of those with the neural bunny: the sin-activated MLP
//        3 -> 16 -> 16 (+res) -> 16 (+res, x 1/1.4) -> 1 inside the unit
//        sphere, r - 0.8 outside it.
// Every variant has the active gate and the resume from (t, w, s, d).
//
// K1a/K1b: march_kernel<POLICY, CRIT, BOUND>, one thread per ray lane with
// its own loop exit. SIMT gives the per-lane early exit the TPU kernel
// approximated with (8|32, 128) tiles and a 32-trip unroll between
// cross-lane convergence checks; a lane that stops early writes the same
// outputs as the lock-step plain march, whose done lanes are frozen. The
// TPU kernel (_march_kernel, march_kernel.py:297) unrolls its object loop
// over static shape types and skips the matrix of a signed permutation
// (_nearest_tile, :238-244).
// What bounds them on the H100: instruction issue on the object loop. The
// work is ~25 flops an object a lane-trip against ~70 bytes a lane once,
// and the warps of 32 fixed lanes run 30-41% more lane-trips than the
// frames' calls need (divergence; PERF.md). The earlier kernel, a type
// switch on every object and every object through its full matrix, took
// 73 SASS instructions an object-trip for a box, 60 for a sphere (the IEEE
// sqrtf alone is ~8, where the flop count has 1).
// The design: the wrapper orders the objects into groups of one (shape,
// permutation or matrix) kind, a permutation group in runs keyed by the
// world axis its SDF reads last or alone; each run is a loop with its SDF
// and transform compiled in, reading its records from shared memory at
// addresses uniform over the warp. A signed permutation takes no matrix
// products (its record is folded per world axis). A box now takes 49
// instructions an object-trip under a permutation and 67 under a matrix, a
// sphere 37 and 55 (tools/ab_march.py counts them). The running min is the
// lexicographic (distance, index) one of march_pool.cuh, so runs may come
// in any order. __launch_bounds__ holds the registers at 40, as many as
// the earlier kernel used: more registers cost more occupancy than the
// few spills they save (tools/ab_march.py --sweep).
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

// K1a/K1b. The grouped pack (kernels/march_kernel.pack_groups): a header
// float4 [bound^2, 0, 0, 0], then a record of kRecord float4s an object, in
// group order:
//   [0] position, object index (a float)
//   [1] offset, a0      [2] a1, a2, a3, 0      [3..5] the matrix rows
// A matrix object keeps its local offset and scale (a0..a2) as packed. A
// signed permutation p_r = s_r e_{c_r} is folded per world axis a = c_r:
// offset s_r * off_r, so that u_a = (x_a - pos_a) + offset_a = s_r * p_r
// exactly (a sign flip is exact, rounding is symmetric); the box's scale by
// axis (a0..a2 = s of the row that reads x, y, z); the cone's a3 = s_1; the
// plane's a1 = s_1 * sy. The group table (the `types` argument): int4
// [groups, 0, 0, 0], then (kind, e0, e1, e2) a group, kind = 2 * shape +
// (0 permutation, 1 matrix) over sphere .. plane. A group's records run
// from the previous group's e2 (0 for the first) to its e2; a permutation
// group's are keyed by axis 0 up to e0, 1 up to e1, 2 up to e2.
constexpr int kRecord = 6;
constexpr int kMatrix = 3;     // transform; 0-2: a permutation keyed by axis
constexpr int kKinds = 5 * 2;  // (sphere .. plane) x (permutation, matrix)

// __launch_bounds__ of K1a/K1b: the largest block and the blocks an SM
// must hold, which caps the registers at 40 (tools/ab_march.py --sweep
// builds others)
#ifndef RT_ANALYTIC_MAX_THREADS
#define RT_ANALYTIC_MAX_THREADS 512
#endif
#ifndef RT_ANALYTIC_MIN_BLOCKS
#define RT_ANALYTIC_MIN_BLOCKS 3
#endif

// The staged scene of a K1a/K1b block: the pack's header and records, and
// the group table. Read by name, not through a pointer, so that every load
// is an LDS at an offset from the record index.
__shared__ float4 s_rec[1 + kMaxObjects * kRecord];
__shared__ int4 s_grp[1 + kKinds];

// The signed distance from (x, y, z) to the object of record r, a SHAPE
// with transform XF. The matrix: to_local's products in its order. A
// permutation keyed by axis K: the three u_a and the SDF of sd_shape on
// them, each read in the plain version's order of operations: the sum of
// squares of the sphere and the box adds rows 0 and 1 first and row 2 (axis
// K) last, and a sum of two is the same either way; the cylinder and the
// cone read row 1 (axis K) alone. The SDFs of the sphere, the box and the
// cylinder read u_a squared or through fabsf, so its sign (s_r) drops out;
// the cone's row 1 gets it back (a3), the plane's compare is |dist| with
// the sign folded into a1. So every distance equals the plain version's up
// to the sign of an exact zero, which no SDF reads.
template <int SHAPE, int XF>
__device__ __forceinline__ float object_sd(const float4* r, float x, float y,
                                           float z, float box_round) {
  const float4 r0 = r[0], r1 = r[1], r2 = r[2];
  if (XF == kMatrix) {
    const float4 m0 = r[3], m1 = r[4], m2 = r[5];
    const float tx = x - r0.x, ty = y - r0.y, tz = z - r0.z;
    const float px = m0.x * tx + m0.y * ty + m0.z * tz + r1.x;
    const float py = m1.x * tx + m1.y * ty + m1.z * tz + r1.y;
    const float pz = m2.x * tx + m2.y * ty + m2.z * tz + r1.z;
    return sd_shape(SHAPE, px, py, pz, r1.w, r2.x, r2.y, box_round);
  }
  const float ux = (x - r0.x) + r1.x, uy = (y - r0.y) + r1.y,
              uz = (z - r0.z) + r1.z;
  const float uk = XF == 0 ? ux : (XF == 1 ? uy : uz);
  const float ui = XF == 0 ? uy : ux;  // the other two axes, in order
  const float uj = XF == 2 ? uy : uz;
  switch (SHAPE) {
    case kBox: {
      const float sk = XF == 0 ? r1.w : (XF == 1 ? r2.x : r2.y);
      const float si = XF == 0 ? r2.x : r1.w;
      const float sj = XF == 2 ? r2.x : r2.y;
      return sd_shape(kBox, ui, uj, uk, si, sj, sk, box_round);
    }
    case kCylinder:
      return sd_shape(kCylinder, ui, uk, uj, r1.w, r2.x, 0.0f, box_round);
    case kCone:
      return sd_shape(kCone, ui, r2.z * uk, uj, r1.w, r2.x, r2.y,
                      box_round);
    case kPlane:
      return sd_shape(kPlane, 0.0f, uk, 0.0f, 0.0f, r2.x, 0.0f, box_round);
    default:  // kSphere
      return sd_shape(kSphere, ui, uj, uk, r1.w, 0.0f, 0.0f, box_round);
  }
}

// The trip's running min over (distance, object index), lexicographic (as
// march_pool.cuh's fold, the index kept as a float): from (1e3, 0) it
// equals the plain version's ordered strict < whatever order the records
// come in, a NaN never taken and nothing at 1e3 taken.
__device__ __forceinline__ void take(float& best, float& best_f, float dist,
                                     float idx) {
  if (dist < best || (dist == best && idx < best_f)) {
    best = dist;
    best_f = idx;
  }
}

// Records begin .. end, each a SHAPE with transform XF, folded in.
template <int SHAPE, int XF>
__device__ __forceinline__ void fold_run(int begin, int end, float x,
                                         float y, float z, float box_round,
                                         float& best, float& best_f) {
#pragma unroll 1
  for (int j = begin; j < end; ++j) {
    const float4* r = s_rec + 1 + kRecord * j;
    take(best, best_f, fabsf(object_sd<SHAPE, XF>(r, x, y, z, box_round)),
         r[0].w);
  }
}

// A group of kind KIND from record `start`: its matrix run, or its three
// permutation runs, each with its transform compiled in.
template <int KIND>
__device__ __forceinline__ void fold_group(int start, int4 G, float x,
                                           float y, float z, float box_round,
                                           float& best, float& best_f) {
  constexpr int SHAPE = kSphere + KIND / 2;
  if (KIND % 2) {
    fold_run<SHAPE, kMatrix>(start, G.w, x, y, z, box_round, best, best_f);
  } else {
    fold_run<SHAPE, 0>(start, G.y, x, y, z, box_round, best, best_f);
    fold_run<SHAPE, 1>(G.y, G.z, x, y, z, box_round, best, best_f);
    fold_run<SHAPE, 2>(G.z, G.w, x, y, z, box_round, best, best_f);
  }
}

// The running min at a point with a NaN or an infinite coordinate, as the
// plain version finds it. There its local coordinates (the matrix products,
// with 0 * inf and m * NaN) are each NaN or infinite, so of its SDFs only
// the sphere's can be under 1e3: its norm of a point with a NaN coordinate
// is 0 (safe_norm), a distance of -sx. The fast path's shortcuts (a
// permutation reads one axis, fmaxf drops a NaN) would differ there, so
// only the sphere groups (kinds 0 and 1, first in the table) are visited,
// on the matrix every record keeps.
__device__ __forceinline__ void fold_non_finite(int n_groups, float x,
                                                float y, float z,
                                                float& best, float& best_f) {
  int start = 0;
  for (int g = 1; g <= n_groups && s_grp[g].x < 2; ++g) {
    for (int j = start; j < s_grp[g].w; ++j) {
      const float4* r = s_rec + 1 + kRecord * j;
      const float4 r0 = r[0], m0 = r[3], m1 = r[4], m2 = r[5];
      const float tx = x - r0.x, ty = y - r0.y, tz = z - r0.z;
      const float px = m0.x * tx + m0.y * ty + m0.z * tz;
      const float py = m1.x * tx + m1.y * ty + m1.z * tz;
      const float pz = m2.x * tx + m2.y * ty + m2.z * tz;
      if (isnan(px) || isnan(py) || isnan(pz)) {
        take(best, best_f, fabsf(0.0f - r[1].w), r0.w);
      }
    }
    start = s_grp[g].w;
  }
}

template <int POLICY, int CRIT, bool BOUND>
__global__ void __launch_bounds__(RT_ANALYTIC_MAX_THREADS,
                                  RT_ANALYTIC_MIN_BLOCKS)
    march_kernel(const MarchArgs a) {
  const float4* pack = reinterpret_cast<const float4*>(a.params);
  for (int k = threadIdx.x; k < 1 + a.n_obj * kRecord; k += blockDim.x) {
    s_rec[k] = pack[k];
  }
  const int4* table = reinterpret_cast<const int4*>(a.types);
  for (int k = threadIdx.x; k < 1 + kKinds; k += blockDim.x) {
    s_grp[k] = table[k];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;

  const float bound2 = BOUND ? s_rec[0].x : 0.0f;
  const int n_groups = s_grp[0].x;
  Lane L = load_lane(a, lane);
  for (int i = 0; i < a.budget && !L.done; ++i) {
    const float x = L.ox + L.t * L.dx, y = L.oy + L.t * L.dy,
                z = L.oz + L.t * L.dz;
    float best = 1e3f, best_f = 0.0f;
    if (!(isfinite(x) && isfinite(y) && isfinite(z))) {
      fold_non_finite(n_groups, x, y, z, best, best_f);
    } else {
      int start = 0;
      for (int g = 1; g <= n_groups; ++g) {
        const int4 G = s_grp[g];
        switch (G.x) {
#define RT_KIND(k)                                                      \
  case k:                                                               \
    fold_group<k>(start, G, x, y, z, a.box_round, best, best_f);        \
    break;
          RT_KIND(0) RT_KIND(1) RT_KIND(2) RT_KIND(3) RT_KIND(4)
          RT_KIND(5) RT_KIND(6) RT_KIND(7) RT_KIND(8) RT_KIND(9)
#undef RT_KIND
        }
        start = G.w;
      }
    }
    advance<POLICY, CRIT, BOUND>(L, a, bound2, x, y, z, best, (int)best_f,
                                 i);
  }
  store_lane(a, lane, L);
}

// K1a/K1b on a scene without the bunny (a.bunny null), K1c with it.
struct Launch {
  template <int P, int C, bool B>
  static int launch(const MarchArgs& a, int block, cudaStream_t s) {
    if (a.bunny) return PoolLaunch<Fp32Mlp>::launch<P, C, B>(a, block, s);
    // the pack and the table are read as 16-byte vectors
    if (!a.params || !a.types || block <= 0 ||
        (reinterpret_cast<uintptr_t>(a.params) |
         reinterpret_cast<uintptr_t>(a.types)) % 16) {
      return (int)cudaErrorInvalidValue;
    }
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
// are device pointers to contiguous arrays: origin and direction (n, 3)
// f32, active (n,) bool, init (n,) f32; outputs (n,). With the bunny (K1c):
// params (n_obj, 32) f32 with bound^2 in row 0 column 18 when has_bound,
// types (n_obj,) i32, bunny (40, 16) f32; next_lane, one i32 the caller
// zeroed, and block 256; counts, two u64 to add to, or null: the MLP
// evaluations run (queue entries, with a warp's padding) and the lane slots
// of the warps' march steps (32 a warp step). Without the bunny (K1a/K1b):
// params the grouped pack (4 + n_obj * 24 f32) and types its group table
// ((1 + 10) x 4 i32), both 16-byte aligned, any block up to
// RT_ANALYTIC_MAX_THREADS; next_lane and counts are ignored.
int rt_march(RT_MARCH_PARAMS) {
  return rt::march_entry<Launch>(RT_MARCH_ARGS);
}

}  // extern "C"
