// What the march kernels K1a-K1c (march.cu) and K1d (march_mxu.cu) share:
// the argument block, the analytic SDFs, the per-lane loop state with its
// update after one trip, the staging of the scene in shared memory, and the
// dispatch of the runtime (policy, hit criterion, escape bound) to template
// instances.
//
// Numerics: every source that includes this is built with -fmad=false and
// without fast math, so every add and multiply rounds on its own, sqrtf and
// the division are IEEE, as PyTorch's elementwise CUDA ops are. The
// expression order follows ops/sdf.py, ops/scene.py and ops/march.py, and
// every constant the plain march takes from a Python float arrives already
// rounded to f32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The C entry both march libraries export as rt_march.
#define RT_MARCH_PARAMS                                                     \
  const float *params, const int *types, const float *bunny, int n_obj,    \
      float box_round, const float *origin, const float *direction,        \
      const uint8_t *active, const float *init_t, const float *init_w,     \
      const float *init_s, const float *init_d, float t0, float w0,        \
      float hit_precision, float max_dis, float pixel_radius,              \
      float one_eps, int policy, int crit, int has_bound, int budget,      \
      int n, float *t_out, int *idx_out, uint8_t *hit_out, int *fin_out,   \
      float *w_out, float *s_out, float *d_out, int *done_out,             \
      int *next_lane, unsigned long long *counts, int block, void *stream
#define RT_MARCH_ARGS                                                       \
  params, types, bunny, n_obj, box_round, origin, direction, active,       \
      init_t, init_w, init_s, init_d, t0, w0, hit_precision, max_dis,      \
      pixel_radius, one_eps, policy, crit, has_bound, budget, n, t_out,    \
      idx_out, hit_out, fin_out, w_out, s_out, d_out, done_out, next_lane, \
      counts, block, stream

namespace rt {

constexpr int kParamStride = 32;  // floats per object in the packed block
constexpr int kParamUsed = 18;    // pos(3) scale(3) matrix(9) offset(3)
constexpr int kBoundCol = 18;     // bound^2, row 0, when the bound is on
constexpr int kMaxObjects = 128;

// Shape ids of ops/sdf.SHAPE.
constexpr int kNone = 0, kSphere = 1, kBox = 2, kCylinder = 3, kCone = 4,
              kPlane = 5, kBunny = 6;
// config.OmegaPolicy and config.HitCriterion, as the wrapper numbers them.
constexpr int kConstant = 0, kRollbackToOne = 1, kRollbackHalfUp = 2;
constexpr int kAbsolute = 0, kRelative = 1, kConeHit = 2;

struct MarchArgs {
  const float* params;  // (n_obj, 32)
  const int* types;     // (n_obj,)
  const float* bunny;   // the MLP block of the kernel's packing, or null
  int n_obj;
  float box_round;
  const float* origin;     // (n, 3)
  const float* direction;  // (n, 3)
  const uint8_t* active;   // (n,) or null
  const float *init_t, *init_w, *init_s, *init_d;  // (n,) each, or null
  float t0, w0, hit_precision, max_dis, pixel_radius, one_eps;
  int budget, n;
  float* t_out;
  int* idx_out;
  uint8_t* hit_out;
  int* fin_out;
  float *w_out, *s_out, *d_out;
  int* done_out;
  // The bunny kernels' lane pool (march_pool.cuh): the next lane to hand
  // out, zeroed by the caller; and, or null, two tallies the kernel adds
  // to: MLP evaluations run and lane slots of the warps that marched a
  // step. K1a/K1b ignore both.
  int* next_lane;
  unsigned long long* counts;
};

__device__ __forceinline__ float sd_shape(int type, float px, float py,
                                          float pz, float sx, float sy,
                                          float sz, float box_round) {
  switch (type) {
    case kSphere:
      return sqrtf(px * px + py * py + pz * pz) - sx;
    case kBox: {
      float qx = fabsf(px) - sx, qy = fabsf(py) - sy, qz = fabsf(pz) - sz;
      float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
      float outside = sqrtf(ox * ox + oy * oy + oz * oz);
      float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
      return outside + inside - box_round;
    }
    case kCylinder: {
      float dx = fabsf(sqrtf(px * px + pz * pz)) - sx;
      float dy = fabsf(py) - sy;
      float mx = fmaxf(dx, 0.0f), my = fmaxf(dy, 0.0f);
      return fminf(fmaxf(dx, dy), 0.0f) + sqrtf(mx * mx + my * my);
    }
    case kCone: {
      float q = sqrtf(px * px + pz * pz);
      return fmaxf(sx * q + sz * py, -sy - py);
    }
    case kPlane:
      return py - sy;
    default:  // kNone
      return 1e3f;
  }
}

// Object-space point of object row `pr` of the staged scene: translate,
// rotate (row products in the plain version's order), animation offset.
__device__ __forceinline__ void to_local(const float* pr, float x, float y,
                                         float z, float& px, float& py,
                                         float& pz) {
  const float tx = x - pr[0], ty = y - pr[1], tz = z - pr[2];
  px = pr[6] * tx + pr[7] * ty + pr[8] * tz + pr[15];
  py = pr[9] * tx + pr[10] * ty + pr[11] * tz + pr[16];
  pz = pr[12] * tx + pr[13] * ty + pr[14] * tz + pr[17];
}

// Copies the packed scene (n_obj x 18 floats) and the shape types into
// shared memory. The caller synchronises the block afterwards.
__device__ __forceinline__ void stage_scene(const MarchArgs& a, float* sp,
                                            int* st) {
  for (int k = threadIdx.x; k < a.n_obj * kParamUsed; k += blockDim.x) {
    sp[k] = a.params[(k / kParamUsed) * kParamStride + k % kParamUsed];
  }
  for (int k = threadIdx.x; k < a.n_obj; k += blockDim.x) st[k] = a.types[k];
}

// One lane's loop state, read from the resume inputs and written out whole.
struct Lane {
  float ox, oy, oz, dx, dy, dz;
  float t, w, s, d;
  int idx;
  uint8_t hit;
  bool done;
  int fin;
};

__device__ __forceinline__ Lane load_lane(const MarchArgs& a, int lane) {
  Lane L;
  L.ox = a.origin[3 * lane];
  L.oy = a.origin[3 * lane + 1];
  L.oz = a.origin[3 * lane + 2];
  L.dx = a.direction[3 * lane];
  L.dy = a.direction[3 * lane + 1];
  L.dz = a.direction[3 * lane + 2];
  L.t = a.init_t ? a.init_t[lane] : a.t0;
  L.w = a.init_w ? a.init_w[lane] : a.w0;
  L.s = a.init_s ? a.init_s[lane] : 0.0f;
  L.d = a.init_d ? a.init_d[lane] : 1e3f;
  L.idx = 0;
  L.hit = 0;
  L.done = a.active ? a.active[lane] == 0 : false;
  L.fin = L.done ? 0 : a.budget;
  return L;
}

__device__ __forceinline__ void store_lane(const MarchArgs& a, int lane,
                                           const Lane& L) {
  a.t_out[lane] = L.t;
  a.idx_out[lane] = L.idx;
  a.hit_out[lane] = L.hit;
  a.fin_out[lane] = L.fin;
  a.w_out[lane] = L.w;
  a.s_out[lane] = L.s;
  a.d_out[lane] = L.d;
  a.done_out[lane] = L.done ? 1 : 0;
}

// The update after trip i of a live lane that sampled the point (x, y, z)
// and found `best` at object `best_i`: the omega policy, the hit test, the
// step, and the escape test (ops/march._march_loop's body).
template <int POLICY, int CRIT, bool BOUND>
__device__ __forceinline__ void advance(Lane& L, const MarchArgs& a,
                                        float bound2, float x, float y,
                                        float z, float best, int best_i,
                                        int i) {
  bool rollback = false;
  float w_next = L.w;
  if (POLICY != kConstant) {
    // relative epsilon: exactly touching bounds (d + dist == s) must roll
    // back or the ray tunnels
    rollback = L.d + best < L.s * a.one_eps;
    if (POLICY == kRollbackToOne) {
      rollback = rollback && (L.w > 1.0f);
      w_next = rollback ? 1.0f : L.w;
    } else {  // kRollbackHalfUp
      w_next = rollback ? 0.5f + 0.5f * L.w : L.w;
    }
  }
  const float s_rb = L.s * (1.0f - L.w);
  const float s_fwd = w_next * best;

  bool hit_now;
  if (CRIT == kConeHit) {
    hit_now = best < (L.t + s_fwd) * a.pixel_radius;
  } else if (CRIT == kRelative) {
    hit_now = best / fmaxf(L.t, (float)1e-12) < a.pixel_radius;
  } else {
    hit_now = best < a.hit_precision;
  }

  const float step = rollback ? s_rb : s_fwd;
  L.t = L.t + step;
  L.w = w_next;
  L.s = step;
  L.d = best;
  L.idx = best_i;
  if (!rollback) {
    L.hit = hit_now;
    bool escaped = L.t >= a.max_dis;
    if (BOUND) {
      // outside the scene's bounding sphere and receding: no hit ahead
      escaped = escaped || ((x * x + y * y + z * z > bound2) &&
                            (x * L.dx + y * L.dy + z * L.dz > 0.0f));
    }
    if (hit_now || escaped) {
      L.done = true;
      L.fin = i + 1;
    }
  }
}

template <class K, int P, int C>
int dispatch_bound(const MarchArgs& a, bool bound, int block,
                   cudaStream_t s) {
  return bound ? K::template launch<P, C, true>(a, block, s)
               : K::template launch<P, C, false>(a, block, s);
}

template <class K, int P>
int dispatch_crit(const MarchArgs& a, int crit, bool bound, int block,
                  cudaStream_t s) {
  switch (crit) {
    case kAbsolute:
      return dispatch_bound<K, P, kAbsolute>(a, bound, block, s);
    case kRelative:
      return dispatch_bound<K, P, kRelative>(a, bound, block, s);
    case kConeHit:
      return dispatch_bound<K, P, kConeHit>(a, bound, block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The body of a library's C entry: checks the sizes, fills MarchArgs and
// calls K::launch<POLICY, CRIT, BOUND>(args, block, stream) for the runtime
// (policy, crit, has_bound); returns cudaGetLastError() of the launch.
template <class K>
int march_entry(RT_MARCH_PARAMS) {
  if (n <= 0) return 0;
  if (n_obj < 0 || n_obj > kMaxObjects) return (int)cudaErrorInvalidValue;
  const MarchArgs a{params, types, bunny, n_obj, box_round, origin,
                    direction, active, init_t, init_w, init_s, init_d,
                    t0, w0, hit_precision, max_dis, pixel_radius, one_eps,
                    budget, n, t_out, idx_out, hit_out, fin_out, w_out,
                    s_out, d_out, done_out, next_lane, counts};
  const bool bound = has_bound != 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (policy) {
    case kConstant:
      return dispatch_crit<K, kConstant>(a, crit, bound, block, s);
    case kRollbackToOne:
      return dispatch_crit<K, kRollbackToOne>(a, crit, bound, block, s);
    case kRollbackHalfUp:
      return dispatch_crit<K, kRollbackHalfUp>(a, crit, bound, block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rt

