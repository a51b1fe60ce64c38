// Resumable enhanced-sphere-trace march for Hopper (sm_90a): kernels K1a,
// K1b and K1c.
//
// Replaces the Pallas TPU kernel raytracingpbr_tpu/pallas/march_kernel.py
// ::_march_kernel (with _sd_tile, _nearest_tile and _bunny_tile). One
// template, march_kernel<POLICY, CRIT, BOUND, BUNNY>, instantiated for every
// combination:
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
// Design: one thread per ray lane with its own loop exit. SIMT gives the
// per-lane early exit the TPU kernel approximated with (8|32, 128) tiles and
// a 32-trip unroll between cross-lane convergence checks; a lane that stops
// early writes the same outputs as the lock-step plain march, whose done
// lanes are frozen. Each block stages the packed scene (n_obj x 18 floats
// plus the shape types) and, for K1c, the 40 x 16 MLP weights (2.5 KB) in
// shared memory once; the object loop then reads shared memory with a type
// switch that is uniform across the warp. The MLP runs per lane only inside
// the unit sphere: the branch takes the place of the TPU kernel's tile-level
// skip, and a warp whose lanes are all outside skips it whole.
//
// Bound: FP32 ALU work. A lane-trip costs about 25 flops per analytic
// object, and about 1,300 flops plus 48 sinf for a bunny lane inside the
// unit sphere; a lane reads about 40 bytes (origin, direction, gate, resume
// state) once and writes 29. So memory traffic is negligible and the kernel
// is bound by instruction issue and by divergence of trip counts (and of the
// MLP branch) within a warp. The MLP keeps 32 activations per lane live in
// registers.
//
// Numerics: built with -fmad=false and without fast math, every add and
// multiply rounds on its own, sqrtf and the division are IEEE and sinf is
// libdevice's full-range sinf, as PyTorch's elementwise CUDA ops do. The
// expression order follows ops/sdf.py, ops/scene.py and ops/march.py (the
// bunny as sdf.bunny_mlp_eval_unrolled), and every constant the plain march
// takes from a Python float arrives here already rounded to f32, so the
// kernel and the plain PyTorch march agree bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParamStride = 32;  // floats per object in the packed block
constexpr int kParamUsed = 18;    // pos(3) scale(3) matrix(9) offset(3)
constexpr int kBoundCol = 18;     // bound^2, row 0, when the bound is on
constexpr int kMaxObjects = 128;
constexpr int kBunnyWeights = 40 * 16;  // kernels/march_kernel.pack_bunny

// Shape ids of ops/sdf.SHAPE.
constexpr int kNone = 0, kSphere = 1, kBox = 2, kCylinder = 3, kCone = 4,
              kPlane = 5, kBunny = 6;
// config.OmegaPolicy and config.HitCriterion, as the wrapper numbers them.
constexpr int kConstant = 0, kRollbackToOne = 1, kRollbackHalfUp = 2;
constexpr int kAbsolute = 0, kRelative = 1, kConeHit = 2;

struct MarchArgs {
  const float* params;  // (n_obj, 32)
  const int* types;     // (n_obj,)
  const float* bunny;   // (40, 16) or null
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

// The bunny SDF in local coordinates; w is the (40, 16) block of
// pack_bunny: rows 0-2 w_in, 3 b_in, 4-19 w_h1, 20 b_h1, 21-36 w_h2,
// 37 b_h2, 38 w_out, 39 [bias_out, 0, ...]. The operation order is
// _bunny_tile's (and sdf.bunny_mlp_eval_unrolled's).
__device__ __forceinline__ float sd_bunny(const float* w, float px, float py,
                                          float pz) {
  const float r = sqrtf(px * px + py * py + pz * pz);
  if (r > 1.0f) return r - 0.8f;
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

template <int POLICY, int CRIT, bool BOUND, bool BUNNY>
__global__ void march_kernel(const MarchArgs a) {
  __shared__ float sp[kMaxObjects * kParamUsed];
  __shared__ int st[kMaxObjects];
  __shared__ float sw[BUNNY ? kBunnyWeights : 1];
  for (int k = threadIdx.x; k < a.n_obj * kParamUsed; k += blockDim.x) {
    sp[k] = a.params[(k / kParamUsed) * kParamStride + k % kParamUsed];
  }
  for (int k = threadIdx.x; k < a.n_obj; k += blockDim.x) st[k] = a.types[k];
  if (BUNNY) {
    for (int k = threadIdx.x; k < kBunnyWeights; k += blockDim.x) {
      sw[k] = a.bunny[k];
    }
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;

  const float bound2 = BOUND ? a.params[kBoundCol] : 0.0f;
  const float ox = a.origin[3 * lane], oy = a.origin[3 * lane + 1],
              oz = a.origin[3 * lane + 2];
  const float dx = a.direction[3 * lane], dy = a.direction[3 * lane + 1],
              dz = a.direction[3 * lane + 2];
  float t = a.init_t ? a.init_t[lane] : a.t0;
  float w = a.init_w ? a.init_w[lane] : a.w0;
  float s = a.init_s ? a.init_s[lane] : 0.0f;
  float d = a.init_d ? a.init_d[lane] : 1e3f;
  int idx = 0;
  uint8_t hit = 0;
  bool done = a.active ? a.active[lane] == 0 : false;
  int fin = done ? 0 : a.budget;

  for (int i = 0; i < a.budget && !done; ++i) {
    const float x = ox + t * dx, y = oy + t * dy, z = oz + t * dz;
    float best = 1e3f;  // running min of |sd|: first object wins ties
    int best_i = 0;
    for (int o = 0; o < a.n_obj; ++o) {
      const float* pr = sp + o * kParamUsed;
      const float tx = x - pr[0], ty = y - pr[1], tz = z - pr[2];
      const float px = pr[6] * tx + pr[7] * ty + pr[8] * tz + pr[15];
      const float py = pr[9] * tx + pr[10] * ty + pr[11] * tz + pr[16];
      const float pz = pr[12] * tx + pr[13] * ty + pr[14] * tz + pr[17];
      const float dist =
          (BUNNY && st[o] == kBunny)
              ? fabsf(sd_bunny(sw, px, py, pz))
              : fabsf(sd_shape(st[o], px, py, pz, pr[3], pr[4], pr[5],
                               a.box_round));
      if (dist < best) {
        best = dist;
        best_i = o;
      }
    }

    bool rollback = false;
    float w_next = w;
    if (POLICY != kConstant) {
      // relative epsilon: exactly touching bounds (d + dist == s) must
      // roll back or the ray tunnels
      rollback = d + best < s * a.one_eps;
      if (POLICY == kRollbackToOne) {
        rollback = rollback && (w > 1.0f);
        w_next = rollback ? 1.0f : w;
      } else {  // kRollbackHalfUp
        w_next = rollback ? 0.5f + 0.5f * w : w;
      }
    }
    const float s_rb = s * (1.0f - w);
    const float s_fwd = w_next * best;

    bool hit_now;
    if (CRIT == kConeHit) {
      hit_now = best < (t + s_fwd) * a.pixel_radius;
    } else if (CRIT == kRelative) {
      hit_now = best / fmaxf(t, (float)1e-12) < a.pixel_radius;
    } else {
      hit_now = best < a.hit_precision;
    }

    const float step = rollback ? s_rb : s_fwd;
    t = t + step;
    w = w_next;
    s = step;
    d = best;
    idx = best_i;
    if (!rollback) {
      hit = hit_now;
      bool escaped = t >= a.max_dis;
      if (BOUND) {
        // outside the scene's bounding sphere and receding: no hit ahead
        escaped = escaped || ((x * x + y * y + z * z > bound2) &&
                              (x * dx + y * dy + z * dz > 0.0f));
      }
      if (hit_now || escaped) {
        done = true;
        fin = i + 1;
      }
    }
  }

  a.t_out[lane] = t;
  a.idx_out[lane] = idx;
  a.hit_out[lane] = hit;
  a.fin_out[lane] = fin;
  a.w_out[lane] = w;
  a.s_out[lane] = s;
  a.d_out[lane] = d;
  a.done_out[lane] = done ? 1 : 0;
}

template <int P, int C, bool B, bool U>
int launch(const MarchArgs& a, int block, cudaStream_t stream) {
  const int grid = (a.n + block - 1) / block;
  march_kernel<P, C, B, U><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int P, int C>
int dispatch_bound_bunny(const MarchArgs& a, bool bound, bool bunny,
                         int block, cudaStream_t s) {
  if (bunny) {
    return bound ? launch<P, C, true, true>(a, block, s)
                 : launch<P, C, false, true>(a, block, s);
  }
  return bound ? launch<P, C, true, false>(a, block, s)
               : launch<P, C, false, false>(a, block, s);
}

template <int P>
int dispatch_crit(const MarchArgs& a, int crit, bool bound, bool bunny,
                  int block, cudaStream_t s) {
  switch (crit) {
    case kAbsolute:
      return dispatch_bound_bunny<P, kAbsolute>(a, bound, bunny, block, s);
    case kRelative:
      return dispatch_bound_bunny<P, kRelative>(a, bound, bunny, block, s);
    case kConeHit:
      return dispatch_bound_bunny<P, kConeHit>(a, bound, bunny, block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int rt_march_max_objects() { return kMaxObjects; }

// Launches the march variant (policy, crit, has_bound, bunny given) on
// `stream` and returns cudaGetLastError(). Optional inputs (active, the
// four init arrays, bunny when the scene has none) may be null. Pointers
// are device pointers to contiguous arrays: params (n_obj, 32) f32 with
// bound^2 in row 0 column 18 when has_bound, types (n_obj,) i32, bunny
// (40, 16) f32, origin and direction (n, 3) f32, active (n,) bool, init
// (n,) f32; outputs (n,).
int rt_march(const float* params, const int* types, const float* bunny,
             int n_obj, float box_round, const float* origin,
             const float* direction, const uint8_t* active,
             const float* init_t, const float* init_w, const float* init_s,
             const float* init_d, float t0, float w0, float hit_precision,
             float max_dis, float pixel_radius, float one_eps, int policy,
             int crit, int has_bound, int budget, int n, float* t_out,
             int* idx_out, uint8_t* hit_out, int* fin_out, float* w_out,
             float* s_out, float* d_out, int* done_out, int block,
             void* stream) {
  if (n <= 0) return 0;
  if (n_obj < 0 || n_obj > kMaxObjects) return (int)cudaErrorInvalidValue;
  const MarchArgs a{params, types, bunny, n_obj, box_round, origin,
                    direction, active, init_t, init_w, init_s, init_d,
                    t0, w0, hit_precision, max_dis, pixel_radius, one_eps,
                    budget, n, t_out, idx_out, hit_out, fin_out, w_out,
                    s_out, d_out, done_out};
  const bool bound = has_bound != 0, has_bunny = bunny != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  switch (policy) {
    case kConstant:
      return dispatch_crit<kConstant>(a, crit, bound, has_bunny, block, s);
    case kRollbackToOne:
      return dispatch_crit<kRollbackToOne>(a, crit, bound, has_bunny, block,
                                           s);
    case kRollbackHalfUp:
      return dispatch_crit<kRollbackHalfUp>(a, crit, bound, has_bunny,
                                            block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
