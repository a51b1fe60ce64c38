// Resumable enhanced-sphere-trace march for Hopper (sm_90a): kernel K1a.
//
// Replaces the Pallas TPU kernel raytracingpbr_tpu/pallas/march_kernel.py
// ::_march_kernel (with _sd_tile and _nearest_tile) on the wavefront's main
// path: CONSTANT omega, ABSOLUTE hit test, no escape bound, analytic shapes,
// active gate and resume from (t, w, s, d).
//
// Design: one thread per ray lane with its own loop exit. SIMT gives the
// per-lane early exit the TPU kernel approximated with (8|32, 128) tiles and
// a 32-trip unroll between cross-lane convergence checks; a lane that stops
// early writes the same outputs as the lock-step plain march, whose done
// lanes are frozen. Each block stages the packed scene (n_obj x 18 floats
// plus the shape types) in shared memory once; the object loop then reads
// shared memory with a type switch that is uniform across the warp.
//
// Bound: FP32 ALU work. A lane-trip costs about 25 flops per box object
// (8 objects on the Cornell path) and reads nothing from device memory after
// the first trip; a lane reads about 40 bytes (origin, direction, gate,
// resume state) once and writes 29. So memory traffic is negligible and the
// kernel is bound by instruction issue and by divergence of trip counts
// within a warp.
//
// Numerics: built with -fmad=false and without fast math, every add and
// multiply rounds on its own and sqrtf is IEEE, as PyTorch's elementwise
// CUDA ops do. The expression order follows ops/sdf.py and ops/scene.py, so
// the kernel and the plain PyTorch march agree bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParamStride = 32;  // floats per object in the packed block
constexpr int kParamUsed = 18;    // pos(3) scale(3) matrix(9) offset(3)
constexpr int kMaxObjects = 128;

// Shape ids of ops/sdf.SHAPE.
constexpr int kNone = 0, kSphere = 1, kBox = 2, kCylinder = 3, kCone = 4,
              kPlane = 5;

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

__global__ void march_k1a_kernel(
    const float* __restrict__ params, const int* __restrict__ types,
    int n_obj, float box_round, const float* __restrict__ origin,
    const float* __restrict__ direction, const uint8_t* __restrict__ active,
    const float* __restrict__ init_t, const float* __restrict__ init_w,
    const float* __restrict__ init_s, const float* __restrict__ init_d,
    float t0, float w0, float hit_precision, float max_dis, int budget,
    int n, float* __restrict__ t_out, int* __restrict__ idx_out,
    uint8_t* __restrict__ hit_out, int* __restrict__ fin_out,
    float* __restrict__ w_out, float* __restrict__ s_out,
    float* __restrict__ d_out, int* __restrict__ done_out) {
  __shared__ float sp[kMaxObjects * kParamUsed];
  __shared__ int st[kMaxObjects];
  for (int k = threadIdx.x; k < n_obj * kParamUsed; k += blockDim.x) {
    sp[k] = params[(k / kParamUsed) * kParamStride + k % kParamUsed];
  }
  for (int k = threadIdx.x; k < n_obj; k += blockDim.x) st[k] = types[k];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const float ox = origin[3 * lane], oy = origin[3 * lane + 1],
              oz = origin[3 * lane + 2];
  const float dx = direction[3 * lane], dy = direction[3 * lane + 1],
              dz = direction[3 * lane + 2];
  float t = init_t ? init_t[lane] : t0;
  float w = init_w ? init_w[lane] : w0;
  float s = init_s ? init_s[lane] : 0.0f;
  float d = init_d ? init_d[lane] : 1e3f;
  int idx = 0;
  uint8_t hit = 0;
  bool done = active ? active[lane] == 0 : false;
  int fin = done ? 0 : budget;

  for (int i = 0; i < budget && !done; ++i) {
    const float x = ox + t * dx, y = oy + t * dy, z = oz + t * dz;
    float best = 1e3f;  // running min of |sd|: first object wins ties
    int best_i = 0;
    for (int o = 0; o < n_obj; ++o) {
      const float* pr = sp + o * kParamUsed;
      const float tx = x - pr[0], ty = y - pr[1], tz = z - pr[2];
      const float px = pr[6] * tx + pr[7] * ty + pr[8] * tz + pr[15];
      const float py = pr[9] * tx + pr[10] * ty + pr[11] * tz + pr[16];
      const float pz = pr[12] * tx + pr[13] * ty + pr[14] * tz + pr[17];
      const float dist = fabsf(
          sd_shape(st[o], px, py, pz, pr[3], pr[4], pr[5], box_round));
      if (dist < best) {
        best = dist;
        best_i = o;
      }
    }
    // CONSTANT omega: never rolls back; w is unchanged.
    const float step = w * best;
    const bool hit_now = best < hit_precision;
    t = t + step;
    s = step;
    d = best;
    idx = best_i;
    hit = hit_now;
    if (hit_now || t >= max_dis) {
      done = true;
      fin = i + 1;
    }
  }

  t_out[lane] = t;
  idx_out[lane] = idx;
  hit_out[lane] = hit;
  fin_out[lane] = fin;
  w_out[lane] = w;
  s_out[lane] = s;
  d_out[lane] = d;
  done_out[lane] = done ? 1 : 0;
}

}  // namespace

extern "C" {

int rt_march_max_objects() { return kMaxObjects; }

// Launches K1a on `stream` and returns cudaGetLastError(). Optional inputs
// (active, the four init arrays) may be null. Pointers are device pointers
// to contiguous arrays: params (n_obj, 32) f32, types (n_obj,) i32, origin
// and direction (n, 3) f32, active (n,) bool, init (n,) f32; outputs (n,).
int rt_march_k1a(const float* params, const int* types, int n_obj,
                 float box_round, const float* origin, const float* direction,
                 const uint8_t* active, const float* init_t,
                 const float* init_w, const float* init_s, const float* init_d,
                 float t0, float w0, float hit_precision, float max_dis,
                 int budget, int n, float* t_out, int* idx_out,
                 uint8_t* hit_out, int* fin_out, float* w_out, float* s_out,
                 float* d_out, int* done_out, int block, void* stream) {
  if (n <= 0) return 0;
  if (n_obj < 0 || n_obj > kMaxObjects) return (int)cudaErrorInvalidValue;
  const int grid = (n + block - 1) / block;
  march_k1a_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      params, types, n_obj, box_round, origin, direction, active, init_t,
      init_w, init_s, init_d, t0, w0, hit_precision, max_dis, budget, n,
      t_out, idx_out, hit_out, fin_out, w_out, s_out, d_out, done_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
