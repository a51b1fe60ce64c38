// The analytic surface normal: one launch a call of ops/scene.calc_normal's
// first-order branch on the card.
//
// Replaces no TPU kernel: the JAX package's normal is jax.grad under XLA.
// The port's autograd normal evaluates every object's signed distance at
// every lane as (N, k, 3) tensors a shape bucket, gathers the lane's own
// column and runs autograd's backward through all of it: about 250
// kernels a call on the tokyo scene. Here one thread takes one lane: it
// reads the lane's point and object index, moves the point into that one
// object's frame (sdf.to_object_space), writes out the closed-form
// gradient of that object's SDF, turns it back with the matrix's transpose
// and normalises it. No other object is evaluated: autograd's gradient
// from every other object is +0 (an upstream +0 through finite partials),
// and a sum of one value and +0s is that value, with an exact zero as +0.
//
// Bit-equal to the autograd normal on the card. Built with -fmad=false and
// no fast math, every add, multiply, divide and square root rounds as
// PyTorch's elementwise CUDA ops do, and each follows autograd's backward
// formula in its order (ops/scene.calc_normal_closed_plain is the same
// arithmetic in PyTorch):
//   - abs: g * sign(x), 0 at x = 0;
//   - maximum/minimum: half the gradient to each side at a tie;
//   - amax: the gradient over the count of tied entries, to each of them;
//   - core/math.safe_norm: sqrt's u / (2 * result) behind both where
//     guards (0 at v = 0), and v * v's two equal terms gsq*v + gsq*v;
//   - the rotation's transpose: rows 2, 1, 0 accumulated into each world
//     component (the order autograd's engine runs the row products'
//     backward), then + 0 (autograd's select backward adds +0s);
//   - a point not finite: NaN where another curved object adds NaN;
//   - the normalisation: torch.linalg.vector_norm's reduction on the card,
//     (x*x + z*z) + y*y (two threads split the three entries, the first
//     takes entries 0 and 2), a true square root and a true divide.
// NaN points give NaN normals as autograd's do: every comparison is
// written as autograd's mask is, and the maxima propagate NaN.
//
// Bound: bytes. A lane reads its point (12 B) and index (4 or 8 B) and
// writes the normal (12 B); the scene's few hundred bytes stay in cache.
// The arithmetic is a few dozen operations a lane, far below the byte
// line. A warp's loads and stores of the (N, 3) rows are three
// consecutive 128 B lines each.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

// ops/sdf.SHAPE
enum Shape { NONE = 0, SPHERE = 1, BOX = 2, CYLINDER = 3, CONE = 4,
             PLANE = 5 };

struct Args {
  const float* p;    // (n, 3) contiguous
  const void* idx;   // (n,) int32 or int64
  float* out;        // (n, 3) contiguous
  long long n;
  int num_objects;
  int num_curved;  // objects of SPHERE, BOX, CYLINDER or CONE
  // the scene's buffers, read in place: element strides
  const float* position; long long pos_o, pos_c;
  const float* matrix; long long mat_o, mat_r, mat_c;
  const float* offset; long long off_o, off_c;
  const float* scale; long long scl_o, scl_c;
  const int32_t* type_ids; long long typ_o;
};

// torch.amax's value: NaN if any entry is
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// torch.maximum(x, 0)'s value (its sign at a zero is never read)
__device__ __forceinline__ float max0(float x) {
  return x != x ? x : (x > 0.f ? x : 0.f);
}

// sgn(x) as torch.sign computes it: 0 at 0 and at NaN
__device__ __forceinline__ float sgn(float x) {
  return (float)((0.f < x) - (x < 0.f));
}

// torch.maximum(x, 0)'s gradient to x under g
__device__ __forceinline__ float max0_grad(float x, float g) {
  return x < 0.f ? 0.f : (x == 0.f ? g / 2.f : g);
}

// safe_norm's gradient over v[0..N) under u, into g
template <int N>
__device__ __forceinline__ void safe_norm_grad(const float* v, float u,
                                               float* g) {
  float sq = v[0] * v[0];
  for (int k = 1; k < N; ++k) sq = sq + v[k] * v[k];
  const bool pos = sq > 0.f;
  const float safe = sqrtf(pos ? sq : 1.f);
  const float gsq = pos ? u / (2.f * safe) : 0.f;
  for (int k = 0; k < N; ++k) g[k] = gsq * v[k] + gsq * v[k];
}

// min(amax(d), 0) + safe_norm(max(d, 0))'s gradient to d[0..N) under an
// upstream 1, into g (sd_round_box and sd_cylinder both end so): minimum's
// 1, 0.5 at the tie or 0, split by amax evenly over the tied entries; the
// norm's gradient through maximum's
template <int N>
__device__ __forceinline__ void grad_box_like(const float* d, float* g) {
  float inner = d[0];
  for (int k = 1; k < N; ++k) inner = max_nan(inner, d[k]);
  const float gi = inner > 0.f ? 0.f : (inner == 0.f ? 0.5f : 1.f);
  float cnt = d[0] == inner ? 1.f : 0.f;
  for (int k = 1; k < N; ++k) cnt = cnt + (d[k] == inner ? 1.f : 0.f);
  const float share = gi / cnt;
  float m[N], outside[N];
  for (int k = 0; k < N; ++k) m[k] = max0(d[k]);
  safe_norm_grad<N>(m, 1.f, outside);
  for (int k = 0; k < N; ++k)
    g[k] = max0_grad(d[k], outside[k])
           + share * (d[k] == inner ? 1.f : 0.f);
}

// sd_round_box: q = |p| - s; abs passes g * sign(p)
__device__ __forceinline__ void grad_box(const float* p, const float* s,
                                         float* g) {
  float q[3];
  for (int k = 0; k < 3; ++k) q[k] = fabsf(p[k]) - s[k];
  grad_box_like<3>(q, g);
  for (int k = 0; k < 3; ++k) g[k] = g[k] * sgn(p[k]);
}

// safe_norm(p.xz) as the forward computes it
__device__ __forceinline__ float norm_xz(float x, float z) {
  const float sq = x * x + z * z;
  return sq > 0.f ? sqrtf(sq) : 0.f;
}

// sd_cylinder: d = |(safe_norm(p.xz), p.y)| - s.xy
__device__ __forceinline__ void grad_cylinder(const float* p, const float* s,
                                              float* g) {
  const float xz[2] = {p[0], p[2]};
  const float dxz = norm_xz(p[0], p[2]);
  const float d[2] = {fabsf(dxz) - s[0], fabsf(p[1]) - s[1]};
  float gd[2], gxz[2];
  grad_box_like<2>(d, gd);
  safe_norm_grad<2>(xz, gd[0] * sgn(dxz), gxz);
  g[0] = gxz[0];
  g[1] = gd[1] * sgn(p[1]);
  g[2] = gxz[1];
}

// sd_cone: max(s.x * safe_norm(p.xz) + s.z * p.y, -s.y - p.y)
__device__ __forceinline__ void grad_cone(const float* p, const float* s,
                                          float* g) {
  const float xz[2] = {p[0], p[2]};
  const float d = s[0] * norm_xz(p[0], p[2]) + s[2] * p[1];
  const float e = -s[1] - p[1];
  const float tie = d == e ? 0.5f : 1.f;
  const float gd = d < e ? 0.f : tie;
  const float ge = d > e ? 0.f : tie;
  float gxz[2];
  safe_norm_grad<2>(xz, gd * s[0], gxz);
  g[0] = gxz[0];
  g[1] = gd * s[2] + -ge;
  g[2] = gxz[1];
}

__global__ void __launch_bounds__(BLOCK) normal_kernel(Args a, bool idx64) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const long long k = idx64 ? static_cast<const int64_t*>(a.idx)[i]
                            : (long long)static_cast<const int32_t*>(a.idx)[i];
  float* out = a.out + 3 * i;
  if (k < 0 || k >= a.num_objects) {  // gather would refuse it
    out[0] = out[1] = out[2] = __int_as_float(0x7fffffff);
    return;
  }
  const float* pi = a.p + 3 * i;
  const int type = a.type_ids[k * a.typ_o];
  // A point not finite makes every other curved object's gradient NaN
  // (an upstream 0 times a NaN or infinite partial), and autograd adds
  // them in; a plane's gradient reads no point
  const bool curved = type >= SPHERE && type <= CONE;
  if (!(isfinite(pi[0]) && isfinite(pi[1]) && isfinite(pi[2]))
      && a.num_curved > (curved ? 1 : 0)) {
    out[0] = out[1] = out[2] = __int_as_float(0x7fffffff);
    return;
  }
  const float* pos = a.position + k * a.pos_o;
  const float* mat = a.matrix + k * a.mat_o;
  const float* off = a.offset + k * a.off_o;
  const float* scl = a.scale + k * a.scl_o;
  float M[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) M[r][c] = mat[r * a.mat_r + c * a.mat_c];
  // sdf.to_object_space: translate, the row products, the offset
  float q[3], pl[3], s[3];
  for (int c = 0; c < 3; ++c) {
    q[c] = pi[c] - pos[c * a.pos_c];
    s[c] = scl[c * a.scl_c];
  }
  for (int r = 0; r < 3; ++r)
    pl[r] = ((M[r][0] * q[0] + M[r][1] * q[1]) + M[r][2] * q[2])
            + off[r * a.off_c];
  float g[3] = {0.f, 0.f, 0.f};
  switch (type) {
    case SPHERE: safe_norm_grad<3>(pl, 1.f, g); break;
    case BOX: grad_box(pl, s, g); break;
    case CYLINDER: grad_cylinder(pl, s, g); break;
    case CONE: grad_cone(pl, s, g); break;
    case PLANE: g[1] = 1.f; break;
    default: break;  // NONE: no gradient, a NaN normal as autograd's
  }
  float w[3];
  for (int c = 0; c < 3; ++c)
    w[c] = ((g[2] * M[2][c] + g[1] * M[1][c]) + g[0] * M[0][c]) + 0.f;
  const float norm = sqrtf((w[0] * w[0] + w[2] * w[2]) + w[1] * w[1]);
  for (int c = 0; c < 3; ++c) out[c] = w[c] / norm;
}

}  // namespace

extern "C" {

// The first-order normal of n lanes: p (n, 3) float32 points, idx n int32
// (idx_is64 0) or int64 object indices, out (n, 3); num_curved: the
// scene's objects of SPHERE, BOX, CYLINDER or CONE. The scene's buffers
// are read in place through their element strides: position and offset
// (objects, 3), matrix (objects, 3, 3), scale (objects, 3), type_ids
// (objects,) int32. An index outside [0, num_objects) gives a NaN normal.
// Launches on `stream_handle` and returns cudaGetLastError().
int rt_normal(const float* p, const void* idx, int idx_is64, float* out,
              long long n, int num_objects, int num_curved,
              const float* position,
              long long pos_o, long long pos_c, const float* matrix,
              long long mat_o, long long mat_r, long long mat_c,
              const float* offset, long long off_o, long long off_c,
              const float* scale, long long scl_o, long long scl_c,
              const int32_t* type_ids, long long typ_o,
              void* stream_handle) {
  if (n <= 0) return 0;
  if ((n + BLOCK - 1) / BLOCK > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const Args a{p, idx, out, n, num_objects, num_curved, position, pos_o, pos_c, matrix,
               mat_o, mat_r, mat_c, offset, off_o, off_c, scale, scl_o,
               scl_c, type_ids, typ_o};
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  normal_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream_handle>>>(
      a, idx_is64 != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
