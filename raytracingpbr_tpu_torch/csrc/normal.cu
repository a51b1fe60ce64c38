// The surface normal: one launch a call of ops/scene.calc_normal's
// first-order branch on the card, in two instances: the analytic shapes
// (normal_kernel, rt_normal) and, for a scene that holds the neural bunny,
// the same with the BUNNY case (normal_bunny_kernel, rt_normal_bunny).
//
// Replaces no TPU kernel: the JAX package's normal is jax.grad under XLA.
// The port's autograd normal evaluates every object's signed distance at
// every lane as (N, k, 3) tensors a shape bucket, gathers the lane's own
// column and runs autograd's backward through all of it: about 250
// kernels a call on the tokyo scene, and on a bunny scene about a hundred
// more over (N, 16) tensors for the MLP. Here one thread takes one lane:
// it reads the lane's point and object index, moves the point into that
// one object's frame (sdf.to_object_space), writes out the closed-form
// gradient of that object's SDF, turns it back with the matrix's
// transpose and normalises it. No other object is evaluated: autograd's
// gradient from every other object is +0 (an upstream +0 through finite
// partials, then the "+ 0" below), and a sum of one value and +0s is that
// value, with an exact zero as +0.
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
//     backward), then + 0 (autograd's select backward adds +0s), which
//     also makes the sign of a zero in object space irrelevant;
//   - a point not finite: NaN where another curved object (the bunny
//     among them) adds NaN;
//   - the normalisation: torch.linalg.vector_norm's reduction on the card,
//     (x*x + z*z) + y*y (two threads split the three entries, the first
//     takes entries 0 and 2), a true square root and a true divide.
// NaN points give NaN normals as autograd's do: every comparison is
// written as autograd's mask is, and the maxima propagate NaN.
//
// The bunny (ops/sdf.sd_bunny: where(r > 1, r - 0.8, mlp(p)), r =
// safe_norm(p)): outside the unit sphere its gradient is safe_norm's, as
// the sphere's, and the MLP's is an exact zero under where's backward, so
// the MLP is skipped there. Inside, the sin-MLP's forward keeps cos z of
// its three hidden layers (48 values) in registers and its backward runs
// in autograd's formulas: g_f2 = w_out (mv's outer product with an
// upstream 1), g_z2 = (g_f2 / 1.4) * cos z2 (the card's division by a
// host scalar is a multiply by its float reciprocal), g_f1 = g_f2 +
// g_z2 W_h2^T, g_z1 = g_f1 * cos z1, g_f0 = g_f1 + g_z1 W_h1^T, g_z0 =
// g_f0 * cos z0, g_p = g_z0 W_in^T. Each contraction, forward and
// backward, rounds as cuBLAS's SIMT float32 GEMM accumulates it: one fmaf
// a term in k's order, from the first product, the bias added after as
// an add of its own. On the H100 cuBLAS sums so at 8,192 to 262,144 rows
// and at the frames' 2,073,600 and 8,294,400; at 4,096 rows and fewer,
// and at 1,048,576, it sums some contractions in another order, and
// autograd's normal there parts from this one in the last bits of some
// lanes (a lane's normal under autograd follows its batch; here it does
// not). sincosf (bit-equal to sinf and cosf over every float on the
// card) and cosf are libdevice's, as torch.sin's and torch.cos's are.
// The 624 weights are staged once a block into shared memory from the
// scene's bunny_* buffers, through their strides; every read of them is
// warp-uniform (a broadcast), and each layer reads them anew (reread()),
// since weights held from the forward for the backward spill to local
// memory. A finite point so far out that the MLP's first layer overflows
// float32 (|p| near 1e37) is outside this: autograd's MLP adds NaN there,
// the kernel does not.
//
// Bound. The analytic instance: bytes. A lane reads its point (12 B) and
// index (4 or 8 B) and writes the normal (12 B); the scene's few hundred
// bytes stay in cache. The arithmetic is a few dozen operations a lane,
// far below the byte line. A warp's loads and stores of the (N, 3) rows
// are three consecutive 128 B lines each. The bunny instance: operations
// on the lanes inside the unit sphere, 1,120 FFMA (48 + 256 + 256
// forward, 256 + 256 + 48 backward), 32 sincosf and 16 cosf (tens of
// instructions each) against the same 28-32 B; lanes outside cost what
// the sphere's do. A warp runs the MLP if any of its lanes does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

// ops/sdf.SHAPE
enum Shape { NONE = 0, SPHERE = 1, BOX = 2, CYLINDER = 3, CONE = 4,
             PLANE = 5, BUNNY = 6 };

// ops/sdf.BunnyMLP's parts as the bunny instance stages them in shared
// memory: W_in (3, 16), b_in, W_h1 (16, 16), b_h1, W_h2 (16, 16), b_h2,
// w_out (16 each), row-major at these offsets (floats)
constexpr int H = 16;
constexpr int MLP_PARTS = 7;
constexpr int W_IN = 0, B_IN = 48, W_H1 = 64, B_H1 = 320, W_H2 = 336,
              B_H2 = 592, W_OUT = 608, MLP_FLOATS = 624;
// sin(z2) / 1.4 on the card: a multiply by the reciprocal in float
constexpr float INV_1_4 = 1.0f / 1.4f;

struct Mlp {
  const float* part[MLP_PARTS];
  long long row[MLP_PARTS], col[MLP_PARTS];  // element strides (row 0 for
                                             // a vector)
};

struct Args {
  const float* p;    // (n, 3) contiguous
  const void* idx;   // (n,) int32 or int64
  float* out;        // (n, 3) contiguous
  long long n;
  int num_objects;
  int num_curved;  // objects of SPHERE, BOX, CYLINDER, CONE or BUNNY
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

// acc[i] = x . W[:, i] over k < H, W row-major (H, H) in shared memory:
// the GEMM's chain, one fmaf a term in k's order from the first product
__device__ __forceinline__ void contract(const float* x, const float* W,
                                         float* acc) {
#pragma unroll
  for (int i = 0; i < H; ++i) acc[i] = x[0] * W[i];
#pragma unroll
  for (int k = 1; k < H; ++k)
#pragma unroll
    for (int i = 0; i < H; ++i) acc[i] = fmaf(x[k], W[k * H + i], acc[i]);
}

// acc[i] = x . W[i, :] over k < H (the backward's x W^T), the same chain
__device__ __forceinline__ void contract_t(const float* x, const float* W,
                                           float* acc) {
#pragma unroll
  for (int i = 0; i < H; ++i) acc[i] = x[0] * W[i * H];
#pragma unroll
  for (int k = 1; k < H; ++k)
#pragma unroll
    for (int i = 0; i < H; ++i)
      acc[i] = fmaf(x[k], W[i * H + k], acc[i]);
}

// A compiler barrier: the weights read after it are read from shared
// memory again, not kept in registers (or spilled) from an earlier read
__device__ __forceinline__ void reread() { asm volatile("" ::: "memory"); }

// The sin-MLP's gradient at p under an upstream 1 (sdf.bunny_mlp_eval):
// the forward keeps cos z of the three hidden layers, the backward runs
// autograd's formulas (the note above)
__device__ __forceinline__ void grad_mlp(const float* p, const float* w,
                                         float* g) {
  const float* w_in = w + W_IN;
  float f0[H], c0[H], f1[H], c1[H], c2[H], acc[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float z = fmaf(p[2], w_in[2 * H + j],
                         fmaf(p[1], w_in[H + j], p[0] * w_in[j]))
                    + w[B_IN + j];
    sincosf(z, &f0[j], &c0[j]);
  }
  reread();
  contract(f0, w + W_H1, acc);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float s;
    sincosf(acc[j] + w[B_H1 + j], &s, &c1[j]);
    f1[j] = s + f0[j];
  }
  reread();
  contract(f1, w + W_H2, acc);
#pragma unroll
  for (int j = 0; j < H; ++j) c2[j] = cosf(acc[j] + w[B_H2 + j]);
  reread();
  // backward: gf holds g_f2, then g_f1, then g_f0; gz g_z2, g_z1, g_z0
  float gf[H], gz[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    gf[j] = w[W_OUT + j];
    gz[j] = (gf[j] * INV_1_4) * c2[j];
  }
  contract_t(gz, w + W_H2, acc);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    gf[j] = gf[j] + acc[j];
    gz[j] = gf[j] * c1[j];
  }
  reread();
  contract_t(gz, w + W_H1, acc);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    gf[j] = gf[j] + acc[j];
    gz[j] = gf[j] * c0[j];
  }
  reread();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = gz[0] * w_in[c * H];
#pragma unroll
    for (int k = 1; k < H; ++k) s = fmaf(gz[k], w_in[c * H + k], s);
    g[c] = s;
  }
}

// sd_bunny's gradient: safe_norm's outside the unit sphere (r as the
// forward computes it), the MLP's inside
__device__ __forceinline__ void grad_bunny(const float* p, const float* w,
                                           float* g) {
  const float sq = (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2];
  const float r = sq > 0.f ? sqrtf(sq) : 0.f;
  if (r > 1.f)
    safe_norm_grad<3>(p, 1.f, g);
  else
    grad_mlp(p, w, g);
}

// One lane's normal into a.out; WITH_BUNNY: the instance with the BUNNY
// case, its weights staged at w
template <bool WITH_BUNNY>
__device__ __forceinline__ void normal_lane(const Args& a, bool idx64,
                                            long long i, const float* w) {
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
  const bool curved = (type >= SPHERE && type <= CONE)
                      || (WITH_BUNNY && type == BUNNY);
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
    default:  // NONE: no gradient, a NaN normal as autograd's
      if constexpr (WITH_BUNNY) {
        if (type == BUNNY) grad_bunny(pl, w, g);
      }
      break;
  }
  float v[3];
  for (int c = 0; c < 3; ++c)
    v[c] = ((g[2] * M[2][c] + g[1] * M[1][c]) + g[0] * M[0][c]) + 0.f;
  const float norm = sqrtf((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1]);
  for (int c = 0; c < 3; ++c) out[c] = v[c] / norm;
}

__global__ void __launch_bounds__(BLOCK) normal_kernel(Args a, bool idx64) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  normal_lane<false>(a, idx64, i, nullptr);
}

__global__ void __launch_bounds__(BLOCK)
    normal_bunny_kernel(Args a, Mlp m, bool idx64) {
  __shared__ float w[MLP_FLOATS];
  int at = 0;
#pragma unroll
  for (int part = 0; part < MLP_PARTS; ++part) {  // rows 3, 1, H, 1, H, 1, 1
    const int rows = part == 0 ? 3 : (part == 2 || part == 4 ? H : 1);
    for (int e = threadIdx.x; e < rows * H; e += BLOCK)
      w[at + e] = m.part[part][(e / H) * m.row[part] + (e % H) * m.col[part]];
    at += rows * H;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  normal_lane<true>(a, idx64, i, w);
}

}  // namespace

extern "C" {

// The first-order normal of n lanes: p (n, 3) float32 points, idx n int32
// (idx_is64 0) or int64 object indices, out (n, 3); num_curved: the
// scene's objects of SPHERE, BOX, CYLINDER, CONE or BUNNY. The scene's
// buffers are read in place through their element strides: position and
// offset (objects, 3), matrix (objects, 3, 3), scale (objects, 3),
// type_ids (objects,) int32. An index outside [0, num_objects) gives a
// NaN normal. mlp_parts: null for a scene without the bunny (the analytic
// instance), else the 7 parts of ops/sdf.BunnyMLP before bias_out, in
// its order (w_in (3, 16), b_in, w_h1 (16, 16), b_h1, w_h2 (16, 16),
// b_h2, w_out (16 each)), with mlp_strides their (row, column) element
// strides, 14 in all (row 0 for a vector); on the host, read at the call.
// Launches on `stream_handle` and returns cudaGetLastError().
int rt_normal(const float* p, const void* idx, int idx_is64, float* out,
              long long n, int num_objects, int num_curved,
              const float* position,
              long long pos_o, long long pos_c, const float* matrix,
              long long mat_o, long long mat_r, long long mat_c,
              const float* offset, long long off_o, long long off_c,
              const float* scale, long long scl_o, long long scl_c,
              const int32_t* type_ids, long long typ_o,
              const float* const* mlp_parts, const long long* mlp_strides,
              void* stream_handle) {
  if (n <= 0) return 0;
  if ((n + BLOCK - 1) / BLOCK > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const Args a{p, idx, out, n, num_objects, num_curved, position, pos_o, pos_c, matrix,
               mat_o, mat_r, mat_c, offset, off_o, off_c, scale, scl_o,
               scl_c, type_ids, typ_o};
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  const cudaStream_t stream = (cudaStream_t)stream_handle;
  if (mlp_parts == nullptr) {
    normal_kernel<<<(unsigned)blocks, BLOCK, 0, stream>>>(a, idx_is64 != 0);
  } else {
    Mlp m;
    for (int part = 0; part < MLP_PARTS; ++part) {
      m.part[part] = mlp_parts[part];
      m.row[part] = mlp_strides[2 * part];
      m.col[part] = mlp_strides[2 * part + 1];
    }
    normal_bunny_kernel<<<(unsigned)blocks, BLOCK, 0, stream>>>(
        a, m, idx_is64 != 0);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
