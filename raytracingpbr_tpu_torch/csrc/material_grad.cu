// The material gather's backward: one call a backward of
// ops/scene.materials_at on the card (two kernels: the blocks' partial
// sums, then their sum in a fixed order).
//
// Replaces no TPU kernel: the JAX package's materials_at is a one-hot
// matmul under XLA. The port's forward gathers one row a lane from the
// (n_obj, 10) material table with index_select, whose backward is
// index_add_: every lane's 10 columns added into the table with float
// atomics. On the bunny (one object) 2 M lanes x 10 columns hit the same
// 10 addresses, so the atomics serialise; Cornell's 230,400 lanes hit 8
// rows. Here each column's sum over an object's lanes is taken without
// contention and only over the columns whose part asked for a gradient.
//
// Design:
//   - Each block takes a fixed contiguous chunk of lanes, each warp 32
//     consecutive lanes at a time (coalesced loads of the index and of
//     each needed column, read in place through its element stride).
//   - A thread keeps the needed columns in registers (the kernel is
//     instantiated for each column count) and issues the loads of its
//     warp's next 32 lanes before it sums the current ones.
//   - A warp's lanes that share an object (__match_any_sync on the index;
//     on the bunny the whole warp) sum each column by pointer jumping:
//     five shuffle steps, after which the group's lowest lane holds the
//     group's sum. That lane adds it to the warp's own (object, column)
//     accumulator in shared memory: no two writers ever share an address.
//   - The block sums its warps' accumulators in warp order into one
//     partial a (object, column) in the scratch (blocks, n_obj, cols);
//     the second kernel sums each (object, column) over the blocks in a
//     fixed order (a thread a stride of blocks, then a fixed tree).
// The chunks depend on the lane count alone (the wrapper fixes the
// number of blocks), so the result is bit-reproducible from run to run
// and from card to card. It is not index_add_'s bits: those follow the
// atomics' order, which changes from run to run.
//
// Bound: bytes. A lane's index (4 or 8 B) and its needed columns (4 B
// each) are read once; the scratch is blocks x n_obj x cols floats and
// stays in L2. The arithmetic is a few adds and shuffles a column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int COMBINE = 256;
// albedo 3, emission 3, roughness, metallic, transmission, ior
constexpr int MAX_COLS = 10;
// the march kernels stage at most 128 objects; the accumulators take
// WARPS x 128 x 10 floats = 40 KB of shared memory at most
constexpr int MAX_OBJECTS = 128;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* idx;  // (n,) int32 or int64, element stride idx_stride
  long long idx_stride;
  long long n;
  int num_objects;
  // column c of lane i is col[c][i * col_stride[c]]; a null column (a
  // part whose gradient autograd left undefined) reads as 0
  const float* col[MAX_COLS];
  long long col_stride[MAX_COLS];
  long long chunk;  // lanes a block, a multiple of 32
  float* partial;   // (blocks, num_objects, num_cols)
};

// Lane i's object (-1 past `end` or outside [0, num_objects)) and its K
// needed columns (0 where it has no object).
template <int K>
__device__ __forceinline__ int load_lane(const Args& a, const bool idx64,
                                         const long long i,
                                         const long long end, float (&v)[K]) {
  int obj = -1;
  if (i < end) {
    const long long o =
        idx64 ? ((const long long*)a.idx)[i * a.idx_stride]
              : (long long)((const int32_t*)a.idx)[i * a.idx_stride];
    // index_select refused anything else in the forward
    if (o >= 0 && o < a.num_objects) obj = (int)o;
  }
#pragma unroll
  for (int c = 0; c < K; ++c)
    v[c] = (obj >= 0 && a.col[c] != nullptr) ? a.col[c][i * a.col_stride[c]]
                                              : 0.f;
  return obj;
}

// K = num_cols: the columns live in registers, as many as there are.
template <int K>
__global__ void __launch_bounds__(BLOCK)
    partial_kernel(const Args a, const bool idx64) {
  extern __shared__ float acc[];  // (WARPS, num_objects, K)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int width = a.num_objects * K;
  float* mine = acc + warp * width;
  for (int e = lane; e < width; e += 32) mine[e] = 0.f;
  __syncwarp();
  const unsigned above = lane == 31 ? 0u : FULL << (lane + 1);
  const unsigned below = (1u << lane) - 1u;
  const long long begin = (long long)blockIdx.x * a.chunk;
  const long long end = begin + a.chunk < a.n ? begin + a.chunk : a.n;
  float v[K];
  int obj = load_lane<K>(a, idx64, begin + warp * 32 + lane, end, v);
  // warp-uniform bounds: every lane of a warp runs the same iterations;
  // the next 32 lanes' loads are issued before this group's sums
  for (long long base = begin + warp * 32; base < end; base += BLOCK) {
    float next_v[K];
    const int next_obj =
        load_lane<K>(a, idx64, base + BLOCK + lane, end, next_v);
    const unsigned peers = __match_any_sync(FULL, obj);
    // pointer jumping: lane l adds the sum its next peer holds and takes
    // that peer's pointer; after step s it holds its group's 2^(s+1)
    // members from l on, after five the whole group
    const unsigned rest = peers & above;
    int next = rest ? __ffs(rest) - 1 : -1;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int src = next >= 0 ? next : lane;
      const int after = __shfl_sync(FULL, next, src);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float t = __shfl_sync(FULL, v[c], src);
        if (next >= 0) v[c] += t;
      }
      if (next >= 0) next = after;
    }
    if (obj >= 0 && (peers & below) == 0u) {
      float* row = mine + obj * K;
#pragma unroll
      for (int c = 0; c < K; ++c) row[c] += v[c];
    }
    __syncwarp();
    obj = next_obj;
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = next_v[c];
  }
  __syncthreads();
  float* out = a.partial + (long long)blockIdx.x * width;
  for (int e = threadIdx.x; e < width; e += BLOCK) {
    float s = acc[e];
    for (int w = 1; w < WARPS; ++w) s += acc[w * width + e];
    out[e] = s;
  }
}

template <int K>
void launch_partial(const Args& a, const bool idx64, const int blocks,
                    cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * a.num_objects * K * sizeof(float);
  partial_kernel<K><<<blocks, BLOCK, smem, stream>>>(a, idx64);
}

// out[e] = the sum of partial[b][e] over the blocks b, a block an entry
__global__ void __launch_bounds__(COMBINE)
    combine_kernel(const float* partial, const int blocks, const int width,
                   float* out) {
  __shared__ float warp_sum[COMBINE / 32];
  const int e = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < blocks; b += COMBINE)
    s += partial[(long long)b * width + e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_sum[0];
    for (int w = 1; w < COMBINE / 32; ++w) t += warp_sum[w];
    out[e] = t;
  }
}

}  // namespace

extern "C" {

int rt_material_grad_max_objects() { return MAX_OBJECTS; }

// Each object's sum over its lanes of the num_cols columns: idx (n,) int32
// (idx_is64 0) or int64 object indices at element stride idx_stride;
// cols[c] column c's first element (or null: zeros) at element stride
// col_strides[c]; partial (blocks, num_objects, num_cols) float32 scratch,
// with blocks * chunk >= n, chunk a multiple of 32 and blocks 0 when n is
// 0; out (num_objects, num_cols) float32. Lanes whose index lies outside
// [0, num_objects) add nothing. Launches on `stream_handle` and returns
// cudaGetLastError() (cudaErrorInvalidValue on arguments it does not
// take).
int rt_material_grad(const void* idx, int idx_is64, long long idx_stride,
                     long long n, int num_objects, int num_cols,
                     const void* const* cols, const long long* col_strides,
                     long long chunk, int blocks, float* partial, float* out,
                     void* stream_handle) {
  if (n < 0 || num_objects < 1 || num_objects > MAX_OBJECTS ||
      num_cols < 1 || num_cols > MAX_COLS || blocks < 0 ||
      (n > 0 && (chunk <= 0 || chunk % 32 != 0 || blocks < 1 ||
                 (long long)blocks * chunk < n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_handle;
  const int width = num_objects * num_cols;
  if (n > 0) {
    Args a{};
    a.idx = idx;
    a.idx_stride = idx_stride;
    a.n = n;
    a.num_objects = num_objects;
    for (int c = 0; c < num_cols; ++c) {
      a.col[c] = (const float*)cols[c];
      a.col_stride[c] = col_strides[c];
    }
    a.chunk = chunk;
    a.partial = partial;
    const bool is64 = idx_is64 != 0;
    switch (num_cols) {
      case 1: launch_partial<1>(a, is64, blocks, stream); break;
      case 2: launch_partial<2>(a, is64, blocks, stream); break;
      case 3: launch_partial<3>(a, is64, blocks, stream); break;
      case 4: launch_partial<4>(a, is64, blocks, stream); break;
      case 5: launch_partial<5>(a, is64, blocks, stream); break;
      case 6: launch_partial<6>(a, is64, blocks, stream); break;
      case 7: launch_partial<7>(a, is64, blocks, stream); break;
      case 8: launch_partial<8>(a, is64, blocks, stream); break;
      case 9: launch_partial<9>(a, is64, blocks, stream); break;
      default: launch_partial<10>(a, is64, blocks, stream); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  combine_kernel<<<width, COMBINE, 0, stream>>>(partial, n > 0 ? blocks : 0,
                                                width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
