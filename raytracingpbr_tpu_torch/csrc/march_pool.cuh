// The persistent lane pool of the bunny march kernels K1c (march.cu) and
// K1d (march_mxu.cu), with a compacted queue of MLP evaluations.
//
// What bounds them. A bunny lane-trip inside the MLP's support (the unit
// sphere) costs ~2,000 FP32 instructions in K1c (48 libdevice sinf and the
// two 16 x 16 contractions) or three passes of four mma.sync tiles plus
// the 48 sinf in K1d; outside it, the point, the support test and the step,
// about a hundred. Memory traffic is ~70 bytes a lane once. So the kernels
// are bound by instruction issue, and the issue slots a warp wastes are the
// loss: a thread that kept one lane for the whole call ran the trips of its
// warp's longest lane (16-48% of a warp's trips were for lanes already
// done), and a warp ran the MLP for all 32 threads when one of its lanes
// was inside the sphere (26-73% of the MLP work was for lanes outside).
//
// Design.
// - Persistent slots. The grid is as many blocks as fit on the card at
//   once (the launcher asks the occupancy API); each thread is a slot. A
//   slot whose lane is done stores the eight outputs and takes the next
//   lane from a global counter that the caller zeroed: a warp takes as
//   many consecutive ids as it has idle slots with one atomicAdd, handed
//   out in ballot order, so its loads of origin, direction and the inits
//   stay near-coalesced. Slots go idle only when the counter is spent. The
//   block loops in rounds until the counter is spent and no slot is live;
//   that test is __syncthreads_or, uniform over the block, because the
//   round holds barriers, and idle slots keep looping to it.
// - A round. Each slot marches on its own: a trip's point, the distances
//   that need no MLP (analytic objects; a bunny outside its unit sphere,
//   r - 0.8) folded into its running min, then the step, trip after trip,
//   until its point lies inside a bunny's sphere (it waits for the MLP),
//   its lane ends, or fewer than 1 / kMarchShare of the warp's live slots
//   still march (it pauses until the next round). Then, one pass per bunny
//   object, the waiting slots append their object-space point to a queue
//   in shared memory (a warp ballot and popc prefix, one shared atomicAdd
//   per warp); after a barrier the engine evaluates the queue alone, spread
//   over the block (warps past its end skip the phase); after a second
//   barrier each waiting slot folds its result in and takes its step. A
//   slot has at most one entry a pass, so the queue holds one entry per
//   slot.
// - Why the slots march on their own between barriers. Measured on the
//   H100 (PERF.md), a queue run every trip made the whole block wait for
//   the MLP's latency on every trip, lanes that need no MLP included, and
//   held about a fifth of the block on the frames' own calls: 15-52%
//   slower there than a thread per lane, whose warps each run their own
//   trips. Marching to the sphere first fills the queue with most of the
//   block, so every warp runs MLP rows, and pays the barrier once per trip
//   that needs the MLP. The lane's state waits in shared memory (60 bytes
//   a slot) across the MLP, so that registers there hold only the trip's
//   point and running min, and the occupancy the MLP needs is kept.
// - The fold takes (distance, object index) lexicographically: a distance
//   replaces the best if it is smaller, or equal and of an earlier object.
//   From best = 1e3 at index 0 that is the object-ordered running min with
//   a strict < (first object wins ties, a NaN is never taken, nothing at or
//   above 1e3 leaves index 0), whatever order the folds come in, so the
//   MLP's results may come after the rest, the bunny need not be the last
//   object and a scene may hold several.
// A lane's arithmetic is the same as in a thread-per-lane march; only the
// threads that do it and the time it waits change, so the outputs do not
// depend on which slot, block or order a lane was marched in.
#pragma once

#include <limits.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "march_common.cuh"

namespace rt {

constexpr int kPoolBlock = 256;  // slots a block; the queue holds as many
// a warp stops marching when fewer than 1 / kMarchShare of its live slots
// still could
constexpr int kMarchShare = 8;
constexpr unsigned kFullMask = 0xffffffffu;
// flags of a slot's lane; kCheck: it failed bounded() when the slot took it
constexpr int kHit = 1, kDone = 2, kLive = 4, kCheck = 8;

__device__ __forceinline__ void fold(float& best, int& best_i, float dist,
                                     int o) {
  if (dist < best || (dist == best && o < best_i)) {
    best = dist;
    best_i = o;
  }
}

// The running min at a point with a NaN or an infinite coordinate, as the
// plain version finds it (march.cu's fold_non_finite, here on the pool's
// staged scene). Its local coordinates are each NaN or infinite (0 * inf
// and m * NaN in the matrix products), so of the analytic SDFs only a
// sphere's can be taken: its norm of a point with a NaN coordinate is 0
// (safe_norm), a distance of |0 - sx|; sd_shape's fmaxf would drop the NaN
// of the others. A bunny is never taken: its support test sends a NaN
// point inside, where the MLP gives NaN, and an infinite one outside, at
// infinity. So such a point folds the spheres alone and never waits for
// the MLP. Out of line, and reached only by lanes that fail bounded(), so
// that the trips of the other warps keep their code.
struct Nearest {
  float d;
  int i;
};

__device__ __noinline__ Nearest nearest_non_finite(const float* sp,
                                                   const int* st, int n_obj,
                                                   float x, float y,
                                                   float z) {
  Nearest b{1e3f, 0};
  for (int o = 0; o < n_obj; ++o) {
    if (st[o] != kSphere) continue;
    const float* pr = sp + o * kParamUsed;
    float px, py, pz;
    to_local(pr, x, y, z, px, py, pz);
    if (isnan(px) || isnan(py) || isnan(pz)) {
      fold(b.d, b.i, fabsf(0.0f - pr[3]), o);
    }
  }
  return b;
}

// Whether every point of the lane's trips in this call is finite. It is
// when the origin, direction and t are under 1e18 in magnitude, the last
// step s under 1e9 and w under 1e3 (a NaN fails each test): a trip moves t
// by w times a distance of at most 1e3 (the running min's start), or by a
// rollback s * (1 - w), so over a call's budget (under 2^31 trips) t stays
// under 4e18 and the point o + t * d under 4e36, below FLT_MAX. The test
// runs once a lane, when a slot takes it (kCheck); only a warp with a lane
// that failed it runs the trips that test each point for
// nearest_non_finite.
__device__ __forceinline__ bool bounded(const Lane& L) {
  return fabsf(L.ox) < 1e18f && fabsf(L.oy) < 1e18f && fabsf(L.oz) < 1e18f &&
         fabsf(L.dx) < 1e18f && fabsf(L.dy) < 1e18f && fabsf(L.dz) < 1e18f &&
         fabsf(L.t) < 1e18f && fabsf(L.s) < 1e9f && fabsf(L.w) < 1e3f;
}

// The block's slots in shared memory, a field an array of kPoolBlock: the
// lane's loop state (Lane), its id and its trip count.
struct Slots {
  float *ox, *oy, *oz, *dx, *dy, *dz, *t, *w, *s, *d;
  int *idx, *fin, *flags, *id, *trip;
  static constexpr int kFields = 15;

  __device__ Lane get(int k) const {
    Lane L;
    L.ox = ox[k];
    L.oy = oy[k];
    L.oz = oz[k];
    L.dx = dx[k];
    L.dy = dy[k];
    L.dz = dz[k];
    L.t = t[k];
    L.w = w[k];
    L.s = s[k];
    L.d = d[k];
    L.idx = idx[k];
    L.fin = fin[k];
    L.hit = (flags[k] & kHit) ? 1 : 0;
    L.done = (flags[k] & kDone) != 0;
    return L;
  }
  __device__ void put(int k, const Lane& L, bool check) const {
    ox[k] = L.ox;
    oy[k] = L.oy;
    oz[k] = L.oz;
    dx[k] = L.dx;
    dy[k] = L.dy;
    dz[k] = L.dz;
    t[k] = L.t;
    w[k] = L.w;
    s[k] = L.s;
    d[k] = L.d;
    idx[k] = L.idx;
    fin[k] = L.fin;
    flags[k] = (L.hit ? kHit : 0) | (L.done ? kDone : 0) | kLive |
               (check ? kCheck : 0);
  }
  __device__ bool live(int k) const { return (flags[k] & kLive) != 0; }
  __device__ bool check(int k) const { return (flags[k] & kCheck) != 0; }
};

// Gives slot k the warp's next lane if it is idle. A lane that needs no
// trip (gated, or a budget of 0) is stored at once and its slot asks
// again. `spent` (uniform over the warp) turns true once the counter has
// passed n.
__device__ __forceinline__ void refill(const MarchArgs& a, const Slots& sl,
                                       int k, bool& spent) {
  const int lane = threadIdx.x & 31;
  bool live = sl.live(k);
  while (!spent) {
    const unsigned idle = __ballot_sync(kFullMask, !live);
    if (idle == 0) return;
    const int want = __popc(idle);
    int base = 0;
    if (lane == 0) base = atomicAdd(a.next_lane, want);
    base = __shfl_sync(kFullMask, base, 0);
    spent = base >= a.n - want;
    if (!live) {
      const int n = base + __popc(idle & ((1u << lane) - 1u));
      if (n < a.n) {
        const Lane L = load_lane(a, n);
        if (L.done || a.budget <= 0) {
          store_lane(a, n, L);
        } else {
          live = true;
          sl.put(k, L, !bounded(L));
          sl.id[k] = n;
          sl.trip[k] = 0;
        }
      }
    }
  }
}

// Engine: an MLP evaluator with
//   static constexpr int kWeights;    // floats of its pack, staged in smem
//   static constexpr int kMinBlocks;  // blocks an SM should hold
//   __device__ static void run(const float* w, const float* qx,
//                              const float* qy, const float* qz, float* qr,
//                              int nq);
//   __device__ static int rows(int nq);  // MLP rows run(nq) issues
// run() is called by every thread of the block with the same nq and writes
// the raw MLP value (no support test) of entries 0 .. nq-1 into qr.
//
// Dynamic shared memory: pool_smem_bytes(n_obj, kWeights).
template <int POLICY, int CRIT, bool BOUND, class Engine>
__global__ void __launch_bounds__(kPoolBlock, Engine::kMinBlocks)
    pool_kernel(const MarchArgs a) {
  extern __shared__ float smem[];
  float* sp = smem;                             // n_obj x 18
  int* st = (int*)(sp + a.n_obj * kParamUsed);  // n_obj
  float* sw = (float*)(st + a.n_obj);           // the pack
  float* qx = sw + Engine::kWeights;            // the queue
  float* qy = qx + kPoolBlock;
  float* qz = qy + kPoolBlock;
  float* qr = qz + kPoolBlock;
  int* qn = (int*)(qr + kPoolBlock);  // 2 lengths, alternating by pass
  float* f = (float*)(qn + 2);        // the slots' fields
  const Slots sl{f, f + kPoolBlock, f + 2 * kPoolBlock, f + 3 * kPoolBlock,
                 f + 4 * kPoolBlock, f + 5 * kPoolBlock, f + 6 * kPoolBlock,
                 f + 7 * kPoolBlock, f + 8 * kPoolBlock, f + 9 * kPoolBlock,
                 (int*)(f + 10 * kPoolBlock), (int*)(f + 11 * kPoolBlock),
                 (int*)(f + 12 * kPoolBlock), (int*)(f + 13 * kPoolBlock),
                 (int*)(f + 14 * kPoolBlock)};
  stage_scene(a, sp, st);
  for (int k = threadIdx.x; k < Engine::kWeights; k += kPoolBlock) {
    sw[k] = a.bunny[k];
  }
  const int k = threadIdx.x;  // this thread's slot
  sl.flags[k] = 0;
  if (k < 2) qn[k] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const float bound2 = BOUND ? a.params[kBoundCol] : 0.0f;
  int pass = 0;
  bool spent = false;
  // tallies for a.counts: MLP rows run (thread 0; whole warps, as the
  // engine issues them), lane slots of the warps' march steps (lane 0)
  unsigned long long rows = 0, slots = 0;
  while (true) {
    refill(a, sl, k, spent);
    bool live = sl.live(k);
    if (!__syncthreads_or(live)) break;

    // the march, until the slot's point needs the MLP
    bool waiting = false;
    float x = 0.0f, y = 0.0f, z = 0.0f, best = 1e3f;
    int best_i = 0;
    {
      Lane L{};
      int trip = 0;
      bool check = false;  // the lane's points may be non-finite
      if (live) {
        L = sl.get(k);
        trip = sl.trip[k];
        check = sl.check(k);
      }
      bool marching = live;
      // the trips, compiled twice: a warp whose lanes all pass bounded()
      // runs them without the test of each point
      auto trips = [&](auto checked) {
        while (true) {
          const int n_march = __popc(__ballot_sync(kFullMask, marching));
          const int n_live = __popc(__ballot_sync(kFullMask, live));
          if (n_march == 0 || kMarchShare * n_march < n_live) break;
          if (lane == 0) slots += 32;
          if (!marching) continue;
          x = L.ox + L.t * L.dx;
          y = L.oy + L.t * L.dy;
          z = L.oz + L.t * L.dz;
          best = 1e3f;
          best_i = 0;
          if (decltype(checked)::value &&
              !(isfinite(x) && isfinite(y) && isfinite(z))) {
            const Nearest b = nearest_non_finite(sp, st, a.n_obj, x, y, z);
            best = b.d;
            best_i = b.i;
          } else {
            for (int o = 0; o < a.n_obj; ++o) {
              const float* pr = sp + o * kParamUsed;
              float px, py, pz;
              to_local(pr, x, y, z, px, py, pz);
              if (st[o] != kBunny) {
                fold(best, best_i,
                     fabsf(sd_shape(st[o], px, py, pz, pr[3], pr[4], pr[5],
                                    a.box_round)),
                     o);
              } else {
                const float r = sqrtf(px * px + py * py + pz * pz);
                if (r > 1.0f) {
                  fold(best, best_i, fabsf(r - 0.8f), o);
                } else {
                  waiting = true;  // K1c's support test
                }
              }
            }
          }
          if (waiting) {
            marching = false;
            continue;
          }
          advance<POLICY, CRIT, BOUND>(L, a, bound2, x, y, z, best, best_i,
                                       trip);
          if (L.done || ++trip == a.budget) {
            store_lane(a, sl.id[k], L);
            live = marching = false;
          }
        }
      };
      if (__any_sync(kFullMask, check)) {
        trips(std::true_type{});
      } else {
        trips(std::false_type{});
      }
      if (live) {
        sl.put(k, L, check);
        sl.trip[k] = trip;
      } else {
        sl.flags[k] = 0;
      }
    }

    // the MLP for the waiting slots, one pass per bunny object
    for (int o = 0; o < a.n_obj; ++o) {
      if (st[o] != kBunny) continue;
      int* count = qn + (pass & 1);
      float px = 0.0f, py = 0.0f, pz = 0.0f;
      bool inside = false;
      if (waiting) {
        to_local(sp + o * kParamUsed, x, y, z, px, py, pz);
        inside = !(sqrtf(px * px + py * py + pz * pz) > 1.0f);
      }
      const unsigned in = __ballot_sync(kFullMask, inside);
      int base = 0;
      if (lane == 0 && in) base = atomicAdd(count, __popc(in));
      base = __shfl_sync(kFullMask, base, 0);
      const int q = base + __popc(in & ((1u << lane) - 1u));
      if (inside) {
        qx[q] = px;
        qy[q] = py;
        qz[q] = pz;
      }
      __syncthreads();
      const int nq = *count;
      Engine::run(sw, qx, qy, qz, qr, nq);
      if (threadIdx.x == 0) rows += Engine::rows(nq);
      __syncthreads();
      // every thread read nq before the barrier; the next pass uses the
      // other length, and this one again only after two more barriers
      if (threadIdx.x == 0) *count = 0;
      if (inside) fold(best, best_i, fabsf(qr[q]), o);
      ++pass;
    }
    // the waiting slot's step
    if (waiting) {
      const bool check = sl.check(k);
      Lane L = sl.get(k);
      const int trip = sl.trip[k];
      advance<POLICY, CRIT, BOUND>(L, a, bound2, x, y, z, best, best_i,
                                   trip);
      if (L.done || trip + 1 == a.budget) {
        store_lane(a, sl.id[k], L);
        sl.flags[k] = 0;
      } else {
        sl.put(k, L, check);
        sl.trip[k] = trip + 1;
      }
    }
  }
  if (a.counts) {
    if (threadIdx.x == 0) atomicAdd(a.counts, rows);
    if (lane == 0) atomicAdd(a.counts + 1, slots);
  }
}

// Dynamic shared memory of pool_kernel: the scene, the pack, the queue and
// its lengths, and the slots' fields.
inline size_t pool_smem_bytes(int n_obj, int weights) {
  return sizeof(float) * ((size_t)n_obj * (kParamUsed + 1) + weights +
                          4 * kPoolBlock + 2 + Slots::kFields * kPoolBlock);
}

// The persistent grid of pool_kernel<P, C, B, Engine> on a scene of n_obj
// objects on the current device: blocks of kPoolBlock that fit on an SM,
// and SMs. The shared-memory attribute and the occupancy query are host
// calls and a frame launches four times, so they run once per (device,
// n_obj) and the answer is kept. The attribute only ever rises, so a grid
// kept for a larger scene stays launchable after a smaller one's query.
template <int P, int C, bool B, class Engine>
int pool_grid(int n_obj, int& per_sm, int& sms) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, std::pair<int, int>> known;
  static std::map<int, size_t> limit;  // the attribute set, by device
  const void* kernel = (const void*)pool_kernel<P, C, B, Engine>;
  const size_t smem = pool_smem_bytes(n_obj, Engine::kWeights);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_pair(dev, n_obj);
  const auto it = known.find(key);
  if (it != known.end()) {
    per_sm = it->second.first;
    sms = it->second.second;
    return 0;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > limit[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) limit[dev] = smem;
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPoolBlock, smem);
  }
  if (e == cudaSuccess) known[key] = std::make_pair(per_sm, sms);
  return (int)e;
}

// K::launch for march_entry: the persistent grid of pool_kernel with the
// given engine. Needs the pack (a.bunny), the zeroed counter and a block of
// kPoolBlock.
template <class Engine>
struct PoolLaunch {
  template <int P, int C, bool B>
  static int launch(const MarchArgs& a, int block, cudaStream_t s) {
    if (!a.bunny || !a.next_lane || block != kPoolBlock) {
      return (int)cudaErrorInvalidValue;
    }
    int per_sm = 0, sms = 0;
    const int e = pool_grid<P, C, B, Engine>(a.n_obj, per_sm, sms);
    if (e != 0) return e;
    const long long need = (a.n + kPoolBlock - 1) / kPoolBlock;
    const long long fit = (long long)per_sm * sms;
    const int grid = (int)(need < fit ? need : (fit > 0 ? fit : 1));
    // each warp overshoots the counter by at most 32 ids, once
    if ((long long)a.n + (long long)grid * kPoolBlock > INT_MAX) {
      return (int)cudaErrorInvalidValue;
    }
    pool_kernel<P, C, B, Engine>
        <<<grid, kPoolBlock, pool_smem_bytes(a.n_obj, Engine::kWeights), s>>>(
            a);
    return (int)cudaGetLastError();
  }
};

// Blocks of one pool_kernel instance (the bunny paths': CONSTANT omega,
// RELATIVE hit test, no bound, one object) that fit on an SM, and the SMs:
// the persistent grid is their product.
template <class Engine>
int pool_occupancy(int* per_sm, int* sms) {
  return pool_grid<kConstant, kRelative, false, Engine>(1, *per_sm, *sms);
}

}  // namespace rt
