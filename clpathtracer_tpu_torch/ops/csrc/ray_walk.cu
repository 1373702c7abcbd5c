// W1: the per-ray stackless kd rope walk for Hopper (sm_90a).
//
// Replaces clpathtracer_tpu/ops/traverse_fast.py::traverse_fast and the
// walk of ops/traverse.py::traverse. Both are XLA in the JAX package, a
// lockstep wavefront that advances every ray by one node or one block per
// iteration, not Pallas kernels. Here each ray walks on its own, as the
// reference kernel does (src/kernel.cl:323-389).
//
// Per ray: 1 / d per axis (+-inf on a component of exactly 0) and its sign;
// the root box's slab test (hit_aabb: entry and exit with the JAX package's
// comparisons, so NaN and infinity give its outcomes); p = o + max(tmin, 0)
// d. Then one step a node, steps counted as the JAX two-gather body counts
// them:
//   * a split (flags = axis + 4 * is_leaf < 4): the hi child when p[axis] >
//     the split value (strict; NaN goes lo);
//   * a leaf: `block` records a step from the leaf's first record (the
//     int32 leaf_start column), tested with mt_hit_uv (pair_tests.cuh); the
//     block's winner is its last minimum, taken when t < BIG, t <= the
//     carried best and, with t_max, t < t_max. When the leaf's list is
//     done: the exit face by traverse_aabb (tmin a NaN-propagating maximum,
//     tmax and the face by strict <), early exit when tmin + EXIT_EPS >
//     best (after a hit, or always with t_max), else the face's rope, from
//     p = o + tmax d.
// any_hit stops a ray at its first take; dead lanes (active 0, or a miss
// of the root box) never step; a ray stops after max_iters steps (the JAX
// loop's cap is global: the two agree wherever no lane reaches it).
//
// Outputs per ray: best t (BIG, or t_max, without a winner), best slot (the
// winner's row of the records, -1) and steps. The plain version is
// ops/traverse_fast.py::ray_walk_reference, the JAX lockstep body in torch
// ops; each lane's outputs equal this kernel's exactly: the same operations,
// each rounded once, in the same order (__f*_rn, built with --fmad=false).
//
// What bounds it on this card: the MT tests of the leaf blocks (the FP32
// rate; on the 1M terrain's primaries leaves of up to 3072 records, 1805
// steps a ray), each step's dependent loads (a node row, then the leaf's
// records), and warps that wait on their longest walk; the probe found
// occupancy (registers) and the lanes' coherence to matter most.
//
// Design.
//   * A leaf split over a group of kGroup threads a ray. The group takes a
//     leaf in chunks of kChunk records (kPer a thread, in rounds of kUnroll
//     whose loads are issued together); thread h tests records h,
//     h + kGroup, ... and keeps the (first block, least t, last record)
//     among its records that the walk could take (t < BIG, t <= the
//     carried best, t < t_max). A take only needs t below bounds fixed for
//     the whole leaf, so the sequential block walk takes exactly the leaf's
//     least such t, the last record among equal ones (any_hit: the first
//     block that holds one, its last minimum); the group merges its
//     threads' candidates by shuffles in that order and counts the steps
//     the block walk would take: ceil(count / block) blocks (1 for an empty
//     leaf), up to the found block with any_hit, at most max_iters in all.
//     Early exit and the rope hop happen at the leaf's end, as before.
//   * The warp's groups run each iteration together, a descent to the next
//     leaf and then one chunk, and reconverge after it (a warp whose lanes
//     walk free of each other was slower on the card).
//   * Live lanes compacted on a persistent grid. The grid is the blocks
//     resident at once. When none of a warp's groups holds a ray, the warp
//     takes a run of consecutive rays from a counter, one a group; each
//     group's thread 0 tests its ray's root box and active flag and writes
//     a dead lane's outputs, and the live rays go to the groups in order,
//     again until every group holds one: a dead lane takes no walk, and the
//     warp's lanes walk neighbouring rays (the primaries' leaves are
//     shared, and the L1 broadcasts a record to the lanes that load it).
//   * At a leaf the exit face and its rope are known before the test (only
//     early exit waits on it): the rope's node row is loaded while the
//     leaf's records are tested.
// The numeric choices are constants below; probes/probe_w1_schedule.py
// builds other values of them from this source.

#include <climits>
#include <cuda_runtime.h>

#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::mt_hit_uv;

// The schedule: probes/probe_w1_schedule.py times other values of these
// constants on the 1M terrain's primaries, the shadow tree's mirror bounce
// wave and the nearest NEE shadow wave (PERF.md section 6 has its numbers).
constexpr int kGroup = 4;          // threads a ray
constexpr int kUnroll = 1;         // records a thread loads at a time
constexpr int kMinBlocks = 8;      // blocks an SM (__launch_bounds__)
constexpr int kThreads = 128;      // threads a block
constexpr int kPer = 8;            // records a thread tests a chunk
constexpr int kChunk = kGroup * kPer;   // records a group tests a chunk
constexpr int kRecF4 = 4;          // float4s per 16-float record
constexpr int kRowF4 = 6;          // float4s per 24-float node row
constexpr float kBig = 3.4e38f;
constexpr float kExitEps = 0.001f;   // reference early-exit slack
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGroup == 1 || kGroup == 2 || kGroup == 4 || kGroup == 8 ||
                  kGroup == 16 || kGroup == 32,
              "a ray's threads are a power-of-two slice of a warp");
static_assert(kPer % kUnroll == 0, "a chunk is whole rounds");

// jnp.maximum / torch.maximum: NaN when either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// The slab distances of a box for a ray: lo + sign (hi - lo) and
// hi - sign (hi - lo), minus o, times 1 / d, as the plain version rounds
// them.
__device__ __forceinline__ void slabs(const float* lo, const float* hi,
                                      const float* o, const float* inv,
                                      const float* sgf, float* t_near,
                                      float* t_far) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ext = __fmul_rn(sgf[a], __fsub_rn(hi[a], lo[a]));
    t_near[a] = __fmul_rn(__fsub_rn(__fadd_rn(lo[a], ext), o[a]), inv[a]);
    t_far[a] = __fmul_rn(__fsub_rn(__fsub_rn(hi[a], ext), o[a]), inv[a]);
  }
}

// v of the group's thread `src`.
template <class T>
__device__ __forceinline__ T from_thread(unsigned mask, T v, int src) {
  if constexpr (kGroup == 1)
    return v;
  else
    return __shfl_sync(mask, v, src, kGroup);
}

// A ray's set-up: its origin and direction, 1 / d and signs, the root box
// test and the entry point p. Returns whether the walk starts (a live
// lane).
struct RayState {
  Ray ray;
  float o[3], d[3], inv[3], sgf[3], p[3];
  int sg[3];
};

__device__ __forceinline__ bool ray_setup(
    int i, const float4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int max_iters, RayState& s) {
  s.ray.ox = orig[3 * i];
  s.ray.oy = orig[3 * i + 1];
  s.ray.oz = orig[3 * i + 2];
  s.ray.dx = dir[3 * i];
  s.ray.dy = dir[3 * i + 1];
  s.ray.dz = dir[3 * i + 2];
  s.o[0] = s.ray.ox;
  s.o[1] = s.ray.oy;
  s.o[2] = s.ray.oz;
  s.d[0] = s.ray.dx;
  s.d[1] = s.ray.dy;
  s.d[2] = s.ray.dz;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    s.inv[a] = __frcp_rn(s.d[a]);   // 1 / +-0 = +-inf
    s.sg[a] = s.inv[a] < 0.f ? 1 : 0;
    s.sgf[a] = (float)s.sg[a];
  }
  // the root box (hit_aabb)
  const float4 q0 = table[0], q1 = table[1];
  const float rlo[3] = {q0.x, q0.y, q0.z}, rhi[3] = {q0.w, q1.x, q1.y};
  float tn[3], tf[3];
  slabs(rlo, rhi, s.o, s.inv, s.sgf, tn, tf);
  float tmin = tn[0], tmax = tf[0];
  bool miss = false;
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    miss = miss || tmin > tf[a] || tn[a] > tmax;
    if (tn[a] > tmin) tmin = tn[a];
    if (tf[a] < tmax) tmax = tf[a];
  }
  bool act = !miss && tmax > 0.f && max_iters > 0;
  if (active != nullptr && !active[i]) act = false;
  const float s0 = tmin > 0.f ? tmin : 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    s.p[a] = __fadd_rn(s.o[a], __fmul_rn(s0, s.d[a]));
  return act;
}

// Test record j (relative to the leaf's first record; j < lim) and keep
// this thread's candidate: the first block, then the least t, then the
// last record, among the records the walk could take.
__device__ __forceinline__ void test_record(const Ray& ray, float4 a,
                                            float4 b, float4 c, int j,
                                            float best_t, bool has_tb,
                                            float tb, int any_hit, int block,
                                            int& pb_blk, float& pb_t,
                                            int& pb_j) {
  float t, u, v;
  if (mt_hit_uv(ray, a, b, c, &t, &u, &v) && t < kBig && t <= best_t &&
      (!has_tb || t < tb)) {
    const int blk = any_hit ? j / block : 0;
    if (blk < pb_blk || (blk == pb_blk && t <= pb_t)) {
      pb_blk = blk;
      pb_t = t;
      pb_j = j;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ray_walk_kernel(const float4* __restrict__ table,
                const int* __restrict__ leaf_first,
                const float4* __restrict__ recs,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ t_max,
                const unsigned char* __restrict__ active,
                float* __restrict__ out_t, int* __restrict__ out_slot,
                int* __restrict__ out_steps, int* __restrict__ next_ray,
                int n, int block, int max_iters, int any_hit) {
  const int lane = threadIdx.x & 31;
  const int h = lane % kGroup;
  const int base_lane = lane - h;
  const unsigned gmask =
      kGroup == 32 ? kFull : ((1u << kGroup) - 1u) << base_lane;
  const bool has_tb = t_max != nullptr;

  bool exhausted = false;   // the counter has passed the last ray
  // the ray the group walks (-1: none) and its walk
  int ray_i = -1;
  RayState s;
  float tb = kBig, best_t = kBig;
  int best_slot = -1, steps = 0, node = 0;
  // the leaf the group stands in: records to test (lim), the next chunk's
  // first record (pos), blocks it holds (nb) and the walk may test (ntest)
  bool in_leaf = false;
  int lf_first = 0, lf_lim = 0, lf_pos = 0, lf_nb = 0, lf_ntest = 0;
  int lf_rope = -1;
  float lf_lmin = 0.f, lf_lmax = 0.f;
  // this thread's candidate in the leaf
  int pb_blk = INT_MAX, pb_j = -1;
  float pb_t = __int_as_float(0x7f800000);
  // the rope's node row, loaded while the leaf is tested
  bool have_pf = false;
  float4 pf1 = make_float4(0.f, 0.f, 0.f, 0.f), pf2 = pf1;

  // ray i starts the group's walk
  auto start = [&](int i) {
    ray_i = i;
    ray_setup(ray_i, table, orig, dir, active, max_iters, s);
    tb = has_tb ? t_max[ray_i] : kBig;
    best_t = tb;
    best_slot = -1;
    steps = 0;
    node = 0;
    in_leaf = false;
    have_pf = false;
  };

  for (;;) {
    // (a) when none of the warp's groups holds a ray, the warp takes a run
    // of consecutive rays, one a group without a ray; each such group's
    // thread 0 tests one, and the live ones go to those groups in order;
    // again until every group holds a live ray or the counter is spent
    if (__all_sync(kFull, ray_i < 0)) {
      while (!exhausted) {
        const unsigned need = __ballot_sync(kFull, ray_i < 0 && h == 0);
        if (need == 0) break;
        int b = 0;
        if (lane == 0) b = atomicAdd(next_ray, __popc(need));
        b = __shfl_sync(kFull, b, 0);
        const int rank = __popc(need & ((1u << lane) - 1u));
        const int r = b + rank;
        bool live = false;
        if (((need >> lane) & 1u) && r < n) {
          RayState t;
          live = ray_setup(r, table, orig, dir, active, max_iters, t);
          if (!live) {
            out_t[r] = has_tb ? t_max[r] : kBig;
            out_slot[r] = -1;
            out_steps[r] = 0;
          }
        }
        const unsigned lmask = __ballot_sync(kFull, live);
        // the group of need-rank k takes the live ray of live-rank k
        int src = -1;
        if ((need >> lane) & 1u) {
          unsigned m = lmask;
          for (int k = 0; k < rank && m != 0; ++k) m &= m - 1;
          if (m != 0) src = __ffs(m) - 1;
        }
        src = from_thread(gmask, src, 0);
        const int got = __shfl_sync(kFull, r, src < 0 ? lane : src);
        if (src >= 0) start(got);
        exhausted = b + __popc(need) >= n;
      }
    }
    // every group of the warp is done; else the warp's groups run the
    // iteration together (a reconvergence point)
    if (!__any_sync(kFull, ray_i >= 0)) break;

    // (b) descend: split steps to the next leaf
    if (ray_i >= 0 && !in_leaf) {
      for (;;) {
        float4 r1, r2;
        const float4* row = table + (size_t)node * kRowF4;
        if (have_pf) {
          r1 = pf1;
          r2 = pf2;
          have_pf = false;
        } else {
          r1 = row[1];   // lanes 4-7: hi.y, hi.z, split, flags
          r2 = row[2];   // lanes 8-11: child_lo, child_hi, -, count
        }
        const int flags = (int)r1.w;
        if (flags < 4) {   // a split: descend
          ++steps;
          const int axis = flags & 3;   // selected, not indexed: p stays
          const float pa =              // in registers
              axis == 0 ? s.p[0] : (axis == 1 ? s.p[1] : s.p[2]);
          node = pa > r1.z ? (int)r2.y : (int)r2.x;
          if (steps >= max_iters) break;
          continue;
        }
        // a leaf: the blocks it holds, those the cap leaves, its exit face
        const int count = (int)r2.w;
        lf_first = leaf_first[node];
        lf_nb = count > 0 ? (count + block - 1) / block : 1;
        lf_ntest = min(lf_nb, max_iters - steps);
        lf_lim = min(count, lf_ntest * block);
        lf_pos = 0;
        const float4 r0 = row[0], r3 = row[3], r4 = row[4];
        const float lo[3] = {r0.x, r0.y, r0.z}, hi[3] = {r0.w, r1.x, r1.y};
        float tn[3], tf[3];
        slabs(lo, hi, s.o, s.inv, s.sgf, tn, tf);
        float lmin = tn[0], lmax = tf[0];
        int face = 1 - s.sg[0];
#pragma unroll
        for (int a = 1; a < 3; ++a) {
          lmin = nan_max(lmin, tn[a]);
          if (tf[a] < lmax) {
            lmax = tf[a];
            face = 2 * a + 1 - s.sg[a];
          }
        }
        const float ropes[6] = {r3.x, r3.y, r3.z, r3.w, r4.x, r4.y};
        float rope = ropes[0];
#pragma unroll
        for (int f = 1; f < 6; ++f)
          if (face == f) rope = ropes[f];
        lf_rope = (int)rope;
        lf_lmin = lmin;
        lf_lmax = lmax;
        if (lf_rope >= 0 && lf_ntest == lf_nb) {   // the hop's row, early
          const float4* nrow = table + (size_t)lf_rope * kRowF4;
          pf1 = nrow[1];
          pf2 = nrow[2];
          have_pf = true;
        }
        pb_blk = INT_MAX;
        pb_t = __int_as_float(0x7f800000);
        pb_j = -1;
        in_leaf = true;
        break;
      }
      if (!in_leaf) {   // the cap ended the walk on a split step
        if (h == 0) {
          out_t[ray_i] = best_t;
          out_slot[ray_i] = best_slot;
          out_steps[ray_i] = steps;
        }
        ray_i = -1;
      }
    }

    // (c) one chunk of the leaf
    const bool at_chunk = ray_i >= 0 && in_leaf;
    const bool tests = at_chunk && lf_pos < lf_lim;
    if (tests) {
      // rounds of kUnroll records: their loads issued together, then tested
      const float4* grec = recs + (size_t)lf_first * kRecF4;
#pragma unroll
      for (int k0 = 0; k0 < kPer; k0 += kUnroll) {
        if (lf_pos + h + kGroup * k0 >= lf_lim) break;
        float4 ra[kUnroll], rb[kUnroll], rc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = kGroup * (k0 + u) + h;   // within the chunk
          if (lf_pos + jj < lf_lim) {
            const float4* src = grec + (size_t)(lf_pos + jj) * kRecF4;
            ra[u] = src[0];
            rb[u] = src[1];
            rc[u] = src[2];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = lf_pos + kGroup * (k0 + u) + h;
          if (j < lf_lim)
            test_record(s.ray, ra[u], rb[u], rc[u], j, best_t, has_tb, tb,
                        any_hit, block, pb_blk, pb_t, pb_j);
        }
      }
    }
    if (at_chunk) {
      lf_pos += kChunk;
      bool done = lf_pos >= lf_lim;
      if (any_hit && !done) {   // the first block with a take is whole
        int fb = pb_blk;
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1)
          fb = min(fb, __shfl_xor_sync(gmask, fb, off, kGroup));
        done = fb != INT_MAX && lf_pos >= (fb + 1) * block;
      }
      if (done) {
        // the leaf's take over the group: first block, least t, last record
        int rb_ = pb_blk, rj = pb_j;
        float rt = pb_t;
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1) {
          const int ob = __shfl_xor_sync(gmask, rb_, off, kGroup);
          const float ot = __shfl_xor_sync(gmask, rt, off, kGroup);
          const int oj = __shfl_xor_sync(gmask, rj, off, kGroup);
          if (ob < rb_ || (ob == rb_ && (ot < rt || (ot == rt && oj > rj)))) {
            rb_ = ob;
            rt = ot;
            rj = oj;
          }
        }
        const bool found = rb_ != INT_MAX;
        steps += (any_hit && found) ? rb_ + 1 : lf_ntest;
        if (found) {
          best_t = rt;
          best_slot = lf_first + rj;
        }
        in_leaf = false;
        bool end = (any_hit && found) || steps >= max_iters;
        if (!end) {   // early exit, else the exit face's rope
          bool early = __fadd_rn(lf_lmin, kExitEps) > best_t;
          if (!has_tb) early = early && best_slot >= 0;
          node = early ? -1 : lf_rope;
#pragma unroll
          for (int a = 0; a < 3; ++a)
            s.p[a] = __fadd_rn(s.o[a], __fmul_rn(lf_lmax, s.d[a]));
          end = node < 0;
        }
        if (end) {
          if (h == 0) {
            out_t[ray_i] = best_t;
            out_slot[ray_i] = best_slot;
            out_steps[ray_i] = steps;
          }
          ray_i = -1;
          have_pf = false;
        }
      }
    }
  }
}

// The blocks of ray_walk_kernel resident on the current card at once.
cudaError_t resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ray_walk_kernel, kThreads, 0);
  *blocks = sms * per_sm;
  return err;
}

}  // namespace

// W1. table: [M, 24] f32 node rows (ops/traverse_fast.py::pack_node_table);
// leaf_first: [M] i32, a leaf's first record; recs: [n_recs, 16] f32
// records (v0, e1, e2, tri_id, pad); orig, dir: [n, 3] f32; t_max: [n] f32
// or null; active: [n] u8 (a bool tensor's bytes) or null; next_ray: [1]
// i32 scratch (the persistent grid's ray counter, zeroed here). Outputs
// out_t [n] f32, out_slot [n] i32, out_steps [n] i32. block: records a leaf
// step (1..16); n_recs, the rows of recs, is not read (a leaf's count
// bounds its reads). Returns the first CUDA error, else
// cudaGetLastError() after the launch.
extern "C" int ray_walk_launch(const void* table, const void* leaf_first,
                               const void* recs, const void* orig,
                               const void* dir, const void* t_max,
                               const void* active, void* out_t,
                               void* out_slot, void* out_steps,
                               void* next_ray, int n, int n_recs, int block,
                               int max_iters, int any_hit, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  long long blocks = ((long long)n + kThreads - 1) / kThreads;
  int resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err == cudaSuccess) err = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (resident < blocks) blocks = resident;
  ray_walk_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float4*>(table), static_cast<const int*>(leaf_first),
      static_cast<const float4*>(recs), static_cast<const float*>(orig),
      static_cast<const float*>(dir), static_cast<const float*>(t_max),
      static_cast<const unsigned char*>(active), static_cast<float*>(out_t),
      static_cast<int*>(out_slot), static_cast<int*>(out_steps),
      static_cast<int*>(next_ray), n, block, max_iters, any_hit);
  return (int)cudaGetLastError();
}

// W1's launch shape into out[6]: threads a block, threads a ray, blocks
// resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers a thread, static shared memory and local (spill) bytes a
// thread. Returns a CUDA error or 0.
extern "C" int ray_walk_shape(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, ray_walk_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                      ray_walk_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = kGroup;
  out[2] = blocks;
  out[3] = fa.numRegs;
  out[4] = (int)fa.sharedSizeBytes;
  out[5] = (int)fa.localSizeBytes;
  return 0;
}
