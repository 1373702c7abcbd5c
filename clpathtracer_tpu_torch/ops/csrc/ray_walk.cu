// W1: the per-ray stackless kd rope walk for Hopper (sm_90a).
//
// Replaces clpathtracer_tpu/ops/traverse_fast.py::traverse_fast and the
// walk of ops/traverse.py::traverse. Both are XLA in the JAX package, a
// lockstep wavefront that advances every ray by one node or one block per
// iteration, not Pallas kernels. Here each ray walks on its own, one thread
// a ray, as the reference kernel does (src/kernel.cl:323-389).
//
// Per ray: 1 / d per axis (+-inf on a component of exactly 0) and its sign;
// the root box's slab test (hit_aabb: entry and exit with the JAX package's
// comparisons, so NaN and infinity give its outcomes); p = o + max(tmin, 0)
// d. Then one step a node, steps counted as the JAX two-gather body counts
// them:
//   * a split (flags = axis + 4 * is_leaf < 4): the hi child when p[axis] >
//     the split value (strict; NaN goes lo);
//   * a leaf: `block` records from the leaf's first record (the int32
//     leaf_start column) + offset, those with offset + k < count tested with
//     mt_hit_uv (pair_tests.cuh); the block's winner is its last minimum,
//     taken when t < BIG, t <= the carried best and, with t_max, t < t_max.
//     When the leaf's list is done: the exit face by traverse_aabb (tmin a
//     NaN-propagating maximum, tmax and the face by strict <), early exit
//     when tmin + EXIT_EPS > best (after a hit, or always with t_max), else
//     the face's rope, from p = o + tmax d.
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
// What bounds it on this card: the node rows and record blocks each ray
// reads, a different path per ray, and the MT tests of its leaf blocks.
// A simple first form: one thread a ray, no staging; a warp waits on its
// longest walk.

#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::mt_hit_uv;

constexpr int kThreads = 128;
constexpr float kBig = 3.4e38f;
constexpr float kExitEps = 0.001f;   // reference early-exit slack
constexpr int kRowF4 = 6;            // float4s per 24-float node row
constexpr int kRecF4 = 4;            // float4s per 16-float record

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

__global__ void __launch_bounds__(kThreads)
ray_walk_kernel(const float4* __restrict__ table,
                const int* __restrict__ leaf_first,
                const float4* __restrict__ recs,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ t_max,
                const unsigned char* __restrict__ active,
                float* __restrict__ out_t, int* __restrict__ out_slot,
                int* __restrict__ out_steps, int n, int n_recs, int block,
                int max_iters, int any_hit) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Ray ray;
  ray.ox = orig[3 * i];
  ray.oy = orig[3 * i + 1];
  ray.oz = orig[3 * i + 2];
  ray.dx = dir[3 * i];
  ray.dy = dir[3 * i + 1];
  ray.dz = dir[3 * i + 2];
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float d[3] = {ray.dx, ray.dy, ray.dz};
  float inv[3], sgf[3];
  int sg[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    inv[a] = __frcp_rn(d[a]);   // 1 / +-0 = +-inf
    sg[a] = inv[a] < 0.f ? 1 : 0;
    sgf[a] = (float)sg[a];
  }

  // the root box (hit_aabb)
  const float4 q0 = table[0], q1 = table[1];
  const float rlo[3] = {q0.x, q0.y, q0.z}, rhi[3] = {q0.w, q1.x, q1.y};
  float tn[3], tf[3];
  slabs(rlo, rhi, o, inv, sgf, tn, tf);
  float tmin = tn[0], tmax = tf[0];
  bool miss = false;
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    miss = miss || tmin > tf[a] || tn[a] > tmax;
    if (tn[a] > tmin) tmin = tn[a];
    if (tf[a] < tmax) tmax = tf[a];
  }
  bool act = !miss && tmax > 0.f;
  if (active != nullptr && !active[i]) act = false;
  const float s0 = tmin > 0.f ? tmin : 0.f;
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __fadd_rn(o[a], __fmul_rn(s0, d[a]));

  const bool has_tb = t_max != nullptr;
  const float tb = has_tb ? t_max[i] : kBig;
  float best_t = tb;
  int best_slot = -1, steps = 0, node = 0, offset = 0;
  while (act && steps < max_iters) {
    ++steps;
    const float4* row = table + (size_t)node * kRowF4;
    const float4 r1 = row[1], r2 = row[2];   // lanes 4-7, 8-11
    const int flags = (int)r1.w;
    if (flags < 4) {   // a split: descend
      const int axis = flags & 3;
      node = p[axis] > r1.z ? (int)r2.y : (int)r2.x;
      offset = 0;
      continue;
    }
    // a leaf: one block of records
    const int count = (int)r2.w;
    const int first = leaf_first[node] + offset;
    float bt = __int_as_float(0x7f800000);   // +inf: the last minimum
    int kk = 0;
    for (int k = 0; k < block; ++k) {
      float tm = kBig, t, u, v;
      if (offset + k < count) {
        const float4* rec = recs + (size_t)min(first + k, n_recs - 1) * kRecF4;
        if (mt_hit_uv(ray, rec[0], rec[1], rec[2], &t, &u, &v)) tm = t;
      }
      if (tm <= bt) {
        bt = tm;
        kk = k;
      }
    }
    const bool take = bt < kBig && bt <= best_t && (!has_tb || bt < tb);
    if (take) {
      best_t = bt;
      best_slot = first + kk;
    }
    if (any_hit && take) break;
    if (offset + block < count) {
      offset += block;
      continue;
    }
    // the leaf is done: the exit face (traverse_aabb) and its rope
    const float4 r0 = row[0], r3 = row[3], r4 = row[4];
    const float lo[3] = {r0.x, r0.y, r0.z}, hi[3] = {r0.w, r1.x, r1.y};
    slabs(lo, hi, o, inv, sgf, tn, tf);
    float lmin = tn[0], lmax = tf[0];
    int face = 1 - sg[0];
#pragma unroll
    for (int a = 1; a < 3; ++a) {
      lmin = nan_max(lmin, tn[a]);
      if (tf[a] < lmax) {
        lmax = tf[a];
        face = 2 * a + 1 - sg[a];
      }
    }
    bool early = __fadd_rn(lmin, kExitEps) > best_t;
    if (!has_tb) early = early && best_slot >= 0;
    const float ropes[6] = {r3.x, r3.y, r3.z, r3.w, r4.x, r4.y};
    float rope = ropes[0];
#pragma unroll
    for (int f = 1; f < 6; ++f)
      if (face == f) rope = ropes[f];
    node = early ? -1 : (int)rope;
    offset = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = __fadd_rn(o[a], __fmul_rn(lmax, d[a]));
    if (node < 0) break;
  }
  out_t[i] = best_t;
  out_slot[i] = best_slot;
  out_steps[i] = steps;
}

}  // namespace

// W1. table: [M, 24] f32 node rows (ops/traverse_fast.py::pack_node_table);
// leaf_first: [M] i32, a leaf's first record; recs: [n_recs, 16] f32
// records (v0, e1, e2, tri_id, pad); orig, dir: [n, 3] f32; t_max: [n] f32
// or null; active: [n] u8 (a bool tensor's bytes) or null. Outputs out_t
// [n] f32, out_slot [n] i32, out_steps [n] i32. block: records a leaf step
// (1..16). Returns cudaGetLastError() after the launch.
extern "C" int ray_walk_launch(const void* table, const void* leaf_first,
                               const void* recs, const void* orig,
                               const void* dir, const void* t_max,
                               const void* active, void* out_t,
                               void* out_slot, void* out_steps, int n,
                               int n_recs, int block, int max_iters,
                               int any_hit, void* stream) {
  if (n <= 0) return 0;
  ray_walk_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
      static_cast<const float4*>(table), static_cast<const int*>(leaf_first),
      static_cast<const float4*>(recs), static_cast<const float*>(orig),
      static_cast<const float*>(dir), static_cast<const float*>(t_max),
      static_cast<const unsigned char*>(active), static_cast<float*>(out_t),
      static_cast<int*>(out_slot), static_cast<int*>(out_steps), n,
      n_recs > 0 ? n_recs : 1, block, max_iters, any_hit);
  return (int)cudaGetLastError();
}
