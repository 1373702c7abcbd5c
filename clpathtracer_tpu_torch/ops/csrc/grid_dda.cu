// G1: the uniform-grid 3-D DDA for Hopper (sm_90a).
//
// Replaces clpathtracer_tpu/ops/grid_walk.py::traverse_grid (its inline
// layout). That walk is XLA in the JAX package, a lockstep wavefront that
// advances every ray by one table row per iteration, not a Pallas kernel.
// Here it is one thread per ray with its own loop: a ray that settles stops,
// and no full-width pass is spent on it.
//
// Per ray: the slab entry into the grid's box (a dir == 0 axis takes the
// origin-in-slab answer), the entry cell, and per axis the t of the next
// boundary crossing (t_next) and its increment (dt). Each step reads one
// row of the [C + S, 128] table (accel/grid.py): a cell row (record 0 =
// (first spill row, count), records 1..7 its first triangles) or one of the
// cell's spill rows (8 triangles). Only the records the cell holds are read,
// three float4 loads each (cols 0-11), the meta record with one. Each record
// is tested with mt_hit_uv (pair_tests.cuh: Moller-Trumbore, det > 0). The
// row's winner is its last minimum; it replaces the ray's best when its
// t <= best (and < t_max). When the cell's list is done the ray stops if
// best <= the cell's exit t (min t_next), or the exit reaches t_max, or the
// next cell is outside the grid; else it steps the axis of least t_next
// (ties: x, then y) and adds dt to it. any_hit: the ray stops after the
// first row with an accepted hit. A ray stops after max_iters rows.
//
// Outputs per ray: t (BIG on a miss), tri (-1), u, v (0), steps (rows read).
// The plain version is ops/grid_walk.py::traverse_grid_reference, the JAX
// package's lockstep wavefront in torch ops; each lane's result and steps
// equal this kernel's exactly: the same operations, each rounded once, in
// the same order (__f*_rn, built with --fmad=false).
//
// What bounds it on this card: the row reads. They are dependent loads (a
// row's meta decides the next row) of a different row per thread, so each
// step waits for a device-memory (or L2) round trip; the MT tests are at
// most 8 a row. The bound counts the bytes these loads read (16 B of meta
// on a cell row, 48 B a record held) against 3.35 TB/s and the MT
// operations against the FP32 rate. Nothing hides the
// latency yet beyond the card's occupancy (many threads a SM, few
// registers each); later work: rays sorted for row locality, prefetching
// the next cell's row while testing the current one.

#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::mt_hit_uv;

constexpr int kThreads = 256;
constexpr float kBig = 3.4e38f;
constexpr int kRowF4 = 32;   // float4s per 128-float row
constexpr int kRecF4 = 4;    // float4s per 16-float record

__global__ void __launch_bounds__(kThreads)
grid_dda_kernel(const float4* __restrict__ table,
                const float* __restrict__ geom,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ t_max,
                const unsigned char* __restrict__ active,
                float* __restrict__ out_t, int* __restrict__ out_tri,
                float* __restrict__ out_u, float* __restrict__ out_v,
                int* __restrict__ out_steps, int n, int rx, int ry, int rz,
                int nrows, int max_iters, int any_hit) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int res[3] = {rx, ry, rz};
  const int ncells = rx * ry * rz;
  Ray ray;
  ray.ox = orig[3 * i];
  ray.oy = orig[3 * i + 1];
  ray.oz = orig[3 * i + 2];
  ray.dx = dir[3 * i];
  ray.dy = dir[3 * i + 1];
  ray.dz = dir[3 * i + 2];
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float d[3] = {ray.dx, ray.dy, ray.dz};

  // slab entry into the grid's box
  float inv[3], t_en = 0.f, t_ex = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = geom[a], hi = geom[3 + a];
    float tn, tf;
    if (d[a] == 0.f) {
      const bool in_slab = o[a] >= lo && o[a] <= hi;
      inv[a] = 0.f;
      tn = in_slab ? -kBig : kBig;
      tf = in_slab ? kBig : -kBig;
    } else {
      inv[a] = __frcp_rn(d[a]);
      const float tl = __fmul_rn(__fsub_rn(lo, o[a]), inv[a]);
      const float th = __fmul_rn(__fsub_rn(hi, o[a]), inv[a]);
      tn = fminf(tl, th);
      tf = fmaxf(tl, th);
    }
    t_en = a == 0 ? tn : fmaxf(t_en, tn);
    t_ex = a == 0 ? tf : fminf(t_ex, tf);
  }
  const float t0 = fmaxf(t_en, 0.f);
  const bool has_tb = t_max != nullptr;
  const float tb = has_tb ? t_max[i] : kBig;
  bool act = t_ex >= t0 && t_ex > 0.f;
  if (active != nullptr && !active[i]) act = false;
  if (has_tb && !(t0 < tb)) act = false;

  float best_t = has_tb ? tb : kBig, best_u = 0.f, best_v = 0.f;
  int best_tri = -1, steps = 0;
  if (act) {
    int cell[3], step[3];
    float t_next[3], dt[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lo = geom[a], h = geom[6 + a];
      const float p = __fadd_rn(o[a], __fmul_rn(t0, d[a]));
      const float cf = floorf(__fdiv_rn(__fsub_rn(p, lo), h));
      cell[a] = (int)fminf(fmaxf(cf, 0.f), (float)(res[a] - 1));
      step[a] = d[a] > 0.f ? 1 : (d[a] < 0.f ? -1 : 0);
      if (d[a] == 0.f) {
        t_next[a] = kBig;
        dt[a] = kBig;
      } else {
        const float nb = __fadd_rn(
            lo, __fmul_rn((float)(cell[a] + (d[a] > 0.f ? 1 : 0)), h));
        t_next[a] = __fmul_rn(__fsub_rn(nb, o[a]), inv[a]);
        dt[a] = __fmul_rn(h, fabsf(inv[a]));
      }
    }
    int row = (cell[0] * ry + cell[1]) * rz + cell[2];
    int offset = 0, count = 0, spill = 0;
    while (steps < max_iters) {
      ++steps;
      const bool at_cell = row < ncells;
      const float4* r =
          table + (size_t)min(max(row, 0), nrows - 1) * kRowF4;
      if (at_cell) {
        const float4 meta = r[0];
        spill = (int)meta.x;
        count = (int)meta.y;
      }
      const int first = at_cell ? 1 : 0;
      const int slots = at_cell ? 7 : 8;
      const int m = min(slots, count - offset);
      float rt = kBig, ru = 0.f, rv = 0.f;
      int rtri = -1;
      for (int j = 0; j < m; ++j) {
        const float4* rec = r + (first + j) * kRecF4;
        const float4 qa = rec[0], qb = rec[1], qc = rec[2];
        float t, u, v;
        // <=: the row's last minimum
        if (mt_hit_uv(ray, qa, qb, qc, &t, &u, &v) && t <= rt) {
          rt = t;
          ru = u;
          rv = v;
          rtri = (int)qc.y;
        }
      }
      const bool take = rt < kBig && rt <= best_t && (!has_tb || rt < tb);
      if (take) {
        best_t = rt;
        best_tri = rtri;
        best_u = ru;
        best_v = rv;
        if (any_hit) break;
      }
      const int offset_next = offset + slots;
      if (offset_next < count) {   // the cell's next spill row
        row = spill + (offset_next - 7) / 8;
        offset = offset_next;
        continue;
      }
      const float t_exit = fminf(fminf(t_next[0], t_next[1]), t_next[2]);
      const bool settled =
          (best_tri >= 0 && best_t <= t_exit) || (has_tb && t_exit >= tb);
      // step the axis of least t_next (constant indices keep the state in
      // registers)
      bool out;
      if (t_next[0] <= fminf(t_next[1], t_next[2])) {
        cell[0] += step[0];
        t_next[0] = __fadd_rn(t_next[0], dt[0]);
        out = cell[0] < 0 || cell[0] >= rx;
      } else if (t_next[1] <= t_next[2]) {
        cell[1] += step[1];
        t_next[1] = __fadd_rn(t_next[1], dt[1]);
        out = cell[1] < 0 || cell[1] >= ry;
      } else {
        cell[2] += step[2];
        t_next[2] = __fadd_rn(t_next[2], dt[2]);
        out = cell[2] < 0 || cell[2] >= rz;
      }
      if (settled || out) break;
      row = (cell[0] * ry + cell[1]) * rz + cell[2];
      offset = 0;
    }
  }
  const bool hit = best_tri >= 0;
  out_t[i] = hit ? best_t : kBig;
  out_tri[i] = best_tri;
  out_u[i] = hit ? best_u : 0.f;
  out_v[i] = hit ? best_v : 0.f;
  out_steps[i] = steps;
}

}  // namespace

// G1. table: [nrows, 128] f32 (accel/grid.py inline layout); geom: [9] f32
// (lo xyz, hi xyz, cell size xyz); orig, dir: [n, 3] f32; t_max: [n] f32 or
// null; active: [n] u8 or null. Outputs out_t [n] f32, out_tri [n] i32,
// out_u, out_v [n] f32, out_steps [n] i32. Returns cudaGetLastError() after
// the launch.
extern "C" int grid_dda_launch(const void* table, const void* geom,
                               const void* orig, const void* dir,
                               const void* t_max, const void* active,
                               void* out_t, void* out_tri, void* out_u,
                               void* out_v, void* out_steps, int n, int rx,
                               int ry, int rz, int nrows, int max_iters,
                               int any_hit, void* stream) {
  if (n <= 0) return 0;
  grid_dda_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(
      static_cast<const float4*>(table), static_cast<const float*>(geom),
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      static_cast<const float*>(t_max),
      static_cast<const unsigned char*>(active), static_cast<float*>(out_t),
      static_cast<int*>(out_tri), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<int*>(out_steps), n, rx, ry,
      rz, nrows, max_iters, any_hit);
  return (int)cudaGetLastError();
}
