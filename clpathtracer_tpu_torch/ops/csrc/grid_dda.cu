// G1: the uniform-grid 3-D DDA for Hopper (sm_90a).
//
// Replaces clpathtracer_tpu/ops/grid_walk.py::traverse_grid, both of its
// layouts (body_inline and body_split). That walk is XLA in the JAX
// package, a lockstep wavefront that advances every ray by one row per
// iteration, not a Pallas kernel. Here each ray walks on its own: a ray
// that settles stops, and no full-width pass is spent on it. The record
// fetch (Fetch<kSplit>) is the template parameter of one kernel and one
// walk loop: the inline form (grid_dda_launch) and the split form
// (grid_dda_split_launch).
//
// Per ray: the slab entry into the grid's box (a dir == 0 axis takes the
// origin-in-slab answer), the entry cell, and per axis the t of the next
// boundary crossing (t_next) and its increment (dt). Each step reads one
// row of the [C + S, 128] table (accel/grid.py): a cell row (record 0 =
// (first spill row, count), records 1..7 its first triangles) or one of the
// cell's spill rows (8 triangles). Each record the cell holds is tested
// with mt_hit_uv (pair_tests.cuh: Moller-Trumbore, det > 0). The row's
// winner is its last minimum (least t, then the highest record); it
// replaces the ray's best when its t <= best (and < t_max). When the cell's
// list is done the ray stops if best <= the cell's exit t (min t_next), or
// the exit reaches t_max, or the next cell is outside the grid; else it
// steps the axis of least t_next (ties: x, then y) and adds dt to it.
// any_hit: the ray stops after the first row with an accepted hit. A ray
// stops after max_iters rows.
//
// Outputs per ray: t (BIG on a miss), tri (-1), u, v (0), steps (rows the
// walk reads). The plain version is ops/grid_walk.py::
// traverse_grid_reference, the JAX package's lockstep wavefront in torch
// ops; each lane's result and steps equal this kernel's exactly: the same
// operations, each rounded once, in the same order (__f*_rn, built with
// --fmad=false); the row's winner does not depend on the order in which
// its records are tested.
//
// What bounds it on this card: the row reads, a different row per ray, in
// a 669 MB table (1M soup) far above the 50 MB L2, so each row is a
// device-memory round trip; the MT tests are at most 8 a row. The bound
// counts the bytes the walk needs (16 B of meta on a cell row, 48 B a
// record held) against 3.35 TB/s and the MT operations against the FP32
// rate.
//
// Design. A ray has kRayThreads = 4 threads; thread h holds records h and
// h + 4 of every row (cols 0-11, three float4 each). A row costs one round
// trip: its loads (the meta record among them) are issued together, before
// any test, and while the row is tested the next row's loads are already
// in flight: the walk knows that row before the test (the cell's next
// spill row when offset + slots < count, else the next cell from t_next),
// and the test decides only whether the walk goes on. A prefetched row the
// walk does not take is discarded and not counted in steps; none is issued
// when the walk is known to stop after this row (the next cell is outside,
// the ray is already settled, or max_iters). A new cell's row is loaded
// whole (its count is in it), a spill row's held records only (the cell's
// count is known). The ray's threads merge their winners by shuffles
// (least t, then the highest record) and take the row's winner once; every
// decision is then the same in all of them. The kernel is persistent: the
// grid is the blocks resident at once, and a ray's threads take the next
// ray from a counter when their walk ends, so no thread idles until the
// longest walk of its block ends (a bounce wave's walks: mean 15 rows,
// max 187). On the card, 4 threads a ray at 3 blocks an SM beat 1, 2 and
// 8 threads a ray, and sizing a new cell's loads by a per-cell count read
// beforehand from L2 was slower than loading the row whole (PERF.md §6).
//
// The split form (accel/grid.py's split layout: cells [C, 8] meta rows of
// (quad start, count), quads [Q, 64] rows of QBLOCK = 4 records) keeps
// that schedule: 4 threads a ray, the persistent grid, the next row
// prefetched. A step reads one quad row, one record a thread, and only
// the records the cell holds. A cell's meta row (8 bytes) is read once,
// by each of the ray's threads (one address: one transaction): the next
// cell's meta is the prefetch of the cell's last row, and that cell's
// first quad row is loaded when the walk steps into it, so a new cell
// costs two dependent round trips where the inline form costs one. Its
// steps are quad rows, as in the JAX package's body_split.

#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::mt_hit_uv;

constexpr int kThreads = 256;    // threads a block
constexpr int kRayThreads = 4;   // threads a ray
constexpr int kMinBlocks = 3;    // blocks an SM holds (__launch_bounds__)
constexpr int kRecs = 8 / kRayThreads;  // records of a row a thread holds
constexpr float kBig = 3.4e38f;
constexpr int kRowF4 = 32;   // float4s per 128-float row
constexpr int kRecF4 = 4;    // float4s per 16-float record
constexpr int kQBlock = 4;   // records per quad row (split layout)
constexpr int kQuadF4 = 16;  // float4s per 64-float quad row
constexpr int kCellF2 = 4;   // float2s per 8-float meta row
static_assert(kQBlock % kRayThreads == 0,
              "a ray's threads split the 4 records of a quad row evenly");
static_assert(kRayThreads == 1 || kRayThreads == 2 || kRayThreads == 4 ||
                  kRayThreads == 8,
              "a ray's threads split the 8 records of a row evenly");

// A thread's records of one row (cols 0-11): record k * kRayThreads + h.
struct RowRecs {
  float4 a[kRecs], b[kRecs], c[kRecs];
};

// Issue the loads of this thread's records among the first `nrec` of row
// `row` (clamped into the table).
__device__ __forceinline__ void load_row(const float4* __restrict__ table,
                                         int row, int nrows, int h,
                                         int nrec, RowRecs& r) {
  const float4* p = table + (size_t)min(max(row, 0), nrows - 1) * kRowF4;
#pragma unroll
  for (int k = 0; k < kRecs; ++k) {
    const int j = k * kRayThreads + h;
    if (j < nrec) {
      const float4* rec = p + j * kRecF4;
      r.a[k] = rec[0];
      r.b[k] = rec[1];
      r.c[k] = rec[2];
    }
  }
}

// Issue the loads of this thread's records among the first `nrec` of quad
// row `q` (clamped into the quads), into r.*[0 .. kQBlock / kRayThreads).
__device__ __forceinline__ void load_quad(const float4* __restrict__ quads,
                                          int q, int nq, int h, int nrec,
                                          RowRecs& r) {
  const float4* p = quads + (size_t)min(max(q, 0), nq - 1) * kQuadF4;
#pragma unroll
  for (int k = 0; k < kQBlock / kRayThreads; ++k) {
    const int j = k * kRayThreads + h;
    if (j < nrec) {
      const float4* rec = p + j * kRecF4;
      r.a[k] = rec[0];
      r.b[k] = rec[1];
      r.c[k] = rec[2];
    }
  }
}

// A cell's meta (quad start, count) from its row of the [C, 8] cells.
__device__ __forceinline__ float2 load_meta(const float2* __restrict__ cells,
                                            int cid, int ncells) {
  return cells[(size_t)min(max(cid, 0), ncells - 1) * kCellF2];
}

// v of the ray's thread `src` (0 .. kRayThreads - 1).
template <class T>
__device__ __forceinline__ T from_thread(unsigned mask, T v, int src) {
  if constexpr (kRayThreads == 1)
    return v;
  else
    return __shfl_sync(mask, v, src, kRayThreads);
}

// A DDA step: the cell after `cell` on the axis of least t_next (ties: x,
// then y), t_next with that axis's dt added, and whether the cell is
// outside the grid. Constant indices keep the state in registers.
struct Cell {
  int c[3];
  float t[3];
  bool out;
  __device__ __forceinline__ int id(int ry, int rz) const {
    return (c[0] * ry + c[1]) * rz + c[2];
  }
};

__device__ __forceinline__ Cell dda_step(const int* cell, const float* t_next,
                                         const int* step, const float* dt,
                                         int rx, int ry, int rz) {
  Cell n = {{cell[0], cell[1], cell[2]}, {t_next[0], t_next[1], t_next[2]},
            false};
  if (t_next[0] <= fminf(t_next[1], t_next[2])) {
    n.c[0] += step[0];
    n.t[0] = __fadd_rn(t_next[0], dt[0]);
    n.out = n.c[0] < 0 || n.c[0] >= rx;
  } else if (t_next[1] <= t_next[2]) {
    n.c[1] += step[1];
    n.t[1] = __fadd_rn(t_next[1], dt[1]);
    n.out = n.c[1] < 0 || n.c[1] >= ry;
  } else {
    n.c[2] += step[2];
    n.t[2] = __fadd_rn(t_next[2], dt[2]);
    n.out = n.c[2] < 0 || n.c[2] >= rz;
  }
  return n;
}

// The row's winner over the ray's threads: least t, then highest record j
// (rt, rj: this thread's; they become the winner's in every thread).
__device__ __forceinline__ void merge_row(unsigned mask, float& rt, int& rj) {
#pragma unroll
  for (int off = kRayThreads / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(mask, rt, off, kRayThreads);
    const int oj = __shfl_xor_sync(mask, rj, off, kRayThreads);
    if (ot < rt || (ot == rt && oj > rj)) {
      rt = ot;
      rj = oj;
    }
  }
}

// The record fetch of one layout (the kernel's template parameter kSplit):
// the walk's loop is shared, and these say what a step reads. enter: load
// cell cid's first row into cur. open: this step's slots [first, first +
// slots) of cur (a cell row's record 0 is the inline layout's meta). count:
// the cell's records. prefetch: name what the walk reads next, the cell's
// row after offset_next when `more`, else the next cell (cell id
// next_cell), and, when `issue` (the walk may take another step) and
// `more` or `go_on`, issue its loads. advance: cur becomes that row.
template <bool kSplit>
struct Fetch;

// Inline: a step reads one row of the [C + S, 128] table, a cell row
// (record 0 = (first spill row, count), records 1..7) or a spill row (8
// records); the next row is prefetched whole into nxt.
template <>
struct Fetch<false> {
  static constexpr int kHeld = kRecs;   // records of a row a thread holds
  const float4* __restrict__ table;
  int nrows, ncells, h;
  int row = 0, next_row = 0, spill = 0, count = 0;

  __device__ Fetch(const float4* t, const float2*, int nr, int nc, int hh)
      : table(t), nrows(nr), ncells(nc), h(hh) {}
  __device__ __forceinline__ void enter(int cid, RowRecs& cur) {
    row = cid;
    load_row(table, row, nrows, h, 8, cur);
  }
  __device__ __forceinline__ void open(unsigned mask, const RowRecs& cur,
                                       int& first, int& slots) {
    const bool at_cell = row < ncells;
    if (at_cell) {
      spill = (int)from_thread(mask, cur.a[0].x, 0);
      count = (int)from_thread(mask, cur.a[0].y, 0);
    }
    first = at_cell ? 1 : 0;
    slots = at_cell ? 7 : 8;
  }
  __device__ __forceinline__ void prefetch(bool issue, bool more, bool go_on,
                                           int offset_next, int next_cell,
                                           RowRecs& nxt) {
    next_row = more ? spill + (offset_next - 7) / 8 : next_cell;
    if (issue && (more || go_on))
      load_row(table, next_row, nrows, h,
               more ? min(8, count - offset_next) : 8, nxt);
  }
  __device__ __forceinline__ void advance(bool, RowRecs& cur,
                                          const RowRecs& nxt) {
    row = next_row;
    cur = nxt;
  }
};

// Split: a step reads one [64]-float quad row (QBLOCK = 4 records). The
// cell's meta row (quad start, count) of the [C, 8] cells is read once:
// the next cell's meta is the prefetch of the cell's last quad row, and
// its first quad row is loaded on the step into it.
template <>
struct Fetch<true> {
  static constexpr int kHeld = kQBlock / kRayThreads;
  const float4* __restrict__ quads;
  const float2* __restrict__ cells;
  int nquads, ncells, h;
  int qstart = 0, count = 0;
  float2 meta;

  __device__ Fetch(const float4* q, const float2* c, int nq, int nc, int hh)
      : quads(q), cells(c), nquads(nq), ncells(nc), h(hh) {}
  __device__ __forceinline__ void first_row(RowRecs& cur) {
    qstart = (int)meta.x;
    count = (int)meta.y;
    load_quad(quads, qstart, nquads, h, min(kQBlock, count), cur);
  }
  __device__ __forceinline__ void enter(int cid, RowRecs& cur) {
    meta = load_meta(cells, cid, ncells);
    first_row(cur);
  }
  __device__ __forceinline__ void open(unsigned, const RowRecs&, int& first,
                                       int& slots) {
    first = 0;
    slots = kQBlock;
  }
  __device__ __forceinline__ void prefetch(bool issue, bool more, bool go_on,
                                           int offset_next, int next_cell,
                                           RowRecs& nxt) {
    if (!issue) return;
    if (more)
      load_quad(quads, qstart + offset_next / kQBlock, nquads, h,
                min(kQBlock, count - offset_next), nxt);
    else if (go_on)
      meta = load_meta(cells, next_cell, ncells);
  }
  __device__ __forceinline__ void advance(bool more, RowRecs& cur,
                                          const RowRecs& nxt) {
    if (more)
      cur = nxt;
    else
      first_row(cur);
  }
};

// Walk ray i with its kRayThreads threads (h, mask: this thread's index
// among them and their lanes); thread 0 writes the outputs. kSplit: table
// is the [nrows, 64] quads and cells the [C, 8] meta rows (split layout),
// else table is the [nrows, 128] table and cells is null (inline layout).
template <bool kSplit>
__device__ __forceinline__ void walk_ray(
    int i, int h, unsigned mask, const float4* __restrict__ table,
    const float2* __restrict__ cells, const float* __restrict__ geom,
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_max,
    const unsigned char* __restrict__ active, float* __restrict__ out_t,
    int* __restrict__ out_tri, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_steps, int rx, int ry,
    int rz, int nrows, int max_iters, int any_hit) {
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
      const float lo = geom[a], hh = geom[6 + a];
      const float p = __fadd_rn(o[a], __fmul_rn(t0, d[a]));
      const float cf = floorf(__fdiv_rn(__fsub_rn(p, lo), hh));
      cell[a] = (int)fminf(fmaxf(cf, 0.f), (float)(res[a] - 1));
      step[a] = d[a] > 0.f ? 1 : (d[a] < 0.f ? -1 : 0);
      if (d[a] == 0.f) {
        t_next[a] = kBig;
        dt[a] = kBig;
      } else {
        const float nb = __fadd_rn(
            lo, __fmul_rn((float)(cell[a] + (d[a] > 0.f ? 1 : 0)), hh));
        t_next[a] = __fmul_rn(__fsub_rn(nb, o[a]), inv[a]);
        dt[a] = __fmul_rn(hh, fabsf(inv[a]));
      }
    }
    Fetch<kSplit> f(table, cells, nrows, ncells, h);
    int offset = 0;   // the cell's records before this step's
    RowRecs cur, nxt = {};
    f.enter((cell[0] * ry + cell[1]) * rz + cell[2], cur);
    while (steps < max_iters) {
      ++steps;
      const Cell nc = dda_step(cell, t_next, step, dt, rx, ry, rz);
      int first, slots;
      f.open(mask, cur, first, slots);
      const int m = min(slots, f.count - offset);
      const int offset_next = offset + slots;
      const bool more = offset_next < f.count;   // the cell's next row
      const float t_exit = fminf(fminf(t_next[0], t_next[1]), t_next[2]);
      // settled before the test stays settled: the test only lowers best_t
      const bool settled_now =
          (best_tri >= 0 && best_t <= t_exit) || (has_tb && t_exit >= tb);
      // prefetch what the walk reads next if it goes on
      f.prefetch(steps < max_iters, more, !(nc.out || settled_now),
                 offset_next, nc.id(ry, rz), nxt);

      // this thread's records; <=: the last minimum
      float rt = kBig, ru = 0.f, rv = 0.f;
      int rtri = -1, rj = -1;
#pragma unroll
      for (int k = 0; k < Fetch<kSplit>::kHeld; ++k) {
        const int j = k * kRayThreads + h;
        float t, u, v;
        if (j >= first && j < first + m &&
            mt_hit_uv(ray, cur.a[k], cur.b[k], cur.c[k], &t, &u, &v) &&
            t <= rt) {
          rt = t;
          ru = u;
          rv = v;
          rtri = (int)cur.c[k].y;
          rj = j;
        }
      }
      merge_row(mask, rt, rj);
      const bool take = rt < kBig && rt <= best_t && (!has_tb || rt < tb);
      if (take) {
        const int src = rj % kRayThreads;   // the thread that holds it
        best_t = rt;
        best_tri = from_thread(mask, rtri, src);
        best_u = from_thread(mask, ru, src);
        best_v = from_thread(mask, rv, src);
        if (any_hit) break;
      }
      if (more) {
        offset = offset_next;
        f.advance(true, cur, nxt);
        continue;
      }
      const bool settled =
          (best_tri >= 0 && best_t <= t_exit) || (has_tb && t_exit >= tb);
      if (settled || nc.out) break;
      // step into the next cell
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cell[a] = nc.c[a];
        t_next[a] = nc.t[a];
      }
      offset = 0;
      f.advance(false, cur, nxt);
    }
  }
  if (h != 0) return;
  const bool hit = best_tri >= 0;
  out_t[i] = hit ? best_t : kBig;
  out_tri[i] = best_tri;
  out_u[i] = hit ? best_u : 0.f;
  out_v[i] = hit ? best_v : 0.f;
  out_steps[i] = steps;
}

// Persistent: each ray's threads take the next ray from the counter
// `next_ray` when their walk ends, so no thread waits for the longest walk
// of its block; the grid is the blocks resident at once.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grid_dda_kernel(const float4* __restrict__ table,
                const float2* __restrict__ cells,
                const float* __restrict__ geom,
                const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ t_max,
                const unsigned char* __restrict__ active,
                float* __restrict__ out_t, int* __restrict__ out_tri,
                float* __restrict__ out_u, float* __restrict__ out_v,
                int* __restrict__ out_steps, int* __restrict__ next_ray,
                int n, int rx, int ry, int rz, int nrows, int max_iters,
                int any_hit) {
  const int h = threadIdx.x % kRayThreads;
  const unsigned lane = threadIdx.x & 31;
  const unsigned mask =
      kRayThreads == 1 ? 1u << lane
                       : ((1u << kRayThreads) - 1u)
                             << (lane & ~(unsigned)(kRayThreads - 1));
  for (;;) {
    int i = 0;
    if (h == 0) i = atomicAdd(next_ray, 1);
    i = from_thread(mask, i, 0);
    if (i >= n) return;   // the ray's threads leave together
    walk_ray<kSplit>(i, h, mask, table, cells, geom, orig, dir, t_max,
                     active, out_t, out_tri, out_u, out_v, out_steps, rx, ry,
                     rz, nrows, max_iters, any_hit);
  }
}

// The blocks of grid_dda_kernel<kSplit> resident on the current card at
// once.
template <bool kSplit>
cudaError_t resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_dda_kernel<kSplit>, kThreads, 0);
  *blocks = sms * per_sm;
  return err;
}

template <bool kSplit>
int launch(const void* table, const void* cells, const void* geom,
           const void* orig, const void* dir, const void* t_max,
           const void* active, void* out_t, void* out_tri, void* out_u,
           void* out_v, void* out_steps, void* next_ray, int n, int rx,
           int ry, int rz, int nrows, int max_iters, int any_hit,
           void* stream) {
  if (n <= 0) return 0;
  int resident = 0;
  const cudaError_t err = resident_blocks<kSplit>(&resident);
  if (err != cudaSuccess) return (int)err;
  const long long needed =
      ((long long)n * kRayThreads + kThreads - 1) / kThreads;
  grid_dda_kernel<kSplit><<<(unsigned)(needed < resident ? needed : resident),
                            kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(table), static_cast<const float2*>(cells),
      static_cast<const float*>(geom), static_cast<const float*>(orig),
      static_cast<const float*>(dir), static_cast<const float*>(t_max),
      static_cast<const unsigned char*>(active), static_cast<float*>(out_t),
      static_cast<int*>(out_tri), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<int*>(out_steps),
      static_cast<int*>(next_ray), n, rx, ry, rz, nrows, max_iters, any_hit);
  return (int)cudaGetLastError();
}

template <bool kSplit>
int shape(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, grid_dda_kernel<kSplit>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, grid_dda_kernel<kSplit>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = kRayThreads;
  out[2] = blocks;
  out[3] = fa.numRegs;
  out[4] = (int)fa.sharedSizeBytes;
  out[5] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace

// G1. table: [nrows, 128] f32 (accel/grid.py inline layout); geom: [9] f32
// (lo xyz, hi xyz, cell size xyz); orig, dir: [n, 3] f32; t_max: [n] f32 or
// null; active: [n] u8 or null; next_ray: [1] i32 scratch, 0 at the launch.
// Outputs out_t [n] f32, out_tri [n] i32, out_u, out_v [n] f32, out_steps
// [n] i32. Returns the first CUDA error, else cudaGetLastError() after the
// launch.
extern "C" int grid_dda_launch(const void* table, const void* geom,
                               const void* orig, const void* dir,
                               const void* t_max, const void* active,
                               void* out_t, void* out_tri, void* out_u,
                               void* out_v, void* out_steps, void* next_ray,
                               int n, int rx, int ry, int rz, int nrows,
                               int max_iters, int any_hit, void* stream) {
  return launch<false>(table, nullptr, geom, orig, dir, t_max, active, out_t,
                       out_tri, out_u, out_v, out_steps, next_ray, n, rx, ry,
                       rz, nrows, max_iters, any_hit, stream);
}

// G1's split form. cells: [rx*ry*rz, 8] f32 meta rows (quad start, count);
// quads: [nquads, 64] f32 quad rows (accel/grid.py split layout); the other
// arguments and the outputs as grid_dda_launch's; out_steps counts quad
// rows.
extern "C" int grid_dda_split_launch(const void* cells, const void* quads,
                                     const void* geom, const void* orig,
                                     const void* dir, const void* t_max,
                                     const void* active, void* out_t,
                                     void* out_tri, void* out_u, void* out_v,
                                     void* out_steps, void* next_ray, int n,
                                     int rx, int ry, int rz, int nquads,
                                     int max_iters, int any_hit,
                                     void* stream) {
  return launch<true>(quads, cells, geom, orig, dir, t_max, active, out_t,
                      out_tri, out_u, out_v, out_steps, next_ray, n, rx, ry,
                      rz, nquads, max_iters, any_hit, stream);
}

// G1's launch shape into out[6]: threads a block, threads a ray, blocks
// resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers a thread, static shared memory and local (spill) bytes a
// thread. Returns a CUDA error or 0.
extern "C" int grid_dda_shape(int* out) { return shape<false>(out); }

// The same of G1's split form.
extern "C" int grid_dda_split_shape(int* out) { return shape<true>(out); }
