// K7: the half-split kd-tree stream packet kernel for Hopper (sm_90a).
// Replaces the TPU kernel clpathtracer_tpu/ops/packet.py::_kernel_stream2
// (its traversal machine _make_machine and _machine_init), the engine
// traverse_packet runs for engine="stream2".
//
// What it computes, per packet tile of `tile` rays: K3's interval walk of
// the kd-tree (packet_stream.cu) with each tile split-culled in halves.
// Lanes [0, tile / 2) are the left half, the rest the right half; each half
// has its own conservative bounds over its active lanes, its own [t_lo,
// t_hi] interval on every stack entry and its own t_upper. In detail, as
// the TPU machine does it:
//   seed: a tile without an active lane does no walk; a half without one
//     gets t_hi = -3.4e38 at the root, so it never goes live; the root is
//     pushed when either half's root interval is live;
//   pop: each half is live when t_lo <= min(t_hi, its t_upper) and t_hi > 0
//     (against the t_upper of pop time); a node neither half reaches is
//     skipped (dead pops count);
//   split: the visit order comes from the LEFT half's direction sign alone;
//     each half gives each child the interval of its own near or far side
//     of the plane; a child is pushed, far first, when either half's
//     interval is live, and the entry carries both intervals. (The TPU
//     kernel gives the right half the left half's near and far intervals
//     even where the right half's own sign on the axis is the other one,
//     which loses hits: a dead left half, or halves of opposite uniform
//     signs. Here the two agree wherever the halves' signs do.)
//   leaf: its chunks run with the halves live at the pop: chunk rows r0 +
//     16 b, r0 = 4 q / 8 for the quad start q, clamped to n_rows - 16, for
//     b < ceil((ceil((4 q + count) / 8) - r0) / 16) (an empty leaf at an
//     odd quad start gets one chunk; the host computes the count,
//     ops/packet.py::stream2_nodes); a chunk's dense MT test (_mt_chunk_math
//     with the active mask, kd_walk.cuh::dense_window) runs for the lanes of
//     the live halves only; no window is culled;
//   t_upper: after a leaf's last chunk, when the pop count is a multiple of
//     4, each live half takes the largest best t over its active lanes; an
//     empty leaf (no chunk) refreshes nothing.
// Stats per tile: node pops, chunks, the tile's active lanes, 0, 0. Tie
// rule: dense_window's (_mt_chunk_math's). The TPU program steps two tiles'
// machines in turn; the machines share nothing, so here each tile is one
// block. The plain torch version (ops/packet.py::packet_stream2_reference)
// replays the same walk with the same rounding (__f*_rn, --fmad=false) and
// agrees exactly in t, slot and stats.
//
// Design: one block per tile, tile/RPT threads of RPT rays each, and the
// block-uniform walk of kd_walk.cuh, as K3: every thread computes the same
// pops and interval tests for both halves; thread 0 writes the stack (128
// entries of node, t_lo and t_hi left, t_lo and t_hi right) and barriers
// order its reads and writes. A leaf's chunks (cols 0-11 of 128 records, 6
// KB) are double-buffered in shared memory with cp.async
// (kd_walk.cuh::stream_windows, as K6b). The stack is guarded: a split whose
// pushes could pass 128 entries sets the overflow flag (the wrapper raises)
// and ends the walk.
//
// What bounds it on this card: FP32 issue in the dense MT test (15-53
// operations per pair by its early exit), as K3; the half split removes a
// half's lanes from a chunk's test when that half has left the node, but
// culls no window, so a tile streams every chunk of every leaf either half
// reaches. Besides, the walk's serial barriers and global reads, and one
// block per tile (128 tiles of 2048 rays at 512x512 on 132 SMs).

#include <cuda_runtime.h>

#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

struct S2Args {
  const int4* nodes_i;     // [M]: (flags, child_lo | row0, child_hi | -,
                           //       0 | chunks)
  const float* nodes_f;    // [6 + M]: root AABB, split value per node
  const float4* rows;      // [n_rows * 8] records of 16 f32
  const float* orig_t;     // [3, n_rays]
  const float* dir_t;      // [3, n_rays]
  const float* act;        // [n_rays], > 0 for an active lane
  float* best_t;           // [n_rays]
  int* best_slot;          // [n_rays]
  int* stats;              // [n_tiles, 5]
  int* overflow;           // [1], set to 1 when a walk's stack overflows
  int n_rays, tile, n_rows;
};

__device__ __forceinline__ bool live(float tlo, float thi, float t_upper) {
  return tlo <= fminf(thi, t_upper) && thi > 0.f;
}

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
packet_stream2_kernel(const S2Args a) {
  __shared__ __align__(16) float4 buf[2 * kWinUsedF4];
  __shared__ int s_node[kStack];
  __shared__ float s_tlo_l[kStack], s_thi_l[kStack];
  __shared__ float s_tlo_r[kStack], s_thi_r[kStack];
  __shared__ float red[kMaxThreads / 32];
  __shared__ int ired[kMaxThreads / 32];
  __shared__ Bounds BL, BR;

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * a.tile;

  Ray ray[RPT];
  bool on[RPT], on_l[RPT], on_r[RPT], go[RPT];
  float bt[RPT];
  int bs[RPT];
  load_rays<RPT>(a.orig_t, a.dir_t, a.act, a.n_rays, base, ray, on, bt, bs);
  half_lanes<RPT>(on, a.tile, false, on_l);
  half_lanes<RPT>(on, a.tile, true, on_r);
  const int n_l = packet_bounds<RPT>(ray, on_l, BL, red, ired);
  const int n_r = packet_bounds<RPT>(ray, on_r, BR, red, ired);

  int sp = 0;
  if (n_l + n_r > 0) {  // seed: the root's interval per half
    float lt_lo, lt_hi, rt_lo, rt_hi;
    box_interval(a.nodes_f, a.nodes_f + 3, BL, &lt_lo, &lt_hi);
    box_interval(a.nodes_f, a.nodes_f + 3, BR, &rt_lo, &rt_hi);
    if (n_l == 0) lt_hi = -kBig;  // an empty half never goes live
    if (n_r == 0) rt_hi = -kBig;
    if (tid == 0) {
      s_node[0] = 0;
      s_tlo_l[0] = lt_lo;
      s_thi_l[0] = lt_hi;
      s_tlo_r[0] = rt_lo;
      s_thi_r[0] = rt_hi;
    }
    __syncthreads();
    sp = (lt_lo <= lt_hi && lt_hi > 0.f) || (rt_lo <= rt_hi && rt_hi > 0.f);
  }

  float tu_l = kBig, tu_r = kBig;
  int nv = 0, nl = 0;
  bool overflow = false;
  while (sp > 0) {
    --sp;
    const int node = s_node[sp];
    const float tlo_l = s_tlo_l[sp], thi_l = s_thi_l[sp];
    const float tlo_r = s_tlo_r[sp], thi_r = s_thi_r[sp];
    __syncthreads();  // every thread has read slot sp before it is reused
    ++nv;
    const bool live_l = live(tlo_l, thi_l, tu_l);
    const bool live_r = live(tlo_r, thi_r, tu_r);
    if (!(live_l || live_r)) continue;
    const int4 nd = a.nodes_i[node];
    if (nd.x >= 4) {  // leaf: its chunks for the live halves
      const int nch = nd.w;
      nl += nch;
      if (nch == 0) continue;
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        go[k] = (live_l && on_l[k]) || (live_r && on_r[k]);
      stream_windows<RPT>(a.rows, a.n_rows, nd.y, nch, buf, ray, go, bt, bs);
      if ((nv & kTupMask) == 0) {
        if (live_l) tu_l = tile_t_upper<RPT>(bt, on_l, red);
        if (live_r) tu_r = tile_t_upper<RPT>(bt, on_r, red);
      }
    } else {  // split: far child first, then the near child
      if (sp + 2 > kStack) {
        overflow = true;
        break;
      }
      const int ax = nd.x & 3;
      const float split = a.nodes_f[6 + node];
      float lp_min, lp_max, rp_min, rp_max;
      bool l_nlo, r_nlo;
      split_interval(BL, ax, split, &lp_min, &lp_max, &l_nlo);
      split_interval(BR, ax, split, &rp_min, &rp_max, &r_nlo);
      const int near = l_nlo ? nd.y : nd.z;  // the left half's order
      const int far = l_nlo ? nd.z : nd.y;
      // [lo, hi] of the near and the far child for each half
      const float ln_lo = tlo_l, ln_hi = fminf(thi_l, lp_max);
      const float lf_lo = fmaxf(tlo_l, lp_min), lf_hi = thi_l;
      float rn_lo = tlo_r, rn_hi = fminf(thi_r, rp_max);
      float rf_lo = fmaxf(tlo_r, rp_min), rf_hi = thi_r;
      if (r_nlo != l_nlo) {  // the right half's near child is `far`
        rn_lo = rf_lo;
        rn_hi = thi_r;
        rf_lo = tlo_r;
        rf_hi = fminf(thi_r, rp_max);
      }
      if (lf_lo <= fminf(lf_hi, tu_l) || rf_lo <= fminf(rf_hi, tu_r)) {
        if (tid == 0) {
          s_node[sp] = far;
          s_tlo_l[sp] = lf_lo;
          s_thi_l[sp] = lf_hi;
          s_tlo_r[sp] = rf_lo;
          s_thi_r[sp] = rf_hi;
        }
        ++sp;
      }
      if (ln_lo <= fminf(ln_hi, tu_l) || rn_lo <= fminf(rn_hi, tu_r)) {
        if (tid == 0) {
          s_node[sp] = near;
          s_tlo_l[sp] = ln_lo;
          s_thi_l[sp] = ln_hi;
          s_tlo_r[sp] = rn_lo;
          s_thi_r[sp] = rn_hi;
        }
        ++sp;
      }
      __syncthreads();
    }
  }
  if (overflow && tid == 0) *a.overflow = 1;

  store_tile<RPT>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl,
                  n_l + n_r, 0, 0);
}

template <int RPT>
int launch_rpt(const S2Args& a, cudaStream_t stream) {
  packet_stream2_kernel<RPT>
      <<<a.n_rays / a.tile, a.tile / RPT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K7. nodes_i: [M, 4] i32 (ops/packet.py::stream2_nodes); nodes_f: [6 + M]
// f32; rows: [n_rows * 8, 16] f32 records (v0, e1, e2, tri_id), 16-byte
// aligned; orig_t, dir_t: [3, n_rays] f32 tile-major; act: [n_rays] f32.
// Outputs best_t [n_rays] f32, best_slot [n_rays] i32 (-1 on a miss), stats
// [n_rays / tile, 5] i32, and overflow [1] i32 (zeroed by the caller; set to
// 1 when a stack overflows). tile: a multiple of 32 up to 4096, with
// tile / 512 rays per thread above 512. Returns cudaGetLastError() after the
// launch.
extern "C" int packet_stream2_launch(
    const void* nodes_i, const void* nodes_f, const void* rows,
    const void* orig_t, const void* dir_t, const void* act, void* best_t,
    void* best_slot, void* stats, void* overflow, int n_rays, int tile,
    int n_rows, void* stream) {
  S2Args a;
  a.nodes_i = static_cast<const int4*>(nodes_i);
  a.nodes_f = static_cast<const float*>(nodes_f);
  a.rows = static_cast<const float4*>(rows);
  a.orig_t = static_cast<const float*>(orig_t);
  a.dir_t = static_cast<const float*>(dir_t);
  a.act = static_cast<const float*>(act);
  a.best_t = static_cast<float*>(best_t);
  a.best_slot = static_cast<int*>(best_slot);
  a.stats = static_cast<int*>(stats);
  a.overflow = static_cast<int*>(overflow);
  a.n_rays = n_rays;
  a.tile = tile;
  a.n_rows = n_rows;
  if (tile <= 0 || tile % 32 || tile > 8 * kMaxThreads || n_rays % tile ||
      n_rows < kChunkRows || reinterpret_cast<size_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpt = tile <= kMaxThreads ? 1 : tile / kMaxThreads;
  if (rpt * (tile / rpt) != tile) return (int)cudaErrorInvalidValue;
  switch (rpt) {
    case 1: return launch_rpt<1>(a, s);
    case 2: return launch_rpt<2>(a, s);
    case 4: return launch_rpt<4>(a, s);
    case 8: return launch_rpt<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
