// K3: the kd-tree stream packet kernel for Hopper (sm_90a). Replaces the
// TPU kernel clpathtracer_tpu/ops/packet.py::_kernel_stream_smem (with
// _stream_windows_culled), the engine traverse_packet runs on a kd-tree with
// no windows attached. Its bf16 instance is K4, the bf16 preview of
// clpathtracer_tpu/ops/packet.py::_kernel_stream (precision="bf16"); K4's
// f32 form computes K3's function and is served by K3.
//
// What it computes, per packet tile of `tile` rays: one interval walk of the
// kd-tree for the whole tile (a stack of (node, t_lo, t_hi) entries), with
// the node boxes tested against conservative bounds of the tile's active
// lanes (origin range and clipped inverse-direction range per axis). A leaf
// streams its triangle records in windows of 128 records (16 rows of 8) on
// the clamped grid row_of(b) = min(r0 + 16 b, n_rows - 16), skipping the
// windows that the tile cannot hit, and tests each kept window densely
// against every active lane with the SO or MT pair test of pair_tests.cuh.
// The window cull is one of:
//   kNoCull:       none (no per-window tables);
//   kCull:         the packet interval against the window's AABB;
//   kCullFrustum:  the same and the tile's 4 corner-frustum planes with a
//                  1e-5 relative slack (shared-origin pixel tiles);
//   kStrips:       the strip prepass's per-tile mask and entry distance
//                  (ops/packet.py::_strip_masks); when every strip is a
//                  512-lane gate, the dense test of a window runs only for
//                  the gates whose mask bit is set.
// t_upper, the largest best t over the active lanes, is refreshed after a
// leaf on every 4th pop (dead pops count); a node is live when
// t_lo <= min(t_hi, t_upper) and t_hi > 0; a split pushes the far child
// before the near one; the strip survey compares against min(t_hi,
// t_upper) frozen at leaf entry. Outputs: best t and best slot per ray (-1
// on a miss) and per tile (node pops, windows streamed, active lanes,
// windows culled, dense executions).
//
// Tie rule, that of clpathtracer_tpu/ops/packet.py::_mt_chunk_math: within
// a window the least t wins, among equal t the lowest row of 8 records, and
// within that row the highest record; across windows the later window wins
// at equal t. The plain torch version (ops/packet.py::
// packet_stream_reference) applies the same rule and the same rounding
// (__f*_rn, --fmad=false), so both agree exactly in t, slot and stats.
//
// Design: one block per tile; tile/RPT threads, each owning RPT rays (lane
// tid + k * threads), so a 2048-ray tile runs 512 threads of 4 rays. The
// walk is block-uniform (kd_walk.cuh, shared with K5). A kept window's 128
// records (cols 0-11) are staged in 6 KB of shared memory and every thread
// reads each record as a broadcast.
//
// What bounds it on this card: FP32 issue in the dense test (22 operations
// per SO pair, 15-53 per MT pair by its early exit), as K1. Besides, the
// walk's barriers and global reads, serial per tile, and the unhidden load
// latency of each window; one block per tile also leaves SMs idle when a
// frame has few tiles (128 tiles of 2048 rays at 512x512 on 132 SMs).
// Making it fast is later work: cp.async double-buffered windows, walk and
// test in separate warps, smaller tiles per block. K4 adds a bf16 rounding
// after each of its FP32 operations, as the preview's semantics ask; it is
// a port of the preview's results, not a speed-up on this card.

#include <climits>
#include <cuda_runtime.h>

#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

constexpr int kUsedF4 = 3;           // float4s staged per record (cols 0-11)
constexpr int kGateLanes = 512;      // lanes per gate in half-gate mode

enum Mode { kNoCull = 0, kCull = 1, kCullFrustum = 2, kStrips = 3 };

struct Args {
  const int4* nodes_i;     // [M]: (flags, child_lo | r0, child_hi | win0,
                           //       0 | nwin)
  const float* nodes_f;    // [6 + M]: root AABB, split value per node
  const float4* rows;      // [n_rows * 8] records of 16 f32
  const float* orig_t;     // [3, n_rays]
  const float* dir_t;      // [3, n_rays]
  const float* act;        // [n_rays], > 0 for an active lane
  const float* cbnd;       // [W, 6] window AABBs (kCull, kCullFrustum)
  const float* frustum;    // [n_tiles, 16] (kCullFrustum)
  const int* masks;        // [n_tiles, W] (kStrips)
  const float* ten;        // [n_tiles, W] (kStrips)
  float* best_t;           // [n_rays]
  int* best_slot;          // [n_rays]
  int* stats;              // [n_tiles, 5]
  int n_rays, tile, n_rows, n_windows, mode, n_strips;
};

// Whether the tile must stream window w (global id) of the current leaf.
__device__ bool survives(const Args& a, const Bounds& B, int tile_i, int w,
                         float tlo, float thi, float t_upper) {
  if (a.mode == kNoCull) return true;
  if (a.mode == kStrips) {
    const size_t i = (size_t)tile_i * a.n_windows + w;
    return a.masks[i] != 0 && a.ten[i] <= fminf(thi, t_upper);
  }
  const float* c = a.cbnd + (size_t)w * 6;
  bool keep = window_keeps(c, B, tlo, thi, t_upper);
  if (a.mode == kCullFrustum) {
    const float* fr = a.frustum + (size_t)tile_i * 16;
    for (int p = 0; p < 4; ++p) {
      const float nx = fr[3 * p], ny = fr[3 * p + 1], nz = fr[3 * p + 2];
      const float cx = __fsub_rn(nx > 0.f ? c[0] : c[3], fr[12]);
      const float cy = __fsub_rn(ny > 0.f ? c[1] : c[4], fr[13]);
      const float cz = __fsub_rn(nz > 0.f ? c[2] : c[5], fr[14]);
      const float sup = dot3(nx, ny, nz, cx, cy, cz);
      const float slack = __fmul_rn(
          1e-5f, __fadd_rn(__fadd_rn(fabsf(cx), fabsf(cy)), fabsf(cz)));
      keep = keep && sup <= slack;
    }
  }
  return keep;
}

// kBF16: the bf16 preview (K4; MT records, modes kNoCull and kCull): the
// window's records and the rays are rounded to bf16 once, where they are
// staged and loaded, and the dense test is mt_hit_bf16; the walk, t_upper,
// the slots and the merge stay f32 / int32, and stats lane 4 is 0 as the
// TPU kernel writes it.
template <int RPT, bool kSO, bool kBF16>
__global__ void __launch_bounds__(kMaxThreads)
packet_stream_kernel(const Args a) {
  __shared__ float4 win[kWinRecs * kUsedF4];
  __shared__ int s_node[kStack];
  __shared__ float s_tlo[kStack], s_thi[kStack];
  __shared__ float red[kMaxThreads / 32];
  __shared__ int ired[kMaxThreads / 32];
  __shared__ Bounds B;

  const int tile_i = blockIdx.x;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)tile_i * a.tile;
  const bool half = a.mode == kStrips && a.tile / a.n_strips == kGateLanes;

  Ray ray[RPT];
  bool on[RPT];
  float bt[RPT];
  int bs[RPT];
  load_rays<RPT>(a.orig_t, a.dir_t, a.act, a.n_rays, base, ray, on, bt, bs);

  // packet bounds over the active lanes (_packet_bounds_masked), in f32
  const int n_act = packet_bounds<RPT>(ray, on, B, red, ired);
  if (kBF16) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      ray[k].ox = bf(ray[k].ox);
      ray[k].oy = bf(ray[k].oy);
      ray[k].oz = bf(ray[k].oz);
      ray[k].dx = bf(ray[k].dx);
      ray[k].dy = bf(ray[k].dy);
      ray[k].dz = bf(ray[k].dz);
    }
  }

  int sp = push_root(a.nodes_f, B, n_act, s_node, s_tlo, s_thi);

  float t_upper = kBig;
  int nv = 0, nl = 0, nc = 0, nsm = 0;
  while (sp > 0) {
    --sp;
    const int node = s_node[sp];
    const float tlo = s_tlo[sp];
    const float thi = s_thi[sp];
    __syncthreads();  // every thread has read slot sp before it is reused
    ++nv;
    if (!(tlo <= fminf(thi, t_upper) && thi > 0.f)) continue;
    const int4 nd = a.nodes_i[node];
    if (nd.x >= 4) {  // leaf: stream its surviving windows
      const int r0 = nd.y, win0 = nd.z, nwin = nd.w;
      int streamed = 0;
      int b = 0;
      while (b < nwin && !survives(a, B, tile_i, win0 + b, tlo, thi, t_upper))
        ++b;
      while (b < nwin) {
        const int row = min(r0 + b * kChunkRows, a.n_rows - kChunkRows);
        const long long rec0 = (long long)row * 8;
        __syncthreads();  // every thread is done with the previous window
        for (int i = tid; i < kWinRecs * kUsedF4; i += nthr) {
          float4 v = a.rows[(rec0 + i / kUsedF4) * kRecF4 + i % kUsedF4];
          if (kBF16) v = make_float4(bf(v.x), bf(v.y), bf(v.z), bf(v.w));
          win[i] = v;
        }
        __syncthreads();
        unsigned gates = 0xffffffffu;
        if (half) {
          gates = (unsigned)a.masks[(size_t)tile_i * a.n_windows + win0 + b]
                  & ((1u << a.n_strips) - 1u);
          nsm += __popc(gates);
        } else {
          ++nsm;
        }
        dense_window<RPT, kSO, kBF16, kUsedF4, kGateLanes>(win, ray, on,
                                                          gates, rec0, bt, bs);
        ++streamed;
        ++b;
        while (b < nwin &&
               !survives(a, B, tile_i, win0 + b, tlo, thi, t_upper))
          ++b;
      }
      nl += streamed;
      if (a.mode != kNoCull) nc += nwin - streamed;
      if ((nv & 3) == 0) t_upper = tile_t_upper<RPT>(bt, on, red);
    } else {  // split: far child first, then the near child
      sp = push_children(B, nd, a.nodes_f[6 + node], tlo, thi, t_upper, sp,
                         s_node, s_tlo, s_thi);
    }
  }

  store_tile<RPT>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl,
                  n_act, nc, kBF16 ? 0 : nsm);
}

template <int RPT>
int launch_rpt(const Args& a, bool so, bool bf16, cudaStream_t stream) {
  const int n_tiles = a.n_rays / a.tile;
  const int threads = a.tile / RPT;
  if (bf16)
    packet_stream_kernel<RPT, false, true><<<n_tiles, threads, 0, stream>>>(a);
  else if (so)
    packet_stream_kernel<RPT, true, false><<<n_tiles, threads, 0, stream>>>(a);
  else
    packet_stream_kernel<RPT, false, false><<<n_tiles, threads, 0, stream>>>(
        a);
  return (int)cudaGetLastError();
}

}  // namespace

// K3, and K4's bf16 preview when bf16 != 0 (MT records, modes 0 and 1).
// nodes_i: [M, 4] i32; nodes_f: [6 + M] f32; rows: [n_rows * 8, 16] f32
// records (SO rows when so != 0, else raw (v0, e1, e2, tri_id)); orig_t,
// dir_t: [3, n_rays] f32 tile-major; act: [n_rays] f32; cbnd: [W, 6] f32
// (modes 1, 2); frustum: [n_rays / tile, 16] f32 (mode 2); masks, ten:
// [n_rays / tile, W] i32 / f32 (mode 3). Outputs best_t [n_rays] f32,
// best_slot [n_rays] i32 (-1 on a miss), stats [n_rays / tile, 5] i32.
// tile: a multiple of 32 up to 4096, with tile / 512 rays per thread above
// 512. Returns cudaGetLastError() after the launch.
extern "C" int packet_stream_launch(
    const void* nodes_i, const void* nodes_f, const void* rows,
    const void* orig_t, const void* dir_t, const void* act, const void* cbnd,
    const void* frustum, const void* masks, const void* ten, void* best_t,
    void* best_slot, void* stats, int n_rays, int tile, int n_rows,
    int n_windows, int mode, int n_strips, int so, int bf16, void* stream) {
  Args a;
  a.nodes_i = static_cast<const int4*>(nodes_i);
  a.nodes_f = static_cast<const float*>(nodes_f);
  a.rows = static_cast<const float4*>(rows);
  a.orig_t = static_cast<const float*>(orig_t);
  a.dir_t = static_cast<const float*>(dir_t);
  a.act = static_cast<const float*>(act);
  a.cbnd = static_cast<const float*>(cbnd);
  a.frustum = static_cast<const float*>(frustum);
  a.masks = static_cast<const int*>(masks);
  a.ten = static_cast<const float*>(ten);
  a.best_t = static_cast<float*>(best_t);
  a.best_slot = static_cast<int*>(best_slot);
  a.stats = static_cast<int*>(stats);
  a.n_rays = n_rays;
  a.tile = tile;
  a.n_rows = n_rows;
  a.n_windows = n_windows;
  a.mode = mode;
  a.n_strips = n_strips;
  if (tile <= 0 || tile % 32 || tile > 8 * kMaxThreads || n_rays % tile ||
      n_rows < kChunkRows || mode < kNoCull || mode > kStrips ||
      (mode == kStrips && (n_strips < 1 || n_strips > 31)) ||
      (bf16 && (so || mode > kCull)))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpt = tile <= kMaxThreads ? 1 : tile / kMaxThreads;
  if (rpt * (tile / rpt) != tile) return (int)cudaErrorInvalidValue;
  switch (rpt) {
    case 1: return launch_rpt<1>(a, so != 0, bf16 != 0, s);
    case 2: return launch_rpt<2>(a, so != 0, bf16 != 0, s);
    case 4: return launch_rpt<4>(a, so != 0, bf16 != 0, s);
    case 8: return launch_rpt<8>(a, so != 0, bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
