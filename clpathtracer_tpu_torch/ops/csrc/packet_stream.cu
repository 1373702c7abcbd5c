// K3: the kd-tree stream packet kernel for Hopper (sm_90a). Replaces the
// TPU kernel clpathtracer_tpu/ops/packet.py::_kernel_stream_smem (with
// _stream_windows_culled), the engine traverse_packet runs on a kd-tree with
// no windows attached.
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
// walk is block-uniform: every thread computes the same pops, interval
// tests and window decisions from the same global reads; thread 0 writes
// the stack (shared memory) and barriers order the reads and writes. The
// packet bounds and t_upper are block reductions. A kept window's 128
// records (cols 0-11) are staged in 6 KB of shared memory and every thread
// reads each record as a broadcast.
//
// What bounds it on this card: FP32 issue in the dense test (22 operations
// per SO pair, 15-53 per MT pair by its early exit), as K1. Besides, the
// walk's barriers and global reads, serial per tile, and the unhidden load
// latency of each window; one block per tile also leaves SMs idle when a
// frame has few tiles (128 tiles of 2048 rays at 512x512 on 132 SMs).
// Making it fast is later work: cp.async double-buffered windows, walk and
// test in separate warps, smaller tiles per block.

#include <climits>
#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::dot3;
using clpt::mt_hit;
using clpt::so_hit;

constexpr int kStack = 128;          // stack entries (the TPU kernel's)
constexpr int kChunkRows = 16;       // rows of 8 records per window
constexpr int kWinRecs = kChunkRows * 8;
constexpr int kRecF4 = 4;            // float4s per 16-float record
constexpr int kUsedF4 = 3;           // float4s loaded per record (cols 0-11)
constexpr int kGateLanes = 512;      // lanes per gate in half-gate mode
constexpr int kMaxThreads = 512;
constexpr float kBig = 3.4e38f;
constexpr float kInvBig = 1e30f;

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

// Block reductions; every thread gets the result. Callers are uniform.
__device__ float block_min(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red[] is free: every thread read the previous result
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fminf(r, red[w]);
  return r;
}

__device__ float block_max(float v, float* red) {
  return -block_min(-v, red);
}

__device__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  return r;
}

__device__ __forceinline__ float clip_inv(float d) {
  return fminf(fmaxf(__frcp_rn(d), -kInvBig), kInvBig);
}

// The packet bounds, in shared memory: ol[3], oh[3], il[3], ih[3].
struct Bounds {
  float ol[3], oh[3], il[3], ih[3];
};

// min and max of (b - ol) * il, (b - ol) * ih, (b - oh) * il, (b - oh) * ih
__device__ __forceinline__ void prods(float b, float ol, float oh, float il,
                                      float ih, float* mn, float* mx) {
  const float c1 = __fmul_rn(__fsub_rn(b, ol), il);
  const float c2 = __fmul_rn(__fsub_rn(b, ol), ih);
  const float c3 = __fmul_rn(__fsub_rn(b, oh), il);
  const float c4 = __fmul_rn(__fsub_rn(b, oh), ih);
  *mn = fminf(fminf(c1, c2), fminf(c3, c4));
  *mx = fmaxf(fmaxf(c1, c2), fmaxf(c3, c4));
}

// clpathtracer_tpu/ops/packet.py::_box_interval over the packet bounds
__device__ void box_interval(const float* lo, const float* hi,
                             const Bounds& B, float* t_en, float* t_ex) {
  float en = -kInvBig, ex = kInvBig;
  for (int ax = 0; ax < 3; ++ax) {
    const float il = B.il[ax], ih = B.ih[ax];
    const bool uniform = __fmul_rn(il, ih) > 0.f;
    const bool pos = il > 0.f;
    float near_min, far_max, unused;
    prods(pos ? lo[ax] : hi[ax], B.ol[ax], B.oh[ax], il, ih, &near_min,
          &unused);
    prods(pos ? hi[ax] : lo[ax], B.ol[ax], B.oh[ax], il, ih, &unused,
          &far_max);
    en = ax == 0 ? (uniform ? near_min : -kInvBig)
                 : fmaxf(en, uniform ? near_min : -kInvBig);
    ex = ax == 0 ? (uniform ? far_max : kInvBig)
                 : fminf(ex, uniform ? far_max : kInvBig);
  }
  *t_en = en;
  *t_ex = ex;
}

// Whether the tile must stream window w (global id) of the current leaf.
__device__ bool survives(const Args& a, const Bounds& B, int tile_i, int w,
                         float tlo, float thi, float t_upper) {
  if (a.mode == kNoCull) return true;
  const float tup = fminf(thi, t_upper);
  if (a.mode == kStrips) {
    const size_t i = (size_t)tile_i * a.n_windows + w;
    return a.masks[i] != 0 && a.ten[i] <= tup;
  }
  const float* c = a.cbnd + (size_t)w * 6;
  float t_en, t_ex;
  box_interval(c, c + 3, B, &t_en, &t_ex);
  bool keep = t_en <= tup && t_ex >= tlo && t_ex > 0.f;
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

template <int RPT, bool kSO>
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
  int n_on = 0;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t g = base + tid + k * nthr;
    ray[k].ox = a.orig_t[g];
    ray[k].oy = a.orig_t[a.n_rays + g];
    ray[k].oz = a.orig_t[2 * (size_t)a.n_rays + g];
    ray[k].dx = a.dir_t[g];
    ray[k].dy = a.dir_t[a.n_rays + g];
    ray[k].dz = a.dir_t[2 * (size_t)a.n_rays + g];
    on[k] = a.act[g] > 0.f;
    n_on += on[k];
    bt[k] = kBig;
    bs[k] = -1;
  }

  // packet bounds over the active lanes (_packet_bounds_masked)
  for (int ax = 0; ax < 3; ++ax) {
    float ol = kBig, oh = -kBig, il = kInvBig, ih = -kInvBig;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (!on[k]) continue;
      const float o = ax == 0 ? ray[k].ox : ax == 1 ? ray[k].oy : ray[k].oz;
      const float d = ax == 0 ? ray[k].dx : ax == 1 ? ray[k].dy : ray[k].dz;
      const float inv = clip_inv(d);
      ol = fminf(ol, o);
      oh = fmaxf(oh, o);
      il = fminf(il, inv);
      ih = fmaxf(ih, inv);
    }
    ol = block_min(ol, red);
    oh = block_max(oh, red);
    il = block_min(il, red);
    ih = block_max(ih, red);
    if (tid == 0) {
      B.ol[ax] = ol;
      B.oh[ax] = oh;
      B.il[ax] = il;
      B.ih[ax] = ih;
    }
  }
  const int n_act = block_sum(n_on, ired);  // its barriers publish B

  float rt_lo, rt_hi;
  box_interval(a.nodes_f, a.nodes_f + 3, B, &rt_lo, &rt_hi);
  int sp = (rt_lo <= rt_hi && rt_hi > 0.f && n_act > 0) ? 1 : 0;
  if (tid == 0) {
    s_node[0] = 0;
    s_tlo[0] = rt_lo;
    s_thi[0] = rt_hi;
  }
  __syncthreads();

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
        for (int i = tid; i < kWinRecs * kUsedF4; i += nthr)
          win[i] = a.rows[(rec0 + i / kUsedF4) * kRecF4 + i % kUsedF4];
        __syncthreads();
        unsigned gates = 0xffffffffu;
        if (half) {
          gates = (unsigned)a.masks[(size_t)tile_i * a.n_windows + win0 + b]
                  & ((1u << a.n_strips) - 1u);
          nsm += __popc(gates);
        } else {
          ++nsm;
        }
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          if (!on[k]) continue;
          if (half && !((gates >> ((tid + k * nthr) / kGateLanes)) & 1u))
            continue;
          float ct = kBig;
          int cr = -1;  // record of ct within the window
          for (int r = 0; r < kWinRecs; ++r) {
            const float4 p = win[r * kUsedF4];
            const float4 q = win[r * kUsedF4 + 1];
            const float4 w = win[r * kUsedF4 + 2];
            float t;
            const bool hit = kSO ? so_hit(ray[k], p, q, w, &t)
                                 : mt_hit(ray[k], p, q, w, &t);
            // least t; at equal t the same row's later record
            if (hit && t < kBig &&
                (t < ct || (t == ct && (r >> 3) == (cr >> 3)))) {
              ct = t;
              cr = r;
            }
          }
          if (ct < kBig && ct <= bt[k]) {  // the later window wins ties
            bt[k] = ct;
            bs[k] = (int)(rec0 + cr);
          }
        }
        ++streamed;
        ++b;
        while (b < nwin &&
               !survives(a, B, tile_i, win0 + b, tlo, thi, t_upper))
          ++b;
      }
      nl += streamed;
      if (a.mode != kNoCull) nc += nwin - streamed;
      if ((nv & 3) == 0) {
        float m = -kBig;
#pragma unroll
        for (int k = 0; k < RPT; ++k)
          if (on[k]) m = fmaxf(m, bt[k]);
        t_upper = block_max(m, red);
      }
    } else {  // split: far child first, then the near child
      const int ax = nd.x & 3;
      const float il = B.il[ax], ih = B.ih[ax];
      const bool uni = __fmul_rn(il, ih) > 0.f;
      const bool nlo = __fadd_rn(il, ih) > 0.f;
      float tp_min, tp_max;
      prods(a.nodes_f[6 + node], B.ol[ax], B.oh[ax], il, ih, &tp_min,
            &tp_max);
      if (!uni) {
        tp_min = -kInvBig;
        tp_max = kInvBig;
      }
      const int near = nlo ? nd.y : nd.z;
      const int far = nlo ? nd.z : nd.y;
      const float far_lo = fmaxf(tlo, tp_min);
      const float near_hi = fminf(thi, tp_max);
      if (sp + 2 > kStack) __trap();  // the stack cannot overflow silently
      if (far_lo <= fminf(thi, t_upper)) {
        if (tid == 0) {
          s_node[sp] = far;
          s_tlo[sp] = far_lo;
          s_thi[sp] = thi;
        }
        ++sp;
      }
      if (tlo <= fminf(near_hi, t_upper)) {
        if (tid == 0) {
          s_node[sp] = near;
          s_tlo[sp] = tlo;
          s_thi[sp] = near_hi;
        }
        ++sp;
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t g = base + tid + k * nthr;
    a.best_t[g] = bt[k];
    a.best_slot[g] = bt[k] < kBig ? bs[k] : -1;
  }
  if (tid == 0) {
    int* st = a.stats + 5 * (size_t)tile_i;
    st[0] = nv;
    st[1] = nl;
    st[2] = n_act;
    st[3] = nc;
    st[4] = nsm;
  }
}

template <int RPT>
int launch_rpt(const Args& a, bool so, cudaStream_t stream) {
  const int n_tiles = a.n_rays / a.tile;
  const int threads = a.tile / RPT;
  if (so)
    packet_stream_kernel<RPT, true><<<n_tiles, threads, 0, stream>>>(a);
  else
    packet_stream_kernel<RPT, false><<<n_tiles, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. nodes_i: [M, 4] i32; nodes_f: [6 + M] f32; rows: [n_rows * 8, 16] f32
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
    int n_windows, int mode, int n_strips, int so, void* stream) {
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
      (mode == kStrips && (n_strips < 1 || n_strips > 31)))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpt = tile <= kMaxThreads ? 1 : tile / kMaxThreads;
  if (rpt * (tile / rpt) != tile) return (int)cudaErrorInvalidValue;
  switch (rpt) {
    case 1: return launch_rpt<1>(a, so != 0, s);
    case 2: return launch_rpt<2>(a, so != 0, s);
    case 4: return launch_rpt<4>(a, so != 0, s);
    case 8: return launch_rpt<8>(a, so != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
