// The kd-tree walks' device functions, shared by the stream kernel K3/K4
// (packet_stream.cu), the queue kernel K5 (packet_queue.cu), the v1
// kernels K6a, K6b and K9 (packet_v1.cu), the half-split kernel K7
// (packet_stream2.cu) and the plane-form kernel K8 (packet_mxu.cu): one
// copy, so every walk rounds every interval as the others and as the plain
// torch versions do (clpathtracer_tpu_torch/ops/packet.py::_walk_tile,
// _queue_tile, _binary_v1_walk, _wide_v1_walk, _stream2_tile and
// ops/packet_mxu.py::_mxu_tile).
//
// A walk is block-uniform: every thread of the block computes the same
// pops, interval tests and window decisions from the same reads; thread 0
// writes the stack in shared memory and barriers order its reads and
// writes. The packet bounds and t_upper are block reductions (K3/K4 run
// the walk on every block of a cluster and reduce them over the cluster
// instead: packet_stream.cu, cluster.cuh).
//
//   packet bounds: per axis the origin range and the clipped inverse-
//     direction range over the tile's active lanes
//     (clpathtracer_tpu/ops/packet.py::_packet_bounds_masked); with
//     half_lanes, over one half of the tile (K7's half split), and
//     tile_t_upper likewise;
//   box_interval: the packet-conservative [t_enter, t_exit] of an AABB
//     (_box_interval);
//   split_interval: the crossing of one split plane (_split_plane_interval);
//   window_keeps: the AABB window cull, [ltlo, min(lthi, t_upper)] against
//     the window's box interval;
//   dense_window: the dense test of one staged window of 128 records
//     against a thread's rays, merged with the TPU kernels' tie rule;
//   stream_windows: a run of windows on the clamped grid, double-buffered
//     with cp.async, each tested by dense_window;
//   load_rays, push_root, push_children, store_tile: the frame of a
//     walk around them;
//   cp_async16, cp_async4, cp_async_commit, cp_async_wait, wait_pending:
//     cp.async copies into shared memory and their commit groups.
//
// The stack guard: a split whose two pushes could pass the kStack entries
// ends the walk instead (push_children returns -1 and writes nothing); the
// kernel then sets its overflow flag, which the wrapper raises on after
// the launch. The decision is block-uniform, so the block leaves the walk
// as a whole and the CUDA context stays usable.

#pragma once

#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace clpt {

constexpr int kStack = 128;          // stack entries (the TPU kernels')
constexpr int kChunkRows = 16;       // rows of 8 records per window
constexpr int kWinRecs = kChunkRows * 8;
constexpr int kRecF4 = 4;            // float4s per 16-float record
constexpr int kUsedF4 = 3;           // float4s staged per record (cols 0-11)
constexpr int kWinUsedF4 = kWinRecs * kUsedF4;
constexpr int kTupMask = 3;          // t_upper after a leaf on every 4th pop
constexpr int kMaxThreads = 512;
constexpr float kBig = 3.4e38f;
constexpr float kInvBig = 1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Block reductions; every thread gets the result. Callers are uniform.
__device__ __forceinline__ float block_min(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red[] is free: every thread read the previous result
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fminf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  return -block_min(-v, red);
}

__device__ __forceinline__ int block_sum(int v, int* red) {
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

// t_upper: the largest best t over the tile's active lanes (-kBig when none).
template <int RPT>
__device__ __forceinline__ float tile_t_upper(const float* bt, const bool* on,
                                              float* red) {
  float m = -kBig;
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (on[k]) m = fmaxf(m, bt[k]);
  return block_max(m, red);
}

// The active flags of one half of the tile: lanes [0, tile / 2) (right =
// false) or [tile / 2, tile) (right = true).
template <int RPT>
__device__ __forceinline__ void half_lanes(const bool* on, int tile,
                                           bool right, bool* out) {
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    out[k] = on[k] &&
             (((int)(threadIdx.x + k * blockDim.x) >= tile / 2) == right);
}

// This thread's rays of tile `base` (lane tid + k * blockDim.x) from the
// [3, n_rays] tile-major arrays, their active flags (all active when act is
// null), and empty winners.
template <int RPT>
__device__ __forceinline__ void load_rays(const float* orig_t,
                                          const float* dir_t,
                                          const float* act, int n_rays,
                                          size_t base, Ray* ray, bool* on,
                                          float* bt, int* bs) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t g = base + threadIdx.x + k * blockDim.x;
    ray[k].ox = orig_t[g];
    ray[k].oy = orig_t[n_rays + g];
    ray[k].oz = orig_t[2 * (size_t)n_rays + g];
    ray[k].dx = dir_t[g];
    ray[k].dy = dir_t[n_rays + g];
    ray[k].dz = dir_t[2 * (size_t)n_rays + g];
    on[k] = act == nullptr || act[g] > 0.f;
    bt[k] = kBig;
    bs[k] = -1;
  }
}

// The winners (slot -1 on a miss) and the tile's stats row (thread 0).
template <int RPT>
__device__ __forceinline__ void store_tile(const float* bt, const int* bs,
                                           size_t base, float* best_t,
                                           int* best_slot, int* stats,
                                           int nv, int nl, int n_act, int nc,
                                           int lane4) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t g = base + threadIdx.x + k * blockDim.x;
    best_t[g] = bt[k];
    best_slot[g] = bt[k] < kBig ? bs[k] : -1;
  }
  if (threadIdx.x == 0) {
    int* st = stats + 5 * (size_t)blockIdx.x;
    st[0] = nv;
    st[1] = nl;
    st[2] = n_act;
    st[3] = nc;
    st[4] = lane4;
  }
}

// The packet bounds, in shared memory: ol[3], oh[3], il[3], ih[3].
struct Bounds {
  float ol[3], oh[3], il[3], ih[3];
};

// Computes the packet bounds over the active lanes into B (thread 0 writes)
// and returns the tile's count of active lanes; its last barriers publish B.
template <int RPT>
__device__ __forceinline__ int packet_bounds(const Ray* ray, const bool* on,
                                             Bounds& B, float* red,
                                             int* ired) {
  int n_on = 0;
#pragma unroll
  for (int k = 0; k < RPT; ++k) n_on += on[k];
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
    if (threadIdx.x == 0) {
      B.ol[ax] = ol;
      B.oh[ax] = oh;
      B.il[ax] = il;
      B.ih[ax] = ih;
    }
  }
  return block_sum(n_on, ired);
}

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
__device__ __forceinline__ void box_interval(const float* lo, const float* hi,
                                             const Bounds& B, float* t_en,
                                             float* t_ex) {
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

// clpathtracer_tpu/ops/packet.py::_split_plane_interval: the packet-
// conservative [tp_min, tp_max] of the crossing of split plane `split` on
// axis `ax`, and whether the low child is the near one
__device__ __forceinline__ void split_interval(const Bounds& B, int ax,
                                               float split, float* tp_min,
                                               float* tp_max, bool* nlo) {
  const float il = B.il[ax], ih = B.ih[ax];
  const bool uni = __fmul_rn(il, ih) > 0.f;
  *nlo = __fadd_rn(il, ih) > 0.f;
  prods(split, B.ol[ax], B.oh[ax], il, ih, tp_min, tp_max);
  if (!uni) {
    *tp_min = -kInvBig;
    *tp_max = kInvBig;
  }
}

// The root entry: the packet interval of the root AABB (nodes_f[0:6]) on
// the stack when it is live and the tile has an active lane (thread 0
// writes, the barrier publishes). Returns the stack pointer, 1 or 0.
__device__ __forceinline__ int push_root(const float* nodes_f,
                                         const Bounds& B, int n_act,
                                         int* s_node, float* s_tlo,
                                         float* s_thi) {
  float rt_lo, rt_hi;
  box_interval(nodes_f, nodes_f + 3, B, &rt_lo, &rt_hi);
  if (threadIdx.x == 0) {
    s_node[0] = 0;
    s_tlo[0] = rt_lo;
    s_thi[0] = rt_hi;
  }
  __syncthreads();
  return (rt_lo <= rt_hi && rt_hi > 0.f && n_act > 0) ? 1 : 0;
}

// The AABB window cull: window box c[6] (lo xyz, hi xyz) against the leaf
// interval [tlo, min(thi, t_upper)]
__device__ __forceinline__ bool window_keeps(const float* c, const Bounds& B,
                                             float tlo, float thi,
                                             float t_upper) {
  float t_en, t_ex;
  box_interval(c, c + 3, B, &t_en, &t_ex);
  return t_en <= fminf(thi, t_upper) && t_ex >= tlo && t_ex > 0.f;
}

// A split's children onto the stack, far child first (popped last), each
// when its interval is live; thread 0 writes, the barrier publishes.
// Returns the new stack pointer, or -1 without a write when the two pushes
// could pass kStack entries (the stack guard; the caller ends its walk).
__device__ __forceinline__ int push_children(const Bounds& B, int4 nd,
                                             float split, float tlo,
                                             float thi, float t_upper, int sp,
                                             int* s_node, float* s_tlo,
                                             float* s_thi) {
  float tp_min, tp_max;
  bool nlo;
  split_interval(B, nd.x & 3, split, &tp_min, &tp_max, &nlo);
  const int near = nlo ? nd.y : nd.z;
  const int far = nlo ? nd.z : nd.y;
  const float far_lo = fmaxf(tlo, tp_min);
  const float near_hi = fminf(thi, tp_max);
  if (sp + 2 > kStack) return -1;
  if (far_lo <= fminf(thi, t_upper)) {
    if (threadIdx.x == 0) {
      s_node[sp] = far;
      s_tlo[sp] = far_lo;
      s_thi[sp] = thi;
    }
    ++sp;
  }
  if (tlo <= fminf(near_hi, t_upper)) {
    if (threadIdx.x == 0) {
      s_node[sp] = near;
      s_tlo[sp] = tlo;
      s_thi[sp] = near_hi;
    }
    ++sp;
  }
  __syncthreads();
  return sp;
}

// The dense test of one staged window (kWinRecs records, kStride float4s
// apart, cols 0-11 in the first three) against this thread's rays; lanes
// whose gate bit is clear (gates >> (lane / kGate)) are skipped. Tie rule,
// that of clpathtracer_tpu/ops/packet.py::_mt_chunk_math: within the window
// the least t, among equal t the lowest row of 8 records and within it the
// highest record; against the earlier windows the later window wins at
// equal t. kBF16: the MT test of the bf16 preview (mt_hit_bf16; the caller
// staged the records and the rays rounded to bf16).
template <int RPT, bool kSO, bool kBF16, int kStride, int kGate>
__device__ __forceinline__ void dense_window(const float4* win, const Ray* ray,
                                             const bool* on, unsigned gates,
                                             long long rec0, float* bt,
                                             int* bs) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (!on[k]) continue;
    if (!((gates >> ((threadIdx.x + k * blockDim.x) / kGate)) & 1u)) continue;
    float ct = kBig;
    int cr = -1;  // record of ct within the window
    for (int r = 0; r < kWinRecs; ++r) {
      const float4 p = win[r * kStride];
      const float4 q = win[r * kStride + 1];
      const float4 w = win[r * kStride + 2];
      float t;
      const bool hit = kSO     ? so_hit(ray[k], p, q, w, &t)
                       : kBF16 ? mt_hit_bf16(ray[k], p, q, w, &t)
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
}

// One window (rows [row, row + 16), cols 0-11 of each record) into `dst`:
// this thread's share of the 16-byte copies, then its commit group.
__device__ __forceinline__ void copy_window(float4* dst, const float4* recs,
                                            int row) {
  const float4* src = recs + (size_t)row * 8 * kRecF4;
  for (int i = threadIdx.x; i < kWinUsedF4; i += blockDim.x)
    cp_async16(dst + i, src + (i / kUsedF4) * kRecF4 + i % kUsedF4);
  cp_async_commit();
}

// Stream and test nch windows, rows row0 + 16 b clamped to n_rows - 16 for
// b < nch, in order, double-buffered in buf[2 * kWinUsedF4]: window b + 1's
// copy is in flight while window b is tested; one commit group per window
// and thread, each waited exactly once (wait_group 1 while the next copy
// flies, 0 for the last window); nch = 0 starts no copy. `on`: the lanes
// that test. Every thread calls it (uniform).
template <int RPT>
__device__ void stream_windows(const float4* recs, int n_rows, int row0,
                               int nch, float4* buf, const Ray* ray,
                               const bool* on, float* bt, int* bs) {
  if (nch > 0) copy_window(buf, recs, min(row0, n_rows - kChunkRows));
  for (int b = 0; b < nch; ++b) {
    if (b + 1 < nch) {
      copy_window(buf + ((b + 1) & 1) * kWinUsedF4, recs,
                  min(row0 + (b + 1) * kChunkRows, n_rows - kChunkRows));
      cp_async_wait<1>();  // window b's group is complete, b + 1's flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's part of window b has landed
    const int row = min(row0 + b * kChunkRows, n_rows - kChunkRows);
    dense_window<RPT, false, false, kUsedF4, kMaxThreads>(
        buf + (b & 1) * kWinUsedF4, ray, on, 0xffffffffu, (long long)row * 8,
        bt, bs);
    __syncthreads();  // every thread is done with it before its reuse
  }
}

}  // namespace clpt
