// The kd-tree walks' device functions, shared by the stream kernel K3/K4
// (packet_stream.cu), the queue kernel K5 (packet_queue.cu), the v1
// kernels K6a, K6b and K9 (packet_v1.cu), the half-split kernel K7
// (packet_stream2.cu) and the plane-form kernel K8 (packet_mxu.cu): one
// copy, so every walk rounds every interval as the others and as the plain
// torch versions do (clpathtracer_tpu_torch/ops/packet.py::_walk_tile,
// _queue_tile, _binary_v1_walk, _wide_v1_walk, _stream2_tile and
// ops/packet_mxu.py::_mxu_tile).
//
// A walk is cluster-uniform: every block of a tile's cluster (one block for
// the tiles that do not split into 8 slices of whole warps) runs the same
// walk on its own stack in shared memory, from the same reads and from the
// values reduced over the whole cluster (cluster.cuh::cluster_reduce):
// every thread computes the same pops, interval tests and window
// decisions; thread 0 writes the block's stack and barriers order its
// reads and writes.
//
//   packet bounds: per axis the origin range and the clipped inverse-
//     direction range over the tile's active lanes
//     (clpathtracer_tpu/ops/packet.py::_packet_bounds_masked), reduced over
//     the cluster (cluster_bounds); with half_lanes, over one half of the
//     tile (K7's half split);
//   box_interval: the packet-conservative [t_enter, t_exit] of an AABB
//     (_box_interval);
//   split_interval: the crossing of one split plane (_split_plane_interval);
//   window_keeps: the AABB window cull, [ltlo, min(lthi, t_upper)] against
//     the window's box interval;
//   precedes, dense_split: the window's tie rule as a total order
//     (_mt_chunk_math's: within a window the least t, among equal t the
//     lowest row of 8 records and within it the highest record; the later
//     window wins at equal t), and the dense MT test of a staged window
//     with kS threads a lane whose winners merge by it (K3, K5, K6b, K7,
//     K9);
//   ring_stream, ring_windows: a leaf's staged buffers through a ring of
//     kRing cp.async copies (K6a, K6b, K7, K8, K9), the windows on the
//     clamped grid each tested by dense_split;
//   load_rays, push_root, push_children, store_tile: the frame of a
//     walk around them (kS threads a lane, kC blocks a tile);
//   cluster_bounds, cluster_t_upper: the packet bounds and t_upper
//     reduced over a cluster (cluster.cuh::cluster_reduce);
//   cp_async16, cp_async4, cp_async_commit, cp_async_wait, wait_pending:
//     cp.async copies into shared memory and their commit groups;
//   copy_recs, ring_smem: the list kernels' staging of a run of records
//     (K1, K2, K10 in plist_super.cu, K11 in plist_subgate.cu) and their
//     ring of two windows.
//
// The stack guard: a split whose two pushes could pass the kStack entries
// ends the walk instead (push_children returns -1 and writes nothing); the
// kernel then sets its overflow flag, which the wrapper raises on after
// the launch. The decision is cluster-uniform, so every block leaves the
// walk as a whole and the CUDA context stays usable.

#pragma once

#include <cmath>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "pair_tests.cuh"

namespace clpt {

constexpr int kStack = 128;          // stack entries (the TPU kernels')
constexpr int kChunkRows = 16;       // rows of 8 records per window
constexpr int kWinRecs = kChunkRows * 8;
constexpr int kRecF4 = 4;            // float4s per 16-float record
constexpr int kUsedF4 = 3;           // float4s staged per record (cols 0-11)
constexpr int kWinUsedF4 = kWinRecs * kUsedF4;
constexpr int kTupMask = 3;          // t_upper after a leaf on every 4th pop
constexpr int kRing = 4;             // buffers of a leaf's ring (ring_stream)
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

// Staging for the list kernels: n_recs records of `rows` (a float4 view of
// [S, 16]) from record rec0, cols 0-11, into `dst` with cp.async, this
// thread's share of the 16-byte copies (the whole block copies), then its
// commit group.
__device__ __forceinline__ void copy_recs(float4* dst,
                                          const float4* __restrict__ rows,
                                          long long rec0, int n_recs) {
  for (int i = threadIdx.x; i < n_recs * kUsedF4; i += blockDim.x)
    cp_async16(dst + i, rows + (rec0 + i / kUsedF4) * kRecF4 + i % kUsedF4);
  cp_async_commit();
}

// The list kernels' dynamic shared memory for a ring of two windows of
// win_rows * 8 staged records (K1, K2, K11).
inline size_t ring_smem(int win_rows) {
  return 2 * (size_t)win_rows * 8 * kUsedF4 * sizeof(float4);
}

__device__ __forceinline__ float clip_inv(float d) {
  return fminf(fmaxf(__frcp_rn(d), -kInvBig), kInvBig);
}

// The active flags of one half of the tile: lanes [0, tile / 2) (right =
// false) or [tile / 2, tile) (right = true). lane0: the tile's lane of this
// thread's first ray (its block's first lane, cluster rank x tile / kC,
// plus the thread's lane in the block); lanes k * lpt apart.
template <int RPT>
__device__ __forceinline__ void half_lanes(const bool* on, int tile,
                                           int lane0, int lpt, bool right,
                                           bool* out) {
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    out[k] = on[k] && ((lane0 + k * lpt >= tile / 2) == right);
}

// This thread's rays of the block's lanes from `base` (lane tid / kS +
// k * blockDim.x / kS: kS neighbouring threads share a lane) from the
// [3, n_rays] tile-major arrays, their active flags (all active when act is
// null), and empty winners.
template <int RPT, int kS = 1>
__device__ __forceinline__ void load_rays(const float* orig_t,
                                          const float* dir_t,
                                          const float* act, int n_rays,
                                          size_t base, Ray* ray, bool* on,
                                          float* bt, int* bs) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t g = base + threadIdx.x / kS + k * (blockDim.x / kS);
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

// The winners (slot -1 on a miss; the first thread of each lane's kS
// writes) and the tile's stats row (thread 0 of the first of the tile's
// kC blocks: 1-D clusters of consecutive blocks).
template <int RPT, int kS = 1, int kC = 1>
__device__ __forceinline__ void store_tile(const float* bt, const int* bs,
                                           size_t base, float* best_t,
                                           int* best_slot, int* stats,
                                           int nv, int nl, int n_act, int nc,
                                           int lane4) {
  if (threadIdx.x % kS == 0) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const size_t g = base + threadIdx.x / kS + k * (blockDim.x / kS);
      best_t[g] = bt[k];
      best_slot[g] = bt[k] < kBig ? bs[k] : -1;
    }
  }
  if (threadIdx.x == 0 && blockIdx.x % kC == 0) {
    int* st = stats + 5 * (size_t)(blockIdx.x / kC);
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

// The packet bounds of the whole tile over its active lanes `on` (K7: one
// half's; a block without such a lane gives the identities)
// (_packet_bounds_masked), reduced over the cluster, into B (thread 0
// writes); returns the tile's active lanes, counted on the threads where
// `counts` (one thread of each lane's kS). Its last barrier publishes B.
template <int RPT>
__device__ __forceinline__ int cluster_bounds(const Ray* ray, const bool* on,
                                              bool counts, Bounds& B,
                                              ClusterSlots<12>& sb,
                                              int& par_b, ClusterSlots<1>& s1,
                                              int& par1) {
  float v[12];  // per axis: ol, -oh, il, -ih; all reduced by min
  float n_on = 0.f;  // the lanes of this thread that `counts` (one share)
#pragma unroll
  for (int k = 0; k < RPT; ++k) n_on += counts && on[k] ? 1.f : 0.f;
#pragma unroll
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
    v[ax] = ol;
    v[3 + ax] = -oh;
    v[6 + ax] = il;
    v[9 + ax] = -ih;
  }
  cluster_reduce<12>(v, sb, par_b, MinOp(), INFINITY);
  if (threadIdx.x == 0) {
    for (int ax = 0; ax < 3; ++ax) {
      B.ol[ax] = v[ax];
      B.oh[ax] = -v[3 + ax];
      B.il[ax] = v[6 + ax];
      B.ih[ax] = -v[9 + ax];
    }
  }
  cluster_reduce<1>(&n_on, s1, par1, SumOp(), 0.f);
  return (int)n_on;
}

// t_upper: the largest best t over the tile's active lanes (-kBig when
// none), reduced over the cluster. Its cluster barrier also orders every
// thread's reads of the block's shared memory before it against the
// writes after it.
template <int RPT>
__device__ __forceinline__ float cluster_t_upper(const float* bt,
                                                 const bool* on,
                                                 ClusterSlots<1>& s1,
                                                 int& par1) {
  float m = -kBig;
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (on[k]) m = fmaxf(m, bt[k]);
  cluster_reduce<1>(&m, s1, par1, MaxOp(), -INFINITY);
  return m;
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

// Whether (t2, r2) precedes (t, r) in a window's tie rule: the least t,
// among equal t the lowest row of 8 records, within it the highest record.
__device__ __forceinline__ bool precedes(float t2, int r2, float t, int r) {
  const int row2 = r2 >> 3, row = r >> 3;
  return t2 < t || (t2 == t && (row2 < row || (row2 == row && r2 > r)));
}

// The dense MT (or SO, or bf16) test of one staged window (kWinRecs
// records, cols 0-11) against this thread's rays, kS threads a lane: the
// kS threads of a lane are neighbours in a warp, and share h tests records
// h, h + kS, ... of the window (neighbouring records for neighbouring
// threads: distinct shared-memory banks). Each share's winner under the
// window's rule is the rule's least of its records, so the shares merge by
// `precedes` (warp shuffles) into the window's winner, which then meets the
// earlier windows' where t <= the best so far (the later window wins at
// equal t); every thread of the lane holds the result. Records staged kUsedF4 float4s
// apart. lane0: the block's lane of this thread's first ray; lanes k * lpt
// apart; a lane whose gate bit (gates >> (lane / kGate)) is clear is
// skipped.
template <int RPT, int kS, bool kSO, bool kBF16, int kGate>
__device__ __forceinline__ void dense_split(const float4* win, const Ray* ray,
                                            const bool* on, unsigned gates,
                                            int lane0, int lpt,
                                            long long rec0, float* bt,
                                            int* bs) {
  const int h = threadIdx.x % kS;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const bool test =
        on[k] && ((gates >> ((lane0 + k * lpt) / kGate)) & 1u);
    float ct = kBig;
    int cr = -1;  // record of ct within the window
    if (test) {
      for (int r = h; r < kWinRecs; r += kS) {
        const float4 p = win[r * kUsedF4];
        const float4 q = win[r * kUsedF4 + 1];
        const float4 w = win[r * kUsedF4 + 2];
        float t;
        const bool hit = kSO     ? so_hit(ray[k], p, q, w, &t)
                         : kBF16 ? mt_hit_bf16(ray[k], p, q, w, &t)
                                 : mt_hit(ray[k], p, q, w, &t);
        if (hit && t < kBig &&
            (t < ct || (t == ct && (r >> 3) == (cr >> 3)))) {
          ct = t;
          cr = r;
        }
      }
    }
#pragma unroll
    for (int off = 1; off < kS; off <<= 1) {
      const float t2 = __shfl_xor_sync(0xffffffffu, ct, off);
      const int r2 = __shfl_xor_sync(0xffffffffu, cr, off);
      if (precedes(t2, r2, ct, cr)) {
        ct = t2;
        cr = r2;
      }
    }
    if (test && ct < kBig && ct <= bt[k]) {  // the later window wins ties
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

// A leaf's nch staged buffers of `stride` float4s through a ring of kRing
// in shared memory (K6a, K6b, K7, K8, K9): kRing - 1 copies in flight
// while one is tested, one commit group per buffer and thread (each thread
// waits until at most min(kRing - 2, buffers left after this one) of its
// groups are pending), one barrier per buffer. copy(b, dst) starts buffer
// b's copies into dst and commits them; test(b, src) tests it. nch = 0
// starts no copy. Every thread of the block calls it (block-uniform); its
// barriers are the block's own, so a block of a cluster that has nothing
// to test may skip it. The caller puts a barrier between the last test and
// the next leaf's copies (the next pop's, or a t_upper refresh's).
template <class Copy, class Test>
__device__ __forceinline__ void ring_stream(int nch, float4* ring, int stride,
                                            Copy copy, Test test) {
  for (int b = 0; b < kRing - 1 && b < nch; ++b) copy(b, ring + b * stride);
  for (int b = 0; b < nch; ++b) {
    wait_pending(min(kRing - 2, nch - 1 - b));  // this thread's buffer b
    __syncthreads();  // buffer b has landed; buffer b - 1 is tested
    if (b + kRing - 1 < nch)  // into b - 1's buffer
      copy(b + kRing - 1, ring + ((b + kRing - 1) % kRing) * stride);
    test(b, ring + (b % kRing) * stride);
  }
}

// A leaf's nch windows on the clamped grid, rows row0 + 16 b clamped to
// last_row (n_rows - 16), through the ring (kRing * kWinUsedF4 float4s),
// each tested by dense_split with kS threads a lane, one ray a thread: the
// window's tie rule, the later window winning at equal t (K6b, K7, K9).
// `on`: the lanes that test.
template <int kS>
__device__ __forceinline__ void ring_windows(const float4* recs, int last_row,
                                             int row0, int nch, float4* ring,
                                             const Ray* ray, const bool* on,
                                             int lane0, int lpt, float* bt,
                                             int* bs) {
  ring_stream(
      nch, ring, kWinUsedF4,
      [&](int b, float4* dst) {
        copy_window(dst, recs, min(row0 + b * kChunkRows, last_row));
      },
      [&](int b, const float4* win) {
        dense_split<1, kS, false, false, kMaxThreads>(
            win, ray, on, 0xffffffffu, lane0, lpt,
            (long long)min(row0 + b * kChunkRows, last_row) * 8, bt, bs);
      });
}

}  // namespace clpt
