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
// windows culled, dense executions). A split whose pushes could pass the
// 128-entry stack ends the walk and sets the overflow flag (kd_walk.cuh),
// which the wrapper raises on.
//
// Tie rule, that of clpathtracer_tpu/ops/packet.py::_mt_chunk_math: within
// a window the least t wins, among equal t the lowest row of 8 records, and
// within that row the highest record; across windows the later window wins
// at equal t. The plain torch version (ops/packet.py::
// packet_stream_reference) applies the same rule and the same rounding
// (__f*_rn, --fmad=false), so both agree exactly in t, slot and stats.
//
// Design: a tile that is a multiple of 256 rays runs on a thread-block
// cluster of kCluster = 8 blocks (cluster.cuh), each block an eighth of the
// tile's lanes (256 at tile 2048, 64 at tile 512; tile 4096 gives a thread
// two of them); a smaller tile runs on one block. In the f32 forms each
// lane has kStreamSplit = 2 neighbouring threads, each testing every other
// record of a window; their winners merge by the window's tie rule, a total
// order (precedes), before the window's winner meets the earlier windows'
// (dense_split). K4 keeps one thread a lane: its bf16 test needs more
// registers than two threads a lane leave it. Every block runs the same
// walk (kd_walk.cuh's device functions, shared with K5-K9; the stack in the
// block's own shared memory): the packet bounds, the active count and
// t_upper are reduced over the whole cluster (cluster_reduce), so every
// block pops the same nodes, keeps the same windows and counts the same
// stats as one block over the whole tile; rank 0 writes the stats row. In
// half-gate strips mode a block's lanes lie in one 512-lane gate, so its
// gate bits are the tile's shifted by its gate. A kept window's 128 records
// (cols 0-11) are staged with cp.async in a ring of two 6 KB buffers:
// t_upper is fixed within a leaf, so the next kept window of the leaf is
// known, and its copy flies while the current one is tested; one barrier
// per window. Every thread reads each record as a broadcast (a warp reads
// two neighbouring records, in distinct banks).
//
// What bounds it on this card: FP32 issue in the dense test (22 operations
// per SO pair, 15-53 per MT pair by its early exit), as K1; a warp issues a
// record to its deepest lane's exit. On one block a 2048-ray tile ran on
// one SM, and a mirror wave took as long as its heaviest tile (8,725
// windows on the 1M terrain, every window of the tree); on a cluster it
// runs on 8 SMs with 16 warps each (the f32 forms held to 64 registers, two
// 512-thread blocks an SM), so the launch moves toward its total work at
// the rate the pair tests issue. The walk's barriers and node reads stay
// serial per tile, repeated by every block of the cluster; they set the
// time of the normal frames' short walks. K4 adds a bf16 rounding after
// each of its FP32 operations, as the preview's semantics ask; it is a port
// of the preview's results, not a speed-up on this card.

#include <climits>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

constexpr int kGateLanes = 512;      // lanes per gate in half-gate mode
constexpr int kCluster = 8;          // blocks per tile (tiles of 256k rays)

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
  int* overflow;           // [1], set to 1 when a walk's stack overflows
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

// The packet bounds of the whole tile over its active lanes
// (_packet_bounds_masked), reduced over the cluster, into B (thread 0
// writes); returns the tile's active lanes. Its last barrier publishes B.
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
// none), reduced over the cluster.
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

// The first window of the leaf at or after b that the tile streams (nwin
// when none).
__device__ __forceinline__ int next_kept(const Args& a, const Bounds& B,
                                         int tile_i, int win0, int b,
                                         int nwin, float tlo, float thi,
                                         float t_upper) {
  while (b < nwin && !survives(a, B, tile_i, win0 + b, tlo, thi, t_upper))
    ++b;
  return b;
}

// Whether (t2, r2) precedes (t, r) in a window's tie rule: the least t,
// among equal t the lowest row of 8 records, within it the highest record.
__device__ __forceinline__ bool precedes(float t2, int r2, float t, int r) {
  const int row2 = r2 >> 3, row = r >> 3;
  return t2 < t || (t2 == t && (row2 < row || (row2 == row && r2 > r)));
}

// dense_window (kd_walk.cuh) with kS threads a lane: the kS threads of a
// lane are neighbours in a warp, and share h tests records h, h + kS, ...
// of the window (neighbouring records for neighbouring threads: distinct
// shared-memory banks). Each share's winner under the window's rule is the
// rule's least of its records, so the shares merge by `precedes` (warp
// shuffles) into the window's winner, which then meets the earlier
// windows' as in dense_window (the later window wins at equal t). lane0:
// the block's lane of this thread's first ray; lanes k * lpt apart.
template <int RPT, int kS, bool kSO, bool kBF16>
__device__ __forceinline__ void dense_split(const float4* win, const Ray* ray,
                                            const bool* on, unsigned gates,
                                            int lane0, int lpt,
                                            long long rec0, float* bt,
                                            int* bs) {
  const int h = threadIdx.x % kS;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const bool test =
        on[k] && ((gates >> ((lane0 + k * lpt) / kGateLanes)) & 1u);
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

// kC blocks per tile (a cluster), each owning tile / kC consecutive lanes,
// RPT of them per group of kS neighbouring threads (lane rank * tile / kC +
// tid / kS + k * threads / kS), each thread of a group a kS-th of every
// window's records (dense_split).
// kBF16: the bf16 preview (K4; MT records, modes kNoCull and kCull): the
// window's records and the rays are rounded to bf16 once, where they are
// staged and loaded, and the dense test is mt_hit_bf16; the walk, t_upper,
// the slots and the merge stay f32 / int32, and stats lane 4 is 0 as the
// TPU kernel writes it. The f32 forms are held to 64 registers, so that
// 1024 threads (two 512-thread blocks, or one of 1024) fit an SM; K4's bf16
// test runs faster with its own register count.
template <int kC, int RPT, int kS, bool kSO, bool kBF16>
__global__ void __launch_bounds__(kMaxThreads * kS,
                                  kS == 1 && !kBF16 ? 2 : 1)
packet_stream_kernel(const Args a) {
  __shared__ float4 win[2 * kWinUsedF4];  // a ring of two windows
  __shared__ int s_node[kStack];
  __shared__ float s_tlo[kStack], s_thi[kStack];
  __shared__ ClusterSlots<12> sb;
  __shared__ ClusterSlots<1> s1;
  __shared__ Bounds B;

  const int rank = cluster_rank();
  const int tile_i = blockIdx.x / kC;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lanes = a.tile / kC;
  const size_t base = (size_t)tile_i * a.tile + (size_t)rank * lanes;
  const bool half = a.mode == kStrips && a.tile / a.n_strips == kGateLanes;
  // the strip gate of this block's lanes: in half-gate mode (tiles of
  // 512n rays, n = 1, 2, 4, 8, on 8 blocks) they lie inside one gate
  const int gate0 = rank * lanes / kGateLanes;

  const int lpt = nthr / kS;      // lanes a step k of the block's threads
  const int lane0 = tid / kS;     // the block's lane of this thread's ray 0

  Ray ray[RPT];
  bool on[RPT];
  float bt[RPT];
  int bs[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const size_t g = base + lane0 + k * lpt;
    ray[k].ox = a.orig_t[g];
    ray[k].oy = a.orig_t[a.n_rays + g];
    ray[k].oz = a.orig_t[2 * (size_t)a.n_rays + g];
    ray[k].dx = a.dir_t[g];
    ray[k].dy = a.dir_t[a.n_rays + g];
    ray[k].dz = a.dir_t[2 * (size_t)a.n_rays + g];
    on[k] = a.act == nullptr || a.act[g] > 0.f;
    bt[k] = kBig;
    bs[k] = -1;
  }

  int par_b = 0, par1 = 0;
  const int n_act = cluster_bounds<RPT>(ray, on, tid % kS == 0, B, sb, par_b,
                                        s1, par1);
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
  int cur = 0;  // the ring's buffer of the next window tested
  bool overflow = false;
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
      int b = next_kept(a, B, tile_i, win0, 0, nwin, tlo, thi, t_upper);
      if (b < nwin)
        copy_window(win + cur * kWinUsedF4, a.rows,
                    min(r0 + b * kChunkRows, a.n_rows - kChunkRows));
      while (b < nwin) {
        // t_upper is fixed within the leaf, so the next kept window is
        // known now: its copy flies while window b is tested
        const int nb = next_kept(a, B, tile_i, win0, b + 1, nwin, tlo, thi,
                                 t_upper);
        float4* w = win + cur * kWinUsedF4;
        cp_async_wait<0>();
        if (kBF16) {  // round the elements this thread copied
          for (int i = tid; i < kWinUsedF4; i += nthr) {
            const float4 v = w[i];
            w[i] = make_float4(bf(v.x), bf(v.y), bf(v.z), bf(v.w));
          }
        }
        __syncthreads();  // window b has landed; the other buffer is free
        if (nb < nwin)
          copy_window(win + (cur ^ 1) * kWinUsedF4, a.rows,
                      min(r0 + nb * kChunkRows, a.n_rows - kChunkRows));
        const int row = min(r0 + b * kChunkRows, a.n_rows - kChunkRows);
        unsigned gates = 0xffffffffu;
        if (half) {
          gates = (unsigned)a.masks[(size_t)tile_i * a.n_windows + win0 + b]
                  & ((1u << a.n_strips) - 1u);
          nsm += __popc(gates);
          gates >>= gate0;
        } else {
          ++nsm;
        }
        dense_split<RPT, kS, kSO, kBF16>(w, ray, on, gates, lane0, lpt,
                                         (long long)row * 8, bt, bs);
        cur ^= 1;
        ++streamed;
        b = nb;
      }
      nl += streamed;
      if (a.mode != kNoCull) nc += nwin - streamed;
      if ((nv & kTupMask) == 0)
        t_upper = cluster_t_upper<RPT>(bt, on, s1, par1);
    } else {  // split: far child first, then the near child
      sp = push_children(B, nd, a.nodes_f[6 + node], tlo, thi, t_upper, sp,
                         s_node, s_tlo, s_thi);
      if (sp < 0) {
        overflow = true;
        break;
      }
    }
  }
  if (overflow && rank == 0 && tid == 0) *a.overflow = 1;

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (tid % kS) break;  // every thread of a group holds its lane's winner
    const size_t g = base + lane0 + k * lpt;
    a.best_t[g] = bt[k];
    a.best_slot[g] = bt[k] < kBig ? bs[k] : -1;
  }
  if (rank == 0 && tid == 0) {
    int* st = a.stats + 5 * (size_t)tile_i;
    st[0] = nv;
    st[1] = nl;
    st[2] = n_act;
    st[3] = nc;
    st[4] = kBF16 ? 0 : nsm;
  }
  cluster_end();
}

using StreamKernel = void (*)(const Args);

// Threads a lane: K3's cluster forms kStreamSplit, K4 and one-block tiles 1.
constexpr int kStreamSplit = 2;

// The instance for clusters of c blocks of rpt rays a group of threads, or
// null.
StreamKernel stream_kernel(int c, int rpt, bool so, bool bf16) {
  constexpr int S = kStreamSplit;
  if (c == kCluster && rpt == 1)
    return bf16 ? packet_stream_kernel<kCluster, 1, 1, false, true>
           : so ? packet_stream_kernel<kCluster, 1, S, true, false>
                : packet_stream_kernel<kCluster, 1, S, false, false>;
  if (c == kCluster && rpt == 2)
    return bf16 ? packet_stream_kernel<kCluster, 2, 1, false, true>
           : so ? packet_stream_kernel<kCluster, 2, S, true, false>
                : packet_stream_kernel<kCluster, 2, S, false, false>;
  if (c == 1 && rpt == 1)
    return bf16 ? packet_stream_kernel<1, 1, 1, false, true>
           : so ? packet_stream_kernel<1, 1, 1, true, false>
                : packet_stream_kernel<1, 1, 1, false, false>;
  return nullptr;
}

// The launch shape of a tile: blocks per cluster (kCluster when the tile
// splits into kCluster slices of whole warps, else 1), rays per group of
// threads and threads per block; the kernel instance, null for a tile it
// does not take (tiles above 512 must be 1024, 2048 or 4096, so that a
// block's lanes lie inside one 512-lane strip gate).
StreamKernel stream_shape(int tile, bool so, bool bf16, int* c,
                          int* threads) {
  const int big = tile / kMaxThreads;
  if (tile > kMaxThreads && (tile % kMaxThreads || (big & (big - 1))))
    return nullptr;
  *c = tile % (32 * kCluster) == 0 ? kCluster : 1;
  const int lanes = tile / *c;
  const int split = *c > 1 && !bf16 ? kStreamSplit : 1;
  const int rpt = (lanes + kMaxThreads - 1) / kMaxThreads;
  *threads = lanes / rpt * split;
  return stream_kernel(*c, rpt, so, bf16);
}

}  // namespace

// K3, and K4's bf16 preview when bf16 != 0 (MT records, modes 0 and 1).
// nodes_i: [M, 4] i32; nodes_f: [6 + M] f32; rows: [n_rows * 8, 16] f32
// records (SO rows when so != 0, else raw (v0, e1, e2, tri_id)); orig_t,
// dir_t: [3, n_rays] f32 tile-major; act: [n_rays] f32; cbnd: [W, 6] f32
// (modes 1, 2); frustum: [n_rays / tile, 16] f32 (mode 2); masks, ten:
// [n_rays / tile, W] i32 / f32 (mode 3). Outputs best_t [n_rays] f32,
// best_slot [n_rays] i32 (-1 on a miss), stats [n_rays / tile, 5] i32, and
// overflow [1] i32 (zeroed by the caller; set to 1 when a stack overflows).
// tile: a multiple of 32 up to 512, or 1024, 2048 or 4096; a tile that is a
// multiple of 256 runs as a cluster of 8 blocks, each an eighth of its
// lanes, a smaller one as one block. Returns the launch's error, else
// cudaGetLastError().
extern "C" int packet_stream_launch(
    const void* nodes_i, const void* nodes_f, const void* rows,
    const void* orig_t, const void* dir_t, const void* act, const void* cbnd,
    const void* frustum, const void* masks, const void* ten, void* best_t,
    void* best_slot, void* stats, void* overflow, int n_rays, int tile,
    int n_rows,
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
  a.overflow = static_cast<int*>(overflow);
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
  int c, threads;
  const StreamKernel kernel = stream_shape(tile, so != 0, bf16 != 0, &c,
                                           &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return launch_cluster(kernel, c, n_rays / tile * c, threads, 0,
                        static_cast<cudaStream_t>(stream), a);
}

// The shape of K3's (bf16 == 0) or K4's cluster launch at `tile`, as
// clpt::cluster_shape writes it into out[6]: blocks per cluster, threads
// per block, the clusters resident at once, registers per thread, static
// and dynamic shared memory bytes per block. Returns a CUDA error or 0.
extern "C" int packet_stream_shape(int tile, int so, int bf16, int* out) {
  int c, threads;
  const StreamKernel kernel = stream_shape(tile, so != 0, bf16 != 0, &c,
                                           &threads);
  if (kernel == nullptr || tile <= 0 || tile % 32 || tile > 8 * kMaxThreads)
    return (int)cudaErrorInvalidValue;
  return cluster_shape(kernel, c, threads, 0, out);
}
