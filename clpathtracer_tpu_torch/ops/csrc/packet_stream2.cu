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
//     with the active mask, kd_walk.cuh::dense_split) runs for the lanes of
//     the live halves only; no window is culled;
//   t_upper: after a leaf's last chunk, when the pop count is a multiple of
//     4, each live half takes the largest best t over its active lanes; an
//     empty leaf (no chunk) refreshes nothing.
// Stats per tile: node pops, chunks, the tile's active lanes, 0, 0. Tie
// rule: the window's (_mt_chunk_math's, kd_walk.cuh::precedes). The TPU
// program steps two tiles' machines in turn; the machines share nothing,
// so here each tile is walked on its own (a cluster or a block). The plain torch version (ops/packet.py::packet_stream2_reference)
// replays the same walk with the same rounding (__f*_rn, --fmad=false) and
// agrees exactly in t, slot and stats.
//
// Design: K6b's cluster walk (packet_v1.cu). A tile that is a multiple of
// 256 rays runs on a thread-block cluster of kCluster = 8 blocks
// (cluster.cuh), each block an eighth of the tile's lanes (256 at tile
// 2048, 64 at tile 512, 512 at tile 4096) with kSplit = 2 neighbouring
// threads a lane, each testing every other record of a staged chunk; so
// blocks 0-3 hold the left half and blocks 4-7 the right half, and no
// block straddles the two (half_lanes maps a lane through the block's
// cluster rank). A smaller tile, or one that is not a multiple of 256,
// runs on one block with one thread a lane. Every block runs the same walk
// on its own stack in shared memory (128 entries of node, t_lo and t_hi
// left, t_lo and t_hi right; thread 0 writes, barriers order the reads);
// each half's packet bounds and active count (cluster_bounds, the other
// half's blocks giving the identities) and both halves' t_upper at a
// refresh (one cluster_reduce of two maxima) are reduced over the whole
// cluster, so every block pops the same nodes, takes the same halves live
// and takes the stack guard's decision alike; rank 0 writes the stats row,
// and the last cluster barrier keeps every block until its peers have read
// its shared memory. A leaf's chunks (cols 0-11 of 128 records, 6 KB) go
// through K6b's ring of 4 buffers with cp.async (kd_walk.cuh::ring_windows:
// three copies in flight while one is tested, dense_split's two shares a
// lane merged by the window's tie rule). A block whose lanes the leaf does
// not test (its half not live at the pop, or no active lane of its half)
// skips the leaf's copies and tests: the ring's barriers are the block's
// own, and the next cluster barrier (a t_upper refresh) is reached by
// every block alike.
//
// What bounds it on this card: FP32 issue in the dense MT test (15-53
// operations per pair by its early exit), as K3; the half split removes a
// half's lanes from a chunk's test when that half has left the node, but
// culls no window, so a tile streams every chunk of every leaf either half
// reaches. On one block a 2048-ray tile ran on one SM, and a mirror wave
// took as long as its heaviest tile; on a cluster it runs on 8 SMs (4 a
// half), so the launch moves toward its total work at the rate the pair
// tests issue. The walk's barriers and node reads stay serial per tile,
// repeated by every block of the cluster.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

constexpr int kCluster = 8;  // blocks per tile (tiles of 256k rays)
constexpr int kSplit = 2;    // threads a lane on a cluster

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

// kC blocks per tile (a cluster), each owning tile / kC consecutive lanes,
// one per group of kS neighbouring threads (lane rank * tile / kC +
// tid / kS).
template <int kC, int kS>
__global__ void __launch_bounds__(kMaxThreads * kS, kS == 1 ? 2 : 1)
packet_stream2_kernel(const S2Args a) {
  __shared__ float4 ring[kRing * kWinUsedF4];
  __shared__ int s_node[kStack];
  __shared__ float s_tlo_l[kStack], s_thi_l[kStack];
  __shared__ float s_tlo_r[kStack], s_thi_r[kStack];
  __shared__ ClusterSlots<12> sb;
  __shared__ ClusterSlots<2> s2;
  __shared__ ClusterSlots<1> s1;
  __shared__ Bounds BL, BR;

  const int rank = cluster_rank();
  const int tid = threadIdx.x;
  const int lanes = a.tile / kC;
  const size_t base = (size_t)(blockIdx.x / kC) * a.tile +
                      (size_t)rank * lanes;
  const int lpt = blockDim.x / kS;  // lanes of the block
  const int lane0 = tid / kS;       // the block's lane of this thread

  Ray ray[1];
  bool on[1], on_l[1], on_r[1], go[1];
  float bt[1];
  int bs[1];
  load_rays<1, kS>(a.orig_t, a.dir_t, a.act, a.n_rays, base, ray, on, bt,
                   bs);
  half_lanes<1>(on, a.tile, rank * lanes + lane0, lpt, false, on_l);
  half_lanes<1>(on, a.tile, rank * lanes + lane0, lpt, true, on_r);
  int par_b = 0, par1 = 0, par2 = 0;
  const bool counts = tid % kS == 0;
  const int n_l = cluster_bounds<1>(ray, on_l, counts, BL, sb, par_b, s1,
                                    par1);
  const int n_r = cluster_bounds<1>(ray, on_r, counts, BR, sb, par_b, s1,
                                    par1);
  // whether this block has an active lane of each half
  const bool has_l = __syncthreads_or(on_l[0]);
  const bool has_r = __syncthreads_or(on_r[0]);

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
      go[0] = (live_l && on_l[0]) || (live_r && on_r[0]);
      if ((live_l && has_l) || (live_r && has_r))
        ring_windows<kS>(a.rows, a.n_rows - kChunkRows, nd.y, nch, ring, ray,
                         go, lane0, lpt, bt, bs);
      if ((nv & kTupMask) == 0) {  // each live half's t_upper
        float m[2] = {on_l[0] ? bt[0] : -kBig, on_r[0] ? bt[0] : -kBig};
        cluster_reduce<2>(m, s2, par2, MaxOp(), -INFINITY);
        if (live_l) tu_l = m[0];
        if (live_r) tu_r = m[1];
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
  if (overflow && rank == 0 && tid == 0) *a.overflow = 1;
  // every thread of a group holds its lane's winner
  store_tile<1, kS, kC>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl,
                        n_l + n_r, 0, 0);
  cluster_end();
}

using Stream2Kernel = void (*)(const S2Args);

// The launch shape of K7 at `tile`: blocks per cluster (kCluster when the
// tile is a multiple of 32 * kCluster, so that each block's lanes are whole
// warps and lie in one half; else 1) and threads per block (kSplit a lane
// on a cluster, one a lane on one block); the kernel instance, null for a
// tile it does not take (a multiple of 32 up to 4096, and up to 512 on one
// block). K6b's rule (packet_v1.cu::v1_shape).
Stream2Kernel stream2_shape(int tile, int* c, int* threads) {
  if (tile <= 0 || tile % 32 || tile > kCluster * kMaxThreads)
    return nullptr;
  if (tile % (32 * kCluster) == 0) {
    *c = kCluster;
    *threads = tile / kCluster * kSplit;
    return packet_stream2_kernel<kCluster, kSplit>;
  }
  if (tile > kMaxThreads) return nullptr;
  *c = 1;
  *threads = tile;
  return packet_stream2_kernel<1, 1>;
}

}  // namespace

// K7. nodes_i: [M, 4] i32 (ops/packet.py::stream2_nodes); nodes_f: [6 + M]
// f32; rows: [n_rows * 8, 16] f32 records (v0, e1, e2, tri_id), 16-byte
// aligned; orig_t, dir_t: [3, n_rays] f32 tile-major; act: [n_rays] f32.
// Outputs best_t [n_rays] f32, best_slot [n_rays] i32 (-1 on a miss), stats
// [n_rays / tile, 5] i32, and overflow [1] i32 (zeroed by the caller; set to
// 1 when a stack overflows). tile: a multiple of 32 up to 4096; a multiple
// of 256 runs as a cluster of 8 blocks, each an eighth of its lanes, a
// smaller one (up to 512) as one block. Returns the launch's error, else
// cudaGetLastError(): a refused cluster launch shows there.
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
  if (tile <= 0 || n_rays % tile || n_rows < kChunkRows ||
      reinterpret_cast<size_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;
  int c, threads;
  const Stream2Kernel kernel = stream2_shape(tile, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  return launch_cluster(kernel, c, n_rays / tile * c, threads, 0,
                        static_cast<cudaStream_t>(stream), a);
}

// The shape of K7's launch at `tile`, as clpt::cluster_shape writes it into
// out[6]: blocks per cluster, threads per block, the clusters resident at
// once, registers per thread, static and dynamic shared memory bytes per
// block. Returns a CUDA error or 0 (cudaErrorInvalidValue for a tile the
// kernel does not take).
extern "C" int packet_stream2_shape(int tile, int* out) {
  int c, threads;
  const Stream2Kernel kernel = stream2_shape(tile, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return cluster_shape(kernel, c, threads, 0, out);
}
