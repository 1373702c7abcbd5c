// K6a, K6b and K9: the v1 packet kernels for Hopper (sm_90a). Replace the
// TPU kernels of the JAX package's "legacy" and "wide" engines,
// clpathtracer_tpu/ops/packet.py::_kernel (K6a, the "vmem" engine: the whole
// scene resident), _kernel_tri_stream (K6b: the records streamed) and
// _kernel_wide (K9: the 8-wide supernode walk, CLPT_WIDE=1).
//
// What they compute, per packet tile of `tile` rays (every lane; there is no
// active mask): one stack walk for the whole tile, with a popped node's AABB
// tested against conservative bounds of all the tile's lanes (origin range
// and clipped inverse-direction range per axis, _packet_bounds); a node is
// live when t_enter <= t_exit, t_exit > 0 and t_enter <= t_upper. The stack
// holds node ids only (no intervals).
//   K6a / K6b walk the binary nodes of node_table[:, :16] (_binary_walk): a
//     live split pushes the far child, then the near one, the near child
//     being the low one when the packet's inverse-direction bounds on the
//     split axis sum to more than 0 (_near_far_children); a live leaf is
//     tested, and t_upper becomes the largest best t over the tile's lanes.
//     K6a tests the leaf's own records [4 q, 4 q + count) in order, 4 per
//     step from the resident array; a record is taken where it hits at
//     t <= best t, so the later record wins at equal t. K6b streams the
//     leaf's windows of 128 records, rows [r0 + 16 b, +16) with r0 =
//     4 q / 8, clamped to n_rows - 16, for b < ceil((ceil((4 q + count) /
//     8) - r0) / 16), none culled (_chunk_pipeline's stream_leaf), with
//     _mt_chunk_math's tie rule: within a window the least t, among equal t
//     the lowest row of 8 and within it the highest record; across windows
//     the later window wins at equal t (kd_walk.cuh::dense_window).
//   K9 walks supernodes of accel/wide.py's [S, 128] table: a pop tests its
//     8 child slots in order; a live internal child (kind 1) is pushed, a
//     live leaf (kind 2) streams its windows as K6b at once and refreshes
//     t_upper before the next slot is tested.
// Stats per tile: node pops (K9: supernode pops), leaves tested (K6a) or
// windows streamed (K6b, K9), then 0, 0, 0, as the TPU kernels write them.
// The plain torch versions (ops/packet.py::packet_legacy_reference,
// packet_wide_reference) replay the same walks with the same rounding
// (__f*_rn, --fmad=false; 1/x as __frcp_rn, clipped to +-1e30) and agree
// exactly in t, slot and stats.
//
// Design. K6a keeps its first schedule: one block per tile, tile/RPT
// threads of RPT rays each, and the block-uniform walk of kd_walk.cuh:
// every thread computes the same pops and interval tests from the same
// reads; thread 0 writes the stack in shared memory and barriers order its
// reads and writes. Its records are read straight from global memory, each
// a broadcast to every thread.
//
// K6b and K9 run as K3 does (packet_stream.cu). A tile that is a multiple
// of 256 rays runs on a thread-block cluster of kCluster = 8 blocks
// (cluster.cuh), each block an eighth of the tile's lanes (256 at tile
// 2048, 64 at tile 512, 512 at tile 4096) with kSplit = 2 neighbouring
// threads a lane, each testing every other record of a window; their
// winners merge by the window's tie rule, a total order, before they meet
// the earlier windows' winner (kd_walk.cuh::dense_split). A smaller tile,
// or one that is not a multiple of 256, runs on one block with one thread
// a lane. Every block runs the same walk on its own stack in shared
// memory; the packet bounds and every t_upper refresh are reduced over the
// whole cluster (cluster_bounds, cluster_t_upper), so every block pops the
// same nodes, tests the same supernode slots and streams the same windows,
// and the stack guard's decision is the same in every block; rank 0 writes
// the stats row, and the last cluster barrier keeps every block until its
// peers have read its shared memory. Nothing is culled, so all nch windows
// of a leaf are known when it is entered: they go through a ring of kRing
// = 4 buffers of 6 KB (cols 0-11 of 128 records) with cp.async, three in
// flight while one is tested, one commit group per window and thread (each
// thread waits until at most min(kRing - 2, windows left after this one)
// of its groups are pending), one barrier per window; no copy is asked
// beyond the leaf, since the next leaf depends on t_upper, and an empty
// leaf starts none. K9 stages a popped supernode's row (8 slots x 16 f32,
// 512 B) in shared memory once, instead of every thread reading it from
// global memory. The streamed forms are held to 64 registers, so that two
// 512-thread blocks fit an SM.
//
// What bounds them on this card: FP32 issue in the dense MT test (15-53
// operations per pair by its early exit). The walk culls no window and,
// while any lane misses, t_upper stays 3.4e38 and cuts nothing, so these
// kernels test far more pairs than K3 on the same tiles. On one block a
// tile ran on one SM with 16 warps, and a mirror wave took as long as its
// heaviest tile, which streams nearly every window of the tree; on a
// cluster it runs on 8 SMs, so the launch moves toward its total work at
// the rate the pair tests issue. The walk's barriers and node reads stay
// serial per tile, repeated by every block of the cluster.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

enum Engine { kResident = 0, kStream = 1, kWide = 2 };

constexpr int kCluster = 8;  // K6b, K9: blocks per tile (tiles of 256k rays)
constexpr int kSplit = 2;    // K6b, K9: threads a lane on a cluster
constexpr int kRing = 4;     // K6b, K9: windows of a leaf staged at once

struct V1Args {
  const float* table;      // K6a, K6b: [M, 16] binary nodes; K9: [S, 128]
  const float4* recs;      // [n_recs] records of 16 f32
  const float* orig_t;     // [3, n_rays]
  const float* dir_t;      // [3, n_rays]
  float* best_t;           // [n_rays]
  int* best_slot;          // [n_rays]
  int* stats;              // [n_tiles, 5]
  int* overflow;           // [1], set to 1 when a walk's stack overflows
  int n_rays, tile, n_recs;
};

// K6a's leaf: the records [4 qstart, 4 qstart + count) in order, 4 per step,
// from global memory; the later record wins at equal t.
template <int RPT>
__device__ void resident_leaf(const V1Args& a, int qstart, int count,
                              const Ray* ray, float* bt, int* bs) {
  const int first = qstart * 4;
  for (int q = 0; q < count; q += 4) {
    for (int j = 0; j < 4 && q + j < count; ++j) {
      const float4* r = a.recs + (size_t)(first + q + j) * kRecF4;
      const float4 p = __ldg(r), s = __ldg(r + 1), w = __ldg(r + 2);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        float t;
        if (mt_hit(ray[k], p, s, w, &t) && t <= bt[k]) {
          bt[k] = t;
          bs[k] = first + q + j;
        }
      }
    }
  }
}

// K6a: the binary walk with resident leaves, one block per tile.
template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
packet_v1_kernel(const V1Args a) {
  __shared__ int s_node[kStack];
  __shared__ float red[kMaxThreads / 32];
  __shared__ int ired[kMaxThreads / 32];
  __shared__ Bounds B;

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * a.tile;

  Ray ray[RPT];
  bool on[RPT];
  float bt[RPT];
  int bs[RPT];
  load_rays<RPT>(a.orig_t, a.dir_t, nullptr, a.n_rays, base, ray, on, bt, bs);
  packet_bounds<RPT>(ray, on, B, red, ired);  // over every lane
  if (tid == 0) s_node[0] = 0;
  __syncthreads();

  int sp = 1, nv = 0, nl = 0;
  bool overflow = false;
  float t_upper = kBig;
  while (sp > 0 && !overflow) {
    --sp;
    const int node = s_node[sp];
    __syncthreads();  // every thread has read slot sp before it is reused
    ++nv;
    const float* f = a.table + (size_t)node * 16;
    float t_en, t_ex;
    box_interval(f, f + 3, B, &t_en, &t_ex);
    if (!(t_en <= t_ex && t_ex > 0.f && t_en <= t_upper)) continue;
    const int flags = (int)f[7];
    if (flags >= 4) {  // leaf
      resident_leaf<RPT>(a, (int)f[10], (int)f[11], ray, bt, bs);
      ++nl;
      t_upper = tile_t_upper<RPT>(bt, on, red);
    } else {  // split: far child, then the near one on top
      if (sp + 2 > kStack) {
        overflow = true;
        break;
      }
      const int ax = flags & 3;
      const bool nlo = __fadd_rn(B.il[ax], B.ih[ax]) > 0.f;
      const int cl = (int)f[8], ch = (int)f[9];
      if (tid == 0) {
        s_node[sp] = nlo ? ch : cl;
        s_node[sp + 1] = nlo ? cl : ch;
      }
      sp += 2;
      __syncthreads();
    }
  }
  if (overflow && tid == 0) atomicExch(a.overflow, 1);
  store_tile<RPT>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl, 0, 0,
                  0);
}

// K6b's and K9's leaf at quad row qstart with `count` records: its windows,
// rows row0 + 16 b clamped to n_rows - 16 for b < nch, in order, through
// the ring of kRing buffers (kRing - 1 copies in flight; one commit group
// per window and thread), each tested by dense_split with kS threads a
// lane. Returns nch. Every thread of the cluster calls it (uniform). The
// caller's t_upper refresh after it is a cluster barrier, so every thread
// is done with the ring before the next leaf's copies.
template <int kS>
__device__ int ring_leaf(const V1Args& a, int qstart, int count,
                         float4* ring, const Ray* ray, const bool* on,
                         int lane0, int lpt, float* bt, int* bs) {
  const int first = qstart * 4;
  const int row0 = first / 8;
  const int nch = ((first + count + 7) / 8 - row0 + kChunkRows - 1) /
                  kChunkRows;
  const int last_row = a.n_recs / 8 - kChunkRows;
  for (int b = 0; b < kRing - 1 && b < nch; ++b)
    copy_window(ring + b * kWinUsedF4, a.recs,
                min(row0 + b * kChunkRows, last_row));
  for (int b = 0; b < nch; ++b) {
    wait_pending(min(kRing - 2, nch - 1 - b));  // this thread's window b
    __syncthreads();  // window b has landed; window b - 1 is tested
    const int nb = b + kRing - 1;  // into window b - 1's buffer
    if (nb < nch)
      copy_window(ring + (nb % kRing) * kWinUsedF4, a.recs,
                  min(row0 + nb * kChunkRows, last_row));
    const int row = min(row0 + b * kChunkRows, last_row);
    dense_split<1, kS, false, false, kMaxThreads>(
        ring + (b % kRing) * kWinUsedF4, ray, on, 0xffffffffu, lane0, lpt,
        (long long)row * 8, bt, bs);
  }
  return nch;
}

// K6b (kEngine kStream: the binary walk) and K9 (kWide: the supernode
// walk): kC blocks per tile (a cluster), each owning tile / kC consecutive
// lanes, one per group of kS neighbouring threads (lane rank * tile / kC +
// tid / kS).
template <int kC, int kS, int kEngine>
__global__ void __launch_bounds__(kMaxThreads * kS, kS == 1 ? 2 : 1)
packet_v1_cluster_kernel(const V1Args a) {
  __shared__ float4 ring[kRing * kWinUsedF4];
  __shared__ float4 s_row[kEngine == kWide ? 32 : 1];  // a supernode row
  __shared__ int s_node[kStack];
  __shared__ ClusterSlots<12> sb;
  __shared__ ClusterSlots<1> s1;
  __shared__ Bounds B;

  const int rank = cluster_rank();
  const int tid = threadIdx.x;
  const size_t base = (size_t)(blockIdx.x / kC) * a.tile +
                      (size_t)rank * (a.tile / kC);
  const int lpt = blockDim.x / kS;  // lanes of the block
  const int lane0 = tid / kS;       // the block's lane of this thread

  Ray ray[1];
  bool on[1];
  float bt[1];
  int bs[1];
  load_rays<1, kS>(a.orig_t, a.dir_t, nullptr, a.n_rays, base, ray, on, bt,
                   bs);
  int par_b = 0, par1 = 0;
  cluster_bounds<1>(ray, on, tid % kS == 0, B, sb, par_b, s1, par1);
  if (tid == 0) s_node[0] = 0;
  __syncthreads();

  int sp = 1, nv = 0, nl = 0;
  bool overflow = false;
  float t_upper = kBig;
  while (sp > 0 && !overflow) {
    --sp;
    const int node = s_node[sp];
    if constexpr (kEngine == kWide) {
      if (tid < 32)
        s_row[tid] = __ldg(reinterpret_cast<const float4*>(
                               a.table + (size_t)node * 128) + tid);
    }
    // every thread has read slot sp before it is reused; K9's row staged
    __syncthreads();
    ++nv;
    if constexpr (kEngine == kWide) {
      const float* row = reinterpret_cast<const float*>(s_row);
      for (int k = 0; k < 8; ++k) {
        const float* c = row + 16 * k;
        const float kind = c[6];
        float t_en, t_ex;
        box_interval(c, c + 3, B, &t_en, &t_ex);
        if (!(t_en <= t_ex && t_ex > 0.f && t_en <= t_upper && kind > 0.5f))
          continue;
        if (kind < 1.5f) {  // internal: push its supernode
          if (sp + 1 > kStack) {
            overflow = true;
            break;
          }
          if (tid == 0) s_node[sp] = (int)c[7];
          ++sp;
        } else {  // leaf: stream it now, then refresh t_upper
          nl += ring_leaf<kS>(a, (int)c[7], (int)c[8], ring, ray, on, lane0,
                              lpt, bt, bs);
          t_upper = cluster_t_upper<1>(bt, on, s1, par1);
        }
      }
      __syncthreads();  // the pushes are visible, the row free, at the pop
      continue;
    }
    const float* f = a.table + (size_t)node * 16;
    float t_en, t_ex;
    box_interval(f, f + 3, B, &t_en, &t_ex);
    if (!(t_en <= t_ex && t_ex > 0.f && t_en <= t_upper)) continue;
    const int flags = (int)f[7];
    if (flags >= 4) {  // leaf
      nl += ring_leaf<kS>(a, (int)f[10], (int)f[11], ring, ray, on, lane0,
                          lpt, bt, bs);
      t_upper = cluster_t_upper<1>(bt, on, s1, par1);
    } else {  // split: far child, then the near one on top
      if (sp + 2 > kStack) {
        overflow = true;
        break;
      }
      const int ax = flags & 3;
      const bool nlo = __fadd_rn(B.il[ax], B.ih[ax]) > 0.f;
      const int cl = (int)f[8], ch = (int)f[9];
      if (tid == 0) {
        s_node[sp] = nlo ? ch : cl;
        s_node[sp + 1] = nlo ? cl : ch;
      }
      sp += 2;
      __syncthreads();
    }
  }
  if (overflow && rank == 0 && tid == 0) atomicExch(a.overflow, 1);
  // every thread of a group holds its lane's winner
  store_tile<1, kS, kC>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl,
                        0, 0, 0);
  cluster_end();
}

template <int RPT>
int launch_resident(const V1Args& a, cudaStream_t stream) {
  packet_v1_kernel<RPT><<<a.n_rays / a.tile, a.tile / RPT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

using V1Kernel = void (*)(const V1Args);

// The launch shape of K6b (engine kStream) or K9 (kWide) at `tile`: blocks
// per cluster (kCluster when the tile is a multiple of 32 * kCluster, so
// that each block's lanes are whole warps; else 1) and threads per block
// (kSplit a lane on a cluster, one a lane on one block); the kernel
// instance, null for an engine or a tile it does not take (a multiple of
// 32 up to 4096, and up to 512 on one block).
V1Kernel v1_shape(int tile, int engine, int* c, int* threads) {
  if ((engine != kStream && engine != kWide) || tile <= 0 || tile % 32 ||
      tile > kCluster * kMaxThreads)
    return nullptr;
  if (tile % (32 * kCluster) == 0) {
    *c = kCluster;
    *threads = tile / kCluster * kSplit;
    return engine == kStream
               ? packet_v1_cluster_kernel<kCluster, kSplit, kStream>
               : packet_v1_cluster_kernel<kCluster, kSplit, kWide>;
  }
  if (tile > kMaxThreads) return nullptr;
  *c = 1;
  *threads = tile;
  return engine == kStream ? packet_v1_cluster_kernel<1, 1, kStream>
                           : packet_v1_cluster_kernel<1, 1, kWide>;
}

}  // namespace

// K6a (engine 0), K6b (1) or K9 (2). table: [M, 16] f32 binary nodes
// (node_table[:, :16]) for engines 0 and 1, [S, 128] f32 supernodes for 2;
// recs: [n_recs, 16] f32 records (v0, e1, e2, tri_id), padded to a multiple
// of 8 and at least 128 for engines 1 and 2; both 16-byte aligned; orig_t,
// dir_t: [3, n_rays] f32 tile-major. Outputs best_t [n_rays] f32, best_slot
// [n_rays] i32 (-1 on a miss), stats [n_rays / tile, 5] i32, and overflow
// [1] i32 (zeroed by the caller; set to 1 when a stack overflows). tile: a
// multiple of 32 up to 4096; K6a: tile / 512 rays per thread above 512
// (1, 2, 4 or 8); K6b, K9: a multiple of 256 runs as a cluster of 8
// blocks, each an eighth of its lanes, a smaller one (up to 512) as one
// block. Returns the launch's error, else cudaGetLastError(): a refused
// cluster launch shows there.
extern "C" int packet_v1_launch(const void* table, const void* recs,
                                const void* orig_t, const void* dir_t,
                                void* best_t, void* best_slot, void* stats,
                                void* overflow, int n_rays, int tile,
                                int n_recs, int engine, void* stream) {
  V1Args a;
  a.table = static_cast<const float*>(table);
  a.recs = static_cast<const float4*>(recs);
  a.orig_t = static_cast<const float*>(orig_t);
  a.dir_t = static_cast<const float*>(dir_t);
  a.best_t = static_cast<float*>(best_t);
  a.best_slot = static_cast<int*>(best_slot);
  a.stats = static_cast<int*>(stats);
  a.overflow = static_cast<int*>(overflow);
  a.n_rays = n_rays;
  a.tile = tile;
  a.n_recs = n_recs;
  if (tile <= 0 || tile % 32 || tile > 8 * kMaxThreads || n_rays % tile ||
      engine < kResident || engine > kWide ||
      (engine != kResident && (n_recs % 8 || n_recs < kWinRecs)) ||
      reinterpret_cast<size_t>(recs) % 16 ||
      reinterpret_cast<size_t>(table) % 16)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine != kResident) {
    int c, threads;
    const V1Kernel kernel = v1_shape(tile, engine, &c, &threads);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    return launch_cluster(kernel, c, n_rays / tile * c, threads, 0, s, a);
  }
  const int rpt = tile <= kMaxThreads ? 1 : tile / kMaxThreads;
  if (rpt * (tile / rpt) != tile) return (int)cudaErrorInvalidValue;
  switch (rpt) {
    case 1: return launch_resident<1>(a, s);
    case 2: return launch_resident<2>(a, s);
    case 4: return launch_resident<4>(a, s);
    case 8: return launch_resident<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shape of K6b's (engine 1) or K9's (2) launch at `tile`, as
// clpt::cluster_shape writes it into out[6]: blocks per cluster, threads
// per block, the clusters resident at once, registers per thread, static
// and dynamic shared memory bytes per block. Returns a CUDA error or 0
// (cudaErrorInvalidValue for K6a, which is no cluster launch, or a tile the
// kernels do not take).
extern "C" int packet_v1_shape(int tile, int engine, int* out) {
  int c, threads;
  const V1Kernel kernel = v1_shape(tile, engine, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return cluster_shape(kernel, c, threads, 0, out);
}
