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
//     K6a tests the leaf's own records [4 q, 4 q + count) of the resident
//     array in order; a record is taken where it hits at t <= best t, so
//     the later record wins at equal t. K6b streams the leaf's windows of
//     128 records, rows [r0 + 16 b, +16) with r0 = 4 q / 8, clamped to
//     n_rows - 16, for b < ceil((ceil((4 q + count) / 8) - r0) / 16), none
//     culled (_chunk_pipeline's stream_leaf), with _mt_chunk_math's tie
//     rule: within a window the least t, among equal t the lowest row of 8
//     and within it the highest record; across windows the later window
//     wins at equal t (kd_walk.cuh::dense_split).
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
// Design. All three run as K3 does (packet_stream.cu). A tile that is a
// multiple of 256 rays runs on a thread-block cluster of kCluster = 8
// blocks (cluster.cuh), each block an eighth of the tile's lanes (256 at
// tile 2048, 64 at tile 512, 512 at tile 4096) with kSplit = 2
// neighbouring threads a lane, each testing every other record of a staged
// buffer; a smaller tile, or one that is not a multiple of 256, runs on
// one block with one thread a lane. Every block runs the same walk on its
// own stack in shared memory; the packet bounds and every t_upper refresh
// are reduced over the whole cluster (cluster_bounds, cluster_t_upper), so
// every block pops the same nodes, tests the same supernode slots and
// stages the same records, and the stack guard's decision is the same in
// every block; rank 0 writes the stats row, and the last cluster barrier
// keeps every block until its peers have read its shared memory. Nothing
// is culled, so a leaf's records are known when it is entered: they go
// through a ring of kRing = 4 buffers of 6 KB (cols 0-11 of 128 records,
// what mt_hit reads) with cp.async, three in flight while one is tested
// (kd_walk.cuh::ring_stream, shared with K7 and K8); no copy is asked
// beyond the leaf, since the next leaf depends on t_upper, and an empty
// leaf starts none.
//   K6b and K9 stage the leaf's windows on the clamped grid of the padded
//     records; the 2 shares of a lane merge by the window's tie rule, a
//     total order, before they meet the earlier windows' winner
//     (kd_walk.cuh::dense_split).
//   K6a stages the leaf's own records of the unpadded array in chunks of
//     128 from 4 q, the last one partial: no copy reads past the leaf. Its
//     tie rule is not the window's (dense_resident): a share takes its
//     records in ascending order where t <= its best, so it keeps its
//     highest record at equal t; the 2 shares merge by the lower t, then
//     the higher record; the chunk's winner meets the running best where
//     t <= best t, so the later chunk and the later leaf win at equal t.
//     That total order replays the record-by-record loop of ops/packet.py::
//     _resident_leaf exactly.
//   K9 stages a popped supernode's row (8 slots x 16 f32, 512 B) in shared
//     memory once, instead of every thread reading it from global memory.
// The forms are held to 64 registers, so that two 512-thread blocks fit an
// SM.
//
// What bounds them on this card: FP32 issue in the dense MT test (15-53
// operations per pair by its early exit). The walk culls no window and,
// while any lane misses, t_upper stays 3.4e38 and cuts nothing, so these
// kernels test far more pairs than K3 on the same tiles. On one block a
// tile ran on one SM with 16 warps, and a mirror wave took as long as its
// heaviest tile, which tests nearly every record of the tree (K6a read
// them one at a time from global memory, each a broadcast to every
// thread); on a cluster it runs on 8 SMs, so the launch moves toward its
// total work at the rate the pair tests issue. The walk's barriers and
// node reads stay serial per tile, repeated by every block of the cluster.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

enum Engine { kResident = 0, kStream = 1, kWide = 2 };

constexpr int kCluster = 8;  // blocks per tile (tiles of 256k rays)
constexpr int kSplit = 2;    // threads a lane on a cluster

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

// K6a's dense test of one staged chunk of n records (rec0 the first)
// against this thread's ray, kS threads a lane: share h takes records h,
// h + kS, ... in ascending order where t <= its best, so it keeps its
// highest record at equal t; the shares merge by the lower t, then the
// higher record (warp shuffles; every thread of the lane ends with the
// chunk's winner); the chunk's winner meets the running best where t <=
// best t, so the later chunk and the later leaf win at equal t.
template <int kS>
__device__ __forceinline__ void dense_resident(const float4* win, int n,
                                               const Ray& ray, int rec0,
                                               float* bt, int* bs) {
  float ct = kBig;
  int cr = -1;  // record of ct within the chunk
  for (int r = threadIdx.x % kS; r < n; r += kS) {
    float t;
    if (mt_hit(ray, win[r * kUsedF4], win[r * kUsedF4 + 1],
               win[r * kUsedF4 + 2], &t) && t <= ct) {
      ct = t;
      cr = r;
    }
  }
#pragma unroll
  for (int off = 1; off < kS; off <<= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, ct, off);
    const int r2 = __shfl_xor_sync(0xffffffffu, cr, off);
    if (t2 < ct || (t2 == ct && r2 > cr)) {
      ct = t2;
      cr = r2;
    }
  }
  if (cr >= 0 && ct <= *bt) {
    *bt = ct;
    *bs = rec0 + cr;
  }
}

// n records from record rec0 (cols 0-11 of each) into `dst`: this
// thread's share of the 16-byte copies, then its commit group.
__device__ __forceinline__ void copy_records(float4* dst, const float4* recs,
                                             int rec0, int n) {
  const float4* src = recs + (size_t)rec0 * kRecF4;
  for (int i = threadIdx.x; i < n * kUsedF4; i += blockDim.x)
    cp_async16(dst + i, src + (i / kUsedF4) * kRecF4 + i % kUsedF4);
  cp_async_commit();
}

// A leaf at quad row qstart with `count` records through the ring of kRing
// buffers (kd_walk.cuh::ring_stream), kS threads a lane. K6a (kResident):
// its records in chunks of 128 from 4 qstart, the last one partial, each
// tested by dense_resident; returns 1 (a leaf tested). K6b and K9: its
// windows, rows row0 + 16 b clamped to n_recs / 8 - 16 for b < nch, in
// order, each tested by dense_split (ring_windows); returns nch. Every
// thread of the cluster calls it (uniform). The caller's t_upper refresh
// after it is a cluster barrier, so every thread is done with the ring
// before the next leaf's copies.
template <int kS, int kEngine>
__device__ int ring_leaf(const V1Args& a, int qstart, int count,
                         float4* ring, const Ray* ray, const bool* on,
                         int lane0, int lpt, float* bt, int* bs) {
  const int first = qstart * 4;
  if constexpr (kEngine == kResident) {
    ring_stream(
        (count + kWinRecs - 1) / kWinRecs, ring, kWinUsedF4,
        [&](int b, float4* dst) {
          copy_records(dst, a.recs, first + b * kWinRecs,
                       min(kWinRecs, count - b * kWinRecs));
        },
        [&](int b, const float4* win) {
          dense_resident<kS>(win, min(kWinRecs, count - b * kWinRecs),
                             ray[0], first + b * kWinRecs, bt, bs);
        });
    return 1;
  } else {
    const int row0 = first / 8;
    const int nch =
        ((first + count + 7) / 8 - row0 + kChunkRows - 1) / kChunkRows;
    ring_windows<kS>(a.recs, a.n_recs / 8 - kChunkRows, row0, nch, ring, ray,
                     on, lane0, lpt, bt, bs);
    return nch;
  }
}

// K6a (kEngine kResident) and K6b (kStream), the binary walk, and K9
// (kWide: the supernode walk): kC blocks per tile (a cluster), each owning
// tile / kC consecutive lanes, one per group of kS neighbouring threads
// (lane rank * tile / kC + tid / kS).
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
          nl += ring_leaf<kS, kEngine>(a, (int)c[7], (int)c[8], ring, ray,
                                       on, lane0, lpt, bt, bs);
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
      nl += ring_leaf<kS, kEngine>(a, (int)f[10], (int)f[11], ring, ray, on,
                                   lane0, lpt, bt, bs);
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

using V1Kernel = void (*)(const V1Args);

// The instance of `engine` on clusters of kC blocks, kS threads a lane.
template <int kC, int kS>
V1Kernel v1_kernel(int engine) {
  return engine == kResident ? packet_v1_cluster_kernel<kC, kS, kResident>
         : engine == kStream ? packet_v1_cluster_kernel<kC, kS, kStream>
                             : packet_v1_cluster_kernel<kC, kS, kWide>;
}

// The launch shape of K6a (engine kResident), K6b (kStream) or K9 (kWide)
// at `tile`: blocks per cluster (kCluster when the tile is a multiple of
// 32 * kCluster, so that each block's lanes are whole warps; else 1) and
// threads per block (kSplit a lane on a cluster, one a lane on one block);
// the kernel instance, null for an engine or a tile it does not take (a
// multiple of 32 up to 4096, and up to 512 on one block).
V1Kernel v1_shape(int tile, int engine, int* c, int* threads) {
  if (engine < kResident || engine > kWide || tile <= 0 || tile % 32 ||
      tile > kCluster * kMaxThreads)
    return nullptr;
  if (tile % (32 * kCluster) == 0) {
    *c = kCluster;
    *threads = tile / kCluster * kSplit;
    return v1_kernel<kCluster, kSplit>(engine);
  }
  if (tile > kMaxThreads) return nullptr;
  *c = 1;
  *threads = tile;
  return v1_kernel<1, 1>(engine);
}

}  // namespace

// K6a (engine 0), K6b (1) or K9 (2). table: [M, 16] f32 binary nodes
// (node_table[:, :16]) for engines 0 and 1, [S, 128] f32 supernodes for 2;
// recs: [n_recs, 16] f32 records (v0, e1, e2, tri_id), as they are for
// engine 0, padded to a multiple of 8 and at least 128 for engines 1 and
// 2; both 16-byte aligned; orig_t, dir_t: [3, n_rays] f32 tile-major.
// Outputs best_t [n_rays] f32, best_slot [n_rays] i32 (-1 on a miss),
// stats [n_rays / tile, 5] i32, and overflow [1] i32 (zeroed by the
// caller; set to 1 when a stack overflows). tile: a multiple of 32 up to
// 4096; a multiple of 256 runs as a cluster of 8 blocks, each an eighth of
// its lanes, a smaller one (up to 512) as one block. Returns the launch's
// error, else cudaGetLastError(): a refused cluster launch shows there.
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
  if (tile <= 0 || n_rays % tile ||
      (engine != kResident && (n_recs % 8 || n_recs < kWinRecs)) ||
      reinterpret_cast<size_t>(recs) % 16 ||
      reinterpret_cast<size_t>(table) % 16)
    return (int)cudaErrorInvalidValue;
  int c, threads;
  const V1Kernel kernel = v1_shape(tile, engine, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  return launch_cluster(kernel, c, n_rays / tile * c, threads, 0,
                        static_cast<cudaStream_t>(stream), a);
}

// The shape of K6a's (engine 0), K6b's (1) or K9's (2) launch at `tile`, as
// clpt::cluster_shape writes it into out[6]: blocks per cluster, threads
// per block, the clusters resident at once, registers per thread, static
// and dynamic shared memory bytes per block. Returns a CUDA error or 0
// (cudaErrorInvalidValue for an engine or a tile the kernels do not take).
extern "C" int packet_v1_shape(int tile, int engine, int* out) {
  int c, threads;
  const V1Kernel kernel = v1_shape(tile, engine, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return cluster_shape(kernel, c, threads, 0, out);
}
