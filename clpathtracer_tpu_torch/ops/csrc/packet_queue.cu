// K5: the kd-tree queue packet kernel for Hopper (sm_90a). Replaces both TPU
// kernels of the JAX package's "queue" engine, clpathtracer_tpu/ops/
// packet.py::_kernel_queue (node tables in VMEM) and _kernel_queue_smem
// (node tables in SMEM); the two differ only in where the TPU keeps the
// tables, and here both read K3's tables from global memory.
//
// What it computes: K3's function (packet_stream.cu: one interval walk of
// the kd-tree per tile, leaf windows of 128 records, the AABB window cull,
// the SO or MT dense test, the same tie rule), with the walk decoupled from
// the dense test by a ring of kDepth = 8 window copies in flight that
// crosses leaf boundaries (kDepth is ops/packet.py::QUEUE_DEPTH, which the
// plain version replays). The loop alternates two phases, as the TPU
// kernel's does:
//   produce: until kDepth windows are in flight or the walk is exhausted,
//     either advance the current leaf's window cursor (cull-test the next
//     windows against [ltlo, min(lthi, t_upper)] when window tables exist,
//     and start the first survivor's copy into ring slot tail % kDepth) or
//     pop a node (a split pushes its children, a leaf opens its cursor);
//   consume: drain every window when the walk is exhausted, else
//     max(in flight - kDepth / 2, 1) of them, in order: wait the copy,
//     re-check the window against the current t_upper (the leaf interval
//     alone without window tables), then run its dense test, or count it
//     as culled when it died; then refresh t_upper, the largest best t
//     over the active lanes, once per drain.
// Stats per tile: node pops, windows tested, active lanes, windows culled
// or skipped, and 0 in lane 4, as the TPU kernel writes them. A split whose
// pushes could pass the 128-entry stack ends the walk (the ring drains, no
// new window starts) and sets the overflow flag, which the wrapper raises
// on. The plain torch version (ops/packet.py::packet_queue_reference)
// replays the same schedule and agrees exactly in t, slot and stats.
//
// Design: K3's cluster walk (packet_stream.cu). A tile that is a multiple
// of 256 rays runs on a thread-block cluster of kCluster = 8 blocks
// (cluster.cuh), each block an eighth of the tile's lanes (256 at tile
// 2048, 64 at tile 512, 512 at tile 4096) with kSplit = 2 neighbouring
// threads a lane, each testing every other record of a window; their
// winners merge by the window's tie rule before they meet the earlier
// windows' winner (kd_walk.cuh::dense_split). A smaller tile, or one that
// is not a multiple of 256, runs on one block with one thread a lane.
// Every block runs the same produce/consume loop on its own stack and ring
// in shared memory; every value a decision reads is the same in all
// blocks: the packet bounds and the active count (cluster_bounds), t_upper
// after each drain (cluster_t_upper, the one cluster barrier a drain) and
// the window cull on those bounds. So every block pops the same nodes,
// starts and drains the same windows and takes the stack guard's decision
// alike; rank 0 writes the stats row, and the last cluster barrier keeps
// every block until its peers have read its shared memory. The ring holds
// kDepth windows of columns 0-11 (what the dense tests read: 128 records x
// 48 B = 6 KB), 48 KB of dynamic shared memory, its limit raised with
// cudaFuncSetAttribute. Each window is one commit group of every thread
// (empty for threads past its 384 16-byte copies), so a thread's groups
// are the ring's windows in order and the head's copy is complete once at
// most (in flight - 1) groups are pending (cp.async.wait_group takes an
// immediate: a switch over that count). Every started copy is waited
// exactly once, and the loop ends only with the ring empty, also after the
// stack guard ends the walk, so no block exits with a copy in flight; a
// tile without an active lane pushes no root and starts no copy. The
// forms are held to 64 registers, so that two 512-thread blocks fit an SM.
//
// What bounds it on this card: FP32 issue in the dense test, as K3 (22
// operations per SO pair, 15-53 per MT pair by its early exit). On one
// block a 2048-ray tile ran on one SM, and a mirror wave took as long as
// its heaviest tile, which streams nearly every window of the tree; on a
// cluster it runs on 8 SMs, so the launch moves toward its total work at
// the rate the pair tests issue. The walk's barriers and node reads stay
// serial per tile, repeated by every block of the cluster; the ring hides
// the window loads behind up to 7 windows of dense tests. Measured beside
// K3 on the same inputs by chip_smoke.py (phase 19), its heaviest mirror
// tile alone in phase 38.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

constexpr int kDepth = 8;     // windows in flight
constexpr int kCluster = 8;   // blocks per tile (tiles of 256k rays)
constexpr int kSplit = 2;     // threads a lane on a cluster
constexpr int kRingBytes = kDepth * kWinUsedF4 * (int)sizeof(float4);

struct QArgs {
  const int4* nodes_i;     // [M]: as K3's
  const float* nodes_f;    // [6 + M]
  const float4* rows;      // [n_rows * 8] records of 16 f32
  const float* orig_t;     // [3, n_rays]
  const float* dir_t;      // [3, n_rays]
  const float* act;        // [n_rays], > 0 for an active lane
  const float* cbnd;       // [W, 6] window AABBs, or null: no window test
  float* best_t;           // [n_rays]
  int* best_slot;          // [n_rays]
  int* stats;              // [n_tiles, 5]
  int* overflow;           // [1], set to 1 when a walk's stack overflows
  int n_rays, tile, n_rows;
};

// kC blocks per tile (a cluster), each owning tile / kC consecutive lanes,
// one per group of kS neighbouring threads (lane rank * tile / kC +
// tid / kS), each thread of a group a kS-th of every window's records.
template <int kC, int kS, bool kSO>
__global__ void __launch_bounds__(kMaxThreads * kS, kS == 1 ? 2 : 1)
packet_queue_kernel(const QArgs a) {
  extern __shared__ float4 ring[];          // [kDepth][kWinUsedF4]
  __shared__ int s_node[kStack];
  __shared__ float s_tlo[kStack], s_thi[kStack];
  __shared__ int q_row[kDepth], q_win[kDepth];   // per ring slot: first
  __shared__ float q_tlo[kDepth], q_thi[kDepth]; // row, window, leaf interval
  __shared__ ClusterSlots<12> sb;
  __shared__ ClusterSlots<1> s1;
  __shared__ Bounds B;

  const int rank = cluster_rank();
  const int tid = threadIdx.x;
  const size_t base = (size_t)(blockIdx.x / kC) * a.tile +
                      (size_t)rank * (a.tile / kC);
  const int lpt = blockDim.x / kS;  // lanes of the block
  const int lane0 = tid / kS;       // the block's lane of this thread
  const bool cull = a.cbnd != nullptr;

  Ray ray[1];
  bool on[1];
  float bt[1];
  int bs[1];
  load_rays<1, kS>(a.orig_t, a.dir_t, a.act, a.n_rays, base, ray, on, bt,
                   bs);
  int par_b = 0, par1 = 0;
  const int n_act = cluster_bounds<1>(ray, on, tid % kS == 0, B, sb, par_b,
                                      s1, par1);

  int sp = push_root(a.nodes_f, B, n_act, s_node, s_tlo, s_thi);

  float t_upper = kBig;
  int head = 0, tail = 0;          // ring: windows consumed / started
  int wcur = 0, wend = 0;          // the open leaf's window cursor and end
  int lrow0 = 0, win0 = 0;         // its first record row and window id
  float ltlo = 0.f, lthi = kBig;   // its interval
  int nv = 0, nl = 0, nc = 0;
  bool overflow = false;
  while (sp > 0 || wcur < wend || head < tail) {
    // produce: until the ring is full or the walk is exhausted
    while (tail - head < kDepth && (wcur < wend || sp > 0)) {
      if (wcur < wend) {
        int w = wcur;
        if (cull)
          while (w < wend && !window_keeps(a.cbnd + (size_t)(win0 + w) * 6,
                                           B, ltlo, lthi, t_upper))
            ++w;
        nc += w - wcur;
        if (w < wend) {
          const int row = min(lrow0 + w * kChunkRows, a.n_rows - kChunkRows);
          const int slot = tail % kDepth;
          if (tid == 0) {
            q_row[slot] = row;
            q_win[slot] = win0 + w;
            q_tlo[slot] = ltlo;
            q_thi[slot] = lthi;
          }
          copy_window(ring + slot * kWinUsedF4, a.rows, row);
          ++tail;
        }
        wcur = w + 1;
      } else {
        --sp;
        const int node = s_node[sp];
        const float tlo = s_tlo[sp];
        const float thi = s_thi[sp];
        __syncthreads();  // every thread has read slot sp before it is reused
        ++nv;
        if (tlo <= fminf(thi, t_upper) && thi > 0.f) {
          const int4 nd = a.nodes_i[node];
          if (nd.x >= 4) {  // leaf: open its window cursor
            wcur = 0;
            wend = nd.w;
            lrow0 = nd.y;
            win0 = nd.z;
            ltlo = tlo;
            lthi = thi;
          } else {
            sp = push_children(B, nd, a.nodes_f[6 + node], tlo, thi, t_upper,
                               sp, s_node, s_tlo, s_thi);
            if (sp < 0) {  // end the walk: the ring drains below
              overflow = true;
              sp = 0;
              wcur = wend = 0;
            }
          }
        }
      }
    }

    // consume: all when the walk is exhausted, else keep kDepth / 2 flying
    const bool done = !(wcur < wend || sp > 0);
    const int ndrain = done ? tail - head : max(tail - head - kDepth / 2, 1);
    for (int k = 0; k < ndrain; ++k, ++head) {
      const int slot = head % kDepth;
      wait_pending(tail - head - 1);
      __syncthreads();  // every thread's part of the copy has landed
      const bool still =
          cull ? window_keeps(a.cbnd + (size_t)q_win[slot] * 6, B,
                              q_tlo[slot], q_thi[slot], t_upper)
               : q_tlo[slot] <= fminf(q_thi[slot], t_upper);
      if (still) {
        dense_split<1, kS, kSO, false, kMaxThreads>(
            ring + slot * kWinUsedF4, ray, on, 0xffffffffu, lane0, lpt,
            (long long)q_row[slot] * 8, bt, bs);
        ++nl;
      } else {
        ++nc;
      }
    }
    // its cluster barrier also keeps the drained slots from the next
    // produce's copies until every thread is done with them
    t_upper = cluster_t_upper<1>(bt, on, s1, par1);
  }
  if (overflow && rank == 0 && tid == 0) *a.overflow = 1;
  // every thread of a group holds its lane's winner
  store_tile<1, kS, kC>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl,
                        n_act, nc, 0);
  cluster_end();
}

using QueueKernel = void (*)(const QArgs);

// The launch shape of K5 at `tile`: blocks per cluster (kCluster when the
// tile is a multiple of 32 * kCluster, so that each block's lanes are whole
// warps; else 1) and threads per block (kSplit a lane on a cluster, one a
// lane on one block); the kernel instance, null for a tile it does not
// take (a multiple of 32 up to 4096, and up to 512 on one block).
QueueKernel queue_shape(int tile, bool so, int* c, int* threads) {
  if (tile <= 0 || tile % 32 || tile > kCluster * kMaxThreads)
    return nullptr;
  if (tile % (32 * kCluster) == 0) {
    *c = kCluster;
    *threads = tile / kCluster * kSplit;
    return so ? packet_queue_kernel<kCluster, kSplit, true>
              : packet_queue_kernel<kCluster, kSplit, false>;
  }
  if (tile > kMaxThreads) return nullptr;
  *c = 1;
  *threads = tile;
  return so ? packet_queue_kernel<1, 1, true>
            : packet_queue_kernel<1, 1, false>;
}

// The ring's 48 KB of dynamic shared memory: the default limit leaves out
// the static shared memory, so it is raised for every instance.
cudaError_t allow_ring(QueueKernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
}

}  // namespace

// K5. nodes_i: [M, 4] i32; nodes_f: [6 + M] f32 (K3's tables); rows:
// [n_rows * 8, 16] f32 records (SO rows when so != 0, else raw (v0, e1, e2,
// tri_id)), 16-byte aligned; orig_t, dir_t: [3, n_rays] f32 tile-major;
// act: [n_rays] f32; cbnd: [W, 6] f32 window AABBs or null. Outputs best_t
// [n_rays] f32, best_slot [n_rays] i32 (-1 on a miss), stats
// [n_rays / tile, 5] i32, and overflow [1] i32 (zeroed by the caller; set
// to 1 when a stack overflows). tile: a multiple of 32 up to 4096; a
// multiple of 256 runs as a cluster of 8 blocks, each an eighth of its
// lanes, a smaller one (up to 512) as one block. Returns the launch's
// error, else cudaGetLastError(): a refused cluster launch shows there.
extern "C" int packet_queue_launch(
    const void* nodes_i, const void* nodes_f, const void* rows,
    const void* orig_t, const void* dir_t, const void* act, const void* cbnd,
    void* best_t, void* best_slot, void* stats, void* overflow, int n_rays,
    int tile, int n_rows, int so, void* stream) {
  QArgs a;
  a.nodes_i = static_cast<const int4*>(nodes_i);
  a.nodes_f = static_cast<const float*>(nodes_f);
  a.rows = static_cast<const float4*>(rows);
  a.orig_t = static_cast<const float*>(orig_t);
  a.dir_t = static_cast<const float*>(dir_t);
  a.act = static_cast<const float*>(act);
  a.cbnd = static_cast<const float*>(cbnd);
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
  const QueueKernel kernel = queue_shape(tile, so != 0, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaError_t err = allow_ring(kernel);
  if (err != cudaSuccess) return (int)err;
  return launch_cluster(kernel, c, n_rays / tile * c, threads, kRingBytes,
                        static_cast<cudaStream_t>(stream), a);
}

// The shape of K5's launch at `tile` (SO form when so != 0), as
// clpt::cluster_shape writes it into out[6]: blocks per cluster, threads
// per block, the clusters resident at once, registers per thread, static
// and dynamic shared memory bytes per block. Returns a CUDA error or 0
// (cudaErrorInvalidValue for a tile the kernel does not take).
extern "C" int packet_queue_shape(int tile, int so, int* out) {
  int c, threads;
  const QueueKernel kernel = queue_shape(tile, so != 0, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_ring(kernel);
  if (err != cudaSuccess) return (int)err;
  return cluster_shape(kernel, c, threads, kRingBytes, out);
}
