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
// on. The plain
// torch version (ops/packet.py::packet_queue_reference) replays the same
// schedule and agrees exactly in t, slot and stats.
//
// Design: one block per tile and the block-uniform walk of kd_walk.cuh, as
// K3. A window is 128 records x 64 B = 8 KB, copied with one 16-byte
// cp.async.cg.shared.global per thread at 512 threads and one commit group
// per window, so a thread's groups are the ring's windows in order and the
// copy of the window at the head is complete once at most (in flight - 1)
// groups are pending (cp.async.wait_group takes an immediate: a switch over
// that count). Every started copy is waited exactly once, and the loop ends
// only with the ring empty, so no block exits with a copy in flight; a tile
// without an active lane pushes no root and starts no copy. The 64 KB ring
// is dynamic shared memory, above the 48 KB default.
//
// What bounds it on this card: FP32 issue in the dense test, as K3 (22
// operations per SO pair, 15-53 per MT pair by its early exit); the ring
// hides the window loads behind up to 7 windows of dense tests but not the
// walk's serial barriers and global reads. Measured beside K3 on the same
// inputs by chip_smoke.py (phase 19).

#include <cuda_runtime.h>

#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

constexpr int kDepth = 8;                   // windows in flight
constexpr int kWinF4 = kWinRecs * kRecF4;   // float4s per window (8 KB)
constexpr int kRingBytes = kDepth * kWinF4 * (int)sizeof(float4);

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

template <int RPT, bool kSO>
__global__ void __launch_bounds__(kMaxThreads)
packet_queue_kernel(const QArgs a) {
  extern __shared__ float4 ring[];          // [kDepth][kWinF4]
  __shared__ int s_node[kStack];
  __shared__ float s_tlo[kStack], s_thi[kStack];
  __shared__ int q_row[kDepth], q_win[kDepth];   // per ring slot: first
  __shared__ float q_tlo[kDepth], q_thi[kDepth]; // row, window, leaf interval
  __shared__ float red[kMaxThreads / 32];
  __shared__ int ired[kMaxThreads / 32];
  __shared__ Bounds B;

  const int tile_i = blockIdx.x;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)tile_i * a.tile;
  const bool cull = a.cbnd != nullptr;

  Ray ray[RPT];
  bool on[RPT];
  float bt[RPT];
  int bs[RPT];
  load_rays<RPT>(a.orig_t, a.dir_t, a.act, a.n_rays, base, ray, on, bt, bs);
  const int n_act = packet_bounds<RPT>(ray, on, B, red, ired);

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
          const float4* src = a.rows + (size_t)row * 8 * kRecF4;
          float4* dst = ring + slot * kWinF4;
          for (int i = tid; i < kWinF4; i += nthr) cp_async16(dst + i, src + i);
          cp_async_commit();
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
        dense_window<RPT, kSO, false, kRecF4, kMaxThreads>(
            ring + slot * kWinF4, ray, on, 0xffffffffu,
            (long long)q_row[slot] * 8, bt, bs);
        ++nl;
      } else {
        ++nc;
      }
    }
    __syncthreads();  // every thread is done with the drained slots
    t_upper = tile_t_upper<RPT>(bt, on, red);
  }
  if (overflow && tid == 0) *a.overflow = 1;

  store_tile<RPT>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl,
                  n_act, nc, 0);
}

template <int RPT, bool kSO>
int launch_one(const QArgs& a, cudaStream_t stream) {
  auto kernel = packet_queue_kernel<RPT, kSO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.n_rays / a.tile, a.tile / RPT, kRingBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int RPT>
int launch_rpt(const QArgs& a, bool so, cudaStream_t stream) {
  return so ? launch_one<RPT, true>(a, stream)
            : launch_one<RPT, false>(a, stream);
}

}  // namespace

// K5. nodes_i: [M, 4] i32; nodes_f: [6 + M] f32 (K3's tables); rows:
// [n_rows * 8, 16] f32 records (SO rows when so != 0, else raw (v0, e1, e2,
// tri_id)), 16-byte aligned; orig_t, dir_t: [3, n_rays] f32 tile-major;
// act: [n_rays] f32; cbnd: [W, 6] f32 window AABBs or null. Outputs best_t
// [n_rays] f32, best_slot [n_rays] i32 (-1 on a miss), stats
// [n_rays / tile, 5] i32, and overflow [1] i32 (zeroed by the caller; set
// to 1 when a stack overflows). tile: a multiple of 32 up to 4096, with
// tile / 512 rays per thread above 512. Returns cudaGetLastError() after
// the launch.
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
  if (tile <= 0 || tile % 32 || tile > 8 * kMaxThreads || n_rays % tile ||
      n_rows < kChunkRows || reinterpret_cast<size_t>(rows) % 16)
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
