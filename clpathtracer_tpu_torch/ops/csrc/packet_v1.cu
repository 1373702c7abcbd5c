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
// Design: one block per tile, tile/RPT threads of RPT rays each, and the
// block-uniform walk of kd_walk.cuh, as K3: every thread computes the same
// pops and interval tests from the same reads; thread 0 writes the stack in
// shared memory and barriers order its reads and writes. The stack is
// guarded: a push that would pass its kStack entries sets the overflow flag
// (the wrapper raises) and ends the walk; nothing is written out of bounds.
// K6a's records are read straight from global memory, each a broadcast to
// every thread. K6b's and K9's windows (cols 0-11 of 128 records, 6 KB) are
// double-buffered in shared memory with cp.async: window b + 1's copy is in
// flight while window b is tested; one commit group per window and thread,
// each waited exactly once (wait_group 1 while the next copy flies, 0 for
// the leaf's last window), and an empty leaf starts no copy.
//
// What bounds them on this card: FP32 issue in the dense MT test (15-53
// operations per pair by its early exit). The walk culls no window and,
// while any lane misses, t_upper stays 3.4e38 and cuts nothing, so these
// kernels test far more pairs than K3 on the same tiles; besides, the
// walk's serial barriers and global reads, and one block per tile. Making
// them fast is later work.

#include <cuda_runtime.h>

#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

enum Engine { kResident = 0, kStream = 1, kWide = 2 };

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

// K6b's and K9's leaf: stream and test the windows of the leaf at quad row
// qstart with `count` records (kd_walk.cuh::stream_windows, double-buffered
// in buf[2 * kWinUsedF4]). Returns the windows streamed. Every thread calls
// it (uniform).
template <int RPT>
__device__ int stream_leaf(const V1Args& a, int qstart, int count,
                           float4* buf, const Ray* ray, const bool* on,
                           float* bt, int* bs) {
  const int first = qstart * 4;
  const int row0 = first / 8;
  const int nch = ((first + count + 7) / 8 - row0 + kChunkRows - 1) /
                  kChunkRows;
  stream_windows<RPT>(a.recs, a.n_recs / 8, row0, nch, buf, ray, on, bt, bs);
  return nch;
}

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

template <int RPT, int kEngine>
__global__ void __launch_bounds__(kMaxThreads)
packet_v1_kernel(const V1Args a) {
  __shared__ __align__(16) float4 buf[kEngine == kResident ? 1
                                                           : 2 * kWinUsedF4];
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
    if constexpr (kEngine == kWide) {
      const float* row = a.table + (size_t)node * 128;
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
          nl += stream_leaf<RPT>(a, (int)c[7], (int)c[8], buf, ray, on, bt,
                                 bs);
          t_upper = tile_t_upper<RPT>(bt, on, red);
        }
      }
      __syncthreads();  // the pushes are visible before the next pop
      continue;
    }
    const float* f = a.table + (size_t)node * 16;
    float t_en, t_ex;
    box_interval(f, f + 3, B, &t_en, &t_ex);
    if (!(t_en <= t_ex && t_ex > 0.f && t_en <= t_upper)) continue;
    const int flags = (int)f[7];
    if (flags >= 4) {  // leaf
      if constexpr (kEngine == kResident) {
        resident_leaf<RPT>(a, (int)f[10], (int)f[11], ray, bt, bs);
        ++nl;
      } else {
        nl += stream_leaf<RPT>(a, (int)f[10], (int)f[11], buf, ray, on, bt,
                               bs);
      }
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

template <int RPT>
int launch_rpt(const V1Args& a, int engine, cudaStream_t stream) {
  const int n_tiles = a.n_rays / a.tile;
  const int threads = a.tile / RPT;
  if (engine == kResident)
    packet_v1_kernel<RPT, kResident><<<n_tiles, threads, 0, stream>>>(a);
  else if (engine == kStream)
    packet_v1_kernel<RPT, kStream><<<n_tiles, threads, 0, stream>>>(a);
  else
    packet_v1_kernel<RPT, kWide><<<n_tiles, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K6a (engine 0), K6b (1) or K9 (2). table: [M, 16] f32 binary nodes
// (node_table[:, :16]) for engines 0 and 1, [S, 128] f32 supernodes for 2;
// recs: [n_recs, 16] f32 records (v0, e1, e2, tri_id), padded to a multiple
// of 8 and at least 128 for engines 1 and 2; both 16-byte aligned; orig_t,
// dir_t: [3, n_rays] f32 tile-major. Outputs best_t [n_rays] f32, best_slot
// [n_rays] i32 (-1 on a miss), stats [n_rays / tile, 5] i32, and overflow
// [1] i32 (zeroed by the caller; set to 1 when a stack overflows). tile: a
// multiple of 32 up to 4096, with tile / 512 rays per thread above 512.
// Returns cudaGetLastError() after the launch.
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
  const int rpt = tile <= kMaxThreads ? 1 : tile / kMaxThreads;
  if (rpt * (tile / rpt) != tile) return (int)cudaErrorInvalidValue;
  switch (rpt) {
    case 1: return launch_rpt<1>(a, engine, s);
    case 2: return launch_rpt<2>(a, engine, s);
    case 4: return launch_rpt<4>(a, engine, s);
    case 8: return launch_rpt<8>(a, engine, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
