// K8: the plane-form kd-tree packet kernel for Hopper (sm_90a). Replaces the
// TPU kernel clpathtracer_tpu/ops/packet_mxu.py::_kernel_mxu (wrapper
// packet_call_mxu), the engine traverse_packet runs for engine="mxu".
//
// What it computes, per packet tile of `tile` rays: K3's interval walk of
// the kd-tree (packet_stream.cu, kd_walk.cuh: the packet bounds over the
// active lanes, far child pushed first, t_upper the largest best t over the
// active lanes after a leaf on every 4th pop, empty leaves included), with
// no window cull and no shared-origin form. A leaf streams the 128-triangle
// chunks c0 + b, c0 = 4 q / 128 for the quad start q, clamped to
// n_chunks - 1, for b < ceil((4 q + count) / 128) - c0 (the host computes
// the range, ops/packet_mxu.py::mxu_nodes), so other leaves' triangles in a
// shared chunk are tested too and their hits count, as in the TPU kernel.
// Each chunk's Moller-Trumbore test is a bilinear form in the ray features
// F = [d, o, o x d, 1] (each o x d component's products rounded
// separately) and the chunk's coefficient rows ([16, 512] feature-major:
// det, u*det, v*det, t*det for 128 triangles, ops/packet_mxu.py::
// mxu_rows_from_quads):
//     det = F . c_det,  ud = F . c_u,  vd = F . c_v,  td = F . c_t,
// each a sum of feature x coefficient in feature order, rounded after every
// operation (__fmul_rn, __fadd_rn), skipping the feature rows that are zero
// by construction (c_det: rows 0-2; c_u, c_v: rows 0-2 and 6-8; c_t: rows
// 3-5 and row 9, whose feature is 1); adding a +-0 changes no comparison.
// Accept: det > 0, ud >= 0, ud <= det, vd >= 0, ud + vd <= det, td > 0, an
// active lane; t = td / det (one __fdiv_rn). Ties: within a chunk the least
// t, the lowest slot among equal t; across chunks the later chunk wins at
// equal t. Slot = 128 c + lane, the row of the [T, 16] records. Stats per
// tile: node pops, chunks, active lanes, 0, 0. The plain torch version
// (ops/packet_mxu.py::packet_mxu_reference) replays the same sums in the
// same order as elementwise ops and agrees exactly in t, slot and stats.
//
// Exact FP32 on the CUDA cores, not the tensor cores: a TF32 product is not
// exact to f32 and the TPU kernel's product is (precision HIGHEST). A split
// 3xTF32 or wgmma form is later work.
//
// Design: one block per tile and the block-uniform walk of kd_walk.cuh, as
// K3; tile/RPT threads, RPT = 4 rays a thread where tile is a multiple of
// 128 (tile / 512 above 2048), else 1, so that a staged triangle's
// coefficients, read once into registers, serve several rays. A chunk's 19
// used coefficient rows (of its 64 rows of 128 floats) are copied with
// 4-byte cp.async into shared memory transposed to 20 floats a triangle (5
// float4s: det xyz + t const, u xyz + u6, u7 u8 + v xy, v z + v678, t xyz),
// double-buffered: chunk b + 1's copy is in flight while chunk b is tested;
// one commit group per chunk and thread, each waited once; an empty range
// starts no copy. Every thread reads a triangle's 5 float4s as broadcasts.
// The stack is guarded: a split whose pushes could pass 128 entries sets the
// overflow flag (the wrapper raises) and ends the walk.
//
// What bounds it on this card: FP32 issue in the plane sums, with early
// exits: 6 operations for a pair rejected at det > 0, 19 at the u test, 33
// at the v test, 42 past it (counted in chip_smoke.py's MXU_EXIT_OPS). It
// reads 76 B of coefficients a triangle where the TPU kernel streamed 256 B,
// but culls no window; besides, the walk's serial barriers and one block
// per tile.

#include <cuda_runtime.h>

#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using namespace clpt;

constexpr int kTris = 128;          // triangles per chunk
constexpr int kRows = 16;           // feature rows per chunk
constexpr int kCols = 4 * kTris;    // det, u, v, t planes
constexpr int kSegs = 19;           // used (row, plane) segments
constexpr int kCoefF4 = 5;          // float4s staged per triangle
constexpr int kChunkF4 = kTris * kCoefF4;

// staged float s of a triangle <- row kSegRow[s], plane kSegPlane[s]
__constant__ int kSegRow[kSegs] = {0, 1, 2, 9, 0, 1, 2, 6, 7, 8,
                                   0, 1, 2, 6, 7, 8, 3, 4, 5};
__constant__ int kSegPlane[kSegs] = {0, 0, 0, 3, 1, 1, 1, 1, 1, 1,
                                     2, 2, 2, 2, 2, 2, 3, 3, 3};

struct MxuArgs {
  const int4* nodes_i;     // [M]: (flags, child_lo | c0, child_hi | 0,
                           //       0 | chunks)
  const float* nodes_f;    // [6 + M]: root AABB, split value per node
  const float* chunks;     // [n_chunks * 16, 512] coefficient rows
  const float* orig_t;     // [3, n_rays]
  const float* dir_t;      // [3, n_rays]
  const float* act;        // [n_rays], > 0 for an active lane
  float* best_t;           // [n_rays]
  int* best_slot;          // [n_rays]
  int* stats;              // [n_tiles, 5]
  int* overflow;           // [1], set to 1 when a walk's stack overflows
  int n_rays, tile, n_chunks;
};

// Chunk c's used coefficients into dst (kChunkF4 float4s), transposed to
// kCoefF4 float4s a triangle: this thread's share of the 4-byte copies,
// then its commit group.
__device__ __forceinline__ void copy_chunk(float4* dst, const float* chunks,
                                           int c) {
  float* d = reinterpret_cast<float*>(dst);
  const float* src = chunks + (size_t)c * kRows * kCols;
  for (int i = threadIdx.x; i < kSegs * kTris; i += blockDim.x) {
    const int s = i / kTris, j = i % kTris;
    cp_async4(d + j * 4 * kCoefF4 + s,
              src + kSegRow[s] * kCols + kSegPlane[s] * kTris + j);
  }
  cp_async_commit();
}

// The dense plane test of one staged chunk (first slot c * 128) against
// this thread's rays, merged into (bt, bs): the chunk's least t (lowest
// slot among equal t), taken where it is <= the best so far.
template <int RPT>
__device__ __forceinline__ void dense_chunk(const float4* tri, const Ray* ray,
                                            float (*cr)[3], const bool* on,
                                            int c, float* bt, int* bs) {
  float ct[RPT];
  int cj[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    ct[k] = kBig;
    cj[k] = 0;
  }
  for (int j = 0; j < kTris; ++j) {
    const float4 A = tri[j * kCoefF4], B = tri[j * kCoefF4 + 1];
    const float4 C = tri[j * kCoefF4 + 2], D = tri[j * kCoefF4 + 3];
    const float4 E = tri[j * kCoefF4 + 4];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (!on[k]) continue;
      const Ray& r = ray[k];
      const float det = dot3(r.dx, r.dy, r.dz, A.x, A.y, A.z);
      if (!(det > 0.f)) continue;
      const float ud = __fadd_rn(
          __fadd_rn(__fadd_rn(dot3(r.dx, r.dy, r.dz, B.x, B.y, B.z),
                              __fmul_rn(cr[k][0], B.w)),
                    __fmul_rn(cr[k][1], C.x)),
          __fmul_rn(cr[k][2], C.y));
      if (!(ud >= 0.f && ud <= det)) continue;
      const float vd = __fadd_rn(
          __fadd_rn(__fadd_rn(dot3(r.dx, r.dy, r.dz, C.z, C.w, D.x),
                              __fmul_rn(cr[k][0], D.y)),
                    __fmul_rn(cr[k][1], D.z)),
          __fmul_rn(cr[k][2], D.w));
      if (!(vd >= 0.f && __fadd_rn(ud, vd) <= det)) continue;
      const float td = __fadd_rn(dot3(r.ox, r.oy, r.oz, E.x, E.y, E.z), A.w);
      if (!(td > 0.f)) continue;
      const float t = __fdiv_rn(td, det);
      if (t < ct[k]) {  // ascending slots: the lowest wins at equal t
        ct[k] = t;
        cj[k] = j;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (ct[k] < kBig && ct[k] <= bt[k]) {  // the later chunk wins ties
      bt[k] = ct[k];
      bs[k] = c * kTris + cj[k];
    }
}

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
packet_mxu_kernel(const MxuArgs a) {
  __shared__ __align__(16) float4 buf[2 * kChunkF4];
  __shared__ int s_node[kStack];
  __shared__ float s_tlo[kStack], s_thi[kStack];
  __shared__ float red[kMaxThreads / 32];
  __shared__ int ired[kMaxThreads / 32];
  __shared__ Bounds B;

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * a.tile;

  Ray ray[RPT];
  bool on[RPT];
  float bt[RPT];
  int bs[RPT];
  float cr[RPT][3];  // o x d, each product rounded
  load_rays<RPT>(a.orig_t, a.dir_t, a.act, a.n_rays, base, ray, on, bt, bs);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const Ray& r = ray[k];
    cr[k][0] = crs(r.oy, r.dz, r.oz, r.dy);
    cr[k][1] = crs(r.oz, r.dx, r.ox, r.dz);
    cr[k][2] = crs(r.ox, r.dy, r.oy, r.dx);
  }
  const int n_act = packet_bounds<RPT>(ray, on, B, red, ired);
  int sp = push_root(a.nodes_f, B, n_act, s_node, s_tlo, s_thi);

  float t_upper = kBig;
  int nv = 0, nl = 0;
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
    if (nd.x >= 4) {  // leaf: its chunk range, none culled
      const int c0 = nd.y, nch = nd.w;
      if (nch > 0) copy_chunk(buf, a.chunks, min(c0, a.n_chunks - 1));
      for (int b = 0; b < nch; ++b) {
        if (b + 1 < nch) {
          copy_chunk(buf + ((b + 1) & 1) * kChunkF4, a.chunks,
                     min(c0 + b + 1, a.n_chunks - 1));
          cp_async_wait<1>();  // chunk b's group is complete, b + 1's flies
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // every thread's part of chunk b has landed
        dense_chunk<RPT>(buf + (b & 1) * kChunkF4, ray, cr, on,
                         min(c0 + b, a.n_chunks - 1), bt, bs);
        __syncthreads();  // every thread is done with it before its reuse
      }
      nl += nch;
      if ((nv & kTupMask) == 0) t_upper = tile_t_upper<RPT>(bt, on, red);
    } else {  // split: far child first, then the near child
      sp = push_children(B, nd, a.nodes_f[6 + node], tlo, thi, t_upper, sp,
                         s_node, s_tlo, s_thi);
      if (sp < 0) {
        overflow = true;
        break;
      }
    }
  }
  if (overflow && tid == 0) *a.overflow = 1;

  store_tile<RPT>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv, nl,
                  n_act, 0, 0);
}

template <int RPT>
int launch_rpt(const MxuArgs& a, cudaStream_t stream) {
  packet_mxu_kernel<RPT><<<a.n_rays / a.tile, a.tile / RPT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K8. nodes_i: [M, 4] i32 (ops/packet_mxu.py::mxu_nodes); nodes_f: [6 + M]
// f32; chunks: [n_chunks * 16, 512] f32 (mxu_rows_from_quads); orig_t,
// dir_t: [3, n_rays] f32 tile-major; act: [n_rays] f32. Outputs best_t
// [n_rays] f32, best_slot [n_rays] i32 (-1 on a miss), stats
// [n_rays / tile, 5] i32, and overflow [1] i32 (zeroed by the caller; set to
// 1 when a stack overflows). tile: a multiple of 32 up to 4096 and of 512
// above 512. Returns cudaGetLastError() after the launch.
extern "C" int packet_mxu_launch(const void* nodes_i, const void* nodes_f,
                                 const void* chunks, const void* orig_t,
                                 const void* dir_t, const void* act,
                                 void* best_t, void* best_slot, void* stats,
                                 void* overflow, int n_rays, int tile,
                                 int n_chunks, void* stream) {
  MxuArgs a;
  a.nodes_i = static_cast<const int4*>(nodes_i);
  a.nodes_f = static_cast<const float*>(nodes_f);
  a.chunks = static_cast<const float*>(chunks);
  a.orig_t = static_cast<const float*>(orig_t);
  a.dir_t = static_cast<const float*>(dir_t);
  a.act = static_cast<const float*>(act);
  a.best_t = static_cast<float*>(best_t);
  a.best_slot = static_cast<int*>(best_slot);
  a.stats = static_cast<int*>(stats);
  a.overflow = static_cast<int*>(overflow);
  a.n_rays = n_rays;
  a.tile = tile;
  a.n_chunks = n_chunks;
  if (tile <= 0 || tile % 32 || tile > 8 * kMaxThreads || n_rays % tile ||
      (tile > kMaxThreads && tile % kMaxThreads) || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpt = tile % 128 ? 1 : tile <= 4 * kMaxThreads ? 4 : 8;
  switch (rpt) {
    case 1: return launch_rpt<1>(a, s);
    case 4: return launch_rpt<4>(a, s);
    default: return launch_rpt<8>(a, s);
  }
}
