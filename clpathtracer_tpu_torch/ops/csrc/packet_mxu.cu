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
// Design: K3's cluster walk (packet_stream.cu). A tile that is a multiple
// of 256 rays runs on a thread-block cluster of kCluster = 8 blocks
// (cluster.cuh), each block an eighth of the tile's lanes, kRays of them a
// thread where the block's lanes fill whole warps so (else one), with
// kSplit neighbouring threads a lane (share h tests triangles h, h +
// kSplit, ... of a chunk); a smaller tile, or one that is not a multiple
// of 256, runs on one block with one thread a lane. A triangle's
// coefficients, read once into registers, serve the thread's rays. The
// shipped shape, kSplit = 2 and kRays = 1, was the fastest of (threads a
// lane, rays a thread) = (2, 1), (1, 2), (2, 2), (1, 4) on every input
// and on the heaviest mirror tile alone (probes/probe_k8_schedule.py, which
// builds the others from this source; PERF.md): two threads a lane keep
// 16 warps a block, where more rays a thread leave 2-8. Every
// block runs the same walk on its own stack in shared memory; the packet
// bounds, the active count and every t_upper refresh are reduced over the
// whole cluster (cluster_bounds, cluster_t_upper), so every block pops the
// same nodes and streams the same chunks, and the stack guard's decision
// is the same in every block; rank 0 writes the stats row, and the last
// cluster barrier keeps every block until its peers have read its shared
// memory. A chunk's 19 used coefficient rows (of its 64 rows of 128
// floats) are copied with 4-byte cp.async into shared memory transposed to
// 20 floats a triangle (5 float4s: det xyz + t const, u xyz + u6, u7 u8 +
// v xy, v z + v678, t xyz), through a ring of kRing = 4 chunks (40 KB of
// dynamic shared memory, its limit raised) with three copies in flight
// while one is tested (kd_walk.cuh::ring_stream); a block without an
// active lane stages and tests nothing. Every thread reads a triangle's 5
// float4s as broadcasts. The shares of a lane merge by the chunk's rule
// (the least t, the lowest slot among equal t) before the chunk's winner
// meets the best so far (dense_chunk). The stack is guarded: a split whose
// pushes could pass 128 entries sets the overflow flag (the wrapper
// raises) and ends the walk.
//
// What bounds it on this card: FP32 issue in the plane sums, with early
// exits: 6 operations for a pair rejected at det > 0, 19 at the u test, 33
// at the v test, 42 past it (counted in chip_smoke.py's MXU_EXIT_OPS). It
// reads 76 B of coefficients a triangle where the TPU kernel streamed 256 B,
// but culls no window. On one block a 2048-ray tile ran on one SM, and a
// mirror wave took as long as its heaviest tile; on a cluster it runs on 8
// SMs. The walk's barriers and node reads stay serial per tile, repeated
// by every block of the cluster.

#include <cuda_runtime.h>

#include "cluster.cuh"
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
constexpr int kRingBytes = kRing * kChunkF4 * (int)sizeof(float4);
constexpr int kCluster = 8;  // blocks per tile (tiles of 256k rays)
constexpr int kSplit = 2;  // threads a lane on a cluster
constexpr int kRays = 1;  // rays a thread on a cluster
// (probes/probe_k8_schedule.py rebuilds the kernel at other kSplit and
// kRays, changing the two lines above)

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
// this thread's rays, kS threads a lane (neighbours in a warp): share h
// tests triangles h, h + kS, ... in ascending order and keeps the least t,
// the lowest triangle among equal t (a later one only where its t is
// less); the shares merge by the lower t, then the lower triangle (warp
// shuffles), into the chunk's winner under the same rule; it is taken
// where t <= the best so far, so the later chunk wins ties. Every thread
// of the lane holds the result.
template <int RPT, int kS>
__device__ __forceinline__ void dense_chunk(const float4* tri, const Ray* ray,
                                            float (*cr)[3], const bool* on,
                                            int c, float* bt, int* bs) {
  float ct[RPT];
  int cj[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    ct[k] = kBig;
    cj[k] = kTris;
  }
  for (int j = threadIdx.x % kS; j < kTris; j += kS) {
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
      if (t < ct[k]) {  // ascending triangles: the lowest wins at equal t
        ct[k] = t;
        cj[k] = j;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
#pragma unroll
    for (int off = 1; off < kS; off <<= 1) {
      const float t2 = __shfl_xor_sync(0xffffffffu, ct[k], off);
      const int j2 = __shfl_xor_sync(0xffffffffu, cj[k], off);
      if (t2 < ct[k] || (t2 == ct[k] && j2 < cj[k])) {
        ct[k] = t2;
        cj[k] = j2;
      }
    }
    if (ct[k] < kBig && ct[k] <= bt[k]) {  // the later chunk wins ties
      bt[k] = ct[k];
      bs[k] = c * kTris + cj[k];
    }
  }
}

// kC blocks per tile (a cluster), each owning tile / kC consecutive lanes,
// RPT of them per group of kS neighbouring threads (lane rank * tile / kC +
// tid / kS + k * threads / kS). Held to 64 registers.
template <int kC, int kS, int RPT>
__global__ void __launch_bounds__(2 * kMaxThreads)
packet_mxu_kernel(const MxuArgs a) {
  extern __shared__ float4 ring[];  // [kRing][kChunkF4]
  __shared__ int s_node[kStack];
  __shared__ float s_tlo[kStack], s_thi[kStack];
  __shared__ ClusterSlots<12> sb;
  __shared__ ClusterSlots<1> s1;
  __shared__ Bounds B;

  const int rank = cluster_rank();
  const int tid = threadIdx.x;
  const size_t base = (size_t)(blockIdx.x / kC) * a.tile +
                      (size_t)rank * (a.tile / kC);

  Ray ray[RPT];
  bool on[RPT];
  float bt[RPT];
  int bs[RPT];
  float cr[RPT][3];  // o x d, each product rounded
  load_rays<RPT, kS>(a.orig_t, a.dir_t, a.act, a.n_rays, base, ray, on, bt,
                     bs);
  bool any_on = false;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const Ray& r = ray[k];
    cr[k][0] = crs(r.oy, r.dz, r.oz, r.dy);
    cr[k][1] = crs(r.oz, r.dx, r.ox, r.dz);
    cr[k][2] = crs(r.ox, r.dy, r.oy, r.dx);
    any_on = any_on || on[k];
  }
  int par_b = 0, par1 = 0;
  const int n_act = cluster_bounds<RPT>(ray, on, tid % kS == 0, B, sb, par_b,
                                        s1, par1);
  const bool block_on = __syncthreads_or(any_on);  // an active lane here
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
      if (block_on)
        ring_stream(
            nch, ring, kChunkF4,
            [&](int b, float4* dst) {
              copy_chunk(dst, a.chunks, min(c0 + b, a.n_chunks - 1));
            },
            [&](int b, const float4* tri) {
              dense_chunk<RPT, kS>(tri, ray, cr, on,
                                   min(c0 + b, a.n_chunks - 1), bt, bs);
            });
      nl += nch;
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
  // every thread of a group holds its lane's winner
  store_tile<RPT, kS, kC>(bt, bs, base, a.best_t, a.best_slot, a.stats, nv,
                          nl, n_act, 0, 0);
  cluster_end();
}

using MxuKernel = void (*)(const MxuArgs);

// The launch shape of K8 at `tile`: blocks per cluster (kCluster when the
// tile is a multiple of 32 * kCluster, so that each block's lanes are whole
// warps; else 1), threads per block (on a cluster kSplit a lane and kRays
// lanes a thread where the block's lanes make whole warps of such threads,
// else one; one thread a lane on one block); the kernel instance, null for
// a tile it does not take (a multiple of 32 up to 4096, and up to 512 on
// one block). K3's and K6b's rule.
MxuKernel mxu_shape(int tile, int* c, int* threads) {
  if (tile <= 0 || tile % 32 || tile > kCluster * kMaxThreads)
    return nullptr;
  if (tile % (32 * kCluster) == 0) {
    const int lanes = tile / kCluster;
    *c = kCluster;
    if (lanes % (32 * kRays) == 0) {
      *threads = lanes / kRays * kSplit;
      return packet_mxu_kernel<kCluster, kSplit, kRays>;
    }
    *threads = lanes * kSplit;
    return packet_mxu_kernel<kCluster, kSplit, 1>;
  }
  if (tile > kMaxThreads) return nullptr;
  *c = 1;
  *threads = tile;
  return packet_mxu_kernel<1, 1, 1>;
}

// The ring's dynamic shared memory: the default limit leaves out the
// static shared memory, so it is raised for every instance.
cudaError_t allow_ring(MxuKernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
}

}  // namespace

// K8. nodes_i: [M, 4] i32 (ops/packet_mxu.py::mxu_nodes); nodes_f: [6 + M]
// f32; chunks: [n_chunks * 16, 512] f32 (mxu_rows_from_quads); orig_t,
// dir_t: [3, n_rays] f32 tile-major; act: [n_rays] f32. Outputs best_t
// [n_rays] f32, best_slot [n_rays] i32 (-1 on a miss), stats
// [n_rays / tile, 5] i32, and overflow [1] i32 (zeroed by the caller; set to
// 1 when a stack overflows). tile: a multiple of 32 up to 4096; a multiple
// of 256 runs as a cluster of 8 blocks, each an eighth of its lanes, a
// smaller one (up to 512) as one block. Returns the launch's error, else
// cudaGetLastError(): a refused cluster launch shows there.
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
  if (tile <= 0 || n_rays % tile || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  int c, threads;
  const MxuKernel kernel = mxu_shape(tile, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaError_t err = allow_ring(kernel);
  if (err != cudaSuccess) return (int)err;
  return launch_cluster(kernel, c, n_rays / tile * c, threads, kRingBytes,
                        static_cast<cudaStream_t>(stream), a);
}

// The shape of K8's launch at `tile`, as clpt::cluster_shape writes it into
// out[6]: blocks per cluster, threads per block, the clusters resident at
// once, registers per thread, static and dynamic shared memory bytes per
// block. Returns a CUDA error or 0 (cudaErrorInvalidValue for a tile the
// kernel does not take).
extern "C" int packet_mxu_shape(int tile, int* out) {
  int c, threads;
  const MxuKernel kernel = mxu_shape(tile, &c, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_ring(kernel);
  if (err != cudaSuccess) return (int)err;
  return cluster_shape(kernel, c, threads, kRingBytes, out);
}
