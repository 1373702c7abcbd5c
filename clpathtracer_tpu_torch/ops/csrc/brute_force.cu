// W2: the nearest hit of every ray over every triangle, for Hopper (sm_90a).
//
// Replaces clpathtracer_tpu/ops/intersect.py::nearest_hit_bruteforce's
// triangle scan, which is XLA in the JAX package (a dense [N, F] broadcast),
// not a Pallas kernel. It carries the port's flat scan (no windows, no
// tree) and is its in-package oracle.
//
// One ray a thread, kThreads threads a block. A block's rays scan the
// records of one split of the triangle range in tiles of kTile records,
// each tile staged in shared memory (cols 0-11 of a record, three float4s)
// with cp.async in a ring of two tiles: the next tile is copied while this
// one is tested, one barrier a tile. Each thread tests every staged record
// against its ray with mt_hit_uv (pair_tests.cuh: Moller-Trumbore, det >
// 0); a hit counts when its t > t_min_eps and t < BIG. The winner is the
// least t and, on equal t, the last record in index order (the reference's
// `t <= minHit`, src/kernel.cl:344; the JAX package's last argmin): within
// a ray's scan by <=, across the splits by an atomicMin on the key (t's
// bits << 32 | ~record), t > 0 so its bits order as the floats do. When
// there are few rays the triangles are split over more blocks, so that the
// card fills; many rays take one split. A second kernel resolves each key:
// t, u and v from mt_hit_uv on the winner again (the same arithmetic, the
// same values), BIG, -1, 0, 0 on a miss.
//
// The plain version is ops/intersect.py::brute_force_reference (chunked
// torch ops, the last minimum of a chunk taken on <= over the chunks
// before); its outputs equal this kernel's exactly (__f*_rn, built with
// --fmad=false). What bounds it: the MT operations, every ray against every
// triangle.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::mt_hit_uv;

constexpr int kThreads = 256;   // threads a block
constexpr int kTile = 256;      // records staged at a time
constexpr float kBig = 3.4e38f;
constexpr int kRecF4 = 4;       // float4s per 16-float record
constexpr int kUsedF4 = 3;      // float4s staged per record (cols 0-11)
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ Ray load_ray(const float* orig, const float* dir,
                                        int i) {
  Ray ray;
  ray.ox = orig[3 * i];
  ray.oy = orig[3 * i + 1];
  ray.oz = orig[3 * i + 2];
  ray.dx = dir[3 * i];
  ray.dy = dir[3 * i + 1];
  ray.dz = dir[3 * i + 2];
  return ray;
}

// Copy records [start, start + cnt) (cols 0-11) into a tile buffer.
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float4* __restrict__ recs,
                                           int start, int cnt) {
  for (int e = threadIdx.x; e < cnt * kUsedF4; e += kThreads)
    clpt::cp_async16(dst + e, recs + (size_t)(start + e / kUsedF4) * kRecF4 +
                                  e % kUsedF4);
  clpt::cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
brute_force_scan(const float4* __restrict__ recs,
                 const float* __restrict__ orig,
                 const float* __restrict__ dir,
                 unsigned long long* __restrict__ key, int n, int f,
                 int per_split, float eps) {
  __shared__ float4 tile[2][kTile * kUsedF4];
  // the thread's ray (a thread past the last ray repeats ray n - 1 and
  // writes nothing)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const Ray ray = load_ray(orig, dir, min(i, n - 1));
  float best_t = kBig;
  int best = -1;
  const int lo = blockIdx.y * per_split;
  const int hi = min(f, lo + per_split);
  const int tiles = (hi - lo + kTile - 1) / kTile;
  stage_tile(tile[0], recs, lo, min(kTile, hi - lo));
  for (int k = 0; k < tiles; ++k) {
    const int start = lo + k * kTile;
    const int cnt = min(kTile, hi - start);
    clpt::cp_async_wait<0>();
    // tile k is in for every thread, and every thread is done with tile
    // k - 1, whose buffer takes tile k + 1 next
    __syncthreads();
    if (k + 1 < tiles)
      stage_tile(tile[(k + 1) & 1], recs, start + kTile,
                 min(kTile, hi - start - kTile));
    const float4* buf = tile[k & 1];
    for (int j = 0; j < cnt; ++j) {
      float t, u, v;
      if (mt_hit_uv(ray, buf[kUsedF4 * j], buf[kUsedF4 * j + 1],
                    buf[kUsedF4 * j + 2], &t, &u, &v) &&
          t > eps && t < kBig && t <= best_t) {
        best_t = t;
        best = start + j;
      }
    }
  }
  if (i < n && best >= 0)
    atomicMin(key + i, ((unsigned long long)__float_as_uint(best_t) << 32) |
                           (0xFFFFFFFFull - (unsigned)best));
}

__global__ void __launch_bounds__(kThreads)
brute_force_resolve(const float4* __restrict__ recs,
                    const float* __restrict__ orig,
                    const float* __restrict__ dir,
                    const unsigned long long* __restrict__ key,
                    float* __restrict__ out_t, int* __restrict__ out_prim,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = key[i];
  float t = kBig, u = 0.f, v = 0.f;
  int prim = -1;
  if (k != kNone) {
    prim = (int)(0xFFFFFFFFull - (k & 0xFFFFFFFFull));
    const float4* rec = recs + (size_t)prim * kRecF4;
    mt_hit_uv(load_ray(orig, dir, i), rec[0], rec[1], rec[2], &t, &u, &v);
  }
  out_t[i] = t;
  out_prim[i] = prim;
  out_u[i] = u;
  out_v[i] = v;
}

}  // namespace

// W2. recs: [f, 16] f32 records (v0, e1, e2, tri_id, pad) in index order;
// orig, dir: [n, 3] f32; key: [n] u64 scratch; eps_bits: t_min_eps's f32
// bits. Outputs out_t [n] f32, out_prim [n] i32 (the record's row, -1),
// out_u, out_v [n] f32. Returns the first CUDA error, else
// cudaGetLastError() after the launches.
extern "C" int brute_force_launch(const void* recs, const void* orig,
                                  const void* dir, void* key, void* out_t,
                                  void* out_prim, void* out_u, void* out_v,
                                  int n, int f, int eps_bits, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(key, 0xFF, sizeof(unsigned long long) * n, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kThreads - 1) / kThreads;
  if (f > 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    // enough blocks for 4 a multiprocessor, never a split under one tile
    const int tiles = (f + kTile - 1) / kTile;
    int splits = (4 * sms + blocks - 1) / blocks;
    splits = std::max(1, std::min(splits, tiles));
    const int per_split = ((tiles + splits - 1) / splits) * kTile;
    splits = (f + per_split - 1) / per_split;
    float eps;
    std::memcpy(&eps, &eps_bits, sizeof eps);
    brute_force_scan<<<dim3((unsigned)blocks, (unsigned)splits), kThreads, 0,
                       s>>>(static_cast<const float4*>(recs),
                            static_cast<const float*>(orig),
                            static_cast<const float*>(dir),
                            static_cast<unsigned long long*>(key), n, f,
                            per_split, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  brute_force_resolve<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float4*>(recs), static_cast<const float*>(orig),
      static_cast<const float*>(dir),
      static_cast<const unsigned long long*>(key),
      static_cast<float*>(out_t), static_cast<int*>(out_prim),
      static_cast<float*>(out_u), static_cast<float*>(out_v), n);
  return (int)cudaGetLastError();
}

// W2's launch shape into out[6]: threads a block, rays a thread, blocks of
// the scan resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers a thread, static shared memory and local (spill) bytes a thread.
// Returns a CUDA error or 0.
extern "C" int brute_force_shape(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, brute_force_scan);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                      brute_force_scan,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = 1;   // rays a thread
  out[2] = blocks;
  out[3] = fa.numRegs;
  out[4] = (int)fa.sharedSizeBytes;
  out[5] = (int)fa.localSizeBytes;
  return 0;
}
