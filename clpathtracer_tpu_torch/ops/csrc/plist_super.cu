// Super-list packet kernel for Hopper (sm_90a), in two forms that share one
// stream loop:
//
//   K1  (shared-origin, SO): plist_super_launch. Replaces the TPU kernel
//       clpathtracer_tpu/ops/plist.py::_kernel_plist_super with so=True
//       (the primary-ray gates of traverse_plist).
//   K1' (general Moller-Trumbore, MT): plist_super_mt_launch. Replaces the
//       same TPU kernel with so=False, the form that traverse_plist_bundle
//       runs on sorted 512-ray bounce bundles (and traverse_plist without
//       SO tables). Per-lane origins and per-lane t0 seeds.
//
// Both compute what the TPU kernel computes, not its schedule: for every
// 512-ray gate or bundle, stream its sorted super list, test every needed
// window of each super densely against all 512 rays, and stop as soon as
// the next super's conservative entry key exceeds the gate's t_upper.
//
// Design: one block per gate, 512 threads, one ray per thread. A thread
// keeps its ray (direction; origin in the MT form), t0, best t and best slot
// in registers. For every need bit of the current super the block copies
// that window's records (win_rows*8 records; cols 0-11 of each 16-float
// record, of which 0-9 are used) into shared memory, synchronises, and each
// thread tests every record with the SO or MT pair test of pair_tests.cuh
// (shared with K3).
// After each super a block max-reduction of min(best t, t0) refreshes
// t_upper (the JAX package's default cadence); the loop goes on while the
// next entry exists and its key <= t_upper, and starts only if
// key[0] <= min(BIG, max t0). Culled windows carry key +inf, so the stream
// stops at the first +inf entry. A bundle whose lanes are all dead (t0 = 0)
// still streams the supers whose key is exactly 0, as the TPU kernel does.
//
// Tie rule: lexicographic (min t, then min slot) over every tested pair.
// It is independent of the order of the tests, so each form agrees exactly
// with its plain torch version (ops/plist.py::plist_super_reference,
// plist_super_mt_reference). The TPU kernel's accumulator order picks another
// winner only at exact-t ties, which are a documented freedom
// (clpathtracer_tpu/ops/packet.py:21-25).
//
// Rounding: the tests use __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__frcp_rn,
// which are never contracted into FMA, in the order the plain versions use,
// and the library is built with --fmad=false, so every product, sum,
// quotient and reciprocal rounds as in the plain torch versions. The MT form
// computes invd once per pair and multiplies by it, as _mt_chunk_math does.
//
// What bounds them on this card: FP32 issue in the dense test, with every
// thread reading the same shared-memory record as a broadcast. SO: about 22
// FP32 instructions per ray-triangle pair (9 mul, 8 add, 2 max, 3 compares).
// MT: 53 FP32 operations per pair on the full path (27 mul, 18 add or sub,
// 7 compares, 1 reciprocal; the reciprocal is a several-instruction IEEE
// sequence), and 15, 27 or 45 on the pairs that the det, u or v branch
// rejects (mt_hit).
// Besides, the __syncthreads and the load latency of each window, which
// nothing hides yet. Making them fast is later work: cp.async/TMA
// double-buffering of windows, several gates per block, persistent blocks.

#include <climits>
#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::mt_hit;
using clpt::so_hit;

constexpr int kGate = 512;     // rays per gate = threads per block
constexpr int kSuper = 16;     // windows per super
constexpr int kRecF4 = 4;      // float4s per 16-float record in memory
constexpr int kUsedF4 = 3;     // float4s loaded per record (cols 0-11)
constexpr float kBig = 3.4e38f;

// Max of v over the block; every thread gets the result. `red` holds one
// float per warp. Callers are block-uniform.
__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red[] is free: every thread read the previous result
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kGate / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

template <bool kMT>
__global__ void __launch_bounds__(kGate)
plist_super_kernel(const float* __restrict__ key, const int* __restrict__ sid,
                   const int* __restrict__ bits,
                   const float4* __restrict__ rows,
                   const float* __restrict__ orig_t,
                   const float* __restrict__ dir_t,
                   const float* __restrict__ t0, float* __restrict__ best_t,
                   int* __restrict__ best_slot, int* __restrict__ stats,
                   int n_rays, int list_len, int win_rows) {
  extern __shared__ float4 win[];  // [win_tris * kUsedF4]
  __shared__ float red[kGate / 32];

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int ray_i = g * kGate + lane;
  Ray ray;
  ray.dx = dir_t[ray_i];
  ray.dy = dir_t[n_rays + ray_i];
  ray.dz = dir_t[2 * n_rays + ray_i];
  if (kMT) {
    ray.ox = orig_t[ray_i];
    ray.oy = orig_t[n_rays + ray_i];
    ray.oz = orig_t[2 * n_rays + ray_i];
  } else {
    ray.ox = ray.oy = ray.oz = 0.f;  // folded into the SO records
  }
  const float t0r = t0[ray_i];
  const int win_tris = win_rows * 8;
  const float* gkey = key + (size_t)g * list_len;
  const int* gsid = sid + (size_t)g * list_len;
  const int* gbits = bits + (size_t)g * list_len;

  float bt = kBig;
  int bs = INT_MAX;
  int ns = 0, nw = 0;
  float tup = fminf(kBig, block_max(t0r, red));
  bool alive = list_len > 0 && gkey[0] <= tup;
  for (int j = 0; alive;) {
    const long long s = gsid[j];
    const unsigned b = (unsigned)gbits[j];
    for (int k = 0; k < kSuper; ++k) {
      if (!((b >> k) & 1u)) continue;
      const long long rec0 = (s * kSuper + k) * win_tris;
      __syncthreads();  // every thread is done with the previous window
      for (int i = lane; i < win_tris * kUsedF4; i += kGate)
        win[i] = rows[(rec0 + i / kUsedF4) * kRecF4 + i % kUsedF4];
      __syncthreads();
      for (int r = 0; r < win_tris; ++r) {
        const float4 p = win[r * kUsedF4];
        const float4 q = win[r * kUsedF4 + 1];
        const float4 w = win[r * kUsedF4 + 2];
        float tt;
        if (kMT ? mt_hit(ray, p, q, w, &tt) : so_hit(ray, p, q, w, &tt)) {
          const int slot = (int)(rec0 + r);
          if (tt < bt || (tt == bt && slot < bs)) {
            bt = tt;
            bs = slot;
          }
        }
      }
    }
    ++ns;
    nw += __popc(b);
    tup = block_max(fminf(bt, t0r), red);
    ++j;
    alive = j < list_len && gkey[j] <= tup;
  }
  best_t[ray_i] = bt;
  best_slot[ray_i] = bt < kBig ? bs : -1;
  if (lane == 0) {
    int* st = stats + 5 * g;  // the JAX tile_stats[::8, :5] columns
    st[0] = 0;
    st[1] = nw;
    st[2] = kGate;
    st[3] = ns;
    st[4] = nw;
  }
}

template <bool kMT>
int launch(const void* key, const void* sid, const void* bits,
           const void* rows, const void* orig_t, const void* dir_t,
           const void* t0, void* best_t, void* best_slot, void* stats,
           int n_gates, int list_len, int win_rows, void* stream) {
  const size_t smem = (size_t)win_rows * 8 * kUsedF4 * sizeof(float4);
  plist_super_kernel<kMT><<<n_gates, kGate, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(key), static_cast<const int*>(sid),
      static_cast<const int*>(bits), static_cast<const float4*>(rows),
      static_cast<const float*>(orig_t), static_cast<const float*>(dir_t),
      static_cast<const float*>(t0), static_cast<float*>(best_t),
      static_cast<int*>(best_slot), static_cast<int*>(stats),
      n_gates * kGate, list_len, win_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. key/sid/bits: [n_gates, list_len] f32/i32/i32, each gate's entries
// sorted by key; rows: [S, 16] f32 SO records; dir_t: [3, n_gates*512] f32;
// t0: [n_gates*512] f32. Outputs best_t [N] f32, best_slot [N] i32 (-1 on a
// miss), stats [n_gates, 5] i32. Returns cudaGetLastError() after the
// launch; a refused launch (resources, configuration) shows only there.
extern "C" int plist_super_launch(const void* key, const void* sid,
                                  const void* bits, const void* rows,
                                  const void* dir_t, const void* t0,
                                  void* best_t, void* best_slot, void* stats,
                                  int n_gates, int list_len, int win_rows,
                                  void* stream) {
  return launch<false>(key, sid, bits, rows, nullptr, dir_t, t0, best_t,
                       best_slot, stats, n_gates, list_len, win_rows, stream);
}

// K1'. As plist_super_launch, with rows the raw [S, 16] triangle records
// (v0, e1, e2, tri_id) and orig_t [3, n_gates*512] f32 per-lane origins.
extern "C" int plist_super_mt_launch(const void* key, const void* sid,
                                     const void* bits, const void* rows,
                                     const void* orig_t, const void* dir_t,
                                     const void* t0, void* best_t,
                                     void* best_slot, void* stats,
                                     int n_gates, int list_len, int win_rows,
                                     void* stream) {
  return launch<true>(key, sid, bits, rows, orig_t, dir_t, t0, best_t,
                      best_slot, stats, n_gates, list_len, win_rows, stream);
}
