// Sub-gate list kernel K11 for Hopper (sm_90a): plist_subgate_launch (SO)
// and plist_subgate_mt_launch (general Moller-Trumbore). Replaces the TPU
// kernel clpathtracer_tpu/ops/plist.py::_kernel_plist4 (traverse_plist4).
//
// What it computes: each 512-ray super-gate (a 16x32 pixel block) holds four
// 128-ray sub-gates of 8x16 pixels (ops/packet.py::_blockify_strips order:
// lanes 128s..128s+127 are sub-gate s). The gate's list is one shared
// sorted list of windows, entry j = (key, wid << 4 | need bits): bit s says
// that sub-gate s must test window wid, and key is the least entry
// distance over the sub-gates that need it. Each sub-gate keeps its own
// cursor into that list and its own t_upper (the largest best t of its 128
// rays): it takes the next entry that it needs, and it stops at the first
// entry whose key is above its t_upper, needed or not (the keys are
// sorted, so every later entry it needs lies beyond too). The decision to
// take a sub-gate's next window is made with its t_upper from before its
// current window was tested, as the TPU kernel decides its prefetch
// (plist.py:1553-1566); this keeps its stats.
//
// Stats per gate: (0, 4*ns, 512, 0, 4*ns), where ns is the largest number
// of windows any of its sub-gates tested: the TPU kernel steps its four
// sub-gates in lockstep, ns steps, the finished ones re-testing a window.
//
// Design: one block per gate, 512 threads, one ray per thread; four groups
// of 128 threads (four warps each), one per sub-gate, that advance
// independently. A group has its own shared-memory window slot, and it
// synchronises on its own named barrier (bar.sync 1+s, 128), never on the
// block's. Its cursor scan runs in every warp of the group at once, with
// the same result: 32 entries a step under __ballot_sync, reading the list
// from global memory, where L2 keeps it (4 B key + 4 B payload per window:
// 62.6 KB per gate for the 1M terrain's 7,824 windows). A window's records
// (cols 0-11) are copied into the group's slot, then every thread tests
// them with pair_tests.cuh's so_hit or mt_hit, then a group max-reduction
// refreshes the t_upper. The block synchronises once, at the end, for the
// stats.
//
// Tie rule: lexicographic (min t, then min slot) over every tested pair
// (pair_tests.cuh::nearest_in_window, as K1's), so the kernel agrees
// exactly with its plain torch version (ops/plist.py::
// plist_subgate_reference). The TPU kernel lets a later window win an
// exact-t tie at the same accumulator row (take = t_acc <= ta,
// plist.py:1586-1588); exact-t winners are a documented freedom
// (clpathtracer_tpu/ops/packet.py:21-25).
//
// Rounding: as K1 (plist_super.cu): __f*_rn in the plain versions' order,
// built with --fmad=false.
//
// What bounds it on this card: FP32 issue in the dense test (SO: 22
// instructions a pair; MT: 15 to 53 by its early exits), as K1; a sub-gate
// tests 128-record windows against 128 rays, so a window costs a quarter
// of K1's, with the same copy latency and two group barriers per window
// that nothing hides yet.

#include <climits>
#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::load_ray;
using clpt::nearest_in_window;

constexpr int kGate = 512;          // rays per gate = threads per block
constexpr int kSub = 4;             // sub-gates per gate
constexpr int kLanes = kGate / kSub;
constexpr int kWarps = kLanes / 32;  // warps per sub-gate
constexpr int kRecF4 = 4;           // float4s per 16-float record in memory
constexpr int kUsedF4 = 3;          // float4s loaded per record (cols 0-11)
constexpr float kBig = 3.4e38f;

// The 128 threads of sub-gate s wait for each other (barrier 0 is the
// block's __syncthreads).
__device__ __forceinline__ void group_sync(int s) {
  asm volatile("bar.sync %0, %1;" ::"r"(s + 1), "r"(kLanes) : "memory");
}

// The first list index >= j that sub-gate bit `sbit` needs with a key <=
// tup; list_len when there is none (the first key > tup ends the search).
// Called by whole warps, which all get the same result.
__device__ __forceinline__ int next_entry(const float* __restrict__ key,
                                          const int* __restrict__ pay,
                                          int list_len, int j, float tup,
                                          int sbit) {
  const int lane = threadIdx.x & 31;
  for (int base = j; base < list_len; base += 32) {
    const int i = base + lane;
    bool stop = true;  // past the end
    if (i < list_len) stop = key[i] > tup || (pay[i] & sbit) != 0;
    const unsigned m = __ballot_sync(0xffffffffu, stop);
    if (m) {
      const int f = base + __ffs(m) - 1;
      return f < list_len && key[f] <= tup ? f : list_len;
    }
  }
  return list_len;
}

template <bool kMT>
__global__ void __launch_bounds__(kGate)
plist_subgate_kernel(const float* __restrict__ key,
                     const int* __restrict__ pay,
                     const float4* __restrict__ rows,
                     const float* __restrict__ orig_t,
                     const float* __restrict__ dir_t,
                     float* __restrict__ best_t, int* __restrict__ best_slot,
                     int* __restrict__ stats, int n_rays, int list_len,
                     int win_rows) {
  extern __shared__ float4 slots[];  // [kSub][win_tris * kUsedF4]
  __shared__ float red[kGate / 32];
  __shared__ int used[kSub];

  const int g = blockIdx.x;
  const int s = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int ray_i = g * kGate + threadIdx.x;
  const Ray ray = load_ray<kMT>(orig_t, dir_t, n_rays, ray_i);
  const int win_tris = win_rows * 8;
  float4* win = slots + (size_t)s * win_tris * kUsedF4;
  const float* gkey = key + (size_t)g * list_len;
  const int* gpay = pay + (size_t)g * list_len;
  const int sbit = 1 << s;

  float bt = kBig;
  int bs = INT_MAX;
  int ns = 0;
  float tup = kBig;
  int j = next_entry(gkey, gpay, list_len, 0, tup, sbit);
  while (j < list_len) {
    // the next window against the t_upper from before window j
    const int jn = next_entry(gkey, gpay, list_len, j + 1, tup, sbit);
    const long long rec0 = (long long)(gpay[j] >> 4) * win_tris;
    for (int i = lane; i < win_tris * kUsedF4; i += kLanes)
      win[i] = rows[(rec0 + i / kUsedF4) * kRecF4 + i % kUsedF4];
    group_sync(s);
    nearest_in_window<kMT>(ray, win, win_tris, rec0, bt, bs);
    ++ns;
    // group max of the best t. After this barrier the slot is free (every
    // thread of the group has tested), and red[] is rewritten only after
    // the next iteration's barrier, which every thread passes after reading
    float v = bt;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    group_sync(s);
    tup = red[s * kWarps];
    for (int w = 1; w < kWarps; ++w) tup = fmaxf(tup, red[s * kWarps + w]);
    j = jn;
  }
  best_t[ray_i] = bt;
  best_slot[ray_i] = bt < kBig ? bs : -1;
  if (lane == 0) used[s] = ns;
  __syncthreads();
  if (threadIdx.x == 0) {
    int most = used[0];
    for (int k = 1; k < kSub; ++k) most = max(most, used[k]);
    int* st = stats + 5 * g;  // the JAX tile_stats[::8, :5] columns
    st[0] = 0;
    st[1] = kSub * most;
    st[2] = kGate;
    st[3] = 0;
    st[4] = kSub * most;
  }
}

template <bool kMT>
int launch(const void* key, const void* pay, const void* rows,
           const void* orig_t, const void* dir_t, void* best_t,
           void* best_slot, void* stats, int n_gates, int list_len,
           int win_rows, void* stream) {
  const size_t smem = (size_t)kSub * win_rows * 8 * kUsedF4 * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        plist_subgate_kernel<kMT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  plist_subgate_kernel<kMT><<<n_gates, kGate, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(key), static_cast<const int*>(pay),
      static_cast<const float4*>(rows), static_cast<const float*>(orig_t),
      static_cast<const float*>(dir_t), static_cast<float*>(best_t),
      static_cast<int*>(best_slot), static_cast<int*>(stats),
      n_gates * kGate, list_len, win_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// K11, SO form. key/pay: [n_gates, list_len] f32/i32, each gate's entries
// sorted by key, pay = window id << 4 | need bits of the four sub-gates;
// rows: [S, 16] f32 SO records, S a multiple of win_rows*8; dir_t:
// [3, n_gates*512] f32 in sub-gate order. Outputs best_t [N] f32, best_slot
// [N] i32 (-1 on a miss), stats [n_gates, 5] i32. Returns
// cudaGetLastError() after the launch.
extern "C" int plist_subgate_launch(const void* key, const void* pay,
                                    const void* rows, const void* dir_t,
                                    void* best_t, void* best_slot,
                                    void* stats, int n_gates, int list_len,
                                    int win_rows, void* stream) {
  return launch<false>(key, pay, rows, nullptr, dir_t, best_t, best_slot,
                       stats, n_gates, list_len, win_rows, stream);
}

// K11, MT form: rows the raw triangle records (v0, e1, e2, tri_id),
// orig_t [3, n_gates*512] f32 per-lane origins.
extern "C" int plist_subgate_mt_launch(const void* key, const void* pay,
                                       const void* rows, const void* orig_t,
                                       const void* dir_t, void* best_t,
                                       void* best_slot, void* stats,
                                       int n_gates, int list_len,
                                       int win_rows, void* stream) {
  return launch<true>(key, pay, rows, orig_t, dir_t, best_t, best_slot,
                      stats, n_gates, list_len, win_rows, stream);
}
