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
// Design: one block per sub-gate, 128 lanes with kSplit threads a lane (2
// in the SO form, 256 threads; 4 in the MT form, 512), each testing a
// contiguous share of every window's records; a lane's threads merge their
// winners (pair_tests.cuh::merge_split, as K1 and K2) before each t_upper,
// a block max of the lanes' merged best t (no t0, as the TPU kernel).
// Windows are staged with cp.async in a ring of two buffers a block: the
// sub-gate's next window jn, which the prefetch decision above fixes before
// window j is tested, is copied while window j is tested. Every window
// copied is tested, so the ring reads nothing extra. Two barriers a
// window: the merge, and one that both publishes the block max and lands
// window jn (each thread waits for its own copies before it). Every warp
// scans the list for itself, 32 entries a step under __ballot_sync, from
// global memory, where L2 keeps it (4 B key + 4 B payload per window: 62.6
// KB per gate for the 1M terrain's 7,824 windows), so no barrier passes
// the index on.
//
// The stats row: the four blocks of a gate run independently, so a
// sub-gate that finishes frees its SM slot at once; the launch entry
// zeroes the stats rows, and each block's thread 0 raises lanes 1 and 4 of
// its gate's row to 4*ns with atomicMax and writes lane 2. The four blocks
// as one cluster that reduces ns through cluster.cuh keep a finished
// sub-gate's 256-512 threads and ring on its SM until the slowest one
// ends, and a gate's four blocks wait to be placed together: on the 1M
// terrain and soup three of the four full launches (SO and MT) ran 3-13%
// slower so, the fourth 1% faster. Warp 0 alone scanning (and issuing
// each copy with its 32 threads), the index passed on through shared
// memory, ran within 2% of this either way, so the simpler form stays.
// probes/probe_k11_schedule.py builds both from this source and times
// them in turns (PERF.md §6).
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
// instructions a pair; MT: 15 to 53 by its early exits), as K1. A window
// is win_rows * 8 records against 128 rays, a quarter of K2's work a
// window, so the two barriers and the scan weigh four times as much; the
// soup's 64-record windows give each barrier the least work.

#include <climits>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "kd_walk.cuh"
#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::copy_recs;
using clpt::kUsedF4;  // float4s staged per record (cols 0-11)
using clpt::load_ray;
using clpt::nearest_in_window;
using clpt::ring_smem;

constexpr int kGate = 512;          // rays per gate
constexpr int kSub = 4;             // sub-gates per gate
constexpr int kLanes = kGate / kSub;  // rays of a sub-gate: lanes a block
constexpr float kBig = 3.4e38f;
// threads per lane: 256 threads a block in the SO form, 512 in the MT form
template <bool kMT>
constexpr int kSplit = kMT ? 4 : 2;

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

template <bool kMT, int kS>
__global__ void __launch_bounds__(kLanes * kS)
plist_subgate_kernel(const float* __restrict__ key,
                     const int* __restrict__ pay,
                     const float4* __restrict__ rows,
                     const float* __restrict__ orig_t,
                     const float* __restrict__ dir_t,
                     float* __restrict__ best_t, int* __restrict__ best_slot,
                     int* __restrict__ stats, int n_rays, int list_len,
                     int win_rows) {
  extern __shared__ float4 win[];  // two windows of win_tris * kUsedF4
  __shared__ float split_t[kLanes * kS];
  __shared__ int split_s[kLanes * kS];
  __shared__ float red[kLanes / 32];  // the block max: the h = 0 warps

  const int g = blockIdx.x / kSub;
  const int s = blockIdx.x % kSub;
  const int h = threadIdx.x / kLanes;
  const int ray_i = g * kGate + s * kLanes + threadIdx.x % kLanes;
  const Ray ray = load_ray<kMT>(orig_t, dir_t, n_rays, ray_i);
  const int win_tris = win_rows * 8;
  const int win_f4 = win_tris * kUsedF4;
  const int share = win_tris / kS;  // records a thread tests of a window
  const float* gkey = key + (size_t)g * list_len;
  const int* gpay = pay + (size_t)g * list_len;
  const int sbit = 1 << s;

  float bt = kBig;
  int bs = INT_MAX;
  int ns = 0;
  float tup = kBig;
  int j = next_entry(gkey, gpay, list_len, 0, tup, sbit);
  if (j < list_len)
    copy_recs(win, rows, (long long)(gpay[j] >> 4) * win_tris, win_tris);
  clpt::cp_async_wait<0>();
  __syncthreads();  // window j has landed
  int cur = 0;      // the buffer of window j
  while (j < list_len) {
    // the sub-gate's next window, against the t_upper from before window j
    // was tested: copied into the other buffer (free: its window was tested
    // before the last barrier) while window j is tested
    const int jn = next_entry(gkey, gpay, list_len, j + 1, tup, sbit);
    if (jn < list_len)
      copy_recs(win + (cur ^ 1) * win_f4, rows,
                (long long)(gpay[jn] >> 4) * win_tris, win_tris);
    nearest_in_window<kMT>(
        ray, win + cur * win_f4 + h * share * kUsedF4, share,
        (long long)(gpay[j] >> 4) * win_tris + h * share, bt, bs);
    ++ns;
    clpt::merge_split<kLanes, kS>(bt, bs, split_t, split_s);
    // the block max of the merged best t: the h = 0 warps hold every lane's
    float v = bt;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (h == 0 && (threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    clpt::cp_async_wait<0>();
    // red[] is whole and window jn has landed. red[] and split_* are
    // rewritten only after the next merge's barrier, which every thread
    // passes after reading them
    __syncthreads();
    tup = red[0];
    for (int w = 1; w < kLanes / 32; ++w) tup = fmaxf(tup, red[w]);
    j = jn;
    cur ^= 1;
  }
  if (h == 0) {  // every thread of a lane holds its merged winner
    best_t[ray_i] = bt;
    best_slot[ray_i] = bt < kBig ? bs : -1;
  }
  if (threadIdx.x == 0) {  // the JAX tile_stats[::8, :5] columns; the
    int* st = stats + 5 * g;  // launch entry zeroed the row
    atomicMax(st + 1, kSub * ns);
    st[2] = kGate;
    atomicMax(st + 4, kSub * ns);
  }
}

template <bool kMT>
int launch(const void* key, const void* pay, const void* rows,
           const void* orig_t, const void* dir_t, void* best_t,
           void* best_slot, void* stats, int n_gates, int list_len,
           int win_rows, void* stream) {
  if (n_gates == 0) return 0;
  const cudaError_t err = cudaMemsetAsync(
      stats, 0, (size_t)n_gates * 5 * sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  // clusters of one block: each sub-gate's block runs on its own
  return clpt::launch_cluster(
      plist_subgate_kernel<kMT, kSplit<kMT>>, 1, n_gates * kSub,
      kLanes * kSplit<kMT>, ring_smem(win_rows), (cudaStream_t)stream,
      static_cast<const float*>(key), static_cast<const int*>(pay),
      static_cast<const float4*>(rows), static_cast<const float*>(orig_t),
      static_cast<const float*>(dir_t), static_cast<float*>(best_t),
      static_cast<int*>(best_slot), static_cast<int*>(stats),
      n_gates * kGate, list_len, win_rows);
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

// The shape of K11's launch (mt == 0: the SO form) at win_rows, as
// clpt::cluster_shape writes it into out[6]: blocks per cluster, threads
// per block, the clusters resident at once, registers per thread, static
// and dynamic shared memory bytes per block. Returns a CUDA error or 0.
extern "C" int plist_subgate_shape(int mt, int win_rows, int* out) {
  const size_t smem = ring_smem(win_rows);
  return mt ? clpt::cluster_shape(plist_subgate_kernel<true, kSplit<true>>,
                                  1, kLanes * kSplit<true>, smem, out)
            : clpt::cluster_shape(plist_subgate_kernel<false, kSplit<false>>,
                                  1, kLanes * kSplit<false>, smem, out);
}
