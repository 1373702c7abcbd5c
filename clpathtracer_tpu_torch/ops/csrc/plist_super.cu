// List-stream packet kernels for Hopper (sm_90a): the windows route's three
// stream schedules for 512-ray gates, which share one per-window test loop.
//
//   K1  (shared-origin, SO): plist_super_launch. Replaces the TPU kernel
//       clpathtracer_tpu/ops/plist.py::_kernel_plist_super with so=True
//       (the primary-ray gates of traverse_plist).
//   K1' (general Moller-Trumbore, MT): plist_super_mt_launch. Replaces the
//       same TPU kernel with so=False, the form that traverse_plist_bundle
//       runs on sorted 512-ray bounce bundles (and traverse_plist without
//       SO tables). Per-lane origins and per-lane t0 seeds.
//   K2  (one sorted entry per window): plist_window_launch (SO) and
//       plist_window_mt_launch (MT). Replaces clpathtracer_tpu/ops/plist.py::
//       _kernel_plist (traverse_plist(supers=False), and the overflow
//       fallback of the gathered schedule on windows that are not whole
//       supers).
//   K10 (gathered private tables): plist_gathered_launch, SO only. Replaces
//       clpathtracer_tpu/ops/plist.py::_kernel_plist_gath
//       (traverse_plist(gathered=True)).
//
// All compute what the TPU kernels compute, not their schedule: for every
// 512-ray gate or bundle, stream its sorted list, test the windows it names
// densely against all 512 rays, and stop as soon as the next entry's
// conservative entry key exceeds the gate's t_upper.
//
// Design: one block per gate, 512 threads, one ray per thread. A thread
// keeps its ray (direction; origin in the MT form), t0, best t and best slot
// in registers. For each window the block copies its records (win_rows*8
// records; cols 0-11 of each 16-float record, of which 0-9 are used) into
// shared memory, synchronises, and each thread tests every record with the
// SO or MT pair test of pair_tests.cuh (shared with K3). A block
// max-reduction of min(best t, t0) refreshes t_upper. A stream starts only
// if its first key <= min(BIG, max t0). Culled windows carry key +inf, so a
// stream stops at the first +inf entry. A bundle whose lanes are all dead
// (t0 = 0) still streams the entries whose key is exactly 0, as the TPU
// kernels do.
//
//   K1: entries are supers of kSuper windows with one need bit per window;
//       the needed windows of a super are tested, then t_upper is refreshed,
//       and the next super is taken if its key <= that t_upper. The kcap
//       form (the first phase of the two-phase straggler engine,
//       plist.py:1015-1032, ops/plist.py::_plist_two_phase) streams at most
//       jcap entries: the stream stops before entry jcap whatever its key,
//       and the stats count the entries consumed.
//   K2: entries are single windows, read at rows + wid*win_rows*8. The
//       decision to take window j+1 uses the t_upper from before window j
//       was tested: the TPU kernel decides its prefetch of j+1 then
//       (plist.py:458-477), and this keeps its stats.
//   K10: entries are the gate's private table of kmax windows (the prepass
//       gathered them), taken in chunks of cwin consecutive windows, one
//       coalesced copy each. Chunk c is taken if the key of its first entry
//       <= the t_upper after chunk c-1 (plist.py:1325-1327); every window of
//       a taken chunk is tested. The slot of record r of entry k is
//       ids[k]*win_rows*8 + r.
//
// Stats per gate (the JAX tile_stats[::8, :5] columns): K1 (0, windows,
// 512, supers, windows); K2 (0, windows, 512, 0, windows); K10 (0,
// chunks*cwin, 512, 0, chunks*cwin).
//
// Tie rule: lexicographic (min t, then min slot) over every tested pair.
// It is independent of the order of the tests, so each form agrees exactly
// with its plain torch version (ops/plist.py::plist_super_reference,
// plist_super_mt_reference, plist_window_reference,
// plist_gathered_reference). The TPU kernels' accumulator order picks
// another winner only at exact-t ties, which are a documented freedom
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
// nothing hides yet (K10 copies cwin windows per synchronisation). Making
// them fast is later work: cp.async/TMA double-buffering of windows,
// several gates per block, persistent blocks.

#include <climits>
#include <cuda_runtime.h>

#include "pair_tests.cuh"

namespace {

using clpt::Ray;
using clpt::load_ray;
using clpt::nearest_in_window;

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

// Copy n_recs records from `rows` (float4 view of [S, 16]), starting at
// record rec0, into shared memory (cols 0-11). The block synchronises
// before (every thread is done with the previous contents) and after.
__device__ __forceinline__ void stage(float4* win,
                                      const float4* __restrict__ rows,
                                      long long rec0, int n_recs) {
  __syncthreads();
  for (int i = threadIdx.x; i < n_recs * kUsedF4; i += kGate)
    win[i] = rows[(rec0 + i / kUsedF4) * kRecF4 + i % kUsedF4];
  __syncthreads();
}

// Outputs of one ray, and the gate's stats row (0, a, 512, b, a).
__device__ __forceinline__ void finish(float* __restrict__ best_t,
                                       int* __restrict__ best_slot,
                                       int* __restrict__ stats, int ray_i,
                                       float bt, int bs, int a, int b) {
  best_t[ray_i] = bt;
  best_slot[ray_i] = bt < kBig ? bs : -1;
  if (threadIdx.x == 0) {
    int* st = stats + 5 * blockIdx.x;
    st[0] = 0;
    st[1] = a;
    st[2] = kGate;
    st[3] = b;
    st[4] = a;
  }
}

// K1 and K1'.
template <bool kMT>
__global__ void __launch_bounds__(kGate)
plist_super_kernel(const float* __restrict__ key, const int* __restrict__ sid,
                   const int* __restrict__ bits,
                   const float4* __restrict__ rows,
                   const float* __restrict__ orig_t,
                   const float* __restrict__ dir_t,
                   const float* __restrict__ t0, float* __restrict__ best_t,
                   int* __restrict__ best_slot, int* __restrict__ stats,
                   int n_rays, int list_len, int win_rows, int jcap) {
  extern __shared__ float4 win[];  // [win_tris * kUsedF4]
  __shared__ float red[kGate / 32];

  const int g = blockIdx.x;
  const int ray_i = g * kGate + threadIdx.x;
  const Ray ray = load_ray<kMT>(orig_t, dir_t, n_rays, ray_i);
  const float t0r = t0[ray_i];
  const int win_tris = win_rows * 8;
  const float* gkey = key + (size_t)g * list_len;
  const int* gsid = sid + (size_t)g * list_len;
  const int* gbits = bits + (size_t)g * list_len;

  float bt = kBig;
  int bs = INT_MAX;
  int ns = 0, nw = 0;
  float tup = fminf(kBig, block_max(t0r, red));
  bool alive = jcap > 0 && gkey[0] <= tup;
  for (int j = 0; alive;) {
    const long long s = gsid[j];
    const unsigned b = (unsigned)gbits[j];
    for (int k = 0; k < kSuper; ++k) {
      if (!((b >> k) & 1u)) continue;
      const long long rec0 = (s * kSuper + k) * win_tris;
      stage(win, rows, rec0, win_tris);
      nearest_in_window<kMT>(ray, win, win_tris, rec0, bt, bs);
    }
    ++ns;
    nw += __popc(b);
    tup = block_max(fminf(bt, t0r), red);
    ++j;
    alive = j < jcap && gkey[j] <= tup;
  }
  finish(best_t, best_slot, stats, ray_i, bt, bs, nw, ns);
}

// K2 (both forms).
template <bool kMT>
__global__ void __launch_bounds__(kGate)
plist_window_kernel(const float* __restrict__ key,
                    const int* __restrict__ wid,
                    const float4* __restrict__ rows,
                    const float* __restrict__ orig_t,
                    const float* __restrict__ dir_t,
                    const float* __restrict__ t0, float* __restrict__ best_t,
                    int* __restrict__ best_slot, int* __restrict__ stats,
                    int n_rays, int list_len, int win_rows) {
  extern __shared__ float4 win[];  // [win_tris * kUsedF4]
  __shared__ float red[kGate / 32];

  const int g = blockIdx.x;
  const int ray_i = g * kGate + threadIdx.x;
  const Ray ray = load_ray<kMT>(orig_t, dir_t, n_rays, ray_i);
  const float t0r = t0[ray_i];
  const int win_tris = win_rows * 8;
  const float* gkey = key + (size_t)g * list_len;
  const int* gwid = wid + (size_t)g * list_len;

  float bt = kBig;
  int bs = INT_MAX;
  int ns = 0;
  float tup = fminf(kBig, block_max(t0r, red));
  bool alive = list_len > 0 && gkey[0] <= tup;
  for (int j = 0; alive; ++j) {
    // the TPU kernel's prefetch decision: window j+1 against the t_upper
    // from before window j
    const bool next = j + 1 < list_len && gkey[j + 1] <= tup;
    const long long rec0 = (long long)gwid[j] * win_tris;
    stage(win, rows, rec0, win_tris);
    nearest_in_window<kMT>(ray, win, win_tris, rec0, bt, bs);
    ++ns;
    tup = block_max(fminf(bt, t0r), red);
    alive = next;
  }
  finish(best_t, best_slot, stats, ray_i, bt, bs, ns, 0);
}

// K10.
__global__ void __launch_bounds__(kGate)
plist_gathered_kernel(const float* __restrict__ ten,
                      const int* __restrict__ ids,
                      const float4* __restrict__ table,
                      const float* __restrict__ dir_t,
                      const float* __restrict__ t0, float* __restrict__ best_t,
                      int* __restrict__ best_slot, int* __restrict__ stats,
                      int n_rays, int kmax, int cwin, int win_rows) {
  extern __shared__ float4 win[];  // [cwin * win_tris * kUsedF4]
  __shared__ float red[kGate / 32];

  const int g = blockIdx.x;
  const int ray_i = g * kGate + threadIdx.x;
  const Ray ray = load_ray<false>(nullptr, dir_t, n_rays, ray_i);
  const float t0r = t0[ray_i];
  const int win_tris = win_rows * 8;
  const float* gten = ten + (size_t)g * kmax;
  const int* gids = ids + (size_t)g * kmax;
  const long long rec_g = (long long)g * kmax * win_tris;
  const int n_chunks = kmax / cwin;

  float bt = kBig;
  int bs = INT_MAX;
  int c = 0;
  float tup = fminf(kBig, block_max(t0r, red));
  while (c < n_chunks && gten[c * cwin] <= tup) {
    stage(win, table, rec_g + (long long)c * cwin * win_tris,
          cwin * win_tris);
    for (int k = 0; k < cwin; ++k)
      nearest_in_window<false>(ray, win + k * win_tris * kUsedF4, win_tris,
                         (long long)gids[c * cwin + k] * win_tris, bt, bs);
    tup = block_max(fminf(bt, t0r), red);
    ++c;
  }
  finish(best_t, best_slot, stats, ray_i, bt, bs, c * cwin, 0);
}

// Launch with `recs` staged records of dynamic shared memory; raises the
// kernel's limit above the default 48 KB where it needs more. Returns
// cudaGetLastError() after the launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int n_gates, int recs, void* stream,
           Args... args) {
  const size_t smem = (size_t)recs * kUsedF4 * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_gates, kGate, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool kMT>
int launch_super(const void* key, const void* sid, const void* bits,
                 const void* rows, const void* orig_t, const void* dir_t,
                 const void* t0, void* best_t, void* best_slot, void* stats,
                 int n_gates, int list_len, int win_rows, int jcap,
                 void* stream) {
  return launch(plist_super_kernel<kMT>, n_gates, win_rows * 8, stream,
                static_cast<const float*>(key), static_cast<const int*>(sid),
                static_cast<const int*>(bits),
                static_cast<const float4*>(rows),
                static_cast<const float*>(orig_t),
                static_cast<const float*>(dir_t),
                static_cast<const float*>(t0), static_cast<float*>(best_t),
                static_cast<int*>(best_slot), static_cast<int*>(stats),
                n_gates * kGate, list_len, win_rows, jcap);
}

template <bool kMT>
int launch_window(const void* key, const void* wid, const void* rows,
                  const void* orig_t, const void* dir_t, const void* t0,
                  void* best_t, void* best_slot, void* stats, int n_gates,
                  int list_len, int win_rows, void* stream) {
  return launch(plist_window_kernel<kMT>, n_gates, win_rows * 8, stream,
                static_cast<const float*>(key), static_cast<const int*>(wid),
                static_cast<const float4*>(rows),
                static_cast<const float*>(orig_t),
                static_cast<const float*>(dir_t),
                static_cast<const float*>(t0), static_cast<float*>(best_t),
                static_cast<int*>(best_slot), static_cast<int*>(stats),
                n_gates * kGate, list_len, win_rows);
}

}  // namespace

// K1. key/sid/bits: [n_gates, list_len] f32/i32/i32, each gate's entries
// sorted by key; rows: [S, 16] f32 SO records; dir_t: [3, n_gates*512] f32;
// t0: [n_gates*512] f32; jcap in [0, list_len]: a gate streams at most its
// first jcap entries (list_len: no cap; the kcap form below it). Outputs
// best_t [N] f32, best_slot [N] i32 (-1 on a miss), stats [n_gates, 5] i32.
// Returns cudaGetLastError() after the launch; a refused launch (resources,
// configuration) shows only there.
extern "C" int plist_super_launch(const void* key, const void* sid,
                                  const void* bits, const void* rows,
                                  const void* dir_t, const void* t0,
                                  void* best_t, void* best_slot, void* stats,
                                  int n_gates, int list_len, int win_rows,
                                  int jcap, void* stream) {
  return launch_super<false>(key, sid, bits, rows, nullptr, dir_t, t0,
                             best_t, best_slot, stats, n_gates, list_len,
                             win_rows, jcap, stream);
}

// K1'. As plist_super_launch, with rows the raw [S, 16] triangle records
// (v0, e1, e2, tri_id) and orig_t [3, n_gates*512] f32 per-lane origins.
extern "C" int plist_super_mt_launch(const void* key, const void* sid,
                                     const void* bits, const void* rows,
                                     const void* orig_t, const void* dir_t,
                                     const void* t0, void* best_t,
                                     void* best_slot, void* stats,
                                     int n_gates, int list_len, int win_rows,
                                     int jcap, void* stream) {
  return launch_super<true>(key, sid, bits, rows, orig_t, dir_t, t0, best_t,
                            best_slot, stats, n_gates, list_len, win_rows,
                            jcap, stream);
}

// K2, SO form. key/wid: [n_gates, list_len] f32/i32, each gate's windows
// sorted by key; rows: [S, 16] f32 SO records, S a multiple of win_rows*8;
// dir_t, t0 and the outputs as plist_super_launch.
extern "C" int plist_window_launch(const void* key, const void* wid,
                                   const void* rows, const void* dir_t,
                                   const void* t0, void* best_t,
                                   void* best_slot, void* stats, int n_gates,
                                   int list_len, int win_rows, void* stream) {
  return launch_window<false>(key, wid, rows, nullptr, dir_t, t0, best_t,
                              best_slot, stats, n_gates, list_len, win_rows,
                              stream);
}

// K2, MT form: rows the raw triangle records, orig_t per-lane origins.
extern "C" int plist_window_mt_launch(const void* key, const void* wid,
                                      const void* rows, const void* orig_t,
                                      const void* dir_t, const void* t0,
                                      void* best_t, void* best_slot,
                                      void* stats, int n_gates, int list_len,
                                      int win_rows, void* stream) {
  return launch_window<true>(key, wid, rows, orig_t, dir_t, t0, best_t,
                             best_slot, stats, n_gates, list_len, win_rows,
                             stream);
}

// K10. ten/ids: [n_gates, kmax] f32/i32, each gate's entry keys in
// ascending order and their window ids (pad entries: key +inf, the id of
// the window whose rows the table holds); table: [n_gates, kmax*win_rows*8,
// 16] f32 SO records, entry k of gate g at rows [k*win_rows*8, (k+1)*
// win_rows*8) of its block; kmax a multiple of cwin. dir_t, t0 and the
// outputs as plist_super_launch.
extern "C" int plist_gathered_launch(const void* ten, const void* ids,
                                     const void* table, const void* dir_t,
                                     const void* t0, void* best_t,
                                     void* best_slot, void* stats,
                                     int n_gates, int kmax, int cwin,
                                     int win_rows, void* stream) {
  return launch(plist_gathered_kernel, n_gates, cwin * win_rows * 8, stream,
                static_cast<const float*>(ten), static_cast<const int*>(ids),
                static_cast<const float4*>(table),
                static_cast<const float*>(dir_t),
                static_cast<const float*>(t0), static_cast<float*>(best_t),
                static_cast<int*>(best_slot), static_cast<int*>(stats),
                n_gates * kGate, kmax, cwin, win_rows);
}
