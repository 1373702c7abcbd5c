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
// Design. A thread keeps one ray (direction; origin in the MT form), t0,
// best t and best slot in registers, and tests every staged record with the
// SO or MT pair test of pair_tests.cuh (shared with K3). A max-reduction of
// min(best t, t0) over the gate refreshes t_upper. A stream starts only if
// its first key <= min(BIG, max t0). Culled windows carry key +inf, so a
// stream stops at the first +inf entry. A bundle whose lanes are all dead
// (t0 = 0) still streams the entries whose key is exactly 0, as the TPU
// kernels do.
//
//   K1, K1', K2 and K10 run one gate or bundle on a thread-block cluster
//   of kCluster = 4 blocks (cluster.cuh), each block 128 of its 512 lanes,
//   with kSplit threads a lane (2 in the SO form, 4 in the MT form; K10 is
//   SO only), each testing a contiguous share of every staged run of
//   records: the (t, slot) rule below does not depend on the order of the
//   tests, so a lane's threads merge their winners (pair_tests.cuh::
//   merge_split) before each t_upper and end with the lane's. Every block
//   walks the same list; the start test and each t_upper (K1: after a
//   super, K2: after a window, K10: after a chunk) come from a max over the
//   whole cluster (cluster_reduce, through distributed shared memory), so
//   every block takes the decisions that one 512-thread block took, and
//   tests the same windows in the same order; rank 0 writes the stats row.
//   Records are staged with cp.async in a ring of two buffers, one barrier
//   per buffer: the copy of the next one flies while the current one is
//   tested. K1 copies the super's next needed window, else the first one of
//   the next super, issued before the break decision (an extra read, never
//   an extra test); K2 copies window j + 1 exactly when its decision below
//   takes it, before window j is tested; K10 copies the next piece of its
//   table (below) before the current one is tested, also ahead of the
//   break decision when that piece starts the next chunk, and never past
//   the table's kmax / cwin chunks.
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
//       gathered them), taken in chunks of cwin consecutive windows. Chunk
//       c is taken if the key of its first entry <= the t_upper after
//       chunk c-1 (plist.py:1325-1327); every window of a taken chunk is
//       tested. The table is contiguous per gate, so the ring stages it in
//       pieces of consecutive records: a chunk (256 records at the JAX
//       package's cwin on both scenes, 12 KB of cols 0-11), or half a
//       chunk when two whole chunks would not fit in shared memory (more
//       than kPieceRecs records; the wrapper allows 2 * kPieceRecs). A
//       thread's share of a piece runs across window ends: the slot of
//       record r of entry k is ids[k]*win_rows*8 + r, and ids need not be
//       monotonic, so the share is tested window by window.
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
// rejects (mt_hit); a warp issues each record to its deepest lane's exit.
// On one 512-thread block a bounce wave's K1' took as long as its heaviest
// bundle on one SM (7,824 windows on the 1M terrain's mirror wave, all of
// them); on a cluster that bundle runs on 4 SMs with 16 warps each, and the
// launch moves toward its total work at the rate the pair tests issue. K10
// is K2's schedule with a chunk of cwin windows for a window: three
// barriers a chunk (the landing, the merge, the cluster max) against 256
// records of tests a lane, and a copy that the previous chunk's tests hide.

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

constexpr int kGate = 512;     // rays per gate
constexpr int kSuper = 16;     // windows per super
constexpr float kBig = 3.4e38f;
constexpr int kCluster = 4;    // blocks per gate or bundle
constexpr int kLanes = kGate / kCluster;  // lanes per block
// threads per lane, each testing a share of every staged run of records:
// 256 threads a block in the SO form, 512 in the MT form
template <bool kMT>
constexpr int kSplit = kMT ? 4 : 2;
// K10: the most records of a piece (the ring's unit): two pieces of
// kPieceRecs take 196,608 bytes of the 227 KB a block may have
constexpr int kPieceRecs = 2048;

// K10's piece: a chunk of cwin windows, or half of one above kPieceRecs.
int gathered_piece(int cwin, int win_rows) {
  const int chunk = cwin * win_rows * 8;
  return chunk <= kPieceRecs ? chunk : chunk / 2;
}

// K10's dynamic shared memory: a ring of two pieces.
size_t gathered_smem(int cwin, int win_rows) {
  return 2 * (size_t)gathered_piece(cwin, win_rows) * kUsedF4 *
         sizeof(float4);
}

// Outputs of one ray, and (writer) its gate's stats row g (0, a, 512, b, a).
__device__ __forceinline__ void finish(float* __restrict__ best_t,
                                       int* __restrict__ best_slot,
                                       int* __restrict__ stats, int ray_i,
                                       float bt, int bs, int a, int b, int g,
                                       bool writer) {
  best_t[ray_i] = bt;
  best_slot[ray_i] = bt < kBig ? bs : -1;
  if (writer) {
    int* st = stats + 5 * g;
    st[0] = 0;
    st[1] = a;
    st[2] = kGate;
    st[3] = b;
    st[4] = a;
  }
}

// The max of v over the gate's cluster; every thread gets it.
__device__ __forceinline__ float cluster_max(float v,
                                             clpt::ClusterSlots<1>& slots,
                                             int& par) {
  clpt::cluster_reduce<1>(&v, slots, par, clpt::MaxOp(), -INFINITY);
  return v;
}

// The first record of the needed window after the one of bit `m`'s lowest
// set bit in super j: this super's next needed window, else the first
// needed window of super j + 1 when the stream may take it (j + 1 < jcap);
// -1 when there is none.
__device__ __forceinline__ long long next_window(
    const int* __restrict__ gsid, const int* __restrict__ gbits, long long s,
    unsigned m, int j, int jcap, int win_tris) {
  const unsigned rest = m & (m - 1u);
  if (rest) return (s * kSuper + __ffs((int)rest) - 1) * win_tris;
  if (j + 1 >= jcap) return -1;
  const unsigned b1 = (unsigned)gbits[j + 1];
  if (!b1) return -1;
  return ((long long)gsid[j + 1] * kSuper + __ffs((int)b1) - 1) * win_tris;
}

// K1 and K1': one gate or bundle per cluster of kCluster blocks, each block
// kLanes of its lanes, with kS threads per lane: thread h * kLanes + l
// tests the h-th kS-th of each window's records against lane l.
template <bool kMT, int kS>
__global__ void __launch_bounds__(kLanes * kS)
plist_super_kernel(const float* __restrict__ key, const int* __restrict__ sid,
                   const int* __restrict__ bits,
                   const float4* __restrict__ rows,
                   const float* __restrict__ orig_t,
                   const float* __restrict__ dir_t,
                   const float* __restrict__ t0, float* __restrict__ best_t,
                   int* __restrict__ best_slot, int* __restrict__ stats,
                   int n_rays, int list_len, int win_rows, int jcap) {
  extern __shared__ float4 win[];  // two windows of win_tris * kUsedF4
  __shared__ clpt::ClusterSlots<1> slots;
  __shared__ float split_t[kLanes * kS];
  __shared__ int split_s[kLanes * kS];

  const int rank = clpt::cluster_rank();
  const int g = blockIdx.x / kCluster;
  const int h = threadIdx.x / kLanes;
  const int ray_i = g * kGate + rank * kLanes + threadIdx.x % kLanes;
  const Ray ray = load_ray<kMT>(orig_t, dir_t, n_rays, ray_i);
  const float t0r = t0[ray_i];
  const int win_tris = win_rows * 8;
  const int win_f4 = win_tris * kUsedF4;
  const int share = win_tris / kS;  // records a thread tests of a window
  const float* gkey = key + (size_t)g * list_len;
  const int* gsid = sid + (size_t)g * list_len;
  const int* gbits = bits + (size_t)g * list_len;

  float bt = kBig;
  int bs = INT_MAX;
  int ns = 0, nw = 0;
  int par = 0;
  float tup = fminf(kBig, cluster_max(t0r, slots, par));
  bool alive = jcap > 0 && gkey[0] <= tup;
  int cur = 0;          // the buffer of the next window tested
  long long pend = -1;  // the window whose copy flies into win[cur], if any
  for (int j = 0; alive;) {
    const long long s = gsid[j];
    const unsigned b = (unsigned)gbits[j];
    for (unsigned m = b; m; m &= m - 1u) {
      const long long rec0 = (s * kSuper + __ffs((int)m) - 1) * win_tris;
      const long long next = next_window(gsid, gbits, s, m, j, jcap,
                                         win_tris);
      float4* w = win + cur * win_f4;
      if (pend != rec0) copy_recs(w, rows, rec0, win_tris);
      clpt::cp_async_wait<0>();
      __syncthreads();  // the window has landed; win[cur ^ 1] is free
      if (next >= 0) copy_recs(win + (cur ^ 1) * win_f4, rows, next, win_tris);
      pend = next;
      nearest_in_window<kMT>(ray, w + h * share * kUsedF4, share,
                             rec0 + h * share, bt, bs);
      cur ^= 1;
    }
    ++ns;
    nw += __popc(b);
    clpt::merge_split<kLanes, kS>(bt, bs, split_t, split_s);
    tup = cluster_max(fminf(bt, t0r), slots, par);
    ++j;
    alive = j < jcap && gkey[j] <= tup;
  }
  clpt::cp_async_wait<0>();  // a prefetch that the break left unused
  if (h == 0)  // every thread of a lane holds its merged winner
    finish(best_t, best_slot, stats, ray_i, bt, bs, nw, ns, g,
           rank == 0 && threadIdx.x == 0);
  clpt::cluster_end();
}

// K2 (both forms): one gate per cluster of kCluster blocks, each block
// kLanes of its lanes, with kS threads per lane as in K1. Window j + 1's
// copy is issued before window j is tested, into the other buffer of the
// ring, if and only if the TPU kernel's prefetch decision takes it: its key
// <= the t_upper from before window j. So every window copied is tested,
// and the stats are the TPU kernel's.
template <bool kMT, int kS>
__global__ void __launch_bounds__(kLanes * kS)
plist_window_kernel(const float* __restrict__ key,
                    const int* __restrict__ wid,
                    const float4* __restrict__ rows,
                    const float* __restrict__ orig_t,
                    const float* __restrict__ dir_t,
                    const float* __restrict__ t0, float* __restrict__ best_t,
                    int* __restrict__ best_slot, int* __restrict__ stats,
                    int n_rays, int list_len, int win_rows) {
  extern __shared__ float4 win[];  // two windows of win_tris * kUsedF4
  __shared__ clpt::ClusterSlots<1> slots;
  __shared__ float split_t[kLanes * kS];
  __shared__ int split_s[kLanes * kS];

  const int rank = clpt::cluster_rank();
  const int g = blockIdx.x / kCluster;
  const int h = threadIdx.x / kLanes;
  const int ray_i = g * kGate + rank * kLanes + threadIdx.x % kLanes;
  const Ray ray = load_ray<kMT>(orig_t, dir_t, n_rays, ray_i);
  const float t0r = t0[ray_i];
  const int win_tris = win_rows * 8;
  const int win_f4 = win_tris * kUsedF4;
  const int share = win_tris / kS;  // records a thread tests of a window
  const float* gkey = key + (size_t)g * list_len;
  const int* gwid = wid + (size_t)g * list_len;

  float bt = kBig;
  int bs = INT_MAX;
  int ns = 0;
  int par = 0;
  float tup = fminf(kBig, cluster_max(t0r, slots, par));
  bool alive = list_len > 0 && gkey[0] <= tup;
  if (alive) copy_recs(win, rows, (long long)gwid[0] * win_tris, win_tris);
  int cur = 0;  // the buffer of window j
  for (int j = 0; alive; ++j) {
    // the TPU kernel's prefetch decision: window j+1 against the t_upper
    // from before window j
    const bool next = j + 1 < list_len && gkey[j + 1] <= tup;
    const long long rec0 = (long long)gwid[j] * win_tris;
    clpt::cp_async_wait<0>();
    __syncthreads();  // window j has landed; win[cur ^ 1] is free
    if (next)
      copy_recs(win + (cur ^ 1) * win_f4, rows,
                (long long)gwid[j + 1] * win_tris, win_tris);
    nearest_in_window<kMT>(ray, win + cur * win_f4 + h * share * kUsedF4,
                           share, rec0 + h * share, bt, bs);
    ++ns;
    clpt::merge_split<kLanes, kS>(bt, bs, split_t, split_s);
    tup = cluster_max(fminf(bt, t0r), slots, par);
    alive = next;
    cur ^= 1;
  }
  if (h == 0)  // every thread of a lane holds its merged winner
    finish(best_t, best_slot, stats, ray_i, bt, bs, ns, 0, g,
           rank == 0 && threadIdx.x == 0);
  clpt::cluster_end();
}

// K10: one gate per cluster of kCluster blocks, each block kLanes of its
// lanes, with kS threads per lane as in K1. The gate's table streams
// through the two-buffer ring in pieces of `piece` records, per_chunk = 1
// or 2 a chunk: piece q + 1 is copied before piece q is tested, and chunk
// c + 1's first piece before the decision to take it (an extra read of at
// most one piece, never an extra test).
template <int kS>
__global__ void __launch_bounds__(kLanes * kS)
plist_gathered_kernel(const float* __restrict__ ten,
                      const int* __restrict__ ids,
                      const float4* __restrict__ table,
                      const float* __restrict__ dir_t,
                      const float* __restrict__ t0, float* __restrict__ best_t,
                      int* __restrict__ best_slot, int* __restrict__ stats,
                      int n_rays, int kmax, int cwin, int win_rows,
                      int piece) {
  extern __shared__ float4 win[];  // two pieces of piece * kUsedF4
  __shared__ clpt::ClusterSlots<1> slots;
  __shared__ float split_t[kLanes * kS];
  __shared__ int split_s[kLanes * kS];

  const int rank = clpt::cluster_rank();
  const int g = blockIdx.x / kCluster;
  const int h = threadIdx.x / kLanes;
  const int ray_i = g * kGate + rank * kLanes + threadIdx.x % kLanes;
  const Ray ray = load_ray<false>(nullptr, dir_t, n_rays, ray_i);
  const float t0r = t0[ray_i];
  const int win_tris = win_rows * 8;
  const int n_chunks = kmax / cwin;
  const int per_chunk = cwin * win_tris / piece;
  const int n_pieces = n_chunks * per_chunk;
  const int piece_f4 = piece * kUsedF4;
  const int share = piece / kS;  // records a thread tests of a piece
  const float* gten = ten + (size_t)g * kmax;
  const int* gids = ids + (size_t)g * kmax;
  const long long rec_g = (long long)g * kmax * win_tris;

  float bt = kBig;
  int bs = INT_MAX;
  int c = 0;  // chunks tested
  int par = 0;
  float tup = fminf(kBig, cluster_max(t0r, slots, par));
  bool alive = n_chunks > 0 && gten[0] <= tup;
  if (alive) copy_recs(win, table, rec_g, piece);
  int cur = 0;  // the buffer of piece q
  for (int q = 0; alive; ++q) {
    clpt::cp_async_wait<0>();
    __syncthreads();  // piece q has landed; win[cur ^ 1] is free
    if (q + 1 < n_pieces)
      copy_recs(win + (cur ^ 1) * piece_f4, table,
                rec_g + (long long)(q + 1) * piece, piece);
    // this thread's records [lo, lo + share) of the gate's table, window
    // by window
    const int lo = q * piece + h * share;
    const float4* w = win + cur * piece_f4 + h * share * kUsedF4;
    for (int r = lo; r < lo + share;) {
      const int k = r / win_tris;
      const int in_win = r - k * win_tris;
      const int n = min(lo + share - r, win_tris - in_win);
      nearest_in_window<false>(ray, w + (r - lo) * kUsedF4, n,
                               (long long)gids[k] * win_tris + in_win, bt,
                               bs);
      r += n;
    }
    cur ^= 1;
    if ((q + 1) % per_chunk == 0) {  // chunk c is tested
      ++c;
      clpt::merge_split<kLanes, kS>(bt, bs, split_t, split_s);
      tup = cluster_max(fminf(bt, t0r), slots, par);
      alive = c < n_chunks && gten[c * cwin] <= tup;
    }
  }
  clpt::cp_async_wait<0>();  // a copy that the break left unused
  if (h == 0)  // every thread of a lane holds its merged winner
    finish(best_t, best_slot, stats, ray_i, bt, bs, c * cwin, 0, g,
           rank == 0 && threadIdx.x == 0);
  clpt::cluster_end();
}

template <bool kMT>
int launch_super(const void* key, const void* sid, const void* bits,
                 const void* rows, const void* orig_t, const void* dir_t,
                 const void* t0, void* best_t, void* best_slot, void* stats,
                 int n_gates, int list_len, int win_rows, int jcap,
                 void* stream) {
  if (n_gates == 0) return 0;
  return clpt::launch_cluster(
      plist_super_kernel<kMT, kSplit<kMT>>, kCluster, n_gates * kCluster,
      kLanes * kSplit<kMT>, ring_smem(win_rows), (cudaStream_t)stream,
      static_cast<const float*>(key), static_cast<const int*>(sid),
      static_cast<const int*>(bits), static_cast<const float4*>(rows),
      static_cast<const float*>(orig_t), static_cast<const float*>(dir_t),
      static_cast<const float*>(t0), static_cast<float*>(best_t),
      static_cast<int*>(best_slot), static_cast<int*>(stats),
      n_gates * kGate, list_len, win_rows, jcap);
}

template <bool kMT>
int launch_window(const void* key, const void* wid, const void* rows,
                  const void* orig_t, const void* dir_t, const void* t0,
                  void* best_t, void* best_slot, void* stats, int n_gates,
                  int list_len, int win_rows, void* stream) {
  if (n_gates == 0) return 0;
  return clpt::launch_cluster(
      plist_window_kernel<kMT, kSplit<kMT>>, kCluster, n_gates * kCluster,
      kLanes * kSplit<kMT>, ring_smem(win_rows), (cudaStream_t)stream,
      static_cast<const float*>(key), static_cast<const int*>(wid),
      static_cast<const float4*>(rows), static_cast<const float*>(orig_t),
      static_cast<const float*>(dir_t), static_cast<const float*>(t0),
      static_cast<float*>(best_t), static_cast<int*>(best_slot),
      static_cast<int*>(stats), n_gates * kGate, list_len, win_rows);
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

// The shape of K1's (mt == 0) or K1''s cluster launch at win_rows, as
// clpt::cluster_shape writes it into out[6]: blocks per cluster, threads
// per block, the clusters resident at once, registers per thread, static
// and dynamic shared memory bytes per block. Returns a CUDA error or 0.
extern "C" int plist_super_shape(int mt, int win_rows, int* out) {
  const size_t smem = ring_smem(win_rows);
  return mt ? clpt::cluster_shape(plist_super_kernel<true, kSplit<true>>,
                                  kCluster, kLanes * kSplit<true>, smem, out)
            : clpt::cluster_shape(plist_super_kernel<false, kSplit<false>>,
                                  kCluster, kLanes * kSplit<false>, smem,
                                  out);
}

// The shape of K2's (mt == 0) or its MT form's cluster launch at win_rows,
// as plist_super_shape writes it.
extern "C" int plist_window_shape(int mt, int win_rows, int* out) {
  const size_t smem = ring_smem(win_rows);
  return mt ? clpt::cluster_shape(plist_window_kernel<true, kSplit<true>>,
                                  kCluster, kLanes * kSplit<true>, smem, out)
            : clpt::cluster_shape(plist_window_kernel<false, kSplit<false>>,
                                  kCluster, kLanes * kSplit<false>, smem,
                                  out);
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
  if (n_gates == 0) return 0;
  return clpt::launch_cluster(
      plist_gathered_kernel<kSplit<false>>, kCluster, n_gates * kCluster,
      kLanes * kSplit<false>, gathered_smem(cwin, win_rows),
      (cudaStream_t)stream, static_cast<const float*>(ten),
      static_cast<const int*>(ids), static_cast<const float4*>(table),
      static_cast<const float*>(dir_t), static_cast<const float*>(t0),
      static_cast<float*>(best_t), static_cast<int*>(best_slot),
      static_cast<int*>(stats), n_gates * kGate, kmax, cwin, win_rows,
      gathered_piece(cwin, win_rows));
}

// The shape of K10's cluster launch at (cwin, win_rows), as
// plist_super_shape writes it.
extern "C" int plist_gathered_shape(int cwin, int win_rows, int* out) {
  return clpt::cluster_shape(plist_gathered_kernel<kSplit<false>>, kCluster,
                             kLanes * kSplit<false>,
                             gathered_smem(cwin, win_rows), out);
}
