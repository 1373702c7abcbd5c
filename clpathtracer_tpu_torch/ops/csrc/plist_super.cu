// Super-list packet kernel (K1), shared-origin (SO) form, for Hopper (sm_90a).
//
// Replaces the TPU kernel clpathtracer_tpu/ops/plist.py::_kernel_plist_super
// (called through _plist_super_call). It computes what that kernel computes,
// not its schedule: for every 512-ray gate (a 16x32 pixel block with one
// shared origin), stream the gate's sorted super list, test every needed
// window of each super densely against all 512 rays, and stop as soon as
// the next super's conservative entry key exceeds the gate's t_upper.
//
// Design: one block per gate, 512 threads, one ray per thread. A thread
// keeps its direction, t0, best t and best slot in registers. For every
// need bit of the current super the block copies that window's SO records
// (win_rows*8 records; cols 0-11 of each 16-float record, of which 0-9 are
// used) into shared memory, synchronises, and each thread runs the
// signed-volume test of clpathtracer_tpu/ops/packet.py::_mt_chunk_math_so
// against every record: s1, s2, s3 <= 0, strict dsum < 0, d0 < 0,
// t = d0 / dsum. The rejection is a branch, never an arithmetic blend: pad
// records are all zero and dsum == 0 would give inf or NaN.
// After each super a block max-reduction of min(best t, t0) refreshes
// t_upper (the JAX package's default cadence); the loop goes on while the
// next entry exists and its key <= t_upper, and starts only if
// key[0] <= min(BIG, max t0). Culled windows carry key +inf, so the stream stops at the first
// +inf entry and a gate that needs nothing runs zero supers.
//
// Tie rule: lexicographic (min t, then min slot) over every tested pair.
// It is independent of the order of the tests, so this kernel and its plain
// torch version (ops/plist.py::plist_super_reference) agree exactly. The TPU
// kernel's accumulator order picks another winner only at exact-t ties,
// which are a documented freedom (clpathtracer_tpu/ops/packet.py:21-25).
//
// Rounding: the dense test uses __fmul_rn/__fadd_rn/__fdiv_rn, which are
// never contracted into FMA, and the library is built with --fmad=false, so
// every product, sum and quotient rounds as in the plain torch version.
//
// What bounds it on this card: FP32 issue in the dense test (about 35
// flops per ray-triangle pair as the TPU kernel counts its vector ops; here
// about 22 FP32 instructions, with no FMA, all threads reading the same
// shared-memory record as a broadcast), plus the __syncthreads and the load latency of
// each window, which nothing hides yet. Making it fast is later work:
// cp.async/TMA double-buffering of windows, several gates per block,
// persistent blocks.

#include <climits>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float dot3(float dx, float dy, float dz, float a,
                                      float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, a), __fmul_rn(dy, b)),
                   __fmul_rn(dz, c));
}

__global__ void __launch_bounds__(kGate)
plist_super_kernel(const float* __restrict__ key, const int* __restrict__ sid,
                   const int* __restrict__ bits,
                   const float4* __restrict__ rows,
                   const float* __restrict__ dir_t,
                   const float* __restrict__ t0, float* __restrict__ best_t,
                   int* __restrict__ best_slot, int* __restrict__ stats,
                   int n_rays, int list_len, int win_rows) {
  extern __shared__ float4 win[];  // [win_tris * kUsedF4]
  __shared__ float red[kGate / 32];

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int ray = g * kGate + lane;
  const float dx = dir_t[ray];
  const float dy = dir_t[n_rays + ray];
  const float dz = dir_t[2 * n_rays + ray];
  const float t0r = t0[ray];
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
        // p = (ab.x, ab.y, ab.z, bc.x), q = (bc.y, bc.z, ca.x, ca.y),
        // w = (ca.z, d0, tri_id, 0)
        const float4 p = win[r * kUsedF4];
        const float4 q = win[r * kUsedF4 + 1];
        const float4 w = win[r * kUsedF4 + 2];
        const float s1 = dot3(dx, dy, dz, p.x, p.y, p.z);
        const float s2 = dot3(dx, dy, dz, p.w, q.x, q.y);
        const float s3 = dot3(dx, dy, dz, q.z, q.w, w.x);
        const float dsum = __fadd_rn(__fadd_rn(s1, s2), s3);
        if (fmaxf(fmaxf(s1, s2), s3) <= 0.f && dsum < 0.f && w.y < 0.f) {
          const float tt = __fdiv_rn(w.y, dsum);
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
  best_t[ray] = bt;
  best_slot[ray] = bt < kBig ? bs : -1;
  if (lane == 0) {
    int* st = stats + 5 * g;  // the JAX tile_stats[::8, :5] columns
    st[0] = 0;
    st[1] = nw;
    st[2] = kGate;
    st[3] = ns;
    st[4] = nw;
  }
}

}  // namespace

// key/sid/bits: [n_gates, list_len] f32/i32/i32, each gate's entries sorted
// by key; rows: [S, 16] f32 SO records; dir_t: [3, n_gates*512] f32;
// t0: [n_gates*512] f32. Outputs best_t [N] f32, best_slot [N] i32 (-1 on a
// miss), stats [n_gates, 5] i32. Returns cudaGetLastError() after the
// launch; a refused launch (resources, configuration) shows only there.
extern "C" int plist_super_launch(const void* key, const void* sid,
                                  const void* bits, const void* rows,
                                  const void* dir_t, const void* t0,
                                  void* best_t, void* best_slot, void* stats,
                                  int n_gates, int list_len, int win_rows,
                                  void* stream) {
  const size_t smem = (size_t)win_rows * 8 * kUsedF4 * sizeof(float4);
  plist_super_kernel<<<n_gates, kGate, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(key), static_cast<const int*>(sid),
      static_cast<const int*>(bits), static_cast<const float4*>(rows),
      static_cast<const float*>(dir_t), static_cast<const float*>(t0),
      static_cast<float*>(best_t), static_cast<int*>(best_slot),
      static_cast<int*>(stats), n_gates * kGate, list_len, win_rows);
  return (int)cudaGetLastError();
}
