// Ray-triangle pair tests shared by the port's kernels: K1, K1', K2, K10
// (plist_super.cu), K11 (plist_subgate.cu), K3 and K4 (packet_stream.cu),
// K5 (packet_queue.cu) and G1 (grid_dda.cu, mt_hit_uv).
// One copy, so every kernel rounds a pair as the others and as the plain
// torch versions do.
//
//   so_hit: the shared-origin signed-volume test of clpathtracer_tpu/ops/
//     packet.py::_mt_chunk_math_so: s1, s2, s3 <= 0, strict dsum < 0,
//     d0 < 0, t = d0 / dsum. 22 FP32 operations per pair (9 mul, 8 add,
//     2 max, 3 compares).
//   mt_hit: the general Moller-Trumbore test of clpathtracer_tpu/ops/
//     packet.py::_mt_chunk_math: p = d x e2, det = e1.p with backface cull
//     det > 0, invd = 1/det, u = (o - v0).p * invd, q = (o - v0) x e1,
//     v = d.q * invd, t = e2.q * invd; accept 0 <= u <= 1, v >= 0,
//     u + v <= 1, t > 0, tri_id >= 0. 53 FP32 operations on the full path
//     (27 mul, 18 add or sub, 7 compares, 1 reciprocal), 15, 27 or 45 on
//     the pairs that the det, u or v branch rejects. mt_hit_uv also
//     returns u and v (ops/traverse_fast.py::_mt_pre).
//   nearest_in_window, merge_split: the list kernels' (min t, then min
//     slot) winner over a staged run of records, and over the kS threads
//     that split a lane's records.
//   mt_hit_bf16: the bf16 preview of mt_hit (_mt_chunk_math with
//     compute_dtype=bfloat16): the same expressions in the same order on
//     bf16 values, each *, -, + and 1/x computed in f32 and rounded to bf16
//     (round to nearest even), which is what every torch bf16 tensor op
//     does, so the plain version (ops/packet.py::mt_pairs with
//     dtype=torch.bfloat16) matches it bit for bit. A hit whose t rounds
//     to 3.0e38 or more is a miss (the preview's miss value). No packed
//     bf16x2 arithmetic and no contraction: either would break exactness.
//
// Rejection is a branch, never an arithmetic blend: pad records and dead
// lanes (direction exactly 0, so det is exactly 0) would give inf or NaN.
// The tests use __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__frcp_rn, which
// are never contracted into FMA, in the order the plain versions use; the
// library is built with --fmad=false besides.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace clpt {

// (x0*a + x1*b) + x2*c, rounded as the plain torch versions round it
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float a,
                                      float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, a), __fmul_rn(x1, b)),
                   __fmul_rn(x2, c));
}

// x1*b - x2*a: one component of a cross product
__device__ __forceinline__ float crs(float x1, float b, float x2, float a) {
  return __fsub_rn(__fmul_rn(x1, b), __fmul_rn(x2, a));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// SO record: p = (ab.x, ab.y, ab.z, bc.x), q = (bc.y, bc.z, ca.x, ca.y),
// w = (ca.z, d0, tri_id, 0). Writes t and returns true on a hit.
__device__ __forceinline__ bool so_hit(const Ray& ray, float4 p, float4 q,
                                       float4 w, float* t) {
  const float s1 = dot3(ray.dx, ray.dy, ray.dz, p.x, p.y, p.z);
  const float s2 = dot3(ray.dx, ray.dy, ray.dz, p.w, q.x, q.y);
  const float s3 = dot3(ray.dx, ray.dy, ray.dz, q.z, q.w, w.x);
  const float dsum = __fadd_rn(__fadd_rn(s1, s2), s3);
  if (fmaxf(fmaxf(s1, s2), s3) <= 0.f && dsum < 0.f && w.y < 0.f) {
    *t = __fdiv_rn(w.y, dsum);
    return true;
  }
  return false;
}

// MT record: a = (v0.x, v0.y, v0.z, e1.x), b = (e1.y, e1.z, e2.x, e2.y),
// c = (e2.z, tri_id, 0, 0). Writes t, u, v and returns true on a hit.
__device__ __forceinline__ bool mt_hit_uv(const Ray& ray, float4 a, float4 b,
                                          float4 c, float* t, float* u_out,
                                          float* v_out) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = crs(ray.dy, e2z, ray.dz, e2y);
  const float py = crs(ray.dz, e2x, ray.dx, e2z);
  const float pz = crs(ray.dx, e2y, ray.dy, e2x);
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  if (!(det > 0.f)) return false;  // backface cull; dead lanes: det == 0
  const float invd = __frcp_rn(det);
  const float tx = __fsub_rn(ray.ox, a.x);
  const float ty = __fsub_rn(ray.oy, a.y);
  const float tz = __fsub_rn(ray.oz, a.z);
  const float u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), invd);
  if (!(u >= 0.f && u <= 1.f)) return false;
  const float qx = crs(ty, e1z, tz, e1y);
  const float qy = crs(tz, e1x, tx, e1z);
  const float qz = crs(tx, e1y, ty, e1x);
  const float v = __fmul_rn(dot3(ray.dx, ray.dy, ray.dz, qx, qy, qz), invd);
  if (!(v >= 0.f && __fadd_rn(u, v) <= 1.f)) return false;
  const float tt = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), invd);
  if (!(tt > 0.f && c.y >= 0.f)) return false;
  *t = tt;
  *u_out = u;
  *v_out = v;
  return true;
}

// mt_hit_uv without u and v: writes t and returns true on a hit.
__device__ __forceinline__ bool mt_hit(const Ray& ray, float4 a, float4 b,
                                       float4 c, float* t) {
  float u, v;
  return mt_hit_uv(ray, a, b, c, t, &u, &v);
}

// x rounded to bf16 (nearest even) and back: the value a torch bf16 op
// stores for the f32 result x
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float dot3_bf(float x0, float x1, float x2,
                                         float a, float b, float c) {
  return bf(__fadd_rn(bf(__fadd_rn(bf(__fmul_rn(x0, a)), bf(__fmul_rn(x1, b)))),
                      bf(__fmul_rn(x2, c))));
}

__device__ __forceinline__ float crs_bf(float x1, float b, float x2,
                                        float a) {
  return bf(__fsub_rn(bf(__fmul_rn(x1, b)), bf(__fmul_rn(x2, a))));
}

// mt_hit in the bf16 preview: the ray and the record (laid out as for
// mt_hit) hold values already rounded to bf16. Writes t and returns true on
// a hit.
__device__ __forceinline__ bool mt_hit_bf16(const Ray& ray, float4 a,
                                            float4 b, float4 c, float* t) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = crs_bf(ray.dy, e2z, ray.dz, e2y);
  const float py = crs_bf(ray.dz, e2x, ray.dx, e2z);
  const float pz = crs_bf(ray.dx, e2y, ray.dy, e2x);
  const float det = dot3_bf(e1x, e1y, e1z, px, py, pz);
  if (!(det > 0.f)) return false;  // backface cull; dead lanes: det == 0
  const float invd = bf(__fdiv_rn(1.f, det));
  const float tx = bf(__fsub_rn(ray.ox, a.x));
  const float ty = bf(__fsub_rn(ray.oy, a.y));
  const float tz = bf(__fsub_rn(ray.oz, a.z));
  const float u = bf(__fmul_rn(dot3_bf(tx, ty, tz, px, py, pz), invd));
  if (!(u >= 0.f && u <= 1.f)) return false;
  const float qx = crs_bf(ty, e1z, tz, e1y);
  const float qy = crs_bf(tz, e1x, tx, e1z);
  const float qz = crs_bf(tx, e1y, ty, e1x);
  const float v = bf(__fmul_rn(dot3_bf(ray.dx, ray.dy, ray.dz, qx, qy, qz),
                               invd));
  if (!(v >= 0.f && bf(__fadd_rn(u, v)) <= 1.f)) return false;
  const float tt = bf(__fmul_rn(dot3_bf(e2x, e2y, e2z, qx, qy, qz), invd));
  if (!(tt > 0.f && c.y >= 0.f && tt < 3.0e38f)) return false;
  *t = tt;
  return true;
}

// A thread's ray from [3, n_rays] arrays: its direction from dir_t, its
// origin from orig_t in the MT form, 0 in the SO form (where the origin is
// folded into the SO records). Shared by the list kernels (plist_super.cu,
// plist_subgate.cu).
template <bool kMT>
__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig_t,
                                        const float* __restrict__ dir_t,
                                        int n_rays, int i) {
  Ray ray;
  ray.dx = dir_t[i];
  ray.dy = dir_t[n_rays + i];
  ray.dz = dir_t[2 * n_rays + i];
  if (kMT) {
    ray.ox = orig_t[i];
    ray.oy = orig_t[n_rays + i];
    ray.oz = orig_t[2 * n_rays + i];
  } else {
    ray.ox = ray.oy = ray.oz = 0.f;
  }
  return ray;
}

// The list kernels' dense test: the ray against n_recs records staged in
// shared memory as three float4s each (cols 0-11 of a 16-float record),
// whose slots are slot0, slot0 + 1, ...; keeps the (min t, then min slot)
// winner in bt/bs, which no order of the tests changes.
template <bool kMT>
__device__ __forceinline__ void nearest_in_window(const Ray& ray,
                                                  const float4* win,
                                                  int n_recs,
                                                  long long slot0, float& bt,
                                                  int& bs) {
  for (int r = 0; r < n_recs; ++r) {
    const float4 p = win[r * 3];
    const float4 q = win[r * 3 + 1];
    const float4 w = win[r * 3 + 2];
    float tt;
    if (kMT ? mt_hit(ray, p, q, w, &tt) : so_hit(ray, p, q, w, &tt)) {
      const int slot = (int)(slot0 + r);
      if (tt < bt || (tt == bt && slot < bs)) {
        bt = tt;
        bs = slot;
      }
    }
  }
}

// The list kernels' split of a lane over kS threads (K1, K1', K2, K10:
// plist_super.cu; K11: plist_subgate.cu): thread h * kLanes + l tests the
// h-th share of lane l's records. The lexicographic (t, slot) least of the
// kS winners of each lane goes into every one of them: each thread writes
// its winner into buf, then all read them. The caller's next barrier keeps
// a later merge from overwriting buf before it is read.
template <int kLanes, int kS>
__device__ __forceinline__ void merge_split(float& bt, int& bs, float* buf_t,
                                            int* buf_s) {
  buf_t[threadIdx.x] = bt;
  buf_s[threadIdx.x] = bs;
  __syncthreads();
  const int l = threadIdx.x % kLanes;
  for (int h = 0; h < kS; ++h) {
    const float t = buf_t[h * kLanes + l];
    const int sl = buf_s[h * kLanes + l];
    if (t < bt || (t == bt && sl < bs)) {
      bt = t;
      bs = sl;
    }
  }
}

}  // namespace clpt
