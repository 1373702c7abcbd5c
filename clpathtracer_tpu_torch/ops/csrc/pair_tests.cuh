// Ray-triangle pair tests shared by the port's kernels: K1 and K1'
// (plist_super.cu) and K3 (packet_stream.cu). One copy, so every kernel
// rounds a pair as the others and as the plain torch versions do.
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
//     the pairs that the det, u or v branch rejects.
//
// Rejection is a branch, never an arithmetic blend: pad records and dead
// lanes (direction exactly 0, so det is exactly 0) would give inf or NaN.
// The tests use __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__frcp_rn, which
// are never contracted into FMA, in the order the plain versions use; the
// library is built with --fmad=false besides.

#pragma once

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
// c = (e2.z, tri_id, 0, 0). Writes t and returns true on a hit.
__device__ __forceinline__ bool mt_hit(const Ray& ray, float4 a, float4 b,
                                       float4 c, float* t) {
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
  return true;
}

}  // namespace clpt
