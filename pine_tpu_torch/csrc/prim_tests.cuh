// Per-type ray tests on one prim row, shared by the traversal kernels
// (dense_traverse.cu, grid_traverse.cu).  Counterpart of PRIM_TESTS in
// pine_tpu/accel/pallas_traverse.py and pine_tpu_torch/accel/dense_traverse.py:
// the same rounded sequence of operations as the plain PyTorch versions when
// built without fast math and with -fmad=false.  prim_test returns t, or BIG
// on a miss or outside (tmin, tmax).
#pragma once

#include <cuda_runtime.h>

namespace pine {

constexpr float BIG = 1e30f;

enum { SPHERE = 0, RECT = 1, DISK = 2, PLANE = 3, BOX_AABB = 4, BOX_OBB = 5,
       TRIANGLE = 6, CONE = 7, CYLINDER = 8 };

struct V3 { float x, y, z; };

// jnp.maximum / torch.maximum propagate NaN; fmaxf does not.
__device__ __forceinline__ float vmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float vmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < 1e-9f ? (d < 0.0f ? -1e-9f : 1e-9f) : d;
  return 1.0f / s;
}

__device__ __forceinline__ float finish(float t, bool ok, float tmin, float tmax) {
  return (ok && t > tmin && t < tmax) ? t : BIG;
}

__device__ __forceinline__ float ld(const float* r, int c) { return __ldg(r + c); }

template <int TID>
__device__ float prim_test(const float* r, V3 o, V3 d, float tmin, float tmax);

template <>
__device__ __forceinline__ float prim_test<RECT>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float px = ld(r, 0), py = ld(r, 1), pz = ld(r, 2);
  float exx = ld(r, 3), exy = ld(r, 4), exz = ld(r, 5);
  float eyx = ld(r, 6), eyy = ld(r, 7), eyz = ld(r, 8);
  float nx = ld(r, 9), ny = ld(r, 10), nz = ld(r, 11);
  float lx = ld(r, 12), ly = ld(r, 13);
  float denom = d.x * nx + d.y * ny + d.z * nz;
  denom = denom == 0.0f ? 1e-12f : denom;
  float t = ((px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz) / denom;
  float hx = o.x + t * d.x - px;
  float hy = o.y + t * d.y - py;
  float hz = o.z + t * d.z - pz;
  float u = (hx * exx + hy * exy + hz * exz) / lx;
  float v = (hx * eyx + hy * eyy + hz * eyz) / ly;
  bool ok = fabsf(u) <= 0.5f && fabsf(v) <= 0.5f;
  return finish(t, ok, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<SPHERE>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float cx = ld(r, 0), cy = ld(r, 1), cz = ld(r, 2), rad = ld(r, 3);
  float rx = o.x - cx, ry = o.y - cy, rz = o.z - cz;
  float b = rx * d.x + ry * d.y + rz * d.z;
  float cc = rx * rx + ry * ry + rz * rz - rad * rad;
  float disc = b * b - cc;
  float sq = sqrtf(vmax(disc, 0.0f));
  float t0 = -b - sq;
  float t = t0 < tmin ? -b + sq : t0;
  return finish(t, disc > 0.0f, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<TRIANGLE>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float v0x = ld(r, 0), v0y = ld(r, 1), v0z = ld(r, 2);
  float e1x = ld(r, 3) - v0x, e1y = ld(r, 4) - v0y, e1z = ld(r, 5) - v0z;
  float e2x = ld(r, 6) - v0x, e2y = ld(r, 7) - v0y, e2z = ld(r, 8) - v0z;
  float tx = o.x - v0x, ty = o.y - v0y, tz = o.z - v0z;
  float px = d.y * e2z - d.z * e2y;
  float py = d.z * e2x - d.x * e2z;
  float pz = d.x * e2y - d.y * e2x;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float det = px * e1x + py * e1y + pz * e1z;
  float inv = 1.0f / (det == 0.0f ? 1.0f : det);
  float t = (qx * e2x + qy * e2y + qz * e2z) * inv;
  float u = (px * tx + py * ty + pz * tz) * inv;
  float v = (qx * d.x + qy * d.y + qz * d.z) * inv;
  bool ok = det != 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
  return finish(t, ok, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<CONE>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float ax = ld(r, 0), ay = ld(r, 1), az = ld(r, 2);
  float nx = ld(r, 3), ny = ld(r, 4), nz = ld(r, 5);
  float A2 = ld(r, 6), h = ld(r, 10);
  float ox = o.x - ax, oy = o.y - ay, oz = o.z - az;
  float dn = d.x * nx + d.y * ny + d.z * nz;
  float on = ox * nx + oy * ny + oz * nz;
  float dd = d.x * d.x + d.y * d.y + d.z * d.z;
  float od = ox * d.x + oy * d.y + oz * d.z;
  float oo = ox * ox + oy * oy + oz * oz;
  float a = -A2 * dn * dn + dd;
  float b = 2.0f * (-A2 * on * dn + od);
  float c = -A2 * on * on + oo;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(vmax(disc, 0.0f));
  float a_safe = a == 0.0f ? 1e-6f : a;
  float t0 = (-b - sq) / (2.0f * a_safe);
  float t = t0 < tmin ? t0 + sq / a_safe : t0;
  float height = on + t * dn;
  bool ok = disc > 0.0f && height < 0.0f && height >= -h;
  return finish(t, ok, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<BOX_AABB>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float inv0 = safe_inv(d.x), inv1 = safe_inv(d.y), inv2 = safe_inv(d.z);
  float lx = ld(r, 0), ly = ld(r, 1), lz = ld(r, 2);
  float ux = ld(r, 3), uy = ld(r, 4), uz = ld(r, 5);
  float t0x = (lx - o.x) * inv0, t1x = (ux - o.x) * inv0;
  float t0y = (ly - o.y) * inv1, t1y = (uy - o.y) * inv1;
  float t0z = (lz - o.z) * inv2, t1z = (uz - o.z) * inv2;
  float near = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmax(vmin(t0z, t1z), tmin));
  float far = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmin(vmax(t0z, t1z), tmax));
  bool ok = near <= far;
  float t = near > tmin ? near : far;
  return finish(t, ok, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<BOX_OBB>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float lx = ld(r, 0), ly = ld(r, 1), lz = ld(r, 2);
  float ux = ld(r, 3), uy = ld(r, 4), uz = ld(r, 5);
  const float* m = r + 6;    // world <- local, 3x4 row-major
  const float* mi = r + 18;  // local <- world
  float olx = ld(mi, 0) * o.x + ld(mi, 1) * o.y + ld(mi, 2) * o.z + ld(mi, 3);
  float oly = ld(mi, 4) * o.x + ld(mi, 5) * o.y + ld(mi, 6) * o.z + ld(mi, 7);
  float olz = ld(mi, 8) * o.x + ld(mi, 9) * o.y + ld(mi, 10) * o.z + ld(mi, 11);
  float dlx = ld(mi, 0) * d.x + ld(mi, 1) * d.y + ld(mi, 2) * d.z;
  float dly = ld(mi, 4) * d.x + ld(mi, 5) * d.y + ld(mi, 6) * d.z;
  float dlz = ld(mi, 8) * d.x + ld(mi, 9) * d.y + ld(mi, 10) * d.z;
  float dn = sqrtf(dlx * dlx + dly * dly + dlz * dlz);
  dn = vmax(dn, 1e-20f);
  dlx = dlx / dn; dly = dly / dn; dlz = dlz / dn;
  float inv0 = safe_inv(dlx), inv1 = safe_inv(dly), inv2 = safe_inv(dlz);
  float t0x = (lx - olx) * inv0, t1x = (ux - olx) * inv0;
  float t0y = (ly - oly) * inv1, t1y = (uy - oly) * inv1;
  float t0z = (lz - olz) * inv2, t1z = (uz - olz) * inv2;
  float near = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmax(vmin(t0z, t1z), 0.0f));
  float far = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmin(vmax(t0z, t1z), BIG));
  bool ok = near <= far;
  float t_l = near > 0.0f ? near : far;
  float plx = olx + t_l * dlx, ply = oly + t_l * dly, plz = olz + t_l * dlz;
  float pwx = ld(m, 0) * plx + ld(m, 1) * ply + ld(m, 2) * plz + ld(m, 3);
  float pwy = ld(m, 4) * plx + ld(m, 5) * ply + ld(m, 6) * plz + ld(m, 7);
  float pwz = ld(m, 8) * plx + ld(m, 9) * ply + ld(m, 10) * plz + ld(m, 11);
  float ex = pwx - o.x, ey = pwy - o.y, ez = pwz - o.z;
  float t = sqrtf(ex * ex + ey * ey + ez * ez);
  return finish(t, ok, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<DISK>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float px = ld(r, 0), py = ld(r, 1), pz = ld(r, 2);
  float nx = ld(r, 3), ny = ld(r, 4), nz = ld(r, 5);
  float rad = ld(r, 12);
  float denom = d.x * nx + d.y * ny + d.z * nz;
  denom = denom == 0.0f ? 1e-12f : denom;
  float t = ((px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz) / denom;
  float hx = o.x + t * d.x - px;
  float hy = o.y + t * d.y - py;
  float hz = o.z + t * d.z - pz;
  bool ok = hx * hx + hy * hy + hz * hz <= rad * rad;
  return finish(t, ok, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<PLANE>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float px = ld(r, 0), py = ld(r, 1), pz = ld(r, 2);
  float nx = ld(r, 3), ny = ld(r, 4), nz = ld(r, 5);
  float denom = d.x * nx + d.y * ny + d.z * nz;
  denom = denom == 0.0f ? 1e-12f : denom;
  float t = ((px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz) / denom;
  return finish(t, true, tmin, tmax);
}

template <>
__device__ __forceinline__ float prim_test<CYLINDER>(const float* r, V3 o, V3 d, float tmin, float tmax) {
  float px = ld(r, 0), py = ld(r, 1), pz = ld(r, 2);
  float qx = ld(r, 3), qy = ld(r, 4), qz = ld(r, 5);
  float nx = ld(r, 6), ny = ld(r, 7), nz = ld(r, 8);
  float rad = ld(r, 9);
  float mx = o.x - px, my = o.y - py, mz = o.z - pz;
  float dn = d.x * nx + d.y * ny + d.z * nz;
  float vx = d.x - dn * nx, vy = d.y - dn * ny, vz = d.z - dn * nz;
  float mn = mx * nx + my * ny + mz * nz;
  float wx = mx - mn * nx, wy = my - mn * ny, wz = mz - mn * nz;
  float a = vx * vx + vy * vy + vz * vz;
  float b = 2.0f * (vx * wx + vy * wy + vz * wz);
  float c = wx * wx + wy * wy + wz * wz - rad * rad;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(vmax(disc, 0.0f));
  float a_safe = a == 0.0f ? 1e-6f : a;
  float t0 = (-b - sq) / (2.0f * a_safe);
  float t = t0 < tmin ? (-b + sq) / (2.0f * a_safe) : t0;
  float axial = mn + t * dn;
  float len_ax = (qx - px) * nx + (qy - py) * ny + (qz - pz) * nz;
  bool ok = disc >= 0.0f && axial >= 0.0f && axial <= len_ax;
  return finish(t, ok, tmin, tmax);
}

// Slab test of one box (lo xyz, hi xyz) against a ray with inverse direction
// inv: true when the ray's window (tmin, lim) reaches the box.  The same
// formula as the Pallas kernels' culls (pallas_traverse.py:878-910).
__device__ __forceinline__ bool slab_hit(const float* __restrict__ box, V3 o, V3 inv,
                                         float tmin, float lim) {
  float t0x = (__ldg(box + 0) - o.x) * inv.x, t1x = (__ldg(box + 3) - o.x) * inv.x;
  float t0y = (__ldg(box + 1) - o.y) * inv.y, t1y = (__ldg(box + 4) - o.y) * inv.y;
  float t0z = (__ldg(box + 2) - o.z) * inv.z, t1z = (__ldg(box + 5) - o.z) * inv.z;
  float near = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmax(vmin(t0z, t1z), tmin));
  float far = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmin(vmax(t0z, t1z), lim));
  return near <= far;
}

}  // namespace pine
