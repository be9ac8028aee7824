// Per-type ray tests on one prim row, shared by the traversal kernels
// (dense_traverse.cu, scdense_traverse.cu, grid_traverse.cu,
// sctree_traverse.cu, bvh_traverse.cu, inst_traverse.cu,
// lattice_traverse.cu, cone_probe.cu), and the slab tests and stack push of
// their culls.
// Counterpart of PRIM_TESTS in
// pine_tpu/accel/pallas_traverse.py and pine_tpu_torch/accel/dense_traverse.py:
// the same rounded sequence of operations as the plain PyTorch versions when
// built without fast math and with -fmad=false.  A test returns t, or BIG on a
// miss or outside (tmin, tmax).
//
// The tests read the row through an accessor ``r(c)`` -> column c, as the TPU
// kernels pass ``fetch`` to PRIM_TESTS: ``prim_test<TID>(const float* row)``
// reads a row of a table in global memory (GlobalRow, through the read-only
// cache); the BVH kernel reads its rows padded to 16 bytes from global
// memory as vectors (GlobalRowV); the grid, supercell-tree and instanced
// kernels pass rows they staged in shared memory, the dense and scdense
// kernels their rows padded to 16 bytes (SharedRow); the lattice kernel
// passes a row it rebuilds in registers.
//
// EARLY (prim_test_row<TID, true>, the form of the dense, scdense, BVH and
// lattice kernels and of the cone-sweep probe): the exact early misses.  A
// cone or sphere whose discriminant is not positive, a cylinder whose
// discriminant is negative (each test's own ok condition, so NaN misses
// too) returns BIG before its square root and divisions, and a rect whose
// plane t lies outside (tmin, tmax) before the divisions of u and v: finish
// would return BIG for each of them, so every result is the same.  The
// other kernels call the tests with EARLY false, without them.
#pragma once

#include <cuda_runtime.h>

namespace pine {

constexpr float BIG = 1e30f;

enum { SPHERE = 0, RECT = 1, DISK = 2, PLANE = 3, BOX_AABB = 4, BOX_OBB = 5,
       TRIANGLE = 6, CONE = 7, CYLINDER = 8 };

struct V3 { float x, y, z; };

// Floats in one prim row of shape type TID (scene/shapes.PARAM_WIDTH).
template <int TID>
__host__ __device__ constexpr int prim_width() {
  return TID == SPHERE ? 4 : TID == RECT ? 15 : TID == DISK ? 13 : TID == PLANE ? 12
       : TID == BOX_AABB ? 6 : TID == BOX_OBB ? 30 : TID == TRIANGLE ? 12 : TID == CONE ? 12
       : 10;
}

// A row of shape type TID as the dense, scdense and BVH kernels read it: its
// width rounded up to a multiple of 4 floats (dense_traverse.padded_width).
template <int TID>
__host__ __device__ constexpr int padded_width() { return (prim_width<TID>() + 3) / 4 * 4; }

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

// A prim row of a table in global memory.
struct GlobalRow {
  const float* p;
  __device__ __forceinline__ float operator()(int c) const { return __ldg(p + c); }
};

// A prim row of W floats (a multiple of 4) in global memory, starting on a
// 16-byte boundary, read into registers as 16-byte vectors through the
// read-only path (ld.global.nc.v4): W / 4 loads where GlobalRow issues W.
// ``load`` only issues them, so several rows can be in flight at once.
template <int W>
struct GlobalRowV {
  static_assert(W % 4 == 0, "a vector row is whole 16-byte vectors");
  float v[W];
  __device__ __forceinline__ void load(const float* g) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      float4 x = __ldg(reinterpret_cast<const float4*>(g) + q);
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
    }
  }
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};

// A prim row of W floats staged in shared memory, read into registers once:
// as 16-byte vectors when W is a multiple of 4 (the row then starts on a
// 16-byte boundary), else float by float.
template <int W>
struct SharedRow {
  float v[W];
  __device__ __forceinline__ explicit SharedRow(const float* s) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        float4 x = reinterpret_cast<const float4*>(s)[q];
        v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) v[c] = s[c];
    }
  }
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};

template <bool EARLY = false, class R>
__device__ __forceinline__ float test_rect(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float px = r(0), py = r(1), pz = r(2);
  float exx = r(3), exy = r(4), exz = r(5);
  float eyx = r(6), eyy = r(7), eyz = r(8);
  float nx = r(9), ny = r(10), nz = r(11);
  float lx = r(12), ly = r(13);
  float denom = d.x * nx + d.y * ny + d.z * nz;
  denom = denom == 0.0f ? 1e-12f : denom;
  float t = ((px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz) / denom;
  if (EARLY && !(t > tmin && t < tmax)) return BIG;
  float hx = o.x + t * d.x - px;
  float hy = o.y + t * d.y - py;
  float hz = o.z + t * d.z - pz;
  float u = (hx * exx + hy * exy + hz * exz) / lx;
  float v = (hx * eyx + hy * eyy + hz * eyz) / ly;
  bool ok = fabsf(u) <= 0.5f && fabsf(v) <= 0.5f;
  return finish(t, ok, tmin, tmax);
}

template <bool EARLY = false, class R>
__device__ __forceinline__ float test_sphere(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float cx = r(0), cy = r(1), cz = r(2), rad = r(3);
  float rx = o.x - cx, ry = o.y - cy, rz = o.z - cz;
  float b = rx * d.x + ry * d.y + rz * d.z;
  float cc = rx * rx + ry * ry + rz * rz - rad * rad;
  float disc = b * b - cc;
  if (EARLY && !(disc > 0.0f)) return BIG;
  float sq = sqrtf(vmax(disc, 0.0f));
  float t0 = -b - sq;
  float t = t0 < tmin ? -b + sq : t0;
  return finish(t, disc > 0.0f, tmin, tmax);
}

template <class R>
__device__ __forceinline__ float test_triangle(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float v0x = r(0), v0y = r(1), v0z = r(2);
  float e1x = r(3) - v0x, e1y = r(4) - v0y, e1z = r(5) - v0z;
  float e2x = r(6) - v0x, e2y = r(7) - v0y, e2z = r(8) - v0z;
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

template <bool EARLY = false, class R>
__device__ __forceinline__ float test_cone(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float ax = r(0), ay = r(1), az = r(2);
  float nx = r(3), ny = r(4), nz = r(5);
  float A2 = r(6), h = r(10);
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
  if (EARLY && !(disc > 0.0f)) return BIG;
  float sq = sqrtf(vmax(disc, 0.0f));
  float a_safe = a == 0.0f ? 1e-6f : a;
  float t0 = (-b - sq) / (2.0f * a_safe);
  float t = t0 < tmin ? t0 + sq / a_safe : t0;
  float height = on + t * dn;
  bool ok = disc > 0.0f && height < 0.0f && height >= -h;
  return finish(t, ok, tmin, tmax);
}

template <class R>
__device__ __forceinline__ float test_aabb(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float inv0 = safe_inv(d.x), inv1 = safe_inv(d.y), inv2 = safe_inv(d.z);
  float lx = r(0), ly = r(1), lz = r(2);
  float ux = r(3), uy = r(4), uz = r(5);
  float t0x = (lx - o.x) * inv0, t1x = (ux - o.x) * inv0;
  float t0y = (ly - o.y) * inv1, t1y = (uy - o.y) * inv1;
  float t0z = (lz - o.z) * inv2, t1z = (uz - o.z) * inv2;
  float near = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmax(vmin(t0z, t1z), tmin));
  float far = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmin(vmax(t0z, t1z), tmax));
  bool ok = near <= far;
  float t = near > tmin ? near : far;
  return finish(t, ok, tmin, tmax);
}

template <class R>
__device__ __forceinline__ float test_obb(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float lx = r(0), ly = r(1), lz = r(2);
  float ux = r(3), uy = r(4), uz = r(5);
  auto m = [&](int c) { return r(6 + c); };    // world <- local, 3x4 row-major
  auto mi = [&](int c) { return r(18 + c); };  // local <- world
  float olx = mi(0) * o.x + mi(1) * o.y + mi(2) * o.z + mi(3);
  float oly = mi(4) * o.x + mi(5) * o.y + mi(6) * o.z + mi(7);
  float olz = mi(8) * o.x + mi(9) * o.y + mi(10) * o.z + mi(11);
  float dlx = mi(0) * d.x + mi(1) * d.y + mi(2) * d.z;
  float dly = mi(4) * d.x + mi(5) * d.y + mi(6) * d.z;
  float dlz = mi(8) * d.x + mi(9) * d.y + mi(10) * d.z;
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
  float pwx = m(0) * plx + m(1) * ply + m(2) * plz + m(3);
  float pwy = m(4) * plx + m(5) * ply + m(6) * plz + m(7);
  float pwz = m(8) * plx + m(9) * ply + m(10) * plz + m(11);
  float ex = pwx - o.x, ey = pwy - o.y, ez = pwz - o.z;
  float t = sqrtf(ex * ex + ey * ey + ez * ez);
  return finish(t, ok, tmin, tmax);
}

template <class R>
__device__ __forceinline__ float test_disk(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float px = r(0), py = r(1), pz = r(2);
  float nx = r(3), ny = r(4), nz = r(5);
  float rad = r(12);
  float denom = d.x * nx + d.y * ny + d.z * nz;
  denom = denom == 0.0f ? 1e-12f : denom;
  float t = ((px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz) / denom;
  float hx = o.x + t * d.x - px;
  float hy = o.y + t * d.y - py;
  float hz = o.z + t * d.z - pz;
  bool ok = hx * hx + hy * hy + hz * hz <= rad * rad;
  return finish(t, ok, tmin, tmax);
}

template <class R>
__device__ __forceinline__ float test_plane(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float px = r(0), py = r(1), pz = r(2);
  float nx = r(3), ny = r(4), nz = r(5);
  float denom = d.x * nx + d.y * ny + d.z * nz;
  denom = denom == 0.0f ? 1e-12f : denom;
  float t = ((px - o.x) * nx + (py - o.y) * ny + (pz - o.z) * nz) / denom;
  return finish(t, true, tmin, tmax);
}

template <bool EARLY = false, class R>
__device__ __forceinline__ float test_cylinder(const R& r, V3 o, V3 d, float tmin, float tmax) {
  float px = r(0), py = r(1), pz = r(2);
  float qx = r(3), qy = r(4), qz = r(5);
  float nx = r(6), ny = r(7), nz = r(8);
  float rad = r(9);
  float mx = o.x - px, my = o.y - py, mz = o.z - pz;
  float dn = d.x * nx + d.y * ny + d.z * nz;
  float vx = d.x - dn * nx, vy = d.y - dn * ny, vz = d.z - dn * nz;
  float mn = mx * nx + my * ny + mz * nz;
  float wx = mx - mn * nx, wy = my - mn * ny, wz = mz - mn * nz;
  float a = vx * vx + vy * vy + vz * vz;
  float b = 2.0f * (vx * wx + vy * wy + vz * wz);
  float c = wx * wx + wy * wy + wz * wz - rad * rad;
  float disc = b * b - 4.0f * a * c;
  if (EARLY && !(disc >= 0.0f)) return BIG;
  float sq = sqrtf(vmax(disc, 0.0f));
  float a_safe = a == 0.0f ? 1e-6f : a;
  float t0 = (-b - sq) / (2.0f * a_safe);
  float t = t0 < tmin ? (-b + sq) / (2.0f * a_safe) : t0;
  float axial = mn + t * dn;
  float len_ax = (qx - px) * nx + (qy - py) * ny + (qz - pz) * nz;
  bool ok = disc >= 0.0f && axial >= 0.0f && axial <= len_ax;
  return finish(t, ok, tmin, tmax);
}

// The test of shape type TID on the row behind accessor r (with EARLY, the
// early misses above).
template <int TID, bool EARLY = false, class R>
__device__ __forceinline__ float prim_test_row(const R& r, V3 o, V3 d, float tmin, float tmax) {
  if constexpr (TID == SPHERE) return test_sphere<EARLY>(r, o, d, tmin, tmax);
  else if constexpr (TID == RECT) return test_rect<EARLY>(r, o, d, tmin, tmax);
  else if constexpr (TID == DISK) return test_disk(r, o, d, tmin, tmax);
  else if constexpr (TID == PLANE) return test_plane(r, o, d, tmin, tmax);
  else if constexpr (TID == BOX_AABB) return test_aabb(r, o, d, tmin, tmax);
  else if constexpr (TID == BOX_OBB) return test_obb(r, o, d, tmin, tmax);
  else if constexpr (TID == TRIANGLE) return test_triangle(r, o, d, tmin, tmax);
  else if constexpr (TID == CONE) return test_cone<EARLY>(r, o, d, tmin, tmax);
  else return test_cylinder<EARLY>(r, o, d, tmin, tmax);
}

// The test of shape type TID on a row of a table in global memory.
template <int TID>
__device__ __forceinline__ float prim_test(const float* row, V3 o, V3 d, float tmin, float tmax) {
  return prim_test_row<TID>(GlobalRow{row}, o, d, tmin, tmax);
}

// Slab test of one box (lo xyz, hi xyz, behind accessor b: b(c) -> its
// coordinate c) against a ray with inverse direction inv: true when the
// ray's window (tmin, lim) reaches the box.  The same formula as the Pallas
// kernels' culls (pallas_traverse.py:878-910).
template <class B>
__device__ __forceinline__ bool slab_test(const B& b, V3 o, V3 inv, float tmin, float lim) {
  float t0x = (b(0) - o.x) * inv.x, t1x = (b(3) - o.x) * inv.x;
  float t0y = (b(1) - o.y) * inv.y, t1y = (b(4) - o.y) * inv.y;
  float t0z = (b(2) - o.z) * inv.z, t1z = (b(5) - o.z) * inv.z;
  float near = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmax(vmin(t0z, t1z), tmin));
  float far = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmin(vmax(t0z, t1z), lim));
  return near <= far;
}

// slab_test on a box in global memory, read through the read-only cache.
__device__ __forceinline__ bool slab_hit(const float* __restrict__ box, V3 o, V3 inv,
                                         float tmin, float lim) {
  return slab_test(GlobalRow{box}, o, inv, tmin, lim);
}

// A box held in registers, for a kernel that reads its boxes as vectors.
struct BoxV {
  float v[6];
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};

// slab_test on a box given by value (lo xyz, hi xyz).
__device__ __forceinline__ bool slab_hit_v(float lx, float ly, float lz, float hx, float hy,
                                           float hz, V3 o, V3 inv, float tmin, float lim) {
  return slab_test(BoxV{{lx, ly, lz, hx, hy, hz}}, o, inv, tmin, lim);
}

// slab_hit that also returns the entry distance.
__device__ __forceinline__ bool slab_near(const float* __restrict__ box, V3 o, V3 inv,
                                          float tmin, float lim, float& near) {
  float t0x = (__ldg(box + 0) - o.x) * inv.x, t1x = (__ldg(box + 3) - o.x) * inv.x;
  float t0y = (__ldg(box + 1) - o.y) * inv.y, t1y = (__ldg(box + 4) - o.y) * inv.y;
  float t0z = (__ldg(box + 2) - o.z) * inv.z, t1z = (__ldg(box + 5) - o.z) * inv.z;
  near = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmax(vmin(t0z, t1z), tmin));
  float far = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmin(vmax(t0z, t1z), lim));
  return near <= far;
}

// One 16-byte asynchronous copy (cp.async) from global into shared memory;
// the bytes past ``bytes`` are zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// Push onto a per-thread stack of CAP entries.  Each wrapper checks the
// tree's need against CAP before it launches, so the trap is unreachable:
// no subtree is ever dropped.
template <int CAP>
__device__ __forceinline__ void push(int* stack, int& sp, int v) {
  if (sp >= CAP) __trap();
  stack[sp++] = v;
}

}  // namespace pine
