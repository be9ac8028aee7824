// The coefficient-table form of the prim tests, shared by the fused sweep
// (mxu_sweep.cu, TPU kernel 7) and the MXU leaf forms of the grid kernel
// (grid_traverse.cu) and the instanced kernel (sctree_walk.cuh).
//
// Counterpart of pine_tpu/accel/mxu_sweep.py::_pair_t_vals and of
// pine_tpu_torch/accel/mxu_sweep.py (pair_t_vals, features, ordered_values).
// A ray's feature row is F = [dx, dy, dz, ox, oy, oz, 1, 0]; a prim of type
// TID has mxu_m<TID>() pair values, each the dot of F with one column of the
// group's coefficient table (accel/mxu_tables.py), summed in the fixed order
// ((((((f0*w0 + f1*w1) + f2*w2) + f3*w3) + f4*w4) + f5*w5) + f6*w6) + f7*w7.
// The epilogue turns the values into t, or BIG on a miss or outside
// (tmin, limit).  Built without fast math and with -fmad=false, every
// operation rounds as the plain PyTorch version's does.
#pragma once

#include "prim_tests.cuh"

namespace pine {

constexpr int RAY_FEATS = 8;

// Pair values per prim of type TID; 0 for the types with no table.
template <int TID>
__host__ __device__ constexpr int mxu_m() {
  return TID == SPHERE ? 2 : TID == RECT ? 6 : TID == DISK ? 4 : TID == PLANE ? 2
       : TID == TRIANGLE ? 6 : TID == CONE ? 5 : 0;
}

// A ray's feature row and its dots o.d, o.o, d.d as (x0*y0 + x1*y1) + x2*y2.
struct RayFeat {
  float f[RAY_FEATS];
  float odr, oor, ddr;
};

__device__ __forceinline__ RayFeat ray_features(V3 o, V3 d) {
  RayFeat r;
  r.f[0] = d.x; r.f[1] = d.y; r.f[2] = d.z;
  r.f[3] = o.x; r.f[4] = o.y; r.f[5] = o.z;
  r.f[6] = 1.0f; r.f[7] = 0.0f;
  r.odr = o.x * d.x + o.y * d.y + o.z * d.z;
  r.oor = o.x * o.x + o.y * o.y + o.z * o.z;
  r.ddr = d.x * d.x + d.y * d.y + d.z * d.z;
  return r;
}

// The M pair values of one prim: col points at its value-0 coefficient of
// feature 0; feature f of value v lies at col[f * f_stride + v * v_stride].
template <int M>
__device__ __forceinline__ void pair_values(const RayFeat& r, const float* col, int f_stride,
                                            int v_stride, float* val) {
#pragma unroll
  for (int v = 0; v < M; ++v) {
    const float* w = col + v * v_stride;
    float s = r.f[0] * w[0];
#pragma unroll
    for (int f = 1; f < RAY_FEATS; ++f) s = s + r.f[f] * w[f * f_stride];
    val[v] = s;
  }
}

// t of one (ray, prim) pair from its values, BIG on a miss.
template <int TID>
__device__ __forceinline__ float mxu_pair_t(const float* val, const RayFeat& r, float tmin,
                                            float limit) {
  float t;
  bool ok;
  if constexpr (TID == CONE) {
    float dn = val[0], on = val[1], pd = val[2], op = val[3], hp = val[4];
    float od = r.odr - pd;
    float oo = r.oor + op;
    float a = r.ddr - dn * dn;
    float b = 2.0f * (od - on * dn);
    float c = oo - on * on;
    float disc = b * b - 4.0f * a * c;
    float sq = sqrtf(vmax(disc, 0.0f));
    float a_safe = a == 0.0f ? 1e-6f : a;
    float t0 = (-b - sq) / (2.0f * a_safe);
    t = t0 < tmin ? t0 + sq / a_safe : t0;
    float height = on + t * dn;
    ok = disc > 0.0f && height < 0.0f && height >= -hp;
  } else if constexpr (TID == SPHERE) {
    float b = r.odr - val[0];
    float cc = r.oor + val[1];
    float disc = b * b - cc;
    float sq = sqrtf(vmax(disc, 0.0f));
    float t0 = -b - sq;
    t = t0 < tmin ? -b + sq : t0;
    ok = disc > 0.0f;
  } else if constexpr (TID == RECT) {
    t = val[0] / (val[1] == 0.0f ? 1e-12f : val[1]);
    float u = val[2] + t * val[3];
    float v = val[4] + t * val[5];
    ok = fabsf(u) <= 0.5f && fabsf(v) <= 0.5f;
  } else if constexpr (TID == DISK) {
    t = val[0] / (val[1] == 0.0f ? 1e-12f : val[1]);
    // |o + t d - p|^2 - r^2 = (oo' - r^2) + 2 t od' + t^2 d.d
    float f = (r.oor + val[3]) + 2.0f * t * (r.odr - val[2]) + t * t * r.ddr;
    ok = f <= 0.0f;
  } else if constexpr (TID == PLANE) {
    t = val[0] / (val[1] == 0.0f ? 1e-12f : val[1]);
    ok = true;
  } else {  // TRIANGLE
    float dng = val[0];
    t = val[1] / (dng == 0.0f ? 1e-12f : dng);
    float u = val[2] + t * val[3];
    float v = val[4] + t * val[5];
    ok = dng != 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
  }
  return (ok && t > tmin && t < limit) ? t : BIG;
}

// The MXU leaf test of prim e of a supercell-major table (n_super * 8,
// M * 128) (accel/mxu_tables.build_mesh_tables).
template <int TID>
__device__ __forceinline__ float mesh_pair_t(const float* __restrict__ wm, int e,
                                             const RayFeat& r, float tmin, float limit) {
  constexpr int M = mxu_m<TID>();
  float val[M];
  const float* col = wm + (size_t)(e / 128) * RAY_FEATS * M * 128 + (e % 128);
  pair_values<M>(r, col, M * 128, 128, val);
  return mxu_pair_t<TID>(val, r, tmin, limit);
}

}  // namespace pine
