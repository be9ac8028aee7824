// The coefficient-table form of the prim tests, shared by the fused sweep
// (mxu_sweep.cu: TPU kernel 7, pine_tpu/accel/mxu_sweep.py::
// _make_fused_kernel) and the MXU leaf forms of the grid kernel
// (grid_traverse.cu: kernel 5m, pallas_traverse.py::_make_grid_kernel with
// mxu_m > 0) and the instanced kernel (inst_traverse.cu through
// warp_leaf.cuh's warp_cells_mxu: kernel 8m).
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
//
// What bounds it on this card: operations.  On the TPU the pair values came
// from the MXU, one matmul per block; here a triangle pair costs six 8-term
// sums (90 FP32 operations unfused, 48 table reads) before an epilogue of
// about 10 and one IEEE division, where the VPU test takes 52 and 12 reads.
// The tables are read from shared memory, where each kernel stages them:
// kernel 7 its 128-prim tiles, kernel 5m each taken supercell's strip (one
// bulk asynchronous copy per block, grid_traverse.cu), kernel 8m each taken
// cell's slice (cp.async per warp, warp_leaf.cuh).  The tensor cores were
// weighed for the sums (mma.sync.m16n8k8 in TF32 with the 3xTF32 split):
// emulated on the CPU (tests/test_torch_mxu.py) they put 1.2e-3 of a
// reduced terrain render's bounce rays outside the 1e-4 gate against the
// ordered sums, so the sums stay on the CUDA cores; the exact three-way TF32 split (six products per
// value) meets it (5.4e-5) and is the lead for a later tensor-core leaf.
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

// A kernel's two-stage ring of table slices (kernel 5m's supercell strips,
// kernel 7's tiles), each slice one bulk asynchronous copy (cp.async.bulk,
// the 1-D form of the TMA) completing on its stage's mbarrier.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Thread 0 readies the ring's two barriers, before the block's first barrier.
__device__ __forceinline__ void init_bulk_barriers(unsigned long long* bar) {
  for (int s = 0; s < 2; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Thread 0 asks the bulk copy engine for one slice; the barrier's phase
// completes when its bytes have landed.
__device__ __forceinline__ void bulk_fetch(float* dst, const float* src, unsigned bytes,
                                           unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void bulk_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// t of one (ray, prim) pair from its values, BIG on a miss.  With EARLY, a
// cone or sphere pair whose discriminant is not positive returns BIG before
// its square root and divisions: the same value, since such a pair misses.
template <int TID, bool EARLY = false>
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
    if (EARLY && !(disc > 0.0f)) return BIG;
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
    if (EARLY && !(disc > 0.0f)) return BIG;
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

// The MXU leaf test of prim e (0..127) of one supercell's (8, M * 128)
// value-major strip (a row block of accel/mxu_tables.build_mesh_tables'
// table), in global or shared memory.
template <int TID>
__device__ __forceinline__ float strip_pair_t(const float* strip, int e, const RayFeat& r,
                                              float tmin, float limit) {
  constexpr int M = mxu_m<TID>();
  float val[M];
  pair_values<M>(r, strip + e, M * 128, 128, val);
  return mxu_pair_t<TID>(val, r, tmin, limit);
}

}  // namespace pine
