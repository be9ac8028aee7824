// The cone-sweep probe for Hopper (sm_90a): the dense kernel's cone sweep
// with parts of its work taken out, to split one sweep's time into its parts.
//
// Replaces the inline kernel of scripts_cone_probe.py::_probe_call, the
// Pallas TPU kernel that sweeps every row of a cone group (no group-box
// cull) for an (8,128) block of rays with one of seven variants of the cone
// test (scripts_cone_probe.py::_variant_test):
//   full      the cone test and the best_t / best_e select     (baseline)
//   inva      one reciprocal feeds both roots (vs two divisions)
//   nodiv     the square root kept, the divisions made multiplications
//   nosqrt    the divisions kept, the square root made a multiplication
//   rawmath   every fetch, the polynomial only (no sqrt, no division)
//   onefetch  one fetch a row, three products (the loop's floor)
//   noselect  the full test, the select dropped: every t summed into acc,
//             out t = acc * 1e-30 + best_t, out id = the id in
// Every variant but full and inva gives wrong answers on purpose: it only
// times.  The contract is the TPU kernel's: closest-hit (best_t, best_e) in
// and out, a row replaces the running best on a strict t < best_t, and the
// running best is each test's tmax.
//
// What bounds it: arithmetic.  Each ray runs the cone test on every row (a
// few dozen FP32 operations with IEEE divisions and a square root) and
// reads 36 bytes of ray state; the rows are a few kilobytes shared by all
// rays.
//
// Design: the dense kernel's (csrc/dense_traverse.cu), so that the probe
// decomposes that kernel's time: one thread per ray, 256 threads a block,
// the rows read through the read-only cache (every thread of a warp reads
// the same row address at the same step, so the loads broadcast; no shared
// memory), one kernel instantiated per variant.  ``full`` and ``noselect``
// call prim_tests.cuh::test_cone itself.  Built as the dense kernel is,
// without fast math and with -fmad=false (cuda_build.NVCC_FLAGS): the
// arithmetic is the plain PyTorch version's rounded sequence
// (lab/cone_probe.py), and a build with fused multiply-adds would time
// another kernel.

#include "prim_tests.cuh"

namespace {

using namespace pine;

enum { FULL = 0, INVA = 1, NODIV = 2, NOSQRT = 3, RAWMATH = 4, ONEFETCH = 5, NOSELECT = 6 };

template <int V>
__device__ __forceinline__ float probe_test(const GlobalRow& r, V3 o, V3 d, float tmin,
                                            float tmax) {
  if constexpr (V == FULL || V == NOSELECT) {
    return test_cone(r, o, d, tmin, tmax);
  } else if constexpr (V == ONEFETCH) {
    float ax = r(0);
    float t = (o.x - ax) * d.x + (o.y - ax) * d.y + (o.z - ax) * d.z;
    return finish(t, t > 0.0f, tmin, tmax);
  } else {
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
    if constexpr (V == RAWMATH) {
      return finish(disc + dn + od, disc > 0.0f, tmin, tmax);
    } else {
      float sq = V == NOSQRT ? disc * 0.5f : sqrtf(vmax(disc, 0.0f));
      float a_safe = a == 0.0f ? 1e-6f : a;
      float t;
      if constexpr (V == NODIV) {
        float t0 = (-b - sq) * (2.0f * a_safe);
        t = t0 < tmin ? t0 + sq * a_safe : t0;
      } else if constexpr (V == INVA) {
        float inva = 0.5f / a_safe;
        float t0 = (-b - sq) * inva;
        t = t0 < tmin ? t0 + 2.0f * sq * inva : t0;
      } else {  // NOSQRT
        float t0 = (-b - sq) / (2.0f * a_safe);
        t = t0 < tmin ? t0 + sq / a_safe : t0;
      }
      float height = on + t * dn;
      bool ok = disc > 0.0f && height < 0.0f && height >= -h;
      return finish(t, ok, tmin, tmax);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(256)
probe_kernel(const float* __restrict__ rows, int width, int n_prims,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ tmin_in, const float* __restrict__ bt_in,
             const int* __restrict__ be_in, float* __restrict__ bt_out,
             int* __restrict__ be_out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  float tmin = tmin_in[i];
  float bt = bt_in[i];
  int be = be_in[i];
  float acc = bt;
  for (int e = 0; e < n_prims; ++e) {
    float tt = probe_test<V>(GlobalRow{rows + e * width}, o, d, tmin, bt);
    if (V == NOSELECT) {
      acc = acc + tt;  // keeps the test live without the select
    } else if (tt < bt) {
      bt = tt;
      be = e;
    }
  }
  bt_out[i] = V == NOSELECT ? acc * 1e-30f + bt : bt;
  be_out[i] = be;
}

template <int V>
void launch(const float* rows, int width, int n_prims, const float* ro, const float* rd,
            const float* tmin, const float* bt_in, const int* be_in, float* bt_out,
            int* be_out, int n, cudaStream_t stream) {
  probe_kernel<V><<<(n + 255) / 256, 256, 0, stream>>>(rows, width, n_prims, ro, rd, tmin,
                                                       bt_in, be_in, bt_out, be_out, n);
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// an unknown variant returns cudaErrorInvalidValue without launching.
extern "C" int pine_cone_probe(int variant, const float* rows, int width, int n_prims,
                               const float* ro, const float* rd, const float* tmin,
                               const float* bt_in, const int* be_in, float* bt_out,
                               int* be_out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINE_CASE(V)                                                                     \
  case V:                                                                                \
    launch<V>(rows, width, n_prims, ro, rd, tmin, bt_in, be_in, bt_out, be_out, n, s); \
    break;
  switch (variant) {
    PINE_CASE(FULL)
    PINE_CASE(INVA)
    PINE_CASE(NODIV)
    PINE_CASE(NOSQRT)
    PINE_CASE(RAWMATH)
    PINE_CASE(ONEFETCH)
    PINE_CASE(NOSELECT)
    default:
      return cudaErrorInvalidValue;
  }
#undef PINE_CASE
  return cudaGetLastError();
}
