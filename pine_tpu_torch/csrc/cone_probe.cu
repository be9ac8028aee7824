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
// rays.  Its first form, one thread per ray reading each row by scalar
// loads through the read-only cache, every pair paying its square root and
// divisions, issued some 150 instructions a pair and ran at 7.8x the full
// sweep's bound (H100 80GB HBM3, 700 W).
//
// Design: the dense kernel's since its redesign (csrc/dense_traverse.cu,
// which the probe decomposes), less the group-box cull and the live-lane
// queue, which the probe by definition has not:
// - the rows (12 floats, a multiple of 4: accel/dense_traverse's
//   padded_width, so the dense kernel's table) are staged once per block
//   into shared memory by cp.async, up to TILE rows at a time, and read as
//   16-byte vectors that broadcast across the warp (SharedRow);
// - the exact early misses: ``full`` and ``noselect`` call
//   prim_tests.cuh::test_cone<EARLY>, as the dense kernel does; ``inva``,
//   ``nodiv``, ``nosqrt`` and ``rawmath`` return BIG where !(disc > 0),
//   before their root and divisions (each requires disc > 0 to hit, so the
//   result is the same, NaN included); ``onefetch`` has no discriminant.
// Measured and not kept (H100 80GB HBM3, 700 W, the sum below the block
// size): two or four rows in flight per thread, their selects applied in
// row order (which keeps the result), 1.902 / 1.828 ms against one row's
// 1.752: with at least 48 warps an SM to hide latency the sweep gains
// nothing from the overlap, and pays for the registers and guards.
// One kernel is instantiated per variant.  Built as the dense kernel is,
// without fast math and with -fmad=false (cuda_build.NVCC_FLAGS): the
// arithmetic is the plain PyTorch version's rounded sequence
// (lab/cone_probe.py), and a build with fused multiply-adds would time
// another kernel.

#include "prim_tests.cuh"

namespace {

using namespace pine;

enum { FULL = 0, INVA = 1, NODIV = 2, NOSQRT = 3, RAWMATH = 4, ONEFETCH = 5, NOSELECT = 6 };

// Rays per block.  Measured on H100 80GB HBM3, 700 W, summed card time of
// the seven variants on the lab's three ray sets of 65,536: 256 rays 1.752
// and 1.762 ms in two runs, 128 rays 1.762 and 1.751; at least 8 blocks of
// 256 per SM (32 registers) 1.748.
constexpr int BLOCK = 256;
constexpr int WP = padded_width<CONE>();  // 12
constexpr int TILE = 512;                 // rows staged at once, as the dense kernel

template <int V, class R>
__device__ __forceinline__ float probe_test(const R& r, V3 o, V3 d, float tmin, float tmax) {
  if constexpr (V == FULL || V == NOSELECT) {
    return test_cone<true>(r, o, d, tmin, tmax);
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
    if (!(disc > 0.0f)) return BIG;  // the early miss
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

// The block copies cnt rows into dst, 16 bytes a thread at a time.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int cnt) {
  for (int q = threadIdx.x; q < cnt * (WP / 4); q += BLOCK)
    cp_async16(dst + 4 * q, src + 4 * q, 16);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void rows_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
probe_kernel(const float* __restrict__ rows, int n_prims,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ tmin_in, const float* __restrict__ bt_in,
             const int* __restrict__ be_in, float* __restrict__ bt_out,
             int* __restrict__ be_out, int n) {
  extern __shared__ __align__(16) float srows[];  // min(n_prims, TILE) rows of WP floats
  stage_rows(srows, rows, min(n_prims, TILE));    // in flight while the rays load
  int i = blockIdx.x * BLOCK + threadIdx.x;
  bool active = i < n;
  V3 o{}, d{};
  float tmin = 0.0f, bt = 0.0f;
  int be = 0;
  if (active) {
    o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
    d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
    tmin = tmin_in[i];
    bt = bt_in[i];
    be = be_in[i];
  }
  float acc = bt;
  for (int t0 = 0; t0 < n_prims; t0 += TILE) {
    int cnt = min(TILE, n_prims - t0);
    if (t0 > 0) {  // a group of more than TILE rows: its next tile
      __syncthreads();
      stage_rows(srows, rows + (size_t)t0 * WP, cnt);
    }
    rows_staged();
    if (!active) continue;
    for (int e = 0; e < cnt; ++e) {
      float tt = probe_test<V>(SharedRow<WP>(srows + e * WP), o, d, tmin, bt);
      if (V == NOSELECT) {
        acc = acc + tt;  // keeps the test live without the select
      } else if (tt < bt) {
        bt = tt;
        be = t0 + e;
      }
    }
  }
  if (active) {
    bt_out[i] = V == NOSELECT ? acc * 1e-30f + bt : bt;
    be_out[i] = be;
  }
}

template <int V>
cudaError_t launch(const float* rows, int n_prims, const float* ro, const float* rd,
                   const float* tmin, const float* bt_in, const int* be_in, float* bt_out,
                   int* be_out, int n, cudaStream_t stream) {
  int smem = min(n_prims, TILE) * WP * 4;  // at most 24 KB: below the default 48 KB
  probe_kernel<V><<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(
      rows, n_prims, ro, rd, tmin, bt_in, be_in, bt_out, be_out, n);
  return cudaGetLastError();
}

}  // namespace

// C interface.  ``rows`` (n_prims x width floats, 16-byte aligned) is the
// cone group's table as the dense kernel reads it.  Returns the launch's
// error (0 on success); an unknown variant, or rows of another width than
// the cone's padded width (12), return cudaErrorInvalidValue without
// launching.
extern "C" int pine_cone_probe(int variant, const float* rows, int width, int n_prims,
                               const float* ro, const float* rd, const float* tmin,
                               const float* bt_in, const int* be_in, float* bt_out,
                               int* be_out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (width != WP) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINE_CASE(V) \
  case V:            \
    return launch<V>(rows, n_prims, ro, rd, tmin, bt_in, be_in, bt_out, be_out, n, s);
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
}
