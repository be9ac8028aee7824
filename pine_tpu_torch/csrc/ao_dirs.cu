// The ambient-occlusion integrator's hemisphere directions for Hopper (sm_90a).
//
// Replaces no TPU kernel: pine_tpu leaves this chain of elementwise
// operations to XLA, which fuses it.  On the card the port ran it as PyTorch
// operations, about 96 launches and 14 synchronising copies a direction:
//   to_world(ns, uniform_hemisphere(sampler.u2(xs, ys, i, 4 + 2k)))
// (pine_tpu_torch/integrators/ao.py, core/samplers.py, core/sampling.py,
// core/vecmath.py).  One thread computes one lane's direction k:
//   1. (pine_ao_dirs_blue) BlueSampler's draw of dims 4 + 2k and 5 + 2k of
//      sample i: the lane's pixel from its index and the film's width, three
//      gathers from the sampler's tables (1.3 MB of int32, resident in L2),
//      (0.5 + value) / 256.  pine_ao_dirs_u takes any sampler's u2 instead.
//   2. uniform_hemisphere: phi = u0 * Pi * 2 in float32, sin_theta =
//      sqrt(max(1 - c*c, 0)), cos and sin of phi in float64 rounded to
//      float32 (core/fmath.py).
//   3. to_world around the normal: coordinate_system's |n.x| > |n.y| pick
//      and its cross products against the unit axes with every product and
//      difference kept (x*0 included: it is -0 or NaN for some x),
//      safe_normalize (the dot product term by term, sqrt, the 1e-20 floor,
//      IEEE division), cross(n, t), then (w0*t + w1*b) + w2*n.
// Each operation rounds as the PyTorch operation it stands for: the file is
// built with -fmad=false and without fast math, so nothing contracts into a
// fused multiply-add or is reassociated, and the directions equal the
// chain's bit for bit (tests/test_torch_ao_dirs.py holds them on the card).
//
// What bounds it: bytes.  A lane reads its normal (12 bytes) and writes its
// direction (12 bytes); the table gathers hit L2.  At 2,073,600 lanes that
// is 50 MB, 15 us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int TILE = 128 * 128 * 8;  // BlueSampler.TILE (core/samplers.py)
constexpr float PI_F = 3.14159265358979323846f;  // Pi as a float32 operand rounds it

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// BlueSampler.u1 for dim d (0..255) of sample s (0..255) at the pixel term pix8.
__device__ __forceinline__ float blue_u1(const int* __restrict__ sobol,
                                         const int* __restrict__ rank,
                                         const int* __restrict__ scram, int pix8, int s, int d) {
  int ranked = s ^ __ldg(rank + (d + pix8) % TILE);
  int value = __ldg(sobol + d + ranked * 256) ^ __ldg(scram + (d % 8) + pix8);
  return (0.5f + static_cast<float>(value)) / 256.0f;
}

// to_world(n, uniform_hemisphere((u0, u1))), written to d[0..2].
__device__ __forceinline__ void direction(const float* __restrict__ ns, float u0, float u1,
                                          float* __restrict__ d) {
  float phi = u0 * PI_F * 2.0f;
  float c = u1;
  float s2 = 1.0f - c * c;
  s2 = s2 < 0.0f ? 0.0f : s2;  // clamp_min: a NaN passes through
  float st = sqrtf(s2);
  float w0 = st * static_cast<float>(cos(static_cast<double>(phi)));
  float w1 = st * static_cast<float>(sin(static_cast<double>(phi)));
  float w2 = c;

  V3 n = {ns[0], ns[1], ns[2]};
  V3 t = fabsf(n.x) > fabsf(n.y) ? cross(n, V3{0.0f, 1.0f, 0.0f})
                                 : cross(n, V3{1.0f, 0.0f, 0.0f});
  float len = sqrtf(t.x * t.x + t.y * t.y + t.z * t.z);
  len = len < 1e-20f ? 1e-20f : len;
  t = {t.x / len, t.y / len, t.z / len};
  V3 b = cross(n, t);
  d[0] = w0 * t.x + w1 * b.x + w2 * n.x;
  d[1] = w0 * t.y + w1 * b.y + w2 * n.y;
  d[2] = w0 * t.z + w1 * b.z + w2 * n.z;
}

__global__ void __launch_bounds__(BLOCK)
    ao_dirs_blue_kernel(const float* __restrict__ ns, const int* __restrict__ sobol,
                        const int* __restrict__ rank, const int* __restrict__ scram, int s,
                        int d0, int d1, int width, float* __restrict__ out, int n) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  int px = i % width, py = i / width;
  int pix8 = ((px & 127) + (py & 127) * 128) * 8;
  float u0 = blue_u1(sobol, rank, scram, pix8, s, d0);
  float u1 = blue_u1(sobol, rank, scram, pix8, s, d1);
  direction(ns + 3 * i, u0, u1, out + 3 * i);
}

__global__ void __launch_bounds__(BLOCK)
    ao_dirs_u_kernel(const float* __restrict__ ns, const float* __restrict__ u,
                     float* __restrict__ out, int n) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  direction(ns + 3 * i, u[2 * i], u[2 * i + 1], out + 3 * i);
}

}  // namespace

// C interface.  Each launches on ``stream`` and returns the launch's error (0
// on success).  ns and out are contiguous (n, 3) float32, u (n, 2) float32;
// the tables are BlueSampler's on the card, int32 of the sizes its
// TABLE_SIZES gives (core/samplers.py, whose u1 draws from them as this file
// does).  Lanes lie in row order over a film ``width`` pixels wide.
extern "C" int pine_ao_dirs_blue(const float* ns, const int* sobol, const int* rank,
                                 const int* scram, int sample_index, int dim, int width,
                                 float* out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (width <= 0) return cudaErrorInvalidValue;
  ao_dirs_blue_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ns, sobol, rank, scram, sample_index & 255, dim & 255, (dim + 1) & 255, width, out, n);
  return cudaGetLastError();
}

extern "C" int pine_ao_dirs_u(const float* ns, const float* u, float* out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  ao_dirs_u_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ns, u, out, n);
  return cudaGetLastError();
}
