// Dense ray-group traversal for Hopper (sm_90a).
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_dense_kernel, the Pallas
// TPU kernel that tests every prim of a group of 512 or fewer prims against an
// (8,128) ray block after a group-AABB slab cull of the whole block.  Its
// contract is pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out; a prim replaces the running best
//     only on a strict t < best_t, so ties keep the lowest row; best_e is the
//     group-local row.
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//     a lane with tmax <= tmin never becomes occluded.
//   Culled lanes pass best_t / best_e through bit for bit.
//
// What bounds it: arithmetic.  Each ray that reaches the group box runs every
// prim test (a few dozen FP32 operations with IEEE divisions and square
// roots) while it reads 40 bytes of ray state and writes 8; the prim rows are
// a few kilobytes shared by all rays.
//
// Design: one thread per ray, 256 threads per block.  The TPU culled a whole
// 1024-ray block at once; here the cull is per thread, which gives the same
// result and lets a thread whose ray cannot reach the group box skip the
// sweep.  Prim rows live in a device table uploaded once when the scene is
// compiled; every thread of a warp reads the same row address at the same
// step, so the __ldg loads broadcast through the read-only cache and no shared
// memory is needed.  The tests are templated on the shape type, so each
// sweep is monomorphic.  Any-hit stops at a lane's first hit (the flag can
// only rise).  Built without fast math and with -fmad=false, the arithmetic
// is the same rounded sequence as the plain PyTorch version in
// accel/dense_traverse.py.

#include "prim_tests.cuh"

namespace {

using namespace pine;

template <int TID, bool ANY>
__global__ void __launch_bounds__(256)
dense_kernel(const float* __restrict__ rows, int width, int n_prims,
             const float* __restrict__ gbox,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
             const float* __restrict__ bt_in, const int* __restrict__ be_in,
             float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  float tmin = tmin_in[i];
  float bt = bt_in[i];
  int be = be_in[i];

  // Group-AABB cull.  Any-hit: an occluded lane gets the empty window
  // (tmin, tmin - 1); closest-hit: the window ends at the running best.
  float tmax = ANY ? tmax_in[i] : bt;
  float near = tmin, far = ANY ? (be == 0 ? tmax : tmin - 1.0f) : bt;
  const float oc[3] = {o.x, o.y, o.z};
  const float dc[3] = {d.x, d.y, d.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float inv = safe_inv(dc[a]);
    float t0 = (__ldg(gbox + a) - oc[a]) * inv;
    float t1 = (__ldg(gbox + 3 + a) - oc[a]) * inv;
    near = vmax(near, vmin(t0, t1));
    far = vmin(far, vmax(t0, t1));
  }
  if (near <= far) {
    if (ANY) {
      for (int e = 0; e < n_prims; ++e) {
        if (prim_test<TID>(rows + e * width, o, d, tmin, tmax) < BIG) {
          be = 1;
          break;
        }
      }
    } else {
      for (int e = 0; e < n_prims; ++e) {
        float tt = prim_test<TID>(rows + e * width, o, d, tmin, bt);
        if (tt < bt) {
          bt = tt;
          be = e;
        }
      }
    }
  }
  bt_out[i] = bt;
  be_out[i] = be;
}

template <int TID>
void launch(bool any_hit, const float* rows, int width, int n_prims, const float* gbox,
            const float* ro, const float* rd, const float* tmin, const float* tmax,
            const float* bt_in, const int* be_in, float* bt_out, int* be_out, int n,
            cudaStream_t stream) {
  dim3 block(256), grid((n + 255) / 256);
  if (any_hit)
    dense_kernel<TID, true><<<grid, block, 0, stream>>>(
        rows, width, n_prims, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
  else
    dense_kernel<TID, false><<<grid, block, 0, stream>>>(
        rows, width, n_prims, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// an unknown shape type returns cudaErrorInvalidValue without launching.
extern "C" int pine_dense_traverse(int tid, int any_hit, const float* rows, int width,
                                   int n_prims, const float* gbox, const float* ro,
                                   const float* rd, const float* tmin, const float* tmax,
                                   const float* bt_in, const int* be_in, float* bt_out,
                                   int* be_out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                                  \
  case T:                                                                             \
    launch<T>(a, rows, width, n_prims, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, \
              be_out, n, s);                                                          \
    break;
  switch (tid) {
    PINE_CASE(SPHERE)
    PINE_CASE(RECT)
    PINE_CASE(DISK)
    PINE_CASE(PLANE)
    PINE_CASE(BOX_AABB)
    PINE_CASE(BOX_OBB)
    PINE_CASE(TRIANGLE)
    PINE_CASE(CONE)
    PINE_CASE(CYLINDER)
    default:
      return cudaErrorInvalidValue;
  }
#undef PINE_CASE
  return cudaGetLastError();
}
