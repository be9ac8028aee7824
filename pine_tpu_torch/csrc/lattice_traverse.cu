// Lattice ray-group traversal for Hopper (sm_90a).
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_lattice_kernel, the Pallas
// TPU kernel for prim groups that form a regular 1-D or 2-D lattice (fields a
// script builds in loops).  Such a group's rows are affine in the lattice
// indices, row(i, j) = base + i*dU + j*dV, so no row is read from memory: a
// ray marches its segment through the group box in windows short enough that
// a K x K block of cells in the lattice's dual (u, v) coordinates covers every
// cell the window can touch, rebuilds those candidates' rows by arithmetic
// and runs the prim test on each.  The contract is pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out; a prim replaces the running best
//     only on a strict t < best_t, in (window, ki, kj) visit order; on a lane
//     whose t improved best_e is the group's SAH slot of the lattice index
//     k = i*nj + j (slot_of_k), elsewhere it passes through bit for bit.
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through.
//   Culled lanes pass best_t / best_e through bit for bit.
//
// What bounds it: arithmetic.  Per ray a few dozen operations of set-up, per
// window about twenty, per candidate the row rebuild (three per column) and
// the prim test; the only memory traffic is the ray state and one slot read.
//
// Design: one thread per ray, 256 threads per block.  The lattice model (base,
// dU, dV, the dual basis, origin, margins and window capacities, at most 108
// floats) is a __grid_constant__ kernel parameter: every thread reads the
// same word at the same step, which the constant bank broadcasts; it is the
// analog of the TPU kernel's scalar prefetch.  The march stops at
// min(n_seg, max_seg) windows, as the TPU kernel's static loop does; any-hit
// stops at a lane's first hit.  Built without fast math and with -fmad=false,
// the arithmetic is the same rounded sequence as the plain PyTorch version
// (accel/lattice_traverse.py::lattice_plain): near + s*dt per window, not an
// accumulated t, and each column rebuilt as (base + fi*dU) + fj*dV.

#include "prim_tests.cuh"

namespace {

using namespace pine;

constexpr int LAT_W = 32;  // widest prim row (the OBB's 30), padded

struct Lattice {
  float base[LAT_W], dU[LAT_W], dV[LAT_W];
  float gu[3], gv[3];
  float u0, v0, r_u, r_v, cap_u, cap_v;
  int ni, nj, ki_n, kj_n, max_seg;
};

// The row of cell (fi, fj), rebuilt column by column as the test reads it.
struct LatticeRow {
  const Lattice& L;
  float fi, fj;
  __device__ __forceinline__ float operator()(int c) const {
    return (L.base[c] + fi * L.dU[c]) + fj * L.dV[c];
  }
};

template <int TID, bool ANY>
__global__ void __launch_bounds__(256)
lattice_kernel(const __grid_constant__ Lattice L, const int* __restrict__ slot,
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

  // Group-AABB clip of [tmin, lim].  Any-hit: an occluded lane gets the empty
  // window (tmin, tmin - 1); closest-hit: the window ends at the running best.
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
    float du = d.x * L.gu[0] + d.y * L.gu[1] + d.z * L.gu[2];
    float dv = d.x * L.gv[0] + d.y * L.gv[1] + d.z * L.gv[2];
    float ou = o.x * L.gu[0] + o.y * L.gu[1] + o.z * L.gu[2] - L.u0;
    float ov = o.x * L.gv[0] + o.y * L.gv[1] + o.z * L.gv[2] - L.v0;
    float seg = vmax(far - near, 0.0f);
    float n_seg = ceilf(vmax(vmax(fabsf(du) * seg / L.cap_u, fabsf(dv) * seg / L.cap_v), 1.0f));
    float dt = seg / vmax(n_seg, 1.0f);
    int k_best = 0;
    bool improved = false;
    for (int s = 0; s < L.max_seg && (float)s < n_seg; ++s) {
      float ta = near + (float)s * dt;
      float tb = near + (float)(s + 1) * dt;
      float ua = ou + ta * du, ub = ou + tb * du;
      float va = ov + ta * dv, vb = ov + tb * dv;
      // candidate window: cells within r of the segment's (u, v) interval;
      // clip before the int cast (far lanes carry huge coordinates)
      int i_lo = (int)vmin(vmax(floorf(vmin(ua, ub) - L.r_u), -1e6f), 1e6f);
      int j_lo = (int)vmin(vmax(floorf(vmin(va, vb) - L.r_v), -1e6f), 1e6f);
      for (int ki = 0; ki < L.ki_n; ++ki) {
        int ii = min(max(i_lo + ki, 0), L.ni - 1);
        float fi = (float)ii;
        for (int kj = 0; kj < L.kj_n; ++kj) {
          int jj = min(max(j_lo + kj, 0), L.nj - 1);
          LatticeRow row{L, fi, (float)jj};
          float tt = prim_test_row<TID>(row, o, d, tmin, ANY ? tmax : bt);
          if (ANY) {
            if (tt < BIG) {
              be = 1;
              goto done;
            }
          } else if (tt < bt) {
            bt = tt;
            k_best = ii * L.nj + jj;
            improved = true;
          }
        }
      }
    }
    if (!ANY && improved) be = __ldg(slot + k_best);
  }
done:
  bt_out[i] = bt;
  be_out[i] = be;
}

template <int TID>
void launch(bool any_hit, const Lattice& L, const int* slot, const float* gbox,
            const float* ro, const float* rd, const float* tmin, const float* tmax,
            const float* bt_in, const int* be_in, float* bt_out, int* be_out, int n,
            cudaStream_t stream) {
  dim3 block(256), grid((n + 255) / 256);
  if (any_hit)
    lattice_kernel<TID, true><<<grid, block, 0, stream>>>(
        L, slot, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
  else
    lattice_kernel<TID, false><<<grid, block, 0, stream>>>(
        L, slot, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
}

}  // namespace

// C interface.  ``latf`` is the host table of accel/lattice_traverse.py's
// lattice_layout: [base | dU | dV] (``width`` each), gu (3), gv (3), u0, v0,
// r_u, r_v, cap_u, cap_v; it is copied into the kernel's parameter block.
// ``slot`` (ni*nj int32, device) maps a lattice index to the group's row.
// Returns cudaGetLastError() after the launch (0 on success); an unknown
// shape type or a row wider than LAT_W returns cudaErrorInvalidValue without
// launching.
extern "C" int pine_lattice_traverse(int tid, int any_hit, const float* latf, int width,
                                     int ni, int nj, int K, int max_seg, const int* slot,
                                     const float* gbox, const float* ro, const float* rd,
                                     const float* tmin, const float* tmax, const float* bt_in,
                                     const int* be_in, float* bt_out, int* be_out, int n,
                                     void* stream) {
  if (n <= 0) return cudaSuccess;
  if (width < 1 || width > LAT_W || ni < 1 || nj < 1 || K < 1) return cudaErrorInvalidValue;
  Lattice L = {};
  for (int c = 0; c < width; ++c) {
    L.base[c] = latf[c];
    L.dU[c] = latf[width + c];
    L.dV[c] = latf[2 * width + c];
  }
  const float* tail = latf + 3 * width;
  for (int a = 0; a < 3; ++a) {
    L.gu[a] = tail[a];
    L.gv[a] = tail[3 + a];
  }
  L.u0 = tail[6];
  L.v0 = tail[7];
  L.r_u = tail[8];
  L.r_v = tail[9];
  L.cap_u = tail[10];
  L.cap_v = tail[11];
  L.ni = ni;
  L.nj = nj;
  L.ki_n = K < ni ? K : ni;
  L.kj_n = K < nj ? K : nj;
  L.max_seg = max_seg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                                        \
  case T:                                                                                   \
    launch<T>(a, L, slot, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s);    \
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
