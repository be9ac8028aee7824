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
// window about twenty, per candidate the row rebuild and the prim test; the
// only memory traffic is the ray state and one slot read.  One thread per
// ray, each marching its own lane and rebuilding every column of every
// candidate, ran the cone forest's main-path launches at 26x / 9x that bound
// (H100 80GB HBM3, 700 W): a fifth of the lanes pass the group-box clip, so
// their warps marched mostly idle; every cone pair paid its square root and
// divisions, though most of them miss; and each candidate rebuilt its eight
// columns in 32 operations beside the test's 56.
//
// Design:
// - The block's lanes clip their own rays to the group box (as the plain
//   version does); a lane that misses writes its state straight back.  The
//   block then compacts its live lanes: each warp appends its live rays and
//   their clipped windows to a queue in shared memory (a ballot and one
//   atomic), and thread j of the block marches queue entry j, so the live
//   rays run in full warps (accel/dense_traverse.cu's queue).
// - Constant columns out of the rebuild.  The C entry marks the columns
//   whose dU and dV are both +-0 (bit c of ``vary`` clear) and forms their
//   value in every cell once, in float32: (base + copysign(0, dU)) +
//   copysign(0, dV), what (base + fi*dU) + fj*dV rounds to for any fi,
//   fj >= 0, signed zeros included.  A lattice whose varying columns all lie in the columns a
//   translation moves (trans_cols: the anchor, the vertices, the matrices'
//   offsets) runs the TRANS form of the kernel, which rebuilds only those;
//   any other lattice rebuilds every column.  The choice is uniform over the
//   launch.  Each rebuilt column's first sum, base + fi*dU, is formed once
//   per candidate row ki and reused across kj.
// - A lattice of at least 4 x 4 cells (K = 4 in both directions, the
//   forest's) runs a form with the K x K loops of constant trip count, which
//   the compiler unrolls (KK = 4); a narrower one keeps the loops.
// - The tests take the exact early misses of prim_tests.cuh (EARLY): a
//   quadric whose discriminant rules out a hit, or a rect whose plane lies
//   outside the window, returns BIG before its square root and divisions.
// Measured and not kept (H100 80GB HBM3, 700 W, summed card time as below
// the block size): skipping a candidate already tested (in the previous
// window's clamped rectangle, or a clamped repeat of its neighbour; exact,
// tests/test_torch_lattice.py holds it) 0.687 ms against 0.671 without, as
// a warp's lanes rarely skip together; the constant columns as a bit mask
// in the parameter block, each column a select, 0.873 (both sides of the
// select issue, and it spilled).
// The arithmetic is the plain version's rounded sequence
// (accel/lattice_traverse.py::lattice_plain), built without fast math and
// with -fmad=false: near + s*dt per window, not an accumulated t, and each
// column (base + fi*dU) + fj*dV; so the two agree bit for bit.  The lattice
// model (base, dU, dV, the constant columns, the dual basis, origin, margins
// and window capacities) is a __grid_constant__ kernel parameter: every
// thread reads the same word at the same step, which the constant bank
// broadcasts; it is the analog of the TPU kernel's scalar prefetch.  The
// march stops at min(n_seg, max_seg) windows, as the TPU kernel's static
// loop does; any-hit stops at a lane's first hit.

#include "prim_tests.cuh"

namespace {

using namespace pine;

constexpr int LAT_W = 32;  // widest prim row (the OBB's 30), padded
// Rays per block.  Measured on H100 80GB HBM3, 700 W, summed card time over
// the cone forest's main-path launches and phase 2d's groups: 128 rays
// 0.597 ms, 256 rays 0.605; with at least 5 or 6 blocks of 256 per SM
// (48 or 40 registers) 0.679 / 0.738.
constexpr int BLOCK = 128;
constexpr unsigned FULL = 0xffffffffu;

struct Lattice {
  float base[LAT_W], dU[LAT_W], dV[LAT_W];
  float cval[LAT_W];  // a constant column's value in every cell
  float gu[3], gv[3];
  float u0, v0, r_u, r_v, cap_u, cap_v;
  int ni, nj, ki_n, kj_n, max_seg;
  unsigned vary;  // bit c: column c has a nonzero (or NaN) dU or dV
};

// The columns of a row of shape type TID that a translation of the prim
// moves: the anchor or centre (every type), an AABB's corners, a cylinder's
// end points, a triangle's vertices, an OBB's two matrices' offsets.
template <int TID>
__host__ __device__ constexpr unsigned trans_cols() {
  return TID == BOX_AABB || TID == CYLINDER ? 0x3fu
       : TID == TRIANGLE ? 0x1ffu
       : TID == BOX_OBB ? (1u << 9 | 1u << 13 | 1u << 17 | 1u << 21 | 1u << 25 | 1u << 29)
       : 0x7u;
}

// The columns the kernel rebuilds: a translation's, or every one.
template <int TID, bool TRANS>
__host__ __device__ constexpr unsigned rebuilt_cols() {
  return TRANS ? trans_cols<TID>() : (1u << prim_width<TID>()) - 1u;
}

// The row of the candidate (fi, fj): each rebuilt column (base + fi*dU) +
// fj*dV, its first sum ``bi`` formed once for the candidate row; each
// other column constant.
template <int TID, bool TRANS>
struct LatticeRow {
  const Lattice& L;
  const float* bi;
  float fj;
  __device__ __forceinline__ float operator()(int c) const {
    if (rebuilt_cols<TID, TRANS>() >> c & 1u) return bi[c] + fj * L.dV[c];
    return L.cval[c];
  }
};

template <int TID, bool ANY, bool TRANS, int KK>
__global__ void __launch_bounds__(BLOCK)
lattice_kernel(const __grid_constant__ Lattice L, const int* __restrict__ slot,
               const float* __restrict__ gbox,
               const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
               const float* __restrict__ bt_in, const int* __restrict__ be_in,
               float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int W = prim_width<TID>();
  __shared__ int queue[BLOCK];  // the block's live rays
  __shared__ float qnear[BLOCK], qfar[BLOCK];  // and their clipped windows
  __shared__ int n_live;
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();

  // Group-AABB clip of [tmin, lim].  Any-hit: an occluded lane gets the empty
  // window (tmin, tmin - 1); closest-hit: the window ends at the running best.
  int lane = threadIdx.x & 31;
  int i = blockIdx.x * BLOCK + threadIdx.x;
  bool live = false;
  float near = 0.0f, far = 0.0f;
  if (i < n) {
    float tmin = tmin_in[i], bt = bt_in[i];
    int be = be_in[i];
    near = tmin;
    far = ANY ? (be == 0 ? tmax_in[i] : tmin - 1.0f) : bt;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float oa = ro[3 * i + a];
      float inv = safe_inv(rd[3 * i + a]);
      float t0 = (__ldg(gbox + a) - oa) * inv;
      float t1 = (__ldg(gbox + 3 + a) - oa) * inv;
      near = vmax(near, vmin(t0, t1));
      far = vmin(far, vmax(t0, t1));
    }
    live = near <= far;
    if (!live) {
      bt_out[i] = bt;
      be_out[i] = be;
    }
  }
  unsigned m = __ballot_sync(FULL, live);
  int at = 0;
  if (lane == 0 && m) at = atomicAdd(&n_live, __popc(m));
  at = __shfl_sync(FULL, at, 0) + __popc(m & ((1u << lane) - 1u));
  if (live) {
    queue[at] = i;
    qnear[at] = near;
    qfar[at] = far;
  }
  __syncthreads();

  // The march: thread j of the block takes the j-th live ray.
  if (threadIdx.x >= n_live) return;
  i = queue[threadIdx.x];
  near = qnear[threadIdx.x];
  far = qfar[threadIdx.x];
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  float tmin = tmin_in[i];
  float bt = bt_in[i];
  int be = be_in[i];  // any-hit: 0, or the lane would have been clipped
  float tmax = ANY ? tmax_in[i] : bt;

  float du = d.x * L.gu[0] + d.y * L.gu[1] + d.z * L.gu[2];
  float dv = d.x * L.gv[0] + d.y * L.gv[1] + d.z * L.gv[2];
  float ou = o.x * L.gu[0] + o.y * L.gu[1] + o.z * L.gu[2] - L.u0;
  float ov = o.x * L.gv[0] + o.y * L.gv[1] + o.z * L.gv[2] - L.v0;
  float seg = vmax(far - near, 0.0f);
  float n_seg = ceilf(vmax(vmax(fabsf(du) * seg / L.cap_u, fabsf(dv) * seg / L.cap_v), 1.0f));
  float dt = seg / vmax(n_seg, 1.0f);
  int k_best = 0;
  bool improved = false;
  const int ki_n = KK ? KK : L.ki_n, kj_n = KK ? KK : L.kj_n;
  for (int s = 0; s < L.max_seg && (float)s < n_seg; ++s) {
    float ta = near + (float)s * dt;
    float tb = near + (float)(s + 1) * dt;
    float ua = ou + ta * du, ub = ou + tb * du;
    float va = ov + ta * dv, vb = ov + tb * dv;
    // candidate window: cells within r of the segment's (u, v) interval;
    // clip before the int cast (far lanes carry huge coordinates)
    int i_lo = (int)vmin(vmax(floorf(vmin(ua, ub) - L.r_u), -1e6f), 1e6f);
    int j_lo = (int)vmin(vmax(floorf(vmin(va, vb) - L.r_v), -1e6f), 1e6f);
    for (int ki = 0; ki < ki_n; ++ki) {
      int ii = min(max(i_lo + ki, 0), L.ni - 1);
      float fi = (float)ii;
      float bi[W];
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (rebuilt_cols<TID, TRANS>() >> c & 1u) bi[c] = L.base[c] + fi * L.dU[c];
      for (int kj = 0; kj < kj_n; ++kj) {
        int jj = min(max(j_lo + kj, 0), L.nj - 1);
        LatticeRow<TID, TRANS> row{L, bi, (float)jj};
        float tt = prim_test_row<TID, true>(row, o, d, tmin, ANY ? tmax : bt);
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
done:
  bt_out[i] = bt;
  be_out[i] = be;
}

template <int TID, bool ANY>
void launch(const Lattice& L, const int* slot, const float* gbox, const float* ro,
            const float* rd, const float* tmin, const float* tmax, const float* bt_in,
            const int* be_in, float* bt_out, int* be_out, int n, cudaStream_t stream) {
  bool trans = (L.vary & ~trans_cols<TID>()) == 0;
  bool k4 = L.ki_n == 4 && L.kj_n == 4;
  auto k = trans ? (k4 ? lattice_kernel<TID, ANY, true, 4> : lattice_kernel<TID, ANY, true, 0>)
                 : (k4 ? lattice_kernel<TID, ANY, false, 4> : lattice_kernel<TID, ANY, false, 0>);
  k<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(L, slot, gbox, ro, rd, tmin, tmax, bt_in,
                                                   be_in, bt_out, be_out, n);
}

template <int TID>
void launch(bool any_hit, const Lattice& L, const int* slot, const float* gbox,
            const float* ro, const float* rd, const float* tmin, const float* tmax,
            const float* bt_in, const int* be_in, float* bt_out, int* be_out, int n,
            cudaStream_t stream) {
  if (any_hit)
    launch<TID, true>(L, slot, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, stream);
  else
    launch<TID, false>(L, slot, gbox, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n,
                       stream);
}

}  // namespace

// C interface.  ``latf`` is the host table of accel/lattice_traverse.py's
// lattice_layout: [base | dU | dV] (``width`` each), gu (3), gv (3), u0, v0,
// r_u, r_v, cap_u, cap_v; it is copied into the kernel's parameter block.  ``slot`` (ni*nj int32, device)
// maps a lattice index to the group's row.  Returns cudaGetLastError() after
// the launch (0 on success); an unknown shape type or a row wider than
// LAT_W returns cudaErrorInvalidValue without launching.
extern "C" int pine_lattice_traverse(int tid, int any_hit, const float* latf, int width,
                                     int ni, int nj, int K, int max_seg, const int* slot,
                                     const float* gbox, const float* ro, const float* rd,
                                     const float* tmin, const float* tmax, const float* bt_in,
                                     const int* be_in, float* bt_out, int* be_out, int n,
                                     void* stream) {
  if (n <= 0) return cudaSuccess;
  if (width < 1 || width > LAT_W || ni < 1 || nj < 1 || K < 1) return cudaErrorInvalidValue;
  Lattice L = {};
  const float* tail = latf + 3 * width;
  for (int c = 0; c < width; ++c) {
    L.base[c] = latf[c];
    L.dU[c] = latf[width + c];
    L.dV[c] = latf[2 * width + c];
    if (L.dU[c] == 0.0f && L.dV[c] == 0.0f)
      L.cval[c] = (L.base[c] + copysignf(0.0f, L.dU[c])) + copysignf(0.0f, L.dV[c]);
    else
      L.vary |= 1u << c;
  }
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
