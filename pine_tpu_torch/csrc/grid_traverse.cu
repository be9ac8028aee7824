// Grid ray-group traversal for Hopper (sm_90a): the traversal of every
// non-lattice group of more than 512 prims, which is every mesh.
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_grid_kernel (reached
// through _compiled_grid_call), the Pallas TPU kernel that sweeps a group's
// prims in leaf order as 128-prim supercells, culling an (8,128) ray block
// against 16-supercell coarse boxes, supercell boxes and 32-prim cell boxes,
// and on mesh-scale groups visits coarse boxes and supercells near-first in
// the block's direction octant.  Its contract is pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out, best_e the group-local row;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//   lanes with tmax <= tmin, lanes already occluded and lanes culled at every
//   level pass their state through bit for bit.
//
// What bounds it: arithmetic and divergence.  A ray runs a few dozen slab
// tests and, in the cells it reaches, Moller-Trumbore tests of ~50 FP32
// operations; it reads 40 bytes of ray state and writes 8.  The tables
// (prim rows 48 bytes each, 4.8 MB for the 99,458-triangle terrain, plus
// 24-byte boxes) are read through the read-only cache and sit in the 50 MB L2.
//
// Design: one thread per ray, as dense_traverse.cu.  The TPU culled and
// ordered whole ray blocks; here each thread culls its own ray at each level
// (coarse box, supercell, 32-prim cell) and visits coarse boxes and
// supercells in the near-first order of its own direction octant, from the
// per-octant orders built at compile() (accel/grid_traverse.grid_layout).
// After the wavefront coherence sort the lanes of a warp mostly share an
// octant and a region, so they mostly walk the same boxes.  No shared
// memory.  Closest-hit keeps a local (t, row) best compared
// lexicographically, so ties go to the lowest row whatever the visit order,
// and a row replaces the incoming best only on a strict t < best_t: the
// result is that of a sweep over the rows in order (grid_plain).  Any-hit
// leaves a ray at its first hit.  Built without fast math and with
// -fmad=false, the tests round as the plain PyTorch version does.
//
// The MXU form (_make_grid_kernel with mxu_m > 0, test_super_mxu; the
// route "grid_mxu"): the same culls and visit order, but the leaf reads prim
// e's m columns of the supercell-major coefficient table
// (accel/mxu_tables.build_mesh_tables) and runs the epilogue of
// csrc/mxu_epilogue.cuh on the ray's feature row, where the VPU form runs
// prim_test<TID> on its row.  The TPU tested a whole taken supercell with one
// (m*128, 8)^T x (8, 128) matmul per sublane row and dropped the cell culls;
// here each thread forms its own pairs, so the cell culls stay.  Closest-hit
// keeps the (t, row) rule: the result is that of a row-order sweep, which is
// what test_super_mxu's min-then-min-pid gives.

#include "mxu_epilogue.cuh"

namespace {

using namespace pine;

constexpr int SUPER = 128;  // prims per supercell
constexpr int CELL = 32;    // prims per cull cell
constexpr int COARSE = 16;  // supercells per coarse box

struct Tables {
  const float* rows;          // (>= n_prims, width) prim rows in leaf order
  int width, n_prims, n_super, n_coarse, use_coarse;
  const float* coarse_boxes;  // (n_coarse, 6) lo xyz, hi xyz
  const float* sc_boxes;      // (n_coarse * 16, 6)
  const float* cell_boxes;    // (n_super * 4, 6)
  const int* c_order8;        // (8, n_coarse) near-first coarse order per octant
  const int* s_order8;        // (8, n_coarse * 16) supercells, within their coarse box
  const float* mxu_w;         // MXU form: (n_super * 8, m * 128) coefficient table
};

template <int TID, bool ANY, bool MXU>
__global__ void __launch_bounds__(128)
grid_kernel(Tables tb, const float* __restrict__ ro, const float* __restrict__ rd,
            const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
            const float* __restrict__ bt_in, const int* __restrict__ be_in,
            float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = bt_in[i];
  int be = be_in[i];
  float tmin = tmin_in[i];
  // the prim-test limit: tmax for any-hit, the incoming best for closest-hit
  float tmax = ANY ? tmax_in[i] : bt;
  if (ANY && (be != 0 || !(tmax > tmin))) {
    bt_out[i] = bt;
    be_out[i] = be;
    return;
  }
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  RayFeat rf;
  if constexpr (MXU) rf = ray_features(o, d);
  int oct = (d.x < 0.0f ? 1 : 0) | (d.y < 0.0f ? 2 : 0) | (d.z < 0.0f ? 4 : 0);
  const int* c_order = tb.c_order8 + oct * tb.n_coarse;
  const int* s_order = tb.s_order8 + oct * tb.n_coarse * COARSE;

  float cur_t = bt;  // closest-hit: local best (t, row); row -1 = not improved
  int cur_e = -1;
  bool occluded = false;
  for (int ci = 0; ci < tb.n_coarse; ++ci) {
    int c = tb.use_coarse ? __ldg(c_order + ci) : 0;
    if (tb.use_coarse && !slab_hit(tb.coarse_boxes + 6 * c, o, inv, tmin, ANY ? tmax : cur_t))
      continue;
    for (int k = 0; k < COARSE; ++k) {
      int si = __ldg(s_order + c * COARSE + k);
      if (si >= tb.n_super) continue;  // padding of the last coarse box
      if (!slab_hit(tb.sc_boxes + 6 * si, o, inv, tmin, ANY ? tmax : cur_t)) continue;
      for (int kc = 0; kc < SUPER / CELL; ++kc) {
        int cell = si * (SUPER / CELL) + kc;
        int p0 = cell * CELL;
        if (p0 >= tb.n_prims) break;
        if (!slab_hit(tb.cell_boxes + 6 * cell, o, inv, tmin, ANY ? tmax : cur_t)) continue;
        int p1 = min(p0 + CELL, tb.n_prims);
        for (int e = p0; e < p1; ++e) {
          float t;
          if constexpr (MXU)
            t = mesh_pair_t<TID>(tb.mxu_w, e, rf, tmin, tmax);
          else
            t = prim_test<TID>(tb.rows + (size_t)e * tb.width, o, d, tmin, tmax);
          if (ANY) {
            if (t < BIG) {
              occluded = true;
              goto done;
            }
          } else if (t < cur_t || (t == cur_t && e < cur_e)) {
            cur_t = t;
            cur_e = e;
          }
        }
      }
    }
  }
done:
  if (ANY) {
    bt_out[i] = bt;
    be_out[i] = occluded ? 1 : be;
  } else {
    bt_out[i] = cur_e >= 0 ? cur_t : bt;
    be_out[i] = cur_e >= 0 ? cur_e : be;
  }
}

template <int TID, bool MXU>
void launch(bool any_hit, const Tables& tb, const float* ro, const float* rd,
            const float* tmin, const float* tmax, const float* bt_in, const int* be_in,
            float* bt_out, int* be_out, int n, cudaStream_t stream) {
  dim3 block(128), grid((n + 127) / 128);
  if (any_hit)
    grid_kernel<TID, true, MXU><<<grid, block, 0, stream>>>(
        tb, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
  else
    grid_kernel<TID, false, MXU><<<grid, block, 0, stream>>>(
        tb, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// an unknown shape type returns cudaErrorInvalidValue without launching.
// mxu_w null: the VPU form; else the MXU form on that table, for the types
// with one (others return cudaErrorInvalidValue).
extern "C" int pine_grid_traverse(
    int tid, int any_hit, const float* rows, int width, int n_prims, int n_super,
    int n_coarse, int use_coarse, const float* coarse_boxes, const float* sc_boxes,
    const float* cell_boxes, const int* c_order8, const int* s_order8, const float* ro,
    const float* rd, const float* tmin, const float* tmax, const float* bt_in,
    const int* be_in, float* bt_out, int* be_out, const float* mxu_w, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tables tb{rows, width, n_prims, n_super, n_coarse, use_coarse, coarse_boxes,
            sc_boxes, cell_boxes, c_order8, s_order8, mxu_w};
  bool a = any_hit != 0;
#define PINE_CASE_MXU(T)                                                               \
  case T:                                                                              \
    launch<T, true>(a, tb, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s);   \
    break;
  if (mxu_w != nullptr) {
    switch (tid) {
      PINE_CASE_MXU(SPHERE)
      PINE_CASE_MXU(RECT)
      PINE_CASE_MXU(DISK)
      PINE_CASE_MXU(PLANE)
      PINE_CASE_MXU(TRIANGLE)
      PINE_CASE_MXU(CONE)
      default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
#undef PINE_CASE_MXU
#define PINE_CASE(T)                                                                    \
  case T:                                                                               \
    launch<T, false>(a, tb, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s);   \
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
