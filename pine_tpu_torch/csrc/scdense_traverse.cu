// Supercell-culled dense ray-group traversal for Hopper (sm_90a): the
// traversal of a group that CompiledScene.small_kernel (or mesh_kernel) sets
// to "scdense".
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_scdense_kernel (reached
// through _compiled_scdense_call), the Pallas TPU kernel that sweeps a
// group's rows in order for an (8,128) ray block with every prim broadcast
// from SMEM, skipping a 128-prim supercell, then a 16-prim cell, when no lane
// of the block reaches its box within its window.  Its contract is
// pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out; a prim replaces the running best
//     only on a strict t < best_t, so ties keep the lowest row; best_e is the
//     group-local row;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//     a lane with tmax <= tmin never becomes occluded;
//   lanes that reach no cell pass their state through bit for bit.
//
// What bounds it: arithmetic.  A ray runs a slab test per supercell, one per
// cell of each supercell it reaches, and the prim tests of the cells it
// reaches; it reads 40 bytes of ray state and writes 8.  The rows and boxes
// are a few to a few hundred kilobytes shared by all rays (read-only cache,
// L2).
//
// Design: one thread per ray, as dense_traverse.cu: the TPU culled whole ray
// blocks, here each thread culls its own ray.  The culls are loops over the
// supercells and their eight cells in row order (the TPU kernel unrolled
// them), and a cell's sixteen rows are tested in row order, each against the
// running best (closest-hit: window (tmin, running best); any-hit: (tmin,
// tmax), until the first hit), so the result is that of the dense sweep and
// the plain version, accel/scdense_traverse.scdense_plain, makes the same
// culls in the same order and agrees with it on every lane, bit for bit.
// Rows at or past the group's prim count (the pad rows of a SAH-ordered
// group's table) are never tested.  Built without fast math and with
// -fmad=false, the arithmetic rounds as the plain version's does.

#include "prim_tests.cuh"

namespace {

using namespace pine;

constexpr int SUPER = 128;  // prims per supercell
constexpr int SCD_CELL = 16;  // prims per cull cell

template <int TID, bool ANY>
__global__ void __launch_bounds__(128)
scdense_kernel(const float* __restrict__ rows, int n_prims, int n_super,
               const float* __restrict__ sc_boxes, const float* __restrict__ cell_boxes,
               const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
               const float* __restrict__ bt_in, const int* __restrict__ be_in,
               float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int W = prim_width<TID>();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = bt_in[i];
  int be = be_in[i];
  float tmin = tmin_in[i];
  float tmax = ANY ? tmax_in[i] : bt;
  if (ANY && (be != 0 || !(tmax > tmin))) {
    bt_out[i] = bt;
    be_out[i] = be;
    return;
  }
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  for (int si = 0; si < n_super; ++si) {
    if (!slab_hit(sc_boxes + 6 * si, o, inv, tmin, ANY ? tmax : bt)) continue;
    for (int kc = 0; kc < SUPER / SCD_CELL; ++kc) {
      int cell = si * (SUPER / SCD_CELL) + kc;
      int p0 = cell * SCD_CELL;
      if (p0 >= n_prims) break;
      if (!slab_hit(cell_boxes + 6 * cell, o, inv, tmin, ANY ? tmax : bt)) continue;
      int p1 = min(p0 + SCD_CELL, n_prims);
      for (int e = p0; e < p1; ++e) {
        if (ANY) {
          if (prim_test<TID>(rows + (size_t)e * W, o, d, tmin, tmax) < BIG) {
            be = 1;
            goto done;
          }
        } else {
          float tt = prim_test<TID>(rows + (size_t)e * W, o, d, tmin, bt);
          if (tt < bt) {
            bt = tt;
            be = e;
          }
        }
      }
    }
  }
done:
  bt_out[i] = bt;
  be_out[i] = be;
}

template <int TID>
void launch(bool any_hit, const float* rows, int n_prims, int n_super, const float* sc_boxes,
            const float* cell_boxes, const float* ro, const float* rd, const float* tmin,
            const float* tmax, const float* bt_in, const int* be_in, float* bt_out,
            int* be_out, int n, cudaStream_t stream) {
  dim3 block(128), grid((n + 127) / 128);
  if (any_hit)
    scdense_kernel<TID, true><<<grid, block, 0, stream>>>(
        rows, n_prims, n_super, sc_boxes, cell_boxes, ro, rd, tmin, tmax, bt_in, be_in,
        bt_out, be_out, n);
  else
    scdense_kernel<TID, false><<<grid, block, 0, stream>>>(
        rows, n_prims, n_super, sc_boxes, cell_boxes, ro, rd, tmin, tmax, bt_in, be_in,
        bt_out, be_out, n);
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// an unknown shape type returns cudaErrorInvalidValue without launching.
extern "C" int pine_scdense_traverse(
    int tid, int any_hit, const float* rows, int n_prims, int n_super, const float* sc_boxes,
    const float* cell_boxes, const float* ro, const float* rd, const float* tmin,
    const float* tmax, const float* bt_in, const int* be_in, float* bt_out, int* be_out,
    int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                                     \
  case T:                                                                                \
    launch<T>(a, rows, n_prims, n_super, sc_boxes, cell_boxes, ro, rd, tmin, tmax, bt_in, \
              be_in, bt_out, be_out, n, s);                                              \
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
