// Supercell-tree ray-group traversal for Hopper (sm_90a): the traversal of a
// group that CompiledScene.mesh_kernel (or small_kernel) sets to "sctree".
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_sctree_kernel (reached
// through _compiled_sctree_call), the Pallas TPU kernel that walks a SAH tree
// over a group's 128-prim supercells with one scalar stack per (8,128) ray
// block, DMAs each reached supercell from a lane-padded (E_pad, 128) table in
// HBM and culls its four 32-prim cells against the block.  Its contract is
// pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out, best_e the group-local row;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//   lanes with nothing to do (occluded, tmax <= tmin, best_t <= tmin) and
//   lanes that reach no prim pass their state through bit for bit.
//
// What bounds it: arithmetic and divergence.  A ray runs a few dozen slab
// tests in the tree and the cells and the prim tests of the cells it reaches;
// it reads 40 bytes of ray state and writes 8.  The tables (the 99,458-
// triangle terrain: 4.8 MB of rows, ~110 KB of tree and cell boxes) are read
// through the read-only cache and sit in the 50 MB L2.
//
// Design: one thread per ray, the walk of csrc/sctree_walk.cuh (the one the
// instanced kernel runs in each instance's frame) once per ray in world
// space, over the group's rows as they are: the lane-padded table and its
// DMA were the TPU's way to reach HBM.  The walk's stack is a per-thread
// array of STACK_DEPTH entries in local memory; the wrapper refuses a tree
// deeper than that (accel/sctree_traverse.sctree_cuda).  The prims of a cell
// are tested only below the group's prim count, so the pad rows of the
// group's table are never read.  Closest-hit keeps the lowest (t, row)
// whatever the visit order (the TPU kernel kept the first visited on an
// exact tie) and replaces the incoming best only on a strict t < best_t.
// Any-hit leaves a ray at its first hit.  Built without fast math and with
// -fmad=false, the tests round as the plain PyTorch version's do.

#include "sctree_walk.cuh"

namespace {

using namespace pine;

constexpr int STACK_DEPTH = 64;  // accel/sctree_traverse.STACK_DEPTH

template <int TID, bool ANY>
__global__ void __launch_bounds__(128)
sctree_kernel(SCTree m, const float* __restrict__ ro, const float* __restrict__ rd,
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
  if (ANY ? (be != 0 || !(tmax > tmin)) : !(bt > tmin)) {
    bt_out[i] = bt;
    be_out[i] = be;
    return;
  }
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float cur_t = tmax;  // running best (t, row); row -1: not improved
  int cur_e = -1;
  int stack[STACK_DEPTH];
  bool occluded = sctree_walk<TID, ANY, STACK_DEPTH>(m, o, d, inv, tmin, tmax, cur_t, cur_e,
                                                     0, stack, 0);
  if (ANY) {
    bt_out[i] = bt;
    be_out[i] = occluded ? 1 : be;
  } else {
    bt_out[i] = cur_e >= 0 ? cur_t : bt;
    be_out[i] = cur_e >= 0 ? cur_e : be;
  }
}

template <int TID>
void launch(bool any_hit, const SCTree& m, const float* ro, const float* rd, const float* tmin,
            const float* tmax, const float* bt_in, const int* be_in, float* bt_out,
            int* be_out, int n, cudaStream_t stream) {
  dim3 block(128), grid((n + 127) / 128);
  if (any_hit)
    sctree_kernel<TID, true><<<grid, block, 0, stream>>>(m, ro, rd, tmin, tmax, bt_in, be_in,
                                                         bt_out, be_out, n);
  else
    sctree_kernel<TID, false><<<grid, block, 0, stream>>>(m, ro, rd, tmin, tmax, bt_in, be_in,
                                                          bt_out, be_out, n);
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// an unknown shape type, or a stack depth other than the one compiled in,
// returns cudaErrorInvalidValue without launching.
extern "C" int pine_sctree_traverse(
    int tid, int any_hit, int stack_depth, const float* rows, int n_prims, int n_super,
    const float* sc_boxes, const float* cell_boxes, const float* boxes, const int* cnode,
    const int* cstart, const int* ccount, const int* sc_order, const float* ro,
    const float* rd, const float* tmin, const float* tmax, const float* bt_in,
    const int* be_in, float* bt_out, int* be_out, int n, void* stream) {
  if (stack_depth != STACK_DEPTH) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SCTree m{rows, n_prims, n_super, sc_boxes, cell_boxes, boxes, cnode, cstart, ccount,
           sc_order};
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                          \
  case T:                                                                     \
    launch<T>(a, m, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s);  \
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
