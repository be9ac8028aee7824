// Supercell-tree ray-group traversal for Hopper (sm_90a): the traversal of a
// group that CompiledScene.mesh_kernel (or small_kernel) sets to "sctree".
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_sctree_kernel (reached
// through _compiled_sctree_call, TPU kernel 6), the Pallas TPU kernel that
// walks a SAH tree over a group's 128-prim supercells with one scalar stack
// per (8,128) ray block: it takes a child when any lane of the block reaches
// its box, pushes the nearer inner child last by the block's least entry
// distance, DMAs each reached supercell from a lane-padded (E_pad, 128) table
// in HBM and culls its four 32-prim cells while the copy is in flight.  Its
// contract is pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out, best_e the group-local row;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//   lanes with nothing to do (occluded, tmax <= tmin, best_t <= tmin) and
//   lanes that reach no prim pass their state through bit for bit.
//
// What bounds it on this card: not the tests (a terrain ray needs a few
// dozen slab tests and the prim tests of the cells it reaches, the tables
// sit in the 50 MB L2) but how the warp runs them.  One thread per ray, each
// with its own 64-entry stack in local memory, walking its own nodes and
// testing a reached cell's 32 rows one by one from L2, ran at 72x / 48x its
// operations bound (closest / any-hit) on the terrain: the lanes of a warp
// that did not need a cell waited while the others tested it.
//
// Design: the warp is the unit of the walk, the TPU kernel's one stack per
// block at warp size (csrc/tree_walk.cuh, shared with the instanced kernel),
// with the grid kernel's leaf (csrc/warp_leaf.cuh).
// - One stack per warp in shared memory, STACK_DEPTH entries: node ids, and
//   a taken leaf child waiting its turn; the wrapper refuses a deeper tree
//   (accel/sctree_traverse.sctree_cuda).
// - At each popped node the warp takes a child when any live lane reaches
//   it, nearer first by the least entry distance of its lanes.  Any-hit
//   leaves when no lane of the warp is live and unoccluded.
// - A taken leaf's supercells, then their cells, are culled per lane; a cell
//   any lane passes is staged by cp.async into the warp's two-stage ring
//   while the cell before it is tested, and tested lanes over prims (k <=
//   GRID_PRIMS_MAX_K rays reach it) or lanes over rays, as the grid kernel
//   tests its cells.  The walk runs one cell ahead of the tests, so its
//   windows are one cell behind: it can take more nodes and cells, never
//   fewer.  Lanes past the rays, dead lanes and occluded lanes stay in the
//   walk as not live: every ballot and shuffle needs all 32 lanes.
// Closest-hit keeps the lowest (t, row) whatever the visit order (the TPU
// kernel kept the first visited on an exact tie) and replaces the incoming
// best only on a strict t < best_t; any-hit sets the flag at its first hit.
// The prims of a cell are tested only below the group's prim count, so the
// pad rows of the group's table are never read.  Built without fast math
// and with -fmad=false, the tests round as the plain PyTorch version's do.
//
// ptxas -v (sm_90a, at least six blocks of 128 threads per SM): the
// triangle forms take 62 / 60 registers (closest / any-hit) with 13,312 B of
// static shared memory (four warps' two-stage rings of 1,536 B and stacks of
// 64 entries); every instantiation 48-76 registers and 5,120-31,744 B, no
// spills.

#include "tree_walk.cuh"

namespace {

using namespace pine;

constexpr int STACK_DEPTH = 64;  // accel/sctree_traverse.STACK_DEPTH
constexpr int WARPS = 4;         // warps per block

// At least six blocks per SM: without a minimum, ptxas held some forms to
// fewer registers than they need, to keep more blocks resident, and spilled.
template <int TID, bool ANY>
__global__ void __launch_bounds__(WARPS * 32, 6)
sctree_kernel(Tree tr, const float* __restrict__ ro, const float* __restrict__ rd,
              const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
              const float* __restrict__ bt_in, const int* __restrict__ be_in,
              float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  using L = CellLayout<prim_width<TID>()>;
  __shared__ __align__(16) float ring[WARPS][2][L::FLOATS];
  __shared__ int stack[WARPS][STACK_DEPTH];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int i = ray_index();
  if (__ballot_sync(FULL, i < n) == 0) return;  // the whole warp lies past the rays
  Lane l = load_lane<ANY, false>(i, n, ro, rd, tmin_in, tmax_in, bt_in, be_in);
  TreeWalk w{stack[warp], 0, 0, 0, STACK_DEPTH};
  if (lane == 0) w.stack[0] = 0;  // the root
  w.sp = 1;
  Cells cs{-1, CELLS, false};
  warp_cells<TID, ANY>(&ring[warp][0][0], tr.rows, tr.n_prims, l, lane, [&](unsigned& mask) {
    return next_cell<ANY>(cs, tr.cell_boxes, tr.n_prims, l, mask, [&](bool& in_s) {
      return next_super<ANY>(w, tr, l, lane, in_s);
    });
  });
  store_lane<ANY>(l, ray_index(), n, bt_in, be_in, bt_out, be_out);
}

template <int TID>
void launch(bool any_hit, const Tree& tr, const float* ro, const float* rd, const float* tmin,
            const float* tmax, const float* bt_in, const int* be_in, float* bt_out,
            int* be_out, int n, cudaStream_t stream) {
  dim3 block(WARPS * 32), grid((n + WARPS * 32 - 1) / (WARPS * 32));
  if (any_hit)
    sctree_kernel<TID, true><<<grid, block, 0, stream>>>(tr, ro, rd, tmin, tmax, bt_in, be_in,
                                                         bt_out, be_out, n);
  else
    sctree_kernel<TID, false><<<grid, block, 0, stream>>>(tr, ro, rd, tmin, tmax, bt_in, be_in,
                                                          bt_out, be_out, n);
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// an unknown shape type, or a stack depth other than the one compiled in,
// returns cudaErrorInvalidValue without launching.  rows start on a 16-byte
// boundary.
extern "C" int pine_sctree_traverse(
    int tid, int any_hit, int stack_depth, const float* rows, int n_prims, int n_super,
    const float* sc_boxes, const float* cell_boxes, const float* boxes, const int* cnode,
    const int* cstart, const int* ccount, const int* sc_order, const float* ro,
    const float* rd, const float* tmin, const float* tmax, const float* bt_in,
    const int* be_in, float* bt_out, int* be_out, int n, void* stream) {
  if (stack_depth != STACK_DEPTH) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tree tr{rows, n_prims, n_super, sc_boxes, cell_boxes, boxes, cnode, cstart, ccount, sc_order};
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                           \
  case T:                                                                      \
    launch<T>(a, tr, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s);  \
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
