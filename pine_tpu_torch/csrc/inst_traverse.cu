// Two-level instanced traversal for Hopper (sm_90a): the traversal of every
// lazy instanced group (one triangle mesh stored once, many instances).
//
// Replaces pine_tpu/accel/instanced_kernel.py::_make_inst_kernel (reached
// through _compiled_inst_call), the Pallas TPU kernel that walks, per (8,128)
// ray block with one shared scalar stack of tagged entries (id*4 + kind), a
// SAH tree over the instances' world boxes (kind 0), instance entries
// (kind 1: re-cull, then the rays into the instance's frame) and the shared
// mesh's supercell tree in that frame (kind 2).  Its contract is
// inst_kernel_intersect's / inst_kernel_any_hit's:
//   closest-hit: (best_t, best_e) in/out; best_e out is the full virtual id
//   vbase + instance * stride + tri, which the caller takes as it is;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//   lanes with nothing to do (occluded, tmax <= tmin, best_t <= tmin) and
//   lanes that reach no triangle pass their state through bit for bit.
//
// What bounds it on this card: not the work (a ray runs a few dozen slab
// tests in each tree, a 3x4 transform per instance it enters and ~50
// operations per triangle test; the tables, 231 KB of rock rows and ~100 KB
// of trees for the benchmark's field, sit in L1 and L2) but how the warp
// runs it.  One thread per ray, each with its own stack in local memory,
// walking both trees alone and testing a reached cell's 32 rows one by one,
// ran the rock field's main-path launches at 160x / 111x the operations
// bound (closest / any-hit; the MXU form 330x / 214x; H100 80GB HBM3,
// 700 W): the lanes of a warp that did not need an instance or a cell
// waited while the others walked it.
//
// Design: the warp is the unit of the walk, the TPU kernel's one stack per
// block at warp size, carried up one level from the supercell-tree kernel
// (csrc/tree_walk.cuh, over warp_leaf.cuh's staged-cell leaf):
// - One stack per warp in shared memory, STACK_DEPTH entries, read and
//   written by lane 0 alone and broadcast by a shuffle: top nodes (id*4),
//   instance entries (id*4 + 1), and above them the mesh walk's entries
//   while an instance is open.  accel/inst_traverse.stack_need is the walk's
//   worst case; the wrapper refuses a deeper group and a push past the end
//   traps, so no subtree is ever dropped.
// - A top node: each lane slab-tests both children with its world ray
//   against its own window (closest-hit: its running best; any-hit: tmax);
//   the warp takes a child any live lane reaches (a ballot), the nearer by
//   the least entry distance over the lanes that reach it.  Inner children
//   are pushed the farther first, then the instances of the taken leaf
//   children that a live lane's world ray reaches, the nearer child's last,
//   so that they pop first.
// - An instance entry: each lane re-culls the instance's world box against
//   its own running best; the lanes that pass take the ray into the
//   instance's frame with the 3x4 inverse in the order ((m0*x + m1*y) +
//   m2*z) + m3 (directions unnormalized, so local t is world t), and the
//   warp walks the shared mesh's supercell tree with those local rays
//   (tree_walk.cuh) above the pending entries; lanes that did not pass stay
//   in the walk as not live, as every ballot needs all 32 lanes.  The cells
//   the walk takes are staged by cp.async into the warp's two-stage ring and
//   tested lanes over prims (at most GRID_PRIMS_MAX_K rays reach the cell)
//   or lanes over rays; a hit's id is vbase + instance * stride + row.
// - Any-hit leaves when no lane of the warp is live and unoccluded.
// Ties: the running best (t, virtual id) is compared lexicographically, so
// the result is the lowest id among equal t whatever the visit order, and
// the triangle tests take the incoming best as their limit, so the group's
// best replaces the incoming one only on a strict t < best_t.  Built without
// fast math and with -fmad=false, the arithmetic rounds as the plain PyTorch
// version's does.
//
// The MXU leaf form (MXU = true; pine_tpu's _do_super_body_mxu, selected by
// PINE_INST_KERNEL=mxu): the same walk, with the grid kernel's MXU leaf:
// the cell's slice of the shared mesh's supercell-major coefficient table
// (8 x 6 x 32 floats for triangles, warp_leaf.cuh's warp_cells_mxu) staged
// in the ring in place of its rows, and the pair values and epilogue of
// csrc/mxu_epilogue.cuh run on each lane's local ray features, rebuilt at
// each instance entry.  Triangles only.
//
// ptxas -v (sm_90a, at least four blocks of 128 threads per SM): 75 / 72
// registers (closest / any-hit), the MXU form 95 / 89, no spills; 1,024 B
// of static shared memory (the stacks) and 12,288 B (rows) or 49,152 B (MXU
// slices) of dynamic.  Without the minimum ptxas held every form but the
// VPU closest-hit one to 64 registers and spilled 24-56 B, and the MXU form
// took 1.07-1.25x the time (lab/redesign_ab.py on the rock field's
// main-path launches, H100 80GB HBM3, 700 W); a minimum of six blocks
// timed the same as four.

#include "tree_walk.cuh"

namespace {

using namespace pine;

constexpr int STACK_DEPTH = 64;  // accel/inst_traverse.STACK_DEPTH
constexpr int WARPS = 4;         // warps per block

// The instance level of an instanced group (accel/inst_traverse).
struct TopTree {
  const float* boxes;   // (M, 2, 6) child boxes of each node
  const int* cnode;     // (M, 2)
  const int* cstart;    // (M, 2) a leaf child's first instance
  const int* ccount;    // (M, 2)
  const float* iboxes;  // (n_inst, 6) instance world boxes, tree order
  const float* minv;    // (>= n_inst, 12) world -> local 3x4, tree order
  int vbase, stride;
};

// Floats of one stage of a warp's ring: a cell's rows, or its table slice.
template <bool MXU>
__host__ __device__ constexpr int stage_floats() {
  return MXU ? SliceLayout<TRIANGLE>::FLOATS : CellLayout<prim_width<TRIANGLE>()>::FLOATS;
}

// At least four blocks per SM (see above).
template <bool ANY, bool MXU>
__global__ void __launch_bounds__(WARPS * 32, 4)
inst_kernel(TopTree top, Tree mesh, const float* __restrict__ mxu_w,
            const float* __restrict__ ro, const float* __restrict__ rd,
            const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
            const float* __restrict__ bt_in, const int* __restrict__ be_in,
            float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int FLOATS = stage_floats<MXU>();
  extern __shared__ __align__(16) float rings[];  // WARPS two-stage rings
  __shared__ int stacks[WARPS][STACK_DEPTH];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int i = ray_index();
  if (__ballot_sync(FULL, i < n) == 0) return;  // the whole warp lies past the rays
  float* ring = rings + warp * 2 * FLOATS;
  int* stack = stacks[warp];

  // The lane's world ray; l.r, l.inv (and l.r.rf) take its local ray at
  // each instance the lane enters.
  Lane l{};
  l.cur_e = -1;
  V3 wo{}, winv{}, wd{};
  int has_work = 0;  // a ray of the launch with an open window (any-hit: unoccluded)
  if (i < n) {
    float bt = bt_in[i];
    l.r.tmin = tmin_in[i];
    l.r.lim = ANY ? tmax_in[i] : bt;
    l.cur_t = bt;
    has_work = ANY ? (be_in[i] == 0 && l.r.lim > l.r.tmin) : bt > l.r.tmin;
    wo = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
    wd = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
    winv = {safe_inv(wd.x), safe_inv(wd.y), safe_inv(wd.z)};
  }

  int sp = 0;
  auto push = [&](int v) {
    if (sp >= STACK_DEPTH) __trap();  // unreachable: the wrapper checks stack_need
    if (lane == 0) stack[sp] = v;
    ++sp;
  };
  push(0);  // the top tree's root
  while (sp > 0) {
    bool lv = has_work && !(ANY && l.occluded);
    if (ANY && !__ballot_sync(FULL, lv)) break;  // every ray of the warp is occluded
    --sp;
    int ent = __shfl_sync(FULL, lane == 0 ? stack[sp] : 0, 0);
    int id = ent >> 2;
    float lim = window<ANY>(l);
    if ((ent & 3) == 0) {  // a top node, world rays
      float n0, n1;
      bool h0 = slab_near(top.boxes + 12 * id, wo, winv, l.r.tmin, lim, n0) && lv;
      bool h1 = slab_near(top.boxes + 12 * id + 6, wo, winv, l.r.tmin, lim, n1) && lv;
      bool t0 = __ballot_sync(FULL, h0) != 0, t1 = __ballot_sync(FULL, h1) != 0;
      if (!t0 && !t1) continue;
      int m0 = __reduce_min_sync(FULL, h0 ? order_key(n0) : 0x7fffffff);
      int m1 = __reduce_min_sync(FULL, h1 ? order_key(n1) : 0x7fffffff);
      int nr = m0 <= m1 ? 0 : 1;
      int c0 = __ldg(top.cnode + 2 * id), c1 = __ldg(top.cnode + 2 * id + 1);
      bool taken_near = nr == 0 ? t0 : t1, taken_far = nr == 0 ? t1 : t0;
      int c_near = nr == 0 ? c0 : c1, c_far = nr == 0 ? c1 : c0;
      if (taken_far && c_far >= 0) push(c_far << 2);
      if (taken_near && c_near >= 0) push(c_near << 2);
      for (int k = 0; k < 2; ++k) {  // leaf children's instances, the nearer child's last
        int ch = k == 0 ? 1 - nr : nr;
        if (!(k == 0 ? taken_far : taken_near) || (k == 0 ? c_far : c_near) >= 0) continue;
        int start = __ldg(top.cstart + 2 * id + ch), cnt = __ldg(top.ccount + 2 * id + ch);
        for (int j = start; j < start + cnt; ++j)
          if (__ballot_sync(FULL, lv && slab_hit(top.iboxes + 6 * j, wo, winv, l.r.tmin, lim)))
            push((j << 2) | 1);
      }
      continue;
    }
    // an instance: re-cull against each lane's running best, then its mesh
    l.valid = lv && slab_hit(top.iboxes + 6 * id, wo, winv, l.r.tmin, lim);
    if (!__ballot_sync(FULL, l.valid)) continue;
    if (l.valid) {
      const float* mv = top.minv + 12 * id;
      l.r.o = {ld(mv, 0) * wo.x + ld(mv, 1) * wo.y + ld(mv, 2) * wo.z + ld(mv, 3),
               ld(mv, 4) * wo.x + ld(mv, 5) * wo.y + ld(mv, 6) * wo.z + ld(mv, 7),
               ld(mv, 8) * wo.x + ld(mv, 9) * wo.y + ld(mv, 10) * wo.z + ld(mv, 11)};
      l.r.d = {ld(mv, 0) * wd.x + ld(mv, 1) * wd.y + ld(mv, 2) * wd.z,
               ld(mv, 4) * wd.x + ld(mv, 5) * wd.y + ld(mv, 6) * wd.z,
               ld(mv, 8) * wd.x + ld(mv, 9) * wd.y + ld(mv, 10) * wd.z};
      l.inv = {safe_inv(l.r.d.x), safe_inv(l.r.d.y), safe_inv(l.r.d.z)};
      if constexpr (MXU) l.r.rf = ray_features(l.r.o, l.r.d);
    }
    // the mesh walk on the stack above the pending entries
    TreeWalk w{stack + sp, 0, 0, 0, STACK_DEPTH - sp};  // sp < STACK_DEPTH: the root fits
    if (lane == 0) w.stack[0] = 0;  // the mesh tree's root
    w.sp = 1;
    Cells cs{-1, CELLS, false};
    auto next = [&](unsigned& mask) {
      return next_cell<ANY>(cs, mesh.cell_boxes, mesh.n_prims, l, mask, [&](bool& in_s) {
        return next_super<ANY>(w, mesh, l, lane, in_s);
      });
    };
    int ent_base = top.vbase + id * top.stride;
    if constexpr (MXU)
      warp_cells_mxu<TRIANGLE, ANY>(ring, mxu_w, mesh.n_prims, l, lane, next, ent_base);
    else
      warp_cells<TRIANGLE, ANY>(ring, mesh.rows, mesh.n_prims, l, lane, next, ent_base);
  }
  store_lane<ANY>(l, ray_index(), n, bt_in, be_in, bt_out, be_out);
}

template <bool MXU>
cudaError_t launch(bool any_hit, const TopTree& top, const Tree& mesh, const float* mxu_w,
                   const float* ro, const float* rd, const float* tmin, const float* tmax,
                   const float* bt_in, const int* be_in, float* bt_out, int* be_out, int n,
                   cudaStream_t stream) {
  auto k = any_hit ? inst_kernel<true, MXU> : inst_kernel<false, MXU>;
  int smem = WARPS * 2 * stage_floats<MXU>() * 4;
  if (MXU) {  // the slices and stacks need more than the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k<<<(n + WARPS * 32 - 1) / (WARPS * 32), WARPS * 32, smem, stream>>>(
      top, mesh, mxu_w, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
  return cudaGetLastError();
}

}  // namespace

// C interface.  Returns the launch's error (0 on success); a stack depth
// other than the one compiled in returns cudaErrorInvalidValue without
// launching.  mxu_w null: the VPU form; else the MXU leaf form on that
// table.  rows and mxu_w start on 16-byte boundaries.
extern "C" int pine_inst_traverse(
    int any_hit, int stack_depth, const float* rows, int n_prims, int n_super,
    const float* sc_boxes, const float* cell_boxes, const float* mboxes, const int* mcnode,
    const int* mcstart, const int* mccount, const int* sc_order, const float* tboxes,
    const int* tcnode, const int* tcstart, const int* tccount, const float* iboxes,
    const float* minv, int vbase, int stride, const float* ro, const float* rd,
    const float* tmin, const float* tmax, const float* bt_in, const int* be_in,
    float* bt_out, int* be_out, const float* mxu_w, int n, void* stream) {
  if (stack_depth != STACK_DEPTH) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tree mesh{rows, n_prims, n_super, sc_boxes, cell_boxes, mboxes, mcnode, mcstart, mccount,
            sc_order};
  TopTree top{tboxes, tcnode, tcstart, tccount, iboxes, minv, vbase, stride};
  bool a = any_hit != 0;
  if (mxu_w != nullptr)
    return launch<true>(a, top, mesh, mxu_w, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out,
                        n, s);
  return launch<false>(a, top, mesh, mxu_w, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n,
                       s);
}
