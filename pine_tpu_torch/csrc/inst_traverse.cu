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
// What bounds it: arithmetic and divergence.  A ray runs a few dozen slab
// tests in each tree, a 3x4 transform (33 FP32 operations and 3 divisions)
// per instance it enters and ~50 operations per triangle test; it reads 40
// bytes of ray state and writes 8.  The tables are small (the 4,802-triangle
// rock: 231 KB of rows, ~10 KB of supercell tables; 1,024 instances: ~90 KB)
// and sit in L1 and L2.
//
// Design: one thread per ray, each with its own stack in local memory.  A top
// node slab-tests both children against [tmin, running best] and pushes the
// inner ones far first, then the instances of its leaf children that pass
// their own world-box slab, the nearer child's last.  LIFO order finishes
// every instance (and the mesh walk inside it) before the next inner node
// pops.  An instance entry is re-culled against the running best when it
// pops, then the ray goes into its frame with the 3x4 inverse in the order
// ((m0*x + m1*y) + m2*z) + m3 (directions unnormalized, so local t is world
// t), and sctree_walk (csrc/sctree_walk.cuh, shared with the one-level
// supercell-tree kernel), the mesh-level walk, runs on the same stack above
// the pending entries: supercell-tree nodes near-first, each leaf's supercells
// gated by their box, then their four 32-prim cells, then the triangle tests
// of csrc/prim_tests.cuh.  Ties: the running best (t, virtual id) is compared
// lexicographically, so the result is the lowest id among equal t whatever
// the visit order, and the triangle tests take the incoming best as their
// limit, so the group's best replaces the incoming one only on a strict
// t < best_t.  Any-hit leaves a ray at its first hit.  The stack holds
// STACK_DEPTH entries; the wrapper refuses groups whose worst case exceeds
// it (accel/inst_traverse.stack_need) and a push past the end traps, so no
// subtree is ever dropped.  Built without fast math and with -fmad=false,
// the arithmetic rounds as the plain PyTorch version's does.
//
// The MXU leaf form (MXU = true; pine_tpu's _do_super_body_mxu, selected by
// PINE_INST_KERNEL=mxu): the same walk, with the mesh-level leaf test read
// from the shared mesh's supercell-major coefficient table over the
// instance's local ray (sctree_walk.cuh).  Triangles only.

#include "sctree_walk.cuh"

namespace {

using namespace pine;

constexpr int STACK_DEPTH = 128; // accel/inst_traverse.STACK_DEPTH

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

template <bool ANY, bool MXU>
__global__ void __launch_bounds__(128)
inst_kernel(TopTree top, SCTree mesh, const float* __restrict__ ro,
            const float* __restrict__ rd, const float* __restrict__ tmin_in,
            const float* __restrict__ tmax_in, const float* __restrict__ bt_in,
            const int* __restrict__ be_in, float* __restrict__ bt_out,
            int* __restrict__ be_out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = bt_in[i];
  int be = be_in[i];
  float tmin = tmin_in[i];
  // the triangle-test limit: tmax for any-hit, the incoming best for closest-hit
  float tmax = ANY ? tmax_in[i] : bt;
  if (ANY ? (be != 0 || !(tmax > tmin)) : !(bt > tmin)) {
    bt_out[i] = bt;
    be_out[i] = be;
    return;
  }
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};

  float cur_t = tmax;  // running best (t, virtual id); id -1: not improved
  int cur_e = -1;
  bool occluded = false;
  int stack[STACK_DEPTH];
  int sp = 0;
  push<STACK_DEPTH>(stack, sp, 0);  // the top tree's root, kind 0
  while (sp > 0) {
    int ent = stack[--sp];
    int id = ent >> 2;
    if ((ent & 3) == 0) {  // top node, world rays
      float n0, n1;
      bool h0 = slab_near(top.boxes + 12 * id, o, inv, tmin, cur_t, n0);
      bool h1 = slab_near(top.boxes + 12 * id + 6, o, inv, tmin, cur_t, n1);
      int c[2] = {__ldg(top.cnode + 2 * id), __ldg(top.cnode + 2 * id + 1)};
      bool h[2] = {h0, h1};
      int nr = n0 <= n1 ? 0 : 1;
      if (h[1 - nr] && c[1 - nr] >= 0) push<STACK_DEPTH>(stack, sp, c[1 - nr] << 2);
      if (h[nr] && c[nr] >= 0) push<STACK_DEPTH>(stack, sp, c[nr] << 2);
      for (int k = 0; k < 2; ++k) {  // leaf instances, the nearer child's last
        int ch = k == 0 ? 1 - nr : nr;
        if (!h[ch] || c[ch] >= 0) continue;
        int start = __ldg(top.cstart + 2 * id + ch), cnt = __ldg(top.ccount + 2 * id + ch);
        for (int j = 0; j < cnt; ++j)
          if (slab_hit(top.iboxes + 6 * (start + j), o, inv, tmin, cur_t))
            push<STACK_DEPTH>(stack, sp, ((start + j) << 2) | 1);
      }
    } else {  // instance entry: re-cull against the running best, then its mesh
      if (!slab_hit(top.iboxes + 6 * id, o, inv, tmin, cur_t)) continue;
      const float* mv = top.minv + 12 * id;
      V3 lo = {ld(mv, 0) * o.x + ld(mv, 1) * o.y + ld(mv, 2) * o.z + ld(mv, 3),
               ld(mv, 4) * o.x + ld(mv, 5) * o.y + ld(mv, 6) * o.z + ld(mv, 7),
               ld(mv, 8) * o.x + ld(mv, 9) * o.y + ld(mv, 10) * o.z + ld(mv, 11)};
      V3 ldir = {ld(mv, 0) * d.x + ld(mv, 1) * d.y + ld(mv, 2) * d.z,
                 ld(mv, 4) * d.x + ld(mv, 5) * d.y + ld(mv, 6) * d.z,
                 ld(mv, 8) * d.x + ld(mv, 9) * d.y + ld(mv, 10) * d.z};
      V3 linv = {safe_inv(ldir.x), safe_inv(ldir.y), safe_inv(ldir.z)};
      if (sctree_walk<TRIANGLE, ANY, STACK_DEPTH, MXU>(mesh, lo, ldir, linv, tmin, tmax, cur_t,
                                                  cur_e, top.vbase + id * top.stride, stack,
                                                  sp)) {
        occluded = true;
        break;
      }
    }
  }
  if (ANY) {
    bt_out[i] = bt;
    be_out[i] = occluded ? 1 : be;
  } else {
    bt_out[i] = cur_e >= 0 ? cur_t : bt;
    be_out[i] = cur_e >= 0 ? cur_e : be;
  }
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// a stack depth other than the one compiled in returns cudaErrorInvalidValue
// without launching.  mxu_w null: the VPU form; else the MXU leaf form on
// that table.
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
  SCTree mesh{rows, n_prims, n_super, sc_boxes, cell_boxes, mboxes, mcnode, mcstart,
              mccount, sc_order, mxu_w};
  TopTree top{tboxes, tcnode, tcstart, tccount, iboxes, minv, vbase, stride};
  dim3 block(128), grid((n + 127) / 128);
#define PINE_LAUNCH(A, X)                                                                \
  inst_kernel<A, X><<<grid, block, 0, s>>>(top, mesh, ro, rd, tmin, tmax, bt_in, be_in,   \
                                           bt_out, be_out, n)
  if (mxu_w != nullptr) {
    if (any_hit)
      PINE_LAUNCH(true, true);
    else
      PINE_LAUNCH(false, true);
  } else if (any_hit) {
    PINE_LAUNCH(true, false);
  } else {
    PINE_LAUNCH(false, false);
  }
#undef PINE_LAUNCH
  return cudaGetLastError();
}
