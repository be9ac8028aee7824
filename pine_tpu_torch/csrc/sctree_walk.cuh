// The walk of a prim group's supercell tree (accel/sctree.sc_tree_layout),
// shared by the one-level supercell-tree kernel (sctree_traverse.cu, TPU
// kernel _make_sctree_kernel) and the two-level instanced kernel
// (inst_traverse.cu), which runs it over the shared mesh in each instance's
// frame.
//
// The tree is a SAH tree over the group's 128-prim supercells.  The walk
// descends it near-first with a per-thread stack; at each leaf child its ray
// reaches it gates the leaf's supercells by their boxes, then each
// supercell's four 32-prim cells, and tests the prims of the cells that pass
// (csrc/prim_tests.cuh).  Every cull's window ends at the running best
// (closest-hit) or at tmax (any-hit).  Closest-hit compares (t, id)
// lexicographically, so among equal t the lowest id wins whatever the visit
// order; any-hit returns at the first hit.
//
// With MXU set (the instanced kernel's MXU leaf form, pine_tpu's
// _do_super_body_mxu under PINE_INST_KERNEL=mxu), the culls stay and the leaf
// reads prim e's m columns of the supercell-major coefficient table
// (SCTree::mxu_w, accel/mxu_tables.build_mesh_tables) and runs the epilogue
// of csrc/mxu_epilogue.cuh on the walk's ray, where the VPU form runs
// prim_test<TID> on its row.
#pragma once

#include "mxu_epilogue.cuh"

namespace pine {

constexpr int SUPER = 128;  // prims per supercell
constexpr int CELL = 32;    // prims per cull cell

// The supercell tree of a prim group.
struct SCTree {
  const float* rows;        // (>= n_prims, prim_width) prim rows in leaf order
  int n_prims, n_super;
  const float* sc_boxes;    // (n_super, 6) lo xyz, hi xyz
  const float* cell_boxes;  // (n_super * 4, 6)
  const float* boxes;       // (M, 2, 6) child boxes of each node
  const int* cnode;         // (M, 2) child node, < 0 for a leaf child
  const int* cstart;        // (M, 2) a leaf child's first entry in sc_order
  const int* ccount;        // (M, 2) and its number of supercells
  const int* sc_order;      // supercells in leaf order
  const float* mxu_w;       // MXU leaf form: (n_super * 8, m * 128) coefficient table
};

// One supercell: its box, then its cells, then the prims of the cells that
// pass.  Closest-hit updates (cur_t, cur_e); any-hit returns true at a hit.
template <int TID, bool ANY, bool MXU = false>
__device__ __forceinline__ bool sctree_super(const SCTree& m, int si, V3 o, V3 d, V3 inv,
                                             float tmin, float tmax, float& cur_t, int& cur_e,
                                             int ent_base, const RayFeat& rf) {
  if (!slab_hit(m.sc_boxes + 6 * si, o, inv, tmin, ANY ? tmax : cur_t)) return false;
  for (int kc = 0; kc < SUPER / CELL; ++kc) {
    int cell = si * (SUPER / CELL) + kc;
    int p0 = cell * CELL;
    if (p0 >= m.n_prims) break;
    if (!slab_hit(m.cell_boxes + 6 * cell, o, inv, tmin, ANY ? tmax : cur_t)) continue;
    int p1 = min(p0 + CELL, m.n_prims);
    for (int e = p0; e < p1; ++e) {
      float t;
      if constexpr (MXU)
        t = mesh_pair_t<TID>(m.mxu_w, e, rf, tmin, tmax);
      else
        t = prim_test<TID>(m.rows + (size_t)e * prim_width<TID>(), o, d, tmin, tmax);
      if (ANY) {
        if (t < BIG) return true;
      } else {
        int vid = ent_base + e;
        if (t < cur_t || (t == cur_t && vid < cur_e)) {
          cur_t = t;
          cur_e = vid;
        }
      }
    }
  }
  return false;
}

// The walk for one ray (o, d, inv) with prim-test limit tmax and running best
// (cur_t, cur_e); hit ids are ent_base + row.  Uses stack[sp0:], a stack of
// CAP entries, and leaves it as it found it; it needs at most the tree's
// depth of entries above sp0.  Any-hit returns true at the first hit.
template <int TID, bool ANY, int CAP, bool MXU = false>
__device__ bool sctree_walk(const SCTree& m, V3 o, V3 d, V3 inv, float tmin, float tmax,
                            float& cur_t, int& cur_e, int ent_base, int* stack, int sp0) {
  RayFeat rf;
  if constexpr (MXU) rf = ray_features(o, d);
  int sp = sp0;
  push<CAP>(stack, sp, 0);
  while (sp > sp0) {
    int node = stack[--sp];
    float lim = ANY ? tmax : cur_t;
    float n0, n1;
    bool h0 = slab_near(m.boxes + 12 * node, o, inv, tmin, lim, n0);
    bool h1 = slab_near(m.boxes + 12 * node + 6, o, inv, tmin, lim, n1);
    int c0 = __ldg(m.cnode + 2 * node), c1 = __ldg(m.cnode + 2 * node + 1);
    int nr = n0 <= n1 ? 0 : 1;  // the nearer child
    for (int k = 0; k < 2; ++k) {  // leaf children now, the nearer first
      int ch = k == 0 ? nr : 1 - nr;
      if (!(ch == 0 ? h0 : h1) || (ch == 0 ? c0 : c1) >= 0) continue;
      int start = __ldg(m.cstart + 2 * node + ch), cnt = __ldg(m.ccount + 2 * node + ch);
      for (int j = 0; j < cnt; ++j)
        if (sctree_super<TID, ANY, MXU>(m, __ldg(m.sc_order + start + j), o, d, inv, tmin,
                                        tmax, cur_t, cur_e, ent_base, rf))
          return true;
    }
    // inner children, the farther first so that the nearer pops next
    if ((nr == 0 ? h1 : h0) && (nr == 0 ? c1 : c0) >= 0)
      push<CAP>(stack, sp, nr == 0 ? c1 : c0);
    if ((nr == 0 ? h0 : h1) && (nr == 0 ? c0 : c1) >= 0)
      push<CAP>(stack, sp, nr == 0 ? c0 : c1);
  }
  return false;
}

}  // namespace pine
