// The warp-level walk of a prim group's supercell tree
// (accel/sctree.sc_tree_layout), shared by the supercell-tree kernel
// (sctree_traverse.cu: kernel 6, over a group) and the two-level instanced
// kernel (inst_traverse.cu: kernels 8 and 8m, over the shared mesh in each
// instance's frame).  Its leaf is warp_leaf.cuh's.
//
// - One stack per warp in shared memory: node ids, and a taken leaf child
//   waiting its turn.  Lane 0 alone reads and writes it and broadcasts a
//   popped entry by a shuffle, so no lane reads a slot another lane writes.
//   The walk uses the stack from the slot it is given (the instanced kernel
//   walks each mesh above the instance-level entries still pending) and at
//   most the tree's depth of entries; a push past its capacity traps, and
//   each wrapper refuses a deeper tree before it launches.
// - At each popped node every lane tests both child boxes against its own
//   window (closest-hit: its running best; any-hit: tmax), and the warp takes
//   a child when any live lane passes (a ballot).  Leaf children first, the
//   nearer first; then inner children, the nearer popped first.  Which child
//   is nearer is decided per warp by the TPU kernel's rule: the child whose
//   least entry distance over the lanes that reach it is lower (two warp
//   min-reductions).  A majority vote of those lanes (each preferring the
//   child it enters first), built as a -D variant of kernel 6, took 1.8-2.4 %
//   more in each of six calls on the card (H100 80GB HBM3, 700 W), summed
//   over both queries on the terrain group's four ray sets of
//   lab/grid_crossover.py.  Any-hit leaves when no lane of the warp is live
//   and unoccluded (the TPU's jnp.all(done)).
// - A taken leaf's supercells, then their cells, are culled per lane
//   (next_super here, next_cell in warp_leaf.cuh); the cells go to the
//   warp's staged-cell leaf.
#pragma once

#include "warp_leaf.cuh"

namespace pine {

// The thread's ray, read from the special registers each time it is asked
// for: kept live across a walk, the index cost some forms a spill.
__device__ __forceinline__ int ray_index() {
  unsigned t, b, d;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(d));
  return static_cast<int>(b * d + t);
}

// The supercell tree of a prim group.
struct Tree {
  const float* rows;        // (>= n_prims, prim_width) prim rows in leaf order
  int n_prims, n_super;
  const float* sc_boxes;    // (n_super, 6) lo xyz, hi xyz
  const float* cell_boxes;  // (n_super * 4, 6)
  const float* boxes;       // (M, 2, 6) child boxes of each node
  const int* cnode;         // (M, 2) child node, < 0 for a leaf child
  const int* cstart;        // (M, 2) a leaf child's first entry in sc_order
  const int* ccount;        // (M, 2) and its number of supercells
  const int* sc_order;      // supercells in leaf order
};

// The walk's place: its stack (sp entries from stack[0] in shared memory,
// at most cap: a node id, or -1 - (2 * node + child) for a taken leaf child
// waiting its turn) and the open leaf's supercells, sc_order[a, b).  Every
// lane holds the same values.
struct TreeWalk {
  int* stack;
  int sp;
  int a, b;
  int cap;
};

// A float's order as a signed integer, for warp min-reductions.
__device__ __forceinline__ int order_key(float x) {
  int i = __float_as_int(x);
  return i ^ ((i >> 31) & 0x7fffffff);
}

// Opens leaf child k (2 * node + child) of the tree.
__device__ __forceinline__ void open_leaf(TreeWalk& w, const Tree& tr, int k) {
  w.a = __ldg(tr.cstart + k);
  w.b = w.a + __ldg(tr.ccount + k);
}

// Pops an entry of the warp's stack: a waiting leaf child opens; a node's
// children are taken, the nearer leaf child opened, a farther one pushed
// above the inner children, which are pushed the farther first, so that the
// nearer pops next.  A node whose children are both leaves pushes no inner
// child, so the stack never holds more entries than the tree has levels.
template <bool ANY>
__device__ __forceinline__ void visit_node(TreeWalk& w, const Tree& tr, const Lane& l,
                                           int lane) {
  --w.sp;
  int node = __shfl_sync(FULL, lane == 0 ? w.stack[w.sp] : 0, 0);
  if (node < 0) {
    open_leaf(w, tr, -1 - node);
    return;
  }
  bool lv = live<ANY>(l);
  float n0, n1, lim = window<ANY>(l);
  bool h0 = slab_near(tr.boxes + 12 * node, l.r.o, l.inv, l.r.tmin, lim, n0) && lv;
  bool h1 = slab_near(tr.boxes + 12 * node + 6, l.r.o, l.inv, l.r.tmin, lim, n1) && lv;
  bool t0 = __ballot_sync(FULL, h0) != 0, t1 = __ballot_sync(FULL, h1) != 0;
  if (!t0 && !t1) return;
  int m0 = __reduce_min_sync(FULL, h0 ? order_key(n0) : 0x7fffffff);
  int m1 = __reduce_min_sync(FULL, h1 ? order_key(n1) : 0x7fffffff);
  int nr = m0 <= m1 ? 0 : 1;
  int c0 = __ldg(tr.cnode + 2 * node), c1 = __ldg(tr.cnode + 2 * node + 1);
  bool taken_near = nr == 0 ? t0 : t1, taken_far = nr == 0 ? t1 : t0;
  int c_near = nr == 0 ? c0 : c1, c_far = nr == 0 ? c1 : c0;
  auto push = [&](int v) {
    if (w.sp >= w.cap) __trap();  // unreachable: the wrapper checks the tree's depth
    if (lane == 0) w.stack[w.sp] = v;
    ++w.sp;
  };
  // inner children, the farther first so that the nearer pops next
  if (taken_far && c_far >= 0) push(c_far);
  if (taken_near && c_near >= 0) push(c_near);
  // leaf children, the nearer first
  if (taken_near && c_near < 0) {
    open_leaf(w, tr, 2 * node + nr);
    if (taken_far && c_far < 0) push(-1 - (2 * node + 1 - nr));
  } else if (taken_far && c_far < 0) {
    open_leaf(w, tr, 2 * node + 1 - nr);
  }
}

// The next supercell the warp takes, or -1; in_s: this lane passed its cull.
template <bool ANY>
__device__ int next_super(TreeWalk& w, const Tree& tr, const Lane& l, int lane, bool& in_s) {
  for (;;) {
    while (w.a < w.b) {
      int si = __ldg(tr.sc_order + w.a++);
      in_s = live<ANY>(l) && cull<ANY>(tr.sc_boxes + 6 * si, l);
      if (__ballot_sync(FULL, in_s)) return si;
    }
    if (w.sp == 0) return -1;
    if (ANY && !__ballot_sync(FULL, live<ANY>(l))) {  // every ray of the warp is occluded
      w.sp = 0;
      return -1;
    }
    visit_node<ANY>(w, tr, l, lane);
  }
}

}  // namespace pine
