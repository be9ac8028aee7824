// BVH ray-group traversal for Hopper (sm_90a): the traversal of every group
// of more than 2,000,000 prims (a high-resolution mesh), and of a group that
// CompiledScene.mesh_kernel or small_kernel sets to "bvh".
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_bvh_kernel (the kind
// "bvh" body of _compiled_call), the Pallas TPU kernel that walks a group's
// binary SAH tree with one 48-entry scalar stack per (8,128) ray block, tests
// both child boxes of a popped node against the whole block, tests leaves of
// up to LEAF_MAX = 4 rows with masked unrolled prim tests and pushes the
// inner children far first.  Its contract is pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out, best_e the group-local row;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//   lanes with nothing to do (occluded, tmax <= tmin, best_t <= tmin) and
//   lanes that reach no prim pass their state through bit for bit.
//
// What bounds it: arithmetic, divergence and latency.  A ray runs two slab
// tests per node it pops (a few dozen nodes) and the prim tests of the leaves
// it reaches; it reads 40 bytes of ray state and writes 8.  The node arrays
// (~48 bytes of boxes and 24 of links per node, about n/2 nodes) and the
// rows (the 2,004,002-triangle terrain: 96 MB) exceed the 50 MB L2, so a
// walk's node and row reads go to HBM where rays diverge.
//
// Design: one thread per ray, each with its own stack of STACK_DEPTH entries
// in local memory, where the TPU shared one per ray block.  A popped node
// slab-tests both child boxes against (tmin, running best) (any-hit: (tmin,
// tmax)), tests the rows of its leaf children, the nearer first, and pushes
// its inner children, the farther first, so that the nearer pops next.  A
// leaf's rows are read only below its count (c_start .. c_start + c_count),
// so the pad rows of the group's table are never read.  The stack never
// drops a push: the wrapper refuses a tree deeper than STACK_DEPTH
// (accel/bvh_traverse.bvh_cuda; the walk needs at most the tree's depth
// of entries), where the TPU kernel silently dropped pushes past 46.
// Closest-hit keeps the lowest (t, row) whatever the visit order and
// replaces the incoming best only on a strict t < best_t.  Any-hit leaves a
// ray at its first hit.  Built without fast math and with -fmad=false, the
// tests round as the plain PyTorch version's do.

#include "prim_tests.cuh"

namespace {

using namespace pine;

constexpr int STACK_DEPTH = 64;  // accel/bvh_traverse.STACK_DEPTH

struct Tree {
  const float* rows;   // (>= n_prims, prim_width) prim rows in leaf order
  const float* boxes;  // (M, 2, 6) child boxes of each node, lo xyz, hi xyz
  const int* cnode;    // (M, 2) child node, < 0 for a leaf child
  const int* cstart;   // (M, 2) a leaf child's first row
  const int* ccount;   // (M, 2) and its number of rows
};

template <int TID, bool ANY>
__global__ void __launch_bounds__(128)
bvh_kernel(Tree tr, const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
           const float* __restrict__ bt_in, const int* __restrict__ be_in,
           float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int W = prim_width<TID>();
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
  bool occluded = false;
  int stack[STACK_DEPTH];
  int sp = 0;
  push<STACK_DEPTH>(stack, sp, 0);
  while (sp > 0) {
    int node = stack[--sp];
    float lim = ANY ? tmax : cur_t;
    float n0, n1;
    bool h0 = slab_near(tr.boxes + 12 * node, o, inv, tmin, lim, n0);
    bool h1 = slab_near(tr.boxes + 12 * node + 6, o, inv, tmin, lim, n1);
    int c0 = __ldg(tr.cnode + 2 * node), c1 = __ldg(tr.cnode + 2 * node + 1);
    int nr = n0 <= n1 ? 0 : 1;  // the nearer child
    for (int k = 0; k < 2; ++k) {  // leaf children, the nearer first
      int ch = k == 0 ? nr : 1 - nr;
      if (!(ch == 0 ? h0 : h1) || (ch == 0 ? c0 : c1) >= 0) continue;
      int start = __ldg(tr.cstart + 2 * node + ch), cnt = __ldg(tr.ccount + 2 * node + ch);
      for (int e = start; e < start + cnt; ++e) {
        float t = prim_test<TID>(tr.rows + (size_t)e * W, o, d, tmin, tmax);
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
    // inner children, the farther first so that the nearer pops next
    if ((nr == 0 ? h1 : h0) && (nr == 0 ? c1 : c0) >= 0)
      push<STACK_DEPTH>(stack, sp, nr == 0 ? c1 : c0);
    if ((nr == 0 ? h0 : h1) && (nr == 0 ? c0 : c1) >= 0)
      push<STACK_DEPTH>(stack, sp, nr == 0 ? c0 : c1);
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

template <int TID>
void launch(bool any_hit, const Tree& tr, const float* ro, const float* rd, const float* tmin,
            const float* tmax, const float* bt_in, const int* be_in, float* bt_out,
            int* be_out, int n, cudaStream_t stream) {
  dim3 block(128), grid((n + 127) / 128);
  if (any_hit)
    bvh_kernel<TID, true><<<grid, block, 0, stream>>>(tr, ro, rd, tmin, tmax, bt_in, be_in,
                                                      bt_out, be_out, n);
  else
    bvh_kernel<TID, false><<<grid, block, 0, stream>>>(tr, ro, rd, tmin, tmax, bt_in, be_in,
                                                       bt_out, be_out, n);
}

}  // namespace

// C interface.  Returns cudaGetLastError() after the launch (0 on success);
// an unknown shape type, or a stack depth other than the one compiled in,
// returns cudaErrorInvalidValue without launching.
extern "C" int pine_bvh_traverse(
    int tid, int any_hit, int stack_depth, const float* rows, const float* boxes,
    const int* cnode, const int* cstart, const int* ccount, const float* ro, const float* rd,
    const float* tmin, const float* tmax, const float* bt_in, const int* be_in,
    float* bt_out, int* be_out, int n, void* stream) {
  if (stack_depth != STACK_DEPTH) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tree tr{rows, boxes, cnode, cstart, ccount};
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
