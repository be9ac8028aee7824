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
// What bounds it: the latency of a walk's dependent reads, and its issued
// instructions.  A ray runs two slab tests per node it visits (a few dozen
// nodes) and the prim tests of the leaves it reaches; it reads 40 bytes of
// ray state and writes 8.  The nodes (64 bytes each, about n/2 of them) and
// the rows (the 2,004,002-triangle terrain: 96 MB) exceed the 50 MB L2, and
// the rays of a warp diverge, so each node and row a lane reads is a
// transaction of its own, and each read waits on the one before.  One
// thread per ray reading a node as 18 scalar loads over four arrays and a
// row as one load per column ran the 2 M terrain's main-path launches at
// 26x / 29x the bound of its bytes (H100 80GB HBM3, 700 W).  Packing a node
// into one record moved nothing by itself (PERF.md, Findings): reading a
// leaf's rows at once and fewer instructions per node did.
//
// Design:
// - One node is one 16-byte-aligned record of 16 words (accel/bvh_traverse
//   .pack_nodes): the two child boxes, lo xyz and hi xyz each, then one link
//   per child, the child node (>= 0) or, for a leaf child, ~(first row * 8 +
//   count) (< 0), and two pad words.  A node is four 16-byte read-only
//   vector loads of one half line.
// - Rows are padded to a multiple of 4 floats (accel/dense_traverse
//   .dense_rows; a triangle row is 12 floats already) and read as 16-byte
//   vectors; a leaf's rows (up to LEAF_MAX) are all loaded before the first
//   is tested, so a leaf costs one round trip, not one per row (rows of up
//   to 16 floats; the OBB's 32 are read one row after the other).
// - One thread per ray.  A visited node slab-tests both child boxes against
//   (tmin, running best) (any-hit: (tmin, tmax)); of its inner children the
//   nearer is visited next and the farther pushed, and its leaf children's
//   rows are tested at once, the nearer leaf first.  (Aila and Laine's
//   while-while order, which keeps a leaf pending until the whole warp holds
//   one, measured 11-12 % slower here.)
// - The child-box test takes fminf / fmaxf, one instruction each, where the
//   plain versions' minimum and maximum propagate NaN (vmin / vmax, several):
//   the same on every ray the kernel walks, since a ray with a NaN or an
//   infinite coordinate is passed through at entry (no prim test gives it a
//   hit) and the boxes of finite prims are finite.
// - Each thread's stack is in shared memory, entry-major ([entry][thread]:
//   no two lanes of a warp on one bank), sized to the tree's depth at the
//   launch: the walk needs fewer entries than that, and the wrapper refuses
//   a tree deeper than STACK_DEPTH (accel/bvh_traverse.bvh_cuda), where the
//   TPU kernel silently dropped pushes past 46.
// - The prim tests take the exact early misses of prim_tests.cuh (EARLY).
// A leaf's rows are read only below its count, so the pad rows of the
// group's table are never read.  The prim window is (tmin, incoming best)
// whatever the visit order, and closest-hit keeps the lowest (t, row): it
// replaces the incoming best only on a strict t < best_t.  Any-hit leaves a
// ray at its first hit.  Built without fast math and with -fmad=false, the
// tests round as the plain PyTorch version's do.

#include "prim_tests.cuh"

namespace {

using namespace pine;

// Rays per block.  Measured on the 2,004,002-triangle terrain's main-path
// launches (H100 80GB HBM3, 700 W; PERF.md, Findings): 256 rays took
// 0.99-1.03x the time of 128 in each form of the walk.
constexpr int BLOCK = 128;
constexpr int STACK_DEPTH = 64;   // accel/bvh_traverse.STACK_DEPTH
constexpr int DONE = 0x7fffffff;  // no node left: above every node, and not a leaf
constexpr int LEAF_MAX = 4;       // rows of a leaf (accel/bvh.LEAF_MAX)
static_assert(STACK_DEPTH * BLOCK * 4 <= 48 * 1024, "the stack fits the default shared memory");

// A thread's stack in shared memory, entry-major ([entry][thread]), so that
// the lanes of a warp never share a bank whatever their depths.
struct Stack {
  int* s;
  int sp = 0;
  int cap;
  __device__ Stack(int* base, int cap_) : s(base + threadIdx.x), cap(cap_) {}
  __device__ __forceinline__ void push(int v) {
    if (sp >= cap) __trap();  // unreachable: the walk needs fewer entries than the depth
    s[BLOCK * sp++] = v;
  }
  __device__ __forceinline__ int pop() { return sp > 0 ? s[BLOCK * --sp] : DONE; }
};

// A child box (lo xyz, hi xyz) against a finite ray's window (tmin, lim);
// near: the entry distance.
__device__ __forceinline__ bool child_hit(float lx, float ly, float lz, float hx, float hy,
                                          float hz, V3 o, V3 inv, float tmin, float lim,
                                          float& near) {
  float t0x = (lx - o.x) * inv.x, t1x = (hx - o.x) * inv.x;
  float t0y = (ly - o.y) * inv.y, t1y = (hy - o.y) * inv.y;
  float t0z = (lz - o.z) * inv.z, t1z = (hz - o.z) * inv.z;
  near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
  float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), lim));
  return near <= far;
}

template <int TID, bool ANY>
__global__ void __launch_bounds__(BLOCK)
bvh_kernel(const float4* __restrict__ nodes, const float* __restrict__ rows, int depth,
           const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
           const float* __restrict__ bt_in, const int* __restrict__ be_in,
           float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int WP = padded_width<TID>();
  extern __shared__ int sstack[];  // depth entries of BLOCK threads
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float bt = bt_in[i];
  int be = be_in[i];
  float tmin = tmin_in[i];
  // the prim-test limit: tmax for any-hit, the incoming best for closest-hit
  float tmax = ANY ? tmax_in[i] : bt;
  V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  bool idle = ANY ? (be != 0 || !(tmax > tmin)) : !(bt > tmin);
  if (idle || !(isfinite(o.x) && isfinite(o.y) && isfinite(o.z) && isfinite(d.x) &&
                isfinite(d.y) && isfinite(d.z))) {
    bt_out[i] = bt;
    be_out[i] = be;
    return;
  }
  V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float cur_t = tmax;  // running best (t, row); row -1: not improved
  int cur_e = -1;
  Stack st(sstack, depth);

  // A tested row's t: true at an any-hit lane's first hit.
  auto take = [&](float t, int e) {
    if (ANY) return t < BIG;
    if (t < cur_t || (t == cur_t && e < cur_e)) {
      cur_t = t;
      cur_e = e;
    }
    return false;
  };
  // The rows of leaf link ``leaf`` (< 0), in order; true at an any-hit hit.
  auto test_leaf = [&](int leaf) {
    int v = ~leaf;
    int start = v >> 3, cnt = v & 7;
    // the rows of up to LEAF_MAX (rows of 16 floats or fewer) or one at a
    // time: every load of a step issued before its first test
    constexpr int AT_ONCE = WP <= 16 ? LEAF_MAX : 1;
    for (int k0 = 0; k0 < cnt; k0 += AT_ONCE) {
      GlobalRowV<WP> r[AT_ONCE];
#pragma unroll
      for (int j = 0; j < AT_ONCE; ++j)
        if (k0 + j < cnt) r[j].load(rows + (size_t)(start + k0 + j) * WP);
#pragma unroll
      for (int j = 0; j < AT_ONCE; ++j) {
        if (k0 + j >= cnt) break;
        if (take(prim_test_row<TID, true>(r[j], o, d, tmin, tmax), start + k0 + j)) return true;
      }
    }
    return false;
  };

  bool occluded = false;
  int node = 0;
  while (true) {
    const float4* p = nodes + 4 * (size_t)node;
    float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2), l = __ldg(p + 3);
    float lim = ANY ? tmax : cur_t;
    float n0, n1;
    bool h0 = child_hit(a.x, a.y, a.z, a.w, b.x, b.y, o, inv, tmin, lim, n0);
    bool h1 = child_hit(b.z, b.w, c.x, c.y, c.z, c.w, o, inv, tmin, lim, n1);
    int c0 = __float_as_int(l.x), c1 = __float_as_int(l.y);
    bool near0 = n0 <= n1;
    int cn = near0 ? c0 : c1, cf = near0 ? c1 : c0;  // the nearer child, the farther
    bool hn = near0 ? h0 : h1, hf = near0 ? h1 : h0;
    if (hn && cn >= 0) {  // the inner children: the nearer next, the farther pushed
      node = cn;
      if (hf && cf >= 0) st.push(cf);
    } else if (hf && cf >= 0) {
      node = cf;
    } else {
      node = st.pop();
    }
    if ((hn && cn < 0 && test_leaf(cn)) || (hf && cf < 0 && test_leaf(cf))) {
      occluded = true;
      break;
    }
    if (node == DONE) break;
  }
  if (ANY) {
    bt_out[i] = bt;
    be_out[i] = occluded ? 1 : be;
  } else {
    bt_out[i] = cur_e >= 0 ? cur_t : bt;
    be_out[i] = cur_e >= 0 ? cur_e : be;
  }
}

template <int TID>
cudaError_t launch(bool any_hit, int depth, const float* nodes, const float* rows, int width,
                   const float* ro, const float* rd, const float* tmin, const float* tmax,
                   const float* bt_in, const int* be_in, float* bt_out, int* be_out, int n,
                   cudaStream_t stream) {
  if (width != padded_width<TID>()) return cudaErrorInvalidValue;
  auto k = any_hit ? bvh_kernel<TID, true> : bvh_kernel<TID, false>;
  k<<<(n + BLOCK - 1) / BLOCK, BLOCK, depth * BLOCK * 4, stream>>>(
      reinterpret_cast<const float4*>(nodes), rows, depth, ro, rd, tmin, tmax, bt_in, be_in,
      bt_out, be_out, n);
  return cudaGetLastError();
}

}  // namespace

// C interface.  Returns the launch's error (0 on success).  An unknown shape
// type, rows of another width than the type's padded width (a multiple of 4
// floats), or a tree deeper than the stack (depth: its node levels, more
// than the stack entries the walk needs) return cudaErrorInvalidValue
// without launching.  nodes and rows start on a 16-byte boundary.
extern "C" int pine_bvh_traverse(
    int tid, int any_hit, int depth, const float* nodes, const float* rows, int width,
    const float* ro, const float* rd, const float* tmin, const float* tmax, const float* bt_in,
    const int* be_in, float* bt_out, int* be_out, int n, void* stream) {
  if (depth < 1 || depth > STACK_DEPTH) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                                   \
  case T:                                                                              \
    return launch<T>(a, depth, nodes, rows, width, ro, rd, tmin, tmax, bt_in, be_in,   \
                     bt_out, be_out, n, s);
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
}
