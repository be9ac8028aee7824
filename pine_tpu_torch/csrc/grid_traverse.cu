// Grid ray-group traversal for Hopper (sm_90a): the traversal of every
// non-lattice group of more than 512 prims, which is every mesh.
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_grid_kernel (reached
// through _compiled_grid_call, TPU kernel 5), the Pallas TPU kernel that
// sweeps a group's prims in leaf order as 128-prim supercells, culling an
// (8,128) ray block against 16-supercell coarse boxes, supercell boxes and
// 32-prim cell boxes, visiting coarse boxes and supercells near-first in the
// block's direction octant; and its MXU form (mxu_m > 0, test_super_mxu,
// kernel 5m, the route "grid_mxu"), which tests a taken supercell with one
// (m*128, 8)^T x (8, 128) matmul of its coefficient table per sublane row.
// Its contract is pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out, best_e the group-local row;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//   lanes with tmax <= tmin, lanes already occluded and lanes culled at every
//   level pass their state through bit for bit.
//
// What bounds it on this card: not the tests it runs (a terrain ray runs
// about 110 slab tests and 120 triangle tests, 1.3x the order-free minimum)
// but how the warp runs them.  One thread per ray, each walking its own
// boxes and testing a cell's 32 rows one by one from L2, ran the function at
// 46x its operations bound: where the lanes of a warp need different cells
// the warp runs each lane's 32-prim loop while the others wait, and a cell
// that k lanes need costs 32 serial row loads whatever k is.
//
// Design: the warp is the unit of the walk.  The lane state, the two leaf
// schedules and kernel 5's staged-cell loop are csrc/warp_leaf.cuh's,
// shared with the supercell-tree kernel (sctree_traverse.cu).
// - Each lane culls its own ray at each level (coarse box, supercell, cell)
//   with its own window (closest-hit: its running best; any-hit: tmax), and
//   the warp takes a box when any live lane passes (a ballot), in the
//   near-first order of the octant most of its live lanes travel in (the
//   TPU's per-block blk_oct).  A lane tests a cell's prims only when it
//   passed that cell's cull and those above it.  Any-hit leaves when no lane
//   of the warp is live and unoccluded.
// - Kernel 5's leaf: the warp stages each taken cell's rows (32 x width
//   floats, 1,536 B for triangles) into its own two-stage ring in shared
//   memory with cp.async, 16-byte chunks, coalesced; the next taken cell's
//   rows are in flight while the current cell is tested.  Rows a multiple of
//   4 floats wide sit an odd number of 16-byte chunks apart, so that lanes
//   reading different rows as vectors hit distinct banks (SharedRow).
// - Two leaf schedules, chosen per cell from k, the lanes that passed its
//   cull: k <= GRID_PRIMS_MAX_K runs lanes over prims (each of the k rays
//   broadcast in turn by shuffles, lane j testing prim j, (t, row) reduced
//   across the warp to the ray's own lane), so a sparse cell costs k steps,
//   not 32; a denser one runs lanes over rays (each lane its own ray over
//   the 32 staged rows).
// - Kernel 5m's leaf: the block walks together (votes by __syncthreads_or)
//   and stages each taken supercell's strip of the supercell-major
//   coefficient table (8 x m*128 floats, 24,576 B for triangles; contiguous)
//   with one bulk asynchronous copy (cp.async.bulk completing on an
//   mbarrier, the 1-D form of the TMA) into a two-stage ring shared by the
//   block's warps.  Each warp then culls the supercell's cells per lane and
//   runs the same two schedules with the coefficient-table test
//   (strip_pair_t, csrc/mxu_epilogue.cuh: the ordered FP32 sum of eight
//   products per pair value, then the epilogue) on the strip.  A tensor-core
//   leaf (mma.sync.m16n8k8 in TF32, 3xTF32 split) was weighed and not built:
//   its CPU emulation (tests/test_torch_mxu.py) put 1.2e-3 of a reduced
//   terrain render's bounce rays outside the gate against the ordered sums,
//   over the 1e-4 allowed (mxu_epilogue.cuh).
// Closest-hit keeps a (t, row) best compared lexicographically, so ties go
// to the lowest row whatever the visit order or schedule, and a row replaces
// the incoming best only on a strict t < best_t: the result is that of a
// sweep over the rows in order (grid_plain).  The two can differ only where
// a cull decides at a box face.  Built without fast math and with
// -fmad=false, the tests round as the plain PyTorch version does.
//
// ptxas -v (sm_90a): the triangle forms take 63 / 56 registers (closest /
// any-hit) with 12,288 B of static shared memory (four warps' two-stage
// rings of 1,536 B), the MXU triangle forms 56 / 56 with 49,152 B of
// dynamic shared memory (two 24,576-B strips) and 16 B of barriers; every
// instantiation 46-72 registers, no spills.

#include "warp_leaf.cuh"

namespace {

using namespace pine;

constexpr int COARSE = 16;  // supercells per coarse box
constexpr int WARPS = 4;    // warps per block

struct Tables {
  const float* rows;          // (>= n_prims, prim_width) prim rows in leaf order
  int n_prims, n_super, n_coarse, use_coarse;
  const float* coarse_boxes;  // (n_coarse, 6) lo xyz, hi xyz
  const float* sc_boxes;      // (n_coarse * 16, 6)
  const float* cell_boxes;    // (n_super * 4, 6)
  const int* c_order8;        // (8, n_coarse) near-first coarse order per octant
  const int* s_order8;        // (8, n_coarse * 16) supercells, within their coarse box
  const float* mxu_w;         // MXU form: (n_super * 8, m * 128) coefficient table
};

// The coarse-box and supercell levels of the walk, taken together by the
// lanes of the unit: a box is taken when any live lane's cull passes, in the
// near-first order of the unit's octant (the octant most of its live lanes
// travel in, as the TPU kernel's blk_oct).
struct Walk {
  const int* c_order;
  const int* s_order;
  int ci;     // next position in the coarse order
  int c, k;   // the open coarse box, next position among its supercells (COARSE: none open)
  bool in_c;  // this lane passed the open coarse box
};

template <bool ANY, bool BLOCK>
__device__ __forceinline__ Walk start_walk(const Tables& tb, const Lane& l) {
  int oct = (l.r.d.x < 0.0f ? 1 : 0) | (l.r.d.y < 0.0f ? 2 : 0) | (l.r.d.z < 0.0f ? 4 : 0);
  int best = 0, most = -1;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    int c = count_of<BLOCK>(live<ANY>(l) && oct == o);
    if (c > most) { most = c; best = o; }
  }
  return Walk{tb.c_order8 + best * tb.n_coarse, tb.s_order8 + best * tb.n_coarse * COARSE,
              0, 0, COARSE, false};
}

// The next supercell the unit takes, or -1; in_s: this lane passed its cull.
template <bool ANY, bool BLOCK>
__device__ int next_super(Walk& w, const Tables& tb, const Lane& l, bool& in_s) {
  for (;;) {
    if (w.k == COARSE) {
      if (w.ci == tb.n_coarse) return -1;
      if (ANY && !any_of<BLOCK>(live<ANY>(l))) {  // every ray of the unit is occluded
        w.ci = tb.n_coarse;
        return -1;
      }
      w.c = tb.use_coarse ? __ldg(w.c_order + w.ci) : 0;
      ++w.ci;
      w.in_c = live<ANY>(l) && (!tb.use_coarse || cull<ANY>(tb.coarse_boxes + 6 * w.c, l));
      if (!any_of<BLOCK>(w.in_c)) continue;
      w.k = 0;
    }
    while (w.k < COARSE) {
      int si = __ldg(w.s_order + w.c * COARSE + w.k++);
      if (si >= tb.n_super) continue;  // padding of the last coarse box
      in_s = w.in_c && live<ANY>(l) && cull<ANY>(tb.sc_boxes + 6 * si, l);
      if (any_of<BLOCK>(in_s)) return si;
    }
  }
}

// --------------------------------------------------------------------------
// kernel 5: cell rows staged per warp by cp.async
// --------------------------------------------------------------------------

template <int TID, bool ANY>
__global__ void __launch_bounds__(WARPS * 32)
grid_kernel(Tables tb, const float* __restrict__ ro, const float* __restrict__ rd,
            const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
            const float* __restrict__ bt_in, const int* __restrict__ be_in,
            float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int W = prim_width<TID>();
  using L = CellLayout<W>;
  __shared__ __align__(16) float ring[WARPS][2][L::FLOATS];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (__ballot_sync(FULL, i < n) == 0) return;  // the whole warp lies past the rays
  Lane l = load_lane<ANY, false>(i, n, ro, rd, tmin_in, tmax_in, bt_in, be_in);
  Walk w = start_walk<ANY, false>(tb, l);
  Cells cs{-1, CELLS, false};
  warp_cells<TID, ANY>(&ring[warp][0][0], tb.rows, tb.n_prims, l, lane, [&](unsigned& mask) {
    return next_cell<ANY>(cs, tb.cell_boxes, tb.n_prims, l, mask, [&](bool& in_s) {
      return next_super<ANY, false>(w, tb, l, in_s);
    });
  });
  store_lane<ANY>(l, i, n, bt_in, be_in, bt_out, be_out);
}

// --------------------------------------------------------------------------
// kernel 5m: supercell strips staged per block by cp.async.bulk
// --------------------------------------------------------------------------

template <int TID>
__host__ __device__ constexpr int strip_floats() { return RAY_FEATS * mxu_m<TID>() * SUPER; }

template <int TID, bool ANY>
__global__ void __launch_bounds__(WARPS * 32)
grid_mxu_kernel(Tables tb, const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
                const float* __restrict__ bt_in, const int* __restrict__ be_in,
                float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int STRIP = strip_floats<TID>();
  extern __shared__ __align__(16) float ring[];  // two strips
  __shared__ __align__(8) unsigned long long bar[2];
  int lane = threadIdx.x & 31;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (threadIdx.x == 0) init_bulk_barriers(bar);
  __syncthreads();
  // every thread of the block stays to the end: the walk votes block-wide
  Lane l = load_lane<ANY, true>(i, n, ro, rd, tmin_in, tmax_in, bt_in, be_in);
  Walk w = start_walk<ANY, true>(tb, l);

  // a two-stage ring shared by the block's warps: the next taken
  // supercell's strip is in flight while the current one is tested
  bool in_s, in_s_next;
  int cur = next_super<ANY, true>(w, tb, l, in_s), stage = 0;
  unsigned parity = 0;  // bit s: the phase of bar[s] to wait for
  if (cur >= 0 && threadIdx.x == 0)
    bulk_fetch(ring, tb.mxu_w + (size_t)cur * STRIP, STRIP * 4, bar);
  while (cur >= 0) {
    int nxt = next_super<ANY, true>(w, tb, l, in_s_next);
    if (nxt >= 0 && threadIdx.x == 0)
      bulk_fetch(ring + (stage ^ 1) * STRIP, tb.mxu_w + (size_t)nxt * STRIP, STRIP * 4,
                  bar + (stage ^ 1));
    bulk_wait(bar + stage, (parity >> stage) & 1u);
    parity ^= 1u << stage;
    const float* strip = ring + stage * STRIP;
    for (int kc = 0; kc < CELLS; ++kc) {
      int cell = cur * CELLS + kc, p0 = cell * CELL;
      if (p0 >= tb.n_prims) break;
      unsigned mask =
          __ballot_sync(FULL, in_s && live<ANY>(l) && cull<ANY>(tb.cell_boxes + 6 * cell, l));
      if (!mask) continue;
      leaf<ANY, true, GRID_PRIMS_MAX_K>(
          l, mask, p0, min(CELL, tb.n_prims - p0), lane, [&](int j, const RayArg& r) {
            return strip_pair_t<TID>(strip, kc * CELL + j, r.rf, r.tmin, r.lim);
          });
    }
    __syncthreads();  // the stage is read out before it is refilled
    cur = nxt;
    in_s = in_s_next;
    stage ^= 1;
  }
  store_lane<ANY>(l, i, n, bt_in, be_in, bt_out, be_out);
}

using KernelFn = void (*)(Tables, const float*, const float*, const float*, const float*,
                          const float*, const int*, float*, int*, int);

template <int TID, bool MXU>
cudaError_t launch(bool any_hit, const Tables& tb, const float* ro, const float* rd,
                   const float* tmin, const float* tmax, const float* bt_in, const int* be_in,
                   float* bt_out, int* be_out, int n, cudaStream_t stream) {
  dim3 block(WARPS * 32), grid((n + WARPS * 32 - 1) / (WARPS * 32));
  KernelFn k;
  int smem = 0;
  if constexpr (MXU) {
    k = any_hit ? grid_mxu_kernel<TID, true> : grid_mxu_kernel<TID, false>;
    smem = 2 * strip_floats<TID>() * 4;
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  } else {
    k = any_hit ? grid_kernel<TID, true> : grid_kernel<TID, false>;
  }
  k<<<grid, block, smem, stream>>>(tb, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
  return cudaGetLastError();
}

}  // namespace

// C interface.  Returns the launch's error (0 on success); an unknown shape
// type, or rows of another width than the type's, return
// cudaErrorInvalidValue without launching.  mxu_w null: the VPU form; else
// the MXU form on that table, for the types with one (others return
// cudaErrorInvalidValue).  rows and mxu_w start on 16-byte boundaries.
extern "C" int pine_grid_traverse(
    int tid, int any_hit, const float* rows, int width, int n_prims, int n_super,
    int n_coarse, int use_coarse, const float* coarse_boxes, const float* sc_boxes,
    const float* cell_boxes, const int* c_order8, const int* s_order8, const float* ro,
    const float* rd, const float* tmin, const float* tmax, const float* bt_in,
    const int* be_in, float* bt_out, int* be_out, const float* mxu_w, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tables tb{rows, n_prims, n_super, n_coarse, use_coarse, coarse_boxes,
            sc_boxes, cell_boxes, c_order8, s_order8, mxu_w};
  bool a = any_hit != 0;
#define PINE_CASE(T, MXU)                                                                 \
  case T:                                                                                 \
    if (width != prim_width<T>()) return cudaErrorInvalidValue;                           \
    return launch<T, MXU>(a, tb, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s);
  if (mxu_w != nullptr) {
    switch (tid) {
      PINE_CASE(SPHERE, true)
      PINE_CASE(RECT, true)
      PINE_CASE(DISK, true)
      PINE_CASE(PLANE, true)
      PINE_CASE(TRIANGLE, true)
      PINE_CASE(CONE, true)
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (tid) {
    PINE_CASE(SPHERE, false)
    PINE_CASE(RECT, false)
    PINE_CASE(DISK, false)
    PINE_CASE(PLANE, false)
    PINE_CASE(BOX_AABB, false)
    PINE_CASE(BOX_OBB, false)
    PINE_CASE(TRIANGLE, false)
    PINE_CASE(CONE, false)
    PINE_CASE(CYLINDER, false)
    default:
      return cudaErrorInvalidValue;
  }
#undef PINE_CASE
}
