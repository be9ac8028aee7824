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
// Design: the warp is the unit of the walk.
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
//   reading different rows as vectors hit distinct banks (SharedRow,
//   prim_tests.cuh).
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
// ptxas -v (sm_90a): the triangle forms take 64 / 56 registers (closest /
// any-hit) with 12,288 B of static shared memory (four warps' two-stage
// rings of 1,536 B), the MXU triangle forms 56 / 56 with 49,152 B of
// dynamic shared memory (two 24,576-B strips) and 16 B of barriers; every
// instantiation 46-72 registers, no spills.

#include "mxu_epilogue.cuh"

namespace {

using namespace pine;

constexpr int SUPER = 128;            // prims per supercell
constexpr int CELL = 32;              // prims per cull cell
constexpr int CELLS = SUPER / CELL;   // cells per supercell
constexpr int COARSE = 16;            // supercells per coarse box
constexpr int WARPS = 4;              // warps per block
constexpr unsigned FULL = 0xffffffffu;

// The leaf schedule's crossover: a taken cell that k <= GRID_PRIMS_MAX_K
// rays of a warp test runs lanes over prims (k broadcast rays, lane j on
// prim j), a denser one lanes over rays (each lane its own ray over the 32
// rows); both forms.  Set on the card by python -m
// pine_tpu_torch.lab.grid_crossover (H100 80GB HBM3, 700 W): the terrain's
// group, closest-hit and any-hit, on chip_smoke.py phase 2b's terrain rays
// and the kernel lab's coherent, incoherent and local sets of 65,536 rays.
// Of k in 0, 4, ..., 32, the worst excess over the best k of each of the
// eight (query, ray set) pairs is least at k = 16 and 20: 2.3 % and 2.5 %
// (VPU form), 3.6 % and 3.3 % (MXU form); an earlier run, 3.0 % and 2.5 %,
// 4.1 % and 2.9 %.  Always lanes over rays (k = 0) takes 2.9x (VPU) and
// 3.9x (MXU) the time of k = 20 summed over the eight; always lanes over
// prims (k = 32) 11 % and 13 % more on coherent closest-hit rays, and 0.1 %
// and 0.7 % less summed.  The lab builds this file with other values
// (-DGRID_PRIMS_MAX_K=k) to time them.
#ifndef GRID_PRIMS_MAX_K
#define GRID_PRIMS_MAX_K 20
#endif

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

// What a prim test reads of a ray; broadcast whole in the lanes-over-prims
// schedule.
struct RayArg {
  V3 o, d;
  float tmin, lim;  // the prim tests' window: tmax (any-hit) or the incoming best
  RayFeat rf;       // MXU form: the feature row
};

// One lane's ray and its running state.
struct Lane {
  RayArg r;
  V3 inv;
  float cur_t;    // closest-hit: the running best (t, row); row -1 = not improved
  int cur_e;
  bool valid;     // a ray of this launch (any-hit: open and unoccluded on entry)
  bool occluded;  // any-hit
};

template <bool ANY>
__device__ __forceinline__ bool live(const Lane& l) { return l.valid && !(ANY && l.occluded); }

// The culls' window: tmax (any-hit) or the running best (closest-hit).
template <bool ANY>
__device__ __forceinline__ float window(const Lane& l) { return ANY ? l.r.lim : l.cur_t; }

template <bool ANY>
__device__ __forceinline__ bool cull(const float* box, const Lane& l) {
  return slab_hit(box, l.r.o, l.inv, l.r.tmin, window<ANY>(l));
}

// Votes over the unit of the walk: the warp (BLOCK false) or the block.
template <bool BLOCK>
__device__ __forceinline__ bool any_of(bool p) {
  if constexpr (BLOCK) return __syncthreads_or(p) != 0;
  else return __ballot_sync(FULL, p) != 0;
}
template <bool BLOCK>
__device__ __forceinline__ int count_of(bool p) {
  if constexpr (BLOCK) return __syncthreads_count(p);
  else return __popc(__ballot_sync(FULL, p));
}

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

// A broadcast of lane b's ray to the warp.
template <bool MXU>
__device__ __forceinline__ RayArg shfl_ray(const RayArg& r, int b) {
  RayArg s;
  s.o = {__shfl_sync(FULL, r.o.x, b), __shfl_sync(FULL, r.o.y, b), __shfl_sync(FULL, r.o.z, b)};
  s.d = {__shfl_sync(FULL, r.d.x, b), __shfl_sync(FULL, r.d.y, b), __shfl_sync(FULL, r.d.z, b)};
  s.tmin = __shfl_sync(FULL, r.tmin, b);
  s.lim = __shfl_sync(FULL, r.lim, b);
  if constexpr (MXU) {
    s.rf.f[0] = s.d.x; s.rf.f[1] = s.d.y; s.rf.f[2] = s.d.z;
    s.rf.f[3] = s.o.x; s.rf.f[4] = s.o.y; s.rf.f[5] = s.o.z;
    s.rf.f[6] = 1.0f; s.rf.f[7] = 0.0f;
    s.rf.odr = __shfl_sync(FULL, r.rf.odr, b);
    s.rf.oor = __shfl_sync(FULL, r.rf.oor, b);
    s.rf.ddr = __shfl_sync(FULL, r.rf.ddr, b);
  }
  return s;
}

// Closest-hit: (t, e) replaces the running best when it is lower
// lexicographically; with row -1 for "not improved" a t equal to the
// incoming best never replaces it.
__device__ __forceinline__ void take(Lane& l, float t, int e) {
  if (t < l.cur_t || (t == l.cur_t && e < l.cur_e)) {
    l.cur_t = t;
    l.cur_e = e;
  }
}

// One taken cell of cnt prims from row p0: the rays of the lanes in mask
// against test(j, ray), prim j of the cell.
template <bool ANY, bool MXU, int PRIMS_MAX_K, class Test>
__device__ __forceinline__ void leaf(Lane& l, unsigned mask, int p0, int cnt, int lane,
                                     const Test& test) {
  if (__popc(mask) <= PRIMS_MAX_K) {
    // lanes over prims: the k rays in turn, lane j testing prim j, the
    // result reduced across the warp to the ray's own lane
    while (mask) {
      int b = __ffs(mask) - 1;
      mask &= mask - 1;
      RayArg r = shfl_ray<MXU>(l.r, b);
      float t = lane < cnt ? test(lane, r) : __int_as_float(0x7f800000);  // +inf: untested
      if constexpr (ANY) {
        if (__any_sync(FULL, t < BIG) && lane == b) l.occluded = true;
      } else {
        int e = p0 + lane;
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          float t2 = __shfl_xor_sync(FULL, t, off);
          int e2 = __shfl_xor_sync(FULL, e, off);
          if (t2 < t || (t2 == t && e2 < e)) {
            t = t2;
            e = e2;
          }
        }
        if (lane == b) take(l, t, e);
      }
    }
  } else if ((mask >> lane) & 1u) {
    // lanes over rays: each lane its own ray over the cell's rows
    for (int j = 0; j < cnt; ++j) {
      float t = test(j, l.r);
      if constexpr (ANY) {
        if (t < BIG) {
          l.occluded = true;
          break;
        }
      } else {
        take(l, t, p0 + j);
      }
    }
  }
  __syncwarp();
}

template <bool ANY, bool MXU>
__device__ __forceinline__ Lane load_lane(int i, int n, const float* __restrict__ ro,
                                          const float* __restrict__ rd,
                                          const float* __restrict__ tmin_in,
                                          const float* __restrict__ tmax_in,
                                          const float* __restrict__ bt_in,
                                          const int* __restrict__ be_in) {
  Lane l{};
  l.cur_e = -1;
  if (i >= n) return l;
  float bt = bt_in[i];
  l.r.tmin = tmin_in[i];
  l.r.lim = ANY ? tmax_in[i] : bt;
  l.cur_t = bt;
  l.valid = !(ANY && (be_in[i] != 0 || !(l.r.lim > l.r.tmin)));
  l.r.o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  l.r.d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  l.inv = {safe_inv(l.r.d.x), safe_inv(l.r.d.y), safe_inv(l.r.d.z)};
  if constexpr (MXU) l.r.rf = ray_features(l.r.o, l.r.d);
  return l;
}

template <bool ANY>
__device__ __forceinline__ void store_lane(const Lane& l, int i, int n,
                                           const float* __restrict__ bt_in,
                                           const int* __restrict__ be_in,
                                           float* __restrict__ bt_out, int* __restrict__ be_out) {
  if (i >= n) return;
  if (ANY) {
    bt_out[i] = bt_in[i];
    be_out[i] = l.occluded ? 1 : be_in[i];
  } else {
    bt_out[i] = l.cur_e >= 0 ? l.cur_t : bt_in[i];
    be_out[i] = l.cur_e >= 0 ? l.cur_e : be_in[i];
  }
}

// --------------------------------------------------------------------------
// kernel 5: cell rows staged per warp by cp.async
// --------------------------------------------------------------------------

// Shared-memory layout of a staged cell: rows whose width is a multiple of 4
// floats sit an odd number of 16-byte chunks apart, so that the eight lanes
// of a quarter-warp reading eight rows as vectors hit distinct banks; other
// widths sit as in global memory (an odd width: 32 rows on 32 banks).
template <int W>
struct CellLayout {
  static constexpr bool PADDED = W % 4 == 0;
  static constexpr int Q = (W + 3) / 4;  // 16-byte chunks of a row, when PADDED
  static constexpr int STRIDE = PADDED ? 4 * (Q | 1) : W;
  static constexpr int FLOATS = CELL * STRIDE;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// The warp copies the cnt rows of a cell (contiguous in global memory) into
// dst in 16-byte chunks, coalesced; the last chunk of a partial cell is
// zero-filled past its rows.
template <int W>
__device__ __forceinline__ void stage_cell(float* dst, const float* rows, int cell, int cnt,
                                           int lane) {
  using L = CellLayout<W>;
  const float* src = rows + (size_t)cell * CELL * W;
  int bytes = cnt * W * 4;
  for (int q = lane; 16 * q < bytes; q += 32) {
    int at = L::PADDED ? (q / L::Q) * L::STRIDE + (q % L::Q) * 4 : 4 * q;
    cp_async16(dst + at, src + 4 * q, min(16, bytes - 16 * q));
  }
}

// The next cell the warp takes below the walk, or -1; mask: its lanes whose
// rays passed the coarse, supercell and cell culls.
struct Cells {
  int si, kc;  // the open supercell (-1: none), its next cell
  bool in_s;
};

template <bool ANY>
__device__ int next_cell(Walk& w, Cells& cs, const Tables& tb, const Lane& l, unsigned& mask) {
  for (;;) {
    for (; cs.si >= 0 && cs.kc < CELLS; ++cs.kc) {
      int cell = cs.si * CELLS + cs.kc;
      if (cell * CELL >= tb.n_prims) break;
      mask = __ballot_sync(FULL, cs.in_s && live<ANY>(l) && cull<ANY>(tb.cell_boxes + 6 * cell, l));
      if (mask) {
        ++cs.kc;
        return cell;
      }
    }
    cs.si = next_super<ANY, false>(w, tb, l, cs.in_s);
    cs.kc = 0;
    if (cs.si < 0) return -1;
  }
}

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

  // a two-stage ring: the next taken cell's rows are in flight while the
  // current cell is tested
  unsigned m_cur, m_next;
  int cur = next_cell<ANY>(w, cs, tb, l, m_cur), stage = 0;
  if (cur >= 0)
    stage_cell<W>(ring[warp][0], tb.rows, cur, min(CELL, tb.n_prims - cur * CELL), lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  while (cur >= 0) {
    int nxt = next_cell<ANY>(w, cs, tb, l, m_next);
    if (nxt >= 0)
      stage_cell<W>(ring[warp][stage ^ 1], tb.rows, nxt, min(CELL, tb.n_prims - nxt * CELL), lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const float* st = ring[warp][stage];
    int p0 = cur * CELL;
    unsigned mask = m_cur & __ballot_sync(FULL, live<ANY>(l));  // any-hit: drop rays occluded since
    leaf<ANY, false, GRID_PRIMS_MAX_K>(
        l, mask, p0, min(CELL, tb.n_prims - p0), lane, [&](int j, const RayArg& r) {
          return prim_test_row<TID>(SharedRow<W>(st + j * L::STRIDE), r.o, r.d, r.tmin, r.lim);
        });
    cur = nxt;
    m_cur = m_next;
    stage ^= 1;
  }
  store_lane<ANY>(l, i, n, bt_in, be_in, bt_out, be_out);
}

// --------------------------------------------------------------------------
// kernel 5m: supercell strips staged per block by cp.async.bulk
// --------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Thread 0 asks the bulk copy engine for one strip; the barrier's phase
// completes when its bytes have landed.
__device__ __forceinline__ void fetch_strip(float* dst, const float* src, unsigned bytes,
                                            unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wait_strip(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

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
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
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
    fetch_strip(ring, tb.mxu_w + (size_t)cur * STRIP, STRIP * 4, bar);
  while (cur >= 0) {
    int nxt = next_super<ANY, true>(w, tb, l, in_s_next);
    if (nxt >= 0 && threadIdx.x == 0)
      fetch_strip(ring + (stage ^ 1) * STRIP, tb.mxu_w + (size_t)nxt * STRIP, STRIP * 4,
                  bar + (stage ^ 1));
    wait_strip(bar + stage, (parity >> stage) & 1u);
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
