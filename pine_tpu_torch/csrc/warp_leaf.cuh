// The warp-level leaf of the culling traversal kernels: a warp's rays, the
// cells of 32 prims the warp takes, staged in shared memory and tested.
// Shared by the grid kernel (grid_traverse.cu: kernel 5, and the lane and
// leaf parts by its MXU form, 5m), the supercell-tree kernel
// (sctree_traverse.cu: kernel 6) and the instanced kernel
// (inst_traverse.cu: kernel 8, and its MXU form 8m, whose cells are slices
// of the coefficient table), the last two through tree_walk.cuh.
//
// - Lane: one lane's ray and its running state.  Each lane culls its own ray
//   with its own window (closest-hit: its running best; any-hit: tmax); the
//   warp takes a box or a cell when any live lane passes (a ballot).  Every
//   ballot and shuffle needs all 32 lanes, so lanes past the rays, dead
//   lanes and occluded lanes stay in the walk as not live.
// - leaf: a taken cell tested by the lanes in its mask, lanes over prims
//   when at most PRIMS_MAX_K of them reach it (each ray broadcast in turn by
//   shuffles, lane j testing prim j, (t, row) reduced across the warp to the
//   ray's own lane), else lanes over rays (each lane its own ray over the
//   cell's rows).
// - warp_cells: the cells a walk takes, each staged by the warp with
//   cp.async (16-byte chunks, coalesced) into its two-stage ring while the
//   cell before it is tested; rows a multiple of 4 floats wide sit an odd
//   number of 16-byte chunks apart, so that lanes reading different rows as
//   vectors (SharedRow) hit distinct banks.  warp_cells_mxu stages and tests
//   a cell's slice of the coefficient table instead.
// Closest-hit keeps a (t, row) best compared lexicographically, and a row
// replaces the incoming best only on a strict t < best_t; any-hit sets the
// lane's flag at its first hit.
#pragma once

#include "mxu_epilogue.cuh"

namespace pine {

constexpr int SUPER = 128;           // prims per supercell
constexpr int CELL = 32;             // prims per cull cell
constexpr int CELLS = SUPER / CELL;  // cells per supercell
constexpr unsigned FULL = 0xffffffffu;

// The leaf schedule's crossover: a taken cell that k <= GRID_PRIMS_MAX_K
// rays of a warp test runs lanes over prims (k broadcast rays, lane j on
// prim j), a denser one lanes over rays (each lane its own ray over the 32
// rows); every form of kernels 5 and 6.  Set on the card by python -m
// pine_tpu_torch.lab.grid_crossover (H100 80GB HBM3, 700 W): the terrain's
// group, closest-hit and any-hit, on chip_smoke.py phase 2b's terrain rays
// and the kernel lab's coherent, incoherent and local sets of 65,536 rays.
// Of k in 0, 4, ..., 32, the worst excess over the best k of each of the
// eight (query, ray set) pairs is least at k = 16 and 20: 2.3 % and 2.5 %
// (VPU form), 3.6 % and 3.3 % (MXU form); an earlier run, 3.0 % and 2.5 %,
// 4.1 % and 2.9 %.  Always lanes over rays (k = 0) takes 2.9x (VPU) and
// 3.9x (MXU) the time of k = 20 summed over the eight; always lanes over
// prims (k = 32) 11 % and 13 % more on coherent closest-hit rays, and 0.1 %
// and 0.7 % less summed.  The lab builds grid_traverse.cu with other values
// (-DGRID_PRIMS_MAX_K=k) to time them.
#ifndef GRID_PRIMS_MAX_K
#define GRID_PRIMS_MAX_K 20
#endif

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
  // flags as ints: as two bools ptxas kept them in local memory in some forms
  int valid;     // a ray of this launch (any-hit: open and unoccluded on entry)
  int occluded;  // any-hit
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

// Votes over the unit of a walk: the warp (BLOCK false) or the block.
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

// The cells of the supercells a walk takes: the open supercell's next cell
// that a live lane's cull passes, else the walk's next supercell
// (next_super(in_s) -> its index, or -1 at the end of the walk; in_s: this
// lane passed its cull).  Returns the cell, or -1; mask: its lanes whose
// rays passed every cull above it and its own.
struct Cells {
  int si, kc;  // the open supercell (-1: none), its next cell
  bool in_s;
};

template <bool ANY, class NextSuper>
__device__ int next_cell(Cells& cs, const float* cell_boxes, int n_prims,
                                         const Lane& l, unsigned& mask, NextSuper&& next_super) {
  for (;;) {
    for (; cs.si >= 0 && cs.kc < CELLS; ++cs.kc) {
      int cell = cs.si * CELLS + cs.kc;
      if (cell * CELL >= n_prims) break;
      mask = __ballot_sync(FULL, cs.in_s && live<ANY>(l) && cull<ANY>(cell_boxes + 6 * cell, l));
      if (mask) {
        ++cs.kc;
        return cell;
      }
    }
    cs.si = next_super(cs.in_s);
    cs.kc = 0;
    if (cs.si < 0) return -1;
  }
}

// The warp's leaf loop: each cell that next(mask) yields (-1: the end) is
// staged into the warp's two-stage ring (2 * FLOATS floats, 16-byte
// aligned) by stage_fn(dst, cell, cnt) while the cell before it is tested, then
// tested by the lanes of its mask still live, test(staged, j, ray) being its
// prim j; hit ids are id_base + row.  The walk that yields a cell culls it
// with windows one cell behind, which can only take more cells, never fewer.
template <bool ANY, bool MXU, int FLOATS, class Next, class Stage, class Test>
__device__ __forceinline__ void staged_cells(float* ring, int n_prims, Lane& l, int lane,
                                             int id_base, Next&& next, const Stage& stage_fn,
                                             const Test& test) {
  unsigned m_cur, m_next;
  int cur = next(m_cur), stage = 0;
  if (cur >= 0) stage_fn(ring, cur, min(CELL, n_prims - cur * CELL));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  while (cur >= 0) {
    int nxt = next(m_next);
    if (nxt >= 0) stage_fn(ring + (stage ^ 1) * FLOATS, nxt, min(CELL, n_prims - nxt * CELL));
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const float* st = ring + stage * FLOATS;
    int p0 = cur * CELL;
    unsigned mask = m_cur & __ballot_sync(FULL, live<ANY>(l));  // any-hit: drop rays occluded since
    leaf<ANY, MXU, GRID_PRIMS_MAX_K>(l, mask, id_base + p0, min(CELL, n_prims - p0), lane,
                                     [&](int j, const RayArg& r) { return test(st, j, r); });
    cur = nxt;
    m_cur = m_next;
    stage ^= 1;
  }
}

// staged_cells over the prim rows of type TID (kernels 5, 6 and 8): a cell
// is its rows (CellLayout<W>), each tested by prim_test_row.
template <int TID, bool ANY, class Next>
__device__ __forceinline__ void warp_cells(float* ring, const float* rows, int n_prims, Lane& l,
                                           int lane, Next&& next, int id_base = 0) {
  constexpr int W = prim_width<TID>();
  using L = CellLayout<W>;
  staged_cells<ANY, false, L::FLOATS>(
      ring, n_prims, l, lane, id_base, next,
      [&](float* dst, int cell, int cnt) { stage_cell<W>(dst, rows, cell, cnt, lane); },
      [&](const float* st, int j, const RayArg& r) {
        return prim_test_row<TID>(SharedRow<W>(st + j * L::STRIDE), r.o, r.d, r.tmin, r.lim);
      });
}

// A 32-prim cell's slice of a supercell-major coefficient table (kernel 8m):
// for each feature f and pair value v the cell's 32 coefficients, at
// (f * M + v) * CELL + j.
template <int TID>
struct SliceLayout {
  static constexpr int M = mxu_m<TID>();
  static constexpr int FLOATS = RAY_FEATS * M * CELL;
};

// staged_cells over the supercell-major coefficient table w of a group of
// type TID (accel/mxu_tables.build_mesh_tables: (n_super * 8, M * 128), row
// 8 * s + f, column v * 128 + e): a cell is its slice (SliceLayout), copied
// in 16-byte chunks of its 8 * M runs of 32 coefficients, and prim j is
// tested by the 5m leaf's pair values and epilogue (mxu_epilogue.cuh).
template <int TID, bool ANY, class Next>
__device__ __forceinline__ void warp_cells_mxu(float* ring, const float* w, int n_prims, Lane& l,
                                               int lane, Next&& next, int id_base) {
  constexpr int M = mxu_m<TID>();
  staged_cells<ANY, true, SliceLayout<TID>::FLOATS>(
      ring, n_prims, l, lane, id_base, next,
      [&](float* dst, int cell, int) {
        const float* strip =
            w + (size_t)(cell / CELLS) * RAY_FEATS * M * SUPER + (cell % CELLS) * CELL;
        for (int q = lane; q < RAY_FEATS * M * (CELL / 4); q += 32) {
          int fv = q / (CELL / 4), part = q % (CELL / 4);
          cp_async16(dst + fv * CELL + 4 * part, strip + fv * SUPER + 4 * part, 16);
        }
      },
      [&](const float* st, int j, const RayArg& r) {
        float val[M];
        pair_values<M>(r.rf, st + j, M * CELL, CELL, val);
        return mxu_pair_t<TID>(val, r.rf, r.tmin, r.lim);
      });
}

}  // namespace pine
