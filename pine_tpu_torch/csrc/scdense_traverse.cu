// Supercell-culled dense ray-group traversal for Hopper (sm_90a): the
// traversal of a group that CompiledScene.small_kernel (or mesh_kernel) sets
// to "scdense".
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_scdense_kernel (reached
// through _compiled_scdense_call), the Pallas TPU kernel that sweeps a
// group's rows in order for an (8,128) ray block with every prim broadcast
// from SMEM, skipping a 128-prim supercell, then a 16-prim cell, when no lane
// of the block reaches its box within its window.  Its contract is
// pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out; a prim replaces the running best
//     only on a strict t < best_t, so ties keep the lowest row; best_e is the
//     group-local row;
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//     a lane with tmax <= tmin never becomes occluded;
//   lanes that reach no cell pass their state through bit for bit.
//
// What bounds it: arithmetic.  A ray runs a slab test per supercell, one per
// cell of each supercell it reaches, and the prim tests of the cells it
// reaches; it reads 40 bytes of ray state and writes 8.  The rows and boxes
// are a few to a few hundred kilobytes shared by all rays.  One thread per
// ray reading every box and row by scalar loads from the read-only cache
// ran the benchmark box's main-path launches at 19x / 12x that bound (H100
// 80GB HBM3, 700 W): lanes that reach no supercell held their warp slots
// through the sweep, each box was six loads and each row one per column,
// and every quadric pair paid its square root and divisions though most of
// them miss.
//
// Design (the dense kernel's, csrc/dense_traverse.cu, with the culls):
// - Each lane finds the first supercell its incoming window reaches.  A
//   lane that reaches none does nothing in the sweep (windows only shrink),
//   and writes its state straight back.  The block then compacts the rest:
//   each warp appends its live rays to a queue in shared memory (a ballot
//   and one atomic), and thread j of the block sweeps queue entry j from
//   that first supercell, so the live rays run in full warps.
// - The group's rows, padded to a multiple of 4 floats at upload
//   (accel/dense_traverse.dense_rows), and the boxes of the supercells and
//   cells they fall in are staged once per block into shared memory by
//   cp.async while the block finds its live lanes, TILE rows (four
//   supercells) at a time: a group of more than TILE rows in tiles, the
//   block meeting at each tile's barrier.  Every lane of a warp reads the
//   same box and row at the same step, so each read is a broadcast: a box
//   two 16-byte vectors (padded to 8 floats in shared memory), a row W / 4.
// - The tests take the exact early misses of prim_tests.cuh (EARLY).
// Per ray the culls are those of a loop over the supercells and their eight
// cells in row order, each against the running best (closest-hit: window
// (tmin, running best); any-hit: (tmin, tmax), until the first hit), and a
// cell's sixteen rows are tested in row order, so the result is that of the
// dense sweep, and the plain version, accel/scdense_traverse.scdense_plain,
// makes the same culls in the same order with the same arithmetic and
// agrees with it on every lane, bit for bit.  Rows at or past the group's
// prim count (the pad rows of a SAH-ordered group's table) are never
// tested.  Built without fast math and with -fmad=false, the arithmetic
// rounds as the plain version's does.

#include "prim_tests.cuh"

namespace {

using namespace pine;

// Rays per block.  Measured on the benchmark box's three groups (the kernel
// lab's three ray sets of 409,600 and the main path's first bounce, H100
// 80GB HBM3, 700 W; PERF.md, Findings): 128 rays 2-3 % slower than 256.
constexpr int BLOCK = 256;
constexpr int SUPER = 128;                  // prims per supercell
constexpr int SCD_CELL = 16;                // prims per cull cell
constexpr int CELLS = SUPER / SCD_CELL;     // cells per supercell
constexpr int TILE = 512;                   // rows staged at once
constexpr int TILE_SUPER = TILE / SUPER;    // supercells staged at once
constexpr int BOX = 8;                      // floats of a staged box: lo xyz, hi xyz, 2 pad
constexpr unsigned FULL = 0xffffffffu;

// One 4-byte asynchronous copy (cp.async) from global into shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The block copies the tile of supercells s0 .. s0 + ns - 1: their rows
// (cnt padded rows of WP floats, 16 bytes a thread at a time) into srows,
// their boxes and then their cells' boxes into 8-float slots of sbox.
template <int WP>
__device__ __forceinline__ void stage_tile(float* srows, float* sbox, const float* rows,
                                           const float* sc_boxes, const float* cell_boxes,
                                           int s0, int ns, int cnt) {
  const float* src = rows + (size_t)s0 * SUPER * WP;
  for (int q = threadIdx.x; q < cnt * (WP / 4); q += BLOCK)
    cp_async16(srows + 4 * q, src + 4 * q, 16);
  for (int q = threadIdx.x; q < ns * (1 + CELLS) * 6; q += BLOCK) {
    int b = q / 6, c = q - 6 * b;  // box b of the tile: its supercells, then their cells
    const float* from = b < ns ? sc_boxes + 6 * (s0 + b) : cell_boxes + 6 * (s0 * CELLS + b - ns);
    cp_async4(sbox + BOX * (b < ns ? b : TILE_SUPER + b - ns) + c, from + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// slab_hit on a box staged in shared memory, read as two 16-byte vectors.
__device__ __forceinline__ bool box_hit(const float* box, V3 o, V3 inv, float tmin, float lim) {
  float4 a = reinterpret_cast<const float4*>(box)[0];
  float4 b = reinterpret_cast<const float4*>(box)[1];
  return slab_hit_v(a.x, a.y, a.z, a.w, b.x, b.y, o, inv, tmin, lim);
}

template <int TID, bool ANY>
__global__ void __launch_bounds__(BLOCK)
scdense_kernel(const float* __restrict__ rows, int n_prims, int n_super,
               const float* __restrict__ sc_boxes, const float* __restrict__ cell_boxes,
               const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
               const float* __restrict__ bt_in, const int* __restrict__ be_in,
               float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int WP = padded_width<TID>();
  extern __shared__ __align__(16) float srows[];  // min(n_prims, TILE) rows of WP floats
  __shared__ __align__(16) float sbox[TILE_SUPER * (1 + CELLS) * BOX];
  __shared__ int queue[BLOCK];  // the block's live rays
  __shared__ int first[BLOCK];  // and the first supercell each reaches
  __shared__ int n_live;
  // the first tile, in flight while the block finds its live lanes
  stage_tile<WP>(srows, sbox, rows, sc_boxes, cell_boxes, 0, min(n_super, TILE_SUPER),
                 min(n_prims, TILE));
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();

  // The first supercell each lane's incoming window reaches (any-hit: an
  // occluded lane, or one with tmax <= tmin, reaches none).
  int lane = threadIdx.x & 31;
  int i = blockIdx.x * BLOCK + threadIdx.x;
  int f = n_super;
  if (i < n) {
    float tmin = tmin_in[i], bt = bt_in[i];
    int be = be_in[i];
    float lim = ANY ? tmax_in[i] : bt;
    if (!ANY || (be == 0 && lim > tmin)) {
      V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
      V3 inv = {safe_inv(rd[3 * i]), safe_inv(rd[3 * i + 1]), safe_inv(rd[3 * i + 2])};
      for (int si = 0; si < n_super; ++si)
        if (slab_hit(sc_boxes + 6 * si, o, inv, tmin, lim)) {
          f = si;
          break;
        }
    }
    if (f == n_super) {
      bt_out[i] = bt;
      be_out[i] = be;
    }
  }
  bool live = f < n_super;
  unsigned m = __ballot_sync(FULL, live);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(&n_live, __popc(m));
  base = __shfl_sync(FULL, base, 0);
  if (live) {
    int slot = base + __popc(m & ((1u << lane) - 1u));
    queue[slot] = i;
    first[slot] = f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The sweep: thread j of the block takes the j-th live ray.
  bool active = threadIdx.x < n_live;
  V3 o{}, d{}, inv{};
  float tmin = 0.0f, tmax = 0.0f, bt = 0.0f;
  int be = 0;
  if (active) {
    i = queue[threadIdx.x];
    f = first[threadIdx.x];
    o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
    d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
    inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
    tmin = tmin_in[i];
    bt = bt_in[i];
    be = be_in[i];  // any-hit: 0, or the lane would not be live
    if (ANY) tmax = tmax_in[i];
  }
  for (int s0 = 0; s0 < n_super; s0 += TILE_SUPER) {
    int ns = min(TILE_SUPER, n_super - s0);
    int p0 = s0 * SUPER;
    if (s0 > 0) {  // a group of more than TILE rows: its next tile
      __syncthreads();
      stage_tile<WP>(srows, sbox, rows, sc_boxes, cell_boxes, s0, ns, min(TILE, n_prims - p0));
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    if (!active || (ANY && be)) continue;
    for (int k = 0; k < ns; ++k) {
      // supercells before the lane's first: their culls fail, as the lane found
      if (s0 + k < f || !box_hit(sbox + BOX * k, o, inv, tmin, ANY ? tmax : bt)) continue;
      for (int kc = 0; kc < CELLS; ++kc) {
        int c0 = p0 + (k * CELLS + kc) * SCD_CELL;
        if (c0 >= n_prims) break;
        if (!box_hit(sbox + BOX * (TILE_SUPER + k * CELLS + kc), o, inv, tmin, ANY ? tmax : bt))
          continue;
        int c1 = min(c0 + SCD_CELL, n_prims);
        for (int e = c0; e < c1; ++e) {
          SharedRow<WP> row(srows + (e - p0) * WP);
          if (ANY) {
            if (prim_test_row<TID, true>(row, o, d, tmin, tmax) < BIG) {
              be = 1;
              goto next_tile;
            }
          } else {
            float tt = prim_test_row<TID, true>(row, o, d, tmin, bt);
            if (tt < bt) {
              bt = tt;
              be = e;
            }
          }
        }
      }
    }
  next_tile:;
  }
  if (active) {
    bt_out[i] = bt;
    be_out[i] = be;
  }
}

template <int TID>
cudaError_t launch(bool any_hit, const float* rows, int width, int n_prims, int n_super,
                   const float* sc_boxes, const float* cell_boxes, const float* ro,
                   const float* rd, const float* tmin, const float* tmax, const float* bt_in,
                   const int* be_in, float* bt_out, int* be_out, int n, cudaStream_t stream) {
  if (width != padded_width<TID>()) return cudaErrorInvalidValue;
  auto k = any_hit ? scdense_kernel<TID, true> : scdense_kernel<TID, false>;
  int smem = min(n_prims, TILE) * padded_width<TID>() * 4;
  if (smem > 32 * 1024) {  // more than the default 48 KB leaves beside the queue and boxes
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k<<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(rows, n_prims, n_super, sc_boxes,
                                                      cell_boxes, ro, rd, tmin, tmax, bt_in,
                                                      be_in, bt_out, be_out, n);
  return cudaGetLastError();
}

}  // namespace

// C interface.  Returns the launch's error (0 on success); an unknown shape
// type, or rows of another width than the type's padded width (a multiple of
// 4 floats), return cudaErrorInvalidValue without launching.  rows start on
// a 16-byte boundary.
extern "C" int pine_scdense_traverse(
    int tid, int any_hit, const float* rows, int width, int n_prims, int n_super,
    const float* sc_boxes, const float* cell_boxes, const float* ro, const float* rd,
    const float* tmin, const float* tmax, const float* bt_in, const int* be_in, float* bt_out,
    int* be_out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                                      \
  case T:                                                                                 \
    return launch<T>(a, rows, width, n_prims, n_super, sc_boxes, cell_boxes, ro, rd, tmin, \
                     tmax, bt_in, be_in, bt_out, be_out, n, s);
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
