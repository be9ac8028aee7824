// The fused coefficient-table sweep of one prim group for Hopper (sm_90a):
// the "mxup" route of groups of up to 8,192 prims of a type with a table
// (sphere, rect, disk, plane, triangle, cone).
//
// Replaces pine_tpu/accel/mxu_sweep.py::_make_fused_kernel (reached through
// _compiled_fused_call, TPU kernel 7), the Pallas TPU kernel that, per 1,024
// rays, loops the group's 128-prim tiles, forms each tile's pair values as
// one (1024, 8) x (8, m*128) MXU matmul of the rays' feature rows
// [d, o, 1, 0] with the tile's coefficient strip, runs the epilogue and
// keeps a running best per lane, then reduces it.  Its contract is
// pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out, best_e the group-local row; the
//     lowest t wins, ties go to the lowest row, and the group's best
//     replaces the incoming one only on a strict t < best_t (a lane that no
//     prim improves, with an incoming best above BIG, gets BIG and row
//     2^30, as on the TPU);
//   any-hit: best_e out = max(best_e in, occluded), best_t passes through;
//   a lane with limit <= tmin (closest: limit = best_t; any-hit: tmax)
//   passes through bit for bit.
//
// What bounds it on this card: FP32 operations, issued unfused.  A pair
// costs 13 operations per value (six products and seven sums, in the fixed
// order of csrc/mxu_epilogue.cuh) and 1 to 24 for the epilogue, with
// IEEE divisions and square roots; -fmad=false keeps each product and sum
// rounded apart, so the card issues them at half its FMA rate.  A ray reads
// 40 bytes and writes 8; the table (32 * m bytes per prim, 68 KB for the
// bench box's 424-row cone group) is read once per block.  The kernel that
// came before it (eight scalar shared loads per pair value, each tile's
// whole strip staged by the threads between two barriers, nothing in flight
// while it was tested) ran at 7-10x its bound; vector loads and the ring
// alone took 0.79-0.98 of its time on the cone group, the early miss below
// 0.60-0.71 (python -m pine_tpu_torch.lab.redesign_ab PARENT mxup).
//
// Design:
// - One ray per thread, 128 threads a block, each with its feature row,
//   (t, row) best and any-hit flag in registers.  Two and four rays per
//   thread, each coefficient read then serving as many rays, were built
//   (-D variants of this kernel) and timed in two calls on the card (H100
//   80GB HBM3, 700 W) on the bench box's rect group (6 prims) and cone
//   group (424 rows), 409,600 rays of the kernel lab's coherent, incoherent
//   and local sets, closest-hit and any-hit.  Summed over those twelve
//   pairs, as a render spends it (64 / 48 launches of each group), two rays
//   took 1.2 % and 0.57 % more than one, four 16 % and 15 %.  On the cone
//   group two won only the coherent closest-hit rays (0.616 ms against
//   0.693).  One ray lost by up to 72 % on a single rect pair (coherent
//   any-hit, 0.042 ms against four rays' 0.024), but the rect times sit at
//   the launch floor, the same build's time for that pair moved from 0.028
//   to 0.042 ms between the calls, and the rect group is 4 % of the sum.
//   With the coefficients read as vectors the loads no longer bound the
//   kernel, and more rays per thread only cut the blocks (four: 800 blocks,
//   1.2 waves).
// - A prim-major copy of the tile-major table (accel/mxu_tables.
//   prim_major, a permutation of its bytes): the eight coefficients of one
//   (prim, value) pair are two 16-byte shared loads.
// - A two-stage ring of tiles, each filled by one bulk asynchronous copy
//   (cp.async.bulk completing on an mbarrier, the 1-D form of the TMA) of the
//   tile's first `width` prims only (the rect group's 6, the last cone tile's
//   40): the next tile is in flight while this one is tested.
// - Any-hit leaves the tile loop once no thread holds a live, unoccluded ray.
// - A cone or sphere pair whose discriminant is not positive skips its
//   square root and divisions (mxu_pair_t's EARLY): it misses either way.
// - Each pair value is ((((((f0*w0 + f1*w1) + f2*w2) + f3*w3) + f4*w4) +
//   f5*w5) + w6) + 0: the plain version's ordered sum with 1*w6, which is w6
//   exactly, and with 0*w7, which is +0 exactly (row 7 of every table is
//   zero), so the result is mxup_plain's bit for bit.
// No tensor cores: mma.sync in TF32, even with the exact three-way split of
// the inputs, sums in another order than the ordered FP32 sums, and the
// gate against mxup_plain is bit for bit (the three-way split is the lead
// for the grid kernel's MXU form, whose gate is 1e-4 of lanes).  Templated
// on the prim type and any-hit.
//
// ptxas -v (sm_90a): the cone forms take 46 / 52 registers (closest /
// any-hit), the triangle forms 41 / 50, every instantiation 30-52; 16 B of
// static shared memory (the two barriers) and two tiles of 128 * m * 32 B
// of dynamic shared memory (40,960 B for the cone, 49,152 B for m = 6); no
// spills.

#include "mxu_epilogue.cuh"

namespace {

using namespace pine;

constexpr int TILE = 128;     // prims per tile
constexpr int THREADS = 128;  // threads per block
constexpr int INT_BIG = 1 << 30;

template <int TID>
__host__ __device__ constexpr int tile_floats() { return TILE * mxu_m<TID>() * RAY_FEATS; }

// The ordered sum of one pair value from the prim's two 16-byte coefficient
// vectors (features 0-3, 4-7).
__device__ __forceinline__ float ordered_value(const RayFeat& r, float4 a, float4 b) {
  float s = r.f[0] * a.x;
  s = s + r.f[1] * a.y;
  s = s + r.f[2] * a.z;
  s = s + r.f[3] * a.w;
  s = s + r.f[4] * b.x;
  s = s + r.f[5] * b.y;
  s = s + b.z;      // 1 * w6
  return s + 0.0f;  // 0 * w7: row 7 is zero
}

template <int TID, bool ANY>
__global__ void __launch_bounds__(THREADS)
mxu_sweep_kernel(const float* __restrict__ Wp, int C, int n_tiles,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
                 const float* __restrict__ bt_in, const int* __restrict__ be_in,
                 float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int M = mxu_m<TID>();
  constexpr int TF = tile_floats<TID>();
  extern __shared__ __align__(16) float ring[];  // two tiles
  __shared__ __align__(8) unsigned long long bar[2];

  int i = blockIdx.x * THREADS + threadIdx.x;
  bool valid = i < n;
  float bt = valid ? bt_in[i] : 0.0f;
  int be = valid ? be_in[i] : 0;
  float tmin = valid ? tmin_in[i] : 0.0f;
  float limit = ANY ? (valid ? tmax_in[i] : 0.0f) : bt;
  // an occluded any-hit lane keeps its flag (max(flag, 0 or 1) = flag)
  bool live = valid && limit > tmin && !(ANY && be >= 1);
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  if (live) {
    o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
    d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  }
  RayFeat rf = ray_features(o, d);
  float bt_run = BIG;
  int be_run = INT_BIG;
  bool hit = false;
  if (__syncthreads_or(live)) {
    if (threadIdx.x == 0) {
      init_bulk_barriers(bar);
      bulk_fetch(ring, Wp, min(TILE, C) * M * RAY_FEATS * 4, bar);
    }
    __syncthreads();
    unsigned parity = 0;  // bit s: the phase of bar[s] to wait for
    int stage = 0;
    for (int ct = 0; ct < n_tiles; ++ct) {
      bool more = ct + 1 < n_tiles;
      if (more && threadIdx.x == 0)  // its stage was read out before the last barrier
        bulk_fetch(ring + (stage ^ 1) * TF, Wp + (size_t)(ct + 1) * TF,
                   min(TILE, C - (ct + 1) * TILE) * M * RAY_FEATS * 4, bar + (stage ^ 1));
      bulk_wait(bar + stage, (parity >> stage) & 1u);
      parity ^= 1u << stage;
      const float4* tile = reinterpret_cast<const float4*>(ring + stage * TF);
      int width = min(TILE, C - ct * TILE);
      for (int c = 0; c < width && live && !hit; ++c) {
        float val[M];
#pragma unroll
        for (int v = 0; v < M; ++v)
          val[v] = ordered_value(rf, tile[(c * M + v) * 2], tile[(c * M + v) * 2 + 1]);
        float t = mxu_pair_t<TID, true>(val, rf, tmin, limit);
        if (ANY) {
          hit = t < BIG;
        } else if (t < bt_run) {
          bt_run = t;
          be_run = ct * TILE + c;
        }
      }
      // the stage is read out before it is refilled; any-hit stops once
      // no thread holds a live, unoccluded ray
      if (ANY) more = __syncthreads_or(live && !hit) && more;
      else __syncthreads();
      if (!more) {
        if (ct + 1 < n_tiles) bulk_wait(bar + (stage ^ 1), (parity >> (stage ^ 1)) & 1u);
        break;
      }
      stage ^= 1;
    }
  }
  if (!valid) return;
  if (!live) {
    bt_out[i] = bt;
    be_out[i] = be;
  } else if (ANY) {
    bt_out[i] = bt;
    be_out[i] = max(be, hit ? 1 : 0);
  } else {
    bool win = bt_run < bt;
    bt_out[i] = win ? bt_run : bt;
    be_out[i] = win ? be_run : be;
  }
}

using KernelFn = void (*)(const float*, int, int, const float*, const float*, const float*,
                          const float*, const float*, const int*, float*, int*, int);

template <int TID>
cudaError_t launch(bool any_hit, const float* Wp, int C, int n_tiles, const float* ro,
                   const float* rd, const float* tmin, const float* tmax, const float* bt_in,
                   const int* be_in, float* bt_out, int* be_out, int n, cudaStream_t stream) {
  dim3 block(THREADS), grid((n + THREADS - 1) / THREADS);
  KernelFn k = any_hit ? mxu_sweep_kernel<TID, true> : mxu_sweep_kernel<TID, false>;
  int smem = 2 * tile_floats<TID>() * 4;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<grid, block, smem, stream>>>(Wp, C, n_tiles, ro, rd, tmin, tmax, bt_in, be_in, bt_out,
                                   be_out, n);
  return cudaGetLastError();
}

}  // namespace

// C interface.  Wp is the prim-major (n_tiles, 128, m, 8) table of C >= 1
// prims, on a 16-byte boundary.  Returns the launch's error (0 on success);
// a prim type with no table returns cudaErrorInvalidValue without launching.
extern "C" int pine_mxu_sweep(int tid, int any_hit, const float* Wp, int C, int n_tiles,
                              const float* ro, const float* rd, const float* tmin,
                              const float* tmax, const float* bt_in, const int* be_in,
                              float* bt_out, int* be_out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (C < 1 || n_tiles != (C + TILE - 1) / TILE) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T) \
  case T:            \
    return launch<T>(a, Wp, C, n_tiles, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s);
  switch (tid) {
    PINE_CASE(SPHERE)
    PINE_CASE(RECT)
    PINE_CASE(DISK)
    PINE_CASE(PLANE)
    PINE_CASE(TRIANGLE)
    PINE_CASE(CONE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PINE_CASE
}
