// The fused coefficient-table sweep of one prim group for Hopper (sm_90a):
// the "mxup" route of groups of up to 8,192 prims of a type with a table
// (sphere, rect, disk, plane, triangle, cone).
//
// Replaces pine_tpu/accel/mxu_sweep.py::_make_fused_kernel (reached through
// _compiled_fused_call), the Pallas TPU kernel that, per 1,024 rays, loops
// the group's 128-prim tiles, forms each tile's pair values as one
// (1024, 8) x (8, m*128) MXU matmul of the rays' feature rows
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
// What bounds it: arithmetic.  A pair costs 2 * 8 * m FP32 operations for
// its values and 7 to 26 for the epilogue, with IEEE divisions and square
// roots; a ray reads 40 bytes and writes 8, and the table (8 * m * 4 bytes
// per prim, 85 KB for the bench box's 424-row cone group) is read once per
// block through shared memory.
//
// Design: one thread per ray, 128 rays a block.  For each 128-prim tile the
// block stages the tile's (8, m*128) strip of the tile-major table
// (accel/mxu_tables.build_tiled_tables, at most 24 KB for m = 6) in shared
// memory; every thread then forms its m values per prim as the ordered FP32
// sums of csrc/mxu_epilogue.cuh (all threads read the same word: a
// broadcast), runs the epilogue and keeps a running (t, row) best, replaced
// on a strictly lower t, so ties keep the lowest row.  No tensor cores: TF32
// rounds the inputs far outside the parity tolerance, as bf16 does on the
// TPU (mxu_sweep.mxu_precision).  Templated on the prim type and any-hit.

#include "mxu_epilogue.cuh"

namespace {

using namespace pine;

constexpr int TILE = 128;   // prims per tile; also rays per block
constexpr int INT_BIG = 1 << 30;

template <int TID, bool ANY>
__global__ void __launch_bounds__(TILE)
mxu_sweep_kernel(const float* __restrict__ W, int C, int n_tiles,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
                 const float* __restrict__ bt_in, const int* __restrict__ be_in,
                 float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int M = mxu_m<TID>();
  constexpr int STRIP = M * TILE;  // floats per feature row of one tile's strip
  __shared__ float strip[RAY_FEATS * STRIP];

  int i = blockIdx.x * TILE + threadIdx.x;
  bool valid = i < n;
  float bt = valid ? bt_in[i] : 0.0f;
  int be = valid ? be_in[i] : 0;
  float tmin = valid ? tmin_in[i] : 0.0f;
  float limit = ANY ? (valid ? tmax_in[i] : 0.0f) : bt;
  // an occluded any-hit lane keeps its flag (max(flag, 0 or 1) = flag)
  bool live = valid && limit > tmin && !(ANY && be >= 1);
  if (!__syncthreads_or(live)) {
    if (valid) {
      bt_out[i] = bt;
      be_out[i] = be;
    }
    return;
  }
  RayFeat rf;
  if (live) {
    V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
    V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
    rf = ray_features(o, d);
  }
  float bt_run = BIG;
  int be_run = INT_BIG;
  bool hit = false;
  const int row_stride = n_tiles * STRIP;  // floats per feature row of W
  for (int ct = 0; ct < n_tiles; ++ct) {
    __syncthreads();  // the previous tile's strip is no longer read
    for (int k = threadIdx.x; k < RAY_FEATS * STRIP; k += TILE) {
      int f = k / STRIP, j = k - f * STRIP;
      strip[k] = __ldg(W + (size_t)f * row_stride + (size_t)ct * STRIP + j);
    }
    __syncthreads();
    if (!live || (ANY && hit)) continue;
    int width = min(TILE, C - ct * TILE);
    for (int c = 0; c < width; ++c) {
      float val[M];
      pair_values<M>(rf, strip + c, STRIP, TILE, val);
      float t = mxu_pair_t<TID>(val, rf, tmin, limit);
      if (ANY) {
        if (t < BIG) {
          hit = true;
          break;
        }
      } else if (t < bt_run) {
        bt_run = t;
        be_run = ct * TILE + c;
      }
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

template <int TID>
void launch(bool any_hit, const float* W, int C, int n_tiles, const float* ro,
            const float* rd, const float* tmin, const float* tmax, const float* bt_in,
            const int* be_in, float* bt_out, int* be_out, int n, cudaStream_t stream) {
  dim3 block(TILE), grid((n + TILE - 1) / TILE);
  if (any_hit)
    mxu_sweep_kernel<TID, true><<<grid, block, 0, stream>>>(
        W, C, n_tiles, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
  else
    mxu_sweep_kernel<TID, false><<<grid, block, 0, stream>>>(
        W, C, n_tiles, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n);
}

}  // namespace

// C interface.  W is the tile-major (8, n_tiles * m * 128) table of C prims.
// Returns cudaGetLastError() after the launch (0 on success); a prim type
// with no table returns cudaErrorInvalidValue without launching.
extern "C" int pine_mxu_sweep(int tid, int any_hit, const float* W, int C, int n_tiles,
                              const float* ro, const float* rd, const float* tmin,
                              const float* tmax, const float* bt_in, const int* be_in,
                              float* bt_out, int* be_out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                                    \
  case T:                                                                               \
    launch<T>(a, W, C, n_tiles, ro, rd, tmin, tmax, bt_in, be_in, bt_out, be_out, n, s); \
    break;
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
  return cudaGetLastError();
}
