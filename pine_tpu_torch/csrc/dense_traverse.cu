// Dense ray-group traversal for Hopper (sm_90a).
//
// Replaces pine_tpu/accel/pallas_traverse.py::_make_dense_kernel, the Pallas
// TPU kernel that tests every prim of a group of 512 or fewer prims against an
// (8,128) ray block after a group-AABB slab cull of the whole block.  Its
// contract is pallas_group_query's:
//   closest-hit: (best_t, best_e) in/out; a prim replaces the running best
//     only on a strict t < best_t, so ties keep the lowest row; best_e is the
//     group-local row.
//   any-hit: best_e in/out is the 0/1 occlusion flag, best_t passes through;
//     a lane with tmax <= tmin never becomes occluded.
//   Culled lanes pass best_t / best_e through bit for bit.
//
// What bounds it: arithmetic.  Each ray that reaches the group box runs every
// prim test (a few dozen FP32 operations with IEEE divisions and square
// roots) while it reads 40 bytes of ray state and writes 8; the prim rows are
// a few kilobytes shared by all rays.  One thread per ray, each culling its
// own lane and reading rows by scalar loads from the read-only cache, ran
// the box's main-path launches at 19x that bound (H100 80GB HBM3, 700 W):
// culled lanes left their warps part idle through the whole sweep, every
// quadric pair paid its square root and divisions though most of them miss,
// and the row loop issued a load per column.
//
// Design:
// - The block's lanes cull their own rays against the group box (as the
//   plain version does); a lane that misses writes its state straight back.
//   The block then compacts its live lanes: each warp appends the indices of
//   its live rays to a queue in shared memory (a ballot and one atomic), and
//   thread j of the block sweeps queue entry j, so the live rays run in full
//   warps and the rest of the block's warps have nothing to do.
// - The group's rows, padded to a multiple of 4 floats at upload
//   (accel/dense_traverse.dense_rows), are staged once per block into shared
//   memory by cp.async while the block culls, up to TILE rows at a time (a
//   default group is staged whole; a forced larger group in tiles).  Every
//   lane of a warp reads the same row at the same step, so each row comes
//   as 16-byte vector loads that broadcast (SharedRow).
// - The tests take the exact early misses of prim_tests.cuh (EARLY): a
//   quadric whose discriminant rules out a hit, or a rect whose plane lies
//   outside the window, returns BIG before its square root and divisions.
// Per ray the rows are tested in order 0..n-1 with the plain version's
// arithmetic (built without fast math and with -fmad=false), so the result
// is accel/dense_traverse.py's dense_plain bit for bit.  Any-hit stops at a
// lane's first hit (the flag can only rise).

#include "prim_tests.cuh"

namespace {

using namespace pine;

// Rays per block.  The block compacts its own live lanes, so a larger block
// fills more warps, but holds its slots until its slowest warp is done.
// Measured on H100 80GB HBM3, 700 W, each size built in turn and summed over
// the benchmark box's cone group, closest-hit and any-hit, on the kernel
// lab's three ray sets of 409,600 and the main path's first bounce: 128 rays
// 3.76 ms, 256 3.62, 512 3.69, 1024 4.23; on the rect and OBB groups
// (0.21-0.28 ms summed) 1024 was the slowest.
constexpr int BLOCK = 256;
constexpr int TILE = 512;  // rows staged at once: accel/dense_traverse.DENSE_DEFAULT_MAX
constexpr unsigned FULL = 0xffffffffu;

// The block copies cnt padded rows into dst, 16 bytes a thread at a time.
template <int WP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int cnt) {
  for (int q = threadIdx.x; q < cnt * (WP / 4); q += BLOCK)
    cp_async16(dst + 4 * q, src + 4 * q, 16);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int TID, bool ANY>
__global__ void __launch_bounds__(BLOCK)
dense_kernel(const float* __restrict__ rows, int n_prims, const float* __restrict__ gbox,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
             const float* __restrict__ bt_in, const int* __restrict__ be_in,
             float* __restrict__ bt_out, int* __restrict__ be_out, int n) {
  constexpr int WP = padded_width<TID>();
  extern __shared__ __align__(16) float srows[];  // min(n_prims, TILE) rows of WP floats
  __shared__ int queue[BLOCK];                    // the block's live rays
  __shared__ int n_live;
  stage_rows<WP>(srows, rows, min(n_prims, TILE));  // in flight while the block culls
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();

  // Group-AABB cull.  Any-hit: an occluded lane gets the empty window
  // (tmin, tmin - 1); closest-hit: the window ends at the running best.
  int lane = threadIdx.x & 31;
  int i = blockIdx.x * BLOCK + threadIdx.x;
  bool live = false;
  if (i < n) {
    float tmin = tmin_in[i], bt = bt_in[i];
    int be = be_in[i];
    float near = tmin, far = ANY ? (be == 0 ? tmax_in[i] : tmin - 1.0f) : bt;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float oa = ro[3 * i + a];
      float inv = safe_inv(rd[3 * i + a]);
      float t0 = (__ldg(gbox + a) - oa) * inv;
      float t1 = (__ldg(gbox + 3 + a) - oa) * inv;
      near = vmax(near, vmin(t0, t1));
      far = vmin(far, vmax(t0, t1));
    }
    live = near <= far;
    if (!live) {
      bt_out[i] = bt;
      be_out[i] = be;
    }
  }
  unsigned m = __ballot_sync(FULL, live);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(&n_live, __popc(m));
  base = __shfl_sync(FULL, base, 0);
  if (live) queue[base + __popc(m & ((1u << lane) - 1u))] = i;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The sweep: thread j of the block takes the j-th live ray.
  bool active = threadIdx.x < n_live;
  V3 o{}, d{};
  float tmin = 0.0f, tmax = 0.0f, bt = 0.0f;
  int be = 0;
  if (active) {
    i = queue[threadIdx.x];
    o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
    d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
    tmin = tmin_in[i];
    bt = bt_in[i];
    be = be_in[i];  // any-hit: 0, or the lane would have been culled
    if (ANY) tmax = tmax_in[i];
  }
  for (int t0 = 0; t0 < n_prims; t0 += TILE) {
    int cnt = min(TILE, n_prims - t0);
    if (t0 > 0) {  // a group of more than TILE rows: its next tile
      __syncthreads();
      stage_rows<WP>(srows, rows + (size_t)t0 * WP, cnt);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    if (!active || (ANY && be)) continue;
    for (int e = 0; e < cnt; ++e) {
      SharedRow<WP> row(srows + e * WP);
      if (ANY) {
        if (prim_test_row<TID, true>(row, o, d, tmin, tmax) < BIG) {
          be = 1;
          break;
        }
      } else {
        float tt = prim_test_row<TID, true>(row, o, d, tmin, bt);
        if (tt < bt) {
          bt = tt;
          be = t0 + e;
        }
      }
    }
  }
  if (active) {
    bt_out[i] = bt;
    be_out[i] = be;
  }
}

template <int TID>
cudaError_t launch(bool any_hit, const float* rows, int width, int n_prims, const float* gbox,
                   const float* ro, const float* rd, const float* tmin, const float* tmax,
                   const float* bt_in, const int* be_in, float* bt_out, int* be_out, int n,
                   cudaStream_t stream) {
  if (width != padded_width<TID>()) return cudaErrorInvalidValue;
  auto k = any_hit ? dense_kernel<TID, true> : dense_kernel<TID, false>;
  int smem = min(n_prims, TILE) * padded_width<TID>() * 4;
  if (smem > 32 * 1024) {  // more than the default 48 KB leaves beside the queue
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k<<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(rows, n_prims, gbox, ro, rd, tmin, tmax,
                                                      bt_in, be_in, bt_out, be_out, n);
  return cudaGetLastError();
}

}  // namespace

// C interface.  Returns the launch's error (0 on success); an unknown shape
// type, or rows of another width than the type's padded width (a multiple of
// 4 floats), return cudaErrorInvalidValue without launching.  rows start on
// a 16-byte boundary.
extern "C" int pine_dense_traverse(int tid, int any_hit, const float* rows, int width,
                                   int n_prims, const float* gbox, const float* ro,
                                   const float* rd, const float* tmin, const float* tmax,
                                   const float* bt_in, const int* be_in, float* bt_out,
                                   int* be_out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool a = any_hit != 0;
#define PINE_CASE(T)                                                                  \
  case T:                                                                             \
    return launch<T>(a, rows, width, n_prims, gbox, ro, rd, tmin, tmax, bt_in, be_in,  \
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
