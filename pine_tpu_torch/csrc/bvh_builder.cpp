// Host binned-SAH BVH builder: the port's copy of pine_tpu/native/bvh_builder.cpp,
// the same algorithm and the same C interface.
//
// Exposed through a C ABI for ctypes; consumed by
// pine_tpu_torch/accel/native_build.py, which compiles it with the system C++
// compiler at first use (no -march=native, -ffp-contract=off, so the tree is
// the same on every machine).  Emits flat node arrays: parent nodes carrying
// both children's AABBs, leaves as (start,count) ranges of the reordered
// entity list padded to LEAF_MAX.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBuckets = 16;
constexpr int kLeafMax = 4;

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline Vec3 vmin(Vec3 a, Vec3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(Vec3 a, Vec3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void extend(const Vec3& l, const Vec3& h) {
    lo = vmin(lo, l);
    hi = vmax(hi, h);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dx * dz + dy * dz);
  }
};

struct Node {
  Vec3 lower[2], upper[2];
  int32_t child[2];  // >=0 inner node index, -1 leaf
  int32_t start[2], count[2];
};

struct Builder {
  const Vec3* lo;
  const Vec3* hi;
  std::vector<Vec3> centroid;
  std::vector<int32_t> order;
  std::vector<Node> nodes;

  Box bounds_of(const int32_t* ids, int n) const {
    Box b;
    for (int i = 0; i < n; i++) b.extend(lo[ids[i]], hi[ids[i]]);
    return b;
  }

  // Partition ids in place; returns split position or -1 for leaf.
  int split(int32_t* ids, int n) {
    if (n <= kLeafMax) return -1;
    Vec3 cmin{FLT_MAX, FLT_MAX, FLT_MAX}, cmax{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = 0; i < n; i++) {
      cmin = vmin(cmin, centroid[ids[i]]);
      cmax = vmax(cmax, centroid[ids[i]]);
    }
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 1e-12f) return n / 2;  // degenerate: median split

    float inv = kBuckets / ext[axis];
    Box bucket_box[kBuckets];
    int bucket_n[kBuckets] = {0};
    auto bucket_of = [&](int32_t id) {
      int b = int((centroid[id][axis] - cmin[axis]) * inv);
      return std::min(b, kBuckets - 1);
    };
    for (int i = 0; i < n; i++) {
      int b = bucket_of(ids[i]);
      bucket_box[b].extend(lo[ids[i]], hi[ids[i]]);
      bucket_n[b]++;
    }
    // sweep for best SAH cut
    float best_cost = FLT_MAX;
    int best_cut = -1;
    Box left_acc[kBuckets];
    Box acc;
    for (int b = 0; b < kBuckets; b++) {
      if (bucket_n[b]) acc.extend(bucket_box[b].lo, bucket_box[b].hi);
      left_acc[b] = acc;
    }
    Box racc;
    int rn = 0;
    for (int b = kBuckets - 1; b >= 1; b--) {
      if (bucket_n[b]) racc.extend(bucket_box[b].lo, bucket_box[b].hi);
      rn += bucket_n[b];
      int ln = n - rn;
      if (ln == 0 || rn == 0) continue;
      float cost = left_acc[b - 1].area() * ln + racc.area() * rn;
      if (cost < best_cost) {
        best_cost = cost;
        best_cut = b;
      }
    }
    if (best_cut < 0) {
      // all in one bucket: median on the axis
      std::nth_element(ids, ids + n / 2, ids + n, [&](int32_t a, int32_t b) {
        return centroid[a][axis] < centroid[b][axis];
      });
      return n / 2;
    }
    auto mid = std::partition(ids, ids + n, [&](int32_t id) {
      return bucket_of(id) < best_cut;
    });
    int pos = int(mid - ids);
    if (pos == 0 || pos == n) pos = n / 2;
    return pos;
  }

  int32_t build_node_presplit(int32_t* ids, int n, int cut) {
    int32_t me = int32_t(nodes.size());
    nodes.push_back({});
    struct Part {
      int32_t* ids;
      int n;
    } parts[2] = {{ids, cut}, {ids + cut, n - cut}};
    for (int k = 0; k < 2; k++) {
      Box b = bounds_of(parts[k].ids, parts[k].n);
      nodes[me].lower[k] = b.lo;
      nodes[me].upper[k] = b.hi;
      int sub_cut = (parts[k].n > kLeafMax) ? split(parts[k].ids, parts[k].n) : -1;
      if (sub_cut < 0) {
        nodes[me].child[k] = -1;
        nodes[me].start[k] = int32_t(order.size());
        nodes[me].count[k] = parts[k].n;
        for (int i = 0; i < parts[k].n; i++) order.push_back(parts[k].ids[i]);
      } else {
        nodes[me].child[k] = build_node_presplit(parts[k].ids, parts[k].n, sub_cut);
      }
    }
    return me;
  }
};

}  // namespace

extern "C" {

// Build BVH over n axis-aligned boxes.
//   lo, hi: (n,3) float32
// Outputs (caller-allocated, capacity >= n nodes):
//   order:          (n,)   int32   entity order
//   c_lower,c_upper:(n,2,3)float32
//   c_node:         (n,2)  int32
//   c_start,c_count:(n,2)  int32
// Returns number of nodes written, or -1 on error.
int32_t pine_build_bvh(const float* lo, const float* hi, int32_t n,
                       int32_t* order_out, float* c_lower, float* c_upper,
                       int32_t* c_node, int32_t* c_start, int32_t* c_count) {
  if (n <= 0) return -1;
  Builder b;
  b.lo = reinterpret_cast<const Vec3*>(lo);
  b.hi = reinterpret_cast<const Vec3*>(hi);
  b.centroid.resize(n);
  for (int i = 0; i < n; i++) {
    b.centroid[i] = {(b.lo[i].x + b.hi[i].x) * 0.5f,
                     (b.lo[i].y + b.hi[i].y) * 0.5f,
                     (b.lo[i].z + b.hi[i].z) * 0.5f};
  }
  std::vector<int32_t> ids(n);
  for (int i = 0; i < n; i++) ids[i] = i;
  b.order.reserve(n);
  b.nodes.reserve(std::max(1, n / 2));

  if (n <= kLeafMax) {
    Node nd{};
    Box bb = b.bounds_of(ids.data(), n);
    for (int k = 0; k < 2; k++) {
      nd.lower[k] = bb.lo;
      nd.upper[k] = bb.hi;
      nd.child[k] = -1;
      nd.start[k] = 0;
      nd.count[k] = (k == 0) ? n : 0;
    }
    b.nodes.push_back(nd);
    b.order = ids;
  } else {
    int cut = b.split(ids.data(), n);
    b.build_node_presplit(ids.data(), n, cut);
  }

  int32_t m = int32_t(b.nodes.size());
  if (m > n) return -1;  // caller capacity exceeded (cannot happen: m <= n)
  std::memcpy(order_out, b.order.data(), n * sizeof(int32_t));
  for (int32_t i = 0; i < m; i++) {
    const Node& nd = b.nodes[i];
    for (int k = 0; k < 2; k++) {
      std::memcpy(c_lower + (i * 2 + k) * 3, &nd.lower[k], 3 * sizeof(float));
      std::memcpy(c_upper + (i * 2 + k) * 3, &nd.upper[k], 3 * sizeof(float));
      c_node[i * 2 + k] = nd.child[k];
      c_start[i * 2 + k] = nd.start[k];
      c_count[i * 2 + k] = nd.count[k];
    }
  }
  return m;
}

}  // extern "C"
