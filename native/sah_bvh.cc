// Binned-SAH BVH builder — the native runtime component of the path tracer.
//
// Role: the reference delegates acceleration-structure construction to Apple's
// closed-source native library (MPSTriangleAccelerationStructure.rebuild,
// reference: renderer/Renderer.mm:456-462).  This is the from-scratch
// equivalent: a 16-bin surface-area-heuristic top-down builder producing
// measurably better trees than the JAX LBVH (fewer node visits per ray), run
// once at scene load on the host.  Exposed through a plain C ABI for ctypes;
// accel/native.py adapts the output into the same BVH arrays the DFS layout
// pass consumes, so LBVH (jittable, device) and SAH (native, host) builders
// are interchangeable.
//
// Build: accel/native.py compiles it on first use (g++ -O3 -shared).

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    const float dx = std::max(hi.x - lo.x, 0.f);
    const float dy = std::max(hi.y - lo.y, 0.f);
    const float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  static constexpr int kBins = 16;

  const float* px[3];
  const float* py[3];
  const float* pz[3];
  int leaf_size;

  std::vector<AABB> tri_box;
  std::vector<Vec3> tri_centroid;
  std::vector<int32_t> order;  // triangle permutation, reordered in place

  // output node arrays (capacity 2T-1)
  std::vector<int32_t> left, right, first, count;
  std::vector<uint8_t> leaf;
  std::vector<float> bmin, bmax;  // 3*M each, component-major

  int32_t new_node(const AABB& b, int32_t lo, int32_t n) {
    const int32_t id = static_cast<int32_t>(left.size());
    left.push_back(-1);
    right.push_back(-1);
    first.push_back(lo);
    count.push_back(n);
    leaf.push_back(0);
    bmin.push_back(b.lo.x);
    bmin.push_back(b.lo.y);
    bmin.push_back(b.lo.z);
    bmax.push_back(b.hi.x);
    bmax.push_back(b.hi.y);
    bmax.push_back(b.hi.z);
    return id;
  }

  // Past this depth the binned-SAH split is replaced by a median split:
  // pathological centroid distributions can otherwise produce 1/(n-1)
  // splits every level (O(T) recursion depth -> native stack overflow on
  // multi-million-triangle scenes); a forced median bounds total depth at
  // kForceMedianDepth + log2(T).
  static constexpr int kForceMedianDepth = 48;

  // returns node id for range [lo, lo+n)
  int32_t build_range(int32_t lo, int32_t n, int depth = 0) {
    AABB box;
    AABB cbox;
    for (int32_t i = lo; i < lo + n; ++i) {
      box.grow(tri_box[order[i]]);
      cbox.grow(tri_centroid[order[i]]);
    }
    const int32_t node = new_node(box, lo, n);
    if (n <= leaf_size) {
      leaf[node] = 1;
      return node;
    }

    // choose split axis = widest centroid extent
    const float ex = cbox.hi.x - cbox.lo.x;
    const float ey = cbox.hi.y - cbox.lo.y;
    const float ez = cbox.hi.z - cbox.lo.z;
    int axis = 0;
    float extent = ex;
    if (ey > extent) { axis = 1; extent = ey; }
    if (ez > extent) { axis = 2; extent = ez; }
    const float clo = axis == 0 ? cbox.lo.x : (axis == 1 ? cbox.lo.y : cbox.lo.z);

    int32_t mid;
    if (extent <= 1e-12f || depth >= kForceMedianDepth) {
      mid = lo + n / 2;  // degenerate or too deep: median split
    } else {
      // binned SAH
      AABB bins[kBins];
      int32_t bin_n[kBins] = {0};
      const float scale = kBins / extent;
      auto bin_of = [&](int32_t t) {
        const Vec3& c = tri_centroid[t];
        const float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = static_cast<int>((v - clo) * scale);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int32_t i = lo; i < lo + n; ++i) {
        const int b = bin_of(order[i]);
        bins[b].grow(tri_box[order[i]]);
        ++bin_n[b];
      }
      float right_area[kBins];
      AABB acc;
      int32_t nr = 0;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bins[b]);
        nr += bin_n[b];
        right_area[b] = nr ? acc.half_area() * nr : 0.f;
      }
      AABB lacc;
      int32_t nl = 0;
      float best_cost = FLT_MAX;
      int best_split = -1;
      for (int b = 0; b < kBins - 1; ++b) {
        lacc.grow(bins[b]);
        nl += bin_n[b];
        if (nl == 0 || nl == n) continue;
        const float cost = lacc.half_area() * nl + right_area[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      if (best_split < 0) {
        mid = lo + n / 2;
        std::nth_element(
            order.begin() + lo, order.begin() + mid, order.begin() + lo + n,
            [&](int32_t a, int32_t b) {
              const Vec3& ca = tri_centroid[a];
              const Vec3& cb = tri_centroid[b];
              const float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
              const float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
              return va < vb;
            });
      } else {
        auto it = std::partition(
            order.begin() + lo, order.begin() + lo + n, [&](int32_t t) {
              return bin_of(t) <= best_split;
            });
        mid = static_cast<int32_t>(it - order.begin());
        if (mid == lo || mid == lo + n) mid = lo + n / 2;  // safety
      }
    }

    const int32_t l = build_range(lo, mid - lo, depth + 1);
    const int32_t r = build_range(mid, lo + n - mid, depth + 1);
    left[node] = l;
    right[node] = r;
    return node;
  }
};

}  // namespace

extern "C" {

// Build a SAH BVH over T triangles given as component-major vertex arrays
// (p0x[T], p0y[T], p0z[T], p1x..., p2z).  Outputs (caller-allocated, capacity
// 2T-1 nodes): node child/leaf arrays, component-major bounds (3 planes of M),
// and the triangle permutation.  Returns the node count M (root is node 0),
// or -1 on error.
int32_t pt_build_sah(
    const float* p0x, const float* p0y, const float* p0z,
    const float* p1x, const float* p1y, const float* p1z,
    const float* p2x, const float* p2y, const float* p2z,
    int32_t num_tris, int32_t leaf_size,
    int32_t* out_left, int32_t* out_right,
    int32_t* out_first, int32_t* out_count, uint8_t* out_leaf,
    float* out_bmin, float* out_bmax,   // each 3 * (2T-1), plane-major
    int32_t* out_order) {
  if (num_tris <= 0 || leaf_size < 1 || leaf_size > 63) return -1;
  Builder b;
  b.leaf_size = leaf_size;
  b.tri_box.resize(num_tris);
  b.tri_centroid.resize(num_tris);
  b.order.resize(num_tris);
  const int32_t max_nodes = 2 * num_tris - 1;
  b.left.reserve(max_nodes);
  b.right.reserve(max_nodes);
  b.first.reserve(max_nodes);
  b.count.reserve(max_nodes);
  b.leaf.reserve(max_nodes);
  b.bmin.reserve(3 * max_nodes);
  b.bmax.reserve(3 * max_nodes);

  for (int32_t i = 0; i < num_tris; ++i) {
    const Vec3 a{p0x[i], p0y[i], p0z[i]};
    const Vec3 c{p1x[i], p1y[i], p1z[i]};
    const Vec3 d{p2x[i], p2y[i], p2z[i]};
    AABB box;
    box.grow(a);
    box.grow(c);
    box.grow(d);
    b.tri_box[i] = box;
    b.tri_centroid[i] = {(a.x + c.x + d.x) / 3.f, (a.y + c.y + d.y) / 3.f,
                         (a.z + c.z + d.z) / 3.f};
    b.order[i] = i;
  }

  b.build_range(0, num_tris);
  const int32_t m = static_cast<int32_t>(b.left.size());

  std::memcpy(out_left, b.left.data(), m * sizeof(int32_t));
  std::memcpy(out_right, b.right.data(), m * sizeof(int32_t));
  std::memcpy(out_first, b.first.data(), m * sizeof(int32_t));
  std::memcpy(out_count, b.count.data(), m * sizeof(int32_t));
  std::memcpy(out_leaf, b.leaf.data(), m * sizeof(uint8_t));
  // interleaved xyz -> plane-major (3, M)
  for (int32_t i = 0; i < m; ++i) {
    out_bmin[0 * m + i] = b.bmin[3 * i + 0];
    out_bmin[1 * m + i] = b.bmin[3 * i + 1];
    out_bmin[2 * m + i] = b.bmin[3 * i + 2];
    out_bmax[0 * m + i] = b.bmax[3 * i + 0];
    out_bmax[1 * m + i] = b.bmax[3 * i + 1];
    out_bmax[2 * m + i] = b.bmax[3 * i + 2];
  }
  std::memcpy(out_order, b.order.data(), num_tris * sizeof(int32_t));
  return m;
}

}  // extern "C"
