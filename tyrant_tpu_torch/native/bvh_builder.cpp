// Native binned-SAH BVH builder + stackless-link threading.
//
// C++ implementation of tyrant_tpu_torch/scene/bvh.py, with the same
// layout and the same splits (asserted in tests/test_torch_scene.py):
// SoA node arrays in depth-first order (left child == current+1), packed
// meta (count | axis<<3 | offset<<5), per-octant threaded hit/miss links,
// and the leaf-contiguous triangle permutation.  Ranges with degenerate
// centroid bounds are split at the median so leaves stay <= max_leaf.
//
// Exposed as a plain C ABI consumed via ctypes (native/bvh_native.py),
// which builds it with g++ into build/tyrant_tpu_torch/ at first use.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int META_AXIS_SHIFT = 3;
constexpr int META_OFFSET_SHIFT = 5;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float axis_of(const Vec3& v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct Box {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Vec3& l, const Vec3& h) {
    lo = vmin(lo, l);
    hi = vmax(hi, h);
  }
  void grow_point(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float surface_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dx * dz + dy * dz);
  }
};

struct BuildTask {
  int start, end, parent;
  bool is_second;
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.  Output buffers must
// hold 2*n_prims nodes (node_lo/node_hi: 3 floats each; meta/second_child:
// one int32 each) and perm must hold n_prims int32.
int tyrant_build_bvh(const float* tri_lo_in, const float* tri_hi_in,
                     int n_prims, int bucket_number, int max_leaf,
                     float traversal_cost, float intersection_cost,
                     int use_sah, float* node_lo,
                     float* node_hi, int32_t* meta, int32_t* second_child,
                     int32_t* perm) {
  if (n_prims <= 0 || bucket_number < 2 || max_leaf < 1 || max_leaf > 7)
    return -1;

  const Vec3* tlo = reinterpret_cast<const Vec3*>(tri_lo_in);
  const Vec3* thi = reinterpret_cast<const Vec3*>(tri_hi_in);

  std::vector<Vec3> centroid(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    centroid[i] = {0.5f * (tlo[i].x + thi[i].x), 0.5f * (tlo[i].y + thi[i].y),
                   0.5f * (tlo[i].z + thi[i].z)};
  }

  std::vector<int32_t> prim_idx(n_prims);
  for (int i = 0; i < n_prims; ++i) prim_idx[i] = i;

  int n_nodes = 0;
  int order_size = 0;
  std::vector<BuildTask> stack;
  stack.reserve(64);
  stack.push_back({0, n_prims, -1, false});

  std::vector<int32_t> scratch(n_prims);
  std::vector<int> b_count(bucket_number);
  std::vector<Box> b_box(bucket_number);

  while (!stack.empty()) {
    BuildTask task = stack.back();
    stack.pop_back();
    const int node = n_nodes++;
    if (task.is_second && task.parent >= 0) second_child[task.parent] = node;
    second_child[node] = -1;

    Box node_box;
    for (int i = task.start; i < task.end; ++i) {
      int p = prim_idx[i];
      node_box.grow(tlo[p], thi[p]);
    }
    node_lo[node * 3 + 0] = node_box.lo.x;
    node_lo[node * 3 + 1] = node_box.lo.y;
    node_lo[node * 3 + 2] = node_box.lo.z;
    node_hi[node * 3 + 0] = node_box.hi.x;
    node_hi[node * 3 + 1] = node_box.hi.y;
    node_hi[node * 3 + 2] = node_box.hi.z;

    const int np = task.end - task.start;

    auto make_leaf = [&]() {
      meta[node] = np | (0 << META_AXIS_SHIFT) | (order_size << META_OFFSET_SHIFT);
      for (int i = task.start; i < task.end; ++i) perm[order_size++] = prim_idx[i];
    };

    if (np == 1) {
      make_leaf();
      continue;
    }

    Box cbox;
    for (int i = task.start; i < task.end; ++i)
      cbox.grow_point(centroid[prim_idx[i]]);
    const Vec3 cext = {cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
                       cbox.hi.z - cbox.lo.z};
    // largest extent, ties broken x > y > z (as scene/bvh.py)
    int dim = 2;
    if (cext.x > cext.y && cext.x > cext.z)
      dim = 0;
    else if (cext.y > cext.z)
      dim = 1;

    const float clo = axis_of(cbox.lo, dim);
    const float chi = axis_of(cbox.hi, dim);

    int mid;
    if (chi == clo) {
      // degenerate centroid bounds: median split until leaf-sized
      if (np <= max_leaf) {
        make_leaf();
        continue;
      }
      mid = (task.start + task.end) / 2;
      meta[node] = 0 | (dim << META_AXIS_SHIFT);
      stack.push_back({mid, task.end, node, true});
      stack.push_back({task.start, mid, node, false});
      continue;
    }

    if (!use_sah) {
      // equal counts: median split
      mid = (task.start + task.end) / 2;
      std::nth_element(prim_idx.begin() + task.start, prim_idx.begin() + mid,
                       prim_idx.begin() + task.end,
                       [&](int32_t a, int32_t b) {
                         return axis_of(centroid[a], dim) <
                                axis_of(centroid[b], dim);
                       });
      meta[node] = 0 | (dim << META_AXIS_SHIFT);
      stack.push_back({mid, task.end, node, true});
      stack.push_back({task.start, mid, node, false});
      continue;
    }

    // binned SAH
    std::fill(b_count.begin(), b_count.end(), 0);
    std::fill(b_box.begin(), b_box.end(), Box{});
    auto bucket_of = [&](int p) {
      // same f32 expression as the numpy builder (scene/bvh.py):
      // a reciprocal-multiply can bucket boundary centroids differently
      float scaled = (axis_of(centroid[p], dim) - clo) / (chi - clo);
      int b = static_cast<int>(bucket_number * scaled);
      return std::min(b, bucket_number - 1);
    };
    for (int i = task.start; i < task.end; ++i) {
      int p = prim_idx[i];
      int b = bucket_of(p);
      b_count[b]++;
      b_box[b].grow(tlo[p], thi[p]);
    }

    // suffix unions
    std::vector<float> suf_sa(bucket_number + 1, 0.f);
    std::vector<int> suf_cnt(bucket_number + 1, 0);
    {
      Box acc;
      for (int b = bucket_number - 1; b >= 1; --b) {
        acc.grow(b_box[b].lo, b_box[b].hi);
        suf_cnt[b] = suf_cnt[b + 1] + b_count[b];
        suf_sa[b] = suf_cnt[b] > 0 ? acc.surface_area() : 0.f;
      }
    }
    float best_cost = FLT_MAX;
    int best_b = -1;
    {
      Box acc;
      int cnt = 0;
      const float area = node_box.surface_area();
      for (int b = 0; b < bucket_number - 1; ++b) {
        acc.grow(b_box[b].lo, b_box[b].hi);
        cnt += b_count[b];
        float sa1 = cnt > 0 ? acc.surface_area() : 0.f;
        // divide (not reciprocal-multiply), matching scene/bvh.py
        float cost = traversal_cost +
                     (cnt * sa1 + suf_cnt[b + 1] * suf_sa[b + 1]) / area;
        if (cost < best_cost) {
          best_cost = cost;
          best_b = b;
        }
      }
    }

    const float leaf_cost = intersection_cost * static_cast<float>(np);
    if (np > max_leaf || best_cost < leaf_cost) {
      // stable partition by bucket <= best_b (order-stable like the numpy
      // builder)
      int w0 = task.start;
      int w1 = 0;
      for (int i = task.start; i < task.end; ++i) {
        int p = prim_idx[i];
        if (bucket_of(p) <= best_b)
          prim_idx[w0++] = p;
        else
          scratch[w1++] = p;
      }
      std::memcpy(prim_idx.data() + w0, scratch.data(), w1 * sizeof(int32_t));
      mid = w0;
      meta[node] = 0 | (dim << META_AXIS_SHIFT);
      stack.push_back({mid, task.end, node, true});
      stack.push_back({task.start, mid, node, false});
    } else {
      make_leaf();
    }
  }
  return n_nodes;
}

// Threaded links for stackless traversal (see scene/bvh.py thread_links).
// hit_link: [2, n_nodes]; miss_link: [8, n_nodes].
int tyrant_thread_links(const int32_t* meta, const int32_t* second_child,
                        int n_nodes, int32_t* hit_link, int32_t* miss_link) {
  std::vector<std::pair<int32_t, int32_t>> stack;
  stack.reserve(64);
  for (int n = 0; n < n_nodes; ++n) {
    bool leaf = (meta[n] & 7) > 0;
    hit_link[n] = leaf ? -1 : n + 1;
    hit_link[n_nodes + n] = leaf ? -1 : second_child[n];
  }
  for (int octant = 0; octant < 8; ++octant) {
    int32_t* ml = miss_link + static_cast<size_t>(octant) * n_nodes;
    stack.clear();
    stack.push_back({0, -1});
    while (!stack.empty()) {
      auto [n, m] = stack.back();
      stack.pop_back();
      ml[n] = m;
      if ((meta[n] & 7) == 0) {
        int axis = (meta[n] >> META_AXIS_SHIFT) & 3;
        bool neg = (octant >> axis) & 1;
        int32_t first = n + 1, second = second_child[n];
        int32_t near = neg ? second : first;
        int32_t far = neg ? first : second;
        stack.push_back({near, far});
        stack.push_back({far, m});
      }
    }
  }
  return 0;
}

}  // extern "C"
