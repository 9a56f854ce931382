// raytpu native runtime — host-side C++ components.
//
// The reference's native surface is its C++ host layer (device management,
// scene construction — CSVersion/DxCSApp.cpp); the framework's host
// runtime is JAX, but the host-side *build* work that sits in front of the
// device (BVH construction over large scenes) is implemented natively here
// and exposed through a C ABI consumed via ctypes (raytpu/native.py).
//
// The algorithm intentionally mirrors raytpu/bvh.py::build_bvh exactly
// (median split on the longest centroid axis, stable ordering, preorder
// flatten with skip pointers, float64 box accumulation) so the two
// builders are interchangeable and cross-checked bit-for-bit in tests.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Builder {
  const double* centers;  // (n, 3)
  const double* radii;    // (n,)
  int leaf_size;
  double pad;
  // outputs
  float* nodes;     // (max_nodes, 9): lo3, hi3, start, count, skip
  float* perm;      // (n,)
  int n_nodes = 0;
  int n_order = 0;

  void build(std::vector<int>& idx, int lo, int hi) {
    const int my = n_nodes++;
    float* nd = nodes + my * 9;

    double blo[3] = {1e300, 1e300, 1e300};
    double bhi[3] = {-1e300, -1e300, -1e300};
    for (int k = lo; k < hi; ++k) {
      const int i = idx[k];
      const double r = std::fabs(radii[i]);
      for (int a = 0; a < 3; ++a) {
        blo[a] = std::min(blo[a], centers[i * 3 + a] - r);
        bhi[a] = std::max(bhi[a], centers[i * 3 + a] + r);
      }
    }
    for (int a = 0; a < 3; ++a) {
      nd[a] = static_cast<float>(blo[a] - pad);
      nd[3 + a] = static_cast<float>(bhi[a] + pad);
    }

    const int count = hi - lo;
    if (count <= leaf_size) {
      nd[6] = static_cast<float>(n_order);
      nd[7] = static_cast<float>(count);
      for (int k = lo; k < hi; ++k) perm[n_order++] = static_cast<float>(idx[k]);
    } else {
      double clo[3] = {1e300, 1e300, 1e300};
      double chi[3] = {-1e300, -1e300, -1e300};
      for (int k = lo; k < hi; ++k) {
        const int i = idx[k];
        for (int a = 0; a < 3; ++a) {
          clo[a] = std::min(clo[a], centers[i * 3 + a]);
          chi[a] = std::max(chi[a], centers[i * 3 + a]);
        }
      }
      int axis = 0;
      double best = chi[0] - clo[0];
      for (int a = 1; a < 3; ++a) {  // strict >: first max wins (np.argmax)
        if (chi[a] - clo[a] > best) { best = chi[a] - clo[a]; axis = a; }
      }
      std::stable_sort(idx.begin() + lo, idx.begin() + hi,
                       [&](int a_, int b_) {
                         return centers[a_ * 3 + axis] < centers[b_ * 3 + axis];
                       });
      nd[6] = 0.0f;
      nd[7] = 0.0f;
      // median rounded UP to a leaf_size multiple (mirrors bvh.py's
      // rec(): leaves pack full -> ceil(n/leaf) leaves, not the pure
      // halving's next-power-of-two inflation)
      int half = count / 2;
      half = (half + leaf_size - 1) / leaf_size * leaf_size;
      if (half > count - 1) half = count - 1;
      build(idx, lo, lo + half);
      build(idx, lo + half, hi);
    }
    nodes[my * 9 + 8] = static_cast<float>(n_nodes);  // skip = after subtree
  }
};

// Binned surface-area-heuristic builder (16 centroid bins per axis).
// Same output layout/contract as Builder; the tree SHAPE differs (SAH
// splits minimize expected traversal cost instead of splitting at the
// median), which matters for non-uniform scenes — e.g. a huge ground
// sphere is isolated into its own cheap subtree instead of inflating a
// median leaf's bbox to the whole world.  Splitting continues while
// count > leaf_size (padded static leaves need count <= leaf_size);
// SAH chooses WHERE, not whether.  Deterministic: stable partition by
// bin keeps the original relative order.
struct SahBuilder {
  static constexpr int kBins = 16;
  const double* centers;
  const double* radii;
  int leaf_size;
  double pad;
  float* nodes;
  float* perm;
  int n_nodes = 0;
  int n_order = 0;

  static double area(const double lo[3], const double hi[3]) {
    const double dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
    if (dx < 0 || dy < 0 || dz < 0) return 0.0;  // empty box
    return 2.0 * (dx * dy + dy * dz + dz * dx);
  }

  void build(std::vector<int>& idx, int lo, int hi) {
    const int my = n_nodes++;
    float* nd = nodes + my * 9;

    double blo[3] = {1e300, 1e300, 1e300};
    double bhi[3] = {-1e300, -1e300, -1e300};
    double clo[3] = {1e300, 1e300, 1e300};
    double chi[3] = {-1e300, -1e300, -1e300};
    for (int k = lo; k < hi; ++k) {
      const int i = idx[k];
      const double r = std::fabs(radii[i]);
      for (int a = 0; a < 3; ++a) {
        const double c = centers[i * 3 + a];
        blo[a] = std::min(blo[a], c - r);
        bhi[a] = std::max(bhi[a], c + r);
        clo[a] = std::min(clo[a], c);
        chi[a] = std::max(chi[a], c);
      }
    }
    for (int a = 0; a < 3; ++a) {
      nd[a] = static_cast<float>(blo[a] - pad);
      nd[3 + a] = static_cast<float>(bhi[a] + pad);
    }

    const int count = hi - lo;
    if (count <= leaf_size) {
      nd[6] = static_cast<float>(n_order);
      nd[7] = static_cast<float>(count);
      for (int k = lo; k < hi; ++k)
        perm[n_order++] = static_cast<float>(idx[k]);
      nodes[my * 9 + 8] = static_cast<float>(n_nodes);
      return;
    }
    nd[6] = 0.0f;
    nd[7] = 0.0f;

    // best SAH split over 3 axes x (kBins - 1) planes
    int best_axis = -1, best_plane = -1;
    double best_cost = 1e300;
    for (int axis = 0; axis < 3; ++axis) {
      const double extent = chi[axis] - clo[axis];
      if (!(extent > 0)) continue;
      const double inv = kBins / extent;
      int cnt[kBins] = {0};
      double bl[kBins][3], bh[kBins][3];
      for (int b = 0; b < kBins; ++b)
        for (int a = 0; a < 3; ++a) { bl[b][a] = 1e300; bh[b][a] = -1e300; }
      for (int k = lo; k < hi; ++k) {
        const int i = idx[k];
        int b = static_cast<int>((centers[i * 3 + axis] - clo[axis]) * inv);
        b = std::min(std::max(b, 0), kBins - 1);
        ++cnt[b];
        const double r = std::fabs(radii[i]);
        for (int a = 0; a < 3; ++a) {
          bl[b][a] = std::min(bl[b][a], centers[i * 3 + a] - r);
          bh[b][a] = std::max(bh[b][a], centers[i * 3 + a] + r);
        }
      }
      // sweep: suffix areas right-to-left, then prefix left-to-right
      double rarea[kBins] = {0};
      int rcnt[kBins] = {0};
      double alo[3] = {1e300, 1e300, 1e300};
      double ahi[3] = {-1e300, -1e300, -1e300};
      int acc = 0;
      for (int b = kBins - 1; b > 0; --b) {
        acc += cnt[b];
        for (int a = 0; a < 3; ++a) {
          alo[a] = std::min(alo[a], bl[b][a]);
          ahi[a] = std::max(ahi[a], bh[b][a]);
        }
        rcnt[b] = acc;
        rarea[b] = area(alo, ahi);
      }
      for (int a = 0; a < 3; ++a) { alo[a] = 1e300; ahi[a] = -1e300; }
      acc = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        acc += cnt[b];
        for (int a = 0; a < 3; ++a) {
          alo[a] = std::min(alo[a], bl[b][a]);
          ahi[a] = std::max(ahi[a], bh[b][a]);
        }
        if (acc == 0 || rcnt[b + 1] == 0) continue;
        const double cost =
            acc * area(alo, ahi) + rcnt[b + 1] * rarea[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_plane = b;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      // degenerate centroids: median split (matches Builder's fallback
      // ordering rule)
      int axis = 0;
      double best = chi[0] - clo[0];
      for (int a = 1; a < 3; ++a)
        if (chi[a] - clo[a] > best) { best = chi[a] - clo[a]; axis = a; }
      std::stable_sort(idx.begin() + lo, idx.begin() + hi,
                       [&](int a_, int b_) {
                         return centers[a_ * 3 + axis] <
                                centers[b_ * 3 + axis];
                       });
      mid = lo + count / 2;
    } else {
      const double inv = kBins / (chi[best_axis] - clo[best_axis]);
      const double c0 = clo[best_axis];
      const int plane = best_plane;
      const int axis = best_axis;
      auto it = std::stable_partition(
          idx.begin() + lo, idx.begin() + hi, [&](int i) {
            int b = static_cast<int>((centers[i * 3 + axis] - c0) * inv);
            return std::min(std::max(b, 0), kBins - 1) <= plane;
          });
      mid = static_cast<int>(it - idx.begin());
    }
    build(idx, lo, mid);
    build(idx, mid, hi);
    nodes[my * 9 + 8] = static_cast<float>(n_nodes);
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.
// nodes_out must hold at least (2*n - 1) * 9 floats; perm_out n floats.
int rt_build_bvh(const double* centers, const double* radii, int n,
                 int leaf_size, double pad, float* nodes_out,
                 float* perm_out) {
  if (n <= 0 || leaf_size <= 0) return -1;
  Builder b;
  b.centers = centers;
  b.radii = radii;
  b.leaf_size = leaf_size;
  b.pad = pad;
  b.nodes = nodes_out;
  b.perm = perm_out;
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  b.build(idx, 0, n);
  if (b.n_order != n) return -1;
  return b.n_nodes;
}

// SAH variant: same contract as rt_build_bvh (see SahBuilder above).
int rt_build_bvh_sah(const double* centers, const double* radii, int n,
                     int leaf_size, double pad, float* nodes_out,
                     float* perm_out) {
  if (n <= 0 || leaf_size <= 0) return -1;
  SahBuilder b;
  b.centers = centers;
  b.radii = radii;
  b.leaf_size = leaf_size;
  b.pad = pad;
  b.nodes = nodes_out;
  b.perm = perm_out;
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  b.build(idx, 0, n);
  if (b.n_order != n) return -1;
  return b.n_nodes;
}

int rt_native_abi_version() { return 2; }

}  // extern "C"
