// Native host kernels of the port's data pipeline (the port's own copy of
// lidiff_tpu/native/src/lidiff_native.cpp; the functions are the same).
//
//   * farthest point sampling   (Open3D farthest_point_down_sample)
//   * voxel-grid dedup          (ME.utils.sparse_quantize)
//   * viewpoint voxel inclusion (Open3D VoxelGrid.check_if_included)
//   * nearest-neighbor distance (Open3D compute_point_cloud_distance) via a
//     uniform grid hash
//
// A plain C ABI loaded through ctypes (lidiff_tpu_torch/native/__init__.py),
// built with -ffp-contract=off so that FPS's squared distances are the three
// float32 products and two adds that numpy computes. All functions are
// single-threaded and deterministic.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct CellKey {
  int64_t x, y, z;
  bool operator==(const CellKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct CellHash {
  size_t operator()(const CellKey& k) const {
    // 3D splitmix-style mix
    uint64_t h = (uint64_t)k.x * 0x9E3779B97F4A7C15ull;
    h ^= (uint64_t)k.y * 0xC2B2AE3D27D4EB4Full + (h << 6) + (h >> 2);
    h ^= (uint64_t)k.z * 0x165667B19E3779F9ull + (h << 6) + (h >> 2);
    return (size_t)h;
  }
};

inline int64_t cell_floor(float v, double inv_voxel) {
  return (int64_t)std::floor((double)v * inv_voxel);
}

}  // namespace

extern "C" {

// Farthest point sampling: pts [n,3] row-major float32; writes k indices.
// Starts at index 0; squared-L2.
void lidiff_fps(const float* pts, int64_t n, int64_t k, int64_t* out_idx) {
  if (k <= 0 || n <= 0) return;
  if (k >= n) {
    for (int64_t i = 0; i < n; ++i) out_idx[i] = i;
    return;
  }
  std::vector<float> d(n);
  const float* p0 = pts;
  for (int64_t i = 0; i < n; ++i) {
    const float dx = pts[3 * i] - p0[0];
    const float dy = pts[3 * i + 1] - p0[1];
    const float dz = pts[3 * i + 2] - p0[2];
    d[i] = dx * dx + dy * dy + dz * dz;
  }
  out_idx[0] = 0;
  for (int64_t s = 1; s < k; ++s) {
    int64_t best = 0;
    float bestd = -1.f;
    for (int64_t i = 0; i < n; ++i) {
      if (d[i] > bestd) { bestd = d[i]; best = i; }
    }
    out_idx[s] = best;
    const float* pb = pts + 3 * best;
    for (int64_t i = 0; i < n; ++i) {
      const float dx = pts[3 * i] - pb[0];
      const float dy = pts[3 * i + 1] - pb[1];
      const float dz = pts[3 * i + 2] - pb[2];
      const float dd = dx * dx + dy * dy + dz * dz;
      if (dd < d[i]) d[i] = dd;
    }
  }
}

// First-point-per-voxel dedup (floor grid). Returns count; indices are in
// ascending order of first occurrence position.
int64_t lidiff_voxel_unique(const float* pts, int64_t n, double voxel,
                            int64_t* out_idx) {
  const double inv = 1.0 / voxel;
  std::unordered_map<CellKey, int64_t, CellHash> seen;
  seen.reserve((size_t)n);
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    CellKey key{cell_floor(pts[3 * i], inv), cell_floor(pts[3 * i + 1], inv),
                cell_floor(pts[3 * i + 2], inv)};
    auto it = seen.find(key);
    if (it == seen.end()) {
      seen.emplace(key, i);
      out_idx[cnt++] = i;
    }
  }
  return cnt;
}

// Viewpoint filter: mask full points inside 10m-ish voxels occupied by the
// partial cloud. Open3D parity: grid origin is the partial cloud min bound.
void lidiff_viewpoint_filter(const float* full, int64_t nf,
                             const float* part, int64_t np_, double voxel,
                             uint8_t* out_mask) {
  double ox = std::numeric_limits<double>::infinity(), oy = ox, oz = ox;
  for (int64_t i = 0; i < np_; ++i) {
    ox = std::min(ox, (double)part[3 * i]);
    oy = std::min(oy, (double)part[3 * i + 1]);
    oz = std::min(oz, (double)part[3 * i + 2]);
  }
  const double inv = 1.0 / voxel;
  std::unordered_map<CellKey, char, CellHash> occ;
  occ.reserve((size_t)np_);
  for (int64_t i = 0; i < np_; ++i) {
    occ.emplace(CellKey{(int64_t)std::floor((part[3 * i] - ox) * inv),
                        (int64_t)std::floor((part[3 * i + 1] - oy) * inv),
                        (int64_t)std::floor((part[3 * i + 2] - oz) * inv)},
                1);
  }
  for (int64_t i = 0; i < nf; ++i) {
    CellKey key{(int64_t)std::floor((full[3 * i] - ox) * inv),
                (int64_t)std::floor((full[3 * i + 1] - oy) * inv),
                (int64_t)std::floor((full[3 * i + 2] - oz) * inv)};
    out_mask[i] = occ.count(key) ? 1 : 0;
  }
}

// Nearest-neighbor Euclidean distances a->b via a uniform grid hash with
// expanding shell search.
void lidiff_nn_dist(const float* a, int64_t na, const float* b, int64_t nb,
                    double cell, float* out_dist) {
  const double inv = 1.0 / cell;
  std::unordered_map<CellKey, std::vector<int32_t>, CellHash> grid;
  grid.reserve((size_t)nb);
  for (int64_t i = 0; i < nb; ++i) {
    grid[CellKey{cell_floor(b[3 * i], inv), cell_floor(b[3 * i + 1], inv),
                 cell_floor(b[3 * i + 2], inv)}].push_back((int32_t)i);
  }
  for (int64_t i = 0; i < na; ++i) {
    const float ax = a[3 * i], ay = a[3 * i + 1], az = a[3 * i + 2];
    const int64_t cx = cell_floor(ax, inv), cy = cell_floor(ay, inv),
                  cz = cell_floor(az, inv);
    double best = std::numeric_limits<double>::infinity();
    // expanding shells; stop one shell after first hit (a neighbor in shell
    // r guarantees the true NN is within shell r+1 for cubic cells)
    for (int64_t r = 0;; ++r) {
      bool any_cell = false;
      for (int64_t dx = -r; dx <= r; ++dx) {
        for (int64_t dy = -r; dy <= r; ++dy) {
          for (int64_t dz = -r; dz <= r; ++dz) {
            if (std::max({std::llabs(dx), std::llabs(dy), std::llabs(dz)})
                != r) continue;   // shell only
            auto it = grid.find(CellKey{cx + dx, cy + dy, cz + dz});
            if (it == grid.end()) continue;
            any_cell = true;
            for (int32_t j : it->second) {
              const double ddx = ax - b[3 * j];
              const double ddy = ay - b[3 * j + 1];
              const double ddz = az - b[3 * j + 2];
              const double dd = ddx * ddx + ddy * ddy + ddz * ddz;
              if (dd < best) best = dd;
            }
          }
        }
      }
      if (best < std::numeric_limits<double>::infinity()) {
        // true NN is guaranteed once we searched past sqrt(best)
        const double safe_r = (double)r * cell;
        if (safe_r * safe_r >= best || r > 4096) break;
      }
      if (r > 4096) break;    // degenerate empty grid guard
      (void)any_cell;
    }
    out_dist[i] = (float)std::sqrt(best);
  }
}

}  // extern "C"
