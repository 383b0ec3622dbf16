// ESDF builder: exact 2-D Euclidean distance transform with nearest-obstacle
// index tracking.
//
// Native (host-side) replacement for the external `obstacle_distance_manager`
// node the reference consumes (README.md:12, obstacle_distance_interface.hpp):
// from an occupancy grid it produces the obstacle_distance message layout —
// per-cell distance to the nearest obstacle cell [m] plus that cell's flat
// index (x + y*width, the convention of optimizer.cpp:702/715-716).
//
// Algorithm: Felzenszwalb & Huttenlocher's lower-envelope-of-parabolas
// squared distance transform, O(H*W), run column-wise then row-wise, with the
// argmin source cell propagated through both passes. This is the data-loading
// layer of the framework (scenario generation at 10^4..10^5 grids/s), not the
// device compute path.
//
// Build: g++ -O3 -shared -fPIC -o libesdf.so esdf_builder.cpp
// (compiled on demand into the package's build/ directory by runtime/esdf.py,
// ctypes-loaded).

#include <cstdint>
#include <cmath>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// 1-D squared distance transform over f[0..n), tracking the source index of
// the winning parabola. d[q] = min_p (q - p)^2 + f[p]; src_out[q] = argmin p.
void dt1d(const float* f, const int32_t* src_in, int n, int stride,
          float* d, int32_t* src_out,
          std::vector<int>& v, std::vector<float>& z) {
  v.resize(n);
  z.resize(n + 1);
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    const float fq = f[q * stride];
    if (fq == kInf && f[v[k] * stride] == kInf) {
      // Both parabolas at infinity: keep the earlier one.
      continue;
    }
    float s;
    while (true) {
      const float fv = f[v[k] * stride];
      if (fv == kInf) {
        // Previous parabola is infinitely high: replace it.
        if (k == 0) { v[0] = q; z[0] = -kInf; z[1] = kInf; s = -kInf; break; }
        --k;
        continue;
      }
      s = ((fq + q * (float)q) - (fv + v[k] * (float)v[k])) / (2.0f * q - 2.0f * v[k]);
      if (s <= z[k]) { --k; } else { break; }
    }
    if (s != -kInf) {
      ++k;
      v[k] = q;
      z[k] = s;
      z[k + 1] = kInf;
    }
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    const int p = v[k];
    const float fv = f[p * stride];
    d[q * stride] = (fv == kInf) ? kInf : (q - p) * (float)(q - p) + fv;
    src_out[q * stride] = src_in[p * stride];
  }
}

}  // namespace

extern "C" {

// occ: (h, w) row-major, nonzero == obstacle cell.
// dist_out: (h, w) float distance in meters (resolution * cell distance);
//           cells on a map with no obstacles get `empty_value`.
// idx_out:  (h, w) int32 flat index (x + y*w) of the nearest obstacle cell
//           (0 when the map has no obstacles, matching the framework's
//           empty-grid convention).
void esdf_build(const uint8_t* occ, int32_t h, int32_t w, float resolution,
                float empty_value, float* dist_out, int32_t* idx_out) {
  const int n = h * w;
  std::vector<float> f(n), tmp(n);
  std::vector<int32_t> src(n), src_tmp(n);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int i = y * w + x;
      f[i] = occ[i] ? 0.0f : kInf;
      src[i] = x + y * w;  // self; meaningful only where occ != 0
    }
  }

  std::vector<int> v;
  std::vector<float> z;
  // Pass 1: columns (over y), stride w
  for (int x = 0; x < w; ++x) {
    dt1d(&f[x], &src[x], h, w, &tmp[x], &src_tmp[x], v, z);
  }
  // Pass 2: rows (over x), stride 1
  for (int y = 0; y < h; ++y) {
    dt1d(&tmp[y * w], &src_tmp[y * w], w, 1, &f[y * w], &src[y * w], v, z);
  }

  for (int i = 0; i < n; ++i) {
    if (f[i] == kInf) {
      dist_out[i] = empty_value;
      idx_out[i] = 0;
    } else {
      dist_out[i] = std::sqrt(f[i]) * resolution;
      idx_out[i] = src[i];
    }
  }
}

}  // extern "C"
