// Native multithreaded scenario generator: the framework's data-loading
// layer at fleet scale.
//
// The reference's world inputs arrive over ROS topics (people_interface.cpp,
// obstacle_distance_interface.cpp) from Gazebo + an external
// obstacle_distance_manager; this generator synthesizes the same world state
// (plan, robot, pedestrians, costmap, ESDF) for 10^3..10^5 scenarios per
// host call, feeding the batched device path. Mirrors the distributions of
// utils/scenarios.py (the readable NumPy single-scenario oracle); exact EDT
// exact-EDT semantics inlined (the port's runtime/esdf.py wraps the general-grid path).
//
// A frozen copy of the port's runtime/scenario_gen.cpp, kept with the
// benchmark so that its traffic does not move when that file does. One
// change: path_kind < 0 deals the three plan shapes out by lane (lane i
// takes sine, arc, straight for i mod 3 = 0, 1, 2), so that every batch
// holds a third of each.
//
// Build: g++ -O3 -shared -fPIC -o libscenario.so scenario_gen.cpp -lpthread
// (compiled on demand into portbench/.cache/ by portbench/gen/native.py,
// ctypes-loaded).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, high-quality per-scenario seeding.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  float uf() { return (next() >> 40) * (1.0f / 16777216.0f); }
  float uniform(float lo, float hi) { return lo + (hi - lo) * uf(); }
};

struct Blob {
  float x, y, r;
};

void fill_one(uint64_t seed, int path_kind, int n_path_points,
              int max_path_points, int n_agents, int n_valid, int h, int w,
              float resolution, float origin_x, float origin_y,
              int with_obstacles, float* path_points, float* path_yaw,
              int32_t* path_n, float* robot_pose, float* robot_speed,
              float* people, float* costmap, float* esdf_dist,
              int32_t* esdf_idx) {
  Rng rng(seed);
  const int n = n_path_points < max_path_points ? n_path_points : max_path_points;

  // --- path (sine/straight/arc over t in [0, 6], utils/scenarios.make_path) ---
  std::vector<float> xs(n_path_points), ys(n_path_points);
  const float amp = rng.uniform(0.3f, 1.0f);
  const float radius = rng.uniform(3.0f, 8.0f);
  for (int i = 0; i < n_path_points; ++i) {
    const float t = 6.0f * (float)i / (float)(n_path_points - 1);
    switch (path_kind) {
      case 1:  // straight
        xs[i] = t; ys[i] = 0.0f; break;
      case 2:  // arc
        xs[i] = radius * std::sin(t / radius);
        ys[i] = radius * (1.0f - std::cos(t / radius));
        break;
      default:  // sine
        xs[i] = t; ys[i] = amp * std::sin(0.8f * t); break;
    }
  }
  for (int i = 0; i < n; ++i) {
    // np.gradient: central differences, one-sided at the ends (the /2 and
    // /1 denominators cancel inside atan2's ratio only for uniform spacing,
    // so keep them explicit).
    const int lo = i > 0 ? i - 1 : 0;
    const int hi = i < n_path_points - 1 ? i + 1 : n_path_points - 1;
    const float denom = (float)(hi - lo);
    const float dx = (xs[hi] - xs[lo]) / denom;
    const float dy = (ys[hi] - ys[lo]) / denom;
    path_points[2 * i] = xs[i];
    path_points[2 * i + 1] = ys[i];
    path_yaw[i] = std::atan2(dy, dx);
  }
  for (int i = n; i < max_path_points; ++i) {  // hold-last padding
    path_points[2 * i] = path_points[2 * (n - 1)];
    path_points[2 * i + 1] = path_points[2 * (n - 1) + 1];
    path_yaw[i] = path_yaw[n - 1];
  }
  *path_n = n;

  robot_pose[0] = path_points[0];
  robot_pose[1] = path_points[1];
  robot_pose[2] = path_yaw[0];
  robot_speed[0] = rng.uniform(0.0f, 0.3f);
  robot_speed[1] = 0.0f;

  // --- people (utils/scenarios.make_people; t = -1 marks padding) ---
  for (int a = 0; a < n_agents; ++a) {
    float* p = people + 6 * a;
    std::memset(p, 0, 6 * sizeof(float));
    p[3] = -1.0f;
    if (a < n_valid) {
      p[0] = rng.uniform(0.5f, 3.0f);
      p[1] = rng.uniform(-1.5f, 1.5f);
      const float vx = rng.uniform(-0.6f, 0.6f);
      const float vy = rng.uniform(-0.6f, 0.6f);
      p[2] = std::atan2(vy, vx);
      p[3] = 0.0f;
      p[4] = std::hypot(vx, vy);
      p[5] = 0.0f;
    }
  }

  // --- costmap: Gaussian-inflated blobs, 0..254 (make_costmap) ---
  // Each blob touches only a +-4.25 sigma window: beyond that
  // 254*exp(-4.25^2/2) < 3e-2, below the f32 print precision of any cell the
  // 0-initialized max() would keep, so the result matches the full-grid fill.
  const Blob blobs[2] = {{3.0f, 1.2f, 0.3f}, {1.5f, -0.8f, 0.25f}};
  const int n_blobs = with_obstacles ? 2 : 0;
  std::memset(costmap, 0, (size_t)h * w * sizeof(float));
  for (int b = 0; b < n_blobs; ++b) {
    const float cx = (blobs[b].x - origin_x) / resolution;
    const float cy = (blobs[b].y - origin_y) / resolution;
    const float r = blobs[b].r / resolution;
    const float inv = 1.0f / (2.0f * r * r > 1e-6f ? 2.0f * r * r : 1e-6f);
    const float reach = 4.25f * r + 1.0f;
    const int x0 = std::max(0, (int)(cx - reach)), x1 = std::min(w - 1, (int)(cx + reach));
    const int y0 = std::max(0, (int)(cy - reach)), y1 = std::min(h - 1, (int)(cy + reach));
    for (int y = y0; y <= y1; ++y) {
      float* row = costmap + (size_t)y * w;
      const float dy2 = (y - cy) * (y - cy);
      for (int x = x0; x <= x1; ++x) {
        const float g = 254.0f * std::exp(-((x - cx) * (x - cx) + dy2) * inv);
        if (g > row[x]) row[x] = g;
      }
    }
  }
  // Round to integer cost values (np.rint semantics: nearest, ties to even)
  // -- nav2's Costmap2D stores unsigned char cost, and the bicubic kernel's
  // split3 dot requires bf16-exact (integer) grids; mirrors make_costmap.
  for (size_t i = 0; i < (size_t)h * w; ++i) costmap[i] = std::nearbyintf(costmap[i]);
  // Obstacle CELLS for the ESDF: the blob centers (matching make_scenario's
  // obs_cells convention).
  int obs_x[2], obs_y[2];
  int n_obs = 0;
  for (int b = 0; b < n_blobs; ++b) {
    const int cx = (int)((blobs[b].x - origin_x) / resolution);
    const int cy = (int)((blobs[b].y - origin_y) / resolution);
    if (cx >= 0 && cx < w && cy >= 0 && cy < h) {
      obs_x[n_obs] = cx;
      obs_y[n_obs] = cy;
      ++n_obs;
    }
  }
  if (n_obs == 0) {
    // Empty grid: esdf_build's empty_value fill, nearest index 0.
    for (size_t i = 0; i < (size_t)h * w; ++i) esdf_dist[i] = 1e3f;
    std::memset(esdf_idx, 0, (size_t)h * w * sizeof(int32_t));
  } else {
    // Exact EDT by direct scan — obstacle count is tiny here, so an
    // O(HW * n_obs) argmin beats the general O(HW) parabola transform
    // (the general-grid transform) by the constant factor that matters at 10^4+
    // grids/s. Same layout: distance [m] + flat index x + y*w
    // (obstacle_distance_interface.cpp:71-103).
    for (int y = 0; y < h; ++y) {
      float* drow = esdf_dist + (size_t)y * w;
      int32_t* irow = esdf_idx + (size_t)y * w;
      for (int x = 0; x < w; ++x) {
        int best = 0;
        float bd2 = 3.4e38f;
        for (int o = 0; o < n_obs; ++o) {
          const float dx = (float)(x - obs_x[o]);
          const float dy = (float)(y - obs_y[o]);
          const float d2 = dx * dx + dy * dy;
          if (d2 < bd2) { bd2 = d2; best = o; }
        }
        drow[x] = std::sqrt(bd2) * resolution;
        irow[x] = obs_x[best] + obs_y[best] * w;
      }
    }
  }
}

}  // namespace

extern "C" {

// Fills batch-leading buffers; layouts match core/types.py Scenario leaves.
//   path_points (B,P,2) path_yaw (B,P) path_n (B,) robot_pose (B,3)
//   robot_speed (B,2) people (B,N,6) costmap (B,H,W) esdf_dist (B,H,W)
//   esdf_idx (B,H,W)
void generate_scenarios(uint64_t base_seed, int32_t batch, int32_t n_threads,
                        int32_t path_kind, int32_t n_path_points,
                        int32_t max_path_points, int32_t n_agents,
                        int32_t n_valid, int32_t h, int32_t w,
                        float resolution, float origin_x, float origin_y,
                        int32_t with_obstacles, float* path_points,
                        float* path_yaw, int32_t* path_n, float* robot_pose,
                        float* robot_speed, float* people, float* costmap,
                        float* esdf_dist, int32_t* esdf_idx) {
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > batch) n_threads = batch;

  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= batch) return;
      const size_t hw = (size_t)h * w;
      static const int kDealt[3] = {0, 2, 1};  // sine, arc, straight
      const int kind = path_kind < 0 ? kDealt[i % 3] : path_kind;
      fill_one(base_seed + (uint64_t)i, kind, n_path_points,
               max_path_points, n_agents, n_valid, h, w, resolution, origin_x,
               origin_y, with_obstacles,
               path_points + (size_t)i * max_path_points * 2,
               path_yaw + (size_t)i * max_path_points, path_n + i,
               robot_pose + (size_t)i * 3, robot_speed + (size_t)i * 2,
               people + (size_t)i * n_agents * 6, costmap + (size_t)i * hw,
               esdf_dist + (size_t)i * hw, esdf_idx + (size_t)i * hw);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
