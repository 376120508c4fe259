// Native terrain generator — C++ equivalent of terrain/generator.py.
//
// The reference's native layer is the external isaacgym binary (PhysX +
// terrain_utils in C++); this file provides the framework's own native
// host-side runtime piece: procedural heightfield synthesis for the
// curriculum world (8 tile generators + world assembly), exported over a
// C ABI consumed via ctypes (native/__init__.py).  Semantics mirror
// terrain/generator.py (which mirrors legged_gym/utils/terrain.py:8-243 +
// the terrain_utils generators); RNG is xoshiro256** so the two backends
// are independently deterministic per seed.
//
// Build: g++ -O2 -shared -fPIC -o libdtcterrain.so terrain_gen.cpp
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
  // uniform integer in [lo, hi)
  int64_t randint(int64_t lo, int64_t hi) {
    if (hi <= lo + 1) return lo;
    return lo + (int64_t)(uniform() * (double)(hi - lo));
  }
  double choice(const std::vector<double>& v) {
    return v[(size_t)randint(0, (int64_t)v.size())];
  }
};

struct Tile {
  int width, length;           // cells along x, y
  double vscale, hscale;
  std::vector<int16_t> h;      // row-major (width, length)
  Tile(int w, int l, double vs, double hs)
      : width(w), length(l), vscale(vs), hscale(hs), h((size_t)w * l, 0) {}
  int16_t& at(int i, int j) { return h[(size_t)i * length + j]; }
  void fill(int x1, int x2, int y1, int y2, int16_t v) {
    x1 = std::max(0, x1); x2 = std::min(width, x2);
    y1 = std::max(0, y1); y2 = std::min(length, y2);
    for (int i = x1; i < x2; i++)
      for (int j = y1; j < y2; j++) at(i, j) = v;
  }
  void add(int x1, int x2, int y1, int y2, int16_t v) {
    x1 = std::max(0, x1); x2 = std::min(width, x2);
    y1 = std::max(0, y1); y2 = std::min(length, y2);
    for (int i = x1; i < x2; i++)
      for (int j = y1; j < y2; j++) at(i, j) = (int16_t)(at(i, j) + v);
  }
};

void pyramid_sloped(Tile& t, double slope, double platform) {
  double cx = t.width / 2.0, cy = t.length / 2.0;
  double max_h = slope * (t.width / 2.0) * t.hscale / t.vscale;
  for (int i = 0; i < t.width; i++)
    for (int j = 0; j < t.length; j++) {
      double dist = std::max(std::fabs(i - cx) / cx, std::fabs(j - cy) / cy);
      t.at(i, j) = (int16_t)(max_h * (1.0 - dist));
    }
  int plat = (int)(platform / t.hscale / 2);
  int16_t ch = t.at((int)cx, (int)cy);
  t.fill((int)cx - plat, (int)cx + plat, (int)cy - plat, (int)cy + plat, ch);
}

void random_uniform(Tile& t, Rng& rng, double min_h, double max_h,
                    double step, double down_scale) {
  int hmin = (int)(min_h / t.vscale), hmax = (int)(max_h / t.vscale);
  int hstep = std::max((int)(step / t.vscale), 1);
  std::vector<double> range;
  for (int v = hmin; v <= hmax + hstep - 1; v += hstep) range.push_back(v);
  int down = std::max((int)(down_scale / t.hscale), 1);
  int nw = t.width / down + 2, nl = t.length / down + 2;
  std::vector<int16_t> coarse((size_t)nw * nl);
  for (auto& c : coarse) c = (int16_t)rng.choice(range);
  for (int i = 0; i < t.width; i++)
    for (int j = 0; j < t.length; j++)
      t.at(i, j) = (int16_t)(t.at(i, j) + coarse[(size_t)(i / down) * nl + j / down]);
}

void pyramid_stairs(Tile& t, double step_width, double step_height,
                    double platform) {
  int sw = std::max((int)(step_width / t.hscale), 1);
  int sh = (int)(step_height / t.vscale);
  int plat = (int)(platform / t.hscale);
  int x1 = 0, x2 = t.width, y1 = 0, y2 = t.length, height = 0;
  while ((x2 - x1) > plat && (y2 - y1) > plat) {
    x1 += sw; x2 -= sw; y1 += sw; y2 -= sw; height += sh;
    t.fill(x1, x2, y1, y2, (int16_t)height);
  }
}

void discrete_obstacles(Tile& t, Rng& rng, double max_h, double min_sz,
                        double max_sz, int num, double platform) {
  int h = (int)(max_h / t.vscale);
  int mn = (int)(min_sz / t.hscale), mx = (int)(max_sz / t.hscale);
  std::vector<double> hs = {(double)-h, -h / 2.0, -h / 4.0,
                            h / 4.0, h / 2.0, (double)h};
  for (int k = 0; k < num; k++) {
    int w = (int)rng.randint(mn, std::max(mx, mn + 1));
    int l = (int)rng.randint(mn, std::max(mx, mn + 1));
    int sx = (int)rng.randint(0, std::max(t.width - w, 1));
    int sy = (int)rng.randint(0, std::max(t.length - l, 1));
    t.fill(sx, sx + w, sy, sy + l, (int16_t)rng.choice(hs));
  }
  int plat = (int)(platform / t.hscale / 2);
  t.fill(t.width / 2 - plat, t.width / 2 + plat,
         t.length / 2 - plat, t.length / 2 + plat, 0);
}

void stepping_stones(Tile& t, Rng& rng, double stone_size,
                     double stone_distance, double max_h, double platform,
                     double depth) {
  int ss = std::max((int)(stone_size / t.hscale), 1);
  int sd = (int)(stone_distance / t.hscale);
  int hmax = (int)(max_h / t.vscale);
  std::vector<double> heights;
  for (int v = -hmax - 1; v <= hmax; v++) heights.push_back(v);
  t.fill(0, t.width, 0, t.length, (int16_t)(depth / t.vscale));
  int start_y = 0;
  while (start_y < t.length) {
    int stop_y = std::min(t.length, start_y + ss);
    int start_x = (int)rng.randint(0, ss);
    int stop_x = std::max(0, start_x - sd);
    t.fill(0, stop_x, start_y, stop_y, (int16_t)rng.choice(heights));
    while (start_x < t.width) {
      stop_x = std::min(t.width, start_x + ss);
      t.fill(start_x, stop_x, start_y, stop_y, (int16_t)rng.choice(heights));
      start_x += ss + sd;
    }
    start_y += ss + sd;
  }
  int plat = (int)(platform / t.hscale / 2);
  t.fill(t.width / 2 - plat, t.width / 2 + plat,
         t.length / 2 - plat, t.length / 2 + plat, 0);
}

void gap(Tile& t, double gap_size, double platform) {
  int g = (int)(gap_size / t.hscale);
  int plat = (int)(platform / t.hscale);
  int cx = t.width / 2, cy = t.length / 2;
  int x1 = (t.width - plat) / 2, x2 = x1 + g;
  int y1 = (t.length - plat) / 2, y2 = y1 + g;
  t.fill(cx - x2, cx + x2, cy - y2, cy + y2, -1000);
  t.fill(cx - x1, cx + x1, cy - y1, cy + y1, 0);
}

void pit(Tile& t, double depth, double platform) {
  int d = (int)(depth / t.vscale);
  int plat = (int)(platform / t.hscale / 2);
  t.fill(t.width / 2 - plat, t.width / 2 + plat,
         t.length / 2 - plat, t.length / 2 + plat, (int16_t)(-d));
}

void stones_everywhere(Tile& t, Rng& rng, double stone_size,
                       double stone_distance, double max_h, double platform,
                       double depth) {
  int max_ss = std::max((int)(stone_size / t.hscale), 2);
  std::vector<double> sizes = {(double)(max_ss - 1), (double)max_ss};
  int sd = std::max((int)(stone_distance / t.hscale), 1);
  int hmax = std::max((int)(max_h / t.vscale), 1);
  std::vector<double> heights;
  for (int v = 1; v <= 2 * hmax; v++) heights.push_back(v);
  t.fill(0, t.width, 0, t.length, (int16_t)(depth / t.vscale));
  int start_y = 0;
  while (start_y < t.length) {
    int stop_y = std::min(t.length, start_y + (int)rng.choice(sizes));
    int start_x = (int)rng.randint(0, (int64_t)rng.choice(sizes));
    int stop_x = std::max(0, start_x - sd);
    t.fill(0, stop_x, start_y, stop_y, (int16_t)rng.choice(heights));
    while (start_x < t.width) {
      stop_x = std::min(t.width, start_x + (int)rng.choice(sizes));
      t.fill(start_x, stop_x, start_y, stop_y, (int16_t)rng.choice(heights));
      start_x += (int)rng.choice(sizes) + sd;
    }
    start_y += (int)rng.choice(sizes) + sd;
  }
  int plat = (int)(platform / t.hscale);
  t.fill((t.width - plat) / 2, (t.width + plat) / 2,
         (t.length - plat) / 2, (t.length + plat) / 2, 0);
}

void make_tile(Tile& t, Rng& rng, const double* props, int n_props,
               double choice, double difficulty) {
  std::vector<double> cum(8, 0.0);
  double acc = 0.0;
  for (int i = 0; i < 8; i++) {
    if (i < n_props) acc += props[i];
    cum[i] = acc;
  }
  double slope = difficulty * 0.4;
  double stepping_size = 1.0 * (1.05 - difficulty);
  double step_height = 0.05 + 0.13 * difficulty;
  double disc_h = 0.05 + difficulty * 0.15;
  double stone_distance = difficulty == 0.0 ? 0.03 : 0.06;
  double stones_max_h = 0.02 + 0.03 * difficulty;
  double stone_size = -0.1 * difficulty + 0.3;
  double gap_size = 0.8 * difficulty;
  double pit_depth = 0.8 * difficulty;

  if (choice < cum[0]) {
    if (choice < cum[0] / 2) slope = -slope;
    pyramid_sloped(t, slope, 3.0);
  } else if (choice < cum[1]) {
    pyramid_sloped(t, slope, 3.0);
    random_uniform(t, rng, -0.05, 0.05, 0.005, 0.2);
  } else if (choice < cum[3]) {
    if (choice < cum[2]) step_height = -step_height;
    pyramid_stairs(t, 0.31, step_height, 3.0);
  } else if (choice < cum[4]) {
    discrete_obstacles(t, rng, disc_h, 1.0, 2.0, 20, 3.0);
  } else if (choice < cum[5]) {
    stepping_stones(t, rng, stepping_size, stone_distance, 0.0, 1.0, -2.0);
  } else if (choice < cum[6]) {
    gap(t, gap_size, 1.0);
  } else if (choice < cum[7]) {
    pit(t, pit_depth, 1.0);
  } else {
    stones_everywhere(t, rng, stone_size, stone_distance, stones_max_h,
                      1.3, -2.0);
  }
}

}  // namespace

extern "C" int dtc_generate_terrain(
    int num_rows, int num_cols, double terrain_length, double terrain_width,
    double border_size, double horizontal_scale, double vertical_scale,
    const double* proportions, int n_props, int curriculum, uint64_t seed,
    int16_t* out_heightfield, double* out_origins) {
  const int lpx = (int)(terrain_length / horizontal_scale);
  const int wpx = (int)(terrain_width / horizontal_scale);
  const int border = (int)(border_size / horizontal_scale);
  const int tot_rows = num_rows * lpx + 2 * border;
  const int tot_cols = num_cols * wpx + 2 * border;
  std::memset(out_heightfield, 0,
              sizeof(int16_t) * (size_t)tot_rows * tot_cols);
  Rng rng(seed);
  for (int j = 0; j < num_cols; j++) {
    for (int i = 0; i < num_rows; i++) {
      double difficulty, choice;
      if (curriculum) {
        difficulty = (double)i / num_rows;
        choice = (double)j / num_cols + 0.001;
      } else {
        choice = rng.uniform();
        const double opts[4] = {0.25, 0.5, 0.75, 0.9};
        difficulty = opts[rng.randint(0, 4)];
      }
      Tile t(lpx, wpx, vertical_scale, horizontal_scale);
      make_tile(t, rng, proportions, n_props, choice, difficulty);
      // blit into the world
      for (int r = 0; r < lpx; r++) {
        std::memcpy(out_heightfield +
                        (size_t)(border + i * lpx + r) * tot_cols +
                        (border + j * wpx),
                    &t.h[(size_t)r * wpx], sizeof(int16_t) * (size_t)wpx);
      }
      // env origin: tile center, z = max height of the central 2x2 m patch
      int x1 = (int)((terrain_length / 2.0 - 1) / horizontal_scale);
      int x2 = (int)((terrain_length / 2.0 + 1) / horizontal_scale);
      int y1 = (int)((terrain_width / 2.0 - 1) / horizontal_scale);
      int y2 = (int)((terrain_width / 2.0 + 1) / horizontal_scale);
      int16_t mx = -32768;
      for (int r = x1; r < x2; r++)
        for (int c = y1; c < y2; c++) mx = std::max(mx, t.at(r, c));
      double* o = out_origins + ((size_t)i * num_cols + j) * 3;
      o[0] = (i + 0.5) * terrain_length;
      o[1] = (j + 0.5) * terrain_width;
      o[2] = mx * vertical_scale;
    }
  }
  return tot_rows * 100000 + tot_cols;
}
