// Stochastic Moving MNIST batch synthesizer on the host (a copy of the JAX
// package's data/native/smmnist.cpp; the two are built with the same g++
// flags, so their clips agree bit for bit).
//
// The loader's batch path (`StochasticMovingMNIST.get_batch`) calls it for a
// whole batch at once. Trajectories follow data/smmnist.py (bounce, velocity
// resampled at the walls); the draws come from splitmix64 seeded per (seed,
// epoch, index), so a clip is not the per-item numpy path's clip.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t s) : state(s) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // uniform integer in [lo, hi)
  int64_t randint(int64_t lo, int64_t hi) {
    return lo + static_cast<int64_t>(next() % static_cast<uint64_t>(hi - lo));
  }
};

}  // namespace

extern "C" {

// digits: (n_avail, ds, ds) float32 in [0,1]
// out: (B, T, sz, sz) float32 (channel dim added on the python side)
void smmnist_synthesize(const float* digits, int64_t n_avail, int32_t ds,
                        uint64_t seed, int64_t epoch, const int64_t* indices,
                        int64_t B, int32_t T, int32_t sz, int32_t num_digits,
                        int32_t deterministic, float* out) {
  const int64_t frame_px = static_cast<int64_t>(sz) * sz;
  for (int64_t b = 0; b < B; ++b) {
    float* video = out + b * T * frame_px;
    std::memset(video, 0, sizeof(float) * T * frame_px);
    SplitMix64 rng(seed * 0x100000001B3ULL + static_cast<uint64_t>(epoch) * 0x9E37ULL +
                   static_cast<uint64_t>(indices[b]) + 1ULL);
    for (int32_t d = 0; d < num_digits; ++d) {
      const float* digit = digits + rng.randint(0, n_avail) * ds * ds;
      int64_t span = std::max<int64_t>(sz - ds, 1);
      int64_t sx = rng.randint(0, span);
      int64_t sy = rng.randint(0, span);
      int64_t dx = rng.randint(-4, 5);
      int64_t dy = rng.randint(-4, 5);
      for (int32_t t = 0; t < T; ++t) {
        if (sy < 0) {
          sy = 0;
          if (deterministic) { dy = -dy; }
          else { dy = rng.randint(1, 5); dx = rng.randint(-4, 5); }
        } else if (sy >= sz - ds) {
          sy = sz - ds - 1;
          if (deterministic) { dy = -dy; }
          else { dy = rng.randint(-4, 0); dx = rng.randint(-4, 5); }
        }
        if (sx < 0) {
          sx = 0;
          if (deterministic) { dx = -dx; }
          else { dx = rng.randint(1, 5); dy = rng.randint(-4, 5); }
        } else if (sx >= sz - ds) {
          sx = sz - ds - 1;
          if (deterministic) { dx = -dx; }
          else { dx = rng.randint(-4, 0); dy = rng.randint(-4, 5); }
        }
        float* frame = video + static_cast<int64_t>(t) * frame_px;
        for (int32_t yy = 0; yy < ds; ++yy) {
          float* row = frame + (sy + yy) * sz + sx;
          const float* drow = digit + static_cast<int64_t>(yy) * ds;
          for (int32_t xx = 0; xx < ds; ++xx) row[xx] += drow[xx];
        }
        sy += dy;
        sx += dx;
      }
    }
    // clip to [0, 1]
    for (int64_t i = 0; i < T * frame_px; ++i)
      video[i] = std::min(1.0f, std::max(0.0f, video[i]));
  }
}

}  // extern "C"
