// The host sampler of stage-2 training: the port's copy of the JAX
// package's native/fastloader/fastloader.cpp, arithmetic unchanged, so that
// both libraries give the same bits for the same seed.
//
// The reference's data path makes ~8 full-image passes per training batch
// to pick jitter pairs (trainvali.py:327-412). This library does the
// per-step host work in native code, so that the host keeps up with the
// device:
//   * select_pairs: fused jitter-pair selection (contrast or random mode)
//     over the alpha/rgb images, OpenMP-parallel across rows, each row
//     seeded on its own (xorshift128+), so the result does not depend on
//     the thread count
//   * gather_rows: the gather of the selected pixels' rows
//   * load_npy_f32: minimal .npy reader (f32/f64, C-order)
//
// Plain C ABI for ctypes (vqnerf_release_torch/data/native.py); built with
// the host compiler by vqnerf_release_torch/kernels/build.py::build_host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// xorshift128+ for reproducible, fast sampling
struct Rng {
  uint64_t s0, s1;
};

static inline uint64_t rng_next(Rng* r) {
  uint64_t x = r->s0;
  const uint64_t y = r->s1;
  r->s0 = y;
  x ^= x << 23;
  r->s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  return r->s1 + y;
}

static inline int64_t rng_below(Rng* r, int64_t n) {
  return static_cast<int64_t>(rng_next(r) % static_cast<uint64_t>(n));
}

// Selects n_rays (pixel, jitter) pairs; writes interleaved coords
// [2*n_rays, 2] (row, col). jitter_mode 0 = uniform-random neighbor
// (train_nfr outer_sample), 1 = max-RGB-contrast neighbor (trainvali).
// Returns number of candidate interior pixels, or -1 if none.
int64_t select_pairs(const float* alpha, const float* rgb, int64_t h,
                     int64_t w, double alpha_thres, int64_t n_rays,
                     int jitter_mode, uint64_t seed, int64_t* out_coords) {
  static const int DY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  static const int DX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

  const int64_t ih = h - 2, iw = w - 2;
  std::vector<int32_t> jit(ih * iw);
  std::vector<uint8_t> keep(ih * iw);

#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < ih; ++r) {
    Rng rng{seed ^ (0x9E3779B97F4A7C15ull * (r + 1)),
            seed + 0xBF58476D1CE4E5B9ull * (r + 7)};
    for (int i = 0; i < 8; ++i) rng_next(&rng);
    for (int64_t c = 0; c < iw; ++c) {
      const int64_t y = r + 1, x = c + 1;
      int best = 0;
      if (jitter_mode == 1) {
        float best_d = -1.f;
        const float* pc = rgb + (y * w + x) * 3;
        for (int k = 0; k < 8; ++k) {
          const float* pn = rgb + ((y + DY[k]) * w + (x + DX[k])) * 3;
          float d = std::max(
              std::fabs(pn[0] - pc[0]),
              std::max(std::fabs(pn[1] - pc[1]),
                       std::fabs(pn[2] - pc[2])));
          if (d > best_d) {
            best_d = d;
            best = k;
          }
        }
      } else {
        best = static_cast<int>(rng_next(&rng) % 8);
      }
      jit[r * iw + c] = best;
      const float a_c = alpha[y * w + x];
      const float a_j =
          alpha[(y + DY[best]) * w + (x + DX[best])];
      keep[r * iw + c] =
          (a_c > alpha_thres && a_j > alpha_thres) ? 1 : 0;
    }
  }

  std::vector<int64_t> cand;
  cand.reserve(ih * iw);
  for (int64_t i = 0; i < ih * iw; ++i) {
    if (keep[i]) cand.push_back(i);
  }
  if (cand.empty()) return -1;

  Rng rng{seed ^ 0xD1B54A32D192ED03ull, seed + 0x94D049BB133111EBull};
  for (int i = 0; i < 8; ++i) rng_next(&rng);
  for (int64_t i = 0; i < n_rays; ++i) {
    const int64_t pick = cand[rng_below(&rng, (int64_t)cand.size())];
    const int64_t r = pick / iw, c = pick % iw;
    const int64_t y = r + 1, x = c + 1;
    const int k = jit[pick];
    out_coords[4 * i + 0] = y;
    out_coords[4 * i + 1] = x;
    out_coords[4 * i + 2] = y + DY[k];
    out_coords[4 * i + 3] = x + DX[k];
  }
  return static_cast<int64_t>(cand.size());
}

// Gather rows from a [H*W, C] buffer at flat pixel indices.
void gather_rows(const float* src, int64_t c, const int64_t* flat_idx,
                 int64_t n, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * c, src + flat_idx[i] * c,
                sizeof(float) * c);
  }
}

// Minimal .npy loader: C-order '<f4' or '<f8', any rank. Fills out
// (f32) up to max_elems; returns element count or negative error.
int64_t load_npy_f32(const char* path, float* out, int64_t max_elems) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    std::fclose(f);
    return -2;
  }
  const int major = magic[6];
  uint32_t hlen = 0;
  if (major >= 2) {
    if (std::fread(&hlen, 4, 1, f) != 1) { std::fclose(f); return -2; }
  } else {
    uint16_t h16;
    if (std::fread(&h16, 2, 1, f) != 1) { std::fclose(f); return -2; }
    hlen = h16;
  }
  std::string header(hlen, '\0');
  if (std::fread(header.data(), 1, hlen, f) != hlen) {
    std::fclose(f);
    return -2;
  }
  const bool f32 = header.find("'<f4'") != std::string::npos;
  const bool f64 = header.find("'<f8'") != std::string::npos;
  if ((!f32 && !f64) ||
      header.find("'fortran_order': False") == std::string::npos) {
    std::fclose(f);
    return -3;
  }
  // parse shape tuple
  size_t sp = header.find("'shape':");
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', lp);
  int64_t n = 1;
  {
    std::string shape = header.substr(lp + 1, rp - lp - 1);
    size_t pos = 0;
    while (pos < shape.size()) {
      while (pos < shape.size() &&
             (shape[pos] == ' ' || shape[pos] == ',')) {
        ++pos;
      }
      if (pos >= shape.size()) break;
      n *= std::strtoll(shape.c_str() + pos, nullptr, 10);
      while (pos < shape.size() && shape[pos] != ',') ++pos;
    }
  }
  if (n > max_elems) {
    std::fclose(f);
    return -4;
  }
  if (f32) {
    if (std::fread(out, 4, n, f) != static_cast<size_t>(n)) {
      std::fclose(f);
      return -5;
    }
  } else {
    std::vector<double> tmp(n);
    if (std::fread(tmp.data(), 8, n, f) != static_cast<size_t>(n)) {
      std::fclose(f);
      return -5;
    }
    for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(tmp[i]);
  }
  std::fclose(f);
  return n;
}

}  // extern "C"
