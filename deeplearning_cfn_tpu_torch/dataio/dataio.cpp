// Native data-loading core: threaded batch gather + augmentation.
//
// The reference's input pipelines ran on native threads inside MXNet/TF's
// data engines (C++ iterators, TF tf.data kernels — SURVEY.md §3.3); the
// rebuild's Python pipeline.py needs the same escape from the GIL for the
// per-image augmentation loop, which is the host-side bottleneck at TPU
// feed rates (SURVEY.md §8 hard-part #2). This file is compiled on demand
// by __init__.py (g++ -O3 -shared) and bound with ctypes — no pybind11 in the
// image, and the C ABI below keeps the surface tiny.
//
// Layout contracts: float32 NHWC images, C-contiguous; int32 indices.
// Randomness: SplitMix64 seeded per (seed, image-index) pair so results are
// deterministic and independent of thread scheduling.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// SplitMix64 — tiny, high-quality, seedable per item.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() { state = splitmix64(state); return state; }
  // Unbiased-enough bounded draw for small bounds.
  uint32_t below(uint32_t bound) { return (uint32_t)(next() % bound); }
};

// Reflect-pad index: maps i in [-pad, size+pad) into [0, size).
static inline int reflect(int i, int size) {
  if (i < 0) return -i;
  if (i >= size) return 2 * size - i - 2;
  return i;
}

static void parallel_for(int n, int nthreads, void (*fn)(int, void*),
                         void* ctx) {
  if (nthreads <= 1) {
    for (int i = 0; i < n; ++i) fn(i, ctx);
    return;
  }
  std::atomic<int> counter{0};
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int i = counter.fetch_add(1);
        if (i >= n) return;
        fn(i, ctx);
      }
    });
  }
  for (auto& th : threads) th.join();
}

struct GatherCtx {
  const float* src;
  const int32_t* idx;
  float* out;
  int h, w, c;
  int pad;
  uint64_t seed;
  bool augment;
};

static void gather_one(int b, void* p) {
  const GatherCtx& g = *static_cast<GatherCtx*>(p);
  const int h = g.h, w = g.w, c = g.c;
  const size_t img_elems = (size_t)h * w * c;
  const float* src = g.src + (size_t)g.idx[b] * img_elems;
  float* dst = g.out + (size_t)b * img_elems;
  if (!g.augment) {
    std::memcpy(dst, src, img_elems * sizeof(float));
    return;
  }
  Rng rng(splitmix64(g.seed ^ (uint64_t)g.idx[b] * 0x9e3779b97f4a7c15ull ^
                     (uint64_t)b));
  const int dy = (int)rng.below(2 * g.pad + 1) - g.pad;
  const int dx = (int)rng.below(2 * g.pad + 1) - g.pad;
  const bool flip = (rng.next() & 1) != 0;
  for (int y = 0; y < h; ++y) {
    const int sy = reflect(y + dy, h);
    const float* srow = src + (size_t)sy * w * c;
    float* drow = dst + (size_t)y * w * c;
    for (int x = 0; x < w; ++x) {
      const int sx0 = reflect(x + dx, w);
      const int sx = flip ? (w - 1 - sx0) : sx0;
      std::memcpy(drow + (size_t)x * c, srow + (size_t)sx * c,
                  c * sizeof(float));
    }
  }
}

// ---------------------------------------------------------------------------
// ImageNet hot path: u8 record -> random-resized-crop / center-crop ->
// bilinear resize -> flip -> normalize -> f32 NHWC.
//
// The RNG draw ORDER below is a contract: the Python fallback in
// data/imagenet.py replicates it draw-for-draw so native and fallback
// pipelines produce identical augmentation for the same seed.
// ---------------------------------------------------------------------------

static inline double uniform01(Rng& rng) {
  return (double)(rng.next() >> 11) * (1.0 / 9007199254740992.0);  // 53-bit
}

struct CropCtx {
  const uint64_t* src_ptrs;  // batch pointers to u8 HWC image payloads
  int src_h, src_w;
  float* out;
  int out_size;
  uint64_t seed;
  bool augment;
  const float* mean;  // [3]
  const float* stddev;  // [3]
};

static void crop_resize_one(int b, void* p) {
  const CropCtx& g = *static_cast<CropCtx*>(p);
  const int H = g.src_h, W = g.src_w, S = g.out_size;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(g.src_ptrs[b]);
  float* dst = g.out + (size_t)b * S * S * 3;
  Rng rng(splitmix64(g.seed ^ ((uint64_t)(b + 1) * 0x9e3779b97f4a7c15ull)));

  int y0 = 0, x0 = 0, ch = H, cw = W;
  bool flip = false;
  if (g.augment) {
    // torchvision-style RandomResizedCrop: area in [0.08, 1], aspect in
    // [3/4, 4/3], 10 attempts then center-crop fallback.
    const double area = (double)H * W;
    bool found = false;
    for (int attempt = 0; attempt < 10 && !found; ++attempt) {
      const double target_area = (0.08 + uniform01(rng) * 0.92) * area;
      const double log_lo = std::log(3.0 / 4.0), log_hi = std::log(4.0 / 3.0);
      const double ar = std::exp(log_lo + uniform01(rng) * (log_hi - log_lo));
      const int w_c = (int)std::floor(std::sqrt(target_area * ar) + 0.5);
      const int h_c = (int)std::floor(std::sqrt(target_area / ar) + 0.5);
      if (w_c > 0 && h_c > 0 && w_c <= W && h_c <= H) {
        y0 = (int)rng.below((uint32_t)(H - h_c + 1));
        x0 = (int)rng.below((uint32_t)(W - w_c + 1));
        ch = h_c;
        cw = w_c;
        found = true;
      }
    }
    if (!found) {
      ch = cw = H < W ? H : W;
      y0 = (H - ch) / 2;
      x0 = (W - cw) / 2;
    }
    flip = (rng.next() & 1) != 0;
  } else {
    // Eval: center crop at the EXPLICIT classic ratio — crop
    // 0.875*min(H,W), then resize to the output. With 256^2 stored
    // sources this is exactly resize-256 / center-crop-224; with any
    // other shard size the field of view stays the same instead of
    // silently widening. Constant must match data/imagenet.py
    // EVAL_CROP_RATIO (same contract style as the shared RNG).
    const double kEvalCropRatio = 0.875;
    int side = H < W ? H : W;
    // floor(x + 0.5): same tie-breaking as the Python fallback's
    // int(ratio*side + 0.5) — lround would round .5 away from zero on
    // some sizes where Python's round() goes half-to-even.
    ch = cw = (int)(kEvalCropRatio * side + 0.5);
    if (ch < 1) ch = cw = 1;
    y0 = (H - ch) / 2;
    x0 = (W - cw) / 2;
  }

  for (int r = 0; r < S; ++r) {
    const double fy = y0 + ((double)r + 0.5) * ch / S - 0.5;
    int yi = (int)std::floor(fy);
    const float wy1 = (float)(fy - yi);
    int y0i = yi < 0 ? 0 : (yi > H - 1 ? H - 1 : yi);
    int y1i = yi + 1 < 0 ? 0 : (yi + 1 > H - 1 ? H - 1 : yi + 1);
    const uint8_t* row0 = src + (size_t)y0i * W * 3;
    const uint8_t* row1 = src + (size_t)y1i * W * 3;
    float* drow = dst + (size_t)r * S * 3;
    for (int c = 0; c < S; ++c) {
      const int cc = flip ? (S - 1 - c) : c;
      const double fx = x0 + ((double)cc + 0.5) * cw / S - 0.5;
      int xi = (int)std::floor(fx);
      const float wx1 = (float)(fx - xi);
      int x0i = xi < 0 ? 0 : (xi > W - 1 ? W - 1 : xi);
      int x1i = xi + 1 < 0 ? 0 : (xi + 1 > W - 1 ? W - 1 : xi + 1);
      for (int k = 0; k < 3; ++k) {
        const float v00 = row0[(size_t)x0i * 3 + k];
        const float v01 = row0[(size_t)x1i * 3 + k];
        const float v10 = row1[(size_t)x0i * 3 + k];
        const float v11 = row1[(size_t)x1i * 3 + k];
        const float top = v00 + (v01 - v00) * wx1;
        const float bot = v10 + (v11 - v10) * wx1;
        const float v = top + (bot - top) * wy1;
        drow[(size_t)c * 3 + k] =
            (v * (1.0f / 255.0f) - g.mean[k]) / g.stddev[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// ImageNet record decode: per-batch pointers to u8 HWC payloads ->
// random-resized-crop (train) or center-crop (eval) -> bilinear resize to
// out_size -> optional flip -> per-channel normalize -> f32 NHWC out.
void dlcfn_crop_resize_norm(const uint64_t* src_ptrs, int src_h, int src_w,
                            float* out, int batch, int out_size,
                            uint64_t seed, int augment, const float* mean,
                            const float* stddev, int nthreads) {
  CropCtx ctx{src_ptrs, src_h, src_w, out, out_size, seed,
              augment != 0, mean, stddev};
  parallel_for(batch, nthreads, crop_resize_one, &ctx);
}

// Gather src[idx[b]] for b in [0, batch) into out, optionally applying
// random reflect-pad crop + horizontal flip (the CIFAR recipe).
void dlcfn_gather_augment(const float* src, const int32_t* idx, float* out,
                          int batch, int h, int w, int c, int pad,
                          uint64_t seed, int augment, int nthreads) {
  GatherCtx ctx{src, idx, out, h, w, c, pad, seed, augment != 0};
  parallel_for(batch, nthreads, gather_one, &ctx);
}

// Plain int32/float32 row gather for label/token arrays: out[b] = src[idx[b]].
void dlcfn_gather_rows_f32(const float* src, const int32_t* idx, float* out,
                           int batch, int64_t row_elems, int nthreads) {
  struct Ctx { const float* src; const int32_t* idx; float* out;
               int64_t row; } c{src, idx, out, row_elems};
  parallel_for(batch, nthreads, [](int b, void* p) {
    auto& c = *static_cast<Ctx*>(p);
    std::memcpy(c.out + (size_t)b * c.row,
                c.src + (size_t)c.idx[b] * c.row, c.row * sizeof(float));
  }, &c);
}

void dlcfn_gather_rows_i32(const int32_t* src, const int32_t* idx,
                           int32_t* out, int batch, int64_t row_elems,
                           int nthreads) {
  struct Ctx { const int32_t* src; const int32_t* idx; int32_t* out;
               int64_t row; } c{src, idx, out, row_elems};
  parallel_for(batch, nthreads, [](int b, void* p) {
    auto& c = *static_cast<Ctx*>(p);
    std::memcpy(c.out + (size_t)b * c.row,
                c.src + (size_t)c.idx[b] * c.row, c.row * sizeof(int32_t));
  }, &c);
}

int dlcfn_version() { return 2; }

}  // extern "C"
