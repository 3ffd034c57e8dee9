// Dense multi-scale SIFT, host-side native kernel.
//
// Copy of keystone_tpu/native/src/dsift.cpp. Host counterpart of the port's
// card SIFT (keystone_tpu_torch/ops/images/sift.py) and the capability
// equivalent of the reference's VLFeat JNI kernel (reference:
// src/main/cpp/VLFeat.cxx:37-292 getMultiScaleDSIFTs_f). Same algorithm
// spec as the card path — flat-window dense SIFT: per-scale Gaussian
// smoothing (sigma = bin/6, edge padding), central-difference gradients
// with one-sided borders, 8 orientation planes with circular triangular
// interpolation, separable triangular spatial binning (zero padding), 4x4
// descriptor grids, normalize -> clamp 0.2 -> renormalize -> contrast-
// threshold zeroing -> min(512*v, 255) quantization. OpenMP parallel over
// images (the reference parallelizes per partition on Spark executors).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kOrientations = 8;
constexpr int kSpatialBins = 4;
constexpr int kDescriptorSize = kOrientations * kSpatialBins * kSpatialBins;
constexpr float kContrastThreshold = 0.005f;
constexpr float kMagnif = 6.0f;

struct ScaleGeom {
  int b;      // bin size
  int step;   // sampling step
  int off;    // grid origin offset
  int nx, ny; // descriptor grid dims (0 if scale inactive)
};

// Floor division (C++ '/' truncates toward zero; the XLA grid math uses
// Python floor division, and a negative numerator must stay negative here
// or an almost-fitting scale gains a phantom grid row reading off the end
// of the binned planes).
inline int floordiv(int a, int b) {
  int q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

ScaleGeom scale_geom(int xd, int yd, int s, int step_size, int bin_size,
                     int scales, int scale_step) {
  ScaleGeom g;
  g.b = bin_size + 2 * s;
  g.step = step_size + s * scale_step;
  g.off = std::max(0, (1 + 2 * scales) - 3 * s);
  int span = (kSpatialBins - 1) * g.b;
  g.nx = floordiv(xd - 1 - g.off - span, g.step) + 1;
  g.ny = floordiv(yd - 1 - g.off - span, g.step) + 1;
  if (g.nx <= 0 || g.ny <= 0) g.nx = g.ny = 0;
  return g;
}

std::vector<float> gaussian_kernel(float sigma) {
  int radius = std::max(1, (int)std::ceil(4.0 * sigma));
  std::vector<float> k(2 * radius + 1);
  double sum = 0.0;
  for (int i = -radius; i <= radius; ++i) {
    double v = std::exp(-0.5 * (double)i * i / ((double)sigma * sigma));
    k[i + radius] = (float)v;
    sum += v;
  }
  for (auto& v : k) v = (float)(v / sum);
  return k;
}

std::vector<float> triangular_kernel(int b) {
  // w(u) = 1 - |u|/b for |u| < b
  std::vector<float> k(2 * b - 1);
  for (int i = -(b - 1); i <= b - 1; ++i)
    k[i + b - 1] = 1.0f - (float)std::abs(i) / (float)b;
  return k;
}

// Separable same-size convolution over one (xd, yd) plane.
// edge=true replicates borders (Gaussian smoothing), else zero padding
// (spatial binning).
void sep_conv(const float* in, float* out, float* tmp, int xd, int yd,
              const std::vector<float>& k, bool edge) {
  const int r = ((int)k.size() - 1) / 2;
  // along x (rows): tmp[x, y] = sum_i k[i] * in[x + r - i, y]  (true conv)
  for (int x = 0; x < xd; ++x) {
    float* trow = tmp + (size_t)x * yd;
    std::memset(trow, 0, sizeof(float) * yd);
    for (int i = 0; i < (int)k.size(); ++i) {
      int sx = x + r - i;
      if (sx < 0) { if (!edge) continue; sx = 0; }
      if (sx >= xd) { if (!edge) continue; sx = xd - 1; }
      const float kv = k[i];
      const float* srow = in + (size_t)sx * yd;
      for (int y = 0; y < yd; ++y) trow[y] += kv * srow[y];
    }
  }
  // along y (cols)
  for (int x = 0; x < xd; ++x) {
    const float* trow = tmp + (size_t)x * yd;
    float* orow = out + (size_t)x * yd;
    for (int y = 0; y < yd; ++y) {
      float acc = 0.0f;
      for (int i = 0; i < (int)k.size(); ++i) {
        int sy = y + r - i;
        if (sy < 0) { if (!edge) continue; sy = 0; }
        if (sy >= yd) { if (!edge) continue; sy = yd - 1; }
        acc += k[i] * trow[sy];
      }
      orow[y] = acc;
    }
  }
}

void one_image_one_scale(const float* img, int xd, int yd, const ScaleGeom& g,
                         float* out /* nx*ny*128 */) {
  const size_t plane = (size_t)xd * yd;
  std::vector<float> smoothed(plane), tmp(plane);
  sep_conv(img, smoothed.data(), tmp.data(), xd, yd,
           gaussian_kernel((float)g.b / kMagnif), /*edge=*/true);

  // Gradients: central differences inside, one-sided at borders.
  std::vector<float> mag(plane), theta(plane);
  for (int x = 0; x < xd; ++x) {
    for (int y = 0; y < yd; ++y) {
      const int xm = x == 0 ? 0 : x - 1, xp = x == xd - 1 ? xd - 1 : x + 1;
      const int ym = y == 0 ? 0 : y - 1, yp = y == yd - 1 ? yd - 1 : y + 1;
      const float sx = (x == 0 || x == xd - 1) ? 1.0f : 0.5f;
      const float sy = (y == 0 || y == yd - 1) ? 1.0f : 0.5f;
      float gx = sx * (smoothed[(size_t)xp * yd + y] - smoothed[(size_t)xm * yd + y]);
      float gy = sy * (smoothed[(size_t)x * yd + yp] - smoothed[(size_t)x * yd + ym]);
      mag[(size_t)x * yd + y] = std::sqrt(gx * gx + gy * gy);
      float th = std::atan2(gy, gx);
      if (th < 0.0f) th += 2.0f * (float)M_PI;
      theta[(size_t)x * yd + y] = th * (kOrientations / (2.0f * (float)M_PI));
    }
  }

  // Orientation planes with circular triangular weights, then spatial
  // triangular binning.
  const auto tri = triangular_kernel(g.b);
  std::vector<float> po(plane), binned((size_t)kOrientations * plane);
  for (int o = 0; o < kOrientations; ++o) {
    for (size_t i = 0; i < plane; ++i) {
      float dist = std::fabs(theta[i] - (float)o);
      dist = std::min(dist, kOrientations - dist);
      po[i] = dist < 1.0f ? mag[i] * (1.0f - dist) : 0.0f;
    }
    sep_conv(po.data(), binned.data() + (size_t)o * plane, tmp.data(), xd, yd,
             tri, /*edge=*/false);
  }

  // Gather 4x4 grids per keypoint; feature order: ybin slowest, xbin, then
  // orientation fastest (matches ops/images/sift.py layout).
  for (int ix = 0; ix < g.nx; ++ix) {
    for (int iy = 0; iy < g.ny; ++iy) {
      float* desc = out + ((size_t)ix * g.ny + iy) * kDescriptorSize;
      for (int yb = 0; yb < kSpatialBins; ++yb) {
        for (int xb = 0; xb < kSpatialBins; ++xb) {
          const int px = g.off + ix * g.step + xb * g.b;
          const int py = g.off + iy * g.step + yb * g.b;
          for (int o = 0; o < kOrientations; ++o) {
            desc[(yb * kSpatialBins + xb) * kOrientations + o] =
                binned[(size_t)o * plane + (size_t)px * yd + py];
          }
        }
      }
      // normalize -> clamp -> renormalize -> contrast threshold -> quantize
      const float eps = 1e-10f;
      float n1 = 0.0f;
      for (int i = 0; i < kDescriptorSize; ++i) n1 += desc[i] * desc[i];
      n1 = std::sqrt(n1);
      if (n1 <= kContrastThreshold) {
        std::memset(desc, 0, sizeof(float) * kDescriptorSize);
        continue;
      }
      float n2 = 0.0f;
      for (int i = 0; i < kDescriptorSize; ++i) {
        desc[i] = std::min(desc[i] / std::max(n1, eps), 0.2f);
        n2 += desc[i] * desc[i];
      }
      n2 = std::max(std::sqrt(n2), eps);
      for (int i = 0; i < kDescriptorSize; ++i)
        desc[i] = std::min(std::floor(512.0f * desc[i] / n2), 255.0f);
    }
  }
}

}  // namespace

extern "C" {

// Total descriptors per image across active scales.
int ks_dsift_descriptor_count(int xd, int yd, int step_size, int bin_size,
                              int scales, int scale_step) {
  int total = 0;
  for (int s = 0; s < scales; ++s) {
    ScaleGeom g = scale_geom(xd, yd, s, step_size, bin_size, scales, scale_step);
    total += g.nx * g.ny;
  }
  return total;
}

// images: n contiguous (xd, yd) float planes. out: n * total_desc * 128.
void ks_dsift(const float* images, int n, int xd, int yd, int step_size,
              int bin_size, int scales, int scale_step, float* out) {
  const int total =
      ks_dsift_descriptor_count(xd, yd, step_size, bin_size, scales, scale_step);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n; ++i) {
    const float* img = images + (size_t)i * xd * yd;
    float* img_out = out + (size_t)i * total * kDescriptorSize;
    size_t offset = 0;
    for (int s = 0; s < scales; ++s) {
      ScaleGeom g =
          scale_geom(xd, yd, s, step_size, bin_size, scales, scale_step);
      if (g.nx == 0) continue;
      one_image_one_scale(img, xd, yd, g,
                          img_out + offset * kDescriptorSize);
      offset += (size_t)g.nx * g.ny;
    }
  }
}

}  // extern "C"
