// Batch JPEG decode + bilinear resize, host-native ingest kernel.
//
// Copy of keystone_tpu/native/src/decode.cpp: the analog of the reference's
// executor-side ImageIO decode (reference: loaders/ImageLoaderUtils.scala:
// 84-88, utils/images/ImageConversions.scala:5-80). Decode fans out over
// OpenMP threads with libjpeg doing the hot loop. Output matches the
// framework's image convention — (X=rows, Y=cols, C) float arrays in BGR
// channel order (keystone_tpu_torch/utils/image.py load_image).

#include <algorithm>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

void silent_output(j_common_ptr) {}

// Decode one JPEG into an RGB byte buffer. Returns false on any error.
// min_x/min_y (>0): the caller's resample target — decode is DCT-domain
// scaled to the smallest 1/2^k size still >= the target in both dims, so
// IDCT + memory traffic scale with output pixels, not source pixels (the
// bilinear resample that follows eats the remaining gap). 0 disables.
bool decode_rgb(const unsigned char* buf, long long len, std::vector<unsigned char>& rgb,
                int& width, int& height, int min_x, int min_y) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (min_x > 0 && min_y > 0) {
    // ceil division: libjpeg's scaled output is ceil(dim/denom)
    // (jdiv_round_up), so floor would reject valid just-under-2^k sizes
    for (int d = 8; d >= 2; d /= 2) {
      if ((int)((cinfo.image_height + d - 1) / d) >= min_x &&
          (int)((cinfo.image_width + d - 1) / d) >= min_y) {
        cinfo.scale_num = 1;
        cinfo.scale_denom = d;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  width = cinfo.output_width;
  height = cinfo.output_height;
  if (width <= 0 || height <= 0 || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  rgb.resize((size_t)width * height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + (size_t)cinfo.output_scanline * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

// bufs[i]: raw JPEG bytes of length lens[i]. out: (n, out_x, out_y, 3)
// float32 BGR. ok[i] = 1 on success, 0 on decode failure (row left zero).
// out_x and out_y must be positive — every image is resampled to that
// fixed shape (ragged native sizes cannot share one output buffer).
void ks_decode_jpeg_batch(const unsigned char* const* bufs,
                          const long long* lens, int n, int out_x, int out_y,
                          float* out, unsigned char* ok) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n; ++i) {
    std::vector<unsigned char> rgb;
    int w = 0, h = 0;
    ok[i] = 0;
    float* dst = out + (size_t)i * out_x * out_y * 3;
    std::memset(dst, 0, sizeof(float) * (size_t)out_x * out_y * 3);
    if (!decode_rgb(bufs[i], lens[i], rgb, w, h, out_x, out_y)) continue;
    // scale factors map output pixel centers into source coordinates
    const float sx = out_x > 1 ? (float)(h - 1) / (float)(out_x - 1) : 0.0f;
    const float sy = out_y > 1 ? (float)(w - 1) / (float)(out_y - 1) : 0.0f;
    // Bilinear resample with column neighbors/weights precomputed once
    // (identical for every row and channel) and row neighbors hoisted
    // per row; neighbor indices clamped independently so 1-pixel
    // wide/tall sources stay in bounds.
    std::vector<int> y0s(out_y), y1s(out_y);
    std::vector<float> ays(out_y);
    for (int y = 0; y < out_y; ++y) {
      float fy = y * sy;
      int y0 = (int)fy;
      if (y0 > w - 1) y0 = w - 1;
      if (y0 < 0) y0 = 0;
      y0s[y] = y0;
      y1s[y] = std::min(y0 + 1, w - 1);
      ays[y] = fy - y0;
    }
    for (int x = 0; x < out_x; ++x) {
      float fx = x * sx;
      int x0 = (int)fx;
      if (x0 > h - 1) x0 = h - 1;
      if (x0 < 0) x0 = 0;
      const int x1 = std::min(x0 + 1, h - 1);
      const float ax = fx - x0;
      const unsigned char* r0 = rgb.data() + (size_t)x0 * w * 3;
      const unsigned char* r1 = rgb.data() + (size_t)x1 * w * 3;
      float* px = dst + (size_t)x * out_y * 3;
      for (int y = 0; y < out_y; ++y, px += 3) {
        const int o0 = y0s[y] * 3, o1 = y1s[y] * 3;
        const float ay = ays[y];
        // channel c of source RGB -> output BGR (px[2-c])
        for (int c = 0; c < 3; ++c) {
          const float top = r0[o0 + c] * (1 - ay) + r0[o1 + c] * ay;
          const float bot = r1[o0 + c] * (1 - ay) + r1[o1 + c] * ay;
          px[2 - c] = top * (1 - ax) + bot * ax;
        }
      }
    }
    ok[i] = 1;
  }
}

// Cap the decode pool (bench scaling curves; 0 = library default).
void ks_set_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

// Probe: returns 1 and fills (height=rows, width=cols) without full decode.
int ks_jpeg_dims(const unsigned char* buf, long long len, int* rows, int* cols) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  *rows = cinfo.image_height;
  *cols = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

}  // extern "C"
