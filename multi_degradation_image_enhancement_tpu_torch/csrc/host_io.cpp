// Host-side image IO of the PyTorch port's data loaders: libjpeg / libpng
// decodes with a bilinear resize or letterbox fused into the caller's batch
// buffer, a libpng writer, and a std::thread fan-out per batch.
//
// The port's own copy of multi_degradation_image_enhancement_tpu's
// native/mdie_io.cpp, with the same C ABI (mdie_decode_image,
// mdie_decode_batch, mdie_encode_png, mdie_encode_png_batch), the same modes
// (0 exact size, 1 bilinear resize, 2 letterbox with pad 128) and the same
// resize arithmetic, so its pixels are the JAX package's.  The decoder and
// the resize are the specification: the two files are kept in lockstep, a
// fix to one is made in both, and tests/test_torch_host_io.py holds the two
// engines' pixels and PNG bytes equal bit for bit.
//
// Host code, not a GPU kernel: data/io_native.py builds it with g++ at first
// use (-O3 -fPIC -std=c++17 -shared ... -ljpeg -lpng -lz -lpthread) and
// binds it with ctypes.  All functions return 0 on success, negative error
// codes otherwise (the batch calls: the number of failures).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

// ---------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG ----

bool decode_png(FILE* f, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);

  // normalize anything to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->rgb.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// -------------------------------------------------------------- decode ----

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);
  } else if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  }
  fclose(f);
  return ok && out->w > 0 && out->h > 0;
}

// -------------------------------------------------------------- resize ----

// Bilinear resize with half-pixel centers (cv2/PIL-family convention).
// Separable two-pass with precomputed per-column coefficients: horizontal
// pass into a float row cache (two source rows live at a time), then the
// vertical lerp — O(1) coordinate math per pixel, vectorizable inner loops.
void resize_bilinear(const Image& src, uint8_t* dst, int dh, int dw) {
  const float sy = float(src.h) / dh;
  const float sx = float(src.w) / dw;

  std::vector<int> xi0(dw), xi1(dw);
  std::vector<float> xt(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    if (fx > src.w - 1) fx = float(src.w - 1);
    int x0 = int(fx);
    xi0[x] = x0 * 3;
    xi1[x] = (x0 + 1 < src.w ? x0 + 1 : src.w - 1) * 3;
    xt[x] = fx - x0;
  }

  // horizontal-pass row cache for two source rows
  std::vector<float> row_a(size_t(dw) * 3), row_b(size_t(dw) * 3);
  int cached_a = -1, cached_b = -1;

  auto hpass = [&](int sy_row, std::vector<float>& out_row) {
    const uint8_t* s = src.rgb.data() + size_t(sy_row) * src.w * 3;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p0 = s + xi0[x];
      const uint8_t* p1 = s + xi1[x];
      const float t = xt[x];
      float* o = out_row.data() + size_t(x) * 3;
      o[0] = p0[0] + t * (p1[0] - p0[0]);
      o[1] = p0[1] + t * (p1[1] - p0[1]);
      o[2] = p0[2] + t * (p1[2] - p0[2]);
    }
  };

  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > src.h - 1) fy = float(src.h - 1);
    int y0 = int(fy);
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    float ty = fy - y0;

    if (cached_a != y0) {
      if (cached_b == y0) {
        std::swap(row_a, row_b);
        std::swap(cached_a, cached_b);
      } else {
        hpass(y0, row_a);
        cached_a = y0;
      }
    }
    if (cached_b != y1) {
      hpass(y1, row_b);
      cached_b = y1;
    }

    const float* a = row_a.data();
    const float* b = row_b.data();
    uint8_t* d = dst + size_t(y) * dw * 3;
    const int n = dw * 3;
    for (int i = 0; i < n; ++i) {
      float v = a[i] + ty * (b[i] - a[i]);
      int iv = int(v + 0.5f);
      d[i] = uint8_t(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
    }
  }
}

// Letterbox: aspect-preserving resize + centered gray pad
// (reference generate_paired_degradation_dataset.py:81-101 semantics).
void letterbox(const Image& src, uint8_t* dst, int dh, int dw, uint8_t pad) {
  float scale = std::min(float(dw) / src.w, float(dh) / src.h);
  int nw = std::max(1, int(src.w * scale + 0.5f));
  int nh = std::max(1, int(src.h * scale + 0.5f));
  std::vector<uint8_t> resized(size_t(nw) * nh * 3);
  resize_bilinear(src, resized.data(), nh, nw);
  memset(dst, pad, size_t(dh) * dw * 3);
  int x0 = (dw - nw) / 2;
  int y0 = (dh - nh) / 2;
  for (int y = 0; y < nh; ++y) {
    memcpy(dst + ((size_t(y0) + y) * dw + x0) * 3,
           resized.data() + size_t(y) * nw * 3, size_t(nw) * 3);
  }
}

int decode_one(const char* path, uint8_t* out, int th, int tw, int mode) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  if (mode == 2) {
    letterbox(img, out, th, tw, 128);
  } else if (img.h == th && img.w == tw) {
    memcpy(out, img.rgb.data(), size_t(th) * tw * 3);
  } else if (mode == 1) {
    resize_bilinear(img, out, th, tw);
  } else {
    return -2;  // size mismatch with resize disabled
  }
  return 0;
}

// PNG write of one RGB8 buffer.  compress_level: zlib 0..9 (PIL default 6;
// restoration outputs are near-noise so level 1 trades ~10% size for
// several-fold faster deflate — the serving writer's default).
int encode_png_one(const char* path, const uint8_t* rgb, int h, int w,
                   int compress_level) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                            nullptr, nullptr);
  if (!png) { fclose(fp); return -3; }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return -3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -4;
  }
  png_init_io(png, fp);
  if (compress_level >= 0 && compress_level <= 9)
    png_set_compression_level(png, compress_level);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  for (int y = 0; y < h; ++y)
    png_write_row(png, const_cast<png_bytep>(rgb + size_t(y) * w * 3));
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

}  // namespace

extern "C" {

// mode: 0 = exact size required, 1 = bilinear resize, 2 = letterbox(pad 128)
int mdie_decode_image(const char* path, uint8_t* out, int target_h, int target_w, int mode) {
  return decode_one(path, out, target_h, target_w, mode);
}

// Decode n images into a contiguous [n, th, tw, 3] uint8 batch buffer.
// n_threads <= 1 → sequential. Returns number of failures (0 = all good);
// failed slots are zero-filled.
int mdie_decode_batch(const char** paths, int n, uint8_t* out, int target_h,
                      int target_w, int mode, int n_threads) {
  const size_t stride = size_t(target_h) * target_w * 3;
  std::vector<int> fails(std::max(1, n_threads), 0);
  auto work = [&](int tid, int begin, int end) {
    for (int i = begin; i < end; ++i) {
      if (decode_one(paths[i], out + stride * i, target_h, target_w, mode) != 0) {
        memset(out + stride * i, 0, stride);
        fails[tid]++;
      }
    }
  };
  if (n_threads <= 1 || n <= 1) {
    work(0, 0, n);
  } else {
    int t = std::min(n_threads, n);
    std::vector<std::thread> threads;
    int per = (n + t - 1) / t;
    for (int k = 0; k < t; ++k)
      threads.emplace_back(work, k, k * per, std::min(n, (k + 1) * per));
    for (auto& th : threads) th.join();
  }
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

// Encode one RGB8 [h, w, 3] buffer to a PNG file.  0 on success.
int mdie_encode_png(const char* path, const uint8_t* rgb, int h, int w,
                    int compress_level) {
  return encode_png_one(path, rgb, h, w, compress_level);
}

// Encode n images from a contiguous [n, h, w, 3] buffer to per-image paths
// with a thread fan-out.  Returns the number of failures (0 = all good).
int mdie_encode_png_batch(const char** paths, const uint8_t* rgb, int n,
                          int h, int w, int compress_level, int n_threads) {
  const size_t stride = size_t(h) * w * 3;
  std::vector<int> fails(std::max(1, n_threads), 0);
  auto work = [&](int tid, int begin, int end) {
    for (int i = begin; i < end; ++i) {
      if (encode_png_one(paths[i], rgb + stride * i, h, w, compress_level) != 0)
        fails[tid]++;
    }
  };
  if (n_threads <= 1 || n <= 1) {
    work(0, 0, n);
  } else {
    int t = std::min(n_threads, n);
    std::vector<std::thread> threads;
    int per = (n + t - 1) / t;
    for (int k = 0; k < t; ++k)
      threads.emplace_back(work, k, k * per, std::min(n, (k + 1) * per));
    for (auto& th : threads) th.join();
  }
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

}  // extern "C"
