// slio: the native IO runtime of the scan path (the port's copy of the JAX
// package's native/slio.cpp, the same entry points and output bytes).
//
// A thread-pooled PNG stack loader (46 frames a view, decode is
// zlib-inflate-bound and scales with cores) and buffered binary PLY/STL
// writers for large clouds and meshes.
//
// Plain C ABI, bound with ctypes by io/native.py, which builds this file
// with g++ at first use (io/_native_build/<hash>/libslio.so) and falls back
// to the Python readers and writers where g++ or libpng is missing.

#include <png.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PNG loading
// ---------------------------------------------------------------------------

// Probe image dimensions. Returns 0 on success.
int slio_probe_png(const char* path, int* width, int* height, int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(f);
    return 2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return 3;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *width = static_cast<int>(png_get_image_width(png, info));
  *height = static_cast<int>(png_get_image_height(png, info));
  *channels = static_cast<int>(png_get_channels(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return 0;
}

namespace {

// Decode one PNG to 8-bit grayscale into dst[h*w]. Grayscale sources are
// byte-exact; color sources convert with fixed-point BT.601 weights
// ((R*4899 + G*9617 + B*1868) >> 14), which tracks cv2 5.x's SIMD path to
// within +-1 gray level (~99% exact) — not byte-identical.
int decode_gray(const char* path, uint8_t* dst, int exp_w, int exp_h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  // raw buffer, not std::vector: a libpng error longjmps to the setjmp below,
  // which would skip a vector destructor (UB) — free on both exits instead.
  // volatile: `row` is assigned between setjmp and a potential longjmp from
  // png_read_row; without it the error path may free a stale value (C UB)
  uint8_t* volatile row = nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    std::free(row);
    return 2;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  int w = static_cast<int>(png_get_image_width(png, info));
  int h = static_cast<int>(png_get_image_height(png, info));
  // per-row streaming below is wrong for Adam7 passes; hand interlaced files
  // (rare re-exports) to the Python loader instead
  if (w != exp_w || h != exp_h ||
      png_get_interlace_type(png, info) != PNG_INTERLACE_NONE) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return 3;
  }
  png_byte depth = png_get_bit_depth(png, info);
  png_byte ctype = png_get_color_type(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (ctype == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (ctype == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  int ch = static_cast<int>(png_get_channels(png, info));

  row = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(w) * ch));
  if (!row) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return 4;
  }
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row, nullptr);
    uint8_t* out = dst + static_cast<size_t>(y) * w;
    if (ch == 1) {
      std::memcpy(out, row, w);
    } else if (ch >= 3) {  // RGB / RGBA
      for (int x = 0; x < w; ++x) {
        const uint8_t* p = row + static_cast<size_t>(x) * ch;
        // truncating descale tracks cv2 5.x's SIMD path (~99% exact, +-1)
        out[x] = static_cast<uint8_t>(
            (p[0] * 4899 + p[1] * 9617 + p[2] * 1868) >> 14);
      }
    } else {  // gray+alpha
      for (int x = 0; x < w; ++x) out[x] = row[static_cast<size_t>(x) * ch];
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  std::free(row);
  return 0;
}

}  // namespace

// Load n PNGs as 8-bit grayscale into out[n*h*w] with a thread pool.
// paths: array of n C strings. Returns 0 on success, else 100+index of the
// first failing file.
int slio_load_gray_stack(const char** paths, int n, uint8_t* out, int width,
                         int height, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> first_err(-1);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || first_err.load() >= 0) return;
      int rc = decode_gray(paths[i], out + static_cast<size_t>(i) * width * height,
                           width, height);
      if (rc != 0) {
        int expected = -1;
        first_err.compare_exchange_strong(expected, i);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  int e = first_err.load();
  return e >= 0 ? 100 + e : 0;
}

// ---------------------------------------------------------------------------
// Binary PLY writer
// ---------------------------------------------------------------------------

// Write a binary_little_endian PLY of n points. colors (u8 rgb) and normals
// (f32) may be null. Returns 0 on success.
int slio_write_ply(const char* path, int64_t n, const float* xyz,
                   const uint8_t* rgb, const float* normals) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  std::string header = "ply\nformat binary_little_endian 1.0\n";
  header += "comment slio native writer\n";
  header += "element vertex " + std::to_string(n) + "\n";
  header += "property float x\nproperty float y\nproperty float z\n";
  if (normals)
    header += "property float nx\nproperty float ny\nproperty float nz\n";
  if (rgb)
    header +=
        "property uchar red\nproperty uchar green\nproperty uchar blue\n";
  header += "end_header\n";
  if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
    std::fclose(f);
    return 2;
  }

  const size_t stride =
      3 * sizeof(float) + (normals ? 3 * sizeof(float) : 0) + (rgb ? 3 : 0);
  std::vector<uint8_t> buf;
  const int64_t kChunk = 1 << 16;
  buf.resize(static_cast<size_t>(kChunk) * stride);
  for (int64_t start = 0; start < n; start += kChunk) {
    int64_t m = std::min(kChunk, n - start);
    uint8_t* p = buf.data();
    for (int64_t i = 0; i < m; ++i) {
      const int64_t j = start + i;
      std::memcpy(p, xyz + 3 * j, 3 * sizeof(float));
      p += 3 * sizeof(float);
      if (normals) {
        std::memcpy(p, normals + 3 * j, 3 * sizeof(float));
        p += 3 * sizeof(float);
      }
      if (rgb) {
        std::memcpy(p, rgb + 3 * j, 3);
        p += 3;
      }
    }
    if (std::fwrite(buf.data(), 1, static_cast<size_t>(m) * stride, f) !=
        static_cast<size_t>(m) * stride) {
      std::fclose(f);
      return 2;
    }
  }
  // fclose flushes stdio buffers — an ENOSPC can first surface here
  return std::fclose(f) == 0 ? 0 : 3;
}

// ---------------------------------------------------------------------------
// Binary STL writer
// ---------------------------------------------------------------------------

int slio_write_stl(const char* path, int64_t n_faces, const float* vertices,
                   const int32_t* faces) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  uint8_t hdr[80] = {0};
  std::memcpy(hdr, "slio native stl", 15);
  uint32_t nf = static_cast<uint32_t>(n_faces);
  if (std::fwrite(hdr, 1, 80, f) != 80 || std::fwrite(&nf, 4, 1, f) != 1) {
    std::fclose(f);
    return 2;
  }

  struct __attribute__((packed)) Tri {
    float n[3];
    float v[9];
    uint16_t attr;
  };
  static_assert(sizeof(Tri) == 50, "STL record must be 50 bytes");
  const int64_t kChunk = 1 << 14;
  std::vector<Tri> buf(static_cast<size_t>(kChunk));
  for (int64_t start = 0; start < n_faces; start += kChunk) {
    int64_t m = std::min(kChunk, n_faces - start);
    for (int64_t i = 0; i < m; ++i) {
      const int32_t* face = faces + 3 * (start + i);
      Tri& t = buf[static_cast<size_t>(i)];
      const float* a = vertices + 3 * face[0];
      const float* b = vertices + 3 * face[1];
      const float* c = vertices + 3 * face[2];
      float u[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      float v[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      float nx = u[1] * v[2] - u[2] * v[1];
      float ny = u[2] * v[0] - u[0] * v[2];
      float nz = u[0] * v[1] - u[1] * v[0];
      float len = std::sqrt(nx * nx + ny * ny + nz * nz);
      if (len > 0) {
        nx /= len;
        ny /= len;
        nz /= len;
      }
      t.n[0] = nx;
      t.n[1] = ny;
      t.n[2] = nz;
      std::memcpy(t.v + 0, a, 12);
      std::memcpy(t.v + 3, b, 12);
      std::memcpy(t.v + 6, c, 12);
      t.attr = 0;
    }
    if (std::fwrite(buf.data(), 50, static_cast<size_t>(m), f) !=
        static_cast<size_t>(m)) {
      std::fclose(f);
      return 2;
    }
  }
  return std::fclose(f) == 0 ? 0 : 3;
}

// Version tag for the ctypes binding to sanity-check.
int slio_abi_version() { return 1; }

}  // extern "C"
