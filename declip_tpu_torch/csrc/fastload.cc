// fastload: native data-path primitives for the host input path of
// declip_tpu_torch (the port's copy of native/fastload.cc).
//
// The role NVIDIA DALI's C++ pipeline plays in the reference
// (prototype/data/nvidia_dali_dataloader.py, SURVEY.md §2.9): fast JPEG
// decode (with libjpeg DCT prescaling), fused crop+bilinear-resize to the
// training resolution, and an mmap newline scanner for fseek-mode JSONL
// metafiles (clip_dataset.py:66-77 builds the same index in Python).
//
// Exposed as a plain C ABI consumed via ctypes (declip_tpu_torch/data/
// native.py). All functions are thread-safe; ctypes releases the GIL during
// the call, so decodes on loader threads run in parallel.
//
// Built at first use by native.py: g++ -O3 -march=native -fPIC -shared,
// linked with -ljpeg (needs libjpeg's headers, jpeglib.h).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// JSONL newline index: returns the number of lines and writes a malloc'd
// array of byte offsets (start of each line) into *out_offsets.
// Caller frees with fl_free. Returns -1 on error.
// ---------------------------------------------------------------------------
int64_t fl_scan_offsets(const char* path, int64_t** out_offsets) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  size_t size = static_cast<size_t>(st.st_size);
  if (size == 0) {
    close(fd);
    *out_offsets = nullptr;
    return 0;
  }
  const char* data =
      static_cast<const char*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return -1;

  // first pass: count lines (non-empty starts)
  int64_t capacity = 1024;
  int64_t* offsets = static_cast<int64_t*>(malloc(capacity * sizeof(int64_t)));
  if (offsets == nullptr) {
    munmap(const_cast<char*>(data), size);
    return -1;
  }
  int64_t count = 0;
  size_t pos = 0;
  while (pos < size) {
    // skip blank lines
    if (data[pos] != '\n') {
      if (count == capacity) {
        capacity *= 2;
        int64_t* grown = static_cast<int64_t*>(
            realloc(offsets, capacity * sizeof(int64_t)));
        if (grown == nullptr) {
          free(offsets);
          munmap(const_cast<char*>(data), size);
          return -1;
        }
        offsets = grown;
      }
      offsets[count++] = static_cast<int64_t>(pos);
    }
    const char* nl =
        static_cast<const char*>(memchr(data + pos, '\n', size - pos));
    if (nl == nullptr) break;
    pos = static_cast<size_t>(nl - data) + 1;
  }
  munmap(const_cast<char*>(data), size);
  if (count == 0) {
    free(offsets);
    offsets = nullptr;
  }
  *out_offsets = offsets;
  return count;
}

void fl_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------
struct FlJpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void fl_jpeg_error_exit(j_common_ptr cinfo) {
  FlJpegError* err = reinterpret_cast<FlJpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Probe the dimensions of a JPEG. Returns 0 on success.
int fl_jpeg_dims(const uint8_t* data, int64_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  FlJpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = fl_jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<size_t>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode JPEG bytes to RGB8. If min_side > 0, uses libjpeg's DCT scaling to
// decode at the smallest scale whose short side is still >= min_side (a large
// speedup for the decode->crop->224 path). Returns a malloc'd buffer in
// *out_rgb (caller frees with fl_free); writes decoded dims. -1 on error.
int fl_jpeg_decode(const uint8_t* data, int64_t len, int min_side,
                   uint8_t** out_rgb, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  FlJpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = fl_jpeg_error_exit;
  // volatile: modified between setjmp and longjmp (C99 7.13.2.1) — without
  // it the error path would free indeterminate register-restored pointers
  uint8_t* volatile buf = nullptr;
  uint8_t* volatile row = nullptr;
  if (setjmp(jerr.jump)) {
    free(buf);
    free(row);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<size_t>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  if (min_side > 0) {
    // libjpeg supports scale_num/8 for scale_num in 1..16
    int short_side = std::min(static_cast<int>(cinfo.image_width),
                              static_cast<int>(cinfo.image_height));
    int num = 8;
    while (num > 1 && short_side * (num - 1) / 8 >= min_side) num--;
    cinfo.scale_num = static_cast<unsigned>(num);
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  int w = static_cast<int>(cinfo.output_width);
  int h = static_cast<int>(cinfo.output_height);
  int stride = w * static_cast<int>(cinfo.output_components);
  buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(h) * w * 3));
  if (buf == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (cinfo.output_components != 3) {
    // grayscale/CMYK: decode then expand — handle gray (1ch) inline
    row = static_cast<uint8_t*>(malloc(static_cast<size_t>(stride)));
    if (row == nullptr) {
      free(buf);
      jpeg_destroy_decompress(&cinfo);
      return -1;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
      int y = static_cast<int>(cinfo.output_scanline);
      JSAMPROW rows[1] = {row};
      jpeg_read_scanlines(&cinfo, rows, 1);
      uint8_t* dst = buf + static_cast<size_t>(y) * w * 3;
      for (int x = 0; x < w; x++) {
        uint8_t g = row[x * cinfo.output_components];
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = g;
      }
    }
    free(row);
    row = nullptr;
  } else {
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW rows[1] = {
          buf + static_cast<size_t>(cinfo.output_scanline) * stride};
      jpeg_read_scanlines(&cinfo, rows, 1);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_rgb = buf;
  *out_w = w;
  *out_h = h;
  return 0;
}

// ---------------------------------------------------------------------------
// Fused crop + bilinear resize: src RGB8 [sh, sw], crop box (cx, cy, cw, ch),
// output RGB8 [oh, ow] written into caller-provided out (ow*oh*3 bytes).
// Matches PIL's Image.resize(box=...) bilinear semantics closely enough for
// augmentation (sampling grid aligned to pixel centers).
// ---------------------------------------------------------------------------
void fl_crop_resize_bilinear(const uint8_t* src, int sw, int sh, float cx,
                             float cy, float cw, float ch, uint8_t* out,
                             int ow, int oh) {
  const float x_ratio = cw / ow;
  const float y_ratio = ch / oh;
  for (int oy = 0; oy < oh; oy++) {
    float sy = cy + (oy + 0.5f) * y_ratio - 0.5f;
    int y0 = static_cast<int>(sy);
    float fy = sy - y0;
    if (sy < 0) {
      y0 = 0;
      fy = 0;
    }
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::min(std::max(y0, 0), sh - 1);
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* dst = out + static_cast<size_t>(oy) * ow * 3;
    for (int ox = 0; ox < ow; ox++) {
      float sx = cx + (ox + 0.5f) * x_ratio - 0.5f;
      int x0 = static_cast<int>(sx);
      float fx = sx - x0;
      if (sx < 0) {
        x0 = 0;
        fx = 0;
      }
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::min(std::max(x0, 0), sw - 1);
      for (int c = 0; c < 3; c++) {
        float top = r0[x0 * 3 + c] * (1 - fx) + r0[x1 * 3 + c] * fx;
        float bot = r1[x0 * 3 + c] * (1 - fx) + r1[x1 * 3 + c] * fx;
        float val = top * (1 - fy) + bot * fy;
        dst[ox * 3 + c] = static_cast<uint8_t>(val + 0.5f);
      }
    }
  }
}

// One-call path: decode + crop + resize into caller buffer. Crop box in
// ORIGINAL image coordinates; rescaled automatically if DCT prescale kicked
// in. Returns 0 on success.
int fl_decode_crop_resize(const uint8_t* data, int64_t len, float cx, float cy,
                          float cw, float ch, uint8_t* out, int ow, int oh) {
  int full_w, full_h;
  if (fl_jpeg_dims(data, len, &full_w, &full_h) != 0) return -1;
  // decode at a scale where the crop is still >= output size
  float crop_short = std::min(cw, ch);
  float frac = crop_short / std::min(full_w, full_h);
  int min_side = frac > 0 ? static_cast<int>(std::min(ow, oh) / frac) + 2 : 0;
  uint8_t* rgb;
  int w, h;
  if (fl_jpeg_decode(data, len, min_side, &rgb, &w, &h) != 0) return -1;
  float sx = static_cast<float>(w) / full_w;
  float sy = static_cast<float>(h) / full_h;
  fl_crop_resize_bilinear(rgb, w, h, cx * sx, cy * sy, cw * sx, ch * sy, out,
                          ow, oh);
  free(rgb);
  return 0;
}

}  // extern "C"
