// Native image decode + resize for the input pipeline of
// patchgan_tpu_torch: the port's own copy of the JAX package's decoder,
// so both packages decode a file to the same pixels.
//
// Fused decode+resize straight into the caller's numpy buffer, with no
// intermediate image objects:
//
//  - JPEG (images): libjpeg DCT-domain prescaling (1/2, 1/4, 1/8) picks
//    the smallest decode >= the target, then bilinear (align_corners =
//    false, as torchvision's Resize without antialias) down to the
//    target, emitting float32 RGB in [0, 1] or rounded uint8.
//  - PNG (masks): libpng grayscale decode + NEAREST resize to int32
//    labelmaps (label values must survive resizing exactly).
//
// Exposed as a plain C ABI for ctypes (no pybind11, no PyTorch headers).
// ctypes releases the GIL for the call duration, so the loader's thread
// pool decodes in true parallel.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// bilinear resize, align_corners=false, HWC uint8 -> uint8 (rounded)
void bilinear_u8_to_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
    const float ry = static_cast<float>(sh) / dh;
    const float rx = static_cast<float>(sw) / dw;
    for (int y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * ry - 0.5f;
        fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
        int y0 = static_cast<int>(fy);
        int y1 = std::min(y0 + 1, sh - 1);
        float wy = fy - y0;
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * rx - 0.5f;
            fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
            int x0 = static_cast<int>(fx);
            int x1 = std::min(x0 + 1, sw - 1);
            float wx = fx - x0;
            const uint8_t* p00 = src + (y0 * sw + x0) * c;
            const uint8_t* p01 = src + (y0 * sw + x1) * c;
            const uint8_t* p10 = src + (y1 * sw + x0) * c;
            const uint8_t* p11 = src + (y1 * sw + x1) * c;
            uint8_t* out = dst + (y * dw + x) * c;
            for (int k = 0; k < c; ++k) {
                float top = p00[k] + (p01[k] - p00[k]) * wx;
                float bot = p10[k] + (p11[k] - p10[k]) * wx;
                float v = top + (bot - top) * wy;
                out[k] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

// bilinear resize, align_corners=false, HWC uint8 -> float32 scaled 1/255
void bilinear_u8_to_f32(const uint8_t* src, int sh, int sw, int c,
                        float* dst, int dh, int dw) {
    const float scale = 1.0f / 255.0f;
    const float ry = static_cast<float>(sh) / dh;
    const float rx = static_cast<float>(sw) / dw;
    for (int y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * ry - 0.5f;
        fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
        int y0 = static_cast<int>(fy);
        int y1 = std::min(y0 + 1, sh - 1);
        float wy = fy - y0;
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * rx - 0.5f;
            fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
            int x0 = static_cast<int>(fx);
            int x1 = std::min(x0 + 1, sw - 1);
            float wx = fx - x0;
            const uint8_t* p00 = src + (y0 * sw + x0) * c;
            const uint8_t* p01 = src + (y0 * sw + x1) * c;
            const uint8_t* p10 = src + (y1 * sw + x0) * c;
            const uint8_t* p11 = src + (y1 * sw + x1) * c;
            float* out = dst + (y * dw + x) * c;
            for (int k = 0; k < c; ++k) {
                float top = p00[k] + (p01[k] - p00[k]) * wx;
                float bot = p10[k] + (p11[k] - p10[k]) * wx;
                out[k] = (top + (bot - top) * wy) * scale;
            }
        }
    }
}

void nearest_u8_to_i32(const uint8_t* src, int sh, int sw, int32_t* dst,
                       int dh, int dw) {
    const float ry = static_cast<float>(sh) / dh;
    const float rx = static_cast<float>(sw) / dw;
    for (int y = 0; y < dh; ++y) {
        int sy = std::min(static_cast<int>((y + 0.5f) * ry), sh - 1);
        for (int x = 0; x < dw; ++x) {
            int sx = std::min(static_cast<int>((x + 0.5f) * rx), sw - 1);
            dst[y * dw + x] = src[sy * sw + sx];
        }
    }
}

}  // namespace

extern "C" {

// returns 0 on success; fills native height/width
int pg_jpeg_info(const unsigned char* buf, long len, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    JpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_error_exit;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    *h = cinfo.image_height;
    *w = cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// decode RGB and bilinear-resize to (out_h, out_w); out is float32
// HWC(3) in [0,1]. out_h/out_w == native dims means convert-only.
int pg_jpeg_decode_rgb_resize(const unsigned char* buf, long len,
                              int out_h, int out_w, float* out) {
    jpeg_decompress_struct cinfo;
    JpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_error_exit;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;

    // DCT-domain prescale: smallest 1/2^k decode that stays >= target
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    for (int denom = 2; denom <= 8; denom *= 2) {
        if (static_cast<int>(cinfo.image_height) / denom >= out_h &&
            static_cast<int>(cinfo.image_width) / denom >= out_w) {
            cinfo.scale_denom = denom;
        } else {
            break;
        }
    }

    jpeg_start_decompress(&cinfo);
    const int sh = cinfo.output_height;
    const int sw = cinfo.output_width;
    const int c = cinfo.output_components;  // 3 for JCS_RGB
    std::vector<uint8_t> pixels(static_cast<size_t>(sh) * sw * c);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = pixels.data()
            + static_cast<size_t>(cinfo.output_scanline) * sw * c;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    if (c != 3) return 2;
    bilinear_u8_to_f32(pixels.data(), sh, sw, 3, out, out_h, out_w);
    return 0;
}

// decode RGB and bilinear-resize to (out_h, out_w) as uint8 HWC(3):
// keeps host->device transfers at 1 byte/channel (normalisation happens
// on device) -- 4x less PCIe/relay traffic than float32.
int pg_jpeg_decode_rgb_resize_u8(const unsigned char* buf, long len,
                                 int out_h, int out_w, uint8_t* out) {
    jpeg_decompress_struct cinfo;
    JpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_error_exit;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    for (int denom = 2; denom <= 8; denom *= 2) {
        if (static_cast<int>(cinfo.image_height) / denom >= out_h &&
            static_cast<int>(cinfo.image_width) / denom >= out_w) {
            cinfo.scale_denom = denom;
        } else {
            break;
        }
    }
    jpeg_start_decompress(&cinfo);
    const int sh = cinfo.output_height;
    const int sw = cinfo.output_width;
    const int c = cinfo.output_components;
    std::vector<uint8_t> pixels(static_cast<size_t>(sh) * sw * c);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = pixels.data()
            + static_cast<size_t>(cinfo.output_scanline) * sw * c;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    if (c != 3) return 2;
    if (sh == out_h && sw == out_w) {
        std::memcpy(out, pixels.data(), pixels.size());
    } else {
        bilinear_u8_to_u8(pixels.data(), sh, sw, 3, out, out_h, out_w);
    }
    return 0;
}

int pg_png_info(const unsigned char* buf, long len, int* h, int* w) {
    png_image img;
    std::memset(&img, 0, sizeof(img));
    img.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(
            &img, buf, static_cast<size_t>(len))) {
        return 1;
    }
    *h = img.height;
    *w = img.width;
    png_image_free(&img);
    return 0;
}

// decode grayscale and nearest-resize to (out_h, out_w) int32 labelmap
int pg_png_decode_gray_resize(const unsigned char* buf, long len,
                              int out_h, int out_w, int32_t* out) {
    png_image img;
    std::memset(&img, 0, sizeof(img));
    img.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(
            &img, buf, static_cast<size_t>(len))) {
        return 1;
    }
    img.format = PNG_FORMAT_GRAY;
    std::vector<uint8_t> pixels(PNG_IMAGE_SIZE(img));
    if (!png_image_finish_read(&img, nullptr, pixels.data(), 0, nullptr)) {
        png_image_free(&img);
        return 1;
    }
    const int sh = img.height;
    const int sw = img.width;
    nearest_u8_to_i32(pixels.data(), sh, sw, out, out_h, out_w);
    return 0;
}

}  // extern "C"
