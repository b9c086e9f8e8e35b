// Native image decode for the host side of the pipeline (reference C10
// analog, SURVEY.md §2: the reference decoded/preprocessed images in host
// C/C++ — OpenCV/stb-style. Here decode happens in C++ against libjpeg and
// libpng; resize + normalize + layout stay ON DEVICE in the jitted graph,
// SURVEY.md §3.4).
//
// C ABI (ctypes-bound from native_io/__init__.py):
//   mnv1_decode_image(path, &out, &h, &w) -> 0 on success
//     out: malloc'd H*W*3 uint8 RGB (caller frees via mnv1_free)
//   mnv1_free(ptr)
//
// Supported: baseline+progressive JPEG (any libjpeg colorspace -> RGB),
// 8/16-bit gray/palette/RGB/RGBA PNG (alpha dropped, 16-bit scaled to 8).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

struct mnv1_jpeg_err {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

static void mnv1_jpeg_error_exit(j_common_ptr cinfo) {
    mnv1_jpeg_err* err = reinterpret_cast<mnv1_jpeg_err*>(cinfo->err);
    longjmp(err->jump, 1);
}

// Keep libjpeg warnings ("Premature end of JPEG file", ...) off stderr —
// corrupt inputs surface as a clean error code, not log spam per request.
static void mnv1_jpeg_silent_output(j_common_ptr) {}

static int decode_jpeg(FILE* f, unsigned char** out, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    mnv1_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = mnv1_jpeg_error_exit;
    jerr.mgr.output_message = mnv1_jpeg_silent_output;
    // volatile: modified after setjmp and read in the longjmp path (C11
    // 7.13.2.1 — a plain local would be indeterminate there under -O2)
    unsigned char* volatile buf = nullptr;
    if (setjmp(jerr.jump)) {  // any libjpeg fatal error lands here
        jpeg_destroy_decompress(&cinfo);
        free(buf);
        return 2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr/CMYK
    jpeg_start_decompress(&cinfo);
    const int H = cinfo.output_height, W = cinfo.output_width;
    buf = static_cast<unsigned char*>(malloc(static_cast<size_t>(H) * W * 3));
    if (!buf) { jpeg_destroy_decompress(&cinfo); return 3; }
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = buf + static_cast<size_t>(cinfo.output_scanline) * W * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf; *h = H; *w = W;
    return 0;
}

static int decode_png(FILE* f, unsigned char** out, int* h, int* w) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) return 2;
    png_infop info = png_create_info_struct(png);
    if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return 2; }
    // volatile: see decode_jpeg — both are written after setjmp and read in
    // the longjmp error path
    unsigned char* volatile buf = nullptr;
    png_bytep* volatile rows = nullptr;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        free(buf); free(rows);
        return 2;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    // Normalize every layout to 8-bit RGB.
    png_set_palette_to_rgb(png);
    png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_16(png);
    png_set_strip_alpha(png);
    png_set_gray_to_rgb(png);
    png_read_update_info(png, info);
    const int H = png_get_image_height(png, info);
    const int W = png_get_image_width(png, info);
    if (png_get_rowbytes(png, info) != static_cast<size_t>(W) * 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 4;  // normalization above should make this impossible
    }
    buf = static_cast<unsigned char*>(malloc(static_cast<size_t>(H) * W * 3));
    rows = static_cast<png_bytep*>(malloc(sizeof(png_bytep) * H));
    if (!buf || !rows) {
        png_destroy_read_struct(&png, &info, nullptr);
        free(buf); free(rows);
        return 3;
    }
    for (int y = 0; y < H; y++)
        rows[y] = buf + static_cast<size_t>(y) * W * 3;
    png_read_image(png, rows);
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    free(rows);
    *out = buf; *h = H; *w = W;
    return 0;
}

// 0 ok; 1 open/format error; 2 decode error; 3 oom; 4 unexpected layout
int mnv1_decode_image(const char* path, unsigned char** out, int* h, int* w) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    unsigned char magic[8] = {0};
    size_t n = fread(magic, 1, 8, f);
    rewind(f);
    int rc;
    if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
        rc = decode_jpeg(f, out, h, w);
    } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
        rc = decode_png(f, out, h, w);
    } else {
        rc = 1;
    }
    fclose(f);
    return rc;
}

void mnv1_free(unsigned char* ptr) { free(ptr); }

// Threaded batch decode — the host-side staging analog of the reference's
// multi-image ingest (SURVEY.md §2 C10/C12: the FPGA host staged batches of
// decoded images into pinned buffers while the device ran). Each worker
// pulls the next undecoded index off a shared atomic counter, so long
// (large-image) decodes don't convoy short ones. libjpeg/libpng are
// re-entrant per decoder instance; every instance here is thread-local
// stack state, so no locking is needed around the codecs.
//
//   paths:   n C strings
//   threads: worker count; <=0 means std::thread::hardware_concurrency()
//   outs[i]: malloc'd H*W*3 RGB on success (caller frees via mnv1_free),
//            nullptr on failure
//   hs/ws[i]: decoded dims; rcs[i]: per-image code (see mnv1_decode_image)
// Returns the number of images that FAILED (0 == all decoded).
int mnv1_decode_batch(const char** paths, int n, int threads,
                      unsigned char** outs, int* hs, int* ws, int* rcs) {
    if (n <= 0) return 0;
    int hw = static_cast<int>(std::thread::hardware_concurrency());
    if (hw <= 0) hw = 4;
    int nt = threads > 0 ? threads : hw;
    if (nt > n) nt = n;
    std::atomic<int> next(0);
    std::atomic<int> failures(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) return;
            outs[i] = nullptr;
            hs[i] = ws[i] = 0;
            rcs[i] = mnv1_decode_image(paths[i], &outs[i], &hs[i], &ws[i]);
            if (rcs[i] != 0) failures.fetch_add(1, std::memory_order_relaxed);
        }
    };
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int t = 0; t < nt; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return failures.load(std::memory_order_relaxed);
}

}  // extern "C"
