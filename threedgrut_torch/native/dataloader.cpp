// Native data loader: threaded PNG/JPEG decode with prefetch.
//
// Role in the framework: the reference feeds its trainer with a torch
// DataLoader running 24 worker processes (threedgrut/datasets/utils.py:
// MultiEpochsDataLoader, platform dataloader config). This C++ thread-pool
// decoder keeps the host input pipeline off the Python GIL instead: images
// are decoded straight into float32 [H, W, C] buffers that the trainer
// copies to the device. The port's copy of
// threedgrut_tpu/native/dataloader.cpp, built by native/__init__.py.
//
// C API (ctypes-friendly), no Python headers required:
//   dl_image_info(path, &w, &h, &c)          — header-only probe
//   dl_decode(path, out, w*h*c)              — synchronous decode to float32
//   dl_create(n_threads)                     — prefetcher handle
//   dl_submit(handle, ticket, path)          — schedule decode of `path`
//   dl_wait(handle, ticket, out, cap, &w,&h,&c) — block until decoded
//   dl_destroy(handle)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 dataloader.cpp -lpng -ljpeg -pthread

#include <png.h>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <condition_variable>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct Image {
    int w = 0, h = 0, c = 0;
    std::vector<float> data;
    bool ok = false;
};

bool has_suffix(const std::string& s, const char* suf) {
    size_t n = strlen(suf);
    if (s.size() < n) return false;
    for (size_t i = 0; i < n; i++) {
        char a = s[s.size() - n + i], b = suf[i];
        if (tolower(a) != tolower(b)) return false;
    }
    return true;
}

Image decode_png(const char* path) {
    Image img;
    FILE* fp = fopen(path, "rb");
    if (!fp) return img;
    png_byte header[8];
    if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
        fclose(fp);
        return img;
    }
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return img;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);

    png_uint_32 w = png_get_image_width(png, info);
    png_uint_32 h = png_get_image_height(png, info);
    int color = png_get_color_type(png, info);
    int depth = png_get_bit_depth(png, info);

    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    png_read_update_info(png, info);

    int channels = png_get_channels(png, info);
    std::vector<png_byte> row(png_get_rowbytes(png, info));
    img.w = (int)w;
    img.h = (int)h;
    img.c = channels;
    img.data.resize((size_t)w * h * channels);
    for (png_uint_32 y = 0; y < h; y++) {
        png_read_row(png, row.data(), nullptr);
        float* dst = img.data.data() + (size_t)y * w * channels;
        for (size_t i = 0; i < (size_t)w * channels; i++)
            dst[i] = row[i] / 255.0f;
    }
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    img.ok = true;
    return img;
}

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

Image decode_jpeg(const char* path) {
    Image img;
    FILE* fp = fopen(path, "rb");
    if (!fp) return img;
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        fclose(fp);
        return img;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fp);
    jpeg_read_header(&cinfo, TRUE);
    jpeg_start_decompress(&cinfo);
    img.w = cinfo.output_width;
    img.h = cinfo.output_height;
    img.c = cinfo.output_components;
    img.data.resize((size_t)img.w * img.h * img.c);
    std::vector<unsigned char> row((size_t)img.w * img.c);
    unsigned char* rp = row.data();
    while (cinfo.output_scanline < cinfo.output_height) {
        int y = cinfo.output_scanline;
        jpeg_read_scanlines(&cinfo, &rp, 1);
        float* dst = img.data.data() + (size_t)y * img.w * img.c;
        for (size_t i = 0; i < (size_t)img.w * img.c; i++)
            dst[i] = row[i] / 255.0f;
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    img.ok = true;
    return img;
}

Image decode_any(const char* path) {
    std::string p(path);
    if (has_suffix(p, ".jpg") || has_suffix(p, ".jpeg"))
        return decode_jpeg(path);
    return decode_png(path);
}

struct Prefetcher {
    std::vector<std::thread> workers;
    std::mutex mu;
    std::condition_variable cv_work, cv_done;
    std::deque<std::pair<long, std::string>> queue;
    std::map<long, Image> done;
    bool stop = false;

    explicit Prefetcher(int n_threads) {
        for (int i = 0; i < n_threads; i++)
            workers.emplace_back([this] { run(); });
    }

    void run() {
        for (;;) {
            std::pair<long, std::string> job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_work.wait(lk, [&] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                job = queue.front();
                queue.pop_front();
            }
            Image img = decode_any(job.second.c_str());
            {
                std::lock_guard<std::mutex> lk(mu);
                done[job.first] = std::move(img);
            }
            cv_done.notify_all();
        }
    }

    void submit(long ticket, const char* path) {
        {
            std::lock_guard<std::mutex> lk(mu);
            queue.emplace_back(ticket, std::string(path));
        }
        cv_work.notify_one();
    }

    Image wait(long ticket) {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [&] { return done.count(ticket) > 0; });
        Image img = std::move(done[ticket]);
        done.erase(ticket);
        return img;
    }

    ~Prefetcher() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv_work.notify_all();
        for (auto& t : workers) t.join();
    }
};

}  // namespace

extern "C" {

int dl_image_info(const char* path, int* w, int* h, int* c) {
    Image img = decode_any(path);  // full decode (header-only not worth it)
    if (!img.ok) return -1;
    *w = img.w;
    *h = img.h;
    *c = img.c;
    return 0;
}

int dl_decode(const char* path, float* out, long capacity,
              int* w, int* h, int* c) {
    Image img = decode_any(path);
    if (!img.ok) return -1;
    long need = (long)img.w * img.h * img.c;
    if (need > capacity) return -2;
    memcpy(out, img.data.data(), need * sizeof(float));
    *w = img.w;
    *h = img.h;
    *c = img.c;
    return 0;
}

void* dl_create(int n_threads) {
    return new Prefetcher(n_threads > 0 ? n_threads : 4);
}

void dl_submit(void* handle, long ticket, const char* path) {
    static_cast<Prefetcher*>(handle)->submit(ticket, path);
}

int dl_wait(void* handle, long ticket, float* out, long capacity,
            int* w, int* h, int* c) {
    Image img = static_cast<Prefetcher*>(handle)->wait(ticket);
    if (!img.ok) return -1;
    long need = (long)img.w * img.h * img.c;
    if (need > capacity) return -2;
    memcpy(out, img.data.data(), need * sizeof(float));
    *w = img.w;
    *h = img.h;
    *c = img.c;
    return 0;
}

void dl_destroy(void* handle) {
    delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
