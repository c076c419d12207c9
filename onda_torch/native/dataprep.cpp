// Host-side data prep of the input pipeline: PNG decode → Pillow-exact
// bicubic / nearest resize → BGR flip + normalize into planar CHW f32, and the
// label LUT remap, run as per-image tasks on a pool of worker threads behind a
// C ABI (bound with ctypes in __init__.py; no Python in the pixel loop).
//
// The PNG decoder is this file's own: chunk walk, zlib `uncompress` of the
// IDAT stream, row unfiltering. It links only the zlib runtime (libz.so.1,
// declared here, so no zlib headers are needed) and no libpng. Non-interlaced
// PNGs of every colour type are read; images become RGB8 (gray replicated,
// palette looked up, alpha dropped, 16-bit channels cut to their high byte,
// as libpng's strip_16 does), labels must be 8-bit gray or palette indices.
//
// The resampler follows Pillow's algorithm (separable convolution with a
// scale-widened support, PRECISION_BITS = 22 fixed-point coefficients, u8
// rounding after each pass), so its output is byte-exact with PIL's resize.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC dataprep.cpp -o libdataprep.so -l:libz.so.1 -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" int uncompress(unsigned char* dest, unsigned long* dest_len, const unsigned char* source,
                          unsigned long source_len);  // zlib

// status codes (mirrored by __init__.py::ERRORS)
enum {
    kOk = 0,
    kOpen = -1,          // the file cannot be opened or read
    kCorrupt = -2,       // not a PNG, or a truncated / inconsistent one
    kUnsupported = -3,   // interlaced, or a label that is not 8-bit gray / palette
    kLabelRange = -4,    // a label id outside the remap table
    kInflate = -5,       // the IDAT stream does not inflate to the expected size
    kSize = -6,          // the decoded size differs from the caller's buffer
    kStopped = -7,       // the executor was destroyed before the job was done
};

namespace {

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

struct Png {
    int width = 0, height = 0, depth = 0, color = 0;
    std::vector<uint8_t> palette;  // RGB triplets
    std::vector<uint8_t> pixels;   // unfiltered rows, `rowbytes` each
    int channels = 0;              // samples per pixel in `pixels`
    size_t rowbytes = 0;
};

int read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return kOpen;
    std::fseek(fp, 0, SEEK_END);
    long size = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    if (size < 0) {
        std::fclose(fp);
        return kOpen;
    }
    out.resize(static_cast<size_t>(size));
    size_t got = size ? std::fread(out.data(), 1, out.size(), fp) : 0;
    std::fclose(fp);
    return got == out.size() ? kOk : kOpen;
}

int samples_per_pixel(int color) {
    switch (color) {
        case 0: return 1;  // gray
        case 2: return 3;  // RGB
        case 3: return 1;  // palette index
        case 4: return 2;  // gray + alpha
        case 6: return 4;  // RGBA
        default: return 0;
    }
}

// Parses the chunks, inflates the IDAT stream and undoes the row filters.
// `header_only` stops after IHDR.
int png_read(const char* path, Png& png, bool header_only) {
    std::vector<uint8_t> file;
    int rc = read_file(path, file);
    if (rc != kOk) return rc;
    static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (file.size() < 8 + 25 || std::memcmp(file.data(), kSig, 8) != 0) return kCorrupt;
    std::vector<uint8_t> idat;
    size_t pos = 8;
    bool header = false, end = false;
    while (pos + 12 <= file.size() && !end) {
        uint32_t len = be32(&file[pos]);
        const uint8_t* type = &file[pos + 4];
        const uint8_t* data = &file[pos + 8];
        if (len > file.size() - pos - 12) return kCorrupt;
        if (std::memcmp(type, "IHDR", 4) == 0) {
            if (len != 13) return kCorrupt;
            png.width = static_cast<int>(be32(data));
            png.height = static_cast<int>(be32(data + 4));
            png.depth = data[8];
            png.color = data[9];
            if (data[10] != 0 || data[11] != 0) return kCorrupt;  // compression, filter method
            if (data[12] != 0) return kUnsupported;               // Adam7 interlace
            png.channels = samples_per_pixel(png.color);
            if (png.channels == 0 || png.width <= 0 || png.height <= 0) return kCorrupt;
            int d = png.depth;
            bool ok = (png.color == 0 && (d == 1 || d == 2 || d == 4 || d == 8 || d == 16)) ||
                      (png.color == 3 && (d == 1 || d == 2 || d == 4 || d == 8)) ||
                      ((png.color == 2 || png.color == 4 || png.color == 6) && (d == 8 || d == 16));
            if (!ok) return kCorrupt;
            png.rowbytes = (static_cast<size_t>(png.width) * png.channels * d + 7) / 8;
            header = true;
            if (header_only) return kOk;
        } else if (std::memcmp(type, "PLTE", 4) == 0) {
            if (len % 3 != 0) return kCorrupt;
            png.palette.assign(data, data + len);
        } else if (std::memcmp(type, "IDAT", 4) == 0) {
            idat.insert(idat.end(), data, data + len);
        } else if (std::memcmp(type, "IEND", 4) == 0) {
            end = true;
        }
        pos += 12 + len;
    }
    if (!header || idat.empty()) return kCorrupt;
    if (png.color == 3 && png.palette.empty()) return kCorrupt;
    const size_t stride = png.rowbytes + 1;
    std::vector<uint8_t> raw(stride * png.height);
    unsigned long raw_len = raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != 0 || raw_len != raw.size())
        return kInflate;
    // undo the per-row filters (PNG spec 9.2); bpp: bytes of one whole pixel, at least 1
    const size_t bpp = std::max<size_t>(1, static_cast<size_t>(png.channels) * png.depth / 8);
    png.pixels.resize(png.rowbytes * png.height);
    std::vector<uint8_t> zero(png.rowbytes, 0);
    for (int y = 0; y < png.height; ++y) {
        const uint8_t* in = &raw[stride * y];
        uint8_t* row = &png.pixels[png.rowbytes * y];
        const uint8_t* up = y ? &png.pixels[png.rowbytes * (y - 1)] : zero.data();
        const uint8_t filter = in[0];
        ++in;
        const size_t n = png.rowbytes;
        switch (filter) {
            case 0:
                std::memcpy(row, in, n);
                break;
            case 1:
                for (size_t i = 0; i < n; ++i) row[i] = in[i] + (i >= bpp ? row[i - bpp] : 0);
                break;
            case 2:
                for (size_t i = 0; i < n; ++i) row[i] = in[i] + up[i];
                break;
            case 3:
                for (size_t i = 0; i < n; ++i)
                    row[i] = in[i] + ((i >= bpp ? row[i - bpp] : 0) + up[i]) / 2;
                break;
            case 4:
                for (size_t i = 0; i < n; ++i) {
                    int a = i >= bpp ? row[i - bpp] : 0, b = up[i], c = i >= bpp ? up[i - bpp] : 0;
                    int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    row[i] = in[i] + (pa <= pb && pa <= pc ? a : (pb <= pc ? b : c));
                }
                break;
            default:
                return kCorrupt;
        }
    }
    return kOk;
}

// sample s of row y as an 8-bit value (sub-byte gray scaled to 0..255,
// 16-bit cut to its high byte; palette indices left as indices)
inline int sample8(const Png& png, const uint8_t* row, int x, int s) {
    const int d = png.depth;
    if (d == 8) return row[x * png.channels + s];
    if (d == 16) return row[(x * png.channels + s) * 2];
    const int per_byte = 8 / d;  // sub-byte depths have one sample per pixel
    const int v = (row[x / per_byte] >> (8 - d * (x % per_byte + 1))) & ((1 << d) - 1);
    return png.color == 3 ? v : v * 255 / ((1 << d) - 1);
}

// RGB8 HWC of an image of any colour type
int decode_rgb(const Png& png, std::vector<uint8_t>& out) {
    const int w = png.width, h = png.height;
    out.resize(static_cast<size_t>(w) * h * 3);
    const size_t n_pal = png.palette.size() / 3;
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = &png.pixels[png.rowbytes * y];
        uint8_t* dst = &out[static_cast<size_t>(y) * w * 3];
        if (png.color == 2 && png.depth == 8) {
            std::memcpy(dst, row, static_cast<size_t>(w) * 3);
            continue;
        }
        for (int x = 0; x < w; ++x) {
            if (png.color == 3) {
                size_t i = static_cast<size_t>(sample8(png, row, x, 0));
                if (i >= n_pal) return kCorrupt;
                std::memcpy(dst + 3 * x, &png.palette[3 * i], 3);
            } else if (png.color == 0 || png.color == 4) {
                dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = static_cast<uint8_t>(sample8(png, row, x, 0));
            } else {
                for (int c = 0; c < 3; ++c) dst[3 * x + c] = static_cast<uint8_t>(sample8(png, row, x, c));
            }
        }
    }
    return kOk;
}

// one 8-bit value per pixel: gray levels or palette indices (a label map)
int decode_index(const Png& png, std::vector<uint8_t>& out) {
    if (!((png.color == 0 && png.depth == 8) || png.color == 3)) return kUnsupported;
    const int w = png.width, h = png.height;
    out.resize(static_cast<size_t>(w) * h);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = &png.pixels[png.rowbytes * y];
        uint8_t* dst = &out[static_cast<size_t>(y) * w];
        if (png.depth == 8) {
            std::memcpy(dst, row, w);
        } else {
            for (int x = 0; x < w; ++x) dst[x] = static_cast<uint8_t>(sample8(png, row, x, 0));
        }
    }
    return kOk;
}

// ---------------------------------------------------------------------------
// Pillow-exact resampling
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

double bicubic_filter(double x) {  // Pillow's bicubic, a = -0.5
    constexpr double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}
constexpr double kBicubicSupport = 2.0;

// Pillow's coefficient table for one output axis
void precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds, std::vector<int>& kk,
                       int& ksize) {
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = kBicubicSupport * filterscale;
    ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    bounds.resize(out_size * 2);
    kk.resize(static_cast<size_t>(out_size) * ksize);
    std::vector<double> w(ksize);
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        int x = 0;
        for (; x < xmax; ++x) {
            double v = bicubic_filter((x + xmin - center + 0.5) * ss);
            w[x] = v;
            ww += v;
        }
        for (x = 0; x < xmax; ++x)
            if (ww != 0.0) w[x] /= ww;
        for (; x < ksize; ++x) w[x] = 0.0;
        for (x = 0; x < ksize; ++x)
            kk[static_cast<size_t>(xx) * ksize + x] = static_cast<int>(std::round(w[x] * (1 << kPrecisionBits)));
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
}

inline uint8_t clip8(int64_t v) {
    v >>= kPrecisionBits;
    if (v < 0) return 0;
    if (v > 255) return 255;
    return static_cast<uint8_t>(v);
}

// separable two-pass bicubic resample of RGB8 HWC, u8 rounding after each pass
void resize_bicubic_rgb(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow) {
    constexpr int ch = 3;
    std::vector<int> bounds_h, kk_h, bounds_v, kk_v;
    int ksize_h, ksize_v;
    precompute_coeffs(w, ow, bounds_h, kk_h, ksize_h);
    precompute_coeffs(h, oh, bounds_v, kk_v, ksize_v);
    std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * ch);
    const int64_t half = 1LL << (kPrecisionBits - 1);
    for (int y = 0; y < h; ++y) {  // horizontal pass
        const uint8_t* srow = src + static_cast<size_t>(y) * w * ch;
        uint8_t* trow = tmp.data() + static_cast<size_t>(y) * ow * ch;
        for (int xx = 0; xx < ow; ++xx) {
            int xmin = bounds_h[xx * 2], xmax = bounds_h[xx * 2 + 1];
            const int* k = &kk_h[static_cast<size_t>(xx) * ksize_h];
            for (int c = 0; c < ch; ++c) {
                int64_t ss = half;
                for (int x = 0; x < xmax; ++x) ss += static_cast<int64_t>(srow[(xmin + x) * ch + c]) * k[x];
                trow[xx * ch + c] = clip8(ss);
            }
        }
    }
    for (int yy = 0; yy < oh; ++yy) {  // vertical pass
        int ymin = bounds_v[yy * 2], ymax = bounds_v[yy * 2 + 1];
        const int* k = &kk_v[static_cast<size_t>(yy) * ksize_v];
        uint8_t* drow = dst + static_cast<size_t>(yy) * ow * ch;
        for (int xx = 0; xx < ow * ch; ++xx) {
            int64_t ss = half;
            for (int y = 0; y < ymax; ++y)
                ss += static_cast<int64_t>(tmp[static_cast<size_t>(ymin + y) * ow * ch + xx]) * k[y];
            drow[xx] = clip8(ss);
        }
    }
}

// PIL NEAREST on a one-channel map: src index = floor((dst + 0.5) * scale)
void resize_nearest(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow) {
    double sy = static_cast<double>(h) / oh, sx = static_cast<double>(w) / ow;
    for (int y = 0; y < oh; ++y) {
        int yin = std::min(static_cast<int>((y + 0.5) * sy), h - 1);
        const uint8_t* srow = src + static_cast<size_t>(yin) * w;
        uint8_t* drow = dst + static_cast<size_t>(y) * ow;
        for (int x = 0; x < ow; ++x) drow[x] = srow[std::min(static_cast<int>((x + 0.5) * sx), w - 1)];
    }
}

// RGB8 HWC → BGR f32 planar CHW: x/255, then (x − mean/255) / (std/255)
// (the reference's preprocess + Normalize; mean/std apply in BGR order as given)
void normalize_bgr_chw(const uint8_t* src, int h, int w, float* dst, const float* mean,
                       const float* stddev) {
    float m[3], inv[3];
    for (int c = 0; c < 3; ++c) {
        m[c] = mean[c] / 255.0f;
        inv[c] = 255.0f / stddev[c];
    }
    const size_t plane = static_cast<size_t>(h) * w;
    for (int c = 0; c < 3; ++c) {
        float* out = dst + c * plane;
        const uint8_t* in = src + (2 - c);  // BGR flip
        for (size_t i = 0; i < plane; ++i) out[i] = (in[3 * i] * (1.0f / 255.0f) - m[c]) * inv[c];
    }
}

// dst[i] = lut[src[i]]; an id outside the table is an error (the Python
// LabelMapper raises IndexError on the same input)
int lut_remap(const uint8_t* src, size_t n, const int32_t* lut, int lut_size, int32_t* dst) {
    int bad = 0;
    for (size_t i = 0; i < n; ++i) {
        int v = src[i];
        if (v >= lut_size) {
            bad = 1;
            v = 0;
        }
        dst[i] = lut[v];
    }
    return bad ? kLabelRange : kOk;
}

// decode → bicubic resize to (out_h, out_w) → BGR normalize into planar CHW f32
int prepare_image(const char* path, int out_h, int out_w, const float* mean, const float* stddev,
                  float* dst) {
    Png png;
    int rc = png_read(path, png, false);
    if (rc != kOk) return rc;
    std::vector<uint8_t> rgb;
    rc = decode_rgb(png, rgb);
    if (rc != kOk) return rc;
    std::vector<uint8_t> resized(static_cast<size_t>(out_h) * out_w * 3);
    resize_bicubic_rgb(rgb.data(), png.height, png.width, resized.data(), out_h, out_w);
    normalize_bgr_chw(resized.data(), out_h, out_w, dst, mean, stddev);
    return kOk;
}

// decode → nearest resize to the input grid and to the 1/8+1 grid → LUT remap
int prepare_label(const char* path, int out_h, int out_w, int res_h, int res_w, const int32_t* lut,
                  int lut_size, int32_t* dst_full, int32_t* dst_res) {
    Png png;
    int rc = png_read(path, png, false);
    if (rc != kOk) return rc;
    std::vector<uint8_t> raw;
    rc = decode_index(png, raw);
    if (rc != kOk) return rc;
    std::vector<uint8_t> full(static_cast<size_t>(out_h) * out_w), res(static_cast<size_t>(res_h) * res_w);
    resize_nearest(raw.data(), png.height, png.width, full.data(), out_h, out_w);
    resize_nearest(raw.data(), png.height, png.width, res.data(), res_h, res_w);
    rc = lut_remap(full.data(), full.size(), lut, lut_size, dst_full);
    int rc2 = lut_remap(res.data(), res.size(), lut, lut_size, dst_res);
    return rc != kOk ? rc : rc2;
}

}  // namespace

extern "C" {

// PNG header: height and width
int png_probe(const char* path, int* height, int* width) {
    Png png;
    int rc = png_read(path, png, true);
    if (rc != kOk) return rc;
    *height = png.height;
    *width = png.width;
    return kOk;
}

// whole PNG into out: RGB8 HWC (rgb != 0) or one index per pixel; out holds
// height * width * (rgb ? 3 : 1) bytes
int decode_png(const char* path, int rgb, uint8_t* out, size_t out_bytes) {
    Png png;
    int rc = png_read(path, png, false);
    if (rc != kOk) return rc;
    std::vector<uint8_t> px;
    rc = rgb ? decode_rgb(png, px) : decode_index(png, px);
    if (rc != kOk) return rc;
    if (px.size() != out_bytes) return kSize;
    std::memcpy(out, px.data(), px.size());
    return kOk;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch executor: a pool of worker threads that prepares whole batches. Python
// submits a batch (one task per image), keeps submitting ahead, and waits on a
// job (the GIL released by ctypes) only when the batch is needed. Each
// executor is an object the caller creates and destroys.
// ---------------------------------------------------------------------------

namespace {

struct Job {
    std::atomic<int> remaining{0};
    std::atomic<int> status{0};   // first nonzero task status wins
    std::atomic<int> failed{-1};  // index of that task in the batch
};

class Executor {
  public:
    explicit Executor(int workers) {
        for (int i = 0; i < std::max(1, workers); ++i) pool_.emplace_back([this] { run(); });
    }

    ~Executor() {
        {
            std::lock_guard<std::mutex> g(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : pool_) t.join();
        // a thread may still wait on a job whose tasks will now never run (a
        // loader thread when the process exits): wake it, and let it leave
        // before the condition variable it waits on is destroyed
        std::unique_lock<std::mutex> g(mu_);
        done_cv_.notify_all();
        done_cv_.wait(g, [this] { return waiters_ == 0; });
        for (auto& kv : jobs_) delete kv.second;
    }

    int submit(std::vector<std::function<int()>> tasks) {
        std::lock_guard<std::mutex> g(mu_);
        int id = next_id_++;
        Job* job = new Job;
        job->remaining.store(static_cast<int>(tasks.size()));
        jobs_[id] = job;
        for (size_t i = 0; i < tasks.size(); ++i) queue_.push_back({job, static_cast<int>(i), std::move(tasks[i])});
        cv_.notify_all();
        return id;
    }

    // blocks until the job is done; reaps it and returns its status
    int wait(int id, int* failed) {
        std::unique_lock<std::mutex> g(mu_);
        auto it = jobs_.find(id);
        if (it == jobs_.end()) return kCorrupt;
        Job* job = it->second;
        ++waiters_;
        done_cv_.wait(g, [this, job] { return stop_ || job->remaining.load() == 0; });
        --waiters_;
        if (job->remaining.load() != 0) {  // stopped: the destructor reaps the job
            done_cv_.notify_all();
            return kStopped;
        }
        int status = job->status.load();
        *failed = job->failed.load();
        jobs_.erase(it);
        delete job;
        return status;
    }

  private:
    struct Task {
        Job* job;
        int index;
        std::function<int()> fn;
    };

    void run() {
        for (;;) {
            Task task;
            {
                std::unique_lock<std::mutex> g(mu_);
                cv_.wait(g, [this] { return stop_ || !queue_.empty(); });
                if (stop_) return;
                task = std::move(queue_.front());
                queue_.pop_front();
            }
            int rc = task.fn();
            if (rc != kOk) {
                int expected = 0;
                if (task.job->status.compare_exchange_strong(expected, rc)) task.job->failed.store(task.index);
            }
            if (task.job->remaining.fetch_sub(1) == 1) {
                std::lock_guard<std::mutex> g(mu_);
                done_cv_.notify_all();
            }
        }
    }

    std::mutex mu_;
    std::condition_variable cv_, done_cv_;
    std::deque<Task> queue_;
    std::unordered_map<int, Job*> jobs_;
    std::vector<std::thread> pool_;
    int next_id_ = 1;
    int waiters_ = 0;  // threads inside wait()
    bool stop_ = false;
};

}  // namespace

extern "C" {

void* executor_create(int workers) { return new Executor(workers); }

void executor_destroy(void* ex) { delete static_cast<Executor*>(ex); }

// an image batch: paths[i] → dst + i * 3 * out_h * out_w (planar CHW f32)
int executor_submit_images(void* ex, const char** paths, int n, int out_h, int out_w,
                           const float* mean, const float* stddev, float* dst) {
    std::vector<std::function<int()>> tasks;
    tasks.reserve(n);
    // copy what the tasks read: the caller's temporaries may go once this
    // returns (dst must stay alive until the job is waited on)
    std::vector<float> m(mean, mean + 3), s(stddev, stddev + 3);
    for (int i = 0; i < n; ++i) {
        std::string path(paths[i]);
        float* out = dst + static_cast<size_t>(i) * 3 * out_h * out_w;
        tasks.push_back([path, out_h, out_w, m, s, out]() {
            return prepare_image(path.c_str(), out_h, out_w, m.data(), s.data(), out);
        });
    }
    return static_cast<Executor*>(ex)->submit(std::move(tasks));
}

// a label batch: paths[i] → the i-th (out_h, out_w) and (res_h, res_w) int32 maps
int executor_submit_labels(void* ex, const char** paths, int n, int out_h, int out_w, int res_h,
                           int res_w, const int32_t* lut, int lut_size, int32_t* dst_full,
                           int32_t* dst_res) {
    std::vector<std::function<int()>> tasks;
    tasks.reserve(n);
    std::vector<int32_t> table(lut, lut + lut_size);
    for (int i = 0; i < n; ++i) {
        std::string path(paths[i]);
        int32_t* full = dst_full + static_cast<size_t>(i) * out_h * out_w;
        int32_t* res = dst_res + static_cast<size_t>(i) * res_h * res_w;
        tasks.push_back([path, out_h, out_w, res_h, res_w, table, full, res]() {
            return prepare_label(path.c_str(), out_h, out_w, res_h, res_w, table.data(),
                                 static_cast<int>(table.size()), full, res);
        });
    }
    return static_cast<Executor*>(ex)->submit(std::move(tasks));
}

// waits for a job; returns its status and, on failure, the failing index
int executor_wait(void* ex, int job, int* failed) {
    return static_cast<Executor*>(ex)->wait(job, failed);
}

}  // extern "C"
