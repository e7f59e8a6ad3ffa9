// v2ap_native: the host library of the PyTorch port (v2ap_torch/native),
// the port's own copy of the JAX package's v2ap_tpu/native/v2ap_native.cpp,
// line for line in its arithmetic, so both packages give the same bytes.
// Host loops in C++, exposed through a C ABI that v2ap_torch/native/
// __init__.py binds with ctypes:
//
//   * wav_decode            - RIFF WAV reader (16/24/32-bit PCM, float32,
//                             WAVE_FORMAT_EXTENSIBLE); v2ap_torch/data/audio_io
//   * resample_poly         - windowed-sinc rational (polyphase) resampler
//   * frame_energy          - per-hop mean |x| energies
//   * max_energy_start      - sliding-window max-energy segment selection;
//                             v2ap_torch/data/audio_io
//   * gray_resize           - RGB -> grayscale + bilinear resize
//   * clip_preprocess_batch - PIL-exact bicubic short-edge resize + center
//                             crop; v2ap_torch/models/clip_vit
//   * pack_yuv420           - RGB -> YUV 4:2:0 wire packing;
//                             v2ap_torch/models/clip_vit
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (v2ap_torch/native/__init__.py,
// at first use, into build/v2ap_torch/); no -march=native and no fast-math,
// which would let the compiler reorder the float arithmetic. The one
// departure from the JAX package's copy: wav_decode refuses a header that
// would read past the buffer or divide by zero (a truncated "fmt " chunk,
// fewer than 8 bits a sample) with -2; well-formed files decode the same.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------- wav decode

// Parses a RIFF WAV from `bytes`. On success writes sample rate / channels /
// frame count through the out params and fills `out` (interleaved float32,
// caller-allocated with capacity `out_capacity` floats). Returns 0 on
// success, negative error codes otherwise. Call with out == nullptr to query
// the required capacity first.
int wav_decode(const uint8_t* bytes, int64_t n_bytes,
               int32_t* sample_rate, int32_t* channels, int64_t* frames,
               float* out, int64_t out_capacity) {
    if (n_bytes < 44 || memcmp(bytes, "RIFF", 4) || memcmp(bytes + 8, "WAVE", 4))
        return -1;
    int64_t pos = 12;
    int fmt = 0, ch = 0, sr = 0, bits = 0;
    const uint8_t* data = nullptr;
    int64_t data_len = 0;
    while (pos + 8 <= n_bytes) {
        const uint8_t* hdr = bytes + pos;
        uint32_t size;
        memcpy(&size, hdr + 4, 4);
        const uint8_t* body = hdr + 8;
        const int64_t avail = n_bytes - pos - 8;   // bytes after the header
        if (!memcmp(hdr, "fmt ", 4) && size >= 16 && avail >= 16) {
            uint16_t f, c; uint32_t s; uint16_t b;
            memcpy(&f, body, 2); memcpy(&c, body + 2, 2);
            memcpy(&s, body + 4, 4); memcpy(&b, body + 14, 2);
            fmt = f; ch = c; sr = (int)s; bits = b;
            if (fmt == 0xFFFE && size >= 40 && avail >= 26) {  // EXTENSIBLE
                uint16_t sub; memcpy(&sub, body + 24, 2);
                fmt = sub;
            }
        } else if (!memcmp(hdr, "data", 4)) {
            data = body;
            data_len = std::min<int64_t>((int64_t)size, n_bytes - pos - 8);
        }
        pos += 8 + size + (size & 1);
    }
    if (!data || !ch || !sr || bits < 8) return -2;
    int bytes_per = bits / 8;
    int64_t total = data_len / bytes_per;
    int64_t nframes = total / ch;
    *sample_rate = sr; *channels = ch; *frames = nframes;
    if (!out) return 0;
    if (out_capacity < total) return -3;

    if (fmt == 1 && bits == 16) {
        const int16_t* p = (const int16_t*)data;
        for (int64_t i = 0; i < total; ++i) out[i] = p[i] / 32768.0f;
    } else if (fmt == 1 && bits == 32) {
        const int32_t* p = (const int32_t*)data;
        for (int64_t i = 0; i < total; ++i) out[i] = p[i] / 2147483648.0f;
    } else if (fmt == 1 && bits == 24) {
        for (int64_t i = 0; i < total; ++i) {
            const uint8_t* b = data + 3 * i;
            int32_t v = (b[0] | (b[1] << 8) | (b[2] << 16));
            if (v & 0x800000) v -= 0x1000000;
            out[i] = v / 8388608.0f;
        }
    } else if (fmt == 3 && bits == 32) {
        memcpy(out, data, total * 4);
    } else {
        return -4;
    }
    return 0;
}

// ------------------------------------------------------------- resampling

// Polyphase windowed-sinc resampler: in (n,) float32 at rate up/down.
// Output length = ceil(n * up / down); returns samples written.
int64_t resample_poly(const float* in, int64_t n, int32_t up, int32_t down,
                      int32_t half_taps, float* out, int64_t out_capacity) {
    if (up == down) {
        int64_t m = std::min(n, out_capacity);
        memcpy(out, in, m * sizeof(float));
        return m;
    }
    const double cutoff = 0.5 / std::max(up, down);
    const int64_t out_len = (n * up + down - 1) / down;
    if (out_capacity < out_len) return -1;
    const int taps_per_phase = 2 * half_taps;
    // filter bank: phase p, tap t -> h[(t*up + p)] of the prototype
    std::vector<float> proto((size_t)taps_per_phase * up);
    const int64_t M = (int64_t)taps_per_phase * up;
    for (int64_t i = 0; i < M; ++i) {
        double x = (double)(i - M / 2);
        double sinc = (x == 0.0) ? 1.0
            : std::sin(2.0 * M_PI * cutoff * x) / (M_PI * x) / (2.0 * cutoff);
        // Blackman window
        double w = 0.42 - 0.5 * std::cos(2.0 * M_PI * i / (M - 1))
                 + 0.08 * std::cos(4.0 * M_PI * i / (M - 1));
        proto[i] = (float)(2.0 * cutoff * up * sinc * w);
    }
    for (int64_t k = 0; k < out_len; ++k) {
        const int64_t num = k * down;
        const int64_t in_center = num / up;
        const int phase = (int)(num % up);
        double acc = 0.0;
        // taps for this phase: proto[t*up + (up-1-phase)]... use direct form:
        for (int t = 0; t < taps_per_phase; ++t) {
            int64_t h_idx = (int64_t)t * up + phase;
            int64_t s = in_center + half_taps - t;
            if (s >= 0 && s < n) acc += (double)proto[h_idx] * in[s];
        }
        out[k] = (float)acc;
    }
    return out_len;
}

// -------------------------------------------------- segment selection

// Per-hop mean-abs energies: in (n*hop,) -> energies (n,)
void frame_energy(const float* in, int64_t n_frames, int32_t hop, float* out) {
    for (int64_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        const float* p = in + i * hop;
        for (int32_t j = 0; j < hop; ++j) acc += std::fabs(p[j]);
        out[i] = (float)(acc / hop);
    }
}

// Max-energy window start (in hops) for a target of `target` hops.
int64_t max_energy_start(const float* in, int64_t total_frames, int32_t hop,
                         int64_t target) {
    if (target >= total_frames) return 0;
    std::vector<double> e(total_frames);
    for (int64_t i = 0; i < total_frames; ++i) {
        double acc = 0.0;
        const float* p = in + i * hop;
        for (int32_t j = 0; j < hop; ++j) acc += std::fabs(p[j]);
        e[i] = acc / hop;
    }
    double best = 0.0, cur = 0.0;
    for (int64_t i = 0; i < target; ++i) cur += e[i];
    best = cur;
    int64_t best_start = 0;
    for (int64_t s = 1; s + target <= total_frames; ++s) {
        cur += e[s + target - 1] - e[s - 1];
        if (cur > best) { best = cur; best_start = s; }
    }
    return best_start;
}

// ------------------------------------------------------ piano frame prep

// RGB uint8 (h, w, 3) -> grayscale bilinear-resized float32 (out_h, out_w)
// in [0, 1] (ITU-R 601 luma, matching PIL convert('L') / cv2).
void gray_resize(const uint8_t* rgb, int32_t h, int32_t w,
                 int32_t out_h, int32_t out_w, float* out) {
    std::vector<float> gray((size_t)h * w);
    for (int64_t i = 0; i < (int64_t)h * w; ++i) {
        const uint8_t* p = rgb + 3 * i;
        gray[i] = (299 * p[0] + 587 * p[1] + 114 * p[2]) / 1000.0f;
    }
    const float sy = (float)h / out_h;
    const float sx = (float)w / out_w;
    for (int32_t y = 0; y < out_h; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        int32_t y0 = std::max(0, std::min(h - 1, (int32_t)std::floor(fy)));
        int32_t y1 = std::min(h - 1, y0 + 1);
        float wy = fy - y0;
        if (wy < 0) wy = 0;
        for (int32_t x = 0; x < out_w; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            int32_t x0 = std::max(0, std::min(w - 1, (int32_t)std::floor(fx)));
            int32_t x1 = std::min(w - 1, x0 + 1);
            float wx = fx - x0;
            if (wx < 0) wx = 0;
            float v = gray[(size_t)y0 * w + x0] * (1 - wy) * (1 - wx)
                    + gray[(size_t)y0 * w + x1] * (1 - wy) * wx
                    + gray[(size_t)y1 * w + x0] * wy * (1 - wx)
                    + gray[(size_t)y1 * w + x1] * wy * wx;
            out[(size_t)y * out_w + x] = v / 255.0f;
        }
    }
}

// ------------------------------------------------ CLIP frame preprocessing

// Pillow-exact bicubic resample (Resample.c): per-output-pixel coefficient
// windows with antialias support scaling, 22-bit fixed-point accumulation,
// uint8 intermediate between the horizontal and vertical passes. Replicating
// the fixed-point math keeps the native fast path bit-compatible with the
// PIL path used by HF's CLIPImageProcessor (the reference's preprocessing),
// so swapping it in cannot move the CLIP features.
namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;   // PIL PRECISION_BITS

inline double bicubic_filter(double x) {      // PIL a = -0.5
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Coefficient window per output position `xx` in [x0_out, x0_out+out_n):
// PIL precompute_coeffs with the output shifted by a crop offset expressed
// in *output* pixels (resize-then-crop == computing only the cropped pixels).
void precompute_coeffs(int in_size, int out_size_full, int x0_out, int out_n,
                       std::vector<int>& bounds, std::vector<int32_t>& kk,
                       int* ksize_out) {
    const double scale = (double)in_size / out_size_full;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = 2.0 * filterscale;   // bicubic support = 2
    const int ksize = (int)std::ceil(support) * 2 + 1;
    bounds.assign((size_t)out_n * 2, 0);
    kk.assign((size_t)out_n * ksize, 0);
    std::vector<double> prek(ksize);
    for (int i = 0; i < out_n; ++i) {
        const int xx = x0_out + i;
        const double center = (xx + 0.5) * scale;
        double ww = 0.0;
        const double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        const int n = xmax - xmin;
        for (int x = 0; x < n; ++x) {
            double w = bicubic_filter((x + xmin - center + 0.5) * ss);
            prek[x] = w;
            ww += w;
        }
        for (int x = 0; x < n; ++x) {
            double v = prek[x] / ww * (double)(1 << kPrecisionBits);
            kk[(size_t)i * ksize + x] =
                (int32_t)(v < 0 ? v - 0.5 : v + 0.5);
        }
        for (int x = n; x < ksize; ++x) kk[(size_t)i * ksize + x] = 0;
        bounds[(size_t)i * 2] = xmin;
        bounds[(size_t)i * 2 + 1] = n;
    }
    *ksize_out = ksize;
}

inline uint8_t clip8(int64_t v) {
    v >>= kPrecisionBits;
    if (v < 0) return 0;
    if (v > 255) return 255;
    return (uint8_t)v;
}

}  // namespace

// CLIP-style geometry for a batch of frames: resize shortest edge to `size`
// (bicubic, antialiased, PIL-exact) then center-crop size x size. Input
// uint8 RGB (t, h, w, 3) channels-last; output uint8 (t, size, size, 3).
// Coefficient tables are shared across the batch (same geometry every frame).
void clip_preprocess_batch(const uint8_t* frames, int32_t t, int32_t h,
                           int32_t w, int32_t size, uint8_t* out) {
    const int short_side = h < w ? h : w;
    // PIL round() (banker's) only differs from round-half-up on exact .5,
    // which needs w*size % short_side*2 == 0 — match python round():
    const auto pyround = [](double v) {
        double f = std::floor(v), r = v - f;
        if (r > 0.5) return (int64_t)f + 1;
        if (r < 0.5) return (int64_t)f;
        return (int64_t)(std::fmod(f, 2.0) == 0.0 ? f : f + 1);  // half-even
    };
    const int nw = (int)pyround((double)w * size / short_side);
    const int nh = (int)pyround((double)h * size / short_side);
    const int left = (nw - size) / 2;
    const int top = (nh - size) / 2;

    int hks, vks;
    std::vector<int> hb, vb;
    std::vector<int32_t> hk, vk;
    // horizontal: only the cropped columns; vertical: only cropped rows
    precompute_coeffs(w, nw, left, size, hb, hk, &hks);
    precompute_coeffs(h, nh, top, size, vb, vk, &vks);

    // horizontal pass needs every source row that the vertical pass touches
    int ymin = vb[0];
    int ymax = vb[(size_t)(size - 1) * 2] + vb[(size_t)(size - 1) * 2 + 1];
    const int rows = ymax - ymin;
    std::vector<uint8_t> temp((size_t)rows * size * 3);

    for (int32_t f = 0; f < t; ++f) {
        const uint8_t* src = frames + (size_t)f * h * w * 3;
        // horizontal: (rows, w, 3) -> (rows, size, 3), uint8 intermediate
        for (int y = 0; y < rows; ++y) {
            const uint8_t* row = src + (size_t)(y + ymin) * w * 3;
            uint8_t* trow = temp.data() + (size_t)y * size * 3;
            for (int x = 0; x < size; ++x) {
                const int xmin = hb[(size_t)x * 2];
                const int n = hb[(size_t)x * 2 + 1];
                const int32_t* k = hk.data() + (size_t)x * hks;
                int64_t s0 = 1 << (kPrecisionBits - 1);
                int64_t s1 = s0, s2 = s0;
                const uint8_t* p = row + (size_t)xmin * 3;
                for (int i = 0; i < n; ++i) {
                    s0 += (int64_t)p[3 * i] * k[i];
                    s1 += (int64_t)p[3 * i + 1] * k[i];
                    s2 += (int64_t)p[3 * i + 2] * k[i];
                }
                trow[3 * x] = clip8(s0);
                trow[3 * x + 1] = clip8(s1);
                trow[3 * x + 2] = clip8(s2);
            }
        }
        // vertical: (rows, size, 3) -> (size, size, 3)
        uint8_t* dst = out + (size_t)f * size * size * 3;
        for (int y = 0; y < size; ++y) {
            const int smin = vb[(size_t)y * 2] - ymin;
            const int n = vb[(size_t)y * 2 + 1];
            const int32_t* k = vk.data() + (size_t)y * vks;
            uint8_t* drow = dst + (size_t)y * size * 3;
            for (int x = 0; x < size * 3; ++x) {
                int64_t s = 1 << (kPrecisionBits - 1);
                for (int i = 0; i < n; ++i)
                    s += (int64_t)temp[(size_t)(smin + i) * size * 3 + x] * k[i];
                drow[x] = clip8(s);
            }
        }
    }
}

// RGB -> YUV 4:2:0 packing for the serving wire format (full-range BT.601,
// mirrors models/clip_vit.py pack_yuv420): input uint8 RGB (t, s, s, 3) with
// s even; outputs y (t, s, s) and uv (t, 2, s/2, s/2) = (Cb, Cr) planes,
// chroma 2x2 box-averaged. Fixed-point (2^20) arithmetic; matches the numpy
// float path to within 1 LSB (rational coefficient rounding only).
void pack_yuv420(const uint8_t* rgb, int32_t t, int32_t s,
                 uint8_t* y_out, uint8_t* uv_out) {
    // Y per pixel in int32 2^16 fixed point (max 255*2^16 fits comfortably).
    const int32_t cR = 19595, cG = 38470, cB = 7471;       // *2^16, sum=2^16
    // Chroma is linear in RGB, so the 2x2 box average commutes with the
    // YCbCr transform: compute Cb/Cr once per block from the RGB block sums
    // (4x less chroma arithmetic, no intermediate planes).
    const int64_t kCb = 36984;    // (1/1.772) * 2^16
    const int64_t kCr = 46743;    // (1/1.402) * 2^16
    const int h = s / 2;
    for (int32_t f = 0; f < t; ++f) {
        const uint8_t* src = rgb + (size_t)f * s * s * 3;
        uint8_t* ydst = y_out + (size_t)f * s * s;
        uint8_t* cbd = uv_out + (size_t)f * 2 * h * h;
        uint8_t* crd = cbd + (size_t)h * h;
        for (int yy = 0; yy < h; ++yy) {
            const uint8_t* row0 = src + (size_t)(2 * yy) * s * 3;
            const uint8_t* row1 = row0 + (size_t)s * 3;
            uint8_t* yrow0 = ydst + (size_t)(2 * yy) * s;
            uint8_t* yrow1 = yrow0 + s;
            for (int xx = 0; xx < h; ++xx) {
                const uint8_t* p00 = row0 + (size_t)(2 * xx) * 3;
                const uint8_t* p01 = p00 + 3;
                const uint8_t* p10 = row1 + (size_t)(2 * xx) * 3;
                const uint8_t* p11 = p10 + 3;
                const int32_t y00 = cR * p00[0] + cG * p00[1] + cB * p00[2];
                const int32_t y01 = cR * p01[0] + cG * p01[1] + cB * p01[2];
                const int32_t y10 = cR * p10[0] + cG * p10[1] + cB * p10[2];
                const int32_t y11 = cR * p11[0] + cG * p11[1] + cB * p11[2];
                yrow0[2 * xx] = (uint8_t)((y00 + (1 << 15)) >> 16);
                yrow0[2 * xx + 1] = (uint8_t)((y01 + (1 << 15)) >> 16);
                yrow1[2 * xx] = (uint8_t)((y10 + (1 << 15)) >> 16);
                yrow1[2 * xx + 1] = (uint8_t)((y11 + (1 << 15)) >> 16);
                const int32_t rs = p00[0] + p01[0] + p10[0] + p11[0];
                const int32_t bs = p00[2] + p01[2] + p10[2] + p11[2];
                const int64_t ys = (int64_t)y00 + y01 + y10 + y11;  // *2^16
                // mean diff in 2^16 fp: ((sum<<16) - ys) / 4
                const int64_t db = (((int64_t)bs << 16) - ys) >> 2;
                const int64_t dr = (((int64_t)rs << 16) - ys) >> 2;
                int64_t b8 = ((db * kCb >> 16) + (128 << 16) + (1 << 15))
                             >> 16;
                int64_t r8 = ((dr * kCr >> 16) + (128 << 16) + (1 << 15))
                             >> 16;
                cbd[(size_t)yy * h + xx] =
                    (uint8_t)(b8 < 0 ? 0 : (b8 > 255 ? 255 : b8));
                crd[(size_t)yy * h + xx] =
                    (uint8_t)(r8 < 0 ? 0 : (r8 > 255 ? 255 : r8));
            }
        }
    }
}

}  // extern "C"
