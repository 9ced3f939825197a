// The host crop's bilinear resize (data/augment.py: random_resized_crop),
// a host helper built by ops/build.py: host_library.
//
// This is the JAX package's native resize (native/imageproc.cpp: make_taps
// and resize_u8, mode 0) statement for statement, in the same loop order,
// and it is built with the same flags as native/Makefile (-O3
// -march=native). Its float32 sums round where that build's compiler
// contracts a multiply and an add into one FMA, which depends on the
// compiler and the machine; keeping the expressions and the flags the
// same lets the compiler make the same choices, so the crop equals the
// JAX package's bit for bit on the machine that built both.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Antialiased bilinear taps for one output axis (PIL-style: the support
// widens by the downscale factor).
struct Taps {
    int* start;     // (dn,) first source index
    float* weights; // (dn, max_taps)
    int max_taps;
};

static Taps make_taps(int sn, int dn) {
    const float scale = static_cast<float>(sn) / dn;
    const float filt = std::max(scale, 1.0f);
    const float base_support = 1.0f;
    const float support = base_support * filt;
    const int max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
    Taps t;
    t.start = new int[dn];
    t.weights = new float[static_cast<size_t>(dn) * max_taps]();
    t.max_taps = max_taps;
    for (int x = 0; x < dn; ++x) {
        const float center = (x + 0.5f) * scale - 0.5f;
        int x0 = static_cast<int>(std::floor(center - support)) + 1;
        x0 = std::clamp(x0, 0, sn - 1);
        int x1 = static_cast<int>(std::ceil(center + support)) + 1;
        x1 = std::min(x1, sn);
        t.start[x] = x0;
        float wsum = 0.0f;
        float* w = t.weights + static_cast<size_t>(x) * max_taps;
        for (int k = 0; k < x1 - x0 && k < max_taps; ++k) {
            const float d = (center - (x0 + k)) / filt;
            w[k] = std::max(0.0f, 1.0f - std::fabs(d));
            wsum += w[k];
        }
        if (wsum > 0)
            for (int k = 0; k < max_taps; ++k) w[k] /= wsum;
    }
    return t;
}

// Separable antialiased bilinear resize, uint8 HWC -> uint8 HWC.
void bilinear_resize_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
    Taps tx = make_taps(sw, dw);
    Taps ty = make_taps(sh, dh);
    // horizontal pass into a float intermediate (sh, dw, c)
    float* tmp = new float[static_cast<size_t>(sh) * dw * c];
    for (int y = 0; y < sh; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * sw * c;
        for (int x = 0; x < dw; ++x) {
            const float* w = tx.weights
                + static_cast<size_t>(x) * tx.max_taps;
            const int x0 = tx.start[x];
            float* out = tmp + (static_cast<size_t>(y) * dw + x) * c;
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.0f;
                for (int k = 0; k < tx.max_taps; ++k) {
                    const int xi = std::min(x0 + k, sw - 1);
                    acc += w[k] * row[xi * c + ch];
                }
                out[ch] = acc;
            }
        }
    }
    // vertical pass
    for (int y = 0; y < dh; ++y) {
        const float* w = ty.weights + static_cast<size_t>(y) * ty.max_taps;
        const int y0 = ty.start[y];
        for (int x = 0; x < dw; ++x) {
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.0f;
                for (int k = 0; k < ty.max_taps; ++k) {
                    const int yi = std::min(y0 + k, sh - 1);
                    acc += w[k] * tmp[(static_cast<size_t>(yi) * dw + x) * c
                                      + ch];
                }
                dst[(static_cast<size_t>(y) * dw + x) * c + ch] =
                    static_cast<uint8_t>(
                        std::clamp(acc + 0.5f, 0.0f, 255.0f));
            }
        }
    }
    delete[] tmp;
    delete[] tx.start;
    delete[] tx.weights;
    delete[] ty.start;
    delete[] ty.weights;
}

}  // extern "C"
