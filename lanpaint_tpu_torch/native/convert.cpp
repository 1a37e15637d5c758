// Native data-plane for checkpoint loading: multithreaded dtype conversion.
//
// The reference delegates model loading to its ComfyUI host (torch
// safetensors, single-threaded casts); this framework loads multi-GB
// safetensors checkpoints itself (models/load.py), and the hot loop —
// fp16/bf16/fp8->fp32 widening of tens of GB — is pure memory-bandwidth
// work that Python/numpy runs single-threaded.  This kernel does the
// conversions with a 64Ki/256-entry lookup table per format across N
// threads, saturating host memory bandwidth.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
// Built on demand by native/__init__.py: g++ -O3 -shared -fPIC -pthread.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---- scalar converters -----------------------------------------------

inline float fp16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;  // +-0
        } else {          // subnormal: normalize
            int shift = 0;
            while (!(man & 0x400)) { man <<= 1; ++shift; }
            man &= 0x3FF;
            bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (man << 13);
        }
    } else if (exp == 0x1F) {
        bits = sign | 0x7F800000u | (man << 13);  // inf/nan
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

// fp8 E4M3FN: 1-4-3, bias 7, no inf, 0x7F/0xFF = nan
inline float fp8e4m3_to_f32(uint8_t b) {
    uint32_t sign = (uint32_t)(b & 0x80) << 24;
    uint32_t exp = (b >> 3) & 0xF;
    uint32_t man = b & 0x7;
    uint32_t bits;
    if (exp == 0xF && man == 0x7) {
        bits = sign | 0x7FC00000u;  // nan
    } else if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {
            int shift = 0;
            while (!(man & 0x8)) { man <<= 1; ++shift; }
            man &= 0x7;
            bits = sign | ((uint32_t)(127 - 6 - shift) << 23) | (man << 20);
        }
    } else {
        bits = sign | ((exp - 7 + 127) << 23) | (man << 20);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

// fp8 E5M2: 1-5-2, bias 15, IEEE-style inf/nan
inline float fp8e5m2_to_f32(uint8_t b) {
    uint32_t sign = (uint32_t)(b & 0x80) << 24;
    uint32_t exp = (b >> 2) & 0x1F;
    uint32_t man = b & 0x3;
    uint32_t bits;
    if (exp == 0x1F) {
        bits = sign | 0x7F800000u | (man << 21);  // inf/nan
    } else if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {
            int shift = 0;
            while (!(man & 0x4)) { man <<= 1; ++shift; }
            man &= 0x3;
            bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (man << 21);
        }
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 21);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

// ---- lookup tables (built once, thread-safe via static init) ----------

struct Tables {
    std::vector<float> fp16;     // 65536
    std::vector<float> e4m3;     // 256
    std::vector<float> e5m2;     // 256
    Tables() : fp16(65536), e4m3(256), e5m2(256) {
        for (uint32_t i = 0; i < 65536; ++i) fp16[i] = fp16_to_f32((uint16_t)i);
        for (uint32_t i = 0; i < 256; ++i) {
            e4m3[i] = fp8e4m3_to_f32((uint8_t)i);
            e5m2[i] = fp8e5m2_to_f32((uint8_t)i);
        }
    }
};

const Tables& tables() {
    static Tables t;
    return t;
}

enum DType {
    DT_F16 = 0,
    DT_BF16 = 1,
    DT_F8_E4M3 = 2,
    DT_F8_E5M2 = 3,
};

void convert_range(const uint8_t* src, float* dst, int64_t lo, int64_t hi,
                   int dtype, float scale) {
    const Tables& t = tables();
    switch (dtype) {
        case DT_F16: {
            const uint16_t* s = (const uint16_t*)src;
            for (int64_t i = lo; i < hi; ++i) dst[i] = t.fp16[s[i]] * scale;
            break;
        }
        case DT_BF16: {
            const uint16_t* s = (const uint16_t*)src;
            for (int64_t i = lo; i < hi; ++i) {
                uint32_t bits = (uint32_t)s[i] << 16;
                float v;
                std::memcpy(&v, &bits, 4);
                dst[i] = v * scale;
            }
            break;
        }
        case DT_F8_E4M3:
            for (int64_t i = lo; i < hi; ++i) dst[i] = t.e4m3[src[i]] * scale;
            break;
        case DT_F8_E5M2:
            for (int64_t i = lo; i < hi; ++i) dst[i] = t.e5m2[src[i]] * scale;
            break;
    }
}

}  // namespace

extern "C" {

// Convert n elements of `dtype` at src into fp32 dst, times scale, using
// up to nthreads threads.  Returns 0 on success, -1 on bad dtype.
int lp_convert_f32(const uint8_t* src, float* dst, int64_t n, int dtype,
                   float scale, int nthreads) {
    if (dtype < 0 || dtype > 3) return -1;
    if (nthreads < 1) nthreads = 1;
    const int64_t kMin = 1 << 20;  // don't spawn threads for small tensors
    if (n < kMin || nthreads == 1) {
        convert_range(src, dst, 0, n, dtype, scale);
        return 0;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int i = 0; i < nthreads; ++i) {
        int64_t lo = (int64_t)i * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        ts.emplace_back(convert_range, src, dst, lo, hi, dtype, scale);
    }
    for (auto& th : ts) th.join();
    return 0;
}

// Multithreaded memcpy for the no-conversion fast path (fp32 tensors out of
// the page cache; single-threaded memcpy leaves bandwidth on the table).
void lp_copy(const uint8_t* src, uint8_t* dst, int64_t nbytes, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    const int64_t kMin = 1 << 22;
    if (nbytes < kMin || nthreads == 1) {
        std::memcpy(dst, src, (size_t)nbytes);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (nbytes + nthreads - 1) / nthreads;
    for (int i = 0; i < nthreads; ++i) {
        int64_t lo = (int64_t)i * chunk;
        int64_t hi = lo + chunk < nbytes ? lo + chunk : nbytes;
        if (lo >= hi) break;
        ts.emplace_back([=] { std::memcpy(dst + lo, src + lo, (size_t)(hi - lo)); });
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"
