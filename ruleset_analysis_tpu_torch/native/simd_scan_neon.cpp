// NEON implementations of the tokenizer scan primitives (aarch64).
//
// NEON is baseline on aarch64, so no runtime CPU probe is needed — the
// guard below is purely compile-time.  Mask extraction uses the
// vshrn_n_u16 narrowing trick (one 64-bit nibble mask per 16-byte
// block, 4 bits per lane).  The same no-read-past-end discipline as the
// AVX2 TU applies: 16-byte blocks strictly inside [p, end), scalar tail.

#include "simd_scan.h"

#if defined(__ARM_NEON) || defined(__aarch64__)

#include <arm_neon.h>

#include <cstring>

namespace {

inline bool sc_is_sp(char c) {
    return c == ' ' || c == '\t' || c == '\v' || c == '\f' || c == '\r' ||
           c == '\n';
}
inline bool sc_is_dig(char c) { return c >= '0' && c <= '9'; }
inline bool sc_is_addr(char c) {
    return sc_is_dig(c) || (c >= 'a' && c <= 'f') || (c >= 'A' && c <= 'F') ||
           c == ':' || c == '.';
}

// 4 bits per byte lane: bit i*4 set iff lane i's comparison was true
inline uint64_t nibble_mask(uint8x16_t eq) {
    return vget_lane_u64(
        vreinterpret_u64_u8(vshrn_n_u16(vreinterpretq_u16_u8(eq), 4)), 0);
}

inline uint8x16_t in_range(uint8x16_t v, uint8_t lo, uint8_t span) {
    return vcleq_u8(vsubq_u8(v, vdupq_n_u8(lo)), vdupq_n_u8(span));
}





int64_t count_nl_neon(const char* p, int64_t n) {
    const char* end = p + n;
    const uint8x16_t nl = vdupq_n_u8('\n');
    int64_t c = 0;
    while (p + 16 <= end) {
        uint8x16_t eq = vceqq_u8(vld1q_u8((const uint8_t*)p), nl);
        // each matching lane contributes 0xFF; sum/255 = count
        c += vaddvq_u8(vshrq_n_u8(eq, 7));
        p += 16;
    }
    while (p < end) c += (*p++ == '\n');
    return c;
}

int64_t nl_positions_neon(const char* p, int64_t n, uint32_t* out,
                          int64_t max_out) {
    const char* base = p;
    const char* end = p + n;
    const uint8x16_t nl = vdupq_n_u8('\n');
    int64_t c = 0;
    while (p + 16 <= end && c < max_out) {
        uint64_t m = nibble_mask(vceqq_u8(vld1q_u8((const uint8_t*)p), nl));
        // each matching lane owns one 4-bit nibble: consume nibble by
        // nibble (clear all 4 bits so ctz advances a full lane)
        while (m) {
            int lane = __builtin_ctzll(m) >> 2;
            out[c++] = (uint32_t)(p - base) + (uint32_t)lane;
            if (c == max_out) return c;
            m &= ~(0xFull << (4 * lane));
        }
        p += 16;
    }
    while (p < end && c < max_out) {
        if (*p == '\n') out[c++] = (uint32_t)(p - base);
        ++p;
    }
    return c;
}

int64_t nl_skip_neon(const char* p, int64_t n, int64_t k, int64_t* bytes) {
    const char* base = p;
    const char* end = p + n;
    const uint8x16_t nl = vdupq_n_u8('\n');
    int64_t c = 0;
    int64_t past_last = 0;
    while (p + 16 <= end && c < k) {
        uint8x16_t eq = vceqq_u8(vld1q_u8((const uint8_t*)p), nl);
        int cnt = vaddvq_u8(vshrq_n_u8(eq, 7));
        if (cnt && c + cnt < k) {
            uint64_t m = nibble_mask(eq);
            past_last = (p - base) + (63 - __builtin_clzll(m)) / 4 + 1;
            c += cnt;
        } else if (cnt) {
            for (int i = 0; i < 16 && c < k; ++i) {
                if (p[i] == '\n') {
                    ++c;
                    past_last = (p - base) + i + 1;
                }
            }
        }
        p += 16;
    }
    while (p < end && c < k) {
        if (*p == '\n') {
            ++c;
            past_last = (p - base) + 1;
        }
        ++p;
    }
    *bytes = past_last;
    return c;
}



const ra_simd::ScanOps kOps = {
    "neon", count_nl_neon, nl_positions_neon, nl_skip_neon,
};

}  // namespace

namespace ra_simd {
const ScanOps* neon_ops() { return &kOps; }
}  // namespace ra_simd

#else  // !NEON

namespace ra_simd {
const ScanOps* neon_ops() { return nullptr; }
}  // namespace ra_simd

#endif
