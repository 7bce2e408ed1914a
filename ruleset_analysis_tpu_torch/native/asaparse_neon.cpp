// NEON build of the ASA line parser (aarch64).
//
// NEON is baseline on aarch64 — the guard is compile-time only.  Mask
// extraction uses the vshrn_n_u16 narrowing trick (a 64-bit nibble mask
// per 16-byte block).  The same inline-into-the-tokenizer structure and
// no-read-past-end discipline as the AVX2 TU apply.

#include "asaparse_types.h"

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

// 4 bits per byte lane: nibble i of the result covers lane i
inline uint64_t nibble_mask(uint8x16_t eq) {
    return vget_lane_u64(
        vreinterpret_u64_u8(vshrn_n_u16(vreinterpretq_u16_u8(eq), 4)), 0);
}

inline uint8x16_t in_range(uint8x16_t v, uint8_t lo, uint8_t span) {
    return vcleq_u8(vsubq_u8(v, vdupq_n_u8(lo)), vdupq_n_u8(span));
}

inline const char* ra_scan_addr_end(const char* p, const char* end) {
    while (p + 16 <= end) {
        uint8x16_t v = vld1q_u8((const uint8_t*)p);
        uint8x16_t ok = vorrq_u8(
            vorrq_u8(in_range(v, 0x30, 0x0A), in_range(v, 0x41, 5)),
            vorrq_u8(in_range(v, 0x61, 5), vceqq_u8(v, vdupq_n_u8('.'))));
        uint64_t bad = ~nibble_mask(ok);
        if (bad) return p + (__builtin_ctzll(bad) >> 2);
        p += 16;
    }
    while (p < end && sc_is_addr(*p)) ++p;
    return p;
}

inline const char* ra_scan_token_end(const char* p, const char* end) {
    while (p + 16 <= end) {
        uint8x16_t v = vld1q_u8((const uint8_t*)p);
        uint8x16_t ws =
            vorrq_u8(vceqq_u8(v, vdupq_n_u8(' ')), in_range(v, 0x09, 4));
        uint64_t m = nibble_mask(ws);
        if (m) return p + (__builtin_ctzll(m) >> 2);
        p += 16;
    }
    while (p < end && !sc_is_sp(*p)) ++p;
    return p;
}

// Dotted-quad fast parse: same accept-only-when-provable contract as the
// AVX2 build, with byte-wise classification over the <=16-byte window.
inline int ra_scan_ipv4(const char** pp, const char* end, uint32_t* out) {
    const char* p = *pp;
    int64_t avail = end - p;
    if (avail < 7) return -1;
    int64_t n = avail < 16 ? avail : 16;
    int64_t t = 0;
    while (t < n && (sc_is_dig(p[t]) || p[t] == '.')) ++t;
    if (t == n && p + n < end) return -1;
    uint32_t value = 0;
    int dots = 0;
    int64_t pos = 0;
    for (int64_t i = 0; i <= t; ++i) {
        if (i == t || p[i] == '.') {
            int64_t len = i - pos;
            if (len < 1 || len > 3) return -1;
            uint32_t o = 0;
            for (int64_t j = pos; j < i; ++j) {
                if (!sc_is_dig(p[j])) return -1;
                o = o * 10 + (uint32_t)(p[j] - '0');
            }
            if (o > 255) return -1;
            value = (value << 8) | o;
            pos = i + 1;
            if (i < t) ++dots;
        }
    }
    if (dots != 3) return -1;
    *out = value;
    *pp = p + t;
    return 1;
}

}  // namespace

#define RA_PARSE_NS ra_neon
#include "asaparse_line.inl"
#undef RA_PARSE_NS

namespace ra_parse {
HandleLineFn neon_handle_line() { return &ra_neon::handle_line; }
}  // namespace ra_parse

#else  // !NEON

namespace ra_parse {
HandleLineFn neon_handle_line() { return nullptr; }
}  // namespace ra_parse

#endif
