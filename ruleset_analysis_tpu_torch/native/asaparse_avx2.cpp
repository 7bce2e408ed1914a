// AVX2 build of the ASA line parser (x86-64).
//
// The scan kernels below are file-local inline functions, so the
// compiler inlines them straight into the tokenizer loops of
// asaparse_line.inl — per-line dispatch, zero per-token call overhead
// (a ScanOps-style function pointer per token was measured at
// 0.93-0.95x).  Compiled with -mavx2 by the Makefile on x86-64; on
// other architectures this TU reduces to a nullptr stub.
//
// No load ever touches bytes past `end`: 32-byte blocks run strictly
// inside [p, end), tails fall back to the scalar character test, and
// the dotted-quad window is memcpy'd — the mutant sweep places lines
// flush against the end of exactly-sized buffers to enforce this.

#include "asaparse_types.h"

#if defined(__AVX2__)

#include <immintrin.h>

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

// unsigned "x - lo <= span" range test per byte
inline __m256i in_range(__m256i v, char lo, int span) {
    __m256i d = _mm256_sub_epi8(v, _mm256_set1_epi8(lo));
    return _mm256_cmpeq_epi8(_mm256_min_epu8(d, _mm256_set1_epi8((char)span)),
                             d);
}

inline const char* ra_scan_addr_end(const char* p, const char* end) {
    while (p + 32 <= end) {
        __m256i v = _mm256_loadu_si256((const __m256i*)p);
        // '0'..':' is one contiguous range (0x30..0x3A): digits + colon
        __m256i ok = _mm256_or_si256(
            _mm256_or_si256(in_range(v, 0x30, 0x0A), in_range(v, 0x41, 5)),
            _mm256_or_si256(in_range(v, 0x61, 5),
                            _mm256_cmpeq_epi8(v, _mm256_set1_epi8('.'))));
        uint32_t bad = ~(uint32_t)_mm256_movemask_epi8(ok);
        if (bad) return p + __builtin_ctz(bad);
        p += 32;
    }
    while (p < end && sc_is_addr(*p)) ++p;
    return p;
}

inline const char* ra_scan_token_end(const char* p, const char* end) {
    while (p + 32 <= end) {
        __m256i v = _mm256_loadu_si256((const __m256i*)p);
        __m256i ws = _mm256_or_si256(
            _mm256_cmpeq_epi8(v, _mm256_set1_epi8(' ')), in_range(v, 0x09, 4));
        uint32_t m = (uint32_t)_mm256_movemask_epi8(ws);
        if (m) return p + __builtin_ctz(m);
        p += 32;
    }
    while (p < end && !sc_is_sp(*p)) ++p;
    return p;
}

// Dotted-quad fast parse: classify a <=16-byte window with SSE, derive
// octets from the dot mask.  Accepts ONLY patterns the scalar reference
// provably accepts with the same value (exactly 3 dots, octet lengths
// 1..3, values <= 255, run terminated inside the window or exactly at
// `end`); everything else defers (-1) to the scalar loop.
inline int ra_scan_ipv4(const char** pp, const char* end, uint32_t* out) {
    const char* p = *pp;
    int64_t avail = end - p;
    if (avail < 7) return -1;  // shortest quad "1.2.3.4"
    int64_t n = avail < 16 ? avail : 16;
    unsigned char buf[16];
    memset(buf, 0, sizeof(buf));
    memcpy(buf, p, (size_t)n);
    __m128i v = _mm_loadu_si128((const __m128i*)buf);
    __m128i d = _mm_sub_epi8(v, _mm_set1_epi8(0x30));
    __m128i isd = _mm_cmpeq_epi8(_mm_min_epu8(d, _mm_set1_epi8(9)), d);
    uint32_t lanes = (n == 16) ? 0xFFFFu : ((1u << n) - 1);
    uint32_t dm = (uint32_t)_mm_movemask_epi8(isd) & lanes;
    uint32_t dotm =
        (uint32_t)_mm_movemask_epi8(_mm_cmpeq_epi8(v, _mm_set1_epi8('.'))) &
        lanes;
    uint32_t run = dm | dotm;
    uint32_t nonrun = ~run & lanes;
    int64_t t = nonrun ? __builtin_ctz(nonrun) : n;
    if (t == n && p + n < end) return -1;  // run extends past the window
    uint32_t rm = t >= 16 ? 0xFFFFu : ((1u << t) - 1);
    dotm &= rm;
    if (__builtin_popcount(dotm) != 3) return -1;
    uint32_t value = 0;
    int64_t pos = 0;
    uint32_t dots = dotm;
    for (int oi = 0; oi < 4; ++oi) {
        int64_t oe = (oi < 3) ? __builtin_ctz(dots) : t;
        if (oi < 3) dots &= dots - 1;
        int64_t len = oe - pos;
        if (len < 1 || len > 3) return -1;  // leading-zero long octets: scalar
        uint32_t o = 0;
        for (int64_t i = pos; i < oe; ++i) {
            if (!(dm & (1u << i))) return -1;  // a dot where a digit must be
            o = o * 10 + (uint32_t)(buf[i] - '0');
        }
        if (o > 255) return -1;  // scalar rejects too; defer the verdict
        value = (value << 8) | o;
        pos = oe + 1;
    }
    // scalar trailing check already satisfied: byte t is neither a digit
    // nor '.', or the run ends exactly at `end`
    *out = value;
    *pp = p + t;
    return 1;
}

}  // namespace

#define RA_PARSE_NS ra_avx2
#include "asaparse_line.inl"
#undef RA_PARSE_NS

namespace ra_parse {
HandleLineFn avx2_handle_line() {
    return __builtin_cpu_supports("avx2") ? &ra_avx2::handle_line : nullptr;
}
}  // namespace ra_parse

#else  // !__AVX2__

namespace ra_parse {
HandleLineFn avx2_handle_line() { return nullptr; }
}  // namespace ra_parse

#endif
