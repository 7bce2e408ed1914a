// AVX2 implementations of the tokenizer scan primitives (x86-64).
//
// Compiled with -mavx2 by the Makefile on x86-64 hosts only; on other
// architectures (or a toolchain without AVX2 support) the preprocessor
// guard below reduces this TU to a nullptr stub, so the link never
// breaks and the dispatch in asaparse.cpp simply stays scalar.
//
// Every loop processes 32-byte blocks strictly inside [p, end) and
// finishes the tail with the scalar character test — no load ever
// touches bytes past `end`, which is what lets the mutant sweep place
// lines flush against the end of an exactly-sized buffer.

#include "simd_scan.h"

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

// unsigned "x - lo <= span" range test per byte: min_epu8(d, span) == d
inline __m256i in_range(__m256i v, char lo, int span) {
    __m256i d = _mm256_sub_epi8(v, _mm256_set1_epi8(lo));
    return _mm256_cmpeq_epi8(_mm256_min_epu8(d, _mm256_set1_epi8((char)span)), d);
}





int64_t count_nl_avx2(const char* p, int64_t n) {
    const char* end = p + n;
    const __m256i nl = _mm256_set1_epi8('\n');
    int64_t c = 0;
    while (p + 32 <= end) {
        __m256i v = _mm256_loadu_si256((const __m256i*)p);
        c += __builtin_popcount(
            (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, nl)));
        p += 32;
    }
    while (p < end) c += (*p++ == '\n');
    return c;
}

int64_t nl_positions_avx2(const char* p, int64_t n, uint32_t* out,
                          int64_t max_out) {
    const char* base = p;
    const char* end = p + n;
    const __m256i nl = _mm256_set1_epi8('\n');
    int64_t c = 0;
    while (p + 32 <= end && c < max_out) {
        __m256i v = _mm256_loadu_si256((const __m256i*)p);
        uint32_t m = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, nl));
        while (m) {
            out[c++] = (uint32_t)(p - base) + (uint32_t)__builtin_ctz(m);
            if (c == max_out) return c;
            m &= m - 1;
        }
        p += 32;
    }
    while (p < end && c < max_out) {
        if (*p == '\n') out[c++] = (uint32_t)(p - base);
        ++p;
    }
    return c;
}

int64_t nl_skip_avx2(const char* p, int64_t n, int64_t k, int64_t* bytes) {
    const char* base = p;
    const char* end = p + n;
    const __m256i nl = _mm256_set1_epi8('\n');
    int64_t c = 0;
    int64_t past_last = 0;  // offset one past the last counted newline
    while (p + 32 <= end && c < k) {
        __m256i v = _mm256_loadu_si256((const __m256i*)p);
        uint32_t m = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, nl));
        int cnt = __builtin_popcount(m);
        if (c + cnt < k) {
            if (cnt) {
                // highest set bit = last newline in this block
                past_last = (p - base) + (31 - __builtin_clz(m)) + 1;
            }
            c += cnt;
        } else {
            // the k-th newline is inside this block: walk its set bits
            while (c < k) {
                past_last = (p - base) + __builtin_ctz(m) + 1;
                m &= m - 1;
                ++c;
            }
        }
        p += 32;
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
    "avx2", count_nl_avx2, nl_positions_avx2, nl_skip_avx2,
};

}  // namespace

namespace ra_simd {
const ScanOps* avx2_ops() {
    return __builtin_cpu_supports("avx2") ? &kOps : nullptr;
}
}  // namespace ra_simd

#else  // !__AVX2__

namespace ra_simd {
const ScanOps* avx2_ops() { return nullptr; }
}  // namespace ra_simd

#endif
