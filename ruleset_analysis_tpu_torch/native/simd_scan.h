// SIMD BULK scan primitives for the ASA tokenizer.
//
// This table holds the primitives whose inputs are megabytes, not
// tokens — newline indexing, counting, and skipping — where one
// function call amortizes over the whole buffer.  Per-TOKEN scans
// (token ends, address runs, the dotted-quad parse) do NOT go through a
// table: an indirect call per 10-byte token was measured at 0.93-0.95x,
// so those inline into the per-ISA line-parser builds instead
// (asaparse_line.inl included by asaparse_avx2.cpp / asaparse_neon.cpp).
//
// Contract: every primitive must return EXACTLY what the scalar loop it
// replaces would return, for every input, including truncated tails at
// buffer edges — implementations never read past [p, p+n).  The 12k
// mutant sweep in tests/test_torch_fastparse.py asserts output identity of
// the full parse under both dispatch states.

#pragma once

#include <cstddef>
#include <cstdint>

namespace ra_simd {

struct ScanOps {
    const char* name;  // "avx2" | "neon" (artifact / test reporting)

    // Newline count over [p, p+n).
    int64_t (*count_nl)(const char* p, int64_t n);

    // Offsets (relative to p) of the first min(max_out, total) newlines
    // in [p, p+n), written to out; returns the count written.  Stops
    // scanning once max_out positions are found.
    int64_t (*nl_positions)(const char* p, int64_t n, uint32_t* out,
                            int64_t max_out);

    // Skip past up to k newlines: returns c = min(k, newlines in
    // [p, p+n)) and sets *bytes to the offset one past the c-th newline
    // (0 when c == 0).  The caller layers the trailing-fragment /
    // `final` semantics on top.
    int64_t (*nl_skip)(const char* p, int64_t n, int64_t k, int64_t* bytes);
};

// nullptr when the TU was compiled without the ISA or the CPU lacks it.
const ScanOps* avx2_ops();
const ScanOps* neon_ops();

}  // namespace ra_simd
