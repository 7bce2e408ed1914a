// Native ASA syslog parser + tuple packer (the host-side hot loop).
//
// SURVEY.md §8.2 names host-side syslog parsing as the end-to-end
// bottleneck at target rates: the device pipeline sustains millions of
// lines/sec/chip, so a Python regex parser starves it.  This library is
// the native tier of the runtime: it parses raw ASA syslog bytes and
// packs valid lines directly into the column-major [TUPLE_COLS, B]
// uint32 batch layout the device step consumes — one pass, no Python
// objects, no regex engine.
//
// Semantics mirror hostside/syslog.py (parse_line)
// and pack.py (LinePacker) exactly; tests/test_torch_fastparse.py asserts the
// two paths produce identical batches on synthetic and edge-case
// corpora.  Both paths skip lines whose IPv4 octets, ports (> 65535) or
// protocol numbers (> 255) exceed their field widths.
//
// SIMD layout: the line parser body lives in
// asaparse_line.inl and compiles once per ISA — the scalar reference
// here, AVX2 in asaparse_avx2.cpp, NEON in asaparse_neon.cpp — with the
// ISA's scan kernels inlined into the tokenizer loops.  This TU owns the
// runtime dispatch (CPU probe, RA_SIMD override, asa_simd_set A/B
// switch): chunk loops resolve ONE handle-line pointer per call and the
// bulk newline scans go through the ra_simd::ScanOps table.  Outputs are
// byte-identical across every dispatch state (the 12k mutant sweep in
// tests/test_torch_fastparse.py pins it).
//
// C ABI only (loaded via ctypes; no pybind11 in this image).

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "asaparse_types.h"
#include "simd_scan.h"

// ---------------------------------------------------------------------------
// Scalar scan kernels for the reference build of the line parser: plain
// byte loops (the compiler may auto-vectorize under -march=native, but
// the SEMANTICS are the reference), and a dotted-quad hook that always
// defers to the inline scalar parse.
// ---------------------------------------------------------------------------

static inline const char* ra_scan_token_end(const char* p, const char* end) {
    while (p < end &&
           !(*p == ' ' || *p == '\t' || *p == '\v' || *p == '\f' ||
             *p == '\r' || *p == '\n'))
        ++p;
    return p;
}

static inline const char* ra_scan_addr_end(const char* p, const char* end) {
    while (p < end &&
           ((*p >= '0' && *p <= '9') || (*p >= 'a' && *p <= 'f') ||
            (*p >= 'A' && *p <= 'F') || *p == ':' || *p == '.'))
        ++p;
    return p;
}

static inline int ra_scan_ipv4(const char** pp, const char* end,
                               uint32_t* out) {
    (void)pp;
    (void)end;
    (void)out;
    return -1;  // always use the inline scalar reference parse
}

#define RA_PARSE_NS ra_scalar
#include "asaparse_line.inl"
#undef RA_PARSE_NS

namespace ra_parse {
HandleLineFn scalar_handle_line() { return &ra_scalar::handle_line; }
}  // namespace ra_parse

namespace {

using ra_parse::HandleLineFn;
using ra_parse::LocalCtx;
using ra_parse::Packer;

constexpr int64_t TUPLE_COLS = 7;

// ---------------------------------------------------------------------------
// Runtime SIMD dispatch: ONE handle-line pointer (whole-line parser,
// per-ISA build) plus one ScanOps table (bulk newline scans).  Selected
// once per process from the CPU probe; RA_SIMD=off/0/false forces
// scalar, asa_simd_set() flips at runtime so one process can A/B both
// sides of the scalar-vs-SIMD identity tests.
// ---------------------------------------------------------------------------

std::atomic<HandleLineFn> g_handle{nullptr};
std::atomic<const ra_simd::ScanOps*> g_scan_ops{nullptr};
std::once_flag g_simd_once;

void pick_dispatch(bool simd_on) {
    HandleLineFn h = nullptr;
    const ra_simd::ScanOps* o = nullptr;
    if (simd_on) {
        h = ra_parse::avx2_handle_line();
        if (!h) h = ra_parse::neon_handle_line();
        o = ra_simd::avx2_ops();
        if (!o) o = ra_simd::neon_ops();
    }
    g_handle.store(h ? h : ra_parse::scalar_handle_line(),
                   std::memory_order_relaxed);
    g_scan_ops.store(o, std::memory_order_relaxed);
}

void simd_init() {
    std::call_once(g_simd_once, [] {
        const char* e = std::getenv("RA_SIMD");
        bool off = e && (strcmp(e, "off") == 0 || strcmp(e, "0") == 0 ||
                         strcmp(e, "false") == 0);
        pick_dispatch(!off);
    });
}

inline HandleLineFn handle_line_fn() {
    return g_handle.load(std::memory_order_relaxed);
}

inline const ra_simd::ScanOps* scan_ops() {
    return g_scan_ops.load(std::memory_order_relaxed);
}

// Build the line-start index for the MT parse paths: up to ``want``
// complete lines from [buf, buf+len), plus the trailing unterminated
// fragment as a final line when ``final_``.  Pushes each line's start
// offset onto ``off`` and returns one past the consumed region.  The
// SIMD path gathers every newline position in bulk (32 bytes/cycle of
// classify+movemask) instead of one memchr call per line.
const char* build_line_index(const char* buf, int64_t len, int final_,
                             int64_t want, std::vector<uint32_t>& off) {
    const char* end = buf + len;
    const char* p = buf;
    const ra_simd::ScanOps* ops = scan_ops();
    if (ops && want > 0) {
        std::vector<uint32_t> nls((size_t)want);
        int64_t c = ops->nl_positions(buf, len, nls.data(), want);
        uint32_t start = 0;
        for (int64_t i = 0; i < c; ++i) {
            off.push_back(start);
            start = nls[(size_t)i] + 1;
        }
        p = buf + start;
        if (c < want && p < end && final_) {  // trailing fragment
            off.push_back(start);
            p = end;
        }
        return p;
    }
    while (p < end && (int64_t)off.size() < want) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        if (!nl && !final_) break;  // incomplete tail line
        off.push_back((uint32_t)(p - buf));
        p = nl ? nl + 1 : end;
    }
    return p;
}

}  // namespace

extern "C" {

void* asa_packer_new() {
    simd_init();
    return new Packer();
}

void asa_packer_free(void* h) { delete (Packer*)h; }

void asa_packer_add_acl(void* h, const char* fw, const char* acl, uint32_t gid) {
    Packer* pk = (Packer*)h;
    std::string k(fw);
    k.push_back('\x01');
    k += acl;
    pk->resolve[k] = gid;
}

void asa_packer_add_binding(void* h, const char* fw, const char* iface, uint32_t gid) {
    Packer* pk = (Packer*)h;
    std::string k(fw);
    k.push_back('\x02');
    k += iface;
    pk->resolve[k] = gid;
}

// out-direction access-group: (firewall, egress interface) -> acl gid.
void asa_packer_add_binding_out(void* h, const char* fw, const char* iface, uint32_t gid) {
    Packer* pk = (Packer*)h;
    std::string k(fw);
    k.push_back('\x03');
    k += iface;
    pk->resolve[k] = gid;
}

int64_t asa_packer_parsed(void* h) { return ((Packer*)h)->parsed; }
int64_t asa_packer_skipped(void* h) { return ((Packer*)h)->skipped; }
void asa_packer_set_counts(void* h, int64_t parsed, int64_t skipped) {
    ((Packer*)h)->parsed = parsed;
    ((Packer*)h)->skipped = skipped;
}

// Zero the padding rows [valid, cap) of every column.  Callers allocate
// the output uninitialized (np.empty); the contract is "padding rows are
// all-zero", matching the pure-Python LinePacker exactly while memsetting
// only the (usually small) tail instead of the whole 28 MB buffer.
void zero_tail(uint32_t* out, int64_t cap, int64_t valid) {
    for (int64_t c = 0; c < TUPLE_COLS; ++c)
        memset(out + c * cap + valid, 0, (size_t)(cap - valid) * sizeof(uint32_t));
}

// Parse up to max_lines newline-terminated lines from buf[0:len) into the
// column-major uint32 out[TUPLE_COLS][cap], using up to n_threads parse
// workers over contiguous line ranges.  With final==0 a trailing fragment
// without '\n' is left unconsumed; with final!=0 it is parsed as the last
// line.  Returns bytes consumed; *n_lines_out lines were consumed,
// *n_valid_out tuples written (rows 0..n_valid-1; rows beyond are zero).
//
// Parallel structure (SURVEY.md §2 L2 — the input-split analog): one
// newline-scan pass builds the line-offset index; lines split evenly
// across workers; each worker parses its range into a private
// column-major slab with a thread-local context; a sequential compaction
// then concatenates the slabs' valid rows in range order.  The output —
// tuple order, counts, consumed bytes — is bit-identical to the
// single-threaded parse.
int64_t asa_pack_chunk_mt(void* h, const char* buf, int64_t len, int final_,
                          int64_t max_lines, uint32_t* out, int64_t cap,
                          int64_t* n_lines_out, int64_t* n_valid_out,
                          int n_threads) {
    simd_init();
    Packer* pk = (Packer*)h;
    const char* end = buf + len;
    int64_t want = max_lines < cap ? max_lines : cap;
    const HandleLineFn handle = handle_line_fn();

    // the parallel path indexes lines with uint32 offsets, and its
    // even-line split can't honor the "keep consuming raw lines while
    // valid < cap" contract that binds when max_lines > cap — route both
    // cases through the exact sequential loop
    if (n_threads != 1 && (len > (int64_t)0xFFFFFFFF || max_lines > cap))
        n_threads = 1;

    if (n_threads == 1) {
        // direct streaming loop: no line index, no scratch — the
        // fastest path for one core and the reference semantics for the
        // parity tests.  Batches are line-atomic: when a line's rows
        // (up to two — in + out evaluation) don't fit, it stays
        // unconsumed and opens the next batch, exactly like the Python
        // _TextSource.
        LocalCtx cx{&pk->resolve, {}};
        const char* p = buf;
        int64_t lines = 0, valid = 0;
        int64_t parsed = 0, skipped = 0;
        while (p < end && lines < max_lines) {
            const char* nl = (const char*)memchr(p, '\n', end - p);
            const char* le = nl ? nl : end;
            if (!nl && !final_) break;  // incomplete tail line
            int n = handle(&cx, p, le, out, cap, valid, nullptr, 0, nullptr);
            if (n < 0) break;  // rows don't fit: close batch, keep line
            if (n == 0) ++skipped;
            else { valid += n; parsed += n; }
            ++lines;
            p = nl ? nl + 1 : end;
        }
        pk->parsed += parsed;
        pk->skipped += skipped;
        zero_tail(out, cap, valid);
        *n_lines_out = lines;
        *n_valid_out = valid;
        return p - buf;
    }

    // ---- pass 1: line-offset index (off[i] = start of line i; off[L] =
    // one past the consumed region)
    std::vector<uint32_t> off;
    off.reserve((size_t)(want > 0 ? want + 1 : 1));
    const char* p = build_line_index(buf, len, final_, want, off);
    const int64_t L = (int64_t)off.size();
    if (L == 0) {
        zero_tail(out, cap, 0);  // same "padding rows are zero" contract
        *n_lines_out = 0;
        *n_valid_out = 0;
        return 0;
    }
    const int64_t consumed = p - buf;
    off.push_back((uint32_t)consumed);
    // line i spans [buf+off[i], buf+off[i+1]) minus the trailing '\n'
    auto line_end = [&](int64_t i) {
        const char* q = buf + off[i + 1];
        return (q > buf + off[i] && q[-1] == '\n') ? q - 1 : q;
    };

    int W = n_threads;
    if (W <= 0) W = (int)std::thread::hardware_concurrency();
    if (W < 1) W = 1;
    if (W > (int)(L / 1024) + 1) W = (int)(L / 1024) + 1;  // tiny batches: few

    // ---- workers: private slabs (2 rows per line: a connection line can
    // emit both an in- and an out-evaluation), thread-local contexts.
    // rows_per_line records each line's emission count so the compaction
    // can re-apply the line-atomic row cap exactly as the sequential loop
    // (and the Python _TextSource) would.
    std::vector<uint32_t> scratch((size_t)(TUPLE_COLS * 2 * L));
    std::vector<uint8_t> rows_per_line((size_t)L);
    std::vector<int64_t> lo(W + 1);
    for (int w = 0; w <= W; ++w) lo[w] = L * w / W;
    std::vector<LocalCtx> ctx((size_t)W);
    std::vector<std::thread> threads;
    threads.reserve((size_t)W);
    for (int w = 0; w < W; ++w) {
        ctx[w].resolve = &pk->resolve;
        threads.emplace_back([&, w]() {
            const int64_t i0 = lo[w], i1 = lo[w + 1];
            const int64_t slab_cap = 2 * (i1 - i0);
            uint32_t* slab = scratch.data() + (size_t)(2 * i0 * TUPLE_COLS);
            LocalCtx* cx = &ctx[w];
            int64_t v = 0;
            for (int64_t i = i0; i < i1; ++i) {
                int n = handle(cx, buf + off[i], line_end(i), slab, slab_cap,
                               v, nullptr, 0, nullptr);
                // n < 0 impossible: slab_cap == 2 * range lines
                rows_per_line[(size_t)i] = (uint8_t)(n > 0 ? n : 0);
                if (n > 0) v += n;
            }
        });
    }
    for (auto& t : threads) t.join();

    // ---- line-atomic row cap: consume lines 0..K-1, K maximal with the
    // cumulative rows fitting in cap (the first non-fitting valid line
    // closes the batch, exactly like the sequential loop)
    int64_t K = 0, total_rows = 0;
    int64_t parsed = 0, skipped = 0;
    for (; K < L; ++K) {
        const int64_t r = rows_per_line[(size_t)K];
        if (total_rows + r > cap) break;
        total_rows += r;
        if (r == 0) ++skipped; else parsed += r;
    }

    // ---- compaction: concatenate consumed lines' rows, preserving order
    int64_t valid = 0;
    for (int w = 0; w < W && lo[w] < K; ++w) {
        const int64_t i0 = lo[w], i1 = lo[w + 1] < K ? lo[w + 1] : K;
        const int64_t slab_cap = 2 * (lo[w + 1] - i0);
        const uint32_t* slab = scratch.data() + (size_t)(2 * i0 * TUPLE_COLS);
        int64_t take = 0;  // rows of this worker's consumed lines
        for (int64_t i = i0; i < i1; ++i) take += rows_per_line[(size_t)i];
        for (int64_t c = 0; c < TUPLE_COLS; ++c)
            memcpy(out + c * cap + valid, slab + c * slab_cap,
                   (size_t)take * sizeof(uint32_t));
        valid += take;
    }
    pk->parsed += parsed;
    pk->skipped += skipped;
    zero_tail(out, cap, valid);
    *n_lines_out = K;
    *n_valid_out = valid;
    return K < L ? (int64_t)off[K] : consumed;
}

// Single-threaded ABI kept for compatibility.
int64_t asa_pack_chunk(void* h, const char* buf, int64_t len, int final_,
                       int64_t max_lines, uint32_t* out, int64_t cap,
                       int64_t* n_lines_out, int64_t* n_valid_out) {
    return asa_pack_chunk_mt(h, buf, len, final_, max_lines, out, cap,
                             n_lines_out, n_valid_out, 1);
}

// Dual-family chunk parse (v6-capable rulesets): v4 rows pack into the
// [TUPLE_COLS, cap] plane exactly as asa_pack_chunk, v6 rows into the
// [13, cap6] TUPLE6 plane (limb layout, pack.py).  Callers size
// cap6 >= 2 * max_lines so the v6 side never closes a batch (mirrors
// the Python _TextSource, whose v6 rows ride a side buffer and never
// close a batch either).  ``n_threads`` splits the parse across workers
// with the same slab/compaction structure as asa_pack_chunk_mt —
// output, counters, and consumed bytes are bit-identical for any
// thread count.  Returns bytes consumed.
int64_t asa_pack_chunk2(void* h, const char* buf, int64_t len, int final_,
                        int64_t max_lines, uint32_t* out, int64_t cap,
                        uint32_t* out6, int64_t cap6,
                        int64_t* n_lines_out, int64_t* n_valid_out,
                        int64_t* n_valid6_out, int n_threads) {
    simd_init();
    constexpr int64_t T6 = 13;  // TUPLE6_COLS
    Packer* pk = (Packer*)h;
    const char* end = buf + len;
    int64_t want = max_lines < cap ? max_lines : cap;
    const HandleLineFn handle = handle_line_fn();
    if (n_threads != 1 && (len > (int64_t)0xFFFFFFFF || max_lines > cap))
        n_threads = 1;  // same constraints as the v4 MT path

    if (n_threads == 1) {
        LocalCtx cx{&pk->resolve, {}};
        const char* p = buf;
        int64_t lines = 0, valid = 0, valid6 = 0;
        int64_t parsed = 0, skipped = 0;
        while (p < end && lines < max_lines) {
            const char* nl = (const char*)memchr(p, '\n', end - p);
            const char* le = nl ? nl : end;
            if (!nl && !final_) break;  // incomplete tail line
            int64_t v6_before = valid6;
            int n = handle(&cx, p, le, out, cap, valid, out6, cap6, &valid6);
            if (n < 0) break;  // rows don't fit: close batch, keep line
            if (n == 0) ++skipped;
            else {
                parsed += n;
                if (valid6 == v6_before) valid += n;  // v4 rows advanced
            }
            ++lines;
            p = nl ? nl + 1 : end;
        }
        pk->parsed += parsed;
        pk->skipped += skipped;
        zero_tail(out, cap, valid);
        for (int64_t c = 0; c < T6; ++c)
            memset(out6 + c * cap6 + valid6, 0,
                   (size_t)(cap6 - valid6) * sizeof(uint32_t));
        *n_lines_out = lines;
        *n_valid_out = valid;
        *n_valid6_out = valid6;
        return p - buf;
    }

    // ---- pass 1: line-offset index (as asa_pack_chunk_mt)
    std::vector<uint32_t> off;
    off.reserve((size_t)(want > 0 ? want + 1 : 1));
    const char* p = build_line_index(buf, len, final_, want, off);
    const int64_t L = (int64_t)off.size();
    if (L == 0) {
        zero_tail(out, cap, 0);
        for (int64_t c = 0; c < T6; ++c)
            memset(out6 + c * cap6, 0, (size_t)cap6 * sizeof(uint32_t));
        *n_lines_out = 0;
        *n_valid_out = 0;
        *n_valid6_out = 0;
        return 0;
    }
    const int64_t consumed = p - buf;
    off.push_back((uint32_t)consumed);
    auto line_end = [&](int64_t i) {
        const char* q = buf + off[i + 1];
        return (q > buf + off[i] && q[-1] == '\n') ? q - 1 : q;
    };

    int W = n_threads;
    if (W <= 0) W = (int)std::thread::hardware_concurrency();
    if (W < 1) W = 1;
    if (W > (int)(L / 1024) + 1) W = (int)(L / 1024) + 1;

    // ---- workers: private slabs per family + per-line row counts
    std::vector<uint32_t> scratch4((size_t)(TUPLE_COLS * 2 * L));
    std::vector<uint32_t> scratch6((size_t)(T6 * 2 * L));
    std::vector<uint8_t> rows4_per_line((size_t)L);
    std::vector<uint8_t> rows6_per_line((size_t)L);
    std::vector<int64_t> lo(W + 1);
    for (int w = 0; w <= W; ++w) lo[w] = L * w / W;
    std::vector<LocalCtx> ctx((size_t)W);
    std::vector<std::thread> threads;
    threads.reserve((size_t)W);
    for (int w = 0; w < W; ++w) {
        ctx[w].resolve = &pk->resolve;
        threads.emplace_back([&, w]() {
            const int64_t i0 = lo[w], i1 = lo[w + 1];
            const int64_t slab_cap = 2 * (i1 - i0);
            uint32_t* slab4 = scratch4.data() + (size_t)(2 * i0 * TUPLE_COLS);
            uint32_t* slab6 = scratch6.data() + (size_t)(2 * i0 * T6);
            LocalCtx* cx = &ctx[w];
            int64_t v4 = 0, v6 = 0;
            for (int64_t i = i0; i < i1; ++i) {
                int64_t v6_before = v6;
                int n = handle(cx, buf + off[i], line_end(i),
                               slab4, slab_cap, v4,
                               slab6, slab_cap, &v6);
                // n < 0 impossible: slab caps are 2 * range lines
                if (n > 0 && v6 != v6_before) {
                    rows6_per_line[(size_t)i] = (uint8_t)n;
                } else {
                    rows4_per_line[(size_t)i] = (uint8_t)(n > 0 ? n : 0);
                    if (n > 0) v4 += n;
                }
            }
        });
    }
    for (auto& t : threads) t.join();

    // ---- line-atomic cap on the v4 plane only (cap6 >= 2*max_lines by
    // the caller contract, so v6 rows can never close the batch)
    int64_t K = 0, total4 = 0;
    int64_t parsed = 0, skipped = 0;
    for (; K < L; ++K) {
        const int64_t r4 = rows4_per_line[(size_t)K];
        const int64_t r6 = rows6_per_line[(size_t)K];
        if (total4 + r4 > cap) break;
        total4 += r4;
        if (r4 == 0 && r6 == 0) ++skipped;
        else parsed += r4 + r6;
    }

    // ---- compaction: per family, concatenating consumed lines' rows
    int64_t valid = 0, valid6 = 0;
    for (int w = 0; w < W && lo[w] < K; ++w) {
        const int64_t i0 = lo[w], i1 = lo[w + 1] < K ? lo[w + 1] : K;
        const int64_t slab_cap = 2 * (lo[w + 1] - i0);
        const uint32_t* slab4 = scratch4.data() + (size_t)(2 * i0 * TUPLE_COLS);
        const uint32_t* slab6 = scratch6.data() + (size_t)(2 * i0 * T6);
        int64_t take4 = 0, take6 = 0;
        for (int64_t i = i0; i < i1; ++i) {
            take4 += rows4_per_line[(size_t)i];
            take6 += rows6_per_line[(size_t)i];
        }
        for (int64_t c = 0; c < TUPLE_COLS; ++c)
            memcpy(out + c * cap + valid, slab4 + c * slab_cap,
                   (size_t)take4 * sizeof(uint32_t));
        for (int64_t c = 0; c < T6; ++c)
            memcpy(out6 + c * cap6 + valid6, slab6 + c * slab_cap,
                   (size_t)take6 * sizeof(uint32_t));
        valid += take4;
        valid6 += take6;
    }
    pk->parsed += parsed;
    pk->skipped += skipped;
    zero_tail(out, cap, valid);
    for (int64_t c = 0; c < T6; ++c)
        memset(out6 + c * cap6 + valid6, 0,
               (size_t)(cap6 - valid6) * sizeof(uint32_t));
    *n_lines_out = K;
    *n_valid_out = valid;
    *n_valid6_out = valid6;
    return K < L ? (int64_t)off[K] : consumed;
}

// Plain newline count (streaming buffer bookkeeping; the SIMD popcount
// pass beats even libc memchr chaining, and both beat Python-level
// bytes.count by ~5-10x).
int64_t asa_count_nl(const char* buf, int64_t len) {
    simd_init();
    if (const ra_simd::ScanOps* o = scan_ops()) return o->count_nl(buf, len);
    int64_t n = 0;
    const char* p = buf;
    const char* end = buf + len;
    while ((p = (const char*)memchr(p, '\n', end - p)) != nullptr) {
        ++n;
        ++p;
    }
    return n;
}

// Count newline-terminated lines in buf (resume fast-skip helper).
int64_t asa_count_lines(const char* buf, int64_t len, int final_,
                        int64_t max_lines, int64_t* bytes_out) {
    simd_init();
    if (const ra_simd::ScanOps* o = scan_ops()) {
        int64_t bytes = 0;
        int64_t lines = o->nl_skip(buf, len, max_lines, &bytes);
        if (lines < max_lines && bytes < len && final_) {
            // trailing unterminated fragment counts as a line when final
            ++lines;
            bytes = len;
        }
        *bytes_out = bytes;
        return lines;
    }
    const char* p = buf;
    const char* end = buf + len;
    int64_t lines = 0;
    while (p < end && lines < max_lines) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        if (!nl && !final_) break;
        ++lines;
        p = nl ? nl + 1 : end;
    }
    *bytes_out = p - buf;
    return lines;
}

// SIMD dispatch introspection/override: kind is 0 scalar,
// 1 AVX2, 2 NEON; asa_simd_set(0) forces scalar, (1) re-enables the
// detected ISA — the in-process A/B switch of the identity tests
// (RA_SIMD=off is the env-level equivalent).
int asa_simd_kind() {
    simd_init();
    HandleLineFn h = handle_line_fn();
    if (h && h == ra_parse::avx2_handle_line()) return 1;
    if (h && h == ra_parse::neon_handle_line()) return 2;
    return 0;
}

void asa_simd_set(int on) {
    simd_init();
    pick_dispatch(on != 0);
}

// Flow coalescing: compact a column-major [rows, b] uint32
// plane into (unique column, summed weight) pairs in FIRST-OCCURRENCE
// order.  The LAST row is the weight/valid plane — zero-weight columns
// drop, the rest group by the remaining rows' values.  One linear pass
// with an open-addressing (linear-probe) table sized to the next power
// of two >= 2b; `out` must have capacity rows*b (laid out [rows, b] —
// the caller slices [:, :U]); `first_idx` (optional) receives each
// unique column's first source index.  Returns U.  ASA flow logs repeat
// the same 5-tuple across 106100/302013 lines, so U << b on real
// traffic — the MapReduce-combiner move applied to the device batch.
int64_t asa_coalesce(const uint32_t* in, int64_t rows, int64_t b,
                     uint32_t* out, int64_t* first_idx) {
    if (rows < 2 || b <= 0) return 0;
    const int64_t krows = rows - 1;
    const uint32_t* wrow = in + krows * b;
    int64_t nslots = 1;
    while (nslots < 2 * b) nslots <<= 1;
    std::vector<int64_t> table((size_t)nslots, -1);
    int64_t u = 0;
    for (int64_t j = 0; j < b; ++j) {
        uint32_t w = wrow[j];
        if (!w) continue;
        uint64_t h = 1469598103934665603ull;  // FNV-1a over the key rows
        for (int64_t r = 0; r < krows; ++r) {
            h ^= in[r * b + j];
            h *= 1099511628211ull;
        }
        h ^= h >> 32;  // fold: the table mask only sees the low bits
        int64_t s = (int64_t)(h & (uint64_t)(nslots - 1));
        for (;;) {
            int64_t p = table[(size_t)s];
            if (p < 0) {
                table[(size_t)s] = u;
                for (int64_t r = 0; r < krows; ++r) out[r * b + u] = in[r * b + j];
                out[krows * b + u] = w;
                if (first_idx) first_idx[u] = j;
                ++u;
                break;
            }
            bool eq = true;
            for (int64_t r = 0; r < krows; ++r) {
                if (out[r * b + p] != in[r * b + j]) { eq = false; break; }
            }
            if (eq) {
                out[krows * b + p] += w;
                break;
            }
            s = (s + 1) & (nslots - 1);
        }
    }
    return u;
}

}  // extern "C"
