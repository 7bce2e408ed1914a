// first_match: the first-match scan as a hand-written Hopper kernel.
//
// Replaces the Pallas kernel of ruleset_analysis_tpu/ops/pallas_match.py
// (first_match_rows_pallas -> _kernel -> tile_first_match): per line, the
// lowest global rule row whose acl equals the line's and whose five
// ranges hold, else 0xFFFFFFFF (NO_MATCH).
//
// What bounds it on the H100: integer operations, not bytes.  A line
// reads 24 B and writes 4 B, but each rule test it needs costs about 12
// integer operations (one acl compare, five subtract+compare range
// tests, one select), and a line needs every row of its own ACL up to
// its first hit: ~32 tests a line at Rp = 7680, far above the card's ~5
// INT32 operations per byte of memory bandwidth.
//
// What the design does about it: the TPU kernel tests every line against
// every rule tile, and a thread-per-line port of it walks every earlier
// ACL's rows too.  Here each line tests only its own ACL's row span (a
// table built once per ruleset), and a warp tests 32 rows of one line at
// once and stops at the first ballot with a hit (csrc/scan.cuh), so a
// line costs ceil(tests / 32) warp steps and no lane waits for another
// line's walk.  A rule row is three 16-byte loads with hi - lo computed
// at ship time, so a step is few instructions; rules are read from L1/L2
// through the read-only path, and nothing is staged or synchronised
// across the block, so the block scheduler balances the uneven walks.
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError().
#include "scan.cuh"

namespace {

constexpr int BLOCK_THREADS = 256;  // 8 warps, one line per thread

__global__ void __launch_bounds__(BLOCK_THREADS)
first_match_kernel(const unsigned* __restrict__ acl, const unsigned* __restrict__ proto,
                   const unsigned* __restrict__ src, const unsigned* __restrict__ sport,
                   const unsigned* __restrict__ dst, const unsigned* __restrict__ dport,
                   const uint4* __restrict__ rules, int rp, const int2* __restrict__ acl_span,
                   int n_span, unsigned* __restrict__ out, int b) {
  const unsigned i = blockIdx.x * BLOCK_THREADS + threadIdx.x;
  const bool active = i < static_cast<unsigned>(b);  // lines past B are masked, not padded
  ra::Line line{};
  int2 span = make_int2(0, 0);
  if (active) {
    line = ra::load_line(acl, proto, src, sport, dst, dport, i);
    span = ra::line_span(acl_span, n_span, rp, line.acl);
  }
  const unsigned best = ra::warp_first_match(rules, line, span);
  if (active) out[i] = best;
}

}  // namespace

// rules: the [rp, RULE_COLS] kernel rule tensor, 16-byte aligned.
extern "C" int ra_first_match(const void* acl, const void* proto, const void* src,
                              const void* sport, const void* dst, const void* dport,
                              const void* rules, int rp, const void* acl_span, int n_span,
                              void* out, int b, void* stream) {
  if (b > 0) {
    const int grid = static_cast<int>((static_cast<long long>(b) + BLOCK_THREADS - 1) /
                                      BLOCK_THREADS);
    first_match_kernel<<<grid, BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(acl), static_cast<const unsigned*>(proto),
        static_cast<const unsigned*>(src), static_cast<const unsigned*>(sport),
        static_cast<const unsigned*>(dst), static_cast<const unsigned*>(dport),
        static_cast<const uint4*>(rules), rp, static_cast<const int2*>(acl_span), n_span,
        static_cast<unsigned*>(out), b);
  }
  return static_cast<int>(cudaGetLastError());
}
