// The first-match scan shared by the v4 kernels (first_match.cu,
// match_hist.cu); first_match6.cu has its own loop and uses line_span.
//
// A warp takes 32 consecutive lines, one per lane, and then works through
// them one line at a time: the line's fields and its ACL's row span
// (ops/first_match.py acl_spans) are broadcast to the warp with shuffles,
// and the warp walks the span 32 rows per step, lane j testing row
// base + j of the kernels' rule tensor (ops/first_match.py prep_rules:
// [Rp, RULE_COLS] rows of 48 B, read as three 16-byte loads, so a step
// reads 32 consecutive rows, 1.5 KB, coalesced, through the read-only
// path; the whole tensor stays in L2).  A ballot of the lanes' hits ends
// the walk at its first nonzero step: the lowest set bit is the line's
// first match, because rows are tested in row order.  The row goes back
// to the line's own lane, so the warp stores its 32 results at once.
//
// A line costs ceil(tests / 32) warp steps, where tests is the number of
// rows of its own span up to its first hit (the whole span when none
// matches); lines in other ACLs' spans and other lines' walks cost it
// nothing.
#pragma once

#include <cuda_runtime.h>

namespace ra {

constexpr int RULE_COLS = 12;  // hostside/pack.py RULE_COLS: 48 B a row
constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr unsigned NO_MATCH = 0xFFFFFFFFu;  // also the padding rows' acl (pack.py NO_ACL)
// rule columns (hostside/pack.py): acl, then (lo, hi) pairs for proto,
// src, sport, dst, dport at columns 1 + 2f and 2 + 2f, then the key; in
// the kernels' tensor each hi is replaced by hi - lo
constexpr int N_RANGES = 5;

struct Line {
  unsigned acl;
  unsigned x[N_RANGES];  // proto, src, sport, dst, dport

  // lane k's line, broadcast to the whole warp
  __device__ __forceinline__ Line shfl(int k) const {
    Line l;
    l.acl = __shfl_sync(FULL_MASK, acl, k);
#pragma unroll
    for (int f = 0; f < N_RANGES; ++f) l.x[f] = __shfl_sync(FULL_MASK, x[f], k);
    return l;
  }
};

__device__ __forceinline__ Line load_line(const unsigned* __restrict__ acl,
                                          const unsigned* __restrict__ proto,
                                          const unsigned* __restrict__ src,
                                          const unsigned* __restrict__ sport,
                                          const unsigned* __restrict__ dst,
                                          const unsigned* __restrict__ dport, unsigned i) {
  Line l;
  l.acl = acl[i];
  l.x[0] = proto[i];
  l.x[1] = src[i];
  l.x[2] = sport[i];
  l.x[3] = dst[i];
  l.x[4] = dport[i];
  return l;
}

// The rows [first, end) that a line of ACL `acl` has to test.  The span
// table has n_span = A + 1 entries: one per acl id below A, then one for
// acl NO_MATCH (the padding rows).  Any other acl id has no rows, so the
// empty span.  The span is clamped to [0, rp), so a wrong table can give
// a wrong row but never a read outside the rules.
__device__ __forceinline__ int2 line_span(const int2* __restrict__ span, int n_span, int rp,
                                          unsigned acl) {
  const unsigned a = static_cast<unsigned>(n_span - 1);
  int2 s = make_int2(0, 0);
  if (acl < a) s = __ldg(&span[acl]);
  else if (acl == NO_MATCH) s = __ldg(&span[a]);
  s.x = max(s.x, 0);
  s.y = min(s.y, rp);
  return s;
}

// True when rule row r holds for the line (acl, x): the acl is equal and
// each range holds.  The range test is the unsigned wraparound check
// (x - lo) <= (hi - lo), one subtract and one compare, with hi - lo
// computed once at ship time; it holds iff lo <= x <= hi given lo <= hi
// (pack.validate_rule_ranges guarantees that at load), and it is the
// reference's own test for any lo and hi.
__device__ __forceinline__ bool row_holds(const uint4* __restrict__ rules, int r, unsigned acl,
                                          const unsigned (&x)[N_RANGES]) {
  const uint4 a = __ldg(rules + 3 * r);      // acl, lo0, d0, lo1
  const uint4 b = __ldg(rules + 3 * r + 1);  // d1, lo2, d2, lo3
  const uint4 c = __ldg(rules + 3 * r + 2);  // d3, lo4, d4, key
  return (a.x == acl) & ((x[0] - a.y) <= a.z) & ((x[1] - a.w) <= b.x) &
         ((x[2] - b.y) <= b.z) & ((x[3] - b.w) <= c.x) & ((x[4] - c.y) <= c.z);
}

// First matching global row of the lane's line, NO_MATCH if none, for
// any line type: L has `L shfl(int k) const` (lane k's line for the
// whole warp) and holds(r, l) tests rule row r against line l.  All 32
// lanes of the warp must call it (it shuffles and ballots over the full
// warp); a lane without a line passes the empty span.
template <class L, class Holds>
__device__ __forceinline__ unsigned warp_first_match_by(const L& line, int2 span, Holds holds) {
  const int lane = threadIdx.x & (WARP - 1);
  unsigned best = NO_MATCH;
  unsigned todo = __ballot_sync(FULL_MASK, span.x < span.y);
  while (todo) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    const L l = line.shfl(k);
    const int first = __shfl_sync(FULL_MASK, span.x, k);
    const int end = __shfl_sync(FULL_MASK, span.y, k);
    unsigned hit = NO_MATCH;
    for (int base = first; base < end; base += WARP) {  // warp-uniform bounds
      const int r = base + lane;
      const unsigned hits = __ballot_sync(FULL_MASK, r < end && holds(r, l));
      if (hits) {
        hit = static_cast<unsigned>(base + __ffs(hits) - 1);
        break;
      }
    }
    if (lane == k) best = hit;
  }
  return best;
}

// The v4 scan.  The acl is still compared inside the span, so rows of one
// ACL need not be contiguous.  Padding rows carry acl NO_MATCH and
// all-zero ranges: they match a line whose acl is NO_MATCH and whose five
// fields are 0, as in the reference.
__device__ __forceinline__ unsigned warp_first_match(const uint4* __restrict__ rules,
                                                     const Line& line, int2 span) {
  return warp_first_match_by(line, span, [rules](int r, const Line& l) {
    return row_holds(rules, r, l.acl, l.x);
  });
}

}  // namespace ra

// Message of a CUDA error code (each kernel library exports one).
extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
