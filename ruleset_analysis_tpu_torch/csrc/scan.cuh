// The first-match scan shared by both kernels (first_match.cu, match_hist.cu).
//
// One thread per log line.  The block walks the field-major rule tensor
// [RULE_COLS, Rp] (ops/first_match.py prep_rules) in tiles of RULE_TILE
// rules, staging each tile in shared memory; every thread tests its line
// against the tile's rules in order and keeps its first hit in a register.
// First match == lowest global row, because rows are in config order and
// tiles are visited in row order, so a thread that has a hit stops
// testing, and the block stops loading tiles once every thread has one.
#pragma once

#include <cuda_runtime.h>

namespace ra {

constexpr int RULE_COLS = 12;  // hostside/pack.py RULE_COLS
constexpr int RULE_TILE = 128;  // rules per shared-memory tile
constexpr int BLOCK_LINES = 256;  // threads (= lines) per block
constexpr unsigned NO_MATCH = 0xFFFFFFFFu;
// rule columns (hostside/pack.py): acl, then (lo, hi) pairs for proto,
// src, sport, dst, dport at columns 1 + 2f and 2 + 2f, then the key
constexpr int R_ACL = 0;
constexpr int N_RANGES = 5;

struct Line {
  unsigned acl;
  unsigned x[N_RANGES];  // proto, src, sport, dst, dport
};

// One tile in shared memory: the acl of each rule, and each range as
// (lo, hi - lo) so the test is one subtract and one compare.
struct RuleTile {
  unsigned acl[RULE_TILE];
  unsigned lo[N_RANGES][RULE_TILE];
  unsigned span[N_RANGES][RULE_TILE];
};

__device__ __forceinline__ void load_tile(RuleTile& t, const unsigned* __restrict__ rules_fm,
                                          int rp, int base) {
  for (int j = threadIdx.x; j < RULE_TILE; j += blockDim.x) {
    const int c = base + j;
    t.acl[j] = rules_fm[R_ACL * rp + c];
#pragma unroll
    for (int f = 0; f < N_RANGES; ++f) {
      const unsigned lo = rules_fm[(1 + 2 * f) * rp + c];
      const unsigned hi = rules_fm[(2 + 2 * f) * rp + c];
      t.lo[f][j] = lo;
      t.span[f][j] = hi - lo;
    }
  }
}

// First matching global row of this thread's line, NO_MATCH if none.
// Every thread of the block must call it: it synchronises the block.
// `active` is false for threads past the end of the batch.
//
// The range test is the unsigned wraparound check (x - lo) <= (hi - lo),
// which holds iff lo <= x <= hi given lo <= hi (pack.validate_rule_ranges
// guarantees that at load).  Padding rules carry acl = NO_MATCH and
// never match.
__device__ __forceinline__ unsigned scan_first_match(RuleTile& t,
                                                     const unsigned* __restrict__ rules_fm,
                                                     int rp, const Line& line, bool active) {
  unsigned best = NO_MATCH;
  bool done = !active;
  for (int base = 0; base < rp; base += RULE_TILE) {
    // the barrier also keeps the previous tile alive until all have read it
    if (__syncthreads_and(done)) break;
    load_tile(t, rules_fm, rp, base);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < RULE_TILE; ++j) {
        if (t.acl[j] != line.acl) continue;
        bool ok = true;
#pragma unroll
        for (int f = 0; f < N_RANGES; ++f) ok &= (line.x[f] - t.lo[f][j]) <= t.span[f][j];
        if (ok) {
          best = static_cast<unsigned>(base + j);
          done = true;
          break;
        }
      }
    }
  }
  return best;
}

__device__ __forceinline__ Line load_line(const unsigned* __restrict__ acl,
                                          const unsigned* __restrict__ proto,
                                          const unsigned* __restrict__ src,
                                          const unsigned* __restrict__ sport,
                                          const unsigned* __restrict__ dst,
                                          const unsigned* __restrict__ dport, int i) {
  Line l;
  l.acl = acl[i];
  l.x[0] = proto[i];
  l.x[1] = src[i];
  l.x[2] = sport[i];
  l.x[3] = dst[i];
  l.x[4] = dport[i];
  return l;
}

}  // namespace ra

// Message of a CUDA error code (each kernel library exports one).
extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
