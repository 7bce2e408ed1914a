// first_match: the first-match scan as a hand-written Hopper kernel.
//
// Replaces the Pallas kernel of ruleset_analysis_tpu/ops/pallas_match.py
// (first_match_rows_pallas -> _kernel -> tile_first_match): per line, the
// lowest global rule row whose acl equals the line's and whose five
// ranges hold, else 0xFFFFFFFF (NO_MATCH).
//
// What bounds it on the H100: integer operations, not bytes.  A line
// reads 24 B and writes 4 B, but tests up to Rp rules at about 12 integer
// operations each (one acl compare, five subtract+compare range tests,
// one select); at Rp = 7680 that is ~90k operations per 28 bytes, far
// above the card's ~5 INT32 operations per byte of memory bandwidth.
//
// What the design does about it: the rule tiles sit in shared memory and
// are read as warp-wide broadcasts, so the inner loop is loads from
// shared memory and integer ALU work only; each range's hi - lo is
// computed once per tile, not once per line; a line stops testing at its
// first hit, and a block stops loading tiles when all its lines have one,
// so most lines test only the rules up to their own ACL's matching row.
// The running minimum is the first hit itself (tiles are visited in row
// order), kept in a register as a plain unsigned int.
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError().
#include "scan.cuh"

namespace {

__global__ void __launch_bounds__(ra::BLOCK_LINES)
first_match_kernel(const unsigned* __restrict__ acl, const unsigned* __restrict__ proto,
                   const unsigned* __restrict__ src, const unsigned* __restrict__ sport,
                   const unsigned* __restrict__ dst, const unsigned* __restrict__ dport,
                   const unsigned* __restrict__ rules_fm, int rp, unsigned* __restrict__ out,
                   int b) {
  __shared__ ra::RuleTile tile;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < b;  // lines past B are masked here, not padded on the host
  ra::Line line{};
  if (active) line = ra::load_line(acl, proto, src, sport, dst, dport, i);
  const unsigned best = ra::scan_first_match(tile, rules_fm, rp, line, active);
  if (active) out[i] = best;
}

}  // namespace

extern "C" int ra_first_match(const void* acl, const void* proto, const void* src,
                              const void* sport, const void* dst, const void* dport,
                              const void* rules_fm, int rp, void* out, int b, void* stream) {
  if (b > 0) {
    const int grid = (b + ra::BLOCK_LINES - 1) / ra::BLOCK_LINES;
    first_match_kernel<<<grid, ra::BLOCK_LINES, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(acl), static_cast<const unsigned*>(proto),
        static_cast<const unsigned*>(src), static_cast<const unsigned*>(sport),
        static_cast<const unsigned*>(dst), static_cast<const unsigned*>(dport),
        static_cast<const unsigned*>(rules_fm), rp, static_cast<unsigned*>(out), b);
  }
  return static_cast<int>(cudaGetLastError());
}
