// relation_grid: the static analyzer's pair relations, by hand for Hopper.
// Every pair tile of an analysis in one launch, as bit-packed words.
//
// Replaces ruleset_analysis_tpu/ops/overlap.py relation_tile (XLA there:
// broadcast u32 compares over one [Ti, Tj] tile a call, under
// pair_relations' loop over the tile grid).  For rule rows a of a tile's
// i-block and b of its j-block (the pack layout: col 0 acl, cols 1-10 the
// lo/hi bounds of proto, src, sport, dst, dport, col 11 the key):
//
//   same          acl_a == acl_b and neither is NO_ACL (0xFFFFFFFF)
//   covered[a,b]  same and, on each field, lo_b <= lo_a and hi_a <= hi_b
//   overlap[a,b]  same and, on each field, max(lo_a, lo_b) <= min(hi_a, hi_b)
//
// every compare unsigned.
//
// Inputs: `blocks`, every padded row block of the analysis, [n_blocks *
// tile, 12] u32 (48-byte rows, the base 16-byte aligned), and the work
// list, int32 [n_tiles, 2]: the i-block and the j-block of each tile.
// Outputs: `covered` and `overlap`, u32 [n_tiles, words, tile] each, words
// = ceil(tile / 32).  Word (t, w, a) holds in bit k the relation of row a
// of tile t's i-block to row 32 w + k of its j-block; bits past the
// tile's edge are 0.  Words of one w are contiguous across a.
//
// What bounds it on the H100: 24 integer operations a pair (16.7 TOP/s
// INT32; below) against 48 bytes a row read and one bit a pair a matrix
// written: operations.  A 512 x 512 tile is ~0.4 us of that, too little
// for a launch of its own (the first design: one launch, 512 KiB of byte
// matrices and a host round trip a tile).
//
// What the design does: one launch takes the whole work list.  A block
// takes ROWS i-rows of one tile, one a thread, each held in registers,
// against 32 * WORDS j-rows staged once in shared memory (ROWS = 128,
// WORDS = 2: 32 blocks a 512-row tile, the fastest of 64 or 128 rows by 2
// or 4 words on the H100, PERF.md section 6).  Every thread of a warp reads
// the same j-row, so the shared loads are broadcasts (three 16-byte loads
// a row).  The overlap test is split so that a pair costs two compares a
// field for each matrix (the rows' own lo <= hi checks are done once a
// row): an acl compare, ten compares a matrix and the staged row's flag,
// each test one chain of ISETPs with the ands folded into their predicate
// operands, and one predicated OR a bit.  A thread stores one word of each
// matrix per 32 j-rows, consecutive threads on consecutive words (one
// 128-byte store a warp).  A padding i-row writes zero words without a
// compare, and 32 padding j-rows of one word take none either; j-rows past
// the tile stage as NO_ACL.
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int ROWS = 128;    // i-rows a block, one a thread
constexpr int WORDS = 2;     // words of each matrix a thread writes: 32 * WORDS j-rows
constexpr int ROW_VECS = 3;  // a 12-word row as three uint4
constexpr unsigned NO_ACL = 0xFFFFFFFFu;
static_assert(ROWS % 32 == 0 && WORDS * 32 <= ROWS, "one staged row a thread of whole warps");

__global__ void __launch_bounds__(ROWS)
relation_grid_kernel(const uint4* __restrict__ blocks, const int* __restrict__ work,
                     int tile, int words, int spans, int per_tile,
                     unsigned* __restrict__ covered, unsigned* __restrict__ overlap) {
  __shared__ uint4 sj[WORDS * 32 * ROW_VECS];
  __shared__ int live[WORDS];  // a staged word's 32 rows hold a real one
  const int t = blockIdx.x / per_tile;
  const int rest = blockIdx.x - t * per_tile;
  const int strip = rest / spans;
  const int span = rest - strip * spans;
  const size_t bi = static_cast<size_t>(__ldg(work + 2 * t));
  const size_t bj = static_cast<size_t>(__ldg(work + 2 * t + 1));
  const int j0 = span * WORDS * 32;

  const uint4* rj = blocks + (bj * tile + j0) * ROW_VECS;
  for (int x = threadIdx.x; x < WORDS * 32 * ROW_VECS; x += ROWS) {
    const int r = x / ROW_VECS;
    sj[x] = j0 + r < tile ? rj[x]
                          : (x - r * ROW_VECS == 0 ? make_uint4(NO_ACL, 0, 0, 0)
                                                   : make_uint4(0, 0, 0, 0));
  }
  __syncthreads();
  // each staged row's key word (never read) becomes its "lo <= hi on every
  // field" flag, the j-side half of the overlap test below; warp u of the
  // first WORDS notes whether word u's rows are all padding
  if (threadIdx.x < WORDS * 32) {
    uint4* b = sj + threadIdx.x * ROW_VECS;
    const uint4 b0 = b[0], b1 = b[1], b2 = b[2];
    b[2].w = (b0.y <= b0.z) & (b0.w <= b1.x) & (b1.y <= b1.z) & (b1.w <= b2.x) &
             (b2.y <= b2.z);
    const int any = __any_sync(0xFFFFFFFFu, b0.x != NO_ACL);
    if ((threadIdx.x & 31) == 0) live[threadIdx.x / 32] = any;
  }
  __syncthreads();

  const int a = strip * ROWS + static_cast<int>(threadIdx.x);
  if (a >= tile) return;
  const int w0 = span * WORDS;
  const int nw = min(WORDS, words - w0);
  const size_t o = (static_cast<size_t>(t) * words + w0) * tile + a;
  unsigned* cov_out = covered + o;
  unsigned* ovl_out = overlap + o;

  const uint4* ri = blocks + (bi * tile + a) * ROW_VECS;
  const uint4 v0 = ri[0], v1 = ri[1], v2 = ri[2];
  const unsigned acl = v0.x;
  if (acl == NO_ACL) {
    for (int u = 0; u < nw; ++u) {
      cov_out[static_cast<size_t>(u) * tile] = 0;
      ovl_out[static_cast<size_t>(u) * tile] = 0;
    }
    return;
  }
  const unsigned lo[5] = {v0.y, v0.w, v1.y, v1.w, v2.y};
  const unsigned hi[5] = {v0.z, v1.x, v1.z, v2.x, v2.z};
  // max(lo_a, lo_b) <= min(hi_a, hi_b) is lo_a <= hi_a, lo_b <= hi_b,
  // lo_a <= hi_b and lo_b <= hi_a: the first is this row's, the second the
  // staged row's flag, so a pair tests two compares a field for each matrix
  const bool a_ok = (lo[0] <= hi[0]) & (lo[1] <= hi[1]) & (lo[2] <= hi[2]) &
                    (lo[3] <= hi[3]) & (lo[4] <= hi[4]);

#pragma unroll
  for (int u = 0; u < WORDS; ++u) {
    if (u >= nw) break;
    unsigned cw = 0, ow = 0;
    // 32 padding j-rows (past a slab's last row) relate to nothing
    if (live[u]) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint4* b = sj + (u * 32 + k) * ROW_VECS;
        const uint4 b0 = b[0], b1 = b[1], b2 = b[2];
        // acl != NO_ACL here, so a NO_ACL j-row never equals it.  Written as
        // && chains: with bools and & the compiler materialises each compare
        // in a register (twice the instructions, measured on the H100)
        const bool same = b0.x == acl;
        if (same && b0.y <= lo[0] && hi[0] <= b0.z && b0.w <= lo[1] && hi[1] <= b1.x &&
            b1.y <= lo[2] && hi[2] <= b1.z && b1.w <= lo[3] && hi[3] <= b2.x &&
            b2.y <= lo[4] && hi[4] <= b2.z)
          cw |= 1u << k;
        if (same && a_ok && b2.w != 0 && lo[0] <= b0.z && b0.y <= hi[0] && lo[1] <= b1.x &&
            b0.w <= hi[1] && lo[2] <= b1.z && b1.y <= hi[2] && lo[3] <= b2.x &&
            b1.w <= hi[3] && lo[4] <= b2.z && b2.y <= hi[4])
          ow |= 1u << k;
      }
    }
    cov_out[static_cast<size_t>(u) * tile] = cw;
    ovl_out[static_cast<size_t>(u) * tile] = ow;
  }
}

}  // namespace

// blocks: [n_blocks * tile, 12] u32, 16-byte aligned; work: [n_tiles, 2]
// int32 on the device, each entry < n_blocks; covered, overlap: [n_tiles,
// ceil(tile / 32), tile] u32.
extern "C" int ra_relation_grid(const void* blocks, const void* work, int n_tiles, int tile,
                                void* covered, void* overlap, void* stream) {
  if (n_tiles <= 0 || tile <= 0) return static_cast<int>(cudaGetLastError());
  const int words = (tile + 31) / 32;
  const int spans = (words + WORDS - 1) / WORDS;
  const int per_tile = ((tile + ROWS - 1) / ROWS) * spans;
  const long long grid = static_cast<long long>(n_tiles) * per_tile;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  relation_grid_kernel<<<static_cast<unsigned>(grid), ROWS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(blocks), static_cast<const int*>(work), tile, words, spans,
      per_tile, static_cast<unsigned*>(covered), static_cast<unsigned*>(overlap));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
