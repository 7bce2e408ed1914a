// relation_tile: the static analyzer's pair-relation tile, by hand for Hopper.
//
// Replaces ruleset_analysis_tpu/ops/overlap.py relation_tile (XLA there:
// broadcast u32 compares over a [Ti, Tj] tile).  For rule rows a of the
// i-block and b of the j-block (the pack layout: col 0 acl, cols 1-10 the
// lo/hi bounds of proto, src, sport, dst, dport, col 11 the key):
//
//   same          acl_a == acl_b and neither is NO_ACL (0xFFFFFFFF)
//   covered[a,b]  same and, on each field, lo_b <= lo_a and hi_a <= hi_b
//   overlap[a,b]  same and, on each field, max(lo_a, lo_b) <= min(hi_a, hi_b)
//
// every compare unsigned; outputs one byte (0 or 1) a pair, row-major.
//
// What bounds it on the H100: at the analyzer's 512 x 512 tile it reads
// 2 x 24 KiB of rows and writes 512 KiB, about 0.16 us of memory time,
// and does about 43 integer operations a pair (0.7 us at the card's INT32
// rate), so its bound is operations; a tile this small is launch-bound
// in practice.
//
// What the design does: one thread per pair in a 64 x 4 block.  The
// block's 64 j-rows are staged once in shared memory, column-major so a
// warp reads 32 consecutive words; each thread's i-row is one warp-wide
// broadcast load kept in registers; both output bytes are written
// coalesced along b.  Ragged Ti and Tj are masked, so a tile needs no
// padding (the analyzer pads anyway, as the reference does).
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int RULE_COLS = 12;
constexpr int USED_COLS = 11;  // acl and the ten bounds; the key is not read
constexpr int TILE_J = 64;     // j-rows a block (threadIdx.x)
constexpr int TILE_I = 4;      // i-rows a block (threadIdx.y)
constexpr unsigned NO_ACL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(TILE_J * TILE_I)
relation_tile_kernel(const unsigned* __restrict__ rows_i, int ti,
                     const unsigned* __restrict__ rows_j, int tj,
                     unsigned char* __restrict__ covered, unsigned char* __restrict__ overlap) {
  // +1: the staging stores (row = t / 11) spread over more banks
  __shared__ unsigned sj[USED_COLS][TILE_J + 1];
  const int a = blockIdx.x * TILE_I + threadIdx.y;
  const int j0 = blockIdx.y * TILE_J;
  const int tid = threadIdx.y * TILE_J + threadIdx.x;
  for (int t = tid; t < TILE_J * USED_COLS; t += TILE_J * TILE_I) {
    const int r = t / USED_COLS;
    const int c = t - r * USED_COLS;
    const int b = j0 + r;
    sj[c][r] = b < tj ? rows_j[static_cast<size_t>(b) * RULE_COLS + c] : NO_ACL;
  }
  __syncthreads();
  const int x = threadIdx.x;
  const int b = j0 + x;
  if (a >= ti || b >= tj) return;
  const unsigned* ri = rows_i + static_cast<size_t>(a) * RULE_COLS;
  const unsigned acl_a = __ldg(ri);
  const bool same = acl_a == sj[0][x] && acl_a != NO_ACL;
  bool cov = same;
  bool ovl = same;
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    const unsigned la = __ldg(ri + 1 + 2 * f);
    const unsigned ha = __ldg(ri + 2 + 2 * f);
    const unsigned lb = sj[1 + 2 * f][x];
    const unsigned hb = sj[2 + 2 * f][x];
    cov = cov && lb <= la && ha <= hb;
    ovl = ovl && max(la, lb) <= min(ha, hb);
  }
  const size_t o = static_cast<size_t>(a) * tj + b;
  covered[o] = cov ? 1 : 0;
  overlap[o] = ovl ? 1 : 0;
}

}  // namespace

// rows_i: [ti, RULE_COLS], rows_j: [tj, RULE_COLS] u32; covered, overlap:
// [ti, tj] bytes.  The grid takes ti < 2^31 and tj <= 65535 * TILE_J.
extern "C" int ra_relation_tile(const void* rows_i, int ti, const void* rows_j, int tj,
                                void* covered, void* overlap, void* stream) {
  if (ti > 0 && tj > 0) {
    const dim3 grid(static_cast<unsigned>((static_cast<long long>(ti) + TILE_I - 1) / TILE_I),
                    static_cast<unsigned>((tj + TILE_J - 1) / TILE_J));
    const dim3 block(TILE_J, TILE_I);
    relation_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(rows_i), ti, static_cast<const unsigned*>(rows_j), tj,
        static_cast<unsigned char*>(covered), static_cast<unsigned char*>(overlap));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
