// first_match6: the IPv6 first-match scan as a hand-written Hopper kernel.
//
// Replaces ruleset_analysis_tpu/ops/match6.py first_match_rows6 (an XLA
// block scan on the TPU, no Pallas): per v6 line, the lowest v6 rule row
// of the line's own ACL span whose acl equals the line's, whose
// proto/sport/dport ranges hold (the v4 wraparound test) and whose src and
// dst lie within the row's 128-bit [lo, hi] bounds (big-endian u32 limbs,
// compared lexicographically); else 0xFFFFFFFF (NO_MATCH).
//
// Why a kernel where the reference had none: XLA fuses the compare chain
// into one pass over [B, 512] tiles, but torch eager materialises every
// intermediate, so the plain scan costs hundreds of ms per 2^20 lines.
//
// What bounds it on the H100: bytes.  A line reads 48 B and writes 4 B
// (52 B a line, ~0.016 ms per 2^20 lines at 3.35 TB/s); the rule tests it
// needs (its own ACL's rows up to the first hit, ~8 on the dual-stack
// edge ruleset) take 24 integer operations each, less than the bytes'
// time.  The work is integer range tests with no product, so the tensor
// cores do not apply.
//
// What the design does about it:
// - Lane groups.  A line is tested by a group of G = 8 lanes, so one
//   warp step tests 8 rows for each of 4 lines.  Each group ballots on
//   its own bits of the warp's ballot and stops at its own first hit;
//   rows are tested in row order, so the lowest set bit of the first
//   nonzero group ballot is the line's first match.  A group that
//   finishes claims the warp's next line at once (a prefix count over the
//   ballot of the idle groups), so a line that walks a long span holds up
//   only its own group.
// - Two-stage row test.  The scalar half of a row (acl, proto, sport,
//   dport with hi - lo, 32 B) is read and tested first; the four 128-bit
//   bounds (64 B) are loaded only where it holds.
// - Rules through L1.  The grid is persistent, one 1024-thread block an
//   SM, whose shared memory holds the line tiles (96 KB); the rest of the
//   SM's 256 KB stays L1, which holds the rule rows the block reads (147
//   KB at R6p = 1536).
// - Asynchronous line tiles.  Each warp walks its own tiles of 32 lines
//   (tile gw, gw + warps, ...); cp.async brings a tile's twelve field
//   arrays into a two-stage ring in shared memory, line-major (a line's
//   twelve words contiguous, 48 B), so the next tile's loads overlap the
//   scan of this one.  A group reads its line from the tile as three
//   16-byte broadcasts and keeps it in registers, one copy per lane, with
//   no shuffles.
// Measured on the H100 and left out (PERF.md): groups of 16 and 32
// lanes, the one-stage test, and staging the scalar half in shared
// memory were each slower on the dual-stack ruleset.

// Row layout (ops/first_match6.py prep_rules6): 24 u32 (96 B) a row, six
// 16-byte quads, each one operand: (acl, proto lo, proto hi - lo, sport
// lo), (sport hi - lo, dport lo, dport hi - lo, key), then src lo, src hi,
// dst lo, dst hi as four limbs each.  The address bounds stay lo and hi
// (not hi - lo) so the test is the reference's own lexicographic one.
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError() or the first CUDA error it met.
#include "scan.cuh"

namespace {

using u64 = unsigned long long;

constexpr int BLOCK_THREADS = 1024;  // one block an SM, its line tiles in shared memory
constexpr int WARPS = BLOCK_THREADS / ra::WARP;
constexpr int N_FIELDS = 12;  // acl, proto, sport, dport, src0..3, dst0..3
constexpr int TILE = 32;      // lines a warp tile
constexpr int STAGES = 2;
constexpr int TILE_WORDS = N_FIELDS * TILE;  // field f of line j at [j * N_FIELDS + f]
constexpr int LINE_SMEM = WARPS * STAGES * TILE_WORDS * 4;  // 96 KB of line tiles a block
constexpr int ROW6_QUADS = 6;  // 16-byte quads a kernel row
constexpr int G = 8;           // lanes that test one line
constexpr unsigned LEADERS = 0x01010101u;  // lane 0 of each group
constexpr unsigned GROUP_MASK = (1u << G) - 1;

struct Fields6 {
  const unsigned* f[N_FIELDS];
};

struct Line6 {
  unsigned acl, proto, sport, dport;
  u64 src_h, src_l, dst_h, dst_l;  // 128-bit addresses as big-endian 64-bit halves
};

__device__ __forceinline__ void cp_async4(unsigned* dst, const unsigned* src, bool copy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(copy ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the twelve fields of lines [i0, i0 + TILE) into `tile`,
// lane j taking line j (zeros past line b), as one cp.async group.  All
// lanes of the warp call it.
__device__ __forceinline__ void load_tile(unsigned* tile, const Fields6& in, unsigned i0, int b,
                                          int lane) {
  const unsigned i = i0 + lane;
  const bool copy = i < static_cast<unsigned>(b);
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) {
    cp_async4(tile + lane * N_FIELDS + f, copy ? in.f[f] + i : in.f[f], copy);
  }
  cp_async_commit();
}

__device__ __forceinline__ u64 hi64(const uint4& q) {
  return (static_cast<u64>(q.x) << 32) | q.y;
}

__device__ __forceinline__ u64 lo64(const uint4& q) {
  return (static_cast<u64>(q.z) << 32) | q.w;
}

// x >= lo and x <= hi over 128 bits, lexicographically (ops/match6.py
// _ge128, _le128); each side is (high 64 bits, low 64 bits).
__device__ __forceinline__ bool within128(u64 xh, u64 xl, const uint4& lo, const uint4& hi) {
  const u64 lh = hi64(lo), ll = lo64(lo), hh = hi64(hi), hl = lo64(hi);
  const bool ge = (xh > lh) | ((xh == lh) & (xl >= ll));
  const bool le = (xh < hh) | ((xh == hh) & (xl <= hl));
  return ge & le;
}

// True when rule row r holds for line l: the scalar half first, the
// address bounds only where it holds.
__device__ __forceinline__ bool row6_holds(const uint4* __restrict__ rules, int r,
                                           const Line6& l) {
  const uint4* row = rules + ROW6_QUADS * r;
  const uint4 a = __ldg(row);      // acl, proto lo, proto d, sport lo
  const uint4 c = __ldg(row + 1);  // sport d, dport lo, dport d, key
  const bool scalar = (a.x == l.acl) & ((l.proto - a.y) <= a.z) & ((l.sport - a.w) <= c.x) &
                      ((l.dport - c.y) <= c.z);
  if (!scalar) return false;
  return within128(l.src_h, l.src_l, __ldg(row + 2), __ldg(row + 3)) &
         within128(l.dst_h, l.dst_l, __ldg(row + 4), __ldg(row + 5));
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
first_match6_kernel(Fields6 in, const uint4* __restrict__ rules, int rp,
                    const int2* __restrict__ acl_span, int n_span, unsigned* __restrict__ out,
                    int b) {
  extern __shared__ uint4 smem[];  // each warp's two line tiles, 16-byte aligned
  const int warp = threadIdx.x / ra::WARP, lane = threadIdx.x % ra::WARP;
  unsigned* tiles = reinterpret_cast<unsigned*>(smem) + warp * STAGES * TILE_WORDS;
  // the warp's tiles: gw, gw + nw, ... below n_tiles
  const int n_tiles = static_cast<int>((static_cast<long long>(b) + TILE - 1) / TILE);
  const int gw = blockIdx.x * WARPS + warp, nw = gridDim.x * WARPS;
  if (gw >= n_tiles) return;  // warp-uniform
  load_tile(tiles, in, static_cast<unsigned>(gw) * TILE, b, lane);
  const int n_mine = (n_tiles - 1 - gw) / nw + 1;  // n_pos lines in all
  const int last = gw + (n_mine - 1) * nw;
  const int n_pos = (n_mine - 1) * TILE + min(TILE, b - last * TILE);

  const int g = lane / G, gl = lane % G;
  const unsigned before_me = (1u << (g * G)) - 1;  // the lanes of lower groups
  int claimed = 0, ready = -1;  // warp-uniform: lines claimed, last tile landed
  bool have = false;            // group-uniform from here on
  Line6 l{};
  int base = 0, end = 0;
  unsigned i_out = 0;
  for (;;) {
    // groups without a line claim the next ones, in group order
    const unsigned idle = __ballot_sync(ra::FULL_MASK, !have) & LEADERS;
    if (idle && claimed < n_pos) {
      const int q = claimed + __popc(idle & before_me);
      claimed += __popc(idle);
      const int k_last = (min(claimed, n_pos) - 1) / TILE;
      const bool crossed = k_last > ready;  // at most one tile a batch: 32 / G <= TILE
      if (crossed) {
        cp_async_wait_all();
        __syncwarp();
        ready = k_last;
      }
      if (!have && q < n_pos) {
        const int k = q / TILE, j = q % TILE;
        const uint4* t =
            reinterpret_cast<const uint4*>(tiles + (k % STAGES) * TILE_WORDS + j * N_FIELDS);
        const uint4 scalars = t[0], src = t[1], dst = t[2];  // scalars: acl, proto, sport, dport
        l.acl = scalars.x;
        l.proto = scalars.y;
        l.sport = scalars.z;
        l.dport = scalars.w;
        l.src_h = (static_cast<u64>(src.x) << 32) | src.y;
        l.src_l = (static_cast<u64>(src.z) << 32) | src.w;
        l.dst_h = (static_cast<u64>(dst.x) << 32) | dst.y;
        l.dst_l = (static_cast<u64>(dst.z) << 32) | dst.w;
        i_out = static_cast<unsigned>(gw + k * nw) * TILE + j;
        const int2 s = ra::line_span(acl_span, n_span, rp, l.acl);
        base = s.x;
        end = s.y;
        have = true;
      }
      if (crossed && ready + 1 < n_mine) {
        // every line of tile ready - 1 is in registers: its stage takes tile ready + 1
        __syncwarp();
        load_tile(tiles + ((ready + 1) % STAGES) * TILE_WORDS, in,
                  static_cast<unsigned>(gw + (ready + 1) * nw) * TILE, b, lane);
      }
    }
    if (!__any_sync(ra::FULL_MASK, have)) break;  // every line of the warp is answered
    const int r = base + gl;
    const bool hit = have && r < end && row6_holds(rules, r, l);
    const unsigned mine = (__ballot_sync(ra::FULL_MASK, hit) >> (g * G)) & GROUP_MASK;
    if (have) {
      if (mine) {
        if (gl == 0) out[i_out] = static_cast<unsigned>(base + __ffs(mine) - 1);
        have = false;
      } else if ((base += G) >= end) {
        if (gl == 0) out[i_out] = ra::NO_MATCH;
        have = false;
      }
    }
  }
}

}  // namespace

// fields: 12 pointers to [b] u32 line fields in FIELDS6 order (acl, proto,
// sport, dport, src0..src3, dst0..dst3); rules: the [rp, 24] kernel rule
// tensor of prep_rules6, 16-byte aligned.  The grid is as many blocks as
// fit on the card at once, or fewer when the batch needs fewer.
extern "C" int ra_first_match6(const void* acl, const void* proto, const void* sport,
                               const void* dport, const void* src0, const void* src1,
                               const void* src2, const void* src3, const void* dst0,
                               const void* dst1, const void* dst2, const void* dst3,
                               const void* rules, int rp, const void* acl_span, int n_span,
                               void* out, int b, void* stream) {
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  Fields6 in;
  const void* f[N_FIELDS] = {acl, proto, sport, dport, src0, src1, src2, src3,
                             dst0, dst1, dst2, dst3};
  for (int j = 0; j < N_FIELDS; ++j) in.f[j] = static_cast<const unsigned*>(f[j]);
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(first_match6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  LINE_SMEM)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, first_match6_kernel,
                                                           BLOCK_THREADS, LINE_SMEM)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (static_cast<long long>(b) + TILE - 1) / TILE;
  const long long needed = (tiles + WARPS - 1) / WARPS;
  const long long fit = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(needed < fit ? needed : fit);
  first_match6_kernel<<<grid, BLOCK_THREADS, LINE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const uint4*>(rules), rp, static_cast<const int2*>(acl_span), n_span,
      static_cast<unsigned*>(out), b);
  return static_cast<int>(cudaGetLastError());
}
