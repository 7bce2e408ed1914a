// first_match6: the IPv6 first-match scan as a hand-written Hopper kernel.
//
// Replaces ruleset_analysis_tpu/ops/match6.py first_match_rows6 (an XLA
// block scan on the TPU, no Pallas): per v6 line, the lowest v6 rule row
// whose acl equals the line's, whose proto/sport/dport ranges hold (the
// v4 wraparound test) and whose src and dst lie within the row's 128-bit
// [lo, hi] bounds (big-endian u32 limbs, compared lexicographically);
// else 0xFFFFFFFF (NO_MATCH).
//
// Why a kernel where the reference had none: XLA fuses the compare chain
// into one pass over [B, 512] tiles, but torch eager materialises every
// intermediate, so the plain scan costs hundreds of ms per 2^20 lines.
//
// What bounds it on the H100: integer operations where a line walks
// many rows, bytes where it walks few.  A line reads 48 B and writes 4 B;
// each rule test needs at least 24 integer operations (an acl compare,
// three scalar ranges, four 128-bit bounds), and a line needs its own
// ACL's v6 rows up to its first hit.
//
// What the design does about it: the v4 kernels' warp loop
// (csrc/scan.cuh warp_first_match_by).  Each line tests only its own
// ACL's v6 row span (a table built once per ruleset by ops/first_match.py
// acl_spans over column 0); a warp takes its 32 lines one at a time,
// tests 32 rows of the line's span per step, and stops at the first
// ballot with a hit.
//
// Row layout (ops/first_match6.py prep_rules6): a v6 row is 24 u32
// (96 B), so the v4 kernels' three 16-byte loads cannot hold it; here a
// row is six 16-byte loads, grouped so that each load is one whole
// operand: (acl, proto lo, proto hi - lo, sport lo), (sport hi - lo,
// dport lo, dport hi - lo, key), then src lo, src hi, dst lo, dst hi as
// four limbs each.  Rows start 32-byte aligned, so each pair of loads
// shares one 32-byte sector and the second of the pair hits L1; a warp
// step reads 32 consecutive rows (3 KB) from L2, where the whole rule
// tensor stays.  The address bounds stay lo and hi (not hi - lo) so the
// test is the reference's own lexicographic one.
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError().
#include "scan.cuh"

namespace {

constexpr int BLOCK_THREADS = 256;  // 8 warps, one line per thread
constexpr int ROW6_QUADS = 6;       // 16-byte loads per v6 kernel row

using u64 = unsigned long long;

struct Line6 {
  unsigned acl, proto, sport, dport;
  u64 src_h, src_l, dst_h, dst_l;  // 128-bit addresses as big-endian 64-bit halves

  // lane k's line, broadcast to the whole warp (ra::warp_first_match_by)
  __device__ __forceinline__ Line6 shfl(int k) const {
    Line6 l;
    l.acl = __shfl_sync(ra::FULL_MASK, acl, k);
    l.proto = __shfl_sync(ra::FULL_MASK, proto, k);
    l.sport = __shfl_sync(ra::FULL_MASK, sport, k);
    l.dport = __shfl_sync(ra::FULL_MASK, dport, k);
    l.src_h = __shfl_sync(ra::FULL_MASK, src_h, k);
    l.src_l = __shfl_sync(ra::FULL_MASK, src_l, k);
    l.dst_h = __shfl_sync(ra::FULL_MASK, dst_h, k);
    l.dst_l = __shfl_sync(ra::FULL_MASK, dst_l, k);
    return l;
  }
};

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

__device__ __forceinline__ bool row6_holds(const uint4* __restrict__ rules, int r,
                                           const Line6& l) {
  const uint4* row = rules + ROW6_QUADS * r;
  const uint4 a = __ldg(row);      // acl, proto lo, proto d, sport lo
  const uint4 b = __ldg(row + 1);  // sport d, dport lo, dport d, key
  const uint4 slo = __ldg(row + 2);
  const uint4 shi = __ldg(row + 3);
  const uint4 dlo = __ldg(row + 4);
  const uint4 dhi = __ldg(row + 5);
  return (a.x == l.acl) & ((l.proto - a.y) <= a.z) & ((l.sport - a.w) <= b.x) &
         ((l.dport - b.y) <= b.z) & within128(l.src_h, l.src_l, slo, shi) &
         within128(l.dst_h, l.dst_l, dlo, dhi);
}

struct Fields6 {
  const unsigned* f[12];  // acl, proto, sport, dport, src0..3, dst0..3
};

__global__ void __launch_bounds__(BLOCK_THREADS)
first_match6_kernel(Fields6 in, const uint4* __restrict__ rules, int rp,
                    const int2* __restrict__ acl_span, int n_span,
                    unsigned* __restrict__ out, int b) {
  const unsigned i = blockIdx.x * BLOCK_THREADS + threadIdx.x;
  const bool active = i < static_cast<unsigned>(b);  // lines past B are masked, not padded
  Line6 line{};
  int2 span = make_int2(0, 0);
  if (active) {
    line.acl = __ldg(in.f[0] + i);
    line.proto = __ldg(in.f[1] + i);
    line.sport = __ldg(in.f[2] + i);
    line.dport = __ldg(in.f[3] + i);
    line.src_h = (static_cast<u64>(__ldg(in.f[4] + i)) << 32) | __ldg(in.f[5] + i);
    line.src_l = (static_cast<u64>(__ldg(in.f[6] + i)) << 32) | __ldg(in.f[7] + i);
    line.dst_h = (static_cast<u64>(__ldg(in.f[8] + i)) << 32) | __ldg(in.f[9] + i);
    line.dst_l = (static_cast<u64>(__ldg(in.f[10] + i)) << 32) | __ldg(in.f[11] + i);
    span = ra::line_span(acl_span, n_span, rp, line.acl);
  }
  const unsigned best = ra::warp_first_match_by(
      line, span, [rules](int r, const Line6& l) { return row6_holds(rules, r, l); });
  if (active) out[i] = best;
}

}  // namespace

// fields: 12 pointers to [b] u32 line fields in FIELDS6 order (acl, proto,
// sport, dport, src0..src3, dst0..dst3); rules: the [rp, 24] kernel rule
// tensor of prep_rules6, 16-byte aligned.
extern "C" int ra_first_match6(const void* acl, const void* proto, const void* sport,
                               const void* dport, const void* src0, const void* src1,
                               const void* src2, const void* src3, const void* dst0,
                               const void* dst1, const void* dst2, const void* dst3,
                               const void* rules, int rp, const void* acl_span, int n_span,
                               void* out, int b, void* stream) {
  if (b > 0) {
    Fields6 in;
    const void* f[12] = {acl, proto, sport, dport, src0, src1, src2, src3,
                         dst0, dst1, dst2, dst3};
    for (int j = 0; j < 12; ++j) in.f[j] = static_cast<const unsigned*>(f[j]);
    const int grid = static_cast<int>((static_cast<long long>(b) + BLOCK_THREADS - 1) /
                                      BLOCK_THREADS);
    first_match6_kernel<<<grid, BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        in, static_cast<const uint4*>(rules), rp, static_cast<const int2*>(acl_span), n_span,
        static_cast<unsigned*>(out), b);
  }
  return static_cast<int>(cudaGetLastError());
}
