// match_hist: the first-match scan fused with the two count histograms.
//
// Replaces the Pallas kernel of ruleset_analysis_tpu/ops/pallas_fused.py
// (match_rows_and_hists_pallas -> _kernel): the first_match scan, plus
// over VALID lines only
//   hist_rows[Rp]  lines per first-matched rule row, and
//   hist_deny[Ap]  unmatched lines per ACL, the acl clamped to n_acls - 1,
// which ops/match_hist.py counts_from_hists folds into the per-key counts
// delta with two row-sized scatters instead of one batch-sized scatter.
//
// What bounds it on the H100: the scan's integer operations, 12 per rule
// test the data needs, as in first_match.cu; the histograms add at most
// one atomic per valid line and one zeroing and flush of Rp + Ap words
// per block.
//
// What the design does about it: the scan is first_match.cu's (each line
// walks only its own ACL's span, 32 rows per warp step, csrc/scan.cuh).
// The Pallas kernel carries the sums across a sequential grid in VMEM;
// here the grid is persistent instead: as many 1024-thread blocks as fit
// on the card at once (one per SM at this register count), each walking
// the batch in warp-sized groups of lines with a grid-stride loop, so a
// block zeroes and flushes its shared-memory histograms once, and few
// large blocks leave most of each SM's shared memory to the L1 cache that
// holds the rules.  A warp adds its valid lines with one atomicAdd per
// distinct bin (__match_any_sync groups the lanes with the same bin), so
// hot rows do not serialise; the block adds its nonzero bins once into
// the zeroed global outputs.  Integer atomics give the same bits in any
// order.  The histograms take 4 (Rp + Ap) bytes of dynamic shared memory
// (31 KB at Rp = 7680); above 48 KB the launch raises the kernel's
// dynamic shared-memory limit.  Above what a block can have (~227 KB,
// Rp > ~56k rows) no block can hold them, and the wrapper selects the
// global-atomic mode (global_mode = 1): warps add straight into the
// global histograms.  Invalid lines fall out of both histograms, and the
// acl clamp matches rows_to_keys, as in the Pallas body.
#include "scan.cuh"

namespace {

constexpr int BLOCK_THREADS = 1024;

__global__ void __launch_bounds__(BLOCK_THREADS)
match_hist_kernel(const unsigned* __restrict__ acl, const unsigned* __restrict__ proto,
                  const unsigned* __restrict__ src, const unsigned* __restrict__ sport,
                  const unsigned* __restrict__ dst, const unsigned* __restrict__ dport,
                  const unsigned* __restrict__ valid, const uint4* __restrict__ rules, int rp,
                  const int2* __restrict__ acl_span, int n_span, int n_acls, int ap,
                  unsigned* __restrict__ out_row, unsigned* __restrict__ hist_rows,
                  unsigned* __restrict__ hist_deny, int b, int global_mode) {
  extern __shared__ unsigned s_hist[];  // [rp + ap] in shared mode, unused otherwise
  if (!global_mode) {
    for (int j = threadIdx.x; j < rp + ap; j += BLOCK_THREADS) s_hist[j] = 0u;
    __syncthreads();
  }
  const unsigned a_max = static_cast<unsigned>(n_acls - 1);
  const unsigned lane = threadIdx.x & (ra::WARP - 1);
  const unsigned stride = gridDim.x * BLOCK_THREADS;  // < 2^32 - b: the grid is one wave
  // warp-uniform loop: every lane of a warp takes the same groups
  for (unsigned g = blockIdx.x * BLOCK_THREADS + (threadIdx.x & ~(ra::WARP - 1));
       g < static_cast<unsigned>(b); g += stride) {
    const unsigned i = g + lane;
    const bool active = i < static_cast<unsigned>(b);
    ra::Line line{};
    int2 span = make_int2(0, 0);
    if (active) {
      line = ra::load_line(acl, proto, src, sport, dst, dport, i);
      span = ra::line_span(acl_span, n_span, rp, line.acl);
    }
    const unsigned best = ra::warp_first_match(rules, line, span);
    if (active) out_row[i] = best;
    const bool counted = active && valid[i] != 0u;
    // bin: the row on a hit, else rp + the clamped acl (the deny histogram)
    const unsigned bin =
        best != ra::NO_MATCH ? best : rp + (line.acl > a_max ? a_max : line.acl);
    const unsigned counting = __ballot_sync(ra::FULL_MASK, counted);
    if (counted) {
      const unsigned peers = __match_any_sync(counting, bin);
      if (lane == static_cast<unsigned>(__ffs(peers) - 1)) {
        unsigned* h = !global_mode ? s_hist + bin
                      : bin < static_cast<unsigned>(rp) ? hist_rows + bin
                                                        : hist_deny + (bin - rp);
        atomicAdd(h, static_cast<unsigned>(__popc(peers)));
      }
    }
  }
  if (!global_mode) {
    __syncthreads();
    for (int j = threadIdx.x; j < rp + ap; j += BLOCK_THREADS) {
      const unsigned v = s_hist[j];
      if (v) atomicAdd(j < rp ? &hist_rows[j] : &hist_deny[j - rp], v);
    }
  }
}

}  // namespace

// Largest dynamic shared memory (bytes) a match_hist block can have on
// `device`: the opt-in per-block limit less the kernel's static shared
// memory (none today).
extern "C" int ra_match_hist_smem_limit(int device, int* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, match_hist_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaGetLastError());
}

// rules: the [rp, RULE_COLS] kernel rule tensor, 16-byte aligned;
// hist_rows [rp] and hist_deny [ap] must be zeroed by the caller.  The
// grid is the number of blocks that fit on the current device at once
// (SMs x blocks per SM at this shared-memory size), or fewer when the
// batch needs fewer.
extern "C" int ra_match_hist(const void* acl, const void* proto, const void* src,
                             const void* sport, const void* dst, const void* dport,
                             const void* valid, const void* rules, int rp, const void* acl_span,
                             int n_span, int n_acls, int ap, void* out_row, void* hist_rows,
                             void* hist_deny, int b, int global_mode, void* stream) {
  if (b > 0) {
    const size_t smem = global_mode ? 0 : sizeof(unsigned) * (static_cast<size_t>(rp) + ap);
    cudaError_t err;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(match_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, match_hist_kernel,
                                                             BLOCK_THREADS, smem)) !=
            cudaSuccess) {
      return static_cast<int>(err);
    }
    const long long needed = (static_cast<long long>(b) + BLOCK_THREADS - 1) / BLOCK_THREADS;
    const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(needed < fit ? needed : fit);
    match_hist_kernel<<<grid, BLOCK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(acl), static_cast<const unsigned*>(proto),
        static_cast<const unsigned*>(src), static_cast<const unsigned*>(sport),
        static_cast<const unsigned*>(dst), static_cast<const unsigned*>(dport),
        static_cast<const unsigned*>(valid), static_cast<const uint4*>(rules), rp,
        static_cast<const int2*>(acl_span), n_span, n_acls, ap,
        static_cast<unsigned*>(out_row), static_cast<unsigned*>(hist_rows),
        static_cast<unsigned*>(hist_deny), b, global_mode);
  }
  return static_cast<int>(cudaGetLastError());
}
