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
// What bounds it on the H100: the scan's integer operations, as in
// first_match.cu; the histograms add one shared-memory atomic per line
// and one flush of at most Rp + Ap words per block.
//
// What the design does about it: the Pallas kernel carries the sums
// across a sequential grid in VMEM.  Here blocks run in parallel in no
// order, so each block builds its histograms in shared memory with
// atomicAdd and adds its nonzero bins once into the zeroed global
// outputs with atomicAdd.  Integer atomics give the same bits in any
// order.  The histograms take 4 (Rp + Ap) bytes of dynamic shared memory
// (31 KB at Rp = 7680); above 48 KB the launch raises the kernel's
// dynamic shared-memory limit.  Above what a block can have (~227 KB,
// Rp > ~56k rows) no block can hold them, and the wrapper selects the
// global-atomic mode (global_mode = 1): every line adds straight into
// the global histograms.  Invalid lines fall out of both histograms, and
// the acl clamp matches rows_to_keys, as in the Pallas body.
#include "scan.cuh"

namespace {

__global__ void __launch_bounds__(ra::BLOCK_LINES)
match_hist_kernel(const unsigned* __restrict__ acl, const unsigned* __restrict__ proto,
                  const unsigned* __restrict__ src, const unsigned* __restrict__ sport,
                  const unsigned* __restrict__ dst, const unsigned* __restrict__ dport,
                  const unsigned* __restrict__ valid, const unsigned* __restrict__ rules_fm,
                  int rp, int n_acls, int ap, unsigned* __restrict__ out_row,
                  unsigned* __restrict__ hist_rows, unsigned* __restrict__ hist_deny, int b,
                  int global_mode) {
  __shared__ ra::RuleTile tile;
  extern __shared__ unsigned s_hist[];  // [rp + ap] in shared mode, unused otherwise
  unsigned* h_rows = global_mode ? hist_rows : s_hist;
  unsigned* h_deny = global_mode ? hist_deny : s_hist + rp;
  if (!global_mode) {
    for (int j = threadIdx.x; j < rp + ap; j += blockDim.x) s_hist[j] = 0u;
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < b;
  ra::Line line{};
  if (active) line = ra::load_line(acl, proto, src, sport, dst, dport, i);
  const unsigned best = ra::scan_first_match(tile, rules_fm, rp, line, active);
  if (active) {
    out_row[i] = best;
    if (valid[i] != 0u) {
      if (best != ra::NO_MATCH) {
        atomicAdd(&h_rows[best], 1u);
      } else {
        const unsigned a_max = static_cast<unsigned>(n_acls - 1);
        atomicAdd(&h_deny[line.acl > a_max ? a_max : line.acl], 1u);
      }
    }
  }
  if (!global_mode) {
    __syncthreads();
    for (int j = threadIdx.x; j < rp + ap; j += blockDim.x) {
      const unsigned v = s_hist[j];
      if (v) atomicAdd(j < rp ? &hist_rows[j] : &hist_deny[j - rp], v);
    }
  }
}

}  // namespace

// Largest dynamic shared memory (bytes) a match_hist block can have on
// `device`: the opt-in per-block limit less the kernel's static tile.
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

// hist_rows [rp] and hist_deny [ap] must be zeroed by the caller.
extern "C" int ra_match_hist(const void* acl, const void* proto, const void* src,
                             const void* sport, const void* dst, const void* dport,
                             const void* valid, const void* rules_fm, int rp, int n_acls,
                             int ap, void* out_row, void* hist_rows, void* hist_deny, int b,
                             int global_mode, void* stream) {
  if (b > 0) {
    const size_t smem = global_mode ? 0 : sizeof(unsigned) * (static_cast<size_t>(rp) + ap);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          match_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int grid = (b + ra::BLOCK_LINES - 1) / ra::BLOCK_LINES;
    match_hist_kernel<<<grid, ra::BLOCK_LINES, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(acl), static_cast<const unsigned*>(proto),
        static_cast<const unsigned*>(src), static_cast<const unsigned*>(sport),
        static_cast<const unsigned*>(dst), static_cast<const unsigned*>(dport),
        static_cast<const unsigned*>(valid), static_cast<const unsigned*>(rules_fm), rp, n_acls,
        ap, static_cast<unsigned*>(out_row), static_cast<unsigned*>(hist_rows),
        static_cast<unsigned*>(hist_deny), b, global_mode);
  }
  return static_cast<int>(cudaGetLastError());
}
