// reg_tail: the register tail of the analysis step, and the talker top-k
// select after it, as hand-written Hopper kernels.
//
// reg_tail_kernel replaces the scatter branch of the reference's register
// tail, ruleset_analysis_tpu/parallel/step.py _merge_tail (XLA there; its
// single-device form is models/pipeline.py _update_registers): per line,
// the count key of the match kernel's row (ops/match.py rows_to_keys), the
// talker-CMS add at one multiply-shift bucket of hash_pair(acl, src) per
// depth row, the HLL max of the source's rank into hll[key * m + reg], the
// exact counts' per-key add (when the match kernel did not build the
// delta), and on a selecting chunk the candidate table's per-slot weight
// sum (cnt) and largest sampled line index (rep).
//
// select_kernel replaces ruleset_analysis_tpu/ops/topk.py
// select_from_tables (XLA there): lax.top_k of the table's int32 counts
// (ties to the lower slot), then each candidate's (acl, src), its
// post-update talker-CMS estimate and the empty-slot mask.
//
// Both read the batch as the match kernels do: the match kernel's int32
// row and the batch's int32 columns (u32 bits), no widened copies.  A v6
// line's source is its four address limbs, folded here as
// ops/match6.py fold_src32 does, and its talker gid carries acl_tag.
//
// What bounds reg_tail on the H100: its atomics.  A v4 line reads 16 B
// and costs ~90 integer operations of hashing, far below the card's
// rates; it also makes four to six register updates, which run as atomics
// in the 50 MB L2 (the registers are small: the 16x256 HLL file, 8.4 MB in
// int64, is the largest).  Atomics on one address serialise there, so
// skewed traffic, where a heavy talker sends its lines to the same CMS
// cells, slot and HLL cell, and the counts delta, where 2^20 lines meet on
// 4112 keys, are the slow cases.
//
// What the design does about it.  Every update is a u32 add (mod 2^32)
// or a max, so any grouping of the updates gives the same registers bit
// for bit.  A persistent grid (as many blocks as fit on the card) walks
// the batch a warp of 32 consecutive lines at a time; every lane reaches
// the warp collectives (no early returns).  Within a warp:
// - lines with the same (acl, src) pair are grouped (__match_any_sync);
//   one lane adds the group's u32 weight sum to each talker-CMS row, and,
//   over the group's sampled lines, adds their sum to cnt[slot] and takes
//   the group's largest sample index into rep[slot] (the slot depends on
//   the pair and the salt only; lines are consecutive, so the largest
//   index is the highest lane's);
// - each line reads its HLL cell (key << p | reg) first; the lines whose
//   rank exceeds it are grouped by cell and one lane takes the group's
//   largest rank (cells only grow during a launch, so a stale read can
//   only cause an atomic, never skip one);
// - the counts delta goes to a block-private u32 histogram of n_keys
//   cells in shared memory (16 KB at 4112 keys), one shared-memory atomic
//   a line, flushed once per block with one global atomic per non-zero
//   cell.  Where 4 n_keys bytes exceed a block's shared memory, the
//   wrapper selects the global mode: lines with the same key are grouped
//   and one lane adds the group's sum to the global delta.
// The registers hold u32 values in int64 words with a zero high word, so a
// 32-bit atomicAdd on the low word is the reference's wrapping u32 add,
// and a 32-bit atomicMax on it the HLL max; rep holds -1 for an empty
// slot, so it takes a 64-bit signed atomicMax.
//
// What bounds the select: latency.  It reads the 32768-slot table (256 KB)
// once and picks 64 candidates: a few microseconds of work, for which
// torch.topk and its elementwise ops launched eight kernels.  The design
// is one block: the table's counts as int32 in shared memory (128 KB), a
// radix select over the positive counts (8-bit digits, from the largest
// count's top digit down; each warp counts digits in its own histogram,
// since small counts crowd a few bins) for the k-th count C, a compaction
// of the slots above C and of the lowest-slot ties at C (each warp walks
// its run of slots 32 consecutive ones at a time, free of bank
// conflicts), each winner ranked by counting the winners whose key
// (count, then lower slot) is larger, and the pick.
// A slot whose count is 0, or 2^31 and more (negative as int32, as the
// reference reads it), ranks below every positive one and is masked to
// zero, so only positive counts are ranked; positions past the winners are
// zero.  Above SELECT_RANK_CAP winners the ranking by counting is too slow
// for one block, and a second launch ranks and picks over many blocks.
//
// The hash constants come from Python (ops/reg_tail.py TAIL_CONSTANTS,
// from ops/hashing.py, ops/hll.py and ops/match6.py) at every launch; this
// file holds none of its own.
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int WARP = 32;
constexpr int BLOCK_THREADS = 1024;
constexpr int MAX_DEPTH = 8;  // config.MAX_CMS_DEPTH
constexpr int FOLD_LIMBS = 4;  // a v6 source's u32 limbs
// ops/reg_tail.py TAIL_CONSTANTS: the seven scalars, the four limb-fold
// multipliers, then MAX_DEPTH multiply-shift constants
constexpr int N_CONSTS = 7 + FOLD_LIMBS + MAX_DEPTH;
// the select: slots index the low SLOT_BITS of a rank key (slots <=
// 2^SLOT_BITS, ops/topk.py CAND_SLOTS), one block of SELECT_THREADS, and
// at most SELECT_RANK_CAP winners ranked inside it
constexpr int SLOT_BITS = 15;
constexpr int SELECT_THREADS = 1024;
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int SELECT_RANK_CAP = 2048;
constexpr int RADIX_BITS = 8;
constexpr int RADIX_BINS = 1 << RADIX_BITS;
constexpr int RANK_THREADS = 256;
constexpr int LOAD_UNROLL = 8;

struct Consts {
  unsigned fmix_c1, fmix_c2, pair_mul, pair_seed, pair_seed2, hll_seed_idx, hll_seed_rank;
  unsigned fold[FOLD_LIMBS];
  unsigned ms[MAX_DEPTH];
};

// A batch's line columns: int32 words holding u32 bits.  src has one
// column (v4) or FOLD_LIMBS (v6 limbs, most significant first).
struct Lines {
  const int* acl;
  const int* src[FOLD_LIMBS];
  int src_limbs;
  unsigned acl_tag;
};

// The talker CMS and what the pick needs to read a candidate back.
struct Talk {
  const long long* cells;  // [depth, 2^width_bits] int64 holding u32
  int depth, width_bits;
  int sample_shift;        // a sample index j names line (j << shift) + phase
  unsigned phase;
};

__device__ __forceinline__ unsigned fmix32(unsigned x, unsigned seed, const Consts& c) {
  x ^= seed;
  x ^= x >> 16;
  x *= c.fmix_c1;
  x ^= x >> 13;
  x *= c.fmix_c2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned hash_pair(unsigned a, unsigned b, const Consts& c) {
  return fmix32(fmix32(a, c.pair_seed, c) ^ (b * c.pair_mul), c.pair_seed2, c);
}

// the line's talker gid and source identity (ops/match6.py fold_src32 for
// a v6 source)
__device__ __forceinline__ unsigned line_acl(const Lines& L, long long i) {
  return static_cast<unsigned>(L.acl[i]) | L.acl_tag;
}

__device__ __forceinline__ unsigned line_src(const Lines& L, long long i, const Consts& c) {
  if (L.src_limbs == 1) return static_cast<unsigned>(L.src[0][i]);
  unsigned h = 0;
  for (int l = 0; l < FOLD_LIMBS; ++l) h = (h ^ static_cast<unsigned>(L.src[l][i])) * c.fold[l];
  return h ^ (h >> 15);
}

// the low 32-bit word of int64 element e (little-endian)
__device__ __forceinline__ unsigned* lo_word(unsigned* base, long long e) {
  return base + 2 * e;
}

// the highest lane of a group: its leader (and, lines being consecutive,
// the lane of the group's largest line index)
__device__ __forceinline__ unsigned leader_of(unsigned peers) {
  return 31u - __clz(peers);
}

__global__ void __launch_bounds__(BLOCK_THREADS)
reg_tail_kernel(const int* __restrict__ row, const int* __restrict__ valid, Lines L, int b,
                const int* __restrict__ key_k, int n_rows, int n_acls,
                unsigned* __restrict__ talk, int depth, int width_bits,
                unsigned* __restrict__ hll, int n_keys, int hll_p,
                unsigned* __restrict__ counts, int global_counts, unsigned* __restrict__ cnt,
                long long* __restrict__ rep, int slots, unsigned salt, int sample_shift,
                Consts c) {
  extern __shared__ unsigned s_counts[];  // [n_keys] in the shared counts mode, else unused
  const bool shared_counts = counts != nullptr && !global_counts;
  if (shared_counts) {
    for (int j = threadIdx.x; j < n_keys; j += BLOCK_THREADS) s_counts[j] = 0u;
    __syncthreads();
  }
  const unsigned lane = threadIdx.x & (WARP - 1);
  const long long width = 1ll << width_bits;
  // ops/topk.py sample_cols: the salt-rotated stride sample, when the
  // batch holds at least one stride (else every line is in it, j = i)
  const bool sampling = sample_shift > 0 && b >= (1 << sample_shift);
  const unsigned stride_mask = sampling ? (1u << sample_shift) - 1u : 0u;
  const unsigned sample_end = sampling ? (static_cast<unsigned>(b) >> sample_shift) << sample_shift
                                       : static_cast<unsigned>(b);
  const unsigned phase = salt & stride_mask;
  const unsigned grid_stride = gridDim.x * BLOCK_THREADS;  // < 2^32 - b: the grid is one wave
  // warp-uniform loop: every lane of a warp takes the same 32 lines
  for (unsigned g = blockIdx.x * BLOCK_THREADS + (threadIdx.x & ~(WARP - 1u));
       g < static_cast<unsigned>(b); g += grid_stride) {
    const unsigned i = g + lane;
    const unsigned w = i < static_cast<unsigned>(b) ? static_cast<unsigned>(valid[i]) : 0u;
    const bool live = w != 0u;  // an invalid line changes no register and no slot
    unsigned s = 0u, pair = 0u, key = 0xFFFFFFFFu;
    if (live) {
      const unsigned a = static_cast<unsigned>(L.acl[i]);
      s = line_src(L, i, c);
      pair = hash_pair(a | L.acl_tag, s, c);
      // rows_to_keys: a matched row's rule key, else the line's ACL's deny
      // key (ids past the last ACL clamp onto it); key_k is the row keys,
      // then the deny keys.  A row past the table has no key.
      const int r = row[i];
      key = r < 0 ? static_cast<unsigned>(key_k[n_rows + min(a, n_acls - 1u)])
            : r < n_rows ? static_cast<unsigned>(key_k[r])
                         : 0xFFFFFFFFu;
    }
    // talker CMS: one add of the pair group's weight sum per depth row
    // (ops/cms.py cms_bucket of the pair: mix, then multiply-shift)
    const unsigned live_lanes = __ballot_sync(FULL_MASK, live);
    unsigned pair_peers = 0u;
    if (live) {
      pair_peers = __match_any_sync(live_lanes, pair);
      const unsigned sum = __reduce_add_sync(pair_peers, w);
      if (lane == leader_of(pair_peers)) {
        const unsigned mixed = fmix32(pair, 0u, c);
        for (int d = 0; d < depth; ++d) {
          const unsigned bucket = (mixed * c.ms[d]) >> (32 - width_bits);
          atomicAdd(lo_word(talk, d * width + bucket), sum);
        }
      }
    }
    // out-of-range keys are dropped
    const bool keyed = live && key < static_cast<unsigned>(n_keys);
    // ops/hll.py hll_reg_rank: register from the high p bits, rank 1..33;
    // the cell is read first, and only lanes whose rank exceeds it group
    // by cell (most lines of a run find their cell already as high)
    unsigned rank = 0u, cell = 0u;
    bool raises = false;
    if (keyed) {
      const unsigned reg = fmix32(s, c.hll_seed_idx, c) >> (32 - hll_p);
      rank = __clz(fmix32(s, c.hll_seed_rank, c)) + 1u;
      cell = (key << hll_p) | reg;  // < 2^32: checked at launch
      raises = *lo_word(hll, cell) < rank;
    }
    const unsigned raising_lanes = __ballot_sync(FULL_MASK, raises);
    if (raises) {
      const unsigned cell_peers = __match_any_sync(raising_lanes, cell);
      const unsigned top = __reduce_max_sync(cell_peers, rank);
      if (lane == leader_of(cell_peers)) atomicMax(lo_word(hll, cell), top);
    }
    if (counts != nullptr) {
      if (shared_counts) {
        // the block's histogram: a shared-memory atomic a line
        if (keyed) atomicAdd(s_counts + key, w);
      } else {
        const unsigned keyed_lanes = __ballot_sync(FULL_MASK, keyed);
        if (keyed) {
          const unsigned key_peers = __match_any_sync(keyed_lanes, key);
          const unsigned sum = __reduce_add_sync(key_peers, w);
          if (lane == leader_of(key_peers)) atomicAdd(lo_word(counts, key), sum);
        }
      }
    }
    if (cnt != nullptr) {
      const bool sampled = live && i < sample_end && (i & stride_mask) == phase;
      const unsigned sampled_lanes = __ballot_sync(FULL_MASK, sampled);
      if (sampled) {
        // the pair's sampled lines: their weight sum, and the highest
        // lane's sample index (the group's largest)
        const unsigned peers = pair_peers & sampled_lanes;
        const unsigned sum = __reduce_add_sync(peers, w);
        if (lane == leader_of(peers)) {
          const unsigned slot = fmix32(pair ^ salt, 0u, c) & static_cast<unsigned>(slots - 1);
          atomicAdd(lo_word(cnt, slot), sum);
          atomicMax(&rep[slot], static_cast<long long>(sampling ? i >> sample_shift : i));
        }
      }
    }
  }
  if (shared_counts) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_keys; j += BLOCK_THREADS) {
      const unsigned v = s_counts[j];
      if (v) atomicAdd(lo_word(counts, j), v);
    }
  }
}

// ---------------------------------------------------------------------------
// the select
// ---------------------------------------------------------------------------

// a winner's rank key: its count above its reversed slot, unique per slot
// (ops/topk.py slot_rank_key for a positive count)
__device__ __forceinline__ unsigned long long rank_key(unsigned count, int slot, int slots) {
  return (static_cast<unsigned long long>(count) << SLOT_BITS) |
         static_cast<unsigned>(slots - 1 - slot);
}

// candidate t of the output: the winner of key `key`, its (acl, src) read
// back through rep, its talker-CMS estimate, zero where rep is empty
__device__ void pick(int t, unsigned long long key, int slots, const long long* __restrict__ rep,
                     const Lines& L, const Talk& T, const Consts& c, long long* __restrict__ ca,
                     long long* __restrict__ cs, long long* __restrict__ ce) {
  const int slot = slots - 1 - static_cast<int>(key & ((1u << SLOT_BITS) - 1u));
  const long long r = rep[slot];
  if (r < 0) {
    ca[t] = cs[t] = ce[t] = 0;
    return;
  }
  const long long line = (r << T.sample_shift) + T.phase;
  const unsigned a = line_acl(L, line);
  const unsigned s = line_src(L, line, c);
  const unsigned mixed = fmix32(hash_pair(a, s, c), 0u, c);
  const long long width = 1ll << T.width_bits;
  long long est = 0;
  for (int d = 0; d < T.depth; ++d) {
    const long long v = T.cells[d * width + ((mixed * c.ms[d]) >> (32 - T.width_bits))];
    est = d == 0 || v < est ? v : est;
  }
  ca[t] = a;
  cs[t] = s;
  ce[t] = est;
}

// the number of keys[0..n) above `key` (keys are unique): key's place
__device__ __forceinline__ int rank_of(unsigned long long key, const unsigned long long* keys,
                                       int n) {
  int above = 0;
  for (int u = 0; u < n; ++u) above += keys[u] > key;
  return above;
}

// block-wide exclusive prefix sum of one int a thread (SELECT_THREADS);
// returns the thread's prefix, and the total through *total
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & (WARP - 1), warp = threadIdx.x / WARP;
  int x = v;
  for (int off = 1; off < WARP; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  if (lane == WARP - 1) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = s_warp[lane];  // SELECT_THREADS / WARP == WARP warps
    for (int off = 1; off < WARP; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, t, off);
      if (lane >= off) t += y;
    }
    s_warp[lane] = t;  // inclusive prefix over warps
  }
  __syncthreads();
  const int out = x - v + (warp > 0 ? s_warp[warp - 1] : 0);
  *total = s_warp[WARP - 1];
  __syncthreads();  // s_warp is reused by the next scan
  return out;
}

__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const long long* __restrict__ cnt, const long long* __restrict__ rep, int slots,
              int k, Lines L, Talk T, Consts c, long long* __restrict__ ca,
              long long* __restrict__ cs, long long* __restrict__ ce,
              unsigned long long* __restrict__ win_keys, int* __restrict__ n_win_out) {
  // dynamic: the slots' int32 counts, then up to SELECT_RANK_CAP winner keys
  extern __shared__ unsigned long long s_dyn[];
  unsigned long long* s_win = s_dyn;
  int* s_cnt = reinterpret_cast<int*>(s_win + SELECT_RANK_CAP);
  __shared__ unsigned s_hist[RADIX_BINS];
  __shared__ unsigned s_whist[SELECT_WARPS][RADIX_BINS];  // each warp's own digit counts
  __shared__ int s_warp[WARP];
  __shared__ unsigned s_prefix, s_mask, s_rank, s_max;
  __shared__ int s_n_win;
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;

  // the table's counts as int32 (the reference's cnt.astype(int32)), read
  // LOAD_UNROLL slots a thread at a time so their loads overlap; the
  // largest positive one sets the radix select's first digit
  unsigned top = 0u;
  int positive = 0;
  for (int base = tid; base < slots; base += SELECT_THREADS * LOAD_UNROLL) {
    long long raw[LOAD_UNROLL];
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; ++u) {
      const int s = base + u * SELECT_THREADS;
      raw[u] = s < slots ? cnt[s] : 0;
    }
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; ++u) {
      const int s = base + u * SELECT_THREADS;
      const int v = static_cast<int>(static_cast<unsigned>(raw[u]));
      if (s < slots) s_cnt[s] = v;
      if (v > 0) {
        ++positive;
        if (static_cast<unsigned>(v) > top) top = v;
      }
    }
  }
  top = __reduce_max_sync(FULL_MASK, top);
  if (tid == 0) {
    s_max = 0u;
    s_prefix = 0u;
    s_mask = 0u;
    s_rank = static_cast<unsigned>(k);
    s_n_win = 0;
  }
  __syncthreads();
  if (lane == 0) atomicMax(&s_max, top);
  __syncthreads();

  // radix select of the k-th largest positive count C (with ties), MSB
  // digit first: s_rank ends as the number of slots at C that win (the
  // lowest ones), the slots above C all win.  With k or fewer positive
  // counts every positive slot wins: C = 0, no ties.
  int n_pos;
  block_exclusive_scan(positive, s_warp, &n_pos);
  if (n_pos > k) {
    const int top_bit = 31 - __clz(s_max);
    for (int shift = (top_bit / RADIX_BITS) * RADIX_BITS; shift >= 0; shift -= RADIX_BITS) {
      for (int j = lane; j < RADIX_BINS; j += WARP) s_whist[warp][j] = 0u;
      __syncwarp();
      const unsigned prefix = s_prefix, mask = s_mask;
      // slots walked a warp of 32 at a time so every lane reaches the
      // collective; equal digits add once per warp, into the warp's own
      // histogram (small counts share their digits: one histogram for the
      // block would serialise its atomics on a few bins)
      for (int base = tid & ~(WARP - 1); base < slots; base += SELECT_THREADS) {
        const int s = base + lane;
        const int v = s < slots ? s_cnt[s] : 0;
        const bool in = v > 0 && (static_cast<unsigned>(v) & mask) == prefix;
        const unsigned in_lanes = __ballot_sync(FULL_MASK, in);
        if (in) {
          const unsigned digit = (static_cast<unsigned>(v) >> shift) & (RADIX_BINS - 1);
          const unsigned peers = __match_any_sync(in_lanes, digit);
          // one leader a digit: the warp's lanes write distinct bins
          if (static_cast<unsigned>(lane) == leader_of(peers)) s_whist[warp][digit] += __popc(peers);
        }
        __syncwarp();
      }
      __syncthreads();
      for (int j = tid; j < RADIX_BINS; j += SELECT_THREADS) {
        unsigned sum = 0u;
        for (int q = 0; q < SELECT_WARPS; ++q) sum += s_whist[q][j];
        s_hist[j] = sum;
      }
      __syncthreads();
      if (tid < WARP) {
        // from the top digit down: the digit where the rank falls
        constexpr int PER_LANE = RADIX_BINS / WARP;
        unsigned mine = 0u;
        for (int j = 0; j < PER_LANE; ++j) mine += s_hist[lane * PER_LANE + j];
        unsigned above = mine;  // bins of this lane and every higher lane
        for (int off = 1; off < WARP; off <<= 1) {
          const unsigned y = __shfl_down_sync(FULL_MASK, above, off);
          if (lane + off < WARP) above += y;
        }
        const unsigned higher = above - mine, rank = s_rank;
        if (higher < rank && rank <= above) {
          unsigned acc = higher;
          for (int j = PER_LANE - 1; j >= 0; --j) {
            const int d = lane * PER_LANE + j;
            if (acc + s_hist[d] >= rank) {
              s_rank = rank - acc;
              s_prefix = prefix | (static_cast<unsigned>(d) << shift);
              s_mask = mask | (static_cast<unsigned>(RADIX_BINS - 1) << shift);
              break;
            }
            acc += s_hist[d];
          }
        }
      }
      __syncthreads();
    }
  } else if (tid == 0) {
    s_prefix = 0u;  // C = 0: every positive count is above it
    s_rank = 0u;
  }
  __syncthreads();
  const int thresh = static_cast<int>(s_prefix);
  const unsigned ties_wanted = s_rank;

  // compaction: every slot above C, and the lowest-slot ties at C.  Each
  // warp owns a run of consecutive slots, walked 32 at a time (lane l on
  // slot base + l), so a block scan of the warps' tie counts and a ballot
  // a step give the ties their order by slot.
  const int per_warp = (slots + SELECT_WARPS - 1) / SELECT_WARPS;
  const int lo = warp * per_warp, hi = min(lo + per_warp, slots);
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  int ties = 0;
  for (int base = lo; base < hi; base += WARP) {
    const int s = base + lane;
    ties += __popc(__ballot_sync(FULL_MASK, s < hi && thresh > 0 && s_cnt[s] == thresh));
  }
  int n_ties;
  int tie_rank = __shfl_sync(FULL_MASK, block_exclusive_scan(lane == 0 ? ties : 0, s_warp,
                                                             &n_ties), 0);
  const bool ranked_here = k <= SELECT_RANK_CAP;
  for (int base = lo; base < hi; base += WARP) {
    const int s = base + lane;
    const int v = s < hi ? s_cnt[s] : 0;
    const bool tie = s < hi && thresh > 0 && v == thresh;
    const unsigned tie_lanes = __ballot_sync(FULL_MASK, tie);
    const bool wins = (s < hi && v > thresh) ||
                      (tie && static_cast<unsigned>(tie_rank + __popc(tie_lanes & below)) <
                                  ties_wanted);
    tie_rank += __popc(tie_lanes);
    const unsigned win_lanes = __ballot_sync(FULL_MASK, wins);
    if (win_lanes == 0u) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(&s_n_win, __popc(win_lanes));
    at = __shfl_sync(FULL_MASK, at, 0) + __popc(win_lanes & below);
    if (wins) {
      const unsigned long long key = rank_key(static_cast<unsigned>(v), s, slots);
      if (ranked_here) {
        s_win[at] = key;
      } else {
        win_keys[at] = key;
      }
    }
  }
  __syncthreads();
  const int n_win = s_n_win;
  // positions past the winners: zero (a zero or negative count's slot)
  for (int t = n_win + tid; t < k; t += SELECT_THREADS) ca[t] = cs[t] = ce[t] = 0;
  if (!ranked_here) {
    if (tid == 0) *n_win_out = n_win;
    return;
  }
  for (int u = tid; u < n_win; u += SELECT_THREADS) {
    const unsigned long long key = s_win[u];
    pick(rank_of(key, s_win, n_win), key, slots, rep, L, T, c, ca, cs, ce);
  }
}

// The second launch, above SELECT_RANK_CAP winners: each thread ranks one
// winner against all of them (tiles through shared memory) and picks it.
__global__ void __launch_bounds__(RANK_THREADS)
select_rank_kernel(const unsigned long long* __restrict__ win_keys,
                   const int* __restrict__ n_win_in, int slots,
                   const long long* __restrict__ rep, Lines L, Talk T, Consts c,
                   long long* __restrict__ ca, long long* __restrict__ cs,
                   long long* __restrict__ ce) {
  __shared__ unsigned long long s_tile[RANK_THREADS];
  const int n_win = *n_win_in;
  const int u = blockIdx.x * RANK_THREADS + threadIdx.x;
  const unsigned long long key = u < n_win ? win_keys[u] : 0ull;
  int above = 0;
  for (int base = 0; base < n_win; base += RANK_THREADS) {
    const int j = base + threadIdx.x;
    s_tile[threadIdx.x] = j < n_win ? win_keys[j] : 0ull;  // 0: below every key
    __syncthreads();
    above += rank_of(key, s_tile, RANK_THREADS);
    __syncthreads();
  }
  if (u < n_win) pick(above, key, slots, rep, L, T, c, ca, cs, ce);
}

bool load_consts(const unsigned* v, int n, Consts* c) {
  if (v == nullptr || n != N_CONSTS) return false;
  c->fmix_c1 = v[0];
  c->fmix_c2 = v[1];
  c->pair_mul = v[2];
  c->pair_seed = v[3];
  c->pair_seed2 = v[4];
  c->hll_seed_idx = v[5];
  c->hll_seed_rank = v[6];
  for (int l = 0; l < FOLD_LIMBS; ++l) c->fold[l] = v[7 + l];
  for (int d = 0; d < MAX_DEPTH; ++d) c->ms[d] = v[7 + FOLD_LIMBS + d];
  return true;
}

bool load_lines(const void* acl, const void* const* src, int src_limbs, unsigned acl_tag,
                Lines* L) {
  if (acl == nullptr || src == nullptr || (src_limbs != 1 && src_limbs != FOLD_LIMBS)) {
    return false;
  }
  L->acl = static_cast<const int*>(acl);
  for (int l = 0; l < FOLD_LIMBS; ++l) {
    L->src[l] = l < src_limbs ? static_cast<const int*>(src[l]) : nullptr;
    if (l < src_limbs && L->src[l] == nullptr) return false;
  }
  L->src_limbs = src_limbs;
  L->acl_tag = acl_tag;
  return true;
}

size_t select_smem(int slots) {
  return sizeof(unsigned long long) * SELECT_RANK_CAP + sizeof(int) * static_cast<size_t>(slots);
}

}  // namespace

// Largest dynamic shared memory (bytes) a reg_tail block can have on
// `device` for its counts histogram: the opt-in per-block limit less the
// kernel's static shared memory (none).
extern "C" int ra_reg_tail_smem_limit(int device, int* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, reg_tail_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaGetLastError());
}

// row: [b] int32 match-kernel rows (-1 = no match); valid, acl: [b] int32
// (u32 bits; valid is the weight plane); src: host array of src_limbs
// (1 or 4) pointers to [b] int32 columns; acl_tag: ORed onto the talker
// gid.  key_k: [n_rows + n_acls] int32, each row's count key then each
// ACL's deny key.  talk [depth, 2^width_bits], hll [n_keys, 2^hll_p],
// counts [n_keys] and cnt [slots]: int64 registers holding u32 values,
// updated in place (counts and cnt zeroed by the caller); counts, cnt and
// rep may be null (no counts delta / no selection); global_counts: add the
// counts straight to `counts` (no shared-memory histogram); rep [slots]
// int64, -1 where empty.  consts: host array of N_CONSTS u32.  The grid is
// the number of blocks that fit on the current device at once, or fewer
// when the batch needs fewer.
extern "C" int ra_reg_tail(const void* row, const void* valid, const void* acl,
                           const void* const* src, int src_limbs, unsigned acl_tag, int b,
                           const void* key_k, int n_rows, int n_acls, void* talk, int depth,
                           int width_bits, void* hll, int n_keys, int hll_p, void* counts,
                           int global_counts, void* cnt, void* rep, int slots, unsigned salt,
                           int sample_shift, const unsigned* consts, int n_consts,
                           void* stream) {
  Consts c;
  Lines L;
  if (!load_consts(consts, n_consts, &c) || !load_lines(acl, src, src_limbs, acl_tag, &L) ||
      row == nullptr || valid == nullptr || key_k == nullptr || n_rows < 0 || n_acls < 1 ||
      depth < 1 || depth > MAX_DEPTH || width_bits < 1 || width_bits > 31 || hll_p < 1 ||
      hll_p > 16 || n_keys < 0 || (static_cast<long long>(n_keys) << hll_p) > (1ll << 32) ||
      (cnt != nullptr && (rep == nullptr || slots < 1 || (slots & (slots - 1)) != 0)) ||
      sample_shift < 0 || sample_shift > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0) {
    const size_t smem =
        counts != nullptr && !global_counts ? sizeof(unsigned) * static_cast<size_t>(n_keys) : 0;
    cudaError_t err;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(reg_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reg_tail_kernel,
                                                             BLOCK_THREADS, smem)) !=
            cudaSuccess) {
      return static_cast<int>(err);
    }
    const long long needed = (static_cast<long long>(b) + BLOCK_THREADS - 1) / BLOCK_THREADS;
    const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(needed < fit ? needed : fit);
    reg_tail_kernel<<<grid, BLOCK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row), static_cast<const int*>(valid), L, b,
        static_cast<const int*>(key_k), n_rows, n_acls, static_cast<unsigned*>(talk), depth,
        width_bits, static_cast<unsigned*>(hll), n_keys, hll_p, static_cast<unsigned*>(counts),
        global_counts, static_cast<unsigned*>(cnt), static_cast<long long*>(rep), slots, salt,
        sample_shift, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// cnt, rep: [slots] int64 (u32 counts; -1 where empty), slots a power of
// two <= 2^15; k <= slots candidates; acl, src, src_limbs, acl_tag: the
// step's [b] line columns as for ra_reg_tail; a sample index j names line
// (j << sample_shift) + phase (shift 0 and phase 0 when the whole batch
// was the sample); talk [depth, 2^width_bits] int64; outputs ca, cs, ce:
// [k] int64.  win_keys: [k] uint64 scratch and n_win: one int32 of
// scratch, used when k > the in-block ranking's cap (a second launch).
extern "C" int ra_select(const void* cnt, const void* rep, int slots, int k, const void* acl,
                         const void* const* src, int src_limbs, unsigned acl_tag,
                         int sample_shift, unsigned phase, const void* talk, int depth,
                         int width_bits, const unsigned* consts, int n_consts, void* ca,
                         void* cs, void* ce, void* win_keys, void* n_win, void* stream) {
  Consts c;
  Lines L;
  if (!load_consts(consts, n_consts, &c) || !load_lines(acl, src, src_limbs, acl_tag, &L) ||
      cnt == nullptr || rep == nullptr || slots < 1 || slots > (1 << SLOT_BITS) ||
      (slots & (slots - 1)) != 0 || k < 0 || k > slots || depth < 1 || depth > MAX_DEPTH ||
      width_bits < 1 || width_bits > 31 || sample_shift < 0 || sample_shift > 30 ||
      (k > SELECT_RANK_CAP && (win_keys == nullptr || n_win == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0) return static_cast<int>(cudaGetLastError());
  const Talk T{static_cast<const long long*>(talk), depth, width_bits, sample_shift, phase};
  const size_t smem = select_smem(slots);
  cudaError_t err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  select_kernel<<<1, SELECT_THREADS, smem, st>>>(
      static_cast<const long long*>(cnt), static_cast<const long long*>(rep), slots, k, L, T, c,
      static_cast<long long*>(ca), static_cast<long long*>(cs), static_cast<long long*>(ce),
      static_cast<unsigned long long*>(win_keys), static_cast<int*>(n_win));
  if (k > SELECT_RANK_CAP) {
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    select_rank_kernel<<<(k + RANK_THREADS - 1) / RANK_THREADS, RANK_THREADS, 0, st>>>(
        static_cast<const unsigned long long*>(win_keys), static_cast<const int*>(n_win), slots,
        static_cast<const long long*>(rep), L, T, c, static_cast<long long*>(ca),
        static_cast<long long*>(cs), static_cast<long long*>(ce));
  }
  return static_cast<int>(cudaGetLastError());
}

// The in-block ranking's cap on winners (above it, ra_select launches twice).
extern "C" int ra_select_rank_cap() { return SELECT_RANK_CAP; }

// Message of a CUDA error code (each kernel library exports one).
extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
