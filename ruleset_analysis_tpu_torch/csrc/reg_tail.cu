// reg_tail: the register tail of the analysis step as hand-written Hopper
// kernels.
//
// Replaces the scatter branch of the reference's register tail,
// ruleset_analysis_tpu/parallel/step.py _merge_tail (XLA there; its
// single-device form is models/pipeline.py _update_registers): per line,
// the count key of the match kernel's row (ops/match.py rows_to_keys), the
// talker-CMS add at one multiply-shift bucket of hash_pair(acl, src) per
// depth row, the HLL max of the source's rank into hll[key * m + reg], the
// exact counts' per-key add (when the match kernel did not build the
// delta), and on a selecting chunk the candidate table's per-slot weight
// sum (cnt) and largest sampled line index (rep).  reg_tail_pick is the
// gather after the top-k over that table (ops/topk.py select_from_tables:
// each candidate's (acl, src), its post-update talker-CMS estimate, and
// the empty-slot mask).
//
// Both read the batch as the match kernels do: the match kernel's int32
// row and the batch's int32 columns (u32 bits), no widened copies.  A v6
// line's source is its four address limbs, folded here as
// ops/match6.py fold_src32 does, and its talker gid carries acl_tag.
//
// What bounds it on the H100: bytes.  A v4 line reads four int32 words
// (16 B; a v6 line 28) and costs ~90 integer operations of hashing and
// five atomics, below the card's ~5 INT32 operations per byte of memory
// bandwidth; the registers it touches are small (the 16x256 HLL file,
// 8.4 MB in int64, is the largest) and stay in the 50 MB L2, where the
// atomics run.  Under skewed traffic a heavy talker sends all of its lines
// to the same CMS cells and slot, and those atomics serialise in L2.
//
// What the design does about it: the torch tail ran each u32 hash as a
// chain of ~20-45 int64 elementwise ops over the batch, each reading and
// writing 8 MB at B = 2^20 (~490 launches a step).  Here one thread takes
// one line, every hash is native uint32 arithmetic in registers, and each
// register update is one global atomic.  The registers hold u32 values in
// int64 words with a zero high word, so a 32-bit atomicAdd on the low word
// is the reference's wrapping u32 add (no masking pass afterwards), and a
// 32-bit atomicMax on it is the HLL max.  An HLL cell is read first and the
// atomic skipped when it already holds the rank (cells only grow during a
// launch, so a stale read can only cause an atomic, never skip one).  rep
// holds -1 for an empty slot, so it takes a 64-bit signed atomicMax.
//
// The hash constants come from Python (ops/reg_tail.py TAIL_CONSTANTS,
// from ops/hashing.py, ops/hll.py and ops/match6.py) at every launch; this
// file holds none of its own.
//
// Plain C interface, loaded with ctypes (ops/_build.py); every function
// returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_THREADS = 256;
constexpr int MAX_DEPTH = 8;  // config.MAX_CMS_DEPTH
constexpr int FOLD_LIMBS = 4;  // a v6 source's u32 limbs
// ops/reg_tail.py TAIL_CONSTANTS: the seven scalars, the four limb-fold
// multipliers, then MAX_DEPTH multiply-shift constants
constexpr int N_CONSTS = 7 + FOLD_LIMBS + MAX_DEPTH;

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

__global__ void __launch_bounds__(BLOCK_THREADS)
reg_tail_kernel(const int* __restrict__ row, const int* __restrict__ valid, Lines L, int b,
                const int* __restrict__ key_k, int n_rows, int n_acls,
                unsigned* __restrict__ talk, int depth, int width_bits,
                unsigned* __restrict__ hll, int n_keys, int hll_p,
                unsigned* __restrict__ counts, unsigned* __restrict__ cnt,
                long long* __restrict__ rep, int slots, unsigned salt, int sample_shift,
                Consts c) {
  const int i = blockIdx.x * BLOCK_THREADS + threadIdx.x;
  if (i >= b) return;
  const unsigned w = static_cast<unsigned>(valid[i]);
  if (w == 0) return;  // an invalid line changes no register and no slot
  const unsigned a = static_cast<unsigned>(L.acl[i]);
  const unsigned s = line_src(L, i, c);
  const unsigned pair = hash_pair(a | L.acl_tag, s, c);
  // talker CMS: ops/cms.py cms_bucket of the pair (mix, then multiply-shift)
  const unsigned mixed = fmix32(pair, 0u, c);
  const long long width = 1ll << width_bits;
  for (int d = 0; d < depth; ++d) {
    const unsigned bucket = (mixed * c.ms[d]) >> (32 - width_bits);
    atomicAdd(lo_word(talk, d * width + bucket), w);
  }
  // rows_to_keys: a matched row's rule key, else the line's ACL's deny
  // key (ids past the last ACL clamp onto it); key_k is the row keys, then
  // the deny keys.  A row past the table has no key.
  const int r = row[i];
  const unsigned key = r < 0 ? static_cast<unsigned>(key_k[n_rows + min(a, n_acls - 1u)])
                       : r < n_rows ? static_cast<unsigned>(key_k[r])
                                    : 0xFFFFFFFFu;
  if (key < static_cast<unsigned>(n_keys)) {  // out-of-range keys are dropped
    if (counts != nullptr) atomicAdd(lo_word(counts, key), w);
    // ops/hll.py hll_reg_rank: register from the high p bits, rank 1..33
    const unsigned reg = fmix32(s, c.hll_seed_idx, c) >> (32 - hll_p);
    const unsigned rank = __clz(fmix32(s, c.hll_seed_rank, c)) + 1;
    unsigned* cell = lo_word(hll, (static_cast<long long>(key) << hll_p) + reg);
    if (*cell < rank) atomicMax(cell, rank);
  }
  if (cnt != nullptr) {
    // ops/topk.py sample_cols: the salt-rotated stride sample, when the
    // batch holds at least one stride
    int j = i;
    if (sample_shift > 0 && b >= (1 << sample_shift)) {
      const int stride_mask = (1 << sample_shift) - 1;
      const int bs = (b >> sample_shift) << sample_shift;
      if (i >= bs || (i & stride_mask) != static_cast<int>(salt & stride_mask)) return;
      j = i >> sample_shift;
    }
    const unsigned slot = fmix32(pair ^ salt, 0u, c) & static_cast<unsigned>(slots - 1);
    atomicAdd(lo_word(cnt, slot), w);
    atomicMax(&rep[slot], static_cast<long long>(j));
  }
}

__global__ void reg_tail_pick_kernel(const long long* __restrict__ top_key,
                                     const long long* __restrict__ top_slot, int k,
                                     const long long* __restrict__ rep, Lines L,
                                     int sample_shift, unsigned phase,
                                     const long long* __restrict__ talk, int depth,
                                     int width_bits, Consts c, long long* __restrict__ ca,
                                     long long* __restrict__ cs, long long* __restrict__ ce) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  const long long count = top_key[t] >> 15;  // the int32 slot count (arithmetic shift)
  const long long r = rep[top_slot[t]];
  const long long safe = r < 0 ? 0 : r;
  // rep holds sample indices; line = sample index * stride + phase
  const long long line = (safe << sample_shift) + phase;
  const unsigned a = line_acl(L, line);
  const unsigned s = line_src(L, line, c);
  const unsigned mixed = fmix32(hash_pair(a, s, c), 0u, c);
  const long long width = 1ll << width_bits;
  long long est = 0;
  for (int d = 0; d < depth; ++d) {
    const long long v = talk[d * width + ((mixed * c.ms[d]) >> (32 - width_bits))];
    est = d == 0 || v < est ? v : est;
  }
  const bool ok = r >= 0 && count > 0;
  ca[t] = ok ? a : 0;
  cs[t] = ok ? s : 0;
  ce[t] = ok ? est : 0;
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

}  // namespace

// row: [b] int32 match-kernel rows (-1 = no match); valid, acl: [b] int32
// (u32 bits; valid is the weight plane); src: host array of src_limbs
// (1 or 4) pointers to [b] int32 columns; acl_tag: ORed onto the talker
// gid.  key_k: [n_rows + n_acls] int32, each row's count key then each
// ACL's deny key.  talk [depth, 2^width_bits], hll [n_keys, 2^hll_p],
// counts [n_keys] and cnt [slots]: int64 registers holding u32 values,
// updated in place; counts, cnt and rep may be null (no counts delta / no
// selection); rep [slots] int64, -1 where empty.  consts: host array of
// N_CONSTS u32.
extern "C" int ra_reg_tail(const void* row, const void* valid, const void* acl,
                           const void* const* src, int src_limbs, unsigned acl_tag, int b,
                           const void* key_k, int n_rows, int n_acls, void* talk, int depth,
                           int width_bits, void* hll, int n_keys, int hll_p, void* counts,
                           void* cnt, void* rep, int slots, unsigned salt, int sample_shift,
                           const unsigned* consts, int n_consts, void* stream) {
  Consts c;
  Lines L;
  if (!load_consts(consts, n_consts, &c) || !load_lines(acl, src, src_limbs, acl_tag, &L) ||
      row == nullptr || valid == nullptr || key_k == nullptr || n_rows < 0 || n_acls < 1 ||
      depth < 1 || depth > MAX_DEPTH || width_bits < 1 || width_bits > 31 || hll_p < 1 ||
      hll_p > 16 || n_keys < 0 ||
      (cnt != nullptr && (slots < 1 || (slots & (slots - 1)) != 0)) || sample_shift < 0 ||
      sample_shift > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b > 0) {
    const int grid = (b + BLOCK_THREADS - 1) / BLOCK_THREADS;
    reg_tail_kernel<<<grid, BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row), static_cast<const int*>(valid), L, b,
        static_cast<const int*>(key_k), n_rows, n_acls, static_cast<unsigned*>(talk), depth,
        width_bits, static_cast<unsigned*>(hll), n_keys, hll_p, static_cast<unsigned*>(counts),
        static_cast<unsigned*>(cnt), static_cast<long long*>(rep), slots, salt, sample_shift,
        c);
  }
  return static_cast<int>(cudaGetLastError());
}

// top_key, top_slot: [k] int64 (torch.topk of the slot ranking key);
// rep [slots] int64; acl, src, src_limbs, acl_tag: the step's [b] line
// columns as for ra_reg_tail; a sample index j names line
// (j << sample_shift) + phase (shift 0 and phase 0 when the whole batch
// was the sample); talk [depth, 2^width_bits] int64; outputs ca, cs, ce:
// [k] int64.
extern "C" int ra_reg_tail_pick(const void* top_key, const void* top_slot, int k,
                                const void* rep, const void* acl, const void* const* src,
                                int src_limbs, unsigned acl_tag, int sample_shift,
                                unsigned phase, const void* talk, int depth, int width_bits,
                                const unsigned* consts, int n_consts, void* ca, void* cs,
                                void* ce, void* stream) {
  Consts c;
  Lines L;
  if (!load_consts(consts, n_consts, &c) || !load_lines(acl, src, src_limbs, acl_tag, &L) ||
      depth < 1 || depth > MAX_DEPTH || width_bits < 1 || width_bits > 31 ||
      sample_shift < 0 || sample_shift > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k > 0) {
    const int threads = 128;
    reg_tail_pick_kernel<<<(k + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(top_key), static_cast<const long long*>(top_slot), k,
        static_cast<const long long*>(rep), L, sample_shift, phase,
        static_cast<const long long*>(talk), depth, width_bits, c,
        static_cast<long long*>(ca), static_cast<long long*>(cs), static_cast<long long*>(ce));
  }
  return static_cast<int>(cudaGetLastError());
}

// Message of a CUDA error code (each kernel library exports one).
extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
