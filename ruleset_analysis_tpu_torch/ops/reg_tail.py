"""Kernels 4 and 5, ``reg_tail`` and the select: the step's register tail on the GPU.

Counterpart of the scatter branch of the reference's register tail
(``parallel/step.py _merge_tail``, single-device form
``models/pipeline.py _update_registers``) and of its talker top-k
(``ops/topk.py select_from_tables``), which XLA fuses on the reference's
chip and plain torch runs as ~490 elementwise launches a step.  The
kernels are in ``csrc/reg_tail.cu`` (CUDA C++ for sm_90a, built by
ops/_build.py):

- :func:`reg_tail`: one launch over the batch that maps each match row
  to its count key, updates the talker CMS and the HLL file in place and
  builds, as asked, the per-key counts delta and the chunk's candidate
  table (``cnt``, ``rep``).  A warp's lines with the same pair, HLL cell
  or key make one update; the counts delta sums in a block-private
  shared-memory histogram, or with global atomics where it does not fit
  (:func:`uses_global_counts`);
- :func:`select_tables`: one launch (two above
  :func:`select_rank_cap` winners) that ranks the candidate table as
  ``torch.topk`` of :func:`~.topk.slot_rank_key` would and gathers each
  candidate, its talker-CMS estimate and the empty-slot mask.

Both take the batch as the match kernels do: the match kernel's int32
rows and the batch's int32 line columns (u32 bits).  A v4 line's source
is one column; a v6 line's is its four address limbs, which the kernels
fold as :func:`~.match6.fold_src32` does, and its talker gid carries
``acl_tag``.  Beside each, :func:`reg_tail_plain` and
:func:`select_tables_plain` are the same functions in plain torch (the
ops of ops/cms.py, hll.py, counts.py and topk.py over int64 u32
values); the wrappers run them for tensors on the CPU and the kernels
for tensors on a CUDA device, never falling back from one to the other.

The kernels hold no hash constant of their own: :data:`TAIL_CONSTANTS`
passes them at every launch, from the modules the plain versions use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..stages import note_kernel, scope
from . import _build
from . import counts as count_ops
from . import hll as hll_ops
from .cms import cms_update
from .hashing import (FMIX_C1, FMIX_C2, M32, MS_CONSTANTS, PAIR_MUL, PAIR_SEED_STEP, hash_pair,
                      u32_of)
from .match6 import FOLD_CONSTANTS, fold_src32
from .topk import CAND_SLOTS, candidate_tables, select_from_tables

#: The kernels' hash constants, in csrc/reg_tail.cu's ``Consts`` order:
#: fmix32's two multipliers, hash_pair's stream multiplier, its two seeds
#: (seed 0, then seed + PAIR_SEED_STEP), the HLL index and rank seeds,
#: fold_src32's four limb multipliers, and the eight multiply-shift
#: constants of the CMS rows.
TAIL_CONSTANTS = (
    FMIX_C1, FMIX_C2, PAIR_MUL, 0, PAIR_SEED_STEP,
    hll_ops._HLL_SEED_IDX, hll_ops._HLL_SEED_RANK,
    *FOLD_CONSTANTS,
    *(int(c) for c in MS_CONSTANTS),
)
_CONSTS = (ctypes.c_uint * len(TAIL_CONSTANTS))(*TAIL_CONSTANTS)


@functools.lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """Bytes of dynamic shared memory a reg_tail block can have."""
    lib = _build.library("reg_tail")
    out = ctypes.c_int(0)
    _build.check(lib, lib.ra_reg_tail_smem_limit(device_index, ctypes.byref(out)),
                 "reg_tail shared-memory query")
    return out.value


def uses_global_counts(n_keys: int, device_index: int) -> bool:
    """True when the counts histogram ([n_keys] u32) cannot fit one block's
    shared memory: the kernel then adds the counts straight to the global
    delta with atomics."""
    return 4 * n_keys > smem_limit(device_index)


@functools.lru_cache(maxsize=None)
def select_rank_cap() -> int:
    """Winners the select kernel ranks inside its one block; above it the
    select launches a second kernel that ranks over many blocks."""
    return int(_build.library("reg_tail").ra_select_rank_cap())


def key_table(rules_key: torch.Tensor, n_rows: int, deny_key: torch.Tensor) -> torch.Tensor:
    """The kernels' ``[n_rows + A]`` int32 key table: each match row's count
    key (``rules_key``; past its end, the kernel's padding rows, no key:
    0xFFFFFFFF, as ops/match_hist.py counts_from_hists drops them), then
    each ACL's deny key."""
    keys = torch.full((n_rows + deny_key.shape[0],), M32, dtype=torch.int64,
                      device=deny_key.device)
    keys[:rules_key.shape[0]] = rules_key
    keys[n_rows:] = deny_key
    return torch.where(keys > 0x7FFFFFFF, keys - (1 << 32), keys).to(torch.int32).contiguous()


def line_keys(row: torch.Tensor, acl: torch.Tensor, key_k: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """[B] int64 count keys (u32) of the match rows: ops/match.py
    rows_to_keys over :func:`key_table`.  A row past the table has no key
    (0xFFFFFFFF, dropped), as in the kernel."""
    keys = u32_of(key_k)
    r = row.to(torch.int64)
    deny = keys[n_rows + torch.clamp(u32_of(acl), max=keys.shape[0] - n_rows - 1)]
    matched = keys[torch.clamp(r, 0, max(n_rows - 1, 0))] if n_rows else deny
    return torch.where(r < 0, deny, torch.where(r < n_rows, matched, M32))


def line_ids(acl: torch.Tensor, src, acl_tag: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """([B] talker gids, [B] source identities), int64 u32: the acl column
    tagged with ``acl_tag``, and the source column or the fold of the four
    v6 limbs."""
    if len(src) == 1:
        s = u32_of(src[0])
    else:
        s = fold_src32({f"src{i}": u32_of(x) for i, x in enumerate(src)})
    return u32_of(acl) | acl_tag, s


def _log2(n: int, what: str) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two >= 2, got {n}")
    return n.bit_length() - 1


def _check(tensors: dict, b: int, dev: torch.device, dtype=torch.int32) -> None:
    for name, t in tensors.items():
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if b >= 0 and (t.dim() != 1 or t.shape[0] != b):
            raise ValueError(f"{name} must be [{b}], got {tuple(t.shape)}")


def _check_lines(acl, src, b: int, dev) -> tuple:
    src = tuple(src)
    if len(src) not in (1, len(FOLD_CONSTANTS)):
        raise ValueError(f"src must be 1 or {len(FOLD_CONSTANTS)} columns, got {len(src)}")
    _check({"acl": acl, **{f"src{i}": s for i, s in enumerate(src)}}, b, dev)
    return src


def _src_ptrs(src) -> ctypes.Array:
    return (ctypes.c_void_p * len(src))(*(s.data_ptr() for s in src))


def _sample(b: int, salt: int, sample_shift: int) -> tuple[int, int]:
    """(shift, phase) mapping a sample index j to line (j << shift) + phase."""
    if sample_shift and b >= (1 << sample_shift):
        return sample_shift, (int(salt) & M32) % (1 << sample_shift)
    return 0, 0


def reg_tail_plain(talk_cms, hll, row, valid, acl, src, key_k, *, n_rows: int,
                   acl_tag: int = 0, counts: bool, salt: int = 0, sample_shift: int = 0,
                   select: bool = True, slots: int = CAND_SLOTS):
    """Plain torch version of :func:`reg_tail` (same inputs, same outputs)."""
    keys = line_keys(row, acl, key_k, n_rows)
    w = u32_of(valid)
    a, s = line_ids(acl, src, acl_tag)
    pair = hash_pair(a, s)
    cms_update(talk_cms, pair, w)
    hll_ops.hll_update(hll, keys, s, w)
    delta = count_ops.segment_counts(keys, w, hll.shape[0]) if counts else None
    cnt = rep = None
    if select:
        cnt, rep = candidate_tables(a, s, w, salt, slots, sample_shift, pair=pair)
    return delta, cnt, rep


def reg_tail(talk_cms, hll, row, valid, acl, src, key_k, *, n_rows: int, acl_tag: int = 0,
             counts: bool, salt: int = 0, sample_shift: int = 0, select: bool = True,
             slots: int = CAND_SLOTS, force_global: bool = False):
    """Register tail of one batch: returns ``(counts_delta, cnt, rep)``.

    ``talk_cms`` ([depth, width]) and ``hll`` ([n_keys, m]) take the
    batch in place.  ``counts_delta`` ([n_keys], or None unless
    ``counts``) sums each in-range key's weights; ``cnt``/``rep``
    ([slots], or None unless ``select``) are the candidate table over the
    salt-rotated sample.  ``row`` (the match kernel's rows, -1 where none
    matched), ``valid`` (the weight plane) and ``acl`` are [B] int32;
    ``src`` is a sequence of one [B] int32 column, or the four limbs of v6
    sources; ``key_k`` is :func:`key_table` over ``n_rows`` match rows.
    ``force_global`` selects the kernel's global-atomic counts mode even
    where the histogram fits shared memory (for testing that mode).
    """
    b = row.shape[0]
    dev = row.device
    src = _check_lines(acl, src, b, dev)
    _check({"row": row, "valid": valid}, b, dev)
    _check({"key_k": key_k}, -1, dev)
    _check({"talk_cms": talk_cms, "hll": hll}, -1, dev, torch.int64)
    depth, width = talk_cms.shape
    n_keys, m = hll.shape
    width_bits, hll_p = _log2(width, "talker CMS width"), _log2(m, "HLL register count")
    _log2(slots, "candidate slots")
    n_acls = key_k.shape[0] - n_rows
    if key_k.dim() != 1 or n_rows < 0 or n_acls < 1:
        raise ValueError(f"key_k must be [n_rows + n_acls] with n_acls >= 1, got "
                         f"{tuple(key_k.shape)} for {n_rows} rows")
    if b >= 1 << 31:
        raise ValueError(f"batch of {b} lines exceeds the kernel's int range")
    if n_keys << hll_p > 1 << 32:
        raise ValueError(f"{n_keys} keys x {m} HLL registers exceed the kernel's u32 cell index")
    with scope("ra.talk"):
        note_kernel("reg_tail_kernel")
        if dev.type == "cpu":
            return reg_tail_plain(talk_cms, hll, row, valid, acl, src, key_k, n_rows=n_rows,
                                  acl_tag=acl_tag, counts=counts, salt=salt,
                                  sample_shift=sample_shift, select=select, slots=slots)
        delta = torch.zeros(n_keys, dtype=torch.int64, device=dev) if counts else None
        cnt = torch.zeros(slots, dtype=torch.int64, device=dev) if select else None
        rep = torch.full((slots,), -1, dtype=torch.int64, device=dev) if select else None
        lib = _build.library("reg_tail")
        with torch.cuda.device(dev):
            glob = counts and (force_global
                               or uses_global_counts(n_keys, torch.cuda.current_device()))
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ra_reg_tail(
                row.data_ptr(), valid.data_ptr(), acl.data_ptr(), _src_ptrs(src), len(src),
                acl_tag, b, key_k.data_ptr(), n_rows, n_acls, talk_cms.data_ptr(), depth,
                width_bits, hll.data_ptr(), n_keys, hll_p, delta.data_ptr() if counts else None,
                int(glob), cnt.data_ptr() if select else None,
                rep.data_ptr() if select else None, slots, int(salt) & M32, sample_shift,
                _CONSTS, len(TAIL_CONSTANTS), stream,
            )
    _build.check(lib, rc, "reg_tail launch")
    reg_tail.launches += 1
    return delta, cnt, rep


#: launches of the reg_tail kernel in this process
reg_tail.launches = 0


def select_tables_plain(cnt, rep, acl, src, talk_cms, k: int, *, acl_tag: int = 0,
                        salt: int = 0, sample_shift: int = 0):
    """Plain torch version of :func:`select_tables`: ops/topk.select_from_tables
    over the sample ``rep`` points into."""
    shift, phase = _sample(acl.shape[0], salt, sample_shift)
    n = acl.shape[0] >> shift
    a, s = line_ids(acl, src, acl_tag)
    return select_from_tables(cnt, rep, a[phase::1 << shift][:n], s[phase::1 << shift][:n],
                              talk_cms, k)


def select_tables(cnt, rep, acl, src, talk_cms, k: int, *, acl_tag: int = 0, salt: int = 0,
                  sample_shift: int = 0):
    """Top-k candidates ``(cand_acl, cand_src, cand_est)`` of a candidate table.

    ``cnt``/``rep`` come from :func:`reg_tail` with the same ``salt`` and
    ``sample_shift`` (``cnt`` holds u32 counts, ranked as int32 like the
    reference's); ``acl``/``src``/``acl_tag`` are the step's line columns
    as :func:`reg_tail` took them; ``talk_cms`` is the post-update talker
    CMS.  ``k`` is at most the table's slots, which are at most
    :data:`~.topk.CAND_SLOTS` on the card.
    """
    b = acl.shape[0]
    dev = acl.device
    src = _check_lines(acl, src, b, dev)
    slots = cnt.shape[0]
    _check({"cnt": cnt, "rep": rep}, slots, dev, torch.int64)
    _check({"talk_cms": talk_cms}, -1, dev, torch.int64)
    if not 0 <= k <= slots:
        raise ValueError(f"k must be in 0..{slots} (the table's slots), got {k}")
    with scope("ra.topk"):
        if dev.type == "cpu":
            note_kernel("select_kernel")
            return select_tables_plain(cnt, rep, acl, src, talk_cms, k, acl_tag=acl_tag,
                                       salt=salt, sample_shift=sample_shift)
        if slots > CAND_SLOTS:
            raise ValueError(f"the select kernel ranks at most {CAND_SLOTS} slots, got {slots}")
        depth, width = talk_cms.shape
        width_bits = _log2(width, "talker CMS width")
        shift, phase = _sample(b, salt, sample_shift)
        out = torch.empty((3, k), dtype=torch.int64, device=dev)
        if k == 0:
            return out[0], out[1], out[2]
        lib = _build.library("reg_tail")
        # the second launch's scratch: the winners' rank keys and their number
        scratch = (torch.empty(k + 1, dtype=torch.int64, device=dev) if k > select_rank_cap()
                   else None)
        note_kernel("select_kernel")
        if scratch is not None:
            note_kernel("select_rank_kernel")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ra_select(
                cnt.data_ptr(), rep.data_ptr(), slots, k, acl.data_ptr(), _src_ptrs(src),
                len(src), acl_tag, shift, phase, talk_cms.data_ptr(), depth, width_bits,
                _CONSTS, len(TAIL_CONSTANTS), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), None if scratch is None else scratch.data_ptr(),
                None if scratch is None else scratch[k:].data_ptr(), stream,
            )
    _build.check(lib, rc, "select launch")
    select_tables.launches += 1
    return out[0], out[1], out[2]


#: launches of the select kernel (one C call: one launch, or two above
#: select_rank_cap winners) in this process
select_tables.launches = 0
