"""Streaming top-K talkers per ACL: talker CMS + per-chunk candidates.

Counterpart of the reference's ``ops/topk.py``.  On the device a
dedicated count-min sketch over (acl, src) pair hashes absorbs every
line, and per chunk a top-k over a chunk-local candidate table surfaces
the strongest candidates; on the host a small :class:`TopKTracker` folds
each chunk's candidates into a bounded per-ACL summary.  The per-chunk
update itself is ops/reg_tail.py's (a kernel on the card, its plain
version over this module's tables on the CPU).
"""

from __future__ import annotations

import torch

from ..stages import scope
from .cms import cms_query
from .hashing import fmix32, hash_pair

#: Chunk-local candidate table size.  Far larger than any realistic k, so
#: within one chunk a heavy hitter rarely loses its slot to a collision;
#: across chunks the slot hash is re-salted (see ``salt``).
CAND_SLOTS = 1 << 15


def cand_slot(pair: torch.Tensor, salt: int, slots: int) -> torch.Tensor:
    """Candidate-table slot of each (acl, src) pair hash."""
    return fmix32(pair ^ (int(salt) & 0xFFFFFFFF)) & (slots - 1)


def sample_cols(acl, src, valid, salt: int, sample_shift: int):
    """Salt-rotated strided sample of the batch (candidate SELECTION only).

    Degrades to the full batch when the batch is smaller than the stride.
    """
    if sample_shift and acl.shape[0] >= (1 << sample_shift):
        stride = 1 << sample_shift
        bs = (acl.shape[0] // stride) * stride
        phase = (int(salt) & 0xFFFFFFFF) % stride

        def col(x):
            return x[:bs].reshape(-1, stride)[:, phase].contiguous()

        return col(acl), col(src), col(valid)
    return acl, src, valid


def cand_k(k: int, b: int, sample_shift: int) -> int:
    """Candidate count after sampling: min(k, sampled length)."""
    if sample_shift and b >= (1 << sample_shift):
        return min(k, b >> sample_shift)
    return min(k, b)


def selects(salt: int, topk_every: int) -> bool:
    """Whether the chunk of this salt selects candidates (``--topk-every``)."""
    return topk_every <= 1 or (int(salt) & 0xFFFFFFFF) % topk_every == 0


def maybe_select(fn, salt: int, topk_every: int, k: int, device):
    """Run candidate-producing ``fn()`` on selection chunks only.

    ``topk_every > 1`` defers selection to chunks whose salt (the chunk
    counter) is a multiple of N; the talker CMS still absorbs every
    line.  A deferred chunk yields ``k`` zero candidates, which the host
    tracker ignores (est 0).  The reference branches with ``lax.cond`` on
    a device salt; the port's salt is a host int, so this is a host
    branch, and a resumed run replays the same schedule.
    """
    with scope("ra.topk"):
        if selects(salt, topk_every):
            return fn()
        z = torch.zeros(k, dtype=torch.int64, device=device)
        return z, z.clone(), z.clone()


def slot_rank_key(cnt: torch.Tensor) -> torch.Tensor:
    """The key ``torch.topk`` ranks candidate slots by (see select_from_tables)."""
    slots = cnt.shape[0]
    iota = torch.arange(slots, dtype=torch.int64, device=cnt.device)
    cnt_i32 = torch.where(cnt > 0x7FFFFFFF, cnt - (1 << 32), cnt)
    return cnt_i32 * (1 << 15) + (slots - 1 - iota)


def select_from_tables(cnt, rep, acl, src, talk_cms, k: int):
    """Top-k selection over an already-built candidate table.

    The reference ranks with ``lax.top_k(cnt.astype(int32), k)``, which
    puts the lower slot first among equal counts — and ties are the
    common case over 32768 slots.  ``torch.topk`` promises no tie order,
    so it ranks a key that is unique per slot instead
    (:func:`slot_rank_key`): the count in the high bits, the reversed
    slot index in the low 15.  Its order is the reference's order
    exactly.  The count is read as int32 like the reference's: a slot of
    weighted rows whose count reaches 2**31 ranks as negative and is
    masked out, there and here.  ``acl``/``src`` are the arrays ``rep``'s
    indices point into (the sample, when the chunk was sampled).
    """
    top_key, top_slot = torch.topk(slot_rank_key(cnt), k, sorted=True)
    top_cnt = top_key >> 15  # arithmetic: the int32 count back
    rep_idx = rep[top_slot]
    safe = rep_idx.clamp(min=0)
    ca, cs = acl[safe], src[safe]
    est = cms_query(talk_cms, hash_pair(ca, cs))
    ok = ((rep_idx >= 0) & (top_cnt > 0)).to(torch.int64)
    return ca * ok, cs * ok, est * ok


def candidate_tables(acl, src, valid, salt: int = 0, slots: int = CAND_SLOTS,
                     sample_shift: int = 0, pair=None):
    """The chunk-local candidate table: per-slot weight sum and representative.

    Over the salt-rotated sample (:func:`sample_cols`): ``cnt[slot]`` sums
    the weights (u32), ``rep[slot]`` is the largest sample index of a
    valid line (-1 where none).  Distinct pairs colliding in a slot: the
    pair whose LAST occurrence in the chunk is later holds the
    representative, exactly as in the reference.  ``pair`` is the full
    batch's ``hash_pair(acl, src)`` when the caller has it.
    """
    s_acl, s_src, s_valid = sample_cols(acl, src, valid, salt, sample_shift)
    if pair is None or s_acl is not acl:
        pair = hash_pair(s_acl, s_src)
    slot = cand_slot(pair, salt, slots)
    dev = acl.device
    cnt = torch.zeros(slots, dtype=torch.int64, device=dev)
    cnt.index_add_(0, slot, s_valid)
    iota = torch.arange(s_acl.shape[0], dtype=torch.int64, device=dev)
    rep = torch.full((slots,), -1, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, slot, torch.where(s_valid > 0, iota, -1), "amax")
    return cnt & 0xFFFFFFFF, rep


class TopKTracker:
    """Host-side bounded per-ACL talker summary fed by chunk candidates."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._tables: dict[int, dict[int, int]] = {}

    def offer(self, acl: int, src: int, est: int) -> None:
        if est <= 0:
            return
        t = self._tables.setdefault(acl, {})
        if src in t:
            t[src] = max(t[src], est)
            return
        if len(t) < self.capacity:
            t[src] = est
            return
        victim = min(t, key=t.get)
        if est > t[victim]:
            del t[victim]
            t[src] = est

    def offer_chunk(self, cand_acl, cand_src, cand_est) -> None:
        for a, s, e in zip(cand_acl.tolist(), cand_src.tolist(), cand_est.tolist()):
            self.offer(int(a), int(s), int(e))

    def top(self, acl: int, k: int) -> list[tuple[int, int]]:
        t = self._tables.get(acl, {})
        # canonical tie order (estimate desc, then source asc): candidate
        # ARRIVAL order varies with the mesh world size (per-device top-k
        # slices), and reports must render identically across scale
        # events for the autoscale bit-identity law
        return sorted(t.items(), key=lambda kv: (-kv[1], kv[0]))[:k]

    def acls(self) -> list[int]:
        return list(self._tables)

    def tables(self) -> dict[int, dict[int, int]]:
        """Snapshot-serializable view of the per-ACL summaries."""
        return {acl: dict(t) for acl, t in self._tables.items()}
