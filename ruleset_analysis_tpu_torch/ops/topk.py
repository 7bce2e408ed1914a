"""Streaming top-K talkers per ACL: talker CMS + per-chunk candidates.

Counterpart of the reference's ``ops/topk.py``.  On the device a
dedicated count-min sketch over (acl, src) pair hashes absorbs every
line, and per chunk a top-k over a chunk-local candidate table surfaces
the strongest candidates; on the host a small :class:`TopKTracker` folds
each chunk's candidates into a bounded per-ACL summary.
"""

from __future__ import annotations

import torch

from .cms import cms_query, cms_update
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


def select_from_tables(cnt, rep, acl, src, talk_cms, k: int):
    """Top-k selection over an already-built candidate table.

    The reference ranks with ``lax.top_k(cnt.astype(int32), k)``, which
    puts the lower slot first among equal counts — and ties are the
    common case over 32768 slots.  ``torch.topk`` promises no tie order,
    so it ranks a key that is unique per slot instead: the count in the
    high bits, the reversed slot index in the low 15.  Its order is the
    reference's order exactly.
    """
    slots = cnt.shape[0]
    iota = torch.arange(slots, dtype=torch.int64, device=cnt.device)
    key = (cnt << 15) | (slots - 1 - iota)
    top_key, top_slot = torch.topk(key, k, sorted=True)
    top_cnt = top_key >> 15
    rep_idx = rep[top_slot]
    safe = rep_idx.clamp(min=0)
    ca, cs = acl[safe], src[safe]
    est = cms_query(talk_cms, hash_pair(ca, cs))
    ok = ((rep_idx >= 0) & (top_cnt > 0)).to(torch.int64)
    return ca * ok, cs * ok, est * ok


def select_candidates(talk_cms, acl, src, valid, k, slots: int = CAND_SLOTS,
                      salt: int = 0, sample_shift: int = 0):
    """Top-k distinct (acl, src) candidates of this chunk.

    Pairs hash into a ``slots``-sized chunk-local table with two scatters
    — per-slot frequency (add) and a representative line index (max) —
    and the top-k runs over the small table, not the batch.  Distinct
    pairs colliding in a slot: the pair whose LAST occurrence in the chunk
    is later holds the representative, exactly as in the reference.
    """
    acl, src, valid = sample_cols(acl, src, valid, salt, sample_shift)
    k = min(k, acl.shape[0])
    b = acl.shape[0]
    pair = hash_pair(acl, src)
    slot = cand_slot(pair, salt, slots)
    dev = acl.device
    cnt = torch.zeros(slots, dtype=torch.int64, device=dev)
    cnt.index_add_(0, slot, valid)
    iota = torch.arange(b, dtype=torch.int64, device=dev)
    rep = torch.full((slots,), -1, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, slot, torch.where(valid > 0, iota, -1), "amax")
    return select_from_tables(cnt & 0xFFFFFFFF, rep, acl, src, talk_cms, k)


def talker_chunk_update(
    talk_cms: torch.Tensor,
    acl: torch.Tensor,
    src: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    salt: int = 0,
    sample_shift: int = 0,
):
    """Absorb one chunk; return (cms, cand_acl, cand_src, cand_est).

    ``talk_cms`` is updated in place.  The candidate estimates are
    post-update global CMS estimates, masked to 0 for suppressed/empty
    slots so they can never displace real candidates.  ``salt`` (the
    chunk counter) re-randomizes the candidate table's slot assignment.
    """
    pair = hash_pair(acl, src)
    new_cms = cms_update(talk_cms, pair, valid)
    k1 = min(k, acl.shape[0])
    cand = select_candidates(
        new_cms, acl, src, valid, k1, salt=salt, sample_shift=sample_shift
    )
    return (new_cms, *cand)


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
