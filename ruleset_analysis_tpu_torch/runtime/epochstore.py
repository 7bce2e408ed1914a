"""Durable epoch store with segment-tree range merges.

Counterpart of the reference's ``runtime/epochstore.py``, whose on-disk
format it keeps: either package opens the other's store.  The window ring
answers "last K windows" and forgets anything older; the deletion question
the system exists for ("was this rule used in the last 90 days, and when
did it last hit?") needs history.  The register merge laws (add64 counts,
wrap-add32 CMS and talker planes, max HLL: serve.merge_register_arrays)
are associative and commutative, which is the license a segment tree
needs: any grouping of the same epochs folds to the same bits.

- **Level-0 chain.**  Every rotated window spills here as one CRC'd
  record (the ``RAEP1`` epoch frame of parallel/distributed.py) in an
  :class:`EpochStoreLog`: the WAL's segment discipline (magic plus
  ``u32 len | u32 crc`` framing, O_APPEND durability, torn-tail clip,
  quarantine-and-continue) under a store-private magic.  Level-0 seq
  ``s`` is window ``base + s``, so every gap is attributable by
  arithmetic alone.

- **Summary levels.**  A binary-counter compactor: whenever level ``k``
  reaches an even node count, its last aligned pair merges into one
  level-``k+1`` node spanning ``2^(k+1)`` windows.  Compaction only
  appends the new node (the append is the link: a torn tail is clipped at
  open, a missing parent is rebuilt from its children), so a kill
  mid-compaction leaves a readable store with no lost epoch.  A pair that
  must not merge (a key-space migration inside the span, a damaged child)
  appends a typed **hole** node: numbering stays dense and queries fall
  through to finer levels.

- **Range queries.**  ``[t0, t1]`` decomposes greedily into at most
  ``2 * log2(n)`` aligned stored aggregates and one merge fold,
  bit-identical to the linear fold over the raw epochs.  A range the store
  cannot cover completely returns a typed ``range_incomplete`` marker
  (reason and first missing window), never a partial report.

- **Last-hit and trend planes.**  Each spill updates a per-rule last-hit
  map (window id and wall time of the last window with nonzero hits) and
  diffs adjacent epochs through report.trend_events for
  ``rule_burst``/``rule_quiet`` rows at store granularity.

The store keeps the registers in their numpy dtypes (u32 planes), never
the int64 the torch paths carry u32 values in, so its node bytes and its
folds are the reference's.  Wired by ``serve --epoch-store DIR``
(runtime/serve.py: a spill at every rotation, HTTP ``/report/range`` and
``/report/last-hit``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import threading
from collections import deque

import numpy as np

from ..errors import AnalysisError
from . import faults
from .wal import WriteAheadLog

#: store-private segment magic: a store chain must never replay as an
#: ingest WAL or an epoch spool (and vice versa)
STORE_MAGIC = b"RAESTOR1"
_LEVEL_RE = re.compile(r"^L(\d{2})$")
#: in-memory tail of store-granularity trend events served on
#: ``/report/last-hit`` (bounded: this is a view, not a ledger)
TREND_TAIL = 256


def _atomic_write_json(path: str, obj) -> None:
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def range_incomplete(lo, hi, reason: str, window=None) -> dict:
    """The typed refusal a partial range answer must become.

    ``reason`` ∈ empty_range / empty_store / beyond_frontier /
    keyspace_migration / missing (evicted, quarantined or hole);
    ``window`` pins the first window the store could not produce.
    """
    m: dict = {"range_incomplete": True, "from": lo, "to": hi,
               "reason": reason}
    if window is not None:
        m["window"] = int(window)
    return m


class EpochStoreLog(WriteAheadLog):
    """One level's append-only node chain (the WAL discipline verbatim:
    O_APPEND records, CRC quarantine, torn-tail clip, seq-gap math).
    Node seq within level ``k`` is implicit: node ``j`` spans windows
    ``[base + j*2^k, base + (j+1)*2^k)``."""

    _MAGICS = (STORE_MAGIC,)
    _WRITE_MAGIC = STORE_MAGIC
    #: one node carries a full register image (counts/CMS/HLL planes)
    _MAX_RECORD = 256 << 20

    @classmethod
    def _decode_record(cls, payload: bytes, magic: bytes) -> tuple:
        return (payload,)


# ---------------------------------------------------------------------------
# Aggregates: the unit compaction merges and queries fold.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EpochAgg:
    """One stored node: register image + accounting over ``span``.

    ``tables`` keeps the UNBOUNDED per-(acl, src) talker estimates
    (max-deduped — the same law TopKTracker.offer applies) rather than a
    capacity-bound tracker: bounded trackers evict order-dependently, so
    only the unbounded table keeps range folds grouping-independent.
    """

    span: tuple[int, int]  # [lo, hi) window ids
    arrays: dict[str, np.ndarray]
    summary: dict
    tables: dict[int, dict[int, int]]
    quarantine: dict[tuple, int]


def _summary_from_meta(meta: dict) -> dict:
    s = {
        "windows": 1,
        "lines": int(meta.get("lines", 0)),
        "parsed": int(meta.get("parsed", 0)),
        "skipped": int(meta.get("skipped", 0)),
        "chunks": int(meta.get("chunks", 0)),
        "drops": int(meta.get("drops", 0)),
        "started_unix": float(meta.get("started_unix") or 0.0),
        "ended_unix": float(meta.get("ended_unix") or 0.0),
        "incomplete": [int(meta["id"])] if meta.get("incomplete") else [],
    }
    return s


def _merge_summaries(a: dict, b: dict) -> dict:
    return {
        "windows": a["windows"] + b["windows"],
        "lines": a["lines"] + b["lines"],
        "parsed": a["parsed"] + b["parsed"],
        "skipped": a["skipped"] + b["skipped"],
        "chunks": a["chunks"] + b["chunks"],
        "drops": a["drops"] + b["drops"],
        "started_unix": min(a["started_unix"], b["started_unix"]),
        "ended_unix": max(a["ended_unix"], b["ended_unix"]),
        "incomplete": a["incomplete"] + b["incomplete"],
    }


def _merge_tables(
    a: dict[int, dict[int, int]], b: dict[int, dict[int, int]]
) -> dict[int, dict[int, int]]:
    out = {acl: dict(t) for acl, t in a.items()}
    for acl, t in b.items():
        d = out.setdefault(acl, {})
        for src, est in t.items():
            # per-window CMS estimates of the SAME talker max-dedup,
            # exactly like TopKTracker.offer — max is associative and
            # commutative, so the fold shape cannot change the table
            d[src] = max(d.get(src, 0), est)
    return out


def merge_aggs(a: EpochAgg, b: EpochAgg) -> EpochAgg:
    """Merge two ADJACENT aggregates under the register merge laws."""
    from .serve import _merge_quarantine, merge_register_arrays

    if a.span[1] != b.span[0]:
        raise AnalysisError(
            f"epoch store cannot merge non-adjacent spans "
            f"{a.span} and {b.span}"
        )
    q = dict(a.quarantine)
    _merge_quarantine(q, b.quarantine)
    return EpochAgg(
        span=(a.span[0], b.span[1]),
        arrays=merge_register_arrays([a.arrays, b.arrays]),
        summary=_merge_summaries(a.summary, b.summary),
        tables=_merge_tables(a.tables, b.tables),
        quarantine=q,
    )


def _encode_tables(tables: dict[int, dict[int, int]]) -> dict:
    return {
        str(acl): {str(src): int(est) for src, est in t.items()}
        for acl, t in tables.items()
    }


def _decode_tables(obj: dict) -> dict[int, dict[int, int]]:
    return {
        int(acl): {int(src): int(est) for src, est in t.items()}
        for acl, t in obj.items()
    }


def _pack_node(agg: EpochAgg, *, level: int, meta: dict | None = None) -> bytes:
    """One node -> RAEP1 frame bytes (the distributed tier's CRC'd epoch
    encoding; parallel/distributed.py owns the format)."""
    from ..parallel.distributed import pack_epoch_payload

    extra = {
        "level": int(level),
        "span": [int(agg.span[0]), int(agg.span[1])],
        "summary": agg.summary,
        "tables": _encode_tables(agg.tables),
        "quarantine": [
            [*k, int(v)] for k, v in sorted(agg.quarantine.items())
        ],
    }
    if meta is not None:
        extra["meta"] = meta  # level 0 keeps the full window meta
    return pack_epoch_payload(agg.arrays, extra)


def _pack_hole(span: tuple[int, int], level: int) -> bytes:
    """A dense-numbering placeholder for a node that must not exist
    (keyspace migration inside the span, or a damaged child): queries
    treat it as unavailable and fall through to finer levels."""
    from ..parallel.distributed import pack_epoch_payload

    return pack_epoch_payload({}, {
        "level": int(level), "span": [int(span[0]), int(span[1])],
        "hole": True,
    })


def _unpack_node(payload: bytes) -> EpochAgg | None:
    """RAEP1 frame -> aggregate; ``None`` for holes.  Raises typed on
    corruption the CRC catches (caller quarantines via the chain)."""
    from ..parallel.distributed import unpack_epoch_payload

    arrays, extra = unpack_epoch_payload(payload)
    if extra.get("hole"):
        return None
    span = tuple(int(x) for x in extra["span"])
    return EpochAgg(
        span=(span[0], span[1]),
        arrays=arrays,
        summary=extra["summary"],
        tables=_decode_tables(extra.get("tables", {})),
        quarantine={
            tuple(row[:-1]): int(row[-1])
            for row in extra.get("quarantine", [])
        },
    )


def agg_from_epoch(ep) -> EpochAgg:
    """A serve WindowEpoch -> its level-0 aggregate."""
    wid = int(ep.meta["id"])
    return EpochAgg(
        span=(wid, wid + 1),
        arrays=ep.arrays,
        summary=_summary_from_meta(ep.meta),
        tables=ep.tracker_tables,
        quarantine=dict(ep.quarantine),
    )


# ---------------------------------------------------------------------------
# The store.
# ---------------------------------------------------------------------------


class EpochStore:
    """Durable window history + segment-tree aggregates for one serve
    process (single-writer; range queries may come from HTTP threads).

    Lifecycle: construct (scans chains, repairs missing summary nodes,
    loads the manifest/last-hit planes), then :meth:`bind_base` with the
    first window id this run will publish — a fresh store adopts it, a
    resumed store checks it against the spill frontier so a window-id
    gap is a typed refusal, never silent misnumbering.
    """

    MANIFEST = "manifest.json"
    INDEX = "index.jsonl"
    LASTHIT = "lasthit.json"

    def __init__(
        self,
        store_dir: str,
        *,
        budget_bytes: int = 512 << 20,
        trend_threshold: float = 0.0,
    ):
        if budget_bytes < 1 << 20:
            raise AnalysisError(
                f"epoch store budget must be >= 1 MiB, got {budget_bytes}"
            )
        self.dir = os.path.abspath(store_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.budget_bytes = int(budget_bytes)
        self.trend_threshold = float(trend_threshold)
        self._lock = threading.RLock()
        # node segments stay small relative to the budget so eviction
        # (whole oldest segment) is granular
        self._segment_bytes = max(64 << 10, min(4 << 20, budget_bytes // 16))
        self._chains: dict[int, EpochStoreLog] = {}
        #: the odd (unpaired) in-memory aggregate per level — an append
        #: cache only; a restart reloads pairs from disk
        self._carry: dict[int, EpochAgg | None] = {}
        self._labels: list[tuple] | None = None
        self.base: int | None = None
        self.eras: list[dict] = []  # {"start": wid, "generation": g}
        self.spilled_total = 0
        self.compactions_total = 0
        self.holes_total = 0
        self.range_queries_total = 0
        self.range_incomplete_total = 0
        self.evicted_epochs_total = 0
        self.evicted_nodes_total = 0
        self.trend_events_total = 0
        self.trend_tail: deque[dict] = deque(maxlen=TREND_TAIL)
        self._trend_state: dict[str, str] = {}
        self._trend_prev: dict | None = None
        self.last_hit: dict[str, dict] = {}
        self._index: list[dict] = []  # {"w","s","e","lines"} per spill
        self._index_fd: int | None = None
        self._load()
        self._repair()

    # -- open / scan ------------------------------------------------------
    def _chain(self, level: int) -> EpochStoreLog:
        c = self._chains.get(level)
        if c is None:
            c = EpochStoreLog(
                os.path.join(self.dir, f"L{level:02d}"),
                segment_bytes=self._segment_bytes,
                # store-level eviction is explicit (_evict_over_budget);
                # a chain must never silently drop its own head
                budget_bytes=1 << 62,
            )
            self._chains[level] = c
        return c

    def _load(self) -> None:
        for name in sorted(os.listdir(self.dir)):
            m = _LEVEL_RE.match(name)
            if m and os.path.isdir(os.path.join(self.dir, name)):
                self._chain(int(m.group(1)))
        mpath = os.path.join(self.dir, self.MANIFEST)
        try:
            with open(mpath) as f:
                man = json.load(f)
            self.base = int(man["base"])
            self.eras = list(man.get("eras", []))
        except (OSError, ValueError, KeyError):
            self.base = None
        try:
            with open(os.path.join(self.dir, self.LASTHIT)) as f:
                self.last_hit = json.load(f).get("rules", {})
        except (OSError, ValueError):
            self.last_hit = {}
        # the window<->wall-time index: jsonl with the lineage ledger's
        # torn-tail law (a SIGKILL tears at most the final line)
        ipath = os.path.join(self.dir, self.INDEX)
        try:
            with open(ipath, "rb") as f:
                lines = f.read().split(b"\n")
            lines.pop()  # b"" after a complete final record, else torn
            for ln in lines:
                if ln.strip():
                    self._index.append(json.loads(ln))
        except (OSError, ValueError):
            self._index = []

    def _write_manifest(self) -> None:
        _atomic_write_json(os.path.join(self.dir, self.MANIFEST), {
            "base": self.base, "eras": self.eras,
        })

    def bind_base(self, win_id: int) -> None:
        """Adopt (fresh) or check (resumed) this run's first window id."""
        with self._lock:
            if self.base is None:
                self.base = int(win_id)
                self._write_manifest()
                return
            frontier = self.base + self._chain(0).next_seq
            if win_id > frontier:
                raise AnalysisError(
                    f"epoch store at {self.dir} ends at window "
                    f"{frontier - 1} but this run starts at {win_id}: "
                    f"the gap would misnumber history — point "
                    f"--epoch-store at a fresh directory or resume the "
                    f"run the store belongs to"
                )

    def _repair(self) -> None:
        """Rebuild summary nodes a crash left unwritten.

        Invariant restored: ``level k count == level k-1 count // 2``
        for every level.  Children read back from disk; an unreadable or
        hole child makes the parent a hole (dense numbering, queries
        fall through) — repair never blocks an open.
        """
        k = 1
        while True:
            below = self._chains.get(k - 1)
            if below is None or below.next_seq < 2:
                break
            chain = self._chain(k)
            expected = below.next_seq // 2
            while chain.next_seq < expected:
                j = chain.next_seq
                left = self._load_node(k - 1, 2 * j)
                right = self._load_node(k - 1, 2 * j + 1)
                if left is None or right is None or not self._pair_ok(
                    left, right
                ):
                    lo = (self.base or 0) + (j << k)
                    chain.append_bytes(_pack_hole((lo, lo + (1 << k)), k))
                    self.holes_total += 1
                else:
                    agg = merge_aggs(left, right)
                    chain.append_bytes(_pack_node(agg, level=k))
                    self.compactions_total += 1
            k += 1

    # -- spill + compaction ----------------------------------------------
    def set_labels(self, labels: list[tuple] | None) -> None:
        """(firewall, acl, index) per key id — the last-hit/trend planes
        need rule identity; serve refreshes this at install/reload."""
        with self._lock:
            self._labels = labels

    def frontier_window(self) -> int | None:
        """Last durably spilled window id (None while empty)."""
        with self._lock:
            if self.base is None:
                return None
            n = self._chain(0).next_seq
            return self.base + n - 1 if n else None

    def spill(self, ep) -> bool:
        """Durably append one rotated window; returns False for a
        duplicate (resume replay re-publishing an already-spilled
        window), True once the epoch and its summaries are on disk.

        Fires the ``epochstore.spill`` fault site first: an injected
        (or real) failure surfaces BEFORE any bytes land, so the caller
        can degrade with the store frontier still consistent.
        """
        wid = int(ep.meta["id"])
        with self._lock:
            if self.base is None:
                self.bind_base(wid)
            chain = self._chain(0)
            frontier = self.base + chain.next_seq
            if wid < frontier:
                return False
            if wid > frontier:
                raise AnalysisError(
                    f"epoch store spill gap: expected window {frontier}, "
                    f"got {wid} (a skipped spill would misnumber history)"
                )
            faults.fire("epochstore.spill")
            agg = agg_from_epoch(ep)
            chain.append_bytes(_pack_node(agg, level=0, meta=ep.meta))
            self.spilled_total += 1
            self._append_index(ep.meta)
            self._note_last_hit(ep)
            self._trend_step(ep)
            self._promote(0, agg)
            self._evict_over_budget()
            return True

    def _pair_ok(self, left: EpochAgg, right: EpochAgg) -> bool:
        """A summary node must not straddle a keyspace migration: the
        register key spaces differ (shapes may too), so the merge would
        be meaningless at best.  Queries refuse pre-era ranges anyway;
        the hole keeps numbering dense."""
        lo, hi = left.span[0], right.span[1]
        return not any(lo < int(e["start"]) < hi for e in self.eras)

    def _promote(self, level: int, agg: EpochAgg | None) -> None:
        """Binary-counter compaction: when level ``k`` turns even, merge
        its last pair one level up (``agg`` None == the new node is a
        hole; holes propagate up as holes)."""
        chain = self._chain(level)
        if chain.next_seq % 2 == 1:
            self._carry[level] = agg
            return
        left = self._carry.get(level)
        if left is None or agg is None or left.span[1] != agg.span[0]:
            # carry lost to a restart (or it IS a hole): reload the pair
            j = chain.next_seq - 2
            left = self._load_node(level, j)
            if agg is None:
                agg = self._load_node(level, j + 1)
        self._carry[level] = None
        up = level + 1
        if left is None or agg is None or not self._pair_ok(left, agg):
            span_lo = (self.base or 0) + ((chain.next_seq - 2) << level)
            self._chain(up).append_bytes(
                _pack_hole((span_lo, span_lo + (2 << level)), up)
            )
            self.holes_total += 1
            self._promote(up, None)
            return
        # the crash window the chaos schedules pin: a kill between here
        # and the append must leave every lower level intact (repair
        # rebuilds this node from its children at next open)
        faults.fire("epochstore.compact")
        merged = merge_aggs(left, agg)
        self._chain(up).append_bytes(_pack_node(merged, level=up))
        self.compactions_total += 1
        self._promote(up, merged)

    def mark_era(self, win_id: int, generation: int) -> None:
        """A non-identity ruleset migration: windows >= ``win_id`` live
        in a new register key space.  Ranges reaching across (or before)
        the newest era boundary answer ``range_incomplete``."""
        with self._lock:
            self.eras.append({
                "start": int(win_id), "generation": int(generation),
            })
            self._write_manifest()
            # the carried aggregates are old-space images; drop them so
            # compaction reloads (and hole-fills) across the boundary
            self._carry.clear()
            self._trend_prev = None
            self._trend_state.clear()

    def _append_index(self, meta: dict) -> None:
        row = {
            "w": int(meta["id"]),
            "s": float(meta.get("started_unix") or 0.0),
            "e": float(meta.get("ended_unix") or 0.0),
            "lines": int(meta.get("lines", 0)),
        }
        if self._index_fd is None:
            self._index_fd = os.open(
                os.path.join(self.dir, self.INDEX),
                os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644,
            )
        os.write(self._index_fd, (
            json.dumps(row, sort_keys=True, separators=(",", ":")) + "\n"
        ).encode())
        self._index.append(row)

    # -- last-hit + trend planes ------------------------------------------
    def _hit_totals(self, arrays: dict) -> np.ndarray:
        u64 = np.uint64
        return arrays["counts_lo"].astype(u64) + (
            arrays["counts_hi"].astype(u64) << u64(32)
        )

    def _note_last_hit(self, ep) -> None:
        if self._labels is None:
            return
        tot = self._hit_totals(ep.arrays)
        wid = int(ep.meta["id"])
        unix = float(ep.meta.get("ended_unix") or 0.0)
        for kid in np.nonzero(tot)[0]:
            fw, acl, idx = self._labels[int(kid)]
            self.last_hit[f"{fw} {acl} {idx}"] = {
                "window": wid, "unix": round(unix, 3),
                "hits": int(tot[kid]),
            }
        _atomic_write_json(os.path.join(self.dir, self.LASTHIT), {
            "rules": self.last_hit, "frontier": wid,
        })

    def _trend_step(self, ep) -> None:
        """Adjacent-epoch rate deltas through the report plane's
        trend_events (same thresholds/hysteresis as live publication,
        store granularity)."""
        if self.trend_threshold <= 0 or self._labels is None:
            return
        from . import report as report_mod

        tot = self._hit_totals(ep.arrays)
        per_rule = []
        for kid in np.nonzero(tot)[0]:
            fw, acl, idx = self._labels[int(kid)]
            per_rule.append({
                "firewall": fw, "acl": acl, "index": idx,
                "hits": int(tot[kid]),
            })
        rep = {
            "per_rule": per_rule,
            "totals": {"lines_total": int(ep.meta.get("lines", 0))},
        }
        if self._trend_prev is not None:
            for ev in report_mod.trend_events(
                self._trend_prev, rep,
                threshold=self.trend_threshold, state=self._trend_state,
            ):
                ev = dict(ev)
                ev["window"] = int(ep.meta["id"])
                self.trend_tail.append(ev)
                self.trend_events_total += 1
        self._trend_prev = rep

    def last_hit_obj(self) -> dict:
        with self._lock:
            return {
                "frontier": self.frontier_window(),
                "rules": dict(self.last_hit),
                "trend_tail": list(self.trend_tail),
            }

    # -- queries ----------------------------------------------------------
    def _load_node(self, level: int, j: int) -> EpochAgg | None:
        chain = self._chains.get(level)
        if chain is None:
            return None
        rec = chain.read_record(j)
        if rec is None:
            return None
        try:
            return _unpack_node(rec[0])
        except AnalysisError:
            return None  # CRC passed but framing did not: treat as gap

    def resolve_range(self, frm: str | None, to: str | None):
        """HTTP query params -> inclusive window-id bounds.

        Values >= 10^8 read as unix seconds and map through the spill
        index (first window ending at/after ``from``, last starting
        at/before ``to``); smaller values are window ids.  ``None``
        bounds default to the store's full extent.
        """
        def parse(v, *, is_from):
            if v is None or v == "":
                return None
            try:
                x = float(v)
            except ValueError as e:
                raise AnalysisError(f"bad range bound {v!r}") from e
            if x < 1e8:
                return int(x)
            with self._lock:
                if is_from:
                    for row in self._index:
                        if row["e"] >= x:
                            return row["w"]
                    return (self.frontier_window() or 0) + 1  # future
                prev = None
                for row in self._index:
                    if row["s"] <= x:
                        prev = row["w"]
                    else:
                        break
                return prev if prev is not None else -1  # before history

        return parse(frm, is_from=True), parse(to, is_from=False)

    def _pick_level(self, s: int, e: int) -> int:
        """Largest level whose aligned node starting at seq ``s`` fits
        inside ``[s, e)`` — the greedy step that caps the decomposition
        at ``2*log2(n)`` nodes."""
        k = 0
        top = max(self._chains, default=0)
        while k < top:
            size = 2 << k
            if s % size or s + size > e:
                break
            k += 1
        return k

    def range_agg(self, lo: int | None, hi: int | None):
        """Inclusive ``[lo, hi]`` -> ``(EpochAgg, None)`` or
        ``(None, range_incomplete marker)``.  Never partial."""
        with self._lock:
            self.range_queries_total += 1
            out = self._range_agg_locked(lo, hi)
            if out[0] is None:
                self.range_incomplete_total += 1
            return out

    def _range_agg_locked(self, lo, hi):
        if self.base is None or self._chain(0).next_seq == 0:
            return None, range_incomplete(lo, hi, "empty_store")
        frontier = self.base + self._chain(0).next_seq  # first unspilled
        if lo is None:
            lo = self.base
        if hi is None:
            hi = frontier - 1
        lo, hi = int(lo), int(hi)
        if lo > hi:
            return None, range_incomplete(lo, hi, "empty_range")
        if hi >= frontier:
            return None, range_incomplete(
                lo, hi, "beyond_frontier", frontier
            )
        if lo < self.base:
            return None, range_incomplete(lo, hi, "missing", lo)
        era_lo = max(
            (int(e["start"]) for e in self.eras), default=self.base
        )
        if lo < era_lo:
            # pre-migration registers live in a dead key space: refuse
            # typed rather than merge incomparable counters
            return None, range_incomplete(
                lo, hi, "keyspace_migration", era_lo - 1
            )
        s, e = lo - self.base, hi - self.base + 1
        agg: EpochAgg | None = None
        w = s
        while w < e:
            k = self._pick_level(w, e)
            node = None
            while k >= 0:
                node = self._load_node(k, w >> k)
                if node is not None:
                    break
                k -= 1
            if node is None:
                return None, range_incomplete(
                    lo, hi, "missing", self.base + w
                )
            agg = node if agg is None else merge_aggs(agg, node)
            w += 1 << max(k, 0)
        return agg, None

    def naive_range_agg(self, lo: int, hi: int):
        """The linear per-epoch left fold the segment tree must match
        bit-for-bit (and beat by >=10x at depth): same guards, level-0
        nodes only: the baseline a range query is timed against and
        the oracle of its fold."""
        with self._lock:
            if self.base is None or self._chain(0).next_seq == 0:
                return None, range_incomplete(lo, hi, "empty_store")
            frontier = self.base + self._chain(0).next_seq
            if lo > hi:
                return None, range_incomplete(lo, hi, "empty_range")
            if hi >= frontier:
                return None, range_incomplete(
                    lo, hi, "beyond_frontier", frontier
                )
            agg: EpochAgg | None = None
            for w in range(lo - self.base, hi - self.base + 1):
                node = self._load_node(0, w)
                if node is None:
                    return None, range_incomplete(
                        lo, hi, "missing", self.base + w
                    )
                agg = node if agg is None else merge_aggs(agg, node)
            return agg, None

    # -- budget + accounting ----------------------------------------------
    def _evict_over_budget(self) -> None:
        """Whole-oldest-segment eviction from the FINEST level holding
        more than one segment: raw epochs go first (their coarse
        summaries still answer aligned queries over the evicted span),
        summaries only when no finer level has anything left to give."""
        while True:
            total = sum(
                c.stats()["bytes"] for c in self._chains.values()
            )
            if total <= self.budget_bytes:
                return
            victim = None
            for k in sorted(self._chains):
                c = self._chains[k]
                if len(c._segments) > 1:
                    victim = (k, c)
                    break
            if victim is None:
                return  # one segment per level: nothing evictable
            k, c = victim
            freed = c.gc(c._segments[0].end)
            if k == 0:
                self.evicted_epochs_total += freed
            else:
                self.evicted_nodes_total += freed
            from . import obs

            obs.instant("epochstore.evict", args={
                "level": k, "nodes": freed,
            })

    def stats(self) -> dict:
        with self._lock:
            per_level = {
                k: c.stats() for k, c in sorted(self._chains.items())
            }
            n0 = self._chain(0).next_seq
            return {
                "dir": self.dir,
                "base": self.base,
                "last_spilled_window": self.frontier_window(),
                "levels": len(self._chains),
                "epochs": int(sum(
                    s.count for s in self._chain(0)._segments
                )),
                "nodes": int(sum(
                    sum(s.count for s in c._segments)
                    for c in self._chains.values()
                )),
                "bytes": int(sum(
                    v["bytes"] for v in per_level.values()
                )),
                "spilled_total": self.spilled_total,
                "compactions_total": self.compactions_total,
                "holes_total": self.holes_total,
                "evicted_epochs_total": self.evicted_epochs_total,
                "evicted_nodes_total": self.evicted_nodes_total,
                "quarantined_segments": int(sum(
                    len(c.quarantined) for c in self._chains.values()
                )),
                "range_queries_total": self.range_queries_total,
                "range_incomplete_total": self.range_incomplete_total,
                "trend_events_total": self.trend_events_total,
                "last_hit_rules": len(self.last_hit),
                "depth": int(math.log2(n0)) + 1 if n0 else 0,
                "eras": len(self.eras),
            }

    def gauges(self) -> dict:
        """Flat numerics for /metrics (JSON and prom render from this
        one dict)."""
        s = self.stats()
        fw = s["last_spilled_window"]
        return {
            "epochstore_spilled_total": s["spilled_total"],
            "epochstore_epochs": s["epochs"],
            "epochstore_levels": s["levels"],
            "epochstore_nodes": s["nodes"],
            "epochstore_bytes": s["bytes"],
            "epochstore_depth": s["depth"],
            "epochstore_compactions_total": s["compactions_total"],
            "epochstore_holes_total": s["holes_total"],
            "epochstore_evicted_epochs_total": s["evicted_epochs_total"],
            "epochstore_evicted_nodes_total": s["evicted_nodes_total"],
            "epochstore_quarantined_segments": s["quarantined_segments"],
            "epochstore_last_window": fw if fw is not None else -1,
            "epochstore_range_queries_total": s["range_queries_total"],
            "epochstore_range_incomplete_total":
                s["range_incomplete_total"],
            "epochstore_trend_events_total": s["trend_events_total"],
            "epochstore_last_hit_rules": s["last_hit_rules"],
        }

    def frontier(self) -> dict:
        """The postmortem join (/lineage + doctor): did history survive?"""
        s = self.stats()
        return {
            "last_spilled_window": s["last_spilled_window"],
            "levels": s["levels"],
            "epochs": s["epochs"],
            "holes": s["holes_total"],
            "quarantined_segments": s["quarantined_segments"],
        }

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Fresh-run open: drop every chain and plane (mirrors the WAL
        law — a non-resume run must not graft onto stale history)."""
        with self._lock:
            for c in self._chains.values():
                c.reset()
                c.close()
            self._chains.clear()
            self._carry.clear()
            if self._index_fd is not None:
                os.close(self._index_fd)
                self._index_fd = None
            for name in (self.MANIFEST, self.INDEX, self.LASTHIT):
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass
            self.base = None
            self.eras = []
            self._index = []
            self.last_hit = {}
            self._trend_prev = None
            self._trend_state.clear()
            self.trend_tail.clear()

    def sync(self) -> None:
        with self._lock:
            for c in self._chains.values():
                c.sync()

    def close(self) -> None:
        with self._lock:
            for c in self._chains.values():
                c.close()
            if self._index_fd is not None:
                os.close(self._index_fd)
                self._index_fd = None


# ---------------------------------------------------------------------------
# Report-plane joins.
# ---------------------------------------------------------------------------


def attach_last_hit(rep_obj: dict, store: EpochStore) -> None:
    """Join the store's last-hit horizon into ``totals.static``: every
    ``safe_to_delete`` verdict gains the evidence the paper's workflow
    actually needs — WHEN the rule last hit, or that it never has inside
    retained history."""
    static = rep_obj.get("totals", {}).get("static")
    if not isinstance(static, dict):
        return
    horizon = store.frontier_window()
    if horizon is None:
        return
    rules: dict[str, dict] = {}
    classes = static.get("unused_classes", {})
    for rule in classes.get("safe_to_delete", []):
        hit = store.last_hit.get(rule)
        if hit is None:
            rules[rule] = {"never_hit": True}
        else:
            rules[rule] = {
                "last_hit_window": hit["window"],
                "last_hit_unix": hit["unix"],
                "quiet_windows": max(horizon - hit["window"], 0),
            }
    static["last_hit"] = {"horizon_window": horizon, "rules": rules}
