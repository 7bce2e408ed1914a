"""Always-on streaming service: live ingest, windowed registers, hot reload.

Counterpart of the reference's ``runtime/serve.py`` (single host, single
tenant).  The batch drivers answer "was this rule used ever in this
corpus"; a deletion decision needs "was it used in the last 24 h / 7 d"
on live traffic.  This module turns the pipeline into a long-running
service with three pillars:

1. **Listener tier** (hostside/listener.py): UDP/TCP syslog sockets and a
   rotating-file tailer feed a bounded queue with explicit drop
   accounting.  The serve loop forms batches with the batch drivers'
   boundary rules (``stream.LineBatcher``) and steps them through the
   same step functions as ``run`` (``parallel/step.py``: the first_match
   or match_hist kernel, first_match6 for v6 lines, the reg_tail kernel's
   register tail and its select), on the card unless ``cfg.device`` is
   ``"cpu"``.  The kernels are built once, when :meth:`ServeDriver.run`
   starts, never at a rotation or a reload.

2. **Windowed registers.**  Time is cut into windows (a wall-clock cadence
   or a deterministic line count); each window accumulates into a fresh
   register state, and at rotation the card is synchronised and the
   window's registers are pulled to the host and pushed into a ring of N
   mergeable epochs.  Every register obeys the merge laws of the
   data-parallel step (add for the 64-bit counts and the CMS planes, max
   for HLL), so merging K epochs is bit-identical to one run over the
   concatenated traffic: "unused in the last K windows" is one host-side
   merge (:func:`merge_register_arrays`), not a re-run.  The ring rides
   the checkpoint plane in the reference's on-disk format, so a restarted
   service resumes with its history, and either package resumes the
   other's ring.

3. **Publication and hot reload.**  Every rotation publishes the window
   report, the cumulative report, a ``diff-reports`` diff against the
   previous window and the merged views to the serve directory and a
   loopback HTTP JSON endpoint.  A SIGHUP or a watched ruleset-file
   change re-packs the rule tensors mid-stream: a key-space migration map
   (rule identity = firewall/ACL/text, so counters survive renumbering)
   rewrites the live state and every ring epoch; keys with hits that map
   nowhere land in an explicit quarantine bucket.  A reload that fails at
   any point (the ``reload.midbatch`` fault site included) leaves the old
   tensors and counters untouched: the new rule tensors and the migrated
   state are built first and swapped in under one lock.

Drop invariant: a window that overlaps a dropped line (queue overflow, a
forced ``listener.drop``, a dead listener) carries a typed
``WindowIncomplete`` marker (``totals.window.incomplete``) in every report
that includes it, never a silent zero-hit window.

Threads: the listeners, the HTTP server and the ruleset watcher run
beside the loop; only the loop's thread touches the card (the device
memory gauges are read there and cached for ``/metrics``), and
``_teardown`` stops every thread.

History and scaling:

- **Epoch store** (``scfg.epoch_store``, runtime/epochstore.py): every
  rotation spills the closed window durably; ``/report/range?from=&to=``
  answers any span of spilled windows from at most ``2 log2 n`` stored
  aggregates (:func:`render_range_report`), or the typed
  ``range_incomplete`` marker with status 404, and ``/report/last-hit``
  serves the per-rule quiet horizon.  A failing spill degrades the
  ``epoch_store`` subsystem and publication goes on.

- **Autoscale** (``ascfg``, runtime/autoscale.py): the policy engine reads
  the queue's pressure and starvation at ``ascfg.poll_sec`` and re-forms
  the mesh at a new world on the divisor ladder of the maximum.  The
  batch is padded to the maximum once, so chunk boundaries (and the
  registers) never depend on the world; a scale event drains the
  in-flight candidates, moves the registers through the host and
  re-ships the rules.  The worlds are drawn from a device pool
  (``devices=``): every visible CUDA device, or the CPU with
  ``cfg.device="cpu"``; a pool may repeat a device (``[cuda:0] * 4`` is
  four virtual shards of one card, whose shards share one register
  replica), which no CLI flag builds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..config import AnalysisConfig, AutoscaleConfig, ServeConfig
from ..errors import AnalysisError, FeedWorkerError, StallError
from ..hostside import pack as pack_mod
from ..hostside.listener import LineQueue, ListenerSet
from ..models import pipeline
from ..ops.topk import TopKTracker
from ..parallel import mesh as mesh_lib
from ..parallel import step as step_lib
from . import checkpoint as ckpt
from . import devprof, epochstore, faults, flightrec, obs, retrypolicy
from .autoscale import PolicyEngine, render_prom, render_prom_labeled, world_ladder
from .metrics import (
    LatencyHistogram,
    SloBurnEngine,
    SloPolicy,
    build_info,
    render_build_info_prom,
    window_slo_stats,
)
from .report import diff_report_objs, seal_lineage, trend_events
from .wal import DEFAULT_TENANT, LineageLog, WriteAheadLog


def merge_register_arrays(items: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Merge K window register images under the step's merge laws.

    Bit-identical to accumulating the concatenated traffic into one
    state: 64-bit counts add exactly (the ``counts_lo``/``counts_hi``
    carry), CMS planes add mod 2^32, HLL takes the elementwise max.
    Associative and commutative, so ring merges compose in any grouping.
    """
    if not items:
        raise AnalysisError("merge_register_arrays needs at least one epoch")
    first = items[0]
    u64 = np.uint64
    lo = first["counts_lo"].astype(u64)
    total = lo + (first["counts_hi"].astype(u64) << u64(32))
    cms = first["cms"].copy()
    hll = first["hll"].copy()
    talk = first["talk_cms"].copy()
    for it in items[1:]:
        total = total + (
            it["counts_lo"].astype(u64) + (it["counts_hi"].astype(u64) << u64(32))
        )
        cms = (cms + it["cms"]).astype(np.uint32)
        np.maximum(hll, it["hll"], out=hll)
        talk = (talk + it["talk_cms"]).astype(np.uint32)
    return {
        "counts_lo": (total & u64(0xFFFFFFFF)).astype(np.uint32),
        "counts_hi": (total >> u64(32)).astype(np.uint32),
        "cms": cms,
        "hll": hll,
        "talk_cms": talk,
    }


def zero_arrays(n_keys: int, cfg: AnalysisConfig) -> dict[str, np.ndarray]:
    """A zeroed register image (the reference's ``state_to_host(init_state_host())``)."""
    pipeline.check_register_budget(n_keys, cfg)
    s = cfg.sketch
    u32 = np.uint32
    return {
        "counts_lo": np.zeros(n_keys, dtype=u32),
        "counts_hi": np.zeros(n_keys, dtype=u32),
        "cms": np.zeros((s.cms_depth, s.cms_width), dtype=u32),
        "hll": np.zeros((n_keys, s.hll_m), dtype=u32),
        "talk_cms": np.zeros((s.talk_cms_depth, s.cms_width), dtype=u32),
    }


# ---------------------------------------------------------------------------
# Key-space migration: old packed ruleset -> new packed ruleset.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MigrationMap:
    """How the old key/gid spaces map into a re-packed ruleset.

    Rule identity is ``(firewall, acl, rule text)``: the index is exactly
    what renumbering changes, so it cannot be the identity.  Duplicate
    identical texts within one ACL pair up in config order.  Implicit-deny
    keys match by ACL identity.  ``key_map[old] == -1`` means the old key
    has no home in the new space (rule deleted or rewritten): its counters
    go to the quarantine bucket.
    """

    key_map: np.ndarray  # [old n_keys] int64 -> new key id or -1
    gid_map: dict[int, int | None]  # old acl gid -> new gid (None = gone)
    old_n_keys: int
    new_n_keys: int
    #: which tenant's key space this map rewrites (DEFAULT_TENANT for the
    #: single-tenant service)
    tenant: str = DEFAULT_TENANT

    @property
    def identity(self) -> bool:
        return (
            self.old_n_keys == self.new_n_keys
            and bool((self.key_map == np.arange(self.old_n_keys)).all())
            and all(v == k for k, v in self.gid_map.items())
        )


def build_migration(
    old: pack_mod.PackedRuleset,
    new: pack_mod.PackedRuleset,
    tenant: str = DEFAULT_TENANT,
) -> MigrationMap:
    from collections import defaultdict

    def ident(m):
        if m.implicit_deny:
            return (m.firewall, m.acl, None)
        return (m.firewall, m.acl, m.text)

    cand: dict[tuple, deque] = defaultdict(deque)
    for kid, m in enumerate(new.key_meta):
        cand[ident(m)].append(kid)
    key_map = np.full(old.n_keys, -1, dtype=np.int64)
    for kid, m in enumerate(old.key_meta):
        q = cand.get(ident(m))
        if q:
            key_map[kid] = q.popleft()
    gid_map = {
        gid: new.acl_gid.get(name) for name, gid in old.acl_gid.items()
    }
    return MigrationMap(key_map, gid_map, old.n_keys, new.n_keys, tenant)


def migrate_arrays(
    arrays: dict[str, np.ndarray],
    mig: MigrationMap,
    old: pack_mod.PackedRuleset,
    cfg: AnalysisConfig,
) -> tuple[dict[str, np.ndarray], dict[tuple, int]]:
    """Rewrite one register image into the new key space.

    Exact counts scatter through the (injective) key map, 64-bit, so
    quarantine accounting is exact to the line.  Per-key HLL rows travel
    with their key.  The two hashed sketches (key CMS, talker CMS) key by
    hashed position, which a renumbering invalidates wholesale: they reset
    to zero on a non-identity migration (estimate planes; the exact
    counters and the unused set never depend on them with
    ``exact_counts``).  Returns the new image plus ``{(firewall, acl,
    index, text): hits}`` for every unmappable key with a nonzero count:
    the quarantine bucket.
    """
    if mig.identity:
        return {k: v.copy() for k, v in arrays.items()}, {}
    u64 = np.uint64
    old_tot = arrays["counts_lo"].astype(u64) + (
        arrays["counts_hi"].astype(u64) << u64(32)
    )
    s = cfg.sketch
    new_tot = np.zeros(mig.new_n_keys, dtype=u64)
    new_hll = np.zeros((mig.new_n_keys, s.hll_m), dtype=np.uint32)
    # the key map is injective (build_migration pops each new key at most
    # once), so a fancy-index assignment is the scatter
    mapped = mig.key_map >= 0
    targets = mig.key_map[mapped]
    new_tot[targets] = old_tot[mapped]
    new_hll[targets] = arrays["hll"][mapped]
    quarantine: dict[tuple, int] = {}
    for kid in np.nonzero(~mapped & (old_tot > 0))[0]:
        m = old.key_meta[int(kid)]
        quarantine[(m.firewall, m.acl, m.index, m.text)] = int(old_tot[kid])
    return (
        {
            "counts_lo": (new_tot & u64(0xFFFFFFFF)).astype(np.uint32),
            "counts_hi": (new_tot >> u64(32)).astype(np.uint32),
            "cms": np.zeros((s.cms_depth, s.cms_width), dtype=np.uint32),
            "hll": new_hll,
            "talk_cms": np.zeros((s.talk_cms_depth, s.cms_width), dtype=np.uint32),
        },
        quarantine,
    )


def migrate_tracker_tables(
    tables: dict[int, dict[int, int]], mig: MigrationMap
) -> tuple[dict[int, dict[int, int]], int]:
    """Re-gid the talker summaries; returns (new tables, entries dropped)."""
    tag = int(pipeline.V6_ACL_TAG)
    out: dict[int, dict[int, int]] = {}
    dropped = 0
    for gid, table in tables.items():
        base = int(gid) & ~tag
        ng = mig.gid_map.get(base)
        if ng is None:
            dropped += len(table)
            continue
        dst = out.setdefault(ng | (int(gid) & tag), {})
        for src, est in table.items():
            dst[src] = max(dst.get(src, 0), est)
    return out, dropped


def _quarantine_totals(q: dict[tuple, int]) -> dict | None:
    """Report-facing image of a quarantine bucket (None when empty)."""
    if not q:
        return None
    return {
        "hits": int(sum(q.values())),
        "rules": [
            {"rule": f"{fw} {acl} {idx}", "text": text, "hits": int(h)}
            for (fw, acl, idx, text), h in sorted(q.items())
        ],
    }


def _merge_quarantine(dst: dict[tuple, int], src: dict[tuple, int]) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v


# ---------------------------------------------------------------------------
# Window epochs + ring.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowEpoch:
    """One rotated window: register image + accounting + talker summary."""

    arrays: dict[str, np.ndarray]
    meta: dict  # id, lines, parsed, skipped, chunks, drops, incomplete...
    tracker_tables: dict[int, dict[int, int]]
    quarantine: dict[tuple, int] = dataclasses.field(default_factory=dict)


class WindowRing:
    """Ring of the last N window epochs (oldest evicted first)."""

    def __init__(self, size: int):
        if size < 1:
            raise AnalysisError(f"window ring size must be >= 1, got {size}")
        self.size = size
        self.epochs: deque[WindowEpoch] = deque(maxlen=size)

    def push(self, ep: WindowEpoch) -> None:
        self.epochs.append(ep)

    def last(self, k: int) -> list[WindowEpoch]:
        eps = list(self.epochs)
        return eps[-k:] if k > 0 else eps

    def window_ids(self) -> list[int]:
        return [ep.meta["id"] for ep in self.epochs]


class _Swag:
    """Two-stack sliding-window aggregate over one view's last ``size``
    register images: each pushed image is merged at most twice (into the
    back accumulator, and into a suffix aggregate when the stacks flip),
    so querying the window's merge is O(1) amortized instead of re-folding
    ``size`` epochs.  Associativity of the merge laws makes the regrouped
    result bit-identical."""

    def __init__(self, size: int):
        self.size = size
        # front: (window id, suffix merge incl. self) with the OLDEST on
        # top; back: raw pushes since the last flip
        self.front: list[tuple[int, dict]] = []
        self.back: list[tuple[int, dict]] = []
        self.back_agg: dict | None = None

    def _len(self) -> int:
        return len(self.front) + len(self.back)

    def push(self, wid: int, arrays: dict) -> None:
        while self._len() >= self.size:
            self._pop_oldest()
        self.back.append((wid, arrays))
        self.back_agg = (
            arrays if self.back_agg is None
            else merge_register_arrays([self.back_agg, arrays])
        )

    def _pop_oldest(self) -> None:
        if not self.front:
            agg = None
            for wid, arrays in reversed(self.back):
                agg = arrays if agg is None else merge_register_arrays([arrays, agg])
                self.front.append((wid, agg))
            self.back = []
            self.back_agg = None
        self.front.pop()

    def query(self) -> tuple[list[int], dict | None]:
        """(window ids oldest-first, merged arrays or None when empty)."""
        ids = [w for w, _ in reversed(self.front)] + [w for w, _ in self.back]
        if self.front and self.back_agg is not None:
            agg = merge_register_arrays([self.front[-1][1], self.back_agg])
        elif self.front:
            agg = self.front[-1][1]
        else:
            agg = self.back_agg
        return ids, agg

    def clear(self) -> None:
        self.front = []
        self.back = []
        self.back_agg = None


class SuffixMergeCache:
    """Running suffix aggregates for the merged-K views ``_publish``
    re-renders every rotation.

    Correctness does not depend on the cache: :meth:`merged` returns
    arrays only when its retained window ids exactly match the ring's,
    and None otherwise (cold start, post-reload migration, resume), when
    the caller falls back to the full fold.  Only the arrays are cached:
    tracker, meta and quarantine merging stays per epoch in
    ``_render_merged``, so the rendered report equals the uncached fold.
    """

    def __init__(self, views: tuple[int, ...]):
        self._swags = {k: _Swag(k) for k in set(views)}
        self.hits = 0
        self.misses = 0

    def push(self, wid: int, arrays: dict) -> None:
        for s in self._swags.values():
            s.push(wid, arrays)

    def merged(self, k: int, window_ids: list[int]) -> dict | None:
        s = self._swags.get(k)
        if s is None:
            return None
        ids, agg = s.query()
        if agg is None or ids != window_ids:
            self.misses += 1
            return None
        self.hits += 1
        return agg

    def invalidate(self) -> None:
        """A reload migration or a restore rewrote the epochs in place:
        the cached merges are old-key-space images, drop them all."""
        for s in self._swags.values():
            s.clear()


def render_range_report(agg, packed, cfg, *, topk: int, v6_digests=None, window_extra=None,
                        backend: str = "torch-cpu"):
    """One stored or folded aggregate (runtime/epochstore.py ``EpochAgg``)
    -> a full Report.

    The talker tracker is rebuilt by offering the aggregate's unbounded
    max-deduped table in sorted order: deterministic and independent of how
    the aggregate was folded, so the segment-tree answer renders exactly as
    the linear fold's does.
    """
    tracker = TopKTracker(cfg.sketch.topk_capacity)
    for acl in sorted(agg.tables):
        table = agg.tables[acl]
        for src in sorted(table):
            tracker.offer(int(acl), int(src), int(table[src]))
    s = agg.summary
    totals = {
        "lines_total": int(s["lines"]),
        "lines_matched": int(s["parsed"]),
        "lines_skipped": int(s["skipped"]),
        "chunks": int(s["chunks"]),
        "window": {
            "range": [int(agg.span[0]), int(agg.span[1]) - 1],
            "windows": int(s["windows"]),
            "drops": int(s["drops"]),
            "started_unix": s["started_unix"],
            "ended_unix": s["ended_unix"],
            **(
                {"incomplete": {"windows": list(s["incomplete"]), "drops": int(s["drops"])}}
                if s["incomplete"]
                else {}
            ),
        },
    }
    if window_extra:
        totals["window"].update(window_extra)
    qt = _quarantine_totals(agg.quarantine)
    if qt:
        totals["quarantine"] = qt
    return _render(agg.arrays, packed, cfg, tracker, topk=topk, totals=totals,
                   v6_digests=v6_digests or {}, backend=backend)


# ---------------------------------------------------------------------------
# The serve driver.
# ---------------------------------------------------------------------------


class _ReloadFlushError(Exception):
    """Carrier: a device-step failure inside a reload's in-flight flush.

    Not an atomic reload failure: the batcher tail was already consumed
    when the step raised, so treating it as a recoverable reload error
    would publish a window missing delivered lines with no incomplete
    marker.  The reload path unwraps it and propagates the original typed
    error as a serve abort, like the same step failure in the serve loop.
    """


def _render(arrays: dict, packed, cfg: AnalysisConfig, tracker: TopKTracker, *, topk: int,
            totals: dict, v6_digests: dict, backend: str):
    """A Report from a host register image (``pipeline.finalize`` on the CPU)."""
    state = pipeline.state_from_numpy(arrays, torch.device("cpu"))
    return pipeline.finalize(state, packed, cfg, tracker, topk=topk, totals=totals,
                             backend=backend, v6_digests=v6_digests)


class ServeDriver:
    """The long-running analysis service (one process, one mesh).

    Construction loads the packed ruleset, binds the listener sockets and
    the HTTP endpoint and validates the config; the blocking :meth:`run`
    owns the device loop.  Tests drive it from a thread and talk to it
    over the loopback listeners and the HTTP endpoint; the CLI ``serve``
    subcommand runs it in the foreground with SIGHUP reload wired up.
    ``mesh`` defaults to ``stream.default_mesh(cfg)``: every visible CUDA
    device, or the CPU with ``cfg.device="cpu"``.  ``ascfg`` arms the
    autoscaler, whose worlds take the first devices of ``devices`` (by
    default every visible CUDA device, or ``[cpu]`` with
    ``cfg.device="cpu"``); ``devices`` may repeat a device, a seam for the
    tests and the card's smoke run, as ``mesh`` is.
    """

    def __init__(
        self,
        ruleset_prefix: str,
        cfg: AnalysisConfig,
        scfg: ServeConfig,
        *,
        topk: int = 10,
        mesh=None,
        ascfg: AutoscaleConfig | None = None,
        devices=None,
    ):
        if ascfg is not None and cfg.mesh_shape != "flat":
            raise AnalysisError(
                "serve --autoscale resizes a flat single-host mesh; the "
                "hybrid DCN x ICI topology is the multi-host direction "
                "the elastic autoscaler grows along (drop --mesh hybrid)"
            )
        if ascfg is not None and mesh is not None:
            raise AnalysisError(
                "serve --autoscale owns the mesh; an explicit mesh "
                "argument cannot be resized"
            )
        if cfg.layout != "flat":
            raise AnalysisError(
                "serve supports layout='flat' only (the stacked group "
                "buffer's data-dependent emission cadence has no window "
                "boundary semantics yet)"
            )
        if cfg.coalesce != "off":
            raise AnalysisError(
                "serve does not support --coalesce yet; windowed batches "
                "are formed line-at-a-time at the listener edge"
            )
        if not scfg.listen:
            raise AnalysisError(
                "serve needs at least one --listen spec "
                "(udp:HOST:PORT, tcp:HOST:PORT, or tail:PATH)"
            )
        self.prefix = ruleset_prefix
        self.cfg = cfg
        self.scfg = scfg
        self.topk = topk
        self._mesh_arg = mesh
        self._devices_arg = list(devices) if devices is not None else None
        self.ascfg = ascfg
        self._engine: PolicyEngine | None = None  # built in run()
        self.world = 0  # mesh extent, maintained across scale events
        # signal sampling state: the /metrics gauges' rates and
        # backpressure/starvation shares, and the autoscale policy's input
        self.lines_consumed_total = 0
        self._gauge_lock = threading.Lock()
        self._as_next = 0.0
        self._as_last_t: float | None = None
        self._as_consumed_last = 0
        self._last_pressure = 0.0
        self._last_starved = 0.0
        self._pressure_sec = 0.0
        self._starved_sec = 0.0
        self._rate_inst = 0.0
        # device memory gauges, read on the serve thread (the only one
        # that touches the card) and served from here
        self._devmem = devprof.device_memory_gauges(None)
        try:
            self.packed = pack_mod.load_packed(ruleset_prefix)
        except OSError as e:
            # typed, so the CLI's bind-failure handler (except OSError
            # around construction) never misreports a bad --ruleset
            raise AnalysisError(
                f"cannot read packed ruleset {ruleset_prefix!r}: {e}"
            ) from e
        self.queue = LineQueue(scfg.queue_lines)
        self.listeners = ListenerSet(self.queue, list(scfg.listen))
        self.ring = WindowRing(scfg.ring)
        self._reload_req = threading.Event()
        self._stop_req = threading.Event()
        self._pub_lock = threading.Lock()
        self._published: dict[str, dict] = {}  # name -> report JSON obj
        self._window_reports: dict[int, dict] = {}
        # bind the HTTP endpoint here, like the listener sockets: a bad
        # --http port is the clean bind error (exit 2, before any
        # listener thread starts), not a mid-run serve I/O failure
        self._http = None
        if scfg.http != "off":
            host, _, port = scfg.http.rpartition(":")
            try:
                self._http = _make_http_server((host, int(port)), self)
            except BaseException:
                # the listener sockets bound above have no owner yet
                self.listeners.close()
                raise
        self._http_thread = None
        self._watch_thread = None
        self._old_signals: dict = {}
        # service counters (cumulative across windows and reloads)
        self.windows_published = 0
        self.reloads = 0
        self.reload_errors = 0
        self.last_reload_error = ""
        self.total_lines = 0
        self.total_parsed = 0
        self.total_skipped = 0
        self.total_chunks = 0
        self.cum_quarantine: dict[tuple, int] = {}
        self.talker_entries_dropped = 0
        # static ruleset analysis plane: computed at start and on every
        # reload when scfg.static_analysis
        self._sa = None
        self._static_obj: dict | None = None
        self._static_done_t: float | None = None
        self._static_duration = 0.0
        self.drops_restored = 0  # drops from checkpointed history (--resume)
        # degraded-mode plane: non-core subsystem failures (static
        # analysis, metrics snapshotter, devprof capture, report
        # publisher) mark the service degraded instead of aborting
        # ingest; recovery re-arms.  Own lock: _degrade/_recover are
        # called from paths that already hold _pub_lock.
        self._deg_lock = threading.Lock()
        self.degraded: dict[str, str] = {}  # subsystem -> last error
        self.degraded_events = 0
        self.recovered_events = 0
        # durable ingest WAL (opened in run() when scfg.wal)
        self.wal: WriteAheadLog | None = None
        self._wal_next = 0  # seq of the next line to consume
        self._wal_resume_seq = 0  # from the restored checkpoint
        self.wal_replayed = 0
        self.wal_lost_total = 0  # eviction/quarantine losses (exact)
        self.wal_lost_unknown = False
        # end-to-end latency: listener receipt -> window publish, log2
        # buckets merged across windows by addition
        self.lat_cum = LatencyHistogram()
        # cumulative incompleteness: every reason a window was marked
        self.cum_incomplete_reasons: list[str] = []
        self.cum_incomplete_windows: list[int] = []
        self._t0 = time.time()
        self._init_lineage_plane()

    def _init_lineage_plane(self) -> None:
        """Lineage, SLO and trend state."""
        scfg = self.scfg
        # publication provenance: solo serve has no lease, so term 0 and
        # path "live" unless the WAL replay overrides it
        self.term = 0
        self._path = "live"
        self._lineage_log = None  # LineageLog, opened in run()
        self._lineage_recent: dict[int, dict] = {}  # window id -> record
        self._lineage_merged: dict[int, dict] = {}  # merged-K k -> record
        self.lineage_records_total = 0
        # per-rule trend plane: rule key -> last emitted label
        self._trend_state: dict[str, str] = {}
        self.trend_events_total = 0
        # the durable epoch store, opened in run() with scfg.epoch_store,
        # and its range-query latency
        self.epoch_store: epochstore.EpochStore | None = None
        self.lat_range = LatencyHistogram()
        self._suffix = SuffixMergeCache(scfg.views) if scfg.views else None
        # SLO burn-rate engine, armed by --slo
        self.slo = SloBurnEngine(SloPolicy.parse(scfg.slo)) if scfg.slo else None

    # -- public control surface -----------------------------------------
    def request_reload(self) -> None:
        self._reload_req.set()

    def stop(self) -> None:
        self._stop_req.set()

    @property
    def http_address(self) -> tuple[str, int] | None:
        srv = self._http
        return tuple(srv.server_address[:2]) if srv is not None else None

    # -- degraded-mode plane ---------------------------------------------
    def _degrade(self, subsystem: str, err: BaseException | str) -> None:
        """Mark a non-core subsystem failed; ingest keeps serving."""
        msg = (
            err if isinstance(err, str)
            else f"{type(err).__name__}: {err}"
        )[:200]
        with self._deg_lock:
            first = subsystem not in self.degraded
            self.degraded[subsystem] = msg
            if first:
                self.degraded_events += 1
        if first:
            obs.instant("serve.degraded", args={"subsystem": subsystem, "error": msg})
            obs.metric_event("serve.degraded", subsystem=subsystem, error=msg)

    def _recover(self, subsystem: str) -> None:
        """A later success of a degraded subsystem re-arms it."""
        with self._deg_lock:
            was = self.degraded.pop(subsystem, None)
            if was is not None:
                self.recovered_events += 1
        if was is not None:
            obs.instant("serve.recovered", args={"subsystem": subsystem})
            obs.metric_event("serve.recovered", subsystem=subsystem)

    def degraded_set(self) -> list[str]:
        with self._deg_lock:
            return sorted(self.degraded)

    def _check_metrics_health(self) -> None:
        """Poll the snapshotter's tick-error counters (cheap; loop tick)."""
        h = obs.metrics_health()
        if h is None:
            return
        if not h["alive"] or h["consec_errors"] > 0:
            self._degrade("metrics", h["last_error"] or "metrics snapshotter thread died")
        else:
            self._recover("metrics")

    # -- health / metrics ------------------------------------------------
    def health(self) -> dict:
        q = self.queue.snapshot()
        stalled = len(self.listeners.stalled(self.cfg.stall_timeout_sec))
        with self._pub_lock:
            # both mutate under this lock (reload and rotation on the
            # serve thread); an unlocked sum() could die mid-iteration
            quarantine_hits = int(sum(self.cum_quarantine.values()))
            ring_windows = self.ring.window_ids()
        deg_subsystems = self.degraded_set()
        with self._deg_lock:
            deg_errors = dict(self.degraded)
        degraded = (
            q["dropped"] > 0
            or self.reload_errors > 0
            or stalled > 0
            or self.listeners.alive() < len(self.listeners.listeners)
            or bool(deg_subsystems)
        )
        return {
            "status": "degraded" if degraded else "ok",
            "degraded_subsystems": deg_subsystems,
            **({"degraded_errors": deg_errors} if deg_errors else {}),
            "degraded_events": self.degraded_events,
            "recovered_events": self.recovered_events,
            "uptime_sec": round(time.time() - self._t0, 3),
            "windows_published": self.windows_published,
            "lines_total": self.total_lines,
            "queue": q,
            "listeners": {
                "n": len(self.listeners.listeners),
                "alive": self.listeners.alive(),
                "stalled": stalled,
                "addresses": self.listeners.addresses(),
            },
            "reloads": self.reloads,
            "reload_errors": self.reload_errors,
            **(
                {"last_reload_error": self.last_reload_error}
                if self.last_reload_error
                else {}
            ),
            "ruleset": {
                "n_rules": self.packed.n_rules,
                "n_acls": self.packed.n_acls,
                "n_keys": self.packed.n_keys,
            },
            "current_window": {
                "id": getattr(self, "win_id", 0),
                "pushed": getattr(self, "win_pushed", 0),
            },
            "window": {
                "mode": "lines" if self.scfg.window_lines else "sec",
                "length": self.scfg.window_lines or self.scfg.window_sec,
                "ring": self.scfg.ring,
                "ring_windows": ring_windows,
            },
            "quarantine_hits": quarantine_hits,
            "world": self.world,
            **({"autoscale": self._engine.summary()} if self._engine is not None else {}),
        }

    def _sample_metrics(self) -> dict:
        return {
            **self.listeners.sample_metrics(),
            "windows_published": self.windows_published,
            "reloads": self.reloads,
            "lines_total": self.total_lines,
        }

    def metrics_gauges(self) -> dict:
        """Flat numeric gauges: one source of truth for the autoscale
        policy, the JSON ``/metrics`` endpoint and the Prometheus text
        variant (``/metrics?format=prom``)."""
        q = self.queue.snapshot()
        eng = self._engine
        with self._gauge_lock:
            g = {
                "queue_depth": q["depth"],
                "queue_capacity": q["capacity"],
                "lines_received_total": q["received"],
                "drops_total": q["dropped"],
                "lines_consumed_total": self.lines_consumed_total,
                "lines_windowed_total": self.total_lines,
                "lines_per_sec": round(self._rate_inst, 1),
                "backpressure_frac": round(self._last_pressure, 4),
                "starved_frac": round(self._last_starved, 4),
                "backpressure_sec_total": round(self._pressure_sec, 3),
                "starved_sec_total": round(self._starved_sec, 3),
            }
        g.update({
            "windows_published": self.windows_published,
            "reloads_total": self.reloads,
            "reload_errors_total": self.reload_errors,
            "listeners_alive": self.listeners.alive(),
            "world": self.world,
            "degraded_subsystems": len(self.degraded_set()),
            "degraded_events_total": self.degraded_events,
            "recovered_events_total": self.recovered_events,
        })
        # p50/p90/p99 of the cumulative receipt->publish histogram; the
        # prom variant also renders the full bucket histogram
        g.update(self.lat_cum.gauges("latency_ingest_to_publish_"))
        # per-site retry attempt/recovery/giveup counters
        g.update(retrypolicy.gauges())
        if self.wal is not None:
            w = self.wal.stats()
            g.update({
                "wal_appended_total": w["appended"],
                "wal_segments": w["segments"],
                "wal_bytes": w["bytes"],
                "wal_evicted_records_total": w["evicted_records"],
                "wal_replayed_total": self.wal_replayed,
                "wal_lost_total": self.wal_lost_total,
            })
        if self.epoch_store is not None:
            # store depth and compaction gauges, and the range-query
            # latency quantiles
            g.update(self.epoch_store.gauges())
            g.update(self.lat_range.gauges("latency_range_query_"))
        if self._suffix is not None:
            g.update({
                "merged_suffix_hits_total": self._suffix.hits,
                "merged_suffix_misses_total": self._suffix.misses,
            })
        # device attribution and device-memory headroom; unsupported
        # memory stats stay explicit nulls (prom skips non-numerics)
        g.update(devprof.gauges())
        g.update(self._devmem)
        if self.scfg.static_analysis and self._static_done_t is not None:
            g["static_analysis_age_sec"] = round(time.time() - self._static_done_t, 3)
            g["static_analysis_duration_sec"] = round(self._static_duration, 4)
        if eng is not None:
            g.update({
                "autoscale_decisions_total": len(eng.decisions),
                "autoscale_scale_out_total": sum(1 for d in eng.decisions
                                                 if d.direction == "out"),
                "autoscale_scale_in_total": sum(1 for d in eng.decisions
                                                if d.direction == "in"),
                "autoscale_flaps_total": eng.flaps,
                "autoscale_budget_left": eng.budget_left,
            })
        if self.scfg.lineage:
            g["lineage_records_total"] = self.lineage_records_total
            g["trend_events_total"] = self.trend_events_total
        if self.slo is not None:
            g.update(self.slo.gauges())
        return g

    def build_info_dict(self) -> dict:
        """``ra_build_info`` labels, served on JSON ``/metrics`` and as the
        value-1 labeled gauge of the prom variant."""
        return build_info({"mesh": f"{self.cfg.mesh_shape}/{max(self.world, 1)}"})

    def render_latency_prom(self) -> str:
        """Prometheus histogram of the cumulative receipt->publish latency,
        appended to the gauges on ``/metrics?format=prom``."""
        out = self.lat_cum.render_prom("ra_serve_ingest_to_publish_seconds")
        if self.epoch_store is not None:
            out += self.lat_range.render_prom("ra_serve_range_query_seconds")
        return out

    def render_labeled_prom(self) -> str:
        """Labeled Prometheus families appended to ``/metrics?format=prom``:
        ``ra_build_info`` and, with ``--slo``, the per-objective burn rates."""
        out = render_build_info_prom(self.build_info_dict())
        if self.slo is not None:
            out += render_prom_labeled(
                self.slo.labeled_gauges(), prefix="ra_serve_", label="objective",
            )
        return out

    # -- report access (HTTP + tests) ------------------------------------
    def published(self, name: str) -> dict | None:
        with self._pub_lock:
            return self._published.get(name)

    def window_report(self, wid: int) -> dict | None:
        with self._pub_lock:
            return self._window_reports.get(wid)

    def merged_report_obj(self, k: int) -> dict | None:
        """Merge the last ``k`` ring epochs into one report (on demand).

        Snapshots the epochs and the ruleset under the publish lock, then
        renders outside it: the merge and finalize must not block the
        serve loop's rotation, and a reload swapping the key space
        mid-render must not mix old arrays with the new ruleset.  Shallow
        refs suffice (a reload rebinds epoch arrays and tables, never
        mutates them in place) except quarantine, which is merged in place
        and therefore copied.
        """
        with self._pub_lock:
            eps = [
                WindowEpoch(
                    arrays=ep.arrays,
                    meta=dict(ep.meta),
                    tracker_tables=ep.tracker_tables,
                    quarantine=dict(ep.quarantine),
                )
                for ep in self.ring.last(k)
            ]
            packed = self.packed
            sa_obj = self._static_obj
        if not eps:
            return None
        obj = json.loads(self._render_merged(eps, packed).to_json())
        if sa_obj is not None:
            from . import staticanalysis

            staticanalysis.attach_static_obj(obj, sa_obj, strict=False)
        return obj

    # -- static analysis plane -------------------------------------------
    def _compute_static(self, packed, reuse):
        """Run the analyzer (compute only: nothing published on failure)."""
        from . import staticanalysis

        t0 = time.monotonic()
        with obs.span("serve.static_analysis"):
            sa = staticanalysis.analyze_ruleset(
                packed,
                witness_budget=self.scfg.static_witness_budget,
                reuse=reuse,
                device=self._device,
            )
        return sa, time.monotonic() - t0

    def _install_static(self, sa, obj: dict, duration: float) -> None:
        """Swap in a complete verdict set.  Caller holds ``_pub_lock``: the
        reload path installs it inside its one locked ruleset swap, so an
        HTTP render never joins old-ruleset verdicts onto new key ids."""
        self._sa = sa
        self._static_obj = obj
        self._published["static"] = obj
        self._static_done_t = time.time()
        self._static_duration = duration
        # a complete verdict set re-arms a degraded static plane
        self._recover("static_analysis")

    def _static_side_effects(self, obj: dict, duration: float) -> None:
        """Off-lock tail of a static publish: disk + metrics."""
        self._write_json("static.json", obj)
        obs.metric_event(
            "serve.static",
            dead=obj["meta"]["dead"],
            reused_acls=obj["meta"]["reused_acls"],
            duration_sec=round(duration, 4),
        )

    def _publish_static(self, packed, sa, duration: float) -> None:
        obj = sa.to_obj(packed)
        with self._pub_lock:
            self._install_static(sa, obj, duration)
        self._static_side_effects(obj, duration)

    def _attach_static(self, obj: dict, *, strict: bool) -> dict:
        """Join the live verdicts into a report object (no-op when the
        analyzer is off).  ``strict`` reports raise the typed
        AnalyzerContradiction on hit + dead verdict; non-strict ones
        (counters spanning a reload, restored history, cumulative and
        merged views) record contradictions in ``totals.static``."""
        sa_obj = self._static_obj
        if sa_obj is None:
            return obj
        from . import staticanalysis

        obj = staticanalysis.attach_static_obj(obj, sa_obj, strict=strict)
        if self.epoch_store is not None:
            # the quiet-horizon join: safe_to_delete verdicts cite when each
            # rule last hit inside retained history, or that it never has
            epochstore.attach_last_hit(obj, self.epoch_store)
        return obj

    # -- internals -------------------------------------------------------
    def _backend(self) -> str:
        return f"torch-{self._device.type}"

    def _render_merged(self, eps: list[WindowEpoch], packed, arrays=None):
        # ``arrays`` lets _publish hand in the SuffixMergeCache's merge
        # (bit-identical by associativity); tracker, meta and quarantine
        # stay per epoch so the rendered report is equal either way
        if arrays is None:
            arrays = merge_register_arrays([ep.arrays for ep in eps])
        tracker = TopKTracker(self.cfg.sketch.topk_capacity)
        for ep in eps:
            for acl, table in ep.tracker_tables.items():
                for src, est in table.items():
                    tracker.offer(int(acl), int(src), int(est))
        drops = sum(ep.meta.get("drops", 0) for ep in eps)
        incomplete = [ep.meta["id"] for ep in eps if ep.meta.get("incomplete")]
        q: dict[tuple, int] = {}
        for ep in eps:
            _merge_quarantine(q, ep.quarantine)
        totals = {
            "lines_total": int(sum(ep.meta["lines"] for ep in eps)),
            "lines_matched": int(sum(ep.meta["parsed"] for ep in eps)),
            "lines_skipped": int(sum(ep.meta["skipped"] for ep in eps)),
            "chunks": int(sum(ep.meta["chunks"] for ep in eps)),
            "window": {
                "merged_windows": [ep.meta["id"] for ep in eps],
                "mode": "lines" if self.scfg.window_lines else "sec",
                "length": self.scfg.window_lines or self.scfg.window_sec,
                "drops": int(drops),
                **(
                    {"incomplete": {"windows": incomplete, "drops": int(drops)}}
                    if incomplete
                    else {}
                ),
            },
        }
        qt = _quarantine_totals(q)
        if qt:
            totals["quarantine"] = qt
        deg = self.degraded_set()
        if deg:
            totals["degraded"] = deg
        return _render(arrays, packed, self.cfg, tracker, topk=self.topk, totals=totals,
                       v6_digests=self._v6_digests, backend=self._backend())

    def _write_json(self, name: str, obj: dict) -> None:
        """Publish one JSON artifact under the serve.publish retry policy.

        The publisher is a non-core subsystem: a transient disk fault
        retries with backoff, and an exhausted budget (or a permanent
        error) degrades the publisher (the in-memory endpoints keep
        serving every report) instead of aborting ingest.  The next
        successful write re-arms it.
        """
        path = os.path.join(self.scfg.serve_dir, name)
        tmp = path + ".tmp"

        def _write():
            faults.fire("serve.publish.fail")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(obj, f, indent=2)
            os.replace(tmp, path)

        try:
            retrypolicy.call("serve.publish", _write)
        except (OSError, AnalysisError) as e:
            self._degrade("publisher", e)
            return
        self._recover("publisher")

    # -- the run loop ----------------------------------------------------
    def run(self) -> dict:
        """Serve until stopped; returns a summary dict (also written to
        ``serve_dir/summary.json``)."""
        from .stream import default_mesh

        scfg = self.scfg
        os.makedirs(scfg.serve_dir, exist_ok=True)
        armed_here = faults.arm_spec(self.cfg.fault_plan)
        retrypolicy.configure(self.cfg.retry_policy)
        if self.cfg.blackbox_dir:
            # the flight recorder runs for the service's lifetime; a typed
            # abort, stall or crash dumps it beside the serve dir
            flightrec.arm(self.cfg.blackbox_dir, role="serve")
        aborted: BaseException | None = None
        try:
            # everything after arming is inside the try: a setup failure
            # (no card, batch geometry, CheckpointMismatch from --resume)
            # still disarms the fault plan and closes the pre-bound
            # listener and HTTP sockets, like a mid-run abort
            if self.ascfg is not None:
                mesh = self._autoscale_mesh()
            else:
                mesh = self._mesh_arg or default_mesh(self.cfg)
                self.world = mesh_lib.data_extent(mesh)
                self._fp_world = self.world
                self.batch_size = mesh_lib.pad_batch_size(self.cfg.batch_size, mesh)
            self.mesh = mesh
            self._device = mesh.local_devices[0]
            if self.packed.bindings_out and self.batch_size < 2:
                raise AnalysisError(
                    "batch_size must be >= 2 when out-direction "
                    "access-groups are bound"
                )
            self._build_kernels()
            self._refresh_devmem()
            self._install_ruleset(self.packed)
            self._v6_digests: dict[int, int] = {}
            self._v6rows: list = []
            self._fp = self._fingerprint(self.packed)
            if scfg.static_analysis:
                # a failure here (the analyze.tile fault site included)
                # degrades the static plane: the service keeps ingesting
                # with /health naming the loss, and the endpoint never
                # serves a partial verdict table
                try:
                    sa, dur = self._compute_static(self.packed, reuse=None)
                except AnalysisError as e:
                    self._degrade("static_analysis", e)
                else:
                    self._publish_static(self.packed, sa, dur)

            # fresh window scaffolding (possibly replaced by resume below)
            self.win_id = 0
            self.cum_arrays = zero_arrays(self.packed.n_keys, self.cfg)
            self.cum_tracker = TopKTracker(self.cfg.sketch.topk_capacity)
            if self.cfg.resume:
                self._restore_ring()
            if scfg.wal:
                self.wal = WriteAheadLog(
                    scfg.wal_dir or os.path.join(scfg.serve_dir, "wal"),
                    segment_bytes=scfg.wal_segment_bytes,
                    budget_bytes=scfg.wal_budget_bytes,
                )
                if not self.cfg.resume:
                    # a fresh run starts a fresh spool: a previous run's
                    # stale tail must neither replay nor grow forever
                    self.wal.reset()
                self._wal_next = (
                    self._wal_resume_seq if self.cfg.resume else self.wal.next_seq
                )
            if scfg.epoch_store:
                # durable history: a fresh run resets it like the WAL; a
                # resumed run re-binds, and the frontier check makes a
                # window-id gap a typed startup refusal
                self.epoch_store = epochstore.EpochStore(
                    scfg.epoch_store,
                    budget_bytes=scfg.epoch_store_budget_bytes,
                    trend_threshold=scfg.trend_threshold,
                )
                if not self.cfg.resume:
                    self.epoch_store.reset()
                self.epoch_store.bind_base(self.win_id)
                self.epoch_store.set_labels(self._rule_labels(self.packed))
            if scfg.lineage:
                # the provenance ledger: O_APPEND jsonl beside the window
                # files; opening it is core setup
                lpath = os.path.join(scfg.serve_dir, LineageLog.NAME)
                if self.cfg.resume:
                    # repopulate the ring-retained /lineage view from the
                    # ledger
                    live = set(self.ring.window_ids())
                    for r in LineageLog.read(lpath):
                        if r.get("kind") != "merged" and r.get("window") in live:
                            self._lineage_recent[r["window"]] = r
                            self.lineage_records_total += 1
                else:
                    # a fresh run, a fresh ledger (the WAL's discipline)
                    try:
                        os.remove(lpath)
                    except OSError:
                        pass
                self._lineage_log = LineageLog(lpath)
            obs.register_sampler("listener", self._sample_metrics)
            obs.register_sampler("serve", self.metrics_gauges)
            # the first window's drop baseline is taken before the listeners
            # start, so a line dropped before the window opens marks it (the
            # reference takes it after, and such a drop marks no window)
            self._next_drops_base = self.queue.snapshot()["dropped"]
            self.listeners.start()
            self._begin_window()
            if self.wal is not None and self.cfg.resume:
                self._replay_wal()
            self._start_http()
            self._start_watcher()
            self._install_signals()
            self._write_json("endpoint.json", {
                "pid": os.getpid(),
                "http": list(self.http_address) if self.http_address else None,
                "listeners": self.listeners.addresses(),
                "serve_dir": os.path.abspath(scfg.serve_dir),
            })
            self._loop()
        except BaseException as e:
            aborted = e
            raise
        finally:
            try:
                self._teardown(aborted)
            finally:
                # disarm on abort paths too: a plan this run armed must
                # not leak into later runs in the same process
                if armed_here:
                    faults.disarm()
        summary = {
            "windows_published": self.windows_published,
            "lines_total": self.total_lines,
            "drops": self.queue.snapshot()["dropped"],
            "reloads": self.reloads,
            "reload_errors": self.reload_errors,
            "quarantine_hits": int(sum(self.cum_quarantine.values())),
            "serve_dir": os.path.abspath(scfg.serve_dir),
            "world": self.world,
            "degraded": self.degraded_set(),
            "degraded_events": self.degraded_events,
            "recovered_events": self.recovered_events,
            "retry": retrypolicy.counters(),
            **({"autoscale": self._engine.summary()} if self._engine is not None else {}),
        }
        if self.wal is not None:
            summary["wal"] = {
                **self.wal.stats(),
                "replayed": self.wal_replayed,
                "lost": self.wal_lost_total,
                "lost_unknown": self.wal_lost_unknown,
            }
        if self.epoch_store is not None:
            summary["epoch_store"] = self.epoch_store.stats()
        self._write_json("summary.json", summary)
        return summary

    def _autoscale_mesh(self) -> mesh_lib.Mesh:
        """The autoscaler's world ladder over the device pool; returns the
        mesh of the initial rung.

        Worlds are the divisors of the maximum on the ladder: the batch is
        padded to the maximum once and never changes, so every chunk
        boundary, and with it the registers, is the same at every world.
        The checkpoint fingerprint pins the maximum, so a ring checkpoint
        taken at one world resumes at any other.
        """
        from .stream import resolve_device

        if self._devices_arg is not None:
            self._devices = self._devices_arg
        elif resolve_device(self.cfg.device).type == "cpu":
            self._devices = [torch.device("cpu")]
        else:
            self._devices = mesh_lib.visible_devices()
        a = self.ascfg
        max_w = a.max_world or len(self._devices)
        if max_w > len(self._devices):
            raise AnalysisError(
                f"--autoscale-max {max_w} exceeds the "
                f"{len(self._devices)} available devices"
            )
        self._ladder = world_ladder(a.min_world, max_w, divisors_of=max_w)
        start = a.initial_world or self._ladder[0]
        if start not in self._ladder:
            raise AnalysisError(
                f"--autoscale-initial {start} is not on the world "
                f"ladder {self._ladder} (divisors of {max_w})"
            )
        self._fp_world = max_w
        self.world = start
        self.batch_size = ((self.cfg.batch_size + max_w - 1) // max_w) * max_w
        self._engine = PolicyEngine(a, world=start, ladder=self._ladder)
        return mesh_lib.make_mesh(self._devices[:start])

    def _build_kernels(self) -> None:
        """Build and load every kernel serve may launch, once, at start:
        first_match6 even for a pure-v4 ruleset, and relation_tile with
        the static analysis, so a reload that brings v6 rows (or
        re-analyzes) never waits on nvcc."""
        from .stream import _build_kernels

        _build_kernels(self.cfg, self.mesh, True,
                       ("relation_tile",) if self.scfg.static_analysis else ())

    def _refresh_devmem(self) -> None:
        """Read the device memory gauges (serve thread only)."""
        self._devmem = devprof.device_memory_gauges(
            self._device if self._device.type == "cuda" else None
        )

    def _fingerprint(self, packed) -> str:
        return ckpt.fingerprint(packed, self.cfg, 0, n_shards=self._fp_world) + "-serve"

    def _install_ruleset(self, packed) -> None:
        """Ship (or re-ship) the rule tensors and build the step functions."""
        self.packed = packed
        self.dev_rules = step_lib.ship(packed, self.mesh)
        self.step = step_lib.make_parallel_step(self.mesh, self.cfg, packed.n_keys)
        self.step6 = None
        self.dev_rules6 = None
        if packed.has_v6:
            self.dev_rules6 = step_lib.ship6(packed, self.mesh)
            self.step6 = step_lib.make_parallel_step6(self.mesh, self.cfg, packed.n_keys)

    # -- window lifecycle ------------------------------------------------
    def _begin_window(self) -> None:
        from .stream import LineBatcher

        self.state = step_lib.init_state(self.packed.n_keys, self.cfg, self.mesh)
        self.tracker = TopKTracker(self.cfg.sketch.topk_capacity)
        self.pending: deque[pipeline.ChunkOut] = deque()
        packer = pack_mod.LinePacker(self.packed)
        self.batcher = LineBatcher(
            packer, self.packed.has_v6, self._v6rows, self._v6_digests, self.batch_size,
        )
        self.n_chunks = 0  # window-local: the candidate-table salt, reset
        # so a window replays exactly like an offline run over its lines
        self.win_lines = 0  # lines committed to emitted batches
        self.win_pushed = 0  # lines handed to the batcher
        self.win_reloads = 0
        self.win_quarantine: dict[tuple, int] = {}
        self._win_wal_drops = 0  # WAL eviction/quarantine losses replayed here
        self._win_wal_unknown = False
        self._buf6 = None
        self._fill6 = 0
        self._win_t0 = time.time()
        # interval math runs on the monotonic clock; the wall stamps are
        # for operator correlation only
        self._win_t0_mono = time.monotonic()
        # receipt stamps of this window's consumed lines, decimated by
        # powers of two past the cap (each retained stamp then counts for
        # ``stride`` lines in the histogram)
        self._win_lat = LatencyHistogram()
        self._win_receipts: list[float] = []
        self._recv_stride = 1
        self._recv_i = 0
        flightrec.cursor(window=self.win_id)
        # the drop baseline carries over from the previous window's close
        # so a drop landing during rotation/publish charges to exactly one
        # window
        base = getattr(self, "_next_drops_base", None)
        self._drops_at_start = base if base is not None else self.queue.snapshot()["dropped"]
        self._listeners_ok_at_start = self.listeners.alive() == len(self.listeners.listeners)
        self._win_saw_stall = False
        # lineage: the first WAL seq this window can cover; rotation
        # stamps the exclusive hi bound from the same cursor
        self._win_wal_lo = int(self._wal_next)

    #: receipt stamps retained per window before stride decimation
    _RECEIPT_CAP = 1 << 16

    def _note_receipt(self, t_recv: float) -> None:
        """Retain one consumed line's receipt stamp for the window's
        ingest->publish latency histogram (stride-decimated, bounded)."""
        if self._recv_i % self._recv_stride == 0:
            self._win_receipts.append(t_recv)
            if len(self._win_receipts) >= self._RECEIPT_CAP:
                self._win_receipts = self._win_receipts[::2]
                self._recv_stride *= 2
        self._recv_i += 1

    def _drain(self, out: pipeline.ChunkOut) -> None:
        self.tracker.offer_chunk(out.cand_acl.cpu(), out.cand_src.cpu(), out.cand_est.cpu())

    def _kind(self, base: str) -> str:
        # per-world dispatch kinds under the autoscaler: each rung's first
        # dispatches are priced apart from another's
        return base if self._engine is None else f"{base}w{self.world}"

    def _dispatch(self, kind: str, step, rules, shards) -> None:
        """Step one chunk (salt = the window-local chunk index), with the
        run loop's trace span and devprof seam; candidates drain with a
        2-chunk lag."""
        rec = obs.recording()
        t0 = time.perf_counter() if rec else 0.0
        batches = [b.use() for b in shards]
        cap = devprof.active_capture()
        if cap is None:
            self.state, out = step(self.state, rules, batches, salt=self.n_chunks)
        else:
            label = "step.v6" if kind == "v6" else f"step.{self.cfg.layout}"
            self.state, out = cap.dispatch(label, step,
                                           (self.state, rules, batches, self.n_chunks),
                                           device=self._device)
        if rec:
            obs.complete("step.dispatch", t0, time.perf_counter(), cat="step",
                         args={"kind": self._kind(kind)})
        self.pending.append(out)
        if len(self.pending) > 2:
            self._drain(self.pending.popleft())
        self.n_chunks += 1

    def _run_chunk(self, batch_np: np.ndarray) -> None:
        shards = mesh_lib.shard_batch(self.mesh, pack_mod.compact_batch(batch_np))
        self._dispatch("v4", self.step, self.dev_rules, shards)

    def _run_chunk6(self, batch6_np: np.ndarray) -> None:
        shards = mesh_lib.shard_batch(self.mesh, batch6_np)
        self._dispatch("v6", self.step6, self.dev_rules6, shards)

    def _stage_v6(self) -> None:
        # the run loop's v6 staging: drain staged rows, step full v6
        # chunks; a partial chunk waits for the flush
        if self.step6 is None:
            return
        if not self._v6rows:
            return
        # drain in place: the batcher holds a reference to this list
        rows = self._v6rows[:]
        del self._v6rows[:]
        i = 0
        while i < len(rows):
            if self._buf6 is None:
                self._buf6 = np.zeros((pack_mod.TUPLE6_COLS, self.batch_size), dtype=np.uint32)
            take = min(self.batch_size - self._fill6, len(rows) - i)
            self._buf6[:, self._fill6:self._fill6 + take] = np.asarray(
                rows[i:i + take], dtype=np.uint32
            ).T
            self._fill6 += take
            i += take
            if self._fill6 == self.batch_size:
                self._run_chunk6(self._buf6)
                self._buf6 = None
                self._fill6 = 0

    def _flush_v6(self) -> None:
        if self.step6 is None:
            return
        self._stage_v6()
        if self._fill6:
            self._run_chunk6(self._buf6)
            self._buf6 = None
            self._fill6 = 0

    def _consume_event(self, ev: tuple[np.ndarray | None, int]) -> None:
        batch_np, n_raw = ev
        if batch_np is None:
            self.win_lines += n_raw
            obs.add_lines(n_raw)
            self._stage_v6()
            return
        self._run_chunk(batch_np)
        self._stage_v6()
        self.win_lines += n_raw
        obs.add_lines(n_raw)

    def _flush_inflight(self) -> None:
        """Step everything consumed so far and wait for the card
        (rotation/reload barrier)."""
        from .stream import _sync

        tail = self.batcher.flush()
        if tail is not None:
            self._consume_event(tail)
        self._flush_v6()
        _sync(self.mesh)
        while self.pending:
            self._drain(self.pending.popleft())

    # -- durable ingest WAL ----------------------------------------------
    def _replay_wal(self) -> None:
        """Replay the spool tail past the restored checkpoint's seq.

        Runs before live consumption: the interrupted window (and any
        rotated-but-uncheckpointed windows: ids and boundaries are
        deterministic) rebuilds from the on-disk records through the
        normal consume path, so its report equals what an uninterrupted
        run would have published over the same delivered lines.  Eviction
        gaps and quarantined segments surface as exactly counted drops
        with the ``wal_lost`` incomplete reason.
        """
        n = 0
        noted = 0  # losses already charged to a window
        # windows that rotate during replay publish with path="replay"
        self._path = "replay"
        with obs.span("serve.wal.replay", from_seq=self._wal_resume_seq):
            for seq, line, _tenant in self.wal.replay(self._wal_resume_seq):
                # charge losses to the window open when they were observed
                if self.wal.replay_lost > noted:
                    self._note_wal_loss(self.wal.replay_lost - noted, False)
                    noted = self.wal.replay_lost
                for ev in self.batcher.push(line):
                    self._consume_event(ev)
                # the replayed lines' receipt stamps died with the previous
                # process; the replay instant is the conservative stand-in
                self._note_receipt(time.monotonic())
                self.win_pushed += 1
                self.lines_consumed_total += 1
                self._wal_next = seq + 1
                n += 1
                if self.scfg.window_lines and self.win_pushed >= self.scfg.window_lines:
                    self._rotate()
        self._path = "live"
        self.wal_replayed = n
        if self.wal.replay_lost > noted or self.wal.replay_lost_unknown:
            self._note_wal_loss(self.wal.replay_lost - noted, self.wal.replay_lost_unknown)
        obs.metric_event(
            "serve.wal.replay", replayed=n, lost=self.wal.replay_lost,
            lost_unknown=self.wal.replay_lost_unknown,
            quarantined=len(self.wal.quarantined),
        )

    def _note_wal_loss(self, lost: int, unknown: bool) -> None:
        self._win_wal_drops += lost
        self.wal_lost_total += lost
        if unknown:
            self._win_wal_unknown = True
            self.wal_lost_unknown = True

    # -- rotation + publication ------------------------------------------
    def _window_meta(self, *, partial: bool) -> dict:
        drops = self.queue.snapshot()["dropped"] - self._drops_at_start
        self._next_drops_base = self._drops_at_start + drops
        listeners_ok = self.listeners.alive() == len(self.listeners.listeners)
        reasons = []
        if drops > 0:
            reasons.append("dropped_lines")
        if self._listeners_ok_at_start and not listeners_ok:
            reasons.append("listener_died")
        if not self._listeners_ok_at_start:
            reasons.append("listener_down")
        if self._win_saw_stall or self.listeners.stalled(self.cfg.stall_timeout_sec):
            reasons.append("listener_stalled")
        if self._win_wal_drops or self._win_wal_unknown:
            # WAL eviction/quarantine losses replayed into this window
            reasons.append("wal_lost")
            drops += self._win_wal_drops
        packer = self.batcher.packer
        meta = {
            "id": self.win_id,
            "mode": "lines" if self.scfg.window_lines else "sec",
            "length": self.scfg.window_lines or self.scfg.window_sec,
            "lines": self.win_lines,
            "parsed": packer.parsed,
            "skipped": packer.skipped,
            "chunks": self.n_chunks,
            "drops": int(drops),
            "reloads": self.win_reloads,
            "started_unix": round(self._win_t0, 3),
            "ended_unix": round(time.time(), 3),
            "elapsed_sec": round(time.monotonic() - self._win_t0_mono, 4),
        }
        if self._win_wal_drops or self._win_wal_unknown:
            meta["wal_lost"] = int(self._win_wal_drops)
            if self._win_wal_unknown:
                meta["wal_lost_unknown"] = True
        if partial:
            meta["partial"] = True
        if reasons:
            # the typed WindowIncomplete marker: "0 hits" here must not
            # read as unused
            meta["incomplete"] = {"drops": int(drops), "reasons": reasons}
        return meta

    def _window_totals(
        self,
        meta: dict,
        quarantine: dict[tuple, int],
        latency: dict | None = None,
    ) -> dict:
        # monotonic-derived where available (live rotations); restored
        # epochs fall back to the wall difference
        elapsed = meta.get(
            "elapsed_sec", max(meta["ended_unix"] - meta["started_unix"], 0.0)
        )
        totals = {
            "lines_total": meta["lines"],
            "lines_matched": meta["parsed"],
            "lines_skipped": meta["skipped"],
            "chunks": meta["chunks"],
            "elapsed_sec": round(elapsed, 4),
            "lines_per_sec": round(meta["lines"] / elapsed, 1) if elapsed > 0 else 0.0,
            "window": meta,
        }
        if latency:
            # receipt->publish percentiles of this window (volatile)
            totals["latency"] = {"ingest_to_publish": latency}
        qt = _quarantine_totals(quarantine)
        if qt:
            totals["quarantine"] = qt
        deg = self.degraded_set()
        if deg:
            totals["degraded"] = deg
        return totals

    def _render_window_obj(self, ep: WindowEpoch) -> dict:
        """Re-render one epoch's window report (resume repopulation)."""
        tracker = TopKTracker(self.cfg.sketch.topk_capacity)
        for acl, table in ep.tracker_tables.items():
            for src, est in table.items():
                tracker.offer(int(acl), int(src), int(est))
        rep = _render(ep.arrays, self.packed, self.cfg, tracker, topk=self.topk,
                      totals=self._window_totals(ep.meta, ep.quarantine),
                      v6_digests=self._v6_digests, backend=self._backend())
        # restored history may predate the analyzed ruleset: annotate,
        # never abort, on a contradiction
        return self._attach_static(json.loads(rep.to_json()), strict=False)

    def _rotate(self, *, partial: bool = False) -> None:
        # a closed devprof capture window parses here, between windows,
        # never on the ingest path
        cap = devprof.active_capture()
        if cap is not None:
            try:
                cap.poll()
            except AnalysisError as e:
                # devprof is non-core: a failed parse degrades it
                self._degrade("devprof", e)
        with obs.span("serve.rotate", window=self.win_id):
            self._flush_inflight()
            # the publish instant of this window's latency clock: every
            # retained receipt stamp becomes one stride-weighted sample
            t_pub = time.monotonic()
            for t_recv in self._win_receipts:
                self._win_lat.record(max(t_pub - t_recv, 0.0), n=self._recv_stride)
            self.lat_cum.merge(self._win_lat)
            win_latency = self._win_lat.summary() if self._win_lat.count else None
            win_hist = self._win_lat  # survives _begin_window's reset
            meta = self._window_meta(partial=partial)
            arrays = pipeline.state_to_numpy(self.state[0])
            self._refresh_devmem()
            ep = WindowEpoch(
                arrays=arrays,
                meta=meta,
                tracker_tables=self.tracker.tables(),
                quarantine=dict(self.win_quarantine),
            )
            rep = _render(arrays, self.packed, self.cfg, self.tracker, topk=self.topk,
                          totals=self._window_totals(meta, self.win_quarantine,
                                                     latency=win_latency),
                          v6_digests=self._v6_digests, backend=self._backend())
            # strict contradiction check only when every counter of this
            # window was earned under the analyzed ruleset (no reload
            # mid-window) and the counters are exact
            rep_obj = self._attach_static(
                json.loads(rep.to_json()),
                strict=meta.get("reloads", 0) == 0 and self.cfg.exact_counts,
            )
            if self.scfg.lineage:
                # provenance, assembled while the closed window's WAL
                # cursor and quarantine are still live state
                rep_obj["totals"]["lineage"] = self._assemble_lineage(meta, self.win_quarantine)
            if meta.get("incomplete"):
                self.cum_incomplete_windows.append(meta["id"])
                for r in meta["incomplete"]["reasons"]:
                    if r not in self.cum_incomplete_reasons:
                        self.cum_incomplete_reasons.append(r)
            with self._pub_lock:
                self.ring.push(ep)
                prev = self._published.get("report")
                # quarantine merges under the lock: /health sums it
                _merge_quarantine(self.cum_quarantine, self.win_quarantine)
            # cumulative accounting
            self.cum_arrays = merge_register_arrays([self.cum_arrays, arrays])
            for acl, table in ep.tracker_tables.items():
                for src, est in table.items():
                    self.cum_tracker.offer(int(acl), int(src), int(est))
            self.total_lines += meta["lines"]
            self.total_parsed += meta["parsed"]
            self.total_skipped += meta["skipped"]
            self.total_chunks += meta["chunks"]
            # the next window opens here, before the (slow) publish and
            # ring checkpoint: a /health poll or reload request arriving
            # mid-rotation sees the new window id with zero pushed lines
            self.win_id += 1
            self._begin_window()
            self.windows_published += 1
            flightrec.cursor(windows_published=self.windows_published,
                             wal_seq=int(self._wal_next))
            obs.metric_event("serve.window", id=meta["id"], lines=meta["lines"],
                             chunks=meta["chunks"], drops=meta["drops"])
            # host-tier hook (distributed serve overrides it)
            self._emit_epoch(ep)
            # durable history: every rotation spills, so the store's
            # frontier tracks publication and the ring's eviction only
            # marks when the store becomes the one copy
            self._spill_epoch(ep)
            if self._suffix is not None:
                self._suffix.push(meta["id"], arrays)
            self._publish(rep_obj, prev, meta)
            self._observe_slo(meta, win_hist)
            if (
                self.scfg.checkpoint_every_windows
                and self.windows_published % self.scfg.checkpoint_every_windows == 0
            ):
                self._save_ring_ckpt()

    #: lineage record kind this driver publishes
    _lineage_kind = "window"

    def _assemble_lineage(self, meta: dict, quarantine: dict) -> dict:
        """The closed window's sealed provenance record.

        Everything except ``term``/``path``/``published_unix``/``crc`` is a
        deterministic function of the delivered lines.
        """
        rec: dict = {
            "window": meta["id"],
            "kind": self._lineage_kind,
            "hosts": [{
                "rank": int(getattr(self, "rank", 0)),
                "wal_seq_lo": int(self._win_wal_lo),
                "wal_seq_hi": int(self._wal_next),
                "drops": int(meta.get("drops", 0)),
                "quarantine_hits": int(sum(quarantine.values())),
            }],
            "generation": int(self.reloads),
            "term": int(self.term),
            "path": self._path,
            "published_unix": round(time.time(), 3),
        }
        if meta.get("incomplete"):
            rec["incomplete"] = meta["incomplete"]
        return seal_lineage(rec)

    def _lineage_append(self, rec: dict) -> None:
        """Ledger a publication's lineage record: a core step.

        The jsonl append happens before the window file is written and
        lets failures propagate typed: a window never publishes without
        its provenance (the ``lineage.append`` site).
        """
        if self._lineage_log is not None:
            self._lineage_log.append(rec)
        with self._pub_lock:
            if rec.get("kind") == "merged":
                self._lineage_merged[rec["k"]] = rec
            else:
                self._lineage_recent[rec["window"]] = rec
                live = set(self.ring.window_ids())
                for wid in [w for w in self._lineage_recent if w not in live]:
                    del self._lineage_recent[wid]
        self.lineage_records_total += 1

    def lineage_tail(self) -> dict:
        """The ``/lineage`` HTTP view: ring-retained records."""
        with self._pub_lock:
            recs = [self._lineage_recent[w] for w in sorted(self._lineage_recent)]
            merged = [self._lineage_merged[k] for k in sorted(self._lineage_merged)]
        out = {
            "records": recs,
            "merged": merged,
            "records_total": self.lineage_records_total,
        }
        if self.epoch_store is not None:
            # the durable-history frontier: which windows survived a crash
            out["epoch_store"] = self.epoch_store.frontier()
        return out

    def lineage_record(self, wid: int) -> dict | None:
        with self._pub_lock:
            return self._lineage_recent.get(wid)

    def _observe_slo(self, meta: dict, hist=None) -> None:
        """Feed one published window to the burn-rate engine (--slo)."""
        if self.slo is None:
            return
        stats = window_slo_stats(
            hist if (hist is not None and hist.count) else None,
            lines=int(meta.get("lines", 0)),
            drops=int(meta.get("drops", 0)),
            incomplete=bool(meta.get("incomplete")),
            degraded=len(self.degraded_set()),
            window=meta.get("id"),
        )
        events = self.slo.observe(stats)
        for ev in events:
            # a typed obs instant (reaches the flight ring) and a metrics
            # JSONL event: slo.breach / slo.recovered
            obs.typed_event(ev.pop("event"), **ev)
        if events:
            flightrec.cursor(slo_breached=sum(1 for b in self.slo._breached.values() if b))

    def _emit_epoch(self, ep: WindowEpoch) -> None:
        """A closed window leaves the service (no-op hook).

        A distributed serve host would override this to hand the epoch to
        the cross-host merge tier; the single-host service is its own
        merge tier (the ring push already happened).
        """

    @staticmethod
    def _rule_labels(packed) -> list[tuple]:
        """(firewall, acl, index) per key id: the epoch store's last-hit
        and trend planes name rules as the static classes do."""
        return [(m.firewall, m.acl, m.index) for m in packed.key_meta]

    def _spill_epoch(self, ep: WindowEpoch) -> None:
        """Durably spill the closed window into the epoch store.

        A spill failure (the ``epochstore.spill`` site, or a full or
        read-only volume) degrades the ``epoch_store`` subsystem and
        publication goes on: history's frontier freezes visibly (/health,
        /lineage, the gauges) and stays frozen, since resuming spills
        mid-run would leave a window-id gap in the store's dense numbering.
        """
        store = self.epoch_store
        if store is None or "epoch_store" in self.degraded_set():
            return
        try:
            store.spill(ep)
        except AnalysisError as e:
            self._degrade("epoch_store", e)
        else:
            flightrec.cursor(epochstore_window=int(ep.meta["id"]),
                             epochstore_levels=len(store._chains))

    def range_report_obj(self, frm: str | None, to: str | None) -> dict:
        """The ``/report/range`` answer: a full report rendered from at most
        ``2 log2 n`` stored aggregates, or the typed range_incomplete marker
        when the store cannot cover the span completely."""
        store = self.epoch_store
        if store is None:
            return {"error": "epoch store not armed (serve --epoch-store)"}
        t0 = time.monotonic()
        try:
            lo, hi = store.resolve_range(frm, to)
        except AnalysisError as e:
            return {"error": str(e)}
        agg, marker = store.range_agg(lo, hi)
        if marker is not None:
            return marker
        with self._pub_lock:
            packed = self.packed
        obj = self._attach_static(
            json.loads(render_range_report(
                agg, packed, self.cfg, topk=self.topk, v6_digests=self._v6_digests,
                window_extra={
                    "mode": "lines" if self.scfg.window_lines else "sec",
                    "length": self.scfg.window_lines or self.scfg.window_sec,
                },
                backend=self._backend(),
            ).to_json()),
            strict=False,
        )
        self.lat_range.record(time.monotonic() - t0)
        return obj

    def _publish(self, rep_obj: dict, prev: dict | None, meta: dict) -> None:
        with obs.span("serve.publish", window=meta["id"]):
            # cumulative counters may span reloads: contradictions there
            # annotate rather than abort
            cum_obj = self._attach_static(
                json.loads(self._render_cumulative().to_json()), strict=False
            )
            diff_obj = None
            if prev is not None:
                # window-over-window churn via the diff-reports machinery
                diff_obj = diff_report_objs(prev, rep_obj, top=self.topk)
                diff_obj["windows"] = [
                    prev["totals"].get("window", {}).get("id"),
                    meta["id"],
                ]
                if self.scfg.trend_threshold > 0:
                    # per-rule rate trends with hysteresis: an event only
                    # on a label transition
                    evs = trend_events(
                        prev, rep_obj,
                        threshold=self.scfg.trend_threshold,
                        state=self._trend_state,
                    )
                    if evs:
                        diff_obj["trend_events"] = evs
                        self.trend_events_total += len(evs)
                        for ev in evs:
                            obs.typed_event(ev["event"], **{
                                k: v for k, v in ev.items() if k != "event"
                            })
            # the lineage ledger append comes before the window file exists
            lin = rep_obj.get("totals", {}).get("lineage")
            if lin is not None:
                self._lineage_append(lin)
            with self._pub_lock:
                self._published["report"] = rep_obj
                self._published["cumulative"] = cum_obj
                if diff_obj is not None:
                    self._published["diff"] = diff_obj
                self._window_reports[meta["id"]] = rep_obj
                # the in-memory per-window map stays bounded by the ring
                live = set(self.ring.window_ids())
                evicted = [w for w in self._window_reports if w not in live]
                for wid in evicted:
                    del self._window_reports[wid]
            # the ring is the retention policy on disk too
            for wid in evicted:
                for name in (f"window-{wid:06d}.json", f"diff-{wid:06d}.json"):
                    try:
                        os.remove(os.path.join(self.scfg.serve_dir, name))
                    except OSError:
                        pass
            self._write_json(f"window-{meta['id']:06d}.json", rep_obj)
            self._write_json("latest.json", rep_obj)
            self._write_json("cumulative.json", cum_obj)
            if diff_obj is not None:
                self._write_json(f"diff-{meta['id']:06d}.json", diff_obj)
            for k in self.scfg.views:
                eps = self.ring.last(k)
                if eps:
                    # serve-thread render: the serve thread is the only
                    # mutator of ring and packed.  The suffix cache answers
                    # the K-fold when its retained ids match the ring
                    # exactly; any mismatch falls back to the full fold
                    cached = None
                    if self._suffix is not None:
                        cached = self._suffix.merged(k, [ep.meta["id"] for ep in eps])
                    merged_obj = self._attach_static(
                        json.loads(self._render_merged(eps, self.packed,
                                                       arrays=cached).to_json()),
                        strict=False,
                    )
                    if self.scfg.lineage:
                        # merged-K provenance: the parent-window links
                        # (in memory and in the merged JSON only)
                        mrec = seal_lineage({
                            "window": meta["id"],
                            "kind": "merged",
                            "k": k,
                            "parents": [ep.meta["id"] for ep in eps],
                            "term": int(self.term),
                            "path": self._path,
                            "published_unix": round(time.time(), 3),
                        })
                        merged_obj["totals"]["lineage"] = mrec
                        with self._pub_lock:
                            self._lineage_merged[k] = mrec
                    self._write_json(f"merged-{k}.json", merged_obj)

    def _render_cumulative(self):
        # rendered only from _publish, after _rotate merged the window's
        # quarantine into the cumulative bucket
        q = self.cum_quarantine
        drops = self.drops_restored + int(self.queue.snapshot()["dropped"])
        totals = {
            "lines_total": self.total_lines,
            "lines_matched": self.total_parsed,
            "lines_skipped": self.total_skipped,
            "chunks": self.total_chunks,
            "window": {
                "cumulative": True,
                "windows": self.windows_published,
                # restored history's drops + this process's
                "drops": drops,
            },
        }
        reasons = list(self.cum_incomplete_reasons)
        if drops and "dropped_lines" not in reasons:
            reasons.append("dropped_lines")
        if drops or reasons:
            # any window lost traffic: the cumulative view says so
            totals["window"]["incomplete"] = {
                "drops": drops,
                "reasons": reasons,
                "windows": list(self.cum_incomplete_windows),
            }
        if self.lat_cum.count:
            totals["latency"] = {"ingest_to_publish": self.lat_cum.summary()}
        qt = _quarantine_totals(q)
        if qt:
            totals["quarantine"] = qt
        deg = self.degraded_set()
        if deg:
            totals["degraded"] = deg
        return _render(self.cum_arrays, self.packed, self.cfg, self.cum_tracker,
                       topk=self.topk, totals=totals, v6_digests=self._v6_digests,
                       backend=self._backend())

    # -- ring checkpointing ----------------------------------------------
    def _save_ring_ckpt(self) -> None:
        arrays: dict[str, np.ndarray] = {}
        wmeta = []
        for ep in self.ring.epochs:
            pfx = f"w{ep.meta['id']:06d}__"
            for k, v in ep.arrays.items():
                arrays[pfx + k] = v
            wmeta.append({
                "meta": ep.meta,
                "tracker": [
                    [int(acl), [[int(s), int(e)] for s, e in t.items()]]
                    for acl, t in ep.tracker_tables.items()
                ],
                "quarantine": [
                    [fw, acl, idx, text, int(h)]
                    for (fw, acl, idx, text), h in sorted(ep.quarantine.items())
                ],
            })
        for k, v in self.cum_arrays.items():
            arrays["cum__" + k] = v
        snap = ckpt.Snapshot(
            arrays=arrays,
            lines_consumed=self.total_lines,
            n_chunks=self.total_chunks,
            parsed=self.total_parsed,
            skipped=self.total_skipped,
            tracker_tables=self.cum_tracker.tables(),
            fingerprint=self._fp,
            extra={
                "serve": {
                    # win_id is the already-open window (the rotation
                    # opened it before checkpointing); a resume restarts
                    # it from empty under the same id
                    "next_window": self.win_id,
                    "windows_published": self.windows_published,
                    "windows": wmeta,
                    "reloads": self.reloads,
                    "quarantine": [
                        [fw, acl, idx, text, int(h)]
                        for (fw, acl, idx, text), h in sorted(self.cum_quarantine.items())
                    ],
                    "v6_digests": [[int(d), int(s)] for d, s in self._v6_digests.items()],
                    "incomplete_reasons": list(self.cum_incomplete_reasons),
                    "incomplete_windows": list(self.cum_incomplete_windows),
                    "drops": self.drops_restored + int(self.queue.snapshot()["dropped"]),
                    # seq of the next line to consume: the WAL replay
                    # cursor a resume starts from (0 with the WAL off)
                    "wal_seq": int(self._wal_next),
                    "wal_lost": int(self.wal_lost_total),
                }
            },
        )
        ckpt.save(self.scfg.checkpoint_dir or self._default_ckpt_dir(), snap)
        if self.wal is not None:
            # the checkpoint covers every record below _wal_next: make the
            # spool durable, then release covered segments
            self.wal.sync()
            self.wal.gc(self._wal_next)

    def _default_ckpt_dir(self) -> str:
        return os.path.join(self.scfg.serve_dir, "ckpt")

    def _restore_ring(self) -> None:
        snap = ckpt.load(self.scfg.checkpoint_dir or self._default_ckpt_dir())
        if snap is None:
            return
        if snap.fingerprint != self._fp:
            raise ckpt.CheckpointMismatch(
                "serve checkpoint was taken with a different ruleset, "
                "sketch geometry, or mesh; refusing to resume the window "
                "ring (delete the serve checkpoint dir to start fresh)"
            )
        sv = (snap.extra or {}).get("serve")
        if not sv:
            raise ckpt.CheckpointCorrupt("serve checkpoint manifest lacks the serve extra block")
        self.total_lines = snap.lines_consumed
        self.total_chunks = snap.n_chunks
        self.total_parsed = snap.parsed
        self.total_skipped = snap.skipped
        self.cum_tracker = ckpt.restore_tracker(snap, self.cfg.sketch.topk_capacity)
        self.cum_arrays = {
            k[len("cum__"):]: v for k, v in snap.arrays.items() if k.startswith("cum__")
        }
        self.win_id = int(sv["next_window"])
        self.windows_published = int(sv.get("windows_published", 0))
        self.reloads = int(sv.get("reloads", 0))
        self.cum_quarantine = {
            (fw, acl, int(idx), text): int(h)
            for fw, acl, idx, text, h in sv.get("quarantine", [])
        }
        self._v6_digests.update({int(d): int(s) for d, s in sv.get("v6_digests", [])})
        self.cum_incomplete_reasons = list(sv.get("incomplete_reasons", []))
        self.cum_incomplete_windows = [int(w) for w in sv.get("incomplete_windows", [])]
        self.drops_restored = int(sv.get("drops", 0))
        self._wal_resume_seq = int(sv.get("wal_seq", 0))
        self.wal_lost_total = int(sv.get("wal_lost", 0))
        for w in sv.get("windows", []):
            meta = w["meta"]
            pfx = f"w{meta['id']:06d}__"
            ep = WindowEpoch(
                arrays={k[len(pfx):]: v for k, v in snap.arrays.items() if k.startswith(pfx)},
                meta=meta,
                tracker_tables={
                    int(acl): {int(s): int(e) for s, e in t} for acl, t in w.get("tracker", [])
                },
                quarantine={
                    (fw, acl, int(idx), text): int(h)
                    for fw, acl, idx, text, h in w.get("quarantine", [])
                },
            )
            self.ring.push(ep)
        # repopulate the publication surface from the restored ring:
        # /report and /report/window/<id> serve the checkpointed history
        # at once (and the first post-resume diff runs against the
        # pre-restart window)
        for ep in self.ring.epochs:
            self._window_reports[ep.meta["id"]] = self._render_window_obj(ep)
        if self.ring.epochs:
            self._published["report"] = self._window_reports[self.ring.epochs[-1].meta["id"]]
            self._published["cumulative"] = self._attach_static(
                json.loads(self._render_cumulative().to_json()),
                strict=False,  # restored counters may predate the ruleset
            )

    # -- metrics-driven autoscaling ---------------------------------------
    def _maybe_autoscale(self) -> None:
        """Sample the signals behind the rate/backpressure gauges; decide
        and act when the autoscaler is armed.

        Runs every loop iteration but samples only at the poll cadence
        (``ascfg.poll_sec``, else 1 s).  The signals are the gauges
        ``/metrics`` exports: pressure is the listener queue's occupancy
        (the device tier is behind the offered load), starvation that the
        loop drained the queue and consumed nothing since the last sample
        (capacity is idle).  The device memory gauges refresh here too.
        """
        now = time.monotonic()
        if now < self._as_next:
            return
        poll = self.ascfg.poll_sec if self.ascfg is not None else 1.0
        self._as_next = now + poll
        q = self.queue.snapshot()
        pressure = q["depth"] / q["capacity"]
        consumed = self.lines_consumed_total
        starved = 1.0 if (consumed == self._as_consumed_last and q["depth"] == 0) else 0.0
        with self._gauge_lock:
            if self._as_last_t is not None:
                dt = now - self._as_last_t
                self._pressure_sec += pressure * dt
                self._starved_sec += starved * dt
                self._rate_inst = (consumed - self._as_consumed_last) / dt if dt > 0 else 0.0
            self._as_last_t = now
            self._as_consumed_last = consumed
            self._last_pressure = pressure
            self._last_starved = starved
        self._refresh_devmem()
        if self._engine is None:
            return
        dec = self._engine.observe(
            now=now,
            pressure=pressure,
            starvation=starved,
            gauges={
                "queue_depth": q["depth"],
                "queue_capacity": q["capacity"],
                "lines_consumed_total": consumed,
                "world": self.world,
            },
        )
        if dec is not None and dec.actuate:
            self._apply_scale(dec)

    def _apply_scale(self, dec) -> None:
        """Re-form the serve mesh at the decided world (a planned event).

        No flush and no extra step: the batcher and the v6 staging are
        host state and the registers move exactly, so the chunk boundaries
        (and the registers) are those of a fixed-world run over the same
        lines.  Only the in-flight candidate outputs drain first: they are
        tensors of the outgoing mesh.
        """
        with obs.span("autoscale.apply", seq=dec.seq, direction=dec.direction,
                      from_world=dec.from_world, to_world=dec.to_world):
            # the chaos seam: a failing actuation leaves the old mesh
            # serving or aborts typed, so it fires before any mutation
            faults.fire("autoscale.spawn")
            while self.pending:
                self._drain(self.pending.popleft())
            arrays = pipeline.state_to_numpy(self.state[0])
            k = dec.to_world
            mesh = mesh_lib.make_mesh(self._devices[:k])
            with self._pub_lock:  # /health reads world
                self.mesh = mesh
                self.world = k
            self._device = mesh.local_devices[0]
            self._install_ruleset(self.packed)  # re-ship, rebuild the steps
            self.state = step_lib.replicate(
                pipeline.state_from_numpy(arrays, self._device), mesh)
        self._engine.applied(dec, now=time.monotonic())
        obs.metric_event("autoscale.applied", seq=dec.seq, world=k,
                         time_to_effect_sec=dec.evidence.get("time_to_effect_sec"))

    # -- hot reload -------------------------------------------------------
    def _maybe_reload(self) -> None:
        if not self._reload_req.is_set():
            return
        self._reload_req.clear()
        with obs.span("serve.reload"):
            try:
                self._do_reload()
            except _ReloadFlushError as e:
                raise e.__cause__  # step failure, not a reload failure
            except (AnalysisError, ValueError, OSError) as e:
                # atomic failure: nothing was swapped, the old tensors and
                # counters keep serving; the error is visible in /health
                self.reload_errors += 1
                self.last_reload_error = str(e)
                obs.instant("serve.reload.failed", args={"error": str(e)[:200]})

    def _do_reload(self) -> None:
        from .stream import LineBatcher

        old_packed = self.packed
        new_packed = pack_mod.load_packed(self.prefix)
        # the fault site first: a reload that dies mid-swap must leave the
        # old tensors, registers and in-flight batch intact
        faults.fire("reload.midbatch")
        mig = build_migration(old_packed, new_packed)
        # re-analyze the new ruleset before anything swaps (changed ACLs
        # only); a failure here is an atomic reload failure, so the
        # previous complete verdict set keeps serving
        sa_new = dur_new = None
        if self.scfg.static_analysis:
            sa_new, dur_new = self._compute_static(new_packed, reuse=self._sa)
        # step everything parsed under the old ruleset through the old
        # step: gids and keys in flight belong to the old space
        try:
            self._flush_inflight()
        except Exception as e:
            raise _ReloadFlushError() from e
        # build everything the swap needs off the publish lock: the new
        # rule tensors, step functions and batcher, and the migrated
        # state as new tensors (nothing is written into a live one)
        dev_rules = step_lib.ship(new_packed, self.mesh)
        step = step_lib.make_parallel_step(self.mesh, self.cfg, new_packed.n_keys)
        dev_rules6 = step6 = None
        if new_packed.has_v6:
            dev_rules6 = step_lib.ship6(new_packed, self.mesh)
            step6 = step_lib.make_parallel_step6(self.mesh, self.cfg, new_packed.n_keys)
        old_packer = self.batcher.packer
        packer = pack_mod.LinePacker(new_packed)
        packer.parsed, packer.skipped = old_packer.parsed, old_packer.skipped
        batcher = LineBatcher(
            packer, new_packed.has_v6, self._v6rows, self._v6_digests, self.batch_size,
        )
        new_state = None
        q: dict[tuple, int] = {}
        if not mig.identity:
            arrays = pipeline.state_to_numpy(self.state[0])
            new_arrays, q = migrate_arrays(arrays, mig, old_packed, self.cfg)
            new_state = step_lib.replicate(
                pipeline.state_from_numpy(new_arrays, self._device), self.mesh
            )
        # one publish-locked swap: ring epochs, cumulative image, live
        # state, rule tensors, steps, batcher and the static verdict table
        # move to the new key space together
        sa_obj_new = sa_new.to_obj(new_packed) if sa_new is not None else None
        with self._pub_lock:
            if not mig.identity:
                _merge_quarantine(self.win_quarantine, q)
                for ep in self.ring.epochs:
                    ep_arrays, ep_q = migrate_arrays(ep.arrays, mig, old_packed, self.cfg)
                    ep.arrays = ep_arrays
                    _merge_quarantine(ep.quarantine, ep_q)
                    ep.meta["migrated"] = ep.meta.get("migrated", 0) + 1
                    new_tables, dropped = migrate_tracker_tables(ep.tracker_tables, mig)
                    ep.tracker_tables = new_tables
                    self.talker_entries_dropped += dropped
                self.cum_arrays, cq = migrate_arrays(self.cum_arrays, mig, old_packed, self.cfg)
                _merge_quarantine(self.cum_quarantine, cq)
                cum_tables, cdrop = migrate_tracker_tables(self.cum_tracker.tables(), mig)
                self.talker_entries_dropped += cdrop
                self.cum_tracker = TopKTracker(self.cfg.sketch.topk_capacity)
                for acl, table in cum_tables.items():
                    for src, est in table.items():
                        self.cum_tracker.offer(acl, src, est)
                win_tables, wdrop = migrate_tracker_tables(self.tracker.tables(), mig)
                self.talker_entries_dropped += wdrop
                self.tracker = TopKTracker(self.cfg.sketch.topk_capacity)
                for acl, table in win_tables.items():
                    for src, est in table.items():
                        self.tracker.offer(acl, src, est)
                self.state = new_state
            self.packed = new_packed
            self.dev_rules = dev_rules
            self.step = step
            self.dev_rules6 = dev_rules6
            self.step6 = step6
            self.batcher = batcher
            if sa_new is not None:
                self._install_static(sa_new, sa_obj_new, dur_new)
        if sa_new is not None:
            self._static_side_effects(sa_obj_new, dur_new)
        self._fp = self._fingerprint(new_packed)
        self.reloads += 1
        self.win_reloads += 1
        if not mig.identity:
            if self._suffix is not None:
                # the cached suffix merges are old-key-space images the ring
                # migration above just invalidated
                self._suffix.invalidate()
            if self.epoch_store is not None:
                # windows from the open one on live in the new key space:
                # the store refuses ranges reaching across, and no summary
                # node straddles the boundary
                self.epoch_store.mark_era(self.win_id, self.reloads)
        if self.epoch_store is not None:
            self.epoch_store.set_labels(self._rule_labels(new_packed))
        obs.instant("serve.reload.ok", args={
            "n_keys": new_packed.n_keys,
            "migrated": not mig.identity,
        })

    # -- service plumbing -------------------------------------------------
    def _start_http(self) -> None:
        if self._http is None:  # bound in __init__; "off" leaves it None
            return
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, name="ra-serve-http", daemon=True
        )
        self._http_thread.start()

    def _start_watcher(self) -> None:
        if not self.scfg.reload_watch:
            return

        def watch():
            # debounced: save_packed writes two files (.npz + .json) whose
            # mtimes settle at different polls; fire one reload once the
            # pair has been stable for a whole poll interval
            last = self._ruleset_mtimes()
            pending = None
            while not self._stop_req.wait(self.scfg.reload_poll_sec):
                cur = self._ruleset_mtimes()
                if cur == last:
                    pending = None
                    continue
                if any(m is None for m in cur):
                    continue  # a file mid-replace; wait for the pair
                if cur == pending:  # stable across a whole poll: fire
                    last = cur
                    pending = None
                    self._reload_req.set()
                else:
                    pending = cur

        self._watch_thread = threading.Thread(
            target=watch, name="ra-serve-reload-watch", daemon=True
        )
        self._watch_thread.start()

    def _ruleset_mtimes(self) -> tuple:
        out = []
        for suffix in (".npz", ".json"):
            try:
                st = os.stat(self.prefix + suffix)
                out.append((st.st_mtime_ns, st.st_size))
            except OSError:
                out.append(None)
        return tuple(out)

    def _install_signals(self) -> None:
        import signal

        if threading.current_thread() is not threading.main_thread():
            return
        # SIGINT/SIGTERM request a graceful stop: the loop exits at its
        # next check, publishes the final partial window and writes
        # summary.json
        wanted = {
            getattr(signal, "SIGHUP", None): lambda *_: self._reload_req.set(),
            signal.SIGINT: lambda *_: self._stop_req.set(),
            signal.SIGTERM: lambda *_: self._stop_req.set(),
        }
        for sig, handler in wanted.items():
            if sig is None:
                continue
            try:
                self._old_signals[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    def _teardown(self, aborted: BaseException | None) -> None:
        import signal

        self._stop_req.set()
        for sig, old in self._old_signals.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_signals = {}
        if self._http is not None:
            if self._http_thread is not None:
                # shutdown() handshakes with serve_forever: calling it when
                # the serving thread never started blocks forever
                self._http.shutdown()
                self._http.server_close()
                self._http_thread.join(timeout=5.0)
            else:
                self._http.server_close()
        self.listeners.close()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5.0)
        if self.wal is not None:
            self.wal.close()
        if self.epoch_store is not None:
            self.epoch_store.sync()
            self.epoch_store.close()
        if self._lineage_log is not None:
            self._lineage_log.sync()
            self._lineage_log.close()
            self._lineage_log = None
        obs.unregister_sampler("listener")
        obs.unregister_sampler("serve")

    def _loop(self) -> None:
        scfg = self.scfg
        t0 = time.monotonic()
        next_rotation = t0 + scfg.window_sec if scfg.window_sec else None
        while True:
            if self._stop_req.is_set():
                break
            if scfg.stop_after_sec and time.monotonic() - t0 >= scfg.stop_after_sec:
                break
            self._maybe_reload()
            self._maybe_autoscale()
            self._check_metrics_health()
            # wall-clock rotation fires under load too, not just when idle
            if next_rotation is not None and time.monotonic() >= next_rotation:
                self._rotate()
                # skip cadence slots the rotation itself overran
                next_rotation += scfg.window_sec
                now = time.monotonic()
                while next_rotation <= now:
                    next_rotation += scfg.window_sec
                if scfg.max_windows and self.windows_published >= scfg.max_windows:
                    break
                continue
            got = self.queue.pop_ts(timeout=0.1)
            if got is not None:
                line, t_recv = got
                if self.wal is not None:
                    # durably spool before window accounting: once this
                    # returns, a SIGKILL cannot lose the line
                    self._wal_next = self.wal.append(line) + 1
                for ev in self.batcher.push(line):
                    self._consume_event(ev)
                self._note_receipt(t_recv)
                self.win_pushed += 1
                self.lines_consumed_total += 1
                # lines-mode rotation: deterministic, replayable windows
                if scfg.window_lines and self.win_pushed >= scfg.window_lines:
                    self._rotate()
                    if scfg.max_windows and self.windows_published >= scfg.max_windows:
                        break
                continue
            # idle tick: listener liveness
            if self.listeners.alive() == 0 and len(self.queue) == 0:
                err = self.listeners.first_error()
                if err is not None:
                    raise FeedWorkerError(
                        f"every serve listener died; first error: "
                        f"{type(err).__name__}: {err}"
                    ) from err
                break  # all ingress closed cleanly and drained: done
            # wedged-listener watchdog: a parked receive thread still says
            # is_alive(), but its heartbeat stops; once every live listener
            # is wedged with nothing queued the service aborts typed
            stalled = self.listeners.stalled(self.cfg.stall_timeout_sec)
            if stalled:
                self._win_saw_stall = True
                if len(stalled) == self.listeners.alive() and len(self.queue) == 0:
                    names = ", ".join(ln.label for ln in stalled)
                    raise StallError(
                        f"every live serve listener stalled (no heartbeat "
                        f"for {self.cfg.stall_timeout_sec:g}s): {names}"
                    )
        # bounded shutdown: stop ingress first, then account every line
        # still queued as an explicit drop
        self.listeners.close()
        undelivered = self.queue.discard_remaining()
        # the final partial window publishes (marked partial) rather than
        # dropping consumed lines, unless it is empty
        if (
            self.win_pushed
            or self.batcher.raw
            or self._fill6
            or self.pending
            or self.win_lines
            or undelivered
        ):
            self._rotate(partial=True)


# ---------------------------------------------------------------------------
# Minimal loopback HTTP JSON endpoint.
# ---------------------------------------------------------------------------


def _make_http_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        server_version = "ra-serve/1"

        def log_message(self, *a):  # silence per-request stderr noise
            pass

        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj, indent=2).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str, ctype: str) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            drv: ServeDriver = self.server.driver
            raw_path, _, query = self.path.partition("?")
            path = raw_path.rstrip("/") or "/"
            try:
                if path == "/health":
                    return self._send(200, drv.health())
                if path == "/metrics":
                    if "format=prom" in query:
                        # Prometheus text exposition of the same gauges
                        return self._send_text(
                            200,
                            render_prom(drv.metrics_gauges(), prefix="ra_serve_")
                            + drv.render_latency_prom()
                            + drv.render_labeled_prom(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    return self._send(200, {
                        **drv._sample_metrics(),
                        **drv.metrics_gauges(),
                        "build_info": drv.build_info_dict(),
                    })
                if path == "/report":
                    obj = drv.published("report")
                    return self._send(200, obj) if obj else self._send(
                        404, {"error": "no window published yet"}
                    )
                if path == "/report/cumulative":
                    obj = drv.published("cumulative")
                    return self._send(200, obj) if obj else self._send(
                        404, {"error": "no window published yet"}
                    )
                if path == "/report/static":
                    obj = drv.published("static")
                    return self._send(200, obj) if obj else self._send(
                        404,
                        {"error": "static analysis disabled "
                                  "(serve --static-analysis) or not yet run"},
                    )
                if path == "/diff":
                    obj = drv.published("diff")
                    return self._send(200, obj) if obj else self._send(
                        404, {"error": "fewer than two windows published"}
                    )
                if path.startswith("/report/window/"):
                    try:
                        wid = int(path.rsplit("/", 1)[1])
                    except ValueError:
                        return self._send(400, {"error": "bad window id"})
                    obj = drv.window_report(wid)
                    return self._send(200, obj) if obj else self._send(
                        404, {"error": f"window {wid} not in the ring"}
                    )
                if path.startswith("/report/merged/"):
                    try:
                        k = int(path.rsplit("/", 1)[1])
                    except ValueError:
                        return self._send(400, {"error": "bad window count"})
                    if not 1 <= k <= drv.scfg.ring:
                        # refuse, don't shrink: a merged-24 answer from an
                        # 8-epoch ring would claim evidence it lacks
                        return self._send(400, {
                            "error": (
                                f"merged window count must be in "
                                f"1..{drv.scfg.ring} (the ring size), "
                                f"got {k}; raise --ring to retain more"
                            ),
                        })
                    obj = drv.merged_report_obj(k)
                    return self._send(200, obj) if obj else self._send(
                        404, {"error": "no windows in the ring"}
                    )
                if path == "/report/range":
                    # historical analytics: bounds are window ids or unix
                    # seconds; the answer is a full report, a typed
                    # range_incomplete marker (404), or a 400 on bad bounds
                    from urllib.parse import parse_qs

                    params = parse_qs(query)
                    obj = drv.range_report_obj(
                        (params.get("from") or [None])[0],
                        (params.get("to") or [None])[0],
                    )
                    if "error" in obj:
                        code = 404 if "not armed" in obj["error"] else 400
                        return self._send(code, obj)
                    return self._send(404 if obj.get("range_incomplete") else 200, obj)
                if path == "/report/last-hit":
                    store = drv.epoch_store
                    if store is None:
                        return self._send(404, {
                            "error": "epoch store not armed (serve --epoch-store)",
                        })
                    return self._send(200, store.last_hit_obj())
                if path == "/lineage":
                    if not drv.scfg.lineage:
                        return self._send(404, {"error": "lineage disabled (--lineage off)"})
                    return self._send(200, drv.lineage_tail())
                if path.startswith("/lineage/window/"):
                    try:
                        wid = int(path.rsplit("/", 1)[1])
                    except ValueError:
                        return self._send(400, {"error": "bad window id"})
                    obj = drv.lineage_record(wid)
                    return self._send(200, obj) if obj else self._send(
                        404, {
                            "error": f"no lineage for window {wid} in the "
                            "ring (the full history is lineage.jsonl in "
                            "the serve dir)",
                        }
                    )
                return self._send(404, {
                    "error": "unknown path",
                    "endpoints": [
                        "/health", "/metrics", "/report",
                        "/report/cumulative", "/report/static",
                        "/report/window/<id>", "/report/merged/<k>",
                        "/report/range?from=&to=", "/report/last-hit",
                        "/diff", "/lineage", "/lineage/window/<id>",
                    ],
                })
            except BrokenPipeError:
                pass

    return Handler


def _make_http_server(addr, driver):
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(addr, _make_http_handler())
    srv.daemon_threads = True
    srv.driver = driver
    return srv


def window_incomplete(report_obj: dict) -> dict | None:
    """The typed WindowIncomplete marker of a serve report, or None.

    Consumers use this to refuse treating an incomplete window's zero-hit
    rules as unused.
    """
    return (report_obj.get("totals", {}).get("window") or {}).get("incomplete")
