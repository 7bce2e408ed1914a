"""Streaming loop: host input -> packed batches -> device steps -> Report.

Counterpart of the reference's ``runtime/stream.py`` (``run_stream``,
``run_stream_file``, ``run_stream_wire`` and ``_run_core_impl``) on one
device.  Four kinds of batch source feed it:

- :class:`_TextSource` — decoded lines through the Python parser;
- :class:`_FileSource` — syslog files through the native C++ parser
  (``hostside/fastparse.py``), with the Python path's batch boundaries;
- the multi-worker feeders of ``hostside/feeder.py`` (``feed_workers``):
  the native parser over file shards in worker processes, threads, or
  one shared-memory ring per device, batches following raw-line counts;
- :class:`_WireFileSource` — ``.rawire`` files (``hostside/wire.py``),
  plain or weighted (coalesced), read from an mmap.

The loop keeps the reference's batch boundaries, salt = chunk index, a
pending drain of depth 2 that offers candidates to the tracker in chunk
order, wire-layout host-to-device transfer (16 B/line; 20 B/row
weighted), optional flow coalescing (runtime/coalesce.py), and the same
``totals`` keys.  With ``cfg.prefetch_depth > 0`` (the default) a
producer thread parses, packs and starts each batch's copy to the card
ahead of the step (runtime/ingest.py).  Reports equal the reference's
apart from ``VOLATILE_TOTALS`` and ``totals.backend``.

IPv6 is a side path through the same registers, placed where the
reference places it: text sources stage v6 evaluations apart from the v4
batches (``take_v6``); after each v4 batch the loop pulls them and steps
every full ``[TUPLE6_COLS, batch]`` chunk at once; the partial chunk
steps after the v4 stream; a wire file's v6 section (``batches6``) is
read last.  v6 chunks take the chunk index as salt like v4 chunks, so
this order decides the talker candidates.  They cross to the card by a
plain copy of the host array (52 B/line; 40 or 44 B/row from a wire
file), not through the pinned ring.

The stacked layout (``cfg.layout == "stacked"``) follows the reference's
single-process loop: each v4 source batch (a wire batch expanded, a
coalesced one compacted first) goes into a ``pack.GroupBuffer`` of one
bucket per ACL, which emits a grouped batch ``[G, TUPLE_COLS, lane]``
whenever a bucket holds a full lane.  The port steps it as the flat batch
of the same lines in group-major order (``pack.flatten_grouped``), packed
weighted whenever rows may carry weights, on the scan route: the
first_match kernel walks only each line's own ACL span, so the reference's
per-ACL rule slabs have no counterpart, and every valid line gets the key
the reference's stacked step gives it.  The salt is the grouped chunk's
index; a snapshot first steps what the buffer holds, and the buffer
drains at the end (after a ``max_chunks`` stop too).  The prefetch
producer only parses, and the ring feeder assembles its batches.  v6 rows
keep the flat side path.

Checkpoint/resume (runtime/checkpoint.py) follows the reference's
``_run_core_impl``: with ``cfg.checkpoint_every_chunks`` a snapshot of
(offset, registers, counters, talker tables, the v6 sources the tables
name) is saved every N chunks and at the end; with ``cfg.resume`` the run
loads it, refuses one of another fingerprint, skips the offset (lines of
text, rows of a wire file counted over its v4 then v6 rows) and replays
the same salts from the saved chunk count.  Before a save the partial v6
chunk steps and every pending candidate drains, so no consumed line is in
limbo.  ``max_chunks`` stops after that many source batches without the
final snapshot, as a crash would (the reference's test knob).

The device is CUDA unless the caller passes ``device="cpu"``; without a
card that is an error, never a quiet run on the CPU.
"""

from __future__ import annotations

import time
from collections import deque
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from ..config import (
    FEED_MODES, WEIGHTED_CHUNK_WEIGHT_LIMIT, WEIGHTED_INPUT_REFUSALS, AnalysisConfig,
)
from ..errors import (
    AnalysisError, DeviceUnavailable, ResumeInputMismatch, WeightedInputRefused, WireCorrupt,
)
from ..hostside import pack as pack_mod
from ..hostside.pack import (
    TUPLE6_COLS, TUPLE_COLS, V6_DIGEST_CAP, W6_META, W6_SRC, W6_WEIGHT, W_WEIGHT,
    LinePacker, PackedRuleset, fold_src32_host,
)
from ..hostside.syslog import parse_line
from ..models import pipeline
from ..ops import _build
from ..ops.topk import TopKTracker
from . import checkpoint as ckpt
from . import coalesce as coalesce_mod
from .ingest import Counters, H2DRing, PrefetchingSource, to_device, views_to_device
from .metrics import ThroughputMeter

#: kernel library each match_impl runs on a CUDA device
KERNEL_OF = {"fused": "match_hist", "scan": "first_match"}


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> a torch device; no card is an error."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run the kernels' plain versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


class LineBatcher:
    """Push-based core of the text batching rules (the reference's).

    Batches are line-atomic: each holds a whole number of raw lines and at
    most ``batch_size`` tuple rows.  A batch normally covers exactly
    ``batch_size`` raw lines, but closes early when the next line's
    evaluations would not fit (a connection line evaluated against both an
    ``in`` and an ``out`` ACL emits two rows).  A batch whose raw lines
    produced no v4 tuple row is emitted as ``(None, n_raw)``.  IPv6
    evaluations never take v4 capacity: they are appended to ``v6rows``
    (and their sources to the capped ``v6_digests`` map) for the loop's
    v6 side path; against a pure-v4 ruleset an IPv6 line is a counted
    skip, as in the reference.
    """

    def __init__(self, packer: LinePacker, has_v6: bool, v6rows: list,
                 v6_digests: dict[int, int], batch_size: int):
        self.packer = packer
        self._has_v6 = has_v6
        self._v6rows = v6rows
        self._digests = v6_digests
        self._batch = batch_size
        self._out = np.zeros((TUPLE_COLS, batch_size), dtype=np.uint32)
        self._fill = 0
        self.raw = 0  # raw lines assigned to the open batch

    def _emit(self) -> tuple[np.ndarray | None, int]:
        ev = ((self._out if self._fill else None), self.raw)
        self._out = np.zeros((TUPLE_COLS, self._batch), dtype=np.uint32)
        self._fill = 0
        self.raw = 0
        return ev

    def push(self, line: str) -> list[tuple[np.ndarray | None, int]]:
        events: list[tuple[np.ndarray | None, int]] = []
        packer = self.packer
        p = parse_line(line)
        gids = [] if p is None else packer.resolve_gids(p)
        if gids and p.family == 6:
            if not self._has_v6:
                gids = []  # v6 traffic vs a pure-v4 ruleset: counted skip
            else:
                s = pack_mod.u128_limbs(p.src)
                d = pack_mod.u128_limbs(p.dst)
                for gid in gids:
                    self._v6rows.append((gid, p.proto, *s, p.sport, *d, p.dport, 1))
                if len(self._digests) < V6_DIGEST_CAP:
                    self._digests.setdefault(fold_src32_host(p.src), p.src)
                packer.parsed += len(gids)
                self.raw += 1
                if self.raw == self._batch:
                    events.append(self._emit())
                return events
        if gids and self._fill + len(gids) > self._batch:
            events.append(self._emit())
        for gid in gids:
            self._out[:, self._fill] = (
                gid, p.proto, p.src, p.sport, p.dst, p.dport, 1
            )
            self._fill += 1
        packer.parsed += len(gids)
        if not gids:
            packer.skipped += 1
        self.raw += 1
        if self.raw == self._batch:
            events.append(self._emit())
        return events

    def flush(self) -> tuple[np.ndarray | None, int] | None:
        """Close the open partial batch (end of stream)."""
        if self.raw:
            return self._emit()
        return None


class _TextSource:
    """Batch source over an iterable of decoded lines (Python parse)."""

    def __init__(self, packed: PackedRuleset, lines: Iterable[str]):
        self.packer = LinePacker(packed)
        self._lines = lines
        self._has_v6 = packed.has_v6
        self._v6rows: list[tuple] = []
        #: fold_src32 digest -> 128-bit source int (report rendering)
        self.v6_digests: dict[int, int] = {}

    def set_counts(self, parsed: int, skipped: int) -> None:
        self.packer.parsed, self.packer.skipped = parsed, skipped

    def take_v6(self) -> list[tuple]:
        """Drain the v6 tuple rows staged since the last call.

        Drains in place: the LineBatcher holds a reference to the list.
        """
        out = self._v6rows[:]
        del self._v6rows[:]
        return out

    def batches(self, skip_lines: int, batch_size: int) -> Iterator[tuple[np.ndarray | None, int]]:
        it = iter(self._lines)
        for i in range(skip_lines):
            if next(it, None) is None:
                raise ResumeInputMismatch(
                    f"snapshot consumed {skip_lines} lines but the input stream has "
                    f"only {i}; wrong or truncated log input"
                )
        packer = self.packer
        b = LineBatcher(packer, self._has_v6, self._v6rows, self.v6_digests, batch_size)
        for line in it:
            before = (packer.parsed, packer.skipped)
            events = b.push(line)
            if events and b.raw:
                # the batch closed early, before this line (its rows did not
                # fit): while it is the last batch out, the counters must
                # not count the line, or a snapshot taken at it would count
                # the line again on resume (the reference does)
                after = (packer.parsed, packer.skipped)
                packer.parsed, packer.skipped = before
                yield from events
                packer.parsed, packer.skipped = after
            else:
                yield from events
        tail = b.flush()
        if tail is not None:
            yield tail


def _needed_v6_digests(tracker: TopKTracker, dig: dict[int, int]) -> dict[int, int]:
    """digest -> address for the v6 sources the tracker's tables hold.

    What the report can render, and what a snapshot keeps: bounded by the
    top-K capacity, not by V6_DIGEST_CAP.
    """
    tag = pipeline.V6_ACL_TAG
    needed = {int(s) for gid, table in tracker.tables().items() if int(gid) & tag
              for s in table}
    return {d: dig[d] for d in sorted(needed) if d in dig}


def _v6_digest_extra(source, tracker: TopKTracker) -> dict | None:
    """The snapshot's ``extra``: the digest -> address map of tracked v6 talkers.

    The map fills at parse time, so a resumed run sees only the sources
    after its offset; without this its pre-crash v6 talkers would render
    as opaque ``v6#xxxx`` digests.
    """
    dig = getattr(source, "v6_digests", None)
    if not dig:
        return None
    rows = [[int(d), int(s)] for d, s in _needed_v6_digests(tracker, dig).items()]
    return {"v6_digests": rows} if rows else None


def _restore_v6_digests(source, snap: ckpt.Snapshot) -> None:
    """Inverse of :func:`_v6_digest_extra` on resume."""
    dig = getattr(source, "v6_digests", None)
    if dig is None or not snap.extra:
        return
    for d, s in snap.extra.get("v6_digests", []):
        dig.setdefault(int(d), int(s))


class _FileSource:
    """Batch source over syslog file(s) via the native C++ parser."""

    def __init__(self, packed: PackedRuleset, paths: list[str]):
        from ..hostside import fastparse

        self.packer = fastparse.NativePacker(packed)
        self._paths = paths
        self.v6_digests: dict[int, int] = {}

    def set_counts(self, parsed: int, skipped: int) -> None:
        self.packer.set_counts(parsed, skipped)

    def take_v6(self):
        """v6 rows the native parser staged (``[n, TUPLE6_COLS]``, or [])."""
        rows = self.packer.take_v6()
        pack_mod.stage_v6_digests(rows, self.v6_digests)
        return rows

    def batches(self, skip_lines: int, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        from ..hostside import fastparse

        return fastparse.batches_from_files(
            self._paths, self.packer, batch_size, skip_lines=skip_lines
        )


class _WireFileSource:
    """Batch source over ``.rawire`` files (hostside.wire).

    Yields wire-format ``[WIRE_COLS, batch]`` arrays (``[WIREW_COLS,
    batch]`` for weighted files) directly — ``yields_wire`` tells the loop
    to skip ``compact_batch`` — and, from :meth:`batches6`, the v6
    section's ``[WIRE6_COLS(+1), batch]`` arrays after the v4 stream.
    The arrays may be read-only mmap views.  Counters come from the
    stored valid bits (summed weights for a weighted file).  A stored row
    whose valid bit is clear, which the converter never writes, is block
    damage: in the v4 stream a typed ``WireCorrupt`` refusal, in the v6
    section a skipped row (``lines_skipped``), each as in the reference.
    The step's valid mask keeps such a row out of every register.
    """

    yields_wire = True

    def __init__(self, packed: PackedRuleset, paths: list[str]):
        from ..hostside.wire import WireReader

        self.reader = WireReader(paths, packed)
        self.yields_wire_weighted = self.reader.weighted
        self.packer = Counters()
        #: fold digest -> 128-bit source, filled by batches6
        self.v6_digests: dict[int, int] = {}

    def set_counts(self, parsed: int, skipped: int) -> None:
        self.packer.parsed, self.packer.skipped = parsed, skipped

    @property
    def n4_rows(self) -> int:
        """Rows of the v4 stream: resume offsets past it fall in the v6 section."""
        return self.reader.n_rows

    @staticmethod
    def _check_chunk_weight(ws: int) -> None:
        """Refuse weighted chunks whose summed weights reach 2^32.

        The exact-counts accumulator's carry detection (counts.add64)
        assumes per-chunk deltas < 2^32; a weighted chunk's delta is the
        ORIGINAL line count behind its rows.
        """
        if ws >= WEIGHTED_CHUNK_WEIGHT_LIMIT:
            raise AnalysisError(
                f"weighted wire chunk carries {ws} original lines, which "
                "overflows the per-chunk uint32 count delta; re-convert "
                "with a smaller --block-rows (or run with a smaller "
                "--batch-size) so each chunk stays under 2^32 lines"
            )

    def batches(self, skip_lines: int, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        from ..hostside.wire import sanity_check_valid_bits

        # resume offsets count the v4-then-v6 row stream; the guard is
        # against the total, so a short input is refused even when the
        # v6 section is never read (a pure-v4 ruleset)
        total = self.reader.n_rows + self.reader.n6_rows
        if skip_lines > total:
            raise ResumeInputMismatch(
                f"snapshot consumed {skip_lines} rows but the wire input has "
                f"only {total}; wrong or truncated input"
            )
        for wire, n in self.reader.iter_batches(min(skip_lines, self.reader.n_rows),
                                                batch_size):
            v, inv = sanity_check_valid_bits(wire)
            pad = wire.shape[1] - n  # padding columns are not stored rows
            if inv > pad:
                raise WireCorrupt(
                    f"wire batch holds {inv - pad} stored row(s) with the "
                    "valid bit clear — the block was damaged after "
                    "conversion; re-run `convert` to proceed"
                )
            if self.yields_wire_weighted:
                ws = int(wire[W_WEIGHT].sum(dtype=np.uint64))
                self._check_chunk_weight(ws)
                self.packer.parsed += ws
            else:
                self.packer.parsed += v
            yield wire, n

    def batches6(self, skip_rows6: int, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        """The v6 section (read after the whole v4 stream); its damaged rows
        (valid bit clear) count as skipped, as in the reference."""
        for w6, n in self.reader.iter_batches6(skip_rows6, batch_size):
            v = int(np.count_nonzero(w6[W6_META] & np.uint32(1 << 23)))
            if self.yields_wire_weighted:
                ws = int(w6[W6_WEIGHT].sum(dtype=np.uint64))
                self._check_chunk_weight(ws)
                self.packer.parsed += ws
            else:
                self.packer.parsed += v
            self.packer.skipped += n - v
            pack_mod.add_v6_digests(w6[W6_SRC:W6_SRC + 4, :n], self.v6_digests)
            yield w6, n

    def close(self) -> None:
        """Release the reader's mmaps."""
        self.reader.close()

    def totals_patch(self, complete: bool) -> dict:
        """True raw-line accounting once the whole input was consumed.

        Until then ``lines_total`` counts stored rows, the unit of resume
        offsets, and the patch only says so.
        """
        if not complete:
            return {"wire_rows_only": True}
        out = {
            "lines_total": self.reader.raw_lines,
            "lines_skipped": self.reader.n_skipped + self.packer.skipped,
            "wire_rows": self.reader.n_rows + self.reader.n6_rows,
        }
        if self.yields_wire_weighted:
            out["wire_evals"] = self.reader.n_evals
            out["wire_weighted"] = True
        return out


def _iter_files(paths: list[str]):
    for path in paths:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            yield from f


def _check_weighted_input_config(cfg: AnalysisConfig) -> None:
    """Refuse device formulations that are not weight-linear.

    A weighted (RAWIREv3) input reaches the step with weights the config
    validator never saw, so every entry of ``config.WEIGHTED_INPUT_REFUSALS``
    is refused here too.
    """
    for r in WEIGHTED_INPUT_REFUSALS:
        if getattr(cfg, r.field) == r.value:
            raise WeightedInputRefused(
                "weighted (coalesced) wire inputs are incompatible with "
                f"{r.field}={r.value!r}: {r.reason}"
            )


def run_stream(packed: PackedRuleset, lines: Iterable[str], cfg: AnalysisConfig,
               *, topk: int = 10, return_state: bool = False, max_chunks: int | None = None):
    """Analyze an iterable of syslog lines (Python parser); returns the Report.

    ``return_state=True`` returns ``(report, registers)``, the registers
    as the reference's ``state_to_host`` dict of numpy uint32 arrays (as
    do the other entry points).  ``max_chunks`` stops after that many
    batches and skips the final snapshot: a simulated crash (all entry
    points take it).
    """
    return _run_core(packed, _TextSource(packed, lines), cfg, topk=topk,
                     return_state=return_state, max_chunks=max_chunks)


def run_stream_file(packed: PackedRuleset, paths: str | list[str], cfg: AnalysisConfig,
                    *, native: bool | None = None, topk: int = 10,
                    return_state: bool = False, max_chunks: int | None = None,
                    feed_workers: int = 0, feed_mode: str = "process"):
    """Analyze syslog file(s), with the native C++ parser when available.

    ``native=None`` picks the C++ parser if its library builds and loads,
    else the Python parser; ``native=True`` without a toolchain raises
    :class:`~..errors.NativeParserUnavailable`.  Batches and registers
    are identical either way.  As in the reference, a batch whose lines
    all skip is stepped (all-invalid) on the native path and not on the
    Python path, so ``chunks`` and later candidate salts can differ.

    ``feed_workers > 1`` (or ``>= 1`` in ring mode) parses with that many
    workers over file shards (``hostside/feeder.py``): spawned processes
    packing into shared memory (``feed_mode="process"``), in-process
    threads (``"thread"``), or one shared-memory ring per device whose
    slots are copied to the card as they are (``"ring"``).  Batches then
    follow raw-line counts (2x wide with out-direction bindings; a
    dual-evaluation line never closes one early), so per-chunk talker
    candidates can differ from the sequential run's; registers, counts
    and the unused set do not.  The three modes give the same report.
    """
    from ..hostside import fastparse

    if isinstance(paths, str):
        paths = [paths]
    if feed_mode not in FEED_MODES:
        raise AnalysisError(
            f"feed_mode must be 'process', 'thread' or 'ring', got {feed_mode!r}"
        )
    if feed_mode == "ring" and not (feed_workers and feed_workers >= 1):
        # an explicitly requested topology must never be silently dropped
        raise AnalysisError(
            "feed_mode='ring' needs feed_workers >= 1 (the per-chip producer pool size)"
        )
    if feed_workers and (feed_workers > 1 or feed_mode == "ring"):
        if native is False:
            raise AnalysisError("feed_workers requires the native parser; drop native=False")
        from ..hostside import feeder

        feeder_cls = {"process": feeder.ParallelFeeder, "thread": feeder.ThreadedFeeder,
                      "ring": feeder.RingFeeder}[feed_mode]
        source = feeder_cls(packed, paths, n_workers=feed_workers,
                            stall_timeout=cfg.stall_timeout_sec)
    elif native if native is not None else fastparse.available():
        source = _FileSource(packed, paths)
    else:
        source = _TextSource(packed, _iter_files(paths))
    return _run_core(packed, source, cfg, topk=topk, return_state=return_state,
                     max_chunks=max_chunks)


def run_stream_wire(packed: PackedRuleset, paths: str | list[str], cfg: AnalysisConfig,
                    *, topk: int = 10, return_state: bool = False,
                    max_chunks: int | None = None):
    """Analyze pre-tokenized ``.rawire`` file(s): no host parse.

    Registers and per-rule counts are bit-identical to a text run over
    the same logs.  Weighted (coalesced) files need a weight-linear
    ``match_impl`` (``scan``).
    """
    if isinstance(paths, str):
        paths = [paths]
    return _run_core(packed, _WireFileSource(packed, paths), cfg, topk=topk,
                     return_state=return_state, max_chunks=max_chunks)


def _run_core(packed: PackedRuleset, source, cfg: AnalysisConfig, *, topk: int,
              return_state: bool = False, max_chunks: int | None = None):
    """Wrap the source (prefetch, coalescing), run it, release it."""
    try:
        device = resolve_device(cfg.device)
        stacked = cfg.layout == "stacked"
        if getattr(source, "yields_wire_weighted", False):
            _check_weighted_input_config(cfg)
        coal = coalesce_mod.make_coalescer(cfg, cfg.batch_size)
        wire_src = getattr(source, "yields_wire", False)
        ring_src = getattr(source, "yields_ring", False)
        if ring_src:
            if coal is not None:
                raise AnalysisError(
                    "runtime coalescing is not available with the ring feeder (per-chip "
                    "shards compact independently, which would change batch grouping); "
                    "pre-coalesce with `convert --coalesce` or the convert fleet instead"
                )
            # one ring per device (one device here); with prefetch the
            # rings' views go to the card as they are, else (and for the
            # stacked layout, which groups on the loop) the feeder
            # assembles plain batches
            if not source.n_rings:
                source.n_rings = 1
            source.emit_views = cfg.prefetch_depth > 0 and not stacked

        def host_pack(b: np.ndarray) -> np.ndarray:
            """A source batch -> the uint32 layout that crosses to the card."""
            if coal is not None and coal.enabled():
                return coal.wire4(b) if wire_src else pack_mod.compact_batch_w(coal.tuple4(b))
            return b if wire_src else pack_mod.compact_batch(b)

        ring = None
        if cfg.prefetch_depth > 0:
            # depth queued + one in the step + one being packed
            if device.type == "cuda":
                ring = H2DRing(device, cfg.prefetch_depth + 2)
            if stacked:
                # the producer only parses (or reads): the loop groups the
                # batches and stages each grouped chunk through the ring
                pack = None
            elif ring_src:
                def pack(rb):
                    return views_to_device(rb, device, ring)
            else:
                def pack(b):
                    return to_device(host_pack(b), device, ring)
            source = PrefetchingSource(source, cfg.prefetch_depth, pack=pack,
                                       stall_timeout=cfg.stall_timeout_sec)
            stage = None
        else:
            def stage(b):
                return to_device(host_pack(b), device)

        return _run_loop(packed, source, cfg, device, stage, coal, ring, topk=topk,
                         return_state=return_state, max_chunks=max_chunks)
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()


def _run_loop(packed, source, cfg, device, stage, coal, ring, *, topk: int,
              return_state: bool, max_chunks: int | None):
    batch_size = cfg.batch_size
    if packed.bindings_out and batch_size < 2:
        raise AnalysisError(
            "batch_size must be >= 2 when out-direction access-groups are "
            "bound: one connection line can emit two ACL evaluations"
        )
    dev_rules = pipeline.ship_ruleset(packed, device)
    lane = 0
    gbuf = None
    if cfg.layout == "stacked":
        # lines bucket by ACL on the host; each grouped batch steps as the
        # flat batch of its lines in group-major order (run_grouped)
        lane = cfg.stacked_lane or max(1, batch_size // max(1, packed.n_acls))
        gbuf = pack_mod.GroupBuffer(max(packed.n_acls, 1), lane)
    # the IPv6 side path: v6 rule tensors and kernel only when the
    # ruleset has v6 rows and the source can deliver v6 lines
    has6 = packed.has_v6 and (hasattr(source, "take_v6") or hasattr(source, "batches6"))
    dev_rules6 = pipeline.ship_ruleset6(packed, device) if has6 else None
    packer = source.packer
    wire_src = getattr(source, "yields_wire", False)
    wire_weighted = getattr(source, "yields_wire_weighted", False)
    # rows fed to the group buffer may carry weights > 1: a grouped chunk
    # then crosses weighted, or a 1-bit valid would crush a weight-w row
    weighted_rows = coal is not None or wire_weighted
    # wire offsets count rows and text offsets lines, so a snapshot must not
    # resume across input kinds (nor a weighted file's stored-row offsets a
    # plain file's)
    fp = ckpt.fingerprint(packed, cfg, lane) + (
        ("-wirew" if wire_weighted else "-wire") if wire_src else ""
    )
    lines_consumed = 0
    n_chunks = 0
    snap = ckpt.load(cfg.checkpoint_dir) if cfg.resume else None
    if snap is not None:
        if snap.fingerprint != fp:
            raise ckpt.CheckpointMismatch(
                f"snapshot in {cfg.checkpoint_dir!r} was taken with a different "
                "ruleset, sketch geometry, batch size, layout, or input kind; "
                "refusing to merge"
            )
        state = ckpt.state_of(snap, device)
        tracker = ckpt.restore_tracker(snap, cfg.sketch.topk_capacity)
        source.set_counts(snap.parsed, snap.skipped)
        _restore_v6_digests(source, snap)
        lines_consumed = snap.lines_consumed
        n_chunks = snap.n_chunks  # the salt of the next chunk
    else:
        state = pipeline.init_state(packed.n_keys, cfg, device)
        tracker = TopKTracker(cfg.sketch.topk_capacity)
    meter = ThroughputMeter(cfg.report_every_chunks)
    step_args = dict(n_keys=packed.n_keys, topk_k=cfg.sketch.topk_chunk_candidates,
                     exact_counts=cfg.exact_counts,
                     topk_sample_shift=cfg.sketch.topk_sample_shift,
                     topk_every=cfg.sketch.topk_every)
    # the port has no jit: its one-time cost is building/loading the
    # kernels, priced apart from the sustained rate like the reference's
    # compile_sec
    compile_sec = 0.0
    if device.type == "cuda":
        t0 = time.perf_counter()
        names = [KERNEL_OF[cfg.match_impl], "reg_tail"] + (["first_match6"] if has6 else [])
        _build.build_all(names)  # one nvcc per source, in parallel
        for name in names:
            _build.library(name)
        compile_sec = time.perf_counter() - t0

    def drain(out: pipeline.ChunkOut) -> None:
        tracker.offer_chunk(out.cand_acl.cpu(), out.cand_src.cpu(), out.cand_est.cpu())

    # candidates drain with a 2-chunk lag, so fetching them never waits
    # on the chunk still in flight, and memory stays O(1) chunks
    pending: deque[pipeline.ChunkOut] = deque()

    def commit(out: pipeline.ChunkOut) -> None:
        nonlocal n_chunks
        pending.append(out)
        if len(pending) > 2:
            drain(pending.popleft())
        n_chunks += 1

    def run_chunk(dev_batch) -> None:
        # salt = chunk index: re-randomizes candidate-table slots per
        # chunk, as in the reference (zero-valid text batches do not
        # step and do not advance it); a resume replays it from the
        # snapshot's chunk count
        nonlocal state
        state, out = pipeline.analysis_step(
            state, dev_rules, dev_batch.use(), salt=n_chunks, match_impl=cfg.match_impl,
            **step_args,
        )
        commit(out)

    def run_grouped(grouped: np.ndarray) -> None:
        # a grouped chunk is G * lane lines wide, not batch_size: the
        # ring's pinned buffers are (re)made for its shape
        flat = pack_mod.flatten_grouped(grouped)
        wire = pack_mod.compact_batch_w(flat) if weighted_rows else pack_mod.compact_batch(flat)
        run_chunk(to_device(wire, device, ring))

    def group(batch: np.ndarray) -> None:
        # bucket a source batch by ACL; coalescing compacts it first, so
        # lanes fill at the unique-row rate, as in the reference
        cols = pack_mod.expand_batch(batch) if wire_src else batch
        if coal is not None and coal.enabled():
            cols = coal.tuple4(cols, pad=False)
        for grouped in gbuf.add(np.ascontiguousarray(cols.T)):
            run_grouped(grouped)

    def run_chunk6(batch6: np.ndarray) -> None:
        nonlocal state
        if coal is not None and coal.enabled():
            # v6 chunks coalesce at step time: tuple batches carry the
            # weights in T6_VALID, wire batches grow the weights row
            batch6 = (coal.tuple6(batch6) if batch6.shape[0] == TUPLE6_COLS
                      else coal.wire6(batch6))
        state, out = pipeline.analysis_step6(
            state, dev_rules6, to_device(batch6, device).use(), salt=n_chunks, **step_args,
        )
        commit(out)

    buf6 = None
    fill6 = 0

    def stage_v6() -> None:
        # pull the v6 rows staged with the batches consumed so far; step
        # each full chunk at once (a wire file's v6 rows come in phase 2)
        nonlocal buf6, fill6
        if not hasattr(source, "take_v6"):
            return
        rows = source.take_v6()
        i = 0
        while i < len(rows):
            if buf6 is None:
                buf6 = np.zeros((TUPLE6_COLS, batch_size), dtype=np.uint32)
            take = min(batch_size - fill6, len(rows) - i)
            buf6[:, fill6:fill6 + take] = np.asarray(rows[i:i + take], dtype=np.uint32).T
            fill6 += take
            i += take
            if fill6 == batch_size:
                run_chunk6(buf6)
                buf6 = None
                fill6 = 0

    def flush_v6() -> None:
        # the partial v6 chunk (padding columns carry valid=0), after the
        # v4 stream and before every snapshot
        nonlocal buf6, fill6
        stage_v6()
        if fill6:
            run_chunk6(buf6)
            buf6 = None
            fill6 = 0

    last_snap_chunks = n_chunks  # the cadence counts device chunks since the last save

    def save_snapshot() -> None:
        # the registers must cover exactly lines_consumed: step the lines
        # the group buffer holds back and the staged v6 rows, and drain
        # every candidate before reading the tables
        nonlocal last_snap_chunks
        if gbuf is not None:
            for grouped in gbuf.flush():
                run_grouped(grouped)
        if has6:
            flush_v6()
        last_snap_chunks = n_chunks
        while pending:
            drain(pending.popleft())
        ckpt.save(cfg.checkpoint_dir, ckpt.snapshot_of(
            state, lines_consumed=lines_consumed, n_chunks=n_chunks, parsed=packer.parsed,
            skipped=packer.skipped, tracker=tracker, fingerprint=fp,
            extra=_v6_digest_extra(source, tracker),
        ))

    def after_chunk(n_raw: int, stepped: bool) -> bool:
        """Account one source batch; snapshot on the cadence; True = stop here.

        The cadence counts device chunks (grouped ones under the stacked
        layout, which emit unevenly), ``max_chunks`` source batches.
        """
        nonlocal lines_consumed, chunks_this_run
        lines_consumed += n_raw
        chunks_this_run += 1
        meter.tick(n_raw)
        if (stepped and cfg.checkpoint_every_chunks
                and n_chunks - last_snap_chunks >= cfg.checkpoint_every_chunks):
            save_snapshot()
        return max_chunks is not None and chunks_this_run >= max_chunks

    lines_at_start = lines_consumed  # nonzero after a resume
    chunks_this_run = 0  # source batches, stepped or not: what max_chunks counts
    aborted = False
    for batch, n_raw in source.batches(lines_consumed, batch_size):
        if batch is not None:
            if gbuf is not None:
                group(batch)
            else:
                # prefetched batches arrive as device batches; the
                # synchronous loop packs (16 B/line wire layout) and copies
                run_chunk(batch if stage is None else stage(batch))
        if has6:
            stage_v6()
        if after_chunk(n_raw, batch is not None):
            aborted = True  # a simulated crash: no final snapshot
            break
    if gbuf is not None:
        # the buffered lines are in lines_consumed and the counters, so
        # they step on an abort too (the crash is the skipped final save)
        for grouped in gbuf.flush():
            run_grouped(grouped)
    if has6:
        flush_v6()
        # phase 2: a wire file's v6 section, after every v4 block; resume
        # offsets run on over the v4-then-v6 row stream
        if hasattr(source, "batches6") and not aborted:
            for b6, n6 in source.batches6(max(0, lines_at_start - source.n4_rows),
                                          batch_size):
                run_chunk6(b6)
                if after_chunk(n6, True):
                    aborted = True
                    break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = meter.elapsed()
    while pending:
        drain(pending.popleft())
    if cfg.checkpoint_every_chunks and not aborted:
        save_snapshot()

    # lines_total/matched/skipped and chunks are cumulative across
    # resumes; the rates are this run's lines over this run's time
    lines_this_run = lines_consumed - lines_at_start
    sustained = elapsed - compile_sec
    totals = {
        "lines_total": lines_consumed,
        "lines_matched": packer.parsed,
        "lines_skipped": packer.skipped,
        "chunks": n_chunks,
        "elapsed_sec": round(elapsed, 4),
        "lines_per_sec": round(lines_this_run / elapsed, 1) if elapsed > 0 else 0.0,
        "compile_sec": round(compile_sec, 4),
        "sustained_lines_per_sec": (
            round(lines_this_run / sustained, 1) if sustained > 0 else 0.0
        ),
        "throughput": meter.summary(),
    }
    stats_fn = getattr(source, "ingest_stats", None)
    if stats_fn is not None:
        # per-stage overlap accounting: host-starved vs device-bound
        totals["ingest"] = stats_fn()
        if ring is not None:
            totals["ingest"]["h2d_bytes"] = ring.bytes
            totals["ingest"]["pinned_buffers"] = ring.allocs
        lat = source.latency_summary()
        if lat:
            totals["latency"] = lat
    if coal is not None:
        totals["coalesce"] = coal.summary()
    patch = getattr(source, "totals_patch", None)
    if patch is not None:
        # wire input: the converter's raw-line accounting (rows != lines)
        # once the whole file was read
        totals.update(patch(not aborted))
    digests = getattr(source, "v6_digests", None)
    report = pipeline.finalize(
        state, packed, cfg, tracker, topk=topk, totals=totals,
        backend=f"torch-{device.type}",
        v6_digests=_needed_v6_digests(tracker, digests) if digests else None,
    )
    if return_state:
        return report, pipeline.state_to_numpy(state)
    return report
