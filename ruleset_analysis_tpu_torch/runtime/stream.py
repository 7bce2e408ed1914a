"""Streaming loop: host input -> packed batches -> device steps -> Report.

Counterpart of the reference's ``runtime/stream.py`` (``run_stream``,
``run_stream_file``, ``run_stream_wire``, ``_run_core_impl`` and
``run_stream_file_distributed``).  Four kinds of batch source feed it:

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

Every batch shards over a device mesh (``parallel/mesh.py``): by default
every visible CUDA device, or the one CPU device with ``device="cpu"``;
without a card that is an error, never a quiet run on the CPU.  The batch
pads to a multiple of the mesh width, each shard steps its columns and
the registers merge after every step (``parallel/step.py``); a ring
feeder keeps one ring per shard.  On a one-device mesh the step is the
one-device step.  :func:`run_stream_file_distributed` runs one process
of a ``torch.distributed`` job over its own input split, in collective
rounds (``parallel/distributed.py``); with ``elastic=`` it runs one
generation of an elastic job (runtime/elastic.py) over per-shard cursors
(:class:`_ShardCursorSource`) and saves world-size-independent epoch
snapshots.

Failure handling follows the reference: each public entry arms the retry
table and, with ``cfg.blackbox_dir``, the flight recorder
(:func:`_arm_retry`); the run arms ``cfg.fault_plan`` and disarms it at
its end.  Each chunk's dispatch is a ``step.dispatch`` span and each
batch's pack and copy an ``ingest.pack`` span when a tracer or the
recorder listens (runtime/obs.py); neither waits for the device.  A
damaged wire block is the ``stream.wire.corrupt`` site.  Unlike the
reference's distributed loop, whose ``to_global`` has no fault site, the
port's copies its local batch through ``mesh.shard_batch`` and so through
the ``device_put`` seam.

Telemetry: the throughput meter feeds the metrics plane (runtime/obs.py)
when it is armed; the prefetch queue, the coalescer and the feeders
register their samplers for the run; a failing run reads every sampler
(``flightrec.note_gauges``) before its sources close.  ``profile_dir``
puts the whole loop, drained and synchronised, in one ``torch.profiler``
window (``metrics.Profiler``); unlike the reference, the distributed
loop takes it too.  An armed ``--devprof-out`` capture
(runtime/devprof.py) sees every dispatch through ``_Chunks._run`` (one
None-check when disarmed) and is finalized into ``totals.devprof`` after
the single-process loop took ``elapsed``.
"""

from __future__ import annotations

import os
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
from ..parallel import mesh as mesh_lib
from ..parallel import step as step_lib
from . import checkpoint as ckpt
from . import coalesce as coalesce_mod
from . import devprof, faults, obs
from .ingest import Counters, PrefetchingSource, views_to_device
from .metrics import Profiler, ThroughputMeter

#: kernel library each match_impl runs on a CUDA device
KERNEL_OF = {"fused": "match_hist", "scan": "first_match"}


def _arm_retry(cfg: AnalysisConfig) -> None:
    """Arm the retry table (counters reset) and, when ``cfg`` names a
    blackbox dir, the flight recorder, for one run.

    Called at the public entries, before any source is built: opening a
    wire file is itself a retry seam, and its attempts must land in this
    run's counters.
    """
    from . import flightrec, retrypolicy

    retrypolicy.configure(cfg.retry_policy)
    if cfg.blackbox_dir:
        flightrec.arm(cfg.blackbox_dir, role="main")


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

    @staticmethod
    def _corrupt_wire(wire: np.ndarray, rng) -> np.ndarray:
        """The reference's seeded storage-damage model for the
        ``stream.wire.corrupt`` site: whole stored rows scrambled, their
        valid bit cleared, which the reader check below refuses."""
        from ..hostside.pack import W_META

        wire = wire.copy()  # never write through the read-only mmap view
        for _ in range(1 + rng.randrange(3)):
            j = rng.randrange(wire.shape[1])
            for w in range(wire.shape[0]):
                wire[w, j] ^= np.uint32(rng.getrandbits(32))
            wire[W_META, j] &= np.uint32(~(1 << 23) & 0xFFFFFFFF)
        return wire

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
            wire = faults.fire("stream.wire.corrupt", payload=wire, corrupt=self._corrupt_wire)
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


class _ShardCursorSource:
    """Sequential multi-shard source with per-shard resume cursors.

    The elastic tier's input (runtime/elastic.py): a worker owns a list of
    ``(shard_index, path, start_line)`` assignments instead of one split,
    reads them in order over the native or the Python parser, and counts
    the raw lines of each shard assigned to emitted batches.  The cursors
    are world-size-independent, so a re-formed cluster of any surviving
    size can re-split the remaining work and resume with registers that
    cover every consumed line once.

    ``die_after_batches`` (the elastic analog of ``max_chunks``) ends the
    process abruptly with ``os._exit(DIE_RC)`` after that many emitted
    batches, as a node dies mid-collective; the ``elastic.worker.die``
    site is its plan-driven twin.  ``pace_sec`` sleeps that long a batch
    (a throttle for drills that need a run to last).
    """

    yields_wire = False

    def __init__(self, packed: PackedRuleset, assignments: list[tuple[int, str, int]],
                 native: bool, die_after_batches: int | None = None, pace_sec: float = 0.0):
        self._packed = packed
        self._assignments = list(assignments)
        self._native = native
        self.v6_digests: dict[int, int] = {}
        #: shard index -> raw lines of that shard assigned to emitted batches
        self.cursors = {int(i): int(start) for i, _p, start in self._assignments}
        self.done: set[int] = set()
        self._die_after = die_after_batches
        self._pace = float(pace_sec or 0.0)
        self._yielded = 0
        self._subs: list[_TextSource] = []
        if native:
            from ..hostside import fastparse

            self.packer = fastparse.NativePacker(packed)
        else:
            self.packer = LinePacker(packed)

    def set_counts(self, parsed: int, skipped: int) -> None:
        if self._native:
            self.packer.set_counts(parsed, skipped)
        else:
            self.packer.parsed, self.packer.skipped = parsed, skipped

    def take_v6(self):
        if self._native:
            rows = self.packer.take_v6()
            pack_mod.stage_v6_digests(rows, self.v6_digests)
            return rows
        return [row for sub in self._subs for row in sub.take_v6()]

    def cursor_rows(self) -> np.ndarray:
        """``[n, 4]`` uint32 rows (idx, cursor_lo, cursor_hi, done): the
        epoch manifest's gather unit (``allgather_rows`` takes uint32, so
        a cursor past 2^32 lines splits into limbs)."""
        rows = [(idx, cur & 0xFFFFFFFF, cur >> 32, 1 if idx in self.done else 0)
                for idx, cur in sorted(self.cursors.items())]
        return np.asarray(rows, dtype=np.uint32).reshape(-1, 4)

    def batches(self, skip_lines: int, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        if skip_lines:
            raise AnalysisError(
                "elastic sources resume via per-shard cursors, not a global skip offset"
            )
        from .elastic import DIE_RC  # elastic imports this module at run time

        for idx, path, start in self._assignments:
            if self._native:
                from ..hostside import fastparse

                it = fastparse.batches_from_files([path], self.packer, batch_size,
                                                  skip_lines=start)
            else:
                sub = _TextSource(self._packed, _iter_files([path]))
                sub.packer = self.packer  # shared cumulative counters
                sub.v6_digests = self.v6_digests  # one digest map
                self._subs.append(sub)
                it = sub.batches(start, batch_size)
            for batch, n_raw in it:
                # the cursor moves as lines are assigned to a batch: a
                # snapshot after this batch steps covers exactly them
                self.cursors[idx] += n_raw
                if self._pace:
                    time.sleep(self._pace)
                yield batch, n_raw
                self._yielded += 1
                faults.fire("elastic.worker.die", crash_rc=DIE_RC)
                if self._die_after is not None and self._yielded >= self._die_after:
                    os._exit(DIE_RC)  # node death: no teardown
            self.done.add(idx)


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
               *, topk: int = 10, return_state: bool = False, max_chunks: int | None = None,
               mesh: mesh_lib.Mesh | None = None, profile_dir: str | None = None):
    """Analyze an iterable of syslog lines (Python parser); returns the Report.

    ``return_state=True`` returns ``(report, registers)``, the registers
    as the reference's ``state_to_host`` dict of numpy uint32 arrays (as
    do the other entry points).  ``max_chunks`` stops after that many
    batches and skips the final snapshot: a simulated crash (all entry
    points take it).  ``mesh`` (all entry points take it): the devices
    each batch shards over; None builds ``cfg``'s mesh over every visible
    CUDA device, or the one CPU device with ``cfg.device="cpu"``.
    ``profile_dir`` (all entry points take it): a whole-run
    ``torch.profiler`` trace there (``metrics.Profiler``), CUDA activity
    included on a CUDA mesh.
    """
    _arm_retry(cfg)
    return _run_core(packed, _TextSource(packed, lines), cfg, topk=topk,
                     return_state=return_state, max_chunks=max_chunks, mesh=mesh,
                     profile_dir=profile_dir)


def run_stream_file(packed: PackedRuleset, paths: str | list[str], cfg: AnalysisConfig,
                    *, native: bool | None = None, topk: int = 10,
                    return_state: bool = False, max_chunks: int | None = None,
                    feed_workers: int = 0, feed_mode: str = "process",
                    mesh: mesh_lib.Mesh | None = None, profile_dir: str | None = None):
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

    _arm_retry(cfg)
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
                     max_chunks=max_chunks, mesh=mesh, profile_dir=profile_dir)


def run_stream_wire(packed: PackedRuleset, paths: str | list[str], cfg: AnalysisConfig,
                    *, topk: int = 10, return_state: bool = False,
                    max_chunks: int | None = None, mesh: mesh_lib.Mesh | None = None,
                    profile_dir: str | None = None):
    """Analyze pre-tokenized ``.rawire`` file(s): no host parse.

    Registers and per-rule counts are bit-identical to a text run over
    the same logs.  Weighted (coalesced) files need a weight-linear
    ``match_impl`` (``scan``).
    """
    if isinstance(paths, str):
        paths = [paths]
    _arm_retry(cfg)  # before the source: opening a wire file is a retry seam
    return _run_core(packed, _WireFileSource(packed, paths), cfg, topk=topk,
                     return_state=return_state, max_chunks=max_chunks, mesh=mesh,
                     profile_dir=profile_dir)


def default_mesh(cfg: AnalysisConfig) -> mesh_lib.Mesh:
    """``cfg``'s mesh: every visible CUDA device, or the CPU with
    ``cfg.device="cpu"`` (no card is an error)."""
    device = resolve_device(cfg.device)
    return mesh_lib.make_mesh([device] if device.type == "cpu" else None,
                              topology=cfg.mesh_shape, dcn=cfg.mesh_dcn)


def _build_kernels(cfg: AnalysisConfig, mesh: mesh_lib.Mesh, has6: bool,
                   extra: tuple[str, ...] = ()) -> float:
    """Build and load the kernels a CUDA run needs (and ``extra`` ones);
    their seconds.

    The port has no jit: its one-time cost is building/loading the
    kernels, priced apart from the sustained rate like the reference's
    compile_sec.
    """
    if all(d.type != "cuda" for d in mesh.local_devices):
        return 0.0
    t0 = time.perf_counter()
    names = ([KERNEL_OF[cfg.match_impl], "reg_tail"] + (["first_match6"] if has6 else [])
             + list(extra))
    _build.build_all(names)  # one nvcc per source, in parallel
    for name in names:
        _build.library(name)
    return time.perf_counter() - t0


def _sync(mesh: mesh_lib.Mesh) -> None:
    for d in mesh.local_devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _profiler(profile_dir: str | None, mesh: mesh_lib.Mesh) -> Profiler:
    """The run's whole-loop profiler: CUDA activity on a CUDA mesh."""
    cuda = any(d.type == "cuda" for d in mesh.local_devices)
    return Profiler(profile_dir, device="cuda" if cuda else "cpu")


def _run_core(packed: PackedRuleset, source, cfg: AnalysisConfig, *, topk: int,
              return_state: bool = False, max_chunks: int | None = None,
              mesh: mesh_lib.Mesh | None = None, profile_dir: str | None = None):
    """Wrap the source (prefetch, coalescing), run it, release it; arm
    ``cfg.fault_plan`` for the run (a plan armed here is disarmed at its end)."""
    from . import flightrec

    armed_here = faults.arm_spec(cfg.fault_plan)
    coal = None
    try:
        if mesh is None:
            mesh = default_mesh(cfg)
        n_shards = mesh_lib.data_extent(mesh)
        batch_size = mesh_lib.pad_batch_size(cfg.batch_size, mesh)
        stacked = cfg.layout == "stacked"
        if getattr(source, "yields_wire_weighted", False):
            _check_weighted_input_config(cfg)
        coal = coalesce_mod.make_coalescer(cfg, batch_size, n_shards)
        if coal is not None:
            obs.register_sampler("coalesce", coal.sample_metrics)
        wire_src = getattr(source, "yields_wire", False)
        ring_src = getattr(source, "yields_ring", False)
        if ring_src:
            if coal is not None:
                raise AnalysisError(
                    "runtime coalescing is not available with the ring feeder (per-chip "
                    "shards compact independently, which would change batch grouping); "
                    "pre-coalesce with `convert --coalesce` or the convert fleet instead"
                )
            # one ring per shard of the mesh; with prefetch each ring's
            # view goes to its shard's device as it is, else (and for the
            # stacked layout, which groups on the loop) the feeder
            # assembles plain batches
            if not source.n_rings:
                source.n_rings = n_shards
            source.emit_views = cfg.prefetch_depth > 0 and not stacked

        def host_pack(b: np.ndarray) -> np.ndarray:
            """A source batch -> the uint32 layout that crosses to the card."""
            if coal is not None and coal.enabled():
                return coal.wire4(b) if wire_src else pack_mod.compact_batch_w(coal.tuple4(b))
            return b if wire_src else pack_mod.compact_batch(b)

        rings = None
        if cfg.prefetch_depth > 0:
            # depth queued + one in the step + one being packed, per shard
            rings = mesh_lib.make_rings(mesh, cfg.prefetch_depth + 2)
            if stacked:
                # the producer only parses (or reads): the loop groups the
                # batches and stages each grouped chunk through the rings
                pack = None
            elif ring_src:
                def pack(rb):
                    if len(mesh.devices) > 1:
                        return mesh_lib.shard_ring_batch(mesh, rb, rings)
                    # one device: every view packs into one pinned buffer
                    dev = mesh.devices[0]
                    return [views_to_device(rb, dev, rings[dev] if rings else None)]
            else:
                def pack(b):
                    return mesh_lib.shard_batch(mesh, host_pack(b), rings)
            source = PrefetchingSource(source, cfg.prefetch_depth, pack=pack,
                                       stall_timeout=cfg.stall_timeout_sec)
            stage = None
        else:
            def stage(b):
                with obs.span("ingest.pack"):
                    return mesh_lib.shard_batch(mesh, host_pack(b))

        return _run_loop(packed, source, cfg, mesh, batch_size, stage, coal, rings, topk=topk,
                         return_state=return_state, max_chunks=max_chunks,
                         profile_dir=profile_dir)
    except BaseException:
        # before the sources close: a crash dump keeps their last gauges
        flightrec.note_gauges()
        raise
    finally:
        if coal is not None:
            obs.unregister_sampler("coalesce")
        close = getattr(source, "close", None)
        if close is not None:
            close()
        if armed_here:
            # a plan this run armed (and its RA_FAULT_PLAN export) must
            # not leak into a later run in the same process
            faults.disarm()


class _Chunks:
    """What both run loops step with, and what they carry from chunk to chunk.

    The mesh's v4 step and rule tensors, and the v6 ones where the
    ruleset has v6 rows and the source can deliver v6 lines; the register
    replicas, the candidate tracker and the chunk count, which is the next
    chunk's salt.  Candidates drain to the tracker with a 2-chunk lag, so
    fetching them never waits on the chunk still in flight, and memory
    stays O(1) chunks.
    """

    def __init__(self, packed: PackedRuleset, cfg: AnalysisConfig, mesh: mesh_lib.Mesh,
                 source):
        self.cfg = cfg
        self.mesh = mesh
        self.source = source
        self.n_keys = packed.n_keys
        self.step = step_lib.make_parallel_step(mesh, cfg, packed.n_keys)
        self.rules = step_lib.ship(packed, mesh)
        self.has6 = packed.has_v6 and (hasattr(source, "take_v6") or hasattr(source, "batches6"))
        self.step6 = step_lib.make_parallel_step6(mesh, cfg, packed.n_keys) if self.has6 else None
        self.rules6 = step_lib.ship6(packed, mesh) if self.has6 else None
        self.state: tuple[pipeline.AnalysisState, ...] = ()
        self.tracker: TopKTracker | None = None
        self.n_chunks = 0
        self.pending: deque[pipeline.ChunkOut] = deque()

    def start(self, snap: ckpt.Snapshot | None, *, counters: bool = True) -> int:
        """Registers, tracker, source counters and chunk count from ``snap``
        (a resume), else zeroed; returns the lines (or rows) it covers.

        ``counters=False`` restores all but the source counters and the
        offset (returns 0): an elastic epoch holds the job's global
        counters, which rank 0 alone carries on, since the totals sum
        every rank's.
        """
        if snap is None:
            self.state = step_lib.init_state(self.n_keys, self.cfg, self.mesh)
            self.tracker = TopKTracker(self.cfg.sketch.topk_capacity)
            return 0
        self.state = step_lib.replicate(ckpt.state_of(snap, self.mesh.local_devices[0]),
                                        self.mesh)
        self.tracker = ckpt.restore_tracker(snap, self.cfg.sketch.topk_capacity)
        _restore_v6_digests(self.source, snap)
        self.n_chunks = snap.n_chunks
        if not counters:
            return 0
        self.source.set_counts(snap.parsed, snap.skipped)
        return snap.lines_consumed

    def run(self, shards) -> None:
        """Step one v4 chunk (``mesh.shard_batch`` or ``shard_grouped`` shards)."""
        self._run("v4", self.step, self.rules, shards)

    def run6(self, shards) -> None:
        """Step one v6 chunk."""
        self._run("v6", self.step6, self.rules6, shards)

    def _run(self, kind: str, step, rules, shards) -> None:
        # salt = chunk index: re-randomizes candidate-table slots per
        # chunk, as in the reference (zero-valid text batches do not
        # step and do not advance it); a resume replays it from the
        # snapshot's chunk count
        rec = obs.recording()  # a tracer shard or the flight-recorder ring
        t0 = time.perf_counter() if rec else 0.0
        batches = [b.use() for b in shards]
        cap = devprof.active_capture()
        if cap is None:
            self.state, out = step(self.state, rules, batches, salt=self.n_chunks)
        else:
            # the capture window's seam: it counts the dispatch and, inside
            # its window, runs it in the program's range
            label = "step.v6" if kind == "v6" else f"step.{self.cfg.layout}"
            self.state, out = cap.dispatch(label, step, (self.state, rules, batches, self.n_chunks),
                                           device=self.mesh.local_devices[0])
        if rec:
            # host dispatch only: the kernels run on after this returns
            obs.complete("step.dispatch", t0, time.perf_counter(), cat="step",
                         args={"kind": kind})
        self.pending.append(out)
        if len(self.pending) > 2:
            self._offer(self.pending.popleft())
        self.n_chunks += 1

    def _offer(self, out: pipeline.ChunkOut) -> None:
        self.tracker.offer_chunk(out.cand_acl.cpu(), out.cand_src.cpu(), out.cand_est.cpu())

    def drain(self) -> None:
        """Offer every pending chunk's candidates."""
        while self.pending:
            self._offer(self.pending.popleft())

    def save(self, ckpt_dir: str, fp: str, lines_consumed: int) -> None:
        """Snapshot the registers, which must cover exactly ``lines_consumed``
        (the caller steps what it holds back first)."""
        self.drain()
        packer = self.source.packer
        ckpt.save(ckpt_dir, ckpt.snapshot_of(
            self.state[0], lines_consumed=lines_consumed, n_chunks=self.n_chunks,
            parsed=packer.parsed, skipped=packer.skipped, tracker=self.tracker,
            fingerprint=fp, extra=_v6_digest_extra(self.source, self.tracker),
        ))

    def result(self, packed: PackedRuleset, *, topk: int, totals: dict,
               v6_digests: dict | None, return_state: bool):
        """The Report (and the registers with ``return_state``)."""
        report = pipeline.finalize(
            self.state[0], packed, self.cfg, self.tracker, topk=topk, totals=totals,
            backend=f"torch-{self.mesh.local_devices[0].type}", v6_digests=v6_digests,
        )
        if return_state:
            return report, pipeline.state_to_numpy(self.state[0])
        return report


class _V6Chunks:
    """A text source's staged v6 evaluations (``take_v6``), cut into
    ``[TUPLE6_COLS, width]`` chunks in staging order.  A wire file's v6
    rows come in its own phase (``batches6``), not here."""

    def __init__(self, source, width: int):
        self._take = getattr(source, "take_v6", None)
        self._width = width
        self._buf: np.ndarray | None = None
        self._fill = 0

    def full(self) -> list[np.ndarray]:
        """The chunks that the rows staged since the last call fill."""
        rows = self._take() if self._take is not None else []
        out = []
        i = 0
        while i < len(rows):
            if self._buf is None:
                self._buf = np.zeros((TUPLE6_COLS, self._width), dtype=np.uint32)
            take = min(self._width - self._fill, len(rows) - i)
            self._buf[:, self._fill:self._fill + take] = np.asarray(rows[i:i + take],
                                                                    dtype=np.uint32).T
            self._fill += take
            i += take
            if self._fill == self._width:
                out.append(self._buf)
                self._buf, self._fill = None, 0
        return out

    def flush(self) -> list[np.ndarray]:
        """Every staged row: the full chunks, then the partial one (its
        padding columns carry valid=0)."""
        out = self.full()
        if self._fill:
            out.append(self._buf)
            self._buf, self._fill = None, 0
        return out


def _stacked_lane(cfg: AnalysisConfig, packed: PackedRuleset, mesh: mesh_lib.Mesh) -> int:
    """This process's per-ACL lane of a stacked grouped batch: the global
    lane padded to the mesh, split over the processes."""
    lane = cfg.stacked_lane or max(1, cfg.batch_size // max(1, packed.n_acls))
    nproc = mesh.n_processes
    return mesh_lib.pad_batch_size(lane * nproc, mesh) // nproc


def _fingerprint(packed: PackedRuleset, cfg: AnalysisConfig, mesh: mesh_lib.Mesh, lane: int,
                 source, suffix: str = "") -> str:
    """The snapshot fingerprint.  Wire offsets count rows and text offsets
    lines, so a snapshot must not resume across input kinds (nor a
    weighted file's stored-row offsets a plain file's)."""
    kind = ""
    if getattr(source, "yields_wire", False):
        kind = "-wirew" if getattr(source, "yields_wire_weighted", False) else "-wire"
    return (ckpt.fingerprint(packed, cfg, lane, n_shards=mesh_lib.data_extent(mesh))
            + suffix + kind)


def _totals(counts: dict, *, chunks: int, lines_this_run: int, elapsed: float,
            compile_sec: float, meter: ThroughputMeter, source, rings, **extra) -> dict:
    """A run's ``totals``: ``counts`` (lines total, matched and skipped,
    cumulative across resumes), the chunk count, ``extra``, then this
    run's rates (its lines over its time) and ingest accounting."""
    sustained = elapsed - compile_sec
    totals = {
        **counts,
        "chunks": chunks,
        **extra,
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
        if rings is not None:
            totals["ingest"]["h2d_bytes"], totals["ingest"]["pinned_buffers"] = (
                mesh_lib.ring_totals(rings))
        lat = source.latency_summary()
        if lat:
            totals["latency"] = lat
    return totals


def _run_loop(packed, source, cfg, mesh, batch_size, stage, coal, rings, *, topk: int,
              return_state: bool, max_chunks: int | None, profile_dir: str | None):
    if packed.bindings_out and batch_size < 2:
        raise AnalysisError(
            "batch_size must be >= 2 when out-direction access-groups are "
            "bound: one connection line can emit two ACL evaluations"
        )
    chunks = _Chunks(packed, cfg, mesh, source)
    lane = 0
    gbuf = None
    if cfg.layout == "stacked":
        # lines bucket by ACL on the host; each shard of a grouped batch
        # steps as the flat batch of its lanes in group-major order
        # (run_grouped); the lane pads to the mesh
        lane = _stacked_lane(cfg, packed, mesh)
        gbuf = pack_mod.GroupBuffer(max(packed.n_acls, 1), lane)
    has6 = chunks.has6
    packer = source.packer
    wire_src = getattr(source, "yields_wire", False)
    # rows fed to the group buffer may carry weights > 1: a grouped chunk
    # then crosses weighted, or a 1-bit valid would crush a weight-w row
    weighted_rows = coal is not None or getattr(source, "yields_wire_weighted", False)
    fp = _fingerprint(packed, cfg, mesh, lane, source)
    snap = ckpt.load(cfg.checkpoint_dir) if cfg.resume else None
    if snap is not None and snap.fingerprint != fp:
        raise ckpt.CheckpointMismatch(
            f"snapshot in {cfg.checkpoint_dir!r} was taken with a different "
            "ruleset, sketch geometry, batch size, layout, device count, or input "
            "kind; refusing to merge"
        )
    lines_consumed = chunks.start(snap)
    meter = ThroughputMeter(cfg.report_every_chunks)
    compile_sec = _build_kernels(cfg, mesh, has6)

    def run_grouped(grouped: np.ndarray) -> None:
        # a grouped chunk is G * lane lines wide, not batch_size: the
        # rings' pinned buffers are (re)made for its shape
        with obs.span("ingest.pack"):
            shards = mesh_lib.shard_grouped(mesh, grouped, weighted_rows, rings)
        chunks.run(shards)

    def group(batch: np.ndarray) -> None:
        # bucket a source batch by ACL; coalescing compacts it first, so
        # lanes fill at the unique-row rate, as in the reference
        cols = pack_mod.expand_batch(batch) if wire_src else batch
        if coal is not None and coal.enabled():
            cols = coal.tuple4(cols, pad=False)
        for grouped in gbuf.add(np.ascontiguousarray(cols.T)):
            run_grouped(grouped)

    def run_chunk6(batch6: np.ndarray) -> None:
        if coal is not None and coal.enabled():
            # v6 chunks coalesce at step time: tuple batches carry the
            # weights in T6_VALID, wire batches grow the weights row
            batch6 = (coal.tuple6(batch6) if batch6.shape[0] == TUPLE6_COLS
                      else coal.wire6(batch6))
        chunks.run6(mesh_lib.shard_batch(mesh, batch6))

    # the v6 rows staged with the batches consumed so far step as each
    # chunk fills; the partial chunk after the v4 stream and before every
    # snapshot
    v6 = _V6Chunks(source, batch_size)
    last_snap_chunks = chunks.n_chunks  # the cadence counts device chunks since the last save

    def save_snapshot() -> None:
        # the registers must cover exactly lines_consumed: step the lines
        # the group buffer holds back and the staged v6 rows first
        nonlocal last_snap_chunks
        if gbuf is not None:
            for grouped in gbuf.flush():
                run_grouped(grouped)
        if has6:
            for b6 in v6.flush():
                run_chunk6(b6)
        last_snap_chunks = chunks.n_chunks
        chunks.save(cfg.checkpoint_dir, fp, lines_consumed)

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
                and chunks.n_chunks - last_snap_chunks >= cfg.checkpoint_every_chunks):
            save_snapshot()
        return max_chunks is not None and chunks_this_run >= max_chunks

    lines_at_start = lines_consumed  # nonzero after a resume
    chunks_this_run = 0  # source batches, stepped or not: what max_chunks counts
    aborted = False
    # the profiler's window is the whole loop, drained and synchronised,
    # so every launched kernel's record is in it; the rate covers the
    # profiled loop, not the trace's stop and export
    with _profiler(profile_dir, mesh):
        for batch, n_raw in source.batches(lines_consumed, batch_size):
            if batch is not None:
                if gbuf is not None:
                    group(batch)
                else:
                    # prefetched batches arrive as device batches; the
                    # synchronous loop packs (16 B/line wire layout) and copies
                    chunks.run(batch if stage is None else stage(batch))
            if has6:
                for b6 in v6.full():
                    run_chunk6(b6)
            if after_chunk(n_raw, batch is not None):
                aborted = True  # a simulated crash: no final snapshot
                break
        if gbuf is not None:
            # the buffered lines are in lines_consumed and the counters, so
            # they step on an abort too (the crash is the skipped final save)
            for grouped in gbuf.flush():
                run_grouped(grouped)
        if has6:
            for b6 in v6.flush():
                run_chunk6(b6)
            # phase 2: a wire file's v6 section, after every v4 block; resume
            # offsets run on over the v4-then-v6 row stream
            if hasattr(source, "batches6") and not aborted:
                for b6, n6 in source.batches6(max(0, lines_at_start - source.n4_rows),
                                              batch_size):
                    run_chunk6(b6)
                    if after_chunk(n6, True):
                        aborted = True
                        break
        _sync(mesh)
        elapsed = meter.elapsed()
    chunks.drain()
    if cfg.checkpoint_every_chunks and not aborted:
        save_snapshot()

    totals = _totals(
        {"lines_total": lines_consumed, "lines_matched": packer.parsed,
         "lines_skipped": packer.skipped},
        chunks=chunks.n_chunks, lines_this_run=lines_consumed - lines_at_start,
        elapsed=elapsed, compile_sec=compile_sec, meter=meter, source=source, rings=rings,
    )
    if coal is not None:
        totals["coalesce"] = coal.summary()
    dp = devprof.finalize_if_armed()
    if dp is not None:
        # the capture window's per-stage attribution, parsed after elapsed
        # was taken; volatile: the rest of the report is the disarmed run's
        totals["devprof"] = dp
    patch = getattr(source, "totals_patch", None)
    if patch is not None:
        # wire input: the converter's raw-line accounting (rows != lines)
        # once the whole file was read
        totals.update(patch(not aborted))
    digests = getattr(source, "v6_digests", None)
    return chunks.result(
        packed, topk=topk, totals=totals, return_state=return_state,
        v6_digests=_needed_v6_digests(chunks.tracker, digests) if digests else None,
    )


def _dist_ckpt_layout_error(ckpt_dir: str, nproc: int) -> str | None:
    """Error message if resuming this process layout would silently restart.

    Snapshot subdirectories are named ``proc-<i>-of-<n>``.  Directories of
    another ``n`` are fatal only when none of this ``n`` exist: a resume
    would then find nothing and start from scratch although an older
    layout's checkpoint is there.  Beside a current-layout set they are
    stale and ignored.
    """
    import re

    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return None
    foreign = set()
    have_matching = False
    for e in entries:
        m = re.fullmatch(r"proc-\d+-of-(\d+)", e)
        if not m:
            continue
        if int(m.group(1)) == nproc:
            have_matching = True
        else:
            foreign.add(int(m.group(1)))
    if foreign and not have_matching:
        return (
            f"{ckpt_dir!r} holds snapshots from a {sorted(foreign)[0]}-process run; "
            f"this job has {nproc} processes"
        )
    return None


def _dist_resume(cfg: AnalysisConfig, my_dir: str, fp: str, nproc: int, dist):
    """Every process's resume verdict, raised alike everywhere.

    Each process classifies its own snapshot first and one gather decides:
    a lone raise would leave the other processes waiting in the next
    collective.  Returns this process's snapshot, or None.
    """
    layout_err = _dist_ckpt_layout_error(cfg.checkpoint_dir, nproc)
    corrupt_err = None
    snap = None
    if layout_err is None:
        try:
            snap = ckpt.load(my_dir)
        except (ckpt.CheckpointCorrupt, OSError) as e:
            corrupt_err = e
    if layout_err is not None:
        local_state = 3  # foreign process layout
    elif corrupt_err is not None:
        local_state = 4  # undecodable snapshot on this process
    elif snap is not None:
        local_state = 1 if snap.fingerprint == fp else 2
    else:
        local_state = 0
    states = dist.value_across_processes(local_state)
    chunks_all = dist.value_across_processes(snap.n_chunks if snap is not None else -1)
    if (states == 4).any():
        raise ckpt.CheckpointCorrupt(
            str(corrupt_err) if corrupt_err is not None
            else f"another process found an undecodable snapshot in {cfg.checkpoint_dir!r}"
        )
    if (states == 3).any():
        raise ckpt.CheckpointMismatch(
            layout_err
            or f"another process found a foreign process layout in {cfg.checkpoint_dir!r}"
        )
    if (states == 2).any():
        raise ckpt.CheckpointMismatch(
            f"snapshot under {cfg.checkpoint_dir!r} was taken with a different ruleset, "
            "geometry, or process layout; refusing to merge"
        )
    n_have = int((states == 1).sum())
    if 0 < n_have < nproc:
        raise ckpt.CheckpointMismatch(
            f"only {n_have}/{nproc} processes found a snapshot in {cfg.checkpoint_dir!r}; "
            "all or none must resume"
        )
    if n_have and not (chunks_all == chunks_all[0]).all():
        raise ckpt.CheckpointMismatch(
            f"processes hold snapshots from different chunk counts ({chunks_all.tolist()}); "
            "the checkpoint is inconsistent"
        )
    return snap


def _elastic_epoch(elastic, fp: str, dist) -> ckpt.Snapshot | None:
    """The generation's epoch snapshot, checked: its fingerprint, and (one
    gather) that every process loaded the same epoch."""
    snap = elastic.snapshot
    if snap is not None and snap.fingerprint != fp:
        raise ckpt.CheckpointMismatch(
            f"elastic epoch snapshot in {elastic.epoch_dir!r} was taken with a different "
            "ruleset, sketch geometry, or layout; refusing to merge"
        )
    chunks_all = dist.value_across_processes(snap.n_chunks if snap is not None else -1)
    if not (chunks_all == chunks_all[0]).all():
        raise ckpt.CheckpointMismatch(
            f"processes loaded different elastic epoch snapshots ({chunks_all.tolist()}); "
            "shared storage is inconsistent"
        )
    return snap


def run_stream_file_distributed(packed: PackedRuleset, local_paths: str | list[str],
                                cfg: AnalysisConfig, *, native: bool | None = None,
                                topk: int = 10, return_state: bool = False,
                                max_chunks: int | None = None,
                                mesh: mesh_lib.Mesh | None = None,
                                profile_dir: str | None = None, elastic=None):
    """Multi-process analysis: each process feeds ITS OWN input split.

    ``parallel.distributed.init_distributed`` must have run.  ``mesh``
    (default ``make_global_mesh`` over ``cfg``'s topology: one device a
    process) spans every process; each global batch of
    ``pad_batch_size(batch_size * n_processes)`` columns is this process's
    local batch on its devices, process-major.  The loop is collective:
    every process steps while any has input, padding with all-invalid
    batches (text, wire, flat or stacked, and the v6 side path in its own
    lockstep rounds), so all step the same chunks and hold the same
    registers.  Every process returns the same Report, whose ``totals``
    sum every process's counters and carry ``processes``.

    Checkpoints: each process snapshots into
    ``checkpoint_dir/proc-<i>-of-<n>`` (the registers are replicated, the
    offset is into its own split), fingerprinted with ``-dist<i>of<n>``;
    a resume checks every process's snapshot in lockstep and refuses a
    changed process count or a damaged snapshot on any process, everywhere.
    ``profile_dir``: each process writes its own ``torch.profiler`` trace
    of its loop there.

    ``elastic`` (a ``runtime.elastic.ElasticRunSpec``) runs one generation
    of the supervised elastic tier: the source is a per-shard cursor
    source over the spec's assignments (``local_paths`` is ignored), and
    the per-process snapshots give way to ONE epoch snapshot in
    ``spec.epoch_dir`` (the replicated registers, the global counters and
    the merged cursor manifest), which rank 0 writes.  Its fingerprint
    leaves out the mesh width and the process layout, so a re-formed
    cluster of any surviving size resumes it; the order-invariant
    registers, and so the counts and the unused set, come out as an
    uninterrupted run's.  ``runtime.elastic.ElasticSupervisor`` drives it.
    """
    from ..hostside import fastparse
    from . import flightrec
    from ..hostside.wire import is_wire_file
    from ..parallel import distributed as dist

    stacked = cfg.layout == "stacked"
    if cfg.coalesce != "off":
        # per-process unique-row counts diverge, and every process must
        # step batches of one width
        raise AnalysisError(
            "coalesce applies to the single-process stream drivers only; "
            "for distributed runs convert the input with "
            "`ruleset-analyze convert --coalesce` instead"
        )
    if isinstance(local_paths, str):
        local_paths = [local_paths]
    _arm_retry(cfg)  # before the source: opening a wire file is a retry seam
    n_wire = sum(1 for p in local_paths if is_wire_file(p))
    if n_wire and n_wire < len(local_paths):
        raise AnalysisError("cannot mix .rawire and text inputs in one --logs list")
    if elastic is not None:
        source = _ShardCursorSource(
            packed, elastic.assignments, fastparse.available() if native is None else native,
            die_after_batches=elastic.die_after_batches, pace_sec=elastic.pace_sec)
    elif n_wire:
        source = _WireFileSource(packed, local_paths)
    else:
        if native is None:
            native = fastparse.available()
        source = (_FileSource(packed, local_paths) if native
                  else _TextSource(packed, _iter_files(local_paths)))
    armed_here = faults.arm_spec(cfg.fault_plan)
    # the producer overlaps this process's parse (and, for flat text, the
    # wire bit-pack) with the collective rounds; the consumer shards.  Its
    # counters, v6 rows and elastic cursors commit as the loop consumes
    # each batch, so an epoch snapshot names the last batch stepped
    prepacked = False
    if cfg.prefetch_depth > 0:
        pack_fn = None
        if not stacked and not n_wire:
            pack_fn = pack_mod.compact_batch
            prepacked = True
        source = PrefetchingSource(source, cfg.prefetch_depth, pack=pack_fn,
                                   stall_timeout=cfg.stall_timeout_sec)
    try:
        wire_src = getattr(source, "yields_wire", False)
        wire_weighted = getattr(source, "yields_wire_weighted", False)
        if wire_weighted:
            _check_weighted_input_config(cfg)
        if mesh is None:
            mesh = dist.make_global_mesh(topology=cfg.mesh_shape, dcn=cfg.mesh_dcn)
        pid, nproc = mesh.process_index, mesh.n_processes
        global_batch = mesh_lib.pad_batch_size(
            max(cfg.batch_size, 2 if packed.bindings_out else 1) * nproc, mesh)
        local_batch = global_batch // nproc
        local_lane = 0
        gbuf = None
        if stacked:
            # per-GLOBAL-batch lane, sharded over every device; each
            # process fills its local lanes from its own group buffer
            local_lane = _stacked_lane(cfg, packed, mesh)
            gbuf = pack_mod.GroupBuffer(max(packed.n_acls, 1), local_lane)
        chunks = _Chunks(packed, cfg, mesh, source)
        # the v6 side path: rows stage per process at a data-dependent
        # rate, so full chunks step in their own lockstep rounds
        has6 = chunks.has6
        v6 = _V6Chunks(source, local_batch)
        ready6: deque[np.ndarray] = deque()  # full [TUPLE6_COLS, local_batch] chunks
        packer = source.packer
        meter = ThroughputMeter(cfg.report_every_chunks)
        compile_sec = _build_kernels(cfg, mesh, has6)
        # each round's v4 batch crosses through pinned buffers (one in the
        # step, one being copied); v6 chunks take a plain copy, as in _run_loop
        rings = mesh_lib.make_rings(mesh, 2)

        my_ckpt_dir = os.path.join(cfg.checkpoint_dir, f"proc-{pid}-of-{nproc}")
        if elastic is not None:
            # world-size-independent: no mesh width, no process layout
            fp = ckpt.fingerprint(packed, cfg, lane=0, n_shards=1) + "-elastic"
            # after the kernel build: the gather must not wait on a peer's nvcc
            snap = _elastic_epoch(elastic, fp, dist)
            lines_consumed = chunks.start(snap, counters=pid == 0)
        else:
            fp = _fingerprint(packed, cfg, mesh, local_lane, source, f"-dist{pid}of{nproc}")
            snap = _dist_resume(cfg, my_ckpt_dir, fp, nproc, dist) if cfg.resume else None
            lines_consumed = chunks.start(snap)
        lines_at_start = lines_consumed

        def drain_v6_rounds() -> None:
            # full v6 chunks step in lockstep: one tiny all-reduce a round
            while True:
                has = bool(ready6)
                if not dist.all_processes_have_data(has):
                    break
                b = ready6.popleft() if has else np.zeros((TUPLE6_COLS, local_batch),
                                                          dtype=np.uint32)
                chunks.run6(mesh_lib.shard_batch(mesh, b))

        def collective_flush_v6() -> None:
            # a snapshot or the end: every staged row steps, the partial
            # chunk too, so no consumed line is in limbo
            if has6:
                ready6.extend(v6.flush())
                drain_v6_rounds()

        # stacked: grouped batches emit at a data-dependent cadence, so a
        # ready queue decouples source pulls from the rounds; each round
        # steps at most one grouped batch a process, padding when dry
        ready: deque[np.ndarray] = deque()
        src_done = False
        # an elastic source resumes at its shard cursors: rank 0's offset
        # is the job's global base, not a skip
        it = source.batches(0 if elastic is not None else lines_consumed, local_batch)

        def step_grouped_round(has: bool) -> None:
            grouped = ready.popleft() if has else np.zeros(
                (max(packed.n_acls, 1), TUPLE_COLS, local_lane), dtype=np.uint32)
            with obs.span("ingest.pack"):
                shards = mesh_lib.shard_grouped(mesh, grouped, wire_weighted, rings)
            chunks.run(shards)

        def collective_flush() -> None:
            # every buffered lane steps, in lockstep rounds, so all
            # processes reach one chunk count (the stacked snapshot
            # barrier, and the end of an aborted run)
            ready.extend(gbuf.flush())
            while True:
                has = bool(ready)
                if not dist.all_processes_have_data(has):
                    break
                step_grouped_round(has)

        def save_epoch_snapshot() -> None:
            # every rank takes part in the gathers; the generation's rank
            # 0 writes (atomically), so every survivor loads one epoch
            chunks.drain()
            cursors = dict(elastic.base_cursors)
            done = set(elastic.base_done)
            for r in dist.allgather_rows(source.cursor_rows()):
                cursors[int(r[0])] = int(r[1]) | (int(r[2]) << 32)
                if int(r[3]):
                    done.add(int(r[0]))
            agg = dist.sum_across_processes({"lines": lines_consumed, "parsed": packer.parsed,
                                             "skipped": packer.skipped})
            # each rank maps its own sources: the epoch keeps the union, so
            # any surviving world renders every tracked v6 talker
            dig = getattr(source, "v6_digests", None) or {}
            rows = np.array([(d, *pack_mod.u128_limbs(a)) for d, a in
                             _needed_v6_digests(chunks.tracker, dig).items()],
                            dtype=np.uint32).reshape(-1, 5)
            merged = dist.allgather_rows(rows)
            if pid != 0:
                return
            digests = [[int(r[0]), pack_mod.limbs_u128(*(int(x) for x in r[1:5]))]
                       for r in merged]
            ckpt.save(elastic.epoch_dir, ckpt.snapshot_of(
                chunks.state[0], lines_consumed=agg["lines"], n_chunks=chunks.n_chunks,
                parsed=agg["parsed"], skipped=agg["skipped"], tracker=chunks.tracker,
                fingerprint=fp, extra={
                    **({"v6_digests": digests} if digests else {}),
                    "elastic": {
                        "epoch": elastic.epoch,
                        "world": nproc,
                        "shards": list(elastic.shards),
                        "cursors": {str(k): v for k, v in sorted(cursors.items())},
                        "done": sorted(done),
                    },
                },
            ))

        def save_snapshot() -> None:
            if stacked:
                collective_flush()
            collective_flush_v6()
            if elastic is not None:
                save_epoch_snapshot()
            else:
                chunks.save(my_ckpt_dir, fp, lines_consumed)

        def refill_ready() -> None:
            nonlocal src_done, lines_consumed
            while not ready and not src_done:
                nxt = next(it, None)
                if nxt is None:
                    src_done = True
                    ready.extend(gbuf.flush())
                    return
                batch_np, n_raw = nxt
                lines_consumed += n_raw
                meter.tick(n_raw)
                if batch_np is None:  # a zero-valid text batch: lines only
                    continue
                cols = pack_mod.expand_batch(batch_np) if wire_src else batch_np
                ready.extend(gbuf.add(np.ascontiguousarray(cols.T)))

        def next_real():
            # the next batch that needs a step; zero-valid (None) text
            # batches are lines to account, not rounds
            nonlocal lines_consumed
            while True:
                nxt = next(it, None)
                if nxt is None or nxt[0] is not None:
                    return nxt
                lines_consumed += nxt[1]
                meter.tick(nxt[1])
                if has6:
                    ready6.extend(v6.full())

        if stacked:
            empty = None
        elif wire_src or prepacked:
            cols_n = (pack_mod.WIREW_COLS if wire_weighted else pack_mod.WIRE_COLS)
            empty = np.zeros((cols_n, local_batch), dtype=np.uint32)
        else:
            empty = np.zeros((TUPLE_COLS, local_batch), dtype=np.uint32)
        last_snap_chunks = chunks.n_chunks
        chunks_this_run = 0
        aborted = False

        def after_round() -> bool:
            """Snapshot on the cadence (the loop is collective: every process
            reaches it at the same chunk count); True = stop here."""
            nonlocal chunks_this_run, last_snap_chunks
            chunks_this_run += 1
            if (cfg.checkpoint_every_chunks
                    and chunks.n_chunks - last_snap_chunks >= cfg.checkpoint_every_chunks):
                save_snapshot()
                last_snap_chunks = chunks.n_chunks
            return max_chunks is not None and chunks_this_run >= max_chunks

        # as in _run_loop: the whole loop, drained and synchronised
        with _profiler(profile_dir, mesh):
            while True:
                if stacked:
                    refill_ready()
                    has = bool(ready)
                else:
                    nxt = next_real()
                    has = nxt is not None
                # everyone steps while anyone has data
                if not dist.all_processes_have_data(has):
                    break
                if stacked:
                    step_grouped_round(has)
                else:
                    batch_np, n_raw = nxt if has else (empty, 0)
                    lines_consumed += n_raw
                    meter.tick(n_raw)
                    with obs.span("ingest.pack"):
                        wire = (batch_np if wire_src or prepacked
                                else pack_mod.compact_batch(batch_np))
                        shards = mesh_lib.shard_batch(mesh, wire, rings)
                    chunks.run(shards)
                if has6:
                    ready6.extend(v6.full())
                    drain_v6_rounds()
                if after_round():
                    aborted = True  # a simulated crash: no final snapshot
                    break
            if stacked and aborted:
                # the buffered lines are in lines_consumed and the counters:
                # they step after an abort too, collectively
                src_done = True
                collective_flush()
            # phase 2: wire v6 sections, in collective rounds
            b6fn = getattr(source, "batches6", None)
            if b6fn is not None and has6 and not aborted:
                it6 = b6fn(max(0, lines_at_start - source.n4_rows), local_batch)
                while True:
                    nxt6 = next(it6, None)
                    have = nxt6 is not None
                    if not dist.all_processes_have_data(have):
                        break
                    if have:
                        b6, n_rows6 = nxt6
                        lines_consumed += n_rows6
                        meter.tick(n_rows6)
                    else:
                        b6 = np.zeros((pack_mod.WIRE6W_COLS if wire_weighted else pack_mod.WIRE6_COLS,
                                       local_batch), dtype=np.uint32)
                    chunks.run6(mesh_lib.shard_batch(mesh, b6))
                    if after_round():
                        aborted = True
                        break
            # the v6 rows of consumed lines step on every exit
            collective_flush_v6()

            _sync(mesh)
            elapsed = meter.elapsed()
        if cfg.checkpoint_every_chunks and not aborted:
            save_snapshot()
        chunks.drain()
        local_total, local_skipped = lines_consumed, packer.skipped
        if wire_src and not aborted:
            # the converter's raw-line accounting of this fully read split
            p = source.totals_patch(True)
            local_total, local_skipped = p["lines_total"], p["lines_skipped"]
        agg = dist.sum_across_processes({
            "lines_total": local_total,
            "lines_matched": packer.parsed,
            "lines_skipped": local_skipped,
            "lines_this_run": lines_consumed - lines_at_start,
        })
        lines_this_run = agg.pop("lines_this_run")
        totals = _totals(agg, chunks=chunks.n_chunks, lines_this_run=lines_this_run,
                         elapsed=elapsed, compile_sec=compile_sec, meter=meter, source=source,
                         rings=rings, processes=nproc)
        if elastic is not None:
            # the generation of the elastic cluster that produced the report
            totals["elastic_epoch"] = elastic.epoch
        v6_digests = getattr(source, "v6_digests", None)
        if has6:
            # each process maps only its own split's sources: gather the
            # rows the tracked v6 talkers need, so every process renders
            # the same report
            local = v6_digests or {}
            tag = pipeline.V6_ACL_TAG
            needed = {int(s) for gid, table in chunks.tracker.tables().items() if int(gid) & tag
                      for s in table}
            rows = np.array([(d, *pack_mod.u128_limbs(local[d])) for d in sorted(needed)
                             if d in local], dtype=np.uint32).reshape(-1, 5)
            merged = dist.allgather_rows(rows)
            v6_digests = {int(r[0]): pack_mod.limbs_u128(*(int(x) for x in r[1:5]))
                          for r in merged}
        return chunks.result(packed, topk=topk, totals=totals, v6_digests=v6_digests,
                             return_state=return_state)
    except BaseException:
        flightrec.note_gauges()  # as in _run_core
        raise
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()
        if armed_here:
            faults.disarm()
