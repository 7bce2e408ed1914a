"""Streaming loop: host text -> packed batches -> device steps -> Report.

Counterpart of the reference's ``runtime/stream.py`` (``run_stream``,
``run_stream_file`` and ``_run_core_impl``) on one device: the same
batch boundaries (:class:`LineBatcher`), salt = chunk index, a pending
drain of depth 2 that offers candidates to the tracker in chunk order,
wire-layout host-to-device transfer (16 B/line), and the same ``totals``
keys.  Reports equal the reference's apart from ``VOLATILE_TOTALS`` and
``totals.backend``.

The device is CUDA unless the caller passes ``device="cpu"``; without a
card that is an error, never a quiet run on the CPU.
"""

from __future__ import annotations

import time
from collections import deque
from collections.abc import Iterable, Iterator

import numpy as np
import torch

from ..config import AnalysisConfig
from ..errors import AnalysisError, DeviceUnavailable
from ..hostside import pack as pack_mod
from ..hostside.pack import TUPLE_COLS, LinePacker, PackedRuleset
from ..hostside.syslog import parse_line
from ..models import pipeline
from ..ops import _build
from ..ops.topk import TopKTracker

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
    """Push-based core of the text batching rules (the reference's, v4 only).

    Batches are line-atomic: each holds a whole number of raw lines and at
    most ``batch_size`` tuple rows.  A batch normally covers exactly
    ``batch_size`` raw lines, but closes early when the next line's
    evaluations would not fit (a connection line evaluated against both an
    ``in`` and an ``out`` ACL emits two rows).  A batch whose raw lines
    produced no tuple row is emitted as ``(None, n_raw)``.  IPv6 lines
    against a v4 ruleset are counted as skipped, as in the reference.
    """

    def __init__(self, packer: LinePacker, batch_size: int):
        self.packer = packer
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
            gids = []  # v6 traffic vs a pure-v4 ruleset: counted skip
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


def text_batches(packer: LinePacker, lines: Iterable[str],
                 batch_size: int) -> Iterator[tuple[np.ndarray | None, int]]:
    """``(batch [TUPLE_COLS, B] | None, n_raw_lines)`` events over ``lines``."""
    b = LineBatcher(packer, batch_size)
    for line in lines:
        yield from b.push(line)
    tail = b.flush()
    if tail is not None:
        yield tail


class ThroughputMeter:
    """Cumulative lines/sec of one run (the reference meter's summary)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.lines = 0
        self.chunks = 0

    def tick(self, n_lines: int) -> None:
        self.lines += n_lines
        self.chunks += 1

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def summary(self) -> dict:
        elapsed = self.elapsed()
        return {
            "chunks_ticked": self.chunks,
            "lines": self.lines,
            "elapsed_sec": round(elapsed, 4),
            "lines_per_sec_cum": (
                round(self.lines / elapsed, 1) if elapsed > 0 else 0.0
            ),
        }


def _iter_files(paths: list[str]):
    for path in paths:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            yield from f


def run_stream(packed: PackedRuleset, lines: Iterable[str], cfg: AnalysisConfig,
               *, topk: int = 10):
    """Analyze an iterable of syslog lines; returns the Report."""
    return _run_core(packed, lines, cfg, topk=topk)


def run_stream_file(packed: PackedRuleset, paths: str | list[str], cfg: AnalysisConfig,
                    *, topk: int = 10):
    """Analyze syslog file(s) with the pure-Python line parser."""
    if isinstance(paths, str):
        paths = [paths]
    return _run_core(packed, _iter_files(paths), cfg, topk=topk)


def _run_core(packed: PackedRuleset, lines: Iterable[str], cfg: AnalysisConfig, *, topk: int):
    device = resolve_device(cfg.device)
    batch_size = cfg.batch_size
    if packed.bindings_out and batch_size < 2:
        raise AnalysisError(
            "batch_size must be >= 2 when out-direction access-groups are "
            "bound: one connection line can emit two ACL evaluations"
        )
    dev_rules = pipeline.ship_ruleset(packed, device)
    state = pipeline.init_state(packed.n_keys, cfg, device)
    tracker = TopKTracker(cfg.sketch.topk_capacity)
    packer = LinePacker(packed)
    meter = ThroughputMeter()
    # the port has no jit: its one-time cost is building/loading the
    # match kernel, priced apart from the sustained rate like the
    # reference's compile_sec
    compile_sec = 0.0
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.library(KERNEL_OF[cfg.match_impl])
        compile_sec = time.perf_counter() - t0

    def drain(out: pipeline.ChunkOut) -> None:
        tracker.offer_chunk(out.cand_acl.cpu(), out.cand_src.cpu(), out.cand_est.cpu())

    # candidates drain with a 2-chunk lag, so fetching them never waits
    # on the chunk still in flight, and memory stays O(1) chunks
    pending: deque[pipeline.ChunkOut] = deque()
    lines_consumed = 0
    n_chunks = 0
    for batch_np, n_raw in text_batches(packer, lines, batch_size):
        if batch_np is not None:
            # ship the bit-packed wire layout (16 B/line); the device
            # unpack is three shifts and masks (pipeline.batch_cols)
            wire = pack_mod.compact_batch(batch_np)
            batch_dev = torch.from_numpy(wire.view(np.int32)).to(device)
            # salt = chunk index: re-randomizes candidate-table slots per
            # chunk, as in the reference (zero-valid batches do not step
            # and do not advance it)
            state, out = pipeline.analysis_step(
                state, dev_rules, batch_dev,
                n_keys=packed.n_keys,
                topk_k=cfg.sketch.topk_chunk_candidates,
                exact_counts=cfg.exact_counts,
                salt=n_chunks,
                match_impl=cfg.match_impl,
                topk_sample_shift=cfg.sketch.topk_sample_shift,
            )
            pending.append(out)
            if len(pending) > 2:
                drain(pending.popleft())
            n_chunks += 1
        lines_consumed += n_raw
        meter.tick(n_raw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = meter.elapsed()
    while pending:
        drain(pending.popleft())

    sustained = elapsed - compile_sec
    totals = {
        "lines_total": lines_consumed,
        "lines_matched": packer.parsed,
        "lines_skipped": packer.skipped,
        "chunks": n_chunks,
        "elapsed_sec": round(elapsed, 4),
        "lines_per_sec": round(lines_consumed / elapsed, 1) if elapsed > 0 else 0.0,
        "compile_sec": round(compile_sec, 4),
        "sustained_lines_per_sec": (
            round(lines_consumed / sustained, 1) if sustained > 0 else 0.0
        ),
        "throughput": meter.summary(),
    }
    return pipeline.finalize(
        state, packed, cfg, tracker, topk=topk, totals=totals,
        backend=f"torch-{device.type}",
    )
