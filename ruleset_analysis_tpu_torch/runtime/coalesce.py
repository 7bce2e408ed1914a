"""Flow-coalescing policy of the stream loop.

Every batch can compact into (unique row, weight) pairs on the host
before it crosses to the card (``hostside.pack.coalesce_*``).  Every
register update is weight-linear or idempotent, so shrinking the batch
to its distinct rows shrinks the batch-sized scatters, the H2D bytes and
the device rows while the report stays identical.  This module owns the
policy around the compactors:

- **Bucket ladder.**  A coalesced batch of U unique rows pads up to the
  smallest bucket of a fixed geometric ladder (batch, batch/2, ... six
  steps), as in the reference, whose jit compiles one program per
  shape.  The port keeps the ladder because the step's candidate count
  (``min(k, B)``) and sampling stride read the batch width: the same
  widths give the reference's candidates.  Padding columns carry weight
  0 and are masked on the device like any invalid row.
- **auto mode.**  Compaction costs one O(B) host hash pass per batch;
  ``auto`` coalesces the first ``AUTO_SAMPLE_BATCHES`` batches (or
  ``AUTO_SAMPLE_ROWS`` raw rows) and disables itself for the rest of
  the run when the observed ratio raw/unique is below
  ``AUTO_MIN_RATIO``.
- **Accounting.**  Raw-vs-unique row counters feed the report's
  ``totals.coalesce`` block.  Batch boundaries stay raw-line based
  (coalescing happens strictly downstream of the batch iterator).  Each
  compaction is an ``ingest.coalesce`` trace span, behind the
  ``ingest.coalesce.fail`` fault site.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..config import AnalysisConfig
from ..hostside import pack as pack_mod
from . import faults, obs

#: ``auto`` samples this many batches before deciding...
AUTO_SAMPLE_BATCHES = 4
#: ...or this many raw rows, whichever comes first.
AUTO_SAMPLE_ROWS = 1 << 19
#: Minimum sampled compaction ratio (raw rows / unique rows) for
#: ``auto`` to keep coalescing.
AUTO_MIN_RATIO = 1.25
#: Maximum distinct coalesced batch widths.
_LADDER_STEPS = 6


def _ladder(batch_size: int, n_dev: int) -> list[int]:
    """Descending bucket sizes: halve while divisible by the device count."""
    out = [batch_size]
    while (
        len(out) < _LADDER_STEPS
        and out[-1] % 2 == 0
        and out[-1] // 2 >= n_dev
        and (out[-1] // 2) % n_dev == 0
    ):
        out.append(out[-1] // 2)
    return out


class Coalescer:
    """Per-run coalescing state.

    Thread-safe: under pipelined ingest the v4 hooks run on the producer
    thread while the v6 hooks and the report run on the consumer, so the
    counters and the auto decision take a small lock (one uncontended
    acquire per batch).
    """

    def __init__(self, mode: str, batch_size: int, n_dev: int = 1):
        if mode not in ("on", "auto"):
            raise ValueError(f"coalesce mode must be 'on' or 'auto', got {mode!r}")
        self.mode = mode
        self._enabled = True
        self._decided = mode == "on"
        self._lock = threading.Lock()
        self._ladder = _ladder(batch_size, max(n_dev, 1))
        self.batches = 0
        self.raw_rows = 0
        self.unique_rows = 0
        self._t0: float | None = None  # the first compaction's start

    def enabled(self) -> bool:
        return self._enabled

    def _bucket(self, u: int) -> int:
        for size in reversed(self._ladder):  # ascending
            if size >= u:
                return size
        return self._ladder[0]

    def _account(self, raw: int, unique: int, t0: float, t1: float) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = t0
            self.batches += 1
            self.raw_rows += raw
            self.unique_rows += unique
            if not self._decided and (
                self.batches >= AUTO_SAMPLE_BATCHES or self.raw_rows >= AUTO_SAMPLE_ROWS
            ):
                self._decided = True
                if self.raw_rows < AUTO_MIN_RATIO * max(self.unique_rows, 1):
                    # uniform-ish traffic: later batches pass through
                    # exactly as with coalesce off
                    self._enabled = False
        obs.complete("ingest.coalesce", t0, t1, cat="ingest",
                     args={"raw": raw, "unique": unique})

    def _compact(self, mat: np.ndarray, fn, pad: bool) -> np.ndarray:
        # a failing compactor must abort typed, never emit a half-built
        # weighted batch
        faults.fire("ingest.coalesce.fail")
        t0 = time.perf_counter()
        raw = int(mat[-1].sum(dtype=np.uint64))
        out = fn(mat)
        u = out.shape[-1]
        if pad:
            out = pack_mod.pad_weighted(out, self._bucket(u))
        self._account(raw, u, t0, time.perf_counter())
        return out

    def tuple4(self, batch: np.ndarray, pad: bool = True) -> np.ndarray:
        """``[TUPLE_COLS, B]`` -> weighted ``[TUPLE_COLS, bucket]``."""
        return self._compact(batch, pack_mod.coalesce_batch, pad)

    def tuple6(self, batch6: np.ndarray, pad: bool = True) -> np.ndarray:
        """``[TUPLE6_COLS, B]`` -> weighted ``[TUPLE6_COLS, bucket]``."""
        return self._compact(batch6, pack_mod.coalesce_batch6, pad)

    def wire4(self, wire: np.ndarray, pad: bool = True) -> np.ndarray:
        """``[WIRE_COLS(+1), B]`` -> weighted ``[WIREW_COLS, bucket]``."""
        view = pack_mod._wire_weighted_view(wire, pack_mod.WIRE_COLS, pack_mod.W_META)
        return self._compact(view, pack_mod.coalesce_wire, pad)

    def wire6(self, wire6: np.ndarray, pad: bool = True) -> np.ndarray:
        """``[WIRE6_COLS(+1), B]`` -> weighted ``[WIRE6W_COLS, bucket]``."""
        view = pack_mod._wire_weighted_view(wire6, pack_mod.WIRE6_COLS, pack_mod.W6_META)
        return self._compact(view, pack_mod.coalesce_wire6, pad)

    def ratio(self) -> float:
        return self.raw_rows / max(self.unique_rows, 1)

    def summary(self) -> dict:
        """Report-totals block (``totals.coalesce``)."""
        with self._lock:
            return {
                "mode": self.mode,
                "active": self._enabled,
                "batches": self.batches,
                "raw_rows": self.raw_rows,
                "unique_rows": self.unique_rows,
                "compaction_ratio": round(self.ratio(), 4),
            }

    def sample_metrics(self) -> dict:
        """The ``coalesce`` metrics sampler: :meth:`summary` and the raw and
        unique rows a second since the first compaction."""
        out = self.summary()
        elapsed = time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        out["raw_rows_per_sec"] = round(self.raw_rows / elapsed, 1) if elapsed > 0 else 0.0
        out["unique_rows_per_sec"] = (
            round(self.unique_rows / elapsed, 1) if elapsed > 0 else 0.0)
        return out


def make_coalescer(cfg: AnalysisConfig, batch_size: int, n_dev: int = 1) -> Coalescer | None:
    """One Coalescer per run, or None when ``cfg.coalesce`` is off."""
    if cfg.coalesce == "off":
        return None
    return Coalescer(cfg.coalesce, batch_size, n_dev)
