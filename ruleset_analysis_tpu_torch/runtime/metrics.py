"""Meters of one run: throughput and batch latency.

The part of the reference's ``runtime/metrics.py`` that the stream loop
and the pipelined ingest use: :class:`ThroughputMeter` (its periodic
stderr line and its report summary, ``totals.throughput``) and the
log2-bucket :class:`LatencyHistogram` (``totals.latency.batch_e2e``,
produce -> commit time of each batch).
"""

from __future__ import annotations

import math
import sys
import threading
import time

#: Upper bucket bounds in seconds: 1 us * 2^i for i in 0..33 (~2.4 h),
#: plus an implicit +Inf overflow bucket.  Fixed for every histogram so
#: counts merge positionally.
LATENCY_BUCKET_BOUNDS: tuple[float, ...] = tuple((1 << i) * 1e-6 for i in range(34))


class LatencyHistogram:
    """Log2-bucket latency histogram with integer counts.

    ``record`` is O(1); quantiles are conservative — they report the
    UPPER bound of the bucket holding the target rank, so a published
    p99 is never below the true p99.  Samples past the last finite bound
    count in the overflow bucket and clamp quantiles to that bound.
    """

    N = len(LATENCY_BUCKET_BOUNDS)

    def __init__(self):
        self.counts: list[int] = [0] * (self.N + 1)  # +1 = +Inf overflow
        self.sum_sec = 0.0
        self.count = 0
        self._lock = threading.Lock()

    @staticmethod
    def bucket_index(sec: float) -> int:
        """Smallest i with bounds[i] >= sec (N = the +Inf overflow)."""
        if sec <= 1e-6:
            return 0
        us = int(math.ceil(sec * 1e6))
        return min((us - 1).bit_length(), LatencyHistogram.N)

    def record(self, sec: float, n: int = 1) -> None:
        """Add ``n`` samples of ``sec``."""
        sec = max(sec, 0.0)
        i = self.bucket_index(sec)
        with self._lock:
            self.counts[i] += n
            self.sum_sec += sec * n
            self.count += n

    def _quantile_locked(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(p * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return LATENCY_BUCKET_BOUNDS[min(i, self.N - 1)]
        return LATENCY_BUCKET_BOUNDS[-1]

    def summary(self) -> dict:
        """Report image: counts and the p50/p90/p99 bucket bounds."""
        with self._lock:
            return {
                "count": self.count,
                "sum_sec": round(self.sum_sec, 6),
                "p50_sec": self._quantile_locked(0.50),
                "p90_sec": self._quantile_locked(0.90),
                "p99_sec": self._quantile_locked(0.99),
            }


class ThroughputMeter:
    """Lines/sec of one run, without per-chunk device syncs.

    With ``report_every_chunks`` N > 0, every Nth tick prints the
    reference's line (instantaneous and cumulative lines/s) to stderr.
    """

    def __init__(self, report_every_chunks: int = 0):
        self.every = report_every_chunks
        self.t0 = time.perf_counter()
        self.t_last = self.t0
        self.lines = 0
        self.lines_last = 0
        self.chunks = 0

    def tick(self, n_lines: int) -> None:
        self.lines += n_lines
        self.chunks += 1
        if self.every and self.chunks % self.every == 0:
            now = time.perf_counter()
            inst = (self.lines - self.lines_last) / max(now - self.t_last, 1e-9)
            cum = self.lines / max(now - self.t0, 1e-9)
            print(
                f"[chunk {self.chunks}] {self.lines} lines, "
                f"{inst:,.0f} lines/s (inst), {cum:,.0f} lines/s (cum)",
                file=sys.stderr,
                flush=True,
            )
            self.t_last, self.lines_last = now, self.lines

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
