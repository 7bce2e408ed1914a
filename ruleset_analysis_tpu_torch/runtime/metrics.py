"""Meters of one run: throughput, latency, recovery, profiling, SLOs.

The port's copy of the reference's ``runtime/metrics.py``:

- :class:`ThroughputMeter`: the periodic stderr line and the report's
  ``totals.throughput``; every tick also feeds the metrics plane's line
  counter and each printed line lands in the metrics JSONL as a
  ``throughput`` event (``runtime/obs.py``; one None-check when
  ``--metrics-out`` is unset).
- :class:`LatencyHistogram`: log2 buckets that merge by addition
  (``totals.latency.batch_e2e``, the ``ingest`` sampler's gauges), with
  a Prometheus rendering that :func:`quantile_from_prom` reads back to
  the same quantiles.
- :class:`RecoveryMeter`: detect -> recovered events of an elastic run.
- :class:`Profiler`: a whole-run ``torch.profiler`` trace (``run
  --profile-dir``), CUDA activity included on a CUDA run.
- :class:`SloPolicy`, :class:`SloBurnEngine`, :func:`window_slo_stats`:
  burn-rate objectives over published windows; :func:`build_info` and
  :func:`render_build_info_prom`: the ``ra_build_info`` gauge.

The reference's ``DispatchTimer`` is not here: the port's one
``step.dispatch`` span is in ``stream._Chunks._run``, and
``totals.compile_sec`` means the seconds spent building and loading the
CUDA kernels (nvcc), not a jit's first-dispatch excess.

Imports run one way, as in the reference: this module imports ``obs``,
and ``obs`` never imports it.
"""

from __future__ import annotations

import math
import os
import sys
import threading
import time

from . import obs

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

    def merge(self, other: "LatencyHistogram") -> None:
        """Positional count addition: the histogram merge law."""
        with other._lock:
            counts = list(other.counts)
            s, c = other.sum_sec, other.count
        with self._lock:
            for i, v in enumerate(counts):
                self.counts[i] += v
            self.sum_sec += s
            self.count += c

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

    def quantile(self, p: float) -> float:
        with self._lock:
            return self._quantile_locked(p)

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

    def gauges(self, prefix: str) -> dict:
        """Flat numeric gauges: :meth:`summary` with ``prefix`` on each key."""
        return {f"{prefix}{k}": v for k, v in self.summary().items()}

    def render_prom(self, name: str, labels: dict | None = None) -> str:
        """Prometheus histogram exposition (text format 0.0.4).

        Cumulative ``le`` buckets ending at ``+Inf``, then ``_sum`` and
        ``_count``, from the same counts as :meth:`summary`, so a
        scraper's bucket-derived quantile equals the JSON gauge.
        ``labels`` precede ``le`` on every bucket and brace ``_sum`` and
        ``_count``.
        """
        with self._lock:
            counts = list(self.counts)
            total = self.count
            sum_sec = self.sum_sec
        lab = _prom_labels(labels)
        pre = f"{lab}," if lab else ""
        suf = f"{{{lab}}}" if lab else ""
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for i, bound in enumerate(LATENCY_BUCKET_BOUNDS):
            cum += counts[i]
            # repr round-trips: a scraper re-parsing le gets the same float
            lines.append(f'{name}_bucket{{{pre}le="{bound!r}"}} {cum}')
        lines.append(f'{name}_bucket{{{pre}le="+Inf"}} {total}')
        lines.append(f"{name}_sum{suf} {sum_sec:.9g}")
        lines.append(f"{name}_count{suf} {total}")
        return "\n".join(lines) + "\n"


def _prom_labels(labels: dict | None) -> str:
    """``k="v"`` label pairs without braces, sorted by key."""
    if not labels:
        return ""
    return ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))


def quantile_from_prom(text: str, name: str, p: float,
                       labels: dict | None = None) -> float | None:
    """The p-quantile of a Prometheus histogram exposition.

    The conservative bucket-upper-bound rule of
    :meth:`LatencyHistogram.quantile`, so both renderings of one
    histogram agree; ``labels`` picks one labelled series (those given to
    ``render_prom``).  None when the text holds no such histogram.
    """
    lab = _prom_labels(labels)
    bucket_pre = f'{name}_bucket{{{lab},le="' if lab else f'{name}_bucket{{le="'
    count_pre = f"{name}_count{{{lab}}} " if lab else f"{name}_count "
    buckets: list[tuple[float, int]] = []
    count = None
    for line in text.splitlines():
        if line.startswith(bucket_pre):
            le, _, cum = line[len(bucket_pre):].partition('"} ')
            buckets.append((math.inf if le == "+Inf" else float(le), int(cum)))
        elif line.startswith(count_pre):
            count = int(line.rsplit(" ", 1)[1])
    if count is None or not buckets:
        return None
    if count == 0:
        return 0.0
    rank = max(1, math.ceil(p * count))
    finite = [b for b, _ in buckets if b != math.inf]
    for bound, cum in buckets:
        if cum >= rank:
            return min(bound, finite[-1]) if finite else bound
    return finite[-1] if finite else None


class ThroughputMeter:
    """Lines/sec of one run, without per-chunk device syncs.

    With ``report_every_chunks`` N > 0, every Nth tick prints the
    reference's line (instantaneous and cumulative lines/s) to ``out``
    (default: the current ``sys.stderr``) and pushes the same numbers as a ``throughput`` metrics event.  Every
    tick feeds the metrics plane's cumulative line counter.
    """

    def __init__(self, report_every_chunks: int = 0, out=None):
        self.every = report_every_chunks
        self.out = out
        self.t0 = time.perf_counter()
        self.t_last = self.t0
        self.lines = 0
        self.lines_last = 0
        self.chunks = 0

    def tick(self, n_lines: int) -> None:
        self.lines += n_lines
        self.chunks += 1
        obs.add_lines(n_lines)
        if self.every and self.chunks % self.every == 0:
            now = time.perf_counter()
            inst = (self.lines - self.lines_last) / max(now - self.t_last, 1e-9)
            cum = self.lines / max(now - self.t0, 1e-9)
            print(
                f"[chunk {self.chunks}] {self.lines} lines, "
                f"{inst:,.0f} lines/s (inst), {cum:,.0f} lines/s (cum)",
                file=self.out or sys.stderr,
                flush=True,
            )
            obs.metric_event("throughput", chunk=self.chunks, lines=self.lines,
                             lines_per_sec_inst=round(inst, 1),
                             lines_per_sec_cum=round(cum, 1))
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


class RecoveryMeter:
    """Recovery events of an elastic run: detect -> recovered.

    ``detect()`` marks the moment a peer death (or any generation failure)
    is seen, ``recovered()`` the moment the next generation's workers run
    again; each pair is one event (a trace span and a ``recovery``
    metrics event).  ``summary()`` patches the report totals.
    """

    def __init__(self):
        self.events: list[dict] = []
        self._t_detect: float | None = None
        #: the open event's reason; defined up front, so a recovered() with
        #: no detect() before it reads "" rather than a missing attribute
        self._reason: str = ""
        #: chaos-harness outcomes (record_run): one bool a seeded schedule,
        #: True when the run ended inside the invariant
        self.runs: list[bool] = []

    @property
    def detecting(self) -> bool:
        """True while a detected failure waits for its recovered(): a
        planned re-formation has no detection window and records nothing."""
        return self._t_detect is not None

    def detect(self, reason: str = "") -> None:
        if self._t_detect is None:  # the first detection of an event wins
            self._t_detect = time.perf_counter()
            self._reason = reason
            obs.instant("elastic.detect", args={"reason": reason})

    def recovered(self, *, world: int) -> None:
        t = time.perf_counter()
        t0 = self._t_detect if self._t_detect is not None else t
        event = {
            "time_to_recover_sec": round(t - t0, 3),
            "world": world,
            "reason": self._reason if self._t_detect is not None else "",
        }
        self.events.append(event)
        # the detect..recovered window is the re-formation span, on both planes
        obs.complete("elastic.reform", t0, t, cat="elastic", args=event)
        obs.metric_event("recovery", **event)
        self._t_detect = None

    def abandon(self) -> None:
        """Forget an open detection (budget exhausted: no recovery happened)."""
        self._t_detect = None

    def record_run(self, ok: bool) -> None:
        """One chaos schedule's verdict."""
        self.runs.append(bool(ok))

    def summary(self) -> dict:
        """Totals patch: {} when nothing was recorded."""
        out: dict = {}
        if self.events:
            total = sum(e["time_to_recover_sec"] for e in self.events)
            out.update({
                "recovery_events": len(self.events),
                "recovery_total_sec": round(total, 3),
                "mean_time_to_recover_sec": round(total / len(self.events), 3),
                "recoveries": self.events,
            })
        if self.runs:
            out.update({
                "chaos_runs": len(self.runs),
                "chaos_pass_rate": round(sum(self.runs) / len(self.runs), 4),
            })
        return out


class Profiler:
    """A whole-run ``torch.profiler`` trace (a no-op when ``trace_dir`` is None).

    CPU activity always; CUDA activity (CUPTI: every kernel the run
    launches, the hand-written ones under their ``__global__`` names) when
    ``device`` is ``"cuda"``.  A CUDA run whose torch cannot record CUDA
    activity raises :class:`~..errors.AnalysisError` rather than write a
    CPU-only trace.  Entering twice is an AnalysisError; the trace always
    stops when the body raises, and a failure to stop or export it then
    never masks the body's error (on a clean exit it propagates).  The
    trace is a Chrome trace, ``<trace_dir>/profile-<pid>.pt.trace.json``;
    a clean exit prints its path and how to open it to ``out`` (default:
    the current ``sys.stderr``).
    """

    def __init__(self, trace_dir: str | None, out=None, device: str = "cpu"):
        self.trace_dir = trace_dir
        self.out = out
        self.device = device
        self.path: str | None = None
        self._prof = None
        self._active = False

    def __enter__(self):
        if self._active:
            from ..errors import AnalysisError

            raise AnalysisError("Profiler already started; nest runs, not profiler scopes")
        if self.trace_dir:
            from torch import profiler as tprof

            acts = [tprof.ProfilerActivity.CPU]
            if self.device == "cuda":
                if tprof.ProfilerActivity.CUDA not in tprof.supported_activities():
                    from ..errors import AnalysisError

                    raise AnalysisError(
                        "--profile-dir: this torch cannot record CUDA activity (no CUPTI), "
                        "and a CPU-only trace of a CUDA run would show no kernel; drop "
                        "--profile-dir or run with --device cpu"
                    )
                acts.append(tprof.ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof = tprof.profile(activities=acts)
            prof.start()
            self._prof = prof
            self._active = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._active:
            return False
        self._active = False
        prof, self._prof = self._prof, None
        path = os.path.join(self.trace_dir, f"profile-{os.getpid()}.pt.trace.json")
        try:
            prof.stop()
            prof.export_chrome_trace(path)
        except Exception:
            # unwinding with the body's exception: the profiler's own
            # failure must not mask it; on a clean exit it is real
            if exc_type is None:
                raise
        else:
            self.path = path
            if exc_type is None:
                print(f"profiler trace: {path} (open in Perfetto or chrome://tracing)",
                      file=self.out or sys.stderr, flush=True)
        return False


# ---------------------------------------------------------------------------
# SLO burn-rate engine.  Objectives are evaluated per published window
# against the same log2 latency histograms and drop / incomplete /
# degraded counters the serve loops keep.  Fast/slow window pairs: the
# fast one catches a sharp regression within a few rotations, the slow
# one confirms sustained burn; breach and recover fire only on state
# transitions, so a steady service emits nothing.
# ---------------------------------------------------------------------------

#: Window-stat keys an ``--slo`` objective may bound: publish-latency
#: quantiles in milliseconds, per-window rates in [0, 1], and the size of
#: the degraded set at rotation.
SLO_METRICS: tuple[str, ...] = (
    "p50_publish_ms",
    "p90_publish_ms",
    "p99_publish_ms",
    "drop_rate",
    "incomplete_rate",
    "degraded_subsystems",
)

_SLO_OBJ_RE = None  # compiled lazily; objective grammar: metric<=number


class SloPolicy:
    """A parsed ``--slo`` policy: a list of ``(metric, bound)`` objectives.

    Grammar, one comma-separated spec, whitespace-tolerant::

        p99_publish_ms<=500,drop_rate<=0.001

    Only ``<=``: every supported metric is smaller-is-better.  An unknown
    or repeated metric, a malformed objective or an empty spec is a
    :class:`ValueError` at parse time.
    """

    def __init__(self, objectives: list[tuple[str, float]]):
        self.objectives = list(objectives)

    @classmethod
    def parse(cls, spec: str) -> "SloPolicy":
        import re

        global _SLO_OBJ_RE
        if _SLO_OBJ_RE is None:
            _SLO_OBJ_RE = re.compile(
                r"^\s*([a-z0-9_]+)\s*<=\s*([0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*$"
            )
        objectives: list[tuple[str, float]] = []
        seen: set[str] = set()
        for part in str(spec).split(","):
            if not part.strip():
                continue
            m = _SLO_OBJ_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad --slo objective {part.strip()!r} "
                    "(want metric<=number, e.g. p99_publish_ms<=500)"
                )
            metric, bound = m.group(1), float(m.group(2))
            if metric not in SLO_METRICS:
                raise ValueError(
                    f"unknown --slo metric {metric!r} (supported: {', '.join(SLO_METRICS)})"
                )
            if metric in seen:
                raise ValueError(f"duplicate --slo metric {metric!r}")
            seen.add(metric)
            objectives.append((metric, bound))
        if not objectives:
            raise ValueError("empty --slo spec")
        return cls(objectives)


class SloBurnEngine:
    """Multi-window burn-rate evaluator over per-window SLO stats.

    Each objective keeps the compliance bits of its last ``slow``
    rotations.  Burn rate = violating fraction / error budget.  An
    objective breaches when the fast burn (last ``fast`` rotations)
    reaches ``fast_burn`` and the slow burn reaches 1.0, and recovers once
    the fast burn falls below 1.0: ``fast`` clean rotations in a row, so
    the state cannot flap a window at a time.  ``observe`` returns the
    transition events only.
    """

    def __init__(self, policy: SloPolicy, *, fast: int = 3, slow: int = 12,
                 budget: float = 0.01, fast_burn: float = 2.0):
        if fast < 1 or slow < fast:
            raise ValueError("want 1 <= fast <= slow")
        self.policy = policy
        self.fast = int(fast)
        self.slow = int(slow)
        self.budget = float(budget)
        self.fast_burn = float(fast_burn)
        # per objective: compliance bits (1 = violated), breached flag, burns
        self._bits: dict[str, list[int]] = {m: [] for m, _ in policy.objectives}
        self._breached: dict[str, bool] = {m: False for m, _ in policy.objectives}
        self._burn: dict[str, tuple[float, float]] = {
            m: (0.0, 0.0) for m, _ in policy.objectives
        }
        self.windows_observed = 0
        self.breaches_total = 0
        self.recoveries_total = 0

    def _burn_of(self, bits: list[int], horizon: int) -> float:
        tail = bits[-horizon:]
        if not tail:
            return 0.0
        return (sum(tail) / len(tail)) / self.budget

    def observe(self, stats: dict) -> list[dict]:
        """Feed one published window's stats; return its transition events.

        A missing stat counts as compliant (a window with no latency
        samples cannot violate a latency objective).  An event carries the
        objective, its bound, the observed value and both burn rates.
        """
        self.windows_observed += 1
        events: list[dict] = []
        for metric, bound in self.policy.objectives:
            val = stats.get(metric)
            violated = 1 if (val is not None and float(val) > bound) else 0
            bits = self._bits[metric]
            bits.append(violated)
            del bits[:-self.slow]
            bf = self._burn_of(bits, self.fast)
            bs = self._burn_of(bits, self.slow)
            self._burn[metric] = (bf, bs)
            was = self._breached[metric]
            ev = None
            if not was and bf >= self.fast_burn and bs >= 1.0:
                self._breached[metric] = True
                self.breaches_total += 1
                ev = "slo.breach"
            elif was and bf < 1.0:
                self._breached[metric] = False
                self.recoveries_total += 1
                ev = "slo.recovered"
            if ev is not None:
                events.append({
                    "event": ev,
                    "objective": metric,
                    "bound": bound,
                    "value": None if val is None else float(val),
                    "burn_fast": round(bf, 4),
                    "burn_slow": round(bs, 4),
                    "window": stats.get("window"),
                })
        return events

    def gauges(self) -> dict:
        """Flat numeric gauges."""
        return {
            "slo_objectives": len(self.policy.objectives),
            "slo_windows_observed": self.windows_observed,
            "slo_breached": sum(1 for b in self._breached.values() if b),
            "slo_breaches_total": self.breaches_total,
            "slo_recoveries_total": self.recoveries_total,
        }

    def labeled_gauges(self) -> dict[str, dict]:
        """Per-objective gauges for a labelled Prometheus exposition."""
        out: dict[str, dict] = {}
        for metric, bound in self.policy.objectives:
            bf, bs = self._burn[metric]
            out[metric] = {
                "slo_bound": float(bound),
                "slo_burn_fast": round(bf, 4),
                "slo_burn_slow": round(bs, 4),
                "slo_objective_breached": 1 if self._breached[metric] else 0,
            }
        return out


def window_slo_stats(hist: "LatencyHistogram | None", *, lines: int, drops: int,
                     incomplete: bool, degraded: int, window: int | None = None) -> dict:
    """One published window's stats, in the shape ``SloBurnEngine.observe``
    reads.  The drop rate is drops over (delivered lines + drops): the
    share of offered lines the window lost."""
    stats: dict = {
        "drop_rate": (drops / (lines + drops)) if (lines + drops) > 0 else 0.0,
        "incomplete_rate": 1.0 if incomplete else 0.0,
        "degraded_subsystems": int(degraded),
        "window": window,
    }
    if hist is not None and hist.count > 0:
        for p, key in ((0.5, "p50_publish_ms"), (0.9, "p90_publish_ms"),
                       (0.99, "p99_publish_ms")):
            q = hist.quantile(p)
            if q == q and q != float("inf"):  # not NaN, not the overflow bucket
                stats[key] = q * 1e3
    return stats


# ---------------------------------------------------------------------------
# Build-info gauge (ra_build_info): what binary produced these numbers.
# Labels constant over the process (version, torch version, SIMD kind of
# the native parser, and any extras) with a value of 1.
# ---------------------------------------------------------------------------


def build_info(extra: dict | None = None) -> dict:
    """The build-info label dict, every value a str: the port's version,
    ``torch`` (in place of the reference's ``jax``) and ``simd``, the
    dispatch of the port's own native parser ("scalar" where it does not
    load)."""
    from .. import __version__

    try:
        import torch

        torch_version = str(torch.__version__)
    except Exception:
        torch_version = "unknown"
    try:
        from ..hostside import fastparse

        simd = str(fastparse.simd_kind()) if fastparse.available() else "scalar"
    except Exception:
        simd = "unknown"
    info = {"version": str(__version__), "torch": torch_version, "simd": simd}
    for k, v in (extra or {}).items():
        info[str(k)] = str(v)
    return info


def render_build_info_prom(info: dict, *, name: str = "ra_build_info") -> str:
    """One ``ra_build_info{...} 1`` line from :func:`build_info`'s dict."""
    body = _prom_labels({k: str(info[k]) for k in info})
    return f"# TYPE {name} gauge\n{name}{{{body}}} 1\n"
