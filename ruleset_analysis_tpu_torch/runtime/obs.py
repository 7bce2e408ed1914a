"""Tracing and metrics plane: where the run's time goes, and its gauges.

The port's copy of the reference's ``runtime/obs.py``.  One arming
discipline, the ``faults.py`` one: the disarmed cost of every call site
is a module-global ``None`` check.

- **Spans and instants.**  :func:`complete` / :func:`span` /
  :func:`timed` / :func:`instant` record Chrome trace events (they load
  in Perfetto or ``chrome://tracing``).  Each process appends to its own
  ``trace-<pid>.jsonl`` shard in the trace directory, one complete event
  a line, flushed as written, so a worker that dies mid-run leaves a
  well-formed shard of everything it finished.  A span times host work
  only: no call site synchronises the device, so a span around a kernel
  launch is its dispatch, as under XLA's asynchronous dispatch in the
  reference.

- **Cross-process capture.**  :func:`start_trace` exports the directory
  to :data:`ENV_VAR`; spawned children (feed workers, convert workers)
  inherit it and arm lazily on their first event.  The owner merges every
  shard into one timeline (:func:`merge_trace`) at :func:`shutdown`,
  after a typed abort too; timestamps are epoch microseconds, so shards
  of different processes share one axis.

- **Metrics snapshotter.**  :func:`start_metrics` appends JSON-lines
  records to a file every N seconds from a daemon ``ra-metrics`` thread:
  wall clock, cumulative and instantaneous lines/s (fed by
  ``ThroughputMeter.tick`` through :func:`add_lines`), RSS, and one key
  per registered sampler (:func:`register_sampler`: the prefetch queue,
  the feeder pool or rings, the coalescer, the retry counters, the
  card's memory); components push event records (:func:`metric_event`:
  checkpoint bytes and seconds, throughput lines).  :func:`shutdown`
  writes a ``final`` snapshot.  The sampler registry lives apart from
  the plane's arming, so a flight-recorder dump reads the same gauges.

- **Flight-recorder tap.**  When the always-on flight recorder
  (runtime/flightrec.py) is armed, every span, instant and metrics
  record also lands in its in-memory ring, with no file I/O.

The CLI arms from ``run --trace-out`` / ``--metrics-out`` and calls
:func:`shutdown` in a ``finally``.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import threading
import time

#: Environment variable carrying the trace directory to child processes
#: (feed and convert workers) — the RA_FAULT_PLAN inheritance discipline.
ENV_VAR = "RA_TRACE_DIR"

#: Default cadence of the metrics snapshotter (seconds).
DEFAULT_METRICS_EVERY = 10.0

#: Waits shorter than this never become backpressure/starved spans —
#: a healthy pipeline's sub-millisecond queue handoffs are not stalls.
STALL_SPAN_MIN_SEC = 0.001

#: Backstop age for pruning leftover shards whose writer PID appears
#: alive (PID recycled by an unrelated long-lived process): older than
#: this, the shard is a previous run's regardless.  Deliberately far
#: above any realistic launcher stagger — wrongly unlinking a live
#: sibling's shard loses its telemetry for the whole run, while keeping
#: a recycled-PID leftover only cosmetically pads one merge.
STALE_SHARD_SEC = 3600.0


class Tracer:
    """One process's span shard: ``trace-<pid>.jsonl`` in the trace dir.

    Events are Chrome trace-event objects, one JSON per line, flushed as
    written — append-only and crash-tolerant by construction (a process
    killed mid-write loses at most its final partial line, which
    :func:`merge_trace` skips).  Timestamps are epoch microseconds
    (derived from one ``time.time``/``perf_counter`` pairing at arm
    time) so shards from different processes merge onto one axis.
    """

    def __init__(self, trace_dir: str, role: str = ""):
        os.makedirs(trace_dir, exist_ok=True)
        self.dir = os.path.abspath(trace_dir)
        self.pid = os.getpid()
        self.path = os.path.join(self.dir, f"trace-{self.pid}.jsonl")
        self._f = open(self.path, "a", encoding="utf-8")
        self._wlock = threading.Lock()
        # one pairing converts perf_counter spans to the shared epoch axis
        self._epoch_us = time.time_ns() // 1_000
        self._pc0 = time.perf_counter()
        self.set_role(role or f"pid-{self.pid}")

    def _us(self, pc: float) -> int:
        return self._epoch_us + int((pc - self._pc0) * 1e6)

    def _emit(self, ev: dict) -> None:
        line = json.dumps(ev, separators=(",", ":"))
        with self._wlock:
            f = self._f
            if f.closed:
                return
            f.write(line + "\n")
            f.flush()

    def set_role(self, role: str) -> None:
        """Name this process's track in the merged timeline."""
        self._emit(
            {
                "ph": "M",
                "name": "process_name",
                "pid": self.pid,
                "tid": 0,
                "args": {"name": f"{role} (pid {self.pid})"},
            }
        )

    def complete(
        self,
        name: str,
        t0_pc: float,
        t1_pc: float,
        cat: str = "",
        args: dict | None = None,
    ) -> None:
        """One finished span, endpoints in ``time.perf_counter`` units."""
        ev = {
            "ph": "X",
            "name": name,
            "cat": cat or name.split(".", 1)[0],
            "pid": self.pid,
            "tid": threading.get_native_id(),
            "ts": self._us(t0_pc),
            "dur": max(0, int((t1_pc - t0_pc) * 1e6)),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, args: dict | None = None) -> None:
        ev = {
            "ph": "i",
            "s": "p",  # process-scoped marker line
            "name": name,
            "cat": name.split(".", 1)[0],
            "pid": self.pid,
            "tid": threading.get_native_id(),
            "ts": self._us(time.perf_counter()),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def close(self) -> None:
        with self._wlock:
            if not self._f.closed:
                self._f.close()


class MetricsPlane:
    """Periodic JSONL snapshots and pushed events, appended to one file.

    Snapshot records (``kind="snapshot"``, ``"final"`` at :meth:`close`)
    carry the built-in gauges (lines, rates, RSS, uptime) and one key a
    registered sampler; event records (``kind=<event kind>``) land when a
    component pushes one.  The sampling thread is a daemon named
    ``ra-metrics``, joined by :meth:`close`.  A sampler that raises is
    left out of that snapshot; a failing tick (an unwritable file, the
    ``metrics.snapshot.fail`` fault site) is counted and the thread
    lives: observability never takes down the run it observes.
    """

    def __init__(self, path: str, every_sec: float = DEFAULT_METRICS_EVERY):
        self.path = os.path.abspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self.every = max(0.05, float(every_sec))
        self._lock = threading.Lock()
        self._lines = 0
        # intervals and rates run on the monotonic clock (a clock step must
        # never give a negative rate); "t" stays wall clock for correlation
        self._t0 = time.monotonic()
        self._last_t = self._t0
        self._last_lines = 0
        self._stop = threading.Event()
        self.errors = 0
        self.consec_errors = 0
        self.last_error = ""
        self._thread = threading.Thread(target=self._loop, name="ra-metrics", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        from . import faults

        while not self._stop.wait(self.every):
            try:
                faults.fire("metrics.snapshot.fail")
                self.snapshot()
            except Exception as e:
                with self._lock:
                    self.errors += 1
                    self.consec_errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"[:200]
            else:
                with self._lock:
                    self.consec_errors = 0

    def health(self) -> dict:
        with self._lock:
            return {
                "alive": self._thread.is_alive(),
                "errors": self.errors,
                "consec_errors": self.consec_errors,
                "last_error": self.last_error,
            }

    def add_lines(self, n: int) -> None:
        with self._lock:
            self._lines += n

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            f = self._f
            if f.closed:
                return
            f.write(line + "\n")
            f.flush()
        # the flight recorder keeps the latest records in its ring, so a
        # crash dump carries the last gauge readings
        fr = _flight
        if fr is not None:
            fr.instant(f"metrics.{rec.get('kind', 'snapshot')}", rec)

    def event(self, kind: str, fields: dict) -> None:
        self._write({"kind": kind, "t": round(time.time(), 3), **fields})

    def snapshot(self, kind: str = "snapshot") -> dict:
        now = time.monotonic()
        with self._lock:
            lines = self._lines
            dt_inst = now - self._last_t
            d_lines = lines - self._last_lines
            self._last_t, self._last_lines = now, lines
        with _samplers_lock:
            samplers = list(_samplers.items())
        rec = {
            "kind": kind,
            "t": round(time.time(), 3),
            "uptime_sec": round(now - self._t0, 3),
            "lines": lines,
            "lines_per_sec_inst": round(d_lines / dt_inst, 1) if dt_inst > 0 else 0.0,
            "lines_per_sec_cum": round(lines / (now - self._t0), 1) if now > self._t0 else 0.0,
            "rss_bytes": _rss_bytes(),
        }
        for name, fn in samplers:
            try:
                rec[name] = fn()
            except Exception:
                pass  # a broken sampler must never take the run down
        self._write(rec)
        return rec

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        self.snapshot(kind="final")
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _rss_bytes() -> int:
    """Resident set size: /proc on Linux, else the getrusage peak."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # only where /proc is absent: macOS reports bytes, others KiB
            return int(peak) if sys.platform == "darwin" else int(peak) * 1024
        except Exception:
            return 0


# ---------------------------------------------------------------------------
# Module arming state — the faults.py discipline: `_tracer is None` and
# `_metrics is None` are the production fast paths; the env check runs at
# most once per process so spawned children (which inherit RA_TRACE_DIR)
# arm themselves lazily on their first span.
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_tracer: Tracer | None = None
_metrics: MetricsPlane | None = None
_env_checked = False
_env_exported = False
_role = ""

#: Flight-recorder tap (runtime/flightrec.py): when the always-on black
#: box is armed, every span/instant also lands in its in-memory ring —
#: NO file I/O, strictly cheaper than the armed trace plane.  Disarmed
#: cost: one module-global None check per event.
_flight = None

#: The sampler registry: name -> ``fn() -> dict``.  Apart from the metrics
#: plane's arming, so components register once and both the JSONL
#: snapshots and a flight-recorder dump read the live gauges, and a
#: sampler registered before ``--metrics-out`` arms still lands in the
#: first snapshot.  Components unregister at teardown.
_samplers: dict[str, object] = {}
_samplers_lock = threading.Lock()


def _set_flight(rec) -> None:
    """Install (or clear) the flight-recorder ring tap (flightrec.arm)."""
    global _flight
    _flight = rec


def sampler_snapshot() -> dict:
    """One guarded reading of every live sampler (flight-recorder dumps):
    a sampler that raises reads as its error string."""
    with _samplers_lock:
        items = list(_samplers.items())
    out: dict = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:  # a broken gauge must not block forensics
            out[name] = f"<sampler error: {type(e).__name__}: {e}>"
    return out


def start_trace(trace_dir: str, *, role: str = "main", export_env: bool = True) -> Tracer:
    """Arm span tracing process-wide, writing this process's shard.

    ``export_env`` publishes the directory to :data:`ENV_VAR` so worker
    processes spawned while armed write sibling shards.
    """
    global _tracer, _env_checked, _env_exported
    with _lock:
        if _tracer is not None:
            _tracer.close()
        if export_env:
            # this process OWNS the run: prune leftovers of previous
            # runs (stale shards + the old merged file) so the merge
            # covers exactly this run.  Lazy-armed children and
            # explicit export_env=False callers never prune — they may
            # be joining a directory other live processes are writing.
            _prune_stale(trace_dir)
        _tracer = Tracer(trace_dir, role=role)
        _env_checked = True
        if export_env:
            os.environ[ENV_VAR] = _tracer.dir
            _env_exported = True
        return _tracer


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists but not ours — treat as alive
    return True


def _prune_stale(trace_dir: str) -> None:
    """Remove leftovers of PREVIOUS runs so the merge covers this one.

    A shard belongs to a previous run exactly when its writer process is
    gone — shard names carry the writer PID, so a liveness probe tells a
    dead run's leftovers (pruned, even seconds after an abort-and-retry)
    from a live sibling rank's shard in a shared multi-launcher
    directory (kept: unlinking it would strand the sibling's events on
    an unlinked inode).  The mtime backstop catches the rare recycled
    PID that probes alive.
    """
    now = time.time()
    me = os.getpid()
    for path in glob.glob(os.path.join(trace_dir, "trace-*.jsonl")):
        name = os.path.basename(path)
        try:
            pid = int(name[len("trace-"):-len(".jsonl")])
        except ValueError:
            continue
        try:
            # our own prior shard is always a previous run's (the old
            # tracer is closed before pruning); others prune when dead
            if pid == me or not _pid_alive(pid) or (
                now - os.path.getmtime(path) > STALE_SHARD_SEC
            ):
                os.unlink(path)
        except OSError:
            continue
    try:
        os.unlink(os.path.join(trace_dir, "trace.json"))
    except OSError:
        pass


def start_metrics(path: str, every_sec: float = DEFAULT_METRICS_EVERY) -> MetricsPlane:
    """Arm the metrics snapshotter (this process only; no env export).
    An unwritable path raises OSError."""
    global _metrics
    with _lock:
        if _metrics is not None:
            _metrics.close()
        _metrics = MetricsPlane(path, every_sec)
        return _metrics


def shutdown(*, merge: bool = True) -> str | None:
    """Disarm everything: stop the metrics plane (its ``final`` snapshot),
    and merge the trace shards when this process owns them.

    Returns the merged trace path (or None when tracing was not armed).
    Safe to call twice and from a ``finally`` after a typed abort — that
    is exactly when a trace is most valuable.
    """
    global _tracer, _metrics, _env_checked, _env_exported
    with _lock:
        tr, mp = _tracer, _metrics
        _tracer, _metrics = None, None
        exported = _env_exported
        _env_exported = False
        _env_checked = True
    if mp is not None:
        mp.close()
    merged = None
    if tr is not None:
        tr.close()
        if exported:
            os.environ.pop(ENV_VAR, None)
        if merge:
            merged = merge_trace(tr.dir)
    return merged


def _reset_for_tests() -> None:
    """Forget all arming state, the once-per-process env check and the
    sampler registry included."""
    global _env_checked
    shutdown(merge=False)
    with _lock:
        _env_checked = False
    with _samplers_lock:
        _samplers.clear()


def _check_env() -> Tracer | None:
    """One-time lazy arm from the environment (spawned children)."""
    global _tracer, _env_checked
    with _lock:
        if _env_checked:
            return _tracer
        _env_checked = True
    # the flight recorder inherits RA_BLACKBOX_DIR through the same
    # once-per-process gate (workers call note_role -> active_tracer on
    # entry, so their rings arm before their first telemetry event)
    from . import flightrec

    flightrec.maybe_arm_from_env()
    d = os.environ.get(ENV_VAR, "")
    if d:
        try:
            tr = Tracer(d, role=_role or "worker")
        except OSError:
            return None  # unwritable inherited dir: stay disarmed
        with _lock:
            _tracer = tr
    return _tracer


def active_tracer() -> Tracer | None:
    """The armed tracer, lazily arming from the inherited env once.

    The hot-path accessor: disarmed cost is one None-check plus one
    bool check after the first call.
    """
    tr = _tracer
    if tr is not None:
        return tr
    if _env_checked:
        return None
    return _check_env()


def note_role(role: str) -> None:
    """Label this process's trace track (call at worker entry points)."""
    global _role
    _role = role
    tr = active_tracer()
    if tr is not None:
        tr.set_role(role)
    fr = _flight
    if fr is not None:
        fr.role = role


def recording() -> bool:
    """True when ANY event sink is live (tracer or flight-recorder ring).

    The guard for call sites that measure endpoints themselves (the step
    dispatch span): they must keep timing when the always-on black box is
    the only consumer.
    """
    return active_tracer() is not None or _flight is not None


def complete(
    name: str, t0_pc: float, t1_pc: float, cat: str = "", args: dict | None = None
) -> None:
    """Record a finished span from already-measured perf_counter endpoints."""
    tr = active_tracer()
    if tr is not None:
        tr.complete(name, t0_pc, t1_pc, cat, args)
    fr = _flight
    if fr is not None:
        fr.span(name, t0_pc, t1_pc, args)


def instant(name: str, args: dict | None = None) -> None:
    tr = active_tracer()
    if tr is not None:
        tr.instant(name, args)
    fr = _flight
    if fr is not None:
        fr.instant(name, args)


def timed(name: str, fn, *args, **span_args):
    """Run ``fn(*args)`` under a span; zero-wrapping when disarmed."""
    if not recording():
        return fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    complete(name, t0, time.perf_counter(), args=span_args or None)
    return out


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_name", "_args", "_t0")

    def __init__(self, name: str, args: dict | None):
        self._name, self._args = name, args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        # module-level complete() fans out to BOTH sinks (tracer shard
        # and flight-recorder ring), whichever subset is armed at exit
        complete(self._name, self._t0, time.perf_counter(), args=self._args)
        return False


def span(name: str, **args):
    """``with obs.span("stage.name"): ...`` — a shared no-op when disarmed."""
    if active_tracer() is None and _flight is None:
        return _NULL_SPAN
    return _Span(name, args or None)


# -- metrics module surface --------------------------------------------------


def add_lines(n: int) -> None:
    """Feed the cumulative line counter (ThroughputMeter.tick calls this)."""
    m = _metrics
    if m is not None:
        m.add_lines(n)


def metric_event(kind: str, **fields) -> None:
    """Push one immediate event record (checkpoint saves, throughput lines)."""
    m = _metrics
    if m is not None:
        m.event(kind, fields)


def typed_event(kind: str, **fields) -> None:
    """One service event on both planes: a trace instant (which the
    flight recorder's tap also takes) and a metrics event record."""
    instant(kind, args=fields)
    metric_event(kind, **fields)


def register_sampler(name: str, fn) -> None:
    """Expose a live gauge callback (``fn() -> dict``) to snapshots and
    dumps, armed or not; a second registration under a name replaces it."""
    with _samplers_lock:
        _samplers[name] = fn


def unregister_sampler(name: str) -> None:
    with _samplers_lock:
        _samplers.pop(name, None)


def metrics_snapshot() -> dict | None:
    """Write one snapshot record now (None when the plane is disarmed)."""
    m = _metrics
    return m.snapshot() if m is not None else None


def metrics_active() -> bool:
    return _metrics is not None


def metrics_health() -> dict | None:
    """The snapshotter's liveness and tick-error counters (None when disarmed)."""
    m = _metrics
    return m.health() if m is not None else None


# -- merge -------------------------------------------------------------------


def merge_trace(trace_dir: str, out_path: str | None = None) -> str:
    """Merge every per-PID shard into one Chrome trace JSON.

    Tolerant by design: a shard's torn final line (a worker killed
    mid-write) and entirely unreadable shards are skipped — after a
    chaos run the surviving timeline must still load.  Events sort by
    timestamp so the file diffs stably and streams into viewers.
    """
    out_path = out_path or os.path.join(trace_dir, "trace.json")
    events: list[dict] = []
    for shard in sorted(glob.glob(os.path.join(trace_dir, "trace-*.jsonl"))):
        try:
            with open(shard, "r", encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a crashed worker's shard
                    if isinstance(ev, dict) and "ph" in ev:
                        events.append(ev)
        except OSError:
            continue
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    # per-PID tmp + atomic rename: in a multi-rank job every launcher
    # merges the shared directory at its own exit, so concurrent merges
    # must each publish a COMPLETE file (last writer wins) rather than
    # interleave writes into one shared tmp path
    tmp = f"{out_path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        os.replace(tmp, out_path)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return out_path
