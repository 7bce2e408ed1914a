"""Always-on flight recorder and crash forensics.

The port's copy of the reference's ``runtime/flightrec.py``: the black
box that is always recording, so a run that ends in a typed abort, a
watchdog stall or a killed worker leaves more than an exit code.

- **Ring.**  Each process keeps a fixed-size in-memory ring of recent
  telemetry events, overwritten in place: the spans and instants of the
  ``obs`` emit path (the tap is one module-global ``None`` check per
  event), fault and retry instants, and a small cursor dict (the last
  committed batch).  No per-event file I/O: the ring touches disk only
  at a dump trigger, and a dump reads no device tensor, so it cannot
  hang on a poisoned CUDA context.

- **Dump triggers** (:data:`TRIGGERS`).  A typed ``AnalysisError``
  escalation, a watchdog ``StallError``, an unhandled exception
  (``sys.excepthook`` / ``threading.excepthook``), an operator
  ``SIGQUIT``, or an injected ``crash`` fault dumps the process's ring
  to a per-PID shard (``blackbox-<pid>.json``) under the blackbox
  directory.  Feed workers also *seal* their ring at exit, so a run that
  dies can merge the survivors' telemetry; a clean run prunes every
  shard and leaves nothing behind.

- **Bundle.**  The CLI's ``finally`` merges all shards into one
  ``postmortem.json`` naming the dump trigger, the failing stage,
  per-stage occupancy over each shard's final ring window, retry
  history and every fired fault site; ``doctor`` turns a bundle and an
  exit code into a ranked diagnosis (:func:`diagnose`).

- **Inheritance.**  :func:`arm` exports :data:`ENV_VAR`
  (``RA_BLACKBOX_DIR``) as ``obs`` exports ``RA_TRACE_DIR``, so spawned
  feed workers arm their own rings on their first ``obs`` activity and
  join the merge.

A shard carries a reading of every live metrics sampler
(``obs.sampler_snapshot``), and a bundle's ``queue_depths`` reads the
prefetch queue's from it.  The reference reads them only at the dump, by
when a typed abort's teardown has unregistered the prefetch queue's
sampler; the run loops here call :func:`note_gauges` as the failure
unwinds, before that teardown, and a dump keeps those readings for the
samplers gone since.  ``doctor`` joins a bundle with the window
lineage ledger beside it (:func:`find_lineage`, :func:`load_lineage`,
``diagnose(lineage=)``).  :func:`disarm` removes the excepthooks and
the SIGQUIT handler that :func:`arm` installed.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import sys
import threading
import time

from ..errors import AnalysisError, StallError

#: Environment variable carrying the blackbox directory to child
#: processes (the RA_TRACE_DIR / RA_FAULT_PLAN inheritance discipline).
ENV_VAR = "RA_BLACKBOX_DIR"

#: Kill switch for the CLI's DEFAULT arming (``RA_BLACKBOX=off``): test
#: harnesses set it so incidental CLI invocations don't write forensics
#: into the working tree.  An explicit ``--blackbox-dir`` still arms.
KILL_SWITCH = "RA_BLACKBOX"

#: Events retained per process.  512 events cover the final seconds of
#: any pipeline tier at production batch cadence while bounding the
#: ring's memory to well under a megabyte.
DEFAULT_RING_EVENTS = 512

#: Registered dump triggers: name -> what fired the dump.
TRIGGERS: dict[str, str] = {
    "abort": "a typed AnalysisError escalated out of the run",
    "stall": "a watchdog bounded a hang (StallError, exit code 6)",
    "unhandled": "an untyped exception reached the top of a thread or "
                 "the interpreter (sys/threading excepthook)",
    "signal": "an operator SIGQUIT requested a live forensics snapshot "
              "without stopping the service",
    "crash": "an injected crash fault (faults.py os._exit action) — the "
             "OOM-kill analog dumps its ring before dying",
    "worker-exit": "a worker process sealed its ring at teardown "
                   "(merged only when the supervising run aborts; a "
                   "clean run prunes every seal)",
}


class FlightRing:
    """Fixed-size overwrite-in-place event ring (lock-light).

    Slots are pre-allocated; :meth:`append` is one short critical
    section (slot store + index bump).  Events are Chrome-trace-shaped
    dicts, as the tracer writes them.
    """

    def __init__(self, capacity: int = DEFAULT_RING_EVENTS):
        if capacity < 8:
            raise AnalysisError(
                f"flight ring capacity must be >= 8 events, got {capacity}"
            )
        self._slots: list = [None] * capacity
        self._n = 0
        self._lock = threading.Lock()

    def append(self, ev: dict) -> None:
        with self._lock:
            self._slots[self._n % len(self._slots)] = ev
            self._n += 1

    @property
    def total(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return len(self._slots)

    def events(self) -> list[dict]:
        """Retained events, oldest first."""
        with self._lock:
            n, cap = self._n, len(self._slots)
            if n <= cap:
                return [e for e in self._slots[:n] if e is not None]
            i = n % cap
            return [e for e in self._slots[i:] + self._slots[:i] if e is not None]


class _Recorder:
    """One process's armed flight recorder (ring + cursors + identity)."""

    def __init__(self, blackbox_dir: str, role: str, ring_events: int):
        self.dir = os.path.abspath(blackbox_dir)
        self.role = role
        self.pid = os.getpid()
        self.ring = FlightRing(ring_events)
        self.cursors: dict = {}
        self._cur_lock = threading.Lock()
        # one pairing converts perf_counter endpoints to the shared
        # epoch-microsecond axis (the Tracer discipline), so shards from
        # different processes merge onto one timeline
        self._epoch_us = time.time_ns() // 1_000
        self._pc0 = time.perf_counter()
        self.dumped: list[str] = []  # triggers that dumped this run
        #: sampler readings taken where the run failed (note_gauges)
        self.noted_samplers: dict = {}

    def _us(self, pc: float) -> int:
        return self._epoch_us + int((pc - self._pc0) * 1e6)

    # -- the obs tap (hot path; called with the plane disarmed too) ------
    def span(self, name: str, t0_pc: float, t1_pc: float, args=None) -> None:
        ev = {
            "ph": "X",
            "name": name,
            "pid": self.pid,
            "tid": threading.get_native_id(),
            "ts": self._us(t0_pc),
            "dur": max(0, int((t1_pc - t0_pc) * 1e6)),
        }
        if args:
            ev["args"] = args
        self.ring.append(ev)

    def instant(self, name: str, args=None) -> None:
        ev = {
            "ph": "i",
            "name": name,
            "pid": self.pid,
            "tid": threading.get_native_id(),
            "ts": self._us(time.perf_counter()),
        }
        if args:
            ev["args"] = args
        self.ring.append(ev)

    def cursor(self, kw: dict) -> None:
        with self._cur_lock:
            self.cursors.update(kw)

    # -- dump ------------------------------------------------------------
    def shard_path(self) -> str:
        return os.path.join(self.dir, f"blackbox-{self.pid}.json")

    def dump(self, trigger: str, error=None, exit_code=None) -> str:
        """Atomically write this process's shard (idempotent: last wins)."""
        if trigger not in TRIGGERS:
            raise AnalysisError(
                f"unregistered dump trigger {trigger!r}; registered: "
                f"{', '.join(sorted(TRIGGERS))}"
            )
        from . import obs, retrypolicy

        with self._cur_lock:
            cursors = dict(self.cursors)
        shard = {
            "kind": "ra-blackbox-shard",
            "pid": self.pid,
            "role": self.role,
            "trigger": trigger,
            "t_unix": round(time.time(), 3),
            "ring_events": self.ring.events(),
            "ring_total": self.ring.total,
            "ring_capacity": self.ring.capacity,
            "cursors": cursors,
            # live readings win; the noted ones keep the gauges of the
            # components the failure's teardown already unregistered
            "samplers": {**self.noted_samplers, **obs.sampler_snapshot()},
            "retry": retrypolicy.counters(),
        }
        if error is not None:
            shard["error"] = str(error)[:500]
            shard["error_type"] = type(error).__name__ if isinstance(
                error, BaseException
            ) else "str"
        if exit_code is not None:
            shard["exit_code"] = int(exit_code)
        os.makedirs(self.dir, exist_ok=True)
        path = self.shard_path()
        tmp = f"{path}.{self.pid}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(shard, f, separators=(",", ":"))
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self.dumped.append(trigger)
        return path


# ---------------------------------------------------------------------------
# Module arming state (the faults.py / obs.py discipline: `_rec is None`
# is the production fast path; env check runs at most once per process).
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_rec: _Recorder | None = None
_env_exported = False
_env_checked = False
_noted_error: BaseException | None = None
_noted_exit_code: int | None = None
_hooks = None  # (sys hook, threading hook, SIGQUIT handler) replaced by ours


def armed() -> bool:
    return _rec is not None


def active() -> _Recorder | None:
    return _rec


def arm(
    blackbox_dir: str,
    *,
    role: str = "main",
    ring_events: int = DEFAULT_RING_EVENTS,
    export_env: bool = True,
) -> _Recorder:
    """Arm the recorder process-wide; idempotent per directory.

    ``export_env`` marks this process the run OWNER: the directory is
    published to :data:`ENV_VAR` for spawned workers, stale shards of
    previous runs are pruned (at dump/merge time the directory is
    created lazily — a clean run never touches disk), and the
    supervising merge happens here.
    """
    global _rec, _env_exported, _env_checked, _noted_error, _noted_exit_code
    with _lock:
        cur = _rec
        if cur is not None and cur.dir == os.path.abspath(blackbox_dir):
            # re-arming the same directory starts a NEW run: forget the
            # previous run's failure state so its finalize can't leak a
            # spurious postmortem into this one's clean exit
            _noted_error = None
            _noted_exit_code = None
            cur.dumped.clear()
            cur.noted_samplers = {}
            if export_env:
                os.environ[ENV_VAR] = cur.dir
                _env_exported = True
                _prune_stale(cur.dir)
            return cur
        _rec = _Recorder(blackbox_dir, role, ring_events)
        # a new recorder is a new run: any failure noted by a previous
        # run in this process must not leak into this one's finalize
        _noted_error = None
        _noted_exit_code = None
        _env_checked = True
        if export_env:
            os.environ[ENV_VAR] = _rec.dir
            _env_exported = True
            _prune_stale(_rec.dir)
        rec = _rec
    from . import obs

    obs._set_flight(rec)
    _install_hooks()
    return rec


def maybe_arm_from_env() -> None:
    """One-time lazy arm from the inherited environment (spawned workers)."""
    global _env_checked
    with _lock:
        if _env_checked or _rec is not None:
            _env_checked = True
            return
        _env_checked = True
    d = os.environ.get(ENV_VAR, "")
    if d:
        from . import obs

        arm(d, role=obs._role or "worker", export_env=False)


def disarm() -> None:
    """Disarm, and put back the hooks :func:`arm` replaced."""
    global _rec, _env_exported, _noted_error, _noted_exit_code
    with _lock:
        _rec = None
        _noted_error = None
        _noted_exit_code = None
        if _env_exported:
            os.environ.pop(ENV_VAR, None)
            _env_exported = False
    from . import obs

    obs._set_flight(None)
    _remove_hooks()


def _reset_for_tests() -> None:
    """Forget arming INCLUDING the once-per-process env check."""
    global _env_checked
    disarm()
    with _lock:
        _env_checked = False


def _prune_stale(blackbox_dir: str) -> None:
    """Remove a previous run's leftovers (shards + merged bundle)."""
    for path in glob.glob(os.path.join(blackbox_dir, "blackbox-*.json")):
        try:
            os.unlink(path)
        except OSError:
            pass
    try:
        os.unlink(os.path.join(blackbox_dir, "postmortem.json"))
    except OSError:
        pass


# -- production call surface (every function below is a no-op disarmed) ----


def cursor(**kw) -> None:
    """Update the last-known-position cursors (committed batch, ckpt/WAL
    seq, current window...) carried in a dump."""
    rec = _rec
    if rec is not None:
        rec.cursor(kw)


def note_gauges() -> None:
    """Read every live metrics sampler now, where a run is failing (the
    run loops call it as an exception unwinds, before their sources
    close): a later dump carries these readings for the samplers that
    teardown unregisters first."""
    rec = _rec
    if rec is not None:
        from . import obs

        rec.noted_samplers = obs.sampler_snapshot()


def dump(trigger: str, error=None, exit_code=None) -> str | None:
    rec = _rec
    if rec is None:
        return None
    try:
        return rec.dump(trigger, error=error, exit_code=exit_code)
    except OSError:
        return None  # forensics must never mask the failure being recorded


def seal(trigger: str = "worker-exit") -> str | None:
    """Worker-exit seal: dump the ring so a supervising merge can read
    this process's telemetry if the RUN aborts (a clean run prunes it).
    """
    rec = _rec
    if rec is None or rec.ring.total == 0:
        return None
    return dump(trigger)


def classify(exc: BaseException | None) -> str:
    if isinstance(exc, StallError):
        return "stall"
    if isinstance(exc, AnalysisError):
        return "abort"
    return "unhandled"


def note_abort(exc: BaseException | None, exit_code: int) -> None:
    """Record the run's failure for :func:`finalize` (cli error handlers)."""
    global _noted_error, _noted_exit_code
    if _rec is None:
        return
    _noted_error = exc
    _noted_exit_code = exit_code


def note_failure(exit_code: int) -> None:
    """A failure reported by exit code alone."""
    note_abort(None, exit_code)


def finalize() -> str | None:
    """End-of-run step for the supervising process (cli.main finally).

    Aborted run (noted, in-flight unhandled exception, or any dump this
    run): dump this process's ring and merge every shard into
    ``postmortem.json``, returning its path.  Clean run: prune the
    shards worker seals left behind — a clean exit leaves none.
    """
    rec = _rec
    if rec is None:
        return None
    exc = _noted_error
    if exc is None:
        exc = sys.exc_info()[1]
        # an operator Ctrl-C / normal interpreter exit is teardown, not
        # a crash: it must not leave forensics claiming a failure
        if isinstance(exc, (KeyboardInterrupt, SystemExit)):
            exc = None
    if exc is None and _noted_exit_code is None and not rec.dumped:
        # clean exit: leave NO forensics behind
        _prune_stale(rec.dir)
        return None
    if exc is not None or _noted_exit_code is not None:
        trigger = classify(exc) if exc is not None else "abort"
        dump(trigger, error=exc, exit_code=_noted_exit_code)
    else:
        trigger = rec.dumped[-1]
    try:
        return merge(
            rec.dir,
            trigger=trigger,
            error=exc,
            exit_code=_noted_exit_code,
        )
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Crash hooks: unhandled exceptions and SIGQUIT.
# ---------------------------------------------------------------------------


def _install_hooks() -> None:
    global _hooks
    if _hooks is not None:
        return  # installed until disarm

    prev_sys = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            # Ctrl-C / sys.exit are teardown, not crashes
            if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
                dump(classify(exc), error=exc)
        except Exception:
            pass
        prev_sys(exc_type, exc, tb)

    sys.excepthook = _hook

    prev_thr = threading.excepthook

    def _thr_hook(args):
        try:
            # a dying ra- thread (listener, metrics, producer) seals the
            # moment of death; SystemExit is normal teardown
            if args.exc_type is not SystemExit:
                dump(classify(args.exc_value), error=args.exc_value)
        except Exception:
            pass
        prev_thr(args)

    threading.excepthook = _thr_hook

    # SIGQUIT = operator-triggered live snapshot: dump + merge without
    # stopping the process (only installable from the main thread).  The
    # handler runs ON the main thread, which may be inside any of the
    # ring/cursor/sampler critical sections when the signal lands — so the
    # snapshot itself runs on a short-lived thread (it can safely block on
    # those non-reentrant locks; the interrupted frame resumes and
    # releases them as soon as the handler returns).
    snap_inflight = threading.Event()

    def _snapshot():
        try:
            rec = _rec
            if rec is None:
                return
            dump("signal")
            try:
                merge(rec.dir, trigger="signal", error=None, exit_code=None)
            except OSError:
                pass
        finally:
            snap_inflight.clear()

    def _sigquit(_signum, _frame):
        if _rec is None or snap_inflight.is_set():
            return
        snap_inflight.set()
        threading.Thread(
            target=_snapshot, name="ra-blackbox-snap", daemon=True
        ).start()

    try:
        prev_quit = signal.signal(signal.SIGQUIT, _sigquit)
    except (ValueError, OSError, AttributeError):
        prev_quit = None  # non-main thread / platform without SIGQUIT
    _hooks = (prev_sys, _hook, prev_thr, _thr_hook, prev_quit, _sigquit)


def _remove_hooks() -> None:
    """Restore what :func:`_install_hooks` replaced, where ours still stand."""
    global _hooks
    if _hooks is None:
        return
    prev_sys, hook, prev_thr, thr_hook, prev_quit, sigquit = _hooks
    _hooks = None
    if sys.excepthook is hook:
        sys.excepthook = prev_sys
    if threading.excepthook is thr_hook:
        threading.excepthook = prev_thr
    if prev_quit is not None:
        try:
            if signal.getsignal(signal.SIGQUIT) is sigquit:
                signal.signal(signal.SIGQUIT, prev_quit)
        except (ValueError, OSError):
            pass  # not the main thread: the handler stays, a no-op disarmed


# ---------------------------------------------------------------------------
# Merge: shards -> one postmortem bundle.
# ---------------------------------------------------------------------------


def stage_occupancy(events: list[dict]) -> dict[str, float]:
    """Per-stage busy % over the events' wall window (ring or trace)."""
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if not spans:
        return {}
    t_min = min(e["ts"] for e in spans)
    t_max = max(e["ts"] + e.get("dur", 0) for e in spans)
    wall = max(1, t_max - t_min)
    busy: dict[str, int] = {}
    for e in spans:
        busy[e["name"]] = busy.get(e["name"], 0) + e.get("dur", 0)
    return {
        name: round(100.0 * us / wall, 2)
        for name, us in sorted(busy.items(), key=lambda kv: -kv[1])
    }


def _shard_analysis(shard: dict) -> dict:
    events = shard.get("ring_events", [])
    instants = [e for e in events if e.get("ph") == "i"]
    fault_sites: dict[str, int] = {}
    for e in instants:
        name = e.get("name", "")
        if name.startswith("fault."):
            fault_sites[name[len("fault."):]] = (
                fault_sites.get(name[len("fault."):], 0) + 1
            )
    # tenant activity on the final ring window (multi-tenant serve tags
    # rotate/reload/window events with args.tenant): ranks which lane
    # was hot when the process died
    tenant_events: dict[str, int] = {}
    for e in events:
        t = (e.get("args") or {}).get("tenant")
        if isinstance(t, str):
            tenant_events[t] = tenant_events.get(t, 0) + 1
    # host activity mirrors tenant activity for the distributed serve
    # tier (runtime/distserve.py tags spawn/retire/death/late-epoch
    # instants with args.host): ranks which ingest host was implicated
    # when the process died, across every per-host shard of the bundle
    host_events: dict[str, int] = {}
    for e in events:
        h = (e.get("args") or {}).get("host")
        if isinstance(h, (int, str)) and not isinstance(h, bool):
            host_events[str(h)] = host_events.get(str(h), 0) + 1
    last = events[-1] if events else None
    return {
        "role": shard.get("role"),
        "pid": shard.get("pid"),
        "trigger": shard.get("trigger"),
        "stage_occupancy_pct": stage_occupancy(events),
        "fault_sites_fired": fault_sites,
        "tenant_events": tenant_events,
        "host_events": host_events,
        "last_event": (
            {"name": last.get("name"), "ph": last.get("ph")} if last else None
        ),
        "cursors": shard.get("cursors", {}),
    }


def _failing_stage(shards: list[dict]) -> str | None:
    """Best-evidence failing stage across the merged shards.

    The shard whose dump trigger is a failure (not a worker seal) rules;
    a stall prefers the dominant stall span of its final window
    (starved = the feed side stopped, backpressure = the device side
    wedged), otherwise the last event before the dump names the stage.
    """
    ranked = sorted(
        shards,
        key=lambda s: 0 if s.get("trigger") not in ("worker-exit",) else 1,
    )
    for shard in ranked:
        events = shard.get("ring_events", [])
        if not events:
            continue
        if shard.get("trigger") == "stall":
            occ = stage_occupancy(events)
            stalls = {
                k: v for k, v in occ.items()
                if k in ("ingest.starved", "ingest.backpressure")
            }
            if stalls:
                return max(stalls, key=stalls.get)
        for e in reversed(events):
            name = e.get("name", "")
            if name.startswith("fault."):
                continue  # the injected site is evidence, not a stage
            return name
    return None


def merge(
    blackbox_dir: str,
    *,
    trigger: str,
    error=None,
    exit_code: int | None = None,
    out_path: str | None = None,
) -> str:
    """Merge every per-PID shard into one ``postmortem.json`` bundle."""
    shards: list[dict] = []
    for path in sorted(glob.glob(os.path.join(blackbox_dir, "blackbox-*.json"))):
        try:
            with open(path, "r", encoding="utf-8") as f:
                shard = json.load(f)
        except (OSError, ValueError):
            continue  # a torn shard must not block the others' forensics
        if isinstance(shard, dict) and shard.get("kind") == "ra-blackbox-shard":
            shards.append(shard)
    per_shard = [_shard_analysis(s) for s in shards]
    fault_sites: dict[str, int] = {}
    tenant_events: dict[str, int] = {}
    host_events: dict[str, int] = {}
    dead_hosts: set[str] = set()
    retries: dict[str, dict] = {}
    queue_depths: dict[str, dict] = {}
    degraded: list[str] = []
    for shard, analysis in zip(shards, per_shard):
        for site, n in analysis["fault_sites_fired"].items():
            fault_sites[site] = fault_sites.get(site, 0) + n
        for t, n in analysis["tenant_events"].items():
            tenant_events[t] = tenant_events.get(t, 0) + n
        for h, n in analysis["host_events"].items():
            host_events[h] = host_events.get(h, 0) + n
        # the supervisor's cursor carries the authoritative dead set;
        # union across shards so a rank-0 dump and a surviving host's
        # seal agree on who died
        for h in (shard.get("cursors") or {}).get("dead_hosts", []) or []:
            dead_hosts.add(str(h))
        for site, c in (shard.get("retry") or {}).items():
            agg = retries.setdefault(
                site, {"attempts": 0, "recoveries": 0, "giveups": 0}
            )
            for k in agg:
                agg[k] += int(c.get(k, 0))
        samplers = shard.get("samplers") or {}
        ing = samplers.get("ingest")
        if isinstance(ing, dict):
            queue_depths[f"ingest@{shard.get('role')}"] = {
                "queue_depth": ing.get("queue_depth"),
                "prefetch_depth": ing.get("prefetch_depth"),
            }
        lst = samplers.get("listener")
        if isinstance(lst, dict):
            queue_depths[f"listener@{shard.get('role')}"] = {
                "depth": lst.get("depth"),
                "capacity": lst.get("capacity"),
                "dropped": lst.get("dropped"),
            }
        srv = samplers.get("serve")
        if isinstance(srv, dict) and srv.get("degraded_subsystems"):
            degraded.append(
                f"{srv['degraded_subsystems']} degraded subsystem(s)"
            )
    bundle = {
        "kind": "ra-postmortem",
        "version": 1,
        "created_unix": round(time.time(), 3),
        "trigger": trigger,
        "error": str(error)[:500] if error is not None else None,
        "error_type": type(error).__name__ if isinstance(
            error, BaseException
        ) else None,
        "exit_code": exit_code,
        "shards": shards,
        "analysis": {
            "dump_trigger": trigger,
            "failing_stage": _failing_stage(shards),
            "per_shard": per_shard,
            "fault_sites_fired": fault_sites,
            "tenant_events": tenant_events,
            "host_events": host_events,
            "dead_hosts": sorted(dead_hosts, key=lambda h: (len(h), h)),
            "retries": retries,
            "queue_depths": queue_depths,
            "degraded": degraded,
        },
    }
    os.makedirs(blackbox_dir, exist_ok=True)
    out_path = out_path or os.path.join(blackbox_dir, "postmortem.json")
    tmp = f"{out_path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1)
        os.replace(tmp, out_path)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return out_path


def load_bundle(path: str) -> dict:
    """Read a postmortem bundle (a file, or a dir holding one)."""
    if os.path.isdir(path):
        path = os.path.join(path, "postmortem.json")
    with open(path, "r", encoding="utf-8") as f:
        bundle = json.load(f)
    if not isinstance(bundle, dict) or bundle.get("kind") != "ra-postmortem":
        raise AnalysisError(
            f"{path!r} is not a postmortem bundle (want kind=ra-postmortem; "
            "bundles are written beside the crash as "
            "BLACKBOX_DIR/postmortem.json)"
        )
    return bundle


def find_lineage(bundle_path: str) -> str | None:
    """A ``lineage.jsonl`` beside a postmortem bundle, or None.

    The blackbox dir usually nests under, or sits beside, the serve dir
    that owns the ledger, so the bundle's own directory and its parent
    cover both layouts.
    """
    p = os.path.abspath(bundle_path)
    d = p if os.path.isdir(p) else os.path.dirname(p)
    for cand in (d, os.path.dirname(d)):
        lp = os.path.join(cand, "lineage.jsonl")
        if os.path.isfile(lp):
            return lp
    return None


def load_lineage(path: str) -> list[dict]:
    from .wal import LineageLog

    return LineageLog.read(path)


# ---------------------------------------------------------------------------
# Diagnosis: bundle + exit code -> ranked human-readable causes.
# ---------------------------------------------------------------------------


def diagnose(
    bundle: dict,
    exit_code: int | None = None,
    lineage: list[dict] | None = None,
) -> list[dict]:
    """Ranked diagnoses (most specific first) for one bundle.

    The first-response runbook for exit codes 3-8 (README "Exit codes"):
    each entry carries the suspected cause, the bundle evidence behind
    it, and the operator's next action.  With the serve dir's
    lineage.jsonl records (``lineage=``), the diagnosis also names the
    last fully published window and the first missing or incomplete one:
    the re-ingest frontier after a crash.
    """
    from ..errors import EXIT_CODE_NAMES

    rc = exit_code if exit_code is not None else bundle.get("exit_code")
    a = bundle.get("analysis", {})
    out: list[dict] = []

    def add(cause: str, evidence: str, advice: str) -> None:
        out.append({
            "rank": len(out) + 1,
            "cause": cause,
            "evidence": evidence,
            "advice": advice,
        })

    sites = a.get("fault_sites_fired") or {}
    if sites:
        fired = ", ".join(f"{s} x{n}" for s, n in sorted(sites.items()))
        add(
            "an armed fault plan fired",
            f"fault site instant(s) on the ring: {fired}",
            "this failure was INJECTED (chaos drill); replay with the "
            "same --fault-plan spec to reproduce exactly",
        )
    dead_hosts = a.get("dead_hosts") or []
    if dead_hosts:
        named = ", ".join(f"host {h}" for h in dead_hosts)
        he = a.get("host_events") or {}
        hot = ", ".join(
            f"host {h} x{n}"
            for h, n in sorted(he.items(), key=lambda kv: -kv[1])[:4]
        )
        add(
            "a distributed-serve ingest host died mid-window "
            f"({named})",
            f"rank 0's cursor names dead host(s) {dead_hosts}"
            + (f"; host-tagged ring events: {hot}" if hot else ""),
            "windows overlapping the death carry a typed incomplete "
            "marker naming the host (host_died:<rank>) — their zero-hit "
            "rules are NOT deletion evidence; the host's WAL replays its "
            "tail on rejoin (--dist-respawn), and the per-host shard "
            "blackbox-*.json in this bundle holds its final ring",
        )
    stage = a.get("failing_stage")
    trigger = bundle.get("trigger")
    if rc == 3:
        add(
            "checkpoint corrupt (torn write / bit rot / CRC failure)",
            f"exit code 3 ({EXIT_CODE_NAMES.get(3)}); last stage: {stage}",
            "inspect the snapshot directory's manifest; delete the "
            "snapshot (or fix storage) and rerun — never resume from a "
            "corrupt snapshot",
        )
    elif rc == 4:
        add(
            "checkpoint/resume identity mismatch",
            f"exit code 4 ({EXIT_CODE_NAMES.get(4)})",
            "the snapshot was taken under a different ruleset, sketch "
            "geometry, or input; point --checkpoint-dir elsewhere or "
            "delete it to start fresh",
        )
    elif rc == 5:
        worker_shards = [
            s for s in a.get("per_shard", [])
            if s.get("role") not in (None, "main", "serve")
        ]
        add(
            "the feed tier failed (dead worker / corrupt wire / producer bug)",
            f"exit code 5 ({EXIT_CODE_NAMES.get(5)}); "
            f"{len(worker_shards)} worker shard(s) in the bundle; "
            f"last stage: {stage}",
            "check the worker shards' last events for the dying parse; "
            "an OOM-killed worker leaves NO shard of its own — the "
            "survivors' rings and the coordinator's FeedWorkerError "
            "name the dead slot",
        )
    elif rc == 6 or trigger == "stall":
        occ = {}
        for s in a.get("per_shard", []):
            for k, v in (s.get("stage_occupancy_pct") or {}).items():
                occ[k] = max(occ.get(k, 0.0), v)
        starved = occ.get("ingest.starved", 0.0)
        pressure = occ.get("ingest.backpressure", 0.0)
        if starved >= pressure and starved > 0:
            add(
                "pipeline stalled STARVED: the parse/feed side stopped "
                "delivering batches",
                f"ingest.starved occupied {starved}% of the final ring "
                f"window (backpressure {pressure}%)",
                "check the input source (hung NFS read, wedged feeder "
                "worker, dry listener); raise --stall-timeout only if "
                "the input is legitimately this slow",
            )
        elif pressure > 0:
            add(
                "pipeline stalled DEVICE-BOUND: the consumer stopped "
                "draining the queue",
                f"ingest.backpressure occupied {pressure}% of the final "
                f"ring window (starved {starved}%)",
                "check the device runtime (wedged collective, dead "
                "peer); the last step.dispatch on the ring names the "
                "program that never returned",
            )
        else:
            add(
                "watchdog stall with no stall spans on the ring",
                f"exit code 6 ({EXIT_CODE_NAMES.get(6)}); last stage: {stage}",
                "the stage that wedged emitted nothing — check the "
                "listener heartbeat gauges and the queue depths block",
            )
    elif rc == 7:
        add(
            "elastic re-formation budget exhausted (--max-reforms)",
            f"exit code 7 ({EXIT_CODE_NAMES.get(7)}); elastic.detect "
            "instants on the ring count the failures",
            "peers died more times than the budget allows; inspect the "
            "worker shards for the recurring death cause before raising "
            "--max-reforms",
        )
    elif rc == 8:
        fenced_by = next(
            (
                s.get("cursors", {}).get("fenced_by_term")
                for s in a.get("per_shard", [])
                if s.get("cursors", {}).get("fenced_by_term") is not None
            ),
            None,
        )
        term_txt = (
            f"fenced by term {fenced_by}" if fenced_by is not None
            else "renewals aged past the lease TTL"
        )
        add(
            f"stale distributed-serve supervisor {term_txt} — a "
            "successor won the publication lease",
            f"exit code 8 ({EXIT_CODE_NAMES.get(8)}); the error text "
            f"names the winning term and holder: {bundle.get('error')}",
            "this abort is the split-brain guard WORKING: the successor "
            "replays the per-host epoch spools and publishes every "
            "pending window bit-identically, so nothing is lost — do "
            "NOT restart this process against the same "
            "--dist-spool-dir while the winner is live; check "
            "lease.json there for the current holder",
        )
    elif trigger == "unhandled":
        add(
            "untyped crash (a programming error, not an operational fault)",
            f"trigger=unhandled, error={bundle.get('error_type')}: "
            f"{bundle.get('error')}",
            "this is a bug: file it with the bundle attached — the ring "
            "shows the last events before the crash",
        )
    if not out or (len(out) == 1 and sites):
        add(
            "typed analysis abort",
            f"trigger={trigger}, exit_code={rc}, "
            f"error={bundle.get('error_type')}: {bundle.get('error')}, "
            f"failing stage: {stage}",
            "the error text is the contract; the ring's final events "
            "and cursors show exactly what committed before the abort",
        )
    if a.get("tenant_events"):
        # multi-tenant serve: rank lanes by final-ring activity so the
        # operator knows WHOSE traffic/reload the process died under —
        # the cursors' last tenant names the in-flight lane exactly
        ranked_t = sorted(
            a["tenant_events"].items(), key=lambda kv: -kv[1]
        )[:5]
        cursor_tenant = next(
            (
                s.get("cursors", {}).get("tenant")
                for s in a.get("per_shard", [])
                if s.get("cursors", {}).get("tenant")
            ),
            None,
        )
        add(
            "multi-tenant service: per-tenant activity ranking",
            "final-ring events by tenant: "
            + ", ".join(f"{t} x{n}" for t, n in ranked_t)
            + (f"; cursor tenant: {cursor_tenant}" if cursor_tenant else ""),
            "the top-ranked tenant's window/reload was in flight at the "
            "dump; check its serve_dir/t/<name>/ reports and its "
            "last_reload_error in /health before blaming the shared tier",
        )
    if a.get("retries"):
        tot = sum(r.get("attempts", 0) for r in a["retries"].values())
        give = sum(r.get("giveups", 0) for r in a["retries"].values())
        if tot or give:
            add(
                "the retry plane was active before the failure",
                f"{tot} retry attempt(s), {give} giveup(s): "
                + ", ".join(sorted(a["retries"])),
                "a giveup means a transient seam exhausted its budget — "
                "the environment (disk/network/device) was failing "
                "repeatedly, not momentarily",
            )
    if a.get("degraded"):
        add(
            "non-core subsystems were already degraded",
            "; ".join(a["degraded"]),
            "the service was running in degraded mode before the "
            "failure — check /health history and the degraded "
            "subsystems' first errors",
        )
    es_win = [
        s["cursors"]["epochstore_window"]
        for s in a.get("per_shard", [])
        if s.get("cursors", {}).get("epochstore_window") is not None
    ]
    if es_win:
        es_levels = max(
            (
                s.get("cursors", {}).get("epochstore_levels") or 0
                for s in a.get("per_shard", [])
            ),
            default=0,
        )
        add(
            "durable epoch-store frontier at the dump",
            f"last spilled window: {max(es_win)}; "
            f"segment-tree levels: {es_levels}",
            "every window <= the frontier answers /report/range without "
            "replay; a frontier behind the lineage ledger's last "
            "complete window means the final rotation published but "
            "died before its spill — that window is recoverable from "
            "the WAL, not the store",
        )
    if lineage:
        from .report import lineage_frontier

        fr = lineage_frontier(lineage)
        last = fr.get("last_complete")
        first_bad = fr.get("first_incomplete")
        gaps = fr.get("gaps") or []
        if first_bad is None and gaps:
            first_bad = gaps[0]
        ev = (
            f"{fr.get('windows', 0)} lineage record(s); last complete "
            f"window: {last if last is not None else '-'}"
        )
        if first_bad is not None:
            ev += f"; first missing/incomplete window: {first_bad}"
        if gaps:
            ev += f"; gap window id(s): {gaps[:8]}"
        add(
            "publication frontier from the adjacent lineage ledger",
            ev,
            "every window <= the last complete id is durably published "
            "with a sealed lineage record; re-ingest (or failover "
            "replay) resumes from the first missing/incomplete window — "
            "its record (if any) names the hosts and WAL ranges that "
            "did NOT land",
        )
    return out


def render_diagnosis(bundle: dict, diagnoses: list[dict]) -> str:
    from ..errors import EXIT_CODE_NAMES

    rc = bundle.get("exit_code")
    head = [
        "== postmortem diagnosis ==",
        f"  trigger: {bundle.get('trigger')}   exit code: {rc}"
        + (f" ({EXIT_CODE_NAMES.get(rc)})" if rc in EXIT_CODE_NAMES else ""),
        f"  error: {bundle.get('error_type')}: {bundle.get('error')}",
        f"  shards: {len(bundle.get('shards', []))} "
        f"(roles: {', '.join(sorted({str(s.get('role')) for s in bundle.get('shards', [])})) or '-'})",
        f"  failing stage: {bundle.get('analysis', {}).get('failing_stage')}",
    ]
    for d in diagnoses:
        head.append(f"  [{d['rank']}] {d['cause']}")
        head.append(f"      evidence: {d['evidence']}")
        head.append(f"      next: {d['advice']}")
    return "\n".join(head)
