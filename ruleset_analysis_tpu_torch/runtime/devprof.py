"""Device profiling: ``ra.*`` stage attribution of a bounded capture window.

Counterpart of the reference's ``runtime/devprof.py``, over
``torch.profiler``.  Three legs:

- **Semantic naming.**  Every launch site of the step (the hand kernels'
  wrappers in ``ops/``, the unpack, the counts and CMS adds, the merges
  of ``parallel/``) runs under a stage range of the ``ra.*`` taxonomy
  (``stages.scope``).  Disarmed, a range is a shared no-op context: it
  enters ``torch.profiler.record_function`` only while a profiler of the
  port is live, so a plain run pays one integer test a site.

- **In-process capture windows.**  :class:`DevprofCapture` counts the
  stream loop's dispatches (``stream._Chunks._run``): dispatches
  ``1..warmup`` run unprofiled; before dispatch ``warmup + 1`` it drains
  the card (``torch.cuda.synchronize``, the reference's
  ``block_until_ready``) and starts ``torch.profiler`` (CPU activity, and
  CUDA activity on a CUDA run); after dispatch ``warmup + steps`` it
  synchronises again and stops it.  Each dispatch in the window runs
  inside a program range named by its label (``step.flat``,
  ``step.stacked``, ``step.v6``).  The parse is deferred to
  :meth:`~DevprofCapture.finalize`, which the loop calls after it took
  ``elapsed``: it exports the Chrome trace under ``DIR/torch-trace/``,
  attributes every device event (:func:`summarize_trace`) and writes
  ``DIR/devprof.json``, ``totals.devprof``, an ``obs.instant
  ("devprof.summary")``, an ``obs.metric_event("devprof")`` and the
  ``devprof`` / ``device_mem`` samplers.

- **Shared classifier.**  :func:`attribute_events` is the one
  definition of "which program and stage does this device event belong
  to": the capture and ``tools/trace_attrib.py`` (a ``--profile-dir``
  trace) both use it, and ``tools/trace_diff.py`` diffs two captures.

Attribution.  A device event is a ``kernel``, ``gpu_memcpy`` or
``gpu_memset`` record on CUDA; on the CPU a top-level ``cpu_op`` (one
not nested in another ``cpu_op``: its time holds its children's, so
counting them too would double-count, the reference's "ENTRY only"
rule).  An event counts only when its launch lies inside a program range
(events outside every program are host work between dispatches, which
the reference skips as missing from its index); it goes to the outermost
``ra.*`` range around its launch, else to ``unattributed``.  On CUDA a
kernel reaches its launch through its ``correlation`` argument and the
runtime or driver launch record of the same correlation: the hand
kernels are launched through ctypes from libraries linked with nvcc's
static cudart, and CUPTI records their ``cudaLaunchKernel`` all the same
(the H100's machine, torch 2.11).  A hand kernel record with no such
launch takes its program and stage from the launch log
(``stages.note_kernel``): the window's launches of that kernel in order,
zipped against its records in stream order.

Records against launches.  ``kernel_records`` holds, for each hand
kernel, the launches in the window (its wrapper's launch counter; for
``select_rank_kernel``, which shares the select's counter, the launch
log) and the records the trace kept; ``records_short`` is true when any
kernel kept fewer records than it had launches.  A shortfall is reported,
never topped up from the launch count.

Differences from the reference, on purpose: no ``hlo_instructions``,
``flops`` or ``bytes_accessed`` (torch has no compiled module and no
cost analysis), no program cache and no HLO re-lowering.
``programs[label]`` holds ``dispatches``, ``device_ops`` (device events a
dispatch), ``stages_static`` (a stage's device events a dispatch) and
``fusions``: every hand kernel seen in the program with its
``stages.KERNEL_STAGES`` signature (on the CPU, where each wrapper runs
its plain version, a kernel is seen when its wrapper ran).  The
one-device step has no merge, unlike the reference's program, where
``psum`` is always present: ``ra.merge`` shows only on a mesh of two or
more shards.

Failure model, the reference's: the ``devprof.capture`` fault site fires
at the window's start and stop, outside the try, so an injected fault is
a typed abort; a real failure of ``torch.profiler`` to start or stop is a
clean no-trace run with ``error`` in the summary; :meth:`abort` stops a
dangling profiler; an abort writes no ``devprof.json``.  Single-controller
only: the CLI refuses ``--devprof-out`` with ``--distributed`` or
``--elastic``, and with ``--profile-dir`` (one profiler session a
process).

The serve tier (runtime/serve.py) folds :func:`gauges` and the memory
gauges into ``/metrics``, dispatches its chunks through the armed
capture's seam, and parses a closed window between windows through
:meth:`DevprofCapture.poll`.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import threading
import time
from collections import Counter

from .. import stages
from ..stages import KERNEL_STAGES, SCOPE_RE, STAGES, scope_of  # noqa: F401  (re-exported)
from . import faults, obs

#: the gauge keys, as the reference names them
GAUGE_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

#: Chrome-trace categories of the card's work, and of a launch on the host
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

#: hand kernel -> (port module, the wrapper whose ``launches`` counts it)
KERNEL_COUNTERS = {
    "first_match_kernel": ("ops.first_match", "first_match_rows"),
    "match_hist_kernel": ("ops.match_hist", "match_rows_and_hists"),
    "first_match6_kernel": ("ops.first_match6", "first_match_rows6"),
    "reg_tail_kernel": ("ops.reg_tail", "reg_tail"),
    "select_kernel": ("ops.reg_tail", "select_tables"),
    "relation_grid_kernel": ("ops.overlap", "relation_grid"),
}


def device_memory_gauges(device=None) -> dict:
    """``device_mem_bytes_in_use`` / ``_peak_bytes_in_use`` / ``_bytes_limit``.

    On a CUDA device: the caching allocator's allocated bytes now and at
    their peak (``torch.cuda.memory_stats``) and the card's total memory.
    The device is named explicitly, never taken from the calling thread's
    current device (the sampler runs on the ``ra-metrics`` thread), and
    nothing here synchronises a stream.  On the CPU (``device`` None or a
    CPU device) all three are None, as the reference gives on XLA:CPU: a
    dashboard shows "unsupported", never a fake zero.
    """
    if device is None:
        return {f"device_mem_{k}": None for k in GAUGE_KEYS}
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {f"device_mem_{k}": None for k in GAUGE_KEYS}
    if device.index is None:
        raise ValueError("device_memory_gauges needs an indexed CUDA device (cuda:N)")
    stats = torch.cuda.memory_stats(device)
    return {
        "device_mem_bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "device_mem_peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "device_mem_bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


def classify_event_name(name: str, args: dict | None = None) -> str | None:
    """Stage of one raw trace event, from its name or its args (the
    reference's classifier): None when no ``ra.*`` token is present."""
    s = scope_of(name)
    if s is not None:
        return s
    for k in ("long_name", "tf_op", "name", "op_name", "hlo_op"):
        v = (args or {}).get(k)
        if isinstance(v, str):
            s = scope_of(v)
            if s is not None:
                return s
    return None


def kernel_base(name: str) -> str:
    """A CUPTI kernel name without its namespaces, return type, template
    arguments and parameters: "(anonymous namespace)::first_match_kernel(
    unsigned int const*, ...)" -> "first_match_kernel"; a name that does
    not parse stays as it is."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return head[-1].split("::")[-1] if head else name


def launch_counts() -> dict[str, int]:
    """Each hand kernel's launches in this process so far (its wrapper's counter)."""
    pkg = __package__.rsplit(".", 1)[0]
    return {k: getattr(importlib.import_module(f"{pkg}.{mod}"), fn).launches
            for k, (mod, fn) in KERNEL_COUNTERS.items()}


class _Ranges:
    """One thread's user-annotation ranges, nested: which hold a time."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        spans.sort(key=lambda s: (s[0], -s[1]))
        self.spans = spans
        self.starts = [s[0] for s in spans]
        self.parent = []
        stack: list[int] = []
        for i, (t0, t1, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] < t1:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, t: float) -> list[str]:
        """Names of the ranges holding ``t``, outermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out[::-1]


def _top_level_cpu_ops(xs: list[dict]) -> list[dict]:
    """The ``cpu_op`` events nested in no other ``cpu_op`` of their thread."""
    by_thread: dict[tuple, list[dict]] = {}
    for e in xs:
        if e.get("cat") == "cpu_op":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = None
        for e in evs:
            if end is None or e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def attribute_events(events: list, programs=None, launch_log=None) -> list[dict]:
    """Every device event of a ``torch.profiler`` Chrome trace, with the
    program and ``ra.*`` stage ranges around its launch.

    ``programs``: the program range names (a capture's dispatch labels);
    None takes any ``step.*`` range.  ``launch_log``: the capture's
    ``(program, stage, kernel)`` launches, for hand kernel records whose
    launch record is missing.  Returns ``[{"name", "kernel", "pid",
    "dur", "program", "stage", "via"}]`` in trace order, ``program`` None
    for an event outside every program range, ``via`` one of
    ``"correlation"``, ``"log"``, ``"host"`` (a CPU op) or None (no
    launch found).
    """
    xs = [e for e in events if isinstance(e, dict) and e.get("ph") == "X" and "dur" in e
          and "ts" in e]
    spans: dict[tuple, list] = {}
    for e in xs:
        if e.get("cat") == "user_annotation":
            spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
    ranges = {k: _Ranges(v) for k, v in spans.items()}

    def is_program(name: str) -> bool:
        return name in programs if programs is not None else name.startswith("step.")

    def place(pid, tid, t) -> tuple[str | None, str | None]:
        r = ranges.get((pid, tid))
        chain = r.chain(float(t)) if r is not None else []
        program = next((n for n in chain if is_program(n)), None)
        stage = next((s for s in map(scope_of, chain) if s is not None), None)
        return program, stage

    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    out = []
    if not device:
        for e in _top_level_cpu_ops(xs):
            program, stage = place(e.get("pid"), e.get("tid"), e["ts"])
            out.append({"name": e.get("name", ""), "kernel": None, "pid": e.get("pid"),
                        "dur": float(e["dur"]), "program": program, "stage": stage,
                        "via": "host"})
        return out
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None and (c not in launches or e.get("cat") == "cuda_runtime"):
                launches[c] = e
    for e in device:
        name = e.get("name", "")
        base = kernel_base(name) if e.get("cat") == "kernel" else None
        rec = {"name": name, "kernel": base if base in KERNEL_STAGES else None,
               "pid": e.get("pid"), "dur": float(e["dur"]), "program": None, "stage": None,
               "via": None, "_ts": float(e["ts"])}
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            rec["program"], rec["stage"] = place(launch.get("pid"), launch.get("tid"),
                                                 launch["ts"])
            rec["via"] = "correlation"
        out.append(rec)
    if launch_log:
        # a hand kernel's records in stream order against its logged launches
        logged: dict[str, list] = {}
        for program, stage, kernel in launch_log:
            logged.setdefault(kernel, []).append((program, stage))
        for kernel, entries in logged.items():
            recs = sorted((r for r in out if r["kernel"] == kernel), key=lambda r: r["_ts"])
            for r, (program, stage) in zip(recs, entries):
                if r["via"] is None:
                    r["program"], r["stage"], r["via"] = program, stage, "log"
    for r in out:
        del r["_ts"]
    return out


def summarize_trace(events: list, dispatches: dict[str, int], launch_log=None,
                    launches: dict[str, int] | None = None) -> dict:
    """The attribution half of a capture summary, from its Chrome trace.

    ``dispatches``: program label -> dispatches in the window;
    ``launch_log``: ``(program, stage, kernel)`` of every hand kernel the
    window launched (or, on the CPU, ran as its plain version);
    ``launches``: each hand kernel's launches in the window (its counter).
    """
    log = list(launch_log or ())
    recs = attribute_events(events, programs=set(dispatches), launch_log=log)
    stages_us: dict[str, float] = {}
    stage_events: Counter = Counter()
    unattributed_us = 0.0
    per_prog: dict[str, Counter] = {label: Counter() for label in dispatches}
    seen: dict[str, set] = {label: set() for label in dispatches}
    for r in recs:
        if r["program"] is None:
            continue  # host work between dispatches
        if r["stage"] is None:
            unattributed_us += r["dur"]
        else:
            stages_us[r["stage"]] = stages_us.get(r["stage"], 0.0) + r["dur"]
            stage_events[r["stage"]] += 1
        per_prog[r["program"]][r["stage"] or "unattributed"] += 1
        if r["kernel"] is not None:
            seen[r["program"]].add(r["kernel"])
    for program, _stage, kernel in log:
        if program in seen and kernel in KERNEL_STAGES:
            seen[program].add(kernel)
    total_us = sum(stages_us.values()) + unattributed_us
    stage_rows = {
        s: {
            "device_us": round(us, 1),
            "pct": round(100.0 * us / total_us, 2) if total_us else 0.0,
            "events": stage_events[s],
        }
        for s, us in sorted(stages_us.items(), key=lambda kv: -kv[1])
    }
    programs = {}
    for label, n in sorted(dispatches.items()):
        ops = per_prog[label]
        programs[label] = {
            "dispatches": n,
            "device_ops": round(sum(ops.values()) / max(n, 1), 2),
            "stages_static": {s: {"ops": round(c / max(n, 1), 2)}
                              for s, c in sorted(ops.items())},
            "fusions": [{"name": k, "stages": sorted(KERNEL_STAGES[k])}
                        for k in sorted(seen[label])],
        }
    cross = [
        {"program": label, "name": f["name"], "stages": f["stages"]}
        for label, prog in programs.items()
        for f in prog["fusions"]
        if len(f["stages"]) > 1
    ]
    kept = Counter(r["kernel"] for r in recs if r["kernel"] is not None)
    launched = dict(launches or {})
    rank = sum(1 for _p, _s, k in log if k == "select_rank_kernel")
    if rank or kept["select_rank_kernel"]:
        launched["select_rank_kernel"] = rank
    kernel_records = {k: {"launches": int(n), "records": int(kept[k])}
                      for k, n in sorted(launched.items())}
    return {
        "device_us_total": round(total_us, 1),
        "attributed_frac": (
            round(1.0 - unattributed_us / total_us, 4) if total_us else 0.0
        ),
        "unattributed": {
            "device_us": round(unattributed_us, 1),
            "pct": round(100.0 * unattributed_us / total_us, 2) if total_us else 0.0,
        },
        "stages": stage_rows,
        "programs": programs,
        "cross_stage_fusions": cross,
        "kernel_records": kernel_records,
        "records_short": any(v["records"] < v["launches"] for v in kernel_records.values()),
    }


def start_profiler(device):
    """The window's started ``torch.profiler.profile``: CPU activity, and
    CUDA activity on a CUDA ``device`` (a torch that cannot record it
    raises)."""
    from torch import profiler as tprof

    acts = [tprof.ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        if tprof.ProfilerActivity.CUDA not in tprof.supported_activities():
            raise RuntimeError("this torch cannot record CUDA activity (no CUPTI)")
        acts.append(tprof.ProfilerActivity.CUDA)
    prof = tprof.profile(activities=acts)
    prof.start()
    return prof


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


class DevprofCapture:
    """One bounded in-process profiler window over the loop's dispatches.

    Dispatches 1..warmup run unprofiled; the profiler starts before
    dispatch warmup+1 (the card drained first) and stops after dispatch
    warmup+steps (synchronised first, so no work of the window is still
    running).  Everything after is a plain pass-through, so a long run
    pays the capture once.
    """

    def __init__(self, out_dir: str, steps: int = 16, warmup: int = 3, label: str = ""):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = os.path.abspath(out_dir)
        self.trace_dir = os.path.join(self.out_dir, "torch-trace")
        self.steps = int(steps)
        self.warmup = int(warmup)
        self.label = label
        self._lock = threading.Lock()
        self._count = 0
        self._profiling = False
        self._done = False
        self._pending_parse = False
        self._error: str | None = None
        self._summary: dict | None = None
        #: wall time the profiler was live (the bounded capture pause)
        self._window_wall: float | None = None
        self._t_window0: float | None = None
        self._prof = None
        self._device = None
        #: label -> {"dispatches"} (programs seen in-window)
        self._programs: dict[str, dict] = {}
        self._log: list | None = None
        self._launches0: dict[str, int] = {}
        self._launches: dict[str, int] = {}

    # -- dispatch seam ---------------------------------------------------

    def dispatch(self, label: str, fn, args=(), device=None):
        """Run one device dispatch ``fn(*args)``, advancing the window."""
        if self._done:
            return fn(*args)
        start = stop = False
        with self._lock:
            if self._done:
                return fn(*args)
            self._count += 1
            if not self._profiling and self._count == self.warmup + 1:
                start = True
            if self._profiling or start:
                prog = self._programs.setdefault(label, {"dispatches": 0})
                prog["dispatches"] += 1
                if self._count >= self.warmup + self.steps:
                    stop = True
        if start:
            if device is not None:
                import torch

                self._device = torch.device(device)
            # drain the warmup dispatches: their tail must not run (and be
            # recorded) inside the window
            _sync(self._device)
            self._start()
            if self._done:  # start failed: clean no-trace run
                return fn(*args)
        if not self._profiling:
            return fn(*args)
        from torch.profiler import record_function

        stages._program = label
        try:
            with record_function(label):
                out = fn(*args)
        finally:
            stages._program = None
        if stop:
            _sync(self._device)
            self._close_window()
        return out

    # -- window control --------------------------------------------------

    def _start(self) -> None:
        # the fault site fires OUTSIDE the try: an injected failure is a
        # typed abort, a real profiler failure a clean no-trace run
        faults.fire("devprof.capture")
        # the pause clock starts before the profiler: its start-up is the
        # capture's cost, not the run's
        t0 = time.perf_counter()
        try:
            self._prof = start_profiler(self._device)
        except Exception as e:
            self._error = f"profiler start failed: {e}"
            self._done = True
            return
        self._t_window0 = t0
        self._profiling = True
        self._launches0 = launch_counts()
        self._log = []
        stages._log = self._log
        stages.set_live(True)

    def _release(self) -> None:
        """The window's hooks off: stage ranges disarmed, the launch log closed."""
        stages.set_live(False)
        stages._log = None
        now = launch_counts()
        self._launches = {k: now[k] - self._launches0.get(k, 0) for k in now}

    def _close_window(self) -> None:
        """Stop the profiler at the window boundary; the export and parse
        wait for :meth:`finalize` / :meth:`poll`, after the loop took its
        ``elapsed``."""
        self._done = True
        try:
            # typed-abort seam: an injected stop failure propagates, and
            # abort() still stops the live profiler on the way out
            faults.fire("devprof.capture")
        except BaseException:
            self.abort()
            raise
        self._profiling = False
        self._release()
        try:
            self._prof.stop()
        except Exception as e:
            self._error = f"profiler stop failed: {e}"
            self._prof = None
            return
        if self._t_window0 is not None:
            self._window_wall = time.perf_counter() - self._t_window0
        self._pending_parse = True

    def _ensure_parsed(self) -> None:
        if not self._pending_parse:
            return
        self._pending_parse = False
        try:
            self._summary = self._parse()
        except Exception as e:  # attribution must never kill the run
            self._error = f"trace parse failed: {e}"
            return
        self._emit(self._summary)

    def poll(self) -> None:
        """Parse a closed window if one is waiting (never closes an open one)."""
        self._ensure_parsed()

    def abort(self) -> None:
        """Stop a dangling profiler without parsing (typed-abort path)."""
        if self._profiling:
            self._profiling = False
            self._done = True
            self._release()
            try:
                self._prof.stop()
            except Exception:
                pass
            self._prof = None

    def finalize(self) -> dict:
        """Close the window (the stream may end early) and return the summary.

        Idempotent; always returns a dict: a window that never opened
        (stream shorter than the warmup) or failed says so.
        """
        if self._profiling:
            _sync(self._device)
            self._close_window()
        self._done = True
        self._ensure_parsed()
        if self._summary is not None:
            return self._summary
        out = {
            "steps_profiled": 0,
            "requested_steps": self.steps,
            "warmup": self.warmup,
        }
        if self.label:
            out["label"] = self.label
        if self._error is not None:
            out["error"] = self._error
        else:
            out["note"] = (
                "stream ended before the capture window opened "
                f"(saw {self._count} dispatches, warmup {self.warmup})"
            )
        return out

    # -- attribution -----------------------------------------------------

    def _parse(self) -> dict:
        os.makedirs(self.trace_dir, exist_ok=True)
        trace_path = os.path.join(self.trace_dir, f"devprof-{os.getpid()}.pt.trace.json")
        prof, self._prof = self._prof, None
        prof.export_chrome_trace(trace_path)
        with open(trace_path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        dispatches = {label: p["dispatches"] for label, p in self._programs.items()}
        attrib = summarize_trace(events, dispatches, self._log, self._launches)
        dev = self._device
        cuda = dev is not None and dev.type == "cuda"
        if cuda:
            import torch

            n_dev = torch.cuda.device_count()
        else:
            n_dev = 1
        out = {
            "requested_steps": self.steps,
            "warmup": self.warmup,
            "steps_profiled": sum(dispatches.values()),
            # the bounded pause the live profiler cost this run: price it
            # apart from the sustained rate, like compile_sec
            "window_wall_sec": (
                round(self._window_wall, 3) if self._window_wall is not None else None
            ),
            "backend": "cuda" if cuda else "cpu",
            "devices": n_dev,
            **attrib,
            "trace_path": trace_path,
            "memory": device_memory_gauges(dev if cuda else None),
        }
        if self.label:
            out["label"] = self.label
        if self._error:
            out["error"] = self._error
        return out

    def _emit(self, summary: dict) -> None:
        path = os.path.join(self.out_dir, "devprof.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
        os.replace(tmp, path)
        self.json_path = path
        brief = self.gauges()
        obs.instant("devprof.summary", args=brief)
        obs.metric_event("devprof", **brief)

    def gauges(self) -> dict:
        """Flat numeric gauges for the metrics JSONL (and serve's /metrics)."""
        s = self._summary
        if s is None:
            return {"devprof_steps_profiled": 0}
        g = {
            "devprof_steps_profiled": s["steps_profiled"],
            "devprof_attributed_frac": s["attributed_frac"],
            "devprof_device_us_total": s["device_us_total"],
        }
        top = next(iter(s["stages"]), None)
        if top is not None:
            g["devprof_top_stage"] = top
            g["devprof_top_stage_pct"] = s["stages"][top]["pct"]
        for name, st in s["stages"].items():
            g[f"devprof_pct_{name.replace('.', '_')}"] = st["pct"]
        return g


# ---------------------------------------------------------------------------
# Module arming state: ``_capture is None`` is the production fast path
# (one None-check a dispatch).
# ---------------------------------------------------------------------------

_capture: DevprofCapture | None = None


def arm(out_dir: str, steps: int = 16, warmup: int = 3, label: str = "",
        mem_gauges=None) -> DevprofCapture:
    """Arm a capture window process-wide (``--devprof-out``).

    Single-controller only: the window brackets THIS process's dispatches
    and the parse reads this process's trace.  Also registers the
    ``devprof`` and ``device_mem`` samplers with the metrics plane
    (``mem_gauges``: the run's bound :func:`device_memory_gauges`; the
    CPU's nulls by default).
    """
    global _capture
    from ..config import DevprofConfig
    from ..errors import AnalysisError

    try:
        # one definition of the limits, for the CLI and the API alike
        DevprofConfig(out_dir=out_dir, steps=steps, warmup=warmup)
    except ValueError as e:
        raise AnalysisError(str(e)) from e
    cap = DevprofCapture(out_dir, steps=steps, warmup=warmup, label=label)
    _capture = cap
    obs.register_sampler("devprof", cap.gauges)
    obs.register_sampler("device_mem", mem_gauges or device_memory_gauges)
    return cap


def active_capture() -> DevprofCapture | None:
    """The armed capture (the hot-path accessor: one None-check)."""
    return _capture


def gauges() -> dict:
    """The armed capture's flat gauges, or {}."""
    cap = _capture
    return cap.gauges() if cap is not None else {}


def finalize_if_armed() -> dict | None:
    """Driver seam: close the window and return the ``totals.devprof``
    block (None when disarmed).  The capture stays armed so its gauges
    answer until :func:`shutdown`."""
    cap = _capture
    if cap is None:
        return None
    return cap.finalize()


def shutdown() -> None:
    """Disarm; stop any dangling profiler (abort path) without parsing."""
    global _capture
    cap = _capture
    _capture = None
    if cap is not None:
        cap.abort()
        obs.unregister_sampler("devprof")
        obs.unregister_sampler("device_mem")
