"""Metrics-driven elastic autoscaling: the policy engine and its controller.

The port's copy of the reference's ``runtime/autoscale.py``.  The elastic
tier (runtime/elastic.py) re-forms the job when a peer dies; this module
makes it re-form on *load*.  The metrics plane (runtime/obs.py) already
carries the signals a policy needs (the prefetch queue's cumulative
backpressure and starvation seconds, runtime/ingest.py), and the epoch
checkpoints resume at any world size, so scaling is a policy on top of
the re-formation the tier already does: decide when the signals justify
another world size, then retire the generation as a planned scale event.

- :class:`PolicyEngine`: the pure decision table over samples of two
  signals in [0, 1], **pressure** (the device-bound share of recent wall
  time: sustained, scale OUT) and **starvation** (the input-bound share:
  sustained, scale IN).  A decision needs the signal's minimum over a
  whole ``sustain_sec`` window at its threshold, ``cooldown_sec`` since
  the last decision, and budget left.  Each decision carries its evidence
  and is an ``autoscale.decide`` trace instant and an ``autoscale``
  metrics event; the ``autoscale.decide`` fault site fires just before a
  decision leaves the engine.
- :class:`MetricsTail` and :func:`ingest_signals`: from the metrics JSONL
  a worker writes (the file ``--metrics-out`` writes) to the two signals.
  :func:`render_prom` and :func:`render_prom_labeled` give the same gauges
  as Prometheus text.
- :class:`AutoscaleController`: a thread on the elastic leader, one a
  generation, that tails its rank-0 worker's metrics shard and publishes
  at most one scale request into the rendezvous directory.

Scale events are planned: they spend the autoscaler's own
``reform_budget``, never ``--max-reforms`` (the failure budget), and a
budget of 0 runs the policy observe-only: decisions with evidence, no
actuation.

Left out until the serve items: the serve tier, which embeds the
engine, resizes its device mesh and serves :func:`render_prom` (its
``serve --autoscale`` flags), waits for the serve item, and the caller of
:func:`host_ladder`, the distributed serve tier, for the distributed-serve
item.  ``world_ladder(divisors_of=)`` is kept for the serve tier's
ladder.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque

from ..config import AutoscaleConfig
from ..errors import AnalysisError
from . import faults, obs


def parse_plan(plan: str) -> list[tuple[str, float]]:
    """``"out@T,in@T"`` -> ordered [(direction, seconds offset)] entries.

    ``AutoscaleConfig`` validates the spec; this is the one decoder the
    engine uses (scripted drills and tests: production decides from the
    live signals).
    """
    out: list[tuple[str, float]] = []
    for part in filter(None, (p.strip() for p in plan.split(","))):
        d, _, t = part.partition("@")
        if d not in ("out", "in"):
            raise AnalysisError(f"autoscale plan entry {part!r}: direction must be 'out' or 'in'")
        try:
            out.append((d, float(t)))
        except ValueError as e:
            raise AnalysisError(f"autoscale plan entry {part!r}: want DIRECTION@SECONDS") from e
    return out


def world_ladder(min_world: int, max_world: int, *, divisors_of: int = 0) -> list[int]:
    """The allowed world sizes, smallest first.

    ``divisors_of`` keeps only the divisors of that extent (the serve
    tier's padded batch geometry, fixed at the largest world: a world
    that divides it keeps every chunk boundary, so the report stays the
    same across scale events).  0 = every integer in range (the elastic
    tier: the collective step is right at any world).
    """
    if divisors_of:
        rungs = [k for k in range(1, divisors_of + 1)
                 if divisors_of % k == 0 and min_world <= k <= max_world]
    else:
        rungs = list(range(min_world, max_world + 1))
    if not rungs:
        raise AnalysisError(
            f"autoscale world ladder is empty (min {min_world}, max {max_world}"
            + (f", divisors of {divisors_of}" if divisors_of else "") + ")"
        )
    return rungs


def host_ladder(min_hosts: int, max_hosts: int) -> list[int]:
    """The allowed HOST counts of a distributed serve tier.

    Every host runs its own whole mesh and the cross-host register merge
    does not depend on the host count, so any contiguous count is
    reachable; the checkpoint fingerprint pins ``max_hosts``, so a
    checkpoint taken at any count resumes at any other on the ladder.
    """
    return world_ladder(min_hosts, max_hosts)


@dataclasses.dataclass
class ScaleDecision:
    """One policy decision with its evidence."""

    seq: int
    direction: str  # "out" | "in"
    from_world: int
    to_world: int
    reason: str  # "backpressure" | "starvation" | "plan"
    t: float  # the engine's clock (the caller's ``now``) at the decision
    actuate: bool  # False when observe-only (reform_budget 0)
    evidence: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class PolicyEngine:
    """The sustained-signal decision table (pure: feed samples, get decisions).

    At every :meth:`observe`:

    1. budget spent (``reform_budget`` actuations used) -> hold for good;
    2. within ``cooldown_sec`` of the last decision -> hold;
    3. the sample window does not yet span ``sustain_sec`` -> hold (the
       window empties at every decision: signals after a re-formation
       describe another capacity);
    4. min(pressure) over the window >= ``out_threshold`` and a higher
       rung exists -> scale OUT one rung;
    5. else min(starvation) >= ``in_threshold`` and a lower rung exists
       -> scale IN one rung.

    A reversal (out after in, or in after out) within
    ``2 * (cooldown_sec + sustain_sec)`` of the last decision counts as a
    **flap**; the damping knobs are there to keep that count at zero.
    """

    def __init__(self, acfg: AutoscaleConfig, *, world: int, ladder: list[int]):
        if world not in ladder:
            raise AnalysisError(f"current world {world} is not on the autoscale ladder {ladder}")
        self.acfg = acfg
        self.ladder = list(ladder)
        self.world = world
        self.budget_left = acfg.reform_budget
        self.observe_only = acfg.reform_budget == 0
        self.decisions: list[ScaleDecision] = []
        self.flaps = 0
        self.suppressed_budget = 0  # decisions that the spent budget held back
        self._window: deque[tuple[float, float, float]] = deque()
        self._t0: float | None = None
        self._last: ScaleDecision | None = None
        self._plan = parse_plan(acfg.plan)
        self._plan_fired = 0
        self._budget_noted = False
        self._seq = 0

    def _rung(self, direction: str) -> int | None:
        i = self.ladder.index(self.world)
        if direction == "out":
            return self.ladder[i + 1] if i + 1 < len(self.ladder) else None
        return self.ladder[i - 1] if i > 0 else None

    def _decide(self, direction: str, reason: str, now: float,
                evidence: dict) -> ScaleDecision | None:
        target = self._rung(direction)
        if target is None:
            return None  # at the edge of the ladder already
        if not self.observe_only and self.budget_left <= 0:
            self.suppressed_budget += 1
            if not self._budget_noted:
                self._budget_noted = True
                obs.instant("autoscale.budget_exhausted",
                            args={"reform_budget": self.acfg.reform_budget})
            return None
        damping = 2 * (self.acfg.cooldown_sec + self.acfg.sustain_sec)
        prev = self._last
        if prev is not None and prev.direction != direction and now - prev.t < damping:
            self.flaps += 1
        self._seq += 1
        dec = ScaleDecision(seq=self._seq, direction=direction, from_world=self.world,
                            to_world=target, reason=reason, t=now,
                            actuate=not self.observe_only, evidence=evidence)
        # fault site: a decision that fails to LEAVE the engine must end in a
        # typed abort, never in a half-issued scale event
        faults.fire("autoscale.decide")
        self.decisions.append(dec)
        self._last = dec
        self._window.clear()
        if dec.actuate:
            self.budget_left -= 1
            self.world = target
        # the damping window rides the instant, so the trace alone counts
        # flaps (tools/trace_summary.py's autoscale block)
        obs.instant("autoscale.decide", args={**dec.to_dict(), "damping_window_sec": damping})
        obs.metric_event("autoscale", **dec.to_dict())
        return dec

    def observe(self, *, now: float, pressure: float, starvation: float,
                gauges: dict | None = None) -> ScaleDecision | None:
        """Feed one sample; a decision when the table fires."""
        a = self.acfg
        if self._t0 is None:
            self._t0 = now
        pressure = min(max(float(pressure), 0.0), 1.0)
        starvation = min(max(float(starvation), 0.0), 1.0)
        self._window.append((now, pressure, starvation))
        while self._window and now - self._window[0][0] > a.sustain_sec * 1.5:
            self._window.popleft()

        if self._plan:
            # a scripted drill: the entries fire in order at their offsets,
            # past the thresholds and the cooldown (the script is the policy)
            if self._plan_fired < len(self._plan):
                d, t_off = self._plan[self._plan_fired]
                if now - self._t0 >= t_off:
                    self._plan_fired += 1
                    return self._decide(d, "plan", now, {
                        "plan_entry": f"{d}@{t_off:g}",
                        "pressure_last": pressure,
                        "starvation_last": starvation,
                        **({"gauges": gauges} if gauges else {}),
                    })
            return None

        if self._last is not None and now - self._last.t < a.cooldown_sec:
            return None
        if not self._window or now - self._window[0][0] < a.sustain_sec:
            return None  # the window does not span the sustain bound yet
        ps = [p for _, p, _ in self._window]
        ss = [s for _, _, s in self._window]
        evidence = {
            "window_sec": round(now - self._window[0][0], 3),
            "samples": len(self._window),
            "pressure": {"min": round(min(ps), 4), "mean": round(sum(ps) / len(ps), 4),
                         "last": round(pressure, 4), "threshold": a.out_threshold},
            "starvation": {"min": round(min(ss), 4), "mean": round(sum(ss) / len(ss), 4),
                           "last": round(starvation, 4), "threshold": a.in_threshold},
            **({"gauges": gauges} if gauges else {}),
        }
        if min(ps) >= a.out_threshold:
            return self._decide("out", "backpressure", now, evidence)
        if min(ss) >= a.in_threshold:
            return self._decide("in", "starvation", now, evidence)
        return None

    def applied(self, dec: ScaleDecision, *, now: float) -> None:
        """Note that the actuation completed (its time to effect)."""
        dec.evidence["time_to_effect_sec"] = round(now - dec.t, 3)

    def summary(self) -> dict:
        """The totals block ({} when nothing ever happened)."""
        if not self.decisions and not self.suppressed_budget:
            return {}
        return {
            "world": self.world,
            "decisions": [d.to_dict() for d in self.decisions],
            "scale_out": sum(1 for d in self.decisions if d.direction == "out"),
            "scale_in": sum(1 for d in self.decisions if d.direction == "in"),
            "flaps": self.flaps,
            "budget_left": self.budget_left,
            "observe_only": self.observe_only,
            **({"suppressed_by_budget": self.suppressed_budget}
               if self.suppressed_budget else {}),
        }


# ---------------------------------------------------------------------------
# Metrics-stream adapters: the JSONL the metrics plane writes (and external
# scrapers read) is the policy's one source of truth
# ---------------------------------------------------------------------------


class MetricsTail:
    """Incremental reader of a metrics JSONL file another process writes.

    A file that does not exist yet (the worker has not armed its metrics
    plane) reads as nothing; bytes after the last newline (a torn line, a
    writer killed mid-write) wait until the line is whole; a line that is
    not a JSON object is skipped.
    """

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._buf = b""

    def poll(self) -> list[dict]:
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                chunk = f.read()
        except OSError:
            return []
        self._pos += len(chunk)
        self._buf += chunk
        recs: list[dict] = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                break
            line, self._buf = self._buf[:nl], self._buf[nl + 1:]
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn or foreign: skip it and tail on
            if isinstance(rec, dict):
                recs.append(rec)
        return recs


def ingest_signals(prev: dict | None, rec: dict) -> tuple[float, float] | None:
    """(pressure, starvation) from two metrics snapshots.

    The ingest sampler exports *cumulative* backpressure and starvation
    seconds; the signals are their rate over the snapshot interval, the
    share of recent wall time the pipeline was device-bound and
    input-bound, each clamped to [0, 1].  None when the pair cannot be
    differentiated (no earlier snapshot, no ingest gauge, a clock that did
    not move forward).
    """
    if prev is None:
        return None
    ing, ping = rec.get("ingest"), prev.get("ingest")
    if not isinstance(ing, dict) or not isinstance(ping, dict):
        return None
    try:
        dt = float(rec["t"]) - float(prev["t"])
        if dt <= 0:
            return None
        dp = float(ing["backpressure_sec"]) - float(ping["backpressure_sec"])
        ds = float(ing["starved_sec"]) - float(ping["starved_sec"])
    except (KeyError, TypeError, ValueError):
        return None

    def clamp(v: float) -> float:
        return min(max(v / dt, 0.0), 1.0)

    return clamp(dp), clamp(ds)


def _prom_name(prefix: str, key) -> str:
    return prefix + "".join(c if c.isalnum() else "_" for c in str(key))


def _prom_value(v) -> str | None:
    """A gauge's exposition text: booleans as 0/1, non-numbers None."""
    if isinstance(v, bool):
        v = int(v)
    if not isinstance(v, (int, float)):
        return None
    return f"{v:g}" if isinstance(v, float) else f"{v}"


def render_prom(gauges: dict, *, prefix: str = "ra_") -> str:
    """Prometheus text exposition of a flat gauge dict: the gauges the
    policy reads, so a scraper and the autoscaler see the same numbers.
    Non-numeric values are left out; booleans export as 0/1."""
    lines: list[str] = []
    for key in sorted(gauges):
        body = _prom_value(gauges[key])
        if body is None:
            continue
        name = _prom_name(prefix, key)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {body}")
    return "\n".join(lines) + "\n"


def render_prom_labeled(per_label: dict[str, dict], *, prefix: str = "ra_",
                        label: str = "tenant") -> str:
    """:func:`render_prom` for per-label gauge families: ``per_label`` maps
    one label value to its flat gauge dict, and each gauge key becomes ONE
    metric family with a ``{label="value"}`` series a value, so a scraper
    sums or compares them without parsing metric names."""
    families: dict[str, list[str]] = {}
    for value in sorted(per_label):
        for key in sorted(per_label[value]):
            body = _prom_value(per_label[value][key])
            if body is None:
                continue
            name = _prom_name(prefix, key)
            families.setdefault(name, []).append(f'{name}{{{label}="{value}"}} {body}')
    lines: list[str] = []
    for name in sorted(families):
        lines.append(f"# TYPE {name} gauge")
        lines.extend(families[name])
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Elastic actuation: the leader supervisor's controller, one a generation
# ---------------------------------------------------------------------------


class AutoscaleController(threading.Thread):
    """Tails the rank-0 worker's metrics shard; publishes ONE scale request.

    The elastic leader starts one after spawning a generation's worker and
    stops it when the generation ends.  Every decision goes to ``log``
    (the run's ``scale-log.jsonl``); an actuated one also to ``publish``,
    which writes ``scale.json``, and every supervisor then retires its
    worker: the planned scale event.  One request a controller: the
    re-formation it causes replaces this generation and this controller.
    """

    def __init__(self, acfg: AutoscaleConfig, *, world: int, ladder: list[int],
                 metrics_path: str, publish, budget_left: int,
                 cooldown_anchor: float | None = None, log=None):
        super().__init__(daemon=True, name="ra-autoscale")
        self.engine = PolicyEngine(acfg, world=world, ladder=ladder)
        # the budget and the cooldown carry across generations (each has a
        # controller of its own): the supervisor passes what is left
        self.engine.budget_left = (0 if self.engine.observe_only
                                   else max(0, min(self.engine.budget_left, budget_left)))
        self._cooldown_anchor = cooldown_anchor
        self.acfg = acfg
        self._tail = MetricsTail(metrics_path)
        self._publish = publish  # callable(ScaleDecision): actuated decisions
        self._log = log  # callable(ScaleDecision): every decision
        # not named _stop: Thread.join() calls its own _stop()
        self._halt = threading.Event()
        self.decision: ScaleDecision | None = None
        self.error: BaseException | None = None

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:  # the supervisor's watch loop raises it
            self.error = e

    def _run(self) -> None:
        a = self.acfg
        prev: dict | None = None
        # differentiate over at least this stride: the ingest counters move
        # in whole-batch steps (a blocked put books its whole wait at once),
        # so fine snapshots alternate between 0 and fractions above 1 and
        # the window's minimum would never cross a threshold
        smooth = max(a.poll_sec, 1.0)
        if self._cooldown_anchor is not None:
            # a request the PREVIOUS generation's controller published still
            # paces this one
            self.engine._last = ScaleDecision(
                seq=0, direction="", from_world=self.engine.world,
                to_world=self.engine.world, reason="carryover", t=self._cooldown_anchor,
                actuate=False, evidence={})
        while not self._halt.wait(min(a.poll_sec, 0.2)):
            now = time.monotonic()
            dec = None
            if self.engine._plan:
                # a scripted drill paces on this clock, snapshots or none
                dec = self.engine.observe(now=now, pressure=0.0, starvation=0.0)
            for rec in self._tail.poll():
                if dec is not None:
                    break
                if rec.get("kind") not in ("snapshot", "final"):
                    continue
                if prev is not None and float(rec.get("t", 0)) - float(prev.get("t", 0)) < smooth:
                    continue  # keep the anchor until a whole stride passed
                sig = ingest_signals(prev, rec)
                prev = rec
                if sig is None:
                    continue
                pressure, starvation = sig
                dec = self.engine.observe(now=now, pressure=pressure, starvation=starvation,
                                          gauges={
                                              "lines": rec.get("lines"),
                                              "lines_per_sec_inst": rec.get("lines_per_sec_inst"),
                                              "queue_depth": (rec.get("ingest") or {}).get(
                                                  "queue_depth"),
                                          })
            if dec is not None:
                if self._log is not None:
                    # EVERY decision lands in the decision log: observe-only
                    # exists to produce this evidence without acting
                    self._log(dec)
                if dec.actuate:
                    self.decision = dec
                    self._publish(dec)
                    return  # the generation is about to be retired


def flap_count(decisions: list[dict], *, cooldown_sec: float, sustain_sec: float) -> int:
    """Flaps in a decision log: direction reversals within the damping window
    ``2 * (cooldown_sec + sustain_sec)``, on the wall-clock ``t_wall``
    stamps, so the count spans generations and processes (the engine's own
    counter cannot see a reversal across a re-formation)."""
    window = 2 * (cooldown_sec + sustain_sec)
    flaps = 0
    prev: dict | None = None
    for d in decisions:
        if prev is not None and d.get("direction") != prev.get("direction"):
            t0, t1 = prev.get("t_wall"), d.get("t_wall")
            if isinstance(t0, (int, float)) and isinstance(t1, (int, float)) and t1 - t0 < window:
                flaps += 1
        prev = d
    return flaps


def append_decision_log(path: str, dec: ScaleDecision, **extra) -> None:
    """Append one decision to the run's ``scale-log.jsonl``."""
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps({**dec.to_dict(), **extra}, separators=(",", ":")) + "\n")


def read_decision_log(path: str) -> list[dict]:
    """The log's records; a torn tail line and a missing file read as none."""
    out: list[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn tail
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return out
    return out
