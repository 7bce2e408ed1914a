"""Deterministic fault injection: plans, sites and the ``fire`` seam.

The port's copy of the reference's ``runtime/faults.py``.  A
:class:`FaultPlan` maps registered sites (:data:`SITES`, every name the
reference registers, so a plan the reference parses parses the same
here) to :class:`FaultSpec`\\ s: fire on the Nth hit of a site, or on
hits N..N+k-1 in the transient form ``site@N:k``.  Plans serialize as
``"site@N,site@N:k,seed=S"``, arm process-wide (:func:`arm`,
:func:`armed`, :func:`arm_spec`) or from the ``RA_FAULT_PLAN``
environment variable, which :func:`arm` exports so that spawned children
inherit the schedule.  :meth:`FaultPlan.random` derives a schedule from a
seed.

Each site is one :func:`fire` call, a no-op unless a plan is armed.  The
port wires the static analysis's ``analyze.tile``, every site of the run
path (the host-to-device copy ``stream.device_put.fail``, the prefetch
producer, the coalescer, checkpoint writes, wire reads and damaged wire
blocks, the feed workers), the elastic tier's two: a supervisor's
heartbeat (``elastic.heartbeat.drop``, runtime/elastic.py) and a
generation worker's death after a batch (``elastic.worker.die``, the
stream's shard-cursor source), and the autoscaler's two: a decision
leaving the policy engine (``autoscale.decide``, runtime/autoscale.py)
and a supervisor between retiring its worker for a scale event and the
next formation (``autoscale.spawn``, runtime/elastic.py).  A firing is a ``fault.<site>`` instant on
the trace (runtime/obs.py) and in the flight recorder's ring; a
``crash`` dumps the ring before the process dies
(runtime/flightrec.py).  ``devprof.capture`` fires at a capture window's
start and stop (runtime/devprof.py), ``lineage.append`` before a lineage
ledger record is written (runtime/wal.py ``LineageLog.append``).  The
listener tier fires ``listener.drop``, ``listener.stall``,
``listener.bind.fail`` and ``listener.accept.fail``
(hostside/listener.py), and serve ``reload.midbatch`` and
``serve.publish.fail`` (runtime/serve.py); ``metrics.snapshot.fail``
fires in the metrics plane (runtime/obs.py).  The tenancy, lease,
distributed-serve and epoch-store sites wait for those modules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time

from ..errors import AnalysisError, InjectedFault

#: Environment variable carrying the armed plan spec to child processes.
ENV_VAR = "RA_FAULT_PLAN"

#: Default bound on "a pipeline stage made no progress" before the
#: watchdog escalates to StallError.  Generous: a legitimately slow
#: stage (cold NFS, giant descriptor) only has to advance once per
#: window, not finish.
_DEFAULT_STALL_SEC = 300.0

#: Hard cap on an injected stall that nobody releases (the watchdog
#: should fire long before; this only guarantees a daemon thread in a
#: crashing process cannot spin forever).
_STALL_CAP_SEC = 600.0

#: Registered fault sites: name -> (action, description).  The action is
#: intrinsic to the site (each site simulates one concrete failure);
#: plans choose WHICH sites fire and on which hit, not what they do.
#:
#:   raise   raise InjectedFault at the site
#:   stall   stop advancing (released by disarm / the caller's stop
#:           event); the stage's watchdog must escalate to StallError
#:   crash   os._exit — abrupt process death, no teardown (OOM-kill /
#:           node-death analog; the exit code is site-specific)
#:   torn    truncate the file the site just wrote, then raise — a
#:           crash mid-save with a partial write on disk
#:   corrupt return a damaged copy of the site's payload (the caller
#:           supplies the site-specific corruptor)
SITES: dict[str, tuple[str, str]] = {
    "feeder.worker.crash": (
        "crash", "a parse feed worker process dies abruptly (OOM-kill analog)"),
    "feeder.worker.stall": (
        "stall", "a feed worker wedges mid-parse and stops completing batches"),
    "feeder.ring.stall": (
        "stall", "a per-chip ring producer wedges before filling its "
        "slot; the ring runs dry and the coordinator's watchdog must "
        "bound the starved chip to a typed abort, never a hang"),
    "ingest.producer.raise": (
        "raise", "the prefetch producer thread fails mid-batch"),
    "ingest.queue.stall": (
        "stall", "the prefetch producer wedges; the bounded queue runs dry"),
    "ingest.coalesce.fail": (
        "raise", "the flow-coalescing compactor fails mid-batch (host "
        "OOM / native-library fault analog); a half-built weighted batch "
        "must never reach the device"),
    "checkpoint.torn_state": (
        "torn", "crash mid-save after a partial register-file write"),
    "checkpoint.torn_manifest": (
        "torn", "crash mid-save after a partial manifest write"),
    "elastic.heartbeat.drop": (
        "stall", "a member's rendezvous heartbeat stops (partition/freeze)"),
    "elastic.worker.die": (
        "crash", "an elastic analysis worker dies mid-collective (node death)"),
    "stream.wire.corrupt": (
        "corrupt", "a wire-format block arrives bit-flipped from storage"),
    "stream.device_put.fail": (
        "raise", "host->device transfer fails (XLA runtime error analog)"),
    "listener.drop": (
        "corrupt", "the serve listener tier loses one received line "
        "(kernel buffer overrun analog); MUST surface as an explicit "
        "drop count + WindowIncomplete marker, never a silent zero-hit "
        "window"),
    "listener.stall": (
        "stall", "a serve listener thread wedges mid-receive and stops "
        "delivering lines (frozen relay/socket analog)"),
    "reload.midbatch": (
        "raise", "a live ruleset reload fails mid-swap; the old rule "
        "tensor and counters must stay intact (atomic reload)"),
    "tenancy.reload.restack": (
        "raise", "a tenant bucket restack (stack-depth rung growth at "
        "install/reload) fails mid-copy; the old stacks and every other "
        "tenant's live registers must stay intact"),
    "autoscale.decide": (
        "raise", "the autoscale policy engine fails at the moment a "
        "scale decision is issued (decide->actuate seam); the run must "
        "abort typed or keep serving at the old world, never actuate a "
        "half-issued scale event"),
    "autoscale.spawn": (
        "raise", "actuating a scale event fails (worker spawn / mesh "
        "re-formation error analog); registers and in-flight batches "
        "must survive intact — typed abort or bit-identical report"),
    "analyze.tile": (
        "raise", "a static-analysis pair tile fails mid-grid "
        "(runtime/staticanalysis.py); the analysis must abort typed — a "
        "partial verdict table must NEVER be published as complete, and "
        "a serve reload's re-analysis failing must leave the previous "
        "complete verdict set serving"),
    "devprof.capture": (
        "raise", "the in-process jax.profiler capture window fails at "
        "its start or stop seam (runtime/devprof.py); the run must end "
        "in a typed abort or complete as a clean no-trace run with a "
        "bit-identical report — never a hang, a half-written "
        "devprof.json, or a corrupted report"),
    "stream.wire.read.fail": (
        "raise", "wire-file / convert-manifest open or header read IO "
        "fails (cold-NFS hiccup analog); the wire.read retry site "
        "absorbs a transient burst, a persistent failure escalates to "
        "the existing typed feed abort"),
    "listener.bind.fail": (
        "raise", "a serve listener socket bind fails (TIME_WAIT rebind "
        "analog); the listener.bind retry site waits it out with "
        "backoff, persistent failure is the documented clean bind "
        "error"),
    "listener.accept.fail": (
        "raise", "a serve listener's receive loop throws mid-iteration "
        "(socket/driver hiccup analog); the listener.accept retry site "
        "re-enters the loop, exhaustion records the error and marks "
        "the listener dead (windows incomplete, all-dead aborts typed)"),
    "serve.publish.fail": (
        "raise", "serve report publication to disk fails (full/readonly "
        "volume analog); the serve.publish retry site absorbs a "
        "transient burst, exhaustion DEGRADES the publisher subsystem "
        "(/health names it, in-memory endpoints keep serving) instead "
        "of aborting ingest"),
    "metrics.snapshot.fail": (
        "raise", "the metrics snapshotter's periodic tick fails "
        "(unwritable metrics file analog); the tick error is counted "
        "and the ra-metrics thread keeps running — serve marks the "
        "metrics subsystem degraded and recovery re-arms it"),
    "lease.acquire": (
        "raise", "the distributed-serve supervisor lease cannot be "
        "claimed at startup (unwritable lease dir / storage fault "
        "analog); the supervisor must abort typed before spawning any "
        "ingest host, never publish without a fencing term"),
    "lease.renew": (
        "raise", "the lease-holder's heartbeat renewal fails and stays "
        "failed (partition / storage-freeze analog); the holder must "
        "self-fence within the lease TTL — stop publishing BEFORE a "
        "successor can win the lease — so a split brain can never "
        "double-publish one window id"),
    "dist.epoch.spool": (
        "raise", "a host's durable epoch-spool append fails (full / "
        "readonly volume analog); the host marks the spool subsystem "
        "degraded and keeps ingesting+shipping — losing durability is "
        "visible /health evidence, never a silent service stop"),
    "dist.epoch.ship": (
        "raise", "shipping a window epoch to the merge supervisor "
        "fails (severed host-tier connection / partition analog); the "
        "dist.epoch.ship retry site absorbs a transient burst, "
        "exhaustion parks the epoch in the partition backlog (degraded "
        "``partition:<rank>``) for heal-time reconciliation — the "
        "spooled copy survives either way"),
    "lineage.append": (
        "raise", "appending a published window's lineage record to "
        "lineage.jsonl fails (full volume / fd-revoked analog); the "
        "append is a CORE publication step — the serve loop aborts "
        "typed rather than publish a window without provenance, and "
        "the single-write O_APPEND discipline means the log holds only "
        "complete records (a torn final line reads as absent, never as "
        "corruption)"),
    "epochstore.spill": (
        "raise", "spilling a rotated window into the durable epoch "
        "store fails (full / readonly volume analog) BEFORE any bytes "
        "land; serve marks the epoch_store subsystem degraded and keeps "
        "publishing — losing history is visible /health + /lineage "
        "frontier evidence, never a torn store or a silent stop"),
    "epochstore.compact": (
        "crash", "SIGKILL at the worst instant of segment-tree "
        "compaction: after the pair is chosen, before the merged "
        "summary node is appended.  Compaction is append-then-link "
        "(the O_APPEND record IS the link), so the store must reopen "
        "readable with zero lost epochs and repair-at-open must "
        "rebuild the missing summary from its intact children"),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled failure: ``site`` fires on hits ``at..at+count-1``.

    ``count == 1`` is the historical single-shot form; ``count > 1`` is
    the *transient* mode (``site@N:k`` in the plan grammar): the site
    fails k consecutive times and then clears — the shape a retry policy
    must survive, and the shape that proves budget exhaustion when k
    exceeds the site's attempt bound.
    """

    site: str
    at: int = 1
    count: int = 1

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise AnalysisError(
                f"unknown fault site {self.site!r}; registered sites: "
                f"{', '.join(sorted(SITES))}"
            )
        if self.at < 1:
            raise AnalysisError(f"fault hit count must be >= 1, got {self.at}")
        if self.count < 1:
            raise AnalysisError(
                f"fault consecutive-fire count must be >= 1, got {self.count}"
            )

    @property
    def action(self) -> str:
        return SITES[self.site][0]

    def fires_on(self, n: int) -> bool:
        return self.at <= n < self.at + self.count


class FaultPlan:
    """A deterministic failure schedule: {site -> FaultSpec} + seed.

    The seed feeds the ``corrupt`` action's bit-flip choices (and is
    recorded in the serialized form) so an armed plan replays the exact
    same damage every run.
    """

    def __init__(self, specs: dict[str, FaultSpec] | list[FaultSpec], seed: int = 0):
        if isinstance(specs, dict):
            specs = list(specs.values())
        self.specs: dict[str, FaultSpec] = {s.site: s for s in specs}
        self.seed = int(seed)
        #: set on disarm: releases every in-flight injected stall
        self.released = threading.Event()

    # -- serialization --------------------------------------------------
    def to_str(self) -> str:
        parts = [
            f"{s.site}@{s.at}" + (f":{s.count}" if s.count > 1 else "")
            for s in self.specs.values()
        ]
        if self.seed:
            parts.append(f"seed={self.seed}")
        return ",".join(parts)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Inverse of :meth:`to_str` (``"site@N,site@N:k,seed=S"``)."""
        specs: list[FaultSpec] = []
        seed = 0
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                try:
                    seed = int(part[5:])
                except ValueError as e:
                    raise AnalysisError(f"bad fault-plan seed {part!r}") from e
                continue
            site, _, at = part.partition("@")
            at, _, count = at.partition(":")
            try:
                specs.append(FaultSpec(
                    site, int(at) if at else 1, int(count) if count else 1
                ))
            except ValueError as e:
                raise AnalysisError(
                    f"bad fault-plan entry {part!r} (want site@N or site@N:k)"
                ) from e
        if not specs:
            raise AnalysisError(f"fault plan {text!r} names no sites")
        return cls(specs, seed=seed)

    @classmethod
    def random(
        cls,
        seed: int,
        sites: list[str] | None = None,
        n_faults: int = 1,
        max_at: int = 4,
    ) -> "FaultPlan":
        """Seeded schedule: ``n_faults`` distinct sites at random hits.

        Deterministic in ``seed`` — the chaos suites sweep seeds and can
        replay any failing schedule exactly from its number alone.
        """
        rng = random.Random(seed)
        pool = sorted(sites) if sites is not None else sorted(SITES)
        picked = rng.sample(pool, min(n_faults, len(pool)))
        return cls(
            [FaultSpec(s, rng.randint(1, max_at)) for s in picked], seed=seed
        )

    def __repr__(self) -> str:  # readable failures in chaos assertions
        return f"FaultPlan({self.to_str()!r})"


# ---------------------------------------------------------------------------
# Module arming state.  `_plan is None` is the production fast path; the
# env check runs at most once per process so spawned children (which
# inherit RA_FAULT_PLAN) arm themselves lazily on their first site hit.
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_plan: FaultPlan | None = None
_hits: dict[str, int] = {}
_env_checked = False
_env_exported = False


def arm(plan: FaultPlan, *, export_env: bool = True) -> None:
    """Arm ``plan`` process-wide; hit counters reset.

    ``export_env`` also publishes the spec to :data:`ENV_VAR` so worker
    processes spawned while armed inherit the schedule.
    """
    global _plan, _env_checked, _env_exported
    with _lock:
        _plan = plan
        _hits.clear()
        _env_checked = True
        if export_env:
            os.environ[ENV_VAR] = plan.to_str()
            _env_exported = True


def disarm() -> None:
    """Disarm and release any in-flight injected stalls."""
    global _plan, _env_exported
    with _lock:
        if _plan is not None:
            _plan.released.set()
        _plan = None
        _hits.clear()
        if _env_exported:
            os.environ.pop(ENV_VAR, None)
            _env_exported = False


def active_plan() -> FaultPlan | None:
    return _plan


@contextlib.contextmanager
def armed(plan: FaultPlan):
    """``with faults.armed(plan): ...`` — arm for the block, then disarm."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


def arm_spec(spec: str) -> bool:
    """Arm from a serialized spec if not already armed with the same one.

    Idempotent so both the CLI and the drivers may call it with the same
    ``AnalysisConfig.fault_plan`` without resetting hit counters mid-run.
    Returns True when THIS call armed the plan — the caller then owns
    disarming it at run end, so an armed schedule (and its RA_FAULT_PLAN
    export) never leaks into a later run in the same process.  An empty
    spec never disarms ambient arming (the chaos harness arms around the
    driver call with config untouched).
    """
    if not spec:
        return False
    cur = _plan
    if cur is not None and cur.to_str() == FaultPlan.parse(spec).to_str():
        return False
    arm(FaultPlan.parse(spec))
    return True


def default_stall_timeout() -> float:
    """Watchdog bound on a stage making no progress (RA_STALL_TIMEOUT)."""
    try:
        t = float(os.environ.get("RA_STALL_TIMEOUT", _DEFAULT_STALL_SEC))
    except ValueError:
        t = _DEFAULT_STALL_SEC
    return t if t > 0 else _DEFAULT_STALL_SEC


def _check_env() -> FaultPlan | None:
    """One-time lazy arm from the environment (spawned children)."""
    global _env_checked
    with _lock:
        if _env_checked:
            return _plan
        _env_checked = True
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        # don't re-export: the var is already in our (inherited) env
        arm(FaultPlan.parse(spec), export_env=False)
    return _plan


def _stall(plan: FaultPlan, stop: threading.Event | None) -> None:
    """Stop advancing until released (disarm) or the caller's stop event.

    Polling two events beats wedging on one: the injecting test releases
    via disarm, a shutting-down stage releases via its own stop signal,
    and the absolute cap guarantees a daemon thread can never spin past
    process teardown.
    """
    deadline = time.monotonic() + _STALL_CAP_SEC
    while time.monotonic() < deadline:
        if plan.released.is_set():
            return
        if stop is not None and stop.is_set():
            return
        time.sleep(0.05)


def fire(
    site: str,
    *,
    stop: threading.Event | None = None,
    payload=None,
    path: str | None = None,
    corrupt=None,
    crash_rc: int = 1,
):
    """The fault point: no-op (returning ``payload``) unless armed.

    Callers thread site-specific context: ``stop`` lets an injected
    stall release when the stage shuts down, ``path`` is the file a
    ``torn`` site truncates, ``corrupt`` is the payload-damaging
    callback a ``corrupt`` site applies (seeded rng supplied), and
    ``crash_rc`` is the exit code of a ``crash`` site.
    """
    plan = _plan
    if plan is None:
        if _env_checked:
            return payload
        plan = _check_env()
        if plan is None:
            return payload
    spec = plan.specs.get(site)
    if spec is None:
        return payload
    with _lock:
        _hits[site] = n = _hits.get(site, 0) + 1
    if not spec.fires_on(n):
        return payload
    action = spec.action
    # mark the firing on the trace timeline BEFORE acting: the per-event
    # flush means even a `crash` (os._exit) or `torn` site leaves its
    # instant in this process's shard
    from . import obs

    obs.instant(f"fault.{site}", args={"action": action, "hit": n})
    if action == "raise":
        raise InjectedFault(f"injected fault: {site} (hit {n})")
    if action == "stall":
        _stall(plan, stop)
        # the stall was released (watchdog fired / stage shut down /
        # plan disarmed): terminate this stage's work item loudly so it
        # cannot resume half-done
        raise InjectedFault(f"injected stall released: {site} (hit {n})")
    if action == "crash":
        # the flight recorder's last chance: os._exit skips every
        # excepthook and finally, so the ring (which holds the instant
        # above) dumps here or never
        from . import flightrec

        flightrec.dump("crash", error=f"injected crash: {site} (hit {n})")
        os._exit(crash_rc)
    if action == "torn":
        if path is not None:
            try:
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(1, size // 2))
            except OSError:
                pass  # the raise below still simulates the crash
        raise InjectedFault(f"injected torn write: {site} ({path})")
    if action == "corrupt":
        if corrupt is None or payload is None:
            raise InjectedFault(f"injected corruption: {site} (hit {n})")
        rng = random.Random((plan.seed << 16) ^ (n * 2654435761))
        return corrupt(payload, rng)
    raise AnalysisError(f"fault site {site} has unknown action {action!r}")
