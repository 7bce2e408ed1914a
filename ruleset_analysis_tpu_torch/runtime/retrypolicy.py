"""Typed retry/backoff engine: the transient-fault survival tier.

The port's copy of the reference's ``runtime/retrypolicy.py``.  A typed
abort is an outage, and most of the faults behind one are *transient*: a
failed host-to-device copy, a torn checkpoint write, a wire read that
hit a storage hiccup.  This module is the one place retry behaviour
lives:

- **Sites.**  :data:`RETRY_SITES` registers every seam the runtime wraps
  with :func:`call`, all seven of the reference's, so a ``--retry-policy``
  spec the reference parses parses the same here.  Each names the
  ``faults.py`` site whose ``site@N:k`` schedules exercise it.  The run
  path wraps three: ``device_put`` (parallel/mesh.py, runtime/ingest.py),
  ``checkpoint.save`` and ``wire.read``; the listener, serve and
  distributed-serve seams come with those modules.

- **Policies.**  A :class:`RetryPolicy` bounds each site: attempts per
  call, exponential backoff with a cap, and a per-site per-run retry
  *budget*.  Overrides arm from ``AnalysisConfig.retry_policy``
  (``run --retry-policy "site=attempts/base_sec,...,seed=S"``; ``"off"``
  collapses every site to a single attempt).

- **Determinism.**  Backoff jitter derives from
  ``crc32(seed | site | attempt)``, not a process RNG, so the same seed
  gives the same delays in every process (:func:`backoff_schedule`).

- **Classification.**  Only faults ``errors.is_transient`` accepts are
  retried; every other error, and the last transient one once the
  attempts or the budget run out, re-raises unchanged, so an exhausted
  budget ends in the typed abort the run gave without retries.

- **Observability.**  Every retry emits a ``retry.attempt`` trace instant
  (before the sleep), recoveries and giveups their own, and
  :func:`counters` / :func:`gauges` report per-site totals.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib

from ..errors import AnalysisError, is_transient


@dataclasses.dataclass(frozen=True)
class RetrySite:
    """One registered retryable seam."""

    #: the runtime/faults.py site whose ``site@N:k`` transient schedules
    #: exercise this seam
    fault_site: str
    description: str


#: Registered retry sites, the reference's seven (descriptions its own).
RETRY_SITES: dict[str, RetrySite] = {
    "device_put": RetrySite(
        "stream.device_put.fail",
        "host->device transfer (mesh.shard_batch/shard_grouped/"
        "shard_ring_batch, ingest.views_to_device); a transient fault or "
        "an allocation that ran out of device memory must not kill a run "
        "holding hours of register state",
    ),
    "checkpoint.save": RetrySite(
        "checkpoint.torn_state",
        "the checkpoint write+fsync phase (state npz + manifest into the "
        "tmp dir); absorbs the former ad-hoc snap-name collision loop so "
        "its attempts are one configurable, observable knob",
    ),
    "wire.read": RetrySite(
        "stream.wire.read.fail",
        "wire-file and convert-manifest open/header read IO; a cold-NFS "
        "hiccup at open time must not abort a resumable run",
    ),
    "listener.bind": RetrySite(
        "listener.bind.fail",
        "serve listener socket bind (TIME_WAIT rebind after a restart is "
        "the canonical transient)",
    ),
    "listener.accept": RetrySite(
        "listener.accept.fail",
        "a serve listener's receive loop; a transient socket fault "
        "re-enters the loop instead of killing the listener (a dead "
        "listener marks every overlapping window incomplete)",
    ),
    "serve.publish": RetrySite(
        "serve.publish.fail",
        "serve report publication to disk; exhaustion degrades the "
        "publisher subsystem (in-memory endpoints keep serving) rather "
        "than aborting ingest",
    ),
    "dist.epoch.ship": RetrySite(
        "dist.epoch.ship",
        "shipping a window epoch from an ingest host to the merge "
        "supervisor; a transient socket fault retries in place, "
        "exhaustion enters partition mode (the epoch waits in the "
        "backlog, the durable spool already holds it) instead of "
        "killing the host's ingest tier",
    ),
}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounds for one site: attempts per call, backoff, per-run budget."""

    attempts: int = 5  # total tries per call (1 = no retry)
    base_sec: float = 0.1  # first backoff delay
    mult: float = 2.0  # exponential growth per retry
    cap_sec: float = 2.0  # ceiling on any single delay
    budget: int = 64  # retries allowed per site per run (across calls)

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise AnalysisError(f"retry attempts must be >= 1, got {self.attempts}")
        if self.base_sec < 0 or self.cap_sec < 0 or self.mult < 1.0:
            raise AnalysisError(
                "retry backoff needs base_sec/cap_sec >= 0 and mult >= 1"
            )
        if self.budget < 0:
            raise AnalysisError(f"retry budget must be >= 0, got {self.budget}")


#: Default policy table.  Per-site deviations are deliberate: the bind
#: seam waits out TIME_WAIT (longer base), the device seam spins fast
#: (the transfer either clears in milliseconds or the runtime is gone).
DEFAULT_POLICIES: dict[str, RetryPolicy] = {
    "device_put": RetryPolicy(attempts=5, base_sec=0.05, cap_sec=1.0),
    "checkpoint.save": RetryPolicy(attempts=5, base_sec=0.1, cap_sec=2.0),
    "wire.read": RetryPolicy(attempts=4, base_sec=0.1, cap_sec=2.0),
    "listener.bind": RetryPolicy(attempts=6, base_sec=0.2, cap_sec=2.0),
    "listener.accept": RetryPolicy(attempts=5, base_sec=0.1, cap_sec=2.0),
    "serve.publish": RetryPolicy(attempts=4, base_sec=0.05, cap_sec=1.0),
    # the ship seam spins fast and gives up early: the durable spool
    # already holds the epoch, so a persistent failure should enter
    # partition mode (heal-time reconciliation) quickly, not block the
    # host's serve loop through a long backoff ladder
    "dist.epoch.ship": RetryPolicy(attempts=4, base_sec=0.05, cap_sec=0.5),
}

assert set(DEFAULT_POLICIES) == set(RETRY_SITES)


class _SiteCounters:
    __slots__ = ("attempts", "recoveries", "giveups", "budget_spent")

    def __init__(self):
        self.attempts = 0  # retries issued (first tries are not counted)
        self.recoveries = 0  # calls that succeeded after >= 1 retry
        self.giveups = 0  # calls that escalated (exhausted or permanent)
        self.budget_spent = 0  # retries charged against the per-run budget


_lock = threading.Lock()
_policies: dict[str, RetryPolicy] = dict(DEFAULT_POLICIES)
_seed = 0
_counters: dict[str, _SiteCounters] = {}

#: Environment override for bare library calls (the CLI's or the run's spec via
#: ``AnalysisConfig.retry_policy`` wins when both are set).
ENV_VAR = "RA_RETRY_POLICY"
_env_checked = False


def parse_spec(spec: str) -> tuple[dict[str, RetryPolicy], int]:
    """``"site=attempts/base,...,seed=S"`` | ``"off"`` -> (overrides, seed).

    ``off`` maps every site to a single attempt (retries disabled; the
    bench's disarmed-overhead A/B and incident triage both use it).
    ``site=attempts`` keeps the site's default backoff; ``/base_sec``
    overrides the first delay too.
    """
    overrides: dict[str, RetryPolicy] = {}
    seed = 0
    if spec.strip() == "off":
        return (
            {s: dataclasses.replace(p, attempts=1)
             for s, p in DEFAULT_POLICIES.items()},
            0,
        )
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if part.startswith("seed="):
            try:
                seed = int(part[5:])
            except ValueError as e:
                raise AnalysisError(f"bad retry-policy seed {part!r}") from e
            continue
        site, eq, rest = part.partition("=")
        if not eq or site not in RETRY_SITES:
            raise AnalysisError(
                f"bad retry-policy entry {part!r}; registered sites: "
                f"{', '.join(sorted(RETRY_SITES))} (want "
                "site=attempts[/base_sec] or seed=S or 'off')"
            )
        attempts_s, slash, base_s = rest.partition("/")
        try:
            attempts = int(attempts_s)
            base = float(base_s) if slash else DEFAULT_POLICIES[site].base_sec
        except ValueError as e:
            raise AnalysisError(
                f"bad retry-policy entry {part!r} (want site=attempts[/base_sec])"
            ) from e
        overrides[site] = dataclasses.replace(
            DEFAULT_POLICIES[site], attempts=attempts, base_sec=base
        )
    return overrides, seed


def configure(spec: str = "") -> None:
    """Arm the policy table for this run; counters reset.

    Idempotent per spec string so drivers may call it unconditionally at
    run start (the ``faults.arm_spec`` discipline).  An empty spec means
    the defaults plus any :data:`ENV_VAR` override.
    """
    global _policies, _seed, _env_checked
    if not spec:
        spec = os.environ.get(ENV_VAR, "")
    overrides, seed = parse_spec(spec) if spec else ({}, 0)
    with _lock:
        _policies = {**DEFAULT_POLICIES, **overrides}
        _seed = seed
        _counters.clear()
        _env_checked = True
    # the reference registers `counters` as the "retry" metrics sampler
    # here; the metrics plane is not ported yet (ROADMAP A3)


def policy(site: str) -> RetryPolicy:
    try:
        return _policies[site]
    except KeyError:
        raise AnalysisError(
            f"unregistered retry site {site!r}; registered: "
            f"{', '.join(sorted(RETRY_SITES))}"
        ) from None


def _jitter_frac(seed: int, site: str, attempt: int) -> float:
    """Deterministic jitter in [0, 1): crc32 of (seed, site, attempt).

    zlib.crc32, not hash(): identical across processes regardless of
    PYTHONHASHSEED — the property test spawns an interpreter to prove it.
    """
    return zlib.crc32(f"{seed}|{site}|{attempt}".encode()) / 2**32


def backoff_delay(site: str, attempt: int, seed: int | None = None) -> float:
    """Delay before retry ``attempt`` (1-based) at ``site``, in seconds.

    ``min(cap, base * mult**(attempt-1)) * (0.5 + jitter)`` — full
    exponential shape, +/-50% deterministic spread so a fleet of
    retriers with distinct seeds never thunders in phase.
    """
    pol = policy(site)
    s = _seed if seed is None else seed
    raw = min(pol.cap_sec, pol.base_sec * pol.mult ** (attempt - 1))
    return raw * (0.5 + _jitter_frac(s, site, attempt))


def backoff_schedule(site: str, n: int, seed: int = 0) -> list[float]:
    """The first ``n`` delays for ``site`` under ``seed`` (pure; tests)."""
    return [round(backoff_delay(site, a, seed), 9) for a in range(1, n + 1)]


def _site_counters(site: str) -> _SiteCounters:
    c = _counters.get(site)
    if c is None:
        with _lock:
            c = _counters.setdefault(site, _SiteCounters())
    return c


def _sleep(delay: float, stop: threading.Event | None) -> None:
    if stop is not None:
        stop.wait(delay)
    elif delay > 0:
        time.sleep(delay)


def call(site: str, fn, *, stop: threading.Event | None = None):
    """Run ``fn()`` under ``site``'s policy; the one retry entry point.

    Transient failures (errors.is_transient) retry with seeded backoff
    until the per-call attempt bound or the per-run site budget runs
    out; the final failure — and every permanent one — re-raises the
    ORIGINAL exception, so exhausted budgets escalate to exactly the
    typed aborts the chaos invariant already covers.  ``stop`` makes the
    backoff sleep responsive to a shutting-down stage.
    """
    pol = policy(site)
    ctr = _site_counters(site)
    attempt = 1
    while True:
        try:
            out = fn()
        except BaseException as e:
            retryable = (
                is_transient(e)
                and attempt < pol.attempts
                and ctr.budget_spent < pol.budget
                and not (stop is not None and stop.is_set())
            )
            if not retryable:
                with _lock:
                    ctr.giveups += 1
                from . import obs

                obs.instant("retry.giveup", args={
                    "site": site, "attempt": attempt,
                    "error": type(e).__name__,
                    "transient": is_transient(e),
                })
                raise
            delay = backoff_delay(site, attempt)
            with _lock:
                ctr.attempts += 1
                ctr.budget_spent += 1
            from . import obs

            # flushed BEFORE the sleep: a crash mid-backoff still shows
            # the retry decision on the merged timeline
            obs.instant("retry.attempt", args={
                "site": site, "attempt": attempt,
                "delay_sec": round(delay, 4), "error": type(e).__name__,
            })
            _sleep(delay, stop)
            attempt += 1
            continue
        if attempt > 1:
            with _lock:
                ctr.recoveries += 1
            from . import obs

            obs.instant("retry.recovered", args={
                "site": site, "attempts": attempt,
            })
        return out


def counters() -> dict:
    """Per-site attempt/recovery/giveup counts (metrics JSONL sampler)."""
    with _lock:
        return {
            site: {
                "attempts": c.attempts,
                "recoveries": c.recoveries,
                "giveups": c.giveups,
            }
            for site, c in sorted(_counters.items())
        }


def gauges(prefix: str = "retry_") -> dict:
    """Flat numeric gauges for serve ``/metrics`` (JSON + prom render)."""
    out: dict[str, int] = {
        f"{prefix}attempts_total": 0,
        f"{prefix}recoveries_total": 0,
        f"{prefix}giveups_total": 0,
    }
    with _lock:
        items = list(_counters.items())
    for site, c in items:
        key = site.replace(".", "_")
        out[f"{prefix}attempts_total"] += c.attempts
        out[f"{prefix}recoveries_total"] += c.recoveries
        out[f"{prefix}giveups_total"] += c.giveups
        out[f"{prefix}{key}_attempts"] = c.attempts
        out[f"{prefix}{key}_recoveries"] = c.recoveries
        out[f"{prefix}{key}_giveups"] = c.giveups
    return out


def _reset_for_tests() -> None:
    global _policies, _seed
    with _lock:
        _policies = dict(DEFAULT_POLICIES)
        _seed = 0
        _counters.clear()
