"""Elastic runs: the job re-forms itself after a peer dies.

The port's copy of the reference's ``runtime/elastic.py``, on
``torch.distributed``:

- each of the job's N launchers runs an :class:`ElasticSupervisor`,
  which keeps a heartbeat file in a shared rendezvous directory and
  spawns the analysis worker as a child process, one per *generation*;
- the distributed loop writes one epoch-tagged, world-size-independent
  checkpoint (the replicated registers and a per-shard cursor manifest)
  into the shared ``epoch/`` directory on the checkpoint cadence
  (``stream.run_stream_file_distributed(elastic=...)``);
- when a peer dies, the survivors detect it (a stale heartbeat for a
  whole-node death, a peer's failure marker for a worker-only death),
  re-elect the lowest surviving tag as coordinator, re-form the process
  group at the surviving world size on a fresh port, and spawn the next
  generation, which re-splits the unread shards round-robin and resumes
  from the epoch checkpoint.

A failed process group is torn down by its worker's exit, never by an
in-process re-initialisation.  The registers are mergeable and
order-invariant, so the per-rule hits and the unused set equal an
uninterrupted run's over the same shards at any surviving world size (the
talker candidates follow the chunk boundaries, as in the feeder tier).

Dead-peer bounds differ from the reference's, which gives jax a 10 s
collective heartbeat and a 60 s formation bound.  torch has one
``timeout`` for the rendezvous and every collective, so a worker takes
the formation bound (the job's ``init_timeout``) for both: 10 s as a
collective bound would fail a generation whose first collective waits on
a peer's cold kernel build.  Under gloo a dead peer's closed socket fails
the survivors' next collective at once; under NCCL it may not, and the
supervisor's watchdog (:data:`STALE_SEC` + :data:`KILL_GRACE_SEC`) is the
bound.

Rendezvous directory (shared filesystem)::

    elastic_dir/
      members/<tag>.hb        heartbeat file (mtime refreshed twice a second)
      members/<tag>.job.json  this member's job spec for its workers
      epoch/                  epoch checkpoints (runtime/checkpoint.py)
      gen-<g>/join/<tag>      generation-g membership markers
      gen-<g>/plan.json       the leader's formation plan
      gen-<g>/failed/<tag>    a member whose worker failed in generation g
      gen-<g>/done/<tag>      a member whose worker finished generation g
      gen-<g>/worker-<t>.log  each worker's stdout and stderr

Every wait has a timeout; spending ``max_reforms`` exits 7
(``errors.EXIT_REFORM_BUDGET``); a member that misses a formation aborts
instead of wedging the others.

Left out until the autoscale item: the ``autoscale`` argument, the
leader's scale requests (the reference's ``_target_world``),
``_standby_wait``, ``_start_controller``, ``SCALE_RC`` with the
``autoscale.spawn`` site, and the ``totals.autoscale`` half of
``_patch_result`` with the ``final_world`` it reads.  The reference's ``enable_persistent_cache`` call is
dropped: the nvcc builds in ``build/kernels/`` play that part, so a new
generation loads its kernel libraries and builds nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

from ..errors import AnalysisError, EXIT_REFORM_BUDGET, InjectedFault, StallError, exit_code_for
from . import faults, obs
from .metrics import RecoveryMeter

#: seconds between heartbeat-file touches
HB_INTERVAL = 0.5
#: a member whose heartbeat is older than this is presumed dead (15 missed
#: beats: wide enough that a load spike does not read as death)
STALE_SEC = 7.5
#: after a peer is presumed lost, how long a still-running worker gets to
#: fail on its own before the supervisor kills it
KILL_GRACE_SEC = 10.0
#: generation-formation waits (join barrier, plan publication)
FORM_TIMEOUT_SEC = 180.0
#: the bound on forming the process group and on every collective
INIT_TIMEOUT_SEC = 60

#: child exit code that simulates abrupt node death (fault injection: the
#: supervisor re-raises it with os._exit, taking the heartbeat with it)
DIE_RC = 77


class FormationTimeout(StallError):
    """A generation could not form within the rendezvous timeout (the
    watchdog class: exit code 6)."""


class _PrevGenDone(Exception):
    """The previous generation finished while this member headed into the
    next formation (a death signal raced the final worker exits): the run
    is complete."""


# ---------------------------------------------------------------------------
# Cursor manifest and shard re-splitting
# ---------------------------------------------------------------------------


def manifest_of(snap) -> tuple[list[str] | None, dict[int, int], set[int]]:
    """(shards, cursors, done) of an epoch Snapshot (None -> empty)."""
    if snap is None or not snap.extra or "elastic" not in snap.extra:
        return None, {}, set()
    man = snap.extra["elastic"]
    return (
        list(man["shards"]),
        {int(k): int(v) for k, v in man["cursors"].items()},
        {int(i) for i in man["done"]},
    )


def assign_shards(shards: list[str], cursors: dict[int, int], done: set[int],
                  world_size: int) -> list[list[tuple[int, str, int]]]:
    """The unread shards split over ``world_size`` ranks.

    Whole shards are the unit (the input-split analog); a partly read
    shard travels with its cursor, so its new owner resumes mid-file.
    Round-robin over the remaining shards in index order: every worker
    computes the same split from the shared manifest, with no message.
    """
    remaining = [i for i in range(len(shards)) if i not in done]
    out: list[list[tuple[int, str, int]]] = [[] for _ in range(world_size)]
    for pos, idx in enumerate(remaining):
        out[pos % world_size].append((idx, shards[idx], cursors.get(idx, 0)))
    return out


@dataclasses.dataclass
class ElasticRunSpec:
    """What ``stream.run_stream_file_distributed`` needs for one generation."""

    epoch_dir: str
    shards: list[str]  # the GLOBAL ordered shard list (the same everywhere)
    assignments: list[tuple[int, str, int]]  # this rank's (idx, path, start)
    snapshot: object | None  # checkpoint.Snapshot of the epoch, or None
    base_cursors: dict[int, int]  # manifest cursors at epoch load
    base_done: set[int]  # shards fully read before this generation
    epoch: int  # generation tag stamped into new snapshots
    die_after_batches: int | None = None  # fault injection: os._exit after N batches
    pace_sec: float = 0.0  # sleep a batch (drills that need a run to last)


# ---------------------------------------------------------------------------
# Rendezvous helpers
# ---------------------------------------------------------------------------


def _atomic_write_json(path: str, obj) -> None:
    """fsync'd write-then-rename; ``obj`` may be a serialized string."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            if isinstance(obj, str):
                f.write(obj)
            else:
                json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class _Heartbeat(threading.Thread):
    """Touches ``members/<tag>.hb`` until stopped (daemon: dies with us)."""

    def __init__(self, path: str):
        super().__init__(daemon=True, name="ra-heartbeat")
        self._path = path
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                # fault site: this member's heartbeat stops (a partition or
                # a frozen node); the peers must re-form without it, and it
                # must abort when it finds itself outside the next formation
                faults.fire("elastic.heartbeat.drop", stop=self._halt)
            except InjectedFault:
                return  # never touch again: the partition persists
            try:
                with open(self._path, "a"):
                    os.utime(self._path, None)
            except OSError:
                pass
            self._halt.wait(HB_INTERVAL)

    def stop(self) -> None:
        self._halt.set()


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------


class ElasticSupervisor:
    """One launcher's recovery supervisor: heartbeat, re-election, respawn.

    One runs in each of the job's N launcher processes (``run
    --distributed --elastic``).  The analysis runs in a child process a
    generation, so tearing down a failed process group is a child's exit.
    """

    def __init__(self, elastic_dir: str, tag: int, n_procs: int, ruleset_prefix: str,
                 shards: list[str], cfg, *, max_reforms: int = 2, topk: int = 10,
                 native: bool | None = None, out_prefix: str | None = None,
                 fault: dict | None = None, coordinator_host: str | None = None):
        from ..hostside.wire import is_wire_file

        if not 0 <= tag < n_procs:
            raise AnalysisError(f"tag {tag} outside 0..{n_procs - 1}")
        wired = [p for p in shards if is_wire_file(p)]
        if wired:
            raise AnalysisError(
                f"--elastic re-splits text shards; {wired[0]!r} is a "
                ".rawire wire file (convert-tier elastic is not built yet)"
            )
        if cfg.checkpoint_every_chunks < 1:
            raise AnalysisError(
                "--elastic needs an epoch-checkpoint cadence; set "
                "--checkpoint-every N (recovery replays at most N chunks)"
            )
        self.dir = os.path.abspath(elastic_dir)
        self.tag = int(tag)
        self.n_procs = int(n_procs)
        self.max_reforms = int(max_reforms)
        # workers start from the shared epoch dir: the per-process resume
        # must not engage
        self.cfg = dataclasses.replace(cfg, resume=False)
        self.job = {
            "ruleset": os.path.abspath(ruleset_prefix),
            "shards": [os.path.abspath(p) for p in shards],
            "cfg": self.cfg.to_dict(),
            "topk": int(topk),
            "native": native,
            "out": os.path.abspath(out_prefix) if out_prefix else None,
            "init_timeout": INIT_TIMEOUT_SEC,
            "fault": fault,
        }
        self.coordinator_host = coordinator_host or os.environ.get("RA_ELASTIC_HOST",
                                                                   "127.0.0.1")
        self.meter = RecoveryMeter()
        self.reforms_used = 0
        self._hb: _Heartbeat | None = None

    # -- paths ------------------------------------------------------------
    def _members_dir(self) -> str:
        return os.path.join(self.dir, "members")

    def _hb_path(self, tag: int) -> str:
        return os.path.join(self._members_dir(), f"{tag}.hb")

    def _gen_dir(self, gen: int) -> str:
        return os.path.join(self.dir, f"gen-{gen}")

    def _plan_path(self, gen: int) -> str:
        return os.path.join(self._gen_dir(gen), "plan.json")

    @property
    def epoch_dir(self) -> str:
        return os.path.join(self.dir, "epoch")

    # -- membership -------------------------------------------------------
    def _fresh_members(self) -> set[int]:
        now = time.time()
        fresh = set()
        try:
            entries = os.listdir(self._members_dir())
        except OSError:
            return fresh
        for e in entries:
            if not e.endswith(".hb"):
                continue
            try:
                t = int(e[:-3])
                if now - os.path.getmtime(os.path.join(self._members_dir(), e)) < STALE_SEC:
                    fresh.add(t)
            except (ValueError, OSError):
                continue
        return fresh

    def _marker(self, gen: int, kind: str) -> None:
        """``gen-<g>/<kind>/<tag>``: join, done or failed."""
        d = os.path.join(self._gen_dir(gen), kind)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, str(self.tag)), "w") as f:
            f.write(str(os.getpid()) if kind == "join" else "")

    def _markers(self, gen: int, kind: str) -> set[int]:
        try:
            return {int(e) for e in os.listdir(os.path.join(self._gen_dir(gen), kind))
                    if e.isdigit()}
        except OSError:
            return set()

    def _peer_failed(self, gen: int) -> bool:
        return bool(self._markers(gen, "failed") - {self.tag})

    # -- formation --------------------------------------------------------
    def _form(self, gen: int) -> dict:
        """Join the generation-``gen`` barrier; return the agreed plan.

        Membership rule: wait until every member with a FRESH heartbeat
        has joined this generation.  A slow-failing survivor keeps its
        heartbeat fresh, so the barrier waits for it; a dead member's goes
        stale and it drops out.  Generation 0 waits for the whole
        launch-time membership (processes may still be starting).  The
        lowest surviving tag leads: it takes a coordinator port and
        publishes the plan; the others poll for it.
        """
        t_form0 = time.perf_counter()
        self._marker(gen, "join")
        deadline = time.monotonic() + FORM_TIMEOUT_SEC
        plan_path = self._plan_path(gen)
        while True:
            if os.path.exists(plan_path):
                break  # someone published the plan already
            if gen > 0 and self._markers(gen - 1, "done"):
                # the previous generation completed while a death signal
                # sent us here: nobody will ever form this one
                raise _PrevGenDone()
            fresh = self._fresh_members()
            fresh.add(self.tag)  # our own heartbeat file may lag a beat
            joined = self._markers(gen, "join")
            ready = joined >= set(range(self.n_procs)) if gen == 0 else fresh <= joined
            if ready:
                avail = sorted(joined & fresh | {self.tag})
                if avail[0] == self.tag:
                    # the re-elected coordinator publishes the formation plan
                    _atomic_write_json(plan_path, {
                        "gen": gen,
                        "world": avail,
                        "coordinator": f"{self.coordinator_host}:{_free_port()}",
                    })
                    break
                # not the leader: poll for the plan (if the presumed leader
                # died before writing it, its heartbeat goes stale and a
                # later pass elects the next tag)
            if time.monotonic() > deadline:
                raise FormationTimeout(
                    f"generation {gen} did not form within {FORM_TIMEOUT_SEC:.0f}s "
                    f"(joined={sorted(joined)}, fresh={sorted(fresh)})"
                )
            time.sleep(0.1)
        with open(plan_path, "r", encoding="utf-8") as f:
            plan = json.load(f)
        # this member's join-to-plan window, on the merged timeline
        obs.complete("elastic.form", t_form0, time.perf_counter(), cat="elastic",
                     args={"gen": gen, "world": list(plan["world"])})
        if self.tag not in plan["world"]:
            # our heartbeat was stale when the plan was cut: the formed
            # world runs without us, and this member aborts
            raise AnalysisError(
                f"member {self.tag} missed generation {gen} formation "
                f"(world={plan['world']}); aborting this launcher"
            )
        return plan

    # -- child lifecycle --------------------------------------------------
    def _spawn_worker(self, gen: int) -> tuple[subprocess.Popen, object]:
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join([pkg_root, *filter(None, [env.get("PYTHONPATH")])])
        log = open(os.path.join(self._gen_dir(gen), f"worker-{self.tag}.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ruleset_analysis_tpu_torch.runtime.elastic", "worker",
             self.dir, str(self.tag), str(gen)],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        return proc, log

    def _watch_worker(self, proc: subprocess.Popen, world: list[int], gen: int) -> int:
        """Wait for the worker; kill it when a peer is known lost.

        Two loss signals feed one grace-then-kill path: a peer's heartbeat
        went stale (whole-node death), or a peer marked this generation
        failed (its supervisor lives, but our worker may wait in a
        collective that never completes).  A worker still running
        :data:`KILL_GRACE_SEC` after either is presumed wedged and killed,
        an ordinary generation failure.  (The reference's scale requests
        and autoscale controller wait for the autoscale item.)
        """
        lost_since: float | None = None
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            stale = bool(set(world) - {self.tag} - self._fresh_members())
            failed = self._peer_failed(gen)
            if stale or failed:
                if lost_since is None:
                    lost_since = time.monotonic()
                    self.meter.detect("peer heartbeat lost" if stale else "peer worker failed")
                elif time.monotonic() - lost_since > KILL_GRACE_SEC:
                    proc.kill()
                    proc.wait()
                    return -9
            else:
                # the lagging peer came back (load, not death): a one-off
                # stale reading must not arm a later kill
                lost_since = None
            time.sleep(0.2)

    # -- the supervised loop ----------------------------------------------
    def run(self) -> tuple[int, str | None]:
        """Supervise until success or until the budget is spent.

        Returns ``(rc, result_json_path)``: rc 0 on success; the path only
        on the member whose worker held rank 0 of the final generation
        (the one that wrote the report).
        """
        os.makedirs(self._members_dir(), exist_ok=True)
        os.makedirs(self.epoch_dir, exist_ok=True)
        _atomic_write_json(os.path.join(self._members_dir(), f"{self.tag}.job.json"), self.job)
        self._hb = _Heartbeat(self._hb_path(self.tag))
        self._hb.start()
        # the recovery totals ride every metrics snapshot while supervising
        obs.register_sampler(
            "recovery", lambda: {"reforms_used": self.reforms_used, **self.meter.summary()})
        try:
            gen = 0
            world: list[int] = []
            while True:
                try:
                    plan = self._form(gen)
                except _PrevGenDone:
                    # the run completed while a death signal sent us to the
                    # next barrier; if WE held rank 0 of that generation,
                    # the report is ours, and it must be whole
                    out = self.job["out"]
                    if not (world and world[0] == self.tag and out):
                        return 0, None
                    path = out + ".json"
                    try:
                        with open(path, "r", encoding="utf-8") as f:
                            json.load(f)
                    except (OSError, ValueError) as e:
                        raise AnalysisError(
                            f"elastic: run completed but rank 0's report at {path!r} is "
                            "missing or torn (a death signal raced the final write); "
                            "re-run to regenerate it"
                        ) from e
                    return 0, self._patch_result(path)
                except FormationTimeout as e:
                    print(f"elastic: {e}", file=sys.stderr)
                    return exit_code_for(e), None  # the stall class (6)
                world = list(plan["world"])
                if gen > 0 and self.meter.detecting:
                    # the replacement group is formed and its worker about
                    # to run: the recovery is complete
                    self.meter.recovered(world=len(world))
                proc, log = self._spawn_worker(gen)
                try:
                    rc = self._watch_worker(proc, world, gen)
                finally:
                    log.close()
                if rc == 0:
                    self._marker(gen, "done")
                    out = self.job["out"]
                    if world[0] == self.tag and out:
                        return 0, self._patch_result(out + ".json")
                    return 0, None
                if rc == DIE_RC:
                    # fault injection: this NODE is dead; the heartbeat goes
                    # down with us, abruptly
                    os._exit(DIE_RC)
                # tell the peers this generation is dead though we live:
                # their workers may wait in a collective, and their
                # supervisors see our heartbeat as healthy
                self._marker(gen, "failed")
                self.meter.detect(f"worker exited rc={rc}")
                self.reforms_used += 1
                if self.reforms_used > self.max_reforms:
                    self.meter.abandon()
                    print(
                        f"elastic: re-formation budget exhausted ({self.reforms_used - 1} "
                        f"re-forms used, --max-reforms {self.max_reforms}); aborting (last "
                        f"worker rc={rc}, log: {self._gen_dir(gen)}/worker-{self.tag}.log)",
                        file=sys.stderr,
                    )
                    return EXIT_REFORM_BUDGET, None
                print(f"elastic: generation {gen} failed (worker rc={rc}); re-forming "
                      f"({self.reforms_used}/{self.max_reforms})", file=sys.stderr)
                gen += 1
        finally:
            obs.unregister_sampler("recovery")
            if self._hb is not None:
                self._hb.stop()
                self._hb.join(timeout=5.0)

    def _patch_result(self, result_path: str) -> str:
        """Fold the supervisor's recovery totals into the report (the
        reference's ``totals.autoscale`` waits for the autoscale item)."""
        try:
            with open(result_path, "r", encoding="utf-8") as f:
                rep = json.load(f)
        except (OSError, ValueError):
            return result_path  # the report stands as written
        rep.setdefault("totals", {})["recovery"] = {"reforms_used": self.reforms_used,
                                                    **self.meter.summary()}
        _atomic_write_json(result_path, rep)
        return result_path


# ---------------------------------------------------------------------------
# Worker (child) entry: one generation of the analysis
# ---------------------------------------------------------------------------


def _start_supervisor_watchdog() -> None:
    """End this worker if its supervisor dies.

    The supervisor owns the heartbeat: without it the peers re-form
    without this member, while an orphaned worker would compute on and
    could write epoch snapshots over the next generation's.  A changed
    parent pid is the orphan signal; the exit is abrupt, so the
    collectives it holds fail rather than drain.
    """
    ppid = os.getppid()

    def watch() -> None:
        while True:
            if os.getppid() != ppid:
                print("elastic worker: supervisor died (orphaned); aborting",
                      file=sys.stderr, flush=True)
                os._exit(1)
            time.sleep(1.0)

    threading.Thread(target=watch, daemon=True, name="ra-supervisor-watchdog").start()


def _worker_main(elastic_dir: str, tag: int, gen: int) -> int:
    # the trace shard and the flight recorder arm from the supervisor's
    # environment (RA_TRACE_DIR, RA_BLACKBOX_DIR) under this role: a worker
    # that dies typed dumps its ring, and a clean one seals at exit so a
    # later supervisor abort can still merge its telemetry
    obs.note_role(f"elastic-worker-{tag}-gen{gen}")
    from . import flightrec

    flightrec.cursor(elastic_gen=gen, elastic_tag=tag)
    _start_supervisor_watchdog()
    with open(os.path.join(elastic_dir, "members", f"{tag}.job.json"), "r",
              encoding="utf-8") as f:
        job = json.load(f)
    with open(os.path.join(elastic_dir, f"gen-{gen}", "plan.json"), "r", encoding="utf-8") as f:
        plan = json.load(f)
    world = list(plan["world"])
    if tag not in world:
        print(f"worker {tag}: not in generation {gen} world {world}", file=sys.stderr)
        return 4
    rank, nproc = world.index(tag), len(world)

    import numpy as np

    from ..config import AnalysisConfig
    from ..hostside import pack
    from ..parallel import distributed as dist
    from . import checkpoint as ckpt
    from .stream import run_stream_file_distributed

    cfg = AnalysisConfig.from_dict(job["cfg"])
    # the ranks renumber at a re-formation: the card follows the new rank
    # (init_distributed would prefer an inherited LOCAL_RANK)
    os.environ.pop("LOCAL_RANK", None)
    # a job on the card finds one or fails typed (DeviceUnavailable),
    # never carries on over gloo on the CPU
    dist.init_distributed(plan["coordinator"], nproc, rank, timeout=job["init_timeout"],
                          device=cfg.device)
    packed = pack.load_packed(job["ruleset"])
    epoch_dir = os.path.join(elastic_dir, "epoch")
    snap = ckpt.load(epoch_dir)
    shards = list(job["shards"])
    man_shards, cursors, done = manifest_of(snap)
    if man_shards is not None and man_shards != shards:
        raise ckpt.CheckpointMismatch(
            f"epoch snapshot in {epoch_dir!r} covers different shards; refusing to merge"
        )
    try:
        pace = float(os.environ.get("RA_ELASTIC_PACE", "") or 0.0)
    except ValueError:
        pace = 0.0
    fault = job.get("fault")
    die = None
    if (fault is not None and int(fault["tag"]) == tag
            and (fault.get("gen") is None or gen == int(fault["gen"]))):
        # no gen filter: the fault arms at this tag's FIRST generation (its
        # supervisor dies with it, so it never fires twice)
        die = int(fault["after_batches"])
    print(f"worker {tag} (rank {rank}/{nproc}, gen {gen}) starts at epoch chunk "
          f"{snap.n_chunks if snap is not None else 0} ({len(shards) - len(done)} of "
          f"{len(shards)} shards unread)", file=sys.stderr, flush=True)
    spec = ElasticRunSpec(
        epoch_dir=epoch_dir,
        shards=shards,
        assignments=assign_shards(shards, cursors, done, nproc)[rank],
        snapshot=snap,
        base_cursors=cursors,
        base_done=done,
        epoch=gen,
        die_after_batches=die,
        pace_sec=pace,
    )
    try:
        report, regs = run_stream_file_distributed(
            packed, [], cfg, native=job["native"], topk=job["topk"], return_state=True,
            elastic=spec,
        )
    finally:
        flightrec.seal()
    dist.shutdown()
    if rank == 0 and job["out"]:
        np.savez(job["out"] + ".npz", **regs)
        _atomic_write_json(job["out"] + ".json", report.to_json())
    print(f"worker {tag} (rank {rank}/{nproc}, gen {gen}) done", file=sys.stderr)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "worker":
        raise SystemExit(_worker_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    print("usage: python -m ruleset_analysis_tpu_torch.runtime.elastic worker "
          "ELASTIC_DIR TAG GEN  (spawned by ElasticSupervisor)", file=sys.stderr)
    raise SystemExit(2)
