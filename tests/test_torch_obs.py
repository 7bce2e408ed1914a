"""The port's span tracer (runtime/obs.py) against the reference's.

- **Plumbing**: disarmed calls are no-ops, a spawned child arms from the
  inherited ``RA_TRACE_DIR``, the owner prunes a previous run's shards
  (not a live sibling's), the merge skips a torn shard tail, and an
  unwritable ``--trace-out`` is the usage error.
- **Names**: the same run through both packages with tracing armed gives
  the same span and instant names, fault and retry instants included, and
  the same count of each (apart from the queue waits, which depend on
  timing); ``step.dispatch`` spans one a chunk.
- **Shape**: one merged trace holds the main thread's dispatches, the
  prefetch producer's spans (another thread of the same process) and the
  feed workers' spans (other processes, their tracks named).
"""

import json
import os
import random
import subprocess
from collections import Counter

import pytest

jax = pytest.importorskip("jax")

from tests._torch_faultkit import (  # noqa: E402
    BOTH, PORT, make_corpus, ref_one_device, reset_all,
)
from ruleset_analysis_tpu_torch.runtime import obs  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402

#: names whose count depends on timing (queue waits of 1 ms or more)
TIMING = {"ingest.backpressure", "ingest.starved"}


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("obs"), 2400, seed=8)


def _load(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def _well_formed(events: list[dict]) -> None:
    assert events, "merged trace is empty"
    for e in events:
        assert e["ph"] in ("X", "i", "M"), e
        if e["ph"] == "X":
            assert e["ts"] > 0 and e["dur"] >= 0
    last: dict = {}
    for e in events:
        if e["ph"] == "X":
            key = (e["pid"], e["tid"])
            assert e["ts"] >= last.get(key, 0), f"time went backwards on {key}"
            last[key] = e["ts"]


def _names(events: list[dict]) -> tuple[Counter, set]:
    """Counts of the timing-free (phase, name) pairs, and the timed names."""
    exact = Counter((e["ph"], e["name"]) for e in events if e["name"] not in TIMING)
    return exact, {e["name"] for e in events if e["name"] in TIMING}


# ---------------------------------------------------------------------------
# Plumbing
# ---------------------------------------------------------------------------


def test_disarmed_everything_is_a_noop(tmp_path):
    assert obs.active_tracer() is None and not obs.recording()
    obs.complete("x", 0.0, 1.0)
    obs.instant("x")
    with obs.span("x"):
        pass
    assert obs.span("x") is obs.span("y")  # one shared no-op
    assert obs.timed("x", lambda a: a + 1, 41) == 42
    assert obs.shutdown() is None
    assert not list(tmp_path.iterdir())


def test_env_export_and_lazy_child_arm(tmp_path):
    d = str(tmp_path / "tr")
    obs.start_trace(d, role="main")
    assert os.environ[obs.ENV_VAR] == os.path.abspath(d)
    obs.complete("unit.span", 0.0, 0.001)
    obs.shutdown()
    assert os.environ.get(obs.ENV_VAR) is None
    # a freshly spawned child: module disarmed, directory inherited
    obs._reset_for_tests()
    os.environ[obs.ENV_VAR] = os.path.abspath(d)
    try:
        obs.instant("child.mark")
        assert obs.active_tracer() is not None
    finally:
        obs.shutdown(merge=False)
        os.environ.pop(obs.ENV_VAR, None)
    names = [e["name"] for e in _load(obs.merge_trace(d))]
    assert "unit.span" in names and "child.mark" in names


def test_owner_arm_prunes_previous_runs_shards(tmp_path):
    """A dead writer's shard (fresh mtime), an hour-old one and the old
    merged file go; a live sibling's shard (pid 1 stands in) stays."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    (tmp_path / f"trace-{proc.pid}.jsonl").write_text(
        f'{{"ph":"X","name":"crashed.run","pid":{proc.pid},"tid":1,"ts":5,"dur":1}}\n')
    stale = tmp_path / "trace-99999.jsonl"
    stale.write_text('{"ph":"X","name":"old.run","pid":99999,"tid":1,"ts":5,"dur":1}\n')
    old = os.path.getmtime(stale) - 2 * obs.STALE_SHARD_SEC
    os.utime(stale, (old, old))
    (tmp_path / "trace.json").write_text("{}")
    (tmp_path / "trace-1.jsonl").write_text(
        '{"ph":"X","name":"sibling.rank","pid":1,"tid":1,"ts":9,"dur":1}\n')
    obs.start_trace(str(tmp_path), role="main")
    obs.complete("new.span", 0.0, 0.001)
    merged = obs.shutdown()
    assert {e["name"] for e in _load(merged) if e["ph"] == "X"} == {"new.span", "sibling.rank"}


def test_merge_skips_a_torn_shard_tail(tmp_path):
    tr = obs.start_trace(str(tmp_path), export_env=False)
    obs.complete("good.span", 0.0, 0.001)
    obs.shutdown(merge=False)
    with open(tr.path, "a", encoding="utf-8") as f:
        f.write('{"ph":"X","name":"torn...')
    events = _load(obs.merge_trace(str(tmp_path)))
    assert [e["name"] for e in events if e["ph"] == "X"] == ["good.span"]


def test_unwritable_trace_out_is_a_usage_error_in_both(corpus, tmp_path, monkeypatch):
    ref_one_device(monkeypatch)
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")  # a FILE where a directory is required
    for side in BOTH:
        extra = ["--device", "cpu"] if side is PORT else []
        assert side.cli.main(["run", "--ruleset", corpus["prefix"], "--logs", corpus["text"],
                              "--trace-out", str(blocker / "sub"), *extra]) == 2, side.name


# ---------------------------------------------------------------------------
# Names: the same run traced through both packages
# ---------------------------------------------------------------------------

RUNS = {
    # name: (input, config fields, plan)
    "text, synchronous": ("text", dict(prefetch_depth=0), None),
    "text, prefetch 2": ("text", dict(prefetch_depth=2), None),
    "wire, prefetch 2": ("wire", dict(prefetch_depth=2), None),
    "stacked text": ("text", dict(prefetch_depth=0, layout="stacked"), None),
    "coalesced text": ("text", dict(prefetch_depth=0, coalesce="on"), None),
    "checkpoints": ("text", dict(prefetch_depth=0, checkpoint_every_chunks=2), None),
    "device_put recovered": ("text", dict(prefetch_depth=0), "stream.device_put.fail@2:2"),
    "torn state recovered": ("wire", dict(prefetch_depth=0, checkpoint_every_chunks=2),
                             "checkpoint.torn_state@1:2"),
    "wire read recovered": ("wire", dict(prefetch_depth=2), "stream.wire.read.fail@1:1"),
    "device_put exhausted": ("text", dict(prefetch_depth=0), "stream.device_put.fail@3:99"),
    "producer raise": ("text", dict(prefetch_depth=2), "ingest.producer.raise@2"),
}


def _traced(side, corpus, tmp_path, inp, fields, plan, tag=""):
    d = str(tmp_path / f"tr-{side.name}{tag}")
    cfg = side.cfg(checkpoint_dir=str(tmp_path / f"ck-{side.name}{tag}"), **fields)
    side.obs.start_trace(d, role="main")
    try:
        img, err = side.outcome(corpus, inp, cfg, plan)
    finally:
        merged = side.obs.shutdown()
    events = _load(merged)
    _well_formed(events)
    return img, err, events


@pytest.mark.parametrize("name", RUNS)
def test_trace_names_equal_the_references(name, corpus, tmp_path):
    inp, fields, plan = RUNS[name]
    got = {}
    for side in BOTH:
        img, err, events = _traced(side, corpus, tmp_path, inp, fields, plan)
        got[side.name] = (img, err, *_names(events))
        reset_all()
    assert got["port"][:2] == got["ref"][:2]
    assert got["port"][2] == got["ref"][2], (name, got["port"][2], got["ref"][2])
    assert got["port"][3] <= TIMING
    exact = got["port"][2]
    if got["port"][1] is None:
        assert exact[("X", "step.dispatch")] == got["port"][0]["totals"]["chunks"]
    if plan:
        site = plan.split("@")[0]
        assert exact[("i", f"fault.{site}")] >= 1


def test_resumed_run_traces_the_snapshot_load(corpus, tmp_path):
    got = {}
    for side in BOTH:
        ck = str(tmp_path / f"ck-{side.name}")
        cfg = side.cfg(prefetch_depth=0, checkpoint_every_chunks=2, checkpoint_dir=ck)
        side.run(corpus, "text", cfg)
        reset_all()
        img, err, events = _traced(side, corpus, tmp_path, "text",
                                   dict(prefetch_depth=0, checkpoint_every_chunks=2,
                                        resume=True), None, tag="-resume")
        got[side.name] = (img, err, _names(events)[0])
        reset_all()
    assert got["port"] == got["ref"]
    assert got["port"][2][("X", "checkpoint.load")] == 1


@pytest.mark.parametrize("seed", [201, 202, 203, 204, 205])
def test_chaos_traces_stay_well_formed_and_name_the_fired_site(seed, corpus, tmp_path):
    """The reference's seeded schedules with tracing armed: whether the run
    aborts or not, the merged trace parses, and a fired site is an instant
    on it, in both packages."""
    rng = random.Random(seed)
    inp = rng.choice(["text", "wire"])
    sites = ["stream.device_put.fail", "checkpoint.torn_state", "checkpoint.torn_manifest",
             "ingest.producer.raise"]
    if inp == "wire":
        sites.append("stream.wire.corrupt")
    site = rng.choice(sites)
    cadence = 2 if site.startswith("checkpoint.") else rng.choice([0, 2])
    plan = f"{site}@{rng.randint(1, 3)},seed={seed}"
    got = {}
    for side in BOTH:
        img, err, events = _traced(side, corpus, tmp_path, inp,
                                   dict(prefetch_depth=2, checkpoint_every_chunks=cadence),
                                   plan)
        fired = [e for e in events if e["ph"] == "i" and e["name"] == f"fault.{site}"]
        got[side.name] = (img, err, len(fired))
        reset_all()
    assert got["port"] == got["ref"], (plan, got["port"][1:], got["ref"][1:])


# ---------------------------------------------------------------------------
# Shape: main thread, producer thread and feed worker processes
# ---------------------------------------------------------------------------


def _cli_trace(side, corpus, tmp_path, *flags):
    td = str(tmp_path / f"trace-{side.name}")
    extra = ["--device", "cpu"] if side is PORT else []
    rc = side.cli.main(["run", "--ruleset", corpus["prefix"], "--logs", corpus["text"],
                        "--batch-size", "256", "--trace-out", td, "--json",
                        "--out", str(tmp_path / f"rep-{side.name}.json"), *extra, *flags])
    merged = os.path.join(td, "trace.json")
    assert os.path.exists(merged), f"{side.name}: the CLI did not merge the trace"
    events = _load(merged)
    _well_formed(events)
    return rc, events


def test_merged_trace_spans_main_producer_and_feed_workers(corpus, tmp_path, monkeypatch):
    ensure_reference_native()
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        rc, events = _cli_trace(side, corpus, tmp_path, "--feed-workers", "2", "--feed-mode",
                                "process", "--prefetch-depth", "2")
        assert rc == 0, side.name
        main_pid = os.getpid()
        spans = [e for e in events if e["ph"] == "X"]
        steps = [e for e in spans if e["name"] == "step.dispatch"]
        assert steps and all(e["pid"] == main_pid for e in steps)
        produce = [e for e in spans if e["name"] == "ingest.produce"]
        assert produce and all(e["pid"] == main_pid for e in produce)
        assert {e["tid"] for e in produce}.isdisjoint({e["tid"] for e in steps})
        feed = [e for e in spans if e["name"] == "feeder.parse"]
        assert feed and all(e["pid"] != main_pid for e in feed)
        roles = [e["args"]["name"] for e in events
                 if e["ph"] == "M" and e.get("name") == "process_name"]
        assert any(r.startswith("feeder-worker") for r in roles)
        assert any(r.startswith("main") for r in roles)
        # the same events and tracks, whatever the pids
        got[side.name] = (_names(events)[0], sorted(r.split(" (pid")[0] for r in roles))
        reset_all()
    assert got["port"] == got["ref"]


def test_fault_instant_lands_in_the_merged_trace_after_an_abort(corpus, tmp_path, monkeypatch):
    """An armed site's firing is an instant, and the typed abort still
    leaves one merged, well-formed trace (the CLI's finally)."""
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        rc, events = _cli_trace(side, corpus, tmp_path, "--prefetch-depth", "2",
                                "--fault-plan", "ingest.producer.raise@2")
        fires = [e for e in events if e["name"] == "fault.ingest.producer.raise"]
        assert len(fires) == 1 and fires[0]["ph"] == "i" and fires[0]["args"]["hit"] == 2
        got[side.name] = (rc, fires[0]["args"])
        reset_all()
    assert got["port"] == got["ref"] == (1, {"action": "raise", "hit": 2})


def test_ring_feeder_trace_carries_the_summary_instant(corpus, tmp_path, monkeypatch):
    ensure_reference_native()
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        rc, events = _cli_trace(side, corpus, tmp_path, "--feed-workers", "2", "--feed-mode",
                                "ring")
        assert rc == 0
        (summary,) = [e for e in events if e["name"] == "feeder.summary"]
        a = summary["args"]
        got[side.name] = (_names(events)[0], {k: a[k] for k in ("mode", "rings", "ring_depth",
                                                                 "workers", "groups")})
        reset_all()
    assert got["port"] == got["ref"]
