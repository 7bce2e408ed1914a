"""The port's flight recorder (runtime/flightrec.py) and `doctor` against
the reference's.

- **Units**: the ring, the obs tap (events reach the ring with tracing
  off, and nothing touches disk), dump and merge, the triggers and their
  classifier, SIGQUIT snapshots (also while the main thread holds the
  ring's lock), Ctrl-C as teardown, a noted abort merging sealed worker
  shards, re-arming a directory, and ``disarm`` putting back the hooks
  ``arm`` replaced.  Each unit runs the same steps through both packages
  and compares the bundles apart from volatile fields (times, pids,
  paths).
- **The CLI**: ``run`` with the recorder's defaults that aborts typed
  writes ``postmortem.json`` beside the checkpoint dir where the
  reference does, with the same trigger, error class, exit code, fired
  sites and failing stage; ``doctor`` gives the reference's diagnosis of
  it, and of the reference's own bundle; a clean run leaves no forensics;
  a stall is diagnosed starved; a killed feed worker's shard joins the
  bundle.
"""

import json
import os
import re
import signal
import sys
import threading
import time

import pytest

jax = pytest.importorskip("jax")

from tests._torch_faultkit import (  # noqa: E402
    BOTH, PORT, REF, STALL_SEC, make_corpus, ref_one_device, reset_all,
)
from ruleset_analysis_tpu_torch.runtime import flightrec  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # the suite switches the CLI's default recorder off; these tests drive it
    monkeypatch.delenv("RA_BLACKBOX", raising=False)
    reset_all()
    yield
    reset_all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("flightrec"), 2000, seed=3)


def _stable(bundle: dict, racy: bool = False) -> dict:
    """A bundle's analysis without volatile fields: times, pids, paths, and
    the queue depths, which the port also reads before a prefetched run's
    teardown (test_typed_abort_under_metrics_carries_the_gauges).  ``racy``: the
    producer thread races the loop to the dump, so the last event (and the
    failing stage it names) is dropped too."""
    a = json.loads(json.dumps(bundle["analysis"]))
    a.pop("queue_depths", None)
    for s in a["per_shard"]:
        s.pop("pid", None)
        s.pop("stage_occupancy_pct", None)
        if racy:
            s.pop("last_event", None)
    if racy:
        a.pop("failing_stage", None)
    err = bundle["error"]
    return {
        "trigger": bundle["trigger"], "error_type": bundle["error_type"],
        "error": err and re.sub(r"\(/[^)]*\)", "(PATH)", err),
        "exit_code": bundle["exit_code"], "analysis": a,
    }


# ---------------------------------------------------------------------------
# Units, each step through both packages
# ---------------------------------------------------------------------------


def test_ring_overwrites_in_place_oldest_first():
    for side in BOTH:
        r = side.flightrec.FlightRing(capacity=8)
        for i in range(20):
            r.append({"i": i})
        assert (r.total, r.capacity) == (20, 8)
        assert [e["i"] for e in r.events()] == list(range(12, 20))
        with pytest.raises(side.errors.AnalysisError):
            side.flightrec.FlightRing(capacity=2)


def test_triggers_and_classifier_equal_the_references():
    assert list(flightrec.TRIGGERS) == list(REF.flightrec.TRIGGERS)
    assert flightrec.ENV_VAR == REF.flightrec.ENV_VAR
    assert flightrec.KILL_SWITCH == REF.flightrec.KILL_SWITCH
    assert flightrec.DEFAULT_RING_EVENTS == REF.flightrec.DEFAULT_RING_EVENTS
    for side in BOTH:
        e = side.errors
        got = [side.flightrec.classify(x) for x in
               (e.StallError("x"), e.AnalysisError("x"), e.InjectedFault("x"), ValueError("x"),
                None)]
        assert got == ["stall", "abort", "abort", "unhandled", "unhandled"]


def test_obs_tap_records_into_the_ring_without_tracing(tmp_path):
    for side in BOTH:
        assert side.obs.active_tracer() is None
        rec = side.flightrec.arm(str(tmp_path / f"bb-{side.name}"), role="main")
        t0 = time.perf_counter()
        side.obs.complete("step.dispatch", t0, time.perf_counter(), args={"kind": "v4"})
        side.obs.instant("fault.test", args={"hit": 1})
        with side.obs.span("ingest.produce", n_raw=7):
            pass
        assert [e["name"] for e in rec.ring.events()] == [
            "step.dispatch", "fault.test", "ingest.produce"]
        assert side.obs.recording()
        # nothing touched disk: the ring lands only at a dump trigger
        assert not (tmp_path / f"bb-{side.name}").exists()
        reset_all()


def _roundtrip(side, d):
    side.flightrec.arm(d, role="main")
    side.obs.instant("fault.stream.device_put.fail", args={"hit": 1})
    with side.obs.span("ingest.backpressure"):
        time.sleep(0.002)
    side.flightrec.cursor(committed_batches=5, committed_parsed=17)
    err = side.errors.AnalysisError("x")
    shard = side.flightrec.dump("abort", error=err, exit_code=1)
    assert shard and os.path.exists(shard)
    pm = side.flightrec.merge(d, trigger="abort", error=err, exit_code=1)
    assert pm.endswith("postmortem.json")
    with pytest.raises(side.errors.AnalysisError):
        side.flightrec.dump("not-a-trigger")
    return side.flightrec.load_bundle(d)  # a dir holding postmortem.json loads too


def test_dump_and_merge_give_the_references_bundle(tmp_path):
    got = {}
    for side in BOTH:
        bundle = _roundtrip(side, str(tmp_path / f"bb-{side.name}"))
        assert bundle["kind"] == "ra-postmortem" and bundle["version"] == 1
        (shard,) = bundle["shards"]
        assert shard["cursors"] == {"committed_batches": 5, "committed_parsed": 17}
        assert bundle["analysis"]["per_shard"][0]["stage_occupancy_pct"][
            "ingest.backpressure"] > 0
        got[side.name] = (_stable(bundle), sorted(shard))
        reset_all()
    assert got["port"] == got["ref"]
    assert got["port"][0]["analysis"]["failing_stage"] == "ingest.backpressure"
    assert got["port"][0]["analysis"]["fault_sites_fired"] == {"stream.device_put.fail": 1}


def _wait_for(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_sigquit_dumps_a_live_snapshot(tmp_path):
    for side in BOTH:
        d = str(tmp_path / f"bb-{side.name}")
        side.flightrec.arm(d, role="main")
        side.obs.instant("checkpoint.commit", args={"snap": "snap-3"})
        os.kill(os.getpid(), signal.SIGQUIT)
        _wait_for(lambda: os.path.exists(os.path.join(d, "postmortem.json")),
                  f"{side.name}: SIGQUIT postmortem")
        bundle = side.flightrec.load_bundle(d)
        assert bundle["trigger"] == "signal" and bundle["shards"][0]["trigger"] == "signal"
        # the snapshot did not stop the process, and a later finalize keeps it
        assert side.flightrec.finalize() is not None
        _wait_for(lambda: not any(t.name == "ra-blackbox-snap" for t in threading.enumerate()),
                  "snapshot thread")
        reset_all()


def test_sigquit_while_the_main_thread_holds_the_ring_lock(tmp_path):
    d = str(tmp_path / "bb")
    rec = flightrec.arm(d, role="main")
    with rec.ring._lock:
        os.kill(os.getpid(), signal.SIGQUIT)
        time.sleep(0.005)  # the handler runs here, inside the critical section
    _wait_for(lambda: os.path.exists(os.path.join(d, "postmortem.json")),
              "SIGQUIT snapshot under a held lock")
    assert flightrec.load_bundle(d)["trigger"] == "signal"
    _wait_for(lambda: not any(t.name == "ra-blackbox-snap" for t in threading.enumerate()),
              "snapshot thread")


def test_keyboard_interrupt_is_teardown_not_a_crash(tmp_path):
    for side in BOTH:
        d = str(tmp_path / f"bb-{side.name}")
        side.flightrec.arm(d, role="main")
        try:
            raise KeyboardInterrupt()
        except KeyboardInterrupt:
            assert side.flightrec.finalize() is None
        assert not (os.path.isdir(d) and os.listdir(d))
        reset_all()


def test_noted_abort_merges_sealed_worker_shards(tmp_path):
    got = {}
    for side in BOTH:
        d = str(tmp_path / f"bb-{side.name}")
        side.flightrec.arm(d, role="main")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "blackbox-9999.json"), "w") as f:
            json.dump({"kind": "ra-blackbox-shard", "role": "feeder-worker", "pid": 9999,
                       "trigger": "worker-exit", "ring_events": [], "cursors": {}}, f)
        side.flightrec.note_abort(side.errors.FeedWorkerError("worker died"), 5)
        assert side.flightrec.finalize() is not None
        bundle = side.flightrec.load_bundle(d)
        got[side.name] = (sorted(s.get("role") for s in bundle["shards"]), _stable(bundle))
        reset_all()
    assert got["port"] == got["ref"]
    assert got["port"][0] == ["feeder-worker", "main"]


def test_rearming_a_directory_forgets_the_previous_runs_failure(tmp_path):
    for side in BOTH:
        d = str(tmp_path / f"bb-{side.name}")
        side.flightrec.arm(d, role="main")
        side.flightrec.note_abort(side.errors.AnalysisError("run-1 failure"), 1)
        side.flightrec.arm(d, role="main")
        assert side.flightrec.finalize() is None
        assert not (os.path.isdir(d) and os.listdir(d))
        reset_all()


def test_stage_occupancy_of_nothing_and_of_instants_only():
    for side in BOTH:
        assert side.flightrec.stage_occupancy([]) == {}
        assert side.flightrec.stage_occupancy([{"ph": "i", "name": "x", "ts": 1}]) == {}


def test_disarm_puts_back_the_hooks_arm_replaced(tmp_path):
    before = (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGQUIT))
    flightrec.arm(str(tmp_path / "bb"), role="main")
    assert sys.excepthook is not before[0]
    assert signal.getsignal(signal.SIGQUIT) is not before[2]
    assert os.environ[flightrec.ENV_VAR] == str(tmp_path / "bb")
    flightrec.disarm()
    assert (sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGQUIT)) == before
    assert flightrec.ENV_VAR not in os.environ
    assert flightrec.dump("abort") is None  # disarmed: a no-op


def test_an_unhandled_thread_exception_dumps_its_ring(tmp_path, monkeypatch):
    # the hook chains to the one it replaced: a quiet one here
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    d = str(tmp_path / "bb")
    flightrec.arm(d, role="main")

    def boom():
        raise ValueError("a bug")

    t = threading.Thread(target=boom, name="ra-test-boom")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    (shard,) = [f for f in os.listdir(d) if f.startswith("blackbox-")]
    with open(os.path.join(d, shard)) as f:
        s = json.load(f)
    assert (s["trigger"], s["error_type"]) == ("unhandled", "ValueError")


# ---------------------------------------------------------------------------
# The CLI: run's default recorder, doctor
# ---------------------------------------------------------------------------

RUN_FLAGS = ["--batch-size", "256", "--cms-width", "4096", "--cms-depth", "2", "--hll-p", "6"]


def _cli(side, corpus, tmp_path, *extra, bb=None):
    """``run`` with the recorder's default directory (beside the checkpoint
    dir) unless ``bb`` names one; returns (rc, blackbox dir)."""
    ck = tmp_path / side.name / "ck"
    dev = ["--device", "cpu"] if side is PORT else []
    where = ["--blackbox-dir", str(bb)] if bb else []
    rc = side.cli.main(["run", "--ruleset", corpus["prefix"], "--logs", corpus["text"],
                        *RUN_FLAGS, "--checkpoint-dir", str(ck), "--json", "--out",
                        os.devnull, *dev, *where, *extra])
    return rc, (bb or tmp_path / side.name / "blackbox")


def _doctor(side, bb, capsys, *extra) -> dict:
    capsys.readouterr()
    assert side.cli.main(["doctor", str(bb), "--json", *extra]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("plan,depth,rc", [
    ("stream.device_put.fail@2:99", "0", 1),
    ("checkpoint.torn_manifest@1:99", "0", 1),
    ("checkpoint.torn_state@2:99", "0", 1),
    ("ingest.producer.raise@2", "2", 1),
    # prefetched: the loop's thread saves (a device_put plan would race the
    # producer's v4 copies against the loop's v6 copies for its hits)
    ("checkpoint.torn_state@2:99", "2", 1),
])
def test_typed_abort_leaves_the_references_postmortem(corpus, tmp_path, capsys, monkeypatch,
                                                      plan, depth, rc):
    ref_one_device(monkeypatch)
    racy = depth != "0"
    got = {}
    for side in BOTH:
        got_rc, bb = _cli(side, corpus, tmp_path, "--prefetch-depth", depth,
                          "--checkpoint-every", "2", "--retry-policy",
                          "device_put=3/0.001,checkpoint.save=3/0.001,wire.read=2/0.001",
                          "--fault-plan", plan)
        assert got_rc == rc, side.name
        bundle = side.flightrec.load_bundle(str(bb))
        names = {e["name"] for s in bundle["shards"] for e in s["ring_events"]
                 if e["name"] not in ("ingest.backpressure", "ingest.starved")}
        dj = _doctor(side, bb, capsys)
        if racy:
            dj.pop("failing_stage")
        dj["error"] = re.sub(r"\(/[^)]*\)", "(PATH)", dj["error"])
        for d in dj["diagnosis"]:
            d["evidence"] = re.sub(r"\(/[^)]*\)", "(PATH)", d["evidence"])
            if racy:
                d["evidence"] = re.sub(r"(failing|last) stage: \S+", "", d["evidence"])
        got[side.name] = (_stable(bundle, racy), names, dj)
        reset_all()
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    assert got["port"][2] == got["ref"][2]
    assert got["port"][2]["diagnosis"][0]["cause"] == "an armed fault plan fired"
    assert plan.split("@")[0] in got["port"][2]["diagnosis"][0]["evidence"]


@pytest.mark.parametrize("depth", ["0", "2"])
def test_typed_abort_under_metrics_carries_the_gauges(corpus, tmp_path, monkeypatch, depth):
    """An exhausted copy fault with --metrics-out armed: the main shard's
    samplers and the bundle's queue depths.  The synchronous loop gives
    the reference's; under prefetch the reference reads its samplers after
    the prefetch queue's teardown and loses its gauges, the port reads
    them as the failure unwinds too (flightrec.note_gauges) and keeps them."""
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        rc, bb = _cli(side, corpus, tmp_path, "--prefetch-depth", depth,
                      "--metrics-out", str(tmp_path / f"m-{side.name}.jsonl"),
                      "--metrics-every", "0.05", "--retry-policy", "device_put=3/0.001",
                      "--fault-plan", "stream.device_put.fail@3:99")
        assert rc == 1, side.name
        bundle = side.flightrec.load_bundle(str(bb))
        (main,) = [s for s in bundle["shards"] if s["role"] == "main"]
        got[side.name] = (sorted(main["samplers"]), bundle["analysis"]["queue_depths"])
        assert main["samplers"]["retry"]["device_put"]["giveups"] == 1, side.name
        reset_all()
    assert got["ref"] == (["device_mem", "retry"], {})
    if depth == "0":
        assert got["port"] == got["ref"]
    else:
        assert got["port"][0] == ["device_mem", "ingest", "retry"]
        assert list(got["port"][1]) == ["ingest@main"]
        qd = got["port"][1]["ingest@main"]
        assert qd["prefetch_depth"] == 2 and 0 <= qd["queue_depth"] <= 2


def test_doctor_diagnoses_the_references_bundle_as_the_reference(corpus, tmp_path, capsys,
                                                                 monkeypatch):
    ref_one_device(monkeypatch)
    rc, bb = _cli(REF, corpus, tmp_path, "--prefetch-depth", "0",
                  "--fault-plan", "stream.device_put.fail@2:99")
    assert rc == 1
    reset_all()
    texts = []
    for side in BOTH:
        for extra in ((), ("--exit-code", "5")):
            texts.append(_doctor(side, bb, capsys, *extra))
        capsys.readouterr()
        assert side.cli.main(["doctor", str(bb)]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[:3] == texts[3:]
    assert "stream.device_put.fail" in texts[2] and "INJECTED" in texts[2]


def test_doctor_refuses_what_is_not_a_bundle(tmp_path):
    bad = tmp_path / "x.json"
    bad.write_text('{"kind": "something-else"}')
    for side in BOTH:
        with pytest.raises(side.errors.AnalysisError):
            side.flightrec.load_bundle(str(bad))
        assert side.cli.main(["doctor", str(bad)]) == 1, side.name
        assert side.cli.main(["doctor", str(tmp_path / "missing.json")]) == 1, side.name


def test_clean_run_leaves_no_forensics(corpus, tmp_path, monkeypatch):
    ref_one_device(monkeypatch)
    for side in BOTH:
        rc, bb = _cli(side, corpus, tmp_path)
        assert rc == 0
        assert not os.path.exists(bb) or not os.listdir(bb)
        reset_all()
    # the recorder is disarmed after the port's run: nothing left armed
    assert not flightrec.armed() and flightrec.ENV_VAR not in os.environ


def test_blackbox_off_and_the_kill_switch_write_nothing(corpus, tmp_path, monkeypatch):
    for extra, env in ((("--blackbox", "off"), None), ((), "off")):
        if env:
            monkeypatch.setenv("RA_BLACKBOX", env)
        rc, bb = _cli(PORT, corpus, tmp_path, "--fault-plan", "stream.device_put.fail@1:99",
                      "--retry-policy", "device_put=2/0.001", *extra)
        assert rc == 1 and not os.path.exists(bb)
        reset_all()


def test_stall_is_diagnosed_starved_as_in_the_reference(corpus, tmp_path, capsys, monkeypatch):
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        rc, bb = _cli(side, corpus, tmp_path, "--fault-plan", "ingest.queue.stall@2",
                      "--stall-timeout", str(STALL_SEC))
        bundle = side.flightrec.load_bundle(str(bb))
        causes = [d["cause"] for d in _doctor(side, bb, capsys)["diagnosis"]]
        # which stall cause leads depends on the queue waits' timing
        got[side.name] = (rc, bundle["trigger"], bundle["error_type"], causes[0],
                          "stall" in causes[1].lower())
        reset_all()
    assert got["port"] == got["ref"]
    assert got["port"] == (6, "stall", "StallError", "an armed fault plan fired", True)


def test_killed_feed_worker_joins_the_bundle_as_in_the_reference(corpus, tmp_path,
                                                                 monkeypatch):
    ensure_reference_native()
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        rc, bb = _cli(side, corpus, tmp_path, "--feed-workers", "2", "--native-parse",
                      "--fault-plan", "feeder.worker.crash@2")
        bundle = side.flightrec.load_bundle(str(bb))
        shards = bundle["shards"]
        roles = {s["role"] for s in shards}
        triggers = {s["trigger"] for s in shards}
        assert "main" in roles and "abort" in triggers and "crash" in triggers, side.name
        assert len(shards) >= 2
        assert bundle["analysis"]["fault_sites_fired"].get("feeder.worker.crash", 0) >= 1
        diags = side.flightrec.diagnose(bundle, exit_code=5)
        got[side.name] = (rc, bundle["error_type"], any("feed tier" in d["cause"]
                                                        for d in diags))
        reset_all()
    assert got["port"] == got["ref"] == (5, "FeedWorkerError", True)
