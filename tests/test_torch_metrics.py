"""The port's run telemetry (runtime/metrics.py, the metrics half of
runtime/obs.py, runtime/devprof.py) against the reference's.

- **Meters**: the same seeded samples through both packages' latency
  histograms give the same counts, gauges, Prometheus text and quantiles
  read back from it; the same SLO specs parse or are refused alike; the
  burn-rate engine emits the same events and gauges over a seeded run of
  window stats; ``window_slo_stats``, ``build_info`` (``torch`` where
  the reference has ``jax``) and ``RecoveryMeter`` agree.  Host code:
  exact equality.
- **Profiler**: the reference's five hardening cases, over a fake
  ``torch.profiler``.
- **Metrics plane**: snapshots and samplers, a raising sampler left out,
  the final snapshot, ``metrics.snapshot.fail`` counted with the thread
  alive, the ring feeder's gauges, and the CPU's device-memory nulls.
- **The CLI**: ``run --metrics-out`` over the synchronous loop, prefetch,
  the thread and ring feeders, a coalesced wire file and checkpoints
  gives the reference's report, record kinds, event counts, snapshot and
  sampler keys; an unwritable file exits 2 in both; ``--profile-dir``
  writes a trace and leaves the report as it was.
"""

import json
import math
import os
import random
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tests._torch_faultkit import (  # noqa: E402
    BOTH, PORT, REF, image, make_corpus, ref_one_device, reset_all,
)
from ruleset_analysis_tpu.runtime import devprof as rdevprof  # noqa: E402
from ruleset_analysis_tpu.runtime import metrics as rmetrics  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import devprof, faults, metrics, obs  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402

MODS = {"port": metrics, "ref": rmetrics}


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


# ---------------------------------------------------------------------------
# Latency histograms
# ---------------------------------------------------------------------------


def _samples(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # log-uniform over 0.1 us .. ~3 h: every bucket, the overflow and zero
    s = 10.0 ** rng.uniform(-7, 4, n)
    s[rng.random(n) < 0.05] = 0.0
    return s


def _hists(seed: int, n: int) -> dict:
    out = {}
    for name, m in MODS.items():
        a, b = m.LatencyHistogram(), m.LatencyHistogram()
        for i, x in enumerate(_samples(seed, n)):
            (a if i % 3 else b).record(float(x), n=1 + i % 2)
        a.merge(b)
        out[name] = a
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("n", [0, 1, 37, 500])
def test_histogram_merge_gauges_and_prom_equal_the_references(seed, n):
    h = _hists(seed, n)
    p, r = h["port"], h["ref"]
    assert p.counts == r.counts and p.count == r.count and p.sum_sec == r.sum_sec
    assert p.gauges("lat_") == r.gauges("lat_")
    for labels in (None, {"tenant": "acme"}, {"b": "2", "a": "1"}):
        text = p.render_prom("ra_lat", labels)
        assert text == r.render_prom("ra_lat", labels)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            got = metrics.quantile_from_prom(text, "ra_lat", q, labels)
            assert got == rmetrics.quantile_from_prom(text, "ra_lat", q, labels)
            if n:
                # the exposition reads back to the JSON quantile
                assert got == p.quantile(q)


def test_quantile_from_prom_of_a_missing_series_is_none():
    text = metrics.LatencyHistogram().render_prom("x")
    for m in MODS.values():
        assert m.quantile_from_prom(text, "y", 0.5) is None
        assert m.quantile_from_prom(text, "x", 0.5, {"t": "a"}) is None
        assert m.quantile_from_prom(text, "x", 0.5) == 0.0


# ---------------------------------------------------------------------------
# SLO policy, burn engine, window stats
# ---------------------------------------------------------------------------

SLO_SPECS = [
    "p99_publish_ms<=500", "p99_publish_ms<=500,drop_rate<=0.001",
    " p50_publish_ms <= 2.5e2 , incomplete_rate<=0 ", "degraded_subsystems<=1,",
    "p90_publish_ms<=.5", "", " , ", "p99_publish_ms<500", "p99<=5",
    "drop_rate<=0.1,drop_rate<=0.2", "p99_publish_ms<=abc", "p99_publish_ms>=5",
    "P99_publish_ms<=5", "drop_rate<=-1",
]


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_slo_policy_parse_accepts_and_refuses_as_the_reference(spec):
    got = {}
    for name, m in MODS.items():
        try:
            got[name] = ("ok", m.SloPolicy.parse(spec).objectives)
        except ValueError as e:
            got[name] = ("refused", str(e))
    assert got["port"] == got["ref"]
    assert metrics.SLO_METRICS == rmetrics.SLO_METRICS


def _window_stats(seed: int, n: int) -> list[dict]:
    rng = random.Random(seed)
    out = []
    for w in range(n):
        bad = rng.random() < (0.6 if (w // 7) % 2 else 0.05)
        st = {"window": w, "drop_rate": rng.random() * (0.01 if bad else 1e-4),
              "incomplete_rate": 1.0 if bad and rng.random() < 0.5 else 0.0,
              "degraded_subsystems": rng.randrange(3) if bad else 0}
        if rng.random() < 0.9:
            st["p99_publish_ms"] = rng.uniform(600, 900) if bad else rng.uniform(10, 400)
        out.append(st)
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("fast,slow,budget", [(3, 12, 0.01), (1, 1, 0.5), (2, 5, 0.2)])
def test_slo_burn_engine_events_and_gauges_equal_the_references(seed, fast, slow, budget):
    spec = "p99_publish_ms<=500,drop_rate<=0.001,incomplete_rate<=0,degraded_subsystems<=1"
    eng = {name: m.SloBurnEngine(m.SloPolicy.parse(spec), fast=fast, slow=slow,
                                 budget=budget)
           for name, m in MODS.items()}
    events = {name: [] for name in MODS}
    for st in _window_stats(seed, 40):
        for name, e in eng.items():
            events[name].append(e.observe(dict(st)))
        assert eng["port"].gauges() == eng["ref"].gauges()
        assert eng["port"].labeled_gauges() == eng["ref"].labeled_gauges()
    assert events["port"] == events["ref"]
    assert any(events["port"]) or budget == 0.5


def test_slo_burn_engine_refuses_a_bad_horizon_as_the_reference():
    for m in MODS.values():
        pol = m.SloPolicy.parse("drop_rate<=0.1")
        for fast, slow in ((0, 3), (4, 3)):
            with pytest.raises(ValueError, match="fast <= slow"):
                m.SloBurnEngine(pol, fast=fast, slow=slow)


@pytest.mark.parametrize("seed", range(5))
def test_window_slo_stats_equal_the_references(seed):
    h = _hists(seed, 50 if seed else 0)
    rng = random.Random(seed)
    for _ in range(10):
        kw = dict(lines=rng.randrange(0, 1000) if rng.random() < 0.8 else 0,
                  drops=rng.randrange(0, 30) if rng.random() < 0.5 else 0,
                  incomplete=rng.random() < 0.3, degraded=rng.randrange(3),
                  window=rng.randrange(100))
        for use in (True, False):
            got = metrics.window_slo_stats(h["port"] if use else None, **kw)
            assert got == rmetrics.window_slo_stats(h["ref"] if use else None, **kw)


# ---------------------------------------------------------------------------
# Build info, recovery meter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [None, {}, {"mesh": "flat", "n": 2}])
def test_build_info_has_the_references_keys_with_torch_for_jax(extra):
    import torch

    p, r = metrics.build_info(extra), rmetrics.build_info(extra)
    assert set(p) == (set(r) - {"jax"}) | {"torch"}
    assert p["torch"] == torch.__version__ and p["version"] == r["version"]
    assert p["simd"] in ("avx2", "neon", "scalar")
    assert all(isinstance(v, str) for v in p.values())
    text = metrics.render_build_info_prom(p)
    lines = text.splitlines()
    assert lines[0] == "# TYPE ra_build_info gauge" and len(lines) == 2
    assert lines[1].startswith("ra_build_info{") and lines[1].endswith("} 1")
    # the same rendering as the reference's for the same labels
    assert text == rmetrics.render_build_info_prom(p)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


RECOVERY_STEPS = [
    [("detect", "peer 1 died"), ("tick", 1.5), ("recovered", 2)],
    [("recovered", 4)],  # out of order: no detect before it
    [("detect", "a"), ("detect", "b"), ("tick", 0.25), ("recovered", 3), ("tick", 1),
     ("detect", "c"), ("tick", 2), ("recovered", 3)],
    [("detect", "x"), ("abandon", None), ("recovered", 1)],
    [("run", True), ("run", False), ("run", True)],
    [],
]


@pytest.mark.parametrize("steps", RECOVERY_STEPS)
def test_recovery_meter_equals_the_references(steps, monkeypatch, tmp_path):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    got = {}
    for name, m in MODS.items():
        side = PORT if name == "port" else REF
        mf = str(tmp_path / f"m-{name}.jsonl")
        side.obs.start_metrics(mf, every_sec=60.0)
        meter = m.RecoveryMeter()
        detecting = []
        for op, arg in steps:
            if op == "detect":
                meter.detect(arg)
            elif op == "tick":
                clock.t += arg
            elif op == "recovered":
                meter.recovered(world=arg)
            elif op == "abandon":
                meter.abandon()
            else:
                meter.record_run(arg)
            detecting.append(meter.detecting)
        side.obs.shutdown(merge=False)
        with open(mf, encoding="utf-8") as f:
            recs = [json.loads(ln) for ln in f]
        events = [{k: v for k, v in r.items() if k != "t"} for r in recs
                  if r["kind"] == "recovery"]
        got[name] = (meter.summary(), detecting, events)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Profiler hardening (the reference's tests/test_obs.py cases), over a fake
# torch.profiler
# ---------------------------------------------------------------------------


class _FakeProfile:
    def __init__(self, owner, activities):
        self.owner = owner
        self.activities = activities

    def start(self):
        self.owner.starts += 1

    def stop(self):
        self.owner.stops += 1
        if self.owner.fail_stop:
            raise RuntimeError("profiler teardown broke")

    def export_chrome_trace(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": []}, f)


class _FakeTorchProfiler:
    """The part of ``torch.profiler`` that metrics.Profiler uses."""

    class ProfilerActivity:
        CPU = "cpu"
        CUDA = "cuda"

    def __init__(self, fail_stop=False, cuda=True):
        self.starts = 0
        self.stops = 0
        self.fail_stop = fail_stop
        self.cuda = cuda
        self.activities = None

    def supported_activities(self):
        return {"cpu", "cuda"} if self.cuda else {"cpu"}

    def profile(self, activities):
        self.activities = list(activities)
        return _FakeProfile(self, activities)


def _patched(monkeypatch, fake):
    import torch

    monkeypatch.setattr(torch, "profiler", fake)


def test_profiler_noop_without_dir(monkeypatch):
    fake = _FakeTorchProfiler()
    _patched(monkeypatch, fake)
    with metrics.Profiler(None):
        pass
    assert fake.starts == 0 and fake.stops == 0


def test_profiler_double_start_is_typed(monkeypatch, tmp_path):
    fake = _FakeTorchProfiler()
    _patched(monkeypatch, fake)
    p = metrics.Profiler(str(tmp_path))
    with p:
        with pytest.raises(AnalysisError, match="already started"):
            p.__enter__()
    assert fake.starts == 1 and fake.stops == 1


def test_profiler_stops_trace_on_body_exception(monkeypatch, tmp_path, capsys):
    fake = _FakeTorchProfiler()
    _patched(monkeypatch, fake)
    with pytest.raises(ValueError, match="body failed"):
        with metrics.Profiler(str(tmp_path), out=sys.stderr):
            raise ValueError("body failed")
    assert fake.stops == 1  # the trace always stops
    assert "profiler trace" not in capsys.readouterr().err


def test_profiler_stop_failure_does_not_mask_body_error(monkeypatch, tmp_path):
    _patched(monkeypatch, _FakeTorchProfiler(fail_stop=True))
    with pytest.raises(ValueError, match="the real error"):
        with metrics.Profiler(str(tmp_path)):
            raise ValueError("the real error")
    # ... but a clean-exit stop failure is real and propagates
    _patched(monkeypatch, _FakeTorchProfiler(fail_stop=True))
    with pytest.raises(RuntimeError, match="teardown broke"):
        with metrics.Profiler(str(tmp_path)):
            pass


def test_profiler_prints_the_trace_and_how_to_open_it_on_clean_exit(monkeypatch, tmp_path,
                                                                    capsys):
    _patched(monkeypatch, _FakeTorchProfiler())
    p = metrics.Profiler(str(tmp_path), out=sys.stderr)
    with p:
        pass
    err = capsys.readouterr().err
    assert p.path and os.path.exists(p.path) and p.path.startswith(str(tmp_path))
    assert p.path in err and "perfetto" in err.lower()


@pytest.mark.parametrize("device,cuda_ok", [("cpu", True), ("cpu", False), ("cuda", True),
                                            ("cuda", False)])
def test_profiler_takes_cuda_activity_on_a_cuda_run_or_refuses(monkeypatch, tmp_path, device,
                                                               cuda_ok):
    fake = _FakeTorchProfiler(cuda=cuda_ok)
    _patched(monkeypatch, fake)
    p = metrics.Profiler(str(tmp_path), device=device)
    if device == "cuda" and not cuda_ok:
        # never a quiet CPU-only trace of a CUDA run
        with pytest.raises(AnalysisError, match="CUDA activity"):
            p.__enter__()
        assert fake.starts == 0
        return
    with p:
        pass
    assert fake.activities == (["cpu", "cuda"] if device == "cuda" else ["cpu"])


def test_a_real_cpu_profile_holds_the_body_ops(tmp_path, capsys):
    import torch

    p = metrics.Profiler(str(tmp_path / "prof"))
    with p:
        torch.ones(64).add_(1).sum()
    with open(p.path, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::add_" in names


# ---------------------------------------------------------------------------
# The metrics plane
# ---------------------------------------------------------------------------


def _records(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_metrics_plane_snapshots_samplers_and_final(tmp_path):
    got = {}
    for side in BOTH:
        mf = str(tmp_path / f"m-{side.name}.jsonl")
        side.obs.start_metrics(mf, every_sec=60.0)
        assert side.obs.metrics_active()
        side.obs.register_sampler("good", lambda: {"depth": 3})
        side.obs.register_sampler("bad", lambda: 1 / 0)
        side.obs.add_lines(250)
        snap = side.obs.metrics_snapshot()
        side.obs.metric_event("checkpoint", n_chunks=2, bytes=10)
        side.obs.typed_event("slo.breach", objective="drop_rate")
        side.obs.unregister_sampler("good")
        side.obs.add_lines(50)
        dumped = side.obs.sampler_snapshot()
        side.obs.shutdown(merge=False)
        assert not side.obs.metrics_active() and side.obs.metrics_snapshot() is None
        assert [t.name for t in threading.enumerate() if t.name == "ra-metrics"] == []
        recs = _records(mf)
        assert snap == recs[0]
        got[side.name] = (
            [(r["kind"], sorted(r)) for r in recs],
            snap["good"], snap["lines"], recs[-1]["lines"],
            sorted(dumped), dumped["bad"].startswith("<sampler error: ZeroDivisionError"),
        )
    assert got["port"] == got["ref"]
    kinds = [k for k, _ in got["port"][0]]
    assert kinds == ["snapshot", "checkpoint", "slo.breach", "final"]
    assert got["port"][2:4] == (250, 300)


def test_metrics_plane_ticks_on_its_cadence_and_rates_are_monotonic(tmp_path):
    mf = str(tmp_path / "m.jsonl")
    plane = obs.start_metrics(mf, every_sec=0.01)  # clamped to 0.05 s
    assert plane.every == 0.05
    try:
        for _ in range(20):
            obs.add_lines(100)
            time.sleep(0.02)
    finally:
        obs.shutdown(merge=False)
    recs = _records(mf)
    snaps = [r for r in recs if r["kind"] == "snapshot"]
    assert len(snaps) >= 2 and recs[-1]["kind"] == "final" and recs[-1]["lines"] == 2000
    assert all(r["lines_per_sec_inst"] >= 0 and r["rss_bytes"] > 0 for r in recs)
    assert [r["uptime_sec"] for r in recs] == sorted(r["uptime_sec"] for r in recs)


def test_metrics_records_reach_the_flight_recorder_ring(tmp_path):
    from ruleset_analysis_tpu_torch.runtime import flightrec

    rec = flightrec.arm(str(tmp_path / "bb"), role="main")
    obs.start_metrics(str(tmp_path / "m.jsonl"), every_sec=60.0)
    obs.metric_event("checkpoint", n_chunks=1)
    obs.metrics_snapshot()
    obs.shutdown(merge=False)
    names = [e["name"] for e in rec.ring.events()]
    assert names == ["metrics.checkpoint", "metrics.snapshot", "metrics.final"]


def test_metrics_snapshot_failures_counted_thread_survives(tmp_path):
    """metrics.snapshot.fail@1:2: tick errors are counted, the ra-metrics
    thread lives, a clean tick resets consec_errors (the reference's
    tests/test_retry.py case)."""
    for side in BOTH:
        mf = str(tmp_path / f"m-{side.name}.jsonl")
        with side.faults.armed(side.faults.FaultPlan.parse("metrics.snapshot.fail@1:2")):
            side.obs.start_metrics(mf, every_sec=0.05)
            try:
                deadline = time.monotonic() + 15
                h = None
                while time.monotonic() < deadline:
                    h = side.obs.metrics_health()
                    if h["errors"] >= 2 and h["consec_errors"] == 0:
                        break
                    time.sleep(0.05)
                assert h is not None and h["alive"], (side.name, h)
                assert h["errors"] == 2 and h["consec_errors"] == 0, (side.name, h)
                assert "InjectedFault" in h["last_error"]
            finally:
                side.obs.shutdown(merge=False)
        assert any(r["kind"] == "snapshot" for r in _records(mf))
        assert side.obs.metrics_health() is None


def test_unwritable_metrics_file_raises_oserror(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    for side in BOTH:
        with pytest.raises(OSError):
            side.obs.start_metrics(str(blocker / "m.jsonl"))
        assert not side.obs.metrics_active()


def test_reset_clears_the_sampler_registry():
    obs.register_sampler("x", lambda: {})
    assert "x" in obs.sampler_snapshot()
    obs._reset_for_tests()
    assert obs.sampler_snapshot() == {}


def test_retry_configure_registers_the_retry_sampler():
    for side in BOTH:
        side.retry.configure("")
        assert side.obs.sampler_snapshot()["retry"] == side.retry.counters() == {}


def test_throughput_meter_feeds_the_plane_as_the_reference(tmp_path):
    import io

    got = {}
    for name, m in MODS.items():
        side = PORT if name == "port" else REF
        mf = str(tmp_path / f"m-{name}.jsonl")
        side.obs.start_metrics(mf, every_sec=60.0)
        out = io.StringIO()
        meter = m.ThroughputMeter(report_every_chunks=2, out=out)
        for n in (100, 100, 100, 100, 50):
            meter.tick(n)
        side.obs.shutdown(merge=False)
        recs = _records(mf)
        got[name] = ([(r["kind"], r.get("chunk"), r["lines"], sorted(r)) for r in recs],
                     out.getvalue().count("\n"))
    assert got["port"] == got["ref"]
    assert [k for k, *_ in got["port"][0]] == ["throughput", "throughput", "final"]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_device_memory_gauges_on_the_cpu_are_nulls_in_both(device):
    want = {"device_mem_bytes_in_use": None, "device_mem_peak_bytes_in_use": None,
            "device_mem_bytes_limit": None}
    assert rdevprof.device_memory_gauges() == want
    assert devprof.device_memory_gauges(device) == want
    assert devprof.device_memory_gauges() == want


def test_ring_feeder_gauges_cover_every_ring(tmp_path):
    """The sampler exposes per-ring occupancy, partition imbalance and
    starved seconds (the reference's tests/test_feeder.py case), and
    unregisters when the feed ends."""
    from ruleset_analysis_tpu_torch.hostside import feeder

    c = make_corpus(tmp_path, 3000, seed=5)
    obs.start_metrics(str(tmp_path / "m.jsonl"), every_sec=60.0)
    seen = {}
    try:
        f = feeder.RingFeeder(c["packed"], [c["text"]], n_workers=2, n_rings=4)
        gen = f.batches(0, 256)
        try:
            for i, _ in enumerate(gen):
                if i == 2:
                    seen = dict(obs.metrics_snapshot().get("feeder", {}))
                    break
        finally:
            gen.close()
        assert "feeder" not in obs.sampler_snapshot()
    finally:
        obs.shutdown(merge=False)
    assert seen["mode"] == "ring" and seen["rings"] == 4 and seen["ring_depth"] == 4
    assert len(seen["ring_occupancy"]) == 4 and len(seen["starved_sec"]) == 4
    assert seen["partition_imbalance"] == max(seen["ring_occupancy"]) - min(
        seen["ring_occupancy"])
    assert seen["workers"] == seen["alive"] == 2


# ---------------------------------------------------------------------------
# The CLI, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("metrics"), 12000, seed=11)


#: name -> (input, extra flags); every run at batch 512, --report-every 1
CLI_RUNS = {
    "synchronous": ("text", ("--prefetch-depth", "0")),
    "prefetch 2": ("text", ("--prefetch-depth", "2")),
    "thread feeder": ("text", ("--feed-workers", "2", "--feed-mode", "thread",
                               "--native-parse")),
    "ring feeder": ("text", ("--feed-workers", "2", "--feed-mode", "ring", "--native-parse")),
    "coalesced wire": ("wire", ("--coalesce", "on", "--prefetch-depth", "0")),
    "checkpoints": ("text", ("--prefetch-depth", "0", "--checkpoint-every", "2")),
}


def _cli(side, c, tmp_path, inp, extra, tag=""):
    d = tmp_path / f"{side.name}{tag}"
    d.mkdir(exist_ok=True)
    mf, out = str(d / "m.jsonl"), str(d / "r.json")
    dev = ["--device", "cpu"] if side is PORT else []
    rc = side.cli.main(["run", "--ruleset", c["prefix"], "--logs",
                        c[inp],
                        "--batch-size", "512", "--cms-width", "1024", "--cms-depth", "2",
                        "--hll-p", "6", "--checkpoint-dir", str(d / "ck"),
                        "--metrics-out", mf, "--metrics-every", "0.05", "--report-every", "1",
                        "--json", "--out", out, *dev, *extra])
    assert rc == 0, side.name
    with open(out, encoding="utf-8") as f:
        rep = json.load(f)
    return rep, _records(mf)


def _shape(recs: list[dict]) -> dict:
    """What must equal the reference's: record kinds, event counts, the
    union of snapshot keys and of each sampler's keys (timing decides which
    snapshot sees which sampler, not which keys a sampler has), the final
    snapshot's keys and lines."""
    kinds = Counter(r["kind"] for r in recs)
    snaps = [r for r in recs if r["kind"] in ("snapshot", "final")]
    top: set = set()
    samplers: dict = {}
    for r in snaps:
        top |= set(r)
        for k, v in r.items():
            if isinstance(v, dict):
                samplers.setdefault(k, set()).update(v)
    final = [r for r in recs if r["kind"] == "final"]
    assert len(final) == 1 and recs[-1] is final[0]
    return {
        "kinds": set(kinds),
        "events": {k: n for k, n in kinds.items() if k not in ("snapshot", "final")},
        "snapshot_keys": top,
        "sampler_keys": {k: sorted(v) for k, v in samplers.items()},
        "final_keys": {k: sorted(v) if isinstance(v, dict) else None
                       for k, v in final[0].items()},
        "final_lines": final[0]["lines"],
    }


@pytest.mark.parametrize("name", CLI_RUNS)
def test_run_metrics_out_gives_the_references_jsonl(name, corpus, tmp_path, monkeypatch):
    inp, extra = CLI_RUNS[name]
    if "--native-parse" in extra:
        ensure_reference_native()
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        rep, recs = _cli(side, corpus, tmp_path, inp, extra)
        got[side.name] = (image(rep), _shape(recs), rep["totals"]["lines_total"])
        reset_all()
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    shape, lines = got["port"][1], got["port"][2]
    # a throughput event a source batch (v6 chunks of text runs step
    # without one), the final snapshot counts every line
    assert shape["events"]["throughput"] >= math.ceil(lines / 512) * (inp == "text")
    assert shape["final_lines"] == lines
    assert {"retry", "device_mem"} <= set(shape["final_keys"])
    # the prefetch queue's sampler, on every prefetched run
    assert ("ingest" in shape["sampler_keys"]) == ("0" not in extra)
    if "--checkpoint-every" in extra:
        assert shape["events"]["checkpoint"] >= 2


def test_unwritable_metrics_out_is_a_usage_error_in_both(corpus, tmp_path, monkeypatch, capsys):
    ref_one_device(monkeypatch)
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    msgs = {}
    for side in BOTH:
        extra = ["--device", "cpu"] if side is PORT else []
        capsys.readouterr()
        assert side.cli.main(["run", "--ruleset", corpus["prefix"], "--logs", corpus["text"],
                              "--metrics-out", str(blocker / "m.jsonl"), *extra]) == 2, side.name
        msgs[side.name] = capsys.readouterr().err.split(":")[0:2]
        assert not side.obs.metrics_active()
    assert msgs["port"] == msgs["ref"] == ["error", " cannot open --trace-out/--metrics-out target"]


def test_oracle_refuses_metrics_and_profile_flags_as_the_reference(corpus, tmp_path, capsys):
    cfg = os.path.join(os.path.dirname(corpus["prefix"]), "fw1.cfg")
    from tests._torch_faultkit import CFG6

    with open(cfg, "w", encoding="utf-8") as f:
        f.write(CFG6)
    for flag in (("--metrics-out", str(tmp_path / "m.jsonl")),
                 ("--profile-dir", str(tmp_path / "p"))):
        for side in BOTH:
            capsys.readouterr()
            rc = side.cli.main(["run", "--ruleset", corpus["prefix"], "--logs", corpus["text"],
                                "--backend", "oracle", "--acl-configs", cfg, *flag])
            assert rc == 2 and flag[0] in capsys.readouterr().err, side.name


def test_profile_dir_on_the_cpu_writes_a_trace_and_keeps_the_report(corpus, tmp_path,
                                                                     monkeypatch, capsys):
    ref_one_device(monkeypatch)
    got = {}
    for side in BOTH:
        prof = tmp_path / f"prof-{side.name}"
        rep, _recs = _cli(side, corpus, tmp_path, "text", ("--prefetch-depth", "2",
                                                           "--profile-dir", str(prof)))
        got[side.name] = image(rep)
        assert any(prof.rglob("*")), side.name
        reset_all()
    assert got["port"] == got["ref"]
    err = capsys.readouterr().err
    traces = list((tmp_path / "prof-port").glob("profile-*.pt.trace.json"))
    assert len(traces) == 1 and str(traces[0]) in err
    with open(traces[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    # the CPU ops of the run's steps
    assert sum(1 for e in events if str(e.get("name", "")).startswith("aten::")) > 0


def test_profile_dir_over_a_distributed_cpu_run_in_process(corpus, tmp_path):
    """The distributed loop enters the profiler too (the reference's does
    not): a one-process gloo job writes its trace and the plain report."""
    from ruleset_analysis_tpu_torch.cli import main

    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prof = tmp_path / "prof"
    out = tmp_path / "r.json"
    rc = main(["run", "--ruleset", corpus["prefix"], "--logs", corpus["text"], "--device", "cpu",
               "--batch-size", "512", "--distributed", "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", "1", "--process-id", "0", "--metrics-out",
               str(tmp_path / "m.jsonl"), "--profile-dir", str(prof), "--json", "--out",
               str(out)])
    assert rc == 0
    assert len(list(prof.glob("profile-*.pt.trace.json"))) == 1
    recs = _records(str(tmp_path / "m.jsonl"))
    with open(out, encoding="utf-8") as f:
        rep = json.load(f)
    assert recs[-1]["kind"] == "final" and recs[-1]["lines"] == rep["totals"]["lines_total"]
    assert recs[-1]["device_mem"] == devprof.device_memory_gauges()


def test_metrics_math_helpers_are_finite():
    for m in MODS.values():
        assert all(math.isfinite(b) for b in m.LATENCY_BUCKET_BOUNDS)
    assert metrics.LATENCY_BUCKET_BOUNDS == rmetrics.LATENCY_BUCKET_BOUNDS
    assert obs.DEFAULT_METRICS_EVERY == REF.obs.DEFAULT_METRICS_EVERY
    assert faults.SITES["metrics.snapshot.fail"] == REF.faults.SITES["metrics.snapshot.fail"]
