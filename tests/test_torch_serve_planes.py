"""Serve's planes in the port against the reference: lineage, chaos, the
latency histograms and the static analysis.

Counterparts of the serve cases of ``tests/test_lineage.py`` (the ledger,
its routes and the SLO gauges; the disarmed plane; an aborted
``lineage.append``), ``tests/test_chaos.py`` (the twelve seeded
listener/reload schedules, with the same seeds, and the WAL hard abort
with resume), ``tests/test_flightrec.py`` (receipt-to-publish latency
histograms on ``/metrics``, JSON and Prometheus) and
``tests/test_staticanalysis.py`` (the static plane across a failed and a
successful reload; serve without it).

Lines arrive through ``tail0:`` spools, windows are ``lines:N``, and
faults come from fault plans, so no case waits on load.  A schedule's
windows are held to the reference's offline run over the lines delivered
to them; the other cases compare the two packages' published files and
HTTP bodies (``tests/_torch_servekit.py``).
"""

import json
import os
import random
import re

import pytest
import torch

pytest.importorskip("jax")

from ruleset_analysis_tpu.errors import AnalysisError as RAnalysisError  # noqa: E402
from ruleset_analysis_tpu.runtime import faults as rfaults  # noqa: E402
from ruleset_analysis_tpu.runtime import staticanalysis as rsa  # noqa: E402
from ruleset_analysis_tpu.runtime.wal import WriteAheadLog as RWal  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import faults, serve  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import staticanalysis as sa_mod  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.metrics import quantile_from_prom  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.report import (  # noqa: E402
    lineage_frontier, seal_lineage,
)
from ruleset_analysis_tpu_torch.runtime.wal import LineageLog, WriteAheadLog  # noqa: E402
from tests._torch_faultkit import CFG6, FAST_RETRY, STALL_SEC, image, mixed_lines  # noqa: E402
from tests._torch_servekit import (  # noqa: E402
    PORT, REF, SIDES, assert_same_files, assert_same_http, get_json, get_text, http_code,
    norm, serve_run, wait_for, write_lines,
)
from tests.test_staticanalysis import SERVE_NEW_CFG, SERVE_OLD_CFG  # noqa: E402

RUN_CFG = dict(batch_size=128, prefetch_depth=0)
WL = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The lineage suite's corpus: 2 ACLs x 8 rules, 500 lines."""
    td = tmp_path_factory.mktemp("tplanes")
    cfg_text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=0, v6_fraction=0.25)
    packed = PORT.packed(cfg_text, "fw1")
    prefix = str(td / "rules")
    pack.save_packed(packed, prefix)
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 500, seed=1), seed=1)
    return {"prefix": prefix, "lines": lines}


def tail_scfg(d, **kw):
    base = dict(listen=(f"tail0:{d / 'spool.log'}",), ring=4, serve_dir=str(d / "serve"),
                stop_after_sec=90, reload_watch=False, queue_lines=10_000,
                checkpoint_every_windows=0)
    base.update(kw)
    return base


def side_dir(tmp_path, side):
    d = tmp_path / side.name
    d.mkdir(exist_ok=True)
    return d


def prom_names(text: str) -> set:
    return {m.group(1) for m in re.finditer(r"^([a-z_]+)[{ ]", text, re.M)}


# ---------------------------------------------------------------------------
# Lineage (tests/test_lineage.py).
# ---------------------------------------------------------------------------


def test_serve_lineage_e2e_ledger_routes_and_slo_gauges(corpus, tmp_path):
    """Two windows of the same lines: sealed records on /lineage, in the
    ledger and in each window report; the SLO gauges on /metrics and its
    Prometheus rendering; no trend events for steady traffic."""
    lines = corpus["lines"][:WL]

    def script(drv, http):
        spool = drv.scfg.listen[0].split(":", 1)[1]
        wait_for(lambda: drv.lineage_records_total >= 1 and drv.slo.windows_observed >= 1,
                 60, "window 0")
        write_lines(spool, lines, mode="a")
        wait_for(lambda: drv.lineage_records_total >= 2 and drv.slo.windows_observed >= 2,
                 60, "window 1")
        m = get_json(http, "/metrics")
        prom = get_text(http, "/metrics?format=prom")
        return {"/lineage": get_json(http, "/lineage"),
                "/lineage/window/1": get_json(http, "/lineage/window/1"),
                "code /lineage/window/9": http_code(http, "/lineage/window/9"),
                "metrics": {k: m[k] for k in (
                    "lineage_records_total", "trend_events_total", "slo_objectives",
                    "slo_windows_observed", "slo_breached", "slo_breaches_total")},
                "metrics keys": sorted(m),
                "build_info keys": sorted(m["build_info"]),
                "prom names": sorted(prom_names(prom)),
                "prom lines": sorted(ln for ln in prom.splitlines() if ln.startswith((
                    "ra_serve_lineage_records_total", "ra_serve_slo_bound")))}

    runs = {}
    for side in SIDES:
        d = side_dir(tmp_path, side)
        write_lines(str(d / "spool.log"), lines)
        runs[side.name] = serve_run(
            side, corpus["prefix"], side.cfg(**RUN_CFG),
            side.scfg(**tail_scfg(d, window_lines=WL,
                                  slo="p99_publish_ms<=60000,drop_rate<=0.5")), script)
    ref, port = runs["ref"], runs["port"]
    # the build info names each package's own framework (jax / torch)
    assert ref.http.pop("build_info keys") != port.http.pop("build_info keys")
    assert_same_files(ref, port)
    assert_same_http(ref, port)
    tail = port.http["/lineage"]
    assert tail["records_total"] == 2 and [r["window"] for r in tail["records"]] == [0, 1]
    ledger = port.files["lineage.jsonl"]
    for w, r in enumerate(ledger):
        assert r["kind"] == "window" and r["path"] == "live" and r["term"] == 0
        assert seal_lineage(dict(r))["crc"] == r["crc"]
        assert port.drv.lineage_record(w) == r
    assert lineage_frontier(ledger) == {"windows": 2, "last_complete": 1,
                                        "first_incomplete": None, "gaps": []}
    assert port.http["metrics"]["slo_objectives"] == 2
    assert port.http["metrics"]["trend_events_total"] == 0
    assert "trend_events" not in port.files["diff-000001.json"]
    assert 'ra_serve_slo_bound{objective="drop_rate"} 0.5' in port.http["prom lines"]


def test_serve_lineage_disarmed_has_no_plane(corpus, tmp_path):
    runs = {}
    for side in SIDES:
        d = side_dir(tmp_path, side)
        write_lines(str(d / "spool.log"), corpus["lines"][:WL])
        runs[side.name] = serve_run(
            side, corpus["prefix"], side.cfg(**RUN_CFG),
            side.scfg(**tail_scfg(d, window_lines=WL, max_windows=1, lineage=False,
                                  http="off")))
    assert_same_files(runs["ref"], runs["port"])
    port = runs["port"]
    assert "lineage.jsonl" not in port.files
    assert "lineage" not in port.files["window-000000.json"]["totals"]
    assert "lineage_records_total" not in port.drv.metrics_gauges()


def test_serve_lineage_append_chaos_never_publishes_without_record(corpus, tmp_path):
    """An armed lineage.append aborts the serve typed before the window
    file: no window is published without its record, the ledger is empty
    and readable."""
    runs = {}
    for side, err in ((REF, RAnalysisError), (PORT, AnalysisError)):
        d = side_dir(tmp_path, side)
        write_lines(str(d / "spool.log"), corpus["lines"][:WL])
        runs[side.name] = serve_run(
            side, corpus["prefix"], side.cfg(**RUN_CFG, fault_plan="lineage.append@1"),
            side.scfg(**tail_scfg(d, window_lines=WL, max_windows=2, http="off")),
            expect_error=err)
    assert_same_files(runs["ref"], runs["port"])
    port = runs["port"]
    assert type(port.error).__name__ == type(runs["ref"].error).__name__ == "InjectedFault"
    assert "window-000000.json" not in port.files and "latest.json" not in port.files
    assert LineageLog.read(os.path.join(port.drv.scfg.serve_dir, LineageLog.NAME)) == []


# ---------------------------------------------------------------------------
# Chaos (tests/test_chaos.py): seeded listener/reload schedules.
# ---------------------------------------------------------------------------

SERVE_W = 100  # lines per window
SERVE_LINES = 310  # 3 full windows + a tail that must never publish dirty
CHAOS_CFG = dict(batch_size=512, sketch=dict(cms_width=1 << 10, cms_depth=2, hll_p=6),
                 prefetch_depth=0, stall_timeout_sec=STALL_SEC, retry_policy=FAST_RETRY)


def serve_schedule(seed: int):
    """The reference's seeded schedule: the site cycles with the seed, the
    hit count comes from its rng (counts above SERVE_LINES never fire)."""
    sites = ["listener.drop", "listener.stall", "reload.midbatch", "stream.device_put.fail"]
    rng = random.Random(seed)
    site = sites[seed % len(sites)]
    if site == "listener.drop":
        at = rng.choice([5, 150, 205, 1000])
    elif site == "listener.stall":
        at = rng.choice([50, 1000])
    elif site == "reload.midbatch":
        at = 1
    else:
        at = rng.randint(1, 4)
    return site, at, faults.FaultPlan([faults.FaultSpec(site, at)], seed=seed)


@pytest.fixture(scope="module")
def chaos_corpus(tmp_path_factory):
    td = tmp_path_factory.mktemp("tchaos")
    packed = PORT.packed(CFG6, "fw1")
    prefix = str(td / "rules")
    pack.save_packed(packed, prefix)
    return {"prefix": prefix, "rpacked": REF.packed(CFG6, "fw1"),
            "lines": mixed_lines(SERVE_LINES, seed=77), "offline": {}}


def offline_image(c, seg: list[str], batch: int = CHAOS_CFG["batch_size"]) -> dict:
    """The reference's offline run over ``seg`` (cached: seeds share segments)."""
    key = (batch, tuple(seg))
    if key not in c["offline"]:
        rep = REF.run_stream(c["rpacked"], seg, REF.cfg(**{**CHAOS_CFG, "batch_size": batch}),
                             topk=5)
        img = image(rep)
        img["totals"].pop("window", None)
        c["offline"][key] = img
    return c["offline"][key]


@pytest.mark.parametrize("seed", range(12))
def test_chaos_serve_schedule(seed, chaos_corpus, tmp_path):
    """Every published window is the reference's offline run over exactly
    the lines delivered to it, or carries a WindowIncomplete marker with
    the exact drop count; a run ends in reports or a typed abort."""
    c = chaos_corpus
    lines = c["lines"]
    site, at, plan = serve_schedule(seed)
    write_lines(str(tmp_path / "spool.log"), lines)

    def script(drv, http):
        if site == "reload.midbatch":
            # the ruleset is unchanged; the site fires before the
            # (identity) migration starts
            drv.request_reload()

    run = serve_run(PORT, c["prefix"], PORT.cfg(**CHAOS_CFG, fault_plan=plan.to_str()),
                    PORT.scfg(**tail_scfg(tmp_path, window_lines=SERVE_W, max_windows=3,
                                          stop_after_sec=60, http="off")),
                    script, expect_error=None if site != "listener.stall" or at > SERVE_LINES
                    else AnalysisError, topk=5)
    if run.error is not None:
        # the wedged-listener watchdog escalating a stalled ingress
        assert site == "listener.stall"
        return
    summary = run.summary
    dropped_idx = at - 1 if site == "listener.drop" and at <= SERVE_LINES else None
    delivered = [ln for i, ln in enumerate(lines) if i != dropped_idx]
    n_full = min(3, len(delivered) // SERVE_W)
    # the bounded stop discards the queued backlog as counted drops and
    # publishes one final marked partial window for it
    backlog = len(delivered) - n_full * SERVE_W
    assert summary["windows_published"] == n_full + (1 if backlog else 0)
    marked = []
    for i in range(n_full):
        rep = run.files[f"window-{i:06d}.json"]
        got = image(rep)
        got["totals"].pop("window", None)
        assert got == offline_image(c, delivered[i * SERVE_W:(i + 1) * SERVE_W]), \
            f"seed {seed} ({site}@{at}): window {i} diverged"
        inc = serve.window_incomplete(rep)
        if inc:
            marked.append((i, inc))
    if backlog:
        prep = run.files[f"window-{n_full:06d}.json"]
        inc = serve.window_incomplete(prep)
        assert prep["totals"]["lines_total"] == 0
        assert inc and inc["drops"] == backlog
    forced = 1 if dropped_idx is not None else 0
    assert summary["drops"] == forced + backlog
    if dropped_idx is not None:
        assert len(marked) == 1 and marked[0][1]["drops"] == 1
    else:
        assert marked == []
    if site == "reload.midbatch":
        assert summary["reload_errors"] == 1 and summary["reloads"] == 0
        assert summary["quarantine_hits"] == 0


def test_chaos_serve_wal_hard_abort_resume(chaos_corpus, tmp_path):
    """Seed 0 of the reference's WAL drill: a device_put failure past the
    retries mid-window 1 (batch 32), then --resume: the interrupted
    window's delivered lines replay and publish as the reference's offline
    run over them, with no unaccounted drop, and as the reference's serve
    publishes them."""
    c = chaos_corpus
    lines = c["lines"]
    at = 5 + random.Random(0).randrange(2)
    cfg_kw = {**CHAOS_CFG, "batch_size": 32}
    runs, delivered = {}, {}
    for side, err, walcls in ((REF, RAnalysisError, RWal), (PORT, AnalysisError, WriteAheadLog)):
        d = side_dir(tmp_path, side)
        write_lines(str(d / "a.log"), lines[:180])
        write_lines(str(d / "b.log"), [])

        def scfg(spool, d=d):
            return side.scfg(**tail_scfg(d, window_lines=SERVE_W, stop_after_sec=60,
                                         http="off", checkpoint_every_windows=1, wal=True,
                                         listen=(f"tail0:{d / spool}",)))

        first = serve_run(side, c["prefix"],
                          side.cfg(**cfg_kw, fault_plan=f"stream.device_put.fail@{at}:99"),
                          scfg("a.log"), expect_error=err, topk=5)
        assert first.drv.windows_published == 1
        wal = walcls(str(d / "serve" / "wal"))
        delivered[side.name] = [ln for _s, ln, _t in wal.replay(SERVE_W)]
        wal.close()
        n = len(delivered[side.name])
        runs[side.name] = serve_run(
            side, c["prefix"], side.cfg(**cfg_kw, resume=True), scfg("b.log"),
            lambda drv, http, n=n: wait_for(lambda: drv.wal_replayed == n, 60, "replay"),
            topk=5)
    assert delivered["port"] == delivered["ref"] == lines[SERVE_W:SERVE_W + len(delivered["ref"])]
    assert_same_files(runs["ref"], runs["port"])
    summary = runs["port"].summary
    assert summary["wal"]["replayed"] == len(delivered["port"]) and summary["wal"]["lost"] == 0
    for wid, seg in ((0, lines[:SERVE_W]), (1, delivered["port"])):
        rep = runs["port"].files[f"window-{wid:06d}.json"]
        got = image(rep)
        got["totals"].pop("window", None)
        assert got == offline_image(c, seg, 32), f"window {wid}"
        inc = serve.window_incomplete(rep)
        assert inc is None or (inc["drops"] == 0 and "wal_lost" not in inc["reasons"])
    assert summary["drops"] == 0


# ---------------------------------------------------------------------------
# Latency histograms on /metrics (tests/test_flightrec.py).
# ---------------------------------------------------------------------------


def test_serve_latency_histograms_json_and_prom_agree(corpus, tmp_path):
    """The receipt-to-publish histogram: JSON percentile gauges, a
    Prometheus histogram whose bucket-derived p99 equals them, and the
    window and cumulative reports' totals.latency; the same metric names
    and keys as the reference's."""
    lines = corpus["lines"][:200]

    def script(drv, http):
        wait_for(lambda: drv.lineage_records_total >= 2, 90, "two windows")
        m = get_json(http, "/metrics")
        prom = get_text(http, "/metrics?format=prom")
        return {"m": m, "prom": prom, "report": get_json(http, "/report"),
                "cum": get_json(http, "/report/cumulative")}

    runs = {}
    for side in SIDES:
        d = side_dir(tmp_path, side)
        write_lines(str(d / "spool.log"), lines)
        runs[side.name] = serve_run(side, corpus["prefix"], side.cfg(**RUN_CFG),
                                    side.scfg(**tail_scfg(d, window_lines=100)), script)
    got = runs["port"].http
    m, prom = got["m"], got["prom"]
    assert m["latency_ingest_to_publish_count"] >= 200
    p99 = m["latency_ingest_to_publish_p99_sec"]
    assert p99 > 0
    name = "ra_serve_ingest_to_publish_seconds"
    assert f"# TYPE {name} histogram" in prom and f'{name}_bucket{{le="+Inf"}}' in prom
    assert quantile_from_prom(prom, name, 0.99) == p99
    assert "ra_serve_latency_ingest_to_publish_p99_sec" in prom
    lat = got["report"]["totals"]["latency"]["ingest_to_publish"]
    assert lat["count"] >= 100 and lat["p99_sec"] > 0
    assert got["cum"]["totals"]["latency"]["ingest_to_publish"]["count"] >= 200
    ref = runs["ref"].http
    assert sorted(m) == sorted(ref["m"])
    # the build info's labels name each package's framework
    assert prom_names(prom) == prom_names(ref["prom"])
    assert norm(got["report"]) == norm(ref["report"])


# ---------------------------------------------------------------------------
# The static plane (tests/test_staticanalysis.py).
# ---------------------------------------------------------------------------


def test_serve_static_plane_end_to_end(tmp_path):
    """Verdicts served before any traffic; a window joins them; a reload
    whose re-analysis fails (analyze.tile) changes nothing; a successful
    one reuses the unchanged ACL's verdicts; the reference's bodies."""
    old = PORT.packed(SERVE_OLD_CFG, "fws")
    new = PORT.packed(SERVE_NEW_CFG, "fws")
    lines = synth.render_syslog(old, synth.synth_tuples(old, 120, seed=5), seed=5)

    def script(drv, http):
        port = isinstance(drv, serve.ServeDriver)
        fmod = faults if port else rfaults
        spool = drv.scfg.listen[0].split(":", 1)[1]
        out = {"static0": get_json(http, "/report/static")}
        g = get_json(http, "/metrics")
        out["gauges"] = [k for k in g if k.startswith("static_analysis_")]
        out["prom"] = sorted(n for n in prom_names(get_text(http, "/metrics?format=prom"))
                             if "static" in n)
        write_lines(spool, lines[:100], mode="a")
        wait_for(lambda: drv.window_report(0) is not None, 60, "first rotation")
        out["w0"] = get_json(http, "/report/window/0")
        pack.save_packed(new, drv.prefix)
        fmod.arm(fmod.FaultPlan.parse("analyze.tile@1"))
        try:
            drv.request_reload()
            wait_for(lambda: drv.health()["reload_errors"] == 1, 30, "failed reload")
        finally:
            fmod.disarm()
        out["health"] = {k: drv.health()[k] for k in ("reloads", "reload_errors")}
        out["still"] = get_json(http, "/report/static")
        drv.request_reload()
        wait_for(lambda: drv.health()["reloads"] == 1, 30, "reload")
        out["static1"] = get_json(http, "/report/static")
        return out

    runs = {}
    for side in SIDES:
        d = side_dir(tmp_path, side)
        pack.save_packed(old, str(d / "fws"))
        write_lines(str(d / "spool.log"), [])
        runs[side.name] = serve_run(side, str(d / "fws"), side.cfg(**RUN_CFG),
                                    side.scfg(**tail_scfg(d, window_lines=100,
                                                          static_analysis=True)), script)
    ref, port = runs["ref"], runs["port"]
    assert_same_http(ref, port)
    assert_same_files(ref, port)
    got = port.http
    st = got["static0"]
    assert st["meta"]["complete"] is True and st["meta"]["dead"] == 1
    verd = {v["rule"]: v["verdict"] for v in st["verdicts"]}
    assert verd["fws A 2"] == sa_mod.CONFLICT == rsa.CONFLICT
    assert sorted(got["gauges"]) == ["static_analysis_age_sec", "static_analysis_duration_sec"]
    assert "fws A 2" in got["w0"]["totals"]["static"]["unused_classes"][sa_mod.CLASS_SAFE]
    assert got["health"] == {"reloads": 0, "reload_errors": 1}
    assert got["still"]["meta"]["n_rules"] == old.n_rules and got["still"]["meta"]["complete"]
    st2 = got["static1"]
    assert st2["meta"]["n_rules"] == new.n_rules
    assert st2["meta"]["reused_acls"] == 1 and st2["meta"]["analyzed_acls"] == 1
    assert {v["rule"]: v["verdict"] for v in st2["verdicts"]}["fws B 2"] == sa_mod.REDUNDANT
    assert port.summary["reload_errors"] == 1
    assert port.files["static.json"]["meta"]["n_rules"] == new.n_rules


def test_serve_without_static_analysis_unchanged(tmp_path):
    """Analysis off (the default): no endpoint, no gauges, no report fields."""
    old = PORT.packed(SERVE_OLD_CFG, "fws")
    lines = synth.render_syslog(old, synth.synth_tuples(old, 50, seed=6), seed=6)

    def script(drv, http):
        out = {"static": http_code(http, "/report/static"),
               "gauge": "static_analysis_age_sec" in get_json(http, "/metrics")}
        wait_for(lambda: drv.window_report(0) is not None, 60, "rotation")
        out["w0"] = get_json(http, "/report/window/0")
        return out

    runs = {}
    for side in SIDES:
        d = side_dir(tmp_path, side)
        pack.save_packed(old, str(d / "fws"))
        write_lines(str(d / "spool.log"), lines)
        runs[side.name] = serve_run(side, str(d / "fws"), side.cfg(**RUN_CFG),
                                    side.scfg(**tail_scfg(d, window_lines=50)), script)
    assert_same_http(runs["ref"], runs["port"])
    got = runs["port"].http
    assert got["static"][0] == 404 and got["gauge"] is False
    assert "static" not in got["w0"]["totals"]
    assert all("verdict" not in e for e in got["w0"]["per_rule"])
    assert json.dumps(got["static"][1]).startswith('{"error": "static analysis disabled')
