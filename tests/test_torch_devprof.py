"""The port's device profiling (stages.py, runtime/devprof.py,
tools/trace_diff.py, tools/trace_attrib.py) against the reference's.

At the reference suite's geometry (synth seed 7, 3 ACLs x 8 rules, batch
512, CMS 1 << 10 x 2, HLL p 6), captured through the port with
``device="cpu"``, where every hand kernel's wrapper runs its plain
version and a device event is a top-level CPU op:

- **Parity**: ``STAGES``, ``SCOPE_RE``, ``scope_of``,
  ``classify_event_name`` and ``DevprofConfig``'s refusals equal the
  reference's; a capture's summary keys equal the reference capture's
  but for the differences on purpose (no ``hlo_instructions``, ``flops``,
  ``bytes_accessed``; ``device_ops``, ``kernel_records``,
  ``records_short`` added), and its window counts equal them; the CLI's
  refusals exit 2 with the reference's words; ``trace_diff`` prints the
  reference tool's table, CSV and JSON.  One module-scoped reference
  capture (it re-lowers and compiles the step).
- **Capture windows**: the reference suite's cases (sync text v4,
  prefetch wire, the v6 program, a window longer than the stream), the
  report bit-identical armed and disarmed and equal to the reference's,
  a profiler that fails to start or stop, the four ``devprof.capture``
  chaos schedules, a mesh of two CPU shards (the only place ``ra.merge``
  shows: the one-device step has no merge).
- **Attribution** over hand-made Chrome traces: correlation into a
  stage range, nesting (the outermost range wins), events outside every
  program, unattributed events, a dropped record (``records_short``) and
  the launch-log fallback.
- ``stages.scope`` costs nothing disarmed: it never reaches
  ``record_function``.
"""

import json
import os
import sys

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from tests._torch_faultkit import image, ref_one_device, reset_all  # noqa: E402
from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu import stages as rstages  # noqa: E402
from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import DevprofConfig as JDevprofConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import devprof as rdevprof  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu_torch import cli, stages  # noqa: E402
from ruleset_analysis_tpu_torch.config import (  # noqa: E402
    AnalysisConfig, DevprofConfig, SketchConfig,
)
from ruleset_analysis_tpu_torch.errors import InjectedFault  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import devprof, metrics, obs  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file, run_stream_wire  # noqa: E402
from ruleset_analysis_tpu_torch.tools import trace_attrib, trace_diff  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import trace_diff as rtrace_diff  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: summary keys the port leaves out on purpose (torch has no compiled
#: module and no cost analysis), and the ones it adds
NOT_PORTED = {"hlo_instructions", "flops", "bytes_accessed"}
PORT_ONLY = {"kernel_records", "records_short"}
PORT_ONLY_PROGRAM = {"device_ops"}


@pytest.fixture(autouse=True)
def _clean():
    devprof.shutdown()
    rdevprof.shutdown()
    reset_all()
    yield
    devprof.shutdown()
    rdevprof.shutdown()
    reset_all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference suite's corpus: one ruleset packed by each package,
    2600 text lines, and their .rawire in 512-row blocks."""
    td = tmp_path_factory.mktemp("devprof")
    cfg_text = synth.synth_config(n_acls=3, rules_per_acl=8, seed=7)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(cfg_text, "fw1")])
    tuples = synth.synth_tuples(packed, 2600, seed=18)
    log = str(td / "dp.log")
    with open(log, "w", encoding="utf-8") as f:
        f.write("\n".join(synth.render_syslog(packed, tuples, seed=19)) + "\n")
    wirep = str(td / "dp.rawire")
    wire.convert_logs(packed, [log], wirep, batch_size=512, block_rows=512)
    prefix = str(td / "packed")
    pack.save_packed(packed, prefix)
    return {"packed": packed, "rpacked": rpacked, "prefix": prefix, "log": log, "wire": wirep}


@pytest.fixture(scope="module")
def corpus6(tmp_path_factory):
    """Mixed v4 + v6 lines, so a capture sees the step.v6 program too."""
    td = tmp_path_factory.mktemp("devprof6")
    cfg_text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=27, v6_fraction=0.4)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 1400, seed=28), seed=29)
    lines += synth.render_syslog6(packed, synth.synth_tuples6(packed, 1000, seed=30), seed=31)
    log = str(td / "dp6.log")
    with open(log, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return packed, log


def _cfg(depth=0, **kw):
    return AnalysisConfig(batch_size=512, device="cpu", prefetch_depth=depth,
                          stall_timeout_sec=5.0,
                          sketch=SketchConfig(cms_width=1 << 10, cms_depth=2, hll_p=6), **kw)


def _rcfg(depth=0, **kw):
    return JConfig(batch_size=512, prefetch_depth=depth, stall_timeout_sec=5.0,
                   sketch=JSketch(cms_width=1 << 10, cms_depth=2, hll_p=6), **kw)


@pytest.fixture(scope="module")
def baselines(corpus):
    """The port's disarmed reports: wire at prefetch 0 and 2, sync text."""
    out = {d: run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(d)) for d in (0, 2)}
    out["text"] = run_stream_file(corpus["packed"], [corpus["log"]], _cfg(0), native=False)
    return out


@pytest.fixture(scope="module")
def ref_capture(corpus, tmp_path_factory):
    """The reference's sync text v4 capture (steps 2, warmup 1) on a
    one-device mesh: (report, summary)."""
    rdevprof.shutdown()
    rdevprof.arm(str(tmp_path_factory.mktemp("refdp")), steps=2, warmup=1)
    try:
        rep = rstream.run_stream_file(corpus["rpacked"], [corpus["log"]], _rcfg(0), native=False,
                                      mesh=rmesh.make_mesh(jax.devices()[:1]))
    finally:
        rdevprof.shutdown()
    return rep, rep.totals["devprof"]


def _well_formed(summary: dict, steps: int) -> None:
    assert summary["steps_profiled"] == steps
    assert summary["attributed_frac"] >= 0.9, summary
    assert summary["unattributed"]["device_us"] >= 0.0
    assert summary["stages"], "no stages attributed"
    assert abs(sum(st["pct"] for st in summary["stages"].values())
               + summary["unattributed"]["pct"] - 100.0) < 0.1
    for prog in summary["programs"].values():
        assert prog["dispatches"] >= 1
        assert prog["device_ops"] > 0
        assert prog["stages_static"]
    assert set(s for s in summary["stages"]) <= set(stages.STAGES)


# ---------------------------------------------------------------------------
# The taxonomy and the classifier
# ---------------------------------------------------------------------------


def test_stages_and_scope_re_equal_the_references():
    assert stages.STAGES == rstages.STAGES
    assert stages.SCOPE_RE.pattern == rstages.SCOPE_RE.pattern
    assert devprof.STAGES is stages.STAGES and devprof.scope_of is stages.scope_of


@pytest.mark.parametrize("path", [
    "jit(f)/jit(main)/ra.counts/scatter-add",
    "jit(f)/ra.talk/ra.cms/scatter",
    "jit(f)/jit(main)/broadcast",
    "ra.merge/all-reduce.3",
    "step.flat",
    "ra.match6",
    "ra.unknown_stage/x",
    "xra.hll",
    "",
    None,
    "ra./ra.topk",
    "ra.sort/ra.merge",
])
def test_scope_of_equals_the_references(path):
    assert stages.scope_of(path) == rstages.scope_of(path)


@pytest.mark.parametrize("name,args", [
    ("fusion.5", None),
    ("fusion.5", {"long_name": "jit(step)/ra.hll/scatter-max"}),
    ("ra.merge/all-reduce.3", None),
    ("copy.1", {"tf_op": "ra.unpack/x"}),
    ("copy.1", {"name": "ra.talk"}),
    ("copy.1", {"op_name": "a/ra.cms/b", "long_name": "ra.hll"}),
    ("copy.1", {"hlo_op": "ra.overlap"}),
    ("copy.1", {"other": "ra.match"}),
    ("copy.1", {"long_name": 7}),
    ("(anonymous namespace)::first_match_kernel(unsigned int const*)", {}),
    ("ra.topk", {"long_name": "ra.match"}),
])
def test_classify_event_name_equals_the_references(name, args):
    assert devprof.classify_event_name(name, args) == rdevprof.classify_event_name(name, args)


@pytest.mark.parametrize("kw", [
    dict(out_dir=""), dict(out_dir="x", steps=0), dict(out_dir="x", steps=4097),
    dict(out_dir="x", warmup=-1), dict(out_dir="x", warmup=4097),
    dict(out_dir="x"), dict(out_dir="x", steps=1, warmup=0),
    dict(out_dir="x", steps=4096, warmup=4096),
])
def test_devprof_config_refuses_what_the_reference_refuses(kw):
    def outcome(cls):
        try:
            c = cls(**kw)
        except ValueError as e:
            return str(e)
        return (c.out_dir, c.steps, c.warmup)

    assert outcome(DevprofConfig) == outcome(JDevprofConfig)
    assert (DevprofConfig.steps, DevprofConfig.warmup) == (JDevprofConfig.steps,
                                                           JDevprofConfig.warmup)


def test_kernel_stages_name_every_hand_kernel_and_registered_stages():
    src = "".join(open(os.path.join(ROOT, "ruleset_analysis_tpu_torch", "csrc", f),
                       encoding="utf-8").read()
                  for f in os.listdir(os.path.join(ROOT, "ruleset_analysis_tpu_torch", "csrc")))
    for kernel, sts in stages.KERNEL_STAGES.items():
        assert f"\n{kernel}(" in src, kernel
        assert sts and set(sts) <= set(stages.STAGES)
    assert stages.KERNEL_STAGES["reg_tail_kernel"][0] == "ra.talk"
    assert set(stages.KERNEL_STAGES["match_hist_kernel"]) == {"ra.match", "ra.counts"}
    assert set(devprof.KERNEL_COUNTERS) <= set(stages.KERNEL_STAGES)
    assert set(devprof.launch_counts()) == set(devprof.KERNEL_COUNTERS)


@pytest.mark.parametrize("name,want", [
    ("(anonymous namespace)::first_match_kernel(unsigned int const*, int)", "first_match_kernel"),
    ("(anonymous namespace)::reg_tail_kernel(int const*, int const*, Lines, int)",
     "reg_tail_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long> >(int)",
     "vectorized_elementwise_kernel"),
    ("Memset (Device)", "Memset"),
    ("", ""),
])
def test_kernel_base(name, want):
    assert devprof.kernel_base(name) == want


# ---------------------------------------------------------------------------
# scope(): free when no profiler of the port is live
# ---------------------------------------------------------------------------


def test_scope_disarmed_never_calls_record_function(corpus, baselines, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler live")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not stages.live()
    assert stages.scope("ra.match") is stages.scope("ra.cms")
    rep = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(0))
    assert image(rep) == image(baselines[0])


def test_scope_live_enters_record_function_and_tracks_the_outermost_stage(monkeypatch):
    entered = []

    class Rec:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(torch.profiler, "record_function", Rec)
    stages.set_live(True)
    try:
        with stages.scope("ra.talk"):
            with stages.scope("ra.cms"):
                assert stages.current_stage() == "ra.talk"
        assert stages.current_stage() is None
    finally:
        stages.set_live(False)
    assert entered == ["ra.talk", "ra.cms"]
    assert not stages.live()


def test_note_kernel_logs_only_while_armed():
    stages.note_kernel("first_match_kernel")  # no log armed: nothing to do
    log = []
    stages._log, stages._program = log, "step.v6"
    try:
        stages.note_kernel("first_match6_kernel")
    finally:
        stages._log, stages._program = None, None
    assert log == [("step.v6", None, "first_match6_kernel")]


# ---------------------------------------------------------------------------
# Capture windows
# ---------------------------------------------------------------------------


def test_capture_sync_text_v4(corpus, baselines, tmp_path):
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    rep = run_stream_file(corpus["packed"], [corpus["log"]], _cfg(0), native=False)
    dp = rep.totals["devprof"]
    _well_formed(dp, 2)
    static = dp["programs"]["step.flat"]["stages_static"]
    for stage in ("ra.unpack", "ra.match", "ra.counts", "ra.cms", "ra.talk", "ra.topk"):
        assert stage in static, f"{stage} missing from the step program"
    assert "ra.merge" not in static  # the one-device step has no merge
    assert {f["name"] for f in dp["programs"]["step.flat"]["fusions"]} == {
        "first_match_kernel", "reg_tail_kernel", "select_kernel"}
    assert [c["name"] for c in dp["cross_stage_fusions"]] == ["reg_tail_kernel"]
    # the plain versions launch nothing: no records, no shortfall
    assert all(v == {"launches": 0, "records": 0} for v in dp["kernel_records"].values())
    assert dp["records_short"] is False
    assert dp["backend"] == "cpu" and dp["window_wall_sec"] > 0
    assert os.path.exists(dp["trace_path"])
    disk = json.load(open(tmp_path / "dp" / "devprof.json"))
    assert disk == json.loads(json.dumps(dp))
    assert image(rep) == image(baselines["text"])


def test_capture_prefetch_wire(corpus, tmp_path):
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    rep = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(2))
    dp = rep.totals["devprof"]
    _well_formed(dp, 2)
    assert dp["programs"]["step.flat"]["dispatches"] == 2


def test_capture_stacked_program(corpus, tmp_path):
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    rep = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(0, layout="stacked"))
    dp = rep.totals["devprof"]
    _well_formed(dp, 2)
    assert set(dp["programs"]) == {"step.stacked"}


def test_capture_v6_program(corpus6, tmp_path):
    packed, log = corpus6
    # warmup 0 and a window longer than the stream: every dispatch of both programs
    devprof.arm(str(tmp_path / "dp"), steps=64, warmup=0)
    rep = run_stream_file(packed, [log], _cfg(0), native=False)
    dp = rep.totals["devprof"]
    assert dp["steps_profiled"] >= 4
    assert dp["attributed_frac"] >= 0.9
    assert {"step.flat", "step.v6"} <= set(dp["programs"])
    v6 = dp["programs"]["step.v6"]
    assert "ra.match6" in v6["stages_static"]
    assert {f["name"] for f in v6["fusions"]} >= {"first_match6_kernel", "reg_tail_kernel"}


def test_capture_window_longer_than_the_stream_reports_itself(corpus, tmp_path):
    devprof.arm(str(tmp_path / "dp"), steps=4, warmup=100)
    rep = run_stream_file(corpus["packed"], [corpus["log"]], _cfg(0), native=False)
    dp = rep.totals["devprof"]
    assert dp["steps_profiled"] == 0
    assert "note" in dp and "capture window" in dp["note"]
    assert not os.path.exists(tmp_path / "dp" / "devprof.json")


def test_fused_and_scan_captures_diff_as_a_changed_boundary(corpus, tmp_path, capsys):
    outs = {}
    for impl in ("scan", "fused"):
        devprof.shutdown()
        devprof.arm(str(tmp_path / impl), steps=2, warmup=1, label=impl)
        run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(0, match_impl=impl))
        outs[impl] = str(tmp_path / impl)
    d = trace_diff.diff_captures(trace_diff.load_capture(outs["scan"]),
                                 trace_diff.load_capture(outs["fused"]))
    assert d["fusion_boundaries_changed"]
    ch = d["fusion_boundary_changes"]["step.flat"]
    assert ["ra.counts", "ra.match", "x1"] in ch["only_B"]
    assert d["A"]["label"] == "scan" and d["B"]["label"] == "fused"
    assert trace_diff.main([outs["scan"], outs["fused"]]) == 0
    assert "fusion boundaries CHANGED" in capsys.readouterr().out


def test_report_bit_identical_armed_vs_disarmed_and_equal_to_the_reference(
        corpus, baselines, ref_capture, tmp_path):
    base = baselines[2]
    assert "devprof" not in base.totals
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    armed = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(2))
    assert "devprof" in armed.totals
    assert image(base) == image(armed)
    # the sync text capture against the reference's run of the same lines
    assert image(baselines["text"]) == image(ref_capture[0])


def test_summary_keys_and_window_equal_the_reference_capture(corpus, ref_capture, tmp_path):
    _rep, ref = ref_capture
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    rep = run_stream_file(corpus["packed"], [corpus["log"]], _cfg(0), native=False)
    dp = rep.totals["devprof"]
    for k in ("steps_profiled", "requested_steps", "warmup"):
        assert dp[k] == ref[k], k
    assert set(dp) - PORT_ONLY == set(ref) - NOT_PORTED
    assert set(dp["programs"]) == set(ref["programs"]) == {"step.flat"}
    for label, prog in dp["programs"].items():
        assert set(prog) - PORT_ONLY_PROGRAM == set(ref["programs"][label]) - NOT_PORTED
        assert prog["dispatches"] == ref["programs"][label]["dispatches"]
    assert set(dp["unattributed"]) == set(ref["unattributed"])
    assert set(dp["memory"]) == set(ref["memory"])
    for rows in (dp["stages"], ref["stages"]):
        for st in rows.values():
            assert set(st) == {"device_us", "pct", "events"}
    assert set(dp["stages"]) <= set(ref["programs"]["step.flat"]["stages_static"])


def test_gauges_obs_event_and_samplers(corpus, tmp_path):
    mf = str(tmp_path / "m.jsonl")
    obs.start_metrics(mf, 10.0)
    cap = devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    assert devprof.active_capture() is cap
    assert devprof.gauges() == {"devprof_steps_profiled": 0}
    run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(0))
    g = devprof.gauges()
    assert g["devprof_steps_profiled"] == 2 and g["devprof_attributed_frac"] >= 0.9
    assert g["devprof_top_stage"] in stages.STAGES
    assert devprof.finalize_if_armed() == cap.finalize()  # idempotent
    obs.shutdown()
    recs = [json.loads(ln) for ln in open(mf, encoding="utf-8")]
    (ev,) = [r for r in recs if r.get("kind") == "devprof"]
    assert ev["devprof_steps_profiled"] == 2
    final = recs[-1]
    assert final["devprof"]["devprof_steps_profiled"] == 2
    assert set(final["device_mem"].values()) == {None}
    devprof.shutdown()
    assert devprof.finalize_if_armed() is None and devprof.gauges() == {}


def test_mesh_of_two_cpu_shards_shows_ra_merge(corpus, tmp_path):
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    mesh = mesh_lib.make_mesh([torch.device("cpu")] * 2)
    rep = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(0), mesh=mesh)
    dp = rep.totals["devprof"]
    _well_formed(dp, 2)
    assert "ra.merge" in dp["stages"]
    assert "ra.merge" in dp["programs"]["step.flat"]["stages_static"]


# ---------------------------------------------------------------------------
# Failure model
# ---------------------------------------------------------------------------


def test_profiler_start_failure_is_a_clean_no_trace_run(corpus, baselines, tmp_path,
                                                       monkeypatch):
    def boom(device):
        raise RuntimeError("profiler backend unavailable")

    monkeypatch.setattr(devprof, "start_profiler", boom)
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    rep = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(0))
    dp = rep.totals["devprof"]
    assert dp["steps_profiled"] == 0
    assert "profiler start failed" in dp["error"]
    assert image(rep) == image(baselines[0])
    assert not os.path.exists(tmp_path / "dp" / "devprof.json")
    assert not stages.live()


def test_profiler_stop_failure_is_a_clean_no_trace_run(corpus, baselines, tmp_path,
                                                      monkeypatch):
    start = devprof.start_profiler

    def failing_stop(device):
        prof = start(device)
        real = prof.stop

        def stop():
            real()
            raise RuntimeError("trace buffer lost")

        prof.stop = stop
        return prof

    monkeypatch.setattr(devprof, "start_profiler", failing_stop)
    devprof.arm(str(tmp_path / "dp"), steps=2, warmup=1)
    rep = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(0))
    dp = rep.totals["devprof"]
    assert dp["steps_profiled"] == 0 and "profiler stop failed" in dp["error"]
    assert image(rep) == image(baselines[0])
    assert not os.path.exists(tmp_path / "dp" / "devprof.json")
    assert not stages.live() and stages._log is None


#: the reference suite's four schedules: the site fires at the window's
#: start (hit 1) or stop (hit 2), under the sync and prefetch loops
_CHAOS = [
    ("devprof.capture@1,seed=101", 0),
    ("devprof.capture@2,seed=102", 0),
    ("devprof.capture@1,seed=103", 2),
    ("devprof.capture@2,seed=104", 2),
]


@pytest.mark.parametrize("plan,depth", _CHAOS)
def test_chaos_capture_site(corpus, baselines, tmp_path, plan, depth):
    out = tmp_path / "dp"
    devprof.arm(str(out), steps=2, warmup=1)
    with pytest.raises(InjectedFault):
        run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(depth, fault_plan=plan))
    assert not os.path.exists(out / "devprof.json")
    devprof.shutdown()  # stops a dangling profiler (the stop seam's case)
    assert not stages.live() and stages._log is None
    again = run_stream_wire(corpus["packed"], [corpus["wire"]], _cfg(depth))
    assert image(again) == image(baselines[depth])


def test_device_memory_gauges_on_the_cpu():
    for dev in (None, torch.device("cpu"), "cpu"):
        g = devprof.device_memory_gauges(dev)
        assert g == {"device_mem_bytes_in_use": None, "device_mem_peak_bytes_in_use": None,
                     "device_mem_bytes_limit": None}
    assert set(devprof.device_memory_gauges()) == set(rdevprof.device_memory_gauges())


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli_pair(corpus, tmp_path, capsys, monkeypatch, extra, port_extra=()):
    ref_one_device(monkeypatch)
    base = ["run", "--ruleset", corpus["prefix"], "--logs", corpus["log"], *extra]
    rc_ref = rcli.main(base)
    err_ref = capsys.readouterr().err
    reset_all()
    rdevprof.shutdown()
    rc = cli.main([*base, *port_extra])
    err = capsys.readouterr().err
    return (rc, err), (rc_ref, err_ref)


@pytest.mark.parametrize("extra,words", [
    (("--distributed", "--num-processes", "2", "--process-id", "0", "--devprof-out",
      "{tmp}/never"), "single-controller"),
    (("--distributed", "--elastic", "--num-processes", "2", "--process-id", "0",
      "--devprof-out", "{tmp}/never"), "single-controller"),
    (("--devprof-steps", "9"), "--devprof-out"),
    (("--devprof-warmup", "0"), "--devprof-out"),
    (("--devprof-out", "{tmp}/d", "--profile-dir", "{tmp}/p"), "both drive"),
    (("--devprof-out", "{tmp}/d", "--devprof-steps", "0"), "cannot arm --devprof-out"),
    (("--devprof-out", "{tmp}/d", "--devprof-warmup", "5000"), "cannot arm --devprof-out"),
])
def test_cli_refusals_exit_2_with_the_references_words(corpus, tmp_path, capsys, monkeypatch,
                                                       extra, words):
    extra = tuple(a.replace("{tmp}", str(tmp_path)) for a in extra)
    (rc, err), (rc_ref, err_ref) = _cli_pair(corpus, tmp_path, capsys, monkeypatch, extra,
                                             ("--device", "cpu"))
    assert rc == rc_ref == 2
    assert words in err
    line = [ln for ln in err.splitlines() if words in ln][0]
    assert line.replace("torch.profiler", "jax.profiler") in err_ref
    assert not os.path.exists(tmp_path / "d" / "devprof.json")


def test_cli_oracle_refuses_devprof_out(corpus, tmp_path, capsys):
    cfg = str(tmp_path / "fw1.cfg")
    with open(cfg, "w", encoding="utf-8") as f:
        f.write(synth.synth_config(n_acls=3, rules_per_acl=8, seed=7))
    args = ["run", "--ruleset", corpus["prefix"], "--logs", corpus["log"], "--backend",
            "oracle", "--acl-configs", cfg, "--devprof-out", str(tmp_path / "d")]
    assert rcli.main(args) == 2
    ref_err = capsys.readouterr().err
    assert cli.main(args) == 2
    err = capsys.readouterr().err
    assert "--devprof-out" in err and "--devprof-out" in ref_err


@pytest.mark.parametrize("inp,depth", [("log", 0), ("wire", 2)])
def test_cli_capture_writes_devprof_json_and_keeps_the_report(corpus, tmp_path, capsys, inp,
                                                              depth):
    def run(*extra):
        out = str(tmp_path / f"r{len(extra)}.json")
        rc = cli.main(["run", "--ruleset", corpus["prefix"], "--logs", corpus[inp], "--device",
                       "cpu", "--batch-size", "512", "--cms-width", str(1 << 10),
                       "--cms-depth", "2", "--hll-p", "6", "--prefetch-depth", str(depth),
                       "--json", "--out", out, *extra])
        assert rc == 0
        with open(out, encoding="utf-8") as f:
            return json.load(f)

    plain = run()
    d = tmp_path / "dp"
    armed = run("--devprof-out", str(d), "--devprof-steps", "2", "--devprof-warmup", "1")
    assert f"devprof: {d / 'devprof.json'}" in capsys.readouterr().err
    assert image(plain) == image(armed)
    disk = json.load(open(d / "devprof.json"))
    assert disk == armed["totals"]["devprof"]
    assert disk["steps_profiled"] == 2 and disk["attributed_frac"] >= 0.9
    assert devprof.active_capture() is None and not stages.live()


# ---------------------------------------------------------------------------
# Attribution over hand-made Chrome traces
# ---------------------------------------------------------------------------

FM = "(anonymous namespace)::first_match_kernel(unsigned int const*, int)"
RT = "(anonymous namespace)::reg_tail_kernel(int const*, int const*, Lines, int)"
FM6 = "(anonymous namespace)::first_match6_kernel(Fields6, uint4 const*, int)"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long> >()"


def ann(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 7,
            "tid": tid}


def launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 2, "pid": 7,
            "tid": tid, "args": {"correlation": corr}}


def kern(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 9,
            "args": {"correlation": corr}}


def _window():
    """One step.flat dispatch: ra.match [10, 30], ra.talk [40, 80] holding
    ra.cms [45, 60]; a launch in each, one in no stage, one after the program."""
    return [
        ann("step.flat", 0, 100),
        ann("ra.match", 10, 20), launch(1, 15),
        ann("ra.talk", 40, 40), ann("ra.cms", 45, 15), launch(2, 50), launch(3, 70),
        launch(4, 90),
        launch(5, 150),
        kern(FM, 1, 200, 5.0), kern(FILL, 2, 210, 2.0), kern(RT, 3, 220, 8.0),
        kern("Memset (Device)", 4, 230, 1.0, cat="gpu_memset"),
        kern("Memcpy DtoH (Device -> Pinned)", 5, 300, 50.0, cat="gpu_memcpy"),
    ]


def test_attribution_correlates_a_kernel_into_its_stage_range():
    recs = devprof.attribute_events(_window(), programs={"step.flat"})
    fm = [r for r in recs if r["kernel"] == "first_match_kernel"][0]
    assert (fm["program"], fm["stage"], fm["via"]) == ("step.flat", "ra.match", "correlation")
    s = devprof.summarize_trace(_window(), {"step.flat": 1}, [],
                                {"first_match_kernel": 1, "reg_tail_kernel": 1})
    assert s["stages"]["ra.match"] == {"device_us": 5.0, "pct": round(500 / 16, 2),
                                       "events": 1}
    assert s["kernel_records"]["first_match_kernel"] == {"launches": 1, "records": 1}
    assert s["records_short"] is False
    assert [f["name"] for f in s["programs"]["step.flat"]["fusions"]] == [
        "first_match_kernel", "reg_tail_kernel"]


def test_attribution_nested_ranges_the_outermost_wins():
    s = devprof.summarize_trace(_window(), {"step.flat": 1})
    # the fill launched inside ra.talk/ra.cms, the tail inside ra.talk
    assert s["stages"]["ra.talk"]["device_us"] == 10.0
    assert s["stages"]["ra.talk"]["events"] == 2
    assert "ra.cms" not in s["stages"]


def test_attribution_skips_events_outside_every_program():
    s = devprof.summarize_trace(_window(), {"step.flat": 1})
    # the 50 us copy was launched after the program range ended
    assert s["device_us_total"] == 16.0
    assert s["programs"]["step.flat"]["device_ops"] == 4


def test_attribution_event_in_a_program_with_no_stage_is_unattributed():
    s = devprof.summarize_trace(_window(), {"step.flat": 1})
    assert s["unattributed"] == {"device_us": 1.0, "pct": round(100 / 16, 2)}
    assert s["attributed_frac"] == round(1 - 1 / 16, 4)
    assert s["programs"]["step.flat"]["stages_static"]["unattributed"] == {"ops": 1.0}


def test_attribution_dropped_record_sets_records_short():
    events = [e for e in _window() if e.get("name") != RT]
    s = devprof.summarize_trace(events, {"step.flat": 1}, [],
                                {"first_match_kernel": 1, "reg_tail_kernel": 2})
    assert s["kernel_records"]["reg_tail_kernel"] == {"launches": 2, "records": 0}
    assert s["records_short"] is True


def test_attribution_launch_log_fallback():
    """Hand kernel records with no launch record take the logged launches,
    in stream order; a non-hand kernel without one stays outside."""
    events = [ann("step.v6", 0, 100), ann("ra.match6", 10, 20),
              kern(FM6, 11, 300, 4.0), kern(FM6, 12, 400, 6.0), kern(FILL, 13, 500, 1.0)]
    log = [("step.v6", "ra.match6", "first_match6_kernel"),
           ("step.v6", "ra.match6", "first_match6_kernel")]
    recs = devprof.attribute_events(events, programs={"step.v6"}, launch_log=log)
    assert [r["via"] for r in recs] == ["log", "log", None]
    s = devprof.summarize_trace(events, {"step.v6": 2}, log, {"first_match6_kernel": 2})
    assert s["stages"] == {"ra.match6": {"device_us": 10.0, "pct": 100.0, "events": 2}}
    assert s["kernel_records"]["first_match6_kernel"] == {"launches": 2, "records": 2}
    assert s["programs"]["step.v6"]["device_ops"] == 1.0


def test_attribution_driver_launch_records_count_too():
    events = [ann("step.flat", 0, 100), ann("ra.match", 10, 20),
              launch(1, 15, cat="cuda_driver"), kern(FM, 1, 200, 5.0)]
    s = devprof.summarize_trace(events, {"step.flat": 1})
    assert s["stages"]["ra.match"]["events"] == 1


def test_attribution_on_the_cpu_counts_top_level_ops_only():
    def op(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 7,
                "tid": tid}

    events = [ann("step.flat", 0, 100), ann("ra.match", 10, 40),
              op("aten::sum", 12, 20), op("aten::sum", 13, 18), op("aten::fill_", 15, 2),
              op("aten::add", 35, 5), op("aten::mul", 60, 10), op("aten::copy_", 120, 3)]
    s = devprof.summarize_trace(events, {"step.flat": 1})
    assert s["stages"] == {"ra.match": {"device_us": 25.0, "pct": round(2500 / 35, 2),
                                        "events": 2}}
    assert s["unattributed"]["device_us"] == 10.0
    assert s["programs"]["step.flat"]["device_ops"] == 3.0


def test_select_rank_launches_come_from_the_launch_log():
    log = [("step.flat", "ra.topk", "select_kernel"),
           ("step.flat", "ra.topk", "select_rank_kernel")]
    s = devprof.summarize_trace([ann("step.flat", 0, 10)], {"step.flat": 1}, log,
                                {"select_kernel": 1})
    assert s["kernel_records"]["select_rank_kernel"] == {"launches": 1, "records": 0}
    assert s["records_short"] is True
    assert [f["name"] for f in s["programs"]["step.flat"]["fusions"]] == [
        "select_kernel", "select_rank_kernel"]


# ---------------------------------------------------------------------------
# trace_diff against the reference tool; trace_attrib over a real trace
# ---------------------------------------------------------------------------


def _synthetic_capture(step_us: dict, fusion_stages: list, steps=4) -> dict:
    """The reference suite's synthetic capture."""
    total = float(sum(step_us.values())) * steps
    return {
        "requested_steps": steps, "warmup": 1, "steps_profiled": steps, "backend": "cpu",
        "devices": 8, "device_us_total": total, "attributed_frac": 1.0,
        "unattributed": {"device_us": 0.0, "pct": 0.0},
        "stages": {s: {"device_us": us * steps, "pct": round(100.0 * us * steps / total, 2),
                       "events": 10} for s, us in step_us.items()},
        "programs": {"step.flat": {
            "dispatches": steps, "hlo_instructions": 50, "stages_static": {},
            "fusions": [{"name": f"fusion.{i}", "stages": st}
                        for i, st in enumerate(fusion_stages)],
            "flops": 1e6, "bytes_accessed": 1e6}},
        "cross_stage_fusions": [],
    }


DIFF_PAIRS = {
    "boundaries": (({"ra.counts": 900.0, "ra.hll": 500.0, "ra.match": 10.0},
                    [["ra.counts"], ["ra.match", "ra.unpack"]], 4),
                   ({"ra.counts": 90.0, "ra.hll": 510.0, "ra.match": 10.0, "ra.merge": 40.0},
                    [["ra.counts", "ra.hll"], ["ra.match", "ra.unpack"]], 8)),
    "csv": (({"ra.counts": 900.0, "ra.hll": 500.0}, [["ra.counts"]], 4),
            ({"ra.counts": 90.0, "ra.hll": 510.0}, [["ra.counts", "ra.hll"]], 8)),
    "same": (({"ra.counts": 900.0, "ra.hll": 500.0, "ra.match": 10.0},
              [["ra.counts"], ["ra.match", "ra.unpack"]], 4),) * 2,
    "kernels": (({"ra.match": 120.0, "ra.talk": 80.0, "ra.topk": 16.0},
                 [["ra.match"], ["ra.counts", "ra.hll", "ra.talk", "ra.topk"], ["ra.topk"]], 16),
                ({"ra.match": 130.0, "ra.talk": 70.0, "ra.topk": 16.0, "ra.cms": 3.0},
                 [["ra.counts", "ra.match"], ["ra.counts", "ra.hll", "ra.talk", "ra.topk"],
                  ["ra.topk"]], 16)),
}


@pytest.mark.parametrize("fmt", ["json", "text", "csv"])
@pytest.mark.parametrize("pair", sorted(DIFF_PAIRS))
def test_trace_diff_equals_the_reference_tool(tmp_path, capsys, pair, fmt):
    paths = []
    for side, (step_us, fus, steps) in zip("ab", DIFF_PAIRS[pair]):
        d = tmp_path / side
        d.mkdir()
        with open(d / "devprof.json", "w", encoding="utf-8") as f:
            json.dump(_synthetic_capture(step_us, fus, steps), f)
        paths.append(str(d))
    flag = {"json": ["--json"], "text": [], "csv": ["--csv"]}[fmt]
    assert trace_diff.main([*paths, *flag]) == 0
    got = capsys.readouterr().out
    assert rtrace_diff.main([*paths, *flag]) == 0
    assert got == capsys.readouterr().out
    a, b = (trace_diff.load_capture(p) for p in paths)
    assert trace_diff.diff_captures(a, b) == rtrace_diff.diff_captures(a, b)


def test_trace_diff_refuses_what_the_reference_refuses(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"stages": {}}))
    assert trace_diff.main([str(bad), str(bad)]) == rtrace_diff.main([str(bad), str(bad)]) == 2
    with pytest.raises(SystemExit):
        trace_diff.main([str(bad), str(bad), "--csv", "--json"])


def test_trace_attrib_over_a_profile_dir_trace(corpus, tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = cli.main(["run", "--ruleset", corpus["prefix"], "--logs", corpus["wire"], "--device",
                   "cpu", "--batch-size", "512", "--profile-dir", str(prof), "--json", "--out",
                   str(tmp_path / "r.json")])
    assert rc == 0
    (trace,) = [str(p) for p in prof.glob("*.pt.trace.json")]
    a = trace_attrib.attribute(trace, top=50)
    labels = {r["label"] for r in a["rows"]}
    assert {"ra.match", "ra.talk", "ra.topk", "ra.unpack"} <= labels
    assert a["scoped_us"] >= 0.9 * a["total_us"] > 0
    assert a["unregistered_stages"] == []
    # the same classifier as the capture
    recs = devprof.attribute_events(trace_attrib.load_events(trace))
    assert sum(r["dur"] for r in recs) == pytest.approx(a["total_us"])
    assert trace_attrib.main([trace]) == 0
    assert "carries a named ra.* stage" in capsys.readouterr().out
    assert not stages.live()


def test_trace_attrib_flags_unregistered_stage_ranges(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "python"}},
        ann("step.flat", 0, 100), ann("ra.mystery", 10, 20), launch(1, 15),
        kern(FM, 1, 200, 5.0)]}))
    a = trace_attrib.attribute(str(path))
    assert a["unregistered_stages"] == ["ra.mystery"]
    assert a["rows"] == [{"process": "0", "label": "ra.mystery", "us": 5.0, "count": 1}]
    assert trace_attrib.main([str(path)]) == 0
    assert "WARNING" in capsys.readouterr().out


def test_metrics_profiler_makes_the_stage_ranges_live(tmp_path):
    assert not stages.live()
    with metrics.Profiler(str(tmp_path), out=open(os.devnull, "w")):
        assert stages.live()
    assert not stages.live()
    with metrics.Profiler(None):
        assert not stages.live()
