"""The port's autoscaler (runtime/autoscale.py and its elastic and CLI
wiring) against the reference's, in one process on the CPU.

- ``AutoscaleConfig``: the same refusals with the same words, the same
  ``to_dict``, and the round trip through ``from_dict``;
- ``parse_plan``, ``world_ladder`` and ``host_ladder``: the same values
  and the same errors;
- ``PolicyEngine``: the reference's engine cases, each run through both
  engines, with equal decision lists (``to_dict``) and ``summary()``, and
  a hypothesis property over random configs and random pressure and
  starvation series; ``autoscale.decide`` armed raises and records no
  decision;
- the adapters: ``MetricsTail`` over torn, missing and foreign lines,
  ``ingest_signals``, ``render_prom`` and ``render_prom_labeled`` byte for
  byte, ``flap_count``, the decision log written by one package and read
  by the other;
- ``AutoscaleController``: the port's and the reference's tail one
  metrics file written as they run; each publishes once (or, observe-only,
  logs and never publishes), the same decision but its clock fields;
- the supervisor on hand-made rendezvous files: ``_target_world``, the
  plan's standby split, ``_standby_wait``'s four exits, the off-ladder
  controller, the ``--autoscale-max`` refusal and ``_patch_result``'s
  ``totals.autoscale``;
- the CLI: every knob without ``--autoscale``, a bad knob, the oracle's
  refusal, ``--autoscale`` without ``--elastic`` and a ladder past the
  launcher pool exit 2 with the reference's words;
- the reshard law: worlds 1 -> 8 -> 3 -> 8 through ``assign_shards``,
  ``_ShardCursorSource`` and the port's mesh step and register merge give
  the registers of one world-1 pass.

The process drills are in tests/test_torch_autoscale_procs.py.  Tolerance
0 throughout.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu import errors as rerrors  # noqa: E402
from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import AutoscaleConfig as RAutoscaleConfig  # noqa: E402
from ruleset_analysis_tpu.runtime import autoscale as rautoscale  # noqa: E402
from ruleset_analysis_tpu.runtime import elastic as relastic  # noqa: E402
from ruleset_analysis_tpu_torch import cli, errors  # noqa: E402
from ruleset_analysis_tpu_torch.config import (  # noqa: E402
    AnalysisConfig, AutoscaleConfig, SketchConfig,
)
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import autoscale, elastic, faults  # noqa: E402
from tests._torch_faultkit import reset_all  # noqa: E402

REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")

#: one package's autoscale surface: (config class, module, error class)
SIDES = {
    "port": (AutoscaleConfig, autoscale, errors.AnalysisError),
    "ref": (RAutoscaleConfig, rautoscale, rerrors.AnalysisError),
}


@pytest.fixture(autouse=True)
def _disarmed():
    reset_all()
    yield
    reset_all()


def acfg(cls, **kw):
    """The reference test's engine knobs."""
    base = dict(min_world=1, max_world=8, out_threshold=0.5, in_threshold=0.8,
                sustain_sec=1.0, cooldown_sec=2.0, reform_budget=4, poll_sec=0.1)
    base.update(kw)
    return cls(**base)


# ---------------------------------------------------------------------------
# AutoscaleConfig, the plan and the ladders
# ---------------------------------------------------------------------------


CONFIG_REFUSALS = [
    dict(min_world=0),
    dict(max_world=-1),
    dict(min_world=4, max_world=2),
    dict(initial_world=-1),
    dict(min_world=2, initial_world=1),
    dict(max_world=4, initial_world=5),
    dict(out_threshold=0.0),
    dict(out_threshold=1.5),
    dict(in_threshold=-0.1),
    dict(sustain_sec=0.0),
    dict(poll_sec=-1.0),
    dict(cooldown_sec=-0.5),
    dict(reform_budget=-1),
    dict(plan="out@nope"),
    dict(plan="sideways@1"),
    dict(plan="out@-2"),
    dict(plan="out@1,in"),
]


@pytest.mark.parametrize("kw", CONFIG_REFUSALS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_config_refusals_are_the_references(kw):
    msgs = []
    for cls in (AutoscaleConfig, RAutoscaleConfig):
        with pytest.raises(ValueError) as ei:
            cls(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw", [
    {}, dict(plan="out@2"), dict(min_world=2, max_world=8, initial_world=4),
    dict(out_threshold=1.0, in_threshold=0.25, sustain_sec=0.5, cooldown_sec=0.0,
         reform_budget=0, poll_sec=0.05, plan="out@1.5, in@3"),
])
def test_config_round_trips_and_is_the_references(kw):
    a = acfg(AutoscaleConfig, **kw)
    d = json.loads(json.dumps(a.to_dict()))
    assert AutoscaleConfig.from_dict(d) == a
    assert d == acfg(RAutoscaleConfig, **kw).to_dict()
    assert AutoscaleConfig().to_dict() == RAutoscaleConfig().to_dict()


@pytest.mark.parametrize("plan", ["", "out@1.5, in@3", "in@0,out@0.25,,", "out@2,in@6",
                                  "sideways@1", "out@x", "out", "@1"])
def test_parse_plan_is_the_references(plan):
    got = []
    for side in ("port", "ref"):
        _cls, mod, err = SIDES[side]
        try:
            got.append(("ok", mod.parse_plan(plan)))
        except err as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]


@pytest.mark.parametrize("fn, args, kw", [
    ("world_ladder", (1, 8), {}),
    ("world_ladder", (2, 8), dict(divisors_of=8)),
    ("world_ladder", (1, 6), dict(divisors_of=12)),
    ("world_ladder", (5, 7), dict(divisors_of=8)),
    ("world_ladder", (3, 2), {}),
    ("world_ladder", (1, 1), {}),
    ("host_ladder", (1, 4), {}),
    ("host_ladder", (3, 3), {}),
    ("host_ladder", (4, 2), {}),
])
def test_ladders_are_the_references(fn, args, kw):
    got = []
    for side in ("port", "ref"):
        _cls, mod, err = SIDES[side]
        try:
            got.append(("ok", getattr(mod, fn)(*args, **kw)))
        except err as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# The policy engine: the reference's cases through both engines
# ---------------------------------------------------------------------------


def feed(eng, t0, t1, *, p=0.0, s=0.0, dt=0.25):
    """Constant-signal samples over [t0, t1); the first decision wins."""
    t = t0
    while t < t1:
        d = eng.observe(now=t, pressure=p, starvation=s)
        if d is not None:
            return d, t
        t += dt
    return None, t


def _out_on_pressure(mk):
    eng = mk(2, [1, 2, 4, 8])
    d1, t1 = feed(eng, 0.0, 10.0, p=0.45)  # below the threshold: never
    d2, t2 = feed(eng, 10.0, 20.0, p=0.9)
    return eng, [(d1, t1), (d2, t2)]


def _one_dip(mk):
    eng = mk(1, [1, 2], sustain_sec=2.0)
    out, t = [], 0.0
    for i in range(40):
        # a dip every 1.5 s keeps the window's minimum under the threshold
        out.append((eng.observe(now=t, pressure=0.1 if i % 6 == 5 else 0.95,
                                starvation=0.0), t))
        t += 0.25
    return eng, out


def _cooldown_and_edges(mk):
    eng = mk(4, [2, 4, 8], cooldown_sec=5.0)
    d, t = feed(eng, 0.0, 30.0, p=1.0)
    return eng, [(d, t), feed(eng, t, t + 4.9, p=1.0), feed(eng, t + 5.0, t + 30.0, p=1.0),
                 feed(eng, t + 31.0, t + 60.0, s=1.0)]


def _budget(mk):
    eng = mk(1, [1, 2, 4], reform_budget=1, cooldown_sec=1.0)
    d, t = feed(eng, 0.0, 30.0, p=1.0)
    return eng, [(d, t), feed(eng, t + 1.5, t + 30.0, p=1.0)]


def _observe_only(mk):
    eng = mk(1, [1, 2], reform_budget=0)
    return eng, [feed(eng, 0.0, 30.0, p=1.0), feed(eng, 30.0, 60.0, s=1.0)]


def _flaps(mk):
    eng = mk(2, [2, 4], sustain_sec=1.0, cooldown_sec=1.0)  # damping window 4 s
    d, t = feed(eng, 0.0, 30.0, p=1.0)
    return eng, [(d, t), feed(eng, t + 1.1, t + 30.0, s=1.0)]


def _plan(mk):
    eng = mk(2, [1, 2, 4, 8], plan="out@1,out@2,in@5")
    out, t = [], 0.0
    while t < 10.0:
        out.append((eng.observe(now=t, pressure=0.0, starvation=0.0), t))
        t += 0.25
    return eng, out


def _window_resets(mk):
    eng = mk(1, [1, 2, 4], cooldown_sec=0.0)
    d, t = feed(eng, 0.0, 30.0, p=1.0)
    return eng, [(d, t), feed(eng, t + 0.25, t + 30.0, p=1.0)]


def _decisions(outs):
    return [(d, t) for d, t in outs if d is not None]


ENGINE_CASES = {
    # name: (scenario, what the reference's test asserts of it)
    "out_on_pressure": (_out_on_pressure, lambda eng, o: (
        o[0][0] is None and (o[1][0].direction, o[1][0].from_world, o[1][0].to_world,
                             o[1][0].reason) == ("out", 2, 4, "backpressure")
        and o[1][1] - 10.0 >= eng.acfg.sustain_sec
        and o[1][0].evidence["pressure"]["min"] >= 0.9)),
    "one_dip": (_one_dip, lambda eng, o: eng.decisions == []),
    "cooldown_and_edges": (_cooldown_and_edges, lambda eng, o: (
        (o[0][0].from_world, o[0][0].to_world) == (4, 8) and o[1][0] is None
        and o[2][0] is None and (o[3][0].direction, o[3][0].to_world) == ("in", 4))),
    "budget": (_budget, lambda eng, o: (
        o[0][0] is not None and o[1][0] is None and eng.budget_left == 0
        and eng.summary()["suppressed_by_budget"] == eng.suppressed_budget > 0)),
    "observe_only": (_observe_only, lambda eng, o: (
        not o[0][0].actuate and eng.world == 1 and eng.summary()["observe_only"])),
    "flaps": (_flaps, lambda eng, o: (
        (o[0][0].direction, o[1][0].direction) == ("out", "in") and eng.flaps == 1)),
    "plan": (_plan, lambda eng, o: (
        [(t, d.direction, d.to_world, d.reason) for d, t in _decisions(o)]
        == [(1.0, "out", 4, "plan"), (2.0, "out", 8, "plan"), (5.0, "in", 4, "plan")])),
    "window_resets": (_window_resets, lambda eng, o: (
        o[1][0] is not None and o[1][1] - o[0][1] >= eng.acfg.sustain_sec)),
}


def _engine_image(eng, outs) -> dict:
    return {
        "outs": [(None if d is None else d.to_dict(), t) for d, t in outs],
        "decisions": [d.to_dict() for d in eng.decisions],
        "summary": eng.summary(),
        "state": (eng.world, eng.budget_left, eng.flaps, eng.suppressed_budget),
    }


def _maker(side):
    cls, mod, _err = SIDES[side]

    def mk(world, ladder, **kw):
        return mod.PolicyEngine(acfg(cls, **kw), world=world, ladder=ladder)

    return mk


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_cases_are_the_references(case):
    scenario, claim = ENGINE_CASES[case]
    eng, outs = scenario(_maker("port"))
    assert claim(eng, outs)
    reng, routs = scenario(_maker("ref"))
    assert _engine_image(eng, outs) == _engine_image(reng, routs)


@pytest.mark.parametrize("side", ["port", "ref"])
def test_an_off_ladder_world_is_refused(side):
    cls, mod, err = SIDES[side]
    with pytest.raises(err, match="ladder") as ei:
        mod.PolicyEngine(acfg(cls), world=3, ladder=[2, 4, 8])
    assert str(ei.value) == "current world 3 is not on the autoscale ladder [2, 4, 8]"


def test_applied_notes_the_time_to_effect():
    for side in ("port", "ref"):
        eng, outs = _out_on_pressure(_maker(side))
        d = outs[1][0]
        eng.applied(d, now=d.t + 1.23456)
        assert d.evidence["time_to_effect_sec"] == 1.235


_signal = st.floats(min_value=-0.5, max_value=1.5, allow_nan=False)


@settings(max_examples=60, deadline=None, database=None)
@given(data=st.data())
def test_random_series_give_the_references_decisions(data):
    kw = dict(
        out_threshold=data.draw(st.floats(0.05, 1.0)),
        in_threshold=data.draw(st.floats(0.05, 1.0)),
        sustain_sec=data.draw(st.floats(0.05, 3.0)),
        cooldown_sec=data.draw(st.floats(0.0, 5.0)),
        reform_budget=data.draw(st.integers(0, 4)),
        plan=data.draw(st.sampled_from(["", "", "out@1", "out@0.5,in@2.5", "in@1,out@1.5,in@4"])),
    )
    ladder = data.draw(st.sampled_from([[1, 2], [1, 2, 4, 8], [2, 3, 4], [3]]))
    world = data.draw(st.sampled_from(ladder))
    series = data.draw(st.lists(st.tuples(st.floats(0.0, 1.0), _signal, _signal),
                                min_size=1, max_size=120))
    images = []
    for side in ("port", "ref"):
        eng = _maker(side)(world, ladder, **kw)
        t, outs = 0.0, []
        for dt, p, s in series:
            t += dt
            outs.append((eng.observe(now=t, pressure=p, starvation=s,
                                     gauges={"lines": int(t * 10)} if dt > 0.5 else None), t))
        images.append(_engine_image(eng, outs))
    assert images[0] == images[1]


def test_an_armed_decide_fault_raises_and_records_no_decision():
    eng = _maker("port")(2, [1, 2, 4], plan="out@1")
    assert eng.observe(now=0.0, pressure=0.0, starvation=0.0) is None
    with faults.armed(faults.FaultPlan.parse("autoscale.decide@1")):
        with pytest.raises(errors.InjectedFault, match="autoscale.decide"):
            eng.observe(now=1.0, pressure=0.0, starvation=0.0)
    assert eng.decisions == [] and eng.summary() == {}
    assert (eng.world, eng.budget_left) == (2, 4)


# ---------------------------------------------------------------------------
# The metrics adapters
# ---------------------------------------------------------------------------


def test_metrics_tails_read_the_same_records(tmp_path):
    p = str(tmp_path / "m.jsonl")
    tails = [autoscale.MetricsTail(p), rautoscale.MetricsTail(p)]
    steps = [
        None,  # the file does not exist yet
        '{"kind":"snapshot","t":1}\n{"kind":"snap',  # a torn tail
        'shot","t":2}\n\nnot json\n[1, 2]\n"s"\n{"kind":"final","t":3}\n',
        '{"kind":"snapshot","t":4',  # torn again
        '}\n  \n{"t": 5, "ingest": {"backpressure_sec": 1.5}}\n',
    ]
    seen = []
    for chunk in steps:
        if chunk is not None:
            with open(p, "a", encoding="utf-8") as f:
                f.write(chunk)
        polls = [t.poll() for t in tails]
        assert polls[0] == polls[1]
        seen.append([r.get("t") for r in polls[0]])
    assert seen == [[], [1], [2, 3], [], [4, 5]]


def _snap(t, bp, st_, **extra):
    return {"t": t, "ingest": {"backpressure_sec": bp, "starved_sec": st_, **extra}}


@pytest.mark.parametrize("prev, rec", [
    (None, _snap(0, 0, 0)),
    (_snap(0, 0, 0), _snap(2.0, 1.0, 0.5)),
    (_snap(0, 0, 0), _snap(1.0, 5.0, 0.0)),
    (_snap(0, 3.0, 2.0), _snap(1.0, 2.0, 1.0)),
    (_snap(5, 0, 0), _snap(5, 1, 1)),
    (_snap(6, 0, 0), _snap(5, 1, 1)),
    (_snap(0, 0, 0), {"t": 1}),
    ({"t": 0}, _snap(1, 0, 0)),
    (_snap(0, 0, 0), {"t": 1, "ingest": {"backpressure_sec": 1}}),
    (_snap(0, 0, 0), _snap(1, "x", 0)),
    (_snap(0, 0, 0), _snap(1, None, 0)),
    (_snap(0, 0, 0), {"ingest": {"backpressure_sec": 1, "starved_sec": 0}}),
    (_snap("0.5", 0.25, 0), _snap("1.5", 0.75, 0.125)),
    (_snap(0, 0, 0), {"t": 1, "ingest": [1, 2]}),
])
def test_ingest_signals_are_the_references(prev, rec):
    assert autoscale.ingest_signals(prev, rec) == rautoscale.ingest_signals(prev, rec)


GAUGES = [
    {},
    {"queue_depth": 12, "rate": 1.5, "name": "skipme", "ok": True},
    {"a.b-c": 1e-7, "z": 0, "big": 12345678901234, "f": 2.0, "neg": -3.25, "none": None,
     "off": False, "list": [1]},
]


@pytest.mark.parametrize("gauges", GAUGES)
@pytest.mark.parametrize("prefix", ["ra_", "ra_serve_"])
def test_render_prom_is_the_references(gauges, prefix):
    assert (autoscale.render_prom(gauges, prefix=prefix)
            == rautoscale.render_prom(gauges, prefix=prefix))


@pytest.mark.parametrize("label", ["tenant", "host"])
def test_render_prom_labeled_is_the_references(label):
    per = {"t1": GAUGES[1], "t0": GAUGES[2], "empty": {}, "t 2": {"queue_depth": 3}}
    got = autoscale.render_prom_labeled(per, prefix="ra_serve_tenant_", label=label)
    assert got == rautoscale.render_prom_labeled(per, prefix="ra_serve_tenant_", label=label)
    assert f'ra_serve_tenant_queue_depth{{{label}="t 2"}} 3' in got.splitlines()
    assert autoscale.render_prom_labeled({}) == rautoscale.render_prom_labeled({}) == "\n"


@pytest.mark.parametrize("log, cd, sus", [
    ([{"direction": "out", "t_wall": 100.0}, {"direction": "in", "t_wall": 102.5}], 1.0, 1.0),
    ([{"direction": "out", "t_wall": 100.0}, {"direction": "in", "t_wall": 104.5}], 1.0, 1.0),
    ([{"direction": "out", "t_wall": 100.0}, {"direction": "out", "t_wall": 100.2}], 1.0, 1.0),
    ([{"direction": "out", "t_wall": 1.0}, {"direction": "in", "t_wall": 2.0},
      {"direction": "out", "t_wall": 3.0}, {"direction": "out"},
      {"direction": "in", "t_wall": "x"}], 0.5, 0.5),
    ([], 1.0, 1.0),
])
def test_flap_count_is_the_references(log, cd, sus):
    assert (autoscale.flap_count(log, cooldown_sec=cd, sustain_sec=sus)
            == rautoscale.flap_count(log, cooldown_sec=cd, sustain_sec=sus))


def test_decision_logs_cross_between_packages(tmp_path):
    p = str(tmp_path / "scale-log.jsonl")
    assert autoscale.read_decision_log(p) == rautoscale.read_decision_log(p) == []
    ev = {"window_sec": 1.0, "pressure": {"min": 0.5}}
    autoscale.append_decision_log(p, autoscale.ScaleDecision(
        1, "out", 2, 3, "backpressure", 5.0, True, ev), gen=0, seq_global=1, t_wall=9.5)
    rautoscale.append_decision_log(p, rautoscale.ScaleDecision(
        1, "in", 3, 2, "plan", 6.0, False, {}), gen=1, seq_global=2, t_wall=10.5)
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"kind":"applied","gen":1}\n\n[3]\n{"torn":')
    got = autoscale.read_decision_log(p)
    assert got == rautoscale.read_decision_log(p)
    assert [r.get("direction", r.get("kind")) for r in got] == ["out", "in", "applied"]
    assert got[0]["evidence"] == ev and got[1]["t_wall"] == 10.5


# ---------------------------------------------------------------------------
# The controller, on a metrics file written while it runs
# ---------------------------------------------------------------------------


#: fields that follow the poll clock and the sample the stride lands on
CLOCK_FIELDS = ("t",)
CLOCK_EVIDENCE = ("window_sec", "samples", "gauges")


def _unclocked(dec) -> dict:
    d = dec.to_dict()
    for k in CLOCK_FIELDS:
        d.pop(k)
    for k in CLOCK_EVIDENCE:
        d["evidence"].pop(k, None)
    return d


@pytest.mark.parametrize("budget", [4, 0], ids=["publishes", "observe-only"])
def test_controllers_decide_alike_on_one_metrics_file(tmp_path, budget):
    """Both controllers tail one file written faster than real time (~8 s of
    device-bound snapshots in 1.4 s): the >= 1 s stride sees pressure 0.9,
    each decides 2 -> 4 and publishes it once, or, observe-only, logs it and
    publishes nothing."""
    mpath = str(tmp_path / "metrics.jsonl")
    out = {}
    ctrls = []
    for side in ("port", "ref"):
        cls, mod, _err = SIDES[side]
        published, logged = [], []
        out[side] = (published, logged)
        ctrls.append(mod.AutoscaleController(
            acfg(cls, out_threshold=0.4, sustain_sec=0.4, cooldown_sec=0.1, poll_sec=0.05,
                 reform_budget=budget),
            world=2, ladder=[1, 2, 4], metrics_path=mpath, publish=published.append,
            log=logged.append, budget_left=budget))
    for c in ctrls:
        c.start()
    try:
        t0 = time.time()
        bp = 0.0
        with open(mpath, "w", encoding="utf-8") as f:
            for i in range(28):
                bp += 0.27
                f.write(json.dumps({
                    "kind": "snapshot", "t": t0 + 0.3 * (i + 1), "lines": 64 * i,
                    "lines_per_sec_inst": 200.0,
                    "ingest": {"backpressure_sec": round(bp, 3), "starved_sec": 0.01 * i,
                               "queue_depth": 2},
                }) + "\n")
                if i % 7 == 3:
                    f.write("{torn" if i == 3 else "\n")  # a foreign line among them
                    f.write("\n")
                f.flush()
                time.sleep(0.05)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not all(lg for _p, lg in out.values()):
            time.sleep(0.05)
    finally:
        for c in ctrls:
            c.stop()
            c.join(timeout=10)
    assert all(c.error is None and not c.is_alive() for c in ctrls)
    (pub, logged), (rpub, rlogged) = out["port"], out["ref"]
    # observe-only decides on (once a cooldown and a window later): the
    # first decisions are compared
    assert logged and rlogged
    dec = logged[0]
    assert (dec.direction, dec.from_world, dec.to_world, dec.reason) == (
        "out", 2, 4, "backpressure")
    assert dec.evidence["pressure"]["min"] >= 0.4
    assert _unclocked(dec) == _unclocked(rlogged[0])
    if budget:
        assert logged == pub == [dec] and len(rlogged) == len(rpub) == 1
        assert ctrls[0].decision is dec
        assert dec.actuate and ctrls[0].engine.world == 4
    else:
        assert pub == rpub == [] and not dec.actuate and ctrls[0].engine.world == 2


def test_a_controller_carries_the_cooldown_and_budget_over(tmp_path):
    """A request of the previous generation paces the next controller, and a
    spent budget holds it (a scripted plan ignores the cooldown)."""
    for side in ("port", "ref"):
        cls, mod, _err = SIDES[side]
        c = mod.AutoscaleController(acfg(cls, reform_budget=3), world=2, ladder=[1, 2, 4],
                                    metrics_path=str(tmp_path / "none.jsonl"),
                                    publish=lambda d: None, budget_left=1,
                                    cooldown_anchor=time.monotonic())
        assert c.engine.budget_left == 1 and c.name == "ra-autoscale" and c.daemon
        c.start()
        time.sleep(0.3)
        c.stop()
        c.join(timeout=5)
        assert c.error is None and c.decision is None
        assert c.engine._last.reason == "carryover"
        obs_only = mod.AutoscaleController(acfg(cls, reform_budget=0), world=2,
                                           ladder=[1, 2], metrics_path="x", publish=None,
                                           budget_left=5)
        assert obs_only.engine.budget_left == 0


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------


def _sups(tmp_path, tag, n, *, plain=False, **akw):
    """The port's and the reference's supervisor of one rendezvous dir, with
    the autoscale knobs ``akw`` (no autoscale when ``plain``)."""
    log = tmp_path / "a.log"
    log.write_text("x\n")
    d = str(tmp_path / "el")
    port = elastic.ElasticSupervisor(
        d, tag, n, str(tmp_path / "rs"), [str(log)], AnalysisConfig(checkpoint_every_chunks=2),
        autoscale=None if plain else AutoscaleConfig(**akw))
    ref = relastic.ElasticSupervisor(
        d, tag, n, str(tmp_path / "rs"), [str(log)], JConfig(checkpoint_every_chunks=2),
        autoscale=None if plain else RAutoscaleConfig(**akw))
    return port, ref


def _hb(sup, tag, age=0.0):
    os.makedirs(sup._members_dir(), exist_ok=True)
    p = sup._hb_path(tag)
    open(p, "w").close()
    now = time.time()
    os.utime(p, (now - age, now - age))


def test_supervisor_takes_the_ladder_and_hands_it_to_its_workers(tmp_path):
    port, ref = _sups(tmp_path, 0, 4, min_world=2, initial_world=3, plan="out@1")
    assert (port._ladder, port._initial_world) == (ref._ladder, ref._initial_world) == (
        [2, 3, 4], 3)
    assert port.job["autoscale"] == ref.job["autoscale"] == json.loads(
        json.dumps(port.job["autoscale"]))
    assert AutoscaleConfig.from_dict(port.job["autoscale"]) == port.autoscale


def test_without_autoscale_the_job_and_the_sizing_are_the_references(tmp_path):
    port, ref = _sups(tmp_path, 0, 3, plain=True)
    assert port.job["autoscale"] is ref.job["autoscale"] is None
    assert port._target_world(0, [0, 1, 2]) == ref._target_world(0, [0, 1, 2]) == (3, 0)


@pytest.mark.parametrize("akw", [dict(max_world=5), dict(min_world=3, max_world=6)])
def test_a_ladder_past_the_launcher_pool_is_refused(tmp_path, akw):
    msgs = []
    for sup_cls, err, cfg, acls in (
            (elastic.ElasticSupervisor, errors.AnalysisError, AnalysisConfig, AutoscaleConfig),
            (relastic.ElasticSupervisor, rerrors.AnalysisError, JConfig, RAutoscaleConfig)):
        with pytest.raises(err) as ei:
            sup_cls(str(tmp_path / "el"), 0, 4, "rs", [str(tmp_path / "a.log")],
                    cfg(checkpoint_every_chunks=2), autoscale=acls(**akw))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "exceeds the provisioned launcher pool" in msgs[0]


TARGET_CASES = {
    # name: (gen, avail, the previous plan, scale.json)
    "gen0": (0, [0, 1, 2, 3], None, None),
    "gen0-few": (0, [0], None, None),
    "carry": (1, [0, 1, 2, 3], {"world": [0, 1, 2], "scale_seq": 0}, None),
    "pending": (1, [0, 1, 2, 3], {"world": [0, 1], "scale_seq": 0},
                {"seq": 1, "to_world": 3}),
    "consumed": (2, [0, 1, 2, 3], {"world": [0, 1, 2], "scale_seq": 1},
                 {"seq": 1, "to_world": 4}),
    "death-below-request": (1, [0, 1], {"world": [0, 1, 2], "scale_seq": 0},
                            {"seq": 1, "to_world": 4}),
    "past-the-ladder": (1, [0, 1, 2, 3], {"world": [0, 1], "scale_seq": 0},
                        {"seq": 1, "to_world": 9}),
    "torn-plan": (1, [0, 1, 2, 3], "{torn", None),
    "torn-request": (1, [0, 1, 2, 3], {"world": [0, 1], "scale_seq": 0}, "{torn"),
}


@pytest.mark.parametrize("case", list(TARGET_CASES))
def test_target_world_is_the_references(tmp_path, case):
    gen, avail, prev, req = TARGET_CASES[case]
    port, ref = _sups(tmp_path, 0, 4, min_world=1, max_world=3, initial_world=2)
    if prev is not None:
        os.makedirs(port._gen_dir(gen - 1))
        with open(port._plan_path(gen - 1), "w", encoding="utf-8") as f:
            f.write(prev if isinstance(prev, str) else json.dumps(prev))
    if req is not None:
        os.makedirs(port.dir, exist_ok=True)
        with open(port._scale_path(), "w", encoding="utf-8") as f:
            f.write(req if isinstance(req, str) else json.dumps(req))
    got = port._target_world(gen, avail)
    assert got == ref._target_world(gen, avail)
    want = {"gen0": (2, 0), "gen0-few": (1, 0), "carry": (3, 0), "pending": (3, 1),
            "consumed": (3, 1), "death-below-request": (2, 1), "past-the-ladder": (3, 1),
            "torn-plan": (2, 0), "torn-request": (2, 0)}[case]
    assert got == want


def _strip_coordinator(plan: dict) -> dict:
    return {k: v for k, v in plan.items() if k != "coordinator"}


@pytest.mark.parametrize("initial", [1, 2, 3])
def test_the_plan_splits_the_pool_into_world_and_standby(tmp_path, initial):
    plans = []
    for side in ("port", "ref"):
        sub = tmp_path / side
        sub.mkdir()
        port, ref = _sups(sub, 0, 3, max_world=3, initial_world=initial)
        sup = port if side == "port" else ref
        for tag in (0, 1, 2):
            _hb(sup, tag)
        os.makedirs(os.path.join(sup._gen_dir(0), "join"))
        for tag in (1, 2):
            open(os.path.join(sup._gen_dir(0), "join", str(tag)), "w").close()
        plans.append(_strip_coordinator(sup._form(0)))
    assert plans[0] == plans[1] == {"gen": 0, "world": list(range(initial)),
                                    "standby": list(range(initial, 3)), "scale_seq": 0}


def test_a_standby_member_takes_the_plan(tmp_path):
    """A member in ``standby`` forms with the plan; one in neither list aborts."""
    port, ref = _sups(tmp_path, 2, 3, max_world=3, initial_world=1)
    for sup, err in ((port, errors.AnalysisError), (ref, rerrors.AnalysisError)):
        os.makedirs(sup._gen_dir(4), exist_ok=True)
        elastic._atomic_write_json(sup._plan_path(4), {
            "gen": 4, "world": [0], "standby": [1, 2], "scale_seq": 1, "coordinator": "h:1"})
        assert sup._form(4)["standby"] == [1, 2]
        elastic._atomic_write_json(sup._plan_path(4), {
            "gen": 4, "world": [0], "standby": [1], "scale_seq": 1, "coordinator": "h:1"})
        with pytest.raises(err, match="missed generation 4 formation"):
            sup._form(4)
        os.unlink(sup._plan_path(4))


STANDBY_EXITS = ("done", "scale", "failed", "stale")


@pytest.mark.parametrize("exit_", STANDBY_EXITS)
def test_standby_wait_exits_as_the_references(tmp_path, exit_):
    """Each of the four exits, already true when the standby parks, so the
    wait returns at its first pass; a scale request the plan consumed and
    a fresh active member keep it parked (checked by a timed-out wait)."""
    got = []
    (tmp_path / "x").mkdir()
    for i, sup in enumerate(_sups(tmp_path / "x", 2, 3, max_world=3, initial_world=2)):
        sub = tmp_path / f"s{i}"
        sup.dir = str(sub)
        os.makedirs(sup._gen_dir(1))
        plan = {"gen": 1, "world": [0, 1], "standby": [2], "scale_seq": 1}
        _hb(sup, 0)
        _hb(sup, 1)
        elastic._atomic_write_json(sup._scale_path(), {"seq": 1, "to_world": 2})
        # parked: nothing has happened yet
        res = []
        th = threading.Thread(target=lambda: res.append(sup._standby_wait(1, plan)),
                              daemon=True, name="standby-wait")
        if exit_ == "done":
            os.makedirs(os.path.join(sup._gen_dir(1), "done"))
            open(os.path.join(sup._gen_dir(1), "done", "0"), "w").close()
        elif exit_ == "scale":
            elastic._atomic_write_json(sup._scale_path(), {"seq": 2, "to_world": 3})
        elif exit_ == "failed":
            os.makedirs(os.path.join(sup._gen_dir(1), "failed"))
            open(os.path.join(sup._gen_dir(1), "failed", "1"), "w").close()
        else:
            _hb(sup, 1, age=elastic.STALE_SEC + 5)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        got.append(res[0])
    assert got[0] == got[1] == ("done" if exit_ == "done" else "next")


def test_a_parked_standby_stays_parked(tmp_path):
    port, _ref = _sups(tmp_path, 2, 3, max_world=3, initial_world=2)
    os.makedirs(port._gen_dir(1))
    _hb(port, 0)
    _hb(port, 1)
    elastic._atomic_write_json(port._scale_path(), {"seq": 1, "to_world": 2})
    res = []
    th = threading.Thread(target=lambda: res.append(port._standby_wait(1, {
        "gen": 1, "world": [0, 1], "standby": [2], "scale_seq": 1})), daemon=True,
        name="standby-wait")
    th.start()
    th.join(timeout=0.8)
    assert th.is_alive() and res == []
    os.makedirs(os.path.join(port._gen_dir(1), "done"))
    open(os.path.join(port._gen_dir(1), "done", "0"), "w").close()
    th.join(timeout=5)
    assert res == ["done"]


def test_the_controller_pauses_off_the_ladder(tmp_path):
    for sup in _sups(tmp_path, 0, 4, min_world=2):
        assert sup._start_controller(3, [0], 0) is None


def test_patch_result_adds_the_references_autoscale_totals(tmp_path):
    port, ref = _sups(tmp_path, 0, 4, min_world=2, cooldown_sec=1.0, sustain_sec=1.0)
    os.makedirs(port.dir)
    log = port._scale_log_path()
    decs = [
        rautoscale.ScaleDecision(1, "out", 2, 3, "backpressure", 5.0, True,
                                 {"pressure": {"min": 0.7}}),
        rautoscale.ScaleDecision(1, "in", 3, 2, "starvation", 6.0, True, {}),
        rautoscale.ScaleDecision(1, "out", 2, 3, "plan", 9.0, False, {}),
    ]
    for i, (d, t_wall) in enumerate(zip(decs, (100.0, 102.0, 110.0))):
        rautoscale.append_decision_log(log, d, gen=i, seq_global=i + 1, t_wall=t_wall)
        if d.actuate:
            with open(log, "a", encoding="utf-8") as f:
                f.write(json.dumps({"kind": "applied", "applied_seq": i + 1, "gen": i + 1,
                                    "world": d.to_world, "time_to_effect_sec": 0.25}) + "\n")
    totals = []
    for sup, name in ((port, "port.json"), (ref, "ref.json")):
        path = os.path.join(sup.dir, name)
        elastic._atomic_write_json(path, {"totals": {"lines_total": 5}, "per_rule": []})
        sup.final_world = [0, 1]
        assert sup._patch_result(path) == path
        with open(path, encoding="utf-8") as f:
            totals.append(json.load(f)["totals"])
    assert totals[0] == totals[1]
    a = totals[0]["autoscale"]
    assert (a["scale_events"], a["scale_out"], a["scale_in"], a["flaps"], a["final_world"]) == (
        2, 2, 1, 1, 2)
    assert [r["kind"] for r in a["applied"]] == ["applied"] * 2


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


KNOBS = {"--autoscale-min": "2", "--autoscale-max": "3", "--autoscale-initial": "1",
         "--autoscale-out-threshold": "0.4", "--autoscale-in-threshold": "0.7",
         "--autoscale-sustain": "2", "--autoscale-cooldown": "1", "--autoscale-budget": "1",
         "--autoscale-poll": "0.2", "--autoscale-plan": "out@1"}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """A small ruleset and two text shards."""
    td = tmp_path_factory.mktemp("autoscale_cli")
    rs = aclparse.parse_asa_config(synth.synth_config(n_acls=2, rules_per_acl=4, seed=3), "fw1")
    packed = pack.pack_rulesets([rs])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 60, seed=4), seed=5)
    pack.save_packed(packed, str(td / "packed"))
    paths = []
    for i in range(2):
        p = td / f"s{i}.log"
        p.write_text("".join(ln + "\n" for ln in lines[i * 30:(i + 1) * 30]), encoding="utf-8")
        paths.append(str(p))
    (td / "fw1.cfg").write_text("hostname fw1\n")
    return str(td / "packed"), paths, str(td / "fw1.cfg")


def _both(argv_port, argv_ref, capsys):
    capsys.readouterr()
    rc = cli.main(argv_port)
    mine = capsys.readouterr().err
    rrc = rcli.main(argv_ref)
    ref = capsys.readouterr().err
    return rc, mine, rrc, ref


@pytest.mark.parametrize("flag", list(KNOBS))
def test_a_knob_without_autoscale_is_the_references_usage_error(shards, flag, capsys,
                                                               monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    prefix, logs, _cfg = shards
    argv = ["run", "--ruleset", prefix, "--logs", *logs, flag, KNOBS[flag], "--json"]
    rc, mine, rrc, ref = _both([*argv, "--device", "cpu"], argv, capsys)
    assert rc == rrc == 2
    assert mine.strip() == ref.strip() == f"error: {flag} requires --autoscale"
    args = cli.make_parser().parse_args([*argv, "--autoscale"])
    rargs = rcli.make_parser().parse_args([*argv, "--autoscale"])
    assert cli._autoscale_config(args).to_dict() == rcli._autoscale_config(rargs).to_dict()
    with pytest.raises(errors.AnalysisError) as ei:
        cli._autoscale_config(cli.make_parser().parse_args(argv))
    with pytest.raises(rerrors.AnalysisError) as rei:
        rcli._autoscale_config(rcli.make_parser().parse_args(argv))
    assert str(ei.value) == str(rei.value)


def test_the_flag_defaults_are_the_references():
    assert cli._autoscale_defaults() == rcli._autoscale_defaults()
    assert cli._AUTOSCALE_FIELDS == rcli._AUTOSCALE_FIELDS
    args = cli.make_parser().parse_args(["run", "--ruleset", "r", "--logs", "l"])
    assert cli._autoscale_config(args) is None


CLI_CASES = {
    # name: the argv past the ruleset, the logs and --json
    "bad-knob": ("--autoscale", "--autoscale-min", "0"),
    "bad-plan": ("--autoscale", "--autoscale-plan", "sideways@1"),
    "bad-initial": ("--autoscale", "--autoscale-max", "2", "--autoscale-initial", "3"),
    "no-elastic": ("--autoscale",),
    "no-elastic-distributed": ("--autoscale", "--distributed", "--num-processes", "1",
                               "--process-id", "0"),
    "past-the-pool": ("--autoscale", "--autoscale-max", "3", "--distributed", "--elastic",
                      "--elastic-dir", "ELDIR", "--num-processes", "2", "--process-id", "0",
                      "--checkpoint-every", "2"),
    "oracle": ("--autoscale", "--backend", "oracle", "--acl-configs", "CFG"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_refusals_are_the_references(shards, case, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    prefix, logs, cfg = shards
    argv = ["run", "--ruleset", prefix, "--logs", *logs, "--json",
            *[{"ELDIR": str(tmp_path / "el"), "CFG": cfg}.get(a, a) for a in CLI_CASES[case]]]
    port_argv = argv if case == "oracle" else [*argv, "--device", "cpu"]
    rc, mine, rrc, ref = _both(port_argv, argv, capsys)
    assert rc == rrc == 2, (mine, ref)
    assert ref.strip() and ref.strip() in mine, (mine, ref)
    assert not os.path.exists(tmp_path / "el")


# ---------------------------------------------------------------------------
# The reshard law
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reshard_corpus(tmp_path_factory):
    """The reference test's corpus: 960 lines in 8 shards of 120."""
    td = tmp_path_factory.mktemp("reshard")
    rs = aclparse.parse_asa_config(synth.synth_config(n_acls=3, rules_per_acl=6, seed=51),
                                   "fw1")
    packed = pack.pack_rulesets([rs])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 960, seed=52), seed=53,
                                variety=0.3)
    shards = []
    for i in range(8):
        p = td / f"s{i}.log"
        p.write_text("".join(ln + "\n" for ln in lines[i * 120:(i + 1) * 120]),
                     encoding="utf-8")
        shards.append(str(p))
    return packed, shards


def test_reshard_grow_and_shrink_registers_are_one_passes(reshard_corpus):
    """Worlds 1 -> 8 -> 3 -> 8 over one corpus == one world-1 pass.

    Each generation re-splits the work left in the cursor manifest
    (``assign_shards``, as a planned scale re-formation does); its ranks
    read their shards through ``_ShardCursorSource`` in lockstep, a bounded
    number of batches each, and step them as the shards of a mesh of
    ``world`` CPU devices, whose step merges the ranks' registers (counts
    and talker deltas summed, HLL maxed: ``parallel/step.merge_tail``); the
    registers carry from generation to generation as the epoch does.  A
    lost, doubled or reordered line shows as a register difference.
    """
    import torch

    from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib
    from ruleset_analysis_tpu_torch.parallel import step as step_lib
    from ruleset_analysis_tpu_torch.runtime.stream import _ShardCursorSource

    packed, shards = reshard_corpus
    cfg = AnalysisConfig(batch_size=64, device="cpu",
                         sketch=SketchConfig(cms_width=1 << 10, cms_depth=2, hll_p=6))
    cpu = torch.device("cpu")
    rules = step_lib.ship(packed, mesh_lib.make_mesh([cpu]))

    def staged(worlds_and_quota):
        state = step_lib.init_state(packed.n_keys, cfg, mesh_lib.make_mesh([cpu]))
        cursors: dict[int, int] = {}
        done: set[int] = set()
        epochs = []
        for world, quota in worlds_and_quota:
            mesh = mesh_lib.make_mesh([cpu] * world)
            step = step_lib.make_parallel_step(mesh, cfg, packed.n_keys)
            srcs = [_ShardCursorSource(packed, a, native=False)
                    for a in elastic.assign_shards(shards, cursors, done, world)]
            its = [s.batches(0, 64) for s in srcs]
            n = 0
            while quota is None or n < quota:
                batches = [next(it, None) for it in its]
                if all(b is None for b in batches):
                    break
                # a rank out of work steps an empty batch, as the loop does
                parts = [pack.compact_batch(b[0] if b is not None else
                                            np.zeros((pack.TUPLE_COLS, 64), np.uint32))
                         for b in batches]
                shards_ = mesh_lib.shard_batch(mesh, np.concatenate(parts, axis=1))
                state, _out = step(state, rules, [b.use() for b in shards_])
                n += 1
            for s in srcs:  # the epoch manifest: every rank's cursors
                cursors.update(s.cursors)
                done |= s.done
            epochs.append((world, sum(cursors.values()), sorted(done),
                           any(0 < c < 120 for c in cursors.values())))
        assert set(range(len(shards))) == done, epochs
        assert sum(cursors.values()) == 960
        return {k: v.numpy() for k, v in state[0]._asdict().items()}, epochs

    got, epochs = staged([(1, 3), (8, 1), (3, 2), (8, None)])
    # the grow and the shrink re-split half-read shards, or the law was not
    # exercised at its boundaries
    assert epochs[0][3] and epochs[1][3], epochs
    assert 0 < epochs[0][1] < epochs[1][1] < 960, epochs
    want, _ = staged([(1, None)])
    for name in REGISTERS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
