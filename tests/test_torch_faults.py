"""The port's fault plans (runtime/faults.py) against the reference's.

Both packages' ``faults`` modules side by side: the same registered
sites, the same plan grammar (``site@N``, the transient ``site@N:k``,
``seed=S``) and refusals, the same seeded random schedules, arming
through ``RA_FAULT_PLAN``, and the same behaviour of the ``raise``,
``stall``, ``torn``, ``corrupt`` and ``crash`` actions.  Each test
leaves both modules disarmed.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from ruleset_analysis_tpu import errors as rerrors
from ruleset_analysis_tpu.runtime import faults as rfaults
from ruleset_analysis_tpu_torch import errors
from ruleset_analysis_tpu_torch.runtime import faults

ROOT = Path(__file__).resolve().parent.parent
BOTH = (("port", faults, errors), ("ref", rfaults, rerrors))


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    rfaults.disarm()
    yield
    faults.disarm()
    rfaults.disarm()


def test_sites_equal_the_references():
    assert list(faults.SITES) == list(rfaults.SITES)
    assert {k: v[0] for k, v in faults.SITES.items()} == {
        k: v[0] for k, v in rfaults.SITES.items()
    }
    assert faults.ENV_VAR == rfaults.ENV_VAR == "RA_FAULT_PLAN"


@pytest.mark.parametrize("site", sorted(rfaults.SITES))
def test_every_site_parses_as_in_the_reference(site):
    for text in (f"{site}@1", f"{site}@3", f"{site}@2:3,seed=7", f"  {site}  ,seed=0"):
        plan, rplan = faults.FaultPlan.parse(text), rfaults.FaultPlan.parse(text)
        assert plan.to_str() == rplan.to_str()
        assert plan.seed == rplan.seed
        spec, rspec = plan.specs[site], rplan.specs[site]
        assert (spec.at, spec.count, spec.action) == (rspec.at, rspec.count, rspec.action)
        assert faults.FaultPlan.parse(plan.to_str()).to_str() == plan.to_str()


def test_multi_site_plan_and_transient_grammar():
    for mod, _err in ((faults, errors), (rfaults, rerrors)):
        multi = mod.FaultPlan.parse("ingest.producer.raise@2,stream.wire.corrupt@1,seed=9")
        assert set(multi.specs) == {"ingest.producer.raise", "stream.wire.corrupt"}
        assert multi.seed == 9
        plan = mod.FaultPlan.parse("stream.device_put.fail@2:3,seed=4")
        spec = plan.specs["stream.device_put.fail"]
        assert [spec.fires_on(n) for n in range(1, 7)] == [False, True, True, True, False, False]
        assert plan.to_str() == "stream.device_put.fail@2:3,seed=4"
        assert mod.FaultPlan.parse("listener.drop@5:1").to_str() == "listener.drop@5"
        assert repr(plan) == "FaultPlan('stream.device_put.fail@2:3,seed=4')"


@pytest.mark.parametrize("text", [
    "no.such.site@1", "ingest.producer.raise@0", "seed=4", "", "listener.drop@5:0",
    "listener.drop@5:x", "analyze.tile@x", "analyze.tile@1,seed=x", "analyze.tile@-2",
])
def test_bad_specs_are_refused_alike(text):
    msgs = []
    for _side, mod, err in BOTH:
        with pytest.raises(err.AnalysisError) as ei:
            mod.FaultPlan.parse(text)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seed", range(5))
def test_random_plans_equal_the_references(seed):
    for kw in ({}, {"n_faults": 2}, {"sites": ["analyze.tile"], "n_faults": 1},
               {"n_faults": 3, "max_at": 9}):
        a = faults.FaultPlan.random(seed, **kw)
        assert a.to_str() == rfaults.FaultPlan.random(seed, **kw).to_str()
        assert a.to_str() == faults.FaultPlan.random(seed, **kw).to_str()


def test_arming_exports_and_restores_the_env_var():
    plan = faults.FaultPlan.random(123, n_faults=2)
    assert faults.active_plan() is None
    with faults.armed(plan) as p:
        assert p is plan and faults.active_plan() is plan
        assert os.environ[faults.ENV_VAR] == plan.to_str()
    assert faults.ENV_VAR not in os.environ
    assert faults.active_plan() is None
    # arm_spec: idempotent for the same spec, never disarms on an empty one
    assert faults.arm_spec("") is False
    assert faults.arm_spec("analyze.tile@3") is True
    assert faults.arm_spec("analyze.tile@3") is False
    assert faults.active_plan().to_str() == "analyze.tile@3"
    faults.disarm()
    assert faults.ENV_VAR not in os.environ


@pytest.mark.parametrize("side", ["port", "ref"])
def test_a_plan_in_the_environment_arms_a_fresh_process_lazily(side, monkeypatch):
    mod, err = {"port": (faults, errors), "ref": (rfaults, rerrors)}[side]
    monkeypatch.setenv(mod.ENV_VAR, "analyze.tile@2")
    monkeypatch.setattr(mod, "_env_checked", False)
    assert mod.fire("analyze.tile", payload="x") == "x"
    assert mod.active_plan().to_str() == "analyze.tile@2"
    with pytest.raises(err.InjectedFault, match=r"analyze.tile \(hit 2\)"):
        mod.fire("analyze.tile")
    assert mod.fire("analyze.tile", payload=3) == 3
    mod.disarm()
    # the inherited variable is not ours to remove
    assert os.environ[mod.ENV_VAR] == "analyze.tile@2"


def test_disarmed_fire_returns_its_payload():
    for _side, mod, _err in BOTH:
        payload = object()
        assert mod.fire("analyze.tile", payload=payload) is payload
        assert mod.fire("stream.wire.corrupt", payload=payload, corrupt=lambda p, r: 0) is payload
        # a site the plan does not name passes through while armed
        with mod.armed(mod.FaultPlan.parse("analyze.tile@1")):
            assert mod.fire("lineage.append", payload=payload) is payload


def _outcome(mod, err, site, **kw):
    try:
        return ("ok", mod.fire(site, **kw))
    except err.InjectedFault as e:
        assert isinstance(e, err.AnalysisError)
        return ("raised", str(e))


def test_raise_fires_on_its_hits_alike():
    seqs = []
    for _side, mod, err in BOTH:
        with mod.armed(mod.FaultPlan.parse("analyze.tile@2:2")):
            seqs.append([_outcome(mod, err, "analyze.tile", payload=n) for n in range(5)])
    assert seqs[0] == seqs[1]
    assert [s[0] for s in seqs[0]] == ["ok", "raised", "raised", "ok", "ok"]
    assert seqs[0][1][1] == "injected fault: analyze.tile (hit 2)"


def test_torn_truncates_then_raises_alike(tmp_path):
    outs = []
    for side, mod, err in BOTH:
        path = tmp_path / f"{side}.bin"
        path.write_bytes(bytes(range(100)))
        with mod.armed(mod.FaultPlan.parse("checkpoint.torn_state@1")):
            out = _outcome(mod, err, "checkpoint.torn_state", path=str(path))
        outs.append((out[0], out[1].replace(side, "X"), path.read_bytes()))
        # a missing file still raises (the crash is simulated either way)
        with mod.armed(mod.FaultPlan.parse("checkpoint.torn_manifest@1")):
            gone = _outcome(mod, err, "checkpoint.torn_manifest", path=str(tmp_path / "none"))
        assert gone[0] == "raised"
    assert outs[0] == outs[1]
    assert outs[0][0] == "raised" and outs[0][2] == bytes(range(50))


@pytest.mark.parametrize("seed", [0, 5])
def test_corrupt_damages_the_payload_alike(seed):
    def flip(payload, rng):
        b = bytearray(payload)
        for _ in range(3):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        return bytes(b)

    outs = []
    for _side, mod, err in BOTH:
        with mod.armed(mod.FaultPlan.parse(f"stream.wire.corrupt@2:2,seed={seed}")):
            outs.append([_outcome(mod, err, "stream.wire.corrupt", payload=bytes(64),
                                  corrupt=flip) for _ in range(4)])
            # no corruptor: the site raises instead
            outs[-1].append(_outcome(mod, err, "stream.wire.corrupt", payload=bytes(4))[0])
    assert outs[0] == outs[1]
    assert outs[0][0] == ("ok", bytes(64)) and outs[0][1][1] != bytes(64)


def test_stall_releases_on_stop_or_disarm_and_raises_alike():
    for _side, mod, err in BOTH:
        stop = threading.Event()
        stop.set()
        with mod.armed(mod.FaultPlan.parse("ingest.queue.stall@1")):
            assert _outcome(mod, err, "ingest.queue.stall", stop=stop) == (
                "raised", "injected stall released: ingest.queue.stall (hit 1)")
        # released by disarm from another thread
        plan = mod.FaultPlan.parse("listener.stall@1")
        mod.arm(plan)
        t = threading.Timer(0.1, mod.disarm)
        t.start()
        assert _outcome(mod, err, "listener.stall")[0] == "raised"
        t.join()


def test_stall_timeout_reads_the_environment_alike(monkeypatch):
    for value in (None, "12.5", "-1", "junk"):
        if value is None:
            monkeypatch.delenv("RA_STALL_TIMEOUT", raising=False)
        else:
            monkeypatch.setenv("RA_STALL_TIMEOUT", value)
        assert faults.default_stall_timeout() == rfaults.default_stall_timeout()


def test_crash_exits_the_process_with_its_code():
    code = (
        "from ruleset_analysis_tpu_torch.runtime import faults\n"
        "faults.arm(faults.FaultPlan.parse('feeder.worker.crash@2'))\n"
        "faults.fire('feeder.worker.crash', crash_rc=7)\n"
        "print('survived the first hit', flush=True)\n"
        "faults.fire('feeder.worker.crash', crash_rc=7)\n"
        "print('not reached')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 7
    assert out.stdout.strip() == "survived the first hit"


def test_the_new_error_classes_follow_the_references():
    for name in ("InjectedFault", "AnalyzerContradiction"):
        cls, rcls = getattr(errors, name), getattr(rerrors, name)
        assert issubclass(cls, errors.AnalysisError) and issubclass(rcls, rerrors.AnalysisError)
        assert errors.exit_code_for(cls("x")) == rerrors.exit_code_for(rcls("x")) == 1
