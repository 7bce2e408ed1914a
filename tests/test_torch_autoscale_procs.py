"""Autoscaled elastic runs of the port's CLI over gloo processes on the CPU.

The reference's autoscale drills (tests/test_autoscale.py, its elastic
actuation section) against the port, on the reference's corpus: 3 ACLs of
8 rules with egress ACLs, 1600 lines in four shards of 400, batch 64, an
epoch every 2 chunks.  ``RA_ELASTIC_PACE`` sleeps a batch in every worker,
so a generation lasts at least its batches times the pace whatever the
host's speed, and the scripted ``--autoscale-plan`` entries, timed from
each generation's spawn, land inside the generation they are meant for.

- the plan drill: ``out@2,in@6`` over four launchers from world 2 re-forms
  2 -> 3 -> 2 with the standbys parking and joining; the report's hits,
  unused set and line totals are the reference's uninterrupted run's and
  ``result.npz`` its registers; the reference's ``tools/trace_summary.py``
  reads the merged ``--trace-out`` to the report's ``totals.autoscale``;
- ``autoscale.spawn@1``: both members of a scale-in abort typed (exit 1,
  "injected", no traceback), no report, and the epoch loads;
- a planned scale-out racing the death of the member it promotes: the
  survivors finish to the reference's hits and unused set;
- ``autoscale.decide@1`` with a plan: the leader's controller error is a
  typed abort, so is the backfilled standby's, and no ``scale.json`` or
  report is written;
- ``slow``: the signal-driven scale-out (no plan), whose decision rests on
  the wall-clock signals of the host.

Every ``communicate`` has a timeout, after which every launcher is killed.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import obs  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.autoscale import (  # noqa: E402
    ingest_signals, read_decision_log,
)
from ruleset_analysis_tpu_torch.runtime.elastic import DIE_RC  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")
TIMEOUT = 240


def _corpus(td, n_lines: int, n_shards: int = 4):
    rs = aclparse.parse_asa_config(
        synth.synth_config(n_acls=3, rules_per_acl=8, seed=41, egress_acls=True), "fw1")
    packed = pack.pack_rulesets([rs])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, n_lines, seed=42), seed=43,
                                variety=0.4)
    prefix = str(td / "packed")
    pack.save_packed(packed, prefix)
    q = n_lines // n_shards
    shards = []
    for i in range(n_shards):
        p = td / f"shard{i}.log"
        p.write_text("".join(ln + "\n" for ln in lines[i * q:(i + 1) * q]), encoding="utf-8")
        shards.append(str(p))
    return prefix, shards


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("autoscale_procs"), 1600)


def _uninterrupted(prefix, shards, tmp_path_factory):
    """The reference's one-process run over the shards at the CLI's batch:
    its report and, from its final snapshot, its registers."""
    ck = str(tmp_path_factory.mktemp("autoscale_ref") / "ck")
    rep = rstream.run_stream_file(
        rpack.load_packed(prefix), shards,
        JConfig(batch_size=64, checkpoint_every_chunks=1 << 20, checkpoint_dir=ck),
        mesh=rmesh.make_mesh(jax.devices()[:1]))
    return json.loads(rep.to_json()), rckpt.load(ck).arrays


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    return _uninterrupted(*corpus, tmp_path_factory)


def _env(extra: dict) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_REPO, *filter(None, [env.get("PYTHONPATH")])])
    env["OMP_NUM_THREADS"] = "1"  # up to eight small processes share the host
    for k in ("RA_FAULT_PLAN", "RA_ELASTIC_FAULT", "RA_ELASTIC_PACE", "RA_TRACE_DIR"):
        env.pop(k, None)
    env.update(extra)
    return env


def _launch(td, prefix, shards, n, flags, *, pace, env=None, extra=(), timeout=TIMEOUT):
    """``n`` autoscaled elastic launchers of the port's CLI; [(rc, stdout, stderr)]."""
    eldir = str(td / "eldir")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ruleset_analysis_tpu_torch.cli", "run", "--ruleset",
             prefix, "--logs", *shards, "--device", "cpu", "--distributed", "--elastic",
             "--elastic-dir", eldir, "--num-processes", str(n), "--process-id", str(tag),
             "--batch-size", "64", "--checkpoint-every", "2", "--autoscale", *flags,
             *extra, "--json", "--out", str(td / f"rep{tag}.json")],
            env=_env({"RA_ELASTIC_PACE": str(pace), **(env or {})}), cwd=str(td),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in range(n)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        raise AssertionError("an autoscale launcher hung (no bounded-time exit)") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return eldir, outs


def _hits(rep) -> dict:
    return {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep["per_rule"]}


def _same_answer(rep, ref) -> None:
    assert _hits(rep) == _hits(ref)
    assert rep["unused"] == ref["unused"]
    for k in ("lines_total", "lines_matched", "lines_skipped"):
        assert rep["totals"][k] == ref["totals"][k], k


def _typed_abort(out) -> None:
    rc, _o, err = out
    assert rc == 1, f"rc={rc}\n{err[-2000:]}"
    assert "injected" in err.lower() and "Traceback" not in err, err[-2000:]


def test_plan_drill_scales_out_and_in_to_the_uninterrupted_answer(corpus, reference, tmp_path):
    """``out@2,in@6`` over a pool of four from world 2: two planned
    re-formations, 2 -> 3 -> 2.  At pace 0.5 a generation of world 3 lasts
    past 7 s (rank 0 holds two shards, 14 batches), so ``in@6`` lands in it."""
    prefix, shards = corpus
    trace = str(tmp_path / "trace")
    eldir, outs = _launch(
        tmp_path, prefix, shards, 4,
        ["--autoscale-min", "2", "--autoscale-max", "4", "--autoscale-initial", "2",
         "--autoscale-budget", "3", "--autoscale-plan", "out@2,in@6", "--autoscale-poll", "0.1"],
        pace=0.5, extra=("--trace-out", trace))
    for tag, (rc, _out, err) in enumerate(outs):
        assert rc == 0, f"launcher {tag} rc={rc}\n{err[-3000:]}"
    rep = json.loads((tmp_path / "rep0.json").read_text(encoding="utf-8"))
    assert not any((tmp_path / f"rep{t}.json").exists() for t in (1, 2, 3))
    a = rep["totals"]["autoscale"]
    assert (a["scale_events"], a["scale_out"], a["scale_in"], a["final_world"]) == (2, 1, 1, 2)
    assert [(d["direction"], d["from_world"], d["to_world"], d["reason"], d["actuate"])
            for d in a["decisions"]] == [("out", 2, 3, "plan", True), ("in", 3, 2, "plan", True)]
    assert [(r["applied_seq"], r["gen"], r["world"]) for r in a["applied"]] == [(1, 1, 3),
                                                                                  (2, 2, 2)]
    assert all(r["time_to_effect_sec"] >= 0 for r in a["applied"])
    assert rep["totals"]["recovery"]["reforms_used"] == 0  # planned, never failures
    log = read_decision_log(os.path.join(eldir, "scale-log.jsonl"))
    assert sum(1 for r in log if r.get("kind") == "applied") == 2
    for g, (world, standby) in enumerate((([0, 1], [2, 3]), ([0, 1, 2], [3]),
                                          ([0, 1], [2, 3]))):
        with open(os.path.join(eldir, f"gen-{g}", "plan.json"), encoding="utf-8") as f:
            plan = json.load(f)
        assert (plan["world"], plan["standby"], plan["scale_seq"]) == (world, standby, g)
    _same_answer(rep, reference[0])
    assert rep["totals"]["lines_total"] == 1600
    # the signal source: the rank-0 shards carry the ingest gauges, and two
    # snapshots a >= 1 s stride apart differentiate (rank 0 streams ~7 s in
    # all over generations 1 and 2, so one of them streams long enough on
    # any host; a worker retired before it armed its plane left no shard);
    # the last generation, which ran to its end, closed its shard with the
    # final record
    shards_ = []
    for g in range(3):
        path = os.path.join(eldir, f"gen-{g}", "metrics-0.jsonl")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                shards_.append([json.loads(ln) for ln in f])
    assert shards_[-1][-1]["kind"] == "final"
    pairs = []
    for recs in shards_:
        snaps = [r for r in recs if r["kind"] == "snapshot"
                 and {"backpressure_sec", "starved_sec"} <= set(r.get("ingest") or {})]
        pairs += [(a_, next(b_ for b_ in snaps[i:] if b_["t"] - a_["t"] >= 1.0))
                  for i, a_ in enumerate(snaps) if snaps[-1]["t"] - a_["t"] >= 1.0]
    assert pairs and all(ingest_signals(a_, b_) is not None for a_, b_ in pairs)
    regs = np.load(os.path.join(eldir, "result.npz"))
    for k in REGISTERS:
        np.testing.assert_array_equal(regs[k], reference[1][k], err_msg=k)

    # the trace alone tells the same story: the reference's summarizer over
    # the merged shards of every launcher and worker
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        import trace_summary
    finally:
        sys.path.pop(0)
    s = trace_summary.summarize(obs.merge_trace(trace))["autoscale"]
    assert (s["scale_out"], s["scale_in"], s["flaps"]) == (a["scale_out"], a["scale_in"],
                                                           a["flaps"])
    # every member of a retired world retires its worker; every member out
    # of a generation's world parks once in it
    assert s["retirements"] == sum(d["from_world"] for d in a["decisions"]) == 5
    worlds = [a["decisions"][0]["from_world"]] + [r["world"] for r in a["applied"]]
    assert s["standby_parks"] == sum(4 - w for w in worlds) == 5
    assert [(d["seq"], d["direction"], d["from_world"], d["to_world"]) for d in s["decisions"]] == [
        (1, "out", 2, 3), (1, "in", 3, 2)]


def test_spawn_fault_aborts_typed_over_an_intact_epoch(corpus, tmp_path):
    """``autoscale.spawn@1`` in both members of a world of two: the scale-in
    at 12 s retires both workers, and both supervisors fail between the
    retirement and the next formation.  An epoch a chunk, at pace 1.5: the
    first epoch lands 1.5 s into the stream (a worker that starts in under
    10 s, even on a loaded host), and 14 batches outlast the scale-in."""
    prefix, shards = corpus
    eldir, outs = _launch(
        tmp_path, prefix, shards, 2,
        ["--autoscale-min", "1", "--autoscale-max", "2", "--autoscale-initial", "2",
         "--autoscale-budget", "2", "--autoscale-plan", "in@12", "--autoscale-poll", "0.1"],
        pace=1.5, extra=("--checkpoint-every", "1", "--fault-plan", "autoscale.spawn@1"))
    for out in outs:
        _typed_abort(out)
        assert "autoscale.spawn" in out[2]
    assert not any((tmp_path / f"rep{t}.json").exists() for t in (0, 1))
    assert not os.path.exists(os.path.join(eldir, "result.json"))
    log = read_decision_log(os.path.join(eldir, "scale-log.jsonl"))
    assert [(r["direction"], r["actuate"]) for r in log] == [("in", True)]  # never applied
    snap = ckpt.load(os.path.join(eldir, "epoch"))
    assert snap is not None and snap.extra["elastic"]["cursors"] and snap.n_chunks >= 1


def test_a_scale_out_racing_a_death_finishes_to_the_answer(corpus, reference, tmp_path):
    """From world 3 with tag 3 parked, ``out@2`` promotes tag 3, whose worker
    dies after six batches (or its generation finishes first: both are
    legal interleavings); the survivors finish to the uninterrupted answer."""
    prefix, shards = corpus
    eldir, outs = _launch(
        tmp_path, prefix, shards, 4,
        ["--autoscale-min", "2", "--autoscale-max", "4", "--autoscale-initial", "3",
         "--autoscale-budget", "2", "--autoscale-plan", "out@2", "--autoscale-poll", "0.1"],
        pace=0.4, env={"RA_ELASTIC_FAULT": "tag=3,after_batches=6"},
        extra=("--max-reforms", "2"))
    assert outs[3][0] in (DIE_RC, 0), f"victim rc={outs[3][0]}\n{outs[3][2][-2000:]}"
    for tag in (0, 1, 2):
        rc, _out, err = outs[tag]
        assert rc == 0, f"survivor {tag} rc={rc}\n{err[-3000:]}"
    rep = json.loads((tmp_path / "rep0.json").read_text(encoding="utf-8"))
    _same_answer(rep, reference[0])
    a = rep["totals"]["autoscale"]
    assert a["scale_events"] >= 1 and a["scale_out"] == 1
    if outs[3][0] == DIE_RC:
        assert rep["totals"]["recovery"]["reforms_used"] >= 1
    regs = np.load(os.path.join(eldir, "result.npz"))
    for k in REGISTERS:
        np.testing.assert_array_equal(regs[k], reference[1][k], err_msg=k)


def test_a_decide_fault_aborts_typed_and_publishes_nothing(corpus, tmp_path):
    """``autoscale.decide@1`` in both members of a pool of two from world 1:
    the leader's controller fails at ``out@1``, and the leader kills its
    worker and aborts typed; the standby backfills it once its heartbeat is
    stale, and its own controller fails the same way."""
    prefix, shards = corpus
    eldir, outs = _launch(
        tmp_path, prefix, shards, 2,
        ["--autoscale-min", "1", "--autoscale-max", "2", "--autoscale-initial", "1",
         "--autoscale-plan", "out@1", "--autoscale-poll", "0.1"],
        pace=0.5, extra=("--fault-plan", "autoscale.decide@1"))
    for out in outs:
        _typed_abort(out)
        assert "autoscale.decide" in out[2]
    assert not os.path.exists(os.path.join(eldir, "scale.json"))
    assert read_decision_log(os.path.join(eldir, "scale-log.jsonl")) == []
    assert not any((tmp_path / f"rep{t}.json").exists() for t in (0, 1))
    with open(os.path.join(eldir, "gen-1", "plan.json"), encoding="utf-8") as f:
        assert json.load(f)["world"] == [1]


@pytest.mark.slow
def test_signal_driven_scale_out(tmp_path, tmp_path_factory):
    """No plan: the consumer is the bottleneck, so rank 0's metrics shard
    shows sustained producer backpressure and the policy scales 2 -> 3 from
    the live signals.  The reference's drill paces its producer at 0.05 s a
    batch over 2400 lines; the port's CPU step outruns that producer (its
    shard reads starvation), so here the producer runs unpaced over 24000
    lines, long enough for the sustain window."""
    prefix, shards = _corpus(tmp_path, 24000)
    eldir, outs = _launch(
        tmp_path, prefix, shards, 3,
        ["--autoscale-min", "2", "--autoscale-max", "3", "--autoscale-initial", "2",
         "--autoscale-budget", "2", "--autoscale-out-threshold", "0.2",
         "--autoscale-sustain", "1.5", "--autoscale-cooldown", "5.0", "--autoscale-poll", "0.2"],
        pace=0)
    for tag, (rc, _out, err) in enumerate(outs):
        assert rc == 0, f"launcher {tag} rc={rc}\n{err[-3000:]}"
    rep = json.loads((tmp_path / "rep0.json").read_text(encoding="utf-8"))
    a = rep["totals"]["autoscale"]
    assert a["scale_out"] >= 1 and a["final_world"] == 3 and a["flaps"] == 0
    d = next(x for x in a["decisions"] if x["direction"] == "out")
    assert d["reason"] == "backpressure" and d["evidence"]["pressure"]["min"] >= 0.2
    ref, regs = _uninterrupted(prefix, shards, tmp_path_factory)
    _same_answer(rep, ref)
    got = np.load(os.path.join(eldir, "result.npz"))
    for k in REGISTERS:
        np.testing.assert_array_equal(got[k], regs[k], err_msg=k)
