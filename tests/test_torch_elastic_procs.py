"""Elastic runs of the port's CLI over gloo processes on the CPU.

The reference's acceptance drills (tests/test_elastic.py, the elastic
cases of tests/test_chaos.py) against the port: four launchers run `run
--distributed --elastic --device cpu` over four shards, and one of them
dies mid-run.  The survivors detect the loss, re-form at world 3 with a
re-elected coordinator, re-split the unread shards and resume from the
shared epoch checkpoint; the report's per-rule hits, unused set and line
totals, and the registers in ``result.npz``, equal the reference's
uninterrupted one-process run.  With ``--max-reforms 0`` every survivor
exits 7 and no report is written.

The victims: ``RA_ELASTIC_FAULT`` (the worker's ``os._exit`` after four
batches), the plan-driven ``elastic.worker.die@4``, and
``elastic.heartbeat.drop@6``, a partitioned member.  The partition drill
throttles the victim alone (``RA_ELASTIC_PACE``), so generation 0, whose
rounds are lockstep, outlasts the peers' staleness bound and kill grace
(the reference's run outlasts them by its jit compile), and generation 1,
without the victim, runs at full speed.

One-member drills (the chip smoke's ``phase_elastic`` at a small size):
a clean run equals the plain `run`; a generation failed by an exhausted
copy fault after its second epoch re-forms and gives the plain run's
registers; and with ``--max-reforms 0`` the launcher exits 7, the
postmortem holds the supervisor and the worker, and ``doctor`` names the
re-formation budget.

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
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.elastic import DIE_RC  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")
TIMEOUT = 240


def _corpus(td, egress: bool):
    """1600 lines over 3 ACLs in four shards of 400."""
    rs = aclparse.parse_asa_config(
        synth.synth_config(n_acls=3, rules_per_acl=8, seed=41, egress_acls=egress), "fw1")
    packed = pack.pack_rulesets([rs])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 1600, seed=42), seed=43,
                                variety=0.4)
    prefix = str(td / "packed")
    pack.save_packed(packed, prefix)
    shards = []
    for i in range(4):
        p = td / f"shard{i}.log"
        p.write_text("".join(ln + "\n" for ln in lines[i * 400:(i + 1) * 400]),
                     encoding="utf-8")
        shards.append(str(p))
    return prefix, shards


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference elastic test's corpus (egress bound: a batch closes
    early where a line's two evaluations do not fit)."""
    return _corpus(tmp_path_factory.mktemp("elastic_procs"), egress=True)


@pytest.fixture(scope="module")
def corpus1(tmp_path_factory):
    """The one-member drills' corpus: one evaluation a line, so at
    :data:`BATCH1` the shards cut into the plain run's chunks."""
    return _corpus(tmp_path_factory.mktemp("elastic_one"), egress=False)


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """The reference's uninterrupted one-process run over the shards at the
    CLI's geometry: its report and, from its final snapshot, its registers."""
    prefix, shards = corpus
    ck = str(tmp_path_factory.mktemp("elastic_ref") / "ck")
    rep = rstream.run_stream_file(
        rpack.load_packed(prefix), shards,
        JConfig(batch_size=64, checkpoint_every_chunks=1 << 20, checkpoint_dir=ck),
        mesh=rmesh.make_mesh(jax.devices()[:1]))
    return json.loads(rep.to_json()), rckpt.load(ck).arrays


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_REPO, *filter(None, [env.get("PYTHONPATH")])])
    env["OMP_NUM_THREADS"] = "1"  # eight small processes share the host
    for k in ("RA_FAULT_PLAN", "RA_ELASTIC_FAULT", "RA_ELASTIC_PACE"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def _launch(td, prefix, shards, n=4, *, env_of=None, extra=(), batch=64, timeout=TIMEOUT):
    """``n`` elastic launchers of the port's CLI; [(rc, stdout, stderr)]."""
    eldir = str(td / "eldir")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ruleset_analysis_tpu_torch.cli", "run", "--ruleset",
             prefix, "--logs", *shards, "--device", "cpu", "--distributed", "--elastic",
             "--elastic-dir", eldir, "--num-processes", str(n), "--process-id", str(tag),
             "--batch-size", str(batch), "--checkpoint-every", "2", "--json", "--out",
             str(td / f"rep{tag}.json"), *extra],
            env=_env(env_of(tag) if env_of else None), cwd=str(td),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in range(n)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        raise AssertionError("an elastic launcher hung (no bounded-time exit)") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return eldir, outs


def _hits(rep) -> dict:
    return {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep["per_rule"]}


def _check_against_reference(td, eldir, reference, world):
    ref, ref_regs = reference
    rep = json.loads((td / "rep0.json").read_text(encoding="utf-8"))
    t = rep["totals"]
    assert t["processes"] == world
    assert t["elastic_epoch"] >= 1
    rec = t["recovery"]
    assert rec["reforms_used"] >= 1 and rec["recovery_events"] >= 1
    assert all(e["time_to_recover_sec"] >= 0 for e in rec["recoveries"])
    assert _hits(rep) == _hits(ref)
    assert rep["unused"] == ref["unused"]
    assert t["lines_total"] == ref["totals"]["lines_total"] == 1600
    for k in ("lines_matched", "lines_skipped"):
        assert t[k] == ref["totals"][k], k
    regs = np.load(os.path.join(eldir, "result.npz"))
    for k in REGISTERS:
        np.testing.assert_array_equal(regs[k], ref_regs[k], err_msg=k)
    # rendezvous hygiene: no temp-write litter survives the run
    litter = [os.path.join(root, e) for root, _d, files in os.walk(eldir) for e in files
              if e.endswith(".tmp") or e.startswith(".tmp-")]
    assert not litter, litter
    return rep


def test_kill_one_of_four_reforms_at_world_three(corpus, reference, tmp_path):
    """Tag 2's worker dies after four batches: the survivors re-form at
    world 3 and the report and registers are the uninterrupted run's."""
    prefix, shards = corpus
    eldir, outs = _launch(tmp_path, prefix, shards,
                          env_of=lambda tag: {"RA_ELASTIC_FAULT": "tag=2,after_batches=4"})
    assert outs[2][0] == DIE_RC, outs[2][2][-2000:]
    for tag in (0, 1, 3):
        assert outs[tag][0] == 0, f"survivor {tag} rc={outs[tag][0]}\n{outs[tag][2][-3000:]}"
    _check_against_reference(tmp_path, eldir, reference, world=3)
    assert not any((tmp_path / f"rep{t}.json").exists() for t in (1, 2, 3))


def test_max_reforms_zero_exits_seven_on_every_survivor(corpus, tmp_path):
    prefix, shards = corpus
    eldir, outs = _launch(tmp_path, prefix, shards, extra=("--max-reforms", "0"),
                          env_of=lambda tag: {"RA_ELASTIC_FAULT": "tag=1,after_batches=4"})
    # normally the injected death; an unrelated generation failure that
    # raced ahead exits 7 on the victim too
    assert outs[1][0] in (DIE_RC, 7), outs[1][2][-1500:]
    for tag in (0, 2, 3):
        rc, _out, err = outs[tag]
        assert rc == 7, f"launcher {tag} rc={rc}\n{err[-1500:]}"
        assert "budget exhausted" in err, err[-1500:]
    assert not any((tmp_path / f"rep{t}.json").exists() for t in range(4))
    assert not os.path.exists(os.path.join(eldir, "result.json"))


def test_plan_driven_worker_death_reforms(corpus, reference, tmp_path):
    """``elastic.worker.die@4`` in the victim's environment only."""
    prefix, shards = corpus
    eldir, outs = _launch(tmp_path, prefix, shards,
                          env_of=lambda tag: {"RA_FAULT_PLAN": "elastic.worker.die@4"}
                          if tag == 2 else {})
    assert outs[2][0] == DIE_RC, outs[2][2][-2000:]
    for tag in (0, 1, 3):
        assert outs[tag][0] == 0, f"survivor {tag} rc={outs[tag][0]}\n{outs[tag][2][-3000:]}"
    _check_against_reference(tmp_path, eldir, reference, world=3)


def test_partitioned_member_is_left_behind(corpus, reference, tmp_path):
    """``elastic.heartbeat.drop@6``: the peers re-form at world 3 without
    the victim, which aborts typed instead of computing on."""
    prefix, shards = corpus
    eldir, outs = _launch(
        tmp_path, prefix, shards, batch=16,
        env_of=lambda tag: {"RA_FAULT_PLAN": "elastic.heartbeat.drop@6",
                            "RA_ELASTIC_PACE": "1.0"} if tag == 2 else {})
    assert outs[2][0] != 0, "the partitioned member claimed success"
    assert "missed generation" in outs[2][2] or "budget" in outs[2][2], outs[2][2][-2000:]
    for tag in (0, 1, 3):
        assert outs[tag][0] == 0, f"survivor {tag} rc={outs[tag][0]}\n{outs[tag][2][-3000:]}"
    rep = _check_against_reference(tmp_path, eldir, reference, world=3)
    assert rep["totals"]["recovery"]["recoveries"][0]["reason"] == "peer heartbeat lost"


# ---------------------------------------------------------------------------
# One member: the chip smoke's drills at a small size
# ---------------------------------------------------------------------------


#: the one-member drills' batch: 5 chunks a shard, 20 in all
BATCH1 = 80


def _plain(corpus):
    prefix, shards = corpus
    rep, regs = run_stream_file(pack.load_packed(prefix), shards,
                                AnalysisConfig(batch_size=BATCH1, device="cpu"),
                                return_state=True)
    return json.loads(rep.to_json()), regs


def _strip(rep) -> dict:
    rep = json.loads(json.dumps(rep))
    for k in (*VOLATILE_TOTALS, "backend", "processes", "elastic_epoch", "recovery"):
        rep["totals"].pop(k, None)
    return rep


def test_one_member_clean_run_is_the_plain_runs(corpus1, tmp_path):
    prefix, shards = corpus1
    eldir, outs = _launch(tmp_path, prefix, shards, n=1, batch=BATCH1)
    assert outs[0][0] == 0, outs[0][2][-3000:]
    rep = json.loads((tmp_path / "rep0.json").read_text(encoding="utf-8"))
    t = rep["totals"]
    assert (t["elastic_epoch"], t["recovery"]["reforms_used"], t["processes"]) == (0, 0, 1)
    plain, regs = _plain(corpus1)
    assert _strip(rep) == _strip(plain)
    got = np.load(os.path.join(eldir, "result.npz"))
    for k in REGISTERS:
        np.testing.assert_array_equal(got[k], regs[k], err_msg=k)


#: 20 chunks, epochs every 8: the copy of chunk 18 fails past its retries
#: (hits 18-22), after generation 0's second epoch (chunk 16); generation 1
#: steps the 4 chunks from that epoch, under 18 hits
ONE_MEMBER_PLAN = "stream.device_put.fail@18:99"


def _one_member_drill(corpus, td, *extra):
    prefix, shards = corpus
    return _launch(td, prefix, shards, n=1, batch=BATCH1, extra=(
        "--checkpoint-every", "8", "--retry-policy", "device_put=5/0.001", *extra),
        env_of=lambda tag: {"RA_FAULT_PLAN": ONE_MEMBER_PLAN})


def test_one_member_reforms_after_a_failed_generation(corpus1, tmp_path):
    eldir, outs = _one_member_drill(corpus1, tmp_path)
    assert outs[0][0] == 0, outs[0][2][-3000:]
    rep = json.loads((tmp_path / "rep0.json").read_text(encoding="utf-8"))
    t = rep["totals"]
    rec = t["recovery"]
    assert (t["elastic_epoch"], rec["reforms_used"], rec["recovery_events"]) == (1, 1, 1)
    with open(os.path.join(eldir, "gen-1", "worker-0.log"), encoding="utf-8") as f:
        assert "starts at epoch chunk 16" in f.read()
    plain, regs = _plain(corpus1)
    assert _hits(rep) == _hits(plain) and rep["unused"] == plain["unused"]
    for k in ("lines_total", "lines_matched", "lines_skipped", "chunks"):
        assert t[k] == plain["totals"][k], k
    got = np.load(os.path.join(eldir, "result.npz"))
    for k in REGISTERS:
        np.testing.assert_array_equal(got[k], regs[k], err_msg=k)


def test_one_member_budget_leaves_a_postmortem_doctor_reads(corpus1, tmp_path, capsys):
    bb = str(tmp_path / "bb")
    eldir, outs = _one_member_drill(corpus1, tmp_path, "--max-reforms", "0",
                                    "--blackbox-dir", bb)
    rc, _out, err = outs[0]
    assert rc == 7 and "budget exhausted" in err, err[-3000:]
    assert not os.path.exists(os.path.join(eldir, "result.json"))
    assert not (tmp_path / "rep0.json").exists()
    with open(os.path.join(bb, "postmortem.json"), encoding="utf-8") as f:
        pm = json.load(f)
    roles = sorted(s["role"] for s in pm["shards"])
    assert roles == ["elastic-supervisor", "elastic-worker-0-gen0"], roles
    capsys.readouterr()
    out = str(tmp_path / "doctor.json")
    assert cli.main(["doctor", bb, "--json", "--out", out]) == 0
    with open(out, encoding="utf-8") as f:
        dj = json.load(f)
    assert dj["exit_code"] == 7
    causes = [x["cause"] for x in dj["diagnosis"]]
    assert "elastic re-formation budget exhausted (--max-reforms)" in causes, causes
