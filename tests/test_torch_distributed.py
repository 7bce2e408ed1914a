"""The port's multi-process runs (``torch.distributed`` over gloo) on the CPU.

Mirrors tests/test_distributed.py.  Worker processes
(``tests/_torch_dist_worker.py``) join a gloo job on a local TCP
coordinator, each feeding its own split of the corpus, and dump their
registers and report:

- 2 and 4 processes (uneven splits, one of them empty) give the
  registers, counts and unused set of one process over the whole corpus,
  on every rank; v6, wire and the stacked layout too;
- the report of a 2-process job equals the reference's 2-process job on
  the same mesh (one device a process, or two), apart from
  ``VOLATILE_TOTALS`` and ``totals.backend``, for text, wire, stacked and
  dual-stack input, and through ``run --distributed`` of both CLIs;
- a crashed job resumes from its ``proc-<i>-of-<n>`` snapshots to the
  uninterrupted registers; stale foreign layout directories do not block
  a resume; a corrupt snapshot on one process fails every process, named;
- a killed peer fails the survivor in bounded time.

The reference's workers run jax with ``__graft_entry__.scrubbed_cpu_env``
fake devices.  The slow marks are the reference's (eight processes, and
the stacked, v6 and v6-stacked crash cases).  Tolerance 0 throughout.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS
from ruleset_analysis_tpu_torch import cli
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig
from ruleset_analysis_tpu_torch.errors import DistributedLayoutError
from ruleset_analysis_tpu_torch.hostside import aclparse, oracle, pack, synth, wire
from ruleset_analysis_tpu_torch.parallel import distributed as dist
from ruleset_analysis_tpu_torch.runtime.stream import _dist_ckpt_layout_error, run_stream_file

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TESTS = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_TESTS, "_torch_dist_worker.py")
_REF_WORKER = os.path.join(_TESTS, "dist_worker.py")
REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")
SKETCH = dict(cms_width=1 << 10, cms_depth=4, hll_p=6)
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_REPO, *filter(None, [env.get("PYTHONPATH")])])
    return env


def _ref_env(n_local: int) -> dict:
    sys.path.insert(0, _REPO)
    from __graft_entry__ import scrubbed_cpu_env

    env = scrubbed_cpu_env(n_local)
    env["RA_TEST_REEXEC"] = "1"
    return env


def _spawn(argvs, env, timeout=TIMEOUT):
    """One process per argv; kill all on timeout; [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen(a, env=env, cwd=_REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
            q.communicate()
        raise
    return outs


def _check(outs):
    for rc, _out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstderr:\n{err[-3000:]}"
    return outs


def _run(prefix, logs, outs, mode=None, ckpt="-", n_local=1, reference=False):
    """A job of len(logs) processes (the port's workers, or the reference's)."""
    port = _free_port()
    n = len(logs)
    if reference:
        argvs = [[sys.executable, _REF_WORKER, str(i), str(n), str(port), prefix, logs[i],
                  outs[i], *([ckpt, mode] if mode else [])] for i in range(n)]
        return _check(_spawn(argvs, _ref_env(n_local)))
    argvs = [[sys.executable, _WORKER, str(i), str(n), str(port), prefix, logs[i], outs[i],
              ckpt, mode or "-", str(n_local)] for i in range(n)]
    return _check(_spawn(argvs, _port_env()))


def _regs(path) -> dict:
    with np.load(path + ".npz") as z:
        return {k: z[k] for k in z.files}


def _rep(path) -> dict:
    with open(path + ".json", encoding="utf-8") as f:
        return json.load(f)


def _strip(obj) -> dict:
    obj = json.loads(json.dumps(obj))
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


def _hits(rep) -> dict:
    return {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep["per_rule"]}


def _assert_regs(a, b, what=""):
    for k in REGISTERS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} register {k}")


def _single(prefix, log):
    """The port's one-process run over the whole corpus (the worker's config)."""
    packed = pack.load_packed(prefix)
    cfg = AnalysisConfig(batch_size=64, sketch=SketchConfig(**SKETCH), device="cpu")
    rep, regs = run_stream_file(packed, [log], cfg, return_state=True)
    return json.loads(rep.to_json()), regs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference test's corpus: 1200 lines over 3 ACLs (egress bound)."""
    td = tmp_path_factory.mktemp("tdist")
    rs = aclparse.parse_asa_config(
        synth.synth_config(n_acls=3, rules_per_acl=8, seed=41, egress_acls=True), "fw1")
    packed = pack.pack_rulesets([rs])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 1200, seed=42), seed=43,
                                variety=0.4)
    prefix = str(td / "packed")
    pack.save_packed(packed, prefix)
    (td / "full.log").write_text("\n".join(lines) + "\n", encoding="utf-8")
    for i, part in enumerate((lines[:600], lines[600:])):
        (td / f"half{i}.log").write_text("\n".join(part) + "\n", encoding="utf-8")
        wire.convert_logs(packed, [str(td / f"half{i}.log")], str(td / f"half{i}.rawire"),
                          native=False, block_rows=64)
    sizes = (700, 300, 200, 0)
    pos = 0
    for i, n in enumerate(sizes):
        (td / f"q{i}.log").write_text("".join(ln + "\n" for ln in lines[pos:pos + n]),
                                      encoding="utf-8")
        pos += n
    return td, prefix, str(td / "full.log")


@pytest.fixture(scope="module")
def corpus6(tmp_path_factory):
    """The reference test's dual-stack corpus (700 v4 + 500 v6 lines)."""
    import random

    td = tmp_path_factory.mktemp("tdist6")
    rs = aclparse.parse_asa_config(
        synth.synth_config(n_acls=3, rules_per_acl=8, seed=51, v6_fraction=0.4), "fw1")
    packed = pack.pack_rulesets([rs])
    assert packed.has_v6
    lines = (synth.render_syslog(packed, synth.synth_tuples(packed, 700, seed=52), seed=54)
             + synth.render_syslog6(packed, synth.synth_tuples6(packed, 500, seed=53), seed=55))
    random.Random(5).shuffle(lines)
    res = oracle.Oracle([rs]).consume(list(lines))
    prefix = str(td / "packed")
    pack.save_packed(packed, prefix)
    (td / "full.log").write_text("\n".join(lines) + "\n", encoding="utf-8")
    for i, part in enumerate((lines[:600], lines[600:])):
        (td / f"half{i}.log").write_text("\n".join(part) + "\n", encoding="utf-8")
        wire.convert_logs(packed, [str(td / f"half{i}.log")], str(td / f"half{i}.rawire"),
                          native=False)
    return td, prefix, res


@pytest.mark.parametrize("split", ["halves", "uneven-with-empty"])
def test_processes_give_the_one_process_registers(corpus, split):
    td, prefix, full = corpus
    logs = ([str(td / "half0.log"), str(td / "half1.log")] if split == "halves"
            else [str(td / f"q{i}.log") for i in range(4)])
    outs = [str(td / f"p-{split}-{i}") for i in range(len(logs))]
    _run(prefix, logs, outs)
    rep1, regs1 = _single(prefix, full)
    for i, o in enumerate(outs):
        _assert_regs(_regs(o), regs1, f"rank {i}")
    rep = _rep(outs[0])
    assert rep["totals"]["processes"] == len(logs)
    for k in ("lines_total", "lines_matched", "lines_skipped"):
        assert rep["totals"][k] == rep1["totals"][k], k
    assert _hits(rep) == _hits(rep1)
    assert rep["unused"] == rep1["unused"]
    assert all(_strip(_rep(o)) == _strip(rep) for o in outs[1:])  # every rank, one report


@pytest.mark.parametrize("case", ["text", "wire", "stacked", "two-local-shards",
                                  "two-local-replicas", "v6", "v6-wire"])
def test_report_equals_the_references_distributed_run(corpus, corpus6, case):
    """Two processes of the port against two of the reference, on the same
    mesh: the whole report, talkers included."""
    if case.startswith("v6"):
        td, prefix, res = corpus6
    else:
        td, prefix, _ = corpus
    ext = "rawire" if case.endswith("wire") else "log"
    logs = [str(td / f"half{i}.{ext}") for i in range(2)]
    mode = "stacked" if case == "stacked" else None
    # two shards a process: on one device, or on two (a replica each,
    # merged in the process before the job's collectives)
    n_local = 2 if case.startswith("two-local") else 1
    mine = [str(td / f"m-{case}-{i}") for i in range(2)]
    ref = [str(td / f"r-{case}-{i}") for i in range(2)]
    _run(prefix, logs, mine, mode=mode, n_local=f"{n_local}r" if case.endswith("replicas")
         else n_local)
    _run(prefix, logs, ref, mode=mode, n_local=n_local, reference=True)
    _assert_regs(_regs(mine[0]), _regs(ref[0]))
    _assert_regs(_regs(mine[1]), _regs(ref[0]), "rank 1")
    assert _strip(_rep(mine[0])) == _strip(_rep(ref[0]))
    if case.startswith("v6"):
        got = {k: v for k, v in _hits(_rep(mine[0])).items() if v}
        assert got == dict(res.hits)
        assert _rep(mine[0])["talkers"] == _rep(mine[1])["talkers"]


def test_stacked_and_wire_registers_equal_the_flat_text_run(corpus):
    td, prefix, full = corpus
    _, regs1 = _single(prefix, full)
    for case, ext, mode in (("st", "log", "stacked"), ("w", "rawire", None)):
        outs = [str(td / f"{case}{i}") for i in range(2)]
        _run(prefix, [str(td / f"half{i}.{ext}") for i in range(2)], outs, mode=mode)
        for i, o in enumerate(outs):
            _assert_regs(_regs(o), regs1, f"{case} rank {i}")
        assert _rep(outs[0])["totals"]["lines_total"] == 1200


def _crash_resume(prefix, logs, td, tag, stacked=False):
    ck = str(td / f"ck-{tag}")
    u = [str(td / f"{tag}-u{i}") for i in range(2)]
    c = [str(td / f"{tag}-c{i}") for i in range(2)]
    r = [str(td / f"{tag}-r{i}") for i in range(2)]
    pre = "stacked-" if stacked else ""
    _run(prefix, logs, u, mode="stacked" if stacked else None)
    _run(prefix, logs, c, mode=pre + "crash", ckpt=ck)
    assert os.path.isdir(os.path.join(ck, "proc-0-of-2"))
    assert os.path.isdir(os.path.join(ck, "proc-1-of-2"))
    _run(prefix, logs, r, mode=pre + "resume", ckpt=ck)
    for i in range(2):
        _assert_regs(_regs(r[i]), _regs(u[0]), f"rank {i}")
    a, b = _rep(r[0]), _rep(u[0])
    assert a["unused"] == b["unused"]
    for k in ("lines_total", "lines_matched"):
        assert a["totals"][k] == b["totals"][k]


def test_crash_and_resume_equals_the_uninterrupted_run(corpus):
    td, prefix, _ = corpus
    _crash_resume(prefix, [str(td / f"half{i}.log") for i in range(2)], td, "flat")


@pytest.mark.slow  # the reference marks its stacked crash case slow
def test_stacked_crash_and_resume_equals_the_uninterrupted_run(corpus):
    td, prefix, _ = corpus
    _crash_resume(prefix, [str(td / f"half{i}.log") for i in range(2)], td, "stacked",
                  stacked=True)


@pytest.mark.slow  # the reference marks its v6 crash case slow
def test_v6_crash_and_resume_equals_the_uninterrupted_run(corpus6):
    td, prefix, _ = corpus6
    _crash_resume(prefix, [str(td / f"half{i}.log") for i in range(2)], td, "v6")


@pytest.mark.slow  # the reference marks its v6 stacked case slow
def test_v6_stacked_processes_equal_one_process(corpus6):
    td, prefix, res = corpus6
    outs = [str(td / f"v6st{i}") for i in range(2)]
    _run(prefix, [str(td / f"half{i}.log") for i in range(2)], outs, mode="stacked")
    _, regs1 = _single(prefix, str(td / "full.log"))
    _assert_regs(_regs(outs[0]), regs1)
    got = {k: v for k, v in _hits(_rep(outs[0])).items() if v}
    assert got == dict(res.hits)


@pytest.mark.slow  # the reference marks its eight-process case slow
def test_eight_processes_give_the_one_process_registers(corpus):
    td, prefix, full = corpus
    lines = open(full, encoding="utf-8").read().splitlines()
    logs = []
    for i in range(8):
        p = td / f"e{i}.log"
        p.write_text("".join(ln + "\n" for ln in lines[i * 150:(i + 1) * 150]), encoding="utf-8")
        logs.append(str(p))
    outs = [str(td / f"e{i}") for i in range(8)]
    _run(prefix, logs, outs)
    _, regs1 = _single(prefix, full)
    _assert_regs(_regs(outs[0]), regs1)
    _assert_regs(_regs(outs[7]), regs1, "rank 7")
    assert _rep(outs[0])["totals"]["processes"] == 8


def test_stacked_abort_drains_buffered_lines(corpus):
    td, prefix, _ = corpus
    outs = [str(td / f"sa{i}") for i in range(2)]
    _run(prefix, [str(td / f"half{i}.log") for i in range(2)], outs, mode="stacked-abort")
    regs, rep = _regs(outs[0]), _rep(outs[0])
    total = int(regs["counts_lo"].astype(np.uint64).sum()
                + (regs["counts_hi"].astype(np.uint64).sum() << np.uint64(32)))
    assert total == rep["totals"]["lines_matched"]  # no counted line in limbo
    assert 0 < rep["totals"]["lines_total"] < 1200  # aborted early


def test_stale_foreign_layout_dirs_do_not_block_resume(tmp_path):
    from ruleset_analysis_tpu.runtime.stream import _dist_ckpt_layout_error as ref_error

    ck = tmp_path / "ck"
    (ck / "proc-0-of-2").mkdir(parents=True)
    (ck / "proc-1-of-2").mkdir()
    assert _dist_ckpt_layout_error(str(ck), 4) is not None  # only foreign dirs
    assert ref_error(str(ck), 4) == _dist_ckpt_layout_error(str(ck), 4)
    (ck / "proc-0-of-4").mkdir()
    assert _dist_ckpt_layout_error(str(ck), 4) is None  # a matching set beside them
    assert _dist_ckpt_layout_error(str(ck), 2) is None
    assert _dist_ckpt_layout_error(str(tmp_path / "absent"), 2) is None


def test_corrupt_snapshot_in_one_process_fails_every_process(corpus):
    """Every process exits non-zero, in bounded time, and CheckpointCorrupt
    is named: the verdict is gathered before anyone raises."""
    td, prefix, _ = corpus
    ck = str(td / "ck-corrupt")
    logs = [str(td / f"half{i}.log") for i in range(2)]
    _run(prefix, logs, [str(td / f"x{i}") for i in range(2)], mode="crash", ckpt=ck)
    pdir = os.path.join(ck, "proc-1-of-2")
    latest = open(os.path.join(pdir, "LATEST")).read().strip()
    with open(os.path.join(pdir, latest, "state.npz"), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef" * 8)
    port = _free_port()
    outs = _spawn([[sys.executable, _WORKER, str(i), "2", str(port), prefix, logs[i],
                    str(td / f"z{i}"), ck, "resume"] for i in range(2)], _port_env())
    assert all(rc != 0 for rc, _, _ in outs), outs
    assert all("CheckpointCorrupt" in err for _, _, err in outs)


def test_killed_peer_fails_the_survivor_in_bounded_time(corpus):
    td, prefix, _ = corpus
    port = _free_port()
    logs = [str(td / f"half{i}.log") for i in range(2)]

    def argv(i, mode):
        return [sys.executable, _WORKER, str(i), "2", str(port), prefix, logs[i],
                str(td / f"k{i}"), "-", mode]

    t0 = time.monotonic()
    env = _port_env()
    survivor = subprocess.Popen(argv(0, "survivor"), env=env, cwd=_REPO, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    victim = subprocess.Popen(argv(1, "die"), env=env, cwd=_REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        _, verr = victim.communicate(timeout=60)
        assert victim.returncode == 3, verr[-2000:]
        _, serr = survivor.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        survivor.kill()
        victim.kill()
        survivor.communicate()
        victim.communicate()
        raise AssertionError("survivor hung after its peer died")
    assert survivor.returncode != 0, "survivor reported success despite a dead peer"
    assert time.monotonic() - t0 < 60
    assert serr.strip()


def _cli_argv(module, prefix, log, port, pid, out, *extra):
    return [sys.executable, "-m", module, "run", "--ruleset", prefix, "--logs", log,
            "--distributed", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(pid), "--batch-size", "64", "--json", "--out", out, *extra]


def test_cli_distributed_report_equals_the_references(corpus):
    """``run --distributed`` of the port's CLI (gloo, two processes) against
    the reference CLI's two-process job on a mesh of the same width; the
    counts and unused set also equal the reference's one-process run."""
    td, prefix, full = corpus
    logs = [str(td / f"half{i}.log") for i in range(2)]
    mine, ref, one = str(td / "cli_mine.json"), str(td / "cli_ref.json"), str(td / "cli1.json")
    port = _free_port()
    _check(_spawn([_cli_argv("ruleset_analysis_tpu_torch.cli", prefix, logs[i], port, i, mine,
                             "--device", "cpu") for i in range(2)], _port_env()))
    port = _free_port()
    _check(_spawn([_cli_argv("ruleset_analysis_tpu.cli", prefix, logs[i], port, i, ref,
                             "--backend", "tpu") for i in range(2)], _ref_env(1)))
    _check(_spawn([[sys.executable, "-m", "ruleset_analysis_tpu.cli", "run", "--ruleset",
                    prefix, "--logs", full, "--batch-size", "64", "--json", "--out", one]],
                  _ref_env(1)))
    got = json.loads(open(mine, encoding="utf-8").read())
    assert got["totals"]["processes"] == 2
    assert got["totals"]["lines_total"] == 1200
    assert _strip(got) == _strip(json.loads(open(ref, encoding="utf-8").read()))
    single = json.loads(open(one, encoding="utf-8").read())
    assert _hits(got) == _hits(single)
    assert got["unused"] == single["unused"]
    for k in ("lines_total", "lines_matched", "lines_skipped"):
        assert got["totals"][k] == single["totals"][k], k


@pytest.mark.parametrize("extra", [
    ("--logs", "-"),
    ("--coalesce", "on"),
    ("--feed-workers", "2"),
    ("--feed-workers", "1", "--feed-mode", "ring"),
])
def test_cli_distributed_refusals_are_the_references(corpus, extra, capsys):
    from ruleset_analysis_tpu import cli as rcli

    td, prefix, _ = corpus
    base = ["run", "--ruleset", prefix, "--logs", str(td / "half0.log"), "--distributed",
            "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "2",
            "--process-id", "0"]
    argv = base + list(extra)
    assert cli.main([*argv, "--device", "cpu"]) == 2
    assert rcli.main(argv) == 2
    capsys.readouterr()


def test_two_ranks_are_never_put_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(DistributedLayoutError, match="two ranks would share a card"):
        dist.init_distributed("127.0.0.1:1", 2, 1, device="cuda")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert dist.local_rank(0) == 3
    assert not torch.distributed.is_initialized()


def test_one_process_group_helpers():
    """The host-side collectives in a one-process gloo job."""
    dist.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, timeout=30, device="cpu")
    try:
        assert (dist.process_count(), dist.process_index()) == (1, 0)
        mesh = dist.make_global_mesh()
        assert mesh.devices == (torch.device("cpu"),) and mesh.n_processes == 1
        hyb = dist.make_global_mesh(topology="hybrid", devices=[torch.device("cpu")] * 4)
        assert hyb.shape == {"dcn": 2, "data": 2}
        assert dist.all_processes_have_data(True) and not dist.all_processes_have_data(False)
        assert dist.value_across_processes(7).tolist() == [7]
        rows = np.array([[1, 2], [0xFFFFFFFF, 3]], dtype=np.uint32)
        np.testing.assert_array_equal(dist.allgather_rows(rows), rows)
        assert dist.allgather_rows(np.zeros((0, 5), np.uint32)).shape == (0, 5)
        assert dist.sum_across_processes({"b": 2, "a": 1}) == {"a": 1, "b": 2}
    finally:
        dist.shutdown()
    assert not torch.distributed.is_initialized()
