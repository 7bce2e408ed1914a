"""`analyze` and `run --static-analysis` through both command lines.

Each command line runs through the port's CLI (on the CPU) and the
reference's (a one-device mesh) over the same synthetic rulesets and
corpus.  `analyze --json` must give the same object apart from
``meta.duration_sec``, and the text view the same lines apart from the
header's seconds.  `run --static-analysis` over text, a weighted
`.rawire`, `--backend oracle` and `--no-exact-counts` must give the same
report apart from ``VOLATILE_TOTALS``, ``totals.backend`` and
``totals.static.meta.duration_sec``; rank 0 of a two-process gloo
`--distributed` run carries the single-process run's ``totals.static``.
Exit codes agree: 2 for the refused flags, 1 for a fired `analyze.tile`
fault (with no `--out` file written) and for a hit on a provably dead
rule.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
B = 256
SKETCH = ("--cms-width", "1024", "--hll-p", "6")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 3 ACL x 16 rule ruleset with 2400 Zipf-repeated lines and a
    weighted wire file; a dual-stack 2 x 24 ruleset; the log split in two
    halves for the distributed run."""
    d = tmp_path_factory.mktemp("analyze")
    assert cli.main(["synth", "--out-dir", str(d), "--acls", "3", "--rules", "16", "--lines",
                     "2400", "--flows", "300", "--seed", "5"]) == 0
    prefix, log = str(d / "fw1"), str(d / "fw1.log")
    w = str(d / "w.rawire")
    assert cli.main(["convert", "--ruleset", prefix, "--logs", log, "--out", w,
                     "--coalesce"]) == 0
    lines = Path(log).read_text().splitlines(keepends=True)
    halves = [str(d / f"half{i}.log") for i in range(2)]
    for i, path in enumerate(halves):
        Path(path).write_text("".join(lines[i * 1200:(i + 1) * 1200]))
    d6 = d / "v6"
    assert cli.main(["synth", "--out-dir", str(d6), "--acls", "2", "--rules", "24", "--lines",
                     "500", "--seed", "2", "--v6-fraction", "0.3"]) == 0
    ensure_reference_native()
    return {"d": d, "prefix": prefix, "log": log, "weighted": w, "halves": halves,
            "cfg": str(d / "fw1.cfg"), "prefix6": str(d6 / "fw1")}


@pytest.fixture
def ref_one_device(monkeypatch):
    make = rmesh.make_mesh
    monkeypatch.setattr(rmesh, "make_mesh",
                        lambda devices=None, *a, **k: make(jax.devices()[:1], *a, **k))


def _rc(main, args):
    try:
        return main(list(args))
    except SystemExit as e:
        return e.code


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _strip_report(obj):
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    if "static" in obj["totals"]:
        obj["totals"]["static"]["meta"].pop("duration_sec")
    return obj


# --- analyze --------------------------------------------------------------------


def _analyze_both(tmp_path, prefix, flags, json_out=True):
    outs = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]), ("ref", rcli.main, [])):
        path = tmp_path / f"{side}-analyze.out"
        rc = _rc(main, ["analyze", "--ruleset", prefix, "--out", str(path),
                        *(["--json"] if json_out else []), *extra, *flags])
        outs[side] = (rc, path.read_text() if path.exists() else None)
    return outs


@pytest.mark.parametrize("which,flags", [
    ("prefix", []), ("prefix", ["--tile", "8"]), ("prefix", ["--witness-budget", "2"]),
    ("prefix6", []), ("prefix6", ["--tile", "16", "--witness-budget", "64"]),
])
def test_analyze_json_equals_the_references(corpus, tmp_path, which, flags):
    outs = _analyze_both(tmp_path, corpus[which], flags)
    assert outs["port"][0] == outs["ref"][0] == 0
    port, ref = (json.loads(outs[s][1]) for s in ("port", "ref"))
    for obj in (port, ref):
        obj["meta"].pop("duration_sec")
    assert port == ref
    assert port["meta"]["complete"] is True and port["meta"]["tiles_run"] > 0


@pytest.mark.parametrize("which", ["prefix", "prefix6"])
def test_analyze_text_equals_the_references(corpus, tmp_path, which):
    outs = _analyze_both(tmp_path, corpus[which], [], json_out=False)
    assert outs["port"][0] == outs["ref"][0] == 0
    port, ref = (outs[s][1].splitlines() for s in ("port", "ref"))
    assert port[1:] == ref[1:]
    assert port[0].rsplit("(", 1)[0] == ref[0].rsplit("(", 1)[0]
    assert port[0].startswith("# static analysis: 48 rules" if which == "prefix" else
                              "# static analysis: 48 rules, 2 ACLs")


def test_analyze_prints_to_stdout_without_out(corpus, capsys):
    assert cli.main(["analyze", "--ruleset", corpus["prefix"], "--device", "cpu",
                     "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["meta"]["n_rules"] == 48


@pytest.mark.parametrize("plan", ["analyze.tile@1", "analyze.tile@2", "FILE"])
def test_fired_tile_fault_exits_1_and_writes_nothing(corpus, tmp_path, capsys, plan):
    if plan == "FILE":
        spec = tmp_path / "plan.txt"
        spec.write_text("analyze.tile@3,seed=4\n")
        plan = f"@{spec}"
    outs = _analyze_both(tmp_path, corpus["prefix"], ["--fault-plan", plan])
    assert outs["port"] == outs["ref"] == (1, None)
    err = capsys.readouterr().err
    assert err.count("error: injected fault: analyze.tile (hit") == 2
    # disarmed after the call: the next analysis completes
    assert _analyze_both(tmp_path, corpus["prefix"], [])["port"][0] == 0
    assert "RA_FAULT_PLAN" not in os.environ


@pytest.mark.parametrize("flags", [
    ["--fault-plan", "no.such.site@1"], ["--fault-plan", "@/nonexistent/plan"],
    ["--fault-plan", "analyze.tile@9"],
])
def test_fault_plan_exit_codes_agree(corpus, tmp_path, capsys, flags):
    outs = _analyze_both(tmp_path, corpus["prefix"], flags)
    assert outs["port"][0] == outs["ref"][0]
    # a plan that never fires (the 3 ACLs run 3 tiles) changes nothing
    assert outs["port"][0] == (0 if flags[1] == "analyze.tile@9" else 1)
    capsys.readouterr()


@pytest.mark.parametrize("cmd,flags", [
    ("analyze", ["--witness-budget", "0"]), ("analyze", ["--tile", "0"]),
    ("run", ["--static-witness-budget", "64"]),
    ("run", ["--static-analysis", "--static-witness-budget", "0"]),
])
def test_refusals_exit_2_as_in_the_reference(corpus, tmp_path, capsys, cmd, flags):
    rcs, errs = [], []
    for main, extra in ((cli.main, ["--device", "cpu"]), (rcli.main, [])):
        args = [cmd, "--ruleset", str(tmp_path / "missing")]
        if cmd == "run":
            args += ["--logs", corpus["log"]]
        rcs.append(_rc(main, args + extra + flags))
        errs.append(capsys.readouterr().err)
    # refused before the (missing) ruleset loads, with the same message
    assert rcs == [2, 2]
    assert errs[0] == errs[1] and errs[0].startswith("error: --")


# --- run --static-analysis --------------------------------------------------------


def _run_both(c, tmp_path, logs, flags, *, oracle=False, sides=("port", "ref")):
    out = {}
    for side, main, extra in (
        ("port", cli.main, ["--device", "cpu"]),
        ("ref", rcli.main, [] if oracle else
         ["--blackbox", "off", "--checkpoint-dir", str(tmp_path / "ref-ck")]),
    ):
        if side not in sides:
            continue
        path = tmp_path / f"{side}.json"
        rc = _rc(main, ["run", "--ruleset", c["prefix"], "--logs", *logs, "--batch-size", str(B),
                        *SKETCH, "--topk", "600", "--json", "--out", str(path), *extra, *flags])
        out[side] = (rc, _strip_report(_load(path)) if rc == 0 else None)
    return out


#: name -> (input, run flags, static-analysis flags)
RUNS = {
    "text": ("log", [], []),
    "weighted wire": ("weighted", [], []),
    "oracle": ("log", ["--backend", "oracle", "--acl-configs", "CFG"], []),
    "--no-exact-counts": ("log", ["--no-exact-counts"], []),
    "budget 8": ("log", [], ["--static-witness-budget", "8"]),
}


@pytest.mark.parametrize("name", RUNS)
def test_run_static_analysis_equals_the_references(corpus, tmp_path, ref_one_device, name):
    kind, flags, static = RUNS[name]
    flags = [corpus["cfg"] if f == "CFG" else f for f in flags]
    got = _run_both(corpus, tmp_path, [corpus[kind]], [*flags, "--static-analysis", *static],
                    oracle="oracle" in name)
    assert got["port"][0] == got["ref"][0] == 0
    assert got["port"][1] == got["ref"][1]
    st = got["port"][1]["totals"]["static"]
    assert st["meta"]["complete"] is True
    assert sum(len(v) for v in st["unused_classes"].values()) == len(got["port"][1]["unused"])
    # the same run without the flag: the report apart from the static fields
    plain = _run_both(corpus, tmp_path, [corpus[kind]], flags, oracle="oracle" in name,
                      sides=("port",))["port"]
    joined = got["port"][1]
    joined["totals"].pop("static")
    for e in joined["per_rule"]:
        for k in ("verdict", "verdict_basis", "verdict_certified"):
            e.pop(k, None)
    assert joined == plain[1]


CONTRA_PACKED = """hostname fwc
access-list A extended permit tcp any any eq 80
access-list A extended permit tcp any any eq 80
access-group A in interface inside
"""
CONTRA_SEEN = """hostname fwc
access-list A extended permit tcp any any eq 81
access-list A extended permit tcp any any eq 80
access-group A in interface inside
"""
CONTRA_LOG = ("Jul 29 07:48:01 fwc : %ASA-6-106100: access-list A permitted tcp "
              "inside/10.0.0.1(1234) -> outside/10.0.0.2(80) hit-cnt 1 first hit [0x0, 0x0]\n")


def test_hit_on_a_dead_rule_exits_1_in_both(tmp_path, capsys):
    """The oracle counts over configs other than the packed ruleset's: its
    hit lands on rule 2, which the packed ruleset makes redundant."""
    cfg_packed, cfg_seen, log = (tmp_path / n for n in ("p.cfg", "s.cfg", "fwc.log"))
    cfg_packed.write_text(CONTRA_PACKED)
    cfg_seen.write_text(CONTRA_SEEN)
    log.write_text(CONTRA_LOG * 3)
    prefix = str(tmp_path / "packed")
    assert cli.main(["parse-acls", str(cfg_packed), "--out", prefix]) == 0
    rcs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (rcli.main, [])):
        base = ["run", "--ruleset", prefix, "--logs", str(log), "--backend", "oracle",
                "--acl-configs", str(cfg_seen), "--json", "--out", str(tmp_path / "r.json"),
                *extra]
        rcs.append((_rc(main, base), _rc(main, base + ["--static-analysis"])))
    assert rcs == [(0, 1), (0, 1)]
    err = capsys.readouterr().err
    assert err.count("rule fwc A 2 has 3 live hit(s) but a certified 'redundant'") == 2


def test_distributed_rank0_carries_the_same_static_totals(corpus, tmp_path, ref_one_device):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [tmp_path / f"r{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ruleset_analysis_tpu_torch.cli", "run", "--ruleset",
             corpus["prefix"], "--logs", corpus["halves"][i], "--device", "cpu", "--batch-size",
             str(B), *SKETCH, "--distributed", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i), "--static-analysis", "--json",
             "--out", str(outs[i])],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], results
    assert not outs[1].exists()  # only process 0 writes
    rank0 = _strip_report(_load(outs[0]))
    whole = _run_both(corpus, tmp_path, corpus["halves"], ["--static-analysis"])
    assert whole["port"][1]["totals"]["static"] == whole["ref"][1]["totals"]["static"]
    assert rank0["totals"]["static"] == whole["port"][1]["totals"]["static"]
    assert rank0["totals"]["lines_total"] == 2400
