"""The port stands alone: no JAX, nothing of the reference package.

Every module of the port is imported (the walk finds new ones), and the
native parser it uses is its own build, never the reference's library.

Also: the CLI refuses to run without a card unless ``--device cpu`` is
given, and the port's VOLATILE_TOTALS equals the reference's.
"""

import ast
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ruleset_analysis_tpu_torch"


def _port_modules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    for m in ("runtime.checkpoint", "ops.reg_tail", "hostside.feeder", "hostside.convertfleet",
              "runtime.timing", "parallel.mesh", "parallel.step", "parallel.distributed",
              "ops.overlap", "runtime.faults", "runtime.staticanalysis",
              "runtime.retrypolicy", "runtime.obs", "runtime.flightrec", "stages",
              "runtime.devprof", "tools.trace_diff", "tools.trace_attrib",
              "runtime.autoscale"):
        assert f"ruleset_analysis_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ruleset_analysis_tpu' or m.startswith('ruleset_analysis_tpu.')]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_native_parser_is_the_ports_own_library():
    """Parsing through the port maps its own build/native library and never
    the reference's ``native/_asaparse.so``, and loads no reference module."""
    code = (
        "import json, sys\n"
        "from ruleset_analysis_tpu_torch.hostside import aclparse, fastparse, pack, synth\n"
        "t = synth.synth_config(n_acls=2, rules_per_acl=4, seed=0)\n"
        "p = pack.pack_rulesets([aclparse.parse_asa_config(t, 'fw1')])\n"
        "lines = synth.render_syslog(p, synth.synth_tuples(p, 50, seed=0))\n"
        "b = fastparse.NativePacker(p).pack_lines(lines)\n"
        "maps = [ln.split()[-1] for ln in open('/proc/self/maps') if '_asaparse' in ln]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ruleset_analysis_tpu' or m.startswith('ruleset_analysis_tpu.')]\n"
        "print(json.dumps([sorted(set(maps)), bad, int(b[:, 6].sum())]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True,
    )
    maps, bad, n_valid = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == [] and n_valid == 50
    assert maps and all(
        m.startswith(str(ROOT / "build" / "native" / "_asaparse-")) for m in maps
    ), maps
    assert str(ROOT / "ruleset_analysis_tpu" / "native" / "_asaparse.so") not in maps


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_jax_or_reference_import(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top != "jax", f"{path} imports {name}"
        assert top != "ruleset_analysis_tpu", f"{path} imports {name}"


@pytest.mark.parametrize("module", [
    "ruleset_analysis_tpu_torch",
    "ruleset_analysis_tpu_torch.hostside.feeder",
    "ruleset_analysis_tpu_torch.hostside.convertfleet",
    "ruleset_analysis_tpu_torch.cli",
    # the fault, trace and flight-recorder modules the workers fire and seal
    "ruleset_analysis_tpu_torch.runtime.faults",
    "ruleset_analysis_tpu_torch.runtime.retrypolicy",
    "ruleset_analysis_tpu_torch.runtime.obs",
    "ruleset_analysis_tpu_torch.runtime.flightrec",
])
def test_spawned_worker_modules_import_no_torch(module):
    """A spawned feed or convert worker imports its module's package chain
    (and ``cli`` is the spawn's main module under ``python -m``): none of
    them may pull in torch."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps([m for m in sys.modules if m == 'torch' or m.startswith('torch.')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_volatile_totals_equal_the_reference():
    from ruleset_analysis_tpu_torch.runtime import report

    assert report.VOLATILE_TOTALS == VOLATILE_TOTALS


def test_run_without_a_card_needs_device_cpu(tmp_path, monkeypatch, capsys):
    import torch

    from ruleset_analysis_tpu_torch import cli

    assert cli.main(["synth", "--out-dir", str(tmp_path), "--acls", "2",
                     "--rules", "4", "--lines", "50"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["run", "--ruleset", str(tmp_path / "fw1"), "--logs", str(tmp_path / "fw1.log")]
    capsys.readouterr()
    assert cli.main(args) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert cli.main(args + ["--device", "cpu", "--json"]) == 0
    from_file = json.loads(capsys.readouterr().out)
    assert from_file["totals"]["lines_total"] == 50
    # '-' reads the same lines from stdin and gives the same answer
    monkeypatch.setattr(sys, "stdin", io.StringIO((tmp_path / "fw1.log").read_text()))
    assert cli.main(args[:3] + ["--logs", "-", "--device", "cpu", "--json"]) == 0
    from_stdin = json.loads(capsys.readouterr().out)
    assert from_stdin["per_rule"] == from_file["per_rule"]


def test_cli_module_runs_as_a_script(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "ruleset_analysis_tpu_torch.cli", "synth",
         "--out-dir", str(tmp_path), "--acls", "1", "--rules", "2", "--lines", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "fw1.npz").exists() and (tmp_path / "fw1.log").exists()
