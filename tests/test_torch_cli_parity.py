"""The port's `run` command line against the reference's, side by side.

Each command line runs through both CLIs (the port's on the CPU, the
reference's on a one-device mesh) over one corpus.  The default `run`
takes what the reference's default takes: a `convert --coalesce` file, a
`convert --workers 2` manifest, `--coalesce on`, `--layout stacked`; the
reference's match spellings (`--match-impl xla|pallas`,
`--experimental-match-impl pallas_fused`) and `--lenient` with the oracle
are accepted.  Exit codes agree, and the reports agree apart from
``VOLATILE_TOTALS`` and ``totals.backend``.  Then the failure classes: a
torn snapshot (3), a snapshot of another batch size (4), a damaged v4
wire block (5), a killed feed worker (5) and a stalled producer (6) exit
with the reference's documented code.
"""

import json
import os
import signal
import threading

import pytest

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu.hostside import feeder as rfeeder  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import ingest as ringest  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch import errors  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import feeder, pack, wire  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.pack import W_META  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import ingest  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402

B = 256
SKETCH = ("--cms-width", "1024", "--hll-p", "6")
#: an entry strict parsing refuses and lenient parsing skips
BAD_ENTRY = "access-list ZZZ extended permit udp object-group NOSUCHGROUP any\n"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 2 ACL x 8 rule ruleset, 2000 lines over 50 Zipf flows, a weighted
    wire file and a two-shard fleet manifest (both made by the port's
    `convert`), and the config with one entry only lenient parsing takes."""
    d = tmp_path_factory.mktemp("cli")
    assert cli.main(["synth", "--out-dir", str(d), "--acls", "2", "--rules", "8", "--lines",
                     "2000", "--flows", "50", "--seed", "3"]) == 0
    prefix, log = str(d / "fw1"), str(d / "fw1.log")
    w = str(d / "w.rawire")
    assert cli.main(["convert", "--ruleset", prefix, "--logs", log, "--out", w,
                     "--coalesce"]) == 0
    fleet = str(d / "fleet" / "m.rawire")
    os.makedirs(d / "fleet")
    assert cli.main(["convert", "--ruleset", prefix, "--logs", log, "--out", fleet,
                     "--workers", "2", "--block-rows", str(B)]) == 0
    lenient = d / "lenient.cfg"
    lenient.write_text((d / "fw1.cfg").read_text() + BAD_ENTRY)
    ensure_reference_native()
    return {"d": d, "prefix": prefix, "log": log, "weighted": w, "fleet": fleet,
            "lenient": str(lenient), "cfg": str(d / "fw1.cfg")}


@pytest.fixture
def ref_one_device(monkeypatch):
    """The reference CLI on a one-device mesh (the suite fakes eight)."""
    make = rmesh.make_mesh
    monkeypatch.setattr(rmesh, "make_mesh",
                        lambda devices=None, *a, **k: make(jax.devices()[:1], *a, **k))


def _rc(main, args):
    try:
        return main(list(args))
    except SystemExit as e:
        return e.code


def _strip(path):
    with open(path, encoding="utf-8") as f:
        obj = json.load(f)
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


def both(c, tmp_path, logs, flags, *, oracle=False):
    """Exit codes and stripped reports of one command line through both CLIs."""
    out = {}
    for side, main, extra in (
        ("port", cli.main, [] if oracle else ["--device", "cpu"]),
        ("ref", rcli.main,
         [] if oracle else ["--blackbox", "off", "--checkpoint-dir", str(tmp_path / "ref-ck")]),
    ):
        path = tmp_path / f"{side}.json"
        rc = _rc(main, ["run", "--ruleset", c["prefix"], "--logs", *logs, "--batch-size",
                        str(B), *SKETCH, "--topk", "600", "--json", "--out", str(path), *extra,
                        *flags])
        out[side] = (rc, _strip(path) if rc == 0 else None)
    return out


#: name -> (input, flags): each one the reference's default `run` takes
ACCEPTED = {
    "plain default": ("text", []),
    "convert --coalesce file": ("weighted", []),
    "convert --workers 2 manifest": ("fleet", []),
    "--coalesce on": ("text", ["--coalesce", "on"]),
    "--layout stacked": ("text", ["--layout", "stacked"]),
    "--match-impl xla": ("text", ["--match-impl", "xla"]),
    "--match-impl pallas": ("text", ["--match-impl", "pallas"]),
    "--experimental-match-impl pallas_fused": ("text", ["--experimental-match-impl",
                                                         "pallas_fused"]),
    "--lenient with the oracle": ("text", ["--backend", "oracle", "--acl-configs", "LENIENT",
                                           "--lenient"]),
}


@pytest.mark.parametrize("name", ACCEPTED)
def test_default_run_accepts_what_the_reference_accepts(corpus, tmp_path, ref_one_device, name):
    kind, flags = ACCEPTED[name]
    logs = [corpus["log"] if kind == "text" else corpus[kind]]
    flags = [corpus["lenient"] if f == "LENIENT" else f for f in flags]
    got = both(corpus, tmp_path, logs, flags, oracle="oracle" in flags)
    assert got["port"][0] == got["ref"][0] == 0, got
    assert got["port"][1] == got["ref"][1]
    assert got["port"][1]["totals"]["lines_total"] == 2000
    if name == "--lenient with the oracle":
        # strict parsing of the same config refuses it, in both
        strict = both(corpus, tmp_path, logs, flags[:-1], oracle=True)
        assert [rc for rc, _ in strict.values()] == [1, 1]


def test_fused_keeps_the_references_pallas_fused_refusals(corpus, tmp_path, capsys):
    """`--experimental-match-impl pallas_fused` (the port's fused kernel) is
    still refused with weighted input and the stacked layout."""
    base = ["run", "--ruleset", corpus["prefix"], "--device", "cpu", "--batch-size", str(B)]
    assert cli.main(base + ["--logs", corpus["weighted"], "--experimental-match-impl",
                            "pallas_fused"]) == 2
    assert "not weight-linear" in capsys.readouterr().err
    assert cli.main(base + ["--logs", corpus["log"], "--layout", "stacked",
                            "--experimental-match-impl", "pallas_fused"]) == 2
    assert "supports layout='flat' only" in capsys.readouterr().err
    # the experimental flag is a device flag, as in the reference
    assert cli.main(base + ["--logs", corpus["log"], "--backend", "oracle", "--acl-configs",
                            corpus["cfg"], "--experimental-match-impl", "pallas_fused"]) == 2
    assert "--experimental-match-impl" in capsys.readouterr().err


# --- failure classes ----------------------------------------------------------


def _snapshot(c, ck):
    """A port run killed after 5 chunks, its snapshot at chunk 4."""
    packed = pack.load_packed(c["prefix"])
    cfg = AnalysisConfig(batch_size=B, sketch=SketchConfig(cms_width=1024, hll_p=6),
                         device="cpu", checkpoint_every_chunks=2, checkpoint_dir=str(ck))
    run_stream_file(packed, [c["log"]], cfg, max_chunks=5)


def _torn(c, tmp_path, monkeypatch):
    ck = tmp_path / "ck"
    _snapshot(c, ck)
    state = ck / (ck / "LATEST").read_text().strip() / ckpt.STATE_FILE
    with open(state, "r+b") as f:
        f.truncate(os.path.getsize(state) // 2)
    return [c["log"]], ["--checkpoint-dir", str(ck), "--resume"], None


def _other_batch(c, tmp_path, monkeypatch):
    ck = tmp_path / "ck"
    _snapshot(c, ck)
    return [c["log"]], ["--checkpoint-dir", str(ck), "--resume", "--batch-size",
                        str(B // 2)], None


def _damaged_wire(c, tmp_path, monkeypatch):
    path = tmp_path / "bad.rawire"
    packed = pack.load_packed(c["prefix"])
    wire.convert_logs(packed, [c["log"]], str(path))
    r = wire.WireReader([str(path)])
    n_rows = r.n_rows  # one block holds every row
    r.close()
    raw = bytearray(path.read_bytes())
    raw[wire.HEADER_BYTES + W_META * 4 * n_rows + 2] &= 0x7F  # the first row's valid bit
    path.write_bytes(bytes(raw))
    return [str(path)], [], None


def _killing(batches):
    """A feeder's batches that SIGKILL its workers after one batch (the
    reference's pool goes on without an idle worker that died)."""
    def run(self, *a, **k):
        gen = batches(self, *a, **k)
        yield next(gen)
        for w in self._workers:
            os.kill(w.pid, signal.SIGKILL)
        yield from gen
    return run


def _killed_worker(c, tmp_path, monkeypatch):
    for mod in (feeder, rfeeder):
        monkeypatch.setattr(mod.ParallelFeeder, "batches", _killing(mod.ParallelFeeder.batches))
    # long enough that the worker still has lines to parse when it dies
    log = tmp_path / "long.log"
    with open(c["log"], "rb") as f:
        log.write_bytes(f.read() * 20)
    return [str(log)], ["--feed-workers", "2", "--feed-mode", "process", "--batch-size",
                        "64"], None


def _stalled(c, tmp_path, monkeypatch):
    """stdin that yields one batch of lines and then blocks: the prefetch
    producer stays alive and hands over nothing.  Its writer closes once
    the watchdog has raised (so the producer's read ends and its thread
    exits), whenever the consumer starts waiting."""
    r, w = os.pipe()
    with open(c["log"], "rb") as f:
        os.write(w, b"".join(f.readlines()[:300]))
    monkeypatch.setattr("sys.stdin", os.fdopen(r, "r", encoding="utf-8"))
    fired = threading.Event()
    for mod in (ingest, ringest):
        base = mod.StallError

        class Stall(base):
            def __init__(self, *a, _base=base, **k):
                _base.__init__(self, *a, **k)
                fired.set()

        monkeypatch.setattr(mod, "StallError", Stall)

    def close_when_fired():
        fired.wait(120)
        os.close(w)

    closer = threading.Thread(target=close_when_fired, name="test-stdin-closer", daemon=True)
    closer.start()
    return ["-"], ["--stall-timeout", "1"], closer


#: name -> (set-up, the reference's exit code)
FAILURES = {
    "torn snapshot": (_torn, errors.EXIT_CHECKPOINT_CORRUPT),
    "snapshot of another batch size": (_other_batch, errors.EXIT_CHECKPOINT_MISMATCH),
    "damaged v4 wire block": (_damaged_wire, errors.EXIT_FEED),
    "killed feed worker": (_killed_worker, errors.EXIT_FEED),
    "stalled producer": (_stalled, errors.EXIT_STALL),
}


@pytest.mark.parametrize("name", FAILURES)
def test_failure_exit_codes_are_the_references(corpus, tmp_path, ref_one_device, monkeypatch,
                                               capsys, name):
    setup, code = FAILURES[name]
    rcs = []
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", rcli.main, ["--blackbox", "off"])):
        side_dir = tmp_path / side
        side_dir.mkdir()
        # each side makes its own snapshot, file or stdin
        logs, flags, held = setup(corpus, side_dir, monkeypatch)
        args = ["run", "--ruleset", corpus["prefix"], "--logs", *logs, "--batch-size", str(B),
                *SKETCH, "--json", "--out", str(side_dir / "r.json"), *extra, *flags]
        rcs.append(_rc(main, args))
        if held is not None:
            held.join(130)
        capsys.readouterr()
    assert rcs == [code, code]


def test_exit_code_for_maps_every_class_the_port_raises():
    want = {
        errors.CheckpointCorrupt: 3, errors.CheckpointMismatch: 4,
        errors.ResumeInputMismatch: 4, errors.FeedWorkerError: 5, errors.IngestError: 5,
        errors.WireCorrupt: 5, errors.NativeParserUnavailable: 5, errors.StallError: 6,
        errors.WeightedInputRefused: 2, errors.AnalysisError: 1, errors.KernelError: 1,
        errors.DeviceUnavailable: 1,
    }
    assert {cls: errors.exit_code_for(cls("x")) for cls in want} == want


# --- usage refusals -------------------------------------------------------------

#: name -> (inputs, flags): `run` refusals the reference prints bare on
#: stderr, without an "error: " prefix, and exits 2 (each `--elastic`
#: refusal after `--distributed --elastic`, the launcher membership,
#: `--elastic-dir` and `--json` it needs before it)
ELASTIC = ["--distributed", "--elastic", "--num-processes", "1", "--process-id", "0",
           "--elastic-dir", "EL", "--json"]
REFUSALS = {
    "--backend=oracle without --acl-configs": (["text"], ["--backend", "oracle"]),
    "--backend=oracle over a .rawire file": (["weighted"], ["--backend", "oracle"]),
    "--backend=oracle with device flags": (["text"], [
        "--backend", "oracle", "--acl-configs", "CFG", "--layout", "stacked", "--resume",
        "--trace-out", "TRACE", "--topk-every", "2"]),
    ".rawire mixed with text": (["text", "weighted"], []),
    "--native-parse over .rawire": (["weighted"], ["--native-parse"]),
    "--native-parse over stdin": (["-"], ["--native-parse"]),
    "--feed-workers over stdin": (["-"], ["--feed-workers", "2"]),
    "--feed-mode ring without workers": (["text"], ["--feed-mode", "ring"]),
    "--feed-mode ring with --distributed": (["text"], [
        "--feed-mode", "ring", "--feed-workers", "1", "--distributed"]),
    "--autoscale without --elastic": (["text"], ["--autoscale"]),
    "--distributed over stdin": (["-"], ["--distributed"]),
    "--elastic without --distributed": (["text"], ["--elastic"]),
    "--elastic over .rawire": (["weighted"], ELASTIC),
    "--elastic without the membership": (["text"], ELASTIC[:2]),
    "--elastic with --coordinator": (["text"], [*ELASTIC, "--coordinator", "127.0.0.1:1"]),
    "--elastic without --elastic-dir": (["text"], [*ELASTIC[:6], "--json"]),
    "--elastic without --json": (["text"], ELASTIC[:-1]),
    "--elastic with --static-analysis": (["text"], [*ELASTIC, "--static-analysis"]),
}


@pytest.mark.parametrize("name", REFUSALS)
def test_run_refusals_print_the_references_line(corpus, tmp_path, ref_one_device, capsys, name):
    """The reference's exit code and last stderr line (the port once
    prefixed these with "error: ")."""
    kinds, flags = REFUSALS[name]
    logs = [corpus["log"] if k == "text" else "-" if k == "-" else corpus[k] for k in kinds]
    subst = {"CFG": corpus["cfg"], "EL": str(tmp_path / "el"), "TRACE": str(tmp_path / "tr")}
    flags = [subst.get(f, f) for f in flags]
    got = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", rcli.main, [])):
        capsys.readouterr()
        rc = _rc(main, ["run", "--ruleset", corpus["prefix"], "--logs", *logs, *extra, *flags])
        got[side] = (rc, capsys.readouterr().err.strip().splitlines()[-1])
    assert got["port"] == got["ref"]
    assert got["port"][0] == 2 and not got["port"][1].startswith("error: ")


#: refusals whose words name the reference's console script, `ruleset-analyze`;
#: the port has none and names the subcommand alone
NAMED_SCRIPT = {
    "--packed-input over text": (["text"], ["--packed-input"]),
    "--coalesce with --distributed": (["text"], ["--distributed", "--coalesce", "on"]),
}


@pytest.mark.parametrize("name", NAMED_SCRIPT)
def test_refusals_naming_the_console_script(corpus, ref_one_device, capsys, name):
    kinds, flags = NAMED_SCRIPT[name]
    got = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", rcli.main, [])):
        capsys.readouterr()
        rc = _rc(main, ["run", "--ruleset", corpus["prefix"], "--logs", corpus["log"], *extra,
                        *flags])
        got[side] = (rc, capsys.readouterr().err.strip().splitlines()[-1])
    assert got["port"] == (2, got["ref"][1].replace("`ruleset-analyze ", "`"))
    assert got["ref"][0] == 2
