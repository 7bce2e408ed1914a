"""The port's convert fleet against the reference's.

Mirrors tests/test_convertfleet.py: the fleet chops the corpus into
exact-raw-line descriptors, gives worker processes contiguous ranges and
coalesces per descriptor batch, so the concatenated row stream, the
manifest's accounting and every report over it are the same for any
worker count.  Here the port's shards and manifest are also held byte
for byte to the reference's for 1 and 3 workers, its runs over them to
the reference's runs (one-device mesh; Report JSON apart from
``VOLATILE_TOTALS`` and ``totals.backend``), and its CLI (`convert
--workers`, the manifest refusals, `run` and `wire-info` over a
manifest) to the reference CLI.  Tolerance 0 throughout.
"""

import json
import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.errors import AnalysisError as RAnalysisError  # noqa: E402
from ruleset_analysis_tpu.hostside import convertfleet as rfleet  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError, FeedWorkerError  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.convertfleet import (  # noqa: E402
    convert_logs_fleet, expand_wire_inputs, is_manifest_file, read_manifest,
)
from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file, run_stream_wire  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SKETCH = dict(cms_width=1 << 11, cms_depth=4, hll_p=6)
B = 256
TOPK = 600  # past 2 x topk_capacity: the report lists every tracked talker


def mesh1():
    return rmesh.make_mesh(jax.devices()[:1])


def _cfg(**kw):
    # weighted shards need a weight-linear match (the port's fused kernel is not)
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu",
                          match_impl="scan", **kw)


def _jcfg(**kw):
    return JConfig(batch_size=B, sketch=JSketch(**SKETCH), **kw)


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json()) if not isinstance(rep, dict) else json.loads(json.dumps(rep))
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference test's corpus: out-direction bindings, 30% IPv6 ACEs,
    3000 v4 and 800 v6 lines shuffled over two files."""
    td = tmp_path_factory.mktemp("fleet")
    text = synth.synth_config(n_acls=3, rules_per_acl=10, seed=61, egress_acls=True,
                              v6_fraction=0.3)
    rs = aclparse.parse_asa_config(text, "fw1")
    packed = pack.pack_rulesets([rs])
    pack.save_packed(packed, str(td / "fw1"))
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 3000, seed=62), seed=63,
                                variety=0.4)
    lines += synth.render_syslog6(packed, synth.synth_tuples6(packed, 800, seed=64), seed=65,
                                  variety=0.3)
    random.Random(7).shuffle(lines)
    (td / "a.log").write_text("\n".join(lines[:2300]) + "\n", encoding="utf-8")
    (td / "b.log").write_text("\n".join(lines[2300:]) + "\n", encoding="utf-8")
    return packed, rpack.load_packed(str(td / "fw1")), [str(td / "a.log"), str(td / "b.log")], td


@pytest.fixture(scope="module")
def manifests(corpus):
    """Port and reference fleets of 1 and 3 workers, in sibling directories
    under the same names (a manifest names its shards by basename)."""
    packed, rpacked, paths, td = corpus
    ensure_reference_native()
    out = {}
    for side, fn, pk in (("port", convert_logs_fleet, packed),
                         ("ref", rfleet.convert_logs_fleet, rpacked)):
        os.makedirs(td / side, exist_ok=True)
        for w in (1, 3):
            m = str(td / side / f"w{w}.rawire")
            out[side, w] = (fn(pk, paths, m, workers=w, batch_size=B), m)
    return out


def _row_streams(packed, shard_paths):
    r = wire.WireReader(shard_paths, packed)
    v4 = [b[:, :n].copy() for b, n in r.iter_batches(0, B)]
    v6 = [b[:, :n].copy() for b, n in r.iter_batches6(0, B)]
    totals = (r.n_rows, r.n6_rows, r.raw_lines, r.n_evals, r.n_skipped)
    r.close()
    return np.concatenate(v4, axis=1), np.concatenate(v6, axis=1), totals


@pytest.mark.parametrize("workers", [1, 3])
def test_shards_and_manifest_byte_identical_to_the_reference(manifests, workers):
    stats, m = manifests["port", workers]
    rstats, rm = manifests["ref", workers]
    assert open(m, "rb").read() == open(rm, "rb").read()
    shards = read_manifest(m)["shard_paths"]
    assert [os.path.basename(p) for p in shards] == [
        os.path.basename(p) for p in rfleet.read_manifest(rm)["shard_paths"]]
    assert len(shards) == workers
    for p in shards:
        assert open(p, "rb").read() == open(p.replace("/port/", "/ref/"), "rb").read()
    assert stats == rstats


def test_fleet_row_stream_byte_identical_w1_vs_w3(corpus, manifests):
    packed, _, _, _ = corpus
    (s1, m1), (s3, m3) = manifests["port", 1], manifests["port", 3]
    assert is_manifest_file(m1) and is_manifest_file(m3)
    a4, a6, atot = _row_streams(packed, read_manifest(m1)["shard_paths"])
    b4, b6, btot = _row_streams(packed, read_manifest(m3)["shard_paths"])
    np.testing.assert_array_equal(a4, b4)
    np.testing.assert_array_equal(a6, b6)
    assert atot == btot and a6.shape[1] > 0  # the v6 plane is exercised
    for k in ("rows", "rows6", "raw_lines", "evals", "skipped"):
        assert s1[k] == s3[k], k
    # pre-coalesced: true evaluations exceed stored rows
    assert read_manifest(m3)["weighted"] and s1["evals"] >= s1["rows"] + s1["rows6"]


@pytest.mark.parametrize("workers", [1, 3])
def test_fleet_report_equals_the_reference(corpus, manifests, workers):
    packed, rpacked, _, _ = corpus
    _, m = manifests["port", workers]
    _, rm = manifests["ref", workers]
    rep = run_stream_wire(packed, read_manifest(m)["shard_paths"], _cfg(), topk=TOPK)
    jrep = rstream.run_stream_wire(rpacked, rfleet.read_manifest(rm)["shard_paths"], _jcfg(),
                                   topk=TOPK, mesh=mesh1())
    assert _strip(rep) == _strip(jrep)
    if workers == 3:
        w1 = run_stream_wire(packed, read_manifest(manifests["port", 1][1])["shard_paths"],
                             _cfg(), topk=TOPK)
        assert _strip(w1) == _strip(rep)


def test_fleet_registers_equal_the_text_run(corpus, manifests):
    packed, _, paths, _ = corpus
    text, tregs = run_stream_file(packed, paths, _cfg(), return_state=True)
    fleet, fregs = run_stream_wire(packed, read_manifest(manifests["port", 3][1])["shard_paths"],
                                   _cfg(), return_state=True)
    for k in ("counts_lo", "counts_hi", "cms", "hll", "talk_cms"):
        np.testing.assert_array_equal(fregs[k], tregs[k], err_msg=k)
    ht = {(e["firewall"], e["acl"], e["index"]): (e["hits"], e.get("unique_sources"))
          for e in text.per_rule}
    hf = {(e["firewall"], e["acl"], e["index"]): (e["hits"], e.get("unique_sources"))
          for e in fleet.per_rule}
    assert ht == hf and text.unused == fleet.unused
    for k in ("lines_total", "lines_matched", "lines_skipped"):
        assert fleet.totals[k] == text.totals[k], k


def test_fleet_resume_in_stored_row_units(corpus, manifests, tmp_path):
    """Killed after 5 chunks over the three shards: the cursor counts stored
    (coalesced) rows across the shard list, and the resume ends with the
    uninterrupted run's report, and the reference's."""
    packed, rpacked, _, _ = corpus
    shards = read_manifest(manifests["port", 3][1])["shard_paths"]
    ck = tmp_path / "ck"
    cfg = _cfg(checkpoint_every_chunks=3, checkpoint_dir=str(ck))
    run_stream_wire(packed, shards, cfg, topk=TOPK, max_chunks=5)
    from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt

    snap = ckpt.load(str(ck))
    assert snap.n_chunks == 3 and snap.lines_consumed == 3 * B  # stored rows
    import dataclasses

    rep = run_stream_wire(packed, shards, dataclasses.replace(cfg, resume=True), topk=TOPK)
    full = run_stream_wire(packed, shards, _cfg(), topk=TOPK)
    jrep = rstream.run_stream_wire(
        rpacked, rfleet.read_manifest(manifests["ref", 3][1])["shard_paths"], _jcfg(),
        topk=TOPK, mesh=mesh1())
    assert _strip(rep) == _strip(full) == _strip(jrep)


def test_expand_wire_inputs_resolves_manifests(corpus, manifests):
    _, _, paths, _ = corpus
    m3 = manifests["port", 3][1]
    out = expand_wire_inputs([m3, paths[0], "-"])
    assert len(out) == 5 and out[3:] == [paths[0], "-"]
    assert all(wire.is_wire_file(p) for p in out[:3])
    assert [os.path.basename(p) for p in out] == [
        os.path.basename(p) for p in rfleet.expand_wire_inputs([m3, paths[0], "-"])]


def test_read_manifest_refusals_as_the_reference(corpus, manifests, tmp_path):
    _, _, paths, _ = corpus
    bad = tmp_path / "bad.json"
    bad.write_text('{"magic": "something else"}')
    moved = tmp_path / "moved.rawire"
    moved.write_bytes(open(manifests["port", 3][1], "rb").read())  # its shards are not here
    for path, phrase in ((paths[0], "cannot read manifest"),
                         (str(bad), "is not a convert-fleet manifest"),
                         (str(moved), "names missing shard")):
        with pytest.raises(AnalysisError, match=phrase):
            read_manifest(path)
        with pytest.raises(RAnalysisError, match=phrase):
            rfleet.read_manifest(path)
    assert not is_manifest_file(paths[0]) and not is_manifest_file(str(tmp_path / "none"))


def test_fleet_worker_failure_leaves_no_manifest(corpus, tmp_path):
    """A failing worker aborts the whole convert: no shard and no manifest."""
    packed, _, paths, _ = corpus
    out = str(tmp_path / "missing-dir" / "x.rawire")  # an unwritable target
    with pytest.raises((FeedWorkerError, OSError)):
        convert_logs_fleet(packed, paths, out, workers=2, batch_size=B)
    assert not os.path.exists(out)
    d = tmp_path / "missing-dir"
    assert not (d.is_dir() and any(f.startswith("x.rawire") for f in os.listdir(d)))
    with pytest.raises(AnalysisError, match="workers >= 1"):
        convert_logs_fleet(packed, paths, str(tmp_path / "y.rawire"), workers=0)


def test_every_shard_is_a_complete_weighted_wire_file(corpus, manifests):
    packed, _, _, _ = corpus
    for w in (1, 3):
        for sp in read_manifest(manifests["port", w][1])["shard_paths"]:
            r = wire.WireReader([sp], packed)
            assert r.weighted and r.n6_rows > 0
            r.close()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _rc(main, args):
    try:
        return main(list(args))
    except SystemExit as e:
        return e.code


def test_cli_convert_workers_and_run_over_the_manifest(corpus, tmp_path, capsys):
    """`convert --workers 3` writes the reference CLI's bytes; `run` and
    `wire-info` over the manifest read it as one corpus, as the reference's do."""
    _, rpacked, paths, td = corpus
    ensure_reference_native()
    outs = {}
    for side, main in (("port", cli.main), ("ref", rcli.main)):
        os.makedirs(tmp_path / side)
        m = str(tmp_path / side / "c.rawire")
        assert _rc(main, ["convert", "--ruleset", str(td / "fw1"), "--logs", *paths, "--out", m,
                          "--workers", "3", "--block-rows", str(B)]) == 0
        assert "parser=fleet-x3" in capsys.readouterr().err
        outs[side] = m
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) and len(names) == 4
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes()
    rep_path = str(tmp_path / "r.json")
    assert cli.main(["run", "--ruleset", str(td / "fw1"), "--logs", outs["port"], "--device",
                     "cpu", "--match-impl", "scan", "--batch-size", str(B), "--cms-width",
                     str(SKETCH["cms_width"]), "--hll-p", str(SKETCH["hll_p"]), "--topk",
                     str(TOPK), "--json", "--out", rep_path]) == 0
    jrep = rstream.run_stream_wire(rpacked, rfleet.read_manifest(outs["ref"])["shard_paths"],
                                   _jcfg(), topk=TOPK, mesh=mesh1())
    with open(rep_path, encoding="utf-8") as f:
        assert _strip(json.load(f)) == _strip(jrep)
    capsys.readouterr()
    infos = []
    for main, m in ((cli.main, outs["port"]), (rcli.main, outs["ref"])):
        assert _rc(main, ["wire-info", m, "--ruleset", str(td / "fw1"), "--json"]) == 0
        infos.append(json.loads(capsys.readouterr().out))
    assert len(infos[0]) == len(infos[1]) == 3
    for got, want in zip(*infos):
        assert os.path.basename(got.pop("file")) == os.path.basename(want.pop("file"))
        assert got == {k: want[k] for k in got}


@pytest.mark.parametrize("case", ["wire", "manifest", "no-native"])
def test_cli_convert_refusals_as_the_reference(corpus, manifests, tmp_path, capsys, case):
    packed, _, paths, td = corpus
    if case == "wire":
        logs, flags, phrase = [str(tmp_path / "in.rawire")], [], "is already a wire file"
        wire.convert_logs(packed, paths, logs[0])
    elif case == "manifest":
        logs, flags, phrase = [manifests["port", 3][1]], ["--workers", "2"], "is already a wire file"
    else:
        logs, flags, phrase = paths, ["--workers", "2", "--no-native-parse"], (
            "--workers requires the native parser")
    got = []
    for main in (cli.main, rcli.main):
        rc = _rc(main, ["convert", "--ruleset", str(td / "fw1"), "--logs", *logs,
                        "--out", str(tmp_path / "o.rawire"), *flags])
        got.append((rc, phrase in capsys.readouterr().err))
    assert got == [(2, True), (2, True)]
    assert not os.path.exists(tmp_path / "o.rawire")
