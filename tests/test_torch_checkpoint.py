"""Checkpoint/resume of the port against the reference (IPv4 inputs).

A run killed anywhere (``max_chunks``, the reference's simulated crash)
and resumed must end with the registers, talker tables and Report of the
run that was never stopped, the port's and the reference's alike, over
every v4 input path: Python text, native text with and without prefetch,
coalescing, plain and weighted ``.rawire``, in the flat layout and the
stacked one (whose saves first step what the group buffer holds, so it
is held to runs saved on the same cadence).  Snapshots are the
reference's format: each package resumes the other's, and the
fingerprint is the reference's string for string.  The format's
refusals (CRCs, torn writes, a pointer to nothing, a foreign
fingerprint, a short input) mirror ``tests/test_checkpoint.py``; the
torn writes truncate files directly.  The CLI's resume and sketch flags
and ``--backend oracle`` match the reference CLI.  The reference runs on
a one-device mesh; tolerance 0 throughout.  The dual-stack cases are in
``tests/test_torch_resume6.py``.
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
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.errors import (  # noqa: E402
    CheckpointCorrupt, CheckpointMismatch, ResumeInputMismatch,
)
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.metrics import ThroughputMeter  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import (  # noqa: E402
    _TextSource, run_stream, run_stream_file, run_stream_wire,
)
from tests._torch_refnative import ensure_reference_native  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SKETCH = dict(cms_width=1 << 10, cms_depth=4, hll_p=6)
B = 256
TOPK = 600  # past 2 x topk_capacity: the report lists every tracked talker


def mesh1():
    return rmesh.make_mesh(jax.devices()[:1])


def _cfg(ck=None, every=0, resume=False, **kw):
    if ck is not None:
        kw["checkpoint_dir"] = str(ck)
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu",
                          checkpoint_every_chunks=every, resume=resume, **kw)


def _jcfg(ck, every=1 << 20, resume=False, **kw):
    return JConfig(batch_size=B, sketch=JSketch(**SKETCH), checkpoint_every_chunks=every,
                   checkpoint_dir=str(ck), resume=resume, **kw)


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json()) if not isinstance(rep, dict) else json.loads(json.dumps(rep))
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 ACLs with out-direction bindings (two rows for some lines), Zipf
    flows (coalescing compacts them), junk lines, and a run of 300 junk
    lines: one Python batch with no tuple row, which does not step."""
    d = tmp_path_factory.mktemp("ckpt")
    text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=9, egress_acls=True)
    (d / "fw1.cfg").write_text(text)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    tuples = synth.synth_flow_tuples(packed, 2700, 300, skew=1.1, seed=9)
    lines = synth.render_syslog(packed, tuples, seed=9, variety=0.3)
    lines[::97] = ["not an ASA line"] * len(lines[::97])
    lines[1000:1000] = [f"junk {i}" for i in range(300)]
    pack.save_packed(packed, str(d / "fw1"))
    log = d / "fw1.log"
    log.write_text("\n".join(lines) + "\n")
    rpacked = rpack.load_packed(str(d / "fw1"))
    for weighted in (False, True):
        wire.convert_logs(packed, [str(log)], str(d / f"w{int(weighted)}.rawire"),
                          coalesce=weighted, batch_size=B, block_rows=B)
    return packed, rpacked, lines, d


def _paths(d, case):
    case = case.removeprefix("stacked-")
    return {"wire": [str(d / "w0.rawire")], "wirew": [str(d / "w1.rawire")]}.get(
        case, [str(d / "fw1.log")])


#: the port's stacked layout runs on the scan route
STACKED = dict(layout="stacked", match_impl="scan")
#: case -> (port config, reference config, crash after N batches, cadence)
CASES = {
    "python": (dict(prefetch_depth=0), {}, 6, 2),
    "native-prefetch0": (dict(prefetch_depth=0), {}, 7, 3),
    "native-prefetch2": (dict(prefetch_depth=2), {}, 7, 3),
    "coalesce-on": (dict(coalesce="on", match_impl="scan"), dict(coalesce="on"), 6, 2),
    "wire": ({}, {}, 5, 2),
    "wirew": (dict(match_impl="scan"), {}, 3, 1),
    # the stacked layout: a snapshot first steps what the group buffer holds
    "stacked-python": (dict(prefetch_depth=0, **STACKED), dict(layout="stacked"), 6, 2),
    "stacked-native-prefetch2": (dict(prefetch_depth=2, stacked_lane=40, **STACKED),
                                 dict(layout="stacked", stacked_lane=40), 7, 3),
    "stacked-coalesce-on": (dict(coalesce="on", **STACKED),
                            dict(coalesce="on", layout="stacked"), 6, 2),
    "stacked-wire": (dict(stacked_lane=64, **STACKED), dict(layout="stacked", stacked_lane=64),
                     5, 2),
    "stacked-wirew": (STACKED, dict(layout="stacked"), 3, 1),
}


def _port_run(case, packed, lines, d, cfg, max_chunks=None):
    case = case.removeprefix("stacked-")
    if case in ("python", "coalesce-on"):
        return run_stream(packed, iter(lines), cfg, topk=TOPK, return_state=True,
                          max_chunks=max_chunks)
    if case.startswith("native"):
        return run_stream_file(packed, _paths(d, case), cfg, native=True, topk=TOPK,
                               return_state=True, max_chunks=max_chunks)
    return run_stream_wire(packed, _paths(d, case), cfg, topk=TOPK, return_state=True,
                           max_chunks=max_chunks)


def _ref_run(case, rpacked, lines, d, jcfg, max_chunks=None):
    case = case.removeprefix("stacked-")
    if case in ("python", "coalesce-on"):
        return rstream.run_stream(rpacked, iter(lines), jcfg, topk=TOPK, mesh=mesh1(),
                                  max_chunks=max_chunks)
    if case.startswith("native"):
        ensure_reference_native()
        return rstream.run_stream_file(rpacked, _paths(d, case), jcfg, native=True,
                                       topk=TOPK, mesh=mesh1(), max_chunks=max_chunks)
    return rstream.run_stream_wire(rpacked, _paths(d, case), jcfg, topk=TOPK, mesh=mesh1(),
                                   max_chunks=max_chunks)


def assert_resume_bit_identical(port_run, ref_run, cfg, jcfg, crash_at, every, tmp_path,
                                check_snap=None):
    """Crash at ``crash_at`` batches, resume; registers, talker tables,
    fingerprint and Report equal the uninterrupted port and reference runs.

    ``cfg(ck, every, resume=False)`` and ``jcfg(ck, every)`` make the
    configs; ``check_snap`` inspects the crashed run's snapshot.  The
    uninterrupted runs save on the same cadence: each save steps the
    partial v6 chunk, so the cadence sets a dual-stack text run's chunks.
    """
    full, full_regs = port_run(cfg(tmp_path / "full", every))
    full_snap = ckpt.load(str(tmp_path / "full"))
    jrep = ref_run(jcfg(tmp_path / "ref", every))
    jsnap = rckpt.load(str(tmp_path / "ref"))
    ck = tmp_path / "ck"
    port_run(cfg(ck, every), crash_at)
    snap = ckpt.load(str(ck))
    assert snap is not None and 0 < snap.n_chunks < full.totals["chunks"]
    if check_snap is not None:
        check_snap(snap)
    rep, regs = port_run(cfg(ck, every, resume=True))
    end = ckpt.load(str(ck))
    for k, v in jsnap.arrays.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
        np.testing.assert_array_equal(full_regs[k], v, err_msg=k)
    assert end.tracker_tables == full_snap.tracker_tables == jsnap.tracker_tables
    assert end.fingerprint == full_snap.fingerprint == jsnap.fingerprint
    assert (end.lines_consumed, end.parsed, end.skipped) == (
        jsnap.lines_consumed, jsnap.parsed, jsnap.skipped)
    assert _strip(rep) == _strip(full) == _strip(jrep)
    return snap, rep


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_bit_identical(corpus, tmp_path, case):
    packed, rpacked, lines, d = corpus
    cfg_kw, jcfg_kw, crash_at, every = CASES[case]
    snap, rep = assert_resume_bit_identical(
        lambda cfg, m=None: _port_run(case, packed, lines, d, cfg, m),
        lambda jcfg: _ref_run(case, rpacked, lines, d, jcfg),
        lambda ck, every, resume=False: _cfg(ck, every, resume, **cfg_kw),
        lambda ck, every: _jcfg(ck, every, **jcfg_kw), crash_at, every, tmp_path,
    )
    # cumulative counters, this run's rate (a wire file's offsets count rows)
    t = rep.totals
    assert t["throughput"]["lines"] == t.get("wire_rows", t["lines_total"]) - snap.lines_consumed
    if case.removeprefix("stacked-").startswith("wire"):
        assert "wire_rows_only" not in t and t["wire_rows"] > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_snapshot_at_a_batch_closed_early_counts_each_line_once(corpus, tmp_path, depth):
    """A batch closes early when the next line's rows do not fit, and that
    line is parsed and counted before the batch goes out.  A snapshot at
    that batch must not count it, or the resumed run counts it twice (the
    reference's resume does: its lines_matched ends one or two high)."""
    packed, _, lines, _ = corpus
    sizes = [n for _, n in _TextSource(packed, iter(lines)).batches(0, B)]
    k = next(i for i, n in enumerate(sizes, 1) if n < B)
    assert k < len(sizes)
    full = run_stream(packed, iter(lines), _cfg(prefetch_depth=depth), topk=TOPK)
    ck = tmp_path / "ck"
    run_stream(packed, iter(lines), _cfg(ck, 1, prefetch_depth=depth), max_chunks=k)
    snap = ckpt.load(str(ck))
    assert (snap.n_chunks, snap.lines_consumed) == (k, sum(sizes[:k]))
    rep = run_stream(packed, iter(lines), _cfg(ck, 1, resume=True, prefetch_depth=depth),
                     topk=TOPK)
    assert _strip(rep) == _strip(full)


def test_port_resumes_a_reference_snapshot(corpus, tmp_path):
    packed, rpacked, lines, _ = corpus
    jfull = rstream.run_stream(rpacked, iter(lines), _jcfg(tmp_path / "ref"), topk=TOPK,
                               mesh=mesh1())
    jregs = rckpt.load(str(tmp_path / "ref")).arrays
    ck = tmp_path / "ck"
    rstream.run_stream(rpacked, iter(lines), _jcfg(ck, every=3), topk=TOPK, mesh=mesh1(),
                       max_chunks=7)
    assert rckpt.load(str(ck)).n_chunks == 6
    rep, regs = run_stream(packed, iter(lines), _cfg(ck, 3, resume=True), topk=TOPK,
                           return_state=True)
    for k, v in jregs.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert _strip(rep) == _strip(jfull)


def test_reference_resumes_a_port_snapshot(corpus, tmp_path):
    packed, rpacked, lines, _ = corpus
    full = run_stream(packed, iter(lines), _cfg(), topk=TOPK)
    jregs = rckpt.load(str(_ref_full(rpacked, lines, tmp_path))).arrays
    ck = tmp_path / "ck"
    run_stream(packed, iter(lines), _cfg(ck, 3), topk=TOPK, max_chunks=7)
    assert ckpt.load(str(ck)).n_chunks == 6
    jrep = rstream.run_stream(rpacked, iter(lines), _jcfg(ck, every=3, resume=True), topk=TOPK,
                              mesh=mesh1())
    got = rckpt.load(str(ck))
    for k, v in jregs.items():
        np.testing.assert_array_equal(got.arrays[k], v, err_msg=k)
    assert _strip(jrep) == _strip(full)


def _ref_full(rpacked, lines, tmp_path):
    rstream.run_stream(rpacked, iter(lines), _jcfg(tmp_path / "ref"), topk=TOPK, mesh=mesh1())
    return tmp_path / "ref"


@pytest.mark.parametrize("geometry", [
    dict(),
    dict(cms_width=1 << 12, cms_depth=3, hll_p=9, topk_sample_shift=2),
    dict(exact_counts=False, batch_size=1000),
])
def test_fingerprint_is_the_references(corpus, geometry):
    packed, rpacked, *_ = corpus
    sk = {k: geometry[k] for k in ("cms_width", "cms_depth", "hll_p", "topk_sample_shift")
          if k in geometry}
    top = {k: geometry[k] for k in ("exact_counts", "batch_size") if k in geometry}
    mine = ckpt.fingerprint(packed, AnalysisConfig(sketch=SketchConfig(**sk), **top))
    ref = rckpt.fingerprint(rpacked, JConfig(sketch=JSketch(**sk), **top), 1, 0)
    assert mine == ref and len(mine) == 16


# --- the format and its refusals (tests/test_checkpoint.py) -----------------


def _snap(**kw):
    base = dict(arrays={"a": np.arange(5, dtype=np.uint32)}, lines_consumed=10, n_chunks=2,
                parsed=10, skipped=0, tracker_tables={}, fingerprint="fp")
    base.update(kw)
    return ckpt.Snapshot(**base)


def test_snapshot_roundtrip_is_read_by_the_reference(tmp_path):
    snap = _snap(arrays={"a": np.arange(5, dtype=np.uint32), "b": np.ones((2, 3), np.uint32)},
                 lines_consumed=123, n_chunks=4, parsed=100, skipped=23,
                 tracker_tables={7: {111: 9, 222: 3}}, fingerprint="abc",
                 extra={"v6_digests": [[5, 1 << 100]]})
    ckpt.save(str(tmp_path), snap)
    for mod in (ckpt, rckpt):
        got = mod.load(str(tmp_path))
        assert (got.lines_consumed, got.n_chunks, got.parsed, got.skipped) == (123, 4, 100, 23)
        assert got.tracker_tables == {7: {111: 9, 222: 3}} and got.fingerprint == "abc"
        assert got.extra == {"v6_digests": [[5, 1 << 100]]}
        np.testing.assert_array_equal(got.arrays["b"], snap.arrays["b"])
    snap.lines_consumed = 456
    ckpt.save(str(tmp_path), snap)
    assert ckpt.load(str(tmp_path)).lines_consumed == 456


def test_same_chunk_resave_never_deletes_the_live_snapshot(tmp_path):
    ckpt.save(str(tmp_path), _snap())
    first = (tmp_path / "LATEST").read_text().strip()
    ckpt.save(str(tmp_path), _snap(lines_consumed=20))
    second = (tmp_path / "LATEST").read_text().strip()
    assert (first, second) == ("snap-2", "snap-2-r1")
    assert not (tmp_path / first).exists()
    assert ckpt.load(str(tmp_path)).lines_consumed == 20


def test_load_of_a_missing_dir_is_none(tmp_path):
    assert ckpt.load(str(tmp_path / "nothing")) is None


def test_orphans_swept_after_the_pointer_commit(tmp_path):
    (tmp_path / "snap-99").mkdir()
    (tmp_path / "snap-99" / "state.npz").write_bytes(b"x")
    (tmp_path / ".tmp-dead").mkdir()
    (tmp_path / "dead.ptr.tmp").write_text("snap-99")
    ckpt.save(str(tmp_path), _snap())
    assert set(os.listdir(tmp_path)) == {"snap-2", "LATEST"}


def test_no_free_snapshot_name_is_refused(tmp_path):
    from ruleset_analysis_tpu_torch.runtime import retrypolicy

    # the names tried are bounded by the checkpoint.save policy's attempts
    attempts = retrypolicy.policy("checkpoint.save").attempts
    for name in ["snap-2"] + [f"snap-2-r{k}" for k in range(1, attempts + 1)]:
        (tmp_path / name).mkdir()
    with pytest.raises(CheckpointCorrupt, match="free snapshot name"):
        ckpt.save(str(tmp_path), _snap())
    assert not [e for e in os.listdir(tmp_path) if e.startswith(".tmp-")]


def test_torn_save_resumes_from_the_previous_snapshot(corpus, tmp_path):
    """A save torn before its pointer moved (a newer snapshot dir, files
    cut short) leaves the previous pair, and the resume is exact."""
    packed, _, lines, _ = corpus
    full = run_stream(packed, iter(lines), _cfg(), topk=TOPK)
    d = tmp_path / "atomic"
    run_stream(packed, iter(lines), _cfg(d, 2), max_chunks=5)
    before = ckpt.load(str(d))
    live = d / (d / "LATEST").read_text().strip()
    torn = d / "snap-99"
    torn.mkdir()
    for f in (ckpt.STATE_FILE, ckpt.MANIFEST_FILE):
        data = (live / f).read_bytes()
        (torn / f).write_bytes(data[: len(data) // 2])
    after = ckpt.load(str(d))
    assert (after.n_chunks, after.lines_consumed) == (before.n_chunks, before.lines_consumed)
    rep = run_stream(packed, iter(lines), _cfg(d, 2, resume=True), topk=TOPK)
    assert _strip(rep) == _strip(full)


def test_manifest_flip_that_stays_valid_json_is_refused(tmp_path):
    ckpt.save(str(tmp_path), _snap(lines_consumed=1000))
    mp = tmp_path / "snap-2" / ckpt.MANIFEST_FILE
    text = mp.read_text()
    mp.write_text(text.replace('"lines_consumed": 1000', '"lines_consumed": 3000'))
    for mod in (ckpt, rckpt):
        with pytest.raises(mod.CheckpointCorrupt, match="CRC32"):
            mod.load(str(tmp_path))
    mp.write_text(text)
    assert ckpt.load(str(tmp_path)).lines_consumed == 1000


def test_state_payload_substitution_is_refused(tmp_path):
    ckpt.save(str(tmp_path), _snap())
    with open(tmp_path / "snap-2" / ckpt.STATE_FILE, "wb") as f:
        np.savez(f, a=np.zeros(5, dtype=np.uint32))  # a valid npz, the wrong data
    with pytest.raises(CheckpointCorrupt, match="CRC32"):
        ckpt.load(str(tmp_path))


@pytest.mark.parametrize("target", [ckpt.STATE_FILE, ckpt.MANIFEST_FILE])
def test_truncated_snapshot_file_is_refused(corpus, tmp_path, target, capsys):
    """Truncate a file of the live snapshot: load, the run and the CLI all
    refuse it, never starting fresh."""
    packed, _, lines, d0 = corpus
    d = tmp_path / "torn"
    run_stream(packed, iter(lines), _cfg(d, 2), max_chunks=5)
    path = d / (d / "LATEST").read_text().strip() / target
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointCorrupt):
        ckpt.load(str(d))
    with pytest.raises(CheckpointCorrupt):
        run_stream(packed, iter(lines), _cfg(d, 2, resume=True))
    capsys.readouterr()
    assert cli.main(["run", "--ruleset", str(d0 / "fw1"), "--logs", str(d0 / "fw1.log"),
                     "--device", "cpu", "--batch-size", str(B), "--checkpoint-dir", str(d),
                     "--resume"]) == 3  # the reference's checkpoint-corrupt code
    assert "corrupt" in capsys.readouterr().err


@pytest.mark.parametrize("pointer", ["snap-7", "", b"\xff\xfe"])
def test_pointer_to_nothing_is_refused(tmp_path, pointer):
    ckpt.save(str(tmp_path), _snap())
    p = tmp_path / "LATEST"
    p.write_bytes(pointer if isinstance(pointer, bytes) else pointer.encode())
    with pytest.raises(CheckpointCorrupt):
        ckpt.load(str(tmp_path))


def test_corrupt_snapshot_fuzz_is_refused_loudly(corpus, tmp_path):
    """Random byte damage to any snapshot file: a typed CheckpointCorrupt,
    or (damage the format cannot see, e.g. in the pointer's name) a
    loadable snapshot; never a raw exception, never a silent None."""
    packed, _, lines, _ = corpus
    d = tmp_path / "ck"
    run_stream(packed, iter(lines), _cfg(d, 1), max_chunks=3)
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    refused = 0
    for trial in range(60):
        rng = random.Random(trial)
        target = rng.choice(files)
        orig = open(target, "rb").read()
        blob = bytearray(orig)
        for _ in range(rng.randint(1, 6)):
            if rng.randrange(2):
                blob[rng.randrange(len(blob))] = rng.randrange(256)
            else:
                blob = blob[: rng.randrange(len(blob))] or bytearray(b"x")
        open(target, "wb").write(bytes(blob))
        try:
            assert ckpt.load(str(d)) is not None
        except CheckpointCorrupt:
            refused += 1
        finally:
            open(target, "wb").write(orig)
    assert refused > 40


@pytest.mark.parametrize("change", ["geometry", "ruleset", "batch", "input-kind"])
def test_resume_against_another_run_is_refused(corpus, tmp_path, change):
    packed, _, lines, d = corpus
    ck = tmp_path / "fp"
    run_stream(packed, iter(lines), _cfg(ck, 2), max_chunks=3)
    cfg = _cfg(ck, 2, resume=True)
    other = packed
    if change == "geometry":
        cfg = AnalysisConfig(batch_size=B, sketch=SketchConfig(**{**SKETCH, "cms_width": 2048}),
                             device="cpu", checkpoint_dir=str(ck), resume=True)
    elif change == "batch":
        cfg = AnalysisConfig(batch_size=B * 2, sketch=SketchConfig(**SKETCH), device="cpu",
                             checkpoint_dir=str(ck), resume=True)
    elif change == "ruleset":
        text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=10, egress_acls=True)
        other = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    with pytest.raises(CheckpointMismatch):
        if change == "input-kind":
            run_stream_wire(packed, _paths(d, "wire"), cfg)
        else:
            run_stream(other, iter(lines), cfg)


def test_plain_wire_snapshot_does_not_resume_a_weighted_file(corpus, tmp_path):
    packed, _, _, d = corpus
    ck = tmp_path / "ck"
    run_stream_wire(packed, _paths(d, "wire"), _cfg(ck, 1), max_chunks=2)
    assert ckpt.load(str(ck)).fingerprint.endswith("-wire")
    with pytest.raises(CheckpointMismatch):
        run_stream_wire(packed, _paths(d, "wirew"), _cfg(ck, 1, resume=True, match_impl="scan"))


@pytest.mark.parametrize("kind", ["text", "native", "wire"])
def test_resume_input_too_short_is_refused(corpus, tmp_path, kind):
    packed, rpacked, lines, d = corpus
    ck = tmp_path / "short"
    if kind == "wire":
        run_stream_wire(packed, _paths(d, "wire"), _cfg(ck, 2), max_chunks=3)
        short = tmp_path / "short.rawire"
        r = wire.WireReader(_paths(d, "wire"), packed)
        n_rows = ckpt.load(str(ck)).lines_consumed - 10
        with wire.WireWriter(str(short), wire.ruleset_fingerprint(packed), B) as w:
            for batch, n in r.iter_batches(0, B):
                take = min(n, n_rows)
                w.add(np.ascontiguousarray(batch[:, :take]), take, 0)
                n_rows -= take
                if not n_rows:
                    break
        r.close()
        with pytest.raises(ResumeInputMismatch, match="truncated"):
            run_stream_wire(packed, [str(short)], _cfg(ck, 2, resume=True))
        return
    run_stream(packed, iter(lines), _cfg(ck, 2), max_chunks=3)
    too_short = lines[: ckpt.load(str(ck)).lines_consumed - 10]
    with pytest.raises(ResumeInputMismatch, match="truncated"):
        if kind == "text":
            run_stream(packed, iter(too_short), _cfg(ck, 2, resume=True))
        else:
            p = tmp_path / "short.log"
            p.write_text("\n".join(too_short) + "\n")
            run_stream_file(packed, [str(p)], _cfg(ck, 2, resume=True), native=True)


def test_resume_without_a_snapshot_starts_fresh(corpus, tmp_path):
    packed, _, lines, _ = corpus
    ref, regs0 = run_stream(packed, iter(lines), _cfg(), topk=TOPK, return_state=True)
    rep, regs = run_stream(packed, iter(lines), _cfg(tmp_path / "empty", 0, resume=True),
                           topk=TOPK, return_state=True)
    for k in regs0:
        np.testing.assert_array_equal(regs[k], regs0[k], err_msg=k)
    assert _strip(rep) == _strip(ref)
    assert not (tmp_path / "empty").exists()  # no cadence: nothing written


def test_totals_are_cumulative_and_the_rate_is_this_runs(corpus, tmp_path):
    packed, _, _, d = corpus
    ck = tmp_path / "ck"
    crashed = run_stream_wire(packed, _paths(d, "wire"), _cfg(ck, 2), max_chunks=5)
    assert crashed.totals["wire_rows_only"] is True
    assert crashed.totals["lines_total"] == 5 * B  # rows so far, not raw lines
    snap = ckpt.load(str(ck))
    rep = run_stream_wire(packed, _paths(d, "wire"), _cfg(ck, 2, resume=True))
    full = run_stream_wire(packed, _paths(d, "wire"), _cfg())
    t = rep.totals
    for k in ("lines_total", "lines_matched", "lines_skipped", "chunks", "wire_rows"):
        assert t[k] == full.totals[k], k
    this_run = t["wire_rows"] - snap.lines_consumed
    assert t["throughput"]["lines"] == this_run
    assert t["throughput"]["chunks_ticked"] == t["chunks"] - snap.n_chunks
    assert t["lines_per_sec"] == pytest.approx(this_run / t["elapsed_sec"], rel=0.02)


def test_meter_prints_the_references_periodic_line(capsys):
    m = ThroughputMeter(2)
    for _ in range(5):
        m.tick(100)
    lines = capsys.readouterr().err.splitlines()
    assert [ln.split(" lines,")[0] for ln in lines] == ["[chunk 2] 200", "[chunk 4] 400"]
    assert all("lines/s (inst)" in ln and ln.endswith("lines/s (cum)") for ln in lines)
    assert m.summary()["lines"] == 500


# --- the CLI ----------------------------------------------------------------


def _run_args(d, *extra):
    return ["run", "--ruleset", str(d / "fw1"), "--logs", str(d / "fw1.log"),
            "--batch-size", str(B), "--topk", str(TOPK), "--json", *extra]


def test_cli_kill_and_resume(corpus, tmp_path, capsys):
    packed, _, _, d = corpus
    ck = tmp_path / "ck"
    sketch = ("--cms-width", str(SKETCH["cms_width"]), "--hll-p", str(SKETCH["hll_p"]))
    assert cli.main(_run_args(d, "--device", "cpu", "--native-parse", *sketch,
                              "--checkpoint-every", "2", "--checkpoint-dir",
                              str(tmp_path / "full"), "--out", str(tmp_path / "full.json"))) == 0
    run_stream_file(packed, [str(d / "fw1.log")], _cfg(ck, 2), native=True, max_chunks=5)
    capsys.readouterr()
    assert cli.main(_run_args(d, "--device", "cpu", "--native-parse", *sketch,
                              "--checkpoint-every", "2", "--checkpoint-dir", str(ck),
                              "--resume", "--report-every", "2",
                              "--out", str(tmp_path / "res.json"))) == 0
    err = capsys.readouterr().err
    full = json.loads((tmp_path / "full.json").read_text())
    res = json.loads((tmp_path / "res.json").read_text())
    assert _strip(res) == _strip(full)
    left = full["totals"]["chunks"] - 4  # the snapshot was taken at chunk 4
    assert res["totals"]["throughput"]["chunks_ticked"] == left
    assert err.count("lines/s (inst)") == left // 2
    # another batch size: the snapshot is refused, exit 4 (the reference's
    # checkpoint-mismatch code)
    args = _run_args(d, "--device", "cpu", *sketch, "--checkpoint-dir", str(ck), "--resume")
    args[args.index("--batch-size") + 1] = str(B // 2)
    assert cli.main(args) == 4
    assert "different ruleset" in capsys.readouterr().err


@pytest.fixture
def ref_one_device(monkeypatch):
    """The reference CLI on a one-device mesh (the suite fakes eight)."""
    make = rmesh.make_mesh
    monkeypatch.setattr(rmesh, "make_mesh",
                        lambda devices=None, *a, **k: make(jax.devices()[:1], *a, **k))


@pytest.mark.parametrize("flags", [
    ("--cms-width", "2048", "--cms-depth", "3", "--hll-p", "7"),
    ("--no-exact-counts", "--topk-sample-shift", "2", "--register-budget-mb", "64"),
])
def test_cli_sketch_flags_give_the_reference_clis_report(corpus, tmp_path, ref_one_device,
                                                          flags):
    _, _, _, d = corpus
    mine, ref = tmp_path / "mine.json", tmp_path / "ref.json"
    assert cli.main(_run_args(d, "--device", "cpu", "--no-native-parse", *flags,
                              "--out", str(mine))) == 0
    assert rcli.main(_run_args(d, "--no-native-parse", "--blackbox", "off",
                               "--checkpoint-dir", str(tmp_path / "ck"), *flags,
                               "--out", str(ref))) == 0
    assert _strip(json.loads(mine.read_text())) == _strip(json.loads(ref.read_text()))


def test_cli_register_budget_refusal(corpus, capsys):
    _, _, _, d = corpus
    assert cli.main(_run_args(d, "--device", "cpu", "--hll-p", "16",
                              "--register-budget-mb", "1")) == 2
    assert "budget" in capsys.readouterr().err


def test_cli_oracle_backend_gives_the_reference_clis_report(corpus, tmp_path, capsys):
    _, _, _, d = corpus
    args = ["run", "--ruleset", str(d / "fw1"), "--logs", str(d / "fw1.log"), "--backend",
            "oracle", "--acl-configs", str(d / "fw1.cfg"), "--json", "--topk", "5"]
    assert cli.main(args + ["--out", str(tmp_path / "mine.json")]) == 0
    assert rcli.main(args + ["--out", str(tmp_path / "ref.json")]) == 0
    assert (tmp_path / "mine.json").read_text() == (tmp_path / "ref.json").read_text()
    capsys.readouterr()
    for bad in (["--resume"], ["--checkpoint-every", "2"], ["--no-exact-counts"],
                ["--coalesce", "on", "--match-impl", "scan"]):
        assert cli.main(args + bad) == 2
        assert "only apply to --backend=tpu" in capsys.readouterr().err
    assert cli.main(args[:7] + ["--json"]) == 2  # no --acl-configs
    assert cli.main(["run", "--ruleset", str(d / "fw1"), "--logs", str(d / "w0.rawire"),
                     "--backend", "oracle", "--acl-configs", str(d / "fw1.cfg")]) == 2


def test_cli_packed_input_refuses_text(corpus, tmp_path, capsys):
    _, _, _, d = corpus
    assert cli.main(_run_args(d, "--device", "cpu", "--packed-input")) == 2
    assert "--packed-input" in capsys.readouterr().err
    args = _run_args(d, "--device", "cpu", "--packed-input", "--out", str(tmp_path / "w.json"))
    args[args.index("--logs") + 1] = str(d / "w0.rawire")
    assert cli.main(args) == 0
    assert json.loads((tmp_path / "w.json").read_text())["totals"]["wire_rows"] > 0


@pytest.mark.parametrize("v6", ["0", "0.3"])
def test_cli_synth_flows_writes_the_references_corpus(tmp_path, v6):
    args = ["synth", "--acls", "3", "--rules", "8", "--lines", "3000", "--seed", "4",
            "--flows", "200", "--skew", "1.2", "--v6-fraction", v6]
    assert cli.main(args + ["--out-dir", str(tmp_path / "p")]) == 0
    assert rcli.main(args + ["--out-dir", str(tmp_path / "r")]) == 0
    for f in ("fw1.cfg", "fw1.log"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "r" / f).read_bytes()
    lines = (tmp_path / "p" / "fw1.log").read_text().splitlines()
    assert len(lines) == 3000 and len(set(lines)) < 1500  # repeated flows
