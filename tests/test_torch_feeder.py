"""The port's multi-worker host feed against the reference's.

Mirrors tests/test_feeder.py (all but its two observability tests, which
wait for the port's metrics and trace planes), the feeder cases of
tests/test_stream6.py and tests/test_wire6.py, and the reference CLI's
feed refusals.  Feeder batches follow raw-line counts, so per-chunk
talker candidates can differ from a sequential run's: each port run is
held to the reference's run in the same mode, worker count and batch
size (Report JSON apart from ``VOLATILE_TOTALS`` and ``totals.backend``;
registers against the reference's final snapshot), and its registers,
counts and unused set to the port's sequential run; so is a stacked-layout
run in each mode.  The reference runs
on a one-device mesh, so the ring mode has one ring on both sides.
Tolerance 0 throughout.  Every test also checks that each shared-memory
segment the port's feeder made is unlinked (the suite's conftest checks
``ra-`` threads and child processes).
"""

import io
import json
import os
import random
import signal
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.errors import AnalysisError as RAnalysisError  # noqa: E402
from ruleset_analysis_tpu.hostside import feeder as rfeeder  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.hostside import wire as rwire  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.errors import (  # noqa: E402
    AnalysisError, FeedWorkerError, ResumeInputMismatch,
)
from ruleset_analysis_tpu_torch.hostside import (  # noqa: E402
    aclparse, fastparse, feeder, oracle, pack, synth, wire,
)
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream, run_stream_file  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _segments_released(monkeypatch):
    """Every shared-memory segment the port's feeder creates is unlinked
    by the end of the test (its workers only attach by name)."""
    made = []
    real = feeder.shared_memory.SharedMemory

    class Recording:
        @staticmethod
        def SharedMemory(*args, **kw):
            shm = real(*args, **kw)
            made.append(shm.name)
            return shm

    monkeypatch.setattr(feeder, "shared_memory", Recording)
    yield made
    left = [n for n in made if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]
    assert not left, f"shared-memory segments left behind: {left}"


SKETCH = dict(cms_width=1 << 11, cms_depth=4, hll_p=6)
B = 256
TOPK = 600  # past 2 x topk_capacity: the report lists every tracked talker
MODES = ("process", "thread", "ring")
REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")


def mesh1():
    return rmesh.make_mesh(jax.devices()[:1])


def _cfg(**kw):
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu", **kw)


def _jcfg(**kw):
    return JConfig(batch_size=B, sketch=JSketch(**SKETCH), **kw)


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json()) if not isinstance(rep, dict) else json.loads(json.dumps(rep))
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


def _rule_view(rep: dict) -> dict:
    """What registers decide: per-rule hits and unique sources, the unused
    set and the line counters (not the chunk-sensitive talkers)."""
    t = rep["totals"]
    return {
        "per_rule": {(e["firewall"], e["acl"], e["index"]): (e["hits"], e.get("unique_sources"))
                     for e in rep["per_rule"]},
        "unused": rep["unused"],
        "lines": (t["lines_total"], t["lines_matched"], t["lines_skipped"]),
    }


def _write(d, name, lines):
    p = d / name
    p.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(p)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference test's v4 corpus: out-direction bindings (two rows for
    some lines), 3000 lines over two files."""
    d = tmp_path_factory.mktemp("feed")
    text = synth.synth_config(n_acls=3, rules_per_acl=10, seed=61, egress_acls=True)
    rs = aclparse.parse_asa_config(text, "fw1")
    packed = pack.pack_rulesets([rs])
    pack.save_packed(packed, str(d / "fw1"))
    (d / "fw1.cfg").write_text(text)
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 3000, seed=62), seed=63,
                                variety=0.4)
    paths = [_write(d, "a.log", lines[:1700]), _write(d, "b.log", lines[1700:])]
    res = oracle.Oracle([rs]).consume(list(lines))
    return packed, rpack.load_packed(str(d / "fw1")), paths, res, d


@pytest.fixture(scope="module")
def corpus6(tmp_path_factory):
    """The reference test's dual-stack corpus: 1600 v4 and 1400 v6 lines, shuffled."""
    d = tmp_path_factory.mktemp("feed6")
    text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=77, v6_fraction=0.5)
    rs = aclparse.parse_asa_config(text, "fw1")
    packed = pack.pack_rulesets([rs])
    pack.save_packed(packed, str(d / "fw1"))
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 1600, seed=78), seed=79)
    lines += synth.render_syslog6(packed, synth.synth_tuples6(packed, 1400, seed=80), seed=81)
    random.Random(7).shuffle(lines)
    assert packed.has_v6
    res = oracle.Oracle([rs]).consume(list(lines))
    return packed, rpack.load_packed(str(d / "fw1")), [_write(d, "mixed.log", lines)], res, d


class Runs:
    """Port and reference runs, each made once per module."""

    def __init__(self, corpora: dict, tmp):
        self.corpora = corpora
        self.tmp = tmp
        self._port: dict = {}
        self._ref: dict = {}

    def port(self, inp, mode, workers):
        """(stripped Report, registers) of the port's run; ``workers=0`` is sequential."""
        key = (inp, mode, workers)
        if key not in self._port:
            corpus, depth = self.corpora[inp]
            packed, _, paths, _, _ = corpus
            rep, regs = run_stream_file(packed, paths, _cfg(prefetch_depth=depth), topk=TOPK,
                                        return_state=True, feed_workers=workers,
                                        feed_mode=mode)
            self._port[key] = (_strip(rep), regs)
        return self._port[key]

    def ref(self, inp, mode, workers):
        """(stripped Report, registers of its final snapshot) of the reference's run."""
        key = (inp, mode, workers)
        if key not in self._ref:
            corpus, depth = self.corpora[inp]
            _, rpacked, paths, _, _ = corpus
            ensure_reference_native()
            ck = self.tmp / f"ref-{inp}-{mode}-{workers}"
            jrep = rstream.run_stream_file(
                rpacked, paths, _jcfg(prefetch_depth=depth, checkpoint_every_chunks=1 << 20,
                                      checkpoint_dir=str(ck)),
                topk=TOPK, mesh=mesh1(), feed_workers=workers, feed_mode=mode,
            )
            self._ref[key] = (_strip(jrep), rckpt.load(str(ck)).arrays)
        return self._ref[key]


@pytest.fixture(scope="module")
def runs(corpus, corpus6, tmp_path_factory):
    return Runs({"v4-prefetch2": (corpus, 2), "v4-prefetch0": (corpus, 0),
                 "dual-stack": (corpus6, 2)}, tmp_path_factory.mktemp("runs"))


# ---------------------------------------------------------------------------
# descriptors and counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip", [0, 500])
def test_scan_batches_cover_every_line_as_the_reference(corpus, skip):
    packed, _, paths, _, _ = corpus
    ensure_reference_native()
    descs = list(feeder._scan_batches(paths, B, skip))
    assert descs == list(rfeeder._scan_batches(paths, B, skip))
    assert sum(d[3] for d in descs) == 3000 - skip
    if skip == 0:
        # descriptors tile each file contiguously, never spanning files
        ends = {}
        for path_i, off, nbytes, n in descs:
            assert off == ends.get(path_i, 0) and 1 <= n <= B
            ends[path_i] = off + nbytes
        assert [ends[i] for i in range(len(paths))] == [os.path.getsize(p) for p in paths]


def test_scan_batches_refuse_a_short_input(corpus):
    _, _, paths, _, _ = corpus
    with pytest.raises(ResumeInputMismatch, match="ran short by 1"):
        list(feeder._scan_batches(paths, B, 3001))


def _feeder(mode, packed, paths, **kw):
    cls = {"process": feeder.ParallelFeeder, "thread": feeder.ThreadedFeeder,
           "ring": feeder.RingFeeder}[mode]
    return cls(packed, paths, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_feeder_counters_equal_the_oracle(corpus, mode):
    packed, _, paths, res, _ = corpus
    src = _feeder(mode, packed, paths, n_workers=3)
    total_lines = total_valid = 0
    for batch, n_raw in src.batches(0, B):
        # 2x wide: out-direction bindings, and no batch closes early
        assert batch.shape == (pack.TUPLE_COLS, 2 * B)
        total_lines += n_raw
        total_valid += int(batch[pack.T_VALID].sum())
    assert total_lines == 3000
    assert src.packer.parsed == total_valid == res.lines_matched
    assert src.packer.skipped == res.lines_skipped


# ---------------------------------------------------------------------------
# reports and registers, against the reference and the sequential run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inp", ["v4-prefetch2", "v4-prefetch0", "dual-stack"])
@pytest.mark.parametrize("workers", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_feeder_run_equals_the_reference(runs, mode, workers, inp):
    rep, regs = runs.port(inp, mode, workers)
    jrep, jregs = runs.ref(inp, mode, workers)
    assert rep == jrep
    assert sorted(jregs) == sorted(REGISTERS)
    for k, v in jregs.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    # registers, counts and the unused set equal the sequential run's
    seq, seq_regs = runs.port(inp, "process", 0)
    for k in REGISTERS:
        np.testing.assert_array_equal(regs[k], seq_regs[k], err_msg=k)
    assert _rule_view(rep) == _rule_view(seq)


@pytest.mark.parametrize("inp", ["v4-prefetch2", "dual-stack"])
def test_the_three_modes_give_one_report(runs, inp):
    reps = [runs.port(inp, mode, 2)[0] for mode in MODES]
    assert reps[0] == reps[1] == reps[2]


@pytest.mark.parametrize("mode, inp", [(m, "v4") for m in MODES] + [("ring", "dual-stack")])
def test_stacked_feeder_run_equals_the_reference(corpus, corpus6, mode, inp):
    """``--layout stacked --feed-workers 2`` under prefetch: the producer only
    parses, the ring feeder assembles its batches (2x wide with
    out-direction bindings), and the loop buckets them by ACL.  The Report
    equals the reference's same run; registers equal the sequential run's."""
    packed, rpacked, paths, res, _ = corpus if inp == "v4" else corpus6
    kw = dict(layout="stacked", prefetch_depth=2)
    rep, regs = run_stream_file(packed, paths, _cfg(match_impl="scan", **kw), topk=TOPK,
                                return_state=True, feed_workers=2, feed_mode=mode)
    ensure_reference_native()
    jrep = rstream.run_stream_file(rpacked, paths, _jcfg(**kw), topk=TOPK, mesh=mesh1(),
                                   feed_workers=2, feed_mode=mode)
    assert _strip(rep) == _strip(jrep)
    _, seq = run_stream_file(packed, paths, _cfg(), topk=TOPK, return_state=True)
    for k in REGISTERS:
        np.testing.assert_array_equal(regs[k], seq[k], err_msg=k)
    assert rep.totals["lines_matched"] == res.lines_matched


def test_ring_views_reach_the_loop_without_assembly(corpus, monkeypatch):
    """With prefetch on, the loop takes each ring batch as views and packs
    them straight into the copy to the device; with it off the feeder
    assembles plain batches."""
    from ruleset_analysis_tpu_torch.runtime import ingest, stream

    packed, _, paths, _, _ = corpus
    seen = []
    real = ingest.views_to_device

    def spy(rb, device, ring=None):
        seen.append((len(rb.views), rb.released))
        out = real(rb, device, ring)
        assert rb.released
        return out

    monkeypatch.setattr(stream, "views_to_device", spy)
    rep = run_stream_file(packed, paths, _cfg(prefetch_depth=2), feed_workers=2,
                          feed_mode="ring")
    assert seen and all(v == (1, False) for v in seen)
    assert len(seen) == rep.totals["chunks"]
    seen.clear()
    run_stream_file(packed, paths, _cfg(prefetch_depth=0), feed_workers=2, feed_mode="ring")
    assert not seen


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _resume_cfg(ck, **kw):
    return _cfg(checkpoint_every_chunks=3, checkpoint_dir=str(ck), **kw)


def _resume_jcfg(ck, **kw):
    return _jcfg(checkpoint_every_chunks=3, checkpoint_dir=str(ck), **kw)


@pytest.mark.parametrize("mode", MODES)
def test_feeder_kill_and_resume_equals_the_reference(corpus, tmp_path, mode):
    """Killed after 5 chunks and resumed with the feeder: the Report and
    registers of the reference's uninterrupted run in the same mode."""
    packed, rpacked, paths, _, _ = corpus
    ensure_reference_native()
    jrep = rstream.run_stream_file(rpacked, paths, _resume_jcfg(tmp_path / "ref"), topk=TOPK,
                                   mesh=mesh1(), feed_workers=2, feed_mode=mode)
    jsnap = rckpt.load(str(tmp_path / "ref"))
    ck = tmp_path / "ck"
    run_stream_file(packed, paths, _resume_cfg(ck), topk=TOPK, feed_workers=2, feed_mode=mode,
                    max_chunks=5)
    snap = ckpt.load(str(ck))
    assert snap is not None and snap.n_chunks == 3 and snap.lines_consumed == 3 * B
    rep, regs = run_stream_file(packed, paths, _resume_cfg(ck, resume=True), topk=TOPK,
                                return_state=True, feed_workers=2, feed_mode=mode)
    for k, v in jsnap.arrays.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert _strip(rep) == _strip(jrep)
    assert rep.totals["lines_total"] == 3000


@pytest.mark.parametrize("mode", MODES)
def test_port_resumes_a_reference_feeder_snapshot(corpus, tmp_path, mode):
    packed, rpacked, paths, _, _ = corpus
    ensure_reference_native()
    jrep = rstream.run_stream_file(rpacked, paths, _resume_jcfg(tmp_path / "ref"), topk=TOPK,
                                   mesh=mesh1(), feed_workers=2, feed_mode=mode)
    jregs = rckpt.load(str(tmp_path / "ref")).arrays
    ck = tmp_path / "ck"
    rstream.run_stream_file(rpacked, paths, _resume_jcfg(ck), topk=TOPK, mesh=mesh1(),
                            feed_workers=2, feed_mode=mode, max_chunks=5)
    assert rckpt.load(str(ck)).n_chunks == 3
    rep, regs = run_stream_file(packed, paths, _resume_cfg(ck, resume=True), topk=TOPK,
                                return_state=True, feed_workers=2, feed_mode=mode)
    for k, v in jregs.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert _strip(rep) == _strip(jrep)


def test_dual_stack_ring_kill_and_resume(corpus6, tmp_path):
    """The v6 rows of a killed ring run's consumed batches are in its
    snapshot's registers, and the resumed registers equal the reference's."""
    packed, rpacked, paths, _, _ = corpus6
    ensure_reference_native()
    rstream.run_stream_file(rpacked, paths, _resume_jcfg(tmp_path / "ref"), topk=TOPK,
                            mesh=mesh1(), feed_workers=2, feed_mode="ring")
    jsnap = rckpt.load(str(tmp_path / "ref"))
    ck = tmp_path / "ck"
    run_stream_file(packed, paths, _resume_cfg(ck), topk=TOPK, feed_workers=2,
                    feed_mode="ring", max_chunks=5)
    rep, regs = run_stream_file(packed, paths, _resume_cfg(ck, resume=True), topk=TOPK,
                                return_state=True, feed_workers=2, feed_mode="ring")
    for k, v in jsnap.arrays.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert rep.totals["lines_matched"] == jsnap.parsed
    assert rep.totals["lines_total"] == 3000


# ---------------------------------------------------------------------------
# failures: typed, bounded, and leaving nothing behind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["process", "ring"])
def test_killed_worker_raises_and_does_not_hang(corpus, mode):
    packed, _, paths, _, _ = corpus
    src = (feeder.ParallelFeeder(packed, paths, n_workers=1) if mode == "process"
           else feeder.RingFeeder(packed, paths, n_workers=2, n_rings=8))
    gen = src.batches(0, 64 if mode == "process" else B)
    next(gen)
    os.kill(src._workers[0].pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(FeedWorkerError, match="died without reporting") as e:
        for _ in gen:
            pass
    assert isinstance(e.value, RuntimeError)
    # the liveness probe runs every POLL_SEC, far inside the stall timeout
    assert time.monotonic() - t0 < 3 * feeder.POLL_SEC < src.stall_timeout


def test_ring_slot_exhaustion_raises_typed(corpus):
    packed, _, paths, _, _ = corpus
    src = feeder.RingFeeder(packed, paths, n_workers=2, n_rings=2, ring_depth=2)
    src.emit_views = True
    held = []
    gen = src.batches(0, B)
    try:
        with pytest.raises(FeedWorkerError, match="ring slots exhausted"):
            for rb, _n in gen:
                held.append(rb)  # never released: the slots run dry
    finally:
        for rb in held:
            rb.release()
        gen.close()
    assert len(held) == 2  # the ring depth


def test_ring_refuses_runtime_coalescing_as_the_reference(corpus):
    packed, rpacked, paths, _, _ = corpus
    ensure_reference_native()
    with pytest.raises(RAnalysisError) as want:
        rstream.run_stream_file(rpacked, paths, _jcfg(coalesce="on"), mesh=mesh1(),
                                feed_workers=2, feed_mode="ring")
    with pytest.raises(AnalysisError, match="convert --coalesce") as got:
        run_stream_file(packed, paths, _cfg(coalesce="on", match_impl="scan"),
                        feed_workers=2, feed_mode="ring")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(feed_workers=2, feed_mode="bogus"),
    dict(feed_mode="ring"),
    dict(feed_workers=2, native=False),
], ids=["bad-mode", "ring-without-workers", "workers-without-native"])
def test_run_stream_file_refusals_as_the_reference(corpus, kw):
    packed, rpacked, paths, _, _ = corpus
    with pytest.raises(RAnalysisError) as want:
        rstream.run_stream_file(rpacked, paths, _jcfg(), mesh=mesh1(), **kw)
    with pytest.raises(AnalysisError) as got:
        run_stream_file(packed, paths, _cfg(), **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the v6 plane
# ---------------------------------------------------------------------------


def _row_streams(batches_it, take_v6):
    """(v4 valid-row stream, v6 row stream) concatenated over all batches."""
    v4, v6 = [], []
    for batch, _n in batches_it:
        v4.append(batch[:, batch[pack.T_VALID] == 1].copy())
        rows6 = take_v6()
        if len(rows6):
            v6.append(np.asarray(rows6, dtype=np.uint32))
    return np.concatenate(v4, axis=1), np.concatenate(v6)


@pytest.mark.parametrize("mode", MODES)
def test_feeder_v6_plane_byte_identical_to_sequential(corpus6, mode):
    packed, _, paths, _, _ = corpus6
    packer = fastparse.NativePacker(packed)
    seq4, seq6 = _row_streams(fastparse.batches_from_files(paths, packer, B), packer.take_v6)
    assert seq6.shape[0] > 0
    # the ring mode over 8 rings: the committed stream is still the
    # sequential parse's, in line order across ring partitions
    src = _feeder(mode, packed, paths, n_workers=2, **({"n_rings": 8} if mode == "ring" else {}))
    par4, par6 = _row_streams(src.batches(0, B), src.take_v6)
    np.testing.assert_array_equal(seq4, par4)
    np.testing.assert_array_equal(seq6, par6)
    # the capped digest -> address map: the same rows in the same order
    want: dict[int, int] = {}
    for r in seq6:
        src_ip = pack.limbs_u128(*r[pack.T6_SRC:pack.T6_SRC + 4])
        want.setdefault(pack.fold_src32_host(src_ip), src_ip)
    assert src.v6_digests == want


def test_feeder_v6_registers_match_text_run(tmp_path):
    """tests/test_stream6.py's feeder case, held to the reference too."""
    text = synth.synth_config(n_acls=3, rules_per_acl=10, seed=77, v6_fraction=0.4)
    rs = aclparse.parse_asa_config(text, "fw1")
    packed = pack.pack_rulesets([rs])
    pack.save_packed(packed, str(tmp_path / "fw1"))
    lines = (synth.render_syslog(packed, synth.synth_tuples(packed, 700, seed=77), seed=77)
             + synth.render_syslog6(packed, synth.synth_tuples6(packed, 400, seed=77), seed=78))
    random.Random(3).shuffle(lines)
    p = _write(tmp_path, "logs.txt", lines)
    res = oracle.Oracle([rs]).consume(list(lines))
    rep_text = run_stream(packed, iter(lines), _cfg(), topk=5)
    rep_feed = run_stream_file(packed, p, _cfg(), feed_workers=2, topk=5)
    ensure_reference_native()
    jrep = rstream.run_stream_file(rpack.load_packed(str(tmp_path / "fw1")), p, _jcfg(),
                                   feed_workers=2, topk=5, mesh=mesh1())
    hits = {(e["firewall"], e["acl"], e["index"]): e["hits"]
            for e in rep_feed.per_rule if e["hits"]}
    assert hits == {(e["firewall"], e["acl"], e["index"]): e["hits"]
                    for e in rep_text.per_rule if e["hits"]} == dict(res.hits)
    assert rep_feed.unused == rep_text.unused == res.unused_rules([rs])
    assert rep_feed.totals["lines_matched"] == res.lines_matched
    assert _strip(rep_feed) == _strip(jrep)


def test_feeder_convert_v6_byte_identical_to_reference(corpus6, tmp_path):
    """tests/test_wire6.py's feeder case: a feeder convert of a unified
    corpus writes the native convert's bytes, and the reference's."""
    packed, rpacked, paths, _, _ = corpus6
    ensure_reference_native()
    wire.convert_logs(packed, paths, str(tmp_path / "fd.rawire"), feed_workers=2)
    wire.convert_logs(packed, paths, str(tmp_path / "nat.rawire"), native=True)
    rwire.convert_logs(rpacked, paths, str(tmp_path / "ref.rawire"), feed_workers=2)
    blob = (tmp_path / "fd.rawire").read_bytes()
    assert blob == (tmp_path / "nat.rawire").read_bytes() == (tmp_path / "ref.rawire").read_bytes()
    with pytest.raises(ValueError, match="feed_workers requires the native parser"):
        wire.convert_logs(packed, paths, str(tmp_path / "x.rawire"), feed_workers=2,
                          native=False)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _both_cli(capsys, args):
    """(port rc, port stderr, reference rc, reference stderr) of one command line."""
    def one(main):
        try:
            rc = main(list(args))
        except SystemExit as e:
            rc = e.code
        return rc, capsys.readouterr().err

    return (*one(cli.main), *one(rcli.main))


@pytest.fixture(scope="module")
def wire_file(corpus):
    packed, _, paths, _, d = corpus
    out = str(d / "cli.rawire")
    wire.convert_logs(packed, paths, out)
    return out


@pytest.mark.parametrize("case", [
    ("wire", ["--feed-workers", "2"], "do not apply to packed .rawire inputs"),
    ("text", ["--feed-workers", "2", "--no-native-parse"],
     "--feed-workers requires file inputs and the native parser"),
    ("stdin", ["--feed-workers", "2"], "--feed-workers requires file inputs and the native parser"),
    ("text", ["--feed-mode", "ring"], "--feed-mode ring needs --feed-workers N"),
    ("text", ["--feed-mode", "ring", "--feed-workers", "1", "--no-native-parse"],
     "--feed-mode ring requires text file inputs and the native parser"),
    ("wire", ["--feed-mode", "ring", "--feed-workers", "1"],
     "--feed-mode ring requires text file inputs and the native parser"),
    ("oracle", ["--feed-workers", "2"], "only apply to --backend=tpu"),
    ("oracle", ["--feed-mode", "ring", "--feed-workers", "1"], "--feed-mode=ring"),
    ("text", ["--feed-mode", "bogus"], "invalid choice: 'bogus'"),
], ids=["wire-input", "no-native", "stdin", "ring-without-workers", "ring-no-native",
        "ring-wire-input", "oracle-workers", "oracle-ring", "bad-mode"])
def test_cli_feed_refusals_as_the_reference(corpus, wire_file, capsys, monkeypatch, case):
    kind, flags, phrase = case
    _, _, paths, _, d = corpus
    logs = {"wire": [wire_file], "stdin": ["-"]}.get(kind, paths)
    args = ["run", "--ruleset", str(d / "fw1"), "--logs", *logs, *flags]
    if kind == "oracle":
        args += ["--backend", "oracle", "--acl-configs", str(d / "fw1.cfg")]
    with open(paths[0], encoding="utf-8") as f:
        monkeypatch.setattr("sys.stdin", io.StringIO(f.read()))
    rc, err, jrc, jerr = _both_cli(capsys, args)
    assert rc == jrc == 2
    assert phrase in err and phrase in jerr


@pytest.mark.parametrize("mode", MODES)
def test_cli_run_with_feed_workers_equals_the_reference(corpus, tmp_path, capsys, mode):
    packed, rpacked, paths, _, d = corpus
    out = str(tmp_path / "r.json")
    assert cli.main(["run", "--ruleset", str(d / "fw1"), "--logs", *paths, "--device", "cpu",
                     "--batch-size", str(B), "--cms-width", str(SKETCH["cms_width"]),
                     "--hll-p", str(SKETCH["hll_p"]), "--feed-workers", "2",
                     "--feed-mode", mode, "--json", "--out", out]) == 0
    ensure_reference_native()
    jrep = rstream.run_stream_file(rpacked, paths, _jcfg(), mesh=mesh1(), feed_workers=2,
                                   feed_mode=mode)
    with open(out, encoding="utf-8") as f:
        assert _strip(json.load(f)) == _strip(jrep)


def test_feed_config_stall_timeout_reaches_the_feeder(corpus):
    packed, _, paths, _, _ = corpus
    src = feeder.ThreadedFeeder(packed, paths, n_workers=2, stall_timeout=7.5)
    assert src.stall_timeout == 7.5
    assert (feeder.ThreadedFeeder(packed, paths, n_workers=2).stall_timeout
            == AnalysisConfig().stall_timeout_sec)


@pytest.mark.parametrize("cls", ["ParallelFeeder", "RingFeeder", "ThreadedFeeder"])
def test_feeder_refuses_fewer_than_one_worker(corpus, cls):
    packed, _, paths, _, _ = corpus
    with pytest.raises(AnalysisError, match="n_workers >= 1, got 0"):
        getattr(feeder, cls)(packed, paths, n_workers=0)
