"""Checkpoint/resume of the port over dual-stack (IPv4 + IPv6) input.

Mirrors ``tests/test_stream6.py::test_crash_resume_bit_identity_with_v6``
and ``tests/test_wire6.py::test_wire_crash_resume_across_phase_boundary``
on the port: a run killed anywhere and resumed ends with the registers,
talker tables and Report of the run that was never stopped, the port's
and the reference's (one-device mesh), over Python and native text and
over wire v2 / v3 killed in its v4 phase or in its v6 phase.  Three
things can go wrong only here, and the Report comparison (``topk`` past
the tracker's capacity) sees each: v6 rows staged from consumed lines
must step before a save; the salts of the v6 chunks must replay; and
the v6 talkers seen before the crash must render as addresses, which
needs the snapshot's digest map.  Each package resumes the other's
dual-stack snapshots.  The stacked layout resumes the same way over text
and wire v2.  Tolerance 0.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, wire  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import (  # noqa: E402
    run_stream, run_stream_file, run_stream_wire,
)
from tests._torch_refnative import ensure_reference_native  # noqa: E402
from tests.test_stream6 import CFG, mixed_lines  # noqa: E402
from tests.test_torch_checkpoint import (  # noqa: E402, F401
    TOPK, _one_torch_thread, _strip, assert_resume_bit_identical, mesh1,
)

SKETCH = dict(cms_width=1 << 12, cms_depth=4, hll_p=8)
B = 128


def _cfg(ck=None, every=0, resume=False, **kw):
    if ck is not None:
        kw["checkpoint_dir"] = str(ck)
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu",
                          checkpoint_every_chunks=every, resume=resume, **kw)


def _jcfg(ck, every=1 << 20, resume=False):
    return JConfig(batch_size=B, sketch=JSketch(**SKETCH), checkpoint_every_chunks=every,
                   checkpoint_dir=str(ck), resume=resume)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume6")
    packed = pack.pack_rulesets([aclparse.parse_asa_config(CFG, "fw1")])
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(CFG, "fw1")])
    assert packed.has_v6
    lines = mixed_lines(2500, seed=5)
    log = d / "logs.txt"
    log.write_text("\n".join(lines) + "\n")
    for weighted in (False, True):
        wire.convert_logs(packed, [str(log)], str(d / f"w{int(weighted)}.rawire"),
                          coalesce=weighted, batch_size=B, block_rows=B)
    r = wire.WireReader([str(d / "w0.rawire")], packed)
    n4_chunks = -(-r.n_rows // B)
    r.close()
    return packed, rpacked, lines, d, n4_chunks


def _wire_path(d, case):
    return [str(d / ("w1.rawire" if "weighted" in case else "w0.rawire"))]


def _port_run(case, packed, lines, d, cfg, max_chunks=None):
    if case == "text-python":
        return run_stream(packed, iter(lines), cfg, topk=TOPK, return_state=True,
                          max_chunks=max_chunks)
    if case == "text-native":
        return run_stream_file(packed, [str(d / "logs.txt")], cfg, native=True, topk=TOPK,
                               return_state=True, max_chunks=max_chunks)
    return run_stream_wire(packed, _wire_path(d, case), cfg, topk=TOPK, return_state=True,
                           max_chunks=max_chunks)


def _ref_run(case, rpacked, lines, d, jcfg, max_chunks=None):
    if case == "text-python":
        return rstream.run_stream(rpacked, iter(lines), jcfg, topk=TOPK, mesh=mesh1(),
                                  max_chunks=max_chunks)
    if case == "text-native":
        ensure_reference_native()
        return rstream.run_stream_file(rpacked, [str(d / "logs.txt")], jcfg, native=True,
                                       topk=TOPK, mesh=mesh1(), max_chunks=max_chunks)
    return rstream.run_stream_wire(rpacked, _wire_path(d, case), jcfg, topk=TOPK,
                                   mesh=mesh1(), max_chunks=max_chunks)


#: case -> (port config, crash after N batches (n4 = v4 chunks of the wire
#: file), cadence, the crash phase of a wire file)
CASES = {
    "text-python": (dict(prefetch_depth=0), lambda n4: 9, 3, None),
    "text-native": (dict(prefetch_depth=2), lambda n4: 9, 3, None),
    "wire-v2-phase1": ({}, lambda n4: n4 // 2 + 1, 2, 1),
    "wire-v2-phase2": (dict(prefetch_depth=0), lambda n4: n4 + 3, 1, 2),
    "wire-v3-weighted-phase2": (dict(match_impl="scan"), lambda n4: n4 + 2, 1, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_bit_identical(corpus, tmp_path, case):
    packed, rpacked, lines, d, n4_chunks = corpus
    cfg_kw, crash, every, phase = CASES[case]
    n4 = n4_chunks
    if "weighted" in case:
        r = wire.WireReader(_wire_path(d, case), packed)
        n4 = -(-r.n_rows // B)
        r.close()

    def check_snap(snap):
        if phase is not None:
            r = wire.WireReader(_wire_path(d, case), packed)
            in_v6 = snap.lines_consumed > r.n_rows
            r.close()
            assert in_v6 == (phase == 2), (snap.lines_consumed, phase)
        # the digest map of the v6 talkers tracked so far rides the snapshot
        # (a wire file's v6 rows come after its v4 phase)
        assert bool(snap.extra and snap.extra["v6_digests"]) == (phase != 1)

    assert_resume_bit_identical(
        lambda cfg, m=None: _port_run(case, packed, lines, d, cfg, m),
        lambda jcfg: _ref_run(case, rpacked, lines, d, jcfg),
        lambda ck, every, resume=False: _cfg(ck, every, resume, **cfg_kw),
        _jcfg, crash(n4), every, tmp_path, check_snap,
    )


@pytest.mark.parametrize("case", ["text-python", "text-native", "wire-v2-phase2"])
def test_stacked_kill_and_resume_bit_identical(corpus, tmp_path, case):
    """The stacked layout over dual-stack input: each save steps what the
    group buffer holds, then the staged v6 rows; the resumed run equals the
    port's and the reference's stacked runs saved on the same cadence."""
    packed, rpacked, lines, d, n4 = corpus
    crash, every = (n4 + 3, 1) if case.startswith("wire") else (9, 3)
    stacked = dict(layout="stacked", match_impl="scan")
    assert_resume_bit_identical(
        lambda cfg, m=None: _port_run(case, packed, lines, d, cfg, m),
        lambda jcfg: _ref_run(case, rpacked, lines, d, jcfg),
        lambda ck, every, resume=False: _cfg(ck, every, resume, **stacked),
        lambda ck, every: _jcfg(ck, every).replace(layout="stacked"), crash, every, tmp_path,
    )


@pytest.mark.parametrize("case", ["text-python", "wire-v2-phase2"])
def test_port_resumes_a_reference_snapshot(corpus, tmp_path, case):
    packed, rpacked, lines, d, n4 = corpus
    jfull = _ref_run(case, rpacked, lines, d, _jcfg(tmp_path / "ref", every=2))
    jregs = rckpt.load(str(tmp_path / "ref")).arrays
    ck = tmp_path / "ck"
    crash = 9 if case == "text-python" else n4 + 3
    _ref_run(case, rpacked, lines, d, _jcfg(ck, every=2), max_chunks=crash)
    assert rckpt.load(str(ck)).extra["v6_digests"]
    rep, regs = _port_run(case, packed, lines, d, _cfg(ck, 2, resume=True))
    for k, v in jregs.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert _strip(rep) == _strip(jfull)


@pytest.mark.parametrize("case", ["text-native", "wire-v2-phase2"])
def test_reference_resumes_a_port_snapshot(corpus, tmp_path, case):
    packed, rpacked, lines, d, n4 = corpus
    full, _ = _port_run(case, packed, lines, d, _cfg(tmp_path / "full", 2))
    _ref_run(case, rpacked, lines, d, _jcfg(tmp_path / "ref"))
    jregs = rckpt.load(str(tmp_path / "ref")).arrays
    ck = tmp_path / "ck"
    _port_run(case, packed, lines, d, _cfg(ck, 2), 9 if case == "text-native" else n4 + 3)
    jrep = _ref_run(case, rpacked, lines, d, _jcfg(ck, every=2, resume=True))
    got = rckpt.load(str(ck))
    for k, v in jregs.items():
        np.testing.assert_array_equal(got.arrays[k], v, err_msg=k)
    assert _strip(jrep) == _strip(full)


def test_fingerprints_of_dual_stack_runs_are_the_references(corpus):
    """The v6 rows enter the hash, so a v4-only snapshot of the same v4 rows
    cannot resume a dual-stack run."""
    packed, rpacked, *_ = corpus
    mine = ckpt.fingerprint(packed, _cfg())
    assert mine == rckpt.fingerprint(rpacked, _jcfg("unused"), 1, 0)
    v4_only = pack.PackedRuleset(**{**vars(packed), "rules6": packed.rules6[:0]})
    assert not v4_only.has_v6 and ckpt.fingerprint(v4_only, _cfg()) != mine
