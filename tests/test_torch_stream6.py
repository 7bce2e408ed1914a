"""Dual-stack (IPv4 + IPv6) runs of the port end to end, against the
reference and the exact oracle.

Mirrors tests/test_stream6.py on the port.  The reference runs on a
one-device mesh, so its chunking and per-chunk salts are the
single-device ones.  Its final registers come from its own checkpoint
snapshot; the port's from ``return_state``.  Registers are equal under
any order of the v4 and v6 chunks, so the Report JSON is compared too,
with ``topk`` past the tracker's capacity so every talker candidate that
survived shows: the talkers equal the reference's only if the v6 chunks
step where the reference steps them.  Tolerance 0 throughout.

The stacked layout over the mixed corpus (v4 lines bucketed by ACL, v6
lines on the flat side path) gives the reference's stacked run, Python
and native parse.  Resume across the v6 side path is in
``tests/test_torch_resume6.py``, the multi-worker feeder's v6 path in
``tests/test_torch_feeder.py``.
"""

import json
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import oracle as roracle  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.parallel.mesh import make_mesh  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, fastparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import (  # noqa: E402
    _TextSource, run_stream, run_stream_file,
)

from tests._torch_refnative import ensure_reference_native  # noqa: E402
from tests.test_stream6 import CFG, V6_EDGE_LINES, mixed_lines  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SKETCH = dict(cms_width=1 << 12, cms_depth=4, hll_p=8)
B = 256
TOPK = 600  # past 2 x topk_capacity: the report lists every tracked talker


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json())
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


def _hits(rep) -> dict:
    return {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep.per_rule if e["hits"]}


def _cfg(**kw):
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu", **kw)


def _reference(packed_ref, lines=None, paths=None, native=False, ckpt=None, batch=B):
    """The reference's report and (with ``ckpt``) its final registers."""
    kw = {}
    if ckpt is not None:
        kw = dict(checkpoint_every_chunks=1 << 20, checkpoint_dir=str(ckpt))
    cfg = JConfig(batch_size=batch, sketch=JSketch(**SKETCH), **kw)
    mesh = make_mesh(jax.devices()[:1])
    if paths is None:
        rep = rstream.run_stream(packed_ref, iter(lines), cfg, topk=TOPK, mesh=mesh)
    else:
        if native:
            ensure_reference_native()
        rep = rstream.run_stream_file(packed_ref, paths, cfg, native=native, topk=TOPK,
                                      mesh=mesh)
    regs = rckpt.load(str(ckpt)).arrays if ckpt is not None else None
    return rep, regs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream6")
    rs = aclparse.parse_asa_config(CFG, "fw1")
    packed = pack.pack_rulesets([rs])
    assert packed.has_v6 and packed.rules.shape[0] > 0
    lines = mixed_lines(2500, seed=5)
    (d / "logs.txt").write_text("\n".join(lines) + "\n")
    res = roracle.Oracle([raclparse.parse_asa_config(CFG, "fw1")]).consume(list(lines))
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(CFG, "fw1")])
    jrep, jregs = _reference(rpacked, lines, ckpt=d / "ck")
    return packed, rs, lines, res, rpacked, jrep, jregs, d


def test_mixed_stream_counts_match_oracle(corpus):
    packed, rs, lines, res, *_ = corpus
    rep = run_stream(packed, iter(lines), _cfg(), topk=5)
    assert _hits(rep) == dict(res.hits)
    assert rep.totals["lines_matched"] == res.lines_matched
    assert rep.totals["lines_skipped"] == res.lines_skipped == 0
    assert rep.unused == res.unused_rules([raclparse.parse_asa_config(CFG, "fw1")])


@pytest.mark.parametrize("impl", ["fused", "scan"])
@pytest.mark.parametrize("depth", [0, 2])
def test_registers_and_report_equal_reference(corpus, impl, depth):
    """Python parse: every register and the whole report equal the reference's."""
    packed, _, lines, _, _, jrep, jregs, _ = corpus
    rep, regs = run_stream(packed, iter(lines), _cfg(match_impl=impl, prefetch_depth=depth),
                           topk=TOPK, return_state=True)
    for k, v in jregs.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert _strip(rep) == _strip(jrep)
    assert rep.totals["chunks"] == jrep.totals["chunks"]


@pytest.mark.parametrize("depth", [0, 2])
def test_native_run_equals_reference(corpus, tmp_path, depth):
    """The native dual-family parse, with and without prefetch, gives the
    reference's native run: registers, candidates and report."""
    packed, _, _, _, rpacked, _, _, d = corpus
    paths = [str(d / "logs.txt")]
    jrep, jregs = _reference(rpacked, paths=paths, native=True, ckpt=tmp_path / "ck")
    rep, regs = run_stream_file(packed, paths, _cfg(prefetch_depth=depth), native=True,
                                topk=TOPK, return_state=True)
    for k, v in jregs.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert _strip(rep) == _strip(jrep)


@pytest.mark.parametrize("native", [False, True])
def test_stacked_run_equals_reference(corpus, tmp_path, native):
    """``--layout stacked`` over the mixed corpus (the reference's
    ``test_stacked_text_v6_matches_flat``): registers and report equal the
    reference's stacked run, talkers included; registers equal the flat
    run's, and exact counts the oracle's."""
    packed, rs, lines, res, rpacked, _, jregs_flat, d = corpus
    paths = [str(d / "logs.txt")]
    ck = tmp_path / "ck"
    if native:
        ensure_reference_native()
    jrep = rstream.run_stream_file(
        rpacked, paths, JConfig(batch_size=B, sketch=JSketch(**SKETCH), layout="stacked",
                                checkpoint_every_chunks=1 << 20, checkpoint_dir=str(ck)),
        native=native, topk=TOPK, mesh=make_mesh(jax.devices()[:1]))
    rep, regs = run_stream_file(packed, paths, _cfg(match_impl="scan", layout="stacked"),
                                native=native, topk=TOPK, return_state=True)
    assert _strip(rep) == _strip(jrep)
    for k, v in rckpt.load(str(ck)).arrays.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
        np.testing.assert_array_equal(regs[k], jregs_flat[k], err_msg=f"flat {k}")
    assert _hits(rep) == dict(res.hits)
    assert rep.unused == res.unused_rules([raclparse.parse_asa_config(CFG, "fw1")])


def test_v6_talkers_render_addresses(corpus):
    packed, _, lines, _, rpacked, *_ = corpus
    # one dominant source per family: both surface in the SAME merged
    # per-ACL talker section, each in its own notation
    heavy6 = [
        "Jul 29 07:49:00 fw1 : %ASA-6-106100: access-list A permitted tcp "
        "inside/2001:db8:1::7777(4321) -> outside/2001:db8:1::1(443) "
        "hit-cnt 1 first hit [0x0, 0x0]"
    ] * 400
    heavy4 = [
        "Jul 29 07:49:01 fw1 : %ASA-6-106100: access-list A permitted tcp "
        "inside/10.1.2.3(4321) -> outside/10.0.0.5(443) "
        "hit-cnt 1 first hit [0x0, 0x0]"
    ] * 300
    all_lines = list(lines) + heavy6 + heavy4
    rep = run_stream(packed, iter(all_lines), _cfg(), topk=5)
    talk = rep.talkers.get("fw1 A", [])
    assert any(ip == "2001:db8:1::7777" for ip, _ in talk), talk
    assert any(ip == "10.1.2.3" for ip, _ in talk), talk
    jrep, _ = _reference(rpacked, all_lines)
    full = run_stream(packed, iter(all_lines), _cfg(), topk=TOPK)
    assert _strip(full) == _strip(jrep)


def test_unknown_digest_renders_as_v6_hash(corpus):
    """A v6 talker whose digest is not in the map renders as ``v6#xxxxxxxx``."""
    from ruleset_analysis_tpu_torch.models import pipeline
    from ruleset_analysis_tpu_torch.ops.topk import TopKTracker

    packed, *_ = corpus
    cfg = _cfg()
    state = pipeline.init_state(packed.n_keys, cfg, "cpu")
    tracker = TopKTracker(8)
    gid = packed.acl_gid[("fw1", "A")]
    tracker.offer(gid | pipeline.V6_ACL_TAG, 0xDEADBEEF, 5)
    tracker.offer(gid | pipeline.V6_ACL_TAG, 0x12345678, 7)
    tracker.offer(gid, 0x0A010203, 6)
    src = aclparse.ip6_to_int("2001:db8::1")
    rep = pipeline.finalize(state, packed, cfg, tracker, topk=5,
                            v6_digests={0x12345678: src})
    assert rep.talkers["fw1 A"] == [["2001:db8::1", 7], ["10.1.2.3", 6], ["v6#deadbeef", 5]]


@pytest.mark.parametrize("seed", [2, 8])
def test_native_python_v6_differential(seed):
    """LinePacker vs NativePacker: bit-identical dual-family packs."""
    cfg_text = synth.synth_config(n_acls=3, rules_per_acl=10, seed=seed, v6_fraction=0.4)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    t4 = synth.synth_tuples(packed, 400, seed=seed)
    t6 = synth.synth_tuples6(packed, 300, seed=seed)
    lines = synth.render_syslog(packed, t4, seed=seed) + synth.render_syslog6(
        packed, t6, seed=seed + 1)
    random.Random(seed).shuffle(lines)
    py = pack.LinePacker(packed)
    ref4, ref6 = py.pack_lines2(lines, batch_size=2 * len(lines))
    nat = fastparse.NativePacker(packed)
    got4, got6 = nat.pack_lines2(lines, batch_size=2 * len(lines))
    np.testing.assert_array_equal(ref4, got4)
    np.testing.assert_array_equal(ref6, got6)
    assert (py.parsed, py.skipped) == (nat.parsed, nat.skipped)
    assert int(ref6[:, pack.T6_VALID].sum()) > 0
    # and the reference's packer agrees with both
    rp = rpack.pack_rulesets([raclparse.parse_asa_config(cfg_text, "fw1")])
    want4, want6 = rpack.LinePacker(rp).pack_lines2(lines, batch_size=2 * len(lines))
    np.testing.assert_array_equal(ref4, want4)
    np.testing.assert_array_equal(ref6, want6)


def test_native_python_v6_edge_lines_bit_identical():
    packed = pack.pack_rulesets([aclparse.parse_asa_config(CFG, "fw1")])
    py = pack.LinePacker(packed)
    ref4, ref6 = py.pack_lines2(V6_EDGE_LINES, batch_size=32)
    nat = fastparse.NativePacker(packed)
    got4, got6 = nat.pack_lines2(V6_EDGE_LINES, batch_size=32)
    np.testing.assert_array_equal(ref4, got4)
    np.testing.assert_array_equal(ref6, got6)
    assert (py.parsed, py.skipped) == (nat.parsed, nat.skipped)


def test_native_v6_mt_bit_identical_to_single_thread():
    """The dual-family entry's worker path equals the sequential one,
    including line-atomic batch closes."""
    cfg_text = synth.synth_config(n_acls=3, rules_per_acl=10, seed=9, v6_fraction=0.5,
                                  egress_acls=True)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    t4 = synth.synth_tuples(packed, 1500, seed=9)
    t6 = synth.synth_tuples6(packed, 1200, seed=9)
    lines = synth.render_syslog(packed, t4, seed=9, variety=0.4)
    lines += synth.render_syslog6(packed, t6, seed=10)
    random.Random(9).shuffle(lines)
    data = ("\n".join(lines) + "\n").encode()
    for cap in (4096, 700):  # ample and batch-closing capacities
        p1 = fastparse.NativePacker(packed)
        o1, l1, u1 = p1.pack_chunk(data, cap, final=True, max_lines=cap, n_threads=1)
        r61 = p1.take_v6()
        p4 = fastparse.NativePacker(packed)
        o4, l4, u4 = p4.pack_chunk(data, cap, final=True, max_lines=cap, n_threads=4)
        r64 = p4.take_v6()
        assert (l1, u1) == (l4, u4)
        np.testing.assert_array_equal(o1, o4)
        np.testing.assert_array_equal(np.asarray(r61), np.asarray(r64))
        assert len(r61) > 0 and (p1.parsed, p1.skipped) == (p4.parsed, p4.skipped)


def test_zero_valid_v4_batches_skip_device_step():
    """A v6-only corpus: the Python source yields (None, n_raw) batches,
    which do not step; the native source yields all-invalid v4 batches,
    which do (and take a salt).  Each equals the reference's own path."""
    rs = aclparse.parse_asa_config(CFG, "fw1")
    packed = pack.pack_rulesets([rs])
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(CFG, "fw1")])
    v6_only = mixed_lines(512, seed=11, v6_share=1.0)
    src = _TextSource(packed, iter(v6_only))
    got = list(src.batches(0, 128))
    assert [n for _b, n in got] == [128, 128, 128, 128]
    assert all(b is None for b, _n in got)
    assert src.packer.parsed > 0 and len(src.take_v6()) == src.packer.parsed

    res = roracle.Oracle([raclparse.parse_asa_config(CFG, "fw1")]).consume(list(v6_only))
    cfg = AnalysisConfig(batch_size=128, sketch=SketchConfig(**SKETCH), device="cpu")
    rep = run_stream(packed, iter(v6_only), cfg, topk=TOPK)
    assert _hits(rep) == dict(res.hits)
    assert rep.totals["lines_total"] == 512
    assert rep.totals["chunks"] == -(-res.lines_matched // 128)  # v6 chunks alone
    jrep, _ = _reference(rpacked, v6_only, batch=128)
    assert _strip(rep) == _strip(jrep)


def test_zero_valid_native_batches_step_like_the_reference(tmp_path):
    rs = aclparse.parse_asa_config(CFG, "fw1")
    packed = pack.pack_rulesets([rs])
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(CFG, "fw1")])
    p = tmp_path / "v6.log"
    p.write_text("\n".join(mixed_lines(512, seed=11, v6_share=1.0)) + "\n")
    cfg = AnalysisConfig(batch_size=128, sketch=SketchConfig(**SKETCH), device="cpu")
    rep = run_stream_file(packed, [str(p)], cfg, native=True, topk=TOPK)
    jrep, _ = _reference(rpacked, paths=[str(p)], native=True, batch=128)
    assert _strip(rep) == _strip(jrep)
    v6_chunks = -(-rep.totals["lines_matched"] // 128)
    assert rep.totals["chunks"] == 4 + v6_chunks  # four all-invalid v4 steps


def test_synth_v6_fraction_corpus_end_to_end(tmp_path):
    """``synth --v6-fraction`` -> ``parse-acls`` -> ``run --device cpu``: the
    corpus is the reference's byte for byte, counts equal the oracle's,
    and the report equals the reference's run of the same files."""
    from ruleset_analysis_tpu import cli as rcli
    from ruleset_analysis_tpu_torch import cli

    d, rd = tmp_path / "port", tmp_path / "ref"
    args = ["synth", "--acls", "3", "--rules", "14", "--lines", "1500", "--seed", "33",
            "--v6-fraction", "0.35"]
    assert cli.main([*args, "--out-dir", str(d)]) == 0
    assert rcli.main([*args, "--out-dir", str(rd)]) == 0
    assert (d / "fw1.log").read_bytes() == (rd / "fw1.log").read_bytes()
    assert (d / "fw1.cfg").read_bytes() == (rd / "fw1.cfg").read_bytes()
    assert cli.main(["parse-acls", str(d / "fw1.cfg"), "--out", str(d / "p")]) == 0
    out = d / "rep.json"
    assert cli.main(["run", "--ruleset", str(d / "p"), "--logs", str(d / "fw1.log"),
                     "--device", "cpu", "--json", "--batch-size", str(B), "--topk", "5",
                     "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    rs = raclparse.parse_config_file(str(d / "fw1.cfg"))
    assert rpack.pack_rulesets([rs]).has_v6
    with open(d / "fw1.log", encoding="utf-8") as fh:
        res = roracle.Oracle([rs]).consume(fh)
    hits = {(e["firewall"], e["acl"], e["index"]): e["hits"]
            for e in got["per_rule"] if e["hits"]}
    assert hits == dict(res.hits)
    assert got["totals"]["lines_matched"] == res.lines_matched
    mesh = make_mesh(jax.devices()[:1])
    ensure_reference_native()  # the reference's file run picks its native parser
    jrep = rstream.run_stream_file(rpack.load_packed(str(d / "p")), [str(d / "fw1.log")],
                                   JConfig(batch_size=B), topk=5, mesh=mesh)
    for k in VOLATILE_TOTALS + ("backend",):
        got["totals"].pop(k, None)
    assert got == _strip(jrep)
