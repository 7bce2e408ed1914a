"""The port's ``.rawire`` files against the reference's, and their refusals.

``convert`` output is the reference's format byte for byte (plain v1 and
coalesced v3, native and Python parse), each package reads the other's
files (a v2 file too), and the refusals hold: an incomplete file, a
fingerprint mismatch, mixed plain and weighted files, a
weighted file or ``--coalesce`` with ``--match-impl fused``, and a chunk
whose weights sum to 2^32 or more.  A stacked-layout run over a plain
or weighted file gives the reference's stacked report.  Tolerance 0
everywhere.
"""

import json

import numpy as np
import pytest

from ruleset_analysis_tpu.hostside import pack as rpack
from ruleset_analysis_tpu.hostside import wire as rwire
from ruleset_analysis_tpu_torch import cli
from ruleset_analysis_tpu_torch.config import AnalysisConfig
from ruleset_analysis_tpu_torch.errors import AnalysisError, WireCorrupt
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire
from ruleset_analysis_tpu_torch.hostside.pack import W_META, W_WEIGHT, WIREW_COLS
from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file, run_stream_wire
from tests._torch_refnative import ensure_reference_native

B = 512


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=9, egress_acls=True)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    tuples = synth.synth_flow_tuples(packed, 6000, 400, skew=1.1, seed=9)
    lines = synth.render_syslog(packed, tuples, seed=9, variety=0.3)
    lines[::97] = ["not an ASA line"] * len(lines[::97])
    d = tmp_path_factory.mktemp("wire")
    pack.save_packed(packed, str(d / "fw1"))
    (d / "fw1.log").write_text("\n".join(lines) + "\n")
    return packed, rpack.load_packed(str(d / "fw1")), [str(d / "fw1.log")], d


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_convert_is_byte_identical_to_reference(corpus, coalesce, native):
    packed, rpacked, logs, d = corpus
    if native:
        ensure_reference_native()
    mine, ref = d / f"m-{coalesce}-{native}.rawire", d / f"r-{coalesce}-{native}.rawire"
    stats = wire.convert_logs(packed, logs, str(mine), native=native, coalesce=coalesce,
                              block_rows=1000, batch_size=B)
    rstats = rwire.convert_logs(rpacked, logs, str(ref), native=native, coalesce=coalesce,
                                block_rows=1000, batch_size=B)
    assert mine.read_bytes() == ref.read_bytes()
    assert stats["parser"] == ("native" if native else "python")
    for k in ("rows", "raw_lines", "evals", "skipped", "bytes", "weighted"):
        assert stats[k] == rstats[k], k
    if coalesce:
        assert mine.read_bytes()[:8] == wire.MAGIC_W and stats["rows"] < stats["evals"]
    else:
        assert mine.read_bytes()[:8] == wire.MAGIC


@pytest.mark.parametrize("coalesce", [False, True])
def test_each_package_reads_the_others_files(corpus, coalesce):
    packed, rpacked, logs, d = corpus
    ensure_reference_native()  # the reference's convert picks its native parser
    mine, ref = d / f"xm-{coalesce}.rawire", d / f"xr-{coalesce}.rawire"
    wire.convert_logs(packed, logs, str(mine), coalesce=coalesce, block_rows=700)
    rwire.convert_logs(rpacked, logs, str(ref), coalesce=coalesce, block_rows=700)
    a = wire.WireReader([str(ref)], packed)
    b = rwire.WireReader([str(mine)], rpacked)
    try:
        assert a.weighted == b.weighted == coalesce
        assert (a.n_rows, a.raw_lines, a.n_evals, a.n_skipped) == (
            b.n_rows, b.raw_lines, b.n_evals, b.n_skipped)
        for skip in (0, 333):
            got = list(a.iter_batches(skip, B))
            want = list(b.iter_batches(skip, B))
            assert len(got) == len(want)
            for (g, gn), (w, wn) in zip(got, want):
                assert gn == wn and (g == w).all()
    finally:
        a.close()
        b.close()


def test_zero_copy_blocks_are_read_only_views(corpus):
    packed, _, logs, d = corpus
    path = d / "zc.rawire"
    wire.convert_logs(packed, logs, str(path), block_rows=B)
    r = wire.WireReader([str(path)], packed)
    try:
        blk, n = next(r.iter_batches(0, B))
        assert n == B and not blk.flags.writeable
    finally:
        del blk
        r.close()


def test_incomplete_file_is_refused(corpus):
    packed, _, _, d = corpus
    path = d / "partial.rawire"
    with pytest.raises(RuntimeError):
        with wire.WireWriter(str(path), wire.ruleset_fingerprint(packed), 16) as w:
            w.add(np.zeros((4, 40), dtype=np.uint32), 40, 0)
            raise RuntimeError("convert crashed")
    assert wire.is_wire_file(str(path))
    with pytest.raises(wire.WireFormatError, match="incomplete"):
        wire.WireReader([str(path)], packed)


def test_fingerprint_mismatch_and_truncation_are_refused(corpus):
    packed, _, logs, d = corpus
    path = d / "fp.rawire"
    wire.convert_logs(packed, logs, str(path))
    other = pack.pack_rulesets([aclparse.parse_asa_config(
        synth.synth_config(n_acls=2, rules_per_acl=5, seed=1), "fw1")])
    with pytest.raises(wire.WireFormatError, match="fingerprint mismatch"):
        wire.WireReader([str(path)], other)
    cut = d / "cut.rawire"
    cut.write_bytes(path.read_bytes()[:-16])
    with pytest.raises(wire.WireFormatError, match="truncated"):
        wire.WireReader([str(cut)], packed)
    junk = d / "junk.rawire"
    junk.write_bytes(b"RAWIREv1")
    with pytest.raises(wire.WireFormatError, match="not a wire file"):
        wire.WireReader([str(junk)], packed)


def test_v2_file_is_not_ported(corpus):
    """A v2 file (IPv6 section) is read now: the reference's v2 file with an
    empty v6 section opens with its v4 rows (the name is kept from when
    v2 was refused)."""
    _, rpacked, _, d = corpus
    path = d / "v2.rawire"
    rows = np.zeros((4, 3), dtype=np.uint32)
    rows[W_META] = 1 << 23
    with rwire.WireWriter(str(path), rwire.ruleset_fingerprint(rpacked), 64) as w:
        w.begin6()
        w.add(rows, 3, 0)
    assert path.read_bytes()[:8] == wire.MAGIC6 and wire.is_wire_file(str(path))
    r = wire.WireReader([str(path)])
    assert (r.n_rows, r.n6_rows, r.weighted) == (3, 0, False)
    ((blk, n),) = list(r.iter_batches(0, 64))
    assert n == 3 and (blk[:, :3] == rows).all()
    assert list(r.iter_batches6(0, 64)) == []
    r.close()


def test_mixed_plain_and_weighted_files_are_refused(corpus):
    packed, _, logs, d = corpus
    a, b = d / "mix-a.rawire", d / "mix-b.rawire"
    wire.convert_logs(packed, logs, str(a))
    wire.convert_logs(packed, logs, str(b), coalesce=True)
    with pytest.raises(wire.WireFormatError, match="cannot mix"):
        wire.WireReader([str(a), str(b)], packed)


def test_weighted_input_with_fused_is_refused(corpus, capsys):
    packed, _, logs, d = corpus
    path = d / "wf.rawire"
    wire.convert_logs(packed, logs, str(path), coalesce=True)
    with pytest.raises(AnalysisError, match="match_impl='fused'.*not weight-linear"):
        run_stream_wire(packed, str(path), AnalysisConfig(device="cpu", match_impl="fused"))
    with pytest.raises(ValueError, match="coalesce is incompatible with match_impl='fused'"):
        AnalysisConfig(coalesce="on", device="cpu", match_impl="fused")
    base = ["run", "--ruleset", str(d / "fw1"), "--device", "cpu", "--json", "--match-impl",
            "fused"]
    capsys.readouterr()
    assert cli.main(base + ["--logs", str(path)]) == 2
    assert "--match-impl scan" in capsys.readouterr().err
    assert cli.main(base + ["--logs", *logs, "--coalesce", "on"]) == 2
    assert "not weight-linear" in capsys.readouterr().err
    # mixing text and wire in one list is refused too
    assert cli.main(base + ["--logs", str(path), *logs, "--match-impl", "scan"]) == 2
    assert "cannot mix" in capsys.readouterr().err


def _weighted_file(path, packed, weights, block_rows):
    """A v3 file whose rows are one valid tuple, with the given weights."""
    t = synth.synth_tuples(packed, len(weights), seed=3)
    wire_rows = pack.compact_batch_w(np.ascontiguousarray(t.T))
    wire_rows[W_WEIGHT] = np.asarray(weights, dtype=np.uint32)
    with wire.WireWriter(str(path), wire.ruleset_fingerprint(packed), block_rows,
                         weighted=True) as w:
        w.add(wire_rows, len(weights), 0)


def test_chunk_weight_at_2_pow_32_is_refused(corpus):
    packed, _, _, d = corpus
    path = d / "heavy.rawire"
    weights = [3 << 30, 5, 1 << 31, 7]
    _weighted_file(path, packed, weights, 4)
    cfg = AnalysisConfig(device="cpu", match_impl="scan", batch_size=4)
    with pytest.raises(AnalysisError, match="overflows the per-chunk uint32 count delta"):
        run_stream_wire(packed, str(path), cfg)
    # the same rows over two chunks below the limit run, and a weight at
    # or above 2^31 stays positive: every line is counted
    rep = run_stream_wire(packed, str(path), AnalysisConfig(device="cpu", match_impl="scan",
                                                            batch_size=2))
    assert sum(e["hits"] for e in rep.per_rule) == rep.totals["lines_matched"] == sum(weights)
    assert rep.totals["wire_evals"] == sum(weights) > 1 << 32


def test_stored_invalid_row_is_wire_corrupt(corpus):
    packed, _, logs, d = corpus
    path = d / "bad.rawire"
    wire.convert_logs(packed, logs, str(path))
    r = wire.WireReader([str(path)])
    n_rows = r.n_rows  # one block: the default block holds every row
    r.close()
    raw = bytearray(path.read_bytes())
    # clear the valid bit of the first stored row's meta word
    at = wire.HEADER_BYTES + W_META * 4 * n_rows
    raw[at + 2] &= 0x7F
    path.write_bytes(bytes(raw))
    with pytest.raises(WireCorrupt):
        run_stream_wire(packed, str(path), AnalysisConfig(device="cpu", batch_size=10 ** 5))


def test_wire_run_equals_text_run(corpus):
    packed, _, logs, d = corpus
    path = d / "eq.rawire"
    wire.convert_logs(packed, logs, str(path))
    cfg = AnalysisConfig(batch_size=B, device="cpu")
    a, b = run_stream_file(packed, logs, cfg), run_stream_wire(packed, str(path), cfg)
    assert a.per_rule == b.per_rule and a.unused == b.unused
    for k in ("lines_total", "lines_matched", "lines_skipped"):
        assert a.totals[k] == b.totals[k], k


def test_cli_convert_and_wire_info(corpus, capsys):
    packed, _, logs, d = corpus
    out = d / "cli.rawire"
    assert cli.main(["convert", "--ruleset", str(d / "fw1"), "--logs", *logs,
                     "--out", str(out), "--coalesce", "--block-rows", "1000"]) == 0
    assert "weighted rows" in capsys.readouterr().err
    assert cli.main(["convert", "--ruleset", str(d / "fw1"), "--logs", str(out),
                     "--out", str(d / "again.rawire")]) == 2
    assert "already a wire file" in capsys.readouterr().err
    assert cli.main(["wire-info", str(out), "--ruleset", str(d / "fw1"), "--json"]) == 0
    (info,) = json.loads(capsys.readouterr().out)
    assert info["ok"] and info["weighted"] and info["ruleset_match"]
    assert info["bytes_per_row"] == 4 * WIREW_COLS and info["block_rows"] == 1000
    assert info["evals"] > info["rows"] and info["raw_lines"] == 6000
    bad = d / "bad-info.rawire"
    bad.write_bytes(b"RAWIRE??" + bytes(64))
    assert cli.main(["wire-info", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().out


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_stacked_wire_run_equals_reference(corpus, weighted, depth):
    """``--layout stacked`` over a plain and a weighted (RAWIREv3) file, with
    and without prefetch: every batch is expanded, bucketed by ACL and
    re-packed (weighted for the weighted file, whose rows carry weights).
    The Report equals the reference's stacked run, talkers included
    (reference on a one-device mesh); the per-rule counts equal the flat
    wire run's."""
    jax = pytest.importorskip("jax")
    from ruleset_analysis_tpu.config import AnalysisConfig as JConfig
    from ruleset_analysis_tpu.parallel.mesh import make_mesh
    from ruleset_analysis_tpu.runtime import stream as rstream
    from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS

    packed, rpacked, logs, d = corpus
    path = d / f"stacked-{weighted}.rawire"
    if not path.exists():
        wire.convert_logs(packed, logs, str(path), coalesce=weighted, batch_size=B,
                          block_rows=B)
    kw = dict(batch_size=B, prefetch_depth=depth, layout="stacked")
    rep = run_stream_wire(packed, str(path), AnalysisConfig(device="cpu", match_impl="scan",
                                                            **kw), topk=600)
    jrep = rstream.run_stream_wire(rpacked, str(path), JConfig(**kw), topk=600,
                                   mesh=make_mesh(jax.devices()[:1]))

    def strip(r):
        o = json.loads(r.to_json())
        for k in VOLATILE_TOTALS + ("backend",):
            o["totals"].pop(k, None)
        return o

    assert strip(rep) == strip(jrep)
    flat = run_stream_wire(packed, str(path), AnalysisConfig(device="cpu", match_impl="scan",
                                                             batch_size=B), topk=600)
    assert rep.per_rule == flat.per_rule and rep.unused == flat.unused
    assert rep.totals["wire_rows"] == flat.totals["wire_rows"] > 0
