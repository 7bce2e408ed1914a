"""Wire format v2 in the port: the IPv6 section of ``.rawire`` files.

Mirrors tests/test_wire6.py on the port.  A dual-stack ruleset converts
to v2 (v3 when coalesced) with the v6 rows after every v4 block; a
pure-v4 ruleset still writes v1.  The port's converter writes the
reference's bytes, each package reads and runs what the other wrote,
and a wire run gives the text run's report.  A truncated v6 section is
refused with a typed error; a stored v6 row with its valid bit clear is
counted as skipped, as the reference counts it.  A stacked-layout run
over a v2 file (its v4 rows bucketed by ACL, its v6 section on the flat
side path) gives the reference's stacked report.  Resume across the
v4/v6 phase boundary is in ``tests/test_torch_resume6.py``.
"""

import json
import os
import random
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import oracle as roracle  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.hostside import wire as rwire  # noqa: E402
from ruleset_analysis_tpu.parallel.mesh import make_mesh  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream, run_stream_wire  # noqa: E402

from tests._torch_refnative import ensure_reference_native  # noqa: E402
from tests.test_stream6 import CFG, mixed_lines  # noqa: E402


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


def _cfg(**kw):
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu", **kw)


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json())
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


def _hits(rep) -> dict:
    return {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep.per_rule if e["hits"]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    td = tmp_path_factory.mktemp("wire6")
    packed = pack.pack_rulesets([aclparse.parse_asa_config(CFG, "fw1")])
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(CFG, "fw1")])
    lines = mixed_lines(2000, seed=11)
    log = td / "logs.txt"
    log.write_text("\n".join(lines) + "\n", encoding="utf-8")
    res = roracle.Oracle([raclparse.parse_asa_config(CFG, "fw1")]).consume(list(lines))
    out = str(td / "logs.rawire")
    stats = wire.convert_logs(packed, [str(log)], out, batch_size=B)
    return td, packed, rpacked, lines, str(log), res, out, stats


def test_convert_writes_v2_and_counts(corpus):
    _, packed, _, _, _, res, out, stats = corpus
    assert stats["rows"] > 0 and stats["rows6"] > 0
    assert stats["rows"] + stats["rows6"] == stats["evals"] == res.lines_matched
    with open(out, "rb") as f:
        assert f.read(8) == wire.MAGIC6
    r = wire.WireReader([out], packed)
    assert (r.n_rows, r.n6_rows) == (stats["rows"], stats["rows6"])
    got = sum(n for _, n in r.iter_batches6(0, 100))
    assert got == stats["rows6"]
    r.close()


def test_all_v4_corpus_still_writes_v1(tmp_path):
    cfg_text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=3)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    t = synth.synth_tuples(packed, 300, seed=3)
    log = tmp_path / "v4.txt"
    log.write_text("\n".join(synth.render_syslog(packed, t, seed=3)) + "\n")
    out = str(tmp_path / "v4.rawire")
    stats = wire.convert_logs(packed, [str(log)], out)
    assert stats["rows6"] == 0
    with open(out, "rb") as f:
        assert f.read(8) == wire.MAGIC


@pytest.mark.parametrize("depth", [0, 2])
def test_wire_run_equals_text_run(corpus, depth):
    _, packed, rpacked, lines, _, res, out, stats = corpus
    rep_text = run_stream(packed, iter(lines), _cfg(), topk=5)
    rep_wire = run_stream_wire(packed, out, _cfg(prefetch_depth=depth), topk=5)
    assert _hits(rep_wire) == _hits(rep_text) == dict(res.hits)
    assert rep_wire.unused == rep_text.unused
    assert rep_wire.totals["lines_total"] == len(lines)
    assert rep_wire.totals["wire_rows"] == stats["rows"] + stats["rows6"]
    # v6 talkers render real addresses from the wire digest map too
    talk = [ip for ip, _ in rep_wire.talkers.get("fw1 A", [])]
    assert any(":" in ip for ip in talk) and not any(ip.startswith("v6#") for ip in talk)
    jrep = rstream.run_stream_wire(rpacked, out, JConfig(batch_size=B, sketch=JSketch(**SKETCH)),
                                   topk=5, mesh=make_mesh(jax.devices()[:1]))
    assert _strip(rep_wire) == _strip(jrep)


@pytest.mark.parametrize("depth", [0, 2])
def test_stacked_wire_run_equals_reference(corpus, depth):
    """``--layout stacked`` over the v2 file (the reference's
    ``test_stacked_wire_v6_matches_flat``): the report equals the
    reference's stacked run, talkers included, and its counts the flat
    run's and the oracle's."""
    _, packed, rpacked, lines, _, res, out, _ = corpus
    kw = dict(layout="stacked", prefetch_depth=depth)
    rep = run_stream_wire(packed, out, _cfg(match_impl="scan", **kw), topk=600)
    jrep = rstream.run_stream_wire(rpacked, out, JConfig(batch_size=B, sketch=JSketch(**SKETCH),
                                                         **kw),
                                   topk=600, mesh=make_mesh(jax.devices()[:1]))
    assert _strip(rep) == _strip(jrep)
    flat = run_stream_wire(packed, out, _cfg(), topk=600)
    assert _hits(rep) == _hits(flat) == dict(res.hits)
    assert rep.unused == flat.unused


def test_truncated_v6_section_refused(corpus, tmp_path):
    _, packed, _, _, _, _, out, _ = corpus
    cut = tmp_path / "t.rawire"
    blob = open(out, "rb").read()
    cut.write_bytes(blob[:-17])  # cut into the v6 section
    with pytest.raises(wire.WireFormatError, match="truncated"):
        wire.WireReader([str(cut)], packed)


def _clear_first_v6_valid_bit(src: str, dst) -> None:
    """Copy a v2/v3 wire file with the valid bit of its first stored v6 row cleared."""
    blob = bytearray(open(src, "rb").read())
    (magic, block_rows, _, n_rows, n6_rows, *_) = struct.unpack(
        wire._HEADER6_FMT, blob[:wire.HEADER6_BYTES])
    weighted = magic == wire.MAGIC_W
    v6_at = wire.HEADER6_BYTES + n_rows * (wire.ROWW_BYTES if weighted else wire.ROW_BYTES)
    # the first v6 block is column-major [cols6, r]: row W6_META holds the meta words
    meta_at = v6_at + pack.W6_META * min(block_rows, n6_rows) * 4
    word = int.from_bytes(blob[meta_at:meta_at + 4], "little")
    assert word & (1 << 23)
    blob[meta_at:meta_at + 4] = (word & ~(1 << 23)).to_bytes(4, "little")
    dst.write_bytes(bytes(blob))


@pytest.mark.parametrize("coalesce", [False, True])
def test_damaged_v6_row_skipped_as_the_reference_does(corpus, tmp_path, coalesce):
    """A stored v6 row with its valid bit clear (block damage) counts as
    skipped and the run goes on, in the port as in the reference: plain v2
    and weighted v3 files give the reference's report and registers."""
    _, packed, rpacked, _, log, _, _, _ = corpus
    good = str(tmp_path / "good.rawire")
    wire.convert_logs(packed, [log], good, batch_size=B, coalesce=coalesce)
    bad = tmp_path / "bad.rawire"
    _clear_first_v6_valid_bit(good, bad)
    impl = "scan" if coalesce else "fused"
    rep, regs = run_stream_wire(packed, str(bad), _cfg(match_impl=impl), topk=600,
                                return_state=True)
    ck = tmp_path / "ck"
    jcfg = JConfig(batch_size=B, sketch=JSketch(**SKETCH), checkpoint_every_chunks=1 << 20,
                   checkpoint_dir=str(ck))
    jrep = rstream.run_stream_wire(rpacked, str(bad), jcfg, topk=600,
                                   mesh=make_mesh(jax.devices()[:1]))
    assert _strip(rep) == _strip(jrep)
    for k, v in rckpt.load(str(ck)).arrays.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    clean = run_stream_wire(packed, good, _cfg(match_impl=impl), topk=600)
    assert rep.totals["lines_skipped"] == clean.totals["lines_skipped"] + 1
    if not coalesce:  # a weighted row's valid plane is its weight, in both packages
        assert rep.totals["lines_matched"] == clean.totals["lines_matched"] - 1


def test_v2_corruption_fuzz_refuses_loudly_never_crashes(corpus, tmp_path):
    """Byte flips, truncations and extensions of a v2 file: the reader
    refuses with WireFormatError or reads rows — it never raises raw."""
    _, packed, _, _, _, _, out, _ = corpus
    blob = open(out, "rb").read()
    rng = random.Random(3)
    crashes = []
    p = str(tmp_path / "m.rawire")
    for _ in range(150):
        b = bytearray(blob)
        k = rng.randrange(4)
        if k == 0:
            pos = rng.randrange(len(b))
            b[pos] ^= 1 << rng.randrange(8)
        elif k == 1:
            b = b[: rng.randrange(len(b))]
        elif k == 2:
            b += bytes(rng.randrange(1, 64))
        else:
            pos = rng.randrange(len(b))
            b[pos:pos + 8] = rng.randbytes(8)
        with open(p, "wb") as f:
            f.write(bytes(b))
        try:
            r = wire.WireReader([p], packed)
            for _batch, _n in r.iter_batches(0, B):
                pass
            for _batch, _n in r.iter_batches6(0, B):
                pass
            r.close()
        except wire.WireFormatError:
            pass
        except Exception as e:  # noqa: BLE001 - the point of the fuzz
            crashes.append((type(e).__name__, str(e)[:120]))
    assert not crashes, crashes[:3]


def test_compact_expand6_roundtrip():
    rng = np.random.default_rng(4)
    b = np.zeros((pack.TUPLE6_COLS, 128), dtype=np.uint32)
    for i in (*range(pack.T6_SRC, pack.T6_SRC + 4), *range(pack.T6_DST, pack.T6_DST + 4)):
        b[i] = rng.integers(0, 1 << 32, 128, dtype=np.uint32)
    b[pack.T6_ACL] = rng.integers(0, 1 << 23, 128, dtype=np.uint32)
    b[pack.T6_PROTO] = rng.integers(0, 256, 128, dtype=np.uint32)
    b[pack.T6_SPORT] = rng.integers(0, 1 << 16, 128, dtype=np.uint32)
    b[pack.T6_DPORT] = rng.integers(0, 1 << 16, 128, dtype=np.uint32)
    b[pack.T6_VALID] = rng.integers(0, 2, 128, dtype=np.uint32)
    w = pack.compact_batch6(b)
    np.testing.assert_array_equal(w, rpack.compact_batch6(b))
    np.testing.assert_array_equal(pack.expand_batch6(w), b)
    np.testing.assert_array_equal(pack.expand_batch6(w), rpack.expand_batch6(w))


def test_wire_fingerprint_covers_v6_rules(corpus):
    """A ruleset differing only in v6 content refuses the wire file."""
    _, packed, rpacked, _, _, _, out, _ = corpus
    assert wire.ruleset_fingerprint(packed) == rwire.ruleset_fingerprint(rpacked)
    packed2 = pack.pack_rulesets([aclparse.parse_asa_config(
        CFG.replace("host 2001:db8::bad", "host 2001:db8::bae"), "fw1")])
    np.testing.assert_array_equal(packed2.rules, packed.rules)
    with pytest.raises(wire.WireFormatError, match="different ruleset"):
        wire.WireReader([out], packed2)


@pytest.mark.parametrize("coalesce", [False, True])
def test_convert_byte_identical_and_read_by_both_packages(corpus, tmp_path, coalesce):
    """Port and reference converts (Python and native parse) write the same
    bytes; the reference runs the port's file and the port runs the
    reference's, with the same report."""
    _, packed, rpacked, _, log, res, _, _ = corpus
    outs = {}
    ensure_reference_native()
    for name, fn, pk, native in (("port-py", wire.convert_logs, packed, False),
                                 ("port-native", wire.convert_logs, packed, True),
                                 ("ref-py", rwire.convert_logs, rpacked, False),
                                 ("ref-native", rwire.convert_logs, rpacked, True)):
        path = str(tmp_path / f"{name}.rawire")
        fn(pk, [log], path, native=native, batch_size=B, block_rows=B, coalesce=coalesce)
        outs[name] = path
    blobs = {k: open(v, "rb").read() for k, v in outs.items()}
    assert blobs["port-py"] == blobs["ref-py"] == blobs["port-native"] == blobs["ref-native"]
    assert blobs["ref-py"][:8] == (rwire.MAGIC_W if coalesce else rwire.MAGIC6)
    assert not os.path.exists(outs["port-py"] + ".spill6")
    impl = "scan" if coalesce else "fused"
    rep = run_stream_wire(packed, outs["ref-py"], _cfg(match_impl=impl), topk=5)
    jrep = rstream.run_stream_wire(rpacked, outs["port-py"],
                                   JConfig(batch_size=B, sketch=JSketch(**SKETCH)),
                                   topk=5, mesh=make_mesh(jax.devices()[:1]))
    assert _strip(rep) == _strip(jrep)
    assert _hits(rep) == dict(res.hits)
    assert rep.totals.get("wire_weighted", False) == coalesce


def test_cli_wire_info_shows_the_v6_split(corpus, capsys):
    from ruleset_analysis_tpu_torch import cli

    td, packed, _, _, _, _, out, stats = corpus
    pack.save_packed(packed, str(td / "p"))
    assert cli.main(["wire-info", out, "--ruleset", str(td / "p"), "--json"]) == 0
    (row,) = json.loads(capsys.readouterr().out)
    assert (row["rows"], row["rows6"]) == (stats["rows"], stats["rows6"])
    assert cli.main(["wire-info", out]) == 0
    assert f"+ {stats['rows6']} v6 rows" in capsys.readouterr().out
