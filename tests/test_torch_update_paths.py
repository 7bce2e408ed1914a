"""Every register-update flag of the reference, end to end on the port.

Mirrors the run-level half of tests/test_sorted_update.py on the port,
which accepts the reference's ``update_impl`` and ``counts_impl`` and
runs its one register tail for each: the identity matrix of
``update_impl`` x ``counts_impl`` (every pairing the reference accepts,
with the port's ``fused`` for its ``pallas_fused``) over every input kind — Python and native text, plain
and weighted wire, ``coalesce="on"``, dual-stack text and wire v2 —
each cell's registers and Report held to the reference's run of the
same input.  The reference's own tests pin its paths to each other, and
here it also runs under the same flags as the port on the text inputs.
Then deferred selection (``topk_every``), the checkpoint fingerprint, a
kill under one impl resumed under the other, and the refusals.  The
reference runs on a one-device mesh; ``topk`` past the tracker's
capacity puts every tracked talker in the Report.  Tolerance 0.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.parallel.mesh import make_mesh  # noqa: E402
from ruleset_analysis_tpu.runtime import checkpoint as rckpt  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import (  # noqa: E402
    run_stream, run_stream_file, run_stream_wire,
)

from tests._torch_refnative import ensure_reference_native  # noqa: E402
from tests.test_stream6 import CFG as CFG6, mixed_lines  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SKETCH = dict(cms_width=1 << 10, cms_depth=2, hll_p=6)
B = 256
TOPK = 600  # past 2 x topk_capacity: the report lists every tracked talker

#: name -> (port match_impl, update_impl, counts_impl): every pairing the
#: reference accepts ("fused" plays pallas_fused, which takes scatter only)
IMPLS = {
    "fused": ("fused", "scatter", "scatter"),
    "scan": ("scan", "scatter", "scatter"),
    "scan-matmul": ("scan", "scatter", "matmul"),
    "scan-reduce": ("scan", "scatter", "reduce"),
    "sorted": ("scan", "sorted", "scatter"),
    "sorted-matmul": ("scan", "sorted", "matmul"),
    "sorted-reduce": ("scan", "sorted", "reduce"),
}
INPUTS = ("text", "native", "wire", "wirew", "coalesce", "text6", "wire6")


def _cfg(impl="fused", every=1, **kw):
    match, update, counts = IMPLS[impl]
    kw.setdefault("prefetch_depth", 0)
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(topk_every=every, **SKETCH),
                          match_impl=match, update_impl=update, counts_impl=counts,
                          device="cpu", **kw)


def _jcfg(ck, update="scatter", counts="scatter", every=1, **kw):
    return JConfig(batch_size=B, sketch=JSketch(topk_every=every, **SKETCH),
                   update_impl=update, counts_impl=counts, checkpoint_every_chunks=1 << 20,
                   checkpoint_dir=str(ck), **kw)


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json())
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A v4 ruleset with Zipf flows (coalescing compacts them) and a
    dual-stack ruleset with a mixed corpus, as text and wire files."""
    d = tmp_path_factory.mktemp("update_paths")
    text = synth.synth_config(n_acls=3, rules_per_acl=8, seed=7)
    (d / "fw1.cfg").write_text(text)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    pack.save_packed(packed, str(d / "fw1"))
    tuples = synth.synth_flow_tuples(packed, 2600, 200, skew=1.1, seed=7)
    lines = synth.render_syslog(packed, tuples, seed=7)
    log = d / "fw1.log"
    log.write_text("\n".join(lines) + "\n")
    for weighted in (False, True):
        wire.convert_logs(packed, [str(log)], str(d / f"w{int(weighted)}.rawire"),
                          coalesce=weighted, batch_size=B, block_rows=B)
    packed6 = pack.pack_rulesets([aclparse.parse_asa_config(CFG6, "fw1")])
    pack.save_packed(packed6, str(d / "fw6"))
    lines6 = mixed_lines(2400, seed=17)
    log6 = d / "fw6.log"
    log6.write_text("\n".join(lines6) + "\n")
    wire.convert_logs(packed6, [str(log6)], str(d / "w6.rawire"), batch_size=B)
    return {
        "d": d, "packed": packed, "rpacked": rpack.load_packed(str(d / "fw1")),
        "packed6": packed6, "rpacked6": rpack.load_packed(str(d / "fw6")),
        "lines": lines, "lines6": lines6,
    }


def _paths(c, kind):
    d = c["d"]
    return {"native": [str(d / "fw1.log")], "wire": [str(d / "w0.rawire")],
            "wirew": [str(d / "w1.rawire")], "wire6": [str(d / "w6.rawire")]}.get(kind)


def port_run(c, kind, cfg, max_chunks=None):
    six = kind.endswith("6")
    packed = c["packed6"] if six else c["packed"]
    kw = dict(topk=TOPK, return_state=True, max_chunks=max_chunks)
    if kind in ("text", "coalesce", "text6"):
        return run_stream(packed, iter(c["lines6" if six else "lines"]), cfg, **kw)
    if kind == "native":
        return run_stream_file(packed, _paths(c, kind), cfg, native=True, **kw)
    return run_stream_wire(packed, _paths(c, kind), cfg, **kw)


def ref_run(c, kind, jcfg, max_chunks=None):
    """The reference's report and its final registers (from its snapshot)."""
    six = kind.endswith("6")
    rpacked = c["rpacked6"] if six else c["rpacked"]
    kw = dict(topk=TOPK, mesh=make_mesh(jax.devices()[:1]), max_chunks=max_chunks)
    if kind in ("text", "coalesce", "text6"):
        rep = rstream.run_stream(rpacked, iter(c["lines6" if six else "lines"]), jcfg, **kw)
    elif kind == "native":
        ensure_reference_native()
        rep = rstream.run_stream_file(rpacked, _paths(c, kind), jcfg, native=True, **kw)
    else:
        rep = rstream.run_stream_wire(rpacked, _paths(c, kind), jcfg, **kw)
    return rep, rckpt.load(jcfg.checkpoint_dir).arrays


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """The reference's default-flag run of each input kind, made once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            ck = tmp_path_factory.mktemp(f"ref-{kind}")
            extra = {"coalesce": "on"} if kind == "coalesce" else {}
            cache[kind] = ref_run(corpus, kind, _jcfg(ck, **extra))
        return cache[kind]

    return get


def _assert_equal(got, want):
    (rep, regs), (jrep, jregs) = got, want
    for k, v in jregs.items():
        np.testing.assert_array_equal(regs[k], v, err_msg=k)
    assert _strip(rep) == _strip(jrep)


def _refused(kind, impl):
    match, _, counts = IMPLS[impl]
    weighted = kind in ("wirew", "coalesce")
    return (weighted and match == "fused") or (kind == "wirew" and counts == "matmul")


#: the accepted cells; the refused ones are test_config_refusals' and
#: test_weighted_wire_with_matmul_is_refused's
MATRIX = [(kind, impl) for kind in INPUTS for impl in IMPLS if not _refused(kind, impl)]


@pytest.mark.parametrize("kind,impl", MATRIX)
def test_identity_matrix(corpus, reference, kind, impl):
    """Registers, talkers and Report of every accepted (input, impl) cell
    equal the reference's run of that input."""
    extra = {"coalesce": "on"} if kind == "coalesce" else {}
    got = port_run(corpus, kind, _cfg(impl, **extra))
    _assert_equal(got, reference(kind))
    if kind == "wirew":
        assert got[0].totals["wire_weighted"] is True


@pytest.mark.parametrize("kind,impl", [
    *(("text", impl) for impl in ("scan-matmul", "scan-reduce", "sorted", "sorted-matmul",
                                  "sorted-reduce")),
    ("text6", "sorted"), ("text6", "scan-reduce"),
])
def test_same_flags_as_the_reference(corpus, tmp_path, kind, impl):
    """The reference under the port's flags gives the port's registers and
    Report (the v4 and the v6 step programs)."""
    _, update, counts = IMPLS[impl]
    got = port_run(corpus, kind, _cfg(impl))
    _assert_equal(got, ref_run(corpus, kind, _jcfg(tmp_path / "ck", update, counts)))


@pytest.mark.parametrize("impl", ["scan", "sorted"])
@pytest.mark.parametrize("kind", ["wire", "text6"])
def test_deferred_selection(corpus, reference, tmp_path, kind, impl):
    """topk_every=3 under both update impls: the reference's registers and
    Report under the same cadence; per-rule counts and unused rules equal
    the every-chunk run; talkers still surface."""
    _, update, _ = IMPLS[impl]
    got = port_run(corpus, kind, _cfg(impl, every=3))
    _assert_equal(got, ref_run(corpus, kind, _jcfg(tmp_path / "ck", update, every=3)))
    base = _strip(reference(kind)[0])
    mine = _strip(got[0])
    assert mine["per_rule"] == base["per_rule"] and mine["unused"] == base["unused"]
    assert got[0].talkers, "deferred selection must still surface talkers"
    assert got[0].totals["chunks"] > 3


def test_deferred_selection_equal_across_impls(corpus):
    reps = [port_run(corpus, "wire", _cfg(impl, every=3))[0] for impl in ("scan", "sorted")]
    assert _strip(reps[0]) == _strip(reps[1])


def test_fingerprint_follows_topk_every_not_the_impls(corpus):
    packed, rpacked = corpus["packed"], corpus["rpacked"]
    base = ckpt.fingerprint(packed, _cfg("scan"))
    assert ckpt.fingerprint(packed, _cfg("scan", every=2)) != base
    for impl in ("fused", "scan-matmul", "sorted", "sorted-reduce"):
        assert ckpt.fingerprint(packed, _cfg(impl)) == base
    for every in (1, 2):
        for update in ("scatter", "sorted"):
            mine = ckpt.fingerprint(packed, _cfg("sorted" if update == "sorted" else "scan",
                                                 every=every))
            ref = rckpt.fingerprint(
                rpacked, JConfig(batch_size=B, sketch=JSketch(topk_every=every, **SKETCH),
                                 update_impl=update), 1, 0)
            assert mine == ref


@pytest.mark.parametrize("first,then", [("scan", "sorted"), ("sorted-reduce", "fused")])
def test_resume_across_impls(corpus, reference, tmp_path, first, then):
    """A run killed under one impl resumes under another to the
    uninterrupted run's registers, talkers and Report."""
    ck = tmp_path / "ck"
    crashed, _ = port_run(corpus, "text", _cfg(first, checkpoint_every_chunks=2,
                                               checkpoint_dir=str(ck)), max_chunks=5)
    snap = ckpt.load(str(ck))
    assert snap is not None and 0 < snap.n_chunks < reference("text")[0].totals["chunks"]
    got = port_run(corpus, "text", _cfg(then, checkpoint_every_chunks=2,
                                        checkpoint_dir=str(ck), resume=True))
    _assert_equal(got, reference("text"))


# --- refusals -----------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(update_impl="sorted", match_impl="fused"), "match_impl='fused'"),
    (dict(counts_impl="matmul", match_impl="fused"), "computes counts in-kernel"),
    (dict(counts_impl="reduce", match_impl="fused"), "computes counts in-kernel"),
    (dict(update_impl="bogus", match_impl="scan"), "update_impl"),
    (dict(counts_impl="bogus", match_impl="scan"), "counts_impl"),
    (dict(counts_impl="matmul", match_impl="scan", coalesce="on", batch_size=1 << 24),
     "matmul"),
])
def test_config_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        AnalysisConfig(**kw)


def test_config_accepts_what_the_reference_accepts():
    AnalysisConfig(update_impl="sorted", match_impl="scan", coalesce="on")
    AnalysisConfig(update_impl="sorted", match_impl="scan", counts_impl="reduce")
    # matmul with coalescing is exact below the 2^24 guard, as in the reference
    AnalysisConfig(counts_impl="matmul", match_impl="scan", coalesce="on",
                   batch_size=(1 << 24) - 1)
    AnalysisConfig(sketch=SketchConfig(topk_every=4096))
    with pytest.raises(ValueError):
        SketchConfig(topk_every=0)
    with pytest.raises(ValueError):
        SketchConfig(topk_every=1 << 13)


@pytest.mark.parametrize("impl", ["scan-matmul", "sorted-matmul"])
def test_weighted_wire_with_matmul_is_refused(corpus, impl):
    with pytest.raises(AnalysisError, match="matmul"):
        port_run(corpus, "wirew", _cfg(impl))


def _run_args(c, *extra):
    d = c["d"]
    return ["run", "--ruleset", str(d / "fw1"), "--logs", str(d / "fw1.log"),
            "--batch-size", str(B), "--cms-width", str(SKETCH["cms_width"]), "--cms-depth",
            str(SKETCH["cms_depth"]), "--hll-p", str(SKETCH["hll_p"]), *extra]


@pytest.mark.parametrize("flag", [["--update-impl", "sorted"], ["--counts-impl", "reduce"],
                                  ["--topk-every", "4"]])
def test_cli_oracle_refuses_each_flag(corpus, capsys, flag):
    rc = cli.main(_run_args(corpus, "--backend", "oracle", "--acl-configs",
                            str(corpus["d"] / "fw1.cfg"), *flag))
    assert rc == 2
    assert flag[0] in capsys.readouterr().err


@pytest.mark.parametrize("flags,match", [
    (["--update-impl", "sorted"], "--match-impl scan"),
    (["--counts-impl", "matmul"], "in-kernel"),
])
def test_cli_refuses_the_fused_pairings(corpus, capsys, flags, match):
    assert cli.main(_run_args(corpus, "--device", "cpu", "--match-impl", "fused", *flags)) == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--update-impl", "sorted", "--match-impl", "scan"],
    ["--counts-impl", "reduce", "--match-impl", "scan"],
    ["--counts-impl", "matmul", "--update-impl", "sorted", "--match-impl", "scan"],
])
def test_cli_update_paths_give_the_default_report(corpus, tmp_path, flags):
    outs = []
    for i, extra in enumerate(([], flags)):
        out = tmp_path / f"r{i}.json"
        assert cli.main(_run_args(corpus, "--device", "cpu", "--json", "--out", str(out),
                                  *extra)) == 0
        obj = json.loads(out.read_text())
        for k in VOLATILE_TOTALS:
            obj["totals"].pop(k, None)
        outs.append(obj)
    assert outs[0] == outs[1]
