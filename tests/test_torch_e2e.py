"""The port's streaming loop end to end, against the reference and the oracle.

The port's ``run_stream`` and the reference's ``run_stream`` (on a
one-device mesh, so its chunking and candidates are the single-device
ones) read the same lines; their Report JSON must be identical apart
from ``VOLATILE_TOTALS`` and ``totals.backend``, for both match impls.
The checks of tests/test_e2e.py are repeated on the port: exact counts
and the unused set equal the oracle's, and the report does not depend
on the batch size.  ``cli run --device cpu --json`` gives the same
report.
"""

import json

import pytest

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse, oracle, pack, synth  # noqa: E402
from ruleset_analysis_tpu.parallel.mesh import make_mesh  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu.runtime.stream import run_stream as jrun_stream  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import pack as tpack  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.stream import run_stream  # noqa: E402

SKETCH = dict(cms_width=1 << 12, cms_depth=4, hll_p=8)
B = 512


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json())
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    cfg_text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=21, egress_acls=True)
    rs = aclparse.parse_asa_config(cfg_text, "fw1")
    packed = pack.pack_rulesets([rs])
    tuples = synth.synth_tuples(packed, 3000, seed=21)
    # variety: connection lines bound to both an in and an out ACL emit
    # two evaluations and close batches early; noise lines are skipped
    lines = synth.render_syslog(packed, tuples, seed=21, variety=0.3)
    lines += ["Jul 29 07:48:01 noise : not an ASA message"] * 7
    res = oracle.Oracle([rs]).consume(list(lines))
    d = tmp_path_factory.mktemp("e2e")
    (d / "fw1.cfg").write_text(cfg_text)
    (d / "fw1.log").write_text("\n".join(lines) + "\n")
    pack.save_packed(packed, str(d / "fw1"))
    jrep = jrun_stream(
        packed, iter(lines), JConfig(batch_size=B, sketch=JSketch(**SKETCH)),
        topk=5, mesh=make_mesh(jax.devices()[:1]),
    )
    return tpack.load_packed(str(d / "fw1")), rs, lines, res, jrep, d


def _port(packed, lines, impl="fused", batch_size=B, **kw):
    cfg = AnalysisConfig(batch_size=batch_size, sketch=SketchConfig(**SKETCH),
                         match_impl=impl, device="cpu", **kw)
    return run_stream(packed, iter(lines), cfg, topk=5)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_report_identical_to_reference(corpus, impl):
    packed, _, lines, _, jrep, _ = corpus
    rep = _port(packed, lines, impl)
    assert rep.totals["backend"] == "torch-cpu"
    assert _strip(rep) == _strip(jrep)
    assert rep.totals["chunks"] == jrep.totals["chunks"]


def test_skipped_stretches_and_v6_lines_match_reference(corpus):
    """Batches of only unparseable or IPv6 lines (v6 against a v4 ruleset
    is a counted skip) close as zero-valid batches: they do not step and
    do not advance the chunk counter (the salt)."""
    packed, _, lines, _, _, _ = corpus
    v6 = (
        "Jul 29 07:48:01 fw1 : %ASA-6-106100: access-list ACL0 permitted tcp "
        "inside/2001:db8::{i:x}(1234) -> outside/2001:db8::2(80) hit-cnt 1 first hit [0x0, 0x0]"
    )
    mixed = (
        ["Jul 29 07:48:01 noise : not an ASA message"] * 300
        + [v6.format(i=i + 1) for i in range(300)]
        + list(lines[:900])
        + [v6.format(i=i + 1) for i in range(40)]
    )
    jrep = jrun_stream(
        pack.load_packed(str(corpus[5] / "fw1")), iter(mixed),
        JConfig(batch_size=256, sketch=JSketch(**SKETCH)),
        topk=5, mesh=make_mesh(jax.devices()[:1]),
    )
    rep = _port(packed, mixed, batch_size=256)
    assert _strip(rep) == _strip(jrep)
    assert rep.totals["lines_skipped"] >= 640
    assert rep.totals["chunks"] < -(-len(mixed) // 256)  # zero-valid batches did not step


def test_exact_counts_and_unused_match_oracle(corpus):
    packed, rs, lines, res, _, _ = corpus
    rep = _port(packed, lines)
    got = {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep.per_rule if e["hits"] > 0}
    assert got == dict(res.hits)
    assert rep.totals["lines_matched"] == res.lines_matched
    assert rep.totals["lines_skipped"] == res.lines_skipped
    assert rep.unused == res.unused_rules([rs])


def test_batch_size_invariance(corpus):
    packed, _, lines, _, _, _ = corpus
    a, b = _port(packed, lines, batch_size=256), _port(packed, lines, batch_size=1000)
    assert a.per_rule == b.per_rule
    assert a.unused == b.unused


def test_sketch_only_counts_keep_the_unused_set(corpus):
    packed, rs, lines, res, _, _ = corpus
    rep = _port(packed, lines, exact_counts=False)
    exact_unused = res.unused_rules([rs])
    assert set(rep.unused) <= set(exact_unused)
    assert oracle.unused_rule_recall(exact_unused, rep.unused) >= 0.99


def test_cli_run_gives_the_same_report(corpus, capsys):
    from ruleset_analysis_tpu_torch import cli

    _, _, _, _, jrep, d = corpus
    out = d / "rep.json"
    rc = cli.main([
        "run", "--ruleset", str(d / "fw1"), "--logs", str(d / "fw1.log"),
        "--device", "cpu", "--json", "--topk", "5", "--batch-size", str(B),
        "--out", str(out),
    ])
    assert rc == 0
    # the CLI runs the default sketch geometry: compare to a reference
    # run of that geometry
    packed, _, lines, _, _, _ = corpus
    jdef = jrun_stream(
        pack.load_packed(str(d / "fw1")), iter(lines), JConfig(batch_size=B),
        topk=5, mesh=make_mesh(jax.devices()[:1]),
    )
    got = json.loads(out.read_text())
    for k in VOLATILE_TOTALS + ("backend",):
        got["totals"].pop(k, None)
    assert got == _strip(jdef)


def test_parse_acls_output_loads_in_both_packages(corpus, tmp_path):
    from ruleset_analysis_tpu_torch import cli

    _, _, _, _, _, d = corpus
    assert cli.main(["parse-acls", str(d / "fw1.cfg"), "--out", str(tmp_path / "p")]) == 0
    mine, ref = tpack.load_packed(str(tmp_path / "p")), pack.load_packed(str(d / "fw1"))
    assert (mine.rules == ref.rules).all() and mine.key_meta == [
        tpack.KeyMeta(**vars(m)) for m in ref.key_meta
    ]
