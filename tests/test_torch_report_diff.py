"""`diff-reports` and the report-diff functions of the port against the
reference's.

Both CLIs run `run --json` over the same corpora (a 2 ACL x 8 rule
ruleset and its churned copy, a few hundred synthetic lines each, parsed
in Python: the native parsers give the same reports and are the parse
tests' business), with and without `--static-analysis`; then both CLIs' `diff-reports` over
either package's reports, in text and `--json`, at the default `--top`,
0 and 3, must print the same bytes.  Exit codes and the last stderr
line agree for unreadable reports, `--top -1` and the `--expect-window`
refusals over hand-built serve window reports.  ``diff_report_objs``,
``parse_window_spec`` and ``check_window_compat`` are held to the
reference's on hand-built inputs (the reference's verdict-transition
case through the port's ``attach_static``).
"""

import contextlib
import io
import json

import pytest

jax = pytest.importorskip("jax")

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu import errors as rerrors  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.runtime import report as rreport  # noqa: E402
from ruleset_analysis_tpu_torch import cli, errors  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import report  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import staticanalysis as sa  # noqa: E402

MAINS = {"port": cli.main, "ref": rcli.main}
#: the synth_config seed of the base ruleset: one whose churn_config move
#: turns a rule dead (ACL1 rule 2: partially-masked -> conflict)
SEED = 5
#: name -> (ruleset, lines, corpus seed)
CORPORA = {"old": ("base", 500, 55), "new": ("base", 700, 56), "churned": ("churned", 700, 57)}


def _call(main, args) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(list(args))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """{(side, static, corpus): report path} of both CLIs' `run --json`."""
    d = tmp_path_factory.mktemp("diff")
    base = synth.synth_config(n_acls=2, rules_per_acl=8, seed=SEED)
    churned, edits = synth.churn_config(base)
    assert edits == {"move": ("ACL1", 2), "delete": ("ACL0", 8), "add": ("ACL1", 9)}
    prefixes = {}
    for name, text in (("base", base), ("churned", churned)):
        packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
        prefixes[name] = (str(d / name), packed)
        pack.save_packed(packed, str(d / name))
    logs = {}
    for corpus, (rs, n, seed) in CORPORA.items():
        packed = prefixes[rs][1]
        lines = synth.render_syslog(packed, synth.synth_tuples(packed, n, seed=seed), seed=seed)
        logs[corpus] = d / f"{corpus}.log"
        logs[corpus].write_text("\n".join(lines) + "\n")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        make = rmesh.make_mesh
        mp.setattr(rmesh, "make_mesh",
                   lambda devices=None, *a, **k: make(jax.devices()[:1], *a, **k))
        for side, main in MAINS.items():
            for static in (False, True):
                for corpus, (rs, _n, _s) in CORPORA.items():
                    path = str(d / f"{side}-{corpus}{'-static' if static else ''}.json")
                    rc, _o, err = _call(main, [
                        "run", "--ruleset", prefixes[rs][0], "--logs", str(logs[corpus]),
                        "--batch-size", "128", "--no-native-parse", "--json", "--out", path,
                        *(["--device", "cpu"] if side == "port" else []),
                        *(["--static-analysis"] if static else [])])
                    assert rc == 0, (side, corpus, err[-500:])
                    out[(side, static, corpus)] = path
    return out


PAIRS = {"two runs": ("old", "new"), "ruleset churn": ("new", "churned"), "itself": ("old", "old")}


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("top", [None, "0", "3"])
@pytest.mark.parametrize("static", [False, True], ids=["plain", "static"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_diff_reports_prints_the_references_bytes(reports, pair, static, top, fmt):
    old, new = PAIRS[pair]
    flags = [*(["--top", top] if top else []), *(["--json"] if fmt == "json" else [])]
    outs = {}
    for made_by in MAINS:
        for side, main in MAINS.items():
            rc, text, err = _call(main, ["diff-reports", reports[(made_by, static, old)],
                                         reports[(made_by, static, new)], *flags])
            assert rc == 0 and not err, (made_by, side, err)
            outs[(made_by, side)] = text
    assert len(set(outs.values())) == 1, outs
    if fmt == "json":
        d = json.loads(outs[("port", "port")])
        assert ("verdict_transitions" in d) == static
        n_movers = len(d["top_hit_movers"])
        assert n_movers <= (int(top) if top else 10)
        if pair == "itself":
            assert not d["newly_used"] and not d["newly_unused"] and n_movers == 0
            assert d.get("verdict_transitions", []) == []
        if pair == "ruleset churn":
            assert d["rules_added"] == ["fw1 ACL1 9"] and d["rules_removed"] == ["fw1 ACL0 8"]
            if static:
                moved = [m for m in d["verdict_transitions"] if m["rule"] == "fw1 ACL1 2"]
                assert moved and moved[0]["new"] == sa.CONFLICT


@pytest.mark.parametrize("static_side", ["old", "new"])
def test_verdicts_on_one_side_only_grow_no_transitions(reports, static_side):
    """One report with static verdicts, one without: no verdict_transitions
    key, as in the reference."""
    old = reports[("port", static_side == "old", "old")]
    new = reports[("port", static_side == "new", "new")]
    outs = {side: _call(main, ["diff-reports", old, new, "--json"])
            for side, main in MAINS.items()}
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == 0 and "verdict_transitions" not in json.loads(outs["port"][1])


def test_diff_counts_are_the_set_arithmetic(reports):
    """The reference's text/JSON case, on the port's reports."""
    old, new = reports[("port", False, "old")], reports[("port", False, "new")]
    rc, text, _ = _call(cli.main, ["diff-reports", old, new])
    assert rc == 0 and "stable unused" in text
    rc, out, _ = _call(cli.main, ["diff-reports", old, new, "--json"])
    d = json.loads(out)
    with open(old) as fa, open(new) as fb:
        ua = {tuple(k) for k in json.load(fa)["unused"]}
        ub = {tuple(k) for k in json.load(fb)["unused"]}
    assert len(d["stable_unused"]) == len(ua & ub)
    assert len(d["newly_used"]) == len(ua - ub)
    assert len(d["newly_unused"]) == len(ub - ua)


BAD = {
    "not json": "not json",
    "a rule without hits": json.dumps({"per_rule": [{"firewall": "f", "acl": "a",
                                                     "index": 1}]}),
    "hits that are not numbers": json.dumps({"per_rule": [
        {"firewall": "f", "acl": "a", "index": 1, "hits": "x"}]}),
}


@pytest.mark.parametrize("case", sorted(BAD) + ["missing file", "--top -1"])
def test_refusals_are_the_references(tmp_path, case):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"per_rule": [
        {"firewall": "f", "acl": "a", "index": 1, "hits": 3}], "unused": []}))
    if case == "--top -1":
        args = [str(good), str(good), "--top", "-1"]
    elif case == "missing file":
        args = [str(good), str(tmp_path / "missing.json")]
    else:
        bad = tmp_path / "bad.json"
        bad.write_text(BAD[case])
        args = [str(bad), str(good)] if case == "not json" else [str(good), str(bad)]
    got = {}
    for side, main in MAINS.items():
        rc, out, err = _call(main, ["diff-reports", *args])
        got[side] = (rc, out, err.strip().splitlines()[-1])
    assert got["port"] == got["ref"]
    assert got["port"][0] == 2


def test_ruleset_churn_is_not_mislabeled(tmp_path):
    """A rule present in only one report is ruleset churn, never newly
    used or newly unused (the reference's case)."""
    a = {"per_rule": [{"firewall": "fw1", "acl": "A", "index": 1, "hits": 0},
                      {"firewall": "fw1", "acl": "A", "index": 2, "hits": 5}],
         "unused": [["fw1", "A", 1]]}
    b = {"per_rule": [{"firewall": "fw1", "acl": "A", "index": 2, "hits": 9},
                      {"firewall": "fw1", "acl": "A", "index": 3, "hits": 0}],
         "unused": [["fw1", "A", 3]]}
    d = report.diff_report_objs(a, b)
    assert d == rreport.diff_report_objs(a, b)
    assert d["newly_used"] == [] and d["newly_unused"] == []
    assert d["rules_removed"] == ["fw1 A 1"] and d["rules_added"] == ["fw1 A 3"]
    assert d["top_hit_movers"] == [{"rule": "fw1 A 2", "old": 5, "new": 9}]


LATTICE_CFG = """
hostname fw1
access-list A extended permit tcp any any eq 80
access-list A extended deny tcp any any eq 80
access-list A extended permit tcp host 10.0.0.1 any eq 80
access-list A extended permit udp any any range 100 200
access-list A extended deny udp any any range 150 250
access-list A extended permit udp any any range 100 250
access-list A extended permit ip any any
access-group A in interface outside
"""


def _report_with_hits(packed, hits_by_kid):
    hits = {}
    for kid, h in hits_by_kid.items():
        m = packed.key_meta[kid]
        hits[(m.firewall, m.acl, m.index)] = h
    return report.build_report(packed, hits, backend="test")


def test_verdict_transitions_as_the_reference():
    """The reference's test_staticanalysis verdict-transition case, through
    the port's attach_static and SHADOWED."""
    packed = pack.pack_rulesets([aclparse.parse_asa_config(LATTICE_CFG, "fw1")])
    res = sa.analyze_ruleset(packed, device="cpu")
    rep_a, rep_b = _report_with_hits(packed, {0: 1}), _report_with_hits(packed, {0: 2})
    sa.attach_static(rep_a, packed, res)
    sa.attach_static(rep_b, packed, res)
    obj_a, obj_b = json.loads(rep_a.to_json()), json.loads(rep_b.to_json())
    assert report.diff_report_objs(obj_a, obj_b)["verdict_transitions"] == []
    for e in obj_b["per_rule"]:
        if e["index"] == 4 and e.get("verdict") is not None:
            e["verdict"] = sa.SHADOWED
    d = report.diff_report_objs(obj_a, obj_b)
    assert d == rreport.diff_report_objs(obj_a, obj_b)
    assert d["verdict_transitions"] == [{"rule": "fw1 A 4", "old": "reachable",
                                         "new": "shadowed"}]
    plain_a = json.loads(_report_with_hits(packed, {0: 1}).to_json())
    plain_b = json.loads(_report_with_hits(packed, {0: 2}).to_json())
    assert "verdict_transitions" not in report.diff_report_objs(plain_a, plain_b)


def _window_rep(hits, *, mode="lines", length=100.0, wid=3, incomplete=None, window=True):
    totals = {"lines_total": 100}
    if window:
        totals["window"] = {"mode": mode, "length": length, "id": wid}
        if incomplete:
            totals["window"]["incomplete"] = incomplete
    return {"per_rule": [{"firewall": "fw1", "acl": "A", "index": i, "hits": h}
                         for i, h in enumerate(hits, 1)],
            "unused": [["fw1", "A", i] for i, h in enumerate(hits, 1) if h == 0],
            "totals": totals}


@pytest.mark.parametrize("which", ["old", "new", "both", "neither"])
def test_window_incomplete_is_surfaced(which, capsys):
    inc = {"drops": 4, "reasons": ["queue_full"]}
    a = _window_rep([0, 5, 0], incomplete=inc if which in ("old", "both") else None)
    b = _window_rep([2, 0, 0], incomplete=inc if which in ("new", "both") else None)
    d = report.diff_report_objs(a, b)
    assert d == rreport.diff_report_objs(a, b)
    want = {"old": ["old"], "new": ["new"], "both": ["old", "new"]}.get(which)
    assert d.get("window_incomplete") == want


SPECS = ["lines:100", "LINES:7", " lines:1 ", "lines:0", "lines:-3", "lines:x", "900s", "15m",
         "24h", "7d", "1.5h", "0s", "-2m", "abc", "", "s", "12"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_window_spec_is_the_references(spec):
    got = {}
    for side, (mod, err) in {"port": (report, errors), "ref": (rreport, rerrors)}.items():
        try:
            got[side] = ("ok", mod.parse_window_spec(spec))
        except err.AnalysisError as e:
            got[side] = ("refused", str(e))
    assert got["port"] == got["ref"]


#: name -> (old report kwargs, new report kwargs, --expect-window)
WINDOW_CASES = {
    "match lines": ({}, {}, "lines:100"),
    "match 24h": ({"mode": "sec", "length": 86400.0}, {"mode": "sec", "length": 86400.0}, "24h"),
    "24h against 7d": ({"mode": "sec", "length": 86400.0}, {"mode": "sec", "length": 604800.0},
                       "24h"),
    "old has no window": ({"window": False}, {}, "lines:100"),
    "new has no id": ({}, {"wid": None}, "lines:100"),
    "other length": ({}, {}, "lines:200"),
    "bad spec": ({}, {}, "abc"),
    "incomplete but matching": ({"incomplete": {"drops": 1, "reasons": ["x"]}}, {}, "lines:100"),
}


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_expect_window_is_the_references(tmp_path, case, fmt):
    ka, kb, spec = WINDOW_CASES[case]
    a, b = _window_rep([0, 5, 0], **ka), _window_rep([2, 0, 0], **kb)
    if kb.get("wid", 3) is None:
        del b["totals"]["window"]["id"]
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    got = {}
    for side, main in MAINS.items():
        rc, out, err = _call(main, ["diff-reports", str(pa), str(pb), "--expect-window", spec,
                                    *(["--json"] if fmt == "json" else [])])
        got[side] = (rc, out, err.strip().splitlines()[-1:] if err else [])
    assert got["port"] == got["ref"]
    refusals = {"24h against 7d", "old has no window", "new has no id", "other length",
                "bad spec"}
    assert got["port"][0] == (1 if case in refusals else 0)
    for side, mod in (("port", report), ("ref", rreport)):
        if case in refusals:
            with pytest.raises(Exception, match="window"):
                mod.check_window_compat(a, b, spec)
        else:
            assert mod.check_window_compat(a, b, spec) is None
    assert report.window_of(a) == rreport.window_of(a)
    assert report.window_of(b) == rreport.window_of(b)
