"""The window lineage plane of the port against the reference's.

- **Records**: ``lineage_core`` and the ``seal_lineage`` CRC (the
  reference's tests/test_lineage.py cases, then seeded records in every
  key order), ``lineage_frontier`` over seeded ledgers with gaps,
  incomplete windows, republished windows and ``merged`` records, and
  ``trend_events`` over a seeded run of window reports, the events and
  the hysteresis ``state`` after each step.
- **The ledger file**: ``LineageLog`` round trip and torn tail, the
  ``lineage.append`` fault site aborting typed before any byte lands,
  the same records giving the same bytes, each package reading the
  other's file; ``find_lineage`` in both layouts.
- **doctor --lineage**: explicit and found beside the bundle or in its
  parent, ``--json`` and text, through both CLIs on one bundle and
  ledger: the same output.
"""

import json
import os
import random

import numpy as np
import pytest

pytest.importorskip("jax")

from tests._torch_faultkit import BOTH, PORT, REF, make_corpus, reset_all  # noqa: E402
from ruleset_analysis_tpu.runtime import faults as rfaults  # noqa: E402
from ruleset_analysis_tpu.runtime import report as rreport  # noqa: E402
from ruleset_analysis_tpu.runtime import wal as rwal  # noqa: E402
from ruleset_analysis_tpu_torch import errors  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import faults, flightrec, report, wal  # noqa: E402

REPORTS = {"port": report, "ref": rreport}


def _rec(mod, window, *, term=1, path="live", incomplete=None, kind="window"):
    """The reference tests' lineage record, sealed by ``mod``."""
    rec = {
        "window": window,
        "kind": kind,
        "hosts": [{
            "rank": 0, "wal_seq_lo": window * 10, "wal_seq_hi": window * 10 + 10,
            "drops": 0, "quarantine_hits": 0,
        }],
        "generation": 0,
        "term": term,
        "path": path,
        "published_unix": 123.0 + window,
    }
    if incomplete:
        rec["incomplete"] = incomplete
    return mod.seal_lineage(rec)


# ---------------------------------------------------------------------------
# Records: seal, frontier, trends
# ---------------------------------------------------------------------------


def test_seal_lineage_crc_covers_only_the_core():
    a = _rec(report, 3, term=1, path="live")
    b = _rec(report, 3, term=7, path="replay")
    assert report.lineage_core(a) == report.lineage_core(b)
    assert a["crc"] == b["crc"] == _rec(rreport, 3)["crc"]
    assert a["term"] != b["term"] and a["path"] != b["path"]
    assert report.LINEAGE_VOLATILE == rreport.LINEAGE_VOLATILE
    for k in report.LINEAGE_VOLATILE:
        assert k not in report.lineage_core(a)
    c = _rec(report, 3)
    c["hosts"][0]["drops"] = 1
    assert report.seal_lineage(c)["crc"] != a["crc"]
    assert report.seal_lineage(dict(a))["crc"] == a["crc"]


def _random_value(rng, depth=0):
    roll = rng.random()
    if depth < 2 and roll < 0.25:
        return {f"k{rng.randrange(9)}": _random_value(rng, depth + 1) for _ in range(3)}
    if depth < 2 and roll < 0.4:
        return [_random_value(rng, depth + 1) for _ in range(rng.randrange(4))]
    return rng.choice([rng.randrange(-5, 10 ** 6), rng.random(), "sé", None, True, "x" * 3])


def _shuffled(v, rng):
    """``v`` with every dict's key order shuffled (the same value)."""
    if isinstance(v, dict):
        items = list(v.items())
        rng.shuffle(items)
        return {k: _shuffled(x, rng) for k, x in items}
    if isinstance(v, list):
        return [_shuffled(x, rng) for x in v]
    return v


@pytest.mark.parametrize("seed", range(6))
def test_seal_crc_is_the_references_in_every_key_order(seed):
    rng = random.Random(seed)
    rec = {"window": rng.randrange(100), "kind": "window", "generation": rng.randrange(3),
           "hosts": [{"rank": r, "wal_seq_lo": rng.randrange(1000), "drops": rng.randrange(3)}
                     for r in range(rng.randrange(1, 4))],
           "term": rng.randrange(1, 5), "path": rng.choice(["live", "replay", "backlog_heal"]),
           "published_unix": rng.random() * 1e9, "extra": _random_value(rng)}
    if rng.random() < 0.5:
        rec["incomplete"] = {"reasons": ["drops"], "drops": rng.randrange(1, 9)}
    crcs = set()
    for _ in range(4):
        perm = _shuffled(rec, rng)
        perm["term"], perm["path"] = rng.randrange(9), rng.choice(["live", "replay"])
        mine = report.seal_lineage(json.loads(json.dumps(perm)))
        ref = rreport.seal_lineage(json.loads(json.dumps(perm)))
        assert mine == ref
        assert report.lineage_core(mine) == rreport.lineage_core(ref)
        crcs.add(mine["crc"])
    assert len(crcs) == 1  # key order and the volatile envelope never move it


def test_lineage_frontier_complete_incomplete_gaps():
    fr = report.lineage_frontier
    assert fr([]) == {"windows": 0, "last_complete": None, "first_incomplete": None, "gaps": []}
    recs = [_rec(report, 0), _rec(report, 1), _rec(report, 3, incomplete={"reasons": ["drops"]}),
            _rec(report, 4)]
    got = fr(recs)
    assert got == {"windows": 4, "last_complete": 4, "first_incomplete": 2, "gaps": [2]}
    assert fr(recs + [{"window": 9, "kind": "merged", "k": 2}])["windows"] == 4
    healed = fr(recs + [_rec(report, 2), _rec(report, 3, path="replay")])
    assert healed["gaps"] == [] and healed["first_incomplete"] is None
    assert healed["last_complete"] == 4


def _ledger(rng) -> list[dict]:
    """A seeded ledger: a window range with gaps, incomplete windows,
    republications (last write wins), merged records and malformed ids."""
    lo = rng.randrange(0, 5)
    recs = []
    for w in range(lo, lo + rng.randrange(1, 14)):
        if rng.random() < 0.2:
            continue  # a gap
        inc = {"reasons": ["drops"]} if rng.random() < 0.25 else None
        recs.append(_rec(report, w, incomplete=inc))
    for _ in range(rng.randrange(4)):
        if recs:
            w = rng.choice(recs)["window"]
            inc = {"reasons": ["late"]} if rng.random() < 0.5 else None
            recs.append(_rec(report, w, path="replay", term=2, incomplete=inc))
    recs += [{"window": rng.randrange(20), "kind": "merged", "k": 2}
             for _ in range(rng.randrange(3))]
    recs += [{"window": str(rng.randrange(5))}, {"kind": "window"}][: rng.randrange(3)]
    rng.shuffle(recs)
    return recs


@pytest.mark.parametrize("seed", range(10))
def test_lineage_frontier_is_the_references(seed):
    recs = _ledger(random.Random(seed))
    assert report.lineage_frontier(recs) == rreport.lineage_frontier(recs)


def _trend_rep(hits_by_idx, lines):
    return {"per_rule": [{"firewall": "fw1", "acl": "a", "index": i, "hits": h}
                         for i, h in hits_by_idx.items()],
            "totals": {"lines_total": lines}}


def test_trend_events_hysteresis_no_storm():
    ev = report.trend_events
    state: dict = {}
    steady = _trend_rep({0: 100, 1: 50}, 1000)
    for _ in range(5):
        assert ev(steady, steady, threshold=4.0, state=state) == []
    burst = _trend_rep({0: 1000, 1: 50}, 1000)
    got = ev(steady, burst, threshold=4.0, state=state)
    assert [e["event"] for e in got] == ["rule_burst"] and got[0]["rule"] == "fw1 a 0"
    assert ev(burst, burst, threshold=4.0, state=state) == []
    assert [e["event"] for e in ev(burst, steady, threshold=4.0, state=state)] == ["rule_quiet"]
    ev(steady, steady, threshold=4.0, state=state)
    assert state == {}
    assert [e["event"] for e in ev(steady, burst, threshold=4.0, state=state)] == ["rule_burst"]
    assert ev(_trend_rep({0: 2}, 1000), _trend_rep({0: 20}, 1000), threshold=4.0, state={}) == []
    assert ev(steady, _trend_rep({0: 10, 1: 5}, 100), threshold=4.0, state={}) == []
    assert report.TREND_MIN_HITS == rreport.TREND_MIN_HITS


@pytest.mark.parametrize("seed", range(5))
def test_trend_events_and_state_are_the_references(seed):
    rng = np.random.default_rng(seed)
    n_rules, reps = 24, []
    base = rng.integers(0, 400, n_rules)
    for _ in range(10):
        mult = np.where(rng.random(n_rules) < 0.2, rng.choice([0.05, 8.0, 30.0], n_rules), 1.0)
        hits = (base * mult * rng.uniform(0.8, 1.2, n_rules)).astype(int)
        # rule churn: a rule may be absent from a window
        keep = rng.random(n_rules) > 0.05
        reps.append(_trend_rep({i: int(h) for i, h in enumerate(hits) if keep[i]},
                               int(rng.integers(0, 5000))))
    threshold = float(rng.choice([2.0, 4.0]))
    min_hits = int(rng.choice([8, 32]))
    states = {"port": {}, "ref": {}}
    for old, new in zip(reps, reps[1:]):
        got = {side: mod.trend_events(old, new, threshold=threshold, state=states[side],
                                      min_hits=min_hits)
               for side, mod in REPORTS.items()}
        assert got["port"] == got["ref"]
        assert states["port"] == states["ref"]


# ---------------------------------------------------------------------------
# The ledger file
# ---------------------------------------------------------------------------


def test_lineage_log_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "lineage.jsonl")
    log = wal.LineageLog(path)
    a, b = _rec(report, 0), _rec(report, 1)
    log.append(a)
    log.append(b)
    log.sync()
    log.close()
    assert log.appended == 2
    assert wal.LineageLog.read(path) == [a, b] == rwal.LineageLog.read(path)
    with open(path, "ab") as f:
        f.write(b'{"window": 2, "torn')
    assert wal.LineageLog.read(path) == [a, b] == rwal.LineageLog.read(path)
    assert wal.LineageLog.read(str(tmp_path / "absent.jsonl")) == []
    assert wal.LineageLog.NAME == rwal.LineageLog.NAME == "lineage.jsonl"


def test_damage_before_the_final_line_is_corruption(tmp_path):
    path = tmp_path / "lineage.jsonl"
    path.write_bytes(b'{"window": 0}\n{"window": 1, "to\n{"window": 2}\n')
    for mod in (wal, rwal):
        with pytest.raises(ValueError):
            mod.LineageLog.read(str(path))


def test_lineage_append_fault_site_aborts_typed_never_torn(tmp_path):
    path = str(tmp_path / "lineage.jsonl")
    log = wal.LineageLog(path)
    with faults.armed(faults.FaultPlan.parse("lineage.append@1")):
        with pytest.raises(errors.InjectedFault):
            log.append(_rec(report, 0))
    assert wal.LineageLog.read(path) == [] and os.path.getsize(path) == 0
    log.append(_rec(report, 0))
    log.close()
    assert [r["window"] for r in wal.LineageLog.read(path)] == [0]


def test_a_failed_write_is_a_typed_analysis_error(tmp_path):
    log = wal.LineageLog(str(tmp_path / "lineage.jsonl"))
    log.close()
    log._fd = 10 ** 6  # a descriptor that is not open: os.write raises EBADF
    with pytest.raises(errors.AnalysisError, match="lineage append failed for window 7"):
        log.append({"window": 7})


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_same_records_same_bytes_and_each_reads_the_others(tmp_path, writer):
    recs = [_rec(report, w, incomplete={"reasons": ["drops"]} if w == 4 else None)
            for w in (0, 1, 2, 4, 5, 4)]
    files = {}
    for side, mod in (("port", wal), ("ref", rwal)):
        path = str(tmp_path / f"{side}.jsonl")
        log = mod.LineageLog(path)
        for r in recs:
            log.append(r)
        log.close()
        with open(path, "rb") as f:
            files[side] = f.read()
    assert files["port"] == files["ref"]
    other = "ref" if writer == "port" else "port"
    path = str(tmp_path / f"{writer}.jsonl")
    reader = wal if other == "port" else rwal
    assert reader.LineageLog.read(path) == recs


@pytest.mark.parametrize("arg", ["dir", "file"])
@pytest.mark.parametrize("layout", ["beside", "parent", "none"])
def test_find_lineage_in_both_layouts(tmp_path, layout, arg):
    serve = tmp_path / "serve"
    bb = serve / "blackbox"
    bb.mkdir(parents=True)
    (bb / "postmortem.json").write_text("{}")
    want = {"beside": bb, "parent": serve}.get(layout)
    if want is not None:
        (want / "lineage.jsonl").write_text("")
    target = str(bb if arg == "dir" else bb / "postmortem.json")
    got = flightrec.find_lineage(target)
    assert got == REF.flightrec.find_lineage(target)
    assert got == (str(want / "lineage.jsonl") if want is not None else None)


# ---------------------------------------------------------------------------
# doctor --lineage through both CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """An exhausted copy fault's postmortem bundle, from the port's `run`."""
    d = tmp_path_factory.mktemp("lineage-doctor")
    c = make_corpus(d, 1200, seed=4)
    bb = d / "serve" / "blackbox"
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RA_BLACKBOX", raising=False)
        rc = PORT.cli.main(["run", "--ruleset", c["prefix"], "--logs", c["text"], "--device",
                            "cpu", "--batch-size", "256", "--prefetch-depth", "0",
                            "--retry-policy", "device_put=2/0.001", "--fault-plan",
                            "stream.device_put.fail@2:99", "--blackbox-dir", str(bb),
                            "--json", "--out", os.devnull])
        reset_all()
    assert rc == 1 and (bb / "postmortem.json").exists()
    return bb


def _ledger_file(path) -> list[dict]:
    """Windows 0-5 sealed: 3 missing, 4 incomplete, and a torn final line."""
    log = wal.LineageLog(str(path))
    recs = [_rec(report, w, incomplete={"reasons": ["drops"], "drops": 3} if w == 4 else None)
            for w in (0, 1, 2, 4, 5)]
    for r in recs:
        log.append(r)
    log.close()
    with open(path, "ab") as f:
        f.write(b'{"window": 6, "kind": "win')
    return recs


@pytest.mark.parametrize("fmt", ["json", "text"])
@pytest.mark.parametrize("where", ["beside", "parent", "explicit"])
def test_doctor_lineage_is_the_references(bundle, tmp_path, capsys, where, fmt):
    target = {"beside": bundle, "parent": bundle.parent, "explicit": tmp_path}[where]
    ledger = target / ("ledger.jsonl" if where == "explicit" else "lineage.jsonl")
    recs = _ledger_file(ledger)
    extra = ["--lineage", str(ledger)] if where == "explicit" else []
    try:
        outs = []
        for side in BOTH:
            capsys.readouterr()
            assert side.cli.main(["doctor", str(bundle), *extra,
                                  *(["--json"] if fmt == "json" else [])]) == 0
            outs.append(capsys.readouterr().out)
    finally:
        os.remove(ledger)
    assert outs[0] == outs[1]
    if fmt == "json":
        dj = json.loads(outs[0])
        assert dj["lineage_path"] == str(ledger)
        assert dj["lineage_frontier"] == report.lineage_frontier(recs) == {
            "windows": 5, "last_complete": 5, "first_incomplete": 3, "gaps": [3]}
        (lin,) = [d for d in dj["diagnosis"] if "lineage" in d["cause"]]
        assert "first missing/incomplete window: 3" in lin["evidence"]
    else:
        assert "publication frontier from the adjacent lineage ledger" in outs[0]


def test_doctor_without_a_ledger_joins_nothing(bundle, capsys):
    capsys.readouterr()
    outs = []
    for side in BOTH:
        assert side.cli.main(["doctor", str(bundle), "--json"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0]["lineage_path"] is None and outs[0]["lineage_frontier"] is None
    assert not any("lineage" in d["cause"] for d in outs[0]["diagnosis"])


@pytest.mark.parametrize("seed", range(4))
def test_diagnose_joins_the_ledger_as_the_reference(bundle, seed):
    b = flightrec.load_bundle(str(bundle))
    recs = _ledger(random.Random(seed))
    for rc in (None, 5):
        assert (flightrec.diagnose(b, exit_code=rc, lineage=recs)
                == REF.flightrec.diagnose(b, exit_code=rc, lineage=recs))


def test_the_lineage_site_is_registered_in_both():
    assert "lineage.append" in faults.SITES and "lineage.append" in rfaults.SITES
