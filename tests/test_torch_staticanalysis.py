"""The port's static analysis (runtime/staticanalysis.py) against the reference's.

Each case builds one ruleset in both packages (numpy-seeded for the
random ones), runs ``analyze_ruleset`` in each on the CPU (the port's
plain ``relation_tile`` and ``first_match`` versions; the reference's
XLA route), and requires ``to_obj`` to be equal apart from
``meta.duration_sec``.  The cases are the reference's
``tests/test_staticanalysis.py`` ones: the brute-force seeds (whose dead
set must also equal the brute-force first-match oracle's), the
implicit-any rule, the hand-built lattice, budget truncation, v6-bearing
rules, tile independence, the report join (unused classes, strict and
non-strict contradictions, a report without analysis), reuse across
re-analysis and key renumbering, the ``analyze.tile`` fault, the budget
guard, the JSON round trip and the key_meta action.  Its serve and
``diff-reports`` cases wait for the port's serve.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from ruleset_analysis_tpu import errors as rerrors  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse as raclparse  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.runtime import faults as rfaults  # noqa: E402
from ruleset_analysis_tpu.runtime import report as rreport  # noqa: E402
from ruleset_analysis_tpu.runtime import staticanalysis as rsa  # noqa: E402
from ruleset_analysis_tpu_torch import errors  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import faults  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import report as report_mod  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import staticanalysis as sa_mod  # noqa: E402

# ---------------------------------------------------------------------------
# The reference test's brute-force oracle over tiny enumerable domains.
# ---------------------------------------------------------------------------

DOM_PROTO, DOM_ADDR, DOM_PORT = 4, 16, 4
_G = np.meshgrid(np.arange(DOM_PROTO), np.arange(DOM_ADDR), np.arange(DOM_PORT),
                 np.arange(DOM_ADDR), np.arange(DOM_PORT), indexing="ij")
PKT = [g.ravel().astype(np.int64) for g in _G]


def oracle_reachable(rules) -> set[int]:
    """First-match scan over every packet of the universe."""
    proto, src, sport, dst, dport = PKT
    unclaimed = np.ones(proto.size, dtype=bool)
    reach = set()
    for k, rule in enumerate(rules):
        m = np.zeros(proto.size, dtype=bool)
        for a in rule.aces:
            m |= ((proto >= a.proto_lo) & (proto <= a.proto_hi) & (src >= a.src_lo)
                  & (src <= a.src_hi) & (sport >= a.sport_lo) & (sport <= a.sport_hi)
                  & (dst >= a.dst_lo) & (dst <= a.dst_hi) & (dport >= a.dport_lo)
                  & (dport <= a.dport_hi))
        if (m & unclaimed).any():
            reach.add(k)
        unclaimed &= ~m
    return reach


def _iv(rng, dom):
    r = rng.random()
    if r < 0.3:
        return 0, dom - 1
    if r < 0.6:
        v = int(rng.integers(dom))
        return v, v
    a, b = sorted(int(x) for x in rng.integers(0, dom, size=2))
    return a, b


def tiny_spec(rng, n_rules):
    """[(aces)] per rule, each ACE an (action, 10 bounds) tuple (the
    reference test's draws)."""
    spec = []
    for _ in range(n_rules):
        n_aces = 1 if rng.random() < 0.8 else 2
        spec.append([
            (int(rng.integers(2)), *_iv(rng, DOM_PROTO), *_iv(rng, DOM_ADDR),
             *_iv(rng, DOM_PORT), *_iv(rng, DOM_ADDR), *_iv(rng, DOM_PORT))
            for _ in range(n_aces)
        ])
    return spec


def ruleset_of(mod, spec, acl="T"):
    rules = [mod.AclRule(acl=acl, index=i + 1, text=f"r{i}", aces=[mod.Ace(*a) for a in aces])
             for i, aces in enumerate(spec)]
    return mod.Ruleset(firewall="fw", acls={acl: rules})


def packed_pair(spec=None, *, text=None, host="fw1", pad=None):
    """The same ruleset packed by each package: (port, reference)."""
    if text is not None:
        return (pack.pack_rulesets([aclparse.parse_asa_config(text, host)]),
                rpack.pack_rulesets([raclparse.parse_asa_config(text, host)]))
    return (pack.pack_rulesets([ruleset_of(aclparse, spec)], pad_rules_to=pad),
            rpack.pack_rulesets([ruleset_of(raclparse, spec)], pad_rules_to=pad))


def obj_of(res, packed):
    obj = res.to_obj(packed)
    obj["meta"].pop("duration_sec")
    return obj


def analyze_both(pair, **kw):
    """Both analyses of a packed pair; their objects must be equal."""
    p, rp = pair
    reuse = kw.pop("reuse", (None, None))
    res = sa_mod.analyze_ruleset(p, device="cpu", reuse=reuse[0], **kw)
    ref = rsa.analyze_ruleset(rp, reuse=reuse[1], **kw)
    assert obj_of(res, p) == obj_of(ref, rp)
    assert res.acl_index == ref.acl_index
    return res, ref


def test_constants_equal_the_references():
    for name in ("REACHABLE", "SHADOWED", "REDUNDANT", "CONFLICT", "PARTIAL", "DEAD_VERDICTS",
                 "CLASS_SAFE", "CLASS_TRAFFIC", "CLASS_UNDECIDED", "DEFAULT_WITNESS_BUDGET",
                 "_CAND_CHUNK", "_FIELDS"):
        assert getattr(sa_mod, name) == getattr(rsa, name), name


@pytest.mark.parametrize("seed", range(10))
def test_analyzer_matches_reference_and_bruteforce_oracle(seed):
    rng = np.random.default_rng(seed)
    n_rules = int(rng.integers(5, 11))
    spec = tiny_spec(rng, n_rules)
    pair = packed_pair(spec, pad=32)
    res, _ = analyze_both(pair, witness_budget=1 << 17)
    rules = ruleset_of(aclparse, spec).acls["T"]
    assert res.dead_keys() == set(range(n_rules)) - oracle_reachable(rules)
    for kid, v in res.verdicts.items():
        if v.dead:
            assert v.certified and v.basis in ("single-cover", "witness-exhaustion")
            if v.basis == "single-cover":
                assert v.cover_key is not None and v.cover_key < kid
            else:
                assert v.witness_grid >= v.witnesses_checked > 0
        if v.witness is not None:
            assert kid in oracle_reachable(rules[: kid + 1])
    assert res.meta["complete"] is True


def test_implicit_any_rule_first_kills_everything_after():
    spec = tiny_spec(np.random.default_rng(99), 6)
    any_ace = (1, 0, DOM_PROTO - 1, 0, DOM_ADDR - 1, 0, DOM_PORT - 1, 0, DOM_ADDR - 1,
               0, DOM_PORT - 1)
    res, _ = analyze_both(packed_pair([[any_ace]] + spec))
    assert res.verdicts[0].verdict == sa_mod.REACHABLE
    assert res.dead_keys() == set(range(1, 7))


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


@pytest.fixture(scope="module")
def lattice():
    pair = packed_pair(text=LATTICE_CFG)
    res, ref = analyze_both(pair)
    return pair, res, ref


def test_verdict_lattice_hand_built(lattice):
    _, res, _ = lattice
    v = res.verdicts
    assert v[0].verdict == sa_mod.REACHABLE and v[0].basis == "disjoint"
    assert v[1].verdict == sa_mod.CONFLICT and v[1].cover_key == 0
    assert v[2].verdict == sa_mod.REDUNDANT and v[2].cover_key == 0
    assert v[3].verdict == sa_mod.REACHABLE
    assert v[4].verdict == sa_mod.PARTIAL and v[4].basis == "witness"
    assert v[4].certified and 201 <= v[4].witness[4] <= 250
    assert v[5].verdict == sa_mod.SHADOWED and v[5].basis == "witness-exhaustion"
    assert v[5].certified and v[5].witness_grid == v[5].witnesses_checked > 0
    assert v[6].verdict == sa_mod.PARTIAL and v[6].basis == "witness"


def test_text_view_equals_the_references(lattice):
    (p, rp), res, ref = lattice
    a = sa_mod.render_text(p, res.to_obj(p)).splitlines()
    b = rsa.render_text(rp, ref.to_obj(rp)).splitlines()
    assert a[1:] == b[1:]
    assert a[0].rsplit("(", 1)[0] == b[0].rsplit("(", 1)[0]


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_witness_budget_truncation_is_honest(lattice, budget):
    pair = lattice[0]
    res, _ = analyze_both(pair, witness_budget=budget)
    v = res.verdicts[5]
    assert v.verdict == (sa_mod.PARTIAL if budget == 1 else sa_mod.SHADOWED)
    if budget == 1:
        assert v.basis == "witness-budget" and not v.certified
        assert v.witness_grid > 1 and v.witnesses_checked == 1
        assert 5 not in res.dead_keys()


def test_v6_bearing_rules_never_die_from_v4_plane():
    cfg = """
hostname fw1
access-list A extended permit ip any any
access-list A extended permit tcp any any eq 80
access-group A in interface inside
"""
    pair = packed_pair(text=cfg)
    res, _ = analyze_both(pair)
    if pair[0].has_v6:
        v = res.verdicts[1]
        assert v.verdict == sa_mod.PARTIAL and v.basis == "v4-dead-v6-unanalyzed"
        assert not v.certified and not res.dead_keys()
    else:
        assert res.verdicts[1].verdict == sa_mod.REDUNDANT


@pytest.mark.parametrize("tile", [1, 2, 3, 5])
def test_tile_grid_independence(lattice, tile):
    pair, base, _ = lattice
    res, _ = analyze_both(pair, tile=tile)
    assert res.meta["tiles_run"] > base.meta["tiles_run"]
    assert {k: (v.verdict, v.basis) for k, v in res.verdicts.items()} == {
        k: (v.verdict, v.basis) for k, v in base.verdicts.items()
    }


@pytest.mark.parametrize("n_acls,rules,v6,tile", [
    (3, 24, 0.0, 512), (2, 64, 0.3, 512), (4, 16, 0.0, 8), (1, 96, 0.0, 32), (2, 40, 0.3, 16),
])
def test_synth_rulesets_equal_the_references(n_acls, rules, v6, tile):
    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules, seed=n_acls + rules,
                              v6_fraction=v6)
    res, _ = analyze_both(packed_pair(text=text), tile=tile)
    assert len(res.verdicts) == n_acls * rules
    assert res.meta["witnesses_checked"] > 0


# ---------------------------------------------------------------------------
# Report join.
# ---------------------------------------------------------------------------


def _reports_with_hits(pair, hits_by_kid):
    out = []
    for packed, mod in zip(pair, (report_mod, rreport)):
        hits = {}
        for kid, h in hits_by_kid.items():
            m = packed.key_meta[kid]
            hits[(m.firewall, m.acl, m.index)] = h
        out.append(mod.build_report(packed, hits, backend="test"))
    return out


def test_unused_rules_classify_by_evidence(lattice):
    pair, res, ref = lattice
    rep, rrep = _reports_with_hits(pair, {0: 10})
    sa_mod.attach_static(rep, pair[0], res)
    rsa.attach_static(rrep, pair[1], ref)
    a, b = json.loads(rep.to_json()), json.loads(rrep.to_json())
    a["totals"]["static"]["meta"].pop("duration_sec")
    b["totals"]["static"]["meta"].pop("duration_sec")
    assert a == b
    classes = rep.totals["static"]["unused_classes"]
    assert set(classes[sa_mod.CLASS_SAFE]) == {f"fw1 A {k + 1}" for k in (1, 2, 5)}
    assert "fw1 A 4" in classes[sa_mod.CLASS_TRAFFIC]
    assert classes[sa_mod.CLASS_UNDECIDED] == []
    assert rep.per_rule[1]["verdict"] == sa_mod.CONFLICT
    assert "verdict" not in rep.per_rule[-1]
    txt = rep.to_text()
    assert "provably dead — safe to delete" in txt
    assert txt.splitlines()[1:] == rrep.to_text().splitlines()[1:]


def test_hit_on_dead_rule_is_typed_contradiction(lattice):
    pair, res, ref = lattice
    rep, rrep = _reports_with_hits(pair, {1: 3, 2: 1})
    with pytest.raises(errors.AnalyzerContradiction, match="fw1 A 2") as ei:
        sa_mod.attach_static(rep, pair[0], res)
    with pytest.raises(rerrors.AnalyzerContradiction) as rei:
        rsa.attach_static(rrep, pair[1], ref)
    assert str(ei.value) == str(rei.value)
    rep, rrep = _reports_with_hits(pair, {1: 3, 2: 1})
    sa_mod.attach_static(rep, pair[0], res, strict=False)
    rsa.attach_static(rrep, pair[1], ref, strict=False)
    cons = rep.totals["static"]["contradictions"]
    assert cons == rrep.totals["static"]["contradictions"]
    assert cons[0] == {"rule": "fw1 A 2", "hits": 3, "verdict": "conflict"}
    assert "CONTRADICTION" in rep.to_text()


def test_report_without_analysis_is_untouched(lattice):
    rep, rrep = _reports_with_hits(lattice[0], {0: 1})
    assert "static" not in rep.totals and "verdict" not in rep.per_rule[0]
    assert "[provably dead" not in rep.to_text()
    assert json.loads(rep.to_json()) == json.loads(rrep.to_json())


# ---------------------------------------------------------------------------
# Incremental re-analysis.
# ---------------------------------------------------------------------------

TWO_ACL_CFG = """
hostname fwx
access-list A extended permit tcp any any eq 80
access-list A extended permit tcp any any eq 80
access-list B extended permit udp any any eq 53
access-list B extended deny udp any any eq 53
access-group A in interface inside
access-group B in interface outside
"""

TWO_ACL_CFG_B_CHANGED = """
hostname fwx
access-list A extended permit tcp any any eq 80
access-list A extended permit tcp any any eq 80
access-list B extended deny udp any any eq 53
access-list B extended permit udp any any eq 53
access-group A in interface inside
access-group B in interface outside
"""


def test_reanalysis_reuses_unchanged_acls_exactly():
    old = packed_pair(text=TWO_ACL_CFG, host="fwx")
    new = packed_pair(text=TWO_ACL_CFG_B_CHANGED, host="fwx")
    sa_old = analyze_both(old)
    inc, _ = analyze_both(new, reuse=sa_old)
    assert inc.meta["reused_acls"] == 1 and inc.meta["analyzed_acls"] == 1
    fresh, _ = analyze_both(new)
    assert {k: (v.verdict, v.basis, v.certified, v.cover_key) for k, v in inc.verdicts.items()} \
        == {k: (v.verdict, v.basis, v.certified, v.cover_key) for k, v in fresh.verdicts.items()}
    assert inc.verdicts[3].verdict == sa_mod.CONFLICT
    cached, _ = analyze_both(old, reuse=sa_old)
    assert cached.meta["reused_acls"] == 2 and cached.meta["analyzed_acls"] == 0
    assert cached.meta["tiles_run"] == 0


def test_reuse_remaps_key_ids_across_renumbering():
    base_cfg = """
hostname fwx
access-list Z extended permit tcp any any eq 80
access-list Z extended deny tcp any any eq 80
access-group Z in interface inside
"""
    grown_cfg = """
hostname fwx
access-list A extended permit udp any any eq 1
access-list A extended permit udp any any eq 2
access-list A extended permit udp any any eq 3
access-list Z extended permit tcp any any eq 80
access-list Z extended deny tcp any any eq 80
access-group A in interface outside
access-group Z in interface inside
"""
    sa_old = analyze_both(packed_pair(text=base_cfg, host="fwx"))
    inc, _ = analyze_both(packed_pair(text=grown_cfg, host="fwx"), reuse=sa_old)
    assert inc.meta["reused_acls"] == 1
    assert inc.verdicts[4].verdict == sa_mod.CONFLICT and inc.verdicts[4].cover_key == 3


# ---------------------------------------------------------------------------
# The analyze.tile fault, guards, serialization.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_fault_aborts_typed_never_partial(lattice, seed):
    (p, rp), _, _ = lattice
    plan = faults.FaultPlan.random(seed, sites=["analyze.tile"], n_faults=1)
    rplan = rfaults.FaultPlan.random(seed, sites=["analyze.tile"], n_faults=1)
    assert plan.to_str() == rplan.to_str()
    at = plan.specs["analyze.tile"].at
    with faults.armed(plan):
        with pytest.raises(errors.InjectedFault) as ei:
            sa_mod.analyze_ruleset(p, tile=2, device="cpu")
    with rfaults.armed(rplan):
        with pytest.raises(rerrors.InjectedFault) as rei:
            rsa.analyze_ruleset(rp, tile=2)
    assert isinstance(ei.value, errors.AnalysisError)
    assert str(ei.value) == str(rei.value) and f"hit {at}" in str(ei.value)
    res, _ = analyze_both((p, rp), tile=2)
    assert len(res.verdicts) == p.n_rules and res.meta["complete"] is True


def test_analyze_rejects_bad_budget(lattice):
    p = lattice[0][0]
    for budget in (0, -3):
        with pytest.raises(errors.AnalysisError, match="witness budget"):
            sa_mod.analyze_ruleset(p, witness_budget=budget, device="cpu")


def test_to_obj_round_trips_through_json(lattice):
    (p, _), res, _ = lattice
    obj = res.to_obj(p)
    assert json.loads(json.dumps(obj)) == obj
    rules = [v["rule"] for v in obj["verdicts"]]
    assert rules == sorted(rules, key=lambda r: int(r.rsplit(" ", 1)[1]))


def test_key_meta_action_round_trips_and_defaults(tmp_path, lattice):
    (p, rp), _, _ = lattice
    prefix = str(tmp_path / "p")
    pack.save_packed(p, prefix)
    loaded = pack.load_packed(prefix)
    assert [m.action for m in loaded.key_meta] == [m.action for m in p.key_meta]
    assert loaded.key_meta[0].action == aclparse.PERMIT
    assert loaded.key_meta[1].action == aclparse.DENY
    meta = json.loads(open(prefix + ".json").read())
    for m in meta["key_meta"]:
        m.pop("action")
    with open(prefix + ".json", "w") as f:
        json.dump(meta, f)
    old_style = (pack.load_packed(prefix), rpack.load_packed(prefix))
    assert all(m.action == -1 for m in old_style[0].key_meta if not m.implicit_deny)
    res, _ = analyze_both(old_style)
    assert res.verdicts[1].verdict == sa_mod.SHADOWED
    assert res.verdicts[2].verdict == sa_mod.SHADOWED


def test_the_default_device_is_the_card(lattice, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.DeviceUnavailable, match="--device cpu"):
        sa_mod.analyze_ruleset(lattice[0][0])


# ---------------------------------------------------------------------------
# The tile phase: every analyzed ACL's tiles in one relation_grid call.
# ---------------------------------------------------------------------------


def _tile_log(monkeypatch):
    """Record the port's on_tile calls per slab, the reference's per
    pair_relations call, and the port's relation_grid calls."""
    from ruleset_analysis_tpu.ops import overlap as roverlap
    from ruleset_analysis_tpu_torch.ops import overlap

    log = {"port": [], "ref": [], "grid": []}
    many, rpair, grid = (overlap.pair_relations_many, roverlap.pair_relations,
                         overlap.relation_grid)

    def port_many(slabs, *a, on_tile=None, **kw):
        def seam(s, i0, j0):
            log["port"].append((s, i0, j0))
            on_tile(s, i0, j0)
        return many(slabs, *a, on_tile=seam, **kw)

    def ref_pair(rules, *a, on_tile=None, **kw):
        log["ref"].append([])

        def seam(i0, j0):
            log["ref"][-1].append((i0, j0))
            on_tile(i0, j0)
        return rpair(rules, *a, on_tile=seam, **kw)

    def port_grid(blocks, work, tile, **kw):
        log["grid"].append(work.shape[0])
        return grid(blocks, work, tile, **kw)

    monkeypatch.setattr(overlap, "pair_relations_many", port_many)
    monkeypatch.setattr(roverlap, "pair_relations", ref_pair)
    monkeypatch.setattr(overlap, "relation_grid", port_grid)
    return log


@pytest.mark.parametrize("n_acls,rules,v6,tile", [
    (3, 24, 0.0, 8), (4, 40, 0.0, 16), (2, 64, 0.3, 16), (3, 30, 0.3, 512), (1, 96, 0.0, 32),
])
def test_tile_order_and_count_equal_the_references(monkeypatch, n_acls, rules, v6, tile):
    """The port fires each analyzed ACL's analyze.tile seams in the
    reference's order (ACL by ACL, its lower tiles in grid order), all in
    one relation_grid call over as many tiles as the reference's tiles_run."""
    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules, seed=7 * n_acls + rules,
                              v6_fraction=v6)
    log = _tile_log(monkeypatch)
    res, ref = analyze_both(packed_pair(text=text), tile=tile)
    ref_calls = [c for c in log["ref"] if c]
    port = {}
    for s, i0, j0 in log["port"]:
        port.setdefault(s, []).append((i0, j0))
    assert list(port.values()) == ref_calls
    assert [t for s in sorted(port) for t in port[s]] == [t for c in log["ref"] for t in c]
    assert res.meta["tiles_run"] == ref.meta["tiles_run"] == len(log["port"]) > 0
    assert log["grid"] == [res.meta["tiles_run"]]


def test_tile_fault_fires_before_any_relation_grid_call(monkeypatch, lattice):
    (p, rp), _, _ = lattice
    log = _tile_log(monkeypatch)
    with faults.armed(faults.FaultPlan.parse("analyze.tile@2")):
        with pytest.raises(errors.InjectedFault, match="hit 2"):
            sa_mod.analyze_ruleset(p, tile=2, device="cpu")
    assert log["grid"] == [] and len(log["port"]) == 2
    with rfaults.armed(rfaults.FaultPlan.parse("analyze.tile@2")):
        with pytest.raises(rerrors.InjectedFault, match="hit 2"):
            rsa.analyze_ruleset(rp, tile=2)
    assert sum(map(len, log["ref"])) == 2


def test_reuse_relaunches_only_the_changed_acls(monkeypatch):
    """With reuse, the JSON is the reference's; only the changed ACL's tiles
    go to the one relation_grid call, and with every ACL reused none."""
    text = synth.synth_config(n_acls=4, rules_per_acl=20, seed=5)
    lines = text.splitlines(keepends=True)
    k = next(i for i, ln in enumerate(lines) if ln.startswith("access-list ACL2 extended "))
    flip = {"permit": "deny", "deny": "permit"}
    lines[k] = " ".join(flip.get(w, w) for w in lines[k].split(" "))
    changed = "".join(lines)
    assert changed != text
    old = packed_pair(text=text)
    sa_old = analyze_both(old)
    log = _tile_log(monkeypatch)
    inc, _ = analyze_both(packed_pair(text=changed), reuse=sa_old)
    assert inc.meta["reused_acls"] == 3 and inc.meta["analyzed_acls"] == 1
    assert log["grid"] == [inc.meta["tiles_run"]] and inc.meta["tiles_run"] > 0
    log["grid"].clear()
    cached, _ = analyze_both(old, reuse=sa_old)
    assert cached.meta["analyzed_acls"] == 0 and cached.meta["tiles_run"] == 0
    assert log["grid"] == []
