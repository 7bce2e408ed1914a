"""The unused-rule report — the reference's L5 layer (SURVEY.md §2, §4.5).

A copy of the reference's ``runtime/report.py`` up to ``build_report``;
the port's reports must equal the reference's apart from
``VOLATILE_TOTALS`` and ``totals.backend``.

Reference semantics: set-difference of all configured rules minus rules with
hits, ordered per ACL; plus per-rule hit counts.  The device rebuild adds the
sketched statistics (estimated counts, per-rule unique-source cardinality,
top talkers) to the same report structure.

Pure host code; consumes plain dicts so both the oracle backend and the device
backend feed it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from ..hostside.oracle import RuleKey
from ..hostside.pack import PackedRuleset

#: ``totals`` keys that are wall-clock/process observations rather than
#: answers — the keys every report-identity test strips before comparing
#: runs bit-for-bit.  ONE list (tests import it; keeping a private copy
#: in a test module is a registry-auditor finding, verify/registry.py)
#: so a new volatile block added to the runtime cannot silently break
#: only SOME identity suites:
#:
#:   elapsed_sec/lines_per_sec/compile_sec/sustained_lines_per_sec —
#:       timings of this particular run
#:   ingest      pipeline overlap accounting (queue depths, waits)
#:   throughput  the meter's cumulative split timings
#:   coalesce    raw/unique compaction accounting (traffic-order shaped)
#:   autoscale   scale decisions/timings (wall-clock, not answers)
#:   recovery    elastic re-formation accounting
#:   devprof     capture-window timings, not answers
#:   lineage     provenance (term/path/publish stamp vary across
#:               control-vs-failover republication; its CORE fields
#:               have their own identity law — lineage_core below)
VOLATILE_TOTALS = (
    "elapsed_sec",
    "lines_per_sec",
    "compile_sec",
    "sustained_lines_per_sec",
    "ingest",
    "throughput",
    "coalesce",
    "autoscale",
    "recovery",
    "devprof",
    "degraded",
    "latency",
    "lineage",
)


@dataclasses.dataclass
class Report:
    """One analysis run's full output."""

    per_rule: list[dict]  # one entry per key, config order
    unused: list[RuleKey]
    totals: dict
    talkers: dict  # "<fw> <acl>" -> [[src_ip_str, count], ...]

    def to_json(self) -> str:
        return json.dumps(
            {
                "totals": self.totals,
                "per_rule": self.per_rule,
                "unused": [list(k) for k in self.unused],
                "talkers": self.talkers,
            },
            indent=2,
        )

    def to_text(self) -> str:
        out = []
        t = self.totals
        out.append(
            f"# lines={t.get('lines_total', 0)} matched={t.get('lines_matched', 0)} "
            f"skipped={t.get('lines_skipped', 0)} backend={t.get('backend', '?')}"
        )
        if t.get("config_entries_skipped"):
            out.append(
                f"# WARNING: {t['config_entries_skipped']} config entries were "
                "skipped at parse time (lenient mode); their rules are not analyzed"
            )
        # group by ACL: key order is all configured rules first, then every
        # ACL's implicit deny, so naive sequential headers would repeat
        by_acl: dict[tuple[str, str], list[dict]] = {}
        for e in self.per_rule:
            by_acl.setdefault((e["firewall"], e["acl"]), []).append(e)
        # HLL error band: every "unique sources" figure
        # is a sketch estimate; print its p90 band right next to it so a
        # deletion decision is never made on an uncaveated approximation
        hll = t.get("hll") or {}
        band = hll.get("rel_err_p90")
        band_txt = f" (±{100.0 * band:.1f}% p90)" if band else ""
        for (fw, acl), entries in by_acl.items():
            out.append(f"\n== {fw} / {acl} ==")
            for e in entries:
                tag = "implicit-deny" if e["index"] == 0 else f"rule {e['index']}"
                extra = ""
                if "unique_sources" in e:
                    extra = f"  uniq_src~{e['unique_sources']}{band_txt}"
                out.append(f"  {tag:>14}: {e['hits']:>12}{extra}  | {e['text']}")
        if hll.get("hint"):
            out.append(f"\n# hint: {hll['hint']}")
        win = t.get("window") or {}
        if win.get("incomplete"):
            inc = win["incomplete"]
            out.append(
                f"\n# WINDOW INCOMPLETE: {inc.get('drops', 0)} line(s) "
                f"dropped ({', '.join(inc.get('reasons', []))}) — zero-hit "
                "rules in this window are NOT deletion evidence"
            )
        if t.get("quarantine"):
            q = t["quarantine"]
            out.append(
                f"\n# quarantined (rules removed by a live reload, counters "
                f"preserved): {q['hits']} hits across {len(q['rules'])} rule(s)"
            )
        out.append(f"\n# unused rules: {len(self.unused)}")
        # static-analysis join (runtime/staticanalysis.py): every unused
        # rule prints with its evidence class, so "no hits observed" is
        # never mistaken for "provably dead" (or vice versa)
        st = t.get("static") or {}
        cls_of: dict[str, str] = {}
        for cls, label in (
            ("safe_to_delete", "provably dead — safe to delete"),
            ("traffic_dependent", "reachable — traffic-dependent"),
            ("undecided", "undecided — witness budget exhausted"),
        ):
            for rule in (st.get("unused_classes") or {}).get(cls, []):
                cls_of[rule] = label
        for fw, acl, idx in self.unused:
            tag = cls_of.get(f"{fw} {acl} {idx}")
            out.append(
                f"  UNUSED {fw} {acl} rule {idx}"
                + (f"  [{tag}]" if tag else "")
            )
        if st:
            sm = st.get("meta", {})
            out.append(
                f"\n# static analysis: {sm.get('dead', 0)} provably dead "
                f"rule(s) of {sm.get('n_rules', 0)} "
                f"({sm.get('witnesses_checked', 0)} witness packets "
                "device-checked)"
            )
            for c in st.get("contradictions", []):
                out.append(
                    f"# CONTRADICTION: {c['rule']} has {c['hits']} hit(s) "
                    f"but a dead '{c['verdict']}' verdict — counters span "
                    "a ruleset reload, or the analyzer is wrong"
                )
        return "\n".join(out)


def build_report(
    packed: PackedRuleset,
    hits: dict[RuleKey, int],
    *,
    backend: str,
    totals: dict[str, Any] | None = None,
    unique_sources: dict[RuleKey, int] | None = None,
    talkers: dict[tuple[str, str], list[tuple[int, int]]] | None = None,
) -> Report:
    """Assemble the report from per-key hits (exact or estimated)."""
    from ..hostside.aclparse import u32_to_ip

    per_rule = []
    unused: list[RuleKey] = []
    for key_id, meta in enumerate(packed.key_meta):
        key: RuleKey = (meta.firewall, meta.acl, meta.index)
        h = int(hits.get(key, 0))
        entry = {
            "firewall": meta.firewall,
            "acl": meta.acl,
            "index": meta.index,
            "key_id": key_id,
            "hits": h,
            "text": meta.text,
        }
        if unique_sources is not None and key in unique_sources:
            entry["unique_sources"] = int(unique_sources[key])
        per_rule.append(entry)
        if not meta.implicit_deny and h == 0:
            unused.append(key)
    talk = {}
    for (fw, acl), items in (talkers or {}).items():
        # items carry uint32 v4 addresses OR pre-rendered labels (IPv6
        # talkers arrive as address/digest strings from pipeline.finalize)
        talk[f"{fw} {acl}"] = [
            [ip if isinstance(ip, str) else u32_to_ip(int(ip)), int(c)]
            for ip, c in items
        ]
    t = dict(totals or {})
    t["backend"] = backend
    t["n_rules"] = packed.n_rules
    t["n_unused"] = len(unused)
    if packed.parse_skips:
        # lenient-mode parse skips: the report must say the source config
        # wasn't fully parsed (those rules were never analyzable)
        t["config_entries_skipped"] = len(packed.parse_skips)
    return Report(per_rule=per_rule, unused=unused, totals=t, talkers=talk)

