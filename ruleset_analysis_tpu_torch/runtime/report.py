"""The unused-rule report — the reference's L5 layer (SURVEY.md §2, §4.5).

A copy of the reference's ``runtime/report.py``: ``Report`` and
``build_report``, the report diff behind ``diff-reports`` and its window checks,
the window lineage record's seal and frontier (``doctor --lineage``) and
the per-rule trend events.  The port's reports must equal the
reference's apart from ``VOLATILE_TOTALS`` and ``totals.backend``; the
diff, the seal, the frontier and the trend events are the reference's
bit for bit.

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
import zlib
from typing import Any

from ..errors import AnalysisError
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


# ---------------------------------------------------------------------------
# Report diffing: the operator's delete-decision view, behind the
# ``diff-reports`` command (and the reference's serve mode's
# window-over-window publication).
# ---------------------------------------------------------------------------


def _hits_by_key(rep: dict) -> dict:
    return {(e["firewall"], e["acl"], e["index"]): e["hits"] for e in rep.get("per_rule", [])}


def _key_str(k) -> str:
    return f"{k[0]} {k[1]} {k[2]}"


def diff_report_objs(old: dict, new: dict, top: int = 10) -> dict:
    """Diff two report JSON objects (the ``run --json`` or serve window shape).

    Rules unused in both reports are the stable deletion candidates;
    newly-unused and newly-used rules are the churn to investigate.  Only
    rules present in both reports compare: ruleset churn is reported
    separately, so a deleted rule never reads as "newly used".
    """
    hits_a, hits_b = _hits_by_key(old), _hits_by_key(new)
    unused_a = {tuple(k) for k in old.get("unused", [])}
    unused_b = {tuple(k) for k in new.get("unused", [])}
    common = set(hits_a) & set(hits_b)
    movers = sorted(((abs(hits_b[k] - hits_a[k]), k) for k in common), reverse=True)[:top]
    out = {
        "stable_unused": [_key_str(k) for k in sorted(unused_a & unused_b & common)],
        "newly_unused": [_key_str(k) for k in sorted((unused_b - unused_a) & common)],
        "newly_used": [_key_str(k) for k in sorted((unused_a - unused_b) & common)],
        "rules_added": [_key_str(k) for k in sorted(set(hits_b) - common)],
        "rules_removed": [_key_str(k) for k in sorted(set(hits_a) - common)],
        "top_hit_movers": [
            {"rule": _key_str(k), "old": hits_a[k], "new": hits_b[k]}
            for d, k in movers
            if d > 0
        ],
    }
    # when both reports carry static-analysis verdicts, a rule moving
    # reachable -> shadowed across a ruleset change is a typed row: the
    # operator must see that a rule died, not only a count change
    verd_a, verd_b = (
        {(e["firewall"], e["acl"], e["index"]): e["verdict"]
         for e in rep.get("per_rule", []) if "verdict" in e}
        for rep in (old, new)
    )
    if verd_a and verd_b:
        out["verdict_transitions"] = [
            {"rule": _key_str(k), "old": verd_a[k], "new": verd_b[k]}
            for k in sorted(set(verd_a) & set(verd_b) & common)
            if verd_a[k] != verd_b[k]
        ]
    # serve window reports: a diff over a lossy window is never clean churn
    inc = [
        label
        for label, rep in (("old", old), ("new", new))
        if (rep.get("totals", {}).get("window") or {}).get("incomplete")
    ]
    if inc:
        out["window_incomplete"] = inc
    return out


def window_of(rep: dict) -> tuple[str, float] | None:
    """``(mode, length)`` of a report's analysis window, or None.

    Batch reports carry no window; serve window reports carry
    ``totals.window.mode/length/id``; merged or cumulative serve views
    carry a window block without one length and give None too (they are
    not same-window comparable as they are).
    """
    win = rep.get("totals", {}).get("window") or {}
    if "mode" in win and "length" in win and "id" in win:
        return (str(win["mode"]), float(win["length"]))
    return None


def parse_window_spec(spec: str) -> tuple[str, float]:
    """``lines:N`` / ``900s`` / ``15m`` / ``24h`` / ``7d`` -> (mode, length)."""
    s = spec.strip().lower()
    if s.startswith("lines:"):
        try:
            n = int(s[len("lines:"):])
        except ValueError as e:
            raise AnalysisError(f"bad window spec {spec!r}") from e
        if n < 1:
            raise AnalysisError(f"window line count must be >= 1, got {n}")
        return ("lines", float(n))
    mult = 1.0
    if s and s[-1] in "smhd":
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}[s[-1]]
        s = s[:-1]
    try:
        sec = float(s) * mult
    except ValueError as e:
        raise AnalysisError(
            f"bad window spec {spec!r} (want lines:N or a duration like "
            "900s / 15m / 24h)"
        ) from e
    if sec <= 0:
        raise AnalysisError(f"window duration must be > 0, got {spec!r}")
    return ("sec", sec)


def check_window_compat(old: dict, new: dict, expect: str) -> None:
    """A typed refusal when the two reports' windows are not ``expect``.

    A 24h window diffed against a 7d window is misleading (every rule
    quiet in 24h reads as newly unused), so ``diff-reports
    --expect-window`` makes that mistake an error instead of an answer.
    """
    want = parse_window_spec(expect)
    for label, rep in (("old", old), ("new", new)):
        got = window_of(rep)
        if got is None:
            raise AnalysisError(
                f"--expect-window {expect}: the {label} report carries no "
                "per-window metadata (not a serve window report, or a "
                "merged/cumulative view)"
            )
        if got != want:
            raise AnalysisError(
                f"--expect-window {expect}: the {label} report's window is "
                f"{got[0]}:{got[1]:g}, expected {want[0]}:{want[1]:g} — "
                "reports from different window lengths are not comparable"
            )


# ---------------------------------------------------------------------------
# Window lineage.  A published window's provenance record: who contributed
# (hosts, delivered WAL seq ranges, loss accounting), which supervisor term
# published it and by which path (live | replay | backlog_heal).  The core
# of the record, all but how and when it was published, is a deterministic
# function of the delivered lines, so a failover republication reproduces
# it bit for bit; term, path and publish stamp are the volatile envelope.
# ---------------------------------------------------------------------------

#: lineage fields that differ between a live publication and a failover
#: replay of the same window (the replay-identity law strips exactly these)
LINEAGE_VOLATILE = ("term", "path", "published_unix", "crc")


def lineage_core(rec: dict) -> dict:
    """The deterministic core: the record without its volatile envelope."""
    return {k: v for k, v in rec.items() if k not in LINEAGE_VOLATILE}


def seal_lineage(rec: dict) -> dict:
    """Stamp ``crc`` = CRC32 of the canonical-JSON core, in place.

    The CRC covers only the core, so replay-identical windows carry equal
    CRCs though their term and path differ: one u32 equality audits "same
    evidence, another publisher".
    """
    core = json.dumps(lineage_core(rec), sort_keys=True, separators=(",", ":")).encode("utf-8")
    rec["crc"] = zlib.crc32(core) & 0xFFFFFFFF
    return rec


def lineage_frontier(records: list[dict]) -> dict:
    """Where publication stopped, from a lineage log (``doctor``'s join).

    The last window published with complete evidence (no incomplete
    marker), the first window missing from the log or carrying an
    incomplete marker, and the contiguity gaps: what a postmortem needs
    before it replays anything.
    """
    by_window: dict[int, dict] = {}
    for r in records:
        if isinstance(r.get("window"), int) and r.get("kind") != "merged":
            by_window[r["window"]] = r  # the last write wins (a replay republish)
    if not by_window:
        return {"windows": 0, "last_complete": None, "first_incomplete": None, "gaps": []}
    ids = sorted(by_window)
    gaps = [w for w in range(ids[0], ids[-1] + 1) if w not in by_window]
    last_complete = None
    first_incomplete = gaps[0] if gaps else None
    for w in ids:
        if by_window[w].get("incomplete"):
            if first_incomplete is None or w < first_incomplete:
                first_incomplete = w
        else:
            last_complete = w
    return {
        "windows": len(ids),
        "last_complete": last_complete,
        "first_incomplete": first_incomplete,
        "gaps": gaps,
    }


# ---------------------------------------------------------------------------
# Per-rule trend events.  A rule whose hit rate jumps or collapses window
# over window is churn to investigate before a deletion decision cites the
# report.  The threshold is multiplicative with a minimum-hits floor, and
# the caller keeps a per-rule state dict, so a ramp over many windows emits
# one event per transition and steady load emits nothing.
# ---------------------------------------------------------------------------

#: below this many hits in both windows a rule's ratio is noise, not a
#: trend (a 0 -> 3 hop would read as an infinite burst)
TREND_MIN_HITS = 32


def trend_events(
    old: dict,
    new: dict,
    *,
    threshold: float,
    state: dict,
    min_hits: int = TREND_MIN_HITS,
) -> list[dict]:
    """Per-rule hit-rate events between consecutive window reports.

    ``rule_burst``: the new rate exceeds ``threshold`` x the old rate and
    the new window has >= ``min_hits`` hits.  ``rule_quiet``: the old
    window had >= ``min_hits`` hits and the new rate fell under old /
    ``threshold``.  Rates normalise by each window's delivered lines, so
    an ingest lull does not read as every rule going quiet.  ``state``
    maps a rule key to its last emitted label; an event is returned only
    when the label changes (hysteresis: no storm of "still bursting").
    """

    def load(rep: dict) -> tuple[dict, float]:
        hits = {k: int(h) for k, h in _hits_by_key(rep).items()}
        lines = float(rep.get("totals", {}).get("lines_total") or 0.0)
        return hits, max(lines, 1.0)

    hits_a, lines_a = load(old)
    hits_b, lines_b = load(new)
    events: list[dict] = []
    for k in sorted(set(hits_a) & set(hits_b)):
        ha, hb = hits_a[k], hits_b[k]
        ra, rb = ha / lines_a, hb / lines_b
        label = None
        if hb >= min_hits and rb > ra * threshold:
            label = "rule_burst"
        elif ha >= min_hits and rb < ra / threshold:
            label = "rule_quiet"
        ks = _key_str(k)
        prev = state.get(ks)
        if label is None:
            # back inside the band: clear the state, so a later burst of
            # the same rule is a fresh transition, and emit nothing
            if prev is not None:
                state.pop(ks, None)
            continue
        if label == prev:
            continue  # still bursting or quiet: hysteresis swallows it
        state[ks] = label
        events.append({
            "event": label,
            "rule": ks,
            "old_hits": ha,
            "new_hits": hb,
            "old_rate": round(ra, 9),
            "new_rate": round(rb, 9),
        })
    return events
