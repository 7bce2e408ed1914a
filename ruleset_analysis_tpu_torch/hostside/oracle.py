"""The exact oracle: reference mapper/reducer semantics in pure Python.

This is a direct, trivially-auditable implementation of the reference's hot
path (SURVEY.md §4.3/§4.4): per log line, linear first-match scan over the
named ACL's expanded ACEs in configuration order; per matched configured
rule, an exact hit count.  It is deliberately written against the *parsed*
:class:`Ruleset` objects — NOT the packed tensors — so it is an independent
yardstick for the device path (SURVEY.md §5 "golden semantics tests") and the
stand-in for the reference's exact Hadoop run when measuring unused-rule
recall.

It also computes the exact versions of every sketched statistic:
per-rule unique-source cardinality and per-ACL top talkers.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from collections.abc import Iterable

from .aclparse import Ruleset
from .syslog import ParsedLine, parse_line

#: Key identifying one configured rule: (firewall, acl, 1-based rule index).
#: Index 0 means the ACL's implicit deny.
RuleKey = tuple[str, str, int]


@dataclasses.dataclass
class OracleResult:
    """Exact analysis results (the reduce output + report inputs)."""

    hits: Counter  # RuleKey -> exact hit count
    sources: dict  # RuleKey -> set of src IPs (exact cardinality)
    talkers: dict  # (firewall, acl) -> Counter of src IPs
    lines_total: int = 0
    lines_matched: int = 0
    lines_skipped: int = 0

    def unused_rules(self, rulesets: Iterable[Ruleset]) -> list[RuleKey]:
        """Configured rules with zero hits, in configuration order."""
        out = []
        for rs in rulesets:
            for acl, rules in rs.acls.items():
                for rule in rules:
                    key = (rs.firewall, acl, rule.index)
                    if self.hits.get(key, 0) == 0:
                        out.append(key)
        return out


class Oracle:
    """Streaming exact analyzer over parsed rulesets."""

    def __init__(self, rulesets: list[Ruleset]):
        self.by_fw = {rs.firewall: rs for rs in rulesets}
        self.rulesets = rulesets
        self.result = OracleResult(
            hits=Counter(), sources=defaultdict(set), talkers=defaultdict(Counter)
        )

    def resolve_acls(self, p: ParsedLine) -> list[tuple[Ruleset, str]]:
        """Every ACL this line is evaluated against (possibly two).

        A connection message is filtered by the ingress interface's ``in``
        ACL and, independently, by the egress interface's ``out`` ACL —
        one evaluation each, exactly like LinePacker.resolve_gids.
        """
        rs = self.by_fw.get(p.firewall)
        if rs is None:
            return []
        if p.acl is not None:
            return [(rs, p.acl)] if p.acl in rs.acls else []
        out: list[tuple[Ruleset, str]] = []
        if p.ingress_if is not None:
            acl = rs.bindings.get((p.ingress_if, "in"))
            if acl is not None and acl in rs.acls:
                out.append((rs, acl))
        if p.egress_if is not None:
            acl = rs.bindings.get((p.egress_if, "out"))
            if acl is not None and acl in rs.acls:
                out.append((rs, acl))
        return out

    def resolve_acl(self, p: ParsedLine) -> tuple[Ruleset, str] | None:
        """First resolved ACL (compatibility helper; prefer resolve_acls)."""
        acls = self.resolve_acls(p)
        return acls[0] if acls else None

    def _match_one(self, rs: Ruleset, acl: str, p: ParsedLine) -> RuleKey:
        for rule in rs.acls[acl]:
            for ace in rule.aces:
                if ace.matches(p.proto, p.src, p.sport, p.dst, p.dport, p.family):
                    return (rs.firewall, acl, rule.index)
        return (rs.firewall, acl, 0)  # implicit deny

    def match_keys(self, p: ParsedLine) -> list[RuleKey]:
        """First-match key per resolved ACL evaluation (empty = skipped)."""
        return [self._match_one(rs, acl, p) for rs, acl in self.resolve_acls(p)]

    def match_line(self, p: ParsedLine) -> RuleKey | None:
        """First evaluation's key (compatibility helper; prefer match_keys)."""
        keys = self.match_keys(p)
        return keys[0] if keys else None

    def _fold(self, p: ParsedLine | None) -> None:
        r = self.result
        r.lines_total += 1
        keys = [] if p is None else self.match_keys(p)
        if not keys:
            r.lines_skipped += 1
            return
        # lines_matched counts ACL evaluations (a dual-bound connection
        # line contributes two), matching the packers' `parsed` counter.
        # Source identity is (family, address): a v4 address and a v6
        # address with equal low bits (10.0.0.1 vs ::a00:1) are DISTINCT
        # sources and must not merge in exact sets/counters.
        for key in keys:
            r.lines_matched += 1
            r.hits[key] += 1
            r.sources[key].add((p.family, p.src))
            r.talkers[(key[0], key[1])][(p.family, p.src)] += 1

    def consume(self, lines: Iterable[str]) -> OracleResult:
        for line in lines:
            self._fold(parse_line(line))
        return self.result

    def consume_parsed(self, parsed: Iterable[ParsedLine]) -> OracleResult:
        for p in parsed:
            self._fold(p)
        return self.result


def unused_rule_recall(exact_unused: list[RuleKey], estimated_unused: list[RuleKey]) -> float:
    """Fraction of the exact run's unused rules the estimated run also found.

    This is the headline accuracy metric (BASELINE.md: >=99% unused-ACL
    recall vs the exact run).
    """
    if not exact_unused:
        return 1.0
    est = set(estimated_unused)
    return sum(1 for k in exact_unused if k in est) / len(exact_unused)
