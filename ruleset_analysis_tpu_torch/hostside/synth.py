"""Synthetic ASA configs and syslog — test fixtures and benchmark feedstock.

A copy of the reference's ``hostside/synth.py``, cut to the v4 text tier
the port's slice drives (``synth_config``, ``synth_tuples``,
``render_syslog``, ``synth_syslog_file``).  Same seeds give the same
configs and lines as the reference.

Generation intent here is only a *bias* — ground truth for every test
comes from the oracle, never from the generator — so overlapping rules
shadowing each other can't make expectations silently wrong.
"""

from __future__ import annotations

import numpy as np

from .aclparse import u32_to_ip
from .pack import (
    PackedRuleset,
    R_ACL,
    R_DHI,
    R_DLO,
    R_DPHI,
    R_DPLO,
    R_PHI,
    R_PLO,
    R_SHI,
    R_SLO,
    R_SPHI,
    R_SPLO,
    T_VALID,
    TUPLE_COLS,
    NO_ACL,
)

_COMMON_PROTOS = np.array([6, 6, 6, 17, 17, 1], dtype=np.uint32)


def synth_config(
    n_acls: int = 4,
    rules_per_acl: int = 32,
    n_groups: int = 4,
    seed: int = 0,
    hostname: str = "fw1",
    egress_acls: bool = False,
    v6_fraction: float = 0.0,
) -> str:
    """Generate ASA configuration text with object-groups and varied ACEs.

    ``v6_fraction`` > 0 spells that share of ACEs with IPv6 operands
    (any6 / host literals / prefixes) — the unified-ACL tier; 0 (the
    default) keeps every historical fixture bit-identical.
    """
    rng = np.random.default_rng(seed)
    lines = [f"hostname {hostname}", "!"]

    group_names = []
    for g in range(n_groups):
        name = f"NETGRP{g}"
        group_names.append(name)
        lines.append(f"object-group network {name}")
        for _ in range(int(rng.integers(2, 5))):
            if rng.random() < 0.5:
                lines.append(f" network-object host 10.{g}.{rng.integers(0,255)}.{rng.integers(1,255)}")
            else:
                lines.append(f" network-object 172.{16+g}.{rng.integers(0,255)}.0 255.255.255.0")
    lines.append("object-group service WEBPORTS tcp")
    lines.append(" port-object eq 80")
    lines.append(" port-object eq 443")
    lines.append(" port-object range 8000 8100")

    protos = ["tcp", "udp", "ip", "icmp"]
    for a in range(n_acls):
        acl = f"ACL{a}"
        for r in range(rules_per_acl):
            action = "permit" if rng.random() < 0.7 else "deny"
            proto = protos[int(rng.integers(0, len(protos)))]
            if v6_fraction and rng.random() < v6_fraction:
                # v6 ACE: any6 / host literal / prefix operands
                roll = rng.random()
                if roll < 0.3:
                    src = "any6"
                elif roll < 0.65:
                    src = f"host 2001:db8:{a:x}::{rng.integers(1, 0xFFFF):x}"
                else:
                    src = f"2001:db8:{rng.integers(0, 16):x}::/{int(rng.choice([48, 64, 96]))}"
                if rng.random() < 0.4:
                    dst = "any6"
                else:
                    dst = f"2001:db8:{rng.integers(0, 16):x}:1::/{int(rng.choice([64, 80]))}"
                if proto == "icmp":
                    proto = "icmp6"
                port = ""
                if proto in ("tcp", "udp") and rng.random() < 0.4:
                    port = f" eq {rng.integers(1, 1024)}"
                lines.append(
                    f"access-list {acl} extended {action} {proto} {src} {dst}{port}"
                )
                continue
            # source
            roll = rng.random()
            if roll < 0.25:
                src = "any"
            elif roll < 0.5:
                src = f"object-group {group_names[int(rng.integers(0, n_groups))]}"
            elif roll < 0.75:
                src = f"host 192.168.{a}.{rng.integers(1, 255)}"
            else:
                src = f"10.{rng.integers(0, 32)}.0.0 255.255.0.0"
            # destination
            if rng.random() < 0.4:
                dst = "any"
            else:
                dst = f"198.51.{rng.integers(0, 100)}.0 255.255.255.0"
            # destination port spec
            port = ""
            if proto in ("tcp", "udp"):
                roll = rng.random()
                if roll < 0.3:
                    port = f" eq {rng.integers(1, 1024)}"
                elif roll < 0.5:
                    lo = int(rng.integers(1024, 30000))
                    port = f" range {lo} {lo + int(rng.integers(1, 5000))}"
                elif proto == "tcp" and roll < 0.6:
                    port = " object-group WEBPORTS"
            lines.append(f"access-list {acl} extended {action} {proto} {src} {dst}{port}")
        lines.append(f"access-group ACL{a} in interface if{a}")
        if egress_acls:
            # the same ACL also filters traffic EXITING interface eg{a}:
            # connection lines whose egress side is eg{a} get a second
            # evaluation against it (SURVEY.md §4.3 mapper semantics)
            lines.append(f"access-group ACL{a} out interface eg{a}")
    return "\n".join(lines) + "\n"


def synth_tuples(
    packed: PackedRuleset,
    n: int,
    seed: int = 0,
    miss_fraction: float = 0.1,
) -> np.ndarray:
    """Vectorized batch of packed tuples biased to hit real rules.

    A ``miss_fraction`` of lines draw fully random field values (mostly
    landing in implicit deny), the rest sample inside a random expanded
    ACE's ranges.
    """
    rng = np.random.default_rng(seed)
    rules = packed.rules.astype(np.int64)
    real = rules[:, R_ACL] != int(NO_ACL)
    rules = rules[real]
    if rules.shape[0] == 0:
        raise ValueError("packed ruleset has no rules")
    pick = rng.integers(0, rules.shape[0], size=n)
    rr = rules[pick]

    def _within(lo_col: int, hi_col: int) -> np.ndarray:
        lo, hi = rr[:, lo_col], rr[:, hi_col]
        return rng.integers(lo, hi + 1)

    proto = _within(R_PLO, R_PHI)
    full_proto = (rr[:, R_PLO] == 0) & (rr[:, R_PHI] == 255)
    proto = np.where(full_proto, rng.choice(_COMMON_PROTOS, size=n).astype(np.int64), proto)

    out = np.zeros((n, TUPLE_COLS), dtype=np.uint32)
    out[:, 0] = rr[:, R_ACL].astype(np.uint32)
    out[:, 1] = proto.astype(np.uint32)
    out[:, 2] = _within(R_SLO, R_SHI).astype(np.uint32)
    out[:, 3] = _within(R_SPLO, R_SPHI).astype(np.uint32)
    out[:, 4] = _within(R_DLO, R_DHI).astype(np.uint32)
    out[:, 5] = _within(R_DPLO, R_DPHI).astype(np.uint32)
    out[:, T_VALID] = 1

    miss = rng.random(n) < miss_fraction
    n_miss = int(miss.sum())
    if n_miss:
        out[miss, 1] = rng.integers(0, 256, size=n_miss)
        out[miss, 2] = rng.integers(0, 1 << 32, size=n_miss, dtype=np.uint32)
        out[miss, 3] = rng.integers(0, 1 << 16, size=n_miss)
        out[miss, 4] = rng.integers(0, 1 << 32, size=n_miss, dtype=np.uint32)
        out[miss, 5] = rng.integers(0, 1 << 16, size=n_miss)
    return out


def synth_syslog_file(
    packed: PackedRuleset,
    path: str,
    n_lines: int,
    seed: int = 0,
    miss_fraction: float = 0.1,
    chunk: int = 1 << 18,
) -> None:
    """Write ``n_lines`` of synthetic ASA syslog text to ``path``.

    Chunked generation keeps memory bounded; the text round-trips the real
    parse path (text tier), so this is the feedstock for end-to-end
    benchmarks and tests.
    """
    with open(path, "w", encoding="utf-8") as f:
        remaining = n_lines
        i = 0
        while remaining > 0:
            m = min(chunk, remaining)
            t = synth_tuples(packed, m, seed=seed + i, miss_fraction=miss_fraction)
            f.write("\n".join(render_syslog(packed, t, seed=seed + i)))
            f.write("\n")
            remaining -= m
            i += 1


_PROTO_NAMES = {6: "tcp", 17: "udp", 1: "icmp", 58: "icmp6"}



def _variety_line(
    timestamp: str, fw: str, acl: str, pname: str, proto: int,
    src: str, dst: str, sport: int, dport: int,
    iface, out_ifaces: dict, pick: int, icmp_protos: tuple,
) -> str:
    """One non-106100 message line (shared by both family renderers).

    Eligibility mirrors what the parsers can resolve: 106023 always
    (names the ACL); the connection/deny classes need a resolvable
    ingress interface and a TCP/UDP protocol.  ``icmp_protos`` is the
    family's ICMP set ((1,) for v4, (1, 58) for v6) for the 106023
    type/code rendering.
    """
    eligible = ["106023"]
    if iface is not None and proto in (6, 17):
        eligible.append("302013")
        eligible.append("106001" if proto == 6 else "106006")
        if proto == 6:
            eligible.append("106015")
    kind = eligible[pick % len(eligible)]
    if kind == "106023":
        if proto in icmp_protos:
            ep = f"src inside:{src} dst outside:{dst} (type {dport}, code 0)"
        else:
            ep = f"src inside:{src}/{sport} dst outside:{dst}/{dport}"
        return (
            f'{timestamp} {fw} : %ASA-4-106023: Deny {pname} {ep} '
            f'by access-group "{acl}" [0x0, 0x0]'
        )
    if kind == "302013":
        egs = out_ifaces.get(fw)
        egress = egs[pick % len(egs)] if egs else "outside"
        tname = "TCP" if proto == 6 else "UDP"
        mid = "302013" if proto == 6 else "302015"
        return (
            f"{timestamp} {fw} : %ASA-6-{mid}: Built inbound {tname} "
            f"connection {pick} for {iface}:{src}/{sport} "
            f"({src}/{sport}) to {egress}:{dst}/{dport} ({dst}/{dport})"
        )
    if kind == "106001":
        return (
            f"{timestamp} {fw} : %ASA-2-106001: Inbound TCP connection "
            f"denied from {src}/{sport} to {dst}/{dport} flags SYN "
            f"on interface {iface}"
        )
    if kind == "106015":
        return (
            f"{timestamp} {fw} : %ASA-6-106015: Deny TCP (no connection) "
            f"from {src}/{sport} to {dst}/{dport} flags RST "
            f"on interface {iface}"
        )
    return (
        f"{timestamp} {fw} : %ASA-2-106006: Deny inbound UDP "
        f"from {src}/{sport} to {dst}/{dport} on interface {iface}"
    )


def render_syslog(
    packed: PackedRuleset,
    tuples: np.ndarray,
    seed: int = 0,
    timestamp: str = "Jul 29 07:48:01",
    variety: float = 0.0,
) -> list[str]:
    """Render packed tuples back into raw ASA syslog text.

    By default every valid tuple renders as a 106100 line (names the ACL
    directly — no binding inverse needed).  With ``variety`` > 0, that
    fraction of eligible lines render as other handled message classes
    (106023, 302013, 106001, 106006, 106015), constrained by protocol and
    by which interfaces the packed bindings make resolvable.  A 302013
    rendered with an out-bound egress interface yields TWO evaluations
    downstream — the oracle remains ground truth for every statistic.
    """
    gid_to_name = {gid: (fw, acl) for (fw, acl), gid in packed.acl_gid.items()}
    # binding inverses: (fw, gid) -> an ingress iface; fw -> egress ifaces
    in_iface = {}
    for (fw, iface), gid in packed.bindings.items():
        in_iface.setdefault((fw, gid), iface)
    out_ifaces: dict[str, list[str]] = {}
    for (fw, iface), _gid in packed.bindings_out.items():
        out_ifaces.setdefault(fw, []).append(iface)
    rng = np.random.default_rng(seed)
    verdicts = rng.random(tuples.shape[0])
    kinds = rng.random(tuples.shape[0])
    picks = rng.integers(0, 1 << 30, size=tuples.shape[0])
    out = []
    for i, row in enumerate(tuples):
        if not row[T_VALID]:
            out.append(f"{timestamp} noise : not an ASA message")
            continue
        gid = int(row[0])
        fw, acl = gid_to_name[gid]
        proto = int(row[1])
        pname = _PROTO_NAMES.get(proto, str(proto))
        src, dst = u32_to_ip(int(row[2])), u32_to_ip(int(row[4]))
        sport, dport = int(row[3]), int(row[5])
        iface = in_iface.get((fw, gid))

        if variety and kinds[i] < variety:
            out.append(_variety_line(
                timestamp, fw, acl, pname, proto, src, dst, sport, dport,
                iface, out_ifaces, int(picks[i]), icmp_protos=(1,),
            ))
            continue

        verdict = "permitted" if verdicts[i] < 0.8 else "denied"
        if proto == 1:
            # icmp: type travels in the dport column; render as (type)(code 0)
            paren_s, paren_d = dport, 0
        else:
            paren_s, paren_d = sport, dport
        out.append(
            f"{timestamp} {fw} : %ASA-6-106100: access-list {acl} {verdict} {pname} "
            f"inside/{src}({paren_s}) -> outside/{dst}({paren_d}) hit-cnt 1 first hit [0x0, 0x0]"
        )
    return out
