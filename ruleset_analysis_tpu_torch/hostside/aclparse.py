"""Cisco ASA access-list parser with object-group expansion.

This is the host half of the reference's L1 layer (``getaccesslists.py``,
SURVEY.md §3/§4.1): read an ASA configuration, extract ``access-list`` lines,
resolve ``object-group`` / ``object`` references, and expand each configured
rule into concrete match rows.

Design decision for the device rebuild (SURVEY.md §8.0): every matchable field
is normalised to an **inclusive uint32 range** ``[lo, hi]`` —

- addresses: ``host A`` -> [a, a]; ``NET MASK`` -> [net, net | ~mask];
  ``range A B`` -> [a, b]; ``any`` -> [0, 2**32-1]
- ports: ``eq p`` -> [p, p]; ``range a b``; ``gt p``; ``lt p``; ``neq p``
  (expands into two rows); absent -> [0, 65535]
- protocols: ``tcp`` -> [6, 6]; ``ip`` -> [0, 255]
- ICMP types are carried in the destination-port column ([type, type]),
  mirroring how the syslog parser packs ICMP messages.

so the device-side predicate is five branch-free range tests.  One configured
rule (one config line — the unit the unused-rule report counts) expands into
the cross-product of its object-group alternatives, exactly as the reference
expands groups on the host before shipping rules to map tasks.
"""

from __future__ import annotations

import dataclasses
import re

PERMIT, DENY = 1, 0

U32_MAX = 0xFFFFFFFF
U128_MAX = (1 << 128) - 1
PORT_MAX = 0xFFFF

#: Address families.  ``FAM_WILD`` marks a family-agnostic wildcard
#: (``any`` / ``interface``) during expansion; it never survives into an
#: :class:`Ace` — parse_asa_config resolves it per ruleset (v4-only for
#: pure-v4 configs, both families when the ruleset carries explicit v6
#: content — the ASA 9.0+ unified-ACL reading of ``any``, gated so
#: v4-era configs keep their exact pre-v6 expansion).
FAM_WILD, FAM_V4, FAM_V6 = 0, 4, 6

#: IP protocol names ASA accepts in ACEs.
PROTO_NUMBERS = {
    "ip": None,  # any protocol -> [0, 255]
    "icmp": 1,
    "igmp": 2,
    "ipinip": 4,
    "tcp": 6,
    "udp": 17,
    "gre": 47,
    "esp": 50,
    "ah": 51,
    "icmp6": 58,
    "eigrp": 88,
    "ospf": 89,
    "nos": 94,
    "pim": 103,
    "pcp": 108,
    "snp": 109,
    "sctp": 132,
}

#: TCP/UDP service names ASA commonly resolves in port specs.
PORT_NAMES = {
    "echo": 7,
    "discard": 9,
    "daytime": 13,
    "chargen": 19,
    "ftp-data": 20,
    "ftp": 21,
    "ssh": 22,
    "telnet": 23,
    "smtp": 25,
    "time": 37,
    "whois": 43,
    "tacacs": 49,
    "domain": 53,
    "bootps": 67,
    "bootpc": 68,
    "tftp": 69,
    "gopher": 70,
    "finger": 79,
    "http": 80,
    "www": 80,
    "kerberos": 88,
    "hostname": 101,
    "pop2": 109,
    "pop3": 110,
    "sunrpc": 111,
    "ident": 113,
    "nntp": 119,
    "ntp": 123,
    "netbios-ns": 137,
    "netbios-dgm": 138,
    "netbios-ssn": 139,
    "imap4": 143,
    "snmp": 161,
    "snmptrap": 162,
    "bgp": 179,
    "irc": 194,
    "ldap": 389,
    "https": 443,
    "isakmp": 500,
    "exec": 512,
    "login": 513,
    "rsh": 514,
    "syslog": 514,
    "lpd": 515,
    "talk": 517,
    "rip": 520,
    "uucp": 540,
    "klogin": 543,
    "kshell": 544,
    "ldaps": 636,
    "kerberos-adm": 749,
    "pptp": 1723,
    "radius": 1645,
    "radius-acct": 1646,
    "sip": 5060,
    "aol": 5190,
    "pcanywhere-data": 5631,
    "pcanywhere-status": 5632,
}

#: ICMP type names usable after the destination in an icmp ACE.
ICMP_TYPE_NAMES = {
    "echo-reply": 0,
    "unreachable": 3,
    "source-quench": 4,
    "redirect": 5,
    "echo": 8,
    "router-advertisement": 9,
    "router-solicitation": 10,
    "time-exceeded": 11,
    "parameter-problem": 12,
    "timestamp-request": 13,
    "timestamp-reply": 14,
    "information-request": 15,
    "information-reply": 16,
    "mask-request": 17,
    "mask-reply": 18,
    "traceroute": 30,
}

#: ICMPv6 type names (RFC 4443 / 4861) usable after the destination in an
#: ``icmp6`` ACE — the numbers differ from their v4 namesakes (echo-reply
#: is 129, not 0), so icmp6 entries resolve through THIS table.
ICMP6_TYPE_NAMES = {
    "unreachable": 1,
    "packet-too-big": 2,
    "time-exceeded": 3,
    "parameter-problem": 4,
    "echo": 128,
    "echo-reply": 129,
    "membership-query": 130,
    "membership-report": 131,
    "membership-reduction": 132,
    "router-solicitation": 133,
    "router-advertisement": 134,
    "neighbor-solicitation": 135,
    "neighbor-advertisement": 136,
    "neighbor-redirect": 137,
    "router-renumbering": 138,
}

FULL_PORTS = (0, PORT_MAX)
FULL_ADDR = (0, U32_MAX)
FULL_ADDR6 = (0, U128_MAX)
FULL_PROTO = (0, 255)

#: Family-tagged full-range address alternatives ((family, lo, hi) —
#: the shape every address resolver returns).
ANY4 = (FAM_V4, 0, U32_MAX)
ANY6 = (FAM_V6, 0, U128_MAX)
ANY_WILD = (FAM_WILD, 0, 0)  # bounds resolved at family expansion


class AclParseError(ValueError):
    """Raised on configuration text this parser cannot interpret."""


def ip_to_u32(s: str) -> int:
    # v6 literals are parsed by ip6_to_int; reaching here with one means
    # the CONTEXT is v4-only (e.g. a standard ACL) — say so explicitly,
    # the lenient-mode skip accounting surfaces this reason verbatim.
    if ":" in s or s == "any6":
        raise AclParseError(f"IPv6 address in IPv4-only context: {s!r}")
    parts = s.split(".")
    if len(parts) != 4:
        raise AclParseError(f"bad IPv4 address: {s!r}")
    v = 0
    for p in parts:
        # plain ASCII digits only: int() also accepts "+1", "1_0", and
        # Unicode digits, which the native parser (asaparse.cpp
        # parse_ipv4_run — documented ip_to_u32 semantics) rejects; the
        # two paths must agree on every input.  Non-numeric octets (fuzz:
        # "1..2.3") must raise the clean parse error, not a raw
        # ValueError that escapes the lenient-mode skip handler.
        if not (p.isascii() and p.isdigit()):
            raise AclParseError(f"bad IPv4 address: {s!r}")
        b = int(p)
        if not 0 <= b <= 255:
            raise AclParseError(f"bad IPv4 address: {s!r}")
        v = (v << 8) | b
    return v


def u32_to_ip(v: int) -> str:
    return ".".join(str((v >> s) & 0xFF) for s in (24, 16, 8, 0))


def subnet_range(net: str, mask: str) -> tuple[int, int]:
    n, m = ip_to_u32(net), ip_to_u32(mask)
    lo = n & m
    return lo, lo | (~m & U32_MAX)


def ip6_to_int(s: str) -> int:
    """IPv6 literal -> 128-bit int (RFC 4291 text forms, incl. embedded v4).

    Delegates to the stdlib ``ipaddress`` parser — strict (rejects zone
    ids, malformed compressions) and battle-tested; the device side never
    sees text, only the 4x uint32 limbs pack.py derives from this int.
    """
    import ipaddress

    try:
        return int(ipaddress.IPv6Address(s))
    except (ipaddress.AddressValueError, ValueError):
        raise AclParseError(f"bad IPv6 address: {s!r}") from None


def int_to_ip6(v: int) -> str:
    import ipaddress

    return str(ipaddress.IPv6Address(v))


def prefix6_range(tok: str) -> tuple[int, int]:
    """``2001:db8::/64`` -> inclusive [lo, hi].

    The ``/prefixlen`` is REQUIRED: ASA spells v6 network operands as one
    prefix token (never address + mask pairs), and accepting a bare
    literal here would let a v4-style ``ADDR MASK`` v6 spelling silently
    parse as two /128 operands — a mis-parse, not a lenient read.  Bare
    literals are only valid after ``host``.
    """
    if "/" not in tok:
        raise AclParseError(
            f"IPv6 network operand requires /prefixlen (or use host): {tok!r}"
        )
    addr, _, plen_s = tok.partition("/")
    if not (plen_s.isascii() and plen_s.isdigit()) or not 0 <= int(plen_s) <= 128:
        raise AclParseError(f"bad IPv6 prefix length: {tok!r}")
    plen = int(plen_s)
    a = ip6_to_int(addr)
    mask = (U128_MAX << (128 - plen)) & U128_MAX
    lo = a & mask
    return lo, lo | (~mask & U128_MAX)


def _port_value(tok: str) -> int:
    if tok in PORT_NAMES:
        return PORT_NAMES[tok]
    try:
        v = int(tok)
    except ValueError:
        raise AclParseError(f"unknown port {tok!r}") from None
    if not 0 <= v <= PORT_MAX:
        raise AclParseError(f"port out of range: {tok!r}")
    return v


def _proto_ranges(tok: str) -> list[tuple[int, int]]:
    if tok in PROTO_NUMBERS:
        n = PROTO_NUMBERS[tok]
        return [FULL_PROTO] if n is None else [(n, n)]
    try:
        v = int(tok)
    except ValueError:
        raise AclParseError(f"unknown protocol {tok!r}") from None
    if not 0 <= v <= 255:
        raise AclParseError(f"protocol out of range: {tok!r}")
    return [(v, v)]


# ---------------------------------------------------------------------------
# Data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ace:
    """One concrete, fully-expanded match row (all-inclusive ranges).

    ``family`` is FAM_V4 or FAM_V6; address bounds are Python ints (32-
    or 128-bit).  A packet can only match an ACE of its own family —
    pack.py exploits this to split rows into per-family device tensors
    without breaking first-match order (cross-family matches are
    impossible, so the min-matching-row within a family equals the
    min-matching-row overall for that packet).
    """

    action: int  # PERMIT / DENY
    proto_lo: int
    proto_hi: int
    src_lo: int
    src_hi: int
    sport_lo: int
    sport_hi: int
    dst_lo: int
    dst_hi: int
    dport_lo: int
    dport_hi: int
    family: int = FAM_V4

    def matches(
        self, proto: int, src: int, sport: int, dst: int, dport: int,
        family: int = FAM_V4,
    ) -> bool:
        return (
            self.family == family
            and self.proto_lo <= proto <= self.proto_hi
            and self.src_lo <= src <= self.src_hi
            and self.sport_lo <= sport <= self.sport_hi
            and self.dst_lo <= dst <= self.dst_hi
            and self.dport_lo <= dport <= self.dport_hi
        )


@dataclasses.dataclass
class AclRule:
    """One configured access-list entry (one config line).

    This is the unit of the unused-rule report — the reference emits hit
    counts keyed by the configured rule, not by expanded alternative
    (SURVEY.md §4.3/§4.5).
    """

    acl: str
    index: int  # 1-based position among real entries of this ACL
    text: str  # original configuration line
    aces: list[Ace] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Ruleset:
    """All parsed ACLs of one firewall (the L1->L3 contract)."""

    firewall: str
    acls: dict[str, list[AclRule]] = dataclasses.field(default_factory=dict)
    #: (interface name, direction) -> acl name, from ``access-group`` lines.
    #: Keyed by direction too: one interface can carry BOTH an ``in`` and
    #: an ``out`` ACL, and egress bindings are evaluated for connection
    #: messages just like ingress ones.
    bindings: dict[tuple[str, str], str] = dataclasses.field(default_factory=dict)
    #: Lenient-mode skips: (line number, reason, raw line) for every
    #: access-list entry ``parse_asa_config(strict=False)`` could not
    #: support (IPv6, exotic object members, ...).  A skipped entry still
    #: consumes its rule index, so later rules keep their device-side
    #: positions.  Empty in strict mode (errors raise instead).
    skipped: list[tuple[int, str, str]] = dataclasses.field(default_factory=list)

    def rule_count(self) -> int:
        return sum(len(rules) for rules in self.acls.values())

    def ace_count(self) -> int:
        return sum(len(r.aces) for rules in self.acls.values() for r in rules)


# ---------------------------------------------------------------------------
# Object / object-group resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Groups:
    network: dict[str, list] = dataclasses.field(default_factory=dict)
    service: dict[str, dict] = dataclasses.field(default_factory=dict)
    protocol: dict[str, list] = dataclasses.field(default_factory=dict)
    icmp_type: dict[str, list] = dataclasses.field(default_factory=dict)
    net_objects: dict[str, list] = dataclasses.field(default_factory=dict)
    svc_objects: dict[str, list] = dataclasses.field(default_factory=dict)


def _collect_blocks(lines: list[str]) -> tuple[_Groups, list[tuple[int, str]]]:
    """One pass: gather object/object-group blocks; return remaining lines."""
    groups = _Groups()
    rest: list[tuple[int, str]] = []
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].rstrip()
        stripped = line.strip()
        toks = stripped.split()
        if not toks:
            i += 1
            continue
        if toks[0] == "object-group" and len(toks) >= 3:
            kind, name = toks[1], toks[2]
            body: list[list[str]] = []
            i += 1
            while i < n and (lines[i].startswith((" ", "\t"))):
                t = lines[i].split()
                if t and t[0] != "description":
                    body.append(t)
                i += 1
            if kind == "network":
                groups.network[name] = body
            elif kind == "service":
                proto = toks[3] if len(toks) > 3 else None  # tcp|udp|tcp-udp|None
                groups.service[name] = {"proto": proto, "body": body}
            elif kind == "protocol":
                groups.protocol[name] = body
            elif kind == "icmp-type":
                groups.icmp_type[name] = body
            # other kinds (user, security) are not matchable here; ignore
            continue
        if toks[0] == "object" and len(toks) >= 3:
            kind, name = toks[1], toks[2]
            body = []
            i += 1
            while i < n and lines[i].startswith((" ", "\t")):
                t = lines[i].split()
                if t and t[0] != "description":
                    body.append(t)
                i += 1
            if kind == "network":
                groups.net_objects[name] = body
            elif kind == "service":
                groups.svc_objects[name] = body
            continue
        rest.append((i + 1, stripped))
        i += 1
    return groups, rest


def _host_triple(tok: str) -> tuple[int, int, int]:
    """``host`` operand -> (family, lo, hi); family by v6 colon literal."""
    if ":" in tok:
        a = ip6_to_int(tok)
        return (FAM_V6, a, a)
    a = ip_to_u32(tok)
    return (FAM_V4, a, a)


def _resolve_network_group(
    groups: _Groups, name: str, _seen=None
) -> list[tuple[int, int, int]]:
    if _seen is None:
        _seen = set()
    if name in _seen:
        raise AclParseError(f"object-group cycle via {name!r}")
    if name not in groups.network:
        raise AclParseError(f"unknown network object-group {name!r}")
    _seen.add(name)
    out: list[tuple[int, int, int]] = []
    for toks in groups.network[name]:
        if toks[0] == "network-object":
            if toks[1] == "host":
                out.append(_host_triple(toks[2]))
            elif toks[1] == "object":
                out.extend(_resolve_network_object(groups, toks[2]))
            elif ":" in toks[1]:
                # v6 members are spelled as a single prefix token
                out.append((FAM_V6, *prefix6_range(toks[1])))
            else:
                out.append((FAM_V4, *subnet_range(toks[1], toks[2])))
        elif toks[0] == "group-object":
            out.extend(_resolve_network_group(groups, toks[1], _seen))
        else:
            raise AclParseError(f"unsupported network-group member: {' '.join(toks)!r}")
    _seen.discard(name)
    return out


def _resolve_network_object(groups: _Groups, name: str) -> list[tuple[int, int, int]]:
    if name not in groups.net_objects:
        raise AclParseError(f"unknown network object {name!r}")
    out = []
    for toks in groups.net_objects[name]:
        if toks[0] == "host":
            out.append(_host_triple(toks[1]))
        elif toks[0] == "subnet":
            if ":" in toks[1]:
                # v6 subnets are one prefix token (``subnet 2001:db8::/64``)
                out.append((FAM_V6, *prefix6_range(toks[1])))
            else:
                out.append((FAM_V4, *subnet_range(toks[1], toks[2])))
        elif toks[0] == "range":
            if ":" in toks[1] or ":" in toks[2]:
                lo, hi = ip6_to_int(toks[1]), ip6_to_int(toks[2])
                fam = FAM_V6
            else:
                lo, hi = ip_to_u32(toks[1]), ip_to_u32(toks[2])
                fam = FAM_V4
            if lo > hi:
                # real ASA rejects inverted ranges; the device kernel's
                # wraparound range check also requires lo <= hi
                raise AclParseError(
                    f"inverted address range {toks[1]}-{toks[2]} in network "
                    f"object {name!r}"
                )
            out.append((fam, lo, hi))
        elif toks[0] in ("nat", "fqdn"):
            continue  # not matchable statically
        else:
            raise AclParseError(f"unsupported network-object member: {' '.join(toks)!r}")
    if not out:
        raise AclParseError(f"network object {name!r} has no address definition")
    return out


def _port_spec_from_tokens(toks: list[str], pos: int) -> tuple[list[tuple[int, int]], int]:
    """Parse ``eq p | range a b | gt p | lt p | neq p`` at toks[pos].

    Returns (ranges, new_pos).  ``neq`` yields two ranges — the caller's
    cross-product expansion turns that into two rows, matching first-match
    semantics because both rows carry the same configured-rule id.
    """
    op = toks[pos]
    if op == "eq":
        v = _port_value(toks[pos + 1])
        return [(v, v)], pos + 2
    if op == "range":
        lo, hi = _port_value(toks[pos + 1]), _port_value(toks[pos + 2])
        if lo > hi:
            # real ASA rejects inverted port ranges; the device kernel's
            # wraparound range check also requires lo <= hi
            raise AclParseError(f"inverted port range {lo}-{hi}")
        return [(lo, hi)], pos + 3
    if op == "gt":
        v = _port_value(toks[pos + 1])
        return ([(v + 1, PORT_MAX)] if v < PORT_MAX else []), pos + 2
    if op == "lt":
        v = _port_value(toks[pos + 1])
        return ([(0, v - 1)] if v > 0 else []), pos + 2
    if op == "neq":
        v = _port_value(toks[pos + 1])
        rs = []
        if v > 0:
            rs.append((0, v - 1))
        if v < PORT_MAX:
            rs.append((v + 1, PORT_MAX))
        return rs, pos + 2
    raise AclParseError(f"bad port operator {op!r}")


def _resolve_service_group_ports(groups: _Groups, name: str, _seen=None) -> list[tuple[int, int]]:
    """Ports of a proto-typed service group (``object-group service NAME tcp``)."""
    if _seen is None:
        _seen = set()
    if name in _seen:
        raise AclParseError(f"object-group cycle via {name!r}")
    g = groups.service.get(name)
    if g is None:
        raise AclParseError(f"unknown service object-group {name!r}")
    _seen.add(name)
    out: list[tuple[int, int]] = []
    for toks in g["body"]:
        if toks[0] == "port-object":
            rs, _ = _port_spec_from_tokens(toks, 1)
            out.extend(rs)
        elif toks[0] == "group-object":
            out.extend(_resolve_service_group_ports(groups, toks[1], _seen))
        else:
            raise AclParseError(f"unsupported service-group member: {' '.join(toks)!r}")
    _seen.discard(name)
    return out


@dataclasses.dataclass(frozen=True)
class _ProtoAlt:
    """One protocol alternative, optionally bundling port constraints.

    Generic ``object-group service`` groups (no proto suffix) contain
    ``service-object tcp destination eq 443`` members that bind protocol and
    ports together; this carries that bundle through expansion.
    """

    proto: tuple[int, int]
    sport: tuple[int, int] | None = None
    dport: tuple[int, int] | None = None


def _parse_service_object_member(toks: list[str]) -> list[_ProtoAlt]:
    # service-object <proto> [source OP ...] [destination OP ...]
    # service-object object NAME is resolved by the caller.
    proto_tok = toks[1]
    if proto_tok == "icmp":
        protos = [(1, 1)]
    else:
        protos = _proto_ranges(proto_tok)
    sports: list[tuple[int, int]] = [FULL_PORTS]
    dports: list[tuple[int, int]] = [FULL_PORTS]
    pos = 2
    while pos < len(toks):
        if toks[pos] == "source":
            sports, pos = _port_spec_from_tokens(toks, pos + 1)
        elif toks[pos] == "destination":
            dports, pos = _port_spec_from_tokens(toks, pos + 1)
        else:
            pos += 1  # icmp type etc. — not constrained here
    return [
        _ProtoAlt(p, sp, dp)
        for p in protos
        for sp in sports
        for dp in dports
    ]


def _resolve_generic_service_group(groups: _Groups, name: str, _seen=None) -> list[_ProtoAlt]:
    if _seen is None:
        _seen = set()
    if name in _seen:
        raise AclParseError(f"object-group cycle via {name!r}")
    g = groups.service.get(name)
    if g is None:
        raise AclParseError(f"unknown service object-group {name!r}")
    _seen.add(name)
    out: list[_ProtoAlt] = []
    for toks in g["body"]:
        if toks[0] == "service-object":
            if toks[1] == "object":
                out.extend(_resolve_service_object(groups, toks[2]))
            else:
                out.extend(_parse_service_object_member(toks))
        elif toks[0] == "group-object":
            out.extend(_resolve_generic_service_group(groups, toks[1], _seen))
        elif toks[0] == "port-object":
            # proto-typed group referenced generically
            proto = g["proto"]
            rs, _ = _port_spec_from_tokens(toks, 1)
            for pr in _proto_alts_for_typed(proto):
                out.extend(_ProtoAlt(pr, None, r) for r in rs)
        else:
            raise AclParseError(f"unsupported service-group member: {' '.join(toks)!r}")
    _seen.discard(name)
    return out


def _resolve_service_object(groups: _Groups, name: str) -> list[_ProtoAlt]:
    if name not in groups.svc_objects:
        raise AclParseError(f"unknown service object {name!r}")
    out = []
    for toks in groups.svc_objects[name]:
        if toks[0] == "service":
            out.extend(_parse_service_object_member(["service-object", *toks[1:]]))
    if not out:
        raise AclParseError(f"service object {name!r} has no service definition")
    return out


def _proto_alts_for_typed(proto: str | None) -> list[tuple[int, int]]:
    if proto == "tcp":
        return [(6, 6)]
    if proto == "udp":
        return [(17, 17)]
    if proto == "tcp-udp":
        return [(6, 6), (17, 17)]
    raise AclParseError(f"service group without usable protocol type: {proto!r}")


def _resolve_protocol_group(groups: _Groups, name: str, _seen=None) -> list[tuple[int, int]]:
    if _seen is None:
        _seen = set()
    if name in _seen:
        raise AclParseError(f"object-group cycle via {name!r}")
    if name not in groups.protocol:
        raise AclParseError(f"unknown protocol object-group {name!r}")
    _seen.add(name)
    out = []
    for toks in groups.protocol[name]:
        if toks[0] == "protocol-object":
            out.extend(_proto_ranges(toks[1]))
        elif toks[0] == "group-object":
            out.extend(_resolve_protocol_group(groups, toks[1], _seen))
        else:
            raise AclParseError(f"unsupported protocol-group member: {' '.join(toks)!r}")
    _seen.discard(name)
    return out


def _resolve_icmp_type_group(
    groups: _Groups, name: str, _seen=None,
    type_names: dict | None = None,
) -> list[tuple[int, int]]:
    """Resolve an icmp-type group; names resolve through ``type_names``
    (the referencing ACE's family table — ICMPv6 numbers differ from
    their v4 namesakes, so an icmp6 ACE must pass ICMP6_TYPE_NAMES)."""
    if type_names is None:
        type_names = ICMP_TYPE_NAMES
    if _seen is None:
        _seen = set()
    if name in _seen:
        raise AclParseError(f"object-group cycle via {name!r}")
    if name not in groups.icmp_type:
        raise AclParseError(f"unknown icmp-type object-group {name!r}")
    _seen.add(name)
    out = []
    for toks in groups.icmp_type[name]:
        if toks[0] == "icmp-object":
            t = type_names.get(toks[1])
            if t is None:
                try:
                    t = int(toks[1])
                except ValueError:
                    raise AclParseError(f"unknown icmp type {toks[1]!r}") from None
            out.append((t, t))
        elif toks[0] == "group-object":
            out.extend(_resolve_icmp_type_group(groups, toks[1], _seen, type_names))
        else:
            raise AclParseError(f"unsupported icmp-type member: {' '.join(toks)!r}")
    _seen.discard(name)
    return out


# ---------------------------------------------------------------------------
# ACE parsing
# ---------------------------------------------------------------------------

_ADDR_STARTERS = {"any", "any4", "any6", "host", "object-group", "object", "interface"}
_PORT_OPS = {"eq", "range", "gt", "lt", "neq"}
_TRAILERS = {"log", "inactive", "time-range"}


def _parse_address(
    groups: _Groups, toks: list[str], pos: int
) -> tuple[list[tuple[int, int, int]], int]:
    """Address spec at toks[pos] -> ((family, lo, hi) alternatives, new pos).

    ``any`` yields the family wildcard (resolved per ruleset by
    parse_asa_config); ``any4``/``any6`` pin a family; v6 operands are
    recognised by their colon literals.
    """
    t = toks[pos]
    if t == "any":
        return [ANY_WILD], pos + 1
    if t == "any4":
        return [ANY4], pos + 1
    if t == "any6":
        return [ANY6], pos + 1
    if t == "host":
        return [_host_triple(toks[pos + 1])], pos + 2
    if t == "object-group":
        return _resolve_network_group(groups, toks[pos + 1]), pos + 2
    if t == "object":
        return _resolve_network_object(groups, toks[pos + 1]), pos + 2
    if t == "interface":
        # matches traffic to/from the interface address; not statically
        # resolvable here — treat as v4-any, as the reference's coarse
        # parse does (v4-era construct; a v6 deployment would use any6)
        return [ANY4], pos + 2
    if ":" in t:
        # v6 network operand: one prefix token (``2001:db8::/64``)
        return [(FAM_V6, *prefix6_range(t))], pos + 1
    # plain "NET MASK"
    return [(FAM_V4, *subnet_range(t, toks[pos + 1]))], pos + 2


def _maybe_port_spec(
    groups: _Groups, toks: list[str], pos: int
) -> tuple[list[tuple[int, int]] | None, int]:
    """Port spec at toks[pos], or None if the next token starts an address."""
    if pos >= len(toks):
        return None, pos
    t = toks[pos]
    if t in _PORT_OPS:
        return _port_spec_from_tokens(toks, pos)
    if t == "object-group" and pos + 1 < len(toks):
        name = toks[pos + 1]
        # service group here = port spec; network group = next address
        if name in groups.service:
            g = groups.service[name]
            if g["proto"] in ("tcp", "udp", "tcp-udp"):
                return _resolve_service_group_ports(groups, name), pos + 2
        return None, pos
    return None, pos


def parse_ace_line(
    groups: _Groups, acl: str, index: int, line: str, toks: list[str]
) -> AclRule:
    """Parse one ``access-list NAME extended permit|deny ...`` line."""
    rule = AclRule(acl=acl, index=index, text=line)
    # toks: access-list NAME [extended] permit|deny PROTO SRC [SPORT] DST [DPORT] ...
    pos = 2
    if toks[pos] == "extended":
        pos += 1
    action_tok = toks[pos]
    if action_tok not in ("permit", "deny"):
        raise AclParseError(f"bad action {action_tok!r} in: {line!r}")
    action = PERMIT if action_tok == "permit" else DENY
    pos += 1

    # protocol spec
    ptok = toks[pos]
    proto_alts: list[_ProtoAlt]
    generic_service = False
    if ptok == "object-group":
        name = toks[pos + 1]
        if name in groups.protocol:
            proto_alts = [_ProtoAlt(p) for p in _resolve_protocol_group(groups, name)]
        elif name in groups.service:
            proto_alts = _resolve_generic_service_group(groups, name)
            generic_service = True
        else:
            raise AclParseError(f"unknown protocol/service group {name!r} in: {line!r}")
        pos += 2
    elif ptok == "object":
        proto_alts = _resolve_service_object(groups, toks[pos + 1])
        generic_service = True
        pos += 2
    else:
        proto_alts = [_ProtoAlt(p) for p in _proto_ranges(ptok)]
        pos += 1

    src, pos = _parse_address(groups, toks, pos)
    sports, pos = _maybe_port_spec(groups, toks, pos)
    dst, pos = _parse_address(groups, toks, pos)
    dports, pos = _maybe_port_spec(groups, toks, pos)

    icmp_types: list[tuple[int, int]] | None = None
    is_icmp = any(a.proto == (1, 1) for a in proto_alts) or ptok in ("icmp", "icmp6")
    # named types resolve per family: ICMPv6 numbers differ from their v4
    # namesakes (echo-reply is 129, not 0)
    type_names = ICMP6_TYPE_NAMES if ptok == "icmp6" else ICMP_TYPE_NAMES
    if dports is None and is_icmp and pos < len(toks) and toks[pos] not in _TRAILERS:
        t = toks[pos]
        if t == "object-group" and pos + 1 < len(toks) and toks[pos + 1] in groups.icmp_type:
            icmp_types = _resolve_icmp_type_group(
                groups, toks[pos + 1], type_names=type_names
            )
            pos += 2
        elif t in type_names:
            v = type_names[t]
            icmp_types = [(v, v)]
            pos += 1
        elif t.isdigit():
            v = int(t)
            icmp_types = [(v, v)]
            pos += 1
    # trailing keywords (log, inactive, time-range) — "inactive" disables the ACE
    if "inactive" in toks[pos:]:
        return rule  # configured but disabled: zero expanded rows, still reported

    # NB: an empty range list ([] from e.g. "gt 65535") means the spec can
    # never match — distinct from None (no spec -> full range).
    n_pairs = 0
    for alt in proto_alts:
        if generic_service and alt.sport:
            alt_sports = [alt.sport]
        else:
            alt_sports = sports if sports is not None else [FULL_PORTS]
        if generic_service and alt.dport:
            alt_dports = [alt.dport]
        elif icmp_types is not None and alt.proto in ((1, 1), (58, 58)):
            # ICMP types ride the dport column for icmp AND icmp6
            alt_dports = icmp_types
        else:
            alt_dports = dports if dports is not None else [FULL_PORTS]
        for s in src:
            for d in dst:
                sf, df = s[0], d[0]
                if sf != FAM_WILD and df != FAM_WILD and sf != df:
                    continue  # a cross-family pair can match no packet
                fam = sf or df  # FAM_WILD only when both sides are wild
                full = FULL_ADDR6 if fam == FAM_V6 else FULL_ADDR
                slo, shi = (s[1], s[2]) if sf != FAM_WILD else full
                dlo, dhi = (d[1], d[2]) if df != FAM_WILD else full
                n_pairs += 1
                for sp in alt_sports:
                    for dp in alt_dports:
                        rule.aces.append(
                            Ace(
                                action=action,
                                proto_lo=alt.proto[0],
                                proto_hi=alt.proto[1],
                                src_lo=slo,
                                src_hi=shi,
                                sport_lo=sp[0],
                                sport_hi=sp[1],
                                dst_lo=dlo,
                                dst_hi=dhi,
                                dport_lo=dp[0],
                                dport_hi=dp[1],
                                family=fam,
                            )
                        )
    if src and dst and proto_alts and n_pairs == 0:
        # every src/dst pairing crossed families (e.g. ``any4`` source
        # with a v6-only destination group) — real ASA rejects such
        # entries; an unmatched-forever rule would silently distort the
        # unused-rule report
        raise AclParseError(f"no same-family src/dst combination in: {line!r}")
    return rule


_STANDARD_RE = re.compile(r"^access-list\s+(\S+)\s+standard\s+(permit|deny)\s+(.*)$")


def parse_asa_config(text: str, firewall: str, strict: bool = True) -> Ruleset:
    """Parse one firewall's ASA configuration into a :class:`Ruleset`.

    ``strict=True`` (default) raises :class:`AclParseError` on any
    unsupported construct.  ``strict=False`` is the ops-tool mode: an
    unsupported access-list entry (IPv6, exotic object members, ...) is
    skipped and recorded in ``Ruleset.skipped`` — it still consumes its
    rule index so later rules keep their device-side positions — and the
    IPv4 analysis proceeds.
    """
    lines = text.splitlines()
    groups, rest = _collect_blocks(lines)
    rs = Ruleset(firewall=firewall)
    indices: dict[str, int] = {}

    for lineno, line in rest:
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "access-group":
            # access-group NAME in|out interface IFNAME
            if len(toks) >= 5 and toks[3] == "interface" and toks[2] in ("in", "out"):
                rs.bindings[(toks[4], toks[2])] = toks[1]
            continue
        if toks[0] != "access-list" or len(toks) < 3:
            continue
        acl = toks[1]
        if toks[2] == "remark":
            continue
        m = _STANDARD_RE.match(line)
        try:
            if m:
                # standard ACL: source-address-only match
                acl, action_tok, addr = m.groups()
                indices[acl] = indices.get(acl, 0) + 1
                rule = AclRule(acl=acl, index=indices[acl], text=line)
                atoks = addr.split()
                if atoks[0] in ("any", "any4"):
                    ranges = [FULL_ADDR]
                elif atoks[0] == "host":
                    a = ip_to_u32(atoks[1])
                    ranges = [(a, a)]
                else:
                    ranges = [subnet_range(atoks[0], atoks[1])]
                action = PERMIT if action_tok == "permit" else DENY
                for lo, hi in ranges:
                    rule.aces.append(
                        Ace(action, *FULL_PROTO, lo, hi, *FULL_PORTS, *FULL_ADDR, *FULL_PORTS)
                    )
                rs.acls.setdefault(acl, []).append(rule)
                continue
            indices[acl] = indices.get(acl, 0) + 1
            rule = parse_ace_line(groups, acl, indices[acl], line, toks)
        except IndexError:
            # truncated entry (either branch); same skip/raise policy
            err = AclParseError(f"truncated access-list entry: {line!r}")
            if strict:
                raise err from None
            rs.acls.setdefault(acl, [])
            rs.skipped.append((lineno, str(err), line))
            continue
        except AclParseError as e:
            if strict:
                raise
            # the index was consumed above; ensure the ACL exists so its
            # implicit deny / bindings still resolve even if every entry
            # was skipped
            rs.acls.setdefault(acl, [])
            rs.skipped.append((lineno, str(e), line))
            continue
        rs.acls.setdefault(acl, []).append(rule)
    _resolve_wildcard_families(rs)
    return rs


def _resolve_wildcard_families(rs: Ruleset) -> None:
    """Resolve FAM_WILD aces (``any`` src AND dst) per ruleset.

    Pure-v4 configs: the wildcard is v4-only — every pre-v6 corpus keeps
    its exact historical expansion (row counts, tensors, reports all
    bit-identical).  Configs with explicit v6 content (a colon literal or
    ``any6`` anywhere): ``any`` means both families, the ASA 9.0+
    unified-ACL semantic, so ``permit ip any any`` really does cover v6
    traffic there.  The v6 twin sits next to its v4 ace — same configured
    rule, same key — so rule-level counts are unaffected by the order.
    """
    has_v6 = any(
        a.family == FAM_V6
        for rules in rs.acls.values()
        for r in rules
        for a in r.aces
    )
    for rules in rs.acls.values():
        for r in rules:
            if all(a.family != FAM_WILD for a in r.aces):
                continue
            new: list[Ace] = []
            for a in r.aces:
                if a.family != FAM_WILD:
                    new.append(a)
                    continue
                new.append(dataclasses.replace(a, family=FAM_V4))
                if has_v6:
                    new.append(
                        dataclasses.replace(
                            a,
                            family=FAM_V6,
                            src_lo=0,
                            src_hi=U128_MAX,
                            dst_lo=0,
                            dst_hi=U128_MAX,
                        )
                    )
            r.aces = new


def parse_config_file(path: str, firewall: str | None = None, strict: bool = True) -> Ruleset:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    if firewall is None:
        m = re.search(r"^hostname\s+(\S+)", text, re.MULTILINE)
        firewall = m.group(1) if m else path.rsplit("/", 1)[-1]
    return parse_asa_config(text, firewall, strict=strict)
