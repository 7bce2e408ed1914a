"""Cisco ASA syslog parsing: log line -> (firewall, ACL, 5-tuple).

The reference's ``mapper.py`` (SURVEY.md §4.3) regex-parses each syslog line,
extracts the connection 5-tuple plus the firewall identity, and decides which
ACL to evaluate.  This module is that parse step, host-side and backend-
agnostic: both the exact oracle and the device packer consume its output.

Message classes handled (the ASA access-list / connection family SURVEY.md
§4.3 names):

- ``%ASA-n-106100``: ``access-list <acl> permitted|denied <proto>
  <if>/<src>(<sport>) -> <if>/<dst>(<dport>) hit-cnt ...`` — names the ACL
  directly.
- ``%ASA-n-106023``: ``Deny <proto> src <if>:<src>[/<sport>] dst
  <if>:<dst>[/<dport>] [(type <t>, code <c>)] by access-group "<acl>"``.
- ``%ASA-n-106001``: ``Inbound TCP connection denied from <src>/<sport> to
  <dst>/<dport> flags <f> on interface <if>`` — resolved via the
  interface's ``in`` binding.
- ``%ASA-n-106006``: ``Deny inbound UDP from <src>/<sport> to <dst>/<dport>
  on interface <if>`` — resolved via the ``in`` binding.
- ``%ASA-n-106015``: ``Deny TCP (no connection) from <src>/<sport> to
  <dst>/<dport> flags <f> on interface <if>`` — resolved via the ``in``
  binding.
- ``%ASA-n-302013/302015``: ``Built inbound|outbound TCP|UDP connection <id>
  for <if>:<a>/<p> (...) to <if>:<b>/<q> (...)`` — no ACL in the message;
  resolved from the ingress interface's ``in`` binding AND (when
  configured) the egress interface's ``out`` binding — one connection line
  can be evaluated against both.

ICMP convention (shared with aclparse): the ICMP *type* travels in the
destination-port column and the source port is 0, so one packed tuple layout
serves every protocol.
"""

from __future__ import annotations

import dataclasses
import re

from .aclparse import FAM_V4, FAM_V6, PROTO_NUMBERS, ip6_to_int, ip_to_u32


@dataclasses.dataclass(frozen=True)
class ParsedLine:
    """One successfully parsed ASA log line, ACL not yet resolved.

    ``family`` is FAM_V4 or FAM_V6; src/dst are Python ints (32- or
    128-bit).  ASA logs a connection's two endpoints in one family —
    mixed-family text in a single message is malformed and skipped.
    """

    firewall: str
    acl: str | None  # None for connection messages; resolve via binding
    ingress_if: str | None
    proto: int
    src: int
    sport: int
    dst: int
    dport: int
    permitted: bool | None  # what the firewall says it did (106100/106023)
    #: exit interface (302013/302015 only): evaluated against that
    #: interface's ``out`` access-group binding, when one exists
    egress_if: str | None = None
    family: int = FAM_V4


_PROTO_BY_NAME = {k: (v if v is not None else 0) for k, v in PROTO_NUMBERS.items()}


def _proto_num(tok: str) -> int:
    v = _PROTO_BY_NAME.get(tok.lower())
    if v is not None:
        return v
    try:
        return int(tok)
    except ValueError:
        return 0


def _addr(tok: str) -> tuple[int, int]:
    """Address text -> (family, value); v6 recognised by colon literals.

    Raises (a ValueError subclass) on malformed text of either family —
    parse_line turns that into a clean line skip.
    """
    if ":" in tok:
        return FAM_V6, ip6_to_int(tok)
    return FAM_V4, ip_to_u32(tok)


# hostname is the last whitespace token before the %ASA tag (syslog relay
# prefixes vary; this is robust to "<pri>MMM dd hh:mm:ss host : %ASA-...").
# re.ASCII everywhere: Python's \d otherwise matches Unicode digits,
# which int() accepts but the native parser (asaparse.cpp is_dig,
# ASCII-only) rejects — the two parsers must agree on every input
# (mirrors the ip_to_u32 isascii() guard).
_TAG_RE = re.compile(r"(?:^|\s)(\S+?)\s*:?\s*%ASA-\d-(\d{6}):\s*(.*)$", re.ASCII)

_M106100_RE = re.compile(
    r"access-list\s+(\S+)\s+(permitted|denied|est-allowed)\s+(\S+)\s+"
    r"(\S+?)/([\dA-Fa-f:.]+)\((\d+)\)(?:\([^)]*\))?\s*->\s*"
    r"(\S+?)/([\dA-Fa-f:.]+)\((\d+)\)"
    , re.ASCII
)

_M106023_RE = re.compile(
    r"Deny\s+(\S+)\s+src\s+(\S+?):([\dA-Fa-f:.]+)(?:/(\d+))?\s+"
    r"dst\s+(\S+?):([\dA-Fa-f:.]+)(?:/(\d+))?"
    r"(?:\s+\(type\s+(\d+),\s*code\s+(\d+)\))?"
    r'.*?by\s+access-group\s+"([^"]+)"'
    , re.ASCII
)

_M302013_RE = re.compile(
    r"Built\s+(inbound|outbound)\s+(TCP|UDP)\s+connection\s+\S+\s+for\s+"
    r"(\S+?):([\dA-Fa-f:.]+)/(\d+)\s*(?:\([^)]*\))?\s*to\s+"
    r"(\S+?):([\dA-Fa-f:.]+)/(\d+)"
    , re.ASCII
)

_M106001_RE = re.compile(
    r"Inbound\s+TCP\s+connection\s+denied\s+from\s+([\dA-Fa-f:.]+)/(\d+)\s+to\s+"
    r"([\dA-Fa-f:.]+)/(\d+)\s+flags\s+.*?\bon\s+interface\s+(\S+)"
    , re.ASCII
)

_M106006_RE = re.compile(
    r"Deny\s+inbound\s+UDP\s+from\s+([\dA-Fa-f:.]+)/(\d+)\s+to\s+"
    r"([\dA-Fa-f:.]+)/(\d+)\s+on\s+interface\s+(\S+)"
    , re.ASCII
)

_M106015_RE = re.compile(
    r"Deny\s+TCP\s+\(no connection\)\s+from\s+([\dA-Fa-f:.]+)/(\d+)\s+to\s+"
    r"([\dA-Fa-f:.]+)/(\d+)\s+flags\s+.*?\bon\s+interface\s+(\S+)"
    , re.ASCII
)


def _field_ranges_ok(p: ParsedLine) -> ParsedLine | None:
    """Skip lines whose numeric fields exceed their wire widths.

    Ports are 16-bit and protocol numbers 8-bit on the wire (and in the
    bit-packed device batch layout, pack.compact_batch); a syslog line
    claiming port 70000 is malformed, and silently truncating it could
    make it match a rule it shouldn't.  The native C++ parser applies the
    identical post-parse check, keeping the two paths line-for-line equal.
    """
    if p.sport > 0xFFFF or p.dport > 0xFFFF or p.proto > 0xFF:
        return None
    return p


def parse_line(line: str) -> ParsedLine | None:
    """Parse one raw syslog line; None if it is not a handled ASA message."""
    try:
        p = _parse_line_raw(line)
    except ValueError:
        # An ASA-shaped line with a malformed field (e.g. a corrupt
        # address like "1.2.3.4.5.6" — found by fuzzing) is not a handled message:
        # skip it like any other unparseable line instead of letting
        # ip_to_u32's AclParseError crash the whole chunk loop.
        return None
    return None if p is None else _field_ranges_ok(p)


def _parse_line_raw(line: str) -> ParsedLine | None:
    m = _TAG_RE.search(line)
    if not m:
        return None
    host, msgid, body = m.group(1), m.group(2), m.group(3)

    if msgid == "106100":
        b = _M106100_RE.search(body)
        if not b:
            return None
        acl, verdict, proto_tok = b.group(1), b.group(2), b.group(3)
        proto = _proto_num(proto_tok)
        sport = int(b.group(6))
        dport = int(b.group(9))
        if proto in (1, 58):
            # ICMP/ICMPv6: the parenthesised values are type/code; type -> dport
            dport = sport
            sport = 0
        sfam, src = _addr(b.group(5))
        dfam, dst = _addr(b.group(8))
        if sfam != dfam:
            return None
        return ParsedLine(
            firewall=host,
            acl=acl,
            ingress_if=b.group(4),
            proto=proto,
            src=src,
            sport=sport,
            dst=dst,
            dport=dport,
            permitted=(verdict != "denied"),
            family=sfam,
        )

    if msgid == "106023":
        b = _M106023_RE.search(body)
        if not b:
            return None
        proto = _proto_num(b.group(1))
        sport = int(b.group(4) or 0)
        dport = int(b.group(7) or 0)
        if proto in (1, 58) and b.group(8) is not None:
            dport = int(b.group(8))  # icmp type
            sport = 0
        sfam, src = _addr(b.group(3))
        dfam, dst = _addr(b.group(6))
        if sfam != dfam:
            return None
        return ParsedLine(
            firewall=host,
            acl=b.group(10),
            ingress_if=b.group(2),
            proto=proto,
            src=src,
            sport=sport,
            dst=dst,
            dport=dport,
            permitted=False,
            family=sfam,
        )

    if msgid in ("302013", "302015"):
        b = _M302013_RE.search(body)
        if not b:
            return None
        direction = b.group(1)
        proto = 6 if b.group(2) == "TCP" else 17
        fam_a, ip_a = _addr(b.group(4))
        fam_b, ip_b = _addr(b.group(7))
        if fam_a != fam_b:
            return None
        if_a, port_a = b.group(3), int(b.group(5))
        if_b, port_b = b.group(6), int(b.group(8))
        # "Built ... for A to B": A is the lower-security side.  Inbound
        # connections are initiated at A (src=A); outbound are initiated at B
        # (src=B) with A as the destination side.  The packet enters on the
        # initiator's interface and exits on the other — the egress side's
        # ``out`` ACL (if bound) also filters it.
        if direction == "inbound":
            src, sport, dst, dport = ip_a, port_a, ip_b, port_b
            ingress, egress = if_a, if_b
        else:
            src, sport, dst, dport = ip_b, port_b, ip_a, port_a
            ingress, egress = if_b, if_a
        return ParsedLine(
            firewall=host,
            acl=None,
            ingress_if=ingress,
            proto=proto,
            src=src,
            sport=sport,
            dst=dst,
            dport=dport,
            permitted=True,
            egress_if=egress,
            family=fam_a,
        )

    if msgid in ("106001", "106006", "106015"):
        rx = {"106001": _M106001_RE, "106006": _M106006_RE, "106015": _M106015_RE}[msgid]
        b = rx.search(body)
        if not b:
            return None
        sfam, src = _addr(b.group(1))
        dfam, dst = _addr(b.group(3))
        if sfam != dfam:
            return None
        return ParsedLine(
            firewall=host,
            acl=None,
            ingress_if=b.group(5),
            proto=17 if msgid == "106006" else 6,
            src=src,
            sport=int(b.group(2)),
            dst=dst,
            dport=int(b.group(4)),
            permitted=False,
            family=sfam,
        )

    return None
