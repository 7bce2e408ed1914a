"""Synthetic ASA configs and syslog — test fixtures and benchmark feedstock.

A copy of the reference's ``hostside/synth.py``, cut to the text tier
the port drives (``synth_config``, ``synth_tuples``, ``render_syslog``
and their IPv6 twins ``synth_tuples6``, ``render_syslog6``, and
``synth_syslog_file``).  Same seeds give the same
configs and lines as the reference.  ``churn_config`` edits a config
into a changed ruleset for report diffs.  Beside them, for the match
kernels' edge cases: ``synth_rule_rows`` (bare rule matrices),
``tuples_for_rules`` and ``match_edge_cases``.

Generation intent here is only a *bias* — ground truth for every test
comes from the oracle, never from the generator — so overlapping rules
shadowing each other can't make expectations silently wrong.
"""

from __future__ import annotations

import numpy as np

from .aclparse import int_to_ip6, u32_to_ip
from .pack import (
    PackedRuleset,
    R_ACL,
    R_DHI,
    R_DLO,
    R_DPHI,
    R_DPLO,
    R_KEY,
    R_PHI,
    R_PLO,
    R_SHI,
    R_SLO,
    R_SPHI,
    R_SPLO,
    RULE_COLS,
    RULE6_COLS,
    R6_ACL,
    R6_DHI,
    R6_DLO,
    R6_DPHI,
    R6_DPLO,
    R6_KEY,
    R6_PHI,
    R6_PLO,
    R6_SHI,
    R6_SLO,
    R6_SPHI,
    R6_SPLO,
    T_VALID,
    T6_DPORT,
    T6_DST,
    T6_PROTO,
    T6_SPORT,
    T6_SRC,
    T6_VALID,
    TUPLE_COLS,
    TUPLE6_COLS,
    NO_ACL,
    limbs_u128,
    u128_limbs,
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


def churn_config(text: str) -> tuple[str, dict]:
    """A ruleset change of three edits to a ``synth_config`` text: the
    feedstock of report diffs across a reload.

    - **move**: in the first ACL whose first ``ip any any`` ACE follows an
      ACE of the other action, the two swap, so the moved ACE covers the
      one it passed, which turns dead (``conflict``: one earlier ACE of
      the other action covers it);
    - **delete**: the last ACE of the next ACL goes;
    - **add**: one ACE is appended to the moved ACE's ACL.

    Rule keys are (firewall, ACL, 1-based position), so the move swaps
    two keys' rules and keeps every other key, the delete removes one key
    and the add makes one.
    Returns the new text and ``{"move": (acl, position of the passed ACE
    after the move), "delete": (acl, position), "add": (acl, position)}``.
    Raises ValueError when the text has no such pair.
    """
    lines = text.splitlines()
    by_acl: dict[str, list[int]] = {}
    for i, ln in enumerate(lines):
        if ln.startswith("access-list "):
            by_acl.setdefault(ln.split()[1], []).append(i)
    acls = list(by_acl)
    for a, acl in enumerate(acls):
        rows = by_acl[acl]
        pos = next((p for p, i in enumerate(rows) if " ip any any" in lines[i]), None)
        if not pos:
            continue
        above, m = rows[pos - 1], rows[pos]
        if lines[above].split()[3] == lines[m].split()[3]:
            continue
        lines[above], lines[m] = lines[m], lines[above]
        gone = acls[(a + 1) % len(acls)]
        n_gone = len(by_acl[gone])
        added = f"access-list {acl} extended permit tcp host 192.0.2.1 host 198.51.100.1 eq 22"
        lines.insert(rows[-1] + 1, added)
        del lines[by_acl[gone][-1] + (by_acl[gone][-1] > rows[-1])]
        edits = {"move": (acl, pos + 1), "delete": (gone, n_gone), "add": (acl, len(rows) + 1)}
        return "\n".join(lines) + "\n", edits
    raise ValueError("no ACL has an 'ip any any' ACE below an ACE of the other action")


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
    return tuples_for_rules(packed.rules, n, seed, miss_fraction)


def flow_pool(
    packed: PackedRuleset,
    n_flows: int,
    seed: int = 0,
    miss_fraction: float = 0.1,
) -> np.ndarray:
    """A pool of DISTINCT candidate flows: ``[m, TUPLE_COLS]``, m <= n_flows.

    Drawn via :func:`synth_tuples`, then deduplicated in generation order.
    """
    t = synth_tuples(packed, n_flows, seed=seed, miss_fraction=miss_fraction)
    view = np.ascontiguousarray(t).view([("", np.uint32)] * t.shape[1]).ravel()
    _, first = np.unique(view, return_index=True)
    first.sort()
    return t[first]


def zipf_weights(m: int, skew: float) -> np.ndarray:
    """Normalized Zipf(s) pmf over ranks 1..m (``skew=0`` -> uniform)."""
    if m < 1:
        raise ValueError("need at least one flow")
    p = 1.0 / np.arange(1, m + 1, dtype=np.float64) ** float(skew)
    return p / p.sum()


def flow_draws(
    packed: PackedRuleset,
    n: int,
    n_flows: int,
    skew: float = 1.0,
    seed: int = 0,
    miss_fraction: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """``(pool [m, TUPLE_COLS], idx [n])``: row i of the corpus is ``pool[idx[i]]``.

    Flow rank k repeats with probability proportional to 1/k**skew, as in
    real firewall logs, where the same 5-tuple is logged over and over.
    The reference's ``synth_flow_tuples`` is ``pool[idx]``, draw for draw.
    """
    pool = flow_pool(packed, n_flows, seed=seed, miss_fraction=miss_fraction)
    rng = np.random.default_rng(seed ^ 0x5EEDF10)
    idx = rng.choice(pool.shape[0], size=n, p=zipf_weights(pool.shape[0], skew))
    return pool, idx


def synth_flow_tuples(
    packed: PackedRuleset,
    n: int,
    n_flows: int,
    skew: float = 1.0,
    seed: int = 0,
    miss_fraction: float = 0.1,
) -> np.ndarray:
    """``n`` tuple rows drawn with Zipf(s) repetition from a flow pool."""
    pool, idx = flow_draws(packed, n, n_flows, skew, seed, miss_fraction)
    return pool[idx]


def tuples_for_rules(
    rules: np.ndarray,
    n: int,
    seed: int = 0,
    miss_fraction: float = 0.1,
) -> np.ndarray:
    """:func:`synth_tuples` over a bare [R, RULE_COLS] rule matrix."""
    rng = np.random.default_rng(seed)
    rules = rules.astype(np.int64)
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


def synth_rule_rows(acl: np.ndarray, seed: int = 0) -> np.ndarray:
    """[R, RULE_COLS] uint32 rule rows with the given acl column.

    Kernel edge cases: the acl column is the caller's (interleaved ACLs,
    ids with no rows, NO_ACL rows anywhere), and each of the five ranges
    is, at random, the whole field, one value, or a random [lo, hi], so
    lines inside one row often hit earlier rows too.  R_KEY is the row.
    """
    rng = np.random.default_rng(seed)
    r = len(acl)
    out = np.zeros((r, RULE_COLS), dtype=np.uint32)
    out[:, R_ACL] = acl
    for lo_col, hi_col, bits in (
        (R_PLO, R_PHI, 8), (R_SLO, R_SHI, 32), (R_SPLO, R_SPHI, 16),
        (R_DLO, R_DHI, 32), (R_DPLO, R_DPHI, 16),
    ):
        top = (1 << bits) - 1
        kind = rng.integers(0, 3, size=r)
        a = rng.integers(0, top, size=r, dtype=np.uint64, endpoint=True)
        b = rng.integers(0, top, size=r, dtype=np.uint64, endpoint=True)
        out[:, lo_col] = np.where(kind == 0, 0, np.where(kind == 1, a, np.minimum(a, b)))
        out[:, hi_col] = np.where(kind == 0, top, np.where(kind == 1, a, np.maximum(a, b)))
    out[:, R_KEY] = np.arange(r, dtype=np.uint32)
    return out


def match_edge_cases(n: int = 2048, seed: int = 0) -> dict:
    """Edge cases of the match kernels' contract, by name.

    Each is ``(rules [R, RULE_COLS], tuples [n, TUPLE_COLS], n_acls)``,
    uint32, the rules unpadded (pipeline.pad_rules pads them with NO_ACL
    rows).  In every case some lines carry corrupt acl ids (n_acls + 3,
    0xFFFFFFF0) and some the padding acl NO_ACL with all-zero fields,
    which match the first padding row where there is one; a tenth of the
    lines are invalid.
    """
    rng = np.random.default_rng(seed)
    u32 = np.uint32

    def blocks(*sizes_by_acl):
        return np.concatenate([np.full(k, a, dtype=u32) for a, k in sizes_by_acl])

    acls = {
        # one ACL's rows scattered among the others'
        "interleaved ACLs": (rng.integers(0, 6, size=900).astype(u32), 6),
        # spans that are not multiples of the warp
        "odd spans": (blocks((0, 1), (1, 31), (2, 33), (3, 45), (4, 97), (5, 64), (6, 3)), 7),
        # ids with no rows, ids >= n_acls in the rules, NO_ACL rows mid-table
        "empty ACLs, ids beyond n_acls": (
            blocks((0, 50), (2, 47), (int(NO_ACL), 10), (5, 40), (9, 33)), 4),
        "one ACL of 7680 rows": (np.zeros(7680, dtype=u32), 1),
        "every line unmatched in the largest ACL": (
            blocks((0, 40), (1, 7000), (2, 500)), 3),
    }
    cases = {}
    for i, (name, (acl, n_acls)) in enumerate(acls.items()):
        rules = synth_rule_rows(acl, seed=seed + i)
        tuples = tuples_for_rules(rules, n, seed=seed + i)
        if name.startswith("every line unmatched"):
            rules[:, R_PLO] = np.maximum(rules[:, R_PLO], 1)
            rules[:, R_PHI] = np.maximum(rules[:, R_PHI], 1)
            tuples[:, 0] = 1
            tuples[:, 1] = 0
        else:
            tuples[::13, 0] = n_acls + 3
            tuples[5::29, 0] = 0xFFFFFFF0
            tuples[7::31, :6] = 0
            tuples[7::31, 0] = NO_ACL
        tuples[3::10, T_VALID] = 0
        cases[name] = (rules, tuples, n_acls)
    return cases


def relation_edge_rows(n: int, n_acls: int = 3, seed: int = 0) -> np.ndarray:
    """[n, RULE_COLS] uint32 rule rows at the u32 edges, for the pair-relation
    kernel (ops/overlap.py): points (lo = hi), bounds of 0 and 0xFFFFFFFF,
    values on both sides of 2^31 (negative as int32), full ranges, and a
    tenth NO_ACL padding rows among them; lo <= hi in every field."""
    rng = np.random.default_rng(seed)
    pool = np.array([0, 1, 2, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                     0xFFFFFFFF], dtype=np.uint64)
    rows = np.zeros((n, RULE_COLS), dtype=np.uint32)
    rows[:, R_ACL] = rng.integers(0, n_acls, size=n)
    rows[rng.random(n) < 0.1, R_ACL] = NO_ACL
    rows[:, R_KEY] = np.arange(n)
    for f in range(5):
        kind = rng.random(n)
        a = rng.choice(pool, size=n)
        b = rng.choice(pool, size=n)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        lo = np.where(kind < 0.3, a, np.where(kind < 0.5, 0, lo))
        hi = np.where(kind < 0.3, a, np.where(kind < 0.5, 0xFFFFFFFF, hi))
        rows[:, 1 + 2 * f], rows[:, 2 + 2 * f] = lo, hi
    return rows


def relation_edge_cases(rules: np.ndarray, seed: int = 0) -> dict:
    """Tiles of the pair-relation kernel's contract, by name: ``(rows_i,
    rows_j)``, uint32 ``[Ti, RULE_COLS]`` and ``[Tj, RULE_COLS]``.

    ``rules`` is a packed rule matrix of at least 1024 rows (its 512-row
    blocks are the analyzer's tiles); the rest are ragged, tiny,
    all-padding, cross-ACL and u32-edge tiles, and u32-edge rows with some
    fields inverted (lo > hi: the packer refuses them, the function is
    defined on them all the same).
    """
    r = rules.shape[0]
    pad = np.zeros((512, RULE_COLS), dtype=np.uint32)
    pad[:, R_ACL] = NO_ACL
    other = rules[:512].copy()
    other[:, R_ACL] += 1  # the same boxes in another ACL
    edge = relation_edge_rows(600, seed=seed)
    inverted = relation_edge_rows(300, seed=seed + 1)
    flip = np.random.default_rng(seed).random((300, 5)) < 0.2
    for f in range(5):
        lo, hi = inverted[:, 1 + 2 * f].copy(), inverted[:, 2 + 2 * f].copy()
        inverted[flip[:, f], 1 + 2 * f] = hi[flip[:, f]]
        inverted[flip[:, f], 2 + 2 * f] = lo[flip[:, f]]
    return {
        "T=512 diagonal block": (rules[:512], rules[:512]),
        "T=512 lower block": (rules[512:1024], rules[:512]),
        "ragged 513-row tile": (rules[:513], rules[:513]),
        "the grid's last row block": (rules[(r - 1) // 512 * 512:], rules[:512]),
        "1 x 1": (rules[:1], rules[:1]),
        "all-padding block": (pad, rules[:512]),
        "cross-ACL blocks": (np.concatenate([rules[:256], other[:256]]), other),
        "u32 edges": (edge, edge[:333]),
        "u32 edges against real rows": (edge[:77], rules[:512]),
        "inverted ranges": (inverted, np.concatenate([inverted[::-1], edge[:200]])),
    }


def reg_tail_cases(b: int, n_keys: int, seed: int = 0) -> dict:
    """Inputs of the register-tail kernel (ops/reg_tail.py), by name.

    Each is a dict of the kernel's line columns, ``row`` (match rows, -1
    where none matched), ``valid`` (the weight plane) and ``acl`` ([n]
    int32 numpy, u32 bits) and ``src`` (a list of one such column, or the
    four limbs of v6 sources); its key table ``key_k`` ([n_rows + 16]
    int32) and ``n_rows``; and the wrapper's options ``counts``,
    ``select``, ``sample_shift``, ``salt`` and ``acl_tag``.  Sources are
    drawn from a small pool so talkers repeat, slots collide and HLL
    cells take many lines; a few keys are out of range and a few rows past
    the table (both dropped), a few acl ids past the last ACL (clamped).
    The cases cover the fused route (no counts) and the scan route, sample
    shifts 0 and 3, a selecting and a deferred chunk, weighted rows up to
    2^32 - 1, v6 lines, one line, a batch that is not a multiple of the
    block, all lines invalid, and every key out of range.  The last five
    are the edges of the kernel's warp grouping (32 consecutive lines):
    one talker on every line (every group is the whole warp), two talkers
    alternating lanes, group weights whose u32 sum wraps past 2^32 inside
    one warp, invalid lines between a group's lanes, and a sampled chunk
    (stride 8) whose talkers' groups span strides.
    """
    rng = np.random.default_rng(seed)
    n_rows, n_acls = 64, 16

    def i32(a):
        return np.asarray(a, np.int64).astype(np.uint32).view(np.int32)

    def table(bad=0.05):
        keys = rng.integers(0, n_keys, n_rows + n_acls)
        keys[rng.random(keys.shape[0]) < bad] = n_keys + 5
        return i32(keys)

    def lines(n, w_hi=2, bad_rows=0.01, limbs=1):
        row = rng.integers(-1, n_rows, n)
        row[rng.random(n) < bad_rows] = n_rows + 3
        return dict(row=i32(row), valid=i32(rng.integers(0, w_hi, n, dtype=np.uint64)),
                    acl=i32(rng.integers(0, n_acls + 2, n)),
                    src=[i32(rng.integers(0, 1 << 14, n) * 2654435761 % (1 << 32))
                         for _ in range(limbs)])

    def case(n, counts=True, select=True, sample_shift=0, salt=7, acl_tag=0, bad_keys=0.05,
             **kw):
        return {**lines(n, **kw), "key_k": table(bad_keys), "n_rows": n_rows, "counts": counts,
                "select": select, "sample_shift": sample_shift, "salt": salt, "acl_tag": acl_tag}

    one = case(1, sample_shift=3)
    one["valid"][:] = 1

    def talkers(n, pattern, **kw):
        """A case whose acl and source follow ``pattern`` ([n] talker ids)."""
        c = case(n, **kw)
        ids = np.asarray(pattern)
        c["acl"] = i32(ids % 3)
        c["src"] = [i32(0x0A000001 + 977 * ids)]
        return c

    lane = np.arange(b)
    single = talkers(b, np.zeros(b, np.int64))
    single["valid"][:] = 1
    alternating = talkers(b, lane % 2)
    alternating["valid"][:] = 1
    wrapping = talkers(b, lane // 32 % 2, w_hi=1 << 32)
    wrapping["valid"] = i32(np.where(lane % 32 < 16, 0xF0000000 + lane % 7, 0x30000001))
    holes = talkers(b, lane // 8 % 3)
    holes["valid"][(lane % 32) % 3 == 1] = 0
    spanning = talkers(b, lane // 12 % 4, sample_shift=3, salt=5)
    return {
        "fused route (delta given), selecting": case(b, counts=False),
        "scan route (delta in the kernel), selecting": case(b),
        "sample_shift 3, salt 11": case(b, sample_shift=3, salt=11),
        "deferred chunk (no selection)": case(b, select=False),
        "weighted rows up to 2^32 - 1": case(b, w_hi=1 << 32, sample_shift=3, salt=5),
        "v6 lines (four source limbs, tagged gid)": case(b, limbs=4, acl_tag=0x80000000),
        "one line": one,
        "ragged B=100003": case(100003, sample_shift=3, salt=0xFFFFFFFF),
        "all lines invalid": case(4099, w_hi=1),
        "every key out of range": case(4099, bad_keys=1.0),
        "one talker on every line": single,
        "two talkers alternating lanes": alternating,
        "group weights wrapping past 2^32 in a warp": wrapping,
        "invalid lines between a group's lanes": holes,
        "sampled chunk, groups spanning strides": spanning,
    }


def select_cases(slots: int, n: int, seed: int = 0) -> dict:
    """Candidate tables for the talker select (ops/reg_tail.py
    select_tables), by name: ``cnt`` ([slots] int64 u32 counts) and ``rep``
    ([slots] int64, an index into an n-line sample, -1 where empty).

    All zero (nothing to pick), all equal (every rank decided by the slot),
    counts of 2^31 and more (negative as int32: masked out, as the
    reference reads them) among small ones, many ties at small counts (a
    chunk of the main path), and positive counts with an empty rep (a slot
    ranked but masked).
    """
    rng = np.random.default_rng(seed)

    def reps(cnt):
        return np.where(cnt != 0, rng.integers(0, n, slots), -1).astype(np.int64)

    equal = np.full(slots, 5, np.int64)
    big = rng.integers(0, 4, slots).astype(np.int64)
    high = rng.random(slots) < 0.1
    big[high] = rng.integers(1 << 31, 1 << 32, int(high.sum()), dtype=np.int64)
    big[rng.random(slots) < 0.05] = (1 << 32) - 1
    ties = np.minimum(rng.zipf(1.5, slots) - 1, 1000).astype(np.int64)
    ties[rng.random(slots) < 0.5] = 0
    holes = rng.integers(0, 9, slots).astype(np.int64)
    holes_rep = reps(holes)
    holes_rep[rng.random(slots) < 0.3] = -1
    return {
        "all zero": dict(cnt=np.zeros(slots, np.int64), rep=np.full(slots, -1, np.int64)),
        "all equal": dict(cnt=equal, rep=reps(equal)),
        "counts >= 2^31 among small ones": dict(cnt=big, rep=reps(big)),
        "ties at small counts": dict(cnt=ties, rep=reps(ties)),
        "positive counts with an empty rep": dict(cnt=holes, rep=holes_rep),
    }


def synth_tuples6(
    packed: PackedRuleset,
    n: int,
    seed: int = 0,
    miss_fraction: float = 0.1,
) -> np.ndarray:
    """v6 twin of :func:`synth_tuples`: [n, TUPLE6_COLS] biased at rules6.

    128-bit address sampling runs per row with Python ints (arbitrary-
    precision ranges), exactly as the reference does.
    """
    import random as _random

    rng = np.random.default_rng(seed)
    prng = _random.Random(seed ^ 0x76C0FFEE)
    r6 = packed.rules6
    real = r6[r6[:, R6_ACL] != NO_ACL]
    if real.shape[0] == 0:
        raise ValueError("packed ruleset has no v6 rules")
    pick = rng.integers(0, real.shape[0], size=n)
    miss = rng.random(n) < miss_fraction
    out = np.zeros((n, TUPLE6_COLS), dtype=np.uint32)
    for i in range(n):
        row = real[pick[i]]
        if miss[i]:
            out[i, T6_PROTO] = prng.randrange(256)
            out[i, T6_SRC:T6_SRC + 4] = u128_limbs(prng.getrandbits(128))
            out[i, T6_SPORT] = prng.randrange(1 << 16)
            out[i, T6_DST:T6_DST + 4] = u128_limbs(prng.getrandbits(128))
            out[i, T6_DPORT] = prng.randrange(1 << 16)
            out[i, 0] = row[R6_ACL]
            out[i, T6_VALID] = 1
            continue
        slo = limbs_u128(*row[R6_SLO:R6_SLO + 4])
        shi = limbs_u128(*row[R6_SHI:R6_SHI + 4])
        dlo = limbs_u128(*row[R6_DLO:R6_DLO + 4])
        dhi = limbs_u128(*row[R6_DHI:R6_DHI + 4])
        proto = prng.randint(int(row[R6_PLO]), int(row[R6_PHI]))
        if row[R6_PLO] == 0 and row[R6_PHI] == 255:
            proto = int(_COMMON_PROTOS[prng.randrange(len(_COMMON_PROTOS))])
        out[i, 0] = row[R6_ACL]
        out[i, T6_PROTO] = proto
        out[i, T6_SRC:T6_SRC + 4] = u128_limbs(prng.randint(slo, shi))
        out[i, T6_SPORT] = prng.randint(int(row[R6_SPLO]), int(row[R6_SPHI]))
        out[i, T6_DST:T6_DST + 4] = u128_limbs(prng.randint(dlo, dhi))
        out[i, T6_DPORT] = prng.randint(int(row[R6_DPLO]), int(row[R6_DPHI]))
        out[i, T6_VALID] = 1
    return out


def _prefix_bounds6(rng, r: int, min_len: int) -> tuple[np.ndarray, np.ndarray]:
    """[r, 4] lo and hi limbs of random 128-bit prefixes (/min_len to /128)."""
    length = rng.integers(min_len, 128, size=r, endpoint=True)
    base = rng.integers(0, 1 << 32, size=(r, 4), dtype=np.uint64)
    bits = np.clip(length[:, None] - 32 * np.arange(4), 0, 32).astype(np.uint64)
    mask = (np.uint64(0xFFFFFFFF) << (np.uint64(32) - bits)) & np.uint64(0xFFFFFFFF)
    lo = base & mask
    return lo.astype(np.uint32), (lo | (~mask & np.uint64(0xFFFFFFFF))).astype(np.uint32)


def synth_rule_rows6(acl: np.ndarray, seed: int = 0, min_prefix: int = 0) -> np.ndarray:
    """[R6, RULE6_COLS] uint32 v6 rule rows with the given acl column.

    The v6 twin of :func:`synth_rule_rows`: proto is any or one value,
    each port range the whole field, one value or a random [lo, hi], and
    src and dst random prefixes of length ``min_prefix`` to 128 (long
    prefixes make a line drawn inside one row miss every other row).
    R6_KEY is the row.
    """
    rng = np.random.default_rng(seed)
    r = len(acl)
    out = np.zeros((r, RULE6_COLS), dtype=np.uint32)
    out[:, R6_ACL] = acl
    one = rng.choice(np.array([6, 17, 58, 132], dtype=np.uint32), size=r)
    anyp = rng.random(r) < 0.4
    out[:, R6_PLO] = np.where(anyp, 0, one)
    out[:, R6_PHI] = np.where(anyp, 255, one)
    for lo_col, hi_col in ((R6_SPLO, R6_SPHI), (R6_DPLO, R6_DPHI)):
        kind = rng.integers(0, 3, size=r)
        a = rng.integers(0, 0xFFFF, size=r, endpoint=True)
        b = rng.integers(0, 0xFFFF, size=r, endpoint=True)
        out[:, lo_col] = np.where(kind == 0, 0, np.where(kind == 1, a, np.minimum(a, b)))
        out[:, hi_col] = np.where(kind == 0, 0xFFFF, np.where(kind == 1, a, np.maximum(a, b)))
    for lo_col, hi_col in ((R6_SLO, R6_SHI), (R6_DLO, R6_DHI)):
        out[:, lo_col:lo_col + 4], out[:, hi_col:hi_col + 4] = _prefix_bounds6(rng, r, min_prefix)
    out[:, R6_KEY] = np.arange(r, dtype=np.uint32)
    return out


def tuples_for_rules6(rules6: np.ndarray, n: int, seed: int = 0, rows=None,
                      miss_fraction: float = 0.1) -> np.ndarray:
    """[n, TUPLE6_COLS] valid v6 lines, each inside one of ``rows`` (default:
    every non-NO_ACL row) of rules whose address bounds are prefixes
    (:func:`synth_rule_rows6`); a ``miss_fraction`` of them random fields
    under the picked row's acl."""
    rng = np.random.default_rng(seed)
    if rows is None:
        rows = np.flatnonzero(rules6[:, R6_ACL] != NO_ACL)
    rr = rules6[rng.choice(np.asarray(rows), size=n)].astype(np.int64)
    out = np.zeros((n, TUPLE6_COLS), dtype=np.uint32)
    out[:, 0] = rr[:, R6_ACL]
    for col, lo, hi in ((T6_PROTO, R6_PLO, R6_PHI), (T6_SPORT, R6_SPLO, R6_SPHI),
                        (T6_DPORT, R6_DPLO, R6_DPHI)):
        out[:, col] = rng.integers(rr[:, lo], rr[:, hi] + 1)
    for col, lo, hi in ((T6_SRC, R6_SLO, R6_SHI), (T6_DST, R6_DLO, R6_DHI)):
        bits = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.int64)
        out[:, col:col + 4] = rr[:, lo:lo + 4] | (bits & (rr[:, lo:lo + 4] ^ rr[:, hi:hi + 4]))
    miss = rng.random(n) < miss_fraction
    out[miss, 1:T6_VALID] = rng.integers(0, 1 << 32, size=(int(miss.sum()), T6_VALID - 1),
                                         dtype=np.uint32)
    out[miss, T6_PROTO] &= 0xFF
    out[miss, T6_SPORT] &= 0xFFFF
    out[miss, T6_DPORT] &= 0xFFFF
    out[:, T6_VALID] = 1
    return out


def match6_edge_cases(n: int = 2048, seed: int = 0) -> dict:
    """Edge cases of the v6 match kernel's contract, by name.

    Each is ``(rules6 [R6, RULE6_COLS], tuples6 [n', TUPLE6_COLS])``,
    uint32, the rules unpadded (pipeline.pad_rules6 pads them with NO_ACL
    rows).  The first four take the ruleset ``synth_config(n_acls=4,
    rules_per_acl=64, v6_fraction=0.3)``: a ragged batch with corrupt acl
    ids (n_acls + 3, 0xFFFFFFF0) and NO_ACL all-zero lines, which match
    the first padding row; the same lines against rules where ACL 1 has
    no v6 rows (its lines get the empty span); the all-zero padding
    columns of a partial chunk; and one line.  The rest take synthetic
    rows (:func:`synth_rule_rows6`): one ACL of 8300 rows whose lines hit
    in its second half (a walk of many group steps) or, a tenth of them,
    nowhere; the rows of five ACLs interleaved; every line unmatched in a
    1000-row ACL; and spans of lengths that are not multiples of 8, 16
    or 32.
    """
    from .aclparse import parse_asa_config
    from .pack import R6_ACL as _ACL
    from .pack import pack_rulesets

    text = synth_config(n_acls=4, rules_per_acl=64, seed=seed, v6_fraction=0.3)
    packed = pack_rulesets([parse_asa_config(text, "fw1")])
    tuples = synth_tuples6(packed, n, seed=seed + 1)

    def damage(t, n_acls):
        t[::13, 0] = n_acls + 3
        t[5::29, 0] = 0xFFFFFFF0
        t[7::31, :T6_VALID] = 0
        t[7::31, 0] = NO_ACL
        t[3::10, T6_VALID] = 0
        return t

    damage(tuples, packed.n_acls)
    r6 = packed.rules6
    cases = {
        "ragged B with corrupt acls and NO_ACL zero lines": (r6, tuples),
        "an ACL with no v6 rows": (r6[r6[:, _ACL] != 1], tuples),
        "all-zero padding columns": (r6, np.zeros((n, TUPLE6_COLS), dtype=np.uint32)),
        "one line": (r6, tuples[:1].copy()),
    }
    u32 = np.uint32

    def blocks(*sizes_by_acl):
        return np.concatenate([np.full(k, a, dtype=u32) for a, k in sizes_by_acl])

    deep = synth_rule_rows6(np.zeros(8300, dtype=u32), seed=seed + 11, min_prefix=40)
    cases["one ACL of 8300 v6 rows, first hits deep"] = (deep, damage(tuples_for_rules6(
        deep, n, seed=seed + 11, rows=np.arange(4150, 8300)), 1))
    inter = synth_rule_rows6(np.random.default_rng(seed).integers(0, 5, size=600).astype(u32),
                             seed=seed + 12)
    cases["interleaved ACL rows"] = (inter, damage(tuples_for_rules6(inter, n, seed=seed + 12), 5))
    walk = synth_rule_rows6(blocks((0, 40), (1, 1000), (2, 300)), seed=seed + 13)
    walk[:, R6_PLO] = np.maximum(walk[:, R6_PLO], 1)
    walk[:, R6_PHI] = np.maximum(walk[:, R6_PHI], 1)
    unmatched = tuples_for_rules6(walk, n, seed=seed + 13, rows=np.arange(40, 1040))
    unmatched[:, T6_PROTO] = 0
    cases["every line unmatched in a 1000-row ACL"] = (walk, unmatched)
    odd = synth_rule_rows6(blocks((0, 1), (1, 7), (2, 9), (3, 15), (4, 17), (5, 31), (6, 33),
                                  (7, 47), (8, 97), (9, 3)), seed=seed + 14)
    cases["spans not multiples of 8, 16 or 32"] = (odd, damage(tuples_for_rules6(
        odd, n, seed=seed + 14), 10))
    return cases


def render_syslog6(
    packed: PackedRuleset,
    tuples6: np.ndarray,
    seed: int = 0,
    timestamp: str = "Jul 29 07:48:01",
    variety: float = 0.0,
) -> list[str]:
    """Render v6 tuple batches as ASA syslog text (text tier).

    Mirrors :func:`render_syslog`: 106100 by default; with ``variety`` a
    fraction of eligible lines render as the other handled message
    classes (106023, 302013/302015, 106001, 106006, 106015) with v6
    literals, constrained by protocol and resolvable bindings.
    """
    gid_to_name = {gid: (fw, acl) for (fw, acl), gid in packed.acl_gid.items()}
    in_iface = {}
    for (fw, iface), gid in packed.bindings.items():
        in_iface.setdefault((fw, gid), iface)
    out_ifaces: dict[str, list[str]] = {}
    for (fw, iface), _gid in packed.bindings_out.items():
        out_ifaces.setdefault(fw, []).append(iface)
    rng = np.random.default_rng(seed)
    verdicts = rng.random(tuples6.shape[0])
    kinds = rng.random(tuples6.shape[0])
    picks = rng.integers(0, 1 << 30, size=tuples6.shape[0])
    out = []
    for i, row in enumerate(tuples6):
        if not row[T6_VALID]:
            out.append(f"{timestamp} noise : not an ASA message")
            continue
        gid = int(row[0])
        fw, acl = gid_to_name[gid]
        proto = int(row[T6_PROTO])
        pname = _PROTO_NAMES.get(proto, str(proto))
        src = int_to_ip6(limbs_u128(*row[T6_SRC:T6_SRC + 4]))
        dst = int_to_ip6(limbs_u128(*row[T6_DST:T6_DST + 4]))
        sport, dport = int(row[T6_SPORT]), int(row[T6_DPORT])
        iface = in_iface.get((fw, gid))

        if variety and kinds[i] < variety:
            out.append(_variety_line(
                timestamp, fw, acl, pname, proto, src, dst, sport, dport,
                iface, out_ifaces, int(picks[i]), icmp_protos=(1, 58),
            ))
            continue

        verdict = "permitted" if verdicts[i] < 0.8 else "denied"
        if proto in (1, 58):
            paren_s, paren_d = dport, 0  # icmp type rides dport
        else:
            paren_s, paren_d = sport, dport
        out.append(
            f"{timestamp} {fw} : %ASA-6-106100: access-list {acl} {verdict} {pname} "
            f"inside/{src}({paren_s}) -> outside/{dst}({paren_d}) hit-cnt 1 first hit [0x0, 0x0]"
        )
    return out


def synth_syslog_file(
    packed: PackedRuleset,
    path: str,
    n_lines: int,
    seed: int = 0,
    miss_fraction: float = 0.1,
    chunk: int = 1 << 18,
    v6_fraction: float = 0.0,
) -> None:
    """Write ``n_lines`` of synthetic ASA syslog text to ``path``.

    Chunked generation keeps memory bounded; the text round-trips the real
    parse path (text tier), so this is the feedstock for end-to-end
    benchmarks and tests.  With ``v6_fraction`` > 0 and a ruleset that
    has IPv6 rows, that share of each chunk's lines are IPv6, shuffled
    among the v4 lines: a unified corpus, as the reference's ``synth
    --v6-fraction`` writes it (byte for byte when ``n_lines <= chunk``).
    """
    import random as _random

    with open(path, "w", encoding="utf-8") as f:
        remaining = n_lines
        i = 0
        while remaining > 0:
            m = min(chunk, remaining)
            s = seed + i
            n6 = int(m * v6_fraction) if packed.has_v6 else 0
            t = synth_tuples(packed, m - n6, seed=s, miss_fraction=miss_fraction)
            lines = render_syslog(packed, t, seed=s)
            if n6:
                t6 = synth_tuples6(packed, n6, seed=s, miss_fraction=miss_fraction)
                lines += render_syslog6(packed, t6, seed=s + 1)
                _random.Random(s).shuffle(lines)
            f.write("\n".join(lines))
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
