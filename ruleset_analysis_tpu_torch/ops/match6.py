"""The plain IPv6 first-match scan: 4x u32 limb addresses, in torch.

Counterpart of the reference's ``ops/match6.py`` (its flat path).  v6
rows live in a separate ``[R6, RULE6_COLS]`` tensor (hostside/pack.py);
splitting by family keeps first-match order, because a line can only
match ACEs of its own family.  Only the address test differs from the v4
scan: a 128-bit lexicographic bound pair over four big-endian limbs
(:func:`_ge128`, :func:`_le128`).  Proto and ports keep the v4
wraparound test.  The block scan, min matching row == first match and
NO_MATCH -> implicit deny key are those of ops/match.py.

This is the plain version behind the CUDA kernel (ops/first_match6.py);
on a CUDA device the port's main path runs the kernel, not this.

All values are u32 held in int64 (see ops/hashing.py).
"""

from __future__ import annotations

import torch

from ..hostside.pack import (
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
    RULE_BLOCK,
)
from .hashing import M32, mul32
from .match import LINE_CHUNK, NO_MATCH

#: line fields of a v6 batch (pipeline.batch_cols6)
FIELDS6 = ("acl", "proto", "sport", "dport",
           "src0", "src1", "src2", "src3", "dst0", "dst1", "dst2", "dst3")


def _ge128(x, lo):
    """x >= lo lexicographically; x/lo are 4-tuples of broadcastable u32."""
    x0, x1, x2, x3 = x
    l0, l1, l2, l3 = lo
    return (x0 > l0) | (
        (x0 == l0)
        & ((x1 > l1) | ((x1 == l1) & ((x2 > l2) | ((x2 == l2) & (x3 >= l3)))))
    )


def _le128(x, hi):
    x0, x1, x2, x3 = x
    h0, h1, h2, h3 = hi
    return (x0 < h0) | (
        (x0 == h0)
        & ((x1 < h1) | ((x1 == h1) & ((x2 < h2) | ((x2 == h2) & (x3 <= h3)))))
    )


def _block_min_row6(cols: dict, rules: torch.Tensor, base: int, span=None) -> torch.Tensor:
    """Min matching global v6 row index within one rule block; NO_MATCH if none.

    ``span`` = (first, end), [B] each: when given, rows outside a line's
    [first, end) never match it.
    """

    def col(i):
        return rules[:, i][None, :]

    def limbs_rule(c0):
        return tuple(col(c0 + i) for i in range(4))

    def limbs_line(name):
        return tuple(cols[f"{name}{i}"][:, None] for i in range(4))

    def in_range(lo_col, hi_col, x):
        # scalar wraparound check, as in ops.match (lo <= hi guaranteed)
        lo = col(lo_col)
        return ((x[:, None] - lo) & M32) <= ((col(hi_col) - lo) & M32)

    src = limbs_line("src")
    dst = limbs_line("dst")
    ok = (
        (col(R6_ACL) == cols["acl"][:, None])
        & in_range(R6_PLO, R6_PHI, cols["proto"])
        & _ge128(src, limbs_rule(R6_SLO))
        & _le128(src, limbs_rule(R6_SHI))
        & in_range(R6_SPLO, R6_SPHI, cols["sport"])
        & _ge128(dst, limbs_rule(R6_DLO))
        & _le128(dst, limbs_rule(R6_DHI))
        & in_range(R6_DPLO, R6_DPHI, cols["dport"])
    )
    idx = base + torch.arange(rules.shape[0], dtype=torch.int64, device=rules.device)
    if span is not None:
        ok &= (idx[None, :] >= span[0][:, None]) & (idx[None, :] < span[1][:, None])
    return torch.where(ok, idx[None, :], NO_MATCH).amin(dim=1)


def first_match_rows6(
    cols: dict,
    rules6: torch.Tensor,
    rule_block: int = RULE_BLOCK,
    span: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Global row index of the first matching v6 ACE per line; NO_MATCH if none.

    cols: dict of [B] int64 u32 columns (:data:`FIELDS6`).  rules6:
    [R6, RULE6_COLS] int64 u32 values; any R6 (the last block may be
    short).  Padding rows carry NO_ACL and all-zero fields, so they match
    only a line whose acl is NO_ACL and whose other fields are all 0.
    ``span`` = (first, end), each [B] int64, restricts each line to the
    rows [first, end) (the kernel's per-ACL row span).
    """
    b = cols["acl"].shape[0]
    out = torch.full((b,), NO_MATCH, dtype=torch.int64, device=rules6.device)
    for s in range(0, b, LINE_CHUNK):
        part = {k: cols[k][s:s + LINE_CHUNK] for k in FIELDS6}
        part_span = None if span is None else tuple(x[s:s + LINE_CHUNK] for x in span)
        best = out[s:s + LINE_CHUNK]
        for r0 in range(0, rules6.shape[0], rule_block):
            m = _block_min_row6(part, rules6[r0:r0 + rule_block], r0, part_span)
            torch.minimum(best, m, out=best)
    return out


def rows_to_keys6(
    row: torch.Tensor,
    rules6: torch.Tensor,
    deny_key: torch.Tensor,
    acl: torch.Tensor,
) -> torch.Tensor:
    """Global first-match v6 row -> count key; NO_MATCH -> the ACL's deny key.

    Out-of-range ACL ids are clamped onto the last ACL, as in v4.
    """
    matched = row != NO_MATCH
    safe_row = torch.where(matched, row, 0)
    rule_key = rules6[:, R6_KEY][safe_row]
    deny = deny_key[torch.clamp(acl, max=deny_key.shape[0] - 1)]
    return torch.where(matched, rule_key, deny)


def match_keys6(
    cols: dict,
    rules6: torch.Tensor,
    deny_key: torch.Tensor,
    rule_block: int = RULE_BLOCK,
) -> torch.Tensor:
    """Count-key per v6 line: first-match rule key or the ACL's deny key."""
    row = first_match_rows6(cols, rules6, rule_block)
    return rows_to_keys6(row, rules6, deny_key, cols["acl"])


#: fold_src32's multiplier for each source limb, most significant first
#: (csrc/reg_tail.cu takes them from ops/reg_tail.py TAIL_CONSTANTS)
FOLD_CONSTANTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


def fold_src32(cols: dict) -> torch.Tensor:
    """[B] u32 sketch identity of a v6 source address (int64 in, int64 out).

    HLL and talker registers key sources by one u32; v6 sources fold
    their four limbs by multiply-xor mixing, bit for bit the reference's
    fold (products mod 2^32 through :func:`mul32`).
    """
    h = 0
    for i, c in enumerate(FOLD_CONSTANTS):
        h = mul32(h ^ cols[f"src{i}"], c)
    return h ^ (h >> 15)
