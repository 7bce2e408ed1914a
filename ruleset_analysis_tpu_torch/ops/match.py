"""The plain first-match scan: the reference mapper's inner loop, in torch.

Counterpart of the reference's ``ops/match.py`` (its default ``xla``
path).  For each log line, the first expanded ACE row of the line's ACL
whose five range predicates all hold wins; no row -> the ACL's implicit
deny.  First match == smallest matching global row index, because
pack.py emits rows in global configuration order.

The rule axis is scanned in blocks of ``rule_block`` rows with a
running-min carry, and the line axis in chunks of ``LINE_CHUNK`` lines,
so no temporary is larger than ``[LINE_CHUNK, rule_block]``.  This is
the plain version behind both CUDA kernels (ops/first_match.py,
ops/match_hist.py); on a CUDA device the port's main path runs the
kernels, not this.

All values are u32 held in int64 (see ops/hashing.py).
"""

from __future__ import annotations

import torch

from ..hostside.pack import (
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
    RULE_BLOCK,
)

#: Row index of "no rule matched" (u32 all-ones).
NO_MATCH = 0xFFFFFFFF

#: Lines per chunk of the plain scan (bounds its temporaries' memory).
LINE_CHUNK = 1 << 16

FIELDS = ("acl", "proto", "src", "sport", "dst", "dport")


def _block_min_row(cols: dict, rules: torch.Tensor, base: int) -> torch.Tensor:
    """Min matching global row index within one rule block; NO_MATCH if none."""

    def in_range(lo_col, hi_col, x):
        # unsigned wraparound range check: with lo <= hi (pack.py
        # guarantees it), x in [lo, hi]  <=>  (x - lo) mod 2**32 <= hi - lo
        lo = rules[:, lo_col][None, :]
        span = (rules[:, hi_col] - rules[:, lo_col]) & 0xFFFFFFFF
        return ((x[:, None] - lo) & 0xFFFFFFFF) <= span[None, :]

    ok = (
        (rules[:, R_ACL][None, :] == cols["acl"][:, None])
        & in_range(R_PLO, R_PHI, cols["proto"])
        & in_range(R_SLO, R_SHI, cols["src"])
        & in_range(R_SPLO, R_SPHI, cols["sport"])
        & in_range(R_DLO, R_DHI, cols["dst"])
        & in_range(R_DPLO, R_DPHI, cols["dport"])
    )
    idx = base + torch.arange(rules.shape[0], dtype=torch.int64, device=rules.device)
    return torch.where(ok, idx[None, :], NO_MATCH).amin(dim=1)


def first_match_rows(
    cols: dict,
    rules: torch.Tensor,
    rule_block: int = RULE_BLOCK,
) -> torch.Tensor:
    """Global row index of the first matching ACE per line; NO_MATCH if none.

    cols: dict of [B] int64 u32 columns (acl, proto, src, sport, dst,
    dport).  rules: [R, RULE_COLS] int64 u32 values; any R (the last block
    may be short).  Padding rows carry NO_ACL and never match.
    """
    b = cols["acl"].shape[0]
    out = torch.full((b,), NO_MATCH, dtype=torch.int64, device=rules.device)
    for s in range(0, b, LINE_CHUNK):
        part = {k: cols[k][s:s + LINE_CHUNK] for k in FIELDS}
        best = out[s:s + LINE_CHUNK]
        for r0 in range(0, rules.shape[0], rule_block):
            m = _block_min_row(part, rules[r0:r0 + rule_block], r0)
            torch.minimum(best, m, out=best)
    return out


def rows_to_keys(
    row: torch.Tensor,
    rules: torch.Tensor,
    deny_key: torch.Tensor,
    acl: torch.Tensor,
) -> torch.Tensor:
    """Global first-match row -> count key (shared by every match impl).

    NO_MATCH rows land on the line's ACL's implicit-deny key, with
    out-of-range ACL ids clamped to the last ACL.
    """
    matched = row != NO_MATCH
    safe_row = torch.where(matched, row, 0)
    rule_key = rules[:, R_KEY][safe_row]
    deny = deny_key[torch.clamp(acl, max=deny_key.shape[0] - 1)]
    return torch.where(matched, rule_key, deny)


def match_keys(
    cols: dict,
    rules: torch.Tensor,
    deny_key: torch.Tensor,
    rule_block: int = RULE_BLOCK,
) -> torch.Tensor:
    """Count-key per line: first-match rule key, or the line's ACL's
    implicit-deny key when nothing matches."""
    row = first_match_rows(cols, rules, rule_block)
    return rows_to_keys(row, rules, deny_key, cols["acl"])
