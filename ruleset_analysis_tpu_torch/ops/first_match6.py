"""Kernel 3, ``first_match6``: the IPv6 first-match scan on the GPU.

Counterpart of the reference's ``ops/match6.py`` ``first_match_rows6``
(an XLA block scan there).  The kernel is ``csrc/first_match6.cu`` (CUDA
C++ for sm_90a, built by ops/_build.py); :func:`first_match_rows6_plain`
beside it is the same function in plain torch, built on ops/match6.py's
block scan.

Line fields and rules cross the kernel boundary as ``int32`` tensors
holding u32 bit patterns: twelve ``[B]`` line fields in
:data:`~.match6.FIELDS6` order, the kernel's ``[R6p, RULE6_COLS]`` rule
tensor of :func:`prep_rules6`, its per-ACL row-span table (built by
:func:`~.first_match.acl_spans`, whose acl column is column 0 here too),
and a ``[B]`` row output with NO_MATCH as -1.

The kernel tests a line with a group of :data:`GROUP` lanes and reads
the rule rows through L1/L2 (the head of the source says why).

:func:`first_match_rows6` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device; it never falls back from
one to the other.
"""

from __future__ import annotations

import torch

from ..hostside.pack import (
    R6_ACL, R6_DHI, R6_DLO, R6_DPHI, R6_DPLO, R6_KEY, R6_PHI, R6_PLO, R6_SHI, R6_SLO,
    R6_SPHI, R6_SPLO, RULE6_COLS,
)
from ..stages import note_kernel, scope
from . import _build
from .first_match import RULE_TILE, check_lines, line_spans
from .hashing import M32, bits_of, u32_of
from .match import NO_MATCH
from .match6 import FIELDS6, first_match_rows6 as _plain_scan6

#: Kernel row layout (csrc/first_match6.cu): column of the kernel tensor
#: -> column of the reference's v6 row.  Scalar ranges hold hi - lo in
#: their hi slot (K6_DIFF); address bounds stay lo and hi.
K6_FROM_R6 = (
    R6_ACL, R6_PLO, R6_PHI, R6_SPLO,
    R6_SPHI, R6_DPLO, R6_DPHI, R6_KEY,
    *range(R6_SLO, R6_SLO + 4), *range(R6_SHI, R6_SHI + 4),
    *range(R6_DLO, R6_DLO + 4), *range(R6_DHI, R6_DHI + 4),
)
#: (hi column, lo column) of the kernel tensor's three scalar ranges
K6_DIFF = ((2, 1), (4, 3), (6, 5))


def prep_rules6(rules6: torch.Tensor) -> torch.Tensor:
    """[R6, RULE6_COLS] u32 (int64) rows -> the kernel's [R6p, RULE6_COLS] int32.

    Columns reordered by :data:`K6_FROM_R6` (six 16-byte groups, one
    operand each) with each scalar range's hi replaced by hi - lo (mod
    2^32).  R6p is R6 rounded up to RULE_TILE; padding rows carry
    NO_MATCH in the acl field and zeros elsewhere, as pack.py's NO_ACL
    rows do.
    """
    r = rules6.shape[0]
    rp = max(-(-r // RULE_TILE) * RULE_TILE, RULE_TILE)
    k = torch.zeros((rp, RULE6_COLS), dtype=torch.int64, device=rules6.device)
    k[:, 0] = NO_MATCH
    k[:r] = rules6[:, list(K6_FROM_R6)]
    for hi, lo in K6_DIFF:
        k[:, hi] = (k[:, hi] - k[:, lo]) & M32
    return bits_of(k).contiguous()


def plain_rules6(rules_k6: torch.Tensor) -> torch.Tensor:
    """The [R6p, RULE6_COLS] u32 (int64) reference-layout rows of a kernel tensor."""
    k = u32_of(rules_k6)
    for hi, lo in K6_DIFF:
        k[:, hi] = (k[:, hi] + k[:, lo]) & M32
    rules6 = torch.empty_like(k)
    rules6[:, list(K6_FROM_R6)] = k
    return rules6


def check_lines6(fields, rules_k6: torch.Tensor, acl_span: torch.Tensor) -> torch.device:
    """Validate kernel inputs (twelve fields, the v6 rule tensor); return the device."""
    if len(fields) != len(FIELDS6):
        raise ValueError(f"expected {len(FIELDS6)} v6 line fields {FIELDS6}, got {len(fields)}")
    return check_lines(fields, rules_k6, acl_span, rule_cols=RULE6_COLS)


def first_match_rows6_plain(fields, rules_k6: torch.Tensor,
                            acl_span: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel (same inputs, same output).

    The span table is a mask: a row outside a line's span never matches.
    """
    cols = {k: u32_of(f) for k, f in zip(FIELDS6, fields)}
    span = line_spans(cols["acl"], acl_span, rules_k6.shape[0])
    return bits_of(_plain_scan6(cols, plain_rules6(rules_k6), span=span))


#: lanes that test one line together (csrc/first_match6.cu G)
GROUP = 8


def first_match_rows6(fields, rules_k6: torch.Tensor, acl_span: torch.Tensor) -> torch.Tensor:
    """Global v6 row of the first matching rule per line; NO_MATCH (-1) if none.

    ``fields`` = the twelve [B] int32 line fields in FIELDS6 order;
    ``acl_span`` = ``first_match.acl_spans(rules_k6)``.
    """
    dev = check_lines6(fields, rules_k6, acl_span)
    with scope("ra.match6"):
        note_kernel("first_match6_kernel")
        if dev.type == "cpu":
            return first_match_rows6_plain(fields, rules_k6, acl_span)
        lib = _build.library("first_match6")
        b = fields[0].shape[0]
        out = torch.empty(b, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ra_first_match6(
                *(f.data_ptr() for f in fields), rules_k6.data_ptr(), rules_k6.shape[0],
                acl_span.data_ptr(), acl_span.shape[0], out.data_ptr(), b, stream,
            )
    _build.check(lib, rc, "first_match6 launch")
    first_match_rows6.launches += 1
    return out


#: launches of the first_match6 kernel in this process
first_match_rows6.launches = 0
