"""Kernel 1, ``first_match``: the first-match scan on the GPU.

Counterpart of the reference's ``ops/pallas_match.py``.  The kernel is
``csrc/first_match.cu`` (CUDA C++ for sm_90a, built by ops/_build.py);
:func:`first_match_rows_plain` beside it is the same function in plain
torch, built on ops/match.py's block scan.

Line fields and rules cross the kernel boundary as ``int32`` tensors
holding u32 bit patterns (torch has no usable uint32): six ``[B]`` line
fields, the kernels' ``[Rp, RULE_COLS]`` rule tensor of
:func:`prep_rules`, its per-ACL row-span table from :func:`acl_spans`,
and a ``[B]`` row output with NO_MATCH as -1.

:func:`first_match_rows` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device; it never falls back from
one to the other.
"""

from __future__ import annotations

import torch

from ..hostside.pack import R_ACL, RULE_COLS, WIRE_MAX_ACLS
from ..stages import note_kernel, scope
from . import _build
from .hashing import M32, bits_of, u32_of
from .match import FIELDS, NO_MATCH, first_match_rows as _plain_scan

#: Rp is a multiple of this (the reference's lane tile, pallas_match.RULE_TILE).
RULE_TILE = 128
#: The lo and hi columns of the five range pairs (pack.py); the kernels'
#: tensor holds hi - lo in each hi column.
LO_COLS = [1 + 2 * f for f in range(5)]
HI_COLS = [2 + 2 * f for f in range(5)]


def prep_rules(rules: torch.Tensor) -> torch.Tensor:
    """[R, RULE_COLS] u32 (int64) rows -> the kernels' [Rp, RULE_COLS] int32.

    The rows of ``rules`` with each range's hi replaced by hi - lo (mod
    2^32, the reference's own range test), one 48-byte row per rule so a
    kernel reads it with three 16-byte loads.  Rp is R rounded up to
    RULE_TILE; padding rows carry NO_MATCH in the acl field and all-zero
    ranges, as pack.py's NO_ACL rows and the reference's prep_rules do.
    """
    r = rules.shape[0]
    rp = -(-r // RULE_TILE) * RULE_TILE
    k = torch.zeros((rp, RULE_COLS), dtype=torch.int64, device=rules.device)
    k[:, R_ACL] = NO_MATCH
    k[:r] = rules
    k[:, HI_COLS] = (k[:, HI_COLS] - k[:, LO_COLS]) & M32
    return bits_of(k).contiguous()


def plain_rules(rules_k: torch.Tensor) -> torch.Tensor:
    """The [Rp, RULE_COLS] u32 (int64) rule rows of a kernel rule tensor.

    :func:`prep_rules`' rows, padding included, with each hi restored.
    """
    rules = u32_of(rules_k)
    rules[:, HI_COLS] = (rules[:, HI_COLS] + rules[:, LO_COLS]) & M32
    return rules


def acl_spans(rules_k: torch.Tensor) -> torch.Tensor:
    """Per-ACL row spans of the kernels' rule tensor: [A + 1, 2] int32.

    Entry ``a < A`` holds (first row whose acl is ``a``, one past the last
    such row); entry ``A`` holds the same for acl NO_MATCH (the padding
    rows).  A is 1 + the largest other acl id, at least 1; an acl with no
    rows gets the empty span (0, 0).  Built with torch ops on the rules'
    device, once per ruleset.  The kernels still compare the acl inside
    the span, so an ACL's rows need not be contiguous.
    """
    acl = u32_of(rules_k[:, R_ACL])
    pad = acl == NO_MATCH
    a = max(int(torch.where(pad, -1, acl).max()) + 1 if acl.numel() else 0, 1)
    if a > WIRE_MAX_ACLS:
        raise ValueError(f"rule acl id {a - 1} is beyond the {WIRE_MAX_ACLS} ACLs the kernels take")
    idx = torch.where(pad, a, acl)
    rows = torch.arange(acl.shape[0], dtype=torch.int64, device=acl.device)
    first = torch.full((a + 1,), acl.shape[0], dtype=torch.int64, device=acl.device)
    first.scatter_reduce_(0, idx, rows, "amin")
    last = torch.full((a + 1,), -1, dtype=torch.int64, device=acl.device)
    last.scatter_reduce_(0, idx, rows, "amax")
    first = torch.where(last < 0, 0, first)
    return torch.stack([first, last + 1], dim=1).to(torch.int32).contiguous()


def line_spans(acl: torch.Tensor, acl_span: torch.Tensor, rp: int):
    """(first, end) row of each line's span, [B] int64 each (csrc/scan.cuh line_span).

    ``acl`` is the lines' acl ids as u32 in int64.  Ids at or above A,
    other than NO_MATCH, get the empty span; every span is clamped to
    [0, rp).
    """
    a = acl_span.shape[0] - 1
    known = (acl < a) | (acl == NO_MATCH)
    span = acl_span.to(torch.int64)[torch.where(acl < a, acl, a)]
    first = torch.where(known, span[:, 0].clamp(min=0), 0)
    end = torch.where(known, span[:, 1].clamp(max=rp), 0)
    return first, end


def check_lines(fields, rules_k: torch.Tensor, acl_span: torch.Tensor, extra=(),
                rule_cols: int = RULE_COLS) -> torch.device:
    """Validate kernel inputs; return their common device.

    ``rule_cols`` is the width of a kernel rule row (RULE6_COLS for v6).
    """
    tensors = [*fields, *extra]
    b = tensors[0].shape[0] if tensors[0].dim() == 1 else -1
    dev = rules_k.device
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != b:
            raise ValueError(
                f"line fields must be 1-D int32 (u32 bits) of one length; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous() or t.device != dev:
            raise ValueError("line fields must be contiguous and on the rules' device")
    if b >= 1 << 31:
        raise ValueError(f"batch of {b} lines exceeds the kernels' int range")
    if (
        rules_k.dtype != torch.int32
        or rules_k.dim() != 2
        or rules_k.shape[1] != rule_cols
        or rules_k.shape[0] % RULE_TILE
        or not rules_k.is_contiguous()
        or rules_k.data_ptr() % 16
    ):
        raise ValueError(
            f"rules_k must be contiguous, 16-byte aligned int32 [Rp, {rule_cols}] with "
            f"Rp a multiple of {RULE_TILE} (prep_rules); got {rules_k.dtype} "
            f"{tuple(rules_k.shape)}"
        )
    if (
        acl_span.dtype != torch.int32
        or acl_span.dim() != 2
        or acl_span.shape[0] < 2
        or acl_span.shape[0] > WIRE_MAX_ACLS + 1
        or acl_span.shape[1] != 2
        or not acl_span.is_contiguous()
        or acl_span.data_ptr() % 8
        or acl_span.device != dev
    ):
        raise ValueError(
            f"acl_span must be a contiguous, 8-byte aligned int32 [A + 1, 2] table "
            f"(acl_spans) on the rules' device; got {acl_span.dtype} "
            f"{tuple(acl_span.shape)} on {acl_span.device}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def first_match_rows_plain(fields, rules_k: torch.Tensor, acl_span: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel (same inputs, same output).

    The span table is a mask: a row outside a line's span never matches.
    """
    cols = {k: u32_of(f) for k, f in zip(FIELDS, fields)}
    span = line_spans(cols["acl"], acl_span, rules_k.shape[0])
    return bits_of(_plain_scan(cols, plain_rules(rules_k), span=span))


def first_match_rows(fields, rules_k: torch.Tensor, acl_span: torch.Tensor) -> torch.Tensor:
    """Global row of the first matching rule per line; NO_MATCH (-1) if none.

    ``fields`` = (acl, proto, src, sport, dst, dport), each [B] int32;
    ``acl_span`` = :func:`acl_spans` of ``rules_k``.
    """
    dev = check_lines(fields, rules_k, acl_span)
    with scope("ra.match"):
        note_kernel("first_match_kernel")
        if dev.type == "cpu":
            return first_match_rows_plain(fields, rules_k, acl_span)
        lib = _build.library("first_match")
        b = fields[0].shape[0]
        out = torch.empty(b, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ra_first_match(
                *(f.data_ptr() for f in fields), rules_k.data_ptr(), rules_k.shape[0],
                acl_span.data_ptr(), acl_span.shape[0], out.data_ptr(), b, stream,
            )
    _build.check(lib, rc, "first_match launch")
    first_match_rows.launches += 1
    return out


#: launches of the first_match kernel in this process
first_match_rows.launches = 0
