"""Kernel 1, ``first_match``: the first-match scan on the GPU.

Counterpart of the reference's ``ops/pallas_match.py``.  The kernel is
``csrc/first_match.cu`` (CUDA C++ for sm_90a, built by ops/_build.py);
:func:`first_match_rows_plain` beside it is the same function in plain
torch, built on ops/match.py's block scan.

Line fields and rules cross the kernel boundary as ``int32`` tensors
holding u32 bit patterns (torch has no usable uint32): six ``[B]`` line
fields, the field-major ``[RULE_COLS, Rp]`` rule tensor of
:func:`prep_rules`, and a ``[B]`` row output with NO_MATCH as -1.

:func:`first_match_rows` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device; it never falls back from
one to the other.
"""

from __future__ import annotations

import torch

from ..hostside.pack import R_ACL, RULE_COLS
from . import _build
from .hashing import bits_of, u32_of
from .match import FIELDS, NO_MATCH, first_match_rows as _plain_scan, rows_to_keys

#: Rules per shared-memory tile (csrc/scan.cuh RULE_TILE); Rp is a multiple.
RULE_TILE = 128


def prep_rules(rules: torch.Tensor) -> torch.Tensor:
    """[R, RULE_COLS] u32 (int64) rows -> [RULE_COLS, Rp] int32, field-major.

    Rp is R rounded up to RULE_TILE; padding columns carry NO_MATCH in the
    acl field so they never match (mirrors pack.py's NO_ACL rows).
    """
    r = rules.shape[0]
    rp = -(-r // RULE_TILE) * RULE_TILE
    fm = torch.zeros((RULE_COLS, rp), dtype=torch.int64, device=rules.device)
    fm[R_ACL] = NO_MATCH
    fm[:, :r] = rules.T
    return bits_of(fm).contiguous()


def check_lines(fields, rules_fm: torch.Tensor, extra=()) -> torch.device:
    """Validate kernel inputs; return their common device."""
    tensors = [*fields, *extra]
    b = tensors[0].shape[0] if tensors[0].dim() == 1 else -1
    dev = rules_fm.device
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
        rules_fm.dtype != torch.int32
        or rules_fm.dim() != 2
        or rules_fm.shape[0] != RULE_COLS
        or rules_fm.shape[1] % RULE_TILE
        or not rules_fm.is_contiguous()
    ):
        raise ValueError(
            f"rules_fm must be contiguous int32 [{RULE_COLS}, Rp] with Rp a "
            f"multiple of {RULE_TILE} (prep_rules); got {rules_fm.dtype} "
            f"{tuple(rules_fm.shape)}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def first_match_rows_plain(fields, rules_fm: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel (same inputs, same output)."""
    cols = {k: u32_of(f) for k, f in zip(FIELDS, fields)}
    return bits_of(_plain_scan(cols, u32_of(rules_fm).T))


def first_match_rows(fields, rules_fm: torch.Tensor) -> torch.Tensor:
    """Global row of the first matching rule per line; NO_MATCH (-1) if none.

    ``fields`` = (acl, proto, src, sport, dst, dport), each [B] int32.
    """
    dev = check_lines(fields, rules_fm)
    if dev.type == "cpu":
        return first_match_rows_plain(fields, rules_fm)
    lib = _build.library("first_match")
    b = fields[0].shape[0]
    out = torch.empty(b, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ra_first_match(
            *(f.data_ptr() for f in fields), rules_fm.data_ptr(),
            rules_fm.shape[1], out.data_ptr(), b, stream,
        )
    _build.check(lib, rc, "first_match launch")
    first_match_rows.launches += 1
    return out


#: launches of the first_match kernel in this process
first_match_rows.launches = 0


def match_keys(cols: dict, rules: torch.Tensor, rules_fm: torch.Tensor,
               deny_key: torch.Tensor) -> torch.Tensor:
    """Count-key per line via the kernel (ops.match.match_keys twin).

    ``cols`` holds int32 line fields; returns int64 keys.
    """
    row = first_match_rows([cols[k] for k in FIELDS], rules_fm)
    return rows_to_keys(u32_of(row), rules, deny_key, u32_of(cols["acl"]))
