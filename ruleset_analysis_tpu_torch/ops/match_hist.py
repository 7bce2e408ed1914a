"""Kernel 2, ``match_hist``: first-match scan fused with count histograms.

Counterpart of the reference's ``ops/pallas_fused.py``.  The kernel is
``csrc/match_hist.cu``; :func:`match_rows_and_hists_plain` beside it is
the same function in plain torch (the block scan plus two masked
``index_add_`` histograms).  Besides the first-match rows it counts, over
valid lines only, lines per first-matched row (``hist_rows [Rp]``) and
unmatched lines per ACL (``hist_deny [Ap]``, acl clamped to n_acls - 1);
:func:`counts_from_hists` folds those into the per-key counts delta with
two row-sized scatters, replacing the batch-sized counts scatter.

Tensors cross the kernel boundary as in ops/first_match.py (int32 u32
bits).  :func:`match_rows_and_hists` runs the plain version for CPU
tensors and the kernel for CUDA tensors, never one in place of the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..hostside.pack import R_KEY
from ..stages import note_kernel, scope
from . import _build
from .first_match import RULE_TILE, check_lines, first_match_rows_plain
from .hashing import M32, u32_of
from .match import NO_MATCH


def acl_pad(n_acls: int) -> int:
    """Ap: the deny histogram's length, n_acls rounded up to RULE_TILE."""
    return -(-max(n_acls, 1) // RULE_TILE) * RULE_TILE


@functools.lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """Bytes of dynamic shared memory a match_hist block can have."""
    lib = _build.library("match_hist")
    out = ctypes.c_int(0)
    _build.check(lib, lib.ra_match_hist_smem_limit(device_index, ctypes.byref(out)),
                 "match_hist shared-memory query")
    return out.value


def uses_global_mode(rp: int, ap: int, device_index: int) -> bool:
    """True when the histograms cannot fit one block's shared memory.

    The kernel then accumulates straight into the global histograms with
    atomics (csrc/match_hist.cu global_mode) instead of per-block copies.
    """
    return 4 * (rp + ap) > smem_limit(device_index)


def match_rows_and_hists_plain(fields, valid: torch.Tensor, rules_k: torch.Tensor,
                               acl_span: torch.Tensor, n_acls: int):
    """Plain torch version of the kernel (same inputs, same outputs)."""
    rp, ap = rules_k.shape[0], acl_pad(n_acls)
    row = first_match_rows_plain(fields, rules_k, acl_span)
    r64, ok = u32_of(row), valid != 0
    hit = ok & (r64 != NO_MATCH)
    hist_rows = torch.zeros(rp, dtype=torch.int64, device=row.device)
    hist_rows.index_add_(0, r64[hit], torch.ones_like(r64[hit]))
    miss = ok & (r64 == NO_MATCH)
    a_cl = torch.clamp(u32_of(fields[0]), max=max(n_acls, 1) - 1)
    hist_deny = torch.zeros(ap, dtype=torch.int64, device=row.device)
    hist_deny.index_add_(0, a_cl[miss], torch.ones_like(a_cl[miss]))
    return row, hist_rows.to(torch.int32), hist_deny.to(torch.int32)


def match_rows_and_hists(fields, valid: torch.Tensor, rules_k: torch.Tensor,
                         acl_span: torch.Tensor, n_acls: int, *, force_global: bool = False):
    """First-match rows + row/deny histograms over the whole batch.

    ``fields`` = (acl, proto, src, sport, dst, dport) and ``valid``, each
    [B] int32; ``acl_span`` = ``first_match.acl_spans(rules_k)``.
    Returns ``(row [B], hist_rows [Rp], hist_deny [Ap])``, int32.
    ``force_global`` selects the kernel's global-atomic mode even where
    the histograms fit shared memory (for testing that mode).
    """
    dev = check_lines(fields, rules_k, acl_span, extra=(valid,))
    with scope("ra.match"):
        note_kernel("match_hist_kernel")
        if dev.type == "cpu":
            return match_rows_and_hists_plain(fields, valid, rules_k, acl_span, n_acls)
        lib = _build.library("match_hist")
        b, rp, ap = fields[0].shape[0], rules_k.shape[0], acl_pad(n_acls)
        n_acls = max(n_acls, 1)
        row = torch.empty(b, dtype=torch.int32, device=dev)
        hist_rows = torch.zeros(rp, dtype=torch.int32, device=dev)
        hist_deny = torch.zeros(ap, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            glob = force_global or uses_global_mode(rp, ap, torch.cuda.current_device())
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ra_match_hist(
                *(f.data_ptr() for f in fields), valid.data_ptr(), rules_k.data_ptr(), rp,
                acl_span.data_ptr(), acl_span.shape[0], n_acls, ap, row.data_ptr(),
                hist_rows.data_ptr(), hist_deny.data_ptr(), b, int(glob), stream,
            )
    _build.check(lib, rc, "match_hist launch")
    match_rows_and_hists.launches += 1
    return row, hist_rows, hist_deny


#: launches of the match_hist kernel in this process
match_rows_and_hists.launches = 0


def counts_from_hists(hist_rows: torch.Tensor, hist_deny: torch.Tensor,
                      rules: torch.Tensor, deny_key: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Fold row/deny histograms into per-KEY count deltas (int64 u32).

    Two row-sized scatters: rows -> keys via R_KEY (several ACE rows share
    one rule key), deny counts onto each ACL's deny key.  A line matches a padding row
    only when its acl is NO_ACL and its five fields are 0; it then counts
    on that row's R_KEY (0), where ops/reg_tail.key_table maps it too.
    Bit-identical to the counts delta the reg_tail kernel builds from the
    same rows.
    """
    with scope("ra.counts"):
        r, a = rules.shape[0], deny_key.shape[0]
        delta = torch.zeros(n_keys, dtype=torch.int64, device=rules.device)
        keys = rules[:, R_KEY]
        ok = keys < n_keys
        delta.index_add_(0, torch.where(ok, keys, 0), torch.where(ok, u32_of(hist_rows[:r]), 0))
        ok = deny_key < n_keys
        delta.index_add_(0, torch.where(ok, deny_key, 0),
                         torch.where(ok, u32_of(hist_deny[:a]), 0))
        return delta & M32
