"""The analysis pipeline: one device step over a batch, and finalize.

Counterpart of the reference's ``models/pipeline.py`` (flat layout, both
address families) and of its one-device ``parallel/step.py`` steps, with
``_merge_tail``'s register tail as one kernel (``topk_every`` included;
its other formulations give the same registers and run the same tail).
The port's ``parallel/step.py`` runs :func:`match_lines` on each shard of
a mesh and merges the tails:

  batch -> first-match keys -> { exact 64-bit counts, CMS, per-rule HLL,
                                 top-K talker candidates }

IPv6 lines take a side path through the same registers
(:func:`analysis_step6`): their own rule tensor and kernel, sources
folded to a 32-bit digest, talker ACL gids tagged :data:`V6_ACL_TAG`.

The reference's stacked step (``analysis_step_stacked``, with
``ship_ruleset_stacked`` and its per-ACL rule slabs) has no counterpart
here: a grouped batch reaches :func:`analysis_step` as the flat batch of
its lines in group-major order (``pack.flatten_grouped``, in the stream
loop), whose scan route already walks only each line's own ACL span.
The reference's stacked step feeds the same group-major keys, valid
plane, sources and gids to the same register tail.

The state is a tuple of u32 register files, held as int64 tensors in
``[0, 2**32)`` (ops/hashing.py), each mergeable (add for counts/CMS, max
for HLL).  :func:`state_to_numpy` / :func:`state_from_numpy` carry them
to and from the reference's ``pipeline.state_to_host`` dict shape, so a
register file moves between the two packages bit for bit.

Unlike the reference, the step updates the state's tensors in place: the
registers belong to the streaming loop and nothing else holds them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import AnalysisConfig
from ..hostside.pack import (
    NO_ACL,
    R6_ACL,
    R6_KEY,
    R_ACL,
    R_KEY,
    RULE6_COLS,
    RULE_BLOCK,
    RULE_COLS,
    T6_ACL, T6_DPORT, T6_DST, T6_PROTO, T6_SPORT, T6_SRC, T6_VALID,
    T_ACL, T_DPORT, T_DST, T_PROTO, T_SPORT, T_SRC, T_VALID,
    TUPLE6_COLS, TUPLE_COLS, W6_DST, W6_META, W6_PORTS, W6_SRC, W6_WEIGHT,
    W_DST, W_META, W_PORTS, W_SRC, W_WEIGHT, WIRE6_COLS, WIRE6W_COLS, WIRE_COLS,
    WIRE_MAX_ACLS, WIREW_COLS,
    PackedRuleset,
)
from ..ops import cms as cms_ops
from ..ops import counts as count_ops
from ..ops import first_match, first_match6, match_hist, reg_tail
from ..ops import hll as hll_ops
from ..ops import topk as topk_ops
from ..stages import scope

#: High bit tagged onto the ACL gids of IPv6 talker candidates: v6 source
#: identities are 32-bit limb digests (ops.match6.fold_src32), and the tag
#: keeps them from ever merging with a numerically equal v4 address in the
#: talker tracker.  gids are bounded by WIRE_MAX_ACLS (23 bits), so bit 31
#: is free; reports strip the tag and render these as v6 addresses.  As
#: int32 a tagged gid is negative, so it is ORed onto the int64 u32 value.
V6_ACL_TAG = 0x80000000


class DeviceRuleset(NamedTuple):
    """Device-resident rule tensors."""

    rules: torch.Tensor  # [R, RULE_COLS] int64 u32, R % RULE_BLOCK == 0
    deny_key: torch.Tensor  # [n_acls] int64
    rules_k: torch.Tensor  # [Rp, RULE_COLS] int32 u32 bits, hi as hi - lo (kernels)
    acl_span: torch.Tensor  # [A + 1, 2] int32 per-ACL row spans of rules_k (kernels)
    key_k: torch.Tensor  # [Rp + A] int32 count key of each rules_k row, then deny keys (reg_tail)


class DeviceRuleset6(NamedTuple):
    """Device-resident IPv6 rule tensors (pack.rules6, limb layout).

    Shares the v4 key universe and deny_key; shipped only when the packed
    ruleset has v6 rows, so pure-v4 runs never touch the v6 path.
    """

    rules6: torch.Tensor  # [R6, RULE6_COLS] int64 u32, R6 % RULE_BLOCK == 0
    deny_key: torch.Tensor  # [n_acls] int64
    rules_k6: torch.Tensor  # [R6p, RULE6_COLS] int32 kernel layout (first_match6.prep_rules6)
    acl_span6: torch.Tensor  # [A + 1, 2] int32 per-ACL row spans of rules_k6
    key_k6: torch.Tensor  # [R6p + A] int32 count key of each rules_k6 row, then deny keys


class AnalysisState(NamedTuple):
    """All mergeable device registers for one analysis run (int64 u32)."""

    counts_lo: torch.Tensor  # [K]     exact hit counts, low word
    counts_hi: torch.Tensor  # [K]     exact hit counts, high word
    cms: torch.Tensor  # [d, w]        approximate per-key counts
    hll: torch.Tensor  # [K, m]        per-key unique-source registers
    talk_cms: torch.Tensor  # [d, w]   (acl, src) pair counts for top-K


class ChunkOut(NamedTuple):
    """Per-chunk host-bound outputs (top-K candidates, int64 u32)."""

    cand_acl: torch.Tensor  # [k]
    cand_src: torch.Tensor  # [k]
    cand_est: torch.Tensor  # [k]


def batch_cols(batch: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Field columns + valid plane of a batch, as int32 u32-bit tensors.

    Accepts the working layout ``[TUPLE_COLS, B]``, the wire layout
    ``[WIRE_COLS, B]`` (bit-packed, 16 B/line, see pack.compact_batch),
    or the WEIGHTED wire layout ``[WIREW_COLS, B]`` (a coalesced batch:
    the extra row carries each unique row's repetition count, which
    becomes the valid plane), all int32 holding u32 bits.  Masks follow
    each shift, so the int32 arithmetic shift gives the unsigned result.
    A weight at or above 2**31 is negative as int32: consumers read the
    valid plane as u32 (``u32_of``, or an unsigned load in a kernel).
    """
    with scope("ra.unpack"):
        return _batch_cols(batch)


def _batch_cols(batch: torch.Tensor) -> tuple[dict, torch.Tensor]:
    if batch.dtype != torch.int32 or batch.dim() != 2:
        raise ValueError(f"batch must be 2-D int32 (u32 bits), got {batch.dtype} {tuple(batch.shape)}")
    if batch.shape[0] in (WIRE_COLS, WIREW_COLS):
        meta, ports = batch[W_META], batch[W_PORTS]
        cols = {
            "acl": meta & (WIRE_MAX_ACLS - 1),
            "proto": (meta >> 24) & 0xFF,
            "src": batch[W_SRC].contiguous(),
            "sport": (ports >> 16) & 0xFFFF,
            "dst": batch[W_DST].contiguous(),
            "dport": ports & 0xFFFF,
        }
        if batch.shape[0] == WIREW_COLS:
            return cols, batch[W_WEIGHT].contiguous()
        return cols, (meta >> 23) & 1
    if batch.shape[0] == TUPLE_COLS:
        cols = {
            "acl": batch[T_ACL].contiguous(),
            "proto": batch[T_PROTO].contiguous(),
            "src": batch[T_SRC].contiguous(),
            "sport": batch[T_SPORT].contiguous(),
            "dst": batch[T_DST].contiguous(),
            "dport": batch[T_DPORT].contiguous(),
        }
        return cols, batch[T_VALID].contiguous()
    raise ValueError(
        f"batch field axis must be TUPLE_COLS={TUPLE_COLS}, "
        f"WIRE_COLS={WIRE_COLS} or WIREW_COLS={WIREW_COLS}, got shape {tuple(batch.shape)}"
    )


def batch_cols6(batch: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Field columns + valid plane of a v6 batch, as int32 u32-bit tensors.

    Accepts the working ``[TUPLE6_COLS, B]`` layout, the wire-v2
    ``[WIRE6_COLS, B]`` layout (40 B/line; ports and meta bit-packed as
    in the v4 wire words) and the weighted ``[WIRE6W_COLS, B]`` layout,
    whose last row carries the weights.  Address limbs surface as
    src0..src3 / dst0..dst3.  A weight at or above 2**31 is negative as
    int32: consumers read the valid plane as u32.
    """
    with scope("ra.unpack"):
        return _batch_cols6(batch)


def _batch_cols6(batch: torch.Tensor) -> tuple[dict, torch.Tensor]:
    if batch.dtype != torch.int32 or batch.dim() != 2:
        raise ValueError(f"batch must be 2-D int32 (u32 bits), got {batch.dtype} {tuple(batch.shape)}")
    if batch.shape[0] in (WIRE6_COLS, WIRE6W_COLS):
        meta, ports = batch[W6_META], batch[W6_PORTS]
        cols = {
            "acl": meta & (WIRE_MAX_ACLS - 1),
            "proto": (meta >> 24) & 0xFF,
            "sport": (ports >> 16) & 0xFFFF,
            "dport": ports & 0xFFFF,
        }
        for i in range(4):
            cols[f"src{i}"] = batch[W6_SRC + i].contiguous()
            cols[f"dst{i}"] = batch[W6_DST + i].contiguous()
        if batch.shape[0] == WIRE6W_COLS:
            return cols, batch[W6_WEIGHT].contiguous()
        return cols, (meta >> 23) & 1
    if batch.shape[0] == TUPLE6_COLS:
        cols = {
            "acl": batch[T6_ACL].contiguous(),
            "proto": batch[T6_PROTO].contiguous(),
            "sport": batch[T6_SPORT].contiguous(),
            "dport": batch[T6_DPORT].contiguous(),
        }
        for i in range(4):
            cols[f"src{i}"] = batch[T6_SRC + i].contiguous()
            cols[f"dst{i}"] = batch[T6_DST + i].contiguous()
        return cols, batch[T6_VALID].contiguous()
    raise ValueError(
        f"v6 batch field axis must be TUPLE6_COLS={TUPLE6_COLS}, WIRE6_COLS={WIRE6_COLS} "
        f"or WIRE6W_COLS={WIRE6W_COLS}, got shape {tuple(batch.shape)}"
    )


def pad_rules6(rules6: np.ndarray, rule_block: int = RULE_BLOCK) -> np.ndarray:
    """Pad the v6 rule matrix to a block multiple (NO_ACL padding rows)."""
    r = rules6.shape[0]
    target = max(rule_block, ((r + rule_block - 1) // rule_block) * rule_block)
    if r == target:
        return rules6
    out = np.zeros((target, RULE6_COLS), dtype=np.uint32)
    out[:, R6_ACL] = NO_ACL
    out[:r] = rules6
    return out


def ship_ruleset6(packed: PackedRuleset, device) -> DeviceRuleset6:
    """Padded v6 rule tensors on ``device``, with the kernel's layout and spans."""
    rules6 = torch.from_numpy(pad_rules6(packed.rules6).astype(np.int64)).to(device)
    rules_k6 = first_match6.prep_rules6(rules6)
    deny_key = torch.from_numpy(packed.deny_key.astype(np.int64)).to(device)
    return DeviceRuleset6(
        rules6=rules6,
        deny_key=deny_key,
        rules_k6=rules_k6,
        acl_span6=first_match.acl_spans(rules_k6),
        key_k6=reg_tail.key_table(rules6[:, R6_KEY], rules_k6.shape[0], deny_key),
    )


def pad_rules(rules: np.ndarray, rule_block: int = RULE_BLOCK) -> np.ndarray:
    """Pad the host rule matrix to a multiple of the scan block size."""
    r = rules.shape[0]
    target = max(rule_block, ((r + rule_block - 1) // rule_block) * rule_block)
    if r == target:
        return rules
    out = np.zeros((target, RULE_COLS), dtype=np.uint32)
    out[:, R_ACL] = NO_ACL
    out[:r] = rules
    return out


def ship_ruleset(packed: PackedRuleset, device) -> DeviceRuleset:
    """Padded v4 rule tensors on ``device`` (v6 rows ship by :func:`ship_ruleset6`)."""
    rules = torch.from_numpy(pad_rules(packed.rules).astype(np.int64)).to(device)
    rules_k = first_match.prep_rules(rules)
    deny_key = torch.from_numpy(packed.deny_key.astype(np.int64)).to(device)
    return DeviceRuleset(
        rules=rules,
        deny_key=deny_key,
        rules_k=rules_k,
        acl_span=first_match.acl_spans(rules_k),
        key_k=reg_tail.key_table(rules[:, R_KEY], rules_k.shape[0], deny_key),
    )


def register_bytes(n_keys: int, cfg: AnalysisConfig) -> dict[str, int]:
    """Per-register-file device memory as u32 (the reference's budget)."""
    s = cfg.sketch
    return {
        "counts": 2 * 4 * n_keys,
        "cms": 4 * s.cms_depth * s.cms_width,
        "hll": 4 * n_keys * s.hll_m,
        "talk_cms": 4 * s.talk_cms_depth * s.cms_width,
    }


def check_register_budget(n_keys: int, cfg: AnalysisConfig) -> None:
    """Refuse geometries whose registers exceed the configured budget.

    The same rule and message as the reference, in u32 bytes (the port
    holds them in int64, twice that).
    """
    sizes = register_bytes(n_keys, cfg)
    total = sum(sizes.values())
    budget = cfg.register_memory_budget_bytes
    if total <= budget:
        return
    non_hll = total - sizes["hll"]
    fit_p = -1
    for p in range(cfg.sketch.hll_p, 0, -1):
        if non_hll + 4 * n_keys * (1 << p) <= budget:
            fit_p = p
            break
    hint = (
        f"try --hll-p {fit_p}"
        if fit_p > 0
        else "even hll_p=1 does not fit; raise register_memory_budget_bytes "
        "or shrink the ruleset/cms geometry"
    )
    raise ValueError(
        f"sketch registers need {total / 2**20:.0f} MiB "
        f"(hll {sizes['hll'] / 2**20:.0f} MiB = {n_keys} keys x "
        f"{cfg.sketch.hll_m} registers x 4 B) but the budget is "
        f"{budget / 2**20:.0f} MiB; {hint}"
    )


def init_state(n_keys: int, cfg: AnalysisConfig, device) -> AnalysisState:
    check_register_budget(n_keys, cfg)
    s = cfg.sketch
    return AnalysisState(
        counts_lo=torch.zeros(n_keys, dtype=torch.int64, device=device),
        counts_hi=torch.zeros(n_keys, dtype=torch.int64, device=device),
        cms=cms_ops.cms_init(s.cms_width, s.cms_depth, device),
        hll=hll_ops.hll_init(n_keys, s.hll_p, device),
        talk_cms=cms_ops.cms_init(s.cms_width, s.talk_cms_depth, device),
    )


def state_to_numpy(state: AnalysisState) -> dict[str, np.ndarray]:
    """Every register file as host numpy uint32 (the reference's state_to_host)."""
    return {
        k: getattr(state, k).cpu().numpy().astype(np.uint32)
        for k in AnalysisState._fields
    }


def state_from_numpy(arrays: dict[str, np.ndarray], device) -> AnalysisState:
    """Inverse of :func:`state_to_numpy`: a reference register dict -> state."""
    return AnalysisState(**{
        k: torch.from_numpy(np.asarray(arrays[k], dtype=np.uint32).astype(np.int64)).to(device)
        for k in AnalysisState._fields
    })


@functools.lru_cache(maxsize=16)
def key_cms_cells(n_keys: int, width: int, depth: int, device: torch.device) -> torch.Tensor:
    """The key CMS's flat cells of every key (``cms_cells(arange(n_keys))``).

    Constant for a run, so computed once per geometry and device, not
    every step.
    """
    keys = torch.arange(n_keys, dtype=torch.int64, device=device)
    return cms_ops.cms_cells(keys, width, depth)


def _update_registers(
    state: AnalysisState,
    row: torch.Tensor,  # [B] int32 match-kernel rows (-1 = no match)
    valid: torch.Tensor,  # [B] int32 weight plane (u32 bits; 0 = invalid)
    acl: torch.Tensor,  # [B] int32 ACL gids
    src: tuple,  # ([B] int32 source IPs,) or the four v6 source limbs
    key_k: torch.Tensor,  # the match rows' key table (reg_tail.key_table)
    *,
    n_rows: int,  # match rows in key_k (the kernel rule tensor's Rp)
    n_keys: int,
    topk_k: int,
    exact_counts: bool,
    acl_tag: int = 0,
    salt: int = 0,
    topk_sample_shift: int = 0,
    counts_delta: torch.Tensor | None = None,
    topk_every: int = 1,
) -> tuple[AnalysisState, ChunkOut]:
    """Register tail of the step: the reference's ``_merge_tail`` on one device.

    Its collective merges become single-device ones: psum is the
    identity, and pmax a max into the live register file.  One per-key
    delta feeds BOTH the exact counts and the CMS: count-min updates are
    linear in per-key increments, so updating from the [n_keys] delta is
    bit-identical to a batch-sized CMS update.  ``counts_delta`` is the
    fused kernel's histogram fold, when it ran; else the reg_tail kernel
    (its plain version on CPU tensors) builds it.  ``topk_every`` defers
    candidate selection to chunks whose salt is a multiple of it.

    The reference's other formulations of this tail (``update_impl``
    sorted, ``counts_impl`` matmul and reduce) give the same registers
    by construction; the port accepts their flags and runs this tail.
    """
    b = row.shape[0]
    k = topk_ops.cand_k(min(topk_k, b), b, topk_sample_shift)
    select = topk_ops.selects(salt, topk_every)
    tail_delta, cnt, rep = reg_tail.reg_tail(
        state.talk_cms, state.hll, row, valid, acl, src, key_k, n_rows=n_rows, acl_tag=acl_tag,
        counts=counts_delta is None, salt=salt, sample_shift=topk_sample_shift, select=select)
    if counts_delta is None:
        counts_delta = tail_delta
    if exact_counts:
        lo, hi = count_ops.add64(state.counts_lo, state.counts_hi, counts_delta)
    else:
        lo, hi = state.counts_lo, state.counts_hi
    cms = cms_ops.cms_add_cells(
        state.cms, key_cms_cells(n_keys, state.cms.shape[1], state.cms.shape[0], row.device),
        counts_delta)
    ca, cs, ce = topk_ops.maybe_select(
        lambda: reg_tail.select_tables(cnt, rep, acl, src, state.talk_cms, k, acl_tag=acl_tag,
                                       salt=salt, sample_shift=topk_sample_shift),
        salt, topk_every, k, row.device)
    return (
        AnalysisState(counts_lo=lo, counts_hi=hi, cms=cms, hll=state.hll,
                      talk_cms=state.talk_cms),
        ChunkOut(cand_acl=ca, cand_src=cs, cand_est=ce),
    )


class Lines(NamedTuple):
    """A batch after its match: what the register tail reads."""

    row: torch.Tensor  # [B] int32 match-kernel rows (-1 = no match)
    valid: torch.Tensor  # [B] int32 weight plane (u32 bits)
    acl: torch.Tensor  # [B] int32 ACL gids
    src: tuple  # ([B] int32 source IPs,) or the four v6 source limbs
    key_k: torch.Tensor  # the match rows' key table (reg_tail.key_table)
    n_rows: int  # match rows in key_k
    acl_tag: int  # ORed onto the talker gids (V6_ACL_TAG for v6 lines)
    counts_delta: torch.Tensor | None  # [n_keys] from the fused kernel, else None


def match_lines(ruleset: DeviceRuleset, batch: torch.Tensor, *, n_keys: int,
                match_impl: str = "scan") -> Lines:
    """The first half of :func:`analysis_step`: unpack and match a v4 batch.

    ``match_impl="fused"`` runs the match_hist kernel (rows and the counts
    histograms at once, folded into the counts delta); ``"scan"`` runs
    the first_match kernel.  A weighted batch needs ``"scan"``.
    """
    cols, valid = batch_cols(batch)
    fields = [cols[k] for k in first_match.FIELDS]
    counts_delta = None
    if match_impl == "fused" and batch.shape[0] == WIREW_COLS:
        raise ValueError(
            "a weighted batch needs match_impl='scan': the fused match_hist "
            "kernel counts one per valid line, not its weight"
        )
    if match_impl == "fused":
        row, hist_rows, hist_deny = match_hist.match_rows_and_hists(
            fields, valid, ruleset.rules_k, ruleset.acl_span, ruleset.deny_key.shape[0])
        counts_delta = match_hist.counts_from_hists(
            hist_rows, hist_deny, ruleset.rules, ruleset.deny_key, n_keys)
    elif match_impl == "scan":
        row = first_match.first_match_rows(fields, ruleset.rules_k, ruleset.acl_span)
    else:
        raise ValueError(f"match_impl must be 'fused' or 'scan', got {match_impl!r}")
    return Lines(row, valid, cols["acl"], (cols["src"],), ruleset.key_k,
                 ruleset.rules_k.shape[0], 0, counts_delta)


def match_lines6(ruleset6: DeviceRuleset6, batch6: torch.Tensor) -> Lines:
    """The first half of :func:`analysis_step6`: unpack and match a v6 batch."""
    cols, valid = batch_cols6(batch6)
    row = first_match6.first_match_rows6(
        [cols[k] for k in first_match6.FIELDS6], ruleset6.rules_k6, ruleset6.acl_span6)
    return Lines(row, valid, cols["acl"], tuple(cols[f"src{i}"] for i in range(4)),
                 ruleset6.key_k6, ruleset6.rules_k6.shape[0], V6_ACL_TAG, None)


def analysis_step(
    state: AnalysisState,
    ruleset: DeviceRuleset,
    batch: torch.Tensor,  # [WIRE_COLS, WIREW_COLS or TUPLE_COLS, B] int32
    *,
    n_keys: int,
    topk_k: int,
    exact_counts: bool = True,
    salt: int = 0,
    match_impl: str = "scan",
    topk_sample_shift: int = 0,
    topk_every: int = 1,
) -> tuple[AnalysisState, ChunkOut]:
    """One device step over a batch of packed log lines.

    ``match_impl="fused"`` runs the match_hist kernel (rows and the counts
    histograms at once); ``"scan"`` runs the first_match kernel, and the
    counts come from the reg_tail kernel.  On CPU tensors every kernel
    runs its plain version.  A weighted batch (``[WIREW_COLS, B]``) needs
    ``"scan"``: match_hist adds one per valid line, whatever its weight.
    ``topk_every``: see :func:`_update_registers`.
    """
    m = match_lines(ruleset, batch, n_keys=n_keys, match_impl=match_impl)
    return _update_registers(
        state, m.row, m.valid, m.acl, m.src, m.key_k,
        n_rows=m.n_rows, n_keys=n_keys, topk_k=topk_k, exact_counts=exact_counts, salt=salt,
        topk_sample_shift=topk_sample_shift, counts_delta=m.counts_delta, topk_every=topk_every,
    )


def analysis_step6(
    state: AnalysisState,
    ruleset6: DeviceRuleset6,
    batch6: torch.Tensor,  # [TUPLE6_COLS, WIRE6_COLS or WIRE6W_COLS, B] int32
    *,
    n_keys: int,
    topk_k: int,
    exact_counts: bool = True,
    salt: int = 0,
    topk_sample_shift: int = 0,
    topk_every: int = 1,
) -> tuple[AnalysisState, ChunkOut]:
    """One device step over a batch of v6 lines.

    Updates the SAME registers as the v4 step (shared key universe):
    exact counts and CMS key by rule key; the HLL and talker source
    identity is the 32-bit limb digest (ops.match6.fold_src32, which the
    reg_tail kernel folds from the four limbs), with the talker gid
    tagged V6_ACL_TAG.  The match runs the first_match6 kernel (its plain
    version on CPU tensors); the tail is the v4 step's, as in the
    reference's ``_core6``; there is no fused v6 kernel, so weighted v6
    batches need no particular match_impl.
    """
    m = match_lines6(ruleset6, batch6)
    return _update_registers(
        state, m.row, m.valid, m.acl, m.src, m.key_k, n_rows=m.n_rows, n_keys=n_keys,
        topk_k=topk_k, exact_counts=exact_counts, acl_tag=m.acl_tag, salt=salt,
        topk_sample_shift=topk_sample_shift, topk_every=topk_every,
    )


def counts_total(state: AnalysisState) -> int:
    """Total hits across all keys, fetched to host (a synchronization point)."""
    lo = state.counts_lo.cpu().numpy().astype(np.uint64)
    hi = state.counts_hi.cpu().numpy().astype(np.uint64)
    return int((lo + (hi << np.uint64(32))).sum())


def finalize(
    state: AnalysisState,
    packed: PackedRuleset,
    cfg: AnalysisConfig,
    tracker: topk_ops.TopKTracker | None = None,
    *,
    topk: int = 10,
    totals: dict | None = None,
    backend: str = "torch",
    v6_digests: dict[int, int] | None = None,
):
    """Pull registers to host and assemble the Report (the reference's finalize).

    ``v6_digests`` maps fold_src32 digests -> 128-bit source ints (built
    by the stream loop as it reads v6 lines, capped), so v6 talkers
    render as addresses; a digest missing from the map renders as
    ``v6#<8 hex>``.
    """
    import math

    from ..hostside.aclparse import int_to_ip6
    from ..runtime.report import build_report

    regs = state_to_numpy(state)
    if cfg.exact_counts:
        per_key = count_ops.to_u64(regs["counts_lo"], regs["counts_hi"])
    else:
        per_key = cms_ops.cms_query_np(regs["cms"], np.arange(packed.n_keys, dtype=np.uint32))
    card = hll_ops.hll_estimate_np(regs["hll"])

    hits = {}
    uniq = {}
    for key_id, meta in enumerate(packed.key_meta):
        k = (meta.firewall, meta.acl, meta.index)
        hits[k] = int(per_key[key_id])
        if per_key[key_id] > 0:
            uniq[k] = int(round(card[key_id]))

    # HLL error band, and a --hll-p memory hint when the observed key
    # cardinality sits far below the sketch's size (as in the reference)
    totals = dict(totals or {})
    m = cfg.sketch.hll_m
    hll_info: dict = {
        "p": cfg.sketch.hll_p,
        "m": m,
        "rel_err_p90": round(1.04 / (m ** 0.5), 4),
    }
    u_max = max(uniq.values(), default=0)
    if u_max and u_max * 8 <= m and cfg.sketch.hll_p > 4:
        fit_p = max(4, math.ceil(math.log2(max(8 * u_max, 16))))
        if fit_p < cfg.sketch.hll_p:
            hll_info["hint"] = (
                f"observed per-rule cardinality tops out at ~{u_max}, far "
                f"below the hll_p={cfg.sketch.hll_p} sketch ({m} registers/"
                f"rule); --hll-p {fit_p} would cut HLL register memory "
                f"{2 ** (cfg.sketch.hll_p - fit_p)}x at ±"
                f"{100 * 1.04 / (2 ** fit_p) ** 0.5:.1f}% p90 error"
            )
    totals["hll"] = hll_info

    talkers = None
    if tracker is not None:
        gid_to_name = {gid: name for name, gid in packed.acl_gid.items()}
        talkers = {}
        for gid in tracker.acls():
            is6 = bool(int(gid) & V6_ACL_TAG)
            name = gid_to_name.get(int(gid) & ~V6_ACL_TAG)
            if name is None:
                continue
            items = tracker.top(gid, topk)
            if is6:
                dig = v6_digests or {}
                items = [
                    (int_to_ip6(dig[int(s)]) if int(s) in dig else f"v6#{int(s):08x}", c)
                    for s, c in items
                ]
            talkers.setdefault(name, []).extend(items)
        # one merged per-ACL section across families, ranked by count
        talkers = {
            k: sorted(v, key=lambda kv: -kv[1])[:topk]
            for k, v in talkers.items()
        }

    return build_report(
        packed,
        hits,
        backend=backend,
        totals=totals,
        unique_sources=uniq,
        talkers=talkers,
    )
