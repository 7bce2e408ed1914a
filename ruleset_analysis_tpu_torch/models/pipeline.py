"""The analysis pipeline: one device step over a batch, and finalize.

Counterpart of the reference's ``models/pipeline.py`` (flat layout, v4,
scatter update path) and of its one-device ``parallel/step.py`` step:

  batch -> first-match keys -> { exact 64-bit counts, CMS, per-rule HLL,
                                 top-K talker candidates }

The state is a tuple of u32 register files, held as int64 tensors in
``[0, 2**32)`` (ops/hashing.py), each mergeable (add for counts/CMS, max
for HLL).  :func:`state_to_numpy` / :func:`state_from_numpy` carry them
to and from the reference's ``pipeline.state_to_host`` dict shape, so a
register file moves between the two packages bit for bit.

Unlike the reference, the step updates the state's tensors in place: the
registers belong to the streaming loop and nothing else holds them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import AnalysisConfig
from ..errors import NotPorted
from ..hostside.pack import (
    NO_ACL,
    R_ACL,
    RULE_BLOCK,
    RULE_COLS,
    T_ACL, T_DPORT, T_DST, T_PROTO, T_SPORT, T_SRC, T_VALID,
    TUPLE_COLS, W_DST, W_META, W_PORTS, W_SRC, WIRE_COLS, WIRE_MAX_ACLS,
    PackedRuleset,
)
from ..ops import cms as cms_ops
from ..ops import counts as count_ops
from ..ops import first_match, match_hist
from ..ops import hll as hll_ops
from ..ops import topk as topk_ops
from ..ops.hashing import u32_of


class DeviceRuleset(NamedTuple):
    """Device-resident rule tensors."""

    rules: torch.Tensor  # [R, RULE_COLS] int64 u32, R % RULE_BLOCK == 0
    deny_key: torch.Tensor  # [n_acls] int64
    rules_fm: torch.Tensor  # [RULE_COLS, Rp] int32 u32 bits, field-major (kernels)


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

    Accepts the working layout ``[TUPLE_COLS, B]`` or the wire layout
    ``[WIRE_COLS, B]`` (bit-packed, 16 B/line, see pack.compact_batch),
    both int32 holding u32 bits.  Masks follow each shift, so the int32
    arithmetic shift gives the unsigned result.
    """
    if batch.dtype != torch.int32 or batch.dim() != 2:
        raise ValueError(f"batch must be 2-D int32 (u32 bits), got {batch.dtype} {tuple(batch.shape)}")
    if batch.shape[0] == WIRE_COLS:
        meta, ports = batch[W_META], batch[W_PORTS]
        cols = {
            "acl": meta & (WIRE_MAX_ACLS - 1),
            "proto": (meta >> 24) & 0xFF,
            "src": batch[W_SRC].contiguous(),
            "sport": (ports >> 16) & 0xFFFF,
            "dst": batch[W_DST].contiguous(),
            "dport": ports & 0xFFFF,
        }
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
        f"batch field axis must be TUPLE_COLS={TUPLE_COLS} or "
        f"WIRE_COLS={WIRE_COLS}, got shape {tuple(batch.shape)}"
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
    """Padded rule tensors on ``device``; refuses rulesets with IPv6 rows."""
    if packed.has_v6:
        raise NotPorted(
            f"the packed ruleset has {packed.rules6.shape[0]} IPv6 rule rows; "
            "IPv6 is not yet ported to the torch package (use the JAX package)"
        )
    rules = torch.from_numpy(pad_rules(packed.rules).astype(np.int64)).to(device)
    return DeviceRuleset(
        rules=rules,
        deny_key=torch.from_numpy(packed.deny_key.astype(np.int64)).to(device),
        rules_fm=first_match.prep_rules(rules),
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


def _update_registers(
    state: AnalysisState,
    keys: torch.Tensor,  # [B] int64 count keys (matched rule / implicit deny)
    valid: torch.Tensor,  # [B] int64 valid plane (0 = invalid)
    src: torch.Tensor,  # [B] int64 source IPs
    acl: torch.Tensor,  # [B] int64 ACL gids
    *,
    n_keys: int,
    topk_k: int,
    exact_counts: bool,
    salt: int = 0,
    topk_sample_shift: int = 0,
    counts_delta: torch.Tensor | None = None,
) -> tuple[AnalysisState, ChunkOut]:
    """Register tail of the step (the reference's scatter path).

    One per-key delta feeds BOTH the exact counts and the CMS: count-min
    updates are linear in per-key increments, so updating from the
    [n_keys] delta is bit-identical to a batch-sized CMS update.
    ``counts_delta`` is the fused kernel's histogram fold, when it ran.
    """
    if counts_delta is None:
        counts_delta = count_ops.segment_counts(keys, valid, n_keys)
    hll = hll_ops.hll_update(state.hll, keys, src, valid)
    if exact_counts:
        lo, hi = count_ops.add64(state.counts_lo, state.counts_hi, counts_delta)
    else:
        lo, hi = state.counts_lo, state.counts_hi
    key_ids = torch.arange(n_keys, dtype=torch.int64, device=keys.device)
    cms = cms_ops.cms_update(state.cms, key_ids, counts_delta)
    talk_cms, ca, cs, ce = topk_ops.talker_chunk_update(
        state.talk_cms, acl, src, valid, topk_k, salt=salt,
        sample_shift=topk_sample_shift,
    )
    return (
        AnalysisState(counts_lo=lo, counts_hi=hi, cms=cms, hll=hll, talk_cms=talk_cms),
        ChunkOut(cand_acl=ca, cand_src=cs, cand_est=ce),
    )


def analysis_step(
    state: AnalysisState,
    ruleset: DeviceRuleset,
    batch: torch.Tensor,  # [WIRE_COLS or TUPLE_COLS, B] int32
    *,
    n_keys: int,
    topk_k: int,
    exact_counts: bool = True,
    salt: int = 0,
    match_impl: str = "fused",
    topk_sample_shift: int = 0,
) -> tuple[AnalysisState, ChunkOut]:
    """One device step over a batch of packed log lines.

    ``match_impl="fused"`` runs the match_hist kernel (keys and the counts
    delta at once); ``"scan"`` runs the first_match kernel and the scatter
    counts.  On CPU tensors both run their kernels' plain versions.
    """
    cols, valid = batch_cols(batch)
    counts_delta = None
    if match_impl == "fused":
        keys, counts_delta = match_hist.match_keys_and_counts(
            cols, valid, ruleset.rules, ruleset.rules_fm, ruleset.deny_key, n_keys
        )
    elif match_impl == "scan":
        keys = first_match.match_keys(cols, ruleset.rules, ruleset.rules_fm, ruleset.deny_key)
    else:
        raise ValueError(f"match_impl must be 'fused' or 'scan', got {match_impl!r}")
    return _update_registers(
        state, keys, u32_of(valid), u32_of(cols["src"]), u32_of(cols["acl"]),
        n_keys=n_keys, topk_k=topk_k, exact_counts=exact_counts, salt=salt,
        topk_sample_shift=topk_sample_shift, counts_delta=counts_delta,
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
):
    """Pull registers to host and assemble the Report (the reference's finalize)."""
    import math

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
            name = gid_to_name.get(int(gid))
            if name is None:
                continue
            talkers.setdefault(name, []).extend(tracker.top(gid, topk))
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
