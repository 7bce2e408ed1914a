"""The data-parallel analysis step: each shard's match and tail, then the merges.

Counterpart of the reference's ``parallel/step.py`` (``_merge_tail``,
``_core_flat``, ``_core_stacked``, ``_core6`` and the step builders).
Per chunk each shard of the mesh runs the one-device step's match and
register tail (``models/pipeline.py``, with its hand kernels on a CUDA
device) over its columns of the batch, into deltas the reference's seams
define:

- the reg_tail kernel adds the shard's talker pairs into a zeroed
  ``[depth, width]`` delta, and its counts delta (or, on the fused
  route, match_hist's histograms folded) into its own buffer;
- it maxes the HLL cells into the replica of the shard's device (max is
  idempotent, so this is the reference's ``maximum(hll, pmax(delta))``).

Then the merges: counts delta SUM, talker delta SUM (both wrap at 2^32,
as the reference's u32 ``psum`` does), HLL MAX, across every shard: in
one process a sum on each device and copies between devices, across
processes ``torch.distributed`` ``all_reduce``.  Each replica then takes
``add64`` and the key CMS from the merged delta and adds the merged
talker delta.  Each shard selects its top-k candidates from its own
candidate table and lines against the merged talker CMS, ``k`` from its
own width; the candidates concatenate in mesh order (process-major, then
device), the reference's ``all_gather(tiled=True)``.

The merges run under the ``ra.merge`` stage range (stages.py), the
talker deltas' zeroing and adds under ``ra.talk``; so ``ra.merge``
shows in a capture only on a mesh of two or more shards.

Integer adds and maxes are associative and commutative, so the merged
registers equal a one-device run over the concatenated batch.  On a mesh
of one device in one process every merge is the identity: the step is
``pipeline.analysis_step`` (``analysis_step6``) as it stands.

The reference's ``_core_stacked`` matches each device's ``[G, C,
lane/n]`` shard against per-ACL rule slabs and feeds the group-major
keys to the same tail; here a stacked shard arrives flattened group-major
(``mesh.shard_grouped``) and steps on the flat scan route, whose kernel
walks only each line's own ACL span.  ``_core_tenant`` comes with the
tenant serve tier.
"""

from __future__ import annotations

import torch

from ..config import AnalysisConfig
from ..hostside.pack import PackedRuleset
from ..models import pipeline
from ..models.pipeline import AnalysisState, ChunkOut, Lines
from ..ops import counts as count_ops
from ..ops import reg_tail
from ..ops import topk as topk_ops
from ..ops.cms import cms_add_cells
from ..ops.hashing import M32
from ..stages import scope
from .mesh import Mesh


def _single(mesh: Mesh) -> bool:
    """One device in one process: the merges are the identity."""
    return len(mesh.devices) == 1 and mesh.n_processes == 1


def ship(packed: PackedRuleset, mesh: Mesh) -> tuple[pipeline.DeviceRuleset, ...]:
    """The v4 rule tensors on each distinct device of ``mesh``."""
    return tuple(pipeline.ship_ruleset(packed, d) for d in mesh.local_devices)


def ship6(packed: PackedRuleset, mesh: Mesh) -> tuple[pipeline.DeviceRuleset6, ...]:
    """The v6 rule tensors on each distinct device of ``mesh``."""
    return tuple(pipeline.ship_ruleset6(packed, d) for d in mesh.local_devices)


def init_state(n_keys: int, cfg: AnalysisConfig, mesh: Mesh) -> tuple[AnalysisState, ...]:
    """Zeroed registers, one replica on each distinct device of ``mesh``."""
    return tuple(pipeline.init_state(n_keys, cfg, d) for d in mesh.local_devices)


def replicate(state: AnalysisState, mesh: Mesh) -> tuple[AnalysisState, ...]:
    """``state`` on each distinct device of ``mesh`` (copies but the first,
    where it already lives there)."""
    return tuple(
        state if i == 0 and state.counts_lo.device == d
        else AnalysisState(*(t.to(d, copy=True) for t in state))
        for i, d in enumerate(mesh.local_devices)
    )


def merge_sum(mesh: Mesh, parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum mod 2^32 of every shard's ``parts[i]`` (int64 u32 values),
    as one tensor on each distinct device of ``mesh``."""
    with scope("ra.merge"):
        dev0 = mesh.local_devices[0]
        partial: dict[int, list[torch.Tensor]] = {}
        for i, t in enumerate(parts):
            partial.setdefault(mesh.replica[i], []).append(t)
        total = None
        for r in range(len(mesh.local_devices)):
            ts = partial[r]
            s = ts[0] if len(ts) == 1 else torch.stack(ts).sum(0)
            total = s if total is None else total + s.to(dev0)
        if len(parts) > 1:
            total = total & M32
        if mesh.n_processes > 1:
            import torch.distributed as dist

            dist.all_reduce(total, op=dist.ReduceOp.SUM)
            total &= M32
        return [total if r == 0 else total.to(d) for r, d in enumerate(mesh.local_devices)]


def merge_max(mesh: Mesh, replicas: list[torch.Tensor]) -> None:
    """Every replica of a register file (one per distinct device) takes the
    element-wise max of them all, across processes too, in place."""
    with scope("ra.merge"):
        h0 = replicas[0]
        for h in replicas[1:]:
            torch.maximum(h0, h.to(h0.device), out=h0)
        if mesh.n_processes > 1:
            import torch.distributed as dist

            dist.all_reduce(h0, op=dist.ReduceOp.MAX)
        for h in replicas[1:]:
            h.copy_(h0)


def gather_candidates(mesh: Mesh, cands: list[tuple]) -> ChunkOut:
    """Every shard's ``(cand_acl, cand_src, cand_est)``, concatenated in mesh
    order (process-major, then device) on this process's first device."""
    with scope("ra.merge"):
        dev0 = mesh.local_devices[0]
        cols = torch.stack([torch.cat([c[j].to(dev0) for c in cands]) for j in range(3)])
        if mesh.n_processes > 1:
            import torch.distributed as dist

            parts = [torch.empty_like(cols) for _ in range(mesh.n_processes)]
            dist.all_gather(parts, cols)
            cols = torch.cat(parts, dim=1)
        return ChunkOut(cand_acl=cols[0], cand_src=cols[1], cand_est=cols[2])


def _select(cnt, rep, m: Lines, talk_cms, k: int, *, salt: int, sample_shift: int,
            topk_every: int):
    return topk_ops.maybe_select(
        lambda: reg_tail.select_tables(cnt, rep, m.acl, m.src, talk_cms, k, acl_tag=m.acl_tag,
                                       salt=salt, sample_shift=sample_shift),
        salt, topk_every, k, m.row.device)


def shard_tails(state: tuple[AnalysisState, ...], mesh: Mesh, lines: list[Lines], *,
                salt: int = 0, topk_sample_shift: int = 0, select: bool = True):
    """The reg_tail kernel over every shard's lines: talker adds into zeroed
    deltas, HLL maxes into the shard's replica.  Returns the per-shard
    counts deltas, talker deltas and candidate tables ``(cnt, rep)``."""
    counts, talks, tables = [], [], []
    for i, m in enumerate(lines):
        st = state[mesh.replica[i]]
        with scope("ra.talk"):
            talk = torch.zeros_like(st.talk_cms)
        delta, cnt, rep = reg_tail.reg_tail(
            talk, st.hll, m.row, m.valid, m.acl, m.src, m.key_k, n_rows=m.n_rows,
            acl_tag=m.acl_tag, counts=m.counts_delta is None, salt=salt,
            sample_shift=topk_sample_shift, select=select)
        counts.append(m.counts_delta if m.counts_delta is not None else delta)
        talks.append(talk)
        tables.append((cnt, rep))
    return counts, talks, tables


def merge_registers(state: tuple[AnalysisState, ...], mesh: Mesh, counts: list, talks: list,
                    *, n_keys: int, exact_counts: bool) -> tuple[AnalysisState, ...]:
    """The merges: counts and talker deltas SUM, HLL MAX over every shard;
    then each replica takes ``add64``, the key CMS and the talker adds."""
    delta = merge_sum(mesh, counts)
    talk = merge_sum(mesh, talks)
    merge_max(mesh, [st.hll for st in state])
    new = []
    for r, st in enumerate(state):
        if exact_counts:
            lo, hi = count_ops.add64(st.counts_lo, st.counts_hi, delta[r])
        else:
            lo, hi = st.counts_lo, st.counts_hi
        depth, width = st.cms.shape
        cms = cms_add_cells(st.cms, pipeline.key_cms_cells(n_keys, width, depth,
                                                           st.cms.device), delta[r])
        with scope("ra.talk"):
            talk_cms = st.talk_cms.add_(talk[r]).bitwise_and_(M32)
        new.append(AnalysisState(counts_lo=lo, counts_hi=hi, cms=cms, hll=st.hll,
                                 talk_cms=talk_cms))
    return tuple(new)


def merge_tail(state: tuple[AnalysisState, ...], mesh: Mesh, lines: list[Lines], *,
               n_keys: int, topk_k: int, exact_counts: bool, salt: int = 0,
               topk_sample_shift: int = 0, topk_every: int = 1):
    """The register tail over every shard's matched lines, with the merges
    at the reference's seams; returns ``(replicas, ChunkOut)``."""
    counts, talks, tables = shard_tails(state, mesh, lines, salt=salt,
                                        topk_sample_shift=topk_sample_shift,
                                        select=topk_ops.selects(salt, topk_every))
    new = merge_registers(state, mesh, counts, talks, n_keys=n_keys, exact_counts=exact_counts)
    b = lines[0].row.shape[0]
    k = topk_ops.cand_k(min(topk_k, b), b, topk_sample_shift)
    cands = [
        _select(*tables[i], m, new[mesh.replica[i]].talk_cms, k, salt=salt,
                sample_shift=topk_sample_shift, topk_every=topk_every)
        for i, m in enumerate(lines)
    ]
    return new, gather_candidates(mesh, cands)


def _step_args(cfg: AnalysisConfig, n_keys: int) -> dict:
    s = cfg.sketch
    return dict(n_keys=n_keys, topk_k=s.topk_chunk_candidates, exact_counts=cfg.exact_counts,
                topk_sample_shift=s.topk_sample_shift, topk_every=s.topk_every)


def make_parallel_step(mesh: Mesh, cfg: AnalysisConfig, n_keys: int):
    """The data-parallel v4 step for ``mesh``.

    ``step(state, rules, shards, salt=0) -> (state, ChunkOut)``: ``state``
    the register replicas (:func:`init_state`), ``rules`` the rule tensors
    (:func:`ship`), ``shards`` one batch tensor per shard (the
    ``mesh.shard_batch`` layout, already readable on the caller's
    stream); the candidates are ``[n * k]``.  The stacked layout steps
    here too: its shards arrive flattened group-major
    (``mesh.shard_grouped``), and a stacked config runs the scan route.
    """
    impl = cfg.match_impl
    kw = _step_args(cfg, n_keys)

    def step(state, rules, shards, salt: int = 0):
        if _single(mesh):
            st, out = pipeline.analysis_step(state[0], rules[0], shards[0], salt=salt,
                                             match_impl=impl, **kw)
            return (st,), out
        lines = [pipeline.match_lines(rules[mesh.replica[i]], b, n_keys=n_keys, match_impl=impl)
                 for i, b in enumerate(shards)]
        return merge_tail(state, mesh, lines, salt=salt, **kw)

    return step


def make_parallel_step6(mesh: Mesh, cfg: AnalysisConfig, n_keys: int):
    """The data-parallel IPv6 step for ``mesh``: the v6 match on each shard
    (``rules`` from :func:`ship6`), then the v4 step's tail and merges into
    the same registers."""
    kw = _step_args(cfg, n_keys)

    def step(state, rules6, shards, salt: int = 0):
        if _single(mesh):
            st, out = pipeline.analysis_step6(state[0], rules6[0], shards[0], salt=salt, **kw)
            return (st,), out
        lines = [pipeline.match_lines6(rules6[mesh.replica[i]], b) for i, b in enumerate(shards)]
        return merge_tail(state, mesh, lines, salt=salt, **kw)

    return step

