"""Kernel 5, ``relation_tile``: how two rule rows relate as boxes.

Counterpart of the reference's ``ops/overlap.py`` (``relation_tile``, XLA
there).  The match kernels ask which rule a packet hits; this asks the
packet-free dual: for two rule rows ``a`` and ``b``, both real (not
NO_ACL padding) and of the same ACL,

  ``covered[a, b]``  b's box contains a's on all five fields (proto,
                     src, sport, dst, dport): ``lo_b <= lo_a`` and
                     ``hi_a <= hi_b``, so an earlier b masks a whole;
  ``overlap[a, b]``  the boxes intersect on all five fields:
                     ``max(lo) <= min(hi)``.

Every compare is unsigned.  These two matrices are the whole input of the
static analyzer (runtime/staticanalysis.py).  :func:`pair_relations`
walks the O(R^2) pair space in fixed ``[tile, tile]`` tiles, one
:func:`relation_tile` call a tile.

The kernel is ``csrc/relation_tile.cu`` (CUDA C++ for sm_90a, built by
ops/_build.py); :func:`relation_tile_plain` beside it is the same
function as torch broadcast compares.  Rule rows cross the kernel
boundary as ``int32`` tensors holding u32 bits (``[T, RULE_COLS]``, the
pack layout with hi as hi, not hi - lo); the outputs are ``bool``.
:func:`relation_tile` runs the plain version for tensors on the CPU and
the kernel for tensors on a CUDA device; it never falls back from one to
the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hostside.pack import _RANGE_COLS, NO_ACL, R_ACL, RULE_COLS
from . import _build
from .hashing import u32_of

#: Default pair-tile edge (the reference's).
PAIR_TILE = 512

#: (lo, hi) column pairs of the five interval fields, from the pack
#: layer's range-column table.
_FIELDS = tuple((lo, hi) for lo, hi, _name in _RANGE_COLS)

#: Largest j-block the kernel's grid takes (65535 blocks of 64 rows).
MAX_TJ = 65535 * 64


def _check_rows(rows_i: torch.Tensor, rows_j: torch.Tensor) -> torch.device:
    for t in (rows_i, rows_j):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != RULE_COLS:
            raise ValueError(
                f"rule rows must be int32 (u32 bits) [T, {RULE_COLS}]; got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError("rule rows must be contiguous")
    dev = rows_i.device
    if rows_j.device != dev:
        raise ValueError(f"row blocks on two devices: {dev} and {rows_j.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if rows_i.shape[0] >= 1 << 31 or rows_j.shape[0] > MAX_TJ:
        raise ValueError(
            f"a tile of {rows_i.shape[0]} x {rows_j.shape[0]} rows exceeds the kernel's grid"
        )
    return dev


def relation_tile_plain(rows_i: torch.Tensor, rows_j: torch.Tensor):
    """Plain torch version of the kernel (same inputs, same outputs)."""
    ri = u32_of(rows_i)
    rj = u32_of(rows_j)
    acl_i = ri[:, R_ACL][:, None]
    acl_j = rj[:, R_ACL][None, :]
    same = (acl_i == acl_j) & (acl_i != int(NO_ACL)) & (acl_j != int(NO_ACL))
    covered = same
    overlap = same
    for lo, hi in _FIELDS:
        li, ha = ri[:, lo][:, None], ri[:, hi][:, None]
        lj, hb = rj[:, lo][None, :], rj[:, hi][None, :]
        covered = covered & (lj <= li) & (ha <= hb)
        overlap = overlap & (torch.maximum(li, lj) <= torch.minimum(ha, hb))
    return covered, overlap


def relation_tile(rows_i: torch.Tensor, rows_j: torch.Tensor):
    """One pair tile: ``([Ti, RULE_COLS], [Tj, RULE_COLS]) -> (covered,
    overlap)``, bool ``[Ti, Tj]`` each (semantics in the module docstring).
    Padding rows (acl == NO_ACL) relate to nothing."""
    dev = _check_rows(rows_i, rows_j)
    if dev.type == "cpu":
        return relation_tile_plain(rows_i, rows_j)
    lib = _build.library("relation_tile")
    ti, tj = rows_i.shape[0], rows_j.shape[0]
    covered = torch.empty((ti, tj), dtype=torch.bool, device=dev)
    overlap = torch.empty((ti, tj), dtype=torch.bool, device=dev)
    if ti == 0 or tj == 0:
        return covered, overlap
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ra_relation_tile(rows_i.data_ptr(), ti, rows_j.data_ptr(), tj,
                                  covered.data_ptr(), overlap.data_ptr(), stream)
    _build.check(lib, rc, "relation_tile launch")
    relation_tile.launches += 1
    return covered, overlap


#: launches of the relation_tile kernel in this process
relation_tile.launches = 0


def _pad_rows(rows: np.ndarray, to: int) -> np.ndarray:
    """Pad a row block to ``to`` rows with never-matching NO_ACL rows."""
    if rows.shape[0] == to:
        return rows
    out = np.zeros((to, RULE_COLS), dtype=np.uint32)
    out[:, R_ACL] = NO_ACL
    out[: rows.shape[0]] = rows
    return out


def iter_pair_tiles(r: int, tile: int = PAIR_TILE):
    """Tile-grid index iterator: yields ``(i0, i1, j0, j1)`` row ranges."""
    for i0 in range(0, r, tile):
        i1 = min(i0 + tile, r)
        for j0 in range(0, r, tile):
            yield i0, i1, j0, min(j0 + tile, r)


def pair_relations(
    rules: np.ndarray,
    tile: int = PAIR_TILE,
    devices: list | None = None,
    on_tile=None,
    lower_only: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Full ``[R, R]`` covered/overlap matrices via fixed-size tiles.

    Every tile is padded to ``[tile, tile]`` with NO_ACL rows, as in the
    reference.  ``devices`` (torch devices; default the CPU) round-robins
    tile rows across them.  ``on_tile(i0, j0)``, if given, is called once
    a tile BEFORE it is computed (the analyzer's ``analyze.tile`` fault
    seam).  ``lower_only`` skips tiles strictly above the diagonal (``j0 >
    i0``), leaving those entries False.
    """
    r = rules.shape[0]
    rules = np.ascontiguousarray(rules, dtype=np.uint32)
    covered = np.zeros((r, r), dtype=bool)
    overlap = np.zeros((r, r), dtype=bool)
    if r == 0:
        return covered, overlap
    devices = list(devices) if devices else [torch.device("cpu")]
    blocks: dict[tuple[int, int], torch.Tensor] = {}

    def block(b0: int, b1: int, d: int) -> torch.Tensor:
        if (b0, d) not in blocks:
            padded = _pad_rows(rules[b0:b1], tile)
            blocks[(b0, d)] = torch.from_numpy(padded.view(np.int32)).to(devices[d])
        return blocks[(b0, d)]

    for i0, i1, j0, j1 in iter_pair_tiles(r, tile):
        if lower_only and j0 > i0:
            continue
        if on_tile is not None:
            on_tile(i0, j0)
        d = (i0 // tile) % len(devices)
        cov, ovl = relation_tile(block(i0, i1, d), block(j0, j1, d))
        both = torch.stack([cov, ovl]).cpu().numpy()
        covered[i0:i1, j0:j1] = both[0, : i1 - i0, : j1 - j0]
        overlap[i0:i1, j0:j1] = both[1, : i1 - i0, : j1 - j0]
    return covered, overlap


def pair_relations_np(rules: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pure-numpy twin of :func:`pair_relations` (tests pin agreement)."""
    acl = rules[:, R_ACL]
    same = (acl[:, None] == acl[None, :]) & (acl != NO_ACL)[:, None] & (
        acl != NO_ACL
    )[None, :]
    covered = same.copy()
    overlap = same.copy()
    for lo, hi in _FIELDS:
        li, ha = rules[:, lo][:, None], rules[:, hi][:, None]
        lj, hb = rules[:, lo][None, :], rules[:, hi][None, :]
        covered &= (lj <= li) & (ha <= hb)
        overlap &= np.maximum(li, lj) <= np.minimum(ha, hb)
    return covered, overlap
