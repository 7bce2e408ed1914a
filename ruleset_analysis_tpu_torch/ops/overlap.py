"""Kernel 5, ``relation_grid``: how two rule rows relate as boxes.

Counterpart of the reference's ``ops/overlap.py`` (``relation_tile`` and
``pair_relations``, XLA there).  The match kernels ask which rule a packet
hits; this asks the packet-free dual: for two rule rows ``a`` and ``b``,
both real (not NO_ACL padding) and of the same ACL,

  ``covered[a, b]``  b's box contains a's on all five fields (proto,
                     src, sport, dst, dport): ``lo_b <= lo_a`` and
                     ``hi_a <= hi_b``, so an earlier b masks a whole;
  ``overlap[a, b]``  the boxes intersect on all five fields:
                     ``max(lo) <= min(hi)``.

Every compare is unsigned.  These two matrices are the whole input of the
static analyzer (runtime/staticanalysis.py).  The O(R^2) pair space is
walked in fixed ``[tile, tile]`` tiles, in the reference's order
(:func:`iter_pair_tiles`).

The kernel is ``csrc/relation_tile.cu`` (CUDA C++ for sm_90a, built by
ops/_build.py).  :func:`relation_grid` computes a whole work list of tiles
in one launch and writes bit-packed words; :func:`relation_grid_plain`
beside it is the same function in torch ops (per tile
:func:`relation_tile_plain`, then a pack into words).  Rule rows cross the
kernel boundary as ``int32`` tensors holding u32 bits (``[n,
RULE_COLS]``, the pack layout with hi as hi, not hi - lo).  The wrapper
runs the plain version for tensors on the CPU and the kernel for tensors
on a CUDA device; it never falls back from one to the other.

:func:`pair_relations_many` builds every tile of several row slabs (the
analyzer's ACLs) into one block tensor and one work list a device: one
copy to the device and one launch; then slab after slab, as the caller
asks, the words are unpacked and placed into that slab's matrices on the
device, and copied back.  :func:`pair_relations` is its one-slab case,
and :func:`relation_tile` its one-tile case.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from ..hostside.pack import _RANGE_COLS, NO_ACL, R_ACL, RULE_COLS
from ..stages import note_kernel, scope
from . import _build
from .hashing import bits_of, u32_of

#: Default pair-tile edge (the reference's).
PAIR_TILE = 512

#: (lo, hi) column pairs of the five interval fields, from the pack
#: layer's range-column table.
_FIELDS = tuple((lo, hi) for lo, hi, _name in _RANGE_COLS)

#: The kernel's block shape (csrc/relation_tile.cu ROWS, WORDS): 128
#: i-rows a block against 2 words (64 j-rows) of each matrix.
GRID_ROWS = 128
GRID_WORDS = 2

#: relations a word (bit k of word w holds j-row 32 w + k)
WORD_BITS = 32

#: tiles a device unpacks at a time in :func:`pair_relations_many`: its
#: temporaries are ~1.6 bytes a pair of each matrix, ~7 MiB at a 512 tile
UNPACK_TILES = 8

#: the bits of each byte value, least significant first: bool [256, 8]
_BYTE_BITS = torch.from_numpy(((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool))

#: int32 bits of the NO_ACL padding acl
_NO_ACL_BITS = int(NO_ACL) - (1 << 32)

#: the field columns the kernel reads (csrc/relation_tile.cu takes a row as
#: three uint4: acl, then lo/hi of proto, src, sport, dst, dport, then key)
assert _FIELDS == ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10)) and RULE_COLS == 12


def words_of(tile: int) -> int:
    """Words a row of one tile's matrix: ``ceil(tile / 32)``."""
    return -(-tile // WORD_BITS)


def grid_size(n_tiles: int, tile: int) -> int:
    """Blocks of the kernel's grid for ``n_tiles`` tiles of edge ``tile``."""
    return n_tiles * -(-tile // GRID_ROWS) * -(-words_of(tile) // GRID_WORDS)


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
    return dev


def _check_grid(blocks: torch.Tensor, work: torch.Tensor, tile: int) -> None:
    """Raise on what the kernel does not take."""
    _check_rows(blocks, blocks)
    if not isinstance(tile, int) or tile < 1:
        raise ValueError(f"tile must be a positive int, got {tile!r}")
    if blocks.shape[0] % tile:
        raise ValueError(f"{blocks.shape[0]} block rows are not whole tiles of {tile}")
    n_blocks = blocks.shape[0] // tile
    if work.dtype != torch.int32 or work.dim() != 2 or work.shape[1] != 2:
        raise ValueError(f"the work list must be int32 [n_tiles, 2]; got {work.dtype} "
                         f"{tuple(work.shape)}")
    if work.device.type != "cpu" or not work.is_contiguous():
        raise ValueError("the work list must be a contiguous tensor on the CPU (the host's)")
    if work.numel() and (int(work.min()) < 0 or int(work.max()) >= n_blocks):
        raise ValueError(f"the work list names blocks outside [0, {n_blocks})")
    if grid_size(work.shape[0], tile) >= 1 << 31:
        raise ValueError(f"{work.shape[0]} tiles of {tile} exceed the kernel's grid")


def relation_tile_plain(rows_i: torch.Tensor, rows_j: torch.Tensor):
    """One tile in torch broadcast compares: bool ``[Ti, Tj]`` covered and
    overlap (the reference's ``relation_tile``)."""
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


def pack_words(rel: torch.Tensor) -> torch.Tensor:
    """bool ``[T, Tj]`` -> int32 words ``[ceil(Tj / 32), T]``: bit k of word
    (w, a) is ``rel[a, 32 w + k]`` (0 past Tj)."""
    t, tj = rel.shape
    w = words_of(tj)
    bits = torch.zeros((t, w * WORD_BITS), dtype=torch.int64, device=rel.device)
    bits[:, :tj] = rel.to(torch.int64)
    weight = torch.ones(WORD_BITS, dtype=torch.int64, device=rel.device) << torch.arange(
        WORD_BITS, device=rel.device)
    return bits_of((bits.view(t, w, WORD_BITS) * weight).sum(-1)).t().contiguous()


def unpack_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words ``[..., W, T]`` -> bool ``[..., T, n]`` (the inverse of
    :func:`pack_words`; a view of ``[..., T, 32 W]``), on the words' device:
    each word's bytes, little end first (the H100's and the x86 host's
    order), looked up in :data:`_BYTE_BITS`.  Its temporaries are half a
    byte a bit (the int32 byte index) beside the bools."""
    t = words.transpose(-1, -2).contiguous()  # [..., T, W]
    b = t.reshape(-1).view(torch.uint8).to(torch.int32)
    bits = torch.index_select(_BYTE_BITS.to(words.device), 0, b)
    return bits.view(*t.shape[:-1], -1)[..., :n]


def relation_grid_plain(blocks: torch.Tensor, work: torch.Tensor, tile: int):
    """Plain torch version of the kernel (same inputs, same outputs): per
    tile :func:`relation_tile_plain`, then :func:`pack_words`."""
    n_t, w = work.shape[0], words_of(tile)
    out = torch.empty((2, n_t, w, tile), dtype=torch.int32, device=blocks.device)
    for t, (bi, bj) in enumerate(work.tolist()):
        rel = relation_tile_plain(blocks[bi * tile:(bi + 1) * tile],
                                  blocks[bj * tile:(bj + 1) * tile])
        for m in (0, 1):
            out[m, t] = pack_words(rel[m])
    return out[0], out[1]


def relation_grid(blocks: torch.Tensor, work: torch.Tensor, tile: int):
    """Every tile of a work list: ``(covered_bits, overlap_bits)``, int32
    (u32 bits) ``[n_tiles, ceil(tile / 32), tile]`` each.

    ``blocks`` is ``[n_blocks * tile, RULE_COLS]`` int32 rows (each block
    padded with NO_ACL rows), ``work`` an int32 ``[n_tiles, 2]`` CPU tensor
    of (i-block, j-block) pairs, which the wrapper copies to the blocks'
    device.  Word ``(t, w, a)`` holds in bit k the relation of row a of
    tile t's i-block to row ``32 w + k`` of its j-block.
    """
    _check_grid(blocks, work, tile)
    dev = blocks.device
    with scope("ra.overlap"):
        if dev.type == "cpu":
            note_kernel("relation_grid_kernel")
            return relation_grid_plain(blocks, work, tile)
        n_t = work.shape[0]
        out = torch.empty((2, n_t, words_of(tile), tile), dtype=torch.int32, device=dev)
        if n_t == 0:
            return out[0], out[1]
        if blocks.data_ptr() % 16:
            raise ValueError("the row blocks must start on a 16-byte boundary")
        lib = _build.library("relation_tile")
        note_kernel("relation_grid_kernel")
        with torch.cuda.device(dev):
            work_d = work.pin_memory().to(dev, non_blocking=True)  # no wait on the card
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ra_relation_grid(blocks.data_ptr(), work_d.data_ptr(), n_t, tile,
                                      out[0].data_ptr(), out[1].data_ptr(), stream)
    _build.check(lib, rc, "relation_grid launch")
    relation_grid.launches += 1
    relation_grid.tiles += n_t
    return out[0], out[1]


#: launches of the relation_grid kernel in this process, and the tiles
#: they computed
relation_grid.launches = 0
relation_grid.tiles = 0


def relation_tile(rows_i: torch.Tensor, rows_j: torch.Tensor):
    """One pair tile: ``([Ti, RULE_COLS], [Tj, RULE_COLS]) -> (covered,
    overlap)``, bool ``[Ti, Tj]`` each (semantics in the module docstring).
    Padding rows (acl == NO_ACL) relate to nothing.

    A one-tile work list through :func:`relation_grid` (both blocks padded
    to ``max(Ti, Tj)`` rows); the unpack of its words into bools is glue on
    the rows' device, not the kernel's function.
    """
    dev = _check_rows(rows_i, rows_j)
    ti, tj = rows_i.shape[0], rows_j.shape[0]
    if ti == 0 or tj == 0:
        empty = torch.zeros((ti, tj), dtype=torch.bool, device=dev)
        return empty, empty.clone()
    t = max(ti, tj)
    blocks = torch.zeros((2 * t, RULE_COLS), dtype=torch.int32, device=dev)
    blocks[:, R_ACL] = _NO_ACL_BITS
    blocks[:ti] = rows_i
    blocks[t:t + tj] = rows_j
    cov, ovl = relation_grid(blocks, torch.tensor([[0, 1]], dtype=torch.int32), t)
    return (unpack_words(cov[0], tj)[:ti].contiguous(),
            unpack_words(ovl[0], tj)[:ti].contiguous())


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


def grid_work(sizes, tile: int = PAIR_TILE, n_devices: int = 1, lower_only: bool = False):
    """The tile schedule of slabs of ``sizes`` rows.

    Returns ``(tiles, per_device)``.  ``tiles`` lists every tile in the
    reference's order (slab by slab, :func:`iter_pair_tiles` within one;
    with ``lower_only`` none with ``j0 > i0``) as ``(slab, i0, i1, j0, j1,
    device, index in that device's work list)``.  ``per_device[d]`` is
    ``(blocks, work)``: the ``(slab, b0)`` row blocks device d reads, in
    first use, and its int32 ``[n_tiles, 2]`` work list over them.  A
    tile's device is its i-block's index in the slab, round robin (the
    reference's).
    """
    tiles = []
    per_device = [({}, []) for _ in range(n_devices)]
    for s, r in enumerate(sizes):
        for i0, i1, j0, j1 in iter_pair_tiles(r, tile):
            if lower_only and j0 > i0:
                continue
            d = (i0 // tile) % n_devices
            index, work = per_device[d]
            for b0 in (i0, j0):
                index.setdefault((s, b0), len(index))
            tiles.append((s, i0, i1, j0, j1, d, len(work)))
            work.append((index[(s, i0)], index[(s, j0)]))
    return tiles, [(list(index), np.asarray(work, dtype=np.int32).reshape(-1, 2))
                   for index, work in per_device]


def pair_relations_many(
    slabs,
    tile: int = PAIR_TILE,
    devices: list | None = None,
    on_tile=None,
    lower_only: bool = False,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Each slab's full ``[R, R]`` covered/overlap matrices, tiled on its own.

    ``slabs`` are uint32 ``[R_k, RULE_COLS]`` row matrices (the analyzer's
    ACLs).  Every tile is padded to ``[tile, tile]`` with NO_ACL rows, as
    in the reference.  ``devices`` (torch devices; default the CPU)
    round-robins each slab's tile rows across them.  ``on_tile(k, i0,
    j0)``, if given, is called for every tile of every slab in the
    reference's order, all BEFORE any is computed (the analyzer's
    ``analyze.tile`` fault seam).  ``lower_only`` skips tiles strictly
    above the diagonal (``j0 > i0``), leaving those entries False; the
    diagonal tiles are computed whole.

    The call builds one block tensor and work list a device, copies it
    there and makes one :func:`relation_grid` launch; a device with no
    tiles gets none.  It returns an iterator that yields the slabs'
    ``(covered, overlap)`` in order, each unpacked when it is asked for:
    on each device its tiles' words, :data:`UNPACK_TILES` at a time, are
    placed into the slab's bool matrices there, which come back in one
    copy.  So besides the words (one bit a pair) one slab's matrices are
    held at a time, and the unpack's temporaries stay bounded.
    """
    slabs = [np.ascontiguousarray(s, dtype=np.uint32) for s in slabs]
    devices = list(devices) if devices else [torch.device("cpu")]
    tiles, per_device = grid_work([s.shape[0] for s in slabs], tile, len(devices), lower_only)
    if on_tile is not None:
        for s, i0, _i1, j0, _j1, _d, _k in tiles:
            on_tile(s, i0, j0)
    words = {}
    for d, (blocks, work) in enumerate(per_device):
        if not len(work):
            continue
        rows = np.empty((len(blocks) * tile, RULE_COLS), dtype=np.uint32)
        for n, (s, b0) in enumerate(blocks):
            rows[n * tile:(n + 1) * tile] = _pad_rows(slabs[s][b0:b0 + tile], tile)
        rows_d = torch.from_numpy(rows.view(np.int32)).to(devices[d])
        words[d] = relation_grid(rows_d, torch.from_numpy(work), tile)
    parts = [{} for _ in slabs]  # slab -> device -> its tiles there, in work order
    for s, i0, i1, j0, j1, d, k in tiles:
        parts[s].setdefault(d, []).append((i0, i1, j0, j1, k))
    return (_unpack_slab(s.shape[0], tile, p, words) for s, p in zip(slabs, parts))


def _unpack_slab(r: int, tile: int, parts: dict, words: dict):
    """One slab's ``(covered, overlap)`` from its tiles' words: the unpack
    and placement are glue on each device, not the kernel's function.  A
    slab's tiles on one device are consecutive in its work list."""
    out = None
    for d, mine in parts.items():
        cov, ovl = words[d]
        rel = torch.zeros((2, r, r), dtype=torch.bool, device=cov.device)
        k0 = mine[0][4]
        for c in range(0, len(mine), UNPACK_TILES):
            chunk = mine[c:c + UNPACK_TILES]
            ks = slice(k0 + c, k0 + c + len(chunk))
            bits = unpack_words(torch.stack((cov[ks], ovl[ks])), tile)
            for q, (i0, i1, j0, j1, _k) in enumerate(chunk):
                rel[:, i0:i1, j0:j1] = bits[:, q, : i1 - i0, : j1 - j0]
            del bits  # before the next chunk's
        host = rel.cpu().numpy()
        out = host if out is None else out | host  # tiles on two devices are disjoint
    if out is None:
        out = np.zeros((2, r, r), dtype=bool)
    return out[0], out[1]


def pair_relations(
    rules: np.ndarray,
    tile: int = PAIR_TILE,
    devices: list | None = None,
    on_tile=None,
    lower_only: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Full ``[R, R]`` covered/overlap matrices via fixed-size tiles: the
    one-slab :func:`pair_relations_many`, with ``on_tile(i0, j0)`` called
    for every tile before any is computed."""
    seam = None if on_tile is None else (lambda _s, i0, j0: on_tile(i0, j0))
    return next(pair_relations_many([rules], tile, devices, seam, lower_only))


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
