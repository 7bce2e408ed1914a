"""Count-min sketch on device: mergeable approximate per-key counts.

Counterpart of the reference's ``ops/cms.py``: a ``[depth, width]`` u32
register file (int64 here, see ops/hashing.py); update = scatter-add at
one multiply-shift bucket per depth row; query = min over rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..stages import scope
from .hashing import M32, MS_CONSTANTS, fmix32, mul_shift


def cms_init(width: int, depth: int, device) -> torch.Tensor:
    if width < 2 or width & (width - 1):
        raise ValueError(f"cms width must be a power of two >= 2, got {width}")
    if not 1 <= depth <= len(MS_CONSTANTS):
        raise ValueError(f"cms depth must be in 1..{len(MS_CONSTANTS)}, got {depth}")
    return torch.zeros((depth, width), dtype=torch.int64, device=device)


def cms_bucket(keys: torch.Tensor, width: int, depth: int) -> torch.Tensor:
    """[depth, B] bucket indices for each key (mixed then multiply-shifted)."""
    bits = int(width).bit_length() - 1
    mixed = fmix32(keys)
    rows = [mul_shift(mixed, int(c), bits) for c in MS_CONSTANTS[:depth]]
    return torch.stack(rows)


def cms_cells(keys: torch.Tensor, width: int, depth: int) -> torch.Tensor:
    """[depth * B] flat register indices of each key's bucket in every row."""
    rows = torch.arange(depth, dtype=torch.int64, device=keys.device)[:, None]
    return (rows * width + cms_bucket(keys, width, depth)).reshape(-1)


def cms_add_cells(cms: torch.Tensor, cells: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Add ``weights`` at :func:`cms_cells` indices, in place, wrapping mod 2**32."""
    with scope("ra.cms"):
        flat = cms.view(-1)
        flat.index_add_(0, cells, weights.repeat(cms.shape[0]))
        flat &= M32
        return cms


def cms_update(cms: torch.Tensor, keys: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Scatter-add ``weights`` for ``keys`` into every depth row, in place.

    Updates ``cms`` in place (the reference returns a new array): the
    register file is the caller's own state and nothing else holds it.
    Sums wrap mod 2**32 like the reference's u32 adds.
    """
    depth, width = cms.shape
    return cms_add_cells(cms, cms_cells(keys, width, depth), weights)


def cms_query(cms: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Point estimate per key: min over depth rows."""
    depth, width = cms.shape
    buckets = cms_bucket(keys, width, depth)  # [d, B]
    return torch.gather(cms, 1, buckets).amin(dim=0)


def cms_query_np(cms: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Pure-numpy query for host-side reporting (no device round trip)."""
    depth, width = cms.shape
    bits = int(width).bit_length() - 1
    x = keys.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    out = None
    for d in range(depth):
        b = (x * MS_CONSTANTS[d]) >> np.uint32(32 - bits)
        v = cms[d, b]
        out = v if out is None else np.minimum(out, v)
    return out
