"""Exact per-key hit counts: a scatter-add into the key space.

Counterpart of the reference's ``ops/counts.py`` (the ``scatter``
formulation).  Totals are carried as a (lo, hi) u32 pair with manual
carry propagation, exactly as the reference does, so the registers load
into either package bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..stages import scope
from .hashing import M32


def segment_counts(keys: torch.Tensor, weights: torch.Tensor, n_keys: int) -> torch.Tensor:
    """[B] keys + [B] u32 weights -> [n_keys] u32 per-key sums (int64).

    Keys outside ``[0, n_keys)`` are dropped, like the reference's
    ``mode="drop"`` scatter.
    """
    ok = (keys >= 0) & (keys < n_keys)
    out = torch.zeros(n_keys, dtype=torch.int64, device=keys.device)
    out.index_add_(0, torch.where(ok, keys, 0), torch.where(ok, weights, 0))
    return out & M32


def add64(lo: torch.Tensor, hi: torch.Tensor, delta: torch.Tensor):
    """(lo, hi) u32 pair += delta (u32), exact 64-bit accumulation."""
    with scope("ra.counts"):
        new_lo = (lo + delta) & M32
        carry = (new_lo < delta).to(torch.int64)
        return new_lo, (hi + carry) & M32


def to_u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host-side: recombine the pair into numpy uint64."""
    return np.asarray(hi, dtype=np.uint64) * np.uint64(1 << 32) + np.asarray(lo, dtype=np.uint64)
