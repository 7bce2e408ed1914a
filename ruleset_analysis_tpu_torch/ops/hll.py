"""Per-key HyperLogLog registers on device: unique sources per rule.

Counterpart of the reference's ``ops/hll.py``.  Register file: ``[n_keys,
m]`` u32 (int64 here, see ops/hashing.py), m = 2**p.  Update is one
scatter-max per line: register index from p hash bits, rank = leading-zero
count of an independent hash + 1.  Rank 0 (invalid lines) is the identity
for max, so masking needs no branches.  Estimation runs host-side in
numpy at report time, identical to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashing import clz32, fmix32

_HLL_SEED_IDX = 0xB5297A4D
_HLL_SEED_RANK = 0x68E31DA4


def hll_init(n_keys: int, p: int, device) -> torch.Tensor:
    return torch.zeros((n_keys, 1 << p), dtype=torch.int64, device=device)


def hll_reg_rank(
    values: torch.Tensor, valid: torch.Tensor, p: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-line (register index, masked rank) — the HLL update's math."""
    h_idx = fmix32(values, seed=_HLL_SEED_IDX)
    h_rank = fmix32(values, seed=_HLL_SEED_RANK)
    reg = h_idx >> (32 - p)  # high p bits -> register index
    rank = clz32(h_rank) + 1  # 1..33
    rank = rank * (valid > 0).to(torch.int64)  # invalid -> 0 == identity for max
    return reg, rank


def hll_update(
    hll: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Fold ``values`` (e.g. src IPs) into each line's key's registers, in place.

    ``valid`` gates each line (``valid > 0``).  Keys outside
    ``[0, n_keys)`` are dropped, like the reference's ``mode="drop"``
    scatter: their rank becomes 0, the identity of max.
    """
    n_keys, m = hll.shape
    p = m.bit_length() - 1
    reg, rank = hll_reg_rank(values, valid, p)
    ok = (keys >= 0) & (keys < n_keys)
    idx = torch.where(ok, keys * m + reg, 0)
    hll.view(-1).scatter_reduce_(0, idx, torch.where(ok, rank, 0), "amax")
    return hll


# ---------------------------------------------------------------------------
# Host-side estimation (numpy), SURVEY.md §5 sketch-accuracy contract.
# ---------------------------------------------------------------------------


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


#: The value space folded into the registers: uint32 IPv4 sources.
VALUE_SPACE = 2.0**32


def hll_estimate_np(registers: np.ndarray) -> np.ndarray:
    """[K, m] registers -> [K] cardinality estimates (float64, host).

    Large-range behavior: the classic 32-bit HLL
    correction ``-2^32 ln(1 - E/2^32)`` compensates for hash COLLISIONS —
    distinct inputs landing on the same 32-bit hash, which makes the raw
    estimate count distinct hashes instead of distinct inputs.  This
    design has no such collisions: :func:`..ops.hashing.fmix32` is a
    bijection on uint32 (murmur3 finalizer — invertible), so n distinct
    IPv4 sources are n distinct rank-hash values, and the rank hash is
    full-width (independent of the p index bits) rather than the classic
    truncated 32-p bits.  Applying the classic correction here would
    INFLATE estimates ~39% at n = 2^31 (it assumes E under-counts).  The
    property tests in the reference's tests/test_sketches.py verify the uncorrected estimator
    holds the 1.04/sqrt(m) bound at 2^31 and beyond by exact inverse-CDF
    simulation of the without-replacement register distribution.

    The one true large-range artifact is rank truncation as n approaches
    the full 2^32 value space (every register saturates toward rank 33,
    and the raw estimate overshoots toward ``alpha * 2^33``); since the
    folded values ARE uint32 IPv4 addresses, the estimate is capped at
    the size of that space, which is also the exact answer in the
    saturated regime.
    """
    reg = np.asarray(registers, dtype=np.float64)
    k, m = reg.shape
    raw = _alpha(m) * m * m / np.sum(np.exp2(-reg), axis=1)
    zeros = np.sum(reg == 0, axis=1)
    # linear counting when the raw estimate is small and registers remain empty
    small = (raw <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        linear = m * np.log(m / np.maximum(zeros, 1e-12))
    return np.minimum(np.where(small, linear, raw), VALUE_SPACE)
