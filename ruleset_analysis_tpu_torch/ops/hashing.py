"""uint32 hashing primitives for the device-side sketches, in torch.

Counterpart of the reference's ``ops/hashing.py``: the murmur3 finalizer
(fmix32) seeded per use, and multiply-shift for power-of-two bucket
ranges.  Bit-identical to the reference on every input.

The u32 rule of the port: ``torch.uint32`` lacks subtraction, compares,
shifts and the scatter ops, so u32 values live in ``int64`` tensors in
``[0, 2**32)``.  Adds, xors and shifts then stay exact; a product is
reduced to its low 32 bits by :func:`mul32`, which never lets an int64
product overflow.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MAX_CMS_DEPTH as _MAX_CMS_DEPTH

#: Low-32-bit mask: ``x & M32`` is ``x mod 2**32`` for any int64 ``x``.
M32 = 0xFFFFFFFF

#: Odd multipliers for multiply-shift hashing, one per CMS depth row.
#: Fixed (not seeded) so sketches from different runs/devices merge.
MS_CONSTANTS = np.array(
    [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35],
    dtype=np.uint32,
)

#: murmur3 finalizer multipliers (fmix32), hash_pair's stream multiplier
#: and the seed step of its second mix.  csrc/reg_tail.cu takes these and
#: the constants above from ops/reg_tail.py, never its own literals.
FMIX_C1 = 0x85EBCA6B
FMIX_C2 = 0xC2B2AE35
PAIR_MUL = 0x9E3779B1
PAIR_SEED_STEP = 0x51ED

if len(MS_CONSTANTS) < _MAX_CMS_DEPTH:
    raise ImportError("config.MAX_CMS_DEPTH exceeds the hash constants")


def mul32(a: torch.Tensor, c: int | torch.Tensor) -> torch.Tensor:
    """``(a * c) mod 2**32`` for u32 values held in int64.

    A 32x32-bit product reaches 2**64, past int64.  Split ``c`` into 16-bit
    halves: ``a * c_lo`` and ``a * c_hi`` are each below 2**48, and only
    the low 16 bits of ``a * c_hi`` survive the shift by 16 into the low
    word.
    """
    c_lo = c & 0xFFFF
    c_hi = c >> 16
    return (a * c_lo + (((a * c_hi) & 0xFFFF) << 16)) & M32


def fmix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3 finalizer: a full-avalanche uint32 -> uint32 mix."""
    x = (x ^ (seed & M32)) & M32
    x = x ^ (x >> 16)
    x = mul32(x, FMIX_C1)
    x = x ^ (x >> 13)
    x = mul32(x, FMIX_C2)
    x = x ^ (x >> 16)
    return x


def hash_pair(a: torch.Tensor, b: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Mix two uint32 streams into one (order-sensitive)."""
    h = fmix32(a, seed=seed)
    return fmix32(h ^ mul32(b, PAIR_MUL), seed=seed + PAIR_SEED_STEP)


def mul_shift(x: torch.Tensor, const: int | torch.Tensor, bits: int) -> torch.Tensor:
    """Multiply-shift hash onto ``[0, 2**bits)`` — bucket index for sketches."""
    return mul32(x, const) >> (32 - bits)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of uint32, branch-free (5-step binary search).

    Exact integer computation — no float log tricks, which round near
    powers of two and would bias HLL ranks.
    """
    n = torch.full_like(x, 32)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = torch.where(big, n - shift, n)
        x = torch.where(big, x >> shift, x)
    # here x is 0 or 1; subtract the final bit
    return n - x


def u32_of(bits: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding u32 bit patterns -> int64 u32 values."""
    return bits.to(torch.int64) & M32


def bits_of(u32: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor holding the same bit patterns."""
    return torch.where(u32 > 0x7FFFFFFF, u32 - (1 << 32), u32).to(torch.int32)
