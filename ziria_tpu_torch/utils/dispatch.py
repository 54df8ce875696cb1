"""Batch geometry helpers (counterpart of ziria_tpu/utils/dispatch.py
:81-100)."""

from __future__ import annotations

from typing import Sequence


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def pow2_bucket(n: int, min_bucket: int) -> int:
    """Power-of-two size bucket with a floor (symbol buckets floor at
    4, capture buckets at 512)."""
    return max(int(min_bucket), pow2_ceil(n))


def pad_lanes(lanes: Sequence) -> list:
    """Pad a non-empty lane list to the next power-of-two count by
    repeating lane 0. The batch shapes then match the reference's lane
    for lane; callers read only the first ``len(lanes)`` results."""
    lanes = list(lanes)
    return lanes + [lanes[0]] * (pow2_ceil(len(lanes)) - len(lanes))
