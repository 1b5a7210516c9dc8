"""Bucketing helpers (port of the JAX package's ``server/batching.py``;
only ``next_bucket`` is on the ported path)."""

from __future__ import annotations


def next_bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)
