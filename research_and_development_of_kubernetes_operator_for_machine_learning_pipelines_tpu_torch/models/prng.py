"""Threefry-2x32 counter-based PRNG in torch integer ops (the port's
counterpart of ``jax.random`` with its default ``threefry2x32``
implementation and ``jax_threefry_partitionable`` on, JAX's default).

A key is two uint32 words, held here as int64 ``[..., 2]`` (torch's
``uint32`` lacks most operations on CUDA); every add and rotate is masked
back to 32 bits, so the same code runs bit-identically on the CPU and on
the card.  Functions take a batch of keys ``[B, 2]`` (or one key ``[2]``)
and work on every row at once, with no loop over rows.

- ``key(seed)``: ``(0, seed mod 2**32)``, the key ``jax.random.key``
  derives when 64-bit integers are disabled, as the JAX package serves.
  A seed of 2**32 or more keeps only its low word there, so it does here.
- ``split(keys, num)``: the fold-like split, ``threefry(key, (0, i))``
  for i < num; ``split_keys(keys)``: its two halves, ``(carry, use)``.
- ``fold_in(keys, data)``: ``threefry(key, (0, data))``.
- ``random_bits(keys, shape)``: 32-bit words, ``hi ^ lo`` of
  ``threefry(key, (n >> 32, n & 0xFFFFFFFF))`` for the flat index n.
- ``uniform(keys, shape, minval, maxval)``: float32 from the top 23 bits.
- ``gumbel(keys, shape)``: ``-log(-log(u))`` over ``u`` uniform in
  [tiny, 1), JAX's "low" mode.  ``log`` is the device's, so gumbels agree
  with JAX to an ulp or two, not bit for bit.
- ``categorical(keys, logits)``: ``argmax(logits + gumbel)`` over the last
  axis, ``jax.random.categorical``'s Gumbel-max draw.
"""

from __future__ import annotations

from typing import Sequence

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``; int64 tensors holding uint32 values,
    broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def key(seed: int, device=None) -> torch.Tensor:
    """One key ``[2]`` from an integer seed: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``[..., 2]`` keys -> ``[..., num, 2]``: the ``num`` keys of each."""
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return torch.stack([a, b], dim=-1)


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance a batch of per-row keys: returns (carry, use)."""
    pairs = split(keys, 2)
    return pairs[..., 0, :], pairs[..., 1, :]


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """Fold a 32-bit integer (or an int tensor broadcast against the keys'
    batch) into each key."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits (as int64 in [0, 2**32)) of ``shape`` for each key:
    ``[*keys.shape[:-1], *shape]``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    batch = keys.shape[:-1]
    k1 = keys[..., 0].reshape(*batch, 1)
    k2 = keys[..., 1].reshape(*batch, 1)
    a, b = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (a ^ b).reshape(*batch, *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval): the top 23 bits as the mantissa
    of a float in [1, 2), minus one, scaled, then clamped below at minval,
    in JAX's order of float32 operations."""
    bits = random_bits(keys, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # The bounds and their span rounded to float32 on the host, as JAX
    # computes them; float32 values pass into the kernels exactly.
    lo, hi = torch.tensor([minval, maxval], dtype=torch.float32)
    span, lo = float(hi - lo), float(lo)
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard Gumbel draws, JAX's "low" mode."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(keys, shape, minval=tiny, maxval=1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw a row of ``logits [B, V]`` under ``keys [B, 2]``: the
    index of the largest ``logits + gumbel``, the lowest among equal
    maxima."""
    return torch.argmax(gumbel(keys, (logits.shape[-1],)) + logits, dim=-1)
