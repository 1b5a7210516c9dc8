"""Radix-tree prefix KV cache: cross-request prompt reuse (port of the JAX
package's ``server/prefix_cache.py``; the port keeps its own copy because
importing any module of the reference's ``server`` package pulls in JAX).

Prompt K/V is a pure function of the token prefix (causal attention), so
K/V computed once for a prefix is copied, not recomputed, into every later
request that shares it.

- The reuse unit is the engine's prefill chunk: prompts are split into
  fixed-size chunks, and each chunk's K/V spans a contiguous slice of the
  batch-1 sequence cache.
- The index is a radix tree over chunks.  The path from the root is the
  cumulative key, so two prompts sharing ``k`` leading chunks share
  exactly ``k`` nodes.  Edges are keyed by the chunk's exact token bytes,
  never a digest: a collision would splice another prompt's K/V into a
  request.
- Each node owns host copies of its chunk's K/V (``[L, 1, C, NKV, D]``,
  the sequence cache's layout): torch CPU tensors in the engine (pinned
  on a CUDA engine, so the seed's copy to the card is one DMA), numpy
  arrays in the reference.  Only FULL chunks of real prompt tokens are
  cached; a padded tail carries pad-token K/V.
- Eviction is LRU over leaves under a byte budget (``nbytes`` counts the K
  and V bytes, as the reference counts them, so one budget evicts the
  same chunks).  Interior nodes are never evicted.
- An optional second tier (``l2_budget_bytes`` > 0) catches evicted
  leaves in a flat host pool keyed by the cumulative token bytes, under
  its own LRU budget; a radix-walk miss promotes from it.

All calls happen on the engine's scheduler thread: no locking.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass(frozen=True)
class PrefixCacheConfig:
    """Engine-side knobs (``--prefix-cache*`` / ``spec.tpu.prefixCache``)."""

    enabled: bool = False
    budget_bytes: int = 256 * 2**20
    # Reuse unit; must equal the engine's prefill chunk (or, when that is
    # unset, becomes it: enabling the cache enables chunked prefill).
    chunk_tokens: int = 64
    # Second-tier host pool for evicted chunks (0 = off).
    l2_budget_bytes: int = 0


def _nbytes(a) -> int:
    """Bytes of a host array: a numpy array or a torch tensor."""
    n = getattr(a, "nbytes", None)
    if n is not None:
        return int(n)
    return int(a.numel()) * int(a.element_size())


class _Node:
    __slots__ = ("key", "kv", "nbytes", "parent", "children", "last_used")

    def __init__(self, key: bytes, kv, nbytes: int, parent: "_Node | None"):
        self.key = key
        self.kv = kv  # (k, v) host arrays, or None on the root
        self.nbytes = nbytes
        self.parent = parent
        self.children: dict[bytes, _Node] = {}
        self.last_used = 0


def _chunk_key(prompt: np.ndarray, idx: int, chunk_tokens: int) -> bytes:
    chunk = np.asarray(prompt[idx * chunk_tokens: (idx + 1) * chunk_tokens], np.int32)
    return chunk.tobytes()


class RadixPrefixCache:
    """Radix tree of prompt chunks with an LRU-evicted host K/V pool."""

    def __init__(
        self,
        budget_bytes: int,
        chunk_tokens: int,
        on_evict: Callable[[int], None] | None = None,
        l2_budget_bytes: int = 0,
        on_l2_event: Callable[[str], None] | None = None,
    ):
        if budget_bytes <= 0:
            raise ValueError(f"prefix cache budget must be positive, got {budget_bytes}")
        if chunk_tokens <= 0:
            raise ValueError(
                f"prefix cache chunk_tokens must be positive, got {chunk_tokens}"
            )
        if l2_budget_bytes < 0:
            raise ValueError(f"prefix cache L2 budget must be >= 0, got {l2_budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.chunk_tokens = int(chunk_tokens)
        self._root = _Node(b"", None, 0, None)
        self._on_evict = on_evict
        # Leaves tracked incrementally: eviction must not walk the tree.
        self._leaves: set[_Node] = set()
        self.bytes = 0
        self.lookups = 0
        self.evictions = 0
        self._tick = 0
        # Second tier: cumulative token bytes -> (k, v, nbytes), LRU by
        # OrderedDict order.  A budget of 0 disables every L2 path.
        self.l2_budget_bytes = int(l2_budget_bytes)
        self._on_l2_event = on_l2_event
        self._l2: OrderedDict[bytes, tuple] = OrderedDict()
        self.l2_bytes = 0
        self.l2_hits = 0
        self.l2_spills = 0
        self.l2_evictions = 0

    def _note_l2(self, kind: str) -> None:
        if self._on_l2_event is not None:
            self._on_l2_event(kind)

    def _cum_key(self, node: _Node) -> bytes:
        """Cumulative token bytes of ``node``'s whole prefix (root path);
        only spill and promote pay this walk."""
        parts = []
        while node is not None and node.parent is not None:
            parts.append(node.key)
            node = node.parent
        return b"".join(reversed(parts))

    # -- queries -------------------------------------------------------------

    def lookup(self, prompt: np.ndarray) -> tuple[int, list]:
        """Longest cached prefix of ``prompt`` in whole chunks:
        ``(matched_tokens, [(k, v), ...])``, one host pair per chunk in
        order.  Capped STRICTLY below the prompt length (``matched <=
        ((len - 1) // C) * C``): at least one token runs real prefill so
        the admission has logits to sample its first token from.  Touches
        every matched node (LRU recency)."""
        self.lookups += 1
        self._tick += 1
        C = self.chunk_tokens
        max_chunks = (int(np.asarray(prompt).size) - 1) // C
        node = self._root
        out: list = []
        for i in range(max_chunks):
            child = node.children.get(_chunk_key(prompt, i, C))
            if child is None and self.l2_budget_bytes:
                child = self._promote_from_l2(prompt, i, node)
            if child is None:
                break
            child.last_used = self._tick
            out.append(child.kv)
            node = child
        return len(out) * C, out

    def _promote_from_l2(self, prompt: np.ndarray, idx: int, parent: _Node):
        """L2 hit: move a spilled chunk back under its (present) parent.
        Returns the re-attached node, or None on a miss or when the
        promotion was at once evicted again."""
        C = self.chunk_tokens
        cum = np.asarray(prompt[: (idx + 1) * C], np.int32).tobytes()
        entry = self._l2.pop(cum, None)
        if entry is None:
            return None
        k, v, nbytes = entry
        self.l2_bytes -= nbytes
        self.l2_hits += 1
        self._note_l2("hit")
        key = _chunk_key(prompt, idx, C)
        child = _Node(key, (k, v), nbytes, parent)
        child.last_used = self._tick
        parent.children[key] = child
        if parent is not self._root:
            self._leaves.discard(parent)
        self._leaves.add(child)
        self.bytes += nbytes
        while self.bytes > self.budget_bytes and self._evict_lru():
            pass
        return parent.children.get(key)

    # -- inserts / eviction --------------------------------------------------

    def has_chunk(self, prompt: np.ndarray, chunk_idx: int) -> bool:
        """Existence probe (no LRU touch): the engine skips the read of a
        chunk's K/V off the card for chunks already cached."""
        C = self.chunk_tokens
        node = self._root
        for i in range(chunk_idx + 1):
            node = node.children.get(_chunk_key(prompt, i, C))
            if node is None:
                return False
        return True

    def insert_chunk(self, prompt: np.ndarray, chunk_idx: int, k, v) -> bool:
        """Attach chunk ``chunk_idx`` of ``prompt`` with its K/V.

        The parent path (chunks ``0..chunk_idx-1``) must exist; otherwise
        the insert is dropped (False) rather than attached under a wrong
        cumulative key.  Returns True when the chunk is (now) cached."""
        self._tick += 1
        C = self.chunk_tokens
        node = self._root
        for i in range(chunk_idx):
            child = node.children.get(_chunk_key(prompt, i, C))
            if child is None:
                return False
            child.last_used = self._tick
            node = child
        key = _chunk_key(prompt, chunk_idx, C)
        existing = node.children.get(key)
        if existing is not None:
            existing.last_used = self._tick
            return True
        nbytes = _nbytes(k) + _nbytes(v)
        if nbytes > self.budget_bytes:
            return False  # one chunk bigger than the whole pool
        child = _Node(key, (k, v), nbytes, node)
        child.last_used = self._tick
        if self.l2_budget_bytes:
            # A fresh insert supersedes a spilled copy of the same chunk.
            stale = self._l2.pop(self._cum_key(child), None)
            if stale is not None:
                self.l2_bytes -= stale[2]
        node.children[key] = child
        if node is not self._root:
            self._leaves.discard(node)  # gained a child: interior now
        self._leaves.add(child)
        self.bytes += nbytes
        while self.bytes > self.budget_bytes and self._evict_lru():
            pass
        return key in node.children

    def _evict_lru(self) -> bool:
        """Drop the least-recently-used LEAF; equal recencies tie-break on
        the chunk key, so eviction is deterministic."""
        if not self._leaves:
            return False
        victim = min(self._leaves, key=lambda n: (n.last_used, n.key))
        parent = victim.parent
        assert parent is not None
        if self.l2_budget_bytes and victim.kv is not None:
            self._spill_to_l2(victim)
        del parent.children[victim.key]
        self._leaves.discard(victim)
        if not parent.children and parent is not self._root:
            self._leaves.add(parent)  # lost its last child: leaf again
        self.bytes -= victim.nbytes
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(victim.nbytes)
        return True

    def _spill_to_l2(self, victim: _Node) -> None:
        """Move an evicted leaf's K/V into the second tier, keyed by its
        cumulative token bytes, under the tier's LRU byte budget."""
        if victim.nbytes > self.l2_budget_bytes:
            return  # one chunk bigger than the whole second tier
        cum = self._cum_key(victim)
        old = self._l2.pop(cum, None)
        if old is not None:
            self.l2_bytes -= old[2]
        self._l2[cum] = (victim.kv[0], victim.kv[1], victim.nbytes)
        self.l2_bytes += victim.nbytes
        self.l2_spills += 1
        self._note_l2("spill")
        while self.l2_bytes > self.l2_budget_bytes:
            _key, (_k, _v, nb) = self._l2.popitem(last=False)
            self.l2_bytes -= nb
            self.l2_evictions += 1
            self._note_l2("evict")

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n
