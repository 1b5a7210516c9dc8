"""Self-speculative n-gram decoding: the host-side drafter and its adaptive
control (port of the JAX package's ``server/speculative.py``, numpy on the
host as there).

A drafter proposes up to k continuation tokens a slot, ONE batched verify
forward scores all k+1 positions (``models.llama.verify_ragged``), and the
longest draft prefix that agrees with the greedy argmax is accepted
(``models.sampling.speculative_accept``): the output is the plain greedy
path's, token for token, while one forward's weights serve several tokens.

The drafter is "prompt lookup": a slot's own history (prompt + generated
tokens) is searched for an earlier occurrence of its current suffix, and
the tokens that followed it become the draft.  On text with no repeats it
proposes nothing and the engine runs the plain single-token step.

:class:`DraftState` is the per-slot adaptive controller: consecutive
zero-accept verifies halve the slot's draft budget (down to 0, plain
decode), an acceptance regrows it, and a parked slot re-probes after a
cooldown.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SpeculativeConfig:
    """Engine-side knobs (``--speculative*`` / ``spec.tpu.speculative``)."""

    enabled: bool = False
    draft_tokens: int = 4  # max draft length k (verify scores k+1 positions)
    ngram_min: int = 1  # shortest history suffix the drafter may match
    ngram_max: int = 4  # longest history suffix tried first
    adaptive: bool = True  # per-slot halve-on-zero-accept / regrow-on-success


def draft_chain(draft_tokens: int) -> tuple[int, ...]:
    """The draft lengths a verify tick is padded to: the halving chain
    ``{k, k//2, ..., 1}``, ascending (the reference compiles one program
    per length; the port keeps the same padding, so a tick verifies the
    same S as the reference's)."""
    if draft_tokens < 1:
        raise ValueError(f"draft_tokens must be >= 1, got {draft_tokens}")
    chain = set()
    k = int(draft_tokens)
    while k >= 1:
        chain.add(k)
        k //= 2
    return tuple(sorted(chain))


def pad_to_chain(want: int, chain: tuple[int, ...]) -> int:
    """Smallest chain length >= ``want``."""
    for c in chain:
        if c >= want:
            return c
    return chain[-1]


# Trailing-history bound for the n-gram scan (tokens): constant host work a
# tick whatever the context length; matches past it are not found.
_SCAN_WINDOW = 2048


def propose_ngram(
    context: np.ndarray,
    max_tokens: int,
    ngram_min: int,
    ngram_max: int,
) -> list[int]:
    """Prompt-lookup draft: longest-suffix match against the sequence's
    own history.

    Tries suffix lengths ``ngram_max`` down to ``ngram_min``; on the first
    (longest) suffix with an earlier occurrence, drafts ``max_tokens``
    tokens under the copy hypothesis ``context[j] == context[j - d]``,
    ``d`` the distance to the MOST RECENT earlier occurrence, so a short
    period tiles its cycle over the whole budget.  Returns ``[]`` when
    nothing matches."""
    arr = np.asarray(context, dtype=np.int64).reshape(-1)
    if arr.size > _SCAN_WINDOW:
        arr = arr[-_SCAN_WINDOW:]
    L = int(arr.size)
    if max_tokens < 1 or L < ngram_min + 1:
        return []
    history = arr[:-1]  # candidate windows must END strictly before L-1
    for n in range(min(int(ngram_max), L - 1), int(ngram_min) - 1, -1):
        suffix = arr[L - n:]
        windows = np.lib.stride_tricks.sliding_window_view(history, n)
        hits = np.nonzero((windows == suffix).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n  # token AFTER the most recent match
            d = L - start
            idx = start + (np.arange(int(max_tokens)) % d)
            return arr[idx].astype(np.int64).tolist()
    return []


class DraftState:
    """Per-slot adaptive draft budget.

    - ``budget()``: tokens the slot may draft this tick (0 = parked: the
      slot rides the plain single-token step).
    - ``HALVE_AFTER`` CONSECUTIVE zero-accept verifies halve the budget
      (4 -> 2 -> 1 -> 0).
    - An acceptance resets the streak and doubles the budget back toward
      the maximum.
    - A parked slot re-probes at budget 1 after ``REPROBE_AFTER`` plain
      ticks.

    With ``adaptive=False`` the budget is pinned to the maximum."""

    HALVE_AFTER = 2
    REPROBE_AFTER = 16

    def __init__(self, max_draft: int, adaptive: bool = True) -> None:
        self.max = int(max_draft)
        self.adaptive = bool(adaptive)
        self.length = self.max
        self.zero_streak = 0
        self.parked_ticks = 0

    def budget(self) -> int:
        if not self.adaptive:
            return self.max
        if self.length == 0:
            self.parked_ticks += 1
            if self.parked_ticks >= self.REPROBE_AFTER:
                self.parked_ticks = 0
                return 1  # probation draft; observe() decides its fate
            return 0
        return self.length

    def observe(self, proposed: int, accepted: int) -> None:
        """Feed back one verify outcome (no-op when nothing was drafted)."""
        if not self.adaptive or proposed <= 0:
            return
        if accepted > 0:
            self.zero_streak = 0
            self.length = min(self.max, max(1, self.length * 2))
            return
        self.zero_streak += 1
        if self.zero_streak >= self.HALVE_AFTER:
            self.zero_streak = 0
            self.length //= 2  # 1 -> 0 parks the slot
