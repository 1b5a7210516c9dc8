"""Token sampling (temperature / top-k / top-p), batched.

Port of the JAX package's ``models/sampling.py``.  Per-row parameters are
tensors ``[B]`` so one call serves any mix of greedy and sampled rows:

- ``temperature <= 0`` -> greedy argmax (first index of the max);
- ``top_k <= 0``       -> k filtering disabled;
- ``top_p >= 1``       -> nucleus filtering disabled.

Filtering happens in sorted-logit space exactly as the reference does:
one stable sort per row in the reference's order (``argsort(-scaled)``),
a rank mask (top-k) AND an exclusive cumulative-probability mask (top-p,
the first token always kept), then a categorical draw over the surviving
logits by the Gumbel-max rule.

Randomness: every row carries a threefry key (``models/prng.py``, int64
words ``[B, 2]``, the reference's ``jax.random.key_data``) and draws
``argmax(masked + gumbel(key))`` as ``jax.random.categorical`` does, so a
seeded row draws the reference's stream.
"""

from __future__ import annotations

import torch

from ..ops.sample_step import filter_logits, pick, sample_step
from . import prng
from .prng import split_keys  # noqa: F401  (the reference's sampling.split_keys)


def sample_logits(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Draw one token per row.

    logits ``[B, V]`` (any float type); keys ``[B, 2]`` int64 threefry
    words; temperature/top_p float ``[B]``; top_k int ``[B]``.  Every row
    draws from its key; rows with temperature <= 0 take the greedy token.
    Returns int32 ``[B]``."""
    greedy_tok, order, masked = filter_logits(logits, temperature, top_k, top_p)
    choice = prng.categorical(keys, masked)
    return pick(order, choice, temperature, greedy_tok)


def sample_chain_step(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One sampling step of a decode chain: advance EVERY row's key and
    draw one token per row, the engine's single-step discipline
    (``split_keys`` then :func:`sample_logits`), and the per-step rule of
    the fused multi-step chain.  It is ``ops.sample_step``: on the card
    two kernels around the sort, on the CPU the plain chain.  Returns
    ``(carry_keys, tokens)``."""
    return sample_step(logits, keys, temperature, top_k, top_p)


def speculative_accept(
    tokens: torch.Tensor,
    greedy: torch.Tensor,
    draft_len: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy acceptance for self-speculative verify.

    ``tokens`` int ``[B, S]``: column 0 is the row's pending token, columns
    ``1..S-1`` its drafted continuation; ``greedy`` int ``[B, S]`` the
    verify forward's argmax at each position; ``draft_len`` int ``[B]``
    caps acceptance at each row's real draft count.  Returns ``(accepted,
    next_token)``: the longest draft prefix that agrees with greedy, and
    the greedy token after it.  int32."""
    b, s = tokens.shape
    if s == 1:
        return (torch.zeros((b,), dtype=torch.int32, device=tokens.device),
                greedy[:, 0].to(torch.int32))
    match = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)
    prefix = torch.cumprod(match, dim=-1)
    in_budget = (torch.arange(s - 1, device=tokens.device)[None, :]
                 < draft_len[:, None]).to(torch.int32)
    accepted = torch.sum(prefix * in_budget, dim=-1).to(torch.int32)
    nxt = torch.gather(greedy, 1, accepted[:, None].to(torch.int64))[:, 0]
    return accepted, nxt.to(torch.int32)
