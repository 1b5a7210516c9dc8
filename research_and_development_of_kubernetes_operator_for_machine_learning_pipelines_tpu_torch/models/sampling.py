"""Token sampling (temperature / top-k / top-p), batched.

Port of the JAX package's ``models/sampling.py``.  Per-row parameters are
tensors ``[B]`` so one call serves any mix of greedy and sampled rows:

- ``temperature <= 0`` -> greedy argmax (first index of the max);
- ``top_k <= 0``       -> k filtering disabled;
- ``top_p >= 1``       -> nucleus filtering disabled.

Filtering happens in sorted-logit space exactly as the reference does:
one stable descending sort per row, a rank mask (top-k) AND an exclusive
cumulative-probability mask (top-p, the first token always kept), then a
categorical draw over the surviving logits by the Gumbel-max rule.

Randomness: the reference threads a JAX PRNG key per row (``split_keys``);
here each sampled row carries its own ``torch.Generator`` seeded from the
request seed, so a row is reproducible for its seed and independent of
its neighbours.  The streams differ from JAX's threefry bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

_NEG_INF = -1e30


def sample_logits(
    logits: torch.Tensor,
    generators: Sequence[torch.Generator | None],
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Draw one token per row.

    logits ``[B, V]`` (any float type); ``generators`` one per row: a row
    with a generator draws once from it (its token is used only where its
    temperature is > 0), a row with None takes the greedy token;
    temperature/top_p float ``[B]``; top_k int ``[B]``.  Returns int32
    ``[B]``."""
    b, v = logits.shape
    logits = logits.to(torch.float32)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    rows = [i for i in range(b) if generators[i] is not None]
    if not rows:
        return greedy_tok

    temp = torch.clamp(temperature.to(torch.float32), min=1e-6)[:, None]
    scaled = logits / temp
    sorted_logits, order = torch.sort(scaled, dim=-1, descending=True, stable=True)

    ranks = torch.arange(v, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k)[:, None]
    keep_k = ranks < k

    probs = torch.softmax(sorted_logits, dim=-1)
    # Exclusive cumsum: keep tokens while the mass BEFORE them is < p.
    cum_before = torch.cumsum(probs, dim=-1) - probs
    p = torch.clamp(top_p.to(torch.float32), 0.0, 1.0)[:, None]
    keep_p = cum_before < p
    masked = torch.where(keep_k & keep_p, sorted_logits,
                         torch.full_like(sorted_logits, _NEG_INF))

    # Gumbel-max draw for the sampled rows only, each from its own stream.
    tiny = torch.finfo(torch.float32).tiny
    gumbel = torch.zeros_like(masked)
    for i in rows:
        u = torch.rand(v, generator=generators[i], device=logits.device,
                       dtype=torch.float32)
        gumbel[i] = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    choice = torch.argmax(masked + gumbel, dim=-1)
    sampled_tok = torch.gather(order, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled_tok, greedy_tok)
