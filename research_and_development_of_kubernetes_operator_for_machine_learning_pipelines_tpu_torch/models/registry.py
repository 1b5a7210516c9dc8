"""Model-family registry (port of the JAX package's ``models/registry.py``;
only the ``llama-generate`` flavor is ported)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass
class Predictor:
    name: str
    predict: Callable[..., Any]
    metadata: dict = field(default_factory=dict)
    # Causal-LM handles ({"params", "cfg", "eos_id"?}): the server builds a
    # continuous-batching GenerationEngine from these and serves /generate.
    causal_lm: dict | None = None


def _build_llama(
    params: Any,
    cfg: Any,
    max_new_tokens: int = 64,
    eos_id: int | None = None,
    dtype=torch.bfloat16,
    **_kw,
) -> Predictor:
    from . import llama

    example_len = min(16, cfg.max_seq // 4)
    max_new_tokens = min(max_new_tokens, cfg.max_seq - example_len)

    def predict(prompt_ids):
        return llama.generate_greedy(params, prompt_ids, max_new_tokens, cfg, dtype)

    return Predictor(
        name="llama-generate",
        predict=predict,
        metadata={"max_new_tokens": max_new_tokens, "max_seq": cfg.max_seq},
        causal_lm={"params": params, "cfg": cfg, "eos_id": eos_id},
    )
