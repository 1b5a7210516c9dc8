"""Model-family registry (port of the JAX package's ``models/registry.py``;
the ``llama-generate`` and ``bert-classifier`` flavors are ported).

A ``Predictor`` is the one interface the data plane serves:

- ``predict``   -- batched callable: numpy or tensor inputs in, tensors on
  the model's device out (launched, not waited for);
- ``example_input`` -- builds a representative batch for warmup;
- ``seq_pad``   -- declarative sequence bucketing (``server/batching.
  apply_seq_pad``), only for models whose padding is exact;
- ``validate``  -- checks a request's inputs on the host before they are
  batched; a bad request fails alone with a 400 (an out-of-range index
  on the card is a device-side assert that would end the process);
- ``causal_lm`` -- handles for the continuous-batching generation engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch


@dataclass
class Predictor:
    name: str
    predict: Callable[..., Any]
    example_input: Callable[[int], Any] | None = None  # batch_size -> inputs
    metadata: dict = field(default_factory=dict)
    # Causal-LM handles ({"params", "cfg", "eos_id"?}): the server builds a
    # continuous-batching GenerationEngine from these and serves /generate.
    causal_lm: dict | None = None
    # Declarative sequence bucketing (server/batching.apply_seq_pad).
    seq_pad: dict | None = None
    # Host-side input check, run per request before batching.
    validate: Callable[[dict], None] | None = None


def _build_bert(
    params: Any,
    cfg: Any = None,
    seq_len: int = 128,
    seq_buckets: bool = True,
    dtype=torch.bfloat16,
    **_kw,
) -> Predictor:
    from . import bert

    cfg = cfg or bert.BertConfig.base()
    device = params["embeddings"]["word"].device
    # None computes in the type the weights are stored in.
    dtype = dtype if dtype is not None else params["embeddings"]["word"].dtype

    def as_ids(x):
        if x is None:
            return None
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(device=device, dtype=torch.int64)

    def predict(input_ids, attention_mask=None, token_type_ids=None):
        return bert.classify(
            params, as_ids(input_ids), as_ids(attention_mask), as_ids(token_type_ids),
            cfg=cfg, dtype=dtype,
        )

    def validate(inputs):
        for name, limit in (("input_ids", cfg.vocab_size),
                            ("token_type_ids", cfg.type_vocab_size)):
            x = inputs.get(name)
            if x is not None and x.size and (x.min() < 0 or x.max() >= limit):
                raise ValueError(f"{name} must lie in [0, {limit})")
        if "input_ids" not in inputs:
            raise ValueError('missing input tensor "input_ids"')

    def example(b):
        return {
            "input_ids": np.ones((b, seq_len), np.int32),
            "attention_mask": np.ones((b, seq_len), np.int32),
        }

    return Predictor(
        name="bert-classifier",
        predict=predict,
        example_input=example,
        validate=validate,
        metadata={
            "seq_len": seq_len,
            "num_labels": cfg.num_labels,
            "hidden_act": cfg.hidden_act,
        },
        # Padding is exact for classification: the attention mask (0 on
        # padded keys) removes them from every softmax, and the CLS
        # position is unaffected.  A request without a mask gets one
        # synthesized BEFORE padding, or the padded ids would be attended.
        # seq_buckets=False pins the model to fixed-length traffic.
        seq_pad=None
        if not seq_buckets
        else {
            "axis": 1,
            "pad_values": {
                "input_ids": 0,
                "attention_mask": 0,
                "token_type_ids": 0,
            },
            "synthesize": {"attention_mask": 1},
            "min_bucket": 16,
            "max_len": cfg.max_position_embeddings,
        },
    )


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


BUILDERS: dict[str, Callable[..., Predictor]] = {
    "bert-classifier": _build_bert,
    "llama-generate": _build_llama,
}
