"""Model-family registry: flavor name -> Predictor builder (port of the
JAX package's ``models/registry.py``, every flavor of it).

The loader resolves an artifact to a *flavor* and asks this registry for a
``Predictor``, the one interface the data plane serves:

- ``predict``   -- batched callable: numpy or tensor inputs in, tensors on
  the model's device out (launched, not waited for); for the ``pyfunc``
  tier a host callable with numpy out;
- ``jittable``  -- the reference's name for "a device function": False only
  for the ``pyfunc`` tier, which runs on the host by design;
- ``example_input`` -- builds a representative batch for warmup;
- ``seq_pad``   -- declarative sequence bucketing (``server/batching.
  apply_seq_pad``), only for models whose padding is exact;
- ``validate``  -- checks a request's inputs on the host before they are
  batched; a bad request fails alone with a 400 (an out-of-range index
  on the card is a device-side assert that would end the process);
- ``causal_lm`` -- handles for the continuous-batching generation engine;
- ``tree`` -- the served tree of the other tree-of-tensors flavors (BERT,
  ResNet), which the sharded snapshot bakes.

The sklearn, forest and xgboost builders take ``device`` (``cuda`` unless
named); the tree-of-tensors flavors run where their weights are.
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
    # False: a host callable (the pyfunc tier), not a device function.
    jittable: bool = True
    # {"params", "cfg"} of a BERT or ResNet predictor: the tree it serves
    # (a rank's block on a mesh) and its config.
    tree: dict | None = None


BUILDERS: dict[str, Callable[..., Predictor]] = {}


def register(flavor: str):
    def deco(fn: Callable[..., Predictor]):
        BUILDERS[flavor] = fn
        return fn

    return deco


def get_builder(flavor: str) -> Callable[..., Predictor]:
    try:
        return BUILDERS[flavor]
    except KeyError:
        raise KeyError(
            f"unknown model flavor {flavor!r}; registered: {sorted(BUILDERS)}"
        ) from None


def list_flavors() -> list[str]:
    return sorted(BUILDERS)


def _device(device) -> torch.device:
    from ..server.generation import resolve_device

    return resolve_device(device)


def _single_input(inputs: dict) -> np.ndarray:
    if len(inputs) != 1:
        raise ValueError(f"expected one input tensor, got {sorted(inputs)}")
    (x,) = inputs.values()
    return x


def _features(n_feat: int):
    """``validate`` for a ``[B, n_feat]`` feature matrix."""

    def validate(inputs):
        x = _single_input(inputs)
        if x.ndim != 2 or x.shape[1] != n_feat:
            raise ValueError(f"expected features of shape [B, {n_feat}], got {list(x.shape)}")

    return validate


def _as_f32(x, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Built-in flavors
# ---------------------------------------------------------------------------


@register("sklearn-linear")
def _build_sklearn_linear(model: Any, device=None, **_kw) -> Predictor:
    from . import linear

    dev = _device(device)
    params, cfg = linear.from_sklearn(model)
    params = {k: v.to(dev) for k, v in params.items()}
    n_feat = cfg.n_features

    def predict(x):
        return linear.predict(params, _as_f32(x, dev), cfg)

    return Predictor(
        name="sklearn-linear",
        predict=predict,
        example_input=lambda b: np.zeros((b, n_feat), np.float32),
        validate=_features(n_feat),
        metadata={"n_features": n_feat, "n_classes": cfg.n_classes},
    )


@register("sklearn-forest")
def _build_sklearn_forest(model: Any, device=None, **_kw) -> Predictor:
    from . import tabular

    dev = _device(device)
    trees = tabular.from_sklearn_forest(model)
    n_feat = int(model.n_features_in_)
    margins, form = tabular.lower_forest(trees, dev)

    def predict(x):
        return margins(_as_f32(x, dev))

    return Predictor(
        name="sklearn-forest",
        predict=predict,
        example_input=lambda b: np.zeros((b, n_feat), np.float32),
        validate=_features(n_feat),
        metadata={"n_trees": int(trees.feature.shape[0]), "eval_form": form},
    )


@register("xgboost")
def _build_xgboost(model: Any, device=None, **_kw) -> Predictor:
    """``model`` is a parsed xgboost JSON dict (or its text, or a live
    Booster).

    The forest is lowered to the product form when it fits the budget
    (``tabular.GemmForest``), else to the gather traversal shared with
    sklearn forests.  The objective picks the output transform: sigmoid for
    ``binary:*``, softmax over the class margins for ``multi:softprob``,
    their argmax as f32 class ids for ``multi:softmax``, the identity
    otherwise: xgboost's ``predict`` shapes."""
    from . import tabular

    dev = _device(device)
    if isinstance(model, (dict, str, bytes)):
        trees, objective = tabular.from_xgboost_json(model)
    else:
        trees, objective = tabular.from_xgboost(model)
    margins, form = tabular.lower_forest(trees, dev)

    if objective.startswith("binary:"):
        def transform(m):
            return torch.sigmoid(m)
    elif objective == "multi:softprob":
        def transform(m):
            return torch.softmax(m, dim=-1)
    elif objective == "multi:softmax":
        def transform(m):
            return torch.argmax(m, dim=-1).to(torch.float32)
    else:
        def transform(m):
            return m

    def predict(x):
        return transform(margins(_as_f32(x, dev)))

    n_feat = trees.n_features or int(trees.feature.max()) + 1
    return Predictor(
        name="xgboost",
        predict=predict,
        example_input=lambda b: np.zeros((b, n_feat), np.float32),
        validate=_features(n_feat),
        metadata={
            "n_trees": int(trees.feature.shape[0]),
            "n_features": n_feat,
            "objective": objective,
            "n_classes": trees.n_groups,
            "eval_form": form,
        },
    )


@register("pyfunc")
def _build_pyfunc(model: Any, **_kw) -> Predictor:
    from .tabular import PyFuncPredictor

    wrapped = model if isinstance(model, PyFuncPredictor) else PyFuncPredictor(
        model.predict if hasattr(model, "predict") else model
    )
    return Predictor(name="pyfunc", predict=wrapped, jittable=False)


@register("bert-classifier")
def _build_bert(
    params: Any,
    cfg: Any = None,
    seq_len: int = 128,
    seq_buckets: bool = True,
    dtype=torch.bfloat16,
    mesh=None,
    **_kw,
) -> Predictor:
    """``mesh``: ``params`` is this rank's block on it (``models/partition``)."""
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
            cfg=cfg, dtype=dtype, mesh=mesh,
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
        tree={"params": params, "cfg": cfg},
    )


@register("resnet-classifier")
def _build_resnet(params: Any, cfg: Any = None, image_size: int = 224, **_kw) -> Predictor:
    """Computes in the images' dtype (f32 from the V2 wire) from leaves
    kept at their stored dtype: the loader's serving-type cast never
    reaches this flavor."""
    from . import resnet

    cfg = cfg or resnet.ResNetConfig.resnet50()
    device = params["fc"]["w"].device
    prepared = resnet.prepare(params)  # the OIHW copy the convolutions read

    def predict(images):
        t = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.asarray(images))
        if not t.is_floating_point() or t.dtype == torch.float64:
            t = t.to(torch.float32)  # the reference's f32 (x64 off)
        return resnet.forward_prepared(prepared, t.to(device), cfg)

    def validate(inputs):
        x = _single_input(inputs)
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected images of shape [B, H, W, 3], got {list(x.shape)}")

    return Predictor(
        name="resnet-classifier",
        predict=predict,
        example_input=lambda b: np.zeros((b, image_size, image_size, 3), np.float32),
        validate=validate,
        metadata={"image_size": image_size, "num_classes": cfg.num_classes},
        tree={"params": params, "cfg": cfg},
    )


@register("llama-generate")
def _build_llama(
    params: Any,
    cfg: Any,
    max_new_tokens: int = 64,
    eos_id: int | None = None,
    dtype=torch.bfloat16,
    mesh=None,
    **_kw,
) -> Predictor:
    """``mesh``: ``params`` is this rank's block on it (``models/partition``)."""
    from . import llama

    example_len = min(16, cfg.max_seq // 4)
    max_new_tokens = min(max_new_tokens, cfg.max_seq - example_len)

    def predict(prompt_ids):
        return llama.generate_greedy(params, prompt_ids, max_new_tokens, cfg, dtype, mesh)

    return Predictor(
        name="llama-generate",
        predict=predict,
        metadata={"max_new_tokens": max_new_tokens, "max_seq": cfg.max_seq},
        causal_lm={"params": params, "cfg": cfg, "eos_id": eos_id},
    )
