"""Int8 quantization: symmetric, per-output-channel weights, and BERT's
dynamic per-row activations (``dense_q8``).

Port of the JAX package's ``models/quantization.py``.  A quantized leaf
is a dict ``{"q8": int8, "scale": float32}`` with the scale kept at the
weight's rank, so the layouts match the reference tree for tree.  The
rounding is bit-identical to the reference: ``scale = max(amax,
1e-12) / 127``, then ``round(w / scale)`` with ties to even, then a clip
to +-127, all in f32.
"""

from __future__ import annotations

from typing import Any

import torch


def quantize_tensor(w: torch.Tensor, axis: int = -2) -> dict[str, torch.Tensor]:
    """Symmetric int8 with |max| reduced over ``axis`` (kept at rank).

    ``axis=-2`` is per output channel for ``[..., in, out]`` weights; the
    KV cache uses ``axis=-1`` (per position and head over head_dim)."""
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return {"q8": quantize_with_scale(w32, scale), "scale": scale}


def channel_scale(w: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """:func:`quantize_tensor`'s ``scale`` of ``w``, reduced one slice of
    the leading axis at a time (``axis`` not the leading one), so a stacked
    ``[L, in, out]`` leaf needs one layer's f32 copy in flight."""
    if w.ndim > 2 and axis % w.ndim != 0:
        dim = axis if axis < 0 else axis - 1  # the axis within one slice
        amax = torch.stack([torch.amax(torch.abs(p.to(torch.float32)), dim=dim, keepdim=True)
                            for p in w])
    else:
        amax = torch.amax(torch.abs(w.to(torch.float32)), dim=axis, keepdim=True)
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_with_scale(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """:func:`quantize_tensor`'s ``q8`` of ``w`` under a given ``scale``
    (a block of a leaf under its cut of the whole leaf's scale)."""
    return torch.clamp(torch.round(w.to(torch.float32) / scale), -127, 127).to(torch.int8)


def dequantize_tensor(q: dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    # Multiply in f32 and round once into the target type.
    return (q["q8"].to(torch.float32) * q["scale"]).to(dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q8" in leaf and "scale" in leaf


# Llama matmul weights worth quantizing: everything the decode step streams
# in full.  Norm vectors and the embedding gather stay as they are.
_LLAMA_LAYER_MATS = ("q", "k", "v", "o", "gate", "up", "down")


def quantize_llama(params: dict) -> dict:
    """A params tree with the layer matmuls and lm_head as int8 leaves.

    Quantizes one leaf at a time on the leaf's own device, so a 7B tree
    needs one f32 copy of its largest matrix in flight, not of the tree."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in _LLAMA_LAYER_MATS:
        out["layers"][name] = quantize_tensor(params["layers"][name])
    out["lm_head"] = quantize_tensor(params["lm_head"])
    return out


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8`` -> int32, exact.

    On the card this is cuBLASLt's int8 GEMM (``torch._int_mm``), which
    takes only M > 16: smaller row counts are padded with zero rows and
    sliced back.  On the CPU the int32 product is exact as well."""
    m = a.shape[0]
    if a.device.type == "cuda" and m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, a.shape[1]))])
        return torch._int_mm(a, b)[:m]
    return torch._int_mm(a, b)


def dense_q8(x: torch.Tensor, qw: dict, b: torch.Tensor | None = None,
             group=None) -> torch.Tensor:
    """Dynamic-activation int8 matmul: ``x [..., in] @ q8 [in, out]``.

    Activations quantize per row (per token) with :func:`quantize_tensor`
    over the contraction axis, multiply the int8 weight into an exact
    int32 product, and rescale by ``a_scale * w_scale`` in f32 (the
    reference's ``dense_q8``).  The reference runs this under jit, where
    ``/ 127`` becomes ``* (1/127)``; this port divides, as the formula is
    written (ROADMAP C), so an activation code can sit one step away.

    ``group`` (a tp process group): ``x`` and ``q8`` are this rank's
    blocks of a matrix split on its INPUT axis.  Each row's absmax is the
    max over the group (the whole row's, as XLA's reduction over the
    sharded axis), the exact int32 partial products are summed over the
    group, then rescaled: equal, bit for bit, to the one-rank product."""
    from ..parallel.collectives import pmax, psum

    x32 = x.to(torch.float32)
    amax = pmax(torch.amax(torch.abs(x32), dim=-1, keepdim=True), group)
    a_scale = torch.clamp(amax, min=1e-12) / 127.0
    x8 = quantize_with_scale(x32, a_scale)
    k = x8.shape[-1]
    y = _int_mm(x8.reshape(-1, k), qw["q8"]).reshape(*x8.shape[:-1], -1)
    y = psum(y, group)
    y32 = y.to(torch.float32) * a_scale * qw["scale"].reshape(-1)
    if b is not None:
        y32 = y32 + b.to(torch.float32)
    return y32.to(x.dtype)


# BERT dense layers worth int8-ing: the six big matmuls of each encoder
# layer.  The pooler, classifier and embeddings stay as they are.
_BERT_LAYER_MATS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
                    ("mlp", "up"), ("mlp", "down"))


def quantize_bert(params: dict) -> dict:
    """A params tree with each encoder layer's six dense weights as int8
    leaves: the dense dicts keep their ``b`` and hold ``{"q8", "scale"}``
    in place of ``w``, which ``models/bert.py`` routes through
    :func:`dense_q8`."""
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        new_layer = {k: dict(v) for k, v in layer.items()}
        for group, name in _BERT_LAYER_MATS:
            d = dict(new_layer[group][name])
            d["w"] = quantize_tensor(d["w"])
            new_layer[group][name] = d
        layers.append(new_layer)
    out["layers"] = layers
    return out
