"""Weight-only int8 quantization (symmetric, per-output-channel).

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
    q8 = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale}


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
