"""Shared building blocks (port of the JAX package's ``models/common.py``;
only ``rms_norm`` is on the ported path)."""

from __future__ import annotations

import torch

from ..ops.rmsnorm import rmsnorm


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32, returned in x's type.

    A CUDA tensor goes through the RMSNorm kernel (``ops/rmsnorm.py``);
    a CPU tensor through its plain version, which is this function's
    reference arithmetic line for line."""
    return rmsnorm(x, scale, eps)
