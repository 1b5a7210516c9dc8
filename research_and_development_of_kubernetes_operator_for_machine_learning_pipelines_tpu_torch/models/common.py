"""Shared building blocks (port of the JAX package's ``models/common.py``).

Every product the reference runs with ``preferred_element_type=float32``
returns f32 here too (:func:`matmul_f32`), and the norms run in f32 and
cast back, so the CPU tests can hold the models to the JAX ones in f64.
"""

from __future__ import annotations

from typing import Any, Iterator

import torch
import torch.nn.functional as F

from ..ops.rmsnorm import rmsnorm


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a parameter tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def count_params(params: Any) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., in] @ w [in, out]`` with an f32 result.  A bf16 product
    on the card keeps cuBLAS's f32 accumulator as its output
    (``out_dtype``) instead of rounding it to bf16 first; an f64 product
    (the CPU tests) is rounded to f32, as XLA does."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.matmul(x, w).to(torch.float32)
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w (+ b)`` accumulated in f32 whatever x's type, returned in
    x's type (the reference's ``dense``)."""
    y = matmul_f32(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               device=None) -> dict[str, torch.Tensor]:
    """Uniform in +-1/sqrt(d_in) and a zero bias (the reference's
    ``init_dense``; torch's generator draws other numbers from a seed)."""
    bound = 1.0 / d_in**0.5
    w = torch.rand((d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    w = (w * (2 * bound) - bound).to(dtype)
    return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm in f32 with the population variance, cast back to x's
    type (an f64 input is normalized in f32 too, as the reference does)."""
    xf = x.to(torch.float32)
    y = F.layer_norm(xf, (x.shape[-1],), scale.to(torch.float32),
                     bias.to(torch.float32), eps)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32, returned in x's type.

    A CUDA tensor goes through the RMSNorm kernel (``ops/rmsnorm.py``);
    a CPU tensor through its plain version, which is this function's
    reference arithmetic line for line."""
    return rmsnorm(x, scale, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def take_embedding(table: torch.Tensor, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    out = F.embedding(ids, table)
    return out.to(dtype) if dtype is not None else out
