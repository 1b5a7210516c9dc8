"""Carry the JAX package's parameter tree across to PyTorch tensors.

``from_jax_numpy`` takes the tree as numpy arrays (``jax.device_get`` of
a JAX tree, or ``np.load`` of a native ``params.npz``), nested dicts and
lists as in the reference, and returns the same tree of tensors:

- plain float leaves are cast to ``dtype`` (kept as stored when None);
- int8 leaves ``{"q8", "scale"}`` keep int8 values and f32 scales;
- a bfloat16 leaf arrives as ``ml_dtypes.bfloat16`` or, where numpy has
  no bfloat16 (no ``ml_dtypes``), as the raw two-byte void ``|V2`` that
  ``np.load`` returns; both are reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or (
        arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    )


def to_tensor(arr: np.ndarray, device=None, dtype=None, copy: bool = True) -> torch.Tensor:
    """One numpy leaf -> tensor; ``dtype`` applies to float leaves only.
    ``copy=False`` lets the tensor share a contiguous, writable ``arr``'s
    memory (a leaf the caller hands over, such as one ``np.load`` read)."""
    arr = np.ascontiguousarray(arr)
    if copy or not arr.flags.writeable:
        arr = arr.copy()
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def from_jax_numpy(tree: Any, device=None, dtype=None) -> Any:
    """Convert a JAX parameter tree of numpy leaves to tensors."""
    if isinstance(tree, dict):
        if "q8" in tree and "scale" in tree:
            return {
                "q8": to_tensor(tree["q8"], device),
                "scale": to_tensor(tree["scale"], device, torch.float32),
            }
        return {k: from_jax_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_numpy(v, device, dtype) for v in tree]
    return to_tensor(tree, device, dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy for writing a ``params.npz``; bfloat16 is written
    as its raw two-byte pattern (``|V2``), which :func:`to_tensor`
    reads back bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()
