"""The sampled chain's key split, Gumbel noise and argmax: a CUDA kernel
(``csrc/sampling.cu``) and its plain version.

Not a Pallas port: the JAX package samples in XLA.  ``gumbel_argmax``
takes the filtered logits of a sampling step ``masked [B, V]`` (f32) and
each row's threefry key ``keys [B, 2]`` (int64 words) and returns
``(carry [B, 2], choice [B])`` (int64): the key half a row carries to its
next step, and ``argmax(masked + gumbel(use))`` with the other half, the
lowest index among equal maxima.  That is ``models/prng.split_keys``
and ``models/prng.categorical``, the plain version here,
which issues some 300 elementwise launches over [B, V] int64 tensors for
what the kernel does in one pass (a split pass and a merge).

The kernel's uniform is bit-equal to the plain version's and its Gumbel
within an ulp or two (the device's ``logf`` against the CPU's ``log``),
so a choice can differ from the plain one only where two scores lie
within a few ulp of each other.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import prng
from . import _build

# Kernel launches since import (the plain version never counts).
launches = 0

THREADS = 256        # csrc/sampling.cu's block
_TARGET_BLOCKS = 528  # 4 blocks on each of the H100's 132 SMs
_fn = None


def gumbel_plan(b: int, v: int) -> tuple[int, int]:
    """(chunk, splits) of a row: ``splits`` blocks a row of ``chunk``
    counters each (the last one ragged): about _TARGET_BLOCKS blocks in
    all at small ``b``, and never a chunk narrower than one block."""
    splits = max(1, min(v // THREADS, -(-_TARGET_BLOCKS // b)))
    chunk = -(-v // splits)
    return chunk, -(-v // chunk)


def gumbel_argmax_reference(masked: torch.Tensor, keys: torch.Tensor):
    """``prng.split_keys`` and ``prng.categorical``: the plain chain."""
    carry, use = prng.split_keys(keys)
    return carry, prng.categorical(use, masked)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("sampling").gumbel_argmax_launch
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [ptr, i64, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gumbel_argmax(masked: torch.Tensor, keys: torch.Tensor):
    """``(carry [B, 2], choice [B])`` of ``masked [B, V]`` f32 under the
    row keys ``keys [B, 2]`` int64.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    global launches
    if masked.device.type == "cpu":
        return gumbel_argmax_reference(masked, keys)
    if masked.device.type != "cuda":
        raise ValueError(f"gumbel_argmax: unsupported device {masked.device}")
    if masked.dtype != torch.float32 or masked.dim() != 2 or masked.stride(-1) != 1:
        raise ValueError(
            f"gumbel_argmax takes f32 [B, V] logits with unit-stride rows, got "
            f"{masked.dtype} {tuple(masked.shape)} strides {masked.stride()}")
    b, v = masked.shape
    if b < 1 or not (1 <= v < 2**31):
        raise ValueError(f"gumbel_argmax: B >= 1 and 1 <= V < 2**31, got [{b}, {v}]")
    if keys.device != masked.device or keys.dtype != torch.int64 or tuple(keys.shape) != (b, 2):
        raise ValueError(
            f"gumbel_argmax: keys must be int64 [{b}, 2] on {masked.device}, got "
            f"{keys.dtype} {tuple(keys.shape)} on {keys.device}")
    keys = keys.contiguous()  # a split's carry half is a strided view
    chunk, splits = gumbel_plan(b, v)
    dev = masked.device
    carry = torch.empty((b, 2), dtype=torch.int64, device=dev)
    choice = torch.empty((b,), dtype=torch.int64, device=dev)
    part_v = torch.empty((b * splits,), dtype=torch.float32, device=dev)
    part_i = torch.empty((b * splits,), dtype=torch.int32, device=dev)
    rc = _kernel()(
        masked.data_ptr(), masked.stride(0), keys.data_ptr(), b, v, chunk, splits,
        part_v.data_ptr(), part_i.data_ptr(), carry.data_ptr(), choice.data_ptr(),
        _build.current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"gumbel_argmax kernel launch failed: cudaError {rc}")
    launches += 1
    return carry, choice
