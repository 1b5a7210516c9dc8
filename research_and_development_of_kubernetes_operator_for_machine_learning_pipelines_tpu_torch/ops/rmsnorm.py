"""RMSNorm: a CUDA kernel (``csrc/rmsnorm.cu``) and its plain version.

Replaces ``_rmsnorm_kernel`` of the JAX package's ``ops/rmsnorm.py``.
The function is ``x * rsqrt(mean(x^2) + eps) * scale`` over the last
axis, computed in f32 and returned in ``x.dtype`` — exactly
``models/common.rms_norm``, which the Llama forward calls 2L+1 times.

On the H100 it is bound by bytes: one read of the rows, one write, two
flops an element.  The kernel runs one block per row, reduces the sum of
squares in f32 with shuffles, and re-reads the row from cache for the
scaled write (see the source for the design note).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches since import (the plain version never counts).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def rmsnorm_reference(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rmsnorm").rmsnorm_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    h = x.shape[-1]
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale on {scale.device}, x on {x.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise ValueError(
            f"rmsnorm kernel takes float32/bfloat16, got x {x.dtype}, "
            f"scale {scale.dtype}"
        )
    if scale.shape != (h,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be contiguous [{h}], got {tuple(scale.shape)}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    rows = x.numel() // h if h else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    rc = _kernel()(
        _DTYPES[x.dtype], _DTYPES[scale.dtype], x.data_ptr(), scale.data_ptr(),
        out.data_ptr(), rows, h, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {rc}")
    launches += 1
    return out
