"""RMSNorm: a CUDA kernel (``csrc/rmsnorm.cu``) and its plain version.

Replaces ``_rmsnorm_kernel`` of the JAX package's ``ops/rmsnorm.py``.
The function is ``x * rsqrt(mean(x^2) + eps) * scale`` over the last
axis, computed in f32 and returned in ``x.dtype`` — exactly
``models/common.rms_norm``, which the Llama forward calls 2L+1 times.

On the H100 it is bound by bytes: one read of the rows, one write, two
flops an element.  The kernel reads x once, with 16-byte loads where the
tensors are aligned, and holds the row in registers between the sum of
squares and the scaled write.  ``rmsnorm_plan`` picks how a row is cut:
256 threads a row at Llama's widths, whatever the row count; several short
rows a CTA; a thread block cluster, whose CTAs add their partial sums
through distributed shared memory, for a row longer than one CTA holds
(see the source's design note).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

# Kernel launches since import (the plain version never counts).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None

# The plan (``rmsnorm_plan``): ROW_THREADS threads a row (fewer for a
# short row, several short rows a CTA of up to CTA_THREADS), each holding
# its vectors in registers; a row of more than MAX_NV vectors a thread
# takes more threads, up to MAX_THREADS (the 16-byte instances, held to 128
# registers) or MAX_SCALAR_THREADS (the scalar ones), and past that a
# cluster of up to MAX_CLUSTER CTAs (the portable cluster size).  On the
# H100 a row of 256 threads beat one of 512 or 128 and a cluster of 8 CTAs
# of 64 (the smoke's plan sweep, PERF.md section 6).
ROW_THREADS = 256
CTA_THREADS = 256
MAX_NV = 4
MAX_THREADS = 512
MAX_SCALAR_THREADS = 1024
MAX_CLUSTER = 8


class Plan(NamedTuple):
    vec: int        # elements a load: 16 bytes of x, or 1 (the scalar instance)
    nv: int         # vectors a thread holds (1, 2, 4)
    cluster: int    # CTAs a row (1..8)
    per_cta: int    # vectors of a row a CTA holds
    tpr: int        # threads a row piece (a power of two)
    threads: int    # threads a CTA


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=512)
def rmsnorm_plan(rows: int, h: int, itemsize: int, aligned: bool) -> Plan:
    """How the kernel cuts ``rows`` rows of ``h`` elements of ``itemsize``
    bytes.  ``aligned``: x, out and the scale start on 16 bytes.  16-byte
    vectors where ``aligned`` and a row is a whole number of 16 bytes,
    else the scalar instance.  Cached, so a call costs a dictionary
    lookup.  ``ValueError`` for a row longer than the kernel holds."""
    vec = 16 // itemsize if aligned and (h * itemsize) % 16 == 0 else 1
    nvec = h // vec
    max_threads = MAX_THREADS if vec > 1 else MAX_SCALAR_THREADS
    cluster = -(-nvec // (max_threads * MAX_NV))
    if cluster > MAX_CLUSTER:
        raise ValueError(f"rmsnorm kernel takes at most "
                         f"{MAX_CLUSTER * max_threads * MAX_NV * vec} elements a row, got {h}")
    per_cta = -(-nvec // cluster)
    tpr = min(ROW_THREADS, _pow2_at_least(per_cta))
    if -(-per_cta // tpr) > MAX_NV:
        tpr = min(max_threads, _pow2_at_least(-(-per_cta // MAX_NV)))
    nv = _pow2_at_least(-(-per_cta // tpr))
    # Whole warps; rows of fewer than CTA_THREADS threads share a CTA.
    rows_per_cta = max(1, min(CTA_THREADS // tpr, rows))
    threads = -(-tpr * rows_per_cta // 32) * 32
    return Plan(vec, nv, cluster, per_cta, tpr, threads)


@functools.lru_cache(maxsize=512)
def _plan_words(plan: Plan):
    """The plan as the C call's int[6], built once a plan."""
    return (ctypes.c_int * len(plan))(*plan)


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
        i32 = ctypes.c_int
        fn.argtypes = [i32, i32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       i32, i32, ctypes.POINTER(i32), ctypes.c_float, ctypes.c_void_p]
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
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    plan = rmsnorm_plan(rows, h, x.element_size(), (xp | sp | op) % 16 == 0)
    rc = _kernel()(
        _DTYPES[x.dtype], _DTYPES[scale.dtype], xp, sp, op, rows, h, _plan_words(plan),
        float(eps), _build.current_stream(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {rc}")
    launches += 1
    return out
