"""Fused int8-KV decode attention: a CUDA kernel and its plain version.

Replaces the JAX package's Pallas kernels in ``ops/decode_attention.py``:
``_decode_attn_kernel_mxu`` (behind ``decode_attention`` and
``decode_attention_batched``) and ``_decode_attn_kernel_vpu`` (behind
``decode_attention_vpu``, G == 1).  On Hopper all three wrappers launch
ONE kernel, ``csrc/decode_attention.cu``, templated on G: the TPU's
split between an MXU and a VPU formulation and its slot blocking have no
counterpart on the card, and the kernel takes every window width (the
VPU kernel's ``W % 128 == 0`` rule is gone).

Layouts (B slots, W window, NKV kv heads, G = heads / kv head, D head dim):

  q       [B, NKV, G, D]   current token's queries, grouped by kv head
  k8, v8  [B, NKV, W, D]   int8 cache window — a strided view of the
                           head-major cache [L, B, NKV, T, D] is taken
                           as is (the kernel reads through its strides)
  ks, vs  [B, NKV, W, 1]   f32 per-(position, head) scales
  k_self  [B, NKV, 1, D]   current token's exact K/V
  v_self  [B, NKV, 1, D]
  mask    [B, 1, W]        f32 additive bias, STRICT: position w < length
  out     [B, NKV, G, D]   f32

Bound on the H100: bytes — the 2 * W * D int8 bytes of each (slot, head)
window dominate, at < 16 flops a byte.  The kernel reads each window row
once, 4 bytes a lane, in place through the view's strides (no
``.contiguous()`` copy of the cache per layer), and keeps the scores in
registers (see the source for the design note).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# Kernel launches since import, all three wrappers together (one kernel).
launches = 0

_GROUPS = (1, 2, 4, 8)
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def decode_attention_reference(q, k8, ks, v8, vs, k_self, v_self, mask):
    """Plain PyTorch version with the identical contract (f32 everywhere)."""
    d = q.shape[-1]
    qf = q.to(torch.float32) / (d ** 0.5)
    s = torch.einsum("bngd,bnwd->bngw", qf, k8.to(torch.float32))
    s = s * ks[..., 0].to(torch.float32)[:, :, None, :] + mask[:, :, None, :]
    s_self = torch.einsum("bngd,bnsd->bngs", qf, k_self.to(torch.float32))
    m = torch.maximum(torch.amax(s, dim=-1, keepdim=True), s_self)
    p = torch.exp(s - m)
    p_self = torch.exp(s_self - m)
    denom = torch.sum(p, dim=-1, keepdim=True) + p_self
    ctx = torch.einsum(
        "bngw,bnwd->bngd", p * vs[..., 0].to(torch.float32)[:, :, None, :],
        v8.to(torch.float32),
    )
    ctx = ctx + p_self * v_self.to(torch.float32)
    return ctx / denom


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [
            i32, i32, vp,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, vp, vp, ll,
            vp, i32, i32, i32, i32, ctypes.c_float, vp,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k8, ks, v8, vs, k_self, v_self, mask):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q.device}")
    b, nkv, g, d = q.shape
    w = k8.shape[2]
    for name, t in (("k8", k8), ("ks", ks), ("v8", v8), ("vs", vs),
                    ("k_self", k_self), ("v_self", v_self), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"decode attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k_self.dtype != q.dtype or v_self.dtype != q.dtype:
        raise ValueError(
            f"decode attention: q/k_self/v_self must share float32 or "
            f"bfloat16, got {q.dtype}/{k_self.dtype}/{v_self.dtype}"
        )
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise ValueError(f"decode attention: k8/v8 must be int8, got {k8.dtype}/{v8.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError("decode attention: ks, vs and mask must be float32")
    if g not in _GROUPS:
        raise ValueError(f"decode attention kernel takes G in {_GROUPS}, got {g}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes D in {_HEAD_DIMS}, got {d}")
    if (k8.shape != (b, nkv, w, d) or v8.shape != (b, nkv, w, d)
            or ks.shape != (b, nkv, w, 1) or vs.shape != (b, nkv, w, 1)
            or k_self.shape != (b, nkv, 1, d) or v_self.shape != (b, nkv, 1, d)
            or mask.shape != (b, 1, w)):
        raise ValueError(
            "decode attention: shapes disagree: q "
            f"{tuple(q.shape)}, k8 {tuple(k8.shape)}, ks {tuple(ks.shape)}, "
            f"v8 {tuple(v8.shape)}, vs {tuple(vs.shape)}, k_self "
            f"{tuple(k_self.shape)}, v_self {tuple(v_self.shape)}, mask "
            f"{tuple(mask.shape)}"
        )
    for name, t in (("k8", k8), ("v8", v8)):
        # 4-byte int8 loads: dense D, every stride and the base 4-aligned.
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 4:
            raise ValueError(
                f"decode attention: {name} needs a dense last axis and "
                f"4-byte aligned strides, got strides {t.stride()}"
            )
    if mask.stride(2) != 1:
        raise ValueError("decode attention: mask needs a dense last axis")
    q = q.contiguous()          # [B, NKV, G, D]: a few KB, never the cache
    k_self = k_self.contiguous()
    v_self = v_self.contiguous()
    out = torch.empty((b, nkv, g, d), dtype=torch.float32, device=q.device)
    rc = _kernel()(
        _DTYPES[q.dtype], g, q.data_ptr(),
        k8.data_ptr(), k8.stride(0), k8.stride(1), k8.stride(2),
        ks.data_ptr(), ks.stride(0), ks.stride(1), ks.stride(2),
        v8.data_ptr(), v8.stride(0), v8.stride(1), v8.stride(2),
        vs.data_ptr(), vs.stride(0), vs.stride(1), vs.stride(2),
        k_self.data_ptr(), v_self.data_ptr(), mask.data_ptr(), mask.stride(0),
        out.data_ptr(), b, nkv, w, d, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def decode_attention(q, k8, ks, v8, vs, k_self, v_self, mask):
    """Fused int8-KV decode attention, one block per (slot, kv head).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k8, ks, v8, vs, k_self, v_self, mask)
    return _launch(q, k8, ks, v8, vs, k_self, v_self, mask)


def decode_attention_batched(q, k8, ks, v8, vs, k_self, v_self, mask):
    """Same launch as :func:`decode_attention`: the TPU kernel's slot
    blocking shrank a sequential grid, which the card does not have."""
    return decode_attention(q, k8, ks, v8, vs, k_self, v_self, mask)


def decode_attention_vpu(q, k8, ks, v8, vs, k_self, v_self, mask):
    """The G == 1 instantiation of the kernel (the TPU's VPU form); any
    window width."""
    g = q.shape[2]
    if g != 1:
        raise ValueError(f"decode_attention_vpu requires G == 1, got {g}")
    return decode_attention(q, k8, ks, v8, vs, k_self, v_self, mask)
