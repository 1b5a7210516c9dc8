"""D-major int8 decode attention: a CUDA kernel (``csrc/dmajor_attention.cu``),
its plain version, and the head-major einsum chain it is compared with.

Replaces ``_kernel_dmajor`` of the JAX layout probe
``scripts/proto_dmajor_attention.py``: one layer's single-token attention
with no self term, over an int8 KV window stored TRANSPOSED, D-major:

  q         [B, NKV, D, 1]  f32 or bf16 (cast to f32 inside)
  k8t, v8t  [B, NKV, D, W]  int8
  ks, vs    [B, NKV, 1, W]  f32 per-position scales
  mask      [B, 1, W]       f32 additive, 0 / -1e9
  out       [B, NKV, D, 1]  f32

Scores are a reduction over D of ``(q * scale) * k``, times ``ks``, plus
the mask; the softmax runs along W; the context is a reduction over W of
``v * (p * vs)``, divided by the sum of ``p``.  A row masked everywhere
comes out as the uniform average over W of ``vs * v``, as the reference
computes it (every score is -1e9 in f32).

The D-major copies must be real transposes: ``jnp.swapaxes`` materialises
one, but ``torch.transpose`` is a view of head-major memory.  Build them
with ``.transpose(2, 3).contiguous()``; the kernel demands a dense W axis
and raises on a view.

``NKV, D, W, LAYERS`` are the probe's geometry (the JAX bench's 1.35B
model: 16 KV heads of 128, a 512-position window, 24 layers); the
functions take any B, NKV and W up to ``MAX_W``, and D in (16, 32, 64,
128).

On the H100 the kernel is bound by bytes (2 * D * W int8 bytes a (slot,
head), ~2 flops a byte).  It splits the window over ``dmajor_splits(B,
NKV, W)`` blocks a (slot, head), copies each split's K and V tiles into
shared memory with 16-byte ``cp.async`` where the views are 16-byte
aligned (``load_width``; 4-byte copies otherwise), and merges the splits
of a (slot, head) with a second kernel from the same C call (see the
source's design note).  One call counts one launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
# Bytes a copy moves of a D-major row: 16 when the bases and the batch, head
# and row strides of both windows are 16-byte aligned (a dense window whose
# W is a multiple of 16), else 4 -- the head-major kernel's rule, on the
# same three strides.
from .decode_attention import load_width

NKV, D, W = 16, 128, 512
LAYERS = 24  # one attention call per layer of a decode step

# Kernel launches since import (the plain version never counts).
launches = 0

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# How the window is split (``dmajor_splits``): the H100's SMs, the blocks
# a wave holds on each (one: in the smoke's split sweep, PERF.md section 6,
# one block an SM beat two, four and eight, whose smaller blocks pay the
# merge), the fewest positions worth a block, the widest window that stays
# whole, the most splits a (slot, head) takes, and the most positions whose
# scores a block keeps in shared memory (the kernel's kMaxChunk).  A split
# is a multiple of SPLIT_ALIGN positions, so that every tile's copy starts
# 16-byte aligned.
NUM_SMS = 132
BLOCKS_PER_SM = 1
MIN_SPLIT = 64
WHOLE_WINDOW = 192
MAX_SPLITS = 8
MAX_CHUNK = 6144
SPLIT_ALIGN = 16
MAX_W = MAX_SPLITS * MAX_CHUNK
_fn = None


def attn_dmajor_reference(q, k8t, ks, v8t, vs, mask):
    """Plain PyTorch version with the kernel's contract, in f32 as the
    formula is written (the Pallas kernel's order of operations)."""
    d = q.shape[2]
    qf = q.to(torch.float32) * (1.0 / d ** 0.5)                         # [B,NKV,D,1]
    s = torch.sum(k8t.to(torch.float32) * qf, dim=2, keepdim=True)      # [B,NKV,1,W]
    s = s * ks + mask[:, None]
    m = torch.amax(s, dim=3, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=3, keepdim=True)
    ctx = torch.sum(v8t.to(torch.float32) * (p * vs), dim=3, keepdim=True)  # [B,NKV,D,1]
    return ctx / denom


def attn_xla(q, k8, ks, v8, vs, mask):
    """The probe's head-major einsum chain (``attn_xla``): q [B,NKV,1,D];
    k8, v8 [B,NKV,W,D] int8; ks, vs [B,NKV,W,1]; mask [B,1,W] -> out
    [B,NKV,1,D] f32, the same function as :func:`attn_dmajor` on the
    transposed copies."""
    d = q.shape[-1]
    qf = q.to(torch.float32) / (d ** 0.5)
    s = torch.einsum("bngd,bnwd->bngw", qf, k8.to(torch.float32))
    s = s * ks[..., 0][:, :, None, :] + mask[:, :, None, :]
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    ctx = torch.einsum("bngw,bnwd->bngd", p * vs[..., 0][:, :, None, :], v8.to(torch.float32))
    return ctx / denom


def dmajor_splits(b: int, nkv: int, w: int) -> int:
    """Blocks per (slot, kv head) over a window of ``w`` positions, as
    ``ops.decode_attention.num_splits`` picks them: as many as fit one wave
    of ``BLOCKS_PER_SM`` blocks on each SM where the window has
    ``MIN_SPLIT`` positions a block for them, 1 up to ``WHOLE_WINDOW``,
    never more than ``MAX_SPLITS``, and enough
    that no split holds more than ``MAX_CHUNK`` scores."""
    if w <= WHOLE_WINDOW:
        s = 1
    else:
        wave = NUM_SMS * BLOCKS_PER_SM // (b * nkv)
        s = max(1, min(wave, w // MIN_SPLIT, MAX_SPLITS))
    return max(s, -(-w // MAX_CHUNK))


def split_len(w: int, splits: int) -> int:
    """Positions each split owns: ``ceil(w / splits)`` rounded up to
    ``SPLIT_ALIGN``; the last split may own fewer, or none."""
    c = -(-w // splits)
    return -(-c // SPLIT_ALIGN) * SPLIT_ALIGN


def check_inputs(q, k8t, ks, v8t, vs, mask) -> tuple[int, int, int, int]:
    """``(B, NKV, D, W)`` of inputs the kernel takes; ``ValueError`` for
    anything else (the device type is the caller's check)."""
    for name, t in (("k8t", k8t), ("ks", ks), ("v8t", v8t), ("vs", vs), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"dmajor attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dmajor attention: q must be float32 or bfloat16, got {q.dtype}")
    if k8t.dtype != torch.int8 or v8t.dtype != torch.int8:
        raise ValueError(f"dmajor attention: k8t/v8t must be int8, got {k8t.dtype}/{v8t.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError("dmajor attention: ks, vs and mask must be float32")
    if q.dim() != 4 or q.shape[3] != 1:
        raise ValueError(f"dmajor attention: q must be [B, NKV, D, 1], got {tuple(q.shape)}")
    b, nkv, d, _ = q.shape
    w = k8t.shape[-1]
    if (k8t.shape != (b, nkv, d, w) or v8t.shape != (b, nkv, d, w)
            or ks.shape != (b, nkv, 1, w) or vs.shape != (b, nkv, 1, w)
            or mask.shape != (b, 1, w)):
        raise ValueError(
            "dmajor attention: shapes disagree: q "
            f"{tuple(q.shape)}, k8t {tuple(k8t.shape)}, ks {tuple(ks.shape)}, "
            f"v8t {tuple(v8t.shape)}, vs {tuple(vs.shape)}, mask {tuple(mask.shape)}"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"dmajor attention kernel takes D in {_HEAD_DIMS}, got {d}")
    if not 1 <= w <= MAX_W:
        raise ValueError(f"dmajor attention kernel takes 1 <= W <= {MAX_W}, got {w}")
    if b * nkv * dmajor_splits(b, nkv, w) > 2**31 - 1:
        raise ValueError(f"dmajor attention: grid too large for B*NKV={b * nkv}")
    for name, t in (("k8t", k8t), ("v8t", v8t)):
        # int8 copies of 4 bytes at least along W: W dense, the base and every
        # other stride 4-aligned.
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 4:
            raise ValueError(
                f"dmajor attention: {name} needs a dense W axis and 4-byte aligned "
                f"strides, got strides {t.stride()} (a transposed view? build the "
                f"D-major copy with .transpose(2, 3).contiguous())"
            )
    for name, t in (("ks", ks), ("vs", vs), ("mask", mask)):
        if t.stride(-1) != 1:
            raise ValueError(f"dmajor attention: {name} needs a dense W axis, "
                             f"got strides {t.stride()}")
    return b, nkv, d, w


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("dmajor_attention").dmajor_attention_launch
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [
            i32, i32, vp,
            vp, ll, ll, ll,
            vp, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll,
            vp, ll,
            vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_float, vp,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k8t, ks, v8t, vs, mask):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"dmajor attention: unsupported device {q.device}")
    b, nkv, d, w = check_inputs(q, k8t, ks, v8t, vs, mask)
    q = q.contiguous()  # [B, NKV, D, 1]: a few KB, never the window
    out = torch.empty((b, nkv, d, 1), dtype=torch.float32, device=q.device)
    splits = dmajor_splits(b, nkv, w)
    # The splits' partials (m, l, ctx[D]) for the merge kernel; none for one.
    part = (torch.empty(b * nkv * splits * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    rc = _kernel()(
        _DTYPES[q.dtype], load_width(k8t, v8t), q.data_ptr(),
        k8t.data_ptr(), k8t.stride(0), k8t.stride(1), k8t.stride(2),
        ks.data_ptr(), ks.stride(0), ks.stride(1),
        v8t.data_ptr(), v8t.stride(0), v8t.stride(1), v8t.stride(2),
        vs.data_ptr(), vs.stride(0), vs.stride(1),
        mask.data_ptr(), mask.stride(0),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        b, nkv, d, w, splits, split_len(w, splits), 1.0 / math.sqrt(d),
        _build.current_stream(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"dmajor attention kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def attn_dmajor(q, k8t, ks, v8t, vs, mask):
    """D-major int8 decode attention, split over the window.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises, never falling back."""
    if q.device.type == "cpu":
        return attn_dmajor_reference(q, k8t, ks, v8t, vs, mask)
    return _launch(q, k8t, ks, v8t, vs, mask)


def headmajor_self_row_inputs(q, k8, ks, v8, vs, lengths):
    """Inputs of the head-major decode kernel (``ops.decode_attention``)
    that give the same function as no-self-term attention over
    ``lengths`` positions (every length >= 1): the mask stops at L - 1 and
    the self term is the dequantized row L - 1 (``k8 * ks`` in f32, and
    ``v8 * vs``).  q [B,NKV,1,D] head-major; returns ``(q, k8, ks, v8, vs,
    k_self, v_self, mask)`` for ``decode_attention``."""
    lengths = torch.as_tensor(lengths, device=k8.device)
    if bool((lengths < 1).any()):
        raise ValueError("the self-row identity needs every length >= 1")
    b, nkv, w, d = k8.shape
    last = (lengths - 1).view(b, 1, 1, 1).expand(b, nkv, 1, 1)
    k_self = (torch.gather(k8, 2, last.expand(b, nkv, 1, d)).to(torch.float32)
              * torch.gather(ks, 2, last))
    v_self = (torch.gather(v8, 2, last.expand(b, nkv, 1, d)).to(torch.float32)
              * torch.gather(vs, 2, last))
    mask = length_mask(lengths - 1, w)
    return q, k8, ks, v8, vs, k_self.to(q.dtype), v_self.to(q.dtype), mask


def length_mask(lengths, w: int) -> torch.Tensor:
    """[B, 1, W] f32: 0 for positions below each length, -1e9 past it."""
    lengths = torch.as_tensor(lengths)
    pos = torch.arange(w, device=lengths.device)
    valid = pos[None, :] < lengths[:, None]
    return torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, :]
