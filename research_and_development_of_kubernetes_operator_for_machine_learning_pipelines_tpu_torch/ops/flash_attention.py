"""Flash attention: a CUDA kernel (``csrc/flash_attention.cu``) and its
plain version.

Replaces ``_flash_kernel`` of the JAX package's ``ops/flash_attention.py``
(line 62, its ``pallas_call`` at line 136): blockwise online-softmax attention over
``[B, H, S, D]`` queries and ``[B, NKV, T, D]`` keys/values, f32 or bf16
in, q's type out.  Scores are ``(q . k) * scale`` in f32; the ``kv_len``
mask (keys at or past ``kv_len``) and the causal mask (key > q_offset +
query) replace a score with -1e30, and masked keys still take part in the
softmax: with ``kv_len <= 0`` every score is -1e30 and a row comes out as
the mean of V over the T keys, as the JAX package's ``attention_reference``
gives.  Any S and T; the kernel masks its ragged tiles itself (their
padding takes no part).

Two additions let Llama's ``_block`` (prefill and chunked prefill) run
through it; both compute what ``models/llama.py`` computes:

- **a query offset** ``q_offset``: query row i sits at key position
  ``q_offset + i``, so a prompt chunk written at cache offset
  ``q_offset`` attends the cached prefix and itself under the causal
  mask (a nonzero offset needs ``q_offset + S <= T``, else a
  ``ValueError``);
- **grouped K/V heads**: k and v have ``NKV`` heads with ``H % NKV ==
  0``; query head h reads K/V head ``h // (H // NKV)`` through the
  strides, nothing repeated on the host.

Two more let BERT's ``_self_attention`` run through it unchanged;
both compute what ``models/bert.py`` computes:

- **strided q/k/v**: any batch, head and position strides with a dense
  last axis, so the ``[B, S, NH, HD]`` projection outputs go in as their
  ``.transpose(1, 2)`` views, without a copy.  The output is returned as
  a ``[B, H, S, D]`` view of a ``[B, S, H, D]`` buffer, so such a caller
  takes it back with ``.transpose(1, 2)``, again without a copy;
- **an additive f32 key bias** ``[B, T]`` (BERT's ``mask_bias``), added
  to the scaled scores BEFORE the replacement masks.  A row whose bias
  masks every key therefore averages V uniformly, as BERT's reference
  does.

On the H100 (see the source for the design note): bf16, the serving
type, runs on the tensor cores (``mma.sync`` m16n8k16, ``cp.async``
double-buffered K/V tiles), bound by its bytes at BERT's shapes and by
its operations at S = 1024, D = 128.  It rounds the probabilities to
bf16 before the product with V (relative 2^-9 each, against the running
max, the row sum over the rounded values), which the plain version does
not: both stay within the bf16 tolerance of each other.  f32 keeps the
CUDA-core kernel.  The bf16 kernel copies Q, K and V tiles with 16-byte
``cp.async`` (the f32 one K and V with 16-byte loads), so the wrapper
asks q, k and v for 16-byte aligned bases and strides; it raises
otherwise and never reroutes.

**The log-sum-exp output** (``return_lse=True``, ring attention's blocks,
``ops/ring_attention.py``): the dense kernel also writes each row's
``m + log(l)`` of its scaled scores as f32 ``[B, H, S]``, ``-inf`` for a
row with no visible key (``kv_len <= 0``); the plain version takes the
log-sum-exp of the same scores.  Without it the kernel runs as before.

**The ragged instance** (:func:`flash_attention_ragged`, packed
multi-admission prefill, ``models/llama.py`` ``prefill_chunks_ragged``):
the attention lines of the JAX package's ``_block_verify_deferred``
(``models/llama.py:1039-1169``, which reaches no Pallas kernel there) at
the prefill chunk, on cache rows picked by ``slots``:

  q          [B_p, C, H, D]    the packed chunks' queries, bf16
  k/v_cache  [NS, NKV, T, D]   one layer of the head-major ragged cache:
                               int8 with f32 scales [NS, NKV, T, 1], or
                               q's type with none
  slots      [B_p] int32       the cache row of each packed row
  offsets    [B_p] int32       its tokens already in that row
  k/v_chunk  [B_p, C, NKV, D]  the chunk's exact K/V, q's type
  chunk8     int8 cache only: the chunk through the cache's quantize
             round-trip, (k8c, ksc, v8c, vsc) [B_p, C, NKV, D] int8 and
             [B_p, C, NKV, 1] f32
  out        [B_p, C, H, D]    q's type (the plain version: f32, f64 for
                               f64 inputs)

Query ``j`` of row ``b`` attends the window keys ``0 .. offsets[b] - 1``
of cache row ``slots[b]`` (scales folded into the score and the
probability on the int8 cache) and the chunk keys ``i <= j`` in one
softmax; on the int8 cache the chunk keys below the diagonal are read
through the round-trip codes and the diagonal is exact, as on the
sequential path, where the earlier chunk positions were in the cache
before they were attended.  A row whose offset is at capacity (a parked
pad row of a packed call) reads no window; its output is finite and
ignored.  ``offsets`` and ``slots`` stay on the card (no host sync).

On the H100 the ragged instance runs the tensor-core core of
``csrc/chunk_attention.cuh`` (the verify chunk's too) with p rounded to
bf16: :func:`ragged_plan` fixes, from C and T alone, query tiles of
``RAGGED_ROWS`` rows and window pieces of ``RAGGED_PIECE`` keys; a
block whose piece lies past its row's window exits, a row of one piece is
written by its block, and a merge kernel launched by the same call joins
the f32 partials of a row whose window spans several pieces.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build
from .decode_attention import _verify_chain

NEG_INF = -1e30

# Kernel launches since import (the plain version never counts): the
# dense kernel's, the share of them that wrote the log-sum-exp, and the
# ragged instance's.
launches = 0
lse_launches = 0
ragged_launches = 0

_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_RAGGED_HEAD_DIMS = (64, 128)
_rfn = None
# The ragged kernel's plan (``ragged_plan``): query rows a block (the
# kernel's 4 warps of 16), keys a staged tile, and keys a window piece (a
# multiple of the tile), as the sweep of ``chip_smoke.py`` picked it on
# the H100.
RAGGED_ROWS = 64
RAGGED_TILE = 64
RAGGED_PIECE = 1024


class RaggedPlan(NamedTuple):
    """How the ragged kernel covers a call: ``rows`` query rows a block
    in ``query_tiles`` tiles a (row, head), and ``pieces`` window pieces
    of ``piece_len`` keys a row (the grid's second axis)."""

    rows: int
    query_tiles: int
    pieces: int
    piece_len: int


def ragged_plan(c: int, t: int, piece_len: int | None = None) -> RaggedPlan:
    """The ragged kernel's grid from the chunk length ``c`` and the cache
    capacity ``t`` alone (no offset is read on the host): pieces of
    ``piece_len`` keys (``RAGGED_PIECE``; rounded up to whole tiles, and
    never longer than the longest window, ``t - 1`` keys) enough to cover
    that window."""
    piece = RAGGED_PIECE if piece_len is None else piece_len
    longest = max(t - 1, 1)
    piece = RAGGED_TILE * -(-min(piece, longest) // RAGGED_TILE)
    return RaggedPlan(RAGGED_ROWS, -(-c // RAGGED_ROWS), -(-longest // piece), piece)


def ragged_window(slot: int, offset: int, n_slots: int, t: int) -> int:
    """The window keys a packed row reads: its offset, or none for a
    parked row (offset at or past capacity), an empty one or a slot out of
    range (what the kernel reads on the device)."""
    return offset if 0 <= slot < n_slots and 0 < offset < t else 0


def ragged_pieces(win: int, plan: RaggedPlan) -> list[tuple[int, int, bool]]:
    """The window keys ``[lo, hi)`` of each piece a row with a ``win``-key
    window runs, and whether it attends the chunk (the last does; a row
    with no window runs one piece, the chunk alone).  The grid's other
    pieces exit at once."""
    n = max(1, -(-win // plan.piece_len))
    return [(i * plan.piece_len, min(win, (i + 1) * plan.piece_len), i == n - 1)
            for i in range(n)]


def _scores_f32(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q . k`` over the last axis with an f32 result, q grouped ``[B,
    NKV, G, S, D]`` against k ``[B, NKV, T, D]``: f64 operands contract in
    f64 and round, narrower ones contract in f32."""
    if q.dtype == torch.float64:
        return torch.einsum("bngqd,bnkd->bngqk", q, k).to(torch.float32)
    return torch.einsum("bngqd,bnkd->bngqk", q.to(torch.float32), k.to(torch.float32))


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    kv_len: int | None = None,
    scale: float | None = None,
    bias: torch.Tensor | None = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Plain PyTorch version with the kernel's contract: the
    ``attention_reference`` chain plus the key bias, the query offset and
    grouped K/V heads, with the softmax in f32 and the probabilities kept
    in f32 (f64 for f64 inputs) for the product with V, as the kernel
    keeps them.  Returned in the kernel's layout.  ``return_lse``: also
    each row's log-sum-exp ``[B, H, S]`` over its visible keys' scaled
    scores (the f32 scores, or f64 ones for f64 inputs), ``-inf`` for a
    row with none."""
    b, h, s_q, d = q.shape
    nkv, t = k.shape[1], k.shape[2]
    _check_offset_and_groups(q, k, q_offset)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qg = q.unflatten(1, (nkv, h // nkv))  # [B, NKV, G, S, D], a view
    s = _scores_f32(qg, k) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)[:, None, None, None, :]
    valid = torch.ones((s_q, t), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        valid = valid & (torch.arange(t, device=q.device) < kv_len)[None, :]
    if causal:
        qi = q_offset + torch.arange(s_q, device=q.device)[:, None]
        valid = valid & (torch.arange(t, device=q.device)[None, :] <= qi)
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    # The kernel's layout: a [B, H, S, D] view of a [B, S, H, D] buffer.
    out = torch.einsum("bngqk,bnkd->bqngd", p.to(wide), v.to(wide))
    out = out.reshape(b, s_q, h, d).contiguous().to(q.dtype).transpose(1, 2)
    if not return_lse:
        return out
    if q.dtype == torch.float64:
        sw = torch.einsum("bngqd,bnkd->bngqk", qg, k) * scale
        if bias is not None:
            sw = sw + bias.to(torch.float64)[:, None, None, None, :]
    else:
        sw = s
    sw = torch.where(valid, sw, torch.tensor(-math.inf, dtype=sw.dtype, device=q.device))
    return out, torch.logsumexp(sw, dim=-1).reshape(b, h, s_q)


def _check_offset_and_groups(q: torch.Tensor, k: torch.Tensor, q_offset: int) -> None:
    """The contract both versions hold: k's heads divide q's, and an offset
    chunk's positions ``q_offset .. q_offset + S - 1`` lie in the T keys
    (at offset 0 any S and T, as ``attention_reference`` takes them)."""
    h, s_q = q.shape[1], q.shape[2]
    nkv, t = k.shape[1], k.shape[2]
    if nkv <= 0 or h % nkv:
        raise ValueError(f"flash attention: {h} query heads do not group over {nkv} K/V heads")
    if q_offset < 0 or (q_offset > 0 and q_offset + s_q > t):
        raise ValueError(
            f"flash attention: queries at positions {q_offset}..{q_offset + s_q - 1} "
            f"lie outside the {t} keys"
        )


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_launch
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [
            i32, i32, i32,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll,
            vp, ll, ll, ll, vp,
            i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, vp,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, causal, kv_len, scale, bias, q_offset, return_lse=False):
    global launches, lse_launches
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)) + ((("bias", bias),) if bias is not None else ()):
        if t.device != q.device:
            raise ValueError(f"flash attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash attention kernel takes float32 or bfloat16 q/k/v of one "
            f"type, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4:
        raise ValueError(f"flash attention: q must be [B, H, S, D], got {tuple(q.shape)}")
    b, h, s_q, d = q.shape
    nkv, t = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes D in {_HEAD_DIMS}, got {d}")
    if k.shape != (b, nkv, t, d) or v.shape != (b, nkv, t, d):
        raise ValueError(
            f"flash attention: shapes disagree: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if s_q == 0 or t == 0:
        raise ValueError(f"flash attention: empty sequence (S={s_q}, T={t})")
    _check_offset_and_groups(q, k, q_offset)
    if b * h > 2**31 - 1 or (s_q + 63) // 64 > 65535:
        raise ValueError(f"flash attention: grid too large for B*H={b * h}, S={s_q}")
    if bias is not None and (
        bias.dtype != torch.float32 or bias.shape != (b, t) or bias.stride(1) != 1
    ):
        raise ValueError(
            f"flash attention: bias must be float32 [B, T] = [{b}, {t}] with a "
            f"dense last axis, got {bias.dtype} {tuple(bias.shape)}"
        )
    size = q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        st = x.stride()
        if st[3] != 1:
            raise ValueError(f"flash attention: {name} needs a dense last axis, "
                             f"got strides {st}")
        # Q, K and V tiles are staged with 16-byte loads.
        if (x.data_ptr() | (st[0] * size) | (st[1] * size) | (st[2] * size)) % 16:
            raise ValueError(
                f"flash attention: {name} needs 16-byte aligned base and "
                f"strides, got strides {st} at {x.data_ptr():#x}"
            )
    kv = t if kv_len is None else int(kv_len)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = _kernel()(
        _DTYPES[q.dtype], d, int(bool(causal)),
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        bias.data_ptr() if bias is not None else None,
        bias.stride(0) if bias is not None else 0,
        out.data_ptr(), out.stride(0), out.stride(1), out.stride(2),
        lse.data_ptr() if lse is not None else None,
        b, h, s_q, t, kv, int(q_offset), h // nkv, float(scale),
        _build.current_stream(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {rc}")
    launches += 1
    if lse is None:
        return out
    lse_launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    kv_len: int | None = None,
    scale: float | None = None,
    bias: torch.Tensor | None = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Attention over ``[B, H, S, D]`` x ``[B, NKV, T, D]`` -> ``[B, H, S,
    D]``, query row i at key position ``q_offset + i``.  ``return_lse``
    returns ``(out, lse)`` with each row's f32 log-sum-exp ``[B, H, S]``
    (``-inf`` where no key is visible), which ring attention merges by.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises (unsupported type, D, device, alignment, offset,
    grouping, build or launch), never falling back."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, kv_len, scale, bias, int(q_offset),
                                         return_lse)
    return _launch(q, k, v, causal, kv_len, scale, bias, int(q_offset), return_lse)


# ---------------------------------------------------------------------------
# The ragged instance: packed multi-admission prefill
# ---------------------------------------------------------------------------


def flash_attention_ragged_reference(q, k_cache, v_cache, slots, offsets, k_chunk, v_chunk,
                                     k_scale=None, v_scale=None, chunk8=None):
    """Plain PyTorch version of :func:`flash_attention_ragged`: the
    window rows gathered by ``slots`` under the strict mask ``key <
    offsets[b]`` (no key for a parked row), then the verify chain of
    ``ops.decode_attention`` over the chunk (the JAX ``_block_verify_deferred``
    lines), scores and softmax in f32.  Returns ``[B_p, C, H, D]`` in f32
    (f64 for f64 inputs)."""
    b, c, h, d = q.shape
    nkv, t = k_cache.shape[1], k_cache.shape[2]
    g = h // nkv
    rows = slots.to(torch.int64)
    win = torch.where((offsets > 0) & (offsets < t), offsets, 0)
    key = torch.arange(t, device=q.device)
    mask = torch.where(key[None, :] < win[:, None], 0.0, -1e9).to(torch.float32)[:, None, :]
    # Query row r = j * G + g of each (row, kv head), as the verify chain takes it.
    qr = q.reshape(b, c, nkv, g, d).transpose(1, 2).reshape(b, nkv, c * g, d)
    rt = None if chunk8 is None else tuple(x.transpose(1, 2) for x in chunk8)
    out = _verify_chain(
        qr, k_cache[rows], v_cache[rows], k_chunk.transpose(1, 2), v_chunk.transpose(1, 2),
        mask, None if k_scale is None else k_scale[rows],
        None if v_scale is None else v_scale[rows], rt,
    )
    return out.reshape(b, nkv, c, g, d).transpose(1, 2).reshape(b, c, h, d)


def _ragged_kernel():
    global _rfn
    if _rfn is None:
        fn = _build.load("flash_attention").flash_ragged_launch
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32] + [vp] * 15 + [i32] * 8 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _rfn = fn
    return _rfn


def _launch_ragged(q, k_cache, v_cache, slots, offsets, k_chunk, v_chunk, k_scale, v_scale,
                   chunk8):
    global ragged_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ragged flash attention: unsupported device {dev}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"ragged flash attention: q {tuple(q.shape)} must be [B, C, H, D] "
                         f"and the cache {tuple(k_cache.shape)} [NS, NKV, T, D]")
    b, c, h, d = q.shape
    n_slots, nkv, t = k_cache.shape[:3]
    if d not in _RAGGED_HEAD_DIMS:
        raise ValueError(f"ragged flash attention kernel takes D in {_RAGGED_HEAD_DIMS}, "
                         f"got {d}")
    if nkv <= 0 or h % nkv:
        raise ValueError(f"ragged flash attention: {h} query heads do not group over {nkv} "
                         "K/V heads")
    quant = k_cache.dtype == torch.int8
    bf = torch.bfloat16
    cache_type = torch.int8 if quant else bf
    want = {
        "q": (q, bf, (b, c, h, d)),
        "k_cache": (k_cache, cache_type, (n_slots, nkv, t, d)),
        "v_cache": (v_cache, cache_type, (n_slots, nkv, t, d)),
        "k_chunk": (k_chunk, bf, (b, c, nkv, d)),
        "v_chunk": (v_chunk, bf, (b, c, nkv, d)),
        "slots": (slots, torch.int32, (b,)),
        "offsets": (offsets, torch.int32, (b,)),
    }
    if quant:
        if k_scale is None or v_scale is None or chunk8 is None:
            raise ValueError("ragged flash attention: an int8 cache needs its scales and the "
                             "chunk's round-trip codes")
        k8c, ksc, v8c, vsc = chunk8
        want.update({
            "k_scale": (k_scale, torch.float32, (n_slots, nkv, t, 1)),
            "v_scale": (v_scale, torch.float32, (n_slots, nkv, t, 1)),
            "k8c": (k8c, torch.int8, (b, c, nkv, d)),
            "ksc": (ksc, torch.float32, (b, c, nkv, 1)),
            "v8c": (v8c, torch.int8, (b, c, nkv, d)),
            "vsc": (vsc, torch.float32, (b, c, nkv, 1)),
        })
    elif k_scale is not None or v_scale is not None or chunk8 is not None:
        raise ValueError("ragged flash attention: scales and round-trip codes go with an "
                         "int8 cache only")
    for name, (x, dtype, shape) in want.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"ragged flash attention: {name} must be {dtype} {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"ragged flash attention: {name} must be contiguous, got "
                             f"strides {x.stride()}")
        # Rows are read with 16-byte loads; scales and indices one element at a time.
        if x.data_ptr() % (16 if x.dim() == 4 and x.shape[-1] == d else 4):
            raise ValueError(f"ragged flash attention: {name} is misaligned at "
                             f"{x.data_ptr():#x}")
    if c == 0 or t == 0 or n_slots == 0:
        raise ValueError(f"ragged flash attention: empty input (C={c}, T={t}, NS={n_slots})")
    plan = ragged_plan(c, t)
    if b * h * plan.query_tiles > 2**31 - 1 or plan.pieces > 65535:
        raise ValueError(f"ragged flash attention: grid too large for B*H={b * h}, C={c}, "
                         f"T={t}")
    out = torch.empty((b, c, h, d), dtype=bf, device=dev)
    # The pieces' partials (acc [D], then m and l a row) of rows whose
    # window spans several pieces; none when no window can.
    part = (torch.empty(b * h * plan.pieces * c * (d + 2), dtype=torch.float32, device=dev)
            if plan.pieces > 1 else None)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = _ragged_kernel()(
        int(quant), d, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        ptr(k_scale), ptr(v_scale), slots.data_ptr(), offsets.data_ptr(),
        k_chunk.data_ptr(), v_chunk.data_ptr(),
        *((ptr(x) for x in chunk8) if quant else (None,) * 4),
        out.data_ptr(), ptr(part), b, h, nkv, c, t, n_slots, plan.pieces, plan.piece_len,
        1.0 / math.sqrt(d), _build.current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"ragged flash attention kernel launch failed: cudaError {rc}")
    ragged_launches += 1
    return out


def flash_attention_ragged(q, k_cache, v_cache, slots, offsets, k_chunk, v_chunk,
                           k_scale=None, v_scale=None, chunk8=None):
    """Packed-prefill attention: each packed row's chunk against the window
    of its cache row and its own causal keys, one softmax (layouts in the
    module docstring).  A CPU tensor takes the plain version; a CUDA
    tensor launches the ragged kernel or raises (type, shape, D, grouping,
    contiguity, alignment, build or launch), never falling back."""
    if q.device.type == "cpu":
        return flash_attention_ragged_reference(q, k_cache, v_cache, slots, offsets, k_chunk,
                                                v_chunk, k_scale, v_scale, chunk8)
    return _launch_ragged(q, k_cache, v_cache, slots, offsets, k_chunk, v_chunk, k_scale,
                          v_scale, chunk8)
