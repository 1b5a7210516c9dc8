"""Fused decode attention: a CUDA kernel and its plain versions.

Replaces the JAX package's Pallas kernels in ``ops/decode_attention.py``:
``_decode_attn_kernel_mxu`` (line 52, behind ``decode_attention`` and
``decode_attention_batched``) and ``_decode_attn_kernel_vpu`` (line 173,
behind ``decode_attention_vpu``, G == 1).  On Hopper all three wrappers
launch ONE kernel, ``csrc/decode_attention.cu``, templated on G: the TPU's
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

The dense (bf16 or f32) cache runs the same kernel instanced on its
element type, through :func:`decode_attention_dense`: k and v ``[B, NKV,
W, D]`` of q's type, no scales.  Its plain version is the XLA chain of the
JAX package's ``models/llama.py:611-637`` (which reaches no Pallas
kernel), with the probabilities kept in f32 as the kernel keeps them.

Bound on the H100: bytes — the 2 * W * D int8 bytes (2 * W * D * 2 in
bf16) of each (slot, head) window dominate, at < 16 flops a byte.  The kernel is a flash-decoding
kernel (see the source for the design note): the window is split over
``num_splits(B, NKV, W)`` blocks per (slot, head), each reads its rows
once in place through the view's strides (no ``.contiguous()`` copy of
the cache per layer) with 16-byte loads where the view is 16-byte
aligned (4-byte ones otherwise), computes its scores, then its softmax
and P . V, and a merge kernel launched by the same call joins the
splits and the self term.  One call counts one launch.

Self-speculative verify (``models/llama.py`` ``_block_verify_deferred``,
the attention of the JAX package's ``models/llama.py:1083-1152``, which
reaches no Pallas kernel there) runs a chunk instance of the same kernel
through :func:`verify_attention` (int8 window) and
:func:`verify_attention_dense`: each slot scores S chunk positions, so
the single query row of each (slot, kv head, group) widens to S causal
rows ``r = s * G + g``:

  q        [B, NKV, S*G, D]  the chunk's queries, row r = s * G + g
  k_chunk  [B, NKV, S, D]    the chunk's fresh K/V, q's type
  v_chunk
  k8c, v8c [B, NKV, S, D]    int8 window only: the chunk through the
  ksc, vsc [B, NKV, S, 1]    cache's quantize round-trip (``_quant_kv``)
  mask     [B, 1, W]         the strict window mask, shared by the S rows
  out      [B, NKV, S*G, D]  f32

Row ``r`` attends the window ``[0, W)`` under the mask and the chunk keys
``j <= s`` in one softmax.  The diagonal ``j == s`` is exact; on the int8
window every earlier chunk key and value goes through the round-trip
(``k8c * ksc``, ``v8c * vsc``), as it would have through the cache on the
sequential path.  At S = 1 it is the decode kernel's function.  S takes
any width from 1: a draft chain, or a super-step's prefill chunk (512 or
1024 as the shipped CRs serve), each kernel streaming the chunk's keys in
tiles.

An optional ``counts`` (int32 ``[B]``) gives each slot's live chunk
positions, for the unified super-step (``models/llama.py``
``super_step_ragged``), whose rows share one static chunk width but commit
1 (decode), draft + 1 (verify) or the prefill chunk's positions: rows ``r``
with ``r // G >= counts[b]`` attend nothing and come out zero, and a
kernel block whose rows are all parked does no window work.  The live rows
are unchanged (the chunk term is causal, so no live row reads a parked
key).  ``counts=None`` is the launch without it.

With bf16 q (the serving type) the verify runs the tensor-core kernel of
``csrc/chunk_attention.cuh`` (``verify_attention_kernel``): one block a
(slot, kv head, group of 16 / 32 / 64 query rows) x window piece, the
window tiles staged once a block through a ``cp.async`` ring and read by
every row tile, the probabilities kept f32 (a hi/lo bf16 pair into
P . V); :func:`verify_plan` cuts the window into pieces from the shapes
alone, and the last piece also attends the chunk.  f32 q keeps the first
design (one query row a block on the CUDA cores, a merge kernel that
joins the chunk keys).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build

# Kernel launches since import, all four wrappers together: one per
# call, the split kernel and its merge together.  ``verify_launches``
# counts the two verify wrappers' calls again on their own.
launches = 0
verify_launches = 0

# How the window is split (``num_splits``): the H100's SMs, the blocks of
# the G = 1 kernel an SM holds at once (its launch bounds), the fewest
# positions worth a block, the most whose scores a block holds in shared
# memory (the kernel's kMaxChunk), and the widest window that stays whole.
NUM_SMS = 132
BLOCKS_PER_SM = 4
MIN_SPLIT = 64
MAX_SPLIT = 2048
WHOLE_WINDOW = 192

_GROUPS = (1, 2, 4, 8)
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_verify_fn = None
# Query rows of the f32-q verify (one a block on the grid's y axis).
MAX_F32_VERIFY_ROWS = 65535
# The bf16 verify's plan (``verify_plan``): keys a staged tile, query rows
# a block by the row count (its 4 warps split a tile's 16-key slices 4, 2
# or 1 ways), and the blocks the window pieces aim to fill: one wave of
# the kernel's 3 blocks an SM (fewer, longer pieces won the sweep of
# ``chip_smoke.py`` on the H100 at S = 5, 17 and 65).
VERIFY_TILE = 64
VERIFY_ROWS = (16, 32, 64)
VERIFY_BLOCKS = 3 * NUM_SMS


class VerifyPlan(NamedTuple):
    """How the bf16 verify kernel covers a call: ``rows`` query rows a
    block in ``row_groups`` groups a (slot, kv head), the window cut into
    ``splits`` pieces of ``piece_len`` positions (the last may hold fewer;
    it also attends the chunk)."""

    rows: int
    row_groups: int
    splits: int
    piece_len: int


def verify_plan(b: int, nkv: int, r: int, w: int, blocks: int | None = None) -> VerifyPlan:
    """The bf16 verify's grid from the shapes alone: the narrowest row
    group that holds ``r`` rows (at most 64; more rows take more groups),
    then as many tile-aligned window pieces as fill ``blocks`` blocks
    (``VERIFY_BLOCKS``), at least one tile each."""
    blocks = VERIFY_BLOCKS if blocks is None else blocks
    rows = next((x for x in VERIFY_ROWS if r <= x), VERIFY_ROWS[-1])
    groups = -(-r // rows)
    tiles = -(-w // VERIFY_TILE)
    splits = max(1, min(tiles, blocks // (b * nkv * groups)))
    piece_tiles = -(-tiles // splits)
    return VerifyPlan(rows, groups, -(-tiles // piece_tiles), piece_tiles * VERIFY_TILE)


def verify_pieces(w: int, plan: VerifyPlan) -> list[tuple[int, int, bool]]:
    """The window positions ``[lo, hi)`` of each piece of ``plan`` and
    whether it attends the chunk (the last does)."""
    return [(i * plan.piece_len, min(w, (i + 1) * plan.piece_len), i == plan.splits - 1)
            for i in range(plan.splits)]


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with an f32 result: f64 operands contract in f64 and
    round, narrower ones contract in f32 (the reference's
    ``preferred_element_type=float32``)."""
    if a.dtype == torch.float64:
        return torch.einsum(eq, a, b).to(torch.float32)
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


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


def decode_attention_dense_reference(q, k, v, k_self, v_self, mask):
    """Plain PyTorch version of the dense-window kernel: the reference's
    chain (``models/llama.py:611-637``) on ``[B, NKV, G, D]`` queries.
    Scores and the softmax over the window and the self term in f32; the
    probabilities kept in f32 (f64 for f64 inputs) for the product with V,
    as the kernel keeps them.  Returns f32 (f64 for f64 inputs)."""
    d = q.shape[-1]
    sqrt_d = torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    scores = _einsum_f32("bngd,bnwd->bngw", q, k.to(q.dtype)) / sqrt_d
    scores = scores + mask[:, :, None, :]
    score_self = _einsum_f32("bngd,bnsd->bngs", q, k_self) / sqrt_d
    probs = torch.softmax(torch.cat([scores, score_self], dim=-1), dim=-1)
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    ctx = torch.einsum("bngw,bnwd->bngd", probs[..., :-1].to(wide), v.to(wide))
    return ctx + probs[..., -1:].to(wide) * v_self.to(wide)


def num_splits(b: int, nkv: int, w: int) -> int:
    """Blocks per (slot, kv head) over a window of ``w`` positions: as
    many as fit one wave of ``BLOCKS_PER_SM`` blocks on each SM, where the
    window has ``MIN_SPLIT`` positions a block for them; never a split
    wider than ``MAX_SPLIT``; 1 up to ``WHOLE_WINDOW`` (no merge launch).
    On the H100 one full wave beats a wave and a part (the split sweep of
    ``chip_smoke.py``, in ``PERF.md``)."""
    if w <= WHOLE_WINDOW:
        return 1
    wave = NUM_SMS * BLOCKS_PER_SM // (b * nkv)
    return max(1, min(wave, w // MIN_SPLIT), -(-w // MAX_SPLIT))


def split_len(w: int, splits: int) -> int:
    """Positions each split owns; the last may own fewer, or none."""
    return -(-w // splits)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [
            i32, i32, i32, i32, vp,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, vp, vp, ll,
            vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_float, vp,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _verify_kernel():
    global _verify_fn
    if _verify_fn is None:
        fn = _build.load("decode_attention").verify_attention_launch
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [
            i32, i32, i32, vp,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, ll, ll, ll,
            vp, vp, vp, vp, vp, vp, vp, ll,
            vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, vp, vp,
        ]
        fn.restype = ctypes.c_int
        _verify_fn = fn
    return _verify_fn


def _check_window(q, k8, ks, v8, vs, mask, exact: dict, other: dict | None = None) -> int:
    """The kernel's contract on the device, the types and the shapes of
    the window and of the per-row tensors (name -> (tensor, expected
    shape)): ``exact`` of q's type, ``other`` of their own types.
    Returns the bytes a lane loads of a cache row."""
    rows = {**exact, **(other or {})}
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q.device}")
    dense = ks is None
    b, nkv, _, d = q.shape
    w = k8.shape[2]
    named = [("k8", k8), ("v8", v8), ("mask", mask)] + [(n, t) for n, (t, _) in rows.items()]
    if not dense:
        named += [("ks", ks), ("vs", vs)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"decode attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t, _ in exact.values()):
        raise ValueError(
            f"decode attention: q and its exact K/V rows must share float32 or "
            f"bfloat16, got q {q.dtype}, "
            + ", ".join(f"{n} {t.dtype}" for n, (t, _) in exact.items())
        )
    cache_dtype = q.dtype if dense else torch.int8
    if k8.dtype != cache_dtype or v8.dtype != cache_dtype:
        raise ValueError(f"decode attention: the window must be {cache_dtype}, got "
                         f"{k8.dtype}/{v8.dtype}")
    if mask.dtype != torch.float32 or (
            not dense and (ks.dtype != torch.float32 or vs.dtype != torch.float32)):
        raise ValueError("decode attention: ks, vs and mask must be float32")
    if (k8.shape != (b, nkv, w, d) or v8.shape != (b, nkv, w, d)
            or (not dense and (ks.shape != (b, nkv, w, 1) or vs.shape != (b, nkv, w, 1)))
            or any(t.shape != shape for t, shape in rows.values())
            or mask.shape != (b, 1, w)):
        raise ValueError(
            "decode attention: shapes disagree: q "
            f"{tuple(q.shape)}, k {tuple(k8.shape)}, v {tuple(v8.shape)}, ks "
            f"{None if dense else tuple(ks.shape)}, vs {None if dense else tuple(vs.shape)}, "
            + ", ".join(f"{n} {tuple(t.shape)}" for n, (t, _) in rows.items())
            + f", mask {tuple(mask.shape)}"
        )
    for name, t in (("k", k8), ("v", v8)):
        # Loads of 4 bytes at least: dense D, every stride and the base 4-byte aligned.
        st = t.stride()
        if st[3] != 1 or _byte_bits(t) % 4:
            raise ValueError(
                f"decode attention: {name} needs a dense last axis and "
                f"4-byte aligned strides, got strides {st}"
            )
    if mask.stride(2) != 1:
        raise ValueError("decode attention: mask needs a dense last axis")
    return load_width(k8, v8)


def _scales(ks, vs):
    if ks is None:
        return (None, 0, 0, 0), (None, 0, 0, 0)
    return (ks.data_ptr(), *ks.stride()[:3]), (vs.data_ptr(), *vs.stride()[:3])


def _launch(q, k8, ks, v8, vs, k_self, v_self, mask):
    """The kernel over an int8 window with its scales (``ks``, ``vs``) or,
    with both None, a dense window of q's type."""
    global launches
    b, nkv, g, d = q.shape
    w = k8.shape[2]
    vec = _check_window(q, k8, ks, v8, vs, mask, {
        "k_self": (k_self, (b, nkv, 1, d)), "v_self": (v_self, (b, nkv, 1, d))})
    if g not in _GROUPS:
        raise ValueError(f"decode attention kernel takes G in {_GROUPS}, got {g}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes D in {_HEAD_DIMS}, got {d}")
    dense = ks is None
    q = q.contiguous()          # [B, NKV, G, D]: a few KB, never the cache
    k_self = k_self.contiguous()
    v_self = v_self.contiguous()
    out = torch.empty((b, nkv, g, d), dtype=torch.float32, device=q.device)
    splits = num_splits(b, nkv, w)
    # The splits' partials (acc [G, D], then m and l per g); none for one split.
    part = (torch.empty(b * nkv * splits * g * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    scales = _scales(ks, vs)
    rc = _kernel()(
        _DTYPES[q.dtype], int(dense), g, vec, q.data_ptr(),
        k8.data_ptr(), k8.stride(0), k8.stride(1), k8.stride(2),
        *scales[0],
        v8.data_ptr(), v8.stride(0), v8.stride(1), v8.stride(2),
        *scales[1],
        k_self.data_ptr(), v_self.data_ptr(), mask.data_ptr(), mask.stride(0),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        b, nkv, w, d, splits, split_len(w, splits), 1.0 / math.sqrt(d),
        _build.current_stream(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def _verify_shapes(q, k_chunk, counts=None) -> tuple[int, int]:
    """(S, G) of a verify call, or the ``ValueError`` the kernel's wrapper
    and the plain versions alike raise for a shape it does not take
    (``counts``: None, or int32 ``[B]`` on q's device, contiguous)."""
    if q.dim() != 4 or k_chunk.dim() != 4:
        raise ValueError(f"verify attention: q {tuple(q.shape)} and the chunk "
                         f"{tuple(k_chunk.shape)} must be [B, NKV, rows, D]")
    r, d = q.shape[2], q.shape[3]
    s = k_chunk.shape[2]
    if s < 1:
        raise ValueError(f"verify attention takes at least 1 chunk position, got {s} "
                         "chunk positions")
    if r % s or r // s not in _GROUPS:
        raise ValueError(f"verify attention: {r} query rows for {s} chunk positions; "
                         f"the kernel takes S * G rows with G in {_GROUPS}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"verify attention kernel takes D in {_HEAD_DIMS}, got {d}")
    if k_chunk.shape != (q.shape[0], q.shape[1], s, d):
        raise ValueError(f"verify attention: chunk {tuple(k_chunk.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if counts is not None and (counts.dtype != torch.int32 or counts.shape != (q.shape[0],)
                               or counts.device != q.device or not counts.is_contiguous()):
        raise ValueError(f"verify attention: counts must be a contiguous int32 [{q.shape[0]}] "
                         f"on {q.device}, got {counts.dtype} {tuple(counts.shape)} on "
                         f"{counts.device}")
    return s, r // s


def _launch_verify(q, k8, ks, v8, vs, k_chunk, v_chunk, k8c, ksc, v8c, vsc, mask,
                   counts=None):
    """The verify instance over an int8 window (``ks``, ``vs``, and the
    round-tripped chunk ``k8c``.. ``vsc``) or, with those None, a dense
    window of q's type; ``counts`` as :func:`verify_attention`."""
    global launches, verify_launches
    if q.device.type != "cuda":
        raise ValueError(f"verify attention: unsupported device {q.device}")
    s, g = _verify_shapes(q, k_chunk, counts)
    b, nkv, r, d = q.shape
    w = k8.shape[2]
    dense = ks is None
    vec = _check_window(
        q, k8, ks, v8, vs, mask,
        {"k_chunk": (k_chunk, (b, nkv, s, d)), "v_chunk": (v_chunk, (b, nkv, s, d))},
        None if dense else {"k8c": (k8c, (b, nkv, s, d)), "v8c": (v8c, (b, nkv, s, d)),
                            "ksc": (ksc, (b, nkv, s, 1)), "vsc": (vsc, (b, nkv, s, 1))})
    if not dense and (k8c.dtype != torch.int8 or v8c.dtype != torch.int8
                      or ksc.dtype != torch.float32 or vsc.dtype != torch.float32):
        raise ValueError("verify attention: the round-tripped chunk must be int8 with "
                         "float32 scales")
    # The chunk's rows (never the cache): contiguous, 16-byte aligned.
    q, k_chunk, v_chunk = (_aligned(t) for t in (q, k_chunk, v_chunk))
    if not dense:
        k8c, ksc, v8c, vsc = (_aligned(t) for t in (k8c, ksc, v8c, vsc))
    out = torch.empty((b, nkv, r, d), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        plan = verify_plan(b, nkv, r, w)
        splits, chunk, rows = plan.splits, plan.piece_len, plan.rows
        # The pieces' partials (acc [D], then m and l a row); none for one piece.
        part = (torch.empty(b * nkv * splits * r * (d + 2), dtype=torch.float32,
                            device=q.device) if splits > 1 else None)
    else:
        # f32 q: one query row a block, every split's partial to the merge
        # kernel that joins the chunk term.
        if r > MAX_F32_VERIFY_ROWS:
            raise ValueError(f"verify attention: {r} query rows with f32 q; the kernel takes "
                             f"at most {MAX_F32_VERIFY_ROWS}")
        splits = num_splits(b, nkv * r, w)
        chunk, rows = split_len(w, splits), 0
        part = torch.empty(b * nkv * r * splits * (d + 2), dtype=torch.float32, device=q.device)
    scales = _scales(ks, vs)
    rc = _verify_kernel()(
        _DTYPES[q.dtype], int(dense), vec, q.data_ptr(),
        k8.data_ptr(), k8.stride(0), k8.stride(1), k8.stride(2),
        *scales[0],
        v8.data_ptr(), v8.stride(0), v8.stride(1), v8.stride(2),
        *scales[1],
        k_chunk.data_ptr(), v_chunk.data_ptr(),
        None if dense else k8c.data_ptr(), None if dense else ksc.data_ptr(),
        None if dense else v8c.data_ptr(), None if dense else vsc.data_ptr(),
        mask.data_ptr(), mask.stride(0),
        out.data_ptr(), None if part is None else part.data_ptr(),
        b, nkv, w, d, splits, chunk, r, s, g, rows, 1.0 / math.sqrt(d),
        None if counts is None else counts.data_ptr(), _build.current_stream(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"verify attention kernel launch failed: cudaError {rc}")
    launches += 1
    verify_launches += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (a fresh copy if not):
    the kernel copies the chunk's rows 16 bytes at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _byte_bits(t: torch.Tensor) -> int:
    """The base address OR'd with the batch, head and position strides in
    bytes: its low bits say how the rows are aligned."""
    size = t.element_size()
    st = t.stride()
    return t.data_ptr() | (st[0] * size) | (st[1] * size) | (st[2] * size)


def load_width(k8: torch.Tensor, v8: torch.Tensor) -> int:
    """Bytes a lane loads of a cache row: 16 when the bases and the batch,
    head and position strides (in bytes) of both windows are 16-byte
    aligned (the head-major cache always is), else 4."""
    return 4 if (_byte_bits(k8) | _byte_bits(v8)) % 16 else 16


def decode_attention(q, k8, ks, v8, vs, k_self, v_self, mask):
    """Fused int8-KV decode attention, split over the window.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k8, ks, v8, vs, k_self, v_self, mask)
    return _launch(q, k8, ks, v8, vs, k_self, v_self, mask)


def decode_attention_batched(q, k8, ks, v8, vs, k_self, v_self, mask):
    """Same launch as :func:`decode_attention`: the TPU kernel's slot
    blocking shrank a sequential grid, which the card does not have."""
    return decode_attention(q, k8, ks, v8, vs, k_self, v_self, mask)


def decode_attention_dense(q, k, v, k_self, v_self, mask):
    """Decode attention over a dense window ``k``/``v`` ``[B, NKV, W, D]``
    of q's type (the bf16 ragged cache's head-major views), split over the
    window, any G.  CPU tensors take the plain version; CUDA tensors the
    kernel, or a ``ValueError``."""
    if q.device.type == "cpu":
        return decode_attention_dense_reference(q, k, v, k_self, v_self, mask)
    return _launch(q, k, None, v, None, k_self, v_self, mask)


def decode_attention_vpu(q, k8, ks, v8, vs, k_self, v_self, mask):
    """The G == 1 instantiation of the kernel (the TPU's VPU form); any
    window width."""
    g = q.shape[2]
    if g != 1:
        raise ValueError(f"decode_attention_vpu requires G == 1, got {g}")
    return decode_attention(q, k8, ks, v8, vs, k_self, v_self, mask)


def _verify_chain(q, k, v, k_chunk, v_chunk, mask, ks=None, vs=None, rt=None, counts=None):
    """The reference's verify attention (``models/llama.py:1083-1152`` of
    the JAX package) on the kernel's layouts.  ``ks``/``vs``: the window's
    scales (None for a dense window); ``rt``: the round-tripped chunk
    ``(k8c, ksc, v8c, vsc)`` that the rows below the diagonal read (None:
    every chunk key exact).  Scores and the softmax in f32, with the
    reference's -1e9 biases; the probabilities cast to the product's type
    (f64 for f64 inputs, else f32, as the kernel keeps them).  Any chunk
    length: the packed prefill's plain version (``ops.flash_attention``)
    runs it at the prefill chunk.  ``counts``: rows at or past a slot's live
    count come out zero."""
    s = k_chunk.shape[2]
    g = q.shape[2] // s
    d = q.shape[-1]
    sqrt_d = torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    scores = _einsum_f32("bnrd,bnwd->bnrw", q, k.to(q.dtype)) / sqrt_d
    if ks is not None:
        scores = scores * ks[..., 0].to(torch.float32)[:, :, None, :]
    scores = scores + mask[:, :, None, :]
    row_s = torch.arange(q.shape[2], device=q.device) // g
    j = torch.arange(s, device=q.device)
    eye = row_s[:, None] == j[None, :]                       # [S*G, S]
    chunk = _einsum_f32("bnrd,bnjd->bnrj", q, k_chunk) / sqrt_d
    if rt is not None:
        k8c, ksc, _, _ = rt
        below = _einsum_f32("bnrd,bnjd->bnrj", q, k8c.to(q.dtype)) / sqrt_d
        chunk = torch.where(eye, chunk, below * ksc[..., 0].to(torch.float32)[:, :, None, :])
    chunk = chunk + torch.where(j[None, :] <= row_s[:, None], 0.0, -1e9).to(torch.float32)
    probs = torch.softmax(torch.cat([scores, chunk], dim=-1), dim=-1)
    p_win, p_chunk = probs[..., :-s], probs[..., -s:]
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    if vs is not None:
        p_win = p_win * vs[..., 0].to(torch.float32)[:, :, None, :]
    ctx = torch.einsum("bnrw,bnwd->bnrd", p_win.to(wide), v.to(wide))
    if rt is None:
        ctx = ctx + torch.einsum("bnrj,bnjd->bnrd", p_chunk.to(wide), v_chunk.to(wide))
    else:
        _, _, v8c, vsc = rt
        eyef = eye.to(probs.dtype)
        ctx = ctx + torch.einsum("bnrj,bnjd->bnrd", (p_chunk * eyef).to(wide),
                                 v_chunk.to(wide))
        below = p_chunk * (1.0 - eyef) * vsc[..., 0].to(torch.float32)[:, :, None, :]
        ctx = ctx + torch.einsum("bnrj,bnjd->bnrd", below.to(wide), v8c.to(wide))
    if counts is None:
        return ctx
    live = row_s[None, :] < counts.to(row_s.device)[:, None]    # [B, S*G]
    return torch.where(live[:, None, :, None], ctx, ctx.new_zeros(()))


def verify_attention_reference(q, k8, ks, v8, vs, k_chunk, v_chunk, k8c, ksc, v8c, vsc,
                               mask, counts=None):
    """Plain PyTorch version of :func:`verify_attention`: the int8 window
    with its scales, the chunk's exact diagonal and its round-tripped rows
    below it.  Returns f32 (f64 for f64 inputs)."""
    _verify_shapes(q, k_chunk, counts)
    return _verify_chain(q, k8, v8, k_chunk, v_chunk, mask, ks, vs, (k8c, ksc, v8c, vsc),
                         counts)


def verify_attention_dense_reference(q, k, v, k_chunk, v_chunk, mask, counts=None):
    """Plain PyTorch version of :func:`verify_attention_dense`: every chunk
    key exact, as on the dense cache.  Returns f32 (f64 for f64 inputs)."""
    _verify_shapes(q, k_chunk, counts)
    return _verify_chain(q, k, v, k_chunk, v_chunk, mask, counts=counts)


def verify_attention(q, k8, ks, v8, vs, k_chunk, v_chunk, k8c, ksc, v8c, vsc, mask,
                     counts=None):
    """Verify attention over an int8 window: S chunk rows a (slot, kv
    head, group), the window under the strict mask plus the chunk's causal
    keys, one launch; ``counts`` (int32 ``[B]``, optional) parks each
    slot's rows at and past its live count.  CPU tensors take the plain
    version; CUDA tensors the kernel, or a ``ValueError``."""
    if q.device.type == "cpu":
        return verify_attention_reference(q, k8, ks, v8, vs, k_chunk, v_chunk, k8c, ksc,
                                          v8c, vsc, mask, counts)
    return _launch_verify(q, k8, ks, v8, vs, k_chunk, v_chunk, k8c, ksc, v8c, vsc, mask,
                          counts)


def verify_attention_dense(q, k, v, k_chunk, v_chunk, mask, counts=None):
    """Verify attention over a dense window of q's type (``counts`` as
    :func:`verify_attention`).  CPU tensors take the plain version; CUDA
    tensors the kernel, or a ``ValueError``."""
    if q.device.type == "cpu":
        return verify_attention_dense_reference(q, k, v, k_chunk, v_chunk, mask, counts)
    return _launch_verify(q, k, None, v, None, k_chunk, v_chunk, None, None, None, None, mask,
                          counts)
