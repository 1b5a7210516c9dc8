"""Llama-2 decoder in PyTorch (port of the JAX package's ``models/llama.py``).

Pre-RMSNorm, rotate-half RoPE, grouped-query attention, SwiGLU MLP,
untied LM head.  The parameter tree keeps the reference layout: layer
weights stacked ``[L, in, out]``, int8 leaves ``{"q8", "scale"}``.

Numerics follow the reference step for step: every product the
reference runs with ``preferred_element_type=float32`` returns f32 here
too (an f64 product is rounded to f32, as XLA does), RoPE tables are f32,
norms run in f32, and the int8 cache scales fold into the score and
probability rows.  That is what lets the CPU tests hold this module to
the JAX one in f64.

Where the reference donates a buffer, this module writes the cache in
place: ``forward``, ``decode_ragged`` and ``insert_sequence`` return a
cache tuple that SHARES the input's buffers (with new lengths); the
caller must treat the input cache as consumed.

Kernels on this path: ``models.common.rms_norm`` (2L+1 launches per
forward); flash attention for prefill and chunked prefill on the dense
position-major cache (one launch per layer per forward: the chunk's
queries at their cache offset against the prefix, grouped K/V heads read
in place); and the fused decode attention, over the int8 window or the
dense one (one launch per layer per decode step); and the verify chunk
instance of the decode kernel for self-speculative verify (one launch per
layer per verify forward); flash with its log-sum-exp for the blocks of
the sequence-parallel prefill (``prefill_ring``: one launch a layer a
ring step, less the blocks wholly above the diagonal); and the ragged instance of the flash kernel
for packed multi-admission prefill (one launch per layer per packed
forward: each packed row's chunk against the window of its cache row, int8
or bf16, and its own causal keys).  ``decode_multistep`` chains K
``decode_ragged`` steps with no host sync, so the engine captures it as
one CUDA graph (``server/cuda_graphs.py``); so does ``super_step_ragged``,
the unified engine's whole tick (decode, verify and packed-prefill rows in
one forward through the verify chunk kernel with a live count a row, then
the decode rows' K - 1 further steps).  The int8 position-major cache of
``_block`` (no engine caller, here or in the JAX package) keeps the
reference's einsum chain.

Every entry takes ``mesh`` (a ``parallel.ServingMesh``), or None for one
device, which is the code path above unchanged.  On a mesh the parameters
and the KV cache are this rank's blocks (``models/partition.py``, the
Megatron split) and the collectives the reference's XLA inserts are
explicit: a tp ``psum`` after the o and down projections (the int8 scale of
o/down factors out of the sum) and after the vocab-split embedding lookup,
an all-gather of the vocab-split ``lm_head`` columns, so the logits are
whole on every rank, and under dp a rank runs its block of cache rows and
the rows' logits are gathered.  The kernels take the rank's heads as they
are: decode attention at NKV/tp heads, flash at H/tp, RMSNorm on the full
(replicated) residual.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.decode_attention import (
    decode_attention_batched,
    decode_attention_dense,
    decode_attention_vpu,
    verify_attention,
    verify_attention_dense,
)
from ..ops.flash_attention import flash_attention, flash_attention_ragged
from ..ops.ring_attention import ring_attention
from ..parallel.collectives import all_gather_concat, psum
from .common import matmul_f32, rms_norm
from .quantization import is_quantized, quantize_tensor

# ---------------------------------------------------------------------------
# Products with an f32 result (the reference's preferred_element_type=f32)
# ---------------------------------------------------------------------------


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with an f32 result: f64 operands contract in f64 and
    round, half-precision operands contract in f32."""
    if a.dtype == torch.float64:
        return torch.einsum(eq, a, b).to(torch.float32)
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ dequantize(w)`` with the scale applied to the OUTPUT.

    The int8 scale is per output channel (``[..., 1, out]``), so ``x @
    (q8 * scale) == (x @ q8) * scale`` exactly; the f32 scale multiplies
    the f32 product.  On the card ``q8.to(x.dtype)`` is a transient bf16
    copy of the weight for each call (a W8A16 kernel is later work)."""
    if is_quantized(w):
        y = matmul_f32(x, w["q8"].to(x.dtype))
        return y * w["scale"].to(torch.float32)
    return matmul_f32(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# The sharded forward: a rank's block and the collectives XLA inserts in the
# reference (``models/partition.py``'s rule table)
# ---------------------------------------------------------------------------


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def _heads(cfg: "LlamaConfig", mesh) -> tuple[int, int, int]:
    """This rank's (query heads, KV heads, head dim): the heads split over tp."""
    tp = _tp(mesh)
    return cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim


def _dp_rows(mesh, batch: int) -> slice | None:
    """This rank's block of the ``batch`` cache rows under dp > 1 (None:
    every row is this rank's)."""
    if mesh is None or mesh.dp == 1:
        return None
    n = batch // mesh.dp
    lo = mesh.index("dp") * n
    return slice(lo, lo + n)


def _rows(t, rows: slice | None):
    return t if rows is None or t is None else t[rows]


def _dp_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every dp shard's rows of ``t``, concatenated in row order."""
    if mesh is None or mesh.dp == 1:
        return t
    return all_gather_concat(t, mesh.group("dp"), axis=0)


def _embed(params: dict, ids: torch.Tensor, dtype, mesh) -> torch.Tensor:
    """The embedding lookup; at tp > 1 each rank holds a block of vocab
    rows: ids outside it read zeros, and the tp psum adds the one rank's
    row to zeros (exact)."""
    table = params["embed"]
    if _tp(mesh) == 1:
        return table[ids].to(dtype)
    rows = table.shape[0]
    local = ids - mesh.index("tp") * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return psum(x, mesh.group("tp")).to(dtype)


def _qmatmul_rows(x: torch.Tensor, w, mesh) -> torch.Tensor:
    """The o/down projection, split on its INPUT axis at tp > 1: each rank's
    f32 partial product, summed over tp; the int8 scale (per output
    channel, replicated) multiplies the sum."""
    if _tp(mesh) == 1:
        return _qmatmul(x, w)
    g = mesh.group("tp")
    if is_quantized(w):
        return psum(matmul_f32(x, w["q8"].to(x.dtype)), g) * w["scale"].to(torch.float32)
    return psum(matmul_f32(x, w.to(x.dtype)), g)


def _lm_head(params: dict, x: torch.Tensor, mesh) -> torch.Tensor:
    """f32 logits over the whole vocab: at tp > 1 each rank's vocab columns,
    all-gathered, so sampling sees the replicated logits."""
    logits = _qmatmul(x, params["lm_head"])
    if _tp(mesh) == 1:
        return logits
    return all_gather_concat(logits, mesh.group("tp"), axis=-1)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        defaults = dict(
            vocab_size=256,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            intermediate_size=128,
            max_seq=64,
        )
        defaults.update(kw)
        return cls(**defaults)


def matmul_param_count(cfg: LlamaConfig) -> int:
    """Weight-matrix elements one token position multiplies through in a
    forward: the q/k/v/o projections, the SwiGLU triple and the untied LM
    head (the embedding lookup moves bytes, not FLOPs).  The device
    telemetry cost model's dominant term, 2 FLOPs an element a position."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = h * nh * hd + 2 * h * nkv * hd + nh * hd * h + 3 * h * i
    return cfg.num_layers * per_layer + h * v


class KVCache(NamedTuple):
    """Single-length cache, position-major: k/v ``[L, B, T, NKV, D]``;
    ``length`` (int) is the number of valid positions."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
               device=None, mesh=None) -> "KVCache":
        """``mesh``: this rank's heads (tp), every row (the scratch is
        replicated over dp)."""
        shape = (cfg.num_layers, batch, cfg.max_seq, _heads(cfg, mesh)[1], cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=0,
        )


class RaggedKVCache(NamedTuple):
    """Multi-slot cache with per-row lengths, head-major:
    k/v ``[L, B, NKV, T, D]``, lengths int32 ``[B]``.  On a mesh a rank
    holds ``[L, B/dp, NKV/tp, T, D]`` and every row's length."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
               device=None, mesh=None) -> "RaggedKVCache":
        shape = _ragged_shape(cfg, batch, mesh)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )


class QuantRaggedKVCache(NamedTuple):
    """Int8 variant of :class:`RaggedKVCache`: k8/v8 int8 ``[L, B, NKV,
    T, D]`` with f32 per-(position, head) scales ``[L, B, NKV, T, 1]``.
    Head-major, so one (slot, kv head)'s window is a strided view the
    decode kernel reads in place."""

    k8: torch.Tensor
    k_scale: torch.Tensor
    v8: torch.Tensor
    v_scale: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, device=None, mesh=None) -> "QuantRaggedKVCache":
        shape = _ragged_shape(cfg, batch, mesh)
        sshape = shape[:-1] + (1,)
        return cls(
            k8=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v8=torch.zeros(shape, dtype=torch.int8, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )


def _ragged_shape(cfg: LlamaConfig, batch: int, mesh) -> tuple[int, ...]:
    rows = _dp_rows(mesh, batch)
    b = batch if rows is None else rows.stop - rows.start
    return (cfg.num_layers, b, _heads(cfg, mesh)[1], cfg.max_seq, cfg.head_dim)


def _quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) int8 over the trailing head_dim axis."""
    q = quantize_tensor(x, axis=-1)
    return q["q8"], q["scale"]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, cfg: LlamaConfig, dtype=torch.float32,
         device=None) -> dict:
    """Random weights (normal, std 0.02; norms at 1) drawn from
    ``generator``, which must live on ``device``."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers

    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w.mul_(0.02)).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": normal((v, h)),
        "layers": {
            "attn_norm": ones((L, h)),
            "q": normal((L, h, nh * hd)),
            "k": normal((L, h, nkv * hd)),
            "v": normal((L, h, nkv * hd)),
            "o": normal((L, nh * hd, h)),
            "mlp_norm": ones((L, h)),
            "gate": normal((L, h, i)),
            "up": normal((L, h, i)),
            "down": normal((L, i, h)),
        },
        "final_norm": ones((h,)),
        "lm_head": normal((h, v)),
    }


def from_torch(torch_model, cfg: LlamaConfig) -> dict:
    """Convert a HuggingFace ``LlamaForCausalLM`` (or its state dict) into
    the parameter tree, float32 on the CPU: per-layer weights stacked on a
    leading layer axis, projections transposed to ``[in, out]``."""
    sd = torch_model if isinstance(torch_model, dict) else torch_model.state_dict()
    sd = {k: v.detach().cpu().float() for k, v in sd.items()}

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        mats = [sd[fmt.format(i)] for i in range(cfg.num_layers)]
        if transpose:
            mats = [m.T for m in mats]
        return torch.stack(mats, dim=0).contiguous()

    return {
        "embed": sd["model.embed_tokens.weight"].contiguous(),
        "layers": {
            "attn_norm": stack("model.layers.{}.input_layernorm.weight"),
            "q": stack("model.layers.{}.self_attn.q_proj.weight", transpose=True),
            "k": stack("model.layers.{}.self_attn.k_proj.weight", transpose=True),
            "v": stack("model.layers.{}.self_attn.v_proj.weight", transpose=True),
            "o": stack("model.layers.{}.self_attn.o_proj.weight", transpose=True),
            "mlp_norm": stack("model.layers.{}.post_attention_layernorm.weight"),
            "gate": stack("model.layers.{}.mlp.gate_proj.weight", transpose=True),
            "up": stack("model.layers.{}.mlp.up_proj.weight", transpose=True),
            "down": stack("model.layers.{}.mlp.down_proj.weight", transpose=True),
        },
        "final_norm": sd["model.norm.weight"].contiguous(),
        "lm_head": sd["lm_head.weight"].T.contiguous(),
    }


def _layer(layers: dict, l: int) -> dict:
    """Layer ``l`` of the stacked layer tree (int8 leaves stay dicts)."""
    return {
        name: ({"q8": w["q8"][l], "scale": w["scale"][l]} if is_quantized(w) else w[l])
        for name, w in layers.items()
    }


# ---------------------------------------------------------------------------
# RoPE (HF rotate-half convention)
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, cfg: LlamaConfig, dtype=torch.float32):
    """cos/sin tables for ``positions`` [S] (or [B, S]) -> [..., head_dim],
    computed in f32 whatever the model's type."""
    hd = cfg.head_dim
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, N, D]; cos/sin: [S, D] (shared) or [B, S, D] (per row)."""
    if cos.dim() == 2:
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    else:
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    return (x * c + _rotate_half(x) * s).to(x.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mlp(x: torch.Tensor, lp: dict, cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    xn = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    gate = _qmatmul(xn, lp["gate"])
    up = _qmatmul(xn, lp["up"])
    act = F.silu(gate) * up
    down = _qmatmul_rows(act.to(x.dtype), lp["down"], mesh).to(x.dtype)
    return x + down


def _qkv(x: torch.Tensor, lp: dict, cos, sin, cfg: LlamaConfig, mesh=None):
    b, s, _ = x.shape
    nh, nkv, hd = _heads(cfg, mesh)
    xn = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = _qmatmul(xn, lp["q"]).to(x.dtype).reshape(b, s, nh, hd)
    k = _qmatmul(xn, lp["k"]).to(x.dtype).reshape(b, s, nkv, hd)
    v = _qmatmul(xn, lp["v"]).to(x.dtype).reshape(b, s, nkv, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _block(
    x: torch.Tensor,
    lp: dict,
    cache_k,
    cache_v,
    start: int,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask_bias: torch.Tensor | None,
    cfg: LlamaConfig,
    window: int | None = None,
    mesh=None,
):
    """One decoder layer over a fixed-capacity cache (prefill and chunked
    prefill).  x: [B,S,H]; cache_k/v: [B,T,NKV,D] views of the layer's
    buffer, or (int8 values, f32 scales [B,T,NKV,1]) pairs; ``start`` is
    the write offset shared by the batch.  This chunk's K/V is written
    into the cache IN PLACE at [start, start+S).

    The dense cache attends through the flash kernel (its plain version
    on the CPU): the chunk's queries at positions [start, start+S) against
    the keys [0, start+S), causal, read through strided views of q and the
    cache.  That is the reference's function: its -1e9 additive mask and
    the kernel's -1e30 replacement both weigh a masked key exactly 0, as
    every query sees at least itself; ``window`` and ``mask_bias`` are not
    read.  The int8 pairs run the reference's chain, where ``window``
    restricts attention to cache positions [0, window) and
    ``mask_bias``'s key axis is window-sized.  Returns (y, cache_k,
    cache_v)."""
    b, s, _ = x.shape
    nh, nkv, hd = _heads(cfg, mesh)
    q, k, v = _qkv(x, lp, cos, sin, cfg, mesh)

    if not isinstance(cache_k, tuple):
        cache_k[:, start:start + s] = k.to(cache_k.dtype)
        cache_v[:, start:start + s] = v.to(cache_v.dtype)
        # [B, H, S, D] views of q and of the written prefix; the output is
        # a [B, H, S, D] view of a [B, S, H, D] buffer.
        kk = cache_k[:, :start + s].to(x.dtype).transpose(1, 2)
        vv = cache_v[:, :start + s].to(x.dtype).transpose(1, 2)
        out = flash_attention(q.transpose(1, 2), kk, vv, causal=True, kv_len=start + s,
                              scale=1.0 / math.sqrt(hd), q_offset=start)
        ctx = out.transpose(1, 2).reshape(b, s, nh * hd)
        x = x + _qmatmul_rows(ctx, lp["o"], mesh).to(x.dtype)
        return _mlp(x, lp, cfg, mesh), cache_k, cache_v

    k8, ks = cache_k
    v8, vs = cache_v
    kq, kqs = _quant_kv(k)
    vq, vqs = _quant_kv(v)
    k8[:, start:start + s] = kq
    ks[:, start:start + s] = kqs
    v8[:, start:start + s] = vq
    vs[:, start:start + s] = vqs

    # GQA: q grouped [B,S,NKV,G,D] contracts directly against the cache.
    group = nh // nkv
    qg = q.reshape(b, s, nkv, group, hd)
    sqrt_d = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    if window is not None:
        k8, ks = k8[:, :window], ks[:, :window]
        v8, vs = v8[:, :window], vs[:, :window]
    scores = _einsum_f32("bqngd,bknd->bngqk", qg, k8.to(x.dtype)) / sqrt_d
    kscale = ks[..., 0].movedim(1, 2)[:, :, None, None, :]
    scores = scores * kscale + mask_bias[:, None]
    probs = torch.softmax(scores, dim=-1)
    vscale = vs[..., 0].movedim(1, 2)[:, :, None, None, :]
    probs = (probs * vscale).to(x.dtype)
    ctx = torch.einsum("bngqk,bknd->bqngd", probs, v8.to(x.dtype))
    ctx = ctx.reshape(b, s, nh * hd)
    x = x + _qmatmul_rows(ctx, lp["o"], mesh).to(x.dtype)
    return _mlp(x, lp, cfg, mesh), cache_k, cache_v


def _block_decode_deferred(
    x: torch.Tensor,
    lp: dict,
    cache_k,
    cache_v,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask_bias: torch.Tensor,
    cfg: LlamaConfig,
    window: int,
    mesh=None,
):
    """One decoder layer for single-token ragged decode with the cache
    READ-ONLY: returns ``(y, k_new, v_new)``; :func:`decode_ragged`
    commits every layer's new row after the layer loop.

    The current token enters through an exact self-term, so ``mask_bias``
    is STRICT (``key_pos < position``).  The attention is the fused
    decode-attention kernel over the int8 window, or its dense instance
    over the bf16 one (their plain versions on the CPU; the dense one is
    the reference's chain)."""
    b, s, _ = x.shape  # s == 1
    nh, nkv, hd = _heads(cfg, mesh)
    q, k, v = _qkv(x, lp, cos, sin, cfg, mesh)
    group = nh // nkv
    qg = q.reshape(b, s, nkv, group, hd)
    k_self = k[:, 0][:, :, None, :]                     # [B, NKV, 1, D]
    v_self = v[:, 0][:, :, None, :]

    if isinstance(cache_k, tuple):
        attn = decode_attention_vpu if group == 1 else decode_attention_batched
        k8, ks = cache_k
        v8, vs = cache_v
        ctx4 = attn(
            qg[:, 0],                                   # [B, NKV, G, D]
            k8[:, :, :window],                          # strided views
            ks[:, :, :window],
            v8[:, :, :window],
            vs[:, :, :window],
            k_self, v_self,
            mask_bias[:, 0],                            # [B, 1, W]
        )
    else:
        ctx4 = decode_attention_dense(
            qg[:, 0],
            cache_k[:, :, :window].to(x.dtype),         # strided views
            cache_v[:, :, :window].to(x.dtype),
            k_self, v_self,
            mask_bias[:, 0],
        )
    ctx = ctx4[:, None].to(x.dtype).reshape(b, s, nh * hd)
    x = x + _qmatmul_rows(ctx, lp["o"], mesh).to(x.dtype)
    return _mlp(x, lp, cfg, mesh), k, v


def forward(
    params: dict,
    input_ids: torch.Tensor,
    cache: KVCache,
    cfg: LlamaConfig,
    dtype=torch.bfloat16,
    mesh=None,
) -> tuple[torch.Tensor, KVCache]:
    """Run ``input_ids`` [B,S] from ``cache.length`` (prefill, S = prompt;
    decode, S = 1).  Writes the cache in place.  Returns (logits
    [B,S,vocab] float32, cache).  ``mesh`` (a ``parallel.ServingMesh``, or
    None for one device): the parameters and the cache are this rank's
    blocks (``models/partition.py``), every rank runs every row (the
    scratch is replicated over dp) and the logits are whole.

    Attention reads only positions [0, start+S): the reference attends
    the whole buffer under a mask whose later columns are -1e9, whose
    softmax weights are exactly 0, so the result is the same.  The dense
    cache needs no mask (the flash kernel masks by position); the int8
    pairs get the reference's ``[S, start+S]`` additive mask."""
    b, s = input_ids.shape
    if s > cfg.max_seq:
        raise ValueError(
            f"sequence chunk of {s} tokens exceeds KV-cache capacity "
            f"max_seq={cfg.max_seq}"
        )
    start = int(cache.length)
    if start + s > cfg.max_seq:
        raise ValueError(
            f"chunk at {start} + {s} tokens exceeds KV-cache capacity "
            f"max_seq={cfg.max_seq}"
        )
    device = input_ids.device
    x = _embed(params, input_ids, dtype, mesh)
    positions = start + torch.arange(s, device=device)
    cos, sin = rope_cos_sin(positions, cfg)
    window = start + s
    mask_bias = None
    if isinstance(cache.k, tuple):
        key_pos = torch.arange(window, device=device)
        valid = key_pos[None, :] <= positions[:, None]
        mask_bias = torch.where(valid, 0.0, -1e9).to(torch.float32)[None, None]

    for l in range(cfg.num_layers):
        ck = cache.k[l] if not isinstance(cache.k, tuple) else tuple(t[l] for t in cache.k)
        cv = cache.v[l] if not isinstance(cache.v, tuple) else tuple(t[l] for t in cache.v)
        x, _, _ = _block(x, _layer(params["layers"], l), ck, cv, start, cos, sin,
                         mask_bias, cfg, window=window, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _lm_head(params, x, mesh)
    return logits, KVCache(cache.k, cache.v, start + s)


def prefill(params, input_ids, cfg, dtype=torch.bfloat16, mesh=None):
    cache = KVCache.create(cfg, input_ids.shape[0], dtype, input_ids.device, mesh)
    return forward(params, input_ids, cache, cfg, dtype, mesh)


def decode_step(params, token_ids, cache, cfg, dtype=torch.bfloat16, mesh=None):
    """One greedy decode step: token_ids [B,1] -> (logits [B,1,V], cache)."""
    return forward(params, token_ids, cache, cfg, dtype, mesh)


def _ring_block(x: torch.Tensor, lp: dict, cos: torch.Tensor, sin: torch.Tensor,
                cfg: LlamaConfig, mesh, axis_name: str):
    """One decoder layer over this rank's sequence shard with ring
    attention in place of the cache (the prompt IS the context).  x:
    ``[B, S/sp, H]``.  Heads split over tp as in :func:`_block` (``_qkv``,
    ``_heads``), the tp psums after o and down; the ring's blocks take the
    grouped K/V heads as they are.  Returns ``(y, k, v)``, k and v this
    layer's ``[B, S/sp, NKV/tp, D]`` rows (k rope'd, what ``_block``
    writes to the cache)."""
    b, s, _ = x.shape
    nh, _, hd = _heads(cfg, mesh)
    q, k, v = _qkv(x, lp, cos, sin, cfg, mesh)
    ctx = ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         mesh.group(axis_name), causal=True, scale=1.0 / math.sqrt(hd))
    ctx = ctx.transpose(1, 2).reshape(b, s, nh * hd)
    x = x + _qmatmul_rows(ctx, lp["o"], mesh).to(x.dtype)
    return _mlp(x, lp, cfg, mesh), k, v


def prefill_ring(params: dict, input_ids: torch.Tensor, cfg: LlamaConfig, *, mesh,
                 last_idx: int, dtype=torch.bfloat16, axis_name: str = "sp"):
    """Sequence-parallel prefill: the whole padded prompt in ONE pass, the
    sequence split over ``axis_name`` of ``mesh`` (rank ``i`` of the ring
    runs positions ``[i S/sp, (i + 1) S/sp)``) and ring attention
    (``ops/ring_attention.py``) in place of the dense scores.

    ``input_ids`` ``[1, S]`` is the whole prompt, padded to a length the sp
    degree divides, the same on every rank; ``last_idx`` is the final REAL
    row.  Returns ``(logits [1, V] f32, k_all, v_all)``: the logits of that
    row (its hidden state psummed over sp from the rank that holds it, one
    row plus zeros: exact), and each layer's K/V for the whole padded
    prompt, ``[L, 1, S, NKV/tp, D]`` all-gathered over sp (decode runs
    replicated over sp), the position-major scratch layout
    :func:`insert_sequence` takes.  Pad rows carry unused K/V, as in the
    reference; the insert's length caps what is read."""
    b, s = input_ids.shape
    n, r, group = mesh.size(axis_name), mesh.index(axis_name), mesh.group(axis_name)
    if s % n:
        raise ValueError(f"sp prefill: {s} positions do not split over sp={n}")
    if s > cfg.max_seq:
        raise ValueError(f"sp prefill of {s} positions exceeds KV-cache capacity "
                         f"max_seq={cfg.max_seq}")
    c = s // n
    x = _embed(params, input_ids[:, r * c:(r + 1) * c], dtype, mesh)
    cos, sin = rope_cos_sin(r * c + torch.arange(c, device=input_ids.device), cfg)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        x, k, v = _ring_block(x, _layer(params["layers"], l), cos, sin, cfg, mesh, axis_name)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    owner, row = divmod(int(last_idx), c)
    last = x[:, row] if owner == r else torch.zeros_like(x[:, 0])
    last = psum(last.to(torch.float32), group).to(x.dtype)  # [1, H]
    logits = _lm_head(params, last, mesh)
    k_all = all_gather_concat(torch.stack(ks), group, axis=2)
    v_all = all_gather_concat(torch.stack(vs), group, axis=2)
    return logits, k_all, v_all


def generate_greedy(
    params: dict,
    prompt_ids: torch.Tensor,
    num_new_tokens: int,
    cfg: LlamaConfig,
    dtype=torch.bfloat16,
    mesh=None,
) -> torch.Tensor:
    """Greedy generation: prefill, then ``num_new_tokens`` decode steps
    (the first new token comes from the prefill).  Returns [B, new]."""
    total = prompt_ids.shape[1] + num_new_tokens
    if total > cfg.max_seq:
        raise ValueError(
            f"prompt ({prompt_ids.shape[1]}) + new tokens ({num_new_tokens}) "
            f"= {total} exceeds KV-cache capacity max_seq={cfg.max_seq}"
        )
    logits, cache = prefill(params, prompt_ids, cfg, dtype, mesh)
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    out = []
    for _ in range(num_new_tokens):
        out.append(tok)
        logits, cache = decode_step(params, tok, cache, cfg, dtype, mesh)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Continuous batching primitives (per-row positions)
# ---------------------------------------------------------------------------


def decode_ragged(
    params: dict,
    token_ids: torch.Tensor,
    cache: "RaggedKVCache | QuantRaggedKVCache",
    cfg: LlamaConfig,
    active: torch.Tensor | None = None,
    dtype=torch.bfloat16,
    window: int | None = None,
    mesh=None,
):
    """One decode step where every batch row is at its OWN position.

    token_ids ``[B, 1]``; row i attends keys ``0..lengths[i]`` (the cache
    strictly below, itself through the exact self-term) and its new K/V
    row is committed at ``lengths[i]`` after the layer loop.  ``active``
    (bool ``[B]``) gates the length advance and the commit: an inactive
    row computes but writes nothing.  ``window`` bounds the attended
    prefix (a bucket above every active row's position).  The cache is
    updated in place.  Returns (logits ``[B, 1, vocab]`` f32, cache with
    advanced lengths).  Under dp > 1 (``mesh``) a rank runs its block of
    rows over its cache rows, and the logits of every row are gathered."""
    b, s = token_ids.shape
    if s != 1:
        raise ValueError(f"decode_ragged is single-token: got chunk of {s}")
    quant = isinstance(cache, QuantRaggedKVCache)
    rows = _dp_rows(mesh, b)
    lengths = _rows(cache.lengths, rows)
    x = _embed(params, _rows(token_ids, rows), dtype, mesh)
    positions = lengths[:, None]
    cos, sin = rope_cos_sin(positions, cfg)  # [B, 1, D]

    capacity = (cache.k8 if quant else cache.k).shape[3]
    window = capacity if window is None else min(int(window), capacity)
    key_pos = torch.arange(window, device=lengths.device)
    valid = key_pos[None, None, :] < positions[:, :, None]  # [B, 1, W]
    mask_bias = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None]

    k_news, v_news = [], []
    for l in range(cfg.num_layers):
        if quant:
            ck = (cache.k8[l], cache.k_scale[l])
            cv = (cache.v8[l], cache.v_scale[l])
        else:
            ck, cv = cache.k[l], cache.v[l]
        x, k_new, v_new = _block_decode_deferred(
            x, _layer(params["layers"], l), ck, cv, cos, sin, mask_bias, cfg,
            window=window, mesh=mesh,
        )
        k_news.append(k_new[:, 0])
        v_news.append(v_new[:, 0])
    logits = _finish_decode(
        params, x, torch.stack(k_news), torch.stack(v_news), cache, lengths,
        _rows(active, rows), quant, cfg, mesh,
    )
    if active is None:
        advance = torch.ones((b,), dtype=torch.int32, device=cache.lengths.device)
    else:
        advance = active.to(torch.int32)
    return _dp_gather(logits, mesh), cache._replace(lengths=cache.lengths + advance)


def decode_multistep(
    params: dict,
    token_ids: torch.Tensor,
    cache: "RaggedKVCache | QuantRaggedKVCache",
    cfg: LlamaConfig,
    active: torch.Tensor,
    remaining: torch.Tensor,
    eos_ids: torch.Tensor,
    steps: int,
    sample_fn,
    sample_carry=None,
    dtype=torch.bfloat16,
    window: int | None = None,
    mesh=None,
):
    """``steps`` (K) decode iterations chained on the device: the
    reference's ``lax.scan`` is a Python loop over :func:`decode_ragged`,
    each step's drawn token feeding the next step's embedding.  The body
    reads no tensor value on the host (no ``.item()``, no branch on a
    value), so the whole call can be captured as one CUDA graph.

    ``token_ids`` ``[B, 1]`` is each row's pending token (emitted, not
    yet fed); ``active`` bool ``[B]``; ``remaining`` int32 ``[B]`` each
    row's budget of new tokens; ``eos_ids`` int32 ``[B]`` each row's stop
    token, -1 for none.  ``sample_fn(logits [B, V], carry) -> (carry,
    next [B])`` is the per-step token rule (greedy: the argmax with the
    carry untouched; sampled: :func:`~.sampling.sample_chain_step` over
    the row keys).

    The EOS latch lives inside the loop: a row that draws its EOS or
    spends its budget leaves ``active`` for the remaining steps, so its
    length stops and its K/V writes park (``decode_ragged``'s gate).
    ``window`` must cover the last step's positions: a bucket of at least
    the longest active length + K - 1.

    Returns ``(tok_block [B, K], valid [B], toks [B, 1], cache,
    active_out, remaining_out, carry_out)``: ``tok_block[i, j]`` is real
    for ``j < valid[i]`` (frozen copies of the last token after), and the
    trailing outputs are the state the next call chains from."""
    toks, act, rem, carry = token_ids, active, remaining, sample_carry
    tok_seq, emit_seq = [], []
    for _ in range(int(steps)):
        logits, cache = decode_ragged(params, toks, cache, cfg, active=act, dtype=dtype,
                                      window=window, mesh=mesh)
        carry, nxt = sample_fn(logits[:, -1, :], carry)
        nxt = torch.where(act, nxt.to(toks.dtype), toks[:, 0])
        emit_seq.append(act)
        rem = rem - act.to(rem.dtype)
        act = act & (nxt != eos_ids) & (rem > 0)
        toks = nxt[:, None]
        tok_seq.append(nxt)
    tok_block = torch.stack(tok_seq, dim=1)
    valid = torch.stack(emit_seq, dim=0).to(torch.int32).sum(dim=0, dtype=torch.int32)
    return tok_block, valid, toks, cache, act, rem, carry


def _finish_decode(params, x, k_news, v_news, cache, lengths, active, quant, cfg, mesh=None):
    """Shared decode tail: final norm, lm_head, and the in-place cache
    commit of every layer's new row ``[L, B, NKV, D]`` at ``lengths`` (this
    rank's rows, and ``active`` with them).  Returns the logits."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _lm_head(params, x, mesh)
    if active is None:
        write_pos = lengths
    else:
        # Inactive rows write NOTHING: parked at capacity, dropped below.
        capacity = (cache.k8 if quant else cache.k).shape[3]
        write_pos = torch.where(active, lengths, torch.full_like(lengths, capacity))
    if quant:
        kq, kqs = _quant_kv(k_news)
        vq, vqs = _quant_kv(v_news)
        _commit_rows(cache.k8, kq, write_pos)
        _commit_rows(cache.k_scale, kqs, write_pos)
        _commit_rows(cache.v8, vq, write_pos)
        _commit_rows(cache.v_scale, vqs, write_pos)
        return logits
    _commit_rows(cache.k, k_news.to(cache.k.dtype), write_pos)
    _commit_rows(cache.v, v_news.to(cache.v.dtype), write_pos)
    return logits


def _commit_rows(buf: torch.Tensor, vals: torch.Tensor, lengths: torch.Tensor) -> None:
    """Write row ``b``'s new K/V at its own position, in place.

    ``buf`` is head-major ``[L, B, NKV, T, ...]``, ``vals`` ``[L, B, NKV,
    ...]``; row ``b`` writes at ``lengths[b]`` on axis 3, and a row parked
    at capacity (``lengths[b] >= T``) is DROPPED — never clamped onto its
    last real position.  PyTorch has no drop mode, so a dropped row
    stores back what its (clamped) target already holds: the buffer is
    unchanged there, and no host sync is needed to find the live rows."""
    b, t = buf.shape[1], buf.shape[3]
    rows = torch.arange(b, device=buf.device)
    keep = lengths < t
    pos = torch.clamp(lengths, max=t - 1).to(torch.int64)
    # Advanced indices at axes 1 and 3 move to the front: [B, L, NKV, ...].
    new = vals.movedim(1, 0).to(buf.dtype)
    old = buf[:, rows, :, pos]
    keep = keep.reshape((b,) + (1,) * (new.dim() - 1))
    buf[:, rows, :, pos] = torch.where(keep, new, old)


def insert_sequence(
    cache: "RaggedKVCache | QuantRaggedKVCache",
    seq: KVCache,
    slot: int,
    length: int,
    mesh=None,
):
    """Install a prefilled single-sequence cache into batch row ``slot``.

    ``seq`` is a batch-1 :class:`KVCache` (k/v ``[L, 1, Tp, NKV, D]``,
    ``Tp <= capacity``) holding ``seq.length`` written positions;
    ``length`` is the sequence's real token count (<= ``seq.length``:
    the rest is prompt padding).  The written prefix is copied into the
    row in place (quantized on the int8 cache).  The reference copies the
    whole ``Tp``; positions past ``seq.length`` hold nothing either way
    and are never attended before decode overwrites them (the decode mask
    is strict), so copying the prefix alone gives the same tokens at a
    fraction of the work on a 4096-position cache.  Returns the cache with
    row ``slot``'s length set.  Under dp > 1 only the rank whose block holds
    ``slot`` writes its K/V; every rank sets the length."""
    slot = int(slot)
    lengths = cache.lengths.clone()
    lengths[slot] = int(length)
    rows = _dp_rows(mesh, lengths.shape[0])
    if rows is not None:
        if not rows.start <= slot < rows.stop:
            return cache._replace(lengths=lengths)
        slot -= rows.start
    tp = min(int(seq.length), seq.k.shape[2])
    # position-major [L, 1, Tp, NKV, D] -> head-major [L, 1, NKV, Tp, D]
    seq_k = seq.k[:, :, :tp].transpose(2, 3)
    seq_v = seq.v[:, :, :tp].transpose(2, 3)
    if isinstance(cache, QuantRaggedKVCache):
        k8, ks = _quant_kv(seq_k)
        v8, vs = _quant_kv(seq_v)
        cache.k8[:, slot:slot + 1, :, :tp] = k8
        cache.k_scale[:, slot:slot + 1, :, :tp] = ks
        cache.v8[:, slot:slot + 1, :, :tp] = v8
        cache.v_scale[:, slot:slot + 1, :, :tp] = vs
        return cache._replace(lengths=lengths)
    cache.k[:, slot:slot + 1, :, :tp] = seq_k.to(cache.k.dtype)
    cache.v[:, slot:slot + 1, :, :tp] = seq_v.to(cache.v.dtype)
    return cache._replace(lengths=lengths)


# ---------------------------------------------------------------------------
# Self-speculative verify (S tokens a slot in one forward)
# ---------------------------------------------------------------------------


def _block_verify_deferred(
    x: torch.Tensor,
    lp: dict,
    cache_k,
    cache_v,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask_bias: torch.Tensor,
    cfg: LlamaConfig,
    window: int,
    counts: torch.Tensor | None = None,
    mesh=None,
):
    """One decoder layer for multi-token ragged verify with the cache
    READ-ONLY: ``x`` is ``[B, S, H]``, row ``i``'s S tokens at positions
    ``lengths[i] .. lengths[i]+S-1``.  Returns ``(y, k_new, v_new, kv8)``
    with the chunk's fresh K/V ``[B, S, NKV, D]`` and, on the int8 cache,
    ``kv8 = (k8, k_scale, v8, v_scale)``: the chunk quantized once, for the
    kernel and for the commit, ``[B, S, NKV, D]`` / ``[B, S, NKV, 1]``
    (None on the dense cache); :func:`verify_ragged` commits every layer
    after the layer loop.

    The attention is the verify chunk instance of the decode kernel (its
    plain version on the CPU): the window under the STRICT mask
    (``mask_bias``, key_pos < lengths[i], no chunk position written yet)
    and the chunk's causal keys in one softmax.  On the int8 cache every
    earlier chunk key and value goes through the quantize round-trip (the
    diagonal stays exact), as it would have through the cache on the
    sequential path, so verify keeps token parity with plain int8kv
    decode.  ``counts`` (int32 ``[B]``, the super-step's live columns a
    row) parks the attention of each row's columns at and past its count:
    their outputs are zeros, which nothing downstream reads."""
    b, s, _ = x.shape
    nh, nkv, hd = _heads(cfg, mesh)
    q, k, v = _qkv(x, lp, cos, sin, cfg, mesh)
    group = nh // nkv
    # Query rows r = j * G + g of each (slot, kv head): [B, NKV, S*G, D].
    rows = q.reshape(b, s, nkv, group, hd).transpose(1, 2).reshape(b, nkv, s * group, hd)
    k_chunk = k.transpose(1, 2)                         # [B, NKV, S, D]
    v_chunk = v.transpose(1, 2)
    if isinstance(cache_k, tuple):
        k8, ks = cache_k
        v8, vs = cache_v
        k8c, ksc = _quant_kv(k_chunk)
        v8c, vsc = _quant_kv(v_chunk)
        ctx4 = verify_attention(
            rows, k8[:, :, :window], ks[:, :, :window], v8[:, :, :window],
            vs[:, :, :window], k_chunk, v_chunk, k8c, ksc, v8c, vsc, mask_bias[:, 0],
            counts,
        )
        kv8 = tuple(t.transpose(1, 2) for t in (k8c, ksc, v8c, vsc))
    else:
        kv8 = None
        ctx4 = verify_attention_dense(
            rows, cache_k[:, :, :window].to(x.dtype), cache_v[:, :, :window].to(x.dtype),
            k_chunk, v_chunk, mask_bias[:, 0], counts,
        )
    ctx = (ctx4.to(x.dtype).reshape(b, nkv, s, group, hd).transpose(1, 2)
           .reshape(b, s, nh * hd))
    x = x + _qmatmul_rows(ctx, lp["o"], mesh).to(x.dtype)
    return _mlp(x, lp, cfg, mesh), k, v, kv8


def verify_ragged(
    params: dict,
    token_ids: torch.Tensor,
    cache: "RaggedKVCache | QuantRaggedKVCache",
    cfg: LlamaConfig,
    dtype=torch.bfloat16,
    window: int | None = None,
    active: torch.Tensor | None = None,
    mesh=None,
):
    """Score S tokens a slot in ONE forward (self-speculative verify).

    ``token_ids`` ``[B, S]``: column 0 is the slot's pending token, columns
    ``1..S-1`` its draft; position ``j`` sits at ``lengths[i] + j``.
    Returns ``(logits [B, S, vocab] f32, cache)`` with every chunk
    position's K/V committed in place but ``lengths`` UNCHANGED: the caller
    advances each row by its accepted count + 1, which is the rollback of
    rejected writes (positions at or past a row's length are never
    attended before they are overwritten).  ``active`` (bool ``[B]``)
    parks inactive rows' writes (:func:`_commit_chunk`).  Under dp > 1 a
    rank runs and commits its block of rows; the logits are gathered."""
    b, s = token_ids.shape
    quant = isinstance(cache, QuantRaggedKVCache)
    rows = _dp_rows(mesh, b)
    lengths = _rows(cache.lengths, rows)
    x = _embed(params, _rows(token_ids, rows), dtype, mesh)
    positions = lengths[:, None] + torch.arange(s, device=lengths.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg)              # [B, S, D]

    capacity = (cache.k8 if quant else cache.k).shape[3]
    window = capacity if window is None else min(int(window), capacity)
    key_pos = torch.arange(window, device=lengths.device)
    # STRICT cache mask shared by every chunk query (no chunk position is
    # written yet); the chunk's own earlier tokens enter through the
    # kernel's in-chunk term.
    valid = key_pos[None, :] < lengths[:, None]           # [B, W]
    mask_bias = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, None]

    k_news, v_news, kv8s = [], [], []
    for l in range(cfg.num_layers):
        if quant:
            ck = (cache.k8[l], cache.k_scale[l])
            cv = (cache.v8[l], cache.v_scale[l])
        else:
            ck, cv = cache.k[l], cache.v[l]
        x, k_new, v_new, kv8 = _block_verify_deferred(
            x, _layer(params["layers"], l), ck, cv, cos, sin, mask_bias, cfg, window=window,
            mesh=mesh,
        )
        k_news.append(k_new)
        v_news.append(v_new)
        kv8s.append(kv8)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _lm_head(params, x, mesh)
    active = _rows(active, rows)
    if quant:
        k8, ks, v8, vs = (torch.stack(t) for t in zip(*kv8s))
        _commit_chunk(cache, (k8, ks), (v8, vs), lengths, quant, active)
    else:
        _commit_chunk(cache, torch.stack(k_news), torch.stack(v_news), lengths, quant, active)
    return _dp_gather(logits, mesh), cache


def _commit_chunk(cache, k_news, v_news, lengths, quant, active=None) -> None:
    """Commit a verify chunk's K/V ``[L, B, S, NKV, D]`` in place: row
    ``b``'s token ``j`` lands at ``lengths[b] + j`` (:func:`_commit_chunk_at`
    on rows ``0 .. B-1``).  ``active`` parks inactive rows at capacity.
    On the int8 cache ``k_news`` and ``v_news`` are the chunk as the cache
    stores it, ``(int8 [L, B, S, NKV, D], f32 scales [L, B, S, NKV, 1])``,
    quantized once by :func:`_block_verify_deferred` as the decode commit
    quantizes."""
    capacity = (cache.k8 if quant else cache.k).shape[3]
    write_base = lengths
    if active is not None:
        write_base = torch.where(active, lengths, torch.full_like(lengths, capacity))
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    _commit_chunk_at(cache, k_news, v_news, rows, write_base, quant)


def _commit_chunk_at(cache, k_news, v_news, slots, offsets, quant, counts=None) -> None:
    """Commit a chunk's K/V ``[L, B, S, NKV, D]`` in place: row ``b``'s
    token ``j`` lands at ``(slots[b], offsets[b] + j)``, one batched
    scatter a buffer.  Positions past capacity are DROPPED, never clamped;
    a parked row (``offsets[b] == capacity``) drops every write, and with
    ``counts`` (int ``[B]``) so does every column ``j >= counts[b]``.
    PyTorch has no drop mode, so a dropped write stores back what its
    target holds: a column parked by ``counts`` inside the cache is aimed
    at its own position, one past capacity ``S`` positions lower, at a
    position of its own cache row below every write it keeps.

    Unique-target contract: the (slot, position) targets must be pairwise
    distinct, which holds when every row's slot differs from every other
    row's, parked rows included (the engine reserves one cache row per
    admission and gives its pad rows slots of their own).  A parked row
    that shared a real row's slot could aim its stored-back values at the
    real row's last ``S`` positions.  ``k_news``/``v_news`` as in
    :func:`_commit_chunk` (int8 pairs on the int8 cache)."""
    s = (k_news[0] if quant else k_news).shape[2]
    capacity = (cache.k8 if quant else cache.k).shape[3]
    if s > capacity:
        raise ValueError(f"chunk of {s} positions exceeds KV capacity {capacity}")
    dev = offsets.device
    rows = slots.to(torch.int64)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    pos = offsets.to(torch.int64)[:, None] + j
    inside = pos < capacity
    keep = inside if counts is None else inside & (j < counts.to(torch.int64)[:, None])
    target = torch.where(inside, pos, pos - s)

    def commit(buf, vals):
        # buf [L, NS, NKV, T, ...], vals [L, B, S, NKV, ...]; the advanced
        # indices at axes 1 and 3 broadcast to [B, S] and move to the front.
        new = vals.movedim((1, 2), (0, 1)).to(buf.dtype)
        old = buf[:, rows, :, target]
        k = keep.reshape(keep.shape + (1,) * (new.dim() - 2))
        buf[:, rows, :, target] = torch.where(k, new, old)

    if quant:
        (kq, kqs), (vq, vqs) = k_news, v_news
        commit(cache.k8, kq)
        commit(cache.k_scale, kqs)
        commit(cache.v8, vq)
        commit(cache.v_scale, vqs)
        return
    commit(cache.k, k_news)
    commit(cache.v, v_news)


# ---------------------------------------------------------------------------
# Packed multi-admission prefill (B_p admissions' chunks in one forward)
# ---------------------------------------------------------------------------


def _block_prefill_ragged(
    x: torch.Tensor,
    lp: dict,
    cache_k,
    cache_v,
    slots: torch.Tensor,
    offsets: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: LlamaConfig,
    mesh=None,
):
    """One decoder layer of a packed prefill with the cache READ-ONLY:
    ``x`` ``[B_p, C, H]``, row ``b``'s chunk at positions ``offsets[b] ..
    offsets[b] + C - 1`` of cache row ``slots[b]``.  Returns ``(y, k_new,
    v_new, kv8)`` as :func:`_block_verify_deferred` does (``kv8``: the
    chunk quantized once, for the kernel and for the commit; None on the
    dense cache).

    The attention is the ragged instance of the flash kernel (its plain
    version on the CPU): the window of cache row ``slots[b]`` under the
    STRICT mask ``key < offsets[b]`` and the chunk's causal keys in one
    softmax, the attention lines of the reference's
    ``_block_verify_deferred`` with a per-row cache-row indirection."""
    b, s, _ = x.shape
    nh, _, hd = _heads(cfg, mesh)
    q, k, v = _qkv(x, lp, cos, sin, cfg, mesh)
    if isinstance(cache_k, tuple):
        k8, ks = cache_k
        v8, vs = cache_v
        kv8 = (*_quant_kv(k), *_quant_kv(v))
        ctx = flash_attention_ragged(q, k8, v8, slots, offsets, k, v, ks, vs, kv8)
    else:
        kv8 = None
        ctx = flash_attention_ragged(q, cache_k, cache_v, slots, offsets, k, v)
    x = x + _qmatmul_rows(ctx.to(x.dtype).reshape(b, s, nh * hd), lp["o"], mesh).to(x.dtype)
    return _mlp(x, lp, cfg, mesh), k, v, kv8


def prefill_chunks_ragged(
    params: dict,
    token_ids: torch.Tensor,
    cache: "RaggedKVCache | QuantRaggedKVCache",
    slots: torch.Tensor,
    offsets: torch.Tensor,
    cfg: LlamaConfig,
    dtype=torch.bfloat16,
    mesh=None,
):
    """Packed multi-admission prefill: one forward for ``B_p`` sequences'
    next prompt chunks under ONE weight stream.

    ``token_ids`` ``[B_p, C]``: row ``b`` is the next uncached chunk of an
    admission whose K/V lives in cache row ``slots[b]`` (int32 ``[B_p]``
    on the cache's device) with ``offsets[b]`` tokens already written
    there; chunk position ``j`` sits at ``offsets[b] + j``.  A row may be
    PARKED with ``offsets[b] == capacity``: it reads no window, its writes
    drop and its logits are ignored (a packed call padded to a power-of-two
    bucket).  ``slots`` must be pairwise distinct (:func:`_commit_chunk_at`).

    Returns ``(logits [B_p, C, vocab] f32, cache)`` with each real row's
    chunk K/V committed in place at ``(slots[b], offsets[b] + j)`` after the
    layer loop and ``lengths`` UNCHANGED: the engine sets a slot's length
    when its last chunk lands.

    Under dp > 1 each packed row belongs to the dp shard that holds its
    cache row: a rank runs only its own rows (the ranks of one tp group
    share a shard, so they run the same rows), and each row's logits reach
    every rank through a dp psum of the owner's rows and zeros elsewhere
    (exact)."""
    rows = _dp_rows(mesh, cache.lengths.shape[0])
    if rows is not None:
        slot_list = slots.tolist()
        own = [i for i, sl in enumerate(slot_list) if rows.start <= sl < rows.stop]
        b, s = token_ids.shape
        logits = torch.zeros((b, s, cfg.vocab_size), dtype=torch.float32,
                             device=token_ids.device)
        if own:
            idx = torch.as_tensor(own, device=token_ids.device)
            part, cache = _prefill_chunks_local(params, token_ids[idx], cache,
                                                slots[idx] - rows.start, offsets[idx], cfg,
                                                dtype, mesh)
            logits[idx] = part
        return psum(logits, mesh.group("dp")), cache
    return _prefill_chunks_local(params, token_ids, cache, slots, offsets, cfg, dtype, mesh)


def _prefill_chunks_local(params, token_ids, cache, slots, offsets, cfg, dtype, mesh):
    """:func:`prefill_chunks_ragged` over this rank's cache rows (``slots``
    index them)."""
    b, s = token_ids.shape
    quant = isinstance(cache, QuantRaggedKVCache)
    x = _embed(params, token_ids, dtype, mesh)
    positions = offsets.to(torch.int64)[:, None] + torch.arange(s, device=offsets.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg)              # [B_p, C, D]

    news = []  # each layer's chunk as the cache stores it
    for l in range(cfg.num_layers):
        if quant:
            ck = (cache.k8[l], cache.k_scale[l])
            cv = (cache.v8[l], cache.v_scale[l])
        else:
            ck, cv = cache.k[l], cache.v[l]
        x, k_new, v_new, kv8 = _block_prefill_ragged(
            x, _layer(params["layers"], l), ck, cv, slots, offsets, cos, sin, cfg, mesh,
        )
        news.append(kv8 if quant else (k_new, v_new))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _lm_head(params, x, mesh)
    stacked = [torch.stack(t) for t in zip(*news)]
    if quant:
        k8, ks, v8, vs = stacked
        _commit_chunk_at(cache, (k8, ks), (v8, vs), slots, offsets, quant)
    else:
        _commit_chunk_at(cache, *stacked, slots, offsets, quant)
    return logits, cache


# ---------------------------------------------------------------------------
# The unified ragged super-step (decode, verify and prefill rows, one forward)
# ---------------------------------------------------------------------------

# Per-row roles of :func:`super_step_ragged`: what each batch row does inside
# ONE dispatch.  IDLE rows park every write.
ROLE_IDLE = 0
ROLE_DECODE = 1
ROLE_VERIFY = 2
ROLE_PREFILL = 3


def _commit_block_at(cache, k_news, v_news, base, counts, quant) -> None:
    """Commit a super-step block's K/V ``[L, B, S, NKV, D]`` in place with
    PER-POSITION parking (the reference's ``_commit_block_at``): row ``b``'s
    column ``j`` lands at ``base[b] + j`` of cache row ``b`` when ``j <
    counts[b]`` and that position is inside the cache, and writes nothing
    otherwise (one super-step row commits 1, draft + 1 or the chunk's
    columns out of the same static-width block).  ``base[b] <= capacity``.
    :func:`_commit_chunk_at` on rows ``0 .. B-1``, whose stored-back
    targets stay distinct from the kept ones."""
    rows = torch.arange(base.shape[0], device=base.device)
    _commit_chunk_at(cache, k_news, v_news, rows, base, quant, counts)


def super_step_ragged(
    params: dict,
    token_block: torch.Tensor,
    cache: "RaggedKVCache | QuantRaggedKVCache",
    cfg: LlamaConfig,
    *,
    roles: torch.Tensor,
    offsets: torch.Tensor,
    counts: torch.Tensor,
    draft_len: torch.Tensor,
    active: torch.Tensor,
    remaining: torch.Tensor,
    eos_ids: torch.Tensor,
    steps: int,
    sample_fn,
    sample_carry=None,
    dtype=torch.bfloat16,
    window: int | None = None,
    mesh=None,
):
    """ONE dispatch advancing a ragged batch of MIXED roles (the
    reference's ``super_step_ragged``): per row a packed-prefill chunk
    commit (``ROLE_PREFILL``), a fused-K decode step with the sampling
    chain (``ROLE_DECODE``), a speculative verify (``ROLE_VERIFY``), or
    nothing (``ROLE_IDLE``).

    ``token_block`` int ``[B, S]``: column 0 is a decode / verify row's
    pending token or a prefill row's first chunk token; verify rows carry
    their draft in columns ``1..draft_len``, prefill rows their chunk in
    ``0..C-1``.  ``offsets`` int32 ``[B]`` is a prefill row's chunk base
    (other roles read their cache length), ``counts`` int32 ``[B]`` the
    leading columns that commit (0 parks the row, :func:`_commit_block_at`)
    and that the verify chunk kernel attends for; ``active`` gates emission
    and the length advance as in the split programs; ``remaining`` /
    ``eos_ids`` are decode rows' budgets and stop tokens.

    The wide forward is :func:`verify_ragged`'s: the strict cache mask
    (``key_pos < base[b]``) and the in-chunk causal term in one softmax
    through :func:`_block_verify_deferred` at ``window``.  Then the commit,
    the greedy argmax and :func:`~.sampling.speculative_accept` for verify
    rows; decode rows draw column 0 under ``decode_multistep``'s latch
    order and run ``steps - 1`` more iterations of :func:`decode_multistep`,
    so a seeded row draws the split programs' stream.  No tensor value is
    read on the host, so the whole call can be captured as one CUDA graph.

    ``window`` must cover a decode row's ``length + steps - 1``, a verify
    row's length and a prefill row's offset (``superstep_window``).

    Returns ``(logits [B, S, vocab] f32, tok_block [B, steps], valid [B],
    greedy [B, S], accepted [B], toks [B, 1], cache, active_out,
    remaining_out, carry_out)``: lengths advance by each decode row's
    emitted count and each active verify row's accepted + 1 (prefill rows
    advance at the engine's finalize).  Under dp > 1 a rank runs and
    commits its block of rows in the wide forward; the logits are gathered
    and the rest runs on every row, replicated."""
    from .sampling import speculative_accept

    b, s = token_block.shape
    quant = isinstance(cache, QuantRaggedKVCache)
    lengths = cache.lengths
    capacity = (cache.k8 if quant else cache.k).shape[3]
    window = capacity if window is None else min(int(window), capacity)
    dev = lengths.device

    is_dec = roles == ROLE_DECODE
    is_ver = roles == ROLE_VERIFY
    # Write and read base a row: a prefill row at its chunk offset (its
    # length stays 0 until finalize), every other role at its length.
    base = torch.where(roles == ROLE_PREFILL, offsets, lengths).to(torch.int32)
    counts = counts.to(torch.int32).contiguous()

    rows = _dp_rows(mesh, b)
    base_l, counts_l = _rows(base, rows), _rows(counts, rows)
    x = _embed(params, _rows(token_block, rows), dtype, mesh)
    positions = base_l.to(torch.int64)[:, None] + torch.arange(s, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg)              # [B, S, D]
    key_pos = torch.arange(window, device=dev)
    valid_mask = key_pos[None, :] < base_l[:, None]      # [B, W], strict
    mask_bias = torch.where(valid_mask, 0.0, -1e9).to(torch.float32)[:, None, None]

    news = []  # each layer's block as the cache stores it
    for l in range(cfg.num_layers):
        if quant:
            ck = (cache.k8[l], cache.k_scale[l])
            cv = (cache.v8[l], cache.v_scale[l])
        else:
            ck, cv = cache.k[l], cache.v[l]
        x, k_new, v_new, kv8 = _block_verify_deferred(
            x, _layer(params["layers"], l), ck, cv, cos, sin, mask_bias, cfg, window=window,
            counts=counts_l, mesh=mesh,
        )
        news.append(kv8 if quant else (k_new, v_new))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _lm_head(params, x, mesh)                   # [B, S, vocab] f32
    stacked = [torch.stack(t) for t in zip(*news)]
    if quant:
        k8, ks, v8, vs = stacked
        _commit_block_at(cache, (k8, ks), (v8, vs), base_l, counts_l, quant)
    else:
        _commit_block_at(cache, *stacked, base_l, counts_l, quant)
    logits = _dp_gather(logits, mesh)

    # Verify rows: exact greedy acceptance over the wide logits (columns
    # past draft_len are capped out by the per-row budget).
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, S]
    accepted, nxt_v = speculative_accept(token_block, greedy, draft_len)
    ver_act = is_ver & active
    accepted = torch.where(ver_act, accepted, torch.zeros_like(accepted))

    # Decode rows' step 1 of K: column 0 under decode_multistep's rule and
    # latch order (every row's key advances on a sampling tick).
    act_dec = active & is_dec
    carry, sampled = sample_fn(logits[:, 0, :], sample_carry)
    nxt_d = torch.where(act_dec, sampled.to(token_block.dtype), token_block[:, 0])
    valid0 = act_dec.to(torch.int32)
    remaining1 = remaining - valid0
    act1 = act_dec & (nxt_d != eos_ids) & (remaining1 > 0)

    lengths1 = lengths + valid0 + torch.where(ver_act, accepted + 1, torch.zeros_like(accepted))
    cache = cache._replace(lengths=lengths1.to(lengths.dtype))

    toks1 = torch.where(ver_act, nxt_v.to(token_block.dtype), nxt_d)[:, None]
    if steps > 1:
        tok_rest, valid_rest, toks2, cache, act2, rem2, carry = decode_multistep(
            params, toks1, cache, cfg, act1, remaining1, eos_ids, steps - 1, sample_fn,
            sample_carry=carry, dtype=dtype, window=window, mesh=mesh,
        )
        tok_block_out = torch.cat([nxt_d[:, None], tok_rest], dim=1)
        valid = valid0 + valid_rest
    else:
        tok_block_out = nxt_d[:, None]
        valid = valid0
        toks2, act2, rem2 = toks1, act1, remaining1
    return (logits, tok_block_out, valid, greedy, accepted, toks2, cache, act2, rem2, carry)
