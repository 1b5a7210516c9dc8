"""Ring attention: exact attention over a sequence split on the ``sp`` mesh
axis (port of the JAX package's ``ops/ring_attention.py``).

Each rank keeps its shard of the queries and passes K/V shards around the
ring of its ``sp`` process group (``parallel.collectives.ring_shift``: rank
``i`` receives rank ``i - 1``'s block), so after ``t`` shifts a rank holds
the block that started on rank ``(r - t) mod n``.  The ``n`` blocks merge
into one softmax, so the full ``S x S`` score matrix exists nowhere.

On the card each block goes through the flash kernel
(``ops/flash_attention.py``, ``return_lse=True``): causal only for the
block that started on this rank (its diagonal), grouped K/V heads read in
place.  The partial outputs merge into a running ``(out, lse)`` by their
log-sum-exp weights, in f32, with elementwise torch ops (in the reference
the merge is XLA, not a Pallas kernel).  Under ``causal`` a block that
started on a later rank lies wholly above the diagonal: it is skipped,
though still passed on.  The reference masks such a block to ``NEG_INF``;
step 0 is always the diagonal, so the running max is finite and that block
adds exactly 0.

The plain version (:func:`ring_attention_reference`, used for CPU tensors)
is the reference's blockwise online softmax in einsums, accumulating in
``promote_types(dtype, float32)`` (f64 for f64 inputs), every block
visited.  Both move K/V with ``ring_shift``, which over gloo stages a CUDA
tensor through the host (``parallel/collectives.py``).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather_concat, axis_index, ring_shift
from .flash_attention import flash_attention

NEG_INF = -1e30


def _ring_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"ring attention: q {tuple(q.shape)} must be [B, H, S, D] and "
                         f"k, v {tuple(k.shape)}, {tuple(v.shape)} [B, NKV, S, D]")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"ring attention: shards disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (K/V heads must divide the query heads)")


def ring_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                             causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """The reference's ring in einsums: local shards ``q [B, H, S/n, D]``,
    ``k, v [B, NKV, S/n, D]``; returns this rank's ``[B, H, S/n, D]`` in
    q's type."""
    _check(q, k, v)
    n, r = _ring_size(group), axis_index(group)
    b, h, chunk, d = q.shape
    nkv = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    acc_dtype = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc_dtype).unflatten(1, (nkv, h // nkv)) * scale  # [B, NKV, G, S, D]
    acc = torch.zeros(qf.shape, dtype=acc_dtype, device=q.device)
    m = torch.full(qf.shape[:-1] + (1,), NEG_INF, dtype=acc_dtype, device=q.device)
    l = torch.zeros_like(m)
    pos = torch.arange(chunk, device=q.device)
    kv = torch.stack((k, v))
    for t in range(n):
        origin = (r - t) % n
        kk, vv = kv[0].to(acc_dtype), kv[1].to(acc_dtype)
        s = torch.einsum("bngqd,bnkd->bngqk", qf, kk)
        if causal:
            visible = (origin * chunk + pos)[None, :] <= (r * chunk + pos)[:, None]
            s = torch.where(visible, s, torch.tensor(NEG_INF, dtype=acc_dtype, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bngqk,bnkd->bngqd", p, vv)
        m = m_new
        if t < n - 1:
            kv = ring_shift(kv, group)
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(b, h, chunk, d).to(q.dtype)


def ring_attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                         causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """The ring through the flash kernel with its log-sum-exp (the plain
    flash on CPU tensors): one flash call a visible block, merged by
    ``lse`` in f32 (f64 for f64 inputs).  Same shapes as
    :func:`ring_attention_reference`."""
    _check(q, k, v)
    n, r = _ring_size(group), axis_index(group)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    acc_dtype = torch.promote_types(q.dtype, torch.float32)
    out = lse = None
    kv = torch.stack((k, v))
    for t in range(n):
        origin = (r - t) % n
        if not (causal and origin > r):
            o_t, l_t = flash_attention(q, kv[0], kv[1], causal=causal and origin == r,
                                       scale=scale, return_lse=True)
            o_t, l_t = o_t.to(acc_dtype), l_t.to(acc_dtype)
            if out is None:  # step 0: this rank's own block
                out, lse = o_t, l_t
            else:
                new = torch.logaddexp(lse, l_t)
                out = (out * torch.exp(lse - new)[..., None]
                       + o_t * torch.exp(l_t - new)[..., None])
                lse = new
        if t < n - 1:
            kv = ring_shift(kv, group)
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """Exact attention over a sequence split on ``group`` (the mesh's sp
    process group, ``ServingMesh.group("sp")``; None is a ring of one).
    ``q [B, H, S/n, D]`` and ``k, v [B, NKV, S/n, D]`` are this rank's
    shards, rank ``i`` holding positions ``[i S/n, (i + 1) S/n)``.  A CPU
    tensor takes the plain version; a CUDA tensor runs the flash kernel a
    block (it raises rather than fall back)."""
    if q.device.type == "cpu":
        return ring_attention_reference(q, k, v, group, causal, scale)
    return ring_attention_flash(q, k, v, group, causal, scale)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           causal: bool = False, axis_name: str = "sp", fn=None) -> torch.Tensor:
    """The reference's convenience signature, for tests: global ``[B, H, S,
    D]`` tensors (the same on every rank of ``mesh``, a
    ``parallel.ServingMesh``) cut into this rank's sequence shard, the
    ring run (``fn``, :func:`ring_attention` by default), and every
    rank's output gathered back along the sequence."""
    n, r = mesh.size(axis_name), mesh.index(axis_name)
    if q.shape[2] % n:
        raise ValueError(f"ring attention: sequence {q.shape[2]} does not split into {n}")
    c = q.shape[2] // n
    part = slice(r * c, (r + 1) * c)
    group = mesh.group(axis_name)
    out = (fn or ring_attention)(q[:, :, part], k[:, :, part], v[:, :, part], group, causal)
    return all_gather_concat(out.contiguous(), group, axis=2)
