"""Collective helpers over process groups (port of the JAX package's
``parallel/collectives.py``).

Where the reference names a mesh axis inside ``shard_map``, these take the
axis's process group (``ServingMesh.group(axis)``); ``None`` is an axis of
size 1, on which every helper is the identity.  Each helper is functional:
it returns a new tensor and leaves its input alone.

- ``psum``, ``pmax``, ``pmean``, ``all_gather_concat``, ``reduce_scatter``,
  ``axis_index`` -- the named primitives;
- :func:`ring_shift` (point-to-point, ``batch_isend_irecv``) and
  :func:`ring_shift_bidirectional`;
- :func:`hierarchical_psum` -- reduce-scatter on the fast axis, psum of
  the shard on the slow one, all-gather on the fast one;
- :func:`all_to_all_swap` -- the sequence-parallel pivot.

Ranks that share one card use gloo (``parallel/distributed.py``), and
ProcessGroupGloo runs some collectives on host tensors only.
``scripts/gloo_probe.py`` on an NVIDIA H100 80GB HBM3 (700 W, torch 2.11,
CUDA 12.8) ran all_reduce, broadcast, all_gather, all_gather_into_tensor,
reduce_scatter_tensor and all_to_all_single on CUDA tensors in worlds of
2 and 4 ranks on one card, and point-to-point send/recv hung there (the
ranks aborted).  So :func:`ring_shift`'s P2P over gloo copies a CUDA
tensor to the host, runs there and copies the result back: explicit,
here, never a silent fallback elsewhere.

Semantics are pinned by ``tests/test_torch_parallel.py`` against numpy in
gloo worlds of 2 and 4 processes.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

# This process's calls and host seconds of each collective (a rank's
# measured collective walls, beside the analytic ones of
# ``server/device_telemetry.py``); an axis of size 1 counts nothing.
calls: dict[str, int] = {}
seconds: dict[str, float] = {}


@contextlib.contextmanager
def _timed(op: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        calls[op] = calls.get(op, 0) + 1
        seconds[op] = seconds.get(op, 0.0) + time.perf_counter() - t0


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks."""
    if _size(group) == 1:
        return x
    out = x.clone()
    with _timed("all_reduce"):
        dist.all_reduce(out, group=group)
    return out


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group's ranks."""
    if _size(group) == 1:
        return x
    out = x.clone()
    with _timed("all_reduce_max"):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / _size(group)


def all_gather_concat(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """All-gather the ranks' shards and concatenate along ``axis`` in rank
    order (the reference's ``tiled=True``)."""
    n = _size(group)
    if n == 1:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    with _timed("all_gather"):
        dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=axis)


def reduce_scatter(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Sum across the group and keep this rank's block of ``axis`` (the
    memory-lean half of an all-reduce)."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not split into {n}")
    src = x.movedim(axis, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with _timed("reduce_scatter"):
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, axis)


def axis_index(group) -> int:
    """This rank's index along the group's axis."""
    return 0 if group is None else dist.get_rank(group)


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Shift ``x`` around the group's ring by ``shift`` hops: rank ``i``
    receives the block of rank ``(i - shift) % n``."""
    n = _size(group)
    if n == 1 or shift % n == 0:
        return x
    i = dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src_rank = dist.get_global_rank(group, (i - shift) % n)
    src = x.contiguous()
    # Gloo's send/recv of CUDA tensors hung on the card (scripts/gloo_probe.py):
    # stage through the host.
    stage = src.is_cuda and dist.get_backend(group) == "gloo"
    if stage:
        src = src.cpu()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dst, group=group),
           dist.P2POp(dist.irecv, out, src_rank, group=group)]
    with _timed("ring_shift"):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if stage else out


def ring_shift_bidirectional(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """One ring step with both halves moving at once: the front half of
    ``x`` along ``axis`` from the left neighbour, the back half from the
    right one."""
    n = x.shape[axis]
    if n % 2:
        raise ValueError(f"axis {axis} of size {n} cannot split into halves")
    fwd, bwd = torch.chunk(x, 2, dim=axis)
    return torch.cat([ring_shift(fwd, group, 1), ring_shift(bwd, group, -1)], dim=axis)


def hierarchical_psum(x: torch.Tensor, fast_group, slow_group,
                      scatter_axis: int = 0) -> torch.Tensor:
    """All-reduce over two axes crossing the slow links once a byte:
    reduce-scatter over ``fast_group``, psum of the shard over
    ``slow_group``, all-gather over ``fast_group``.  Equal to the flat psum
    up to the order of the float sums."""
    shard = reduce_scatter(x, fast_group, axis=scatter_axis)
    shard = psum(shard, slow_group)
    return all_gather_concat(shard, fast_group, axis=scatter_axis)


def all_to_all_swap(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Move the sharded dimension: ``x`` splits into n blocks along
    ``split_axis``, block ``j`` goes to rank ``j``, and the blocks a rank
    receives concatenate along ``concat_axis`` in rank order (the
    reference's tiled ``all_to_all``)."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(
            f"axis {split_axis} of size {x.shape[split_axis]} does not split into {n}"
        )
    src = torch.stack(torch.chunk(x, n, dim=split_axis)).contiguous()
    out = torch.empty_like(src)
    with _timed("all_to_all"):
        dist.all_to_all_single(out, src, group=group)
    return torch.cat(list(out.unbind(0)), dim=concat_axis)
