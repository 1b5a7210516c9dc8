"""The serving mesh from the CRD's ``meshShape`` field (port of the JAX
package's ``parallel/mesh.py``).

A ``meshShape`` like ``{"dp": 2, "tp": 2}`` names a world of
``prod(meshShape)`` ranks, one process each.  Axis names are the
reference's:

- ``dp`` -- data parallel (cache rows split; replicated weights)
- ``tp`` -- tensor parallel (heads/mlp/vocab split; activations summed)
- ``sp`` -- sequence parallel (the ring-attention prefill, ``ops/ring_attention.py``)
- ``pp`` -- pipeline parallel, ``ep`` -- expert parallel

Ranks are laid out in ``MESH_AXIS_ORDER``, outer to inner, so ``tp`` --
which carries the per-layer all-reduces -- is innermost: ``rank = dp_index
* tp + tp_index`` on a ``{dp, tp}`` mesh, and a host's consecutive ranks
share a tp group.  Where the reference's ``Mesh`` holds devices, a
:class:`ServingMesh` holds this rank's coordinates and one process group an
axis of size > 1 (``torch.distributed.new_group``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping

AXIS_DATA = "dp"
AXIS_PIPE = "pp"
AXIS_EXPERT = "ep"
AXIS_SEQ = "sp"
AXIS_TENSOR = "tp"

# Outer-to-inner canonical order: collectives-heavy axes innermost.
MESH_AXIS_ORDER: tuple[str, ...] = (
    AXIS_DATA,
    AXIS_PIPE,
    AXIS_EXPERT,
    AXIS_SEQ,
    AXIS_TENSOR,
)


@dataclass(eq=False)
class ServingMesh:
    """This rank's place on the mesh: the axis sizes (in ``MESH_AXIS_ORDER``,
    size-1 axes kept), its coordinates, and the process group of each axis
    of size > 1 (``None`` in a world of one rank, where every collective is
    the identity)."""

    shape: dict[str, int]
    rank: int
    coords: dict[str, int]
    groups: dict[str, object] = field(default_factory=dict)

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def group(self, axis: str):
        """The process group of ``axis`` (None when the axis has size 1)."""
        return self.groups.get(axis)

    @property
    def tp(self) -> int:
        return self.size(AXIS_TENSOR)

    @property
    def dp(self) -> int:
        return self.size(AXIS_DATA)

    @property
    def sp(self) -> int:
        return self.size(AXIS_SEQ)


def _axis_groups(axis_names, sizes, axis: str) -> list[list[int]]:
    """Every set of ranks that differ only along ``axis`` (row-major rank
    layout over ``axis_names``), in rank order."""
    k = axis_names.index(axis)
    stride = math.prod(sizes[k + 1:])
    total = math.prod(sizes)
    out = []
    for r in range(total):
        if (r // stride) % sizes[k] == 0:
            out.append([r + i * stride for i in range(sizes[k])])
    return out


def build_mesh(mesh_shape: Mapping[str, int], rank: int | None = None,
               world: int | None = None) -> ServingMesh:
    """Build this rank's :class:`ServingMesh` from ``{axis: size}``.

    Axes are laid out in ``MESH_AXIS_ORDER`` whatever the dict's order.
    ``rank``/``world`` default to the initialized process group's (one rank
    when none is); the product of the sizes must equal ``world``.  Every
    rank must call this in the same order: each axis's groups are made with
    ``torch.distributed.new_group``, which all ranks enter for every group."""
    place = placement(mesh_shape, rank, world)
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    axis_names, sizes = tuple(place.shape), tuple(place.shape.values())
    rank, total = place.rank, place.world
    groups: dict[str, object] = {}
    if total > 1:
        if not live:
            raise RuntimeError(
                f"meshShape {dict(mesh_shape)} spans {total} ranks: initialize "
                "torch.distributed first (parallel.maybe_initialize_distributed)"
            )
        for a, n in zip(axis_names, sizes):
            if n == 1:
                continue
            for ranks in _axis_groups(axis_names, sizes, a):
                g = dist.new_group(ranks)
                if int(rank) in ranks:
                    groups[a] = g
    place.groups = groups
    return place


def placement(mesh_shape: Mapping[str, int], rank: int | None = None,
              world: int | None = None) -> ServingMesh:
    """This rank's :class:`ServingMesh` without process groups: the axis
    sizes in ``MESH_AXIS_ORDER`` and its coordinates (what a rank's block
    of a leaf depends on).  ``rank``/``world`` default to the initialized
    process group's; the sizes must multiply to ``world``."""
    unknown = set(mesh_shape) - set(MESH_AXIS_ORDER)
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)}; known: {list(MESH_AXIS_ORDER)}"
        )
    axis_names = tuple(a for a in MESH_AXIS_ORDER if a in mesh_shape)
    sizes = tuple(int(mesh_shape[a]) for a in axis_names)
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {dict(mesh_shape)}")
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    total = math.prod(sizes) if sizes else 1
    if total != int(world):
        raise ValueError(
            f"meshShape {dict(mesh_shape)} needs {total} devices, have {int(world)}"
        )
    coords, rest = {}, int(rank)
    for a, n in zip(reversed(axis_names), reversed(sizes)):
        coords[a] = rest % n
        rest //= n
    coords = {a: coords[a] for a in axis_names}
    return ServingMesh(shape=dict(zip(axis_names, sizes)), rank=int(rank), coords=coords)


def local_mesh(mesh_shape: Mapping[str, int] | None = None) -> ServingMesh:
    """The mesh over every rank of the process group (one ``tp`` axis
    spanning them by default)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if mesh_shape is None:
        mesh_shape = {AXIS_TENSOR: world}
    return build_mesh(mesh_shape, world=world)
