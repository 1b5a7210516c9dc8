"""Logical-axis sharding rules (port of the JAX package's
``parallel/sharding.py``).

Model code names array axes logically (``"batch"``, ``"heads"``,
``"mlp"`` ...); a :class:`ShardingRules` table maps each to a mesh axis (or
to ``None``, replicated).  A :class:`PartitionSpec` is the reference's: one
entry an array axis, a mesh axis name (or a tuple of them) or ``None``.
Where XLA places a sharded array on the devices of a mesh, a rank here
holds its own block: :func:`shard_pytree` cuts a full tree into this
rank's contiguous block along every sharded axis.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from .mesh import AXIS_DATA, AXIS_SEQ, AXIS_TENSOR

LOGICAL_BATCH = "batch"
LOGICAL_SEQ = "seq"
LOGICAL_EMBED = "embed"  # model/residual dimension
LOGICAL_HEADS = "heads"  # attention heads (query)
LOGICAL_KV_HEADS = "kv_heads"  # attention heads (key/value, GQA)
LOGICAL_HEAD_DIM = "head_dim"
LOGICAL_MLP = "mlp"  # feed-forward hidden dimension
LOGICAL_VOCAB = "vocab"
LOGICAL_EXPERT = "expert"


class PartitionSpec(tuple):
    """One entry an array axis: a mesh axis name, a tuple of names, or
    ``None`` (replicated along that axis).  ``PartitionSpec()`` replicates
    the whole array, whatever its rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis -> mesh axis (or None for replicated)."""

    rules: Mapping[str, str | None]

    def mesh_axis(self, logical: str | None) -> str | None:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, logical_axes: tuple[str | None, ...]) -> PartitionSpec:
        seen: list[str | None] = []
        for ax in logical_axes:
            mesh_ax = self.mesh_axis(ax)
            # A mesh axis may appear at most once in a PartitionSpec; later
            # occurrences fall back to replication.
            seen.append(mesh_ax if mesh_ax not in [s for s in seen if s] else None)
        return PartitionSpec(*seen)


# Default rules for transformer serving: batch over dp, sequence over sp,
# heads/mlp/vocab over tp (Megatron column/row splits), embed replicated.
TRANSFORMER_RULES = ShardingRules(
    rules={
        LOGICAL_BATCH: AXIS_DATA,
        LOGICAL_SEQ: AXIS_SEQ,
        LOGICAL_EMBED: None,
        LOGICAL_HEADS: AXIS_TENSOR,
        LOGICAL_KV_HEADS: AXIS_TENSOR,
        LOGICAL_HEAD_DIM: None,
        LOGICAL_MLP: AXIS_TENSOR,
        LOGICAL_VOCAB: AXIS_TENSOR,
        LOGICAL_EXPERT: None,
    }
)


def logical_spec(
    logical_axes: tuple[str | None, ...], rules: ShardingRules | None = None
) -> PartitionSpec:
    return (rules or TRANSFORMER_RULES).spec(logical_axes)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what :func:`shard_shape` of a full shape is."""

    mesh: Any  # ServingMesh
    spec: PartitionSpec

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh.shape)


def logical_sharding(mesh, logical_axes: tuple[str | None, ...],
                     rules: ShardingRules | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(logical_axes, rules))


class PartitionRuleError(ValueError):
    """A rule produced a PartitionSpec whose rank does not match the leaf it
    matched: raised at match time, naming the path, the rule and both
    ranks, before any leaf is cut."""


def _walk(tree: Any, fn, path: tuple = ()):
    """Map ``fn(path, leaf)`` over a tree of dicts, lists and tuples (a
    NamedTuple keeps its type)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        out = [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(path, tree)


def match_partition_rules(rules: Sequence[tuple[str, PartitionSpec]], tree: Any) -> Any:
    """Regex rule table -> PartitionSpec tree.

    Each leaf's path (``/``-joined dict keys and sequence indices) is
    matched with ``re.search`` against the rules IN ORDER: the first match
    wins.  A leaf no rule matches is replicated (``PartitionSpec()``), and
    so is every scalar.  A matched non-empty spec whose rank differs from
    the leaf's raises :class:`PartitionRuleError`."""
    compiled = [(re.compile(pat), pat, spec) for pat, spec in rules]

    def match(path, leaf):
        name = "/".join(path)
        ndim = getattr(leaf, "ndim", 0)
        if ndim == 0:
            return PartitionSpec()
        for creg, pat, spec in compiled:
            if creg.search(name) is None:
                continue
            if len(spec) != 0 and len(spec) != ndim:
                raise PartitionRuleError(
                    f"partition rule {pat!r} produced rank-{len(spec)} "
                    f"spec {spec} for rank-{ndim} leaf {name!r}"
                )
            return spec
        return PartitionSpec()

    return _walk(tree, match)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def shard_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh_shape: Mapping[str, int]) -> tuple[int, ...]:
    """The block one rank holds of an array of ``shape`` under ``spec``
    (mesh axes the mesh does not carry replicate)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(int(mesh_shape.get(a, 1)) for a in _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"axis {d} of size {out[d]} does not split into {n} shards")
        out[d] //= n
    return tuple(out)


def _block(x, spec: PartitionSpec, mesh):
    """This rank's contiguous block of ``x`` under ``spec`` (``x`` itself
    where no axis is cut)."""
    cut = False
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = math.prod(mesh.size(a) for a in axes)
        if n == 1:
            continue
        idx = 0
        for a in axes:  # row-major over the entry's axes
            idx = idx * mesh.size(a) + mesh.index(a)
        size = x.shape[d]
        if size % n:
            raise ValueError(f"axis {d} of size {size} does not split into {n} shards")
        w = size // n
        sl = [slice(None)] * x.ndim
        sl[d] = slice(idx * w, (idx + 1) * w)
        x = x[tuple(sl)]
        cut = True
    if not cut:
        return x
    if hasattr(x, "contiguous"):
        return x.contiguous().clone()  # the full leaf can be freed
    import numpy as np

    return np.ascontiguousarray(x)


def shard_pytree(tree: Any, specs: Any, mesh, rules: ShardingRules | None = None) -> Any:
    """This rank's block of every leaf of a full ``tree`` (numpy or torch).

    ``specs`` mirrors ``tree`` with a :class:`PartitionSpec` a leaf, a tuple
    of logical axis names (mapped through ``rules``) or ``None``
    (replicated)."""

    def cut(path, leaf):
        spec = _lookup(specs, path)
        if spec is None:
            return leaf
        if not isinstance(spec, PartitionSpec):
            spec = logical_spec(tuple(spec), rules)
        return _block(leaf, spec, mesh)

    return _walk(tree, cut)


def _lookup(specs: Any, path: tuple):
    node = specs
    for key in path:
        if node is None or isinstance(node, PartitionSpec):
            return node
        node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
    return node
