"""Tensor- and data-parallel partition rules for the Llama serving stack
(port of the JAX package's ``models/partition.py``), and BERT's rule table
(the reference's ``bert.param_logical_axes`` through ``TRANSFORMER_RULES``).

One rule table (regex path -> :class:`~..parallel.sharding.PartitionSpec`)
maps the Llama parameter tree onto a ``{"dp": D, "tp": T}`` mesh, the
Megatron split: q/k/v/gate/up shard their OUTPUT axis, o/down their INPUT
axis, the embedding its vocab rows and ``lm_head`` its vocab columns; norms
replicate.  The int8 layout's ``q8`` planes shard like the matrices they
quantize; ``scale`` planes shard on their output axis only (o/down scales
replicate and factor out of the partial sums).

The engine's device state outside the tree: the ragged cache
``[L, B, NKV, T, D]`` shards its heads over tp and, under dp > 1, its rows
over dp (each dp shard holds B/dp rows), the int8kv scale planes alike; the
per-sequence prefill scratch ``[L, B, T, NKV, D]`` shards heads only; the
sampling state (tokens, keys, temperatures, top-k/top-p, lengths) is
replicated, so the host truth of every slot is the same on every rank.

Where XLA inserts the collectives in the reference, ``models/llama.py``
makes them explicit: a tp ``psum`` after the o and down projections and
the embedding, an all-gather of the vocab-split logits, and over dp an
all-gather of the rows' logits.

BERT (``BERT_PARTITION_RULES``): q, k, v and up split their output axis
and their bias, o and down their input axis (bias replicated), the word
embedding its vocab rows; the position and token-type embeddings, every
LayerNorm, the pooler and the classifier replicate.  int8 leaves: ``q8``
shards like its matrix, a column-split matrix's ``scale`` on its output
axis, o's and down's ``scale`` replicate.  ``models/bert.py`` makes the
collectives explicit.  Every other flavor (ResNet, the tabular, linear,
xgboost and pyfunc tiers) replicates whole, as the reference's
``resnet.param_logical_axes`` and its loader's ``else`` branch do.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

from ..parallel import AXIS_DATA, AXIS_SEQ, AXIS_TENSOR, match_partition_rules, shard_pytree
from ..parallel.sharding import PartitionSpec, logical_spec, shard_shape

P = PartitionSpec
TP = AXIS_TENSOR
DP = AXIS_DATA
SP = AXIS_SEQ

# Regex path -> PartitionSpec, first match wins (the quantized rules sit
# above the bare-matrix rules they would otherwise shadow).  Matched by
# re.search against "/"-joined tree paths, e.g. "layers/q/q8".
LLAMA_PARTITION_RULES: tuple[tuple[str, PartitionSpec], ...] = (
    (r"layers/(q|k|v|gate|up)/q8$", P(None, None, TP)),
    (r"layers/(q|k|v|gate|up)/scale$", P(None, None, TP)),
    (r"layers/(o|down)/q8$", P(None, TP, None)),
    (r"layers/(o|down)/scale$", P()),
    (r"lm_head/q8$", P(None, TP)),
    (r"lm_head/scale$", P(None, TP)),
    (r"layers/(q|k|v|gate|up)$", P(None, None, TP)),
    (r"layers/(o|down)$", P(None, TP, None)),
    (r"embed$", P(TP, None)),
    (r"lm_head$", P(None, TP)),
    (r"(attn_norm|mlp_norm|final_norm)$", P()),
)

# BERT: ``bert.param_logical_axes`` of the reference, each leaf's logical
# axes mapped through ``TRANSFORMER_RULES`` (heads, mlp and vocab on tp,
# embed replicated).  Matched against "/"-joined paths such as
# "layers/0/attn/q/w" (or "layers/#0/attn/q/w/q8", a flattened key); a leaf
# no rule names replicates.
_BERT_COLUMN = r"(attn/(q|k|v)|mlp/up)"
_BERT_ROW = r"(attn/o|mlp/down)"
BERT_PARTITION_RULES: tuple[tuple[str, PartitionSpec], ...] = (
    (_BERT_COLUMN + r"/w/q8$", logical_spec(("embed", "heads"))),
    (_BERT_COLUMN + r"/w/scale$", logical_spec((None, "heads"))),
    (_BERT_ROW + r"/w/q8$", logical_spec(("heads", "embed"))),
    (_BERT_ROW + r"/w/scale$", P()),
    (r"attn/(q|k|v)/w$", logical_spec(("embed", "heads"))),
    (r"mlp/up/w$", logical_spec(("embed", "mlp"))),
    (_BERT_COLUMN + r"/b$", logical_spec(("heads",))),
    (r"attn/o/w$", logical_spec(("heads", "embed"))),
    (r"mlp/down/w$", logical_spec(("mlp", "embed"))),
    (r"embeddings/word$", logical_spec(("vocab", "embed"))),
)

RAGGED_KV_SPEC = P(None, None, TP, None, None)
RAGGED_KV_SPEC_DP = P(None, DP, TP, None, None)
SEQ_KV_SPEC = P(None, None, None, TP, None)
REPLICATED = P()


def ragged_kv_spec(dp: int) -> PartitionSpec:
    """Heads on tp always; the row axis on dp only when dp > 1."""
    return RAGGED_KV_SPEC_DP if int(dp) > 1 else RAGGED_KV_SPEC


def tp_degree(mesh_shape: Mapping[str, int] | None) -> int:
    """The ``tp`` axis size of a meshShape (1 when absent/empty)."""
    if not mesh_shape:
        return 1
    return int(mesh_shape.get(AXIS_TENSOR, 1))


def dp_degree(mesh_shape: Mapping[str, int] | None) -> int:
    """The ``dp`` axis size of a meshShape (1 when absent/empty)."""
    if not mesh_shape:
        return 1
    return int(mesh_shape.get(AXIS_DATA, 1))


def sp_degree(mesh_shape: Mapping[str, int] | None) -> int:
    """The ``sp`` axis size of a meshShape (1 when absent/empty)."""
    if not mesh_shape:
        return 1
    return int(mesh_shape.get(AXIS_SEQ, 1))


def mesh_device_count(mesh_shape: Mapping[str, int] | None) -> int:
    n = 1
    for v in (mesh_shape or {}).values():
        n *= int(v)
    return n


def validate_mesh_for_model(
    mesh_shape: Mapping[str, int] | None,
    *,
    num_kv_heads: int | None = None,
    num_heads: int | None = None,
    intermediate_size: int | None = None,
    vocab_size: int | None = None,
    cache_rows: int | None = None,
    prefill_chunk: int | None = None,
    chip_count: int | None = None,
) -> None:
    """Reject a ``meshShape`` the model/serving geometry cannot shard,
    typed, naming the knob and the count (a copy of the JAX package's
    ``utils/config.validate_mesh_for_model``, messages and all)."""
    mesh = dict(mesh_shape or {})
    tp = int(mesh.get("tp", 1))
    dp = int(mesh.get("dp", 1))
    sp = int(mesh.get("sp", 1))
    if chip_count is not None:
        total = 1
        for v in mesh.values():
            total *= int(v)
        if total > int(chip_count):
            raise ValueError(
                f"spec.tpu.meshShape {mesh} uses {total} devices but the "
                f"topology provides only {int(chip_count)} chips; "
                "dp*pp*ep*sp*tp must not exceed the slice or the pod is "
                "unschedulable"
            )
    if dp > 1 and cache_rows is not None and int(cache_rows) % dp != 0:
        raise ValueError(
            f"spec.tpu.meshShape dp={dp} does not divide the KV-cache "
            f"row count (maxSlots) = {int(cache_rows)}; each dp shard "
            "owns rows/dp cache rows — pick a maxSlots that dp divides "
            "(or dp: 1)"
        )
    if sp > 1 and prefill_chunk is not None and int(prefill_chunk) % sp != 0:
        raise ValueError(
            f"spec.tpu.meshShape sp={sp} does not divide the prefill "
            f"chunk size (prefillChunk) = {int(prefill_chunk)}; ring "
            "attention splits the sequence axis into sp equal shards — "
            "pick a chunk that sp divides (or sp: 1)"
        )
    if tp <= 1:
        return
    checks = (
        ("KV-head count (num_kv_heads)", num_kv_heads),
        ("attention-head count (num_heads)", num_heads),
        ("MLP width (intermediate_size)", intermediate_size),
        ("vocab size (vocab_size)", vocab_size),
    )
    for label, count in checks:
        if count is None:
            continue
        if int(count) % tp != 0:
            raise ValueError(
                f"spec.tpu.meshShape tp={tp} does not divide the model's "
                f"{label} = {int(count)}; pick a tp that divides it (or "
                "tp: 1) — an indivisible axis cannot shard and would "
                "fail as an XLA shape error at first dispatch"
            )


def validate_llama_mesh(cfg, mesh_shape: Mapping[str, int] | None) -> None:
    """Reject a meshShape the Llama geometry cannot shard, typed, before
    any weight is cut or any device state allocated."""
    validate_mesh_for_model(
        mesh_shape,
        num_kv_heads=cfg.num_kv_heads,
        num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        vocab_size=cfg.vocab_size,
    )


def validate_bert_mesh(cfg, mesh_shape: Mapping[str, int] | None) -> None:
    """Reject a meshShape the BERT geometry cannot shard (heads, MLP width,
    vocab rows), typed, before any weight is read.  BERT-base's vocab of
    30522 refuses tp 4: the reference's ``device_put`` would fail on that
    shape."""
    validate_mesh_for_model(
        mesh_shape,
        num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        vocab_size=cfg.vocab_size,
    )


def bert_param_specs(params: Any) -> Any:
    """PartitionSpec tree for a BERT parameter tree (float or int8)."""
    return match_partition_rules(BERT_PARTITION_RULES, params)


def shard_bert_params(params: Any, mesh) -> Any:
    """This rank's block of a full BERT parameter tree (numpy or torch)."""
    return shard_pytree(params, bert_param_specs(params), mesh)


# Flavor -> its rule table; a flavor not named here replicates every leaf.
FLAVOR_RULES: dict[str, tuple[tuple[str, PartitionSpec], ...]] = {
    "llama-generate": LLAMA_PARTITION_RULES,
    "bert-classifier": BERT_PARTITION_RULES,
}


def flavor_rules(flavor: str) -> tuple[tuple[str, PartitionSpec], ...]:
    """The rule table of ``flavor`` (empty: every leaf ``P()``)."""
    return FLAVOR_RULES.get(flavor, ())


def llama_param_specs(params: Any) -> Any:
    """PartitionSpec tree for a Llama parameter tree (float or int8)."""
    return match_partition_rules(LLAMA_PARTITION_RULES, params)


def shard_llama_params(params: Any, mesh) -> Any:
    """This rank's block of a full Llama parameter tree (numpy or torch):
    each leaf cut along its rule's axes on ``mesh``, contiguous."""
    return shard_pytree(params, llama_param_specs(params), mesh)


def engine_state_shapes(cfg, max_slots: int, mesh_shape: Mapping[str, int] | None,
                        kv_quant: bool = False) -> dict[str, tuple[int, ...]]:
    """The shapes one rank allocates for the engine's cache: the ragged
    cache ``[L, B/dp, NKV/tp, T, D]`` (``k``/``v``, or ``k8``/``v8`` with
    ``k_scale``/``v_scale`` ``[L, B/dp, NKV/tp, T, 1]`` under int8kv), the
    replicated ``lengths`` ``[B]`` and the prefill scratch ``[L, 1, T,
    NKV/tp, D]``."""
    tp, dp = tp_degree(mesh_shape), dp_degree(mesh_shape)
    full = (cfg.num_layers, int(max_slots), cfg.num_kv_heads, cfg.max_seq, cfg.head_dim)
    rag = shard_shape(full, ragged_kv_spec(dp), dict(mesh_shape or {}))
    seq = shard_shape((cfg.num_layers, 1, cfg.max_seq, cfg.num_kv_heads, cfg.head_dim),
                      SEQ_KV_SPEC, dict(mesh_shape or {}))
    out: dict[str, tuple[int, ...]] = {"lengths": (int(max_slots),), "seq_kv": seq}
    if kv_quant:
        out.update(k8=rag, v8=rag, k_scale=rag[:-1] + (1,), v_scale=rag[:-1] + (1,))
    else:
        out.update(k=rag, v=rag)
    return out


def shard_bytes(leaf, spec: PartitionSpec | None = None,
                mesh_shape: Mapping[str, int] | None = None) -> int:
    """Bytes ONE rank holds of ``leaf``: a rank's tensor is its shard, so
    its own bytes; with ``spec`` and ``mesh_shape``, the block of a FULL
    leaf that spec cuts (replicated leaves count whole)."""
    shape = tuple(leaf.shape)
    if spec is not None:
        shape = shard_shape(shape, spec, dict(mesh_shape or {}))
    itemsize = getattr(leaf, "itemsize", None)
    if itemsize is None:
        itemsize = leaf.element_size()
    return math.prod(shape) * int(itemsize)
