"""Model loading: URI -> artifact directory -> Predictor (port of the JAX
package's ``server/loader.py``).

Tiered resolution, in the reference's order:

1. the native artifact, ``params.npz`` + ``config.json``, of the
   tree-of-tensors flavors (``llama-generate``, ``bert-classifier``,
   ``resnet-classifier``);
2. a HuggingFace Llama or BERT checkpoint, bare or inside an MLflow
   transformers artifact (needs ``transformers``, imported only then);
3. an MLflow xgboost artifact in xgboost's JSON format (no xgboost
   needed; a binary model is refused with how to re-save it);
4. a pickled sklearn model, ``model.pkl`` (needs sklearn to unpickle),
   served as ``sklearn-linear``, ``sklearn-forest`` or, for anything else
   with a ``predict``, the host-side ``pyfunc`` tier.

URIs: local paths and ``file://`` load directly; object-store URIs
(``s3://``, ``gs://``) resolve under ``TPUMLOPS_ARTIFACT_MIRROR``, a local
mount of the buckets (``s3://<bucket>/<path>`` is ``<mirror>/<bucket>/
<path>``), so the server needs no cloud SDK.

The artifact layout is the reference's, so an artifact written by the
JAX package's ``save_native_model`` loads here unchanged: ``params.npz``
holds the flattened tree (keys joined with ``|``), ``config.json`` the
flavor, config and builder kwargs.  A bfloat16 leaf reads back as the
raw two-byte ``|V2`` where numpy has no bfloat16, and is reinterpreted
bit for bit (``convert.to_tensor``).

``snapshot_dir`` turns on pre-baked weight snapshots
(``server/snapshot.py``): a valid snapshot of the model restores the
served tree straight onto the device with no transform work; a miss loads
cold and, for a causal LM, bakes the snapshot once from the served
(post-quantize) tree.  A mismatched snapshot is one warning and a cold
load; a corrupt one is moved aside (``<path>.corrupt-<pid>``) and baked
again.  A snapshot's identity's mesh is ``SNAPSHOT_MESH``, the JAX
package's default ``meshShape``: a snapshot baked by a JAX replica at that
mesh restores here, and the other way.

``mesh_shape`` of several ranks (one process a rank, the process group
formed first: ``parallel/distributed.py``): a Llama or a BERT is validated
against the mesh, then each rank reads the native artifact or the HF
checkpoint one leaf at a time on the host (:func:`_blocks`): the leaf
(a Llama's at the serving type, a BERT's as stored), its int8 scale from
the whole leaf (so an o/down scale is the whole channel's before the row
split), cut to the rank's block by the flavor's rule table
(``models/partition.LLAMA_PARTITION_RULES`` / ``BERT_PARTITION_RULES``),
and only the block copied to the device.  A rank's device never holds a
full leaf; its host reads a native artifact one leaf at a time
(``transformers`` loads an HF checkpoint whole first).  Every other flavor
(ResNet, the linear, forest, xgboost and pyfunc tiers) is replicated: each
rank loads the whole model, as on one rank.  With ``snapshot_dir`` the
ranks restore together (the sharded layout of ``server/snapshot.py``: each
rank reads its blocks and the replicated leaves) or, on a miss anywhere,
load cold together and bake, each rank writing its blocks; they agree on
each step over the control group, so no rank takes another path.  Every
native flavor bakes on a mesh (the reference bakes causal LMs only, and
restores any flavor's snapshot).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import pickle
import re
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..convert import to_numpy, to_tensor
from ..models import quantization
from ..models.registry import BUILDERS, Predictor, get_builder
from .generation import resolve_device

_log = logging.getLogger("tpumlops_torch.loader")
_capacity_log = logging.getLogger("tpumlops.capacity")

QUANTIZE_MODES = ("none", "int8", "int8kv")

MIRROR_ENV = "TPUMLOPS_ARTIFACT_MIRROR"

# The mesh of a snapshot's identity: one device, named as the JAX package's
# default meshShape names it.
SNAPSHOT_MESH = {"dp": 1, "tp": 1}


class ModelLoadError(Exception):
    pass


def resolve_uri(model_uri: str) -> Path:
    """Resolve a model URI to a local directory (an object-store URI
    through the ``MIRROR_ENV`` mirror)."""
    if model_uri.startswith("file://"):
        path = Path(model_uri[len("file://"):])
    elif "://" in model_uri:
        scheme, rest = model_uri.split("://", 1)
        mirror = os.environ.get(MIRROR_ENV)
        if not mirror:
            raise ModelLoadError(
                f"cannot fetch {model_uri!r}: no {MIRROR_ENV} mirror configured "
                f"(mount the {scheme} bucket and set {MIRROR_ENV})"
            )
        path = Path(mirror) / rest
    else:
        path = Path(model_uri)
    if not path.exists():
        raise ModelLoadError(f"model path {path} does not exist")
    return path


_SEP = "|"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_native_model(
    path: str | Path,
    flavor: str,
    params: Any,
    config: dict | None = None,
    builder_kwargs: dict | None = None,
) -> Path:
    """Write the native artifact layout from a tree of tensors (or numpy
    arrays); bfloat16 leaves are stored as their raw bytes (``|V2``)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = {
        k: to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in _flatten(params).items()
    }
    np.savez(path / "params.npz", **flat)
    meta = {
        "flavor": flavor,
        "config": config or {},
        "builder_kwargs": builder_kwargs or {},
    }
    (path / "config.json").write_text(json.dumps(meta, indent=2))
    (path / "MLmodel").write_text(
        "flavors:\n"
        "  tpumlops:\n"
        "    format: params-npz\n"
        f"    flavor: {flavor}\n"
    )
    return path


def save_sklearn_model(path: str | Path, model: Any, flavor: str) -> Path:
    """Write an MLflow-sklearn-compatible artifact (pickle + MLmodel)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "model.pkl", "wb") as f:
        pickle.dump(model, f)
    (path / "MLmodel").write_text(
        "flavors:\n"
        "  sklearn:\n"
        "    pickled_model: model.pkl\n"
        "  python_function:\n"
        "    loader_module: mlflow.sklearn\n"
        f"# tpumlops flavor hint: {flavor}\n"
    )
    (path / "config.json").write_text(json.dumps({"flavor": flavor}))
    return path


def save_xgboost_model(path: str | Path, model_json: dict) -> Path:
    """Write an MLflow-xgboost-compatible artifact from a parsed JSON model
    (the dict ``Booster.save_model("model.json")`` produces)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "model.json").write_text(json.dumps(model_json))
    (path / "MLmodel").write_text(
        "flavors:\n"
        "  xgboost:\n"
        "    data: model.json\n"
        "    model_format: json\n"
        "  python_function:\n"
        "    loader_module: mlflow.xgboost\n"
        "    data: model.json\n"
    )
    return path


_CONFIG_CLASSES = {
    "bert-classifier": ("bert", "BertConfig"),
    "resnet-classifier": ("resnet", "ResNetConfig"),
    "llama-generate": ("llama", "LlamaConfig"),
}

# Flavors whose float leaves take the serving ``dtype``; ResNet computes in
# the images' dtype from leaves kept as stored, as the reference does.
_SERVING_CAST = ("llama-generate", "bert-classifier")


def _build_config(flavor: str, config_dict: dict) -> Any:
    if flavor not in _CONFIG_CLASSES:
        return None
    mod_name, cls_name = _CONFIG_CLASSES[flavor]
    cls = getattr(importlib.import_module(f"..models.{mod_name}", __package__), cls_name)
    known = set(cls.__dataclass_fields__)
    return cls(**{k: v for k, v in config_dict.items() if k in known})


def _cast_floats(tree: Any, dtype) -> Any:
    """Cast float leaves to ``dtype``; int8 leaves keep their q8 and f32 scale."""
    if isinstance(tree, dict):
        if "q8" in tree and "scale" in tree:
            return tree
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _leaf_dtype(key: str, dtype):
    # int8 leaves of a pre-quantized tree keep their type (``to_tensor``
    # casts float leaves only); their scales stay f32 whatever the serving
    # type.
    return None if key.endswith(f"{_SEP}scale") else dtype


def _read_npz(path: Path, dev: torch.device, dtype) -> Any:
    with np.load(path, allow_pickle=False) as npz:
        flat = {key: to_tensor(npz[key], dev, _leaf_dtype(key, dtype)) for key in npz.files}
    return _unflatten(flat)


# The Llama leaves ``quantize_llama`` turns into int8, by flattened key.
_LLAMA_QUANTIZED = frozenset(
    [f"layers{_SEP}{n}" for n in quantization._LLAMA_LAYER_MATS] + ["lm_head"]
)
# The BERT leaves ``quantize_bert`` turns into int8: each encoder layer's
# six dense weights.
_BERT_QUANTIZED = re.compile(
    r"layers\|#\d+\|(" + "|".join(f"{g}\\|{n}" for g, n in quantization._BERT_LAYER_MATS)
    + r")\|w")


def _quantized_key(flavor: str, key: str) -> bool:
    """Whether the int8 modes quantize ``flavor``'s leaf at flattened ``key``."""
    if flavor == "llama-generate":
        return key in _LLAMA_QUANTIZED
    return flavor == "bert-classifier" and _BERT_QUANTIZED.fullmatch(key) is not None


def _place(block: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Copy one of a rank's blocks to its device (every tensor a rank of a
    mesh keeps goes through here)."""
    return block.to(dev)


def _blocks(flavor: str, leaves, mesh, dev: torch.device, quantize: str,
            stats: dict | None, cast=None) -> Any:
    """This rank's blocks of a Llama or BERT tree from ``leaves``, an
    iterable of ``(flattened key, full host tensor)`` read one at a time.
    A leaf the int8 modes quantize (``quantize_llama`` / ``quantize_bert``)
    takes its scale from the whole leaf (``quantization.channel_scale``),
    then the flavor's rule table cuts the leaf as its ``q8`` plane and the
    scale as its ``scale`` plane, and the block quantizes with its cut of
    the scale: equal, code for code, to cutting the quantized full tree.
    Every other float block is cast to ``cast`` (None: kept).  Only blocks
    are copied to ``dev``; each full leaf is dropped before the next is
    read."""
    from ..models.partition import flavor_rules
    from ..parallel import match_partition_rules, shard_pytree

    rules = flavor_rules(flavor)
    flat: dict[str, Any] = {}
    quantize_s = 0.0
    for key, leaf in leaves:
        quantized = quantize != "none" and _quantized_key(flavor, key)
        if quantized:
            t0 = time.perf_counter()
            part = {f"{key}{_SEP}q8": leaf,
                    f"{key}{_SEP}scale": quantization.channel_scale(leaf)}
            quantize_s += time.perf_counter() - t0
        else:
            part = {key: leaf}
        del leaf
        # The rule table matched on each flattened key as a "/" path.
        paths = {k.replace(_SEP, "/"): v for k, v in part.items()}
        block = {k.replace("/", _SEP): v for k, v in
                 shard_pytree(paths, match_partition_rules(rules, paths), mesh).items()}
        del part, paths
        if quantized:
            t0 = time.perf_counter()
            q8 = f"{key}{_SEP}q8"
            block[q8] = quantization.quantize_with_scale(block[q8], block[f"{key}{_SEP}scale"])
            quantize_s += time.perf_counter() - t0
        elif cast is not None and block[key].is_floating_point():
            block[key] = block[key].to(cast)
        for k, b in block.items():
            flat[k] = _place(b, dev)
        del block
    if stats is not None and quantize != "none":
        stats["quantize_s"] = round(quantize_s, 3)
    return _unflatten(flat)


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def _find_hf_checkpoint(path: Path) -> Path | None:
    """Locate a HuggingFace checkpoint in ``path``, its ``model/`` or
    ``pipeline/`` (MLflow's transformers flavor) or any subdirectory: a
    directory with a ``config.json`` naming a ``model_type`` and weights
    (a single file or a sharded checkpoint's index)."""
    candidates = [path, path / "model", path / "pipeline"]
    candidates += [p for p in sorted(path.iterdir()) if p.is_dir()] if path.is_dir() else []
    seen = set()
    for cand in candidates:
        if cand in seen or not cand.is_dir():
            continue
        seen.add(cand)
        cfg_file = cand / "config.json"
        if not cfg_file.exists():
            continue
        try:
            hf_cfg = json.loads(cfg_file.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(hf_cfg, dict) or "model_type" not in hf_cfg:
            continue
        weight_markers = (
            "pytorch_model.bin",
            "model.safetensors",
            "model.safetensors.index.json",
            "pytorch_model.bin.index.json",
        )
        if any((cand / w).exists() for w in weight_markers):
            return cand
    return None


def _load_transformers(hf_dir: Path):
    """HF checkpoint -> (flavor, float32 params on the CPU, config, builder
    kwargs, raw config), through ``llama.from_torch`` or
    ``bert.from_torch``.  ``transformers`` is imported here, only when an
    HF checkpoint is loaded.  The raw config pins BERT's ``hidden_act``, as
    the checkpoint's own config does."""
    hf_cfg = json.loads((hf_dir / "config.json").read_text())
    model_type = hf_cfg.get("model_type")
    if model_type == "llama":
        from ..models import llama

        scaling = hf_cfg.get("rope_scaling")
        if scaling:
            # The port's RoPE is plain theta-based: a scaled checkpoint would
            # serve silently degraded tokens.
            raise ModelLoadError(
                f"rope_scaling {scaling!r} is not supported (plain RoPE only)"
            )
        from transformers import LlamaForCausalLM

        tm = LlamaForCausalLM.from_pretrained(hf_dir)
        cfg = llama.LlamaConfig(
            vocab_size=int(hf_cfg["vocab_size"]),
            hidden_size=int(hf_cfg["hidden_size"]),
            num_layers=int(hf_cfg["num_hidden_layers"]),
            num_heads=int(hf_cfg["num_attention_heads"]),
            num_kv_heads=int(hf_cfg.get("num_key_value_heads")
                             or hf_cfg["num_attention_heads"]),
            intermediate_size=int(hf_cfg["intermediate_size"]),
            max_seq=int(hf_cfg.get("max_position_embeddings", 4096)),
            rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
            rms_eps=float(hf_cfg.get("rms_norm_eps", 1e-5)),
        )
        params = llama.from_torch(tm, cfg)
        eos = hf_cfg.get("eos_token_id")
        if isinstance(eos, list):  # some checkpoints ship a list of eos ids
            eos = eos[0] if eos else None
        kwargs = {"eos_id": int(eos)} if eos is not None else {}
        return "llama-generate", params, cfg, kwargs, {}
    if model_type == "bert":
        from ..models import bert

        # HF's "gelu" is exact erf; the *_tanh / _new spellings are the tanh
        # approximation.  Another activation would serve wrong logits.
        hf_act = str(hf_cfg.get("hidden_act", "gelu"))
        act_map = {
            "gelu": "gelu",
            "gelu_python": "gelu",
            "gelu_new": "gelu_tanh",
            "gelu_pytorch_tanh": "gelu_tanh",
        }
        if hf_act not in act_map:
            raise ModelLoadError(
                f"unsupported BERT hidden_act {hf_act!r} (supported: {sorted(act_map)})"
            )
        from transformers import BertForSequenceClassification

        tm = BertForSequenceClassification.from_pretrained(hf_dir)
        cfg = bert.BertConfig(
            vocab_size=int(hf_cfg["vocab_size"]),
            hidden_size=int(hf_cfg["hidden_size"]),
            num_layers=int(hf_cfg["num_hidden_layers"]),
            num_heads=int(hf_cfg["num_attention_heads"]),
            intermediate_size=int(hf_cfg["intermediate_size"]),
            max_position_embeddings=int(hf_cfg.get("max_position_embeddings", 512)),
            type_vocab_size=int(hf_cfg.get("type_vocab_size", 2)),
            layer_norm_eps=float(hf_cfg.get("layer_norm_eps", 1e-12)),
            num_labels=int(getattr(tm.config, "num_labels", 2)),
            hidden_act=act_map[hf_act],
        )
        return ("bert-classifier", bert.from_torch(tm, cfg), cfg, {},
                {"hidden_act": act_map[hf_act]})
    raise ModelLoadError(
        f"unsupported transformers model_type {model_type!r} (supported: llama, bert)"
    )


def load_predictor(
    model_uri: str,
    flavor: str | None = None,
    quantize: str | None = None,
    device=None,
    dtype=torch.bfloat16,
    load_stats: dict | None = None,
    snapshot_dir: str | None = None,
    mesh_shape: dict | None = None,
) -> Predictor:
    """Load a model artifact (see the module docstring) onto ``device``
    (``cuda`` unless named).

    Float leaves of ``llama-generate`` and ``bert-classifier`` are cast to
    ``dtype`` (None keeps them as stored; an HF checkpoint's float32
    weights are stored as bfloat16 first, as the reference serves them, and
    ``eos_id`` comes from its config).  ``resnet-classifier`` keeps its
    leaves as stored and computes in the images' dtype.

    - ``llama-generate``: ``quantize`` ``int8``/``int8kv`` turns the layer
      matmuls and the LM head into int8 leaves on the device (``int8kv``
      also selects the int8 KV cache, which is the engine's option).
    - ``bert-classifier``: ``int8`` quantizes each encoder layer's six
      dense weights from the stored values (``quantize_bert``) and, unless
      the artifact pins ``hidden_act``, switches the MLP to tanh-GELU, as
      the reference's loader does; ``int8kv`` is an error (BERT has no KV
      cache).
    - every other flavor refuses any ``quantize`` but ``none``.

    ``load_stats`` receives the load's stage seconds: ``restore_s``,
    ``disk_s``, ``transfer_s`` and ``read_gib`` when a snapshot served it,
    else ``quantize_s`` (quantized loads) and ``wall_s``.  ``snapshot_dir``
    and ``mesh_shape``: see the module docstring."""
    quantize = quantize or "none"
    if quantize not in QUANTIZE_MODES:
        raise ModelLoadError(f"unknown quantize mode {quantize!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    from ..models.partition import mesh_device_count

    if mesh_device_count(mesh_shape) > 1:
        mesh_shape = dict(mesh_shape)
        pred = None
        if snapshot_dir:
            pred = _try_restore_sharded(model_uri, snapshot_dir, quantize, dev, dtype,
                                        load_stats, mesh_shape)
        if pred is None:
            pred, flavor, meta = _load_cold_unit(model_uri, flavor, quantize, dev, dtype,
                                                 load_stats, mesh_shape)
            if snapshot_dir:
                _maybe_write_sharded(pred, model_uri, snapshot_dir, quantize, flavor, meta,
                                     mesh_shape)
        if load_stats is not None and "wall_s" not in load_stats:
            load_stats["wall_s"] = round(time.perf_counter() - t0, 3)
        return pred
    if snapshot_dir:
        pred = _try_restore_snapshot(model_uri, snapshot_dir, quantize, dev, dtype,
                                     load_stats)
        if pred is not None:
            return pred
    pred, flavor, meta = _load_cold(model_uri, flavor, quantize, dev, dtype, load_stats)
    if snapshot_dir:
        _maybe_write_snapshot(pred, model_uri, snapshot_dir, quantize, flavor, meta)
    if load_stats is not None and "wall_s" not in load_stats:
        load_stats["wall_s"] = round(time.perf_counter() - t0, 3)
    return pred


def _quantize_timed(params, dev: torch.device, stats: dict | None):
    """``quantize_llama`` with its seconds in ``stats["quantize_s"]`` (the
    card waited for, so the stage is the device's work)."""
    from ..models.quantization import quantize_llama

    t0 = time.perf_counter()
    params = quantize_llama(params)
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["quantize_s"] = round(time.perf_counter() - t0, 3)
    return params


def _check_quantize(flavor: str, quantize: str) -> None:
    """Refuse a quantize mode ``flavor`` has no path for, before any weight
    is read."""
    if flavor == "bert-classifier" and quantize == "int8kv":
        raise ModelLoadError(
            "int8kv quantizes a KV cache; bert-classifier has none -- use "
            "quantize: int8"
        )
    if flavor not in ("llama-generate", "bert-classifier") and quantize != "none":
        raise ModelLoadError(
            f"quantize={quantize!r} is not supported for flavor {flavor!r} "
            "(supported: llama-generate, bert-classifier)"
        )


def _int8_act(cfg, raw_config: dict):
    """BERT's int8 path: tanh-GELU unless the artifact pins ``hidden_act``."""
    if "hidden_act" in raw_config:
        return cfg
    _log.info("int8 path substituting hidden_act=gelu_tanh for an "
              "artifact without a hidden_act pin")
    return dataclasses.replace(cfg, hidden_act="gelu_tanh")


def _finish(flavor: str, params, cfg, raw_config: dict, quantize: str,
            dev: torch.device, dtype, stats: dict | None):
    """The shared tail of the tree-of-tensors flavors on one rank: quantize
    (the mode checked by :func:`_check_quantize` first) and the
    serving-type cast; returns ``(params, cfg)``."""
    from ..models.quantization import quantize_bert

    if flavor == "llama-generate":
        if quantize != "none":
            params = _quantize_timed(params, dev, stats)
    elif flavor == "bert-classifier":
        if quantize == "int8":
            params = quantize_bert(params)
            cfg = _int8_act(cfg, raw_config)
        if dtype is not None:
            params = _cast_floats(params, dtype)
    return params, cfg


def _sharded(flavor: str | None) -> bool:
    """Whether ``flavor`` shards over a mesh (a rule table of its own);
    every other flavor is replicated."""
    from ..models.partition import FLAVOR_RULES

    return flavor in FLAVOR_RULES


def _mesh_for_flavor(flavor: str, cfg: Any, mesh_shape: dict | None):
    """This rank's mesh on a mesh of several ranks (None for one rank).  A
    Llama or a BERT has its geometry checked first (a bad tp fails typed
    here, before any weight is read) and gets the mesh with its process
    groups; every other flavor is replicated and gets this rank's place
    only (``parallel.mesh.placement``: no collective runs)."""
    from ..models import partition

    if partition.mesh_device_count(mesh_shape) <= 1:
        return None
    if not _sharded(flavor):
        from ..parallel.mesh import placement

        mesh = placement(mesh_shape)
        _log.info("loading %s whole on every rank of mesh %s (replicated)", flavor,
                  mesh_shape)
        return mesh
    validate = (partition.validate_llama_mesh if flavor == "llama-generate"
                else partition.validate_bert_mesh)
    try:
        validate(cfg, mesh_shape)
    except ValueError as e:
        raise ModelLoadError(str(e)) from None
    from ..parallel import build_mesh

    mesh = build_mesh(mesh_shape)
    _log.info("loading this rank's blocks of %s over mesh %s (rank %d, coordinates %s)",
              flavor, mesh_shape, mesh.rank, mesh.coords)
    return mesh


def _hf_leaves(params: Any, dtype):
    """An HF checkpoint's leaves one at a time, cast as the one-rank path
    casts the tree (bfloat16 first, as the reference serves a checkpoint,
    then ``dtype`` where not None)."""
    for key, leaf in _flatten(params).items():
        leaf = leaf.to(torch.bfloat16)
        yield key, (leaf.to(dtype) if dtype is not None else leaf)


class _UnitSteps:
    """The agreements of a cold load on a mesh of several ranks, so that
    every rank enters the same collectives whatever fails where: one once
    the artifact's flavor and geometry are read (:meth:`planned`, before
    any mesh is built), and one after the load (in :func:`_load_cold_unit`)
    when the first passed.  A rank that fails before the first joins it
    with a failure; a failure after it is the second's."""

    def __init__(self) -> None:
        self.planned_ok: bool | None = None  # None: this rank never reached the step

    def planned(self) -> None:
        self.planned_ok = _agree(True)
        if not self.planned_ok:
            raise ModelLoadError("the load failed on another rank of the unit")


def _load_cold_unit(model_uri, flavor, quantize, dev, dtype, load_stats, mesh_shape):
    """:func:`_load_cold` on every rank of a mesh together (see
    :class:`_UnitSteps`): it raises on every rank when it failed on any."""
    steps = _UnitSteps()
    try:
        out, err = _load_cold(model_uri, flavor, quantize, dev, dtype, load_stats,
                              mesh_shape=mesh_shape, steps=steps), None
    except Exception as e:
        out, err = None, e
    if steps.planned_ok is None:
        _agree(False)  # the step the other ranks wait in
    if steps.planned_ok and not _agree(err is None):
        err = err or ModelLoadError("the load failed on another rank of the unit")
    if err is not None:
        raise err
    return out


def _load_cold(model_uri, flavor, quantize, dev, dtype, load_stats, mesh_shape=None,
               steps: _UnitSteps | None = None):
    """The load without a snapshot: ``(predictor, flavor, artifact meta)``.
    ``steps``: a mesh's agreements (:class:`_UnitSteps`), taken before any
    mesh is built."""
    planned = steps.planned if steps is not None else (lambda: None)
    path = resolve_uri(model_uri)
    cfg_file = path / "config.json"
    meta = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    flavor = flavor or meta.get("flavor")
    serving_dtype = dtype or torch.bfloat16

    if (path / "params.npz").exists():
        if not flavor:
            raise ModelLoadError(f"{path} has params.npz but no flavor recorded")
        if flavor not in _CONFIG_CLASSES:
            raise ModelLoadError(
                f"flavor {flavor!r} has no params.npz layout (native flavors: "
                f"{', '.join(sorted(_CONFIG_CLASSES))})"
            )
        raw_config = meta.get("config", {})
        cfg = _build_config(flavor, raw_config)
        _check_quantize(flavor, quantize)
        planned()
        mesh = _mesh_for_flavor(flavor, cfg, mesh_shape)
        if mesh is not None and _sharded(flavor):
            llama = flavor == "llama-generate"
            # Llama is read straight at the serving type; BERT as stored, and
            # cast after its int8 leaves are cut.
            read_dtype = dtype if llama else None
            with np.load(path / "params.npz", allow_pickle=False) as npz:
                params = _blocks(
                    flavor,
                    ((k, to_tensor(npz[k], None, _leaf_dtype(k, read_dtype)))
                     for k in npz.files),
                    mesh, dev, quantize, load_stats, cast=None if llama else dtype)
            if flavor == "bert-classifier" and quantize == "int8":
                cfg = _int8_act(cfg, raw_config)
        else:
            # Llama is read straight at the serving type; the others as stored.
            params = _read_npz(path / "params.npz", dev,
                               dtype if flavor == "llama-generate" else None)
            params, cfg = _finish(flavor, params, cfg, raw_config, quantize, dev, dtype,
                                  load_stats)
        _log.info("loaded native %s model from %s onto %s (quantize=%s)",
                  flavor, path, dev, quantize)
        kwargs = dict(meta.get("builder_kwargs", {}))
        if mesh is not None and _sharded(flavor):
            kwargs["mesh"] = mesh
        # BERT with dtype None computes in its stored type; Llama never does.
        build_dtype = serving_dtype if flavor == "llama-generate" else dtype
        pred = _log_capacity(get_builder(flavor)(params, cfg=cfg, dtype=build_dtype, **kwargs),
                             quantize, mesh.tp if mesh is not None else 1)
        return pred, flavor, meta

    hf_dir = _find_hf_checkpoint(path)
    if hf_dir is not None:
        flavor, params, cfg, kwargs, raw_config = _load_transformers(hf_dir)
        _check_quantize(flavor, quantize)
        planned()
        mesh = _mesh_for_flavor(flavor, cfg, mesh_shape)
        if mesh is not None:
            llama = flavor == "llama-generate"
            params = _blocks(flavor, _hf_leaves(params, dtype if llama else None), mesh, dev,
                             quantize, load_stats, cast=None if llama else dtype)
            if flavor == "bert-classifier" and quantize == "int8":
                cfg = _int8_act(cfg, raw_config)
        else:
            params = _cast_floats(params, torch.bfloat16)
            if flavor == "llama-generate" and dtype is not None:
                params = _cast_floats(params, dtype)
            params = _to_device(params, dev)
            params, cfg = _finish(flavor, params, cfg, raw_config, quantize, dev, dtype,
                                  load_stats)
        _log.info("loaded transformers %s model from %s onto %s (quantize=%s)",
                  flavor, hf_dir, dev, quantize)
        pred = _log_capacity(get_builder(flavor)(params, cfg=cfg, dtype=serving_dtype,
                                                 **kwargs, **({"mesh": mesh} if mesh else {})),
                             quantize, mesh.tp if mesh is not None else 1)
        return pred, flavor, {"config": dataclasses.asdict(cfg), "builder_kwargs": kwargs}

    # What remains (sklearn, xgboost, pyfunc) is replicated on a mesh: every
    # rank loads the whole model.
    planned()
    if quantize != "none":
        # What remains are sklearn / xgboost / pyfunc artifacts, with no
        # weight matmuls to quantize: refuse loudly instead of ignoring.
        raise ModelLoadError(
            f"quantize={quantize!r} is only supported for the tree-of-tensors "
            "flavors (llama-generate, bert-classifier)"
        )

    xgb_file = _find_xgboost_file(path)
    if xgb_file is not None:
        raw = xgb_file.read_bytes()
        if raw.lstrip()[:1] != b"{":
            raise ModelLoadError(
                f"{xgb_file.name} is a binary xgboost model (UBJ/legacy); "
                're-save it as JSON (booster.save_model("model.json")) for '
                "device-native serving, or use the pyfunc tier"
            )
        _log.info("loaded xgboost JSON model from %s onto %s", xgb_file, dev)
        return get_builder("xgboost")(json.loads(raw), device=dev), "xgboost", meta

    if (path / "model.pkl").exists():
        # An MLflow sklearn artifact is a pickle: unpickling runs the code
        # it names, so serve only artifacts from a trusted registry.
        with open(path / "model.pkl", "rb") as f:
            model = pickle.load(f)
        flavor = flavor or _sniff_sklearn_flavor(model)
        _log.info("loaded sklearn %s model from %s as flavor %s",
                  type(model).__name__, path, flavor)
        return get_builder(flavor)(model, device=dev), flavor, meta

    raise ModelLoadError(
        f"{path} is not a recognized artifact "
        "(no params.npz, HuggingFace checkpoint, xgboost model file, or model.pkl)"
    )


def _find_xgboost_file(path: Path) -> Path | None:
    """The model file of an MLflow xgboost artifact: the MLmodel's
    ``data: <file>``, else a conventional name."""
    mlmodel = path / "MLmodel"
    if mlmodel.exists():
        text = mlmodel.read_text()
        if "xgboost" not in text:
            return None  # a declared non-xgboost artifact: no name sniffing
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("data:"):
                cand = path / line.split(":", 1)[1].strip().strip("\"'")
                if cand.exists():
                    return cand
    for name in ("model.json", "model.ubj", "model.xgb", "model.bst"):
        cand = path / name
        if cand.exists():
            return cand
    return None


def _sniff_sklearn_flavor(model: Any) -> str:
    name = type(model).__name__
    if hasattr(model, "estimators_"):
        return "sklearn-forest"
    if hasattr(model, "coef_"):
        return "sklearn-linear"
    if hasattr(model, "predict"):
        _log.warning("model %s has no device lowering; using the pyfunc tier", name)
        return "pyfunc"
    raise ModelLoadError(f"cannot serve object of type {name}")


def _try_restore_snapshot(model_uri: str, snapshot_dir: str, quantize: str,
                          dev: torch.device, dtype, load_stats: dict | None):
    """A restore from the model's snapshot, or None for a cold load: never
    baked (silent), baked for another identity or layout (one warning), or
    corrupt (a warning, and the snapshot moved aside so the cold load
    bakes it again)."""
    from . import snapshot as _snap

    spath = _snap.snapshot_path_for(snapshot_dir, model_uri)
    if not (spath / _snap.MANIFEST_NAME).exists():
        return None
    ident = _snap.snapshot_identity(model_uri, quantize, SNAPSHOT_MESH)
    try:
        stats: dict = {}
        params, manifest = _snap.load_snapshot(spath, identity=ident, stats=stats,
                                               device=dev)
        flavor = manifest["flavor"]
        if flavor not in BUILDERS:
            raise _snap.SnapshotMismatch(f"snapshot flavor {flavor!r} is not registered")
        cfg = _build_config(flavor, manifest.get("config", {}))
        if dtype is not None and flavor in _SERVING_CAST:
            params = _cast_floats(params, dtype)  # a no-op at the baked type
        pred = BUILDERS[flavor](params, cfg=cfg, dtype=dtype or torch.bfloat16,
                                **manifest.get("builder_kwargs", {}))
        if load_stats is not None:
            load_stats.update(stats)
        _log.info("restored %s from snapshot %s (%.2f GiB in %.2fs, zero transform work)",
                  flavor, spath, stats.get("read_gib", 0.0), stats.get("restore_s", 0.0))
        return _log_capacity(pred, quantize)
    except _snap.SnapshotMismatch as e:
        _log.warning("snapshot invalidated, falling back to cold load (will re-bake): %s", e)
    except _snap.SnapshotError as e:
        _log.warning("snapshot unusable (%s), falling back to cold load", e)
        # Moved aside: its manifest still matches the identity, so without
        # this the bake after the cold load would skip it and every later
        # restore would fail on the same chunks.
        try:
            os.replace(spath, f"{spath}.corrupt-{os.getpid()}")
        except OSError:
            pass
    return None


def _maybe_write_snapshot(pred: Predictor, model_uri: str, snapshot_dir: str,
                          quantize: str, flavor: str, meta: dict) -> None:
    """Bake the snapshot after a cold load, from the served tree: once (a
    snapshot valid for this identity is left alone), causal LMs only.  A
    failed write is a warning; serving goes on."""
    from . import snapshot as _snap

    lm = pred.causal_lm
    if not lm:
        return
    ident = _snap.snapshot_identity(model_uri, quantize, SNAPSHOT_MESH)
    spath = _snap.snapshot_path_for(snapshot_dir, model_uri)
    try:
        if (spath / _snap.MANIFEST_NAME).exists():
            try:
                _snap.check_identity(_snap.read_manifest(spath), ident)
                return  # already baked for this identity
            except _snap.SnapshotError:
                pass  # stale or corrupt: bake again below
        _snap.write_snapshot(
            snapshot_dir, lm["params"], identity=ident, flavor=flavor,
            config=dict(meta.get("config", {})),
            builder_kwargs={"eos_id": int(lm["eos_id"])} if lm.get("eos_id") is not None else {},
        )
    except Exception as e:
        _log.warning("snapshot write failed (serving unaffected): %s", e)


def _agree(flag: bool, strongest: bool = False) -> bool:
    """Every rank's ``flag`` joined over the world-wide control group: all
    of them (``strongest``: any of them), so the ranks of a unit take one
    path together."""
    import torch.distributed as dist

    from ..parallel.distributed import control_group

    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if strongest else dist.ReduceOp.MIN,
                    group=control_group())
    return bool(t.item())


def _try_restore_sharded(model_uri: str, snapshot_dir: str, quantize: str,
                         dev: torch.device, dtype, load_stats: dict | None, mesh_shape: dict):
    """:func:`_try_restore_snapshot` on a mesh of several ranks (every rank
    calls it together): the ranks agree the manifest matches this
    identity, build the mesh, each restores its own blocks and the
    replicated leaves (``snapshot.load_snapshot(mesh=)``), and they agree
    again.  A miss or a failure anywhere is a cold load on every rank; a
    corrupt snapshot is moved aside by rank 0."""
    import torch.distributed as dist

    from ..parallel.distributed import control_group
    from . import snapshot as _snap

    spath = _snap.snapshot_path_for(snapshot_dir, model_uri)
    ident = _snap.snapshot_identity(model_uri, quantize, mesh_shape)
    manifest, why = None, None
    if (spath / _snap.MANIFEST_NAME).exists():
        try:
            manifest = _snap.read_manifest(spath)
            _snap.check_identity(manifest, ident)
            if manifest.get("flavor") not in _CONFIG_CLASSES:
                raise _snap.SnapshotMismatch(
                    f"snapshot flavor {manifest.get('flavor')!r} has no native layout")
        except _snap.SnapshotError as e:
            manifest, why = None, e
    if not _agree(manifest is not None):
        if why is not None and dist.get_rank() == 0:
            _log.warning("snapshot invalidated, falling back to cold load (will re-bake): %s",
                         why)
        return None
    flavor = manifest["flavor"]
    cfg = _build_config(flavor, manifest.get("config", {}))
    mesh = _mesh_for_flavor(flavor, cfg, mesh_shape)
    stats: dict = {}
    params, corrupt = None, False
    try:
        params, _ = _snap.load_snapshot(spath, identity=ident, stats=stats, device=dev,
                                        mesh=mesh)
    except _snap.SnapshotMismatch as e:
        _log.warning("snapshot invalidated, falling back to cold load (will re-bake): %s", e)
    except _snap.SnapshotError as e:
        _log.warning("snapshot unusable (%s), falling back to cold load", e)
        corrupt = True
    if not _agree(params is not None):
        if _agree(corrupt, strongest=True) and dist.get_rank() == 0:
            try:
                os.replace(spath, f"{spath}.corrupt-{os.getpid()}")
            except OSError:
                pass
        dist.barrier(group=control_group())
        return None
    if dtype is not None and flavor in _SERVING_CAST:
        params = _cast_floats(params, dtype)  # a no-op at the baked type
    kwargs = dict(manifest.get("builder_kwargs", {}))
    if _sharded(flavor):
        kwargs["mesh"] = mesh
    pred = BUILDERS[flavor](params, cfg=cfg, dtype=dtype or torch.bfloat16, **kwargs)
    if load_stats is not None:
        load_stats.update(stats)
    _log.info("restored this rank's blocks of %s from snapshot %s (%.2f GiB in %.2fs, zero "
              "transform work; mesh %s, coordinates %s)", flavor, spath,
              stats.get("read_gib", 0.0), stats.get("restore_s", 0.0), mesh_shape, mesh.coords)
    return _log_capacity(pred, quantize, mesh.tp)


def _maybe_write_sharded(pred: Predictor, model_uri: str, snapshot_dir: str, quantize: str,
                         flavor: str, meta: dict, mesh_shape: dict) -> None:
    """:func:`_maybe_write_snapshot` on a mesh of several ranks (every rank
    calls it together): once for the identity, in the sharded layout, each
    rank writing its own blocks, for every native flavor (a replicated one
    is written whole by rank 0).  A BERT's config records the ``hidden_act``
    it serves (the int8 path's substitution included).  A failed write is a
    warning on every rank; serving goes on."""
    from ..models import partition
    from . import snapshot as _snap

    lm = pred.causal_lm
    tree = lm or pred.tree
    ident = _snap.snapshot_identity(model_uri, quantize, mesh_shape)
    spath = _snap.snapshot_path_for(snapshot_dir, model_uri)
    baked = False
    if (spath / _snap.MANIFEST_NAME).exists():
        try:
            _snap.check_identity(_snap.read_manifest(spath), ident)
            baked = True
        except _snap.SnapshotError:
            pass  # stale or corrupt: bake again below
    if _agree(baked) or not tree:
        return
    from ..parallel import match_partition_rules
    from ..parallel.mesh import placement

    # The rule table matched on each flattened key as a "/" path.
    flat = {k.replace(_SEP, "/"): v for k, v in _flatten(tree["params"]).items()}
    specs = match_partition_rules(partition.flavor_rules(flavor), flat)
    config = dict(meta.get("config", {}))
    if lm:
        kwargs = {"eos_id": int(lm["eos_id"])} if lm.get("eos_id") is not None else {}
    else:
        kwargs = dict(meta.get("builder_kwargs", {}))
        if flavor == "bert-classifier":
            config["hidden_act"] = tree["cfg"].hidden_act
    try:
        _snap.write_snapshot(
            snapshot_dir, tree["params"], identity=ident, flavor=flavor,
            config=config, builder_kwargs=kwargs,
            mesh=placement(mesh_shape),
            specs={k.replace("/", _SEP): v for k, v in specs.items()})
    except Exception as e:
        _log.warning("snapshot write failed (serving unaffected): %s", e)


def _log_capacity(predictor: Predictor, quantize: str, tp: int = 1) -> Predictor:
    """Stamp a causal LM's model-capacity line (weights by dtype, KV bytes
    a row, the cache rows that fit; a rank's own at ``tp`` > 1), with or
    without device telemetry; returns the predictor."""
    lm = predictor.causal_lm
    if lm:
        from .device_telemetry import capacity_log_line

        _capacity_log.info("%s", capacity_log_line(lm["params"], lm["cfg"],
                                                   kv_quant=quantize == "int8kv", tp=tp))
    return predictor
