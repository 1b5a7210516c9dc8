"""Model loading: URI -> artifact directory -> Predictor (port of the JAX
package's ``server/loader.py``; the native ``params.npz`` + ``config.json``
artifact of flavors ``llama-generate`` and ``bert-classifier``, and a
HuggingFace Llama checkpoint, bare or inside an MLflow transformers
artifact).

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
again.  The port serves on one device, so its identity's mesh is
``SNAPSHOT_MESH``, the JAX package's default ``meshShape``: a snapshot
baked by a JAX replica at that mesh restores here, and the other way.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..convert import to_numpy, to_tensor
from ..models.registry import BUILDERS, Predictor
from .generation import resolve_device

_log = logging.getLogger("tpumlops_torch.loader")
_capacity_log = logging.getLogger("tpumlops.capacity")

QUANTIZE_MODES = ("none", "int8", "int8kv")

# The mesh of a snapshot's identity: one device, named as the JAX package's
# default meshShape names it.
SNAPSHOT_MESH = {"dp": 1, "tp": 1}


class ModelLoadError(Exception):
    pass


def resolve_uri(model_uri: str) -> Path:
    """Resolve a model URI (a local path or ``file://``) to a directory."""
    if model_uri.startswith("file://"):
        path = Path(model_uri[len("file://"):])
    elif "://" in model_uri:
        raise ModelLoadError(
            f"cannot load {model_uri!r}: object-store URIs are not yet ported "
            "(local paths and file:// only)"
        )
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


_CONFIG_CLASSES = {
    "bert-classifier": ("bert", "BertConfig"),
    "llama-generate": ("llama", "LlamaConfig"),
}


def _build_config(flavor: str, config_dict: dict) -> Any:
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


def _read_npz(path: Path, dev: torch.device, dtype) -> Any:
    with np.load(path, allow_pickle=False) as npz:
        flat = {}
        for key in npz.files:
            # int8 leaves of a pre-quantized tree keep their type; their
            # scales stay f32 whatever the serving type.
            leaf_dtype = None if key.endswith(f"{_SEP}scale") else dtype
            flat[key] = to_tensor(npz[key], dev, leaf_dtype)
    return _unflatten(flat)


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
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
    kwargs), through ``llama.from_torch``.  ``transformers`` is imported
    here, only when an HF checkpoint is loaded."""
    from ..models import llama

    hf_cfg = json.loads((hf_dir / "config.json").read_text())
    model_type = hf_cfg.get("model_type")
    if model_type == "bert":
        raise ModelLoadError(
            "the HF loader for bert is not yet ported (use a native artifact)"
        )
    if model_type != "llama":
        raise ModelLoadError(
            f"unsupported transformers model_type {model_type!r} (supported: llama)"
        )
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
    return "llama-generate", params, cfg, kwargs


def load_predictor(
    model_uri: str,
    flavor: str | None = None,
    quantize: str | None = None,
    device=None,
    dtype=torch.bfloat16,
    load_stats: dict | None = None,
    snapshot_dir: str | None = None,
) -> Predictor:
    """Load a native artifact, or a HuggingFace Llama checkpoint, onto
    ``device`` (``cuda`` unless named).

    Float leaves are cast to ``dtype`` (None keeps them as stored; an HF
    checkpoint's float32 weights are stored as bfloat16 first, as the
    reference serves them, and ``eos_id`` comes from its config).

    - ``llama-generate``: ``quantize`` ``int8``/``int8kv`` turns the layer
      matmuls and the LM head into int8 leaves on the device (``int8kv``
      also selects the int8 KV cache, which is the engine's option).
    - ``bert-classifier``: ``int8`` quantizes each encoder layer's six
      dense weights from the stored values (``quantize_bert``) and, unless
      the artifact pins ``hidden_act``, switches the MLP to tanh-GELU, as
      the reference's loader does; ``int8kv`` is an error (BERT has no KV
      cache).

    ``load_stats`` receives the load's stage seconds: ``restore_s``,
    ``disk_s``, ``transfer_s`` and ``read_gib`` when a snapshot served it,
    else ``quantize_s`` (quantized loads) and ``wall_s``.  ``snapshot_dir``:
    see the module docstring."""
    quantize = quantize or "none"
    if quantize not in QUANTIZE_MODES:
        raise ModelLoadError(f"unknown quantize mode {quantize!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
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


def _load_cold(model_uri, flavor, quantize, dev, dtype, load_stats):
    """The load without a snapshot: ``(predictor, flavor, artifact meta)``."""
    from ..models.quantization import quantize_bert

    path = resolve_uri(model_uri)
    cfg_file = path / "config.json"
    meta = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    flavor = flavor or meta.get("flavor")
    if not (path / "params.npz").exists():
        hf_dir = _find_hf_checkpoint(path)
        if hf_dir is None:
            raise ModelLoadError(
                f"{path} is not a recognized artifact (no params.npz or "
                "HuggingFace checkpoint)"
            )
        flavor, params, cfg, kwargs = _load_transformers(hf_dir)
        params = _cast_floats(params, torch.bfloat16)
        if dtype is not None:
            params = _cast_floats(params, dtype)
        params = _to_device(params, dev)
        if quantize != "none":
            params = _quantize_timed(params, dev, load_stats)
        _log.info("loaded transformers %s model from %s onto %s (quantize=%s)",
                  flavor, hf_dir, dev, quantize)
        pred = _log_capacity(
            BUILDERS[flavor](params, cfg=cfg, dtype=dtype or torch.bfloat16, **kwargs),
            quantize)
        return pred, flavor, {"config": dataclasses.asdict(cfg), "builder_kwargs": kwargs}
    if flavor not in BUILDERS:
        raise ModelLoadError(
            f"flavor {flavor!r} is not yet ported (the port serves "
            f"{', '.join(sorted(BUILDERS))})"
        )
    raw_config = meta.get("config", {})
    cfg = _build_config(flavor, raw_config)
    if flavor == "llama-generate":
        params = _read_npz(path / "params.npz", dev, dtype)
        if quantize != "none":
            params = _quantize_timed(params, dev, load_stats)
    else:
        if quantize == "int8kv":
            raise ModelLoadError(
                "int8kv quantizes a KV cache; bert-classifier has none -- use "
                "quantize: int8"
            )
        params = _read_npz(path / "params.npz", dev, None)
        if quantize == "int8":
            params = quantize_bert(params)
            if "hidden_act" not in raw_config:
                cfg = dataclasses.replace(cfg, hidden_act="gelu_tanh")
                _log.info("int8 path substituting hidden_act=gelu_tanh for an "
                          "artifact without a hidden_act pin")
        if dtype is not None:
            params = _cast_floats(params, dtype)
    _log.info("loaded native %s model from %s onto %s (quantize=%s)",
              flavor, path, dev, quantize)
    kwargs = dict(meta.get("builder_kwargs", {}))
    if flavor == "llama-generate":
        dtype = dtype or torch.bfloat16
    pred = _log_capacity(BUILDERS[flavor](params, cfg=cfg, dtype=dtype, **kwargs), quantize)
    return pred, flavor, meta


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
            raise _snap.SnapshotMismatch(f"snapshot flavor {flavor!r} is not ported")
        cfg = _build_config(flavor, manifest.get("config", {}))
        if dtype is not None:
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


def _log_capacity(predictor: Predictor, quantize: str) -> Predictor:
    """Stamp a causal LM's model-capacity line (weights by dtype, KV bytes
    a row, the cache rows that fit), with or without device telemetry;
    returns the predictor."""
    lm = predictor.causal_lm
    if lm:
        from .device_telemetry import capacity_log_line

        _capacity_log.info("%s", capacity_log_line(lm["params"], lm["cfg"],
                                                   kv_quant=quantize == "int8kv"))
    return predictor
