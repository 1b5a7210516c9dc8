"""Model loading: URI -> artifact directory -> Predictor (port of the JAX
package's ``server/loader.py``; the native ``params.npz`` + ``config.json``
artifact of flavors ``llama-generate`` and ``bert-classifier``).

The artifact layout is the reference's, so an artifact written by the
JAX package's ``save_native_model`` loads here unchanged: ``params.npz``
holds the flattened tree (keys joined with ``|``), ``config.json`` the
flavor, config and builder kwargs.  A bfloat16 leaf reads back as the
raw two-byte ``|V2`` where numpy has no bfloat16, and is reinterpreted
bit for bit (``convert.to_tensor``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..convert import to_numpy, to_tensor
from ..models.registry import BUILDERS, Predictor
from .generation import resolve_device

_log = logging.getLogger("tpumlops_torch.loader")

QUANTIZE_MODES = ("none", "int8", "int8kv")


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


def load_predictor(
    model_uri: str,
    flavor: str | None = None,
    quantize: str | None = None,
    device=None,
    dtype=torch.bfloat16,
) -> Predictor:
    """Load a native artifact onto ``device`` (``cuda`` unless named).

    Float leaves are cast to ``dtype`` (None keeps them as stored).

    - ``llama-generate``: ``quantize`` ``int8``/``int8kv`` turns the layer
      matmuls and the LM head into int8 leaves on the device (``int8kv``
      also selects the int8 KV cache, which is the engine's option).
    - ``bert-classifier``: ``int8`` quantizes each encoder layer's six
      dense weights from the stored values (``quantize_bert``) and, unless
      the artifact pins ``hidden_act``, switches the MLP to tanh-GELU, as
      the reference's loader does; ``int8kv`` is an error (BERT has no KV
      cache)."""
    from ..models.quantization import quantize_bert, quantize_llama

    quantize = quantize or "none"
    if quantize not in QUANTIZE_MODES:
        raise ModelLoadError(f"unknown quantize mode {quantize!r}")
    dev = resolve_device(device)
    path = resolve_uri(model_uri)
    cfg_file = path / "config.json"
    meta = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    flavor = flavor or meta.get("flavor")
    if not (path / "params.npz").exists():
        raise ModelLoadError(
            f"{path} has no params.npz: only the native artifact is ported "
            "(the HF loader is not yet ported)"
        )
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
            params = quantize_llama(params)
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
    return BUILDERS[flavor](params, cfg=cfg, dtype=dtype, **kwargs)
