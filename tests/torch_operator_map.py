"""The mapping between the JAX package's control-plane vocabulary and the
port's, shared by the port's operator tests.

The JAX package serves ``backend: tpu`` with ``spec.tpu`` and TPU
topologies; the port serves ``backend: cuda`` with ``spec.cuda`` and GPU
topologies.  Everything else of a spec, a parsed config, a manifest or an
error message is the same, and these helpers say exactly where the two
differ.
"""

from __future__ import annotations

import copy
import dataclasses
import re

PORT = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"

TOPOLOGY = {"v5e-1": "h100-1", "v5e-4": "h100-4", "v5e-8": "h100-8", "v5e-16": "h100-16"}

# Reference message -> port message, in order.
MESSAGE = [
    ("spec.tpu", "spec.cuda"),
    ("tpuTopology", "gpuTopology"),
    ("backend: tpu", "backend: cuda"),
    ("'tpu'", "'cuda'"),
    (" chips", " cards"),
    ("the slice or", "the topology or"),
    ("a larger slice", "a larger topology"),
    ("a larger\nslice", "a larger topology"),
    ("an XLA shape error at first dispatch", "a shape error at first dispatch"),
] + [(f"'{k}'", f"'{v}'") for k, v in TOPOLOGY.items()]

REF_SERVER_IMAGE = "tpumlops/jax-server:latest"
PORT_SERVER_IMAGE = "tpumlops/torch-server:latest"


def port_tpu(spec):
    """A reference ``spec.tpu`` as the port's ``spec.cuda``."""
    if not isinstance(spec, dict):
        return copy.deepcopy(spec)
    out = copy.deepcopy(spec)
    if "tpuTopology" in out:
        topo = out.pop("tpuTopology")
        out["gpuTopology"] = TOPOLOGY.get(topo, topo)
    return out


def port_spec(spec):
    """A reference ``MlflowModel`` spec as the port's."""
    if not isinstance(spec, dict):
        return copy.deepcopy(spec)
    out = copy.deepcopy(spec)
    if out.get("backend") == "tpu":
        out["backend"] = "cuda"
    if "tpu" in out:
        out["cuda"] = port_tpu(out.pop("tpu"))
    return out


def _sorted_lists(msg: str) -> str:
    # A message that lists allowed keys or names sorts them; the two
    # vocabularies sort differently.
    return re.sub(r"\[([^\[\]]*)\]", lambda m: "[" + ", ".join(
        sorted(x.strip() for x in m.group(1).split(","))) + "]", msg)


def port_message(msg: str) -> str:
    for a, b in MESSAGE:
        msg = msg.replace(a, b)
    return _sorted_lists(msg)


def same_message(ref_msg: str, port_msg: str) -> bool:
    return port_message(ref_msg) == _sorted_lists(port_msg)


def port_fields(obj) -> dict:
    """A reference config dataclass as the port's fields: ``tpu`` is
    ``cuda``, topologies and the backend are renamed."""
    d = dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)
    if "tpu" in d:
        d["cuda"] = d.pop("tpu")
    if d.get("backend") == "tpu":
        d["backend"] = "cuda"
    if d.get("server_image") == REF_SERVER_IMAGE:
        d["server_image"] = PORT_SERVER_IMAGE
    for sub in (d, d.get("cuda") or {}):
        if "topology" in sub:
            sub["topology"] = TOPOLOGY.get(sub["topology"], sub["topology"])
    return d


def refused_feature(port_spec_: dict) -> str | None:
    """The field the port refuses as not yet ported, for a spec the JAX
    package accepts: a mesh smaller than a unit that spans hosts (the JAX
    package runs it on a device prefix); None when the port serves it,
    every other topology of one card or several included."""
    if not isinstance(port_spec_, dict):
        return None
    from importlib import import_module

    config = import_module(f"{PORT}.utils.config")
    if port_spec_.get("backend") == "cuda":
        cuda = port_spec_.get("cuda") or {}
        info = config.GPU_TOPOLOGIES.get(cuda.get("gpuTopology", "h100-8"))
        mesh = cuda.get("meshShape") or {"dp": 1, "tp": 1}
        if info is not None and info.hosts > 1 and info.mesh_devices(mesh) < info.cards:
            return "spec.cuda.meshShape"
    return None
