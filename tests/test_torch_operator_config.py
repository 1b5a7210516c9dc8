"""The port's ``utils/config.py`` against the JAX package's.

Every spec that ``tests/test_config.py`` parses — through
``OperatorConfig.from_spec``, ``TpuSpec.from_spec`` or
``validate_mesh_for_model`` — is recorded by running that file's tests
with the three entry points wrapped, then goes through both packages
after the mapping of ``torch_operator_map`` (``tpu`` -> ``cuda``,
``v5e-N`` -> ``h100-N``, ``spec.tpu`` -> ``spec.cuda``).  The parsed
dataclasses are equal field by field and the errors equal apart from that
vocabulary.  Every topology parses as the JAX package's does, one card or
several; where the JAX package accepts a spec that the port does not serve
yet (a mesh smaller than a unit that spans hosts), the port refuses it with
a ``NotYetPorted`` naming the field; ``spec.slo``, ``spec.planner``,
``spec.anomaly`` and ``spec.multiplex`` parse to the JAX package's fields.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest

import test_config as REF_TESTS
import torch_operator_map as M
import tpumlops.utils.config as JC
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    config as PC,
)


def _record_reference_specs() -> list[tuple[str, tuple, dict]]:
    """Run ``tests/test_config.py``'s tests with the reference's three
    parse entry points wrapped; every top-level call's arguments."""
    calls: list[tuple[str, tuple, dict]] = []
    depth = [0]

    def wrap(kind, fn):
        def inner(*args, **kwargs):
            if depth[0] == 0:
                calls.append((kind, copy.deepcopy(args), copy.deepcopy(kwargs)))
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return inner

    saved = (JC.OperatorConfig.__dict__["from_spec"], JC.TpuSpec.__dict__["from_spec"],
             JC.validate_mesh_for_model)
    JC.OperatorConfig.from_spec = staticmethod(wrap("operator", JC.OperatorConfig.from_spec))
    JC.TpuSpec.from_spec = staticmethod(wrap("tpu", JC.TpuSpec.from_spec))
    JC.validate_mesh_for_model = wrap("mesh", saved[2])
    try:
        for name, fn in sorted(vars(REF_TESTS).items()):
            if name.startswith("test_") and callable(fn):
                fn()
    finally:
        JC.OperatorConfig.from_spec, JC.TpuSpec.from_spec = saved[0], saved[1]
        JC.validate_mesh_for_model = saved[2]
    return calls


CASES = _record_reference_specs()


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, e


def test_every_reference_spec_was_recorded():
    kinds = {k for k, _, _ in CASES}
    assert kinds == {"operator", "tpu", "mesh"}
    assert len(CASES) >= 100


@pytest.mark.parametrize("case", range(len(CASES)))
def test_reference_spec_parses_alike(case):
    kind, args, kwargs = CASES[case]
    if kind == "mesh":
        ref, ref_err = _outcome(lambda: JC.validate_mesh_for_model(*args, **kwargs))
        got, err = _outcome(lambda: PC.validate_mesh_for_model(*args, **kwargs))
        assert (ref_err is None) == (err is None), (ref_err, err)
        if err is not None:
            assert M.same_message(str(ref_err), str(err)), (str(ref_err), str(err))
        return
    spec = args[0]
    if kind == "tpu":
        mapped = M.port_tpu(spec)
        ref, ref_err = _outcome(lambda: JC.TpuSpec.from_spec(spec))
        got, err = _outcome(lambda: PC.CudaSpec.from_spec(mapped))
        refused = None
    else:
        mapped = M.port_spec(spec)
        ref, ref_err = _outcome(lambda: JC.OperatorConfig.from_spec(spec))
        got, err = _outcome(lambda: PC.OperatorConfig.from_spec(mapped))
        refused = None if ref_err is not None else M.refused_feature(mapped)
    if ref_err is not None:
        assert err is not None, f"the port accepted {mapped}: {ref_err}"
        assert M.same_message(str(ref_err), str(err)), (str(ref_err), str(err))
    elif refused is not None:
        assert isinstance(err, PC.NotYetPorted), (mapped, err)
        assert str(err).startswith(refused), (refused, str(err))
    else:
        assert err is None, err
        assert dataclasses.asdict(got) == M.port_fields(ref)


def minimal(**extra):
    return {"modelName": "bert-base", "modelAlias": "prod", **extra}


@pytest.mark.parametrize("topology", ["h100-2", "h100-4", "h100-8", "h100-16"])
def test_a_topology_of_more_than_one_card_is_refused(topology):
    """The name is the refusal this test pinned while units of several cards
    waited for the launcher: each such topology now parses with a mesh of
    every card (and, on one host, with a smaller one, the other cards idle);
    only a mesh smaller than a unit across hosts is still refused."""
    info = PC.GPU_TOPOLOGIES[topology]
    full = {"dp": 1, "tp": info.cards}
    cfg = PC.OperatorConfig.from_spec(minimal(backend="cuda", cuda={"gpuTopology": topology,
                                                                     "meshShape": full}))
    assert (cfg.cuda.topology, dict(cfg.cuda.mesh_shape)) == (topology, full)
    assert info.ranks_per_host(full) == info.cards_per_host
    small = minimal(backend="cuda", cuda={"gpuTopology": topology,
                                          "meshShape": {"dp": 1, "tp": 2}})
    if info.hosts == 1:
        assert PC.OperatorConfig.from_spec(small).cuda.mesh_shape == {"dp": 1, "tp": 2}
        assert info.ranks_per_host({"dp": 1, "tp": 2}) == 2
    else:
        with pytest.raises(PC.NotYetPorted, match=r"^spec.cuda.meshShape .* uses 2 of "
                                                  rf"gpuTopology '{topology}'.*every card"):
            PC.OperatorConfig.from_spec(small)
    # The default topology is the JAX package's v5e-8 mapped, with the default
    # {dp: 1, tp: 1} mesh: one rank, seven cards idle, as in the JAX package.
    cfg = PC.OperatorConfig.from_spec(minimal(backend="cuda"))
    assert cfg.cuda.topology == "h100-8" and cfg.cuda.mesh_shape == {"dp": 1, "tp": 1}


def test_one_card_parses_and_seldon_ignores_the_topology():
    cfg = PC.OperatorConfig.from_spec(minimal(backend="cuda", cuda={"gpuTopology": "h100-1"}))
    assert cfg.backend == "cuda" and cfg.cuda.topology == "h100-1"
    assert cfg.server_image == "tpumlops/torch-server:latest"
    info = PC.GPU_TOPOLOGIES["h100-1"]
    assert (info.cards, info.hosts, info.cards_per_host) == (1, 1, 1)
    assert info.product == "NVIDIA-H100-80GB-HBM3"
    assert PC.GPU_TOPOLOGIES["h100-16"].cards_per_host == 8
    assert PC.GPU_HBM_GIB_PER_CARD[info.product] == 80
    # backend: seldon never reads the topology, as the reference's never does.
    assert PC.OperatorConfig.from_spec(minimal()).backend == "seldon"


@pytest.mark.parametrize("field,section", [
    ("spec.slo", {"slo": {"ttftP99Ms": 250}}),
    ("spec.planner", {"planner": {"enabled": True, "objective": {"ttftP99Ms": 250},
                                  "trace": {"requests": []}}}),
    ("spec.anomaly", {"anomaly": {"driftPct": 0},
                      "cuda": {"gpuTopology": "h100-1",
                               "observability": {"timeseriesRing": 64}}}),
    ("spec.multiplex", {"multiplex": {"poolRef": "pool-a"},
                        "cuda": {"gpuTopology": "h100-1", "snapshot": {"enabled": True}}}),
])
def test_an_unported_feature_is_refused_by_name(field, section):
    """The four fields the port once refused by name now parse to the JAX
    package's fields on ``backend: cuda``, ``h100-1``."""
    spec = minimal(backend="cuda", **section)
    spec.setdefault("cuda", {"gpuTopology": "h100-1"})
    ref_spec = {**spec, "backend": "tpu", "tpu": M.port_tpu(spec["cuda"])}
    ref_spec["tpu"]["tpuTopology"] = "v5e-1"
    ref_spec["tpu"].pop("gpuTopology")
    ref_spec.pop("cuda")
    ref = JC.OperatorConfig.from_spec(ref_spec)
    got = PC.OperatorConfig.from_spec(spec)
    assert dataclasses.asdict(got) == M.port_fields(ref)
    key = field.removeprefix("spec.")
    assert dataclasses.asdict(getattr(got, key)) == dataclasses.asdict(getattr(ref, key))
    assert M.refused_feature(spec) is None


def test_the_jax_backend_and_its_spec_are_refused_naming_cuda():
    with pytest.raises(ValueError, match="backend: cuda"):
        PC.OperatorConfig.from_spec(minimal(backend="tpu"))
    with pytest.raises(ValueError, match="spec.cuda"):
        PC.OperatorConfig.from_spec(minimal(tpu={"tpuTopology": "v5e-1"}))
    with pytest.raises(ValueError, match="'seldon' or 'cuda'"):
        PC.OperatorConfig.from_spec(minimal(backend="gpu"))


def test_not_yet_ported_is_a_value_error():
    assert issubclass(PC.NotYetPorted, ValueError)


def test_mesh_axes_and_slo_classes_match_the_reference():
    from tpumlops.utils.journey_trace import SLO_CLASSES

    assert PC.MESH_AXES == JC.MESH_AXES
    assert PC.SLO_CLASSES == SLO_CLASSES
    assert [f.name for f in dataclasses.fields(PC.CudaSpec)] == \
        [f.name for f in dataclasses.fields(JC.TpuSpec)]
