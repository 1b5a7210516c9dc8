"""The port's ``operator/builder.py`` against the JAX package's.

``backend: seldon`` manifests are byte-equal.  ``backend: cuda`` manifests
(``h100-1``) equal the reference's ``backend: tpu`` manifests (``v5e-1``)
after a normaliser that names exactly the keys that differ: the container's
resource limits and requests, the pod's nodeSelector and tolerations, the
``JAX_PLATFORMS`` variable, the image and the command.  Warm-pool and fleet
pool manifests are held the same way, and ``set_traffic`` too.
"""

from __future__ import annotations

import copy
import json

import pytest

import torch_operator_map as M
from tpumlops.operator import builder as JB
from tpumlops.utils import config as JC
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.operator import (
    builder as PB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    config as PC,
)

SERVER_MODULE = f"{M.PORT}.server"


def _configs(spec: dict):
    return JC.OperatorConfig.from_spec(spec), PC.OperatorConfig.from_spec(M.port_spec(spec))


def _states():
    """(current, uri, traffic, previous, old uri, traffic prev, replicas)."""
    return [
        ("1", "s3://mlflow/1/a/artifacts/model", 100, None, None, 0, None),
        ("2", "s3://mlflow/1/b/artifacts/model", 10, "1", "s3://mlflow/1/a/artifacts/model",
         90, None),
        ("2", "s3://mlflow/1/b/artifacts/model", 60, "1", "s3://mlflow/1/a/artifacts/model",
         40, 3),
        ("3", "/mnt/models/v3", 100, None, None, 0, 2),
    ]


def _build(builder, config, state):
    cur, uri, t, prev, old, tp, replicas = state
    return builder.build_deployment(
        name="iris", namespace="models", owner_uid="uid-1", config=config,
        current_version=cur, new_model_uri=uri, traffic_current=t, previous_version=prev,
        old_model_uri=old, traffic_prev=tp, replicas=replicas)


SELDON_SPECS = [
    {"modelName": "iris", "modelAlias": "prod"},
    {"modelName": "iris", "modelAlias": "prod", "minioSecret": "minio",
     "artifactRoot": "s3://other", "canary": {"step": 25}},
    {"modelName": "iris", "modelAlias": "prod", "minioSecret": "m",
     "autoscaling": {"enabled": True, "minReplicas": 1, "maxReplicas": 4,
                     "targetQueueDepthPerReplica": 2}},
]


@pytest.mark.parametrize("spec", range(len(SELDON_SPECS)))
@pytest.mark.parametrize("state", range(len(_states())))
def test_seldon_manifests_are_byte_equal(spec, state):
    ref_cfg, port_cfg = _configs(SELDON_SPECS[spec])
    st = _states()[state]
    ref = json.dumps(_build(JB, ref_cfg, st), sort_keys=True)
    got = json.dumps(_build(PB, port_cfg, st), sort_keys=True)
    assert got == ref


def _tpu(**tpu):
    return {"modelName": "iris", "modelAlias": "prod", "backend": "tpu", "minioSecret": "m",
            "tpu": {"tpuTopology": "v5e-1", **tpu}}


TPU_SPECS = [
    _tpu(),
    _tpu(quantize="int8kv", prefillChunk=256, maxSlots=4,
         prefixCache={"enabled": True, "budgetMB": 512, "l2BudgetMB": 128},
         speculative={"enabled": True, "draftTokens": 4}, decodeSteps=4),
    _tpu(unifiedStep=True, admissionQueueBudget=4096, drainGraceSeconds=40,
         sloClass="batch", preemption=True, prefixCache={"enabled": True},
         observability={"traceRing": 256, "deviceTelemetry": True, "timeseriesRing": 60}),
    _tpu(compileCacheDir=None, snapshot={"enabled": True}, replicas=2),
    {**_tpu(snapshot={"enabled": True}),
     "autoscaling": {"enabled": True, "minReplicas": 1, "maxReplicas": 4, "warmPoolSize": 2,
                     "targetQueueDepthPerReplica": 2}},
    {**_tpu(prefixCache={"enabled": True}, snapshot={"enabled": True}),
     "fleet": {"disaggregation": True, "prefillReplicas": 2, "decodeReplicas": 3,
               "prefixAffinity": {"tokens": 32}, "observability": {"journeyRing": 128}}},
]


def _normalise(obj, port: bool):
    """The manifest with the differing keys checked (on the port's side)
    and replaced by a placeholder (on both)."""
    obj = copy.deepcopy(obj)

    def walk(node):
        if isinstance(node, dict):
            if "containers" in node:  # a pod spec
                if port:
                    assert node["nodeSelector"] == {"nvidia.com/gpu.product":
                                                    "NVIDIA-H100-80GB-HBM3"}
                    assert node["tolerations"] == [{"key": "nvidia.com/gpu",
                                                    "operator": "Exists",
                                                    "effect": "NoSchedule"}]
                node["nodeSelector"] = node["tolerations"] = "<differs>"
                for c in node["containers"]:
                    if port:
                        assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
                        assert c["resources"]["requests"] == {"nvidia.com/gpu": "1"}
                        assert c["command"] == ["python", "-m", SERVER_MODULE]
                        assert c["image"] == "tpumlops/torch-server:latest"
                        assert not any(e["name"] == "JAX_PLATFORMS" for e in c["env"])
                    else:
                        assert not any(e["name"] == "JAX_PLATFORMS" and e["value"] != "tpu"
                                       for e in c["env"])
                    c["resources"]["limits"] = c["resources"]["requests"] = "<differs>"
                    c["image"] = c["command"] = "<differs>"
                    c["env"] = [e for e in c["env"] if e["name"] != "JAX_PLATFORMS"]
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(obj)
    # The topology's name is a value of the spec, mapped like the spec.
    return json.loads(json.dumps(obj).replace('"v5e-1"', '"h100-1"'))


@pytest.mark.parametrize("spec", range(len(TPU_SPECS)))
@pytest.mark.parametrize("state", range(len(_states())))
def test_cuda_manifests_equal_the_tpu_ones_but_for_the_accelerator(spec, state):
    ref_cfg, port_cfg = _configs(TPU_SPECS[spec])
    st = _states()[state]
    ref, got = _build(JB, ref_cfg, st), _build(PB, port_cfg, st)
    assert ref["spec"]["protocol"] == got["spec"]["protocol"] == "v2"
    assert _normalise(got, port=True) == _normalise(ref, port=False)


@pytest.mark.parametrize("spec", range(len(TPU_SPECS)))
def test_pool_and_unit_manifests_equal_the_tpu_ones(spec):
    ref_cfg, port_cfg = _configs(TPU_SPECS[spec])
    args = ("iris", "models", "uid-1")
    for fn in ("build_warm_pool_manifests", "build_fleet_pool_manifests",
               "build_worker_unit_manifests"):
        ref = getattr(JB, fn)(*args, ref_cfg, "2", "s3://mlflow/1/b/artifacts/model")
        got = getattr(PB, fn)(*args, port_cfg, "2", "s3://mlflow/1/b/artifacts/model")
        assert _normalise(got, port=True) == _normalise(ref, port=False), fn


def test_the_warm_pool_and_fleet_manifests_exist_where_asked():
    _, warm = _configs(TPU_SPECS[4])
    _, fleet = _configs(TPU_SPECS[5])
    args = ("iris", "models", "uid-1")
    pool = PB.build_warm_pool_manifests(*args, warm, "2", "u")
    assert [m["kind"] for m in pool] == ["Deployment"]
    assert pool[0]["spec"]["replicas"] == 2
    assert "--warm-pool" in pool[0]["spec"]["template"]["spec"]["containers"][0]["args"]
    pools = PB.build_fleet_pool_manifests(*args, fleet, "2", "u")
    assert [m["kind"] for m in pools] == ["Deployment", "Service"] * 2


def test_the_server_command_parses_on_the_port_server():
    """Every argument a cuda manifest passes is a flag of the port's
    server, and the parsed config is what the spec says."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
        app,
    )

    for spec in TPU_SPECS:
        _, cfg = _configs(spec)
        c = _build(PB, cfg, _states()[0])["spec"]["predictors"][0]["componentSpecs"][0]
        c = c["spec"]["containers"][0]
        conf = app.config_from_args(app.build_arg_parser().parse_args(c["args"]))
        assert conf.quantize == cfg.cuda.quantize
        assert conf.prefill_chunk == cfg.cuda.prefill_chunk
        assert conf.prefix_cache == cfg.cuda.prefix_cache.enabled
        assert conf.decode_steps == cfg.cuda.decode_steps
        assert conf.predictor_name == "v1" and conf.deployment_name == "iris"


def test_a_unit_of_several_cards_is_refused_by_the_builder():
    import dataclasses

    _, cfg = _configs(TPU_SPECS[0])
    big = dataclasses.replace(cfg, cuda=dataclasses.replace(cfg.cuda, topology="h100-8"))
    with pytest.raises(PC.NotYetPorted, match="unit launcher"):
        _build(PB, big, _states()[0])
    with pytest.raises(PC.NotYetPorted, match="unit launcher"):
        PB.build_worker_unit_manifests("iris", "models", "u", big, "1", "u")


@pytest.mark.parametrize("weights", [{"v1": 70, "v2": 30}, {"v2": 100}, {"v9": 5}, {}])
def test_set_traffic_matches_the_reference(weights):
    ref_cfg, port_cfg = _configs(TPU_SPECS[1])
    st = _states()[1]
    ref = JB.set_traffic(_build(JB, ref_cfg, st), weights)
    got = PB.set_traffic(_build(PB, port_cfg, st), weights)
    assert _normalise(got, port=True) == _normalise(ref, port=False)
    ref_s, port_s = _configs(SELDON_SPECS[1])
    assert json.dumps(PB.set_traffic(_build(PB, port_s, st), weights), sort_keys=True) == \
        json.dumps(JB.set_traffic(_build(JB, ref_s, st), weights), sort_keys=True)
