"""The port's ``deploy/`` against the JAX package's (after
``tests/test_aux.py``'s manifest tests and ``tests/test_deploy_build.py``).

- The CRD, the RBAC and the operator Deployment load as YAML with the
  expected fields; apart from ``backend``'s enum and the ``tpu`` / ``cuda``
  blocks the port's CRD IS the JAX package's (one ``MlflowModel`` kind for
  both operators).
- ``spec.cuda`` in the CRD lists exactly the keys ``CudaSpec.from_spec``
  reads, its nested blocks included, and ``gpuTopology`` is an enum of
  ``GPU_TOPOLOGIES``.
- Every example CR is the JAX package's example of the same name in the
  port's vocabulary, parses through ``OperatorConfig.from_spec`` and builds
  through every manifest builder without a refusal; every CR on
  ``backend: cuda`` takes its pod's server arguments through the
  generation engine's construction on a CUDA device at the CR's mesh
  without a refusal.
- Every Dockerfile ``COPY`` source exists; the images are the ones the
  manifests, the config and the Makefile name; the package data ships the
  files; the operator's import closure pulls no torch.
"""

from __future__ import annotations

import copy
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import yaml

import torch_operator_map as M
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.operator import (  # noqa: E501
    builder as PB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (  # noqa: E501
    config as PC,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / M.PORT
REF = REPO / "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu"


def _crd(pkg: Path) -> dict:
    return list(yaml.safe_load_all((pkg / "deploy" / "crd.yaml").read_text()))[0]


def _spec_props(crd: dict) -> dict:
    return crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"][
        "properties"]


def test_manifests_are_valid_yaml_with_expected_fields():
    crd = _crd(PORT)
    assert crd["spec"]["group"] == "mlflow.nizepart.com"
    assert crd["spec"]["names"]["kind"] == "MlflowModel"
    assert crd["spec"]["names"]["shortNames"] == ["mlflowm"]
    version = crd["spec"]["versions"][0]
    spec_props = _spec_props(crd)
    for f in ("modelName", "modelAlias", "monitoringInterval", "minioSecret"):
        assert f in spec_props, f
    assert spec_props["backend"]["enum"] == ["seldon", "tpu", "cuda"]
    assert "gpuTopology" in spec_props["cuda"]["properties"]
    assert "meshShape" in spec_props["cuda"]["properties"]
    status_props = version["schema"]["openAPIV3Schema"]["properties"]["status"]["properties"]
    for f in ("currentModelVersion", "previousModelVersion", "error",
              "phase", "trafficCurrent", "heldVersion"):
        assert f in status_props, f
    assert version["subresources"] == {"status": {}}

    rbac_docs = list(yaml.safe_load_all((PORT / "deploy" / "rbac.yaml").read_text()))
    assert [d["kind"] for d in rbac_docs] == ["ServiceAccount", "ClusterRole",
                                             "ClusterRoleBinding"]
    resources = {r for rule in rbac_docs[1]["rules"] for r in rule["resources"]}
    assert {"mlflowmodels", "mlflowmodels/status", "seldondeployments", "events", "secrets",
            "nodes", "pods", "leases", "statefulsets", "services", "deployments"} <= resources
    ref_rbac = list(yaml.safe_load_all((REF / "deploy" / "rbac.yaml").read_text()))
    ref_rules = {(tuple(r["apiGroups"]), res, tuple(r["verbs"]))
                 for r in ref_rbac[1]["rules"] for res in r["resources"]}
    got_rules = {(tuple(r["apiGroups"]), res, tuple(r["verbs"]))
                 for r in rbac_docs[1]["rules"] for res in r["resources"]}
    assert ref_rules <= got_rules  # the reference's grants, and more

    dep = list(yaml.safe_load_all((PORT / "deploy" / "operator-deployment.yaml").read_text()))[0]
    container = dep["spec"]["template"]["spec"]["containers"][0]
    assert container["command"] == ["python", "-m", f"{M.PORT}.operator"]
    assert container["args"] == ["--leader-elect"]
    assert container["envFrom"][0]["secretRef"]["name"] == "mlflow-creds"
    assert dep["spec"]["template"]["spec"]["serviceAccountName"] == rbac_docs[0]["metadata"][
        "name"]


def test_the_crd_is_the_reference_crd_with_cuda_added():
    ref, got = _crd(REF), _crd(PORT)
    assert "tpu" in _spec_props(got) and "cuda" in _spec_props(got)
    for doc in (ref, got):
        props = _spec_props(doc)
        props.pop("tpu")
        props.pop("cuda", None)
        props["backend"].pop("enum")
    assert got == ref


def _allowed(section: str | None) -> list[str]:
    """The keys ``CudaSpec.from_spec`` reads at ``section`` (the top level
    when None), as its unknown-key message lists them."""
    spec = {"bogus_key": 1} if section is None else {section: {"bogus_key": 1}}
    with pytest.raises(ValueError, match="unknown key") as err:
        PC.CudaSpec.from_spec(spec)
    return sorted(re.search(r"allowed: \[(.*)\]", str(err.value)).group(1).replace("'", "")
                  .split(", "))


def test_every_cuda_key_the_parser_reads_is_a_crd_property_and_back():
    cuda = _spec_props(_crd(PORT))["cuda"]["properties"]
    assert sorted(cuda) == _allowed(None)
    for section in ("prefixCache", "speculative", "observability", "snapshot"):
        assert sorted(cuda[section]["properties"]) == _allowed(section), section
    assert cuda["gpuTopology"]["enum"] == list(PC.GPU_TOPOLOGIES)
    assert cuda["gpuTopology"]["default"] == PC.CudaSpec.from_spec({}).topology
    assert cuda["sloClass"]["enum"] == list(PC.SLO_CLASSES)
    # The CRD's defaults are the parser's.
    parsed = PC.CudaSpec.from_spec({})
    for key, field in (("replicas", "replicas"), ("dtype", "dtype"),
                       ("maxBatchSize", "max_batch_size"), ("decodeSteps", "decode_steps"),
                       ("compileCacheDir", "compile_cache_dir"), ("quantize", "quantize"),
                       ("spPrefillThreshold", "sp_prefill_threshold"),
                       ("drainGraceSeconds", "drain_grace_s")):
        assert cuda[key]["default"] == getattr(parsed, field), key


def _examples(pkg: Path) -> dict[str, list[dict]]:
    return {p.name: list(yaml.safe_load_all(p.read_text()))
            for p in sorted((pkg / "deploy" / "examples").glob("*.yaml"))}


def test_every_example_is_the_reference_example_in_the_port_vocabulary():
    ref, got = _examples(REF), _examples(PORT)
    assert sorted(got) == sorted(ref)
    for name, docs in ref.items():
        want = copy.deepcopy(docs)
        for doc in want:
            doc["spec"] = M.port_spec(doc["spec"])
        assert got[name] == want, name
    text = "\n".join(p.read_text() for p in (PORT / "deploy" / "examples").glob("*.yaml"))
    assert "v5e" not in text and "tpuTopology" not in text


@pytest.mark.parametrize("name", sorted(_examples(PORT)))
def test_every_example_parses_and_builds_without_a_refusal(name):
    for doc in _examples(PORT)[name]:
        cfg = PC.OperatorConfig.from_spec(doc["spec"])
        meta = doc["metadata"]
        args = (meta["name"], meta["namespace"], "uid")
        sd = PB.build_deployment(*args, cfg, "1", "s3://mlflow/1", 100)
        (pred,) = sd["spec"]["predictors"]
        units = PB.build_worker_unit_manifests(*args, cfg, "1", "s3://mlflow/1")
        PB.build_warm_pool_manifests(*args, cfg, "1", "s3://mlflow/1")
        PB.build_fleet_pool_manifests(*args, cfg, "1", "s3://mlflow/1")
        if cfg.backend != "cuda":
            continue
        info = PC.GPU_TOPOLOGIES[cfg.cuda.topology]
        if info.hosts > 1:
            assert [m["kind"] for m in units] == ["Service", "Service", "StatefulSet"]
            pod = units[2]["spec"]["template"]["spec"]
            assert pred["gpuWorkerUnit"]["ranksPerHost"] == info.cards_per_host
        else:
            assert units == []
            pod = pred["componentSpecs"][0]["spec"]
        (c,) = pod["containers"]
        assert c["command"][-1] == (PB.LAUNCH_MODULE if info.cards > 1 else PB.SERVER_MODULE)
        assert c["resources"]["limits"] == {"nvidia.com/gpu": str(info.cards_per_host)}


def _cuda_docs() -> list[tuple[str, int]]:
    return [(name, i) for name, docs in _examples(PORT).items() for i, doc in enumerate(docs)
            if doc["spec"].get("backend") == "cuda"]


@pytest.mark.parametrize("name,i", _cuda_docs())
def test_every_cuda_example_passes_the_engines_construction_checks(monkeypatch, name, i):
    """The server arguments of the pod the operator builds for the CR, parsed
    by the server, through ``make_gen_engine`` on a CUDA device at the CR's
    mesh: every option check the engine makes at construction passes (the
    card and the world are stood in for; construction stops at its first
    device allocation, after the checks)."""
    import types

    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (  # noqa: E501
        parallel,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
        llama as TL,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel import (  # noqa: E501
        mesh as pmesh,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
        app as tapp,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
        generation as TG,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
        metrics as tmetrics,
    )

    doc = _examples(PORT)[name][i]
    cfg = PC.OperatorConfig.from_spec(doc["spec"])
    meta = doc["metadata"]
    args = (meta["name"], meta["namespace"], "uid")
    sd = PB.build_deployment(*args, cfg, "1", "s3://mlflow/1", 100)
    units = PB.build_worker_unit_manifests(*args, cfg, "1", "s3://mlflow/1")
    pod = (units[2]["spec"]["template"]["spec"] if units
           else sd["spec"]["predictors"][0]["componentSpecs"][0]["spec"])
    (c,) = pod["containers"]
    conf = tapp.config_from_args(tapp.build_arg_parser().parse_args(c["args"]))
    assert conf.mesh_shape == cfg.cuda.mesh_shape

    class Reached(Exception):
        pass

    def key(*a, **kw):
        raise Reached  # the boot key: the engine's first tensor on the card

    cuda = types.SimpleNamespace(type="cuda")
    world = 1
    for n in conf.mesh_shape.values():
        world *= int(n)
    monkeypatch.setattr(TG, "resolve_device", lambda device=None: cuda)
    monkeypatch.setattr(parallel, "build_mesh",
                        lambda shape: pmesh.placement(shape, rank=0, world=world))
    monkeypatch.setattr(TG.prng, "key", key)
    lm = TL.LlamaConfig.llama2_7b(max_seq=32768 if "32k" in doc["spec"]["modelName"] else 4096)
    predictor = types.SimpleNamespace(causal_lm={
        "params": {"embed": types.SimpleNamespace(device=cuda, shape=(1, 1))}, "cfg": lm})
    metrics = tmetrics.ServerMetrics(meta["name"], "v1", meta["namespace"])
    with pytest.raises(Reached):
        tapp.make_gen_engine(predictor, conf, metrics)


def test_the_shipped_examples_land_their_fields():
    """Field names must really land (unknown keys would be refused, but a
    mistyped value silently defaults)."""
    ex = _examples(PORT)
    cfg = PC.OperatorConfig.from_spec(ex["llama-tpu.yaml"][0]["spec"])
    assert cfg.backend == "cuda" and cfg.cuda.topology == "h100-8"
    assert cfg.cuda.quantize == "int8kv" and cfg.cuda.prefill_chunk == 256
    assert cfg.cuda.mesh_shape == {"dp": 1, "tp": 8}
    assert cfg.thresholds.min_sample_count == 50
    assert cfg.thresholds.error_rate_floor == 0.005
    assert cfg.canary.rollback_on_failure is True and cfg.canary.warmup_requests == 20
    lc = PC.OperatorConfig.from_spec(ex["llama-longcontext.yaml"][0]["spec"])
    assert (lc.cuda.topology, lc.cuda.mesh_shape) == ("h100-16", {"sp": 4, "tp": 4})
    assert lc.cuda.sp_prefill_threshold == 8192
    tp4 = PC.OperatorConfig.from_spec(ex["llama-7b-tp4.yaml"][0]["spec"])
    assert (tp4.cuda.topology, tp4.cuda.mesh_shape) == ("h100-4", {"dp": 1, "tp": 4})


def _dockerfiles() -> list[Path]:
    return sorted((PORT / "deploy" / "docker").glob("Dockerfile.*"))


def test_every_dockerfile_copy_source_exists_and_names_the_port():
    assert [p.name for p in _dockerfiles()] == ["Dockerfile.operator", "Dockerfile.router",
                                                "Dockerfile.server"]
    for path in _dockerfiles():
        text = path.read_text()
        for line in text.splitlines():
            m = re.match(r"COPY\s+(?!--from)(.+)\s+\S+$", line.strip())
            if m:
                for src in m.group(1).split():
                    assert (REPO / src).exists(), f"{path.name}: COPY {src}"
        assert M.PORT in text, path.name
        entry = re.search(r"^ENTRYPOINT (.*)$", text, re.M).group(1)
        if path.name != "Dockerfile.router":
            assert entry == f'["python", "-m", "{M.PORT}.{path.name.split(".")[1]}"]'
    server = (PORT / "deploy" / "docker" / "Dockerfile.server").read_text()
    base = re.search(r"^FROM (\S+)", server, re.M).group(1)
    assert "cuda" in base and "devel" in base  # nvcc builds the kernels at first use


def test_the_images_are_the_ones_the_manifests_and_the_makefile_name():
    mk = (REPO / "Makefile").read_text()
    for target in ("torch-images:", "torch-operator-image:", "torch-server-image:",
                   "torch-router-image:"):
        assert target in mk, target
    dep = list(yaml.safe_load_all((PORT / "deploy" / "operator-deployment.yaml").read_text()))[0]
    image = dep["spec"]["template"]["spec"]["containers"][0]["image"]
    assert image == "tpumlops/torch-operator:latest" and "/torch-operator:" in mk
    assert PC.DEFAULT_SERVER_IMAGE == "tpumlops/torch-server:latest" and "/torch-server:" in mk


def test_the_package_data_ships_the_deploy_files():
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = data["tool"]["setuptools"]["package-data"][M.PORT]
    shipped = {p for pat in patterns for p in PORT.glob(pat)}
    deploy = {p for p in (PORT / "deploy").rglob("*") if p.is_file()}
    assert deploy and deploy <= shipped


def test_the_operator_import_closure_pulls_no_torch():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"from {M.PORT}.clients import kube_rest, mlflow_rest, prom_http, dataplane\n"
        f"from {M.PORT}.operator import runtime, telemetry, reconciler, builder, judge, "
        "__main__\n"
        f"from {M.PORT}.server import launch\n"
        "heavy = {'jax', 'jaxlib', 'numpy', 'torch', 'flax', 'aiohttp', 'kubernetes', 'kopf',"
        " 'mlflow', 'orbax', 'httpx'}\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "bad = sorted(new & heavy)\n"
        "assert not bad, f'operator closure pulls heavy deps: {bad}'\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
