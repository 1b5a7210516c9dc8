"""Deployment manifest construction (the port's copy of the JAX
package's ``operator/builder.py``).

Two backends:

- ``seldon`` — byte-compatible with the reference's SeldonDeployment shape
  (``mlflow_operator.py:193-238``): ``MLFLOW_SERVER`` graph nodes, protocol
  ``kfserving``, predictor names ``v<version>``, weighted ``traffic``;
  byte-for-byte the JAX package's manifests.
- ``cuda``   — this package's first-party data plane: each predictor is the
  PyTorch server (``python -m <package>.server``) on one NVIDIA H100,
  requested as ``nvidia.com/gpu`` and placed by the GPU product label with
  a toleration for ``nvidia.com/gpu``.  Everything else is the JAX
  package's ``tpu`` manifest: names, labels, owner references, ports,
  probes, the metrics port, the compile-cache and snapshot volumes and the
  warm-pool and fleet-pool manifests.  The Seldon CR shape (predictor list
  + traffic weights) is retained so the promotion loop and metric identity
  (``deployment_name``/``predictor_name``/``namespace``,
  ``mlflow_operator.py:367``) are unchanged.

A unit of more than one card (one process a card) needs a launcher this
package does not have yet; the config refuses such topologies, and
:func:`build_worker_unit_manifests` builds none.

Owner references (``:158-169``) make the cluster GC the deployment when the
``MlflowModel`` CR is deleted.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

from ..utils.config import (
    GPU_TOPOLOGIES,
    MULTI_CARD_REFUSAL,
    CudaSpec,
    NotYetPorted,
    OperatorConfig,
)

SELDON_API_VERSION = "machinelearning.seldon.io/v1"
MLFLOWMODEL_API_VERSION = "mlflow.nizepart.com/v1alpha1"


def owner_reference(name: str, uid: str) -> list[dict[str, Any]]:
    """Reference ``mlflow_operator.py:162-169``."""
    return [
        {
            "apiVersion": MLFLOWMODEL_API_VERSION,
            "kind": "MlflowModel",
            "name": name,
            "uid": uid,
            "controller": True,
            "blockOwnerDeletion": True,
        }
    ]


def _seldon_predictor(
    version: str,
    model_uri: str,
    traffic: int,
    config: OperatorConfig,
    replicas: int | None = None,
) -> dict[str, Any]:
    """Reference-parity predictor (``mlflow_operator.py:195-222``).

    ``replicas`` is the autoscaler's override (None — the default — keeps
    the reference's fixed 1, byte-for-byte)."""
    return {
        "graph": {
            "name": f"classifier-{version}",
            "implementation": "MLFLOW_SERVER",
            "modelUri": model_uri,
            "envSecretRefName": config.minio_secret,
            "children": [],
        },
        "name": f"v{version}",
        "replicas": 1 if replicas is None else int(replicas),
        "traffic": traffic,
    }


# The module a pod runs: this package's server.
SERVER_MODULE = __name__.split(".")[0] + ".server"


def _topology_info(config: OperatorConfig):
    info = GPU_TOPOLOGIES.get(config.cuda.topology)
    if info is None:
        raise ValueError(
            f"unknown gpuTopology {config.cuda.topology!r}; "
            f"known: {sorted(GPU_TOPOLOGIES)}"
        )
    return info


def _single_card(config: OperatorConfig):
    """The topology's facts, refusing a unit of more than one card."""
    info = _topology_info(config)
    if info.cards > 1:
        raise NotYetPorted(
            f"spec.cuda.gpuTopology {config.cuda.topology!r}: {MULTI_CARD_REFUSAL}"
        )
    return info


def _cuda_pod_spec(
    version: str,
    model_uri: str,
    config: OperatorConfig,
    deployment_name: str,
    namespace: str,
) -> dict[str, Any]:
    """Pod spec of a GPU predictor: the JAX package's ``_tpu_pod_spec`` with
    this package's server command, an ``nvidia.com/gpu`` request, the GPU
    product nodeSelector and its toleration, and no ``JAX_PLATFORMS``."""
    cuda: CudaSpec = config.cuda
    info = _single_card(config)
    container = {
        "name": f"tpu-server-{version}",
        "image": config.server_image,
        "command": ["python", "-m", SERVER_MODULE],
        "args": [
            "--model-uri", model_uri,
            "--model-name", config.model_name,
            "--predictor-name", f"v{version}",
            "--deployment-name", deployment_name,
            "--namespace", namespace,
            "--mesh-shape", json.dumps(dict(cuda.mesh_shape)),
            "--dtype", cuda.dtype,
            "--max-batch-size", str(cuda.max_batch_size),
            "--max-batch-delay-ms", str(cuda.max_batch_delay_ms),
            "--compile-cache-dir", cuda.compile_cache_dir or "",
            "--quantize", cuda.quantize,
            "--prefill-chunk", str(cuda.prefill_chunk or 0),
            "--prefill-batch", str(cuda.prefill_batch),
            "--prefill-token-budget", str(cuda.prefill_token_budget),
            "--sp-prefill-threshold", str(cuda.sp_prefill_threshold),
            "--prefix-cache", "1" if cuda.prefix_cache.enabled else "0",
            "--prefix-cache-budget-mb", str(cuda.prefix_cache.budget_mb),
            "--prefix-cache-chunk", str(cuda.prefix_cache.chunk_tokens),
            "--speculative", "1" if cuda.speculative.enabled else "0",
            "--speculative-draft-tokens", str(cuda.speculative.draft_tokens),
            "--speculative-ngram-min", str(cuda.speculative.ngram_min),
            "--speculative-ngram-max", str(cuda.speculative.ngram_max),
            "--speculative-adaptive", "1" if cuda.speculative.adaptive else "0",
            "--trace-ring", str(cuda.observability.trace_ring),
        ],
        "env": [
            {"name": "TPU_TOPOLOGY", "value": cuda.topology},
            {
                "name": "JAX_COMPILATION_CACHE_DIR",
                "value": cuda.compile_cache_dir or "",
            },
        ],
        "ports": [
            {"name": "http", "containerPort": 9000},
            {"name": "metrics", "containerPort": 6000},
        ],
        "resources": {
            # per-host request (one host: the whole unit)
            "limits": {"nvidia.com/gpu": str(info.cards_per_host)},
            "requests": {"nvidia.com/gpu": str(info.cards_per_host)},
        },
        "readinessProbe": {
            "httpGet": {"path": "/v2/health/ready", "port": 9000},
            # Cold start: the first kernel build (nvcc) and the graph
            # captures take tens of seconds; generous window so a canary
            # isn't killed mid-build (SURVEY §7 hard part 3).
            "initialDelaySeconds": 10,
            "periodSeconds": 5,
            "failureThreshold": 60,
        },
    }
    # Admission-control / drain flags are appended ONLY when non-default:
    # unlike the always-emitted knobs above, these arrived later and
    # an unannotated CR's manifest must stay byte-for-byte identical.
    if cuda.decode_steps != 1:
        # Appended only when fused decode is on (same byte-identity
        # contract as the admission/drain flags): an unannotated CR's
        # manifest must stay byte-for-byte what it was.
        container["args"] += ["--decode-steps", str(cuda.decode_steps)]
    if cuda.unified_step:
        # Unified ragged super-step engine. Emitted only when true —
        # same byte-identity contract: an unannotated CR's manifest (and
        # the unifiedStep: false default) keeps the legacy split-program
        # engine byte-for-byte.
        container["args"] += ["--unified-step", "1"]
    if cuda.admission_queue_budget > 0:
        container["args"] += [
            "--admission-queue-budget", str(cuda.admission_queue_budget),
        ]
    if cuda.drain_grace_s != 20.0:
        container["args"] += [
            "--drain-grace-seconds", str(cuda.drain_grace_s),
        ]
    if cuda.prefix_cache.l2_budget_mb > 0:
        # Host-RAM second prefix-cache tier. Appended only when a budget
        # is set — same byte-identity contract as the flags above.
        container["args"] += [
            "--prefix-cache-l2-budget-mb", str(cuda.prefix_cache.l2_budget_mb),
        ]
    if cuda.slo_class:
        # Priority admission classes (spec.sloClass). Appended only when
        # a default class is set — same byte-identity contract.
        container["args"] += ["--slo-class", cuda.slo_class]
    if cuda.preemption:
        # Mid-decode preemption of lower-class slots. Appended only when
        # enabled — same byte-identity contract.
        container["args"] += ["--preemption", "1"]
    if cuda.observability.device_telemetry:
        # Appended only when enabled (same byte-identity contract as the
        # admission/drain flags): an unannotated CR's manifest must stay
        # byte-for-byte what it was before the device telemetry layer.
        container["args"] += ["--device-telemetry", "1"]
    if cuda.observability.timeseries_ring > 0:
        # Per-second serving time-series ring (the anomaly detector's
        # input plane).  Appended only when sized — same byte-identity
        # contract.
        container["args"] += [
            "--timeseries-ring", str(cuda.observability.timeseries_ring)
        ]
    if cuda.snapshot.enabled:
        # Pre-baked weight snapshots (scale-to-zero fast restore).
        # Appended only when enabled — same byte-identity contract.  The
        # snapshot dir is node-local like the kernel cache: a woken pod on
        # the same host restores without re-downloading or re-quantizing.
        container["args"] += ["--snapshot-dir", cuda.snapshot.dir]
    if config.minio_secret:
        container["envFrom"] = [{"secretRef": {"name": config.minio_secret}}]
    pod: dict[str, Any] = {}
    if cuda.drain_grace_s != 20.0:
        # The drain is only lossless if kubelet lets it finish: pod
        # termination grace must cover the endpoint-removal lag (3s
        # --drain-s default) + the in-flight drain window + margin, or
        # Kubernetes' default 30s grace SIGKILLs the server mid-drain
        # and drops exactly the requests the protocol exists to save.
        # Emitted only alongside the non-default flag (byte-identity).
        pod["terminationGracePeriodSeconds"] = int(cuda.drain_grace_s) + 15
    if cuda.compile_cache_dir:
        # Node-local persistent kernel cache (SURVEY §7 hard part 3):
        # hostPath outlives the pod, so a rescheduled canary — or the
        # *other* version's pod on the same node — loads built kernels
        # instead of rebuilding, keeping time-to-ready off the latency gate.
        container["volumeMounts"] = [
            {"name": "xla-cache", "mountPath": cuda.compile_cache_dir}
        ]
        pod["volumes"] = [
            {
                "name": "xla-cache",
                "hostPath": {
                    "path": "/var/cache/tpumlops/xla",
                    "type": "DirectoryOrCreate",
                },
            }
        ]
    if cuda.snapshot.enabled:
        # Snapshot store survives the pod the same way the kernel cache
        # does — a wake-from-zero on the same node restores locally.
        container.setdefault("volumeMounts", []).append(
            {"name": "weight-snapshots", "mountPath": cuda.snapshot.dir}
        )
        pod.setdefault("volumes", []).append(
            {
                "name": "weight-snapshots",
                "hostPath": {
                    "path": "/var/cache/tpumlops/snapshots",
                    "type": "DirectoryOrCreate",
                },
            }
        )
    return {
        **pod,
        "nodeSelector": {"nvidia.com/gpu.product": info.product},
        "tolerations": [
            {
                "key": "nvidia.com/gpu",
                "operator": "Exists",
                "effect": "NoSchedule",
            }
        ],
        "containers": [container],
    }


def _cuda_predictor(
    version: str,
    model_uri: str,
    traffic: int,
    config: OperatorConfig,
    deployment_name: str,
    namespace: str,
    replicas: int | None = None,
) -> dict[str, Any]:
    """First-party GPU predictor: this package's server on one H100."""
    return {
        "graph": {
            "name": f"tpu-server-{version}",
            "implementation": "TRITON_SERVER",  # pre-packaged V2-protocol slot
            "type": "MODEL",
            "modelUri": model_uri,
            "children": [],
        },
        "name": f"v{version}",
        # data-parallel copies of the predictor — DP in SURVEY §2.3's
        # inventory.  ``replicas`` is the autoscaler's live count
        # (None = spec.cuda.replicas, byte-for-byte the fixed topology).
        "replicas": (
            config.cuda.replicas if replicas is None else int(replicas)
        ),
        "traffic": traffic,
        "componentSpecs": [
            {
                "spec": _cuda_pod_spec(
                    version, model_uri, config, deployment_name, namespace
                )
            }
        ],
    }


def build_worker_unit_manifests(
    name: str,
    namespace: str,
    owner_uid: str,
    config: OperatorConfig,
    version: str,
    model_uri: str,
) -> list[dict[str, Any]]:
    """The objects of a unit of several hosts: none on one card (the
    Seldon-shaped componentSpecs cover it).  A larger unit is refused."""
    _single_card(config)
    return []


def build_warm_pool_manifests(
    name: str,
    namespace: str,
    owner_uid: str,
    config: OperatorConfig,
    version: str,
    model_uri: str,
) -> list[dict[str, Any]]:
    """Warm-pool Deployment for ``autoscaling.warmPoolSize`` replicas.

    Each pod runs the server in ``--warm-pool`` mode: booted, compile
    sweep run against the current version's snapshot geometry, holding
    NO weights — deliberately NotReady (no traffic routes there) until
    a ``POST /admin/attach``.  Even unattached, the pool keeps the
    node-local snapshot + kernel caches hot, so a wake-from-zero replica
    scheduled onto the same node restores instead of cold-loading.
    Returns ``[]`` when the pool size is 0 (byte-identity) or the
    backend is not ``cuda``.
    """
    size = config.autoscaling.warm_pool_size
    if size <= 0 or config.backend != "cuda":
        return []
    unit = f"{name}-warm-pool"
    labels = {
        "app": unit,
        "tpumlops/deployment": name,
        "tpumlops/role": "warm-pool",
    }
    pod_spec = _cuda_pod_spec(version, model_uri, config, name, namespace)
    pod_spec["containers"][0]["args"] += ["--warm-pool", "1"]
    return [
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {
                "name": unit,
                "namespace": namespace,
                "labels": labels,
                "ownerReferences": owner_reference(name, owner_uid),
            },
            "spec": {
                "replicas": size,
                "selector": {"matchLabels": {"app": unit}},
                "template": {
                    "metadata": {"labels": labels},
                    "spec": pod_spec,
                },
            },
        }
    ]


def fleet_pool_name(deployment_name: str, version: str, pool: str) -> str:
    """Name of one disaggregated pool's Deployment/Service."""
    return f"{deployment_name}-v{version}-{pool}"


def build_fleet_pool_manifests(
    name: str,
    namespace: str,
    owner_uid: str,
    config: OperatorConfig,
    version: str,
    model_uri: str,
    prefill_replicas: int | None = None,
    decode_replicas: int | None = None,
) -> list[dict[str, Any]]:
    """Disaggregated prefill/decode pools for one predictor version.

    Two Deployments (each pod a full server flagged with its
    ``--fleet-role``) plus a routed Service per pool — the router's
    backend table points at the Services, role-tagged, so the
    prefix-affinity ring covers the decode pool and the KV-export relay
    targets the prefill pool.  Replica counts default to ``spec.fleet``
    and are overridden by the per-pool autoscaler (``status.fleet``).
    Returns ``[]`` when disaggregation is off (byte-identity) or the
    backend is not ``cuda``.
    """
    fleet = config.fleet
    if not fleet.disaggregation or config.backend != "cuda":
        return []
    counts = {
        "prefill": (
            fleet.prefill_replicas
            if prefill_replicas is None
            else int(prefill_replicas)
        ),
        "decode": (
            fleet.decode_replicas
            if decode_replicas is None
            else int(decode_replicas)
        ),
    }
    owner = owner_reference(name, owner_uid)
    out: list[dict[str, Any]] = []
    for pool, replicas in counts.items():
        unit = fleet_pool_name(name, version, pool)
        labels = {
            "app": unit,
            "tpumlops/deployment": name,
            "tpumlops/predictor": f"v{version}",
            "tpumlops/fleet-role": pool,
        }
        pod_spec = _cuda_pod_spec(version, model_uri, config, name, namespace)
        args = pod_spec["containers"][0]["args"]
        # Pool replicas export their OWN metric identity
        # (predictor_name "v<ver>-prefill"/"-decode"): the per-pool
        # autoscaler reads each pool's saturation series separately,
        # and pool pods must not pollute the unified predictor's
        # summed signals.
        args[args.index("--predictor-name") + 1] = f"v{version}-{pool}"
        args += ["--fleet-role", pool]
        out.append(
            {
                "apiVersion": "apps/v1",
                "kind": "Deployment",
                "metadata": {
                    "name": unit,
                    "namespace": namespace,
                    "labels": labels,
                    "ownerReferences": owner,
                },
                "spec": {
                    "replicas": replicas,
                    "selector": {"matchLabels": {"app": unit}},
                    "template": {
                        "metadata": {"labels": labels},
                        "spec": pod_spec,
                    },
                },
            }
        )
        out.append(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {
                    "name": unit,
                    "namespace": namespace,
                    "labels": labels,
                    "ownerReferences": owner,
                },
                "spec": {
                    "selector": {"app": unit},
                    "ports": [
                        {"name": "http", "port": 9000, "targetPort": 9000},
                        {
                            "name": "metrics",
                            "port": 6000,
                            "targetPort": 6000,
                        },
                    ],
                },
            }
        )
    return out


def build_deployment(
    name: str,
    namespace: str,
    owner_uid: str,
    config: OperatorConfig,
    current_version: str,
    new_model_uri: str,
    traffic_current: int,
    previous_version: str | None = None,
    old_model_uri: str | None = None,
    traffic_prev: int = 0,
    replicas: int | None = None,
) -> dict[str, Any]:
    """Build the (Seldon-shaped) deployment manifest for a rollout state.

    Predictor order matches the reference: previous first, current second
    (``mlflow_operator.py:181-222``); at 100% only the current predictor
    remains (``:354-358``).

    ``replicas`` is the autoscaler-controlled count (``status.replicas``);
    it applies to EVERY predictor in the manifest — during a canary the
    topology is frozen, so old and new versions must serve at the same
    replica count or the promotion judge would compare a loaded predictor
    against an idle one.  None (autoscaling off) keeps the spec-declared
    topology byte-for-byte.
    """
    if previous_version is not None and old_model_uri is None:
        raise ValueError("old_model_uri required when previous_version is set")

    if config.backend == "cuda":
        make = lambda v, uri, t: _cuda_predictor(
            v, uri, t, config, name, namespace, replicas=replicas
        )
        protocol = "v2"
    else:
        make = lambda v, uri, t: _seldon_predictor(
            v, uri, t, config, replicas=replicas
        )
        protocol = "kfserving"  # reference :235

    predictors: list[dict[str, Any]] = []
    if previous_version is not None and traffic_prev > 0:
        predictors.append(make(previous_version, old_model_uri, traffic_prev))
    predictors.append(make(current_version, new_model_uri, traffic_current))

    # Rollout context as annotations: `kubectl get sdep -o yaml` then
    # explains the split without chasing the owning MlflowModel's status
    # (the spec.predictors weights say WHAT, these say WHICH rollout).
    annotations = {
        "tpumlops.dev/current-version": str(current_version),
        "tpumlops.dev/traffic-current": str(traffic_current),
    }
    if previous_version is not None and traffic_prev > 0:
        annotations["tpumlops.dev/previous-version"] = str(previous_version)
        annotations["tpumlops.dev/traffic-prev"] = str(traffic_prev)
    if replicas is not None:
        # Autoscaler context (absent = fixed topology, byte-for-byte):
        # `kubectl get sdep -o yaml` explains the replica count without
        # chasing the owning MlflowModel's status.
        annotations["tpumlops.dev/replicas"] = str(replicas)
    if config.backend == "cuda" and config.fleet.disaggregation:
        # Fleet routing contract (absent = byte-for-byte): whatever
        # fronts this predictor (the native router in local/router
        # mode, a mesh config elsewhere) reads the affinity/handoff
        # knobs and the pool Service names from HERE — the manifest is
        # the handoff point, exactly as traffic weights are.
        fleet = config.fleet
        annotations["tpumlops.dev/fleet-disaggregation"] = "true"
        annotations["tpumlops.dev/fleet-prefill-service"] = fleet_pool_name(
            name, current_version, "prefill"
        )
        annotations["tpumlops.dev/fleet-decode-service"] = fleet_pool_name(
            name, current_version, "decode"
        )
        if fleet.prefix_affinity.enabled:
            annotations["tpumlops.dev/fleet-affinity-tokens"] = str(
                fleet.prefix_affinity.tokens
            )
        if fleet.kv_transfer.enabled:
            annotations["tpumlops.dev/fleet-kv-retries"] = str(
                fleet.kv_transfer.retries
            )
    if config.backend == "cuda" and config.fleet.observability.journey_ring > 0:
        # Fleet trace plane (absent = byte-for-byte): RouterSync reads
        # this annotation and sizes the router's journey ring — valid
        # with or without disaggregation, same handoff contract as the
        # affinity/kv knobs above.
        annotations["tpumlops.dev/fleet-journey-ring"] = str(
            config.fleet.observability.journey_ring
        )
    if (
        config.backend == "cuda"
        and config.cuda.observability.timeseries_ring > 0
    ):
        # Router half of the anomaly observatory (absent = byte-for-
        # byte): RouterSync reads this annotation and sizes the router's
        # per-backend time-series ring to match the replicas' rings —
        # proxy-visible slowness (leg latency) lives only at the router.
        annotations["tpumlops.dev/fleet-timeseries-ring"] = str(
            config.cuda.observability.timeseries_ring
        )
    if config.backend == "cuda" and config.multiplex.enabled:
        # Multiplexing contract (absent = byte-for-byte): RouterSync
        # reads mux-models to arm model-aware routing, and the shared
        # pool's packer reads poolRef/weight — same manifest-as-handoff
        # pattern as the fleet knobs above.
        annotations["tpumlops.dev/mux-models"] = "1"
        annotations["tpumlops.dev/mux-pool"] = str(config.multiplex.pool_ref)
        annotations["tpumlops.dev/mux-weight"] = str(config.multiplex.weight)

    return {
        "apiVersion": SELDON_API_VERSION,
        "kind": "SeldonDeployment",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "annotations": annotations,
            "ownerReferences": owner_reference(name, owner_uid),
        },
        "spec": {
            "name": name,
            "protocol": protocol,
            "predictors": predictors,
        },
    }


def set_traffic(
    manifest: Mapping[str, Any], weights: Mapping[str, int]
) -> dict[str, Any]:
    """Return a copy of ``manifest`` with predictor traffic set from
    ``weights`` (predictor name -> percent); reference ``:319-327``."""
    import copy

    out = copy.deepcopy(dict(manifest))
    for predictor in out["spec"]["predictors"]:
        if predictor["name"] in weights:
            predictor["traffic"] = weights[predictor["name"]]
    return out
