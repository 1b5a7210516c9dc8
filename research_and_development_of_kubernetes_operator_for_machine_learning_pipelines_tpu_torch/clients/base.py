"""Protocol interfaces and data types for the operator's external systems.

Shapes mirror what the reference consumes:

- ``ModelVersion``: the two fields the reference reads off MLflow's
  model-version object — ``version`` (``mlflow_operator.py:95``) and
  ``source`` (``:126,:132``).
- ``ModelMetrics``: the six quantities ``get_model_metrics`` computes from
  PromQL (``:363-417``), with ``None`` meaning "no traffic in the window"
  exactly as the reference does (``:387-390,:401-404``).
- ``KubeClient``: the five CustomObjectsApi verbs the reference uses
  (get/create/replace/patch-status/delete, ``:73,:241-282,:462-477``) plus
  event emission (``kopf.event`` call sites ``:90,:122,:332,:344,:361``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Protocol, runtime_checkable


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class ApiError(Exception):
    """Kubernetes API error with an HTTP status code."""

    def __init__(self, status: int, message: str = ""):
        super().__init__(f"{status}: {message}")
        self.status = status


class NotFound(ApiError):
    def __init__(self, message: str = "not found"):
        super().__init__(404, message)


class Conflict(ApiError):
    """409 — stale resourceVersion on replace.

    The reference propagates resourceVersion (``mlflow_operator.py:256-259``)
    but never catches the resulting 409s (SURVEY §5 race note); the rebuild's
    reconciler retries on Conflict.
    """

    def __init__(self, message: str = "conflict"):
        super().__init__(409, message)


class WatchExpired(ApiError):
    """410 Gone — the watch's resourceVersion fell out of etcd's history.

    The standard Kubernetes informer contract: the watcher must re-list to
    get a fresh resourceVersion and resume from there.
    """

    def __init__(self, message: str = "watch expired"):
        super().__init__(410, message)


class RegistryError(Exception):
    """MLflow registry unreachable or returned an unexpected error."""


class AliasNotFound(RegistryError):
    """Alias does not exist on the registered model.

    The reference treats *any* exception from
    ``get_model_version_by_alias`` as alias-missing
    (``mlflow_operator.py:58-62``); the rebuild distinguishes a definitive
    miss (this error -> error status + teardown) from transport errors
    (``RegistryError`` -> keep last-known-good deployment and retry).
    """


# ---------------------------------------------------------------------------
# Data types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelVersion:
    version: str
    source: str  # artifact URI as stored by MLflow, e.g. mlflow-artifacts:/1/abc/artifacts/model


@dataclass(frozen=True)
class ModelMetrics:
    """One predictor's metrics over a window (reference ``:363-417``)."""

    latency_p95: float | None = None
    error_responses: float = 0.0
    error_rate: float | None = None
    latency_avg: float | None = None
    request_count: float = 0.0
    feedback_request_count: float = 0.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "latency_95th": self.latency_p95,
            "error_responses": self.error_responses,
            "error_rate": self.error_rate,
            "latency_avg": self.latency_avg,
            "request_count": self.request_count,
            "feedback_request_count": self.feedback_request_count,
        }


@dataclass(frozen=True)
class EngineMetrics:
    """One predictor's engine-saturation signals over a window.

    The replica autoscaler's inputs (``operator/autoscaler.py``): queue
    depth summed across the predictor's replicas (instant gauge), and
    the p95 of admission wait / TTFT over the window.  ``None`` means
    the signal is unavailable (no such series, Prometheus unreachable,
    or no traffic in the window) — the autoscaler must treat that as
    "hold", never as zero load, or a metrics blackout would drain the
    fleet to minReplicas under full load.
    """

    queue_depth: float | None = None
    admission_wait_p95_ms: float | None = None
    ttft_p95_s: float | None = None
    # Requests held in the router's park buffer because the CR is at
    # zero replicas (tpumlops_router_parked_requests / GET
    # /router/parked).  THE wake signal for scale-to-zero: a parked
    # request is a user already waiting, so the autoscaler wakes
    # immediately on parked > 0.  None = no parking-capable source.
    parked: float | None = None
    # SLO tails (spec.slo): p99 of tpumlops_ttft_seconds /
    # tpumlops_itl_seconds over the window.  Filled only by sources
    # asked to serve the SLO tracker; as_dict omits them when None so
    # pre-SLO journal records (ScaleRecord.observed) stay byte-for-byte.
    ttft_p99_s: float | None = None
    itl_p99_s: float | None = None

    def as_dict(self) -> dict[str, Any]:
        out = {
            "queue_depth": self.queue_depth,
            "admission_wait_p95_ms": self.admission_wait_p95_ms,
            "ttft_p95_s": self.ttft_p95_s,
            "parked": self.parked,
        }
        if self.ttft_p99_s is not None:
            out["ttft_p99_s"] = self.ttft_p99_s
        if self.itl_p99_s is not None:
            out["itl_p99_s"] = self.itl_p99_s
        return out


@dataclass(frozen=True)
class WatchEvent:
    """One event off a Kubernetes watch stream.

    ``type`` is the API server's event type: ``ADDED`` / ``MODIFIED`` /
    ``DELETED``, plus ``BOOKMARK`` when ``allowWatchBookmarks`` is on
    (a resourceVersion checkpoint carrying no object change).
    """

    type: str
    object: Mapping[str, Any]


@dataclass(frozen=True)
class Event:
    """A Kubernetes Event attached to a CR (reference ``kopf.event`` sites)."""

    type: str  # "Normal" | "Warning"
    reason: str  # e.g. "TrafficIncrease", "PromotionFailed"
    message: str


@dataclass
class ObjectRef:
    group: str
    version: str
    namespace: str
    plural: str
    name: str

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version


# The two custom-resource kinds the operator touches.
MLFLOWMODEL = dict(group="mlflow.nizepart.com", version="v1alpha1", plural="mlflowmodels")
SELDONDEPLOYMENT = dict(
    group="machinelearning.seldon.io", version="v1", plural="seldondeployments"
)


# ---------------------------------------------------------------------------
# Protocols
# ---------------------------------------------------------------------------


@runtime_checkable
class RegistryClient(Protocol):
    """Model-registry lookups (MLflow in the reference)."""

    def get_version_by_alias(self, model_name: str, alias: str) -> ModelVersion:
        """Resolve alias -> ModelVersion.  Raises AliasNotFound / RegistryError."""
        ...

    def get_version(self, model_name: str, version: str) -> ModelVersion:
        ...


@runtime_checkable
class KubeClient(Protocol):
    """Minimal dynamic-object Kubernetes API (CustomObjectsApi equivalent)."""

    def get(self, ref: ObjectRef) -> Mapping[str, Any]:
        ...

    def create(self, ref: ObjectRef, body: Mapping[str, Any]) -> Mapping[str, Any]:
        ...

    def replace(self, ref: ObjectRef, body: Mapping[str, Any]) -> Mapping[str, Any]:
        ...

    def patch_status(self, ref: ObjectRef, status: Mapping[str, Any]) -> Mapping[str, Any]:
        ...

    def delete(self, ref: ObjectRef) -> None:
        ...

    def list(self, ref: ObjectRef) -> list[Mapping[str, Any]]:
        ...

    def emit_event(self, ref: ObjectRef, event: Event) -> None:
        ...


@runtime_checkable
class MetricsSource(Protocol):
    """Per-predictor serving metrics (Prometheus in the reference)."""

    def model_metrics(
        self,
        deployment_name: str,
        predictor_name: str,
        namespace: str,
        window_s: int = 60,
    ) -> ModelMetrics:
        ...
