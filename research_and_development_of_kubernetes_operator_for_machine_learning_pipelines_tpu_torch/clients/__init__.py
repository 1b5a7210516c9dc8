"""External-system clients: protocol interfaces, fakes, the native
router and the local plane (the port's copy of the JAX package's
``clients/``).

The reference talks to four external systems over the network — the
Kubernetes API server, the MLflow tracking server, Prometheus, and (via
Seldon) the inference data plane (SURVEY.md §1).  Here every dependency is
a small protocol (``base``); the operator core only sees the protocol.
This package has the in-memory fakes (``fakes``), the native canary
router (``router``, ``native/router.cc``), the local data plane of live
PyTorch servers behind it (``localplane``), the REST clients
(``kube_rest``, ``mlflow_rest``, ``prom_http``, ``dataplane``) on the
standard library's HTTP (``transport``), the fault injector and proxy
(``chaos``) and a loopback apiserver (``envtest``).
"""

from .base import (
    AliasNotFound,
    ApiError,
    Conflict,
    EngineMetrics,
    KubeClient,
    MetricsSource,
    ModelMetrics,
    ModelVersion,
    NotFound,
    RegistryClient,
    RegistryError,
)
from .fakes import FakeKube, FakeMetrics, FakeRegistry

__all__ = [
    "AliasNotFound",
    "ApiError",
    "Conflict",
    "EngineMetrics",
    "KubeClient",
    "MetricsSource",
    "ModelMetrics",
    "ModelVersion",
    "NotFound",
    "RegistryClient",
    "RegistryError",
    "FakeKube",
    "FakeMetrics",
    "FakeRegistry",
]
