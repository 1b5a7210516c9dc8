"""Prometheus metrics with Seldon-executor-compatible identity (port of the
JAX package's ``server/metrics.py``, the families the V2 and /generate
routes record).

The operator's promotion gate queries these series by name
(``clients/prom_http.py`` in the JAX package):

- ``seldon_api_executor_client_requests_seconds`` histogram: p95 and mean
  latency and the request count;
- ``seldon_api_executor_server_requests_seconds_count`` with a ``code``
  label: the error rate (``code!="200"``), and ``service`` for feedback;

all keyed by ``{deployment_name, predictor_name, namespace}``.  Names,
types, label names and bucket bounds are the reference's, so the gate's
PromQL reads a port replica unchanged.  The card's machine has no
``prometheus_client``: the text exposition (format 0.0.4) is written here
with the standard library.
"""

from __future__ import annotations

import math
import threading

# Latency SLOs live in the 1 ms - 10 s range.
_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _num(x: float) -> str:
    """A sample value as Prometheus' Go client writes it."""
    x = float(x)
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    if math.isnan(x):
        return "NaN"
    return repr(x)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in pairs) + "}"


class _Family:
    def __init__(self, name: str, doc: str, label_names, lock):
        self.name, self.doc = name, doc
        self.label_names = tuple(label_names)
        self._lock = lock
        self._children: dict[tuple, list] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: labels {sorted(labels)}, "
                             f"expected {sorted(self.label_names)}")
        return tuple(str(labels[n]) for n in self.label_names)


class Counter(_Family):
    """A counter; ``name`` is the family name, the sample is ``name_total``."""

    def __init__(self, name, doc, label_names, lock):
        super().__init__(name, doc, label_names, lock)

    def inc(self, labels: dict, amount: float = 1.0) -> None:
        key = self._key(labels)
        with self._lock:
            child = self._children.setdefault(key, [0.0])
            child[0] += amount

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name}_total {self.doc}",
                 f"# TYPE {self.name}_total counter"]
        for key, (v,) in sorted(self._children.items()):
            lines.append(f"{self.name}_total{_labels(zip(self.label_names, key))} {_num(v)}")
        return lines


class Histogram(_Family):
    def __init__(self, name, doc, label_names, buckets, lock):
        super().__init__(name, doc, label_names, lock)
        self.buckets = tuple(float(b) for b in buckets) + (math.inf,)

    def observe(self, labels: dict, value: float) -> None:
        key = self._key(labels)
        with self._lock:
            child = self._children.setdefault(key, [[0] * len(self.buckets), 0.0])
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child[0][i] += 1
                    break
            child[1] += value

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.doc}", f"# TYPE {self.name} histogram"]
        for key, (counts, total) in sorted(self._children.items()):
            pairs = list(zip(self.label_names, key))
            running = 0
            for bound, c in zip(self.buckets, counts):
                running += c
                lines.append(f"{self.name}_bucket{_labels(pairs + [('le', _num(bound))])} "
                             f"{_num(running)}")
            lines.append(f"{self.name}_count{_labels(pairs)} {_num(running)}")
            lines.append(f"{self.name}_sum{_labels(pairs)} {_num(total)}")
        return lines


class ServerMetrics:
    def __init__(self, deployment_name: str, predictor_name: str, namespace: str):
        self.identity = {
            "deployment_name": deployment_name,
            "predictor_name": predictor_name,
            "namespace": namespace,
        }
        ident = list(self.identity)
        lock = self._lock = threading.Lock()
        self.client_requests = Histogram(
            "seldon_api_executor_client_requests_seconds",
            "Inference request latency (gate-compatible identity)",
            ident, _LATENCY_BUCKETS, lock)
        # A histogram, not a counter: the gate reads its _count series.
        self.server_requests = Histogram(
            "seldon_api_executor_server_requests_seconds",
            "Request durations by HTTP code (gate queries _count with code!='200')",
            ident + ["code", "service"], _LATENCY_BUCKETS, lock)
        self.batch_size = Histogram(
            "tpumlops_batch_size", "Dynamic-batcher batch sizes",
            ident, _BATCH_BUCKETS, lock)
        self.queue_seconds = Histogram(
            "tpumlops_queue_seconds", "Time requests spend in the batching queue",
            ident, _LATENCY_BUCKETS, lock)
        self.batch_run_seconds = Histogram(
            "tpumlops_batch_run_seconds",
            "run_batch (device dispatch) wall time per executed batch",
            ident, _LATENCY_BUCKETS, lock)
        self.pipeline_wait_seconds = Histogram(
            "tpumlops_pipeline_wait_seconds",
            "Wait behind the previous in-flight batch before materialize",
            ident, _LATENCY_BUCKETS, lock)
        self.compilations = Counter(
            "tpumlops_compilations",
            "New input signatures seen by the engine (compilations on the "
            "reference's XLA path)",
            ident, lock)
        self._families = (
            self.client_requests, self.server_requests, self.batch_size,
            self.queue_seconds, self.batch_run_seconds, self.pipeline_wait_seconds,
            self.compilations,
        )

    def observe_request(self, seconds: float, code: int = 200,
                        service: str = "predictions") -> None:
        # client_requests feeds the gate's latency percentiles: inference
        # traffic only.
        if service == "predictions":
            self.client_requests.observe(self.identity, seconds)
        self.server_requests.observe(
            {**self.identity, "code": str(code), "service": service}, seconds)

    def observe_batch(self, size: int, queue_seconds: float, run_seconds: float = 0.0,
                      pipeline_wait_seconds: float = 0.0) -> None:
        self.batch_size.observe(self.identity, size)
        self.queue_seconds.observe(self.identity, queue_seconds)
        self.batch_run_seconds.observe(self.identity, run_seconds)
        self.pipeline_wait_seconds.observe(self.identity, pipeline_wait_seconds)

    def inc_compilations(self) -> None:
        self.compilations.inc(self.identity)

    def render(self) -> bytes:
        lines: list[str] = []
        with self._lock:
            for fam in self._families:
                lines.extend(fam.render())
        return ("\n".join(lines) + "\n").encode()
