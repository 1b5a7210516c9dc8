"""In-memory fakes for the three external systems (SURVEY.md §4).

The reference has no tests and no fakes; these are the seams the rebuild's
test strategy is built on:

- ``FakeRegistry``  — alias -> version map with mutation helpers, standing in
  for the MLflow registry.
- ``FakeKube``      — an in-memory object store with real Kubernetes
  semantics: resourceVersion bumping, 404 on missing, 409 on stale replace
  (the failure mode the reference provokes but never handles,
  ``mlflow_operator.py:256-269``), recorded events.
- ``FakeMetrics``   — scripted per-predictor metric readings to drive the
  promotion gate through promote / hold / fail / rollback paths.
"""

from __future__ import annotations

import copy
import queue as _queue
import threading
from typing import Any, Callable, Mapping

from .base import (
    AliasNotFound,
    Conflict,
    EngineMetrics,
    Event,
    ModelMetrics,
    ModelVersion,
    NotFound,
    ObjectRef,
    RegistryError,
    WatchEvent,
)


class FakeRegistry:
    """Dict-backed model registry: ``(model, alias) -> ModelVersion``."""

    def __init__(self):
        self._aliases: dict[tuple[str, str], str] = {}
        self._versions: dict[tuple[str, str], ModelVersion] = {}
        self.fail_next: Exception | None = None  # inject a transport error

    # -- test setup helpers -------------------------------------------------
    def register(self, model: str, version: str, source: str) -> None:
        self._versions[(model, version)] = ModelVersion(version=version, source=source)

    def set_alias(self, model: str, alias: str, version: str) -> None:
        if (model, version) not in self._versions:
            raise KeyError(f"register version {version} first")
        self._aliases[(model, alias)] = version

    def drop_alias(self, model: str, alias: str) -> None:
        self._aliases.pop((model, alias), None)

    # -- RegistryClient protocol -------------------------------------------
    def get_version_by_alias(self, model_name: str, alias: str) -> ModelVersion:
        if self.fail_next is not None:
            err, self.fail_next = self.fail_next, None
            raise err
        try:
            version = self._aliases[(model_name, alias)]
        except KeyError:
            raise AliasNotFound(
                f"alias {alias!r} not found on model {model_name!r}"
            ) from None
        return self._versions[(model_name, version)]

    def get_version(self, model_name: str, version: str) -> ModelVersion:
        try:
            return self._versions[(model_name, version)]
        except KeyError:
            raise RegistryError(
                f"model {model_name!r} has no version {version!r}"
            ) from None


class FakeKube:
    """In-memory Kubernetes custom-objects store.

    Keyed by ``(group, plural, namespace, name)``.  Implements optimistic
    concurrency: ``replace`` requires the body's ``metadata.resourceVersion``
    to match the stored one (or be absent), else raises ``Conflict`` — the
    same contract as a real API server, which the reference relies on at
    ``mlflow_operator.py:256-269``.
    """

    def __init__(self):
        self._objects: dict[tuple[str, str, str, str], dict] = {}
        self._rv_counter = 0
        self._lock = threading.RLock()
        self.events: list[tuple[str, Event]] = []  # (object name, event)
        self.apply_log: list[dict] = []  # every create/replace body, in order
        # Live watch subscriptions: each is a queue fed by every mutation.
        self._watchers: list[_queue.Queue] = []

    def _next_rv(self) -> str:
        self._rv_counter += 1
        return str(self._rv_counter)

    def _broadcast(self, ref: ObjectRef, type_: str, obj: dict) -> None:
        ev = WatchEvent(type=type_, object=copy.deepcopy(obj))
        for q in list(self._watchers):
            q.put((ref.group, ref.plural, ev))

    @staticmethod
    def _key(ref: ObjectRef) -> tuple[str, str, str, str]:
        return (ref.group, ref.plural, ref.namespace, ref.name)

    def get(self, ref: ObjectRef) -> dict:
        with self._lock:
            try:
                return copy.deepcopy(self._objects[self._key(ref)])
            except KeyError:
                raise NotFound(f"{ref.plural}/{ref.name}") from None

    def list(self, ref: ObjectRef) -> list[dict]:
        with self._lock:
            return [
                copy.deepcopy(obj)
                for (g, p, ns, _), obj in self._objects.items()
                if g == ref.group
                and p == ref.plural
                and (not ref.namespace or ns == ref.namespace)
            ]

    def create(self, ref: ObjectRef, body: Mapping[str, Any]) -> dict:
        with self._lock:
            key = self._key(ref)
            if key in self._objects:
                raise Conflict(f"{ref.plural}/{ref.name} already exists")
            obj = copy.deepcopy(dict(body))
            obj.setdefault("metadata", {})
            obj["metadata"]["name"] = ref.name
            obj["metadata"]["namespace"] = ref.namespace
            obj["metadata"]["resourceVersion"] = self._next_rv()
            obj["metadata"].setdefault("uid", f"uid-{ref.name}")
            # Real API-server semantics: generation starts at 1 and bumps
            # only on spec changes (status patches leave it alone).
            obj["metadata"]["generation"] = 1
            self._objects[key] = obj
            self.apply_log.append(copy.deepcopy(obj))
            self._broadcast(ref, "ADDED", obj)
            return copy.deepcopy(obj)

    def replace(self, ref: ObjectRef, body: Mapping[str, Any]) -> dict:
        with self._lock:
            key = self._key(ref)
            if key not in self._objects:
                raise NotFound(f"{ref.plural}/{ref.name}")
            stored_rv = self._objects[key]["metadata"]["resourceVersion"]
            sent_rv = dict(body).get("metadata", {}).get("resourceVersion")
            if sent_rv is not None and sent_rv != stored_rv:
                raise Conflict(
                    f"stale resourceVersion {sent_rv} (stored {stored_rv})"
                )
            obj = copy.deepcopy(dict(body))
            obj.setdefault("metadata", {})
            obj["metadata"]["name"] = ref.name
            obj["metadata"]["namespace"] = ref.namespace
            obj["metadata"]["resourceVersion"] = self._next_rv()
            obj["metadata"].setdefault("uid", self._objects[key]["metadata"].get("uid"))
            old_gen = self._objects[key]["metadata"].get("generation", 1)
            spec_changed = obj.get("spec") != self._objects[key].get("spec")
            obj["metadata"]["generation"] = old_gen + 1 if spec_changed else old_gen
            # status is a subresource: plain replace does not change it
            if "status" in self._objects[key]:
                obj["status"] = copy.deepcopy(self._objects[key]["status"])
            self._objects[key] = obj
            self.apply_log.append(copy.deepcopy(obj))
            self._broadcast(ref, "MODIFIED", obj)
            return copy.deepcopy(obj)

    def patch_status(self, ref: ObjectRef, status: Mapping[str, Any]) -> dict:
        with self._lock:
            key = self._key(ref)
            if key not in self._objects:
                raise NotFound(f"{ref.plural}/{ref.name}")
            obj = self._objects[key]
            merged = dict(obj.get("status") or {})
            merged.update(copy.deepcopy(dict(status)))
            obj["status"] = merged
            obj["metadata"]["resourceVersion"] = self._next_rv()
            self._broadcast(ref, "MODIFIED", obj)
            return copy.deepcopy(obj)

    def delete(self, ref: ObjectRef) -> None:
        with self._lock:
            key = self._key(ref)
            if key not in self._objects:
                raise NotFound(f"{ref.plural}/{ref.name}")
            gone = self._objects.pop(key)
            self._broadcast(ref, "DELETED", gone)

    def emit_event(self, ref: ObjectRef, event: Event) -> None:
        with self._lock:
            self.events.append((ref.name, event))

    def list_with_version(self, ref: ObjectRef) -> tuple[list[dict], str]:
        with self._lock:
            return self.list(ref), str(self._rv_counter)

    def watch(
        self,
        ref: ObjectRef,
        resource_version: str | None = None,
        timeout_s: int = 300,
        stop=None,
    ):
        """Generator of WatchEvents for mutations after subscription.

        Delivers only post-subscription events (the fake keeps no history,
        so ``resource_version`` is accepted but unused -- callers list
        first, exactly like against the real API server).  Ends when
        ``stop`` is set, mimicking the server closing an idle watch.
        """
        # Register eagerly (watch() is NOT a generator): the queue must be
        # live the moment watch() returns, or mutations between a caller's
        # list() and its first next() would be dropped — the fake keeps no
        # history to replay them from.
        q: _queue.Queue = _queue.Queue()
        with self._lock:
            self._watchers.append(q)
        return self._drain_watch(q, ref, stop)

    def _drain_watch(self, q: _queue.Queue, ref: ObjectRef, stop):
        try:
            while stop is None or not stop.is_set():
                try:
                    group, plural, ev = q.get(timeout=0.05)
                except _queue.Empty:
                    continue
                if group != ref.group or plural != ref.plural:
                    continue
                meta = ev.object.get("metadata") or {}
                if (
                    ref.namespace
                    and meta.get("namespace")
                    and meta["namespace"] != ref.namespace
                ):
                    continue
                yield ev
        finally:
            with self._lock:
                self._watchers.remove(q)

    # -- test helpers -------------------------------------------------------
    def event_reasons(self) -> list[str]:
        return [e.reason for _, e in self.events]


class FakeMetrics:
    """Scripted metrics source.

    Set a constant reading per predictor with ``set_metrics``, or a callable
    ``(window_s) -> ModelMetrics`` with ``set_series`` for time-varying
    behavior.  Unknown predictors return the reference's no-traffic shape:
    all gating metrics ``None`` (``mlflow_operator.py:372,:390,:404``).
    """

    def __init__(self):
        self._readings: dict[tuple[str, str, str], Callable[[int], ModelMetrics]] = {}
        self.query_log: list[tuple[str, str, str]] = []
        # Engine-saturation readings for the replica autoscaler
        # (mirrors PrometheusSource.engine_metrics).  Unknown predictors
        # return the all-None shape = signal unavailable, which the
        # autoscaler treats as "hold".
        self._engine: dict[
            tuple[str, str, str], Callable[[int], EngineMetrics]
        ] = {}
        self.engine_query_log: list[tuple[str, str, str]] = []

    def set_metrics(
        self, deployment: str, predictor: str, namespace: str, metrics: ModelMetrics
    ) -> None:
        self._readings[(deployment, predictor, namespace)] = lambda _w: metrics

    def set_series(
        self,
        deployment: str,
        predictor: str,
        namespace: str,
        fn: Callable[[int], ModelMetrics],
    ) -> None:
        self._readings[(deployment, predictor, namespace)] = fn

    def clear(self, deployment: str, predictor: str, namespace: str) -> None:
        self._readings.pop((deployment, predictor, namespace), None)

    def model_metrics(
        self,
        deployment_name: str,
        predictor_name: str,
        namespace: str,
        window_s: int = 60,
    ) -> ModelMetrics:
        self.query_log.append((deployment_name, predictor_name, namespace))
        fn = self._readings.get((deployment_name, predictor_name, namespace))
        if fn is None:
            return ModelMetrics()  # no traffic: latency/error metrics all None
        return fn(window_s)

    def set_engine_metrics(
        self, deployment: str, predictor: str, namespace: str, metrics: EngineMetrics
    ) -> None:
        self._engine[(deployment, predictor, namespace)] = lambda _w: metrics

    def set_engine_series(
        self,
        deployment: str,
        predictor: str,
        namespace: str,
        fn: Callable[[int], EngineMetrics],
    ) -> None:
        self._engine[(deployment, predictor, namespace)] = fn

    def engine_metrics(
        self,
        deployment_name: str,
        predictor_name: str,
        namespace: str,
        window_s: int = 60,
        slo_tails: bool = False,
    ) -> EngineMetrics:
        # ``slo_tails`` is accepted for interface parity (real sources
        # gate the p99 work on it); scripted readings carry whatever the
        # test set regardless.
        self.engine_query_log.append(
            (deployment_name, predictor_name, namespace)
        )
        fn = self._engine.get((deployment_name, predictor_name, namespace))
        if fn is None:
            return EngineMetrics()  # unavailable: autoscaler holds
        return fn(window_s)
