"""Local data-plane harness: real servers + native router, no cluster (the
port's copy of the JAX package's ``clients/localplane.py``).

Drives a full unscripted canary where the predictors are live PyTorch
servers (``server.app.build_server`` on its standard-library HTTP server),
traffic flows through the compiled ``native/router.cc`` split, and the
gate reads the router's real histograms.  The pieces map to the
reference's production loop (``mlflow_operator.py:56-361``):

    reference            here
    ------------------   ------------------------------------------
    Seldon MLFLOW_SERVER server.app (the PyTorch data plane)
    Istio traffic split  native/router.cc smooth-WRR split
    Seldon executor      router's seldon_api_executor_* histograms
    kopf + API server    OperatorRuntime + FakeKube

A server runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.request

from .base import SELDONDEPLOYMENT, EngineMetrics, ModelMetrics
from .fakes import FakeKube
from .router import RouterSync, parse_prometheus_text

__all__ = [
    "free_port",
    "ModelServerHandle",
    "server_config",
    "start_model_server",
    "SyncingKube",
    "TrafficGenerator",
    "train_iris_pair",
    "relaxed_gate_spec",
    "LocalReplicaSet",
    "ReplicaSetMetrics",
    "PoolMetrics",
    "MuxRouterSync",
]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ModelServerHandle:
    """A live inference server on a daemon thread, stoppable."""

    def __init__(self, server, port: int, thread: threading.Thread | None = None):
        self.server = server
        self.port = port
        self.thread = thread

    def stop(self) -> None:
        # shutdown_all stops serve_forever, closes the listening socket
        # (a later client probing the port is refused, never left
        # hanging) and stops the engine.
        self.server.shutdown_all()
        if self.thread is not None:
            self.thread.join(timeout=10)


def server_config(
    cuda=None,
    *,
    model_name: str,
    predictor: str,
    deployment_name: str,
    namespace: str,
    port: int,
    device=None,
):
    """The server's configuration for one predictor: ``cuda`` (a
    ``CudaSpec``; its defaults when None) as the operator's manifest
    passes it on the command line, plus the metric identity."""
    from ..server.app import ServerConfig
    from ..utils.config import CudaSpec

    cuda = cuda if cuda is not None else CudaSpec()
    pc, spec, obs = cuda.prefix_cache, cuda.speculative, cuda.observability
    return ServerConfig(
        model_name=model_name,
        host="127.0.0.1",
        port=port,
        dtype=cuda.dtype,
        quantize=cuda.quantize,
        max_slots=cuda.max_slots or min(cuda.max_batch_size, 8),
        prefill_chunk=cuda.prefill_chunk,
        prefill_batch=cuda.prefill_batch,
        prefill_token_budget=cuda.prefill_token_budget,
        decode_steps=cuda.decode_steps,
        unified_step=cuda.unified_step,
        slo_class=cuda.slo_class,
        preemption=cuda.preemption,
        device=device,
        max_batch_size=cuda.max_batch_size,
        max_batch_delay_ms=cuda.max_batch_delay_ms,
        admission_queue_budget=cuda.admission_queue_budget,
        drain_grace_s=cuda.drain_grace_s,
        predictor_name=predictor,
        deployment_name=deployment_name,
        namespace=namespace,
        prefix_cache=pc.enabled,
        prefix_cache_budget_mb=pc.budget_mb,
        prefix_cache_chunk=pc.chunk_tokens if pc.enabled else None,
        prefix_cache_l2_budget_mb=pc.l2_budget_mb,
        speculative=spec.enabled,
        speculative_draft_tokens=spec.draft_tokens,
        speculative_ngram_min=spec.ngram_min,
        speculative_ngram_max=spec.ngram_max,
        speculative_adaptive=spec.adaptive,
        trace_ring=obs.trace_ring,
        timeseries_ring=obs.timeseries_ring,
        device_telemetry=obs.device_telemetry,
        snapshot_dir=cuda.snapshot.dir if cuda.snapshot.enabled else "",
        mesh_shape=dict(cuda.mesh_shape),
    )


def start_model_server(
    model_uri: str,
    predictor: str,
    port: int,
    model_name: str = "iris",
    deployment_name: str | None = None,
    namespace: str = "models",
    cuda=None,
    ready_timeout_s: float = 180.0,
    warmup: bool = True,
    wake_start_wall: float | None = None,
    device=None,
) -> ModelServerHandle:
    """Load ``model_uri`` and serve it on a daemon thread (``device``:
    ``cuda`` unless the caller names the CPU); raises TimeoutError if it
    never becomes ready.  ``wake_start_wall`` (unix seconds) marks when the
    controller decided to wake this replica — it anchors the server's
    ``tpumlops_cold_start_seconds`` ladder."""
    from ..server.app import _DTYPES, build_server
    from ..server.loader import load_predictor

    t_boot = time.time()
    config = server_config(
        cuda,
        model_name=model_name,
        predictor=predictor,
        deployment_name=deployment_name or model_name,
        namespace=namespace,
        port=port,
        device=device,
    )
    load_stats: dict = {}
    loaded = load_predictor(
        model_uri, quantize=config.quantize, device=device,
        dtype=_DTYPES[config.dtype], load_stats=load_stats,
        snapshot_dir=config.snapshot_dir or None, mesh_shape=config.mesh_shape,
    )
    server = build_server(
        loaded, config, warmup=warmup, load_stats=load_stats,
        boot_wall=wake_start_wall if wake_start_wall is not None else t_boot,
    )
    if wake_start_wall is not None:
        server.metrics.observe_cold_start("wake", t_boot - wake_start_wall)
    thread = threading.Thread(
        target=server.serve_forever, daemon=True, name=f"model-server-{port}"
    )
    thread.start()
    handle = ModelServerHandle(server, port, thread)
    deadline = time.monotonic() + ready_timeout_s
    while time.monotonic() < deadline:
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v2/health/ready", timeout=1
            )
            return handle
        except Exception:
            time.sleep(0.05)
    handle.stop()
    raise TimeoutError(f"model server on :{port} never became ready")


class SyncingKube(FakeKube):
    """FakeKube that plays the Seldon-controller/Istio role: every applied
    SeldonDeployment is pushed into its router as backends + weights.

    ``syncs`` maps deployment name -> RouterSync; a single RouterSync may
    be passed for the one-deployment case.
    """

    def __init__(self, syncs: "RouterSync | dict[str, RouterSync]"):
        super().__init__()
        self._syncs = syncs

    def _sync_for(self, name: str) -> RouterSync | None:
        if isinstance(self._syncs, dict):
            return self._syncs.get(name)
        return self._syncs

    def _push(self, ref, obj) -> None:
        if ref.plural == SELDONDEPLOYMENT["plural"]:
            sync = self._sync_for(ref.name)
            if sync is not None:
                sync.sync_manifest(obj)

    def create(self, ref, body):
        obj = super().create(ref, body)
        self._push(ref, obj)
        return obj

    def replace(self, ref, body):
        obj = super().replace(ref, body)
        self._push(ref, obj)
        return obj


class LocalReplicaSet:
    """The Deployment-controller role for the local plane: make predictor
    ``replicas`` REAL.

    In-cluster, a predictor's ``replicas`` count materializes as pods via
    Seldon/Kubernetes; here each replica is a live inference server on a
    local port.  ``sync_manifest`` diffs an applied SeldonDeployment
    against the running set: scale-up starts servers, scale-down (and
    predictor removal) runs the LOSSLESS drain protocol — the port is
    unlisted from :meth:`ports` first, ``POST /admin/drain`` finishes
    every in-flight sequence, and only then does the server stop — so
    the autoscaler's e2e can prove no request is ever dropped across a
    topology change.
    """

    def __init__(
        self,
        model_uris: dict,  # predictor name -> artifact uri
        model_name: str,
        namespace: str = "models",
        deployment_name: str | None = None,
        cuda=None,  # CudaSpec for every replica server
        drain_grace_s: float = 30.0,
        stop_linger_s: float = 0.5,
        warmup: bool = True,  # False: replicas boot fast, build lazily
        device=None,  # torch device of every replica (cuda unless named)
    ):
        self.model_uris = dict(model_uris)
        self.model_name = model_name
        self.namespace = namespace
        self.deployment_name = deployment_name or model_name
        self.cuda = cuda
        self.device = device
        self.drain_grace_s = drain_grace_s
        # Post-drain linger before the socket closes: clients that
        # snapshotted the port list just before it was unlisted get
        # their request answered (shed or served), never a connection
        # refusal — the local analogue of the --drain-s endpoint-removal
        # lag in production.
        self.stop_linger_s = stop_linger_s
        self.warmup = warmup
        self._lock = threading.RLock()
        self._replicas: dict[str, list[ModelServerHandle]] = {}
        # Every drain's final /admin/drain response, for the e2e's
        # zero-lost-requests proof.
        self.drain_reports: list[dict] = []
        self.scale_log: list[tuple[str, int]] = []  # (predictor, replicas)
        # Straggler verdicts (anomaly observatory, operator/anomaly.py):
        # ports to drain FIRST when the next scale-down picks victims.
        # Empty (the default) = the historical newest-last choice,
        # byte-identical.
        self.straggler_ports: frozenset = frozenset()

    def set_stragglers(self, ports) -> None:
        """Replace the straggler port set the next scale-down prefers
        as victims (a flagged replica should leave the fleet before a
        healthy one does)."""
        with self._lock:
            self.straggler_ports = frozenset(int(p) for p in ports)

    def ports(self) -> list[int]:
        """Live (non-draining) replica ports, all predictors."""
        with self._lock:
            return [
                h.port for handles in self._replicas.values() for h in handles
            ]

    def replica_ports(self, predictor: str) -> list[int]:
        """Live ports of ONE predictor (router backend resolution)."""
        with self._lock:
            return [h.port for h in self._replicas.get(predictor, [])]

    def replica_count(self, predictor: str | None = None) -> int:
        with self._lock:
            if predictor is not None:
                return len(self._replicas.get(predictor, []))
            return sum(len(v) for v in self._replicas.values())

    def sync_manifest(self, manifest: dict) -> None:
        spec = manifest.get("spec") or {}
        desired = {
            p.get("name"): int(p.get("replicas", 1))
            for p in spec.get("predictors") or []
        }
        with self._lock:
            current = {k: list(v) for k, v in self._replicas.items()}
        # Scale up / create first (capacity before teardown), then drain
        # down — the same order a rolling controller uses.
        for pred, n in desired.items():
            have = len(current.get(pred, []))
            # A predictor going 0 -> n is a WAKE: stamp the decision
            # instant so the replica's tpumlops_cold_start_seconds
            # ladder carries the controller-side wake stage too.
            wake = time.time() if have == 0 and n > 0 else None
            for _ in range(have, n):
                self._start(pred, wake_start_wall=wake)
            if n != have:
                self.scale_log.append((pred, n))
        for pred, handles in current.items():
            keep = desired.get(pred, 0)
            if self.straggler_ports and len(handles) > keep:
                # Stable sort pushes flagged ports into the drained
                # slice; with no verdicts the slice (and every drain
                # order) is exactly what it always was.
                handles = sorted(
                    handles, key=lambda h: h.port in self.straggler_ports
                )
            for handle in handles[keep:]:
                self._drain_stop(pred, handle)

    def _start(
        self, predictor: str, wake_start_wall: float | None = None
    ) -> None:
        uri = self.model_uris[predictor]
        handle = start_model_server(
            uri,
            predictor,
            free_port(),
            model_name=self.model_name,
            deployment_name=self.deployment_name,
            namespace=self.namespace,
            cuda=self.cuda,
            warmup=self.warmup,
            wake_start_wall=wake_start_wall,
            device=self.device,
        )
        with self._lock:
            self._replicas.setdefault(predictor, []).append(handle)

    def _drain_stop(self, predictor: str, handle: ModelServerHandle) -> None:
        # Unlist BEFORE draining: new traffic must stop targeting this
        # replica while its in-flight tail finishes.
        with self._lock:
            handles = self._replicas.get(predictor, [])
            if handle in handles:
                handles.remove(handle)
            if not handles:
                self._replicas.pop(predictor, None)
        report: dict = {"predictor": predictor, "port": handle.port}
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{handle.port}/admin/drain",
                data=json.dumps({"grace_s": self.drain_grace_s}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(
                req, timeout=self.drain_grace_s + 10
            ) as resp:
                report.update(json.loads(resp.read()))
        except Exception as e:  # drain endpoint gone/failed: record it
            report["error"] = str(e)
        self.drain_reports.append(report)
        if self.stop_linger_s > 0:
            time.sleep(self.stop_linger_s)
        handle.stop()

    def stop_all(self) -> None:
        with self._lock:
            handles = [
                h for hs in self._replicas.values() for h in hs
            ]
            self._replicas.clear()
        for h in handles:
            h.stop()


class ReplicaSetMetrics:
    """Engine-saturation source over live local replicas.

    The in-cluster shape is Prometheus scraping every replica pod and the
    autoscaler's PromQL summing ``tpumlops_engine_queue_depth`` across
    them (``PrometheusSource.engine_metrics``); here we scrape each
    replica's ``/metrics`` directly and do the same sum.  A replica that
    fails to answer is skipped; no replicas answering returns the
    all-None shape, which the autoscaler treats as "hold".
    ``model_metrics`` returns the no-traffic shape — the promotion gate
    is not part of the scaling loop this source serves.
    """

    _FAMILY = "tpumlops_engine_queue_depth"

    def __init__(self, ports, timeout: float = 2.0, router_admin=None):
        self._ports = ports  # Callable[[], list[int]]
        self._timeout = timeout
        # RouterAdmin | None: when given, each engine_metrics read also
        # reports the router's park-buffer depth — THE wake signal for a
        # predictor at zero replicas (no replica ports to scrape there).
        self._router_admin = router_admin

    def model_metrics(
        self, deployment_name, predictor_name, namespace, window_s=60
    ) -> ModelMetrics:
        return ModelMetrics()

    def engine_metrics(
        self, deployment_name, predictor_name, namespace, window_s=60,
        slo_tails=False,
    ) -> EngineMetrics:
        from .router import _histogram_quantile

        ident = {
            ("deployment_name", deployment_name),
            ("predictor_name", predictor_name),
            ("namespace", namespace),
        }
        total: float | None = None
        # Cumulative bucket sums across replicas for the SLO tails,
        # accumulated ONLY when the caller serves the SLO tracker
        # (local source: lifetime quantile, the PromQL rate() window is
        # Prometheus's job in-cluster).
        buckets: dict[str, dict[float, float]] = (
            {"tpumlops_ttft_seconds": {}, "tpumlops_itl_seconds": {}}
            if slo_tails
            else {}
        )
        for port in list(self._ports()):
            try:
                text = (
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=self._timeout,
                    )
                    .read()
                    .decode()
                )
            except Exception:
                continue  # replica mid-boot/mid-drain: partial sum
            for (name, labels), value in parse_prometheus_text(text).items():
                if name == self._FAMILY and ident <= labels:
                    total = (total or 0.0) + value
                elif buckets and name.endswith("_bucket"):
                    fam = name[: -len("_bucket")]
                    if fam in buckets and ident <= labels:
                        le = dict(labels).get("le")
                        if le is not None:
                            b = buckets[fam]
                            b[float(le)] = b.get(float(le), 0.0) + value
        parked = None
        if self._router_admin is not None:
            try:
                parked = float(self._router_admin.parked().get("parked", 0))
            except Exception:
                parked = None  # router unreachable: park signal unknown

        def p99(fam: str) -> float | None:
            b = buckets.get(fam) or {}
            if not b:
                return None
            return _histogram_quantile(
                0.99, sorted(b.items(), key=lambda x: x[0])
            )

        return EngineMetrics(
            queue_depth=total,
            parked=parked,
            ttft_p99_s=p99("tpumlops_ttft_seconds"),
            itl_p99_s=p99("tpumlops_itl_seconds"),
        )


class PoolMetrics:
    """Metrics of the models multiplexed onto one shared warm pool
    (``spec.multiplex``).

    A pool replica's metric identity is fixed at its boot, whichever model
    it holds, so the engine series of one model are those of the replicas
    that hold it NOW: ``holders(model_name)`` names their ports (the
    multiplexer's attached table).  ``engine_metrics`` sums their queue
    depth and, with ``slo_tails``, reads the TTFT / ITL p99 of their
    summed cumulative buckets (the replica's lifetime, as
    :class:`ReplicaSetMetrics` reads it); a model held nowhere reads
    all-None (unobservable, never a pass).  ``model_metrics`` is the
    ``gate`` source's (the router's histograms) or the no-traffic shape.
    """

    _FAMILIES = ("tpumlops_ttft_seconds", "tpumlops_itl_seconds")

    def __init__(self, holders, gate=None, timeout: float = 2.0):
        self._holders = holders  # Callable[[str], list[int]]
        self._gate = gate
        self._timeout = timeout

    def model_metrics(self, deployment_name, predictor_name, namespace, window_s=60):
        if self._gate is None:
            return ModelMetrics()
        return self._gate.model_metrics(deployment_name, predictor_name, namespace, window_s)

    def engine_metrics(self, deployment_name, predictor_name, namespace, window_s=60,
                       slo_tails=False) -> EngineMetrics:
        from .router import _histogram_quantile

        depth: float | None = None
        buckets: dict[str, dict[float, float]] = {f: {} for f in self._FAMILIES}
        for port in list(self._holders(deployment_name)):
            try:
                text = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=self._timeout
                ).read().decode()
            except Exception:
                continue
            for (name, labels), value in parse_prometheus_text(text).items():
                if name == ReplicaSetMetrics._FAMILY:
                    depth = (depth or 0.0) + value
                elif slo_tails and name.endswith("_bucket"):
                    fam = name[: -len("_bucket")]
                    le = dict(labels).get("le")
                    if fam in buckets and le is not None:
                        b = buckets[fam]
                        b[float(le)] = b.get(float(le), 0.0) + value

        def p99(fam: str) -> float | None:
            b = sorted(buckets[fam].items())
            if not b or b[-1][1] <= 0:
                return None
            return _histogram_quantile(0.99, b)

        return EngineMetrics(
            queue_depth=depth,
            ttft_p99_s=p99("tpumlops_ttft_seconds") if slo_tails else None,
            itl_p99_s=p99("tpumlops_itl_seconds") if slo_tails else None,
        )


class MuxRouterSync:
    """The endpoint sync of a multiplexed pool (``RouterSync``'s role for
    ``spec.multiplex``): whenever the multiplexer's attached table changes,
    PUT the router config with each backend's ``model`` so the router
    routes by model and releases that model's parked requests.

    ``backends`` maps a replica name to the (host, port) the router
    forwards to (a proxy's, where one stands in front); ``model_of(uri)``
    names the model an attached uri serves."""

    def __init__(self, router_admin, mux, backends: dict, model_of, namespace: str,
                 deployment: str, weight: int = 50, interval_s: float = 0.05):
        self.admin, self.mux = router_admin, mux
        self.backends = dict(backends)
        self.model_of = model_of
        self.namespace, self.deployment = namespace, deployment
        self.weight = int(weight)
        self.interval_s = float(interval_s)
        self._last: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def held(self) -> dict:
        return {r.name: (self.model_of(r.attached_uri) if r.attached_uri else "")
                for r in self.mux.replicas}

    def sync_once(self) -> None:
        held = self.held()
        if held == self._last:
            return
        self.admin.set_config(
            [{"name": n, "host": host, "port": port, "weight": self.weight,
              "model": held.get(n, "")}
             for n, (host, port) in self.backends.items()],
            namespace=self.namespace, deployment=self.deployment, mux_models=1,
        )
        self._last = held

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:
                pass  # router mid-restart: the next tick pushes again
            self._stop.wait(self.interval_s)

    def start(self) -> "MuxRouterSync":
        self._thread = threading.Thread(target=self._run, daemon=True, name="mux-sync")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class TrafficGenerator:
    """Continuous client traffic through the router (the gate needs live
    samples on both predictors; in production this is user traffic)."""

    def __init__(
        self,
        router_port: int,
        model_name: str = "iris",
        body: bytes | None = None,
        path: str = "infer",
    ):
        # ``path="generate"`` drives the continuous-batching causal-LM
        # endpoint instead — the router proxies (and records gate
        # histograms for) every model path the same way.
        self.url = f"http://127.0.0.1:{router_port}/v2/models/{model_name}/{path}"
        self.body = body or json.dumps(
            {
                "inputs": [
                    {
                        "name": "x",
                        "shape": [2, 4],
                        "datatype": "FP32",
                        "data": [5.1, 3.5, 1.4, 0.2, 6.7, 3.0, 5.2, 2.3],
                    }
                ]
            }
        ).encode()
        self._stop = threading.Event()
        self.sent = 0
        self.errors = 0

    def _loop(self):
        while not self._stop.is_set():
            try:
                req = urllib.request.Request(
                    self.url,
                    data=self.body,
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=2).read()
            except Exception:
                self.errors += 1  # 502s while a canary backend is dead, etc.
            self.sent += 1
            time.sleep(0.002)

    def __enter__(self):
        threading.Thread(target=self._loop, daemon=True).start()
        return self

    def __exit__(self, *exc):
        self._stop.set()


class DeploymentSyncWatcher:
    """Watch SeldonDeployments on a (real) API server and push each
    change's traffic split into the router — the role Seldon's controller
    + Istio play in-cluster, reduced to its data-plane essence.

    Unlike :class:`SyncingKube` (a FakeKube subclass that intercepts
    writes in-process), this consumes the apiserver's WATCH STREAM, so an
    operator talking to a real (or envtest) API server over HTTP gets its
    weight changes applied the same way a production controller would:
    asynchronously, from events.
    """

    def __init__(self, kube, sync: RouterSync, namespace: str = "models"):
        from .base import SELDONDEPLOYMENT, ObjectRef, WatchExpired

        self._kube = kube
        self._sync = sync
        self._ref = ObjectRef(namespace=namespace, name="", **SELDONDEPLOYMENT)
        self._WatchExpired = WatchExpired
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "DeploymentSyncWatcher":
        self._thread.start()
        return self

    def _run(self) -> None:
        rv = None
        while not self._stop.is_set():
            try:
                if rv is None:
                    items, rv = self._kube.list_with_version(self._ref)
                    for obj in items:
                        self._sync.sync_manifest(obj)
                for ev in self._kube.watch(
                    self._ref, resource_version=rv, timeout_s=5,
                    stop=self._stop,
                ):
                    rv = (ev.object.get("metadata") or {}).get(
                        "resourceVersion", rv
                    )
                    if ev.type in ("ADDED", "MODIFIED"):
                        self._sync.sync_manifest(ev.object)
            except self._WatchExpired:
                rv = None  # re-list
            except Exception:
                if not self._stop.is_set():
                    time.sleep(0.1)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


def train_iris_pair(root) -> dict[str, str]:
    """Two distinguishable sklearn iris models saved as v1/v2 artifacts —
    the canary pair used by both the e2e tests and the benchmark."""
    from pathlib import Path

    from sklearn.datasets import load_iris
    from sklearn.linear_model import LogisticRegression

    from ..server.loader import save_sklearn_model

    root = Path(root)
    X, y = load_iris(return_X_y=True)
    uris = {}
    for tag, model in {
        "1": LogisticRegression(max_iter=200).fit(X, y),
        "2": LogisticRegression(max_iter=500, C=0.5).fit(X, y),
    }.items():
        path = str(root / f"v{tag}")
        save_sklearn_model(path, model, "sklearn-linear")
        uris[tag] = path
    return uris


def relaxed_gate_spec(**canary_overrides) -> dict:
    """CR spec skeleton for local-plane canaries on live metrics.

    Generous latency tolerances: both versions are identical sklearn
    models on a loaded box — the gate must judge real jittery numbers
    without flaking; the error floor absorbs transient 502s at
    weight-switch instants.  Canary pacing fields come from the caller.
    """
    spec = {
        "modelName": "iris",
        "modelAlias": "prod",
        "monitoringInterval": 0.2,
        "thresholds": {
            "latencyP95": 5.0,
            "latencyAvg": 5.0,
            "errorRate": 1.0,
            "errorRateFloor": 0.5,
            "minSampleCount": 3,
        },
        "canary": {
            "step": 25,
            "stepInterval": 0.2,
            "attemptDelay": 0.15,
            "maxAttempts": 60,
            "initialTraffic": 25,
            "metricsWindow": 2,
        },
    }
    spec["canary"].update(canary_overrides)
    return spec
