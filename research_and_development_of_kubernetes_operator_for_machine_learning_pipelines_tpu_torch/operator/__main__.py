"""``python -m <package>_torch.operator`` — the operator process entrypoint
(the port's copy of the JAX package's ``operator/__main__.py``, with every
flag of its ``main``).

Wires the real REST clients (no cluster SDKs, no ``httpx``) into the runtime:
Kubernetes in-cluster auth, MLflow from ``MLFLOW_TRACKING_URI`` env (same
creds-secret convention as the reference,
``mlflow-operator-deployment.yaml:21-23``), and a per-URL-cached Prometheus
source honoring each CR's ``spec.prometheusUrl``.
"""

from __future__ import annotations

import argparse
import logging


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser("tpumlops-operator")
    ap.add_argument("--namespace", default="", help="watch one namespace (default all)")
    ap.add_argument(
        "--sync-interval",
        type=float,
        default=None,
        help="fallback resync poll (default 30s with the watch active — it "
        "only bounds staleness after a dropped watch event — or 5s under "
        "--no-watch, where the poll is the only reaction path)",
    )
    ap.add_argument(
        "--no-watch",
        action="store_true",
        help="disable the event-driven watch and rely on polling alone",
    )
    ap.add_argument(
        "--leader-elect",
        action="store_true",
        help="acquire a coordination.k8s.io Lease before reconciling, so "
        "replicas > 1 run active/standby instead of double-reconciling "
        "(the reference pins replicas: 1 and has no election)",
    )
    ap.add_argument(
        "--concurrent-reconciles",
        type=int,
        default=4,
        help="distinct CRs reconciled in parallel (one CR is never "
        "reconciled concurrently with itself); 1 = serial",
    )
    ap.add_argument(
        "--leader-elect-namespace",
        default="tpumlops-system",
        help="namespace of the election Lease",
    )
    ap.add_argument("--kube-url", default=None, help="API server URL (default in-cluster)")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument(
        "--metrics-port",
        type=int,
        default=8080,
        help="operator self-metrics /metrics (+ /debug/spans) listener; "
        "0 disables",
    )
    ap.add_argument(
        "--log-format",
        default="text",
        choices=["text", "json"],
        help="json: one JSON object per log line (machine-parseable)",
    )
    ap.add_argument(
        "--rollout-ring",
        type=int,
        default=0,
        help="per-CR rollout journal capacity (gate decisions + phase "
        "transitions, served at /debug/rollouts and "
        "/debug/rollouts/trace on the metrics listener); 0 disables — "
        "no recorder object is constructed at all",
    )
    ap.add_argument(
        "--fleet-trace-sources",
        default=None,
        help="wire GET /debug/fleet-trace on the metrics listener: inline "
        'JSON or a file path of [{"name", "base_url", "kind": '
        '"router"|"replica"}, ...] naming the fleet\'s trace endpoints '
        "(the native router runs in local/router mode today: no "
        "in-cluster router controller discovers them from the routing "
        "manifest yet); unset = the endpoint 404s",
    )
    args = ap.parse_args(argv)

    from ..utils.logging import configure as configure_logging

    configure_logging(
        level=getattr(logging, args.log_level.upper()),
        json_format=args.log_format == "json",
    )

    from ..clients.dataplane import DataPlaneWarmup
    from ..clients.kube_rest import KubeRestClient
    from ..clients.mlflow_rest import MlflowRestClient
    from ..clients.prom_http import PrometheusSource
    from .leader import LeaderElector
    from .rollout_recorder import RolloutRecorder
    from .runtime import CrWatcher, DeploymentWatcher, OperatorRuntime
    from .telemetry import OperatorTelemetry

    if args.sync_interval is None:
        args.sync_interval = 5.0 if args.no_watch else 30.0

    kube = KubeRestClient(base_url=args.kube_url)
    registry = MlflowRestClient()
    telemetry = OperatorTelemetry()
    recorder = (
        RolloutRecorder(capacity=args.rollout_ring)
        if args.rollout_ring > 0
        else None
    )
    fleet_trace_sources = None
    if args.fleet_trace_sources:
        import json as _json
        import os as _os

        raw = args.fleet_trace_sources
        if _os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        try:
            specs = _json.loads(raw)
        except _json.JSONDecodeError as e:
            raise SystemExit(
                f"--fleet-trace-sources is not valid JSON: {e}"
            ) from e
        if not isinstance(specs, list):
            raise SystemExit(
                "--fleet-trace-sources must be a JSON list of "
                '{"name", "base_url", "kind"} objects'
            )
        fleet_trace_sources = lambda: specs  # noqa: E731
    # The same source list drives the anomaly observatory: ring
    # snapshots for CRs with spec.anomaly, and /debug/fleet-overview.
    ring_sources = None
    if fleet_trace_sources is not None:
        from .anomaly import ring_sources_from

        ring_sources = ring_sources_from(fleet_trace_sources)
    if args.metrics_port:
        telemetry.serve(
            args.metrics_port,
            recorder=recorder,
            fleet_trace_sources=fleet_trace_sources,
        )

    sources: dict[str, PrometheusSource] = {}

    def metrics_factory(url: str) -> PrometheusSource:
        if url not in sources:
            sources[url] = PrometheusSource(url)
        return sources[url]

    import signal
    import threading

    class _Session:
        """One reconciling session: a fresh runtime + watchers.

        Fresh per leadership round on purpose: ``OperatorRuntime.stop``
        is terminal (its stop event is never cleared), and all durable
        state lives in CR status anyway — a regained leadership resumes
        exactly like an operator restart would.
        """

        def __init__(self):
            self.runtime = OperatorRuntime(
                kube=kube,
                registry=registry,
                metrics_factory=metrics_factory,
                warmup=DataPlaneWarmup(),
                namespace=args.namespace,
                sync_interval_s=args.sync_interval,
                telemetry=telemetry,
                recorder=recorder,
                max_concurrent_reconciles=args.concurrent_reconciles,
                ring_sources=ring_sources,
            )
            # Watchers start HERE, synchronously, so teardown can never
            # race a half-started serve thread into orphaning them.
            self.watchers = (
                []
                if args.no_watch
                else [
                    CrWatcher(self.runtime).start(),
                    DeploymentWatcher(self.runtime).start(),
                ]
            )
            self.thread: threading.Thread | None = None

        def serve_background(self):
            self.thread = threading.Thread(
                target=self.runtime.serve, daemon=True
            )
            self.thread.start()

        def teardown(self, drain_s: float = 0.0):
            # Leadership loss passes the election's takeover grace (one
            # renew interval): an in-flight reconcile finishing its patch
            # is fine inside the grace, a dual writer past it is not.
            self.runtime.stop(drain_s=drain_s)
            # Signal both before joining either: each stop() may wait out
            # a 15s blocked watch read, and those waits must overlap.
            for w in self.watchers:
                w._stop.set()
            for w in self.watchers:
                w.stop()
            if self.thread is not None:
                self.thread.join(timeout=30)

    if args.leader_elect:
        # Reconcile only while holding the Lease.  SIGTERM releases the
        # lease so the successor takes over immediately instead of
        # waiting out the lease duration (rolling-update gap).
        elector = LeaderElector(kube, namespace=args.leader_elect_namespace)
        session: list[_Session] = []

        def on_started():
            s = _Session()
            session[:] = [s]
            s.serve_background()

        def on_stopped():
            if session:
                session.pop().teardown(drain_s=elector.renew_interval_s)

        def _terminate(signum, frame):
            logging.getLogger(__name__).info("SIGTERM: releasing lease")
            elector.stop()

        signal.signal(signal.SIGTERM, _terminate)
        try:
            elector.run(on_started, on_stopped)
        finally:
            elector.stop()
            elector.release()
    else:
        s = _Session()
        signal.signal(
            signal.SIGTERM, lambda *_: s.runtime.stop()
        )
        try:
            s.runtime.serve()
        finally:
            s.teardown()


if __name__ == "__main__":
    main()
