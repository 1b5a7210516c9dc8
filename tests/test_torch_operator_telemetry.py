"""The port's ``operator/slo.py``, ``operator/telemetry.py``,
``operator/leader.py``, ``clients/chaos.py`` and ``utils/trace_stitch.py``
against the JAX package's.

- The JAX package's tests of these modules run against the port
  (``torch_transplant``): the SLO accounting and stitching halves of
  ``tests/test_journey.py``, ``tests/test_rollout_recorder.py`` (the gate
  journal and its telemetry), ``tests/test_faults.py`` (the fault
  injector, telemetry on a deleted CR), ``tests/test_leader.py`` (two and
  more electors on a ``FakeKube``).
- SLO: the same scripted sample sequence through both packages'
  ``SloTracker`` and ``collect_samples`` gives equal evaluations.
- Telemetry: the family inventory is the reference's (names, types, label
  names, bucket bounds); one scripted control-plane run (canary, SLO,
  anomaly verdicts, mux moves, autoscaler) through both packages'
  reconcilers feeds each package's ``OperatorTelemetry``, and the two
  expositions, parsed with ``prometheus_client``'s parser (in the test
  only), are equal sample for sample; ``serve()``'s endpoints answer alike.
"""

from __future__ import annotations

import dataclasses
import json
import math
import socket
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from importlib import import_module

import pytest
from prometheus_client.parser import text_string_to_metric_families

import test_metrics_contract as REF_CONTRACT
import torch_transplant as TT

PORT = TT.PORT

# -- the JAX package's tests, on the port ---------------------------------------

_journey = TT.transplant("test_journey", vocabulary=True)
TT.export(_journey, globals(), [n for n in sorted(vars(_journey))
                                if n.startswith(("test_slo_", "test_stitch_",
                                                 "test_filter_request"))], tag="journey")
_recorder = TT.transplant("test_rollout_recorder", vocabulary=True)
TT.export(_recorder, globals(), [n for n in sorted(vars(_recorder)) if n.startswith("test_")],
          tag="recorder")
_faults = TT.transplant("test_faults", vocabulary=True)
TT.export(_faults, globals(), [n for n in sorted(vars(_faults)) if n.startswith("test_")],
          tag="faults")
_leader = TT.transplant("test_leader", vocabulary=True)
TT.export(_leader, globals(), [n for n in sorted(vars(_leader)) if n.startswith("test_")],
          tag="leader")


class Pkg:
    def __init__(self, root: str):
        self.root = root
        for mod in ("clients.base", "clients.fakes", "operator.reconciler", "operator.slo",
                    "operator.telemetry", "operator.multiplexer", "operator.anomaly",
                    "operator.rollout_recorder", "utils.clock", "utils.config"):
            setattr(self, mod.split(".")[1], import_module(f"{root}.{mod}"))


REF, PRT = Pkg("tpumlops"), Pkg(PORT)


# -- SLO ----------------------------------------------------------------------------

_SLO_SPECS = [
    {"ttftP99Ms": 200, "itlP99Ms": 40, "availabilityPct": 99.0, "windowMinutes": 1},
    {"ttftP99Ms": 50, "availabilityPct": 95.0, "windowMinutes": 1},
    {"itlP99Ms": 10, "availabilityPct": 99.9, "windowMinutes": 2},
]


def _script(seed: int):
    """(wall, model metrics kwargs, engine metrics kwargs) a step."""
    import random

    rng = random.Random(seed)
    wall = 1000.0
    for _ in range(60):
        wall += rng.choice((1.0, 5.0, 17.5))
        model = {} if rng.random() < 0.15 else {
            "request_count": rng.choice((0.0, 3.0, 40.0)),
            "error_rate": rng.choice((None, 0.0, 0.004, 0.2)),
            "latency_p95": 0.1, "latency_avg": 0.05}
        engine = {"ttft_p99_s": rng.choice((None, 0.03, 0.12, 0.4)),
                  "itl_p99_s": rng.choice((None, 0.005, 0.02, 0.09))}
        yield wall, model, engine


@pytest.mark.parametrize("which", range(len(_SLO_SPECS)))
def test_slo_evaluations_equal_the_reference_over_a_scripted_sequence(which):
    out = []
    for pkg in (REF, PRT):
        spec = pkg.config.SloSpec.from_spec(_SLO_SPECS[which])
        tracker = pkg.slo.SloTracker()
        evals = []
        for wall, model, engine in _script(which):
            samples = pkg.slo.collect_samples(
                spec, pkg.base.ModelMetrics(**model) if model else None,
                pkg.base.EngineMetrics(**engine))
            for name in spec.slo_names:
                if name in samples:
                    good, observed = samples[name]
                    tracker.observe(name, wall, good, observed)
                ev = tracker.evaluate(name, wall, spec.window_minutes * 60.0,
                                      spec.availability_pct, pkg.slo.target_of(spec, name))
                rec = pkg.slo.SloRecord(wall=wall, slo=name, state=ev.state or "within_budget",
                                        attainment=ev.attainment, burn_rate=ev.burn_rate,
                                        budget_remaining=ev.budget_remaining, target=ev.target,
                                        observed=ev.observed, samples=ev.samples)
                evals.append((sorted(samples.items()), ev.as_dict(), ev.state, rec.as_dict()))
        out.append(evals)
    assert out[1] == out[0]
    states = {e[2] for e in out[0]}
    assert {"within_budget", "budget_exhausted"} <= states or which == 2


# -- telemetry -------------------------------------------------------------------------


def _inventory(tel) -> dict:
    out = {}
    for fam in tel.registry.families:
        kind = type(fam).__name__.lower()
        out[fam.name] = (kind, tuple(fam.label_names))
    return out


def test_the_operator_families_are_the_reference_inventory():
    tel = PRT.telemetry.OperatorTelemetry()
    assert _inventory(tel) == REF_CONTRACT.EXPECTED_OPERATOR


def test_bucket_bounds_are_the_reference_buckets():
    ref = REF.telemetry.OperatorTelemetry()
    got = PRT.telemetry.OperatorTelemetry()
    for attr, metric in vars(ref).items():
        upper = getattr(metric, "_upper_bounds", None)
        if upper is not None:
            assert list(getattr(got, attr).buckets) == list(upper), attr


def _families(text: str, drop=()) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):  # prometheus_client's own gauges
            continue
        samples = sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value)
            for s in fam.samples
            if not s.name.endswith("_created") and s.name not in drop)
        out[fam.name] = (fam.type, fam.documentation, samples)
    return out


class _Observatory:
    """Scripted ring snapshots: three replicas, r1 slow from step ``from_step``."""

    def __init__(self, from_step: int):
        self.step, self.from_step = 0, from_step

    def __call__(self):
        slow = self.step >= self.from_step
        leg = {"r0": 20.0, "r1": 400.0 if slow else 21.0, "r2": 19.0}
        backends = {name: {"samples": [{"t": 100 + i, "n": 4, "p50_ms": ms, "p99_ms": ms * 1.5,
                                        "errors": 0, "failovers": 0} for i in range(4)]}
                    for name, ms in leg.items()}
        return {"replicas": {}, "router": {"backends": backends}}


def _control_plane_run(pkg: Pkg) -> tuple:
    """A CR with a canary, ``spec.slo``, ``spec.anomaly``, ``spec.multiplex``
    and ``spec.autoscaling`` on FakeKube; every outcome into the package's
    ``OperatorTelemetry``."""
    b, f = pkg.base, pkg.fakes
    tel = pkg.telemetry.OperatorTelemetry()
    kube, registry, metrics = f.FakeKube(), f.FakeRegistry(), f.FakeMetrics()
    clock = pkg.clock.FakeClock()
    cr = b.ObjectRef(namespace="models", name="llm", **b.MLFLOWMODEL)
    backend = "tpu" if pkg is REF else "cuda"
    topo = {"tpuTopology": "v5e-1"} if pkg is REF else {"gpuTopology": "h100-1"}
    kube.create(cr, {"apiVersion": "mlflow.nizepart.com/v1alpha1", "kind": "MlflowModel",
                     "metadata": {"name": "llm", "namespace": "models", "uid": "u"},
                     "spec": {"modelName": "llm", "modelAlias": "champion", "minioSecret": "m",
                              "backend": backend,
                              backend: {**topo, "snapshot": {"enabled": True, "dir": "/s"},
                                        "observability": {"timeseriesRing": 64}},
                              "observability": {"historyLimit": 64},
                              "slo": {"ttftP99Ms": 100, "itlP99Ms": 30,
                                      "availabilityPct": 99.0, "windowMinutes": 5},
                              "anomaly": {"driftPct": 0},
                              "multiplex": {"poolRef": "pool"},
                              "autoscaling": {"enabled": True, "minReplicas": 1,
                                              "maxReplicas": 3,
                                              "targetQueueDepthPerReplica": 2,
                                              "scaleUpStabilizationSeconds": 0,
                                              "scaleDownCooldownSeconds": 30}}})
    registry.register("llm", "1", "mlflow-artifacts:/1/a/artifacts/model")
    registry.set_alias("llm", "champion", "1")
    attached: dict = {}

    def attach(replica, uri, replace=False, wake_start_wall=None):
        attached[replica.name] = uri
        return {"snapshot_hash": "h" + replica.name}

    parked = {"llm": 0}
    mux = pkg.multiplexer.Multiplexer(
        "pool", [pkg.multiplexer.MuxReplica("r0", "http://r0"),
                 pkg.multiplexer.MuxReplica("r1", "http://r1")],
        attach=attach, ready=lambda r: {"model": attached.get(r.name)},
        parked=lambda: dict(parked), wall=lambda: 5000.0)
    obs = _Observatory(from_step=4)
    wall = [2000.0]
    rec = pkg.reconciler.Reconciler("llm", "models", kube, registry, metrics, clock,
                                    wall=lambda: wall[0], mux_pools={"pool": mux},
                                    ring_sources=obs)
    good = b.ModelMetrics(latency_p95=0.1, error_rate=0.0, latency_avg=0.05,
                          request_count=500)
    for step in range(12):
        obs.step = step
        parked["llm"] = 2 if step in (2, 3) else 0
        if step == 6:
            registry.register("llm", "2", "mlflow-artifacts:/1/b/artifacts/model")
            registry.set_alias("llm", "champion", "2")
        for v in ("v1", "v2"):
            metrics.set_metrics("llm", v, "models", good)
            metrics.set_engine_metrics("llm", v, "models", b.EngineMetrics(
                queue_depth=(7 if step < 3 else 0),
                ttft_p99_s=(0.05, 0.3)[step % 2], itl_p99_s=(0.01, 0.05)[step % 3 == 0]))
        out = rec.reconcile(kube.get(cr))
        tel.record_outcome("models", "llm", out, 0.001 * (step + 1))
        if step == 5:
            tel.record_failure("models", "llm", 0.25)
        tel.set_resource_count(1)
        wall[0] += 31.0
        clock.advance(31.0)
    return tel, kube.get(cr).get("status") or {}


# Measured walls: the rollout's (its sum) and each step component's (the
# buckets it lands in and the sum; its count is compared).
_WALLS = ("tpumlops_operator_rollout_duration_seconds_sum",
          "tpumlops_operator_step_component_seconds_bucket",
          "tpumlops_operator_step_component_seconds_sum")


def test_one_control_plane_run_exposes_the_same_samples():
    ref_tel, ref_status = _control_plane_run(REF)
    got_tel, got_status = _control_plane_run(PRT)
    drop = _WALLS
    want = _families(ref_tel.exposition().decode(), drop)
    got = _families(got_tel.exposition().decode(), drop)
    assert got == want
    # The run reached every family the slice ports.
    names = {s[0] for _, _, samples in got.values() for s in samples}
    for fam in ("tpumlops_operator_slo_attainment", "tpumlops_operator_slo_burn_rate",
                "tpumlops_operator_slo_error_budget_remaining",
                "tpumlops_operator_mux_moves_total", "tpumlops_operator_anomaly_active",
                "tpumlops_operator_anomaly_events_total", "tpumlops_operator_gate_margin",
                "tpumlops_operator_autoscale_replicas", "tpumlops_operator_events_total"):
        assert fam in names, fam
    kinds = {h["kind"] for h in got_status.get("history") or []}
    assert {"slo", "anomaly", "mux", "gate"} <= kinds, kinds
    # forget() drops every series of the CR in both.
    for tel in (ref_tel, got_tel):
        tel.forget("models", "llm")
    assert _families(got_tel.exposition().decode(), _WALLS) == \
        _families(ref_tel.exposition().decode(), _WALLS)
    assert 'name="llm"' not in got_tel.exposition().decode()


def test_the_exposition_writes_labels_sorted_as_prometheus_client_does():
    for pkg in (REF, PRT):
        tel = pkg.telemetry.OperatorTelemetry()
        tel.record_failure("ns-a", "model-z", 0.02)
        text = tel.exposition().decode()
        assert 'tpumlops_operator_reconcile_total{name="model-z",namespace="ns-a",' \
               'result="error"} 1.0' in text
        assert 'tpumlops_operator_reconcile_seconds_bucket{le="0.05",name="model-z",' \
               'namespace="ns-a"} 1.0' in text


class _Stub(BaseHTTPRequestHandler):
    """A replica with its ring off and a router with one: what
    ``/debug/fleet-overview`` fetches."""

    def do_GET(self):  # noqa: N802
        if self.path == "/router/debug/timeseries":
            body = {"backends": {"r0": {"samples": [{"t": 1, "n": 2}]}}}
        elif self.path == "/router/fleet":
            body = {"backends": [{"name": "r0", "healthy": True, "circuit_opened": 0,
                                  "model": "m"}]}
        else:
            self.send_error(404)
            return
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_serve_answers_its_endpoints_as_the_reference_does():
    stub = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    base_stub = f"http://127.0.0.1:{stub.server_address[1]}"
    dead = f"http://127.0.0.1:{_free_port()}"
    sources = [{"name": "r0", "base_url": base_stub},
               {"name": "router", "kind": "router", "base_url": base_stub},
               {"name": "dark", "base_url": dead}]
    answers = []
    servers = []
    try:
        for pkg in (REF, PRT):
            tel, _ = _control_plane_run(pkg)
            journal = pkg.rollout_recorder.RolloutRecorder(capacity=16)
            port = _free_port()
            servers.append(tel.serve(port, addr="127.0.0.1", recorder=journal,
                                     fleet_trace_sources=lambda: sources))
            bare = _free_port()
            servers.append(tel.serve(bare, addr="127.0.0.1"))
            base = f"http://127.0.0.1:{port}"
            got = {}
            for path in ("/metrics", "/debug/spans", "/debug/rollouts",
                         "/debug/rollouts/trace?format=chrome",
                         "/debug/rollouts/trace?format=json", "/debug/rollouts/trace?format=x",
                         "/debug/fleet-overview", "/nope"):
                status, ctype, body = _get(base + path)
                if path == "/metrics":
                    body = _families(body.decode(), _WALLS)
                elif path == "/debug/spans":
                    body = sorted(json.loads(body)["spans"])
                elif path == "/debug/fleet-overview":
                    doc = json.loads(body)
                    doc["sources"]["dark"]["error"] = bool(doc["sources"]["dark"]["error"])
                    body = doc
                elif status == 200:
                    body = json.loads(body)
                got[path] = (status, ctype, body)
            for path in ("/debug/rollouts", "/debug/fleet-overview", "/debug/fleet-trace"):
                got["bare" + path] = _get(f"http://127.0.0.1:{bare}{path}")[0]
            answers.append(got)
    finally:
        for s in servers:
            s.shutdown()
        stub.shutdown()
    assert answers[1] == answers[0]
    ov = answers[1]["/debug/fleet-overview"][2]
    assert ov["sources"]["r0"] == {"kind": "replica", "base_url": base_stub, "timeseries": None}
    assert ov["sources"]["router"]["circuits"]["r0"]["model"] == "m"
    assert ov["models"]["models/llm"]["anomalies"]
    assert answers[1]["bare/debug/rollouts"] == 404


def test_remove_of_an_unknown_child_is_a_key_error():
    tel = PRT.telemetry.OperatorTelemetry()
    with pytest.raises(KeyError):
        tel.gate_margin.remove({"namespace": "a", "name": "b", "check": "c"})
    assert math.isfinite(tel.resources._children[()][0])
    assert dataclasses.is_dataclass(PRT.slo.SloRecord)


def _keepalive_walls(proxy_cls, each_response: bool) -> list:
    """Three requests on one keep-alive connection through a proxy whose
    connections are scripted slow: each request's wall in seconds."""
    import http.client
    import time

    class Ok(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):  # noqa: N802
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Ok)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    proxy = proxy_cls(srv.server_address[1])
    try:
        if each_response:
            proxy.inject_slow(0.2, times=4, each_response=True)
        else:
            proxy.inject_slow(0.2, times=4)
        conn = http.client.HTTPConnection("127.0.0.1", proxy.port, timeout=10)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            conn.request("GET", "/")
            assert conn.getresponse().read() == b"ok"
            walls.append(time.perf_counter() - t0)
        conn.close()
        return walls
    finally:
        proxy.stop()
        srv.shutdown()


def test_chaos_proxy_holds_a_connections_first_response_as_the_reference_does():
    ref_chaos = import_module("tpumlops.clients.chaos")
    port_chaos = import_module(f"{PORT}.clients.chaos")
    for mod in (ref_chaos, port_chaos):
        walls = _keepalive_walls(mod.ChaosProxy, each_response=False)
        assert walls[0] >= 0.2 and max(walls[1:]) < 0.15, (mod.__name__, walls)


def test_chaos_proxy_holds_each_response_when_asked():
    port_chaos = import_module(f"{PORT}.clients.chaos")
    walls = _keepalive_walls(port_chaos.ChaosProxy, each_response=True)
    assert min(walls) >= 0.2, walls
