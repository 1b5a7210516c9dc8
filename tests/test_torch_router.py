"""The port's ``clients/router.py`` and its ``native/router.cc`` against the
JAX package's.

``parse_prometheus_text`` and ``_histogram_quantile`` give the reference's
outputs on the same inputs; ``RouterSync`` pushes the same router config
from the same manifests; ``RouterMetricsSource`` reads the same gate
metrics from the same scrapes.  ``build_router`` compiles the port's own
copy of the router into ``build/native/`` at the repository root, and a
live router built from it splits traffic to a stub backend.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

import torch_operator_map as M
from tpumlops.clients import router as JR
from tpumlops.operator import builder as JB
from tpumlops.utils import config as JC
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (
    router as PR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.operator import (
    builder as PB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    metrics as PM,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    config as PC,
)

ROOT = Path(__file__).resolve().parents[1]


def _server_metrics_text() -> str:
    m = PM.ServerMetrics(deployment_name="iris", predictor_name="v2", namespace="models")
    for i, s in enumerate((0.0004, 0.003, 0.003, 0.02, 0.7, 12.0)):
        m.observe_request(s, code=200 if i % 3 else 500)
    return m.render().decode()


TEXTS = [
    "",
    "# HELP x a counter\n# TYPE x counter\nx 3\n",
    'a_bucket{le="0.1",predictor_name="v1"} 2\na_bucket{le="+Inf",predictor_name="v1"} 5\n',
    'b{path="/v2/models/x/infer",msg="say \\"hi\\", ok"} 1.5e-3\nb_total 7\n',
    'c{x="1"} NaN\nc{x="2"} +Inf\nc{x="3"} -Inf\n',
    "d{} 4\nd 5\n   \n",
]


@pytest.mark.parametrize("text", range(len(TEXTS) + 1))
def test_parse_prometheus_text_matches(text):
    t = TEXTS[text] if text < len(TEXTS) else _server_metrics_text()
    ref, got = JR.parse_prometheus_text(t), PR.parse_prometheus_text(t)
    assert json.dumps(sorted((k[0], sorted(k[1]), v) for k, v in got.items()), default=str) == \
        json.dumps(sorted((k[0], sorted(k[1]), v) for k, v in ref.items()), default=str)


BUCKETS = [
    [],
    [(float("inf"), 0.0)],
    [(0.01, 5.0), (float("inf"), 5.0)],
    [(0.001, 0.0), (0.01, 3.0), (0.1, 9.0), (float("inf"), 10.0)],
    [(0.001, 1.0), (0.0025, 1.0), (0.005, 4.0), (0.01, 4.0), (float("inf"), 40.0)],
]


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0])
@pytest.mark.parametrize("buckets", range(len(BUCKETS)))
def test_histogram_quantile_matches(q, buckets):
    b = BUCKETS[buckets]
    assert PR._histogram_quantile(q, b) == JR._histogram_quantile(q, b)


class _FakeAdmin:
    def __init__(self, texts=()):
        self.calls: list = []
        self.texts = list(texts)

    def set_config(self, backends, **kw):
        self.calls.append((backends, kw))

    def metrics_text(self):
        return self.texts[0]


def _manifests(builder, config_mod, backend: str):
    spec = {"modelName": "iris", "modelAlias": "prod", "minioSecret": "m"}
    if backend == "tpu":
        spec.update(backend="tpu", tpu={"tpuTopology": "v5e-1",
                                        "prefixCache": {"enabled": True},
                                        "snapshot": {"enabled": True},
                                        "observability": {"timeseriesRing": 30}},
                    fleet={"disaggregation": True, "observability": {"journeyRing": 64}})
    if config_mod is PC:
        spec = M.port_spec(spec)
    cfg = config_mod.OperatorConfig.from_spec(spec)
    out = []
    for cur, t, prev, tp, replicas in (("1", 100, None, 0, None), ("2", 10, "1", 90, None),
                                       ("2", 70, "1", 30, 0), ("2", 100, None, 0, 3)):
        out.append(builder.build_deployment(
            name="iris", namespace="models", owner_uid="u", config=cfg, current_version=cur,
            new_model_uri="s3://b/2", traffic_current=t, previous_version=prev,
            old_model_uri="s3://b/1" if prev else None, traffic_prev=tp, replicas=replicas))
    return out


@pytest.mark.parametrize("backend", ["seldon", "tpu"])
def test_router_sync_pushes_the_same_config(backend):
    ports = {"v1": 9101, "v2": 9102}
    ref_admin, port_admin = _FakeAdmin(), _FakeAdmin()
    ref_sync = JR.RouterSync(ref_admin, lambda p: ("127.0.0.1", ports[p]))
    port_sync = PR.RouterSync(port_admin, lambda p: ("127.0.0.1", ports[p]))
    for ref_m, port_m in zip(_manifests(JB, JC, backend), _manifests(PB, PC, backend)):
        ref_sync.sync_manifest(ref_m)
        port_sync.sync_manifest(port_m)
    assert port_admin.calls == ref_admin.calls
    assert [[b["weight"] for b in c[0]] for c in port_admin.calls] == \
        [[100], [90, 10], [0, 0], [100]]


def _gate_text(v1: tuple, v2: tuple) -> str:
    """Router histograms for two predictors: (bucket counts, sum, codes)."""
    lines = []
    les = ("0.005", "0.01", "0.025", "+Inf")
    for pred, (counts, total, codes) in (("v1", v1), ("v2", v2)):
        ident = f'deployment_name="iris",predictor_name="{pred}",namespace="models"'
        for le, c in zip(les, counts):
            lines.append(f'seldon_api_executor_client_requests_seconds_bucket{{{ident},'
                         f'le="{le}"}} {c}')
        lines.append(f"seldon_api_executor_client_requests_seconds_count{{{ident}}} {counts[-1]}")
        lines.append(f"seldon_api_executor_client_requests_seconds_sum{{{ident}}} {total}")
        for code, n in codes.items():
            lines.append(f'seldon_api_executor_server_requests_seconds_count{{{ident},'
                         f'code="{code}",service="{ "feedback" if code == "201" else "predictions"}"}}'
                         f" {n}")
    return "\n".join(lines) + "\n"


def test_router_metrics_source_reads_the_same_gate_metrics():
    texts = [
        _gate_text(((1, 2, 3, 3), 0.02, {"200": 3}), ((0, 0, 0, 0), 0.0, {})),
        _gate_text(((5, 9, 12, 13), 0.11, {"200": 12, "502": 1}),
                   ((1, 1, 2, 2), 0.03, {"200": 2, "201": 1})),
        _gate_text(((5, 9, 12, 13), 0.11, {"200": 12, "502": 1}),
                   ((1, 4, 6, 7), 0.09, {"200": 6, "500": 1, "201": 3})),
        # v2's series reset (its predictor left and came back): clamped at 0.
        _gate_text(((6, 10, 14, 15), 0.13, {"200": 14, "502": 1}),
                   ((0, 1, 1, 1), 0.004, {"200": 1})),
    ]
    ref_admin, port_admin = _FakeAdmin(), _FakeAdmin()
    ref, got = JR.RouterMetricsSource(ref_admin), PR.RouterMetricsSource(port_admin)
    for text in texts:  # one scrape of the router at a time
        ref_admin.texts = port_admin.texts = [text]
        # The first read of a scrape diffs against the previous scrape.
        for pred, window in (("v2", 0), ("v1", 0), ("v1", 60), ("v2", 60)):
            assert got.model_metrics("iris", pred, "models", window).as_dict() == \
                ref.model_metrics("iris", pred, "models", window).as_dict()


def test_the_router_source_is_the_ports_own_copy():
    src = ROOT / M.PORT / "native" / "router.cc"
    assert PR._SRC == src
    assert src.read_bytes() == (ROOT / JR._SRC.relative_to(JR._SRC.parents[2])).read_bytes()


@pytest.fixture(scope="module")
def binary():
    return PR.build_router()


def test_build_router_compiles_into_build_native(binary):
    assert binary.parent == ROOT / "build" / "native"
    assert binary.stat().st_uid == __import__("os").getuid()
    assert (binary.parent.stat().st_mode & 0o777) == 0o700
    assert PR.build_router() == binary  # cached by the source's hash


class _Stub(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        body = json.dumps({"backend": self.server.tag}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_a_live_router_splits_by_weight(binary):
    stubs = {}
    for tag in ("v1", "v2"):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
        srv.tag = tag
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        stubs[tag] = srv
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    backends = {t: ("127.0.0.1", srv.server_address[1], w)
                for (t, srv), w in zip(stubs.items(), (75, 25))}
    try:
        with PR.RouterProcess(port=port, backends=backends, namespace="models",
                              deployment="iris", binary=binary) as router:
            seen = []
            for _ in range(40):
                req = urllib.request.Request(f"http://127.0.0.1:{port}/v2/models/iris/infer",
                                             data=b"{}",
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=5) as r:
                    seen.append(json.loads(r.read())["backend"])
            assert seen.count("v1") == 30 and seen.count("v2") == 10  # smooth WRR: exact
            m = PR.RouterMetricsSource(router.admin).model_metrics("iris", "v2", "models", 0)
            assert m.request_count == 10 and m.error_rate == 0.0
            router.admin.set_weights({"v1": 0, "v2": 100})
            assert router.admin.get_weights() == {"v1": 0, "v2": 100}
    finally:
        for srv in stubs.values():
            srv.shutdown()
            srv.server_close()
