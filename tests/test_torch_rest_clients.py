"""The port's REST clients (``clients/kube_rest.py``, ``mlflow_rest.py``,
``prom_http.py``, ``dataplane.py`` on ``clients/transport.py``), its
``clients/envtest.py`` and ``python -m <port>.operator`` against the JAX
package's.

- The JAX package's own client tests (``tests/test_clients_rest.py``, the
  REST half of ``tests/test_watch.py``) run against the port: each handler
  they give ``httpx.MockTransport`` sits behind the port client's transport
  seam (``torch_transplant.httpx_seam``) and answers the port the same.
- Side by side, the same calls through both packages' clients send the
  same requests (method, path, query, body, content type, auth) and give the
  same results and errors.
- Wire: ``tests/test_envtest_wire.py``'s loopback cases run port client on
  port server, port client on the JAX server and the JAX client on the port
  server, a watch and its 410 resume in each.
- The entry point: ``--help`` names every flag the reference's does; the
  process takes its Lease from the port's ``EnvtestServer``, serves
  ``/metrics`` with the ``tpumlops_operator_*`` families and exits 0 within
  10 s of SIGTERM.  With ``httpx`` and ``prometheus_client`` blocked every
  port module still imports (the card's machine has neither).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import httpx
import pytest

import torch_transplant as TT
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (  # noqa: E501
    base as PB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (  # noqa: E501
    dataplane as PD,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (  # noqa: E501
    kube_rest as PK,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (  # noqa: E501
    mlflow_rest as PM,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (  # noqa: E501
    prom_http as PP,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (  # noqa: E501
    transport as PT,
)
from tpumlops.clients import base as JB
from tpumlops.clients import dataplane as JD
from tpumlops.clients import kube_rest as JK
from tpumlops.clients import mlflow_rest as JM
from tpumlops.clients import prom_http as JP

PORT = TT.PORT
ROOT = Path(__file__).resolve().parent.parent

# -- the JAX package's client tests, on the port ------------------------------

_rest = TT.transplant("test_clients_rest", subs=TT.REST_SUBS)
TT.export(_rest, globals(), [n for n in sorted(vars(_rest)) if n.startswith("test_")],
          tag="reference")

_watch = TT.transplant("test_watch", subs=TT.REST_SUBS)
_watch._rest_client = lambda handler: PK.KubeRestClient(
    "https://kube", transport=TT.httpx_seam(handler))
TT.export(_watch, globals(), ["test_kube_rest_watch_parses_stream_and_params",
                              "test_kube_rest_watch_410_raises_watch_expired",
                              "test_kube_rest_list_with_version",
                              "test_watcher_recovers_from_expired_cursor",
                              "test_watcher_requires_watch_capable_client"], tag="watch")

# -- wire: port client / port server, port client / JAX server, JAX / port ----

_ENVTEST_CASES = ["test_crud_roundtrip_over_real_http", "test_watch_streams_real_chunked_events",
                  "test_watch_resume_cursor_skips_old_events_and_410s_after_compaction",
                  "test_bearer_auth_enforced", "test_events_endpoint_accepts_corev1_events",
                  "test_keep_alive_survives_errored_bodied_requests",
                  "test_watch_from_post_compaction_rv_is_not_410"]
_CROSS_CASES = ["test_crud_roundtrip_over_real_http", "test_watch_streams_real_chunked_events",
                "test_watch_resume_cursor_skips_old_events_and_410s_after_compaction"]
_wire = TT.transplant("test_envtest_wire")
TT.export(_wire, globals(), _ENVTEST_CASES, tag="wire")
_wire_jax_server = TT.transplant("test_envtest_wire", subs=[
    (rf"from {PORT}\.clients\.envtest import", "from tpumlops.clients.envtest import")])
TT.export(_wire_jax_server, globals(), _CROSS_CASES, tag="wire_port_client_jax_server")
_wire_jax_client = TT.transplant("test_envtest_wire", subs=[
    (rf"from {PORT}\.clients\.(kube_rest|base) import", r"from tpumlops.clients.\1 import")])
TT.export(_wire_jax_client, globals(), _CROSS_CASES, tag="wire_jax_client_port_server")


def test_the_cross_wire_cases_mix_the_packages():
    jax_mod = f"{TT.JAX_PKG}.clients"
    assert _wire_jax_server.EnvtestServer.__module__ == f"{jax_mod}.envtest"
    assert _wire_jax_server.KubeRestClient.__module__ == f"{PORT}.clients.kube_rest"
    assert _wire_jax_client.EnvtestServer.__module__ == f"{PORT}.clients.envtest"
    assert _wire_jax_client.KubeRestClient.__module__ == f"{jax_mod}.kube_rest"
    assert _wire_jax_client.Conflict.__module__ == f"{jax_mod}.base"


# -- side by side --------------------------------------------------------------


class _Recorder:
    """One scripted handler for both packages; every request it saw, as
    (method, path, query, content type, auth, parsed body)."""

    def __init__(self, respond):
        self.respond = respond
        self.seen: list = []

    def __call__(self, request: httpx.Request) -> httpx.Response:
        body = request.content
        try:
            parsed = json.loads(body) if body else None
        except ValueError:
            parsed = body
        self.seen.append((request.method, request.url.path, sorted(request.url.params.items()),
                          request.headers.get("content-type"),
                          request.headers.get("authorization"), parsed))
        return self.respond(request)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the error's type name and message
        return type(e).__name__, str(e)


def _both(respond, make_ref, make_port, calls):
    """Run ``calls(client, base)`` on the reference client (httpx mock) and
    the port's (the seam); (requests, outcomes) of each."""
    out = []
    for make, base in ((make_ref, JB), (make_port, PB)):
        rec = _Recorder(respond)
        client = make(rec)
        out.append((rec.seen, [_outcome(lambda c=c: c(client, base)) for c in calls]))
    return out


def _ref_kube(handler, token=None):
    c = JK.KubeRestClient.__new__(JK.KubeRestClient)
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    c._http = httpx.Client(base_url="https://kube", headers=headers,
                           transport=httpx.MockTransport(handler))
    return c


def _port_kube(handler, token=None):
    return PK.KubeRestClient("https://kube", token=token, transport=TT.httpx_seam(handler))


def _ref(base, name="iris", ns="models"):
    return base.ObjectRef(namespace=ns, name=name, **base.MLFLOWMODEL)


def _dict_view(obj):
    if isinstance(obj, list):
        return [_dict_view(x) for x in obj]
    if hasattr(obj, "type") and hasattr(obj, "object"):
        return {"type": obj.type, "object": obj.object}
    return obj


@pytest.mark.parametrize("status", [200, 404, 409, 500])
def test_kube_calls_send_the_same_requests_and_map_the_same_errors(status):
    def respond(request):
        if request.url.path.endswith("/events"):
            return httpx.Response(201, json={"kind": "Event"})
        return httpx.Response(status, json={"kind": "X", "items": [{"a": 1}],
                                            "metadata": {"resourceVersion": "7"}})

    calls = [
        lambda c, b: c.get(_ref(b)),
        lambda c, b: c.list(_ref(b)),
        lambda c, b: c.list_with_version(_ref(b)),
        lambda c, b: c.create(_ref(b), {"spec": {"modelName": "iris", "ü": 1.5}}),
        lambda c, b: c.replace(_ref(b), {"metadata": {"resourceVersion": "3"}, "spec": {}}),
        lambda c, b: c.patch_status(_ref(b), {"phase": "Stable", "trafficCurrent": 30}),
        lambda c, b: c.delete(_ref(b)),
        lambda c, b: c.emit_event(_ref(b), b.Event("Warning", "Reason", "a message")),
        lambda c, b: c.get(b.ObjectRef(namespace="", name="n1", group="", version="v1",
                                       plural="nodes")),
    ]
    (ref_seen, ref_out), (got_seen, got_out) = _both(
        respond, lambda h: _ref_kube(h, "tok"), lambda h: _port_kube(h, "tok"), calls)
    # An event body carries the wall-clock second it was sent in.
    strip = lambda seen: [s[:5] + ((dict(s[5], firstTimestamp=None, lastTimestamp=None),)  # noqa: E731
                                   if isinstance(s[5], dict) and "firstTimestamp" in s[5]
                                   else s[5:]) for s in seen]
    assert strip(got_seen) == strip(ref_seen)
    assert got_out == ref_out
    assert any(s[3] == "application/merge-patch+json" for s in got_seen)


def test_kube_watch_streams_alike_and_410s_alike():
    lines = b"".join(json.dumps(o).encode() + b"\n" for o in (
        {"type": "ADDED", "object": {"metadata": {"name": "a", "resourceVersion": "4"}}},
        {"type": "BOOKMARK", "object": {"metadata": {"resourceVersion": "6"}}},
        {"type": "ERROR", "object": {"kind": "Status", "code": 410}},
    ))
    for body, status in ((lines, 200), (b"Gone", 410), (b"denied", 403)):
        def respond(request, body=body, status=status):
            return httpx.Response(status, content=body)

        calls = [lambda c, b: _dict_view(list(c.watch(_ref(b), resource_version="3",
                                                      timeout_s=9)))]
        (ref_seen, ref_out), (got_seen, got_out) = _both(respond, _ref_kube, _port_kube, calls)
        assert got_seen == ref_seen
        assert got_out == ref_out
        assert ref_out[0][0] == {200: "WatchExpired", 410: "WatchExpired", 403: "ApiError"}[status]


def test_kube_watch_stops_on_the_stop_event_between_lines():
    import threading

    stop = threading.Event()
    lines = b"".join(json.dumps({"type": "ADDED", "object": {"metadata": {
        "name": f"m{i}", "resourceVersion": str(i)}}}).encode() + b"\n" for i in range(5))
    client = _port_kube(lambda r: httpx.Response(200, content=lines))
    got = []
    for ev in client.watch(_ref(PB), stop=stop):
        got.append(ev.object["metadata"]["name"])
        if len(got) == 2:
            stop.set()
    assert got == ["m0", "m1"]


def test_mlflow_calls_send_the_same_requests(monkeypatch):
    def respond(request):
        if request.url.params.get("alias") == "missing":
            return httpx.Response(404, json={"error_code": "RESOURCE_DOES_NOT_EXIST"})
        if request.url.params.get("version") == "9":
            return httpx.Response(502, text="bad gateway")
        if request.url.params.get("version") == "8":
            return httpx.Response(200, json={"model_version": {}})
        return httpx.Response(200, json={"model_version": {"version": 3, "source": "s3://b"}})

    calls = [
        lambda c, b: c.get_version_by_alias("iris", "champion"),
        lambda c, b: c.get_version_by_alias("iris", "missing"),
        lambda c, b: c.get_version("iris", "2"),
        lambda c, b: c.get_version("iris", "9"),
        lambda c, b: c.get_version("iris", "8"),
    ]
    for env in ({}, {"MLFLOW_TRACKING_TOKEN": "tk"},
                {"MLFLOW_TRACKING_USERNAME": "u", "MLFLOW_TRACKING_PASSWORD": "p"},
                {"MLFLOW_TRACKING_TOKEN": "tk", "MLFLOW_TRACKING_USERNAME": "u",
                 "MLFLOW_TRACKING_PASSWORD": "p"}):
        for k in ("MLFLOW_TRACKING_TOKEN", "MLFLOW_TRACKING_USERNAME",
                  "MLFLOW_TRACKING_PASSWORD"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)

        def ref_client(h):
            c = JM.MlflowRestClient("http://mlflow/")
            c._http = httpx.Client(base_url="http://mlflow", auth=c._http.auth,
                                   headers=dict(c._http.headers),
                                   transport=httpx.MockTransport(h))
            return c

        (ref_seen, ref_out), (got_seen, got_out) = _both(
            respond, ref_client,
            lambda h: PM.MlflowRestClient("http://mlflow/", transport=TT.httpx_seam(h)), calls)
        assert got_seen == ref_seen, env
        assert [(k, repr(v) if k == "ok" else v) for k, v in got_out] == \
            [(k, repr(v) if k == "ok" else v) for k, v in ref_out]


def test_mlflow_unreachable_is_a_registry_error_in_both():
    def down(*a):
        raise PT.TransportError("connection refused")

    with pytest.raises(PB.RegistryError, match="mlflow unreachable"):
        PM.MlflowRestClient("http://mlflow", transport=down).get_version("iris", "1")

    def ref_down(request):
        raise httpx.ConnectError("connection refused")

    c = JM.MlflowRestClient("http://mlflow")
    c._http = httpx.Client(base_url="http://mlflow", transport=httpx.MockTransport(ref_down))
    with pytest.raises(JB.RegistryError, match="mlflow unreachable"):
        c.get_version("iris", "1")


@pytest.mark.parametrize("mode", ["values", "empty", "nan", "errors", "garbage"])
def test_prometheus_sends_the_same_promql_and_reads_the_same_metrics(mode):
    def respond(request):
        q = request.url.params["query"]
        if mode == "errors" and ("code!=" in q or "ttft" in q):
            return httpx.Response(503, text="prometheus hiccup")
        if mode == "garbage":
            return httpx.Response(200, content=b"{not json")
        if mode == "empty":
            return httpx.Response(200, json={"data": {"result": []}})
        value = "NaN" if mode == "nan" and "histogram_quantile" in q else str(len(q) % 17 + 1)
        return httpx.Response(200, json={"data": {"result": [{"value": [0, value]}]}})

    calls = [
        lambda c, b: c.model_metrics("iris", "v2", "models", 45),
        lambda c, b: c.engine_metrics("iris", "v2", "models", 30),
        lambda c, b: c.engine_metrics("iris", "v2", "models", 30, slo_tails=True),
    ]

    def ref_src(h):
        s = JP.PrometheusSource("http://prom")
        s._http = httpx.Client(base_url="http://prom", transport=httpx.MockTransport(h))
        return s

    (ref_seen, ref_out), (got_seen, got_out) = _both(
        respond, ref_src, lambda h: PP.PrometheusSource("http://prom/",
                                                        transport=TT.httpx_seam(h)), calls)
    assert got_seen == ref_seen
    assert [(k, v.__dict__ if k == "ok" else v) for k, v in got_out] == \
        [(k, v.__dict__ if k == "ok" else v) for k, v in ref_out]


def test_dataplane_warmup_posts_the_same_body_and_counts_alike():
    codes = iter([200, 404, 201, 500, 200] * 2)

    def respond(request):
        return httpx.Response(next(codes), json={})

    seen, counts = [], []
    for pkg in ("ref", "port"):
        rec = _Recorder(respond)
        if pkg == "ref":
            real = httpx.Client

            def patched(*a, **kw):
                return real(*a, **{**kw, "transport": httpx.MockTransport(rec)})

            JD.httpx.Client = patched
            try:
                counts.append(JD.DataPlaneWarmup()("iris", "v2", "models", 5, model="m"))
            finally:
                JD.httpx.Client = real
        else:
            counts.append(PD.DataPlaneWarmup(transport=TT.httpx_seam(rec))(
                "iris", "v2", "models", 5, model="m"))
        seen.append([(s[0], s[1], s[3], s[5]) for s in rec.seen])
    assert seen[0] == seen[1]
    assert seen[1][0][1] == "/v2/models/m/infer"
    assert counts == [3, 3]


def test_dataplane_warmup_survives_an_unreachable_predictor():
    def down(*a):
        raise PT.TransportError("refused")

    assert PD.DataPlaneWarmup(transport=down)("iris", "v2", "models", 3) == 0


def test_the_default_transport_speaks_http_and_maps_statuses():
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading

    class H(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            code = int(self.path.rsplit("/", 1)[-1])
            body = json.dumps({"path": self.path, "auth": self.headers.get("Authorization")})
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body.encode())

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        t = PT.UrllibTransport(timeout=5)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        status, _, body = t("GET", url + "/x/200", {"Authorization": "Bearer a"}, None)
        assert status == 200 and json.loads(body)["auth"] == "Bearer a"
        for code in (404, 409, 500):
            assert t("GET", f"{url}/x/{code}", {}, None)[0] == code
    finally:
        srv.shutdown()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    with pytest.raises(PT.TransportError):
        PT.UrllibTransport(timeout=2)("GET", f"http://127.0.0.1:{dead}/", {}, None)


# -- the entry point ----------------------------------------------------------


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT), "MLFLOW_TRACKING_URI": "http://127.0.0.1:9",
            "JAX_PLATFORMS": "cpu"}


def _flags(module: str) -> set:
    out = subprocess.run([sys.executable, "-m", module, "--help"], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr
    import re

    return set(re.findall(r"--[a-z][a-z-]+", out.stdout))


def test_help_names_every_flag_of_the_reference():
    got = _flags(f"{PORT}.operator")
    assert got == _flags("tpumlops.operator")
    assert {"--leader-elect", "--metrics-port", "--kube-url", "--fleet-trace-sources",
            "--rollout-ring", "--concurrent-reconciles", "--no-watch"} <= got


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_operator_process_takes_its_lease_serves_metrics_and_stops_on_sigterm():
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients.envtest import (  # noqa: E501
        EnvtestServer,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.operator.leader import (  # noqa: E501
        LEASE,
    )

    mport = _free_port()
    with EnvtestServer() as srv:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{PORT}.operator", "--kube-url", srv.url, "--leader-elect",
             "--metrics-port", str(mport), "--namespace", "models", "--log-level", "WARNING"],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            kube = PK.KubeRestClient(srv.url)
            lease_ref = PB.ObjectRef(namespace="tpumlops-system", name="tpumlops-operator",
                                     **LEASE)
            deadline = time.monotonic() + 60
            lease = text = None
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    lease = kube.get(lease_ref)
                    text = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                                  timeout=2).read().decode()
                    break
                except Exception:
                    time.sleep(0.1)
            assert proc.poll() is None, proc.stdout.read()
            assert lease is not None and lease["spec"]["holderIdentity"], lease
            assert "# TYPE tpumlops_operator_reconcile_total counter" in text
            assert "tpumlops_operator_resources 0.0" in text
            assert "# TYPE tpumlops_operator_slo_attainment gauge" in text
            t0 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
            took = time.monotonic() - t0
            assert rc == 0 and took < 10.0, (rc, took, proc.stdout.read())
            # SIGTERM released the Lease for a successor.
            assert not (kube.get(lease_ref)["spec"].get("holderIdentity") or "")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_every_port_module_imports_without_httpx_or_prometheus_client():
    code = f"""
import importlib, pkgutil, sys
sys.modules["httpx"] = None
sys.modules["prometheus_client"] = None
pkg = importlib.import_module("{PORT}")
names = []
for m in pkgutil.walk_packages(pkg.__path__, "{PORT}."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "tpumlops", "httpx",
             "prometheus_client", "{TT.JAX_PKG}") and sys.modules[m] is not None)
print(len(names), bad)
assert not bad, bad
for need in ("operator.slo", "operator.anomaly", "operator.multiplexer", "operator.planner",
             "operator.telemetry", "operator.leader", "clients.kube_rest", "clients.mlflow_rest",
             "clients.prom_http", "clients.dataplane", "clients.chaos", "clients.envtest",
             "clients.transport", "utils.trace_stitch"):
    assert "{PORT}." + need in names, need
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stdout + out.stderr
