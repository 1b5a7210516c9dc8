"""The port's last server flags, on the CPU: ``--drain-s`` (the SIGTERM
endpoint lag), ``--metrics-port`` (a listener for ``/metrics`` alone) and
``--log-format json`` (``utils/logging.py``).  Counterparts: the
``JsonFormatter`` cases of ``tests/test_aux.py`` and
``tests/test_rollout_recorder.py``, and the reference server's ``main``.

- ``JsonFormatter``: a record with and without ``request_id``; the per-CR
  logger's generation, namespace and name; the same record formats to the
  same JSON in both packages; ``configure`` in both modes.
- The listener answers ``/metrics`` and nothing else.
- A server process with ``--drain-s 2 --metrics-port P --log-format json``:
  after SIGTERM ``/readyz`` is 503 while a generate sent inside the lag is
  answered 200, then the process exits 0; the listener served ``/metrics``;
  every log line is JSON and the completion line carries the request id.
  A metrics port that is taken costs the listener, not the replica.
"""

from __future__ import annotations

import dataclasses
import http.client
import io
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    metrics as tmetrics,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    logging as tlogging,
)
from tpumlops.utils import logging as jlogging

ROOT = Path(__file__).resolve().parents[1]
PORT_PKG = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"


@pytest.mark.parametrize("mod", [tlogging, jlogging], ids=["port", "reference"])
def test_json_log_format_carries_request_id(mod):
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(mod.JsonFormatter())
    log = logging.getLogger(f"tpumlops.test.jsonfmt.{mod.__name__}")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    try:
        log.info("generate done tokens=%d", 7, extra={"request_id": "rid-9"})
        log.warning("no id attached")
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            log.exception("failed")
    finally:
        log.removeHandler(handler)
    lines = [json.loads(ln) for ln in stream.getvalue().splitlines()]
    assert lines[0]["message"] == "generate done tokens=7"
    assert lines[0]["request_id"] == "rid-9"
    assert lines[0]["level"] == "INFO" and lines[0]["logger"] == log.name
    assert lines[0]["ts"].endswith("+00:00")
    assert "request_id" not in lines[1]
    assert "RuntimeError: boom" in lines[2]["exc_info"]


def test_per_resource_logger_carries_generation_in_json_mode(caplog):
    log = tlogging.model_logger("iris", "models")
    log.set_generation(7)
    with caplog.at_level(logging.INFO, logger="tpumlops.models.iris"):
        log.info("reconcile step")
    rendered = json.loads(tlogging.JsonFormatter().format(caplog.records[-1]))
    assert rendered["namespace"] == "models" and rendered["name"] == "iris"
    assert rendered["generation"] == 7
    assert "[models/iris gen=7]" in rendered["message"]


def test_the_same_record_formats_alike_in_both_packages():
    record = logging.LogRecord("tpumlops_torch.server.requests", logging.INFO, __file__, 1,
                               "generate done request_id=%s code=%d", ("r-1", 200), None)
    record.request_id = "r-1"
    record.cr_namespace, record.cr_name, record.cr_generation = "ns", "m", 3
    record.odd = object()
    assert tlogging.JsonFormatter().format(record) == jlogging.JsonFormatter().format(record)
    adapter_t = tlogging.model_logger("m", "ns")
    adapter_j = jlogging.model_logger("m", "ns")
    assert adapter_t.process("x", {}) == adapter_j.process("x", {})


def test_configure_switches_the_root_handler():
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        tlogging.configure(json_format=True)
        assert isinstance(root.handlers[-1].formatter, tlogging.JsonFormatter)
        assert root.level == logging.INFO
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


def test_metrics_listener_serves_metrics_only():
    m = tmetrics.ServerMetrics(deployment_name="d", predictor_name="v1", namespace="ns")
    m.set_ready(True)
    httpd = tapp.serve_metrics("127.0.0.1", 0, m)
    try:
        port = httpd.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
        assert resp.status == 200 and resp.getheader("Content-Type") == tmetrics.CONTENT_TYPE
        assert "tpumlops_model_ready" in body
        conn.request("GET", "/readyz")
        resp = conn.getresponse()
        assert resp.status == 404 and "metrics only" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_flag_defaults_follow_the_reference():
    ap = tapp.build_arg_parser()
    args = ap.parse_args(["--model-uri", "x"])
    assert (args.drain_s, args.metrics_port, args.log_format) == (3.0, 6000, "text")
    with pytest.raises(SystemExit):
        ap.parse_args(["--model-uri", "x", "--log-format", "yaml"])


# -- a server process ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = T.LlamaConfig.tiny(max_seq=64)
    params = T.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)
    return tloader.save_native_model(tmp_path_factory.mktemp("flags") / "tiny",
                                     "llama-generate", params, config=dataclasses.asdict(cfg))


def _start(artifact, log_path, *flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    logf = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT_PKG}.server", "--model-uri", str(artifact),
         "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1", "--port", "0",
         *flags], cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    logf.close()
    serving = re.compile(r"serving model \(llama-generate\) on 127\.0\.0\.1:(\d+)")
    assert _wait(lambda: serving.search(log_path.read_text()) or proc.poll() is not None,
                 120), log_path.read_text()
    assert proc.poll() is None, log_path.read_text()
    return proc, int(serving.search(log_path.read_text()).group(1))


def test_sigterm_lag_metrics_port_and_json_logs_in_a_server_process(artifact, tmp_path):
    mport = _free_port()
    log_path = tmp_path / "server.log"
    proc, port = _start(artifact, log_path, "--drain-s", "2", "--metrics-port", str(mport),
                        "--log-format", "json")
    try:
        code, raw = _http(mport, "GET", "/metrics")
        assert code == 200 and b"tpumlops_model_ready" in raw
        assert _http(port, "GET", "/readyz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert _wait(lambda: _http(port, "GET", "/readyz")[0] == 503, 2)
        t_lag = time.monotonic()
        code, raw = _http(port, "POST", "/v2/models/model/generate",
                          {"prompt_ids": [5, 9, 2, 7], "max_new_tokens": 4},
                          headers={"X-Request-Id": "flags-rid-1"})
        assert code == 200, raw
        assert time.monotonic() - t_lag < 2.0  # answered inside the lag
        assert len(json.loads(raw)["outputs"][0]["data"]) == 4
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(ln) for ln in log_path.read_text().splitlines() if ln.strip()]
    messages = [ln["message"] for ln in lines]
    assert any("endpoint lag 2.0s before drain" in m for m in messages)
    assert any("termination signal; draining" in m for m in messages)
    done = [ln for ln in lines if ln["logger"] == "tpumlops_torch.server.requests"]
    assert done and done[0]["request_id"] == "flags-rid-1"
    assert "request_id=flags-rid-1 code=200" in done[0]["message"]


def test_a_taken_metrics_port_costs_the_listener_not_the_replica(artifact, tmp_path):
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        log_path = tmp_path / "server.log"
        proc, port = _start(artifact, log_path, "--drain-s", "0", "--metrics-port",
                            str(taken.getsockname()[1]))
        try:
            code, raw = _http(port, "GET", "/metrics")
            assert code == 200 and b"tpumlops_model_ready" in raw
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert "metrics listener on port" in log_path.read_text()
