"""The port server's serving surface against the reference's scenarios
(``tests/test_server.py`` SSE cases, ``tests/test_server_hardening.py``
shed/drain/request-id cases), with a tiny Llama on the CPU.

Covered: SSE token events and the final event, the multi-prompt stream
400, the typed terminal ``error`` event on an engine failure and a client
disconnect (499, slot freed); the lossless drain with a stream in flight,
drain cancel, the SIGTERM drain (in process with a request in flight, and
in a subprocess); the 429 body and ``Retry-After`` for budget and drain
sheds, the whole-request shed of a multi-prompt request, the oversized
request admitted on an idle engine, request ids in error bodies; the
lifecycle routes in every state; and the generation metric families,
parsed with ``prometheus_client``'s parser, against the reference's
``ServerMetrics``: names, types, label sets and bucket bounds, with counts
equal to the answers.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as TR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from tpumlops.server.metrics import ServerMetrics as JaxServerMetrics

ROOT = Path(__file__).resolve().parents[1]
PORT_PKG = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"
GEN = "/v2/models/llm/generate"

# The generation families the operator, autoscaler and router read.
FAMILIES = [
    "tpumlops_generated_tokens", "tpumlops_decode_batch_size",
    "tpumlops_decode_step_seconds", "tpumlops_engine_active_slots",
    "tpumlops_engine_queue_depth", "tpumlops_engine_admitting",
    "tpumlops_admission_wait_ms", "tpumlops_ttft_seconds", "tpumlops_itl_seconds",
    "tpumlops_request_tokens", "tpumlops_tick_seconds", "tpumlops_engine_dispatches",
    "tpumlops_engine_shed", "tpumlops_model_load_seconds",
    "tpumlops_cold_start_seconds", "tpumlops_model_ready",
]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_llama():
    cfg = T.LlamaConfig.tiny(max_seq=64)
    params = T.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)
    return cfg, params


class _Handle:
    def __init__(self, srv):
        self.srv = srv
        self.port = srv.server_address[1]
        self.thread = threading.Thread(target=srv.serve_forever, daemon=True)
        self.thread.start()

    @property
    def engine(self):
        return self.srv.engine

    def stop(self):
        if self.srv.lifecycle != "shutdown":
            self.srv.shutdown_all()
        self.thread.join(timeout=10)


def _serve(tiny_llama, **config):
    cfg, params = tiny_llama
    pred = TR._build_llama(params, cfg, dtype=torch.float32)
    conf = tapp.ServerConfig(model_name="llm", host="127.0.0.1", port=0,
                             dtype="float32", max_slots=2, device="cpu", **config)
    return _Handle(tapp.build_server(pred, conf))


@pytest.fixture(scope="module")
def server(tiny_llama):
    h = _serve(tiny_llama)
    yield h
    h.stop()


@pytest.fixture(scope="module")
def shed_server(tiny_llama):
    h = _serve(tiny_llama, admission_queue_budget=64)
    yield h
    h.stop()


def _request(h, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=60)
    data = None if body is None else json.dumps(body)
    conn.request(method, path, data, {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    try:
        payload = json.loads(raw)
    except ValueError:
        payload = raw.decode()
    return resp.status, payload, resp


@contextmanager
def _open_stream(h, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=60)
    conn.request("POST", GEN, json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json", **(headers or {})})
    try:
        yield conn.getresponse()
    finally:
        conn.close()


def _events(resp):
    """(event name, payload) per SSE event, until the final one."""
    name = ""
    for raw in resp:
        line = raw.decode().rstrip("\r\n")
        if line.startswith("event: "):
            name = line[len("event: "):]
        elif line.startswith("data: "):
            payload = json.loads(line[len("data: "):])
            yield name, payload
            name = ""
            if payload.get("done"):
                return


@contextmanager
def _slow_steps(h, seconds=0.02, fail_after=None):
    """Slow every decode tick (the tiny model decodes in ~1 ms), or make
    the tick after ``fail_after`` ticks fail."""
    eng = h.engine
    real = eng._device_step
    count = [0]

    def step(*a, **kw):
        count[0] += 1
        if fail_after is not None and count[0] > fail_after:
            raise RuntimeError("device wedged mid-generation")
        time.sleep(seconds)
        return real(*a, **kw)

    eng._device_step = step
    try:
        yield
    finally:
        eng._device_step = real


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        time.sleep(0.01)


def _metric(h, family, labels=""):
    _, text, _ = _request(h, "GET", "/metrics")
    total = 0.0
    for line in text.splitlines():
        if line.startswith(family) and labels in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


# -- SSE -------------------------------------------------------------------


def test_generate_streaming_sse(server):
    code, ref, _ = _request(server, "POST", GEN, {"prompt_ids": [5, 9, 2],
                                                   "max_new_tokens": 6})
    ref = ref["outputs"][0]["data"]
    with _open_stream(server, {"prompt_ids": [5, 9, 2], "max_new_tokens": 6}) as resp:
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/event-stream")
        assert len(resp.getheader("X-Request-Id")) == 32  # minted
        events = list(_events(resp))
    *toks, (name, final) = events
    assert [e["token"] for _, e in toks] == ref
    assert [e["index"] for _, e in toks] == list(range(6))
    assert name == "" and final == {"done": True, "output_ids": ref}


def test_seeded_stream_equals_the_answer_without_stream(server):
    body = {"prompt_ids": [7, 1, 4], "max_new_tokens": 10, "temperature": 0.8,
            "top_k": 50, "top_p": 0.95, "seed": 1234}
    _, plain, _ = _request(server, "POST", GEN, body)
    with _open_stream(server, body) as resp:
        events = list(_events(resp))
    assert [e["token"] for _, e in events[:-1]] == plain["outputs"][0]["data"]
    assert events[-1][1]["output_ids"] == plain["outputs"][0]["data"]


def test_generate_streaming_rejects_multi_prompt(server):
    code, body, _ = _request(server, "POST", GEN, {"prompt_ids": [[1, 2], [3, 4]],
                                                    "max_new_tokens": 2, "stream": True})
    assert code == 400 and "one prompt" in body["error"]


def test_sse_engine_failure_ends_with_a_typed_error_event(server):
    before = _metric(server, "seldon_api_executor_server_requests_seconds_count",
                     'code="500"')
    with _slow_steps(server, seconds=0.0, fail_after=2):
        with _open_stream(server, {"prompt_ids": [5, 9, 2], "max_new_tokens": 24},
                          headers={"X-Request-Id": "sse-death-1"}) as resp:
            assert resp.status == 200
            assert resp.getheader("X-Request-Id") == "sse-death-1"
            events = list(_events(resp))
    tokens = [e for n, e in events if not e.get("done")]
    assert tokens  # generation really started
    name, final = events[-1]
    assert name == "error" and final["done"] is True
    assert final["request_id"] == "sse-death-1"
    assert final["reason"] == "engine_failed" and final["error"]
    # The status line said 200; the gate's metric says 500.
    _wait(lambda: _metric(server, "seldon_api_executor_server_requests_seconds_count",
                          'code="500"') == before + 1)
    code, body, _ = _request(server, "POST", GEN, {"prompt_ids": [5], "max_new_tokens": 2})
    assert code == 200  # the engine recovered


def test_sse_completion_has_no_error_event(server):
    with _open_stream(server, {"prompt_ids": [5, 9, 2], "max_new_tokens": 4}) as resp:
        lines = [raw.decode() for raw in resp]
    assert not any(ln.startswith("event: ") for ln in lines)
    data = [json.loads(ln[len("data: "):]) for ln in lines if ln.startswith("data: ")]
    assert data[-1]["done"] is True and len(data[-1]["output_ids"]) == 4


def test_sse_client_disconnect_cancels_and_frees_the_slot(server):
    before = _metric(server, "seldon_api_executor_server_requests_seconds_count",
                     'code="499"')
    with _slow_steps(server):
        with _open_stream(server, {"prompt_ids": [5, 9, 2], "max_new_tokens": 50}) as resp:
            next(_events(resp))
        # Closed after the first token: the next write fails, the future
        # is cancelled and the slot frees at the next tick.
        _wait(lambda: server.engine.inflight() == 0)
        _wait(lambda: all(s is None for s in server.engine._slots))
    _wait(lambda: _metric(server, "seldon_api_executor_server_requests_seconds_count",
                          'code="499"') == before + 1)


# -- lifecycle routes --------------------------------------------------------


@pytest.mark.parametrize("lifecycle,ready_code,live_code", [
    ("ready", 200, 200), ("loading", 503, 200), ("draining", 503, 200),
    ("shutdown", 503, 503),
])
@pytest.mark.parametrize("route", ["/readyz", "/healthz", "/v2/health/ready",
                                   "/v2/models/llm/ready", "/livez", "/v2/health/live"])
def test_lifecycle_routes(server, route, lifecycle, ready_code, live_code):
    srv = server.srv
    srv.lifecycle = lifecycle
    try:
        code, body, resp = _request(server, "GET", route, headers={"X-Request-Id": "probe-1"})
    finally:
        srv.lifecycle = "ready"
    assert resp.getheader("X-Request-Id") == "probe-1"
    assert body["lifecycle"] == lifecycle
    if route in ("/livez", "/v2/health/live"):
        assert (code, body["live"]) == (live_code, live_code == 200)
    else:
        assert (code, body["ready"]) == (ready_code, ready_code == 200)
        assert ("inFlight" in body) == (lifecycle == "draining")


# -- drain -------------------------------------------------------------------


def test_sse_stream_survives_drain_and_new_requests_shed(server):
    """An SSE stream in flight when /admin/drain lands streams to its end;
    new requests shed 429 draining; /readyz says draining with the
    request in flight; the drain reports drained; cancel restores."""
    shed_before = _metric(server, "tpumlops_engine_shed_total", 'reason="draining"')
    drain = {}
    with _slow_steps(server):
        with _open_stream(server, {"prompt_ids": [5, 9, 2], "max_new_tokens": 24}) as resp:
            events = _events(resp)
            tokens = [next(events)[1]["token"], next(events)[1]["token"]]
            drainer = threading.Thread(target=lambda: drain.update(
                _request(server, "POST", "/admin/drain", {"grace_s": 60})[1]))
            drainer.start()
            _wait(lambda: server.srv.lifecycle == "draining")
            code, ready, _ = _request(server, "GET", "/readyz")
            assert code == 503 and ready["lifecycle"] == "draining"
            assert ready["inFlight"] >= 1
            code, shed, resp429 = _request(server, "POST", GEN,
                                           {"prompt_ids": [5], "max_new_tokens": 2})
            assert code == 429 and shed["reason"] == "draining"
            assert resp429.getheader("Retry-After") == str(shed["retry_after_s"])
            rest = list(events)
    final = rest[-1][1]
    assert "error" not in final and len(final["output_ids"]) == 24
    assert tokens + [e["token"] for _, e in rest[:-1]] == final["output_ids"]
    drainer.join(timeout=60)
    assert drain == {"lifecycle": "draining", "drained": True, "inFlight": 0}
    assert _metric(server, "tpumlops_engine_shed_total", 'reason="draining"') == shed_before + 1
    assert _metric(server, "tpumlops_model_ready") == 0.0
    code, undo, _ = _request(server, "POST", "/admin/drain", {"cancel": True})
    assert code == 200 and undo == {"lifecycle": "ready", "cancelled": True}
    assert _request(server, "GET", "/readyz")[0] == 200
    assert _metric(server, "tpumlops_model_ready") == 1.0
    assert _request(server, "POST", GEN, {"prompt_ids": [5, 9, 2], "max_new_tokens": 2})[0] == 200


@pytest.mark.parametrize("body,needle", [
    ({"grace_s": -1}, "grace_s"), ({"grace_s": 3601}, "grace_s"),
    ({"grace_s": "soon"}, "could not convert"), ([1], "JSON object"),
])
def test_drain_rejects_a_bad_body(server, body, needle):
    code, payload, _ = _request(server, "POST", "/admin/drain", body)
    assert code == 400 and needle in payload["error"]
    assert server.srv.lifecycle == "ready"


def test_cancel_is_refused_once_terminating(server):
    srv = server.srv
    try:
        srv.begin_drain()
        assert server.engine.draining and srv.wait_drained(5)
        srv.terminating = True
        code, body, _ = _request(server, "POST", "/admin/drain", {"cancel": True})
        assert code == 409 and body == {"lifecycle": "draining", "cancelled": False}
    finally:
        srv.terminating = False
        assert srv.cancel_drain() is True
    assert srv.lifecycle == "ready" and not server.engine.draining


def test_sigterm_drain_finishes_the_request_in_flight(tiny_llama):
    """``terminate`` (what SIGTERM runs): the stream in flight ends with
    all its tokens before the server shuts down."""
    h = _serve(tiny_llama, drain_grace_s=60)
    try:
        with _slow_steps(h):
            with _open_stream(h, {"prompt_ids": [5, 9, 2], "max_new_tokens": 20}) as resp:
                events = _events(resp)
                first = next(events)[1]
                done = {}
                term = threading.Thread(target=lambda: done.update(ok=h.srv.terminate()))
                term.start()
                rest = list(events)
        term.join(timeout=60)
        assert done == {"ok": True}
        final = rest[-1][1]
        assert len(final["output_ids"]) == 20 and final["output_ids"][0] == first["token"]
        assert h.srv.lifecycle == "shutdown"
    finally:
        h.stop()


def test_sigterm_drains_and_exits_the_server_process(tmp_path, tiny_llama):
    cfg, params = tiny_llama
    import dataclasses

    art = tloader.save_native_model(tmp_path / "tiny", "llama-generate", params,
                                    config=dataclasses.asdict(cfg))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    log_path = tmp_path / "server.log"
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{PORT_PKG}.server", "--model-uri", str(art),
             "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
             "--port", "0", "--drain-grace-seconds", "30",
             "--admission-queue-budget", "64"],
            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
        try:
            _wait(lambda: "serving llm" in log_path.read_text()
                  or "serving model" in log_path.read_text() or proc.poll() is not None, 120)
            assert proc.poll() is None, log_path.read_text()
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log = log_path.read_text()
    assert "termination signal; draining (grace 30.0s)" in log
    assert "drain grace" not in log  # an idle server drains at once


# -- admission shed ----------------------------------------------------------


def _saturate(h):
    """Both slots busy and one request queued (est 60 of the 64 budget),
    admitting the slot occupants one at a time."""
    eng = h.engine
    futs = []
    for _ in range(2):
        futs.append(eng.submit([5, 9, 2, 7], 56))
        _wait(lambda: eng._queue.qsize() == 0)
    futs.append(eng.submit([5, 9, 2, 7], 56))
    return futs


def test_shed_429_body_and_retry_after_contract(shed_server):
    eng = shed_server.engine
    with _slow_steps(shed_server):
        futs = _saturate(shed_server)
        try:
            code, body, resp = _request(shed_server, "POST", GEN,
                                        {"prompt_ids": [5, 9, 2, 7], "max_new_tokens": 56},
                                        headers={"X-Request-Id": "shed-rid-1"})
            assert code == 429, body
            assert body["reason"] == "budget" and body["retry_after_s"] >= 1
            assert resp.getheader("Retry-After") == str(body["retry_after_s"])
            assert "budget" in body["error"] and body["request_id"] == "shed-rid-1"
            assert eng._queue.qsize() == 1 and eng.inflight() == 3
            assert _metric(shed_server, "tpumlops_engine_shed_total", 'reason="budget"') >= 1
        finally:
            for f in futs:
                f.result(timeout=120)
    assert _request(shed_server, "POST", GEN, {"prompt_ids": [5, 9, 2],
                                               "max_new_tokens": 4})[0] == 200


def test_shed_is_atomic_for_multi_prompt_requests(shed_server):
    eng = shed_server.engine
    with _slow_steps(shed_server):
        futs = _saturate(shed_server)
        before = eng.shed_total
        try:
            code, _, _ = _request(shed_server, "POST", GEN, {
                "inputs": [{"name": "prompt_ids", "shape": [3, 4], "datatype": "INT64",
                            "data": [5, 9, 2, 7] * 3}],
                "parameters": {"max_new_tokens": 4}})
            assert code == 429
            assert eng.shed_total == before + 1  # one shed, the whole request
            assert eng.inflight() == 3  # no sibling joined
        finally:
            for f in futs:
                f.result(timeout=120)


def test_oversized_request_admits_on_an_idle_engine(shed_server):
    _wait(lambda: shed_server.engine.inflight() == 0)
    code, body, _ = _request(shed_server, "POST", GEN, {
        "prompt_ids": [[5, 9, 2, 7], [1, 2, 3, 4]], "max_new_tokens": 56})  # est 120 > 64
    assert code == 200, body
    assert [len(o["data"]) for o in body["outputs"]] == [56, 56]


# -- request ids -------------------------------------------------------------


def test_request_ids_in_headers_and_error_bodies(server):
    code, body, resp = _request(server, "POST", GEN, {"prompt_ids": []},
                                headers={"X-Request-Id": "bad-7"})
    assert code == 400 and body["request_id"] == "bad-7"
    assert resp.getheader("X-Request-Id") == "bad-7"
    trace_id = "0af7651916cd43dd8448eb211c80319c"
    code, _, resp = _request(server, "POST", GEN, {"prompt_ids": [5], "max_new_tokens": 1},
                             headers={"traceparent": f"00-{trace_id}-b7ad6b7169203331-01"})
    assert code == 200 and resp.getheader("X-Request-Id") == trace_id
    with _slow_steps(server, seconds=0.0, fail_after=0):
        code, body, resp = _request(server, "POST", GEN, {"prompt_ids": [5], "max_new_tokens": 4},
                                    headers={"X-Request-Id": "boom-1"})
    assert code == 500 and body["request_id"] == "boom-1"
    code, _, resp = _request(server, "GET", "/no/such/path", headers={"X-Request-Id": "lost-1"})
    assert code == 404 and resp.getheader("X-Request-Id") == "lost-1"
    assert tapp.request_id_from_headers({"X-Request-Id": "\x00\x01"}) != ""


# -- metrics -----------------------------------------------------------------


def _families(text: str) -> dict:
    """name -> (type, {sample suffix: label names}, bucket bounds)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        suffixes, bounds = {}, set()
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            labels = dict(s.labels)
            if "le" in labels:
                bounds.add(float(labels.pop("le")))
            suffixes[s.name[len(fam.name):]] = tuple(sorted(labels))
        out[fam.name] = (fam.type, suffixes, tuple(sorted(bounds)))
    return out


def _touch(m):
    """One observation in every generation family (the reference's and
    the port's ``ServerMetrics`` share these method names)."""
    m.observe_decode_step(2, 0.01, 1, 1)
    m.inc_generated_tokens(3)
    m.inc_shed("budget")
    m.observe_admission_wait(0.002)
    m.observe_ttft(0.05)
    m.observe_itl(0.02)
    m.observe_request_tokens(7)
    m.observe_tick("decode", 0.01)
    m.inc_dispatch("decode")
    m.observe_model_load({"wall_s": 1.5})
    m.observe_cold_start("total", 2.0)


def test_generation_families_match_the_reference():
    ref = JaxServerMetrics("d", "v1", "ns")
    _touch(ref)
    ref.ready.labels(**ref.identity).set(1)
    port = tapp.ServerMetrics("d", "v1", "ns")
    _touch(port)
    port.set_ready(True)
    want = _families(ref.exposition().decode())
    got = _families(port.render().decode())
    for name in FAMILIES:
        assert name in got, name
        assert got[name] == want[name], name


def test_generation_counts_equal_the_answers(tiny_llama):
    h = _serve(tiny_llama)
    try:
        answers = []
        for body in ({"prompt_ids": [5, 9, 2], "max_new_tokens": 6},
                     {"prompt_ids": [[1, 2], [3, 4, 5]], "max_new_tokens": 4,
                      "temperature": 0.9, "seed": 5},
                     {"prompt_ids": [8, 8], "max_new_tokens": 3, "stream": True}):
            if body.get("stream"):
                with _open_stream(h, body) as resp:
                    answers.append([list(_events(resp))[-1][1]["output_ids"]])
            else:
                code, payload, _ = _request(h, "POST", GEN, body)
                answers.append([o["data"] for o in payload["outputs"]])
        assert _request(h, "POST", GEN, {"prompt_ids": []})[0] == 400
        rows = [r for a in answers for r in a]
        tokens = sum(len(r) for r in rows)
        _, text, _ = _request(h, "GET", "/metrics")
        fams = {f.name: f for f in text_string_to_metric_families(text)}

        def value(name, suffix="", **labels):
            return sum(s.value for s in fams[name].samples if s.name == name + suffix
                       and all(s.labels.get(k) == v for k, v in labels.items()))

        assert value("tpumlops_generated_tokens", "_total") == tokens
        assert value("tpumlops_ttft_seconds", "_count") == len(rows)
        assert value("tpumlops_itl_seconds", "_count") == tokens - len(rows)
        assert value("tpumlops_request_tokens", "_count") == len(rows)
        assert value("tpumlops_request_tokens", "_sum") == tokens
        assert value("tpumlops_admission_wait_ms", "_count") == len(rows)
        eng = h.engine
        assert value("tpumlops_engine_dispatches", "_total", op="decode") == \
            eng.dispatches_total["decode"] == value("tpumlops_tick_seconds", "_count",
                                                    kind="decode")
        assert value("tpumlops_engine_dispatches", "_total", op="prefill") == \
            eng.dispatches_total["prefill"]
        server = "seldon_api_executor_server_requests_seconds"
        assert value(server, "_count", code="200") == 3
        assert value(server, "_count", code="400") == 1
        assert value("tpumlops_model_ready") == 1.0
        stages = {s.labels["stage"] for s in fams["tpumlops_cold_start_seconds"].samples}
        assert stages == {"compile", "total", "first_token"}
    finally:
        h.stop()


# -- the prefix cache and speculation on the serving surface -----------------

FEATURE_FAMILIES = [
    "tpumlops_prefix_cache_hits", "tpumlops_prefix_cache_cached_tokens",
    "tpumlops_prefix_cache_evictions", "tpumlops_prefix_cache_l2_hits",
    "tpumlops_prefix_cache_l2_spills", "tpumlops_prefix_cache_l2_evictions",
    "tpumlops_spec_proposed_tokens", "tpumlops_spec_accepted_tokens",
    "tpumlops_spec_accepted_len", "tpumlops_spec_acceptance_rate",
]


def test_prefix_cache_and_spec_families_match_the_reference():
    ref = JaxServerMetrics("d", "v1", "ns")
    port = tapp.ServerMetrics("d", "v1", "ns")
    for m in (ref, port):
        m.observe_prefix_hit(64)
        m.inc_prefix_evictions()
        for kind in ("hit", "spill", "evict"):
            m.inc_prefix_l2(kind)
        m.observe_speculative(4, 3)
        m.observe_speculative(0, 0)
    want = _families(ref.exposition().decode())
    got = _families(port.render().decode())
    for name in FEATURE_FAMILIES:
        assert name in got, name
        assert got[name] == want[name], name


def _args(*extra):
    return tapp.build_arg_parser().parse_args(["--model-uri", "x", *extra])


def test_feature_flags_parse_into_the_engine_configs():
    conf = tapp.config_from_args(_args(
        "--prefill-chunk", "256", "--prefix-cache", "1", "--prefix-cache-budget-mb", "512",
        "--prefix-cache-l2-budget-mb", "256", "--speculative", "1",
        "--speculative-draft-tokens", "8", "--speculative-ngram-min", "2",
        "--speculative-ngram-max", "3", "--speculative-adaptive", "0"))
    pc, sp = conf.prefix_cache_config(), conf.speculative_config()
    assert (pc.enabled, pc.budget_bytes, pc.chunk_tokens, pc.l2_budget_bytes) == (
        True, 512 * 2**20, 256, 256 * 2**20)
    assert (sp.enabled, sp.draft_tokens, sp.ngram_min, sp.ngram_max, sp.adaptive) == (
        True, 8, 2, 3, False)
    # The reuse unit follows --prefill-chunk, or 64; both off by default.
    assert tapp.config_from_args(_args("--prefix-cache", "1")).prefix_cache_chunk_tokens == 64
    off = tapp.config_from_args(_args())
    assert off.prefix_cache_config() is None and off.speculative_config() is None


@pytest.mark.parametrize("flags,spec", [
    (["--prefill-chunk", "256", "--prefix-cache-chunk", "64"],
     {"prefillChunk": 256, "prefixCache": {"chunkTokens": 64}}),
    (["--prefix-cache-budget-mb", "0"], {"prefixCache": {"budgetMB": 0}}),
    (["--prefix-cache-chunk", "-8"], {"prefixCache": {"chunkTokens": -8}}),
    (["--prefix-cache-l2-budget-mb", "-1"], {"prefixCache": {"l2BudgetMB": -1}}),
    (["--speculative-draft-tokens", "0"], {"speculative": {"draftTokens": 0}}),
    (["--speculative-draft-tokens", "65"], {"speculative": {"draftTokens": 65}}),
    (["--speculative-ngram-min", "3", "--speculative-ngram-max", "2"],
     {"speculative": {"ngramMin": 3, "ngramMax": 2}}),
    (["--speculative-ngram-min", "0"], {"speculative": {"ngramMin": 0}}),
])
def test_bad_feature_flags_are_refused_as_the_reference_refuses_them(flags, spec):
    """Each bad value is a ValueError at startup with the message of the
    reference's ``TpuSpec`` for the same values, and nothing with the
    feature off."""
    from tpumlops.utils.config import TpuSpec

    feature = "--prefix-cache" if "prefixCache" in spec else "--speculative"
    key = "prefixCache" if "prefixCache" in spec else "speculative"
    with pytest.raises(ValueError) as ref:
        TpuSpec.from_spec({**spec, key: {**spec[key], "enabled": True}})
    with pytest.raises(ValueError) as port:
        tapp.config_from_args(_args(feature, "1", *flags))
    assert str(port.value) == str(ref.value)
    tapp.config_from_args(_args(*flags))  # off: never refused


def test_metrics_deltas_equal_the_engine_counters(tiny_llama, caplog):
    """A warm request, then a speculative one: the prefix-cache and spec
    counters on /metrics move by the engine's counters, and the completion
    lines carry the same cached and accepted tokens."""
    import logging

    h = _serve(tiny_llama, prefill_chunk=8, prefix_cache=True, prefix_cache_budget_mb=1,
               speculative=True)
    try:
        eng = h.engine
        with caplog.at_level(logging.INFO, logger="tpumlops_torch.server.requests"):
            prompt = list(range(2, 22))
            for _ in range(2):
                assert _request(h, "POST", GEN, {"prompt_ids": prompt,
                                                 "max_new_tokens": 3})[0] == 200
            assert (eng.prefix_hits, eng.prefix_cached_tokens) == (1, 16)
            code, _, _ = _request(h, "POST", GEN, {"prompt_ids": [1, 2, 3] * 5,
                                                   "max_new_tokens": 12})
            assert code == 200
        assert eng.spec_proposed_tokens > 0
        _, text, _ = _request(h, "GET", "/metrics")
        fams = {f.name: f for f in text_string_to_metric_families(text)}

        def value(name, suffix="_total"):
            return sum(s.value for s in fams[name].samples if s.name == name + suffix)

        assert value("tpumlops_prefix_cache_hits") == eng.prefix_hits
        assert value("tpumlops_prefix_cache_cached_tokens") == eng.prefix_cached_tokens
        assert value("tpumlops_prefix_cache_evictions") == eng.prefix_evictions
        assert value("tpumlops_spec_proposed_tokens") == eng.spec_proposed_tokens
        assert value("tpumlops_spec_accepted_tokens") == eng.spec_accepted_tokens
        assert value("tpumlops_engine_dispatches", "_total") == sum(
            eng.dispatches_total.values())
        lines = [r.getMessage() for r in caplog.records if "generate done" in r.getMessage()]
        assert len(lines) == 3
        assert "cached_tokens=0 " in lines[0] and "cached_tokens=16 " in lines[1]
        assert lines[1].count("prefill_chunks=1 ") == 1
        accepted = sum(int(ln.split("spec_accepted=")[1].split("/")[0]) for ln in lines)
        assert accepted == eng.spec_accepted_tokens
    finally:
        h.stop()
