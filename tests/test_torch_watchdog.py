"""The port's scheduler watchdog and poison quarantine against the JAX
package's (the cases of ``tests/test_watchdog.py``).

- Unit: the same scenarios drive the port's and the reference's
  ``EngineWatchdog`` (millisecond deadlines, ``on_exit`` a recording
  callable): quiet while beaten, silent while unarmed, a stall fires once
  with the tick kind and the inventory, a later beat recovers and re-arms,
  a persistent stall exits once, ``on_age`` feeds the gauge (0 disarmed), an
  inventory that raises is tolerated.  Both classes give the same event
  sequences.
- A served port replica (tiny Llama on the CPU) with a wedged tick:
  ``/readyz`` 503 ``stalled`` within the deadline, the stall counter and the
  age gauge on ``/metrics``, a ``watchdog`` event with the tick kind and the
  wedged request in the inventory, 200 again once the tick completes; an
  idle engine with a sub-second deadline never stalls.
- Poison quarantine: a second admission crash of one prompt quarantines it
  (whole-prompt, chunked, packed and restore handlers) and the third submit
  raises ``PoisonRequest`` while an innocent prompt is served; a decode
  crash never quarantines; the fingerprint is the reference's.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as TR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.scripts import (
    profile_stress,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    prefix_cache as tpc,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    watchdog as twd,
)
from tpumlops.server import generation as JG
from tpumlops.server import watchdog as jwd

CLASSES = [pytest.param(twd.EngineWatchdog, id="port"),
           pytest.param(jwd.EngineWatchdog, id="reference")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait_for(pred, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# -- unit: the monitor itself, port and reference -----------------------------


@pytest.mark.parametrize("cls", CLASSES)
def test_deadline_must_be_positive(cls):
    for bad in (0, -1):
        with pytest.raises(ValueError):
            cls(deadline_s=bad)


@pytest.mark.parametrize("cls", CLASSES)
def test_beating_keeps_an_armed_watchdog_quiet(cls):
    events = []
    wd = cls(deadline_s=0.2, grace_s=60, poll_s=0.02, on_stall=lambda *a: events.append(a),
             on_exit=lambda: events.append("exit"))
    wd.arm()
    wd.start()
    try:
        for _ in range(25):
            wd.beat("decode")
            time.sleep(0.02)
        assert events == [] and wd.stalls_total == 0
    finally:
        wd.stop()


@pytest.mark.parametrize("cls", CLASSES)
def test_an_unarmed_watchdog_never_stalls(cls):
    events = []
    wd = cls(deadline_s=0.05, grace_s=60, poll_s=0.02, on_stall=lambda *a: events.append(a),
             on_exit=lambda: events.append("exit"))
    wd.start()  # never armed: the start-up's semantics
    try:
        time.sleep(0.25)
        assert events == []
    finally:
        wd.stop()


def _stall_once(cls):
    stalls = []
    inventory = [{"slot": 0, "request_id": "r-1"}]
    wd = cls(deadline_s=0.1, grace_s=60, poll_s=0.02,
             on_stall=lambda kind, age, inv: stalls.append((kind, age, inv)),
             on_exit=lambda: stalls.append("exit"), slot_inventory=lambda: inventory)
    wd.arm()
    wd.beat("prefill")  # the tick about to wedge
    wd.start()
    try:
        _wait_for(lambda: stalls, msg="stall")
        time.sleep(0.25)  # well past further polls: no second stall
        return stalls, wd.stalls_total
    finally:
        wd.stop()


def test_a_stall_fires_once_with_kind_and_inventory_as_the_reference():
    runs = [_stall_once(c) for c in (twd.EngineWatchdog, jwd.EngineWatchdog)]
    for stalls, total in runs:
        assert len(stalls) == 1 and total == 1
        kind, age, inv = stalls[0]
        assert kind == "prefill" and age > 0.1 and inv == [{"slot": 0, "request_id": "r-1"}]
    assert [(k, i) for k, _, i in runs[0][0]] == [(k, i) for k, _, i in runs[1][0]]


def _recover_and_restall(cls):
    events = []
    wd = cls(deadline_s=0.1, grace_s=60, poll_s=0.02, on_stall=lambda *a: events.append("stall"),
             on_recover=lambda: events.append("recover"), on_exit=lambda: events.append("exit"))
    wd.arm()
    wd.beat("decode")
    wd.start()
    try:
        _wait_for(lambda: "stall" in events, msg="first stall")
        wd.beat("decode")  # the wedged tick completed after all
        _wait_for(lambda: "recover" in events, msg="recover")
        _wait_for(lambda: events.count("stall") == 2, msg="second stall")  # a new incident
        return events[:3]
    finally:
        wd.stop()


def test_a_recovery_beat_recovers_and_rearms_as_the_reference():
    want = ["stall", "recover", "stall"]
    assert _recover_and_restall(twd.EngineWatchdog) == _recover_and_restall(
        jwd.EngineWatchdog) == want


@pytest.mark.parametrize("cls", CLASSES)
def test_a_persistent_stall_exits_once(cls):
    events = []
    wd = cls(deadline_s=0.1, grace_s=0.15, poll_s=0.02, on_stall=lambda *a: events.append("stall"),
             on_exit=lambda: events.append("exit"))
    wd.arm()
    wd.start()
    try:
        _wait_for(lambda: "exit" in events, msg="exit escalation")
        time.sleep(0.15)
        assert events == ["stall", "exit"]  # never a second exit
    finally:
        wd.stop()


@pytest.mark.parametrize("cls", CLASSES)
def test_on_age_feeds_the_gauge_and_reads_zero_disarmed(cls):
    ages = []
    wd = cls(deadline_s=5, grace_s=60, poll_s=0.02, on_age=ages.append, on_exit=lambda: None)
    wd.start()
    try:
        _wait_for(lambda: len(ages) >= 3, msg="age samples")
        assert all(a == 0.0 for a in ages)
        wd.arm()
        time.sleep(0.15)
        assert any(a > 0.0 for a in ages)
        wd.disarm()
        n = len(ages)
        _wait_for(lambda: len(ages) > n + 1, msg="disarmed samples")
        assert ages[-1] == 0.0
    finally:
        wd.stop()


@pytest.mark.parametrize("cls", CLASSES)
def test_an_inventory_that_raises_is_tolerated(cls):
    stalls = []

    def bad_inventory():
        raise RuntimeError("racing the wedged thread")

    wd = cls(deadline_s=0.05, grace_s=60, poll_s=0.02,
             on_stall=lambda kind, age, inv: stalls.append(inv), on_exit=lambda: None,
             slot_inventory=bad_inventory)
    wd.arm()
    wd.start()
    try:
        _wait_for(lambda: stalls, msg="stall despite the raise")
        assert stalls[0] == []
    finally:
        wd.stop()


# -- a served replica with a wedged tick -------------------------------------------


@pytest.fixture(scope="module")
def tiny_pred():
    cfg = T.LlamaConfig.tiny(max_seq=64)
    params = T.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)
    return TR._build_llama(params, cfg, dtype=torch.float32)


def _serve(pred, **config):
    conf = tapp.ServerConfig(model_name="llm", host="127.0.0.1", port=0, dtype="float32",
                             max_slots=2, device="cpu", **config)
    srv = tapp.build_server(pred, conf)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw.decode()


def test_a_wedged_tick_flips_readyz_journals_and_recovers(tiny_pred):
    srv, th = _serve(tiny_pred, trace_ring=128, watchdog_deadline_s=0.5,
                     watchdog_grace_s=3600.0)
    eng = srv.engine
    exits = []
    eng._watchdog.on_exit = lambda: exits.append(1)  # a test never exits the process
    try:
        assert eng._watchdog._armed and _get(srv, "/readyz")[0] == 200
        real = eng._device_step
        wedge = threading.Event()

        def wedged(*a, **kw):
            if not wedge.is_set():
                wedge.set()
                time.sleep(2.0)  # far past the deadline: a hung card's shape
            return real(*a, **kw)

        eng._device_step = wedged
        fut = eng.submit([5, 9, 2], 3, request_id="wedged-req")
        _wait_for(lambda: _get(srv, "/readyz")[0] == 503, timeout=1.5, msg="readyz flip")
        assert json.loads(_get(srv, "/readyz")[1]) == {"ready": False, "lifecycle": "stalled"}
        metrics = _get(srv, "/metrics")[1]
        stall = [ln for ln in metrics.splitlines()
                 if ln.startswith("tpumlops_engine_watchdog_stalls_total{")]
        assert stall and float(stall[0].rsplit(" ", 1)[1]) == 1.0
        age = [ln for ln in metrics.splitlines()
               if ln.startswith("tpumlops_engine_watchdog_last_tick_age_seconds{")]
        assert age and float(age[0].rsplit(" ", 1)[1]) > 0.5
        events = json.loads(_get(srv, "/debug/engine")[1])["events"]
        wd_events = [e for e in events if e["event"] == "watchdog"]
        assert len(wd_events) == 1
        assert wd_events[0]["kind"] == "decode" and wd_events[0]["age_s"] > 0.5
        assert any(s["request_id"] == "wedged-req" for s in wd_events[0]["slots"])
        assert len(fut.result(timeout=30)) == 3
        _wait_for(lambda: _get(srv, "/readyz")[0] == 200, timeout=5, msg="re-ready")
        eng._device_step = real
        assert not exits
    finally:
        srv.shutdown_all()
        th.join(timeout=10)
    assert eng._watchdog._thread is None and not eng._watchdog._armed


def test_an_idle_engine_below_a_second_deadline_never_stalls(tiny_pred):
    srv, th = _serve(tiny_pred, watchdog_deadline_s=0.4, watchdog_grace_s=3600.0)
    try:
        wd = srv.engine._watchdog
        assert srv.engine._idle_poll_s == pytest.approx(0.2)
        time.sleep(1.2)  # several one-second polls of an idle scheduler
        assert wd.stalls_total == 0 and srv.lifecycle == "ready"
        assert len(srv.engine.generate([5, 9, 2], 4)) == 4
    finally:
        srv.shutdown_all()
        th.join(timeout=10)


def test_no_watchdog_by_default(tiny_pred):
    srv, th = _serve(tiny_pred)
    try:
        assert srv.engine._watchdog is None and srv.engine._idle_poll_s == 1.0
        assert srv.engine._recorder is None and srv.engine._telemetry is None
        assert not srv.engine._sync_ticks
        assert _get(srv, "/debug/engine") == (404, json.dumps({
            "error": "flight recorder disabled; set spec.tpu.observability.traceRing "
                     "(--trace-ring) > 0"}))
        assert _get(srv, "/debug/device") == (404, json.dumps({
            "error": "device telemetry disabled; set spec.tpu.observability.deviceTelemetry "
                     "(--device-telemetry 1)"}))
        assert _get(srv, "/debug/timeseries") == (404, json.dumps({
            "error": "timeseries ring disabled; set spec.tpu.observability.timeseriesRing "
                     "(--timeseries-ring) > 0"}))
    finally:
        srv.shutdown_all()
        th.join(timeout=10)


def test_between_ticks_holds_the_scheduler_until_released(tiny_pred):
    engine = _engine(tiny_pred)
    try:
        with engine.between_ticks():
            fut = engine.submit([5, 9, 2], 3)
            time.sleep(0.3)
            assert not fut.done() and engine.dispatches_total.get("decode", 0) == 0
        assert len(fut.result(timeout=30)) == 3
    finally:
        engine.shutdown()


def test_between_ticks_gets_in_on_a_busy_scheduler(tiny_pred):
    engine = _engine(tiny_pred)
    real = engine._device_step

    def slow(*a, **kw):
        time.sleep(0.005)  # back-to-back ticks that each hold the gate
        return real(*a, **kw)

    engine._device_step = slow
    try:
        futs = [engine.submit([5, 9, 2], 50), engine.submit([7, 1], 50)]
        _wait_for(lambda: engine.dispatches_total.get("decode", 0) >= 2, msg="decode ticks")
        for _ in range(5):
            with engine.between_ticks():
                # Let in while the requests still decode, not once they end.
                assert not all(f.done() for f in futs)
                ticks = engine.dispatches_total["decode"]
                time.sleep(0.02)
                assert engine.dispatches_total["decode"] == ticks  # nothing ran meanwhile
            time.sleep(0.01)
        assert [len(f.result(timeout=30)) for f in futs] == [50, 50]
    finally:
        engine.shutdown()


def test_debug_profile_starts_and_stops_between_ticks(tiny_pred):
    srv, th = _serve(tiny_pred)
    eng = srv.engine
    held = []
    gate = eng.between_ticks

    def recording():
        held.append(torch.autograd.profiler._is_profiler_enabled)
        return gate()

    eng.between_ticks = recording
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=30)
        conn.request("POST", "/debug/profile", body=json.dumps({"duration_s": 0.1}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and body["duration_s"] == 0.1
        assert held == [False, True]  # the hold before the start, then before the stop
        assert len(eng.generate([5, 9, 2], 3)) == 3
    finally:
        srv.shutdown_all()
        th.join(timeout=10)


def test_profile_stress_script_runs_on_the_cpu(capsys):
    summary = profile_stress.main(["--device", "cpu", "--tiny", "--profiles", "2",
                                   "--duration-s", "0.1"])
    assert summary["profiles"] == summary["answered_200"] == 2
    assert summary["request_errors"] == 0 and summary["device"] == "cpu"
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["profile"] for ln in lines[:2]] == [0, 1]


# -- poison quarantine ------------------------------------------------------------------

POISON = [7, 7, 7, 7]


def _engine(pred, **kw):
    lm = pred.causal_lm
    engine = TG.GenerationEngine(lm["params"], lm["cfg"], max_slots=2, dtype=torch.float32,
                                 device="cpu", **kw)
    engine.start()
    return engine


@pytest.mark.parametrize("mode,kw,target", [
    ("whole", {}, "_device_admit"),
    ("chunked", {"prefill_chunk": 8}, "_device_chunk"),
    ("packed", {"prefill_chunk": 8, "prefill_batch": 2}, "_device_chunks"),
])
def test_a_second_admission_crash_quarantines_the_prompt(tiny_pred, mode, kw, target):
    poison_events = []
    engine = _engine(tiny_pred, on_poison=poison_events.append, **kw)
    real = getattr(engine, target)
    crashes = [0]

    def crashing(*a, **k):
        if crashes[0] < 2:
            crashes[0] += 1
            raise RuntimeError("injected admission crash")
        return real(*a, **k)

    setattr(engine, target, crashing)
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError):
                engine.submit(POISON, 3).result(timeout=30)
        _wait_for(lambda: engine.poison_quarantined_total == 1, msg="quarantine")
        with pytest.raises(TG.PoisonRequest) as info:
            engine.submit(POISON, 3)
        assert info.value.crashes == 2
        assert info.value.fingerprint == JG.GenerationEngine._fingerprint(np.asarray(POISON))
        assert engine.poison_rejected_total == 1
        assert poison_events == ["quarantined", "rejected"]
        assert len(engine.generate([5, 9, 2], 3)) == 3  # an innocent prompt: served
    finally:
        engine.shutdown()


def test_a_crashed_restore_counts_toward_the_quarantine(tiny_pred):
    """The restore handler charges the evicted sequence's prompt: two failed
    restores of one prompt quarantine it."""
    pc = tpc.PrefixCacheConfig(enabled=True, budget_bytes=1 << 22, chunk_tokens=8)
    lm = tiny_pred.causal_lm
    engine = TG.GenerationEngine(lm["params"], lm["cfg"], max_slots=1, dtype=torch.float32,
                                 device="cpu", prefill_chunk=8, prefix_cache=pc,
                                 preemption=True)

    def fail(*a, **k):
        raise RuntimeError("injected restore crash")

    engine._device_restore = fail
    be_prompt = list(range(2, 14))
    futs = []
    for round_ in range(2):
        ia = []

        def on_tok(_t, seen=[0], ia=ia):
            seen[0] += 1
            if seen[0] == 3:
                ia.append(engine.submit([30 + round_, 31, 32], 2, slo_class="interactive"))

        futs.append(engine.submit(be_prompt, 12, on_token=on_tok, slo_class="best-effort"))
        if round_ == 0:
            engine.start()
        with pytest.raises(RuntimeError):
            futs[-1].result(timeout=30)
        _wait_for(lambda: ia, msg="the interactive submit")
        assert len(ia[0].result(timeout=30)) == 2
    try:
        _wait_for(lambda: engine.poison_quarantined_total == 1, msg="quarantine")
        with pytest.raises(TG.PoisonRequest):
            engine.submit(be_prompt, 3)
    finally:
        engine.shutdown()


def test_a_decode_crash_never_quarantines(tiny_pred):
    engine = _engine(tiny_pred)
    real = engine._device_step
    fails = [0]

    def crashing(*a, **k):
        if fails[0] < 2:
            fails[0] += 1
            raise RuntimeError("injected decode crash")
        return real(*a, **k)

    engine._device_step = crashing
    try:
        for _ in range(2):
            with pytest.raises(Exception):
                engine.submit(POISON, 3).result(timeout=30)
        assert engine.poison_quarantined_total == 0
        assert len(engine.submit(POISON, 3).result(timeout=30)) == 3  # the third try serves
    finally:
        engine.shutdown()
