"""The port's flight recorder, timeseries ring and span tracer against the
JAX package's, and the port engine's journal against the JAX engine's.

- Unit parity: the same calls into the port's and the reference's
  ``FlightRecorder`` (one clock anchor for both), ``TimeseriesRing`` (one
  injected clock) and ``Tracer`` give the same snapshots, wall times
  aside; the port's Chrome trace passes the reference's
  ``_chrome_invariants`` (imported from ``tests/test_flight_recorder.py``)
  and equals the reference's export.
- Engine parity, f64 on the CPU, every request submitted before
  ``start()`` so the schedule is fixed: the port engine and the JAX engine
  (``warmup=False``), each with a recorder, record the same tick sequence
  (kind, active slots, batch fill, tokens, accepted drafts, steps, roles)
  and, per request, the same lifecycle events on the same rows and the
  same trace counts, with the tokens equal.  Split K 1 and K 4, chunked and
  packed prefill with a prefix hit, a speculative verify, the unified
  engine and one preemption.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_flight_recorder import _chrome_invariants

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    flight_recorder as tfr,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    prefix_cache as tpc,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    speculative as tsp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    timeseries as tts,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    tracing as ttr,
)
from tpumlops.models import llama as J
from tpumlops.server import flight_recorder as jfr
from tpumlops.server import generation as JG
from tpumlops.server import prefix_cache as jpc
from tpumlops.server import speculative as jsp
from tpumlops.server import timeseries as jts
from tpumlops.utils import tracing as jtr

JCFG = J.LlamaConfig.tiny(max_seq=64)
TCFG = T.LlamaConfig.tiny(max_seq=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# -- unit parity ----------------------------------------------------------------


def _pair_recorders(capacity):
    """A port and a reference recorder on one clock anchor, so the times
    the callers pass land on the same microseconds in both."""
    recs = (tfr.FlightRecorder(capacity), jfr.FlightRecorder(capacity))
    for r in recs[1:]:
        r._t0_perf, r._t0_unix = recs[0]._t0_perf, recs[0]._t0_unix
    return recs


def _drive_recorder(rec, mod, base: float) -> None:
    """Every record shape: plain, fused, super-step and telemetry ticks,
    lifecycle events with extra fields, and completed traces (three finish
    reasons, a relayed one, one that never reached a row)."""
    for i in range(6):
        rec.tick("decode", base + i * 0.01, 0.004, active_slots=2, queue_depth=i,
                 tokens=2)
    rec.tick("multistep", base + 0.07, 0.02, active_slots=3, tokens=11, steps=4)
    rec.tick("superstep", base + 0.1, 0.03, active_slots=4, batch_fill=1, tokens=9,
             spec_accepted=2, steps=2, roles={"prefill": 1, "decode": 2, "verify": 1})
    rec.tick("prefill", base + 0.14, 0.01, batch_fill=1, tokens=1,
             util={"mfu": 0.31, "hbm_bw_util": 0.42})
    rec.tick("preempt-evict", base + 0.16, 0.002, active_slots=1, tokens=40)
    rec.event("", "watchdog", kind="decode", age_s=2.5, slots=[{"slot": 0}])
    rec.event("r-q", "poison-quarantine", fingerprint="ab" * 8, crashes=2)
    for i, reason in enumerate(["length", "eos", "cancelled"]):
        tr = mod.RequestTrace(request_id=f"req-{i}", prompt_tokens=4 + i, slot=i,
                              trace_id="0" * 31 + str(i) if i == 1 else "",
                              parent_span="f" * 16 if i == 1 else "")
        tr.t_submit = base + i * 0.001
        tr.t_admit = tr.t_submit + 0.002
        tr.t_first = tr.t_admit + 0.003
        for k in range(3 + i):
            tr.note_token(tr.t_first + 0.004 * k)
        tr.prefill_chunks, tr.cached_tokens = 1 + i, 8 * i
        tr.spec_proposed, tr.spec_accepted = 3 * i, i
        if i == 2:
            tr.t_handoff, tr.handoff_ms = tr.t_submit + 0.001, 1.5
        tr.finish(reason, t=tr.t_first + 0.05)
        rec.event(tr.request_id, "finish", slot=tr.slot)
        rec.complete(tr)
    never = mod.RequestTrace(request_id="queued")
    never.t_submit = base + 0.2
    never.finish("shutdown", t=base + 0.3)
    rec.complete(never)


def _without_event_times(snap):
    snap = dict(snap)
    snap["events"] = [{k: v for k, v in e.items() if k != "ts_us"} for e in snap["events"]]
    return snap


@pytest.mark.parametrize("capacity", [4, 64], ids=["rotated", "whole"])
def test_recorder_snapshot_equals_the_reference(capacity):
    port, ref = _pair_recorders(capacity)
    base = time.perf_counter()
    _drive_recorder(port, tfr, base)
    _drive_recorder(ref, jfr, base)
    got, want = port.snapshot(), ref.snapshot()
    assert got["ticks_recorded"] == 10 and len(got["ticks"]) == min(capacity, 10)
    assert _without_event_times(got) == _without_event_times(want)


def test_chrome_trace_passes_the_reference_invariants_and_equals_its_export():
    port, ref = _pair_recorders(64)
    base = time.perf_counter()
    _drive_recorder(port, tfr, base)
    _drive_recorder(ref, jfr, base)
    doc = port.chrome_trace()
    _chrome_invariants(doc)

    def strip(d):
        return [{k: v for k, v in e.items() if not (e.get("cat") == "lifecycle" and k == "ts")}
                for e in d["traceEvents"]]

    assert strip(doc) == strip(ref.chrome_trace())
    assert doc["started_unix"] == ref.chrome_trace()["started_unix"]
    counters = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert counters == {"role_fill", "mfu", "hbm_bw_util"}


def test_request_trace_timing_block_equals_the_reference():
    blocks = []
    for mod in (tfr, jfr):
        tr = mod.RequestTrace(request_id="r", prompt_tokens=3)
        tr.t_submit, tr.t_admit, tr.t_first = 1.0, 1.25, 1.5
        tr.note_token(1.5)
        tr.finish("eos", t=2.0)
        tr.finish("cancelled", t=3.0)  # the first writer wins
        blocks.append(tr.timing_block())
    assert blocks[0] == blocks[1]
    assert blocks[0]["finish_reason"] == "eos" and blocks[0]["total_ms"] == 1000.0
    with pytest.raises(ValueError, match="capacity"):
        tfr.FlightRecorder(0)


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


class _Util:
    """A stand-in telemetry layer: ``last_util`` under ``_util_lock``."""

    def __init__(self, util):
        import threading

        self._util_lock = threading.Lock()
        self.last_util = util


def _drive_ring(mod, telemetry):
    clock = _Clock(1000.2)
    ring = mod.TimeseriesRing(3, clock=clock)
    if telemetry:
        ring.bind_telemetry(_Util({"decode": {"mfu": 0.01, "hbm_bw_util": 0.3},
                                   "prefill": {"mfu": 0.2, "hbm_bw_util": 0.5}}))
    for sec in range(5):
        clock.t = 1000.2 + sec
        for i in range(300 if sec == 1 else 3):  # past the per-bucket cap once
            ring.observe_tick("decode", 0.001 * (1 + i % 7))
            ring.observe_itl(0.002 * (1 + i % 5))
        ring.observe_tick("multistep", 0.03)
        ring.observe_decode_step(3, 0.01, queue_depth=sec, admitting=1)
        ring.inc_shed("budget")
        if sec == 2:
            ring.inc_poison("rejected")
            ring.mark("attach")
    return ring.snapshot()


@pytest.mark.parametrize("telemetry", [False, True], ids=["plain", "telemetry"])
def test_timeseries_ring_equals_the_reference(telemetry):
    got, want = _drive_ring(tts, telemetry), _drive_ring(jts, telemetry)
    assert got == want
    assert len(got["samples"]) == 4 and got["samples"][-1]["open"]
    assert got["samples"][0]["ticks"]["decode"]["n"] == 300
    with pytest.raises(ValueError, match="capacity"):
        tts.TimeseriesRing(0)


def test_tracer_stats_equal_the_reference():
    stats = []
    for mod in (ttr, jtr):
        tracer = mod.Tracer()
        for name, n in (("reconcile", 3), ("gate", 1)):
            for _ in range(n):
                with tracer.span(name):
                    pass
        d = tracer.as_dict()
        stats.append({k: (v["count"], sorted(v)) for k, v in d.items()})
        assert "reconcile: n=3" in tracer.report()
    assert stats[0] == stats[1]
    assert isinstance(ttr.GLOBAL_TRACER, ttr.Tracer) and ttr.span == ttr.GLOBAL_TRACER.span


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    with ttr.torch_profile(str(tmp_path / "cap")):
        with ttr.annotate("probe-region"):
            torch.ones(8).sum()
    trace = (tmp_path / "cap" / ttr.TRACE_FILE).read_text()
    assert "probe-region" in trace and "traceEvents" in trace


@pytest.mark.parametrize("preset,kept", [(None, "0"), ("1", "1")])
def test_keep_cupti_sets_no_teardown_unless_the_caller_chose(monkeypatch, preset, kept):
    if preset is None:
        monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    else:
        monkeypatch.setenv("TEARDOWN_CUPTI", preset)
    ttr.keep_cupti()
    assert ttr.os.environ["TEARDOWN_CUPTI"] == kept


def test_torch_profile_holds_only_around_start_and_stop(tmp_path):
    seen = []

    class Hold:
        def __enter__(self):
            seen.append(("enter", torch.autograd.profiler._is_profiler_enabled))

        def __exit__(self, *exc):
            seen.append(("exit", torch.autograd.profiler._is_profiler_enabled))

    with ttr.torch_profile(str(tmp_path / "cap"), Hold):
        seen.append(("body", torch.autograd.profiler._is_profiler_enabled))
    # Started inside the first hold, running outside both, stopped inside
    # the second; the trace written after it.
    assert seen == [("enter", False), ("exit", True), ("body", True),
                    ("enter", True), ("exit", False)]
    assert (tmp_path / "cap" / ttr.TRACE_FILE).stat().st_size > 0


# -- engine parity ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(x64):
    jp = J.init(jax.random.key(0), JCFG, dtype=jnp.float64)
    return jp, convert.from_jax_numpy(jax.device_get(jp))


SHARED = list(range(3, 19))  # two whole prefix chunks of 8
PROMPTS = {
    "split": [([5, 9, 2], 6), ([7, 1, 4, 8, 3], 9), ([42], 4), ([2, 3], 7)],
    "prefix": [(SHARED + [60, 61], 5), ([70, 71, 72], 4), (SHARED + [90], 6)],
    "spec": [([1, 2, 3, 4] * 4, 10), ([9, 8, 7] * 3, 8)],
    "preempt": [],
}


def _cfgs(case, mod_pc, mod_sp):
    pc = mod_pc.PrefixCacheConfig(enabled=True, budget_bytes=1 << 22, chunk_tokens=8)
    sp = mod_sp.SpeculativeConfig(enabled=True, draft_tokens=3)
    return {
        "split-k1": ("split", dict(max_slots=3)),
        "split-k4": ("split", dict(max_slots=3, decode_steps=4)),
        "chunked-prefix": ("prefix", dict(max_slots=2, prefix_cache=pc)),
        "packed-prefix": ("prefix", dict(max_slots=2, prefix_cache=pc, prefill_batch=2)),
        "speculative": ("spec", dict(max_slots=2, speculative=sp)),
        "unified": ("prefix", dict(max_slots=2, prefix_cache=pc, prefill_batch=2,
                                   decode_steps=2, unified_step=True)),
        "preempt": ("preempt", dict(max_slots=1, prefix_cache=pc, preemption=True)),
    }[case]


def _journal(engine_cls, params, cfg, dtype, rec_mod, pc_mod, sp_mod, case, start):
    """Run a case with a recorder; returns (tokens by request id, ticks,
    events by request id, completed traces)."""
    group, kw = _cfgs(case, pc_mod, sp_mod)
    rec = rec_mod.FlightRecorder(4096)
    engine = engine_cls(params, cfg, dtype=dtype, recorder=rec, **kw)
    futs = {}

    def submit(rid, prompt, n, **extra):
        futs[rid] = engine.submit(prompt, n, request_id=rid,
                                  trace=rec_mod.RequestTrace(request_id=rid), **extra)

    if group == "preempt":
        def on_tok(_t, seen=[0]):
            seen[0] += 1
            if seen[0] == 4:  # on the scheduler thread: a fixed eviction point
                submit("ia", list(range(30, 40)), 5, slo_class="interactive")

        submit("be", list(range(2, 14)), 20, on_token=on_tok, slo_class="best-effort")
    else:
        for i, (prompt, n) in enumerate(PROMPTS[group]):
            submit(f"r{i}", prompt, n)
    start(engine)
    try:
        deadline = time.monotonic() + 120
        while len(futs) < (2 if group == "preempt" else len(PROMPTS[group])):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        tokens = {rid: np.asarray(f.result(timeout=120)).tolist() for rid, f in futs.items()}
    finally:
        engine.shutdown()
    snap = rec.snapshot()
    keep = ("kind", "active_slots", "batch_fill", "tokens", "spec_accepted", "steps", "roles")
    ticks = [{k: t[k] for k in keep if k in t} for t in snap["ticks"]]
    events: dict = {}
    for e in snap["events"]:
        events.setdefault(e["request_id"], []).append((e["event"], e["slot"]))
    counts = ("request_id", "prompt_tokens", "prefill_chunks", "cached_tokens",
              "spec_proposed", "spec_accepted", "tokens", "finish_reason")
    traces = sorted(({k: r[k] for k in counts} for r in snap["requests"]),
                    key=lambda r: r["request_id"])
    return tokens, ticks, events, traces


@pytest.mark.parametrize("case", ["split-k1", "split-k4", "chunked-prefix", "packed-prefix",
                                  "speculative", "unified", "preempt"])
def test_engine_journal_equals_the_jax_engine(tiny, case):
    jp, tp = tiny

    def port_engine(params, cfg, **kw):
        return TG.GenerationEngine(params, cfg, device="cpu", **kw)

    got = _journal(port_engine, tp, TCFG, torch.float64, tfr, tpc, tsp, case,
                   lambda e: e.start())
    want = _journal(JG.GenerationEngine, jp, JCFG, jnp.float64, jfr, jpc, jsp, case,
                    lambda e: e.start(warmup=False))
    assert got[0] == want[0]  # tokens
    assert got[1] == want[1]  # the tick sequence
    assert got[2] == want[2]  # each request's events and rows
    assert got[3] == want[3]  # each request's trace counts
    kinds = {t["kind"] for t in got[1]}
    expect = {"split-k1": {"prefill", "decode"}, "split-k4": {"multistep"},
              "chunked-prefix": {"seed"}, "packed-prefix": {"packed-prefill", "seed"},
              "speculative": {"verify"}, "unified": {"superstep", "seed"},
              "preempt": {"preempt-evict", "preempt-restore"}}[case]
    assert expect <= kinds, kinds
    if case == "unified":
        assert all("roles" in t and t["steps"] == 2 for t in got[1] if t["kind"] == "superstep")
