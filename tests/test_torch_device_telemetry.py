"""The port's device telemetry, compile cache and observability surface
against the JAX package.

- The cost model's ``(flops, bytes)`` for decode, verify, prefill,
  superstep, seed and the sp/tp extras equal the reference's to float
  equality, from a JAX tree converted by ``convert.from_jax_numpy`` (f32,
  bf16 and int8 trees, dense and int8kv caches); the HBM ledger, its
  snapshot (the same peaks), the weight bytes by dtype and the KV row
  bytes equal the reference's; ``tick_util`` equals the reference's on the
  same peaks and clamps the same way.  At tp > 1 the collective seconds
  count the dispatch's own tokens (a rank's rows x positions x steps), not
  tokens read back from flops that count the attention's padded window.
- Peaks: the H100's published figures, detected on a card whose name
  holds "H100", else the same figures marked ``assumed``; the caching
  allocator's counts under the reference's keys; the capacity line.
- The compile observatory: kernel builds reported by ``ops/_build.py``
  (a library already in the build directory is a hit, no nvcc), the
  directory pointer, graph captures attributed to their program with the
  watchdog disarmed around a recapture.
- A port server with every option on: ``/debug/*``, the ``debug``
  timing block, the 422 of a quarantined prompt, ``/debug/profile``, and
  exactly the reference's ``/metrics`` families (``NOT_YET`` lists those
  still to be ported: none).
"""

import http.client
import json
import os
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as TR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    _build,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    device_telemetry as tdt,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    watchdog as twd,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.cuda_graphs import (
    MultistepProgram,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    compile_cache as tcc,
)
from tpumlops.models import llama as J
from tpumlops.models.quantization import quantize_llama as j_quantize_llama
from tpumlops.server import device_telemetry as jdt
from tpumlops.server.metrics import ServerMetrics as JaxServerMetrics

JCFG = J.LlamaConfig.tiny(max_seq=64)
TCFG = T.LlamaConfig.tiny(max_seq=64)
# The reference families a port server does not register yet (the
# tensor-parallel collective walls came with the mesh).
NOT_YET: set = set()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(kind):
    jp = J.init(jax.random.key(0), JCFG, dtype=jnp.float32)
    if kind == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    elif kind == "int8":
        jp = j_quantize_llama(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp))
    return jp, convert.from_jax_numpy(jax.device_get(jp))


@pytest.mark.parametrize("kind,kv_quant,dtype_bytes", [
    ("f32", False, 4), ("bf16", False, 2), ("int8", True, 2), ("int8", False, 2),
])
def test_cost_model_equals_the_reference(kind, kv_quant, dtype_bytes):
    jp, tp = _trees(kind)
    ref = jdt.LlamaCostModel.for_model(jp, JCFG, kv_quant=kv_quant, dtype_bytes=dtype_bytes)
    got = tdt.LlamaCostModel.for_model(tp, TCFG, kv_quant=kv_quant, dtype_bytes=dtype_bytes)
    for f in ("matmul_params", "weight_bytes", "num_layers", "num_heads", "num_kv_heads",
              "head_dim", "kv_elem_bytes", "tp", "hidden_size", "vocab_size", "act_bytes",
              "dp", "sp"):
        assert getattr(got, f) == getattr(ref, f), f
    assert T.matmul_param_count(TCFG) == J.matmul_param_count(JCFG)
    for rows, window, s in ((3, 16, 1), (4, 48, 1), (2, 64, 4), (1, 24, 17)):
        assert got.decode(rows, window, s) == ref.decode(rows, window, s)
        assert got.superstep(rows, window, s, 4) == ref.superstep(rows, window, s, 4)
        assert got.superstep(rows, window, s, 1) == ref.superstep(rows, window, s, 1)
    for rows, chunk, attended in ((1, 16, None), (4, 8, 36.0), (2, 32, 8.0)):
        assert got.prefill(rows, chunk, attended) == ref.prefill(rows, chunk, attended)
    for tokens in (8, 40):
        assert got.seed(tokens) == ref.seed(tokens)
        assert got.sp_prefill(tokens) == ref.sp_prefill(tokens)
        assert got.ring_bytes(tokens) == ref.ring_bytes(tokens) == {}
    assert got.collective_bytes(4, 2) == ref.collective_bytes(4, 2) == {}
    mesh = {"tp": 2, "dp": 1, "sp": 2}
    got2 = tdt.LlamaCostModel.for_model(tp, TCFG, kv_quant, dtype_bytes, mesh_shape=mesh)
    ref2 = jdt.LlamaCostModel.for_model(jp, JCFG, kv_quant, dtype_bytes, mesh_shape=mesh)
    assert got2.collective_bytes(4, 2) == ref2.collective_bytes(4, 2)
    assert got2.ring_bytes(40) == ref2.ring_bytes(40)


@pytest.mark.parametrize("kind,kv_quant,slots,budget", [
    ("f32", False, 3, 0), ("bf16", False, 4, 1 << 20), ("int8", True, 2, 0),
])
def test_hbm_ledger_equals_the_reference(kind, kv_quant, slots, budget):
    jp, tp = _trees(kind)
    assert tdt.weights_bytes_by_dtype(tp) == jdt.weights_bytes_by_dtype(jp)
    for q in (False, True):
        for nb in (2, 4, 8):
            assert (tdt.kv_cache_bytes_per_row(TCFG, q, nb)
                    == jdt.kv_cache_bytes_per_row(JCFG, q, nb))
    assert tdt.sampling_state_bytes(slots) == jdt.sampling_state_bytes(slots)
    got = tdt.build_hbm_ledger(tp, TCFG, slots, kv_quant=kv_quant,
                               prefix_cache_budget_bytes=budget)
    ref = jdt.build_hbm_ledger(jp, JCFG, slots, kv_quant=kv_quant,
                               prefix_cache_budget_bytes=budget)
    assert got.components == ref.components
    assert got.host_components == ref.host_components
    assert got.device_total() == ref.device_total()
    peaks = tdt.detect_peaks()
    assert got.snapshot(peaks) == ref.snapshot(peaks)  # measured: None on both
    assert got.max_cache_rows(10 * 2**20) == ref.max_cache_rows(10 * 2**20)


def test_tick_util_equals_the_reference_on_the_same_peaks():
    port, ref = tdt.DeviceTelemetry(), jdt.DeviceTelemetry()
    ref._chip_peaks = ref.peaks = port.peaks
    for kind, wall, flops, nbytes in (("decode", 0.008, 5e10, 2.7e10),
                                      ("prefill", 0.02, 4e12, 1.4e10),
                                      ("multistep", 1e-12, 1e9, 1e9),  # clamped to 1
                                      ("seed", 0.001, 0.0, 3e6)):
        assert port.tick_util(kind, wall, flops, nbytes) == ref.tick_util(kind, wall, flops,
                                                                         nbytes)
    assert port.last_util == ref.last_util
    assert port.last_util["multistep"] == {"mfu": 1.0, "hbm_bw_util": 1.0}
    assert port.last_util["seed"]["mfu"] == 0.0
    snap = port.snapshot()
    assert snap["peaks"]["device"] == "nvidia-h100 (assumed)" and snap["hbm"] is None
    assert snap["utilization"] == port.last_util


def test_collective_seconds_count_the_dispatch_tokens():
    """A tp-2, dp-2 engine's decode, K-step, verify, super-step and packed
    ticks size their collectives by the positions one rank's forward ran;
    without that count ``tick_util`` derives the tokens from flops as the
    reference does, which overcounts a long window."""
    import types

    _, tp = _trees("f32")
    tel = tdt.DeviceTelemetry()
    tel.attach_model(tp, TCFG, 4, mesh_shape={"dp": 2, "tp": 2})
    link = tel.peaks.link_bytes_per_s
    eng = SimpleNamespace(_telemetry=tel, max_slots=4, _mesh=SimpleNamespace(dp=2))
    eng._rank_rows = types.MethodType(TG.GenerationEngine._rank_rows, eng)
    cost = {name: types.MethodType(getattr(TG.GenerationEngine, f"_cost_{name}"), eng)
            for name in ("decode", "superstep", "prefill", "seed")}
    cases = ((cost["decode"](48), 2.0), (cost["decode"](48, steps=4), 8.0),
             (cost["decode"](48, 5), 10.0), (cost["superstep"](48, 8, 4), 22.0),
             (cost["prefill"](1, 16), 16.0), (cost["prefill"](4, 8, packed=True), 16.0))
    for (flops, nbytes, tokens), want in cases:
        assert tokens == want
        util = tel.tick_util("decode", 0.01, flops, nbytes, tokens)
        coll = tel.cost.collective_bytes(want)
        assert util["collective_s"] == float(f"{sum(coll.values()) / link:.3g}")
    flops, nbytes, tokens = cost["decode"](4000)
    derived = flops / (2.0 * tel.cost.matmul_params)
    assert derived > 1.5 * tokens  # the padded window's attention flops
    coll = tel.cost.collective_bytes(derived)
    assert tel.tick_util("decode", 0.01, flops, nbytes)["collective_s"] == float(
        f"{sum(coll.values()) / link:.3g}")
    assert cost["seed"](8)[2] == 0.0


def test_peaks_are_the_h100s_detected_on_an_h100_and_assumed_elsewhere(monkeypatch):
    p = tdt.detect_peaks()
    assert (p.kind, p.source) == ("nvidia-h100 (assumed)", "assumed")
    assert (p.flops_per_s, p.hbm_bytes_per_s, p.hbm_bytes) == (989e12, 3.35e12, 80 * 2**30)
    assert tdt.measured_memory() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i=0: {
        "allocated_bytes.all.current": 7, "allocated_bytes.all.peak": 9,
        "reserved_bytes.all.current": 16})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i=0: SimpleNamespace(total_memory=85 * 10**9))
    p = tdt.detect_peaks()
    assert (p.kind, p.source, p.flops_per_s) == ("nvidia-h100", "detected", 989e12)
    assert p.scaled(2).hbm_bytes == 160 * 2**30 and p.scaled(2).chips == 2
    assert tdt.measured_memory() == {"bytes_in_use": 7, "peak_bytes_in_use": 9,
                                     "bytes_reserved": 16, "bytes_limit": 85 * 10**9,
                                     "devices": 1}
    led = tdt.HbmLedger(components={"weights_bfloat16": 5, "kv_cache": 2})
    assert led.snapshot(p)["ledger_vs_measured_pct"] == 0.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA A100-SXM4-80GB")
    assert tdt.detect_peaks().source == "assumed"


def test_capacity_line_counts_what_the_reference_counts(caplog):
    jp, tp = _trees("bf16")
    line = tdt.capacity_log_line(tp, TCFG, kv_quant=False)
    ref = jdt.capacity_log_line(jp, JCFG, kv_quant=False)
    assert line.split(" max cache rows")[0] == ref.split(" max cache rows")[0]
    assert line.endswith("(hbm 80.0 GiB assumed nvidia-h100 (assumed))")
    pred = TR._build_llama(tp, TCFG, dtype=torch.float32)
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
        loader as tloader,
    )

    with caplog.at_level("INFO", logger="tpumlops.capacity"):
        assert tloader._log_capacity(pred, "int8kv") is pred
    assert any("int8kv" in r.getMessage() and "model capacity" in r.getMessage()
               for r in caplog.records)


def test_kernel_builds_are_counted_and_attributed(tmp_path, monkeypatch):
    """A library already in the build directory is a hit (no nvcc runs);
    a miss is nvcc's; both reach the bound observatory and the metrics."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    assert tcc.enable_persistent_compile_cache(str(tmp_path / "node")) is True
    assert _build.BUILD_DIR == tmp_path / "node"
    assert tcc.enable_persistent_compile_cache("") is False
    assert tcc.enable_persistent_compile_cache(str(tmp_path / "f" / "x")) is True
    (tmp_path / "ro").write_text("a file, not a directory")
    assert tcc.enable_persistent_compile_cache(str(tmp_path / "ro" / "d")) is False
    assert _build.BUILD_DIR == tmp_path / "f" / "x"
    metrics = tapp.ServerMetrics("d", "v1", "ns", device_telemetry=True)
    tel = tdt.DeviceTelemetry(metrics=metrics)
    before = tcc.counters_snapshot()
    try:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _build.library_path("rmsnorm").write_bytes(b"")
        _build.build(("rmsnorm",))  # built already: a hit, nvcc never asked for
        tcc.note_build("sampling", hit=False, seconds=1.5)
        after = tcc.counters_snapshot()
        assert after["hits"] - before["hits"] == 1
        assert after["misses"] - before["misses"] == 1
        assert after["compile_seconds"] - before["compile_seconds"] == 1.5
        obs = tel.observatory.snapshot()
        assert obs["ops"]["rmsnorm"] == {"compiles": 0, "seconds": 0.0, "cache_hits": 1,
                                         "cache_misses": 0}
        assert obs["ops"]["sampling"] == {"compiles": 1, "seconds": 1.5, "cache_hits": 0,
                                          "cache_misses": 1}
        text = metrics.render().decode()
        assert 'tpumlops_compile_seconds_total{deployment_name="d",predictor_name="v1",' \
               'namespace="ns",op="sampling"} 1.5' in text
        assert "tpumlops_compile_cache_hits_total" in text
        assert tcc.cache_entry_count(str(_build.BUILD_DIR)) == 1
    finally:
        tcc.detach_observatory(tel.observatory)
    tcc.note_build("rmsnorm", hit=True)  # detached: the observatory stops counting
    assert tel.observatory.snapshot()["ops"]["rmsnorm"]["cache_hits"] == 1


def test_observatory_warmup_report_and_budget(caplog):
    obs = tdt.CompileObservatory(readiness_budget_s=-1.0)
    obs.on_event("compile", 0.5, op="multistep")
    obs.begin_warmup()
    for _ in range(3):
        obs.on_event("compile", 0.25, op="multistep")
    obs.on_event("cache_hit", op="decode_attention")
    with caplog.at_level("WARNING", logger="tpumlops.device_telemetry"):
        report = obs.end_warmup()
    assert report["compiles"] == 3 and report["seconds"] == 0.75
    assert report["ops"] == {"multistep": 3}
    assert any("readiness budget" in r.getMessage() for r in caplog.records)
    snap = obs.snapshot()
    assert [e["warmup"] for e in snap["events"]] == [False, True, True, True]
    assert snap["ops"]["multistep"]["compiles"] == 4


def test_graph_captures_are_attributed_and_the_watchdog_disarmed_around_them(monkeypatch):
    """Each captured graph is one observatory event of its program; the pool
    is a ledger component; a recapture on a running engine disarms the
    watchdog and arms it again (the CPU captures nothing, so the capture is
    stood in for)."""
    jp = J.init(jax.random.key(0), JCFG, dtype=jnp.float32)
    tp = convert.from_jax_numpy(jax.device_get(jp))
    tel = tdt.DeviceTelemetry()
    wd = twd.EngineWatchdog(deadline_s=30.0, on_exit=lambda: None)
    armed_during = []

    def capture(self, windows, on_graph=None):
        armed_during.append(wd._armed)
        for _ in range(2 * len(windows)):
            on_graph(0.01)

    monkeypatch.setattr(MultistepProgram, "capture", capture)
    engine = TG.GenerationEngine(tp, TCFG, max_slots=2, dtype=torch.float32, device="cpu",
                                 decode_steps=4, telemetry=tel, watchdog=wd)
    try:
        n = 2 * len(TG.decode_window_buckets(TCFG.max_seq))
        engine._capture_graphs()  # as start() does on the card, before arming
        wd.arm()
        engine._thread = threading.current_thread()  # a running scheduler
        engine._capture_graphs()  # as a recovery does
        assert armed_during == [False, False] and wd._armed
        ops = tel.observatory.snapshot()["ops"]
        assert ops["multistep"]["compiles"] == 2 * n
        assert tel.ledger.components["cuda_graph_pool"] == 0  # no pool on the CPU
    finally:
        engine._thread = None
        engine.shutdown()
        tcc.detach_observatory(tel.observatory)


def test_tick_activations_count_the_widest_tick_at_a_world_above_one_rank():
    """Where the K-step and super-step programs run uncaptured (a world
    above one rank) the ledger counts the widest tick's working set, which
    one rank holds in its graph pool: the f32 logits with the tp all-gather's
    parts and concatenation, an activations'-type copy of the largest int8
    block, one layer's f32 planes.  Absent at one rank and without rows."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
        quantization,
    )

    q = quantization.quantize_llama(T.init(torch.Generator().manual_seed(0), TCFG))
    tp2 = {"dp": 1, "tp": 2}
    assert "tick_activations" not in tdt.build_hbm_ledger(q, TCFG, 4, tick_rows=64).components
    assert "tick_activations" not in tdt.build_hbm_ledger(q, TCFG, 4, mesh_shape=tp2).components
    got = tdt.build_hbm_ledger(q, TCFG, 4, dtype_bytes=4, mesh_shape=tp2,
                               tick_rows=64).components["tick_activations"]
    cfg = TCFG
    logits = 4 * 64 * cfg.vocab_size * (1 + 1 + 0.5)
    copy = max(q["lm_head"]["q8"].numel(),
               max(leaf["q8"][0].numel() for leaf in _q8_leaves(q["layers"]))) * 4
    layer = 4 * 64 * 3 * (cfg.intermediate_size // 2 + (cfg.num_heads // 2) * cfg.head_dim
                          + cfg.hidden_size)
    assert got == logits + copy + layer == tdt.tick_activation_bytes(q, cfg, 64, tp2, 4)
    plain = T.init(torch.Generator().manual_seed(0), TCFG)  # no int8 block: no copy
    assert tdt.tick_activation_bytes(plain, cfg, 64, tp2, 4) == logits + layer


def _q8_leaves(tree):
    if isinstance(tree, dict) and "q8" in tree:
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _q8_leaves(v)


@pytest.mark.parametrize("kw,rows", [
    ({}, 64),                                              # a whole prompt's largest bucket
    ({"prefill_chunk": 16}, 16),                           # one chunk
    ({"prefill_chunk": 16, "prefill_batch": 3}, 64),       # a packed bucket of 4 chunks
    ({"prefill_chunk": 8, "unified_step": True, "prefill_batch": 2}, 4 * 8),  # slots x width
    ({"prefill_chunk": 8, "speculative": True}, 4 * 3),    # 4 slots' draft chains over the chunk
])
def test_the_engines_widest_tick(kw, rows):
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
        speculative as tsp,
    )

    if kw.pop("speculative", False):
        kw["speculative"] = tsp.SpeculativeConfig(enabled=True, draft_tokens=2)
    params = T.init(torch.Generator().manual_seed(0), TCFG)
    engine = TG.GenerationEngine(params, TCFG, max_slots=4, dtype=torch.float32, device="cpu",
                                 **kw)
    assert engine.widest_tick_rows == rows


@pytest.mark.parametrize("kw,want", [({"decode_steps": 4}, "multistep, uncaptured (cpu)"),
                                     ({"unified_step": True}, "superstep, uncaptured (cpu)"),
                                     ({}, None)])
def test_debug_device_reports_the_programs_mode(kw, want):
    """``/debug/device`` names what runs the K-step or super-step tick (the
    program's kind, captured or not and why), set at the engine's start;
    None without a program."""
    tp = convert.from_jax_numpy(jax.device_get(J.init(jax.random.key(0), JCFG,
                                                      dtype=jnp.float32)))
    tel = tdt.DeviceTelemetry()
    engine = TG.GenerationEngine(tp, TCFG, max_slots=2, dtype=torch.float32, device="cpu",
                                 telemetry=tel, **kw)
    assert tel.snapshot()["program"] is None
    engine.start(warmup=False)
    try:
        assert tel.snapshot()["program"] == want
        assert tel.ledger.components.get("cuda_graph_pool", 0) == 0
    finally:
        engine.shutdown()
        tcc.detach_observatory(tel.observatory)


# -- the served surface, every option on ------------------------------------------------


@pytest.fixture(scope="module")
def observed():
    cfg = T.LlamaConfig.tiny(max_seq=64)
    params = T.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)
    pred = TR._build_llama(params, cfg, dtype=torch.float32)
    conf = tapp.ServerConfig(model_name="llm", host="127.0.0.1", port=0, dtype="float32",
                             max_slots=2, device="cpu", prefill_chunk=8, trace_ring=256,
                             timeseries_ring=60, device_telemetry=True,
                             watchdog_deadline_s=30.0, watchdog_grace_s=3600.0)
    srv = tapp.build_server(pred, conf)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv
    srv.shutdown_all()
    th.join(timeout=10)


def _request(srv, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    try:
        return resp.status, json.loads(raw), resp
    except ValueError:
        return resp.status, raw.decode(), resp


GEN = "/v2/models/llm/generate"


def test_debug_routes_serve_the_rings_ledger_and_timing(observed):
    code, body, resp = _request(observed, "POST", GEN,
                                {"prompt_ids": [[5, 9, 2], [7, 1, 4, 8]], "max_new_tokens": 3,
                                 "debug": True}, headers={"X-Request-Id": "multi-1"})
    assert code == 200
    timing = body["timing"]
    assert timing["tokens"] == 6 and timing["request_id"] == "multi-1"
    assert [r["request_id"] for r in timing["rows"]] == ["multi-1/0", "multi-1/1"]
    plain = _request(observed, "POST", GEN, {"prompt_ids": [5, 9, 2], "max_new_tokens": 2})[1]
    assert "timing" not in plain
    code, eng, _ = _request(observed, "GET", "/debug/engine")
    assert code == 200 and eng["capacity"] == 256
    kinds = {t["kind"] for t in eng["ticks"]}
    assert {"prefill", "decode"} <= kinds
    assert all(0.0 < t["hbm_bw_util"] <= 1.0 for t in eng["ticks"] if t["kind"] == "decode")
    names = [e["event"] for e in eng["events"] if e["request_id"] == "multi-1/0"]
    assert names[:2] == ["enqueued", "admission"] and names[-1] == "finish"
    assert "first_token" in names and "prefill_chunk" in names
    code, doc, _ = _request(observed, "GET", "/debug/trace?format=chrome")
    assert code == 200 and doc["traceEvents"]
    assert _request(observed, "GET", "/debug/trace?format=json")[1]["capacity"] == 256
    code, bad, _ = _request(observed, "GET", "/debug/trace?format=xml")
    assert code == 400 and bad == {"error": "unknown format 'xml'; use chrome or json"}
    code, dev, _ = _request(observed, "GET", "/debug/device")
    assert code == 200 and dev["peaks"]["source"] == "assumed"
    assert dev["hbm"]["components"]["kv_cache"] == 2 * dev["hbm"]["kv_bytes_per_row"]
    assert {"decode", "prefill"} <= set(dev["utilization"])
    assert dev["compile"]["warmup"]["compiles"] == 0  # the CPU builds and captures nothing
    code, ts, _ = _request(observed, "GET", "/debug/timeseries")
    assert code == 200 and ts["resolution_s"] == 1 and ts["samples"]
    assert "warmup" in ts["samples"][0].get("marks", [])
    code, spans, _ = _request(observed, "GET", "/debug/spans")
    assert code == 200 and isinstance(spans["spans"], dict)
    assert _request(observed, "GET", "/debug/nothing")[0] == 404


def test_debug_profile_captures_into_the_temp_directory(observed):
    code, out, _ = _request(observed, "POST", "/debug/profile", {"duration_s": 0.2})
    assert code == 200 and out["duration_s"] == 0.2
    assert out["trace_dir"].startswith(tapp.profile_root() + os.sep)
    assert (Path(out["trace_dir"]) / "trace.json").stat().st_size > 0
    assert _request(observed, "POST", "/debug/profile", {"duration_s": "nan"})[0] == 400
    observed._profile_lock.acquire()
    try:
        code, busy, _ = _request(observed, "POST", "/debug/profile", {"duration_s": 0.1})
        assert code == 409 and busy == {"error": "a profile capture is already running"}
    finally:
        observed._profile_lock.release()


def test_profile_capture_gc_keeps_the_newest_dirs(tmp_path):
    assert tapp.PROFILE_KEEP_DIRS == 8
    root = tmp_path / "prof"
    root.mkdir()
    for i in range(11):
        d = root / f"cap-{i:02d}"
        d.mkdir()
        os.utime(d, (1000 + i, 1000 + i))
    assert sorted(tapp._gc_profile_dirs(str(root))) == ["cap-00", "cap-01", "cap-02"]
    assert tapp._gc_profile_dirs(str(root)) == []
    assert tapp._gc_profile_dirs(str(tmp_path / "nope")) == []


def test_a_quarantined_prompt_is_a_422(observed):
    engine = observed.engine
    real = engine._device_chunk
    crashes = [0]

    def crashing(ids, fresh):
        if crashes[0] < 2:
            crashes[0] += 1
            raise RuntimeError("injected admission crash")
        return real(ids, fresh)

    engine._device_chunk = crashing
    body = {"prompt_ids": [7, 7, 7, 7], "max_new_tokens": 3}
    try:
        for _ in range(2):
            assert _request(observed, "POST", GEN, body)[0] == 500
        deadline = time.monotonic() + 10
        while engine.poison_quarantined_total < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, payload, resp = _request(observed, "POST", GEN, body,
                                       headers={"X-Request-Id": "p-1"})
    finally:
        engine._device_chunk = real
    assert code == 422 and resp.getheader("Retry-After") is None
    assert payload["reason"] == "poison_quarantined" and payload["crashes"] == 2
    assert len(payload["fingerprint"]) == 16 and payload["request_id"] == "p-1"
    assert _request(observed, "POST", GEN, {"prompt_ids": [5, 9, 2],
                                            "max_new_tokens": 2})[0] == 200
    text = _request(observed, "GET", "/metrics")[1]
    fams = {f.name: f for f in text_string_to_metric_families(text)}
    assert fams["tpumlops_engine_poison_quarantined"].samples[0].value == 1.0
    assert fams["tpumlops_engine_poison_rejected"].samples[0].value == 1.0
    events = _request(observed, "GET", "/debug/engine")[1]["events"]
    assert [e["crashes"] for e in events if e["event"] == "poison-quarantine"] == [2]
    ts = _request(observed, "GET", "/debug/timeseries")[1]["samples"]
    assert sum(s["poison"] for s in ts) == 2  # the quarantine, then the refusal


def test_a_server_with_every_option_registers_the_reference_families(observed):
    text = _request(observed, "GET", "/metrics")[1]
    got = {f.name for f in text_string_to_metric_families(text)}
    want = {f.name for f in text_string_to_metric_families(
        JaxServerMetrics("d", "v1", "ns", device_telemetry=True).exposition().decode())}
    assert want - got == NOT_YET and got - want == set()
    fams = {f.name: f for f in text_string_to_metric_families(text)}
    comps = {s.labels["component"] for s in fams["tpumlops_device_hbm_bytes"].samples}
    assert {"weights_float32", "kv_cache", "sampling_state", "total"} <= comps
    assert {s.labels["kind"] for s in fams["tpumlops_device_mfu"].samples} >= {"decode"}


def test_families_match_the_reference_and_stay_off_when_disabled():
    def families(text):
        out = {}
        for fam in text_string_to_metric_families(text):
            labels = {tuple(sorted(k for k in s.labels if k != "le")) for s in fam.samples
                      if not s.name.endswith("_created")}
            out[fam.name] = (fam.type, labels)
        return out

    ref = JaxServerMetrics("d", "v1", "ns", device_telemetry=True)
    port = tapp.ServerMetrics("d", "v1", "ns", device_telemetry=True)
    for m in (ref, port):
        m.inc_watchdog_stall()
        m.set_watchdog_tick_age(1.5)
        m.inc_poison("quarantined")
        m.inc_poison("rejected")
        m.observe_hbm_component("kv_cache", 1024)
        m.observe_device_util("decode", 0.01, 0.4)
        m.observe_compile("multistep", 0.5)
        m.observe_compile_cache(True)
        m.observe_compile_cache(False)
        m.observe_collective("all_reduce", 0.002)
    want, got = families(ref.exposition().decode()), families(port.render().decode())
    for name in ("tpumlops_engine_collective_seconds",
                 "tpumlops_engine_watchdog_stalls", "tpumlops_engine_watchdog_last_tick_age_seconds",
                 "tpumlops_engine_poison_quarantined", "tpumlops_engine_poison_rejected",
                 "tpumlops_device_hbm_bytes", "tpumlops_device_mfu", "tpumlops_device_hbm_bw_util",
                 "tpumlops_compile_seconds", "tpumlops_compile_cache_hits",
                 "tpumlops_compile_cache_misses"):
        assert got[name] == want[name], name
    off = tapp.ServerMetrics("d", "v1", "ns")
    off.observe_hbm_component("kv_cache", 1)  # no family: a no-op
    off.observe_device_util("decode", 0.1, 0.2)
    text = off.render().decode()
    assert "tpumlops_device_" not in text and "tpumlops_compile_" not in text
    assert "tpumlops_engine_watchdog_stalls_total" in text


@pytest.mark.parametrize("flags,msg", [
    (["--trace-ring", "-1"], "traceRing must be >= 0"),
    (["--timeseries-ring", "86401"], "timeseriesRing must be in [0, 86400]"),
])
def test_bad_observability_flags_are_refused(flags, msg):
    args = tapp.build_arg_parser().parse_args(["--model-uri", "x", *flags])
    with pytest.raises(ValueError, match=msg.replace("[", r"\[").replace("]", r"\]")):
        tapp.config_from_args(args)


def test_observability_flags_parse_and_default_off():
    args = tapp.build_arg_parser().parse_args(["--model-uri", "x"])
    conf = tapp.config_from_args(args)
    assert (conf.trace_ring, conf.timeseries_ring, conf.device_telemetry,
            conf.watchdog_deadline_s, conf.watchdog_grace_s) == (0, 0, False, 0.0, 30.0)
    assert args.compile_cache_dir == ""
    args = tapp.build_arg_parser().parse_args([
        "--model-uri", "x", "--trace-ring", "512", "--timeseries-ring", "120",
        "--device-telemetry", "1", "--watchdog-deadline-s", "2", "--watchdog-grace-s", "5",
        "--compile-cache-dir", "/var/cache/k"])
    conf = tapp.config_from_args(args)
    assert (conf.trace_ring, conf.timeseries_ring, conf.device_telemetry,
            conf.watchdog_deadline_s, conf.watchdog_grace_s) == (512, 120, True, 2.0, 5.0)
    assert args.compile_cache_dir == "/var/cache/k"
