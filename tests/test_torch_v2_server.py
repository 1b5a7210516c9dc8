"""The port's V2 predict path: loader, batcher, engine, metrics and /infer.

A tiny BERT classifier is written by the JAX package's ``save_native_model``
and loaded by the port's loader (float, int8, the int8kv error and the
``hidden_act`` pin).  The port's server then answers ``/v2/models/{name}/
infer`` on the CPU, on port 0, and every response is held to a direct
``classify`` of the same unpadded ids.  The batcher cases follow the JAX
package's ``tests/test_batching.py``; ``/metrics`` is parsed with
``prometheus_client``'s parser (in the test only) and its families are
checked against the JAX package's ``ServerMetrics``.

Tolerances: float logits 1e-5 absolute and relative (f32 on both sides; a
padded request sums over masked keys whose weight is exactly 0, and the
summation order may differ); int8 logits 2e-3 absolute against the JAX
int8 model (activation codes one step apart, see ``test_torch_bert.py``).
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    bert as TB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    quantization as TQ,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    batching as tb,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    engine as teng,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    metrics as tmetrics,
)
from tpumlops.models import bert as JB
from tpumlops.models import quantization as JQ
from tpumlops.server import loader as jloader
from tpumlops.server import metrics as jmetrics

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=0, atol=2e-3)
MAX_POS = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    return JB.BertConfig.tiny(num_labels=3, max_position_embeddings=MAX_POS, **kw)


def _save(path, params, cfg, **config_extra):
    config = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "hidden_act"}
    return jloader.save_native_model(path, "bert-classifier", params,
                                     config={**config, **config_extra},
                                     builder_kwargs={"seq_len": 32})


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = _jcfg()
    params = JB.init(jax.random.key(7), cfg)
    root = tmp_path_factory.mktemp("bert")
    return _save(root / "plain", params, cfg), _save(root / "pinned", params, cfg,
                                                     hidden_act="gelu"), params, cfg


@pytest.fixture(scope="module")
def predictor(artifact):
    return tloader.load_predictor(str(artifact[0]), device="cpu", dtype=None)


def _classify(pred, ids, mask=None, tt=None):
    """Direct classify of the unpadded ids with the predictor's own weights."""
    as_t = (lambda x: None if x is None else torch.as_tensor(np.asarray(x)).long())
    return pred.predict(as_t(ids), as_t(mask), as_t(tt)).numpy()


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


def test_loader_reads_a_jax_bert_artifact(artifact, predictor):
    _, _, params, cfg = artifact
    assert predictor.name == "bert-classifier"
    assert predictor.metadata == {"seq_len": 32, "num_labels": 3, "hidden_act": "gelu"}
    assert predictor.seq_pad["max_len"] == MAX_POS and predictor.seq_pad["min_bucket"] == 16
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jax.jit(JB.classify, static_argnames=("cfg", "dtype"))(
        params, ids, cfg=cfg, dtype=jnp.float32))
    np.testing.assert_allclose(_classify(predictor, ids), want, **TOL)
    assert predictor.example_input(4)["input_ids"].shape == (4, 32)


def test_loader_int8_quantizes_switches_to_tanh_and_keeps_a_pin(artifact):
    plain, pinned, params, cfg = artifact
    pred = tloader.load_predictor(str(plain), quantize="int8", device="cpu", dtype=None)
    assert pred.metadata["hidden_act"] == "gelu_tanh"
    pin = tloader.load_predictor(str(pinned), quantize="int8", device="cpu", dtype=None)
    assert pin.metadata["hidden_act"] == "gelu"
    jq = JQ.quantize_bert(params)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    want = np.asarray(jax.jit(JB.classify, static_argnames=("cfg", "dtype"))(
        jq, ids, cfg=_jcfg(hidden_act="gelu_tanh"), dtype=jnp.float32))
    np.testing.assert_allclose(_classify(pred, ids), want, **INT8_TOL)
    np.testing.assert_allclose(
        _classify(pin, ids),
        np.asarray(jax.jit(JB.classify, static_argnames=("cfg", "dtype"))(
            jq, ids, cfg=_jcfg(hidden_act="gelu"), dtype=jnp.float32)), **INT8_TOL)


def test_loader_int8_weight_codes_match_the_eager_reference(artifact):
    plain, _, params, _ = artifact
    tree = tloader._read_npz(plain / "params.npz", torch.device("cpu"), None)
    q = TQ.quantize_bert(tree)
    for group, name in TQ._BERT_LAYER_MATS:
        want = JQ.quantize_tensor(params["layers"][1][group][name]["w"])
        got = q["layers"][1][group][name]["w"]
        np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


def test_loader_int8kv_is_an_error(artifact):
    with pytest.raises(tloader.ModelLoadError, match="int8kv"):
        tloader.load_predictor(str(artifact[0]), quantize="int8kv", device="cpu")


def test_convert_carries_the_int8_bert_tree(artifact):
    _, _, params, _ = artifact
    jq = JQ.quantize_bert(params)
    tree = convert.from_jax_numpy(jax.device_get(jq))
    leaf = tree["layers"][0]["mlp"]["up"]
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 2
    assert leaf["w"]["q8"].dtype == torch.int8 and leaf["w"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(leaf["w"]["q8"].numpy(),
                                  np.asarray(jq["layers"][0]["mlp"]["up"]["w"]["q8"]))
    assert leaf["b"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Batcher and engine
# ---------------------------------------------------------------------------


def test_seq_pad_buckets_synthesizes_mask_and_rejects():
    spec = {"axis": 1, "pad_values": {"input_ids": 0, "attention_mask": 0},
            "synthesize": {"attention_mask": 1}, "min_bucket": 16, "max_len": 128}
    out = tb.apply_seq_pad({"input_ids": np.arange(1, 58, dtype=np.int32)[None]}, spec)
    assert out["input_ids"].shape == out["attention_mask"].shape == (1, 64)
    assert out["attention_mask"][0].tolist() == [1] * 57 + [0] * 7
    assert out["input_ids"][0, 57:].tolist() == [0] * 7
    a = tb.apply_seq_pad({"input_ids": np.ones((1, 57), np.int32)}, spec)
    b = tb.apply_seq_pad({"input_ids": np.ones((1, 60), np.int32)}, spec)
    assert tb._group_key(a) == tb._group_key(b)
    assert tb.apply_seq_pad({"input_ids": np.ones((1, 3), np.int32)}, spec)["input_ids"].shape == (1, 16)
    with pytest.raises(ValueError, match="exceeds the model maximum"):
        tb.apply_seq_pad({"input_ids": np.ones((1, 200), np.int32)}, spec)
    with pytest.raises(ValueError, match="disagree"):
        tb.apply_seq_pad({"input_ids": np.ones((1, 20), np.int32),
                          "attention_mask": np.ones((1, 19), np.int32)}, spec)
    assert tb.seq_buckets({"min_bucket": 16, "max_len": 100}) == [16, 32, 64, 100]


def test_batcher_groups_by_shape_and_pads_to_buckets():
    seen = []

    def run_batch(inputs):
        seen.append(inputs["x"].shape)
        return inputs["x"].sum(axis=1)

    b = tb.DynamicBatcher(run_batch, max_batch_size=8, max_batch_delay_ms=30)
    b.start()
    try:
        f1 = b.submit({"x": np.ones((4,), np.float32)})
        f2 = b.submit({"x": np.ones((6,), np.float32)})  # other trailing shape
        futs = [b.submit({"x": np.full((4,), i, np.float32)}) for i in range(3)]
        assert f1.result(5) == 4.0 and f2.result(5) == 6.0
        assert [f.result(5) for f in futs] == [0.0, 4.0, 8.0]
    finally:
        b.stop()
    assert all(s[0] in (1, 2, 4, 8) for s in seen)
    assert {s[1] for s in seen} == {4, 6}  # never padded across shapes


def test_batcher_propagates_exceptions_and_survives():
    state = {"fail": True}

    def run_batch(inputs):
        if state["fail"]:
            raise RuntimeError("boom")
        return inputs["x"]

    b = tb.DynamicBatcher(run_batch, max_batch_size=4, max_batch_delay_ms=5)
    b.start()
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.submit({"x": np.ones((2,), np.float32)}).result(timeout=5)
        state["fail"] = False
        np.testing.assert_array_equal(
            b.submit({"x": np.ones((2,), np.float32)}).result(timeout=5), np.ones(2))
    finally:
        b.stop()


def test_pipelined_batcher_overlaps_launch_with_device_wait():
    """With ``materialize`` given, batch N+1 is launched while batch N is
    still waiting on the device (events, not wall-clock timing)."""
    launched = []
    release = threading.Event()
    second = threading.Event()
    threads = set()

    def run_batch(stacked):
        threads.add(threading.current_thread().name)
        launched.append(int(stacked["x"][0, 0]))
        if len(launched) >= 2:
            second.set()
        return int(stacked["x"][0, 0]), stacked["x"].shape[0]

    def materialize(out):
        tag, n = out
        if tag == 0:
            assert release.wait(timeout=5)
        return np.full((n, 1), tag, np.float32)

    b = tb.DynamicBatcher(run_batch, max_batch_size=1, max_batch_delay_ms=1,
                          materialize=materialize, max_inflight=2)
    b.start()
    try:
        f0 = b.submit({"x": np.array([0], np.int64)})
        f1 = b.submit({"x": np.array([1], np.int64)})
        assert second.wait(timeout=5), "no overlap: pipelining broken"
        assert not f0.done()
        release.set()
        assert f0.result(timeout=5)[0] == 0.0 and f1.result(timeout=5)[0] == 1.0
        # A client batch runs alone, as it is, on the same collector thread.
        whole = b.submit_batch({"x": np.array([[2], [3], [4]], np.int64)}).result(timeout=5)
        assert whole.shape == (3, 1) and whole[0, 0] == 2.0
    finally:
        release.set()
        b.stop()
    assert threads == {"batcher-collector"}


def test_pipelined_batcher_materialize_error_fails_only_its_batch():
    def materialize(tag):
        if tag == 0:
            raise RuntimeError("device exploded")
        return np.full((1, 1), tag, np.float32)

    b = tb.DynamicBatcher(lambda s: int(s["x"][0, 0]), max_batch_size=1,
                          max_batch_delay_ms=1, materialize=materialize, max_inflight=2)
    b.start()
    try:
        f0 = b.submit({"x": np.array([0], np.int64)})
        f1 = b.submit({"x": np.array([1], np.int64)})
        with pytest.raises(RuntimeError, match="device exploded"):
            f0.result(timeout=5)
        assert f1.result(timeout=5)[0] == 1.0
    finally:
        b.stop()


def test_pipelined_batcher_stop_fails_inflight_futures():
    hold = threading.Event()

    def materialize(_tag):
        hold.wait(timeout=5)
        return np.zeros((1, 1), np.float32)

    b = tb.DynamicBatcher(lambda s: 0, max_batch_size=1, max_batch_delay_ms=1,
                          materialize=materialize, max_inflight=2)
    b.start()
    futs = [b.submit({"x": np.array([i], np.int64)}) for i in range(4)]
    time.sleep(0.1)
    hold.set()
    b.stop()
    for f in futs:
        assert f.done()
        if f.exception() is not None:
            assert "shutting down" in str(f.exception())


def test_engine_warmup_counts_signatures_and_dispatches(predictor):
    sigs = []
    eng = teng.InferenceEngine(predictor, max_batch_size=4, on_compile=lambda: sigs.append(1))
    assert teng.warmup_buckets(4) == [1, 2, 4] and teng.warmup_buckets(6) == [1, 2, 4, 6]
    eng.warmup()
    # batches 1, 2, 4 at seq_len 32; lengths 16 and 64 at batches 1 and 4
    assert eng.dispatches == len(sigs) == 3 + 2 * 2
    out = eng.predict(predictor.example_input(2))
    assert isinstance(out, np.ndarray) and out.shape == (2, 3)
    assert len(sigs) == 7 and eng.dispatches == 8  # a seen signature adds none


# ---------------------------------------------------------------------------
# The HTTP server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(predictor):
    config = tapp.ServerConfig(model_name="tinybert", host="127.0.0.1", port=0,
                               device="cpu", max_batch_size=4, max_batch_delay_ms=20)
    srv = tapp.build_server(predictor, config)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown_all()
    th.join(timeout=10)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if r.headers.get_content_type() ==
                              "application/json" else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _v2(ids, mask=None, tt=None, dtype="INT32"):
    ins = [{"name": "input_ids", "datatype": dtype, "shape": list(ids.shape),
            "data": ids.reshape(-1).tolist()}]
    for name, x in (("attention_mask", mask), ("token_type_ids", tt)):
        if x is not None:
            ins.append({"name": name, "datatype": "INT32", "shape": list(x.shape),
                        "data": x.reshape(-1).tolist()})
    return {"inputs": ins, "id": "r"}


def _logits(body):
    (out,) = body["outputs"]
    assert out["name"] == "output_0" and out["datatype"] == "FP32"
    return np.asarray(out["data"], np.float32).reshape(out["shape"])


def test_infer_single_batched_and_variable_length(server, predictor):
    _, url = server
    infer = url + "/v2/models/tinybert/infer"
    rng = np.random.default_rng(3)
    # batch 1 through the batcher; a 40-token request is padded to 64
    ids = rng.integers(1, 512, (1, 40)).astype(np.int32)
    code, body = _call(infer, _v2(ids))
    assert code == 200 and body["model_name"] == "tinybert" and body["id"] == "r"
    np.testing.assert_allclose(_logits(body), _classify(predictor, ids), **TOL)
    # a client batch of 3 (padded to bucket 4) with ragged masks, token
    # types.  (A row whose mask is all 0 averages V over every key, padding
    # included, in the reference too, so it is not padding-exact; it is
    # checked unpadded in test_torch_bert.py.)
    ids = rng.integers(1, 512, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[0, 9:] = 0
    mask[2, 1:] = 0
    tt = rng.integers(0, 2, (3, 20)).astype(np.int32)
    code, body = _call(infer, _v2(ids, mask, tt))
    assert code == 200
    np.testing.assert_allclose(_logits(body), _classify(predictor, ids, mask, tt), **TOL)
    # a client batch larger than max_batch_size is chunked
    ids = rng.integers(1, 512, (6, 12)).astype(np.int32)
    code, body = _call(infer, _v2(ids, dtype="INT64"))
    assert code == 200 and _logits(body).shape == (6, 3)
    np.testing.assert_allclose(_logits(body), _classify(predictor, ids), **TOL)
    # concurrent singles of several lengths share batches by bucket
    lens = [5, 17, 33, 40, 64, 9]
    reqs = [rng.integers(1, 512, (1, n)).astype(np.int32) for n in lens]
    with ThreadPoolExecutor(len(reqs)) as pool:
        got = list(pool.map(lambda r: _call(infer, _v2(r)), reqs))
    for r, (code, body) in zip(reqs, got):
        assert code == 200
        np.testing.assert_allclose(_logits(body), _classify(predictor, r), **TOL)


@pytest.mark.parametrize("body,needle", [
    (_v2(np.ones((1, MAX_POS + 1), np.int32)), "exceeds the model maximum"),
    ({"inputs": []}, "no inputs"),
    ({"inputs": [{"name": "input_ids", "datatype": "STR", "shape": [1], "data": [1]}]},
     "unsupported datatype"),
    (_v2(np.ones((1, 20), np.int32), np.ones((1, 19), np.int32)), "disagree"),
    (_v2(np.full((1, 8), 512, np.int32)), "input_ids must lie in"),
    (_v2(np.ones((1, 8), np.int32), tt=np.full((1, 8), 2, np.int32)), "token_type_ids"),
    ({"inputs": [{"name": "input_ids", "datatype": "INT32", "shape": [2, 3],
                  "data": [1, 2, 3]}]}, "reshape"),
    ({"inputs": [{"name": "attention_mask", "datatype": "INT32", "shape": [1, 3],
                  "data": [1, 1, 1]}]}, "input_ids"),
])
def test_infer_bad_input_is_a_400(server, body, needle):
    _, url = server
    code, payload = _call(url + "/v2/models/tinybert/infer", body)
    assert code == 400 and needle in payload["error"]


def test_routes_metadata_and_404s(server):
    _, url = server
    code, meta = _call(url + "/v2/models/tinybert")
    assert code == 200 and meta["flavor"] == "bert-classifier" and meta["metadata"]["seq_len"] == 32
    assert _call(url + "/v2/models/other/infer", _v2(np.ones((1, 4), np.int32)))[0] == 404
    code, payload = _call(url + "/v2/models/tinybert/generate", {"prompt_ids": [1]})
    assert code == 404 and "no route" in payload["error"]
    assert _call(url + "/v2/health/ready") == (200, {"ready": True, "lifecycle": "ready"})


def _families(text):
    return {f.name: f for f in text_string_to_metric_families(text)}


def _server_count(fams, code):
    fam = fams["seldon_api_executor_server_requests_seconds"]
    return sum(s.value for s in fam.samples
               if s.name.endswith("_count") and s.labels["code"] == code)


def test_metrics_count_responses_and_match_the_reference_families(server):
    srv, url = server
    code, before = _call(url + "/metrics")
    assert code == 200
    fams0 = _families(before)
    ok = [_call(url + "/v2/models/tinybert/infer", _v2(np.ones((1, n), np.int32)))[0]
          for n in (3, 30)]
    bad = _call(url + "/v2/models/tinybert/infer", {"inputs": []})[0]
    assert ok == [200, 200] and bad == 400
    fams = _families(_call(url + "/metrics")[1])
    assert _server_count(fams, "200") - _server_count(fams0, "200") == 2
    assert _server_count(fams, "400") - _server_count(fams0, "400") == 1
    client = fams["seldon_api_executor_client_requests_seconds"]
    n_client = [s.value for s in client.samples if s.name.endswith("_count")]
    n_client0 = [s.value for s in fams0["seldon_api_executor_client_requests_seconds"].samples
                 if s.name.endswith("_count")]
    assert n_client[0] - n_client0[0] == 3  # every inference request, any code
    assert srv.metrics.identity == {"deployment_name": "tinybert", "predictor_name": "v1",
                                    "namespace": "default"}

    # Names, types, label names and bucket bounds: the reference's, with
    # the same observations recorded on both sides.
    ref = jmetrics.ServerMetrics("d", "p", "n")
    port = tmetrics.ServerMetrics("d", "p", "n")
    for m in (ref, port):
        m.observe_request(0.003, code=200)
        m.observe_request(0.2, code=500)
        m.observe_batch(4, 0.001, 0.01, 0.0)
    ref.compilations.labels(**ref.identity).inc()
    port.inc_compilations()
    want = _families(generate_latest(ref.registry).decode())
    got = _families(port.render().decode())
    for name, fam in got.items():
        assert name in want, name
        w = want[name]
        assert fam.type == w.type, name

        def shape(samples):
            return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                          for s in samples if not s.name.endswith("_created"))

        want_samples = [s for s in w.samples if not s.name.endswith("_created")]
        if name.endswith("_seconds"):  # the sums are float sums of the same values
            want_samples = [s for s in want_samples if not s.name.endswith("_sum")]
            fam_samples = [s for s in fam.samples if not s.name.endswith("_sum")]
        else:
            fam_samples = fam.samples
        assert shape(fam_samples) == shape(want_samples), name
    # The generation engine's families are registered on every server, as
    # the reference registers them (no samples on a classifier).
    assert set(got) == {
        "seldon_api_executor_client_requests_seconds",
        "seldon_api_executor_server_requests_seconds", "tpumlops_batch_size",
        "tpumlops_queue_seconds", "tpumlops_batch_run_seconds",
        "tpumlops_pipeline_wait_seconds", "tpumlops_compilations",
        "tpumlops_generated_tokens", "tpumlops_decode_batch_size",
        "tpumlops_decode_step_seconds", "tpumlops_engine_active_slots",
        "tpumlops_engine_queue_depth", "tpumlops_engine_admitting",
        "tpumlops_admission_wait_ms", "tpumlops_ttft_seconds", "tpumlops_itl_seconds",
        "tpumlops_request_tokens", "tpumlops_prefill_batch_fill", "tpumlops_tick_seconds",
        "tpumlops_engine_dispatches", "tpumlops_engine_shed", "tpumlops_engine_preempt",
        "tpumlops_model_load_seconds",
        "tpumlops_cold_start_seconds", "tpumlops_model_ready",
        "tpumlops_feedback_reward_total",
        "tpumlops_prefix_cache_hits", "tpumlops_prefix_cache_cached_tokens",
        "tpumlops_prefix_cache_evictions", "tpumlops_prefix_cache_l2_hits",
        "tpumlops_prefix_cache_l2_spills", "tpumlops_prefix_cache_l2_evictions",
        "tpumlops_spec_proposed_tokens", "tpumlops_spec_accepted_tokens",
        "tpumlops_spec_accepted_len", "tpumlops_spec_acceptance_rate",
        "tpumlops_engine_watchdog_stalls", "tpumlops_engine_watchdog_last_tick_age_seconds",
        "tpumlops_engine_poison_quarantined", "tpumlops_engine_poison_rejected"}
