"""The port's loader and HTTP server.

A tiny Llama is written by the JAX package's ``save_native_model`` with
bfloat16 leaves (stored as raw ``|V2``), loaded by both packages' loaders,
and must generate the same greedy tokens (the port in f64 on the CPU).
The standard-library HTTP server is then driven on port 0 in both request
forms and as a token stream, with its health routes and its 400s.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models.quantization import (
    quantize_llama as t_quantize_llama,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from tpumlops.models import llama as J
from tpumlops.models import quantization as JQ
from tpumlops.models.quantization import quantize_llama as j_quantize_llama
from tpumlops.server import loader as jloader

PROMPTS = [([5, 9, 2], 6), ([7, 1, 4, 8, 3], 5)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads; one thread keeps
    this module from crowding tests that run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, x64):
    import dataclasses

    cfg = J.LlamaConfig.tiny(max_seq=64)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          J.init(jax.random.key(11), cfg, dtype=jnp.float32))
    path = jloader.save_native_model(tmp_path_factory.mktemp("art") / "tiny",
                                     "llama-generate", params,
                                     config=dataclasses.asdict(cfg))
    assert np.load(path / "params.npz")["embed"].dtype == np.dtype("V2")
    return path, cfg


@pytest.fixture(scope="module")
def refs(artifact):
    path, cfg = artifact
    pred = jloader.load_predictor(str(path))
    params = pred.causal_lm["params"]
    gen = jax.jit(J.generate_greedy, static_argnums=(2, 3), static_argnames=("dtype",))
    return [
        np.asarray(gen(params, jnp.asarray([p], jnp.int32), n, cfg,
                       dtype=jnp.float64))[0].tolist()
        for p, n in PROMPTS
    ], params


def test_loader_round_trip_from_a_jax_artifact(artifact, refs):
    path, cfg = artifact
    expected, jparams = refs
    pred = tloader.load_predictor(f"file://{path}", device="cpu", dtype=None)
    assert pred.name == "llama-generate"
    params = pred.causal_lm["params"]
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["layers"]["q"].float().numpy(),
                                  np.asarray(jparams["layers"]["q"], np.float32))
    tcfg = pred.causal_lm["cfg"]
    assert (tcfg.hidden_size, tcfg.num_kv_heads, tcfg.max_seq) == (
        cfg.hidden_size, cfg.num_kv_heads, cfg.max_seq)
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
        llama as T,
    )

    for (p, n), ref in zip(PROMPTS, expected):
        out = T.generate_greedy(params, torch.tensor([p]), n, tcfg, dtype=torch.float64)
        assert out[0].tolist() == ref
    # int8: the loader's codes are the reference quantize_tensor's, bit for
    # bit.  The reference's quantize_llama runs under jit, where XLA turns
    # "/ 127" into "* (1/127)": a scale one ulp off moves a code that sits
    # on an exact .5 tie (common for bf16 weights) by one step.
    q = tloader.load_predictor(str(path), quantize="int8kv", device="cpu", dtype=None)
    got = q.causal_lm["params"]["layers"]["down"]["q8"].numpy()
    eager = JQ.quantize_tensor(jparams["layers"]["down"])
    np.testing.assert_array_equal(got, np.asarray(eager["q8"]))
    jitted = j_quantize_llama(jparams)["layers"]["down"]["q8"]
    assert np.abs(got.astype(int) - np.asarray(jitted).astype(int)).max() <= 1


def test_port_artifact_round_trip(tmp_path, artifact):
    path, _ = artifact
    pred = tloader.load_predictor(str(path), device="cpu", dtype=None)
    params = t_quantize_llama(pred.causal_lm["params"])
    out = tloader.save_native_model(tmp_path / "again", "llama-generate", params,
                                    config=vars(pred.causal_lm["cfg"]))
    back = tloader.load_predictor(str(out), device="cpu", dtype=None)
    for name in ("embed", "final_norm"):
        torch.testing.assert_close(back.causal_lm["params"][name], params[name],
                                   rtol=0, atol=0)
    q, q2 = params["layers"]["gate"], back.causal_lm["params"]["layers"]["gate"]
    assert torch.equal(q["q8"], q2["q8"]) and torch.equal(q["scale"], q2["scale"])


def test_loader_rejects_what_is_not_ported(tmp_path, artifact, monkeypatch):
    path, _ = artifact
    with pytest.raises(tloader.ModelLoadError, match="does not exist"):
        tloader.resolve_uri(str(tmp_path / "missing"))
    monkeypatch.delenv(tloader.MIRROR_ENV, raising=False)
    with pytest.raises(tloader.ModelLoadError, match=tloader.MIRROR_ENV):
        tloader.resolve_uri("s3://bucket/model")
    with pytest.raises(tloader.ModelLoadError, match="quantize"):
        tloader.load_predictor(str(path), quantize="int4", device="cpu")
    with pytest.raises(tloader.ModelLoadError, match="no params.npz layout"):
        tloader.load_predictor(str(path), flavor="sklearn-linear", device="cpu")


@pytest.fixture(scope="module")
def server(artifact):
    path, _ = artifact
    pred = tloader.load_predictor(str(path), quantize="none", device="cpu", dtype=None)
    config = tapp.ServerConfig(model_name="tiny", host="127.0.0.1", port=0,
                               dtype="float64", max_slots=2, prefill_chunk=8,
                               device="cpu")
    srv = tapp.build_server(pred, config)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown_all()
    th.join(timeout=10)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_generate_simple_and_v2_forms(server, refs):
    expected, _ = refs
    url = server + "/v2/models/tiny/generate"
    code, body = _call(url, {"prompt_ids": PROMPTS[0][0], "max_new_tokens": PROMPTS[0][1],
                             "id": "r1"})
    assert code == 200 and body["model_name"] == "tiny" and body["id"] == "r1"
    assert body["outputs"] == [{"name": "output_ids_0", "datatype": "INT32",
                                "shape": [6], "data": expected[0]}]
    code, body = _call(url, {"prompt_ids": [p for p, _ in PROMPTS], "max_new_tokens": 5})
    assert code == 200 and [o["data"] for o in body["outputs"]] == [e[:5] for e in expected]
    rows = np.zeros((2, 5), np.int32)
    rows[0, :3], rows[1, :5] = PROMPTS[0][0], PROMPTS[1][0]
    code, body = _call(url, {
        "inputs": [
            {"name": "prompt_ids", "datatype": "INT32", "shape": [2, 5],
             "data": rows.reshape(-1).tolist()},
            {"name": "lengths", "datatype": "INT32", "shape": [2], "data": [3, 5]},
        ],
        "parameters": {"max_new_tokens": 5},
    })
    assert code == 200
    assert [o["data"] for o in body["outputs"]] == [e[:5] for e in expected]
    assert [o["shape"] for o in body["outputs"]] == [[5], [5]]


def test_seeded_rows_are_reproducible_and_distinct(server):
    url = server + "/v2/models/tiny/generate"
    req = {"prompt_ids": [[5, 9, 2], [5, 9, 2]], "max_new_tokens": 10,
           "temperature": 1.0, "top_k": 50, "seed": 3}
    _, a = _call(url, req)
    _, b = _call(url, req)
    assert a["outputs"] == b["outputs"]
    assert a["outputs"][0]["data"] != a["outputs"][1]["data"]  # seed + i per row


def test_stream_sends_the_reference_tokens_as_events(server, refs):
    """``"stream": true`` answers Server-Sent Events over a chunked body,
    one event a token of the JAX package's greedy output, then the final
    event with the whole sequence."""
    expected, _ = refs
    prompt, n = PROMPTS[1]
    req = urllib.request.Request(
        server + "/v2/models/tiny/generate",
        data=json.dumps({"prompt_ids": prompt, "max_new_tokens": n, "stream": True}).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": "s-1"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200 and r.headers["Transfer-Encoding"] == "chunked"
        assert r.headers["X-Request-Id"] == "s-1"
        events = [json.loads(line[len(b"data: "):]) for line in r
                  if line.startswith(b"data: ")]
    assert events[:-1] == [{"index": i, "token": t} for i, t in enumerate(expected[1])]
    assert events[-1] == {"done": True, "output_ids": expected[1]}


def test_health_routes(server):
    assert _call(server + "/v2/health/live") == (200, {"live": True, "lifecycle": "ready"})
    assert _call(server + "/v2/health/ready") == (200, {"ready": True, "lifecycle": "ready"})


def test_generate_debug_returns_the_timing_block(server, refs):
    """``"debug": true`` (refused before it was ported) answers the tokens
    and the request's timing block: one row, its prefill chunk, its tokens
    and finish reason, and the queue and first-token times."""
    expected, _ = refs
    prompt, n = PROMPTS[0]
    code, body = _call(server + "/v2/models/tiny/generate",
                       {"prompt_ids": prompt, "max_new_tokens": n, "debug": True})
    assert code == 200 and body["outputs"][0]["data"] == expected[0]
    timing = body["timing"]
    assert timing["tokens"] == n and timing["prefill_chunks"] == 1
    assert timing["finish_reasons"] == ["length"] and len(timing["rows"]) == 1
    row = timing["rows"][0]
    assert row["prompt_tokens"] == len(prompt) and row["tokens"] == n
    assert 0 <= row["queue_ms"] <= row["ttft_ms"] <= row["total_ms"]
    assert timing["request_id"] == row["request_id"] != ""


@pytest.mark.parametrize("path,body,code,needle", [
    ("/v2/models/tiny/generate", {"prompt_ids": [1, 2], "max_new_token": 3}, 400, "unknown key"),
    ("/v2/models/tiny/generate", {"inputs": [{"name": "prompt_ids", "shape": [1, 2],
                                              "data": [1, 2]}],
                                  "parameters": {"temperatur": 1.0}}, 400, "unknown key"),
    ("/v2/models/tiny/generate", {"prompt_ids": []}, 400, "empty"),
    ("/v2/models/tiny/generate", {"prompt_ids": [1, 2], "max_new_tokens": 100}, 400, "capacity"),
    ("/v2/models/tiny/generate", {"inputs": [{"name": "x", "shape": [1], "data": [1]}]},
     400, "prompt_ids"),
    ("/v2/models/other/generate", {"prompt_ids": [1, 2]}, 404, "unknown model"),
    ("/v2/models/tiny/infer", {"prompt_ids": [1, 2]}, 404, "no route"),
])
def test_generate_errors(server, path, body, code, needle):
    got, payload = _call(server + path, body)
    assert got == code
    assert needle in payload["error"]
