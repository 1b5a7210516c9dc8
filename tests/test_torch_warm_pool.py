"""The port's warm pool (``--warm-pool`` + ``POST /admin/attach``) and its
multiplexed routes, on the CPU (tiny Llama).  Counterpart:
``tests/test_warm_pool.py``.

- The reference's five cases: the typed surface before an attach (``/readyz``
  503 ``warm-pool``, generate and infer 503 ``warm_pool_empty`` with
  ``Retry-After: 5``); an attach that restores the baked snapshot, flips
  readiness and stamps the cold-start ladder; a second attach refused, a
  replace that swaps the weights; a failed attach falling back to the warm
  pool and recovering; the same uri and hash again a no-op (the same engine
  object serving, ``model`` and ``snapshotHash`` on ``/readyz``); a replace
  whose snapshot geometry differs a typed 409 before anything stops; a body
  without ``model_uri`` a 400; the prewarm skipped without a snapshot.
- The port's own: the attached model's tokens equal the same tree served
  directly; the prewarm's zero tree released; an attach of a corrupt
  snapshot loads cold (``restored`` false) and bakes again; the
  ``/v2/models/{any}/generate``, ``/infer`` and ``/ready`` routes, the
  model's admission share given back after each request; a server that is
  no warm pool refuses an attach and an unknown model; the flags; the
  card's capture probe (``scripts/capture_probe.py``) at tiny size.
"""

from __future__ import annotations

import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    snapshot as tsnap,
)
from tpumlops.models import llama as J
from tpumlops.server import loader as jloader

GEN = "/v2/models/llm/generate"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Handle:
    def __init__(self, srv):
        self.srv = srv
        self.port = srv.server_address[1]
        self.thread = threading.Thread(target=srv.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        if self.srv.lifecycle != "shutdown":
            self.srv.shutdown_all()
        self.thread.join(timeout=10)


def _conf(**kw):
    return tapp.ServerConfig(model_name="llm", host="127.0.0.1", port=0, dtype="float32",
                             max_slots=2, device="cpu", **kw)


def _req(h, path, body=None, method=None):
    conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=120)
    data = json.dumps(body) if body is not None else None
    conn.request(method or ("POST" if body is not None else "GET"), path, data,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw or b"{}"), resp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("warmpool")
    cfg = J.LlamaConfig.tiny(max_seq=64)
    dims = {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "intermediate_size": cfg.intermediate_size,
            "max_seq": cfg.max_seq}
    uris = {}
    for tag, seed in (("1", 3), ("2", 4)):
        art = root / f"v{tag}"
        jloader.save_native_model(art, "llama-generate",
                                  J.init(jax.random.key(seed), cfg, dtype=jnp.bfloat16),
                                  config=dims)
        uris[tag] = str(art)
    snap_dir = str(root / "snaps")
    # Bake v1's snapshot once (a cold load writes it): the attach restores.
    tloader.load_predictor(uris["1"], device="cpu", dtype=torch.float32,
                           snapshot_dir=snap_dir)
    h = _Handle(tapp.build_server(None, _conf(snapshot_dir=snap_dir, warm_pool=True,
                                              model_uri=uris["1"])))
    yield h, uris
    h.stop()


def test_warm_pool_lifecycle_attach_and_replace(world):
    h, uris = world
    server = h.srv
    assert server.lifecycle == "warm-pool" and server.engine is None
    code, body, _ = _req(h, "/readyz")
    assert code == 503 and body["lifecycle"] == "warm-pool" and body["model"] is None
    for path, payload in ((GEN, {"prompt_ids": [1, 2, 3], "max_new_tokens": 2}),
                          ("/v2/models/llm/infer", {"inputs": []}),
                          ("/v2/models/other/generate", {"prompt_ids": [1]})):
        code, body, resp = _req(h, path, payload)
        assert code == 503, (path, body)
        assert body["reason"] == "warm_pool_empty" and resp.getheader("Retry-After") == "5"
    code, body, _ = _req(h, "/v2/models/llm")
    assert code == 503 and body["reason"] == "warm_pool_empty"

    code, body, _ = _req(h, "/admin/attach",
                         {"model_uri": uris["1"], "wake_start_wall": time.time() - 0.5})
    assert code == 200, body
    assert body["restored"] is True and body["restore_s"] is not None
    assert body["load_breakdown_s"].get("restore_s") is not None
    assert body["capture_s"] >= 0
    assert _req(h, "/readyz")[0] == 200
    code, body, _ = _req(h, GEN, {"prompt_ids": [1, 2, 3], "max_new_tokens": 3})
    assert code == 200, body
    v1_tokens = body["outputs"][0]["data"]
    expo = server.metrics.render().decode()
    stages = {line.split('stage="')[1].split('"')[0] for line in expo.splitlines()
              if line.startswith("tpumlops_cold_start_seconds{")}
    assert {"wake", "restore", "compile", "total", "first_token"} <= stages
    assert 'stage="restore"' in "".join(line for line in expo.splitlines()
                                        if line.startswith("tpumlops_model_load_seconds{"))

    code, body, _ = _req(h, "/admin/attach", {"model_uri": uris["2"]})
    assert code == 409, body
    code, body, _ = _req(h, "/admin/attach", {"model_uri": uris["2"], "replace": True})
    assert code == 200, body
    assert body["restored"] is False  # v2 was never baked: a cold load that bakes it
    code, body, _ = _req(h, GEN, {"prompt_ids": [1, 2, 3], "max_new_tokens": 3})
    assert code == 200 and body["outputs"][0]["data"] != v1_tokens

    code, body, _ = _req(h, "/admin/attach", {"model_uri": "/nonexistent/model",
                                              "replace": True})
    assert code == 500, body
    assert server.lifecycle == "warm-pool" and server.engine is None
    code, body, _ = _req(h, GEN, {"prompt_ids": [1], "max_new_tokens": 1})
    assert code == 503 and body["reason"] == "warm_pool_empty"
    code, body, _ = _req(h, "/admin/attach", {"model_uri": uris["1"], "replace": True})
    assert code == 200, body
    assert server.lifecycle == "ready"


def test_attach_same_model_and_hash_is_idempotent_noop(world):
    h, uris = world
    server = h.srv
    code, body, _ = _req(h, "/admin/attach", {"model_uri": uris["1"], "replace": True})
    assert code == 200, body
    attached_hash = body["snapshot_hash"]
    assert attached_hash
    engine = server.gen_engine
    for payload in ({"model_uri": uris["1"], "replace": True}, {"model_uri": uris["1"]}):
        code, body, _ = _req(h, "/admin/attach", payload)
        assert code == 200 and body.get("noop") is True, body
        assert body["snapshot_hash"] == attached_hash
    assert server.gen_engine is engine and server.lifecycle == "ready"
    code, body, _ = _req(h, "/readyz")
    assert code == 200 and body["model"] == uris["1"]
    assert body["snapshotHash"] == attached_hash


def test_attach_geometry_incompatible_replace_is_typed_409(world):
    h, uris = world
    server = h.srv
    assert _req(h, "/admin/attach", {"model_uri": uris["1"], "replace": True})[0] == 200
    bogus = "/fat/model"
    spath = tsnap.snapshot_path_for(server.snapshot_dir, bogus)
    spath.mkdir(parents=True, exist_ok=True)
    manifest = tsnap.read_manifest(tsnap.snapshot_path_for(server.snapshot_dir, uris["1"]))
    fat = dict(manifest, config={**manifest["config"], "hidden_size": 4096})
    (spath / tsnap.MANIFEST_NAME).write_text(json.dumps(fat))
    code, body, _ = _req(h, "/admin/attach", {"model_uri": bogus, "replace": True})
    assert code == 409 and body["reason"] == "geometry_incompatible", body
    assert body["attached_model_uri"] == uris["1"]
    assert server.lifecycle == "ready"
    assert _req(h, GEN, {"prompt_ids": [1, 2], "max_new_tokens": 1})[0] == 200


def test_attach_requires_model_uri_and_warm_pool_flag(world, tmp_path):
    h, uris = world
    code, body, _ = _req(h, "/admin/attach", {})
    assert code == 400 and "model_uri" in body["error"]
    code, body, _ = _req(h, "/admin/attach", [1])
    assert code == 400
    plain = _Handle(tapp.build_server(
        tloader.load_predictor(uris["1"], device="cpu", dtype=torch.float32), _conf()))
    try:
        code, body, _ = _req(plain, "/admin/attach", {"model_uri": uris["1"]})
        assert code == 400 and "warm-pool" in body["error"]
        assert "model" not in _req(plain, "/readyz")[1]
        code, _, _ = _req(plain, "/v2/models/other/generate",
                          {"prompt_ids": [1], "max_new_tokens": 1})
        assert code == 404
    finally:
        plain.stop()
    ap = tapp.build_arg_parser()
    with pytest.raises(ValueError, match="--warm-pool requires --snapshot-dir"):
        tapp.config_from_args(ap.parse_args(["--model-uri", "x", "--warm-pool", "1"]))
    conf = tapp.config_from_args(ap.parse_args(["--model-uri", "x", "--warm-pool", "1",
                                                "--snapshot-dir", str(tmp_path)]))
    assert conf.warm_pool and conf.snapshot_dir == str(tmp_path) and conf.model_uri == "x"
    with pytest.raises(ValueError, match="no predictor"):
        tapp.build_server(object(), conf)


def test_prewarm_from_snapshot_runs_on_its_geometry_and_holds_no_weights(world, tmp_path,
                                                                         monkeypatch):
    h, uris = world
    assert tapp.prewarm_from_snapshot(_conf(snapshot_dir=str(tmp_path / "none"),
                                            model_uri=uris["1"])) is None
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
        llama as T,
    )

    seen = {}
    real = T.generate_greedy

    def spy(params, prompt, n, cfg, dtype):
        seen["shapes"] = {k: (str(v.dtype), list(v.shape))
                          for k, v in tloader._flatten(params).items()}
        seen["abs_sum"] = sum(float(v.abs().sum()) for v in tloader._flatten(params).values())
        return real(params, prompt, n, cfg, dtype)

    monkeypatch.setattr(T, "generate_greedy", spy)
    wall = tapp.prewarm_from_snapshot(_conf(snapshot_dir=h.srv.snapshot_dir,
                                            model_uri=uris["1"]))
    assert wall is not None and wall >= 0
    # One forward on a zero tree of exactly the snapshot's leaves.
    manifest = tsnap.read_manifest(tsnap.snapshot_path_for(h.srv.snapshot_dir, uris["1"]))
    assert seen["shapes"] == {leaf["key"]: ("torch." + leaf["dtype"], leaf["shape"])
                              for leaf in manifest["leaves"]}
    assert seen["abs_sum"] == 0.0


def test_attached_tokens_equal_the_same_tree_served_directly(world):
    h, uris = world
    assert _req(h, "/admin/attach", {"model_uri": uris["1"], "replace": True})[0] == 200
    prompt = {"prompt_ids": list(range(3, 20)), "max_new_tokens": 6}
    code, body, _ = _req(h, GEN, prompt)
    assert code == 200
    direct = _Handle(tapp.build_server(
        tloader.load_predictor(uris["1"], device="cpu", dtype=torch.float32), _conf()))
    try:
        code, want, _ = _req(direct, GEN, prompt)
    finally:
        direct.stop()
    assert code == 200 and body["outputs"] == want["outputs"]


def test_an_attach_of_a_corrupt_snapshot_loads_cold_and_bakes_again(world):
    h, uris = world
    assert _req(h, "/admin/attach", {"model_uri": uris["1"], "replace": True})[0] == 200
    code, want, _ = _req(h, GEN, {"prompt_ids": [4, 5, 6], "max_new_tokens": 4})
    spath = tsnap.snapshot_path_for(h.srv.snapshot_dir, uris["2"])
    if not (spath / tsnap.MANIFEST_NAME).exists():
        assert _req(h, "/admin/attach", {"model_uri": uris["2"], "replace": True})[0] == 200
    chunk = sorted(spath.glob("chunk-*.bin"))[0]
    raw = bytearray(chunk.read_bytes())
    raw[len(raw) // 3] ^= 0xFF
    chunk.write_bytes(bytes(raw))
    code, body, _ = _req(h, "/admin/attach", {"model_uri": uris["2"], "replace": True})
    assert code == 200 and body["restored"] is False, body
    assert list(spath.parent.glob(f"{spath.name}.corrupt-*"))
    assert (spath / tsnap.MANIFEST_NAME).exists()  # baked again
    code, body, _ = _req(h, "/admin/attach", {"model_uri": uris["1"], "replace": True})
    assert code == 200 and body["restored"] is True
    code, again, _ = _req(h, GEN, {"prompt_ids": [4, 5, 6], "max_new_tokens": 4})
    assert again["outputs"] == want["outputs"]


def test_multiplexed_routes_hold_and_return_the_model_share(world):
    h, uris = world
    assert _req(h, "/admin/attach", {"model_uri": uris["1"], "replace": True})[0] == 200
    engine = h.srv.gen_engine
    seen = []
    real = engine.reserve_admission

    def spy(est, slo_class=None, model=None):
        seen.append((est, model))
        return real(est, slo_class=slo_class, model=model)

    engine.reserve_admission = spy
    code, mux, _ = _req(h, "/v2/models/cr-7/generate",
                        {"prompt_ids": [1, 2, 3], "max_new_tokens": 3})
    assert code == 200, mux
    code, own, _ = _req(h, GEN, {"prompt_ids": [1, 2, 3], "max_new_tokens": 3})
    assert code == 200 and own["outputs"] == mux["outputs"]
    assert seen == [(6, "cr-7"), (6, None)]
    assert engine._model_est.get("cr-7", 0) == 0  # given back
    code, body, _ = _req(h, "/v2/models/cr-7/ready")
    assert code == 200 and body["model"] == uris["1"]
    code, _, _ = _req(h, "/v2/models/cr-7/infer", {"inputs": []})
    assert code == 404  # the attached model generates


def test_capture_probe_script_runs_on_the_cpu(tmp_path):
    """The card's capture probe, tiny on the CPU: every engine starts on
    its thread over both trees, and the attach restores (nothing is
    captured on the CPU); its snapshot is gone afterwards."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.scripts import (
        capture_probe,
    )

    sdir = tmp_path / "probe-snaps"
    summary = capture_probe.main(["--device", "cpu", "--tiny", "--rounds", "1",
                                  "--snapshot-dir", str(sdir)])
    runs = summary["runs"]
    assert [(r["tree"], r["where"]) for r in runs[:4]] == [
        ("quantized", "main"), ("restored", "main"), ("restored", "thread"),
        ("quantized", "thread")]
    assert all(r["capture_s"] == 0.0 and r["start_s"] >= 0 for r in runs[:4])
    assert summary["attach"]["where"] == "attach" and summary["attach"]["restore_s"] >= 0
    assert summary["device"] == "cpu" and not sdir.exists()
