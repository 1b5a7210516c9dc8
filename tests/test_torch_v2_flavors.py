"""The rest of the port's V2 predict path on the CPU: the sklearn,
forest, xgboost, pyfunc and ResNet flavors through the port's loader, the
Seldon route ``/api/v1.0/predictions``, the feedback route
``/api/v1.0/feedback`` and object-store URIs through the artifact mirror,
each against the JAX package.

An iris replica (sklearn's bundled iris, a ``LogisticRegression`` written
by the port's ``save_sklearn_model``) is served by the port's
``build_server`` on port 0 and answers as the JAX package's
``tests/test_server.py`` expects of its own (V2 infer single and batched,
concurrent singles, the Seldon route with ``data.ndarray`` and
``data.tensor``, feedback counted under ``service="feedback"`` without
touching the latency histogram, metadata, a 400).  Class ids are equal to
sklearn's and to the JAX loader's predictor.  The loader cases follow the
JAX package's loader tests; forest outputs agree with sklearn within
1e-4 relative + 1e-3 absolute (the reference's bar) and with the JAX
loader's predictor within 1e-5; ResNet logits with the JAX loader's
within 1e-4 relative + 1e-4 of the largest logit (f32 both sides).
"""

import json
import re
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models_tabular import _ref_eval_one, _two_tree_model

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as treg,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    resnet as TR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    snapshot as tsnap,
)
from tpumlops.models import registry as jreg
from tpumlops.models import resnet as JR
from tpumlops.server import loader as jloader


class Doubler:
    """A host model with ``predict`` and nothing a device flavor reads."""

    def predict(self, x):
        return np.asarray(x) * 2.0


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read()
            ctype = r.headers.get_content_type()
            return r.status, (json.loads(raw) if ctype == "application/json" else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _v2(x, dtype="FP32"):
    x = np.asarray(x)
    return {"inputs": [{"name": "x", "shape": list(x.shape), "datatype": dtype,
                        "data": x.ravel().tolist()}]}


@pytest.fixture(scope="module")
def iris(tmp_path_factory):
    from sklearn.datasets import load_iris
    from sklearn.linear_model import LogisticRegression

    X, y = load_iris(return_X_y=True)
    sk = LogisticRegression(max_iter=500).fit(X, y)
    art = tloader.save_sklearn_model(tmp_path_factory.mktemp("artifacts") / "iris", sk,
                                     "sklearn-linear")
    return sk, X, art


@pytest.fixture(scope="module")
def iris_server(iris):
    sk, X, art = iris
    pred = tloader.load_predictor(str(art), device="cpu")
    config = tapp.ServerConfig(model_name="iris", host="127.0.0.1", port=0, device="cpu",
                               predictor_name="v1", deployment_name="iris",
                               namespace="models", max_batch_size=8, max_batch_delay_ms=2)
    srv = tapp.build_server(pred, config)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}", sk, X
    srv.shutdown_all()
    th.join(timeout=10)
    assert not th.is_alive()


def test_iris_artifact_loads_like_the_jax_loader(iris):
    sk, X, art = iris
    pred = tloader.load_predictor(str(art), device="cpu")
    jpred = jloader.load_predictor(str(art))
    assert pred.name == jpred.name == "sklearn-linear"
    assert pred.metadata == jpred.metadata
    x32 = X.astype(np.float32)
    got = pred.predict(x32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpred.predict(jnp.asarray(x32))))
    np.testing.assert_array_equal(got.numpy(), sk.predict(X))


def test_v2_single_and_batched_infer_match_sklearn(iris_server):
    _, url, sk, X = iris_server
    code, body = _call(url + "/v2/models/iris/infer", _v2(X[7:8]))
    assert code == 200, body
    out = body["outputs"][0]
    assert out["shape"] == [1] and out["datatype"] == "INT32"
    assert out["data"][0] == int(sk.predict(X[7:8])[0])
    code, body = _call(url + "/v2/models/iris/infer", _v2(X[:12]))
    assert code == 200
    np.testing.assert_array_equal(body["outputs"][0]["data"], sk.predict(X[:12]))


def test_concurrent_singles_are_batched(iris_server):
    srv, url, sk, X = iris_server
    with ThreadPoolExecutor(16) as pool:
        resps = list(pool.map(lambda i: _call(url + "/v2/models/iris/infer", _v2(X[i:i + 1])),
                              range(16)))
    assert all(code == 200 for code, _ in resps)
    np.testing.assert_array_equal([b["outputs"][0]["data"][0] for _, b in resps],
                                  sk.predict(X[:16]))
    assert "tpumlops_batch_size_bucket" in _call(url + "/metrics")[1]


def test_seldon_protocol_ndarray_and_tensor(iris_server):
    _, url, sk, X = iris_server
    code, body = _call(url + "/api/v1.0/predictions",
                       {"data": {"ndarray": [[float(v) for v in X[3]]]}})
    assert code == 200 and body["meta"] == {}
    assert body["data"]["ndarray"][0] == int(sk.predict(X[3][None])[0])
    code, body = _call(url + "/api/v1.0/predictions",
                       {"data": {"tensor": {"shape": [5, 4], "values": X[:5].ravel().tolist()}}})
    assert code == 200
    np.testing.assert_array_equal(body["data"]["ndarray"], sk.predict(X[:5]))
    for bad in ({"data": {}}, {"data": {"ndarray": [[1.0, 2.0]]}}, {"data": {"ndarray": 3.0}},
                {"data": {"tensor": {"shape": [2, 4], "values": [1.0]}}}, [1, 2]):
        code, body = _call(url + "/api/v1.0/predictions", bad)
        assert code == 400, (bad, body)


def _client_count(text) -> float:
    m = re.search(r"seldon_api_executor_client_requests_seconds_count{[^}]*} ([0-9.e+-]+)", text)
    return float(m.group(1)) if m else 0.0


def _service_count(text, service) -> float:
    return sum(float(m.group(2)) for m in re.finditer(
        r"seldon_api_executor_server_requests_seconds_count{([^}]*)} ([0-9.e+-]+)", text)
        if f'service="{service}"' in m.group(1))


def _reward(text) -> float:
    m = re.search(r"tpumlops_feedback_reward_total{[^}]*} ([0-9.e+-]+)", text)
    return float(m.group(1)) if m else 0.0


def test_feedback_counts_under_the_feedback_service(iris_server):
    _, url, _, _ = iris_server
    text0 = _call(url + "/metrics")[1]
    lat0, fb0, pred0 = _client_count(text0), _service_count(text0, "feedback"), \
        _service_count(text0, "predictions")
    for reward in (1, -0.5, 2.0):
        code, body = _call(url + "/api/v1.0/feedback",
                           {"reward": reward, "response": {"data": {"ndarray": [[0]]}}})
        assert (code, body) == (200, {"meta": {}})
    text = _call(url + "/metrics")[1]
    assert _service_count(text, "feedback") == fb0 + 3
    assert _client_count(text) == lat0  # the latency gate's series untouched
    assert _service_count(text, "predictions") == pred0
    assert _reward(text) - _reward(text0) == pytest.approx(2.5)
    assert "# TYPE tpumlops_feedback_reward_total gauge" in text
    for bad in ({"reward": "five stars"}, [1.0]):
        assert _call(url + "/api/v1.0/feedback", bad)[0] == 400
    text = _call(url + "/metrics")[1]
    assert _service_count(text, "feedback") == fb0 + 5  # the 400s count too
    assert 'code="400",service="feedback"' in text.replace(", ", ",")


def test_gate_identity_metadata_and_a_bad_request(iris_server):
    _, url, _, _ = iris_server
    text = _call(url + "/metrics")[1]
    for needle in ('deployment_name="iris"', 'predictor_name="v1"', 'namespace="models"',
                   "seldon_api_executor_server_requests_seconds_count{"):
        assert needle in text
    code, meta = _call(url + "/v2/models/iris")
    assert code == 200 and meta["flavor"] == "sklearn-linear" and meta["jittable"] is True
    code, _ = _call(url + "/v2/models/iris/infer", _v2([[1, 2, 3, 4]], dtype="NOPE"))
    assert code == 400
    code, body = _call(url + "/v2/models/iris/infer", _v2([[1.0, 2.0, 3.0]]))
    assert code == 400 and "[B, 4]" in body["error"]
    assert 'code="400"' in _call(url + "/metrics")[1]


def test_seldon_on_a_warm_pool_replica_and_a_generate_server(tmp_path):
    config = tapp.ServerConfig(model_name="pool", host="127.0.0.1", port=0, device="cpu",
                               warm_pool=True, snapshot_dir=str(tmp_path))
    srv = tapp.build_server(None, config)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        code, body = _call(url + "/api/v1.0/predictions", {"data": {"ndarray": [[1.0]]}})
        assert code == 503 and body["reason"] == "warm_pool_empty"
        # Feedback runs nothing on a model: answered, as the reference does.
        assert _call(url + "/api/v1.0/feedback", {"reward": 1})[0] == 200
    finally:
        srv.shutdown_all()
        th.join(timeout=10)
    assert not th.is_alive()


def test_mirror_resolves_and_fails_loudly_without_one(tmp_path, monkeypatch, iris):
    (tmp_path / "mlflow" / "1" / "m").mkdir(parents=True)
    monkeypatch.setenv(tloader.MIRROR_ENV, str(tmp_path))
    assert tloader.resolve_uri("s3://mlflow/1/m") == tmp_path / "mlflow" / "1" / "m"
    assert tloader.resolve_uri("gs://mlflow/1/m") == jloader.resolve_uri("gs://mlflow/1/m")
    # An s3:// URI loads through the mirror.
    sk, X, art = iris
    monkeypatch.setenv(tloader.MIRROR_ENV, str(art.parent.parent))
    uri = f"s3://{art.parent.name}/{art.name}"
    pred = tloader.load_predictor(uri, device="cpu")
    np.testing.assert_array_equal(pred.predict(X.astype(np.float32)).numpy(), sk.predict(X))
    monkeypatch.delenv(tloader.MIRROR_ENV)
    with pytest.raises(tloader.ModelLoadError, match="TPUMLOPS_ARTIFACT_MIRROR"):
        tloader.resolve_uri("s3://mlflow/1/m")
    assert tloader.MIRROR_ENV == jloader.MIRROR_ENV


def test_loader_sniffs_forest_and_pyfunc_flavors(tmp_path):
    from sklearn.datasets import make_regression
    from sklearn.ensemble import RandomForestRegressor

    X, y = make_regression(n_samples=50, n_features=4, random_state=0)
    sk = RandomForestRegressor(n_estimators=5, max_depth=4, random_state=0).fit(X, y)
    art = tloader.save_sklearn_model(tmp_path / "forest", sk, "sklearn-forest")
    (art / "config.json").unlink()  # no flavor hint: sniffed from the object
    pred = tloader.load_predictor(str(art), device="cpu")
    jpred = jloader.load_predictor(str(art))
    assert pred.name == jpred.name == "sklearn-forest"
    assert pred.metadata == jpred.metadata
    x32 = np.asarray(X[:8], np.float32)
    out = pred.predict(x32).numpy()
    np.testing.assert_allclose(out, sk.predict(X[:8]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out, np.asarray(jpred.predict(jnp.asarray(x32))), rtol=1e-5,
                               atol=1e-5)
    host = tloader.save_sklearn_model(tmp_path / "host", Doubler(), "pyfunc")
    (host / "config.json").unlink()
    pyf = tloader.load_predictor(str(host), device="cpu")
    assert pyf.name == "pyfunc" and pyf.jittable is False
    np.testing.assert_allclose(pyf.predict(np.ones((2, 3))), np.full((2, 3), 2.0))
    assert tloader._sniff_sklearn_flavor(sk) == jloader._sniff_sklearn_flavor(sk)
    with pytest.raises(tloader.ModelLoadError, match="cannot serve"):
        tloader._sniff_sklearn_flavor(object())


@pytest.fixture(scope="module")
def resnet_art(tmp_path_factory):
    """A tiny ResNet written by the JAX package's ``save_native_model``."""
    cfg = JR.ResNetConfig.tiny()
    params = JR.init(jax.random.key(0), cfg)
    return jloader.save_native_model(
        tmp_path_factory.mktemp("artifacts") / "resnet", "resnet-classifier", params,
        config={"stage_sizes": list(cfg.stage_sizes), "num_classes": cfg.num_classes,
                "width": cfg.width},
        builder_kwargs={"image_size": 32})


@pytest.mark.parametrize("kind", ["sklearn", "xgboost", "resnet"])
@pytest.mark.parametrize("quantize", ["int8", "int8kv"])
def test_quantize_is_refused(tmp_path, iris, resnet_art, kind, quantize):
    if kind == "sklearn":
        art = iris[2]
    elif kind == "xgboost":
        art = tloader.save_xgboost_model(tmp_path / "xgb", _two_tree_model()[0])
    else:
        art = resnet_art
    with pytest.raises(jloader.ModelLoadError, match="quantize"):
        jloader.load_predictor(str(art), quantize=quantize)
    with pytest.raises(tloader.ModelLoadError, match="quantize"):
        tloader.load_predictor(str(art), quantize=quantize, device="cpu")


def test_binary_xgboost_is_refused_with_guidance(tmp_path):
    art = tmp_path / "xgb-ubj"
    art.mkdir()
    (art / "model.ubj").write_bytes(b"\x7fUBJ\x01binarystuff")
    (art / "MLmodel").write_text("flavors:\n  xgboost:\n    data: model.ubj\n")
    with pytest.raises(tloader.ModelLoadError, match="re-save it as JSON"):
        tloader.load_predictor(str(art), device="cpu")
    assert tloader._find_xgboost_file(art) == jloader._find_xgboost_file(art)


def test_xgboost_artifact_loads_end_to_end(tmp_path):
    model, trees_json = _two_tree_model()
    art = tloader.save_xgboost_model(tmp_path / "xgb", model)
    assert (art / "MLmodel").read_text() == (
        jloader.save_xgboost_model(tmp_path / "jxgb", model) / "MLmodel").read_text()
    pred = tloader.load_predictor(str(art), device="cpu")
    jpred = jloader.load_predictor(str(art))
    assert pred.name == "xgboost" and pred.metadata == jpred.metadata
    assert pred.metadata["eval_form"] == "gemm"
    assert pred.example_input(2).shape == (2, 3)
    X = np.array([[0.0, 1.0, 0.0], [1.5, 0.25, -0.5]], np.float32)
    want = [sum(_ref_eval_one(t, row) for t in trees_json) + 0.5 for row in X]
    np.testing.assert_allclose(pred.predict(X).numpy(), want)
    np.testing.assert_allclose(pred.predict(X).numpy(), np.asarray(jpred.predict(jnp.asarray(X))))


def test_native_resnet_artifact_loads_at_its_stored_dtype_and_through_a_snapshot(tmp_path,
                                                                                resnet_art):
    art = resnet_art
    stats: dict = {}
    # The default serving type (bf16) must not reach the ResNet leaves.
    pred = tloader.load_predictor(str(art), device="cpu", load_stats=stats)
    jpred = jloader.load_predictor(str(art))
    assert pred.name == "resnet-classifier" and pred.metadata == jpred.metadata
    imgs = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = pred.predict(imgs)
    want = np.asarray(jpred.predict(jnp.asarray(imgs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    f32 = tloader.load_predictor(str(art), device="cpu", dtype=torch.float32)
    torch.testing.assert_close(got, f32.predict(imgs), rtol=0, atol=0)

    # A snapshot of the stored tree restores at its stored dtype.
    snap = tmp_path / "snaps"
    with np.load(art / "params.npz") as npz:
        flat = {k: torch.from_numpy(npz[k]) for k in npz.files}
    tsnap.write_snapshot(snap, tloader._unflatten(flat),
                         identity=tsnap.snapshot_identity(str(art), "none", tloader.SNAPSHOT_MESH),
                         flavor="resnet-classifier",
                         config=json.loads((art / "config.json").read_text())["config"],
                         builder_kwargs={"image_size": 32})
    rstats: dict = {}
    restored = tloader.load_predictor(str(art), device="cpu", load_stats=rstats,
                                      snapshot_dir=str(snap))
    assert rstats.get("restore_s") is not None
    assert restored.name == "resnet-classifier" and restored.metadata == pred.metadata
    torch.testing.assert_close(restored.predict(imgs), got, rtol=0, atol=0)


def test_flavors_and_config_classes_match_the_reference():
    assert treg.list_flavors() == jreg.list_flavors()
    assert tloader._CONFIG_CLASSES.keys() == jloader._CONFIG_CLASSES.keys()
    cfg = tloader._build_config("resnet-classifier", {"width": 8, "stage_sizes": [1, 1],
                                                      "unknown": 1})
    assert isinstance(cfg, TR.ResNetConfig) and cfg.width == 8
    assert tloader._build_config("xgboost", {}) is None
