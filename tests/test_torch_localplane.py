"""Live canaries on the CPU through the port's local plane: the port's
servers (``clients.localplane.start_model_server``, ``device="cpu"``)
behind the port's native router, the port's ``OperatorRuntime`` on a
``SystemClock`` over ``SyncingKube``, and the judge reading the router's
real histograms — the two e2e scenarios of
``tests/test_e2e_localplane.py`` (``test_full_promotion_on_live_metrics``,
``test_rollback_on_slo_breach_with_live_metrics``) and a tiny BERT pair
through the plain flash path.  The same iris canary through the JAX
package's local plane gives the promotion journal's reference shape: the
same phases and the same weight ladder.
"""

from __future__ import annotations

import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.clients import (
    base as PBASE,
    fakes as PFAKES,
    localplane as PLP,
    router as PR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.operator import (
    runtime as PRT,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    clock as PCLOCK,
)


class _Journal:
    def __init__(self):
        self.records: list = []

    def record(self, namespace, name, rec):
        self.records.append(rec)

    def shape(self):
        """(phase transitions, promoted weight ladder) of the journal."""
        phases = [(r.from_phase, r.to_phase, r.reason) for r in self.records
                  if hasattr(r, "to_phase")]
        ladder = [r.traffic_after for r in self.records if hasattr(r, "margins") and r.promote]
        return phases, ladder


def wait_for(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {what}")


def _world(mods, ports, model="iris"):
    base, fakes, lp, router_mod, runtime, clock = mods
    router = router_mod.RouterProcess(port=lp.free_port(), backends={},
                                      namespace="models").start()
    sync = router_mod.RouterSync(router.admin, lambda pred: ("127.0.0.1", ports[pred]))
    kube = lp.SyncingKube(sync)
    registry = fakes.FakeRegistry()
    registry.register(model, "1", "mlflow-artifacts:/1/aaa/artifacts/model")
    registry.set_alias(model, "prod", "1")
    journal = _Journal()
    rt = runtime.OperatorRuntime(kube, registry,
                                 metrics=router_mod.RouterMetricsSource(router.admin),
                                 clock=clock.SystemClock(), sync_interval_s=0.05,
                                 recorder=journal)
    cr = base.ObjectRef(namespace="models", name=model, **base.MLFLOWMODEL)
    return router, kube, registry, rt, cr, journal


PORT_MODS = (PBASE, PFAKES, PLP, PR, PRT, PCLOCK)


def _status(kube, cr):
    return kube.get(cr).get("status") or {}


def _iris_canary(mods, ports, version="2", spec=None, body=None, model="iris"):
    lp = mods[2]
    router, kube, registry, rt, cr, journal = _world(mods, ports, model)
    try:
        kube.create(cr, {"spec": spec or lp.relaxed_gate_spec()})
        threading.Thread(target=rt.serve, daemon=True).start()
        wait_for(lambda: _status(kube, cr).get("phase") == "Stable", what="v1 Stable")
        assert router.admin.get_weights() == {"v1": 100}
        with lp.TrafficGenerator(router.port, model_name=model, body=body) as gen:
            wait_for(lambda: gen.sent > 50, what="baseline traffic")
            registry.register(model, version, f"mlflow-artifacts:/1/{version}/artifacts/model")
            registry.set_alias(model, "prod", version)
            wait_for(lambda: _status(kube, cr).get("phase") in ("Stable", "RolledBack")
                     and _status(kube, cr).get("heldVersion", None) in (None, version)
                     and (_status(kube, cr).get("currentModelVersion") == version
                          or _status(kube, cr).get("phase") == "RolledBack"),
                     timeout=90, what="the canary's end")
        return {"status": _status(kube, cr), "weights": router.admin.get_weights(),
                "reasons": kube.event_reasons(), "metrics": router.admin.metrics_text(),
                "journal": journal, "router": router}
    finally:
        rt.stop()
        router.stop()


@pytest.fixture(scope="module")
def iris(tmp_path_factory):
    uris = PLP.train_iris_pair(tmp_path_factory.mktemp("iris"))
    handles = {f"v{v}": PLP.start_model_server(uri, f"v{v}", PLP.free_port(), device="cpu")
               for v, uri in uris.items()}
    yield {k: h.port for k, h in handles.items()}, uris
    for h in handles.values():
        h.stop()


def test_full_promotion_on_live_metrics(iris):
    ports, _ = iris
    res = _iris_canary(PORT_MODS, ports)
    st = res["status"]
    assert st["phase"] == "Stable" and st["currentModelVersion"] == "2"
    assert st["previousModelVersion"] is None and st["trafficCurrent"] == 100
    for reason in ("NewModelVersionDetected", "TrafficIncrease", "PromotionComplete"):
        assert reason in res["reasons"]
    assert res["weights"] == {"v2": 100}
    assert 'predictor_name="v1"' not in res["metrics"]
    assert 'predictor_name="v2"' in res["metrics"]
    phases, ladder = res["journal"].shape()
    assert ladder == [50, 75, 100]


def test_rollback_on_slo_breach_with_live_metrics(iris):
    ports, _ = iris
    spec = PLP.relaxed_gate_spec(maxAttempts=3, attemptDelay=0.1, rollbackOnFailure=True)
    res = _iris_canary(PORT_MODS, {**ports, "v3": PLP.free_port()}, version="3", spec=spec)
    st = res["status"]
    assert st["phase"] == "RolledBack"
    assert st["currentModelVersion"] == "1" and st["heldVersion"] == "3"
    assert "PromotionFailed" in res["reasons"] and "RollbackComplete" in res["reasons"]
    assert res["weights"].get("v1") == 100
    phases, _ = res["journal"].shape()
    assert phases[-1][1:] == ("RolledBack", "RollbackComplete")


def test_the_journal_has_the_reference_shape(iris):
    """The same canary through the JAX package's local plane (its servers,
    its router, its runtime): the same phases and the same weight ladder."""
    from tpumlops.clients import base, fakes, localplane, router
    from tpumlops.operator import runtime
    from tpumlops.utils import clock

    ports, uris = iris
    ref_handles = {f"v{v}": localplane.start_model_server(uri, f"v{v}", localplane.free_port())
                   for v, uri in uris.items()}
    try:
        ref = _iris_canary((base, fakes, localplane, router, runtime, clock),
                           {k: h.port for k, h in ref_handles.items()})
    finally:
        for h in ref_handles.values():
            h.stop()
    got = _iris_canary(PORT_MODS, ports)
    assert got["journal"].shape() == ref["journal"].shape()
    assert ref["journal"].shape()[1] == [50, 75, 100]
    assert got["reasons"][-1] == ref["reasons"][-1] == "PromotionComplete"


def test_a_tiny_bert_pair_promotes_through_the_plain_flash_path(tmp_path):
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
        bert,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
        flash_attention as fa,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
        loader,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
        config,
    )

    cfg = bert.BertConfig.tiny()
    handles, ports = {}, {}
    calls = []
    real = bert.flash_attention

    def counting(*a, **k):
        calls.append(a[0].device.type)
        return real(*a, **k)

    spec = {**PLP.relaxed_gate_spec(step=50, initialTraffic=50), "modelName": "bert",
            "backend": "cuda", "cuda": {"gpuTopology": "h100-1", "dtype": "float32"}}
    cuda = config.OperatorConfig.from_spec(spec).cuda
    bert.flash_attention = counting
    try:
        for seed in (1, 2):
            params = bert.init(torch.Generator().manual_seed(seed), cfg)
            uri = loader.save_native_model(tmp_path / f"v{seed}", "bert-classifier", params,
                                           config=__import__("dataclasses").asdict(cfg),
                                           builder_kwargs={"seq_len": 16})
            port = PLP.free_port()
            handles[f"v{seed}"] = PLP.start_model_server(
                str(uri), f"v{seed}", port, model_name="bert", deployment_name="bert",
                cuda=cuda, device="cpu")
            ports[f"v{seed}"] = port
        ids = np.arange(1, 17, dtype=np.int32)[None, :]
        body = ('{"inputs": [{"name": "input_ids", "datatype": "INT32", "shape": [1, 16], '
                f'"data": {ids.reshape(-1).tolist()}}}]}}').encode()
        res = _iris_canary(PORT_MODS, ports, spec=spec, body=body, model="bert")
        st = res["status"]
        assert st["phase"] == "Stable" and st["currentModelVersion"] == "2"
        assert res["weights"] == {"v2": 100}
        assert res["journal"].shape()[1] == [100]
        assert calls and set(calls) == {"cpu"}
        assert fa.launches == 0  # the plain path never counts a kernel launch
        req = urllib.request.Request(f"http://127.0.0.1:{ports['v2']}/v2/models/bert/infer",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            import json

            out = json.loads(r.read())["outputs"][0]
        got = np.asarray(out["data"], np.float32).reshape(out["shape"])
        want = handles["v2"].server.predictor.predict(ids).float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        bert.flash_attention = real
        for h in handles.values():
            h.stop()


def test_a_stopped_server_releases_its_port(tmp_path):
    uris = PLP.train_iris_pair(tmp_path)
    port = PLP.free_port()
    h = PLP.start_model_server(uris["1"], "v1", port, device="cpu")
    h.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/v2/health/ready", timeout=2)
    h2 = PLP.start_model_server(uris["1"], "v1", port, device="cpu")  # the port is free again
    h2.stop()
