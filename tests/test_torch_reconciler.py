"""The port's reconciler, runtime, judge and autoscaler against the JAX
package's, scenario by scenario on a ``FakeClock`` with scripted metrics.

Each scenario of ``tests/test_reconciler.py``, ``test_runtime.py``,
``test_judge.py`` and ``test_autoscaler.py`` that this slice serves —
promotion, a gate hold that fails frozen, rollback on an SLO breach, a
crash loop, an operator restart in the middle of a rollout, the
autoscaler's decisions — runs through both packages' fakes and
reconcilers.  The sequences of phases, weights, event reasons and status
patches are equal after the mapping of ``torch_operator_map``
(``backend: tpu`` on ``v5e-1`` is ``backend: cuda`` on ``h100-1``).
"""

from __future__ import annotations

import copy
import itertools
from importlib import import_module

import pytest

import torch_operator_map as M

NS, NAME = "models", "iris"
TIMES = {"lastTransitionTime", "ts", "time", "wall", "timings", "lastScaleTime",
         "lastScaleUpWall", "lastScaleDownWall", "stableSinceWall"}


class Pkg:
    def __init__(self, root: str, port: bool):
        self.port = port
        for mod in ("clients.base", "clients.fakes", "operator.reconciler", "operator.runtime",
                    "operator.judge", "operator.autoscaler", "operator.state", "utils.clock",
                    "utils.config"):
            setattr(self, mod.split(".")[1], import_module(f"{root}.{mod}"))

    def spec(self, spec: dict) -> dict:
        return M.port_spec(spec) if self.port else copy.deepcopy(spec)


REF, PORT = Pkg("tpumlops", False), Pkg(M.PORT, True)


def _scrub(obj):
    """Status and journal records without wall times and op timings."""
    if isinstance(obj, dict):
        return {k: (None if k in TIMES else _scrub(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


class World:
    def __init__(self, pkg: Pkg, spec_extra=None, metrics_factory=False):
        b = pkg.base
        self.pkg = pkg
        self.kube = pkg.fakes.FakeKube()
        self.registry = pkg.fakes.FakeRegistry()
        self.metrics = pkg.fakes.FakeMetrics()
        self.clock = pkg.clock.FakeClock()
        self.wall = [1_000_000.0]
        self.patches: list = []
        real = self.kube.patch_status

        def patch(ref, status):
            if ref.plural == b.MLFLOWMODEL["plural"]:
                self.patches.append(_scrub(copy.deepcopy(dict(status))))
            return real(ref, status)

        self.kube.patch_status = patch
        self.cr = b.ObjectRef(namespace=NS, name=NAME, **b.MLFLOWMODEL)
        self.sd = b.ObjectRef(namespace=NS, name=NAME, **b.SELDONDEPLOYMENT)
        spec = {"modelName": "iris", "modelAlias": "champion", "minioSecret": "m"}
        spec.update(copy.deepcopy(spec_extra or {}))
        self.kube.create(self.cr, {"apiVersion": "mlflow.nizepart.com/v1alpha1",
                                   "kind": "MlflowModel",
                                   "metadata": {"name": NAME, "namespace": NS, "uid": "u1"},
                                   "spec": pkg.spec(spec)})
        self.registry.register("iris", "1", "mlflow-artifacts:/1/aaa/artifacts/model")
        self.registry.set_alias("iris", "champion", "1")
        self.rec = self.reconciler()
        self.trace: list = []

    def reconciler(self):
        return self.pkg.reconciler.Reconciler(NAME, NS, self.kube, self.registry, self.metrics,
                                              self.clock, wall=lambda: self.wall[0])

    def metrics_of(self, **kw):
        return self.pkg.base.ModelMetrics(**kw)

    def step(self):
        n_events = len(self.kube.event_reasons())
        out = self.rec.reconcile(self.kube.get(self.cr))
        try:
            preds = {p["name"]: [p["traffic"], p["replicas"]]
                     for p in self.kube.get(self.sd)["spec"]["predictors"]}
        except self.pkg.base.NotFound:
            preds = None
        st = out.state
        self.trace.append({
            "phase": st.phase.value, "current": st.current_version,
            "previous": st.previous_version, "traffic": [st.traffic_current, st.traffic_prev],
            "attempt": st.attempt, "replicas": st.replicas, "requeue": out.requeue_after,
            "predictors": preds, "events": self.kube.event_reasons()[n_events:],
            "gate": None if out.gate is None else _scrub(out.gate.as_dict()),
            "scale": None if out.scale is None else _scrub(out.scale.as_dict()),
        })
        return out

    def result(self):
        return {"trace": self.trace, "patches": self.patches,
                "status": _scrub(self.kube.get(self.cr).get("status"))}


GOOD = dict(latency_p95=0.1, error_rate=0.01, latency_avg=0.05, request_count=500)
BAD = dict(latency_p95=0.5, error_rate=0.2, latency_avg=0.4, request_count=500)
CUDA = {"backend": "tpu", "tpu": {"tpuTopology": "v5e-1"}}


def _canary(w: World, new: dict, steps: int = 40):
    w.registry.register("iris", "2", "mlflow-artifacts:/1/bbb/artifacts/model")
    w.registry.set_alias("iris", "champion", "2")
    w.metrics.set_metrics(NAME, "v1", NS, w.metrics_of(**GOOD))
    w.metrics.set_metrics(NAME, "v2", NS, w.metrics_of(**new))
    for _ in range(steps):
        out = w.step()
        if out.state.phase.value != "Canary":
            break
        w.clock.advance(out.requeue_after)


def sc_promotion(pkg, extra):
    w = World(pkg, extra)
    w.step()
    _canary(w, GOOD)
    return w.result()


def sc_hold_fails_frozen(pkg, extra):
    w = World(pkg, {**extra, "canary": {"maxAttempts": 3}})
    w.step()
    _canary(w, BAD)
    return w.result()


def sc_rollback_on_slo_breach(pkg, extra):
    w = World(pkg, {**extra, "canary": {"maxAttempts": 3, "rollbackOnFailure": True},
                    "observability": {"historyLimit": 16}})
    w.step()
    _canary(w, BAD)
    for _ in range(2):  # the held version stays held
        w.clock.advance(60)
        w.step()
    return w.result()


def sc_restart_mid_rollout(pkg, extra):
    w = World(pkg, {**extra, "observability": {"historyLimit": 16}})
    w.step()
    _canary(w, GOOD, steps=4)
    w.rec = w.reconciler()  # the operator restarts: state comes back from status
    _canary(w, GOOD)
    return w.result()


def sc_mid_canary_supersede(pkg, extra):
    w = World(pkg, extra)
    w.step()
    _canary(w, GOOD, steps=3)
    w.registry.register("iris", "3", "mlflow-artifacts:/1/ccc/artifacts/model")
    w.registry.set_alias("iris", "champion", "3")
    w.metrics.set_metrics(NAME, "v3", NS, w.metrics_of(**GOOD))
    for _ in range(30):
        out = w.step()
        if out.state.phase.value != "Canary":
            break
        w.clock.advance(out.requeue_after)
    return w.result()


def sc_crash_loop(pkg, extra):
    w = World(pkg, {**extra, "observability": {"historyLimit": 8}})
    w.metrics.set_metrics(NAME, "v1", NS, w.metrics_of(**GOOD))
    b = pkg.base
    pod = b.ObjectRef(namespace=NS, name="iris-v1-abc", group="", version="v1", plural="pods")
    w.step()
    for restarts in (2, 2, 5):
        status = {"containerStatuses": [{"name": "server", "restartCount": restarts,
                                         "lastState": {"terminated": {"reason": "Error"}}}]}
        try:
            w.kube.create(pod, {"apiVersion": "v1", "kind": "Pod",
                                "metadata": {"name": "iris-v1-abc", "namespace": NS,
                                             "labels": {"tpumlops/deployment": NAME}},
                                "status": status})
        except b.Conflict:
            w.kube.patch_status(pod, status)
        w.clock.advance(60)
        w.step()
    return w.result()


AUTOSCALE = {"enabled": True, "minReplicas": 1, "maxReplicas": 4,
             "targetQueueDepthPerReplica": 2, "scaleUpStabilizationSeconds": 0,
             "scaleDownCooldownSeconds": 60}


def sc_autoscaler(pkg, extra):
    w = World(pkg, {**extra, "autoscaling": AUTOSCALE, "observability": {"historyLimit": 32}})
    w.step()
    for qd, dt in ((7, 1), (7, 1), (0, 30), (0, 61), (0, 10), (0, 61), (0, 61), (None, 61),
                   (3, 61)):
        w.metrics.set_engine_metrics(NAME, "v1", NS,
                                     pkg.base.EngineMetrics(queue_depth=qd))
        w.wall[0] += dt
        w.clock.advance(dt)
        w.step()
    _canary(w, GOOD)  # frozen during the canary, resumes after
    w.wall[0] += 61
    w.step()
    return w.result()


def sc_invalid_spec(pkg, extra):
    w = World(pkg, {**extra, "canary": {"step": 0}})
    w.step()
    return w.result()


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_promotion, sc_hold_fails_frozen, sc_rollback_on_slo_breach, sc_restart_mid_rollout,
    sc_mid_canary_supersede, sc_crash_loop, sc_autoscaler, sc_invalid_spec)}


def _port_view(result: dict) -> dict:
    """The reference's record in the port's vocabulary (topology names,
    the backend, the spec's message prefixes)."""
    import json

    text = json.dumps(result, sort_keys=True)
    for a, b in M.MESSAGE:
        text = text.replace(json.dumps(a)[1:-1], json.dumps(b)[1:-1])
    return json.loads(text)


@pytest.mark.parametrize("backend", ["seldon", "cuda"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_runs_alike(scenario, backend):
    extra = {} if backend == "seldon" else CUDA
    ref = SCENARIOS[scenario](REF, extra)
    got = SCENARIOS[scenario](PORT, extra)
    assert got["trace"], scenario
    assert got == _port_view(ref)


def test_promotion_reaches_100_and_deletes_the_old_predictor():
    got = sc_promotion(PORT, CUDA)
    last = got["trace"][-1]
    assert last["phase"] == "Stable" and last["current"] == "2"
    assert last["predictors"] == {"v2": [100, 1]}
    weights = [t["traffic"][0] for t in got["trace"] if t["phase"] == "Canary"]
    assert weights == [10, 20, 30, 40, 50, 60, 70, 80, 90]
    assert "PromotionComplete" in last["events"]


def test_rollback_restores_the_stable_version():
    got = sc_rollback_on_slo_breach(PORT, CUDA)
    assert got["status"]["phase"] == "RolledBack"
    assert got["status"]["currentModelVersion"] == "1"
    assert got["status"]["heldVersion"] == "2"
    events = list(itertools.chain.from_iterable(t["events"] for t in got["trace"]))
    assert "RollbackComplete" in events


@pytest.mark.parametrize("section", [
    {"slo": {"ttftP99Ms": 250}},
    {"backend": "tpu", "tpu": {"tpuTopology": "v5e-16"}},
    {"backend": "tpu", "multiplex": {"poolRef": "pool"},
     "tpu": {"tpuTopology": "v5e-1", "snapshot": {"enabled": True}}},
    {"backend": "tpu", "tpu": {"tpuTopology": "v5e-8", "meshShape": {"dp": 1, "tp": 8}}},
    {"backend": "tpu", "tpu": {"tpuTopology": "v5e-16", "meshShape": {"dp": 1, "tp": 16}}},
])
def test_an_unported_feature_is_an_invalid_spec_on_the_cr(section):
    """A mesh smaller than a unit across hosts (h100-16 at the default
    {dp: 1, tp: 1}) is still refused as any bad spec is (``status.error``,
    one ``InvalidSpec`` event, no data plane); ``spec.slo``,
    ``spec.multiplex`` and units of several cards, on one host or across
    two, are served and reach ``Stable`` with the JAX package's trace."""
    w = World(PORT, section)
    w.step()
    w.step()
    status = w.kube.get(w.cr)["status"]
    if section.get("tpu", {}) == {"tpuTopology": "v5e-16"}:
        assert "invalid spec" in status["error"] and "not yet ported" in status["error"]
        assert w.kube.event_reasons().count("InvalidSpec") == 1
        with pytest.raises(PORT.base.NotFound):
            w.kube.get(w.sd)
        return
    assert status["phase"] == "Stable" and not status.get("error"), status
    assert "InvalidSpec" not in w.kube.event_reasons()
    ref = World(REF, section)
    ref.step()
    ref.step()
    assert w.result() == _port_view(ref.result())


def _runtime_canary(pkg, extra):
    w = World(pkg, extra)
    rt = pkg.runtime.OperatorRuntime(w.kube, w.registry, w.metrics, w.clock)
    rt.step()
    w.registry.register("iris", "2", "mlflow-artifacts:/1/bbb/artifacts/model")
    w.registry.set_alias("iris", "champion", "2")
    w.metrics.set_metrics(NAME, "v1", NS, w.metrics_of(**GOOD))
    w.metrics.set_metrics(NAME, "v2", NS, w.metrics_of(**GOOD))
    rt.run_for(10 * 60)
    weights = [p["traffic"] for p in w.kube.get(w.sd)["spec"]["predictors"]]
    rt.sync()
    w.kube.delete(w.cr)
    rt.step()
    try:
        w.kube.get(w.sd)
        torn_down = False
    except pkg.base.NotFound:
        torn_down = True
    return {"patches": w.patches, "events": w.kube.event_reasons(), "weights": weights,
            "now": w.clock.now(), "torn_down": torn_down}


@pytest.mark.parametrize("backend", ["seldon", "cuda"])
def test_runtime_full_canary_with_fake_clock_runs_alike(backend):
    extra = {} if backend == "seldon" else CUDA
    ref, got = _runtime_canary(REF, extra), _runtime_canary(PORT, extra)
    assert got == _port_view(ref)
    assert got["weights"] == [100] and got["events"][-1] == "PromotionComplete"
    assert got["torn_down"]


_LEVELS = (None, 0.0, 0.01, 0.1, 0.105, 0.5)


@pytest.mark.parametrize("thresholds", [
    {}, {"errorRateFloor": 0.05}, {"minSampleCount": 100}, {"latencyP95": 0.5, "latencyAvg": 1},
])
def test_the_judge_decides_alike(thresholds):
    for p95, err, avg in itertools.product(_LEVELS, _LEVELS, _LEVELS[:4]):
        for count in (50, 500):
            ref_t = REF.config.GateThresholds.from_spec(thresholds)
            port_t = PORT.config.GateThresholds.from_spec(thresholds)
            old = dict(latency_p95=0.1, error_rate=0.0, latency_avg=0.05, request_count=500)
            new = dict(latency_p95=p95, error_rate=err, latency_avg=avg, request_count=count)
            r = REF.judge.should_promote(REF.base.ModelMetrics(**new),
                                         REF.base.ModelMetrics(**old), ref_t)
            g = PORT.judge.should_promote(PORT.base.ModelMetrics(**new),
                                          PORT.base.ModelMetrics(**old), port_t)
            assert (g.promote, g.reasons, dict(g.margins), set(g.missing_on)) == \
                (r.promote, r.reasons, dict(r.margins), set(r.missing_on))


def test_the_autoscaler_decides_alike():
    ref_spec = REF.config.AutoscalingSpec.from_spec(AUTOSCALE)
    port_spec = PORT.config.AutoscalingSpec.from_spec(AUTOSCALE)
    for current, qd, ttft, wall in itertools.product((0, 1, 2, 4), (None, 0, 3, 9),
                                                     (None, 0.1, 5.0), (1000.0, 1100.0)):
        r = REF.autoscaler.decide(ref_spec, current, REF.autoscaler.ScalerState(),
                                  REF.base.EngineMetrics(queue_depth=qd, ttft_p99_s=ttft),
                                  now_wall=wall)
        g = PORT.autoscaler.decide(port_spec, current, PORT.autoscaler.ScalerState(),
                                   PORT.base.EngineMetrics(queue_depth=qd, ttft_p99_s=ttft),
                                   now_wall=wall)
        assert repr(g) == repr(r)
