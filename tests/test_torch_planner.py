"""The port's ``operator/planner.py`` against the JAX package's.

The JAX package plans with v5e's rooflines by default; the port with
``server/device_telemetry.detect_peaks()`` (the H100's, detected on the
card, assumed elsewhere).  With the v5e ``DevicePeaks`` passed in, the
port's planner reproduces ``tests/fixtures/journey_plan.json`` from
``tests/fixtures/journey_trace.json`` byte for byte, and every
``predict`` / ``plan`` call of ``tests/test_planner.py`` gives the JAX
package's numbers.  That file's tests also run against the port
(``torch_transplant``, ``backend: cuda`` on ``h100-1``) with the v5e table
as the port's default.  With the H100 default, the fixture's plan is
deterministic and pinned here.
"""

from __future__ import annotations

import dataclasses
import json
from importlib import import_module
from pathlib import Path

import pytest

import test_planner as REF_TESTS
import torch_transplant as TT
import tpumlops.operator.planner as JPL

PPL = import_module(f"{TT.PORT}.operator.planner")
PDT = import_module(f"{TT.PORT}.server.device_telemetry")
PJT = import_module(f"{TT.PORT}.utils.journey_trace")
PC = import_module(f"{TT.PORT}.utils.config")

FIXTURES = Path(__file__).parent / "fixtures"
# The JAX planner's default table (``planner.py``'s v5e rooflines, its
# ``DevicePeaks`` interconnect field at its default).
V5E = PDT.DevicePeaks(kind="tpu-v5e(assumed)", flops_per_s=197e12, hbm_bytes_per_s=819e9,
                      hbm_bytes=16 * 2**30, source="assumed", link_bytes_per_s=2e11)

_mod = TT.transplant("test_planner", vocabulary=True, subs=[(r'"h100-8"', '"h100-1"')])
TT.export(_mod, globals(), [n for n in sorted(vars(_mod)) if n.startswith("test_")],
          tag="reference")


@pytest.fixture(autouse=True)
def v5e_default(request, monkeypatch):
    if request.node.name.startswith("test_reference_"):
        monkeypatch.setattr(PPL, "detect_peaks", lambda: V5E)


def test_the_v5e_table_is_the_reference_default():
    ref = JPL._DEFAULT_PEAKS
    assert (ref.flops_per_s, ref.hbm_bytes_per_s, ref.hbm_bytes, ref.ici_bytes_per_s) == \
        (V5E.flops_per_s, V5E.hbm_bytes_per_s, V5E.hbm_bytes, V5E.link_bytes_per_s)


def _fixture_trace():
    return PJT.load_journey_trace(json.loads((FIXTURES / "journey_trace.json").read_text()))


def test_the_fixture_plan_is_reproduced_byte_for_byte_with_v5e_peaks():
    got = PPL.plan(_fixture_trace(), {"ttftP99Ms": 250}, peaks=V5E, chips_available=8)
    text = json.dumps(got, indent=1, sort_keys=True) + "\n"
    assert text == (FIXTURES / "journey_plan.json").read_text()


H100_FIXTURE_PLAN = {
    "formatVersion": 1, "seed": 0, "objective": {"ttftP99Ms": 250.0},
    "knobs": {"decodeSteps": 1, "maxSlots": 4, "meshShape": {"dp": 1, "tp": 1},
              "prefillBatch": 1, "prefillTokenBudget": 0, "quantize": "int8kv",
              "replicas": 1, "speculative": True},
    "predicted": {"chipSeconds": 19.672, "chips": 1, "makespanS": 19.672,
                  "ttftP50Ms": 2.438, "ttftP99Ms": 3.293},
    "trace": {"formatVersion": 1, "requests": 90, "spanS": 19.6},
    "searched": 432,
}


def test_the_h100_default_plan_is_deterministic_and_pinned():
    peaks = PDT.detect_peaks()
    assert peaks.kind.startswith("nvidia-h100") and peaks.link_bytes_per_s == 450e9
    a = PPL.plan(_fixture_trace(), {"ttftP99Ms": 250}, chips_available=8)
    b = PPL.plan(_fixture_trace(), {"ttftP99Ms": 250}, peaks=peaks, chips_available=8)
    assert a == b == H100_FIXTURE_PLAN


def _record(fn_name: str) -> list:
    calls = []
    real = getattr(JPL, fn_name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(JPL, fn_name, spy)
    saved = [k for k, v in vars(REF_TESTS).items() if v is real]
    for k in saved:
        setattr(REF_TESTS, k, spy)
    try:
        for name, fn in sorted(vars(REF_TESTS).items()):
            if name.startswith("test_") and callable(fn) and fn.__code__.co_argcount == 0 \
                    and not getattr(fn, "pytestmark", None):
                try:
                    fn()
                except Exception:
                    pass  # the reference's own suite holds its outcomes
    finally:
        setattr(JPL, fn_name, real)
        for k in saved:
            setattr(REF_TESTS, k, real)
    return calls


PREDICTS = _record("predict")


def _port_args(args, kwargs):
    def conv(x):
        if isinstance(x, JPL.KnobPoint):
            return PPL.KnobPoint(**dataclasses.asdict(x))
        if isinstance(x, JPL.ModelProfile):
            return PPL.ModelProfile(**dataclasses.asdict(x))
        if type(x).__name__ == "JourneyTrace":
            return PJT.load_journey_trace(_trace_export(x))
        return x
    kwargs = {k: conv(v) for k, v in kwargs.items()}
    kwargs["peaks"] = V5E if kwargs.get("peaks") is None else kwargs["peaks"]
    return [conv(a) for a in args], kwargs


def _trace_export(trace) -> dict:
    return {"format_version": trace.format_version,
            "requests": [{"ts_us": round(r.arrival_s * 1e6), "prompt_tokens": r.prompt_tokens,
                          "max_new_tokens": r.max_new_tokens,
                          **({"slo_class": r.slo_class} if r.slo_class else {})}
                         for r in trace.requests]}


def test_the_reference_tests_called_predict():
    assert len(PREDICTS) >= 20


@pytest.mark.parametrize("case", range(0, len(PREDICTS), max(1, len(PREDICTS) // 24)))
def test_predict_gives_the_reference_numbers(case):
    args, kwargs, want = PREDICTS[case]
    if kwargs.get("peaks") is not None:
        pytest.fail("the reference tests pass no peaks to predict")
    pargs, pkw = _port_args(args, kwargs)
    got = PPL.predict(*pargs, **pkw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_apply_plan_rewrites_the_cuda_spec():
    cfg = PC.OperatorConfig.from_spec({"modelName": "m", "modelAlias": "a", "backend": "cuda",
                                       "cuda": {"gpuTopology": "h100-1"}})
    out = PPL.apply_plan(cfg, H100_FIXTURE_PLAN)
    assert out.cuda.quantize == "int8kv" and out.cuda.max_slots == 4
    assert out.cuda.speculative.enabled and dict(out.cuda.mesh_shape) == {"dp": 1, "tp": 1}
    assert out.cuda.replicas == 1 and cfg.cuda.quantize == "none"
