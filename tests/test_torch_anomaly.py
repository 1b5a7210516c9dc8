"""The port's ``operator/anomaly.py`` against the JAX package's.

- ``tests/test_anomaly.py`` runs against the port (``torch_transplant``,
  ``backend: cuda`` on ``h100-1`` where it says ``tpu``): robust z, slope,
  ``detect``, the ring extraction helpers, the spec, the multiplexer's
  straggler demotion and the reconciler's journal, dedupe and status.
- Every call that file's tests make to the JAX ``detect`` is recorded and
  made again on the port with the same windows, spec and baselines: the
  verdicts are equal, field by field and in order.
"""

from __future__ import annotations

import dataclasses
from importlib import import_module

import pytest

import test_anomaly as REF_TESTS
import torch_transplant as TT
import tpumlops.operator.anomaly as JA

PA = import_module(f"{TT.PORT}.operator.anomaly")
PC = import_module(f"{TT.PORT}.utils.config")

_SUBS = [(r"^_TPU_RING = \{", '_TPU_RING = {"gpuTopology": "h100-1", ')]
_mod = TT.transplant("test_anomaly", vocabulary=True, subs=_SUBS)
TT.export(_mod, globals(), [n for n in sorted(vars(_mod)) if n.startswith("test_")],
          tag="reference")


def _record_detect_calls() -> list:
    calls = []
    real = JA.detect

    def spy(windows, spec, baselines=None):
        out = real(windows, spec, baselines)
        calls.append((dataclasses.asdict(spec), windows, baselines, out))
        return out

    JA.detect = spy
    saved = {k: v for k, v in vars(REF_TESTS).items() if v is real}
    for k in saved:
        setattr(REF_TESTS, k, spy)
    try:
        for name, fn in sorted(vars(REF_TESTS).items()):
            if name.startswith("test_") and callable(fn) and fn.__code__.co_argcount == 0 \
                    and not getattr(fn, "pytestmark", None):
                fn()
    finally:
        JA.detect = real
        for k, v in saved.items():
            setattr(REF_TESTS, k, v)
    return calls


CALLS = _record_detect_calls()


def test_the_reference_tests_called_detect():
    assert len(CALLS) >= 10
    assert any(out for *_, out in CALLS) and any(not out for *_, out in CALLS)


@pytest.mark.parametrize("case", range(len(CALLS)))
def test_detect_gives_the_reference_verdicts(case):
    spec, windows, baselines, want = CALLS[case]
    got = PA.detect(windows, PC.AnomalySpec(**spec), baselines)
    assert [v.as_dict() for v in got] == [v.as_dict() for v in want]


@pytest.mark.parametrize("x,peers", [
    (5.0, [1.0, 1.1, 0.9, 5.0]), (1.0, [1.0, 1.0, 1.0]), (3.0, [1.0, 1.0, 3.0]),
    (-2.0, [0.0, 0.1, -2.0, 0.05, 0.02]), (7.0, [7.0, 7.5]),
])
def test_robust_z_and_slope_equal_the_reference(x, peers):
    assert PA.robust_z(x, peers) == JA.robust_z(x, peers)
    assert PA.slope(peers) == JA.slope(peers)
