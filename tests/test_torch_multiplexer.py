"""The port's ``operator/multiplexer.py`` against the JAX package's.

- ``tests/test_multiplexer.py`` runs against the port (``torch_transplant``,
  ``backend: cuda`` on ``h100-1`` where it says ``tpu``): ``plan``, the
  coordinator's attach / replace / error records and rate limit, the spec
  and the reconciler's status and journal.
- Every call that file's and ``tests/test_anomaly.py``'s tests make to the
  JAX ``plan`` is recorded and made again on the port with the same pool,
  members, replicas, wall and stragglers: the moves and holds are equal.
"""

from __future__ import annotations

import dataclasses
from importlib import import_module

import pytest

import test_anomaly as REF_ANOMALY
import test_multiplexer as REF_TESTS
import torch_transplant as TT
import tpumlops.operator.multiplexer as JX

PX = import_module(f"{TT.PORT}.operator.multiplexer")

_SUBS = [(r"^_TPU = \{", '_TPU = {"gpuTopology": "h100-1", ')]
_mod = TT.transplant("test_multiplexer", vocabulary=True, subs=_SUBS)
TT.export(_mod, globals(), [n for n in sorted(vars(_mod)) if n.startswith("test_")],
          tag="reference")


def _record_plan_calls() -> list:
    calls = []
    real = JX.plan

    def spy(pool, models, replicas, wall, stragglers=frozenset()):
        out = real(pool, models, replicas, wall, stragglers)
        calls.append((pool, [dataclasses.asdict(m) for m in models],
                      [dataclasses.asdict(r) for r in replicas], wall, frozenset(stragglers),
                      out))
        return out

    JX.plan = spy
    saved = [(mod, k) for mod in (REF_TESTS, REF_ANOMALY) for k, v in vars(mod).items()
             if v is real]
    for mod, k in saved:
        setattr(mod, k, spy)
    try:
        for mod in (REF_TESTS, REF_ANOMALY):
            for name, fn in sorted(vars(mod).items()):
                if name.startswith("test_") and callable(fn) \
                        and fn.__code__.co_argcount == 0 and not getattr(fn, "pytestmark", None):
                    fn()
    finally:
        JX.plan = real
        for mod, k in saved:
            setattr(mod, k, real)
    return calls


CALLS = _record_plan_calls()


def _view(p) -> dict:
    return {"moves": [(m.model.name, m.replica.name, m.replace, m.displaced)
                      for m in p.moves],
            "holds": [r.as_dict() for r in p.holds]}


def test_the_reference_tests_called_plan_with_stragglers():
    assert len(CALLS) >= 8
    assert any(c[4] for c in CALLS)  # a straggler set among them
    assert any(c[5].moves for c in CALLS)


@pytest.mark.parametrize("case", range(len(CALLS)))
def test_plan_gives_the_reference_moves(case):
    pool, models, replicas, wall, stragglers, want = CALLS[case]
    got = PX.plan(pool, [PX.MuxModel(**m) for m in models],
                  [PX.MuxReplica(**r) for r in replicas], wall, stragglers)
    assert _view(got) == _view(want)
