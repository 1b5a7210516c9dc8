"""SLO error-budget accounting: rolling attainment + burn rate per CR (the
port's copy of the JAX package's ``operator/slo.py``: pure bookkeeping,
the standard library only).

``spec.slo {ttftP99Ms, itlP99Ms, availabilityPct, windowMinutes}``
declares the serving objectives; this module turns the metrics the
operator ALREADY scrapes every reconcile step — TTFT/ITL p99 from the
engine series, availability from the router's gate histograms — into
the three numbers an on-call actually pages on:

- **attainment** — the fraction of in-window evaluation samples that
  met the target (each reconcile step contributes one sample per SLO;
  a sample whose signal was unobservable contributes nothing, never a
  fake pass/fail);
- **burn rate** — (1 − attainment) / (1 − objective).  1.0 means the
  error budget is being consumed exactly as fast as the objective
  allows; 2.0 means the budget will be gone in half the window;
- **error budget remaining** — max(0, 1 − burn rate) over the rolling
  window (1.0 = untouched, 0.0 = exhausted).

Exported as ``tpumlops_operator_slo_{attainment,error_budget_remaining,
burn_rate}{slo=...}`` (operator/telemetry.py) and journaled as
:class:`SloRecord` (``kind: "slo"``) into ``status.history`` /
``/debug/rollouts`` beside gate/scale/crashloop records whenever an
SLO's budget state changes — so "the canary gate refused WHILE the
availability budget was exhausted" reads straight out of the journal.

The sample windows live in operator memory (a restart restarts the
window — documented in docs/OBSERVABILITY.md; persisting per-step
samples in etcd-backed status would bloat every patch).  All pure
bookkeeping: the reconciler owns the I/O.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

from .rollout_recorder import _iso

# Budget states (``SloRecord.state``): transitions between these are
# what gets journaled.
STATE_WITHIN = "within_budget"
STATE_EXHAUSTED = "budget_exhausted"


@dataclass(frozen=True)
class SloRecord:
    """One SLO budget-state transition, with the numbers behind it."""

    wall: float  # unix epoch seconds at evaluation time
    slo: str = ""  # ttft_p99 | itl_p99 | availability
    state: str = STATE_WITHIN
    prior_state: str | None = None  # None = first evaluation
    attainment: float | None = None
    burn_rate: float | None = None
    budget_remaining: float | None = None
    target: float | None = None  # ms for latency SLOs, pct for availability
    objective_pct: float = 99.0
    window_minutes: float = 60.0
    observed: float | None = None  # the newest raw signal reading
    samples: int = 0  # in-window samples behind the numbers

    def as_dict(self) -> dict[str, Any]:
        return {
            "kind": "slo",
            "ts": self.wall,
            "time": _iso(self.wall),
            "slo": self.slo,
            "state": self.state,
            "priorState": self.prior_state,
            "attainment": self.attainment,
            "burnRate": self.burn_rate,
            "budgetRemaining": self.budget_remaining,
            "target": self.target,
            "objectivePct": self.objective_pct,
            "windowMinutes": self.window_minutes,
            "observed": self.observed,
            "samples": self.samples,
        }


@dataclass(frozen=True)
class SloEval:
    """One SLO's rolling numbers after the current step's sample
    (telemetry feed via ``ReconcileOutcome.slo``)."""

    slo: str
    attainment: float | None  # None = no samples in window yet
    burn_rate: float | None
    budget_remaining: float | None
    samples: int = 0
    observed: float | None = None
    target: float | None = None

    @property
    def state(self) -> str | None:
        if self.burn_rate is None:
            return None  # unobservable: no state claim either way
        return STATE_EXHAUSTED if self.burn_rate >= 1.0 else STATE_WITHIN

    def as_dict(self) -> dict[str, Any]:
        return {
            "slo": self.slo,
            "attainment": self.attainment,
            "burn_rate": self.burn_rate,
            "budget_remaining": self.budget_remaining,
            "samples": self.samples,
            "observed": self.observed,
            "target": self.target,
        }


@dataclass
class SloSample:
    """One per-step observation of one SLO's SLI."""

    wall: float
    good: bool
    observed: float | None = None


class SloTracker:
    """Rolling per-SLO sample windows for one CR.

    Each reconcile step appends at most one sample per SLO (skipped
    entirely when the signal was unobservable — blindness must never
    read as attainment OR violation) and evaluates attainment over the
    samples still inside ``window_minutes``.
    """

    def __init__(self) -> None:
        self._windows: dict[str, deque] = {}

    def observe(
        self, slo: str, wall: float, good: bool,
        observed: float | None = None,
    ) -> None:
        self._windows.setdefault(slo, deque()).append(
            SloSample(wall=wall, good=bool(good), observed=observed)
        )

    def evaluate(
        self,
        slo: str,
        wall: float,
        window_s: float,
        objective_pct: float,
        target: float | None = None,
    ) -> SloEval:
        window = self._windows.setdefault(slo, deque())
        cutoff = wall - window_s
        while window and window[0].wall < cutoff:
            window.popleft()
        samples = len(window)
        if samples == 0:
            return SloEval(
                slo=slo, attainment=None, burn_rate=None,
                budget_remaining=None, samples=0, target=target,
            )
        good = sum(1 for s in window if s.good)
        attainment = good / samples
        allowed = 1.0 - objective_pct / 100.0  # > 0 (pct < 100 enforced)
        burn = (1.0 - attainment) / allowed
        observed = None
        for s in reversed(window):
            if s.observed is not None:
                observed = s.observed
                break
        return SloEval(
            slo=slo,
            attainment=attainment,
            burn_rate=burn,
            budget_remaining=max(0.0, 1.0 - burn),
            samples=samples,
            observed=observed,
            target=target,
        )

    def reset(self) -> None:
        self._windows.clear()


def collect_samples(slo_spec, model_metrics, engine_metrics) -> dict:
    """Map the scraped readings onto per-SLO SLI samples.

    Returns ``{slo_name: (good, observed)}`` with unobservable signals
    OMITTED (not recorded as either outcome):

    - ``ttft_p99`` / ``itl_p99`` — the engine p99 (seconds) vs the ms
      target;
    - ``availability`` — ``1 − error_rate`` from the gate-compatible
      router histograms; no traffic in the window (``error_rate`` None)
      is not an availability claim.
    """
    out: dict[str, tuple] = {}
    if slo_spec.ttft_p99_ms > 0 and engine_metrics is not None:
        p99_s = getattr(engine_metrics, "ttft_p99_s", None)
        if p99_s is not None:
            ms = p99_s * 1000.0
            out["ttft_p99"] = (ms <= slo_spec.ttft_p99_ms, ms)
    if slo_spec.itl_p99_ms > 0 and engine_metrics is not None:
        p99_s = getattr(engine_metrics, "itl_p99_s", None)
        if p99_s is not None:
            ms = p99_s * 1000.0
            out["itl_p99"] = (ms <= slo_spec.itl_p99_ms, ms)
    if model_metrics is not None and model_metrics.error_rate is not None:
        availability = (1.0 - model_metrics.error_rate) * 100.0
        out["availability"] = (
            availability >= slo_spec.availability_pct, availability,
        )
    return out


def target_of(slo_spec, name: str) -> float | None:
    return {
        "ttft_p99": slo_spec.ttft_p99_ms,
        "itl_p99": slo_spec.itl_p99_ms,
        "availability": slo_spec.availability_pct,
    }.get(name)
