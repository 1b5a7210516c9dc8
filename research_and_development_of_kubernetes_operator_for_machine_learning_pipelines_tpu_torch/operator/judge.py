"""The promotion gate: decide whether the canary earns more traffic.

Reference: ``should_promote_model`` (``mlflow_operator.py:419-460``).
Semantics preserved with default thresholds:

- any of {p95 latency, error rate, mean latency} being ``None`` on either
  model refuses promotion (``:430-434``) — both versions must have live
  traffic in the window;
- promote only if ALL of:
    new_p95 <= old_p95 * (1 + tol_p95)        (``:440``)
    new_err <= old_err * (1 + tol_err)        (``:447``)
    new_avg <= old_avg * (1 + tol_avg)        (``:454``)

Hardening beyond the reference (opt-in via ``GateThresholds``, see SURVEY
§3.5(4)):

- ``min_sample_count``: refuse until both predictors served >= N requests in
  the window, so a 2-request fluke can't drive a promotion;
- ``error_rate_floor``: absolute slack so a zero-error baseline doesn't
  deadlock the relative check on the canary's first error.

Observability: alongside the boolean and the prose reasons, the decision
carries a signed **margin** per check (budget − observed) so the rollout
journal, ``status.lastGate``, and ``tpumlops_operator_gate_margin`` can
say *how far* a canary is from promoting, not just that it isn't.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Mapping

from ..clients.base import ModelMetrics
from ..utils.config import GateThresholds

_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class GateDecision:
    promote: bool
    reasons: tuple[str, ...] = ()
    # Which models had gating metrics missing (no traffic in the window):
    # any subset of {"new", "old"}.  Typed so consumers (warm-up targeting
    # in the reconciler) never parse the human-readable reason strings —
    # rewording a message must not change behavior.
    missing_on: frozenset[str] = frozenset()
    # Signed headroom per check, budget − observed (so >= 0 promotes and
    # exact boundary equality is margin 0.0): keys "latency_p95",
    # "error_rate", "latency_avg".  EMPTY — not zero — when the gate
    # refused before the budget comparisons ran (metrics missing or
    # below minSampleCount): an absent margin must never read as "right
    # at the boundary".  This is what the rollout journal, status
    # history, and tpumlops_operator_gate_margin{check} export instead
    # of leaving headroom derivable only from the prose reasons.
    margins: Mapping[str, float] = field(default_factory=dict)

    def __bool__(self) -> bool:
        return self.promote


def should_promote(
    new: ModelMetrics,
    old: ModelMetrics,
    thresholds: GateThresholds | None = None,
    logger: logging.Logger | logging.LoggerAdapter | None = None,
) -> GateDecision:
    """Return the gate decision with human-readable refusal reasons."""
    t = thresholds or GateThresholds()
    log = logger or _log
    reasons: list[str] = []

    # Availability check (reference :430-434): all three gating metrics must
    # be present on both models.  The reason names which model is missing
    # traffic so the reconciler can aim warm-up requests at that predictor.
    missing_on: set[str] = set()
    for who, m in (("new", new), ("old", old)):
        missing = [
            label
            for label, val in (
                ("latency_95th", m.latency_p95),
                ("error_rate", m.error_rate),
                ("latency_avg", m.latency_avg),
            )
            if val is None
        ]
        if missing:
            missing_on.add(who)
            reasons.append(
                f"metrics {', '.join(missing)} unavailable on {who} model "
                "(no traffic in window)"
            )
    if reasons:
        for r in reasons:
            log.warning(r)
        return GateDecision(False, tuple(reasons), frozenset(missing_on))

    # Hardening: minimum sample count before the gate may pass.
    if t.min_sample_count > 0:
        for who, m in (("new", new), ("old", old)):
            if m.request_count < t.min_sample_count:
                reasons.append(
                    f"{who} model has {m.request_count:.0f} samples "
                    f"< minSampleCount {t.min_sample_count}"
                )
        if reasons:
            for r in reasons:
                log.warning(r)
            return GateDecision(False, tuple(reasons))

    # Budgets per check; margin = budget − observed.  A negative margin
    # IS the refusal (margin < 0 ⇔ the reference's new > budget, so the
    # boundary stays inclusive: margin 0.0 promotes).
    err_budget = old.error_rate * (1 + t.error_rate)
    if t.error_rate_floor > 0:
        err_budget = max(err_budget, t.error_rate_floor)
    margins = {
        "latency_p95": old.latency_p95 * (1 + t.latency_p95) - new.latency_p95,
        "error_rate": err_budget - new.error_rate,
        "latency_avg": old.latency_avg * (1 + t.latency_avg) - new.latency_avg,
    }

    # p95 latency (reference :440-444)
    if margins["latency_p95"] < 0:
        reasons.append(
            f"p95 latency {new.latency_p95:.4f}s exceeds "
            f"{old.latency_p95:.4f}s * {1 + t.latency_p95:.2f}"
        )

    # error rate (reference :447-451), with optional absolute floor
    if margins["error_rate"] < 0:
        reasons.append(
            f"error rate {new.error_rate:.4f} exceeds budget {err_budget:.4f}"
        )

    # mean latency (reference :454-458)
    if margins["latency_avg"] < 0:
        reasons.append(
            f"mean latency {new.latency_avg:.4f}s exceeds "
            f"{old.latency_avg:.4f}s * {1 + t.latency_avg:.2f}"
        )

    if reasons:
        for r in reasons:
            log.warning(r)
        return GateDecision(False, tuple(reasons), margins=margins)
    log.info("promotion gate passed: canary within all thresholds")
    return GateDecision(True, margins=margins)
