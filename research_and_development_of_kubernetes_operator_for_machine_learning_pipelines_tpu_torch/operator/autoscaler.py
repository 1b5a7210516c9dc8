"""SLO-driven replica autoscaler: the topology half of the control plane.

The canary machinery adjusts *which version* gets traffic; until now the
operator never adjusted *how much capacity* serves it — every predictor
ran a fixed ``spec.cuda.replicas`` (default 1), so the engine-saturation
series the data plane exports (``tpumlops_engine_queue_depth``,
``tpumlops_admission_wait_ms``, ``tpumlops_ttft_seconds``) were observed
by nothing.  This module closes that loop, InferLine/λScale-style: per
``MlflowModel``, read the stable predictor's saturation signals, compute
a desired replica count against ``spec.autoscaling``, and apply it with
asymmetric hysteresis:

- **fast up** — once demand has persisted ``scaleUpStabilizationSeconds``
  (0 = immediately), jump straight to the desired count; queued users
  should not wait one cooldown per replica;
- **slow down** — step ONE replica at a time, and only after
  ``scaleDownCooldownSeconds`` since the last scale event in either
  direction, so a load dip never collapses capacity it will want back;
- **frozen during a canary** — the reconciler simply never evaluates the
  autoscaler while a rollout is in flight, so the promotion judge never
  compares versions across a topology change;
- **blind = hold** — missing metrics hold the current count; a
  Prometheus blackout must never read as "no load".

Everything here is a pure function of (spec, current state, observation,
wall time): the reconciler owns the I/O, status persistence (cooldown
and stabilization state round-trip through ``status.autoscaler`` so a
restarted operator keeps its pacing), and manifest application.  Every
decision that changes or withholds a change becomes a :class:`ScaleRecord`
in the PR-5 rollout journal (``status.history``, ``/debug/rollouts``,
``tpumlops_operator_autoscale_*``).

The data-plane half that makes scale-down safe — bounded admission with
429 shed and the lossless drain protocol — lives in ``server/app.py`` /
``server/generation.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Mapping

from .rollout_recorder import _iso

# Hold reasons (``ScaleRecord.hold`` / the ``reason`` label on
# ``tpumlops_operator_autoscale_holds``): why a wanted scale did not run.
HOLD_METRICS_MISSING = "metrics_missing"
HOLD_STABILIZATION = "stabilization"
HOLD_COOLDOWN = "cooldown"


@dataclass(frozen=True)
class ScaleRecord:
    """One autoscaler decision, with everything it observed.

    Journaled alongside :class:`~.rollout_recorder.GateRecord` /
    :class:`~.rollout_recorder.TransitionRecord` (``kind: "scale"``), so
    a replica staircase is reconstructable from ``status.history`` or
    ``GET /debug/rollouts`` alone.  ``hold`` is ``None`` when the scale
    was applied; otherwise the typed reason it was withheld."""

    wall: float  # unix epoch seconds at evaluation time
    from_replicas: int = 0
    to_replicas: int = 0
    desired: int = 0  # the un-hysteresis'd target this evaluation wanted
    reason: str = ""
    hold: str | None = None
    version: str | None = None  # predictor version observed
    # Disaggregated pool this record sizes ("prefill"/"decode"); None =
    # the whole-predictor count (and the key is OMITTED from as_dict, so
    # pre-fleet journal records stay byte-for-byte).
    pool: str | None = None
    observed: Mapping[str, Any] = field(default_factory=dict)
    targets: Mapping[str, Any] = field(default_factory=dict)

    @property
    def applied(self) -> bool:
        return self.hold is None and self.to_replicas != self.from_replicas

    @property
    def direction(self) -> str:
        if self.hold is not None or self.to_replicas == self.from_replicas:
            return "hold"
        return "up" if self.to_replicas > self.from_replicas else "down"

    def as_dict(self) -> dict[str, Any]:
        out = {
            "kind": "scale",
            "ts": self.wall,
            "time": _iso(self.wall),
            "from": self.from_replicas,
            "to": self.to_replicas,
            "desired": self.desired,
            "direction": self.direction,
            "hold": self.hold,
            "reason": self.reason,
            "version": self.version,
            "observed": dict(self.observed),
            "targets": dict(self.targets),
        }
        if self.pool is not None:
            out["pool"] = self.pool
        return out


@dataclass(frozen=True)
class ScalerState:
    """Hysteresis state, round-tripped through ``status.autoscaler``.

    Wall-clock (unix epoch) timestamps on purpose: this state survives
    operator restarts via CR status, and the injected reconcile Clock is
    monotonic in production — a persisted monotonic reading would reset
    to ~0 on every restart and break cooldown arithmetic (the same
    lesson the rollout journal learned in the tracing PR)."""

    last_scale_wall: float = 0.0  # last applied scale, either direction
    above_since_wall: float | None = None  # demand > current since (or None)

    def to_status(self) -> dict[str, Any]:
        out: dict[str, Any] = {"lastScaleTime": self.last_scale_wall}
        if self.above_since_wall is not None:
            out["scaleUpPendingSince"] = self.above_since_wall
        return out

    @classmethod
    def from_status(cls, status: Mapping[str, Any] | None) -> "ScalerState":
        if not status:
            return cls()
        above = status.get("scaleUpPendingSince")
        return cls(
            last_scale_wall=float(status.get("lastScaleTime") or 0.0),
            above_since_wall=float(above) if above is not None else None,
        )


@dataclass(frozen=True)
class ScaleDecision:
    """What to run now, plus the state and journal record to persist."""

    replicas: int
    state: ScalerState
    record: ScaleRecord | None = None  # None = nothing worth journaling


def clamp_replicas(value: int, spec) -> int:
    return max(spec.min_replicas, min(spec.max_replicas, int(value)))


def desired_replicas(spec, current: int, observed) -> tuple[int, str]:
    """The un-hysteresis'd replica target for one observation.

    Backlog — engine queue depth plus router-parked requests — is the
    primary signal (``ceil(total / target-per-replica)``); a TTFT p95
    above budget adds one replica on top even when the queue looks fine
    — latency pressure without a backlog is what long prompts under
    packed prefill look like.  Parked requests count at full weight: a
    parked request is a user waiting on a CR with no capacity AT ALL.
    Returns ``(desired, reason)`` with the reason naming the binding
    signal.
    """
    wanted = spec.min_replicas
    reason = "idle"
    qd_target = spec.target_queue_depth_per_replica
    parked = getattr(observed, "parked", None)
    backlog_known = observed.queue_depth is not None or parked is not None
    backlog = (observed.queue_depth or 0.0) + (parked or 0.0)
    if qd_target > 0 and backlog_known:
        by_queue = math.ceil(backlog / qd_target)
        if parked and by_queue < 1:
            by_queue = 1  # a parked request needs at least one replica
        if by_queue > wanted:
            wanted = by_queue
            if parked:
                reason = (
                    f"queue depth {backlog:g} ({parked:g} parked at the "
                    f"router) / target {qd_target:g} per replica"
                )
            else:
                reason = (
                    f"queue depth {backlog:g} / target "
                    f"{qd_target:g} per replica"
                )
    ttft_target = spec.target_ttft_seconds
    if (
        ttft_target > 0
        and observed.ttft_p95_s is not None
        and observed.ttft_p95_s > ttft_target
        and current + 1 > wanted
    ):
        wanted = current + 1
        reason = (
            f"ttft p95 {observed.ttft_p95_s:.3f}s > target "
            f"{ttft_target:g}s"
        )
    return clamp_replicas(wanted, spec), reason


def decide(
    spec,
    current: int,
    state: ScalerState,
    observed,
    now_wall: float,
) -> ScaleDecision:
    """One autoscaler evaluation (pure; the reconciler applies it).

    ``spec`` is a :class:`~..utils.config.AutoscalingSpec`, ``observed``
    an :class:`~..clients.base.EngineMetrics` or ``None`` (source has no
    engine-metrics capability / query failed entirely).
    """

    def rec(to: int, desired: int, reason: str, hold: str | None):
        return ScaleRecord(
            wall=now_wall,
            from_replicas=current,
            to_replicas=to,
            desired=desired,
            reason=reason,
            hold=hold,
            observed=observed.as_dict() if observed is not None else {},
            targets={
                "queueDepthPerReplica": spec.target_queue_depth_per_replica,
                "ttftSeconds": spec.target_ttft_seconds,
                "minReplicas": spec.min_replicas,
                "maxReplicas": spec.max_replicas,
            },
        )

    parked = getattr(observed, "parked", None) if observed is not None else None
    blind = observed is None or (
        observed.queue_depth is None
        and observed.ttft_p95_s is None
        and parked is None
    )
    if blind:
        # Hold at current strength; also stop any pending scale-up clock
        # — stale demand must re-prove itself once metrics return.
        new_state = replace(state, above_since_wall=None)
        return ScaleDecision(
            replicas=current,
            state=new_state,
            record=rec(
                current, current,
                "engine metrics unavailable", HOLD_METRICS_MISSING,
            ),
        )

    desired, why = desired_replicas(spec, current, observed)

    # Wake from zero: a parked/queued request is a user ALREADY waiting,
    # so the stabilization window does not apply — every second of
    # hysteresis is a second added to their cold start.  Jump straight
    # to the demand.
    if current == 0 and desired > 0:
        return ScaleDecision(
            replicas=desired,
            state=ScalerState(last_scale_wall=now_wall, above_since_wall=None),
            record=rec(desired, desired, f"wake from zero: {why}", None),
        )

    # Scale-DOWN needs positive evidence of idleness.  With a queue
    # target configured, that evidence is the queue gauge itself — a
    # healthy TTFT cannot stand in for it (TTFT samples only admitted
    # requests; under shed the backlog pressure is exactly what TTFT
    # doesn't see).  A TTFT-only config needs a present TTFT reading —
    # and since the rate-window quantile is also None at zero traffic,
    # such a config holds its count through full idle (configure the
    # queue target to shrink).  A partially-answering source may still
    # justify GROWING; under-observing never shrinks the fleet.
    if desired < current:
        if spec.target_queue_depth_per_replica > 0:
            down_evidence = observed.queue_depth is not None
        else:
            down_evidence = observed.ttft_p95_s is not None
        if not down_evidence:
            return ScaleDecision(
                replicas=current,
                state=replace(state, above_since_wall=None),
                record=rec(
                    current, desired,
                    "idle-evidence signal unavailable; holding scale-down",
                    HOLD_METRICS_MISSING,
                ),
            )
        if current == 1 and desired == 0 and parked is None:
            # The LAST step to zero additionally needs the park signal
            # wired (router /router/parked observable): without it the
            # wake path could never see a waiting request and the CR
            # would be unreachable-forever, which is worse than one idle
            # replica.
            return ScaleDecision(
                replicas=current,
                state=replace(state, above_since_wall=None),
                record=rec(
                    current, desired,
                    "park signal unavailable; holding scale-to-zero "
                    "(the wake path needs router parked-request "
                    "visibility)",
                    HOLD_METRICS_MISSING,
                ),
            )

    if desired > current:
        since = (
            state.above_since_wall
            if state.above_since_wall is not None
            else now_wall
        )
        pending = replace(state, above_since_wall=since)
        if now_wall - since < spec.scale_up_stabilization_s:
            return ScaleDecision(
                replicas=current,
                state=pending,
                record=rec(current, desired, why, HOLD_STABILIZATION),
            )
        # Fast up: jump straight to the stabilized demand.
        return ScaleDecision(
            replicas=desired,
            state=ScalerState(
                last_scale_wall=now_wall, above_since_wall=None
            ),
            record=rec(desired, desired, why, None),
        )

    # Demand at or below current: any pending scale-up is off.
    state = replace(state, above_since_wall=None)
    if desired < current:
        since_last = now_wall - state.last_scale_wall
        if since_last < spec.scale_down_cooldown_s:
            return ScaleDecision(
                replicas=current,
                state=state,
                record=rec(current, desired, why, HOLD_COOLDOWN),
            )
        # Slow down: one replica per cooldown window, never straight to
        # the floor — the load that justified the fleet usually comes
        # back faster than a replica boots.
        to = current - 1
        return ScaleDecision(
            replicas=to,
            state=ScalerState(last_scale_wall=now_wall),
            record=rec(to, desired, why, None),
        )

    return ScaleDecision(replicas=current, state=state, record=None)


# ---------------------------------------------------------------------------
# Disaggregated prefill/decode pools (spec.fleet) — each pool evaluated
# on ITS OWN saturation signal through the same decide() hysteresis:
#
#   prefill — admission wait p95 (queued prompts stalling before their
#             prefill begins is THE prefill-capacity signal; queue depth
#             conflates it with decode backlog);
#   decode  — the main autoscaling targets (queue depth / TTFT), which
#             at a decode pool measure token-streaming capacity.
#
# decide() reads only a duck-typed subset of AutoscalingSpec, so each
# pool gets a synthetic spec with its own band and targets — InferLine's
# "right-size each stage independently", without duplicating the
# cooldown/stabilization/blind-hold machinery.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _PoolSpec:
    """The duck-typed subset of AutoscalingSpec that decide() reads."""

    min_replicas: int
    max_replicas: int
    target_queue_depth_per_replica: float
    target_ttft_seconds: float
    scale_up_stabilization_s: float
    scale_down_cooldown_s: float


@dataclass(frozen=True)
class FleetDecision:
    """Per-pool counts + states + journal records for one evaluation."""

    prefill: ScaleDecision
    decode: ScaleDecision

    def to_status(
        self, prior: Mapping[str, Any] | None = None
    ) -> dict[str, Any]:
        out = dict(prior or {})
        out["prefillReplicas"] = self.prefill.replicas
        out["decodeReplicas"] = self.decode.replicas
        out["prefillScaler"] = self.prefill.state.to_status()
        out["decodeScaler"] = self.decode.state.to_status()
        return out


def fleet_counts(fleet_spec, status: Mapping[str, Any] | None) -> tuple[int, int]:
    """Current (prefill, decode) pool counts: status.fleet when the
    autoscaler has taken control, else the spec counts."""
    status = status or {}
    prefill = status.get("prefillReplicas")
    decode = status.get("decodeReplicas")
    return (
        int(prefill) if prefill is not None else fleet_spec.prefill_replicas,
        int(decode) if decode is not None else fleet_spec.decode_replicas,
    )


def decide_fleet(
    auto,
    fleet_spec,
    status: Mapping[str, Any] | None,
    observed_prefill,
    observed_decode,
    now_wall: float,
) -> FleetDecision:
    """One per-pool evaluation (pure; the reconciler applies it).

    ``observed_prefill``/``observed_decode`` are per-pool
    :class:`~..clients.base.EngineMetrics` (or None = blind, which
    decide() holds on).  The prefill pool's admission-wait signal is
    mapped onto decide()'s TTFT slot — same shape (a p95 latency above a
    budget adds one replica), different series.
    """
    status = status or {}
    cur_prefill, cur_decode = fleet_counts(fleet_spec, status)

    wait_target_s = fleet_spec.prefill_target_admission_wait_ms / 1000.0
    prefill_spec = _PoolSpec(
        min_replicas=fleet_spec.prefill_min_replicas,
        max_replicas=fleet_spec.prefill_max_replicas,
        target_queue_depth_per_replica=0.0,
        target_ttft_seconds=wait_target_s,
        scale_up_stabilization_s=auto.scale_up_stabilization_s,
        scale_down_cooldown_s=auto.scale_down_cooldown_s,
    )
    decode_backlog = (
        observed_decode.queue_depth
        if observed_decode is not None and observed_decode.queue_depth
        else 0.0
    )
    if wait_target_s <= 0 or not auto.enabled:
        # Pool fixed at its current count: no signal, no record.
        dp = ScaleDecision(
            replicas=cur_prefill,
            state=ScalerState.from_status(status.get("prefillScaler")),
        )
    elif cur_prefill == 0 and decode_backlog > 0:
        # Wake from zero: a prefill pool at zero exports NO admission-
        # wait series, so its own signal can never wake it — the decode
        # pool's backlog is the fleet's "users are waiting" evidence
        # (cold prompts are falling back to unified prefill on decode
        # chips right now).  Same no-stabilization contract as the
        # predictor-level wake.
        dp = ScaleDecision(
            replicas=max(1, fleet_spec.prefill_min_replicas),
            state=ScalerState(last_scale_wall=now_wall),
            record=ScaleRecord(
                wall=now_wall,
                from_replicas=0,
                to_replicas=max(1, fleet_spec.prefill_min_replicas),
                desired=max(1, fleet_spec.prefill_min_replicas),
                reason=(
                    f"wake from zero: decode backlog {decode_backlog:g} "
                    "(cold prompts falling back to unified prefill)"
                ),
                observed=(
                    observed_decode.as_dict()
                    if observed_decode is not None
                    else {}
                ),
            ),
        )
    else:
        wait = (
            observed_prefill.admission_wait_p95_ms
            if observed_prefill is not None
            else None
        )
        from ..clients.base import EngineMetrics

        # parked=0.0 rides along whenever the wait series answers:
        # decide()'s last-step-to-zero guard demands park visibility,
        # and for a POOL the wake signal is the decode backlog above —
        # observable exactly when the wait series is (live pods).
        mapped = EngineMetrics(
            ttft_p95_s=(wait / 1000.0) if wait is not None else None,
            parked=0.0 if wait is not None else None,
        )
        dp = decide(
            prefill_spec,
            cur_prefill,
            ScalerState.from_status(status.get("prefillScaler")),
            mapped,
            now_wall,
        )
    decode_spec = _PoolSpec(
        min_replicas=fleet_spec.decode_min_replicas,
        max_replicas=fleet_spec.decode_max_replicas,
        target_queue_depth_per_replica=auto.target_queue_depth_per_replica,
        target_ttft_seconds=auto.target_ttft_seconds,
        scale_up_stabilization_s=auto.scale_up_stabilization_s,
        scale_down_cooldown_s=auto.scale_down_cooldown_s,
    )
    if not auto.enabled:
        dd = ScaleDecision(
            replicas=cur_decode,
            state=ScalerState.from_status(status.get("decodeScaler")),
        )
    else:
        dd = decide(
            decode_spec,
            cur_decode,
            ScalerState.from_status(status.get("decodeScaler")),
            observed_decode,
            now_wall,
        )

    def tag(decision: ScaleDecision, pool: str) -> ScaleDecision:
        if decision.record is None:
            return decision
        return ScaleDecision(
            replicas=decision.replicas,
            state=decision.state,
            record=replace(decision.record, pool=pool),
        )

    return FleetDecision(prefill=tag(dp, "prefill"), decode=tag(dd, "decode"))
