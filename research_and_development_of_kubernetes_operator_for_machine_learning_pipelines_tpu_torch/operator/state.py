"""Serializable canary-promotion state.

The reference keeps promotion progress in local variables of a blocking
loop (``traffic_current``/``traffic_prev``/``attempt`` at
``mlflow_operator.py:184-191,:296-352``); an operator restart mid-promotion
freezes the traffic split forever (SURVEY §3.5(2)).  The rebuild makes the
entire promotion a value: ``PromotionState`` round-trips through the CR
status subresource, so any operator instance can pick up a rollout exactly
where it stopped.

Status keys keep the reference's names where they exist
(``currentModelVersion`` / ``previousModelVersion`` / ``error``,
``crd.yaml:26-37``) and add the promotion-progress fields the reference
never persisted.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Any, Mapping


class Phase(str, Enum):
    """Rollout lifecycle.

    IDLE        — no version deployed yet (fresh CR).
    STABLE      — one version at 100% traffic, monitoring the alias.
    CANARY      — two predictors live, traffic shifting under the gate.
    FAILED      — gate failed max_attempts times and rollback is disabled:
                  weights frozen at last split (reference behavior,
                  ``mlflow_operator.py:342-349``).
    ROLLED_BACK — gate failed and rollback restored 100% to the old version
                  (the reference's TODO at ``:345``, implemented).
    ERROR       — alias missing: deployment torn down, error recorded
                  (``:64-93``); self-heals when the alias reappears.
    """

    IDLE = "Idle"
    STABLE = "Stable"
    CANARY = "Canary"
    FAILED = "Failed"
    ROLLED_BACK = "RolledBack"
    ERROR = "Error"


@dataclass(frozen=True)
class PromotionState:
    phase: Phase = Phase.IDLE
    current_version: str | None = None
    previous_version: str | None = None
    traffic_current: int = 0  # % of traffic on current_version
    traffic_prev: int = 0  # % of traffic on previous_version
    attempt: int = 0  # consecutive gate failures at this traffic level
    held_version: str | None = None  # version blocked after FAILED/ROLLED_BACK
    error: str | None = None
    # Rollout journal surfaced on status when spec.observability.historyLimit
    # > 0 (see operator/rollout_recorder.py for the record shapes).  Both
    # default empty AND are omitted from to_status() when empty, so an
    # unannotated CR's status stays byte-for-byte what it always was.
    # ``last_gate`` is the compact block of the most recent gate
    # evaluation; ``history`` a bounded tuple of full gate/phase records.
    last_gate: Any = None
    history: tuple = ()
    # Replica autoscaling (spec.autoscaling, operator/autoscaler.py).
    # ``replicas`` is the autoscaler-controlled predictor replica count
    # (None = autoscaling off, spec.cuda.replicas rules — and both keys
    # are omitted from to_status(), keeping an unannotated CR's status
    # byte-for-byte).  ``scaler`` is the hysteresis state dict
    # (ScalerState.to_status()): wall-clock cooldown/stabilization
    # anchors that must survive operator restarts.
    replicas: int | None = None
    scaler: Any = None
    # Scale-to-zero park context (spec.cuda.snapshot + autoscaling
    # minReplicas: 0): while the CR's Deployment is parked at zero
    # replicas, status.snapshot records WHERE the pre-baked weight
    # snapshot lives so the wake path (and a human reading kubectl -o
    # yaml) knows the restore source.  None (and omitted from status)
    # whenever the CR holds capacity.
    snapshot: Any = None
    # Disaggregated prefill/decode pools (spec.fleet.disaggregation):
    # the per-pool replica counts + hysteresis state the fleet
    # autoscaler controls, e.g. {"prefillReplicas": 1,
    # "decodeReplicas": 3, "prefillScaler": {...}, "decodeScaler":
    # {...}}.  None (and omitted from status) when disaggregation is
    # off — an unannotated CR's status stays byte-for-byte.
    fleet: Any = None
    # Multi-model multiplexing (spec.multiplex, operator/multiplexer.py):
    # this CR's view of its shared pool, e.g. {"pool": "shared-a",
    # "weight": 2.0, "attachedReplicas": [...], "parked": 3}.  None (and
    # omitted from status) when the CR is not multiplexed.
    multiplex: Any = None
    # Fleet anomaly observatory (spec.anomaly, operator/anomaly.py): the
    # active verdict list from the last detection pass, e.g.
    # [{"replica": "m-2", "kind": "straggler", "series":
    # "router_leg_p99_ms", ...}].  None (and omitted from status) when
    # anomaly detection is off — an unannotated CR stays byte-for-byte.
    anomalies: Any = None

    # -- transitions (pure; each returns a new state) -----------------------

    def with_(self, **kw: Any) -> "PromotionState":
        return dataclasses.replace(self, **kw)

    def alias_missing(self, alias: str) -> "PromotionState":
        """Reference ``:64-93``: error status, versions cleared.

        The rollout journal survives every fresh-state transition (here,
        ``new_version``, ``rolled_back``): it is this CR's audit trail,
        not a property of one rollout."""
        return PromotionState(
            phase=Phase.ERROR,
            error=f"Alias '{alias}' does not exist",
            last_gate=self.last_gate,
            history=self.history,
            replicas=self.replicas,
            scaler=self.scaler,
            snapshot=self.snapshot,
            fleet=self.fleet,
            multiplex=self.multiplex,
            anomalies=self.anomalies,
        )

    def new_version(self, version: str, initial_traffic: int) -> "PromotionState":
        """A different version now carries the alias (reference ``:97-122``).

        With no prior version the new one takes 100% immediately
        (``:188-191``); otherwise start a canary at ``initial_traffic``
        (reference hardcodes 10, ``:187``).

        The canary's baseline is the version *currently carrying the majority
        of traffic* — not blindly ``current_version`` as in the reference
        (``:101``).  Mid-canary or after a FAILED freeze, ``current_version``
        is an unproven canary at minority traffic; using it as the baseline
        would hand ~90% of traffic to a version that never earned it and
        drop the proven stable version entirely.
        """
        if self.current_version is None or self.phase in (Phase.IDLE, Phase.ERROR):
            return PromotionState(
                phase=Phase.STABLE,
                current_version=version,
                previous_version=None,
                traffic_current=100,
                traffic_prev=0,
                last_gate=self.last_gate,
                history=self.history,
                replicas=self.replicas,
                scaler=self.scaler,
                snapshot=self.snapshot,
            fleet=self.fleet,
            multiplex=self.multiplex,
            anomalies=self.anomalies,
            )
        if (
            self.previous_version is not None
            and self.traffic_prev >= self.traffic_current
        ):
            baseline = self.previous_version
        else:
            baseline = self.current_version
        if version == baseline:
            # Alias moved back to the proven version (e.g. reverting a bad
            # release): no canary needed, it is already trusted.
            return PromotionState(
                phase=Phase.STABLE,
                current_version=version,
                previous_version=None,
                traffic_current=100,
                traffic_prev=0,
                last_gate=self.last_gate,
                history=self.history,
                replicas=self.replicas,
                scaler=self.scaler,
                snapshot=self.snapshot,
            fleet=self.fleet,
            multiplex=self.multiplex,
            anomalies=self.anomalies,
            )
        return PromotionState(
            phase=Phase.CANARY,
            current_version=version,
            previous_version=baseline,
            traffic_current=initial_traffic,
            traffic_prev=100 - initial_traffic,
            attempt=0,
            last_gate=self.last_gate,
            history=self.history,
            # The scaled topology rides into (and through) the rollout
            # FROZEN: the autoscaler never evaluates mid-canary, so both
            # predictors serve at the same replica count and the judge
            # compares like with like.
            replicas=self.replicas,
            scaler=self.scaler,
            snapshot=self.snapshot,
            fleet=self.fleet,
            multiplex=self.multiplex,
            anomalies=self.anomalies,
        )

    def promoted_step(self, step: int) -> "PromotionState":
        """Gate passed: shift ``step`` % to the canary (reference ``:311-327``)."""
        new_cur = min(self.traffic_current + step, 100)
        new_prev = max(self.traffic_prev - step, 0)
        if new_cur >= 100:
            return self.with_(
                phase=Phase.STABLE,
                traffic_current=100,
                traffic_prev=0,
                previous_version=None,
                attempt=0,
            )
        return self.with_(traffic_current=new_cur, traffic_prev=new_prev, attempt=0)

    def gate_failed(self) -> "PromotionState":
        return self.with_(attempt=self.attempt + 1)

    def halt_failed(self) -> "PromotionState":
        """Max attempts exhausted, rollback disabled: freeze (ref ``:342-349``)."""
        return self.with_(phase=Phase.FAILED, held_version=self.current_version)

    def rolled_back(self) -> "PromotionState":
        """Max attempts exhausted, rollback enabled: old version back to 100%."""
        return PromotionState(
            phase=Phase.ROLLED_BACK,
            current_version=self.previous_version,
            previous_version=None,
            traffic_current=100,
            traffic_prev=0,
            held_version=self.current_version,
            last_gate=self.last_gate,
            history=self.history,
            replicas=self.replicas,
            scaler=self.scaler,
            snapshot=self.snapshot,
            fleet=self.fleet,
            multiplex=self.multiplex,
            anomalies=self.anomalies,
        )

    # -- serialization ------------------------------------------------------

    def conditions(
        self,
        prior: list[dict] | None = None,
        now_iso: str = "",
    ) -> list[dict[str, Any]]:
        """Standard K8s status Conditions derived from the phase.

        The reference exposes none; these make ``kubectl wait
        --for=condition=Available`` and dashboard tooling work:

        - ``Available``   — a version is serving traffic (Stable, mid-
          Canary, rolled back onto the old version, or halted at a
          frozen split — Failed still serves 100% of traffic);
        - ``Progressing`` — a canary rollout is in flight;
        - ``Degraded``    — promotion failed / spec or alias error /
          serving the rolled-back version.

        ``lastTransitionTime`` only moves when a condition's status
        flips (K8s convention), which is why the caller passes the prior
        conditions back in.
        """
        available = (
            self.phase
            in (Phase.STABLE, Phase.CANARY, Phase.ROLLED_BACK, Phase.FAILED)
            and self.current_version is not None
        )
        degraded_reason = {
            Phase.FAILED: ("PromotionFailed", "Canary halted at max attempts."),
            Phase.ERROR: ("Error", self.error or "reconcile error"),
            Phase.ROLLED_BACK: (
                "RolledBack",
                f"Serving previous version {self.current_version}; "
                f"version {self.held_version} held.",
            ),
        }.get(self.phase)
        desired = [
            (
                "Available",
                available,
                "Serving" if available else "NoServingVersion",
                f"Version {self.current_version} at "
                f"{self.traffic_current}% traffic."
                if available
                else "No model version is serving.",
            ),
            (
                "Progressing",
                self.phase == Phase.CANARY,
                "CanaryRollout" if self.phase == Phase.CANARY else "Idle",
                f"Canary at {self.traffic_current}% "
                f"(attempt {self.attempt})."
                if self.phase == Phase.CANARY
                else "No rollout in flight.",
            ),
            (
                "Degraded",
                degraded_reason is not None,
                degraded_reason[0] if degraded_reason else "Healthy",
                degraded_reason[1] if degraded_reason else "",
            ),
        ]
        prior_map = {c.get("type"): c for c in (prior or [])}
        out = []
        for ctype, truth, reason, message in desired:
            status = "True" if truth else "False"
            prev = prior_map.get(ctype)
            ltt = (
                prev.get("lastTransitionTime")
                if prev is not None and prev.get("status") == status
                else now_iso
            )
            out.append(
                {
                    "type": ctype,
                    "status": status,
                    "reason": reason,
                    "message": message,
                    "lastTransitionTime": ltt,
                }
            )
        return out

    def to_status(self) -> dict[str, Any]:
        status = {
            "phase": self.phase.value,
            "currentModelVersion": self.current_version,
            "previousModelVersion": self.previous_version,
            "trafficCurrent": self.traffic_current,
            "trafficPrev": self.traffic_prev,
            "attempt": self.attempt,
            "heldVersion": self.held_version,
            "error": self.error,
        }
        # Omitted — not null — when empty: historyLimit 0 (the default)
        # must keep status patches byte-identical to pre-journal behavior.
        if self.last_gate is not None:
            status["lastGate"] = self.last_gate
        if self.history:
            status["history"] = list(self.history)
        # Same contract for the autoscaler keys: absent unless autoscaling
        # has taken control of the replica count.
        if self.replicas is not None:
            status["replicas"] = self.replicas
        if self.scaler is not None:
            status["autoscaler"] = dict(self.scaler)
        if self.snapshot is not None:
            status["snapshot"] = dict(self.snapshot)
        if self.fleet is not None:
            status["fleet"] = dict(self.fleet)
        if self.multiplex is not None:
            status["multiplex"] = dict(self.multiplex)
        if self.anomalies is not None:
            status["anomalies"] = list(self.anomalies)
        return status

    @classmethod
    def from_status(cls, status: Mapping[str, Any] | None) -> "PromotionState":
        if not status:
            return cls()
        phase_raw = status.get("phase")
        current = status.get("currentModelVersion")
        try:
            if phase_raw is not None:
                Phase(phase_raw)
        except ValueError:
            # Unknown phase string (written by a newer/older operator):
            # fall through to reference-status adoption below.
            phase_raw = None
        if phase_raw is None:
            # Status written by the reference operator (versions only,
            # crd.yaml:26-37): infer a stable single-version deployment so
            # the rebuild can adopt in-place.
            phase = Phase.STABLE if current else Phase.IDLE
            return cls(
                phase=phase,
                current_version=current,
                previous_version=status.get("previousModelVersion"),
                traffic_current=100 if current else 0,
                error=status.get("error"),
            )
        return cls(
            phase=Phase(phase_raw),
            current_version=current,
            previous_version=status.get("previousModelVersion"),
            traffic_current=int(status.get("trafficCurrent") or 0),
            traffic_prev=int(status.get("trafficPrev") or 0),
            attempt=int(status.get("attempt") or 0),
            held_version=status.get("heldVersion"),
            error=status.get("error"),
            last_gate=status.get("lastGate"),
            history=tuple(status.get("history") or ()),
            replicas=(
                int(status["replicas"])
                if status.get("replicas") is not None
                else None
            ),
            scaler=status.get("autoscaler"),
            snapshot=status.get("snapshot"),
            fleet=status.get("fleet"),
            multiplex=status.get("multiplex"),
            anomalies=(
                list(status["anomalies"])
                if status.get("anomalies") is not None
                else None
            ),
        )
