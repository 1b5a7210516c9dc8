"""Level-triggered reconciler for ``MlflowModel`` resources (the port's
copy of the JAX package's ``operator/reconciler.py``, on ``backend:
cuda`` where that one has ``tpu``).

The reference's handler is a ``while True`` loop that never returns
(``mlflow_operator.py:56``), blocks the whole event loop with synchronous
network calls, spawns a duplicate loop on every CR edit, and holds promotion
progress in local variables (SURVEY §3.5(1-3)).  The rebuild inverts that:
``Reconciler.reconcile`` is a *single step* — read the world, compute the
next state, apply it, persist it to status, and tell the runtime when to
call back.  Crash/restart at any point resumes from status.

One step performs at most one state transition, so each call is short and
the runtime can interleave many resources on one thread.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any

from ..clients.base import (
    AliasNotFound,
    ApiError,
    Conflict,
    Event,
    KubeClient,
    MetricsSource,
    ModelVersion,
    NotFound,
    ObjectRef,
    RegistryClient,
    RegistryError,
    MLFLOWMODEL,
    SELDONDEPLOYMENT,
)
from ..utils.clock import Clock, SystemClock
from ..utils.config import (
    GPU_HBM_GIB_PER_CARD,
    GPU_TOPOLOGIES,
    OperatorConfig,
)
from ..utils.logging import model_logger
from .builder import build_deployment
from .judge import should_promote
from .rollout_recorder import CrashLoopRecord, GateRecord, TransitionRecord
from .state import Phase, PromotionState
from .uri import artifact_uri

# One structured JSON decision line per gate evaluation (the control
# plane's analogue of the server's ``tpumlops.request`` completion line):
# CR identity + decision + margins, machine-parseable in both log modes.
_gate_log = logging.getLogger("tpumlops.gate")


def _capacity_summary(config: OperatorConfig) -> "dict | None":
    """``status.capacity``: what the operator scheduled, in device terms
    — topology, cards, HBM — so the CR itself answers "how much hardware
    does this model hold" (the server's ledger answers how it is spent).
    None unless ``spec.cuda.observability.deviceTelemetry`` on a ``cuda``
    backend: the disabled status patch stays byte-for-byte.  The keys are
    the JAX package's status schema (a card counts as a chip)."""
    if config.backend != "cuda" or not config.cuda.observability.device_telemetry:
        return None
    info = GPU_TOPOLOGIES.get(config.cuda.topology)
    if info is None:
        return None
    hbm_per_card = GPU_HBM_GIB_PER_CARD.get(info.product)
    out = {
        "topology": config.cuda.topology,
        "chips": info.cards,
        "hosts": info.hosts,
        "meshShape": dict(config.cuda.mesh_shape),
        # The tp axis pulled out of the mesh for dashboards/selectors:
        # > 1 means one replica spans tensorParallel cards and the HBM
        # numbers below divide across them.
        "tensorParallel": int(dict(config.cuda.mesh_shape).get("tp", 1)),
        "quantize": config.cuda.quantize,
        "deviceTelemetry": True,
    }
    if hbm_per_card is not None:
        out["hbmGiBPerChip"] = hbm_per_card
        out["hbmGiBTotal"] = hbm_per_card * info.cards
    return out


class _OpTimer:
    """Context manager accumulating wall seconds into ``sink[component]``."""

    __slots__ = ("_sink", "_component", "_t0")

    def __init__(self, sink: dict, component: str):
        self._sink = sink
        self._component = component

    def __enter__(self):
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        self._sink[self._component] = self._sink.get(self._component, 0.0) + (
            time.perf_counter() - self._t0
        )
        return False


@dataclass
class ReconcileOutcome:
    state: PromotionState
    requeue_after: float  # seconds until the runtime should reconcile again
    events: list[Event] = field(default_factory=list)
    applied: bool = False  # whether a deployment manifest was written
    # Seconds per operation class within this step (status_patch,
    # manifest_apply, gate_read, registry) — the overhead breakdown the
    # time-to-100% bench and operator telemetry report.
    timings: dict = field(default_factory=dict)
    # The step's GateRecord when this step evaluated the promotion gate
    # (None otherwise); OperatorTelemetry reads it for the
    # tpumlops_operator_gate_* series.
    gate: Any = None
    # The step's ScaleRecord when this step evaluated the autoscaler
    # (None otherwise — including every step with autoscaling disabled);
    # OperatorTelemetry reads it for tpumlops_operator_autoscale_*.
    scale: Any = None
    # {slo_name: SloEval} when spec.slo is configured (None otherwise);
    # OperatorTelemetry reads it for the tpumlops_operator_slo_* gauges.
    slo: Any = None
    # The step's MuxRecords when this CR is multiplexed (None otherwise);
    # OperatorTelemetry reads them for tpumlops_operator_mux_*.
    mux: Any = None
    # The step's AnomalyRecords when this step journaled a verdict-set
    # transition (None otherwise — including every step with
    # spec.anomaly absent); OperatorTelemetry reads them for
    # tpumlops_operator_anomaly_*.
    anomaly: Any = None


class Reconciler:
    """Reconciles one ``MlflowModel`` resource.

    All collaborators are injected protocols (SURVEY §4's fake seams):
    ``kube`` (API server), ``registry`` (MLflow), ``metrics`` (Prometheus),
    ``clock`` (pacing).
    """

    def __init__(
        self,
        name: str,
        namespace: str,
        kube: KubeClient,
        registry: RegistryClient,
        metrics: MetricsSource | None = None,
        clock: Clock | None = None,
        logger: logging.Logger | logging.LoggerAdapter | None = None,
        metrics_factory=None,  # Callable[[str], MetricsSource]; honors spec.prometheusUrl
        warmup=None,  # Callable[(deployment, predictor, namespace, n)]; synthetic traffic
        recorder=None,  # RolloutRecorder | None; per-CR gate/phase journal
        wall=None,  # Callable[[], float]; unix-epoch seconds (tests inject)
        mux_pools=None,  # Mapping[str, multiplexer.Multiplexer] | None
        ring_sources=None,  # Callable[[], dict] | None; fleet ring snapshots
    ):
        self.name = name
        self.namespace = namespace
        self.kube = kube
        self.registry = registry
        self.metrics = metrics
        self.metrics_factory = metrics_factory
        self.warmup = warmup
        self.clock = clock or SystemClock()
        self.log = logger or model_logger(name, namespace)
        if metrics is None and metrics_factory is None:
            raise ValueError("either metrics or metrics_factory is required")
        # (model, version) -> registry source URI.  An MLflow version's
        # source is immutable once registered, so resolve each version once
        # — the reference does the same (resolves at version-change time,
        # ``mlflow_operator.py:125-135``); without this every canary step
        # pays up to two registry round-trips re-resolving both versions.
        # The cache holds the raw source, NOT the final artifact URI:
        # spec.artifactRoot is mutable, so rooting must happen per call.
        # Freshness: alias resolutions overwrite the current version's
        # entry, and AliasNotFound clears the cache (a deleted/re-created
        # registered model restarts version numbering with new sources).
        self._source_cache: dict[tuple[str, str], str] = {}
        self._timings: dict[str, float] = {}
        self.recorder = recorder
        # Gate/phase records produced by the current step, flushed to the
        # recorder (with the step's full op-timer breakdown) in reconcile().
        self._pending_records: list = []
        # Stuck-canary event rate limiter: the (traffic, reasons) of the
        # last PromotionHold Warning actually emitted, and how many
        # identical refusals have been suppressed since.
        self._last_hold: tuple | None = None
        self._hold_suppressed = 0
        # Autoscaler wiring.  ``wall`` is unix-epoch time (NOT the
        # injected Clock, which is monotonic in production): cooldown /
        # stabilization anchors persist in CR status across operator
        # restarts, where a monotonic reading would reset to ~0.
        self._wall = wall or time.time
        # Journal rate limiter for autoscaler holds: the (hold, desired,
        # current) shape of the last hold record journaled — an
        # unchanged "cooldown" hold must not append one record per poll.
        self._last_scale_hold: tuple | None = None
        # The step's ScaleRecord (telemetry feed), set by _autoscale_step.
        self._scale_record = None
        # SLO error-budget accounting (operator/slo.py): rolling sample
        # windows live in operator memory (a restart restarts the
        # window), budget-state transitions journal beside gate/scale
        # records, and the latest evals feed tpumlops_operator_slo_*.
        self._slo_tracker = None
        self._slo_last_state: dict = {}
        self._slo_evals = None
        # The step's engine-metrics reading, stashed by _autoscale_step
        # so _slo_step reuses it instead of issuing a second identical
        # fetch (False = no fetch ran this step; None = fetched blind).
        self._step_engine_obs: object = False
        # Offline SLO planner (operator/planner.py): plans are pure
        # functions of (spec.planner, topology, trace), so each is
        # computed once and cached until the spec or trace file changes
        # — a reconcile poll must not re-run the grid search.
        self._plan_cache: dict = {}
        # Shared-pool multiplexers (operator/multiplexer.py), keyed by
        # spec.multiplex.poolRef and SHARED across every member CR's
        # reconciler — the runtime (or a test harness) owns the mapping.
        # None/missing pool = this CR surfaces status only; the pump,
        # journal drain, and mux events all no-op.
        self.mux_pools = mux_pools
        # Fleet anomaly observatory (spec.anomaly, operator/anomaly.py).
        # ``ring_sources`` is a zero-arg callable returning
        # ``{"replicas": {name: server-ring snapshot}, "router":
        # router-ring snapshot | None}`` — the reconciler never does its
        # own HTTP; the runtime (or a test) owns the fetching.  The
        # verdict-set shape of the last journaled transition dedupes the
        # journal/event stream exactly like the PromotionHold limiter;
        # None = unknown (rebuilt from status.anomalies on the first
        # step, so an operator restart doesn't re-announce a standing
        # verdict).
        self.ring_sources = ring_sources
        self._anomaly_last_shape: "frozenset | None" = None
        self._anomaly_records = None
        # Replicas currently under a straggler verdict — read by the
        # multiplexer pump (straggler = last-choice attach target).
        # None = unknown until the first step reads status back.
        self._stragglers: "frozenset | None" = None

    def _metrics_source(self, config: OperatorConfig) -> MetricsSource:
        """Fixed source (tests) or per-CR source from spec.prometheusUrl."""
        if self.metrics is not None:
            return self.metrics
        return self.metrics_factory(config.prometheus_url)

    # -- object refs --------------------------------------------------------

    @property
    def cr_ref(self) -> ObjectRef:
        return ObjectRef(namespace=self.namespace, name=self.name, **MLFLOWMODEL)

    @property
    def deployment_ref(self) -> ObjectRef:
        return ObjectRef(namespace=self.namespace, name=self.name, **SELDONDEPLOYMENT)

    # -- main entry ----------------------------------------------------------

    def _op_timer(self, component: str):
        """Accumulate wall time of one operation class into the step's
        timing breakdown (read back through ReconcileOutcome.timings)."""
        return _OpTimer(self._timings, component)

    def reconcile(self, obj: dict) -> ReconcileOutcome:
        """One reconcile step for the given CR object (spec+status+metadata)."""
        self._timings = {}
        self._pending_records = []
        self._scale_record = None
        self._mux_records = None
        self._anomaly_records = None
        self._step_engine_obs = False
        # Reset per step: an early-returning _slo_step (spec didn't
        # parse, nothing serving) must export NO evals, not re-export
        # the previous step's numbers as if live accounting ran.
        self._slo_evals = None
        # Per-CR log identity: metadata.generation on every line of this
        # step (the control-plane analogue of the server's request_id).
        if hasattr(self.log, "set_generation"):
            self.log.set_generation(
                (obj.get("metadata") or {}).get("generation")
            )
        outcome = self._reconcile_inner(obj)
        # Capacity-summary sync runs on EVERY path (ERROR-parked and
        # held CRs included — the journal keys have per-branch shedding,
        # capacity is cheaper to sync centrally): one patch when the
        # spec-derived summary differs from what status carries.
        self._sync_capacity_status(outcome.state)
        # Planner-output sync mirrors it: status.plan appears/refreshes/
        # clears with one patch when the computed plan differs from what
        # status carries; a disabled planner on a CR that never had the
        # key patches nothing (byte-for-byte).
        self._sync_plan_status(outcome.state)
        # Replica-churn audit runs centrally too (every path, ERROR-
        # parked CRs included): restart counts are observation, not
        # rollout logic, and must keep flowing while a canary is stuck.
        outcome.state = self._sync_restart_audit(outcome.state)
        # SLO accounting is observation too: it samples every step —
        # canary steps included (an SLO breach DURING a rollout is
        # exactly what the journal must be able to show).
        outcome.state = self._slo_step(outcome.state, outcome.events)
        outcome.slo = self._slo_evals
        # Anomaly detection is fleet observation on the same footing:
        # every path, stuck canaries included — a straggler mid-rollout
        # is precisely what the observatory exists to catch.
        outcome.state = self._anomaly_step(outcome.state, outcome.events)
        outcome.anomaly = self._anomaly_records
        outcome.timings = self._timings
        outcome.scale = self._scale_record
        outcome.mux = self._mux_records
        # Flush the step's journal records.  Gate records get the step's
        # COMPLETE op-timer breakdown here (the status.history copy was
        # written mid-step, before its own status_patch could be timed).
        for rec in self._pending_records:
            if isinstance(rec, GateRecord):
                rec = dataclasses.replace(rec, timings=dict(self._timings))
                outcome.gate = rec
            if self.recorder is not None:
                self.recorder.record(self.namespace, self.name, rec)
        return outcome

    def _reconcile_inner(self, obj: dict) -> ReconcileOutcome:
        # Prior conditions feed lastTransitionTime stability (state.py).
        self._prior_conditions = (obj.get("status") or {}).get("conditions")
        prior_status = obj.get("status") or {}
        self._had_journal_keys = bool(
            prior_status.get("lastGate") or prior_status.get("history")
        )
        # Same explicit-null contract for the autoscaler keys: a CR whose
        # autoscaling was just disabled needs one patch clearing them.
        self._had_scaler_keys = (
            prior_status.get("replicas") is not None
            or prior_status.get("autoscaler") is not None
        )
        # Scale-to-zero park context: same explicit-null contract — a CR
        # waking from zero needs one patch clearing status.snapshot.
        self._had_snapshot_key = prior_status.get("snapshot") is not None
        # Disaggregated-fleet pool counts: same explicit-null contract.
        self._had_fleet_key = prior_status.get("fleet") is not None
        # Multiplexed-pool view: same explicit-null contract.
        self._had_multiplex_key = prior_status.get("multiplex") is not None
        # Anomaly verdicts: same explicit-null contract; the straggler
        # set and journal-dedupe shape also rebuild from status here so
        # an operator restart neither re-announces a standing verdict
        # nor forgets which replicas the multiplexer should avoid.
        self._had_anomalies_key = prior_status.get("anomalies") is not None
        if self._stragglers is None:
            prior_anoms = prior_status.get("anomalies") or ()
            self._stragglers = frozenset(
                a.get("replica")
                for a in prior_anoms
                if isinstance(a, dict) and a.get("kind") == "straggler"
            )
            if self._anomaly_last_shape is None:
                self._anomaly_last_shape = frozenset(
                    (
                        a.get("replica"),
                        a.get("kind"),
                        a.get("series"),
                        a.get("direction"),
                    )
                    for a in prior_anoms
                    if isinstance(a, dict)
                )
        # Device-telemetry capacity summary: recomputed from spec each
        # step (no state round-trip needed); the explicit-null contract
        # mirrors the journal/scaler keys so disabling clears it once.
        self._had_capacity_key = prior_status.get("capacity") is not None
        self._prior_capacity = prior_status.get("capacity")
        self._capacity_status = None
        # Unknown until the spec parses: a config-error step must leave
        # status.capacity untouched (neither refreshed nor nulled) — the
        # summary still reflects the last VALID spec, and a transient
        # typo in an unrelated field must not wipe it.
        self._capacity_known = False
        # Replica-churn audit: container restart counts across
        # this CR's pods surface as ``status.restarts`` when the rollout
        # journal is enabled.  Same explicit-null contract; same
        # config-error caution (an unparseable spec leaves the key
        # untouched).
        self._had_restarts_key = prior_status.get("restarts") is not None
        self._prior_restarts = prior_status.get("restarts")
        self._restarts_status = None
        self._restarts_known = False
        self._audit_config = None
        # Offline planner output (status.plan): same explicit-null
        # contract as capacity, and the same config-error caution — an
        # unparseable spec leaves the key untouched.
        self._had_plan_key = prior_status.get("plan") is not None
        self._prior_plan = prior_status.get("plan")
        self._plan_status = None
        self._plan_known = False
        state = PromotionState.from_status(obj.get("status"))
        events: list[Event] = []
        try:
            config = OperatorConfig.from_spec(obj.get("spec") or {})
        except ValueError as e:
            return self._on_config_error(state, str(e), events)
        # Offline SLO planner: compute/refresh the costed plan before
        # the capacity summary so applyMode: apply's knob substitution
        # is what capacity (and every manifest below) describes.  A
        # planner failure — unreadable/drifted trace, infeasible
        # objective — is a spec problem and surfaces exactly like one.
        try:
            config, state = self._planner_step(config, state)
        except ValueError as e:
            return self._on_config_error(state, f"planner: {e}", events)
        self._capacity_status = _capacity_summary(config)
        self._capacity_known = True
        self._audit_config = config

        # 1. Resolve alias -> version (reference :57-62).
        try:
            with self._op_timer("registry"):
                mv = self.registry.get_version_by_alias(
                    config.model_name, config.model_alias
                )
        except AliasNotFound:
            # A vanished alias often means the registered model was deleted;
            # if it is re-created, version numbers restart at 1 with new
            # sources — cached sources for the old incarnation would serve
            # stale artifacts, so drop them.
            self._source_cache.clear()
            return self._on_alias_missing(obj, config, state, events)
        except RegistryError as e:
            # Transport error: unlike the reference (which tears the
            # deployment down on *any* registry exception, :61-93), keep the
            # last-known-good data plane and retry.
            self.log.warning(f"registry unreachable, keeping current state: {e}")
            return ReconcileOutcome(state, config.monitoring_interval_s, events)
        # Upsert the freshly resolved source unconditionally: if the
        # registered model was deleted and re-created between reconciles
        # (version numbers restart with new sources), the alias resolution
        # in hand is the truth and any cached entry for this version is
        # stale.
        self._source_cache[(config.model_name, mv.version)] = mv.source

        # 2. Blocked version (post-rollback hold): don't redeploy a version
        #    that just failed its SLOs until the alias moves on.
        if (
            state.held_version is not None
            and mv.version == state.held_version
            and state.phase in (Phase.FAILED, Phase.ROLLED_BACK)
        ):
            self._ensure_deployment(obj, config, state)
            state = self._shed_disabled_journal(config, state)
            state = self._autoscale_step(obj, config, state, events)
            state = self._fleet_step(obj, config, state, events)
            state = self._multiplex_step(obj, config, state, events)
            return ReconcileOutcome(state, config.monitoring_interval_s, events)

        # 3. New version detected (reference :97-149).
        if mv.version != state.current_version:
            return self._on_new_version(obj, config, state, mv, events)

        # 4. Canary in progress: one gate evaluation (reference :296-352).
        if state.phase == Phase.CANARY:
            return self._on_canary_step(obj, config, state, events)

        # 5. Steady state: self-heal the deployment if it vanished, keep
        #    monitoring the alias, and size the topology to the load.
        #    The autoscaler runs ONLY here (and on the held-version
        #    branch above) — never mid-CANARY, so the promotion judge
        #    never compares versions across a topology change.
        if state.phase in (Phase.STABLE, Phase.FAILED, Phase.ROLLED_BACK):
            self._ensure_deployment(obj, config, state)
            state = self._shed_disabled_journal(config, state)
            state = self._autoscale_step(obj, config, state, events)
            state = self._fleet_step(obj, config, state, events)
            state = self._multiplex_step(obj, config, state, events)
        return ReconcileOutcome(state, config.monitoring_interval_s, events)

    def _planner_step(
        self, config: OperatorConfig, state: PromotionState
    ) -> "tuple[OperatorConfig, PromotionState]":
        """Offline SLO planner (operator/planner.py): compute the costed
        plan behind ``spec.planner``, journal a ``PlanRecord`` when it
        changes, and — under ``applyMode: apply`` — return the config
        with the chosen knobs substituted so everything downstream
        (capacity summary, manifests) describes the planned fleet.
        ``suggest`` (the default) changes NOTHING but ``status.plan``."""
        if not config.planner.enabled:
            self._plan_status = None
            self._plan_known = True
            return config, state
        from . import planner as planner_mod

        # Cache key: the planner inputs.  tracePath contributes its
        # mtime so replacing the export file on disk re-plans without a
        # spec edit.
        key_src: dict = {
            "planner": dataclasses.asdict(config.planner),
            "topology": config.cuda.topology,
        }
        if config.planner.trace_path:
            try:
                key_src["traceMtime"] = os.stat(
                    config.planner.trace_path
                ).st_mtime_ns
            except OSError:
                pass  # load_journey_trace will raise the typed error
        key = json.dumps(key_src, sort_keys=True, default=str)
        plan_dict = self._plan_cache.get(key)
        if plan_dict is None:
            with self._op_timer("planner"):
                plan_dict = planner_mod.plan_for_config(config)
            self._plan_cache.clear()  # one live plan per CR
            self._plan_cache[key] = plan_dict
        self._plan_status = plan_dict
        self._plan_known = True
        if plan_dict != getattr(self, "_prior_plan", None):
            rec = planner_mod.PlanRecord(
                ts=self.clock.now(),
                wall=time.time(),
                apply_mode=config.planner.apply_mode,
                objective=dict(plan_dict.get("objective", {})),
                knobs=dict(plan_dict.get("knobs", {})),
                predicted=dict(plan_dict.get("predicted", {})),
            )
            state = self._journal(config, state, rec)
        if config.planner.apply_mode == "apply":
            config = planner_mod.apply_plan(config, plan_dict)
        return config, state

    def _sync_plan_status(self, state: PromotionState) -> None:
        """Quiescent-CR plan sync, mirroring the capacity sync: one
        patch when the computed plan differs from what status carries
        (including the clearing null when the planner was disabled)."""
        if not getattr(self, "_plan_known", False):
            return  # config never parsed this step: leave status alone
        plan_dict = self._plan_status
        prior = getattr(self, "_prior_plan", None)
        if plan_dict == prior:
            return
        if plan_dict is None and not getattr(self, "_had_plan_key", False):
            return
        self._patch_status(state)

    def _sync_capacity_status(self, state: PromotionState) -> None:
        """Quiescent-CR capacity sync: transitions carry the key on their
        own patches, but a STABLE CR whose deviceTelemetry was just
        toggled (or whose topology spec changed) would otherwise never
        see status.capacity appear/refresh/clear — one patch, then
        steady state is patch-free again."""
        if not getattr(self, "_capacity_known", False):
            return  # config never parsed this step: leave status alone
        cap = self._capacity_status
        prior = getattr(self, "_prior_capacity", None)
        if cap == prior:
            return
        if cap is None and not getattr(self, "_had_capacity_key", False):
            return
        self._patch_status(state)

    # -- replica-churn audit (restart counts -> status.restarts) -------------

    @property
    def pods_ref(self) -> ObjectRef:
        return ObjectRef(
            namespace=self.namespace, name="", group="", version="v1",
            plural="pods",
        )

    def _collect_restarts(self) -> dict | None:
        """Summed container restart counts for this CR's pods (matched by
        the builder's ``tpumlops/deployment`` label), as the
        ``status.restarts`` block: ``{"total": N, "pods": {name: n}}``
        with zero-restart pods omitted (steady state stays compact and a
        fresh fleet reads ``{"total": 0, "pods": {}}``).  None = the pod
        listing failed (RBAC, API hiccup) — leave status untouched
        rather than publishing a fake zero."""
        try:
            pods = self.kube.list(self.pods_ref)
        except Exception as e:  # NotFound / ApiError / transport
            self.log.warning(f"pod listing for restart audit failed: {e}")
            return None
        total = 0
        per_pod: dict[str, int] = {}
        reasons: list[str] = []
        for pod in pods:
            meta = pod.get("metadata") or {}
            if (meta.get("labels") or {}).get(
                "tpumlops/deployment"
            ) != self.name:
                continue
            n = 0
            for cs in (pod.get("status") or {}).get(
                "containerStatuses"
            ) or []:
                n += int(cs.get("restartCount") or 0)
                term = (cs.get("lastState") or {}).get("terminated") or {}
                if term.get("reason"):
                    reasons.append(str(term["reason"]))
            if n > 0:
                per_pod[meta.get("name", "")] = n
            total += n
        return {
            "total": total,
            "pods": dict(sorted(per_pod.items())),
            **({"lastReason": reasons[-1]} if reasons else {}),
        }

    def _sync_restart_audit(self, state: PromotionState) -> PromotionState:
        """Surface replica churn next to the gate decisions.

        Gated on ``spec.observability.historyLimit`` (the journal knob):
        at the default 0 no pods are listed and every status patch is
        byte-for-byte what it was.  When the summed restart count GROWS,
        a ``ReplicaCrashLoop`` Warning fires (deduped: an unchanged
        total never re-fires, across operator restarts too — the prior
        total is read back from status) and a ``crashloop`` record joins
        ``status.history``."""
        config = self._audit_config
        if config is None:
            # The spec didn't parse this step: like the capacity summary,
            # neither refresh nor clear — the block reflects the last
            # VALID spec, and wiping it would reset the crash-loop dedupe
            # baseline (a re-fired ReplicaCrashLoop for churn already
            # announced once the typo is fixed).
            return state
        if config.observability.history_limit <= 0:
            if getattr(self, "_had_restarts_key", False):
                # Journal disabled with the key lingering: one explicit-
                # null patch clears it, then steady state is patch-free.
                self._restarts_known = True
                self._restarts_status = None
                self._patch_status(state)
            return state
        with self._op_timer("restart_audit"):
            rs = self._collect_restarts()
        if rs is None:
            return state  # listing failed: neither refresh nor null
        self._restarts_known = True
        self._restarts_status = rs
        prior = self._prior_restarts if isinstance(
            self._prior_restarts, dict
        ) else None
        prior_total = int((prior or {}).get("total") or 0)
        if rs["total"] > prior_total:
            prior_pods = (prior or {}).get("pods") or {}
            grown = tuple(
                (pod, n)
                for pod, n in rs["pods"].items()
                if n > int(prior_pods.get(pod) or 0)
            )
            ev = Event(
                "Warning",
                "ReplicaCrashLoop",
                f"Replica restarts {prior_total} -> {rs['total']} "
                + ", ".join(f"{pod} x{n}" for pod, n in grown)
                + (
                    f" (last: {rs['lastReason']})"
                    if rs.get("lastReason")
                    else ""
                ),
            )
            self.kube.emit_event(self.cr_ref, ev)
            rec = CrashLoopRecord(
                wall=self._wall(),
                total=int(rs["total"]),
                prior_total=prior_total,
                pods=grown,
                reason=str(rs.get("lastReason") or ""),
            )
            state = self._journal(config, state, rec)
            self._patch_status(state)
        elif rs != prior:
            # Count shrank (pod replaced) or details shifted: refresh the
            # block quietly — churn DOWN is not an alert.
            self._patch_status(state)
        return state

    def _engine_fetch(self, fetch, predictor: str, window_s, slo_tails: bool):
        """engine_metrics with the ``slo_tails`` hint, falling back to
        the 4-argument shape for duck-typed sources that predate it."""
        try:
            return fetch(
                self.name, predictor, self.namespace, window_s,
                slo_tails=slo_tails,
            )
        except TypeError:
            return fetch(self.name, predictor, self.namespace, window_s)

    def _slo_step(
        self, state: PromotionState, events: list[Event]
    ) -> PromotionState:
        """One SLO accounting pass (``spec.slo``; operator/slo.py).

        Samples the metrics already scraped for this CR — TTFT/ITL p99
        from the engine series, availability from the gate histograms —
        into rolling per-SLO windows, computes attainment / burn rate /
        budget remaining, and journals an ``SloRecord`` (plus a
        ``SloBudgetExhausted`` Warning) whenever an SLO's budget state
        changes.  Absent ``spec.slo`` (the default): no tracker object,
        no reads, no status writes — byte-for-byte."""
        config = self._audit_config
        if config is None:
            return state  # spec didn't parse: leave everything alone
        if not config.slo.enabled:
            if self._slo_tracker is not None:
                # spec.slo removed: drop the window and state so a
                # re-enable starts a fresh budget, not a stale one.
                self._slo_tracker = None
                self._slo_last_state = {}
            self._slo_evals = None
            return state
        if state.current_version is None:
            return state  # nothing serving yet: nothing to attain
        from . import slo as _slo

        if self._slo_tracker is None:
            self._slo_tracker = _slo.SloTracker()
        spec = config.slo
        source = self._metrics_source(config)
        predictor = f"v{state.current_version}"
        model = engine = None
        with self._op_timer("slo_read"):
            try:
                model = source.model_metrics(
                    self.name, predictor, self.namespace,
                    config.canary.metrics_window_s,
                )
            except Exception as e:
                self.log.warning(f"slo model metrics read failed: {e}")
            if self._step_engine_obs is not False:
                # The autoscale pass already read this predictor's
                # engine metrics this step (tails included, since
                # spec.slo is on): reuse instead of a second fetch.
                engine = self._step_engine_obs
            else:
                fetch = getattr(source, "engine_metrics", None)
                if fetch is not None:
                    try:
                        engine = self._engine_fetch(
                            fetch, predictor,
                            config.canary.metrics_window_s,
                            slo_tails=True,
                        )
                    except Exception as e:
                        self.log.warning(
                            f"slo engine metrics read failed: {e}"
                        )
        wall = self._wall()
        samples = _slo.collect_samples(spec, model, engine)
        window_s = spec.window_minutes * 60.0
        evals: dict = {}
        recs: list = []
        for name in spec.slo_names:
            if name in samples:
                good, observed = samples[name]
                self._slo_tracker.observe(name, wall, good, observed)
            ev = self._slo_tracker.evaluate(
                name, wall, window_s, spec.availability_pct,
                _slo.target_of(spec, name),
            )
            evals[name] = ev
            st = ev.state
            if st is not None and st != self._slo_last_state.get(name):
                recs.append(
                    _slo.SloRecord(
                        wall=wall,
                        slo=name,
                        state=st,
                        prior_state=self._slo_last_state.get(name),
                        attainment=ev.attainment,
                        burn_rate=ev.burn_rate,
                        budget_remaining=ev.budget_remaining,
                        target=ev.target,
                        objective_pct=spec.availability_pct,
                        window_minutes=spec.window_minutes,
                        observed=ev.observed,
                        samples=ev.samples,
                    )
                )
                self._slo_last_state[name] = st
        self._slo_evals = evals
        if recs:
            for rec in recs:
                if rec.state == _slo.STATE_EXHAUSTED:
                    ev = Event(
                        "Warning",
                        "SloBudgetExhausted",
                        f"SLO {rec.slo} error budget exhausted: "
                        f"attainment {rec.attainment:.4f} vs objective "
                        f"{rec.objective_pct}% over "
                        f"{rec.window_minutes:g}m (burn rate "
                        f"{rec.burn_rate:.2f}).",
                    )
                    events.append(ev)
                    self.kube.emit_event(self.cr_ref, ev)
                    self.log.warning(ev.message)
            state = self._journal(config, state, *recs)
            self._patch_status(state)
        return state

    def _anomaly_step(
        self, state: PromotionState, events: list[Event]
    ) -> PromotionState:
        """One fleet anomaly-detection pass (``spec.anomaly``;
        operator/anomaly.py).

        Pulls ring snapshots through the injected ``ring_sources``
        callable, builds the per-replica named-series windows (server
        ITL/MFU/queue PLUS the router's per-backend leg latency — the
        only vantage that sees proxy-injected slowness), and runs the
        pure ``detect()``.  A verdict-set SHAPE transition — which
        replicas/series/directions, never the jittering statistics —
        journals one ``AnomalyRecord``, emits one ``AnomalyDetected``
        Warning, and refreshes ``status.anomalies``; an unchanged
        standing verdict is silent.  Absent ``spec.anomaly`` (the
        default): no fetches, no status writes — byte-for-byte."""
        config = self._audit_config
        if config is None:
            return state  # spec didn't parse: leave everything alone
        spec = config.anomaly
        if not spec.enabled:
            self._anomaly_last_shape = frozenset()
            self._stragglers = frozenset()
            if state.anomalies is not None:
                # spec.anomaly removed with the key lingering: one
                # explicit-null patch clears it, then patch-free again.
                state = state.with_(anomalies=None)
                self._patch_status(state)
            return state
        if self.ring_sources is None:
            return state  # observatory not wired into this runtime
        from . import anomaly as _anomaly

        with self._op_timer("anomaly"):
            try:
                obs = self.ring_sources() or {}
            except Exception as e:
                self.log.warning(f"anomaly ring fetch failed: {e}")
                return state
            windows: dict = {}
            baselines: dict = {}
            for replica, snap in sorted(
                (obs.get("replicas") or {}).items()
            ):
                series = _anomaly.replica_series(snap, spec.window_s)
                if series:
                    windows[replica] = series
                base = _anomaly.baseline_of(snap, spec.baseline_s)
                if base:
                    baselines[replica] = base
            router_snap = obs.get("router")
            if router_snap:
                for replica, series in _anomaly.router_series(
                    router_snap, spec.window_s
                ).items():
                    windows.setdefault(replica, {}).update(series)
            verdicts = _anomaly.detect(windows, spec, baselines)
        shape = frozenset(v.shape for v in verdicts)
        self._stragglers = frozenset(
            v.replica for v in verdicts if v.kind == "straggler"
        )
        prev = self._anomaly_last_shape
        if prev is None:
            prev = frozenset()
        if shape == prev:
            return state  # standing verdict (or standing quiet): silent
        self._anomaly_last_shape = shape
        rec = _anomaly.AnomalyRecord(
            wall=self._wall(),
            action="detected" if verdicts else "cleared",
            verdicts=verdicts,
            replicas=len(windows),
        )
        self._anomaly_records = [rec]
        state = self._journal(config, state, rec)
        # status.anomalies carries the verdicts stamped at this
        # transition (live numbers would force a patch per poll).
        state = state.with_(anomalies=[v.as_dict() for v in verdicts])
        self._patch_status(state)
        if verdicts:
            ev = Event(
                "Warning",
                "AnomalyDetected",
                f"Fleet anomaly across {len(windows)} replicas: "
                + "; ".join(
                    f"{v.replica} {v.kind} on {v.series} "
                    f"({v.direction})"
                    for v in verdicts
                ),
            )
            events.append(ev)
            self.kube.emit_event(self.cr_ref, ev)
            self.log.warning(ev.message)
        else:
            self.log.info("fleet anomaly verdicts cleared")
        return state

    def _shed_disabled_journal(
        self, config: OperatorConfig, state: PromotionState
    ) -> PromotionState:
        """historyLimit back at 0 on a quiescent CR: the journal-writing
        paths won't run again until the next rollout, so clear the stale
        status.lastGate/history here (one extra patch, then steady state
        is patch-free again)."""
        if config.observability.history_limit > 0 or (
            state.last_gate is None and not state.history
        ):
            return state
        state = state.with_(last_gate=None, history=())
        self._patch_status(state)
        return state

    # -- replica autoscaling (operator/autoscaler.py) ------------------------

    def _autoscale_step(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        events: list[Event],
    ) -> PromotionState:
        """One autoscaler evaluation on a steady-state (non-canary) CR.

        Reads the current version's engine-saturation signals, computes
        the desired replica count with asymmetric hysteresis (pure logic
        in ``operator/autoscaler.py``), applies topology changes through
        the normal manifest path, and journals every decision as a
        ``ScaleRecord`` beside the gate/phase records.
        """
        from . import autoscaler as _scaling

        auto = config.autoscaling
        if not auto.enabled:
            if state.replicas is None and state.scaler is None:
                return state
            # Autoscaling switched off: hand the topology back to
            # spec.cuda.replicas and clear the status keys (explicit
            # nulls via _had_scaler_keys).
            state = state.with_(replicas=None, scaler=None)
            self._apply_for_state(obj, config, state)
            self._patch_status(state)
            self.log.info(
                "autoscaling disabled; replicas back to spec topology"
            )
            return state
        if state.current_version is None:
            return state

        current = state.replicas
        if current is None:
            # First evaluation after enabling: adopt the spec topology,
            # clamped into the autoscaler's band.
            current = _scaling.clamp_replicas(config.cuda.replicas, auto)
        observed = None
        source = self._metrics_source(config)
        fetch = getattr(source, "engine_metrics", None)
        if fetch is not None:
            try:
                with self._op_timer("scale_read"):
                    # slo_tails rides along when spec.slo is on, so the
                    # SLO step can reuse THIS reading instead of a
                    # second identical fetch.
                    observed = self._engine_fetch(
                        fetch,
                        f"v{state.current_version}",
                        config.canary.metrics_window_s,
                        slo_tails=config.slo.enabled,
                    )
            except Exception as e:
                # Blind = hold (decide() treats None as metrics-missing);
                # a Prometheus blip must never read as "no load".
                self.log.warning(f"engine metrics read failed: {e}")
                observed = None
            self._step_engine_obs = observed

        decision = _scaling.decide(
            auto,
            current,
            _scaling.ScalerState.from_status(state.scaler),
            observed,
            self._wall(),
        )
        record = decision.record
        if record is not None:
            record = dataclasses.replace(
                record, version=state.current_version
            )
        self._scale_record = record

        first_take = state.replicas is None
        changed = decision.replicas != current
        new_state = state.with_(
            replicas=decision.replicas, scaler=decision.state.to_status()
        )
        # Park context: while the Deployment is at zero, status.snapshot
        # records the restore source the wake path will use.
        if decision.replicas == 0:
            snap = self._snapshot_status(config, state)
            if snap is not None and new_state.snapshot != snap:
                new_state = new_state.with_(snapshot=snap)
        elif new_state.snapshot is not None:
            new_state = new_state.with_(snapshot=None)

        if changed or first_take:
            self._last_scale_hold = None
            applied_rec = record if changed else None
            if first_take and config.cuda.replicas != decision.replicas:
                # Enabling autoscaling CHANGED the running topology (the
                # spec count was clamped into the band, or the demand
                # moved it immediately): journal the real from-count and
                # arm the cooldown — an unrecorded multi-replica jump
                # would be invisible in status.history and a follow-up
                # step-down could fire with no scale event on record.
                base = record if record is not None else _scaling.ScaleRecord(
                    wall=self._wall(),
                    desired=decision.replicas,
                    reason="spec topology adopted into the autoscaling band",
                )
                applied_rec = dataclasses.replace(
                    base,
                    from_replicas=config.cuda.replicas,
                    to_replicas=decision.replicas,
                    hold=None,
                    version=state.current_version,
                )
                self._scale_record = applied_rec
                new_state = new_state.with_(
                    scaler=dataclasses.replace(
                        decision.state, last_scale_wall=self._wall()
                    ).to_status()
                )
            self._apply_for_state(obj, config, new_state)
            new_state = self._journal(config, new_state, applied_rec)
            self._patch_status(new_state)
            if applied_rec is not None and applied_rec.applied:
                if applied_rec.to_replicas == 0:
                    reason = "ScaledToZero"
                elif applied_rec.from_replicas == 0:
                    reason = "WokenFromZero"
                elif applied_rec.to_replicas > applied_rec.from_replicas:
                    reason = "ScaledUp"
                else:
                    reason = "ScaledDown"
                ev = Event(
                    "Normal",
                    reason,
                    f"Scaled replicas {applied_rec.from_replicas} -> "
                    f"{applied_rec.to_replicas} ({applied_rec.reason}).",
                )
                events.append(ev)
                self.kube.emit_event(self.cr_ref, ev)
                self.log.info(ev.message)
            return new_state

        # No topology change.  Journal a hold only when its shape is new
        # (an unchanged "cooldown" hold must not append one record per
        # poll), and patch only when something durable moved (the
        # stabilization clock arming/landing, or the journal growing).
        hold_rec = None
        if record is not None and record.hold is not None:
            hold_key = (record.hold, record.desired, current)
            if hold_key != self._last_scale_hold:
                self._last_scale_hold = hold_key
                hold_rec = record
        new_state = self._journal(config, new_state, hold_rec)
        if new_state != state:
            self._patch_status(new_state)
        return new_state

    def _fleet_step(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        events: list[Event],
    ) -> PromotionState:
        """One per-pool fleet autoscaler evaluation (disaggregated CRs,
        steady state only — frozen during canary like the whole-predictor
        autoscaler).

        The prefill pool sizes on its own admission-wait signal, the
        decode pool on the main autoscaling targets; every APPLIED
        change journals a pool-tagged ``ScaleRecord`` and re-applies the
        pool Deployments through the worker-unit sync."""
        from . import autoscaler as _scaling

        fleet = config.fleet
        if not fleet.disaggregation:
            if state.fleet is not None:
                # Disaggregation switched off: clear the status key and
                # re-apply so the worker-unit sync GCs the pool
                # Deployments/Services this CR no longer wants.
                state = state.with_(fleet=None)
                self._apply_for_state(obj, config, state)
                self._patch_status(state)
            return state
        if not config.autoscaling.enabled or state.current_version is None:
            if (
                state.fleet is not None
                and state.current_version is not None
            ):
                # Autoscaling switched off mid-flight: hand the pool
                # counts back to spec.fleet and clear the status key —
                # a stale status.fleet would silently pin the pools at
                # the autoscaler's last counts through later spec edits.
                state = state.with_(fleet=None)
                self._apply_for_state(obj, config, state)
                self._patch_status(state)
            return state
        source = self._metrics_source(config)
        fetch = getattr(source, "engine_metrics", None)
        obs_prefill = obs_decode = None
        if fetch is not None:
            try:
                with self._op_timer("scale_read"):
                    obs_prefill = fetch(
                        self.name,
                        f"v{state.current_version}-prefill",
                        self.namespace,
                        config.canary.metrics_window_s,
                    )
                    obs_decode = fetch(
                        self.name,
                        f"v{state.current_version}-decode",
                        self.namespace,
                        config.canary.metrics_window_s,
                    )
            except Exception as e:
                # Blind = hold, same contract as the predictor scaler.
                self.log.warning(f"fleet engine metrics read failed: {e}")
        decision = _scaling.decide_fleet(
            config.autoscaling, fleet, state.fleet,
            obs_prefill, obs_decode, self._wall(),
        )
        cur_prefill, cur_decode = _scaling.fleet_counts(fleet, state.fleet)
        changed = (
            decision.prefill.replicas != cur_prefill
            or decision.decode.replicas != cur_decode
        )
        new_state = state.with_(fleet=decision.to_status(state.fleet))
        applied = [
            dataclasses.replace(d.record, version=state.current_version)
            for d in (decision.prefill, decision.decode)
            if d.record is not None and d.record.applied
        ]
        if changed:
            self._apply_for_state(obj, config, new_state)
            new_state = self._journal(config, new_state, *applied)
            self._patch_status(new_state)
            for rec in applied:
                ev = Event(
                    "Normal",
                    "FleetScaled",
                    f"Scaled {rec.pool} pool {rec.from_replicas} -> "
                    f"{rec.to_replicas} ({rec.reason}).",
                )
                events.append(ev)
                self.kube.emit_event(self.cr_ref, ev)
                self.log.info(ev.message)
        elif new_state != state:
            # Stabilization/cooldown clocks moved (or the key is new):
            # persist them without journaling per-poll hold records.
            self._patch_status(new_state)
        return new_state

    def _multiplex_step(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        events: list[Event],
    ) -> PromotionState:
        """One multiplexer pass for a pool-member CR (steady state only,
        like the autoscaler — a mid-canary CR must not be swapped out
        from under the judge).

        Registers this CR with its shared-pool coordinator
        (operator/multiplexer.py), pumps one observe→plan→execute pass
        (rate-limited inside the coordinator so N members don't N-fold
        the convergence rate — attaches go through the existing
        warm-pool admin endpoint), journals the resulting MuxRecords
        into THIS CR's status.history, and publishes status.multiplex.
        Disabled = the key clears once, then byte-for-byte."""
        mux = config.multiplex
        if not mux.enabled:
            if state.multiplex is not None:
                state = state.with_(multiplex=None)
                self._patch_status(state)
            return state
        status: dict = {"pool": mux.pool_ref, "weight": mux.weight}
        coord = (self.mux_pools or {}).get(mux.pool_ref)
        recs = []
        if coord is not None:
            uri = None
            if state.current_version is not None:
                try:
                    # The ATTACHABLE artifact uri (what the pool restores
                    # from), not the raw registry source.
                    uri = self._resolve_uri(config, state.current_version)
                except Exception as e:  # registry blip: keep the last
                    self.log.warning(f"mux uri resolution failed: {e}")
            if uri:
                coord.register(self.name, uri=uri, weight=mux.weight)
            # Straggler verdicts steer placement: a flagged replica is
            # the LAST choice as an attach target.  Empty set (verdicts
            # off or all clear) leaves every decision byte-identical.
            set_stragglers = getattr(coord, "set_stragglers", None)
            if set_stragglers is not None:
                set_stragglers(self._stragglers or frozenset())
            with self._op_timer("mux_pump"):
                coord.pump()
            recs = coord.take_records(self.name)
            status.update(coord.model_status(self.name))
        self._mux_records = recs
        new_state = state.with_(multiplex=status)
        new_state = self._journal(config, new_state, *recs)
        if new_state != state:
            self._patch_status(new_state)
        for rec in recs:
            if rec.action in ("attach", "replace"):
                ev = Event(
                    "Normal",
                    "MuxAttached",
                    f"Multiplexer {rec.action}ed {rec.model} onto "
                    f"{rec.replica} in pool {rec.pool} "
                    f"(score {rec.score:g}, {rec.parked} parked).",
                )
                events.append(ev)
                self.kube.emit_event(self.cr_ref, ev)
                self.log.info(ev.message)
            elif rec.action == "error":
                ev = Event(
                    "Warning",
                    "MuxAttachFailed",
                    f"Multiplexer could not attach {rec.model}: "
                    f"{rec.reason}.",
                )
                events.append(ev)
                self.kube.emit_event(self.cr_ref, ev)
                self.log.warning(ev.message)
        return new_state

    def _snapshot_status(self, config: OperatorConfig, state) -> "dict | None":
        """``status.snapshot`` for a CR parked at zero: the deterministic
        snapshot location (``server/snapshot.py`` keys it by model URI;
        quantize/mesh invalidation lives in the manifest's content hash)
        so the wake path — and a human — can find the restore source
        without the data plane running."""
        if not config.cuda.snapshot.enabled or state.current_version is None:
            return None
        out: dict = {
            "enabled": True,
            "dir": config.cuda.snapshot.dir,
            "quantize": config.cuda.quantize,
        }
        try:
            uri = self._resolve_uri(config, state.current_version)
            from ..server.snapshot import snapshot_path_for

            out["modelUri"] = uri
            out["uri"] = str(snapshot_path_for(config.cuda.snapshot.dir, uri))
        except Exception as e:  # registry blip: park context still lands
            self.log.warning(f"snapshot URI resolution failed: {e}")
        return out

    # -- handlers ------------------------------------------------------------

    def _on_config_error(
        self, state: PromotionState, message: str, events: list[Event]
    ) -> ReconcileOutcome:
        """Invalid spec: surface it on the CR instead of only in operator logs.

        The data plane is deliberately left as-is — a spec typo must not tear
        down a serving model.  Status error + a Warning event are written only
        when the message changes, so backoff retries don't spam the stream.
        """
        err = f"invalid spec: {message}"
        new_state = state.with_(error=err)
        if state.error != err:
            self._patch_status(new_state)
            ev = Event("Warning", "InvalidSpec", err)
            events.append(ev)
            self.kube.emit_event(self.cr_ref, ev)
            self.log.error(err)
        return ReconcileOutcome(new_state, 300.0, events)

    def _on_alias_missing(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        events: list[Event],
    ) -> ReconcileOutcome:
        """Reference :64-93: error status, tear down, Warning event."""
        new_state = state.alias_missing(config.model_alias)
        changed = state != new_state
        # Strip stale journal keys if historyLimit went back to 0 — an
        # ERROR-parked CR never reaches the other shedding sites.
        new_state = self._journal(config, new_state)
        if changed:
            self._patch_status(new_state)
            self._delete_deployment()
            ev = Event(
                "Warning",
                "AliasNotFound",
                f"Alias '{config.model_alias}' does not exist.",
            )
            events.append(ev)
            self.kube.emit_event(self.cr_ref, ev)
            self.log.error(f"Alias '{config.model_alias}' does not exist.")
        elif state != new_state:
            # Journal-only cleanup: patch, but don't re-announce the
            # missing alias.
            self._patch_status(new_state)
        return ReconcileOutcome(new_state, config.monitoring_interval_s, events)

    # -- rollout journal -----------------------------------------------------

    def _journal(self, config: OperatorConfig, state: PromotionState, *records):
        """Queue journal records for the recorder flush and — when
        ``spec.observability.historyLimit`` > 0 — fold them into the
        state's status journal.  Returns the state to persist."""
        recs = [r for r in records if r is not None]
        self._pending_records.extend(recs)
        limit = config.observability.history_limit
        if limit <= 0:
            # Journal disabled: strip keys left over from when it was
            # enabled so the upcoming patch clears them.
            if state.last_gate is not None or state.history:
                return state.with_(last_gate=None, history=())
            return state
        if not recs:
            return state
        history = (state.history + tuple(r.as_dict() for r in recs))[-limit:]
        kw: dict = {"history": tuple(history)}
        for r in reversed(recs):
            if isinstance(r, GateRecord):
                kw["last_gate"] = r.compact()
                break
        return state.with_(**kw)

    def _gate_record(
        self,
        config: OperatorConfig,
        state: PromotionState,
        decision,
        new_m,
        old_m,
        traffic_after: int,
        attempt: int,
    ) -> GateRecord:
        """Everything the judge saw and decided, as one journal record.
        The timings snapshot here is what has accrued so far this step
        (registry + gate_read + any manifest apply); the recorder copy
        is re-stamped with the complete breakdown at step end."""
        return GateRecord(
            ts=self.clock.now(),
            wall=time.time(),
            new_version=state.current_version,
            old_version=state.previous_version,
            traffic_before=state.traffic_current,
            traffic_after=traffic_after,
            attempt=attempt,
            promote=bool(decision.promote),
            reasons=tuple(decision.reasons),
            missing_on=tuple(sorted(decision.missing_on)),
            margins=dict(decision.margins),
            new_metrics=new_m.as_dict(),
            old_metrics=old_m.as_dict(),
            thresholds=dataclasses.asdict(config.thresholds),
            timings=dict(self._timings),
            suppressed_events=self._hold_suppressed,
        )

    def _transition(
        self,
        from_phase: Phase,
        to_phase: Phase,
        reason: str,
        new_version: str | None,
        old_version: str | None,
        traffic: int,
    ) -> TransitionRecord:
        return TransitionRecord(
            ts=self.clock.now(),
            wall=time.time(),
            from_phase=from_phase.value,
            to_phase=to_phase.value,
            reason=reason,
            new_version=new_version,
            old_version=old_version,
            traffic=traffic,
        )

    def _log_decision(self, config: OperatorConfig, rec: GateRecord) -> None:
        payload = {
            "event": "gate_decision",
            "namespace": self.namespace,
            "name": self.name,
            "model": config.model_name,
            "newVersion": rec.new_version,
            "oldVersion": rec.old_version,
            "result": rec.result,
            "refusal": rec.refusal,
            "attempt": rec.attempt,
            "trafficBefore": rec.traffic_before,
            "trafficAfter": rec.traffic_after,
            "margins": dict(rec.margins),
            "reasons": list(rec.reasons),
            "suppressedEvents": rec.suppressed_events,
        }
        _gate_log.info(
            "%s",
            json.dumps(payload, default=str),
            extra={"cr_namespace": self.namespace, "cr_name": self.name},
        )

    def _reset_hold_dedupe(self) -> None:
        self._last_hold = None
        self._hold_suppressed = 0

    # -- handlers (continued) ------------------------------------------------

    def _on_new_version(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        mv: ModelVersion,
        events: list[Event],
    ) -> ReconcileOutcome:
        new_state = state.new_version(mv.version, config.canary.initial_traffic)
        self._reset_hold_dedupe()
        self._last_scale_hold = None  # frozen rollout: fresh dedupe after
        # Apply + persist BEFORE emitting: if the apply fails persistently,
        # status is unchanged and the next reconcile retries this branch —
        # emitting first would duplicate the event on every retry.
        applied = self._apply_for_state(obj, config, new_state, source_of_current=mv)
        new_state = self._journal(
            config,
            new_state,
            self._transition(
                state.phase,
                new_state.phase,
                "NewModelVersionDetected",
                mv.version,
                new_state.previous_version,
                new_state.traffic_current,
            ),
        )
        self._patch_status(new_state)
        ev = Event(
            "Normal",
            "NewModelVersionDetected",
            f"New model version {mv.version} detected.",
        )
        events.append(ev)
        self.kube.emit_event(self.cr_ref, ev)
        self.log.info(f"New model version detected: {mv.version}")

        # Fresh STABLE deploy (no canary): the autoscaler takes the
        # topology under control immediately, so a minReplicas floor
        # above spec.cuda.replicas applies on first deploy rather than
        # one monitoring interval later.
        if new_state.phase == Phase.STABLE:
            new_state = self._autoscale_step(obj, config, new_state, events)
            new_state = self._fleet_step(obj, config, new_state, events)
            new_state = self._multiplex_step(obj, config, new_state, events)

        # Canary: go straight to the first gate check (the reference enters
        # its metrics loop immediately after the initial apply, :296-310).
        requeue = 0.0 if new_state.phase == Phase.CANARY else config.monitoring_interval_s
        return ReconcileOutcome(new_state, requeue, events, applied=applied)

    def _on_canary_step(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        events: list[Event],
    ) -> ReconcileOutcome:
        canary = config.canary
        source = self._metrics_source(config)
        with self._op_timer("gate_read"):
            new_m = source.model_metrics(
                self.name,
                f"v{state.current_version}",
                self.namespace,
                canary.metrics_window_s,
            )
            old_m = source.model_metrics(
                self.name,
                f"v{state.previous_version}",
                self.namespace,
                canary.metrics_window_s,
            )
        self.log.info(
            f"Metrics for new model (version {state.current_version}): {new_m.as_dict()}"
        )
        self.log.info(
            f"Metrics for old model (version {state.previous_version}): {old_m.as_dict()}"
        )

        decision = should_promote(new_m, old_m, config.thresholds, self.log)
        attempt_no = state.attempt + 1  # 1-based: this evaluation's number
        if decision:
            self._reset_hold_dedupe()
            new_state = state.promoted_step(canary.step)
            rec = self._gate_record(
                config, state, decision, new_m, old_m,
                new_state.traffic_current, attempt_no,
            )
            applied = self._apply_for_state(obj, config, new_state)
            records = [rec]
            if new_state.phase == Phase.STABLE:
                records.append(
                    self._transition(
                        Phase.CANARY, Phase.STABLE, "PromotionComplete",
                        new_state.current_version, state.previous_version, 100,
                    )
                )
            new_state = self._journal(config, new_state, *records)
            self._patch_status(new_state)
            self._log_decision(config, rec)
            if new_state.phase == Phase.STABLE:
                ev = Event(
                    "Normal",
                    "PromotionComplete",
                    "New model now receives 100% traffic. "
                    "Previous model has been removed.",
                )
                requeue = config.monitoring_interval_s
            else:
                ev = Event(
                    "Normal",
                    "TrafficIncrease",
                    f"Increased traffic to new model to {new_state.traffic_current}%",
                )
                requeue = canary.step_interval_s
            events.append(ev)
            self.kube.emit_event(self.cr_ref, ev)
            self.log.info(ev.message)
            return ReconcileOutcome(new_state, requeue, events, applied=applied)

        # Gate refused.  If the refusal is missing metrics (no traffic in the
        # window — SURVEY §3.5(4) zero-traffic deadlock), send best-effort
        # synthetic warm-up traffic to the canary before the next attempt.
        # This runs on gate attempts, NOT at deploy time: right after the
        # manifest apply the canary pod/service does not exist yet, so a
        # deploy-time burst would always fail and never be retried.
        if canary.warmup_requests > 0 and self.warmup is not None:
            # The gate needs BOTH predictors' metrics; warm whichever one the
            # judge reported as missing traffic (usually the 10% canary, but a
            # drained stable predictor deadlocks the gate just the same).
            targets = []
            if "new" in decision.missing_on:
                targets.append(f"v{state.current_version}")
            if "old" in decision.missing_on:
                targets.append(f"v{state.previous_version}")
            for predictor in targets:
                try:
                    self.warmup(
                        self.name,
                        predictor,
                        self.namespace,
                        canary.warmup_requests,
                        model=config.model_name,
                    )
                    self.log.info(
                        f"sent {canary.warmup_requests} warm-up requests to "
                        f"{predictor} (gate metrics unavailable)"
                    )
                except Exception as e:
                    self.log.warning(f"warm-up traffic failed: {e}")

        new_state = state.gate_failed()
        if new_state.attempt < canary.max_attempts:
            # Stuck-canary event rate limiting: an unchanged refusal at
            # the same traffic level emits ONE Warning event, not one
            # per poll — the suppressed count rides the journal.  The
            # key is the refusal SHAPE (which checks fail / which model
            # is traffic-less), never the reason strings: those embed
            # live metric readings that jitter every poll, which would
            # defeat the dedupe exactly when it matters.
            hold_key = (
                state.traffic_current,
                tuple(sorted(decision.missing_on)),
                bool(decision.margins),  # min_sample vs threshold class
                tuple(
                    sorted(
                        k for k, v in decision.margins.items() if v < 0
                    )
                ),
            )
            if hold_key != self._last_hold:
                self._last_hold = hold_key
                self._hold_suppressed = 0
                hold_ev = Event(
                    "Warning",
                    "PromotionHold",
                    f"Gate refused promotion at {state.traffic_current}% "
                    f"(attempt {new_state.attempt}/{canary.max_attempts}): "
                    + "; ".join(decision.reasons),
                )
                events.append(hold_ev)
                self.kube.emit_event(self.cr_ref, hold_ev)
            else:
                self._hold_suppressed += 1
            rec = self._gate_record(
                config, state, decision, new_m, old_m,
                state.traffic_current, attempt_no,
            )
            new_state = self._journal(config, new_state, rec)
            self._patch_status(new_state)
            self._log_decision(config, rec)
            self.log.info(
                f"Attempt {new_state.attempt}/{canary.max_attempts}: metrics do not "
                f"meet conditions, retrying after {canary.attempt_delay_s} seconds."
            )
            return ReconcileOutcome(new_state, canary.attempt_delay_s, events)

        # Max attempts exhausted (reference :341-349).
        rec = self._gate_record(
            config, state, decision, new_m, old_m,
            state.traffic_current, attempt_no,
        )
        self._reset_hold_dedupe()
        fail_ev = Event(
            "Warning",
            "PromotionFailed",
            f"Metrics did not meet conditions after {canary.max_attempts} attempts, "
            "stopping promotion.",
        )
        events.append(fail_ev)
        self.kube.emit_event(self.cr_ref, fail_ev)
        self.log.warning(fail_ev.message)

        if canary.rollback_on_failure:
            # The rollback the reference left as a TODO (:345).
            new_state = new_state.rolled_back()
            applied = self._apply_for_state(obj, config, new_state)
            new_state = self._journal(
                config,
                new_state,
                rec,
                self._transition(
                    Phase.CANARY, Phase.ROLLED_BACK, "RollbackComplete",
                    new_state.held_version, new_state.current_version, 100,
                ),
            )
            self._patch_status(new_state)
            self._log_decision(config, rec)
            rb_ev = Event(
                "Normal",
                "RollbackComplete",
                f"Rolled back to version {new_state.current_version}; "
                f"version {new_state.held_version} is held until the alias moves.",
            )
            events.append(rb_ev)
            self.kube.emit_event(self.cr_ref, rb_ev)
            self.log.warning(rb_ev.message)
            return ReconcileOutcome(
                new_state, config.monitoring_interval_s, events, applied=applied
            )

        new_state = new_state.halt_failed()
        new_state = self._journal(
            config,
            new_state,
            rec,
            self._transition(
                Phase.CANARY, Phase.FAILED, "PromotionFailed",
                new_state.current_version, new_state.previous_version,
                new_state.traffic_current,
            ),
        )
        self._patch_status(new_state)
        self._log_decision(config, rec)
        return ReconcileOutcome(new_state, config.monitoring_interval_s, events)

    # -- deployment application ---------------------------------------------

    def _resolve_uri(self, config: OperatorConfig, version: str) -> str:
        key = (config.model_name, version)
        source = self._source_cache.get(key)
        if source is None:
            source = self.registry.get_version(config.model_name, version).source
            self._source_cache[key] = source
        return artifact_uri(source, config.artifact_root)

    def _manifest_for_state(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        source_of_current: ModelVersion | None = None,
    ) -> dict:
        if source_of_current is not None and source_of_current.version == state.current_version:
            new_uri = artifact_uri(source_of_current.source, config.artifact_root)
            self._source_cache[
                (config.model_name, state.current_version)
            ] = source_of_current.source
        else:
            new_uri = self._resolve_uri(config, state.current_version)
        old_uri = None
        if state.previous_version is not None and state.traffic_prev > 0:
            old_uri = self._resolve_uri(config, state.previous_version)
        owner_uid = (obj.get("metadata") or {}).get("uid", f"uid-{self.name}")
        return build_deployment(
            name=self.name,
            namespace=self.namespace,
            owner_uid=owner_uid,
            config=config,
            current_version=state.current_version,
            new_model_uri=new_uri,
            traffic_current=state.traffic_current,
            previous_version=state.previous_version if state.traffic_prev > 0 else None,
            old_model_uri=old_uri,
            traffic_prev=state.traffic_prev,
            # Autoscaler-controlled count (None = spec topology).  Applies
            # to every predictor: mid-canary the topology is frozen, so
            # both versions serve at the same replica count.
            replicas=state.replicas,
        )

    def _apply_for_state(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        source_of_current: ModelVersion | None = None,
    ) -> bool:
        if state.current_version is None:
            return False
        manifest = self._manifest_for_state(obj, config, state, source_of_current)
        self._apply_deployment(manifest)
        if config.backend == "cuda":
            self._sync_worker_units(obj, config, state, source_of_current)
        return True

    def _apply_deployment(self, manifest: dict) -> None:
        self._apply_object(self.deployment_ref, manifest)

    def _apply_object(self, ref: ObjectRef, manifest: dict, max_retries: int = 3) -> None:
        """Create-or-replace with optimistic-concurrency retry.

        Reference ``apply_seldon_deployment`` (``mlflow_operator.py:244-282``)
        does get -> inject resourceVersion -> replace, creating on 404 — but a
        409 from a concurrent writer kills the handler.  Here Conflict causes
        a re-get and retry.
        """
        with self._op_timer("manifest_apply"):
            self._apply_object_inner(ref, manifest, max_retries)

    def _apply_object_inner(
        self, ref: ObjectRef, manifest: dict, max_retries: int = 3
    ) -> None:
        for attempt in range(max_retries):
            try:
                existing = self.kube.get(ref)
            except NotFound:
                try:
                    self.kube.create(ref, manifest)
                    self.log.info(f"Created {ref.plural}/{ref.name}.")
                    return
                except Conflict:
                    continue  # lost a create race; re-get and replace
            else:
                body = dict(manifest)
                meta = dict(body.get("metadata") or {})
                rv = (existing.get("metadata") or {}).get("resourceVersion")
                if rv:
                    meta["resourceVersion"] = rv
                body["metadata"] = meta
                try:
                    self.kube.replace(ref, body)
                    return
                except Conflict:
                    if attempt == max_retries - 1:
                        raise
                    continue
        raise ApiError(409, f"could not apply {ref.plural}/{ref.name} after retries")

    # -- multi-host worker units (SURVEY §7 hard part 5) ---------------------

    _UNIT_KIND_REFS = {
        "StatefulSet": {"group": "apps", "version": "v1", "plural": "statefulsets"},
        "Service": {"group": "", "version": "v1", "plural": "services"},
        # Warm-pool replicas (autoscaling.warmPoolSize): weightless,
        # compile-swept servers awaiting /admin/attach.
        "Deployment": {"group": "apps", "version": "v1", "plural": "deployments"},
    }

    def _sync_worker_units(
        self,
        obj: dict,
        config: OperatorConfig,
        state: PromotionState,
        source_of_current: ModelVersion | None = None,
        only_if_missing: bool = False,
    ) -> None:
        """Level-triggered: apply the worker units the current state needs,
        delete any this CR owns that it no longer needs (e.g. the old
        version's unit after the 100% step drops the predictor).

        The reference outsources all pod materialization to Seldon's
        controller; a multi-host slice (one predictor = N pods) is beyond
        that model, so for ``backend: cuda`` the operator owns these
        first-party.  Single-host topologies produce no units; the sync
        then only garbage-collects leftovers (e.g. after a topology edit).
        """
        from .builder import (
            build_fleet_pool_manifests,
            build_warm_pool_manifests,
            build_worker_unit_manifests,
        )

        owner_uid = (obj.get("metadata") or {}).get("uid", f"uid-{self.name}")
        desired: list[dict] = []
        if state.current_version is not None:
            if (
                source_of_current is not None
                and source_of_current.version == state.current_version
            ):
                uri = artifact_uri(source_of_current.source, config.artifact_root)
            else:
                uri = self._resolve_uri(config, state.current_version)
            desired += build_worker_unit_manifests(
                self.name, self.namespace, owner_uid, config,
                state.current_version, uri,
            )
            # Warm pool rides the current version (its snapshot geometry
            # is the prewarm source); [] when warmPoolSize is 0.
            desired += build_warm_pool_manifests(
                self.name, self.namespace, owner_uid, config,
                state.current_version, uri,
            )
            # Disaggregated prefill/decode pools ([] when off): counts
            # come from status.fleet when the per-pool autoscaler has
            # taken control, else spec.fleet.
            if config.fleet.disaggregation:
                from . import autoscaler as _scaling

                n_prefill, n_decode = _scaling.fleet_counts(
                    config.fleet, state.fleet
                )
                desired += build_fleet_pool_manifests(
                    self.name, self.namespace, owner_uid, config,
                    state.current_version, uri,
                    prefill_replicas=n_prefill,
                    decode_replicas=n_decode,
                )
        if state.previous_version is not None and state.traffic_prev > 0:
            prev_uri = self._resolve_uri(config, state.previous_version)
            desired += build_worker_unit_manifests(
                self.name, self.namespace, owner_uid, config,
                state.previous_version, prev_uri,
            )
            if config.fleet.disaggregation:
                # The outgoing version's pools at SPEC counts: the fleet
                # autoscaler is frozen during a canary, same contract as
                # the whole-predictor count.
                desired += build_fleet_pool_manifests(
                    self.name, self.namespace, owner_uid, config,
                    state.previous_version, prev_uri,
                )

        desired_names: dict[str, set[str]] = {
            kind: set() for kind in self._UNIT_KIND_REFS
        }
        for manifest in desired:
            kind = manifest["kind"]
            name = manifest["metadata"]["name"]
            desired_names[kind].add(name)
            ref = self._unit_ref(kind, name)
            if only_if_missing:
                # steady-state self-heal: recreate what's gone without
                # rewriting (and rv-bumping) healthy objects every cycle
                try:
                    self.kube.get(ref)
                    continue
                except NotFound:
                    self.log.warning(
                        f"worker-unit {kind} {name} missing; recreating (self-heal)."
                    )
            self._apply_object(ref, manifest)
        self._gc_worker_units(keep=desired_names)

    def _unit_ref(self, kind: str, name: str) -> ObjectRef:
        return ObjectRef(
            namespace=self.namespace, name=name, **self._UNIT_KIND_REFS[kind]
        )

    def _gc_worker_units(self, keep: dict[str, set[str]] | None = None) -> None:
        keep = keep or {}
        for kind in self._UNIT_KIND_REFS:
            try:
                existing = self.kube.list(self._unit_ref(kind, ""))
            except ApiError as e:
                self.log.warning(f"worker-unit GC list of {kind} failed: {e}")
                continue
            for found in existing:
                meta = found.get("metadata") or {}
                labels = meta.get("labels") or {}
                if labels.get("tpumlops/deployment") != self.name:
                    continue  # not ours
                name = meta.get("name", "")
                if name in keep.get(kind, set()):
                    continue
                try:
                    self.kube.delete(self._unit_ref(kind, name))
                    self.log.info(f"Deleted stale worker-unit {kind} {name}.")
                except NotFound:
                    pass

    def _ensure_deployment(
        self, obj: dict, config: OperatorConfig, state: PromotionState
    ) -> None:
        """Self-heal: recreate the deployment if it was deleted out-of-band.

        The reference cannot do this — it only writes on version change — so
        a deleted SeldonDeployment stays gone until the next alias move.
        """
        if state.current_version is None:
            return
        try:
            self.kube.get(self.deployment_ref)
        except NotFound:
            self.log.warning("SeldonDeployment missing; recreating (self-heal).")
            self._apply_for_state(obj, config, state)
            return
        if config.backend == "cuda":
            from .builder import _topology_info

            # the units are separate objects; heal them independently of
            # the (still-present) routing manifest.  Single-host topologies
            # have no units — skip the registry round-trips.
            if _topology_info(config).hosts > 1:
                self._sync_worker_units(obj, config, state, only_if_missing=True)

    def _delete_deployment(self) -> None:
        """Reference ``delete_seldon_deployment`` (:462-477): 404 tolerated.

        Also tears down any first-party worker units (in-cluster the
        ownerReferences GC covers them too; explicit delete keeps fakes and
        non-GC stores equivalent)."""
        try:
            self.kube.delete(self.deployment_ref)
            self.log.info(f"SeldonDeployment '{self.name}' deleted.")
        except NotFound:
            pass
        self._gc_worker_units()

    def _patch_status(self, state: PromotionState) -> None:
        import datetime

        # Wall clock, NOT self.clock: the injected Clock is monotonic in
        # production (SystemClock = time.monotonic), and a
        # lastTransitionTime of "1970-01-03T…" is garbage to kubectl and
        # anything sorting conditions.  Transition stability still comes
        # from the prior-conditions comparison, so FakeClock tests are
        # unaffected.
        now_iso = datetime.datetime.fromtimestamp(
            time.time(), datetime.timezone.utc
        ).strftime("%Y-%m-%dT%H:%M:%SZ")
        status = state.to_status()
        # Journal keys are omitted when empty (byte-for-byte default), so
        # a CR whose historyLimit went back to 0 needs explicit nulls once
        # to clear what the merge-patch would otherwise leave behind.
        if getattr(self, "_had_journal_keys", False):
            status.setdefault("lastGate", None)
            status.setdefault("history", None)
        if getattr(self, "_had_scaler_keys", False):
            status.setdefault("replicas", None)
            status.setdefault("autoscaler", None)
        if getattr(self, "_had_snapshot_key", False):
            status.setdefault("snapshot", None)
        if getattr(self, "_had_fleet_key", False):
            status.setdefault("fleet", None)
        if getattr(self, "_had_multiplex_key", False):
            status.setdefault("multiplex", None)
        if getattr(self, "_had_anomalies_key", False):
            status.setdefault("anomalies", None)
        if getattr(self, "_capacity_known", False):
            cap = self._capacity_status
            if cap is not None:
                status["capacity"] = cap
            elif getattr(self, "_had_capacity_key", False):
                status.setdefault("capacity", None)
            # Any patch carries the current summary (or its explicit
            # null), so the end-of-step sync knows nothing is left to do.
            self._prior_capacity = cap
        if getattr(self, "_restarts_known", False):
            rs = self._restarts_status
            if rs is not None:
                status["restarts"] = rs
            elif getattr(self, "_had_restarts_key", False):
                status.setdefault("restarts", None)
            self._prior_restarts = rs
        if getattr(self, "_plan_known", False):
            plan_dict = self._plan_status
            if plan_dict is not None:
                status["plan"] = plan_dict
            elif getattr(self, "_had_plan_key", False):
                status.setdefault("plan", None)
            self._prior_plan = plan_dict
        status["conditions"] = state.conditions(
            getattr(self, "_prior_conditions", None), now_iso
        )
        # Later patches in the same reconcile see the fresh conditions.
        self._prior_conditions = status["conditions"]
        try:
            with self._op_timer("status_patch"):
                self.kube.patch_status(self.cr_ref, status)
        except NotFound:
            # CR deleted mid-step; runtime will stop this reconciler.
            self.log.info("CR gone; skipping status patch.")
