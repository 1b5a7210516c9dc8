"""Typed configuration parsed from the ``MlflowModel`` CRD spec (the
port's copy of the JAX package's ``utils/config.py``).

Every operating constant of the reference operator is a spec field with
the reference value as its default, so an unannotated CR behaves exactly
like the reference while everything is tunable per model.  ``backend:
seldon`` parses as the JAX package's does.  ``backend: cuda`` is this
package's first-party data plane (the JAX package's ``tpu``): ``spec.cuda``
(:class:`CudaSpec`) holds ``TpuSpec``'s fields, defaults and validation,
and ``gpuTopology`` names an entry of :data:`GPU_TOPOLOGIES`.

Not yet ported, refused at parse with a ``ValueError`` naming the field: a
topology of more than one card (one process a card needs the unit
launcher), ``spec.slo``, ``spec.planner``, ``spec.anomaly`` and
``spec.multiplex``.  The server's own configuration is
``server/app.py``'s ``ServerConfig``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Mapping

from .journey_trace import SLO_CLASSES

# Reference defaults (file:line cites into the reference operator's mlflow_operator.py)
DEFAULT_MONITORING_INTERVAL_S = 60  # :31
DEFAULT_ARTIFACT_ROOT = "s3://mlflow"  # :125
DEFAULT_PROMETHEUS_URL = (
    "http://seldon-monitoring-prometheus.seldon-monitoring.svc.cluster.local:9090"  # :47
)
DEFAULT_TRAFFIC_STEP = 10  # :291
DEFAULT_STEP_INTERVAL_S = 60  # :292
DEFAULT_MAX_ATTEMPTS = 10  # :293
DEFAULT_ATTEMPT_DELAY_S = 10  # :294
DEFAULT_INITIAL_CANARY_TRAFFIC = 10  # :187
DEFAULT_METRICS_WINDOW_S = 60  # :363 (elapsed_time=60)
# The image of this package's server (``python -m <package>.server``).
DEFAULT_SERVER_IMAGE = "tpumlops/torch-server:latest"


class NotYetPorted(ValueError):
    """A spec field whose machinery this package does not have yet: the
    reconciler sets the CR to ``Error`` as it does for any bad spec."""


# Canonical GPU topology table: CRD gpuTopology value -> placement facts.
# A unit of ``hosts > 1`` is several pods forming one process group; the
# builder's ``nvidia.com/gpu`` request is per host (``cards_per_host``).


@dataclass(frozen=True)
class GpuTopologyInfo:
    product: str  # the node label nvidia.com/gpu.product
    cards: int  # total cards of one predictor unit
    hosts: int = 1  # nodes of the unit (pods per predictor unit)

    @property
    def cards_per_host(self) -> int:
        return self.cards // self.hosts

    def check_mesh(self, name: str, mesh_shape: Mapping[str, int]) -> None:
        """Over-subscription only: a mesh SMALLER than the unit is legal
        (the server builds it over a device prefix — a {dp:1, tp:1} debug
        CR on an h100-8 node runs fine, idle cards and all); a mesh larger
        than the unit can never schedule."""
        n = 1
        for v in mesh_shape.values():
            n *= int(v)
        if n > self.cards:
            raise ValueError(
                f"meshShape {dict(mesh_shape)} uses {n} "
                f"devices but gpuTopology {name!r} provides "
                f"only {self.cards} cards; dp*pp*ep*sp*tp must not "
                "exceed the topology or the pod is unschedulable"
            )


H100_PRODUCT = "NVIDIA-H100-80GB-HBM3"

# HBM per card by product label (the operator's capacity-summary fact;
# the data plane measures its own through torch.cuda).
GPU_HBM_GIB_PER_CARD: dict[str, int] = {
    H100_PRODUCT: 80,
}

GPU_TOPOLOGIES: dict[str, GpuTopologyInfo] = {
    "h100-1": GpuTopologyInfo(H100_PRODUCT, 1),
    "h100-2": GpuTopologyInfo(H100_PRODUCT, 2),
    "h100-4": GpuTopologyInfo(H100_PRODUCT, 4),
    "h100-8": GpuTopologyInfo(H100_PRODUCT, 8),
    # two 8-card nodes
    "h100-16": GpuTopologyInfo(H100_PRODUCT, 16, hosts=2),
}

# The refusal of every unit of more than one card, until the port has a
# launcher that starts one process a card.
MULTI_CARD_REFUSAL = "not yet ported: one process a card needs the unit launcher"


@dataclass(frozen=True)
class GateThresholds:
    """Relative regression tolerances for the promotion gate.

    Semantics match ``should_promote_model`` (``mlflow_operator.py:175-179``):
    promote only if new <= old * (1 + threshold) for each metric.

    Hardening extensions beyond the reference (SURVEY §3.5(4)):

    - ``min_sample_count``: both predictors must have served at least this
      many requests in the window before the gate will pass; avoids judging
      on noise.  0 keeps reference behavior (any non-None metric counts).
    - ``error_rate_floor``: absolute error-rate slack.  The reference's
      purely relative check (``:447``) deadlocks when the old model has 0
      errors: a single canary error fails ``new <= 0 * 1.02``.  With a
      floor f, the gate passes if ``new_err <= max(old_err * (1+tol), f)``.
      0.0 keeps reference behavior.
    """

    latency_p95: float = 0.05  # :176
    error_rate: float = 0.02  # :177
    latency_avg: float = 0.05  # :178
    min_sample_count: int = 0
    error_rate_floor: float = 0.0

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "GateThresholds":
        spec = spec or {}
        return cls(
            latency_p95=float(spec.get("latencyP95", spec.get("latency_95th", 0.05))),
            error_rate=float(spec.get("errorRate", 0.02)),
            latency_avg=float(spec.get("latencyAvg", 0.05)),
            min_sample_count=int(spec.get("minSampleCount", 0)),
            error_rate_floor=float(spec.get("errorRateFloor", 0.0)),
        )


@dataclass(frozen=True)
class CanaryPolicy:
    """Traffic-shifting schedule (reference constants at
    ``mlflow_operator.py:290-294``) plus rollback policy.

    ``rollback_on_failure=False`` reproduces the reference, which stops and
    leaves weights frozen after ``max_attempts`` gate failures (the rollback
    is an acknowledged TODO at ``:345``).  True enables the real
    rollback-on-SLO-breach path (north-star requirement).
    """

    step: int = DEFAULT_TRAFFIC_STEP
    step_interval_s: float = DEFAULT_STEP_INTERVAL_S
    max_attempts: int = DEFAULT_MAX_ATTEMPTS
    attempt_delay_s: float = DEFAULT_ATTEMPT_DELAY_S
    initial_traffic: int = DEFAULT_INITIAL_CANARY_TRAFFIC
    metrics_window_s: int = DEFAULT_METRICS_WINDOW_S
    rollback_on_failure: bool = False
    warmup_requests: int = 0  # synthetic warm-up traffic per predictor (0 = off)

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "CanaryPolicy":
        spec = spec or {}
        return cls(
            step=int(spec.get("step", DEFAULT_TRAFFIC_STEP)),
            step_interval_s=float(spec.get("stepInterval", DEFAULT_STEP_INTERVAL_S)),
            max_attempts=int(spec.get("maxAttempts", DEFAULT_MAX_ATTEMPTS)),
            attempt_delay_s=float(spec.get("attemptDelay", DEFAULT_ATTEMPT_DELAY_S)),
            initial_traffic=int(spec.get("initialTraffic", DEFAULT_INITIAL_CANARY_TRAFFIC)),
            metrics_window_s=int(spec.get("metricsWindow", DEFAULT_METRICS_WINDOW_S)),
            rollback_on_failure=bool(spec.get("rollbackOnFailure", False)),
            warmup_requests=int(spec.get("warmupRequests", 0)),
        )

    def __post_init__(self):
        if not (0 < self.step <= 100):
            raise ValueError(f"canary step must be in (0, 100], got {self.step}")
        if not (0 < self.initial_traffic <= 100):
            raise ValueError(
                f"initialTraffic must be in (0, 100], got {self.initial_traffic}"
            )
        if self.max_attempts < 1:
            raise ValueError("maxAttempts must be >= 1")


def _reject_unknown_keys(
    spec: Mapping[str, Any], allowed: frozenset, path: str
) -> None:
    """Fail loudly on unknown spec keys at reconcile time.

    The CRD schema is permissive about extra properties, so a typo'd
    knob (``draftToken`` for ``draftTokens``) used to be SILENTLY
    ignored — the CR applied cleanly and served with the default, the
    worst failure mode for a performance knob.  Rejecting here lands the
    error in CR status (and in the server log at startup), naming both
    the bad key and the accepted set."""
    unknown = sorted(set(spec) - allowed)
    if unknown:
        raise ValueError(
            f"unknown key(s) {unknown} in {path}; "
            f"allowed: {sorted(allowed)}"
        )


def _parse_prefill_batch(value) -> int:
    """``spec.cuda.prefillBatch``: concurrent admissions whose next prompt
    chunks batch into ONE prefill call per engine tick (1 = today's
    one-at-a-time pipeline, byte-for-byte)."""
    batch = int(value) if value is not None else 1
    if batch < 1:
        raise ValueError(
            f"spec.cuda.prefillBatch must be >= 1, got {value!r}"
        )
    return batch


def _parse_prefill_token_budget(value) -> int:
    """``spec.cuda.prefillTokenBudget``: Sarathi-style cap on prompt tokens
    prefilled per engine tick (0 = uncapped); bounds the decode-cadence
    jitter a burst of long prompts can inject."""
    budget = int(value) if value is not None else 0
    if budget < 0:
        raise ValueError(
            f"spec.cuda.prefillTokenBudget must be >= 0, got {value!r}"
        )
    return budget


def _parse_sp_prefill_threshold(value) -> int:
    """``spec.cuda.spPrefillThreshold``: minimum cold-prompt length (in
    tokens) that routes through sequence-parallel ring-attention prefill
    when meshShape carries sp > 1.  Ignored at sp == 1."""
    threshold = int(value) if value is not None else 1024
    if threshold < 1:
        raise ValueError(
            f"spec.cuda.spPrefillThreshold must be >= 1, got {value!r}"
        )
    return threshold


def _parse_prefill_chunk(value) -> int | None:
    """Positivity is checkable here; divisibility into the model's KV
    capacity is not (max_seq lives in the artifact, not the CR) — that
    check runs at server startup, where a violation fails readiness with
    a clear error in the pod log."""
    if not value:
        return None
    chunk = int(value)
    if chunk <= 0:
        raise ValueError(f"spec.cuda.prefillChunk must be positive, got {value!r}")
    return chunk


def _parse_decode_steps(value) -> int:
    """``spec.cuda.decodeSteps``: decode iterations fused into ONE device
    dispatch per engine tick (a ``lax.scan`` with on-device sampling and
    an EOS latch, paired with lag-1 async token readback).  1 — the
    default — is the single-step tick loop byte-for-byte.  Capped at 16:
    over-run work past EOS/budget is bounded by K, and host token
    cadence (SSE flushes, cancellation latency) coarsens with K — past
    16 the dispatch amortization has long since saturated.

    ``decodeSteps`` > 1 combined with ``speculative.enabled`` is NOT an
    error: ticks holding draft proposals run verify (acceptance beats a
    fixed-K scan on draftable text) and draft-less ticks fuse — a
    documented per-slot fallback, not a contradiction."""
    steps = int(value) if value is not None else 1
    if not (1 <= steps <= 16):
        raise ValueError(
            f"spec.cuda.decodeSteps must be in [1, 16], got {value!r}"
        )
    return steps


def _parse_admission_budget(value) -> int:
    """``spec.cuda.admissionQueueBudget``: estimated-token bound on
    queued-but-unadmitted generation work (0 = unbounded, the old
    behavior byte-for-byte); beyond it the server sheds with 429."""
    budget = int(value) if value is not None else 0
    if budget < 0:
        raise ValueError(
            f"spec.cuda.admissionQueueBudget must be >= 0, got {value!r}"
        )
    return budget


def _parse_drain_grace(value) -> float:
    """``spec.cuda.drainGraceSeconds``: in-flight completion bound of the
    lossless drain protocol (SIGTERM / POST /admin/drain).

    Default 20: with the 3s endpoint-removal lag it fits inside
    Kubernetes' DEFAULT 30s terminationGracePeriodSeconds with margin —
    a default-config drain must never be SIGKILLed mid-flight.  Larger
    values make the builder emit a matching pod grace override."""
    grace = float(value) if value is not None else 20.0
    if grace < 0:
        raise ValueError(
            f"spec.cuda.drainGraceSeconds must be >= 0, got {value!r}"
        )
    return grace


@dataclass(frozen=True)
class PrefixCacheSpec:
    """``spec.cuda.prefixCache``: radix-tree prompt-prefix KV reuse.

    ``chunk_tokens`` is the reuse unit and must equal ``prefillChunk``
    when both are set (the server rejects a mismatch at startup); when
    ``prefillChunk`` is unset, enabling the cache turns on chunked
    prefill at ``chunk_tokens``.  Disabled by default: an unannotated CR
    behaves exactly as before.
    """

    enabled: bool = False
    budget_mb: int = 256
    chunk_tokens: int = 64
    # Second-tier host-RAM pool: chunks the first tier evicts spill here
    # (LRU under this budget) and promote back on a radix-walk miss.
    # 0 — the default — is the single-tier behavior byte-for-byte.
    l2_budget_mb: int = 0

    @classmethod
    def from_spec(
        cls,
        spec: Mapping[str, Any] | None,
        prefill_chunk: int | None = None,
    ) -> "PrefixCacheSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec,
            frozenset({"enabled", "budgetMB", "chunkTokens", "l2BudgetMB"}),
            "spec.cuda.prefixCache",
        )
        enabled = bool(spec.get("enabled", False))
        # Unset chunkTokens follows prefillChunk (the common case: one
        # knob already set); an EXPLICIT mismatch is rejected HERE, at
        # reconcile time, so it lands in CR status — not as a server
        # CrashLoopBackOff from GenerationEngine's own guard.
        chunk_tokens = spec.get("chunkTokens")
        if chunk_tokens is None:
            chunk_tokens = prefill_chunk or 64
        chunk_tokens = int(chunk_tokens)
        if (
            enabled
            and prefill_chunk is not None
            and chunk_tokens != prefill_chunk
        ):
            raise ValueError(
                f"prefixCache.chunkTokens {chunk_tokens} must equal "
                f"prefillChunk {prefill_chunk} (the prefill chunk is the "
                "prefix reuse unit); omit chunkTokens to follow prefillChunk"
            )
        return cls(
            enabled=enabled,
            budget_mb=int(spec.get("budgetMB", 256)),
            chunk_tokens=chunk_tokens,
            l2_budget_mb=int(spec.get("l2BudgetMB", 0)),
        )

    def __post_init__(self):
        if self.enabled:
            # Reject at reconcile time, not as a pod CrashLoopBackOff.
            if self.budget_mb < 1:
                raise ValueError(
                    f"prefixCache.budgetMB must be >= 1, got {self.budget_mb}"
                )
            if self.chunk_tokens < 1:
                raise ValueError(
                    "prefixCache.chunkTokens must be >= 1, got "
                    f"{self.chunk_tokens}"
                )
            if self.l2_budget_mb < 0:
                raise ValueError(
                    "prefixCache.l2BudgetMB must be >= 0, got "
                    f"{self.l2_budget_mb}"
                )


@dataclass(frozen=True)
class SpeculativeSpec:
    """``spec.cuda.speculative``: self-speculative n-gram decoding.

    A host-side "prompt lookup" drafter proposes up to ``draft_tokens``
    continuations per slot from the sequence's own history (no draft
    model), and ONE batched verify forward scores all of them — tokens
    emitted per HBM weight stream multiply by the acceptance length
    while output stays bit-identical to plain greedy decode (exact
    argmax acceptance).  Disabled by default: an unannotated CR behaves
    exactly as before.  Greedy traffic only — a tick with any sampling
    slot falls back to the single-token step.
    """

    enabled: bool = False
    draft_tokens: int = 4
    ngram_min: int = 1
    ngram_max: int = 4
    adaptive: bool = True

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "SpeculativeSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec,
            frozenset(
                {"enabled", "draftTokens", "ngramMin", "ngramMax", "adaptive"}
            ),
            "spec.cuda.speculative",
        )
        return cls(
            enabled=bool(spec.get("enabled", False)),
            draft_tokens=int(spec.get("draftTokens", 4)),
            ngram_min=int(spec.get("ngramMin", 1)),
            ngram_max=int(spec.get("ngramMax", 4)),
            adaptive=bool(spec.get("adaptive", True)),
        )

    def __post_init__(self):
        if self.enabled:
            # Reject at reconcile time, not as a pod CrashLoopBackOff.
            if not (1 <= self.draft_tokens <= 64):
                raise ValueError(
                    "speculative.draftTokens must be in [1, 64], got "
                    f"{self.draft_tokens}"
                )
            if not (1 <= self.ngram_min <= self.ngram_max):
                raise ValueError(
                    "speculative ngram bounds must satisfy 1 <= ngramMin "
                    f"<= ngramMax, got [{self.ngram_min}, {self.ngram_max}]"
                )


@dataclass(frozen=True)
class SnapshotSpec:
    """``spec.cuda.snapshot``: pre-baked weight snapshots (scale-to-zero
    fast restore, ``server/snapshot.py``).

    When enabled, the server bakes the post-shard, post-quantize device
    tree into ``dir`` after its first successful cold load and restores
    from it on every later boot/attach with zero transform work; the
    snapshot is invalidated by a content hash of (model version/URI,
    quantize mode, mesh shape).  Required for ``autoscaling.minReplicas:
    0`` — without a restorable snapshot a woken CR would pay the full
    cold path while a request is parked.  Disabled by default: an
    unannotated CR's manifest and load path stay byte-for-byte.
    """

    enabled: bool = False
    dir: str = "/var/cache/tpumlops/snapshots"

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "SnapshotSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec, frozenset({"enabled", "dir"}), "spec.cuda.snapshot"
        )
        return cls(
            enabled=bool(spec.get("enabled", False)),
            dir=str(spec.get("dir", "/var/cache/tpumlops/snapshots")),
        )

    def __post_init__(self):
        if self.enabled and not self.dir:
            # Reject at reconcile time, not as a pod CrashLoopBackOff.
            raise ValueError(
                "snapshot.enabled requires a non-empty snapshot.dir"
            )


@dataclass(frozen=True)
class ObservabilitySpec:
    """``spec.cuda.observability``: engine flight-recorder sizing and the
    device telemetry layer.

    ``trace_ring`` is the bounded in-memory journal's capacity (one ring
    each for engine ticks, request lifecycle events, and completed
    request traces; served at ``/debug/engine`` and ``/debug/trace``).
    0 — the default — creates no recorder at all, so the engine loop
    stays byte-for-byte unobserved.

    ``device_telemetry`` turns on the HBM ledger + compile observatory +
    per-tick MFU/bandwidth accounting (``server/device_telemetry.py``:
    ``GET /debug/device``, ``tpumlops_device_*`` /
    ``tpumlops_compile_*`` series, utilization fields on recorder
    ticks, and a ``status.capacity`` summary on the CR).  False — the
    default — constructs none of it: ticks, metric families, status
    patches, and ``/debug/*`` payloads stay byte-for-byte.

    ``timeseries_ring`` sizes the per-second serving time-series ring
    (``server/timeseries.py``: per-tick-kind wall quantiles, ITL, queue
    depth, MFU/HBM-bandwidth, shed/poison counts, served at
    ``GET /debug/timeseries`` — the anomaly detector's input plane).
    0 — the default — constructs no ring: callbacks, routes, and
    payloads stay byte-for-byte.
    """

    trace_ring: int = 0
    device_telemetry: bool = False
    timeseries_ring: int = 0

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "ObservabilitySpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec,
            frozenset({"traceRing", "deviceTelemetry", "timeseriesRing"}),
            "spec.cuda.observability",
        )
        return cls(
            trace_ring=int(spec.get("traceRing", 0)),
            device_telemetry=bool(spec.get("deviceTelemetry", False)),
            timeseries_ring=int(spec.get("timeseriesRing", 0)),
        )

    def __post_init__(self):
        if self.trace_ring < 0:
            # Reject at reconcile time, not as a pod CrashLoopBackOff.
            raise ValueError(
                "observability.traceRing must be >= 0, got "
                f"{self.trace_ring}"
            )
        # One day of 1 s samples is already ~86 KB of JSON per replica
        # per fleet-overview scrape; anything larger is a typo, not a
        # window.
        if not (0 <= self.timeseries_ring <= 86400):
            raise ValueError(
                "observability.timeseriesRing must be in [0, 86400], got "
                f"{self.timeseries_ring}"
            )


@dataclass(frozen=True)
class AutoscalingSpec:
    """``spec.autoscaling``: SLO-driven horizontal replica scaling.

    The autoscaler (``operator/autoscaler.py``) reads the stable
    predictor's engine saturation signals — queue depth, admission wait,
    TTFT p95 — from the CR's Prometheus and sizes ``replicas`` between
    ``min_replicas`` and ``max_replicas``:

    - ``target_queue_depth_per_replica``: desired replicas =
      ceil(total queue depth / target) — the primary saturation signal;
    - ``target_ttft_seconds``: a TTFT p95 above this adds one replica
      even when the queue target is met (latency pressure without a
      visible backlog, e.g. long prompts);
    - asymmetric hysteresis: scale-up jumps straight to the desired
      count once the demand has persisted ``scale_up_stabilization_s``
      (0 = immediately); scale-down steps ONE replica at a time and only
      after ``scale_down_cooldown_s`` since the last scale event in
      either direction;
    - ``min_replicas: 0`` is serverless scale-to-zero: an idle CR's
      Deployment parks at zero replicas (requires
      ``spec.cuda.snapshot.enabled`` so the wake restore is fast, and is
      rejected on multi-host topologies), the router parks incoming
      requests, and a parked/queued request wakes the CR immediately —
      no stabilization window, a waiting user has already paid it;
    - ``warm_pool_size`` reserves that many ``--warm-pool`` replicas
      (booted, compile-swept, weightless) the wake path can attach a
      snapshot to instead of booting a pod from scratch.

    Disabled (the default) keeps manifests, status patches, and engine
    admission behavior byte-for-byte what they were.
    """

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 1
    target_queue_depth_per_replica: float = 0.0  # <= 0: signal unused
    target_ttft_seconds: float = 0.0  # <= 0: signal unused
    scale_up_stabilization_s: float = 0.0
    scale_down_cooldown_s: float = 300.0
    warm_pool_size: int = 0  # 0 = no warm pool

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "AutoscalingSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec,
            frozenset(
                {
                    "enabled", "minReplicas", "maxReplicas",
                    "targetQueueDepthPerReplica", "targetTTFTSeconds",
                    "scaleUpStabilizationSeconds",
                    "scaleDownCooldownSeconds",
                    "warmPoolSize",
                }
            ),
            "spec.autoscaling",
        )
        return cls(
            enabled=bool(spec.get("enabled", False)),
            min_replicas=int(spec.get("minReplicas", 1)),
            max_replicas=int(spec.get("maxReplicas", 1)),
            target_queue_depth_per_replica=float(
                spec.get("targetQueueDepthPerReplica", 0.0)
            ),
            target_ttft_seconds=float(spec.get("targetTTFTSeconds", 0.0)),
            scale_up_stabilization_s=float(
                spec.get("scaleUpStabilizationSeconds", 0.0)
            ),
            scale_down_cooldown_s=float(
                spec.get("scaleDownCooldownSeconds", 300.0)
            ),
            warm_pool_size=int(spec.get("warmPoolSize", 0)),
        )

    def __post_init__(self):
        # Contradictory specs are rejected at reconcile time so they land
        # in CR status, not as an autoscaler oscillating or parked.
        if self.min_replicas < 0:
            raise ValueError(
                f"autoscaling.minReplicas must be >= 0 (0 = serverless "
                f"scale-to-zero), got {self.min_replicas}"
            )
        if self.max_replicas < 1:
            raise ValueError(
                f"autoscaling.maxReplicas must be >= 1, got "
                f"{self.max_replicas}"
            )
        if not (0 <= self.warm_pool_size <= 16):
            raise ValueError(
                f"autoscaling.warmPoolSize must be in [0, 16], got "
                f"{self.warm_pool_size}"
            )
        if self.min_replicas > self.max_replicas:
            raise ValueError(
                f"autoscaling.minReplicas {self.min_replicas} > "
                f"maxReplicas {self.max_replicas}"
            )
        if self.scale_up_stabilization_s < 0:
            raise ValueError(
                "autoscaling.scaleUpStabilizationSeconds must be >= 0, "
                f"got {self.scale_up_stabilization_s}"
            )
        if self.scale_down_cooldown_s < 0:
            raise ValueError(
                "autoscaling.scaleDownCooldownSeconds must be >= 0, got "
                f"{self.scale_down_cooldown_s}"
            )
        if (
            self.enabled
            and self.target_queue_depth_per_replica <= 0
            and self.target_ttft_seconds <= 0
        ):
            raise ValueError(
                "autoscaling.enabled requires a scaling target: set "
                "targetQueueDepthPerReplica > 0 and/or "
                "targetTTFTSeconds > 0"
            )
        if (
            self.enabled
            and self.min_replicas == 0
            and self.target_queue_depth_per_replica <= 0
        ):
            # The wake signal for a CR at zero is backlog (router-parked
            # + queued requests); a TTFT-only config samples nothing at
            # zero traffic and could never wake.
            raise ValueError(
                "autoscaling.minReplicas: 0 requires "
                "targetQueueDepthPerReplica > 0 (parked/queued backlog "
                "is the wake signal; TTFT alone cannot wake a CR at "
                "zero)"
            )


@dataclass(frozen=True)
class PrefixAffinitySpec:
    """``spec.fleet.prefixAffinity``: route repeat prefixes to the decode
    replica already holding their KV.

    The router hashes the first ``tokens`` prompt ids onto a consistent-
    hash ring over decode-role backends, so a shared template prefix
    lands on the same replica every time — cache hit rate survives
    scale-out instead of diluting 1/N per replica."""

    enabled: bool = True
    tokens: int = 64  # leading prompt ids hashed onto the decode ring

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "PrefixAffinitySpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec, frozenset({"enabled", "tokens"}), "spec.fleet.prefixAffinity"
        )
        return cls(
            enabled=bool(spec.get("enabled", True)),
            tokens=int(spec.get("tokens", 64)),
        )

    def __post_init__(self):
        if self.enabled and not (1 <= self.tokens <= 4096):
            raise ValueError(
                f"fleet.prefixAffinity.tokens must be in [1, 4096], got "
                f"{self.tokens}"
            )


@dataclass(frozen=True)
class KvTransferSpec:
    """``spec.fleet.kvTransfer``: the prefill→decode KV handoff relay.

    ``retries`` is the number of ADDITIONAL prefill replicas the router
    tries after the first export fails (total export attempts =
    1 + retries) before falling back to unified serving — the decode
    replica prefills locally: slower, never lost."""

    enabled: bool = True
    retries: int = 1

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "KvTransferSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec, frozenset({"enabled", "retries"}), "spec.fleet.kvTransfer"
        )
        return cls(
            enabled=bool(spec.get("enabled", True)),
            retries=int(spec.get("retries", 1)),
        )

    def __post_init__(self):
        if not (0 <= self.retries <= 8):
            raise ValueError(
                f"fleet.kvTransfer.retries must be in [0, 8], got "
                f"{self.retries}"
            )


@dataclass(frozen=True)
class FleetObservabilitySpec:
    """``spec.fleet.observability``: the router's fleet trace plane.

    ``journey_ring`` sizes the router's bounded per-request
    JourneyRecord ring (``--journey-ring`` via the
    ``tpumlops.dev/fleet-journey-ring`` manifest annotation and
    RouterSync).  With the ring on, the router adopts-or-mints
    ``X-Request-Id`` + W3C ``traceparent`` on every inbound request,
    propagates them on every outbound leg (forwards, KV relay legs,
    failover retries, park releases), echoes the id on every response,
    and serves the ring at ``/router/debug/requests`` +
    ``/router/debug/trace``.  0 — the default — keeps the router
    byte-for-byte: no header minting, no new metric families, 404 on
    the debug endpoints."""

    journey_ring: int = 0

    @classmethod
    def from_spec(
        cls, spec: Mapping[str, Any] | None
    ) -> "FleetObservabilitySpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec, frozenset({"journeyRing"}), "spec.fleet.observability"
        )
        return cls(journey_ring=int(spec.get("journeyRing", 0)))

    def __post_init__(self):
        # The router serializes the whole ring per debug scrape on its
        # single-threaded event loop; the cap bounds that stall.
        if not (0 <= self.journey_ring <= 1 << 16):
            raise ValueError(
                "fleet.observability.journeyRing must be in "
                f"[0, {1 << 16}], got {self.journey_ring}"
            )


@dataclass(frozen=True)
class FleetSpec:
    """``spec.fleet``: disaggregated prefill/decode replica pools.

    ``disaggregation: true`` splits the predictor into two pools — a
    prefill-heavy one that computes prompt K/V and a decode-heavy one
    that streams tokens — connected by the KV handoff relay
    (``server/kv_transfer.py``) and fronted by the prefix-affinity
    router.  Per-pool ``min``/``max`` bounds let the autoscaler size
    each pool on its own signal (prefill: admission wait; decode:
    queue depth / ITL) instead of one count serving two workloads.

    Disabled (the default) keeps manifests, router behavior, and engine
    ticks byte-for-byte what they were.
    """

    disaggregation: bool = False
    prefill_replicas: int = 1
    decode_replicas: int = 2
    prefill_min_replicas: int = 1
    prefill_max_replicas: int = 1
    decode_min_replicas: int = 1
    decode_max_replicas: int = 1
    # Prefill pool's own scaling signal (0 = pool fixed at its count):
    # admission wait p95 above this adds a prefill replica.
    prefill_target_admission_wait_ms: float = 0.0
    prefix_affinity: PrefixAffinitySpec = field(
        default_factory=PrefixAffinitySpec
    )
    kv_transfer: KvTransferSpec = field(default_factory=KvTransferSpec)
    # Router trace plane: valid WITHOUT disaggregation (a plain canary
    # router benefits from request journeys just as much as a fleet).
    observability: FleetObservabilitySpec = field(
        default_factory=FleetObservabilitySpec
    )

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "FleetSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec,
            frozenset(
                {
                    "disaggregation", "prefillReplicas", "decodeReplicas",
                    "prefillMinReplicas", "prefillMaxReplicas",
                    "decodeMinReplicas", "decodeMaxReplicas",
                    "prefillTargetAdmissionWaitMs",
                    "prefixAffinity", "kvTransfer", "observability",
                }
            ),
            "spec.fleet",
        )
        disagg = bool(spec.get("disaggregation", False))
        prefill = int(spec.get("prefillReplicas", 1 if disagg else 0))
        decode = int(spec.get("decodeReplicas", 2 if disagg else 0))
        if not disagg:
            # A pool size without the mode is a contradiction the CR
            # author must resolve — silently ignoring it would leave
            # them believing a prefill pool exists.
            for key in (
                "prefillReplicas", "decodeReplicas", "prefillMinReplicas",
                "prefillMaxReplicas", "decodeMinReplicas",
                "decodeMaxReplicas",
            ):
                if spec.get(key) is not None:
                    raise ValueError(
                        f"fleet.{key} requires fleet.disaggregation: true"
                    )
        return cls(
            disaggregation=disagg,
            prefill_replicas=prefill,
            decode_replicas=decode,
            prefill_min_replicas=int(
                spec.get("prefillMinReplicas", min(1, prefill))
            ),
            prefill_max_replicas=int(
                spec.get("prefillMaxReplicas", prefill)
            ),
            decode_min_replicas=int(
                spec.get("decodeMinReplicas", min(1, decode))
            ),
            decode_max_replicas=int(spec.get("decodeMaxReplicas", decode)),
            prefill_target_admission_wait_ms=float(
                spec.get("prefillTargetAdmissionWaitMs", 0.0)
            ),
            prefix_affinity=PrefixAffinitySpec.from_spec(
                spec.get("prefixAffinity")
            ),
            kv_transfer=KvTransferSpec.from_spec(spec.get("kvTransfer")),
            observability=FleetObservabilitySpec.from_spec(
                spec.get("observability")
            ),
        )

    def __post_init__(self):
        if not self.disaggregation:
            return
        # Reject contradictions at reconcile time so they land in CR
        # status, not as an empty pool serving 503s.
        if self.prefill_replicas < 1:
            raise ValueError(
                "fleet.disaggregation requires prefillReplicas >= 1, got "
                f"{self.prefill_replicas}"
            )
        if self.decode_replicas < 1:
            raise ValueError(
                "fleet.disaggregation requires decodeReplicas >= 1, got "
                f"{self.decode_replicas}"
            )
        for label, lo, hi, count in (
            (
                "prefill", self.prefill_min_replicas,
                self.prefill_max_replicas, self.prefill_replicas,
            ),
            (
                "decode", self.decode_min_replicas,
                self.decode_max_replicas, self.decode_replicas,
            ),
        ):
            if lo < 0:
                raise ValueError(
                    f"fleet.{label}MinReplicas must be >= 0, got {lo}"
                )
            if hi < 1:
                raise ValueError(
                    f"fleet.{label}MaxReplicas must be >= 1, got {hi}"
                )
            if lo > hi:
                raise ValueError(
                    f"fleet.{label}MinReplicas {lo} > {label}MaxReplicas "
                    f"{hi}"
                )
            if not (lo <= count <= hi):
                raise ValueError(
                    f"fleet.{label}Replicas {count} outside "
                    f"[{label}MinReplicas {lo}, {label}MaxReplicas {hi}]"
                )
        if self.prefill_target_admission_wait_ms < 0:
            raise ValueError(
                "fleet.prefillTargetAdmissionWaitMs must be >= 0, got "
                f"{self.prefill_target_admission_wait_ms}"
            )


@dataclass(frozen=True)
class RolloutObservability:
    """``spec.observability``: rollout decision-journal surfacing on the CR.

    ``history_limit`` bounds ``status.history`` — the per-CR journal of
    gate evaluations and phase transitions the reconciler appends so
    ``kubectl get -o yaml`` alone explains a stalled canary.  0 — the
    default — writes neither ``status.history`` nor ``status.lastGate``,
    keeping status patches byte-for-byte what they were.  The cap of 64
    exists because status lives in etcd (~1.5 MB object limit): a full
    gate record with two raw metric readings is ~1 KB.
    """

    history_limit: int = 0

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "RolloutObservability":
        spec = spec or {}
        _reject_unknown_keys(
            spec, frozenset({"historyLimit"}), "spec.observability"
        )
        return cls(history_limit=int(spec.get("historyLimit", 0)))

    def __post_init__(self):
        if not (0 <= self.history_limit <= 64):
            # Reject at reconcile time so it lands in CR status.
            raise ValueError(
                "observability.historyLimit must be in [0, 64], got "
                f"{self.history_limit}"
            )


@dataclass(frozen=True)
class SloSpec:
    """``spec.slo``: serving objectives the operator accounts against.

    Each configured target becomes one SLO the operator evaluates per
    reconcile step from the metrics it already scrapes — TTFT p99 and
    ITL p99 from the engine series, availability from the router's
    gate histograms — over a rolling ``window_minutes`` window:

    - attainment: fraction of in-window samples meeting the target;
    - burn rate: (1 − attainment) / (1 − objective), where the shared
      objective is ``availability_pct`` (burn 1.0 = consuming the error
      budget exactly as fast as the objective allows);
    - error budget remaining: max(0, 1 − burn rate).

    Exported as ``tpumlops_operator_slo_{attainment,
    error_budget_remaining,burn_rate}{slo=...}`` and journaled as
    ``SloRecord``s beside gate/scale records when budget state changes.
    Absent (the default) — no tracker, no series, no status writes:
    byte-for-byte.
    """

    enabled: bool = False
    ttft_p99_ms: float = 0.0  # 0 = latency target not tracked
    itl_p99_ms: float = 0.0   # 0 = not tracked
    availability_pct: float = 99.0  # the objective percent (all SLOs)
    window_minutes: float = 60.0

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "SloSpec":
        if spec is None:
            return cls()
        _reject_unknown_keys(
            spec,
            frozenset(
                {
                    "ttftP99Ms", "itlP99Ms", "availabilityPct",
                    "windowMinutes",
                }
            ),
            "spec.slo",
        )
        return cls(
            enabled=True,
            ttft_p99_ms=float(spec.get("ttftP99Ms", 0.0)),
            itl_p99_ms=float(spec.get("itlP99Ms", 0.0)),
            availability_pct=float(spec.get("availabilityPct", 99.0)),
            window_minutes=float(spec.get("windowMinutes", 60.0)),
        )

    def __post_init__(self):
        if not self.enabled:
            return
        if self.ttft_p99_ms < 0 or self.itl_p99_ms < 0:
            raise ValueError(
                "slo.ttftP99Ms / slo.itlP99Ms must be >= 0, got "
                f"{self.ttft_p99_ms} / {self.itl_p99_ms}"
            )
        if not (50.0 <= self.availability_pct < 100.0):
            # 100% leaves a zero error budget (division by zero in the
            # burn rate) and below 50% is a typo, not an objective.
            raise ValueError(
                "slo.availabilityPct must be in [50, 100), got "
                f"{self.availability_pct}"
            )
        if not (1.0 <= self.window_minutes <= 1440.0):
            raise ValueError(
                "slo.windowMinutes must be in [1, 1440], got "
                f"{self.window_minutes}"
            )

    @property
    def slo_names(self) -> tuple:
        """The SLOs this spec tracks, in evaluation order (values of the
        ``slo`` metric label and ``SloRecord.slo``)."""
        names = []
        if self.ttft_p99_ms > 0:
            names.append("ttft_p99")
        if self.itl_p99_ms > 0:
            names.append("itl_p99")
        names.append("availability")  # always tracked when enabled
        return tuple(names)


@dataclass(frozen=True)
class AnomalySpec:
    """``spec.anomaly``: the fleet anomaly detector (operator/anomaly.py).

    Present (any value, even ``{}``) arms a per-reconcile detection pass
    over the fleet's time-series ring snapshots: robust peer comparison
    (median/MAD z-score of each replica's ITL / MFU / queue slope
    against the other replicas of the same pool → straggler verdicts)
    plus self-baseline drift (the current window vs the post-warmup /
    post-attach baseline window).  Verdicts are journaled as
    ``AnomalyRecord``s, published at ``status.anomalies``, exported as
    ``tpumlops_operator_anomaly_{active,events_total}``, and fed into
    the multiplexer's eviction scoring and the autoscaler's scale-down
    victim choice.  Requires ``spec.cuda.observability.timeseriesRing``
    > 0 (the rings ARE the input plane).  Absent (the default) — no
    detector, no series, no status writes, identical mux/autoscaler
    decisions: byte-for-byte.
    """

    enabled: bool = False
    mad_threshold: float = 3.5  # |robust z| beyond which a peer straggles
    drift_pct: float = 25.0  # self-baseline drift trigger (0 = off)
    min_peers: int = 3  # below this: no peer verdicts at all
    window_s: int = 30  # trailing comparison window (ring seconds)
    baseline_s: int = 30  # baseline window (post-warmup/attach seconds)

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "AnomalySpec":
        if spec is None:
            return cls()
        _reject_unknown_keys(
            spec,
            frozenset(
                {
                    "madThreshold", "driftPct", "minPeers", "windowSeconds",
                    "baselineSeconds",
                }
            ),
            "spec.anomaly",
        )
        return cls(
            enabled=True,
            mad_threshold=float(spec.get("madThreshold", 3.5)),
            drift_pct=float(spec.get("driftPct", 25.0)),
            min_peers=int(spec.get("minPeers", 3)),
            window_s=int(spec.get("windowSeconds", 30)),
            baseline_s=int(spec.get("baselineSeconds", 30)),
        )

    def __post_init__(self):
        if not self.enabled:
            return
        if self.mad_threshold <= 0:
            raise ValueError(
                "anomaly.madThreshold must be > 0, got "
                f"{self.mad_threshold}"
            )
        if self.drift_pct < 0:
            raise ValueError(
                f"anomaly.driftPct must be >= 0 (0 disables drift "
                f"detection), got {self.drift_pct}"
            )
        if self.min_peers < 3:
            # Median/MAD of two peers is degenerate (MAD of a pair is
            # half their spread; every pair member is its own outlier) —
            # the detector hard-refuses verdicts below 3, so a smaller
            # spec value is a contradiction, not a tuning choice.
            raise ValueError(
                f"anomaly.minPeers must be >= 3, got {self.min_peers}"
            )
        if not (5 <= self.window_s <= 3600):
            raise ValueError(
                f"anomaly.windowSeconds must be in [5, 3600], got "
                f"{self.window_s}"
            )
        if not (5 <= self.baseline_s <= 3600):
            raise ValueError(
                f"anomaly.baselineSeconds must be in [5, 3600], got "
                f"{self.baseline_s}"
            )


# Objective keys the offline planner (operator/planner.py) can search
# against.  Unknown keys reject HERE (a typo'd objective must land in CR
# status); an objective the knob space cannot meet rejects in the planner
# as a typed InfeasibleObjectiveError.
PLANNER_OBJECTIVE_KEYS = frozenset({"ttftP99Ms"})


@dataclass(frozen=True)
class PlannerSpec:
    """``spec.planner``: the offline SLO planner (operator/planner.py).

    The planner replays a journey-ring trace (``/router/debug/requests``
    export: ``tracePath`` to a file, or ``trace`` inline) through an
    analytic cost model and searches the knob space — decodeSteps,
    speculative, prefillBatch/prefillTokenBudget, quantize, cache slots,
    meshShape chips-vs-replicas — for the cheapest configuration
    (chip-seconds) meeting ``objective``.  ``applyMode: suggest`` (the
    default) writes the costed plan to ``status.plan`` and nothing else
    — manifests stay byte-for-byte; ``apply`` also rebuilds the data
    plane with the chosen knobs.  Disabled (the default) — no plan, no
    status writes: byte-for-byte.
    """

    enabled: bool = False
    apply_mode: str = "suggest"  # suggest | apply
    objective: Mapping[str, float] = field(default_factory=dict)
    trace_path: str | None = None
    trace: Mapping[str, Any] | None = None
    # Optional model-profile overrides for the analytic cost model
    # (layers/hidden/heads/...); absent fields take the planner's
    # 7B-class defaults.
    model: Mapping[str, Any] | None = None

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "PlannerSpec":
        if spec is None:
            return cls()
        _reject_unknown_keys(
            spec,
            frozenset(
                {"enabled", "applyMode", "objective", "tracePath",
                 "trace", "model"}
            ),
            "spec.planner",
        )
        objective = dict(spec.get("objective") or {})
        _reject_unknown_keys(
            objective, PLANNER_OBJECTIVE_KEYS, "spec.planner.objective"
        )
        return cls(
            enabled=bool(spec.get("enabled", False)),
            apply_mode=str(spec.get("applyMode", "suggest")),
            objective={k: float(v) for k, v in objective.items()},
            trace_path=(
                str(spec["tracePath"])
                if spec.get("tracePath") is not None
                else None
            ),
            trace=spec.get("trace"),
            model=spec.get("model"),
        )

    def __post_init__(self):
        if self.apply_mode not in ("suggest", "apply"):
            raise ValueError(
                "planner.applyMode must be 'suggest' or 'apply', got "
                f"{self.apply_mode!r}"
            )
        if not self.enabled:
            return
        if not self.objective:
            raise ValueError(
                "planner.enabled requires planner.objective (e.g. "
                "{ttftP99Ms: 250})"
            )
        for key, value in self.objective.items():
            if value <= 0:
                raise ValueError(
                    f"planner.objective.{key} must be > 0, got {value}"
                )
        if self.trace_path is None and self.trace is None:
            raise ValueError(
                "planner.enabled requires a trace source: tracePath (a "
                "/router/debug/requests export on disk) or trace (the "
                "export inline)"
            )


# Mirrors parallel.mesh.MESH_AXIS_ORDER without importing torch into the
# operator process (tests pin the two tuples equal).
MESH_AXES = ("dp", "pp", "ep", "sp", "tp")


def _parse_mesh_shape(value) -> dict:
    """Structural meshShape validation at reconcile time: unknown axis
    names and non-positive sizes must land in CR status, not as a pod
    CrashLoopBackOff at the server's build_mesh.

    An absent meshShape defaults to ``{"dp": 1, "tp": 1}`` — product 1,
    i.e. NO mesh — matching the server's ``--mesh-shape`` default, so
    the manifest the operator renders and the engine the pod builds
    agree byte-for-byte when the field is omitted (the old ``tp: 8``
    fallback silently demanded an 8-card unit from a CR that never
    asked for sharding)."""
    mesh = dict(value or {"dp": 1, "tp": 1})
    unknown = set(mesh) - set(MESH_AXES)
    if unknown:
        raise ValueError(
            f"spec.cuda.meshShape has unknown axes {sorted(unknown)}; "
            f"known: {list(MESH_AXES)}"
        )
    out = {}
    for axis, size in mesh.items():
        try:
            n = int(size)
        except (TypeError, ValueError):
            raise ValueError(
                f"spec.cuda.meshShape.{axis} must be a positive integer, "
                f"got {size!r}"
            ) from None
        if n < 1:
            raise ValueError(
                f"spec.cuda.meshShape.{axis} must be >= 1, got {n}"
            )
        out[axis] = n
    return out


def validate_mesh_for_model(
    mesh_shape: Mapping[str, int] | None,
    *,
    num_kv_heads: int | None = None,
    num_heads: int | None = None,
    intermediate_size: int | None = None,
    vocab_size: int | None = None,
    cache_rows: int | None = None,
    prefill_chunk: int | None = None,
    chip_count: int | None = None,
) -> None:
    """Reject a ``meshShape`` the model/serving geometry cannot shard —
    typed, naming the knob and the offending count.

    Without this the mismatch surfaces as an opaque shape error at
    the first dispatch (after the weights already streamed).  The
    KV-head count is the binding constraint for ``tp`` (the cache's
    heads axis is what decode shards); heads/mlp/vocab ride along so
    every sharded matrix is covered by one message shape.  ``dp`` must
    divide the cache-row count (``cache_rows``, i.e. maxSlots — each dp
    shard owns B/dp rows), ``sp`` the prefill chunk size
    (``prefill_chunk`` — ring attention splits the sequence axis
    evenly), and the total ``dp*pp*ep*sp*tp`` must fit ``chip_count``
    when given.  Called by the server loader and the generation engine
    with the artifact's geometry in hand; the operator applies the
    structural half (:func:`_parse_mesh_shape`) at reconcile, where the
    artifact is not yet readable.
    """
    mesh = dict(mesh_shape or {})
    tp = int(mesh.get("tp", 1))
    dp = int(mesh.get("dp", 1))
    sp = int(mesh.get("sp", 1))
    if chip_count is not None:
        total = 1
        for v in mesh.values():
            total *= int(v)
        if total > int(chip_count):
            raise ValueError(
                f"spec.cuda.meshShape {mesh} uses {total} devices but the "
                f"topology provides only {int(chip_count)} cards; "
                "dp*pp*ep*sp*tp must not exceed the topology or the pod is "
                "unschedulable"
            )
    if dp > 1 and cache_rows is not None and int(cache_rows) % dp != 0:
        raise ValueError(
            f"spec.cuda.meshShape dp={dp} does not divide the KV-cache "
            f"row count (maxSlots) = {int(cache_rows)}; each dp shard "
            "owns rows/dp cache rows — pick a maxSlots that dp divides "
            "(or dp: 1)"
        )
    if sp > 1 and prefill_chunk is not None and int(prefill_chunk) % sp != 0:
        raise ValueError(
            f"spec.cuda.meshShape sp={sp} does not divide the prefill "
            f"chunk size (prefillChunk) = {int(prefill_chunk)}; ring "
            "attention splits the sequence axis into sp equal shards — "
            "pick a chunk that sp divides (or sp: 1)"
        )
    if tp <= 1:
        return
    checks = (
        ("KV-head count (num_kv_heads)", num_kv_heads),
        ("attention-head count (num_heads)", num_heads),
        ("MLP width (intermediate_size)", intermediate_size),
        ("vocab size (vocab_size)", vocab_size),
    )
    for label, count in checks:
        if count is None:
            continue
        if int(count) % tp != 0:
            raise ValueError(
                f"spec.cuda.meshShape tp={tp} does not divide the model's "
                f"{label} = {int(count)}; pick a tp that divides it (or "
                "tp: 1) — an indivisible axis cannot shard and would "
                "fail as a shape error at first dispatch"
            )


def _parse_quantize(value) -> str:
    """Reject bad quantize values at reconcile time — a typo'd CR field must
    surface in status, not as a pod CrashLoopBackOff at argparse."""
    mode = str(value).lower()
    if mode not in ("none", "int8", "int8kv"):
        raise ValueError(
            f"spec.cuda.quantize must be 'none', 'int8', or 'int8kv', "
            f"got {value!r}"
        )
    return mode


@dataclass(frozen=True)
class CudaSpec:
    """GPU data-plane placement and serving knobs (``spec.cuda``): the
    JAX package's ``TpuSpec`` with its fields, defaults and validation.

    ``mesh_shape`` maps logical mesh axis names to sizes, e.g.
    ``{"dp": 1, "tp": 8}`` for a Llama-2-7B tensor-sharded across an
    ``h100-8`` node.  ``topology`` names an entry of
    :data:`GPU_TOPOLOGIES`; the builder turns it into the
    ``nvidia.com/gpu`` request, a nodeSelector and a toleration.
    """

    topology: str = "h100-8"
    mesh_shape: Mapping[str, int] = field(default_factory=lambda: {"dp": 1, "tp": 1})
    replicas: int = 1
    dtype: str = "bfloat16"
    max_batch_size: int = 32
    max_batch_delay_ms: float = 5.0
    # Continuous-batching decode slots.  None = min(max_batch_size, 8), a
    # conservative latency-first default; throughput deployments should
    # raise it — decode streams the full weights per step, so tok/s rises
    # near-linearly with slots until the KV cache dominates HBM traffic
    # (measured curve in bench.py llama_decode.slot_ladder).
    max_slots: int | None = None
    # Batches allowed in flight on the device at once (async dispatch
    # double-buffering): while batch N executes, batch N+1 is stacked and
    # dispatched.  1 = fully serial (the pre-pipelining behavior).
    max_inflight_batches: int = 2
    compile_cache_dir: str | None = "/tmp/jax_compile_cache"
    quantize: str = "none"  # none | int8 (weights) | int8kv (weights+KV cache)
    prefill_chunk: int | None = None  # chunked prefill (decode interleaving)
    # Packed multi-admission prefill: concurrent admissions' next chunks
    # batch into ONE prefill call, amortizing the per-chunk HBM weight
    # stream across waiting prompts (TTFT under bursty load).  1 = the
    # single-admission pipeline, byte-for-byte.  > 1 requires chunked
    # prefill (prefillChunk, or prefixCache which implies it).
    prefill_batch: int = 1
    # Prompt tokens prefilled per engine tick (0 = uncapped): caps how
    # much prefill work a tick may batch so in-flight decode streams
    # keep their token cadence under long-prompt bursts (Sarathi-style).
    prefill_token_budget: int = 0
    # Sequence-parallel ring-attention prefill (meshShape sp > 1): cold
    # prompts at least this many tokens long prefill with the sequence
    # axis split across the sp cards (ops/ring_attention.py) instead of
    # the chunked/fused single-device path.  Ignored when sp == 1.
    sp_prefill_threshold: int = 1024
    # Radix prefix KV cache: shared prompt prefixes (system prompts, chat
    # templates) prefill once and are copied thereafter.
    prefix_cache: PrefixCacheSpec = field(default_factory=PrefixCacheSpec)
    # Pre-baked weight snapshots (server/snapshot.py): the post-shard,
    # post-quantize device tree on disk, restored with zero transform
    # work — the scale-to-zero wake path's fast restore.
    snapshot: SnapshotSpec = field(default_factory=SnapshotSpec)
    # Self-speculative n-gram decoding: batched multi-token verify
    # amortizes the per-tick HBM weight stream over accepted drafts.
    speculative: SpeculativeSpec = field(default_factory=SpeculativeSpec)
    # Fused multi-step decode: K decode iterations per device dispatch
    # (on-device sampling chain + EOS latch) with lag-1 async token
    # readback — collapses per-token host dispatch overhead by ~K when
    # the scheduler owes nothing else.  1 = single-step loop,
    # byte-for-byte.  Composes with speculative per slot (draft ticks
    # verify, draft-less ticks fuse) — see _parse_decode_steps.
    decode_steps: int = 1
    # Unified ragged super-step: ONE jit program per engine tick covers
    # packed-prefill chunk commits, fused-K decode with on-device
    # sampling chains, and speculative verify simultaneously (per-row
    # role tensors), collapsing the warmup sweep to one variant per
    # (window-bucket x sampling-mode).  False — the default — keeps the
    # split-program legacy engine byte-for-byte.
    unified_step: bool = False
    # Engine flight recorder (per-tick journal + request traces at
    # /debug/engine and /debug/trace); traceRing 0 = off, zero overhead.
    observability: ObservabilitySpec = field(default_factory=ObservabilitySpec)
    # Warm the FULL batch x seq-length compile grid at startup instead of
    # the edges (batch 1 / max per length).  Costs |batch buckets| x
    # |length buckets| cold compiles; buys zero first-hit compile stalls
    # even with a cold persistent cache.
    warmup_full_grid: bool = False
    # Server-side admission control: shed /generate submissions with
    # 429 + Retry-After once the estimated tokens (prompt + max_new) of
    # queued-but-unadmitted work would exceed this budget.  0 (default)
    # = unbounded queue, byte-for-byte the old admission behavior.
    # Sheds keep p99 TTFT bounded under overload and give the replica
    # autoscaler a loss-free pressure valve while new replicas boot.
    admission_queue_budget: int = 0
    # Lossless-drain window: on SIGTERM / POST /admin/drain the server
    # stops admissions (new requests shed 429), flips /readyz, and waits
    # up to this many seconds for in-flight sequences to finish before
    # teardown — scale-down and rollout teardown never drop a request.
    # 20 (not 30): + the 3s endpoint lag it fits Kubernetes' default
    # 30s termination grace; larger values emit a pod grace override.
    drain_grace_s: float = 20.0
    # Default SLO class for requests that don't carry one (interactive |
    # batch | best-effort).  Setting it arms the engine's priority
    # admission queues: higher classes drain first, lower classes shed
    # at a fraction of the admission budget.  None (the default) leaves
    # the single-queue admission path byte-for-byte.  Top-level
    # spec.sloClass is the CRD spelling; spec.cuda.sloClass the low-level
    # one (top-level wins when both are set).
    slo_class: str | None = None
    # Mid-decode preemption: a waiting higher-class request may evict a
    # lower-class slot at a tick boundary — its K/V is written back
    # through the radix prefix cache, the record requeued at the front
    # of its class, and restored on re-admission with no lost work.
    # Requires prefixCache.enabled (the cache IS the parking surface).
    preemption: bool = False

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "CudaSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec,
            frozenset(
                {
                    "gpuTopology", "meshShape", "replicas", "dtype",
                    "maxBatchSize", "maxBatchDelayMs", "maxSlots",
                    "maxInflightBatches", "compileCacheDir", "quantize",
                    "prefillChunk", "prefillBatch", "prefillTokenBudget",
                    "spPrefillThreshold",
                    "prefixCache", "speculative", "decodeSteps",
                    "unifiedStep", "observability", "snapshot",
                    "warmupFullGrid", "admissionQueueBudget",
                    "drainGraceSeconds", "sloClass", "preemption",
                }
            ),
            "spec.cuda",
        )
        mesh = _parse_mesh_shape(spec.get("meshShape"))
        prefill_chunk = _parse_prefill_chunk(spec.get("prefillChunk"))
        prefill_batch = _parse_prefill_batch(spec.get("prefillBatch"))
        prefix_cache = PrefixCacheSpec.from_spec(
            spec.get("prefixCache"), prefill_chunk=prefill_chunk
        )
        if (
            prefill_batch > 1
            and prefill_chunk is None
            and not prefix_cache.enabled
        ):
            # Reject at reconcile time, not as a pod CrashLoopBackOff:
            # packed admission batches CHUNKS, so a chunk size must exist.
            raise ValueError(
                f"spec.cuda.prefillBatch {prefill_batch} requires chunked "
                "prefill: set prefillChunk (or enable prefixCache, which "
                "implies it)"
            )
        slo_class = spec.get("sloClass")
        if slo_class is not None:
            slo_class = str(slo_class)
            if slo_class not in SLO_CLASSES:
                raise ValueError(
                    f"spec.cuda.sloClass must be one of {list(SLO_CLASSES)}, "
                    f"got {slo_class!r}"
                )
        preemption = bool(spec.get("preemption", False))
        if preemption and not prefix_cache.enabled:
            # The evicted slot's K/V parks in the radix cache; without it
            # preemption would have to discard decoded work.
            raise ValueError(
                "spec.cuda.preemption requires spec.cuda.prefixCache.enabled "
                "(an evicted slot's K/V is written back through the radix "
                "prefix cache and restored from it on re-admission)"
            )
        return cls(
            topology=str(spec.get("gpuTopology", "h100-8")),
            mesh_shape=mesh,
            replicas=int(spec.get("replicas", 1)),
            dtype=str(spec.get("dtype", "bfloat16")),
            max_batch_size=int(spec.get("maxBatchSize", 32)),
            max_batch_delay_ms=float(spec.get("maxBatchDelayMs", 5.0)),
            max_slots=(
                int(spec["maxSlots"]) if spec.get("maxSlots") is not None else None
            ),
            max_inflight_batches=int(spec.get("maxInflightBatches", 2)),
            compile_cache_dir=spec.get("compileCacheDir", "/tmp/jax_compile_cache"),
            quantize=_parse_quantize(spec.get("quantize", "none")),
            prefill_chunk=prefill_chunk,
            prefill_batch=prefill_batch,
            prefill_token_budget=_parse_prefill_token_budget(
                spec.get("prefillTokenBudget")
            ),
            sp_prefill_threshold=_parse_sp_prefill_threshold(
                spec.get("spPrefillThreshold")
            ),
            prefix_cache=prefix_cache,
            snapshot=SnapshotSpec.from_spec(spec.get("snapshot")),
            speculative=SpeculativeSpec.from_spec(spec.get("speculative")),
            decode_steps=_parse_decode_steps(spec.get("decodeSteps")),
            unified_step=bool(spec.get("unifiedStep", False)),
            observability=ObservabilitySpec.from_spec(
                spec.get("observability")
            ),
            warmup_full_grid=bool(spec.get("warmupFullGrid", False)),
            admission_queue_budget=_parse_admission_budget(
                spec.get("admissionQueueBudget")
            ),
            drain_grace_s=_parse_drain_grace(spec.get("drainGraceSeconds")),
            slo_class=slo_class,
            preemption=preemption,
        )

    @property
    def num_devices(self) -> int:
        n = 1
        for v in self.mesh_shape.values():
            n *= int(v)
        return n


@dataclass(frozen=True)
class MultiplexSpec:
    """``spec.multiplex``: opt this CR into a shared warm-pool fleet.

    ``poolRef`` names the shared pool (a plain convention string — every
    CR naming the same pool in the same namespace is bin-packed onto
    that pool's warm replicas by ``operator/multiplexer.py``).
    ``weight`` biases the packer's traffic score: a weight-2 model wins
    a replica over a weight-1 model at equal observed traffic.

    A multiplexed model owns NO replica of its own: with zero traffic
    it holds nothing (its requests park at the router), and the packer
    attaches it to a pool replica via the warm-pool admin endpoint when
    parked/queued traffic appears.  Absent (the default) keeps
    manifests, router behavior, and metrics byte-for-byte unchanged.
    """

    pool_ref: str | None = None
    weight: float = 1.0

    @property
    def enabled(self) -> bool:
        return self.pool_ref is not None

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "MultiplexSpec":
        spec = spec or {}
        _reject_unknown_keys(
            spec, frozenset({"poolRef", "weight"}), "spec.multiplex"
        )
        pool_ref = spec.get("poolRef")
        if pool_ref is not None:
            pool_ref = str(pool_ref)
            if not pool_ref:
                raise ValueError("multiplex.poolRef must be non-empty")
        elif spec.get("weight") is not None:
            # A weight without a pool is a contradiction the CR author
            # must resolve — silently ignoring it would leave them
            # believing the model is multiplexed.
            raise ValueError("multiplex.weight requires multiplex.poolRef")
        return cls(
            pool_ref=pool_ref,
            weight=float(spec.get("weight", 1.0)),
        )

    def __post_init__(self):
        if self.enabled and not (self.weight > 0):
            raise ValueError(
                f"multiplex.weight must be > 0, got {self.weight}"
            )


@dataclass(frozen=True)
class OperatorConfig:
    """Full parsed ``MlflowModel`` spec.

    Reference spec fields (``crd.yaml:17-25``): ``modelName``, ``modelAlias``,
    ``monitoringInterval``, ``minioSecret``.  Everything else is a rebuild
    addition with reference-equivalent defaults.
    """

    model_name: str
    model_alias: str
    monitoring_interval_s: float = DEFAULT_MONITORING_INTERVAL_S
    minio_secret: str | None = None
    backend: str = "seldon"  # "seldon" (reference parity) | "cuda" (first-party)
    artifact_root: str = DEFAULT_ARTIFACT_ROOT
    prometheus_url: str = DEFAULT_PROMETHEUS_URL
    thresholds: GateThresholds = field(default_factory=GateThresholds)
    canary: CanaryPolicy = field(default_factory=CanaryPolicy)
    cuda: CudaSpec = field(default_factory=CudaSpec)
    server_image: str = DEFAULT_SERVER_IMAGE
    # Rollout journal surfacing on CR status (status.lastGate/history);
    # distinct from spec.cuda.observability, which sizes the data plane's
    # engine flight recorder.
    observability: RolloutObservability = field(
        default_factory=RolloutObservability
    )
    # SLO-driven replica autoscaling (operator/autoscaler.py); disabled
    # default = manifests and status byte-for-byte unchanged.
    autoscaling: AutoscalingSpec = field(default_factory=AutoscalingSpec)
    # Disaggregated prefill/decode pools with KV handoff and prefix-
    # affinity routing; disabled default = byte-for-byte.
    fleet: FleetSpec = field(default_factory=FleetSpec)
    # Serving objectives (error-budget accounting in operator/slo.py);
    # absent default = no tracker, no series, byte-for-byte.
    slo: SloSpec = field(default_factory=SloSpec)
    # Offline SLO planner (operator/planner.py): trace replay + knob
    # search behind spec.planner; disabled default = byte-for-byte.
    planner: PlannerSpec = field(default_factory=PlannerSpec)
    # Multi-model multiplexing on a shared warm pool
    # (operator/multiplexer.py); absent default = byte-for-byte.
    multiplex: MultiplexSpec = field(default_factory=MultiplexSpec)
    # Fleet anomaly detector (operator/anomaly.py): straggler + drift
    # verdicts over time-series ring snapshots; absent default = no
    # detector, no series, byte-for-byte.
    anomaly: AnomalySpec = field(default_factory=AnomalySpec)

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any]) -> "OperatorConfig":
        model_name = spec.get("modelName")
        model_alias = spec.get("modelAlias")
        if not model_name or not model_alias:
            raise ValueError("spec.modelName and spec.modelAlias are required")
        backend = str(spec.get("backend", "seldon"))
        if backend == "tpu":
            raise ValueError(
                "spec.backend 'tpu' is the JAX package's data plane; this "
                "package serves backend: cuda (spec.cuda, gpuTopology)"
            )
        if backend not in ("seldon", "cuda"):
            raise ValueError(f"spec.backend must be 'seldon' or 'cuda', got {backend!r}")
        if "tpu" in spec:
            raise ValueError(
                "spec.tpu is the JAX package's data-plane spec; this package "
                "reads spec.cuda"
            )
        cuda = CudaSpec.from_spec(spec.get("cuda"))
        # Top-level spec.sloClass is the CRD spelling of the data plane's
        # default class — authoritative over spec.cuda.sloClass when both
        # are set (the cuda key exists so the server CLI round-trips).
        top_slo = spec.get("sloClass")
        if top_slo is not None:
            top_slo = str(top_slo)
            if top_slo not in SLO_CLASSES:
                raise ValueError(
                    f"spec.sloClass must be one of {list(SLO_CLASSES)}, "
                    f"got {top_slo!r}"
                )
            cuda = replace(cuda, slo_class=top_slo)
        autoscaling = AutoscalingSpec.from_spec(spec.get("autoscaling"))
        fleet = FleetSpec.from_spec(spec.get("fleet"))
        if fleet.disaggregation:
            if backend != "cuda":
                raise ValueError(
                    "fleet.disaggregation requires backend: cuda (the "
                    "Seldon backend has no KV handoff data plane)"
                )
            if not cuda.prefix_cache.enabled:
                # The handoff wire format IS the radix cache's chunk —
                # without the cache there is nothing to export, seed, or
                # route affinity for.
                raise ValueError(
                    "fleet.disaggregation requires spec.cuda.prefixCache."
                    "enabled (handed-off K/V re-enters the decode replica "
                    "through the radix prefix cache's seed path)"
                )
            if fleet.prefill_min_replicas == 0 and not cuda.snapshot.enabled:
                raise ValueError(
                    "fleet.prefillMinReplicas: 0 requires spec.cuda."
                    "snapshot.enabled (a prefill pool woken from zero "
                    "must restore pre-baked weights while the cold "
                    "prompt waits; without a snapshot it pays the full "
                    "cold load)"
                )
        anomaly = AnomalySpec.from_spec(spec.get("anomaly"))
        if anomaly.enabled and cuda.observability.timeseries_ring <= 0:
            # The detector's ONLY input plane is the per-replica ring —
            # without one it would silently never fire, the worst
            # failure mode for a health check.
            raise ValueError(
                "spec.anomaly requires spec.cuda.observability."
                "timeseriesRing > 0 (the detector compares replicas over "
                "their time-series ring snapshots; without rings there "
                "is nothing to detect from)"
            )
        multiplex = MultiplexSpec.from_spec(spec.get("multiplex"))
        if multiplex.enabled:
            if backend != "cuda":
                raise ValueError(
                    "spec.multiplex requires backend: cuda (the Seldon "
                    "backend has no warm-pool attach data plane)"
                )
            if not cuda.snapshot.enabled:
                raise ValueError(
                    "spec.multiplex requires spec.cuda.snapshot.enabled "
                    "(the shared pool attaches models by snapshot "
                    "restore; without one every swap pays the full "
                    "cold load)"
                )
            if fleet.disaggregation:
                raise ValueError(
                    "spec.multiplex with fleet.disaggregation is not "
                    "supported: the shared pool multiplexes unified "
                    "replicas, not split prefill/decode pools"
                )
        if (
            autoscaling.enabled
            and autoscaling.min_replicas == 0
            and not cuda.snapshot.enabled
        ):
            # Scale-to-zero without a restorable snapshot means every
            # wake pays the full cold path while a request is parked —
            # the exact failure scale-to-zero exists to prevent.
            raise ValueError(
                "autoscaling.minReplicas: 0 requires spec.cuda.snapshot."
                "enabled (the wake path restores pre-baked weights; "
                "without a snapshot the parked request would wait out a "
                "full cold load)"
            )
        if autoscaling.warm_pool_size > 0 and not cuda.snapshot.enabled:
            raise ValueError(
                "autoscaling.warmPoolSize > 0 requires spec.cuda."
                "snapshot.enabled (warm-pool replicas attach models by "
                "snapshot restore)"
            )
        if backend == "cuda":
            info = GPU_TOPOLOGIES.get(cuda.topology)
            if info is None:
                raise ValueError(
                    f"unknown gpuTopology {cuda.topology!r}; known: "
                    f"{sorted(GPU_TOPOLOGIES)}"
                )
            info.check_mesh(cuda.topology, cuda.mesh_shape)
            # Serving-geometry axes are checkable at reconcile (the
            # model's head counts are not — the loader re-validates with
            # the artifact in hand): dp must divide the cache-row count,
            # sp the prefill chunk.
            validate_mesh_for_model(
                cuda.mesh_shape,
                cache_rows=cuda.max_slots,
                prefill_chunk=cuda.prefill_chunk,
                chip_count=info.cards,
            )
            if info.hosts > 1 and cuda.replicas > 1:
                raise ValueError(
                    f"replicas={cuda.replicas} with multi-host topology "
                    f"{cuda.topology!r} is not supported yet: one worker "
                    "unit per predictor version; scale out with more "
                    "MlflowModel CRs or a larger topology"
                )
            if info.hosts > 1 and autoscaling.max_replicas > 1:
                # Same constraint the builder enforces for replicas > 1:
                # a multi-host unit is one StatefulSet per predictor, so
                # the autoscaler cannot fan it out either.
                raise ValueError(
                    f"autoscaling.maxReplicas={autoscaling.max_replicas} "
                    f"with multi-host topology {cuda.topology!r} is not "
                    "supported: one worker unit per predictor version; "
                    "scale out with more MlflowModel CRs or a larger "
                    "topology"
                )
            if info.hosts > 1 and fleet.disaggregation:
                # A pool replica is one pod; a multi-host unit is N pods
                # forming one process group — neither pool machinery nor
                # the per-replica KV handoff models that.
                raise ValueError(
                    f"fleet.disaggregation with multi-host topology "
                    f"{cuda.topology!r} is not supported: pools scale "
                    "single-host replicas; use a larger topology or more "
                    "MlflowModel CRs"
                )
            if info.hosts > 1 and multiplex.enabled:
                raise ValueError(
                    f"spec.multiplex with multi-host topology "
                    f"{cuda.topology!r} is not supported: the shared "
                    "pool attaches by single-host snapshot restore"
                )
            if info.hosts > 1 and (
                autoscaling.min_replicas == 0
                or autoscaling.warm_pool_size > 0
            ):
                # Snapshots store a single-device tree; a multi-host
                # unit's weights are distributed across hosts, so wake-
                # from-zero cannot restore it (and a parked unit would
                # strand the follower process group mid-collective).
                raise ValueError(
                    f"scale-to-zero (autoscaling.minReplicas: 0 / "
                    f"warmPoolSize > 0) with multi-host topology "
                    f"{cuda.topology!r} is not supported: the snapshot "
                    "restore path is single-host; scale out with more "
                    "MlflowModel CRs or keep minReplicas >= 1"
                )
        slo = SloSpec.from_spec(spec.get("slo"))
        planner = PlannerSpec.from_spec(spec.get("planner"))
        # What the port cannot serve yet is refused last, after every check
        # the JAX package makes: a spec it rejects fails here the same way.
        if backend == "cuda" and GPU_TOPOLOGIES[cuda.topology].cards > 1:
            raise NotYetPorted(
                f"spec.cuda.gpuTopology {cuda.topology!r} "
                f"({GPU_TOPOLOGIES[cuda.topology].cards} cards): "
                f"{MULTI_CARD_REFUSAL}; use h100-1"
            )
        for field_name, on in (
            ("spec.slo", slo.enabled),
            ("spec.planner", planner.enabled),
            ("spec.anomaly", anomaly.enabled),
            ("spec.multiplex", bool(spec.get("multiplex"))),
        ):
            if on:
                raise NotYetPorted(
                    f"{field_name}: not yet ported (its operator module "
                    "comes with a later control-plane slice)"
                )
        return cls(
            model_name=str(model_name),
            model_alias=str(model_alias),
            monitoring_interval_s=float(
                spec.get("monitoringInterval", DEFAULT_MONITORING_INTERVAL_S)
            ),
            minio_secret=spec.get("minioSecret"),
            backend=backend,
            artifact_root=str(spec.get("artifactRoot", DEFAULT_ARTIFACT_ROOT)),
            prometheus_url=str(spec.get("prometheusUrl", DEFAULT_PROMETHEUS_URL)),
            thresholds=GateThresholds.from_spec(spec.get("thresholds")),
            canary=CanaryPolicy.from_spec(spec.get("canary")),
            cuda=cuda,
            server_image=str(spec.get("serverImage", DEFAULT_SERVER_IMAGE)),
            observability=RolloutObservability.from_spec(
                spec.get("observability")
            ),
            autoscaling=autoscaling,
            fleet=fleet,
            slo=slo,
            planner=planner,
            multiplex=multiplex,
            anomaly=anomaly,
        )
