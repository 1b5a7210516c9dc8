"""Offline SLO planner: throughput-optimal knob search over a replayed
journey trace (``spec.planner``; the port's copy of the JAX package's
``operator/planner.py``, on ``spec.cuda``).

InferLine's observation (PAPERS.md) is that the cheapest configuration
meeting a tight latency objective is found OFFLINE, against a recorded
trace, with an analytic cost model — not by live trial and error on the
fleet.  Every input this planner needs already exists as a spec'd
surface:

- the **trace**: the router journey ring's ``/router/debug/requests``
  export, parsed by ``utils/journey_trace.py`` (typed rejection of
  drifted exports);
- the **cost model**: the same analytic FLOPs / HBM-bytes ledger the
  device-telemetry layer reads MFU against
  (:class:`~..server.device_telemetry.LlamaCostModel`), joined with the
  per-card rooflines (:class:`~..server.device_telemetry.DevicePeaks`);
- the **knob space**: the serving knobs that are pure config —
  ``decodeSteps`` K, ``speculative``, ``prefillBatch`` /
  ``prefillTokenBudget``, ``quantize``, cache slots (``maxSlots``), and
  ``meshShape`` chips-per-replica vs replica count (the fleet pool
  size).

:func:`plan` replays the trace's arrivals through a deterministic
slot-level simulator for every grid point and emits the cheapest
(card-seconds) configuration whose predicted interactive TTFT p99 meets
the objective — or raises the typed :class:`InfeasibleObjectiveError`
naming the best the knob space can do.  Determinism is a contract: given
the peaks the JAX package plans with, this copy re-plans the committed
fixture trace to the committed plan JSON byte-for-byte, so cost-model
drift fails a test instead of silently re-shaping fleets.

The peaks default to :func:`~..server.device_telemetry.detect_peaks`: the
H100's published rates on the card, the assumed H100 entry elsewhere.  A
``plan`` keyword ``peaks`` overrides them (the parity test passes the JAX
package's v5e table).  Collective bytes divide by
``DevicePeaks.link_bytes_per_s`` (NVLink, one way).

Error bars (the JAX package's docs/PLANNER.md): tick walls are
``max(flops, bytes)`` rooflines plus a fixed host-dispatch constant —
no kernel-level overlap modeling; speculative decode is credited an
assumed acceptance rate (:data:`SPEC_ASSUMED_ACCEPTANCE`); the
simulator models slots, not the admission queue's class interleaving.
The numbers are planning-grade (which knob region), not benchmark-grade
(exact milliseconds).
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path
from typing import Any, Mapping

from ..server.device_telemetry import DevicePeaks, LlamaCostModel, detect_peaks
from ..utils.config import GPU_TOPOLOGIES, OperatorConfig, PlannerSpec
from ..utils.journey_trace import (
    JourneyTrace,
    TraceRequest,
    load_journey_trace,
)

PLAN_FORMAT_VERSION = 1

# Fixed per-dispatch host overhead (enqueue + callback glue) the fused
# multi-step path amortizes by K.  Order-of-magnitude constant, same
# spirit as DevicePeaks' "assumed" rooflines.
HOST_DISPATCH_S = 300e-6

# Credit speculative decode an assumed draft-acceptance rate: the trace
# records arrivals, not text, so the real rate is unknowable offline.
# 0.3 is conservative for chat workloads (bench.py measures the real
# curve); the JAX package's docs/PLANNER.md carries the caveat.
SPEC_ASSUMED_ACCEPTANCE = 0.3
SPEC_DRAFT_TOKENS = 4



class InfeasibleObjectiveError(ValueError):
    """No point in the knob space meets the stated objective.

    Carries the best the space can do (``best_ms`` at ``best_knobs``) so
    the caller can surface "tighten the objective or grow the slice"
    with numbers instead of a bare failure."""

    def __init__(self, objective_ms: float, best_ms: float,
                 best_knobs: Mapping[str, Any]):
        self.objective_ms = objective_ms
        self.best_ms = best_ms
        self.best_knobs = dict(best_knobs)
        super().__init__(
            f"no knob configuration meets ttftP99Ms <= {objective_ms:g}: "
            f"best predicted p99 is {best_ms:.1f} ms at {self.best_knobs} "
            "— loosen the objective or provide a larger topology"
        )


@dataclass(frozen=True)
class ModelProfile:
    """Model geometry the analytic cost model needs (7B-class defaults).

    ``spec.planner.model`` overrides any field; the live server derives
    the same numbers from the artifact in hand
    (``LlamaCostModel.for_model``) — the planner runs where no artifact
    is loadable, so the geometry is declared instead."""

    num_layers: int = 32
    hidden_size: int = 4096
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    intermediate_size: int = 11008
    vocab_size: int = 32000

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | None) -> "ModelProfile":
        spec = dict(spec or {})
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"spec.planner.model has unknown keys {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(**{k: int(v) for k, v in spec.items()})

    @property
    def matmul_params(self) -> int:
        """Weight-matrix element count (the 2-flops-per-param term)."""
        h = self.hidden_size
        attn = 2 * h * h + 2 * h * self.num_kv_heads * self.head_dim
        mlp = 3 * h * self.intermediate_size
        return self.num_layers * (attn + mlp) + h * self.vocab_size


@dataclass(frozen=True)
class KnobPoint:
    """One candidate configuration the search scores."""

    tp: int = 1            # chips per replica (meshShape tp axis)
    replicas: int = 1      # pool size (chips_total = tp * replicas)
    max_slots: int = 8     # continuous-batching cache slots
    quantize: str = "none"
    decode_steps: int = 1
    speculative: bool = False
    prefill_batch: int = 1
    prefill_token_budget: int = 0

    @property
    def chips(self) -> int:
        return self.tp * self.replicas

    def as_spec(self) -> dict:
        """CRD-spelled knob dict (the plan's ``knobs`` key)."""
        return {
            "meshShape": {"dp": 1, "tp": self.tp},
            "replicas": self.replicas,
            "maxSlots": self.max_slots,
            "quantize": self.quantize,
            "decodeSteps": self.decode_steps,
            "speculative": bool(self.speculative),
            "prefillBatch": self.prefill_batch,
            "prefillTokenBudget": self.prefill_token_budget,
        }


def _cost_model(profile: ModelProfile, knob: KnobPoint) -> LlamaCostModel:
    dtype_bytes = 1 if knob.quantize in ("int8", "int8kv") else 2
    kv_eb = (
        1 + 4.0 / profile.head_dim if knob.quantize == "int8kv" else 2.0
    )
    return LlamaCostModel(
        matmul_params=profile.matmul_params,
        weight_bytes=profile.matmul_params * dtype_bytes,
        num_layers=profile.num_layers,
        num_heads=profile.num_heads,
        num_kv_heads=profile.num_kv_heads,
        head_dim=profile.head_dim,
        kv_elem_bytes=kv_eb,
        tp=knob.tp,
        hidden_size=profile.hidden_size,
        vocab_size=profile.vocab_size,
        act_bytes=2,
    )


def _wall(flops: float, nbytes: float, coll: Mapping[str, float],
          peaks: DevicePeaks, dispatches: float = 1.0) -> float:
    """Roofline wall of one device dispatch: max(compute, HBM) plus the
    interconnect collective terms, plus ``dispatches`` host-dispatch
    constants."""
    w = max(flops / peaks.flops_per_s, nbytes / peaks.hbm_bytes_per_s)
    for b in coll.values():
        w += b / peaks.link_bytes_per_s
    return w + dispatches * HOST_DISPATCH_S


def _prefill_seconds(cm: LlamaCostModel, peaks: DevicePeaks,
                     tokens: int, knob: KnobPoint) -> float:
    """Wall to prefill one ``tokens``-long cold prompt.  ``prefillBatch``
    > 1 amortizes the weight stream across packed admissions — credited
    as the weight-bytes term divided by the batch (full packing, the
    bursty-load best case the knob exists for)."""
    flops, nbytes = cm.prefill(1, tokens)
    if knob.prefill_batch > 1:
        nbytes -= cm.weight_bytes * (1.0 - 1.0 / knob.prefill_batch)
    return _wall(flops, nbytes, cm.collective_bytes(1, tokens), peaks)


def _per_token_seconds(cm: LlamaCostModel, peaks: DevicePeaks,
                       window: float, knob: KnobPoint) -> float:
    """Steady-state seconds per generated token for one slot, at full
    occupancy (``max_slots`` rows share every tick — the conservative
    load assumption), with the fused-K dispatch amortization and the
    assumed speculative acceptance credit applied."""
    rows = knob.max_slots
    if knob.speculative:
        s = 1 + SPEC_DRAFT_TOKENS
        flops, nbytes = cm.decode(rows, int(window), s)
        wall = _wall(flops, nbytes, cm.collective_bytes(rows, s), peaks)
        tokens = 1.0 + SPEC_ASSUMED_ACCEPTANCE * SPEC_DRAFT_TOKENS
        return wall / tokens
    flops, nbytes = cm.decode(rows, int(window), 1)
    # decodeSteps K fuses K decode iterations under ONE host dispatch.
    k = max(1, knob.decode_steps)
    wall = _wall(k * flops, k * nbytes, cm.collective_bytes(rows, k),
                 peaks, dispatches=1.0)
    return wall / k


@dataclass(frozen=True)
class Prediction:
    """What the simulator says one knob point does to the trace."""

    ttft_p50_ms: float
    ttft_p99_ms: float
    makespan_s: float
    chip_seconds: float
    chips: int
    requests: int


def _percentile(sorted_vals: list, q: float) -> float:
    """Deterministic nearest-rank percentile (no interpolation drift)."""
    if not sorted_vals:
        return 0.0
    rank = max(0, math.ceil(q * len(sorted_vals)) - 1)
    return sorted_vals[min(rank, len(sorted_vals) - 1)]


def predict(trace: JourneyTrace, knob: KnobPoint,
            profile: ModelProfile | None = None,
            peaks: DevicePeaks | None = None) -> Prediction:
    """Replay the trace's arrivals through ``knob``'s analytic engine.

    Deterministic slot-level simulation: arrivals assign to the replica
    with the least outstanding work (tie: lowest index), then to that
    replica's earliest-free slot.  TTFT = queue wait + prefill wall;
    the decode tail holds the slot for ``max_new_tokens`` at the
    steady-state per-token cadence.  The objective reads the
    interactive class's TTFTs when the trace carries classes (the SLO
    preemption exists to protect), all requests otherwise."""
    profile = profile or ModelProfile()
    base = peaks or detect_peaks()
    per_replica = base.scaled(knob.tp)
    cm = _cost_model(profile, knob)

    # slot_free[r][s] = when slot s of replica r next frees.
    slot_free = [[0.0] * knob.max_slots for _ in range(knob.replicas)]
    replica_load = [0.0] * knob.replicas  # outstanding busy seconds
    ttfts: list[float] = []
    interactive_ttfts: list[float] = []
    finish_last = 0.0
    for req in trace.requests:
        window = req.prompt_tokens + req.max_new_tokens / 2.0
        prefill_s = _prefill_seconds(cm, per_replica, req.prompt_tokens,
                                     knob)
        decode_s = req.max_new_tokens * _per_token_seconds(
            cm, per_replica, window, knob
        )
        r = min(range(knob.replicas), key=lambda i: (replica_load[i], i))
        slots = slot_free[r]
        s = min(range(knob.max_slots), key=lambda i: (slots[i], i))
        start = max(req.arrival_s, slots[s])
        ttft = (start - req.arrival_s) + prefill_s
        finish = start + prefill_s + decode_s
        slots[s] = finish
        replica_load[r] += prefill_s + decode_s
        finish_last = max(finish_last, finish)
        ttfts.append(ttft)
        if req.slo_class == "interactive":
            interactive_ttfts.append(ttft)
    scored = sorted(interactive_ttfts or ttfts)
    makespan = finish_last
    return Prediction(
        ttft_p50_ms=_percentile(scored, 0.50) * 1e3,
        ttft_p99_ms=_percentile(scored, 0.99) * 1e3,
        makespan_s=makespan,
        chip_seconds=knob.chips * makespan,
        chips=knob.chips,
        requests=len(trace.requests),
    )


def default_grid(chips_available: int = 8) -> tuple[KnobPoint, ...]:
    """The deterministic search grid, bounded by the topology's chips.

    Ordered canonically (ascending knob tuples) so ties in the
    (chip-seconds, p99) objective always resolve the same way."""
    points = []
    for tp in (1, 4, 8):
        for replicas in (1, 2, 4):
            if tp * replicas > chips_available:
                continue
            for max_slots in (4, 8, 16):
                for quantize in ("none", "int8", "int8kv"):
                    for decode_steps in (1, 4):
                        for speculative in (False, True):
                            for prefill_batch in (1, 4):
                                points.append(KnobPoint(
                                    tp=tp,
                                    replicas=replicas,
                                    max_slots=max_slots,
                                    quantize=quantize,
                                    decode_steps=decode_steps,
                                    speculative=speculative,
                                    prefill_batch=prefill_batch,
                                    prefill_token_budget=(
                                        2048 if prefill_batch > 1 else 0
                                    ),
                                ))
    return tuple(points)


def _round_floats(obj):
    """3-decimal rounding everywhere: the committed plan JSON must be
    byte-for-byte reproducible across platforms' float printing."""
    if isinstance(obj, float):
        return round(obj, 3)
    if isinstance(obj, dict):
        return {k: _round_floats(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v) for v in obj]
    return obj


def plan(trace: JourneyTrace,
         objective: Mapping[str, float],
         profile: ModelProfile | None = None,
         peaks: DevicePeaks | None = None,
         grid: tuple[KnobPoint, ...] | None = None,
         chips_available: int = 8,
         seed: int = 0) -> dict:
    """Search the knob grid for the cheapest point meeting ``objective``.

    Returns the costed plan dict (``status.plan`` / ``scripts/plan.py``
    output).  Raises :class:`InfeasibleObjectiveError` (typed) when no
    grid point meets the objective, and ``ValueError`` for an objective
    key the planner does not know or an empty trace.  ``seed`` is
    recorded in the plan for provenance; the search itself is
    exhaustive and deterministic — same trace + same objective ==
    byte-for-byte the same plan."""
    unknown = set(objective) - {"ttftP99Ms"}
    if unknown:
        raise ValueError(
            f"unknown planner objective keys {sorted(unknown)}; "
            "known: ['ttftP99Ms']"
        )
    if "ttftP99Ms" not in objective:
        raise ValueError("planner objective requires ttftP99Ms")
    objective_ms = float(objective["ttftP99Ms"])
    if objective_ms <= 0:
        raise ValueError(
            f"planner objective ttftP99Ms must be > 0, got {objective_ms}"
        )
    if not trace.requests:
        raise ValueError("journey trace has no requests to replay")
    grid = grid or default_grid(chips_available)
    peaks = peaks or detect_peaks()
    best = None           # (chip_seconds, p99, idx, knob, pred): feasible
    best_any = None       # same, ignoring feasibility (for the error)
    for idx, knob in enumerate(grid):
        pred = predict(trace, knob, profile=profile, peaks=peaks)
        key = (pred.chip_seconds, pred.ttft_p99_ms, idx)
        if best_any is None or pred.ttft_p99_ms < best_any[4].ttft_p99_ms:
            best_any = (*key, knob, pred)
        if pred.ttft_p99_ms <= objective_ms and (
            best is None or key < best[:3]
        ):
            best = (*key, knob, pred)
    if best is None:
        assert best_any is not None
        raise InfeasibleObjectiveError(
            objective_ms, best_any[4].ttft_p99_ms, best_any[3].as_spec()
        )
    _, _, _, knob, pred = best
    return _round_floats({
        "formatVersion": PLAN_FORMAT_VERSION,
        "seed": int(seed),
        "objective": {"ttftP99Ms": objective_ms},
        "knobs": knob.as_spec(),
        "predicted": {
            "ttftP50Ms": pred.ttft_p50_ms,
            "ttftP99Ms": pred.ttft_p99_ms,
            "makespanS": pred.makespan_s,
            "chipSeconds": pred.chip_seconds,
            "chips": pred.chips,
        },
        "trace": {
            "requests": pred.requests,
            "spanS": trace.span_s,
            "formatVersion": trace.format_version,
        },
        "searched": len(grid),
    })


def plan_for_config(config: OperatorConfig) -> dict | None:
    """The reconciler's entry: run :func:`plan` per ``spec.planner``.

    Returns None when the planner is disabled.  Trace loading, profile
    parsing, and the search all raise typed ValueErrors the reconciler
    surfaces on CR status."""
    spec: PlannerSpec = config.planner
    if not spec.enabled:
        return None
    source = spec.trace if spec.trace is not None else spec.trace_path
    trace = load_journey_trace(source)
    profile = ModelProfile.from_spec(spec.model)
    info = GPU_TOPOLOGIES.get(config.cuda.topology)
    chips = info.cards if info is not None else 8
    return plan(trace, spec.objective, profile=profile,
                chips_available=chips)


def apply_plan(config: OperatorConfig, plan_dict: Mapping[str, Any]
               ) -> OperatorConfig:
    """``applyMode: apply``: fold the plan's chosen knobs into the
    config the builder renders manifests from.  Returns a NEW config
    (frozen dataclasses throughout); suggest mode never calls this."""
    knobs = dict(plan_dict.get("knobs") or {})
    cuda = config.cuda
    spec_updates: dict = {}
    if "meshShape" in knobs:
        spec_updates["mesh_shape"] = dict(knobs["meshShape"])
    if "replicas" in knobs:
        spec_updates["replicas"] = int(knobs["replicas"])
    if "maxSlots" in knobs:
        spec_updates["max_slots"] = int(knobs["maxSlots"])
    if "quantize" in knobs:
        spec_updates["quantize"] = str(knobs["quantize"])
    if "decodeSteps" in knobs:
        spec_updates["decode_steps"] = int(knobs["decodeSteps"])
    if "prefillBatch" in knobs:
        spec_updates["prefill_batch"] = int(knobs["prefillBatch"])
    if "prefillTokenBudget" in knobs:
        spec_updates["prefill_token_budget"] = int(
            knobs["prefillTokenBudget"]
        )
    if "speculative" in knobs:
        spec_updates["speculative"] = replace(
            cuda.speculative, enabled=bool(knobs["speculative"])
        )
    return replace(config, cuda=replace(cuda, **spec_updates))


@dataclass(frozen=True)
class PlanRecord:
    """One planner decision for the rollout journal (``kind: "plan"``) —
    journaled beside gate/scale/SLO records when the computed plan
    changes, surfacing on ``status.history`` and ``/debug/rollouts``."""

    ts: float
    wall: float
    apply_mode: str
    objective: dict = field(default_factory=dict)
    knobs: dict = field(default_factory=dict)
    predicted: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "kind": "plan",
            "ts": self.ts,
            "wall": self.wall,
            "applyMode": self.apply_mode,
            "objective": dict(self.objective),
            "knobs": dict(self.knobs),
            "predicted": dict(self.predicted),
        }
