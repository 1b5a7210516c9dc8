"""Rollout flight recorder: per-CR journal of the canary control loop.

The data plane got its flight recorder in the tracing PR
(``server/flight_recorder.py``); this is the control-plane half.  The
promotion gate used to collapse two raw ``ModelMetrics`` readings, the
thresholds in force, and three budget comparisons into a boolean plus
prose reason strings that only ever hit the operator log — so "why has
this canary been stuck at 30% for an hour?" was unanswerable from the
CR, the metrics endpoint, or anything but scrollback.

Every gate evaluation now produces a structured :class:`GateRecord`
(raw new/old metrics, thresholds, per-check signed margins from
``judge.should_promote``, decision + reasons, traffic before/after,
attempt count, op-timer breakdown) and every rollout phase change a
:class:`TransitionRecord`; the replica autoscaler journals its decisions
beside them as :class:`~.autoscaler.ScaleRecord` (``kind: "scale"``).
They surface three ways:

- ``status.lastGate`` / ``status.history`` on the CR itself (opt-in via
  ``spec.observability.historyLimit``; 0 — the default — writes neither
  key, keeping status byte-for-byte), so ``kubectl get -o yaml`` alone
  explains a stalled rollout;
- this recorder's bounded per-CR rings, served by the operator's
  telemetry listener as ``GET /debug/rollouts`` (live JSON) and ``GET
  /debug/rollouts/trace?format=chrome`` (Perfetto timeline: one track
  per CR, traffic-level spans, gate instants carrying margins) — the
  same chrome-trace conventions as the engine recorder;
- ``tpumlops_operator_gate_*`` Prometheus series plus one structured
  JSON decision log line per evaluation (``operator/telemetry.py`` and
  ``operator/reconciler.py``).

Constructed only when ``--rollout-ring > 0`` on the operator CLI; the
default operator builds no recorder object at all.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Mapping

# Gate checks, in the order the judge evaluates them.  Keys of
# ``GateDecision.margins`` / ``GateRecord.margins`` and values of the
# ``check`` label on ``tpumlops_operator_gate_margin``.
GATE_CHECKS = ("latency_p95", "error_rate", "latency_avg")


def _iso(ts: float) -> str:
    """ISO-8601 UTC for a unix-epoch reading."""
    import datetime

    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%SZ")


@dataclass(frozen=True)
class GateRecord:
    """One promotion-gate evaluation, with everything the judge saw.

    ``margins`` is the signed headroom per check (budget − observed;
    ≥ 0 promotes, computed by ``judge.should_promote``) and is EMPTY —
    not zero — when the gate refused before the budget comparisons ran
    (metrics missing or below ``minSampleCount``).

    ``ts`` is the injected ``Clock.now()`` reading (pacing context;
    monotonic in production, fake seconds in tests) and stays
    process-internal; the EXPORTED ``ts``/``time`` come from ``wall``
    (unix epoch), because journal records round-trip through CR status
    and survive operator restarts — a monotonic ts would reset to ~0 on
    every restart and make cross-restart deltas meaningless."""

    ts: float  # Clock.now() at evaluation time
    wall: float = 0.0  # unix epoch seconds at evaluation time
    new_version: str | None = None
    old_version: str | None = None
    traffic_before: int = 0
    traffic_after: int = 0
    attempt: int = 0  # 1-based attempt number at this traffic level
    promote: bool = False
    reasons: tuple[str, ...] = ()
    missing_on: tuple[str, ...] = ()
    margins: Mapping[str, float] = field(default_factory=dict)
    new_metrics: Mapping[str, Any] = field(default_factory=dict)
    old_metrics: Mapping[str, Any] = field(default_factory=dict)
    thresholds: Mapping[str, Any] = field(default_factory=dict)
    timings: Mapping[str, float] = field(default_factory=dict)
    # Duplicate PromotionHold Warning events suppressed so far at this
    # refusal shape (traffic level + failing checks / missing models) —
    # the stuck-canary event rate limiter.
    suppressed_events: int = 0

    @property
    def result(self) -> str:
        return "promote" if self.promote else "refuse"

    @property
    def refusal(self) -> str | None:
        """Typed refusal class (``None`` when the gate promoted):
        ``missing_metrics`` / ``min_sample`` / ``threshold``."""
        if self.promote:
            return None
        if self.missing_on:
            return "missing_metrics"
        if not self.margins:
            return "min_sample"
        return "threshold"

    def as_dict(self) -> dict[str, Any]:
        """Full journal shape (recorder rings and ``status.history``)."""
        return {
            "kind": "gate",
            "ts": self.wall,
            "time": _iso(self.wall),
            "result": self.result,
            "refusal": self.refusal,
            "newVersion": self.new_version,
            "oldVersion": self.old_version,
            "trafficBefore": self.traffic_before,
            "trafficAfter": self.traffic_after,
            "attempt": self.attempt,
            "reasons": list(self.reasons),
            "missingOn": sorted(self.missing_on),
            "margins": dict(self.margins),
            "newMetrics": dict(self.new_metrics),
            "oldMetrics": dict(self.old_metrics),
            "thresholds": dict(self.thresholds),
            "timings": dict(self.timings),
            "suppressedEvents": self.suppressed_events,
        }

    def compact(self) -> dict[str, Any]:
        """The ``status.lastGate`` block: decision + margins without the
        raw metric dumps (those live in ``status.history``)."""
        return {
            "time": _iso(self.wall),
            "result": self.result,
            "refusal": self.refusal,
            "attempt": self.attempt,
            "trafficBefore": self.traffic_before,
            "trafficAfter": self.traffic_after,
            "margins": dict(self.margins),
            "reasons": list(self.reasons),
        }


@dataclass(frozen=True)
class TransitionRecord:
    """One rollout phase change (NEW_VERSION detection, promotion to
    Stable, rollback, halt) keyed by the Event reason that announced it."""

    ts: float
    wall: float = 0.0  # unix epoch seconds
    from_phase: str = ""
    to_phase: str = ""
    reason: str = ""  # the K8s Event reason, e.g. "PromotionComplete"
    new_version: str | None = None
    old_version: str | None = None
    traffic: int = 0

    def as_dict(self) -> dict[str, Any]:
        return {
            "kind": "phase",
            "ts": self.wall,
            "time": _iso(self.wall),
            "from": self.from_phase,
            "to": self.to_phase,
            "reason": self.reason,
            "newVersion": self.new_version,
            "oldVersion": self.old_version,
            "traffic": self.traffic,
        }


@dataclass(frozen=True)
class CrashLoopRecord:
    """Replica churn observed by the reconciler (``kind: "crashloop"``).

    Journaled when the summed container restart count across a CR's
    pods GROWS — one record per observed increase, beside the gate and
    scale records, so "the canary gate refused while the new pod was
    crash-looping" is reconstructable from ``status.history`` alone.
    ``pods`` carries only the pods whose counts grew this observation."""

    wall: float  # unix epoch seconds at observation time
    total: int = 0  # summed restarts across all pods now
    prior_total: int = 0  # what status.restarts carried before
    pods: tuple = ()  # ((pod_name, restart_count), ...) for grown pods
    reason: str = ""  # last terminated reason when one is visible

    def as_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "kind": "crashloop",
            "ts": self.wall,
            "time": _iso(self.wall),
            "total": self.total,
            "priorTotal": self.prior_total,
            "pods": {name: int(n) for name, n in self.pods},
        }
        if self.reason:
            out["reason"] = self.reason
        return out


class RolloutRecorder:
    """Bounded per-CR journal of gate and transition records.

    Writers are reconcile steps (any pool thread), readers the telemetry
    listener's ``/debug/rollouts*`` handlers; one lock covers both, and
    every write is an O(1) deque append."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(
                f"rollout ring capacity must be >= 1, got {capacity}"
            )
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._journals: dict[tuple[str, str], deque] = {}
        self._recorded: dict[tuple[str, str], int] = {}

    # -- writers (reconciler side) -------------------------------------------

    def record(self, namespace: str, name: str, record) -> None:
        rec = record.as_dict() if hasattr(record, "as_dict") else dict(record)
        key = (namespace, name)
        with self._lock:
            journal = self._journals.get(key)
            if journal is None:
                journal = self._journals[key] = deque(maxlen=self.capacity)
            journal.append(rec)
            self._recorded[key] = self._recorded.get(key, 0) + 1

    def forget(self, namespace: str, name: str) -> None:
        """Drop a deleted CR's journal (mirrors ``OperatorTelemetry.forget``)."""
        with self._lock:
            self._journals.pop((namespace, name), None)
            self._recorded.pop((namespace, name), None)

    # -- readers (/debug/rollouts side) --------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Live journal for ``GET /debug/rollouts``: records verbatim plus
        lifetime totals (ring rotation visible as recorded > len)."""
        with self._lock:
            journals = {k: list(v) for k, v in self._journals.items()}
            recorded = dict(self._recorded)
        return {
            "capacity": self.capacity,
            "rollouts": {
                f"{ns}/{name}": {
                    "recorded": recorded.get((ns, name), 0),
                    "records": [dict(r) for r in recs],
                }
                for (ns, name), recs in sorted(journals.items())
            },
        }

    def chrome_trace(self) -> dict[str, Any]:
        """Chrome trace-event JSON (Perfetto / chrome://tracing).

        One track (tid) per CR.  Traffic levels render as complete
        (``X``) spans named ``traffic N%`` — a rollout reads as a
        staircase — with gate evaluations as instant events carrying
        margins/reasons and phase changes as instants between them.
        The time base is the earliest record in the journal (records
        export wall-clock epoch seconds, so spans stay comparable even
        across operator restarts)."""
        with self._lock:
            journals = {k: [dict(r) for r in v] for k, v in self._journals.items()}

        out: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": "tpumlops-operator rollouts"},
            }
        ]
        bases = [
            float(r.get("ts", 0.0))
            for recs in journals.values()
            for r in recs
        ]
        base = min(bases) if bases else 0.0

        def us(r: dict) -> int:
            return max(0, int((float(r.get("ts", base)) - base) * 1e6))
        for tid, ((ns, name), recs) in enumerate(sorted(journals.items()), start=1):
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": f"{ns}/{name}"},
                }
            )
            # Traffic staircase: close a span whenever the level changes.
            level: int | None = None
            span_start = 0
            last_ts = 0
            for r in recs:
                ts = us(r)
                last_ts = max(last_ts, ts)
                r_level = (
                    r.get("trafficAfter")
                    if r.get("kind") == "gate"
                    else r.get("traffic")
                )
                if r.get("kind") == "gate":
                    out.append(
                        {
                            "name": f"gate {r.get('result')}",
                            "cat": "gate",
                            "ph": "i",
                            "s": "t",
                            "ts": ts,
                            "pid": 1,
                            "tid": tid,
                            "args": {
                                "refusal": r.get("refusal"),
                                "attempt": r.get("attempt"),
                                "margins": r.get("margins") or {},
                                "reasons": r.get("reasons") or [],
                            },
                        }
                    )
                elif r.get("kind") == "scale":
                    # Autoscaler decision (operator/autoscaler.py
                    # ScaleRecord): applied scalings and typed holds.
                    out.append(
                        {
                            "name": (
                                f"scale {r.get('from')} -> {r.get('to')}"
                                if r.get("hold") is None
                                else f"scale hold ({r.get('hold')})"
                            ),
                            "cat": "scale",
                            "ph": "i",
                            "s": "t",
                            "ts": ts,
                            "pid": 1,
                            "tid": tid,
                            "args": {
                                "desired": r.get("desired"),
                                "reason": r.get("reason"),
                                "observed": r.get("observed") or {},
                            },
                        }
                    )
                elif r.get("kind") == "anomaly":
                    # Fleet anomaly observatory (operator/anomaly.py
                    # AnomalyRecord): verdict-set transitions.
                    out.append(
                        {
                            "name": f"anomaly {r.get('action')}",
                            "cat": "anomaly",
                            "ph": "i",
                            "s": "t",
                            "ts": ts,
                            "pid": 1,
                            "tid": tid,
                            "args": {
                                "replicas": r.get("replicas"),
                                "verdicts": r.get("verdicts") or [],
                            },
                        }
                    )
                else:
                    out.append(
                        {
                            "name": f"{r.get('from')} -> {r.get('to')}",
                            "cat": "phase",
                            "ph": "i",
                            "s": "t",
                            "ts": ts,
                            "pid": 1,
                            "tid": tid,
                            "args": {"reason": r.get("reason")},
                        }
                    )
                if r_level is None:
                    continue
                if level is None:
                    level, span_start = r_level, ts
                elif r_level != level:
                    out.append(
                        {
                            "name": f"traffic {level}%",
                            "cat": "traffic",
                            "ph": "X",
                            "ts": span_start,
                            "dur": max(0, ts - span_start),
                            "pid": 1,
                            "tid": tid,
                            "args": {"level": level},
                        }
                    )
                    level, span_start = r_level, ts
            if level is not None:
                out.append(
                    {
                        "name": f"traffic {level}%",
                        "cat": "traffic",
                        "ph": "X",
                        "ts": span_start,
                        "dur": max(0, last_ts - span_start),
                        "pid": 1,
                        "tid": tid,
                        "args": {"level": level},
                    }
                )
        return {"traceEvents": out, "displayTimeUnit": "ms"}
