"""First-party operator metrics (the port's copy of the JAX package's
``operator/telemetry.py``).

The reference *consumes* Prometheus but exports nothing about itself
("the operator exports no metrics of its own") — so an operator
stuck in backoff, a promotion frozen mid-split, or a reconcile-latency
regression is invisible until someone reads pod logs.  This module gives
the control plane the same observability its data plane already has:

- ``tpumlops_operator_reconcile_total{namespace,name,result}`` — steps by
  outcome (``ok``/``error``);
- ``tpumlops_operator_reconcile_seconds`` — step latency histogram
  (the promotion-loop step timing SURVEY §5 calls for);
- ``tpumlops_operator_phase{...,phase}`` — one-hot rollout phase per CR;
- ``tpumlops_operator_traffic_percent`` — live canary split per CR
  (time-to-100% — the north-star metric — is directly readable from this
  series' history);
- ``tpumlops_operator_promotions_total{...,outcome}`` — completed /
  failed / rolled-back rollouts (from the same events the reference posts
  to Kubernetes, ``mlflow_operator.py:344,:361``);
- ``tpumlops_operator_resources`` — CRs currently managed;
- ``tpumlops_operator_gate_margin{check}`` — signed headroom (budget −
  observed) of the last gate evaluation per check: how far the canary
  is from promoting, not just that it isn't;
- ``tpumlops_operator_gate_evaluations_total{result}`` — gate decisions
  by class (``promote`` / ``threshold`` / ``missing_metrics`` /
  ``min_sample``);
- ``tpumlops_operator_gate_attempt`` — this evaluation's attempt number
  at the current traffic level (resets on each promote step);
- ``tpumlops_operator_rollout_duration_seconds`` — NEW_VERSION→terminal
  wall time per rollout (the north-star time-to-100% as a histogram).

Wired into ``OperatorRuntime`` (zero-cost when not configured) and served
by ``python -m <package>.operator --metrics-port``.  The families' names,
types, label names and bucket bounds are the JAX package's; they are built
on the port's own text exposition (``server/metrics.py``), since the card's
machine has no ``prometheus_client``.
"""

from __future__ import annotations

import time

import threading

from ..server.metrics import Counter, Gauge, Histogram
from .rollout_recorder import GATE_CHECKS
from .state import Phase

_STEP_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0)
# A rollout spans canary step intervals, not reconcile steps: seconds to
# hours.
_ROLLOUT_BUCKETS = (1.0, 5.0, 15.0, 60.0, 120.0, 300.0, 600.0, 1800.0,
                    3600.0, 7200.0)

# Event reasons that terminate a rollout, mapped to a promotion outcome.
# Ordered by precedence: a rolled-back step emits PromotionFailed AND
# RollbackComplete in the same outcome and must count once, as
# rolled_back — not once per reason (pre-journal versions keyed this on
# a "RolledBack" reason nothing ever emitted, so rolled_back rollouts
# were miscounted as failed).
_TERMINAL_REASONS = (
    ("RollbackComplete", "rolled_back"),
    ("PromotionComplete", "completed"),
    ("PromotionFailed", "failed"),
)


def _fetch_json(url: str, timeout: float = 5.0):
    import json as _json
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return _json.loads(resp.read().decode())


def fleet_overview(sources, models) -> dict:
    """One aggregated fleet view: every source's ring snapshot (server
    rings for replicas, the leg-latency ring + per-backend circuit
    state for the router) plus the control plane's per-model verdicts
    and mux assignments.

    ``sources`` is the fleet-trace source list
    (``[{"name", "base_url", "kind": "router"|"replica"}, ...]``).
    Unlike ``/debug/fleet-trace`` — where a missing component makes the
    merged trace silently wrong, so a fetch error is a 502 — a dark
    replica IS the story here: it stays listed with an ``error`` field
    instead of taking the whole overview down.  A 404 from a ring
    endpoint (ring disabled) lists the source with ``timeseries: null``
    and no error."""
    import urllib.error

    srcs: dict = {}
    for spec in sources:
        base = str(spec.get("base_url") or "").rstrip("/")
        name = spec.get("name") or base
        kind = spec.get("kind") or "replica"
        entry: dict = {"kind": kind, "base_url": base, "timeseries": None}
        ts_path = (
            "/router/debug/timeseries"
            if kind == "router"
            else "/debug/timeseries"
        )
        try:
            entry["timeseries"] = _fetch_json(base + ts_path)
        except urllib.error.HTTPError as e:
            if e.code != 404:  # 404 = ring off, a legitimate state
                entry["error"] = f"HTTP {e.code}"
        except Exception as e:
            entry["error"] = str(e)
        if kind == "router" and "error" not in entry:
            try:
                fl = _fetch_json(base + "/router/fleet")
                circuits = {}
                for b in fl.get("backends") or []:
                    c = {
                        "healthy": b.get("healthy"),
                        "circuitOpened": b.get("circuit_opened"),
                    }
                    if b.get("model"):
                        c["model"] = b["model"]
                    circuits[b.get("name")] = c
                entry["circuits"] = circuits
            except Exception as e:
                entry["error"] = str(e)
        srcs[name] = entry
    return {"sources": srcs, "models": models}


class _Registry:
    """The families of one exposition, in registration order, on one lock
    (what ``prometheus_client``'s ``CollectorRegistry`` is to the JAX
    package's copy)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.families: list = []

    def add(self, family):
        family.sort_labels = True
        self.families.append(family)
        return family

    def render(self) -> bytes:
        lines: list[str] = []
        with self.lock:
            for fam in self.families:
                lines.extend(fam.render())
        return ("\n".join(lines) + "\n").encode()


class _Series:
    """One labeled child of a family (``metric.labels(*values)``)."""

    __slots__ = ("_family", "_labels")

    def __init__(self, family, values):
        self._family = family
        self._labels = dict(zip(family.label_names, values))

    def inc(self, amount: float = 1.0) -> None:
        self._family.inc(self._labels, amount)

    def set(self, value: float) -> None:
        self._family.set(self._labels, value)

    def observe(self, value: float) -> None:
        self._family.observe(self._labels, value)


def _remove(family, *values) -> None:
    """Drop one labeled child; KeyError when it was never minted (as
    ``prometheus_client``'s ``remove``)."""
    family.remove(dict(zip(family.label_names, values)))


class OperatorTelemetry:
    def __init__(self) -> None:
        self.registry = reg = _Registry()
        lock = reg.lock

        def counter(name, doc, labels):
            # The exposition appends ``_total`` to a counter's family name.
            return reg.add(Counter(name.removesuffix("_total"), doc, labels, lock))

        def gauge(name, doc, labels):
            return reg.add(Gauge(name, doc, labels, lock))

        def histogram(name, doc, labels, buckets):
            return reg.add(Histogram(name, doc, labels, buckets, lock))

        ident = ["namespace", "name"]
        self.reconciles = counter(
            "tpumlops_operator_reconcile_total",
            "Reconcile steps by result",
            ident + ["result"]
        )
        self.reconcile_seconds = histogram(
            "tpumlops_operator_reconcile_seconds",
            "Wall time of one reconcile step",
            ident, _STEP_BUCKETS
        )
        # Where each step's time went (status patch vs manifest apply vs
        # gate read vs registry): the per-component split behind the
        # time-to-100% overhead line — a drift in
        # operator overhead becomes attributable instead of a mystery.
        self.step_component_seconds = histogram(
            "tpumlops_operator_step_component_seconds",
            "Reconcile-step wall time per operation class",
            ident + ["component"], _STEP_BUCKETS
        )
        self.phase = gauge(
            "tpumlops_operator_phase",
            "Rollout phase (one-hot per CR)",
            ident + ["phase"]
        )
        self.traffic = gauge(
            "tpumlops_operator_traffic_percent",
            "Traffic on the current (new) version",
            ident
        )
        self.promotions = counter(
            "tpumlops_operator_promotions_total",
            "Finished rollouts by outcome",
            ident + ["outcome"]
        )
        self.events = counter(
            "tpumlops_operator_events_total",
            "Kubernetes events posted, by reason",
            ident + ["reason"]
        )
        self.resources = gauge(
            "tpumlops_operator_resources",
            "MlflowModel resources currently managed",
            ()
        )
        self.resources.set({}, 0.0)  # an unlabeled gauge exports from birth
        # Promotion-gate decision series (fed from ReconcileOutcome.gate;
        # no samples appear until a CR actually runs a canary gate).
        self.gate_margin = gauge(
            "tpumlops_operator_gate_margin",
            "Signed headroom (budget - observed) of the last gate "
            "evaluation, per check; >= 0 promotes",
            ident + ["check"]
        )
        self.gate_evaluations = counter(
            "tpumlops_operator_gate_evaluations_total",
            "Gate evaluations by decision class",
            ident + ["result"]
        )
        self.gate_attempt = gauge(
            "tpumlops_operator_gate_attempt",
            "Attempt number of the last gate evaluation at the current "
            "traffic level (1-based; resets each promote step)",
            ident
        )
        # Replica-autoscaler decision series (fed from
        # ReconcileOutcome.scale and the post-step state; no samples
        # until a CR enables spec.autoscaling).
        self.autoscale_replicas = gauge(
            "tpumlops_operator_autoscale_replicas",
            "Autoscaler-controlled replica count of the current version "
            "(absent while spec.autoscaling is disabled)",
            ident
        )
        self.autoscale_desired = gauge(
            "tpumlops_operator_autoscale_desired_replicas",
            "Replica count the last autoscaler evaluation wanted before "
            "hysteresis (> replicas = scale-up pending stabilization; "
            "< replicas = scale-down pending cooldown)",
            ident
        )
        self.autoscale_events = counter(
            "tpumlops_operator_autoscale_events_total",
            "Applied replica scalings by direction",
            ident + ["direction"]
        )
        self.autoscale_holds = counter(
            "tpumlops_operator_autoscale_holds_total",
            "Autoscaler evaluations held back, by reason (cooldown / "
            "stabilization / metrics_missing)",
            ident + ["reason"]
        )
        # SLO error-budget accounting (spec.slo; operator/slo.py) — no
        # samples until a CR configures spec.slo.
        self.slo_attainment = gauge(
            "tpumlops_operator_slo_attainment",
            "Rolling fraction of in-window samples meeting the SLO "
            "target (spec.slo)",
            ident + ["slo"]
        )
        self.slo_budget_remaining = gauge(
            "tpumlops_operator_slo_error_budget_remaining",
            "Rolling error budget remaining (1 = untouched, 0 = "
            "exhausted) per SLO over spec.slo.windowMinutes",
            ident + ["slo"]
        )
        self.slo_burn_rate = gauge(
            "tpumlops_operator_slo_burn_rate",
            "Error-budget burn rate per SLO (1.0 = consuming the "
            "budget exactly as fast as the objective allows)",
            ident + ["slo"]
        )
        # Multi-model multiplexing (spec.multiplex; operator/
        # multiplexer.py) — no samples until a CR joins a shared pool.
        self.mux_moves = counter(
            "tpumlops_operator_mux_moves_total",
            "Executed multiplexer moves by action (attach = onto an "
            "empty replica, replace = evicted another model)",
            ident + ["action"]
        )
        self.mux_parked = gauge(
            "tpumlops_operator_mux_parked_requests",
            "Router-parked requests awaiting this model's attach, as "
            "last observed by the multiplexer",
            ident
        )
        # Fleet anomaly observatory (spec.anomaly; operator/anomaly.py)
        # — no samples until a CR enables spec.anomaly.
        self.anomaly_active = gauge(
            "tpumlops_operator_anomaly_active",
            "Active anomaly verdicts by kind (straggler / drift), as "
            "stamped at the last journaled verdict-set transition",
            ident + ["kind"]
        )
        self.anomaly_events = counter(
            "tpumlops_operator_anomaly_events_total",
            "Journaled anomaly verdicts by kind, plus 'cleared' "
            "all-quiet transitions",
            ident + ["kind"]
        )
        self.rollout_seconds = histogram(
            "tpumlops_operator_rollout_duration_seconds",
            "Wall time from NEW_VERSION detection to a terminal phase "
            "(promoted / failed / rolled back)",
            ident, _ROLLOUT_BUCKETS
        )
        # Canary start times for rollout_duration (keyed per CR).
        self._rollout_t0: dict[tuple[str, str], float] = {}
        # Every labeled series this object has minted, keyed by CR, so
        # forget() can prune with the public remove() API only (no reaching
        # into a family's internals).
        self._series: dict[tuple[str, str], set] = {}
        # slo-label children currently exported per CR (pruned when an
        # SLO vanishes from the spec or spec.slo is removed).
        self._slo_children: dict[tuple[str, str], set] = {}
        # Per-CR control-plane view for /debug/fleet-overview: the
        # latest anomaly verdicts and mux assignment per model.
        self._overview: dict[tuple[str, str], dict] = {}

    def _child(self, metric, namespace: str, name: str, *extra: str):
        values = (namespace, name, *extra)
        self._series.setdefault((namespace, name), set()).add((metric, values))
        return _Series(metric, values)

    # -- recording (called by OperatorRuntime) -------------------------------

    def record_outcome(self, namespace: str, name: str, outcome, seconds: float):
        """Record a successful reconcile step and its resulting state."""
        self._child(self.reconciles, namespace, name, "ok").inc()
        self._child(self.reconcile_seconds, namespace, name).observe(seconds)
        for component, secs in (getattr(outcome, "timings", None) or {}).items():
            self._child(
                self.step_component_seconds, namespace, name, component
            ).observe(secs)
        state = outcome.state
        for phase in Phase:
            self._child(self.phase, namespace, name, phase.value).set(
                1.0 if state.phase == phase else 0.0
            )
        self._child(self.traffic, namespace, name).set(state.traffic_current)
        reasons = {event.reason for event in outcome.events}
        for event in outcome.events:
            self._child(self.events, namespace, name, event.reason).inc()
        for reason, outcome_label in _TERMINAL_REASONS:
            if reason in reasons:
                self._child(
                    self.promotions, namespace, name, outcome_label
                ).inc()
                break
        gate = getattr(outcome, "gate", None)
        if gate is not None:
            self._child(
                self.gate_evaluations, namespace, name,
                gate.refusal or "promote",
            ).inc()
            self._child(self.gate_attempt, namespace, name).set(gate.attempt)
            if gate.margins:
                for check, margin in gate.margins.items():
                    self._child(
                        self.gate_margin, namespace, name, check
                    ).set(margin)
            else:
                # The latest evaluation ran NO budget comparisons
                # (metrics missing / below min samples): drop the
                # per-check children rather than keep exporting the
                # previous evaluation's headroom as if it were current.
                for check in GATE_CHECKS:
                    try:
                        _remove(self.gate_margin, namespace, name, check)
                    except KeyError:
                        pass
        scale = getattr(outcome, "scale", None)
        if state.replicas is not None:
            self._child(self.autoscale_replicas, namespace, name).set(
                state.replicas
            )
        elif (namespace, name) in self._series:
            # Autoscaling just disabled: stop exporting a stale count.
            for metric in (self.autoscale_replicas, self.autoscale_desired):
                try:
                    _remove(metric, namespace, name)
                except KeyError:
                    pass
        if scale is not None:
            self._child(self.autoscale_desired, namespace, name).set(
                scale.desired
            )
            if scale.applied:
                self._child(
                    self.autoscale_events, namespace, name, scale.direction
                ).inc()
            elif scale.hold is not None:
                self._child(
                    self.autoscale_holds, namespace, name, scale.hold
                ).inc()
        mux = getattr(outcome, "mux", None)
        if mux is not None:
            for rec in mux:
                if rec.action in ("attach", "replace"):
                    self._child(
                        self.mux_moves, namespace, name, rec.action
                    ).inc()
            muxv = getattr(state, "multiplex", None) or {}
            if muxv.get("parked") is not None:
                self._child(self.mux_parked, namespace, name).set(
                    muxv["parked"]
                )
        anomaly = getattr(outcome, "anomaly", None)
        if anomaly:
            for rec in anomaly:
                if rec.verdicts:
                    for v in rec.verdicts:
                        self._child(
                            self.anomaly_events, namespace, name, v.kind
                        ).inc()
                else:
                    self._child(
                        self.anomaly_events, namespace, name, "cleared"
                    ).inc()
        anoms = getattr(state, "anomalies", None)
        if anoms is not None:
            counts = {"straggler": 0, "drift": 0}
            for a in anoms:
                k = a.get("kind") if isinstance(a, dict) else None
                if k in counts:
                    counts[k] += 1
            for kind, n in counts.items():
                self._child(
                    self.anomaly_active, namespace, name, kind
                ).set(n)
        elif (namespace, name) in self._series:
            # spec.anomaly removed: stop exporting stale verdict counts.
            for kind in ("straggler", "drift"):
                try:
                    _remove(self.anomaly_active, namespace, name, kind)
                except KeyError:
                    pass
        # Fleet-overview stash: what the control plane currently
        # believes about this model, next to the rings fetched live.
        ov: dict = {}
        if anoms is not None:
            ov["anomalies"] = list(anoms)
        muxv = getattr(state, "multiplex", None)
        if muxv is not None:
            ov["multiplex"] = dict(muxv)
        if ov:
            self._overview[(namespace, name)] = ov
        else:
            self._overview.pop((namespace, name), None)
        slo = getattr(outcome, "slo", None)
        slo_gauges = (
            self.slo_attainment, self.slo_budget_remaining,
            self.slo_burn_rate,
        )
        if slo:
            stale = self._slo_children.get((namespace, name), set()) - set(
                slo
            )
            for slo_name, ev in slo.items():
                values = (
                    (ev.attainment, self.slo_attainment),
                    (ev.budget_remaining, self.slo_budget_remaining),
                    (ev.burn_rate, self.slo_burn_rate),
                )
                for value, gauge in values:
                    if value is not None:
                        self._child(gauge, namespace, name, slo_name).set(
                            value
                        )
            self._slo_children[(namespace, name)] = set(slo)
        else:
            # spec.slo removed: stop exporting stale budget numbers.
            stale = self._slo_children.pop((namespace, name), set())
        for slo_name in stale:
            for gauge in slo_gauges:
                try:
                    _remove(gauge, namespace, name, slo_name)
                except KeyError:
                    pass
        # Rollout duration: arm on canary start, observe on terminal.
        key = (namespace, name)
        if "NewModelVersionDetected" in reasons and state.phase == Phase.CANARY:
            self._rollout_t0[key] = time.monotonic()
        if reasons & {"PromotionComplete", "RollbackComplete"} or (
            "PromotionFailed" in reasons and state.phase == Phase.FAILED
        ):
            t0 = self._rollout_t0.pop(key, None)
            if t0 is not None:
                self._child(self.rollout_seconds, namespace, name).observe(
                    time.monotonic() - t0
                )

    def record_failure(self, namespace: str, name: str, seconds: float):
        self._child(self.reconciles, namespace, name, "error").inc()
        self._child(self.reconcile_seconds, namespace, name).observe(seconds)

    def set_resource_count(self, n: int):
        self.resources.set({}, n)

    def forget(self, namespace: str, name: str):
        """Drop a deleted CR's labeled series so /metrics stops exporting a
        phantom model (a stale phase=Canary gauge would fire "canary stuck"
        alerts forever)."""
        for metric, values in self._series.pop((namespace, name), ()):
            try:
                _remove(metric, *values)
            except KeyError:
                pass
        self._rollout_t0.pop((namespace, name), None)
        self._slo_children.pop((namespace, name), None)
        self._overview.pop((namespace, name), None)

    def exposition(self) -> bytes:
        return self.registry.render()

    def serve(self, port: int, addr: str = "0.0.0.0", recorder=None,
              fleet_trace_sources=None):
        """Expose /metrics, /debug/spans, and (with a RolloutRecorder
        attached) /debug/rollouts + /debug/rollouts/trace on a
        daemon-thread listener.

        /debug/spans serves the ``utils/tracing.py`` GLOBAL_TRACER stats
        (reconcile-step span timings) as JSON — the same payload shape
        the data-plane server exposes, so one tool reads both planes.
        /debug/rollouts is the live per-CR gate/phase journal;
        /debug/rollouts/trace?format=chrome renders it as Chrome
        trace-event JSON (Perfetto), mirroring the server's
        /debug/engine + /debug/trace pair.

        ``fleet_trace_sources`` — a zero-arg callable returning
        ``[{"name", "base_url", "kind": "router"|"replica"}, ...]``
        (typically derived from the routing manifest: the router admin
        address plus every live replica) — additionally serves ``GET
        /debug/fleet-trace``: the sources' chrome traces fetched,
        shifted onto one clock, and merged into ONE Perfetto trace whose
        request spans share the propagated request ids
        (``utils/trace_stitch.py``).  404 when not wired.

        The same sources also drive ``GET /debug/fleet-overview``: each
        source's timeseries ring (plus the router's circuit states)
        fetched live and merged with the control plane's per-model
        anomaly verdicts and mux assignments — what
        ``scripts/fleet_top.py`` renders."""
        import json
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        from ..utils.tracing import GLOBAL_TRACER

        telemetry = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler contract)
                parsed = urlparse(self.path)
                path = parsed.path
                if path == "/metrics":
                    body = telemetry.exposition()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/debug/spans":
                    body = json.dumps(
                        {"spans": GLOBAL_TRACER.as_dict()}
                    ).encode()
                    ctype = "application/json"
                elif path == "/debug/fleet-trace":
                    if fleet_trace_sources is None:
                        self.send_error(
                            404,
                            "fleet trace sources not wired (pass "
                            "fleet_trace_sources to telemetry.serve)",
                        )
                        return
                    from ..utils.trace_stitch import fleet_trace

                    try:
                        specs = list(fleet_trace_sources())
                        merged = fleet_trace(specs)
                    except Exception as e:  # a dark component is a 502,
                        self.send_error(502, f"fleet trace fetch: {e}")
                        return  # not a silent partial story
                    q = parse_qs(parsed.query).get("request_id", [None])[0]
                    if q:
                        from ..utils.trace_stitch import filter_request

                        merged = filter_request(merged, q)
                    body = json.dumps(merged).encode()
                    ctype = "application/json"
                elif path == "/debug/fleet-overview":
                    if fleet_trace_sources is None:
                        self.send_error(
                            404,
                            "fleet trace sources not wired (pass "
                            "fleet_trace_sources to telemetry.serve)",
                        )
                        return
                    try:
                        specs = list(fleet_trace_sources())
                    except Exception as e:
                        self.send_error(502, f"fleet overview sources: {e}")
                        return
                    models = {
                        f"{ns}/{nm}": dict(ov)
                        for (ns, nm), ov in sorted(
                            telemetry._overview.items()
                        )
                    }
                    body = json.dumps(
                        fleet_overview(specs, models)
                    ).encode()
                    ctype = "application/json"
                elif path == "/debug/rollouts":
                    if recorder is None:
                        self.send_error(404, "rollout recorder disabled")
                        return
                    body = json.dumps(recorder.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/debug/rollouts/trace":
                    if recorder is None:
                        self.send_error(404, "rollout recorder disabled")
                        return
                    fmt = parse_qs(parsed.query).get("format", ["chrome"])[0]
                    if fmt == "chrome":
                        body = json.dumps(recorder.chrome_trace()).encode()
                    elif fmt == "json":
                        body = json.dumps(recorder.snapshot()).encode()
                    else:
                        self.send_error(400, f"unknown format {fmt!r}")
                        return
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log events
                pass

        httpd = ThreadingHTTPServer((addr, port), _Handler)
        httpd.daemon_threads = True
        threading.Thread(
            target=httpd.serve_forever, daemon=True, name="operator-metrics"
        ).start()
        return httpd
