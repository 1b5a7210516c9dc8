"""Prometheus metrics source over the HTTP query API — no client SDK (the
port's copy of the JAX package's ``clients/prom_http.py``, on the standard
library's HTTP: ``clients/transport.py``).

Runs the exact PromQL the reference runs (``get_model_metrics``,
``mlflow_operator.py:363-417``): p95 via histogram_quantile over the
client-requests buckets, error/total counts with the ``or on() vector(0)``
zero-fallback, mean latency as increase(sum)/increase(count), request and
feedback counts — keyed by {deployment_name, predictor_name, namespace}.
"""

from __future__ import annotations

import json
import logging

from .base import EngineMetrics, ModelMetrics
from .transport import Transport, TransportError, UrllibTransport, with_query

_log = logging.getLogger(__name__)


class PrometheusSource:
    def __init__(self, url: str, timeout: float = 30.0,
                 transport: Transport | None = None):
        self._base = url.rstrip("/")
        self._transport = transport or UrllibTransport(timeout=timeout)

    def _query(self, promql: str) -> float | None:
        try:
            status, _, body = self._transport(
                "GET", with_query(self._base + "/api/v1/query", {"query": promql}),
                {}, None,
            )
            if status >= 400:
                raise TransportError(f"HTTP {status} from prometheus")
            result = json.loads(body).get("data", {}).get("result", [])
        except (TransportError, ValueError) as e:
            _log.warning("prometheus query failed: %s", e)
            return None
        if not result:
            return None
        try:
            value = float(result[0]["value"][1])
        except (KeyError, IndexError, TypeError, ValueError):
            return None
        return None if value != value else value  # NaN -> None

    def model_metrics(
        self,
        deployment_name: str,
        predictor_name: str,
        namespace: str,
        window_s: int = 60,
    ) -> ModelMetrics:
        sel = (
            f'deployment_name="{deployment_name}", '
            f'predictor_name="{predictor_name}", namespace="{namespace}"'
        )
        w = f"{window_s}s"

        # Reference :367-372
        p95 = self._query(
            "histogram_quantile(0.95, sum(rate("
            f"seldon_api_executor_client_requests_seconds_bucket{{{sel}}}[{w}]"
            ")) by (le))"
        )
        # NOTE on None vs 0: every count query below carries PromQL's
        # ``or on() vector(0)`` fallback, so a *successful* query returns a
        # real number (possibly 0).  ``_query`` returning None means the
        # query itself failed (Prometheus unreachable / bad response) — that
        # must surface as metric-unavailable (None), never as 0, or a
        # transient Prometheus blip would read as a perfect canary and pass
        # the gate.
        # Reference :375-380
        errors = self._query(
            "sum(increase("
            f'seldon_api_executor_server_requests_seconds_count{{code!="200", {sel}}}[{w}]'
            ")) or on() vector(0)"
        )
        # Reference :383-390
        total = self._query(
            "sum(increase("
            f"seldon_api_executor_server_requests_seconds_count{{{sel}}}[{w}]"
            ")) or on() vector(0)"
        )
        if errors is None or total is None:
            error_rate = None
        else:
            error_rate = (errors / total) if total > 0 else None
        # Reference :393-404
        lat_sum = self._query(
            "sum(increase("
            f"seldon_api_executor_client_requests_seconds_sum{{{sel}}}[{w}]"
            ")) or on() vector(0)"
        )
        lat_count = self._query(
            "sum(increase("
            f"seldon_api_executor_client_requests_seconds_count{{{sel}}}[{w}]"
            ")) or on() vector(0)"
        )
        if lat_sum is None or lat_count is None:
            latency_avg = None
        else:
            latency_avg = (lat_sum / lat_count) if lat_count > 0 else None
        # Reference :410-415
        # NOTE: a failed query stays 0.0 only because ModelMetrics requires a
        # float here and nothing gates on feedback count; keep the None-vs-0
        # distinction if a consumer ever appears.
        feedback = self._query(
            "sum(increase("
            f'seldon_api_executor_server_requests_seconds_count{{service="feedback", {sel}}}[{w}]'
            ")) or on() vector(0)"
        )
        feedback = feedback if feedback is not None else 0.0

        return ModelMetrics(
            latency_p95=p95,
            error_responses=errors if errors is not None else 0.0,
            error_rate=error_rate,
            latency_avg=latency_avg,
            # On query failure request_count reads 0, which the
            # min_sample_count hardening treats as not-enough-samples (safe).
            request_count=lat_count if lat_count is not None else 0.0,
            feedback_request_count=feedback,
        )

    def engine_metrics(
        self,
        deployment_name: str,
        predictor_name: str,
        namespace: str,
        window_s: int = 60,
        slo_tails: bool = False,
    ) -> EngineMetrics:
        """Engine-saturation signals for the replica autoscaler.

        Queue depth is summed over the predictor's replicas — each
        replica exports its own ``tpumlops_engine_queue_depth`` gauge
        under the same identity labels, so the sum is the predictor's
        total backlog.  No ``vector(0)`` fallback anywhere: a failed or
        empty query must surface as None (signal unavailable), never as
        0 — the autoscaler treats blindness as "hold", and a Prometheus
        blackout reading as "no load" would drain the fleet to
        minReplicas under full traffic.
        """
        sel = (
            f'deployment_name="{deployment_name}", '
            f'predictor_name="{predictor_name}", namespace="{namespace}"'
        )
        w = f"{window_s}s"
        queue_depth = self._query(
            f"sum(tpumlops_engine_queue_depth{{{sel}}})"
        )
        wait_p95 = self._query(
            "histogram_quantile(0.95, sum(rate("
            f"tpumlops_admission_wait_ms_bucket{{{sel}}}[{w}]"
            ")) by (le))"
        )
        ttft_p95 = self._query(
            "histogram_quantile(0.95, sum(rate("
            f"tpumlops_ttft_seconds_bucket{{{sel}}}[{w}]"
            ")) by (le))"
        )
        # The router's park buffer (native/router.cc): requests held for
        # a CR at zero replicas.  Keyed by deployment/namespace only —
        # the router parks before any predictor is picked, so the gauge
        # carries no predictor_name.  Same no-vector(0) discipline:
        # None = park signal unobservable, and the autoscaler then
        # refuses the last scale-down step to zero.
        parked = self._query(
            "sum(tpumlops_router_parked_requests{"
            f'deployment_name="{deployment_name}", '
            f'namespace="{namespace}"}})'
        )
        # SLO tails (spec.slo): p99 of the same TTFT histogram plus the
        # inter-token-latency one.  Queried ONLY when the caller serves
        # the SLO tracker — autoscale-only CRs keep the 4-query shape.
        # Same no-vector(0) discipline: an unobservable tail contributes
        # NO sample to the error budget.
        ttft_p99 = itl_p99 = None
        if slo_tails:
            ttft_p99 = self._query(
                "histogram_quantile(0.99, sum(rate("
                f"tpumlops_ttft_seconds_bucket{{{sel}}}[{w}]"
                ")) by (le))"
            )
            itl_p99 = self._query(
                "histogram_quantile(0.99, sum(rate("
                f"tpumlops_itl_seconds_bucket{{{sel}}}[{w}]"
                ")) by (le))"
            )
        return EngineMetrics(
            queue_depth=queue_depth,
            admission_wait_p95_ms=wait_p95,
            ttft_p95_s=ttft_p95,
            parked=parked,
            ttft_p99_s=ttft_p99,
            itl_p99_s=itl_p99,
        )
