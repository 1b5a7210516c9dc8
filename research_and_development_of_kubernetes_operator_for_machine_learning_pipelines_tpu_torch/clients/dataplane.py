"""Data-plane client: synthetic warm-up traffic to a predictor (the port's
copy of the JAX package's ``clients/dataplane.py``, on the standard
library's HTTP: ``clients/transport.py``).

Solves the zero-traffic deadlock (SURVEY §3.5(4)): a 10%-weight canary may
never accumulate the samples the gate needs.  The operator POSTs a burst of
V2 inference requests directly to the canary predictor's service (bypassing
the Istio split, so the burst cannot skew the stable model's metrics).

The service URL follows Seldon's naming (``<deployment>-<predictor>`` svc in
the model namespace); override with ``url_template`` for other layouts.
"""

from __future__ import annotations

import logging

from .transport import Transport, TransportError, UrllibTransport, json_body

_log = logging.getLogger(__name__)

DEFAULT_URL_TEMPLATE = (
    "http://{deployment}-{predictor}.{namespace}:9000/v2/models/{model}/infer"
)


class DataPlaneWarmup:
    def __init__(
        self,
        url_template: str = DEFAULT_URL_TEMPLATE,
        timeout: float = 2.0,
        max_wall_s: float = 10.0,
        example: dict | None = None,
        transport: Transport | None = None,
    ):
        self.url_template = url_template
        # Short per-request timeout AND an overall deadline: warmup runs on
        # the single-threaded reconcile loop, so a hanging canary must never
        # stall other resources' gate checks (reconciler design contract).
        self.timeout = timeout
        self.max_wall_s = max_wall_s
        self._transport = transport or UrllibTransport(timeout=timeout)
        # A 1-element FP32 vector by default; model-specific warmup bodies
        # can be injected per-operator via ``example``.
        self.example = example or {
            "inputs": [
                {"name": "x", "shape": [1, 1], "datatype": "FP32", "data": [0.0]}
            ]
        }

    def __call__(
        self,
        deployment: str,
        predictor: str,
        namespace: str,
        n: int,
        model: str | None = None,
    ) -> int:
        import time

        # The V2 infer route is registered under spec.modelName (server
        # app.py), which need not equal the deployment/CR name.
        url = self.url_template.format(
            deployment=deployment,
            predictor=predictor,
            namespace=namespace,
            model=model or deployment,
        )
        ok = 0
        deadline = time.monotonic() + self.max_wall_s
        body = json_body(self.example)
        headers = {"Content-Type": "application/json"}
        for _ in range(n):
            if time.monotonic() > deadline:
                _log.info("warmup wall-time budget exhausted")
                break
            try:
                status, _, _ = self._transport("POST", url, headers, body)
                # Only a handled inference counts: a 404/400 produces no
                # request metric, so counting it would report a warmup
                # that unblocks nothing.
                if 200 <= status < 300:
                    ok += 1
                else:
                    _log.debug("warmup request to %s got %d", url, status)
            except TransportError as e:
                _log.debug("warmup request failed: %s", e)
        _log.info("warmup: %d/%d requests served by %s", ok, n, url)
        return ok
