"""MLflow registry client over the REST API — no mlflow SDK (the port's copy
of the JAX package's ``clients/mlflow_rest.py``, on the standard library's
HTTP: ``clients/transport.py``).

Implements the two calls the reference makes through ``MlflowClient``
(``mlflow_operator.py:44``): ``get_model_version_by_alias`` (``:59``) and
``get_model_version`` (``:131``), against MLflow's documented 2.0 REST
endpoints.  Credentials follow the same convention as the reference's
deployment (env via the creds secret, ``mlflow-operator-deployment.yaml:21-23``):
``MLFLOW_TRACKING_URI``, optional ``MLFLOW_TRACKING_USERNAME``/``PASSWORD``
(HTTP basic, which wins over a token as ``httpx``'s ``auth`` does)
or ``MLFLOW_TRACKING_TOKEN``.
"""

from __future__ import annotations

import base64
import json
import os

from .base import AliasNotFound, ModelVersion, RegistryError
from .transport import Transport, TransportError, UrllibTransport, with_query


class MlflowRestClient:
    def __init__(self, tracking_uri: str | None = None, timeout: float = 30.0,
                 transport: Transport | None = None):
        tracking_uri = tracking_uri or os.environ.get("MLFLOW_TRACKING_URI")
        if not tracking_uri:
            raise RuntimeError("MLFLOW_TRACKING_URI not configured")
        self._base = tracking_uri.rstrip("/")
        self.headers: dict[str, str] = {}
        token = os.environ.get("MLFLOW_TRACKING_TOKEN")
        if token:
            self.headers["Authorization"] = f"Bearer {token}"
        user = os.environ.get("MLFLOW_TRACKING_USERNAME")
        password = os.environ.get("MLFLOW_TRACKING_PASSWORD")
        if user and password:
            pair = base64.b64encode(f"{user}:{password}".encode()).decode()
            self.headers["Authorization"] = f"Basic {pair}"
        self._transport = transport or UrllibTransport(timeout=timeout)

    def _get(self, path: str, params: dict) -> dict:
        try:
            status, _, body = self._transport(
                "GET", with_query(self._base + path, params), dict(self.headers), None
            )
        except TransportError as e:
            raise RegistryError(f"mlflow unreachable: {e}") from e
        if status >= 400:
            text = body.decode("utf-8", "replace")[:500]
            # Only MLflow's own structured error for a missing alias/version
            # may report AliasNotFound — that verdict triggers error status +
            # deployment teardown (base.py contract).  A bare 404 from an
            # ingress/proxy (wrong path prefix, upstream down) is an infra
            # fault and must stay retryable, not tear down a healthy model.
            try:
                error_code = json.loads(body).get("error_code")
            except ValueError:
                error_code = None
            if error_code == "RESOURCE_DOES_NOT_EXIST":
                raise AliasNotFound(text)
            raise RegistryError(f"mlflow error {status}: {text}")
        return json.loads(body)

    @staticmethod
    def _parse_version(body: dict) -> ModelVersion:
        mv = body.get("model_version") or {}
        version = mv.get("version")
        if version is None:
            # A 200 without model_version.version must not become the
            # string "None" and trigger a phantom rollout.
            raise RegistryError(f"malformed mlflow response: {body!r:.200}")
        return ModelVersion(version=str(version), source=mv.get("source", ""))

    def get_version_by_alias(self, model_name: str, alias: str) -> ModelVersion:
        return self._parse_version(
            self._get(
                "/api/2.0/mlflow/registered-models/alias",
                {"name": model_name, "alias": alias},
            )
        )

    def get_version(self, model_name: str, version: str) -> ModelVersion:
        return self._parse_version(
            self._get(
                "/api/2.0/mlflow/model-versions/get",
                {"name": model_name, "version": version},
            )
        )
