"""Kubernetes API client over plain REST — no kubernetes SDK (the port's
copy of the JAX package's ``clients/kube_rest.py``, on the standard
library's HTTP instead of ``httpx``: ``clients/transport.py``).

Speaks the same CustomObjects endpoints the reference uses through
``kubernetes.client.CustomObjectsApi`` (``mlflow_operator.py:35,:241``),
with in-cluster auth: ServiceAccount bearer token + cluster CA from the
standard mounts, API server address from the standard env vars (what
``config.load_incluster_config()`` reads at ``mlflow_operator.py:13``).
Paths, verbs, the merge-patch content type, the error mapping and the
watch stream (JSON lines, ``resourceVersion`` resume, 410 as
:class:`WatchExpired`) are the JAX package's.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Mapping

from .base import ApiError, Conflict, Event, NotFound, ObjectRef, WatchEvent, WatchExpired
from .transport import (
    Transport,
    TransportError,
    UrllibTransport,
    json_body,
    split_lines,
    with_query,
)

_log = logging.getLogger(__name__)

_SA_DIR = Path("/var/run/secrets/kubernetes.io/serviceaccount")

# Connect/read bound of one watch read: an idle stream ends after this and
# the caller reconnects from its cursor (no re-list), so stop() never waits
# out the server-side watch timeout.  The JAX package's client waits 15 s;
# here 5 s, so an operator process stops within seconds of SIGTERM (its
# watchers join after their blocked reads end).
WATCH_READ_TIMEOUT_S = 5.0


class _Response:
    __slots__ = ("status_code", "content")

    def __init__(self, status: int, content: bytes):
        self.status_code = int(status)
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content)


class KubeRestClient:
    _token_from_mount = False

    def __init__(
        self,
        base_url: str | None = None,
        token: str | None = None,
        verify: Any = None,
        timeout: float = 30.0,
        transport: Transport | None = None,
    ):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in-cluster (KUBERNETES_SERVICE_HOST unset) and no "
                    "base_url given"
                )
            base_url = f"https://{host}:{port}"
        self._base = base_url.rstrip("/")
        # Remember whether the token came from the SA mount: bound SA tokens
        # expire (~1h) and the kubelet rotates the file, so a 401 means
        # "re-read the mount", not "give up".
        self._token_from_mount = token is None and (_SA_DIR / "token").exists()
        if self._token_from_mount:
            token = (_SA_DIR / "token").read_text().strip()
        if verify is None:
            ca = _SA_DIR / "ca.crt"
            verify = str(ca) if ca.exists() else True
        self.headers: dict[str, str] = (
            {"Authorization": f"Bearer {token}"} if token else {}
        )
        self._transport = transport or UrllibTransport(timeout=timeout, verify=verify)

    # -- plumbing ------------------------------------------------------------

    def _send(self, method: str, path: str, body: bytes | None,
              content_type: str | None) -> _Response:
        headers = dict(self.headers)
        if content_type is not None:
            headers["Content-Type"] = content_type
        status, _, data = self._transport(method, self._base + path, headers, body)
        return _Response(status, data)

    def _request(self, method: str, path: str, body: bytes | None = None,
                 content_type: str | None = None) -> _Response:
        resp = self._send(method, path, body, content_type)
        if resp.status_code == 401 and self._token_from_mount:
            fresh = (_SA_DIR / "token").read_text().strip()
            self.headers["Authorization"] = f"Bearer {fresh}"
            resp = self._send(method, path, body, content_type)
        return resp

    def _json(self, method: str, path: str, obj: Mapping[str, Any]) -> _Response:
        return self._request(method, path, json_body(dict(obj)), "application/json")

    @staticmethod
    def _path(ref: ObjectRef, name: bool = True) -> str:
        group_part = (
            f"/apis/{ref.group}/{ref.version}" if ref.group else f"/api/{ref.version}"
        )
        ns_part = f"/namespaces/{ref.namespace}" if ref.namespace else ""
        name_part = f"/{ref.name}" if name and ref.name else ""
        return f"{group_part}{ns_part}/{ref.plural}{name_part}"

    @staticmethod
    def _check(resp: _Response) -> dict:
        if resp.status_code == 404:
            raise NotFound(resp.text[:200])
        if resp.status_code == 409:
            raise Conflict(resp.text[:200])
        if resp.status_code >= 400:
            raise ApiError(resp.status_code, resp.text[:500])
        return resp.json()

    # -- KubeClient protocol -------------------------------------------------

    def get(self, ref: ObjectRef) -> dict:
        return self._check(self._request("GET", self._path(ref)))

    def list(self, ref: ObjectRef) -> list[dict]:
        return self.list_with_version(ref)[0]

    def list_with_version(self, ref: ObjectRef) -> tuple[list[dict], str]:
        """List plus the collection's resourceVersion — the watch cursor.

        Starting a watch from the list's resourceVersion (not per-item RVs)
        is the informer contract: every change after this snapshot is
        guaranteed to appear on the stream.
        """
        body = self._check(self._request("GET", self._path(ref, name=False)))
        rv = (body.get("metadata") or {}).get("resourceVersion", "")
        return body.get("items", []), rv

    def _open_stream(self, path: str):
        """(status, lines) of a streamed GET: the transport's ``stream``
        where it has one, else its whole body split into lines."""
        url, headers = self._base + path, dict(self.headers)
        stream = getattr(self._transport, "stream", None)
        if stream is not None:
            status, _, lines = stream("GET", url, headers, None, WATCH_READ_TIMEOUT_S)
            return status, lines
        status, _, body = self._transport("GET", url, headers, None)
        return status, split_lines(body)

    def watch(
        self,
        ref: ObjectRef,
        resource_version: str | None = None,
        timeout_s: int = 300,
        stop=None,
    ):
        """Stream watch events for a collection (kopf's push model,
        reference ``mlflow_operator.py:26-27``, without kopf).

        Yields :class:`WatchEvent`.  Raises :class:`WatchExpired` on 410
        (either HTTP status or an ERROR event carrying code 410) — the
        caller must re-list and restart the watch from the fresh
        resourceVersion.  ``timeout_s`` is the server-side watch timeout;
        the generator simply ends when the server closes the stream (or a
        read idles past :data:`WATCH_READ_TIMEOUT_S`), and the caller
        reconnects with its latest bookmark.
        """
        params: dict[str, str] = {
            "watch": "1",
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(int(timeout_s)),
        }
        if resource_version:
            params["resourceVersion"] = resource_version
        status, lines = self._open_stream(
            with_query(self._path(ref, name=False), params)
        )
        it = iter(lines)
        try:
            if status == 410:
                raise WatchExpired("watch list version expired")
            if status >= 400:
                text = b"".join(it).decode("utf-8", "replace")
                raise ApiError(status, text[:500])
            while True:
                if stop is not None and stop.is_set():
                    return
                try:
                    line = next(it)
                except (StopIteration, TransportError):
                    return
                if isinstance(line, (bytes, bytearray)):
                    line = bytes(line).decode("utf-8", "replace")
                if not line.strip():
                    continue
                try:
                    raw = json.loads(line)
                except json.JSONDecodeError:
                    _log.warning("undecodable watch line: %r", line[:200])
                    continue
                if raw.get("type") == "ERROR":
                    code = (raw.get("object") or {}).get("code")
                    if code == 410:
                        raise WatchExpired(str(raw.get("object"))[:200])
                    raise ApiError(int(code or 500), str(raw.get("object"))[:300])
                yield WatchEvent(type=raw.get("type", ""), object=raw.get("object") or {})
        finally:
            getattr(lines, "close", lambda: None)()

    def create(self, ref: ObjectRef, body: Mapping[str, Any]) -> dict:
        return self._check(self._json("POST", self._path(ref, name=False), body))

    def replace(self, ref: ObjectRef, body: Mapping[str, Any]) -> dict:
        return self._check(self._json("PUT", self._path(ref), body))

    def patch_status(self, ref: ObjectRef, status: Mapping[str, Any]) -> dict:
        return self._check(
            self._request(
                "PATCH",
                self._path(ref) + "/status",
                json.dumps({"status": dict(status)}).encode(),
                "application/merge-patch+json",
            )
        )

    def delete(self, ref: ObjectRef) -> None:
        self._check(self._request("DELETE", self._path(ref)))

    def emit_event(self, ref: ObjectRef, event: Event) -> None:
        """Create a corev1 Event attached to the CR (kopf.event equivalent,
        reference call sites :90,:122,:332,:344,:361)."""
        import datetime

        now = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"
        )
        try:
            obj = self.get(ref)
            uid = (obj.get("metadata") or {}).get("uid")
        except (ApiError, TransportError):
            uid = None
        body = {
            "metadata": {"generateName": f"{ref.name}-", "namespace": ref.namespace},
            "involvedObject": {
                "apiVersion": ref.api_version,
                "kind": "MlflowModel",
                "name": ref.name,
                "namespace": ref.namespace,
                **({"uid": uid} if uid else {}),
            },
            "type": event.type,
            "reason": event.reason,
            "message": event.message,
            "firstTimestamp": now,
            "lastTimestamp": now,
            "count": 1,
            "source": {"component": "tpumlops-operator"},
        }
        # Best-effort end to end: a cosmetic event must never abort a
        # reconcile step, whether the API rejects it or the transport drops.
        try:
            self._check(
                self._json("POST", f"/api/v1/namespaces/{ref.namespace}/events", body)
            )
        except (ApiError, TransportError) as e:
            _log.warning("event emission failed: %s", e)
