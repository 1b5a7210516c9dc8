"""envtest-style in-process Kubernetes API server (real HTTP, real watches;
the port's copy of the JAX package's ``clients/envtest.py``).

A REST client's wire behavior tested only against scripted responses says
nothing of a live apiserver, and a test host often has no docker or kind to
run one.  This module is the
controller-runtime ``envtest`` idea scaled to what the operator actually
uses: a threaded HTTP server speaking the CustomObjects + corev1-events
subset of the Kubernetes API with faithful semantics for

- **resourceVersion** — one monotonic counter; PUT with a stale
  ``metadata.resourceVersion`` is a 409 (the optimistic-concurrency seam
  ``Reconciler._apply_object`` retries on);
- **generation** — bumped only when ``spec`` changes (what the watch
  runtime's generation-gated notify relies on);
- **merge-patch /status** — RFC 7386 merge on the status subresource with
  no generation bump;
- **watch streams** — chunked JSON-lines with ADDED/MODIFIED/DELETED
  events from the collection's change log, honoring ``resourceVersion``
  resume cursors, ``timeoutSeconds``, and emitting a 410-coded ERROR
  event when the cursor predates the retained log (`compact()` forces
  this for tests — the 410 recovery path CrWatcher must survive);
- **bearer-token auth** — 401 without the expected token (exercises the
  client's token-refresh path when combined with a token file).

Not implemented (the operator does not use them): field selectors, server
-side apply, OpenAPI validation, RBAC.  Use::

    with EnvtestServer(token="secret") as srv:
        client = KubeRestClient(base_url=srv.url, token="secret")
        ...

Runs entirely on loopback TCP — the same bytes a real apiserver would see.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

__all__ = ["EnvtestServer"]


def _merge(base: dict, patch: Any) -> Any:
    """RFC 7386 merge patch."""
    if not isinstance(patch, dict):
        return patch
    out = dict(base) if isinstance(base, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge(out.get(k, {}), v)
    return out


class _State:
    """Object store + per-collection change logs, one lock."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.rv = 0
        # (collection key, namespace, name) -> object dict
        self.objects: dict[tuple[str, str, str], dict] = {}
        # collection key -> list of (rv, event dict); compact() trims it
        self.log: dict[str, list[tuple[int, dict]]] = {}
        self.log_floor: dict[str, int] = {}
        # collection key -> condition to wake blocked watchers
        self.cond = threading.Condition(self.lock)

    def next_rv(self) -> int:
        self.rv += 1
        return self.rv

    def record(self, coll: str, etype: str, obj: dict) -> None:
        rv = int(obj["metadata"]["resourceVersion"])
        self.log.setdefault(coll, []).append((rv, {"type": etype, "object": obj}))
        self.cond.notify_all()

    def compact(self, coll: str, floor_rv: int) -> None:
        """Drop log entries at/below ``floor_rv`` — subsequent watches
        resuming from an older cursor get the 410 a real apiserver would
        produce after etcd compaction."""
        with self.lock:
            self.log_floor[coll] = max(self.log_floor.get(coll, 0), floor_rv)
            self.log[coll] = [
                (rv, e) for rv, e in self.log.get(coll, []) if rv > floor_rv
            ]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "envtest"
    state: _State  # set by EnvtestServer subclassing
    token: str | None

    # -- plumbing ----------------------------------------------------------

    def log_message(self, *a):  # quiet
        pass

    def _auth_ok(self) -> bool:
        if not self.token:
            return True
        return self.headers.get("Authorization") == f"Bearer {self.token}"

    def _body(self) -> Any:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw) if raw else None

    def _send(self, code: int, payload: Any) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _status(self, code: int, reason: str, message: str) -> None:
        self._send(
            code,
            {
                "kind": "Status",
                "apiVersion": "v1",
                "status": "Failure",
                "reason": reason,
                "message": message,
                "code": code,
            },
        )

    # -- path parsing ------------------------------------------------------

    def _parse(self):
        """-> (collection key, namespace, name, subresource, query dict)."""
        from urllib.parse import parse_qs, urlparse

        u = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        parts = [p for p in u.path.split("/") if p]
        # /apis/{group}/{version}/namespaces/{ns}/{plural}[/{name}[/{sub}]]
        # /api/{version}/namespaces/{ns}/{plural}[/{name}[/{sub}]]
        if not parts or parts[0] not in ("apis", "api"):
            return None
        idx = 3 if parts[0] == "apis" else 2
        group_version = "/".join(parts[1:idx])
        ns = None
        if len(parts) > idx and parts[idx] == "namespaces":
            ns = parts[idx + 1]
            idx += 2
        if len(parts) <= idx:
            return None
        plural = parts[idx]
        name = parts[idx + 1] if len(parts) > idx + 1 else None
        sub = parts[idx + 2] if len(parts) > idx + 2 else None
        # Collection key is namespace-agnostic so cluster-wide lists and
        # watches (no /namespaces/ segment) see every namespace's objects.
        coll = f"{group_version}/{plural}"
        return coll, ns, name, sub, q

    # -- verbs -------------------------------------------------------------

    def do_GET(self):
        if not self._auth_ok():
            return self._status(401, "Unauthorized", "bad token")
        parsed = self._parse()
        if not parsed:
            return self._status(404, "NotFound", "bad path")
        coll, ns, name, _sub, q = parsed
        st = self.state
        if name is None and q.get("watch") in ("1", "true"):
            return self._watch(coll, q, ns)
        with st.lock:
            if name is None:
                items = [
                    obj
                    for (c, ons, _n), obj in st.objects.items()
                    if c == coll and (ns is None or ons == ns)
                ]
                return self._send(
                    200,
                    {
                        "kind": "List",
                        "items": items,
                        "metadata": {"resourceVersion": str(st.rv)},
                    },
                )
            obj = st.objects.get((coll, ns or "", name))
            if obj is None:
                return self._status(404, "NotFound", f"{coll}/{name}")
            return self._send(200, obj)

    def do_POST(self):
        # Read the body FIRST, even on error paths: an undrained body
        # desyncs the keep-alive connection — the next request on the
        # pooled socket gets parsed out of leftover body bytes.
        body = self._body() or {}
        if not self._auth_ok():
            return self._status(401, "Unauthorized", "bad token")
        parsed = self._parse()
        if not parsed:
            return self._status(404, "NotFound", "bad path")
        coll, ns, _name, _sub, _q = parsed
        st = self.state
        name = (body.get("metadata") or {}).get("generateName")
        with st.lock:
            meta = dict(body.get("metadata") or {})
            if name:  # corev1 events use generateName
                meta["name"] = f"{name}{uuid.uuid4().hex[:6]}"
            if not meta.get("name"):
                return self._status(422, "Invalid", "metadata.name required")
            key = (coll, ns or "", meta["name"])
            if key in st.objects:
                return self._status(409, "AlreadyExists", meta["name"])
            meta.setdefault("namespace", ns)
            meta["uid"] = uuid.uuid4().hex
            meta["resourceVersion"] = str(st.next_rv())
            meta["generation"] = 1
            obj = dict(body)
            obj["metadata"] = meta
            st.objects[key] = obj
            st.record(coll, "ADDED", obj)
            return self._send(201, obj)

    def do_PUT(self):
        body = self._body() or {}  # drain first (see do_POST)
        if not self._auth_ok():
            return self._status(401, "Unauthorized", "bad token")
        parsed = self._parse()
        if not parsed or parsed[2] is None:
            return self._status(404, "NotFound", "bad path")
        coll, ns, name, _sub, _q = parsed
        st = self.state
        with st.lock:
            key = (coll, ns or "", name)
            old = st.objects.get(key)
            if old is None:
                return self._status(404, "NotFound", name)
            sent_rv = (body.get("metadata") or {}).get("resourceVersion")
            if sent_rv is not None and sent_rv != old["metadata"]["resourceVersion"]:
                return self._status(
                    409, "Conflict", f"stale resourceVersion {sent_rv}"
                )
            meta = dict(old["metadata"])
            meta["resourceVersion"] = str(st.next_rv())
            if body.get("spec") != old.get("spec"):
                meta["generation"] = int(meta.get("generation", 1)) + 1
            obj = dict(body)
            obj["metadata"] = meta
            # Status subresource semantics: PUT to the main resource
            # ignores the body's "status" and preserves the server-held
            # one — otherwise every operator manifest apply would wipe
            # the status its own patch_status wrote (real apiservers
            # with a status subresource behave this way).
            obj.pop("status", None)
            if "status" in old:
                obj["status"] = old["status"]
            st.objects[key] = obj
            st.record(coll, "MODIFIED", obj)
            return self._send(200, obj)

    def do_PATCH(self):
        patch = self._body() or {}  # drain first (see do_POST)
        if not self._auth_ok():
            return self._status(401, "Unauthorized", "bad token")
        parsed = self._parse()
        if not parsed or parsed[2] is None:
            return self._status(404, "NotFound", "bad path")
        coll, ns, name, sub, _q = parsed
        if "merge-patch" not in (self.headers.get("Content-Type") or ""):
            return self._status(415, "UnsupportedMediaType", "merge-patch only")
        st = self.state
        with st.lock:
            key = (coll, ns or "", name)
            old = st.objects.get(key)
            if old is None:
                return self._status(404, "NotFound", name)
            if sub == "status":
                patch = {"status": patch.get("status", {})}
            obj = _merge(old, patch)
            meta = dict(obj["metadata"])
            meta["resourceVersion"] = str(st.next_rv())
            # status patches never bump generation; spec merge would.
            if sub != "status" and obj.get("spec") != old.get("spec"):
                meta["generation"] = int(meta.get("generation", 1)) + 1
            obj["metadata"] = meta
            st.objects[key] = obj
            st.record(coll, "MODIFIED", obj)
            return self._send(200, obj)

    def do_DELETE(self):
        if not self._auth_ok():
            return self._status(401, "Unauthorized", "bad token")
        parsed = self._parse()
        if not parsed or parsed[2] is None:
            return self._status(404, "NotFound", "bad path")
        coll, ns, name, _sub, _q = parsed
        st = self.state
        with st.lock:
            obj = st.objects.pop((coll, ns or "", name), None)
            if obj is None:
                return self._status(404, "NotFound", name)
            meta = dict(obj["metadata"])
            meta["resourceVersion"] = str(st.next_rv())
            obj = dict(obj)
            obj["metadata"] = meta
            st.record(coll, "DELETED", obj)
            return self._send(200, obj)

    # -- watch -------------------------------------------------------------

    def _watch(self, coll: str, q: dict, ns: str | None = None) -> None:
        st = self.state
        deadline = time.monotonic() + float(q.get("timeoutSeconds") or 300)
        cursor = int(q.get("resourceVersion") or 0)

        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_line(payload: dict) -> bool:
            data = json.dumps(payload).encode() + b"\n"
            try:
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()
                return True
            except OSError:
                return False  # client went away

        with st.lock:
            # Strict: a cursor exactly at the floor misses nothing — the
            # floor IS the rv a fresh post-compaction list returns, and
            # 410ing it would spin CrWatcher in a list->watch->410 loop.
            if cursor and cursor < st.log_floor.get(coll, 0):
                write_line(
                    {
                        "type": "ERROR",
                        "object": {
                            "kind": "Status",
                            "code": 410,
                            "reason": "Expired",
                            "message": f"resourceVersion {cursor} compacted",
                        },
                    }
                )
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass
                return

        def select(cur):
            return [
                e
                for rv, e in st.log.get(coll, [])
                if rv > cur
                and (
                    ns is None
                    or e["object"].get("metadata", {}).get("namespace") == ns
                )
            ]

        while time.monotonic() < deadline:
            with st.cond:
                pending = select(cursor)
                if not pending:
                    st.cond.wait(timeout=0.2)
                    pending = select(cursor)
            for event in pending:
                cursor = int(event["object"]["metadata"]["resourceVersion"])
                if not write_line(event):
                    return
        try:
            self.wfile.write(b"0\r\n\r\n")  # clean chunked EOF on timeout
        except OSError:
            pass


class EnvtestServer:
    """Threaded loopback apiserver; ``url`` is its base URL."""

    def __init__(self, token: str | None = None):
        self.state = _State()
        handler = type(
            "BoundHandler", (_Handler,), {"state": self.state, "token": token}
        )
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    def start(self) -> "EnvtestServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "EnvtestServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # test helper: force "etcd compaction" so old watch cursors 410
    def compact(self, group_version: str, plural: str) -> None:
        self.state.compact(f"{group_version}/{plural}", self.state.rv)
