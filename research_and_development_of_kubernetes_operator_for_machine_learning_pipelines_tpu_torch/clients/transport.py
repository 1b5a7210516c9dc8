"""The HTTP seam of the port's REST clients (``kube_rest``, ``mlflow_rest``,
``prom_http``, ``dataplane``).

The JAX package's clients are built on ``httpx``; the card's machine has no
``httpx``, so these speak HTTP through the standard library.  Every client
takes a *transport*: a callable

    transport(method, url, headers, body) -> (status, headers, body)

with ``url`` absolute, ``headers`` a dict, ``body`` bytes or None, and the
response body bytes.  A transport raises :class:`TransportError` when no
HTTP answer came back at all (refused, reset, timed out) — what
``httpx.HTTPError`` is to the reference.  A transport MAY also have a
``stream(method, url, headers, body, timeout)`` method returning ``(status,
headers, lines)`` with ``lines`` an iterator of the body's lines as they
arrive and a ``close()``; the Kubernetes watch uses it when present and
otherwise splits a whole body into lines.  Tests script responses by
passing their own callable.
"""

from __future__ import annotations

import http.client
import json
import ssl
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Iterator, Mapping

Transport = Callable[[str, str, Mapping[str, str], "bytes | None"],
                     "tuple[int, Mapping[str, str], bytes]"]


class TransportError(OSError):
    """No HTTP response: connection refused or reset, DNS, timeout."""


def json_body(obj: Any) -> bytes:
    """A JSON request body as ``httpx`` writes ``json=`` (compact, UTF-8)."""
    return json.dumps(obj, ensure_ascii=False, separators=(",", ":"),
                      allow_nan=False).encode()


def with_query(url: str, params: Mapping[str, str] | None) -> str:
    """``url`` with ``params`` form-encoded as its query string."""
    if not params:
        return url
    return f"{url}?{urllib.parse.urlencode(dict(params))}"


def ssl_context(verify: Any) -> ssl.SSLContext:
    """``verify`` as ``httpx`` reads it: True (system CAs), False (no
    check), or a CA bundle path."""
    if verify is True or verify is None:
        return ssl.create_default_context()
    if verify is False:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    return ssl.create_default_context(cafile=str(verify))


class _Lines:
    """An open response read line by line; a read timeout ends it."""

    def __init__(self, resp):
        self._resp = resp

    def __iter__(self) -> Iterator[bytes]:
        try:
            while True:
                try:
                    line = self._resp.readline()
                except (OSError, http.client.HTTPException):  # a read timeout included
                    return
                if not line:
                    return
                yield line
        finally:
            self.close()

    def close(self) -> None:
        try:
            self._resp.close()
        except Exception:
            pass


class UrllibTransport:
    """The default transport: ``urllib.request`` with an optional TLS
    context.  Error statuses come back as responses, not exceptions."""

    def __init__(self, timeout: float = 30.0, verify: Any = True):
        self.timeout = float(timeout)
        self._opener = urllib.request.build_opener(
            _NoRedirect(), urllib.request.HTTPSHandler(context=ssl_context(verify)))

    def _open(self, method, url, headers, body, timeout):
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=dict(headers or {}))
        try:
            return self._opener.open(req, timeout=timeout), None
        except urllib.error.HTTPError as e:
            return None, e
        except (urllib.error.URLError, http.client.HTTPException, OSError) as e:
            raise TransportError(str(getattr(e, "reason", e))) from e

    def __call__(self, method: str, url: str, headers: Mapping[str, str],
                 body: bytes | None):
        resp, err = self._open(method, url, headers, body, self.timeout)
        if err is not None:
            with err:
                return err.code, dict(err.headers or {}), err.read()
        with resp:
            try:
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                raise TransportError(str(e)) from e
            return resp.status, dict(resp.headers), data

    def stream(self, method: str, url: str, headers: Mapping[str, str],
               body: bytes | None, timeout: float):
        resp, err = self._open(method, url, headers, body, timeout)
        if err is not None:
            with err:
                return err.code, dict(err.headers or {}), iter([err.read()])
        return resp.status, dict(resp.headers), _Lines(resp)


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """Hand 3xx back to the caller, as ``httpx`` does by default."""

    def redirect_request(self, *args, **kwargs):
        return None


def split_lines(body: bytes | Any) -> Iterator[bytes]:
    """A whole body (bytes) or an already line-wise stream, as lines."""
    if isinstance(body, (bytes, bytearray)):
        return iter(bytes(body).splitlines())
    return iter(body)
