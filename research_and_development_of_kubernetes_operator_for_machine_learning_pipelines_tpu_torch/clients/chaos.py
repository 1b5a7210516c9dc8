"""Fault injection for client protocols (test/chaos harness; the port's
copy of the JAX package's ``clients/chaos.py``, the standard library only).

The reference has no fault injection of any kind (SURVEY §5) and its
promotion loop dies on the first unhandled Prometheus/MLflow exception
(``mlflow_operator.py`` only try/excepts the alias lookup, ``:58-62``).
The rebuild's recovery guarantees — reconcile backoff, resumable promotion
state, alias self-healing — are only guarantees if they're exercised, so
this wrapper makes any injected client (kube / registry / metrics) fail on
a script.

``FaultInjector`` proxies attributes of the wrapped client; its own
control surface is ``inject_``-prefixed so it can never shadow a wrapped
method (e.g. ``FakeMetrics.clear``).  Scheduled faults are consumed per
method call:

    metrics = FaultInjector(FakeMetrics())
    metrics.inject_fail("model_metrics", ApiError(503, "prom down"), times=4)
    ...
    metrics.inject_fail_if("apply", lambda ns, name: name == "canary",
                           Conflict(...))

Works against the fakes in tests and equally against the real REST clients
for in-cluster chaos runs.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable


class FaultInjector:
    def __init__(self, target: Any):
        self._target = target
        self._lock = threading.Lock()
        self._scheduled: dict[str, list[Exception]] = {}
        self._conditional: dict[str, list[tuple[Callable[..., bool], Exception]]] = {}
        self.proxy_calls: list[tuple[str, tuple, dict]] = []
        self.faults_fired: int = 0

    # -- scheduling ----------------------------------------------------------

    def inject_fail(self, method: str, exc: Exception, times: int = 1) -> None:
        """Fail the next ``times`` calls of ``method`` with ``exc``."""
        with self._lock:
            self._scheduled.setdefault(method, []).extend([exc] * times)

    def inject_fail_if(
        self, method: str, predicate: Callable[..., bool], exc: Exception
    ) -> None:
        """Fail any call of ``method`` whose arguments satisfy ``predicate``
        (checked after scheduled faults; not consumed — fires every time)."""
        with self._lock:
            self._conditional.setdefault(method, []).append((predicate, exc))

    def inject_clear(self, method: str | None = None) -> None:
        with self._lock:
            if method is None:
                self._scheduled.clear()
                self._conditional.clear()
            else:
                self._scheduled.pop(method, None)
                self._conditional.pop(method, None)

    def inject_pending(self, method: str) -> int:
        with self._lock:
            return len(self._scheduled.get(method, []))

    # -- proxying ------------------------------------------------------------

    def __getattr__(self, attr: str) -> Any:
        value = getattr(self._target, attr)
        if not callable(value):
            return value

        def wrapper(*args, **kwargs):
            with self._lock:
                queued = self._scheduled.get(attr)
                if queued:
                    exc = queued.pop(0)
                    self.faults_fired += 1
                    raise exc
                for predicate, exc in self._conditional.get(attr, []):
                    if predicate(*args, **kwargs):
                        self.faults_fired += 1
                        raise exc
                self.proxy_calls.append((attr, args, kwargs))
            return value(*args, **kwargs)

        return wrapper


class ChaosProxy:
    """Data-plane fault injection: a TCP proxy whose failures are scripted.

    ``FaultInjector`` above covers the *control* plane (Python clients
    whose method calls can raise on a script); the data plane — the
    native router proxying bytes to live replica sockets — needs faults
    at the WIRE level.  Park a ChaosProxy between the router and a real
    backend (``--backend name=127.0.0.1:<proxy.port>:w``) and script the
    three failure shapes the failure-containment layer must contain:

    - ``inject_refuse(times)``: the next ``times`` connections are
      accepted and immediately reset — the upstream dies before any
      response byte (connect-level failure: trips circuits, is
      failover-idempotent);
    - ``inject_kill_midstream(times, after_bytes)``: the request is
      relayed, then the response is cut after ``after_bytes`` bytes —
      generation has started, so the request is NOT failover-eligible
      (typed 503 / SSE terminal error territory);
    - ``inject_slow(delay_s, times)``: the response is held for
      ``delay_s`` before relaying (deadline-exceeded shape for probe /
      client-timeout tests).  As in the JAX package's proxy, only a
      connection's first response is held: a keep-alive client's later
      requests pass at full speed.  ``each_response=True`` holds every
      response the scripted connection relays, the shape of a replica
      whose link is slow (the router pools its upstream connections).

    Unscripted connections pass through byte-for-byte, both directions,
    so the proxy is invisible until a fault is scheduled.  ``stop()``
    closes the listener entirely — the classic dead-pod ECONNREFUSED —
    and ``restart()`` brings it back on the SAME port (the half-open
    probe re-admission story).  Thread-per-connection: chaos tests run a
    handful of concurrent requests, not production load.
    """

    def __init__(self, upstream_port: int, host: str = "127.0.0.1"):
        self.upstream = (host, int(upstream_port))
        self._lock = threading.Lock()
        # Scripted modes, consumed one per ACCEPTED connection, in
        # schedule order: ("refuse", None) | ("kill", after_bytes) |
        # ("slow", delay_s).
        self._script: list[tuple[str, float | int | None]] = []
        self.connections = 0
        self.faults_fired = 0
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._stopping = False
        # Live relay sockets, severed on stop(): a dead pod kills its
        # established connections too, not just the listener.
        self._active: set[socket.socket] = set()
        self.port = 0
        self._bind()

    # -- scripting -----------------------------------------------------------

    def inject_refuse(self, times: int = 1) -> None:
        with self._lock:
            self._script.extend([("refuse", None)] * times)

    def inject_kill_midstream(
        self, times: int = 1, after_bytes: int = 1
    ) -> None:
        with self._lock:
            self._script.extend([("kill", int(after_bytes))] * times)

    def inject_slow(self, delay_s: float, times: int = 1,
                    each_response: bool = False) -> None:
        mode = "slow_each" if each_response else "slow"
        with self._lock:
            self._script.extend([(mode, float(delay_s))] * times)

    def inject_clear(self) -> None:
        with self._lock:
            self._script.clear()

    def inject_pending(self) -> int:
        with self._lock:
            return len(self._script)

    # -- lifecycle -----------------------------------------------------------

    def _bind(self) -> None:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", self.port))  # 0 first time; sticky after
        listener.listen(64)
        self.port = listener.getsockname()[1]
        self._listener = listener
        self._stopping = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-proxy"
        )
        self._accept_thread.start()

    def stop(self) -> None:
        """The hard kill: close the listener (new connections see
        ECONNREFUSED) AND sever every established relay — a dead pod
        takes its open sockets with it, which is exactly what the
        router's before-first-byte/EOF-mid-response handling must
        contain."""
        self._stopping = True
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            # The accept thread may be BLOCKED inside accept() — CPython
            # defers the fd close while another thread is in a socket
            # call, so the OS keeps accepting into the backlog.  One
            # self-connection wakes it; the post-stop accept is dropped
            # by the loop's stopping check.
            try:
                socket.create_connection(
                    ("127.0.0.1", self.port), timeout=1
                ).close()
            except OSError:
                pass
            self._listener = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        with self._lock:
            active = list(self._active)
        for s in active:
            # shutdown, not close: relay threads may be blocked inside
            # recv on these sockets, and CPython defers the fd close
            # while another thread is in a socket call.
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def restart(self) -> None:
        """Re-listen on the SAME port (the pod-restarted shape the
        half-open probe re-admits)."""
        if self._listener is None:
            self._bind()

    # -- relay ---------------------------------------------------------------

    def _next_fault(self) -> tuple[str, float | int | None] | None:
        with self._lock:
            if self._script:
                self.faults_fired += 1
                return self._script.pop(0)
        return None

    def _accept_loop(self) -> None:
        listener = self._listener
        while not self._stopping and listener is not None:
            try:
                client, _ = listener.accept()
            except OSError:  # listener closed by stop()
                return
            if self._stopping:
                # Accepted between stop() and the fd actually closing
                # (incl. the wake-up poke): a dead pod serves nobody.
                try:
                    client.close()
                except OSError:
                    pass
                return
            self.connections += 1
            fault = self._next_fault()
            if fault is not None and fault[0] == "refuse":
                # Before-first-byte death: RST beats FIN here (a FIN on
                # an unanswered request is the same EOF-mid-response
                # shape; RST is the unambiguous connect-level failure).
                try:
                    client.setsockopt(
                        socket.SOL_SOCKET, socket.SO_LINGER,
                        b"\x01\x00\x00\x00\x00\x00\x00\x00",
                    )
                    client.close()
                except OSError:
                    pass
                continue
            threading.Thread(
                target=self._relay, args=(client, fault), daemon=True
            ).start()

    def _relay(self, client: socket.socket, fault) -> None:
        mode, arg = fault if fault is not None else (None, None)
        try:
            up = socket.create_connection(self.upstream, timeout=10)
        except OSError:
            client.close()
            return
        with self._lock:
            self._active.add(client)
            self._active.add(up)
        stop = threading.Event()
        # "slow_each": a request relayed upstream arms the hold of the
        # response that answers it.
        request_seen = threading.Event()

        def pump_up() -> None:  # client -> upstream, transparent
            try:
                while not stop.is_set():
                    data = client.recv(65536)
                    if not data:
                        break
                    request_seen.set()
                    up.sendall(data)
            except OSError:
                pass
            finally:
                try:
                    up.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

        t = threading.Thread(target=pump_up, daemon=True)
        t.start()
        relayed = 0
        try:
            if mode == "slow":
                # Hold the RESPONSE, not the request: the upstream gets
                # the work; the caller waits past its deadline.
                time.sleep(float(arg))
            while True:
                data = up.recv(65536)
                if not data:
                    break
                if mode == "slow_each" and request_seen.is_set():
                    request_seen.clear()
                    time.sleep(float(arg))
                if mode == "kill":
                    take = max(0, int(arg) - relayed)
                    client.sendall(data[:take])
                    relayed += len(data[:take])
                    if relayed >= int(arg):
                        # Mid-stream kill: response bytes are out, then
                        # the connection dies (EOF mid-response — the
                        # first-byte-seen failure class).
                        break
                else:
                    client.sendall(data)
                    relayed += len(data)
        except OSError:
            pass
        finally:
            stop.set()
            with self._lock:
                self._active.discard(client)
                self._active.discard(up)
            for s in (client, up):
                # shutdown BEFORE close: pump_up is blocked in recv on
                # this socket, and CPython defers the fd close while
                # another thread is inside a socket call — without the
                # shutdown the peer never sees the connection die.
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
