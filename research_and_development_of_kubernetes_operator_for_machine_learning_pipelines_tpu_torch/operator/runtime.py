"""Operator runtime: watches ``MlflowModel`` CRs and drives reconcilers.

Replaces kopf's role in the reference (``@kopf.on.create``/``on.update``,
``mlflow_operator.py:26-27``) with an explicit scheduler:

- one ``Reconciler`` per CR, created/removed as CRs appear/disappear;
- each reconcile step returns ``requeue_after``; the runtime maintains a
  per-resource due time instead of per-handler sleep loops — so N edits to a
  CR never spawn N competing monitors (fixes SURVEY §3.5(1));
- CR deletion stops the reconciler and deletes its data plane (the reference
  has no delete handler and leans entirely on ownerReferences GC;
  we do both — GC in-cluster via ownerReferences, explicit delete here so
  fakes and non-GC stores behave identically);
- reconcile errors back off exponentially instead of killing the handler
  (the reference's unhandled exceptions end monitoring forever, §5).

Deterministic by construction: with a ``FakeClock`` the test advances time
and calls ``run_until_idle``; with the ``SystemClock`` ``serve`` runs a real
loop.

Event-driven reaction (the reference's kopf watch registration,
``mlflow_operator.py:26-27``): :class:`CrWatcher` consumes the API server's
watch stream (``KubeClient.watch``) and pokes the runtime — a CR add, edit,
or delete reconciles immediately instead of waiting out the resync poll.
The poll in ``sync()`` stays as the level-triggered fallback, so a dropped
watch event can delay a reconcile but never lose it.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

from ..clients.base import (
    KubeClient,
    MetricsSource,
    NotFound,
    ObjectRef,
    RegistryClient,
    MLFLOWMODEL,
    SELDONDEPLOYMENT,
)
from ..utils.clock import Clock, FakeClock, SystemClock
from .reconciler import Reconciler

_log = logging.getLogger(__name__)

_MAX_BACKOFF_S = 300.0


@dataclass
class _Entry:
    reconciler: Reconciler
    due_at: float
    failures: int = 0
    # metadata.generation of the object at its last reconcile.  The API
    # server bumps generation on spec changes only — never on status
    # patches — which is what lets notify() tell a user edit (reconcile
    # now) from the reconciler's own status writes (don't touch pacing).
    generation: int | None = None
    # Bumped by notify(): a reconcile completing after a notify must not
    # overwrite the notify's due-now with its computed requeue.
    epoch: int = 0


class OperatorRuntime:
    def __init__(
        self,
        kube: KubeClient,
        registry: RegistryClient,
        metrics: MetricsSource | None = None,
        clock: Clock | None = None,
        namespace: str = "",
        sync_interval_s: float = 5.0,
        metrics_factory=None,
        warmup=None,
        telemetry=None,
        recorder=None,
        max_concurrent_reconciles: int = 1,
        mux_pools=None,
        ring_sources=None,
    ):
        if metrics is None and metrics_factory is None:
            raise ValueError(
                "OperatorRuntime needs metrics or metrics_factory — failing "
                "here, not on first CR, so misconfiguration dies at startup"
            )
        self.kube = kube
        self.registry = registry
        self.metrics = metrics
        self.metrics_factory = metrics_factory
        self.warmup = warmup
        self.telemetry = telemetry  # OperatorTelemetry | None (SURVEY §5)
        self.recorder = recorder  # RolloutRecorder | None (gate journal)
        # Mapping[poolRef, Multiplexer] — the shared warm-pool
        # coordinators CRs with spec.multiplex bind to.  Runtime-owned
        # (one coordinator outlives any single CR), reconciler-driven.
        self.mux_pools = mux_pools
        # Zero-arg callable returning fleet ring snapshots
        # ({"replicas": {name: snapshot}, "router": snapshot|None}) for
        # the anomaly observatory; None = spec.anomaly CRs detect
        # nothing (the seam is runtime wiring, not per-CR config).
        self.ring_sources = ring_sources
        self.clock = clock or SystemClock()
        self.namespace = namespace
        self.sync_interval_s = sync_interval_s
        self._entries: dict[tuple[str, str], _Entry] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        # Set by notify() (watch events) to cut a serve() sleep short.
        self._wake = threading.Event()
        # Reconciles of DISTINCT CRs may run concurrently (kopf runs
        # handlers concurrently; controller-runtime calls this knob
        # MaxConcurrentReconciles): without it one CR with a slow metrics
        # source stalls every other rollout.  Entries are never reconciled
        # concurrently with themselves — step() partitions by entry.
        self.max_concurrent_reconciles = max(1, int(max_concurrent_reconciles))
        self._pool = None
        # Keys currently being reconciled on the pool: step() neither
        # re-submits them (a CR is never reconciled concurrently with
        # itself) nor counts their stale due_at toward the next-due delay
        # (which would spin the serve loop hot for the whole reconcile).
        self._in_flight: set[tuple[str, str]] = set()
        # Bumped by notify(): a reconcile that finishes AFTER a watch
        # event must not clobber the event's due-now with its requeue.
        self._epoch = 0
        if self.max_concurrent_reconciles > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.max_concurrent_reconciles,
                thread_name_prefix="reconcile",
            )

    # -- discovery -----------------------------------------------------------

    def _list_ref(self) -> ObjectRef:
        return ObjectRef(namespace=self.namespace, name="", **MLFLOWMODEL)

    def sync(self) -> None:
        """Reconcile the set of reconcilers with the set of CRs."""
        with self._lock:
            seen: set[tuple[str, str]] = set()
            for obj in self.kube.list(self._list_ref()):
                meta = obj.get("metadata") or {}
                key = (meta.get("namespace", "default"), meta.get("name", ""))
                seen.add(key)
                if key not in self._entries:
                    ns, name = key
                    _log.info("tracking MlflowModel %s/%s", ns, name)
                    self._entries[key] = _Entry(
                        reconciler=Reconciler(
                            name=name,
                            namespace=ns,
                            kube=self.kube,
                            registry=self.registry,
                            metrics=self.metrics,
                            clock=self.clock,
                            metrics_factory=self.metrics_factory,
                            warmup=self.warmup,
                            recorder=self.recorder,
                            mux_pools=self.mux_pools,
                            ring_sources=self.ring_sources,
                        ),
                        due_at=self.clock.now(),  # reconcile promptly
                    )
            for key in list(self._entries):
                if key not in seen:
                    ns, name = key
                    _log.info("MlflowModel %s/%s deleted; tearing down", ns, name)
                    entry = self._entries.pop(key)
                    try:
                        entry.reconciler._delete_deployment()
                    except Exception:
                        _log.exception("teardown of %s/%s failed", ns, name)
                    if self.telemetry is not None:
                        self.telemetry.forget(ns, name)
                    if self.recorder is not None:
                        self.recorder.forget(ns, name)

    def notify(
        self,
        namespace: str,
        name: str,
        obj: dict | None = None,
        event_type: str = "MODIFIED",
    ) -> None:
        """React to a watch event: maybe mark the CR due now, wake serve.

        The canary's pacing (step intervals, gate retry delays) lives in
        ``requeue_after`` — so a MODIFIED event may only pull the due time
        forward when the *spec* changed.  The API server bumps
        ``metadata.generation`` on spec changes and never on status
        patches; without this check the reconciler's own status writes
        would echo back through the watch and each canary step would
        immediately schedule the next, promoting 0→100% in milliseconds
        with every gate interval skipped.

        Unknown keys (a just-created CR, or a deletion) need no per-entry
        action: ``step()`` always runs ``sync()`` first, which picks up
        adds and tears down deletes — waking is enough.
        """
        with self._lock:
            entry = self._entries.get((namespace, name))
            if entry is not None:
                # ADDED must take the same path: a reconnecting watch with
                # no cursor replays synthetic ADDED for every live object,
                # and those must not reset pacing either.
                if event_type in ("ADDED", "MODIFIED") and obj is not None:
                    gen = (obj.get("metadata") or {}).get("generation")
                    if gen is not None and gen == entry.generation:
                        return  # status echo / watch replay; pacing stands
                entry.due_at = self.clock.now()
                entry.epoch += 1
        self._wake.set()

    # -- stepping ------------------------------------------------------------

    def _set_due(self, entry: _Entry, epoch: int, due_at: float) -> None:
        """Write the post-reconcile due time unless a notify() landed
        mid-reconcile — its due-now wins over our computed requeue."""
        with self._lock:
            if entry.epoch == epoch:
                entry.due_at = due_at

    def _reconcile_one(self, key: tuple[str, str], entry: _Entry) -> None:
        ns, name = key
        t0 = time.perf_counter()
        with self._lock:
            epoch = entry.epoch
        try:
            obj = self.kube.get(
                ObjectRef(namespace=ns, name=name, **MLFLOWMODEL)
            )
            entry.generation = (obj.get("metadata") or {}).get("generation")
            outcome = entry.reconciler.reconcile(dict(obj))
            entry.failures = 0
            self._set_due(
                entry, epoch, self.clock.now() + max(0.0, outcome.requeue_after)
            )
            if self.telemetry is not None:
                self.telemetry.record_outcome(
                    ns, name, outcome, time.perf_counter() - t0
                )
        except NotFound:
            pass  # sync() on the next step removes it
        except Exception:
            entry.failures += 1
            backoff = min(_MAX_BACKOFF_S, 2.0 ** entry.failures)
            self._set_due(entry, epoch, self.clock.now() + backoff)
            if self.telemetry is not None:
                self.telemetry.record_failure(ns, name, time.perf_counter() - t0)
            _log.exception(
                "reconcile of %s/%s failed (attempt %d), backing off %.0fs",
                ns,
                name,
                entry.failures,
                backoff,
            )

    def step(self) -> float | None:
        """Run every due reconciler once.

        Returns seconds until the next entry is due (None if no entries).
        Never raises: API-server outages (during discovery or reconcile)
        back off instead of killing the runtime — the reference's unhandled
        exceptions silently end monitoring forever (SURVEY §5).
        """
        try:
            self.sync()
        except Exception:
            _log.exception("CR discovery failed; retrying next step")
        now = self.clock.now()
        with self._lock:
            due = [
                (k, e)
                for k, e in self._entries.items()
                if e.due_at <= now and k not in self._in_flight
            ]
        if self._pool is not None:
            # Fire-and-continue, NO barrier: one slow CR must not gate
            # anyone else's next round (controller-runtime semantics).
            # Completion wakes serve() to recompute the next due time.
            for key, entry in due:
                with self._lock:
                    self._in_flight.add(key)
                try:
                    fut = self._pool.submit(self._reconcile_one, key, entry)
                except RuntimeError:  # pool shut down mid-step (stop())
                    with self._lock:
                        self._in_flight.discard(key)
                    break
                fut.add_done_callback(
                    lambda _f, key=key: self._reconcile_done(key)
                )
        else:
            for key, entry in due:
                self._reconcile_one(key, entry)
        with self._lock:
            if self.telemetry is not None:
                self.telemetry.set_resource_count(len(self._entries))
            # In-flight entries' due_at is stale (past); counting them
            # would spin the serve loop for the whole reconcile.
            pending = [
                e.due_at
                for k, e in self._entries.items()
                if k not in self._in_flight
            ]
            if not pending:
                return None
            return max(0.0, min(pending) - self.clock.now())

    def _reconcile_done(self, key: tuple[str, str]) -> None:
        with self._lock:
            self._in_flight.discard(key)
        self._wake.set()

    # -- loops ---------------------------------------------------------------

    def run_until_idle(self, max_wall: float = 3600.0, max_steps: int = 10_000) -> None:
        """Test loop for ``FakeClock``: step, then jump the clock to the next
        due time, until nothing is due within ``max_wall`` fake-seconds."""
        if not isinstance(self.clock, FakeClock):
            raise TypeError("run_until_idle requires a FakeClock")
        deadline = self.clock.now() + max_wall
        for _ in range(max_steps):
            delay = self.step()
            if delay is None:
                return
            if delay > 0:
                if self.clock.now() + delay > deadline:
                    return
                self.clock.advance(delay)
        raise RuntimeError("run_until_idle did not settle (livelock?)")

    def run_for(self, fake_seconds: float, max_steps: int = 10_000) -> None:
        """Advance a ``FakeClock`` by ``fake_seconds``, stepping as entries
        come due."""
        if not isinstance(self.clock, FakeClock):
            raise TypeError("run_for requires a FakeClock")
        deadline = self.clock.now() + fake_seconds
        for _ in range(max_steps):
            delay = self.step()
            remaining = deadline - self.clock.now()
            if remaining <= 0:
                return
            if delay is None:
                self.clock.advance(remaining)
                return
            self.clock.advance(min(delay, remaining) if delay > 0 else 0)
            if delay == 0:
                continue
        raise RuntimeError("run_for did not settle (livelock?)")

    def serve(self) -> None:
        """Real-time loop (SystemClock)."""
        _log.info("operator runtime serving (namespace=%r)", self.namespace or "*")
        while not self._stop.is_set():
            try:
                delay = self.step()
            except Exception:  # belt and braces: serve() must never die
                _log.exception("runtime step failed")
                delay = self.sync_interval_s
            sleep_for = self.sync_interval_s if delay is None else min(delay, self.sync_interval_s)
            # Sleep until the next due time OR a watch notification —
            # whichever comes first.  stop() also sets _wake so shutdown
            # never waits out a sleep.
            if self._wake.wait(max(0.05, sleep_for)):
                self._wake.clear()

    def stop(self, drain_s: float = 0.0) -> None:
        """Stop the serve loop; optionally drain in-flight reconciles.

        ``drain_s > 0`` bounds a wait for reconciles already running on
        the pool.  On leadership loss this matters: shutdown(wait=False)
        only cancels *pending* work, and a slow in-flight reconcile that
        keeps patching status past the takeover window briefly
        reintroduces the dual-writer the Lease exists to prevent.  The
        wait is bounded (not ``shutdown(wait=True)``) so a hung metrics
        source cannot wedge teardown past the successor's takeover.
        """
        self._stop.set()
        self._wake.set()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            if drain_s <= 0:
                # No drain requested — and stop() may be running inside a
                # signal handler on the serve thread itself, where taking
                # self._lock (held by step()) would self-deadlock.
                return
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._in_flight:
                        return
                time.sleep(0.05)
            with self._lock:
                leftover = set(self._in_flight)
            if leftover:
                _log.warning(
                    "stop: %d reconcile(s) still running after %.1fs drain "
                    "(%s) — a new leader may observe overlapping writes",
                    len(leftover), drain_s, sorted(leftover),
                )


class CrWatcher:
    """Event-driven bridge: API-server watch stream → ``runtime.notify``.

    The push half of the informer pattern (the reference gets this from
    kopf's watch registration, ``mlflow_operator.py:26-27``).  Lifecycle:

    - list once for a resourceVersion cursor, then stream events from it;
    - track the cursor through object and BOOKMARK events so a reconnect
      resumes where it left off instead of replaying history;
    - on 410 Gone (cursor fell out of etcd history) re-list for a fresh
      cursor — the standard re-list contract;
    - on transport errors reconnect with capped exponential backoff;
    - every delivered event just pokes the runtime: reconcile state lives
      in ``OperatorRuntime``/``Reconciler``; the watcher carries no state
      worth preserving, so a crashed watcher degrades to poll-only, it
      never wedges the operator.
    """

    def __init__(
        self,
        runtime: OperatorRuntime,
        timeout_s: int = 300,
        max_backoff_s: float = 30.0,
    ):
        kube = runtime.kube
        if not hasattr(kube, "watch"):
            raise TypeError(
                f"{type(kube).__name__} has no watch(); CrWatcher needs a "
                "watch-capable KubeClient (KubeRestClient or FakeKube)"
            )
        self.runtime = runtime
        self.timeout_s = timeout_s
        self.max_backoff_s = max_backoff_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "CrWatcher":
        self._thread = threading.Thread(
            target=self.run, daemon=True, name=type(self).__name__
        )
        self._thread.start()
        return self

    def _ref(self):
        """The collection this watcher streams (MlflowModels)."""
        return self.runtime._list_ref()

    def _handle(self, ev) -> None:
        meta = ev.object.get("metadata") or {}
        self.runtime.notify(
            meta.get("namespace", "default"),
            meta.get("name", ""),
            obj=dict(ev.object),
            event_type=ev.type,
        )

    def run(self) -> None:
        from ..clients.base import WatchExpired

        ref = self._ref()
        rv: str | None = None
        failures = 0
        while not self._stop.is_set():
            try:
                if rv is None:
                    if hasattr(self.runtime.kube, "list_with_version"):
                        _, rv = self.runtime.kube.list_with_version(ref)
                    else:
                        rv = ""
                    # The snapshot may differ from the runtime's view
                    # (adds/deletes during the gap): force a resync pass.
                    self.runtime._wake.set()
                for ev in self.runtime.kube.watch(
                    ref, resource_version=rv or None,
                    timeout_s=self.timeout_s, stop=self._stop,
                ):
                    failures = 0
                    meta = ev.object.get("metadata") or {}
                    if meta.get("resourceVersion"):
                        rv = meta["resourceVersion"]
                    if ev.type == "BOOKMARK":
                        continue
                    self._handle(ev)
                # Server closed the stream (watch timeout): reconnect from
                # the current cursor without re-listing.
            except WatchExpired:
                _log.info("watch cursor expired; re-listing")
                rv = None
            except Exception:
                failures += 1
                backoff = min(self.max_backoff_s, 2.0 ** min(failures, 16))
                _log.exception("watch failed; reconnecting in %.0fs", backoff)
                rv = None
                self._stop.wait(backoff)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # A real watch blocked in a read only observes stop after the
            # client's 15s read timeout — join must outlast it.
            self._thread.join(timeout=20)


class DeploymentWatcher(CrWatcher):
    """Watch SeldonDeployments and heal out-of-band deletions immediately.

    Only DELETED events react: the operator's own applies echo back as
    ADDED/MODIFIED and must not reset reconcile pacing, and any foreign
    edit is overwritten by the next apply anyway.  A deleted deployment
    whose (namespace, name) matches a tracked CR pulls that CR due NOW,
    so ``Reconciler._ensure_deployment`` recreates it in milliseconds
    instead of after the resync poll.
    """

    def _ref(self):
        return ObjectRef(
            namespace=self.runtime.namespace, name="", **SELDONDEPLOYMENT
        )

    def _handle(self, ev) -> None:
        if ev.type != "DELETED":
            return
        meta = ev.object.get("metadata") or {}
        self.runtime.notify(
            meta.get("namespace", "default"),
            meta.get("name", ""),
            obj=None,
            event_type="DELETED",
        )
