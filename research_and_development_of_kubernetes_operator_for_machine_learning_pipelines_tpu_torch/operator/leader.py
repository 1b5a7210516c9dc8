"""Lease-based leader election: makes ``replicas > 1`` safe (the port's
copy of the JAX package's ``operator/leader.py``, on the port's
``clients/base.py`` and ``utils/clock.py``).

The reference pins the operator at one replica
(``mlflow-operator-deployment.yaml:7``) and has no election — a second
replica would double-reconcile every CR and race the promotion loops.
This module implements the standard Kubernetes pattern on
``coordination.k8s.io/v1`` Leases (what client-go's leaderelection and
kopf's peering provide) over the same generic object client the operator
already uses, so FakeKube serves tests unchanged:

- acquire: create the Lease, or take it over when expired; optimistic
  concurrency (resourceVersion on replace) makes simultaneous takeovers
  resolve to exactly one winner — the loser sees 409;
- renew: the holder refreshes ``renewTime`` every ``renew_interval_s``;
- step-down: if renewing fails past ``renew_deadline_s`` (strictly less
  than the lease duration, client-go style) the elector reports loss so
  the caller stops reconciling BEFORE any challenger may act on the
  expired lease; SIGTERM additionally releases the lease so successors
  need not wait out the expiry.

The runtime composes, not inherits: ``LeaderElector.run(on_started,
on_stopped)`` brackets ``OperatorRuntime.serve()``.
"""

from __future__ import annotations

import datetime
import logging
import os
import re
import socket
import threading
import uuid

from ..clients.base import ApiError, Conflict, NotFound, ObjectRef
from ..utils.clock import Clock, SystemClock

_log = logging.getLogger(__name__)

LEASE = dict(group="coordination.k8s.io", version="v1", plural="leases")


def _now_iso(clock: Clock) -> str:
    # Lease timestamps are RFC3339 micro-time.  A FakeClock's epoch maps
    # through fromtimestamp so tests stay deterministic.
    return (
        datetime.datetime.fromtimestamp(clock.now(), datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%f")
    ) + "Z"


def _parse_iso(ts: str | None) -> float | None:
    # A renewTime written by another client with no fractional seconds,
    # RFC3339Nano's nine digits, or a numeric UTC offset instead of 'Z'
    # (e.g. ``...+00:00``) must NOT parse to None, or the challenger
    # treats a live lease as takeable and two leaders run concurrently.
    # The fraction is normalized to microseconds by hand: fromisoformat
    # only accepts arbitrary precision (and 'Z') from 3.11 on, and this
    # package supports 3.10.
    if not ts:
        return None
    try:
        s = ts.strip().rstrip("Zz")
        offset_s = 0
        m = re.search(r"([+-])(\d{2}):?(\d{2})$", s)
        if m:
            offset_s = (int(m.group(2)) * 3600 + int(m.group(3)) * 60) * (
                1 if m.group(1) == "+" else -1
            )
            s = s[: m.start()]
        base, frac = s, "0"
        if "." in base:
            base, frac = base.split(".", 1)
            frac = (frac + "000000")[:6]
        dt = datetime.datetime.strptime(base, "%Y-%m-%dT%H:%M:%S")
        return dt.replace(
            microsecond=int(frac), tzinfo=datetime.timezone.utc
        ).timestamp() - offset_s
    except ValueError:
        return None


class LeaderElector:
    def __init__(
        self,
        kube,
        name: str = "tpumlops-operator",
        namespace: str = "tpumlops-system",
        identity: str | None = None,
        lease_duration_s: float = 15.0,
        renew_interval_s: float = 5.0,
        retry_interval_s: float = 2.0,
        renew_deadline_s: float | None = None,
        clock: Clock | None = None,
    ):
        if renew_interval_s >= lease_duration_s:
            raise ValueError(
                f"renew_interval_s ({renew_interval_s}) must be < "
                f"lease_duration_s ({lease_duration_s}) or the lease "
                "expires between renewals"
            )
        # The holder must give up STRICTLY before a challenger may take
        # over (client-go's renewDeadline < leaseDuration): challengers
        # act at renewTime + lease_duration; the holder abandons at
        # last_renew + renew_deadline, one renew interval earlier.
        self.renew_deadline_s = (
            renew_deadline_s
            if renew_deadline_s is not None
            else lease_duration_s - renew_interval_s
        )
        if not (renew_interval_s <= self.renew_deadline_s < lease_duration_s):
            raise ValueError(
                f"renew_deadline_s ({self.renew_deadline_s}) must be in "
                f"[renew_interval_s, lease_duration_s)"
            )
        self.kube = kube
        self.ref = ObjectRef(namespace=namespace, name=name, **LEASE)
        self.identity = identity or (
            f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        )
        self.lease_duration_s = lease_duration_s
        self.renew_interval_s = renew_interval_s
        self.retry_interval_s = retry_interval_s
        self.clock = clock or SystemClock()
        self.is_leader = False
        self._stop = threading.Event()

    # -- lease mechanics -----------------------------------------------------

    def _lease_body(self, prior: dict | None) -> dict:
        spec_prior = (prior or {}).get("spec") or {}
        transitions = int(spec_prior.get("leaseTransitions") or 0)
        if spec_prior.get("holderIdentity") not in (None, self.identity):
            transitions += 1
        now = _now_iso(self.clock)
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {
                "name": self.ref.name,
                "namespace": self.ref.namespace,
            },
            "spec": {
                "holderIdentity": self.identity,
                # ceil: the API field is an integer; truncation would
                # advertise 0 for sub-second (test) durations, which
                # reads as an expired lease.
                "leaseDurationSeconds": max(1, int(-(-self.lease_duration_s // 1))),
                "acquireTime": (
                    spec_prior.get("acquireTime")
                    if spec_prior.get("holderIdentity") == self.identity
                    else now
                )
                or now,
                "renewTime": now,
                "leaseTransitions": transitions,
            },
        }
        if prior is not None:
            body["metadata"]["resourceVersion"] = (
                prior.get("metadata") or {}
            ).get("resourceVersion")
        return body

    def try_acquire_or_renew(self) -> bool:
        """One election round.  Returns True iff we hold the lease now.

        Never raises: a transport blip or API 5xx is a failed round
        (False), handled by the renew-deadline grace in ``_hold`` —
        crashing the election loop on the first flaky read would take
        the whole operator down with it.
        """
        try:
            return self._acquire_or_renew_once()
        except Exception as e:
            _log.warning("leader election round failed: %s", e)
            return False

    def _acquire_or_renew_once(self) -> bool:
        try:
            lease = self.kube.get(self.ref)
        except NotFound:
            try:
                self.kube.create(self.ref, self._lease_body(None))
                return True
            except (Conflict, ApiError):
                return False  # someone else created it first
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        if holder == "":
            pass  # explicitly released (see release()): take immediately
        elif holder not in (None, self.identity):
            renew = _parse_iso(spec.get("renewTime"))
            raw_duration = spec.get("leaseDurationSeconds")
            # 0 is meaningful (a released lease) — `or` would eat it.
            duration = float(
                self.lease_duration_s if raw_duration is None else raw_duration
            )
            if renew is not None and self.clock.now() < renew + duration:
                return False  # held and fresh
            # expired: fall through and try to take it over
        try:
            self.kube.replace(self.ref, self._lease_body(lease))
            return True
        except (Conflict, NotFound):
            return False  # lost the takeover race
        except ApiError:
            return False

    # -- lifecycle -----------------------------------------------------------

    def run(self, on_started, on_stopped) -> None:
        """Block until stopped: wait for leadership, hold it, step down.

        ``on_started()`` runs when leadership is gained (typically starts
        the runtime's serve loop on this thread's behalf);
        ``on_stopped()`` runs when leadership is lost or ``stop()`` is
        called.  If renewals keep failing past the lease duration we
        step down proactively — a new leader may already be running.
        """
        while not self._stop.is_set():
            if self.try_acquire_or_renew():
                _log.info("leader election: %s acquired the lease", self.identity)
                self.is_leader = True
                try:
                    on_started()
                    self._hold()
                finally:
                    self.is_leader = False
                    _log.warning(
                        "leader election: %s stepping down", self.identity
                    )
                    on_stopped()
            else:
                self._stop.wait(self.retry_interval_s)

    def _hold(self) -> None:
        """Renew until stop or sustained failure.

        Abandons at ``renew_deadline_s`` after the last successful renew
        — strictly before challengers may act on the expired lease, so
        two leaders never reconcile concurrently (modulo clock skew
        beyond one renew interval, the standard Lease caveat).
        """
        last_renew = self.clock.now()
        while not self._stop.is_set():
            self._stop.wait(self.renew_interval_s)
            if self._stop.is_set():
                return
            if self.try_acquire_or_renew():
                last_renew = self.clock.now()
            elif self.clock.now() - last_renew >= self.renew_deadline_s:
                _log.error(
                    "leader election: renewals failing for >= %.0fs "
                    "(deadline); stepping down before the lease expires",
                    self.renew_deadline_s,
                )
                return

    def release(self) -> None:
        """Best-effort lease release (SIGTERM path): zero out renewTime so
        a successor's expiry check passes immediately instead of waiting
        out the remaining lease duration on every rolling update."""
        try:
            lease = self.kube.get(self.ref)
        except Exception:
            return
        if ((lease.get("spec") or {}).get("holderIdentity")) != self.identity:
            return  # not ours to release
        body = self._lease_body(lease)
        # Duration 0 is expired under ANY clock (now < renew + 0 is never
        # true) — epoch-zero renewTime would not be, e.g. for a FakeClock
        # still at time 0.
        body["spec"]["leaseDurationSeconds"] = 0
        body["spec"]["holderIdentity"] = ""
        try:
            self.kube.replace(self.ref, body)
            _log.info("leader election: lease released")
        except Exception as e:
            _log.warning("lease release failed (successor waits expiry): %s", e)

    def stop(self) -> None:
        self._stop.set()
