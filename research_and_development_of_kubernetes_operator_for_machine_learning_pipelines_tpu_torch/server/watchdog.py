"""Scheduler-loop watchdog: detect a wedged engine tick and contain it
(port of the JAX package's ``server/watchdog.py``; standard library only,
the same semantics).

The failure this guards against is the one nothing else in the stack
can see: a device dispatch that never returns (a CUDA graph replay or a
kernel that never finishes, a wedged card, a deadlocked collective).  The
scheduler thread blocks inside the replay or the readback that waits for
it, so no exception fires,
``/readyz`` stays green, the router keeps routing, and every request
hangs until its client times out — the worst failure mode a replica
has.

The watchdog is a tiny monitor thread beside the scheduler:

- the engine **beats** it at every loop iteration and stamps the tick
  kind it is about to dispatch (``decode`` / ``verify`` / ``multistep``
  / ``prefill`` / ``packed-prefill`` / ``admit``);
- if no beat lands for ``deadline_s``, the tick is declared **stalled**:
  ``on_stall(kind, age_s, inventory)`` fires ONCE per incident — the
  server flips ``/readyz`` unready (balancers route elsewhere), the
  flight recorder journals a ``watchdog`` event carrying the in-flight
  tick kind and the slot inventory, and
  ``tpumlops_engine_watchdog_stalls_total`` increments;
- if the tick then completes (a transient — device contention, a
  pathological compile), the next beat fires ``on_recover`` and the
  server re-readies;
- if the stall persists past ``deadline_s + grace_s``, ``on_exit``
  fires: the process exits non-zero so Kubernetes restarts the pod —
  a restart is the only remedy for a wedged device, and a fast one
  beats an invisible hang every time.

Armed only AFTER warmup (on the port, the kernel builds and the CUDA
graph capture at start, which legitimately block for seconds); disabled entirely at ``deadline_s = 0`` — the
default — in which case no thread is created and the engine loop is
byte-for-byte what it was.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable

_log = logging.getLogger(__name__)

_IDLE = "idle"


def _default_exit(code: int = 70) -> None:  # pragma: no cover - process exit
    # os._exit, not sys.exit: the scheduler thread is wedged inside a
    # device call and will never unwind; interpreter teardown would hang
    # behind it exactly like the requests already do.
    os._exit(code)


class EngineWatchdog:
    """Monitor thread over the generation scheduler's heartbeat.

    ``slot_inventory`` is called (from the monitor thread) at stall time
    to snapshot what was in flight — best effort, the payload of the
    flight-recorder event.  All callbacks are assignable after
    construction so the server can wire itself in once it exists.
    """

    def __init__(
        self,
        deadline_s: float,
        grace_s: float = 30.0,
        on_stall: Callable | None = None,
        on_recover: Callable | None = None,
        on_exit: Callable | None = None,
        on_age: Callable | None = None,
        slot_inventory: Callable | None = None,
        poll_s: float | None = None,
    ):
        if deadline_s <= 0:
            raise ValueError(
                f"watchdog deadline_s must be > 0, got {deadline_s}"
            )
        self.deadline_s = float(deadline_s)
        self.grace_s = max(0.0, float(grace_s))
        self.on_stall = on_stall
        self.on_recover = on_recover
        self.on_exit = on_exit if on_exit is not None else _default_exit
        self.on_age = on_age  # fed the beat age every poll (the gauge)
        self.slot_inventory = slot_inventory
        # Poll fine enough to flip readiness "within the deadline" with
        # margin, bounded below so a tight test deadline still works.
        self.poll_s = (
            float(poll_s) if poll_s is not None
            else min(max(self.deadline_s / 4.0, 0.05), 1.0)
        )
        self.stalls_total = 0
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._kind = _IDLE
        self._armed = False
        self._stalled = False
        self._stall_kind = _IDLE
        self._exited = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- engine side (scheduler thread) --------------------------------------

    def beat(self, kind: str | None = None) -> None:
        """One scheduler heartbeat; ``kind`` stamps what is about to run
        (None keeps the current stamp).  Called at every loop iteration
        — the whole integration cost when healthy is this method."""
        recovered = False
        with self._lock:
            self._last_beat = time.monotonic()
            if kind is not None:
                self._kind = kind
            if self._stalled:
                self._stalled = False
                recovered = True
        if recovered:
            _log.warning(
                "watchdog: stalled tick completed after all; re-readying"
            )
            if self.on_recover is not None:
                try:
                    self.on_recover()
                except Exception:
                    _log.exception("watchdog on_recover failed")

    def arm(self) -> None:
        """Start enforcing the deadline (called once warmup finishes —
        the compile sweep legitimately blocks far past any deadline)."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._armed = True

    def disarm(self) -> None:
        with self._lock:
            self._armed = False
            self._stalled = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="engine-watchdog"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- monitor thread ------------------------------------------------------

    def _snapshot_inventory(self) -> list:
        if self.slot_inventory is None:
            return []
        try:
            return list(self.slot_inventory())
        except Exception:  # racing the wedged thread's last mutation
            return []

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed = self._armed
                age = time.monotonic() - self._last_beat
                kind = self._kind
                stalled = self._stalled
            if self.on_age is not None:
                try:
                    self.on_age(age if armed else 0.0)
                except Exception:
                    _log.exception("watchdog on_age failed")
            if not armed:
                continue
            if not stalled and age > self.deadline_s:
                with self._lock:
                    self._stalled = True
                    self._stall_kind = kind
                self.stalls_total += 1
                inventory = self._snapshot_inventory()
                _log.error(
                    "watchdog: engine tick kind=%s exceeded deadline "
                    "(%.1fs > %.1fs); flipping unready, exiting after "
                    "%.1fs grace unless it completes (in flight: %s)",
                    kind, age, self.deadline_s, self.grace_s, inventory,
                )
                if self.on_stall is not None:
                    try:
                        self.on_stall(kind, age, inventory)
                    except Exception:
                        _log.exception("watchdog on_stall failed")
            elif stalled and age > self.deadline_s + self.grace_s:
                if self._exited:
                    continue
                self._exited = True
                _log.critical(
                    "watchdog: stall persisted %.1fs past the deadline; "
                    "exiting so the pod restarts (kind=%s)",
                    self.grace_s, self._stall_kind,
                )
                try:
                    self.on_exit()
                except Exception:  # injected exit hooks in tests
                    _log.exception("watchdog on_exit failed")
