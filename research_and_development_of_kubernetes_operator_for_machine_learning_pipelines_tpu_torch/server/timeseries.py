"""Fixed-memory 1 s-resolution time-series ring for the serving plane
(port of the JAX package's ``server/timeseries.py``; standard library
only, the same samples).

Every observability layer before this one is point-in-time or
event-shaped: the Prometheus gauges say what is true NOW, the flight
recorder's rings say what HAPPENED, but neither holds short-horizon
history — so nothing on the server can answer "has ITL drifted since the
last attach?" or give the operator's anomaly detector a window to
compare replicas over.  :class:`TimeseriesRing` closes that gap with a
bounded ring of per-second samples distilled from the SAME callback
stream the metrics layer already consumes (``on_step``/``on_tick``/
``on_itl``/``on_shed``/``on_poison`` out of the engine's
``_record_tick`` funnel) — zero new instrumentation points; the ring's
observer methods are fanned onto the existing metric callbacks at the
one ``make_gen_engine`` wiring site.

Memory is fixed by construction: the open (current-second) bucket keeps
at most :data:`BUCKET_SAMPLE_CAP` raw walls per tick kind (p50/p99 past
the cap are computed over the first CAP observations — an error bar
documented in docs/OBSERVABILITY.md), and a finalized bucket is a small
flat dict of aggregates in a ``deque(maxlen=capacity)``.

Sized by ``spec.tpu.observability.timeseriesRing`` (``--timeseries-ring``);
0 — the default — constructs no ring at all, so the engine callbacks,
``/debug`` routes, and serving behavior stay byte-for-byte.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

# Raw per-kind tick walls (and ITL samples) kept per open bucket; a
# decode loop can tick thousands of times a second and the ring must
# stay fixed-memory, so quantiles past the cap are over the first CAP
# observations of that second.
BUCKET_SAMPLE_CAP = 256


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return float(sorted_vals[idx])


class TimeseriesRing:
    """Bounded ring of per-second serving samples.

    Observer methods mirror the :class:`ServerMetrics` callback
    signatures exactly, so one fan-out combinator chains both onto the
    engine's existing hooks.  All methods are thread-safe (the engine
    scheduler thread observes; the aiohttp event loop snapshots).
    """

    def __init__(
        self,
        capacity: int,
        clock: Callable[[], float] = time.time,
    ):
        if capacity <= 0:
            raise ValueError(
                f"timeseries ring capacity must be > 0, got {capacity}"
            )
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=self.capacity)
        self._telemetry = None  # DeviceTelemetry | None (last_util source)
        self._open_t: int | None = None  # unix second of the open bucket
        self._open: dict = {}

    def bind_telemetry(self, telemetry) -> None:
        """Attach the device-telemetry layer as the MFU / HBM-bandwidth
        source: each finalized bucket gauge-samples ``last_util`` (the
        dict ``tick_util`` maintains) instead of adding a new hook."""
        self._telemetry = telemetry

    # -- bucket lifecycle ---------------------------------------------------

    def _fresh_bucket(self) -> dict:
        return {
            "ticks": {},  # kind -> capped list of wall seconds
            "tick_counts": {},  # kind -> total count (cap-independent)
            "itl": [],  # capped list of inter-token latencies (s)
            "itl_count": 0,
            "queue_depth": None,  # last observed this second
            "active_slots": None,
            "shed": 0,
            "poison": 0,
            "marks": [],  # lifecycle marks (e.g. "attach") this second
        }

    def _roll(self, now: float) -> None:
        """Finalize the open bucket if the wall clock left its second.
        Caller holds the lock."""
        sec = int(now)
        if self._open_t is None:
            self._open_t = sec
            self._open = self._fresh_bucket()
            return
        if sec <= self._open_t:
            return
        self._samples.append(self._finalize(self._open_t, self._open))
        self._open_t = sec
        self._open = self._fresh_bucket()

    def _finalize(self, t: int, bucket: dict) -> dict:
        ticks = {}
        for kind, walls in bucket["ticks"].items():
            walls.sort()
            ticks[kind] = {
                "n": bucket["tick_counts"][kind],
                "wall_p50_ms": round(_quantile(walls, 0.50) * 1e3, 4),
                "wall_p99_ms": round(_quantile(walls, 0.99) * 1e3, 4),
            }
        itl = sorted(bucket["itl"])
        sample: dict[str, Any] = {
            "t": t,
            "ticks": ticks,
            "itl": {
                "n": bucket["itl_count"],
                "p50_ms": round(_quantile(itl, 0.50) * 1e3, 4),
                "p99_ms": round(_quantile(itl, 0.99) * 1e3, 4),
            },
            "queue_depth": bucket["queue_depth"],
            "active_slots": bucket["active_slots"],
            "shed": bucket["shed"],
            "poison": bucket["poison"],
        }
        if bucket["marks"]:
            sample["marks"] = list(bucket["marks"])
        util = self._sample_util()
        if util is not None:
            sample["mfu"] = util[0]
            sample["hbm_bw_util"] = util[1]
        return sample

    def _sample_util(self):
        """Busiest program's (mfu, hbm_bw_util) from the telemetry
        layer's ``last_util`` gauge — absent when device telemetry is
        off (the sample simply carries no utilization fields)."""
        if self._telemetry is None:
            return None
        try:
            with self._telemetry._util_lock:
                utils = list(self._telemetry.last_util.values())
        except Exception:
            return None
        if not utils:
            return None
        best = max(utils, key=lambda u: u.get("mfu", 0.0))
        return (
            float(best.get("mfu", 0.0)),
            float(best.get("hbm_bw_util", 0.0)),
        )

    # -- observer methods (ServerMetrics-signature mirrors) -----------------

    def observe_tick(self, kind: str, seconds: float) -> None:
        with self._lock:
            self._roll(self._clock())
            walls = self._open["ticks"].setdefault(kind, [])
            counts = self._open["tick_counts"]
            counts[kind] = counts.get(kind, 0) + 1
            if len(walls) < BUCKET_SAMPLE_CAP:
                walls.append(float(seconds))

    def observe_decode_step(
        self,
        active_slots: int,
        seconds: float,
        queue_depth: int = 0,
        admitting: int = 0,
    ) -> None:
        with self._lock:
            self._roll(self._clock())
            self._open["queue_depth"] = int(queue_depth)
            self._open["active_slots"] = int(active_slots)

    def observe_itl(self, seconds: float) -> None:
        with self._lock:
            self._roll(self._clock())
            self._open["itl_count"] += 1
            if len(self._open["itl"]) < BUCKET_SAMPLE_CAP:
                self._open["itl"].append(float(seconds))

    def inc_shed(self, reason: str = "") -> None:
        with self._lock:
            self._roll(self._clock())
            self._open["shed"] += 1

    def inc_poison(self, action: str = "") -> None:
        with self._lock:
            self._roll(self._clock())
            self._open["poison"] += 1

    def mark(self, event: str) -> None:
        """Stamp a lifecycle mark (e.g. ``"attach"``) into the current
        second — the anomaly detector's baseline-reset signal."""
        with self._lock:
            self._roll(self._clock())
            self._open["marks"].append(str(event))

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /debug/timeseries`` payload: finalized samples
        oldest-first, then the open (still-accumulating) bucket."""
        with self._lock:
            self._roll(self._clock())
            samples = list(self._samples)
            if self._open_t is not None:
                open_view = self._finalize(self._open_t, self._open)
                open_view["open"] = True
                samples.append(open_view)
        return {
            "capacity": self.capacity,
            "resolution_s": 1,
            "samples": samples,
        }
