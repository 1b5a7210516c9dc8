"""Engine flight recorder: bounded in-memory journal of the scheduler loop
(port of the JAX package's ``server/flight_recorder.py``; standard library
only, the same record shapes and Chrome export).

The port's engine records every tick kind below, ``kv-import`` included
(a handed-off prefix inserted into the radix cache,
``GenerationEngine.import_prefix_kv``), and a request the router relays
after a KV handoff carries its ``kv-handoff`` span, so a port replica's
journal reads as the reference's.  Besides the dispatch kinds, a
preempting engine records ``preempt-evict`` and ``preempt-restore`` ticks.

Every serving metric this server exports is an aggregate — when one
request's TTFT blows p99 the histograms cannot say whether it lost the
time queued, behind a packed-prefill budget, to a prefix-cache miss, or
to a zero-accept speculative streak.  The recorder keeps the raw
material for that question in three bounded rings:

- **ticks** — one record per engine device dispatch (kind: ``decode`` /
  ``verify`` / ``multistep`` / ``packed-prefill`` / ``prefill`` /
  ``seed`` / ``kv-import`` — the last is a handed-off prefix landing in
  the radix cache, host-side — / ``superstep``, the unified engine's
  one-dispatch-per-tick program) with wall time, batch fill, active
  slots, queue depth,
  tokens emitted, and accepted speculative drafts; fused multi-step
  ticks additionally carry ``steps`` (K scan iterations per dispatch),
  and their per-token instants in the request traces are reconstructed
  across the tick wall, not stacked on the harvest instant; superstep
  ticks carry both ``steps`` and ``roles`` (the {prefill, decode,
  verify} row mix of the dispatch);
- **events** — per-request lifecycle points (``enqueued``, ``admission``,
  ``seed``, ``prefill_chunk``, ``first_token``, ``finish``) with the
  cache row they happened on;
- **traces** — completed :class:`RequestTrace` objects carrying the
  request's whole timing block including per-token timestamps.

``GET /debug/engine`` serves the live snapshot; ``GET
/debug/trace?format=chrome`` renders the rings as Chrome trace-event
JSON (one track for engine ticks, one per cache row; request spans as
async begin/end pairs) viewable in Perfetto or ``chrome://tracing``.

Sized by ``spec.tpu.observability.traceRing`` (CRD -> config -> builder
-> server ``--trace-ring``); 0 — the default — means no recorder object
exists at all, so the engine's hot path stays byte-for-byte what it was.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


def _ms(a: float, b: float) -> float | None:
    """Wall delta in milliseconds, None when either endpoint is unset."""
    if a <= 0.0 or b <= 0.0:
        return None
    return round((b - a) * 1000.0, 3)


@dataclass
class RequestTrace:
    """Per-request timing, filled in by the engine as the request moves
    queue -> admission -> prefill chunks -> first token -> finish.

    Created by the HTTP layer (one per submitted sequence) regardless of
    whether a recorder is attached: the ``"debug": true`` timing block
    and the per-request completion log line are always available.  All
    timestamps are ``time.perf_counter()`` values; only deltas are ever
    exposed."""

    request_id: str = ""
    # W3C trace context joined from the inbound traceparent (the router
    # mints/propagates one when its journey ring is on): the 32-hex
    # trace id shared by every component this request touched, and the
    # 16-hex span id of the immediate parent (the router's leg span).
    # Empty = the request arrived without a traceparent; the timing
    # block and chrome export then stay byte-for-byte what they were.
    trace_id: str = ""
    parent_span: str = ""
    prompt_tokens: int = 0
    slot: int = -1
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0
    # Disaggregated-fleet relay: stamped at request receipt when the
    # router forwarded this request AFTER a prefill→decode KV handoff
    # (X-Tpumlops-Handoff header); ``handoff_ms`` is the router-measured
    # handoff wall riding the same header.  0.0/None = not relayed.
    t_handoff: float = 0.0
    handoff_ms: float | None = None
    prefill_chunks: int = 0
    cached_tokens: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    tokens: int = 0
    finish_reason: str = ""
    token_times: list = field(default_factory=list)

    def note_token(self, t: float) -> None:
        self.tokens += 1
        self.token_times.append(t)

    def finish(self, reason: str, t: float | None = None) -> None:
        # First writer wins: a client cancel racing the final token must
        # not relabel an already-finished request.
        if not self.finish_reason:
            self.finish_reason = reason
            self.t_finish = time.perf_counter() if t is None else t

    def timing_block(self) -> dict:
        """The JSON shape returned by ``"debug": true`` and logged on
        completion.  Totals here agree with the Prometheus counters the
        same request incremented (asserted in tests/test_server.py)."""
        out = {
            "request_id": self.request_id,
            "prompt_tokens": self.prompt_tokens,
            "queue_ms": _ms(self.t_submit, self.t_admit),
            "ttft_ms": _ms(self.t_submit, self.t_first),
            "total_ms": _ms(self.t_submit, self.t_finish),
            "prefill_chunks": self.prefill_chunks,
            "cached_tokens": self.cached_tokens,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "tokens": self.tokens,
            # KV relay context (None = not a relayed request): the
            # router's measured handoff wall, so /debug/trace alone
            # reconstructs export → import → forward → seed.
            "handoff_ms": self.handoff_ms,
            "finish_reason": self.finish_reason or "in-flight",
        }
        if self.trace_id:
            # Present only for requests that arrived with a traceparent
            # (fleet trace plane on): pre-trace-plane blocks stay
            # byte-for-byte.
            out["trace_id"] = self.trace_id
            out["parent_span"] = self.parent_span
        return out


class FlightRecorder:
    """Bounded ring journal fed from the engine scheduler loop.

    All writers (the scheduler thread, ``submit`` on HTTP threads) and
    readers (the ``/debug/*`` handlers) go through one lock; every write
    is an O(1) deque append, so the recorder's steady-state cost is a
    dict build + append per engine tick (bench scenario
    ``observability_serving`` pins the tok/s overhead).
    """

    # Completed traces carry per-token timestamps (up to max_new_tokens
    # floats each), so their ring is capped independently of the tick
    # ring — traceRing=4096 with 1k-token generations must not pin
    # hundreds of MB of host memory for a debug feature.
    MAX_TRACES = 512
    # Token instants rendered per request span in the Chrome export
    # (stride-sampled beyond this): bounds the /debug/trace payload.
    MAX_TOKEN_INSTANTS = 256

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"trace ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._t0_perf = time.perf_counter()
        self._t0_unix = time.time()
        self._lock = threading.Lock()
        self._ticks: deque = deque(maxlen=self.capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._traces: deque = deque(maxlen=min(self.capacity, self.MAX_TRACES))
        self.ticks_recorded = 0
        self.events_recorded = 0
        self.traces_recorded = 0

    def _us(self, t: float | None = None) -> int:
        """Microseconds since recorder start (the Chrome trace clock)."""
        return int(((time.perf_counter() if t is None else t) - self._t0_perf) * 1e6)

    # -- writers (engine side) ----------------------------------------------

    def tick(
        self,
        kind: str,
        t0: float,
        wall_s: float,
        *,
        active_slots: int = 0,
        queue_depth: int = 0,
        batch_fill: int = 0,
        tokens: int = 0,
        spec_accepted: int = 0,
        util: dict | None = None,
        steps: int = 0,
        roles: dict | None = None,
    ) -> None:
        rec = {
            "ts_us": self._us(t0),
            "dur_us": max(0, int(wall_s * 1e6)),
            "kind": kind,
            "active_slots": int(active_slots),
            "queue_depth": int(queue_depth),
            "batch_fill": int(batch_fill),
            "tokens": int(tokens),
            "spec_accepted": int(spec_accepted),
        }
        if steps:
            # Fused multi-step ticks only (K scan iterations under this
            # one dispatch); absent otherwise so single-step tick
            # records stay byte-for-byte what they were.
            rec["steps"] = int(steps)
        if roles:
            # Unified super-step ticks only: the per-row role breakdown
            # ({prefill, decode, verify} counts) of this one dispatch.
            # Absent for every split-engine tick kind, so the
            # unified-off record shapes stay byte-for-byte.
            rec["roles"] = {k: int(v) for k, v in roles.items()}
        if util:
            # Device telemetry only (spec.tpu.observability.
            # deviceTelemetry): mfu / hbm_bw_util from the analytic cost
            # model joined with this tick's wall.  Absent otherwise, so
            # the telemetry-off tick record stays byte-for-byte.
            rec.update(util)
        with self._lock:
            self.ticks_recorded += 1
            self._ticks.append(rec)

    def event(
        self, request_id: str, name: str, *, slot: int = -1, **fields
    ) -> None:
        rec = {
            "ts_us": self._us(),
            "request_id": request_id,
            "event": name,
            "slot": int(slot),
            **fields,
        }
        with self._lock:
            self.events_recorded += 1
            self._events.append(rec)

    def complete(self, trace: RequestTrace) -> None:
        with self._lock:
            self.traces_recorded += 1
            self._traces.append(trace)

    # -- readers (/debug/* side) --------------------------------------------

    def snapshot(self) -> dict:
        """Live state for ``GET /debug/engine``: the rings verbatim plus
        lifetime totals (so ring rotation is visible as recorded > len).

        The lock is held only for the deque copies: building thousands
        of payload dicts under it would block the scheduler thread's
        ``tick()`` mid-decode — inflating the very tail latency someone
        is scraping this endpoint to debug.  Ring records are immutable
        once appended and traces are completed, so reading them outside
        the lock is safe; the per-record ``dict(...)`` copies keep
        callers from mutating the live journal."""
        with self._lock:
            ticks = list(self._ticks)
            events = list(self._events)
            traces = list(self._traces)
            totals = (
                self.ticks_recorded,
                self.events_recorded,
                self.traces_recorded,
            )
        return {
            "capacity": self.capacity,
            "started_unix": self._t0_unix,
            "ticks_recorded": totals[0],
            "events_recorded": totals[1],
            "traces_recorded": totals[2],
            "ticks": [dict(t) for t in ticks],
            "events": [dict(e) for e in events],
            "requests": [t.timing_block() for t in traces],
        }

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing).

        Track layout: tid 0 carries the engine ticks as complete (``X``)
        events; tid ``row + 1`` is one track per cache row carrying that
        row's request spans (async ``b``/``e`` pairs keyed by request id)
        with per-token instant events and the lifecycle instants between
        them.  A request that never reached a row (shutdown while
        queued) spans on tid 0."""
        with self._lock:
            ticks = [dict(t) for t in self._ticks]
            events = [dict(e) for e in self._events]
            traces = list(self._traces)

        out: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": "tpumlops-engine"},
            },
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": "engine ticks"},
            },
        ]
        rows = sorted(
            {t.slot for t in traces if t.slot >= 0}
            | {e["slot"] for e in events if e.get("slot", -1) >= 0}
        )
        for row in rows:
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": row + 1,
                    "args": {"name": f"cache row {row}"},
                }
            )
        for t in ticks:
            out.append(
                {
                    "name": t["kind"],
                    "cat": "tick",
                    "ph": "X",
                    "ts": t["ts_us"],
                    "dur": t["dur_us"],
                    "pid": 1,
                    "tid": 0,
                    "args": {
                        k: t[k]
                        for k in (
                            "active_slots",
                            "queue_depth",
                            "batch_fill",
                            "tokens",
                            "spec_accepted",
                            "steps",
                            "roles",
                        )
                        if k in t
                    },
                }
            )
            if "roles" in t:
                # Role-fill counter track: Perfetto renders one series
                # per args key, so each unified dispatch's
                # prefill/decode/verify mix reads as a stacked
                # staircase next to the tick track.  Superstep ticks
                # only — the legacy export stays byte-for-byte.
                out.append(
                    {
                        "name": "role_fill",
                        "cat": "roles",
                        "ph": "C",
                        "ts": t["ts_us"],
                        "pid": 1,
                        "args": dict(t["roles"]),
                    }
                )
            if "mfu" in t:
                # Device-telemetry counter tracks: Perfetto renders one
                # counter per name, one series per args key (tick kind)
                # — the utilization staircase next to the tick track.
                # Emitted only for ticks carrying the fields, so the
                # telemetry-off export stays byte-for-byte.
                for counter in ("mfu", "hbm_bw_util"):
                    out.append(
                        {
                            "name": counter,
                            "cat": "utilization",
                            "ph": "C",
                            "ts": t["ts_us"],
                            "pid": 1,
                            "args": {t["kind"]: t[counter]},
                        }
                    )
        for e in events:
            out.append(
                {
                    "name": e["event"],
                    "cat": "lifecycle",
                    "ph": "i",
                    "s": "t",
                    "ts": e["ts_us"],
                    "pid": 1,
                    "tid": e.get("slot", -1) + 1 if e.get("slot", -1) >= 0 else 0,
                    "args": {"request_id": e["request_id"]},
                }
            )
        for tr in traces:
            tid = tr.slot + 1 if tr.slot >= 0 else 0
            begin = self._us(tr.t_submit) if tr.t_submit > 0 else 0
            end = self._us(tr.t_finish) if tr.t_finish > 0 else begin
            end = max(end, begin)  # clock skew must never invert the span
            if tr.t_handoff > 0 and tr.handoff_ms:
                # The router-measured KV handoff, anchored in this
                # process's clock by the receipt stamp: the relay span
                # ENDS at t_handoff and lasted handoff_ms.  Emitted only
                # for relayed requests — the non-fleet export stays
                # byte-for-byte.
                dur_us = int(tr.handoff_ms * 1000.0)
                out.append(
                    {
                        "name": "kv-handoff",
                        "cat": "handoff",
                        "ph": "X",
                        "ts": max(self._us(tr.t_handoff) - dur_us, 0),
                        "dur": dur_us,
                        "pid": 1,
                        "tid": tid,
                        "args": {"request_id": tr.request_id},
                    }
                )
            out.append(
                {
                    "name": "request",
                    "cat": "request",
                    "ph": "b",
                    "id": tr.request_id,
                    "ts": begin,
                    "pid": 1,
                    "tid": tid,
                }
            )
            # Stride-sample long generations: every token of a 1k-token
            # request as its own event would balloon the export without
            # adding readable detail at that zoom level.
            times = tr.token_times
            stride = max(1, -(-len(times) // self.MAX_TOKEN_INSTANTS))
            for tok_t in times[::stride]:
                out.append(
                    {
                        "name": "token",
                        "cat": "token",
                        "ph": "i",
                        "s": "t",
                        "ts": min(max(self._us(tok_t), begin), end),
                        "pid": 1,
                        "tid": tid,
                        "args": {"request_id": tr.request_id},
                    }
                )
            out.append(
                {
                    "name": "request",
                    "cat": "request",
                    "ph": "e",
                    "id": tr.request_id,
                    "ts": end,
                    "pid": 1,
                    "tid": tid,
                    "args": tr.timing_block(),
                }
            )
        # started_unix rides top-level so the fleet stitcher
        # (utils/trace_stitch.py) reads its clock anchor from this
        # payload instead of fetching /debug/engine separately.
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "started_unix": self._t0_unix,
        }
