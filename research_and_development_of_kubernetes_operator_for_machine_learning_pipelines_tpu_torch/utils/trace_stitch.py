"""Fleet trace stitching: merge per-component Chrome traces into ONE (the
port's copy of the JAX package's ``utils/trace_stitch.py``).

The fleet trace plane leaves three journals behind for any request:
the router's journey ring (``GET /router/debug/trace``) and each
replica's engine flight recorder (``GET /debug/trace``).  All three
export Chrome trace-event JSON whose timestamps are microseconds since
*that process's own start* — useless side by side until they share a
clock.  Every component also exports its ``started_unix`` anchor
(``/router/debug/requests`` and ``/debug/engine``), so stitching is a
pure shift-and-merge:

1. fetch each component's chrome trace + ``started_unix``;
2. pick the earliest anchor as the common epoch;
3. shift each component's ``ts`` by its anchor delta and re-home its
   events under a distinct ``pid`` (one "process" per component in
   Perfetto's UI);
4. concatenate.

Because the router propagates one ``X-Request-Id``/trace id across every
leg (forwards, KV export/import relays, failover retries, park
releases), the async request spans emitted by the router and by every
replica the request touched carry the SAME ``id`` — Perfetto renders
them as one coherent request story across process tracks, which is the
acceptance bar for the chaos e2e (relay → failover → park as one tree).

Consumed three ways: ``scripts/stitch_trace.py`` (CLI), the operator
telemetry listener's ``GET /debug/fleet-trace`` (fans out to the
endpoints listed for it), and tests.  The journey export format is
documented in docs/OBSERVABILITY.md — it doubles as the replayable
traffic trace the offline planner (``operator/planner.py``) consumes.
"""

from __future__ import annotations

import json
import urllib.request


def fetch_json(url: str, timeout: float = 10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def fetch_source(name: str, base_url: str, kind: str = "replica",
                 timeout: float = 10.0) -> dict:
    """One component's trace + clock anchor.

    ``kind`` is ``"router"`` (native router admin surface) or
    ``"replica"`` (server ``/debug/*``).  Raises on unreachable
    endpoints — a stitcher silently dropping a component would present a
    partial story as the whole one.  The chrome payloads carry their
    ``started_unix`` anchor top-level; the raw-ring/snapshot endpoint is
    fetched only as a fallback for older components, so a stitch does
    not download a potentially multi-MB ring twice.
    """
    base = base_url.rstrip("/")
    if kind == "router":
        trace = fetch_json(f"{base}/router/debug/trace?format=chrome", timeout)
        anchor = trace.get("started_unix")
        if anchor is None:
            anchor = fetch_json(
                f"{base}/router/debug/requests", timeout
            )["started_unix"]
    else:
        trace = fetch_json(f"{base}/debug/trace?format=chrome", timeout)
        anchor = trace.get("started_unix")
        if anchor is None:
            anchor = fetch_json(f"{base}/debug/engine", timeout)[
                "started_unix"
            ]
    return {
        "name": name,
        "kind": kind,
        "trace": trace,
        "started_unix": float(anchor),
    }


def stitch_chrome_traces(sources: list[dict]) -> dict:
    """Merge fetched sources (see :func:`fetch_source`) into one Chrome
    trace on a common timeline.

    Each source becomes its own ``pid`` (1-based, in input order) with a
    ``process_name`` metadata event named after the source, its events
    shifted onto the earliest source's clock.  ``tid`` values are left
    alone — they are already scoped per process in the trace format.
    """
    if not sources:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(float(s["started_unix"]) for s in sources)
    out: list[dict] = []
    for pid, src in enumerate(sources, start=1):
        shift_us = int((float(src["started_unix"]) - base) * 1e6)
        named = False
        for ev in src["trace"].get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") != "M":
                ev["ts"] = int(ev.get("ts", 0)) + shift_us
            elif ev.get("name") == "process_name":
                # One process per component, named by the stitcher so
                # two replicas don't both render as "tpumlops-engine".
                ev["args"] = {"name": str(src.get("name") or f"pid {pid}")}
                named = True
            out.append(ev)
        if not named:
            out.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": str(src.get("name") or f"pid {pid}")},
                }
            )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def filter_request(trace: dict, request_id: str) -> dict:
    """Reduce a stitched trace to one request's span tree (metadata
    events kept so the track names survive)."""
    keep = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M":
            keep.append(ev)
            continue
        rid = ev.get("id") or (ev.get("args") or {}).get("request_id")
        if rid is not None and str(rid) == request_id:
            keep.append(ev)
    return {"traceEvents": keep, "displayTimeUnit": "ms"}


def request_ids_by_pid(trace: dict) -> dict[int, set]:
    """``{pid: {request ids}}`` over a stitched trace — the coherence
    check the e2e uses: a propagated id must appear under the router's
    pid AND every replica pid that served one of its legs."""
    out: dict[int, set] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M":
            continue
        rid = ev.get("id") or (ev.get("args") or {}).get("request_id")
        if rid is None:
            continue
        out.setdefault(int(ev.get("pid", 0)), set()).add(str(rid))
    return out


def fleet_trace(source_specs: list[dict], timeout: float = 10.0) -> dict:
    """Fetch + stitch in one call.  ``source_specs`` entries carry
    ``name``, ``base_url``, and optional ``kind`` (default replica)."""
    sources = [
        fetch_source(
            str(spec["name"]),
            str(spec["base_url"]),
            str(spec.get("kind", "replica")),
            timeout,
        )
        for spec in source_specs
    ]
    return stitch_chrome_traces(sources)
