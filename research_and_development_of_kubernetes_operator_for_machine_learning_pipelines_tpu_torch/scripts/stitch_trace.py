"""Stitch router journeys and replica flight-recorder tracks into ONE
Perfetto trace.

The counterpart of the JAX repository's ``scripts/stitch_trace.py``, with
its flags and output, on the port's ``utils/trace_stitch.py``.  The fleet
trace plane propagates one X-Request-Id and W3C traceparent across every
leg of a request's life (router forward, KV export/import relays,
failover retries, park releases, and the replica engine spans), so the
per-component Chrome traces share request ids.  This tool fetches each
component's trace and its ``started_unix`` clock anchor, shifts them onto
one timeline, and writes a single Chrome trace JSON (load it at
https://ui.perfetto.dev or chrome://tracing).  It reads HTTP only::

    python -m <port>.scripts.stitch_trace --router http://127.0.0.1:9000 \\
        --replica http://127.0.0.1:8001 --replica http://127.0.0.1:8002 -o fleet_trace.json

``--request-id ID`` keeps one request's span tree.  The operator's
telemetry listener serves the same merge live at ``GET /debug/fleet-trace``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..utils.trace_stitch import fetch_source, filter_request, stitch_chrome_traces


def stitch(routers: list[str], replicas: list[str], request_id: str | None = None,
           timeout: float = 10.0) -> tuple[dict, int]:
    """The stitched trace of the routers' and replicas' base URLs (labelled
    as the CLI labels them) and the number of components."""
    sources = []
    for i, url in enumerate(routers):
        label = "router" if len(routers) == 1 else f"router-{i}"
        sources.append(fetch_source(label, url, "router", timeout))
    for i, url in enumerate(replicas):
        label = f"replica-{i}" if len(replicas) > 1 else "replica"
        sources.append(fetch_source(label, url, "replica", timeout))
    trace = stitch_chrome_traces(sources)
    if request_id:
        trace = filter_request(trace, request_id)
    return trace, len(sources)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "stitch_trace",
        description="Merge router + replica chrome traces into one "
        "Perfetto timeline (shared request ids across tracks).",
    )
    ap.add_argument(
        "--router", action="append", default=[], metavar="URL",
        help="router base URL (e.g. http://127.0.0.1:9000); repeatable",
    )
    ap.add_argument(
        "--replica", action="append", default=[], metavar="URL",
        help="replica base URL (server /debug endpoints); repeatable",
    )
    ap.add_argument(
        "--request-id", default=None,
        help="keep only this request's span tree",
    )
    ap.add_argument(
        "-o", "--output", default="-",
        help="output path (default '-' = stdout)",
    )
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not args.router and not args.replica:
        ap.error("need at least one --router or --replica URL")

    trace, n_sources = stitch(args.router, args.replica, args.request_id, args.timeout)
    text = json.dumps(trace)
    if args.output == "-":
        print(text)
    else:
        Path(args.output).write_text(text)
        n = len(trace["traceEvents"])
        print(f"wrote {args.output}: {n} events from "
              f"{n_sources} components", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
