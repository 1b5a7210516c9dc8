"""Offline SLO planner CLI (the scriptable face of ``spec.planner``).

The counterpart of the JAX repository's ``scripts/plan.py``, with its
flags and output.  Replays a journey-ring trace (``GET
/router/debug/requests`` export, or the committed fixture) through the
port's analytic cost model (``operator/planner.py``) and prints the
cheapest knob configuration meeting the objective as JSON: exactly the
dict the reconciler writes to ``status.plan``.  The rooflines are the
card's, ``detect_peaks()``: the H100's, detected on the card and assumed
anywhere else, so the plan is the same on the card and on the host.

``--dry-run --expect tests/fixtures/journey_plan_h100.json`` re-plans the
committed fixture trace and fails on ANY byte drift from the committed
plan (``make torch-plan-contract``), so a cost-model change must
re-commit the fixture plan (and say why) instead of silently re-shaping
fleets::

    python -m <port>.scripts.plan --trace export.json --objective-ttft-p99-ms 250
    python -m <port>.scripts.plan --dry-run --expect tests/fixtures/journey_plan_h100.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

DEFAULT_TRACE = "tests/fixtures/journey_trace.json"
DEFAULT_OBJECTIVE_MS = 250.0


def plan_text(trace_path: str, objective_ms: float = DEFAULT_OBJECTIVE_MS, chips: int = 8,
              seed: int = 0) -> str:
    """The plan of the trace at ``trace_path`` as the CLI prints it."""
    from ..operator import planner
    from ..utils.journey_trace import load_journey_trace

    result = planner.plan(load_journey_trace(trace_path), {"ttftP99Ms": objective_ms},
                          chips_available=chips, seed=seed)
    return json.dumps(result, indent=1, sort_keys=True) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--trace", default=DEFAULT_TRACE,
        help="journey trace: a /router/debug/requests export on disk",
    )
    ap.add_argument(
        "--objective-ttft-p99-ms", type=float,
        default=DEFAULT_OBJECTIVE_MS,
        help="the interactive-class TTFT p99 objective the plan must meet",
    )
    ap.add_argument(
        "--chips", type=int, default=8,
        help="cards the topology provides (bounds tp * replicas)",
    )
    ap.add_argument(
        "--seed", type=int, default=0,
        help="recorded in the plan for provenance (the search is "
        "exhaustive and deterministic; the seed changes nothing)",
    )
    ap.add_argument(
        "--dry-run", action="store_true",
        help="plan and print only; never touches a cluster (the only "
        "mode; the flag exists for CLI-contract parity with bench.py)",
    )
    ap.add_argument(
        "--expect",
        help="path to a committed plan JSON; exit 1 if the computed "
        "plan differs byte-for-byte (the plan-contract gate)",
    )
    args = ap.parse_args(argv)

    from ..utils.journey_trace import TraceFormatError

    try:
        text = plan_text(args.trace, args.objective_ttft_p99_ms, args.chips, args.seed)
    except (TraceFormatError, ValueError) as e:
        print(f"plan: {e}", file=sys.stderr)
        return 2
    sys.stdout.write(text)
    if args.expect:
        expected = Path(args.expect).read_text()
        if text != expected:
            print(
                f"plan-contract FAILED: computed plan differs from "
                f"{args.expect}; the cost model or grid drifted; if "
                "intentional, re-commit the fixture plan",
                file=sys.stderr,
            )
            return 1
        print(f"plan-contract OK ({args.expect})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
