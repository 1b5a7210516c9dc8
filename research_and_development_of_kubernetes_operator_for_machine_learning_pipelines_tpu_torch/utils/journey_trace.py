"""Journey-ring trace loader: the planner's replayable traffic input.

The router's ``GET /router/debug/requests`` export is a spec'd,
replayable record of real traffic — every request's arrival instant
(``ts_us``, microseconds since router start), request id, and journey
metadata.  The offline SLO planner (``operator/planner.py``) replays
those arrivals through an analytic cost model, so this loader is the
contract boundary between the live fleet and the planner: it parses the
export into typed :class:`TraceRequest` rows and rejects anything it
does not understand with :class:`TraceFormatError` instead of
mis-parsing a drifted export into a silently wrong plan.

Versioning: the export carries a top-level ``format_version`` (added in
the same change as this loader).  Absence is tolerated — every export
that predates the field IS version 1 — but a PRESENT version this
loader does not know is a typed rejection.  Unknown per-request keys
are ignored (the journey record grows fields routinely); the loader
additionally honors OPTIONAL extension keys the live export does not
emit (``prompt_tokens``, ``max_new_tokens``, ``slo_class``) so
hand-written and augmented fixture traces can carry the workload shape
the planner's cost model needs.  Requests missing those keys replay at
documented defaults.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping

JOURNEY_TRACE_FORMAT_VERSION = 1

# Replay defaults for exports that carry arrivals only (the live router
# journey ring does not know token counts): a mid-size chat turn.
DEFAULT_PROMPT_TOKENS = 128
DEFAULT_MAX_NEW_TOKENS = 64
DEFAULT_SLO_CLASS = "interactive"

SLO_CLASSES = ("interactive", "batch", "best-effort")


class TraceFormatError(ValueError):
    """The trace payload is not a journey export this loader knows."""


@dataclass(frozen=True)
class TraceRequest:
    """One replayable arrival."""

    arrival_s: float  # seconds since the first request in the trace
    request_id: str = ""
    prompt_tokens: int = DEFAULT_PROMPT_TOKENS
    max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS
    slo_class: str = DEFAULT_SLO_CLASS


@dataclass(frozen=True)
class JourneyTrace:
    """A parsed journey export: arrivals sorted ascending."""

    requests: tuple[TraceRequest, ...]
    started_unix: float = 0.0
    format_version: int = JOURNEY_TRACE_FORMAT_VERSION

    @property
    def span_s(self) -> float:
        """First-to-last arrival span (0 for <= 1 request)."""
        if not self.requests:
            return 0.0
        return self.requests[-1].arrival_s - self.requests[0].arrival_s


def _parse_request(entry, index: int) -> tuple[float, TraceRequest]:
    if not isinstance(entry, Mapping):
        raise TraceFormatError(
            f"journey trace requests[{index}] is not an object: "
            f"{type(entry).__name__}"
        )
    # Arrival instant: ts_us (journey-ring monotonic microseconds) is
    # authoritative; ``wall`` (unix seconds) is the fallback for
    # hand-written fixtures.  Neither present -> typed reject.
    if "ts_us" in entry:
        try:
            t = float(entry["ts_us"]) / 1e6
        except (TypeError, ValueError):
            raise TraceFormatError(
                f"journey trace requests[{index}].ts_us is not numeric: "
                f"{entry['ts_us']!r}"
            ) from None
    elif "wall" in entry:
        try:
            t = float(entry["wall"])
        except (TypeError, ValueError):
            raise TraceFormatError(
                f"journey trace requests[{index}].wall is not numeric: "
                f"{entry['wall']!r}"
            ) from None
    else:
        raise TraceFormatError(
            f"journey trace requests[{index}] has neither ts_us nor wall "
            "— not a journey-ring export"
        )
    slo_class = str(entry.get("slo_class", DEFAULT_SLO_CLASS))
    if slo_class not in SLO_CLASSES:
        raise TraceFormatError(
            f"journey trace requests[{index}].slo_class {slo_class!r} "
            f"not in {SLO_CLASSES}"
        )
    try:
        prompt_tokens = int(
            entry.get("prompt_tokens", DEFAULT_PROMPT_TOKENS)
        )
        max_new_tokens = int(
            entry.get("max_new_tokens", DEFAULT_MAX_NEW_TOKENS)
        )
    except (TypeError, ValueError):
        raise TraceFormatError(
            f"journey trace requests[{index}] token counts are not "
            "integers"
        ) from None
    if prompt_tokens <= 0 or max_new_tokens <= 0:
        raise TraceFormatError(
            f"journey trace requests[{index}] token counts must be "
            f"positive, got prompt_tokens={prompt_tokens} "
            f"max_new_tokens={max_new_tokens}"
        )
    return t, TraceRequest(
        arrival_s=0.0,  # rebased below once the minimum is known
        request_id=str(entry.get("request_id", "")),
        prompt_tokens=prompt_tokens,
        max_new_tokens=max_new_tokens,
        slo_class=slo_class,
    )


def load_journey_trace(source) -> JourneyTrace:
    """Parse a ``/router/debug/requests`` export (or fixture).

    ``source`` is a path (str / Path) to a JSON file, or the
    already-decoded dict.  Raises :class:`TraceFormatError` on anything
    that is not a journey export this loader understands — including a
    PRESENT ``format_version`` newer than
    :data:`JOURNEY_TRACE_FORMAT_VERSION`.
    """
    if isinstance(source, (str, Path)):
        try:
            payload = json.loads(Path(source).read_text())
        except json.JSONDecodeError as e:
            raise TraceFormatError(
                f"journey trace {source} is not valid JSON: {e}"
            ) from None
    else:
        payload = source
    if not isinstance(payload, Mapping):
        raise TraceFormatError(
            f"journey trace payload is not an object: "
            f"{type(payload).__name__}"
        )
    version = payload.get("format_version", JOURNEY_TRACE_FORMAT_VERSION)
    if not isinstance(version, int) or isinstance(version, bool):
        raise TraceFormatError(
            f"journey trace format_version is not an integer: {version!r}"
        )
    if version != JOURNEY_TRACE_FORMAT_VERSION:
        raise TraceFormatError(
            f"journey trace format_version {version} is not supported "
            f"(this loader knows version {JOURNEY_TRACE_FORMAT_VERSION}); "
            "refusing to mis-parse a drifted export"
        )
    raw = payload.get("requests")
    if not isinstance(raw, list):
        raise TraceFormatError(
            "journey trace has no 'requests' list — not a "
            "/router/debug/requests export"
        )
    parsed = [_parse_request(entry, i) for i, entry in enumerate(raw)]
    parsed.sort(key=lambda tr: tr[0])
    t0 = parsed[0][0] if parsed else 0.0
    requests = tuple(
        TraceRequest(
            arrival_s=t - t0,
            request_id=req.request_id,
            prompt_tokens=req.prompt_tokens,
            max_new_tokens=req.max_new_tokens,
            slo_class=req.slo_class,
        )
        for t, req in parsed
    )
    started = payload.get("started_unix", 0.0)
    try:
        started = float(started)
    except (TypeError, ValueError):
        raise TraceFormatError(
            f"journey trace started_unix is not numeric: {started!r}"
        ) from None
    return JourneyTrace(
        requests=requests,
        started_unix=started,
        format_version=version,
    )
