"""Injectable time source.

The reference drives all pacing with ``await asyncio.sleep(...)`` inside an
infinite handler (``mlflow_operator.py:92,:154,:340,:352``), which makes the
promotion loop untestable without real wall time.  The rebuild injects a
``Clock`` everywhere time is read so the whole canary state machine can be
unit-tested with a ``FakeClock``.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    def now(self) -> float:
        """Seconds since an arbitrary epoch; must be monotonic non-decreasing."""
        ...


class SystemClock:
    """Wall-clock backed by ``time.monotonic`` (promotion pacing never needs
    calendar time, and monotonic survives NTP steps)."""

    def now(self) -> float:
        return time.monotonic()


class FakeClock:
    """Deterministic clock for tests; advance manually."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("cannot move a monotonic clock backwards")
        self._t += seconds
