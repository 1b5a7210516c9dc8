"""Tracing and profiling (port of the JAX package's ``utils/tracing.py``).

Two layers:

- lightweight spans for the control plane: ``span("reconcile")`` records
  wall-time stats per name (count/total/max), queryable for logs or export
  (``GET /debug/spans``);
- PyTorch profiler hooks for the data plane: ``torch_profile(dir)`` wraps
  ``torch.profiler.profile`` (the card's activity, or the host's ops where
  there is no card) and writes a Chrome trace into ``dir``, so a server can
  capture a device trace on demand (``POST /debug/profile``);
  ``annotate`` marks a named region that shows on the profiler's host
  timeline and, on the card, as an NVTX range.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class Tracer:
    def __init__(self):
        self._stats: dict[str, SpanStats] = defaultdict(SpanStats)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._stats[name].observe(dt)

    def stats(self) -> dict[str, SpanStats]:
        """Point-in-time snapshot.  The values are COPIES taken under the
        lock: handing out the live mutable ``SpanStats`` let ``report()``
        read torn counts mid-``observe`` (count bumped, total_s not yet)."""
        with self._lock:
            return {
                name: SpanStats(s.count, s.total_s, s.max_s)
                for name, s in self._stats.items()
            }

    def as_dict(self) -> dict[str, dict]:
        """JSON-ready stats (the ``/debug/spans`` payload shape on both
        the server and the operator's metrics listener)."""
        return {
            name: {
                "count": s.count,
                "total_s": round(s.total_s, 6),
                "mean_ms": round(s.mean_s * 1e3, 3),
                "max_ms": round(s.max_s * 1e3, 3),
            }
            for name, s in sorted(self.stats().items())
        }

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats().items()):
            lines.append(
                f"{name}: n={s.count} mean={s.mean_s*1e3:.2f}ms "
                f"max={s.max_s*1e3:.2f}ms total={s.total_s:.3f}s"
            )
        return "\n".join(lines)


GLOBAL_TRACER = Tracer()
span = GLOBAL_TRACER.span


# The file ``torch_profile`` writes into its directory.
TRACE_FILE = "trace.json"


def keep_cupti() -> None:
    """Keep CUPTI set up after a capture stops (Kineto's
    ``TEARDOWN_CUPTI=0``, which torch sets itself for its own CUDA graph
    users: graphs do not work well with a CUPTI teardown and re-init).  A
    value already in the environment is left as it is."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")


@contextlib.contextmanager
def torch_profile(log_dir: str, hold=contextlib.nullcontext):
    """Profile the card's activity (its kernels, copies and the CUDA
    runtime calls that launched them) for the duration, or the host's ops
    where there is no card; the Chrome trace lands in
    ``log_dir/trace.json``.  On the card the host's op tracing stays off: on
    a replica under traffic it held the scheduler thread for seconds when
    the capture stopped, and once never returned.  ``hold()`` is entered
    around the profiler's start and its stop, each alone: a replica passes
    its engine's ``between_ticks``, since starting or stopping the
    profiler beside a CUDA graph replay on another thread deadlocked.
    On the card CUPTI stays set up after the stop (:func:`keep_cupti`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    if on_card:
        keep_cupti()
    activities = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with hold():
        prof.start()
    try:
        yield prof
    finally:
        with hold():
            prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the profiler's timeline (``record_function``), and
    an NVTX range on the card."""
    import torch

    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
