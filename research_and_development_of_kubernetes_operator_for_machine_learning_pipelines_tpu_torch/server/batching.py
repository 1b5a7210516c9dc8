"""Dynamic request batching with power-of-two padding buckets (port of the
JAX package's ``server/batching.py``).

Requests queue briefly (``max_batch_delay_ms``), are grouped by trailing
shape (a seq-128 BERT batch never pads against a seq-32 one), stacked,
padded up to the next power-of-two batch bucket, run once, and split back
per caller.

On the card every launch happens on the batcher's collector thread: single
examples (``submit``) and already-formed client batches (``submit_batch``)
alike.  In the pipelined mode (``materialize`` given) ``run_batch`` returns
device tensors as soon as the kernels are queued (CUDA launches are
asynchronous), and the completion thread's ``materialize`` is the copy to
the host that waits for them, so the collector forms and launches batch
N+1 while batch N still runs.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np


def next_bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


def _group_key(inputs: Mapping[str, np.ndarray]) -> tuple:
    return tuple(sorted((k, v.shape[1:], str(v.dtype)) for k, v in inputs.items()))


def seq_buckets(spec: Mapping[str, Any]) -> list[int]:
    """The servable length-bucket ladder for a ``seq_pad`` spec: powers of
    two from ``min_bucket``, topped by ``max_len`` itself (which may not
    be a power of two).  One definition for what is padded onto and what
    the engine warms."""
    max_len = int(spec.get("max_len") or 0)
    ladder = []
    length = max(int(spec.get("min_bucket", 16)), 1)
    while not max_len or length < max_len:
        ladder.append(length)
        if not max_len and length >= 1 << 20:
            break  # uncapped spec: don't ladder to infinity
        length *= 2
    if max_len:
        ladder.append(max_len)
    return ladder


def apply_seq_pad(
    inputs: Mapping[str, np.ndarray], spec: Mapping[str, Any]
) -> dict[str, np.ndarray]:
    """Pad sequence-shaped inputs to a power-of-two length bucket.

    ``spec`` (``Predictor.seq_pad``) is declarative:

    - ``axis``: the sequence axis (default 1);
    - ``pad_values``: {input_name: fill} -- only these inputs are padded;
    - ``synthesize``: {input_name: fill} -- inputs created as a full
      ``fill`` array when the request omits them, BEFORE padding (BERT's
      attention mask, or the padded ids would be attended);
    - ``min_bucket`` (default 16) and ``max_len`` (cap): a longer request
      raises ValueError, which the HTTP layer turns into a 400.
    """
    axis = int(spec.get("axis", 1))
    pad_values = spec.get("pad_values") or {}
    out = dict(inputs)
    ref = next((out[k] for k in pad_values if k in out), None)
    if ref is None:
        return out
    for name, fill in (spec.get("synthesize") or {}).items():
        if name not in out:
            out[name] = np.full_like(ref, fill)
    lengths = {k: out[k].shape[axis] for k in pad_values if k in out}
    if len(set(lengths.values())) > 1:
        # Padding each input to the max would silently mask out real
        # tokens: a malformed request errors instead.
        raise ValueError(
            f"sequence inputs disagree on length along axis {axis}: {lengths}"
        )
    length = next(iter(lengths.values()))
    max_len = int(spec.get("max_len") or 0)
    if max_len and length > max_len:
        raise ValueError(
            f"sequence length {length} exceeds the model maximum {max_len}"
        )
    bucket = next((b for b in seq_buckets(spec) if b >= length), None)
    if bucket is None:
        raise ValueError(
            f"sequence length {length} exceeds the bucket ladder "
            f"(declare max_len in seq_pad to raise the cap explicitly)"
        )
    if bucket <= length:
        return out  # already exactly bucket-sized
    for name in pad_values:
        if name not in out:
            continue
        v = out[name]
        widths = [(0, 0)] * v.ndim
        widths[axis] = (0, bucket - v.shape[axis])
        out[name] = np.pad(v, widths, constant_values=pad_values[name])
    return out


@dataclass
class _Item:
    inputs: dict[str, np.ndarray]  # each [rows, ...]
    future: Future
    # A client batch (submit_batch): dispatched alone, as it is, and its
    # whole output delivered to the one future.
    whole: bool = False
    enqueued_at: float = field(default_factory=time.perf_counter)


class DynamicBatcher:
    """Collects single-example requests into padded batches.

    ``run_batch(inputs: dict[str, np.ndarray])`` is called with stacked and
    padded arrays on the collector thread; outputs are split along axis 0
    and delivered to each request's Future.

    **Pipelined mode** (pass ``materialize``): ``run_batch`` only launches
    and ``materialize(out)`` is the blocking wait, run on the completion
    thread, so batch N+1 is formed and launched while batch N runs, bounded
    by ``max_inflight`` launched-but-unmaterialized batches (the put
    blocks as backpressure).  Without ``materialize`` one batch runs at a
    time.
    """

    def __init__(
        self,
        run_batch: Callable[[dict[str, np.ndarray]], Any],
        max_batch_size: int = 32,
        max_batch_delay_ms: float = 5.0,
        on_batch: Callable[[int, float, float, float], None] | None = None,
        materialize: Callable[[Any], Any] | None = None,
        max_inflight: int = 2,
    ):
        self._run_batch = run_batch
        self._materialize = materialize
        self.max_batch_size = int(max_batch_size)
        self.max_delay_s = float(max_batch_delay_ms) / 1000.0
        self.max_inflight = max(1, int(max_inflight)) if materialize else 1
        self._on_batch = on_batch
        self._queue: queue.Queue[_Item | None] = queue.Queue()
        self._inflight: queue.Queue = queue.Queue(maxsize=self.max_inflight)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="batcher-collector")
        self._completer = threading.Thread(
            target=self._completion_worker, daemon=True, name="batcher-completer"
        )
        self._started = False
        self._stop = False

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()
            self._completer.start()

    def stop(self) -> None:
        self._stop = True
        self._queue.put(None)
        if self._started:
            # A wedged materialize can leave the completer stuck and the
            # in-flight queue full (with the collector blocked on its
            # put): drain BEFORE joining so the collector unsticks, and
            # never block on the sentinel put.
            self._drain_inflight()
            self._thread.join(timeout=5)
            try:
                self._inflight.put_nowait(None)
            except queue.Full:
                self._drain_inflight()
                try:
                    self._inflight.put_nowait(None)
                except queue.Full:
                    pass  # completer is wedged; it's a daemon thread
            self._completer.join(timeout=5)
        # Fail anything still queued so waiting HTTP requests get an error
        # instead of hanging.
        self._drain_inflight()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("server shutting down"))

    def _drain_inflight(self) -> None:
        while True:
            try:
                entry = self._inflight.get_nowait()
            except queue.Empty:
                return
            if entry is not None:
                for item in entry[0]:
                    if not item.future.done():
                        item.future.set_exception(
                            RuntimeError("server shutting down")
                        )

    # -- client side ---------------------------------------------------------

    def submit(self, inputs: Mapping[str, np.ndarray]) -> Future:
        """Submit one example (arrays WITHOUT batch dim); returns a Future."""
        batched = {k: np.asarray(v)[None, ...] for k, v in inputs.items()}
        fut: Future = Future()
        self._queue.put(_Item(batched, fut))
        return fut

    def submit_batch(self, inputs: Mapping[str, np.ndarray]) -> Future:
        """Submit an already-batched input dict, run as one batch of its own
        on the collector thread (no grouping, no padding); the Future gets
        the whole output."""
        fut: Future = Future()
        self._queue.put(_Item({k: np.asarray(v) for k, v in inputs.items()}, fut,
                              whole=True))
        return fut

    # -- worker side ---------------------------------------------------------

    def _collect(self) -> list[_Item]:
        first = self._queue.get()
        if first is None:
            return []
        if first.whole:
            return [first]
        items = [first]
        deadline = time.perf_counter() + self.max_delay_s
        key = _group_key(first.inputs)
        pending: list[_Item] = []
        while len(items) < self.max_batch_size:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._stop = True
                break
            if not item.whole and _group_key(item.inputs) == key:
                items.append(item)
            else:
                pending.append(item)  # other shape, or a client batch: next
        for p in pending:
            self._queue.put(p)
        return items

    def _worker(self) -> None:
        while not self._stop:
            items = self._collect()
            if not items:
                continue
            self._dispatch(items)

    def _dispatch(self, items: list[_Item]) -> None:
        """Stack, pad and launch one batch.  Launch errors (bad shapes,
        unsupported inputs) fail this batch's futures here; errors that
        surface only when the device finishes arrive at materialize time
        in the completer."""
        try:
            if items[0].whole:
                stacked = items[0].inputs
                n = int(next(iter(stacked.values())).shape[0])
            else:
                n = len(items)
                bucket = next_bucket(n, self.max_batch_size)
                stacked = {
                    k: np.concatenate([it.inputs[k] for it in items], axis=0)
                    for k in items[0].inputs
                }
                if bucket > n:  # pad by repeating the last example (valid data)
                    stacked = {
                        k: np.concatenate([v, np.repeat(v[-1:], bucket - n, axis=0)])
                        for k, v in stacked.items()
                    }
            queue_age = time.perf_counter() - items[0].enqueued_at
            t_run = time.perf_counter()
            out = self._run_batch(stacked)
        except Exception as e:
            for item in items:
                if not item.future.done():
                    item.future.set_exception(e)
            return
        if self._stop:
            # stop() may already have drained the in-flight queue and let
            # the completer exit: fail these futures directly.
            for item in items:
                if not item.future.done():
                    item.future.set_exception(RuntimeError("server shutting down"))
            return
        # Blocks once max_inflight batches are launched-but-unfinished.
        self._inflight.put((items, n, out, queue_age, t_run))

    def _completion_worker(self) -> None:
        t_prev_done = 0.0
        while True:
            entry = self._inflight.get()
            if entry is None:
                return
            items, n, out, queue_age, t_run = entry
            try:
                if self._materialize is not None:
                    out = self._materialize(out)
                done = time.perf_counter()
                # Marginal run time: from max(launch, previous completion),
                # so a pipelined batch's wait behind its predecessor is its
                # own term (pipeline_wait), not run time.
                run_seconds = done - max(t_run, t_prev_done)
                pipeline_wait = max(0.0, t_prev_done - t_run)
                t_prev_done = done
                if self._on_batch:
                    self._on_batch(n, queue_age, run_seconds, pipeline_wait)
                outputs = [out] if items[0].whole else _split_outputs(out, n)
                for i, item in enumerate(items):
                    if not item.future.done():  # stop() may have failed it
                        item.future.set_result(outputs[i])
            except Exception as e:
                for item in items:
                    if not item.future.done():
                        item.future.set_exception(e)


def _split_outputs(out: Any, n: int) -> list[Any]:
    """Split batch-dim-0 outputs (array or tuple/dict of arrays) into n rows."""
    if isinstance(out, (tuple, list)):
        parts = [_split_outputs(o, n) for o in out]
        return [tuple(p[i] for p in parts) for i in range(n)]
    if isinstance(out, dict):
        parts = {k: _split_outputs(v, n) for k, v in out.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    arr = np.asarray(out)
    return [arr[i] for i in range(n)]
