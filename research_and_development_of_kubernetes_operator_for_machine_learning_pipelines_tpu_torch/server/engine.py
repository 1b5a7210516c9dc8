"""Inference engine: warmup and dispatch for a Predictor (port of the JAX
package's ``server/engine.py``).

There is no compile in the port: PyTorch runs eagerly and the kernels are
built once per process.  Warmup runs every batch bucket (and the length
buckets at the batch-grid edges) once before traffic, so the kernel
libraries are loaded, cuBLAS has picked its algorithms and the caching
allocator holds its blocks when the first request arrives.
``on_compile`` keeps the reference's meaning as "a new input signature",
which the server counts in ``tpumlops_compilations``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..models.registry import Predictor

_log = logging.getLogger("tpumlops_torch.engine")


def warmup_buckets(max_batch_size: int) -> list[int]:
    """Batch buckets to warm: powers of two up to the cap, plus the cap
    itself when it isn't one (``next_bucket()`` clamps there)."""
    buckets = []
    b = 1
    while b <= max_batch_size:
        buckets.append(b)
        b <<= 1
    if buckets[-1] != max_batch_size:
        buckets.append(max_batch_size)
    return buckets


class InferenceEngine:
    def __init__(
        self,
        predictor: Predictor,
        max_batch_size: int = 32,
        on_compile: Callable[[], None] | None = None,
    ):
        self.predictor = predictor
        self.max_batch_size = int(max_batch_size)
        self._on_compile = on_compile
        self._seen_signatures: set[tuple] = set()
        self._lock = threading.Lock()
        # predict_async calls since construction (warmup included).
        self.dispatches = 0

    def _call_predict(self, inputs: Mapping[str, Any]):
        """Single input -> positional call; several -> keyword call."""
        if len(inputs) == 1:
            (value,) = inputs.values()
            return self.predictor.predict(value)
        return self.predictor.predict(**inputs)

    @staticmethod
    def _signature(inputs: Mapping[str, np.ndarray]) -> tuple:
        return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in inputs.items()))

    def predict(self, inputs: Mapping[str, np.ndarray]) -> Any:
        """Run one already-batched input dict; returns numpy outputs."""
        return self.materialize(self.predict_async(inputs))

    def predict_async(self, inputs: Mapping[str, np.ndarray]) -> Any:
        """Launch one already-batched input dict WITHOUT waiting: the
        returned tensors live on the model's device and are ready once the
        queued kernels finish.  Pair with :meth:`materialize`."""
        sig = self._signature(inputs)
        with self._lock:
            new_sig = sig not in self._seen_signatures
            if new_sig:
                self._seen_signatures.add(sig)
            self.dispatches += 1
        if new_sig:
            if self._on_compile:
                self._on_compile()
            _log.info("new input signature %s", sig)
        return self._call_predict(inputs)

    def materialize(self, out: Any) -> Any:
        """Copy ``out`` to the host as numpy, which waits for the device."""
        if isinstance(out, (tuple, list)):
            return tuple(self.materialize(o) for o in out)
        if isinstance(out, dict):
            return {k: self.materialize(v) for k, v in out.items()}
        if isinstance(out, torch.Tensor):
            return out.detach().cpu().numpy()
        return np.asarray(out)

    def warmup(
        self, predict: Callable[[Mapping[str, np.ndarray]], Any] | None = None
    ) -> float:
        """Run every batch bucket once ahead of traffic; returns seconds.

        ``predict`` overrides the dispatch path (the server passes the
        batcher's, so warmup launches on the collector thread too)."""
        if self.predictor.example_input is None:
            return 0.0
        predict = predict or self.predict
        t0 = time.perf_counter()
        n_shapes = 0
        for b in warmup_buckets(self.max_batch_size):
            ex = self.predictor.example_input(b)
            if not isinstance(ex, Mapping):
                ex = {"x": ex}
            predict(ex)
            n_shapes += 1
        # Sequence-bucketed predictors: also the LENGTH buckets at the
        # batch-grid edges (batch 1 and max).
        seq_pad = self.predictor.seq_pad
        if seq_pad:
            from .batching import seq_buckets

            axis = int(seq_pad.get("axis", 1))
            example = self.predictor.example_input(1)
            pad_names = [k for k in (seq_pad.get("pad_values") or {})
                         if isinstance(example, Mapping) and k in example]
            if pad_names and seq_pad.get("max_len"):

                def at_length(b: int, length: int) -> dict:
                    ex = self.predictor.example_input(b)
                    idx = np.zeros(length, np.intp)  # repeat position 0
                    return {k: (np.take(v, idx, axis=axis) if k in pad_names else v)
                            for k, v in ex.items()}

                base_len = example[pad_names[0]].shape[axis]
                for length in seq_buckets(seq_pad):
                    if length == base_len:
                        continue  # base length covered above
                    for b in (1, self.max_batch_size):
                        predict(at_length(b, length))
                        n_shapes += 1
        dt = time.perf_counter() - t0
        _log.info("warmup ran %d shapes in %.1fs", n_shapes, dt)
        return dt
