"""HTTP server for ``/generate`` and the V2 predict path (port of the JAX
package's ``server/app.py``).

Standard library only (``http.server.ThreadingHTTPServer``): the GPU
machine's Python has no aiohttp.  Each request runs on its own handler
thread and waits on futures; tensor work stays on the engine's threads
(the generation engine's scheduler, or the dynamic batcher's collector).
``build_server`` picks the engine by the predictor's flavor.

Routes:

- ``POST /v2/models/{name}/generate`` (causal LMs) -- the simple form
  ``{"prompt_ids": [[...]] or [...], "max_new_tokens": N, ...}`` or the V2
  tensor form ``{"inputs": [{"name": "prompt_ids", ...}, {"name":
  "lengths", ...}?], "parameters": {...}}``; parameters ``max_new_tokens``,
  ``eos_id``, ``temperature``, ``top_k``, ``top_p``, ``seed`` (row i
  samples with ``seed + i``), ``stream``, ``slo_class`` (``interactive``,
  ``batch`` or ``best-effort``; the server's ``--slo-class`` when absent,
  a 400 when not a class) and ``debug`` (the response carries a
  ``timing`` block: queue and first-token ms, prefill chunks, cached
  tokens, accepted drafts, each row's trace).  Unknown keys are a 400.
  A prompt the engine quarantined (its admission crashed the engine
  twice) is a 422 with ``reason: poison_quarantined``.
  ``"stream": true`` (one prompt) answers Server-Sent Events over a
  chunked body: ``data: {"index": i, "token": t}`` per token, then
  ``data: {"done": true, "output_ids": [...]}``, or a terminal ``event:
  error`` whose data names the ``reason``.  The status line is out before
  the outcome is known, so the gate's request metric records 499 for a
  client that went away (its future is cancelled and its slot freed at
  the next tick) and 500 for an engine failure.  A request over the
  admission budget, or any while draining, is a 429 with ``Retry-After``
  and a body naming ``reason`` (``budget``, ``class_<name>`` at a class's
  fraction of the budget, or ``draining``) and, with classes armed, the
  request's ``slo_class``; a multi-prompt request is admitted whole or
  shed whole.
- ``POST /v2/models/{name}/infer`` (classifiers) -- V2 tensors in and out.
  Inputs are padded onto the predictor's sequence buckets; a batch of one
  goes through the dynamic batcher, a larger client batch is padded to a
  warmed batch bucket.  400 for bad input or an overlong sequence, 500 for
  a runtime failure.
- ``POST /api/v1.0/predictions`` (classifiers) -- the Seldon protocol:
  ``{"data": {"ndarray": [[...]]}}`` or ``{"data": {"tensor": {"shape":
  [...], "values": [...]}}}`` in (as FP32, one input ``x``), ``{"data":
  {"ndarray": ...}, "meta": {}}`` out, 400 on a bad body; counted in the
  gate's latency histogram like ``/infer``.
- ``POST /api/v1.0/feedback`` -- Seldon's feedback API: ``{"reward": r,
  ...}`` adds ``r`` (a number, else 400) to
  ``tpumlops_feedback_reward_total`` and answers ``{"meta": {}}``; counted
  under ``service="feedback"`` in the request metric, never in the latency
  histogram.
- ``GET /v2/models/{name}`` -- model metadata.
- ``GET /metrics`` -- Prometheus text exposition (``server/metrics.py``);
  both POST routes record every answered request in the gate's families.
- ``GET /readyz``, ``/healthz``, ``/v2/health/ready`` and
  ``/v2/models/{name}/ready`` -- one handler: 200 only while ``ready``,
  503 while loading, draining or shut down, with the ``lifecycle`` (and
  ``inFlight`` while draining).  ``GET /livez`` and ``/v2/health/live``
  stay 200 through a drain.
- ``POST /admin/drain`` -- ``{"grace_s": s}`` stops admissions and waits up
  to ``s`` seconds (default ``--drain-grace-seconds``) for every admitted
  request, streams included, to finish; answers ``lifecycle``, ``drained``
  and ``inFlight``.  ``{"cancel": true}`` reopens admissions.  SIGTERM
  runs the same drain before the server exits.
- ``GET /debug/engine`` (the flight recorder's rings), ``/debug/trace``
  (``?format=chrome``, the default, or ``json``), ``/debug/device`` (the
  HBM ledger, utilization by tick kind, the compile observatory),
  ``/debug/timeseries`` (the per-second ring) -- each a 404 naming its
  flag while that is off -- and ``/debug/spans`` (the span tracer).
  ``POST /debug/profile {"duration_s": s}`` captures a ``torch.profiler``
  trace of the card's activity for ``s`` seconds (0.1-60) under
  ``<tmp>/tpumlops-profile`` (one capture at a time, else 409; the newest
  ``PROFILE_KEEP_DIRS`` kept).  Its stop holds the scheduler for seconds
  on a busy replica, which a watchdog with a short deadline counts.

- ``POST /admin/kv/export`` (the generate body: ``{"prompt_ids": [...]}``)
  -- the prompt's whole-chunk prefix K/V as one handoff blob
  (``application/octet-stream``, ``server/kv_transfer.py``'s wire format,
  the JAX package's byte for byte) with ``X-Tpumlops-Kv-Tokens``; a prefix
  not in the radix cache yet is prefilled first by one
  ``max_new_tokens=1`` admission.  400 ``prompt_too_short`` (no whole
  chunk), 503 ``export_unavailable`` with ``Retry-After`` (the prefix did
  not land in the cache), 429 on a shed.  ``POST /admin/kv/import`` (a
  blob) -- inserts its chunks into the radix cache (one ``kv-import``
  tick); 400 ``bad_blob`` on a corrupt blob, 409 ``geometry_mismatch`` /
  ``dtype_mismatch``, else ``{"imported_tokens", "chunks"}``.  Both need
  the prefix cache (409 ``prefix_cache_disabled``) and count in the request
  metric under ``service`` ``kv-export`` / ``kv-import``.  A request the
  router relays after a handoff carries ``X-Tpumlops-Handoff: <ms>``, which
  its trace records (``handoff_ms``, the ``kv-handoff`` span).
  ``--fleet-role prefill|decode`` (needs ``--prefix-cache 1``) is advisory:
  ``/readyz`` names it as ``fleetRole``.
- ``POST /admin/attach`` (``--warm-pool 1``, which needs ``--snapshot-dir``)
  -- ``{"model_uri": ..., "replace": false, "wake_start_wall": s?}``: a
  warm-pool replica boots with no weights (``/readyz`` 503 ``warm-pool``,
  prediction routes 503 ``warm_pool_empty`` with ``Retry-After: 5``) and
  attaches a model on demand, restored from its snapshot where there is
  one, then its engine is built and started (kernel libraries loaded, CUDA
  graphs captured into a fresh pool); the answer reports ``restored``,
  ``restore_s``, ``capture_s`` and the load's stages.  400 on a server that
  is no warm pool or a body without ``model_uri``; 409 while terminating,
  on a second attach without ``"replace": true``, and on a replace whose
  snapshot's geometry differs (``geometry_incompatible``); the same uri
  and snapshot hash again is a no-op.  ``/readyz`` names the attached
  ``model`` and its ``snapshotHash``.  A warm pool also answers
  ``/v2/models/{any}/generate``, ``/infer`` and ``/ready`` (the
  multiplexer addresses models by its own ids); a generate there holds
  its share of the admission budget under that model name.
- ``--snapshot-dir DIR`` bakes the served tree into a snapshot after the
  first cold load and restores it on later boots and attaches
  (``server/snapshot.py``).

Every response echoes ``X-Request-Id`` (the request's, a W3C
``traceparent`` trace id, or a new one), and every 400, 429 and 500 body
of ``/generate`` carries it as ``request_id``.  Each answered
``/generate`` logs one completion line (logger
``tpumlops_torch.server.requests``): rows, tokens, prefill chunks, prompt
tokens served from the prefix cache and accepted/proposed draft tokens.

The radix prefix cache (``--prefix-cache*``), self-speculative n-gram
decoding (``--speculative*``), packed multi-admission prefill
(``--prefill-batch``, ``--prefill-token-budget``) and fused multi-step
decode (``--decode-steps``) are the reference's serving knobs, refused at
startup with the reference's messages when out of range; the unified
ragged super-step (``--unified-step 1``, the flag the reference operator's
builder derives from a manifest's ``spec.tpu.unifiedStep``) runs every
tick as one dispatch (tick kind ``superstep``).  ``--slo-class`` arms the
engine's class queues with a default class, and ``--preemption 1`` (which
needs ``--prefix-cache 1``) lets a waiting higher class evict a lower one
mid-decode, counted in ``tpumlops_engine_preempt{event}``.

Observability and containment, each off by default (off, nothing of it is
built): ``--trace-ring N`` (the flight recorder), ``--timeseries-ring N``
(seconds of per-second samples), ``--device-telemetry 1`` (HBM ledger,
MFU and bandwidth shares by tick kind, compile observatory; with its
``/metrics`` families), ``--watchdog-deadline-s s`` with
``--watchdog-grace-s g`` (a tick blocked past ``s`` flips ``/readyz`` to
503 ``stalled`` until it completes; past ``s + g`` the process exits so
the pod restarts); ``--compile-cache-dir`` is the node-local directory of
built kernels.

Process flags: on SIGTERM the replica first turns NotReady (``/readyz``
503) and keeps admitting for ``--drain-s`` seconds (the endpoint lag of a
terminating pod), then drains; ``--metrics-port`` (default 6000, 0 off)
serves ``/metrics`` on a listener of its own; ``--log-format json`` writes
every log line as one JSON object, the completion lines with their
``request_id``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import math
import os
import queue
import re
import shutil
import signal
import sys
import tempfile
import threading
import time
import uuid
from concurrent.futures import wait
from contextlib import contextmanager
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from ..models.partition import mesh_device_count
from .batching import DynamicBatcher, apply_seq_pad, next_bucket
from .engine import InferenceEngine
from .flight_recorder import RequestTrace
from .generation import (
    SLO_CLASSES,
    EngineOverloaded,
    EngineShutdown,
    GenerationEngine,
    PoisonRequest,
)
from .launch import SHARE_CARD_ENV
from .metrics import CONTENT_TYPE, ServerMetrics
from .prefix_cache import PrefixCacheConfig
from .speculative import SpeculativeConfig

_log = logging.getLogger("tpumlops_torch.server")
_req_log = logging.getLogger("tpumlops_torch.server.requests")

_GEN_PARAM_KEYS = frozenset(
    {"max_new_tokens", "eos_id", "temperature", "top_k", "top_p", "seed", "stream",
     "slo_class", "debug"}
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}

FLEET_ROLES = ("unified", "prefill", "decode")

_MODEL_ROUTE = re.compile(r"^/v2/models/([^/]+)(?:/(generate|infer|ready))?$")
_READY_ROUTES = frozenset({"/readyz", "/healthz", "/v2/health/ready"})
_LIVE_ROUTES = frozenset({"/livez", "/v2/health/live"})

# W3C traceparent: version-traceid-spanid-flags.
_TRACEPARENT = re.compile(r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

# Capture directories of POST /debug/profile, under the temp directory: a
# trace is tens of MB and the endpoint is unauthenticated, so the newest
# PROFILE_KEEP_DIRS stay and older ones go after each capture.
PROFILE_KEEP_DIRS = 8


def profile_root() -> str:
    return os.path.join(tempfile.gettempdir(), "tpumlops-profile")


def _gc_profile_dirs(root: str, keep: int = PROFILE_KEEP_DIRS) -> list:
    """Delete all but the ``keep`` newest capture directories under
    ``root``; returns the deleted names.  A directory that vanishes
    meanwhile is skipped: GC never fails a capture."""
    try:
        entries = [e for e in os.scandir(root) if e.is_dir(follow_symlinks=False)]
    except OSError:
        return []

    def _mtime(entry) -> float:
        try:
            return entry.stat().st_mtime
        except OSError:
            return 0.0

    entries.sort(key=_mtime, reverse=True)
    evicted = []
    for entry in entries[keep:]:
        try:
            shutil.rmtree(entry.path)
            evicted.append(entry.name)
        except OSError:
            continue
    return evicted


def trace_context_from_headers(headers) -> tuple[str, str]:
    """``(trace_id, parent_span)`` of a well-formed ``traceparent``, else
    ``("", "")``; a request's trace carries them."""
    m = _TRACEPARENT.match((headers.get("traceparent") or "").strip().lower())
    if m:
        return m.group(1), m.group(2)
    return "", ""


def request_id_from_headers(headers) -> str:
    """``X-Request-Id`` (at most 128 printable characters), else the
    ``traceparent`` trace id, else a new uuid4 hex."""
    rid = "".join(c for c in (headers.get("X-Request-Id") or "").strip()[:128]
                  if c.isprintable())
    if rid:
        return rid
    m = _TRACEPARENT.match((headers.get("traceparent") or "").strip().lower())
    if m:
        return m.group(1)
    return uuid.uuid4().hex


_V2_TO_NP = {
    "FP32": np.float32,
    "FP64": np.float64,
    "FP16": np.float16,
    "BF16": np.float32,  # JSON carries floats; the cast happens model-side
    "INT32": np.int32,
    "INT64": np.int64,
    "UINT8": np.uint8,
    "BOOL": np.bool_,
}
_NP_TO_V2 = {
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.bool_): "BOOL",
}


def _check_gen_params(params: dict, allowed: frozenset) -> None:
    unknown = sorted(set(params) - allowed)
    if unknown:
        raise ValueError(
            f"unknown key(s) {unknown} in generate parameters; "
            f"allowed: {sorted(allowed)}"
        )


@dataclass
class ServerConfig:
    model_name: str = "model"
    host: str = "0.0.0.0"
    port: int = 9000
    dtype: str = "bfloat16"
    quantize: str = "none"
    max_slots: int = 4
    prefill_chunk: int | None = None
    # Packed multi-admission prefill (spec.tpu.prefillBatch and
    # prefillTokenBudget): 1 is the single-admission pipeline, 0 no budget.
    prefill_batch: int = 1
    prefill_token_budget: int = 0
    # Fused multi-step decode (spec.tpu.decodeSteps): decode iterations a
    # dispatch, 1 the single-step tick.
    decode_steps: int = 1
    # The unified ragged super-step (spec.tpu.unifiedStep): every tick ONE
    # dispatch of decode, verify and packed-prefill rows.
    unified_step: bool = False
    # SLO classes (spec.tpu.sloClass): the default class of a request that
    # names none; set, it arms the class queues.  Mid-decode preemption
    # (spec.tpu.preemption) needs the prefix cache.
    slo_class: str | None = None
    preemption: bool = False
    device: str | None = None
    # The V2 predict path's dynamic batcher.
    max_batch_size: int = 32
    max_batch_delay_ms: float = 5.0
    # Admission control and drain (the generation engine).
    admission_queue_budget: int = 0
    drain_grace_s: float = 20.0
    # Metric identity (the gate's {deployment_name, predictor_name, namespace}).
    predictor_name: str = "v1"
    deployment_name: str = ""
    namespace: str = "default"
    # Radix prefix cache (spec.tpu.prefixCache).  The reuse unit follows
    # prefill_chunk when unset (64 when that is unset too).
    prefix_cache: bool = False
    prefix_cache_budget_mb: int = 256
    prefix_cache_chunk: int | None = None
    prefix_cache_l2_budget_mb: int = 0
    # Self-speculative n-gram decoding (spec.tpu.speculative).
    speculative: bool = False
    speculative_draft_tokens: int = 4
    speculative_ngram_min: int = 1
    speculative_ngram_max: int = 4
    speculative_adaptive: bool = True
    # Observability (spec.tpu.observability: traceRing, timeseriesRing,
    # deviceTelemetry) and the scheduler watchdog; 0 or off builds nothing.
    trace_ring: int = 0
    timeseries_ring: int = 0
    device_telemetry: bool = False
    watchdog_deadline_s: float = 0.0
    watchdog_grace_s: float = 30.0
    # Disaggregated fleets (--fleet-role): advisory, named on /readyz; a
    # prefill or decode replica needs the prefix cache, whose chunks the
    # KV handoff moves.
    fleet_role: str = "unified"
    # Weight snapshots (--snapshot-dir, "" off) and the warm pool
    # (--warm-pool): a replica booted with no weights attaches one on
    # POST /admin/attach.  model_uri is the boot model, whose snapshot's
    # geometry a warm pool prewarms.
    snapshot_dir: str = ""
    warm_pool: bool = False
    model_uri: str = ""
    # spec.tpu.meshShape (--mesh-shape): {"dp": 1, "tp": 1} is one rank; a
    # mesh of several ranks runs one process a rank (README, "A tp or dp
    # unit").
    mesh_shape: dict | None = None
    # sp > 1: a cold prompt of at least this many tokens prefills through
    # the ring-attention pass instead of serial chunks.
    sp_prefill_threshold: int = 1024

    def __post_init__(self):
        """The reference's startup checks of the serving features (its
        ``TpuSpec``, ``PrefixCacheSpec`` and ``SpeculativeSpec``), the
        caches' and speculation's only when enabled."""
        self.mesh_shape = parse_mesh_shape(self.mesh_shape)
        if self.prefill_batch < 1:
            raise ValueError(f"spec.tpu.prefillBatch must be >= 1, got {self.prefill_batch!r}")
        if not (1 <= self.decode_steps <= 16):
            raise ValueError(f"spec.tpu.decodeSteps must be in [1, 16], got {self.decode_steps!r}")
        if self.prefix_cache:
            chunk = self.prefix_cache_chunk_tokens
            if self.prefill_chunk is not None and chunk != self.prefill_chunk:
                raise ValueError(
                    f"prefixCache.chunkTokens {chunk} must equal prefillChunk "
                    f"{self.prefill_chunk} (the prefill chunk is the prefix reuse "
                    "unit); omit chunkTokens to follow prefillChunk"
                )
            if self.prefix_cache_budget_mb < 1:
                raise ValueError(
                    f"prefixCache.budgetMB must be >= 1, got {self.prefix_cache_budget_mb}")
            if chunk < 1:
                raise ValueError(f"prefixCache.chunkTokens must be >= 1, got {chunk}")
            if self.prefix_cache_l2_budget_mb < 0:
                raise ValueError(
                    f"prefixCache.l2BudgetMB must be >= 0, got {self.prefix_cache_l2_budget_mb}")
        if self.prefill_batch > 1 and not self.prefill_chunk and not self.prefix_cache:
            raise ValueError(
                f"spec.tpu.prefillBatch {self.prefill_batch} requires chunked prefill: set "
                "prefillChunk (or enable prefixCache, which implies it)")
        if self.speculative:
            if not (1 <= self.speculative_draft_tokens <= 64):
                raise ValueError(
                    f"speculative.draftTokens must be in [1, 64], got "
                    f"{self.speculative_draft_tokens}")
            if not (1 <= self.speculative_ngram_min <= self.speculative_ngram_max):
                raise ValueError(
                    "speculative ngram bounds must satisfy 1 <= ngramMin <= ngramMax, got "
                    f"[{self.speculative_ngram_min}, {self.speculative_ngram_max}]")
        if self.prefill_token_budget < 0:
            raise ValueError(
                f"spec.tpu.prefillTokenBudget must be >= 0, got {self.prefill_token_budget!r}")
        if self.slo_class is not None and self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"spec.tpu.sloClass must be one of {list(SLO_CLASSES)}, got {self.slo_class!r}")
        if self.preemption and not self.prefix_cache:
            raise ValueError(
                "spec.tpu.preemption requires spec.tpu.prefixCache.enabled "
                "(an evicted slot's K/V is written back through the radix "
                "prefix cache and restored from it on re-admission)")
        if self.trace_ring < 0:
            raise ValueError(f"observability.traceRing must be >= 0, got {self.trace_ring}")
        if not (0 <= self.timeseries_ring <= 86400):
            raise ValueError(
                f"observability.timeseriesRing must be in [0, 86400], got {self.timeseries_ring}")
        if self.fleet_role not in FLEET_ROLES:
            raise ValueError(f"--fleet-role must be one of {list(FLEET_ROLES)}, "
                             f"got {self.fleet_role!r}")
        if self.fleet_role != "unified" and not self.prefix_cache:
            raise ValueError("--fleet-role prefill/decode requires --prefix-cache 1 "
                             "(KV handoff moves radix prefix-cache chunks)")
        if self.warm_pool and not self.snapshot_dir:
            raise ValueError("--warm-pool requires --snapshot-dir")

    @property
    def prefix_cache_chunk_tokens(self) -> int:
        if self.prefix_cache_chunk is not None:
            return int(self.prefix_cache_chunk)
        return int(self.prefill_chunk or 64)

    def prefix_cache_config(self) -> PrefixCacheConfig | None:
        if not self.prefix_cache:
            return None
        return PrefixCacheConfig(
            enabled=True, budget_bytes=self.prefix_cache_budget_mb * 2**20,
            chunk_tokens=self.prefix_cache_chunk_tokens,
            l2_budget_bytes=self.prefix_cache_l2_budget_mb * 2**20)

    def speculative_config(self) -> SpeculativeConfig | None:
        if not self.speculative:
            return None
        return SpeculativeConfig(
            enabled=True, draft_tokens=self.speculative_draft_tokens,
            ngram_min=self.speculative_ngram_min, ngram_max=self.speculative_ngram_max,
            adaptive=self.speculative_adaptive)


def parse_mesh_shape(value) -> dict:
    """Structural meshShape validation (the reference's
    ``utils/config._parse_mesh_shape``): unknown axes and sizes that are
    not positive integers raise ``ValueError``; absent is ``{"dp": 1,
    "tp": 1}``, one rank."""
    from ..parallel.mesh import MESH_AXIS_ORDER

    mesh = dict(value or {"dp": 1, "tp": 1})
    unknown = set(mesh) - set(MESH_AXIS_ORDER)
    if unknown:
        raise ValueError(
            f"spec.tpu.meshShape has unknown axes {sorted(unknown)}; "
            f"known: {list(MESH_AXIS_ORDER)}"
        )
    out = {}
    for axis, size in mesh.items():
        try:
            n = int(size)
        except (TypeError, ValueError):
            raise ValueError(
                f"spec.tpu.meshShape.{axis} must be a positive integer, got {size!r}"
            ) from None
        if n < 1:
            raise ValueError(f"spec.tpu.meshShape.{axis} must be >= 1, got {n}")
        out[axis] = n
    return out


def _fan(*fns):
    """Chain observer callbacks onto one engine hook (the timeseries ring
    rides the metrics callbacks); None entries drop out, and a single one
    is returned as it is."""
    live = [f for f in fns if f is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]

    def fanned(*args, **kwargs):
        for f in live:
            f(*args, **kwargs)

    return fanned


def make_gen_engine(predictor, config: ServerConfig, metrics: ServerMetrics,
                    recorder=None, telemetry=None, watchdog=None,
                    timeseries=None, channel=None) -> GenerationEngine:
    """Construct the GenerationEngine for a causal-LM predictor, its hooks
    feeding ``metrics``' generation families and, when given, the
    timeseries ring.  ``channel``: a leader's ``multihost.UnitChannel``
    (a follower's engine takes none and is never started)."""
    m, ts = metrics, timeseries
    return GenerationEngine(
        predictor.causal_lm["params"],
        predictor.causal_lm["cfg"],
        max_slots=config.max_slots,
        dtype=_DTYPES[config.dtype],
        eos_id=predictor.causal_lm.get("eos_id"),
        kv_quant=config.quantize == "int8kv",
        prefill_chunk=config.prefill_chunk,
        prefill_batch=config.prefill_batch,
        prefill_token_budget=config.prefill_token_budget,
        on_prefill_batch=m.observe_prefill_batch,
        decode_steps=config.decode_steps,
        unified_step=config.unified_step,
        device=config.device,
        admission_queue_budget=config.admission_queue_budget,
        on_step=_fan(m.observe_decode_step, ts and ts.observe_decode_step),
        on_tokens=m.inc_generated_tokens,
        on_admission_wait=m.observe_admission_wait,
        on_ttft=m.observe_ttft,
        on_itl=_fan(m.observe_itl, ts and ts.observe_itl),
        on_request_tokens=m.observe_request_tokens,
        on_tick=_fan(m.observe_tick, ts and ts.observe_tick),
        on_shed=_fan(m.inc_shed, ts and ts.inc_shed),
        on_dispatch=m.inc_dispatch,
        prefix_cache=config.prefix_cache_config(),
        on_prefix_hit=m.observe_prefix_hit,
        on_prefix_evict=m.inc_prefix_evictions,
        on_prefix_l2=m.inc_prefix_l2,
        speculative=config.speculative_config(),
        on_spec=m.observe_speculative,
        slo_class=config.slo_class,
        preemption=config.preemption,
        on_preempt=m.inc_preempt,
        recorder=recorder,
        telemetry=telemetry,
        watchdog=watchdog,
        on_poison=_fan(m.inc_poison, ts and ts.inc_poison),
        mesh_shape=config.mesh_shape,
        channel=channel,
        sp_prefill_threshold=config.sp_prefill_threshold,
    )


def _timing_summary(request_id: str, traces) -> dict:
    """One /generate request's timing over its rows' traces: the ``"debug":
    true`` response block and the completion log line's fields.  Totals
    agree with the counters the request moved."""
    rows = [t.timing_block() for t in traces]
    queue_ms = [r["queue_ms"] for r in rows if r["queue_ms"] is not None]
    ttft = [r["ttft_ms"] for r in rows if r["ttft_ms"] is not None]
    return {
        "request_id": request_id,
        "tokens": sum(r["tokens"] for r in rows),
        "prefill_chunks": sum(r["prefill_chunks"] for r in rows),
        "cached_tokens": sum(r["cached_tokens"] for r in rows),
        "spec_proposed": sum(r["spec_proposed"] for r in rows),
        "spec_accepted": sum(r["spec_accepted"] for r in rows),
        # The worst row's queue wait, the best row's TTFT.
        "queue_ms": max(queue_ms) if queue_ms else None,
        "ttft_ms": min(ttft) if ttft else None,
        "finish_reasons": sorted({r["finish_reason"] for r in rows}),
        "rows": rows,
    }


def _log_completion(summary: dict, code: int) -> None:
    _req_log.info(
        "generate done request_id=%s code=%d rows=%d tokens=%d queue_ms=%s ttft_ms=%s "
        "prefill_chunks=%d cached_tokens=%d spec_accepted=%d/%d finish=%s",
        summary["request_id"], code, len(summary["rows"]), summary["tokens"],
        summary["queue_ms"], summary["ttft_ms"], summary["prefill_chunks"],
        summary["cached_tokens"], summary["spec_accepted"], summary["spec_proposed"],
        ",".join(summary["finish_reasons"]),
        extra={"request_id": summary["request_id"]},
    )


def _stamp_handoff(headers, traces) -> None:
    """A request the router relays after a prefill-to-decode KV handoff
    carries ``X-Tpumlops-Handoff: <ms>``, the handoff wall it measured:
    ``t_handoff`` anchors the relay in this process's clock, ``handoff_ms``
    keeps the router's number.  A malformed stamp marks nothing."""
    hdr = headers.get("X-Tpumlops-Handoff")
    if not hdr:
        return
    try:
        hms = float(hdr)
    except ValueError:
        return
    now = time.perf_counter()
    for tr in traces:
        tr.t_handoff = now
        tr.handoff_ms = hms


def parse_generate(body: dict) -> tuple[list, dict]:
    """Request body -> (prompts, parameters), in either request form."""
    if "inputs" in body:
        tensors = {
            t["name"]: np.asarray(t["data"], np.int64).reshape(t["shape"])
            for t in body["inputs"]
        }
        if "prompt_ids" not in tensors:
            raise ValueError('missing input tensor "prompt_ids"')
        rows = tensors["prompt_ids"]
        if "lengths" in tensors:
            # Explicit per-row lengths disambiguate right-padding from
            # legitimate trailing 0 tokens.
            lens = tensors["lengths"].reshape(-1)
            if lens.size != rows.shape[0]:
                raise ValueError(
                    f'"lengths" has {lens.size} entries for {rows.shape[0]} prompt rows'
                )
            prompts = [row[: int(n)] for row, n in zip(rows, lens)]
        else:
            prompts = [np.trim_zeros(row, "b") for row in rows]
        params = body.get("parameters", {})
        _check_gen_params(params, _GEN_PARAM_KEYS)
    else:
        raw = body["prompt_ids"]
        prompts = [raw] if raw and np.isscalar(raw[0]) else list(raw)
        params = body
        _check_gen_params(params, _GEN_PARAM_KEYS | {"prompt_ids", "id"})
    if not prompts:
        raise ValueError("prompt_ids is empty")
    return prompts, params


def _to_v2_outputs(out) -> list[dict]:
    if isinstance(out, dict):
        items = list(out.items())
    elif isinstance(out, tuple):
        items = [(f"output_{i}", o) for i, o in enumerate(out)]
    else:
        items = [("output_0", out)]
    v2 = []
    for name, arr in items:
        arr = np.asarray(arr)
        v2.append({
            "name": name,
            "shape": list(arr.shape),
            "datatype": _NP_TO_V2.get(arr.dtype, "FP32"),
            "data": arr.ravel().tolist(),
        })
    return v2


def _add_batch_dim(out):
    if isinstance(out, tuple):
        return tuple(_add_batch_dim(o) for o in out)
    if isinstance(out, dict):
        return {k: _add_batch_dim(v) for k, v in out.items()}
    return np.asarray(out)[None, ...]


def _slice_batch(out, n: int):
    if isinstance(out, tuple):
        return tuple(_slice_batch(o, n) for o in out)
    if isinstance(out, dict):
        return {k: _slice_batch(v, n) for k, v in out.items()}
    return np.asarray(out)[:n]


def _concat_batches(chunks: list):
    if len(chunks) == 1:
        return chunks[0]
    first = chunks[0]
    if isinstance(first, tuple):
        return tuple(_concat_batches([c[i] for c in chunks]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _concat_batches([c[k] for c in chunks]) for k in first}
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


def parse_v2_inputs(body: dict) -> dict[str, np.ndarray]:
    """V2 request tensors -> named numpy arrays (all with one batch dim)."""
    inputs: dict[str, np.ndarray] = {}
    for tensor in body.get("inputs", []):
        dt = _V2_TO_NP.get(tensor.get("datatype", "FP32"))
        if dt is None:
            raise ValueError(f"unsupported datatype {tensor.get('datatype')}")
        inputs[tensor["name"]] = np.asarray(tensor["data"], dtype=dt).reshape(tensor["shape"])
    if not inputs:
        raise ValueError("request has no inputs")
    batches = {k: (v.shape[0] if v.ndim else None) for k, v in inputs.items()}
    if len(set(batches.values())) != 1 or None in batches.values() or 0 in batches.values():
        raise ValueError(f"inputs need one non-empty batch dimension, got {batches}")
    return inputs


class ModelServer(ThreadingHTTPServer):
    """The HTTP server plus the engine it fronts: a ``GenerationEngine``
    for a causal LM (``batcher`` None), or an ``InferenceEngine`` behind a
    ``DynamicBatcher`` for the V2 predict path.  A warm-pool server
    (``attach_fn`` set) starts with neither and attaches a model on
    ``POST /admin/attach``."""

    daemon_threads = True
    # listen() backlog: the default of 5 resets connections under a burst
    # of concurrent clients.
    request_queue_size = 128

    def __init__(self, address, engine, model_name: str, metrics: ServerMetrics,
                 predictor, batcher: DynamicBatcher | None = None,
                 drain_grace_s: float = 20.0, cold_start_anchor: float | None = None,
                 recorder=None, telemetry=None, timeseries=None,
                 config: ServerConfig | None = None, watchdog=None, attach_fn=None,
                 unit_channel=None):
        self.engine = engine
        # A leader of several ranks: the channel its engine broadcasts on,
        # closed (followers released) at shutdown.
        self.unit_channel = unit_channel
        self.model_name = model_name
        self.metrics = metrics
        self.predictor = predictor
        self.batcher = batcher
        self.drain_grace_s = float(drain_grace_s)
        self.lifecycle = "loading"
        # SIGTERM committed the process to exit: a drain can no longer be
        # cancelled.
        self.terminating = False
        self._cold_anchor = cold_start_anchor  # wall of boot, until first token
        # Prediction requests whose answer is not fully written yet: a
        # drain waits for these as well as for the engine, so the last
        # event of a stream is out before the server goes.
        self._answering = 0
        self._answering_lock = threading.Lock()
        # Observability (each None while off) and the one-at-a-time profile.
        self.recorder = recorder
        self.telemetry = telemetry
        self.timeseries = timeseries
        self._profile_lock = threading.Lock()
        # What install() builds engines from, and the fleet role /readyz names.
        self._config = config or ServerConfig(model_name=model_name)
        self._watchdog = watchdog
        self.fleet_role = self._config.fleet_role
        self.snapshot_dir = self._config.snapshot_dir
        # The warm pool: attach_fn(model_uri, load_stats) loads a predictor;
        # the attached model's uri, snapshot hash and geometry.
        self.attach_fn = attach_fn
        self.attached_model_uri: str | None = None
        self.attached_snapshot_hash: str | None = None
        self._attached_geometry: dict | None = None
        self._attach_lock = threading.Lock()
        super().__init__(address, _Handler)

    # -- the engine and the warm pool ------------------------------------------

    def install(self, predictor, warmup: bool = True) -> None:
        """Build and start the engine a loaded predictor needs: a
        ``GenerationEngine`` for a causal LM (``warmup`` builds the kernels;
        a graph engine on the card captures its graphs), else an
        ``InferenceEngine`` behind a started ``DynamicBatcher`` (warmed
        through it, so the batch histograms count those batches)."""
        conf, m = self._config, self.metrics
        batcher = None
        if predictor.causal_lm is not None:
            engine = make_gen_engine(predictor, conf, m, recorder=self.recorder,
                                     telemetry=self.telemetry, watchdog=self._watchdog,
                                     timeseries=self.timeseries, channel=self.unit_channel)
            try:
                engine.start(warmup=warmup)
            except Exception:
                engine.shutdown()
                raise
        else:
            engine = InferenceEngine(predictor, max_batch_size=conf.max_batch_size,
                                     on_compile=m.inc_compilations)
            if self.unit_channel is not None:
                # Every batch is broadcast on the unit's channel before it
                # launches, so the followers replay it (OP_PREDICT).
                from .multihost import MultihostEngine

                engine = MultihostEngine(engine, self.unit_channel.transport,
                                         channel=self.unit_channel)
            # Pipelined: the collector launches batch N+1 while N runs.
            batcher = DynamicBatcher(
                run_batch=engine.predict_async,
                max_batch_size=conf.max_batch_size,
                max_batch_delay_ms=conf.max_batch_delay_ms,
                on_batch=m.observe_batch,
                materialize=engine.materialize,
            )
            batcher.start()
            if warmup:
                try:
                    engine.warmup(predict=lambda ex: batcher.submit_batch(ex).result())
                except Exception:
                    batcher.stop()
                    raise
        self.predictor, self.engine, self.batcher = predictor, engine, batcher

    def release(self) -> None:
        """Stop the engine and drop the model, so its tree, cache and graph
        pool go back to the device before another model loads.  On a unit
        the followers drop theirs too (``OP_DETACH``) and stay for the next
        attach; each rank's peak allocation restarts from what it holds."""
        if self.batcher is not None:
            self.batcher.stop()
        elif self.engine is not None:
            self.engine.shutdown()
        self.engine = self.batcher = self.predictor = None
        if self.unit_channel is not None and not self.unit_channel.closed:
            from .multihost import OP_DETACH, encode_message

            self.unit_channel.run(encode_message(OP_DETACH),
                                  lambda: free_device_memory(reset_peak=True))
        else:
            free_device_memory()

    def rank_reports(self) -> list:
        """Every rank's :func:`rank_report`, gathered to the leader of a
        unit (``OP_REPORT``)."""
        from .multihost import OP_REPORT, encode_message, gather_reports

        gen = self.gen_engine

        def mine():
            return gather_reports(rank_report(
                gen.op_stats if gen is not None else {}, gen_engine=gen,
                predict_engine=self.engine if self.batcher is not None else None,
                device=self._config.device, mesh_shape=self._config.mesh_shape))

        return self.unit_channel.run(encode_message(OP_REPORT), mine)

    def _snapshot_probe(self, model_uri: str) -> tuple[str | None, dict | None]:
        """``(content_hash, geometry)`` of ``model_uri``'s snapshot, or
        ``(None, None)`` when there is none yet (a first attach of a model
        bakes it during the load)."""
        if not self.snapshot_dir:
            return None, None
        try:
            from . import snapshot as _snap

            spath = _snap.snapshot_path_for(self.snapshot_dir, model_uri)
            if not (spath / _snap.MANIFEST_NAME).exists():
                return None, None
            manifest = _snap.read_manifest(spath)
            geom = manifest.get("config")
            return manifest.get("content_hash"), dict(geom) if isinstance(geom, dict) else None
        except Exception:
            return None, None

    def attach(self, model_uri: str, replace: bool = False,
               wake_start: float | None = None) -> tuple[int, dict]:
        """Attach ``model_uri`` to this warm-pool server: ``(code, body)``.

        The model restores from its snapshot where there is one (else it
        loads cold and bakes one); then its engine is built and started: the
        kernel libraries load and a graph engine captures its graphs into a
        fresh pool, because a graph holds the addresses of the weights it
        was captured on.  A replace stops the old engine and releases its
        tree and graph pool first.  The same uri and snapshot hash again is
        a no-op; a replace whose snapshot geometry differs from the attached
        model's is refused before anything stops."""
        if self.terminating or self.lifecycle == "shutdown":
            return 409, {"error": "server is terminating"}
        with self._attach_lock:
            req_hash, req_geom = self._snapshot_probe(model_uri)
            if (self.engine is not None and self.attached_model_uri == model_uri
                    and req_hash is not None and self.attached_snapshot_hash == req_hash):
                return 200, {"lifecycle": self.lifecycle, "model_uri": model_uri,
                             "snapshot_hash": req_hash, "noop": True}
            if self.engine is not None and not replace:
                return 409, {"error": 'a model is already attached; pass "replace": true '
                                      "to swap it", "lifecycle": self.lifecycle}
            if (self.engine is not None and req_geom is not None
                    and self._attached_geometry is not None
                    and req_geom != self._attached_geometry):
                return 409, {
                    "error": f"snapshot geometry of {model_uri} does not match the "
                             "attached model's engine",
                    "reason": "geometry_incompatible",
                    "attached_model_uri": self.attached_model_uri,
                    "lifecycle": self.lifecycle,
                }
            t_receipt = time.time()
            if wake_start is not None:
                self.metrics.observe_cold_start("wake", t_receipt - wake_start)
            anchor = wake_start if wake_start is not None else t_receipt
            self._cold_anchor = anchor
            if self.engine is not None:
                self.lifecycle = "loading"
                self.metrics.set_ready(False)
                self.release()
                self.attached_model_uri = self.attached_snapshot_hash = None
                self._attached_geometry = None
            load_stats: dict = {}
            try:
                predictor = self.attach_fn(model_uri, load_stats)
                self.metrics.observe_model_load(load_stats)
                restored = load_stats.get("restore_s") is not None
                self.metrics.observe_cold_start(
                    "restore" if restored else "load",
                    load_stats.get("restore_s") or load_stats.get("wall_s") or 0.0)
                t_warm = time.perf_counter()
                self.install(predictor, warmup=True)
                capture_s = time.perf_counter() - t_warm
                self.metrics.observe_cold_start("compile", capture_s)
                self.metrics.observe_cold_start("total", time.time() - anchor)
                self.attached_model_uri = model_uri
                self.attached_snapshot_hash, self._attached_geometry = (
                    self._snapshot_probe(model_uri))
                self.lifecycle = "ready"
                self.metrics.set_ready(True)
                if self.timeseries is not None:
                    self.timeseries.mark("attach")  # the detector's new baseline
            except Exception as e:
                _log.exception("attach of %s failed", model_uri)
                self.release()
                self.attached_model_uri = self.attached_snapshot_hash = None
                self._attached_geometry = None
                self.lifecycle = "warm-pool"
                return 500, {"error": f"attach failed: {e}"}
        return 200, {
            "lifecycle": self.lifecycle,
            "model_uri": model_uri,
            "snapshot_hash": self.attached_snapshot_hash,
            "restored": restored,
            "restore_s": load_stats.get("restore_s"),
            "capture_s": round(capture_s, 3),
            "load_breakdown_s": load_stats,
        }

    def readiness(self) -> tuple[int, dict]:
        """The lifecycle probe's answer: 200 only while ``ready``."""
        ready = self.lifecycle == "ready"
        body = {"ready": ready, "lifecycle": self.lifecycle}
        if self.fleet_role != "unified":
            body["fleetRole"] = self.fleet_role
        if self.lifecycle == "draining":
            body["inFlight"] = self.inflight()
        if self.attach_fn is not None:
            # What is on the device, for the multiplexer's bin-packer.
            body["model"] = self.attached_model_uri
            if self.attached_snapshot_hash is not None:
                body["snapshotHash"] = self.attached_snapshot_hash
        return (200 if ready else 503), body

    @property
    def serves(self) -> str:
        return "infer" if self.batcher is not None else "generate"

    def handle_error(self, request, client_address) -> None:
        # A client that closes its kept-alive connection (or a stream)
        # resets the socket the handler waits on: routine, not a fault.
        if isinstance(sys.exc_info()[1], ConnectionError):
            _log.debug("client %s went away", client_address)
            return
        super().handle_error(request, client_address)

    @property
    def gen_engine(self) -> GenerationEngine | None:
        return None if self.batcher is not None else self.engine

    def note_first_token(self) -> None:
        """Close the cold-start ladder at the first token served (once)."""
        anchor, self._cold_anchor = self._cold_anchor, None
        if anchor is not None:
            self.metrics.observe_cold_start("first_token", time.time() - anchor)

    # -- lifecycle -----------------------------------------------------------

    def begin_drain(self) -> None:
        """Readiness goes (503 ``draining``), new /generate requests shed
        with 429, and everything admitted runs to completion."""
        if self.lifecycle == "shutdown":
            return
        self.lifecycle = "draining"
        self.metrics.set_ready(False)
        if self.gen_engine is not None:
            self.gen_engine.begin_drain()

    def cancel_drain(self) -> bool:
        """Reopen admissions and readiness; refused (False) once the
        process is terminating or shut down."""
        if self.terminating:
            return False
        if self.lifecycle != "draining":
            return self.lifecycle == "ready"
        if self.gen_engine is not None:
            self.gen_engine.cancel_drain()
        self.lifecycle = "ready"
        self.metrics.set_ready(True)
        return True

    def note_watchdog_stall(self, kind: str, age_s: float, inventory) -> None:
        """The watchdog's stall callback (monitor thread): a tick passed
        the deadline.  Readiness goes (503 ``stalled``) so balancers route
        elsewhere, the stall is counted and journalled with the tick kind
        and what was in flight."""
        if self.lifecycle == "ready":
            self.lifecycle = "stalled"
            self.metrics.set_ready(False)
        self.metrics.inc_watchdog_stall()
        if self.recorder is not None:
            self.recorder.event("", "watchdog", kind=kind, age_s=round(float(age_s), 3),
                                slots=list(inventory))

    def note_watchdog_recover(self) -> None:
        """The stalled tick completed after all: ready again, unless a
        drain or shutdown landed meanwhile."""
        if self.lifecycle == "stalled":
            self.lifecycle = "ready"
            self.metrics.set_ready(True)

    def inflight(self) -> int:
        return self.gen_engine.inflight() if self.gen_engine is not None else 0

    @contextmanager
    def answering(self):
        with self._answering_lock:
            self._answering += 1
        try:
            yield
        finally:
            with self._answering_lock:
                self._answering -= 1

    def drained(self) -> bool:
        """Draining, no admitted request left, and every answer written."""
        engine_drained = self.gen_engine is None or self.gen_engine.drained()
        return self.lifecycle != "ready" and engine_drained and self._answering == 0

    def wait_drained(self, grace_s: float | None = None) -> bool:
        """Wait (at most ``grace_s``) until no admitted request is left."""
        grace = self.drain_grace_s if grace_s is None else float(grace_s)
        deadline = time.monotonic() + max(0.0, grace)
        while True:
            if self.drained():
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def terminate(self, grace_s: float | None = None) -> bool:
        """The SIGTERM path: drain (bounded by ``grace_s``), then shut
        down.  Returns whether the drain completed."""
        self.terminating = True
        self.begin_drain()
        drained = self.wait_drained(grace_s)
        if not drained:
            _log.warning("drain grace %.1fs expired with %d request(s) in flight",
                         self.drain_grace_s if grace_s is None else grace_s,
                         self.inflight())
        self.shutdown_all()
        return drained

    # -- /generate -----------------------------------------------------------

    def prepare_generate(self, body: dict):
        """Parse and validate a /generate body: (prompts, max_new, eos_id,
        sampling, stream, debug); ``sampling`` also carries the request's
        ``slo_class`` (None: the engine's default).  A quarantined prompt
        raises :class:`PoisonRequest`."""
        prompts, params = parse_generate(body)
        max_new = int(params.get("max_new_tokens", 16))
        eos_id = params.get("eos_id")
        eos_id = int(eos_id) if eos_id is not None else None
        seed = params.get("seed")
        sampling = {
            "temperature": float(params.get("temperature", 0.0)),
            "top_k": int(params.get("top_k", 0)),
            "top_p": float(params.get("top_p", 1.0)),
            "seed": int(seed) if seed is not None else None,
        }
        # Validate every prompt, and the class, before admitting any: a bad
        # sibling must not leave earlier ones generating into abandoned futures.
        slo_class = params.get("slo_class")
        if slo_class is not None:
            slo_class = str(slo_class)
            if slo_class not in SLO_CLASSES:
                raise ValueError(f"slo_class {slo_class!r} not in {SLO_CLASSES}")
        prompts = [self.engine.validate(p, max_new, **sampling) for p in prompts]
        sampling["slo_class"] = slo_class
        stream = bool(params.get("stream", False))
        if stream and len(prompts) != 1:
            raise ValueError("stream=true supports exactly one prompt")
        return prompts, max_new, eos_id, sampling, stream, bool(params.get("debug", False))

    def generate(self, body: dict, prompts, max_new, eos_id, sampling,
                 request_id: str = "", debug: bool = False,
                 trace_context: tuple[str, str] = ("", ""), headers=None,
                 model: str | None = None) -> dict:
        """Serve one non-streamed /generate.  ``headers`` carry the router's
        handoff stamp; ``model`` (a warm pool's multiplexed route) holds the
        request's estimate against that model's share until it is done."""
        def row_seed(i: int) -> int | None:
            # Distinct stream per row, reproducible from the request seed.
            base = sampling["seed"]
            return None if base is None else (base + i) % (2**63)

        # Reserve the whole request's estimate first: admitted whole or
        # shed whole, never siblings generating into abandoned futures.
        est = sum(int(p.size) + max_new for p in prompts)
        engine = self.engine
        engine.reserve_admission(est, slo_class=sampling.get("slo_class"), model=model)
        try:
            traces = [RequestTrace(request_id=request_id if len(prompts) == 1
                                   else f"{request_id}/{i}",
                                   trace_id=trace_context[0], parent_span=trace_context[1])
                      for i in range(len(prompts))]
            if headers is not None:
                _stamp_handoff(headers, traces)
            futures = [
                engine.submit(p, max_new, eos_id, **{**sampling, "seed": row_seed(i)},
                              request_id=traces[i].request_id, trace=traces[i],
                              est_reserved=True)
                for i, p in enumerate(prompts)
            ]
            wait(futures)
            outs = [f.result() for f in futures]
        finally:
            if model is not None:
                engine.release_model_admission(model, est)
        self.note_first_token()
        summary = _timing_summary(request_id, traces)
        _log_completion(summary, 200)
        payload = {
            "model_name": self.model_name,
            "id": body.get("id", ""),
            "outputs": [
                {
                    "name": f"output_ids_{i}",
                    "datatype": "INT32",
                    "shape": [int(o.size)],
                    "data": o.tolist(),
                }
                for i, o in enumerate(outs)
            ],
        }
        if debug:
            payload["timing"] = summary
        return payload

    # -- /infer --------------------------------------------------------------

    def infer(self, body: dict) -> dict:
        inputs = parse_v2_inputs(body)
        out = self._run(inputs)
        return {"model_name": self.model_name, "id": body.get("id", ""),
                "outputs": _to_v2_outputs(out)}

    def seldon_predict(self, body: dict) -> dict:
        """Seldon protocol: ``data.ndarray`` or ``data.tensor`` as one FP32
        input ``x``; the first output back as ``data.ndarray``."""
        data = body.get("data", {})
        if "ndarray" in data:
            arr = np.asarray(data["ndarray"], dtype=np.float32)
        elif "tensor" in data:
            t = data["tensor"]
            arr = np.asarray(t["values"], np.float32).reshape(t["shape"])
        else:
            raise ValueError("data.ndarray or data.tensor required")
        if arr.ndim == 0 or arr.shape[0] == 0:
            raise ValueError(f"data needs a non-empty batch dimension, got shape {list(arr.shape)}")
        out = self._run({"x": arr})
        out_arr = np.asarray(out if not isinstance(out, tuple) else out[0])
        return {"data": {"ndarray": out_arr.tolist()}, "meta": {}}

    def _run(self, inputs: dict[str, np.ndarray]):
        """Batch 1 via the dynamic batcher, larger client batches padded to
        warmed batch buckets; both always on sequence buckets."""
        if self.predictor.validate is not None:
            self.predictor.validate(inputs)
        if self.predictor.seq_pad:
            inputs = apply_seq_pad(inputs, self.predictor.seq_pad)
        if next(iter(inputs.values())).shape[0] == 1:
            out = self.batcher.submit({k: v[0] for k, v in inputs.items()}).result()
            return _add_batch_dim(out)
        return self._predict_bucketed(inputs)

    def _predict_bucketed(self, inputs: dict[str, np.ndarray]):
        """Pad a client batch up to the nearest warmed bucket (chunking one
        larger than max_batch_size), run each chunk as a batch of its own on
        the collector thread, then slice back."""
        batch = next(iter(inputs.values())).shape[0]
        cap = self.batcher.max_batch_size
        pending = []
        for start in range(0, batch, cap):
            chunk = {k: v[start:start + cap] for k, v in inputs.items()}
            n = next(iter(chunk.values())).shape[0]
            bucket = next_bucket(n, cap)
            if bucket > n:
                chunk = {k: np.concatenate([v, np.repeat(v[-1:], bucket - n, axis=0)])
                         for k, v in chunk.items()}
            pending.append((self.batcher.submit_batch(chunk), n))
        return _concat_batches([_slice_batch(f.result(), n) for f, n in pending])

    def metadata(self) -> dict:
        p = self.predictor
        return {"name": self.model_name, "platform": "tpumlops-torch",
                "flavor": p.name, "jittable": p.jittable, "metadata": p.metadata}

    def shutdown_all(self) -> None:
        """Stop serving, then stop the engine (failing what is queued)."""
        self.lifecycle = "shutdown"
        self.metrics.set_ready(False)
        if self.telemetry is not None:
            # The kernel builds of this process stop reporting into a
            # retired server's observatory.
            from ..utils.compile_cache import detach_observatory

            detach_observatory(self.telemetry.observatory)
        self.shutdown()
        self.server_close()
        if self.batcher is not None:
            self.batcher.stop()
        elif self.engine is not None:
            self.engine.shutdown()
        if self.unit_channel is not None:
            # After the engine: no broadcast can follow the release.
            from .multihost import OP_SHUTDOWN, encode_message

            self.unit_channel.close_with(encode_message(OP_SHUTDOWN))


class _Handler(BaseHTTPRequestHandler):
    server: ModelServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access lines to logging
        _log.debug("%s - " + fmt, self.address_string(), *args)

    def _send(self, code: int, data: bytes, content_type: str,
              headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Request-Id", self._rid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _reply(self, code: int, payload: dict, headers: dict | None = None) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json", headers)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    # -- GET -----------------------------------------------------------------

    def do_GET(self):
        self._rid = request_id_from_headers(self.headers)
        srv = self.server
        url = urlsplit(self.path)
        path = url.path
        m = _MODEL_ROUTE.match(path)
        if path.startswith("/debug/"):
            self._debug(path, parse_qs(url.query))
        elif path in _LIVE_ROUTES:
            # Live through loading and draining: a replica finishing its
            # in-flight tail must not be killed.
            live = srv.lifecycle != "shutdown"
            self._reply(200 if live else 503, {"live": live, "lifecycle": srv.lifecycle})
        elif path in _READY_ROUTES or (
                m is not None and m.group(2) == "ready"
                and (m.group(1) == srv.model_name or srv.attach_fn is not None)):
            self._reply(*srv.readiness())
        elif path == "/metrics":
            self._send(200, srv.metrics.render(), CONTENT_TYPE)
        elif m is not None and m.group(2) is None and m.group(1) == srv.model_name:
            if srv.engine is None:
                self._not_attached()
            else:
                self._reply(200, srv.metadata())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _debug(self, path: str, query: dict) -> None:
        """The ``/debug/*`` reads; a ring that is off is a 404 naming its
        flag."""
        srv = self.server
        if path in ("/debug/engine", "/debug/trace"):
            if srv.recorder is None:
                self._reply(404, {"error": "flight recorder disabled; set "
                                           "spec.tpu.observability.traceRing (--trace-ring) > 0"})
                return
            fmt = (query.get("format") or ["chrome"])[0] if path == "/debug/trace" else "json"
            if fmt == "chrome":
                self._reply(200, srv.recorder.chrome_trace())
            elif fmt == "json":
                self._reply(200, srv.recorder.snapshot())
            else:
                self._reply(400, {"error": f"unknown format {fmt!r}; use chrome or json"})
        elif path == "/debug/device":
            if srv.telemetry is None:
                self._reply(404, {"error": "device telemetry disabled; set "
                                           "spec.tpu.observability.deviceTelemetry "
                                           "(--device-telemetry 1)"})
                return
            self._reply(200, srv.telemetry.snapshot())
        elif path == "/debug/timeseries":
            if srv.timeseries is None:
                self._reply(404, {"error": "timeseries ring disabled; set "
                                           "spec.tpu.observability.timeseriesRing "
                                           "(--timeseries-ring) > 0"})
                return
            self._reply(200, srv.timeseries.snapshot())
        elif path == "/debug/spans":
            from ..utils.tracing import GLOBAL_TRACER

            self._reply(200, {"spans": GLOBAL_TRACER.as_dict()})
        elif path == "/debug/ranks":
            if srv.unit_channel is None:
                self._reply(404, {"error": "not the leader of a unit of several ranks "
                                           "(--mesh-shape)"})
                return
            try:
                self._reply(200, {"ranks": srv.rank_reports()})
            except RuntimeError as e:  # the unit is shut down
                self._reply(409, {"error": str(e)})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    # -- POST ----------------------------------------------------------------

    def do_POST(self):
        self._rid = request_id_from_headers(self.headers)
        srv = self.server
        raw = self._read_body()
        if self.path == "/admin/drain":
            self._admin_drain(raw)
            return
        if self.path == "/debug/profile":
            self._profile(raw)
            return
        if self.path == "/admin/attach":
            self._admin_attach(raw)
            return
        if self.path == "/admin/kv/export":
            self._kv_export(raw)
            return
        if self.path == "/admin/kv/import":
            self._kv_import(raw)
            return
        if self.path == "/api/v1.0/feedback":
            self._feedback(raw)
            return
        if self.path == "/api/v1.0/predictions":
            if srv.engine is None:
                self._not_attached()
            elif srv.serves != "infer":
                self._reply(404, {"error": f"no route {self.path} for this model "
                                           f"(it serves /{srv.serves})"})
            else:
                with srv.answering():
                    self._answer(raw, seldon=True)
            return
        m = _MODEL_ROUTE.match(self.path)
        # A warm pool answers any model name (the multiplexer's ids).
        known = m is not None and (m.group(1) == srv.model_name or srv.attach_fn is not None)
        if known and m.group(2) in ("generate", "infer") and srv.engine is None:
            self._not_attached()
            return
        if m is None or m.group(2) != srv.serves:
            self._reply(404, {"error": f"no route {self.path} for this model "
                                       f"(it serves /{srv.serves})"})
            return
        if not known:
            self._reply(404, {"error": f"unknown model {m.group(1)!r}"})
            return
        with srv.answering():
            self._answer(raw, model=m.group(1) if m.group(1) != srv.model_name else None)

    def _not_attached(self) -> None:
        """A warm-pool replica with no model: a typed 503 its clients retry."""
        self._reply(503, {"error": "no model attached to this warm-pool replica",
                          "reason": "warm_pool_empty", "retry_after_s": 5,
                          "request_id": self._rid}, {"Retry-After": "5"})

    def _answer(self, raw: bytes, model: str | None = None, seldon: bool = False) -> None:
        srv = self.server
        t0 = time.perf_counter()
        code, payload, headers = 200, None, None
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            if seldon:
                payload = srv.seldon_predict(body)
            elif srv.serves == "infer":
                payload = srv.infer(body)
            else:
                prompts, max_new, eos_id, sampling, stream, debug = srv.prepare_generate(body)
                context = trace_context_from_headers(self.headers)
                if stream:
                    code = self._stream(prompts[0], max_new, eos_id, sampling, context)
                    return
                payload = srv.generate(body, prompts, max_new, eos_id, sampling,
                                       request_id=self._rid, debug=debug,
                                       trace_context=context, headers=self.headers,
                                       model=model)
        except EngineOverloaded as e:
            code, headers = 429, {"Retry-After": str(e.retry_after_s)}
            payload = {"error": str(e), "reason": e.reason,
                       "retry_after_s": e.retry_after_s, "request_id": self._rid}
            # A class shed names its class: best-effort shedding is not overload.
            if e.slo_class is not None:
                payload["slo_class"] = e.slo_class
        except PoisonRequest as e:
            # The prompt itself crashes admission, here and on any replica:
            # unprocessable, and no Retry-After.
            code, payload = 422, {"error": str(e), "reason": "poison_quarantined",
                                  "fingerprint": e.fingerprint, "crashes": e.crashes,
                                  "request_id": self._rid}
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            code, payload = 400, {"error": str(e), "request_id": self._rid}
        except EngineShutdown as e:
            code, payload = 503, {"error": str(e), "request_id": self._rid}
        except Exception as e:
            _log.exception("%s failed", srv.serves)
            code, payload = 500, {"error": str(e), "request_id": self._rid}
        finally:
            srv.metrics.observe_request(time.perf_counter() - t0, code=code)
        self._reply(code, payload, headers)

    def _feedback(self, raw: bytes) -> None:
        """Seldon's feedback API: the reward is summed into
        ``tpumlops_feedback_reward_total`` and the post counted under
        ``service="feedback"``; feedback is reward signal, not inference, so
        nothing runs on the model (and a warm pool with none answers too)."""
        srv = self.server
        t0 = time.perf_counter()
        code, payload = 200, {"meta": {}}
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("feedback body must be a JSON object")
            reward = body.get("reward", 0.0)
            if not isinstance(reward, (int, float)):
                raise ValueError("reward must be a number")
            srv.metrics.observe_feedback_reward(float(reward))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            code, payload = 400, {"error": str(e), "request_id": self._rid}
        except Exception as e:
            _log.exception("feedback handling failed")
            code, payload = 500, {"error": str(e), "request_id": self._rid}
        finally:
            srv.metrics.observe_request(time.perf_counter() - t0, code=code, service="feedback")
        self._reply(code, payload)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _event(self, payload: dict, event: str | None = None) -> None:
        head = f"event: {event}\n" if event else ""
        self._chunk(f"{head}data: {json.dumps(payload)}\n\n".encode())

    def _stream(self, prompt, max_new, eos_id, sampling, context=("", "")) -> int:
        """Serve one prompt as Server-Sent Events over a chunked body;
        returns the code the gate's metric records.  Shedding raises
        before the status line is sent."""
        srv = self.server
        tokens: queue.Queue = queue.Queue()
        trace = RequestTrace(request_id=self._rid, trace_id=context[0], parent_span=context[1])
        _stamp_handoff(self.headers, [trace])
        fut = srv.engine.submit(prompt, max_new, eos_id, **sampling,
                                on_token=tokens.put, request_id=self._rid, trace=trace)
        fut.add_done_callback(lambda f: tokens.put(None))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Request-Id", self._rid)
        self.end_headers()
        code, n = 200, 0
        try:
            while True:
                tok = tokens.get()
                if tok is None:
                    break
                if n == 0:
                    srv.note_first_token()
                self._event({"index": n, "token": int(tok)})
                n += 1
            if fut.cancelled():
                code = 499
                self._sse_error("cancelled", "generation cancelled")
            elif fut.exception() is not None:
                code = 500
                self._sse_error("engine_failed", str(fut.exception()))
            else:
                out = fut.result()
                self._event({"done": True, "output_ids": out.tolist()})
            self._chunk(b"")
        except OSError:
            # The client went away: cancel, so the slot frees at the
            # next scheduler tick instead of decoding for nobody.
            fut.cancel()
            code = 499
            self.close_connection = True
        except Exception as e:
            _log.exception("stream failed mid-generation")
            fut.cancel()
            code = 500
            try:
                self._sse_error("stream_failed", str(e))
                self._chunk(b"")
            except Exception:
                self.close_connection = True
        # A cancel frees the slot only at the next tick: the trace is
        # finished here (the engine's later finish is a no-op), so a 499
        # or 500 line never reads "in-flight".
        if code != 200:
            trace.finish("cancelled" if code == 499 else "error")
        _log_completion(_timing_summary(self._rid, [trace]), code)
        return code

    def _sse_error(self, reason: str, message: str) -> None:
        """The terminal ``error`` event: a stream that ends without its
        result says so, with the request id and a typed reason."""
        self._event({"done": True, "error": message, "request_id": self._rid,
                     "reason": reason}, event="error")

    def _profile(self, raw: bytes) -> None:
        """``POST /debug/profile {"duration_s": s}``: a ``torch.profiler``
        capture of the card's activity (``utils/tracing.torch_profile``) for
        ``s`` seconds, clamped to [0.1, 60], into a new directory under
        :func:`profile_root` (no caller-chosen path: the endpoint is
        unauthenticated).  One capture at a time (409 otherwise); the
        newest ``PROFILE_KEEP_DIRS`` captures are kept.  The profiler starts
        and stops between two of the engine's ticks."""
        from ..utils.tracing import torch_profile

        srv = self.server
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            duration = float(body.get("duration_s", 3.0))
            if not math.isfinite(duration):
                raise ValueError(f"duration_s must be finite, got {duration}")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        duration = min(max(duration, 0.1), 60.0)
        root = profile_root()
        out_dir = os.path.join(root, f"{srv.model_name}-{int(time.time())}")
        if not srv._profile_lock.acquire(blocking=False):
            self._reply(409, {"error": "a profile capture is already running"})
            return
        engine = srv.gen_engine
        hold = engine.between_ticks if engine is not None else contextlib.nullcontext
        try:
            with torch_profile(out_dir, hold):
                time.sleep(duration)
            evicted = _gc_profile_dirs(root)
        except Exception as e:
            _log.exception("profile capture failed")
            self._reply(500, {"error": str(e)})
            return
        finally:
            srv._profile_lock.release()
        self._reply(200, {"trace_dir": out_dir, "duration_s": duration, "evicted": evicted})

    def _admin_attach(self, raw: bytes) -> None:
        srv = self.server
        if srv.attach_fn is None:
            self._reply(400, {"error": "not a warm-pool server (boot with --warm-pool 1 to "
                                       "attach models at runtime)"})
            return
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("attach body must be a JSON object")
            model_uri = body.get("model_uri")
            if not model_uri or not isinstance(model_uri, str):
                raise ValueError('attach requires "model_uri"')
            replace = bool(body.get("replace", False))
            wake = body.get("wake_start_wall")
            wake = float(wake) if wake is not None else None
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        self._reply(*srv.attach(model_uri, replace, wake))

    def _kv_engine(self):
        """The engine the KV routes work on, or None with the error sent: a
        warm pool with no model (503), no causal LM (400), or no prefix
        cache (409 ``prefix_cache_disabled``: the handoff unit is its chunk)."""
        srv = self.server
        if srv.engine is None:
            self._not_attached()
            return None
        engine = srv.gen_engine
        if engine is None:
            self._reply(400, {"error": f"model {srv.model_name} is not a causal LM"})
            return None
        if engine._prefix_cache is None:
            self._reply(409, {"error": "KV handoff requires the radix prefix cache; enable "
                                       "spec.tpu.prefixCache (--prefix-cache 1)",
                              "reason": "prefix_cache_disabled"})
            return None
        return engine

    def _kv_export(self, raw: bytes) -> None:
        """``POST /admin/kv/export``: the prompt's whole-chunk prefix K/V as
        one handoff blob; a prefix not in the radix cache yet is prefilled
        first (one ``max_new_tokens=1`` admission, whose write-backs land
        the chunks), then read again."""
        from . import kv_transfer

        engine = self._kv_engine()
        if engine is None:
            return
        srv = self.server
        t0 = time.perf_counter()
        code, payload, headers = 200, None, None
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("export body must be a JSON object")
            prompt_ids = body.get("prompt_ids")
            if prompt_ids is None:
                raise ValueError('export requires "prompt_ids"')
            if prompt_ids and not np.isscalar(prompt_ids[0]):
                if len(prompt_ids) != 1:
                    raise ValueError("export supports exactly one prompt sequence")
                prompt_ids = prompt_ids[0]
            prompt = engine.validate(prompt_ids, 1)
            covered = engine.exportable_prefix_tokens(prompt)
            if covered <= 0:
                code, payload = 400, {"error": f"prompt of {prompt.size} tokens has no "
                                               "whole-chunk prefix to export",
                                      "reason": "prompt_too_short"}
                return
            matched, chunks = engine.export_prefix_kv(prompt)
            if matched < covered:
                trace_id, span = trace_context_from_headers(self.headers)
                trace = RequestTrace(request_id=self._rid, trace_id=trace_id,
                                     parent_span=span)
                engine.submit(prompt, 1, request_id=self._rid, trace=trace).result()
                matched, chunks = engine.export_prefix_kv(prompt)
            if matched <= 0 or not chunks:
                code, headers = 503, {"Retry-After": "1"}
                payload = {"error": "prefix did not land in the radix cache (budget too "
                                    "small for the prompt?)",
                           "reason": "export_unavailable", "retry_after_s": 1}
                return
            blob = kv_transfer.serialize_chunks(engine._prefill_chunk_size, prompt, chunks)
            self._send(200, blob, "application/octet-stream",
                       {"X-Tpumlops-Kv-Tokens": str(matched)})
        except EngineOverloaded as e:
            code, headers = 429, {"Retry-After": str(e.retry_after_s)}
            payload = {"error": str(e), "reason": e.reason, "retry_after_s": e.retry_after_s}
            if e.slo_class is not None:
                payload["slo_class"] = e.slo_class
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            code, payload = 400, {"error": str(e)}
        except Exception as e:
            _log.exception("kv export failed")
            code, payload = 500, {"error": str(e)}
        finally:
            srv.metrics.observe_request(time.perf_counter() - t0, code=code,
                                        service="kv-export")
            if payload is not None:
                self._reply(code, payload, headers)

    def _kv_import(self, raw: bytes) -> None:
        """``POST /admin/kv/import``: insert a handoff blob's chunks into the
        radix cache.  Its geometry and dtype must be this engine's exactly:
        a mismatch is a 409, never a cast."""
        from . import kv_transfer

        engine = self._kv_engine()
        if engine is None:
            return
        srv = self.server
        t0 = time.perf_counter()
        code = 200
        try:
            try:
                header, chunks = kv_transfer.deserialize_chunks(
                    raw, pin_memory=engine._device.type == "cuda")
            except kv_transfer.KvTransferError as e:
                code, payload = 400, {"error": str(e), "reason": "bad_blob"}
                return
            cfg, C = engine._cfg, engine._prefill_chunk_size
            expected = [cfg.num_layers, 1, C, cfg.num_kv_heads, cfg.head_dim]
            if int(header["chunk_tokens"]) != C or list(header["kv_shape"]) != expected:
                code, payload = 409, {
                    "error": f"handoff geometry {header['kv_shape']} @ "
                             f"{header['chunk_tokens']} tokens does not match this engine "
                             f"({expected} @ {C})",
                    "reason": "geometry_mismatch"}
                return
            want = kv_transfer.dtype_name(engine._dtype)
            if header["dtype"] != want:
                code, payload = 409, {"error": f"handoff dtype {header['dtype']} does not "
                                               f"match engine dtype {want}",
                                      "reason": "dtype_mismatch"}
                return
            imported = engine.import_prefix_kv(kv_transfer.chunk_token_ids(header), chunks)
            payload = {"imported_tokens": int(imported), "chunks": len(chunks)}
        except (ValueError, KeyError, TypeError) as e:
            code, payload = 400, {"error": str(e)}
        except Exception as e:
            _log.exception("kv import failed")
            code, payload = 500, {"error": str(e)}
        finally:
            srv.metrics.observe_request(time.perf_counter() - t0, code=code,
                                        service="kv-import")
            self._reply(code, payload)

    def _admin_drain(self, raw: bytes) -> None:
        srv = self.server
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("drain body must be a JSON object")
            grace = float(body.get("grace_s", srv.drain_grace_s))
            if not (0.0 <= grace <= 3600.0):
                raise ValueError(f"grace_s must be in [0, 3600], got {grace}")
            cancel = bool(body.get("cancel", False))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e), "request_id": self._rid})
            return
        if cancel:
            restored = srv.cancel_drain()
            self._reply(200 if restored else 409,
                        {"lifecycle": srv.lifecycle, "cancelled": restored})
            return
        srv.begin_drain()
        drained = srv.wait_drained(grace)
        self._reply(200, {"lifecycle": srv.lifecycle, "drained": drained,
                          "inFlight": srv.inflight()})


def build_server(predictor, config: ServerConfig, warmup: bool = True,
                 load_stats: dict | None = None,
                 boot_wall: float | None = None, transport=None) -> ModelServer:
    """Engine + bound HTTP server for a loaded predictor; the engine is
    started (and warmed) and the server reads ready.  Call
    ``serve_forever()`` (on any thread) and ``shutdown_all()`` to stop.
    ``transport`` (a leader's ``multihost`` transport): the engine
    broadcasts every device op on a ``UnitChannel`` over it, and
    ``shutdown_all`` releases the followers.

    ``load_stats`` (the loader's stage seconds) and ``boot_wall`` (the
    process's start, ``time.time()``) feed the model-load and cold-start
    gauges.

    ``config.warm_pool``: ``predictor`` is None and the server boots with no
    weights (lifecycle ``warm-pool``); ``warmup`` prewarms from the boot
    model's snapshot (:func:`prewarm_from_snapshot`), and ``POST
    /admin/attach`` loads a model through ``load_predictor`` with the
    server's quantize mode, device, type and snapshot directory."""
    anchor = time.time() if boot_wall is None else boot_wall
    telemetry = None
    if config.device_telemetry:
        from .device_telemetry import DeviceTelemetry

        telemetry = DeviceTelemetry()
    metrics = ServerMetrics(
        deployment_name=config.deployment_name or config.model_name,
        predictor_name=config.predictor_name,
        namespace=config.namespace,
        device_telemetry=telemetry is not None,
    )
    if telemetry is not None:
        telemetry.bind_metrics(metrics)
    recorder = None
    if config.trace_ring > 0:
        from .flight_recorder import FlightRecorder

        recorder = FlightRecorder(config.trace_ring)
    timeseries = None
    if config.timeseries_ring > 0:
        from .timeseries import TimeseriesRing

        timeseries = TimeseriesRing(config.timeseries_ring)
        if telemetry is not None:
            timeseries.bind_telemetry(telemetry)  # MFU / bandwidth a bucket
    watchdog = None
    if config.watchdog_deadline_s > 0:
        from .watchdog import EngineWatchdog

        watchdog = EngineWatchdog(deadline_s=config.watchdog_deadline_s,
                                  grace_s=config.watchdog_grace_s,
                                  on_age=metrics.set_watchdog_tick_age)
    metrics.set_ready(False)
    unit_channel = None
    if transport is not None:
        from .multihost import UnitChannel

        unit_channel = UnitChannel(transport)
    attach_fn = None
    if config.warm_pool:
        if predictor is not None:
            raise ValueError("a warm-pool server boots with no predictor")

        def attach_fn(model_uri: str, stats: dict):
            if unit_channel is None:
                return _load_model(config, model_uri, stats)
            # A unit op: every rank loads its part, and the ranks agree that
            # each succeeded (else every rank stays in the warm pool).
            from .multihost import OP_ATTACH, encode_message

            return unit_channel.run(
                encode_message(OP_ATTACH, {"model_uri": model_uri}),
                lambda: _agreed(lambda: _load_model(config, model_uri, stats)))
    srv = ModelServer((config.host, config.port), None, config.model_name, metrics,
                      predictor=None, drain_grace_s=config.drain_grace_s,
                      cold_start_anchor=anchor, recorder=recorder, telemetry=telemetry,
                      timeseries=timeseries, config=config, watchdog=watchdog,
                      attach_fn=attach_fn, unit_channel=unit_channel)
    if watchdog is not None:
        # Wired before an engine starts (and arms it): a stall must never
        # fire into unassigned hooks.
        watchdog.on_stall = srv.note_watchdog_stall
        watchdog.on_recover = srv.note_watchdog_recover
    if config.warm_pool:
        if warmup:
            prewarm_from_snapshot(config)
        srv.lifecycle = "warm-pool"
        return srv
    if load_stats:
        metrics.observe_model_load(load_stats)
        restored = load_stats.get("restore_s") is not None
        metrics.observe_cold_start("restore" if restored else "load",
                                   load_stats.get("restore_s") or load_stats.get("wall_s") or 0.0)
    t_warm = time.time()
    try:
        srv.install(predictor, warmup=warmup)
    except Exception:
        srv.server_close()
        raise
    metrics.observe_cold_start("compile", time.time() - t_warm)
    metrics.observe_cold_start("total", time.time() - anchor)
    srv.lifecycle = "ready"
    metrics.set_ready(True)
    if timeseries is not None:
        timeseries.mark("warmup")  # samples before it are start-up, not serving
    return srv


def free_device_memory(reset_peak: bool = False) -> None:
    """Collect the dropped model's reference cycles and return the
    allocator's free blocks to the card (``reset_peak``: the peak
    allocation restarts from what is held)."""
    gc.collect()  # an engine's reference cycles hold device memory
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        if reset_peak:
            torch.cuda.reset_peak_memory_stats()


def _load_model(config: ServerConfig, model_uri: str, stats: dict | None = None):
    """``model_uri`` loaded on this rank with the server's quantize mode,
    device, type, snapshot directory and mesh (``stats``: the loader's
    stage seconds)."""
    from .loader import load_predictor

    return load_predictor(model_uri, quantize=config.quantize, device=config.device,
                          dtype=_DTYPES[config.dtype], load_stats=stats,
                          snapshot_dir=config.snapshot_dir or None,
                          mesh_shape=config.mesh_shape)


def _agreed(fn):
    """``fn()`` on this rank, then the unit's agreement (every rank joins it)
    that it succeeded on every rank; raises on every rank when it failed on
    any (this rank's own error where it was this rank's)."""
    from .loader import ModelLoadError, _agree

    try:
        out, err = fn(), None
    except Exception as e:
        out, err = None, e
    if not _agree(err is None):
        raise err or ModelLoadError("the attach failed on another rank of the unit")
    return out


def follower_engines(predictor, config: ServerConfig, metrics: ServerMetrics):
    """A follower's ``(engine, gen_engine)`` for ``predictor``: a
    never-started ``GenerationEngine`` for a causal LM, else an
    ``InferenceEngine`` (the replay of the leader's ``OP_PREDICT``)."""
    if predictor.causal_lm is not None:
        return None, make_gen_engine(predictor, config, metrics)
    return InferenceEngine(predictor, max_batch_size=config.max_batch_size), None


def prewarm_from_snapshot(config: ServerConfig) -> float | None:
    """A warm pool's start-up work, from the boot model's snapshot manifest:
    the kernel build, then one eager forward on a zero tree of the
    manifest's geometry (the dtypes and shapes the real weights will have),
    which loads the kernel libraries and the cuBLAS handles; then the zero
    tree is released, so the replica holds no weights.  The counterpart of
    the reference's compile sweep: an eager port compiles nothing more, and
    CUDA graphs are captured at attach, on the attached weights.
    Best-effort; returns the seconds, or None when there is no snapshot to
    read a geometry from.  On a unit every rank runs it together, on its
    own blocks of the geometry (the Llama rule table's cut of each leaf,
    the forward's collectives included), once the ranks agree that each
    can."""
    from ..models import llama
    from ..models.partition import LLAMA_PARTITION_RULES, mesh_device_count
    from ..models.registry import BUILDERS
    from ..parallel import match_partition_rules
    from ..parallel.sharding import shard_shape
    from . import snapshot as _snap
    from .generation import resolve_device
    from .loader import _agree, _build_config, _mesh_for_flavor, _unflatten

    if not config.snapshot_dir:
        return None
    unit = mesh_device_count(config.mesh_shape) > 1
    spath = _snap.snapshot_path_for(config.snapshot_dir, config.model_uri)
    manifest = None
    if (spath / _snap.MANIFEST_NAME).exists():
        try:
            manifest = _snap.read_manifest(spath)
            if not unit:
                _snap.check_placeable(manifest)
            if manifest["flavor"] != "llama-generate":
                manifest = None
        except Exception as e:
            _log.warning("warm-pool prewarm skipped: %s", e)
            manifest = None
    if unit and not _agree(manifest is not None):
        manifest = None
    if manifest is None:
        _log.info("warm-pool prewarm skipped: no Llama snapshot at %s yet", spath)
        return None
    t0 = time.perf_counter()
    try:
        dev = resolve_device(config.device)
        if dev.type == "cuda":
            from ..ops import _build

            _build.build()
        cfg = _build_config(manifest["flavor"], manifest.get("config", {}))
        mesh = _mesh_for_flavor(manifest["flavor"], cfg, config.mesh_shape) if unit else None
        shapes = {leaf["key"]: torch.empty(leaf["shape"], device="meta")
                  for leaf in manifest["leaves"]}
        if mesh is not None:  # this rank's block of each leaf
            specs = match_partition_rules(
                LLAMA_PARTITION_RULES, {k.replace("|", "/"): v for k, v in shapes.items()})
            shapes = {k: torch.empty(shard_shape(v.shape, specs[k.replace("|", "/")],
                                                 mesh.shape), device="meta")
                      for k, v in shapes.items()}
        dtypes = {leaf["key"]: _snap.TORCH_DTYPES[leaf["dtype"]] for leaf in manifest["leaves"]}
        flat = {k: torch.zeros(v.shape, dtype=dtypes[k], device=dev) for k, v in shapes.items()}
        pred = BUILDERS[manifest["flavor"]](_unflatten(flat), cfg=cfg,
                                            dtype=_DTYPES[config.dtype], mesh=mesh)
        del flat
        prompt = torch.zeros((1, min(16, cfg.max_seq - 1)), dtype=torch.int64, device=dev)
        llama.generate_greedy(pred.causal_lm["params"], prompt, 1, cfg, _DTYPES[config.dtype],
                              *(() if mesh is None else (mesh,)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        del pred
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        _log.info("warm-pool prewarm: kernels built and one forward at the snapshot's "
                  "geometry in %.1fs (zero tree released)", wall)
        return wall
    except Exception as e:
        _log.warning("warm-pool prewarm failed (attach still works): %s", e)
        return None


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve a native or HF artifact: a Llama over /generate or a "
                    "classifier over /v2/models/{name}/infer.")
    ap.add_argument("--model-uri", required=True)
    ap.add_argument("--model-name", default="model")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--quantize", default="none", choices=["none", "int8", "int8kv"])
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill size (0 or unset = whole-prompt)")
    ap.add_argument("--prefill-batch", type=int, default=1,
                    help="concurrent admissions whose next prompt chunks batch into ONE "
                         "prefill forward a tick (1 = single-admission pipeline; > 1 needs "
                         "--prefill-chunk or --prefix-cache)")
    ap.add_argument("--prefill-token-budget", type=int, default=0,
                    help="prompt tokens prefilled a tick, Sarathi-style (0 = uncapped); "
                         "bounds decode-cadence jitter under long-prompt bursts")
    ap.add_argument("--sp-prefill-threshold", type=int, default=1024,
                    help="prompt length at or over which a cold prompt (no cached prefix) "
                         "prefills in one sequence-parallel ring pass; effective only when "
                         "--mesh-shape carries sp > 1")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode iterations fused into ONE dispatch a tick (a CUDA graph "
                         "captured at startup, on-device sampling and EOS latch, lag-1 token "
                         "readback; engages only when no admissions or drafts are pending). "
                         "1 = the single-step tick; max 16")
    ap.add_argument("--unified-step", type=int, default=0,
                    help="1: the unified ragged super-step engine: ONE dispatch a tick "
                         "covers packed-prefill chunks, fused-K decode and speculative "
                         "verify through per-row roles (a CUDA graph per window bucket and "
                         "token rule); 0 (default) keeps the split engine")
    ap.add_argument("--slo-class", default="",
                    help="default SLO class for requests that don't carry one "
                         "(interactive | batch | best-effort); arms the priority "
                         "admission queues: higher classes drain first and lower "
                         "classes shed at a fraction of the admission budget")
    ap.add_argument("--preemption", type=int, default=0,
                    help="1: a waiting higher-class request may evict a lower-class "
                         "slot at a tick boundary (KV parked in the prefix cache, "
                         "restored on re-admission with no lost work); requires "
                         "--prefix-cache 1")
    ap.add_argument("--max-batch-size", type=int, default=32)
    ap.add_argument("--max-batch-delay-ms", type=float, default=5.0)
    ap.add_argument("--admission-queue-budget", type=int, default=0,
                    help="estimated-token bound (prompt + max_new) on queued-but-"
                         "unadmitted generation work; beyond it /generate sheds "
                         "with 429 + Retry-After. 0 = unbounded")
    ap.add_argument("--drain-grace-seconds", type=float, default=20.0,
                    help="seconds SIGTERM and POST /admin/drain wait for in-flight "
                         "requests (streams included) to finish after admissions "
                         "stop, before teardown")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="1 enables the radix prefix KV cache (shared prompt prefixes "
                         "prefill once and are copied thereafter)")
    ap.add_argument("--prefix-cache-budget-mb", type=int, default=256,
                    help="host-memory byte budget for cached prefix K/V (LRU eviction)")
    ap.add_argument("--prefix-cache-chunk", type=int, default=0,
                    help="prefix reuse unit in tokens (0 = follow --prefill-chunk, or "
                         "64 when that is unset too); an explicit mismatch with "
                         "--prefill-chunk is rejected at startup")
    ap.add_argument("--prefix-cache-l2-budget-mb", type=int, default=0,
                    help="second-tier host-RAM pool for evicted prefix chunks (LRU "
                         "under this budget, promoted back on a radix-walk miss); 0 "
                         "= single tier")
    ap.add_argument("--speculative", type=int, default=0,
                    help="1 enables self-speculative n-gram decoding (draft from the "
                         "sequence's own history, verify k+1 positions per forward; "
                         "greedy-exact output)")
    ap.add_argument("--speculative-draft-tokens", type=int, default=4,
                    help="max draft tokens per slot per verify tick")
    ap.add_argument("--speculative-ngram-min", type=int, default=1,
                    help="shortest history suffix the n-gram drafter may match")
    ap.add_argument("--speculative-ngram-max", type=int, default=4,
                    help="longest history suffix tried first")
    ap.add_argument("--speculative-adaptive", type=int, default=1,
                    help="1: per-slot draft length halves on consecutive zero-accept "
                         "verifies and regrows on success; 0: fixed draft length")
    ap.add_argument("--trace-ring", type=int, default=0,
                    help="engine flight-recorder ring size (ticks/events/requests kept in "
                         "memory, served at /debug/engine and /debug/trace); 0 disables "
                         "recording entirely (the default)")
    ap.add_argument("--timeseries-ring", type=int, default=0,
                    help="per-second serving time-series ring size (seconds of history: "
                         "tick-wall quantiles, ITL, queue depth, MFU/HBM bandwidth, "
                         "shed/poison counts; served at /debug/timeseries); 0 disables it")
    ap.add_argument("--device-telemetry", type=int, default=0,
                    help="1 enables the device telemetry layer: the HBM ledger (GET "
                         "/debug/device, tpumlops_device_hbm_bytes), the compile observatory "
                         "(kernel builds and CUDA graph captures, tpumlops_compile_*) and "
                         "per-tick MFU/HBM-bandwidth gauges and recorder fields")
    ap.add_argument("--watchdog-deadline-s", type=float, default=0.0,
                    help="scheduler-tick watchdog deadline: a dispatch blocking past this "
                         "flips /readyz unready and journals a watchdog event "
                         "(tpumlops_engine_watchdog_stalls_total); armed after the graph "
                         "capture at start.  0 (default) disables the monitor")
    ap.add_argument("--watchdog-grace-s", type=float, default=30.0,
                    help="grace past the watchdog deadline before the process exits "
                         "non-zero so Kubernetes restarts the pod")
    ap.add_argument("--compile-cache-dir", default="",
                    help="node-local directory of the built CUDA kernels (a library "
                         "already there loads without nvcc); empty = build/torch_kernels/ "
                         "beside the package")
    ap.add_argument("--fleet-role", default="unified", choices=list(FLEET_ROLES),
                    help="disaggregated-fleet role of this replica (advisory: named on "
                         "/readyz; the router's role table decides who exports and who "
                         "imports KV); prefill and decode need --prefix-cache 1")
    ap.add_argument("--snapshot-dir", default="",
                    help="weight snapshot directory: the served (post-quantize) tree is "
                         "baked here after the first cold load and restored on later boots "
                         "and attaches with no transform work; empty disables")
    ap.add_argument("--warm-pool", type=int, default=0,
                    help="1 boots a warm-pool replica: no weights, the kernels built and "
                         "loaded from the --model-uri snapshot's geometry, POST /admin/attach "
                         "loads a model on demand; requires --snapshot-dir")
    ap.add_argument("--drain-s", type=float, default=3.0,
                    help="seconds to keep admitting, NotReady, after SIGTERM before the "
                         "drain begins, so requests still routed here during the endpoint "
                         "lag are served")
    ap.add_argument("--metrics-port", type=int, default=6000,
                    help="a second listener serving /metrics only (the manifest's metrics "
                         "port); 0 disables it")
    ap.add_argument("--log-format", default="text", choices=["text", "json"],
                    help="json: one JSON object a log line, the request completion lines "
                         "with their request_id")
    ap.add_argument("--predictor-name", default="v1")
    ap.add_argument("--deployment-name", default="")
    ap.add_argument("--namespace", default="default")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; the CPU only when named)")
    ap.add_argument("--mesh-shape", default='{"dp": 1, "tp": 1}',
                    help="spec.tpu.meshShape as JSON: a mesh of several ranks runs one "
                         "process a rank, formed from JAX_COORDINATOR_ADDRESS, "
                         "JAX_NUM_PROCESSES and JAX_PROCESS_ID")
    return ap


def config_from_args(args: argparse.Namespace) -> ServerConfig:
    """The parsed command line as a :class:`ServerConfig`; bad feature
    values raise ``ValueError`` here, before any model loads."""
    return ServerConfig(
        model_name=args.model_name, host=args.host, port=args.port,
        dtype=args.dtype, quantize=args.quantize, max_slots=args.max_slots,
        prefill_chunk=args.prefill_chunk or None, device=args.device,
        prefill_batch=args.prefill_batch, prefill_token_budget=args.prefill_token_budget,
        decode_steps=args.decode_steps, unified_step=bool(args.unified_step),
        slo_class=args.slo_class or None, preemption=bool(args.preemption),
        max_batch_size=args.max_batch_size, max_batch_delay_ms=args.max_batch_delay_ms,
        admission_queue_budget=args.admission_queue_budget,
        drain_grace_s=args.drain_grace_seconds,
        predictor_name=args.predictor_name, deployment_name=args.deployment_name,
        namespace=args.namespace,
        prefix_cache=bool(args.prefix_cache),
        prefix_cache_budget_mb=args.prefix_cache_budget_mb,
        prefix_cache_chunk=args.prefix_cache_chunk or None,
        prefix_cache_l2_budget_mb=args.prefix_cache_l2_budget_mb,
        speculative=bool(args.speculative),
        speculative_draft_tokens=args.speculative_draft_tokens,
        speculative_ngram_min=args.speculative_ngram_min,
        speculative_ngram_max=args.speculative_ngram_max,
        speculative_adaptive=bool(args.speculative_adaptive),
        trace_ring=args.trace_ring, timeseries_ring=args.timeseries_ring,
        device_telemetry=bool(args.device_telemetry),
        watchdog_deadline_s=args.watchdog_deadline_s,
        watchdog_grace_s=args.watchdog_grace_s,
        fleet_role=args.fleet_role, snapshot_dir=args.snapshot_dir,
        warm_pool=bool(args.warm_pool), model_uri=args.model_uri,
        mesh_shape=_mesh_arg(args.mesh_shape),
        sp_prefill_threshold=args.sp_prefill_threshold,
    )


def _mesh_arg(text: str) -> dict:
    try:
        value = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"--mesh-shape must be a JSON object, got {text!r}: {e}") from None
    if not isinstance(value, dict):
        raise ValueError(f"--mesh-shape must be a JSON object, got {text!r}")
    return value


class _MetricsHandler(BaseHTTPRequestHandler):
    """The ``--metrics-port`` listener: ``GET /metrics`` only."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        _log.debug("%s - " + fmt, self.address_string(), *args)

    def do_GET(self):
        if urlsplit(self.path).path == "/metrics":
            code, data, ctype = 200, self.server.metrics.render(), CONTENT_TYPE
        else:
            code, ctype = 404, "application/json"
            data = json.dumps({"error": f"no route {self.path} (this port serves "
                                        "/metrics only)"}).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def serve_metrics(host: str, port: int, metrics: ServerMetrics) -> ThreadingHTTPServer:
    """Start a listener for ``/metrics`` alone on a daemon thread; returns
    it (``shutdown()`` stops it)."""
    httpd = ThreadingHTTPServer((host, port), _MetricsHandler)
    httpd.daemon_threads = True
    httpd.metrics = metrics
    threading.Thread(target=httpd.serve_forever, daemon=True, name="metrics-listener").start()
    return httpd


class _FollowerHealth(BaseHTTPRequestHandler):
    """A follower's live/ready listener: ``{"role": "follower", "ok": true}``."""

    def log_message(self, fmt, *args):
        _log.debug("%s - " + fmt, self.address_string(), *args)

    def do_GET(self):
        if urlsplit(self.path).path in ("/v2/health/live", "/v2/health/ready", "/healthz",
                                        "/readyz", "/livez"):
            code, payload = 200, {"role": "follower", "ok": True}
        else:
            code, payload = 404, {"error": f"no route {self.path} on a follower"}
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def serve_follower_health(host: str, port: int) -> ThreadingHTTPServer:
    """The follower's listener on a daemon thread (the unit's shared
    readiness probe: a follower that joined the process group is ready)."""
    httpd = ThreadingHTTPServer((host, port), _FollowerHealth)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True, name="follower-health").start()
    return httpd


# A directory each server process (each rank of a unit) writes
# ``rank-<r>.json`` into as it exits (unset: none is written): its ops'
# walls, its collectives' host seconds, its kernel launches and, for a
# generation engine, its HBM ledger beside the allocator's counts
# (allocated, peak allocated, reserved).
RANK_REPORT_ENV = "TPUMLOPS_RANK_REPORT_DIR"


def write_rank_report(engine, op_stats: dict, predict_engine=None, device=None,
                      mesh_shape=None) -> Path | None:
    """This rank's :func:`rank_report` into ``$TPUMLOPS_RANK_REPORT_DIR`` (see
    ``RANK_REPORT_ENV``) as ``rank-<r>.json``; None when the variable is
    unset."""
    directory = os.environ.get(RANK_REPORT_ENV)
    if not directory:
        return None
    report = rank_report(op_stats, gen_engine=engine, predict_engine=predict_engine,
                         device=device, mesh_shape=mesh_shape)
    out = Path(directory) / f"rank-{report['rank']}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return out


def rank_report(op_stats: dict, gen_engine=None, predict_engine=None, device=None,
                mesh_shape=None) -> dict:
    """This rank's walls of each replayed op, its collectives' calls and
    host seconds, its kernel launches and, where it serves a model, its HBM
    ledger (``build_hbm_ledger`` for a generation engine,
    ``build_predict_ledger`` for a predict engine) beside the allocator's
    counts on the card (allocated, peak allocated, reserved; a weightless
    warm-pool rank reports these alone)."""
    import torch.distributed as dist

    from ..ops import flash_attention
    from ..parallel import collectives, distributed
    from .cuda_graphs import _COUNTERS
    from .device_telemetry import build_hbm_ledger, build_predict_ledger

    rank = dist.get_rank() if dist.is_initialized() else 0
    launches = {name: int(getattr(m, a)) for name, (m, a) in _COUNTERS.items()}
    launches["flash_attention_ragged"] = int(flash_attention.ragged_launches)
    launches["flash_attention_lse"] = int(flash_attention.lse_launches)
    report = {
        "rank": rank,
        "backend": distributed.backend_name(),
        "ops": {op: {"count": c, "seconds": t, "max_s": m}
                for op, (c, t, m) in sorted(op_stats.items())},
        "collectives": {op: {"calls": collectives.calls[op],
                             "seconds": collectives.seconds[op]}
                        for op in sorted(collectives.calls)},
        "launches": launches,
    }
    engine = gen_engine
    ledger = None
    if engine is not None:
        mesh = engine._mesh
        ledger = build_hbm_ledger(engine._params, engine._cfg, engine.max_slots,
                                  kv_quant=engine._kv_quant,
                                  dtype_bytes=engine._dtype.itemsize,
                                  mesh_shape=mesh.shape if mesh is not None else None,
                                  tick_rows=engine.widest_tick_rows)
        device = engine._device
        report["mesh"] = None if mesh is None else {"shape": mesh.shape, "coords": mesh.coords}
    else:
        from ..models.partition import mesh_device_count
        from ..parallel.mesh import placement

        if mesh_device_count(mesh_shape) > 1 and dist.is_initialized():
            place = placement(mesh_shape)
            report["mesh"] = {"shape": place.shape, "coords": place.coords}
        if predict_engine is not None and predict_engine.predictor.tree is not None:
            report["flavor"] = predict_engine.predictor.name
            ledger = build_predict_ledger(predict_engine.predictor,
                                          predict_engine.max_batch_size)
    if ledger is not None:
        report["ledger"] = dict(ledger.components, total=ledger.device_total())
    device = torch.device(device) if device is not None else None
    if device is not None:
        report["device"] = str(device)
        if device.type == "cuda":
            # Now, the peak since the process began (or since the last
            # release on a unit) and what the caching allocator holds.
            report["memory_allocated"] = int(torch.cuda.memory_allocated(device))
            report["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(device))
            report["memory_reserved"] = int(torch.cuda.memory_reserved(device))
    return report


def form_unit(config: ServerConfig):
    """Join the process group of a mesh of several ranks (one process a
    rank, from ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``); returns ``(transport, rank device, local rank)``, or
    ``(None, config.device, 0)`` for one rank.  A rank takes
    ``cuda:(local_rank % device_count)`` (``parallel.distributed.local_rank``:
    ``LOCAL_RANK``, else the rank's place in its host's block of
    ``LOCAL_WORLD_SIZE`` ranks, all on one host when unset), or the CPU when
    ``--device cpu``."""
    world = mesh_device_count(config.mesh_shape)
    if world <= 1:
        return None, config.device, 0
    import torch.distributed as dist

    from ..parallel import distributed
    from .multihost import TorchDistTransport

    local_world = distributed.local_world_size(world)
    if config.warm_pool and local_world < world:
        # The reference serves the warm pool where one process holds the
        # unit; here that is a unit whose ranks share one host.
        raise ValueError(
            f"--warm-pool is single-host only (a multi-host unit cannot attach weights "
            f"after its process group formed): meshShape {config.mesh_shape} spans "
            f"{world} ranks, {local_world} on this host "
            "(LOCAL_WORLD_SIZE)")
    dev_type = torch.device(config.device).type if config.device else "cuda"
    if dev_type == "cuda" and not os.environ.get(SHARE_CARD_ENV):
        # Before the rendezvous: ranks that outnumber the cards would share
        # them in silence (and the backend would fall back to gloo).
        cards = torch.cuda.device_count()
        if cards < local_world:
            raise ValueError(
                f"{local_world} ranks on this host (LOCAL_WORLD_SIZE) but {cards} cards: one "
                "rank a card, unless the launcher's --ranks-share-card says they share")
    if not distributed.maybe_initialize_distributed(device_type=dev_type):
        raise ValueError(
            f"meshShape {config.mesh_shape} spans {world} ranks: set JAX_COORDINATOR_ADDRESS "
            "(host:port of rank 0), JAX_NUM_PROCESSES and JAX_PROCESS_ID"
        )
    if dist.get_world_size() != world:
        raise ValueError(f"meshShape {config.mesh_shape} spans {world} ranks, but the "
                         f"process group has {dist.get_world_size()}")
    rank = dist.get_rank()
    local_rank = distributed.local_rank(rank, world)
    device = distributed.rank_device(dev_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _log.info("rank %d of %d (local rank %d) on %s; model collectives over %s",
              rank, world, local_rank, device, distributed.backend_name())
    return TorchDistTransport(), str(device), local_rank


def run_follower(config: ServerConfig, transport, local_rank: int) -> int:
    """A follower rank: load its block of the model, build the same engine
    (a never-started ``GenerationEngine``, or an ``InferenceEngine`` for a
    predict flavor) and repeat the leader's ops until it releases the unit.
    A follower of a ``--warm-pool`` unit boots weightless (after the
    prewarm, which every rank runs together), and its engines come and go
    with the leader's ``OP_ATTACH`` / ``OP_DETACH``.  Only a follower that
    is the first rank of a host of its own (``LOCAL_RANK`` 0: the leader
    holds local rank 0 on its host) answers the unit's health probe on
    ``--port``; ranks that share the leader's host are answered for by the
    leader.  Returns the ops run."""
    from .multihost import FollowerEngines, follower_loop

    health = serve_follower_health(config.host, config.port) if local_rank == 0 else None
    metrics = ServerMetrics(deployment_name=config.deployment_name or config.model_name,
                            predictor_name=config.predictor_name, namespace=config.namespace)
    stats: dict = {}

    def report(engines, op_stats):
        return rank_report(op_stats, gen_engine=engines.gen_engine,
                           predict_engine=engines.engine, device=config.device,
                           mesh_shape=config.mesh_shape)

    if config.warm_pool:
        prewarm_from_snapshot(config)

        def attach(model_uri: str):
            try:
                predictor = _agreed(lambda: _load_model(config, model_uri))
            except Exception:
                _log.exception("attach of %s failed on this rank or another; back to the "
                               "warm pool", model_uri)
                free_device_memory(reset_peak=True)
                return None, None
            # After the agreement, where the leader builds its own: a
            # generation engine on a mesh forms its process groups.
            return follower_engines(predictor, config, metrics)

        engines = FollowerEngines(attach_fn=attach, report_fn=report,
                                  release_fn=lambda *_: free_device_memory(reset_peak=True))
        _log.info("follower of a warm-pool unit ready (weightless); waiting on the leader")
    else:
        predictor = _load_model(config, config.model_uri)
        engines = FollowerEngines(*follower_engines(predictor, config, metrics),
                                  report_fn=report)
        del predictor
        _log.info("follower ready; repeating the leader's ops")
    try:
        steps = follower_loop(None, transport, stats=stats, engines=engines)
    finally:
        if health is not None:
            health.shutdown()
    write_rank_report(engines.gen_engine, stats, predict_engine=engines.engine,
                      device=config.device, mesh_shape=config.mesh_shape)
    return steps


def main(argv: list[str] | None = None) -> None:
    from ..utils.logging import configure as configure_logging

    boot_wall = time.time()
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    configure_logging(json_format=args.log_format == "json")
    try:
        config = config_from_args(args)
    except ValueError as e:
        ap.error(str(e))
    from ..utils.compile_cache import enable_persistent_compile_cache

    enable_persistent_compile_cache(args.compile_cache_dir)  # before any kernel loads
    transport, device, local_rank = form_unit(config)
    config.device = device
    if transport is not None and not transport.is_leader:
        run_follower(config, transport, local_rank)
        from ..parallel.distributed import shutdown_distributed

        shutdown_distributed()
        return
    if config.warm_pool:
        predictor, srv = None, build_server(None, config, boot_wall=boot_wall,
                                            transport=transport)
    else:
        load_stats: dict = {}
        predictor = _load_model(config, args.model_uri, load_stats)
        srv = build_server(predictor, config, load_stats=load_stats, boot_wall=boot_wall,
                           transport=transport)
    metrics_httpd = None
    if args.metrics_port:
        try:
            metrics_httpd = serve_metrics(config.host, args.metrics_port, srv.metrics)
        except OSError as e:
            # The main port serves /metrics as well: a taken metrics port
            # costs the second listener, not the replica.
            _log.error("metrics listener on port %d failed (%s); /metrics stays on the "
                       "main port", args.metrics_port, e)

    terminated = threading.Event()

    def _terminate() -> None:
        # The endpoint lag: a terminating pod leaves the endpoints a little
        # after SIGTERM, so for --drain-s the replica reads NotReady and
        # still admits; only then does the drain stop admissions.
        try:
            if srv.lifecycle == "ready":
                srv.lifecycle = "draining"
                srv.metrics.set_ready(False)
            time.sleep(max(0.0, args.drain_s))
            _log.info("termination signal; draining (grace %.1fs)", args.drain_grace_seconds)
            srv.terminate(args.drain_grace_seconds)
            if metrics_httpd is not None:
                metrics_httpd.shutdown()
        finally:
            terminated.set()

    def _term(_signum, _frame):
        _log.info("termination signal; endpoint lag %.1fs before drain", args.drain_s)
        threading.Thread(target=_terminate, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    host, port = srv.server_address[:2]
    what = predictor.name if predictor is not None else "warm pool"
    _log.info("serving %s (%s) on %s:%d (metrics on %s)", config.model_name, what, host, port,
              args.metrics_port or f"{port}/metrics")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown_all()
        terminated.set()
    if transport is not None or os.environ.get(RANK_REPORT_ENV):
        # The followers are released at the end of the shutdown (after the
        # engine's last op), on the terminating thread: the group outlives it.
        terminated.wait(timeout=args.drain_grace_seconds + 60.0)
        engine = srv.gen_engine
        write_rank_report(engine, engine.op_stats if engine is not None else {},
                          predict_engine=srv.engine if srv.batcher is not None else None,
                          device=config.device, mesh_shape=config.mesh_shape)
    if transport is not None:
        from ..parallel.distributed import shutdown_distributed

        shutdown_distributed()
