"""Prometheus metrics with Seldon-executor-compatible identity (port of the
JAX package's ``server/metrics.py``, the families the V2 and /generate
routes and the generation engine record).

The operator's promotion gate queries these series by name
(``clients/prom_http.py`` in the JAX package):

- ``seldon_api_executor_client_requests_seconds`` histogram: p95 and mean
  latency and the request count;
- ``seldon_api_executor_server_requests_seconds_count`` with a ``code``
  label: the error rate (``code!="200"``), and ``service`` for feedback;
- ``tpumlops_feedback_reward_total`` gauge: the sum of posted rewards;

all keyed by ``{deployment_name, predictor_name, namespace}``.  The
operator, the autoscaler and the router read the generation families
(``tpumlops_ttft_seconds``, ``_itl_seconds``, ``_engine_queue_depth``,
``_admission_wait_ms``, ``_engine_shed``, ``_engine_preempt``,
``_cold_start_seconds``, ``_model_ready``, ...), some through
``histogram_quantile``.  The watchdog and poison families are always
registered; the device telemetry families (``tpumlops_device_*``,
``tpumlops_compile_*``) only with ``device_telemetry=True``, so a replica
without it exposes what it did before.  Names,
types, label names and bucket bounds are the reference's, so its PromQL
reads a port replica unchanged.  The card's machine has no
``prometheus_client``: the text exposition (format 0.0.4) is written here
with the standard library.
"""

from __future__ import annotations

import math
import threading

# Latency SLOs live in the 1 ms - 10 s range.
_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
_DECODE_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
_ADMISSION_WAIT_MS_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                              2500, 5000, 10000)
_REQUEST_TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
_PREFILL_FILL_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# Accepted draft length per (slot, verify); the top finite bucket is the
# draftTokens ceiling (64).
_SPEC_ACCEPTED_LEN_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
_SPEC_ACCEPTANCE_RATE_BUCKETS = (0.0, 0.25, 0.5, 0.75, 0.999, 1.0)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _num(x: float) -> str:
    """A sample value as Prometheus' Go client writes it."""
    x = float(x)
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    if math.isnan(x):
        return "NaN"
    return repr(x)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in pairs) + "}"


class _Family:
    def __init__(self, name: str, doc: str, label_names, lock):
        self.name, self.doc = name, doc
        self.label_names = tuple(label_names)
        self._lock = lock
        self._children: dict[tuple, list] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: labels {sorted(labels)}, "
                             f"expected {sorted(self.label_names)}")
        return tuple(str(labels[n]) for n in self.label_names)


class Counter(_Family):
    """A counter; ``name`` is the family name, the sample is ``name_total``."""

    def __init__(self, name, doc, label_names, lock):
        super().__init__(name, doc, label_names, lock)

    def inc(self, labels: dict, amount: float = 1.0) -> None:
        key = self._key(labels)
        with self._lock:
            child = self._children.setdefault(key, [0.0])
            child[0] += amount

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name}_total {self.doc}",
                 f"# TYPE {self.name}_total counter"]
        for key, (v,) in sorted(self._children.items()):
            lines.append(f"{self.name}_total{_labels(zip(self.label_names, key))} {_num(v)}")
        return lines


class Gauge(_Family):
    def set(self, labels: dict, value: float) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = [float(value)]

    def inc(self, labels: dict, amount: float = 1.0) -> None:
        key = self._key(labels)
        with self._lock:
            self._children.setdefault(key, [0.0])[0] += float(amount)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.doc}", f"# TYPE {self.name} gauge"]
        for key, (v,) in sorted(self._children.items()):
            lines.append(f"{self.name}{_labels(zip(self.label_names, key))} {_num(v)}")
        return lines


class Histogram(_Family):
    def __init__(self, name, doc, label_names, buckets, lock):
        super().__init__(name, doc, label_names, lock)
        self.buckets = tuple(float(b) for b in buckets) + (math.inf,)

    def observe(self, labels: dict, value: float) -> None:
        key = self._key(labels)
        with self._lock:
            child = self._children.setdefault(key, [[0] * len(self.buckets), 0.0])
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child[0][i] += 1
                    break
            child[1] += value

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.doc}", f"# TYPE {self.name} histogram"]
        for key, (counts, total) in sorted(self._children.items()):
            pairs = list(zip(self.label_names, key))
            running = 0
            for bound, c in zip(self.buckets, counts):
                running += c
                lines.append(f"{self.name}_bucket{_labels(pairs + [('le', _num(bound))])} "
                             f"{_num(running)}")
            lines.append(f"{self.name}_count{_labels(pairs)} {_num(running)}")
            lines.append(f"{self.name}_sum{_labels(pairs)} {_num(total)}")
        return lines


class ServerMetrics:
    def __init__(self, deployment_name: str, predictor_name: str, namespace: str,
                 device_telemetry: bool = False):
        self.identity = {
            "deployment_name": deployment_name,
            "predictor_name": predictor_name,
            "namespace": namespace,
        }
        ident = list(self.identity)
        lock = self._lock = threading.Lock()
        self.client_requests = Histogram(
            "seldon_api_executor_client_requests_seconds",
            "Inference request latency (gate-compatible identity)",
            ident, _LATENCY_BUCKETS, lock)
        # A histogram, not a counter: the gate reads its _count series.
        self.server_requests = Histogram(
            "seldon_api_executor_server_requests_seconds",
            "Request durations by HTTP code (gate queries _count with code!='200')",
            ident + ["code", "service"], _LATENCY_BUCKETS, lock)
        self.batch_size = Histogram(
            "tpumlops_batch_size", "Dynamic-batcher batch sizes",
            ident, _BATCH_BUCKETS, lock)
        self.queue_seconds = Histogram(
            "tpumlops_queue_seconds", "Time requests spend in the batching queue",
            ident, _LATENCY_BUCKETS, lock)
        self.batch_run_seconds = Histogram(
            "tpumlops_batch_run_seconds",
            "run_batch (device dispatch) wall time per executed batch",
            ident, _LATENCY_BUCKETS, lock)
        self.pipeline_wait_seconds = Histogram(
            "tpumlops_pipeline_wait_seconds",
            "Wait behind the previous in-flight batch before materialize",
            ident, _LATENCY_BUCKETS, lock)
        self.compilations = Counter(
            "tpumlops_compilations",
            "New input signatures seen by the engine (compilations on the "
            "reference's XLA path)",
            ident, lock)
        # -- the generation engine's families --------------------------------
        self.generated_tokens = Counter(
            "tpumlops_generated_tokens",
            "Tokens produced by the continuous-batching generation engine",
            ident, lock)
        self.decode_batch = Histogram(
            "tpumlops_decode_batch_size",
            "Active slots per continuous-batching decode step",
            ident, _DECODE_BATCH_BUCKETS, lock)
        self.decode_step_seconds = Histogram(
            "tpumlops_decode_step_seconds", "Wall time of one batched decode step",
            ident, _LATENCY_BUCKETS, lock)
        self.engine_active_slots = Gauge(
            "tpumlops_engine_active_slots",
            "Occupied decode slots at the most recent engine tick", ident, lock)
        self.engine_queue_depth = Gauge(
            "tpumlops_engine_queue_depth",
            "Requests queued but NOT yet admitted (excludes in-flight "
            "admissions — see tpumlops_engine_admitting)", ident, lock)
        self.engine_admitting = Gauge(
            "tpumlops_engine_admitting",
            "Admissions mid-prefill (dequeued, no first token yet)", ident, lock)
        self.admission_wait_ms = Histogram(
            "tpumlops_admission_wait_ms",
            "Milliseconds a request waited in the queue before its admission began",
            ident, _ADMISSION_WAIT_MS_BUCKETS, lock)
        self.ttft_seconds = Histogram(
            "tpumlops_ttft_seconds",
            "Submit-to-first-token latency per generation request",
            ident, _LATENCY_BUCKETS, lock)
        self.itl_seconds = Histogram(
            "tpumlops_itl_seconds",
            "Inter-token latency: wall between consecutive tokens of one "
            "request (first token excluded — that is TTFT)",
            ident, _LATENCY_BUCKETS, lock)
        self.request_tokens = Histogram(
            "tpumlops_request_tokens",
            "Tokens generated per finished request (includes cancelled "
            "requests' partial output)",
            ident, _REQUEST_TOKEN_BUCKETS, lock)
        # Packed multi-admission prefill: real chunks a packed forward.  Under
        # a burst its mean should track min(concurrent admissions,
        # prefillBatch); a flat 1 under load means packing is not engaging.
        self.prefill_batch_fill = Histogram(
            "tpumlops_prefill_batch_fill",
            "Admission chunks packed into one batched prefill call",
            ident, _PREFILL_FILL_BUCKETS, lock)
        self.tick_seconds = Histogram(
            "tpumlops_tick_seconds",
            "Engine tick wall time by kind (decode/verify/prefill/seed); the "
            "port's decode and verify ticks read their tokens back, so their "
            "walls cover their device time",
            ident + ["kind"], _LATENCY_BUCKETS, lock)
        self.engine_dispatches = Counter(
            "tpumlops_engine_dispatches",
            "Engine device dispatches by tick kind (decode/verify/prefill/seed)",
            ident + ["op"], lock)
        # Radix prefix cache (server/prefix_cache.py) and its host L2.
        self.prefix_cache_hits = Counter(
            "tpumlops_prefix_cache_hits",
            "Admissions that reused a radix-cached prompt prefix", ident, lock)
        self.prefix_cache_cached_tokens = Counter(
            "tpumlops_prefix_cache_cached_tokens",
            "Prompt tokens served from the prefix KV cache (prefill skipped)", ident, lock)
        self.prefix_cache_evictions = Counter(
            "tpumlops_prefix_cache_evictions",
            "Prefix-cache chunks evicted under the byte budget (LRU)", ident, lock)
        self.prefix_cache_l2_hits = Counter(
            "tpumlops_prefix_cache_l2_hits",
            "Radix-walk misses served by the second-tier host-RAM pool "
            "(chunk promoted back into the tree)", ident, lock)
        self.prefix_cache_l2_spills = Counter(
            "tpumlops_prefix_cache_l2_spills",
            "First-tier evictions caught by the second-tier pool", ident, lock)
        self.prefix_cache_l2_evictions = Counter(
            "tpumlops_prefix_cache_l2_evictions",
            "Chunks aged out of the second-tier pool (LRU byte budget)", ident, lock)
        # Self-speculative decoding (server/speculative.py): the counters
        # give the acceptance rate over any window, the histograms its shape.
        self.spec_proposed_tokens = Counter(
            "tpumlops_spec_proposed_tokens",
            "Draft tokens proposed by the n-gram speculative drafter", ident, lock)
        self.spec_accepted_tokens = Counter(
            "tpumlops_spec_accepted_tokens",
            "Draft tokens accepted by greedy verification", ident, lock)
        self.spec_accepted_len = Histogram(
            "tpumlops_spec_accepted_len", "Accepted draft length per (slot, verify)",
            ident, _SPEC_ACCEPTED_LEN_BUCKETS, lock)
        self.spec_acceptance_rate = Histogram(
            "tpumlops_spec_acceptance_rate", "accepted/proposed per (slot, verify)",
            ident, _SPEC_ACCEPTANCE_RATE_BUCKETS, lock)
        self.shed = Counter(
            "tpumlops_engine_shed",
            "Generation requests shed at admission (HTTP 429)",
            ident + ["reason"], lock)
        self.preempt = Counter(
            "tpumlops_engine_preempt",
            "Slot preemption events (evict = KV written back through "
            "the prefix cache and slot reclaimed; restore = sequence "
            "re-admitted with no lost work)",
            ident + ["event"], lock)
        self.model_load_seconds = Gauge(
            "tpumlops_model_load_seconds",
            "Most recent model load's stage breakdown (total = wall)",
            ident + ["stage"], lock)
        self.cold_start_seconds = Gauge(
            "tpumlops_cold_start_seconds",
            "Cold-start stage walls of the most recent boot "
            "(load/compile/first_token/total)",
            ident + ["stage"], lock)
        self.ready = Gauge(
            "tpumlops_model_ready", "1 once the model is loaded and warmed",
            ident, lock)
        # Reward telemetry of the Seldon feedback API; the feedback count
        # is server_requests{service="feedback"}.  A gauge, not a counter:
        # rewards are any float (a negative one is a penalty).
        self.feedback_reward = Gauge(
            "tpumlops_feedback_reward_total",
            "Running sum of rewards posted to the feedback endpoint "
            "(may decrease: negative rewards are penalties)",
            ident, lock)
        # Failure containment: the watchdog families sit at 0 until
        # --watchdog-deadline-s arms the monitor; the poison counters back
        # the always-on quarantine.
        self.watchdog_stalls = Counter(
            "tpumlops_engine_watchdog_stalls",
            "Scheduler ticks that exceeded the watchdog deadline "
            "(each flips /readyz unready and journals a watchdog event)",
            ident, lock)
        self.watchdog_tick_age = Gauge(
            "tpumlops_engine_watchdog_last_tick_age_seconds",
            "Age of the scheduler's last heartbeat as seen by the "
            "watchdog monitor (0 while disarmed; climbs during a stall)",
            ident, lock)
        self.poison_quarantined = Counter(
            "tpumlops_engine_poison_quarantined",
            "Prompt fingerprints quarantined after repeated "
            "admission/prefill crashes", ident, lock)
        self.poison_rejected = Counter(
            "tpumlops_engine_poison_rejected",
            "Submissions refused (typed 422) because their prompt "
            "fingerprint is quarantined", ident, lock)
        families = [
            self.watchdog_stalls, self.watchdog_tick_age,
            self.poison_quarantined, self.poison_rejected,
        ]
        # Device telemetry (server/device_telemetry.py), registered only
        # when it is on: even an unobserved family adds HELP/TYPE lines.
        self.device_hbm_bytes = None
        self.device_mfu = None
        self.device_hbm_bw_util = None
        self.compile_seconds = None
        self.compile_cache_hits = None
        self.compile_cache_misses = None
        self.engine_collective_seconds = None
        if device_telemetry:
            self.device_hbm_bytes = Gauge(
                "tpumlops_device_hbm_bytes",
                "Analytic HBM ledger: bytes held on device by component "
                "(weights_<dtype>, kv_cache, sampling_state, cuda_graph_pool, total)",
                ident + ["component"], lock)
            self.device_mfu = Gauge(
                "tpumlops_device_mfu",
                "Model FLOPs utilization of the most recent engine tick "
                "of each kind (analytic cost model / device peak)",
                ident + ["kind"], lock)
            self.device_hbm_bw_util = Gauge(
                "tpumlops_device_hbm_bw_util",
                "HBM bandwidth utilization of the most recent engine "
                "tick of each kind (analytic bytes / device peak)",
                ident + ["kind"], lock)
            self.engine_collective_seconds = Counter(
                "tpumlops_engine_collective_seconds",
                "Estimated interconnect collective wall seconds per engine "
                "dispatch at tp > 1, by op (all_reduce = the Megatron "
                "o/down psum pair per layer, all_gather = the vocab-"
                "sharded logits gather), from the analytic cost model",
                ident + ["op"], lock)
            self.compile_seconds = Counter(
                "tpumlops_compile_seconds",
                "Kernel build (nvcc) and CUDA graph capture wall seconds, "
                "by the kernel or program they were for",
                ident + ["op"], lock)
            self.compile_cache_hits = Counter(
                "tpumlops_compile_cache_hits",
                "Kernel builds served by a library already in the build "
                "directory", ident, lock)
            self.compile_cache_misses = Counter(
                "tpumlops_compile_cache_misses",
                "Kernel builds that ran nvcc", ident, lock)
            families += [self.device_hbm_bytes, self.device_mfu, self.device_hbm_bw_util,
                         self.engine_collective_seconds, self.compile_seconds, self.compile_cache_hits,
                         self.compile_cache_misses]
        self._families = (
            self.client_requests, self.server_requests, self.batch_size,
            self.queue_seconds, self.batch_run_seconds, self.pipeline_wait_seconds,
            self.compilations, self.generated_tokens, self.decode_batch,
            self.decode_step_seconds, self.engine_active_slots,
            self.engine_queue_depth, self.engine_admitting,
            self.admission_wait_ms, self.ttft_seconds, self.itl_seconds,
            self.request_tokens, self.prefill_batch_fill, self.tick_seconds,
            self.engine_dispatches,
            self.prefix_cache_hits, self.prefix_cache_cached_tokens,
            self.prefix_cache_evictions, self.prefix_cache_l2_hits,
            self.prefix_cache_l2_spills, self.prefix_cache_l2_evictions,
            self.spec_proposed_tokens, self.spec_accepted_tokens,
            self.spec_accepted_len, self.spec_acceptance_rate,
            self.shed, self.preempt, self.model_load_seconds, self.cold_start_seconds,
            self.ready, self.feedback_reward, *families,
        )

    def observe_request(self, seconds: float, code: int = 200,
                        service: str = "predictions") -> None:
        # client_requests feeds the gate's latency percentiles: inference
        # traffic only.
        if service == "predictions":
            self.client_requests.observe(self.identity, seconds)
        self.server_requests.observe(
            {**self.identity, "code": str(code), "service": service}, seconds)

    def observe_feedback_reward(self, reward: float) -> None:
        self.feedback_reward.inc(self.identity, reward)

    def observe_batch(self, size: int, queue_seconds: float, run_seconds: float = 0.0,
                      pipeline_wait_seconds: float = 0.0) -> None:
        self.batch_size.observe(self.identity, size)
        self.queue_seconds.observe(self.identity, queue_seconds)
        self.batch_run_seconds.observe(self.identity, run_seconds)
        self.pipeline_wait_seconds.observe(self.identity, pipeline_wait_seconds)

    def inc_compilations(self) -> None:
        self.compilations.inc(self.identity)

    def observe_decode_step(self, active_slots: int, seconds: float,
                            queue_depth: int = 0, admitting: int = 0) -> None:
        # active_slots == 0 is the engine's idle heartbeat: refresh the
        # occupancy gauges, keep the per-tick histograms tick-only.
        if active_slots > 0:
            self.decode_batch.observe(self.identity, active_slots)
            self.decode_step_seconds.observe(self.identity, seconds)
        self.engine_active_slots.set(self.identity, active_slots)
        self.engine_queue_depth.set(self.identity, queue_depth)
        self.engine_admitting.set(self.identity, admitting)

    def inc_generated_tokens(self, n: int = 1) -> None:
        self.generated_tokens.inc(self.identity, n)

    def inc_shed(self, reason: str) -> None:
        self.shed.inc({**self.identity, "reason": reason})

    def inc_preempt(self, event: str) -> None:
        """``event``: "evict" (a slot reclaimed, its K/V parked through the
        prefix cache) or "restore" (the sequence re-admitted)."""
        self.preempt.inc({**self.identity, "event": event})

    def inc_watchdog_stall(self) -> None:
        self.watchdog_stalls.inc(self.identity)

    def set_watchdog_tick_age(self, seconds: float) -> None:
        self.watchdog_tick_age.set(self.identity, seconds)

    def inc_poison(self, action: str) -> None:
        """``action``: "quarantined" (a fingerprint crossed the crash
        threshold) or "rejected" (a submit refused with the typed 422)."""
        if action == "quarantined":
            self.poison_quarantined.inc(self.identity)
        else:
            self.poison_rejected.inc(self.identity)

    # -- device telemetry (families exist only with device_telemetry) ---------

    def observe_hbm_component(self, component: str, nbytes: int) -> None:
        if self.device_hbm_bytes is not None:
            self.device_hbm_bytes.set({**self.identity, "component": component}, nbytes)

    def observe_collective(self, op: str, seconds: float) -> None:
        if self.engine_collective_seconds is not None:
            self.engine_collective_seconds.inc({**self.identity, "op": op}, seconds)

    def observe_device_util(self, kind: str, mfu: float, bw_util: float) -> None:
        if self.device_mfu is not None:
            self.device_mfu.set({**self.identity, "kind": kind}, mfu)
            self.device_hbm_bw_util.set({**self.identity, "kind": kind}, bw_util)

    def observe_compile(self, op: str, seconds: float) -> None:
        if self.compile_seconds is not None:
            self.compile_seconds.inc({**self.identity, "op": op}, seconds)

    def observe_compile_cache(self, hit: bool) -> None:
        if self.compile_cache_hits is not None:
            (self.compile_cache_hits if hit else self.compile_cache_misses).inc(self.identity)

    def observe_admission_wait(self, seconds: float) -> None:
        self.admission_wait_ms.observe(self.identity, seconds * 1000)

    def observe_ttft(self, seconds: float) -> None:
        self.ttft_seconds.observe(self.identity, seconds)

    def observe_itl(self, seconds: float) -> None:
        self.itl_seconds.observe(self.identity, seconds)

    def observe_request_tokens(self, n: int) -> None:
        self.request_tokens.observe(self.identity, n)

    def observe_prefill_batch(self, fill: int) -> None:
        self.prefill_batch_fill.observe(self.identity, fill)

    def observe_tick(self, kind: str, seconds: float) -> None:
        self.tick_seconds.observe({**self.identity, "kind": kind}, seconds)

    def inc_dispatch(self, op: str) -> None:
        self.engine_dispatches.inc({**self.identity, "op": op})

    def observe_speculative(self, proposed: int, accepted: int) -> None:
        self.spec_proposed_tokens.inc(self.identity, proposed)
        self.spec_accepted_tokens.inc(self.identity, accepted)
        self.spec_accepted_len.observe(self.identity, accepted)
        if proposed > 0:
            self.spec_acceptance_rate.observe(self.identity, accepted / proposed)

    def observe_prefix_hit(self, cached_tokens: int) -> None:
        self.prefix_cache_hits.inc(self.identity)
        self.prefix_cache_cached_tokens.inc(self.identity, cached_tokens)

    def inc_prefix_evictions(self, n: int = 1) -> None:
        self.prefix_cache_evictions.inc(self.identity, n)

    def inc_prefix_l2(self, kind: str) -> None:
        counter = {
            "hit": self.prefix_cache_l2_hits,
            "spill": self.prefix_cache_l2_spills,
            "evict": self.prefix_cache_l2_evictions,
        }.get(kind)
        if counter is not None:
            counter.inc(self.identity)

    # The loader's stage keys -> the gauge's stage label (the reference's).
    _LOAD_STAGES = {"disk_s": "disk", "transfer_s": "transfer", "quantize_s": "quantize",
                    "shard_s": "shard", "restore_s": "restore", "wall_s": "total"}

    def observe_model_load(self, stats: dict) -> None:
        """A load's stage walls (a stage absent from ``stats`` makes no
        child): ``wall_s`` is stage "total", a snapshot's ``restore_s``
        stage "restore"."""
        for key, stage in self._LOAD_STAGES.items():
            if stats.get(key) is not None:
                self.model_load_seconds.set({**self.identity, "stage": stage},
                                            float(stats[key]))

    def observe_cold_start(self, stage: str, seconds: float) -> None:
        self.cold_start_seconds.set({**self.identity, "stage": stage},
                                    max(0.0, float(seconds)))

    def set_ready(self, ready: bool) -> None:
        self.ready.set(self.identity, 1.0 if ready else 0.0)

    def render(self) -> bytes:
        lines: list[str] = []
        with self._lock:
            for fam in self._families:
                lines.extend(fam.render())
        return ("\n".join(lines) + "\n").encode()
