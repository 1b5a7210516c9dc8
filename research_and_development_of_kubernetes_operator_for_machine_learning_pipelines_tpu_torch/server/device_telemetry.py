"""Device telemetry: HBM ledger, compile observatory, cost model + MFU
(port of the JAX package's ``server/device_telemetry.py``).

Three parts:

- **HBM ledger** — an analytic byte ledger of what the serving process
  holds on the card (weight tree by dtype, the KV cache with the int8kv
  layout's scale planes, per-slot sampling state) and, the port's own
  component, the CUDA graph pool of the engine's ``MultistepProgram`` or
  ``SuperstepProgram`` measured from the program after its capture;
  cross-checked against ``torch.cuda.memory_stats()``.  Served at ``GET
  /debug/device``, exported as ``tpumlops_device_hbm_bytes{component}``,
  and stamped into the model-capacity startup log line
  (``server/loader.py`` emits that line even with telemetry off).
- **Compile observatory** — on the port a "compilation" is one of two
  events: a kernel build in ``ops/_build.py`` (a cache hit when its
  library is already in the build directory, a miss when ``nvcc`` runs;
  ``utils/compile_cache`` reports both, attributed to the kernel), and a
  CUDA graph capture, attributed to its program (``multistep`` or
  ``superstep``, one event a window bucket and token rule) with its wall.
  ``tpumlops_compile_seconds{op}`` and ``tpumlops_compile_cache_{hits,
  misses}``; a warning when the start-up builds and capture exceed the
  readiness budget.  A recapture after a crash lands in the journal too.
- **Cost model + utilization** — analytic per-program FLOPs / HBM-bytes
  estimates for the llama serving programs, joined with flight-recorder
  tick walls into per-tick-kind MFU and HBM-bandwidth utilization.  The
  counts are the reference program's work, whatever implements it: an
  int8 weight counts one byte, so the bf16 copy of every int8 weight that
  ``models/llama._qmatmul`` makes on the card shows as low utilization,
  not as more bytes.  Exposed as ``mfu`` / ``hbm_bw_util`` fields on
  recorder ticks, Perfetto counter tracks in ``/debug/trace``, and
  ``tpumlops_device_{mfu,hbm_bw_util}{kind}`` gauges.

``cost_from_analysis`` parses the ``{"flops", "bytes accessed"}``
payload of an XLA ``Compiled.cost_analysis()`` (a dict, or a one-item
list), the reference's adapter for tooling that holds a compiled
program; the port's engine never does, and counts analytically.

On a mesh of several ranks (one process a rank) everything is per rank:
the ledger counts the rank's blocks (its weight shards, ``B/dp`` cache
rows of ``NKV/tp`` heads: ``models/partition.engine_state_shapes``), and at
tp > 1 each tick's analytic collective wall (the Megatron all-reduce pair
a layer and the logits all-gather, ``LlamaCostModel.collective_bytes``,
over ``DevicePeaks.link_bytes_per_s``) feeds
``tpumlops_engine_collective_seconds{op}``.

Peaks: the NVIDIA H100 SXM's published dense rates (989e12 bf16 tensor
FLOP/s, 3.35e12 B/s, 80 GiB; NVLink 4 at 900 GB/s a GPU both ways, so
450e9 B/s each way, NVIDIA's H100 data sheet, at the card's 700 W limit),
matched on ``torch.cuda.get_device_name()``.  Anywhere else (the CPU,
another card) the same figures stand, marked ``assumed``, so the ratios
stay computable.  The collective walls are the NVLink deployment's
estimate: ranks that share one card (gloo, staged through the host) run
their collectives far slower, which ``chip_smoke.py`` phase 8 measures.

Error bars: the FLOPs count is exact for the matmul tree and counts the
attention at the full padded window, so MFU is a lower bound on "useful"
utilization by at most the padding fraction; HBM bytes assume each weight
byte and each attended cache byte streams exactly once; values are
clamped to (0, 1].

``--device-telemetry`` gates the whole layer; off (the default) constructs
nothing and every payload stays byte-for-byte.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass, field

_log = logging.getLogger("tpumlops.device_telemetry")
_compile_log = logging.getLogger("tpumlops.compile")

# Warm-up budget before a warning fires: the builder's readiness probe
# window is initialDelay 10 + period 5 x failureThreshold 60 = 310 s.
READINESS_BUDGET_S = 300.0


# ---------------------------------------------------------------------------
# Device facts (peaks the utilization ratios divide by)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DevicePeaks:
    """Peak rates the utilization ratios are read against.  ``chips`` is
    how many cards the numbers cover."""

    kind: str  # the matched card (or the assumed stand-in)
    flops_per_s: float  # dense bf16 tensor-core peak
    hbm_bytes_per_s: float
    hbm_bytes: int  # HBM capacity
    source: str  # "detected" | "assumed"
    chips: int = 1
    # One direction of the card's GPU-to-GPU interconnect (the collective
    # walls divide by it): NVLink 4, 900 GB/s both ways.
    link_bytes_per_s: float = 450e9

    def scaled(self, chips: int) -> "DevicePeaks":
        n = max(1, int(chips))
        return dataclasses.replace(
            self,
            flops_per_s=self.flops_per_s * n,
            hbm_bytes_per_s=self.hbm_bytes_per_s * n,
            hbm_bytes=self.hbm_bytes * n,
            chips=n,
        )


def param_device_count(params) -> int:
    """Cards the param tree is sharded over: 1 (the port has no mesh yet)."""
    return 1


# NVIDIA H100 SXM, published dense rates (989e12 bf16 FLOP/s, 3.35e12
# B/s, 80 GiB).  Matching is by a substring of the lowercased
# ``torch.cuda.get_device_name()``.
_KNOWN_DEVICES = {
    "h100": ("nvidia-h100", 989e12, 3.35e12, 80 * 2**30),
}
_ASSUMED = ("nvidia-h100 (assumed)", 989e12, 3.35e12, 80 * 2**30)


def detect_peaks() -> DevicePeaks:
    import torch

    kind = "unknown"
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0).lower()
    for marker, (name, fl, bw, hbm) in _KNOWN_DEVICES.items():
        if marker in kind:
            return DevicePeaks(name, fl, bw, hbm, "detected")
    name, fl, bw, hbm = _ASSUMED
    return DevicePeaks(name, fl, bw, hbm, "assumed")


def measured_memory() -> dict | None:
    """The caching allocator's counts on the card, under the keys the
    reference reads from ``device.memory_stats()``: ``bytes_in_use``
    (live tensors), ``peak_bytes_in_use``, ``bytes_reserved`` (held by the
    allocator) and ``bytes_limit`` (the card's memory); None without a
    card."""
    import torch

    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(0)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(0).total_memory),
        "devices": 1,
    }


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def weights_bytes_by_dtype(params) -> dict[str, int]:
    """Parameter bytes grouped by dtype as stored (int8 leaves count
    1 byte/elem; their f32 scale planes land under float32)."""
    from ..models.common import tree_leaves

    out: dict[str, int] = {}
    for leaf in tree_leaves(params):
        name = _dtype_name(leaf)
        out[name] = out.get(name, 0) + int(leaf.numel()) * leaf.element_size()
    return out


def kv_cache_bytes_per_row(cfg, kv_quant: bool, dtype_bytes: int = 2, tp: int = 1) -> int:
    """Bytes one cache row (slot at full ``max_seq``) holds: k + v across
    all layers, plus the int8kv layout's per-(pos, head) f32 scales; at
    ``tp`` > 1 a rank's ``NKV/tp`` heads of it."""
    elems = cfg.num_layers * (cfg.num_kv_heads // max(1, int(tp))) * cfg.max_seq * cfg.head_dim
    if kv_quant:
        # int8 values + f32 scale per head_dim group, for k and v each.
        return 2 * (elems + (elems // cfg.head_dim) * 4)
    return 2 * elems * dtype_bytes


def sampling_state_bytes(max_slots: int) -> int:
    """Engine per-slot device state outside the cache, as the reference
    counts it: token buffer (int32), PRNG keys (2x uint32), temps/topk/topp
    (4 B each).  The port holds the token and the key words as int64, 12
    bytes a slot more, which the ledger's cross-check absorbs."""
    return max_slots * (4 + 8 + 4 + 4 + 4)


@dataclass
class HbmLedger:
    """Analytic device-byte ledger, cross-checkable against the caching
    allocator.  ``components`` are on the card; ``host_components`` (the
    prefix cache's host-RAM budget) ride along for the capacity story but
    never count toward the device total."""

    components: dict[str, int] = field(default_factory=dict)
    host_components: dict[str, int] = field(default_factory=dict)
    kv_bytes_per_row: int = 0
    max_slots: int = 0

    def device_total(self) -> int:
        return sum(self.components.values())

    def max_cache_rows(self, hbm_bytes: int) -> int:
        """Full-capacity KV rows that fit beside the weights — the
        capacity number the autoscaler/operator plans against."""
        if self.kv_bytes_per_row <= 0:
            return 0
        spare = hbm_bytes - sum(
            v for k, v in self.components.items() if not k.startswith("kv_")
        )
        return max(0, spare // self.kv_bytes_per_row)

    def snapshot(self, peaks: DevicePeaks | None = None) -> dict:
        peaks = peaks or detect_peaks()
        measured = measured_memory()
        out = {
            "components": dict(self.components),
            "host_components": dict(self.host_components),
            "device_total_bytes": self.device_total(),
            "kv_bytes_per_row": self.kv_bytes_per_row,
            "max_slots": self.max_slots,
            "hbm_capacity_bytes": peaks.hbm_bytes,
            "hbm_source": peaks.source,
            "max_cache_rows": self.max_cache_rows(peaks.hbm_bytes),
            "measured": measured,
        }
        if measured and measured.get("bytes_in_use"):
            out["ledger_vs_measured_pct"] = round(
                100.0 * (self.device_total() - measured["bytes_in_use"])
                / max(1, measured["bytes_in_use"]),
                1,
            )
        return out


def build_hbm_ledger(
    params,
    cfg,
    max_slots: int,
    kv_quant: bool = False,
    dtype_bytes: int = 2,
    prefix_cache_budget_bytes: int = 0,
    mesh_shape=None,
    tick_rows: int | None = None,
) -> HbmLedger:
    """The ledger of one rank: ``params`` as held (a rank's blocks on a
    mesh), the cache at ``B/dp`` rows of ``NKV/tp`` heads, the replicated
    sampling state whole; at sp > 1 also the port's own
    ``ring_activations`` (:func:`ring_activation_bytes` at ``max_seq``
    positions, in the activations' ``dtype_bytes``), and at a world above
    one rank with ``tick_rows`` (the engine's widest tick) its own
    ``tick_activations`` (:func:`tick_activation_bytes`), both of which the
    reference's ledger, counting no activations, lacks."""
    from ..models.partition import dp_degree, mesh_device_count, sp_degree, tp_degree

    ledger = HbmLedger(
        kv_bytes_per_row=kv_cache_bytes_per_row(cfg, kv_quant, dtype_bytes,
                                                tp_degree(mesh_shape)),
        max_slots=int(max_slots),
    )
    for dtype, nbytes in weights_bytes_by_dtype(params).items():
        ledger.components[f"weights_{dtype}"] = nbytes
    ledger.components["kv_cache"] = (ledger.kv_bytes_per_row * int(max_slots)
                                     // dp_degree(mesh_shape))
    ledger.components["sampling_state"] = sampling_state_bytes(max_slots)
    if sp_degree(mesh_shape) > 1:
        ledger.components["ring_activations"] = ring_activation_bytes(
            cfg, cfg.max_seq, mesh_shape, dtype_bytes)
    if tick_rows and mesh_device_count(mesh_shape) > 1:
        ledger.components["tick_activations"] = tick_activation_bytes(
            params, cfg, tick_rows, mesh_shape, dtype_bytes)
    if prefix_cache_budget_bytes:
        ledger.host_components["prefix_cache_budget"] = int(
            prefix_cache_budget_bytes
        )
    return ledger


def ring_activation_bytes(cfg, positions: int, mesh_shape, dtype_bytes: int = 2) -> int:
    """What one rank holds during the sp ring prefill of a ``positions``-long
    padded prompt (``llama.prefill_ring``), beyond its weights and cache:

    - the K/V of every layer, ``2 L`` planes of ``NKV/tp x D`` in the
      activations' type: its own ``positions/sp`` rows stacked, then the
      sp all-gather's parts and their concatenation (the whole prompt
      each);
    - one layer's f32 working set at ``positions/sp`` rows: three
      ``I/tp``-wide MLP planes (gate, up, their product), three
      ``H/tp x D`` attention planes (the ring's output, a block's partial,
      their merge) and three ``H``-wide residual planes."""
    from ..models.partition import sp_degree, tp_degree

    sp, tp = sp_degree(mesh_shape), tp_degree(mesh_shape)
    rows = int(positions) // sp
    kv_row = (cfg.num_kv_heads // tp) * cfg.head_dim * int(dtype_bytes)
    kv = 2 * cfg.num_layers * kv_row * (rows + 2 * int(positions))
    layer = 4 * rows * 3 * (cfg.intermediate_size // tp
                            + (cfg.num_heads // tp) * cfg.head_dim + cfg.hidden_size)
    return kv + layer


def tick_activation_bytes(params, cfg, rows: int, mesh_shape, dtype_bytes: int = 2) -> int:
    """What one rank holds beyond its weights, cache and state during a tick
    of ``rows`` rows at a world above one rank, where the K-step and
    super-step programs run uncaptured (on one rank the same working set
    lies in their graph pool, measured as ``cuda_graph_pool``):

    - the f32 logits: this rank's ``V/tp`` columns, then the tp all-gather's
      parts and their concatenation (the whole vocabulary each);
    - with int8 weights, the activations'-type copy of the largest int8
      matmul block (``_qmatmul`` copies the codes for each call);
    - one layer's f32 working set, as :func:`ring_activation_bytes` counts
      it: three ``I/tp``-wide MLP planes, three ``H/tp x D`` attention
      planes and three ``H``-wide residual planes."""
    from ..models.partition import tp_degree

    tp = tp_degree(mesh_shape)
    rows = int(rows)
    logits = 4 * rows * cfg.vocab_size * (2 * tp + 1) // tp
    copy = 0
    for path, leaf in _quantized_blocks(params):
        per = int(leaf.numel()) // (int(leaf.shape[0]) if path[0] == "layers" else 1)
        copy = max(copy, per * int(dtype_bytes))
    layer = 4 * rows * 3 * (cfg.intermediate_size // tp
                            + (cfg.num_heads // tp) * cfg.head_dim + cfg.hidden_size)
    return logits + copy + layer


def _quantized_blocks(tree, path=()):
    """``(path, q8)`` of every int8 matmul leaf (a ``{"q8", "scale"}`` node)."""
    if isinstance(tree, dict):
        if "q8" in tree and "scale" in tree:
            yield path, tree["q8"]
            return
        for k, v in tree.items():
            yield from _quantized_blocks(v, path + (k,))


def predict_activation_bytes(predictor, batch: int) -> int:
    """The port's estimate of the forward's f32 working set on one rank at
    the largest warmed ``batch`` (the ledger's ``activations`` term of a
    predict flavor): BERT at its longest sequence bucket, three planes of
    the residual width and three of this rank's MLP width (``I/tp``: the
    word block's rows give tp) a position; ResNet-50 six feature maps of
    its stem's output (``image/2`` square at the stem width) an image.
    Other flavors: 0."""
    tree = predictor.tree or {}
    cfg = tree.get("cfg")
    if predictor.name == "bert-classifier":
        seq = int((predictor.seq_pad or {}).get("max_len")
                  or predictor.metadata.get("seq_len", 128))
        tp = max(1, cfg.vocab_size // int(tree["params"]["embeddings"]["word"].shape[0]))
        return 4 * int(batch) * seq * 3 * (cfg.hidden_size + cfg.intermediate_size // tp)
    if predictor.name == "resnet-classifier":
        side = int(predictor.metadata.get("image_size", 224)) // 2
        return 4 * 6 * int(batch) * side * side * cfg.width
    return 0


def build_predict_ledger(predictor, max_batch_size: int) -> HbmLedger:
    """The ledger of one rank of a predict flavor (BERT, ResNet): its tree
    as held (a rank's blocks on a mesh) by dtype, ResNet's serving copy of
    its convolutions (``resnet.prepare``), and the forward's
    :func:`predict_activation_bytes` at ``max_batch_size``."""
    ledger = HbmLedger()
    tree = predictor.tree or {}
    if "params" in tree:
        for dtype, nbytes in weights_bytes_by_dtype(tree["params"]).items():
            ledger.components[f"weights_{dtype}"] = nbytes
    if predictor.name == "resnet-classifier":
        from ..models.resnet import _CONV_KEYS

        ledger.components["prepared_convs"] = sum(
            int(leaf.numel()) * leaf.element_size() for leaf in _conv_leaves(tree["params"],
                                                                            _CONV_KEYS))
    ledger.components["activations"] = predict_activation_bytes(predictor, max_batch_size)
    return ledger


def _conv_leaves(node, keys):
    if isinstance(node, list):
        for v in node:
            yield from _conv_leaves(v, keys)
    elif isinstance(node, dict):
        for k, v in node.items():
            if k in keys:
                yield v
            else:
                yield from _conv_leaves(v, keys)


def capacity_log_line(params, cfg, kv_quant: bool, tp: int = 1) -> str:
    """The model-capacity startup line ``server/loader.py`` stamps (even
    with telemetry off): weights by dtype, KV bytes/row, max cache rows;
    a rank's own at ``tp`` > 1 (``params`` its blocks)."""
    peaks = detect_peaks().scaled(param_device_count(params))
    by_dtype = weights_bytes_by_dtype(params)
    total = sum(by_dtype.values())
    per_row = kv_cache_bytes_per_row(cfg, kv_quant, tp=tp)
    spare = peaks.hbm_bytes - total
    rows = max(0, spare // per_row) if per_row else 0
    dtypes = ", ".join(
        f"{k}={v / 2**20:.1f}MiB" for k, v in sorted(by_dtype.items())
    )
    return (
        f"model capacity: weights {total / 2**20:.1f} MiB ({dtypes}), "
        f"kv {per_row} B/row (max_seq {cfg.max_seq}"
        f"{', int8kv' if kv_quant else ''}), "
        f"max cache rows {rows} "
        f"(hbm {peaks.hbm_bytes / 2**30:.1f} GiB "
        f"{peaks.source} {peaks.kind})"
    )


# ---------------------------------------------------------------------------
# Compile observatory
# ---------------------------------------------------------------------------


class CompileObservatory:
    """Attributes every kernel build and CUDA graph capture to the op it
    was for: a kernel's source name (``decode_attention``, ...) or the
    graph program (``multistep``, ``superstep``).  ``utils/compile_cache``
    delivers the builds; the engine delivers its captures."""

    MAX_EVENTS = 256

    def __init__(self, readiness_budget_s: float = READINESS_BUDGET_S):
        self._lock = threading.Lock()
        self.readiness_budget_s = float(readiness_budget_s)
        # op -> {"compiles", "seconds", "cache_hits", "cache_misses"}
        self.ops: dict[str, dict] = {}
        self.events: list[dict] = []  # newest-last, bounded
        self._in_warmup = False
        self.warmup: dict = {}
        self._on_compile = None  # (op, seconds) -> None (metrics hookup)
        self._on_cache = None  # (hit: bool) -> None

    # -- wiring ---------------------------------------------------------------

    def install(self) -> None:
        """Register with utils/compile_cache, which reports every kernel
        build from now on."""
        from ..utils.compile_cache import install_compile_listeners

        install_compile_listeners(observatory=self)

    def set_metrics_hooks(self, on_compile=None, on_cache=None) -> None:
        self._on_compile = on_compile
        self._on_cache = on_cache

    # -- event sinks ----------------------------------------------------------

    def on_event(self, kind: str, seconds: float = 0.0, op: str = "other") -> None:
        """``kind``: "compile" (a build or a capture, with its wall) or
        "cache_hit" / "cache_miss" (a kernel build's outcome)."""
        with self._lock:
            rec = self.ops.setdefault(
                op,
                {"compiles": 0, "seconds": 0.0,
                 "cache_hits": 0, "cache_misses": 0},
            )
            if kind == "compile":
                rec["compiles"] += 1
                rec["seconds"] += seconds
                self.events.append(
                    {"op": op, "seconds": round(seconds, 4),
                     "ts": time.time(), "warmup": self._in_warmup}
                )
                del self.events[: -self.MAX_EVENTS]
                if self._in_warmup:
                    self.warmup["compiles"] = self.warmup.get("compiles", 0) + 1
                    self.warmup["seconds"] = (
                        self.warmup.get("seconds", 0.0) + seconds
                    )
            elif kind == "cache_hit":
                rec["cache_hits"] += 1
            elif kind == "cache_miss":
                rec["cache_misses"] += 1
        if kind == "compile" and self._on_compile is not None:
            self._on_compile(op, seconds)
        elif kind in ("cache_hit", "cache_miss") and self._on_cache is not None:
            self._on_cache(kind == "cache_hit")

    # -- the start-up builds and capture ---------------------------------------

    def begin_warmup(self) -> None:
        with self._lock:
            self._in_warmup = True
            self.warmup = {"compiles": 0, "seconds": 0.0}
            # Per-op counts at the start, so end_warmup reports what the
            # start-up itself built and captured.
            self._warmup_baseline = {
                op: rec["compiles"] for op, rec in self.ops.items()
            }
            self._t_warmup = time.perf_counter()

    def end_warmup(self) -> dict:
        with self._lock:
            self._in_warmup = False
            self.warmup["wall_s"] = round(
                time.perf_counter() - getattr(self, "_t_warmup", 0.0), 2
            )
            baseline = getattr(self, "_warmup_baseline", {})
            inventory = {
                op: rec["compiles"] - baseline.get(op, 0)
                for op, rec in sorted(self.ops.items())
                if rec["compiles"] - baseline.get(op, 0) > 0
            }
            self.warmup["ops"] = inventory
            report = dict(self.warmup)
            report["ops"] = dict(inventory)
        inv = (
            " ".join(f"{op}={n}" for op, n in report["ops"].items()) or "-"
        )
        if report["wall_s"] > self.readiness_budget_s:
            _log.warning(
                "warmup took %.1fs (> readiness budget %.0fs): %d builds and "
                "captures [%s], %.1fs of them — the kubelet may kill this pod "
                "first; keep the kernel build directory on the node "
                "(--compile-cache-dir) or raise the readiness window",
                report["wall_s"], self.readiness_budget_s,
                report["compiles"], inv, report["seconds"],
            )
        else:
            _compile_log.info(
                "warmup sweep done compiles=%d compile_s=%.2f "
                "wall_s=%.2f ops=[%s]",
                report["compiles"], report["seconds"],
                report["wall_s"], inv,
            )
        return report

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ops": {k: dict(v) for k, v in self.ops.items()},
                "events": [dict(e) for e in self.events],
                "warmup": dict(self.warmup),
                "readiness_budget_s": self.readiness_budget_s,
            }


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


def cost_from_analysis(analysis) -> tuple[float, float] | None:
    """Parse an XLA ``Compiled.cost_analysis()`` payload into ``(flops,
    hbm_bytes)``: a dict, or a one-item list of dicts as older jax
    returns; None when it carries neither count."""
    if isinstance(analysis, (list, tuple)):
        analysis = analysis[0] if analysis else None
    if not isinstance(analysis, dict):
        return None
    flops = float(analysis.get("flops", 0.0))
    nbytes = float(analysis.get("bytes accessed", 0.0))
    if flops <= 0.0 and nbytes <= 0.0:
        return None
    return flops, nbytes


@dataclass(frozen=True)
class LlamaCostModel:
    """Analytic per-program FLOPs / HBM-bytes for the llama serving
    programs.  ``matmul_params`` is the weight-matrix element count (the
    2-flops-per-param term); ``weight_bytes`` the tree as stored (int8
    leaves 1 B) — every program streams it once."""

    matmul_params: int
    weight_bytes: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    kv_elem_bytes: float  # bytes per cache element incl. scale overhead
    # Tensor-parallel collective geometry (tp == 1 -> no collectives):
    # hidden/vocab size the per-layer all-reduces and the logits
    # all-gather move, in the serving activation dtype.
    tp: int = 1
    hidden_size: int = 0
    vocab_size: int = 0
    act_bytes: int = 2
    # Batch (row) and sequence parallel degrees.
    dp: int = 1
    sp: int = 1

    @classmethod
    def for_model(cls, params, cfg, kv_quant: bool = False,
                  dtype_bytes: int = 2,
                  mesh_shape=None) -> "LlamaCostModel":
        from ..models.llama import matmul_param_count
        from ..models.quantization import quantized_bytes

        wbytes = quantized_bytes(params)
        hd = cfg.head_dim
        kv_eb = 1 + 4.0 / hd if kv_quant else float(dtype_bytes)
        if mesh_shape:
            tp = max(1, int(dict(mesh_shape).get("tp", 1)))
            dp = max(1, int(dict(mesh_shape).get("dp", 1)))
            sp = max(1, int(dict(mesh_shape).get("sp", 1)))
        else:
            tp, dp, sp = param_device_count(params), 1, 1
        return cls(
            matmul_params=matmul_param_count(cfg),
            weight_bytes=wbytes,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=hd,
            kv_elem_bytes=kv_eb,
            tp=tp,
            hidden_size=int(getattr(cfg, "hidden_size", 0)),
            vocab_size=int(getattr(cfg, "vocab_size", 0)),
            act_bytes=int(dtype_bytes),
            dp=dp,
            sp=sp,
        )

    def collective_bytes(self, rows: int, s: int = 1) -> dict[str, float]:
        """Per-device interconnect bytes one forward dispatch moves at
        tp > 1: the two all-reduces a layer of the ``[rows*s, hidden]``
        activations (``2(tp-1)/tp`` of the block each) and the logits
        all-gather (``(tp-1)/tp`` of ``[rows*s, vocab]`` f32).  Empty at
        tp == 1."""
        if self.tp <= 1:
            return {}
        tokens = float(rows) * float(s)
        block = tokens * self.hidden_size * self.act_bytes
        ar = 2.0 * self.num_layers * block * 2.0 * (self.tp - 1) / self.tp
        ag = tokens * self.vocab_size * 4.0 * (self.tp - 1) / self.tp
        return {"all_reduce": ar, "all_gather": ag}

    def _kv_bytes(self, rows: int, positions: float) -> float:
        """k+v cache traffic for ``rows`` rows over ``positions`` each."""
        return (
            2.0 * rows * positions * self.num_layers * self.num_kv_heads
            * self.head_dim * self.kv_elem_bytes
        )

    def decode(self, rows: int, window: int, s: int = 1
               ) -> tuple[float, float]:
        """One decode (``s=1``) or verify (``s`` positions/row) tick over
        ``rows`` cache rows attending ``window`` positions."""
        flops = 2.0 * self.matmul_params * rows * s
        flops += 4.0 * rows * s * window * self.num_heads * self.head_dim
        nbytes = self.weight_bytes + self._kv_bytes(rows, window)
        nbytes += self._kv_bytes(rows, s)  # fresh K/V written
        return flops, nbytes

    def prefill(self, rows: int, chunk: int, attended: float | None = None
                ) -> tuple[float, float]:
        """One prefill call: ``rows`` rows of ``chunk`` tokens each,
        attending ``attended`` mean positions (defaults to the causal
        mean over the chunk itself)."""
        if attended is None:
            attended = chunk / 2.0
        flops = 2.0 * self.matmul_params * rows * chunk
        flops += 4.0 * rows * chunk * attended * self.num_heads * self.head_dim
        nbytes = self.weight_bytes + self._kv_bytes(rows, chunk)
        nbytes += self._kv_bytes(rows, max(0.0, attended - chunk / 2.0))
        return flops, nbytes

    def superstep(self, rows: int, window: int, s: int, steps: int
                  ) -> tuple[float, float]:
        """One unified super-step dispatch: the wide ragged forward
        (``s`` positions/row) plus ``steps - 1`` chained single-position
        decode iterations under the same dispatch."""
        flops, nbytes = self.decode(rows, window, s)
        if steps > 1:
            f1, b1 = self.decode(rows, window, 1)
            flops += (steps - 1) * f1
            nbytes += (steps - 1) * b1
        return flops, nbytes

    def seed(self, tokens: int) -> tuple[float, float]:
        """Prefix-cache seed: a pure K/V copy — read + write, no flops."""
        return 0.0, 2.0 * self._kv_bytes(1, tokens)

    def sp_prefill(self, tokens: int) -> tuple[float, float]:
        """One ring-attention prefill pass over a ``tokens``-long padded
        prompt: the same total work as a fused prefill of the prompt."""
        return self.prefill(1, tokens)

    def ring_bytes(self, tokens: int) -> dict[str, float]:
        """Per-device bytes the sp ring rotation moves in one prefill
        pass (each device forwards its K/V shard ``sp - 1`` times a
        layer).  Empty at sp == 1."""
        if self.sp <= 1:
            return {}
        shard = float(tokens) / self.sp
        per_layer = (
            2.0 * shard * self.num_kv_heads * self.head_dim * self.act_bytes
        )
        return {
            "ring_permute": per_layer * self.num_layers * (self.sp - 1)
        }


# ---------------------------------------------------------------------------
# Facade the server wires together
# ---------------------------------------------------------------------------


# Tick kinds that run a forward (and so its collectives at tp > 1).
_FORWARD_KINDS = frozenset({"decode", "verify", "multistep", "prefill", "packed-prefill",
                            "superstep", "sp-prefill"})


class DeviceTelemetry:
    """One object per server process: ledger + observatory + cost model.

    Constructed only with ``--device-telemetry 1``; ``None`` everywhere
    otherwise, so the disabled path allocates nothing and every existing
    payload stays byte-for-byte."""

    def __init__(self, metrics=None,
                 readiness_budget_s: float = READINESS_BUDGET_S):
        self.peaks = detect_peaks()
        self.observatory = CompileObservatory(readiness_budget_s)
        self.observatory.install()
        self.ledger: HbmLedger | None = None
        self.cost: LlamaCostModel | None = None
        self._metrics = None
        # Last computed utilization per tick kind (the /debug/device
        # mirror of the gauges): written by the scheduler thread, read by
        # the /debug/device handler thread.
        self._util_lock = threading.Lock()
        self.last_util: dict[str, dict] = {}
        # What runs the engine's K-step or super-step tick (its program's
        # ``mode``, set at the engine's start), None without a program.
        self.program: str | None = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        """Hook the Prometheus families (present only when the registry
        was built with ``device_telemetry=True``)."""
        if getattr(metrics, "device_hbm_bytes", None) is None:
            return
        self._metrics = metrics
        self.observatory.set_metrics_hooks(
            on_compile=metrics.observe_compile,
            on_cache=metrics.observe_compile_cache,
        )

    def attach_model(self, params, cfg, max_slots: int,
                     kv_quant: bool = False, dtype_bytes: int = 2,
                     prefix_cache_budget_bytes: int = 0, mesh_shape=None,
                     tick_rows: int | None = None) -> None:
        """Build the ledger + cost model once the engine geometry is
        known; exports the per-component HBM gauges.  ``mesh_shape``: the
        rank's blocks (``params`` is its shard) and the collective walls;
        ``tick_rows``: the engine's widest tick (its activations, counted
        at a world above one rank)."""
        self.ledger = build_hbm_ledger(
            params, cfg, max_slots, kv_quant=kv_quant,
            dtype_bytes=dtype_bytes,
            prefix_cache_budget_bytes=prefix_cache_budget_bytes,
            mesh_shape=mesh_shape, tick_rows=tick_rows,
        )
        self.cost = LlamaCostModel.for_model(
            params, cfg, kv_quant=kv_quant, dtype_bytes=dtype_bytes, mesh_shape=mesh_shape,
        )
        self._export_ledger()

    def set_component(self, component: str, nbytes: int) -> None:
        """Set one measured ledger component (the engine's CUDA graph pool,
        after each capture) and re-export the gauges."""
        if self.ledger is None:
            return
        self.ledger.components[component] = int(nbytes)
        self._export_ledger()

    def _export_ledger(self) -> None:
        if self._metrics is None:
            return
        for comp, nbytes in self.ledger.components.items():
            self._metrics.observe_hbm_component(comp, nbytes)
        self._metrics.observe_hbm_component("total", self.ledger.device_total())

    def tick_util(self, kind: str, wall_s: float, flops: float,
                  hbm_bytes: float, tokens: float | None = None) -> dict:
        """Join one tick's wall with its program cost: MFU and HBM-BW
        utilization, clamped to (0, 1] (see the module docstring's error
        bars).  ``tokens``: the positions one rank's forward ran in the
        dispatch (rows x positions x steps), which size its collectives at
        tp > 1.  Returns the dict merged onto the recorder tick."""
        wall = max(wall_s, 1e-9)
        mfu = min(1.0, flops / wall / self.peaks.flops_per_s)
        bw = min(1.0, hbm_bytes / wall / self.peaks.hbm_bytes_per_s)
        # 3 significant digits, NOT fixed decimals: a CPU dev tick's
        # 4e-7 MFU must stay > 0 (the in-(0,1] contract).
        util = {
            "mfu": float(f"{mfu:.3g}") if flops > 0 else 0.0,
            "hbm_bw_util": float(f"{bw:.3g}"),
        }
        if self.cost is not None and (self.cost.tp > 1 or kind == "sp-prefill") \
                and kind in _FORWARD_KINDS:
            # The dispatch's collective bytes over the link rate, by op.
            # Without the dispatch's own count, the tokens come back from
            # its flops as the reference does (2 x matmul params a token),
            # which also counts the attention at the padded window.
            if tokens is None:
                tokens = flops / max(1.0, 2.0 * self.cost.matmul_params)
            coll = self.cost.collective_bytes(tokens)
            if kind == "sp-prefill":
                # The ring's K/V shard forwards, the sp axis's collective
                # (a rank ran tokens / sp of the prompt's positions).
                coll = {**coll, **self.cost.ring_bytes(tokens * self.cost.sp)}
            total = 0.0
            for op, nbytes in coll.items():
                secs = nbytes / self.peaks.link_bytes_per_s
                total += secs
                if self._metrics is not None:
                    self._metrics.observe_collective(op, secs)
            util["collective_s"] = float(f"{total:.3g}")
        with self._util_lock:
            self.last_util[kind] = util
        if self._metrics is not None:
            self._metrics.observe_device_util(kind, mfu, bw)
        return util

    def snapshot(self) -> dict:
        """The ``GET /debug/device`` payload."""
        with self._util_lock:
            utilization = {k: dict(v) for k, v in self.last_util.items()}
        return {
            "peaks": {
                "device": self.peaks.kind,
                "source": self.peaks.source,
                "chips": self.peaks.chips,
                "flops_per_s": self.peaks.flops_per_s,
                "hbm_bytes_per_s": self.peaks.hbm_bytes_per_s,
                "hbm_bytes": self.peaks.hbm_bytes,
                "link_bytes_per_s": self.peaks.link_bytes_per_s,
            },
            "hbm": self.ledger.snapshot(self.peaks) if self.ledger else None,
            "utilization": utilization,
            "compile": self.observatory.snapshot(),
            "program": self.program,
        }
