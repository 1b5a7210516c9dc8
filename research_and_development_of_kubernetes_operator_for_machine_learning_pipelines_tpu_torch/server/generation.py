"""Continuous-batching text-generation engine (port of the JAX package's
``server/generation.py``, legacy single-admission tick).

The engine owns a ragged KV cache with a fixed number of rows ("slots").
A request is prefilled as batch 1 — the whole prompt right-padded to a
power-of-two bucket, or fixed-size chunks interleaved with decode ticks
(``prefill_chunk``) — and its K/V inserted into a free slot.  Every
scheduler tick runs ONE batched decode step over all slots at their own
positions; requests join and leave between ticks.  Inactive slots still
compute and write nothing.

Device work runs on the single scheduler thread, eagerly: the JAX
engine's jitted programs are plain functions here, and the cache is
updated in place where the reference donates it.  Decode reads only a
window bucket of the cache (``decode_window_bucket``); on the int8 cache
each layer's attention is the fused decode-attention kernel.

Sampling follows the reference's key discipline: each slot carries a
threefry key (``models/prng.py``), ``key(seed)`` for a seeded request and
``fold_in(boot_key, n)`` for the n-th request of this boot otherwise;
admission splits it once for the first token, and every sampling decode
tick splits every row's key once, so a seeded row draws the reference's
stream whatever its neighbours do.

Admission control: ``admission_queue_budget`` bounds the estimated
tokens (prompt + max_new) of queued-but-unadmitted requests; past it, and
while draining, ``submit``/``reserve_admission`` raise
:class:`EngineOverloaded` before anything is enqueued (the HTTP layer's
429).  ``begin_drain`` stops admissions and lets every submitted request
finish; ``drained`` says when none is left.

Radix prefix cache (``prefix_cache``, ``server/prefix_cache.py``): a
chunked admission looks its prompt up in whole chunks; a hit spends one
tick ("seed") copying the cached K/V into the batch-1 scratch cache at
each chunk's offset, and only the suffix is prefilled (its chunks run the
flash kernel at their offset).  Every full chunk of real prompt tokens
prefilled fresh is read back to the host and inserted, unless the tree
holds it already.  The reuse unit is the prefill chunk.

Self-speculative decoding (``speculative``, ``server/speculative.py``): a
greedy tick in which any slot has an n-gram draft runs ONE verify forward
(``llama.verify_ragged``, the decode kernel's chunk instance) over the
pending token and the drafts, and emits each slot's accepted draft prefix
plus the bonus token; the tokens are the plain greedy path's.  A tick
with a sampling slot, or with no draft, is the plain decode tick.

Packed multi-admission prefill (``prefill_batch`` > 1, chunked prefill
only): each admission reserves a cache row and its chunks are written into
that row directly; every scheduler iteration packs up to ``prefill_batch``
in-flight admissions' next chunks (capped by ``prefill_token_budget`` /
chunk when set) into ONE forward (``llama.prefill_chunks_ragged``, the
ragged instance of the flash kernel), padded with parked rows to a
power-of-two bucket.  A row whose chunk completes its prompt is finalized
in the same tick: its length, its sampling state and its first token.  A
radix-cached prefix is seeded straight into the reserved row, and fresh
full chunks are read back off it.

Fused multi-step decode (``decode_steps`` K in [2, 16]): when the
scheduler owes nothing else (no admission in flight or queued, no draft
in hand), a BURST runs K decode steps a dispatch (``llama.decode_multistep``
with the sampling chain and the EOS latch on the device), and harvests
each dispatch's token block one tick late, after the next dispatch is
in flight.  On the card every dispatch replays a CUDA graph captured at
start for its (window, token rule) (``server/cuda_graphs.py``); the
window is pre-picked to cover every row's length + K - 1.  K = 1 is the
single-step tick.

Unified ragged super-step (``unified_step``): EVERY tick is one dispatch,
``llama.super_step_ragged`` over per-row roles: each occupied slot decodes
(K steps, the sampling chain and the EOS latch on the device) or, on an
all-greedy tick with a draft in hand, verifies; up to the packed budget of
in-flight packed admissions ride the same dispatch as prefill rows, and
the rows whose chunk completes their prompt are finalized inside it (their
sampling state, length and first token).  The block is one static width,
``max(draft_tokens + 1, prefill_chunk)`` (at most the verify chunk kernel's
256 positions), and each row tells the kernel how many of its columns are
live.  On the card every tick replays a CUDA graph captured at start for
its (window, token rule); the tick's inputs are host arrays, read back
synchronously.  The split engine's decode, verify, multistep and
packed-prefill programs are never built or run; seeds stay their own op.

Observability and containment (each off unless given; off, the loop is
the one without them): ``recorder`` (``server/flight_recorder.py``)
journals every tick (kind, wall, active slots, batch fill, tokens,
accepted drafts, a fused tick's ``steps``, a super-step's ``roles``) and
each request's lifecycle events, and completes each request's
:class:`RequestTrace` (``submit(trace=)``, per-token timestamps; a fused
tick spreads its tokens across its wall); ``telemetry``
(``server/device_telemetry.py``) joins each tick's analytic cost with its
wall into MFU and HBM-bandwidth shares, and observes the start-up kernel
builds and graph captures.  With either on, and only then, prefill and
seed ticks wait for the card before their wall is read; the K-step burst
keeps its lag-1 harvest.  ``watchdog`` (``server/watchdog.py``) is beaten
at every loop iteration with the tick kind about to run, armed after the
capture at start (disarmed around a recapture) and disarmed at shutdown.
Poison quarantine is always on: a prompt whose admission crashed the
engine twice (``POISON_CRASH_THRESHOLD``; the chunked, whole-prompt,
restore and packed admission handlers count, a decode crash never) is
refused by ``submit`` with :class:`PoisonRequest` (``on_poison``:
``quarantined`` / ``rejected``).

Hooks (all optional, called on the scheduler thread): ``on_step`` per
decode or verify tick and idle pass, ``on_tokens``/``on_itl`` per emitted
token, ``on_ttft``, ``on_admission_wait``, ``on_request_tokens`` per
finished request, ``on_tick``/``on_dispatch`` per device dispatch
(preemption's evict and restore included),
``on_prefix_hit`` (cached tokens) per warm admission, ``on_prefix_evict``
per chunk the first tier evicts, ``on_prefix_l2`` (``hit``/``spill``/
``evict``) per second-tier event, ``on_prefill_batch`` (real chunks) per
packed forward, ``on_spec`` (proposed, accepted) per
slot with a draft in a verify tick, ``on_shed`` per refused request (on
the submitting thread); ``submit(on_token=...)`` streams one request's
tokens and ``submit(trace=...)`` (a :class:`RequestTrace`) counts its
prefill chunks, cached tokens and draft tokens and times it.

SLO classes (``slo_class``, or ``preemption``, which needs them): each
request carries ``interactive``, ``batch`` or ``best-effort``; the
scheduler drains the transport queue into one deque a class and admits
the highest class first (FIFO within a class), and a lower class sheds
at a fraction of the admission budget (reason ``class_<name>``).
``reserve_admission(model=)`` bounds each model holding outstanding work
by an equal share of the budget (reason ``model_budget``).  Mid-decode
preemption (``preemption``, radix prefix cache required): when a higher
class waits with every slot taken, one lower-class slot a scheduler
iteration is evicted at a tick boundary (the lowest class, then the
least progress, then the lowest index).  Its committed K/V is read off
the card, its whole chunks written back through the prefix cache, and
the host copies, the key row and the pending token ride a record at the
front of its class; the restore seeds the row from the cache where the
chunks survived, else from the copies, and writes the length, pending
token, key row (no split) and sampling rows in place.  No token is
generated twice (``preempt_recomputed_tokens`` stays 0); ``on_preempt``
(``evict``/``restore``) per event.

Control ops and the KV handoff: ``run_control(fn)`` runs ``fn`` on the
scheduler thread at the next admission phase (a ``_Wake`` item unblocks an
idle scheduler; every scheduler loop drains the ops there: the split tick,
the packed path, the K-step burst once its harvest is in, the super tick),
and fails them with :class:`EngineShutdown` at shutdown.  With the prefix
cache on, ``export_prefix_kv`` reads a prompt's whole-chunk prefix out of
the radix cache and ``import_prefix_kv`` inserts handed-off chunks into
it, journalled as one ``kv-import`` tick; both run as control ops, since
the radix cache is the scheduler's alone.  An import stops at a chunk
whose parent path the cache has meanwhile evicted.

Tensor and data parallelism (``mesh_shape`` with ``tp`` and/or ``dp`` above
1): one process a rank, each holding its block of the weights and of the
KV cache (``models/partition.py``) and running the sharded forward
(``models/llama.py``, ``mesh=``).  Rank 0 leads: its engine runs the
scheduler and hands every device op to ``channel`` (a
``server/multihost.UnitChannel``), which broadcasts the op's host inputs
before running it (``OP_GEN_*``); every other rank's engine is never
started and repeats each op through its ``replay_*`` method
(``multihost.follower_loop``).  Sampling state is replicated, so the host
truth of every slot is the same on every rank; a seed carries the whole
heads' K/V and each rank takes its own, and a read for the prefix cache
gathers the heads (and the owning dp shard's row) back.  Under dp > 1
``_free_slot`` admits into the least-loaded block of cache rows.  A failed
op on the leader broadcasts ``OP_GEN_RESET``.  Not yet ported (it raises
``ValueError`` at construction, before any device state): on CUDA the
graph-replayed paths (``decode_steps`` > 1, ``unified_step``) at a world
above one rank, whose gloo collectives no CUDA graph captures.

Sequence parallelism (``sp`` > 1, a power of two no larger than the
smallest prompt bucket, dividing the prefill chunk): a cold prompt of at
least ``sp_prefill_threshold`` tokens (no radix-cached prefix) prefills in
ONE ring-attention pass over its bucket, the sequence split over the sp
ranks (``llama.prefill_ring``, ``OP_GEN_SP_PREFILL``; a ``sp-prefill``
tick), writes its whole chunks back into the radix cache and inserts
through the scratch like a chunked admission.  Decode runs replicated over
sp.  Every other prompt keeps its path; ``{"sp": 1}`` is the engine
without a mesh.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..models import llama
from ..models import partition
from ..models import prng
from ..models.sampling import sample_chain_step, speculative_accept
from ..ops.decode_attention import MAX_VERIFY_S
from ..parallel.collectives import all_gather_concat, psum
from .batching import next_bucket
from .cuda_graphs import MultistepProgram, SuperstepProgram
from .flight_recorder import RequestTrace
from .multihost import (
    OP_GEN_ADMIT,
    OP_GEN_CHUNK,
    OP_GEN_CHUNKS,
    OP_GEN_INSERT,
    OP_GEN_MULTISTEP,
    OP_GEN_READ,
    OP_GEN_RESET,
    OP_GEN_RESTORE,
    OP_GEN_SEED,
    OP_GEN_SEED_SLOT,
    OP_GEN_SP_PREFILL,
    OP_GEN_STEP,
    OP_GEN_SUPERSTEP,
    OP_GEN_VERIFY,
    encode_message,
    note_op,
)
from .prefix_cache import RadixPrefixCache
from .speculative import DraftState, draft_chain, pad_to_chain, propose_ngram

_log = logging.getLogger("tpumlops_torch.generation")


class EngineShutdown(RuntimeError):
    """The engine shut down before this request's admission completed."""


class EngineOverloaded(RuntimeError):
    """Admission shed: the request was refused at the door (nothing was
    enqueued), because its estimated tokens would push the queued backlog
    past the admission budget (``reason="budget"``, or ``class_<name>`` at
    its class's fraction of it, or ``model_budget`` past its model's
    share) or because the engine is draining (``reason="draining"``).  The
    HTTP layer answers 429 with a ``Retry-After`` of ``retry_after_s`` and
    names ``slo_class`` (None while classes are off)."""

    def __init__(self, message: str, reason: str = "budget",
                 retry_after_s: int = 1, slo_class: str | None = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = int(retry_after_s)
        self.slo_class = slo_class


class PoisonRequest(ValueError):
    """The request's prompt fingerprint is quarantined: its admission
    crashed the engine twice, and each crash failed every in-flight
    sequence and reset the device state.  Refused synchronously by
    :meth:`GenerationEngine.submit`; the HTTP layer answers 422 (the prompt
    would crash any replica, so no ``Retry-After``)."""

    def __init__(self, fingerprint: str, crashes: int):
        super().__init__(
            f"prompt quarantined: admission crashed the engine {crashes} "
            f"times (fingerprint {fingerprint})"
        )
        self.fingerprint = fingerprint
        self.crashes = int(crashes)


def _safe_resolve(fut: Future, value) -> None:
    try:
        fut.set_result(value)
    except Exception:  # InvalidStateError: client cancelled in the gap
        pass


def _safe_fail(fut: Future, exc: Exception) -> None:
    try:
        fut.set_exception(exc)
    except Exception:
        pass


class _Wake:
    """Queue item that only unblocks the scheduler's idle wait (a control op
    arrived): it carries no request and is never the None shutdown
    sentinel."""


_WAKE = _Wake()

# SLO priority classes, highest first: a higher class drains first from
# the admission queue and, under preemption, may evict a lower one.
SLO_CLASSES = ("interactive", "batch", "best-effort")
_CLASS_PRIORITY = {name: i for i, name in enumerate(reversed(SLO_CLASSES))}
# The fraction of the admission budget a class may fill before its
# submissions shed (reason "class_<name>"): lower classes leave the
# headroom to interactive traffic.
_CLASS_BUDGET_FACTOR = {"interactive": 1.0, "batch": 0.75, "best-effort": 0.5}

_MIN_BUCKET = 16


def prefill_bucket(length: int, capacity: int) -> int:
    """Power-of-two prompt bucket (>= _MIN_BUCKET, <= cache capacity)."""
    return min(max(_MIN_BUCKET, next_bucket(length, capacity)), capacity)


def decode_window_bucket(length: int, capacity: int) -> int:
    """Attention-window bucket: smallest of {2^k, 3*2^(k-1)} >= length.

    Decode attention cost is linear in the attended window, so the 1.5x
    steps (96, 192, 384, ...) cap the overshoot at 33%.  The decode
    kernel takes every bucket width."""
    w = prefill_bucket(length, capacity)
    if length > 0 and w >= 2 * _MIN_BUCKET and w & (w - 1) == 0:
        threeq = 3 * (w // 4)
        if length <= threeq:
            return threeq
    return w


def decode_window_buckets(capacity: int) -> list[int]:
    """Every window :func:`decode_window_bucket` can return, ascending."""
    out = {min(capacity, _MIN_BUCKET)}
    b = _MIN_BUCKET
    while b < capacity:
        out.add(b)
        if 2 * b <= capacity:
            out.add(3 * (b // 2))
        b *= 2
    out.add(capacity)
    return sorted(out)


def superstep_window(decode_hi: int, other_hi: int, steps: int, capacity: int) -> int:
    """The window of a unified super-step dispatch: one static window serves
    every row of the tick, so it covers each role's worst case, a decode row
    at next-write position ``decode_hi`` attending up to ``decode_hi +
    steps - 1`` by its last fused step, a verify or prefill row strictly
    below its length or offset (``other_hi``, their max)."""
    need = max(1, decode_hi + (steps - 1) if decode_hi > 0 else 1, other_hi)
    return decode_window_bucket(min(need, capacity), capacity)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; no card and no explicit
    request is an error, never a quiet run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class _Slot:
    future: Future
    remaining: int  # new tokens still to produce
    eos_id: int | None
    sampling: bool = False  # temperature > 0 (selects the sampling step)
    on_token: Callable[[int], None] | None = None  # streaming callback
    prompt_len: int = 0  # for the decode attention window
    generated: list[int] = field(default_factory=list)
    t_last_token: float = 0.0  # perf_counter of the last emitted token (ITL)
    request_id: str = ""
    trace: RequestTrace | None = None  # the request's timing and counts
    # Speculation only (None / 0 otherwise): prompt + generated tokens,
    # appended in place (the drafter's context, no per-tick concatenation;
    # validate() caps prompt + max_new at capacity), and the slot's
    # adaptive draft budget.
    history: np.ndarray | None = None  # int64 [capacity]; valid: [:hist_len]
    hist_len: int = 0
    draft: DraftState | None = None
    # SLO classes (defaults while they are off); under preemption also the
    # prompt and the sampling parameters, so an evicted slot is rebuilt
    # exactly on restore.
    slo_class: str = "interactive"
    prompt: np.ndarray | None = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


@dataclass
class _Request:
    prompt: np.ndarray  # int32 [L]
    max_new_tokens: int
    eos_id: int | None
    future: Future
    temperature: float = 0.0  # <= 0: greedy
    top_k: int = 0  # <= 0: disabled
    top_p: float = 1.0  # >= 1: disabled
    seed: int | None = None  # None: engine-assigned (boot-key fold_in)
    on_token: Callable[[int], None] | None = None  # streaming callback
    t_submit: float = 0.0  # perf_counter at submit (admission wait, TTFT)
    # Estimated tokens (prompt + max_new) held against the admission
    # budget while queued; released once, at dequeue.
    est_tokens: int = 0
    request_id: str = ""
    trace: RequestTrace | None = None
    slo_class: str = "interactive"


@dataclass(eq=False)  # identity semantics: numpy fields
class _Preempted:
    """An evicted mid-decode sequence waiting to be restored: what resumes
    it exactly where the eviction cut it.  The committed K/V as host chunk
    pairs (the prefix cache holds the whole ones too, but a later
    admission may evict them first), the key row (the threefry carry, not
    split again), the pending token (``generated[-1]``, emitted but not
    fed) and the slot's bookkeeping.  It waits at the front of its class
    deque, beside queued :class:`_Request` items."""

    future: Future
    remaining: int
    eos_id: int | None
    sampling: bool
    on_token: Callable[[int], None] | None
    prompt: np.ndarray
    generated: list[int]
    slo_class: str
    temperature: float
    top_k: int
    top_p: float
    key: torch.Tensor  # int64 [2] on the host: the slot's key row at eviction
    chunks: list  # host (k, v) pairs [L, 1, C, NKV, D] covering [0, hist)
    hist: int  # committed positions: prompt + generated - 1
    history: np.ndarray | None
    hist_len: int
    draft: DraftState | None
    request_id: str
    trace: RequestTrace | None
    t_last_token: float
    # What the admission loop reads of a queued item: nothing reserved, no
    # admission-wait metric.
    est_tokens: int = 0
    t_submit: float = 0.0


@dataclass(eq=False)  # identity semantics: numpy fields
class _PrefillProgress:
    """A chunked admission in flight.  Single-admission mode holds at most
    one and threads the batch-1 scratch cache; packed mode holds a queue of
    them, each with a reserved cache row (``slot``) its chunks are written
    into.  With a radix-cached prefix (``cached_tokens`` > 0), ``chunks``
    covers only the uncached suffix: the prefix's K/V (``cached_kv``, one
    host pair a chunk) is seeded by one tick and never re-prefilled."""

    req: _Request
    chunks: list  # padded [1, C] int32 arrays (the uncached suffix)
    next_idx: int = 0
    cached_tokens: int = 0
    cached_kv: list = field(default_factory=list)
    seeded: bool = False
    slot: int = -1  # packed mode: the reserved cache row (-1: the scratch)


# Engine options of the reference that this port does not have yet (none
# left: the mesh's unported axis and paths are refused in the constructor).
_NOT_PORTED: dict = {}


def pick_free_slot(slots: Sequence, reserved, dp: int) -> int | None:
    """The cache row an admission takes: the first free row, or under dp > 1
    a free row of the least-loaded dp block of ``len(slots) / dp``
    contiguous rows (ties to the lowest index), so admissions spread over
    the dp shards instead of parking every sequence on the first."""
    free = [i for i, s in enumerate(slots) if s is None and i not in reserved]
    if not free:
        return None
    if dp <= 1:
        return free[0]
    rows = len(slots) // dp

    def shard_load(shard: int) -> int:
        return sum(1 for i in range(shard * rows, (shard + 1) * rows)
                   if slots[i] is not None or i in reserved)

    return min(free, key=lambda i: (shard_load(i // rows), i))


# The host inputs of a super-step tick, in ``_device_superstep``'s order.
_SUPERSTEP_ARGS = ("ids", "roles", "offsets", "counts", "draft_len", "active", "remaining",
                   "eos_ids", "last_pos", "final_lens", "slot_keys", "r_temps", "r_tks",
                   "r_tps", "window", "sampling")


def _key_data(key: torch.Tensor | None):
    """A slot key as the channel carries it: its two words on the host."""
    return None if key is None else key.cpu().numpy()


class GenerationEngine:
    """Schedules concurrent generation requests onto one ragged KV cache.

    ``submit`` is thread-safe and returns a ``concurrent.futures.Future``
    resolving to the generated token ids (``np.ndarray[int32]``).  All
    tensor work happens on the single scheduler thread."""

    def __init__(
        self,
        params,
        cfg,
        *,
        max_slots: int = 4,
        dtype=None,
        eos_id: int | None = None,
        kv_quant: bool = False,
        prefill_chunk: int | None = None,
        device=None,
        admission_queue_budget: int = 0,
        on_step: Callable[[int, float, int, int], None] | None = None,
        on_tokens: Callable[[int], None] | None = None,
        on_admission_wait: Callable[[float], None] | None = None,
        on_ttft: Callable[[float], None] | None = None,
        on_itl: Callable[[float], None] | None = None,
        on_request_tokens: Callable[[int], None] | None = None,
        on_tick: Callable[[str, float], None] | None = None,
        on_shed: Callable[[str], None] | None = None,
        on_dispatch: Callable[[str], None] | None = None,
        prefill_batch: int | None = None,
        prefill_token_budget: int | None = None,
        on_prefill_batch: Callable[[int], None] | None = None,
        prefix_cache=None,  # PrefixCacheConfig | None
        on_prefix_hit: Callable[[int], None] | None = None,
        on_prefix_evict: Callable[[], None] | None = None,
        on_prefix_l2: Callable[[str], None] | None = None,
        speculative=None,  # SpeculativeConfig | None
        on_spec: Callable[[int, int], None] | None = None,
        decode_steps: int = 1,
        unified_step: bool = False,
        slo_class: str | None = None,  # the default class of a submission
        preemption: bool = False,  # mid-decode eviction of lower classes
        on_preempt: Callable[[str], None] | None = None,  # "evict" | "restore"
        recorder=None,  # flight_recorder.FlightRecorder | None
        telemetry=None,  # device_telemetry.DeviceTelemetry | None
        watchdog=None,  # watchdog.EngineWatchdog | None
        on_poison: Callable[[str], None] | None = None,  # "quarantined" | "rejected"
        mesh_shape=None,  # {"dp": D, "sp": S, "tp": T}: one rank of a world of D * S * T
        channel=None,  # multihost.UnitChannel: the leader's op broadcast
        sp_prefill_threshold: int = 1024,
    ):
        self._device = resolve_device(device)
        embed_dev = params["embed"].device
        if embed_dev.type != self._device.type:
            raise ValueError(
                f"params live on {embed_dev}, engine device is {self._device}"
            )
        self._cfg = cfg
        self._eos_default = eos_id
        self.max_slots = int(max_slots)
        self._channel = channel
        # A leader's device ops by kind: [count, total s, max s] (broadcast
        # included), the counterpart of a follower loop's stats.
        self.op_stats: dict[str, list] = {}
        self._mesh = None
        self._dp = 1
        # sp > 1: a cold prompt of at least sp_prefill_threshold tokens
        # prefills in ONE ring-attention pass, the sequence split over sp
        # (llama.prefill_ring), then inserts through the scratch path.
        self._sp = 1
        self._sp_threshold = int(sp_prefill_threshold)
        if mesh_shape and partition.mesh_device_count(mesh_shape) > 1:
            chunk = prefill_chunk or (prefix_cache.chunk_tokens if prefix_cache is not None
                                      and prefix_cache.enabled else None)
            params = self._init_mesh(params, cfg, dict(mesh_shape), decode_steps, unified_step,
                                     chunk)
        self._params = params
        self.capacity = int(cfg.max_seq)
        self._dtype = dtype or torch.bfloat16
        self._kv_quant = bool(kv_quant)
        if int(admission_queue_budget) < 0:
            raise ValueError(
                f"admission_queue_budget must be >= 0, got {admission_queue_budget}"
            )
        self._admission_budget = int(admission_queue_budget)
        # (active_slots, step_seconds, queue_depth, admitting) per decode
        # tick and idle pass: queue_depth counts queued-but-unadmitted
        # requests, admitting the admissions mid-prefill.
        self.on_step = on_step
        self.on_tokens = on_tokens  # (1,) per token delivered
        self.on_admission_wait = on_admission_wait  # submit -> admission s
        self.on_ttft = on_ttft  # submit -> first token s
        self.on_itl = on_itl  # s between a request's consecutive tokens
        self.on_request_tokens = on_request_tokens  # tokens of a finished request
        self.on_tick = on_tick  # (kind, wall s) per device dispatch
        self.on_shed = on_shed  # reason of a refused request
        self.on_dispatch = on_dispatch  # kind per device dispatch
        # Flight recorder and device telemetry, None by default: every
        # hook below is guarded.  With either on, prefill and seed ticks
        # wait for the card before their wall is read (a wall of the
        # launches alone would charge the device time to the next tick,
        # and read as an absurd MFU); nothing else syncs for them.
        self._recorder = recorder
        self._telemetry = telemetry
        self._sync_ticks = recorder is not None or telemetry is not None
        # Scheduler watchdog, None by default.  An idle scheduler blocks
        # in the queue's get and beats once a poll, so the poll halves
        # under the deadline: quiet time must never read as a stall.
        self._watchdog = watchdog
        self._idle_poll_s = min(1.0, watchdog.deadline_s / 2.0) if watchdog is not None else 1.0
        if watchdog is not None:
            watchdog.slot_inventory = self._slot_inventory
        # Held by the scheduler for each iteration's admission and tick, so
        # another thread can run between two ticks (``between_ticks``); the
        # turnstile, passed before each iteration, lets a waiting holder in
        # ahead of the next one.
        self._tick_gate = threading.Lock()
        self._turnstile = threading.Lock()
        # Poison quarantine: crash counts by prompt fingerprint, and the
        # fingerprints past the threshold that submit refuses.
        self._poison_counts: dict[str, int] = {}
        self._quarantined: dict[str, int] = {}
        self._poison_lock = threading.Lock()
        self._on_poison = on_poison
        self.poison_quarantined_total = 0
        self.poison_rejected_total = 0
        self._prefill_chunk_size = int(prefill_chunk) if prefill_chunk else None
        # Radix prefix cache: the reuse unit IS the prefill chunk, so the
        # cache turns chunked prefill on at chunk_tokens when no chunk is
        # set, and a chunk that differs is refused.
        prefix_enabled = prefix_cache is not None and prefix_cache.enabled
        if prefix_enabled:
            ct = int(prefix_cache.chunk_tokens)
            if ct <= 0:
                raise ValueError(f"prefixCache.chunkTokens must be positive, got {ct}")
            if self._prefill_chunk_size is None:
                self._prefill_chunk_size = ct
            elif self._prefill_chunk_size != ct:
                raise ValueError(
                    f"prefixCache.chunkTokens {ct} must equal prefillChunk "
                    f"{self._prefill_chunk_size}: the prefill chunk is the "
                    "prefix reuse unit"
                )
        if self._prefill_chunk_size is not None:
            C = self._prefill_chunk_size
            if C <= 0:
                raise ValueError(f"prefill_chunk must be positive, got {C}")
            if self.capacity % C != 0:
                raise ValueError(
                    f"prefill_chunk {C} must divide KV capacity {self.capacity}"
                )
        # Packed multi-admission prefill: up to prefill_batch in-flight
        # admissions' next chunks in ONE forward, so the weight stream a
        # chunk forward pays is shared.  1 (the default) is the
        # single-admission pipeline.
        self._prefill_batch = 1 if prefill_batch is None else int(prefill_batch)
        if self._prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, got {prefill_batch}")
        if self._prefill_batch > 1 and self._prefill_chunk_size is None:
            raise ValueError(
                "prefill_batch > 1 requires chunked prefill: set "
                "prefillChunk (or enable prefixCache, which implies it)"
            )
        # More concurrent admissions than cache rows cannot exist.
        self._prefill_batch = min(self._prefill_batch, self.max_slots)
        self._prefill_token_budget = int(prefill_token_budget or 0)
        if self._prefill_token_budget < 0:
            raise ValueError(
                f"prefill_token_budget must be >= 0, got {prefill_token_budget}"
            )
        self._packed = self._prefill_batch > 1
        self._on_prefill_batch = on_prefill_batch
        self._on_prefix_hit = on_prefix_hit
        self._on_prefix_evict = on_prefix_evict
        self._on_prefix_l2 = on_prefix_l2
        self._prefix_cache = None
        if prefix_enabled:
            self._prefix_cache = RadixPrefixCache(
                budget_bytes=int(prefix_cache.budget_bytes),
                chunk_tokens=self._prefill_chunk_size,
                on_evict=self._note_prefix_evict,
                l2_budget_bytes=int(prefix_cache.l2_budget_bytes),
                on_l2_event=self._note_prefix_l2,
            )
        # SLO classes and mid-decode preemption, both off by default; off,
        # no class deque exists, _dequeue is the queue's get and a slot
        # records nothing more.  Classes arm with a default class or with
        # preemption (which picks its victims by class).
        if slo_class is not None and slo_class not in SLO_CLASSES:
            raise ValueError(f"slo_class must be one of {SLO_CLASSES}, got {slo_class!r}")
        self._slo_default = slo_class
        self._classes = slo_class is not None or bool(preemption)
        self._class_queues: dict[str, deque] | None = None
        if self._classes:
            self._class_queues = {name: deque() for name in SLO_CLASSES}
        self._preemption = bool(preemption)
        if self._preemption and self._prefix_cache is None:
            raise ValueError(
                "preemption requires the radix prefix cache "
                "(prefixCache.enabled): evicted slots write their K/V "
                "back through it and restore from the same chunks"
            )
        self._on_preempt = on_preempt
        self.preemptions = 0
        self.preempt_restores = 0
        # Tokens a restored sequence generated again: 0 by construction (the
        # pending token and the key row travel with the record).
        self.preempt_recomputed_tokens = 0
        # Self-speculative n-gram decoding; None is the plain tick.  The
        # reference compiles a verify program per (draft length, window)
        # at warmup; the port runs eagerly, so there is nothing to warm.
        self._spec = None
        self._spec_chain: tuple[int, ...] = ()
        self._on_spec = on_spec
        if speculative is not None and speculative.enabled:
            dt = int(speculative.draft_tokens)
            if dt < 1:
                raise ValueError(f"speculative.draftTokens must be >= 1, got {dt}")
            if not (1 <= int(speculative.ngram_min) <= int(speculative.ngram_max)):
                raise ValueError(
                    "speculative ngram bounds must satisfy 1 <= ngramMin <= ngramMax, "
                    f"got [{speculative.ngram_min}, {speculative.ngram_max}]"
                )
            self._spec = speculative
            self._spec_chain = draft_chain(dt)
        # Fused multi-step decode: K decode steps a dispatch, chained on
        # the device, harvested one tick late.  1 is the single-step tick.
        self._decode_steps = 1 if decode_steps is None else int(decode_steps)
        if not (1 <= self._decode_steps <= 16):
            raise ValueError(f"decode_steps must be in [1, 16], got {decode_steps}")
        self._fused = self._decode_steps > 1
        # Unified ragged super-step: every tick one dispatch of decode,
        # verify and packed-prefill rows.  Its static block width is the
        # largest verify chain and the prefill chunk (1 with neither); the
        # verify chunk kernel it runs takes at most MAX_VERIFY_S.
        self._unified = bool(unified_step)
        sw = 1
        if self._spec is not None:
            sw = max(sw, int(self._spec.draft_tokens) + 1)
        if self._packed:
            sw = max(sw, int(self._prefill_chunk_size))
        self._super_width = sw
        if self._unified and sw > MAX_VERIFY_S:
            raise ValueError(
                f"unified_step: the super-step width max(draftTokens + 1, prefillChunk) = "
                f"{sw} exceeds the {MAX_VERIFY_S} chunk positions the verify chunk kernel "
                "takes; use a prefillChunk of at most 256 or the split engine"
            )
        # The graph program: the super-step on a unified engine, the fused
        # multi-step burst on a split one with K > 1, else none.
        self._program: MultistepProgram | SuperstepProgram | None = None
        self._capture = False  # graphs wanted (a started CUDA engine)
        # Device dispatches by tick kind, as the reference keeps them.
        self.dispatches_total: dict[str, int] = {}
        self.tokens_generated = 0
        self.prefill_forwards = 0  # whole-prompt prefills + chunk forwards
        self.prefill_chunks_dispatched = 0  # chunks run by packed forwards
        self.decode_forwards = 0  # decode and verify ticks
        self.prefix_hits = 0
        self.prefix_cached_tokens = 0
        self.prefix_evictions = 0
        self.spec_verify_ticks = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.sample_steps = 0  # sampling-chain steps run on the device
        self._slots: list[_Slot | None] = [None] * self.max_slots
        self._pending: list[_PrefillProgress] = []
        self._reserved: set[int] = set()  # packed mode: rows of admissions in flight
        self._seq_state = None  # (last_logits, seq KVCache) of a chunked admission
        # Engine-assigned keys fold a counter into a per-boot key, so
        # unseeded streams never collide with a user's key(seed) stream
        # and never replay across restarts.  Not reset by recovery.
        self._boot_key = prng.key(int.from_bytes(os.urandom(7), "little"),
                                  self._device)
        self._seed_counter = 0
        # Admission control (see reserve_admission): all under _adm_lock.
        self._adm_lock = threading.Lock()
        self._queued_est_tokens = 0
        self._model_est: dict[str, int] = {}  # model -> outstanding estimate
        self._inflight_reqs = 0  # submitted futures not yet done
        self._draining = False
        self.shed_total = 0
        self._queue: queue.Queue[_Request | _Wake | None] = queue.Queue()
        # (fn, future) pairs run on the scheduler thread (run_control).
        self._control_ops: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if telemetry is not None:
            telemetry.attach_model(
                params, cfg, self.max_slots, kv_quant=self._kv_quant,
                dtype_bytes=self._dtype.itemsize,
                prefix_cache_budget_bytes=int(prefix_cache.budget_bytes) if prefix_enabled else 0,
                mesh_shape=self._mesh.shape if self._mesh is not None else None,
            )
        self._reset_device_state()

    def _init_mesh(self, params, cfg, mesh_shape: dict, decode_steps, unified_step, chunk):
        """Check a mesh of several ranks (typed errors, before any device
        state), build this rank's ``ServingMesh`` and return its block of the
        parameters (a full tree is cut here; the loader's block passes)."""
        bad = {a: int(n) for a, n in mesh_shape.items()
               if a not in ("dp", "sp", "tp") and int(n) > 1}
        if bad:
            raise ValueError(
                "the generation engine shards over dp/sp/tp only; meshShape axes "
                f"{bad} must be 1 (no pipeline or expert parallelism exists here)"
            )
        dp = partition.dp_degree(mesh_shape)
        if dp > 1 and self.max_slots % dp:
            raise ValueError(
                f"meshShape dp={dp} does not divide maxSlots {self.max_slots}: the ragged "
                "cache's row axis shards over dp in equal blocks"
            )
        partition.validate_llama_mesh(cfg, mesh_shape)
        partition.validate_mesh_for_model(mesh_shape, prefill_chunk=chunk)
        sp = partition.sp_degree(mesh_shape)
        if sp > 1 and (sp & (sp - 1) or sp > _MIN_BUCKET):
            raise ValueError(
                f"meshShape sp={sp} must be a power of two <= {_MIN_BUCKET} so every "
                "prefill bucket divides evenly across the ring"
            )
        if self._device.type == "cuda" and ((decode_steps or 1) > 1 or unified_step):
            raise ValueError(
                "decode_steps > 1 and unified_step replay CUDA graphs, and graph capture "
                "across ranks is not yet ported: at a world above one rank the gloo "
                "collectives run on the host, where no graph captures them"
            )
        from ..parallel import build_mesh

        self._mesh = build_mesh(mesh_shape)
        self._dp = self._mesh.dp
        self._sp = self._mesh.sp
        if params["embed"].shape[0] == cfg.vocab_size and self._mesh.tp > 1:
            params = partition.shard_llama_params(params, self._mesh)
        return params

    def _reset_device_state(self) -> None:
        """(Re)allocate the KV cache, the per-slot token and sampling state
        and, on a fused engine, the multi-step program over the new cache
        (its graphs captured again once the engine has started) — also the
        recovery path after a failed step, whose in-place writes may have
        left the cache half-updated."""
        dev = self._device
        if self._kv_quant:
            self._cache = llama.QuantRaggedKVCache.create(self._cfg, self.max_slots, dev,
                                                          self._mesh)
        else:
            self._cache = llama.RaggedKVCache.create(
                self._cfg, self.max_slots, self._dtype, dev, self._mesh
            )
        self._tokens = torch.zeros((self.max_slots, 1), dtype=torch.int64, device=dev)
        self._temps = torch.zeros((self.max_slots,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((self.max_slots,), dtype=torch.int32, device=dev)
        self._topp = torch.ones((self.max_slots,), dtype=torch.float32, device=dev)
        self._keys = prng.split(prng.key(0, dev), self.max_slots)  # [slots, 2]
        # A new cache: graphs of the old one would write freed memory.
        if self._program is not None:
            self._program.drop()
            self._program = None
        if self._unified:
            self._program = SuperstepProgram(self._params, self._cfg, self._cache,
                                             self._decode_steps, self._super_width,
                                             self._dtype, dev, self._mesh)
            self._bind_program_state()
        elif self._fused:
            self._program = MultistepProgram(self._params, self._cfg, self._cache,
                                             self._decode_steps, self._dtype, dev, self._mesh)
        if self._program is not None and self._capture:
            self._capture_graphs()

    def _bind_program_state(self) -> None:
        """The unified engine's device state IS the super-step program's
        buffers: the engine's tensors are copied in first where one is not
        the buffer (a tensor an admission replaced, such as
        ``insert_sequence``'s lengths), then the engine points at them."""
        prog = self._program
        prog.load_state(self._tokens, self._cache.lengths, self._keys, self._temps,
                        self._topk, self._topp)
        self._tokens, self._keys = prog.tokens, prog.keys
        self._temps, self._topk, self._topp = prog.temps, prog.topk, prog.topp
        self._cache = prog.cache

    def _capture_graphs(self) -> None:
        """One graph per window bucket and token rule, on all-inactive rows
        or a parked super-step (what the reference's warmup sweep
        compiles)."""
        prog = self._program
        windows = decode_window_buckets(self.capacity)
        kind = "multistep"
        if self._unified:
            prog.stage(*self._parked_superstep())
            kind = "superstep"
        on_graph = None
        if self._telemetry is not None:
            obs = self._telemetry.observatory

            def on_graph(seconds: float) -> None:
                obs.on_event("compile", seconds, op=kind)
        # A recapture (recovery) blocks the running scheduler for seconds:
        # not a stall, so the watchdog is disarmed around it.
        wd = self._watchdog if self._thread is not None else None
        if wd is not None:
            wd.disarm()
        try:
            prog.capture(windows, on_graph=on_graph)
        finally:
            if wd is not None:
                wd.arm()
        if self._telemetry is not None:
            self._telemetry.set_component("cuda_graph_pool",
                                          prog.pool_bytes("allocated_size"))
        _log.info("captured %d %s graphs (K=%d) in %.2f s; pool %.1f MiB",
                  len(prog.graphs), kind, self._decode_steps, prog.capture_s,
                  prog.pool_bytes() / 2**20)

    # -- lifecycle -----------------------------------------------------------

    def start(self, warmup: bool = True) -> None:
        """Start the scheduler thread.  ``warmup`` builds the CUDA kernels
        first (nothing to compile on the CPU), so no request pays nvcc.
        A fused or unified engine on the card captures its graphs here,
        warm-up or not: a capture on first use would stall every stream.
        It admits no prompt, so nothing reads or fills the prefix cache
        before the first request."""
        obs = self._telemetry.observatory if self._telemetry is not None else None
        if obs is not None:
            obs.begin_warmup()  # the builds and the capture: the start-up's cost
        if warmup and self._device.type == "cuda":
            from ..ops import _build

            _build.build()
        if self._program is not None and self._device.type == "cuda":
            self._capture = True
            self._capture_graphs()
        if obs is not None:
            obs.end_warmup()
        if self._watchdog is not None:
            # Armed after the capture: it blocks far past a tick deadline.
            self._watchdog.arm()
            self._watchdog.start()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="generation-scheduler"
        )
        self._thread.start()

    def _beat(self, kind: str | None = None) -> None:
        """One scheduler heartbeat, stamped with the tick kind about to run
        (a no-op without a watchdog)."""
        if self._watchdog is not None:
            self._watchdog.beat(kind)

    def _slot_inventory(self) -> list:
        """What is in flight, for the watchdog's stall event (called on
        the monitor thread while the scheduler is wedged: its reads race
        the scheduler's last writes, which the watchdog tolerates)."""
        inv = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            inv.append({
                "slot": i,
                "request_id": slot.request_id,
                "prompt_len": int(slot.prompt_len),
                "generated": len(slot.generated),
                "remaining": int(slot.remaining),
            })
        for prog in list(self._pending):
            inv.append({
                "slot": int(prog.slot),
                "request_id": prog.req.request_id,
                "prompt_len": int(prog.req.prompt.size),
                "generated": 0,
                "remaining": int(prog.req.max_new_tokens),
                "admitting": True,
            })
        return inv

    def shutdown(self) -> None:
        if self._watchdog is not None:
            # Disarmed before the join: teardown stops beating, and an
            # escalation mid-shutdown would turn a drain into an exit.
            self._watchdog.disarm()
            self._watchdog.stop()
        self._stop.set()
        self._queue.put(None)  # unblock the scheduler
        if self._thread is not None:
            self._thread.join(timeout=30)
        for prog in self._pending:
            self._abort_trace(prog.req.trace, "shutdown")
            if not prog.req.future.done():
                _safe_fail(
                    prog.req.future,
                    EngineShutdown(
                        "engine shut down mid-prefill; retry on another replica"
                    ),
                )
        self._pending = []
        self._reserved.clear()
        self._seq_state = None
        if self._program is not None:
            self._program.drop()  # the graphs' pool goes back to the allocator
        for slot in self._slots:
            if slot is not None and not slot.future.done():
                self._abort_trace(slot.trace, "shutdown")
                slot.future.cancel()
        self._fail_control_ops()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not isinstance(req, _Wake):
                self._release_queued(req)
                self._refuse_at_shutdown(req)
        if self._class_queues is not None:
            # Requests drained from the queue and evicted sequences alike.
            for dq in self._class_queues.values():
                while dq:
                    item = dq.popleft()
                    self._release_queued(item)
                    self._refuse_at_shutdown(item)

    # -- client API ----------------------------------------------------------

    def validate(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int | None = None,
    ) -> np.ndarray:
        """Check a request without admitting it; returns the int32 prompt."""
        try:
            prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        except (OverflowError, ValueError, TypeError) as e:
            raise ValueError(f"prompt ids must be integers: {e}") from None
        if prompt.size == 0:
            raise ValueError("empty prompt")
        vocab = int(getattr(self._cfg, "vocab_size", 0))
        if int(prompt.min()) < 0 or (vocab and int(prompt.max()) >= vocab):
            raise ValueError(
                f"prompt ids must be in [0, {vocab}), got range "
                f"[{int(prompt.min())}, {int(prompt.max())}]"
            )
        prompt = prompt.astype(np.int32)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        total = prompt.size + max_new_tokens
        if total > self.capacity:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds KV-cache capacity {self.capacity}"
            )
        if not (0.0 <= float(temperature) <= 100.0):
            raise ValueError(f"temperature must be in [0, 100], got {temperature}")
        if not (0 <= int(top_k) < 2**31):
            raise ValueError(f"top_k must be in [0, 2**31), got {top_k}")
        if not (0.0 < float(top_p) <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if seed is not None and not (0 <= int(seed) < 2**63):
            raise ValueError(f"seed must be in [0, 2**63), got {seed}")
        # Poison quarantine: no hash until a crash has quarantined a prompt.
        if self._quarantined:
            fp = self._fingerprint(prompt)
            with self._poison_lock:  # validate runs on the HTTP threads
                crashes = self._quarantined.get(fp)
                if crashes is not None:
                    self.poison_rejected_total += 1
            if crashes is not None:
                if self._on_poison is not None:
                    self._on_poison("rejected")
                raise PoisonRequest(fp, crashes)
        return prompt

    # -- poison-request quarantine -------------------------------------------

    # Crashes of one prompt fingerprint before submits refuse it: the first
    # could be anything (a wedged card, an allocation race), a second with
    # every other request fine meanwhile is the prompt.
    POISON_CRASH_THRESHOLD = 2

    @staticmethod
    def _fingerprint(prompt: np.ndarray) -> str:
        import hashlib

        return hashlib.sha256(np.ascontiguousarray(prompt, np.int64).tobytes()).hexdigest()[:16]

    def _note_admission_crash(self, reqs) -> None:
        """Charge an admission crash to the prompt of each request it
        implicates; quarantine at the threshold.  Called from the admission
        crash handlers only (a decode crash implicates every slot, and
        blaming them would quarantine innocents).  A packed crash charges
        every admission in the batch: the poison one reaches the threshold
        on its retry, an innocent only if it keeps sharing batches with it."""
        for req in reqs:
            if req is None:
                continue
            fp = self._fingerprint(req.prompt)
            newly = False
            with self._poison_lock:
                n = self._poison_counts.get(fp, 0) + 1
                self._poison_counts[fp] = n
                if n >= self.POISON_CRASH_THRESHOLD and fp not in self._quarantined:
                    self._quarantined[fp] = n
                    newly = True
            if newly:
                self.poison_quarantined_total += 1
                _log.error("poison quarantine: prompt fingerprint %s crashed admission "
                           "%d times; further submits are refused with a typed 422", fp, n)
                if self._on_poison is not None:
                    self._on_poison("quarantined")
                if self._recorder is not None:
                    self._recorder.event(req.request_id or "", "poison-quarantine",
                                         fingerprint=fp, crashes=n)

    def submit(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        eos_id: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int | None = None,
        on_token: Callable[[int], None] | None = None,
        request_id: str = "",
        trace: RequestTrace | None = None,
        est_reserved: bool = False,
        slo_class: str | None = None,
    ) -> Future:
        """Enqueue one request; returns its future.  Sheds with
        :class:`EngineOverloaded` before enqueueing anything, unless the
        caller already took the reservation (``est_reserved``, a
        multi-prompt request's whole reservation through
        :meth:`reserve_admission`); refuses a quarantined prompt with
        :class:`PoisonRequest`.  ``on_token`` is called on the scheduler
        thread with each emitted token; ``trace``, when given, receives the
        request's timing and counts.  ``slo_class`` overrides the engine's
        default class (read only while classes are armed)."""
        prompt = self.validate(
            prompt_ids, max_new_tokens, temperature, top_k, top_p, seed
        )
        if slo_class is not None and slo_class not in SLO_CLASSES:
            raise ValueError(f"slo_class must be one of {SLO_CLASSES}, got {slo_class!r}")
        cls = slo_class or self._slo_default or "interactive"
        est = int(prompt.size) + int(max_new_tokens)
        if not est_reserved:
            self.reserve_admission(est, slo_class=cls)
        fut: Future = Future()
        # None means "use the engine default"; 0 is a legitimate eos token.
        eos = self._eos_default if eos_id is None else eos_id
        t_submit = time.perf_counter()
        if trace is not None:
            trace.t_submit = t_submit
            trace.prompt_tokens = int(prompt.size)
            if not trace.request_id:
                trace.request_id = request_id
            if self._recorder is not None:
                self._recorder.event(trace.request_id, "enqueued")
        with self._adm_lock:
            self._inflight_reqs += 1
        fut.add_done_callback(self._note_request_done)
        self._queue.put(
            _Request(
                prompt,
                int(max_new_tokens),
                eos,
                fut,
                temperature=float(temperature),
                top_k=int(top_k),
                top_p=float(top_p),
                seed=None if seed is None else int(seed),
                on_token=on_token,
                t_submit=t_submit,
                est_tokens=est,
                request_id=request_id,
                trace=trace,
                slo_class=cls,
            )
        )
        return fut

    def _note_request_done(self, _fut: Future) -> None:
        # Fires once per submitted future (result, exception or cancel).
        with self._adm_lock:
            self._inflight_reqs -= 1

    # -- admission control / drain --------------------------------------------

    def reserve_admission(self, est_tokens: int, slo_class: str | None = None,
                          model: str | None = None) -> None:
        """Reserve queue room for ``est_tokens`` or shed.

        Raises :class:`EngineOverloaded` while draining, or when the
        queued-but-unadmitted estimate plus ``est_tokens`` would pass the
        budget.  The budget bounds the backlog, not a request's size: with
        nothing queued any request ``validate`` allows is admitted, or it
        would shed the same way on every replica.  The reservation is
        released when the scheduler dequeues the request.

        With classes armed, a class sheds at its fraction of the budget
        (``_CLASS_BUDGET_FACTOR``, reason ``class_<name>``).  ``model``
        (the model a multiplexed route addressed) arms per-model fairness:
        while two or more models hold outstanding work, each is bounded by
        an equal share of the budget instead of the global backlog check
        (reason ``model_budget``), so a flooded model cannot shed another
        model's first request.  The caller returns that reservation with
        :meth:`release_model_admission` when its request finishes."""
        cls = None
        if self._classes:
            cls = slo_class or self._slo_default or "interactive"
        with self._adm_lock:
            if self._draining:
                self._note_shed("draining")
                raise EngineOverloaded(
                    "engine is draining; retry on another replica",
                    reason="draining", slo_class=cls,
                )
            budget = self._admission_budget
            eff_budget, reason = budget, "budget"
            if cls is not None and budget:
                factor = _CLASS_BUDGET_FACTOR.get(cls, 1.0)
                if factor < 1.0:
                    eff_budget = int(budget * factor)
                    reason = f"class_{cls}"
            fair_share = None
            if eff_budget and model is not None:
                active = {m for m, v in self._model_est.items() if v > 0}
                active.add(model)
                if len(active) >= 2:
                    fair_share = max(1, eff_budget // len(active))
                    mine = self._model_est.get(model, 0)
                    if mine > 0 and mine + est_tokens > fair_share:
                        self._note_shed("model_budget")
                        raise EngineOverloaded(
                            f"model {model!r} admission share full: {mine} estimated "
                            f"tokens outstanding + {est_tokens} requested > share "
                            f"{fair_share} ({eff_budget} budget / {len(active)} active "
                            "models); retry after the share drains",
                            reason="model_budget", slo_class=cls,
                        )
            if (
                fair_share is None
                and eff_budget
                and self._queued_est_tokens > 0
                and self._queued_est_tokens + est_tokens > eff_budget
            ):
                self._note_shed(reason)
                raise EngineOverloaded(
                    f"admission queue full: {self._queued_est_tokens} "
                    f"estimated tokens queued + {est_tokens} requested "
                    f"> budget {eff_budget}; retry on another replica",
                    reason=reason, slo_class=cls,
                )
            self._queued_est_tokens += est_tokens
            if model is not None:
                self._model_est[model] = self._model_est.get(model, 0) + est_tokens

    def release_model_admission(self, model: str | None, est_tokens: int) -> None:
        """Return a per-model reservation (the ``model=`` arm of
        :meth:`reserve_admission`, scoped to the HTTP request)."""
        if not model or not est_tokens:
            return
        with self._adm_lock:
            left = self._model_est.get(model, 0) - est_tokens
            if left > 0:
                self._model_est[model] = left
            else:
                self._model_est.pop(model, None)

    def _note_shed(self, reason: str) -> None:
        # _adm_lock held.
        self.shed_total += 1
        if self.on_shed is not None:
            self.on_shed(reason)

    def _release_queued(self, req: "_Request | _Preempted") -> None:
        """Return a dequeued request's reservation (once)."""
        if req.est_tokens:
            with self._adm_lock:
                self._queued_est_tokens -= req.est_tokens
            req.est_tokens = 0

    def begin_drain(self) -> None:
        """Stop admissions: every later submit sheds with reason
        "draining"; queued and in-flight requests run to completion."""
        with self._adm_lock:
            self._draining = True

    def cancel_drain(self) -> None:
        """Reopen admissions."""
        with self._adm_lock:
            self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def inflight(self) -> int:
        """Submitted requests whose futures are not done, counted at the
        future (a request moving between queue, prefill and slot never
        drops out of the count)."""
        with self._adm_lock:
            return self._inflight_reqs

    def drained(self) -> bool:
        return self._draining and self.inflight() == 0

    def generate(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        eos_id: int | None = None,
        timeout: float | None = 120.0,
        **sampling,
    ) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(prompt_ids, max_new_tokens, eos_id, **sampling).result(timeout)

    # -- scheduler -----------------------------------------------------------

    def _free_slot(self) -> int | None:
        return pick_free_slot(self._slots, self._reserved, self._dp)

    def _run_op(self, op: str, inputs: dict, fn: Callable[[], object]):
        """Run a device op; on a leader, broadcast its host inputs first (the
        channel makes the pair atomic), so every follower repeats it, and
        note the op's wall in ``op_stats``."""
        if self._channel is None:
            return fn()
        t0 = time.perf_counter()
        try:
            return self._channel.run(encode_message(op, inputs), fn)
        finally:
            note_op(self.op_stats, op, time.perf_counter() - t0)

    def _queued_work(self) -> bool:
        """A submission waits, in the transport queue or a class deque: a
        fused burst must end, and none may start."""
        if not self._queue.empty():
            return True
        return self._class_queues is not None and any(self._class_queues.values())

    # -- SLO classes and preemption ----------------------------------------------

    def _drain_to_classes(self) -> None:
        """Move every submission waiting in the transport queue into its
        class deque (classes armed).  The shutdown sentinel and a ``_Wake``
        go back into the queue, for the admission loop to see."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is None or isinstance(item, _Wake):
                self._queue.put(item)
                return
            self._class_queues[item.slo_class].append(item)

    def _dequeue(self, block: bool, timeout: float):
        """The queue's ``get`` with class priority.  Classes off, it is the
        plain ``get``.  Armed: the transport queue drains into the class
        deques and the highest class pops first (FIFO within a class,
        evicted sequences at the front of theirs); a blocking get waits only
        when every deque is empty."""
        if self._class_queues is None:
            return self._queue.get(block=block, timeout=timeout)
        self._drain_to_classes()
        for name in SLO_CLASSES:
            if self._class_queues[name]:
                return self._class_queues[name].popleft()
        item = self._queue.get(block=block, timeout=timeout)
        if item is None or isinstance(item, _Wake):
            return item
        # More may have landed meanwhile: admit in class order, not arrival.
        self._class_queues[item.slo_class].append(item)
        self._drain_to_classes()
        for name in SLO_CLASSES:
            if self._class_queues[name]:
                return self._class_queues[name].popleft()
        raise AssertionError("unreachable: an item was just queued")

    def _maybe_preempt(self) -> None:
        """At a tick boundary, with no free slot and a strictly higher class
        waiting, evict the lowest-class slot (least progress, then lowest
        index), so the waiting work admits next.  At most one eviction a
        scheduler iteration: preemption follows demand, never flushes."""
        if self._free_slot() is not None:
            return
        self._drain_to_classes()
        waiting = next((n for n in SLO_CLASSES if self._class_queues[n]), None)
        if waiting is None:
            return
        wprio = _CLASS_PRIORITY[waiting]
        victim = None
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            prio = _CLASS_PRIORITY.get(slot.slo_class, wprio)
            if prio >= wprio:
                continue
            key = (prio, slot.prompt_len + len(slot.generated), i)
            if victim is None or key < victim[0]:
                victim = (key, i)
        if victim is not None:
            self._evict_slot(victim[1])

    def _committed_tokens(self, prompt: np.ndarray, generated: list[int],
                          hist: int) -> np.ndarray:
        """The ``hist`` tokens whose K/V a slot holds: the prompt, then every
        generated token but the pending one."""
        full = np.empty((hist,), np.int32)
        pl = int(prompt.size)
        full[:pl] = prompt
        if hist > pl:
            full[pl:] = np.asarray(generated[: hist - pl], np.int32)
        return full

    def _evict_slot(self, idx: int) -> None:
        """Evict slot ``idx`` at a tick boundary, losing no work.  Its
        committed K/V (positions ``[0, hist)``, ``hist = prompt + generated
        - 1``) is read off the card a chunk at a time by the prefix cache's
        own read (dequantized on the int8 cache); the whole chunks enter the
        radix cache, and every chunk's host copy rides the record with the
        key row and the pending token.  The freed row's stale contents are
        the normal slot-reuse case."""
        slot = self._slots[idx]
        assert slot is not None and slot.prompt is not None
        t0 = time.perf_counter()
        self._beat("preempt")
        C = self._prefill_chunk_size
        hist = slot.prompt_len + len(slot.generated) - 1
        full = self._committed_tokens(slot.prompt, slot.generated, hist)
        chunks = [self._read_op(idx, ci * C) for ci in range(-(-hist // C))]
        # Whole-token chunks only: the tail holds positions past hist.
        for ci in range(hist // C):
            if not self._prefix_cache.has_chunk(full, ci):
                if not self._prefix_cache.insert_chunk(full, ci, *chunks[ci]):
                    break  # the parent path was evicted meanwhile
        rec = _Preempted(
            future=slot.future, remaining=slot.remaining, eos_id=slot.eos_id,
            sampling=slot.sampling, on_token=slot.on_token, prompt=slot.prompt,
            generated=slot.generated, slo_class=slot.slo_class,
            temperature=slot.temperature, top_k=slot.top_k, top_p=slot.top_p,
            key=self._keys[idx].cpu().clone(), chunks=chunks, hist=hist,
            history=slot.history, hist_len=slot.hist_len, draft=slot.draft,
            request_id=slot.request_id, trace=slot.trace, t_last_token=slot.t_last_token,
        )
        self._slots[idx] = None
        # The front of its own class: it re-admits before newer work of it.
        self._class_queues[slot.slo_class].appendleft(rec)
        self.preemptions += 1
        self._record_tick("preempt-evict", t0, time.perf_counter() - t0,
                          active_slots=self._occupied(), tokens=hist)
        self._trace_event(slot.trace, "preempt-evict", slot=idx)
        if self._on_preempt is not None:
            self._on_preempt("evict")

    def _admit_restore(self, rec: _Preempted) -> None:
        """Restore an evicted sequence into a free slot, where the eviction
        cut it: the row seeded from the radix cache where its whole chunks
        survived (a prefix hit; an L2 chunk is promoted on the way), from
        the record's host copies past them; then the state rows written in
        place (:meth:`_device_restore`).  No token is sampled."""
        slot_idx = self._free_slot()
        assert slot_idx is not None
        t0 = time.perf_counter()
        self._beat("restore")
        C = self._prefill_chunk_size
        hist = rec.hist
        full = self._committed_tokens(rec.prompt, rec.generated, hist)
        matched, cached = self._prefix_cache.lookup(full)
        matched = min(matched, (hist // C) * C)
        seed = list(cached[: matched // C]) + list(rec.chunks[matched // C:])
        self._seed_slot_op(seed, slot_idx)
        if matched:
            self.prefix_hits += 1
            self.prefix_cached_tokens += matched
            if self._on_prefix_hit is not None:
                self._on_prefix_hit(matched)
        pending = int(rec.generated[-1])
        self._run_op(
            OP_GEN_RESTORE,
            {"slot": slot_idx, "length": hist, "pending": pending, "key_data": rec.key.numpy(),
             "temp": rec.temperature, "tk": rec.top_k, "tp": rec.top_p},
            lambda: self._device_restore(slot_idx, hist, pending, rec.key, rec.temperature,
                                         rec.top_k, rec.top_p))
        self._slots[slot_idx] = _Slot(
            future=rec.future, remaining=rec.remaining, eos_id=rec.eos_id,
            sampling=rec.sampling, on_token=rec.on_token, prompt_len=int(rec.prompt.size),
            generated=rec.generated, t_last_token=rec.t_last_token,
            request_id=rec.request_id, trace=rec.trace, history=rec.history, hist_len=rec.hist_len, draft=rec.draft,
            slo_class=rec.slo_class, prompt=rec.prompt, temperature=rec.temperature,
            top_k=rec.top_k, top_p=rec.top_p,
        )
        self.preempt_restores += 1
        self._record_tick("preempt-restore", t0, time.perf_counter() - t0,
                          active_slots=self._occupied(), tokens=hist,
                          cost=self._cost_seed(hist))
        self._trace_event(rec.trace, "preempt-restore", slot=slot_idx)
        if self._on_preempt is not None:
            self._on_preempt("restore")

    def replay_restore(self, slot, length, pending, key_data, temp, tk, tp) -> None:
        """Follower side of a preemption restore."""
        self._device_restore(int(slot), int(length), int(pending),
                             torch.as_tensor(np.asarray(key_data)), float(temp), int(tk),
                             float(tp))

    def _device_restore(self, slot: int, length: int, pending: int, key: torch.Tensor,
                        temp: float, tk: int, tp: float) -> None:
        """The slot's state rows as the eviction left them: its length, the
        pending token, the key row as captured (no split: it happened in the
        sequence's own history) and the sampling rows.  Each is written in
        place: on the unified engine these tensors are the super-step
        program's buffers, which its captured graphs read."""
        self._cache.lengths[slot] = int(length)
        self._tokens[slot, 0] = int(pending)
        self._keys[slot].copy_(key)
        self._temps[slot] = float(temp)
        self._topk[slot] = int(tk)
        self._topp[slot] = float(tp)

    def _class_slot_state(self, req: _Request) -> dict:
        """A slot's class and preemption fields (none while classes are
        off): under preemption the prompt keys the write-back and the
        sampling parameters refill the rows on restore."""
        if not self._classes:
            return {}
        out: dict = {"slo_class": req.slo_class}
        if self._preemption:
            out.update(prompt=req.prompt, temperature=req.temperature, top_k=req.top_k,
                       top_p=req.top_p)
        return out

    def _occupied(self) -> int:
        return sum(s is not None for s in self._slots)

    def _record_tick(self, kind: str, t0: float, wall_s: float, *, active_slots: int = 0,
                     batch_fill: int = 0, tokens: int = 0, spec_accepted: int = 0,
                     cost=None, steps: int = 0, roles: dict | None = None) -> None:
        """Journal one device dispatch of ``kind``, started at ``t0``, that
        took ``wall_s`` seconds: the dispatch counter, the tick metric and,
        when on, the flight recorder.  ``cost`` is the tick's analytic
        ``(flops, hbm_bytes, tokens)`` (device telemetry only, else None;
        ``tokens`` the positions a rank's forward ran), joined with the
        wall into MFU and bandwidth shares and, at tp > 1, collective
        seconds; ``steps`` > 0 marks a
        fused tick (K steps in the one dispatch), ``roles`` a super-step
        tick's {prefill, decode, verify} rows."""
        self.dispatches_total[kind] = self.dispatches_total.get(kind, 0) + 1
        if self.on_dispatch is not None:
            self.on_dispatch(kind)
        util = None
        if self._telemetry is not None and cost is not None:
            util = self._telemetry.tick_util(kind, wall_s, *cost)
        if self.on_tick is not None:
            self.on_tick(kind, wall_s)
        if self._recorder is not None:
            self._recorder.tick(kind, t0, wall_s, active_slots=active_slots,
                                queue_depth=self._queue.qsize(), batch_fill=batch_fill,
                                tokens=tokens, spec_accepted=spec_accepted, util=util,
                                steps=steps, roles=roles)

    def _rank_rows(self, rows: int) -> float:
        """The rows of ``rows`` one rank's forward runs: a dp shard's block."""
        return rows / (self._mesh.dp if self._mesh is not None else 1)

    def _cost_decode(self, window: int, s: int = 1, steps: int = 1):
        """Analytic (flops, bytes, tokens) of one decode or verify tick: the
        program computes every cache row, so the cost counts ``max_slots``
        (a rank its dp block); a fused tick pays K steps, each at the
        pre-picked window."""
        if self._telemetry is None or self._telemetry.cost is None:
            return None
        flops, nbytes = self._telemetry.cost.decode(self.max_slots, window, s)
        if steps > 1:
            flops, nbytes = flops * steps, nbytes * steps
        return flops, nbytes, self._rank_rows(self.max_slots) * s * steps

    def _cost_superstep(self, window: int, s: int, steps: int):
        """Analytic (flops, bytes, tokens) of one super-step: the S-wide
        forward and ``steps - 1`` fused single-token steps, at the
        pre-picked window."""
        if self._telemetry is None or self._telemetry.cost is None:
            return None
        flops, nbytes = self._telemetry.cost.superstep(self.max_slots, window, s, steps)
        return flops, nbytes, self._rank_rows(self.max_slots) * (s + steps - 1)

    def _cost_prefill(self, rows: int, chunk: int, attended=None, packed: bool = False):
        """A prefill of ``rows`` rows of ``chunk`` positions; ``packed``
        rows are split over the dp shards (the mean a rank runs), a single
        row's prefill runs on every rank."""
        if self._telemetry is None or self._telemetry.cost is None:
            return None
        flops, nbytes = self._telemetry.cost.prefill(rows, chunk, attended)
        return flops, nbytes, (self._rank_rows(rows) if packed else rows) * chunk

    def _cost_seed(self, tokens: int):
        if self._telemetry is None or self._telemetry.cost is None:
            return None
        return (*self._telemetry.cost.seed(tokens), 0.0)

    def _sync_tick(self) -> None:
        """With the recorder or telemetry on, wait for the card before a
        prefill or seed tick's wall is read."""
        if self._sync_ticks and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _trace_event(self, trace, name: str, slot: int = -1) -> None:
        if self._recorder is not None and trace is not None:
            self._recorder.event(trace.request_id, name, slot=slot)

    def _abort_trace(self, trace, reason: str) -> None:
        """Finish a request's trace off the token path (shutdown, engine
        failure), so its span still closes in the recorder."""
        if trace is None:
            return
        trace.finish(reason)
        if self._recorder is not None:
            self._recorder.event(trace.request_id, "finish", slot=trace.slot)
            self._recorder.complete(trace)

    def _note_ttft(self, req: _Request) -> None:
        if req.t_submit <= 0.0:
            return
        if req.trace is not None:
            req.trace.t_first = time.perf_counter()
            self._trace_event(req.trace, "first_token", slot=req.trace.slot)
        if self.on_ttft is not None:
            self.on_ttft(time.perf_counter() - req.t_submit)

    def _note_admission_wait(self, req: _Request) -> None:
        if req.t_submit <= 0.0:
            return
        if req.trace is not None:
            req.trace.t_admit = time.perf_counter()
            self._trace_event(req.trace, "admission")
        if self.on_admission_wait is not None:
            self.on_admission_wait(time.perf_counter() - req.t_submit)

    def _slot_key_for(self, req: _Request) -> torch.Tensor | None:
        """The request's key ``[2]``: ``key(seed)``, or the boot key with
        this boot's request counter folded in.  Every request advances the
        counter, as in the reference; a greedy request's key is never
        read, so it is not computed (None)."""
        if req.seed is None:
            self._seed_counter += 1
        if req.temperature <= 0:
            return None
        if req.seed is None:
            return prng.fold_in(self._boot_key, self._seed_counter)
        return prng.key(req.seed, self._device)

    def _install_slot(self, slot_idx, row_logits, slot_key, temp: float, tk: int,
                      tp: float) -> int:
        """Set the slot's sampling state and draw its first token from the
        prefill's last real row: split the request's key once, keep the
        carry for decode, draw with the other half."""
        self._temps[slot_idx] = temp
        self._topk[slot_idx] = tk
        self._topp[slot_idx] = tp
        if slot_key is None:  # greedy: the sampling step would return the argmax
            first = torch.argmax(row_logits.to(torch.float32))
        else:
            carry, first = sample_chain_step(
                row_logits[None], slot_key[None], self._temps[slot_idx:slot_idx + 1],
                self._topk[slot_idx:slot_idx + 1], self._topp[slot_idx:slot_idx + 1],
            )
            self.sample_steps += 1
            self._keys[slot_idx] = carry[0]
            first = first[0]
        self._tokens[slot_idx, 0] = first
        return int(first)

    def _new_slot(self, req: _Request) -> _Slot:
        return _Slot(
            future=req.future,
            remaining=req.max_new_tokens,
            eos_id=req.eos_id,
            sampling=req.temperature > 0,
            on_token=req.on_token,
            prompt_len=int(req.prompt.size),
            request_id=req.request_id,
            trace=req.trace,
            **self._spec_slot_state(req),
            **self._class_slot_state(req),
        )

    def _spec_slot_state(self, req: _Request) -> dict:
        """Per-slot speculative state (empty when speculation is off)."""
        if self._spec is None:
            return {}
        history = np.empty((self.capacity,), np.int64)
        L = int(req.prompt.size)
        history[:L] = req.prompt
        return {
            "history": history,
            "hist_len": L,
            "draft": DraftState(self._spec.draft_tokens, adaptive=self._spec.adaptive),
        }

    def _admit(self, req: _Request) -> None:
        """Whole-prompt admission: prefill the bucket-padded prompt and
        insert it into a free slot."""
        slot_idx = self._free_slot()
        assert slot_idx is not None
        L = int(req.prompt.size)
        bucket = prefill_bucket(L, self.capacity)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :L] = req.prompt
        slot_key = self._slot_key_for(req)
        t0 = time.perf_counter()
        self._beat("admit")
        first = self._run_op(  # read back: synced
            OP_GEN_ADMIT,
            {"ids": ids, "slot": slot_idx, "length": L, "key_data": _key_data(slot_key),
             "temp": req.temperature, "tk": req.top_k, "tp": req.top_p},
            lambda: self._device_admit(ids, slot_idx, L, slot_key, req))
        self.prefill_forwards += 1
        self._record_tick("prefill", t0, time.perf_counter() - t0, active_slots=self._occupied(),
                          batch_fill=1, tokens=1, cost=self._cost_prefill(1, bucket))
        if req.trace is not None:
            req.trace.slot = slot_idx
            req.trace.prefill_chunks += 1  # the whole prompt at once
        self._slots[slot_idx] = self._new_slot(req)
        self._note_ttft(req)
        self._record_token(slot_idx, first)

    def _device_admit(self, ids, slot_idx, L, slot_key, req) -> int:
        ids_t = torch.as_tensor(ids, dtype=torch.int64, device=self._device)
        logits, seq = llama.prefill(self._params, ids_t, self._cfg, self._dtype, self._mesh)
        self._cache = llama.insert_sequence(self._cache, seq, slot_idx, L, self._mesh)
        return self._install_slot(slot_idx, logits[0, L - 1], slot_key, req.temperature,
                                  req.top_k, req.top_p)

    def _key(self, key_data) -> torch.Tensor | None:
        return None if key_data is None else torch.as_tensor(
            np.asarray(key_data), dtype=torch.int64, device=self._device)

    def replay_admit(self, ids, slot, length, key_data, temp, tk, tp) -> None:
        """Follower side of a whole-prompt admission (the request as the
        op carries it: its prompt and sampling parameters)."""
        ids = np.asarray(ids)
        req = _Request(prompt=ids[0, :int(length)], max_new_tokens=0, eos_id=None,
                       future=Future(), temperature=float(temp), top_k=int(tk),
                       top_p=float(tp))
        self._device_admit(ids, int(slot), int(length), self._key(key_data), req)

    # -- chunked prefill (one chunk shape; decode interleaves) ---------------

    def _split_chunks(self, prompt: np.ndarray) -> list:
        C = self._prefill_chunk_size
        L = int(prompt.size)
        n = -(-L // C)
        padded = np.zeros((n * C,), np.int32)
        padded[:L] = prompt
        return [padded[i * C: (i + 1) * C][None, :] for i in range(n)]

    def _device_chunk(self, ids: np.ndarray, fresh: bool) -> None:
        if fresh:
            seq = llama.KVCache.create(self._cfg, 1, self._dtype, self._device, self._mesh)
            self._seq_state = (None, seq)
        _, seq = self._seq_state
        ids_t = torch.as_tensor(ids, dtype=torch.int64, device=self._device)
        logits, seq = llama.forward(self._params, ids_t, seq, self._cfg, self._dtype,
                                    self._mesh)
        self._seq_state = (logits[0], seq)

    def replay_chunk(self, ids, fresh) -> None:
        """Follower side of one prefill chunk."""
        self._device_chunk(np.asarray(ids), bool(fresh))

    def _device_insert(self, slot_idx, L, slot_key, temp, tk, tp, last_idx) -> int:
        last_logits, seq = self._seq_state
        self._seq_state = None
        self._cache = llama.insert_sequence(self._cache, seq, slot_idx, L, self._mesh)
        return self._install_slot(slot_idx, last_logits[last_idx], slot_key, temp, tk, tp)

    def replay_insert(self, slot, length, key_data, temp, tk, tp, last_idx) -> None:
        """Follower side of a chunked admission's insert."""
        self._device_insert(int(slot), int(length), self._key(key_data), float(temp),
                            int(tk), float(tp), int(last_idx))

    # -- sequence-parallel prefill (meshShape sp > 1) -------------------------

    def _sp_eligible(self, req: _Request) -> bool:
        """Long cold prompts ride the ring: one sequence-parallel pass
        instead of L/C serial chunk forwards.  Short prompts and warm
        prefixes keep their paths (a radix-cached prefix already skips the
        prefill the ring would split)."""
        return self._sp > 1 and int(req.prompt.size) >= self._sp_threshold

    def _admit_sp(self, req: _Request) -> None:
        """Admit ``req`` through the sequence-parallel prefill: one ring pass
        over the bucket-padded prompt into the scratch cache, the radix
        write-back of its whole chunks, then the scratch insert."""
        slot_idx = self._free_slot()
        assert slot_idx is not None
        L = int(req.prompt.size)
        bucket = prefill_bucket(L, self.capacity)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :L] = req.prompt
        self._beat("prefill")
        ts = time.perf_counter()
        self._run_op(OP_GEN_SP_PREFILL, {"ids": ids, "length": L},
                     lambda: self._device_sp_prefill(ids, L))
        self.prefill_forwards += 1
        self._sync_tick()
        self._record_tick("sp-prefill", ts, time.perf_counter() - ts,
                          active_slots=self._occupied(), batch_fill=1,
                          cost=self._cost_sp_prefill(bucket))
        self._trace_event(req.trace, "sp_prefill")
        self._cache_sp_chunks(req)
        slot_key = self._slot_key_for(req)
        t0 = time.perf_counter()
        # The ring pass selected the final real row: last_idx 0 indexes the
        # [1, V] logits it left in the scratch state.
        first = self._run_op(  # read back: synced
            OP_GEN_INSERT,
            {"slot": slot_idx, "length": L, "key_data": _key_data(slot_key),
             "temp": req.temperature, "tk": req.top_k, "tp": req.top_p, "last_idx": 0},
            lambda: self._device_insert(slot_idx, L, slot_key, req.temperature, req.top_k,
                                        req.top_p, 0))
        self._record_tick("prefill", t0, time.perf_counter() - t0,
                          active_slots=self._occupied(), batch_fill=1, tokens=1)
        if req.trace is not None:
            req.trace.slot = slot_idx
            req.trace.prefill_chunks += 1  # the whole prompt at once
        self._slots[slot_idx] = self._new_slot(req)
        self._note_ttft(req)
        self._record_token(slot_idx, first)

    def _cache_sp_chunks(self, req: _Request) -> None:
        """Radix write-back after a ring prefill: every WHOLE chunk of the
        prompt (a padded tail never enters the cache) the tree does not
        hold, read from the freshly filled scratch, so a later request
        sharing the prefix seeds from them as if chunked prefill had
        written them."""
        if self._prefix_cache is None or self._prefill_chunk_size is None:
            return
        C = self._prefill_chunk_size
        for chunk_idx in range(int(req.prompt.size) // C):
            if self._prefix_cache.has_chunk(req.prompt, chunk_idx):
                continue
            ck, cv = self._read_op(-1, chunk_idx * C)
            self._prefix_cache.insert_chunk(req.prompt, chunk_idx, ck, cv)

    def _device_sp_prefill(self, ids: np.ndarray, length: int) -> None:
        """The ring pass into a fresh scratch cache: its K/V at positions
        ``[0, bucket)``, its length ``length``, and the last real row's
        ``[1, V]`` logits beside it."""
        seq = llama.KVCache.create(self._cfg, 1, self._dtype, self._device, self._mesh)
        ids_t = torch.as_tensor(ids, dtype=torch.int64, device=self._device)
        logits, k_all, v_all = llama.prefill_ring(self._params, ids_t, self._cfg,
                                                  mesh=self._mesh, last_idx=int(length) - 1,
                                                  dtype=self._dtype)
        n = k_all.shape[2]
        seq.k[:, :, :n] = k_all.to(seq.k.dtype)
        seq.v[:, :, :n] = v_all.to(seq.v.dtype)
        self._seq_state = (logits, seq._replace(length=int(length)))

    def replay_sp_prefill(self, ids, length) -> None:
        """Follower side of a ring prefill."""
        self._device_sp_prefill(np.asarray(ids), int(length))

    def _cost_sp_prefill(self, tokens: int):
        """One ring pass over ``tokens`` padded positions: the work of a
        whole-prompt prefill of them, a rank running its ``1/sp`` share."""
        if self._telemetry is None or self._telemetry.cost is None:
            return None
        flops, nbytes = self._telemetry.cost.sp_prefill(tokens)
        return flops, nbytes, tokens / self._sp

    # -- radix prefix cache --------------------------------------------------

    def _make_progress(self, req: _Request) -> _PrefillProgress:
        """Chunked-admission plan: the longest radix-cached prefix (to
        seed) and the uncached suffix (to prefill)."""
        cached_tokens, cached_kv = 0, []
        if self._prefix_cache is not None:
            cached_tokens, cached_kv = self._prefix_cache.lookup(req.prompt)
        if req.trace is not None:
            req.trace.cached_tokens = cached_tokens
        return _PrefillProgress(
            req=req,
            chunks=self._split_chunks(req.prompt[cached_tokens:]),
            cached_tokens=cached_tokens,
            cached_kv=cached_kv,
        )

    def _note_prefix_evict(self, nbytes: int) -> None:
        self.prefix_evictions += 1
        if self._on_prefix_evict is not None:
            self._on_prefix_evict()

    def _note_prefix_l2(self, kind: str) -> None:
        if self._on_prefix_l2 is not None:
            self._on_prefix_l2(kind)

    # -- control ops and the KV handoff (disaggregated prefill/decode) -------

    def run_control(self, fn: Callable[[], object]) -> Future:
        """Run ``fn`` on the scheduler thread at the next admission phase
        (thread-safe); returns a future of its result.  A control op takes
        no cache row and runs with every slot busy: it is for state the
        scheduler owns alone (the radix prefix cache)."""
        fut: Future = Future()
        if self._stop.is_set():
            # The scheduler will never pop it: fail now, not at the
            # caller's timeout.
            _safe_fail(fut, EngineShutdown("engine shut down before the control op ran"))
            return fut
        self._control_ops.put((fn, fut))
        self._queue.put(_WAKE)  # unblock an idle scheduler promptly
        if self._stop.is_set():
            # Raced shutdown: its drain may have missed this op.  Both
            # drains take with get_nowait and failing twice is harmless.
            self._fail_control_ops()
        return fut

    def _drain_control_ops(self) -> None:
        while True:
            try:
                fn, fut = self._control_ops.get_nowait()
            except queue.Empty:
                return
            try:
                _safe_resolve(fut, fn())
            except Exception as exc:
                _safe_fail(fut, exc)

    def _fail_control_ops(self) -> None:
        while True:
            try:
                _fn, fut = self._control_ops.get_nowait()
            except queue.Empty:
                return
            _safe_fail(fut, EngineShutdown("engine shut down before the control op ran"))

    def _require_prefix_cache(self) -> RadixPrefixCache:
        if self._prefix_cache is None:
            raise RuntimeError(
                "KV handoff requires the radix prefix cache: enable "
                "spec.tpu.prefixCache (--prefix-cache 1)"
            )
        return self._prefix_cache

    def exportable_prefix_tokens(self, prompt) -> int:
        """Whole-chunk tokens of ``prompt`` a handoff can cover (the radix
        lookup stops strictly below the prompt's length)."""
        C = self._require_prefix_cache().chunk_tokens
        return ((int(np.asarray(prompt).size) - 1) // C) * C

    def export_prefix_kv(self, prompt, timeout: float | None = 60.0) -> tuple[int, list]:
        """The committed prefix K/V of ``prompt`` in the radix cache:
        ``(matched_tokens, [(k, v), ...])``, host tensors ``[L, 1, C, NKV,
        D]``.  The lookup (an LRU-touching walk) runs as a control op; the
        chunks are never written in place, so they serialize from any
        thread."""
        cache = self._require_prefix_cache()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        return self.run_control(lambda: cache.lookup(prompt)).result(timeout)

    def import_prefix_kv(self, prompt, chunks: list, timeout: float | None = 60.0) -> int:
        """Insert handed-off prefix chunks (host tensors, or numpy arrays
        that ``convert.to_tensor`` takes) into the radix cache; returns the
        tokens now covered.  Runs as a control op and journals one
        ``kv-import`` tick.  It stops at a chunk whose parent path was
        evicted meanwhile."""
        from ..convert import to_tensor

        cache = self._require_prefix_cache()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        C = cache.chunk_tokens
        if len(chunks) * C > prompt.size:
            raise ValueError(
                f"{len(chunks)} chunks of {C} tokens exceed the {prompt.size}-token prompt"
            )
        pin = self._device.type == "cuda"

        def host(x) -> torch.Tensor:
            t = x if isinstance(x, torch.Tensor) else to_tensor(x)
            if pin and not t.is_pinned():
                t = t.pin_memory()  # the seed's copy to the card is one DMA
            return t

        pairs = [(host(k), host(v)) for k, v in chunks]

        def op() -> int:
            t0 = time.perf_counter()
            installed = 0
            for idx, (k, v) in enumerate(pairs):
                if not cache.insert_chunk(prompt, idx, k, v):
                    break  # the parent path was evicted mid-walk
                installed += 1
            self._record_tick("kv-import", t0, time.perf_counter() - t0,
                              active_slots=self._occupied(), batch_fill=installed,
                              tokens=installed * C)
            return installed * C

        return int(self.run_control(op).result(timeout))

    def _device_seed(self, cached_kv: list, length: int) -> None:
        """A fresh scratch cache with the cached chunks copied in at their
        offsets (host to card; one DMA a tensor from pinned host memory),
        its length set to ``length``.  No logits yet: a suffix chunk always
        follows (the match stops below the prompt length).  A chunk holds
        every head; a rank of a tp mesh copies in its own."""
        seq = llama.KVCache.create(self._cfg, 1, self._dtype, self._device, self._mesh)
        C = self._prefill_chunk_size
        for i, (ck, cv) in enumerate(cached_kv):
            seq.k[:, :, i * C:(i + 1) * C].copy_(self._head_block(ck), non_blocking=True)
            seq.v[:, :, i * C:(i + 1) * C].copy_(self._head_block(cv), non_blocking=True)
        self._seq_state = (None, seq._replace(length=int(length)))

    def replay_seed(self, ks, vs, length) -> None:
        """Follower side of a prefix-cache seed of the scratch cache."""
        self._device_seed(list(zip(ks, vs)), int(length))

    def _head_block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's heads of a position-major ``[L, 1, C, NKV, D]`` chunk."""
        if self._mesh is None or self._mesh.tp == 1:
            return t
        n = t.shape[3] // self._mesh.tp
        h0 = self._mesh.index("tp") * n
        return t[:, :, :, h0:h0 + n]

    def _gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's heads of a position-major chunk, in head order."""
        if self._mesh is None or self._mesh.tp == 1:
            return t
        return all_gather_concat(t, self._mesh.group("tp"), axis=3)

    def _to_host(self, srcs) -> list:
        """Copies in host memory (pinned on a CUDA engine, so a later seed is
        one DMA); the copy waits for the forward that wrote them."""
        pin = self._device.type == "cuda"
        out = []
        for src in srcs:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
            host.copy_(src)
            out.append(host)
        return out

    def _read_op(self, slot: int, start: int):
        """A chunk's K/V for the prefix cache: the scratch cache's (``slot``
        -1) or cache row ``slot``'s.  On a mesh of several ranks the read
        gathers across ranks, so it is an op every rank runs."""
        if slot < 0:
            def fn():
                return self._read_chunk(start)
        else:
            def fn():
                return self._read_chunk_slot(slot, start)
        if self._mesh is None:
            return fn()
        return self._run_op(OP_GEN_READ, {"slot": int(slot), "start": int(start)}, fn)

    def replay_read(self, slot, start) -> None:
        """Follower side of a read: join its gathers, keep nothing."""
        if int(slot) < 0:
            self._read_chunk(int(start))
        else:
            self._read_chunk_slot(int(slot), int(start))

    def _read_chunk(self, start: int):
        """The scratch cache's K/V ``[L, 1, C, NKV, D]`` at ``start``, every
        head, copied to host memory."""
        _, seq = self._seq_state
        C = self._prefill_chunk_size
        return self._to_host(self._gather_heads(buf[:, :, start:start + C])
                             for buf in (seq.k, seq.v))

    def _read_chunk_slot(self, slot: int, start: int):
        """Packed mode's :meth:`_read_chunk`: cache row ``slot``'s K/V at
        ``start``, position-major ``[L, 1, C, NKV, D]`` in the engine's type
        (the radix cache's layout, so entries serve either mode), copied to
        host memory (pinned on a CUDA engine).  The int8 cache dequantizes
        on the way out; requantizing ``code * scale`` in bf16 gives the code
        and the scale back (the per-head max is kept).  Under dp > 1 the row's
        shard reads it and a dp psum (its values plus zeros) brings it to
        every rank."""
        C = self._prefill_chunk_size
        rows = llama._dp_rows(self._mesh, self.max_slots)
        owned = rows is None or rows.start <= slot < rows.stop
        local = slot if rows is None else (slot - rows.start if owned else 0)
        at = (slice(None), slice(local, local + 1), slice(None), slice(start, start + C))
        cache = self._cache
        if self._kv_quant:
            bufs = [(q8[at].to(self._dtype) * sc[at]).to(self._dtype)
                    for q8, sc in ((cache.k8, cache.k_scale), (cache.v8, cache.v_scale))]
        else:
            bufs = [cache.k[at], cache.v[at]]
        if rows is not None:
            bufs = [psum(b if owned else torch.zeros_like(b), self._mesh.group("dp"))
                    for b in bufs]
        # head-major -> position-major
        return self._to_host(self._gather_heads(b.transpose(2, 3)) for b in bufs)

    def _seed_slot_op(self, cached_kv: list, slot: int) -> None:
        self._run_op(OP_GEN_SEED_SLOT, {"ks": [k for k, _ in cached_kv],
                                        "vs": [v for _, v in cached_kv], "slot": int(slot)},
                     lambda: self._device_seed_slot(cached_kv, slot))

    def replay_seed_slot(self, ks, vs, slot) -> None:
        """Follower side of a seed of a cache row."""
        self._device_seed_slot(list(zip(ks, vs)), int(slot))

    def _device_seed_slot(self, cached_kv: list, slot: int) -> None:
        """Packed mode's :meth:`_device_seed`: the cached chunks (host
        pairs ``[L, 1, C, NKV, D]``, position-major) copied into the reserved
        cache row ``slot`` at their offsets, head-major, quantized on the
        int8 cache (one DMA a tensor from pinned host memory).  On a mesh a
        rank copies its heads, and under dp only the row's shard copies."""
        C = self._prefill_chunk_size
        cache = self._cache
        rows = llama._dp_rows(self._mesh, self.max_slots)
        if rows is not None:
            if not rows.start <= slot < rows.stop:
                return
            slot -= rows.start
        for i, (ck, cv) in enumerate(cached_kv):
            at = (slice(None), slice(slot, slot + 1), slice(None), slice(i * C, (i + 1) * C))
            kh, vh = (self._head_block(x).to(self._device, non_blocking=True).transpose(2, 3)
                      .to(self._dtype) for x in (ck, cv))
            if self._kv_quant:
                cache.k8[at], cache.k_scale[at] = llama._quant_kv(kh)
                cache.v8[at], cache.v_scale[at] = llama._quant_kv(vh)
            else:
                cache.k[at] = kh
                cache.v[at] = vh

    def _note_prefix_hit(self, prog: _PrefillProgress) -> None:
        self.prefix_hits += 1
        self.prefix_cached_tokens += prog.cached_tokens
        if self._on_prefix_hit is not None:
            self._on_prefix_hit(prog.cached_tokens)

    def _maybe_cache_chunk(self, prog: _PrefillProgress) -> None:
        """Write the chunk just prefilled (``prog.next_idx``) back into the
        radix cache: full chunks of real prompt tokens only (a padded tail
        holds pad-token K/V), and only chunks the tree does not hold (the
        read off the card waits for the forward, so each unique chunk pays
        it once).  Packed mode reads the reserved row, the single-admission
        pipeline its scratch cache."""
        if self._prefix_cache is None:
            return
        C = self._prefill_chunk_size
        L = int(prog.req.prompt.size)
        start = prog.cached_tokens + prog.next_idx * C
        if start + C > L:
            return
        chunk_idx = start // C
        if self._prefix_cache.has_chunk(prog.req.prompt, chunk_idx):
            return
        ck, cv = self._read_op(prog.slot, start)
        self._prefix_cache.insert_chunk(prog.req.prompt, chunk_idx, ck, cv)

    def _chunk_tick(self) -> None:
        """Advance the in-flight chunked admission by ONE device op: a
        prefix-cache seed or one prefill chunk; on the final chunk, install
        the sequence into its slot."""
        assert self._pending
        self._beat("prefill")
        prog = self._pending[0]
        trace = prog.req.trace
        C = self._prefill_chunk_size
        if prog.cached_tokens and not prog.seeded:
            # Cached-prefix hit: one seed copies the cached K/V into a
            # fresh scratch cache; those tokens never re-prefill.  The
            # suffix chunks start next tick (the decode cadence is kept).
            t0 = time.perf_counter()
            kv, n = prog.cached_kv, prog.cached_tokens
            self._run_op(OP_GEN_SEED, {"ks": [k for k, _ in kv], "vs": [v for _, v in kv],
                                       "length": n},
                         lambda: self._device_seed(kv, n))
            prog.seeded = True
            prog.cached_kv = []  # the cache keeps the host copies
            self._note_prefix_hit(prog)
            self._sync_tick()
            self._record_tick("seed", t0, time.perf_counter() - t0,
                              active_slots=self._occupied(), batch_fill=1,
                              cost=self._cost_seed(prog.cached_tokens))
            self._trace_event(trace, "seed")
            return
        ids = prog.chunks[prog.next_idx]
        offset = prog.cached_tokens + prog.next_idx * C
        t0 = time.perf_counter()
        fresh = prog.next_idx == 0 and not prog.seeded
        self._run_op(OP_GEN_CHUNK, {"ids": ids, "fresh": fresh},
                     lambda: self._device_chunk(ids, fresh=fresh))
        self.prefill_forwards += 1
        self._sync_tick()
        self._record_tick("prefill", t0, time.perf_counter() - t0,
                          active_slots=self._occupied(), batch_fill=1,
                          cost=self._cost_prefill(1, C, attended=offset + C / 2))
        if trace is not None:
            trace.prefill_chunks += 1
            self._trace_event(trace, "prefill_chunk")
        self._maybe_cache_chunk(prog)
        prog.next_idx += 1
        if prog.next_idx < len(prog.chunks):
            return
        req = prog.req
        self._pending.pop(0)
        slot_idx = self._free_slot()
        assert slot_idx is not None  # reserved by the admission policy
        L = int(req.prompt.size)
        slot_key = self._slot_key_for(req)
        t0 = time.perf_counter()
        last_idx = (L - 1) - prog.cached_tokens - C * (len(prog.chunks) - 1)
        first = self._run_op(  # read back: synced
            OP_GEN_INSERT,
            {"slot": slot_idx, "length": L, "key_data": _key_data(slot_key),
             "temp": req.temperature, "tk": req.top_k, "tp": req.top_p, "last_idx": last_idx},
            lambda: self._device_insert(slot_idx, L, slot_key, req.temperature, req.top_k,
                                        req.top_p, last_idx))
        self._record_tick("prefill", t0, time.perf_counter() - t0,
                          active_slots=self._occupied(), batch_fill=1, tokens=1)
        if req.trace is not None:
            req.trace.slot = slot_idx
        self._slots[slot_idx] = self._new_slot(req)
        self._note_ttft(req)
        self._record_token(slot_idx, first)

    # -- packed multi-admission prefill (prefill_batch > 1) ------------------

    def _pack_buckets(self) -> list[int]:
        """Power-of-two B_p buckets up to ``prefill_batch`` (which caps the
        set even when it is not a power of two), ascending: every packed
        forward has one of these row counts, so its shapes are few (what a
        later CUDA-graph capture needs)."""
        out, b = [], 1
        while b < self._prefill_batch:
            out.append(b)
            b *= 2
        out.append(self._prefill_batch)
        return out

    def _pack_bucket(self, n: int) -> int:
        for b in self._pack_buckets():
            if b >= n:
                return b
        return self._prefill_batch

    def _parked_batch(self, bucket: int, real_slots: list[int]) -> tuple:
        """A packed call's (ids, slots, offsets) with every row PARKED
        (offset == capacity: it reads no window and writes nothing); rows
        ``[0, n)`` carry ``real_slots`` for :meth:`_packed_tick` to fill,
        and each pad row a slot no other row has (the unique-target
        contract of ``llama._commit_chunk_at``: a parked row stores back
        what its own row holds)."""
        spare = [i for i in range(self.max_slots) if i not in real_slots]
        slots = np.asarray(list(real_slots) + spare[:bucket - len(real_slots)], np.int32)
        return (
            np.zeros((bucket, self._prefill_chunk_size), np.int64),
            slots,
            np.full((bucket,), self.capacity, np.int32),
        )

    def _packed_tick(self) -> None:
        """Advance up to ``prefill_batch`` in-flight admissions by one chunk
        each: ONE packed forward, after one seed op for each admission
        entering with a radix-cached prefix.  The token budget caps the
        chunks a tick packs (Sarathi-style): decode ticks interleave every
        tick, so bounding prefill work a tick bounds the decode-cadence
        jitter long prompts inject."""
        self._beat("packed-prefill")
        C = self._prefill_chunk_size
        max_chunks = self._prefill_batch
        if self._prefill_token_budget:
            max_chunks = min(max_chunks, max(1, self._prefill_token_budget // C))
        chunk_progs = []
        for prog in self._pending[:max_chunks]:
            if prog.cached_tokens and not prog.seeded:
                # The cached prefix goes straight into the reserved row;
                # those tokens never re-prefill.
                self._seed_reserved(prog)
            else:
                chunk_progs.append(prog)
        if not chunk_progs:
            return
        n = len(chunk_progs)
        ids, slots, offsets = self._parked_batch(self._pack_bucket(n),
                                                 [p.slot for p in chunk_progs])
        # (row, slot, length, last real position in the chunk, key, temp, tk, tp)
        finals = []
        for i, prog in enumerate(chunk_progs):
            ids[i] = prog.chunks[prog.next_idx][0]
            offsets[i] = prog.cached_tokens + prog.next_idx * C
            if prog.next_idx == len(prog.chunks) - 1:
                req = prog.req
                L = int(req.prompt.size)
                finals.append((i, prog.slot, L, L - 1 - int(offsets[i]),
                               self._slot_key_for(req), req.temperature, req.top_k, req.top_p))
        t0 = time.perf_counter()
        firsts = self._run_op(
            OP_GEN_CHUNKS,
            {"ids": ids, "slots": slots, "offsets": offsets,
             "finals": [f[:4] + (_key_data(f[4]),) + f[5:] for f in finals]},
            lambda: self._device_chunks(ids, slots, offsets, finals))
        self.prefill_chunks_dispatched += n
        self.prefill_forwards += 1
        if self._on_prefill_batch is not None:
            self._on_prefill_batch(n)
        self._sync_tick()
        # The forward computes every row of the bucket (parked pad rows
        # too); the mean attended span is over the real chunks' offsets.
        attended = float(offsets[:n].mean()) + C / 2
        self._record_tick("packed-prefill", t0, time.perf_counter() - t0,
                          active_slots=self._occupied(), batch_fill=n, tokens=len(finals),
                          cost=self._cost_prefill(len(ids), C, attended=attended,
                                                  packed=True))
        for i, prog in enumerate(chunk_progs):
            self._note_chunk(prog)
            self._maybe_cache_chunk(prog)
            prog.next_idx += 1
            if prog.next_idx < len(prog.chunks):
                continue
            # The packed forward installed the slot and drew its first token.
            self._pending.remove(prog)
            self._reserved.discard(prog.slot)
            self._slots[prog.slot] = self._new_slot(prog.req)
            self._note_ttft(prog.req)
            self._record_token(prog.slot, firsts[i])

    def _seed_reserved(self, prog: _PrefillProgress) -> None:
        """A packed admission's radix-cached prefix seeded straight into
        its reserved row: one seed tick."""
        t0 = time.perf_counter()
        self._seed_slot_op(prog.cached_kv, prog.slot)
        prog.seeded = True
        prog.cached_kv = []
        self._note_prefix_hit(prog)
        self._sync_tick()
        self._record_tick("seed", t0, time.perf_counter() - t0, active_slots=self._occupied(),
                          batch_fill=1, cost=self._cost_seed(prog.cached_tokens))
        self._trace_event(prog.req.trace, "seed", slot=prog.slot)

    def _note_chunk(self, prog: _PrefillProgress) -> None:
        """A packed admission's chunk ran, in its reserved row."""
        trace = prog.req.trace
        if trace is not None:
            trace.slot = prog.slot
            trace.prefill_chunks += 1
            self._trace_event(trace, "prefill_chunk", slot=prog.slot)

    def _device_chunks(self, ids, slots, offsets, finals) -> dict[int, int]:
        """The packed forward, then the finalize of each row whose chunk
        completes its prompt: the slot's length, its sampling state and its
        first token, drawn from the row's last real position as a
        single-admission insert draws it.  Returns ``{row: first token}``."""
        dev = self._device
        logits, self._cache = llama.prefill_chunks_ragged(
            self._params, torch.as_tensor(ids, device=dev), self._cache,
            torch.as_tensor(slots, device=dev), torch.as_tensor(offsets, device=dev),
            self._cfg, self._dtype, self._mesh,
        )
        firsts = {}
        for row, slot, length, last, slot_key, temp, tk, tp in finals:
            self._cache.lengths[slot] = int(length)
            firsts[row] = self._install_slot(slot, logits[row, last], slot_key, temp, tk, tp)
        return firsts

    def replay_chunks(self, ids, slots, offsets, finals) -> None:
        """Follower side of a packed prefill forward and its finalizes."""
        finals = [f[:4] + (self._key(f[4]),) + tuple(f[5:]) for f in finals]
        self._device_chunks(np.asarray(ids), np.asarray(slots), np.asarray(offsets), finals)

    def _record_token(self, slot_idx: int, token: int, t: float | None = None) -> None:
        """Credit one emitted token to a slot at time ``t`` (now when
        None); finish it on EOS or budget.  A cancelled request (a client
        that went away) frees its slot instead."""
        slot = self._slots[slot_idx]
        assert slot is not None
        if slot.future.cancelled():
            self._finish_trace(slot, "cancelled")
            self._slots[slot_idx] = None
            return
        slot.generated.append(token)
        if slot.history is not None and slot.hist_len < slot.history.size:
            slot.history[slot.hist_len] = token
            slot.hist_len += 1
        slot.remaining -= 1
        now = time.perf_counter() if t is None else t
        if slot.t_last_token > 0.0 and self.on_itl is not None:
            self.on_itl(now - slot.t_last_token)
        slot.t_last_token = now
        if slot.trace is not None:
            slot.trace.note_token(now)
        self.tokens_generated += 1
        if self.on_tokens is not None:
            self.on_tokens(1)
        if slot.on_token is not None:
            try:
                slot.on_token(token)
            except Exception:
                # One line, then disarm: a broken streaming client must
                # not log a stack per token.
                _log.exception("on_token callback failed; disabling it for "
                               "this request")
                slot.on_token = None
        eos = slot.eos_id is not None and token == slot.eos_id
        if slot.remaining <= 0 or eos:
            self._finish_trace(slot, "eos" if eos else "length")
            _safe_resolve(slot.future, np.asarray(slot.generated, np.int32))
            self._slots[slot_idx] = None

    def _finish_trace(self, slot: _Slot, reason: str) -> None:
        """A slot's request is done: its token count, and its trace closed
        and handed to the recorder's completed ring."""
        if self.on_request_tokens is not None:
            self.on_request_tokens(len(slot.generated))
        if slot.trace is None:
            return
        slot.trace.finish(reason)
        self._trace_event(slot.trace, "finish", slot=slot.trace.slot)
        if self._recorder is not None:
            self._recorder.complete(slot.trace)

    def _note_step(self, active: int, wall_s: float) -> None:
        if self.on_step is not None:
            self.on_step(active, wall_s, self._queue.qsize(), len(self._pending))

    def _step(self) -> None:
        """One batched decode tick over every occupied slot.  With
        speculation on and every occupied slot greedy, a tick in which any
        slot drafts is a verify tick instead.  The unified engine sends
        every tick to the super-step instead."""
        if self._unified:
            self._super_tick()
            return
        active_np = np.array([s is not None for s in self._slots])
        if not active_np.any():
            # Idle heartbeat: the occupancy gauges must not freeze at
            # their last busy values.
            self._note_step(0, 0.0)
            return
        # Attention window: smallest bucket covering every active row's
        # next write position (prompt + tokens emitted so far).
        needed = max(
            s.prompt_len + len(s.generated) for s in self._slots if s is not None
        )
        window = decode_window_bucket(needed, self.capacity)
        sampling = any(s is not None and s.sampling for s in self._slots)
        if self._spec is not None and not sampling:
            drafts = self._collect_drafts()
            if any(drafts):
                self._verify_tick(active_np, window, drafts)
                return
        if self._fused and not self._pending and not self._queued_work():
            # A burst engages only when the scheduler owes nothing else: no
            # queued request waiting on a slot a burst would hold for K
            # tokens, no admission whose chunk cadence it would stall.
            self._step_fused(active_np, sampling)
            return
        t0 = time.perf_counter()
        self._beat("decode")
        self._run_op(OP_GEN_STEP, {"active": active_np, "window": window, "sampling": sampling},
                     lambda: self._device_step(active_np, window, sampling))
        toks = self._tokens[:, 0].cpu().numpy()
        wall = time.perf_counter() - t0
        self.decode_forwards += 1
        n_active = int(active_np.sum())
        self._record_tick("decode", t0, wall, active_slots=n_active, tokens=n_active,
                          cost=self._cost_decode(window))
        self._note_step(n_active, wall)
        for i, was_active in enumerate(active_np):
            if was_active and self._slots[i] is not None:
                self._record_token(i, int(toks[i]))

    def replay_step(self, active, window, sampling) -> None:
        """Follower side of a decode tick."""
        self._device_step(np.asarray(active), int(window), bool(sampling))

    def _device_step(self, active_np, window: int, sampling: bool) -> None:
        active = torch.as_tensor(active_np, device=self._device)
        logits, self._cache = llama.decode_ragged(
            self._params, self._tokens, self._cache, self._cfg, active,
            self._dtype, window, self._mesh,
        )
        last = logits[:, -1, :]
        if sampling:
            # Every row's key advances once, greedy rows included, so a
            # row's stream does not depend on its neighbours.
            self._keys, nxt = sample_chain_step(last, self._keys, self._temps, self._topk,
                                                self._topp)
            self.sample_steps += 1
        else:
            nxt = torch.argmax(last, dim=-1)
        # Finished slots keep their last token so their rows stay inert.
        self._tokens = torch.where(active, nxt.to(torch.int64), self._tokens[:, 0])[:, None]

    # -- fused multi-step decode (decode_steps > 1) ---------------------------

    def _step_fused(self, active_np, sampling: bool) -> None:
        """A fused-decode burst with lag-1 readback.

        Each iteration dispatches ONE K-step program (a graph replay on the
        card), then harvests the PREVIOUS dispatch's token block, so the
        host's work for tick N (the sync, the SSE events) overlaps tick
        N+1 on the device.  Chained dispatches take no host input: the
        program's static buffers carry the tokens, lengths, active mask,
        budgets and keys from one to the next.

        The host's view therefore lags the device by one tick.  Two
        decisions need it, whether to go on and the window, and both use
        bounds (a row advances at most K a tick), so an EOS mid-block costs
        at most one trailing dispatch, never a wrong token.  The burst
        exits with every harvest drained, and the chained state copied
        back into the engine's."""
        K = self._decode_steps
        B = self.max_slots
        # Burst-entry inputs from exact host slot truth.
        remaining = np.zeros((B,), np.int32)
        eos_ids = np.full((B,), -1, np.int32)  # -1: no EOS (ids are >= 0)
        hi = np.zeros((B,), np.int64)  # per-row next-write position bound
        rem_hi = np.zeros((B,), np.int64)  # per-row emit-budget bound
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            remaining[i] = slot.remaining
            if slot.eos_id is not None:
                eos_ids[i] = slot.eos_id
            hi[i] = slot.prompt_len + len(slot.generated)
            rem_hi[i] = slot.remaining
        prog = self._program
        prog.load(self._tokens, self._cache.lengths, self._keys, self._temps, self._topk,
                  self._topp, active_np, remaining, eos_ids)
        # The burst entry's host inputs ride the first op; chained ones carry
        # none: each follower chains from its own replay's state.
        entry = {"active": active_np, "remaining": remaining, "eos_ids": eos_ids}
        pending = None  # (host buffer, t0, window) of the dispatch not yet harvested
        while True:
            # The window covers the LAST step's positions: a row crossing a
            # bucket edge inside the K steps must already be covered.
            needed_hi = int(max(hi[i] for i in range(B)
                                if self._slots[i] is not None and rem_hi[i] > 0))
            window = decode_window_bucket(min(needed_hi + K - 1, self.capacity),
                                          self.capacity)
            t0 = time.perf_counter()
            self._beat("multistep")
            handle = self._run_op(
                OP_GEN_MULTISTEP, {"window": window, "sampling": sampling, **entry},
                lambda: self._device_multistep(window, sampling))
            entry = {}
            for i in range(B):
                emit = min(int(rem_hi[i]), K)
                hi[i] += emit
                rem_hi[i] -= emit
            if pending is not None:
                self._harvest_fused(*pending)  # lag-1: tick N+1 is in flight
            pending = (handle, t0, window)
            may_be_active = any(self._slots[i] is not None and rem_hi[i] > 0
                                for i in range(B))
            if (not may_be_active or self._stop.is_set() or self._pending
                    or self._queued_work()):
                break
            if self._spec is not None and not sampling and any(self._collect_drafts()):
                # The harvest refreshed the histories and a draft is in
                # hand: the next tick verifies.
                break
        self._harvest_fused(*pending)
        self._tokens = prog.tokens.clone()
        self._cache = self._cache._replace(lengths=prog.lengths.clone())
        if sampling:
            self._keys = prog.keys.clone()

    def _harvest_fused(self, handle: int, t0: float, window: int) -> None:
        """Wait for one fused tick's token block and credit its tokens.

        ``valid[i]`` counts the steps row ``i`` was active for: columns at
        and after it are frozen copies (their K/V was parked, never
        committed).  Each row's tokens are spread over the tick's wall,
        clamped after the row's last token, so that K tokens do not land
        on one instant (every ITL would read 0)."""
        toks, valid = self._program.harvest(handle)
        end = time.perf_counter()
        wall = end - t0
        K = self._decode_steps
        active_slots = int((valid > 0).sum())
        self.decode_forwards += 1
        self._record_tick("multistep", t0, wall, active_slots=active_slots,
                          tokens=int(valid.sum()), steps=K,
                          cost=self._cost_decode(window, steps=K))
        self._note_step(active_slots, wall)
        for i in range(self.max_slots):
            n = int(valid[i])
            if n <= 0 or self._slots[i] is None:
                continue
            base = max(t0, self._slots[i].t_last_token)
            span = max(end - base, 0.0)
            for j in range(n):
                self._record_token(i, int(toks[i, j]), t=base + span * (j + 1) / n)
                if self._slots[i] is None:
                    break  # finished (EOS, budget) or cancelled mid-block

    def replay_multistep(self, window, sampling, active=None, remaining=None,
                         eos_ids=None) -> None:
        """Follower side of a fused K-step dispatch: a burst's first op loads
        the program from the engine's state, and after every dispatch the
        chained state is the engine's (the leader copies it back at the
        burst's end, before anything else reads it)."""
        prog = self._program
        if active is not None:
            prog.load(self._tokens, self._cache.lengths, self._keys, self._temps,
                      self._topk, self._topp, active, remaining, eos_ids)
        self._device_multistep(int(window), bool(sampling))
        self._tokens = prog.tokens.clone()
        self._cache = self._cache._replace(lengths=prog.lengths.clone())
        if sampling:
            self._keys = prog.keys.clone()

    def _device_multistep(self, window: int, sampling: bool) -> int:
        """One K-step dispatch on the program's chained state; returns the
        host buffer its harvest reads."""
        if sampling:
            self.sample_steps += self._decode_steps
        return self._program.dispatch(window, sampling)

    # -- self-speculative decoding (n-gram draft + batched verify) ----------

    def _collect_drafts(self) -> list[list[int]]:
        """Each slot's draft for this tick (``[]``: none).  The budget is
        the slot's adaptive length capped at ``remaining - 1``: a verify
        emits up to budget + 1 tokens, never past the request."""
        drafts: list[list[int]] = []
        for slot in self._slots:
            if slot is None or slot.draft is None:
                drafts.append([])
                continue
            budget = min(slot.draft.budget(), slot.remaining - 1)
            drafts.append(self._propose(slot, budget) if budget >= 1 else [])
        return drafts

    def _propose(self, slot: _Slot, budget: int) -> list[int]:
        """The n-gram ("prompt lookup") draft from the slot's own history;
        a method of its own so a test can put an oracle in its place."""
        return propose_ngram(slot.history[: slot.hist_len], budget,
                             self._spec.ngram_min, self._spec.ngram_max)

    def _verify_tick(self, active_np, window: int, drafts) -> None:
        """One draft + verify pass: each slot's pending token and draft,
        padded to the halving chain, in ONE forward; each slot emits its
        accepted draft prefix and the greedy token after it."""
        s_draft = pad_to_chain(max(len(d) for d in drafts), self._spec_chain)
        toks = np.zeros((self.max_slots, s_draft + 1), np.int32)
        draft_len = np.zeros((self.max_slots,), np.int32)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            toks[i, 0] = slot.generated[-1]  # the pending (emitted, unfed) token
            toks[i, 1:1 + len(drafts[i])] = drafts[i]
            draft_len[i] = len(drafts[i])
        t0 = time.perf_counter()
        self._beat("verify")
        greedy, accepted = self._run_op(
            OP_GEN_VERIFY,
            {"toks": toks, "active": active_np, "draft_len": draft_len, "window": window},
            lambda: self._device_verify(toks, active_np, draft_len, window))
        wall = time.perf_counter() - t0
        self.decode_forwards += 1
        self.spec_verify_ticks += 1
        n_active = int(active_np.sum())
        acc_total = int(accepted[active_np].sum())
        self._record_tick("verify", t0, wall, active_slots=n_active, tokens=n_active + acc_total,
                          spec_accepted=acc_total, cost=self._cost_decode(window, s_draft + 1))
        self._note_step(n_active, wall)
        for i, was_active in enumerate(active_np):
            slot = self._slots[i]
            if not was_active or slot is None:
                continue
            n_prop, n_acc = int(draft_len[i]), int(accepted[i])
            slot.draft.observe(n_prop, n_acc)
            if n_prop:
                self.spec_proposed_tokens += n_prop
                self.spec_accepted_tokens += n_acc
                if slot.trace is not None:
                    slot.trace.spec_proposed += n_prop
                    slot.trace.spec_accepted += n_acc
                if self._on_spec is not None:
                    self._on_spec(n_prop, n_acc)
            # The accepted draft prefix, then the bonus token; stop early
            # when the slot finishes (EOS, budget) or was cancelled.
            for j in range(n_acc + 1):
                self._record_token(i, int(greedy[i, j]))
                if self._slots[i] is None:
                    break

    def replay_verify(self, toks, active, draft_len, window) -> None:
        """Follower side of a speculative verify tick."""
        self._device_verify(np.asarray(toks), np.asarray(active), np.asarray(draft_len),
                            int(window))

    def _device_verify(self, toks, active_np, draft_len, window):
        """``verify_ragged``, the greedy argmax, ``speculative_accept``,
        then each active row's length advanced by accepted + 1 (the
        rejected positions' writes are never attended).  Returns host
        ``(greedy [B, S], accepted [B])``."""
        dev = self._device
        toks_t = torch.as_tensor(toks, dtype=torch.int64, device=dev)
        active = torch.as_tensor(active_np, device=dev)
        logits, self._cache = llama.verify_ragged(
            self._params, toks_t, self._cache, self._cfg, self._dtype, window, active,
            self._mesh,
        )
        greedy = torch.argmax(logits, dim=-1)
        accepted, nxt = speculative_accept(
            toks_t, greedy, torch.as_tensor(draft_len, device=dev))
        self._tokens = torch.where(active, nxt.to(torch.int64), toks_t[:, 0])[:, None]
        advance = torch.where(active, accepted + 1, 0).to(torch.int32)
        self._cache = self._cache._replace(lengths=self._cache.lengths + advance)
        return greedy.cpu().numpy(), accepted.cpu().numpy()

    # -- the unified ragged super-step (unified_step) ---------------------------

    def _parked_superstep(self) -> tuple:
        """A fully parked super-step's host inputs: every row idle (zero
        counts park every K/V write, inactive rows emit nothing, ``last_pos``
        -1 finalizes nothing) with neutral sampling parameters.  The capture
        stages it as it is; :meth:`_super_tick` overwrites the tick's rows."""
        B, S = self.max_slots, self._super_width
        return (
            np.zeros((B, S), np.int64),   # ids
            np.zeros((B,), np.int32),     # roles (all ROLE_IDLE)
            np.zeros((B,), np.int32),     # offsets
            np.zeros((B,), np.int32),     # counts
            np.zeros((B,), np.int32),     # draft_len
            np.zeros((B,), bool),         # active
            np.zeros((B,), np.int32),     # remaining
            np.full((B,), -1, np.int32),  # eos_ids
            np.full((B,), -1, np.int32),  # last_pos
            np.zeros((B,), np.int32),     # final_lens
            np.zeros((B, 2), np.int64),   # slot keys
            np.zeros((B,), np.float32),   # r_temps
            np.zeros((B,), np.int32),     # r_tks
            np.ones((B,), np.float32),    # r_tps
        )

    def _super_tick(self) -> None:
        """ONE dispatch a tick: every occupied slot as a decode row or, on an
        all-greedy tick with a draft in hand, a verify row, and up to the
        packed budget of in-flight admissions' next chunks as prefill rows;
        then the harvest of all three roles from the one readback."""
        B = self.max_slots
        occupied = np.array([s is not None for s in self._slots])
        chunk_progs: list[_PrefillProgress] = []
        if self._packed and self._pending:
            C = self._prefill_chunk_size
            max_chunks = self._prefill_batch
            if self._prefill_token_budget:
                max_chunks = min(max_chunks, max(1, self._prefill_token_budget // C))
            for prog in self._pending[:max_chunks]:
                if prog.cached_tokens and not prog.seeded:
                    # Seeds stay their own op: a radix copy is not a forward.
                    self._seed_reserved(prog)
                else:
                    chunk_progs.append(prog)
        if not occupied.any() and not chunk_progs:
            self._note_step(0, 0.0)
            return
        self._beat("superstep")
        K = self._decode_steps
        sampling = any(s is not None and s.sampling for s in self._slots)
        drafts: list[list[int]] = [[] for _ in range(B)]
        if self._spec is not None and not sampling and occupied.any():
            drafts = self._collect_drafts()
        (ids, roles, offsets, counts, draft_len, active, remaining, eos_ids, last_pos,
         final_lens, slot_keys, r_temps, r_tks, r_tps) = self._parked_superstep()
        decode_hi = other_hi = 0
        n_dec = n_ver = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            pos = slot.prompt_len + len(slot.generated)
            ids[i, 0] = slot.generated[-1]  # the pending (emitted, unfed) token
            active[i] = True
            d = drafts[i]
            if d:
                roles[i] = llama.ROLE_VERIFY
                ids[i, 1:1 + len(d)] = d
                draft_len[i] = len(d)
                counts[i] = len(d) + 1
                other_hi = max(other_hi, pos)
                n_ver += 1
            else:
                roles[i] = llama.ROLE_DECODE
                counts[i] = 1
                remaining[i] = slot.remaining
                if slot.eos_id is not None:
                    eos_ids[i] = slot.eos_id
                decode_hi = max(decode_hi, pos)
                n_dec += 1
        C = self._prefill_chunk_size
        for prog in chunk_progs:
            i, req = prog.slot, prog.req
            roles[i] = llama.ROLE_PREFILL
            off = prog.cached_tokens + prog.next_idx * C
            offsets[i] = off
            counts[i] = C
            ids[i, :C] = prog.chunks[prog.next_idx][0]
            other_hi = max(other_hi, off)
            if prog.next_idx == len(prog.chunks) - 1:
                L = int(req.prompt.size)
                last_pos[i] = (L - 1) - off
                final_lens[i] = L
                r_temps[i], r_tks[i], r_tps[i] = req.temperature, req.top_k, req.top_p
                key = self._slot_key_for(req)
                if key is not None:  # greedy: the draw takes the argmax
                    slot_keys[i] = key.cpu().numpy()
        window = superstep_window(decode_hi, other_hi, K, self.capacity)
        n_pre = len(chunk_progs)
        t0 = time.perf_counter()
        args = (ids, roles, offsets, counts, draft_len, active, remaining, eos_ids, last_pos,
                final_lens, slot_keys, r_temps, r_tks, r_tps, window, sampling)
        out = self._run_op(OP_GEN_SUPERSTEP, dict(zip(_SUPERSTEP_ARGS, args)),
                           lambda: self._device_superstep(*args))
        end = time.perf_counter()
        wall = end - t0
        # The finalize draws every row's first token; a sampling tick adds K steps.
        self.sample_steps += 1 + (K if sampling else 0)
        self.decode_forwards += 1
        if n_pre:
            self.prefill_chunks_dispatched += n_pre
            self.prefill_forwards += 1
            if self._on_prefill_batch is not None:
                self._on_prefill_batch(n_pre)
        if n_ver:
            self.spec_verify_ticks += 1
        finals = sum(1 for prog in chunk_progs if prog.next_idx == len(prog.chunks) - 1)
        acc_total = int(out.accepted[occupied].sum()) if n_ver else 0
        self._record_tick("superstep", t0, wall, active_slots=int(occupied.sum()),
                          batch_fill=n_pre,
                          tokens=int(out.valid.sum()) + n_ver + acc_total + finals,
                          spec_accepted=acc_total, steps=K,
                          cost=self._cost_superstep(window, self._super_width, K),
                          roles={"prefill": n_pre, "decode": n_dec, "verify": n_ver})
        self._note_step(int(occupied.sum()), wall)
        # Prefill harvest: the packed tick's bookkeeping.
        for prog in chunk_progs:
            self._note_chunk(prog)
            self._maybe_cache_chunk(prog)
            prog.next_idx += 1
            if prog.next_idx < len(prog.chunks):
                continue
            self._pending.remove(prog)
            self._reserved.discard(prog.slot)
            self._slots[prog.slot] = self._new_slot(prog.req)
            self._note_ttft(prog.req)
            self._record_token(prog.slot, int(out.firsts[prog.slot]))
        # Decode and verify harvest from the same readback.
        for i in range(B):
            slot = self._slots[i]
            if not occupied[i] or slot is None:
                continue
            if roles[i] == llama.ROLE_VERIFY:
                n_prop, n_acc = int(draft_len[i]), int(out.accepted[i])
                slot.draft.observe(n_prop, n_acc)
                self.spec_proposed_tokens += n_prop
                self.spec_accepted_tokens += n_acc
                if slot.trace is not None:
                    slot.trace.spec_proposed += n_prop
                    slot.trace.spec_accepted += n_acc
                if self._on_spec is not None:
                    self._on_spec(n_prop, n_acc)
                for j in range(n_acc + 1):
                    self._record_token(i, int(out.greedy[i, j]))
                    if self._slots[i] is None:
                        break
                continue
            n = int(out.valid[i])
            # Tokens spaced across the tick's wall (the fused harvest's rule):
            # K tokens on one instant would read every ITL as 0.
            base = max(t0, slot.t_last_token)
            span = max(end - base, 0.0)
            for j in range(n):
                self._record_token(i, int(out.tok_block[i, j]), t=base + span * (j + 1) / n)
                if self._slots[i] is None:
                    break  # finished (EOS, budget) or cancelled mid-block

    def replay_superstep(self, **inputs) -> None:
        """Follower side of a unified super-step tick (self-contained host
        inputs: nothing chains from the leader)."""
        self._device_superstep(*(inputs[k] for k in _SUPERSTEP_ARGS))

    def _device_superstep(self, ids, roles, offsets, counts, draft_len, active, remaining,
                          eos_ids, last_pos, final_lens, slot_keys, r_temps, r_tks, r_tps,
                          window: int, sampling: bool):
        """One unified tick on the program: the engine's state into its
        buffers (nothing to copy unless an admission replaced a tensor), the
        host inputs staged, one replay (the eager call on the CPU) and the
        synchronous readback (``cuda_graphs.SuperstepOut``)."""
        self._bind_program_state()
        prog = self._program
        prog.stage(ids, roles, offsets, counts, draft_len, active, remaining, eos_ids,
                   last_pos, final_lens, slot_keys, r_temps, r_tks, r_tps)
        return prog.dispatch(window, sampling)

    def _loop(self) -> None:
        while not self._stop.is_set():
            # The idle stamp is overwritten just before each dispatch, so a
            # wedged tick is charged to its kind.
            self._beat("idle")
            with self._turnstile:
                pass
            with self._tick_gate:
                if not self._admit_phase():
                    return  # shutdown sentinel
                try:
                    self._step()
                except Exception:
                    _log.exception("decode step failed")
                    self._fail_all_and_recover()

    @contextlib.contextmanager
    def between_ticks(self):
        """A context in which the scheduler launches nothing: entered
        between two iterations (at most one idle poll away), held until
        exit.  For work that must not run beside a dispatch: the
        profiler's start and stop, which deadlocked against a concurrent
        CUDA graph replay on the card.  Never entered on the scheduler
        thread itself (its hooks included)."""
        with self._turnstile, self._tick_gate:
            yield

    def _admit_phase(self) -> bool:
        """Admission work for one scheduler iteration: whole-prompt mode
        drains every free slot; chunked mode advances the in-flight
        admission by ONE chunk (or starts a new one), so a decode tick is
        never more than one prefill chunk away.  Under preemption it first
        evicts at most one lower-class slot for waiting higher-class work;
        every burst has drained its harvest by then.  Control ops run first.
        Returns False on the shutdown sentinel."""
        self._drain_control_ops()
        if self._preemption:
            self._maybe_preempt()
        if self._packed:
            return self._admit_phase_packed()
        if self._pending:
            prog = self._pending[0]  # _chunk_tick pops it on finish
            try:
                self._chunk_tick()
            except Exception as exc:
                _log.exception("chunked prefill failed")
                self._note_admission_crash([prog.req])
                self._pending = []
                self._seq_state = None
                if not prog.req.future.done():
                    _safe_fail(prog.req.future, exc)
                self._fail_all_and_recover()
            return True
        while self._free_slot() is not None:
            try:
                idle = all(s is None for s in self._slots)
                req = self._dequeue(idle, self._idle_poll_s)
            except queue.Empty:
                break
            if isinstance(req, _Wake):
                self._drain_control_ops()
                continue
            if req is not None:
                self._release_queued(req)  # left the admission queue
            if req is None or self._stop.is_set():
                self._refuse_at_shutdown(req)
                return False
            if isinstance(req, _Preempted):
                # Straight into the free slot the loop found: no prefill.
                self._restore_or_fail(req)
                continue
            self._note_admission_wait(req)
            if self._prefill_chunk_size is not None:
                prog = self._make_progress(req)
                if self._sp_eligible(req) and not prog.cached_tokens:
                    # A long cold prompt: one ring pass now instead of L/C
                    # serial chunk ticks (a warm prefix keeps the seed and
                    # its suffix chunks).
                    self._admit_sp_or_fail(req)
                    continue
                self._pending.append(prog)
                return True  # first chunk (or seed) runs next iteration's admit phase
            if self._sp_eligible(req):
                self._admit_sp_or_fail(req)
                continue
            try:
                self._admit(req)
            except Exception as exc:  # keep the scheduler alive
                _log.exception("admit failed")
                self._note_admission_crash([req])
                if not req.future.done():
                    _safe_fail(req.future, exc)
                self._fail_all_and_recover()
        return True

    def _admit_sp_or_fail(self, req: _Request) -> None:
        """:meth:`_admit_sp`; a failure fails the request, drops the stale
        scratch and recovers the device state."""
        try:
            self._admit_sp(req)
        except Exception as exc:
            _log.exception("sp prefill failed")
            self._note_admission_crash([req])
            self._seq_state = None
            if not req.future.done():
                _safe_fail(req.future, exc)
            self._fail_all_and_recover()

    def _restore_or_fail(self, rec: _Preempted) -> None:
        """Restore an evicted sequence; a failed restore fails its own
        future and recovers the device state."""
        try:
            self._admit_restore(rec)
        except Exception as exc:
            _log.exception("preemption restore failed")
            self._note_admission_crash([rec])
            if not rec.future.done():
                self._abort_trace(rec.trace, "error")
                _safe_fail(rec.future, exc)
            self._fail_all_and_recover()

    def _refuse_at_shutdown(self, req: "_Request | _Preempted | None") -> None:
        """Fail a request dequeued after shutdown began (None: the sentinel)."""
        if req is not None and not req.future.done():
            self._abort_trace(req.trace, "shutdown")
            _safe_fail(
                req.future,
                EngineShutdown("engine shut down before admission; retry on another replica"),
            )

    def _admit_phase_packed(self) -> bool:
        """Packed-mode admission: top up the in-flight admissions (each new
        one reserves a free cache row), then advance up to
        ``prefill_batch`` of them by one packed forward.  Returns False on
        the shutdown sentinel."""
        popped = False
        while self._free_slot() is not None:
            idle = not self._pending and all(s is None for s in self._slots)
            try:
                req = self._dequeue(idle and not popped, self._idle_poll_s)
            except queue.Empty:
                break
            if isinstance(req, _Wake):
                self._drain_control_ops()
                continue
            if req is not None:
                self._release_queued(req)  # left the admission queue
            if req is None or self._stop.is_set():
                self._refuse_at_shutdown(req)
                return False
            if isinstance(req, _Preempted):
                # The unified engine's route too: a restore is no prefill
                # row, so it takes its slot here, before the next dispatch.
                self._restore_or_fail(req)
                popped = True
                continue
            self._note_admission_wait(req)
            prog = self._make_progress(req)
            if self._sp_eligible(req) and not prog.cached_tokens:
                # A long cold prompt: the ring pass (the batch-1 scratch, no
                # reserved row) instead of packing its L/C chunks.
                self._admit_sp_or_fail(req)
                popped = True
                continue
            prog.slot = self._free_slot()
            self._reserved.add(prog.slot)
            self._pending.append(prog)
            popped = True
        if not self._pending:
            return True
        if self._unified:
            # The chunks ride the next super-step dispatch; a failure there
            # runs _loop's recovery, which fails packed admissions too.
            return True
        try:
            self._packed_tick()
        except Exception as exc:
            _log.exception("packed prefill failed")
            self._note_admission_crash([p.req for p in self._pending])
            for prog in self._pending:
                if not prog.req.future.done():
                    _safe_fail(prog.req.future, exc)
            self._pending = []
            self._reserved.clear()
            self._fail_all_and_recover()
        return True

    def _fail_all_and_recover(self) -> None:
        """Fail every in-flight sequence and reallocate device state: a
        failed step may have written part of the cache in place.  Packed
        admissions prefill straight into their reserved rows, which the
        reset zeroes, so they fail too (single-mode admissions live in the
        batch-1 scratch and survive)."""
        for i, slot in enumerate(self._slots):
            if slot is not None and not slot.future.done():
                self._abort_trace(slot.trace, "error")
                _safe_fail(
                    slot.future,
                    RuntimeError("generation step failed; see server log"),
                )
            self._slots[i] = None
        if self._packed:
            for prog in self._pending:
                if not prog.req.future.done():
                    self._abort_trace(prog.req.trace, "error")
                    _safe_fail(
                        prog.req.future,
                        RuntimeError("generation step failed; see server log"),
                    )
            self._pending = []
            self._reserved.clear()
        try:
            # Followers ran the op that failed here (or failed it first):
            # every rank drops to the same fresh state, or each later
            # replayed op would run on disagreeing state.
            self._run_op(OP_GEN_RESET, {}, self._reset_device_state)
        except Exception:
            _log.exception("device state reallocation failed")

    def replay_reset(self) -> None:
        """Follower side of the leader's recovery."""
        self._reset_device_state()
