"""A replica of several ranks acting as one unit (port of the JAX package's
``server/multihost.py``).

A replica whose ``meshShape`` spans N ranks runs N processes that must
enter every collective together.  Rank 0 (the **leader**) owns the HTTP
frontend and the scheduler; ranks 1..N-1 (**followers**) run
:func:`follower_loop`: block on a broadcast from the leader, repeat the
same device op with the same host inputs, and wait again.  Follower order
is broadcast order, so the leader makes (broadcast, run) atomic in
:class:`UnitChannel`, which every leader-side dispatcher shares.

The reference's unit is one process a host, each driving its host's
devices through GSPMD; here one process a device is PyTorch's idiom, and
the same design serves the ranks of one host as well as several hosts.
The channel is :class:`TorchDistTransport`, a broadcast over the
world-wide gloo control group (``parallel/distributed.py``), in the
reference's two rounds: a ``uint32`` length, then the payload.  Tests use
:class:`LocalGroupTransport` (threads and barriers) for a unit inside one
process.

A follower's failed generation op is fatal to it (its state would
disagree with every other rank's): it exits its loop, and the leader's
next collective fails, so the unit restarts.  The leader's failed op
broadcasts ``OP_GEN_RESET`` (``GenerationEngine._fail_all_and_recover``).

A warm-pool unit's followers hold their engines in a
:class:`FollowerEngines`, which the port's own unit ops swap:
``OP_ATTACH`` loads a model on every rank (the ranks agree that each
succeeded, or every rank stays in the warm pool), ``OP_DETACH`` drops it
and frees the card's memory, ``OP_REPORT`` gathers each rank's report to
the leader.  Only ``OP_SHUTDOWN`` ends a follower's loop.
"""

from __future__ import annotations

import logging
import pickle
import threading
import time
from typing import Any, Mapping, Protocol

import numpy as np

_log = logging.getLogger("tpumlops_torch.multihost")

OP_PREDICT = "predict"
OP_SHUTDOWN = "shutdown"
OP_GEN_ADMIT = "gen_admit"  # whole-prompt prefill + insert (replayed)
OP_GEN_STEP = "gen_step"  # continuous-batching decode tick (replayed)
OP_GEN_RESET = "gen_reset"  # leader recovered from a failed step: drop state
OP_GEN_CHUNK = "gen_chunk"  # chunked prefill: one prompt chunk (replayed)
OP_GEN_INSERT = "gen_insert"  # chunked prefill: install sequence into slot
OP_GEN_SEED = "gen_seed"  # prefix-cache hit: seed seq cache from cached K/V
OP_GEN_VERIFY = "gen_verify"  # speculative draft+verify tick (replayed)
OP_GEN_CHUNKS = "gen_chunks"  # packed prefill: batched multi-admission chunks
OP_GEN_SEED_SLOT = "gen_seed_slot"  # packed prefill / restore: seed a cache row
OP_GEN_MULTISTEP = "gen_multistep"  # fused K-step decode tick (replayed);
#   chained ticks of a burst carry no burst-entry inputs: the state each
#   rank's OWN previous replay left keeps the unit in lockstep
OP_GEN_SP_PREFILL = "gen_sp_prefill"  # sp ring prefill into the scratch (replayed)
OP_GEN_RESTORE = "gen_restore"  # preemption restore: a slot's state rows
OP_GEN_SUPERSTEP = "gen_superstep"  # unified ragged super-step tick
# The port's own op: a prefix-cache read of a chunk's K/V gathers every
# rank's heads (and the owning dp shard's row), so every rank joins it.
OP_GEN_READ = "gen_read"
# The port's warm-pool unit ops: attach a model on every rank ({model_uri}),
# drop it (a release or a replace; the followers stay), and gather every
# rank's report to the leader.
OP_ATTACH = "attach"
OP_DETACH = "detach"
OP_REPORT = "report"

# Round 1 of a broadcast is the payload's byte length as uint32; round 2 is
# the payload.  Two rounds because a broadcast needs same-shape buffers on
# every rank, and followers cannot know the payload's size ahead of time.
_LEN_DTYPE = np.uint32

# Op -> the follower engine's method that repeats it.
_REPLAY = {
    OP_GEN_ADMIT: "replay_admit",
    OP_GEN_STEP: "replay_step",
    OP_GEN_RESET: "replay_reset",
    OP_GEN_CHUNK: "replay_chunk",
    OP_GEN_INSERT: "replay_insert",
    OP_GEN_SEED: "replay_seed",
    OP_GEN_VERIFY: "replay_verify",
    OP_GEN_CHUNKS: "replay_chunks",
    OP_GEN_SEED_SLOT: "replay_seed_slot",
    OP_GEN_MULTISTEP: "replay_multistep",
    OP_GEN_SUPERSTEP: "replay_superstep",
    OP_GEN_RESTORE: "replay_restore",
    OP_GEN_READ: "replay_read",
    OP_GEN_SP_PREFILL: "replay_sp_prefill",
}


class GroupTransport(Protocol):
    """One-to-all broadcast within the unit."""

    @property
    def is_leader(self) -> bool: ...

    def broadcast(self, payload: bytes | None) -> bytes:
        """Leader passes ``payload``; followers pass ``None``.  Every rank
        returns the leader's bytes."""
        ...


class TorchDistTransport:
    """Broadcast over a ``torch.distributed`` gloo group (the control group
    by default: its timeout is one an idle unit cannot reach).  Host bytes
    only, whatever backend the model's collectives use."""

    def __init__(self, group=None) -> None:
        import torch.distributed as dist

        from ..parallel.distributed import control_group

        self._group = group if group is not None else control_group()
        self._rank = dist.get_rank()
        # The leader is global rank 0, whatever the group's own numbering.
        self._src = 0

    @property
    def is_leader(self) -> bool:
        return self._rank == 0

    def broadcast(self, payload: bytes | None) -> bytes:
        import torch
        import torch.distributed as dist

        if self.is_leader:
            if payload is None:
                raise ValueError("leader must supply a payload")
            buf = np.frombuffer(payload, dtype=np.uint8)
            n = np.asarray([len(buf)], dtype=_LEN_DTYPE)
        else:
            buf = None
            n = np.zeros(1, dtype=_LEN_DTYPE)
        # gloo has no uint32: the same four bytes travel as int32.
        n_t = torch.from_numpy(n.view(np.int32).copy())
        dist.broadcast(n_t, src=self._src, group=self._group)
        size = int(n_t.numpy().view(_LEN_DTYPE)[0])
        out = (torch.from_numpy(buf.copy()) if buf is not None
               else torch.zeros(size, dtype=torch.uint8))
        dist.broadcast(out, src=self._src, group=self._group)
        return out.numpy().tobytes()


class LocalGroupTransport:
    """In-process fake: N threads acting as N ranks (tests and docs).
    Construct one :class:`_LocalGroup` and take a transport a rank."""

    def __init__(self, group: "_LocalGroup", rank: int) -> None:
        self._group = group
        self._rank = rank

    @property
    def is_leader(self) -> bool:
        return self._rank == 0

    def broadcast(self, payload: bytes | None) -> bytes:
        return self._group.broadcast(self._rank, payload)


class _LocalGroup:
    def __init__(self, size: int) -> None:
        self.size = size
        self._slot: bytes | None = None
        self._fill = threading.Barrier(size)
        self._drain = threading.Barrier(size)

    def broadcast(self, rank: int, payload: bytes | None) -> bytes:
        if rank == 0:
            if payload is None:
                raise ValueError("leader must supply a payload")
            self._slot = payload
        self._fill.wait()
        out = self._slot
        self._drain.wait()
        if out is None:
            raise RuntimeError("broadcast round completed without a payload")
        return out

    def transports(self) -> list[LocalGroupTransport]:
        return [LocalGroupTransport(self, r) for r in range(self.size)]


# ---------------------------------------------------------------------------
# Message encoding
# ---------------------------------------------------------------------------


def encode_message(op: str, inputs: Mapping[str, Any] | None = None) -> bytes:
    """The reference's pickle form, so equal inputs give equal bytes.
    Pickle is safe here: the channel is the unit's own process group, and
    every peer runs the same trusted server image."""
    return pickle.dumps((op, dict(inputs) if inputs is not None else None))


def decode_message(raw: bytes) -> tuple[str, dict | None]:
    op, inputs = pickle.loads(raw)
    return op, inputs


# ---------------------------------------------------------------------------
# Leader-side engine wrapper + follower loop
# ---------------------------------------------------------------------------


class UnitChannel:
    """Serialized broadcast + run for every leader-side dispatcher: the
    batcher's predict path and the generation scheduler share one lock, so
    followers see ops in the order the leader runs them."""

    def __init__(self, transport: GroupTransport) -> None:
        self.transport = transport
        self.lock = threading.RLock()
        self.closed = False

    def run(self, payload: bytes, fn):
        with self.lock:
            if self.closed:
                # After OP_SHUTDOWN the followers have left their loop; a
                # further broadcast would wait on peers that are gone.
                raise RuntimeError("multihost unit is shut down")
            self.transport.broadcast(payload)
            return fn()

    def close_with(self, payload: bytes) -> None:
        with self.lock:
            if self.closed:
                return
            self.closed = True
            self.transport.broadcast(payload)


class MultihostEngine:
    """Duck-types the inference engine for the batcher and the app; every
    ``predict`` is broadcast first so followers run it in lockstep.
    ``warmup`` routes through ``self.predict`` so followers warm the same
    batch buckets the leader does."""

    def __init__(self, engine: Any, transport: GroupTransport,
                 channel: UnitChannel | None = None) -> None:
        if not transport.is_leader:
            raise ValueError("MultihostEngine is leader-side; followers run follower_loop")
        self._engine = engine
        self._transport = transport
        # Shared with the generation scheduler (see UnitChannel).
        self.channel = channel or UnitChannel(transport)

    @property
    def predictor(self):
        return self._engine.predictor

    @property
    def max_batch_size(self) -> int:
        return self._engine.max_batch_size

    @property
    def dispatches(self) -> int:
        return self._engine.dispatches

    def predict(self, inputs: Mapping[str, np.ndarray]) -> Any:
        return self.channel.run(
            encode_message(OP_PREDICT, inputs),
            lambda: self._engine.predict(inputs),
        )

    def predict_async(self, inputs: Mapping[str, np.ndarray]) -> Any:
        """The batcher's launch: broadcast and launch under the channel's
        lock, so the followers replay batches in the order the leader
        launches them (the batcher launches batch N+1 while N runs; a
        follower replays each synchronously)."""
        return self.channel.run(
            encode_message(OP_PREDICT, inputs),
            lambda: self._engine.predict_async(inputs),
        )

    def materialize(self, out: Any) -> Any:
        return self._engine.materialize(out)

    def warmup(self, predict=None) -> float:
        """``predict``: the dispatch path (the server passes its batcher's,
        whose launches broadcast through :meth:`predict_async`)."""
        return self._engine.warmup(predict=predict or self.predict)

    def shutdown(self) -> None:
        """Release the followers; without this they wait on the broadcast
        forever and the unit never terminates."""
        self.channel.close_with(encode_message(OP_SHUTDOWN))


def note_op(stats: dict | None, op: str, seconds: float) -> None:
    """Add one op's wall to ``stats`` (op -> [count, total s, max s])."""
    if stats is None:
        return
    row = stats.setdefault(op, [0, 0.0, 0.0])
    row[0] += 1
    row[1] += seconds
    row[2] = max(row[2], seconds)


class FollowerEngines:
    """What a follower replays on: its predict ``engine`` (an
    ``InferenceEngine``) and its ``gen_engine`` (a never-started
    ``GenerationEngine``), either None.  A warm-pool unit's attach swaps
    them: ``attach_fn(model_uri)`` returns the pair (None, None when any
    rank failed: every rank stays in the warm pool; it joins the unit's
    agreement itself and raises nothing), ``release_fn(engine,
    gen_engine)`` frees a pair.  ``report_fn(engines, stats)`` builds this
    rank's report for ``OP_REPORT``."""

    def __init__(self, engine: Any = None, gen_engine: Any = None, attach_fn=None,
                 release_fn=None, report_fn=None) -> None:
        self.engine = engine
        self.gen_engine = gen_engine
        self.attach_fn = attach_fn
        self.release_fn = release_fn
        self.report_fn = report_fn

    def attach(self, model_uri: str) -> None:
        if self.attach_fn is None:
            raise RuntimeError("attach on a unit that is not a warm pool")
        self.detach()
        self.engine, self.gen_engine = self.attach_fn(model_uri)

    def detach(self) -> None:
        engine, gen_engine = self.engine, self.gen_engine
        self.engine = self.gen_engine = None
        if self.release_fn is not None:
            self.release_fn(engine, gen_engine)


def gather_reports(report: dict) -> list | None:
    """Every rank's ``report`` gathered to the leader over the world-wide
    control group: the list in rank order on the leader, None elsewhere."""
    import torch.distributed as dist

    from ..parallel.distributed import control_group

    leader = dist.get_rank() == 0
    out = [None] * dist.get_world_size() if leader else None
    dist.gather_object(report, out, dst=0, group=control_group())
    return out


def follower_loop(engine: Any, transport: GroupTransport, gen_engine: Any = None,
                  stats: dict | None = None, engines: FollowerEngines | None = None) -> int:
    """Run on ranks 1..N-1: repeat broadcast ops until shutdown.

    ``gen_engine`` (a never-started ``GenerationEngine``) repeats the
    leader's generation ops, ``engine`` its predict batches; ``engines``
    (a :class:`FollowerEngines`) holds them instead where an attach can swap
    them.  ``stats`` (op -> [count, total s, max s]) receives each op's
    wall.  Returns the number of ops run."""
    if transport.is_leader:
        raise ValueError("follower_loop must not run on the leader")
    if engines is None:
        engines = FollowerEngines(engine, gen_engine)
    steps = 0
    while True:
        op, inputs = decode_message(transport.broadcast(None))
        if op == OP_SHUTDOWN:
            _log.info("follower received shutdown after %d steps", steps)
            return steps
        t0 = time.perf_counter()
        try:  # the op's wall is noted whether it ran or raised
            if op == OP_PREDICT:
                if engines.engine is None:
                    raise RuntimeError("predict on a unit without a predict engine")
                engines.engine.predict(inputs)
            elif op in _REPLAY:
                if engines.gen_engine is None:
                    raise RuntimeError("GEN op on a unit without a gen engine")
                getattr(engines.gen_engine, _REPLAY[op])(**(inputs or {}))
            elif op == OP_ATTACH:
                engines.attach(**inputs)
            elif op == OP_DETACH:
                engines.detach()
            elif op == OP_REPORT:
                try:  # the leader waits in the gather: always join it
                    report = engines.report_fn(engines, stats) if engines.report_fn else {}
                except Exception as e:
                    report = {"error": f"{type(e).__name__}: {e}"}
                gather_reports(report)
            else:  # unknown op: skip rather than desync the group
                _log.warning("follower ignoring unknown op %r", op)
        except Exception:
            if op in _REPLAY:
                # Generation is STATEFUL: a rank that failed an op the
                # leader ran now disagrees with every other rank.  Fail
                # loud: leave the loop, so the process group breaks, the
                # leader's next collective errors and the unit restarts.
                _log.exception("follower gen step %r failed; exiting so the unit "
                               "restarts instead of serving corrupted tokens", op)
                raise
            # predict is stateless: the leader's handler gets the same error
            # and stays up; a follower that died could not rejoin the group.
            # An attach's failure was agreed on by every rank inside it.
            _log.exception("follower step %r failed; continuing", op)
        finally:
            note_op(stats, op, time.perf_counter() - t0)
        steps += 1
