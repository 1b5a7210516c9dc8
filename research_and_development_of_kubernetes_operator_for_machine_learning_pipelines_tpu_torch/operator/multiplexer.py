"""Multi-model multiplexer: bin-packs N CRs onto a shared warm pool (the
port's copy of the JAX package's ``operator/multiplexer.py``; it drives the
port server's ``POST /admin/attach`` and ``/readyz`` over ``urllib``).

λScale/Cicada-style serverless serving: one CR per model
wastes cards on the long tail of rarely-hit models — most hold a whole
replica for near-zero traffic.  This module closes that gap by treating
warm-pool replicas (``--warm-pool 1``: booted, NO weights until
``POST /admin/attach``) as a *shared* substrate: every ``MlflowModel``
that names the same ``spec.multiplex.poolRef`` competes for the pool's
replicas by observed traffic, and the packer swaps models in seconds via
snapshot restore instead of holding one pod per model forever.

Division of labor (same shape as the autoscaler):

- :func:`plan` is a **pure function** of (pool, models, replicas, wall):
  score each model ``weight × (parked + queue_depth)``, rank, keep every
  attachment already serving a winner (minimal moves — a convergence
  pass over a settled pool emits NOTHING), assign the remaining winners
  to empty replicas first and lowest-scored losers last.  A model with
  zero traffic holds no replica: its requests park at the router, and
  the parked gauge's ``model`` label is exactly the wake signal that
  puts it back in the ranking next pass.
- :class:`Multiplexer` owns the pool-level I/O: refresh observations
  (router parked breakdown + ``/readyz`` attached-model reports),
  execute the plan's moves through the *existing* warm-pool admin
  endpoint, and buffer the resulting :class:`MuxRecord`\\ s per model so
  each CR's reconciler journals its own slice into ``status.history`` /
  ``/debug/rollouts``.  The reconciler drives it (``_multiplex_step``
  pumps the shared coordinator), so the control loop stays: observe →
  plan → execute → journal.

Safety comes from the server's attach identity contract: an attach of
the uri+snapshot-hash already on the device is an idempotent no-op (the
packer can re-emit its plan every pass), and a geometry-incompatible
replace is a typed 409 that leaves the attached model serving.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from .rollout_recorder import _iso

# Typed reasons on hold/error MuxRecords ("why did this model not get
# (or keep) a replica"), mirrored by the ``action`` label on
# tpumlops_operator_mux_moves.
HOLD_POOL_FULL = "pool_full"
ERR_ATTACH_FAILED = "attach_failed"


@dataclass(frozen=True)
class MuxModel:
    """One multiplexed model as the packer observes it."""

    name: str  # CR / model id (the router's model key)
    uri: str  # artifact URI the pool attaches (snapshot-keyed)
    weight: float = 1.0  # spec.multiplex.weight: packer bias
    parked: int = 0  # router park-buffer entries for this model
    queue_depth: float = 0.0  # engine queue depth where it serves

    @property
    def score(self) -> float:
        """Traffic pressure: what the packer ranks by.  Zero = the
        model holds nothing (scale-to-zero is the default state)."""
        return self.weight * (self.parked + self.queue_depth)


@dataclass(frozen=True)
class MuxReplica:
    """One shared warm-pool replica and what it currently holds."""

    name: str
    url: str = ""  # admin base url, e.g. http://127.0.0.1:9001
    attached_uri: str | None = None  # /readyz attached-model report


@dataclass(frozen=True)
class MuxRecord:
    """One packer decision, journaled beside gate/scale records
    (``kind: "mux"``) so a swap ladder is reconstructable from
    ``status.history`` or ``GET /debug/rollouts`` alone."""

    wall: float
    action: str  # "attach" | "replace" | "noop" | "hold" | "error"
    pool: str = ""
    model: str = ""
    model_uri: str = ""
    replica: str | None = None  # None on holds (no replica involved)
    displaced: str | None = None  # uri a replace evicted
    reason: str = ""
    score: float = 0.0
    parked: int = 0
    snapshot_hash: str | None = None  # echoed by the attach endpoint

    def as_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "kind": "mux",
            "ts": self.wall,
            "time": _iso(self.wall),
            "action": self.action,
            "pool": self.pool,
            "model": self.model,
            "modelUri": self.model_uri,
            "reason": self.reason,
            "score": self.score,
            "parked": self.parked,
        }
        # Optional keys omitted — not nulled — so hold records stay as
        # compact as autoscaler holds.
        if self.replica is not None:
            out["replica"] = self.replica
        if self.displaced is not None:
            out["displaced"] = self.displaced
        if self.snapshot_hash is not None:
            out["snapshotHash"] = self.snapshot_hash
        return out


@dataclass(frozen=True)
class MuxMove:
    """One attach/replace the plan wants executed."""

    replica: MuxReplica
    model: MuxModel
    replace: bool
    displaced: str | None  # uri being evicted (None on empty replica)


@dataclass(frozen=True)
class MuxPlan:
    pool: str
    moves: tuple = ()
    holds: tuple = ()  # MuxRecords for wanted-but-unplaced models

    @property
    def converged(self) -> bool:
        return not self.moves


def plan(
    pool: str,
    models: Sequence[MuxModel],
    replicas: Sequence[MuxReplica],
    wall: float,
    stragglers: frozenset = frozenset(),
) -> MuxPlan:
    """Pure bin-pack pass: who should hold what, expressed as moves.

    Minimal-move by construction: a replica already serving a winner is
    never touched, so re-running the plan against a settled pool yields
    zero moves (and the attach endpoint's idempotent no-op backstops
    even a re-emitted one).  Ties rank by name for determinism.

    ``stragglers`` (anomaly-observatory verdicts, operator/anomaly.py)
    demotes the named replicas to LAST choice as attach targets: a
    model newly winning capacity should not land on the pool's slowest
    device.  The empty set leaves every decision byte-identical.
    """
    ranked = sorted(
        (m for m in models if m.score > 0),
        key=lambda m: (-m.score, m.name),
    )
    winners = ranked[: len(replicas)]
    winner_uris = {m.uri for m in winners}
    score_by_uri = {m.uri: m.score for m in models}
    satisfied = {
        r.attached_uri for r in replicas if r.attached_uri in winner_uris
    }
    # Free list: healthy replicas before stragglers, then empty replicas
    # first, then losers cheapest-first (evict the attachment with the
    # least traffic behind it).
    free = sorted(
        (r for r in replicas if r.attached_uri not in winner_uris),
        key=lambda r: (
            r.name in stragglers,
            r.attached_uri is not None,
            score_by_uri.get(r.attached_uri, 0.0),
            r.name,
        ),
    )
    moves = []
    holds = []
    for m in winners:
        if m.uri in satisfied:
            continue
        if not free:
            # Cannot happen with distinct uris (|winners| <= |replicas|)
            # but two CRs sharing one uri make it reachable; journal it.
            holds.append(
                MuxRecord(
                    wall=wall, action="hold", pool=pool, model=m.name,
                    model_uri=m.uri, reason=HOLD_POOL_FULL,
                    score=m.score, parked=m.parked,
                )
            )
            continue
        r = free.pop(0)
        moves.append(
            MuxMove(
                replica=r,
                model=m,
                replace=r.attached_uri is not None,
                displaced=r.attached_uri,
            )
        )
    for m in ranked[len(replicas):]:
        holds.append(
            MuxRecord(
                wall=wall, action="hold", pool=pool, model=m.name,
                model_uri=m.uri, reason=HOLD_POOL_FULL,
                score=m.score, parked=m.parked,
            )
        )
    return MuxPlan(pool=pool, moves=tuple(moves), holds=tuple(holds))


def http_attach(
    replica: MuxReplica,
    model_uri: str,
    replace: bool,
    wake_start_wall: float,
    timeout_s: float = 300.0,
) -> dict:
    """Default transport: the existing warm-pool admin endpoint."""
    body = json.dumps(
        {
            "model_uri": model_uri,
            "replace": replace,
            "wake_start_wall": wake_start_wall,
        }
    ).encode()
    req = urllib.request.Request(
        f"{replica.url}/admin/attach",
        data=body,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def http_ready(replica: MuxReplica, timeout_s: float = 5.0) -> dict:
    """Attached-model report: GET /readyz (any lifecycle state)."""
    try:
        with urllib.request.urlopen(
            f"{replica.url}/readyz", timeout=timeout_s
        ) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:  # 503 carries the body too
        try:
            return json.loads(e.read().decode())
        except Exception:
            return {}
    except Exception:
        return {}


class Multiplexer:
    """Pool-level coordinator: observe, plan, execute, buffer records.

    One instance per shared pool, shared by every member CR's
    reconciler (each pumps it; a min-interval gate keeps N members from
    N-folding the convergence rate).  All I/O seams are injected:
    ``attach`` executes a move (default: HTTP against the replica's
    admin endpoint), ``ready`` refreshes a replica's attached-model
    report, ``parked`` returns the router's per-model parked breakdown
    (``RouterAdmin.parked()["models"]``).
    """

    def __init__(
        self,
        pool: str,
        replicas: Sequence[MuxReplica] = (),
        attach: Callable[..., dict] | None = None,
        ready: Callable[[MuxReplica], dict] | None = None,
        parked: Callable[[], Mapping[str, int]] | None = None,
        min_interval_s: float = 0.0,
        wall: Callable[[], float] = time.time,
        on_move: Callable[[str, str], None] | None = None,  # (model, action)
    ):
        self.pool = pool
        self.replicas: list[MuxReplica] = list(replicas)
        self._attach = attach or http_attach
        self._ready = ready or http_ready
        self._parked = parked
        self._min_interval_s = float(min_interval_s)
        self._wall = wall
        self._on_move = on_move
        self._lock = threading.Lock()
        self._members: dict[str, MuxModel] = {}
        self._pending: dict[str, list[MuxRecord]] = {}
        self._last_pass = 0.0
        self.moves_total = 0
        # Straggler verdicts from the anomaly observatory (reconciler
        # _anomaly_step): replica names to treat as last-choice attach
        # targets.  Empty (the default) = byte-identical planning.
        self._stragglers: frozenset = frozenset()

    # -- membership / observation -------------------------------------------

    def register(
        self, name: str, uri: str, weight: float = 1.0
    ) -> None:
        """(Re-)register a member CR; idempotent, called every pump."""
        with self._lock:
            cur = self._members.get(name)
            if cur is not None and cur.uri == uri and cur.weight == weight:
                return
            parked = cur.parked if cur is not None else 0
            depth = cur.queue_depth if cur is not None else 0.0
            self._members[name] = MuxModel(
                name=name, uri=uri, weight=float(weight),
                parked=parked, queue_depth=depth,
            )

    def deregister(self, name: str) -> None:
        with self._lock:
            self._members.pop(name, None)
            self._pending.pop(name, None)

    def set_stragglers(self, names) -> None:
        """Replace the straggler set the next plan will avoid."""
        with self._lock:
            self._stragglers = frozenset(names)

    def observe(
        self,
        parked: Mapping[str, int] | None = None,
        queue_depth: Mapping[str, float] | None = None,
    ) -> None:
        """Fold fresh traffic signals into the member table."""
        with self._lock:
            for name, m in list(self._members.items()):
                new_parked = (
                    int(parked.get(name, 0)) if parked is not None
                    else m.parked
                )
                new_depth = (
                    float(queue_depth.get(name, 0.0))
                    if queue_depth is not None
                    else m.queue_depth
                )
                if new_parked != m.parked or new_depth != m.queue_depth:
                    self._members[name] = MuxModel(
                        name=m.name, uri=m.uri, weight=m.weight,
                        parked=new_parked, queue_depth=new_depth,
                    )

    def refresh_replicas(self) -> None:
        """Re-read every replica's /readyz attached-model report — the
        device is the source of truth, not the packer's memory (a
        replica restarted by the kubelet comes back empty)."""
        fresh = []
        for r in self.replicas:
            body = self._ready(r)
            fresh.append(
                MuxReplica(
                    name=r.name, url=r.url,
                    attached_uri=body.get("model") or None,
                )
            )
        with self._lock:
            self.replicas = fresh

    # -- convergence ----------------------------------------------------------

    def pump(self, force: bool = False) -> list[MuxRecord]:
        """One observe→plan→execute pass (rate-limited); returns the
        records it produced (they are ALSO buffered per model for
        :meth:`take_records`)."""
        now = self._wall()
        with self._lock:
            if not force and now - self._last_pass < self._min_interval_s:
                return []
            self._last_pass = now
            members = list(self._members.values())
        if not members or not self.replicas:
            return []
        if self._parked is not None:
            try:
                self.observe(parked=self._parked())
            except Exception:
                pass  # blind = plan on last observation, same as scaler
            with self._lock:
                members = list(self._members.values())
        self.refresh_replicas()
        with self._lock:
            stragglers = self._stragglers
        p = plan(self.pool, members, self.replicas, now, stragglers)
        records = list(p.holds)
        for mv in p.moves:
            records.append(self._execute(mv, now))
        with self._lock:
            for rec in records:
                self._pending.setdefault(rec.model, []).append(rec)
        return records

    def _execute(self, mv: MuxMove, wall: float) -> MuxRecord:
        action = "replace" if mv.replace else "attach"
        try:
            resp = self._attach(
                mv.replica, mv.model.uri,
                replace=mv.replace, wake_start_wall=wall,
            )
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = str(json.loads(e.read().decode()).get("reason", ""))
            except Exception:
                pass
            return MuxRecord(
                wall=wall, action="error", pool=self.pool,
                model=mv.model.name, model_uri=mv.model.uri,
                replica=mv.replica.name, displaced=mv.displaced,
                reason=f"{ERR_ATTACH_FAILED}:{e.code}"
                + (f":{detail}" if detail else ""),
                score=mv.model.score, parked=mv.model.parked,
            )
        except Exception as e:
            return MuxRecord(
                wall=wall, action="error", pool=self.pool,
                model=mv.model.name, model_uri=mv.model.uri,
                replica=mv.replica.name, displaced=mv.displaced,
                reason=f"{ERR_ATTACH_FAILED}:{e}",
                score=mv.model.score, parked=mv.model.parked,
            )
        if resp.get("noop"):
            action = "noop"
        else:
            self.moves_total += 1
            if self._on_move is not None:
                self._on_move(mv.model.name, action)
        # Commit the packer's view of the replica; the next pass's
        # refresh re-reads the device anyway.
        with self._lock:
            self.replicas = [
                MuxReplica(
                    name=r.name, url=r.url, attached_uri=mv.model.uri
                )
                if r.name == mv.replica.name
                else r
                for r in self.replicas
            ]
        return MuxRecord(
            wall=wall, action=action, pool=self.pool,
            model=mv.model.name, model_uri=mv.model.uri,
            replica=mv.replica.name, displaced=mv.displaced,
            reason="traffic", score=mv.model.score,
            parked=mv.model.parked,
            snapshot_hash=resp.get("snapshot_hash"),
        )

    # -- per-CR surfaces (what _multiplex_step reads) -------------------------

    def take_records(self, model: str) -> list[MuxRecord]:
        """Drain the buffered records for one member CR (its reconciler
        journals them into that CR's status.history)."""
        with self._lock:
            return self._pending.pop(model, [])

    def model_status(self, model: str) -> dict[str, Any]:
        """This member's live pool view for ``status.multiplex``."""
        with self._lock:
            m = self._members.get(model)
            attached = [
                r.name
                for r in self.replicas
                if m is not None and r.attached_uri == m.uri
            ]
            out: dict[str, Any] = {
                "poolReplicas": len(self.replicas),
                "attachedReplicas": attached,
            }
            if m is not None:
                out["parked"] = m.parked
                out["score"] = m.score
            return out
