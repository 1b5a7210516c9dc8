"""``python -m <package>.server.launch`` — the entry point of a pod whose
unit has more than one card: it starts one server rank a card
(``python -m <package>.server`` with the same arguments) and watches them.

It is the pod's first process, so it imports the standard library only and
is up at once; torch loads in the ranks.  Every argument passes to the
ranks unchanged but one, which may stand anywhere among them:
``--ranks-share-card`` says the ranks of this host may outnumber its cards
and share them.  The operator never emits it; it exists for a machine with
one card that rehearses a unit of several.  Each line a rank writes comes
out on the launcher's output prefixed ``[rank r]``.

Two sets of variables, which never share a name:

- **Pod-level** (set on the pod by the operator's manifest, read here):
  ``TPUMLOPS_UNIT_HOSTS`` (the unit's pods, 1 when unset),
  ``TPUMLOPS_UNIT_HOST_INDEX`` (this pod's index, from the StatefulSet's
  ``apps.kubernetes.io/pod-index`` label; 0 when unset) and
  ``TPUMLOPS_UNIT_COORDINATOR`` (``host:port`` of the unit's rank 0: pod
  0's name through the headless Service; ``127.0.0.1:<a free port>`` when
  unset, which only a unit of one host may be).
- **Rank-level** (set here, one set a rank; read by
  ``parallel/distributed.py`` and ``server/app.py``): ``JAX_PROCESS_ID`` =
  host index x ranks a host + local rank, ``JAX_NUM_PROCESSES`` = the world,
  ``JAX_COORDINATOR_ADDRESS``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` (ranks
  a host) and, with ``--ranks-share-card``, ``TPUMLOPS_RANKS_SHARE_CARD``.

The world is the product of ``--mesh-shape`` (the server's default when
absent); ranks a host is the world over the hosts.  ``CUDA_VISIBLE_DEVICES``
is left whole: every rank sees every card of the pod and takes
``cuda:(LOCAL_RANK % device_count)``, and the backend is nccl where the
host's ranks fit its cards.  A rank that finds fewer cards than ranks on its
host fails at start (``server/app.py``'s ``form_unit``).

Signals and exit: SIGTERM (or SIGINT) to the launcher of host 0 goes to the
leader (rank 0), which drains and releases its followers; on another host
the launcher waits for its ranks, which the leader releases.  The launcher
exits with the leader's code once every rank of its host has exited.  A
rank that exits non-zero, or dies from a signal, ends the pod: the other
ranks get SIGTERM, then SIGKILL after :data:`KILL_GRACE_S`, and the
launcher exits non-zero, since part of a unit can never serve.  A rank is also
killed if the launcher itself dies.  There is no restart loop: the pod's
restart policy restarts the unit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time

# Pod-level variables (the manifest's).
HOSTS_ENV = "TPUMLOPS_UNIT_HOSTS"
HOST_INDEX_ENV = "TPUMLOPS_UNIT_HOST_INDEX"
COORDINATOR_ENV = "TPUMLOPS_UNIT_COORDINATOR"
# Rank-level: the ranks of a host may share its cards (--ranks-share-card).
SHARE_CARD_ENV = "TPUMLOPS_RANKS_SHARE_CARD"

SERVER_MODULE = __package__  # also when run as `python -m`, where __name__ is __main__
DEFAULT_MESH = '{"dp": 1, "tp": 1}'  # the server's --mesh-shape default
# After a rank failed, the seconds the others get between SIGTERM and
# SIGKILL (a leader's drain with part of its unit gone may not end).
KILL_GRACE_S = 10.0
POLL_S = 0.05


def _log(msg: str) -> None:
    sys.stderr.write(f"launch: {msg}\n")
    sys.stderr.flush()


def mesh_world(server_argv: list[str]) -> int:
    """The ranks ``--mesh-shape`` spans (its last value, as argparse reads
    it; the server's default when absent)."""
    text = DEFAULT_MESH
    for i, a in enumerate(server_argv):
        if a == "--mesh-shape" and i + 1 < len(server_argv):
            text = server_argv[i + 1]
        elif a.startswith("--mesh-shape="):
            text = a.split("=", 1)[1]
    mesh = json.loads(text)
    if not isinstance(mesh, dict):
        raise ValueError(f"--mesh-shape must be a JSON object, got {text!r}")
    return math.prod(int(v) for v in mesh.values())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_plan(world: int, env=None) -> list[dict[str, str]]:
    """The rank-level variables of each rank this host starts, from the
    pod-level ones in ``env`` (``os.environ`` by default)."""
    env = os.environ if env is None else env
    hosts = int(env.get(HOSTS_ENV) or 1)
    host = int(env.get(HOST_INDEX_ENV) or 0)
    if hosts < 1 or not 0 <= host < hosts:
        raise ValueError(f"host index {host} of {hosts} hosts ({HOST_INDEX_ENV}, {HOSTS_ENV})")
    if world % hosts:
        raise ValueError(f"a mesh of {world} ranks does not split over {hosts} hosts")
    coordinator = env.get(COORDINATOR_ENV)
    if not coordinator:
        if hosts > 1:
            raise ValueError(f"a unit of {hosts} hosts needs {COORDINATOR_ENV} (host:port of "
                             "rank 0)")
        coordinator = f"127.0.0.1:{free_port()}"
    per_host = world // hosts
    return [{"JAX_COORDINATOR_ADDRESS": coordinator, "JAX_NUM_PROCESSES": str(world),
             "JAX_PROCESS_ID": str(host * per_host + local), "LOCAL_RANK": str(local),
             "LOCAL_WORLD_SIZE": str(per_host)}
            for local in range(per_host)]


def _die_with_parent():
    """A ``preexec_fn`` that has the rank SIGKILLed when the launcher dies
    (``PR_SET_PDEATHSIG``, Linux); None elsewhere."""
    try:
        prctl = ctypes.CDLL(None).prctl
    except (OSError, AttributeError):
        return None
    return lambda: prctl(1, signal.SIGKILL)


def _pump(stream, prefix: bytes, lock: threading.Lock) -> None:
    out = sys.stdout.buffer
    for line in iter(stream.readline, b""):
        with lock:
            out.write(prefix + line)
            out.flush()
    stream.close()


class Unit:
    """This host's rank processes: ``python -m <module> <server_argv>`` a
    rank (the server unless another module is named)."""

    def __init__(self, server_argv: list[str], plans: list[dict[str, str]],
                 share_card: bool = False, module: str = SERVER_MODULE):
        self.procs: list[subprocess.Popen] = []
        self.ranks = [int(p["JAX_PROCESS_ID"]) for p in plans]
        preexec = _die_with_parent()
        for plan in plans:
            env = dict(os.environ, **plan)
            if share_card:
                env[SHARE_CARD_ENV] = "1"
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *server_argv], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, preexec_fn=preexec))
        # Started after every fork: a fork must not copy a pumping thread.
        lock = threading.Lock()
        self._pumps = [threading.Thread(target=_pump, args=(p.stdout, f"[rank {r}] ".encode(),
                                                            lock), daemon=True)
                       for p, r in zip(self.procs, self.ranks)]
        for t in self._pumps:
            t.start()

    def codes(self) -> list[int | None]:
        return [p.poll() for p in self.procs]

    def kill(self, grace: float) -> None:
        """SIGTERM to every live rank, SIGKILL to any left after ``grace``."""
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + grace
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def close(self) -> None:
        for t in self._pumps:
            t.join(timeout=5)


def _exit_code(code: int) -> int:
    return code if code > 0 else 128 - code


def run(unit: Unit, host: int, stop: threading.Event) -> int:
    """Watch the ranks until they have all exited; the launcher's code."""
    forwarded = False
    while True:
        if stop.is_set() and not forwarded:
            forwarded = True
            if host == 0:
                _log("termination signal; SIGTERM to the leader (rank 0)")
                if unit.procs[0].poll() is None:
                    unit.procs[0].send_signal(signal.SIGTERM)
            else:
                _log(f"termination signal on host {host}; waiting for the leader's release")
        codes = unit.codes()
        failed = [(r, c) for r, c in zip(unit.ranks, codes) if c not in (None, 0)]
        if failed:
            rank, code = failed[0]
            how = f"signal {-code}" if code < 0 else f"code {code}"
            _log(f"rank {rank} exited with {how}; stopping ranks "
                 f"{[r for r, c in zip(unit.ranks, codes) if c is None]} "
                 f"(SIGKILL after {KILL_GRACE_S:g} s)")
            unit.kill(KILL_GRACE_S)
            return _exit_code(code)
        if all(c == 0 for c in codes):
            _log(f"every rank exited 0 ({unit.ranks})")
            return 0
        time.sleep(POLL_S)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m {SERVER_MODULE}.launch", allow_abbrev=False,
        description="start one server rank a card of this host; every other argument is the "
                    "server's")
    ap.add_argument("--ranks-share-card", action="store_true",
                    help="let this host's ranks outnumber its cards (a one-card rehearsal; "
                         "never in a manifest)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args, server_argv = build_arg_parser().parse_known_args(argv)
    world = mesh_world(server_argv)
    plans = rank_plan(world)
    host = int(os.environ.get(HOST_INDEX_ENV) or 0)
    stop = threading.Event()

    def _term(signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    _log(f"host {host} of {os.environ.get(HOSTS_ENV) or 1}: ranks "
         f"{[int(p['JAX_PROCESS_ID']) for p in plans]} of {world}, coordinator "
         f"{plans[0]['JAX_COORDINATOR_ADDRESS']}"
         + (", ranks share the cards" if args.ranks_share_card else ""))
    unit = Unit(server_argv, plans, share_card=args.ranks_share_card)
    try:
        return run(unit, host, stop)
    except BaseException:
        unit.kill(KILL_GRACE_S)
        raise
    finally:
        unit.close()


if __name__ == "__main__":
    sys.exit(main())
