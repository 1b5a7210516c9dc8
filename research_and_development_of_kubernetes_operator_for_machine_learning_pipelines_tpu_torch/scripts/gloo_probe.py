"""Which collectives a gloo process group runs on CUDA tensors, with every
rank on the same card.

A machine with one card cannot give two ranks an NCCL group (NCCL refuses
two ranks on one device), so a world of several ranks there runs gloo with
every rank on ``cuda:0``.  ProcessGroupGloo has CUDA paths for some
collectives and not for others; ``parallel/collectives.py`` stages the
missing ones through a host tensor.  For each collective the port uses,
this probe starts a world of ``--world`` ranks (2 by default) as processes,
runs the collective on a CUDA tensor under a 30 s group timeout, checks the
result against numpy, times it with a host clock around a synchronised call
(``--size`` f32 elements, ``--rounds`` repeats, the median) and prints one
JSON line; a world that does not finish within ``--limit`` seconds is
killed and its collective reported as hung.  Then one process brings up a
one-rank ``nccl`` group and runs an ``all_reduce``, which shows that the
NCCL library loads.  Run on the card::

    python3 -m <port>.scripts.gloo_probe [--world 2] [--size 1048576]

``--device cpu`` runs the same probe on CPU tensors.  The last line is the
summary.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import queue
import socket
import statistics
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "send_recv")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(name: str, rank: int, world: int, n: int, dev: torch.device):
    """One collective on this rank's tensor; returns (output, expected)."""
    base = [np.arange(n, dtype=np.float32) + 1000.0 * r for r in range(world)]
    x = torch.from_numpy(base[rank].copy()).to(dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        return x, sum(base)
    if name == "broadcast":
        dist.broadcast(x, src=0)
        return x, base[0]
    if name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts), np.concatenate(base)
    if name == "all_gather_into_tensor":
        out = torch.empty(world * n, dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out, np.concatenate(base)
    if name == "reduce_scatter_tensor":
        full = torch.arange(world * n, dtype=torch.float32, device=dev) + rank
        out = torch.empty(n, dtype=x.dtype, device=dev)
        dist.reduce_scatter_tensor(out, full)
        total = sum(np.arange(world * n, dtype=np.float32) + r for r in range(world))
        return out, total[rank * n:(rank + 1) * n]
    if name == "all_to_all_single":
        full = torch.arange(world * n, dtype=torch.float32, device=dev) + 1e6 * rank
        out = torch.empty_like(full)
        dist.all_to_all_single(out, full)
        exp = np.concatenate([np.arange(rank * n, (rank + 1) * n, dtype=np.float32) + 1e6 * r
                              for r in range(world)])
        return out, exp
    if name == "send_recv":
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, nxt), dist.P2POp(dist.irecv, out, prv)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out, base[prv]
    raise KeyError(name)


def _rank_main(name: str, rank: int, world: int, port: int, n: int, rounds: int,
               device: str, q) -> None:
    torch.set_num_threads(1)
    dev = torch.device("cuda:0") if device == "cuda" else torch.device("cpu")
    if device == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    row = {"collective": name, "backend": "gloo", "tensor": device, "world": world,
           "elements": n}
    try:
        out, exp = _run(name, rank, world, n, dev)
        row["ok"] = bool(np.array_equal(out.cpu().numpy(), exp))
        walls = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            _run(name, rank, world, n, dev)
            if device == "cuda":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        row["host_ms_median"] = 1e3 * statistics.median(walls)
    except Exception as exc:  # the probe's point: record what gloo refuses
        row["ok"] = False
        row["error"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
    q.put((rank, row))


def _nccl_one_rank(port: int, q) -> None:
    row = {"collective": "all_reduce", "backend": "nccl", "world": 1}
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
        x = torch.ones(1024, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        row["ok"] = bool((x == 1).all().item())
        row["nccl_version"] = ".".join(str(v) for v in torch.cuda.nccl.version())
        dist.destroy_process_group()
    except Exception:
        row["ok"] = False
        row["error"] = traceback.format_exc().splitlines()[-1][:200]
    q.put((0, row))


def _world(ctx, q, target, args_of, world: int, limit: float) -> tuple[dict, list]:
    """Start ``world`` processes, collect each one's row, kill what is left
    at the limit; returns ({rank: row}, [exit codes])."""
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + limit
    while len(got) < world:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            rank, row = q.get(timeout=left)
        except queue.Empty:
            break
        got[rank] = row
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
    return got, [p.exitcode for p in procs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--size", type=int, default=1 << 20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--limit", type=float, default=60.0,
                    help="seconds one collective's world may take before it is killed")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to probe CPU tensors")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rows = []
    for name in COLLECTIVES:
        port = free_port()
        got, codes = _world(
            ctx, q, _rank_main,
            lambda r: (name, r, args.world, port, args.size, args.rounds, args.device, q),
            args.world, args.limit)
        row = dict(got.get(0) or {"collective": name, "backend": "gloo",
                                  "tensor": args.device, "world": args.world})
        if len(got) < args.world:
            row.update(ok=False, error=f"hung: {len(got)} of {args.world} ranks answered "
                                       f"within {args.limit} s")
        else:
            row["ok"] = all(r["ok"] for r in got.values())
        row["exit_codes"] = codes
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.device == "cuda":
        got, codes = _world(ctx, q, _nccl_one_rank, lambda r: (free_port(), q), 1, args.limit)
        row = dict(got.get(0) or {"collective": "all_reduce", "backend": "nccl", "world": 1,
                                  "ok": False, "error": "hung"})
        row["exit_codes"] = codes
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"ok_on_" + args.device: [r["collective"] for r in rows
                                        if r["ok"] and r["backend"] == "gloo"],
               "refused": [r["collective"] for r in rows if not r["ok"]],
               "nccl_one_rank": next((r["ok"] for r in rows if r["backend"] == "nccl"), None)}
    if args.device == "cuda":
        summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
