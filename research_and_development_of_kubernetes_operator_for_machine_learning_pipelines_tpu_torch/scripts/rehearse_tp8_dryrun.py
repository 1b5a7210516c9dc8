"""The tp-8 deployment path as eight ranks: Llama-2-7B's layer shapes (2
layers, a vocabulary of 8192, so the host's memory stays small), each rank
loading its block of the int8 model and running one prefill.

The counterpart of the JAX repository's ``scripts/rehearse_tp8_dryrun.py``
(the v5e-8 mesh on 8 virtual CPU devices), as the port runs an ``h100-8``
unit: one process a rank, started with the launcher's rank plan
(``server/launch.py`` ``rank_plan`` and ``Unit``), each joining the group
through the server's ``form_unit`` (nccl where the host's ranks fit its
cards, gloo where they share one: the launcher's ``--ranks-share-card``).
Each rank runs ``load_predictor(mesh_shape={"tp": 8}, quantize="int8")``
and a 16-token ``prefill``.  The JAX script asserts that the ``q8`` leaf is
not replicated; here the parent checks that every int8 leaf each rank holds is
its block of the whole leaf quantized on the host (a column block of
q/k/v/gate/up and the LM head with their scales, a row block of o/down
with the whole scale), and that every rank's logits are finite and equal.  Run on the
card::

    python -m <port>.scripts.rehearse_tp8_dryrun

It runs on ``cuda``, and on the CPU (gloo ranks, the kernels' plain
versions) only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..models import llama
from ..models.quantization import _LLAMA_LAYER_MATS, is_quantized, quantize_stacked
from ..server import launch
from ..server.loader import save_native_model

# The JAX script's geometry: Llama-2-7B's widths at 2 layers.
CONFIG = dict(vocab_size=8192, hidden_size=4096, num_layers=2, num_heads=32, num_kv_heads=32,
              intermediate_size=11008, max_seq=128)
MESH = {"tp": 8}
PROMPT = 16  # prefill tokens, all ones
TIMEOUT_S = 600.0  # the unit's whole run
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The int8 leaves by flattened key.  They split on their last axis (columns,
# the scale with them); o and down on their input axis (rows) under the
# whole scale.
_ROWS = ("o", "down")
INT8_KEYS = (*(f"layers|{n}" for n in _LLAMA_LAYER_MATS), "lm_head")


def write_artifact(path, geometry: dict = CONFIG, seed: int = 0, device="cpu") -> Path:
    """A ``llama-generate`` artifact at ``geometry``: ``llama.init``'s bf16
    weights from a generator seeded with ``seed`` on ``device``."""
    cfg = llama.LlamaConfig(**geometry)
    params = llama.init(torch.Generator(device=device).manual_seed(seed), cfg,
                        dtype=torch.bfloat16, device=device)
    return save_native_model(path, "llama-generate", params, config=dict(geometry))


def _block(t: torch.Tensor, axis: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[axis] // tp
    return t.narrow(axis, rank * n, n)


def _int8_leaves(params: dict) -> dict[str, dict]:
    """The int8 leaves of a Llama tree by flattened key (``INT8_KEYS``)."""
    return {key: params["lm_head"] if key == "lm_head" else params["layers"][key.split("|")[1]]
            for key in INT8_KEYS}


def host_quantized(art: Path, dtype) -> dict[str, dict]:
    """Each int8 leaf of ``art`` (read at ``dtype``) quantized whole on the
    host, as the sharded loader quantizes (the card's ``/ 127`` of a scale
    may round one ulp apart from the host's)."""
    from ..convert import to_tensor

    with np.load(Path(art) / "params.npz", allow_pickle=False) as npz:
        return {key: quantize_stacked(to_tensor(npz[key], None, dtype)) for key in INT8_KEYS}


def check_blocks(blocks: dict[str, dict], whole: dict[str, dict], rank: int,
                 tp: int) -> list[str]:
    """Raise unless each of a rank's int8 ``blocks`` is its block of the
    ``whole`` leaf (a column block with its scales, or for o and down a row
    block under the whole scale); the blocks checked."""
    checked = []
    for key, w in whole.items():
        held = blocks[key]
        if not is_quantized(held):
            raise AssertionError(f"rank {rank}: {key} is not int8")
        rows = key.split("|")[-1] in _ROWS
        want_q8 = _block(w["q8"], -2 if rows else -1, rank, tp)
        want_scale = w["scale"] if rows else _block(w["scale"], -1, rank, tp)
        if not (torch.equal(held["q8"], want_q8) and torch.equal(held["scale"], want_scale)):
            raise AssertionError(f"rank {rank}: {key} is not its {'row' if rows else 'column'} "
                                 f"block {tuple(want_q8.shape)} of {tuple(w['q8'].shape)}")
        checked.append(f"{key} {tuple(held['q8'].shape)} of {tuple(w['q8'].shape)}")
    return checked


def rank_main(art: str, out: str, device: str, dtype_name: str) -> None:
    """One rank: join the unit, load its blocks, prefill, and write
    ``rank-<r>.json``, ``rank-<r>.npy`` (its f32 logits) and ``rank-<r>.pt``
    (its int8 blocks, on the host) to ``out``."""
    import torch.distributed as dist

    from ..ops import flash_attention, rmsnorm
    from ..parallel import build_mesh, distributed
    from ..server.app import ServerConfig, form_unit
    from ..server.loader import load_predictor

    # The host's cores shared among its ranks: the load cuts and quantizes
    # each leaf on the host.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // distributed.local_world_size(1)))
    dtype = _DTYPES[dtype_name]
    _, dev_name, _ = form_unit(ServerConfig(mesh_shape=dict(MESH), device=device))
    dev = torch.device(dev_name)
    rank, tp = dist.get_rank(), MESH["tp"]
    try:
        stats: dict = {}
        t0 = time.perf_counter()
        pred = load_predictor(art, quantize="int8", device=dev, dtype=dtype, mesh_shape=MESH,
                              load_stats=stats)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        # The load's peak, before the check below holds whole leaves.
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else None
        params, cfg = pred.causal_lm["params"], pred.causal_lm["cfg"]
        torch.save({k: {n: t.cpu() for n, t in v.items()}
                    for k, v in _int8_leaves(params).items()}, Path(out) / f"rank-{rank}.pt")
        mesh = build_mesh(MESH)
        rmsnorm.launches = flash_attention.launches = 0
        t0 = time.perf_counter()
        logits, _ = llama.prefill(params, torch.ones((1, PROMPT), dtype=torch.long, device=dev),
                                  cfg, dtype=dtype, mesh=mesh)
        logits = logits.float().cpu()
        prefill_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"rank {rank}: the prefill's logits are not finite")
        report = {"rank": rank, "device": str(dev), "backend": distributed.backend_name(),
                  "load_s": load_s, "load_stats": stats, "prefill_s": prefill_s,
                  "shape": list(logits.shape), "load_peak_bytes": peak,
                  "launches": {"rmsnorm": int(rmsnorm.launches),
                               "flash_attention": int(flash_attention.launches)}}
        np.save(Path(out) / f"rank-{rank}.npy", logits.numpy())
        (Path(out) / f"rank-{rank}.json").write_text(json.dumps(report))
        print(f"rank {rank} on {dev}: sharded int8 load {load_s:.1f}s, prefill "
              f"{prefill_s:.1f}s", flush=True)
    finally:
        distributed.shutdown_distributed()


def dryrun(art, device=None, dtype=torch.bfloat16, timeout: float = TIMEOUT_S) -> dict:
    """The eight ranks on ``art`` (``cuda`` unless ``device`` names the CPU):
    ``{"ranks": [each rank's report with the ``blocks`` checked], "logits":
    rank 0's f32 logits, "whole": the int8 leaves quantized whole on the
    host, "share_card", "wall_s"}``.  Raises if a rank fails, the unit
    outlasts ``timeout`` seconds, a rank's int8 leaf is not its block of the
    whole leaf, or the ranks' logits differ."""
    device = str(device or "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    world = MESH["tp"]
    share = device == "cuda" and torch.cuda.device_count() < world
    root = str(Path(__file__).resolve().parents[2])
    plans = [{**p, "PYTHONPATH": os.pathsep.join(filter(None, [root,
                                                                os.environ.get("PYTHONPATH")]))}
             for p in launch.rank_plan(world, env={})]
    dtype_name = next(k for k, v in _DTYPES.items() if v == dtype)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        t0 = time.perf_counter()
        unit = launch.Unit(["--rank-of", str(art), "--out", str(out), "--device", device,
                            "--dtype", dtype_name], plans, share_card=share,
                           module=f"{__package__}.rehearse_tp8_dryrun")
        try:
            deadline = time.monotonic() + timeout
            while True:
                codes = unit.codes()
                failed = [(r, c) for r, c in zip(unit.ranks, codes) if c not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    unit.kill(launch.KILL_GRACE_S)
                    raise RuntimeError(f"tp-8 dry run: rank {failed[0][0]} exited {failed[0][1]}"
                                       if failed else f"tp-8 dry run: over {timeout:.0f} s")
                if all(c == 0 for c in codes):
                    break
                time.sleep(launch.POLL_S)
        finally:
            unit.close()
        wall = time.perf_counter() - t0
        ranks = [json.loads((out / f"rank-{r}.json").read_text()) for r in range(world)]
        logits = [np.load(out / f"rank-{r}.npy") for r in range(world)]
        whole = host_quantized(Path(art), dtype)
        for r, report in enumerate(ranks):
            report["blocks"] = check_blocks(torch.load(out / f"rank-{r}.pt", weights_only=True),
                                            whole, r, world)
    for r in range(1, world):
        if not np.array_equal(logits[r], logits[0]):
            raise AssertionError(f"tp-8 dry run: rank {r}'s logits differ from rank 0's (max "
                                 f"{float(np.abs(logits[r] - logits[0]).max()):.3e})")
    return {"ranks": ranks, "logits": torch.from_numpy(logits[0]), "whole": whole,
            "share_card": share, "wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    # A rank of the unit (set by dryrun for the processes it starts).
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of:
        rank_main(args.rank_of, args.out, args.device, args.dtype)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        art = write_artifact(Path(tmp) / "llm7b2l")
        res = dryrun(art, args.device)
    r0 = res["ranks"][0]
    print(f"sharded int8 load: {max(r['load_s'] for r in res['ranks']):.1f}s")
    print(f"q8 sharding: {r0['blocks'][0]} on each of {len(res['ranks'])} ranks "
          f"({r0['backend']}{', sharing one card' if res['share_card'] else ''})")
    print(f"sharded prefill (incl. kernel builds): "
          f"{max(r['prefill_s'] for r in res['ranks']):.1f}s")
    print("TP8 DRYRUN OK", tuple(r0["shape"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
