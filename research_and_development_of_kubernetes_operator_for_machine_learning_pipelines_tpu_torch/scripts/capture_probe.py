"""Time one K-step engine's CUDA graph capture, where a warm-pool attach
and a direct start differ.

The engine is ``chip_smoke.py`` phase 5j's: Llama-2-7B (random bf16
weights from seed 0, quantized to ``int8``), 4 slots, chunks of 256,
``decodeSteps`` 4 (34 graphs at capacity 4096).  The tree is written as a
snapshot under ``--snapshot-dir`` and restored from it.  Then, ``--rounds``
times, four engines are built and started in turns: over the tree as
quantized and over the restored tree, each on the main thread and on a new
thread; each prints one JSON line with its start's seconds and the graph
program's own capture seconds.  Last, a warm-pool server attaches the
snapshot over ``POST /admin/attach`` (its capture runs on the HTTP handler
thread).  The snapshot is deleted at the end.  Run on the card::

    python3 -m <port>.scripts.capture_probe --rounds 2

``--tiny`` runs the tiny Llama on ``--device cpu`` instead (nothing is
captured there).  The last line is the summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import shutil
import tempfile
import threading
import time
import urllib.request

import torch

from ..models import llama
from ..models import registry
from ..models.quantization import quantize_llama
from ..server import app
from ..server import loader
from ..server import snapshot
from ..server.metrics import ServerMetrics

URI = "probe/llama2-7b-int8"


def _free_memory() -> None:
    gc.collect()  # an engine's reference cycles hold device memory
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _start(predictor, conf: app.ServerConfig, where: str) -> dict:
    """Build and start one engine on ``where`` ("main" or "thread")."""
    out: dict = {}

    def run() -> None:
        m = ServerMetrics(deployment_name="probe", predictor_name="v1", namespace="probe")
        t0 = time.perf_counter()
        engine = app.make_gen_engine(predictor, conf, m)
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            engine.start(warmup=True)
            out["start_s"] = time.perf_counter() - t0
            prog = engine._program
            out["capture_s"] = prog.capture_s if prog is not None else 0.0
            out["graphs"] = len(prog.graphs) if prog is not None else 0
        finally:
            engine.shutdown()

    if where == "main":
        run()
    else:
        th = threading.Thread(target=run, name="capture-probe")
        th.start()
        th.join()
        if "start_s" not in out:
            raise RuntimeError("the engine did not start on its thread")
    _free_memory()
    return out


def _attach(conf: app.ServerConfig, snapshot_dir: str) -> dict:
    srv = app.build_server(None, dataclasses.replace(conf, snapshot_dir=snapshot_dir,
                                                     warm_pool=True, model_uri=URI))
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/admin/attach",
            data=json.dumps({"model_uri": URI}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=1800) as resp:
            body = json.loads(resp.read())
        wall = time.perf_counter() - t0
        if not body.get("restored"):
            raise RuntimeError(f"the attach did not restore: {body}")
        return {"attach_wall_s": wall, "restore_s": body["restore_s"],
                "start_s": body["capture_s"], "capture_s": srv.engine._program.capture_s
                if srv.engine._program is not None else 0.0}
    finally:
        srv.shutdown_all()
        serving.join(timeout=30)
        _free_memory()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--snapshot-dir", default="",
                    help="where the snapshot is written (a new temporary directory when "
                         "empty); deleted at the end")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("capture_probe: no CUDA device (pass --device cpu --tiny)")
    cfg = llama.LlamaConfig.tiny(max_seq=512) if args.tiny else llama.LlamaConfig.llama2_7b()
    dtype = torch.float32 if args.tiny else torch.bfloat16
    tree = quantize_llama(llama.init(torch.Generator(device=args.device).manual_seed(0), cfg,
                                     dtype=dtype, device=args.device))
    sdir = args.snapshot_dir or tempfile.mkdtemp(prefix="capture-probe-")
    conf = app.ServerConfig(model_name="probe", host="127.0.0.1", port=0,
                            dtype="float32" if args.tiny else "bfloat16", quantize="int8",
                            max_slots=4, prefill_chunk=256, decode_steps=4, device=args.device)
    runs = []
    try:
        ident = snapshot.snapshot_identity(URI, "int8", loader.SNAPSHOT_MESH)
        path = snapshot.write_snapshot(sdir, tree, identity=ident, flavor="llama-generate",
                                       config=dataclasses.asdict(cfg))
        restored, _ = snapshot.load_snapshot(path, identity=ident, device=args.device)
        trees = {"quantized": tree, "restored": restored}
        for r in range(args.rounds):
            order = [("quantized", "main"), ("restored", "main"), ("restored", "thread"),
                     ("quantized", "thread")]
            for name, where in (order if r % 2 == 0 else order[::-1]):
                pred = registry._build_llama(trees[name], cfg, dtype=dtype)
                res = {"round": r, "tree": name, "where": where, **_start(pred, conf, where)}
                runs.append(res)
                print(json.dumps(res), flush=True)
        trees = restored = pred = None
        _free_memory()
        res = {"where": "attach", **_attach(conf, sdir)}
        runs.append(res)
        print(json.dumps(res), flush=True)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    device = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"

    def capture(where):
        return sorted(x["capture_s"] for x in runs if x["where"] == where)

    summary = {"device": device, "main_capture_s": capture("main"),
               "thread_capture_s": capture("thread"), "attach": runs[-1], "runs": runs}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
