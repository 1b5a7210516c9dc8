"""Repeat ``POST /debug/profile`` under traffic on one served replica.

The replica is ``chip_smoke.py`` phase 5h's: Llama-2-7B (random bf16
weights from seed 0), ``quantize: none``, 4 slots, ``decodeSteps`` 4
(its bursts replayed from CUDA graphs), the flight recorder, the
timeseries ring, device telemetry and a 2 s watchdog on.  Two client
threads keep requests of 17, 130 and 300 prompt tokens (16 new) in flight
while the route captures ``--duration-s`` of the card's activity, ``--profiles``
times in a row.  Each capture prints one JSON line: its status, the
route's wall, the trace's bytes, the watchdog stalls during it and any
failed request.  A capture that has not answered after ``--hang-s``
seconds dumps every thread's stack to stderr and exits with code 1
(``faulthandler``): the starting or stopping profiler deadlocked against
a graph replay on the scheduler thread this way before the route started
and stopped it between two ticks.  Run on the card::

    python3 -m <port>.scripts.profile_stress --profiles 10

``--tiny`` serves the tiny Llama on ``--device cpu`` instead (the
profiler then records the host's ops).  The last line is the summary.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from ..models import llama
from ..models import registry
from ..server import app

PROMPT_LENS = (17, 130, 300)


def _post(url: str, body: dict, timeout: float) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profiles", type=int, default=10)
    ap.add_argument("--duration-s", type=float, default=2.0)
    ap.add_argument("--hang-s", type=float, default=120.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_stress: no CUDA device (pass --device cpu --tiny)")
    t_start = time.perf_counter()
    cfg = llama.LlamaConfig.tiny(max_seq=512) if args.tiny else llama.LlamaConfig.llama2_7b()
    dtype = torch.float32 if args.tiny else torch.bfloat16
    params = llama.init(torch.Generator(device=args.device).manual_seed(0), cfg,
                        dtype=dtype, device=args.device)
    predictor = registry._build_llama(params, cfg, dtype=dtype)
    config = app.ServerConfig(model_name="llm", host="127.0.0.1", port=0,
                              dtype="float32" if args.tiny else "bfloat16", quantize="none",
                              max_slots=4, device=args.device, decode_steps=4,
                              trace_ring=4096, timeseries_ring=600, device_telemetry=True,
                              watchdog_deadline_s=2.0, watchdog_grace_s=3600.0)
    srv = app.build_server(predictor, config)
    wd = srv.engine._watchdog
    wd.on_exit = lambda: None  # a stall is reported here, never an exit
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    url = base + "/v2/models/llm/generate"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    _post(url, {"prompt_ids": prompts[0], "max_new_tokens": 2}, args.hang_s)  # warm-up
    rows = []
    try:
        for i in range(args.profiles):
            faulthandler.dump_traceback_later(args.hang_s, exit=True, file=sys.__stderr__)
            stop, errors = threading.Event(), []

            def traffic():
                j = 0
                while not stop.is_set():
                    try:
                        _post(url, {"prompt_ids": prompts[j % len(prompts)],
                                    "max_new_tokens": 16}, args.hang_s)
                    except Exception as e:  # reported in the capture's line
                        errors.append(repr(e))
                        return
                    j += 1

            clients = [threading.Thread(target=traffic, daemon=True) for _ in range(2)]
            for c in clients:
                c.start()
            time.sleep(0.5)
            stalls0 = wd.stalls_total
            t0 = time.perf_counter()
            status, out = _post(base + "/debug/profile", {"duration_s": args.duration_s},
                                args.hang_s)
            wall = time.perf_counter() - t0
            stop.set()
            for c in clients:
                c.join(timeout=args.hang_s)
            faulthandler.cancel_dump_traceback_later()
            trace = Path(out["trace_dir"]) / "trace.json"
            row = {"profile": i, "status": status, "wall_s": wall,
                   "trace_bytes": trace.stat().st_size,
                   "stalls": wd.stalls_total - stalls0, "request_errors": errors}
            trace.unlink()  # tens of MB each on the card
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        faulthandler.cancel_dump_traceback_later()
        srv.shutdown_all()
        serving.join(timeout=30)
    walls = [r["wall_s"] for r in rows]
    summary = {"profiles": len(rows), "answered_200": sum(r["status"] == 200 for r in rows),
               "request_errors": sum(len(r["request_errors"]) for r in rows),
               "wall_s_min": min(walls), "wall_s_max": max(walls),
               "stalls": sum(r["stalls"] for r in rows),
               "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
               "seconds": time.perf_counter() - t_start}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    faulthandler.enable()
    summary = main()
    sys.exit(0 if summary["answered_200"] == summary["profiles"]
             and not summary["request_errors"] else 1)
