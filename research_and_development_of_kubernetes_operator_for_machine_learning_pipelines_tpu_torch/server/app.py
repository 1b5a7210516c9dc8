"""HTTP server for ``/generate`` (port of the JAX package's ``server/app.py``,
text-generation routes only).

Standard library only (``http.server.ThreadingHTTPServer``): the GPU
machine's Python has no aiohttp.  Each request runs on its own handler
thread, which submits to the engine and waits on the engine's futures;
all tensor work stays on the engine's scheduler thread.

Routes:

- ``POST /v2/models/{name}/generate`` — the simple form ``{"prompt_ids":
  [[...]] or [...], "max_new_tokens": N, ...}`` or the V2 tensor form
  ``{"inputs": [{"name": "prompt_ids", ...}, {"name": "lengths", ...}?],
  "parameters": {...}}``; parameters ``max_new_tokens``, ``eos_id``,
  ``temperature``, ``top_k``, ``top_p`` and ``seed`` (row i samples with
  ``seed + i``).  Unknown keys are a 400; ``stream: true`` is a 400 (not
  yet ported).
- ``GET /v2/health/live`` and ``GET /v2/health/ready``.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import signal
import threading
from concurrent.futures import wait
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .generation import EngineShutdown, GenerationEngine

_log = logging.getLogger("tpumlops_torch.server")

_GEN_PARAM_KEYS = frozenset(
    {"max_new_tokens", "eos_id", "temperature", "top_k", "top_p", "seed", "stream"}
)
# Parameters of the reference's /generate that this port does not serve yet.
_GEN_NOT_PORTED = frozenset({"debug", "slo_class"})

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}

_GENERATE_PATH = re.compile(r"^/v2/models/([^/]+)/generate$")


def _check_gen_params(params: dict, allowed: frozenset) -> None:
    for key in sorted(_GEN_NOT_PORTED & set(params)):
        if params[key]:
            raise ValueError(f"generate parameter {key!r} is not yet ported")
    unknown = sorted(set(params) - allowed - _GEN_NOT_PORTED)
    if unknown:
        raise ValueError(
            f"unknown key(s) {unknown} in generate parameters; "
            f"allowed: {sorted(allowed)}"
        )


@dataclass
class ServerConfig:
    model_name: str = "model"
    host: str = "0.0.0.0"
    port: int = 9000
    dtype: str = "bfloat16"
    quantize: str = "none"
    max_slots: int = 4
    prefill_chunk: int | None = None
    device: str | None = None


def make_gen_engine(predictor, config: ServerConfig) -> GenerationEngine:
    """Construct the GenerationEngine for a causal-LM predictor."""
    return GenerationEngine(
        predictor.causal_lm["params"],
        predictor.causal_lm["cfg"],
        max_slots=config.max_slots,
        dtype=_DTYPES[config.dtype],
        eos_id=predictor.causal_lm.get("eos_id"),
        kv_quant=config.quantize == "int8kv",
        prefill_chunk=config.prefill_chunk,
        device=config.device,
    )


def parse_generate(body: dict) -> tuple[list, dict]:
    """Request body -> (prompts, parameters), in either request form."""
    if "inputs" in body:
        tensors = {
            t["name"]: np.asarray(t["data"], np.int64).reshape(t["shape"])
            for t in body["inputs"]
        }
        if "prompt_ids" not in tensors:
            raise ValueError('missing input tensor "prompt_ids"')
        rows = tensors["prompt_ids"]
        if "lengths" in tensors:
            # Explicit per-row lengths disambiguate right-padding from
            # legitimate trailing 0 tokens.
            lens = tensors["lengths"].reshape(-1)
            if lens.size != rows.shape[0]:
                raise ValueError(
                    f'"lengths" has {lens.size} entries for {rows.shape[0]} prompt rows'
                )
            prompts = [row[: int(n)] for row, n in zip(rows, lens)]
        else:
            prompts = [np.trim_zeros(row, "b") for row in rows]
        params = body.get("parameters", {})
        _check_gen_params(params, _GEN_PARAM_KEYS)
    else:
        raw = body["prompt_ids"]
        prompts = [raw] if raw and np.isscalar(raw[0]) else list(raw)
        params = body
        _check_gen_params(params, _GEN_PARAM_KEYS | {"prompt_ids", "id"})
    if not prompts:
        raise ValueError("prompt_ids is empty")
    return prompts, params


class GenerateServer(ThreadingHTTPServer):
    """The HTTP server plus the engine it fronts."""

    daemon_threads = True

    def __init__(self, address, engine: GenerationEngine, model_name: str):
        self.engine = engine
        self.model_name = model_name
        self.lifecycle = "loading"
        super().__init__(address, _Handler)

    def generate(self, body: dict) -> dict:
        prompts, params = parse_generate(body)
        if params.get("stream"):
            raise ValueError("stream=true is not yet ported")
        max_new = int(params.get("max_new_tokens", 16))
        eos_id = params.get("eos_id")
        eos_id = int(eos_id) if eos_id is not None else None
        seed = params.get("seed")
        sampling = {
            "temperature": float(params.get("temperature", 0.0)),
            "top_k": int(params.get("top_k", 0)),
            "top_p": float(params.get("top_p", 1.0)),
            "seed": int(seed) if seed is not None else None,
        }
        # Validate every prompt before admitting any: a bad sibling must
        # not leave earlier ones generating into abandoned futures.
        prompts = [self.engine.validate(p, max_new, **sampling) for p in prompts]

        def row_seed(i: int) -> int | None:
            # Distinct stream per row, reproducible from the request seed.
            base = sampling["seed"]
            return None if base is None else (base + i) % (2**63)

        futures = [
            self.engine.submit(p, max_new, eos_id, **{**sampling, "seed": row_seed(i)})
            for i, p in enumerate(prompts)
        ]
        wait(futures)
        outs = [f.result() for f in futures]
        return {
            "model_name": self.model_name,
            "id": body.get("id", ""),
            "outputs": [
                {
                    "name": f"output_ids_{i}",
                    "datatype": "INT32",
                    "shape": [int(o.size)],
                    "data": o.tolist(),
                }
                for i, o in enumerate(outs)
            ],
        }

    def shutdown_all(self) -> None:
        """Stop serving, then stop the engine (failing what is queued)."""
        self.lifecycle = "shutdown"
        self.shutdown()
        self.server_close()
        self.engine.shutdown()


class _Handler(BaseHTTPRequestHandler):
    server: GenerateServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access lines to logging
        _log.debug("%s - " + fmt, self.address_string(), *args)

    def _reply(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        srv = self.server
        if self.path == "/v2/health/live":
            live = srv.lifecycle != "shutdown"
            self._reply(200 if live else 503, {"live": live, "lifecycle": srv.lifecycle})
        elif self.path == "/v2/health/ready":
            ready = srv.lifecycle == "ready"
            self._reply(200 if ready else 503, {"ready": ready, "lifecycle": srv.lifecycle})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv = self.server
        m = _GENERATE_PATH.match(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if m is None:
            self._reply(404, {"error": f"no route {self.path}"})
            return
        if m.group(1) != srv.model_name:
            self._reply(404, {"error": f"unknown model {m.group(1)!r}"})
            return
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            payload = srv.generate(body)
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except EngineShutdown as e:
            self._reply(503, {"error": str(e)})
            return
        except Exception as e:
            _log.exception("generation failed")
            self._reply(500, {"error": str(e)})
            return
        self._reply(200, payload)


def build_server(predictor, config: ServerConfig, warmup: bool = True) -> GenerateServer:
    """Engine + bound HTTP server for a loaded predictor; the engine is
    started and the server reads ready.  Call ``serve_forever()`` (on any
    thread) and ``shutdown_all()`` to stop."""
    engine = make_gen_engine(predictor, config)
    engine.start(warmup=warmup)
    try:
        srv = GenerateServer((config.host, config.port), engine, config.model_name)
    except Exception:
        engine.shutdown()
        raise
    srv.lifecycle = "ready"
    return srv


def main(argv: list[str] | None = None) -> None:
    from .loader import load_predictor

    ap = argparse.ArgumentParser(description="Serve a Llama artifact over /generate.")
    ap.add_argument("--model-uri", required=True)
    ap.add_argument("--model-name", default="model")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--quantize", default="none", choices=["none", "int8", "int8kv"])
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; the CPU only when named)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    config = ServerConfig(
        model_name=args.model_name, host=args.host, port=args.port,
        dtype=args.dtype, quantize=args.quantize, max_slots=args.max_slots,
        prefill_chunk=args.prefill_chunk, device=args.device,
    )
    predictor = load_predictor(
        args.model_uri, quantize=args.quantize, device=args.device,
        dtype=_DTYPES[args.dtype],
    )
    srv = build_server(predictor, config)

    def _term(_signum, _frame):
        threading.Thread(target=srv.shutdown_all, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    host, port = srv.server_address[:2]
    _log.info("serving %s on %s:%d", config.model_name, host, port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown_all()
