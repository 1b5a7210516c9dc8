"""HTTP server for ``/generate`` and the V2 predict path (port of the JAX
package's ``server/app.py``).

Standard library only (``http.server.ThreadingHTTPServer``): the GPU
machine's Python has no aiohttp.  Each request runs on its own handler
thread and waits on futures; tensor work stays on the engine's threads
(the generation engine's scheduler, or the dynamic batcher's collector).
``build_server`` picks the engine by the predictor's flavor.

Routes:

- ``POST /v2/models/{name}/generate`` (causal LMs) -- the simple form
  ``{"prompt_ids": [[...]] or [...], "max_new_tokens": N, ...}`` or the V2
  tensor form ``{"inputs": [{"name": "prompt_ids", ...}, {"name":
  "lengths", ...}?], "parameters": {...}}``; parameters ``max_new_tokens``,
  ``eos_id``, ``temperature``, ``top_k``, ``top_p`` and ``seed`` (row i
  samples with ``seed + i``).  Unknown keys are a 400; ``stream: true`` is a
  400 (not yet ported).
- ``POST /v2/models/{name}/infer`` (classifiers) -- V2 tensors in and out.
  Inputs are padded onto the predictor's sequence buckets; a batch of one
  goes through the dynamic batcher, a larger client batch is padded to a
  warmed batch bucket.  400 for bad input or an overlong sequence, 500 for
  a runtime failure.
- ``GET /v2/models/{name}`` -- model metadata.
- ``GET /metrics`` -- Prometheus text exposition (``server/metrics.py``);
  both POST routes record every answered request in the gate's families.
- ``GET /v2/health/live`` and ``GET /v2/health/ready``.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import signal
import threading
import time
from concurrent.futures import wait
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .batching import DynamicBatcher, apply_seq_pad, next_bucket
from .engine import InferenceEngine
from .generation import EngineShutdown, GenerationEngine
from .metrics import CONTENT_TYPE, ServerMetrics

_log = logging.getLogger("tpumlops_torch.server")

_GEN_PARAM_KEYS = frozenset(
    {"max_new_tokens", "eos_id", "temperature", "top_k", "top_p", "seed", "stream"}
)
# Parameters of the reference's /generate that this port does not serve yet.
_GEN_NOT_PORTED = frozenset({"debug", "slo_class"})

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}

_MODEL_ROUTE = re.compile(r"^/v2/models/([^/]+)(?:/(generate|infer))?$")

_V2_TO_NP = {
    "FP32": np.float32,
    "FP64": np.float64,
    "FP16": np.float16,
    "BF16": np.float32,  # JSON carries floats; the cast happens model-side
    "INT32": np.int32,
    "INT64": np.int64,
    "UINT8": np.uint8,
    "BOOL": np.bool_,
}
_NP_TO_V2 = {
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.bool_): "BOOL",
}


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
    # The V2 predict path's dynamic batcher.
    max_batch_size: int = 32
    max_batch_delay_ms: float = 5.0
    # Metric identity (the gate's {deployment_name, predictor_name, namespace}).
    predictor_name: str = "v1"
    deployment_name: str = ""
    namespace: str = "default"


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


def _to_v2_outputs(out) -> list[dict]:
    if isinstance(out, dict):
        items = list(out.items())
    elif isinstance(out, tuple):
        items = [(f"output_{i}", o) for i, o in enumerate(out)]
    else:
        items = [("output_0", out)]
    v2 = []
    for name, arr in items:
        arr = np.asarray(arr)
        v2.append({
            "name": name,
            "shape": list(arr.shape),
            "datatype": _NP_TO_V2.get(arr.dtype, "FP32"),
            "data": arr.ravel().tolist(),
        })
    return v2


def _add_batch_dim(out):
    if isinstance(out, tuple):
        return tuple(_add_batch_dim(o) for o in out)
    if isinstance(out, dict):
        return {k: _add_batch_dim(v) for k, v in out.items()}
    return np.asarray(out)[None, ...]


def _slice_batch(out, n: int):
    if isinstance(out, tuple):
        return tuple(_slice_batch(o, n) for o in out)
    if isinstance(out, dict):
        return {k: _slice_batch(v, n) for k, v in out.items()}
    return np.asarray(out)[:n]


def _concat_batches(chunks: list):
    if len(chunks) == 1:
        return chunks[0]
    first = chunks[0]
    if isinstance(first, tuple):
        return tuple(_concat_batches([c[i] for c in chunks]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _concat_batches([c[k] for c in chunks]) for k in first}
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


def parse_v2_inputs(body: dict) -> dict[str, np.ndarray]:
    """V2 request tensors -> named numpy arrays (all with one batch dim)."""
    inputs: dict[str, np.ndarray] = {}
    for tensor in body.get("inputs", []):
        dt = _V2_TO_NP.get(tensor.get("datatype", "FP32"))
        if dt is None:
            raise ValueError(f"unsupported datatype {tensor.get('datatype')}")
        inputs[tensor["name"]] = np.asarray(tensor["data"], dtype=dt).reshape(tensor["shape"])
    if not inputs:
        raise ValueError("request has no inputs")
    batches = {k: (v.shape[0] if v.ndim else None) for k, v in inputs.items()}
    if len(set(batches.values())) != 1 or None in batches.values() or 0 in batches.values():
        raise ValueError(f"inputs need one non-empty batch dimension, got {batches}")
    return inputs


class ModelServer(ThreadingHTTPServer):
    """The HTTP server plus the engine it fronts: a ``GenerationEngine``
    for a causal LM (``batcher`` None), or an ``InferenceEngine`` behind a
    ``DynamicBatcher`` for the V2 predict path."""

    daemon_threads = True
    # listen() backlog: the default of 5 resets connections under a burst
    # of concurrent clients.
    request_queue_size = 128

    def __init__(self, address, engine, model_name: str, metrics: ServerMetrics,
                 predictor, batcher: DynamicBatcher | None = None):
        self.engine = engine
        self.model_name = model_name
        self.metrics = metrics
        self.predictor = predictor
        self.batcher = batcher
        self.lifecycle = "loading"
        super().__init__(address, _Handler)

    @property
    def serves(self) -> str:
        return "infer" if self.batcher is not None else "generate"

    # -- /generate -----------------------------------------------------------

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

    # -- /infer --------------------------------------------------------------

    def infer(self, body: dict) -> dict:
        inputs = parse_v2_inputs(body)
        out = self._run(inputs)
        return {"model_name": self.model_name, "id": body.get("id", ""),
                "outputs": _to_v2_outputs(out)}

    def _run(self, inputs: dict[str, np.ndarray]):
        """Batch 1 via the dynamic batcher, larger client batches padded to
        warmed batch buckets; both always on sequence buckets."""
        if self.predictor.validate is not None:
            self.predictor.validate(inputs)
        if self.predictor.seq_pad:
            inputs = apply_seq_pad(inputs, self.predictor.seq_pad)
        if next(iter(inputs.values())).shape[0] == 1:
            out = self.batcher.submit({k: v[0] for k, v in inputs.items()}).result()
            return _add_batch_dim(out)
        return self._predict_bucketed(inputs)

    def _predict_bucketed(self, inputs: dict[str, np.ndarray]):
        """Pad a client batch up to the nearest warmed bucket (chunking one
        larger than max_batch_size), run each chunk as a batch of its own on
        the collector thread, then slice back."""
        batch = next(iter(inputs.values())).shape[0]
        cap = self.batcher.max_batch_size
        pending = []
        for start in range(0, batch, cap):
            chunk = {k: v[start:start + cap] for k, v in inputs.items()}
            n = next(iter(chunk.values())).shape[0]
            bucket = next_bucket(n, cap)
            if bucket > n:
                chunk = {k: np.concatenate([v, np.repeat(v[-1:], bucket - n, axis=0)])
                         for k, v in chunk.items()}
            pending.append((self.batcher.submit_batch(chunk), n))
        return _concat_batches([_slice_batch(f.result(), n) for f, n in pending])

    def metadata(self) -> dict:
        p = self.predictor
        return {"name": self.model_name, "platform": "tpumlops-torch",
                "flavor": p.name, "metadata": p.metadata}

    def shutdown_all(self) -> None:
        """Stop serving, then stop the engine (failing what is queued)."""
        self.lifecycle = "shutdown"
        self.shutdown()
        self.server_close()
        if self.batcher is not None:
            self.batcher.stop()
        else:
            self.engine.shutdown()


class _Handler(BaseHTTPRequestHandler):
    server: ModelServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access lines to logging
        _log.debug("%s - " + fmt, self.address_string(), *args)

    def _send(self, code: int, data: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json")

    def do_GET(self):
        srv = self.server
        m = _MODEL_ROUTE.match(self.path)
        if self.path == "/v2/health/live":
            live = srv.lifecycle != "shutdown"
            self._reply(200 if live else 503, {"live": live, "lifecycle": srv.lifecycle})
        elif self.path == "/v2/health/ready":
            ready = srv.lifecycle == "ready"
            self._reply(200 if ready else 503, {"ready": ready, "lifecycle": srv.lifecycle})
        elif self.path == "/metrics":
            self._send(200, srv.metrics.render(), CONTENT_TYPE)
        elif m is not None and m.group(2) is None and m.group(1) == srv.model_name:
            self._reply(200, srv.metadata())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv = self.server
        m = _MODEL_ROUTE.match(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if m is None or m.group(2) != srv.serves:
            self._reply(404, {"error": f"no route {self.path} for this model "
                                       f"(it serves /{srv.serves})"})
            return
        if m.group(1) != srv.model_name:
            self._reply(404, {"error": f"unknown model {m.group(1)!r}"})
            return
        t0 = time.perf_counter()
        code = 200
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            payload = srv.generate(body) if srv.serves == "generate" else srv.infer(body)
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            code, payload = 400, {"error": str(e)}
        except EngineShutdown as e:
            code, payload = 503, {"error": str(e)}
        except Exception as e:
            _log.exception("%s failed", srv.serves)
            code, payload = 500, {"error": str(e)}
        finally:
            srv.metrics.observe_request(time.perf_counter() - t0, code=code)
        self._reply(code, payload)


def build_server(predictor, config: ServerConfig, warmup: bool = True) -> ModelServer:
    """Engine + bound HTTP server for a loaded predictor; the engine is
    started (and warmed) and the server reads ready.  Call
    ``serve_forever()`` (on any thread) and ``shutdown_all()`` to stop."""
    metrics = ServerMetrics(
        deployment_name=config.deployment_name or config.model_name,
        predictor_name=config.predictor_name,
        namespace=config.namespace,
    )
    batcher = None
    if predictor.causal_lm is not None:
        engine = make_gen_engine(predictor, config)
        engine.start(warmup=warmup)
        stop = engine.shutdown
    else:
        engine = InferenceEngine(predictor, max_batch_size=config.max_batch_size,
                                 on_compile=metrics.inc_compilations)
        # Pipelined: the collector launches batch N+1 while N runs.
        batcher = DynamicBatcher(
            run_batch=engine.predict_async,
            max_batch_size=config.max_batch_size,
            max_batch_delay_ms=config.max_batch_delay_ms,
            on_batch=metrics.observe_batch,
            materialize=engine.materialize,
        )
        batcher.start()
        stop = batcher.stop
        if warmup:
            # Through the batcher, so the warmup launches on the thread
            # that serves (the batch histograms count these batches).
            try:
                engine.warmup(predict=lambda ex: batcher.submit_batch(ex).result())
            except Exception:
                stop()
                raise
    try:
        srv = ModelServer((config.host, config.port), engine, config.model_name,
                          metrics, predictor=predictor, batcher=batcher)
    except Exception:
        stop()
        raise
    srv.lifecycle = "ready"
    return srv


def main(argv: list[str] | None = None) -> None:
    from .loader import load_predictor

    ap = argparse.ArgumentParser(
        description="Serve a native artifact: a Llama over /generate or a "
                    "classifier over /v2/models/{name}/infer.")
    ap.add_argument("--model-uri", required=True)
    ap.add_argument("--model-name", default="model")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--quantize", default="none", choices=["none", "int8", "int8kv"])
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--max-batch-size", type=int, default=32)
    ap.add_argument("--max-batch-delay-ms", type=float, default=5.0)
    ap.add_argument("--predictor-name", default="v1")
    ap.add_argument("--deployment-name", default="")
    ap.add_argument("--namespace", default="default")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; the CPU only when named)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    config = ServerConfig(
        model_name=args.model_name, host=args.host, port=args.port,
        dtype=args.dtype, quantize=args.quantize, max_slots=args.max_slots,
        prefill_chunk=args.prefill_chunk, device=args.device,
        max_batch_size=args.max_batch_size, max_batch_delay_ms=args.max_batch_delay_ms,
        predictor_name=args.predictor_name, deployment_name=args.deployment_name,
        namespace=args.namespace,
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
    _log.info("serving %s (%s) on %s:%d", config.model_name, predictor.name, host, port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown_all()
