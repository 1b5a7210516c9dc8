"""7B-scale load rehearsal: stream a Llama-2-7B artifact through the port's
``load_predictor`` with ``quantize="int8"``, record the wall and the card's
memory, then prove the loaded model decodes.

The counterpart of the JAX repository's ``scripts/rehearse_7b_load.py``,
with the same printed lines.  The loader reads ``params.npz`` one leaf at a
time and quantizes each matrix on the card as it arrives, so the card
never holds the bf16 tree.  Then a prefill of 16 tokens into a one-row
``RaggedKVCache`` and 8 greedy ``decode_ragged`` steps over a 512-position
window: at full depth that runs flash attention (the prefill), RMSNorm (2L
+ 1 a forward) and the decode kernel's bf16-window instance.  Run on the
card, on the artifact ``scripts/gen_7b_checkpoint.py`` writes::

    python -m <port>.scripts.rehearse_7b_load --path build/ckpt7b

It runs on ``cuda``, and on the CPU (the kernels' plain versions) only
with ``--device cpu``; the memory lines then read "not measured".
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models import llama
from ..models.quantization import _LLAMA_LAYER_MATS, is_quantized, quantized_bytes
from ..server.generation import resolve_device
from ..server.loader import load_predictor

PROMPT = 16   # prefill tokens (all ones, as the reference's)
STEPS = 8     # greedy decode steps
WINDOW = 512  # the decode steps' attended window


def _gib(n: int | None) -> str:
    return "not measured" if n is None else f"{n / 2**30:.2f} GiB"


def _memory(dev: torch.device, base: int) -> dict:
    """The card's allocated and peak bytes above ``base`` (what the caller
    held before), and its free and total bytes; None on the CPU."""
    if dev.type != "cuda":
        return {"allocated": None, "peak": None, "free": None, "total": None}
    free, total = torch.cuda.mem_get_info(dev)
    return {"allocated": torch.cuda.memory_allocated(dev) - base,
            "peak": torch.cuda.max_memory_allocated(dev) - base, "free": free, "total": total}


def greedy_chain(params: dict, cfg, dev, dtype=torch.bfloat16,
                 window: int = WINDOW) -> tuple[list[int], torch.Tensor]:
    """The rehearsal's decode: a ``PROMPT``-token prefill of ones into a
    one-row ``RaggedKVCache``, then ``STEPS`` greedy ``decode_ragged`` steps
    over ``window`` positions; the greedy tokens and the last logits."""
    cache = llama.RaggedKVCache.create(cfg, 1, dtype, device=dev)
    ids = torch.ones((1, PROMPT), dtype=torch.long, device=dev)
    logits, seq = llama.prefill(params, ids, cfg, dtype=dtype)
    cache = llama.insert_sequence(cache, seq, 0, PROMPT)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    tokens = [int(tok)]
    for _ in range(STEPS):
        logits, cache = llama.decode_ragged(params, tok, cache, cfg, dtype=dtype, window=window)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        tokens.append(int(tok))
    return tokens, logits


def rehearse(path, device=None, dtype=torch.bfloat16, window: int = WINDOW,
             log=print) -> dict:
    """Load ``path`` int8 onto ``device`` (``cuda`` unless named), check
    every layer matrix and the LM head are int8, decode, and return the
    figures: ``load_s``, the loader's ``load_stats``, ``stored_bytes``, the
    card's memory after the load and after the decode (bytes above what was
    allocated before the call), the greedy ``tokens``, the last ``logits``
    (f32, on the host) and the ``predictor``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    base = 0
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        log(f"device: {torch.cuda.get_device_name(dev)}")
    else:
        log(f"device: {dev}")
    stats: dict = {}
    t0 = time.perf_counter()
    pred = load_predictor(str(path), quantize="int8", device=dev, dtype=dtype,
                          load_stats=stats)
    if cuda:
        torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    loaded = _memory(dev, base)
    log(f"load time: {load_s:.1f}s")
    log(f"HBM in use: {_gib(loaded['allocated'])}  peak: {_gib(loaded['peak'])}  "
        f"limit: {_gib(loaded['total'])}")

    params = pred.causal_lm["params"]
    for name in _LLAMA_LAYER_MATS:
        if not is_quantized(params["layers"][name]):
            raise AssertionError(f"layers/{name} was not loaded as int8")
    if not is_quantized(params["lm_head"]):
        raise AssertionError("lm_head was not loaded as int8")
    stored = quantized_bytes(params)
    log(f"stored param bytes: {stored / 2**30:.2f} GiB (int8 leaves)")

    t0 = time.perf_counter()
    tokens, logits = greedy_chain(params, pred.causal_lm["cfg"], dev, dtype, window)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("the decode's logits are not finite")
    decode_s = time.perf_counter() - t0
    log(f"prefill+{STEPS} decode steps: {decode_s:.1f}s; logits finite")
    decoded = _memory(dev, base)
    log(f"HBM after decode: {_gib(decoded['allocated'])}  peak: {_gib(decoded['peak'])}")
    summary = {
        "load_s": round(load_s, 1),
        "hbm_weights_gib": None if loaded["allocated"] is None
        else round(loaded["allocated"] / 2**30, 2),
        "hbm_peak_gib": None if decoded["peak"] is None else round(decoded["peak"] / 2**30, 2),
        "hbm_limit_gib": None if loaded["total"] is None else round(loaded["total"] / 2**30, 2),
    }
    log(json.dumps(summary))
    return {"load_s": load_s, "load_stats": stats, "stored_bytes": stored, "loaded": loaded,
            "decoded": decoded, "decode_s": decode_s, "tokens": tokens,
            "logits": logits.float().cpu(), "summary": summary, "predictor": pred}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", default="build/ckpt7b", help="the artifact's directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rehearse(args.path, args.device)
    print("REHEARSAL OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
