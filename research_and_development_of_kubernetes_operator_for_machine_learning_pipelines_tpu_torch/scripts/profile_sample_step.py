"""Device time of one sampled decode step by kernel, this checkout's beside
another's.

``models.sampling.sample_chain_step`` runs on the same logits ``[B, V]``
(f32, a seeded normal times 3, as the decode hands them) and keys at B 4
and 32, V 32000, under four filter mixes (T, top_k, top_p): the smoke's
(0.8, 50, 0.95), none (1.0, 0, 1.0), top-p only (0.7, 0, 0.9) and top-k 1
(0.8, 1, 1.0).  ``torch.profiler`` gives, a step, each kernel's device
milliseconds and launches (by its short name), their total, and the
share of the kernels ``torch.sort`` launches on its own (profiled alone on
the same shape, ascending and descending); the host's enqueue
milliseconds a step come from the wall clock over back-to-back steps.
With ``--other`` the other checkout's port (loaded under the package name
``ab_other``, as ``ab_kernels`` loads it; it builds its own kernels) runs
the same steps in turns: this, other, other, this in each round; each
number is the minimum over rounds.  Run on the card::

    mkdir -p build/ab_other && git archive <commit> | tar -x -C build/ab_other
    python -m <port>.scripts.profile_sample_step --other build/ab_other --rounds 2

One JSON line a (checkout, B, mix), then one with the card and all of
them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import time

import torch

from ..models import prng
from ..models import sampling
from .ab_kernels import load_other

MIXES = {"smoke": (0.8, 50, 0.95), "none": (1.0, 0, 1.0), "top_p": (0.7, 0, 0.9),
         "top_k1": (0.8, 1, 1.0)}
V = 32000


def _short(kernel: str) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters, as the profiler reports it."""
    k = re.split(r"[(<]", kernel.replace("(anonymous namespace)::", ""))[0]
    return k.rsplit("::", 1)[-1].strip().split(" ")[-1] or kernel


def by_kernel(fn, iters: int = 20) -> dict[str, dict[str, float]]:
    """{short kernel name: {"ms", "launches"}} a call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a profiler window now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out: dict[str, dict[str, float]] = {}
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", 0.0)
            if dev_us and e.count:
                k = out.setdefault(_short(e.key), {"ms": 0.0, "launches": 0.0})
                k["ms"] += dev_us / 1e3 / iters
                k["launches"] += e.count / iters
        if out:
            return out
    return {}


def host_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default="", help="root of another checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sample_step: no CUDA device; it profiles the card")
    sides = {"this": sampling}
    if args.other:
        load_other(args.other)
        sides["other"] = importlib.import_module("ab_other.models.sampling")
    gen = torch.Generator(device="cuda").manual_seed(11)
    results: dict = {}
    for b in (4, 32):
        logits = torch.randn(b, V, device="cuda", generator=gen) * 3
        keys = prng.split(prng.key(1234, "cuda"), b)
        sort_names = set(by_kernel(lambda: torch.sort(logits, dim=-1, stable=True)))
        sort_names |= set(by_kernel(lambda: torch.sort(logits, dim=-1, descending=True,
                                                       stable=True)))
        for mix, (t, k, p) in MIXES.items():
            params = (torch.full((b,), t, device="cuda"),
                      torch.full((b,), k, dtype=torch.int32, device="cuda"),
                      torch.full((b,), p, device="cuda"))
            runs = {side: [] for side in sides}
            order = ("this", "other", "other", "this") if len(sides) > 1 else ("this",)
            for _ in range(args.rounds):
                for side in order:
                    mod = sides[side]
                    step = (lambda mod=mod: mod.sample_chain_step(logits, keys, *params))
                    kern = by_kernel(step)
                    runs[side].append({
                        "kernels": kern,
                        "device_ms": sum(v["ms"] for v in kern.values()),
                        "launches": sum(v["launches"] for v in kern.values()),
                        "sort_ms": sum(v["ms"] for n, v in kern.items() if n in sort_names),
                        "host_ms": host_ms(step)})
            for side, rs in runs.items():
                best = min(rs, key=lambda r: r["device_ms"])
                rec = {**best, "device_ms_runs": [r["device_ms"] for r in rs],
                       "host_ms": min(r["host_ms"] for r in rs),
                       "host_ms_runs": [r["host_ms"] for r in rs]}
                results[f"{side}_b{b}_{mix}"] = rec
                print(json.dumps({f"{side}_b{b}_{mix}": rec}), flush=True)
    summary = {"device": torch.cuda.get_device_name(0), "rounds": args.rounds,
               "other": args.other, "V": V, "results": results}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
