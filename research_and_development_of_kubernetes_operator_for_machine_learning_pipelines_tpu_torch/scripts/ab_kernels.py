"""In-process A/B of the port's kernels against another checkout.

The counterpart of the JAX repository's ``scripts/ab_attention.py``: times
compared across processes (or across calls, which may land on other cards
and hosts) drift, so two versions are compared only in one process, in
turns.  The other checkout's port is loaded under the module name
``ab_other`` (it builds its own kernels into its own ``build/``), and for
every shape this checkout's wrapper and the other's run on the same
inputs, this, other, other, this in each round:

- ``ms``: CUDA-event milliseconds a call over back-to-back calls, the
  host's launch included (``chip_smoke.py``'s "ms");
- ``device_ms``: the profiler's device milliseconds a call (each one's
  mean a launch, summed over the kernels a call launches) of the kernels
  whose names hold ``decode_attention_kernel``, ``attention_kernel`` (a
  verify call: its pieces and their join, or an older checkout's split
  and merge kernels), ``flash_attention_kernel``, ``flash_ragged``,
  ``dmajor_attention_kernel`` or ``rmsnorm_kernel``.

Each is the minimum over rounds; every reading is kept beside it
(``ms_runs``, ``device_ms_runs``).  Shapes: ``chip_smoke.py``'s decode
window ladder (4 slots, 32 kv heads, G = 1, D = 128, bf16 q, windows
rotated over 8 layers of a cache), the verify chunk at S = 2, 5, 17 and
65 on the same windows (W = 768, int8 and bf16), its bf16 flash cases,
the ragged packed prefill at its timed shape (B_p 4, C 256, offsets
0/256/768/3840 of a T = 4096 cache of 10 rows, H = NKV = 32, D = 128,
int8 and bf16 caches, 4 layers), the D-major kernel at the layout
probe's shapes (8 and 32 slots, 16 kv heads, D = 128, W = 512, f32 q,
windows rotated over copies that exceed the 50 MB L2) and RMSNorm at
Llama-2-7B's width (4 and 512 rows of 4096, bf16).
Run on the card, with the other checkout unpacked where ``.gitignore``
lists it::

    mkdir -p build/ab_other && git archive <commit> | tar -x -C build/ab_other
    python -m <port>.scripts.ab_kernels --other build/ab_other --rounds 2 \
        [--shapes decode_w16,flash_bert_b32_s128_bias]

One JSON line per shape, then one line with the card and every shape.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

from ..ops import decode_attention as da
from ..ops import dmajor_attention as dm
from ..ops import flash_attention as fa
from ..ops import rmsnorm as rn

_PKG = Path(__file__).resolve().parents[1].name
LADDER = (16, 48, 192, 768, 1536, 4096)
LAYERS = 8


def load_other(root: str):
    """The other checkout's ``ops.decode_attention`` and
    ``ops.flash_attention`` modules, imported as package ``ab_other``."""
    pkg_dir = Path(root).resolve() / _PKG
    spec = importlib.util.spec_from_file_location(
        "ab_other", pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ab_other"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("ab_other.ops.decode_attention"),
            importlib.import_module("ab_other.ops.flash_attention"))


def other_module(name: str):
    """``ops.<name>`` of the checkout :func:`load_other` imported."""
    return importlib.import_module(f"ab_other.ops.{name}")


def event_ms(fn, iters: int = 100) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, needle: str, iters: int = 50) -> float | None:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a profiler window now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # Each matching kernel runs once a call: its mean a launch the
        # profiler saw, so a window that misses launches reads no faster.
        per_launch = [e.self_device_time_total / e.count for e in prof.key_averages()
                      if needle in e.key and e.count and e.self_device_time_total]
        if per_launch:
            return sum(per_launch) / 1e3
    return None


def decode_shapes(gen):
    """name -> a call taking the module: the ladder's windows rotated over
    LAYERS layers of one head-major cache."""
    b, nkv, d, t = 4, 32, 128, 4096
    shape = (LAYERS, b, nkv, t, d)
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand(shape[:4] + (1,), generator=gen, device="cuda") * 0.01 + 1e-3
    vs = torch.rand(shape[:4] + (1,), generator=gen, device="cuda") * 0.01 + 1e-3
    q = torch.randn((b, nkv, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    k_self = torch.randn((b, nkv, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    v_self = torch.randn((b, nkv, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for w in LADDER:
        mask = torch.zeros((b, 1, w), device="cuda")
        views = [(q, k8[i, :, :, :w], ks[i, :, :, :w], v8[i, :, :, :w], vs[i, :, :, :w],
                  k_self, v_self, mask) for i in range(LAYERS)]
        it = {"i": 0}

        def call(mod, views=views, it=it):
            it["i"] += 1
            return mod.decode_attention_vpu(*views[it["i"] % LAYERS])

        out[f"decode_w{w}"] = call
    return out


def verify_shapes(gen):
    """name -> a call taking the module: the verify chunk at S = 2, 5, 17
    and 65 (G = 1), bf16 q, over W = 768 windows rotated over LAYERS
    layers of one head-major int8 or bf16 cache (lengths W/4 .. W)."""
    from ..models.llama import _quant_kv

    b, nkv, d, t, w = 4, 32, 128, 1024, 768
    shape = (LAYERS, b, nkv, t, d)
    bf = torch.bfloat16
    caches = {
        "int8": (torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
                 torch.rand(shape[:4] + (1,), generator=gen, device="cuda") * 0.01 + 1e-3,
                 torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8),
                 torch.rand(shape[:4] + (1,), generator=gen, device="cuda") * 0.01 + 1e-3),
        "bf16": (torch.randn(shape, generator=gen, device="cuda").to(bf), None,
                 torch.randn(shape, generator=gen, device="cuda").to(bf), None),
    }
    lens = torch.tensor([w // 4, w // 2, 3 * w // 4, w], device="cuda")
    mask = torch.where(torch.arange(w, device="cuda")[None, :] < lens[:, None], 0.0,
                       -1e9).to(torch.float32)[:, None, :]
    out = {}
    for tag, (k, ks, v, vs) in caches.items():
        for s in (2, 5, 17, 65):
            q = torch.randn((b, nkv, s, d), generator=gen, device="cuda").to(bf)
            kc = torch.randn((b, nkv, s, d), generator=gen, device="cuda").to(bf)
            vc = torch.randn((b, nkv, s, d), generator=gen, device="cuda").to(bf)
            if ks is None:
                views = [(q, k[i, :, :, :w], v[i, :, :, :w], kc, vc, mask)
                         for i in range(LAYERS)]
            else:
                rt = (*_quant_kv(kc), *_quant_kv(vc))
                views = [(q, k[i, :, :, :w], ks[i, :, :, :w], v[i, :, :, :w], vs[i, :, :, :w],
                          kc, vc, *rt, mask) for i in range(LAYERS)]
            it = {"i": 0}

            def call(mod, views=views, it=it, dense=ks is None):
                it["i"] += 1
                fn = mod.verify_attention_dense if dense else mod.verify_attention
                return fn(*views[it["i"] % LAYERS])

            out[f"verify_{tag}_s{s}"] = call
    return out


def ragged_shapes(gen):
    """name -> a call taking the module: the ragged packed prefill at
    chip_smoke.py's timed shape, int8 (with scales and the chunk's
    round-trip codes) and bf16 caches, rotated over 4 layers."""
    from ..models.llama import _quant_kv

    bp, c, h, d, t, ns, layers = 4, 256, 32, 128, 4096, 10, 4
    bf = torch.bfloat16
    q = torch.randn((bp, c, h, d), generator=gen, device="cuda").to(bf)
    kc = torch.randn((bp, c, h, d), generator=gen, device="cuda").to(bf)
    vc = torch.randn((bp, c, h, d), generator=gen, device="cuda").to(bf)
    rt = (*_quant_kv(kc), *_quant_kv(vc))
    slots = torch.tensor([3, 7, 0, 5], dtype=torch.int32, device="cuda")
    offsets = torch.tensor([0, 256, 768, 3840], dtype=torch.int32, device="cuda")
    shape = (layers, ns, h, t, d)
    out = {}
    for tag in ("int8", "bf16"):
        if tag == "int8":
            k, v = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                  dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand(shape[:4] + (1,), generator=gen, device="cuda") * 0.02 + 1e-3
                      for _ in range(2))
            views = [(q, k[i], v[i], slots, offsets, kc, vc, ks[i], vs[i], rt)
                     for i in range(layers)]
        else:
            k, v = (torch.randn(shape, generator=gen, device="cuda").to(bf) for _ in range(2))
            views = [(q, k[i], v[i], slots, offsets, kc, vc) for i in range(layers)]
        it = {"i": 0}

        def call(mod, views=views, it=it):
            it["i"] += 1
            return mod.flash_attention_ragged(*views[it["i"] % layers])

        out[f"ragged_{tag}"] = call
    return out


def flash_shapes(gen):
    """name -> a call taking the module: chip_smoke.py's bf16 flash cases
    (same shapes and masks; other random values)."""
    def case(b, h, s, d, bias_lengths=None, **kw):
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        if bias_lengths is not None:
            lens = torch.as_tensor(bias_lengths, device="cuda")
            kw["bias"] = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None],
                                     0.0, -1e9).to(torch.float32)
        return lambda mod: mod.flash_attention(q, k, v, **kw)

    lens = torch.randint(8, 129, (32,), generator=torch.Generator().manual_seed(11)).tolist()
    return {
        "flash_bert_b32_s128_bias": case(32, 12, 128, 64, lens),
        "flash_b8_s512_bias": case(8, 12, 512, 64, [300, 512, 100, 32, 400, 511, 256, 64]),
        "flash_causal_d128_s1024": case(2, 16, 1024, 128, causal=True),
        "flash_kv_len_d128_s1024": case(2, 16, 1024, 128, kv_len=700),
        "flash_ragged_s50": case(4, 12, 50, 64),
        "flash_d16_s200_bias": case(4, 8, 200, 16, [0, 57, 133, 200]),
        "flash_d32_s200_bias": case(4, 8, 200, 32, [200, 1, 99, 0]),
        "flash_causal_s200": case(4, 8, 200, 64, causal=True),
    }


def dmajor_shapes(gen):
    """name -> a call taking the module: the D-major kernel at the layout
    probe's shapes, f32 q, full lengths, over enough copies of the window
    (real D-major tensors) that the calls exceed the 50 MB L2."""
    out = {}
    for b in (8, 32):
        window = b * dm.NKV * dm.D * dm.W * 2
        copies = max(2, math.ceil(150e6 / window))
        shape = (copies, b, dm.NKV, dm.D, dm.W)
        k8t = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        v8t = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        ks = torch.rand((copies, b, dm.NKV, 1, dm.W), generator=gen, device="cuda") * 0.01 + 1e-3
        vs = torch.rand((copies, b, dm.NKV, 1, dm.W), generator=gen, device="cuda") * 0.01 + 1e-3
        q = torch.randn((b, dm.NKV, dm.D, 1), generator=gen, device="cuda")
        mask = torch.zeros((b, 1, dm.W), device="cuda")
        views = [(q, k8t[i], ks[i], v8t[i], vs[i], mask) for i in range(copies)]
        it = {"i": 0}

        def call(mod, views=views, it=it):
            it["i"] += 1
            return mod.attn_dmajor(*views[it["i"] % len(views)])

        out[f"dmajor_b{b}"] = call
    return out


def rmsnorm_shapes(gen):
    """name -> a call taking the module: RMSNorm of 4 (decode) and 512
    (prefill) rows of Llama-2-7B's 4096-wide bf16 hidden state."""
    out = {}
    scale = (1 + 0.1 * torch.randn((4096,), generator=gen, device="cuda")).to(torch.bfloat16)
    for rows in (4, 512):
        x = torch.randn((rows, 4096), generator=gen, device="cuda").to(torch.bfloat16)
        out[f"rmsnorm_rows{rows}"] = lambda mod, x=x: mod.rmsnorm(x, scale, 1e-5)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shapes", default="", help="comma-separated shape names (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device; the A/B times the card")
    other_da, other_fa = load_other(args.other)
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = [(name, call, (da, other_da), "decode_attention_kernel")
              for name, call in decode_shapes(gen).items()]
    shapes += [(name, call, (da, other_da), "attention_kernel")
               for name, call in verify_shapes(gen).items()]
    shapes += [(name, call, (fa, other_fa), "flash_attention_kernel")
               for name, call in flash_shapes(gen).items()]
    shapes += [(name, call, (fa, other_fa), "flash_ragged")
               for name, call in ragged_shapes(gen).items()]
    shapes += [(name, call, (dm, other_module("dmajor_attention")), "dmajor_attention_kernel")
               for name, call in dmajor_shapes(gen).items()]
    shapes += [(name, call, (rn, other_module("rmsnorm")), "rmsnorm_kernel")
               for name, call in rmsnorm_shapes(gen).items()]
    if args.shapes:
        shapes = [x for x in shapes if x[0] in args.shapes.split(",")]
    results = {}
    for name, call, (this, other), needle in shapes:
        r = {"this": {"ms": [], "device_ms": []}, "other": {"ms": [], "device_ms": []}}
        for _ in range(args.rounds):
            for side, mod in (("this", this), ("other", other), ("other", other),
                              ("this", this)):
                r[side]["ms"].append(event_ms(lambda mod=mod: call(mod)))
                r[side]["device_ms"].append(device_ms(lambda mod=mod: call(mod), needle))
        for side in ("this", "other"):
            for key in ("ms", "device_ms"):
                vals = [x for x in r[side][key] if x is not None]
                r[side][f"{key}_runs"] = vals
                r[side][key] = min(vals) if vals else None
        if name.startswith("decode_w"):
            r["splits"] = da.num_splits(4, 32, int(name[len("decode_w"):]))
        elif name.startswith("dmajor_b"):
            r["splits"] = dm.dmajor_splits(int(name[len("dmajor_b"):]), dm.NKV, dm.W)
        results[name] = r
        print(json.dumps({name: r}), flush=True)
    summary = {"device": torch.cuda.get_device_name(0), "rounds": args.rounds,
               "other": str(args.other), "shapes": results}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
