"""Layout probe: D-major int8 decode attention against the head-major forms.

The counterpart of the JAX repository's ``scripts/proto_dmajor_attention.py``.
At the JAX bench's 1.35B geometry (16 KV heads of 128, a 512-position
window, 24 layers) it builds one set of int8 K/V windows with per-position
scales and ragged lengths, in the head-major layout ``[B, NKV, W, D]`` and
as real D-major copies ``[B, NKV, D, W]`` (``.transpose(2, 3).contiguous()``),
checks that every arm computes the same function, then times three arms,
each as milliseconds per decode step of ``LAYERS`` (24) attention calls:

- ``xla``: the head-major einsum chain (``ops.dmajor_attention.attn_xla``);
- ``dmajor``: the D-major kernel (``ops.dmajor_attention.attn_dmajor``);
- ``headmajor``: the port's production int8-KV decode kernel
  (``ops.decode_attention``) on the head-major copies.  That kernel always
  adds a self term, so it computes the same no-self-term function through
  an exact identity: the mask stops at L - 1 and the self term is the
  dequantized row L - 1.

Each arm is a data-chained loop (``c + 1e-6 * o``) timed by
``utils.timing.delta_timed``.  Run on the card::

    python -m <port>.scripts.proto_dmajor_attention --slots 8,32 --rounds 2

It runs on ``cuda``, and on the CPU (plain versions, host times) only with
``--device cpu``.  One JSON line per slot count, then the summary.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import decode_attention as da
from ..ops import dmajor_attention as dm
from ..utils.timing import delta_timed

PARITY_TOL = 1e-3  # max |arm - attn_xla|, as the JAX probe asserts


def make_inputs(b: int, device) -> dict:
    """The JAX probe's inputs, from one generator seeded with 0 (the JAX
    probe's ``jax.random.key(0)``, though the numbers differ): int8 K/V in
    [-127, 127], scales ``|N(0, 1)| * 0.01 + 1e-3``, f32 queries, lengths
    ``arange(b) * (W // b) + 1`` and a 0 / -1e9 mask; head-major tensors
    and their D-major copies."""
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (b, dm.NKV, dm.W, dm.D)
    k8 = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
    scale_shape = (b, dm.NKV, dm.W, 1)
    ksc = torch.randn(scale_shape, generator=gen, device=device).abs() * 0.01 + 1e-3
    vsc = torch.randn(scale_shape, generator=gen, device=device).abs() * 0.01 + 1e-3
    q = torch.randn((b, dm.NKV, 1, dm.D), generator=gen, device=device)
    lengths = torch.arange(b, device=device) * (dm.W // max(b, 1)) + 1
    mask = dm.length_mask(lengths, dm.W)
    return {
        "q": q, "k8": k8, "ks": ksc, "v8": v8, "vs": vsc, "mask": mask, "lengths": lengths,
        # D-major copies of the same values: real transposes, not views.
        "qt": q.transpose(2, 3).contiguous(),
        "k8t": k8.transpose(2, 3).contiguous(),
        "kst": ksc.transpose(2, 3).contiguous(),
        "v8t": v8.transpose(2, 3).contiguous(),
        "vst": vsc.transpose(2, 3).contiguous(),
    }


def probe(b: int, device, *, rounds: int, layers: int) -> dict:
    x = make_inputs(b, device)
    head = (x["k8"], x["ks"], x["v8"], x["vs"], x["mask"])
    dmaj = (x["k8t"], x["kst"], x["v8t"], x["vst"], x["mask"])
    # The head-major kernel's inputs, built once, outside the timed chain.
    _, _, _, _, _, k_self, v_self, hmask = dm.headmajor_self_row_inputs(
        x["q"], x["k8"], x["ks"], x["v8"], x["vs"], x["lengths"])

    # Parity first.
    ref = dm.attn_xla(x["q"], *head)
    got = dm.attn_dmajor(x["qt"], *dmaj).transpose(2, 3)
    hm = da.decode_attention(x["q"], x["k8"], x["ks"], x["v8"], x["vs"], k_self, v_self, hmask)
    delta = float((got - ref).abs().max())
    delta_hm = float((hm - ref).abs().max())
    if not (delta < PARITY_TOL and delta_hm < PARITY_TOL):
        raise AssertionError(f"parity: dmajor {delta}, headmajor {delta_hm} against "
                             f"attn_xla (tolerance {PARITY_TOL})")

    def step_x(c):
        return c + 1e-6 * dm.attn_xla(c, *head)

    def step_d(c):
        return c + 1e-6 * dm.attn_dmajor(c, *dmaj)

    def step_h(c):
        return c + 1e-6 * da.decode_attention(c, x["k8"], x["ks"], x["v8"], x["vs"],
                                              k_self, v_self, hmask)

    res, p99 = {}, {}
    for name, step, qin in (("xla", step_x, x["q"]), ("dmajor", step_d, x["qt"]),
                            ("headmajor", step_h, x["q"])):
        p = delta_timed(step, lambda i, qin=qin: qin + 1e-5 * i,
                        n1=layers, n2=layers * 5, runs=max(3, rounds * 2))
        res[name] = p[50] * layers  # seconds per decode step of `layers` calls
        p99[name] = p[99] * layers
    row = {f"{k}_ms_per_step": v * 1e3 for k, v in res.items()}
    row.update({f"{k}_p99_ms_per_step": v * 1e3 for k, v in p99.items()})
    row["speedup"] = res["xla"] / res["dmajor"]
    row["speedup_vs_headmajor"] = res["headmajor"] / res["dmajor"]
    row["max_abs_err"] = delta
    row["headmajor_max_abs_err"] = delta_hm
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", default="8,32")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {}
    for b in (int(s) for s in args.slots.split(",")):
        row = probe(b, device, rounds=args.rounds, layers=dm.LAYERS)
        out[str(b)] = row
        print(json.dumps({"slots": b, "device": kind, **row}), flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
