"""A synthetic Llama-2-7B checkpoint (the real shapes, random bf16 weights)
in the native artifact layout: the multi-GiB artifact the load rehearsal
(``scripts/rehearse_7b_load.py``) reads.

The counterpart of the JAX repository's ``scripts/gen_7b_checkpoint.py``,
and the same artifact byte for byte: ``default_rng(0)`` standard normals
x 0.02, drawn in f32 chunks of 2^24 in the reference's leaf order and
rounded to bfloat16 to nearest even (``torch``'s rounding, which is
``ml_dtypes``'), written through the port's ``save_native_model``.  Like
the reference it draws and writes on the host (numpy, no card)::

    python -m <port>.scripts.gen_7b_checkpoint --out build/ckpt7b

The artifact takes 13.5 GB of disk (``build/`` is ignored by git); the
draw holds the bf16 tree, 13.5 GB, in host memory while it writes.
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from ..server.loader import save_native_model

# Llama-2-7B: hidden, layers, heads, KV heads, MLP width, vocabulary; the
# artifact's max_seq is 1024, as the reference writes it.
GEOMETRY = dict(hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=32,
                intermediate_size=11008, vocab_size=32000, max_seq=1024)
CHUNK = 1 << 24  # values drawn a call, as the reference draws them
DEFAULT_OUT = "build/ckpt7b"


def draw(rng: np.random.Generator, *shape: int) -> torch.Tensor:
    """``shape`` standard normals x 0.02 from ``rng`` in f32 chunks of
    ``CHUNK``, each rounded to bfloat16."""
    out = torch.empty(shape, dtype=torch.bfloat16)
    flat = out.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - i)
        flat[i:i + n] = torch.from_numpy(rng.standard_normal(n, dtype=np.float32) * 0.02
                                         ).to(torch.bfloat16)
    return out


def synthetic_params(geometry: dict = GEOMETRY) -> dict:
    """The reference's tree at ``geometry``, drawn leaf by leaf in its order
    from one ``default_rng(0)``."""
    g = geometry
    h, n_layers, inter, vocab = (g["hidden_size"], g["num_layers"], g["intermediate_size"],
                                 g["vocab_size"])
    rng = np.random.default_rng(0)
    return {
        "embed": draw(rng, vocab, h),
        "layers": {
            "q": draw(rng, n_layers, h, h), "k": draw(rng, n_layers, h, h),
            "v": draw(rng, n_layers, h, h), "o": draw(rng, n_layers, h, h),
            "gate": draw(rng, n_layers, h, inter), "up": draw(rng, n_layers, h, inter),
            "down": draw(rng, n_layers, inter, h),
            "attn_norm": draw(rng, n_layers, h), "mlp_norm": draw(rng, n_layers, h),
        },
        "final_norm": draw(rng, h),
        "lm_head": draw(rng, h, vocab),
    }


def write_checkpoint(path: str | Path, params: dict, geometry: dict = GEOMETRY) -> int:
    """Write ``params`` (any Llama tree of tensors, on any device) as a
    ``llama-generate`` artifact at ``path`` with ``geometry`` as its config;
    returns the bytes of ``params.npz``."""
    path = save_native_model(path, "llama-generate", params, config=dict(geometry))
    return (path / "params.npz").stat().st_size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT, help="the artifact's directory")
    args = ap.parse_args(argv)
    t0 = time.time()
    params = synthetic_params()
    print(f"generated in {time.time() - t0:.0f}s")
    t0 = time.time()
    nbytes = write_checkpoint(args.out, params)
    print(f"saved in {time.time() - t0:.0f}s")
    print(f"{nbytes / 1e9:.1f} GB\t{args.out} "
          f"({shutil.disk_usage(args.out).free / 1e9:.1f} GB free on its disk)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
