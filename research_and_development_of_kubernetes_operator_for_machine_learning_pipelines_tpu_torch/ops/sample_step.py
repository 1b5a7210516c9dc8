"""The sampled decode step: two CUDA kernels around the sort
(``csrc/sampling.cu``) and the plain chain.

Not a Pallas port: the JAX package samples in XLA (``models/sampling.py``
``sample_chain_step``).  ``sample_step(logits, keys, temperature, top_k,
top_p)`` returns ``(carry [B, 2] int64, tokens [B] int32)``: every row's
key split into the half it carries and the half it draws with, the
greedy token, ``logits / max(T, 1e-6)`` sorted stably as the reference's
``argsort(-scaled)`` sorts it, the top-k rank mask AND the exclusive
softmax-mass mask (``mass < clip(p, 0, 1)``), the Gumbel-max draw over
sorted ranks (the Gumbel's counter is the rank), and ``order[choice]`` or
the greedy token where ``T <= 0``.

On the card a step is three calls: the prep kernel (the negated scaled
values for the sort, each block's greedy and softmax partials, the key
split), ``torch.sort`` (the counterpart of the reference's ``jnp.argsort``,
which XLA runs there as well) and the draw kernel (the masks, threefry
and the Gumbel for kept ranks only, the argmax and the token; the last
block of a row to finish reduces it).  ``launches`` counts one a step.
The plain chain (``filter_logits``, ``prng.split_keys``,
``prng.categorical``, ``pick``) is the CPU's and the tests'.

The kernels' scaled values, greedy token, top-k mask and carry key are
the plain chain's exactly; the softmax sum and the exclusive mass are
added in another order, and the Gumbel of a kept rank is the device's
``logf``, so a token can differ from the plain one only where two chosen
scores lie within a few ulp or the plain mass at a rank whose keep
decision differs lies within a few f32 roundings of p.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..models import prng

# Kernel launches since import, one a sampled step (the plain chain never
# counts).
launches = 0

THREADS = 256          # csrc/sampling.cu's block
ITEMS = 4              # positions a thread
CHUNK = THREADS * ITEMS
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def sample_plan(v: int) -> tuple[int, int]:
    """(chunk, splits) of a row of ``v`` positions: a block of either
    kernel takes ``chunk`` consecutive positions (the last one ragged)."""
    return CHUNK, -(-v // CHUNK)


def filter_logits(logits, temperature, top_k, top_p):
    """The reference's filtering in sorted-logit space: ``(greedy token
    [B] int32, sort order [B, V], masked sorted logits [B, V] f32)``.  The
    order is the reference's ``argsort(-scaled)``: stable, NaN last."""
    b, v = logits.shape
    logits = logits.to(torch.float32)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)

    temp = torch.clamp(temperature.to(torch.float32), min=1e-6)[:, None]
    scaled = logits / temp
    neg_sorted, order = torch.sort(-scaled, dim=-1, stable=True)
    sorted_logits = -neg_sorted

    ranks = torch.arange(v, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k)[:, None]
    keep_k = ranks < k

    probs = torch.softmax(sorted_logits, dim=-1)
    # Exclusive cumsum: keep tokens while the mass BEFORE them is < p.
    cum_before = torch.cumsum(probs, dim=-1) - probs
    p = torch.clamp(top_p.to(torch.float32), 0.0, 1.0)[:, None]
    keep_p = cum_before < p
    masked = torch.where(keep_k & keep_p, sorted_logits,
                         torch.full_like(sorted_logits, _NEG_INF))
    return greedy_tok, order, masked


def pick(order, choice, temperature, greedy_tok) -> torch.Tensor:
    sampled_tok = torch.gather(order, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled_tok, greedy_tok)


def sample_step_reference(logits, keys, temperature, top_k, top_p):
    """The plain chain: ``prng.split_keys``, ``filter_logits``,
    ``prng.categorical`` with the use half, ``pick``."""
    carry, use = prng.split_keys(keys)
    greedy_tok, order, masked = filter_logits(logits, temperature, top_k, top_p)
    return carry, pick(order, prng.categorical(use, masked), temperature, greedy_tok)


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("sampling")
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        prep = lib.sample_prep_launch
        prep.argtypes = [ptr, i32, i64, i32, i32, i32, ptr, i64, ptr, i64, i64,
                         ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        draw = lib.sample_draw_launch
        draw.argtypes = [ptr, ptr, i32, i32, i32, ptr, i64, ptr, i64, ptr, i64, ptr,
                         ptr, ptr, ptr, ptr, ptr, ptr]
        prep.restype = draw.restype = ctypes.c_int
        _fns = (prep, draw)
    return _fns


def _check_param(name, t, b, dtype, dev):
    if t.device != dev or t.dtype != dtype or t.dim() != 1 or t.shape[0] != b:
        raise ValueError(f"sample_step: {name} must be {dtype} [{b}] on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def prep_launch(logits, keys, temperature):
    """The prep kernel alone (``sample_step`` has checked the inputs):
    ``(carry [B, 2] int64, neg [B, V] f32, state)``, ``neg`` the negated
    scaled logits for the sort and ``state`` what the draw kernel reads:
    each block's (greedy value, greedy index bits, m, z) ``[B, splits,
    4]`` f32, the use keys ``[B, 2]`` int32, and the draw's flags ``[B,
    splits]`` int64 and tickets ``[B, 2]`` int32, zeroed."""
    b, v = logits.shape
    dev = logits.device
    _, splits = sample_plan(v)
    neg = torch.empty((b, v), dtype=torch.float32, device=dev)
    part = torch.empty((b, splits, 4), dtype=torch.float32, device=dev)
    use = torch.empty((b, 2), dtype=torch.int32, device=dev)
    carry = torch.empty((b, 2), dtype=torch.int64, device=dev)
    flags = torch.empty((b, splits), dtype=torch.int64, device=dev)
    tickets = torch.empty((b, 2), dtype=torch.int32, device=dev)
    rc = _kernels()[0](
        logits.data_ptr(), _DTYPES[logits.dtype], logits.stride(0), b, v, splits,
        temperature.data_ptr(), temperature.stride(0), keys.data_ptr(), keys.stride(0),
        keys.stride(1), neg.data_ptr(), part.data_ptr(), use.data_ptr(), carry.data_ptr(),
        flags.data_ptr(), tickets.data_ptr(), _build.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"sample_prep kernel launch failed: cudaError {rc}")
    return carry, neg, (part, use, flags, tickets)


def draw_launch(neg_sorted, order, state, temperature, top_k, top_p):
    """The draw kernel alone over the sorted ``neg`` and the ``state`` of
    its step's prep kernel (which the draw leaves as it found it, so it
    may run again on it): tokens [B] int32."""
    b, v = neg_sorted.shape
    dev = neg_sorted.device
    _, splits = sample_plan(v)
    part, use, flags, tickets = state
    best = torch.empty((b, splits, 2), dtype=torch.float32, device=dev)
    tokens = torch.empty((b,), dtype=torch.int32, device=dev)
    rc = _kernels()[1](
        neg_sorted.data_ptr(), order.data_ptr(), b, v, splits, temperature.data_ptr(),
        temperature.stride(0), top_k.data_ptr(), top_k.stride(0), top_p.data_ptr(),
        top_p.stride(0), part.data_ptr(), use.data_ptr(), flags.data_ptr(),
        tickets.data_ptr(), best.data_ptr(), tokens.data_ptr(), _build.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"sample_draw kernel launch failed: cudaError {rc}")
    return tokens


def sample_step(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor):
    """``(carry [B, 2], tokens [B])`` of one sampled step over ``logits
    [B, V]`` under the row keys ``keys [B, 2]`` int64.  A CPU tensor takes
    the plain chain; a CUDA tensor launches the kernels or raises."""
    global launches
    if logits.device.type == "cpu":
        return sample_step_reference(logits, keys, temperature, top_k, top_p)
    if logits.dtype not in _DTYPES or logits.dim() != 2 or logits.stride(-1) != 1:
        raise ValueError(
            f"sample_step takes f32 or bf16 [B, V] logits with unit-stride rows, got "
            f"{logits.dtype} {tuple(logits.shape)} strides {logits.stride()}")
    b, v = logits.shape
    if not (1 <= b < 65536 and 1 <= v < 2**31):
        raise ValueError(f"sample_step: 1 <= B < 65536 and 1 <= V < 2**31, got [{b}, {v}]")
    dev = logits.device
    if keys.device != dev or keys.dtype != torch.int64 or tuple(keys.shape) != (b, 2):
        raise ValueError(
            f"sample_step: keys must be int64 [{b}, 2] on {dev}, got "
            f"{keys.dtype} {tuple(keys.shape)} on {keys.device}")
    _check_param("temperature", temperature, b, torch.float32, dev)
    _check_param("top_k", top_k, b, torch.int32, dev)
    _check_param("top_p", top_p, b, torch.float32, dev)
    if dev.type != "cuda":
        raise ValueError(f"sample_step: unsupported device {dev}")
    carry, neg, state = prep_launch(logits, keys, temperature)
    neg_sorted, order = torch.sort(neg, dim=-1, stable=True)
    tokens = draw_launch(neg_sorted, order, state, temperature, top_k, top_p)
    launches += 1
    return carry, tokens
