"""The port's unified ragged super-step against the JAX package, on the CPU.

- ``superstep_window`` equal to the reference's over a grid.
- ``llama._commit_block_at`` against the JAX one (whose parked columns
  drop) on a 5-row cache near capacity, bf16 and int8: the whole cache
  equal after the commit.
- ``llama.super_step_ragged`` against the jitted JAX one on a batch of
  idle, decode, verify and prefill rows, steps 1 and 3, greedy and
  seeded-sampled, on the bf16 and the int8 cache, f64 activations: the
  token block, ``valid``, accepted, tokens, lengths, keys, greedy at live
  columns and the committed cache equal, logits at live columns within
  1e-6 (the reference rounds every product to f32).
- The plain verify attention with ``counts``: live rows equal to the call
  without it, parked rows zero.
- The unified engine (``unified_step=True``) against JAX
  ``generate_greedy``, the port's split engine and the JAX unified engine:
  the reference's own engine cases of ``tests/test_superstep.py``.
- ``SuperstepProgram`` on the CPU equal to the direct call; the engine's
  gating; ``--unified-step`` and ``unifiedStep``.

Reference cases that wait: the flag in the operator's rendered manifests
(the control-plane backend), tp x 2 / 4 and the multi-host replay
(parallelism and multi-host), and the telemetry warmup count (its
counterpart here is the number of graphs a CUDA engine captures, checked
on the card).
"""

import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    prng as TP,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as TR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    sampling as TS,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    decode_attention as TDA,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    cuda_graphs as TCG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    prefix_cache as tpc,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    speculative as tsp,
)
from tpumlops.models import llama as J
from tpumlops.models import sampling as JS
from tpumlops.server import generation as JG

JCFG = J.LlamaConfig.tiny(max_seq=64)
TCFG = T.LlamaConfig.tiny(max_seq=64)
CAP = JCFG.max_seq
SAMPLED = dict(temperature=0.9, top_k=7, top_p=0.95)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def tiny(x64):
    jp = J.init(jax.random.key(0), JCFG, dtype=jnp.float64)
    tp = convert.from_jax_numpy(jax.device_get(jp))
    return jp, tp


@functools.lru_cache(maxsize=None)
def _jgen():
    return jax.jit(J.generate_greedy, static_argnums=(2, 3), static_argnames=("dtype",))


def _ref(jp, prompt, n, eos=None):
    out = np.asarray(_jgen()(jp, jnp.asarray([prompt], jnp.int32), n, JCFG,
                             dtype=jnp.float64))[0].tolist()
    if eos is not None and eos in out:
        out = out[: out.index(eos) + 1]
    return out


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# -- the window pre-pick --------------------------------------------------------


@pytest.mark.parametrize("capacity", [64, 96, 4096])
def test_superstep_window_matches_the_reference(capacity):
    for decode_hi in range(0, capacity + 1, max(1, capacity // 48)):
        for other_hi in (0, 1, 17, capacity // 2, capacity - 1, capacity):
            for steps in (1, 2, 4, 16):
                got = TG.superstep_window(decode_hi, other_hi, steps, capacity)
                assert got == JG.superstep_window(decode_hi, other_hi, steps, capacity)
                assert got in TG.decode_window_buckets(capacity)
                assert got >= min(max(other_hi, decode_hi + steps - 1 if decode_hi else 1),
                                  capacity)


# -- the per-position commit ----------------------------------------------------


def _rand_cache(rng, quant, b=5, dense_dtype=np.float32):
    shape = (JCFG.num_layers, b, JCFG.num_kv_heads, CAP, JCFG.head_dim)
    if quant:
        return dict(k8=rng.integers(-127, 128, shape).astype(np.int8),
                    k_scale=rng.uniform(0.01, 0.1, shape[:-1] + (1,)).astype(np.float32),
                    v8=rng.integers(-127, 128, shape).astype(np.int8),
                    v_scale=rng.uniform(0.01, 0.1, shape[:-1] + (1,)).astype(np.float32))
    return dict(k=rng.standard_normal(shape).astype(dense_dtype),
                v=rng.standard_normal(shape).astype(dense_dtype))


def _jax_cache(c, lengths, quant, dense=jnp.bfloat16):
    lengths = jnp.asarray(lengths, jnp.int32)
    if quant:
        return J.QuantRaggedKVCache(jnp.asarray(c["k8"]), jnp.asarray(c["k_scale"]),
                                    jnp.asarray(c["v8"]), jnp.asarray(c["v_scale"]), lengths)
    return J.RaggedKVCache(jnp.asarray(c["k"], dense), jnp.asarray(c["v"], dense), lengths)


def _port_cache(c, lengths, quant, dense=torch.bfloat16):
    lengths = torch.as_tensor(np.asarray(lengths, np.int32))
    if quant:
        return T.QuantRaggedKVCache(*(torch.from_numpy(c[n].copy())
                                      for n in ("k8", "k_scale", "v8", "v_scale")), lengths)
    return T.RaggedKVCache(torch.from_numpy(c["k"].copy()).to(dense),
                           torch.from_numpy(c["v"].copy()).to(dense), lengths)


def _cache_arrays(cache, quant):
    """The cache's buffers (torch or JAX) as f64 numpy arrays by name."""
    def f64(t):
        if isinstance(t, torch.Tensor):
            return t.to(torch.float64).numpy()
        return np.asarray(t).astype(np.float64)

    names = ("k8", "k_scale", "v8", "v_scale") if quant else ("k", "v")
    return {n: f64(getattr(cache, n)) for n in names}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_commit_block_at_matches_the_jax_drop_scatter(x64, quant):
    """Bases within S of capacity, counts 0 / 1 / draft + 1 / S: the kept
    positions take the block, every other position keeps its value (the
    parked columns inside the cache store themselves back, those past it
    store back S lower)."""
    rng = np.random.default_rng(3)
    S = 8
    c = _rand_cache(rng, quant)
    base = np.asarray([60, 3, 58, 64, 57], np.int32)
    counts = np.asarray([0, 1, 3, S, S], np.int32)
    news_shape = (JCFG.num_layers, 5, S, JCFG.num_kv_heads, JCFG.head_dim)
    k_news = rng.standard_normal(news_shape)
    v_news = rng.standard_normal(news_shape)
    jc = J._commit_block_at(_jax_cache(c, np.zeros(5), quant), jnp.asarray(k_news, jnp.bfloat16),
                            jnp.asarray(v_news, jnp.bfloat16), jnp.asarray(base),
                            jnp.asarray(counts), quant)
    tc = _port_cache(c, np.zeros(5), quant)
    tk = torch.from_numpy(k_news).to(torch.bfloat16)
    tv = torch.from_numpy(v_news).to(torch.bfloat16)
    if quant:
        tk, tv = T._quant_kv(tk), T._quant_kv(tv)
    T._commit_block_at(tc, tk, tv, torch.from_numpy(base), torch.from_numpy(counts), quant)
    got, want = _cache_arrays(tc, quant), _cache_arrays(jc, quant)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # Row 3 (base at capacity) and row 0 (counts 0) are untouched; row 4
    # keeps exactly positions 57..63.
    orig = _cache_arrays(_port_cache(c, np.zeros(5), quant), quant)
    first = next(iter(got))
    for row in (0, 3):
        np.testing.assert_array_equal(got[first][:, row], orig[first][:, row])
    changed = (got[first][:, 4] != orig[first][:, 4]).any(axis=(0, 1, 3))
    assert set(np.flatnonzero(changed)) <= set(range(57, 64))
    assert changed[:57].sum() == 0


# -- the super-step ---------------------------------------------------------------

# Rows: idle, decode, verify (draft 2), prefill (offset 8, a full chunk),
# decode near the top of its window.
S_BLOCK = 8
ROLES = np.asarray([T.ROLE_IDLE, T.ROLE_DECODE, T.ROLE_VERIFY, T.ROLE_PREFILL, T.ROLE_DECODE],
                   np.int32)
COUNTS = np.asarray([0, 1, 3, S_BLOCK, 1], np.int32)
LENGTHS = np.asarray([9, 5, 11, 0, 20], np.int32)
OFFSETS = np.asarray([0, 0, 0, 8, 0], np.int32)


def _ss_case(seed, quant):
    rng = np.random.default_rng(seed)
    c = _rand_cache(rng, quant, dense_dtype=np.float64)
    ids = rng.integers(0, JCFG.vocab_size, (5, S_BLOCK)).astype(np.int32)
    return dict(
        cache=c, ids=ids, draft_len=np.asarray([0, 0, 2, 0, 0], np.int32),
        active=np.asarray([False, True, True, False, True]),
        remaining=np.asarray([0, 9, 0, 0, 2], np.int32),
        eos=np.full((5,), -1, np.int32),
        keys=np.stack([TP.key(s).numpy() for s in (11, 2**32 + 5, 7, 3, 2**40)]),
        temps=np.asarray([0.0, 0.9, 0.0, 0.0, 0.7], np.float32),
        topk=np.asarray([0, 7, 0, 0, 3], np.int32),
        topp=np.asarray([1.0, 0.95, 1.0, 1.0, 0.8], np.float32),
    )


def _ss_window(steps):
    decode_hi = int(max(LENGTHS[ROLES == T.ROLE_DECODE]))
    other_hi = int(max(max(LENGTHS[ROLES == T.ROLE_VERIFY]), max(OFFSETS)))
    return TG.superstep_window(decode_hi, other_hi, steps, CAP)


@functools.lru_cache(maxsize=None)
def _jax_superstep(steps, window, sampling):
    def run(params, ids, cache, roles, offsets, counts, draft_len, active, remaining, eos,
            carry, temps, tks, tps):
        if sampling:
            def fn(lg, c):
                return JS.sample_chain_step(lg, c, temps, tks, tps)
        else:
            def fn(lg, c):
                return c, jnp.argmax(lg, axis=-1).astype(jnp.int32)
        return J.super_step_ragged(
            params, ids, cache, JCFG, roles=roles, offsets=offsets, counts=counts,
            draft_len=draft_len, active=active, remaining=remaining, eos_ids=eos,
            steps=steps, sample_fn=fn, sample_carry=carry if sampling else None,
            dtype=jnp.float64, window=window)

    return jax.jit(run)


def _port_superstep(tp, c, quant, steps, sampling):
    cache = _port_cache(c["cache"], LENGTHS, quant)
    targs = [torch.from_numpy(c[n]) for n in ("temps", "topk", "topp")]
    if sampling:
        def fn(lg, k):
            return TS.sample_chain_step(lg, k, *targs)
        carry = torch.from_numpy(c["keys"])
    else:
        def fn(lg, k):
            return k, torch.argmax(lg, dim=-1)
        carry = None
    return T.super_step_ragged(
        tp, torch.from_numpy(c["ids"]).long(), cache, TCFG, roles=torch.from_numpy(ROLES),
        offsets=torch.from_numpy(OFFSETS), counts=torch.from_numpy(COUNTS),
        draft_len=torch.from_numpy(c["draft_len"]), active=torch.from_numpy(c["active"]),
        remaining=torch.from_numpy(c["remaining"]), eos_ids=torch.from_numpy(c["eos"]),
        steps=steps, sample_fn=fn, sample_carry=carry, dtype=torch.float64,
        window=_ss_window(steps))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("steps,sampling", [(1, False), (3, True), (3, False)],
                         ids=["k1-greedy", "k3-sampled", "k3-greedy"])
def test_super_step_ragged_matches_the_jax_one(tiny, quant, steps, sampling):
    jp, tp = tiny
    c = _ss_case(5, quant)
    got = _port_superstep(tp, c, quant, steps, sampling)
    keys = jax.random.wrap_key_data(jnp.asarray(c["keys"], jnp.uint32))
    want = _jax_superstep(steps, _ss_window(steps), sampling)(
        jp, jnp.asarray(c["ids"]), _jax_cache(c["cache"], LENGTHS, quant), jnp.asarray(ROLES),
        jnp.asarray(OFFSETS), jnp.asarray(COUNTS), jnp.asarray(c["draft_len"]),
        jnp.asarray(c["active"]), jnp.asarray(c["remaining"]), jnp.asarray(c["eos"]), keys,
        jnp.asarray(c["temps"]), jnp.asarray(c["topk"]), jnp.asarray(c["topp"]))
    logits, tok_block, valid, greedy, accepted, toks, cache, act, rem, carry = got
    (jlogits, jtok, jvalid, jgreedy, jacc, jtoks, jcache, jact, jrem, jcarry) = want
    for name, a, b in (("tok_block", tok_block, jtok), ("valid", valid, jvalid),
                       ("accepted", accepted, jacc), ("toks", toks, jtoks),
                       ("lengths", cache.lengths, jcache.lengths), ("active", act, jact),
                       ("remaining", rem, jrem)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if sampling:
        np.testing.assert_array_equal(carry.numpy(), _kd(jcarry))
    live = np.arange(S_BLOCK)[None, :] < COUNTS[:, None]
    np.testing.assert_array_equal(greedy.numpy()[live], np.asarray(jgreedy)[live])
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(jlogits)[live], rtol=0,
                               atol=1e-6)
    got_c, want_c = _cache_arrays(cache, quant), _cache_arrays(jcache, quant)
    for name in got_c:
        if quant and name.startswith(("k8", "v8")):
            # codes of the same f32-rounded K/V: at most one step at a tie
            assert np.abs(got_c[name] - want_c[name]).max() <= 1, name
            assert (got_c[name] != want_c[name]).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(got_c[name], want_c[name], rtol=1e-6, atol=1e-7,
                                       err_msg=name)
    # The idle row and the prefill row's unused window stay as they were.
    orig = _cache_arrays(_port_cache(c["cache"], LENGTHS, quant), quant)
    first = next(iter(got_c))
    np.testing.assert_array_equal(got_c[first][:, 0], orig[first][:, 0])
    np.testing.assert_array_equal(got_c[first][:, 3, :, 16:], orig[first][:, 3, :, 16:])
    assert valid.tolist() == [0, steps, 0, 0, min(steps, 2)]


def test_super_step_ragged_at_one_step_is_a_decode_step_for_decode_rows(tiny):
    """Decode column 0 of the wide forward is the plain decode step: the
    decode rows' token, the committed row and the length equal one
    ``decode_ragged`` call's (the verify kernel with counts 1)."""
    _, tp = tiny
    c = _ss_case(6, False)
    out = _port_superstep(tp, c, False, 1, False)
    cache = _port_cache(c["cache"], LENGTHS, False)
    dec = torch.from_numpy(ROLES == T.ROLE_DECODE)
    logits, cache = T.decode_ragged(tp, torch.from_numpy(c["ids"][:, :1]).long(), cache, TCFG,
                                    dec, torch.float64, _ss_window(1))
    rows = [1, 4]
    np.testing.assert_allclose(out[0][rows, 0].numpy(), logits[rows, 0].numpy(), rtol=0,
                               atol=1e-6)
    assert out[1][rows, 0].tolist() == torch.argmax(logits[rows, 0], -1).tolist()


# -- the kernel's live count, plain version ----------------------------------------


@pytest.mark.parametrize("dense", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("g", [1, 4])
def test_verify_attention_counts_zero_the_parked_rows(dense, g):
    gen = torch.Generator().manual_seed(7)
    B, NKV, S, D, W = 4, 2, 6, 16, 40
    q = torch.randn(B, NKV, S * g, D, generator=gen)
    kc, vc = (torch.randn(B, NKV, S, D, generator=gen) for _ in range(2))
    lengths = torch.tensor([0, 7, 40, 21])
    mask = torch.where(torch.arange(W)[None, :] < lengths[:, None], 0.0, -1e9)[:, None]
    counts = torch.tensor([1, 0, S, 4], dtype=torch.int32)
    if dense:
        k, v = (torch.randn(B, NKV, W, D, generator=gen) for _ in range(2))
        args = (q, k, v, kc, vc, mask)
        fn = TDA.verify_attention_dense
    else:
        k8, v8 = (torch.randint(-127, 128, (B, NKV, W, D), generator=gen, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(B, NKV, W, 1, generator=gen) * 0.1 for _ in range(2))
        rt = [*T._quant_kv(kc), *T._quant_kv(vc)]
        args = (q, k8, ks, v8, vs, kc, vc, *rt, mask)
        fn = TDA.verify_attention
    full = fn(*args)
    part = fn(*args, counts=counts)
    live = (torch.arange(S * g) // g)[None, :] < counts[:, None]      # [B, R]
    assert torch.equal(part[live[:, None, :, None].expand_as(part)],
                       full[live[:, None, :, None].expand_as(full)])
    assert not part[~live[:, None, :, None].expand_as(part)].any()
    with pytest.raises(ValueError, match="counts must be"):
        fn(*args, counts=counts.to(torch.int64))


# -- the engine ---------------------------------------------------------------------


def _engine(tp, unified=True, decode_steps=4, max_slots=2, **kw):
    return TG.GenerationEngine(tp, TCFG, max_slots=max_slots, dtype=torch.float64,
                               device="cpu", decode_steps=decode_steps, unified_step=unified,
                               **kw)


def _run(engine, jobs):
    """Submit every job before the scheduler starts (the first admit phase
    sees all of them), then collect."""
    futs = [engine.submit(*args, **kw) for args, kw in jobs]
    engine.start()
    try:
        return [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()


SPEC = tsp.SpeculativeConfig(enabled=True, draft_tokens=2, ngram_min=1, ngram_max=4,
                             adaptive=True)


def test_engine_gating_builds_one_program_not_both(tiny):
    _, tp = tiny
    split = _engine(tp, unified=False)
    unified = _engine(tp)
    assert isinstance(unified._program, TCG.SuperstepProgram) and unified._unified
    assert isinstance(split._program, TCG.MultistepProgram) and not split._unified
    assert _engine(tp, decode_steps=1)._program is not None  # K 1 still one program
    assert _engine(tp, unified=False, decode_steps=1)._program is None
    assert "unified_step" not in TG._NOT_PORTED
    # The width: the verify chain, the prefill chunk, 1 with neither.
    assert unified._super_width == 1
    assert _engine(tp, speculative=SPEC)._super_width == 3
    assert _engine(tp, max_slots=4, prefill_chunk=16, prefill_batch=2,
                   speculative=SPEC)._super_width == 16


@pytest.mark.parametrize("chunk", [512, 1024])
def test_a_super_width_over_the_verify_kernel_is_refused(tiny, chunk):
    """A super-step as wide as a prefill chunk past 256 positions is taken
    (it was refused while the verify kernel held at most 256 chunk
    positions): the program's width is the chunk, as on the split engine."""
    _, tp = tiny
    cfg = T.LlamaConfig.tiny(max_seq=4096)
    unified = TG.GenerationEngine(tp, cfg, max_slots=2, dtype=torch.float64, device="cpu",
                                  unified_step=True, prefill_chunk=chunk, prefill_batch=2)
    assert unified._super_width == unified._program.width == chunk
    assert isinstance(unified._program, TCG.SuperstepProgram)
    # the split engine takes it too
    split = TG.GenerationEngine(tp, cfg, max_slots=2, dtype=torch.float64, device="cpu",
                                prefill_chunk=chunk, prefill_batch=2)
    assert split._program is None and split._prefill_chunk_size == chunk


WIDE_CFG = dict(max_seq=2048)


@pytest.fixture(scope="module")
def wide(x64):
    jcfg = J.LlamaConfig.tiny(**WIDE_CFG)
    jp = J.init(jax.random.key(3), jcfg, dtype=jnp.float64)
    return jcfg, jp, convert.from_jax_numpy(jax.device_get(jp))


@pytest.mark.parametrize("chunk", [512, 1024])
def test_a_wide_unified_engine_equals_the_jax_unified_engine(wide, chunk):
    """A one-rank unified engine whose super-step is as wide as a prefill
    chunk of 512 or 1024 positions, on a tiny Llama with 2048 positions,
    against the JAX package's unified engine at the same width (f64,
    greedy): a 700-token prompt (two chunks of 512, or one of 1024) packed
    beside a short one, then decode rows in the same wide block."""
    jcfg, jp, tp = wide
    rng = np.random.default_rng(chunk)
    prompts = [(rng.integers(1, 250, 700).tolist(), 6), ([5, 9, 2], 9)]
    kw = dict(max_slots=2, prefill_chunk=chunk, prefill_batch=2, decode_steps=4)
    jeng = JG.GenerationEngine(jp, jcfg, dtype=jnp.float64, unified_step=True, **kw)
    jfuts = [jeng.submit(p, n) for p, n in prompts]
    jeng.start(warmup=False)
    try:
        want = [f.result(timeout=300).tolist() for f in jfuts]
    finally:
        jeng.shutdown()
    seen = []
    engine = TG.GenerationEngine(tp, T.LlamaConfig.tiny(**WIDE_CFG), dtype=torch.float64,
                                 device="cpu", unified_step=True, on_dispatch=seen.append,
                                 **kw)
    assert engine._program.width == chunk
    got = _run(engine, [((p, n), {}) for p, n in prompts])
    assert got == want
    assert set(seen) == {"superstep"}


def test_greedy_parity_and_one_dispatch_kind_a_tick(tiny):
    jp, tp = tiny
    seen = []
    engine = _engine(tp, on_dispatch=seen.append)
    jobs = [(([7, 1, 4, 8, 3], 8), {}), (([6, 2, 8, 4, 1], 8), {}), (([5, 9, 2], 13), {})]
    outs = _run(engine, jobs)
    assert outs == [_ref(jp, p, n) for (p, n), _ in jobs]
    assert engine.dispatches_total.get("superstep", 0) > 0
    assert set(engine.dispatches_total) == {"superstep", "prefill"}  # whole-prompt admissions
    assert set(seen) == {"superstep", "prefill"}
    for op in ("decode", "multistep", "verify", "packed-prefill"):
        assert engine.dispatches_total.get(op, 0) == 0, op


def test_seeded_sampling_equals_the_split_single_step_engine(tiny):
    _, tp = tiny
    jobs = [(([7, 1, 4, 8, 3], 8), dict(temperature=0.8, top_k=20, seed=123)),
            (([6, 2, 8, 4, 1], 8), dict(temperature=0.6, top_p=0.9, seed=7)),
            (([1, 2, 3], 6), {})]
    split = _run(_engine(tp, unified=False, decode_steps=1), jobs)
    unified = _run(_engine(tp), jobs)
    assert unified == split


@pytest.mark.parametrize("packed", [False, True], ids=["chunked", "packed"])
def test_seeded_sampling_with_packed_finals_equals_the_split_engine(tiny, packed):
    """Sampled rows finalized inside the super-step (their key split and
    first draw) against the split engine's packed or chunked admission."""
    _, tp = tiny
    kw = dict(max_slots=4, prefill_chunk=8, prefill_batch=4 if packed else 1)
    jobs = [((list(range(2, 23)), 7), dict(seed=11, **SAMPLED)),
            (([5, 9, 2], 6), dict(seed=3, **SAMPLED)),
            (([7, 1, 4, 8, 3, 9, 2, 6], 5), {}),
            (([11, 3], 4), dict(seed=2**40 + 9, **SAMPLED))]
    split = _run(_engine(tp, unified=False, decode_steps=1, **kw), jobs)
    unified = _run(_engine(tp, **kw), jobs)
    assert unified == split


def test_speculative_equals_the_split_engine_and_generate_greedy(tiny):
    jp, tp = tiny
    rep = [5, 9, 5, 9, 5, 9, 5, 9]
    jobs = [((rep, 12), {}), (([7, 1, 4, 8, 3], 9), {})]
    split = _run(_engine(tp, unified=False, decode_steps=1, speculative=SPEC), jobs)
    engine = _engine(tp, speculative=SPEC)
    unified = _run(engine, jobs)
    assert unified == split == [_ref(jp, p, n) for (p, n), _ in jobs]
    assert engine.spec_verify_ticks > 0 and engine.spec_accepted_tokens > 0
    assert engine.dispatches_total.get("verify", 0) == 0


def test_packed_prefill_with_ragged_chunk_counts(tiny):
    """Sub-chunk, exactly one chunk, several with a partial tail: prefill
    rows inside the shared dispatches, some beside decode rows."""
    jp, tp = tiny
    engine = _engine(tp, max_slots=4, prefill_chunk=8, prefill_batch=4)
    mixes = []
    real = engine._device_superstep

    def spy(ids, roles, *rest):
        mixes.append(sorted(set(roles.tolist())))
        return real(ids, roles, *rest)

    engine._device_superstep = spy
    prompts = [([5, 9, 2], 6), ([7, 1, 4, 8, 3, 9, 2, 6], 5), (list(range(2, 23)), 7),
               ([11, 3], 4)]
    outs = _run(engine, [((p, n), {}) for p, n in prompts])
    assert outs == [_ref(jp, p, n) for p, n in prompts]
    assert engine.dispatches_total.get("packed-prefill", 0) == 0
    assert engine.prefill_chunks_dispatched == 1 + 1 + 3 + 1
    # a prefill chunk rode a tick that also decoded
    assert any(T.ROLE_PREFILL in m and T.ROLE_DECODE in m for m in mixes)
    assert set(engine.dispatches_total) == {"superstep"}


def test_prefix_cache_hit_seeds_then_prefills_in_the_super_step(tiny):
    jp, tp = tiny
    engine = _engine(tp, prefill_chunk=8, prefill_batch=2,
                     prefix_cache=tpc.PrefixCacheConfig(enabled=True, budget_bytes=8 * 2**20,
                                                        chunk_tokens=8))
    p = list(range(2, 19))
    engine.start()
    try:
        cold = engine.generate(p, 6, timeout=120).tolist()
        warm = engine.generate(p, 6, timeout=120).tolist()
    finally:
        engine.shutdown()
    assert cold == warm == _ref(jp, p, 6)
    assert engine.prefix_hits == 1
    assert set(engine.dispatches_total) == {"superstep", "seed"}


def test_int8kv_equals_the_split_engine(tiny):
    """The quantized commit per position: tokens equal engine against
    engine (packed off, as the reference's case)."""
    _, tp = tiny
    jobs = [(([7, 1, 4, 8, 3], 8), {}), (([6, 2, 8, 4, 1], 8), {})]
    split = _run(_engine(tp, unified=False, decode_steps=1, kv_quant=True), jobs)
    unified = _run(_engine(tp, kv_quant=True), jobs)
    assert unified == split


def test_eos_and_short_budgets_inside_the_k_steps(tiny):
    jp, tp = tiny
    full = _ref(jp, [5, 9, 2], 24)
    eos = full[5]
    engine = _engine(tp, decode_steps=8)
    outs = _run(engine, [(([5, 9, 2], 24), dict(eos_id=eos)), (([7, 1, 4], 3), {})])
    assert outs == [_ref(jp, [5, 9, 2], 24, eos=eos), _ref(jp, [7, 1, 4], 3)]


def test_the_window_pre_pick_covers_each_role(tiny):
    jp, tp = tiny
    engine = _engine(tp, max_slots=3, prefill_chunk=8, prefill_batch=2, speculative=SPEC)
    seen = []
    real = engine._device_superstep

    def spy(ids, roles, offsets, counts, draft_len, active, remaining, eos_ids, last_pos,
            final_lens, slot_keys, r_temps, r_tks, r_tps, window, sampling):
        lengths = engine._cache.lengths.tolist()
        seen.append((window, roles.copy(), offsets.copy(), lengths))
        return real(ids, roles, offsets, counts, draft_len, active, remaining, eos_ids,
                    last_pos, final_lens, slot_keys, r_temps, r_tks, r_tps, window, sampling)

    engine._device_superstep = spy
    prompts = [(list(range(1, 15)), 20), ([5, 9, 5, 9, 5, 9], 10), (list(range(3, 27)), 4)]
    outs = _run(engine, [((p, n), {}) for p, n in prompts])
    assert outs == [_ref(jp, p, n) for p, n in prompts]
    buckets = TG.decode_window_buckets(CAP)
    for window, roles, offsets, lengths in seen:
        assert window in buckets
        for i, role in enumerate(roles):
            if role == T.ROLE_DECODE:
                assert window >= min(lengths[i] + 3, CAP)
            elif role == T.ROLE_VERIFY:
                assert window >= lengths[i]
            elif role == T.ROLE_PREFILL:
                assert window >= offsets[i]


def test_unified_engine_equals_the_jax_unified_engine(tiny):
    """One greedy packed case against the JAX package's own unified engine
    (started without its warmup sweep)."""
    jp, tp = tiny
    prompts = [(list(range(2, 23)), 6), ([5, 9, 2], 6), ([7, 1, 4, 8, 3, 9, 2, 6], 5)]
    kw = dict(max_slots=4, prefill_chunk=8, prefill_batch=4, decode_steps=4)
    jeng = JG.GenerationEngine(jp, JCFG, dtype=jnp.float64, unified_step=True, **kw)
    jfuts = [jeng.submit(p, n) for p, n in prompts]
    jeng.start(warmup=False)
    try:
        want = [f.result(timeout=300).tolist() for f in jfuts]
    finally:
        jeng.shutdown()
    got = _run(_engine(tp, **kw), [((p, n), {}) for p, n in prompts])
    assert got == want == [_ref(jp, p, n) for p, n in prompts]


def test_recovery_rebuilds_the_super_step_on_the_new_cache(tiny):
    jp, tp = tiny
    engine = _engine(tp)
    old = engine._program
    engine._reset_device_state()
    assert engine._program is not old
    assert engine._program.cache.k.data_ptr() == engine._cache.k.data_ptr()
    assert engine._tokens is engine._program.tokens
    engine.start()
    try:
        assert engine.generate([5, 9, 2], 6).tolist() == _ref(jp, [5, 9, 2], 6)
    finally:
        engine.shutdown()


# -- the program on the CPU ---------------------------------------------------------


def test_superstep_program_equals_the_direct_call(tiny):
    """The program's eager run on its staged buffers against
    ``super_step_ragged`` and the finalize written out by hand."""
    _, tp = tiny
    c = _ss_case(8, False)
    cache = _port_cache(c["cache"], LENGTHS, False)
    prog = TCG.SuperstepProgram(tp, TCFG, cache, 3, S_BLOCK, torch.float64, "cpu")
    assert prog.cache.k.data_ptr() == cache.k.data_ptr()
    keys = torch.from_numpy(c["keys"])
    temps, topk, topp = (torch.from_numpy(c[n]) for n in ("temps", "topk", "topp"))
    prog.load_state(torch.zeros((5, 1), dtype=torch.int64), cache.lengths, keys, temps, topk,
                    topp)
    last_pos = np.asarray([-1, -1, -1, 5, -1], np.int32)
    final_lens = np.asarray([0, 0, 0, 14, 0], np.int32)
    slot_keys = np.zeros((5, 2), np.int64)
    slot_keys[3] = TP.key(99).numpy()
    r = (np.asarray([0, 0, 0, 0.8, 0], np.float32), np.asarray([0, 0, 0, 5, 0], np.int32),
         np.asarray([1, 1, 1, 0.9, 1], np.float32))
    prog.stage(c["ids"], ROLES, OFFSETS, COUNTS, c["draft_len"], c["active"], c["remaining"],
               c["eos"], last_pos, final_lens, slot_keys, *r)
    window = _ss_window(3)
    out = prog.dispatch(window, True)
    want = _port_superstep(tp, dict(c, cache=c["cache"]), False, 3, True)
    logits, tok_block, valid, greedy, accepted, toks, wcache, _, _, carry = want
    np.testing.assert_array_equal(out.tok_block, tok_block.numpy())
    np.testing.assert_array_equal(out.valid, valid.numpy())
    np.testing.assert_array_equal(out.greedy, greedy.numpy())
    np.testing.assert_array_equal(out.accepted, accepted.numpy())
    f_carry, first = TS.sample_chain_step(logits[3:4, 5], torch.from_numpy(slot_keys[3:4]),
                                          *(torch.from_numpy(x[3:4]) for x in r))
    assert int(out.firsts[3]) == int(first[0])
    assert torch.equal(prog.keys[3], f_carry[0]) and torch.equal(prog.keys[:3], carry[:3])
    # decode rows K and their budget, the verify row accepted + 1, the final row L
    assert prog.lengths.tolist() == [9, 5 + 3, 11 + int(accepted[2]) + 1, 14, 20 + 2]
    assert prog.tokens[3, 0] == int(first[0]) and prog.tokens[:3, 0].tolist() == toks[:3, 0].tolist()
    assert prog.temps[3] == pytest.approx(0.8) and int(prog.topk[3]) == 5
    assert torch.equal(prog.cache.k, wcache.k) and torch.equal(prog.cache.v, wcache.v)
    assert prog.capture([16, 24]) is None and prog.graphs == {}  # no graph on the CPU
    assert prog.replays == 1


# -- the serving surface ------------------------------------------------------------------


def _args(*extra):
    return tapp.build_arg_parser().parse_args(["--model-uri", "x", *extra])


def test_unified_step_flag_and_spec_default_off():
    # A manifest's spec.tpu.unifiedStep is parsed by the reference's
    # operator (TpuSpec), whose builder passes --unified-step to the server:
    # the port's flag and ServerConfig take the same values and default.
    from tpumlops.utils.config import TpuSpec

    assert TpuSpec.from_spec({}).unified_step is False
    assert tapp.config_from_args(_args()).unified_step is False
    assert tapp.ServerConfig().unified_step is False
    for on in (True, False):
        conf = tapp.config_from_args(_args("--unified-step", str(int(on)), "--device", "cpu"))
        assert conf.unified_step is TpuSpec.from_spec({"unifiedStep": on}).unified_step is on
    pred = TR._build_llama(T.init(torch.Generator().manual_seed(3), TCFG), TCFG,
                           dtype=torch.float32)
    conf = tapp.config_from_args(_args("--unified-step", "1", "--decode-steps", "4",
                                       "--device", "cpu"))
    engine = tapp.make_gen_engine(pred, conf, tapp.ServerMetrics("d", "v1", "ns"))
    assert engine._unified and isinstance(engine._program, TCG.SuperstepProgram)


def test_a_served_unified_burst_shows_superstep_on_metrics():
    cfg = T.LlamaConfig.tiny(max_seq=64)
    pred = TR._build_llama(T.init(torch.Generator().manual_seed(3), cfg), cfg,
                           dtype=torch.float32)
    conf = tapp.ServerConfig(model_name="tiny", host="127.0.0.1", port=0, device="cpu",
                             decode_steps=4, unified_step=True, prefill_chunk=8,
                             prefill_batch=2)
    srv = tapp.build_server(pred, conf)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        body = json.dumps({"prompt_ids": [5, 9, 2], "max_new_tokens": 13}).encode()
        req = urllib.request.Request(url + "/v2/models/tiny/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())["outputs"][0]["data"]) == 13
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        srv.shutdown_all()
        th.join(timeout=30)
    supers = srv.engine.dispatches_total["superstep"]
    assert supers == 1 + 3  # the prefill chunk, then 12 decoded tokens 4 a dispatch
    assert set(srv.engine.dispatches_total) == {"superstep"}

    def value(name, **labels):
        total = 0.0
        for line in text.splitlines():
            if line.startswith(name + "{") and all(f'{k}="{v}"' in line
                                                     for k, v in labels.items()):
                total += float(line.rsplit(" ", 1)[1])
        return total

    assert value("tpumlops_engine_dispatches_total", op="superstep") == supers
    assert value("tpumlops_tick_seconds_count", kind="superstep") == supers
    assert value("tpumlops_itl_seconds_count") == 12
