"""The port's fused multi-step decode against the JAX package, in float64
on the CPU.

- ``llama.decode_multistep`` against the jitted JAX one (the reference's
  ``lax.scan``) at K = 1, 4 and 16, greedy and with ``sample_chain_step``
  on both sides from the same key words: tokens, ``valid``, lengths,
  active / remaining out, keys out and the whole cache must match; and
  against K sequential ``decode_ragged`` steps of the port.
- The EOS latch freezes a row mid-chain.
- The engine at ``decode_steps`` K against JAX ``generate_greedy`` (slot
  churn, EOS mid-block, short budgets, the prefix cache, speculation,
  admissions and packed prefill), seeded sampling at K against the port's
  K = 1 engine (which ``test_torch_generation.py`` holds to the JAX
  engine), the dispatch counts, the window pre-pick, and the lag-1 double
  buffer of the program on the CPU.
- The window buckets, exhaustively against the reference's.
- ``--decode-steps`` / ``decodeSteps`` reach the engine, out-of-range
  values are refused with the reference's message, and a served burst
  shows on ``/metrics``.

On the CPU the program runs ``decode_multistep`` eagerly on its static
buffers; graph capture and replay run only on the card (``chip_smoke.py``
holds replay against the eager call there).
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


def _engine(tp, decode_steps=4, max_slots=2, **kw):
    return TG.GenerationEngine(tp, TCFG, max_slots=max_slots, dtype=torch.float64,
                               device="cpu", decode_steps=decode_steps, **kw)


# -- the model layer ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_multistep(steps, window, sampling):
    def run(params, toks, cache, active, remaining, eos, carry, temps, tks, tps):
        if sampling:
            def fn(lg, c):
                return JS.sample_chain_step(lg, c, temps, tks, tps)
        else:
            def fn(lg, c):
                return c, jnp.argmax(lg, axis=-1).astype(jnp.int32)
        return J.decode_multistep(params, toks, cache, JCFG, active, remaining, eos, steps,
                                  fn, sample_carry=carry if sampling else None,
                                  dtype=jnp.float64, window=window)

    return jax.jit(run)


def _case(seed=0, lengths=(5, 11, 0), remaining=(20, 3, 0), eos=(-1, -1, -1)):
    """A 3-row f64 cache of random K/V at ``lengths`` (row 2 inactive),
    pending tokens, budgets, EOS ids, keys and sampling rows."""
    rng = np.random.default_rng(seed)
    shape = (JCFG.num_layers, 3, JCFG.num_kv_heads, JCFG.max_seq, JCFG.head_dim)
    k, v = rng.standard_normal(shape), rng.standard_normal(shape)
    return dict(
        k=k, v=v, lengths=np.asarray(lengths, np.int32),
        toks=rng.integers(0, JCFG.vocab_size, (3, 1)).astype(np.int32),
        active=np.asarray([n > 0 for n in remaining]),
        remaining=np.asarray(remaining, np.int32), eos=np.asarray(eos, np.int32),
        keys=np.stack([TP.key(s).numpy() for s in (11, 2**32 + 5, 7)]),
        temps=np.asarray([0.9, 0.0, 0.7], np.float32),
        topk=np.asarray([7, 0, 3], np.int32), topp=np.asarray([0.95, 1.0, 0.8], np.float32),
    )


def _window(c, steps):
    hi = int(max(c["lengths"][c["active"]]))
    return TG.decode_window_bucket(min(hi + steps - 1, JCFG.max_seq), JCFG.max_seq)


def _port_sample(c, sampling):
    targs = [torch.from_numpy(c[n]) for n in ("temps", "topk", "topp")]
    if sampling:
        return (lambda lg, k: TS.sample_chain_step(lg, k, *targs)), torch.from_numpy(c["keys"])
    return (lambda lg, k: (k, torch.argmax(lg, dim=-1))), None


def _port_multistep(tp, c, steps, sampling):
    cache = T.RaggedKVCache(torch.from_numpy(c["k"].copy()), torch.from_numpy(c["v"].copy()),
                            torch.from_numpy(c["lengths"].copy()))
    fn, carry = _port_sample(c, sampling)
    return T.decode_multistep(
        tp, torch.from_numpy(c["toks"]).long(), cache, TCFG, torch.from_numpy(c["active"]),
        torch.from_numpy(c["remaining"]), torch.from_numpy(c["eos"]), steps, fn,
        sample_carry=carry, dtype=torch.float64, window=_window(c, steps))


def _jax_run(jp, c, steps, sampling):
    cache = J.RaggedKVCache(jnp.asarray(c["k"]), jnp.asarray(c["v"]), jnp.asarray(c["lengths"]))
    keys = jax.random.wrap_key_data(jnp.asarray(c["keys"], jnp.uint32))
    return _jax_multistep(steps, _window(c, steps), sampling)(
        jp, jnp.asarray(c["toks"]), cache, jnp.asarray(c["active"]),
        jnp.asarray(c["remaining"]), jnp.asarray(c["eos"]), keys, jnp.asarray(c["temps"]),
        jnp.asarray(c["topk"]), jnp.asarray(c["topp"]))


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("steps", [1, 4, 16])
def test_decode_multistep_matches_the_jax_scan(tiny, steps, sampling):
    """Row 1's budget of 3 ends mid-chain at K >= 4; row 2 is inactive."""
    jp, tp = tiny
    c = _case()
    got = _port_multistep(tp, c, steps, sampling)
    want = _jax_run(jp, c, steps, sampling)
    tok_block, valid, toks, cache, act, rem, carry = got
    jtok, jvalid, jtoks, jcache, jact, jrem, jcarry = want
    np.testing.assert_array_equal(tok_block.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(rem.numpy(), np.asarray(jrem))
    if sampling:
        np.testing.assert_array_equal(carry.numpy(), _kd(jcarry))
    for name, tx, jx in (("k", cache.k, jcache.k), ("v", cache.v, jcache.v)):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert valid.tolist() == [steps, min(steps, 3), 0]
    assert cache.lengths.tolist() == [5 + steps, 11 + min(steps, 3), 0]


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampled"])
def test_decode_multistep_matches_sequential_decode_ragged(tiny, sampling):
    _, tp = tiny
    c = _case(seed=1, remaining=(20, 20, 0))
    steps = 4
    tok_block, valid, _, cache, _, _, carry = _port_multistep(tp, c, steps, sampling)
    seq = T.RaggedKVCache(torch.from_numpy(c["k"].copy()), torch.from_numpy(c["v"].copy()),
                          torch.from_numpy(c["lengths"].copy()))
    fn, keys = _port_sample(c, sampling)
    active = torch.from_numpy(c["active"])
    toks = torch.from_numpy(c["toks"]).long()
    cols = []
    for _ in range(steps):
        logits, seq = T.decode_ragged(tp, toks, seq, TCFG, active, torch.float64,
                                      _window(c, steps))
        keys, nxt = fn(logits[:, -1], keys)
        toks = torch.where(active, nxt.long(), toks[:, 0])[:, None]
        cols.append(toks[:, 0])
    assert torch.equal(tok_block, torch.stack(cols, dim=1))
    assert valid.tolist() == [4, 4, 0]
    assert torch.equal(cache.lengths, seq.lengths)
    assert torch.equal(cache.k, seq.k) and torch.equal(cache.v, seq.v)
    if sampling:
        assert torch.equal(carry, keys)


def test_eos_latch_freezes_a_row_mid_chain(tiny):
    jp, tp = tiny
    c = _case(seed=2, remaining=(20, 20, 0))
    free = _port_multistep(tp, c, 8, False)[0][0].tolist()
    # the first token, from the third on, that row 0 has not drawn before
    j = next(i for i in range(2, 8) if free[i] not in free[:i])
    c["eos"] = np.asarray([free[j], -1, -1], np.int32)
    tok_block, valid, _, cache, act, rem, _ = _port_multistep(tp, c, 8, False)
    want = _jax_run(jp, c, 8, False)
    np.testing.assert_array_equal(tok_block.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[1]))
    assert int(valid[0]) == j + 1 and tok_block[0, :j + 1].tolist() == free[:j + 1]
    assert tok_block[0, j + 1:].tolist() == [free[j]] * (7 - j)  # frozen after the latch
    assert int(cache.lengths[0]) == 5 + j + 1 and not bool(act[0]) and int(rem[0]) == 19 - j
    assert int(valid[1]) == 8  # the other row runs on
    # nothing committed past the EOS row's last position
    np.testing.assert_array_equal(cache.k[:, 0, :, 6 + j:].numpy(), c["k"][:, 0, :, 6 + j:])


# -- the engine -------------------------------------------------------------------


CHURN = [([1, 2, 3] * 5, 10), ([5, 9, 2], 6), ([7, 1, 4, 8, 3], 9), ([42], 4),
         ([10, 20, 30, 40, 50, 60, 70], 5)]


@pytest.mark.parametrize("steps", [4, 16])
def test_engine_fused_matches_generate_greedy_with_slot_churn(tiny, steps):
    jp, tp = tiny
    engine = _engine(tp, decode_steps=steps)
    engine.start()
    try:
        futs = [engine.submit(p, n) for p, n in CHURN]
        outs = [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()
    assert outs == [_ref(jp, p, n) for p, n in CHURN]
    assert engine.dispatches_total.get("multistep", 0) > 0


@pytest.mark.parametrize("steps", [2, 4, 8])
def test_engine_fused_seeded_sampling_equals_single_step(tiny, steps):
    jp, tp = tiny
    outs = {}
    for k in (1, steps):
        engine = _engine(tp, decode_steps=k)
        engine.start()
        try:
            outs[k] = engine.generate([5, 9, 2], 9, seed=123, **SAMPLED).tolist()
            # A greedy row beside a sampled one: the sampled variant serves both.
            mixed = engine.submit([7, 1, 4], 6, temperature=0.7, seed=9)
            assert engine.generate([1, 2, 3], 6).tolist() == _ref(jp, [1, 2, 3], 6)
            outs[k, "mixed"] = mixed.result(timeout=120).tolist()
        finally:
            engine.shutdown()
        assert (engine.dispatches_total.get("multistep", 0) > 0) == (k > 1)
    assert outs[steps] == outs[1]
    assert outs[steps, "mixed"] == outs[1, "mixed"]


def test_engine_fused_eos_mid_block_and_short_budgets(tiny):
    jp, tp = tiny
    full = _ref(jp, [5, 9, 2], 24)
    eos = full[5]
    engine = _engine(tp, decode_steps=8)
    engine.start()
    try:
        out = engine.generate([5, 9, 2], 24, eos_id=eos).tolist()
        short = engine.generate([7, 1, 4], 3).tolist()
    finally:
        engine.shutdown()
    assert out == _ref(jp, [5, 9, 2], 24, eos=eos)
    assert short == _ref(jp, [7, 1, 4], 3) and len(short) == 3


def test_engine_fused_amortizes_dispatches(tiny):
    jp, tp = tiny
    prompt, n, K = [5, 9, 2], 25, 4
    seen = []
    engine = _engine(tp, decode_steps=K, on_dispatch=seen.append)
    engine.start()
    try:
        out = engine.generate(prompt, n).tolist()
    finally:
        engine.shutdown()
    assert out == _ref(jp, prompt, n)
    fused = engine.dispatches_total.get("multistep", 0)
    assert fused == -(-(n - 1) // K)  # 24 decoded tokens -> 6 fused dispatches
    assert engine.dispatches_total.get("decode", 0) == 0
    assert engine.decode_forwards == fused and engine.tokens_generated == n
    assert seen.count("multistep") == fused


def test_engine_fused_window_pre_pick_covers_k_steps(tiny):
    jp, tp = tiny
    engine = _engine(tp, decode_steps=4)
    windows = []
    real = engine._device_multistep

    def spy(window, sampling):
        hi = max(s.prompt_len + len(s.generated) for s in engine._slots if s is not None)
        windows.append((window, hi))
        return real(window, sampling)

    engine._device_multistep = spy
    engine.start()
    try:
        prompt = list(range(1, 15))  # crosses the 16 and 24 buckets inside blocks
        out = engine.generate(prompt, 20).tolist()
    finally:
        engine.shutdown()
    assert out == _ref(jp, prompt, 20)
    assert windows
    buckets = TG.decode_window_buckets(engine.capacity)
    for window, hi in windows:
        assert window >= min(hi + 3, engine.capacity) and window in buckets, (window, hi)
    # a window that the lag-1 bound grows is still a bucket: the first
    # dispatch sees the exact length, later ones the bound
    assert windows[0][0] == TG.decode_window_bucket(14 + 1 + 3, 64)


def test_engine_fused_with_prefix_cache(tiny):
    jp, tp = tiny
    shared = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]  # one 16-token chunk
    engine = _engine(tp, decode_steps=4, prefill_chunk=16,
                     prefix_cache=tpc.PrefixCacheConfig(enabled=True, budget_bytes=1 << 20,
                                                        chunk_tokens=16))
    engine.start()
    try:
        p1, p2 = shared + [11, 12], shared + [13]
        o1 = engine.generate(p1, 8).tolist()
        o2 = engine.generate(p2, 8).tolist()
    finally:
        engine.shutdown()
    assert o1 == _ref(jp, p1, 8) and o2 == _ref(jp, p2, 8)
    assert engine.prefix_hits == 1
    assert engine.dispatches_total.get("multistep", 0) > 0


def test_engine_fused_composes_with_speculation(tiny):
    """Ticks where a slot has a draft verify; draft-less ticks fuse, and a
    burst ends at the first draft."""
    jp, tp = tiny
    rep, rep_n = [1, 2, 3] * 5, 10
    rep_ref = _ref(jp, rep, rep_n)
    engine = _engine(tp, decode_steps=4, speculative=tsp.SpeculativeConfig(
        enabled=True, draft_tokens=2, ngram_min=1, ngram_max=4, adaptive=True))
    drafting = threading.Event()

    def propose(slot, budget):
        if drafting.is_set() and slot.history[: slot.prompt_len].tolist() == rep:
            g = len(slot.generated)
            return rep_ref[g: g + budget]
        return []

    engine._propose = propose
    bursts = []
    real_burst = engine._step_fused

    def burst(active_np, sampling):
        bursts.append(engine.dispatches_total.get("multistep", 0))
        if len(bursts) == 1:
            drafting.set()  # the rep stream drafts from its first harvest on
        real_burst(active_np, sampling)
        bursts[-1] = engine.dispatches_total.get("multistep", 0) - bursts[-1]

    engine._step_fused = burst
    engine.start()
    try:
        rnd = ([7, 1, 4, 8, 3], 9)
        futs = [engine.submit(rep, rep_n), engine.submit(*rnd)]
        # both admitted before the first decode tick
        outs = [f.result(timeout=120).tolist() for f in futs]
        solo = engine.generate([6, 2, 8, 4, 1], 8).tolist()
    finally:
        engine.shutdown()
    assert outs == [rep_ref, _ref(jp, *rnd)]
    assert solo == _ref(jp, [6, 2, 8, 4, 1], 8)
    assert engine.spec_verify_ticks > 0 and engine.spec_accepted_tokens > 0
    assert engine.dispatches_total.get("multistep", 0) > 0
    assert bursts[0] == 1  # the draft in hand after the first harvest ends the burst


def test_single_step_engine_runs_no_multistep(tiny):
    jp, tp = tiny
    engine = _engine(tp, decode_steps=1)
    assert not engine._fused and engine._program is None
    engine.start()
    try:
        out = engine.generate([5, 9, 2], 6).tolist()
    finally:
        engine.shutdown()
    assert out == _ref(jp, [5, 9, 2], 6)
    assert "multistep" not in engine.dispatches_total
    assert engine.dispatches_total.get("decode", 0) == 5


@pytest.mark.parametrize("packed", [False, True], ids=["queued", "packed"])
def test_engine_fused_defers_to_admissions(tiny, packed):
    """A queued request, or an admission mid-prefill, keeps ticks single
    step; the burst starts once nothing is owed."""
    jp, tp = tiny
    kw = dict(prefill_chunk=8, prefill_batch=2) if packed else {}
    engine = _engine(tp, decode_steps=8, **kw)
    reqs = [([5, 9, 2], 8), ([7, 1, 4], 8), ([1, 2, 3] * 6, 8)]
    futs = [engine.submit(p, n) for p, n in reqs]  # queued before the scheduler starts
    engine.start()
    try:
        outs = [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()
    assert outs == [_ref(jp, p, n) for p, n in reqs]
    assert engine.dispatches_total.get("decode", 0) > 0
    assert engine.dispatches_total.get("multistep", 0) > 0
    if packed:
        assert engine.dispatches_total.get("packed-prefill", 0) > 0


@pytest.mark.parametrize("steps", [0, -1, 17])
def test_engine_refuses_decode_steps_out_of_range(tiny, steps):
    _, tp = tiny
    with pytest.raises(ValueError, match=r"decode_steps must be in \[1, 16\]"):
        _engine(tp, decode_steps=steps)


def test_engine_accepts_every_decode_steps_in_range(tiny):
    _, tp = tiny
    for k in range(1, 17):
        engine = _engine(tp, decode_steps=k)
        assert engine._fused == (k > 1)
        assert (engine._program is not None) == (k > 1)


# -- the program's buffers ----------------------------------------------------------


def test_program_lag1_double_buffer_keeps_a_block_past_the_next_dispatch(tiny):
    _, tp = tiny
    c = _case(seed=3, remaining=(20, 20, 0))
    cache = T.RaggedKVCache(torch.from_numpy(c["k"].copy()), torch.from_numpy(c["v"].copy()),
                            torch.from_numpy(c["lengths"].copy()))
    prog = TCG.MultistepProgram(tp, TCFG, cache, 4, torch.float64, "cpu")
    assert prog.cache.k.data_ptr() == cache.k.data_ptr()  # the cache in place
    prog.load(torch.from_numpy(c["toks"]).long(), cache.lengths, torch.from_numpy(c["keys"]),
              *(torch.from_numpy(c[n]) for n in ("temps", "topk", "topp")),
              c["active"], c["remaining"], c["eos"])
    want = _port_multistep(tp, c, 8, False)[0]  # 8 steps = two chained ticks
    h1 = prog.dispatch(24, False)
    h2 = prog.dispatch(24, False)  # chained: no host input between the two
    assert h1 != h2
    assert torch.equal(prog.tok_block, want[:, 4:])  # the graph output holds tick 2
    tok1, valid1 = prog.harvest(h1)
    tok2, valid2 = prog.harvest(h2)
    np.testing.assert_array_equal(tok1, want[:, :4].numpy())
    np.testing.assert_array_equal(tok2, want[:, 4:].numpy())
    assert valid1.tolist() == valid2.tolist() == [4, 4, 0]
    assert prog.lengths.tolist() == [13, 19, 0] and prog.remaining.tolist() == [12, 12, 0]
    assert prog.capture([16, 24]) is None and prog.graphs == {}  # no graph on the CPU


def test_engine_recovery_rebuilds_the_program_on_the_new_cache(tiny):
    jp, tp = tiny
    engine = _engine(tp, decode_steps=4)
    old = engine._program
    engine._reset_device_state()
    assert engine._program is not old
    assert engine._program.cache.k.data_ptr() == engine._cache.k.data_ptr()
    engine.start()
    try:
        assert engine.generate([5, 9, 2], 6).tolist() == _ref(jp, [5, 9, 2], 6)
    finally:
        engine.shutdown()


# -- window buckets -------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [64, 96, 100, 768, 1024, 3000, 4096])
def test_window_buckets_match_the_reference_exhaustively(capacity):
    assert TG.decode_window_buckets(capacity) == JG.decode_window_buckets(capacity)
    buckets = set(TG.decode_window_buckets(capacity))
    for n in range(0, capacity + 1):
        w = TG.decode_window_bucket(n, capacity)
        assert w == JG.decode_window_bucket(n, capacity), n
        for k in (2, 4, 8, 16):
            assert TG.decode_window_bucket(min(n + k - 1, capacity), capacity) in buckets


# -- the serving surface ------------------------------------------------------------------


def _args(*extra):
    return tapp.build_arg_parser().parse_args(["--model-uri", "x", *extra])


def test_decode_steps_flag_reaches_the_engine():
    conf = tapp.config_from_args(_args("--decode-steps", "4", "--device", "cpu"))
    assert conf.decode_steps == 4
    assert tapp.config_from_args(_args()).decode_steps == 1
    pred = TR._build_llama(T.init(torch.Generator().manual_seed(3), TCFG), TCFG,
                           dtype=torch.float32)
    engine = tapp.make_gen_engine(pred, conf, tapp.ServerMetrics("d", "v1", "ns"))
    assert engine._decode_steps == 4 and engine._fused


@pytest.mark.parametrize("steps", [0, -1, 17])
def test_bad_decode_steps_are_refused_as_the_reference_refuses_them(steps):
    from tpumlops.utils.config import TpuSpec

    with pytest.raises(ValueError) as ref:
        TpuSpec.from_spec({"decodeSteps": steps})
    with pytest.raises(ValueError) as port:
        tapp.config_from_args(_args("--decode-steps", str(steps)))
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError) as cr:
        tapp.ServerConfig(decode_steps=steps)
    assert str(cr.value) == str(ref.value)


def test_a_served_burst_shows_on_metrics():
    cfg = T.LlamaConfig.tiny(max_seq=64)
    pred = TR._build_llama(T.init(torch.Generator().manual_seed(3), cfg), cfg,
                           dtype=torch.float32)
    conf = tapp.ServerConfig(model_name="tiny", host="127.0.0.1", port=0, device="cpu",
                             decode_steps=4)
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
    engine = srv.engine
    fused = engine.dispatches_total["multistep"]
    assert fused == 3  # 12 decoded tokens, 4 a dispatch

    def value(name, **labels):
        total = 0.0
        for line in text.splitlines():
            if line.startswith(name + "{") and all(f'{k}="{v}"' in line
                                                     for k, v in labels.items()):
                total += float(line.rsplit(" ", 1)[1])
        return total

    assert value("tpumlops_engine_dispatches_total", op="multistep") == fused
    assert value("tpumlops_itl_seconds_count") == 12
    assert value("tpumlops_itl_seconds_sum") > 0.0
