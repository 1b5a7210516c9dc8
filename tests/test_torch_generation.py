"""The port's GenerationEngine against the JAX package, in float64 on CPU.

Scenarios are those of ``tests/test_generation.py`` (five prompts, three
slots, so slots are reused).  References:

- dense cache: JAX ``llama.generate_greedy`` per prompt, and for int8
  weights on the dense cache (``quantize: int8`` without int8kv) the JAX
  ``GenerationEngine`` on the same tree, whole-prompt and chunked;
- int8 KV cache: JAX ``prefill`` + ``insert_sequence`` + ``decode_ragged``
  stepped per token, with the decode attention through the Pallas kernel
  (interpret mode) and through the XLA chain;

and JAX ``GenerationEngine``s (no warmup) for the EOS behaviour and for
seeded sampling.  Greedy tokens must be equal, and so must seeded sampled
tokens: the port draws from the reference's threefry streams with its key
discipline (``key(seed)``, one split at admission and one a sampling
tick), so a seeded request replays the reference token for token, alone,
beside other requests and through chunked prefill.
"""

import time

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
    sampling as TS,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models.quantization import (
    quantize_llama as t_quantize_llama,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from tpumlops.models import llama as J
from tpumlops.models import sampling as JS
from tpumlops.models.quantization import quantize_llama as j_quantize_llama
from tpumlops.server.generation import GenerationEngine as JaxEngine

PROMPTS = [
    ([5, 9, 2], 6),
    ([7, 1, 4, 8, 3], 9),
    ([42], 4),
    ([10, 20, 30, 40, 50, 60, 70], 5),
    ([2, 3], 7),  # 5 requests > 3 slots: forces slot reuse
]


def _keys(seeds) -> torch.Tensor:
    """A batch of keys ``[B, 2]``, one a seed."""
    return torch.stack([TP.key(s) for s in seeds])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads; one thread keeps
    this module from crowding tests that run beside it."""
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
    cfg = J.LlamaConfig.tiny(max_seq=64)
    jp = J.init(jax.random.key(0), cfg, dtype=jnp.float64)
    tp = convert.from_jax_numpy(jax.device_get(jp))
    return cfg, T.LlamaConfig.tiny(max_seq=64), jp, tp


@pytest.fixture(scope="module")
def dense_refs(tiny):
    cfg, _, jp, _ = tiny
    gen = jax.jit(J.generate_greedy, static_argnums=(2, 3), static_argnames=("dtype",))
    return [
        np.asarray(gen(jp, jnp.asarray([p], jnp.int32), n, cfg, dtype=jnp.float64))[0].tolist()
        for p, n in PROMPTS
    ]


def _int8kv_refs(cfg, jpq, impl):
    """Greedy tokens per prompt through the reference's int8 KV path: a
    bucket-padded prefill inserted into a capacity-64 quant cache, then
    single-token ``decode_ragged`` steps."""
    prefill = jax.jit(J.prefill, static_argnums=(2,), static_argnames=("dtype",))

    def step(*a, **kw):
        prev = J._DECODE_ATTN
        try:
            J._DECODE_ATTN = impl
            return J.decode_ragged(*a, **kw)
        finally:
            J._DECODE_ATTN = prev

    decode = jax.jit(step, static_argnums=(3,), static_argnames=("dtype", "window"))
    insert = jax.jit(J.insert_sequence)
    refs = []
    for prompt, n in PROMPTS:
        ids = np.zeros((1, 16), np.int32)
        ids[0, : len(prompt)] = prompt
        logits, seq = prefill(jpq, jnp.asarray(ids), cfg, dtype=jnp.float64)
        cache = insert(J.QuantRaggedKVCache.create(cfg, 1), seq, jnp.int32(0),
                       jnp.int32(len(prompt)))
        tok = int(jnp.argmax(logits[0, len(prompt) - 1]))
        out = [tok]
        while len(out) < n:
            lg, cache = decode(jpq, jnp.asarray([[tok]], jnp.int32), cache, cfg,
                               dtype=jnp.float64, window=64)
            tok = int(jnp.argmax(lg[0, -1]))
            out.append(tok)
        refs.append(out)
    return refs


@pytest.fixture(scope="module")
def int8kv(tiny):
    cfg, tcfg, jp, _ = tiny
    jpq = j_quantize_llama(jp)
    tpq = convert.from_jax_numpy(jax.device_get(jpq))
    refs = {impl: _int8kv_refs(cfg, jpq, impl) for impl in ("pallas", "xla")}
    return tcfg, tpq, refs


def _run_engine(tp, tcfg, **kw):
    engine = TG.GenerationEngine(tp, tcfg, max_slots=3, dtype=torch.float64,
                                 device="cpu", **kw)
    engine.start()
    try:
        futs = [engine.submit(p, n) for p, n in PROMPTS]
        outs = [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()
    return outs, engine


@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunked"])
def test_engine_dense_matches_generate_greedy(tiny, dense_refs, chunk):
    _, tcfg, _, tp = tiny
    outs, engine = _run_engine(tp, tcfg, prefill_chunk=chunk)
    assert outs == dense_refs
    assert engine.tokens_generated == sum(n for _, n in PROMPTS)
    assert engine.dispatches_total["decode"] == engine.decode_forwards > 0


@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunked"])
def test_engine_int8kv_matches_stepped_reference(int8kv, chunk):
    tcfg, tpq, refs = int8kv
    outs, _ = _run_engine(tpq, tcfg, kv_quant=True, prefill_chunk=chunk)
    assert outs == refs["pallas"]
    assert outs == refs["xla"]


@pytest.fixture(scope="module")
def int8_dense_refs(tiny):
    """The JAX engine's greedy tokens for PROMPTS with int8 weights on the
    dense cache (no kv_quant), per prefill mode (three slots)."""
    cfg, _, jp, _ = tiny
    jpq = j_quantize_llama(jp)
    refs = {}
    for chunk in (None, 8):
        engine = JaxEngine(jpq, cfg, max_slots=3, dtype=jnp.float64, prefill_chunk=chunk)
        engine.start(warmup=False)
        try:
            futs = [engine.submit(p, n) for p, n in PROMPTS]
            refs[chunk] = [f.result(timeout=120).tolist() for f in futs]
        finally:
            engine.shutdown()
    return convert.from_jax_numpy(jax.device_get(jpq)), refs


@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunked"])
def test_engine_int8_weights_dense_cache_matches_the_jax_engine(tiny, int8_dense_refs, chunk):
    """``quantize: int8`` without int8kv: int8 weights, the dense cache,
    prefill through flash attention (chunks at their cache offsets) and
    decode through the dense window, token for token against the JAX
    engine in f64."""
    _, tcfg, _, _ = tiny
    tpq, refs = int8_dense_refs
    outs, engine = _run_engine(tpq, tcfg, prefill_chunk=chunk)
    assert isinstance(engine._cache, T.RaggedKVCache)
    assert outs == refs[chunk]
    assert engine.dispatches_total["decode"] == engine.decode_forwards > 0


def test_port_int8_quantizer_serves_the_same_tokens(tiny, int8kv):
    """The port's own quantize_llama (not the converted reference tree)."""
    _, tcfg, _, tp = tiny
    _, _, refs = int8kv
    outs, _ = _run_engine(t_quantize_llama(tp), tcfg, kv_quant=True)
    assert outs == refs["pallas"]


@pytest.fixture(scope="module")
def jax_engine(tiny):
    """The one JAX engine of this module (no warmup: compiles lazily)."""
    cfg, _, jp, _ = tiny
    engine = JaxEngine(jp, cfg, max_slots=2, dtype=jnp.float64)
    engine.start(warmup=False)
    yield engine
    engine.shutdown()


def test_engine_eos_and_budget_match_jax_engine(tiny, dense_refs, jax_engine):
    _, tcfg, _, tp = tiny
    eos = dense_refs[0][2]  # stop after the 3rd token
    ref = jax_engine.generate([5, 9, 2], 8, eos_id=eos).tolist()
    engine = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu")
    engine.start()
    try:
        out = engine.generate([5, 9, 2], 8, eos_id=eos).tolist()
        budget = engine.generate([5, 9, 2], 2).tolist()
    finally:
        engine.shutdown()
    assert out == ref == dense_refs[0][:3]
    assert budget == dense_refs[0][:2]


@pytest.mark.parametrize("args,kw", [
    ((list(range(60)), 10), {}),                          # past capacity
    (([], 4), {}),                                        # empty prompt
    (([1, 2], 0), {}),                                    # no new tokens
    (([1, 256], 2), {}),                                  # id outside the vocab
    (([1, 2], 2), {"temperature": 1.0, "top_p": 0.0}),
    (([1, 2], 2), {"temperature": -1.0}),
    (([1, 2], 2), {"top_k": -1}),
    (([1, 2], 2), {"seed": -1}),
])
def test_engine_rejects_like_the_reference(tiny, jax_engine, args, kw):
    _, tcfg, _, tp = tiny
    engine = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_engine.validate(*args, **kw)
    with pytest.raises(ValueError) as got:
        engine.submit(*args, **kw)
    assert str(got.value) == str(ref.value)


def test_engine_shutdown_fails_queued_with_engine_shutdown(tiny):
    _, tcfg, _, tp = tiny
    engine = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu")
    fut = engine.submit([1, 2, 3], 4)  # never started: stays queued
    engine.shutdown()
    with pytest.raises(TG.EngineShutdown, match="before admission"):
        fut.result(timeout=5)


def test_engine_recovers_after_failed_step(tiny, dense_refs):
    _, tcfg, _, tp = tiny
    engine = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu")
    engine.start()
    try:
        assert engine.generate([5, 9, 2], 6).tolist() == dense_refs[0]
        real = engine._device_step

        def bomb(*a, **kw):
            raise RuntimeError("injected failure")

        engine._device_step = bomb
        with pytest.raises(RuntimeError):
            engine.submit([7, 1, 4], 5).result(timeout=30)
        engine._device_step = real
        assert engine.generate([5, 9, 2], 6).tolist() == dense_refs[0]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("option,value", [
    ("mesh_shape", {"sp": 3}),
    ("mesh_shape", {"tp": 2, "sp": 32}),
])
def test_unported_engine_options_raise(tiny, option, value):
    """An sp degree the ring cannot split every prompt bucket over (not a
    power of two, or past the smallest bucket) is refused at construction,
    before any world or device state is needed."""
    _, tcfg, _, tp = tiny
    with pytest.raises(ValueError, match="must be a power of two"):
        TG.GenerationEngine(tp, tcfg, device="cpu", **{option: value})


@pytest.mark.parametrize("option", ["watchdog", "telemetry", "recorder"])
def test_observability_options_serve_the_reference_tokens(tiny, dense_refs, option):
    """The watchdog, device telemetry and the flight recorder are accepted
    (they raised before they were ported): an engine with one of them on
    answers the reference's greedy tokens, and the option saw the run."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.device_telemetry import (
        DeviceTelemetry,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.flight_recorder import (
        FlightRecorder,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.watchdog import (
        EngineWatchdog,
    )

    _, tcfg, _, tp = tiny
    exits = []
    value = {"watchdog": lambda: EngineWatchdog(deadline_s=30.0, on_exit=lambda: exits.append(1)),
             "telemetry": DeviceTelemetry,
             "recorder": lambda: FlightRecorder(256)}[option]()
    outs, engine = _run_engine(tp, tcfg, **{option: value})
    assert outs == dense_refs
    dispatches = sum(engine.dispatches_total.values())
    if option == "watchdog":
        assert value.stalls_total == 0 and not exits
        assert value._thread is None and not value._armed  # stopped at shutdown
        assert value.slot_inventory == engine._slot_inventory
    elif option == "telemetry":
        assert set(value.last_util) == {"prefill", "decode"}
        for util in value.last_util.values():
            assert 0.0 < util["hbm_bw_util"] <= 1.0 and 0.0 < util["mfu"] <= 1.0
        assert value.ledger.components["kv_cache"] == 3 * value.ledger.kv_bytes_per_row
    else:
        assert value.ticks_recorded == dispatches
        assert value.traces_recorded == 0  # no request carried a trace


def test_entry_points_need_a_card_or_an_explicit_cpu(tiny, monkeypatch):
    _, tcfg, _, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.GenerationEngine(tp, tcfg)
    TG.GenerationEngine(tp, tcfg, device="cpu")  # explicit CPU is fine


def test_sampled_tokens_stay_in_the_reference_kept_set():
    rng = np.random.default_rng(0)
    B, V = 6, 64
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1  # a tie at the top
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 12, 3, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.9, 1.0, 0.5], np.float32)
    # The reference's kept set, from its own sort and masks.
    scaled = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temp), 1e-6)[:, None]
    order = np.asarray(jnp.argsort(-scaled, axis=-1))
    sorted_l = np.take_along_axis(np.asarray(scaled), order, axis=-1)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(sorted_l), axis=-1))
    keep = (np.arange(V)[None] < np.where(top_k <= 0, V, top_k)[:, None]) & (
        (np.cumsum(probs, -1) - probs) < top_p[:, None])
    kept = [set(order[i][keep[i]].tolist()) for i in range(B)]
    args = (torch.from_numpy(temp), torch.from_numpy(top_k), torch.from_numpy(top_p))
    seen = [set() for _ in range(B)]
    for seed in range(60):
        keys = _keys([seed * B + i for i in range(B)])
        toks = TS.sample_logits(torch.from_numpy(logits), keys, *args).tolist()
        for i, t in enumerate(toks):
            assert t in kept[i], (i, t)
            seen[i].add(t)
    # greedy row: the first index of the max, as the reference's argmax
    greedy = int(JS.sample_logits(jnp.asarray(logits), jax.random.split(jax.random.key(0), B),
                                  jnp.asarray(temp), jnp.asarray(top_k),
                                  jnp.asarray(top_p))[0])
    assert seen[0] == {greedy}
    assert len(seen[2]) > 1  # row 2 really samples
    again = TS.sample_logits(torch.from_numpy(logits), _keys(range(B)), *args)
    first = TS.sample_logits(torch.from_numpy(logits), _keys(range(B)), *args)
    assert again.tolist() == first.tolist()


SAMPLED = [
    ([5, 9, 2], 12, dict(temperature=0.9, top_k=20, top_p=0.95, seed=7)),
    ([7, 1, 4, 8, 3], 10, dict(temperature=1.3, top_p=0.8, seed=2**32 + 5)),
    ([42], 9, {}),  # a greedy neighbour
    ([10, 20, 30, 40, 50, 60, 70, 1, 2, 3], 8, dict(temperature=0.7, seed=123)),
    ([2, 3], 11, dict(temperature=1.0, top_k=5, seed=0)),
]


def _as_served(kw: dict) -> dict:
    """A request's options as a JAX replica reads them.  It serves with
    64-bit integers disabled, where ``jax.random.key`` keeps a seed's low
    32 bits; this module runs JAX with them enabled for f64, so the JAX
    engine gets the seed reduced as its serving configuration reduces it
    (``test_torch_prng.py`` holds ``key(seed)`` against that rule for the
    same seed)."""
    return {**kw, "seed": kw["seed"] % 2**32} if "seed" in kw else kw


@pytest.fixture(scope="module")
def sampled_refs(tiny):
    """The JAX engine's tokens for SAMPLED, per prefill mode: the first
    request alone, then all five submitted together (three slots)."""
    cfg, _, jp, _ = tiny
    refs = {}
    for chunk in (None, 8):
        engine = JaxEngine(jp, cfg, max_slots=3, dtype=jnp.float64, prefill_chunk=chunk)
        engine.start(warmup=False)
        try:
            p, n, kw = SAMPLED[0]
            alone = engine.submit(p, n, **_as_served(kw)).result(timeout=120).tolist()
            futs = [engine.submit(p, n, **_as_served(kw)) for p, n, kw in SAMPLED]
            refs[chunk] = {"single": [alone],
                           "several": [f.result(timeout=120).tolist() for f in futs]}
        finally:
            engine.shutdown()
    return refs


@pytest.mark.parametrize("mode", ["single", "several"])
@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunked"])
def test_seeded_sampling_matches_the_jax_engine(tiny, sampled_refs, chunk, mode):
    _, tcfg, _, tp = tiny
    reqs = SAMPLED[:1] if mode == "single" else SAMPLED
    engine = TG.GenerationEngine(tp, tcfg, max_slots=3, dtype=torch.float64,
                                 device="cpu", prefill_chunk=chunk)
    engine.start()
    try:
        futs = [engine.submit(p, n, **kw) for p, n, kw in reqs]
        outs = [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()
    assert outs == sampled_refs[chunk][mode]


def test_unseeded_streams_differ_across_boots_and_repeat_within_one(tiny):
    """Unseeded requests draw from ``fold_in(boot_key, n)``: another boot
    (another boot key) draws another stream; the same boot with its
    counter rewound draws the same one."""
    _, tcfg, _, tp = tiny
    kw = dict(temperature=1.0)
    outs = []
    for _boot in range(2):
        engine = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64,
                                     device="cpu")
        engine.start()
        try:
            first = engine.generate([5, 9, 2], 16, **kw).tolist()
            second = engine.generate([5, 9, 2], 16, **kw).tolist()
            engine._seed_counter = 0
            replay = engine.generate([5, 9, 2], 16, **kw).tolist()
        finally:
            engine.shutdown()
        assert replay == first
        assert second != first  # the counter moves on within a boot
        outs.append(first)
    assert outs[0] != outs[1]


def test_admission_queue_budget_sheds_past_the_backlog(tiny):
    """The budget bounds queued-but-unadmitted estimated tokens: the
    request that would pass it sheds synchronously (nothing enqueued), an
    oversized request on an empty queue is admitted, and a drain sheds
    with its own reason while what was admitted finishes."""
    _, tcfg, _, tp = tiny
    sheds = []
    engine = TG.GenerationEngine(tp, tcfg, max_slots=1, dtype=torch.float64,
                                 device="cpu", admission_queue_budget=48,
                                 on_shed=sheds.append)
    with pytest.raises(ValueError, match="admission_queue_budget"):
        TG.GenerationEngine(tp, tcfg, device="cpu", admission_queue_budget=-1)
    f1 = engine.submit([5, 9, 2, 7], 20)  # not started: stays queued (est 24)
    f2 = engine.submit([5, 9, 2, 7], 20)  # 24 + 24 <= 48
    assert engine.inflight() == 2
    with pytest.raises(TG.EngineOverloaded) as err:
        engine.submit([5, 9, 2, 7], 10)  # 48 + 14 > 48
    assert err.value.reason == "budget" and err.value.retry_after_s >= 1
    assert engine._queue.qsize() == 2 and engine.shed_total == 1
    engine.start()
    try:
        assert f1.result(timeout=60).size == f2.result(timeout=60).size == 20
        # Empty queue: a request whose estimate alone passes the budget
        # (4 + 56 > 48) is admitted.
        assert engine.submit([5, 9, 2, 7], 56).result(timeout=60).size == 56
        slow = engine.submit([5, 9, 2, 7], 40)
        engine.begin_drain()
        with pytest.raises(TG.EngineOverloaded) as err:
            engine.submit([1], 2)
        assert err.value.reason == "draining"
        assert sheds == ["budget", "draining"]
        assert slow.result(timeout=60).size == 40  # admitted work finishes
        deadline = time.monotonic() + 10
        while not engine.drained() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.drained() and engine._queued_est_tokens == 0
        engine.cancel_drain()
        assert not engine.draining and engine.generate([5, 9, 2], 2).size == 2
    finally:
        engine.shutdown()


def test_admission_ledger_holds_under_concurrent_submits(tiny):
    """Many threads submitting at once (switch interval shortened): the
    queued estimate is exactly the admitted requests' and every submit is
    either queued or shed, none lost to a racing update."""
    import sys
    import threading

    _, tcfg, _, tp = tiny
    engine = TG.GenerationEngine(tp, tcfg, max_slots=1, dtype=torch.float64,
                                 device="cpu", admission_queue_budget=600)
    admitted, shed = [], []
    lock = threading.Lock()

    def worker(i):
        for j in range(20):
            n = 1 + (i + j) % 7
            try:
                engine.submit([5, 9], n)
            except TG.EngineOverloaded:
                with lock:
                    shed.append(n)
            else:
                with lock:
                    admitted.append(n)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(admitted) + len(shed) == 16 * 20 and shed
        assert engine._queued_est_tokens == sum(2 + n for n in admitted) <= 600
        assert engine.shed_total == len(shed)
        assert engine.inflight() == len(admitted)
    finally:
        sys.setswitchinterval(old)
        engine.shutdown()
    # Shutdown failed every queued future and returned its reservation.
    assert engine.inflight() == 0 and engine._queued_est_tokens == 0


def test_seeded_request_repeats_itself(tiny):
    _, tcfg, _, tp = tiny
    engine = TG.GenerationEngine(tp, tcfg, max_slots=3, dtype=torch.float64, device="cpu")
    engine.start()
    try:
        kw = dict(temperature=0.9, top_k=20, top_p=0.95)
        a = engine.submit([5, 9, 2], 12, seed=7, **kw)
        b = engine.submit([7, 1, 4], 12, **kw)  # a neighbour with its own stream
        c = engine.submit([5, 9, 2], 12, seed=7, **kw)
        d = engine.submit([5, 9, 2], 12, seed=8, **kw)
        ra, _, rc, rd = (f.result(timeout=60).tolist() for f in (a, b, c, d))
        assert ra == rc
        assert ra != rd
        assert all(0 <= t < tcfg.vocab_size for t in ra + rd)
    finally:
        engine.shutdown()
