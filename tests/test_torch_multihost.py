"""The port's multihost unit against the JAX package's
(``tests/test_multihost.py``'s cases).

A unit of N "ranks" runs in one process over ``LocalGroupTransport``
(threads as ranks): lockstep, a leader hammered from several threads, the
roles refused both ways, predict after shutdown, a follower surviving a
model error; generation engines (no mesh, so every rank holds the whole
model) in lockstep with state parity, interleaved with predict, the
``OP_GEN_RESET`` broadcast after the leader fails, chunked prefill.  The
wire form is the reference's: ``encode_message`` bytes equal, op names and
the length type.  A follower's failed generation op ends its loop.  Last,
``TorchDistTransport`` in a 2-process gloo world: payloads of every size,
and a follower that waits in the control channel past the model groups'
timeout and still takes the next op.
"""

import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world as W
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models.registry import (
    Predictor,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    multihost as TM,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.engine import (
    InferenceEngine,
)
from tpumlops.models import llama as J
from tpumlops.server import multihost as JM


def _engine(predict=lambda x: x * 2.0):
    return InferenceEngine(
        Predictor(name="double", predict=predict,
                  example_input=lambda b: np.zeros((b, 3), np.float32)),
        max_batch_size=4,
    )


def _unit(n):
    group = TM._LocalGroup(n)
    transports = group.transports()
    leader = TM.MultihostEngine(_engine(), transports[0])
    results = [None] * (n - 1)
    threads = []
    for i, t in enumerate(transports[1:]):
        def run(i=i, t=t):
            results[i] = TM.follower_loop(_engine(), t)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        threads.append(th)
    return leader, results, threads


def _join(threads):
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()


def test_followers_execute_in_lockstep():
    leader, results, threads = _unit(3)
    x = np.ones((2, 3), np.float32)
    np.testing.assert_allclose(np.asarray(leader.predict({"x": x})), x * 2.0)
    leader.predict({"x": x})
    leader.shutdown()
    _join(threads)
    assert results == [2, 2]


def test_warmup_broadcasts_every_bucket():
    leader, results, threads = _unit(2)
    leader.warmup()
    leader.shutdown()
    _join(threads)
    assert results[0] == 3  # buckets 1, 2, 4 for max_batch_size 4


def test_leader_concurrency_does_not_desync():
    leader, results, threads = _unit(2)
    errors = []

    def hammer():
        try:
            for _ in range(10):
                leader.predict({"x": np.ones((1, 3), np.float32)})
        except Exception as e:  # pragma: no cover - the failure the test looks for
            errors.append(e)

    hammers = [threading.Thread(target=hammer) for _ in range(4)]
    for h in hammers:
        h.start()
    _join(hammers)
    leader.shutdown()
    _join(threads)
    assert not errors and results[0] == 40


def test_follower_refuses_leader_role_and_vice_versa():
    leader_t, follower_t = TM._LocalGroup(2).transports()
    with pytest.raises(ValueError):
        TM.MultihostEngine(_engine(), follower_t)
    with pytest.raises(ValueError):
        TM.follower_loop(_engine(), leader_t)


@pytest.mark.parametrize("op,inputs", [
    ("predict", {"a": np.arange(6, dtype=np.int32).reshape(2, 3)}),
    ("shutdown", None),
    ("gen_step", {"active": np.array([True, False]), "window": 16, "sampling": False}),
    ("gen_admit", {"ids": np.zeros((1, 16), np.int32), "slot": 1, "length": 3,
                   "key_data": np.array([0, 7], np.uint32), "temp": 0.8, "tk": 5, "tp": 0.9}),
    ("gen_multistep", {"window": 24, "sampling": True, "active": np.ones(4, bool),
                       "remaining": np.full(4, 3, np.int32), "eos_ids": np.full(4, -1, np.int32)}),
    ("gen_reset", {}),
])
def test_message_round_trip_and_bytes_equal_the_reference(op, inputs):
    raw = TM.encode_message(op, inputs)
    assert raw == JM.encode_message(op, inputs)
    got_op, got = TM.decode_message(raw)
    assert got_op == op
    if inputs is None:
        assert got is None
    else:
        assert pickle.dumps(got) == pickle.dumps(inputs)


def test_op_names_and_the_length_type_are_the_reference_ones():
    ref = {k: v for k, v in vars(JM).items() if k.startswith("OP_")}
    port = {k: v for k, v in vars(TM).items() if k.startswith("OP_")}
    assert {k: port[k] for k in ref} == ref
    # the port's own: gathered reads, and the warm-pool unit's attach,
    # detach and rank reports
    assert set(port) - set(ref) == {"OP_GEN_READ", "OP_ATTACH", "OP_DETACH", "OP_REPORT"}
    assert TM._LEN_DTYPE is JM._LEN_DTYPE


def test_predict_after_shutdown_raises():
    leader, _, threads = _unit(2)
    leader.shutdown()
    _join(threads)
    with pytest.raises(RuntimeError, match="shut down"):
        leader.predict({"x": np.ones((1, 3), np.float32)})
    leader.shutdown()  # idempotent


def test_follower_survives_model_error():
    leader_t, follower_t = TM._LocalGroup(2).transports()

    def bad_predict(x):
        raise ValueError("bad input")

    result = {}
    th = threading.Thread(target=lambda: result.update(
        n=TM.follower_loop(_engine(bad_predict), follower_t)), daemon=True)
    th.start()
    leader = TM.MultihostEngine(_engine(), leader_t)
    leader.predict({"x": np.ones((1, 3), np.float32)})
    leader.predict({"x": np.ones((1, 3), np.float32)})
    leader.shutdown()
    _join([th])
    assert result["n"] == 2


class _Scripted:
    """A follower's transport that hands out a fixed list of messages."""

    is_leader = False

    def __init__(self, messages):
        self._messages = list(messages)

    def broadcast(self, payload):
        return self._messages.pop(0)


class _FailingGen:
    def replay_step(self, **kw):
        raise RuntimeError("injected replay failure")

    def replay_sp_prefill(self, **kw):
        raise RuntimeError("injected sp replay failure")


def test_a_follower_gen_failure_ends_its_loop():
    """Generation is stateful: a rank that failed an op the leader ran
    leaves the loop (its process, and so the unit, goes down)."""
    msgs = [TM.encode_message(TM.OP_GEN_STEP, {"active": np.ones(1, bool), "window": 16,
                                               "sampling": False}),
            TM.encode_message(TM.OP_SHUTDOWN)]
    stats = {}
    with pytest.raises(RuntimeError, match="injected"):
        TM.follower_loop(None, _Scripted(msgs), gen_engine=_FailingGen(), stats=stats)
    # The ring prefill replays like every other generation op.
    with pytest.raises(RuntimeError, match="injected sp replay"):
        TM.follower_loop(None, _Scripted([TM.encode_message(TM.OP_GEN_SP_PREFILL, {})]),
                         gen_engine=_FailingGen())
    with pytest.raises(RuntimeError, match="without a gen engine"):
        TM.follower_loop(None, _Scripted(msgs[:1]))
    assert stats["gen_step"][0] == 1  # the failed op's wall is still noted


# -- generation engines in lockstep (threads as ranks) ----------------------------


PROMPTS = (([5, 9, 2], 6), (list(range(2, 23)), 5))


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny Llama in f64, and the tokens of the port's
    engine without a channel (``test_torch_generation.py`` holds that engine
    to the JAX engine token for token)."""
    jax.config.update("jax_enable_x64", True)
    try:
        jp = jax.device_get(J.init(jax.random.key(0), J.LlamaConfig.tiny(max_seq=64),
                                   dtype=jnp.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
    tcfg = T.LlamaConfig.tiny(max_seq=64)
    params = convert.from_jax_numpy(jp)
    engine = TG.GenerationEngine(params, tcfg, max_slots=2, dtype=torch.float64, device="cpu")
    engine.start(warmup=False)
    try:
        refs = {tuple(p): engine.generate(p, n).tolist() for p, n in PROMPTS}
    finally:
        engine.shutdown()
    return tcfg, params, refs


def _gen_unit(tcfg, params, max_slots=2, **kw):
    transports = TM._LocalGroup(2).transports()
    channel = TM.UnitChannel(transports[0])
    leader = TG.GenerationEngine(params, tcfg, max_slots=max_slots, dtype=torch.float64,
                                 device="cpu", channel=channel, **kw)
    follower = TG.GenerationEngine(params, tcfg, max_slots=max_slots, dtype=torch.float64,
                                   device="cpu", **kw)
    result = {}
    th = threading.Thread(target=lambda: result.update(
        steps=TM.follower_loop(_engine(), transports[1], gen_engine=follower)), daemon=True)
    th.start()
    return leader, follower, channel, result, th


def _assert_state_equal(a, b):
    for x, y in ((a._tokens, b._tokens), (a._cache.lengths, b._cache.lengths),
                 (a._keys, b._keys), (a._cache.k, b._cache.k), (a._cache.v, b._cache.v)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw,prompt,n", [({}, [5, 9, 2], 6),
                                         ({"prefill_chunk": 8}, list(range(2, 23)), 5)],
                         ids=["whole", "chunked"])
def test_generation_lockstep_and_state_parity(tiny, kw, prompt, n):
    tcfg, params, refs = tiny
    leader, follower, channel, result, th = _gen_unit(tcfg, params, **kw)
    leader.start(warmup=False)
    try:
        out = leader.generate(prompt, n).tolist()
        sampled = leader.generate([7, 1], 5, temperature=0.9, top_k=4, seed=11).tolist()
    finally:
        leader.shutdown()
        channel.close_with(TM.encode_message(TM.OP_SHUTDOWN))
    _join([th])
    assert out == refs[tuple(prompt)] and len(sampled) == 5
    assert result["steps"] > 0
    assert sum(c for c, _, _ in leader.op_stats.values()) == result["steps"]
    _assert_state_equal(leader, follower)


def test_generation_interleaved_with_predict(tiny):
    tcfg, params, _ = tiny
    transports = TM._LocalGroup(2).transports()
    unit = TM.MultihostEngine(_engine(), transports[0])
    gen = TG.GenerationEngine(params, tcfg, max_slots=2, dtype=torch.float64, device="cpu",
                              channel=unit.channel)
    follower = TG.GenerationEngine(params, tcfg, max_slots=2, dtype=torch.float64,
                                   device="cpu")
    result = {}
    th = threading.Thread(target=lambda: result.update(
        steps=TM.follower_loop(_engine(), transports[1], gen_engine=follower)), daemon=True)
    th.start()
    gen.start(warmup=False)
    try:
        x = np.ones((2, 3), np.float32)
        np.testing.assert_allclose(np.asarray(unit.predict({"x": x})), x * 2.0)
        assert gen.generate([5, 9, 2], 4).shape == (4,)
    finally:
        gen.shutdown()
        unit.shutdown()  # closes the shared channel
    _join([th])
    assert result["steps"] >= 3  # 1 predict + admit + decode ticks
    _assert_state_equal(gen, follower)


def test_gen_reset_broadcast_on_leader_failure(tiny):
    """A failed op on the leader broadcasts OP_GEN_RESET: the follower drops
    to the same fresh state, and the next request works on both."""
    tcfg, params, refs = tiny
    leader, follower, channel, result, th = _gen_unit(tcfg, params)
    leader.start(warmup=False)
    try:
        assert leader.generate([5, 9, 2], 3).shape == (3,)
        real = leader._device_step

        def bomb(*a, **kw):
            raise RuntimeError("injected")

        leader._device_step = bomb
        with pytest.raises(RuntimeError):
            leader.generate([7, 1], 4, timeout=30)
        leader._device_step = real
        assert leader.generate([5, 9, 2], 6).tolist() == refs[(5, 9, 2)]
        assert leader.op_stats["gen_reset"][0] == 1
    finally:
        leader.shutdown()
        channel.close_with(TM.encode_message(TM.OP_SHUTDOWN))
    _join([th])
    _assert_state_equal(leader, follower)


def test_preemption_restore_is_replayed(tiny):
    """A best-effort stream evicted for an interactive request on a
    one-slot unit: the restore's seed and state rows are ops the follower
    repeats, the tokens are the plain engine's and both ranks end equal."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.prefix_cache import (  # noqa: E501
        PrefixCacheConfig,
    )

    tcfg, params, _ = tiny
    kw = dict(prefill_chunk=8, preemption=True,
              prefix_cache=PrefixCacheConfig(enabled=True, budget_bytes=1 << 22, chunk_tokens=8))
    be_prompt, ia_prompt = list(range(2, 14)), [30, 31, 32]
    plain = TG.GenerationEngine(params, tcfg, max_slots=1, dtype=torch.float64, device="cpu")
    plain.start(warmup=False)
    try:
        want = [plain.generate(be_prompt, 10).tolist(), plain.generate(ia_prompt, 3).tolist()]
    finally:
        plain.shutdown()
    leader, follower, channel, _, th = _gen_unit(tcfg, params, max_slots=1, **kw)
    ia = []

    def on_tok(_t, seen=[0]):
        seen[0] += 1
        if seen[0] == 4:  # on the scheduler thread, at the stream's 4th token
            ia.append(leader.submit(ia_prompt, 3, slo_class="interactive"))

    be = leader.submit(be_prompt, 10, slo_class="best-effort", on_token=on_tok)
    leader.start(warmup=False)
    try:
        got = [be.result(timeout=60).tolist(), ia[0].result(timeout=60).tolist()]
    finally:
        leader.shutdown()
        channel.close_with(TM.encode_message(TM.OP_SHUTDOWN))
    _join([th])
    assert got == want
    assert leader.preemptions == 1 and leader.preempt_restores == 1
    assert leader.op_stats["gen_restore"][0] == 1 and leader.op_stats["gen_seed_slot"][0] >= 1
    _assert_state_equal(leader, follower)


# -- TorchDistTransport in a gloo world ------------------------------------------


def test_torch_dist_transport_in_a_gloo_world():
    """Payloads of 0 B to 1 MiB arrive whole; a follower waits 1.6 s in the
    control channel, past the model groups' 0.8 s timeout, and still takes
    the next op; the model group's own broadcast does time out."""
    leader, follower = W.run(W.transport_case, 2, 1.6, timeout=90, group_timeout=0.8)
    assert leader["equal"] and follower["equal"]
    assert leader["leader"] and not follower["leader"]
    assert follower["late"] == ("gen_step", {"window": 16}) == leader["late"]
    assert follower["waited_s"] > 1.2
    assert follower["model_group_timed_out"] is True
