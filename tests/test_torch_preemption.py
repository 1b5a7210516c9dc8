"""The port's SLO classes, per-model admission shares and mid-decode
preemption against the JAX package, on the CPU (tiny Llama, f64 unless a
test says otherwise).

- ``_dequeue``'s class order (FIFO within a class, an evicted record at the
  front of its class), ``reserve_admission``'s class factors and the
  per-model share ledger, each beside the JAX engine on the same calls;
  the refusals (preemption without the prefix cache, a bad class).
- The reference's cases of ``tests/test_preemption.py``: a preempted
  best-effort stream equals its uninterrupted run and JAX
  ``generate_greedy`` token for token, the interactive request that evicted
  it is untouched; the same for a seeded sampled stream (its clean run
  equals the JAX engine's), at ``decode_steps=4``, with speculation (4
  drafts), packed ``prefill_batch=2``, ``unified_step=True``, int8kv and
  through the L2 tier.  The port's preempted engine against the JAX one
  with ``preemption=True`` on the same trigger.
- The evict -> restore round trip of a cache row and the state rows against
  the JAX ``_read_slot`` / ``_seed_slot`` / ``_insert_restore`` composition,
  dense and int8, f64 and bf16: bit for bit.  In f64 it gives the row back
  exactly; on the int8 cache in bf16, with arbitrary scales, it does not, in
  either package (the per-head max ``bf16(127 * scale)`` need not give the
  scale back), but it does for the scales a bf16 engine writes (a bf16
  value over 127).
- The unified engine's state is still the super-step program's buffers
  after a restore (``data_ptr``).
- The serving surface: ``slo_class`` on ``/generate`` (a bad value a 400),
  a class shed's 429 body, ``tpumlops_engine_preempt_total`` after a served
  preemption, ``--slo-class`` / ``--preemption`` and their refusals with
  the reference's messages.

Every trigger is deterministic: the interactive request is submitted from
inside the best-effort stream's ``on_token`` at its N-th token, on the
scheduler thread, so the eviction point is fixed by construction.  The
reference's multi-host replay case waits for the port's multi-host item.
"""

import functools
import http.client
import json
import threading
import time
from types import SimpleNamespace

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
    registry as TR,
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
from tpumlops.server import generation as JG
from tpumlops.server import prefix_cache as jpc

JCFG = J.LlamaConfig.tiny(max_seq=64)
TCFG = T.LlamaConfig.tiny(max_seq=64)
BE_PROMPT = list(range(2, 14))
IA_PROMPT = list(range(30, 40))
OTHER = list(range(50, 60))
SEEDED = dict(temperature=1.0, seed=7)


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


def _ref(jp, prompt, n):
    return np.asarray(_jgen()(jp, jnp.asarray([prompt], jnp.int32), n, JCFG,
                              dtype=jnp.float64))[0].tolist()


def _pc(budget_bytes=1 << 22, mod=tpc, **kw):
    return mod.PrefixCacheConfig(enabled=True, budget_bytes=budget_bytes, chunk_tokens=8, **kw)


def _engine(tp, max_slots=1, **kw):
    kw.setdefault("prefix_cache", _pc())
    kw.setdefault("preemption", True)
    return TG.GenerationEngine(tp, TCFG, max_slots=max_slots, dtype=torch.float64,
                               device="cpu", **kw)


def _jengine(jp, max_slots=1, **kw):
    kw.setdefault("prefix_cache", _pc(mod=jpc))
    kw.setdefault("preemption", True)
    return JG.GenerationEngine(jp, JCFG, max_slots=max_slots, dtype=jnp.float64, **kw)


def _run_preempted(engine, n_be=20, trigger_at=4, n_ia=5, others=(), start=None,
                   **submit_kw):
    """A best-effort stream (and ``others``, best-effort too) fill the
    engine; at the stream's ``trigger_at``-th token its ``on_token``
    submits an interactive request, on the scheduler thread.  Returns
    (best-effort output, interactive output, other outputs)."""
    ia = []

    def on_tok(_t, seen=[0]):
        seen[0] += 1
        if seen[0] == trigger_at:
            ia.append(engine.submit(IA_PROMPT, n_ia, slo_class="interactive"))

    f_be = engine.submit(BE_PROMPT, n_be, on_token=on_tok, slo_class="best-effort",
                         **submit_kw)
    f_others = [engine.submit(p, n_be, slo_class="best-effort") for p in others]
    (start or engine.start)()
    try:
        out_be = np.asarray(f_be.result(timeout=120)).tolist()
        outs = [np.asarray(f.result(timeout=120)).tolist() for f in f_others]
        assert len(ia) == 1, "the trigger never fired"
        out_ia = np.asarray(ia[0].result(timeout=120)).tolist()
        return out_be, out_ia, outs
    finally:
        engine.shutdown()


def _run_clean(engine, n_be=20, prompts=(BE_PROMPT,), start=None, **submit_kw):
    futs = [engine.submit(p, n_be, **submit_kw) for p in prompts]
    (start or engine.start)()
    try:
        return [np.asarray(f.result(timeout=120)).tolist() for f in futs]
    finally:
        engine.shutdown()


def _no_lost_work(engine):
    assert engine.preemptions >= 1
    assert engine.preempt_restores == engine.preemptions
    assert engine.preempt_recomputed_tokens == 0
    assert engine.dispatches_total["preempt-evict"] == engine.preemptions
    assert engine.dispatches_total["preempt-restore"] == engine.preempt_restores


# -- the class queues and the admission ledger ------------------------------------


def _put_slot(engine, idx, slo_class, generated, prompt=BE_PROMPT):
    """An occupied slot as an admission leaves it (never started engine)."""
    engine._slots[idx] = TG._Slot(
        future=TG.Future(), remaining=10, eos_id=None, prompt_len=len(prompt),
        generated=list(generated), slo_class=slo_class,
        prompt=np.asarray(prompt, np.int32))


def test_dequeue_is_class_ordered_fifo_and_an_evicted_record_goes_first(tiny):
    _, tp = tiny
    engine = _engine(tp, max_slots=2)
    order = [("best-effort", 1), ("batch", 2), ("interactive", 3), ("batch", 4),
             ("interactive", 5), (None, 6)]  # None: the default class, interactive
    for c, n in order:
        engine.submit([n, 2, 3], 2, slo_class=c)
    got = []
    while engine._queued_work():
        got.append(int(engine._dequeue(False, 0.0).prompt[0]))
    assert got == [3, 5, 6, 2, 4, 1]
    # An eviction: the record goes to the FRONT of its class, before newer
    # work of the same class, and after every higher class.
    for n in (7, 8):
        engine.submit([n, 2, 3], 2, slo_class="best-effort")
    engine.submit([9, 2, 3], 2, slo_class="batch")
    _put_slot(engine, 0, "batch", [40, 41, 42])
    _put_slot(engine, 1, "best-effort", [43, 44])
    engine._drain_to_classes()
    engine._evict_slot(1)
    assert engine._slots[1] is None and engine._slots[0] is not None
    items = [engine._dequeue(False, 0.0) for _ in range(4)]
    assert [type(i).__name__ for i in items] == ["_Request", "_Preempted", "_Request",
                                                 "_Request"]
    assert int(items[0].prompt[0]) == 9
    rec = items[1]
    assert rec.hist == len(BE_PROMPT) + 2 - 1 and rec.generated == [43, 44]
    assert len(rec.chunks) == -(-rec.hist // 8)
    assert [int(i.prompt[0]) for i in items[2:]] == [7, 8]
    assert engine.preemptions == 1 and engine.dispatches_total == {"preempt-evict": 1}
    # Shutdown fails what waits in the deques: a request and a record.
    engine._class_queues["best-effort"].appendleft(rec)
    late = engine.submit([10, 2, 3], 2, slo_class="batch")
    engine._drain_to_classes()
    engine.shutdown()
    for fut in (rec.future, late):
        with pytest.raises(TG.EngineShutdown):
            fut.result(timeout=1)


def _ledger(engine, calls):
    """Each reservation's outcome: None (admitted) or (reason, class)."""
    out = []
    for kw in calls:
        try:
            engine.reserve_admission(**kw)
            out.append(None)
        except (TG.EngineOverloaded, JG.EngineOverloaded) as e:
            assert e.retry_after_s >= 1
            out.append((e.reason, e.slo_class))
    return out


CLASS_CALLS = [dict(est_tokens=10), dict(est_tokens=45, slo_class="best-effort"),
               dict(est_tokens=30, slo_class="best-effort"),
               dict(est_tokens=30, slo_class="batch"), dict(est_tokens=50, slo_class="batch"),
               dict(est_tokens=20, slo_class="interactive"),
               dict(est_tokens=90, slo_class="interactive")]


@pytest.mark.parametrize("default", [None, "batch"], ids=["preemption", "batch-default"])
def test_class_budget_factors_match_the_jax_engine(tiny, default):
    jp, tp = tiny
    kw = dict(admission_queue_budget=100, slo_class=default, preemption=default is None)
    port = _engine(tp, **kw)
    ref = _jengine(jp, **kw)
    got = _ledger(port, CLASS_CALLS)
    assert got == _ledger(ref, CLASS_CALLS)
    # best-effort sheds at half the budget: 10 queued + 45 > 50
    assert got[1] == ("class_best-effort", "best-effort")
    assert got == [None, ("class_best-effort", "best-effort"), None, None,
                   ("class_batch", "batch"), None, ("budget", "interactive")]
    assert port.shed_total == ref.shed_total == sum(x is not None for x in got)
    assert port._queued_est_tokens == ref._queued_est_tokens


def test_per_model_admission_shares_match_the_jax_engine(tiny):
    """The port's twin of the reference's
    ``test_per_model_admission_fairness_on_shared_replica``."""
    jp, tp = tiny
    port = TG.GenerationEngine(tp, TCFG, max_slots=1, dtype=torch.float64, device="cpu",
                               admission_queue_budget=80)
    ref = JG.GenerationEngine(jp, JCFG, max_slots=1, dtype=jnp.float64,
                              admission_queue_budget=80)
    for engine in (port, ref):
        engine.reserve_admission(60, model="hot")  # empty queue: admitted
        # The tail model's first request admits despite 60 queued + 30 > 80.
        engine.reserve_admission(30, model="tail")
        # The hot model is now bounded by budget / 2 = 40 < its 60.
        with pytest.raises((TG.EngineOverloaded, JG.EngineOverloaded)) as err:
            engine.reserve_admission(10, model="hot")
        assert err.value.reason == "model_budget" and err.value.retry_after_s >= 1
        assert err.value.slo_class is None
        with pytest.raises((TG.EngineOverloaded, JG.EngineOverloaded)) as err:
            engine.reserve_admission(30, model="tail")
        assert err.value.reason == "model_budget"
        assert engine.shed_total == 2
        engine.release_model_admission("tail", 30)
        engine.reserve_admission(5, model="tail")
        engine.release_model_admission("tail", 5)
        engine.release_model_admission("hot", 60)
        assert engine._model_est == {}
        engine.release_model_admission(None, 5)  # no model: nothing to return
    assert port._queued_est_tokens == ref._queued_est_tokens == 95


@pytest.mark.parametrize("kw,match", [
    (dict(preemption=True, prefix_cache=None), "preemption requires the radix prefix cache"),
    (dict(slo_class="gold", preemption=False), "slo_class must be one of"),
])
def test_bad_class_options_are_refused(tiny, kw, match):
    _, tp = tiny
    with pytest.raises(ValueError, match=match):
        _engine(tp, **kw)


def test_a_bad_submitted_class_is_refused_before_anything_is_reserved(tiny):
    _, tp = tiny
    engine = _engine(tp, admission_queue_budget=100)
    with pytest.raises(ValueError, match="slo_class must be one of"):
        engine.submit([1, 2, 3], 2, slo_class="gold")
    assert engine._queued_est_tokens == 0 and engine.inflight() == 0


def test_classes_off_keep_the_single_queue(tiny):
    _, tp = tiny
    engine = TG.GenerationEngine(tp, TCFG, max_slots=1, dtype=torch.float64, device="cpu")
    assert engine._class_queues is None and not engine._preemption
    engine.submit([1, 2, 3], 2, slo_class="best-effort")  # read only while armed
    req = engine._dequeue(False, 0.0)
    assert engine._queue.empty() and req.slo_class == "best-effort"
    assert engine._class_slot_state(req) == {}
    for name in ("slo_class", "preemption"):
        assert name not in TG._NOT_PORTED


def test_work_waiting_in_a_class_deque_ends_a_burst_and_keeps_the_gate_shut(tiny):
    """``_queued_work`` sees the class deques: a request drained out of the
    transport queue (or an evicted record) still ends a fused burst and
    keeps the next one from starting."""
    _, tp = tiny
    engine = _engine(tp, decode_steps=4)
    assert not engine._queued_work()
    engine.submit([1, 2, 3], 2, slo_class="batch")
    engine._drain_to_classes()
    assert engine._queue.empty() and engine._queued_work()
    engine._dequeue(False, 0.0)
    assert not engine._queued_work()


# -- no lost work -------------------------------------------------------------------


def test_preempt_greedy_no_lost_work(tiny):
    jp, tp = tiny
    engine = _engine(tp)
    out_be, out_ia, _ = _run_preempted(engine)
    _no_lost_work(engine)
    assert out_be == _ref(jp, BE_PROMPT, 20)
    assert out_ia == _ref(jp, IA_PROMPT, 5)
    assert engine.prefix_hits >= 1  # the restore seeded from the radix cache


def test_preempt_seeded_sampling_equals_the_clean_and_the_jax_run(tiny):
    jp, tp = tiny
    engine = _engine(tp)
    out_p, _, _ = _run_preempted(engine, **SEEDED)
    _no_lost_work(engine)
    clean = _run_clean(_engine(tp), **SEEDED)[0]
    jeng = _jengine(jp)
    want = _run_clean(jeng, start=lambda: jeng.start(warmup=False), **SEEDED)[0]
    assert out_p == clean == want


SPEC = tsp.SpeculativeConfig(enabled=True, draft_tokens=4)


@pytest.mark.parametrize("case", [
    "decode_steps", "speculative", "packed", "unified", "int8kv", "l2",
])
def test_preempted_streams_equal_their_clean_runs(tiny, case):
    """The invariant on every engine path: the preempted stream (greedy, and
    on K 4 and unified also a seeded one) equals its uninterrupted run,
    and the greedy one ``generate_greedy`` (int8kv: the JAX int8kv
    engine's run)."""
    jp, tp = tiny
    kw, others, run = {}, (), {}
    if case == "decode_steps":
        kw = dict(decode_steps=4)
    elif case == "speculative":
        kw = dict(speculative=SPEC)
    elif case == "packed":
        kw, others = dict(max_slots=2, prefill_batch=2), (OTHER,)
    elif case == "unified":
        kw, others = dict(max_slots=2, prefill_batch=2, unified_step=True,
                          decode_steps=4), (OTHER,)
    elif case == "int8kv":
        kw = dict(kv_quant=True)
    elif case == "l2":
        # A starved first tier: the evicted chunks spill into the L2 and the
        # restore promotes them back.
        kw = dict(prefix_cache=_pc(budget_bytes=9 * 1024, l2_budget_bytes=1 << 22))
        run = dict(n_be=24, trigger_at=10)
    n = run.get("n_be", 20)
    engine = _engine(tp, **kw)
    out_be, out_ia, outs = _run_preempted(engine, others=others, **run)
    _no_lost_work(engine)
    if case == "int8kv":
        jeng = _jengine(jp, kv_quant=True)
        want = _run_clean(jeng, n, start=lambda: jeng.start(warmup=False))[0]
        assert out_be == _run_clean(_engine(tp, **kw), n)[0] == want
    else:
        assert out_be == _ref(jp, BE_PROMPT, n)
        assert out_ia == _ref(jp, IA_PROMPT, 5)
    assert outs == [_ref(jp, p, n) for p in others]
    if case == "l2":
        assert engine._prefix_cache.l2_hits > 0
    if case in ("decode_steps", "unified"):
        engine = _engine(tp, **kw)
        sampled, _, _ = _run_preempted(engine, others=others, **SEEDED)
        _no_lost_work(engine)
        assert sampled == _run_clean(_engine(tp, **kw), prompts=(BE_PROMPT,),
                                     **SEEDED)[0]


def test_a_failed_restore_fails_its_own_request_and_recovers(tiny):
    """A restore that raises fails the evicted request's future and runs the
    recovery; the engine then serves the next request."""
    jp, tp = tiny
    engine = _engine(tp)

    def bomb(*_a):
        raise RuntimeError("injected restore failure")

    engine._device_restore = bomb
    ia = []

    def on_tok(_t, seen=[0]):
        seen[0] += 1
        if seen[0] == 4:
            ia.append(engine.submit(IA_PROMPT, 5, slo_class="interactive"))

    f_be = engine.submit(BE_PROMPT, 20, on_token=on_tok, slo_class="best-effort")
    engine.start()
    try:
        with pytest.raises(RuntimeError, match="injected restore failure"):
            f_be.result(timeout=120)
        assert ia[0].result(timeout=120).tolist() == _ref(jp, IA_PROMPT, 5)
        assert engine.preemptions == 1 and engine.preempt_restores == 0
        assert engine.generate(OTHER, 6).tolist() == _ref(jp, OTHER, 6)
    finally:
        engine.shutdown()


def test_the_preempted_engine_equals_the_jax_preempted_engine(tiny):
    """Both engines preempted on the same trigger: the same streams, the
    same evictions and restores."""
    jp, tp = tiny
    port = _engine(tp, decode_steps=4)
    got = _run_preempted(port, **SEEDED)
    jeng = _jengine(jp, decode_steps=4)
    want = _run_preempted(jeng, start=lambda: jeng.start(warmup=False), **SEEDED)
    assert got == want
    assert (port.preemptions, port.preempt_restores) == (jeng.preemptions,
                                                         jeng.preempt_restores)
    assert port.preempt_recomputed_tokens == jeng.preempt_recomputed_tokens == 0


# -- the round trip and the buffers -----------------------------------------------------


def _key_words(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_evict_restore_round_trip_equals_the_jax_composition(tiny, quant, dtype):
    """Slot 1 (hist 21: two whole chunks and a partial one) evicted, then
    restored into slot 0: the row over its chunks and the six state rows
    against the JAX ``_read_slot``, ``_seed_slot`` and ``_insert_restore``
    on the same values, bit for bit; against the snapshot, exact except on
    the int8 cache in bf16."""
    jp, tp = tiny
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    port = TG.GenerationEngine(tp, TCFG, max_slots=3, dtype=tdt, device="cpu", kv_quant=quant,
                               prefix_cache=_pc(), preemption=True)
    ref = JG.GenerationEngine(jp, JCFG, max_slots=3, dtype=jdt, kv_quant=quant,
                              prefix_cache=_pc(mod=jpc), preemption=True)
    rng = np.random.default_rng(3)
    shape = (JCFG.num_layers, 3, JCFG.num_kv_heads, JCFG.max_seq, JCFG.head_dim)
    cache = port._cache
    if quant:
        bufs = {}
        for name in ("k", "v"):
            x = torch.from_numpy(rng.standard_normal(shape) * 0.5)
            q8, sc = T._quant_kv(x)
            bufs[name] = (q8.numpy(), sc.numpy())
        cache.k8.copy_(torch.from_numpy(bufs["k"][0]))
        cache.k_scale.copy_(torch.from_numpy(bufs["k"][1]))
        cache.v8.copy_(torch.from_numpy(bufs["v"][0]))
        cache.v_scale.copy_(torch.from_numpy(bufs["v"][1]))
        jk = tuple(jnp.asarray(a) for a in bufs["k"])
        jv = tuple(jnp.asarray(a) for a in bufs["v"])
    else:
        k = torch.from_numpy(rng.standard_normal(shape)).to(tdt)
        v = torch.from_numpy(rng.standard_normal(shape)).to(tdt)
        cache.k.copy_(k)
        cache.v.copy_(v)
        jk = jnp.asarray(k.to(torch.float64).numpy()).astype(jdt)
        jv = jnp.asarray(v.to(torch.float64).numpy()).astype(jdt)
    keys = rng.integers(0, 2**32, (3, 2)).astype(np.int64)
    lengths = np.asarray([5, 21, 9], np.int32)
    toks = np.asarray([[3], [77], [4]], np.int64)
    temps = np.asarray([0.5, 0.8, 0.0], np.float32)
    tks = np.asarray([0, 50, 3], np.int32)
    tps = np.asarray([1.0, 0.95, 0.5], np.float32)
    cache.lengths.copy_(torch.from_numpy(lengths))
    port._tokens.copy_(torch.from_numpy(toks))
    port._keys.copy_(torch.from_numpy(keys))
    port._temps.copy_(torch.from_numpy(temps))
    port._topk.copy_(torch.from_numpy(tks))
    port._topp.copy_(torch.from_numpy(tps))
    prompt = np.arange(1, 15, dtype=np.int32)  # 14 + 8 generated - 1 = hist 21
    port._slots[1] = TG._Slot(future=TG.Future(), remaining=5, eos_id=None, sampling=True,
                              prompt_len=14, generated=[60, 61, 62, 63, 64, 65, 66, 77],
                              slo_class="best-effort", prompt=prompt, temperature=0.8,
                              top_k=50, top_p=0.95)
    port._slots[2] = TG._Slot(future=TG.Future(), remaining=5, eos_id=None)

    def row(c, slot, n):
        if quant:
            return [t[:, slot, :, :n].clone() for t in (c.k8, c.k_scale, c.v8, c.v_scale)]
        return [t[:, slot, :, :n].clone() for t in (c.k, c.v)]

    C, hist = 8, 21
    n = 3 * C
    snapshot = row(port._cache, 1, n)
    port._evict_slot(1)
    (rec,) = port._class_queues["best-effort"]
    port._class_queues["best-effort"].clear()
    port._admit_restore(rec)
    assert port._slots[0] is not None and port._slots[0].generated[-1] == 77
    got = row(port._cache, 0, n)
    # The JAX composition on the same values, op by op (jitted, XLA turns
    # the scale's division by 127 into a product: one f32 ulp apart on some
    # scales, a standing record), and jitted.
    def compose(jk, jv):
        for ci in range(3):
            ck, cv = ref._read_slot(jk, jv, jnp.int32(1), jnp.int32(ci * C))
            jk, jv = ref._seed_slot(jk, jv, ck, cv, jnp.int32(0), jnp.int32(ci * C))
        return jk, jv

    with jax.disable_jit():
        eager = compose(jk, jv)
    jk, jv = compose(jk, jv)
    if quant:
        for a, b in zip((*jk, *jv), (*eager[0], *eager[1])):
            a, b = np.asarray(a)[:, 0, :, :n], np.asarray(b)[:, 0, :, :n]
            if a.dtype == np.int8:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_max_ulp(a, b, maxulp=1)
    jk, jv = eager
    jkeys = jax.random.wrap_key_data(jnp.asarray(keys.astype(np.uint32)))
    jl, jt, jkeys, jte, jtk, jtp = ref._insert_restore(
        jnp.asarray(lengths), jnp.asarray(toks.astype(np.int32)), jkeys, jnp.asarray(temps),
        jnp.asarray(tks), jnp.asarray(tps), jnp.int32(0), jnp.int32(hist), jnp.int32(77),
        jax.random.wrap_key_data(jnp.asarray(keys[1].astype(np.uint32))),
        jnp.float32(0.8), jnp.int32(50), jnp.float32(0.95))
    if quant:
        want = [np.asarray(a)[:, 0, :, :n] for a in (*jk, *jv)]
        got_np = [t.numpy() for t in got]
    else:
        want = [np.asarray(a.astype(jnp.float64))[:, 0, :, :n] for a in (jk, jv)]
        got_np = [t.to(torch.float64).numpy() for t in got]
    for g, w in zip(got_np, want):
        np.testing.assert_array_equal(g, w)
    lossless = all(torch.equal(a, b) for a, b in zip(got, snapshot))
    assert lossless == (not (quant and dtype == "bfloat16"))
    assert port._cache.lengths.tolist() == np.asarray(jl).tolist()
    assert port._tokens[:, 0].tolist() == np.asarray(jt)[:, 0].tolist()
    np.testing.assert_array_equal(port._keys.numpy(), _key_words(jkeys))
    np.testing.assert_array_equal(port._temps.numpy(), np.asarray(jte))
    np.testing.assert_array_equal(port._topk.numpy(), np.asarray(jtk))
    np.testing.assert_array_equal(port._topp.numpy(), np.asarray(jtp))
    # The two whole chunks entered the radix cache under the committed tokens.
    full = np.concatenate([prompt, [60, 61, 62, 63, 64, 65, 66]]).astype(np.int32)
    assert port._prefix_cache.has_chunk(full, 1) and not port._prefix_cache.has_chunk(full, 2)
    assert port.prefix_hits == 1 and port.prefix_cached_tokens == 16


def test_the_int8_round_trip_is_exact_for_the_scales_a_bf16_engine_writes(x64):
    """A bf16 engine quantizes bf16 K/V, so each scale is a bf16 value over
    127 and ``bf16(127 * scale)`` gives it back: the round trip that loses
    bits on arbitrary scales is exact on every row such an engine writes,
    in both packages (what the card's restore check holds)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 1, 4, 64, 128)) * 3.0).to(torch.bfloat16)
    q8, sc = T._quant_kv(x)
    deq = (q8.to(torch.bfloat16) * sc).to(torch.bfloat16)
    q8b, scb = T._quant_kv(deq)
    assert torch.equal(q8b, q8) and torch.equal(scb, sc)
    jq8, jsc = J._quant_kv((jnp.asarray(q8.numpy()).astype(jnp.bfloat16)
                            * jnp.asarray(sc.numpy())).astype(jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(jq8), q8.numpy())
    np.testing.assert_array_equal(np.asarray(jsc), sc.numpy())


def test_a_restore_writes_the_unified_programs_buffers_in_place(tiny):
    """After every restore the engine's state tensors are still the
    super-step program's buffers (the graphs on the card read those)."""
    jp, tp = tiny
    engine = _engine(tp, max_slots=2, prefill_batch=2, unified_step=True, decode_steps=4)
    prog = engine._program
    seen = []
    real = engine._admit_restore

    def spy(rec):
        real(rec)
        pairs = ((engine._tokens, prog.tokens), (engine._keys, prog.keys),
                 (engine._temps, prog.temps), (engine._topk, prog.topk),
                 (engine._topp, prog.topp), (engine._cache.lengths, prog.lengths),
                 (engine._cache.k, prog.cache.k))
        seen.append(all(a.data_ptr() == b.data_ptr() for a, b in pairs))
        idx = next(i for i, s in enumerate(engine._slots) if s is not None and s.generated
                   is rec.generated)
        seen.append(int(prog.lengths[idx]) == rec.hist
                    and int(prog.tokens[idx, 0]) == rec.generated[-1]
                    and torch.equal(prog.keys[idx], rec.key))

    engine._admit_restore = spy
    assert isinstance(prog, TCG.SuperstepProgram)
    out_be, _, outs = _run_preempted(engine, others=(OTHER,), **SEEDED)
    assert seen and all(seen)
    assert engine._program is prog  # no recovery ran
    assert out_be == _run_clean(_engine(tp, max_slots=2, prefill_batch=2, unified_step=True,
                                        decode_steps=4), **SEEDED)[0]
    assert outs == [_ref(jp, OTHER, 20)]


# -- the serving surface ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_f32():
    cfg = T.LlamaConfig.tiny(max_seq=64)
    return cfg, T.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)


class _Served:
    def __init__(self, tiny_f32, **config):
        cfg, params = tiny_f32
        pred = TR._build_llama(params, cfg, dtype=torch.float32)
        conf = tapp.ServerConfig(model_name="llm", host="127.0.0.1", port=0, dtype="float32",
                                 device="cpu", **config)
        self.srv = tapp.build_server(pred, conf)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def post(self, body):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        conn.request("POST", "/v2/models/llm/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
        conn.close()
        return out

    def metrics(self) -> str:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        return text

    def stop(self):
        self.srv.shutdown_all()
        self.thread.join(timeout=30)


def _sample(text: str, name: str, label: str) -> float:
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(name + "{") and label in ln)


def test_generate_takes_slo_class_and_refuses_a_bad_one(tiny_f32):
    h = _Served(tiny_f32, max_slots=2, slo_class="batch")
    try:
        seen = []
        real = h.srv.engine.submit
        h.srv.engine.submit = lambda *a, **kw: (seen.append(kw.get("slo_class")),
                                                real(*a, **kw))[1]
        for cls in ("interactive", "best-effort", None):
            body = {"prompt_ids": [5, 9, 2], "max_new_tokens": 3}
            if cls is not None:
                body["slo_class"] = cls
            code, out = h.post(body)
            assert code == 200 and len(out["outputs"][0]["data"]) == 3
        assert seen == ["interactive", "best-effort", None]  # None: the server's batch
        code, out = h.post({"prompt_ids": [[5, 9, 2], [1, 2]], "max_new_tokens": 3,
                            "slo_class": "gold"})
        assert code == 400 and "slo_class 'gold' not in" in out["error"]
        assert h.srv.engine.inflight() == 0 and h.srv.engine._queued_est_tokens == 0
    finally:
        h.stop()


def test_a_class_shed_429_names_the_class(tiny_f32):
    h = _Served(tiny_f32, max_slots=1, slo_class="batch", admission_queue_budget=100)
    eng = h.srv.engine
    backlog = SimpleNamespace(est_tokens=40)  # queued-but-unadmitted work
    eng.reserve_admission(backlog.est_tokens)
    try:
        code, out = h.post({"prompt_ids": [5, 9, 2], "max_new_tokens": 8,
                            "slo_class": "best-effort"})  # 40 + 11 > 50
        assert code == 429
        assert out["reason"] == "class_best-effort" and out["slo_class"] == "best-effort"
        code, out = h.post({"prompt_ids": [5, 9, 2], "max_new_tokens": 8})  # batch: 75
        assert code == 200
        text = h.metrics()
        assert _sample(text, "tpumlops_engine_shed_total", 'reason="class_best-effort"') == 1
    finally:
        eng._release_queued(backlog)
        h.stop()


def test_a_served_preemption_shows_on_metrics(tiny_f32):
    """A best-effort request fills the one slot; at its 4th token the
    scheduler thread starts an interactive request over HTTP and waits
    until it is queued, so the eviction is fixed by construction."""
    h = _Served(tiny_f32, max_slots=1, prefill_chunk=8, prefix_cache=True,
                prefix_cache_budget_mb=1, slo_class="best-effort", preemption=True)
    eng = h.srv.engine
    got = {}
    count = [0]
    metric = eng.on_tokens

    def trigger(n):
        metric(n)
        count[0] += 1
        if count[0] == 4:
            th = threading.Thread(target=lambda: got.update(ia=h.post(
                {"prompt_ids": IA_PROMPT, "max_new_tokens": 5, "slo_class": "interactive"})))
            th.start()
            deadline = time.monotonic() + 60
            while eng._queue.empty():
                assert time.monotonic() < deadline, "the interactive request never queued"
                time.sleep(0.001)
            got["th"] = th

    eng.on_tokens = trigger
    try:
        code, out = h.post({"prompt_ids": BE_PROMPT, "max_new_tokens": 30})
        got["th"].join(timeout=60)
        assert code == 200 and len(out["outputs"][0]["data"]) == 30
        assert got["ia"][0] == 200 and len(got["ia"][1]["outputs"][0]["data"]) == 5
        assert eng.preemptions == eng.preempt_restores == 1
        text = h.metrics()
        assert _sample(text, "tpumlops_engine_preempt_total", 'event="evict"') == 1
        assert _sample(text, "tpumlops_engine_preempt_total", 'event="restore"') == 1
        assert _sample(text, "tpumlops_engine_dispatches_total",
                       'op="preempt-evict"') == 1
    finally:
        h.stop()


def _args(*extra):
    return tapp.build_arg_parser().parse_args(["--model-uri", "x", *extra])


@pytest.mark.parametrize("flags,spec", [
    (["--preemption", "1"], {"preemption": True}),
    (["--slo-class", "gold"], {"sloClass": "gold"}),
])
def test_bad_class_flags_are_refused_as_the_reference_refuses_them(flags, spec):
    from tpumlops.utils.config import TpuSpec

    with pytest.raises(ValueError) as ref:
        TpuSpec.from_spec(spec)
    with pytest.raises(ValueError) as port:
        tapp.config_from_args(_args(*flags))
    assert str(port.value) == str(ref.value)


def test_class_flags_parse_into_the_engine():
    from tpumlops.utils.config import TpuSpec

    off = tapp.config_from_args(_args())
    assert (off.slo_class, off.preemption) == (None, False) == (
        TpuSpec.from_spec({}).slo_class, TpuSpec.from_spec({}).preemption)
    conf = tapp.config_from_args(_args("--slo-class", "batch", "--preemption", "1",
                                       "--prefix-cache", "1", "--device", "cpu"))
    ref = TpuSpec.from_spec({"sloClass": "batch", "preemption": True,
                             "prefixCache": {"enabled": True}})
    assert (conf.slo_class, conf.preemption) == (ref.slo_class, ref.preemption)
    pred = TR._build_llama(T.init(torch.Generator().manual_seed(3), TCFG), TCFG,
                           dtype=torch.float32)
    m = tapp.ServerMetrics("d", "v1", "ns")
    engine = tapp.make_gen_engine(pred, conf, m)
    assert engine._slo_default == "batch" and engine._preemption
    assert engine._on_preempt == m.inc_preempt
