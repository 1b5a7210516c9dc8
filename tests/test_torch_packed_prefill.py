"""The port's packed multi-admission prefill against the JAX package, in
float64 on the CPU.

- ``prefill_chunks_ragged`` (dense and int8 caches) against JAX
  ``prefill_chunks_ragged``: the real rows' logits (f32 on both sides, so
  ``LOGIT_TOL``) and the committed cache, ragged offsets, permuted slots and
  a parked row; parked rows leave the cache bit-identical.  (The ragged
  attention itself, its plain version and the kernel's tile algebra, is
  held in ``tests/test_torch_flash_attention.py``.)
- The packed engine token for token on the scenarios of
  ``tests/test_packed_prefill.py``: ragged chunk counts, bucket boundaries
  (1, 2, 3 in a bucket of 4, 4), the serial engine's first tokens, seeded
  sampling (against the JAX packed engine), prefix-cache hits (the cached
  prefix seeded into the reserved row, fresh chunks read back off it),
  speculation, validation, the token budget and the metric hooks; int8 KV
  against the JAX packed engine; a failed packed forward.  Greedy
  references are JAX ``generate_greedy``, which the JAX packed engine
  reproduces token for token (its own tests).
- The read-back and seed of a chunk are lossless in bf16 in both packages:
  the int8 cache's codes and scales come back bit for bit.
- ``--prefill-batch`` / ``--prefill-token-budget`` on the serving surface,
  refused as the reference refuses them, and the
  ``tpumlops_prefill_batch_fill`` family against the reference's, with its
  count and sum equal to the engine's packed forwards and chunks.
"""

import functools
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

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
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    prefix_cache as tpc,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    speculative as tsp,
)
from tpumlops.models import llama as J
from tpumlops.models.quantization import quantize_llama as j_quantize_llama
from tpumlops.server.generation import GenerationEngine as JaxEngine
from tpumlops.server.metrics import ServerMetrics as JaxServerMetrics
from tpumlops.server.prefix_cache import PrefixCacheConfig as JaxPrefixCacheConfig

LOGIT_TOL = dict(rtol=2e-5, atol=2e-6)


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


@functools.lru_cache(maxsize=None)
def _models(quant=False):
    jcfg = J.LlamaConfig.tiny(max_seq=64)
    tcfg = T.LlamaConfig.tiny(max_seq=64)
    jp = J.init(jax.random.key(0), jcfg, dtype=jnp.float64)
    if quant:
        jp = j_quantize_llama(jp)
    return jcfg, tcfg, jp, convert.from_jax_numpy(jax.device_get(jp))


_jgen = jax.jit(J.generate_greedy, static_argnums=(2, 3), static_argnames=("dtype",))


@functools.lru_cache(maxsize=None)
def _ref(prompt: tuple, n: int) -> list:
    jcfg, _, jp, _ = _models()
    out = _jgen(jp, jnp.asarray([prompt], jnp.int32), n, jcfg, dtype=jnp.float64)
    return np.asarray(out)[0].tolist()


def _refs(jobs):
    return [_ref(tuple(p), n) for p, n in jobs]


# -- the model function ----------------------------------------------------------


def _caches(jcfg, quant, n_slots, seed):
    """The same random ragged cache for both packages (f64 values, or int8
    codes with f32 scales)."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.num_layers, n_slots, jcfg.num_kv_heads, jcfg.max_seq, jcfg.head_dim)
    lengths = np.zeros((n_slots,), np.int32)
    if quant:
        arrs = (rng.integers(-127, 128, shape).astype(np.int8),
                (rng.random(shape[:-1] + (1,)) * 0.01 + 1e-3).astype(np.float32),
                rng.integers(-127, 128, shape).astype(np.int8),
                (rng.random(shape[:-1] + (1,)) * 0.01 + 1e-3).astype(np.float32))
        jc = J.QuantRaggedKVCache(*(jnp.asarray(a) for a in arrs), jnp.asarray(lengths))
        tc = T.QuantRaggedKVCache(*(torch.from_numpy(a.copy()) for a in arrs),
                                  torch.from_numpy(lengths))
    else:
        arrs = rng.standard_normal((2,) + shape)
        jc = J.RaggedKVCache(*(jnp.asarray(a) for a in arrs), jnp.asarray(lengths))
        tc = T.RaggedKVCache(*(torch.from_numpy(a.copy()) for a in arrs),
                             torch.from_numpy(lengths))
    return jc, tc


_jpack = jax.jit(J.prefill_chunks_ragged, static_argnums=(5,), static_argnames=("dtype",))


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_prefill_chunks_ragged_matches_the_reference(quant):
    """Three real rows (offsets 0, one chunk, 40 off the chunk grid) on
    permuted slots of a 5-row cache, and a parked row: the real rows'
    logits and the whole committed cache equal the JAX function's (the
    reference's parked row attends its whole row; its logits are ignored
    on both sides)."""
    jcfg, tcfg, jp, tp = _models(quant)
    jc, tc = _caches(jcfg, quant, 5, seed=1)
    C = 8
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, C)).astype(np.int32)
    slots = np.array([3, 0, 4, 1], np.int32)
    offsets = np.array([0, 8, 40, jcfg.max_seq], np.int32)
    jl, jc2 = _jpack(jp, jnp.asarray(ids), jc, jnp.asarray(slots), jnp.asarray(offsets), jcfg,
                     dtype=jnp.float64)
    tl, tc2 = T.prefill_chunks_ragged(tp, torch.from_numpy(ids).long(), tc,
                                      torch.from_numpy(slots), torch.from_numpy(offsets), tcfg,
                                      dtype=torch.float64)
    np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], **LOGIT_TOL)
    assert np.isfinite(tl.numpy()).all()
    for name, want, got in zip(tc2._fields[:-1], jc2[:-1], tc2[:-1]):
        want, got = np.asarray(want), got.numpy()
        if got.dtype == np.int8:  # codes of f32-rounded K/V: at most one step at a tie
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
            assert (got == want).mean() > 0.999, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    assert not tc2.lengths.any()  # the engine sets a length when a prompt's last chunk lands


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_parked_rows_leave_the_cache_bit_identical(quant):
    """One real row and three parked ones (offset == capacity) on slots of
    their own: the parked slots' rows keep every byte, the real row's chunk
    lands, and the parked rows' logits are finite."""
    jcfg, tcfg, _, tp = _models(quant)
    _, tc = _caches(jcfg, quant, 6, seed=3)
    before = [t.clone() for t in tc[:-1]]
    ids = torch.zeros((4, 8), dtype=torch.int64)
    ids[0] = torch.arange(2, 10)
    slots = torch.tensor([2, 0, 5, 1], dtype=torch.int32)
    offsets = torch.tensor([16] + [tcfg.max_seq] * 3, dtype=torch.int32)
    logits, tc2 = T.prefill_chunks_ragged(tp, ids, tc, slots, offsets, tcfg,
                                          dtype=torch.float64)
    assert torch.isfinite(logits).all()
    for old, new in zip(before, tc2[:-1]):
        for s in (0, 1, 3, 4, 5):
            assert torch.equal(new[:, s], old[:, s])
        assert torch.equal(new[:, 2, :, :16], old[:, 2, :, :16])
        assert torch.equal(new[:, 2, :, 24:], old[:, 2, :, 24:])
        assert not torch.equal(new[:, 2, :, 16:24], old[:, 2, :, 16:24])


# -- the engine ---------------------------------------------------------------------


def _engine(quant=False, **kw):
    _, tcfg, _, tp = _models(quant)
    kw.setdefault("max_slots", 4)
    kw.setdefault("prefill_batch", 4)
    if "prefix_cache" not in kw:
        kw.setdefault("prefill_chunk", 8)
    return TG.GenerationEngine(tp, tcfg, dtype=torch.float64, device="cpu", **kw)


def _run(engine, jobs):
    """Queue ``jobs`` ((prompt, n) or (prompt, n, sampling kwargs)) before
    the scheduler starts, so its first admit phase pops the whole burst,
    and return their tokens."""
    futs = [engine.submit(job[0], job[1], **(job[2] if len(job) > 2 else {})) for job in jobs]
    engine.start()
    try:
        return [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()


RAGGED = [([5, 9, 2], 6), ([7, 1, 4, 8, 3, 9, 2, 6], 5), (list(range(2, 23)), 7), ([11, 3], 4)]


def test_ragged_chunk_counts_match_generate_greedy():
    """Four admissions of 1, 1, 3 and 1 chunks in one burst: every stream
    equals greedy decode, the six chunks ran in three packed forwards (the
    longest admission's count), one a layer a forward through the ragged
    attention."""
    engine = _engine()
    calls = []
    real = T.prefill_chunks_ragged

    def spy(*a, **kw):
        calls.append(a[1].shape[0])
        return real(*a, **kw)

    TG.llama.prefill_chunks_ragged = spy
    try:
        assert _run(engine, RAGGED) == _refs(RAGGED)
    finally:
        TG.llama.prefill_chunks_ragged = real
    assert engine.prefill_forwards == 3 and engine.prefill_chunks_dispatched == 6
    assert calls == [4, 1, 1]  # a bucket of 4, then the long admission alone
    assert engine.dispatches_total["packed-prefill"] == 3
    assert not engine._reserved and not engine._pending


def test_bucket_boundaries_and_parked_pad_rows():
    """Waves of 1, 2, 3 and 4 admissions: packed calls of 1, 2, 4 (3 real
    rows and a parked one on a slot of its own) and 4 rows, each wave equal
    to greedy decode."""
    engine = _engine()
    calls = []
    real = TG.GenerationEngine._device_chunks

    def spy(self, ids, slots, offsets, finals):
        calls.append((len(ids), slots.tolist(), offsets.tolist()))
        return real(self, ids, slots, offsets, finals)

    engine._device_chunks = spy.__get__(engine)
    engine.start()
    try:
        for wave in (1, 2, 3, 4):
            jobs = [(list(range(2 + i, 12 + i)), 4) for i in range(wave)]
            futs = [engine.submit(p, n) for p, n in jobs]
            assert [f.result(timeout=120).tolist() for f in futs] == _refs(jobs), wave
    finally:
        engine.shutdown()
    buckets = {len(s) for _, s, _ in calls}
    assert buckets <= {1, 2, 4} and 4 in buckets
    for rows, slots, offsets in calls:
        assert len(set(slots)) == rows  # pad rows on slots of their own
        parked = [o for o in offsets if o == 64]
        assert rows - len(parked) >= 1


def test_packed_matches_the_serial_engine_first_tokens():
    """Packed and single-admission engines: the same tokens, the first one
    included (the packed forward's finalize draws it)."""
    jobs = [(list(range(3, 20)), 5), ([9, 8, 7, 6, 5, 4], 5)]
    serial = _run(_engine(prefill_batch=1), jobs)
    assert _run(_engine(), jobs) == serial == _refs(jobs)


@functools.lru_cache(maxsize=None)
def _jax_packed(jobs: tuple, quant: bool = False) -> list:
    """The JAX packed engine (prefill_batch 4, chunk 8, four slots, f64) on
    ``jobs``, queued before it starts."""
    jcfg, _, jp, _ = _models(quant)
    eng = JaxEngine(jp, jcfg, max_slots=4, dtype=jnp.float64, prefill_chunk=8, prefill_batch=4,
                    kv_quant=quant)
    futs = [eng.submit(list(p), n, **dict(kw)) for p, n, kw in jobs]
    eng.start(warmup=False)
    try:
        return [f.result(timeout=600).tolist() for f in futs]
    finally:
        eng.shutdown()


def test_seeded_sampling_matches_the_jax_packed_engine():
    """A seeded sampled request beside a greedy one through the packed
    forward: the batched finalize installs the reference's key discipline,
    so both streams equal the JAX packed engine's and the serial port
    engine's."""
    kw = (("temperature", 0.9), ("top_k", 4), ("top_p", 0.95), ("seed", 1234))
    jobs = (((5, 9, 2, 7, 1, 4, 8, 3, 11), 6, kw), (tuple(range(2, 20)), 5, ()))
    want = _jax_packed(jobs)
    port_jobs = [(list(p), n, dict(k)) for p, n, k in jobs]
    assert _run(_engine(), port_jobs) == want
    assert _run(_engine(prefill_batch=1), port_jobs) == want


def test_int8_kv_matches_the_jax_packed_engine():
    """int8 weights and the int8 KV cache: the packed forward reads earlier
    chunks through the cache's codes, as the JAX packed engine does; the
    ragged burst's tokens are equal."""
    jobs = tuple((tuple(p), n, ()) for p, n in RAGGED)
    want = _jax_packed(jobs, quant=True)
    assert _run(_engine(quant=True, kv_quant=True), [(list(p), n) for p, n, _ in jobs]) == want


def test_prefix_cache_hits_seed_the_reserved_row():
    """A cold prompt writes its two full chunks back off its reserved row;
    three warm ones seed them into their own rows and each prefills one
    suffix chunk, packed into one forward."""
    engine = _engine(prefix_cache=tpc.PrefixCacheConfig(enabled=True, budget_bytes=32 * 2**20,
                                                         chunk_tokens=8))
    shared = list(range(2, 18))
    engine.start()
    try:
        assert engine.generate(shared + [40], 5).tolist() == _ref(tuple(shared + [40]), 5)
        f0, c0 = engine.prefill_forwards, engine.prefill_chunks_dispatched
        seeds0 = engine.dispatches_total.get("seed", 0)
        warm = [shared + [50 + i] for i in range(3)]
        futs = [engine.submit(p, 5) for p in warm]
        outs = [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()
    assert outs == [_ref(tuple(p), 5) for p in warm]
    assert (engine.prefix_hits, engine.prefix_cached_tokens) == (3, 48)
    assert engine.prefill_chunks_dispatched - c0 == 3
    assert engine.prefill_forwards - f0 <= 3
    assert engine.dispatches_total["seed"] - seeds0 == 3


def test_speculation_composes_with_packed_admission():
    engine = _engine(speculative=tsp.SpeculativeConfig(
        enabled=True, draft_tokens=4, ngram_min=1, ngram_max=4, adaptive=True))
    jobs = [([1, 2, 3] * 5, 10), ([4, 5, 6] * 4, 8)]
    assert _run(engine, jobs) == _refs(jobs)
    assert engine.spec_verify_ticks > 0


def test_validation_matches_the_reference():
    with pytest.raises(ValueError, match="chunked prefill"):
        _engine(prefill_chunk=None, prefill_batch=2)
    with pytest.raises(ValueError, match="prefill_batch"):
        _engine(prefill_batch=0)
    with pytest.raises(ValueError, match="prefill_token_budget"):
        _engine(prefill_batch=2, prefill_token_budget=-1)
    assert _engine(prefill_batch=16)._prefill_batch == 4  # at most max_slots
    assert _engine(prefill_batch=3)._pack_buckets() == [1, 2, 3]


def test_token_budget_caps_chunks_a_forward():
    """A budget of 16 tokens at chunk 8: at most two chunks a forward."""
    fills = []
    engine = _engine(prefill_token_budget=16, on_prefill_batch=fills.append)
    jobs = [(list(range(2 + i, 14 + i)), 4) for i in range(4)]
    assert _run(engine, jobs) == _refs(jobs)
    assert fills and max(fills) == 2 and sum(fills) == engine.prefill_chunks_dispatched


def test_admission_metrics_fire():
    fills, waits, ttfts = [], [], []
    engine = _engine(on_prefill_batch=fills.append, on_admission_wait=waits.append,
                     on_ttft=ttfts.append)
    jobs = [(list(range(2 + i, 14 + i)), 3) for i in range(3)]
    assert _run(engine, jobs) == _refs(jobs)
    assert len(ttfts) == 3 and all(t > 0 for t in ttfts)
    assert len(waits) == 3 and all(w >= 0 for w in waits)
    assert fills[0] == 3 and len(fills) == engine.prefill_forwards


def test_a_failed_packed_forward_fails_its_admissions_and_recovers():
    """A packed forward that raises fails every pending admission (their
    rows are reset with the cache), frees the reserved rows, and the next
    request is served exactly."""
    engine = _engine()
    real = engine._device_chunks

    def bomb(*a):
        raise RuntimeError("injected failure")

    engine._device_chunks = bomb
    engine.start()
    try:
        futs = [engine.submit(p, n) for p, n in RAGGED[:2]]
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=60)
        assert not engine._reserved
        engine._device_chunks = real
        assert engine.generate([5, 9, 2], 6).tolist() == _ref((5, 9, 2), 6)
    finally:
        engine.shutdown()


def test_drain_waits_for_a_pending_admission():
    """A request still mid-prefill in its reserved row counts as in flight:
    the engine is not drained until its answer is out."""
    engine = _engine()
    real = engine._device_chunks
    mid = threading.Event()

    def slow(*a):
        mid.set()
        threading.Event().wait(0.05)
        return real(*a)

    engine._device_chunks = slow
    engine.start()
    try:
        prompt = list(range(2, 23))  # three chunks
        fut = engine.submit(prompt, 3)
        assert mid.wait(30) and engine._pending
        engine.begin_drain()
        assert engine.inflight() == 1 and not engine.drained()
        assert fut.result(timeout=60).tolist() == _ref(tuple(prompt), 3)
        # The in-flight count drops in the future's done callback, which may
        # run just after result() wakes this thread.
        deadline = time.monotonic() + 10
        while not engine.drained() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.drained()
    finally:
        engine.shutdown()


# -- the lossless read-back and seed ------------------------------------------------


def _bf16_kv(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) * 3


def test_read_and_seed_round_trip_is_lossless_in_bf16():
    """A chunk's codes read off one reserved row (dequantized to bf16) and
    seeded into another (requantized) come back bit for bit: the port's
    ``_read_chunk_slot`` / ``_device_seed_slot`` on codes from its eager
    quantizer, and the JAX engine's ``_read_slot`` / ``_seed_slot`` on
    codes from its jitted one (whose scales may sit one f32 ulp from the
    eager ones, ROADMAP C); the two reads agree to that ulp."""
    jcfg, tcfg, jp, tp = _models()
    C = 8
    engine = TG.GenerationEngine(tp, tcfg, max_slots=4, dtype=torch.bfloat16, device="cpu",
                                 kv_quant=True, prefill_chunk=C, prefill_batch=2)
    cache = engine._cache
    L, _, NKV, _, D = cache.k8.shape
    xs = [_bf16_kv((L, 1, NKV, C, D), seed) for seed in (1, 2)]
    (k8, ks), (v8, vs) = (T._quant_kv(torch.from_numpy(x).to(torch.bfloat16)) for x in xs)
    at = (slice(None), slice(1, 2), slice(None), slice(16, 24))
    cache.k8[at], cache.k_scale[at], cache.v8[at], cache.v_scale[at] = k8, ks, v8, vs
    ck, cv = engine._read_chunk_slot(1, 16)
    assert ck.shape == (L, 1, C, NKV, D) and ck.dtype == torch.bfloat16
    engine._device_seed_slot([(ck, cv)], 3)
    for buf, want in ((cache.k8, k8), (cache.k_scale, ks), (cache.v8, v8), (cache.v_scale, vs)):
        assert torch.equal(buf[:, 3:4, :, :C], want)

    jeng = JaxEngine(jp, jcfg, max_slots=4, dtype=jnp.bfloat16, kv_quant=True, prefill_batch=2,
                     prefix_cache=JaxPrefixCacheConfig(enabled=True, budget_bytes=1 << 20,
                                                       chunk_tokens=C))
    quant = jax.jit(J._quant_kv)
    (jk8, jks), (jv8, jvs) = (quant(jnp.asarray(x, jnp.bfloat16)) for x in xs)
    jk = tuple(b.at[at].set(x) for b, x in zip(jeng._cache_k, (jk8, jks)))
    jv = tuple(b.at[at].set(x) for b, x in zip(jeng._cache_v, (jv8, jvs)))
    jck, jcv = jeng._read_slot(jk, jv, jnp.int32(1), jnp.int32(16))
    np.testing.assert_allclose(np.asarray(jck.astype(jnp.float32)),
                               ck.to(torch.float32).numpy(), rtol=2**-7, atol=0)
    jk, jv = jeng._seed_slot(jk, jv, jck, jcv, jnp.int32(3), jnp.int32(0))
    for got, want in ((jk[0], jk8), (jk[1], jks), (jv[0], jv8), (jv[1], jvs)):
        np.testing.assert_array_equal(np.asarray(got[:, 3:4, :, :C]), np.asarray(want))


# -- the serving surface --------------------------------------------------------------


def _args(*extra):
    return tapp.build_arg_parser().parse_args(["--model-uri", "x", *extra])


def test_prefill_flags_parse_into_the_engine():
    """The flags reach the engine (``--prefix-cache`` alone implies the
    chunk packed prefill needs) with its fill hook on the metrics."""
    conf = tapp.config_from_args(_args("--prefill-chunk", "8", "--prefill-batch", "4",
                                       "--prefill-token-budget", "16", "--device", "cpu"))
    assert (conf.prefill_batch, conf.prefill_token_budget) == (4, 16)
    cfg = T.LlamaConfig.tiny(max_seq=64)
    pred = TR._build_llama(T.init(torch.Generator().manual_seed(3), cfg), cfg,
                           dtype=torch.float32)
    metrics = tapp.ServerMetrics("d", "v1", "ns")
    engine = tapp.make_gen_engine(pred, conf, metrics)
    assert (engine._prefill_batch, engine._prefill_token_budget, engine._packed) == (4, 16, True)
    assert engine._on_prefill_batch == metrics.observe_prefill_batch
    off = tapp.config_from_args(_args())
    assert (off.prefill_batch, off.prefill_token_budget) == (1, 0)
    warm = tapp.config_from_args(_args("--prefix-cache", "1", "--prefill-batch", "2"))
    assert warm.prefill_batch == 2 and warm.prefix_cache_chunk_tokens == 64


@pytest.mark.parametrize("flags,spec", [
    (["--prefill-batch", "0"], {"prefillBatch": 0}),
    (["--prefill-batch", "2"], {"prefillBatch": 2}),
    (["--prefill-chunk", "8", "--prefill-batch", "2", "--prefill-token-budget", "-1"],
     {"prefillChunk": 8, "prefillBatch": 2, "prefillTokenBudget": -1}),
])
def test_bad_prefill_flags_are_refused_as_the_reference_refuses_them(flags, spec):
    from tpumlops.utils.config import TpuSpec

    with pytest.raises(ValueError) as ref:
        TpuSpec.from_spec(spec)
    with pytest.raises(ValueError) as port:
        tapp.config_from_args(_args(*flags))
    assert str(port.value) == str(ref.value)


def _family(text: str, name: str):
    for fam in text_string_to_metric_families(text):
        if fam.name == name:
            return fam
    raise AssertionError(f"{name} missing")


def test_prefill_batch_fill_family_matches_the_reference():
    ref, port = JaxServerMetrics("d", "v1", "ns"), tapp.ServerMetrics("d", "v1", "ns")
    for m in (ref, port):
        for fill in (1, 3, 4, 64, 65):
            m.observe_prefill_batch(fill)
    name = "tpumlops_prefill_batch_fill"
    want = _family(ref.exposition().decode(), name)
    got = _family(port.render().decode(), name)
    assert got.type == want.type == "histogram"

    def samples(fam):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value) for s in fam.samples
                      if not s.name.endswith("_created"))

    assert samples(got) == samples(want)


def test_served_burst_fills_the_histogram_with_the_engine_counts():
    """Four concurrent /generate requests on a packed server: the fill
    histogram's count is the packed forwards and its sum the chunks."""
    cfg = T.LlamaConfig.tiny(max_seq=64)
    params = T.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)
    pred = TR._build_llama(params, cfg, dtype=torch.float32)
    conf = tapp.ServerConfig(model_name="llm", host="127.0.0.1", port=0, dtype="float32",
                             max_slots=4, device="cpu", prefill_chunk=8, prefill_batch=4)
    srv = tapp.build_server(pred, conf)
    real = srv.engine._device_chunks

    def slow(*a):  # a forward long enough for the burst's requests to arrive together
        threading.Event().wait(0.02)
        return real(*a)

    srv.engine._device_chunks = slow
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        return resp.status, raw

    try:
        codes = []
        workers = [threading.Thread(target=lambda n=n: codes.append(call(
            "POST", "/v2/models/llm/generate",
            {"prompt_ids": list(range(1, n)), "max_new_tokens": 3})[0]))
            for n in (5, 12, 20, 30)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert codes == [200] * 4
        eng = srv.engine
        _, text = call("GET", "/metrics")
        fam = _family(text.decode(), "tpumlops_prefill_batch_fill")
        val = {s.name: s.value for s in fam.samples}
        assert val["tpumlops_prefill_batch_fill_count"] == eng.prefill_forwards > 0
        assert val["tpumlops_prefill_batch_fill_sum"] == eng.prefill_chunks_dispatched == 1 + 2 + 3 + 4
        assert eng.prefill_forwards < eng.prefill_chunks_dispatched
    finally:
        srv.shutdown_all()
        th.join(timeout=10)
