"""The port's radix prefix cache against the JAX package, on the CPU.

- Radix side by side: the port's ``RadixPrefixCache`` (torch host
  tensors) and the JAX one (numpy arrays of the same byte sizes) run the
  same operation sequences, the scenarios of ``tests/test_prefix_cache.py``
  (longest match, the cap below the prompt length, a missing parent path,
  LRU at the byte budget, L2 catch / promote / age-out, L2 off as one
  tier, the config checks); after every operation the matches, the chunk
  each match returns, the counters and the hook calls must agree.
- The engine in float64 (``LlamaConfig.tiny(max_seq=64)``, two slots)
  against JAX ``generate_greedy``: a warm admission's pre-insert logits
  equal to the cold one's, partial reuse across prompts, a disabled cache
  identical to the plain engine, the chunk mismatch refused, a tight
  budget still exact, the L2 path exact, the hit, evict and L2 hooks.
"""

import functools

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
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    prefix_cache as tpc,
)
from tpumlops.models import llama as J
from tpumlops.server import prefix_cache as jpc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- radix side by side ----------------------------------------------------------


class _Pair:
    """The port's and the reference's cache driven by the same calls; every
    insert gets a tagged K/V of ``nbytes`` a tensor (torch on the port,
    numpy on the reference) so returned chunks compare by tag."""

    def __init__(self, **kw):
        self.events = {"port": [], "ref": []}
        self.evicted = {"port": [], "ref": []}
        self.tags = {}
        self.port = tpc.RadixPrefixCache(
            on_evict=self.evicted["port"].append, on_l2_event=self.events["port"].append, **kw)
        self.ref = jpc.RadixPrefixCache(
            on_evict=self.evicted["ref"].append, on_l2_event=self.events["ref"].append, **kw)

    def _kv(self, tag, nbytes):
        tk, tv = torch.zeros(nbytes // 8, dtype=torch.float64), torch.zeros(
            nbytes // 8, dtype=torch.float64)
        jk, jv = np.zeros(nbytes // 8, np.float64), np.zeros(nbytes // 8, np.float64)
        for a in (tk, tv, jk, jv):
            self.tags[id(a)] = tag
        return (tk, tv), (jk, jv)

    def check(self):
        for name in ("bytes", "evictions", "l2_bytes", "l2_hits", "l2_spills",
                     "l2_evictions", "lookups"):
            assert getattr(self.port, name) == getattr(self.ref, name), name
        assert len(self.port) == len(self.ref)
        assert self.events["port"] == self.events["ref"]
        assert self.evicted["port"] == self.evicted["ref"]

    def insert(self, prompt, idx, tag, nbytes=64):
        (tk, tv), (jk, jv) = self._kv(tag, nbytes)
        got = self.port.insert_chunk(prompt, idx, tk, tv)
        assert got == self.ref.insert_chunk(prompt, idx, jk, jv)
        self.check()
        return got

    def lookup(self, prompt):
        n, kvs = self.port.lookup(prompt)
        jn, jkvs = self.ref.lookup(prompt)
        assert n == jn
        assert [(self.tags[id(k)], self.tags[id(v)]) for k, v in kvs] == \
            [(self.tags[id(k)], self.tags[id(v)]) for k, v in jkvs]
        self.check()
        return n, [self.tags[id(k)] for k, _ in kvs]

    def has(self, prompt, idx):
        got = self.port.has_chunk(prompt, idx)
        assert got == self.ref.has_chunk(prompt, idx)
        return got


def _chunks(*lists):
    return np.concatenate([np.asarray(t, np.int32) for t in lists])


A, B, C = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]


def test_radix_longest_prefix_match():
    c = _Pair(budget_bytes=1 << 20, chunk_tokens=4)
    prompt = _chunks(A, B, C, [13])
    assert c.insert(prompt, 0, "a") and c.insert(prompt, 1, "b")
    assert c.lookup(prompt) == (8, ["a", "b"])
    assert c.lookup(_chunks(A, [99, 98, 97, 96], [1])) == (4, ["a"])
    assert c.lookup(_chunks([42] * 4, [1])) == (0, [])
    assert c.has(prompt, 1) and not c.has(prompt, 2)


def test_radix_match_capped_below_prompt_length():
    c = _Pair(budget_bytes=1 << 20, chunk_tokens=4)
    prompt = _chunks(A, B)
    c.insert(prompt, 0, "a")
    c.insert(prompt, 1, "b")
    assert c.lookup(prompt) == (4, ["a"])
    assert c.lookup(_chunks(A, B, [9])) == (8, ["a", "b"])


def test_radix_insert_requires_parent_path():
    c = _Pair(budget_bytes=1 << 20, chunk_tokens=4)
    prompt = _chunks(A, B, [9])
    assert not c.insert(prompt, 1, "b")
    assert c.insert(prompt, 0, "a") and c.insert(prompt, 1, "b")
    assert len(c.port) == 2


def test_lru_eviction_at_byte_budget():
    c = _Pair(budget_bytes=3 * 128, chunk_tokens=4)
    pa, pb, pc, pd = (_chunks([1] * 4, [2] * 4, [0]), _chunks([3] * 4, [0]),
                      _chunks([4] * 4, [0]), _chunks([5] * 4, [0]))
    c.insert(pa, 0, "a0")
    c.insert(pa, 1, "a1")
    c.insert(pb, 0, "b")
    c.lookup(pa)
    c.insert(pc, 0, "c")
    assert c.port.evictions == 1 and c.evicted["port"] == [128]
    assert c.lookup(pb) == (0, [])
    assert c.lookup(pa) == (8, ["a0", "a1"])
    assert c.lookup(pc) == (4, ["c"])
    c.insert(pd, 0, "d")
    assert c.lookup(pa)[0] >= 4


def test_oversized_chunk_refused():
    c = _Pair(budget_bytes=100, chunk_tokens=4)
    assert not c.insert(_chunks(A, [0]), 0, "big", nbytes=64)
    assert c.port.bytes == 0


def test_l2_catches_evictions_and_promotes_on_lookup():
    c = _Pair(budget_bytes=2 * 128, chunk_tokens=4, l2_budget_bytes=1 << 20)
    pa, pb, pc = _chunks([1] * 4, [0]), _chunks([2] * 4, [0]), _chunks([3] * 4, [0])
    c.insert(pa, 0, "a")
    c.insert(pb, 0, "b")
    c.insert(pc, 0, "c")
    assert c.events["port"] == ["spill"]
    assert c.lookup(pa) == (4, ["a"])
    assert c.events["port"] == ["spill", "hit", "spill"]
    assert c.port.bytes <= c.port.budget_bytes


def test_l2_lru_ages_out_under_its_own_budget():
    c = _Pair(budget_bytes=128, chunk_tokens=4, l2_budget_bytes=2 * 128)
    prompts = [_chunks([i] * 4, [0]) for i in range(1, 5)]
    for i, p in enumerate(prompts):
        c.insert(p, 0, f"p{i}")
    assert (c.port.l2_spills, c.port.l2_evictions) == (3, 1)
    assert c.lookup(prompts[0]) == (0, [])
    assert c.lookup(prompts[2]) == (4, ["p2"])


def test_l2_fresh_insert_supersedes_a_spilled_copy():
    """An earlier chunk aged out of both tiers while a deeper one sat in
    the L2: re-inserting the path purges the stale spill."""
    c = _Pair(budget_bytes=2 * 128, chunk_tokens=4, l2_budget_bytes=4 * 128)
    p = _chunks(A, B, [0])
    c.insert(p, 0, "a")
    c.insert(p, 1, "b")
    c.insert(_chunks([7] * 4, [0]), 0, "x")
    c.insert(_chunks([8] * 4, [0]), 0, "y")
    c.insert(p, 0, "a2")
    c.insert(p, 1, "b2")
    assert c.lookup(p) == (8, ["a2", "b2"])


def test_l2_disabled_is_single_tier():
    c = _Pair(budget_bytes=128, chunk_tokens=4)
    pa = _chunks([1] * 4, [0])
    c.insert(pa, 0, "a")
    c.insert(_chunks([2] * 4, [0]), 0, "b")
    c.insert(_chunks([3] * 4, [0]), 0, "c")
    assert c.port.evictions >= 1 and c.port.l2_spills == 0
    assert c.lookup(pa) == (0, [])


@pytest.mark.parametrize("kw,needle", [
    (dict(budget_bytes=0, chunk_tokens=4), "budget"),
    (dict(budget_bytes=100, chunk_tokens=0), "chunk_tokens"),
    (dict(budget_bytes=100, chunk_tokens=4, l2_budget_bytes=-1), "L2 budget"),
])
def test_bad_config_refused_as_the_reference_refuses_it(kw, needle):
    with pytest.raises(ValueError, match=needle) as port:
        tpc.RadixPrefixCache(**kw)
    with pytest.raises(ValueError) as ref:
        jpc.RadixPrefixCache(**kw)
    assert str(port.value) == str(ref.value)


def test_random_operation_sequences_agree():
    """A random walk of inserts (in order, out of order, repeated) and
    lookups over a small alphabet of chunks, with both tiers under
    pressure: every answer, counter and hook call agrees."""
    rng = np.random.default_rng(7)
    c = _Pair(budget_bytes=5 * 128, chunk_tokens=2, l2_budget_bytes=3 * 128)
    for step in range(400):
        prompt = rng.integers(0, 3, int(rng.integers(1, 9))).astype(np.int32)
        if rng.random() < 0.5:
            c.insert(prompt, int(rng.integers(0, 4)), f"t{step}")
        else:
            c.lookup(prompt)


# -- the engine ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jax.config.update("jax_enable_x64", True)
    cfg = J.LlamaConfig.tiny(max_seq=64)
    jp = J.init(jax.random.key(0), cfg, dtype=jnp.float64)
    yield cfg, T.LlamaConfig.tiny(max_seq=64), jp, convert.from_jax_numpy(jax.device_get(jp))
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def ref(tiny):
    cfg, _, jp, _ = tiny
    gen = jax.jit(J.generate_greedy, static_argnums=(2, 3), static_argnames=("dtype",))

    @functools.lru_cache(maxsize=None)
    def run(prompt: tuple, n: int) -> list:
        out = gen(jp, jnp.asarray([prompt], jnp.int32), n, cfg, dtype=jnp.float64)
        return np.asarray(out)[0].tolist()

    return lambda p, n: run(tuple(p), n)


def _engine(tiny, budget_bytes=1 << 22, l2_budget_bytes=0, **kw):
    _, tcfg, _, tp = tiny
    return TG.GenerationEngine(
        tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu",
        prefix_cache=tpc.PrefixCacheConfig(enabled=True, budget_bytes=budget_bytes,
                                           chunk_tokens=8, l2_budget_bytes=l2_budget_bytes),
        **kw)


# One f64 chunk node at the tiny shape: 2 x (L 2 x 1 x C 8 x NKV 2 x D 16) x 8 B.
NODE = 2 * 2 * 8 * 2 * 16 * 8
P20 = list(range(2, 22))  # 20 tokens, C = 8: a 16-token cached prefix


def test_warm_admission_logits_equal_the_cold_ones(tiny, ref):
    engine = _engine(tiny)
    captured = []
    real = engine._device_insert

    def spy(*a, **kw):
        captured.append(engine._seq_state[0].clone())
        return real(*a, **kw)

    engine._device_insert = spy
    engine.start()
    try:
        cold = engine.generate(P20, 5).tolist()
        chunks_cold = engine.prefill_forwards
        assert engine.prefix_hits == 0
        warm = engine.generate(P20, 5).tolist()
        chunks_warm = engine.prefill_forwards - chunks_cold
    finally:
        engine.shutdown()
    assert cold == warm == ref(P20, 5)
    assert (chunks_cold, chunks_warm) == (3, 1)
    assert (engine.prefix_hits, engine.prefix_cached_tokens) == (1, 16)
    assert engine.dispatches_total["seed"] == 1
    # Row 3 of the final chunk is token 19 of 20, at chunk offset 16.
    assert torch.equal(captured[0][3], captured[1][3])


def test_partial_reuse_across_prompts(tiny, ref):
    shared = list(range(2, 10))
    p1, p2 = shared + [30, 31, 32], shared + [40, 41, 42, 43]
    engine = _engine(tiny)
    engine.start()
    try:
        out1, out2 = engine.generate(p1, 4).tolist(), engine.generate(p2, 4).tolist()
    finally:
        engine.shutdown()
    assert (out1, out2) == (ref(p1, 4), ref(p2, 4))
    assert (engine.prefix_hits, engine.prefix_cached_tokens) == (1, 8)


def test_a_disabled_cache_is_the_plain_chunked_engine(tiny, ref):
    _, tcfg, _, tp = tiny
    engine = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu",
                                 prefill_chunk=8,
                                 prefix_cache=tpc.PrefixCacheConfig(enabled=False))
    assert engine._prefix_cache is None
    engine.start()
    try:
        assert engine.generate(P20, 4).tolist() == ref(P20, 4)
        assert engine.generate(P20, 4).tolist() == ref(P20, 4)
    finally:
        engine.shutdown()
    assert engine.prefix_hits == 0 and engine.prefill_forwards == 6
    assert "seed" not in engine.dispatches_total


def test_chunk_mismatch_refused_and_chunking_derived(tiny):
    _, tcfg, _, tp = tiny
    with pytest.raises(ValueError, match="chunkTokens 8 must equal prefillChunk 16"):
        TG.GenerationEngine(tp, tcfg, device="cpu", prefill_chunk=16,
                            prefix_cache=tpc.PrefixCacheConfig(enabled=True, chunk_tokens=8))
    with pytest.raises(ValueError, match="chunkTokens must be positive"):
        TG.GenerationEngine(tp, tcfg, device="cpu",
                            prefix_cache=tpc.PrefixCacheConfig(enabled=True, chunk_tokens=0))
    engine = TG.GenerationEngine(tp, tcfg, device="cpu",
                                 prefix_cache=tpc.PrefixCacheConfig(enabled=True,
                                                                    chunk_tokens=8))
    assert engine._prefill_chunk_size == 8


def test_a_tight_budget_stays_exact(tiny, ref):
    p1, p2 = P20, list(range(100, 120))
    engine = _engine(tiny, budget_bytes=NODE + 1024)
    engine.start()
    try:
        for p in (p1, p2, p1, p2):
            assert engine.generate(p, 3).tolist() == ref(p, 3)
    finally:
        engine.shutdown()
    assert engine.prefix_evictions > 0


def test_the_second_tier_serves_evicted_chunks_exactly(tiny, ref):
    """A first tier of two nodes and an L2 of four: the second prompt's
    chunks push the first's into the L2, and the third admission of the
    first prompt promotes them back and seeds them."""
    p1, p2 = P20, list(range(100, 120))
    l2 = []
    engine = _engine(tiny, budget_bytes=2 * NODE, l2_budget_bytes=4 * NODE,
                     on_prefix_l2=l2.append)
    engine.start()
    try:
        for p in (p1, p2, p1):
            assert engine.generate(p, 3).tolist() == ref(p, 3)
    finally:
        engine.shutdown()
    cache = engine._prefix_cache
    assert cache.l2_spills == 4 and cache.l2_hits == 2
    assert (engine.prefix_hits, engine.prefix_cached_tokens) == (1, 16)
    assert l2 == ["spill", "spill", "hit", "spill", "hit", "spill"]


def test_hit_and_evict_hooks_fire(tiny):
    hits, evicts = [], []
    engine = _engine(tiny, budget_bytes=2 * NODE + 1024, on_prefix_hit=hits.append,
                     on_prefix_evict=lambda: evicts.append(1))
    engine.start()
    try:
        engine.generate(P20, 3)
        engine.generate(P20, 3)
        engine.generate(list(range(100, 120)), 3)
    finally:
        engine.shutdown()
    assert hits == [16]
    assert len(evicts) == engine.prefix_evictions == 2
