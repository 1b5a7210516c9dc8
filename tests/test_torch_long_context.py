"""Sequence parallelism in the port against the JAX package, in f64 on the
CPU: ``llama.prefill_ring`` and the engine's ring prefill at meshShape
sp > 1.

A tiny Llama (``torch_world.CFG_KW``; a grouped-heads variant with 2 K/V
heads) made by the JAX package's ``init`` is the one tree both sides run.
The port's ranks are spawned gloo worlds (``torch_world``); the JAX
references run here, on its 8 host devices.

- ``prefill_ring`` at ``{"sp": 2}`` and ``{"sp": 2, "tp": 2}`` against the
  JAX ``prefill_ring`` at sp 2: the last real row's logits and every
  layer's K/V of the whole padded prompt (a tp rank: its heads).
- The engine (leader + followers over the control channel) at
  ``{"sp": 2}``, ``{"sp": 4}`` and ``{"sp": 2, "tp": 2}``, threshold 16: a
  32-token cold prompt rides the ring (one ``sp-prefill`` dispatch, as the
  JAX engine counts it), a shorter one keeps the dense path, and both
  stream the unsharded tokens (JAX ``generate_greedy``).  At sp 2 also
  int8kv (equal to the unsharded int8kv engine), chunked prefill with the
  prefix cache seeded from the ring's write-back (a hit), and packed
  prefill.
- ``{"sp": 1}`` is the engine without a mesh (the same dispatch ledger);
  sp 3, sp 32 and an sp that does not divide the prefill chunk are
  refused with the reference's types.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world as W
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (  # noqa: E501
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    prefix_cache as TPC,
)
from tpumlops.models import llama as J
from tpumlops.models.partition import build_serving_mesh
from tpumlops.server.generation import GenerationEngine as JaxEngine

CFG_KW = W.CFG_KW
GQA_KW = {**W.CFG_KW, "num_kv_heads": 2}
LOGIT_TOL = dict(rtol=2e-5, atol=2e-6)  # f32 products, sums in another order
KV_TOL = dict(rtol=1e-5, atol=1e-7)
THRESHOLD = 16


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def trees(x64):
    out = {}
    for name, kw in (("mha", CFG_KW), ("gqa", GQA_KW)):
        jcfg = J.LlamaConfig(**kw)
        out[name] = (jcfg, J.init(jax.random.key(0), jcfg, dtype=jnp.float64))
    return out


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 120, size=n).tolist()


# -- prefill_ring ------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [{"sp": 2}, {"sp": 2, "tp": 2}], ids=["sp2", "sp2tp2"])
def test_prefill_ring_matches_the_jax_prefill_ring(trees, mesh_shape):
    jcfg, jp = trees["gqa"]
    L = 27  # 5 pad rows in the 32-position bucket
    ids = np.zeros((1, 32), np.int32)
    ids[0, :L] = _prompt(L, 5)
    lg, k_all, v_all = J.prefill_ring(jp, jnp.asarray(ids), jcfg,
                                      mesh=build_serving_mesh({"sp": 2}), last_idx=L - 1,
                                      dtype=jnp.float64)
    lg, k_all, v_all = (np.asarray(x) for x in (lg, k_all, v_all))
    world = int(np.prod(list(mesh_shape.values())))
    ranks = W.run(W.prefill_ring_case, world, mesh_shape, GQA_KW, jax.device_get(jp), ids, L - 1,
                  timeout=120)
    tp = mesh_shape.get("tp", 1)
    nkv = GQA_KW["num_kv_heads"] // tp
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], lg, **LOGIT_TOL, err_msg=f"rank {r}")
        h = got["coords"].get("tp", 0) * nkv
        for name, want in (("k", k_all), ("v", v_all)):
            assert got[name].shape == want[..., h:h + nkv, :].shape
            # pad rows carry unused K/V: only the real rows are compared
            np.testing.assert_allclose(got[name][:, :, :L], want[:, :, :L, h:h + nkv],
                                       **KV_TOL, err_msg=f"rank {r} {name}")


# -- the engine --------------------------------------------------------------------

LONG = (_prompt(32, 3), 8, {})
SHORT = (_prompt(15, 4), 6, {})
SHARED = _prompt(32, 21)
FOLLOW = SHARED[:16] + _prompt(4, 22)
INT8KV = (_prompt(32, 9), 8, {})
PACKED = [(_prompt(32, 41), 6, {}), (_prompt(10, 42), 5, {}), (_prompt(20, 43), 6, {})]
SP_KW = {"sp_prefill_threshold": THRESHOLD}

# mesh -> the runs of its one spawned world: (engine kwargs, requests)
RUNS = {
    "sp2": ({"sp": 2}, [
        ("whole", SP_KW, [LONG, SHORT]),
        ("int8kv", {**SP_KW, "kv_quant": True}, [INT8KV]),
        ("prefix", "prefix", [(SHARED, 6, {}), (FOLLOW, 6, {})]),
        ("packed", {**SP_KW, "prefill_chunk": 8, "prefill_batch": 2}, PACKED),
    ]),
    "sp4": ({"sp": 4}, [("whole", SP_KW, [LONG, SHORT])]),
    "sp2tp2": ({"sp": 2, "tp": 2}, [("whole", SP_KW, [LONG, (_prompt(10, 32), 6, {})])]),
}
_WORLDS: dict = {}


def _prefix_kw() -> dict:
    return {**SP_KW, "prefill_chunk": 16,
            "prefix_cache": TPC.PrefixCacheConfig(enabled=True, budget_bytes=1 << 22,
                                                  chunk_tokens=16)}


def _engine_world(trees, name):
    if name not in _WORLDS:
        mesh_shape, runs = RUNS[name]
        runs = [(_prefix_kw() if kw == "prefix" else kw, reqs) for _, kw, reqs in runs]
        world = int(np.prod(list(mesh_shape.values())))
        out = W.run(W.engine_case, world, mesh_shape, CFG_KW,
                    jax.device_get(trees["mha"][1]), runs, timeout=240)
        _WORLDS[name] = {tag: [rank[i] for rank in out]
                         for i, (tag, _, _) in enumerate(RUNS[name][1])}
    return _WORLDS[name]


_GREEDY: dict = {}


def _greedy(trees, prompt, n):
    key = (tuple(prompt), n)
    if key not in _GREEDY:
        jcfg, jp = trees["mha"]
        out = J.generate_greedy(jp, jnp.asarray([prompt], jnp.int32), n, jcfg,
                                dtype=jnp.float64)
        _GREEDY[key] = np.asarray(out)[0].tolist()
    return _GREEDY[key]


@pytest.mark.parametrize("name", ["sp2", "sp4", "sp2tp2"])
def test_sp_engine_streams_the_unsharded_tokens(trees, name):
    """The cold 32-token prompt rides the ring once; the short one keeps
    the dense path; every token equals the unsharded greedy stream, and
    every follower replayed the leader's ops."""
    leader, *followers = _engine_world(trees, name)["whole"]
    reqs = RUNS[name][1][0][2]
    assert leader["tokens"] == [_greedy(trees, p, n) for p, n, _ in reqs]
    assert leader["dispatches"].get("sp-prefill", 0) == 1
    assert all(f["steps"] > 0 for f in followers)
    # the follower's replicated state is the leader's
    for f in followers:
        for k in ("tokens", "lengths", "temps"):
            np.testing.assert_array_equal(f["state"][k], leader["state"][k])


def test_the_jax_engine_counts_the_same_sp_prefill(trees):
    """The JAX engine at sp 2 on the same traffic: the same tokens and the
    same ``sp-prefill`` dispatch count as the port's leader."""
    jcfg, jp = trees["mha"]
    from tpumlops.models import partition as JPART

    shape = {"sp": 2}
    engine = JaxEngine(JPART.shard_llama_params(jp, JPART.build_serving_mesh(shape)), jcfg,
                       max_slots=4, dtype=jnp.float64, mesh_shape=shape,
                       sp_prefill_threshold=THRESHOLD)
    futs = [engine.submit(p, n) for p, n, _ in (LONG, SHORT)]
    engine.start(warmup=False)
    try:
        toks = [f.result(timeout=240).tolist() for f in futs]
    finally:
        engine.shutdown()
    leader = _engine_world(trees, "sp2")["whole"][0]
    assert leader["tokens"] == toks
    assert leader["dispatches"]["sp-prefill"] == engine.dispatches_total["sp-prefill"]


def _unsharded(trees, reqs, **kw):
    engine = TG.GenerationEngine(convert.from_jax_numpy(jax.device_get(trees["mha"][1])),
                                 T.LlamaConfig(**CFG_KW), max_slots=4, dtype=torch.float64,
                                 device="cpu", **kw)
    futs = [engine.submit(p, n, **skw) for p, n, skw in reqs]
    engine.start(warmup=False)
    try:
        return [f.result(timeout=120).tolist() for f in futs], engine
    finally:
        engine.shutdown()


def test_sp_int8kv_matches_the_unsharded_int8kv_engine(trees):
    """The ring-prefilled K/V quantizes on insert as the dense-prefilled
    cache does."""
    leader = _engine_world(trees, "sp2")["int8kv"][0]
    want, _ = _unsharded(trees, [INT8KV], kv_quant=True)
    assert leader["tokens"] == want
    assert leader["dispatches"]["sp-prefill"] == 1


def test_prefix_cache_seeds_from_the_ring_write_back(trees):
    """The ring pass writes its two whole chunks of 16 back; the request
    sharing the first one hits the radix cache and both match the
    unsharded streams."""
    leader = _engine_world(trees, "sp2")["prefix"][0]
    assert leader["tokens"] == [_greedy(trees, SHARED, 6), _greedy(trees, FOLLOW, 6)]
    assert leader["dispatches"]["sp-prefill"] >= 1
    assert leader["prefix_hits"] > 0
    assert leader["dispatches"].get("seed", 0) >= 1


def test_packed_admissions_route_long_cold_prompts_to_the_ring(trees):
    leader = _engine_world(trees, "sp2")["packed"][0]
    assert leader["tokens"] == [_greedy(trees, p, n) for p, n, _ in PACKED]
    assert leader["dispatches"]["sp-prefill"] == 2  # the 32- and 20-token prompts
    assert leader["dispatches"].get("packed-prefill", 0) >= 1  # the 10-token one


def test_sp1_keeps_the_dispatch_ledger_of_the_engine_without_a_mesh(trees):
    reqs = [(_prompt(32, 41), 6, {}), (_prompt(8, 42), 4, {})]
    toks_none, e_none = _unsharded(trees, reqs, **SP_KW)
    toks_sp1, e_sp1 = _unsharded(trees, reqs, mesh_shape={"dp": 1, "sp": 1, "tp": 1},
                                 **SP_KW)
    assert e_sp1._mesh is None and e_sp1._sp == 1
    assert toks_sp1 == toks_none
    assert e_sp1.dispatches_total == e_none.dispatches_total
    assert "sp-prefill" not in e_sp1.dispatches_total


@pytest.mark.parametrize("mesh_shape,kw,match", [
    ({"sp": 3}, {}, "sp=3 must be a power of two"),
    ({"sp": 32}, {}, "sp=32 must be a power of two"),
    ({"sp": 4}, {"prefill_chunk": 6}, "sp=4 does not divide the prefill chunk"),
])
def test_unsplittable_sp_is_refused_typed(trees, mesh_shape, kw, match):
    """Refused at construction, before any world or device state (the
    reference's ValueErrors)."""
    params = convert.from_jax_numpy(jax.device_get(trees["mha"][1]))
    with pytest.raises(ValueError, match=match):
        TG.GenerationEngine(params, T.LlamaConfig(**CFG_KW), max_slots=4, dtype=torch.float64,
                            device="cpu", mesh_shape=mesh_shape, **kw)
