"""Data parallelism (and dp x tp) in the port against the JAX package, in
f64 on the CPU.

The tiny Llama and the traffic of ``torch_world`` (six greedy prompts
over four slots, two seeded sampled ones, the composition's run); the
port's ranks are spawned gloo worlds, the JAX references run here:

- the cache's rows split over dp (each rank holds ``B/dp`` rows), the
  sampling state and the weights replicate;
- ``_free_slot`` balances admissions across the dp row blocks: the port's
  ``pick_free_slot`` against the JAX engine's ``_free_slot`` on one seeded
  sequence of admissions, releases and reservations;
- dp 2 with slot churn, greedy and seeded sampling, whole and chunked
  prompts, and the unified super-step (eager), token for token against the
  JAX engine; the replicated state bit-equal on both ranks and each rank's
  cache rows the tp-1 engine's;
- the composed ``{"dp": 2, "tp": 2}`` mesh, plain, with the full
  composition and on the unified super-step (the program uncaptured, as
  every program at a world above one rank runs).
"""

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
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    partition as TPART,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from tpumlops.models import llama as J
from tpumlops.server.generation import GenerationEngine as JaxEngine

KV_TOL = dict(rtol=1e-5, atol=1e-7)
UNIFIED = dict(unified_step=True, prefill_chunk=8, prefill_batch=2, decode_steps=2)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def model(x64):
    jcfg = J.LlamaConfig(**W.CFG_KW)
    jp = J.init(jax.random.key(0), jcfg, dtype=jnp.float64)
    return jcfg, jp, jax.device_get(jp)


def _as_served(kw: dict) -> dict:
    return {**kw, "seed": kw["seed"] % 2**32} if "seed" in kw else kw


@pytest.fixture(scope="module")
def refs(model):
    """The JAX engine's tokens for every request (four slots, f64)."""
    jcfg, jp, _ = model
    reqs = W.GREEDY + W.SAMPLED + [W.COMPOSITION[0], W.COMPOSITION[-1]]
    engine = JaxEngine(jp, jcfg, max_slots=4, dtype=jnp.float64)
    futs = [engine.submit(p, n, **_as_served(kw)) for p, n, kw in reqs]
    engine.start(warmup=False)
    try:
        out = [f.result(timeout=240).tolist() for f in futs]
    finally:
        engine.shutdown()
    return {W.request_key(p, n, kw): o for (p, n, kw), o in zip(reqs, out)}


def _want(refs, reqs):
    return [refs[W.request_key(p, n, kw)] for p, n, kw in reqs]


_WORLDS: dict = {}


def _world(name, tree):
    if name not in _WORLDS:
        if name == "dp2":
            runs = [({}, W.GREEDY + W.SAMPLED), ({"prefill_chunk": 8}, W.GREEDY + W.SAMPLED),
                    (UNIFIED, W.GREEDY)]
            _WORLDS[name] = W.run(W.engine_case, 2, {"dp": 2}, W.CFG_KW, tree, runs,
                                  timeout=240)
        else:
            runs = [({}, W.GREEDY + W.SAMPLED), (W.composition_kw(), W.COMPOSITION),
                    (UNIFIED, W.GREEDY)]
            _WORLDS[name] = W.run(W.engine_case, 4, {"dp": 2, "tp": 2}, W.CFG_KW, tree, runs,
                                  timeout=300)
    return _WORLDS[name]


def test_dp_cache_rows_shard_and_sampling_state_replicates(model):
    ranks = _world("dp2", model[2])
    cfg = T.LlamaConfig(**W.CFG_KW)
    shapes = TPART.engine_state_shapes(cfg, 4, {"dp": 2})
    for rank in ranks:
        state = rank[0]["state"]
        assert state["cache"][0].shape == shapes["k"] == (2, 2, 4, 64, 16)
        assert state["lengths"].shape == shapes["lengths"] == (4,)
        for k in ("tokens", "lengths", "keys", "temps", "topk", "topp"):
            np.testing.assert_array_equal(state[k], ranks[0][0]["state"][k])


@pytest.mark.parametrize("dp,slots", [(2, 4), (2, 8), (4, 8)])
def test_free_slot_balances_like_the_reference(dp, slots):
    """The same seeded sequence of admissions (the pick becomes occupied),
    releases and reservations through the port's ``pick_free_slot`` and the
    JAX engine's ``_free_slot`` under ``{"dp": dp}``."""
    jcfg = J.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, max_seq=64)
    ref = JaxEngine(J.init(jax.random.key(0), jcfg), jcfg, max_slots=slots,
                    dtype=jnp.float32, mesh_shape={"dp": dp})
    rng = np.random.default_rng(dp * 100 + slots)
    occupied: list = [None] * slots
    reserved: set = set()
    for _ in range(60):
        ref._slots, ref._reserved = list(occupied), set(reserved)
        got = TG.pick_free_slot(occupied, reserved, dp)
        assert got == ref._free_slot()
        move = rng.integers(3)
        busy = [i for i in range(slots) if occupied[i] is not None or i in reserved]
        if move == 0 and got is not None:
            occupied[got] = object()
        elif move == 1 and got is not None:
            reserved.add(got)
        elif busy:
            i = int(rng.choice(busy))
            occupied[i] = None
            reserved.discard(i)
    assert TG.pick_free_slot([None] * 4, set(), 2) == 0


@pytest.mark.parametrize("run,reqs", [(0, W.GREEDY + W.SAMPLED), (1, W.GREEDY + W.SAMPLED),
                                      (2, W.GREEDY)], ids=["whole", "chunked", "unified"])
def test_dp2_engine_matches_the_jax_engine(model, refs, run, reqs):
    leader, follower = _world("dp2", model[2])
    assert leader[run]["tokens"] == _want(refs, reqs)
    assert follower[run]["steps"] > 0
    if run == 2:
        assert leader[run]["dispatches"].get("superstep", 0) > 0


def test_dp2_state_after_replay_is_the_tp1_engines_rows(model):
    leader, follower = _world("dp2", model[2])
    for k in ("tokens", "lengths", "keys", "temps", "topk", "topp"):
        np.testing.assert_array_equal(leader[1]["state"][k], follower[1]["state"][k])
    engine = TG.GenerationEngine(convert.from_jax_numpy(model[2]), T.LlamaConfig(**W.CFG_KW),
                                 max_slots=4, dtype=torch.float64, device="cpu",
                                 prefill_chunk=8)
    engine._dp = 2  # the same admission policy: the same slots take the same requests
    futs = [engine.submit(p, n, **kw) for p, n, kw in W.GREEDY + W.SAMPLED]
    engine.start(warmup=False)
    try:
        [f.result(timeout=120) for f in futs]
    finally:
        engine.shutdown()
    for r, rank in enumerate((leader, follower)):
        for x, full in zip(rank[1]["state"]["cache"], (engine._cache.k, engine._cache.v)):
            np.testing.assert_allclose(x, full[:, 2 * r:2 * r + 2].numpy(), **KV_TOL)


@pytest.mark.parametrize("run,reqs", [(0, W.GREEDY + W.SAMPLED), (1, W.COMPOSITION),
                                      (2, W.GREEDY)], ids=["plain", "composed", "unified"])
def test_dp2_tp2_mesh_matches_the_jax_engine(model, refs, run, reqs):
    ranks = _world("dp2tp2", model[2])
    assert ranks[0][run]["tokens"] == _want(refs, reqs)
    assert [r[run]["steps"] for r in ranks[1:]] == [ranks[1][run]["steps"]] * 3
    for rank in ranks:
        assert rank[run]["state"]["cache"][0].shape == (2, 2, 2, 64, 16)  # [L, B/dp, NKV/tp]
        np.testing.assert_array_equal(rank[run]["state"]["keys"], ranks[0][run]["state"]["keys"])
    if run == 1:
        assert ranks[0][run]["prefix_hits"] >= 1 and ranks[0][run]["spec_verify_ticks"] >= 1
    if run == 2:  # every decode tick a super-step, replayed by every follower
        dispatches = ranks[0][run]["dispatches"]
        assert dispatches.get("superstep", 0) > 0
        assert not {"decode", "multistep", "verify", "packed-prefill"} & set(dispatches)
