"""Tensor parallelism in the port against the JAX package, in f64 on the CPU.

A tiny Llama (2 layers, H 64, 4 heads and 4 KV heads, vocab 128) made once
by the JAX package's ``init`` (and its int8 tree by its quantizer) is the
one tree both sides run.  The port's ranks are spawned gloo worlds
(``torch_world``); the JAX references run here.

- Construction: the default mesh builds no sharded state; pp/ep, an
  indivisible tp or dp and sp > 1 are refused, typed, before any world.
- The sharded forward at tp 2 and 4 (``prefill``, a chunk, two
  ``decode_ragged`` steps, ``verify_ragged``; float, int8 weights and the
  int8 cache) against the JAX forward, logits and every rank's cache
  block; and against the JAX forward run under its own 2-device mesh
  with ``shard_llama_params``.
- The engine at tp 2 (leader + follower over the control channel) with
  slot churn, greedy and seeded sampling, whole and chunked prompts, and
  the full composition (prefix cache, speculation, packed prefill, K 4
  multistep, eager here): token for token against the JAX engine.  After
  a run the replicated state is bit-equal on both ranks and each rank's
  cache block is the tp-1 engine's.
- A served ``{"tp": 2}`` unit (two server processes) answers /generate
  with the tp-1 server's tokens; a follower that is the first rank of a
  host of its own answers the health probe, one that shares the leader's
  host serves no listener; SIGTERM to the leader ends both with 0.
"""

import dataclasses
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

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
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from tpumlops.models import llama as J
from tpumlops.models import partition as JPART
from tpumlops.models import quantization as JQ
from tpumlops.server.generation import GenerationEngine as JaxEngine

ROOT = Path(__file__).resolve().parents[1]
CFG_KW = W.CFG_KW
LOGIT_TOL = dict(rtol=2e-5, atol=2e-6)  # f32 logits, sums in another order
KV_TOL = dict(rtol=1e-5, atol=1e-7)
GREEDY, SAMPLED, COMPOSITION = W.GREEDY, W.SAMPLED, W.COMPOSITION


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def model(x64):
    jcfg = J.LlamaConfig(**CFG_KW)
    jp = J.init(jax.random.key(0), jcfg, dtype=jnp.float64)
    jq = JQ.quantize_llama(jp)
    trees = {"none": (jax.device_get(jp), False), "int8": (jax.device_get(jq), False),
             "int8kv": (jax.device_get(jq), True)}
    return jcfg, jp, jq, trees


# -- construction ----------------------------------------------------------------


def _tiny_torch():
    cfg = T.LlamaConfig(**CFG_KW)
    return T.init(torch.Generator().manual_seed(0), cfg, dtype=torch.float64), cfg


@pytest.mark.parametrize("mesh_shape", [None, {"dp": 1, "tp": 1}, {"tp": 1}])
def test_default_mesh_builds_no_sharded_state(mesh_shape):
    params, cfg = _tiny_torch()
    engine = TG.GenerationEngine(params, cfg, max_slots=2, dtype=torch.float64, device="cpu",
                                 mesh_shape=mesh_shape)
    assert engine._mesh is None and engine._dp == 1 and engine._channel is None
    assert engine._cache.k.shape == (2, 2, 4, 64, 16)
    assert engine._params is params


@pytest.mark.parametrize("mesh_shape,match", [
    ({"pp": 2}, "dp/sp/tp only"),
    ({"ep": 2, "tp": 2}, "dp/sp/tp only"),
    ({"tp": 3}, "tp=3 does not divide"),
    ({"dp": 3}, "dp=3 does not divide maxSlots"),
    ({"sp": 3}, "sp=3 must be a power of two"),
    ({"sp": 32, "dp": 2}, "sp=32 must be a power of two"),
])
def test_unservable_meshes_are_refused_typed(mesh_shape, match):
    params, cfg = _tiny_torch()
    with pytest.raises(ValueError, match=match):
        TG.GenerationEngine(params, cfg, max_slots=4, dtype=torch.float64, device="cpu",
                            mesh_shape=mesh_shape)


@pytest.mark.parametrize("kw", [{"decode_steps": 4}, {"unified_step": True}])
def test_graph_paths_across_ranks_are_refused_on_cuda(monkeypatch, kw):
    """On the card the K-step and unified engines replay CUDA graphs, which
    cannot capture a gloo collective: refused typed at construction, before
    any world or device state (the device is stood in for: no card here)."""
    import types

    monkeypatch.setattr(TG, "resolve_device", lambda device=None: torch.device("cuda"))
    _, cfg = _tiny_torch()
    params = {"embed": types.SimpleNamespace(device=torch.device("cuda"), shape=(128, 64))}
    with pytest.raises(ValueError, match="graph capture across ranks is not yet ported"):
        TG.GenerationEngine(params, cfg, max_slots=4, mesh_shape={"tp": 2}, **kw)


# -- the sharded forward -----------------------------------------------------------

_WORLDS: dict = {}
# The tp 2 world also runs the engine (one spawn): whole and chunked
# prompts with churn and seeded sampling, then the full composition.
ENGINE_RUNS = [({}, GREEDY + SAMPLED), ({"prefill_chunk": 8}, GREEDY + SAMPLED),
               ("composition", COMPOSITION)]


def _world(tp, trees):
    if tp not in _WORLDS:
        if tp == 2:
            runs = [(W.composition_kw() if kw == "composition" else kw, reqs)
                    for kw, reqs in ENGINE_RUNS]
            _WORLDS[tp] = W.run(W.forward_and_engine_case, tp, {"tp": tp}, CFG_KW, trees,
                                trees["none"][0], runs, timeout=240)
        else:
            _WORLDS[tp] = [{"forward": r} for r in W.run(W.forward_case, tp, {"tp": tp},
                                                         CFG_KW, trees, timeout=180)]
    return _WORLDS[tp]


def _forward_world(tp, trees):
    return [r["forward"] for r in _world(tp, trees)]


_jprefill = jax.jit(J.prefill, static_argnums=(2,), static_argnames=("dtype",))
_jforward = jax.jit(J.forward, static_argnums=(3,), static_argnames=("dtype",))
_jinsert = jax.jit(J.insert_sequence)
_jverify = jax.jit(J.verify_ragged, static_argnums=(3,), static_argnames=("dtype", "window"))


def _jdecode():
    def run(*args, **kw):
        prev = J._DECODE_ATTN
        try:
            J._DECODE_ATTN = "xla"
            return J.decode_ragged(*args, **kw)
        finally:
            J._DECODE_ATTN = prev

    return jax.jit(run, static_argnums=(3,), static_argnames=("dtype", "window"))


_JDECODE = _jdecode()
_JREFS: dict = {}


def _jax_case(jcfg, jp, kv):
    """``torch_world.forward_case``'s sequence in the JAX package."""
    key = (id(jp), kv)
    if key in _JREFS:
        return _JREFS[key]
    f64 = jnp.float64
    v = jcfg.vocab_size
    res = {}
    lg, jc = _jprefill(jp, jnp.asarray(W._ids(11, 1, v)), jcfg, dtype=f64)
    res["prefill"], res["seq_k"] = np.asarray(lg), np.asarray(jc.k)
    lg2, _ = _jforward(jp, jnp.asarray(W._ids(5, 2, v)), jc, jcfg, dtype=f64)
    res["chunk"] = np.asarray(lg2)
    cache = J.QuantRaggedKVCache.create(jcfg, 3) if kv else J.RaggedKVCache.create(jcfg, 3, f64)
    for slot, n in ((0, 7), (2, 16)):
        pid = np.zeros((1, 16), np.int32)
        pid[0, :n] = W._ids(n, 10 + slot, v)[0]
        _, s1 = _jprefill(jp, jnp.asarray(pid), jcfg, dtype=f64)
        cache = _jinsert(cache, s1, jnp.int32(slot), jnp.int32(n))
    active = jnp.asarray([True, False, True])
    toks = jnp.asarray([[3], [5], [7]], jnp.int32)
    res["decode"] = []
    for window in (24, 32):
        lg, cache = _JDECODE(jp, toks, cache, jcfg, active, dtype=f64, window=window)
        res["decode"].append(np.asarray(lg))
        toks = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
    vt = jnp.asarray([[3, 9, 4], [5, 1, 2], [7, 7, 8]], jnp.int32)
    lg, cache = _jverify(jp, vt, cache, jcfg, dtype=f64, window=40, active=active)
    res["verify"] = np.asarray(lg)
    res["cache"] = {name: np.asarray(x) for name, x in zip(cache._fields, cache)}
    _JREFS[key] = res
    return res


@pytest.mark.parametrize("tree", ["none", "int8", "int8kv"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_forward_matches_the_reference(model, tp, tree):
    jcfg, jp, jq, trees = model
    ranks = _forward_world(tp, trees)
    ref = _jax_case(jcfg, jq if tree != "none" else jp, trees[tree][1])
    nkv = CFG_KW["num_kv_heads"] // tp
    fields = ("k8", "k_scale", "v8", "v_scale", "lengths") if trees[tree][1] else \
        ("k", "v", "lengths")
    for r, out in enumerate(ranks):
        got = out[tree]
        for k in ("prefill", "chunk", "verify"):
            np.testing.assert_allclose(got[k], ref[k], **LOGIT_TOL, err_msg=f"rank {r} {k}")
        for i in range(2):
            np.testing.assert_allclose(got["decode"][i], ref["decode"][i], **LOGIT_TOL)
        # this rank's heads of the scratch cache and of the ragged cache
        np.testing.assert_allclose(got["seq_k"], ref["seq_k"][:, :, :, r * nkv:(r + 1) * nkv],
                                   **KV_TOL)
        for name, x in zip(fields, got["cache"]):
            want = ref["cache"][name]
            if name != "lengths":
                want = want[:, :, r * nkv:(r + 1) * nkv]
            if x.dtype == np.int8:
                assert np.abs(x.astype(int) - want.astype(int)).max() <= 1, name
            else:
                np.testing.assert_allclose(x, want, **KV_TOL, err_msg=name)
        # every rank holds the same whole logits
        np.testing.assert_array_equal(got["verify"], ranks[0][tree]["verify"])


def test_port_matches_the_reference_forward_under_its_own_mesh(model):
    """The JAX forward under its 2-device mesh, on the tree
    ``shard_llama_params`` placed, against the port's tp 2 ranks."""
    jcfg, jp, _, trees = model
    sharded = JPART.shard_llama_params(jp, JPART.build_serving_mesh({"dp": 1, "tp": 2}))
    lg, _ = _jprefill(sharded, jnp.asarray(W._ids(11, 1, jcfg.vocab_size)), jcfg,
                      dtype=jnp.float64)
    for out in _forward_world(2, trees):
        np.testing.assert_allclose(out["none"]["prefill"], np.asarray(lg), **LOGIT_TOL)


# -- the engine at tp 2 ------------------------------------------------------------

def _engine_world(trees):
    return [r["engine"] for r in _world(2, trees)]


def _as_served(kw: dict) -> dict:
    """The JAX replica serves with x64 off, where ``key(seed)`` keeps the
    seed's low 32 bits (see test_torch_generation.py)."""
    return {**kw, "seed": kw["seed"] % 2**32} if "seed" in kw else kw


@pytest.fixture(scope="module")
def jax_engine_refs(model):
    """The JAX engine's tokens for every request, submitted together
    before its start (four slots, f64)."""
    jcfg, jp, _, _ = model
    engine = JaxEngine(jp, jcfg, max_slots=4, dtype=jnp.float64)
    reqs = GREEDY + SAMPLED + [COMPOSITION[0], COMPOSITION[-1]]
    futs = [engine.submit(p, n, **_as_served(kw)) for p, n, kw in reqs]
    engine.start(warmup=False)
    try:
        out = [f.result(timeout=240).tolist() for f in futs]
    finally:
        engine.shutdown()
    return {W.request_key(p, n, kw): o for (p, n, kw), o in zip(reqs, out)}


def _want(refs, reqs):
    return [refs[W.request_key(p, n, kw)] for p, n, kw in reqs]


@pytest.mark.parametrize("run,reqs", [(0, GREEDY + SAMPLED), (1, GREEDY + SAMPLED),
                                      (2, COMPOSITION)], ids=["whole", "chunked", "composed"])
def test_tp2_engine_matches_the_jax_engine(model, jax_engine_refs, run, reqs):
    leader, follower = _engine_world(model[3])
    assert leader[run]["tokens"] == _want(jax_engine_refs, reqs)
    assert follower[run]["steps"] > 0
    if run == 2:
        assert leader[run]["prefix_hits"] >= 1
        assert leader[run]["spec_verify_ticks"] >= 1
        assert leader[run]["prefill_chunks_dispatched"] > 0
        assert leader[run]["dispatches"].get("multistep", 0) > 0


def test_leader_and_follower_state_are_equal_after_replay(model):
    """Replicated state bit-equal on both ranks; each rank's cache block is
    the tp-1 engine's after the same run."""
    tree = model[3]["none"][0]
    leader, follower = _engine_world(model[3])
    for k in ("tokens", "lengths", "keys", "temps", "topk", "topp"):
        np.testing.assert_array_equal(leader[1]["state"][k], follower[1]["state"][k])
    cfg = T.LlamaConfig(**CFG_KW)
    engine = TG.GenerationEngine(convert.from_jax_numpy(tree), cfg, max_slots=4,
                                 dtype=torch.float64, device="cpu", prefill_chunk=8)
    futs = [engine.submit(p, n, **kw) for p, n, kw in GREEDY + SAMPLED]
    engine.start(warmup=False)
    try:
        [f.result(timeout=120) for f in futs]
    finally:
        engine.shutdown()
    np.testing.assert_array_equal(leader[1]["state"]["lengths"], engine._cache.lengths.numpy())
    nkv = CFG_KW["num_kv_heads"] // 2
    for r, rank in enumerate((leader, follower)):
        for x, full in zip(rank[1]["state"]["cache"], (engine._cache.k, engine._cache.v)):
            np.testing.assert_allclose(x, full[:, :, r * nkv:(r + 1) * nkv].numpy(), **KV_TOL)


# -- a served unit ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(port, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST" if body is not None else "GET", path,
                 json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = T.LlamaConfig(**CFG_KW)
    params = T.init(torch.Generator().manual_seed(3), cfg, dtype=torch.float64)
    return tloader.save_native_model(tmp_path_factory.mktemp("tp") / "tiny", "llama-generate",
                                     params, config=dataclasses.asdict(cfg))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_a_loading_rank_holds_its_blocks_and_one_full_leaf(artifact, monkeypatch, quantize):
    """Each rank of a ``{"dp": 2, "tp": 2}`` mesh loads the artifact leaf by
    leaf: what it places on its device is its block of the full (quantized)
    tree, code for code and byte for byte, and no full leaf the rule table
    cuts is alive when the next leaf is read."""
    import weakref

    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
        parallel as TPAR,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
        partition as TPART,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
        quantization as TQ,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel.mesh import (
        ServingMesh,
    )

    npz_path = artifact / "params.npz"
    cpu = torch.device("cpu")
    full = tloader._read_npz(npz_path, cpu, torch.float64)
    if quantize == "int8":
        full = TQ.quantize_llama(full)
    shape = {"dp": 2, "tp": 2}
    for rank in range(4):
        mesh = ServingMesh(shape=shape, rank=rank, coords={"dp": rank // 2, "tp": rank % 2})
        want = tloader._flatten(TPART.shard_llama_params(full, mesh))
        placed, alive = [], []
        monkeypatch.setattr(tloader, "_place", lambda b, dev: placed.append(b) or b.to(dev))

        def leaves():
            with np.load(npz_path, allow_pickle=False) as npz:
                for key in npz.files:
                    assert all(ref() is None for ref in alive), f"a full leaf outlived {key}"
                    leaf = convert.to_tensor(npz[key], None, torch.float64)
                    spec = TPAR.match_partition_rules(
                        TPART.LLAMA_PARTITION_RULES,
                        {key.replace(tloader._SEP, "/"): leaf})[key.replace(tloader._SEP, "/")]
                    if any(entry is not None for entry in spec):
                        alive.append(weakref.ref(leaf))
                    yield key, leaf
                    del leaf

        stats = {}
        got = tloader._flatten(tloader._blocks("llama-generate", leaves(), mesh, cpu, quantize, stats))
        assert alive and all(ref() is None for ref in alive)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
        assert sorted(b.shape for b in placed) == sorted(w.shape for w in want.values())
        assert (sum(b.numel() * b.element_size() for b in placed)
                == sum(TPART.shard_bytes(w) for w in want.values()))
        assert ("quantize_s" in stats) == (quantize == "int8")


def _unit(artifact, tmp_path, follower_env, follower_port):
    coord = _free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   PYTHONWARNINGS="ignore", JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
        env.pop("LOCAL_RANK", None)
        if rank == 1:
            env.update(follower_env)
        logs.append(tmp_path / f"rank{rank}.log")
        with open(logs[-1], "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{W.PKG}.server", "--model-uri", str(artifact),
                 "--device", "cpu", "--dtype", "float64", "--host", "127.0.0.1",
                 "--port", str(0 if rank == 0 else follower_port), "--metrics-port", "0",
                 "--drain-s", "0", "--prefill-chunk", "8", "--mesh-shape", '{"tp": 2}'],
                cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT))
    serving = re.compile(r"serving model \(llama-generate\) on 127\.0\.0\.1:(\d+)")
    deadline = time.time() + 120
    while not serving.search(logs[0].read_text()):
        if any(p.poll() is not None for p in procs) or time.time() > deadline:
            for p in procs:
                p.kill()
            raise AssertionError(logs[0].read_text() + logs[1].read_text())
        time.sleep(0.1)
    return procs, int(serving.search(logs[0].read_text()).group(1)), logs


def _stop(procs, logs):
    procs[0].send_signal(signal.SIGTERM)
    try:
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0, 0], [lg.read_text()[-2000:] for lg in logs]


BODY = {"prompt_ids": [list(range(2, 20)), [5, 9, 2]], "max_new_tokens": 6}


def test_served_tp2_unit_answers_with_the_tp1_tokens(artifact, tmp_path):
    direct = tapp.build_server(tloader.load_predictor(str(artifact), device="cpu",
                                                      dtype=torch.float64),
                               tapp.ServerConfig(host="127.0.0.1", port=0, prefill_chunk=8,
                                                 dtype="float64", device="cpu"))
    import threading

    threading.Thread(target=direct.serve_forever, daemon=True).start()
    try:
        code, want = _req(direct.server_address[1], "/v2/models/model/generate", BODY)
    finally:
        direct.shutdown_all()
    assert code == 200
    fport = _free_port()
    # The follower is the first rank of a host of its own: it answers the
    # unit's health probe on its port.
    procs, port, logs = _unit(artifact, tmp_path, {"LOCAL_RANK": "0"}, fport)
    try:
        code, got = _req(port, "/v2/models/model/generate", BODY)
        assert code == 200 and got["outputs"] == want["outputs"]
        assert _req(fport, "/v2/health/ready") == (200, {"role": "follower", "ok": True})
        assert _req(port, "/readyz")[0] == 200
    finally:
        _stop(procs, logs)
    assert "model collectives over gloo" in logs[0].read_text()


def test_a_follower_sharing_the_leaders_host_serves_no_listener(artifact, tmp_path):
    fport = _free_port()
    procs, port, logs = _unit(artifact, tmp_path, {}, fport)  # local rank = rank = 1
    try:
        code, got = _req(port, "/v2/models/model/generate", BODY)
        assert code == 200 and [len(o["data"]) for o in got["outputs"]] == [6, 6]
        with pytest.raises(ConnectionRefusedError):
            _req(fport, "/v2/health/ready")
    finally:
        _stop(procs, logs)
