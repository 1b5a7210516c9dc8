"""The warm pool as a unit of several ranks, on the CPU: one spawned gloo
world of ``{"tp": 2}`` (``torch_world.unit_case``) serving three units in
turn, as the app runs them (``form_unit``, the leader's ``build_server``,
the follower's ``run_follower``).  Counterparts: ``tests/test_warm_pool.py``
and ``tests/test_torch_warm_pool.py`` at one rank.

- A ``--warm-pool`` unit boots weightless (``/readyz`` 503 ``warm-pool``);
  an attach that fails on the follower only (its first block read raises)
  answers 500 and leaves every rank in the warm pool; a second attach of
  the tiny Llama succeeds, and its f64 greedy tokens equal a cold unit's
  and the JAX engine's.
- A ``replace`` from the Llama to a BERT sends ``OP_DETACH``, never
  ``OP_SHUTDOWN``: the follower lives on, replays the BERT's batches, and
  its logits equal one rank's.
- A second warm-pool unit prewarms on its blocks of the first one's
  sharded snapshot and restores it at its attach: the same tokens.
- A unit across hosts (``LOCAL_WORLD_SIZE`` below the world) is refused,
  typed, before its process group forms.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world as W
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    loader as tloader,
)
from tpumlops.models import bert as JB
from tpumlops.models import llama as J
from tpumlops.server import loader as jloader
from tpumlops.server.generation import GenerationEngine as JaxEngine

from test_torch_bert import F64_TOL

TP2 = {"tp": 2}
PROMPTS = [([5, 9, 2], 6), (list(range(2, 23)), 7), ([11, 3], 4)]
GEN = "/v2/models/llm/generate"


def _argv(uri: str, snapdir: str | None, warm: bool) -> list:
    argv = ["--model-uri", uri, "--model-name", "llm", "--device", "cpu",
            "--dtype", "float64", "--host", "127.0.0.1", "--port", "0",
            "--max-slots", "2", "--max-batch-size", "4", "--mesh-shape", json.dumps(TP2)]
    if snapdir:
        argv += ["--snapshot-dir", snapdir]
    return argv + (["--warm-pool", "1"] if warm else [])


def _gen(prompt, n):
    return ("POST", GEN, {"prompt_ids": prompt, "max_new_tokens": n})


@pytest.fixture(scope="module")
def unit(tmp_path_factory):
    root = tmp_path_factory.mktemp("warm-pool-unit")
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg = J.LlamaConfig(**W.CFG_KW)
        jp = J.init(jax.random.key(0), jcfg, dtype=jnp.float64)
        engine = JaxEngine(jp, jcfg, max_slots=2, dtype=jnp.float64)
        futs = [engine.submit(p, n) for p, n in PROMPTS]
        engine.start(warmup=False)
        try:
            jax_tokens = [f.result(timeout=240).tolist() for f in futs]
        finally:
            engine.shutdown()
        llama = jloader.save_native_model(root / "llama", "llama-generate", jax.device_get(jp),
                                          config=dataclasses.asdict(jcfg),
                                          builder_kwargs={"eos_id": -1})
        bcfg = JB.BertConfig.tiny(num_labels=3)
        btree = jax.device_get(jax.tree.map(lambda x: x.astype(jnp.float64),
                                            JB.init(jax.random.key(2), bcfg)))
        bert = jloader.save_native_model(root / "bert", "bert-classifier", btree,
                                         config=dataclasses.asdict(bcfg))
    finally:
        jax.config.update("jax_enable_x64", False)
    ids = np.random.default_rng(3).integers(0, 512, (2, 16)).astype(np.int32)
    infer = {"inputs": [{"name": "input_ids", "shape": list(ids.shape), "datatype": "INT32",
                         "data": ids.ravel().tolist()}]}
    snapdir = str(root / "snaps")
    gens = [_gen(p, n) for p, n in PROMPTS]
    warm_plan = ([("GET", "/readyz", None), ("GET", "/debug/ranks", None),
                  ("POST", "/admin/attach", {"model_uri": str(llama)}),
                  ("GET", "/readyz", None),
                  ("POST", "/admin/attach", {"model_uri": str(llama)})]
                 + gens
                 + [("POST", "/admin/attach", {"model_uri": str(bert), "replace": True}),
                    ("POST", "/v2/models/llm/infer", infer),
                    ("GET", "/debug/ranks", None)])
    units = [(_argv(str(llama), snapdir, True), warm_plan, 1),
             (_argv(str(llama), None, False), gens, None),
             (_argv(str(llama), snapdir, True),
              [("POST", "/admin/attach", {"model_uri": str(llama)})] + gens, None)]
    leader, follower = W.run(W.calls_case, 2, [("unit_case", (units,))], timeout=300)
    pred = tloader.load_predictor(str(bert), device="cpu", dtype=torch.float64)
    one_rank = pred.predict(torch.from_numpy(ids)).numpy()
    return {"leader": [u["answers"] for u in leader[0]],
            "follower": [u["steps"] for u in follower[0]],
            "jax_tokens": jax_tokens, "bert_one_rank": one_rank}


def _tokens(answers):
    out = []
    for code, body in answers:
        assert code == 200, body
        out.append(body["outputs"][0]["data"])
    return out


def test_a_warm_pool_unit_boots_weightless(unit):
    warm = unit["leader"][0]
    (code, ready), (rcode, ranks) = warm[0], warm[1]
    assert code == 503 and ready["lifecycle"] == "warm-pool"
    assert rcode == 200
    reps = ranks["ranks"]
    assert [r["rank"] for r in reps] == [0, 1]
    assert all("ledger" not in r for r in reps)  # nothing attached on any rank


def test_an_attach_that_fails_on_the_follower_leaves_every_rank_in_the_warm_pool(unit):
    warm = unit["leader"][0]
    (code, body), (rcode, ready), (acode, attached) = warm[2], warm[3], warm[4]
    assert code == 500 and "another rank" in body["error"], body
    assert rcode == 503 and ready["lifecycle"] == "warm-pool"
    assert acode == 200 and attached["lifecycle"] == "ready", attached


def test_attached_tokens_equal_a_cold_unit_and_the_jax_engine(unit):
    warm = _tokens(unit["leader"][0][5:5 + len(PROMPTS)])
    cold = _tokens(unit["leader"][1])
    assert warm == cold == unit["jax_tokens"]


def test_a_replace_detaches_and_the_follower_lives_on(unit):
    warm = unit["leader"][0]
    (code, body), (icode, infer), (rcode, ranks) = warm[-3], warm[-2], warm[-1]
    assert code == 200 and body["lifecycle"] == "ready", body
    assert icode == 200, infer
    out = infer["outputs"][0]
    logits = np.asarray(out["data"], np.float64).reshape(out["shape"])
    np.testing.assert_allclose(logits, unit["bert_one_rank"], **F64_TOL)
    ops = ranks["ranks"][1]["ops"]
    # three attaches (the failed one, the Llama, the BERT); the failed
    # attach's release and the replace: two detaches, no shutdown
    assert ops["detach"]["count"] == 2 and ops["attach"]["count"] == 3
    assert "shutdown" not in ops
    assert ops["predict"]["count"] >= 1  # the follower replays the BERT's batches
    assert ranks["ranks"][1]["flavor"] == "bert-classifier"
    # the follower left its loop only at the unit's own shutdown
    assert unit["follower"][0] > sum(v["count"] for v in ops.values())


def test_a_second_warm_pool_unit_prewarms_and_restores_the_sharded_snapshot(unit):
    (code, body), *gens = unit["leader"][2]
    assert code == 200 and body["restored"] is True, body
    assert _tokens(gens) == unit["jax_tokens"]


@pytest.mark.parametrize("local,world_shape", [("1", TP2), ("2", {"dp": 2, "tp": 2})])
def test_a_warm_pool_unit_across_hosts_is_refused(tmp_path, monkeypatch, local, world_shape):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    conf = tapp.ServerConfig(mesh_shape=world_shape, warm_pool=True,
                             snapshot_dir=str(tmp_path))
    with pytest.raises(ValueError, match="--warm-pool is single-host only"):
        tapp.form_unit(conf)


# -- the follower's engines and the leader's pipelined launches (threads, no world) --

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models.registry import (  # noqa: E402,E501
    Predictor,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E402,E501
    multihost as TM,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.engine import (  # noqa: E402,E501
    InferenceEngine,
)


class _Scripted:
    is_leader = False

    def __init__(self, messages):
        self._messages = list(messages)

    def broadcast(self, payload):
        return self._messages.pop(0)


def _engine(factor: float):
    return InferenceEngine(Predictor(name="scale", predict=lambda x: x * factor), 4)


def test_a_follower_swaps_its_engines_on_attach_and_detach():
    """OP_ATTACH builds through ``attach_fn``, OP_DETACH releases; a predict
    with nothing attached is logged and the loop goes on; only OP_SHUTDOWN
    ends it."""
    calls = []

    def attach_fn(model_uri):
        calls.append(("attach", model_uri))
        return _engine(2.0 if model_uri == "a" else 3.0), None

    def release_fn(engine, gen):
        calls.append(("release", engine is not None))

    engines = TM.FollowerEngines(attach_fn=attach_fn, release_fn=release_fn)
    x = {"x": np.ones((1, 2), np.float32)}
    msgs = [TM.encode_message(TM.OP_ATTACH, {"model_uri": "a"}),
            TM.encode_message(TM.OP_PREDICT, x),
            TM.encode_message(TM.OP_DETACH),
            TM.encode_message(TM.OP_PREDICT, x),  # nothing attached: logged, loop goes on
            TM.encode_message(TM.OP_ATTACH, {"model_uri": "b"}),
            TM.encode_message(TM.OP_PREDICT, x),
            TM.encode_message(TM.OP_SHUTDOWN)]
    stats = {}
    steps = TM.follower_loop(None, _Scripted(msgs), stats=stats, engines=engines)
    assert steps == 6
    assert [c[0] for c in calls] == ["release", "attach", "release", "release", "attach"]
    assert engines.engine is not None and engines.engine.dispatches == 1
    assert stats["attach"][0] == 2 and stats["detach"][0] == 1 and stats["predict"][0] == 3


def test_the_leader_broadcasts_batches_in_launch_order():
    """The batcher's launches (``predict_async``) reach the followers in the
    order the leader launched them, and ``materialize`` runs on the leader
    alone."""
    group = TM._LocalGroup(2)
    leader_t, follower_t = group.transports()
    seen = []

    def record(x):
        seen.append(float(np.asarray(x).ravel()[0]))
        return x

    follower = InferenceEngine(Predictor(name="rec", predict=record), 4)
    done = {}
    th = threading.Thread(target=lambda: done.setdefault(
        "steps", TM.follower_loop(follower, follower_t)), daemon=True)
    th.start()
    leader = TM.MultihostEngine(_engine(1.0), leader_t)
    outs = [leader.predict_async({"x": np.full((1, 2), float(i), np.float32)})
            for i in range(5)]
    got = [float(leader.materialize(o).ravel()[0]) for o in outs]
    leader.shutdown()
    th.join(timeout=30)
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0] and seen == got
    assert done["steps"] == 5 and leader.dispatches == 5
