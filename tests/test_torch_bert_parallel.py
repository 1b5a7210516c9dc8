"""BERT and the other predict flavors at a world above one rank, in the
port against the JAX package, on the CPU.

Ranks are spawned gloo worlds (``torch_world``), three in all: ``{"tp":
2}``, ``{"tp": 4}`` and ``{"dp": 2, "tp": 2}``, each running several rank
bodies (``calls_case``).  The JAX references run here, jitted once a shape.

- The sharded ``encode``/``classify`` (``models/bert.py`` with ``mesh=``,
  the tree cut by ``partition.shard_bert_params``) against JAX ``encode``
  / ``classify`` on the same weights: in f64 within ``F64_TOL`` of
  ``tests/test_torch_bert.py``, in f32 within 1e-4 (the bound of
  ``tests/test_models_bert.py``'s sharded case).
- int8: a tp-2 rank's ``q8``/``scale`` leaves, loaded through
  ``load_predictor(mesh_shape=)``, equal the cut of the unsharded
  ``quantize_bert``; the sharded int8 logits equal the one-rank port's bit
  for bit, and lie within ``INT8_TOL`` of JAX's int8 ``classify``.
- Refusals before a weight is read: tp 3 on 4 heads, tp 4 on BERT-base's
  vocab of 30522.
- ResNet-tiny and a linear model are replicated: each rank's answer equals
  one rank's.
- A served ``{"tp": 2}`` BERT unit answers ``/v2/models/.../infer`` with the
  one-rank logits; the follower's op count shows the ``OP_PREDICT`` replay.
- A JAX tp-2 BERT bake restores rank by rank in the port; a port tp-2 int8
  BERT bake reads back in the JAX package.
"""

import dataclasses
import json

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
    bert as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    partition as TPART,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    quantization as TQ,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    resnet as TR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel.mesh import (  # noqa: E501
    placement,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    snapshot as tsnap,
)
from tpumlops.models import bert as J
from tpumlops.models import partition as JPART
from tpumlops.models import quantization as JQ
from tpumlops.parallel import shard_pytree as jshard_pytree
from tpumlops.server import loader as jloader
from tpumlops.server import snapshot as jsnap

from test_torch_bert import F64_TOL, INT8_TOL

F32_TOL = dict(rtol=0, atol=1e-4)  # tests/test_models_bert.py's sharded encode
TP2, TP4, DP2TP2 = {"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2}
CFG_KW = dict(dataclasses.asdict(J.BertConfig.tiny(num_labels=3)))
# The artifact's config pins no hidden_act: the int8 path then serves tanh-GELU.
ART_CFG = {k: v for k, v in CFG_KW.items() if k != "hidden_act"}


class _Linear:
    """A fitted linear classifier as the sklearn builder reads it."""

    def __init__(self):
        rng = np.random.default_rng(5)
        self.coef_ = rng.standard_normal((3, 6))
        self.intercept_ = rng.standard_normal(3)
        self.classes_ = np.arange(3)

    def predict_proba(self, x):  # pragma: no cover - the builder needs the attribute
        raise NotImplementedError


def _inputs(b=3, s=20, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 11:] = 0
    mask[2, :] = 0
    tt = rng.integers(0, 2, (b, s)).astype(np.int32)
    return ids, mask, tt


def _cast(tree, dtype):
    return jax.tree.map(lambda x: x.astype(dtype) if np.issubdtype(x.dtype, np.floating)
                        else x, tree)


_jencode = jax.jit(J.encode, static_argnames=("cfg", "dtype"))
_jclassify = jax.jit(J.classify, static_argnames=("cfg", "dtype"))


def _bits(t):
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return str(t.dtype), bits.numpy()


def _assert_cut(got: dict, full_tree, mesh_shape: dict, rank: int):
    """A rank's flattened tree equals the port's cut of ``full_tree``."""
    world = int(np.prod(list(mesh_shape.values())))
    want = tloader._flatten(TPART.shard_bert_params(full_tree,
                                                    placement(mesh_shape, rank, world)))
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        name, bits = _bits(t)
        assert got[key][0] == name and np.array_equal(got[key][1], bits), f"rank {rank} {key}"


def _served_one_rank(art: str, inputs: dict) -> np.ndarray:
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server.batching import (  # noqa: E501
        apply_seq_pad,
    )

    pred = tloader.load_predictor(art, device="cpu", dtype=torch.float32)
    return pred.predict(**apply_seq_pad(inputs, pred.seq_pad)).numpy()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results, and what the tests compare them with."""
    root = tmp_path_factory.mktemp("bert-parallel")
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg = J.BertConfig.tiny(num_labels=3)
        j64 = jax.device_get(jax.tree.map(lambda x: x.astype(jnp.float64),
                                          J.init(jax.random.key(0), jcfg)))
        j32 = _cast(j64, np.float32)
        q32 = jax.device_get(JQ.quantize_bert(j32))
        ids, mask, tt = _inputs()
        ref = {
            "f64": np.asarray(_jclassify(j64, ids, mask, tt, cfg=jcfg, dtype=jnp.float64)),
            "f64_seq": np.asarray(_jencode(j64, ids, mask, tt, cfg=jcfg,
                                           dtype=jnp.float64)[0]),
            "f32": np.asarray(_jclassify(j32, ids, mask, tt, cfg=jcfg, dtype=jnp.float32)),
            "int8": np.asarray(_jclassify(q32, ids, mask, tt, cfg=jcfg, dtype=jnp.float32)),
        }
    finally:
        jax.config.update("jax_enable_x64", False)
    trees = {"f64": (j64, "float64"), "f32": (j32, "float32"), "int8": (q32, "float32")}
    tcfg = T.BertConfig(**CFG_KW)
    one = {name: T.classify(convert.from_jax_numpy(tree), torch.from_numpy(ids),
                            torch.from_numpy(mask), torch.from_numpy(tt), tcfg,
                            getattr(torch, dt)).numpy()
           for name, (tree, dt) in trees.items()}

    # Artifacts: the tiny BERT (f32), a vocab of 30522, ResNet-tiny, a linear model.
    art = jloader.save_native_model(root / "bert", "bert-classifier", j32, config=ART_CFG)
    big_cfg = dict(ART_CFG, vocab_size=30522)
    big = jloader.save_native_model(
        root / "bert-30522", "bert-classifier",
        jax.device_get(J.init(jax.random.key(1), J.BertConfig(**big_cfg))), config=big_cfg)
    rcfg = TR.ResNetConfig.tiny()
    rtree = TR.init(torch.Generator().manual_seed(3), rcfg)
    rart = tloader.save_native_model(root / "resnet", "resnet-classifier", rtree,
                                     config=dataclasses.asdict(rcfg),
                                     builder_kwargs={"image_size": 32})
    lart = tloader.save_sklearn_model(root / "linear", _Linear(), "sklearn-linear")
    images = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    feats = np.random.default_rng(6).standard_normal((4, 6)).astype(np.float32)
    bert_in = {"input_ids": ids, "attention_mask": mask, "token_type_ids": tt}

    # A JAX tp-2 bake of the f32 tree.
    jsnapdir = root / "jax-snaps"
    placed = jshard_pytree(j32, J.param_logical_axes(j32), JPART.build_serving_mesh(TP2))
    jsnap.write_snapshot(jsnapdir, placed, identity=jsnap.snapshot_identity(str(art), "none", TP2),
                         flavor="bert-classifier", config=ART_CFG, builder_kwargs={})
    psnapdir = root / "port-snaps"
    served = ["--model-uri", str(art), "--model-name", "bert", "--device", "cpu",
              "--dtype", "float32", "--host", "127.0.0.1", "--port", "0",
              "--max-batch-size", "4", "--mesh-shape", json.dumps(TP2)]
    body = {"inputs": [{"name": k, "shape": list(v.shape), "datatype": "INT32",
                        "data": v.ravel().tolist()} for k, v in bert_in.items()]}
    plan = [("POST", "/v2/models/bert/infer", body), ("GET", "/debug/ranks", None)]
    loads = [(str(art), "int8", "float32", None, bert_in),
             (str(rart), "none", "float32", None, {"images": images}),
             (str(lart), "none", "float32", None, {"x": feats}),
             (str(art), "none", "float32", str(jsnapdir), bert_in),
             (str(art), "int8", "float32", str(psnapdir), bert_in),
             (str(art), "int8", "float32", str(psnapdir), bert_in)]
    out = {
        "tp2": W.run(W.calls_case, 2, [
            ("bert_forward_case", (TP2, CFG_KW, trees, (ids, mask, tt))),
            ("load_case", (TP2, loads)),
            ("unit_case", ([(served, plan, None)],))], timeout=240),
        "tp4": W.run(W.calls_case, 4, [
            ("bert_forward_case", (TP4, CFG_KW, trees, (ids, mask, tt))),
            ("load_case", (TP4, [(str(big), "none", "float32", None, bert_in)]))],
            timeout=240),
        "dp2tp2": W.run(W.calls_case, 4, [
            ("bert_forward_case", (DP2TP2, CFG_KW, trees, (ids, mask, tt)))], timeout=240),
    }
    one_rank = {
        "int8": tloader.load_predictor(str(art), quantize="int8", device="cpu",
                                       dtype=torch.float32).predict(**bert_in).numpy(),
        "none": tloader.load_predictor(str(art), device="cpu",
                                       dtype=torch.float32).predict(**bert_in).numpy(),
        # as served: padded onto the sequence buckets (row 2 attends no key,
        # so its uniform average covers the pad keys too)
        "served": _served_one_rank(str(art), bert_in),
        "resnet": tloader.load_predictor(str(rart), device="cpu").predict(images).numpy(),
        "linear": tloader.load_predictor(str(lart), device="cpu").predict(feats).numpy(),
    }
    return {"out": out, "ref": ref, "one": one, "one_rank": one_rank, "q32": q32,
            "j32": j32, "art": str(art), "psnapdir": psnapdir, "jsnapdir": jsnapdir}


@pytest.mark.parametrize("world", ["tp2", "tp4", "dp2tp2"])
def test_sharded_bert_matches_jax(worlds, world):
    ref = worlds["ref"]
    for rank in worlds["out"][world]:
        fwd = rank[0]
        np.testing.assert_allclose(fwd["f64"]["logits"], ref["f64"], **F64_TOL)
        np.testing.assert_allclose(fwd["f64"]["seq"], ref["f64_seq"], **F64_TOL)
        np.testing.assert_allclose(fwd["f32"]["logits"], ref["f32"], **F32_TOL)
        np.testing.assert_allclose(fwd["int8"]["logits"], ref["int8"], **INT8_TOL)


@pytest.mark.parametrize("world", ["tp2", "tp4", "dp2tp2"])
def test_sharded_int8_logits_equal_the_one_rank_port(worlds, world):
    one = worlds["one"]
    for rank in worlds["out"][world]:
        assert np.array_equal(rank[0]["int8"]["logits"], one["int8"])
        # the row-split matrices' activation scales come from a tp pmax
        assert rank[0]["pmax_calls"] > 0


@pytest.mark.parametrize("world", ["tp2", "tp4", "dp2tp2"])
def test_pmax_is_the_max_over_the_tp_group(worlds, world):
    for rank in worlds["out"][world]:
        fwd = rank[0]
        coords = fwd["coords"]
        tp = {"tp2": 2, "tp4": 4, "dp2tp2": 2}[world]
        base = coords.get("dp", 0) * tp  # the tp group's ranks are consecutive
        top = base + tp - 1
        np.testing.assert_array_equal(fwd["pmax"], [top, -base, 3.0])


def test_a_tp2_rank_loads_the_cut_of_the_unsharded_int8_tree(worlds):
    full = TQ.quantize_bert(convert.from_jax_numpy(worlds["j32"]))
    for r, rank in enumerate(worlds["out"]["tp2"]):
        res = rank[1][0]
        assert res["hidden_act"] == "gelu_tanh"
        _assert_cut(res["params"], full, TP2, r)
        assert np.array_equal(res["y"], worlds["one_rank"]["int8"])


@pytest.mark.parametrize("idx,name", [(1, "resnet"), (2, "linear")])
def test_replicated_flavors_answer_as_one_rank(worlds, idx, name):
    for rank in worlds["out"]["tp2"]:
        res = rank[1][idx]
        assert res["y"].shape == worlds["one_rank"][name].shape
        assert np.array_equal(res["y"], worlds["one_rank"][name])


def test_indivisible_geometries_are_refused_before_a_weight_is_read(worlds):
    for rank in worlds["out"]["tp4"]:
        res = rank[1][0]
        assert "vocab size (vocab_size) = 30522" in res["refused"]
        assert res["reads"] == 0
    cfg = T.BertConfig.tiny()
    with pytest.raises(ValueError, match=r"tp=3 does not divide .*\(num_heads\) = 4"):
        TPART.validate_bert_mesh(cfg, {"tp": 3})
    with pytest.raises(tloader.ModelLoadError, match="num_heads"):
        tloader._mesh_for_flavor("bert-classifier", cfg, {"tp": 3})


def test_a_served_tp2_unit_answers_infer_and_the_follower_replays(worlds):
    leader, follower = worlds["out"]["tp2"]
    (infer, ranks), = [u["answers"] for u in leader[2]]
    assert infer[0] == 200, infer
    logits = np.asarray(infer[1]["outputs"][0]["data"], np.float32).reshape(
        infer[1]["outputs"][0]["shape"])
    # f32 partial products summed over tp in another order than one rank's
    np.testing.assert_allclose(logits, worlds["one_rank"]["served"], **F32_TOL)
    assert ranks[0] == 200
    reps = ranks[1]["ranks"]
    assert [r["rank"] for r in reps] == [0, 1]
    # the follower replayed every batch the leader launched: warm-up and the request
    predicts = reps[1]["ops"]["predict"]["count"]
    assert predicts >= 2
    assert reps[1]["flavor"] == "bert-classifier" and reps[1]["ledger"]["total"] > 0
    assert reps[1]["mesh"]["coords"] == {"tp": 1}
    assert follower[2][0]["steps"] >= predicts + 1  # and the report op


def test_a_jax_tp2_bert_bake_restores_rank_by_rank(worlds):
    for r, rank in enumerate(worlds["out"]["tp2"]):
        res = rank[1][3]
        assert res["stats"].get("restore_s") is not None, res["warnings"]
        _assert_cut(res["params"], convert.from_jax_numpy(worlds["j32"]), TP2, r)
        np.testing.assert_allclose(res["y"], worlds["one_rank"]["none"], **F32_TOL)


def _u8(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def test_a_port_tp2_int8_bert_bake_reads_back_in_the_jax_package(worlds):
    art = worlds["art"]
    spath = tsnap.snapshot_path_for(worlds["psnapdir"], art)
    manifest = tsnap.read_manifest(spath)
    assert manifest["flavor"] == "bert-classifier"
    assert manifest["config"]["hidden_act"] == "gelu_tanh"
    assert any("shards" in leaf for leaf in manifest["leaves"])
    back, _ = jsnap.load_snapshot(spath, identity=jsnap.snapshot_identity(art, "int8", TP2),
                                  to_device=False)
    want = tloader._flatten(TQ.quantize_bert(convert.from_jax_numpy(worlds["j32"])))
    got = jloader._flatten(back)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert np.array_equal(_u8(got[key]), _u8(convert.to_numpy(t))), key
    for rank in worlds["out"]["tp2"]:
        cold, warm = rank[1][4], rank[1][5]
        assert "restore_s" not in cold["stats"] and warm["stats"].get("restore_s") is not None
        assert warm["hidden_act"] == "gelu_tanh"
        assert np.array_equal(warm["y"], cold["y"])
        assert np.array_equal(warm["y"], worlds["one_rank"]["int8"])


def test_the_predict_ledger_counts_a_ranks_blocks_and_its_activations():
    """``build_predict_ledger``: the rank's tree by dtype, the forward's
    activations at the largest batch (BERT: I/tp from the word block's rows),
    ResNet's serving copy of its convolutions."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models.registry import (  # noqa: E501
        BUILDERS,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
        device_telemetry as TDT,
    )

    cfg = T.BertConfig.tiny(num_labels=3)
    full = T.init(torch.Generator().manual_seed(0), cfg)
    block = TPART.shard_bert_params(full, placement(TP2, 1, 2))
    pred = BUILDERS["bert-classifier"](block, cfg=cfg, dtype=torch.float32)
    led = TDT.build_predict_ledger(pred, 4)
    assert led.components["weights_float32"] == sum(
        t.numel() * 4 for t in tloader._flatten(block).values())
    seq = cfg.max_position_embeddings
    assert led.components["activations"] == 4 * 4 * seq * 3 * (
        cfg.hidden_size + cfg.intermediate_size // 2)
    rcfg = TR.ResNetConfig.tiny()
    rtree = TR.init(torch.Generator().manual_seed(3), rcfg)
    rpred = BUILDERS["resnet-classifier"](rtree, cfg=rcfg, image_size=32)
    rled = TDT.build_predict_ledger(rpred, 2)
    convs = sum(t.numel() * 4 for k, t in tloader._flatten(rtree).items()
                if k.split("|")[-1] in TR._CONV_KEYS)
    assert rled.components["prepared_convs"] == convs > 0
    assert rled.components["activations"] == 4 * 6 * 2 * 16 * 16 * rcfg.width
    assert rled.device_total() == sum(rled.components.values())


def test_the_ring_ledger_term_appears_at_sp_above_one():
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
        llama as TL,
    )
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
        device_telemetry as TDT,
    )

    cfg = TL.LlamaConfig(**W.CFG_KW)
    params = TL.init(torch.Generator().manual_seed(0), cfg)
    for shape in (None, TP2, {"dp": 2, "tp": 2}):
        assert "ring_activations" not in TDT.build_hbm_ledger(
            params, cfg, 4, mesh_shape=shape).components
    sp = {"sp": 2, "tp": 2}
    got = TDT.build_hbm_ledger(params, cfg, 4, dtype_bytes=2, mesh_shape=sp).components
    rows = cfg.max_seq // 2
    kv = 2 * cfg.num_layers * (cfg.num_kv_heads // 2) * cfg.head_dim * 2 * (rows + 2 * cfg.max_seq)
    act = 4 * rows * 3 * (cfg.intermediate_size // 2 + (cfg.num_heads // 2) * cfg.head_dim
                          + cfg.hidden_size)
    assert got["ring_activations"] == kv + act == TDT.ring_activation_bytes(cfg, cfg.max_seq,
                                                                             sp, 2)
