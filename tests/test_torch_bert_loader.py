"""The port's HuggingFace BERT path (``models/bert.from_torch`` and the
BERT branch of ``server/loader._load_transformers``) against the JAX
package's, with a local ``BertConfig`` and random weights (as
``tests/test_transformers_loader.py`` builds them), on the CPU.

``from_torch`` must give the JAX converter's tree leaf for leaf (float32,
exact), from the model and from its state dict.  The loaders must give the
same bfloat16 leaves, config, metadata and ``hidden_act`` (exact erf for
HF's ``gelu``, tanh for ``gelu_new``; an int8 load keeps the checkpoint's
pin; ``int8kv`` refused).  The port's predictor, computing in f32 on the
bf16 leaves, holds the JAX ``classify`` in f32 on the same leaves within
1e-5 absolute and relative, and its default bf16 predictor picks the same
classes as ``BertForSequenceClassification`` (the JAX test's bar).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    bert as TB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from tpumlops.models import bert as JB
from tpumlops.server import loader as jloader

IDS = np.random.RandomState(0).randint(0, 100, (2, 16)).astype(np.int32)
MASK = np.concatenate([np.ones((2, 12), np.int32), np.zeros((2, 4), np.int32)], axis=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_checkpoint(path, hidden_act="gelu"):
    from transformers import BertConfig, BertForSequenceClassification

    path.mkdir()
    (path / "MLmodel").write_text("flavors:\n  transformers:\n    source_model_name: test\n")
    cfg = BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, max_position_embeddings=64, num_labels=3,
                     hidden_act=hidden_act)
    torch.manual_seed(1)
    model = BertForSequenceClassification(cfg).eval()
    model.save_pretrained(path, safe_serialization=False)
    return model


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    art = tmp_path_factory.mktemp("artifacts") / "hf-bert"
    return art, _hf_checkpoint(art)


def _assert_same_tree(t, j, exact_dtype=None):
    flat_t = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(j)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        b = np.asarray(b)
        if exact_dtype is not None:
            assert a.dtype == exact_dtype and str(b.dtype) == "bfloat16", path
            a, b = a.float().numpy(), b.astype(np.float32)
        else:
            a = a.numpy()
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_from_torch_matches_the_jax_converter(checkpoint):
    _, model = checkpoint
    cfg = TB.BertConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                        intermediate_size=64, max_position_embeddings=64, num_labels=3)
    jcfg = JB.BertConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    tp, jp = TB.from_torch(model, cfg), JB.from_torch(model, jcfg)
    _assert_same_tree(tp, jp)
    assert tp["layers"][0]["attn"]["q"]["w"].is_contiguous()
    _assert_same_tree(TB.from_torch(model.state_dict(), cfg), jp)
    # The bare encoder (no "bert." prefix, no classifier head).
    tb = TB.from_torch(model.bert, cfg)
    assert "classifier" not in tb
    _assert_same_tree(tb, JB.from_torch(model.bert, jcfg))


def test_hf_checkpoint_loads_and_classifies_like_the_jax_loader(checkpoint):
    art, model = checkpoint
    hf_dir = tloader._find_hf_checkpoint(art)
    flavor, tp, tcfg, kwargs, raw = tloader._load_transformers(hf_dir)
    jflavor, jp, jcfg, jkwargs, jraw = jloader._load_transformers(hf_dir)
    assert (flavor, kwargs, raw) == (jflavor, jkwargs, jraw) == (
        "bert-classifier", {}, {"hidden_act": "gelu"})
    assert tcfg.__dict__ == jcfg.__dict__
    _assert_same_tree(tloader._cast_floats(tp, torch.bfloat16), jp, exact_dtype=torch.bfloat16)

    pred = tloader.load_predictor(str(art), device="cpu", dtype=torch.float32)
    jpred = jloader.load_predictor(str(art))
    assert pred.name == jpred.name == "bert-classifier"
    assert pred.metadata == jpred.metadata
    assert pred.metadata["num_labels"] == 3 and pred.metadata["hidden_act"] == "gelu"
    got = pred.predict(input_ids=IDS, attention_mask=MASK).numpy()
    jp32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jp)
    want = np.asarray(jax.jit(lambda p, i, m: JB.classify(p, i, m, cfg=jcfg, dtype=jnp.float32))(
        jp32, jnp.asarray(IDS), jnp.asarray(MASK)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    bf16 = tloader.load_predictor(str(art), device="cpu")
    ours = bf16.predict(input_ids=IDS, attention_mask=MASK).numpy()
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(IDS, dtype=torch.long),
                    attention_mask=torch.tensor(MASK, dtype=torch.long)).logits.numpy()
    assert (ours.argmax(-1) == ref.argmax(-1)).all()


def test_int8_keeps_the_checkpoint_pin_and_int8kv_is_refused(checkpoint, tmp_path):
    art, _ = checkpoint
    q = tloader.load_predictor(str(art), device="cpu", quantize="int8")
    jq = jloader.load_predictor(str(art), quantize="int8")
    assert q.metadata == jq.metadata and q.metadata["hidden_act"] == "gelu"
    with pytest.raises(tloader.ModelLoadError, match="int8kv"):
        tloader.load_predictor(str(art), device="cpu", quantize="int8kv")
    tanh = tmp_path / "hf-bert-tanh"
    _hf_checkpoint(tanh, hidden_act="gelu_new")
    pred = tloader.load_predictor(str(tanh), device="cpu")
    assert pred.metadata["hidden_act"] == jloader.load_predictor(str(tanh)).metadata[
        "hidden_act"] == "gelu_tanh"
    cfg = json.loads((tanh / "config.json").read_text())
    cfg["hidden_act"] = "relu"
    (tanh / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(tloader.ModelLoadError, match="hidden_act"):
        tloader.load_predictor(str(tanh), device="cpu")
