"""Port BERT against the JAX package's BERT, in float64 on the CPU.

Weights are made once by the JAX package's ``init`` (cast to f64) and
carried across by ``convert.from_jax_numpy``, so both sides run the same
tree.  JAX runs in f64 behind a module fixture (restored after).  Both
packages round the attention scores to f32 (``preferred_element_type``)
and normalize in f32, so float logits agree to f32 rounding.  The int8
path runs the same int8 weights on both sides; the reference quantizes
the activations under jit (``* (1/127)``), the port eagerly (``/ 127``),
so an activation code can sit one step apart and the int8 tolerance is
wider (stated at the check).
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
    bert as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    common as TC,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    quantization as TQ,
)
from tpumlops.models import bert as J
from tpumlops.models import common as JC
from tpumlops.models import quantization as JQ

# f32 rounding of differently ordered sums, through two layers.
F64_TOL = dict(rtol=1e-5, atol=1e-6)
# int8: on these inputs no activation code moved and the logits agreed to
# 6e-8; 2e-3 absolute (logits ~0.5 here) leaves room for codes one step
# apart between the jitted and the eager activation scale.
INT8_TOL = dict(rtol=0, atol=2e-3)


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


_jencode = jax.jit(J.encode, static_argnames=("cfg", "dtype"))
_jclassify = jax.jit(J.classify, static_argnames=("cfg", "dtype"))


@functools.lru_cache(maxsize=None)
def _models(act="gelu", quant=False, seed=0):
    jcfg = J.BertConfig.tiny(num_labels=3, hidden_act=act)
    tcfg = T.BertConfig.tiny(num_labels=3, hidden_act=act)
    jp = jax.tree.map(lambda x: x.astype(jnp.float64), J.init(jax.random.key(seed), jcfg))
    if quant:
        jp = JQ.quantize_bert(jp)
    tp = convert.from_jax_numpy(jax.device_get(jp))
    return jcfg, tcfg, jp, tp


def _inputs(b=3, s=20, seed=1, masks=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (b, s)).astype(np.int32)
    if not masks:
        return ids, None, None
    mask = np.ones((b, s), np.int32)
    mask[1, 11:] = 0   # ragged
    mask[2, :] = 0     # nothing attended: BERT averages V uniformly
    tt = rng.integers(0, 2, (b, s)).astype(np.int32)
    return ids, mask, tt


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_config_matches_the_reference():
    assert T.BertConfig.base() == T.BertConfig(**J.BertConfig.base().__dict__)
    assert T.BertConfig.tiny() == T.BertConfig(**J.BertConfig.tiny().__dict__)
    assert T.BertConfig.base().head_dim == 64


def test_init_shapes_match_the_reference_tree():
    cfg = T.BertConfig.tiny()
    tp = T.init(torch.Generator().manual_seed(0), cfg)
    jp = J.init(jax.random.key(0), J.BertConfig.tiny())
    tshapes = jax.tree.map(lambda x: tuple(x.shape), convert.from_jax_numpy(jax.device_get(jp)))
    assert jax.tree.map(lambda x: tuple(x.shape), tp) == tshapes
    ids = torch.ones((2, 16), dtype=torch.int64)
    seq, pooled = T.encode(tp, ids, cfg=cfg)
    assert seq.shape == (2, 16, cfg.hidden_size) and pooled.shape == (2, cfg.hidden_size)
    assert T.classify(tp, ids, cfg=cfg).shape == (2, cfg.num_labels)


@pytest.mark.parametrize("masks", [True, False], ids=["ragged_masks_token_types", "no_masks"])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
def test_encode_and_classify_match_jax(act, masks):
    jcfg, tcfg, jp, tp = _models(act)
    ids, mask, tt = _inputs(masks=masks)
    jseq, jpooled = _jencode(jp, _j(ids), _j(mask), _j(tt), cfg=jcfg, dtype=jnp.float64)
    tseq, tpooled = T.encode(tp, _t(ids), _t(mask), _t(tt), cfg=tcfg, dtype=torch.float64)
    assert tseq.dtype == torch.float64
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), **F64_TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(jpooled), **F64_TOL)
    jl = _jclassify(jp, _j(ids), _j(mask), _j(tt), cfg=jcfg, dtype=jnp.float64)
    tl = T.classify(tp, _t(ids), _t(mask), _t(tt), cfg=tcfg, dtype=torch.float64)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F64_TOL)


def test_int8_classify_matches_jax():
    jcfg, tcfg, jp, tp = _models("gelu_tanh", quant=True)
    ids, mask, tt = _inputs(b=4, s=32, seed=3)
    jl = _jclassify(jp, _j(ids), _j(mask), _j(tt), cfg=jcfg, dtype=jnp.float64)
    tl = T.classify(tp, _t(ids), _t(mask), _t(tt), cfg=tcfg, dtype=torch.float64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **INT8_TOL)
    assert (tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()


def test_quantize_bert_codes_match_the_eager_reference():
    """Port ``quantize_bert`` divides by 127 as the eager reference
    ``quantize_tensor`` does: q8 and scales bit-identical, and only the
    six layer matrices quantized (biases, norms, embeddings, pooler and
    classifier untouched)."""
    _, _, jp, tp = _models()
    q = TQ.quantize_bert(tp)
    for jl, tl in zip(jp["layers"], q["layers"]):
        for group, name in TQ._BERT_LAYER_MATS:
            want = JQ.quantize_tensor(jl[group][name]["w"])  # eager
            got = tl[group][name]["w"]
            assert TQ.is_quantized(got)
            np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
            np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
            assert torch.equal(tl[group][name]["b"], convert.to_tensor(np.asarray(jl[group][name]["b"])))
        assert torch.equal(tl["attn"]["ln"]["scale"], convert.to_tensor(np.asarray(jl["attn"]["ln"]["scale"])))
    assert q["embeddings"] is tp["embeddings"]
    assert not TQ.is_quantized(q["pooler"]["w"]) and not TQ.is_quantized(q["classifier"]["w"])
    assert not TQ.is_quantized(tp["layers"][0]["attn"]["q"]["w"])  # input untouched


@pytest.mark.parametrize("rows", [1, 16, 37])
def test_dense_q8_int32_product_is_exact(rows):
    """Activation codes from the eager reference, an int32 product equal to
    the exact integer product, and the reference's f32 rescale."""
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 24)).astype(np.float32) * 3
    w = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    qw = JQ.quantize_tensor(jnp.asarray(w))
    qa = JQ.quantize_tensor(jnp.asarray(x), axis=-1)
    exact = np.asarray(qa["q8"], np.int64) @ np.asarray(qw["q8"], np.int64)
    want = (exact.astype(np.float32) * np.asarray(qa["scale"])
            * np.asarray(qw["scale"]).reshape(-1) + b).astype(np.float32)
    tqw = convert.from_jax_numpy(jax.device_get(qw))
    got = TQ.dense_q8(torch.from_numpy(x), tqw, torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    i32 = TQ._int_mm(convert.to_tensor(np.asarray(qa["q8"])), tqw["q8"])
    assert i32.dtype == torch.int32
    np.testing.assert_array_equal(i32.numpy(), exact)


def test_common_blocks_match_the_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 32)) * 4
    scale, bias = rng.standard_normal(32), rng.standard_normal(32)
    w = rng.standard_normal((32, 12))
    np.testing.assert_allclose(
        TC.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias)).numpy(),
        np.asarray(jax.jit(JC.layer_norm)(x, scale, bias)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        TC.dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale[:12])).numpy(),
        np.asarray(jax.jit(JC.dense)(x, w, scale[:12])), rtol=1e-6, atol=1e-6)
    for tf, jf in ((TC.gelu, JC.gelu), (TC.gelu_tanh, JC.gelu_tanh)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax.jit(jf)(x)), rtol=1e-12, atol=1e-12)
    table = rng.standard_normal((10, 4))
    ids = np.array([[1, 9], [0, 3]])
    np.testing.assert_array_equal(
        TC.take_embedding(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(JC.take_embedding(table, ids)))
