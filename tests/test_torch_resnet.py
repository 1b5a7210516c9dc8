"""The port's ResNet (``models/resnet.py`` and the ``resnet-classifier``
flavor) against the JAX package's, on the CPU.

The JAX package draws a ``ResNetConfig.tiny()`` tree, its folded batch
norms are replaced by random scales and biases (so BN is not the
identity), and the tree is carried across with ``convert.from_jax_numpy``.
Both forwards then run on the same float32 NHWC images at 32 x 32 (XLA's
SAME padding is asymmetric at stride 2 on an even side: (2, 3) for the
7 x 7 stem, (0, 1) for a 3 x 3 conv), 33 x 33 (symmetric) and 32 x 45
(one of each, which also holds the H and W pads apart).  Tolerance: 1e-4
relative + 1e-4 of the largest logit, absolute (f32 convolutions on both
sides, summed in another order).  ``fold_batchnorm`` is held to torch's
eval ``BatchNorm`` (1e-5) and to the JAX fold; ``resnet50()`` to the JAX
tree leaf by leaf shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as treg,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    resnet as TR,
)
from tpumlops.models import resnet as JR

JCFG = JR.ResNetConfig.tiny()
TCFG = TR.ResNetConfig.tiny()


def _random_bn(tree, rng):
    """The tree with every folded BN leaf drawn at random."""
    if isinstance(tree, list):
        return [_random_bn(v, rng) for v in tree]
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            c = tree["scale"].shape[0]
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def trees():
    jp = _random_bn(jax.device_get(JR.init(jax.random.key(0), JCFG)),
                    np.random.default_rng(0))
    return jp, convert.from_jax_numpy(jp)


@pytest.mark.parametrize("hw", [(32, 32), (33, 33), (32, 45)])
def test_tiny_forward_against_jax(trees, hw):
    jp, tp = trees
    imgs = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: JR.forward(p, x, JCFG))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(imgs)))
    got = TR.forward(tp, torch.from_numpy(imgs), TCFG)
    assert got.dtype == torch.float32 and got.shape == (2, TCFG.num_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_symmetric_padding_would_shift_the_even_sides(trees, monkeypatch):
    """The check above sees a pixel's shift: ``padding=k // 2`` (symmetric)
    at 32 x 32 gives other logits."""
    jp, tp = trees
    imgs = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 32, 32, 3))
                            .astype(np.float32))
    good = TR.forward(tp, imgs, TCFG)

    def symmetric(x, k, stride):
        return torch.nn.functional.pad(x, [k // 2] * 4)

    monkeypatch.setattr(TR, "_same_pad", symmetric)
    bad = TR.forward(tp, imgs, TCFG)
    assert (bad - good).abs().max() > 1e-2 * good.abs().max()


def test_fold_batchnorm_matches_torch_eval_bn_and_jax():
    rng = np.random.default_rng(0)
    c = 8
    gamma, beta, mean = (rng.normal(size=c).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    x = rng.normal(size=(2, 5, 5, c)).astype(np.float32)
    sb = TR.fold_batchnorm(*(torch.from_numpy(a) for a in (gamma, beta, mean, var)))
    ours = (torch.from_numpy(x) * sb["scale"] + sb["bias"]).numpy()
    bn = torch.nn.BatchNorm1d(c, eps=1e-5).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(gamma))
        bn.bias.copy_(torch.tensor(beta))
        bn.running_mean.copy_(torch.tensor(mean))
        bn.running_var.copy_(torch.tensor(var))
        theirs = bn(torch.tensor(x).reshape(-1, c)).numpy().reshape(ours.shape)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    jsb = JR.fold_batchnorm(*(jnp.asarray(a) for a in (gamma, beta, mean, var)))
    np.testing.assert_allclose(sb["scale"].numpy(), np.asarray(jsb["scale"]), rtol=1e-6)
    np.testing.assert_allclose(sb["bias"].numpy(), np.asarray(jsb["bias"]), rtol=1e-6,
                               atol=1e-6)


def test_resnet50_tree_matches_the_jax_tree_leaf_by_leaf():
    cfg = TR.ResNetConfig.resnet50()
    tp = TR.init(torch.Generator().manual_seed(0), cfg)
    jshape = jax.eval_shape(lambda: JR.init(jax.random.key(0), JR.ResNetConfig.resnet50()))
    t_leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: tuple(t.shape), tp, is_leaf=lambda t: isinstance(t, torch.Tensor)),
        is_leaf=lambda t: isinstance(t, tuple))[0]
    j_leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: tuple(a.shape), jshape),
        is_leaf=lambda t: isinstance(t, tuple))[0]
    assert t_leaves == j_leaves
    n = sum(t.numel() for t in jax.tree.leaves(tp, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert n == sum(int(np.prod(s)) for _, s in j_leaves)
    assert 25_000_000 < n < 26_000_000, n
    # He-normal: the stem's std is sqrt(2 / (7 * 7 * 3)).
    std = float(tp["stem"]["conv"].std())
    assert abs(std / (2 / 147) ** 0.5 - 1) < 0.05


def test_prepare_gives_channels_last_oihw(trees):
    _, tp = trees
    prep = TR.prepare(tp)
    w = prep["stages"][1][0]["conv2"]
    assert w.shape == (16, 16, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(w, tp["stages"][1][0]["conv2"].permute(3, 2, 0, 1))
    assert prep["fc"]["w"] is tp["fc"]["w"]  # non-conv leaves shared


def test_classifier_flavor_computes_in_the_images_dtype(trees):
    jp, tp = trees
    pred = treg.get_builder("resnet-classifier")(tp, cfg=TCFG, image_size=32,
                                                 dtype=torch.bfloat16)
    ex = pred.example_input(2)
    assert ex.shape == (2, 32, 32, 3) and ex.dtype == np.float32
    imgs = np.random.default_rng(2).normal(size=(2, 32, 32, 3))  # float64 in
    out = pred.predict(imgs)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, TR.forward(tp, torch.from_numpy(imgs.astype(np.float32)),
                                               TCFG), rtol=0, atol=0)
    assert pred.metadata == {"image_size": 32, "num_classes": 10}
    with pytest.raises(ValueError, match="H, W, 3"):
        pred.validate({"x": np.zeros((1, 32, 32), np.float32)})
