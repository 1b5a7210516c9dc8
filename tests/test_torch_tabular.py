"""The port's tabular models (``models/tabular.py`` and the forest,
xgboost and pyfunc flavors of ``models/registry.py``) against the JAX
package's, on the CPU.

Every case of the JAX package's ``tests/test_models_tabular.py`` is here:
each forest is converted by both packages from the same sklearn model or
xgboost JSON (the JSON builders are that file's own), the flattened arrays
must be equal leaf for leaf, and each evaluation form is held to the JAX
function (jitted, once a shape) on the same float32 rows, and to sklearn
or an independent recursive traversal with xgboost's strict ``<``.

Tolerances: the gather traversal picks the same leaves as JAX, so its sums
agree within 1e-6 on the small forests and 1e-5 relative + 1e-5 absolute
on sklearn's (20 f32 leaves of magnitude ~100 summed in another order:
one f32 ulp there is ~8e-6); the product form within
1e-6 of the gather form on the rows that sit exactly on a split and on NaN
rows (the reference's bar), 1e-5 for multi-class margins; sklearn within
1e-4 relative + 1e-3 absolute (its f64 thresholds against f32 ones, the
reference's bar); probabilities within 1e-5 relative + 1e-6 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models_tabular import (
    _multiclass_model,
    _ref_eval_one,
    _two_tree_model,
)

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as treg,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    tabular as TT,
)
from tpumlops.models import registry as jreg
from tpumlops.models import tabular as JT


def _J_GATHER(jtrees, x):
    """The JAX gather traversal, jitted (once a forest and shape)."""
    return jax.jit(lambda v: JT.eval_forest(jtrees, v))(x)


def _J_GEMM(jgf, x):
    return jax.jit(lambda v: JT.eval_forest_gemm(jgf, v))(x)


def _same_arrays(t: TT.TreeArrays, j: JT.TreeArrays) -> None:
    for name in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (t.max_depth, t.base_score, t.n_features, t.n_groups) == (
        j.max_depth, j.base_score, j.n_features, j.n_groups)
    if j.tree_group is None:
        assert t.tree_group is None
    else:
        np.testing.assert_array_equal(t.tree_group.numpy(), np.asarray(j.tree_group))


def _gather(trees, X):
    return TT.eval_forest(trees, torch.from_numpy(X)).numpy()


def _gemm(gf, X):
    return TT.eval_forest_gemm(gf, torch.from_numpy(X)).numpy()


@pytest.fixture(scope="module")
def regression():
    from sklearn.datasets import make_regression

    X, y = make_regression(n_samples=200, n_features=8, random_state=0)
    return X, y


@pytest.mark.parametrize("kind", ["random_forest", "gradient_boosting"])
def test_sklearn_forests_against_jax_and_sklearn(kind, regression):
    from sklearn.ensemble import GradientBoostingRegressor, RandomForestRegressor

    X, y = regression
    if kind == "random_forest":
        sk = RandomForestRegressor(n_estimators=12, max_depth=6, random_state=0).fit(X, y)
    else:
        sk = GradientBoostingRegressor(n_estimators=20, max_depth=3, random_state=1).fit(X, y)
    trees, jtrees = TT.from_sklearn_forest(sk), JT.from_sklearn_forest(sk)
    _same_arrays(trees, jtrees)
    x32 = X.astype(np.float32)
    got = _gather(trees, x32)
    np.testing.assert_allclose(got, np.asarray(_J_GATHER(jtrees, jnp.asarray(x32))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, sk.predict(X), rtol=1e-4, atol=1e-3)
    gf = TT.to_gemm(trees)
    np.testing.assert_allclose(_gemm(gf, x32), got, rtol=1e-6, atol=1e-4)


def test_pyfunc_fallback_tier():
    p = TT.PyFuncPredictor(lambda x: x.sum(axis=1))
    np.testing.assert_allclose(p(np.ones((3, 4))), [4.0, 4.0, 4.0])
    np.testing.assert_allclose(p(torch.ones((2, 4))), [4.0, 4.0])
    assert p.jittable is False
    pred = treg.get_builder("pyfunc")(p)
    assert pred.jittable is False and pred.predict is p
    wrapped = treg.get_builder("pyfunc")(type("M", (), {"predict": lambda self, x: x * 2})())
    np.testing.assert_allclose(wrapped.predict(np.ones((1, 2))), [[2.0, 2.0]])


def test_flavors_equal_the_reference():
    assert treg.list_flavors() == jreg.list_flavors()
    with pytest.raises(KeyError, match="unknown model flavor"):
        treg.get_builder("nope")


def test_models_star_import_works():
    ns = {}
    exec("from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"
         ".models import *", ns)
    assert {"llama", "registry", "tabular", "linear", "resnet", "bert"} <= set(ns)


def test_xgboost_json_matches_reference_traversal():
    model, trees_json = _two_tree_model()
    trees, objective = TT.from_xgboost_json(model)
    jtrees, _ = JT.from_xgboost_json(model)
    assert objective == "reg:squarederror" and trees.n_features == 3
    _same_arrays(trees, jtrees)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)).astype(np.float32) * 2
    X[0] = [1.5, 0.25, -0.5]  # on every split: strict < goes right
    X[1] = [1.5 - 1e-6, 0.25 - 1e-6, -0.5 - 1e-6]
    expected = np.array([sum(_ref_eval_one(t, row) for t in trees_json) + 0.5 for row in X],
                        np.float32)
    got = _gather(trees, X)
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(_J_GATHER(jtrees, jnp.asarray(X))),
                               rtol=1e-6, atol=1e-6)
    assert got[0] == 3.0 + 1.0 + 0.5 and got[1] == 10.0 + (-1.0) + 0.5
    # The json text parses the same.
    import json

    _same_arrays(TT.from_xgboost_json(json.dumps(model))[0], jtrees)


def test_xgboost_binary_logistic_applies_sigmoid_and_logit_base():
    model, trees_json = _two_tree_model(objective="binary:logistic", base_score="0.2")
    pred = treg.get_builder("xgboost")(model, device="cpu")
    jpred = jreg.get_builder("xgboost")(model)
    assert pred.jittable and pred.metadata == jpred.metadata
    assert pred.metadata["objective"] == "binary:logistic"
    X = np.array([[0.0, 1.0, 0.0], [2.0, -1.0, 0.0]], np.float32)
    margin = np.array([sum(_ref_eval_one(t, row) for t in trees_json) for row in X]) + np.log(
        0.2 / 0.8)
    got = pred.predict(X).numpy()
    np.testing.assert_allclose(got, 1.0 / (1.0 + np.exp(-margin)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jpred.predict(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["gblinear", "tree_info", "num_class", "vector_leaf",
                                  "no_learner", "no_trees"])
def test_xgboost_refusals_match_the_reference(case):
    if case == "gblinear":
        model, _ = _two_tree_model()
        model["learner"]["gradient_booster"]["name"] = "gblinear"
        err, needle = NotImplementedError, "gblinear"
    elif case == "tree_info":
        model, _, _ = _multiclass_model()
        model["learner"]["gradient_booster"]["model"]["tree_info"] = [0, 1]
        err, needle = ValueError, "tree_info"
    elif case == "num_class":
        model, _, _ = _multiclass_model()
        model["learner"]["learner_model_param"]["num_class"] = "0"
        err, needle = ValueError, "num_class"
    elif case == "vector_leaf":
        model, _, _ = _multiclass_model()
        model["learner"]["gradient_booster"]["model"]["trees"][0]["tree_param"][
            "size_leaf_vector"] = "3"
        err, needle = NotImplementedError, "vector-leaf"
    elif case == "no_learner":
        model, err, needle = {"version": [2, 0, 0]}, ValueError, "learner"
    else:
        model, _ = _two_tree_model()
        model["learner"]["gradient_booster"]["model"]["trees"] = []
        err, needle = ValueError, "no trees"
    with pytest.raises(err, match=needle):
        JT.from_xgboost_json(model)
    with pytest.raises(err, match=needle):
        TT.from_xgboost_json(model)


@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_xgboost_multiclass_against_reference_and_jax(objective):
    model, trees_json, info = _multiclass_model(objective=objective)
    trees, got_objective = TT.from_xgboost_json(model)
    jtrees, _ = JT.from_xgboost_json(model)
    assert got_objective == objective and trees.n_groups == 3
    _same_arrays(trees, jtrees)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(32, 4)).astype(np.float32)
    margins = np.full((32, 3), 0.5, np.float32)  # base_score a class
    for t, k in zip(trees_json, info):
        for b, row in enumerate(X):
            margins[b, k] += _ref_eval_one(t, row)
    np.testing.assert_allclose(_gather(trees, X), margins, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_gather(trees, X), np.asarray(_J_GATHER(jtrees, jnp.asarray(X))),
                               rtol=1e-6, atol=1e-6)
    pred = treg.get_builder("xgboost")(model, device="cpu")
    jpred = jreg.get_builder("xgboost")(model)
    assert pred.metadata == jpred.metadata and pred.metadata["n_classes"] == 3
    got = pred.predict(X).numpy()
    want = np.asarray(jax.jit(jpred.predict)(jnp.asarray(X)))
    if objective == "multi:softprob":
        expect = np.exp(margins) / np.exp(margins).sum(axis=1, keepdims=True)
        assert got.shape == (32, 3)
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert got.shape == (32,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, margins.argmax(axis=1).astype(np.float32))
        np.testing.assert_array_equal(got, want)


def test_gemm_forest_exact_parity_with_gather_and_jax():
    """The product form reproduces the gather traversal: strict-< splits
    (nextafter thresholds), NaN routing (NaN <= thr is false: right at
    every node), base_score; and equals the JAX package's product form."""
    model, trees_json = _two_tree_model(base_score="0.75")
    trees, _ = TT.from_xgboost_json(model)
    jtrees, _ = JT.from_xgboost_json(model)
    gf, jgf = TT.to_gemm(trees), JT.to_gemm(jtrees)
    assert gf is not None
    for name in ("feat", "thr", "A", "plen", "lval"):
        np.testing.assert_array_equal(getattr(gf, name).numpy(), np.asarray(getattr(jgf, name)),
                                      err_msg=name)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 3)).astype(np.float32) * 2
    X[0] = [1.5, 0.25, -0.5]  # exact split values: strict < goes right
    X[1, 0] = np.nan  # NaN: right at every node
    X[2] = np.nan
    ref = _gather(trees, X)
    got = _gemm(gf, X)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(_J_GEMM(jgf, jnp.asarray(X))), rtol=1e-6,
                               atol=1e-6)
    assert got[2] == 3.0 + 1.0 + 0.75  # all right branches
    # The serving form: A in bf16 (exact for +-1 and 0), same sums.
    fn, form = TT.lower_forest(trees, "cpu")
    assert form == "gemm"
    np.testing.assert_array_equal(fn(torch.from_numpy(X)).numpy(), got)


def test_gemm_forest_multiclass_parity():
    model, _, _ = _multiclass_model(n_class=3, rounds=5)
    trees, _ = TT.from_xgboost_json(model)
    jtrees, _ = JT.from_xgboost_json(model)
    gf = TT.to_gemm(trees)
    assert gf is not None and gf.n_groups == 3
    rng = np.random.default_rng(4)
    X = rng.normal(size=(16, 4)).astype(np.float32)
    got = _gemm(gf, X)
    assert got.shape == (16, 3)
    np.testing.assert_allclose(got, _gather(trees, X), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_J_GEMM(JT.to_gemm(jtrees), jnp.asarray(X))),
                               rtol=1e-5, atol=1e-5)


def test_gemm_budget_falls_back_to_gather(monkeypatch):
    model, _ = _two_tree_model()
    trees, _ = TT.from_xgboost_json(model)
    monkeypatch.setattr(TT, "_GEMM_BUDGET_ELEMS", 1)
    assert TT.to_gemm(trees) is None
    fn, form = TT.lower_forest(trees)
    assert form == "gather"
    X = np.zeros((2, 3), np.float32)
    np.testing.assert_allclose(fn(torch.from_numpy(X)).numpy(), _gather(trees, X))
    pred = treg.get_builder("xgboost")(model, device="cpu")
    assert pred.metadata["eval_form"] == "gather"


def test_sklearn_forest_flavor_uses_gemm_form():
    from sklearn.datasets import load_iris
    from sklearn.ensemble import GradientBoostingRegressor

    X, y = load_iris(return_X_y=True)
    model = GradientBoostingRegressor(n_estimators=20, max_depth=3, random_state=0).fit(
        X, y.astype(float))
    pred = treg.get_builder("sklearn-forest")(model, device="cpu")
    jpred = jreg.get_builder("sklearn-forest")(model)
    assert pred.metadata == jpred.metadata and pred.metadata["eval_form"] == "gemm"
    x32 = X[:8].astype(np.float32)
    got = pred.predict(x32).numpy()
    np.testing.assert_allclose(got, model.predict(X[:8]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jpred.predict)(jnp.asarray(x32))),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match=r"\[B, 4\]"):
        pred.validate({"x": np.zeros((1, 5), np.float32)})


def test_trees_carried_from_jax_evaluate_the_same():
    """A JAX forest taken apart into numpy (int32 indices) carries across
    through ``convert.from_jax_numpy`` and evaluates in both forms."""
    model, _, _ = _multiclass_model(n_class=3, rounds=3)
    jtrees, _ = JT.from_xgboost_json(model)
    fields = {f.name: getattr(jtrees, f.name) for f in dataclasses.fields(jtrees)}
    arrays = {k: np.asarray(v) for k, v in fields.items() if hasattr(v, "shape")}
    carried = convert.from_jax_numpy(arrays)
    trees = TT.TreeArrays(**carried, **{k: v for k, v in fields.items() if k not in arrays})
    assert trees.feature.dtype == torch.int32
    rng = np.random.default_rng(5)
    X = rng.normal(size=(8, 4)).astype(np.float32)
    want = np.asarray(_J_GATHER(jtrees, jnp.asarray(X)))
    np.testing.assert_allclose(_gather(trees, X), want, rtol=1e-6, atol=1e-6)
    jgf = JT.to_gemm(jtrees)
    g_fields = {f.name: getattr(jgf, f.name) for f in dataclasses.fields(jgf)}
    g_arrays = {k: np.asarray(v) for k, v in g_fields.items() if hasattr(v, "shape")}
    gf = TT.GemmForest(**convert.from_jax_numpy(g_arrays),
                       **{k: v for k, v in g_fields.items() if k not in g_arrays})
    np.testing.assert_allclose(_gemm(gf, X), want, rtol=1e-5, atol=1e-5)
