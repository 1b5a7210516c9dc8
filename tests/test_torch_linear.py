"""The port's linear models (``models/linear.py``) against the JAX
package's and sklearn, on the CPU.

sklearn's bundled iris (no download) fits a ``LogisticRegression``; both
packages convert it with ``from_sklearn`` and run ``predict_proba`` and
``predict`` on the same float32 rows.  Tolerances: probabilities within
1e-4 absolute of sklearn (the reference's own bar,
``tests/test_models_misc.py``) and within 1e-6 absolute of the JAX
function (f32 on both sides); class ids equal, and carried as int32 (the
reference's V2 datatype).  ``LinearRegression`` values within 1e-4 of
sklearn and 1e-5 of the JAX function; the binary single-column case
returns ``[1 - p, p]`` like sklearn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    linear as TL,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    registry as treg,
)
from tpumlops.models import linear as JL


@pytest.fixture(scope="module")
def iris():
    from sklearn.datasets import load_iris
    from sklearn.linear_model import LogisticRegression

    X, y = load_iris(return_X_y=True)
    return LogisticRegression(max_iter=500).fit(X, y), X.astype(np.float32), y


def test_iris_logistic_regression_against_jax_and_sklearn(iris):
    sk, X, _ = iris
    tp, tcfg = TL.from_sklearn(sk)
    jp, jcfg = JL.from_sklearn(sk)
    assert (tcfg.n_features, tcfg.n_classes, tcfg.kind) == (jcfg.n_features, jcfg.n_classes,
                                                          jcfg.kind)
    np.testing.assert_array_equal(tp["coef"].numpy(), np.asarray(jp["coef"]))
    proba = TL.predict_proba(tp, torch.from_numpy(X)).numpy()
    jproba = np.asarray(jax.jit(JL.predict_proba)(jp, jnp.asarray(X)))
    np.testing.assert_allclose(proba, sk.predict_proba(X), atol=1e-4)
    np.testing.assert_allclose(proba, jproba, atol=1e-6)
    pred = TL.predict(tp, torch.from_numpy(X), tcfg)
    assert pred.dtype == torch.int32
    jpred = np.asarray(JL.predict(jp, jnp.asarray(X), jcfg))
    assert jpred.dtype == np.int32
    np.testing.assert_array_equal(pred.numpy(), sk.predict(X))
    np.testing.assert_array_equal(pred.numpy(), jpred)


def test_linear_regression_against_jax_and_sklearn():
    from sklearn.linear_model import LinearRegression

    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 4))
    y = X @ [1.0, -2.0, 0.5, 3.0] + 0.7
    sk = LinearRegression().fit(X, y)
    tp, tcfg = TL.from_sklearn(sk)
    jp, jcfg = JL.from_sklearn(sk)
    assert tcfg.kind == jcfg.kind == "linear"
    x32 = X.astype(np.float32)
    got = TL.predict(tp, torch.from_numpy(x32), tcfg).numpy()
    assert got.shape == (50,)
    np.testing.assert_allclose(got, sk.predict(X), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(JL.predict(jp, jnp.asarray(x32), jcfg)),
                               atol=1e-5)


def test_binary_single_column_is_one_minus_p_and_p():
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 3))
    y = (X[:, 0] - X[:, 2] > 0).astype(int)
    sk = LogisticRegression().fit(X, y)
    tp, tcfg = TL.from_sklearn(sk)
    jp, _ = JL.from_sklearn(sk)
    assert tp["coef"].shape == (3, 1) and tcfg.n_classes == 1
    x32 = X.astype(np.float32)
    proba = TL.predict_proba(tp, torch.from_numpy(x32)).numpy()
    assert proba.shape == (40, 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(proba, sk.predict_proba(X), atol=1e-4)
    np.testing.assert_allclose(proba, np.asarray(JL.predict_proba(jp, jnp.asarray(x32))),
                               atol=1e-6)
    np.testing.assert_array_equal(TL.predict(tp, torch.from_numpy(x32), tcfg).numpy(),
                                  sk.predict(X))


def test_init_is_seeded_and_shaped():
    cfg = TL.LinearConfig(n_features=4, n_classes=3)
    a = TL.init(torch.Generator().manual_seed(3), cfg)
    b = TL.init(torch.Generator().manual_seed(3), cfg)
    assert a["coef"].shape == (4, 3) and a["intercept"].shape == (3,)
    assert torch.equal(a["coef"], b["coef"]) and not a["intercept"].any()


def test_registry_builder_serves_iris_on_the_cpu(iris):
    sk, X, _ = iris
    pred = treg.get_builder("sklearn-linear")(sk, device="cpu")
    assert pred.jittable and pred.metadata == {"n_features": 4, "n_classes": 3}
    out = pred.predict(X)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), sk.predict(X))
    assert pred.example_input(4).shape == (4, 4)
    with pytest.raises(ValueError, match=r"\[B, 4\]"):
        pred.validate({"x": np.zeros((2, 3), np.float32)})
