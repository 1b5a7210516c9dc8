"""Linear and logistic-regression models in PyTorch (port of the JAX
package's ``models/linear.py``; baseline config 0, sklearn iris).

A fitted sklearn model's coefficients are lifted into tensors, so a tiny
tabular model rides the same device path and metric surface as the big
ones.  ``coef`` is ``[n_features, n_out]`` and ``intercept`` ``[n_out]``,
float32, as in the reference's tree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class LinearConfig:
    n_features: int
    n_classes: int = 1  # 1 => regression or binary-with-sigmoid
    kind: str = "logistic"  # "logistic" | "linear"


def init(gen: torch.Generator, cfg: LinearConfig, device=None) -> dict:
    """Random weights from ``gen``: normal with std 0.01, zero intercept."""
    out = max(cfg.n_classes, 1)
    coef = torch.randn((cfg.n_features, out), generator=gen, device=device,
                       dtype=torch.float32)
    return {
        "coef": 0.01 * coef,
        "intercept": torch.zeros((out,), dtype=torch.float32, device=device),
    }


def decision_function(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["coef"].to(x.dtype) + params["intercept"].to(x.dtype)


def predict_proba(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities with sklearn's ``LogisticRegression`` semantics:
    a binary model stored as one column is a sigmoid, returned as
    ``[1 - p, p]``; a multinomial one a softmax."""
    z = decision_function(params, x)
    if z.shape[-1] == 1:
        p1 = torch.sigmoid(z)
        return torch.cat([1.0 - p1, p1], dim=-1)
    return torch.softmax(z, dim=-1)


def predict(params: dict, x: torch.Tensor, cfg: LinearConfig) -> torch.Tensor:
    """Regression values, or the argmax's class ids as int32 (the type the
    reference's V2 response carries)."""
    if cfg.kind == "linear":
        z = decision_function(params, x)
        return z[..., 0] if z.shape[-1] == 1 else z
    return torch.argmax(predict_proba(params, x), dim=-1).to(torch.int32)


def from_sklearn(model) -> tuple[dict, LinearConfig]:
    """Convert a fitted sklearn ``LogisticRegression`` / ``LinearRegression``
    (or any object with ``coef_`` and ``intercept_``; ``predict_proba``
    makes it logistic).  Reads attributes only: no sklearn import."""
    coef = np.asarray(model.coef_, np.float32)
    if coef.ndim == 1:
        coef = coef[None, :]
    intercept = np.atleast_1d(np.asarray(model.intercept_, np.float32))
    kind = "logistic" if hasattr(model, "predict_proba") else "linear"
    params = {
        "coef": torch.from_numpy(np.ascontiguousarray(coef.T)),
        "intercept": torch.from_numpy(np.ascontiguousarray(intercept)),
    }
    cfg = LinearConfig(
        n_features=params["coef"].shape[0],
        n_classes=params["coef"].shape[1],
        kind=kind,
    )
    return params, cfg
