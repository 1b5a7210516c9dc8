"""Tabular models in PyTorch (port of the JAX package's
``models/tabular.py``; baseline config 1, gradient-boosted trees).

Two tiers, as in the reference:

- decision forests on the device: trees flattened to index tensors
  (``TreeArrays``) and traversed with ``max_depth`` rounds of gathers, or
  lowered at load time to two batched products and a compare
  (``GemmForest``); converters from sklearn forests and boosters and from
  xgboost's JSON model format (no sklearn or xgboost import: the
  converters read attributes and JSON);
- ``PyFuncPredictor``: any Python ``predict`` callable, run on the host by
  design (an MLflow pyfunc with no device lowering).

Index tensors are int64 (torch's index type); a tree carried from the JAX
package with int32 indices evaluates the same (``.long()`` at use).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch


@dataclass(frozen=True)
class TreeArrays:
    """One forest flattened to tensors of shape [n_trees, max_nodes].

    Leaf nodes self-loop (left == right == self), so ``max_depth``
    traversal rounds land every row on its leaf and keep it there.
    """

    feature: torch.Tensor  # int [T, N] feature index tested at node
    threshold: torch.Tensor  # f32 [T, N]
    left: torch.Tensor  # int [T, N] child if x[feat] <= threshold
    right: torch.Tensor  # int [T, N]
    value: torch.Tensor  # f32 [T, N] leaf contribution
    max_depth: int
    base_score: float = 0.0
    n_features: int = 0  # 0 = unknown (derived from the splits)
    # Multi-class boosters (xgboost multi:*) train one tree group per class:
    # tree_group[t] is the class whose margin tree t adds to.  n_groups == 1
    # keeps the scalar output ([B], not [B, 1]).
    tree_group: torch.Tensor | None = None  # int [T] or None
    n_groups: int = 1


def _to_device(forest, device):
    """A copy of a ``TreeArrays`` or ``GemmForest`` with every tensor on
    ``device``."""
    return dataclasses.replace(forest, **{
        f.name: getattr(forest, f.name).to(device)
        for f in dataclasses.fields(forest)
        if isinstance(getattr(forest, f.name), torch.Tensor)
    })


def _group_sum(per_tree: torch.Tensor, tree_group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """``per_tree [T, B]`` summed into ``[B, n_groups]`` by each tree's class
    (the reference's product with a one-hot group matrix), in f32."""
    out = torch.zeros((per_tree.shape[1], n_groups), dtype=torch.float32,
                      device=per_tree.device)
    return out.index_add_(1, tree_group.long(), per_tree.to(torch.float32).T)


def eval_forest(trees: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """Evaluate the forest: x [B, F] -> [B] summed leaf values, or
    [B, n_groups] per-class margins for a multi-class forest.

    Each of ``max_depth`` rounds gathers the current node's feature,
    threshold and children for every (tree, row) pair: gathers and selects
    only, no data-dependent control flow."""
    n_trees, b = trees.feature.shape[0], x.shape[0]
    feature, left, right = trees.feature.long(), trees.left.long(), trees.right.long()
    node = torch.zeros((n_trees, b), dtype=torch.long, device=x.device)
    xt = x.T  # [F, B]
    for _ in range(trees.max_depth):
        feat = torch.gather(feature, 1, node)  # [T, B]
        thr = torch.gather(trees.threshold, 1, node)  # [T, B]
        # For tree t, row b: x[b, feat[t, b]] == xt[feat[t, b], b].
        xv = torch.gather(xt, 0, feat)  # [T, B]
        node = torch.where(xv <= thr, torch.gather(left, 1, node),
                           torch.gather(right, 1, node))
    leaf_vals = torch.gather(trees.value, 1, node)  # [T, B]
    if trees.n_groups > 1:
        return _group_sum(leaf_vals, trees.tree_group, trees.n_groups) + trees.base_score
    return leaf_vals.sum(dim=0) + trees.base_score


@dataclass(frozen=True)
class GemmForest:
    """A forest lowered to products (the tensor-core form).

    Each leaf is one row of a +-1 "path polarity" matrix over the tree's
    internal nodes: +1 where its path takes the left (``<=``) branch, -1
    where it takes the right, 0 off the path.  With the comparisons
    encoded +-1, ``A @ cmp`` counts a path's agreements, and a leaf is hit
    iff the count equals its path length: the data-dependent traversal
    becomes a batched product and a compare.

    The predicate product runs in bf16 with an f32 result: exact, since its
    inputs are +-1 or 0 and its sums small integers.  The value reduction
    stays f32 (real-valued leaf sums).
    """

    feat: torch.Tensor  # int [T, NI] feature tested by each internal node
    thr: torch.Tensor  # f32 [T, NI] (+inf padding: cmp true, A column 0)
    A: torch.Tensor  # [T, NL, NI] path polarity (+1 left / -1 right / 0)
    plen: torch.Tensor  # f32 [T, NL] path length (-1 padding: never hit)
    lval: torch.Tensor  # f32 [T, NL] leaf value
    max_depth: int
    base_score: float = 0.0
    n_features: int = 0
    tree_group: torch.Tensor | None = None
    n_groups: int = 1


# A-matrix element budget for the GEMM lowering: [T, NL, NI] grows as
# 4^depth a tree, so very deep trees keep the gather traversal.
# 16M f32 elements = 64 MiB.
_GEMM_BUDGET_ELEMS = 16_000_000


def to_gemm(trees: TreeArrays) -> GemmForest | None:
    """Lower ``TreeArrays`` to the product form (host numpy, at load time;
    the result's tensors are on the CPU).

    Returns None when the padded A matrix would pass the element budget:
    the caller keeps the gather traversal."""
    F = trees.feature.cpu().numpy()
    TH = trees.threshold.cpu().numpy()
    Lc = trees.left.cpu().numpy()
    Rc = trees.right.cpu().numpy()
    V = trees.value.cpu().numpy()
    T = F.shape[0]

    # The budget is checked BEFORE the per-leaf path expansion, from the
    # flattened arrays: leaves self-loop (left == self), and padding rows
    # (left == self == 0) only overcount, which can only reject.
    node_idx = np.arange(F.shape[1])[None, :]
    is_leaf = Lc == node_idx
    n_leaf_bound = int(is_leaf.sum(axis=1).max())
    n_int_bound = int((~is_leaf).sum(axis=1).max())
    if T * max(1, n_leaf_bound) * max(1, n_int_bound) > _GEMM_BUDGET_ELEMS:
        return None

    per_tree = []
    n_int_max = n_leaf_max = 1
    for t in range(T):
        internal: list[int] = []
        leaves: list[tuple[float, list[tuple[int, int]]]] = []
        # Iterative DFS (explicit stack): depth is not bounded by Python's.
        stack: list[tuple[int, list[tuple[int, int]]]] = [(0, [])]
        while stack:
            node, path = stack.pop()
            if Lc[t, node] == node:  # leaf self-loop
                leaves.append((float(V[t, node]), path))
                continue
            internal.append(node)
            stack.append((int(Rc[t, node]), path + [(node, -1)]))
            stack.append((int(Lc[t, node]), path + [(node, +1)]))
        per_tree.append((internal, leaves))
        n_int_max = max(n_int_max, len(internal))
        n_leaf_max = max(n_leaf_max, len(leaves))

    if T * n_leaf_max * n_int_max > _GEMM_BUDGET_ELEMS:
        return None

    NI, NL = n_int_max, n_leaf_max
    feat = np.zeros((T, NI), np.int64)
    thr = np.full((T, NI), np.inf, np.float32)
    A = np.zeros((T, NL, NI), np.float32)
    plen = np.full((T, NL), -1.0, np.float32)
    lval = np.zeros((T, NL), np.float32)
    for t, (internal, leaves) in enumerate(per_tree):
        pos = {n: i for i, n in enumerate(internal)}
        if internal:
            feat[t, : len(internal)] = F[t, internal]
            thr[t, : len(internal)] = TH[t, internal]
        for li, (v, path) in enumerate(leaves):
            lval[t, li] = v
            plen[t, li] = float(len(path))
            for node, pol in path:
                A[t, li, pos[node]] = pol
    return GemmForest(
        feat=torch.from_numpy(feat),
        thr=torch.from_numpy(thr),
        A=torch.from_numpy(A),
        plen=torch.from_numpy(plen),
        lval=torch.from_numpy(lval),
        max_depth=trees.max_depth,
        base_score=trees.base_score,
        n_features=trees.n_features,
        tree_group=None if trees.tree_group is None else trees.tree_group.cpu(),
        n_groups=trees.n_groups,
    )


def _polarity_counts(A: torch.Tensor, cmp_pm: torch.Tensor) -> torch.Tensor:
    """``A [T, NL, NI] @ cmp [T, NI, B]`` as f32 counts: on the card a bf16
    batched product whose f32 accumulator is the output; elsewhere in f32
    (the same integers)."""
    if A.device.type == "cuda":
        return torch.bmm(A.to(torch.bfloat16), cmp_pm.to(torch.bfloat16),
                         out_dtype=torch.float32)
    return torch.bmm(A.to(torch.float32), cmp_pm.to(torch.float32))


def eval_forest_gemm(gf: GemmForest, x: torch.Tensor) -> torch.Tensor:
    """Evaluate the product-form forest: x [B, F] -> [B] (or [B, K])."""
    xt = x.T  # [F, B]
    fv = xt[gf.feat.long()]  # [T, NI, B]
    one = torch.ones((), dtype=torch.bfloat16, device=x.device)
    cmp_pm = torch.where(fv <= gf.thr[..., None], one, -one)
    counts = _polarity_counts(gf.A, cmp_pm)  # [T, NL, B]
    hit = (counts == gf.plen[..., None]).to(torch.float32)
    # The value reduction elementwise in f32 (no product that a TF32
    # setting could round).
    contrib = (hit * gf.lval[..., None].to(torch.float32)).sum(dim=1)  # [T, B]
    if gf.n_groups > 1:
        return _group_sum(contrib, gf.tree_group, gf.n_groups) + gf.base_score
    return contrib.sum(dim=0) + gf.base_score


def lower_forest(trees: TreeArrays, device=None):
    """Pick the evaluation form: ``(eval_fn, form_name)``, the forest's
    tensors moved to ``device`` (kept where they are when None).

    The product form when it fits the budget (its A matrix stored in bf16,
    exact for +-1 and 0), else the gather traversal."""
    gf = to_gemm(trees)
    if gf is None:
        if device is not None:
            trees = _to_device(trees, device)
        return (lambda x: eval_forest(trees, x)), "gather"
    gf = dataclasses.replace(gf, A=gf.A.to(torch.bfloat16))
    if device is not None:
        gf = _to_device(gf, device)
    return (lambda x: eval_forest_gemm(gf, x)), "gemm"


def _tree_arrays(feature, threshold, left, right, value, **kw) -> TreeArrays:
    return TreeArrays(
        feature=torch.from_numpy(feature.astype(np.int64)),
        threshold=torch.from_numpy(threshold),
        left=torch.from_numpy(left.astype(np.int64)),
        right=torch.from_numpy(right.astype(np.int64)),
        value=torch.from_numpy(value),
        **kw,
    )


def from_sklearn_forest(model) -> TreeArrays:
    """Convert sklearn RandomForest* / GradientBoosting* to ``TreeArrays``."""
    if not hasattr(model, "estimators_"):
        raise TypeError(f"unsupported sklearn model {type(model).__name__}")
    raw = np.asarray(model.estimators_).ravel().tolist()
    estimators = [e.tree_ for e in raw]
    # A random forest averages its trees; gradient boosting sums
    # learning-rate-scaled trees on top of the init estimator's constant.
    if type(model).__name__.startswith("RandomForest"):
        scale, base = 1.0 / len(estimators), 0.0
    else:
        scale = float(model.learning_rate)
        init = getattr(model, "init_", None)
        base = float(np.ravel(init.constant_)[0]) if hasattr(init, "constant_") else 0.0

    max_nodes = max(t.node_count for t in estimators)
    max_depth = max(t.max_depth for t in estimators)
    T = len(estimators)
    feature = np.zeros((T, max_nodes), np.int32)
    threshold = np.zeros((T, max_nodes), np.float32)
    left = np.zeros((T, max_nodes), np.int32)
    right = np.zeros((T, max_nodes), np.int32)
    value = np.zeros((T, max_nodes), np.float32)
    for ti, t in enumerate(estimators):
        n = t.node_count
        is_leaf = t.children_left[:n] == -1
        feature[ti, :n] = np.where(is_leaf, 0, t.feature[:n])
        threshold[ti, :n] = np.where(is_leaf, 0.0, t.threshold[:n])
        idx = np.arange(n)
        left[ti, :n] = np.where(is_leaf, idx, t.children_left[:n])
        right[ti, :n] = np.where(is_leaf, idx, t.children_right[:n])
        value[ti, :n] = np.where(is_leaf, t.value[:n, 0, 0] * scale, 0.0)
    return _tree_arrays(feature, threshold, left, right, value,
                        max_depth=int(max_depth), base_score=float(base))


def from_xgboost(booster) -> tuple[TreeArrays, str]:
    """Convert a live xgboost Booster through its JSON dump (no xgboost
    import here: the caller already holds the booster)."""
    import json as _json

    raw = booster.save_raw(raw_format="json")
    return from_xgboost_json(_json.loads(bytes(raw)))


def from_xgboost_json(model: Any) -> tuple[TreeArrays, str]:
    """Parse xgboost's JSON model format into ``(TreeArrays, objective)``.

    Reads what ``Booster.save_model("model.json")`` writes, so serving an
    xgboost model needs no xgboost.  Semantics kept:

    - routing is ``x[feat] < cond`` (strict, unlike sklearn's ``<=``): the
      threshold stored is ``nextafter(cond, -inf)`` in float32, so the
      shared ``<=`` evaluator reproduces the strict comparison exactly;
    - leaf values live in ``split_conditions`` at leaf nodes (already
      learning-rate scaled);
    - ``base_score`` is a probability for ``binary:*``: the margin sum
      starts from ``logit(base_score)`` there, from it as is elsewhere.

    The objective names the caller's output transform.
    """
    if isinstance(model, (str, bytes)):
        import json as _json

        model = _json.loads(model)
    learner = model.get("learner")
    if not isinstance(learner, dict):
        raise ValueError("not an xgboost JSON model: missing 'learner'")
    booster = learner.get("gradient_booster", {})
    booster_name = booster.get("name", "gbtree")
    if booster_name not in ("gbtree", "dart"):
        raise NotImplementedError(
            f"xgboost booster {booster_name!r} has no device lowering "
            "(only tree boosters); use the pyfunc tier"
        )
    lmp = learner.get("learner_model_param", {})
    num_class = int(lmp.get("num_class", "0") or 0)
    objective = (learner.get("objective") or {}).get("name", "reg:squarederror")
    base = float(lmp.get("base_score", "0.5"))
    if objective.startswith("binary:"):
        # ProbToMargin: the stored base_score is a probability.
        eps = 1e-7
        p = min(max(base, eps), 1 - eps)
        base = float(np.log(p / (1 - p)))
    if booster_name == "dart":
        weights = [float(w) for w in booster.get("weight_drop", [])]
        booster = booster.get("gbtree", booster)
    else:
        weights = []
    trees_json = (booster.get("model") or {}).get("trees", [])
    if not trees_json:
        raise ValueError("xgboost model contains no trees")
    # Multi-class (multi:softprob/softmax): one tree group per class,
    # recorded per tree in tree_info.  base_score stays a raw margin here:
    # softmax has no ProbToMargin transform.
    if objective.startswith("multi:") and num_class < 2:
        # Without num_class the [B] margins would be softmaxed ACROSS THE
        # BATCH downstream: refuse at load time.
        raise ValueError(
            f"objective {objective!r} requires num_class >= 2 in "
            f"learner_model_param, got {num_class}"
        )
    n_groups = num_class if num_class > 1 else 1
    tree_group = None
    if n_groups > 1:
        tree_info = (booster.get("model") or {}).get("tree_info", [])
        if len(tree_info) != len(trees_json):
            raise ValueError(
                f"multi-class model: tree_info has {len(tree_info)} entries "
                f"for {len(trees_json)} trees"
            )
        tree_group = np.asarray(tree_info, np.int64)
        if tree_group.size and (tree_group.min() < 0 or tree_group.max() >= n_groups):
            raise ValueError(
                f"tree_info class ids outside [0, {n_groups}): "
                f"[{tree_group.min()}, {tree_group.max()}]"
            )

    T = len(trees_json)
    max_nodes = max(len(t["left_children"]) for t in trees_json)
    feature = np.zeros((T, max_nodes), np.int32)
    threshold = np.zeros((T, max_nodes), np.float32)
    left = np.zeros((T, max_nodes), np.int32)
    right = np.zeros((T, max_nodes), np.int32)
    value = np.zeros((T, max_nodes), np.float32)
    max_depth = 1
    for ti, t in enumerate(trees_json):
        leaf_vec = int((t.get("tree_param") or {}).get("size_leaf_vector", "1") or 1)
        if leaf_vec > 1:
            # xgboost >= 2.0 multi_strategy="multi_output_tree": one tree
            # emits a vector of per-class leaves, which the scalar-leaf
            # evaluator would sum into class 0.  Refuse instead.
            raise NotImplementedError(
                f"vector-leaf tree (size_leaf_vector={leaf_vec}, "
                "multi_output_tree strategy) has no device lowering; "
                "train with one-tree-per-class (default) or use the "
                "pyfunc tier"
            )
        lc = np.asarray(t["left_children"], np.int32)
        rc = np.asarray(t["right_children"], np.int32)
        cond = np.asarray(t["split_conditions"], np.float32)
        sidx = np.asarray(t["split_indices"], np.int32)
        n = lc.shape[0]
        is_leaf = lc == -1
        idx = np.arange(n, dtype=np.int32)
        feature[ti, :n] = np.where(is_leaf, 0, sidx)
        # Strict '<' via nextafter: x < c  <=>  x <= nextafter(c, -inf) in f32.
        threshold[ti, :n] = np.where(is_leaf, 0.0, np.nextafter(cond, np.float32(-np.inf)))
        left[ti, :n] = np.where(is_leaf, idx, lc)
        right[ti, :n] = np.where(is_leaf, idx, rc)
        scale = weights[ti] if ti < len(weights) else 1.0
        value[ti, :n] = np.where(is_leaf, cond * scale, 0.0)
        # This tree's depth from the child links (the root is node 0).
        depth = np.zeros(n, np.int32)
        order = [0]
        while order:
            node = order.pop()
            for child in (lc[node], rc[node]):
                if child != -1:
                    depth[child] = depth[node] + 1
                    order.append(int(child))
        max_depth = max(max_depth, int(depth.max()) + 1 if n > 1 else 1)
    trees = _tree_arrays(
        feature, threshold, left, right, value,
        max_depth=max_depth,
        base_score=base,
        n_features=int(lmp.get("num_feature", "0") or 0) or int(feature.max()) + 1,
        tree_group=None if tree_group is None else torch.from_numpy(tree_group),
        n_groups=n_groups,
    )
    return trees, objective


class PyFuncPredictor:
    """The pyfunc tier: any Python callable behind the predictor interface.

    Runs on the host by design (``jittable`` False, the reference's name):
    an MLflow pyfunc whose flavor has no device lowering."""

    def __init__(self, predict: Callable[[np.ndarray], np.ndarray], name: str = "pyfunc"):
        self._predict = predict
        self.name = name
        self.jittable = False

    def __call__(self, x: Any) -> np.ndarray:
        return np.asarray(self._predict(np.asarray(x)))
