"""Control plane: CRD-driven reconciler with metric-gated canary rollouts
(the port's copy of the JAX package's ``operator/``, serving ``backend:
cuda`` where that one serves ``tpu``).

Rebuilds the reference's single-file operator (``mlflow_operator.py``) as a
level-triggered state machine:

- ``uri``        — artifact URI normalization (ref ``:18-24``)
- ``judge``      — the promotion gate decision (ref ``:419-460``)
- ``state``      — serializable promotion state (fixes SURVEY §3.5(2))
- ``builder``    — deployment manifest construction (ref ``:156-238``),
                   including the ``backend: cuda`` first-party data plane
- ``autoscaler`` — the replica autoscaler's pure decision functions
- ``rollout_recorder`` — the per-CR gate and transition journal
- ``reconciler`` — the per-resource reconcile step (ref ``:26-361``,
                   without the infinite handler of §3.5(1))
- ``runtime``    — the watch/timer engine that drives reconcilers
"""

from .builder import build_deployment
from .judge import should_promote
from .reconciler import Reconciler, ReconcileOutcome
from .state import Phase, PromotionState
from .uri import artifact_uri, extract_relative_path

__all__ = [
    "artifact_uri",
    "extract_relative_path",
    "should_promote",
    "Phase",
    "PromotionState",
    "build_deployment",
    "Reconciler",
    "ReconcileOutcome",
]
