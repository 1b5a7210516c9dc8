"""Artifact URI normalization.

The MLflow registry reports artifact sources like
``mlflow-artifacts:/1/<run>/artifacts/model``; predictors need them
re-rooted under the object store the cluster actually mounts (``s3://mlflow``
in the reference, configurable here — SURVEY §3.5(5)).

Reference behavior: ``extract_relative_path`` at ``mlflow_operator.py:18-24``
and the re-rooting at ``:125-135``.
"""

from __future__ import annotations

_MLFLOW_SCHEME = "mlflow-artifacts:/"


def extract_relative_path(source_uri: str) -> str:
    """Strip the ``mlflow-artifacts:/`` scheme (first occurrence only) and any
    leading slashes, yielding a bucket-relative path.

    Matches reference semantics exactly (``mlflow_operator.py:18-24``):
    non-mlflow-scheme URIs pass through with only the leading-slash strip.
    """
    if source_uri.startswith(_MLFLOW_SCHEME):
        relative = source_uri.replace(_MLFLOW_SCHEME, "", 1)
    else:
        relative = source_uri
    return relative.lstrip("/")


def artifact_uri(source_uri: str, artifact_root: str = "s3://mlflow") -> str:
    """Re-root an MLflow source URI under the cluster's artifact store.

    Reference: ``f"{base_uri}/{relative_path}"`` with ``base_uri`` hardcoded
    to ``s3://mlflow`` (``mlflow_operator.py:125-127``).  Already-rooted URIs
    (s3://, gs://, file://, /abs/path) whose root matches are passed through
    unchanged so the operator is idempotent over its own outputs.
    """
    root = artifact_root.rstrip("/")
    if source_uri.startswith(root + "/") or source_uri == root:
        return source_uri
    return f"{root}/{extract_relative_path(source_uri)}"
