"""The PyTorch port imports neither JAX nor the JAX package, nor
``ml_dtypes`` (the card's machine has none: the port reads and writes
bfloat16 through int16 views), nor ``httpx`` or ``prometheus_client``
(the AST scan).

The JAX package's ``server/__init__.py`` imports its engine, which imports
JAX, so even a numpy-only reference module would pull JAX in; the port
keeps its own copies.  Checked two ways: a fresh interpreter imports every
port module (and ``chip_smoke.py``) and inspects ``sys.modules``, and an
AST scan of every source rejects the import statements outright.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch"
JAX_PKG = "research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu"
# httpx and prometheus_client: the card's machine has neither (the port's
# REST clients and operator telemetry are on the standard library).
FORBIDDEN = ("jax", "jaxlib", "tpumlops", JAX_PKG, "ml_dtypes", "httpx", "prometheus_client")

SOURCES = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_port_module_leaves_jax_out():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
pkg = importlib.import_module({PORT!r})
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    if not m.name.endswith("__main__")
]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpumlops", {JAX_PKG!r}, "ml_dtypes"))
print(len(names))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 26  # package + ops/models/server/utils/scripts modules


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


CONTROL_PLANE = ("utils.clock", "utils.journey_trace", "utils.config", "clients.base",
                 "clients.fakes", "clients.router", "clients.localplane", "operator.state",
                 "operator.uri", "operator.judge", "operator.rollout_recorder",
                 "operator.builder", "operator.autoscaler", "operator.reconciler",
                 "operator.runtime")


def test_the_walk_and_the_scan_reach_the_control_plane():
    """``clients/`` and ``operator/`` are packages the import walk enters
    and the AST scan covers; ``native/`` holds the port's own router
    source (no Python)."""
    import pkgutil

    walked = {m.name for m in pkgutil.walk_packages([str(ROOT / PORT)], PORT + ".")}
    scanned = {str(p.relative_to(ROOT / PORT))[:-3].replace("/", ".") for p in SOURCES
               if p.is_relative_to(ROOT / PORT)}
    for name in CONTROL_PLANE:
        assert f"{PORT}.{name}" in walked, name
        assert name in scanned, name
    assert (ROOT / PORT / "native" / "router.cc").is_file()
    assert not list((ROOT / PORT / "native").glob("*.py"))
