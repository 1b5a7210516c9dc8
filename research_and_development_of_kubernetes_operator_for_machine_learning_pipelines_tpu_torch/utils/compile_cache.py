"""The node-local directory of built kernels (the port's counterpart of the
JAX package's ``utils/compile_cache.py``, its persistent XLA cache).

The port compiles no XLA program: what a replica builds before it can
serve is its CUDA kernels (``ops/_build.py``: one ``nvcc`` per
``csrc/<name>.cu`` into ``<dir>/<name>-<hash>.so``, the hash covering the
source, the shared headers and the flags).  A library already in the
directory is a cache hit and loads in milliseconds; a miss runs ``nvcc``
(seconds a source).  Pointing the directory at a node-local volume that
outlives the pod (``--compile-cache-dir``) makes a restart or a second
replica on the node a hit; the default is ``build/torch_kernels/`` beside
the package, which ``.gitignore`` lists.

Every build outcome is counted here (:data:`COUNTERS`), logged as one
``tpumlops.compile`` line a build, and, with device telemetry on,
attributed to its kernel in the compile observatory
(``server/device_telemetry.CompileObservatory``), which feeds
``tpumlops_compile_seconds{op}`` and ``tpumlops_compile_cache_{hits,
misses}``.  Standard library only: ``ops/_build.py`` reports into it.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path

_log = logging.getLogger("tpumlops.compile_cache")
# One structured line per build (see note_build).
_compile_log = logging.getLogger("tpumlops.compile")

# Process-wide build counters: "hits" are libraries found built, "misses"
# the ones nvcc built; "compiles" counts nvcc runs and "compile_seconds"
# their summed wall.
COUNTERS = {"hits": 0, "misses": 0, "compiles": 0, "compile_seconds": 0.0}
_counters_lock = threading.Lock()
_observatory = None  # server.device_telemetry.CompileObservatory | None


def install_compile_listeners(observatory=None) -> None:
    """Bind a :class:`~..server.device_telemetry.CompileObservatory`: each
    later build outcome is attributed to its kernel there.  The latest
    call wins, so a server rebuild re-binds."""
    global _observatory
    if observatory is not None:
        _observatory = observatory


def detach_observatory(observatory) -> None:
    """Unbind an observatory (server shutdown), so a retired server's
    metrics stop moving and its object graph can be freed."""
    global _observatory
    if _observatory is observatory:
        _observatory = None


def note_build(name: str, hit: bool, seconds: float = 0.0) -> None:
    """One kernel library's build outcome (``ops/_build.py``): found built
    (``hit``), or built by nvcc in ``seconds``."""
    with _counters_lock:
        if hit:
            COUNTERS["hits"] += 1
        else:
            COUNTERS["misses"] += 1
            COUNTERS["compiles"] += 1
            COUNTERS["compile_seconds"] += seconds
        hits, misses = COUNTERS["hits"], COUNTERS["misses"]
    obs = _observatory
    if hit:
        if obs is not None:
            obs.on_event("cache_hit", op=name)
        return
    _compile_log.info(
        "compiled op=%s wall_ms=%.1f cache_hits=%d cache_misses=%d",
        name, seconds * 1000.0, hits, misses,
        extra={"compile_op": name, "compile_wall_s": seconds},
    )
    if obs is not None:
        obs.on_event("cache_miss", op=name)
        obs.on_event("compile", seconds, op=name)


def counters_snapshot() -> dict:
    with _counters_lock:
        return dict(COUNTERS)


def enable_persistent_compile_cache(cache_dir: str | None) -> bool:
    """Point the kernel build (``ops/_build.BUILD_DIR``) at ``cache_dir``.

    Returns True when the directory is in use.  ``cache_dir`` falsy keeps
    the default (``build/torch_kernels/``) and returns False; a directory
    that cannot be written logs a warning and keeps the default rather
    than failing startup: a build there is slow, not fatal.  Call it
    before the first kernel loads."""
    from ..ops import _build

    if not cache_dir:
        return False
    try:
        os.makedirs(cache_dir, exist_ok=True)
        probe = os.path.join(cache_dir, ".tpumlops-probe")
        with open(probe, "w"):
            pass
        os.remove(probe)
    except OSError as exc:
        _log.warning("compile cache dir %s unusable (%s); building into %s",
                     cache_dir, exc, _build.BUILD_DIR)
        return False
    _build.BUILD_DIR = Path(cache_dir)
    _log.info("kernel build cache at %s", cache_dir)
    return True


def cache_entry_count(cache_dir: str) -> int:
    """Number of built kernel libraries in ``cache_dir``."""
    try:
        return sum(1 for n in os.listdir(cache_dir) if n.endswith(".so"))
    except OSError:
        return 0
