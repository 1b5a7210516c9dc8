"""Checkpoint/resume of weight state (the port's copy of the JAX package's
``utils/checkpoint.py``, without orbax).

The reference's only persisted state is the CR status subresource; model
weights live in MLflow/MinIO and are pulled fresh by each predictor
(``mlflow_operator.py:199,:214``).  The rebuild owns a data plane, so it
owes the piece the reference delegates: durable, versioned weight state
with sharded-on-load restore for predictors of several ranks and warm
restarts that skip the artifact store.

Two layers:

- :func:`save` / :func:`restore` — one-shot round trip of a tree (dicts,
  lists and tuples) of torch tensors: one ``torch.save`` file a tree, read
  back with ``weights_only`` loading (no pickled code runs) and memory-mapped,
  so a template of ``parallel/sharding.py`` specs makes each rank read and
  keep only its block of every leaf.
- :class:`CheckpointManager` — the subsystem: a versioned step layout
  with atomic publish (write to a scratch name, fsync-rename, then a
  ``COMMITTED`` marker — a torn save is never listed), background/async
  saves so a serving process snapshots without stalling its decode loop,
  keep-N garbage collection, and JSON metadata per step (wall time,
  user tags) for operational forensics.

The file format is this package's own; no server path reads it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

try:
    import fcntl
except ImportError:  # non-POSIX: single-process use only
    fcntl = None

_log = logging.getLogger(__name__)

_COMMITTED = "COMMITTED"  # marker file: step directory is fully written
_TREE_FILE = "tree.pt"


def _fsync_path(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(root: Path) -> None:
    """fsync every file and directory under ``root`` (and root itself).

    The atomic-publish guarantee needs the DATA durable before the
    rename and the COMMITTED marker: a crash that persists the tiny
    marker but not the tensor writes would otherwise surface a torn
    checkpoint as restorable.
    """
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames:
            _fsync_path(Path(dirpath) / name)
        _fsync_path(Path(dirpath))


def _map(tree: Any, fn, template: Any = None):
    """``fn(leaf, template leaf)`` over a tree of dicts, lists and tuples
    (a NamedTuple keeps its type); ``template`` mirrors ``tree`` or is None."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, None if template is None else template[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(v, fn, None if template is None else template[i])
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, template)


def _host_copy(tree: Any) -> Any:
    """A copy of every tensor of ``tree`` on the host, taken now."""
    import torch

    def copy(x, _):
        return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x

    return _map(tree, copy)


def save(path: str | Path, tree: Any) -> None:
    """Write ``tree`` (torch tensors in dicts, lists and tuples; ints,
    floats, strings and None beside them) into the directory ``path``."""
    import torch

    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save(_host_copy(tree), path / _TREE_FILE)


def restore(path: str | Path, template: Any | None = None, device: Any = None) -> Any:
    """Read a tree written by :func:`save`.

    ``template`` mirrors the tree: where its leaf is a
    ``parallel.sharding.NamedSharding`` (a spec on this rank's
    ``ServingMesh``), only this rank's block of that leaf is read and kept
    (the file is memory-mapped, so the other blocks are never loaded);
    any other template leaf keeps the whole leaf.  ``device`` moves every
    tensor there (the host when None)."""
    import torch

    from ..parallel.sharding import NamedSharding, _block, shard_shape

    path = Path(path).absolute()
    tree = torch.load(path / _TREE_FILE, map_location="cpu", weights_only=True, mmap=True)

    def take(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        if isinstance(spec, NamedSharding):
            want = shard_shape(x.shape, spec.spec, spec.mesh.shape)
            x = _block(x, spec.spec, spec.mesh)
            if tuple(x.shape) != want:
                raise ValueError(f"block of shape {tuple(x.shape)}, expected {want}")
        x = x.clone() if device is None else x.to(device, copy=True)
        return x

    return _map(tree, take, template)


class AsyncSaveHandle:
    """Handle for a background save: ``wait()`` re-raises its failure."""

    def __init__(self, thread: threading.Thread):
        self._thread = thread
        self.error: BaseException | None = None

    def wait(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint save still running")
        if self.error is not None:
            raise self.error

    def done(self) -> bool:
        return not self._thread.is_alive()


class CheckpointManager:
    """Versioned checkpoints under one root: ``<root>/step_<N>/``.

    Guarantees:

    - **Atomic publish.**  A step is written to ``.tmp_step_<N>``, then
      renamed, then marked with a ``COMMITTED`` file.  ``steps()`` lists
      only committed steps, so a crash mid-save leaves garbage (cleaned
      on the next save) but never a restorable-looking torn checkpoint.
    - **Monotonic steps.**  Re-saving an existing step is refused unless
      ``overwrite=True`` — silent clobbering of a published version is
      how serving fleets end up with two weight sets under one name.
    - **Keep-N GC.**  After each successful save, committed steps beyond
      ``max_to_keep`` (oldest first) are deleted.
    - **Async.**  ``save_async`` copies the tree to the host at once (a
      torch tensor is mutable: a decode step after the call must not
      change what is written), then runs the same path on a daemon thread;
      the returned handle's ``wait()`` surfaces errors.  One in-flight
      async save at a time (a second request waits) — concurrent writes
      into one root interleave badly.
    """

    def __init__(self, root: str | Path, max_to_keep: int | None = 3):
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._save_lock = threading.Lock()
        self._recover_interrupted()

    @contextlib.contextmanager
    def _os_lock(self):
        """Cross-PROCESS exclusion for every root-mutating section.

        ``_save_lock`` only serializes threads of one process; recovery
        at open time also mutates the root, so a second process opening
        the manager during another process's overwrite window (between
        ``final.rename(old)`` and ``tmp.rename(final)``) would "restore"
        the parked predecessor and break the in-flight saver's final
        rename.  An flock on ``<root>/.lock`` closes that window: saves
        and open-time recovery block each other across processes.  On
        platforms without fcntl this degrades to the documented
        single-writer-process assumption.
        """
        if fcntl is None:
            yield
            return
        fd = os.open(self.root / ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _recover_interrupted(self) -> None:
        """Heal crash leftovers at open time, for EVERY step: an overwrite
        that crashed between parking the committed predecessor under
        ``.replaced_<step>`` and committing its replacement leaves the
        step's only committed bytes under a name ``steps()`` never lists;
        restore the predecessor when the step is uncommitted, scrap the
        leftover when the overwrite did commit."""
        with self._save_lock, self._os_lock():
            for old in self.root.glob(".replaced_step_*"):
                final = self.root / old.name[len(".replaced_"):]
                if (final / _COMMITTED).exists():
                    shutil.rmtree(old)  # overwrite committed; this is trash
                else:
                    if final.exists():
                        shutil.rmtree(final)  # uncommitted replacement
                    old.rename(final)
                    _fsync_path(self.root)

    # -- layout --------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def steps(self) -> list[int]:
        """Committed steps, ascending."""
        out = []
        for p in self.root.glob("step_*"):
            if (p / _COMMITTED).exists():
                try:
                    out.append(int(p.name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def metadata(self, step: int) -> dict:
        return json.loads((self._step_dir(step) / _COMMITTED).read_text())

    # -- save ----------------------------------------------------------------

    def save(
        self,
        step: int,
        tree: Any,
        *,
        tags: dict | None = None,
        overwrite: bool = False,
    ) -> Path:
        with self._save_lock, self._os_lock():
            final = self._step_dir(step)
            tmp = self.root / f".tmp_{final.name}"
            old = self.root / f".replaced_{final.name}"
            if tmp.exists():  # torn leftover from a previous crash
                shutil.rmtree(tmp)
            if old.exists():
                if (final / _COMMITTED).exists():
                    # The previous overwrite committed; the leftover is
                    # just its trash.
                    shutil.rmtree(old)
                else:
                    # Crashed between renaming the predecessor away and
                    # committing its replacement: the .replaced_ copy is
                    # the ONLY committed data for this step.  Restore it
                    # before doing anything destructive.
                    if final.exists():
                        shutil.rmtree(final)  # uncommitted replacement
                    old.rename(final)
                    _fsync_path(self.root)
            replacing = (final / _COMMITTED).exists()
            if replacing and not overwrite:
                raise FileExistsError(
                    f"step {step} already committed at {final} "
                    "(pass overwrite=True to replace)"
                )
            if final.exists() and not replacing:
                shutil.rmtree(final)  # renamed but never committed = torn

            t0 = time.time()
            save(tmp / "params", tree)
            # Durability order: data -> rename -> parent dir -> marker ->
            # parent dir.  On overwrite the committed predecessor stays in
            # place (and restorable) until the replacement's data is fully
            # fsynced; a crash inside the two renames leaves both datasets
            # on disk (the predecessor under .replaced_*, healed next open).
            _fsync_tree(tmp)
            if replacing:
                final.rename(old)
                _fsync_path(self.root)
            tmp.rename(final)
            _fsync_path(self.root)
            # The marker goes through temp + rename so its existence is
            # all-or-nothing: a truncated COMMITTED that steps() lists but
            # metadata() cannot parse never exists.
            marker = final / _COMMITTED
            marker_tmp = final / (_COMMITTED + ".tmp")
            marker_tmp.write_text(
                json.dumps(
                    {
                        "step": step,
                        "written_at_unix": round(t0, 3),
                        "save_seconds": round(time.time() - t0, 3),
                        "tags": tags or {},
                    },
                    indent=1,
                )
            )
            _fsync_path(marker_tmp)
            marker_tmp.rename(marker)
            _fsync_path(final)
            if old.exists():
                shutil.rmtree(old)
            self._gc()
            return final

    def save_async(
        self, step: int, tree: Any, *, tags: dict | None = None,
        overwrite: bool = False,
    ) -> AsyncSaveHandle:
        """Snapshot without blocking the caller (e.g. a serving loop) past
        the host copy of the tree."""
        tree = _host_copy(tree)

        def run():
            try:
                self.save(step, tree, tags=tags, overwrite=overwrite)
            except BaseException as e:  # surfaced via handle.wait()
                handle.error = e
                _log.exception("async checkpoint save of step %d failed", step)

        t = threading.Thread(target=run, daemon=True, name=f"ckpt-save-{step}")
        handle = AsyncSaveHandle(t)
        t.start()
        return handle

    # -- restore -------------------------------------------------------------

    def restore(self, step: int | None = None, template: Any | None = None,
                device: Any = None) -> Any:
        """Restore ``step`` (default: latest committed); ``template`` and
        ``device`` as :func:`restore`."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoints in {self.root}")
        final = self._step_dir(step)
        if not (final / _COMMITTED).exists():
            raise FileNotFoundError(f"step {step} is not committed in {self.root}")
        return restore(final / "params", template, device=device)

    # -- GC ------------------------------------------------------------------

    def _gc(self) -> None:
        if self.max_to_keep is None:
            return
        steps = self.steps()
        for step in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
