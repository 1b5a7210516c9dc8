"""Pre-baked weight snapshots: the served parameter tree on disk, restored
with no transform work (port of the JAX package's ``server/snapshot.py``;
the same directory layout, manifest and chunk files, so a snapshot baked
by either package restores in the other).

A snapshot is the tree exactly as the engine serves it, after
quantization (``q8`` and ``scale`` planes included), written once after
the first cold load.  A restore is a straight stream from disk to the card:
for ``int8`` about half the bytes of the bf16 artifact, and no quantize
stage.

Layout (one directory a snapshot)::

    <dir>/<sha256(model_uri)[:16]>/
        SNAPSHOT.json     # manifest: format version, identity, leaf index
        chunk-00000.bin   # leaf bytes, concatenated (bounded size)
        chunk-00001.bin
        ...

The manifest indexes every leaf as ``(key, dtype, shape, file, offset,
nbytes, crc32)``, keys sorted, leaves never split across files (a leaf
larger than the bound gets a file of its own).  bfloat16 leaves are their
raw two bytes, named ``"bfloat16"``; this module reads and writes them
through an int16 view and needs no ``ml_dtypes``.

The restore streams: a reader thread reads each leaf in pieces into a ring
of pinned host buffers and checks its CRC, while this thread copies each
piece to the card asynchronously; a buffer is reused once its copy is done.

Only the single-device layout is ported.  The JAX package's tensor-parallel
layout (a leaf's ``shards``, an identity with a mesh of more than one
device) waits for the sharded snapshot layout, the slice after the port's
tp and dp: such a manifest is a :class:`SnapshotMismatch`, a miss and a
cold load, never a partial restore.

Identity and invalidation: keyed by a content hash of ``(model uri,
quantize mode, mesh shape, format version)``; any mismatch misses and the
caller cold-loads (and bakes again).  Corruption (a truncated chunk, a CRC
mismatch, a malformed manifest) raises :class:`SnapshotError`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import shutil
import tempfile
import threading
import time
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

_log = logging.getLogger("tpumlops_torch.snapshot")

# Bumped when the on-disk layout changes; a version mismatch is an ordinary
# miss (cold load and a new bake), never an error.
FORMAT_VERSION = 1

MANIFEST_NAME = "SNAPSHOT.json"

# Leaves are packed into chunk files of at most this many bytes (a larger
# leaf gets its own file).
DEFAULT_CHUNK_BYTES = 256 * 2**20

# The restore's pinned staging ring: pieces of at most PIECE_BYTES, NUM_PIECES
# buffers in flight between the reader thread and the copies to the card.
PIECE_BYTES = 64 * 2**20
NUM_PIECES = 4

# Manifest dtype name <-> torch dtype (bfloat16 through its int16 bits).
TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_DTYPE_NAMES = {t: name for name, t in TORCH_DTYPES.items()}


class SnapshotError(Exception):
    """Typed failure of a snapshot read: a corrupt or truncated chunk, a CRC
    mismatch, a malformed manifest.  The snapshot is unusable; callers fall
    back to the cold load."""


class SnapshotMismatch(SnapshotError):
    """The snapshot was baked for another identity (model, quantize mode,
    mesh) or format version, or in a layout this port cannot place: a miss,
    not corruption."""


# ---------------------------------------------------------------------------
# Identity
# ---------------------------------------------------------------------------


def snapshot_identity(model_uri: str, quantize: str | None,
                      mesh_shape: dict | None) -> dict[str, Any]:
    """The invalidation key: everything that changes the tree a load makes."""
    return {
        "model_uri": str(model_uri),
        "quantize": quantize or "none",
        "mesh_shape": {k: int(v) for k, v in sorted((mesh_shape or {}).items())},
        "format_version": FORMAT_VERSION,
    }


def content_hash(identity: dict[str, Any]) -> str:
    """Stable short hash of an identity (sorted-key JSON, sha256)."""
    blob = json.dumps(identity, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def snapshot_path_for(snapshot_dir: str | Path, model_uri: str) -> Path:
    """Where ``model_uri``'s snapshot lives: keyed by the uri only, so a
    change of quantize mode or mesh lands in the same place, misses on the
    manifest's hash and is baked again over it."""
    tag = hashlib.sha256(str(model_uri).encode()).hexdigest()[:16]
    return Path(snapshot_dir) / tag


# ---------------------------------------------------------------------------
# Leaves as bytes
# ---------------------------------------------------------------------------


def _leaf_bytes(leaf: Any) -> tuple[str, list, np.ndarray]:
    """``(dtype name, shape, flat uint8 view)`` of a leaf: a tensor (on any
    device, copied to the host) or anything numpy takes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        try:
            name = _DTYPE_NAMES[t.dtype]
        except KeyError:
            raise SnapshotError(f"no snapshot dtype for {t.dtype}") from None
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        arr = bits.numpy()
        return name, list(t.shape), np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.dtype.name, list(arr.shape), arr.reshape(-1).view(np.uint8)


def _crc(data, value: int = 0) -> int:
    # zlib.crc32 is binascii.crc32's CRC-32 and lets go of the GIL on
    # large buffers, so the reader thread's checks overlap the copies.
    return zlib.crc32(data, value) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def write_snapshot(snapshot_dir: str | Path, params: Any, *, identity: dict[str, Any],
                   flavor: str, config: dict | None = None,
                   builder_kwargs: dict | None = None,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Path:
    """Write the tree as a snapshot; returns its path.

    Atomic: everything is staged in a temporary directory beside the target
    and renamed into place, so a crash mid-write leaves no half-snapshot.
    Writing over a snapshot of the same model uri replaces it whole."""
    from .loader import _flatten

    target = snapshot_path_for(snapshot_dir, identity["model_uri"])
    target.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    flat = _flatten(params)
    staging = Path(tempfile.mkdtemp(prefix=".snapshot-", dir=str(target.parent)))
    try:
        leaves = []
        # The chunk file being filled; "used" starts past the bound so the
        # first leaf opens chunk 0.
        state = {"idx": -1, "f": None, "used": chunk_bytes + 1, "total": 0}

        def emit(raw: np.ndarray) -> tuple[str, int]:
            n = int(raw.size)
            if state["used"] + n > chunk_bytes and state["used"] > 0:
                if state["f"] is not None:
                    state["f"].close()
                state["idx"] += 1
                state["f"] = open(staging / f"chunk-{state['idx']:05d}.bin", "wb")
                state["used"] = 0
            off = state["used"]
            state["f"].write(memoryview(raw))
            state["used"] += n
            state["total"] += n
            return f"chunk-{state['idx']:05d}.bin", off

        try:
            for key in sorted(flat):
                name, shape, raw = _leaf_bytes(flat[key])
                fname, off = emit(raw)
                leaves.append({
                    "key": key,
                    "dtype": name,
                    "shape": shape,
                    "file": fname,
                    "offset": off,
                    "nbytes": int(raw.size),
                    "crc32": _crc(memoryview(raw)),
                })
        finally:
            if state["f"] is not None:
                state["f"].close()
        total = state["total"]
        manifest = {
            "format_version": FORMAT_VERSION,
            "identity": identity,
            "content_hash": content_hash(identity),
            "flavor": flavor,
            "config": config or {},
            "builder_kwargs": builder_kwargs or {},
            "total_bytes": total,
            "leaves": leaves,
        }
        (staging / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
        if target.exists():
            shutil.rmtree(target)
        os.replace(staging, target)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    _log.info("wrote snapshot %s: %d leaves, %.2f GiB in %.1fs", target, len(leaves),
              total / 2**30, time.perf_counter() - t0)
    return target


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def read_manifest(path: str | Path) -> dict[str, Any]:
    """Parse and check the shape of a snapshot manifest; anything malformed
    raises :class:`SnapshotError`."""
    mf = Path(path) / MANIFEST_NAME
    if not mf.exists():
        raise SnapshotError(f"no {MANIFEST_NAME} in {path}")
    try:
        manifest = json.loads(mf.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotError(f"unreadable snapshot manifest {mf}: {e}") from e
    if not isinstance(manifest, dict) or not isinstance(manifest.get("leaves"), list):
        raise SnapshotError(f"malformed snapshot manifest {mf}")
    return manifest


def check_identity(manifest: dict, identity: dict[str, Any]) -> None:
    """Raise :class:`SnapshotMismatch` unless the manifest was baked for
    exactly this identity (the format version rides inside it)."""
    if int(manifest.get("format_version", -1)) != FORMAT_VERSION:
        raise SnapshotMismatch(
            f"snapshot format v{manifest.get('format_version')} != v{FORMAT_VERSION}")
    if manifest.get("content_hash") != content_hash(identity):
        raise SnapshotMismatch(
            f"snapshot identity mismatch: baked for {manifest.get('identity')}, "
            f"requested {identity}")


def check_placeable(manifest: dict) -> None:
    """Raise :class:`SnapshotMismatch` for a layout this port cannot place: a
    leaf stored by shards, or an identity whose mesh spans several devices."""
    mesh = (manifest.get("identity") or {}).get("mesh_shape") or {}
    devices = int(np.prod([int(v) for v in mesh.values()] or [1]))
    if devices > 1 or any("shards" in leaf for leaf in manifest["leaves"]):
        raise SnapshotMismatch(
            f"snapshot baked for mesh {mesh} in the sharded layout; the port "
            "restores single-device snapshots only (the sharded snapshot layout "
            "is the next slice of its parallelism)")


def load_snapshot(path: str | Path, *, identity: dict[str, Any] | None = None,
                  stats: dict | None = None, device=None) -> tuple[Any, dict[str, Any]]:
    """Restore ``(params, manifest)`` from a snapshot directory onto
    ``device`` (``cuda`` unless named).

    With ``identity``, a mismatch raises :class:`SnapshotMismatch` before
    any leaf is read.  Each leaf's CRC is checked as it streams; a missing
    or truncated chunk or a CRC mismatch raises :class:`SnapshotError` and
    nothing is returned.  ``stats`` receives ``restore_s``, ``disk_s`` (the
    reader's reads and CRCs), ``transfer_s`` (this thread's copy launches
    and waits) and ``read_gib``."""
    from .generation import resolve_device
    from .loader import _unflatten

    dev = resolve_device(device)
    path = Path(path)
    manifest = read_manifest(path)
    if identity is not None:
        check_identity(manifest, identity)
    check_placeable(manifest)
    records = []
    for leaf in manifest["leaves"]:
        try:
            records.append({
                "key": str(leaf["key"]), "dtype": TORCH_DTYPES[leaf["dtype"]],
                "shape": [int(d) for d in leaf["shape"]], "file": str(leaf["file"]),
                "offset": int(leaf["offset"]), "nbytes": int(leaf["nbytes"]),
                "crc32": int(leaf["crc32"]),
            })
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotError(f"malformed snapshot leaf {leaf!r}: {e}") from e
        rec = records[-1]
        want = int(np.prod(rec["shape"], dtype=np.int64)) * rec["dtype"].itemsize
        if rec["nbytes"] != want:
            raise SnapshotError(
                f"snapshot leaf {rec['key']!r}: {rec['nbytes']} bytes do not fit shape "
                f"{rec['shape']} x {leaf['dtype']}")

    cuda = dev.type == "cuda"
    t_wall = time.perf_counter()
    timing = {"disk_s": 0.0, "transfer_s": 0.0, "read_bytes": 0}
    bufs = [torch.empty(PIECE_BYTES, dtype=torch.uint8, pin_memory=cuda)
            for _ in range(NUM_PIECES)]
    done = [None] * NUM_PIECES  # the event of each buffer's last copy
    free: queue.Queue = queue.Queue()
    for i in range(NUM_PIECES):
        free.put(i)
    pieces: queue.Queue = queue.Queue()
    reader_error: list[BaseException] = []
    abort = threading.Event()

    def reader() -> None:
        f, open_name = None, None
        try:
            for rec in records:
                if rec["file"] != open_name:
                    if f is not None:
                        f.close()
                    fpath = path / rec["file"]
                    if not fpath.exists():
                        raise SnapshotError(f"snapshot chunk {rec['file']} missing in {path}")
                    f, open_name = open(fpath, "rb"), rec["file"]
                f.seek(rec["offset"])
                crc, off, left = 0, 0, rec["nbytes"]
                while left > 0 or off == 0:
                    i = free.get()
                    if abort.is_set():
                        return
                    if done[i] is not None:
                        done[i].synchronize()  # its previous copy has landed
                    t0 = time.perf_counter()
                    n = min(PIECE_BYTES, left)
                    view = memoryview(bufs[i].numpy())[:n]
                    got = f.readinto(view) if n else 0
                    if got != n:
                        raise SnapshotError(
                            f"snapshot chunk {rec['file']} truncated at leaf "
                            f"{rec['key']!r}: wanted {rec['nbytes']} bytes, got {off + got}")
                    crc = _crc(view, crc)
                    left -= n
                    last = left == 0
                    if last and crc != rec["crc32"]:
                        raise SnapshotError(
                            f"snapshot leaf {rec['key']!r} failed CRC in {rec['file']}")
                    timing["disk_s"] += time.perf_counter() - t0
                    timing["read_bytes"] += n
                    pieces.put((rec, i, off, n, last))
                    off += n
                    if last:
                        break
        except BaseException as e:
            reader_error.append(e)
        finally:
            if f is not None:
                f.close()
            pieces.put(None)

    thread = threading.Thread(target=reader, daemon=True, name="snapshot-reader")
    thread.start()
    leaves: dict[str, torch.Tensor] = {}
    dst = None
    try:
        while True:
            item = pieces.get()
            if item is None:
                break
            rec, i, off, n, last = item
            t0 = time.perf_counter()
            if off == 0:
                dst = torch.empty(rec["nbytes"], dtype=torch.uint8, device=dev)
            if n:
                dst[off:off + n].copy_(bufs[i][:n], non_blocking=cuda)
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                done[i] = ev
            free.put(i)
            if last:
                leaves[rec["key"]] = dst.view(rec["dtype"]).view(rec["shape"])
                dst = None
            timing["transfer_s"] += time.perf_counter() - t0
        if cuda:
            t0 = time.perf_counter()
            torch.cuda.synchronize(dev)
            timing["transfer_s"] += time.perf_counter() - t0
    except BaseException:
        abort.set()
        for _ in range(NUM_PIECES):
            free.put(0)  # unblock the reader at its next wait
        raise
    finally:
        thread.join()
    if reader_error:
        err = reader_error[0]
        if isinstance(err, SnapshotError):
            raise err
        raise SnapshotError(f"snapshot read failed: {err}") from err
    if stats is not None:
        stats.update(
            restore_s=round(time.perf_counter() - t_wall, 3),
            disk_s=round(timing["disk_s"], 3),
            transfer_s=round(timing["transfer_s"], 3),
            read_gib=round(timing["read_bytes"] / 2**30, 3),
        )
    return _unflatten(leaves), manifest
