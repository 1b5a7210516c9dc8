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

The sharded layout (a mesh of several ranks, one process a rank) is the
reference's: a leaf the mesh partitions carries ``spec`` (its
PartitionSpec as data, axes the mesh lacks dropped) and ``shards``, one
``(file, offset, nbytes, crc32, start, shape)`` record a DISTINCT block
(ranks that differ only on an axis the spec does not name hold the same
block, which is written once), sorted by start; a replicated leaf keeps
the flat record.  A manifest either package writes restores in the other.
Each rank writes its own blocks: the ranks whose coordinates are 0 on
every axis a leaf's spec leaves out write that leaf's block into chunk
files of their own (``chunk-r<rank>-<n>.bin``) in one staging directory
the leader names, rank 0 writes the replicated leaves, and the leader
gathers the records (small host objects over the world-wide gloo control
group), writes the manifest and renames the directory into place.  No
block crosses the process group and no rank holds another's.  A restore
reads this rank's block of each sharded leaf (the record whose start is
the rank's block origin on the running mesh) and every replicated leaf,
nothing else; a layout the running mesh cannot place (a sharded leaf on
one device, a missing block) is a :class:`SnapshotMismatch`.

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


def _spec_data(spec, mesh_shape: dict) -> list:
    """A PartitionSpec as the manifest stores it: an axis name, a list of
    them, or None a dimension, axes the mesh lacks dropped (the reference's
    ``_spec_on_mesh`` then ``_spec_to_data``)."""
    out = []
    for entry in spec:
        if isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry if a in mesh_shape] or None)
        else:
            out.append(str(entry) if entry is not None and entry in mesh_shape else None)
    return out


def _entry_axes(entry) -> list:
    if entry is None:
        return []
    return list(entry) if isinstance(entry, (tuple, list)) else [entry]


def block_of(shape, spec_data: list, mesh) -> tuple[tuple, tuple] | None:
    """``(start, block shape)`` of this rank's block of a leaf of full
    ``shape`` cut by ``spec_data`` on ``mesh`` (a ``parallel.ServingMesh``),
    the cut ``parallel.sharding`` makes; None when no axis of the spec has
    size > 1 there (the leaf is replicated)."""
    start, block, cut = [], [], False
    for d, size in enumerate(shape):
        entry = spec_data[d] if d < len(spec_data) else None
        axes = [a for a in _entry_axes(entry) if mesh.size(a) > 1]
        n, idx = 1, 0
        for a in axes:  # row-major over the entry's axes
            n *= mesh.size(a)
            idx = idx * mesh.size(a) + mesh.index(a)
        if size % n:
            raise SnapshotMismatch(f"axis {d} of size {size} does not split into {n} blocks")
        w = size // n
        start.append(idx * w)
        block.append(w)
        cut = cut or n > 1
    return (tuple(start), tuple(block)) if cut else None


def _writes_block(spec_data: list, mesh) -> bool:
    """Whether this rank writes its block of a leaf cut by ``spec_data``:
    the first of the ranks that hold the same block (coordinate 0 on every
    axis the spec does not name)."""
    named = {a for entry in spec_data for a in _entry_axes(entry)}
    return all(mesh.index(a) == 0 for a in mesh.shape if a not in named)


def _crc(data, value: int = 0) -> int:
    # zlib.crc32 is binascii.crc32's CRC-32 and lets go of the GIL on
    # large buffers, so the reader thread's checks overlap the copies.
    return zlib.crc32(data, value) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


class _ChunkWriter:
    """Appends leaf bytes to chunk files ``<prefix><n>.bin`` of at most
    ``chunk_bytes`` (a larger blob gets a file of its own)."""

    def __init__(self, directory: Path, prefix: str, chunk_bytes: int):
        self.dir, self.prefix, self.chunk_bytes = directory, prefix, chunk_bytes
        # "used" starts past the bound so the first blob opens file 0.
        self.idx, self.f, self.used, self.total = -1, None, chunk_bytes + 1, 0

    def emit(self, raw: np.ndarray) -> dict:
        """Write one blob; its ``file``, ``offset``, ``nbytes`` and ``crc32``."""
        n = int(raw.size)
        if self.used + n > self.chunk_bytes and self.used > 0:
            self.close()
            self.idx += 1
            self.f = open(self.dir / self.name, "wb")
            self.used = 0
        off = self.used
        self.f.write(memoryview(raw))
        self.used += n
        self.total += n
        return {"file": self.name, "offset": off, "nbytes": n, "crc32": _crc(memoryview(raw))}

    @property
    def name(self) -> str:
        return f"{self.prefix}{self.idx:05d}.bin"

    def close(self) -> None:
        if self.f is not None:
            self.f.close()
            self.f = None


def _manifest(identity, flavor, config, builder_kwargs, total: int, leaves: list) -> dict:
    return {
        "format_version": FORMAT_VERSION,
        "identity": identity,
        "content_hash": content_hash(identity),
        "flavor": flavor,
        "config": config or {},
        "builder_kwargs": builder_kwargs or {},
        "total_bytes": total,
        "leaves": leaves,
    }


def _publish(staging: Path, target: Path, manifest: dict) -> None:
    (staging / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
    if target.exists():
        shutil.rmtree(target)
    os.replace(staging, target)


def write_snapshot(snapshot_dir: str | Path, params: Any, *, identity: dict[str, Any],
                   flavor: str, config: dict | None = None,
                   builder_kwargs: dict | None = None,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES, mesh=None,
                   specs: dict | None = None) -> Path:
    """Write the tree as a snapshot; returns its path.

    Atomic: everything is staged in a temporary directory beside the target
    and renamed into place, so a crash mid-write leaves no half-snapshot.
    Writing over a snapshot of the same model uri replaces it whole.

    ``mesh`` (a ``parallel.ServingMesh`` of several ranks): ``params`` is
    this rank's block tree and ``specs`` maps each flattened key to its
    PartitionSpec; every rank of the world calls this together and the
    sharded layout is written (the module docstring)."""
    from .loader import _flatten

    target = snapshot_path_for(snapshot_dir, identity["model_uri"])
    target.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    flat = _flatten(params)
    if mesh is not None and mesh.world > 1:
        total, n_leaves = _write_sharded(target, flat, identity, flavor, config,
                                         builder_kwargs, chunk_bytes, mesh, specs or {})
    else:
        staging = Path(tempfile.mkdtemp(prefix=".snapshot-", dir=str(target.parent)))
        w = _ChunkWriter(staging, "chunk-", chunk_bytes)
        try:
            leaves = []
            try:
                for key in sorted(flat):
                    name, shape, raw = _leaf_bytes(flat[key])
                    leaves.append({"key": key, "dtype": name, "shape": shape, **w.emit(raw)})
            finally:
                w.close()
            _publish(staging, target, _manifest(identity, flavor, config, builder_kwargs,
                                                w.total, leaves))
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        total, n_leaves = w.total, len(leaves)
    _log.info("wrote snapshot %s: %d leaves, %.2f GiB in %.1fs", target, n_leaves,
              total / 2**30, time.perf_counter() - t0)
    return target


def _write_sharded(target: Path, flat: dict, identity, flavor, config, builder_kwargs,
                   chunk_bytes: int, mesh, specs: dict) -> tuple[int, int]:
    """Every rank's part of a sharded write (the module docstring); returns
    the snapshot's total bytes and leaf count on every rank, or raises
    :class:`SnapshotError` on every rank when any rank failed."""
    import torch.distributed as dist

    from ..parallel.distributed import control_group

    group = control_group()
    rank = dist.get_rank()
    box = [str(tempfile.mkdtemp(prefix=".snapshot-", dir=str(target.parent)))
           if rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=group)
    staging = Path(box[0])
    mine: dict = {"flat": [], "blocks": [], "error": None}
    w = _ChunkWriter(staging, f"chunk-r{rank:03d}-", chunk_bytes)
    try:
        try:
            for key in sorted(flat):
                leaf = flat[key]
                spec = _spec_data(specs.get(key, ()), mesh.shape)
                # ``leaf`` is this rank's block: the full leaf is it times the splits.
                full = ([int(b) * n for b, n in zip(leaf.shape, _splits(spec, mesh))]
                        if len(spec) == len(leaf.shape) else list(leaf.shape))
                blk = block_of(full, spec, mesh) if len(spec) == len(leaf.shape) else None
                if blk is None:
                    if rank == 0:
                        name, shape, raw = _leaf_bytes(leaf)
                        mine["flat"].append({"key": key, "dtype": name, "shape": shape,
                                             **w.emit(raw)})
                    continue
                if not _writes_block(spec, mesh):
                    continue
                start, bshape = blk
                name, _, raw = _leaf_bytes(leaf)
                mine["blocks"].append({"key": key, "dtype": name, "shape": full, "spec": spec,
                                       "shard": {**w.emit(raw), "start": list(start),
                                                 "shape": list(bshape)}})
        finally:
            w.close()
    except Exception as e:  # every rank still joins the gather below
        mine["error"] = f"rank {rank}: {e}"
    mine["total"] = w.total
    parts = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(mine, parts, dst=0, group=group)
    result = [None]
    if rank == 0:
        errors = [p["error"] for p in parts if p["error"]]
        try:
            if errors:
                raise SnapshotError("; ".join(errors))
            entries = {e["key"]: e for e in parts[0]["flat"]}
            for p in parts:
                for b in p["blocks"]:
                    e = entries.setdefault(b["key"], {k: b[k] for k in
                                                      ("key", "dtype", "shape", "spec")}
                                           | {"shards": []})
                    e["shards"].append(b["shard"])
            for e in entries.values():
                if "shards" in e:
                    e["shards"].sort(key=lambda r: tuple(r["start"]))
            total = sum(p["total"] for p in parts)
            leaves = [entries[k] for k in sorted(entries)]
            _publish(staging, target, _manifest(identity, flavor, config, builder_kwargs,
                                                total, leaves))
            result = [(total, len(leaves))]
        except Exception as e:
            shutil.rmtree(staging, ignore_errors=True)
            result = [f"{type(e).__name__}: {e}"]
    dist.broadcast_object_list(result, src=0, group=group)
    if isinstance(result[0], str):
        raise SnapshotError(f"sharded snapshot write failed: {result[0]}")
    return result[0]


def _splits(spec_data: list, mesh) -> list[int]:
    """The blocks each dimension of a leaf cut by ``spec_data`` splits into
    on ``mesh``."""
    out = []
    for entry in spec_data:
        n = 1
        for a in _entry_axes(entry):
            n *= mesh.size(a)
        out.append(n)
    return out


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


def _record(key: str, dtype: str, shape, rec: dict) -> dict:
    """One read of the restore: a flat leaf, or this rank's block of one."""
    try:
        out = {"key": str(key), "dtype": TORCH_DTYPES[dtype],
               "shape": [int(d) for d in shape], "file": str(rec["file"]),
               "offset": int(rec["offset"]), "nbytes": int(rec["nbytes"]),
               "crc32": int(rec["crc32"])}
    except (KeyError, TypeError, ValueError) as e:
        raise SnapshotError(f"malformed snapshot leaf {key!r}: {e}") from e
    want = int(np.prod(out["shape"], dtype=np.int64)) * out["dtype"].itemsize
    if out["nbytes"] != want:
        raise SnapshotError(f"snapshot leaf {key!r}: {out['nbytes']} bytes do not fit shape "
                            f"{out['shape']} x {dtype}")
    return out


def read_plan(manifest: dict, mesh=None) -> list[dict]:
    """The records a restore on ``mesh`` (a ``parallel.ServingMesh``; None
    or one rank: a single device) reads: every flat leaf, and of each
    sharded leaf only the block this rank holds.  A layout the mesh cannot
    place raises :class:`SnapshotMismatch`: a sharded leaf on a single
    device, a spec naming an axis the mesh does not split, a missing
    block."""
    single = mesh is None or mesh.world == 1
    ident_mesh = (manifest.get("identity") or {}).get("mesh_shape") or {}
    devices = int(np.prod([int(v) for v in ident_mesh.values()] or [1]))
    if single and (devices > 1 or any("shards" in leaf for leaf in manifest["leaves"])):
        raise SnapshotMismatch(
            f"snapshot baked for mesh {ident_mesh} in the sharded layout; a single-device "
            "restore cannot place it (it restores on a mesh of as many ranks)")
    if not single and devices != mesh.world:
        raise SnapshotMismatch(f"snapshot baked for mesh {ident_mesh} ({devices} devices); "
                               f"this mesh {mesh.shape} has {mesh.world} ranks")
    records = []
    for leaf in manifest["leaves"]:
        if not isinstance(leaf, dict):
            raise SnapshotError(f"malformed snapshot leaf {leaf!r}")
        key = leaf.get("key")
        if "shards" not in leaf:
            records.append(_record(key, leaf.get("dtype"), leaf.get("shape"), leaf))
            continue
        try:
            shape = [int(d) for d in leaf["shape"]]
            spec = list(leaf["spec"])
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotError(f"malformed sharded snapshot leaf {key!r}: {e}") from e
        if any(a not in mesh.shape for entry in spec for a in _entry_axes(entry)):
            raise SnapshotMismatch(f"snapshot leaf {key!r} is cut over {spec}, axes this mesh "
                                   f"{mesh.shape} lacks")
        blk = block_of(shape, spec, mesh)
        start, bshape = blk if blk is not None else ((0,) * len(shape), tuple(shape))
        match = [r for r in leaf["shards"] if tuple(r.get("start", ())) == start]
        if not match or tuple(match[0].get("shape", ())) != bshape:
            raise SnapshotMismatch(f"snapshot leaf {key!r} has no block at {list(start)} of "
                                   f"shape {list(bshape)} for this rank of mesh {mesh.shape}")
        records.append(_record(key, leaf.get("dtype"), bshape, match[0]))
    return records


def check_placeable(manifest: dict, mesh=None) -> None:
    """Raise :class:`SnapshotMismatch` for a layout the running mesh cannot
    place (:func:`read_plan`)."""
    read_plan(manifest, mesh)


def load_snapshot(path: str | Path, *, identity: dict[str, Any] | None = None,
                  stats: dict | None = None, device=None,
                  mesh=None) -> tuple[Any, dict[str, Any]]:
    """Restore ``(params, manifest)`` from a snapshot directory onto
    ``device`` (``cuda`` unless named).

    With ``identity``, a mismatch raises :class:`SnapshotMismatch` before
    any leaf is read.  Each leaf's CRC is checked as it streams; a missing
    or truncated chunk or a CRC mismatch raises :class:`SnapshotError` and
    nothing is returned.  ``stats`` receives ``restore_s``, ``disk_s`` (the
    reader's reads and CRCs), ``transfer_s`` (this thread's copy launches
    and waits) and ``read_gib``.  ``mesh`` (a ``parallel.ServingMesh`` of
    several ranks): the tree returned is this rank's blocks, and only they
    and the replicated leaves are read."""
    from .generation import resolve_device
    from .loader import _unflatten

    dev = resolve_device(device)
    path = Path(path)
    manifest = read_manifest(path)
    if identity is not None:
        check_identity(manifest, identity)
    records = read_plan(manifest, mesh)
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
