"""KV handoff wire format: a prompt's committed prefix K/V between replicas
(port of the JAX package's ``server/kv_transfer.py``; byte for byte the
same blobs, so port and JAX replicas hand off to each other).

A disaggregated fleet prefills on one replica and decodes on another: the
prefill replica exports the prompt's whole-chunk prefix K/V, the decode
replica imports it into its radix prefix cache and serves the request as a
cache hit (one seed, then the suffix chunk).

The transfer unit is the radix cache's chunk: host copies of one prefill
chunk's K/V in the layout ``[L, 1, C, NKV, D]``, what the engine reads off
a prefilled row and seeds back in.  The port's chunks are CPU tensors; the
serializer also takes numpy arrays.

Wire layout (one blob a handoff)::

    MAGIC (6 bytes: b"TPKV1\\n")
    header length (8 bytes, little-endian uint64)
    JSON header:
        format_version, chunk_tokens, dtype, kv_shape,
        total_tokens, chunks: [
            {tokens, k_offset, k_nbytes, k_crc32,
                     v_offset, v_nbytes, v_crc32}, ...]
    raw payload (the K and V bytes at the indexed offsets, in order)

Each chunk's K and V carry a CRC32: a truncated or bit-flipped blob raises
:class:`KvTransferError` instead of splicing corrupt K/V into a request.
The token ids ride in the header, so the importer keys the radix inserts
by the exact tokens.

bfloat16 travels as its raw two bytes and is named ``"bfloat16"`` in the
header, as the JAX package names it; numpy has no bfloat16 and this module
needs none (no ``ml_dtypes``): a bfloat16 tensor is read and written
through an int16 view.
"""

from __future__ import annotations

import binascii
import json
from typing import Any

import numpy as np
import torch

MAGIC = b"TPKV1\n"

# Bumped when the wire layout changes; a mismatch is a typed error (the
# router falls back to unified serving, never to garbage K/V).
FORMAT_VERSION = 1

# A handoff blob is one prompt's prefix, not a checkpoint: capped well
# below anything a misbehaving peer could use to balloon the importer.
MAX_BLOB_BYTES = 1 << 30

# Header dtype name -> (torch dtype, numpy dtype of the raw bytes).
_DTYPES = {
    "bfloat16": (torch.bfloat16, np.dtype(np.int16)),
    "float16": (torch.float16, np.dtype(np.float16)),
    "float32": (torch.float32, np.dtype(np.float32)),
    "float64": (torch.float64, np.dtype(np.float64)),
    "int8": (torch.int8, np.dtype(np.int8)),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


class KvTransferError(Exception):
    """Typed failure of a KV handoff blob: bad magic, truncation, CRC
    mismatch, malformed header, or a geometry that the importing engine
    does not have.  Callers treat the handoff as unusable and fall back to
    local prefill."""


def dtype_name(dtype) -> str:
    """The header's name of a torch dtype (as the JAX package writes it)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise KvTransferError(f"no wire name for dtype {dtype}") from None


def _as_raw(x) -> tuple[str, tuple, bytes]:
    """``(dtype name, shape, raw bytes)`` of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        name = dtype_name(t.dtype)
        view = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return name, tuple(t.shape), view.numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(x))
    return a.dtype.name, tuple(a.shape), a.tobytes()


def serialize_chunks(chunk_tokens: int, prompt, chunks: list) -> bytes:
    """Pack ``chunks`` (``[(k, v), ...]`` host pairs ``[L, 1, C, NKV, D]``,
    one a matched chunk of ``prompt``) into one handoff blob.  The first
    ``len(chunks) * chunk_tokens`` tokens of ``prompt`` are the covered
    prefix; their ids ride in the header."""
    if not chunks:
        raise KvTransferError("no chunks to serialize")
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    C = int(chunk_tokens)
    if len(chunks) * C > prompt.size:
        raise KvTransferError(
            f"{len(chunks)} chunks of {C} tokens exceed the {prompt.size}-token prompt"
        )
    name0, shape0, _ = _as_raw(chunks[0][0])
    header: dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "chunk_tokens": C,
        "dtype": name0,
        "kv_shape": list(shape0),
        "total_tokens": len(chunks) * C,
        "chunks": [],
    }
    parts: list[bytes] = []
    offset = 0
    for idx, (k, v) in enumerate(chunks):
        kname, kshape, kraw = _as_raw(k)
        vname, vshape, vraw = _as_raw(v)
        if kshape != shape0 or vshape != shape0 or kname != name0:
            raise KvTransferError(
                f"chunk {idx} geometry {kshape}/{kname} differs from chunk 0 "
                f"{shape0}/{name0}"
            )
        header["chunks"].append({
            "tokens": prompt[idx * C:(idx + 1) * C].tolist(),
            "k_offset": offset,
            "k_nbytes": len(kraw),
            "k_crc32": binascii.crc32(kraw) & 0xFFFFFFFF,
            "v_offset": offset + len(kraw),
            "v_nbytes": len(vraw),
            "v_crc32": binascii.crc32(vraw) & 0xFFFFFFFF,
        })
        parts += (kraw, vraw)
        offset += len(kraw) + len(vraw)
    head = json.dumps(header).encode()
    return b"".join([MAGIC, len(head).to_bytes(8, "little"), head, *parts])


def _to_tensor(raw, name: str, shape: tuple, pin_memory: bool) -> torch.Tensor:
    """Raw bytes -> a CPU tensor of the header's dtype and shape (pinned
    when asked, so the seed's copy to the card is one DMA)."""
    tdtype, ndtype = _DTYPES[name]
    src = np.frombuffer(raw, dtype=ndtype).reshape(shape)
    out = torch.empty(shape, dtype=tdtype, pin_memory=pin_memory)
    dst = out.view(torch.int16) if tdtype == torch.bfloat16 else out
    dst.numpy()[...] = src
    return out


def deserialize_chunks(blob: bytes, pin_memory: bool = False) -> tuple[dict[str, Any], list]:
    """Unpack a handoff blob into ``(header, [(k, v), ...])``, CPU tensors
    (pinned with ``pin_memory``).  Every chunk's CRC is checked before its
    bytes are used; any structural fault raises :class:`KvTransferError`."""
    if len(blob) > MAX_BLOB_BYTES:
        raise KvTransferError(
            f"handoff blob of {len(blob)} bytes exceeds the {MAX_BLOB_BYTES}-byte cap"
        )
    if not blob.startswith(MAGIC):
        raise KvTransferError("bad magic: not a KV handoff blob")
    if len(blob) < len(MAGIC) + 8:
        raise KvTransferError("truncated handoff blob: no header length")
    head_len = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 8], "little")
    head_start = len(MAGIC) + 8
    if head_start + head_len > len(blob):
        raise KvTransferError("truncated handoff blob: header cut short")
    try:
        header = json.loads(blob[head_start:head_start + head_len])
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise KvTransferError(f"malformed handoff header: {e}") from e
    if not isinstance(header, dict) or not isinstance(header.get("chunks"), list):
        raise KvTransferError("malformed handoff header: bad shape")
    if int(header.get("format_version", -1)) != FORMAT_VERSION:
        raise KvTransferError(
            f"handoff format v{header.get('format_version')} != v{FORMAT_VERSION}"
        )
    try:
        name = str(header["dtype"])
        if name not in _DTYPES:
            raise ValueError(f"unsupported dtype {name!r}")
        shape = tuple(int(d) for d in header["kv_shape"])
        C = int(header["chunk_tokens"])
    except (KeyError, TypeError, ValueError) as e:
        raise KvTransferError(f"malformed handoff header: {e}") from e
    payload = memoryview(blob)[head_start + head_len:]
    chunks: list = []
    expected_off = 0
    for idx, entry in enumerate(header["chunks"]):
        try:
            tokens = entry["tokens"]
            pairs = [
                (entry["k_offset"], entry["k_nbytes"], entry["k_crc32"]),
                (entry["v_offset"], entry["v_nbytes"], entry["v_crc32"]),
            ]
        except (KeyError, TypeError) as e:
            raise KvTransferError(f"malformed chunk {idx} manifest: {e}") from e
        if not isinstance(tokens, list) or len(tokens) != C:
            n = len(tokens) if isinstance(tokens, list) else "?"
            raise KvTransferError(f"chunk {idx} carries {n} tokens, expected {C}")
        # Sequential layout only: entries that alias the same payload bytes
        # would let the decoded size outgrow the blob cap many times over.
        (k_off, k_n, _), (v_off, v_n, _) = ((int(p[0]), int(p[1]), p[2]) for p in pairs)
        if k_off != expected_off or v_off != k_off + k_n:
            raise KvTransferError(
                f"chunk {idx} payload offsets overlap or leave gaps "
                "(sequential layout required)"
            )
        expected_off = v_off + v_n
        arrs = []
        for off, nbytes, crc in pairs:
            off, nbytes = int(off), int(nbytes)
            raw = payload[off:off + nbytes]
            if len(raw) != nbytes:
                raise KvTransferError(
                    f"chunk {idx} truncated: wanted {nbytes} bytes at offset {off}, "
                    f"got {len(raw)}"
                )
            if (binascii.crc32(raw) & 0xFFFFFFFF) != int(crc):
                raise KvTransferError(f"chunk {idx} failed CRC")
            try:
                arrs.append(_to_tensor(raw, name, shape, pin_memory))
            except ValueError as e:
                # The byte count disagrees with shape x dtype: structural
                # corruption, typed like every other.
                raise KvTransferError(
                    f"chunk {idx} byte count {nbytes} does not fit shape {shape} x "
                    f"{name}: {e}"
                ) from e
        chunks.append((arrs[0], arrs[1]))
    return header, chunks


def chunk_token_ids(header: dict[str, Any]) -> np.ndarray:
    """The covered prefix's token ids in chunk order: the prompt prefix the
    importer keys its radix inserts by."""
    out: list[int] = []
    for entry in header["chunks"]:
        out.extend(int(t) for t in entry["tokens"])
    return np.asarray(out, np.int32)
