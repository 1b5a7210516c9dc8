"""The port's weight snapshots against the JAX package, on the CPU.
Counterpart: ``tests/test_snapshot.py`` (its single-device cases).

- Round trips of the served tree, bit for bit, for ``none``, ``int8`` and
  ``int8kv`` (q8 and scale planes as their own leaves; no quantize stage
  on a restore; ``eos_id`` through the manifest), in pieces smaller than a
  leaf too; the identity hash over quantize mode, mesh and format; a
  quantize mismatch falls back with one warning and bakes again; a format
  bump is a miss; a truncated or bit-flipped chunk is a typed error, and
  the loader moves a corrupt snapshot aside and bakes again; a never-baked
  model loads cold without a warning; a failed write leaves nothing.
- Across packages: the same tree gives byte-identical chunk files and the
  same leaf index; a tree the reference's ``write_snapshot`` wrote restores
  in the port equal to ``convert.from_jax_numpy`` of it, and the port's
  reads back in the reference's ``load_snapshot`` leaf for leaf; a JAX
  loader's bake restores through the port's loader and the other way; a
  ``tp: 4`` manifest is a miss in the port, never a partial restore.
"""

from __future__ import annotations

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    snapshot as snap,
)
from tpumlops.models import llama as J
from tpumlops.server import loader as jloader
from tpumlops.server import snapshot as jsnap

MESH = {"dp": 1, "tp": 1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_artifact(tmp_path_factory):
    cfg = J.LlamaConfig.tiny(max_seq=64)
    art = tmp_path_factory.mktemp("snap-artifact") / "model"
    jloader.save_native_model(
        art, "llama-generate", J.init(jax.random.key(7), cfg, dtype=jnp.bfloat16),
        config={"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
                "num_kv_heads": cfg.num_kv_heads, "intermediate_size": cfg.intermediate_size,
                "max_seq": cfg.max_seq},
        builder_kwargs={"eos_id": 2},
    )
    return str(art)


def _load(art, quantize, snapdir, stats=None):
    return tloader.load_predictor(art, quantize=quantize, device="cpu", snapshot_dir=snapdir,
                                  load_stats=stats)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = convert.to_numpy(x)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _trees_bit_identical(a, b) -> None:
    fa, fb = tloader._flatten(a), tloader._flatten(b)
    assert sorted(fa) == sorted(fb)
    for key in fa:
        x, y = fa[key], fb[key]
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert np.array_equal(_bits(x), _bits(y)), f"leaf {key} not bit-identical"


@pytest.mark.parametrize("quantize", ["none", "int8", "int8kv"])
def test_round_trip_bit_identical(tiny_artifact, tmp_path, quantize):
    snapdir = str(tmp_path / f"snaps-{quantize}")
    cold_stats: dict = {}
    cold = _load(tiny_artifact, quantize, snapdir, cold_stats)
    assert "restore_s" not in cold_stats and cold_stats["wall_s"] >= 0
    assert ("quantize_s" in cold_stats) == (quantize != "none")
    stats: dict = {}
    restored = _load(tiny_artifact, quantize, snapdir, stats)
    assert stats.get("restore_s") is not None, stats
    assert "quantize_s" not in stats and {"disk_s", "transfer_s", "read_gib"} <= set(stats)
    _trees_bit_identical(cold.causal_lm["params"], restored.causal_lm["params"])
    if quantize != "none":
        flat = tloader._flatten(restored.causal_lm["params"])
        assert any(k.endswith("|scale") for k in flat)
        assert any(k.endswith("|q8") for k in flat)
    assert restored.causal_lm.get("eos_id") == 2


def test_restore_streams_leaves_in_pieces(tiny_artifact, tmp_path, monkeypatch):
    """Pieces far smaller than a leaf, through a two-buffer ring: the same
    tree, and the CRC taken across the pieces."""
    snapdir = str(tmp_path / "snaps")
    cold = _load(tiny_artifact, "int8", snapdir)
    monkeypatch.setattr(snap, "PIECE_BYTES", 96)
    monkeypatch.setattr(snap, "NUM_PIECES", 2)
    stats: dict = {}
    restored = _load(tiny_artifact, "int8", snapdir, stats)
    assert stats.get("restore_s") is not None
    _trees_bit_identical(cold.causal_lm["params"], restored.causal_lm["params"])
    spath = snap.snapshot_path_for(snapdir, tiny_artifact)
    chunk = sorted(spath.glob("chunk-*.bin"))[0]
    raw = bytearray(chunk.read_bytes())
    raw[-1] ^= 0xFF  # the last piece of the last leaf in the file
    chunk.write_bytes(bytes(raw))
    with pytest.raises(snap.SnapshotError, match="CRC"):
        snap.load_snapshot(spath, device="cpu")


def test_identity_hash_covers_quantize_mesh_and_format(tiny_artifact):
    base = snap.snapshot_identity(tiny_artifact, "int8", {"tp": 1})
    assert snap.content_hash(base) == snap.content_hash(
        snap.snapshot_identity(tiny_artifact, "int8", {"tp": 1}))
    for other in (
        snap.snapshot_identity(tiny_artifact, "int8kv", {"tp": 1}),
        snap.snapshot_identity(tiny_artifact, "none", {"tp": 1}),
        snap.snapshot_identity(tiny_artifact, "int8", {"tp": 2}),
        snap.snapshot_identity(tiny_artifact, "int8", {"dp": 1}),
        snap.snapshot_identity(tiny_artifact + "x", "int8", {"tp": 1}),
    ):
        assert snap.content_hash(other) != snap.content_hash(base)
    assert snap.content_hash(snap.snapshot_identity(tiny_artifact, "int8", {"dp": 1, "tp": 2})
                             ) == snap.content_hash(
        snap.snapshot_identity(tiny_artifact, "int8", {"tp": 2, "dp": 1}))
    # The reference's identity, hash and path, for the same inputs.
    for q, mesh in (("int8", MESH), (None, None), ("int8kv", {"tp": 4})):
        ident = snap.snapshot_identity(tiny_artifact, q, mesh)
        assert ident == jsnap.snapshot_identity(tiny_artifact, q, mesh)
        assert snap.content_hash(ident) == jsnap.content_hash(ident)
    assert snap.snapshot_path_for("/d", tiny_artifact) == jsnap.snapshot_path_for(
        "/d", tiny_artifact)
    assert snap.FORMAT_VERSION == jsnap.FORMAT_VERSION
    assert snap.MANIFEST_NAME == jsnap.MANIFEST_NAME


def test_quantize_mismatch_falls_back_with_one_warning_and_rebakes(tiny_artifact, tmp_path,
                                                                   caplog):
    snapdir = str(tmp_path / "snaps")
    _load(tiny_artifact, "int8", snapdir)
    spath = snap.snapshot_path_for(snapdir, tiny_artifact)
    assert (spath / snap.MANIFEST_NAME).exists()
    with caplog.at_level(logging.WARNING):
        stats: dict = {}
        _load(tiny_artifact, "none", snapdir, stats)
    assert "restore_s" not in stats
    warnings = [r for r in caplog.records if "snapshot invalidated" in r.message]
    assert len(warnings) == 1, [r.message for r in caplog.records]
    stats2: dict = {}
    _load(tiny_artifact, "none", snapdir, stats2)
    assert stats2.get("restore_s") is not None


def test_format_version_mismatch_is_a_miss_not_an_error(tiny_artifact, tmp_path):
    snapdir = str(tmp_path / "snaps")
    _load(tiny_artifact, "none", snapdir)
    spath = snap.snapshot_path_for(snapdir, tiny_artifact)
    manifest = json.loads((spath / snap.MANIFEST_NAME).read_text())
    manifest["format_version"] = snap.FORMAT_VERSION + 1
    (spath / snap.MANIFEST_NAME).write_text(json.dumps(manifest))
    with pytest.raises(snap.SnapshotMismatch):
        snap.load_snapshot(spath, identity=snap.snapshot_identity(tiny_artifact, "none", MESH),
                           device="cpu")
    assert _load(tiny_artifact, "none", snapdir).causal_lm is not None


def test_truncated_chunk_raises_typed_error(tiny_artifact, tmp_path):
    snapdir = str(tmp_path / "snaps")
    _load(tiny_artifact, "none", snapdir)
    spath = snap.snapshot_path_for(snapdir, tiny_artifact)
    chunk = sorted(spath.glob("chunk-*.bin"))[0]
    chunk.write_bytes(chunk.read_bytes()[:-100])
    with pytest.raises(snap.SnapshotError, match="truncated"):
        snap.load_snapshot(spath, device="cpu")


def test_bitflip_fails_crc_with_typed_error(tiny_artifact, tmp_path):
    snapdir = str(tmp_path / "snaps")
    _load(tiny_artifact, "none", snapdir)
    spath = snap.snapshot_path_for(snapdir, tiny_artifact)
    chunk = sorted(spath.glob("chunk-*.bin"))[0]
    raw = bytearray(chunk.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    chunk.write_bytes(bytes(raw))
    with pytest.raises(snap.SnapshotError, match="CRC"):
        snap.load_snapshot(spath, device="cpu")


def test_corrupt_snapshot_quarantined_and_rebaked(tiny_artifact, tmp_path, caplog):
    snapdir = str(tmp_path / "snaps")
    _load(tiny_artifact, "none", snapdir)
    spath = snap.snapshot_path_for(snapdir, tiny_artifact)
    chunk = sorted(spath.glob("chunk-*.bin"))[0]
    chunk.write_bytes(chunk.read_bytes()[: chunk.stat().st_size // 2])
    with caplog.at_level(logging.WARNING):
        stats: dict = {}
        pred = _load(tiny_artifact, "none", snapdir, stats)
    assert pred.causal_lm is not None and "restore_s" not in stats
    assert any("snapshot unusable" in r.message for r in caplog.records)
    assert list(spath.parent.glob(f"{spath.name}.corrupt-*"))
    stats2: dict = {}
    _load(tiny_artifact, "none", snapdir, stats2)
    assert stats2.get("restore_s") is not None, stats2


def test_missing_manifest_is_silent_cold_start(tiny_artifact, tmp_path, caplog):
    snapdir = str(tmp_path / "snaps")
    with caplog.at_level(logging.WARNING):
        _load(tiny_artifact, "none", snapdir)
    assert not [r for r in caplog.records if "snapshot" in r.message.lower()]
    assert (snap.snapshot_path_for(snapdir, tiny_artifact) / snap.MANIFEST_NAME).exists()


def test_write_is_atomic_no_partial_dir_on_failure(tmp_path):
    class Boom(Exception):
        pass

    class ExplodingLeaf:
        dtype = np.dtype(np.float32)

        def __array__(self, *a, **k):
            raise Boom("disk full mid-leaf")

    ident = snap.snapshot_identity("uri", "none", None)
    with pytest.raises(Boom):
        snap.write_snapshot(tmp_path / "snaps", {"a": torch.zeros(4), "b": ExplodingLeaf()},
                            identity=ident, flavor="llama-generate")
    assert not snap.snapshot_path_for(tmp_path / "snaps", "uri").exists()
    assert list((tmp_path / "snaps").glob(".snapshot-*")) == []


# -- across packages ------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_tree():
    """A tiny ``int8`` tree as the reference serves it (bf16 leaves, q8 and
    f32 scale planes), quantized by the reference's eager quantizer."""
    from tpumlops.models.quantization import quantize_tensor

    cfg = J.LlamaConfig.tiny(max_seq=64)
    tree = jax.device_get(J.init(jax.random.key(9), cfg, dtype=jnp.bfloat16))
    tree["layers"] = dict(tree["layers"])
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        tree["layers"][name] = jax.device_get(quantize_tensor(jnp.asarray(tree["layers"][name])))
    tree["lm_head"] = jax.device_get(quantize_tensor(jnp.asarray(tree["lm_head"])))
    return tree


def test_chunk_files_are_byte_identical_to_the_reference(int8_tree, tmp_path):
    ident = snap.snapshot_identity("tiny", "int8", MESH)
    kw = dict(identity=ident, flavor="llama-generate", config={"hidden_size": 64},
              builder_kwargs={"eos_id": 2}, chunk_bytes=4096)
    jpath = jsnap.write_snapshot(tmp_path / "jax", int8_tree, **kw)
    tpath = snap.write_snapshot(tmp_path / "port", convert.from_jax_numpy(int8_tree), **kw)
    jfiles = sorted(p.name for p in jpath.glob("chunk-*.bin"))
    assert jfiles == sorted(p.name for p in tpath.glob("chunk-*.bin")) and len(jfiles) > 1
    for name in jfiles:
        assert (jpath / name).read_bytes() == (tpath / name).read_bytes(), name
    jm, tm = jsnap.read_manifest(jpath), snap.read_manifest(tpath)
    assert tm == jm
    assert {leaf["dtype"] for leaf in tm["leaves"]} == {"bfloat16", "int8", "float32"}


def test_a_reference_snapshot_restores_in_the_port(int8_tree, tmp_path):
    ident = snap.snapshot_identity("tiny", "int8", MESH)
    path = jsnap.write_snapshot(tmp_path, int8_tree, identity=ident, flavor="llama-generate")
    got, manifest = snap.load_snapshot(path, identity=ident, device="cpu")
    assert manifest["content_hash"] == jsnap.content_hash(ident)
    _trees_bit_identical(got, convert.from_jax_numpy(int8_tree))


def test_a_port_snapshot_reads_back_in_the_reference(int8_tree, tmp_path):
    ident = snap.snapshot_identity("tiny", "int8", MESH)
    tree = convert.from_jax_numpy(int8_tree)
    path = snap.write_snapshot(tmp_path, tree, identity=ident, flavor="llama-generate")
    back, _ = jsnap.load_snapshot(path, identity=ident, to_device=False)
    want = jloader._flatten(int8_tree)
    got = jloader._flatten(back)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert np.array_equal(_bits(got[key]), _bits(want[key])), key


def test_loader_bakes_restore_across_packages(tiny_artifact, tmp_path):
    """A JAX loader's bake (the JAX server's default mesh) restores through
    the port's loader, and a port bake through the JAX loader."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcold = jloader.load_predictor(tiny_artifact, mesh_shape=MESH, quantize="int8kv",
                                   snapshot_dir=jdir)
    stats: dict = {}
    port = _load(tiny_artifact, "int8kv", jdir, stats)
    assert stats.get("restore_s") is not None, stats
    _trees_bit_identical(port.causal_lm["params"],
                         convert.from_jax_numpy(jax.device_get(jcold.causal_lm["params"])))
    tcold = _load(tiny_artifact, "none", tdir)
    jstats: dict = {}
    jrest = jloader.load_predictor(tiny_artifact, mesh_shape=MESH, quantize="none",
                                   snapshot_dir=tdir, load_stats=jstats)
    assert jstats.get("restore_s") is not None, jstats
    _trees_bit_identical(tcold.causal_lm["params"],
                         convert.from_jax_numpy(jax.device_get(jrest.causal_lm["params"])))


def test_a_sharded_manifest_is_a_miss_in_the_port(tiny_artifact, tmp_path, caplog):
    """A ``tp: 4`` bake (an identity of four devices, leaves by shards) is a
    :class:`SnapshotMismatch`: the loader warns once and loads cold, and the
    snapshot is not moved aside as corrupt."""
    snapdir = str(tmp_path / "snaps")
    _load(tiny_artifact, "none", snapdir)
    spath = snap.snapshot_path_for(snapdir, tiny_artifact)
    manifest = snap.read_manifest(spath)
    sharded = dict(manifest, identity=dict(manifest["identity"], mesh_shape={"tp": 4}))
    sharded["content_hash"] = snap.content_hash(sharded["identity"])
    leaf = dict(sharded["leaves"][0])
    leaf["spec"] = [None, "tp"]
    leaf["shards"] = [{k: leaf.pop(k) for k in ("file", "offset", "nbytes", "crc32")}]
    leaf["shards"][0].update(start=[0, 0], shape=leaf["shape"])
    sharded["leaves"] = [leaf] + sharded["leaves"][1:]
    (spath / snap.MANIFEST_NAME).write_text(json.dumps(sharded))
    with pytest.raises(snap.SnapshotMismatch, match="single-device"):
        snap.load_snapshot(spath, device="cpu")
    # The identity check (tp 4 against the port's one device) misses first.
    with pytest.raises(snap.SnapshotMismatch, match="identity"):
        snap.load_snapshot(spath, identity=snap.snapshot_identity(tiny_artifact, "none", MESH),
                           device="cpu")
    with caplog.at_level(logging.WARNING):
        stats: dict = {}
        pred = _load(tiny_artifact, "none", snapdir, stats)
    assert pred.causal_lm is not None and "restore_s" not in stats
    assert len([r for r in caplog.records if "snapshot invalidated" in r.message]) == 1
    assert not list(spath.parent.glob(f"{spath.name}.corrupt-*"))
