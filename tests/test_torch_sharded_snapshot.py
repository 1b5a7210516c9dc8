"""The sharded snapshot layout (a weight snapshot at a world above one
rank) in the port against the JAX package, on the CPU.

Ranks are spawned gloo worlds (``torch_world.sharded_snapshot_case``:
``load_predictor`` with ``snapshot_dir`` and ``mesh_shape``); the JAX
package bakes and reads here, on its host mesh.  The artifact is a tiny
bf16 Llama (4 heads, 2 K/V heads) in the reference's native layout.

- A JAX ``tp: 2`` bake (the JAX ``write_snapshot`` of a tree placed by its
  ``shard_llama_params``) restores in a 2-rank port world, ``none`` and
  ``int8``: each rank's tree equals, bit for bit, the port's
  ``partition.shard_llama_params`` cut of the full tree for that rank.
- A port ``tp: 2`` bake (each rank writes its blocks, the leader the
  manifest) reads back in the JAX ``load_snapshot(to_device=False)`` as
  the full tree; the port restores it; at ``{"sp": 2, "tp": 2}`` each
  distinct block is written once.
- A restoring rank reads the replicated leaves and its own blocks only.
- A tp-1 bake misses on a tp-2 mesh: one warning, a cold load, a new bake.
- The warm pool at a world above one rank is refused across hosts only.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world as W
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (  # noqa: E501
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    partition as TPART,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (  # noqa: E501
    quantization as TQ,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel.mesh import (  # noqa: E501
    placement,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    app as tapp,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    loader as tloader,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (  # noqa: E501
    snapshot as snap,
)
from tpumlops.models import llama as J
from tpumlops.models import partition as JPART
from tpumlops.models.quantization import quantize_tensor
from tpumlops.server import loader as jloader
from tpumlops.server import snapshot as jsnap

TP2 = {"tp": 2}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    cfg = J.LlamaConfig.tiny(max_seq=64)
    tree = jax.device_get(J.init(jax.random.key(7), cfg, dtype=jnp.bfloat16))
    art = tmp_path_factory.mktemp("sharded-artifact") / "model"
    jloader.save_native_model(art, "llama-generate", tree, config=dataclasses.asdict(cfg),
                              builder_kwargs={"eos_id": 2})
    return str(art), cfg, tree


def _int8(tree):
    """The reference's int8 tree (its eager quantizer), bf16 elsewhere."""
    out = dict(tree, layers=dict(tree["layers"]))
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        out["layers"][name] = jax.device_get(quantize_tensor(jnp.asarray(tree["layers"][name])))
    out["lm_head"] = jax.device_get(quantize_tensor(jnp.asarray(tree["lm_head"])))
    return out


def _bits(t):
    """(dtype name, bits) of a port tensor, as the rank body returns them."""
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return str(t.dtype), bits.numpy()


def _world(mesh_shape: dict) -> int:
    return int(np.prod(list(mesh_shape.values())))


def _assert_blocks(got: dict, full_tree, mesh_shape: dict, rank: int):
    """A rank's flattened tree equals the port's cut of ``full_tree`` for
    that rank, bit for bit."""
    want = tloader._flatten(TPART.shard_llama_params(
        convert.from_jax_numpy(full_tree), placement(mesh_shape, rank, _world(mesh_shape))))
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        name, bits = _bits(t)
        assert got[key][0] == name and np.array_equal(got[key][1], bits), f"rank {rank} {key}"


def _jax_bake(snapdir, art, tree, quantize, mesh_shape):
    """The JAX package's bake of ``tree`` placed on its host mesh."""
    placed = JPART.shard_llama_params(tree, JPART.build_serving_mesh(mesh_shape))
    return jsnap.write_snapshot(snapdir, placed,
                                identity=jsnap.snapshot_identity(art, quantize, mesh_shape),
                                flavor="llama-generate",
                                config=dataclasses.asdict(J.LlamaConfig.tiny(max_seq=64)),
                                builder_kwargs={"eos_id": 2})


def _own_reads(manifest: dict, mesh_shape: dict, rank: int) -> set:
    """The (key, file, offset) records rank ``rank`` should read: every flat
    leaf and the shard whose start is its block's."""
    mesh = placement(mesh_shape, rank, _world(mesh_shape))
    out = set()
    for leaf in manifest["leaves"]:
        if "shards" not in leaf:
            out.add((leaf["key"], leaf["file"], leaf["offset"]))
            continue
        start, _ = snap.block_of(leaf["shape"], leaf["spec"], mesh)
        rec = next(r for r in leaf["shards"] if tuple(r["start"]) == start)
        out.add((leaf["key"], rec["file"], rec["offset"]))
    return out


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_a_jax_tp2_bake_restores_rank_by_rank(model, tmp_path, quantize):
    art, _, tree = model
    full = _int8(tree) if quantize == "int8" else tree
    spath = _jax_bake(tmp_path / "snaps", art, full, quantize, TP2)
    manifest = jsnap.read_manifest(spath)
    assert any("shards" in leaf for leaf in manifest["leaves"])
    ranks = W.run(W.sharded_snapshot_case, 2, art, TP2, [(str(tmp_path / "snaps"), quantize)],
                  timeout=120)
    for r, (res,) in enumerate(ranks):
        assert res["stats"].get("restore_s") is not None, res["warnings"]
        assert "quantize_s" not in res["stats"]
        _assert_blocks(res["params"], full, TP2, r)
        got = {(k, f, o) for k, f, o, _ in res["reads"]}
        assert got == _own_reads(manifest, TP2, r)
        # fewer bytes than the snapshot holds: the other rank's blocks stay on disk
        assert sum(n for *_, n in res["reads"]) < manifest["total_bytes"]


def _u8(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_a_port_tp2_bake_reads_back_in_the_jax_package(model, tmp_path, quantize):
    """Rank by rank the port bakes after its cold load; the JAX reader
    assembles the full tree (the artifact's, or the port's quantization of
    it); the port's second start restores the blocks it served and reads
    its own records only."""
    art, _, tree = model
    snapdir = str(tmp_path / "snaps")
    ranks = W.run(W.sharded_snapshot_case, 2, art, TP2, [(snapdir, quantize)] * 2,
                  timeout=120)
    spath = snap.snapshot_path_for(snapdir, art)
    manifest = snap.read_manifest(spath)
    back, _ = jsnap.load_snapshot(spath, identity=jsnap.snapshot_identity(art, quantize, TP2),
                                  to_device=False)
    full = convert.from_jax_numpy(tree)
    if quantize == "int8":
        full = TQ.quantize_llama(full)
    want = tloader._flatten(full)
    got = jloader._flatten(back)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert np.array_equal(_u8(got[key]), _u8(convert.to_numpy(t))), key
    for r, (cold, warm) in enumerate(ranks):
        assert "restore_s" not in cold["stats"] and warm["stats"].get("restore_s") is not None
        assert sorted(cold["params"]) == sorted(warm["params"])
        for key, (name, bits) in warm["params"].items():
            assert cold["params"][key][0] == name
            assert np.array_equal(cold["params"][key][1], bits), f"rank {r} {key}"
        _assert_blocks(warm["params"], jax.tree.map(np.asarray, back), TP2, r)
        assert {(k, f, o) for k, f, o, _ in warm["reads"]} == _own_reads(manifest, TP2, r)


def test_an_sp_tp_bake_writes_each_block_once(model, tmp_path):
    """At ``{"sp": 2, "tp": 2}`` two ranks hold each tp block: the one at
    sp 0 writes it.  The JAX reader takes the manifest, and every rank
    restores its block."""
    art, _, tree = model
    shape = {"sp": 2, "tp": 2}
    snapdir = str(tmp_path / "snaps")
    ranks = W.run(W.sharded_snapshot_case, 4, art, shape, [(snapdir, "none")] * 2,
                  timeout=180)
    spath = snap.snapshot_path_for(snapdir, art)
    manifest = snap.read_manifest(spath)
    sharded = [leaf for leaf in manifest["leaves"] if "shards" in leaf]
    assert sharded and all(len(leaf["shards"]) == 2 for leaf in sharded)
    assert {f.name.split("-")[1] for f in spath.glob("chunk-*.bin")} == {"r000", "r001"}
    back, _ = jsnap.load_snapshot(spath, identity=jsnap.snapshot_identity(art, "none", shape),
                                  to_device=False)
    want = jloader._flatten(tree)
    got = jloader._flatten(back)
    for key in want:
        assert np.array_equal(_u8(got[key]), _u8(want[key])), key
    for r, (_, warm) in enumerate(ranks):
        assert warm["stats"].get("restore_s") is not None
        _assert_blocks(warm["params"], tree, shape, r)


def test_a_tp1_bake_misses_on_a_tp2_mesh(model, tmp_path):
    """The identity covers the mesh: a single-device bake is one warning on
    the tp-2 unit, a cold load, and a sharded bake over it."""
    art, _, _ = model
    snapdir = str(tmp_path / "snaps")
    tloader.load_predictor(art, device="cpu", dtype=torch.bfloat16, snapshot_dir=snapdir)
    spath = snap.snapshot_path_for(snapdir, art)
    assert snap.read_manifest(spath)["identity"]["mesh_shape"] == tloader.SNAPSHOT_MESH
    ranks = W.run(W.sharded_snapshot_case, 2, art, TP2, [(snapdir, "none")], timeout=120)
    for res, in ranks:
        assert "restore_s" not in res["stats"]
    warned = [w for res, in ranks for w in res["warnings"] if "snapshot invalidated" in w]
    assert len(warned) == 1, warned
    assert snap.read_manifest(spath)["identity"]["mesh_shape"] == TP2
    with pytest.raises(snap.SnapshotMismatch, match="single-device"):
        snap.load_snapshot(spath, device="cpu")


def test_the_warm_pool_is_refused_at_a_world_above_one_rank(tmp_path, monkeypatch):
    """Across hosts only: a unit whose ranks do not all share one host
    (``LOCAL_WORLD_SIZE`` below the world) is refused before its process
    group forms; on one host the config is accepted."""
    warm = tapp.ServerConfig(mesh_shape=TP2, warm_pool=True, snapshot_dir=str(tmp_path))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="--warm-pool is single-host only"):
        tapp.form_unit(warm)
    conf = tapp.ServerConfig(mesh_shape=TP2, snapshot_dir=str(tmp_path))
    assert conf.snapshot_dir == str(tmp_path)
    args = tapp.build_arg_parser().parse_args(
        ["--model-uri", "m", "--mesh-shape", json.dumps({"sp": 2, "tp": 2}),
         "--snapshot-dir", str(tmp_path), "--sp-prefill-threshold", "512"])
    conf = tapp.config_from_args(args)
    assert conf.sp_prefill_threshold == 512 and conf.mesh_shape == {"sp": 2, "tp": 2}
