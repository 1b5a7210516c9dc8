"""The port's ``utils/checkpoint.py`` against the JAX package's.

The same sequence of saves, async saves, refusals, torn leftovers, crashes
and restores goes through both packages' ``CheckpointManager`` on trees
made with numpy (numpy arrays on the reference, the same values as torch
tensors on the port); both must list the same ``steps()`` and
``latest_step()``, write the same metadata keys and tags, refuse and
recover alike, and restore the same values.  A template of
``parallel/sharding.py`` specs restores each rank's block, equal to the
slice of the full array.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel import (  # noqa: E501
    mesh as PM,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel import (  # noqa: E501
    sharding as PS,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (  # noqa: E501
    checkpoint as PC,
)
from tpumlops.utils import checkpoint as JC


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((8, 6)), "layers": [
        {"wq": rng.standard_normal((6, 4)).astype(np.float32),
         "scale": rng.integers(-5, 5, (4,)).astype(np.int32)} for _ in range(2)]}


def _torch(tree):
    return PC._map(tree, lambda x, _: torch.from_numpy(np.array(x)))


def _numpy(tree):
    return PC._map(tree, lambda x, _: np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x))


def _equal(got, want) -> None:
    PC._map(_numpy(got), lambda x, w: np.testing.assert_array_equal(x, np.asarray(w)), want)


class _Both:
    """One manager of each package over its own root, driven alike."""

    def __init__(self, tmp_path, **kw):
        self.ref = JC.CheckpointManager(tmp_path / "jax", **kw)
        self.port = PC.CheckpointManager(tmp_path / "torch", **kw)

    def save(self, step, tree, **kw):
        self.ref.save(step, tree, **kw)
        self.port.save(step, _torch(tree), **kw)

    def same_listing(self):
        assert self.port.steps() == self.ref.steps()
        assert self.port.latest_step() == self.ref.latest_step()
        for step in self.ref.steps():
            ref, got = self.ref.metadata(step), self.port.metadata(step)
            assert sorted(got) == sorted(ref)
            assert (got["step"], got["tags"]) == (ref["step"], ref["tags"])
        return self.ref.steps()

    def restore(self, step=None):
        want = self.ref.restore(step)
        got = self.port.restore(step)
        _equal(got, want)
        return got


def test_the_same_sequence_through_both_managers(tmp_path):
    m = _Both(tmp_path, max_to_keep=3)
    with pytest.raises(FileNotFoundError):
        m.port.restore()
    m.save(1, _tree(1), tags={"run": "a"})
    ref_h = m.ref.save_async(2, _tree(2), tags={"run": "b"})
    port_h = m.port.save_async(2, _torch(_tree(2)), tags={"run": "b"})
    ref_h.wait(timeout=60)
    port_h.wait(timeout=60)
    assert port_h.done()
    assert m.same_listing() == [1, 2]
    # An existing step is refused unless overwrite, synchronously and async.
    for mgr, tree in ((m.ref, _tree(9)), (m.port, _torch(_tree(9)))):
        with pytest.raises(FileExistsError):
            mgr.save(2, tree)
        with pytest.raises(FileExistsError):
            mgr.save_async(2, tree).wait(timeout=60)
    m.save(2, _tree(22), tags={"run": "b2"}, overwrite=True)
    _equal(m.restore(2), _tree(22))
    # A torn save is never listed and is cleaned at the next save.
    for root in (m.ref.root, m.port.root):
        torn = root / ".tmp_step_00000003"
        torn.mkdir()
        (torn / "junk").write_text("partial")
    assert m.same_listing() == [1, 2]
    m.save(3, _tree(3))
    assert not (m.ref.root / ".tmp_step_00000003" / "junk").exists()
    assert not (m.port.root / ".tmp_step_00000003" / "junk").exists()
    # Keep-N: the oldest committed step goes.
    m.save(4, _tree(4))
    assert m.same_listing() == [2, 3, 4]
    assert not (m.port.root / "step_00000001").exists()
    # An old step restores; the default is the latest.
    _equal(m.restore(3), _tree(3))
    _equal(m.restore(), _tree(4))
    with pytest.raises(FileNotFoundError):
        m.port.restore(1)


def test_an_overwrite_that_crashes_keeps_the_predecessor(tmp_path, monkeypatch):
    m = _Both(tmp_path, max_to_keep=None)
    m.save(5, _tree(5))

    def boom(path, tree):
        raise OSError("disk full")

    for mod, mgr, tree in ((JC, m.ref, _tree(6)), (PC, m.port, _torch(_tree(6)))):
        monkeypatch.setattr(mod, "save", boom)
        with pytest.raises(OSError, match="disk full"):
            mgr.save(5, tree, overwrite=True)
    assert m.same_listing() == [5]
    _equal(m.restore(5), _tree(5))


def test_opening_heals_an_interrupted_swap(tmp_path):
    """A crash between parking the committed predecessor and committing the
    replacement: the next manager opened on the root restores the
    predecessor."""
    m = _Both(tmp_path, max_to_keep=None)
    m.save(7, _tree(7))
    for mgr in (m.ref, m.port):
        final = mgr.root / "step_00000007"
        final.rename(mgr.root / ".replaced_step_00000007")
        final.mkdir()  # an uncommitted replacement
    fresh = _Both(tmp_path, max_to_keep=None)
    assert fresh.same_listing() == [7]
    _equal(fresh.restore(7), _tree(7))


def test_an_async_save_writes_the_tree_as_it_was_at_the_call(tmp_path):
    """A torch tensor is mutable: what the port writes is the tree at the
    call, whatever the caller does to it after."""
    mgr = PC.CheckpointManager(tmp_path / "c")
    tree = _torch(_tree(11))
    handle = mgr.save_async(1, tree)
    tree["embed"].add_(1.0)
    tree["layers"][0]["scale"].zero_()
    handle.wait(timeout=60)
    _equal(mgr.restore(1), _tree(11))


def test_the_one_shot_round_trip_matches_the_reference(tmp_path):
    tree = _tree(12)
    JC.save(tmp_path / "jax", tree)
    PC.save(tmp_path / "torch", {**_torch(tree), "meta": {"step": 3, "name": "x", "none": None}})
    got = PC.restore(tmp_path / "torch")
    assert got["meta"] == {"step": 3, "name": "x", "none": None}
    del got["meta"]
    _equal(got, JC.restore(tmp_path / "jax"))
    assert got["layers"][0]["scale"].dtype == torch.int32


@pytest.mark.parametrize("shape,specs", [
    ({"dp": 1, "tp": 2}, {"embed": PS.PartitionSpec(None, "tp"),
                          "layers": [{"wq": PS.PartitionSpec("tp", None), "scale": None}] * 2}),
    ({"dp": 2, "tp": 2}, {"embed": PS.PartitionSpec(("dp", "tp"), None),
                          "layers": [{"wq": PS.PartitionSpec(None, "tp"),
                                      "scale": PS.PartitionSpec("dp")}] * 2}),
])
def test_a_sharded_template_restores_each_ranks_block(tmp_path, shape, specs):
    full = _tree(13)
    mgr = PC.CheckpointManager(tmp_path / "c")
    mgr.save(1, _torch(full))
    world = int(np.prod(list(shape.values())))
    for rank in range(world):
        mesh = PM.placement(shape, rank=rank, world=world)
        template = {"embed": PS.NamedSharding(mesh, specs["embed"]),
                    "layers": [{k: None if s is None else PS.NamedSharding(mesh, s)
                                for k, s in layer.items()} for layer in specs["layers"]]}
        got = mgr.restore(1, template)

        def block(x, spec):
            if spec is None:
                return x
            for d, entry in enumerate(spec):
                axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
                n, idx = 1, 0
                for a in axes:
                    n *= mesh.size(a)
                    idx = idx * mesh.size(a) + mesh.index(a)
                w = x.shape[d] // n
                x = np.take(x, np.arange(idx * w, (idx + 1) * w), axis=d)
            return x

        want = PC._map(full, lambda x, s: block(np.asarray(x), s), specs)
        _equal(got, want)
        assert got["embed"].is_contiguous()
    with pytest.raises(ValueError, match="does not split"):
        bad = PS.NamedSharding(PM.placement({"tp": 3}, rank=0, world=3),
                               PS.PartitionSpec("tp", None))
        mgr.restore(1, {"embed": bad, "layers": [{"wq": None, "scale": None}] * 2})
