"""The port's ``parallel/`` and ``models/partition.py`` against the JAX
package's, case by case (``tests/test_parallel.py``'s semantics).

Meshes, logical specs, the regex rule table and its matcher, the cut of a
tree into a rank's blocks (against the JAX package's own device shards of
the same tree), the engine-state shapes and the mesh geometry checks run
in this process.  Every collective helper runs in spawned gloo worlds of
2 and 4 processes (``torch_world.collectives_case``), one spawn a world,
against numpy.  Last, two processes build the kernels into one directory
at once with a fake compiler: each library is compiled once.
"""

import functools
import importlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_world as W
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    parallel as TPAR,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    partition as TPART,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel import (
    distributed as TDIST,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel.mesh import (
    ServingMesh,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.parallel.sharding import (
    PartitionSpec as P,
)
from tpumlops import parallel as JPAR
from tpumlops.models import llama as J
from tpumlops.models import partition as JPART
from tpumlops.models import quantization as JQ
from tpumlops.utils.config import validate_mesh_for_model as j_validate

ROOT = Path(__file__).resolve().parents[1]
PORT_PKG = W.PKG


def _spec(js) -> tuple:
    """A JAX PartitionSpec as the port's tuple form."""
    return tuple(js)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [{"tp": 1, "dp": 1}, {"sp": 1, "dp": 1, "tp": 1},
                                   {"tp": 1}, {}])
def test_mesh_axis_order_is_the_reference_order(shape):
    mesh = TPAR.build_mesh(shape)
    assert tuple(mesh.shape) == tuple(a for a in JPAR.MESH_AXIS_ORDER if a in shape)
    assert mesh.world == 1 and mesh.rank == 0 and mesh.groups == {}
    assert TPAR.MESH_AXIS_ORDER == JPAR.MESH_AXIS_ORDER
    assert (TPAR.AXIS_DATA, TPAR.AXIS_TENSOR, TPAR.AXIS_SEQ) == ("dp", "tp", "sp")


@pytest.mark.parametrize("shape,match", [
    ({"x": 1}, "unknown mesh axes"),
    ({"dp": 0, "tp": 1}, "sizes must be >= 1"),
    ({"dp": 3, "tp": 2}, "devices"),
])
def test_mesh_errors_follow_the_reference(shape, match):
    with pytest.raises(ValueError, match=match):
        TPAR.build_mesh(shape)
    with pytest.raises(ValueError, match=match):
        JPAR.build_mesh(shape)


def test_a_mesh_of_several_ranks_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize torch.distributed"):
        TPAR.build_mesh({"tp": 2}, rank=0, world=2)


def test_parallel_exports_the_reference_names():
    assert set(TPAR.__all__) == set(JPAR.__all__) - {"shard_map_compat"}
    for name in TPAR.__all__:
        assert getattr(TPAR, name) is not None


# ---------------------------------------------------------------------------
# Logical specs and the rule table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [
    ("batch", "seq", "heads", "head_dim"),
    ("heads", "mlp"),
    ("embed", "vocab"),
    ("kv_heads", "expert", None),
])
def test_logical_specs_match_the_reference(axes):
    assert tuple(TPAR.logical_spec(axes)) == _spec(JPAR.logical_spec(axes))
    mesh = ServingMesh(shape={"dp": 2, "tp": 4}, rank=0, coords={"dp": 0, "tp": 0})
    sh = TPAR.logical_sharding(mesh, axes)
    assert sh.spec == TPAR.logical_spec(axes)


def test_llama_rule_table_is_the_reference_table():
    assert len(TPART.LLAMA_PARTITION_RULES) == len(JPART.LLAMA_PARTITION_RULES)
    for (tpat, tspec), (jpat, jspec) in zip(TPART.LLAMA_PARTITION_RULES,
                                            JPART.LLAMA_PARTITION_RULES):
        assert tpat == jpat
        assert tuple(tspec) == _spec(jspec), tpat
    for dp in (1, 2):
        assert tuple(TPART.ragged_kv_spec(dp)) == _spec(JPART.ragged_kv_spec(dp))
    assert tuple(TPART.SEQ_KV_SPEC) == _spec(JPART.SEQ_KV_SPEC)


@functools.lru_cache(maxsize=None)
def _trees():
    cfg = J.LlamaConfig.tiny(num_heads=4, num_kv_heads=4)
    params = jax.device_get(J.init(jax.random.key(0), cfg))
    return cfg, params, jax.device_get(JQ.quantize_llama(params))


def test_rule_matches_equal_the_reference_on_both_llama_layouts():
    _, params, q = _trees()
    for tree in (params, q):
        got = TPART.llama_param_specs(tree)
        want = JPART.llama_param_specs(tree)
        flat_got = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, tuple))
        flat_want = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, JP))
        assert [tuple(s) for s in flat_got] == [_spec(s) for s in flat_want]


def test_rule_precedence_rank_mismatch_and_scalars():
    tree = {"layers": {"q": {"scale": np.zeros((1, 8)), "q8": np.zeros((4, 8))}},
            "mystery_aux": np.zeros((3, 3)), "step": np.zeros(())}
    rules = [(r"q/scale$", P()), (r"layers/q", P(None, "tp")), (r".", P("tp", None))]
    jrules = [(r"q/scale$", JP()), (r"layers/q", JP(None, "tp")), (r".", JP("tp", None))]
    got = TPAR.match_partition_rules(rules, tree)
    want = JPAR.match_partition_rules(jrules, tree)
    assert got["layers"]["q"]["scale"] == P() == tuple(want["layers"]["q"]["scale"])
    assert got["layers"]["q"]["q8"] == P(None, "tp")
    assert got["mystery_aux"] == tuple(want["mystery_aux"]) == ("tp", None)
    assert got["step"] == P() == tuple(want["step"])  # scalars always replicate
    unmatched = TPAR.match_partition_rules([(r"wq$", P(None, "tp"))],
                                           {"other": np.zeros((3, 3))})
    assert unmatched["other"] == P()
    for bad in (P(None, None, "tp"), P("tp")):
        with pytest.raises(TPAR.PartitionRuleError, match="rank-") as e:
            TPAR.match_partition_rules([(r"wq$", bad)], {"wq": np.zeros((4, 8))})
        assert isinstance(e.value, ValueError) and "'wq'" in str(e.value)
    assert TPAR.match_partition_rules([(r"wq$", P())], {"wq": np.zeros((4, 8))})["wq"] == P()


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_llama_params_equals_the_reference_device_shards(tp):
    """Each rank's block of both layouts is the JAX package's shard on the
    device of the same mesh coordinate."""
    _, params, q = _trees()
    jmesh = JPART.build_serving_mesh({"dp": 1, "tp": tp})
    for tree in (params, q):
        jsharded = JPART.shard_llama_params(tree, jmesh)
        jleaves = jax.tree_util.tree_leaves(jsharded)
        for r in range(tp):
            mesh = ServingMesh(shape={"dp": 1, "tp": tp}, rank=r, coords={"dp": 0, "tp": r})
            got = jax.tree_util.tree_leaves(TPART.shard_llama_params(tree, mesh))
            assert len(got) == len(jleaves)
            for g, j in zip(got, jleaves):
                dev = jmesh.devices[0, r]
                shard = next(s.data for s in j.addressable_shards if s.device == dev)
                np.testing.assert_array_equal(np.asarray(g), np.asarray(shard))


def test_shard_pytree_takes_logical_axes_and_torch_leaves():
    mesh = ServingMesh(shape={"dp": 2, "tp": 4}, rank=6, coords={"dp": 1, "tp": 2})
    w = torch.arange(16 * 8 * 4, dtype=torch.float32).reshape(16, 8, 4)
    out = TPAR.shard_pytree({"wq": w, "bias": torch.zeros(8)},
                            {"wq": ("embed", "heads", "head_dim"), "bias": None}, mesh)
    assert torch.equal(out["wq"], w[:, 4:6]) and out["wq"].is_contiguous()
    assert out["bias"].shape == (8,)
    assert out["wq"].data_ptr() != w.data_ptr()  # a copy: the full leaf can go
    with pytest.raises(ValueError, match="does not split"):
        TPAR.shard_pytree({"w": np.zeros((3, 4))}, {"w": P("tp", None)}, mesh)


@pytest.mark.parametrize("mesh_shape,kv", [({"tp": 2}, False), ({"dp": 2, "tp": 2}, True),
                                           ({"dp": 2}, False), ({"dp": 1, "tp": 4}, True)])
def test_engine_state_shapes_are_the_reference_shardings_blocks(mesh_shape, kv):
    cfg = T.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, max_seq=64)
    shapes = TPART.engine_state_shapes(cfg, 4, mesh_shape, kv_quant=kv)
    jmesh = JPART.build_serving_mesh(mesh_shape)
    rep, ragged, seq = JPART.engine_state_shardings(jmesh, kv)
    full = (cfg.num_layers, 4, cfg.num_kv_heads, cfg.max_seq, cfg.head_dim)
    jr = ragged[0] if kv else ragged
    assert shapes["k8" if kv else "k"] == jr.shard_shape(full)
    if kv:
        assert shapes["k_scale"] == jr.shard_shape(full[:-1] + (1,))
    sfull = (cfg.num_layers, 1, cfg.max_seq, cfg.num_kv_heads, cfg.head_dim)
    assert shapes["seq_kv"] == seq.shard_shape(sfull)
    assert shapes["lengths"] == rep.shard_shape((4,))
    # shard_bytes: a rank's own leaf, or the block a spec cuts of a full one
    leaf = torch.zeros(full, dtype=torch.bfloat16)
    spec = TPART.ragged_kv_spec(TPART.dp_degree(mesh_shape))
    nbytes = TPART.shard_bytes(leaf, spec, mesh_shape)
    assert nbytes == int(np.prod(shapes["k8" if kv else "k"])) * 2
    assert TPART.shard_bytes(torch.zeros(shapes["k8" if kv else "k"], dtype=torch.bfloat16)) \
        == nbytes
    lengths = TPART.shard_bytes(np.zeros((4,), np.int32), TPART.REPLICATED, mesh_shape)
    assert lengths == 16


@pytest.mark.parametrize("mesh_shape,kw", [
    ({"tp": 3}, {}),
    ({"tp": 8}, {}),
    ({"dp": 3}, {"cache_rows": 4}),
    ({"sp": 3}, {"prefill_chunk": 8}),
    ({"dp": 2, "tp": 4}, {"chip_count": 4}),
    ({"tp": 2}, {}),
    (None, {}),
])
def test_mesh_checks_equal_the_reference_checks(mesh_shape, kw):
    cfg = T.LlamaConfig.tiny(num_heads=4, num_kv_heads=4)
    geo = dict(num_kv_heads=4, num_heads=4, intermediate_size=cfg.intermediate_size,
               vocab_size=cfg.vocab_size, **kw)

    def outcome(fn):
        try:
            fn(mesh_shape, **geo)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(TPART.validate_mesh_for_model) == outcome(j_validate)
    if not kw:
        try:
            TPART.validate_llama_mesh(cfg, mesh_shape)
            port = None
        except ValueError as e:
            port = str(e)
        assert port == outcome(j_validate)
    for f in ("tp_degree", "dp_degree", "sp_degree", "mesh_device_count"):
        assert getattr(TPART, f)(mesh_shape) == getattr(JPART, f)(mesh_shape)


# ---------------------------------------------------------------------------
# Process-group init
# ---------------------------------------------------------------------------


def test_single_process_init_is_a_no_op_and_cpu_picks_gloo(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert TDIST.maybe_initialize_distributed() is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert TDIST.maybe_initialize_distributed() is False  # one process: nothing to form
    assert TDIST.choose_backend(4, "cpu") == "gloo"
    assert TDIST.backend_name() is None and TDIST.control_group() is None
    with pytest.raises(ValueError, match="one process drives one rank"):
        TDIST.configure_cpu_rehearsal(2)
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        TDIST.maybe_initialize_distributed("127.0.0.1:1", 2)
    assert str(TDIST.rank_device("cpu", 3)) == "cpu"


def test_backend_is_nccl_only_where_no_two_ranks_share_a_card(monkeypatch):
    """Two hosts of eight cards (16 ranks, ``LOCAL_WORLD_SIZE`` 8) form an
    nccl unit; the same 16 ranks with no ``LOCAL_WORLD_SIZE`` are all on
    one host of eight cards and take gloo.  A rank's local index is
    ``LOCAL_RANK``, else its place in its host's block of ranks."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for var in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert TDIST.choose_backend(8, "cuda") == "nccl"
    assert TDIST.choose_backend(16, "cuda") == "gloo"
    assert TDIST.choose_backend(1, "cpu") == "gloo"
    assert TDIST.local_world_size(16) == 16 and TDIST.local_rank(11, 16) == 11
    formed = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: formed.append((backend, kw["world_size"],
                                                             kw["rank"], kw["init_method"])))
    monkeypatch.setattr(dist, "new_group", lambda **kw: ("control", kw["backend"]))
    monkeypatch.setattr(TDIST, "_initialized", False)
    monkeypatch.setattr(TDIST, "_control_group", None)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "16")
    monkeypatch.setenv("JAX_PROCESS_ID", "11")
    for local_world, want in ((None, "gloo"), ("8", "nccl")):
        if local_world is not None:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
        TDIST._initialized = False
        assert TDIST.maybe_initialize_distributed(device_type="cuda")
        assert formed[-1] == (want, 16, 11, "tcp://10.0.0.1:1234")
        assert TDIST.control_group() == ("control", "gloo")
    assert TDIST.local_rank(11, 16) == 3
    assert str(TDIST.rank_device("cuda", 3)) == "cuda:3"
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert TDIST.local_rank(11, 16) == 5


# ---------------------------------------------------------------------------
# Collectives in spawned gloo worlds, against numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_every_collective_in_a_gloo_world(world):
    n = 4
    res = W.run(W.collectives_case, world, n, timeout=120)
    blocks = [np.arange(n * 4, dtype=np.float64).reshape(n, 4) + 100.0 * r
              for r in range(world)]
    total = sum(blocks)
    for r, out in enumerate(res):
        assert out["axis_index"] == r
        np.testing.assert_array_equal(out["psum"], total)
        np.testing.assert_allclose(out["pmean"], total / world)
        np.testing.assert_array_equal(out["gather0"], np.concatenate(blocks, 0))
        np.testing.assert_array_equal(out["gather1"], np.concatenate(blocks, 1))
        np.testing.assert_array_equal(out["reduce_scatter"],
                                      np.split(total, world, 0)[r])
        np.testing.assert_array_equal(out["ring1"], blocks[(r - 1) % world])
        np.testing.assert_array_equal(out["ring_m1"], blocks[(r + 1) % world])
        np.testing.assert_array_equal(out["ring2"], blocks[(r - 2) % world])
        half = n // 2
        np.testing.assert_array_equal(out["bidir"][:half], blocks[(r - 1) % world][:half])
        np.testing.assert_array_equal(out["bidir"][half:], blocks[(r + 1) % world][half:])
        # all_to_all: block r of every rank's split, in rank order
        want = np.concatenate([np.split(b, world, 0)[r] for b in blocks], 1)
        np.testing.assert_array_equal(out["swap"], want)
        np.testing.assert_array_equal(out["psum_none"], blocks[r])
        if world == 4:
            # dp-outer, tp-inner rank layout; the hierarchical psum is the flat one
            assert out["coords"] == {"dp": r // 2, "tp": r % 2}
            np.testing.assert_allclose(out["hier"], total, rtol=1e-12)


# ---------------------------------------------------------------------------
# The kernel build across processes
# ---------------------------------------------------------------------------


def test_kernel_build_is_one_compile_across_processes(tmp_path):
    """Two processes build every source into one directory at the same
    moment (ranks starting cold on one card), with a fake ``nvcc`` that
    logs each call and takes 0.3 s: the file lock makes each library one
    compile, the other process finds it built, and both load."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        out = sys.argv[sys.argv.index("-o") + 1]
        with open({str(log)!r}, "a") as f:
            f.write(sys.argv[-1] + "\\n")
        time.sleep(0.3)
        open(out, "wb").write(b"")
        """))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "kernels"
    code = textwrap.dedent(f"""\
        import sys, time
        from pathlib import Path
        import {PORT_PKG}.ops._build as b
        b.BUILD_DIR = Path({str(build_dir)!r})
        while time.time() < float(sys.argv[1]):
            time.sleep(0.01)
        secs = b.build()
        print(sum(1 for s in secs.values() if s > 0))
        """)
    import time

    start = time.time() + 1.5
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"), PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(start)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    sources = importlib.import_module(f"{PORT_PKG}.ops._build").SOURCES
    calls = log.read_text().splitlines()
    assert len(calls) == len(sources) == len(set(calls))
    compiled = sorted(int(o.strip()) for o, _ in outs)
    assert compiled == [0, len(sources)]  # one process compiled all, the other none
    assert (build_dir / ".build.lock").exists()
