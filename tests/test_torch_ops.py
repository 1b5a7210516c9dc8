"""Port kernels' plain versions against the JAX package's Pallas kernels.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there); here, on CPU tensors, each wrapper runs its
plain version, which is checked against the Pallas kernel it replaces (in
interpret mode, as the JAX package's own tests run it) and against the
XLA oracle, with the same inputs made from a seeded numpy generator.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    common as tcommon,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    _build,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    decode_attention as tda,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    rmsnorm as trn,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as tgen,
)
from tpumlops.models import common as jcommon
from tpumlops.ops import decode_attention as jda
from tpumlops.server import generation as jgen

# The JAX package re-exports the function under the module's name.
jrn = importlib.import_module("tpumlops.ops.rmsnorm")

# f32 everywhere on both sides: the two differ only in summation order.
DA_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads; one thread keeps
    this module from crowding tests that run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _da_inputs(B, NKV, G, D, W, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NKV, G, D)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, NKV, W, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, NKV, W, D)).astype(np.int8)
    ks = (np.abs(rng.standard_normal((B, NKV, W, 1))) * 0.01 + 1e-3).astype(np.float32)
    vs = (np.abs(rng.standard_normal((B, NKV, W, 1))) * 0.01 + 1e-3).astype(np.float32)
    k_self = rng.standard_normal((B, NKV, 1, D)).astype(np.float32)
    v_self = rng.standard_normal((B, NKV, 1, D)).astype(np.float32)
    lengths = np.array([0, W // 2, W])[:B]  # empty, mid, exactly W
    mask = np.where(np.arange(W)[None, :] < lengths[:, None], 0.0, -1e9)
    mask = mask.astype(np.float32)[:, None, :]
    return q, k8, ks, v8, vs, k_self, v_self, mask


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("W", [16, 24, 48, 96, 128])
def test_decode_attention_plain_matches_pallas_and_oracle(W, G):
    args = _da_inputs(3, 2, G, 16, W, seed=W * 10 + G)
    out = tda.decode_attention(*(torch.from_numpy(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    refs = {
        "reference": jda.decode_attention_reference(*jargs),
        "mxu": jda.decode_attention(*jargs, interpret=True),
        "batched": jda.decode_attention_batched(*jargs, interpret=True),
    }
    if G == 1 and W % 128 == 0:  # the Pallas VPU kernel's own constraint
        refs["vpu"] = jda.decode_attention_vpu(*jargs, interpret=True)
    for name, ref in refs.items():
        np.testing.assert_allclose(out, np.asarray(ref), rtol=DA_TOL, atol=DA_TOL,
                                   err_msg=name)
    # Row 0 has length 0: exactly the self V.
    np.testing.assert_allclose(out[0], np.broadcast_to(args[6][0], out[0].shape),
                               rtol=DA_TOL, atol=DA_TOL)
    if G == 1:
        vpu = tda.decode_attention_vpu(*(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_array_equal(vpu, out)
    batched = tda.decode_attention_batched(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(batched, out)


def test_decode_attention_reads_strided_cache_window():
    """The window the model passes is a strided view of the head-major
    cache [L, B, NKV, T, D]; the result equals the one on a dense copy."""
    B, NKV, G, D, T, W = 3, 2, 2, 16, 64, 24
    q, k8, ks, v8, vs, k_self, v_self, mask = _da_inputs(B, NKV, G, D, W, seed=3)
    rng = np.random.default_rng(4)
    big_k = rng.integers(-127, 128, (2, B, NKV, T, D)).astype(np.int8)
    big_v = rng.integers(-127, 128, (2, B, NKV, T, D)).astype(np.int8)
    big_ks = np.abs(rng.standard_normal((2, B, NKV, T, 1))).astype(np.float32)
    big_vs = np.abs(rng.standard_normal((2, B, NKV, T, 1))).astype(np.float32)
    t = torch.from_numpy
    views = (t(big_k)[1, :, :, :W], t(big_ks)[1, :, :, :W], t(big_v)[1, :, :, :W],
             t(big_vs)[1, :, :, :W])
    assert not views[0].is_contiguous()
    out = tda.decode_attention(t(q), views[0], views[1], views[2], views[3],
                               t(k_self), t(v_self), t(mask))
    dense = tda.decode_attention(t(q), *(v.contiguous() for v in views),
                                 t(k_self), t(v_self), t(mask))
    torch.testing.assert_close(out, dense, rtol=0, atol=0)


def test_decode_attention_vpu_rejects_grouped_heads():
    args = [torch.from_numpy(a) for a in _da_inputs(3, 2, 2, 16, 16, seed=0)]
    with pytest.raises(ValueError, match="G == 1"):
        tda.decode_attention_vpu(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64), (5, 64), (2, 3, 48)])
def test_rmsnorm_plain_matches_pallas_and_common(shape, dtype):
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    x32 = rng.standard_normal(shape).astype(np.float32)
    s32 = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jx = jnp.asarray(x32).astype(dtype)
    js = jnp.asarray(s32).astype(dtype)
    tdt = getattr(torch, dtype)
    # identical input bits on both sides
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    ts = torch.tensor(np.asarray(js.astype(jnp.float32))).to(tdt)
    out = trn.rmsnorm(tx, ts, 1e-5)
    via_common = tcommon.rms_norm(tx, ts, 1e-5)
    assert out.dtype == tdt
    torch.testing.assert_close(via_common, out, rtol=0, atol=0)
    refs = {
        "pallas": jrn.rmsnorm(jx, js, 1e-5, interpret=True),
        "common": jcommon.rms_norm(jx, js, 1e-5),
        "reference": jrn.rmsnorm_reference(jx, js, 1e-5),
    }
    got = out.to(torch.float32).numpy()
    for name, ref in refs.items():
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6, err_msg=name)
        else:
            # one bf16 ulp: f32 sums in another order may round the other way
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
            assert np.all(np.abs(got - ref) <= ulp), name


def test_cpu_tensors_never_count_as_launches():
    da0, rn0 = tda.launches, trn.launches
    args = [torch.from_numpy(a) for a in _da_inputs(3, 2, 1, 16, 16, seed=1)]
    tda.decode_attention(*args)
    tda.decode_attention_batched(*args)
    tda.decode_attention_vpu(*args)
    trn.rmsnorm(torch.ones(2, 8), torch.ones(8))
    assert (tda.launches, trn.launches) == (da0, rn0)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Anything but a CPU tensor goes to the kernel or raises: a tensor on
    a device with no kernel is an error, not a quiet plain run."""
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trn.rmsnorm(x, torch.empty((8,), device="meta"))
    args = [torch.from_numpy(a).to("meta") for a in _da_inputs(3, 2, 2, 16, 16, seed=2)]
    with pytest.raises(ValueError, match="unsupported device"):
        tda.decode_attention(*args)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a system nvcc exists")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_library_name_tracks_source_and_flags():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"


@pytest.mark.parametrize("capacity", [16, 48, 64, 100, 1024, 4096])
def test_window_buckets_match_reference(capacity):
    assert tgen.decode_window_buckets(capacity) == jgen.decode_window_buckets(capacity)
    for n in range(1, capacity + 1):
        assert tgen.decode_window_bucket(n, capacity) == jgen.decode_window_bucket(n, capacity)
        assert tgen.prefill_bucket(n, capacity) == jgen.prefill_bucket(n, capacity)
