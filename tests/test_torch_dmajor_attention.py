"""The port's D-major decode attention (its plain version, on CPU tensors)
against the JAX layout probe's Pallas kernel and einsum chain.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
this plain version and against the head-major decode kernel there).  Here
the JAX probe ``scripts/proto_dmajor_attention.py`` is loaded from its file
(it is a script, not a module of the JAX package) and its ``attn_dmajor``
runs in interpret mode on the same inputs, made from a seeded numpy
generator.  Then the self-row identity that lets the head-major kernel
compute the same function, the input checks, the timing helper and the
port's probe end to end.

Tolerance: f32 on both sides, which differ only in summation order: 1e-5
absolute and relative.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    decode_attention as tda,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    dmajor_attention as tdm,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.scripts import (
    proto_dmajor_attention as tprobe,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.utils import (
    timing,
)
from tpumlops.ops import decode_attention as jda

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_proto_dmajor_attention", ROOT / "scripts" / "proto_dmajor_attention.py")
jprobe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jprobe)

TOL = dict(atol=1e-5, rtol=1e-5)
NKV, D, W = jprobe.NKV, jprobe.D, jprobe.W


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads; one thread keeps
    this module from crowding tests that run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(lengths, seed, nkv=NKV, d=D, w=W):
    """Head-major inputs as the JAX probe draws them (int8 in [-127, 127],
    scales |N(0,1)| * 0.01 + 1e-3, f32 q, a 0 / -1e9 mask), from numpy."""
    b = len(lengths)
    rng = np.random.default_rng(seed)
    k8 = rng.integers(-127, 128, (b, nkv, w, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, nkv, w, d)).astype(np.int8)
    ks = (np.abs(rng.standard_normal((b, nkv, w, 1))) * 0.01 + 1e-3).astype(np.float32)
    vs = (np.abs(rng.standard_normal((b, nkv, w, 1))) * 0.01 + 1e-3).astype(np.float32)
    q = rng.standard_normal((b, nkv, 1, d)).astype(np.float32)
    mask = np.where(np.arange(w)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    return q, k8, ks, v8, vs, mask.astype(np.float32)[:, None, :]


def _dmajor(q, k8, ks, v8, vs, mask):
    """The D-major copies (real transposes) of head-major numpy inputs."""
    t = lambda x: np.ascontiguousarray(np.swapaxes(x, 2, 3))  # noqa: E731
    return t(q), t(k8), t(ks), t(v8), t(vs), mask


@pytest.mark.parametrize("lengths", [[173], [0, 1, 300, W]], ids=["B1", "B4"])
def test_plain_matches_pallas_kernel_in_interpret_mode(lengths):
    """B=1 and B=4 take the Pallas wrapper's bb = 1 and bb = 4 branches;
    the length-0 row is the uniform average over W of vs * v."""
    dmaj = _dmajor(*_inputs(lengths, seed=len(lengths)))
    pallas = np.asarray(jprobe.attn_dmajor(*(jnp.asarray(a) for a in dmaj), interpret=True))
    launches = tdm.launches
    out = tdm.attn_dmajor(*(torch.from_numpy(a) for a in dmaj))
    assert tdm.launches == launches  # CPU tensors never reach the kernel
    assert out.dtype == torch.float32 and out.shape == (len(lengths), NKV, D, 1)
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)
    ref = tdm.attn_dmajor_reference(*(torch.from_numpy(a) for a in dmaj)).numpy()
    np.testing.assert_array_equal(out.numpy(), ref)
    if lengths[0] == 0:
        _, _, _, v8t, vst, _ = dmaj
        uniform = (v8t[0].astype(np.float32) * vst[0]).mean(axis=-1, keepdims=True)
        np.testing.assert_allclose(out[0].numpy(), uniform, **TOL)


@pytest.mark.parametrize("lengths", [[173], [0, 1, 300, W]], ids=["B1", "B4"])
def test_attn_xla_matches_the_probe_chain_and_the_dmajor_form(lengths):
    args = _inputs(lengths, seed=10 + len(lengths))
    want = np.asarray(jprobe.attn_xla(*(jnp.asarray(a) for a in args)))
    got = tdm.attn_xla(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dmaj = tdm.attn_dmajor(*(torch.from_numpy(a) for a in _dmajor(*args)))
    np.testing.assert_allclose(dmaj.transpose(2, 3).numpy(), got.numpy(), **TOL)


def test_self_row_identity_gives_the_head_major_kernel_the_same_function():
    """No-self-term attention over L positions equals the head-major
    kernel's contract with the mask at L - 1 and the dequantized row L - 1
    as the self term (lengths 1 and W are the edges), for the port's plain
    version and the JAX package's oracle alike."""
    lengths = [1, 2, 97, W - 1, W]
    args = _inputs(lengths, seed=7, nkv=4)
    t = torch.from_numpy
    want = tdm.attn_dmajor_reference(*(t(a) for a in _dmajor(*args))).transpose(2, 3)
    hm = tdm.headmajor_self_row_inputs(*(t(a) for a in args[:5]), lengths)
    assert hm[5].shape == (len(lengths), 4, 1, D) and hm[5].dtype == torch.float32
    np.testing.assert_allclose(tda.decode_attention(*hm).numpy(), want.numpy(), **TOL)
    jgot = jda.decode_attention_reference(*(jnp.asarray(x.numpy()) for x in hm))
    np.testing.assert_allclose(np.asarray(jgot), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="length >= 1"):
        tdm.headmajor_self_row_inputs(*(t(a) for a in args[:5]), [0] * len(lengths))


def _good(b=2, nkv=2, d=16, w=24):
    dmaj = _dmajor(*_inputs([w // 2] * b, seed=3, nkv=nkv, d=d, w=w))
    return [torch.from_numpy(a) for a in dmaj]


def test_check_inputs_accepts_the_contract():
    assert tdm.check_inputs(*_good()) == (2, 2, 16, 24)
    args = _good()
    args[0] = args[0].to(torch.bfloat16)
    assert tdm.check_inputs(*args) == (2, 2, 16, 24)


def _transposed_view(args):
    # A head-major buffer seen as D-major through .transpose: W is strided.
    args[1] = args[1].transpose(2, 3).contiguous().transpose(2, 3)
    return args


def _wrong_dtype(args):
    args[3] = args[3].to(torch.int16)
    return args


def _mismatched_shapes(args):
    args[2] = args[2][:, :, :, :-1]
    return args


def _unaligned_rows(args):
    # W = 23 sliced from a 24-wide buffer keeps 4-byte rows; a dense
    # 23-wide copy does not.
    args = [a[..., :23] if a.dim() == 4 and a.shape[-1] == 24 else a for a in args]
    args[5] = args[5][..., :23]
    args[1] = args[1].contiguous()
    return args


@pytest.mark.parametrize("broken,match", [
    (_transposed_view, "dense W axis"),
    (_wrong_dtype, "int8"),
    (_mismatched_shapes, "shapes disagree"),
    (_unaligned_rows, "4-byte aligned"),
])
def test_check_inputs_rejects(broken, match):
    with pytest.raises(ValueError, match=match):
        tdm.check_inputs(*broken(_good()))


def test_sliced_window_of_a_padded_buffer_is_accepted():
    args = [a[..., :23] if a.dim() == 4 and a.shape[-1] == 24 else a for a in _good()]
    args[5] = args[5][..., :23]
    assert tdm.check_inputs(*args) == (2, 2, 16, 23)


def test_unsupported_device_raises_instead_of_falling_back():
    with pytest.raises(ValueError, match="unsupported device"):
        tdm.attn_dmajor(*(a.to("meta") for a in _good()))


def test_delta_timed_chains_the_carry_on_the_cpu():
    m = torch.from_numpy(np.random.default_rng(0).standard_normal((192, 192)).astype(np.float32))
    seen, made = [], []

    def step(c):
        seen.append(c)
        out = c + 1e-6 * torch.tanh(c @ m)
        seen.append(out)
        return out

    def make_carry(i):
        made.append(i)
        return torch.full((192, 192), float(i))

    n1, n2, runs = 2, 10, 3
    p = timing.delta_timed(step, make_carry, n1=n1, n2=n2, runs=runs)
    assert 0 < p[50] <= p[99]
    assert len(p["samples"]) == runs
    assert made == [-1, -2] + list(range(2 * runs))  # distinct carries per run
    calls = len(seen) // 2
    pairs = [(seen[2 * i], seen[2 * i + 1]) for i in range(calls)]
    # A chain continues while each input is the last output.
    starts = [i for i in range(calls) if i == 0 or pairs[i][0] is not pairs[i - 1][1]]
    assert np.diff(starts + [calls]).tolist() == [n1, n2] * (runs + 1)  # warm-up pair first
    with pytest.raises(ValueError):
        timing.delta_timed(step, make_carry, n1=5, n2=5, runs=1)


def test_probe_runs_end_to_end_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(tdm, "LAYERS", 2)  # chains of 2 and 10 calls: CPU-sized
    out = tprobe.main(["--device", "cpu", "--slots", "2", "--rounds", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == json.loads(json.dumps(out))
    row = lines[0]
    assert row["slots"] == 2 and row["device"] == "cpu"
    for key in ("xla_ms_per_step", "dmajor_ms_per_step", "headmajor_ms_per_step", "speedup"):
        assert row[key] > 0, key
    assert row["max_abs_err"] < tprobe.PARITY_TOL
    assert row["headmajor_max_abs_err"] < tprobe.PARITY_TOL


def test_probe_refuses_to_run_without_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tprobe.main(["--slots", "2"])
