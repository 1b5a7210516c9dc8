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


# ---------------------------------------------------------------------------
# The split kernel's algebra: partials per split and their merge
# ---------------------------------------------------------------------------


def _dmajor_split_emulation(q, k8t, ks, v8t, vs, mask, splits):
    """The split kernel's arithmetic in f32 torch (the kernel's type: a
    score plus the -1e9 mask is exactly -1e9 only in f32, which makes a
    row masked everywhere uniform), splits of ``split_len(W, splits)``
    positions: each split's scores (q * scale) . k8t * ks + mask, its max
    m, sum l and context sum_w v8t * (p * vs), then the merge that
    rescales by exp(m_i - M).  A split past W has m = -inf, l = 0, ctx =
    0, as the kernel writes it."""
    f32 = torch.float32
    q, k8t, ks, v8t, vs, mask = (torch.as_tensor(a).to(f32)
                                 for a in (q, k8t, ks, v8t, vs, mask))
    b, nkv, d, w = k8t.shape
    chunk = tdm.split_len(w, splits)
    qs = q * (1.0 / d ** 0.5)                                            # [B,NKV,D,1]
    parts = []
    for i in range(splits):
        lo, hi = i * chunk, min(w, (i + 1) * chunk)
        if hi <= lo:
            parts.append((torch.full((b, nkv, 1, 1), -torch.inf, dtype=f32),
                          torch.zeros((b, nkv, 1, 1), dtype=f32),
                          torch.zeros((b, nkv, d, 1), dtype=f32)))
            continue
        s = torch.sum(k8t[..., lo:hi] * qs, dim=2, keepdim=True)         # [B,NKV,1,n]
        s = s * ks[..., lo:hi] + mask[:, None, :, lo:hi]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        ctx = torch.sum(v8t[..., lo:hi] * (p * vs[..., lo:hi]), dim=-1, keepdim=True)
        parts.append((m, p.sum(-1, keepdim=True), ctx))
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    num = torch.zeros((b, nkv, d, 1), dtype=f32)
    den = torch.zeros((b, nkv, 1, 1), dtype=f32)
    for m, l, ctx in parts:
        f = torch.exp(m - mx)  # 0 for a split past W
        num = num + ctx * f
        den = den + l * f
    return num / den


def _split_edges(w, splits):
    """Lengths on and beside every split edge, 0 (a row masked everywhere)
    and W."""
    c = tdm.split_len(w, splits)
    edges = [j * c + o for j in range(1, splits) for o in (-1, 0, 1)]
    return sorted({n for n in [0, w, max(w - 1, 1), 1] + edges if 0 <= n <= w})


def _pallas_geometry(monkeypatch, nkv, d, w):
    """The JAX probe's kernel reads its geometry from module globals."""
    monkeypatch.setattr(jprobe, "NKV", nkv)
    monkeypatch.setattr(jprobe, "D", d)
    monkeypatch.setattr(jprobe, "W", w)


@pytest.mark.parametrize("w", [1, 97, 512, 4096])
def test_split_partials_and_merge_match_the_pallas_kernel(w, monkeypatch):
    """The kernel's split-and-merge algebra, with the splits the wrapper
    picks (8 at 4 slots x 2 heads from W = 512), equals the probe's Pallas
    kernel in interpret mode and the port's plain version: lengths on and
    beside every split edge, a row masked everywhere (the uniform average
    over W of vs * v) and W.  f32 on every side, summed in other orders:
    TOL."""
    nkv, d = 2, 16
    b = 4
    splits = tdm.dmajor_splits(b, nkv, w)
    assert splits == (1 if w <= tdm.WHOLE_WINDOW else 8)
    lengths = _split_edges(w, splits)
    lengths += [w] * (-len(lengths) % b)
    _pallas_geometry(monkeypatch, nkv, d, w)
    for i in range(0, len(lengths), b):
        dmaj = _dmajor(*_inputs(lengths[i:i + b], seed=w + i, nkv=nkv, d=d, w=w))
        got = _dmajor_split_emulation(*dmaj, splits).numpy()
        pallas = np.asarray(jprobe.attn_dmajor(*(jnp.asarray(a) for a in dmaj), interpret=True))
        np.testing.assert_allclose(got, pallas, **TOL)
        plain = tdm.attn_dmajor(*(torch.from_numpy(a) for a in dmaj)).numpy()
        np.testing.assert_allclose(got, plain, **TOL)
        for row, n in enumerate(lengths[i:i + b]):
            if n == 0:
                _, _, _, v8t, vst, _ = dmaj
                uniform = (v8t[row].astype(np.float64) * vst[row]).mean(axis=-1, keepdims=True)
                np.testing.assert_allclose(got[row], uniform, **TOL)


@pytest.mark.parametrize("w,splits", [(513, 8), (97, 8), (16, 3), (130, 2), (4096, 5)])
def test_split_merge_takes_empty_ragged_and_masked_splits(w, splits):
    """Forced split counts: a split past W (513 in 8 runs of 80, 97 in 8
    of 16, 16 in 3 of 16) weighs nothing and gives no NaN; a ragged last
    split (4096 in 5 runs of 832); a split masked everywhere (the
    length-40 row at W = 130)."""
    c = tdm.split_len(w, splits)
    assert c % tdm.SPLIT_ALIGN == 0 and splits * c >= w
    lengths = [0, w, min(40, w), max(1, w - c)]
    dmaj = _dmajor(*_inputs(lengths, seed=splits, nkv=2, d=16, w=w))
    got = _dmajor_split_emulation(*dmaj, splits).numpy()
    assert np.isfinite(got).all()
    ref = tdm.attn_dmajor_reference(*(torch.from_numpy(a) for a in dmaj)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("b,nkv", [(1, 1), (1, 16), (2, 8), (4, 2), (8, 16), (32, 16), (64, 32)])
def test_dmajor_splits_properties(b, nkv):
    """1..8 splits (one cluster's worth, the merge's bound) whose runs of
    split_len positions (a multiple of 16, at most MAX_CHUNK) cover W; 1
    up to WHOLE_WINDOW; at least MIN_SPLIT positions a split; where W
    allows, the grid fills one wave of BLOCKS_PER_SM blocks an SM and one
    more split would pass it."""
    wave = tdm.NUM_SMS * tdm.BLOCKS_PER_SM
    for w in list(range(1, 300)) + [384, 512, 513, 768, 1536, 4096, 4225, 6145, 12289,
                                    tdm.MAX_W - 1, tdm.MAX_W]:
        s = tdm.dmajor_splits(b, nkv, w)
        c = tdm.split_len(w, s)
        fewest = -(-w // tdm.MAX_CHUNK)
        assert 1 <= s <= tdm.MAX_SPLITS
        assert s * c >= w and c % tdm.SPLIT_ALIGN == 0 and c <= tdm.MAX_CHUNK
        if w <= tdm.WHOLE_WINDOW:
            assert s == 1
        if s > fewest:
            assert w // s >= tdm.MIN_SPLIT and b * nkv * s <= wave
            if s < tdm.MAX_SPLITS and w // (s + 1) >= tdm.MIN_SPLIT:
                assert b * nkv * (s + 1) > wave
    assert tdm.dmajor_splits(8, tdm.NKV, tdm.W) == 1  # the probe's shapes
    assert tdm.dmajor_splits(32, tdm.NKV, tdm.W) == 1
    assert tdm.dmajor_splits(1, tdm.NKV, 4096) == tdm.MAX_SPLITS  # the cap of 8 holds


def test_dmajor_load_width_follows_alignment():
    """16-byte copies for a dense window whose W is a multiple of 16, 4-byte
    ones for a W = 97 slice of a 100-wide buffer or a base off 16 bytes."""
    dense = torch.zeros((2, 4, 32, 512), dtype=torch.int8)
    assert tdm.load_width(dense, dense) == 16
    sliced = torch.zeros((3, 4, 32, 100), dtype=torch.int8)[..., :97]
    assert tdm.load_width(sliced, sliced) == 4
    assert tdm.load_width(dense, sliced) == 4
    off = torch.zeros((2 * 4 * 32 * 512 + 4,), dtype=torch.int8)[4:].view(2, 4, 32, 512)
    assert tdm.load_width(off, off) == 4
