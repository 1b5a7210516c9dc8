"""Port kernels' plain versions against the JAX package's Pallas kernels.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there); here, on CPU tensors, each wrapper runs its
plain version, which is checked against the Pallas kernel it replaces (in
interpret mode, as the JAX package's own tests run it) and against the
XLA oracle, with the same inputs made from a seeded numpy generator.
"""

import importlib

import jax
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
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.scripts import (
    ab_kernels as tab,
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


def _split_emulation(q, k8, ks, v8, vs, k_self, v_self, mask, splits):
    """The split kernel's arithmetic in f64 torch: each split's scores
    (q * scale) . k8 * ks + mask, its max m, sum l and P . V partial acc,
    then the merge that joins the self term once.  A split past W has m =
    -inf, l = 0, acc = 0, as the kernel writes it."""
    q, k8, ks, v8, vs, k_self, v_self, mask = (
        torch.as_tensor(a).to(torch.float64)
        for a in (q, k8, ks, v8, vs, k_self, v_self, mask))
    b, nkv, g, d = q.shape
    w = k8.shape[2]
    chunk = tda.split_len(w, splits)
    qs = q * (1.0 / d ** 0.5)
    parts = []
    for i in range(splits):
        lo, hi = i * chunk, min(w, (i + 1) * chunk)
        if hi <= lo:
            parts.append((torch.full((b, nkv, g), -torch.inf, dtype=torch.float64),
                          torch.zeros((b, nkv, g), dtype=torch.float64),
                          torch.zeros((b, nkv, g, d), dtype=torch.float64)))
            continue
        sc = torch.einsum("bngd,bnwd->bngw", qs, k8[:, :, lo:hi])
        sc = sc * ks[:, :, None, lo:hi, 0] + mask[:, :, None, lo:hi]
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        acc = torch.einsum("bngw,bnwd->bngd", p * vs[:, :, None, lo:hi, 0], v8[:, :, lo:hi])
        parts.append((m, p.sum(-1), acc))
    s_self = torch.einsum("bngd,bnsd->bng", qs, k_self)
    mx = s_self
    for m, _, _ in parts:
        mx = torch.maximum(mx, m)
    p_self = torch.exp(s_self - mx)
    den, num = p_self, p_self[..., None] * v_self
    for m, l, acc in parts:
        f = torch.exp(m - mx)  # 0 for a split past W
        den = den + l * f
        num = num + acc * f[..., None]
    return num / den[..., None]


def _lengths_mask(lengths, w):
    lengths = np.asarray(lengths)
    mask = np.where(np.arange(w)[None, :] < lengths[:, None], 0.0, -1e9)
    return mask.astype(np.float32)[:, None, :]


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("W", [16, 96, 97, 768, 4096])
def test_split_partials_and_merge_match_the_reference(W, G):
    """The kernel's split-and-merge algebra, with the splits the wrapper
    picks, equals the JAX package's decode_attention_reference: lengths on
    and beside the split boundaries, 0 (exactly v_self) and W; a row whose
    later splits are masked everywhere.  f64 emulation against the f32
    reference: 1e-5, the f32 summation-order tolerance of this file."""
    B, NKV, D = 8, 2, 16
    splits = tda.num_splits(B, NKV, W)
    c = tda.split_len(W, splits)
    if splits > 1:
        cuts = sorted({c, (splits // 2) * c, (splits - 1) * c})
        lengths = [0, W] + [x + o for x in cuts for o in (-1, 0, 1)]
        lengths = (lengths + [c // 2] * B)[:B]
        assert any(0 < n <= (splits - 1) * c - c for n in lengths)  # a split masked everywhere
    else:
        lengths = [0, W, W - 1, 1, W // 2, W // 3, 2, W - 2]
    args = list(_da_inputs(B, NKV, G, D, W, seed=W + G))
    args[-1] = _lengths_mask(lengths, W)
    got = _split_emulation(*args, splits).numpy()
    ref = np.asarray(jda.decode_attention_reference(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, ref, rtol=DA_TOL, atol=DA_TOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(args[6][0], got[0].shape),
                               rtol=DA_TOL, atol=DA_TOL)
    port = tda.decode_attention(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, port, rtol=DA_TOL, atol=DA_TOL)


@pytest.mark.parametrize("W,splits", [(96, 13), (97, 3), (16, 7), (130, 2)])
def test_split_merge_takes_empty_and_ragged_splits(W, splits):
    """Forced split counts: a split past W (96 in 13 runs of 8, 16 in 7 of
    3) contributes nothing and no NaN; a ragged last split (97 = 33 + 33 +
    31); one split masked everywhere (the length-40 row at W = 130)."""
    B, NKV, G, D = 4, 2, 2, 16
    args = list(_da_inputs(B, NKV, G, D, W, seed=splits))
    args[-1] = _lengths_mask([0, W, W // 3, min(40, W)], W)
    got = _split_emulation(*args, splits).numpy()
    assert np.isfinite(got).all()
    ref = np.asarray(jda.decode_attention_reference(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, ref, rtol=DA_TOL, atol=DA_TOL)


def _jax_dense_chain(q, k, v, k_self, v_self, mask):
    """The dense-cache decode chain of the JAX package's Llama
    ``_block_decode_deferred`` (``models/llama.py:611-637``) at S = 1, on
    the wrapper's layouts: q ``[B, NKV, G, D]`` as qg ``[B, 1, NKV, G,
    D]``, the window ``[B, NKV, W, D]``, the current K/V ``[B, NKV, 1, D]``
    as ``[B, 1, NKV, D]``, the strict mask ``[B, 1, W]`` as mask_bias ``[B,
    1, 1, W]``; ``[B, NKV, G, D]`` out."""
    hd = q.shape[-1]
    qg = q[:, None]
    k_new, v_new = k_self[:, :, 0][:, None], v_self[:, :, 0][:, None]
    mask_bias = mask[:, None]
    scores = jnp.einsum("bqngd,bnkd->bngqk", qg, k,
                        preferred_element_type=jnp.float32) / jnp.sqrt(jnp.float32(hd))
    scores = scores + mask_bias[:, None]
    score_self = (jnp.einsum("bqngd,bqnd->bngq", qg, k_new, preferred_element_type=jnp.float32)
                  / jnp.sqrt(jnp.float32(hd)))[..., None]
    probs = jax.nn.softmax(jnp.concatenate([scores, score_self], axis=-1), axis=-1)
    probs_cache, prob_self = probs[..., :-1], probs[..., -1:]
    ctx = jnp.einsum("bngqk,bnkd->bqngd", probs_cache.astype(q.dtype), v)
    ctx = ctx + jnp.einsum("bngqk,bknd->bqngd", prob_self.astype(q.dtype), v_new)
    return ctx[:, 0]


_jdense_chain = jax.jit(_jax_dense_chain)


def _dense_inputs(B, NKV, G, D, W, lengths, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(sh).astype(dtype) for sh in
               ((B, NKV, G, D), (B, NKV, W, D), (B, NKV, W, D)))
    k_self, v_self = rng.standard_normal((2, B, NKV, 1, D)).astype(dtype)
    return q, k, v, k_self, v_self, _lengths_mask(lengths, W)


@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("W", [16, 96, 97, 768, 4096])
def test_dense_decode_plain_and_split_emulation_match_the_jax_chain(W, G):
    """The bf16-window instance's plain version and its split-and-merge
    algebra (the splits the wrapper picks; the int8 emulation with scales
    of exactly 1, which the dense instance skips) against the JAX dense
    decode chain: lengths on and beside the split edges, 0 (exactly
    v_self) and W.  f32 on both sides: DA_TOL, summation order."""
    B, NKV, D = 8, 2, 16
    splits = tda.num_splits(B, NKV, W)
    c = tda.split_len(W, splits)
    lengths = [0, W, W - 1, 1, c, min(c + 1, W), W // 2, max(c - 1, 0)]
    q, k, v, k_self, v_self, mask = _dense_inputs(B, NKV, G, D, W, lengths, seed=W + G)
    want = np.asarray(_jdense_chain(*(jnp.asarray(a) for a in (q, k, v, k_self, v_self, mask))))
    t = torch.from_numpy
    launches = tda.launches
    plain = tda.decode_attention_dense(t(q), t(k), t(v), t(k_self), t(v_self), t(mask))
    assert tda.launches == launches and plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), want, rtol=DA_TOL, atol=DA_TOL)
    ones = np.ones((B, NKV, W, 1), np.float32)
    got = _split_emulation(q, k, ones, v, ones, k_self, v_self, mask, splits).numpy()
    np.testing.assert_allclose(got, want, rtol=DA_TOL, atol=DA_TOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(v_self[0], got[0].shape),
                               rtol=DA_TOL, atol=DA_TOL)


@pytest.mark.parametrize("W", [16, 97, 768])
def test_dense_decode_plain_is_the_jax_chain_in_f64(W):
    """In f64 the plain version runs the reference chain step for step
    (f32 scores and softmax, f64 products): equal to f32 rounding."""
    args = _dense_inputs(3, 2, 2, 16, W, [0, W // 2, W], seed=W, dtype=np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(_jdense_chain(*(jnp.asarray(a) for a in args[:5]),
                                        jnp.asarray(args[5])))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = tda.decode_attention_dense(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-7)


def test_dense_decode_load_width_and_refusals():
    """The load width counts bytes: 16 for a bf16 head-major window, 4 for
    [..., :128] of a 130-wide bf16 buffer; a window on a device without the
    kernel raises, through the wrapper and its launch path alike."""
    cache = torch.zeros((2, 4, 8, 64, 128), dtype=torch.bfloat16)
    assert tda.load_width(cache[1, :, :, :48], cache[1, :, :, :48]) == 16
    narrow = torch.zeros((4, 8, 64, 130), dtype=torch.bfloat16)[..., :128]
    assert tda.load_width(narrow, narrow) == 4
    q, k, v, k_self, v_self, mask = (torch.from_numpy(a).to("meta")
                                     for a in _dense_inputs(2, 2, 1, 16, 16, [0, 16], seed=0))
    with pytest.raises(ValueError, match="unsupported device"):
        tda.decode_attention_dense(q, k, v, k_self, v_self, mask)
    with pytest.raises(ValueError, match="unsupported device"):
        tda._launch(q, k.to(torch.bfloat16), None, v, None, k_self, v_self, mask)


@pytest.mark.parametrize("b,nkv", [(1, 1), (1, 8), (2, 8), (4, 32), (8, 16), (32, 16),
                                   (64, 32), (1, 32)])
def test_num_splits_properties(b, nkv):
    """At least 1 and at most W; 1 for small windows; at least MIN_SPLIT
    positions a split; where W allows, the grid fills one wave of 4 blocks
    on each of the 132 SMs (one more split would pass it)."""
    wave = tda.NUM_SMS * tda.BLOCKS_PER_SM
    assert wave == 4 * 132
    for w in list(range(1, 300)) + [384, 512, 768, 997, 1000, 1536, 2049, 4096, 4225,
                                    8192, 40000]:
        s = tda.num_splits(b, nkv, w)
        c = tda.split_len(w, s)
        fewest = -(-w // tda.MAX_SPLIT)  # the splits whose scores fit shared memory
        assert 1 <= s <= w
        assert s * c >= w and c <= tda.MAX_SPLIT
        if w <= tda.WHOLE_WINDOW:
            assert s == 1
        else:
            assert s >= fewest
            if w // tda.MIN_SPLIT * b * nkv >= wave and fewest <= wave // (b * nkv):
                assert b * nkv * s <= wave < b * nkv * (s + 1)
        if s > fewest:
            assert c >= tda.MIN_SPLIT
    assert tda.num_splits(4, 32, 768) == 4  # Llama-2-7B, 4 slots: 512 blocks of 192
    assert tda.num_splits(1, 32, 768) == 12  # one slot: 384 blocks of 64
    assert tda.num_splits(4, 32, 192) == 1


def test_load_width_follows_alignment():
    """16-byte rows where the bases and strides allow them (the head-major
    cache), 4-byte ones for a [..., :128] view of a 132-wide buffer."""
    cache = torch.zeros((2, 4, 8, 64, 128), dtype=torch.int8)
    window = cache[1, :, :, :48]
    assert tda.load_width(window, window) == 16
    wide = torch.zeros((4, 8, 64, 132), dtype=torch.int8)[..., :128]
    assert tda.load_width(wide, wide) == 4
    assert tda.load_width(window, wide) == 4
    odd = torch.zeros((4 * 8 * 48 * 128 + 4,), dtype=torch.int8)[4:].view(4, 8, 48, 128)
    assert tda.load_width(odd, odd) == 4


def test_ab_kernels_loads_another_checkout_as_its_own_package(monkeypatch):
    """The A/B script imports the other checkout (here this one) under its
    own name: its modules, build paths and launch counters are its own."""
    import sys
    from pathlib import Path

    for name in [m for m in sys.modules if m == "ab_other" or m.startswith("ab_other.")]:
        monkeypatch.delitem(sys.modules, name)
    root = Path(__file__).resolve().parents[1]
    other_da, other_fa = tab.load_other(str(root))
    try:
        assert other_da.__name__ == "ab_other.ops.decode_attention" and other_da is not tda
        assert other_fa.__name__ == "ab_other.ops.flash_attention"
        assert other_da._build is not tda._build
        args = [torch.from_numpy(a) for a in _da_inputs(3, 2, 2, 16, 24, seed=5)]
        torch.testing.assert_close(other_da.decode_attention(*args), tda.decode_attention(*args),
                                   rtol=0, atol=0)
    finally:
        for name in [m for m in sys.modules if m == "ab_other" or m.startswith("ab_other.")]:
            del sys.modules[name]


def test_ab_kernels_loads_the_other_dmajor_and_rmsnorm_modules(monkeypatch):
    """The A/B's D-major and RMSNorm shapes take the other checkout's
    modules under its own name, with their own launch counters."""
    import sys
    from pathlib import Path

    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
        dmajor_attention as tdm,
    )

    for name in [m for m in sys.modules if m == "ab_other" or m.startswith("ab_other.")]:
        monkeypatch.delitem(sys.modules, name)
    tab.load_other(str(Path(__file__).resolve().parents[1]))
    try:
        other_dm, other_rn = tab.other_module("dmajor_attention"), tab.other_module("rmsnorm")
        assert other_dm.__name__ == "ab_other.ops.dmajor_attention" and other_dm is not tdm
        assert other_rn.__name__ == "ab_other.ops.rmsnorm" and other_rn is not trn
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32))
        torch.testing.assert_close(other_rn.rmsnorm(x, torch.ones(64)),
                                   trn.rmsnorm(x, torch.ones(64)), rtol=0, atol=0)
    finally:
        for name in [m for m in sys.modules if m == "ab_other" or m.startswith("ab_other.")]:
            del sys.modules[name]


def test_ab_kernels_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tab.main(["--other", "."])


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


# ---------------------------------------------------------------------------
# RMSNorm: the kernel's plan and its order of partial sums
# ---------------------------------------------------------------------------


def _rmsnorm_plan_emulation(x, scale, eps, plan):
    """The kernel's sum of squares in f32 torch, in its order under
    ``plan``: each thread's elements in order, the butterfly of shuffles
    over a group's lanes, the group's warps in order, then the C cluster
    partials in rank order; then rsqrt and (x * r) * scale in f32."""
    f32 = torch.float32
    xf = torch.as_tensor(x).to(f32)
    rows, h = xf.shape
    vec, nvec = plan.vec, h // plan.vec
    xv = xf.reshape(rows, nvec, vec)
    total = torch.zeros(rows, dtype=f32)
    for rank in range(plan.cluster):
        lanes = []
        for j in range(plan.tpr):
            s = torch.zeros(rows, dtype=f32)
            for k in range(plan.nv):
                local = k * plan.tpr + j
                idx = rank * plan.per_cta + local
                if local < plan.per_cta and idx < nvec:
                    for e in range(vec):
                        s = s + xv[:, idx, e] * xv[:, idx, e]
            lanes.append(s)
        lanes = torch.stack(lanes, dim=1)                  # [rows, tpr]
        width = min(plan.tpr, 32)
        for w0 in range(0, plan.tpr, width):
            warp = lanes[:, w0:w0 + width].clone()
            off = width // 2
            while off:
                warp = warp + warp[:, torch.arange(width) ^ off]
                off //= 2
            lanes[:, w0:w0 + width] = warp
        part = torch.zeros(rows, dtype=f32)
        for w0 in range(0, plan.tpr, width):               # the group's warps, in order
            part = part + lanes[:, w0]
        total = total + part if rank else part
    r = torch.rsqrt(total / h + torch.tensor(eps, dtype=f32))
    out = xf * r[:, None] * torch.as_tensor(scale).to(f32)
    return out.to(torch.as_tensor(x).dtype)


def _bf16_ulp(ref):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 1000, 4096])
def test_rmsnorm_plan_emulation_matches_reference_and_pallas(h, dtype):
    """The kernel's partial-sum order under the plan it takes (16-byte
    vectors), under the scalar instance (a misaligned x), and under a
    forced cluster of 2 CTAs a row (C partials, then the cluster total),
    against the port's plain version and the JAX package's Pallas rmsnorm
    in interpret mode: bf16 within one ulp, f32 within 1e-6."""
    rng = np.random.default_rng(h)
    x32 = rng.standard_normal((3, h)).astype(np.float32)
    s32 = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    jx, js = jnp.asarray(x32).astype(dtype), jnp.asarray(s32).astype(dtype)
    tdt = getattr(torch, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    ts = torch.tensor(np.asarray(js.astype(jnp.float32))).to(tdt)
    item = tx.element_size()
    vec_plan = trn.rmsnorm_plan(3, h, item, True)
    assert vec_plan.vec == 16 // item
    per = -(-(h // vec_plan.vec) // 2)
    plans = {
        "vector": vec_plan,
        "scalar": trn.rmsnorm_plan(3, h, item, False),
        "cluster2": trn.Plan(vec_plan.vec, 1, 2, per, trn._pow2_at_least(per),
                             trn._pow2_at_least(per)),
    }
    refs = {
        "reference": trn.rmsnorm_reference(tx, ts, 1e-5).to(torch.float32).numpy(),
        "pallas": np.asarray(jrn.rmsnorm(jx, js, 1e-5, interpret=True).astype(jnp.float32)),
    }
    for pname, plan in plans.items():
        got = _rmsnorm_plan_emulation(tx, ts, 1e-5, plan).to(torch.float32).numpy()
        for rname, ref in refs.items():
            if dtype == "float32":
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{pname} {rname}")
            else:
                assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), f"{pname} {rname}"


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows", [1, 4, 32, 256, 512])
def test_rmsnorm_plan_covers_every_element_once(rows, itemsize):
    """Every vector of a row belongs to exactly one (CTA, thread, slot);
    whole warps; the thread limits of the 16-byte (512) and scalar (1024)
    instances; a cluster only where one CTA cannot hold the row; the
    scalar instance for a misaligned base or a row that is not a whole
    number of 16 bytes; ValueError past the longest row."""
    for h, aligned in ((64, True), (1000, True), (1001, True), (4096, True),
                       (4096, False), (8192, True), (32768, True), (65536, True)):
        p = trn.rmsnorm_plan(rows, h, itemsize, aligned)
        if not aligned or (h * itemsize) % 16:
            assert p.vec == 1
        else:
            assert p.vec == 16 // itemsize
        nvec = h // p.vec
        seen = []
        for rank in range(p.cluster):
            for j in range(p.tpr):
                for k in range(p.nv):
                    local = k * p.tpr + j
                    idx = rank * p.per_cta + local
                    if local < p.per_cta and idx < nvec:
                        seen.append(idx)
        assert sorted(seen) == list(range(nvec)), (h, aligned, p)
        assert p.nv in (1, 2, 4) and p.threads % 32 == 0 and p.threads % p.tpr == 0
        max_threads = trn.MAX_THREADS if p.vec > 1 else trn.MAX_SCALAR_THREADS
        assert p.threads <= max_threads
        assert p.cluster == 1 or (p.threads == p.tpr and nvec > max_threads * trn.MAX_NV)
        assert 1 <= p.cluster <= trn.MAX_CLUSTER
    bf16_row = trn.rmsnorm_plan(rows, 4096, 2, True)  # Llama-2-7B's hidden, bf16
    assert (bf16_row.vec, bf16_row.nv, bf16_row.cluster, bf16_row.tpr) == (8, 2, 1, 256)
    with pytest.raises(ValueError, match="elements a row"):
        trn.rmsnorm_plan(rows, 8 * 1024 * 4 + 1, 2, False)
