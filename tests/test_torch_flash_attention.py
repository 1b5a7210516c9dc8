"""The port's flash attention (its plain version, on CPU tensors) against
the JAX package's Pallas flash kernel and its XLA oracle.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
this plain version there).  Here the five cases of the JAX package's own
flash tests go through both packages with the same inputs, made from a
seeded numpy generator; the Pallas kernel runs in interpret mode, as the
JAX package's tests run it.  Then the port's additions: the additive key
bias and strided q/k/v, against the einsum chain of BERT's
``_self_attention``; and the query offset with grouped K/V heads of
Llama's prefill and chunked prefill, against the attention lines of the
JAX package's Llama ``_block`` (``models/llama.py:370``) in f64.  Last,
the ragged instance of packed prefill: its plain version against a JAX
transcript of ``_block_verify_deferred``'s attention lines on cache rows
gathered by ``slots`` (G = 1 and 4, int8 and dense caches, 1e-5: f32
scores and softmax on both sides), and a torch emulation of the CUDA
kernel's plan (query tiles of 64 or 128 rows, window pieces from
``ragged_plan`` each under one online softmax of 16-key slices, the chunk
in a row's last piece with the exact diagonal put in place of its
round-trip score and p_jj * v_j added from the exact V, the pieces' f32
partials joined by the max-rescale) against the plain version (1e-6 in
f64, and 2e-2 with P rounded to bf16 as the kernel's MMA takes it) and
the JAX lines, with the plan's coverage properties.

Tolerances: f32 2e-5 absolute and relative, as the JAX package's own
flash tests (summation order and where the scale is applied).  bf16 I/O:
1e-2 against the Pallas kernel (both keep the probabilities in f32 and
round the output once, so they differ by at most about one bf16 ulp), and
3e-2 against the oracle, which also rounds the probabilities to bf16 (the
JAX package's own bf16 tolerance).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    bert as TB,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    flash_attention as tfa,
)
from tpumlops.models import bert as JB
from tpumlops.models import llama as J

jfa = importlib.import_module("tpumlops.ops.flash_attention")

# The JAX side jitted: one compile per shape.
_jflash = jax.jit(jfa.flash_attention, static_argnames=(
    "causal", "kv_len", "scale", "block_q", "block_k", "interpret"))
_joracle = jax.jit(jfa.attention_reference, static_argnames=("causal", "kv_len", "scale"))

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL_FLASH = dict(atol=1e-2, rtol=1e-2)
BF16_TOL_ORACLE = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads; one thread keeps
    this module from crowding tests that run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b=2, h=3, s=64, d=16, t=None, seed=0):
    t = t or s
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, t, d)).astype(np.float32),
            rng.standard_normal((b, h, t, d)).astype(np.float32))


# The cases of the JAX package's tests/test_ops.py flash tests: shapes,
# masks and Pallas tiles.
CASES = {
    "full": dict(shape=dict(), kw=dict(), tiles=32),
    "causal": dict(shape=dict(s=48), kw=dict(causal=True), tiles=16),
    "non_divisible": dict(shape=dict(s=50, t=50), kw=dict(), tiles=16),
    "kv_len": dict(shape=dict(s=32, t=64), kw=dict(kv_len=40), tiles=16),
    "bf16_io": dict(shape=dict(s=32), kw=dict(), tiles=16, bf16=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_pallas_and_oracle(case):
    c = CASES[case]
    q, k, v = _qkv(**c["shape"], seed=len(case))
    bf16 = c.get("bf16", False)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32) for x in (q, k, v))
    pallas = _jflash(jq, jk, jv, interpret=True, block_q=c["tiles"], block_k=c["tiles"],
                     **c["kw"])
    oracle = _joracle(jq, jk, jv, **c["kw"])
    tq, tk, tv = (convert.to_tensor(np.asarray(x)) for x in (jq, jk, jv))
    launches = tfa.launches
    out = tfa.flash_attention(tq, tk, tv, **c["kw"])
    assert tfa.launches == launches  # CPU tensors never reach the kernel
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert out.shape == q.shape
    got = out.float().numpy()
    tol_flash = BF16_TOL_FLASH if bf16 else F32_TOL
    tol_oracle = BF16_TOL_ORACLE if bf16 else F32_TOL
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **tol_flash)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), **tol_oracle)


def test_no_key_to_attend_averages_v_as_the_oracle():
    """kv_len 0 masks every key: each score is -1e30, so every row is the
    mean of V over the T keys, as ``attention_reference`` gives, causal or
    not.  The Pallas kernel agrees where T is a tile multiple (T=8); with a
    ragged T it also counts its zero padding, so it is compared only there."""
    for t in (8, 5):
        q, k, v = _qkv(s=8, t=t, seed=t)
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        mean_v = np.broadcast_to(v.mean(axis=2, keepdims=True), q.shape[:3] + (v.shape[3],))
        for causal in (False, True):
            out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), kv_len=0,
                                      causal=causal).numpy()
            oracle = _joracle(jq, jk, jv, kv_len=0, causal=causal)
            np.testing.assert_allclose(out, np.asarray(oracle), **F32_TOL)
            np.testing.assert_allclose(out, mean_v, **F32_TOL)
            if t == 8:
                pallas = _jflash(jq, jk, jv, kv_len=0, causal=causal, interpret=True)
                np.testing.assert_allclose(out, np.asarray(pallas), **F32_TOL)


def _bert_chain(q, k, v, mask_bias):
    """The attention lines of the JAX package's ``bert._self_attention``
    on [B, S, NH, HD] projections and a [B, 1, 1, S] bias."""
    hd = q.shape[-1]
    scores = jnp.einsum("bqnd,bknd->bnqk", q, k,
                        preferred_element_type=jnp.float32) / jnp.sqrt(jnp.float32(hd))
    probs = jax.nn.softmax(scores + mask_bias, axis=-1).astype(q.dtype)
    return jnp.einsum("bnqk,bknd->bqnd", probs, v)


@pytest.mark.parametrize("hd", [16, 64])
def test_bias_and_strided_views_match_the_bert_chain(hd):
    """q/k/v sliced from one [B, S, 3*NH*HD] projection buffer, taken as
    [B, NH, S, HD] views without a copy; a ragged mask with one row
    masked everywhere, which BERT averages uniformly."""
    b, s, nh = 3, 20, 2
    rng = np.random.default_rng(hd)
    buf = rng.standard_normal((b, s, 3 * nh * hd)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[1, 13:] = 0
    mask[2, :] = 0  # all keys masked
    mask_bias = (1.0 - mask) * -1e9
    jq, jk, jv = (jnp.asarray(buf[..., i * nh * hd:(i + 1) * nh * hd].reshape(b, s, nh, hd))
                  for i in range(3))
    want = np.asarray(jax.jit(_bert_chain)(jq, jk, jv, jnp.asarray(mask_bias)[:, None, None, :]))

    tbuf = torch.from_numpy(buf)
    views = [tbuf[..., i * nh * hd:(i + 1) * nh * hd].view(b, s, nh, hd).transpose(1, 2)
             for i in range(3)]
    assert views[0].data_ptr() == tbuf.data_ptr()  # views, not copies
    out = tfa.flash_attention(*views, scale=1.0 / hd**0.5, bias=torch.from_numpy(mask_bias))
    got = out.transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    # The fully masked row is the uniform average of V, not 0.
    np.testing.assert_allclose(got[2], np.broadcast_to(np.asarray(jv[2]).mean(0), got[2].shape),
                               **F32_TOL)


# chip_smoke.FLASH_TOL["bfloat16"]: the kernel's bf16 output against its
# plain version on the card, absolute and relative.
FLASH_TOL_BF16 = 2e-2


def _flash_bf16_p(q, k, v, scale, bias=None, causal=False, kv_len=None, tile=64,
                  q_offset=0):
    """The tensor-core kernel's arithmetic in f32 torch: bf16 q/k/v (k and
    v with their own NKV heads, query head h reading K/V head h // G),
    scores (q . k) * scale + bias, then the replacement masks (-1e30, the
    causal one from each query's position q_offset + i); an online softmax
    over 64-key tiles from a running max of -1e30, whose probabilities are
    rounded to bf16 against the running max (the row sum adds the rounded
    values) before the product with V; the output rounded to bf16.  The
    tiles past a query tile's last position, which the kernel skips, hold
    only -1e30 scores below a finite running max: they add exactly 0."""
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    b, h, s_q, d = q.shape
    t = k.shape[2]
    g = h // k.shape[1]
    kf, vf = kf.repeat_interleave(g, dim=1), vf.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    key = torch.arange(t)[None, :]
    masked = key >= (t if kv_len is None else kv_len)
    if causal:
        masked = masked | (key > q_offset + torch.arange(s_q)[:, None])
    s = torch.where(masked, torch.tensor(-1e30), s)
    m = torch.full((b, h, s_q, 1), -1e30)
    l = torch.zeros((b, h, s_q, 1))
    acc = torch.zeros((b, h, s_q, d))
    for k0 in range(0, t, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new).to(torch.bfloat16).float()
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vf[..., k0:k0 + tile, :]
        m = m_new
    return (acc / l).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["bert_bias", "causal_kv_len", "kv_len0"])
def test_bf16_probabilities_fit_the_bf16_tolerance(case):
    """At BERT-base width (H12, D64, S=T=128) the kernel's bf16 rounding of
    P, emulated, stays within the card's unchanged bf16 tolerance of the
    JAX package's f32 chains: BERT's einsum chain with a bias that masks
    some keys (one row masked everywhere), ``attention_reference`` with
    causal and kv_len masks, and kv_len 0 (the mean of V)."""
    b, h, s, d = 3, 12, 128, 64
    rng = np.random.default_rng(len(case))
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (q, k, v))
    scale = 1.0 / d**0.5
    if case == "bert_bias":
        mask = (np.arange(s)[None, :] < np.array([s, 77, 0])[:, None]).astype(np.float32)
        bias = (1.0 - mask) * -1e9
        got = _flash_bf16_p(q, k, v, scale, bias=torch.from_numpy(bias))
        t = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731  [B, H, S, D] <-> [B, S, H, D]
        want = np.asarray(t(_bert_chain(t(jq), t(jk), t(jv),
                                        jnp.asarray(bias)[:, None, None, :])))
        plain = tfa.flash_attention_reference(q.float(), k.float(), v.float(), scale=scale,
                                              bias=torch.from_numpy(bias))
    else:
        kw = dict(causal=True, kv_len=100) if case == "causal_kv_len" else dict(kv_len=0)
        got = _flash_bf16_p(q, k, v, scale, **kw)
        want = np.asarray(_joracle(jq, jk, jv, scale=scale, **kw))
        plain = tfa.flash_attention_reference(q.float(), k.float(), v.float(), scale=scale,
                                              **kw)
    got = got.float().numpy()
    tol = dict(atol=FLASH_TOL_BF16, rtol=FLASH_TOL_BF16)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, plain.numpy(), **tol)


def _llama_chain(q, cache_k, cache_v, start, window):
    """The dense-cache attention lines of the JAX package's Llama
    ``_block`` (``models/llama.py:370``): q ``[B, S, NH, D]`` grouped
    ``[B, S, NKV, G, D]`` against the cache ``[B, T, NKV, D]`` cut to
    ``window``, f32 scores over sqrt(D), the -1e9 causal mask of
    ``forward``, the softmax cast to q's type; ``[B, S, NH, D]`` out."""
    b, s, nh, hd = q.shape
    nkv = cache_k.shape[2]
    qg = q.reshape(b, s, nkv, nh // nkv, hd)
    kk, vv = cache_k[:, :window], cache_v[:, :window]
    positions = start + jnp.arange(s)
    valid = jnp.arange(window)[None, :] <= positions[:, None]
    mask_bias = jnp.where(valid, 0.0, -1e9).astype(jnp.float32)[None, None]
    scores = jnp.einsum("bqngd,bknd->bngqk", qg, kk,
                        preferred_element_type=jnp.float32) / jnp.sqrt(jnp.float32(hd))
    probs = jax.nn.softmax(scores + mask_bias[:, None], axis=-1).astype(q.dtype)
    return jnp.einsum("bngqk,bknd->bqngd", probs, vv).reshape(b, s, nh, hd)


_jllama_chain = jax.jit(_llama_chain, static_argnums=(3, 4))


@pytest.mark.parametrize("nkv", [4, 2, 1], ids=["g1", "g2", "g4"])
@pytest.mark.parametrize("start,s", [(0, 11), (11, 5), (16, 1), (40, 24)])
def test_offset_and_grouped_heads_match_the_llama_block_in_f64(start, s, nkv):
    """A prompt chunk at cache offset ``start`` (q_offset) with NH4 query
    heads over NKV K/V heads (the tiny config's 4/2, and 4/4 and 4/1),
    read as views of a position-major [B, 64, NKV, D] cache, against the
    reference ``_block``'s chain in f64: f32 scores and softmax on both
    sides, so they agree to f32 rounding."""
    b, nh, hd, cap = 2, 4, 16, 64
    rng = np.random.default_rng(start * 10 + s + nkv)
    q = rng.standard_normal((b, s, nh, hd))
    ck, cv = rng.standard_normal((2, b, cap, nkv, hd))
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(_jllama_chain(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                        start, start + s))
    finally:
        jax.config.update("jax_enable_x64", False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, ck, cv))
    kk, vv = tk[:, :start + s].transpose(1, 2), tv[:, :start + s].transpose(1, 2)
    assert kk.data_ptr() == tk.data_ptr()  # views of the cache, not copies
    out = tfa.flash_attention(tq.transpose(1, 2), kk, vv, causal=True, kv_len=start + s,
                              scale=1.0 / hd**0.5, q_offset=start)
    got = out.transpose(1, 2)
    assert got.is_contiguous() and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("g", [2, 4])
def test_grouped_heads_match_pallas_with_repeated_kv(g):
    """At q_offset 0 the grouped call is the Pallas kernel (interpret
    mode) and ``attention_reference`` on K/V repeated to every query head:
    query head h reads K/V head h // G."""
    q, k, v = _qkv(b=2, h=4, s=48, d=16, seed=g)
    k, v = k[:, ::g], v[:, ::g]  # [B, 4 / G, T, D]
    rep = [jnp.asarray(np.repeat(x, g, axis=1)) for x in (k, v)]
    pallas = _jflash(jnp.asarray(q), *rep, causal=True, interpret=True, block_q=16,
                     block_k=16)
    oracle = _joracle(jnp.asarray(q), *rep, causal=True)
    out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True).numpy()
    np.testing.assert_allclose(out, np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **F32_TOL)


@pytest.mark.parametrize("start,nkv", [(0, 32), (384, 32), (448, 8), (400, 4)])
def test_bf16_probabilities_at_an_offset_fit_the_bf16_tolerance(start, nkv):
    """Llama-2-7B's head width (D128, H32) at a chunk offset and with
    grouped heads: the kernel's bf16 rounding of P, emulated with the
    offset diagonal, stays within the card's bf16 tolerance of the
    reference ``_block`` chain in f32 and of the plain version."""
    b, h, s, d = 1, 32, 64, 128
    t = start + s
    rng = np.random.default_rng(start + nkv)
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    ck, cv = (torch.from_numpy(x) for x in rng.standard_normal((2, b, t, nkv, d))
              .astype(np.float32))
    q, ck, cv = (x.to(torch.bfloat16) for x in (q, ck, cv))
    want = np.asarray(_jllama_chain(*(jnp.asarray(x.float().numpy()) for x in (q, ck, cv)),
                                    start, t))
    views = (q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2))
    kw = dict(causal=True, kv_len=t, q_offset=start)
    got = _flash_bf16_p(*views, 1.0 / d**0.5, **kw).transpose(1, 2).float().numpy()
    plain = tfa.flash_attention_reference(*(x.float() for x in views), scale=1.0 / d**0.5,
                                          **kw).transpose(1, 2).numpy()
    tol = dict(atol=FLASH_TOL_BF16, rtol=FLASH_TOL_BF16)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, plain, **tol)


def test_offset_past_the_keys_and_ungrouped_heads_raise():
    q, k, v = (torch.from_numpy(x) for x in _qkv(b=1, h=4, s=8, t=16))
    for fn in (tfa.flash_attention, tfa.flash_attention_reference):
        with pytest.raises(ValueError, match="outside"):
            fn(q, k, v, causal=True, q_offset=9)  # 9 + 8 > 16
        with pytest.raises(ValueError, match="outside"):
            fn(q, k, v, causal=True, q_offset=-1)
        with pytest.raises(ValueError, match="group"):
            fn(q, k[:, :3], v[:, :3])
    # the last chunk that fits, and S > T at offset 0 (cross attention)
    assert tfa.flash_attention(q, k, v, causal=True, q_offset=8).shape == q.shape
    assert tfa.flash_attention(q, k[:, :, :5], v[:, :, :5]).shape == q.shape


def test_self_attention_block_matches_jax_in_f64():
    """The whole attention block (projections, flash attention with the
    bias, output projection) in f64: f32 scores and softmax on both sides,
    so the two agree to f32 rounding."""
    jax.config.update("jax_enable_x64", True)
    try:
        cfg = JB.BertConfig.tiny()
        jp = JB.init(jax.random.key(1), cfg)
        jp = jax.tree.map(lambda x: x.astype(jnp.float64), jp)
        p = jp["layers"][0]["attn"]
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 24, cfg.hidden_size))
        mask = np.ones((2, 24), np.int32)
        mask[0, 17:] = 0
        jbias = (1.0 - jnp.asarray(mask)[:, None, None, :].astype(jnp.float32)) * -1e9
        want = np.asarray(jax.jit(JB._self_attention, static_argnums=(3,))(
            p, jnp.asarray(x), jbias, cfg))
    finally:
        jax.config.update("jax_enable_x64", False)
    tp = convert.from_jax_numpy(jax.device_get(p))
    tbias = (1.0 - torch.from_numpy(mask).float()) * -1e9
    got = TB._self_attention(tp, torch.from_numpy(x), tbias, TB.BertConfig.tiny()).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_unsupported_device_raises_instead_of_falling_back():
    q, k, v = (torch.from_numpy(x).to("meta") for x in _qkv(s=8))
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q, k, v)


# -- the ragged instance (packed prefill): plain version and kernel algebra --------


def _ragged_inputs(B, C, H, NKV, NS, W, offsets, slots, quant, seed, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, D))
    kc, vc = rng.standard_normal((2, B, C, NKV, D))
    kc[..., 0] = 6.0 * np.sign(kc[..., 0] + 1e-9)  # the round-trip clips these at +-127
    shape = (NS, NKV, W, D)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks, vs = (rng.random((2,) + shape[:-1] + (1,)) * 0.02 + 1e-3).astype(np.float32)
    else:
        k, v = rng.standard_normal((2,) + shape)
        ks = vs = None
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, kc=kc, vc=vc,
                slots=np.asarray(slots, np.int32), offsets=np.asarray(offsets, np.int32))


def _port_ragged(a, fn=tfa.flash_attention_ragged):
    t = {n: None if x is None else torch.from_numpy(np.ascontiguousarray(x))
         for n, x in a.items()}
    rt = None
    if t["ks"] is not None:
        rt = (*T._quant_kv(t["kc"]), *T._quant_kv(t["vc"]))
    return fn(t["q"], t["k"], t["v"], t["slots"], t["offsets"], t["kc"], t["vc"], t["ks"],
              t["vs"], rt)


def _jax_ragged_lines(q, k, v, slots, offsets, kc, vc, ks=None, vs=None):
    """JAX ``_block_verify_deferred``'s attention lines (``models/llama.py``
    1072-1160) on cache rows gathered by ``slots`` under the strict mask
    ``key < offsets[b]``: q ``[B, C, H, D]``, the window ``[NS, NKV, T,
    D]`` (int8 with scales ``[NS, NKV, T, 1]``), the chunk ``[B, C, NKV,
    D]``; ``[B, C, H, D]`` out.  Run eagerly, as the reference's quantizer
    divides by 127 there."""
    b, s, h, hd = q.shape
    nkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, nkv, h // nkv, hd)
    k, v = k[slots], v[slots]
    quant = ks is not None
    sq = jnp.sqrt(jnp.float32(hd))
    scores = jnp.einsum("bqngd,bnkd->bngqk", qg, k.astype(q.dtype),
                        preferred_element_type=jnp.float32) / sq
    if quant:
        scores = scores * ks[slots][..., 0][:, :, None, None, :]
    valid = jnp.arange(t)[None, :] < offsets[:, None]
    scores = scores + jnp.where(valid, 0.0, -1e9).astype(jnp.float32)[:, None, None, None]
    score_self = jnp.einsum("bqngd,bjnd->bngqj", qg, kc, preferred_element_type=jnp.float32) / sq
    eye = jnp.eye(s, dtype=bool)[None, None, None]
    if quant:
        k8c, kscc = J._quant_kv(kc)
        score_rt = jnp.einsum("bqngd,bjnd->bngqj", qg, k8c.astype(q.dtype),
                              preferred_element_type=jnp.float32) / sq
        score_rt = score_rt * jnp.moveaxis(kscc[..., 0], 1, 2)[:, :, None, None, :]
        score_chunk = jnp.where(eye, score_self, score_rt)
    else:
        score_chunk = score_self
    qpos = jnp.arange(s)
    chunk_bias = jnp.where(qpos[:, None] >= qpos[None, :], 0.0, -1e9).astype(jnp.float32)
    probs = jax.nn.softmax(jnp.concatenate([scores, score_chunk + chunk_bias], -1), axis=-1)
    pc, pk = probs[..., :-s], probs[..., -s:]
    if quant:
        pc = (pc * vs[slots][..., 0][:, :, None, None, :]).astype(q.dtype)
        ctx = jnp.einsum("bngqk,bnkd->bqngd", pc, v.astype(q.dtype))
        v8c, vscc = J._quant_kv(vc)
        eyef = eye.astype(probs.dtype)
        ctx = ctx + jnp.einsum("bngqj,bjnd->bqngd", (pk * eyef).astype(q.dtype), vc)
        below = pk * (1.0 - eyef) * jnp.moveaxis(vscc[..., 0], 1, 2)[:, :, None, None, :]
        ctx = ctx + jnp.einsum("bngqj,bjnd->bqngd", below.astype(q.dtype), v8c.astype(q.dtype))
    else:
        ctx = jnp.einsum("bngqk,bnkd->bqngd", pc.astype(q.dtype), v)
        ctx = ctx + jnp.einsum("bngqj,bjnd->bqngd", pk.astype(q.dtype), vc)
    return ctx.reshape(b, s, h, hd)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("H,NKV", [(4, 4), (8, 2)], ids=["G1", "G4"])
def test_ragged_plain_matches_the_reference_lines(quant, H, NKV):
    """Three rows on permuted slots of a 5-row cache, offsets 0, 37 and 64
    (a full window), a 12-position chunk with rows near the int8 clip:
    f32 scores and softmax on both sides, so 1e-5."""
    a = _ragged_inputs(3, 12, H, NKV, 5, 64, [0, 37, 64 - 1], [4, 1, 2], quant, seed=H)
    jax.config.update("jax_enable_x64", True)
    try:
        want = _jax_ragged_lines(*(None if a[n] is None else jnp.asarray(a[n]) for n in
                                   ("q", "k", "v", "slots", "offsets", "kc", "vc", "ks", "vs")))
        want = np.asarray(want)
    finally:
        jax.config.update("jax_enable_x64", False)
    got = _port_ragged(a).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _ragged_piece(qq, segs, pos, rnd):
    """One warp's online softmax over a piece in f64 torch, as
    ``csrc/chunk_attention.cuh`` runs it for the ragged kernel: queries
    ``qq [R, D]`` (pre-scaled) at chunk positions ``pos [R]`` against
    segments ``(K, V, kscale, vscale, chunk, diag)`` in 16-key slices
    (running max, rescale); ``diag``: the exact diagonal's scores ``[R]``
    and V rows ``[R, D]`` (int8 chunk), whose p stays out of P . V; ``rnd``
    rounds p (times the value scale) as the MMA takes it.  Returns ``(m,
    l, acc)``."""
    m = torch.full((len(pos),), -1e30, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros((len(pos), qq.shape[1]), dtype=torch.float64)
    for k, v, ksc, vsc, chunk, diag in segs:
        for k0 in range(0, k.shape[0], 16):
            k1 = min(k.shape[0], k0 + 16)
            key = torch.arange(k0, k1)
            x = (qq @ k[k0:k1].T) * ksc[None, k0:k1]
            on_diag = (key[None, :] == pos[:, None]) & chunk & (diag is not None)
            if diag is not None and chunk:
                x = torch.where(on_diag, diag[0][:, None], x)
            if chunk:
                x = torch.where(key[None, :] <= pos[:, None], x, -torch.inf)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(x - m_new[:, None])
            l = l * corr + p.sum(-1)
            pv = rnd(torch.where(on_diag, 0.0, p * vsc[None, k0:k1]))
            acc = acc * corr[:, None] + pv @ v[k0:k1]
            if diag is not None and chunk:
                acc = acc + torch.where(on_diag, p, 0.0).sum(-1)[:, None] * diag[1]
            m = m_new
    return m, l, acc


def _ragged_emulation(a, round_p=False, plan=None):
    """The CUDA kernel's algebra in f64 torch: the plan of
    ``tfa.ragged_plan`` (or ``plan``); for each (row, head), query tiles
    of ``plan.rows`` rows in row tiles of 16; the pieces of
    ``tfa.ragged_pieces`` (window keys of cache row ``slots[b]``, none for
    a parked row; the last piece also the chunk keys up to each row's
    diagonal), each one online softmax over 16-key slices; on the int8
    cache the key scale times the score and the value scale times p
    (rounded to bf16 with ``round_p``, as the MMA takes it), the row sum
    of the unrounded p, the exact q_j . k_j in place of the diagonal's
    round-trip score, p_jj kept out of P . V and p_jj * v_j added from the
    exact V row; a row of several pieces joins their (m, l, acc) by the
    max-rescale, as the merge kernel does."""
    t = {n: None if x is None else torch.from_numpy(np.asarray(x)) for n, x in a.items()}
    q, kc, vc = (t[n].to(torch.float64) for n in ("q", "kc", "vc"))
    b, c, h, d = q.shape
    ns, nkv, w = t["k"].shape[:3]
    plan = plan or tfa.ragged_plan(c, w)
    quant = t["ks"] is not None
    ones_c = torch.ones(c, dtype=torch.float64)
    if quant:
        k8c, ksc = (x.to(torch.float64) for x in T._quant_kv(t["kc"]))
        v8c, vsc = (x.to(torch.float64) for x in T._quant_kv(t["vc"]))
    rnd = (lambda x: x.to(torch.bfloat16).to(torch.float64)) if round_p else (lambda x: x)
    out = torch.zeros((b, c, h, d), dtype=torch.float64)
    for bi in range(b):
        slot, off = int(t["slots"][bi]), int(t["offsets"][bi])
        pieces = tfa.ragged_pieces(tfa.ragged_window(slot, off, ns, w), plan)
        for hi_ in range(h):
            hk = hi_ // (h // nkv)
            if quant:
                chunk = (k8c[bi, :, hk], v8c[bi, :, hk], ksc[bi, :, hk, 0], vsc[bi, :, hk, 0])
            else:
                chunk = (kc[bi, :, hk], vc[bi, :, hk], ones_c, ones_c)
            for r0 in range(0, c, 16):  # a row tile: one warp of its query tile's block
                rows = torch.arange(r0, min(c, r0 + 16))
                qq = q[bi, rows, hi_] / d ** 0.5
                diag = ((qq * kc[bi, rows, hk]).sum(-1), vc[bi, rows, hk]) if quant else None
                parts = []
                for lo, hi, with_chunk in pieces:
                    segs = []
                    if hi > lo:
                        kw, vw = (t[n][slot, hk, lo:hi].to(torch.float64) for n in ("k", "v"))
                        kscl, vscl = ((t[n][slot, hk, lo:hi, 0].double() for n in ("ks", "vs"))
                                      if quant else (torch.ones(hi - lo, dtype=torch.float64),) * 2)
                        segs.append((kw, vw, kscl, vscl, False, None))
                    if with_chunk:
                        segs.append((*chunk, True, diag))
                    parts.append(_ragged_piece(qq, segs, rows, rnd))
                mx = torch.stack([p[0] for p in parts]).amax(0)
                f = [torch.exp(p[0] - mx) for p in parts]
                l = sum(p[1] * fi for p, fi in zip(parts, f))
                acc = sum(p[2] * fi[:, None] for p, fi in zip(parts, f))
                out[bi, rows, hi_] = acc / l[:, None]
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("C,W,offsets", [(100, 200, [0, 64, 199, 200]),
                                         (130, 256, [255, 1, 128, 70])],
                         ids=["parked", "ragged"])
def test_kernel_tiles_and_diagonal_match_the_plain_version(quant, C, W, offsets):
    """The kernel's algebra (query tiles of 64 rows, window pieces of the
    default plan, of one tile, and of 128 keys, windows ending off
    the tile grid, a parked row at offset == capacity, chunks of 100 and
    130 spanning several query tiles) equals the plain version: 1e-6 in
    f64; with P rounded to bf16 as the MMA takes it, within 2e-2 (the bf16
    tolerance of the smoke's checks)."""
    a = _ragged_inputs(4, C, 4, 2, 6, W, offsets, [5, 0, 3, 1], quant, seed=C + W)
    want = _port_ragged(a).numpy()
    for plan in (None, tfa.ragged_plan(C, W, piece_len=64), tfa.ragged_plan(C, W, piece_len=128)):
        np.testing.assert_allclose(_ragged_emulation(a, plan=plan).numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_ragged_emulation(a, round_p=True, plan=plan).numpy(), want,
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("piece_len", [64, 1024])
def test_ragged_emulation_matches_the_reference_lines(quant, piece_len):
    """The kernel's f64 emulation (a window split over 64-key pieces, or
    held whole) against the JAX ``_block_verify_deferred`` lines on the
    gathered rows: f32 scores and softmax there, so 1e-5."""
    a = _ragged_inputs(3, 12, 8, 2, 5, 200, [0, 137, 199], [4, 1, 2], quant, seed=piece_len)
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(_jax_ragged_lines(*(None if a[n] is None else jnp.asarray(a[n]) for n in
                                              ("q", "k", "v", "slots", "offsets", "kc", "vc",
                                               "ks", "vs"))))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = _ragged_emulation(a, plan=tfa.ragged_plan(12, 200, piece_len=piece_len)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,t", [(256, 4096), (100, 4096), (12, 64), (1, 1), (130, 257),
                                 (256, 2048)])
@pytest.mark.parametrize("piece_len", [None, 64, 512, 8192])
def test_ragged_plan_covers_every_window_key_once(c, t, piece_len):
    """From C and T alone (no offset read on the host): query tiles cover
    the chunk; for every offset a row can hold (0 .. T - 1, and T, a
    parked row), its pieces cover the window keys exactly once, all within
    the grid's pieces, and only the last attends the chunk; a parked row,
    an empty window and an out-of-range slot run the chunk alone."""
    plan = tfa.ragged_plan(c, t, piece_len)
    assert plan == tfa.ragged_plan(c, t, piece_len)
    assert plan.rows == tfa.RAGGED_ROWS
    assert (plan.query_tiles - 1) * plan.rows < c <= plan.query_tiles * plan.rows
    assert plan.piece_len % tfa.RAGGED_TILE == 0
    assert plan.pieces * plan.piece_len >= t - 1
    for off in sorted({0, 1, 63, 64, 65, t // 2, t - 2, t - 1, t} & set(range(t + 1))):
        win = tfa.ragged_window(0, off, 1, t)
        assert win == (off if 0 < off < t else 0)
        pieces = tfa.ragged_pieces(win, plan)
        assert 1 <= len(pieces) <= plan.pieces
        assert [k for lo, hi, _ in pieces for k in range(lo, hi)] == list(range(win))
        assert [ch for _, _, ch in pieces] == [False] * (len(pieces) - 1) + [True]
    for slot in (-1, 1, 7):
        assert tfa.ragged_window(slot, t // 2, 1, t) == 0
        assert tfa.ragged_pieces(0, plan) == [(0, 0, True)]


def test_ragged_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper checks before it launches: a meta tensor is
    an unsupported device, and it never falls back to the plain version."""
    a = _ragged_inputs(1, 4, 4, 4, 2, 16, [3], [1], True, seed=0)
    t = {n: torch.from_numpy(np.ascontiguousarray(x)).to("meta") for n, x in a.items()}
    rt = tuple(torch.empty(s, dtype=dt, device="meta")
               for s, dt in (((1, 4, 4, 16), torch.int8), ((1, 4, 4, 1), torch.float32)) * 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_ragged(t["q"], t["k"], t["v"], t["slots"], t["offsets"], t["kc"],
                                   t["vc"], t["ks"], t["vs"], rt)
    assert tfa.ragged_launches == 0
