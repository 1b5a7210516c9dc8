"""Port Llama against the JAX package's Llama, in float64 on the CPU.

Weights are made once by the JAX package's ``init`` and carried across by
``convert.from_jax_numpy``, so both sides run the same tree.  JAX runs in
f64 behind a module fixture (restored after).  Both packages round the
same products to f32 (``preferred_element_type``), so logits agree to
f32 rounding; the tolerance is stated per check.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch import (
    convert,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    quantization as TQ,
)
from tpumlops.models import llama as J
from tpumlops.models import quantization as JQ

# Logits are f32 on both sides; f32 rounding of differently ordered sums.
LOGIT_TOL = dict(rtol=2e-5, atol=2e-6)

CONFIGS = {
    "gqa": dict(num_heads=4, num_kv_heads=2),
    "mha": dict(num_heads=4, num_kv_heads=4),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads; one thread keeps
    this module from crowding tests that run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# Jitted reference entry points: one compile per shape instead of one per
# primitive (the reference's own engine runs them jitted too).
_jprefill = jax.jit(J.prefill, static_argnums=(2,), static_argnames=("dtype",))
_jforward = jax.jit(J.forward, static_argnums=(3,), static_argnames=("dtype",))
_jinsert = jax.jit(J.insert_sequence)


def _jdecode(impl):
    """decode_ragged jitted under one ``_DECODE_ATTN`` choice (read at
    trace time, so each choice gets its own jit)."""

    def run(*args, **kw):
        prev = J._DECODE_ATTN
        try:
            J._DECODE_ATTN = impl
            return J.decode_ragged(*args, **kw)
        finally:
            J._DECODE_ATTN = prev

    return jax.jit(run, static_argnums=(3,), static_argnames=("dtype", "window"))


@functools.lru_cache(maxsize=None)
def _models(kind, quant=False, seed=0):
    jcfg = J.LlamaConfig.tiny(max_seq=64, **CONFIGS[kind])
    tcfg = T.LlamaConfig.tiny(max_seq=64, **CONFIGS[kind])
    jp = J.init(jax.random.key(seed), jcfg, dtype=jnp.float64)
    if quant:
        jp = JQ.quantize_llama(jp)
    tp = convert.from_jax_numpy(jax.device_get(jp))
    return jcfg, tcfg, jp, tp


def _ids(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(np.int32)


def test_converter_carries_plain_int8_and_bf16_leaves():
    jcfg = J.LlamaConfig.tiny()
    jp = J.init(jax.random.key(3), jcfg, dtype=jnp.float32)
    jq = JQ.quantize_llama(jp)
    tree = convert.from_jax_numpy(jax.device_get(jq), dtype=torch.float64)
    assert tree["embed"].dtype == torch.float64
    np.testing.assert_array_equal(tree["embed"].numpy(), np.asarray(jq["embed"], np.float64))
    q = tree["layers"]["gate"]
    assert q["q8"].dtype == torch.int8 and q["scale"].dtype == torch.float32
    np.testing.assert_array_equal(q["q8"].numpy(), np.asarray(jq["layers"]["gate"]["q8"]))
    np.testing.assert_array_equal(q["scale"].numpy(), np.asarray(jq["layers"]["gate"]["scale"]))
    # bf16: as ml_dtypes arrays and as the raw |V2 bytes np.load returns
    b16 = np.asarray(jp["final_norm"].astype(jnp.bfloat16) * 1.5)
    for arr in (b16, b16.view(np.dtype("V2"))):
        t = convert.to_tensor(arr)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), b16.astype(np.float32))
    back = convert.to_numpy(convert.to_tensor(b16))
    assert back.dtype == np.dtype("V2") and back.tobytes() == b16.tobytes()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_prefill_and_chunked_forward_match(kind, quant):
    jcfg, tcfg, jp, tp = _models(kind, quant)
    ids = _ids(11, seed=1)
    jl, jc = _jprefill(jp, jnp.asarray(ids), jcfg, dtype=jnp.float64)
    tl, tc = T.prefill(tp, torch.from_numpy(ids).long(), tcfg, dtype=torch.float64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-6, atol=1e-7)
    assert tc.length == int(jc.length) == 11
    # a second chunk against the cached prefix (chunked prefill)
    ids2 = _ids(5, seed=2)
    jl2, jc2 = _jforward(jp, jnp.asarray(ids2), jc, jcfg, dtype=jnp.float64)
    tl2, tc2 = T.forward(tp, torch.from_numpy(ids2).long(), tc, tcfg, dtype=torch.float64)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **LOGIT_TOL)
    np.testing.assert_allclose(tc2.v.numpy(), np.asarray(jc2.v), rtol=1e-6, atol=1e-7)
    assert tc2.length == int(jc2.length) == 16


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_dense_block_runs_the_flash_wrapper(kind, monkeypatch):
    """Prefill and a chunk on the dense cache go through
    ``ops.flash_attention`` once a layer (counted by a wrapper around it),
    at the chunk's cache offset, over the written prefix only, grouped
    K/V heads as views of the cache; the argmax tokens equal JAX
    ``forward``'s.  The int8 pairs of ``_block`` keep their chain."""
    jcfg, tcfg, jp, tp = _models(kind)
    calls = []
    real = T.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["q_offset"], kw["kv_len"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(T, "flash_attention", counting)
    nh, nkv, hd, L = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim, tcfg.num_layers
    ids, ids2 = _ids(11, seed=5), _ids(5, seed=6)
    jl, jc = _jprefill(jp, jnp.asarray(ids), jcfg, dtype=jnp.float64)
    tl, tc = T.prefill(tp, torch.from_numpy(ids).long(), tcfg, dtype=torch.float64)
    assert calls == [((1, nh, 11, hd), (1, nkv, 11, hd), 0, 11)] * L
    jl2, _ = _jforward(jp, jnp.asarray(ids2), jc, jcfg, dtype=jnp.float64)
    tl2, _ = T.forward(tp, torch.from_numpy(ids2).long(), tc, tcfg, dtype=torch.float64)
    assert calls[L:] == [((1, nh, 5, hd), (1, nkv, 16, hd), 11, 16)] * L
    for t_, j_ in ((tl, jl), (tl2, jl2)):
        assert t_.argmax(-1).tolist() == np.asarray(jnp.argmax(j_, -1)).tolist()
    # the int8 position-major pairs run the reference's chain, not the kernel
    shape = (L, 1, tcfg.max_seq, nkv, hd)
    q8 = T.KVCache((torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:-1] + (1,))),
                   (torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:-1] + (1,))), 0)
    T.forward(tp, torch.from_numpy(ids).long(), q8, tcfg, dtype=torch.float64)
    assert len(calls) == 2 * L


def _ragged_pair(jcfg, tcfg, jp, tp, quant):
    """Both caches with slots 0 and 2 prefilled (lengths 7 and 16), slot 1
    empty."""
    if quant:
        jc = J.QuantRaggedKVCache.create(jcfg, 3)
        tc = T.QuantRaggedKVCache.create(tcfg, 3)
    else:
        jc = J.RaggedKVCache.create(jcfg, 3, jnp.float64)
        tc = T.RaggedKVCache.create(tcfg, 3, torch.float64)
    for slot, n in ((0, 7), (2, 16)):
        ids = np.zeros((1, 16), np.int32)
        ids[0, :n] = _ids(n, seed=10 + slot)[0]
        _, jseq = _jprefill(jp, jnp.asarray(ids), jcfg, dtype=jnp.float64)
        _, tseq = T.prefill(tp, torch.from_numpy(ids).long(), tcfg, dtype=torch.float64)
        jc = _jinsert(jc, jseq, jnp.int32(slot), jnp.int32(n))
        tc = T.insert_sequence(tc, tseq, slot, n)
    return jc, tc


def _cache_arrays(c):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy() for x in c]


@pytest.mark.parametrize("cache,impl", [("dense", "xla"), ("int8", "xla"), ("int8", "pallas")])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_decode_ragged_matches(kind, cache, impl):
    quant = cache == "int8"
    jcfg, tcfg, jp, tp = _models(kind, quant=quant)
    jc, tc = _ragged_pair(jcfg, tcfg, jp, tp, quant)
    for name, jx, tx in zip(jc._fields, _cache_arrays(jc), _cache_arrays(tc)):
        np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-7, err_msg=f"insert {name}")
    active = np.array([True, False, True])
    toks = np.array([[3], [5], [7]], np.int32)
    jdecode = _jdecode(impl)
    for step, window in enumerate((24, 32)):
        jl, jc = jdecode(jp, jnp.asarray(toks), jc, jcfg, jnp.asarray(active),
                         dtype=jnp.float64, window=window)
        tl, tc = T.decode_ragged(tp, torch.from_numpy(toks).long(), tc, tcfg,
                                 torch.from_numpy(active), dtype=torch.float64,
                                 window=window)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"step {step}")
        toks = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert tc.lengths.tolist() == [9, 0, 18]
    for name, jx, tx in zip(jc._fields, _cache_arrays(jc), _cache_arrays(tc)):
        if jx.dtype == np.int8:
            # an int8 code may sit on a rounding boundary: at most one step
            assert np.abs(tx.astype(int) - jx.astype(int)).max() <= 1, name
        else:
            np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-7, err_msg=name)


def test_commit_rows_drops_write_at_capacity():
    L, B, H, Tn, D = 2, 3, 2, 4, 3
    buf = torch.zeros((L, B, H, Tn, D), dtype=torch.float32)
    vals = torch.ones((L, B, H, D), dtype=torch.float32)
    lengths = torch.tensor([1, Tn, 3], dtype=torch.int32)  # row 1 is AT capacity
    T._commit_rows(buf, vals, lengths)
    assert torch.all(buf[:, 0, :, 1] == 1.0)
    assert torch.all(buf[:, 2, :, 3] == 1.0)
    assert torch.all(buf[:, 1] == 0.0)  # dropped, never clamped onto position 3
    # the same scatter as the reference on random data, parked rows included
    rng = np.random.default_rng(0)
    b0 = rng.standard_normal((L, 4, H, Tn, 1)).astype(np.float32)
    v0 = rng.standard_normal((L, 4, H, 1)).astype(np.float32)
    ln = np.array([0, Tn, 2, Tn], np.int32)
    ref = J._commit_rows(jnp.asarray(b0), jnp.asarray(v0), jnp.asarray(ln))
    got = torch.from_numpy(b0.copy())
    T._commit_rows(got, torch.from_numpy(v0), torch.from_numpy(ln))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_decode_attends_itself_at_exact_window_boundary(quant):
    """A row whose position EQUALS the window still attends its own token
    (through the self-term); the oracle is a window covering everything."""
    jcfg, tcfg, jp, tp = _models("gqa", seed=2)
    W = 16

    def run(window):
        c = (T.QuantRaggedKVCache.create(tcfg, 1) if quant
             else T.RaggedKVCache.create(tcfg, 1, torch.float64))
        for i in range(W):
            tok = torch.tensor([[(7 * i) % tcfg.vocab_size]])
            _, c = T.decode_ragged(tp, tok, c, tcfg, dtype=torch.float64, window=64)
        logits, _ = T.decode_ragged(tp, torch.tensor([[5]]), c, tcfg,
                                    dtype=torch.float64, window=window)
        return logits[0, -1].numpy()

    np.testing.assert_allclose(run(W), run(64), rtol=2e-6, atol=2e-6)


def test_quantize_tensor_is_bit_identical_including_ties():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32) * 0.05
    # Column 0 of each layer: amax 127 * 2^-7, so the scale is exactly 2^-7
    # and (k + 0.5) * 2^-7 lands exactly on a rounding tie.
    ties = (np.arange(-20, 19) + 0.5).astype(np.float32) * np.float32(2.0 ** -7)
    w[:, :39, 0] = ties
    w[:, 39, 0] = 127 * 2.0 ** -7
    for axis in (-2, -1):
        jq = JQ.quantize_tensor(jnp.asarray(w), axis=axis)
        tq = TQ.quantize_tensor(torch.from_numpy(w), axis=axis)
        np.testing.assert_array_equal(tq["q8"].numpy(), np.asarray(jq["q8"]))
        np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    q0 = TQ.quantize_tensor(torch.from_numpy(w))["q8"].numpy()[0, :39, 0]
    np.testing.assert_array_equal(q0, np.rint(np.arange(-20, 19) + 0.5))  # half to even
    deq = TQ.dequantize_tensor(TQ.quantize_tensor(torch.from_numpy(w)), torch.float32)
    jdeq = JQ.dequantize_tensor(JQ.quantize_tensor(jnp.asarray(w)), jnp.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


def test_quantize_llama_matches_reference_tree():
    """int8 codes are identical.  The reference quantizes under jit, where
    XLA turns the division by 127 into a multiply by 1/127; the port
    divides, as the eager reference does, so a scale may differ by one
    f32 ulp."""
    _, _, jp, tp = _models("gqa")
    jq, tq = JQ.quantize_llama(jp), TQ.quantize_llama(tp)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        np.testing.assert_array_equal(tq["layers"][name]["q8"].numpy(),
                                      np.asarray(jq["layers"][name]["q8"]))
        np.testing.assert_allclose(tq["layers"][name]["scale"].numpy(),
                                   np.asarray(jq["layers"][name]["scale"]), rtol=1.2e-7)
    np.testing.assert_array_equal(tq["lm_head"]["q8"].numpy(), np.asarray(jq["lm_head"]["q8"]))
    assert TQ.is_quantized(tq["lm_head"]) and not TQ.is_quantized(tq["embed"])


def test_rope_tables_and_generate_greedy_match():
    jcfg, tcfg, jp, tp = _models("mha", seed=4)
    pos = np.arange(40)
    jc, js = J.rope_cos_sin(jnp.asarray(pos), jcfg)
    tc, ts = T.rope_cos_sin(torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
    ids = _ids(6, seed=9)
    ref = J.generate_greedy(jp, jnp.asarray(ids), 8, jcfg, dtype=jnp.float64)
    out = T.generate_greedy(tp, torch.from_numpy(ids).long(), 8, tcfg, dtype=torch.float64)
    assert out.tolist() == np.asarray(ref).tolist()
    with pytest.raises(ValueError, match="capacity"):
        T.generate_greedy(tp, torch.zeros((1, 60), dtype=torch.long), 8, tcfg)


def test_forward_on_an_int8_position_major_cache_matches():
    """``_block``'s int8-cache branch: a KVCache whose k/v are (int8 values,
    f32 scales) pairs, written chunk by chunk and read with folded scales."""
    jcfg, tcfg, jp, tp = _models("gqa", quant=True)
    shape = (jcfg.num_layers, 1, jcfg.max_seq, jcfg.num_kv_heads, jcfg.head_dim)
    sshape = shape[:-1] + (1,)

    def jcache():
        z8, zs = jnp.zeros(shape, jnp.int8), jnp.zeros(sshape, jnp.float32)
        return J.KVCache((z8, zs), (z8, zs), jnp.zeros((), jnp.int32))

    def tcache():
        return T.KVCache((torch.zeros(shape, dtype=torch.int8), torch.zeros(sshape)),
                         (torch.zeros(shape, dtype=torch.int8), torch.zeros(sshape)), 0)

    jc, tc = jcache(), tcache()
    for n, seed in ((9, 21), (4, 22)):
        ids = _ids(n, seed)
        jl, jc = _jforward(jp, jnp.asarray(ids), jc, jcfg, dtype=jnp.float64)
        tl, tc = T.forward(tp, torch.from_numpy(ids).long(), tc, tcfg, dtype=torch.float64)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))
    assert tc.length == 13
