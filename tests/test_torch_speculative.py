"""The port's self-speculative decoding against the JAX package, in float64
on the CPU.

- Host side: ``propose_ngram``, ``draft_chain``, ``pad_to_chain`` and
  ``DraftState`` against the JAX functions on the cases of
  ``tests/test_speculative.py``.
- The verify attention's plain versions (both instances) against a JAX
  transcript of ``_block_verify_deferred``'s attention lines
  (``models/llama.py:1083-1152``) and the port's ``_block_verify_deferred``
  against the JAX one, int8 round-trip rows included; a torch emulation of
  the bf16 CUDA kernel's plan (row groups whose warps split the 16-key
  slices, window pieces with f32 partials, the chunk and its exact
  diagonal in the last piece, the max-rescale joins, p as a hi/lo bf16
  pair) against the plain version and the JAX lines, and the plan's
  coverage properties.
- ``verify_ragged`` (dense and int8) against JAX ``verify_ragged``: logits
  and the committed cache, with an inactive row and a row past capacity.
- The port's engine with speculation against JAX ``generate_greedy``
  token for token (slot churn, an oracle drafter, EOS inside an accepted
  run, adaptive collapse, speculation with the prefix cache, a join and a
  leave mid-stream), a sampling slot against the plain engine and the JAX
  engine under its seed, int8kv against the JAX int8 path, and a disabled
  config against the plain dispatch.

Logits are f32 on both sides (the reference's ``preferred_element_type``),
so they agree to f32 rounding (``LOGIT_TOL``, as ``test_torch_llama.py``);
tokens agree exactly.
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
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    decode_attention as tda,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    prefix_cache as tpc,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    speculative as tsp,
)
from tpumlops.models import llama as J
from tpumlops.models.quantization import quantize_llama as j_quantize_llama
from tpumlops.server import speculative as jsp
from tpumlops.server.generation import GenerationEngine as JaxEngine

LOGIT_TOL = dict(rtol=2e-5, atol=2e-6)
CONFIGS = {"gqa": dict(num_heads=4, num_kv_heads=2), "mha": dict(num_heads=4, num_kv_heads=4)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _models(kind="gqa", quant=False):
    jcfg = J.LlamaConfig.tiny(max_seq=64, **CONFIGS[kind])
    tcfg = T.LlamaConfig.tiny(max_seq=64, **CONFIGS[kind])
    jp = J.init(jax.random.key(0), jcfg, dtype=jnp.float64)
    if quant:
        jp = j_quantize_llama(jp)
    return jcfg, tcfg, jp, convert.from_jax_numpy(jax.device_get(jp))


_jgen = jax.jit(J.generate_greedy, static_argnums=(2, 3), static_argnames=("dtype",))


@functools.lru_cache(maxsize=None)
def _ref(prompt: tuple, n: int) -> list:
    jcfg, _, jp, _ = _models()
    out = _jgen(jp, jnp.asarray([prompt], jnp.int32), n, jcfg, dtype=jnp.float64)
    return np.asarray(out)[0].tolist()


# -- host side -----------------------------------------------------------------


@pytest.mark.parametrize("ctx,k,lo,hi", [
    ([1, 2, 7, 8, 5, 6, 9, 7, 8], 3, 1, 4), ([1, 2, 7, 8, 5, 6, 9, 7, 8], 2, 1, 4),
    ([3, 4, 10, 5, 3, 4, 20, 5, 3, 4], 1, 1, 4), ([5, 3, 4, 30, 1, 3, 4, 40, 5, 3, 4], 1, 1, 4),
    ([1, 2, 3, 4, 5], 4, 1, 4), ([7, 1, 7], 2, 2, 4), ([7, 1, 7], 2, 1, 4), ([], 4, 1, 4),
    ([5], 4, 1, 4), ([5, 5], 0, 1, 4), ([11, 12, 13] * 4, 4, 1, 4),
    ([11, 12, 13] * 4, 7, 1, 4), ([11, 12, 13] * 4 + [11], 4, 1, 4), ([9, 9, 9], 3, 1, 4),
    (list(range(3000)) + [5, 6], 4, 1, 4), (list(range(2100)) + [1, 2], 3, 2, 2),
])
def test_propose_ngram_matches_the_reference(ctx, k, lo, hi):
    assert tsp.propose_ngram(ctx, k, lo, hi) == jsp.propose_ngram(ctx, k, lo, hi)


@pytest.mark.parametrize("k", [1, 2, 4, 5, 8, 64])
def test_draft_chain_and_padding_match_the_reference(k):
    chain = tsp.draft_chain(k)
    assert chain == jsp.draft_chain(k)
    for want in range(0, k + 2):
        assert tsp.pad_to_chain(want, chain) == jsp.pad_to_chain(want, chain)
    with pytest.raises(ValueError):
        tsp.draft_chain(0)


@pytest.mark.parametrize("adaptive", [True, False])
def test_draft_state_follows_the_reference_step_for_step(adaptive):
    """The same feedback sequence (collapse, re-probe, regrowth) gives the
    same budgets and internal state on both sides."""
    rng = np.random.default_rng(3)
    port, ref = tsp.DraftState(4, adaptive), jsp.DraftState(4, adaptive)
    for step in range(120):
        b = port.budget()
        assert b == ref.budget(), step
        acc = 0 if step < 40 or rng.random() < 0.6 else int(rng.integers(0, b + 1))
        port.observe(b, acc)
        ref.observe(b, acc)
        assert (port.length, port.zero_streak, port.parked_ticks) == (
            ref.length, ref.zero_streak, ref.parked_ticks), step


# -- the verify attention --------------------------------------------------------


def _jax_verify_chain(q, k, v, k_chunk, v_chunk, mask, ks=None, vs=None):
    """``_block_verify_deferred``'s attention lines (JAX ``models/llama.py``
    1083-1152) on the kernel's layouts: q ``[B, NKV, S*G, D]`` as qg ``[B,
    S, NKV, G, D]``, the chunk ``[B, NKV, S, D]`` as ``[B, S, NKV, D]``,
    the window ``[B, NKV, W, D]`` (int8 with scales ``[B, NKV, W, 1]``),
    the mask ``[B, 1, W]``; ``[B, NKV, S*G, D]`` out."""
    b, nkv, r, hd = q.shape
    s = k_chunk.shape[2]
    g = r // s
    qg = jnp.moveaxis(q.reshape(b, nkv, s, g, hd), 2, 1)
    kn, vn = jnp.moveaxis(k_chunk, 2, 1), jnp.moveaxis(v_chunk, 2, 1)
    quant = ks is not None
    sq = jnp.sqrt(jnp.float32(hd))
    scores = jnp.einsum("bqngd,bnkd->bngqk", qg, k.astype(q.dtype),
                        preferred_element_type=jnp.float32) / sq
    if quant:
        scores = scores * ks[..., 0][:, :, None, None, :]
    scores = scores + mask[:, None, None]
    score_self = jnp.einsum("bqngd,bjnd->bngqj", qg, kn, preferred_element_type=jnp.float32) / sq
    eye = jnp.eye(s, dtype=bool)[None, None, None]
    if quant:
        k8c, kscc = J._quant_kv(kn)
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
        pc = (pc * vs[..., 0][:, :, None, None, :]).astype(q.dtype)
        ctx = jnp.einsum("bngqk,bnkd->bqngd", pc, v.astype(q.dtype))
        v8c, vscc = J._quant_kv(vn)
        eyef = eye.astype(probs.dtype)
        ctx = ctx + jnp.einsum("bngqj,bjnd->bqngd", (pk * eyef).astype(q.dtype), vn)
        below = pk * (1.0 - eyef) * jnp.moveaxis(vscc[..., 0], 1, 2)[:, :, None, None, :]
        ctx = ctx + jnp.einsum("bngqj,bjnd->bqngd", below.astype(q.dtype), v8c.astype(q.dtype))
    else:
        ctx = jnp.einsum("bngqk,bnkd->bqngd", pc.astype(q.dtype), v)
        ctx = ctx + jnp.einsum("bngqj,bjnd->bqngd", pk.astype(q.dtype), vn)
    return jnp.moveaxis(ctx, 1, 2).reshape(b, nkv, r, hd)


_jverify_chain = jax.jit(_jax_verify_chain)


def _verify_inputs(B, NKV, S, G, D, W, lengths, seed, quant, near_clip=False):
    """f64 inputs of both instances; ``near_clip`` puts chunk rows where
    the int8 round-trip rounds at +-127."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NKV, S * G, D))
    k_chunk, v_chunk = rng.standard_normal((2, B, NKV, S, D))
    if near_clip:
        k_chunk[..., 0] = 50.0 * np.sign(k_chunk[..., 0] + 1e-9)
        v_chunk[..., 1] = -40.0
    mask = np.where(np.arange(W)[None, :] < np.asarray(lengths)[:, None], 0.0, -1e9)
    mask = mask.astype(np.float32)[:, None, :]
    if quant:
        k = rng.integers(-127, 128, (B, NKV, W, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, NKV, W, D)).astype(np.int8)
        ks, vs = (rng.random((2, B, NKV, W, 1)) * 0.01 + 1e-3).astype(np.float32)
        return q, k, v, k_chunk, v_chunk, mask, ks, vs
    k, v = rng.standard_normal((2, B, NKV, W, D))
    return q, k, v, k_chunk, v_chunk, mask, None, None


def _port_verify(q, k, v, k_chunk, v_chunk, mask, ks=None, vs=None, fn=None, counts=None):
    t = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, k_chunk, v_chunk, mask, ks, vs)]
    q, k, v, k_chunk, v_chunk, mask, ks, vs = t
    if ks is None:
        return (fn or tda.verify_attention_dense)(q, k, v, k_chunk, v_chunk, mask,
                                                  counts=counts)
    k8c, ksc = T._quant_kv(k_chunk)
    v8c, vsc = T._quant_kv(v_chunk)
    return (fn or tda.verify_attention)(q, k, ks, v, vs, k_chunk, v_chunk, k8c, ksc, v8c,
                                        vsc, mask, counts=counts)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("S,G,W", [(1, 2, 16), (2, 1, 16), (3, 2, 24), (5, 4, 48),
                                   (17, 1, 64), (4, 8, 16)])
def test_plain_verify_attention_matches_the_reference_lines(quant, S, G, W):
    """Both plain versions against the JAX attention lines in f64: lengths
    0, 1 and W - 1 in one batch, chunk rows near the int8 clip.  Scores and
    the softmax are f32 on both sides (torch's and XLA's exp round
    differently), so they agree to f32 rounding."""
    args = _verify_inputs(3, 2, S, G, 16, W, [0, 1, W - 1], seed=S * 10 + G, quant=quant,
                          near_clip=quant)
    want = np.asarray(_jverify_chain(*(None if a is None else jnp.asarray(a) for a in args)))
    got = _port_verify(*args).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_verify_at_one_position_is_the_decode_attention():
    """At S = 1 the chunk is the self row: the verify plain versions are
    the decode kernel's plain versions."""
    for quant in (False, True):
        q, k, v, kc, vc, mask, ks, vs = _verify_inputs(2, 2, 1, 4, 16, 24, [0, 24], 1, quant)
        got = _port_verify(q, k, v, kc, vc, mask, ks, vs).numpy()
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        if quant:
            want = tda.decode_attention_reference(t(q), t(k), t(ks), t(v), t(vs), t(kc), t(vc),
                                                  t(mask))
        else:
            want = tda.decode_attention_dense_reference(t(q), t(k), t(v), t(kc), t(vc), t(mask))
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def _slices(qs, segs, pos, ksplit, rnd):
    """One block's piece in f64 torch, as ``csrc/chunk_attention.cuh``
    runs it: pre-scaled queries ``qs [B, NKV, R, D]`` at chunk positions
    ``pos [R]`` against segments ``(K, V, kscale, vscale, bias, chunk,
    diag)`` (keys ``[B, NKV, N, ...]``; ``diag``: the exact diagonal's
    scores ``[B, NKV, R]`` and V rows ``[B, NKV, R, D]``, or None), in
    16-key slices; slice j of a segment goes to warp ``(j % 4) % ksplit``,
    whose online softmax (running max, rescale) takes it.  ``rnd`` rounds
    p (times the value scale) as P . V takes it.  Returns the warps'
    ``(m, l, acc)``."""
    b, nkv, r, d = qs.shape
    states = [(torch.full((b, nkv, r), -1e30, dtype=torch.float64),
               torch.zeros((b, nkv, r), dtype=torch.float64),
               torch.zeros((b, nkv, r, d), dtype=torch.float64)) for _ in range(ksplit)]
    for k, v, ksc, vsc, bias, chunk, diag in segs:
        for k0 in range(0, k.shape[2], 16):
            k1 = min(k.shape[2], k0 + 16)
            x = torch.einsum("bnrd,bnkd->bnrk", qs, k[:, :, k0:k1]) * ksc[:, :, None, k0:k1]
            if bias is not None:
                x = x + bias[:, :, None, k0:k1]
            key = torch.arange(k0, k1)
            on_diag = (key[None, :] == pos[:, None]) & chunk & (diag is not None)
            if diag is not None and chunk:
                x = torch.where(on_diag, diag[0][..., None], x)
            if chunk:
                x = torch.where(key[None, :] <= pos[:, None], x, -torch.inf)
            w = (k0 // 16 % 4) % ksplit
            m, l, acc = states[w]
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            pv = rnd(torch.where(on_diag, 0.0, p * vsc[:, :, None, k0:k1]))
            acc = acc * corr[..., None] + torch.einsum("bnrk,bnkd->bnrd", pv, v[:, :, k0:k1])
            if diag is not None and chunk:
                acc = acc + torch.where(on_diag, p, 0.0).sum(-1)[..., None] * diag[1]
            states[w] = (m_new, l * corr + p.sum(-1), acc)
    return states


def _join(states):
    """The max-rescale join of ``(m, l, acc)`` states (a row tile's warps,
    or a row's pieces)."""
    m = torch.stack([s[0] for s in states]).amax(0)
    f = [torch.exp(s[0] - m) for s in states]
    return (m, sum(s[1] * fi for s, fi in zip(states, f)),
            sum(s[2] * fi[..., None] for s, fi in zip(states, f)))


def _hi_lo(x):
    """x as the kernel's P . V takes it: bf16(x) + bf16(x - bf16(x))."""
    hi = x.to(torch.bfloat16).to(torch.float64)
    return hi + (x - hi).to(torch.bfloat16).to(torch.float64)


def _plan(b, nkv, r, w, splits=None):
    """``tda.verify_plan``, with ``splits`` window pieces asked for."""
    rows = tda.verify_plan(b, nkv, r, w).rows
    return tda.verify_plan(b, nkv, r, w, None if splits is None
                           else b * nkv * -(-r // rows) * splits)


def _verify_emulation(q, k, v, k_chunk, v_chunk, mask, ks, vs, splits=None, round_p=False,
                      counts=None):
    """The bf16 verify kernel's algebra in f64 torch: the plan of
    ``tda.verify_plan`` (``splits``: that many window pieces asked for),
    each row group of ``plan.rows`` rows attending each window piece, the
    last piece also the chunk (round-trip codes and scales below the
    diagonal on the int8 window, the exact diagonal), through ``_slices``
    with the 64 / rows warps of a row tile; the warps joined, then the
    pieces.  ``round_p``: p enters P . V as the kernel's hi/lo bf16 pair.
    ``counts`` (a slot's live chunk positions): a row group's rows at or
    past ``counts[b] * G`` attend nothing and stay zero, and a group with
    no live row of any slot is skipped, as the kernel's blocks exit."""
    q, k, v, kc, vc, mask = (torch.from_numpy(np.asarray(a, np.float64))
                             for a in (q, k, v, k_chunk, v_chunk, mask))
    b, nkv, r, d = q.shape
    s, w = kc.shape[2], k.shape[2]
    g = r // s
    quant = ks is not None
    ones = torch.ones((b, nkv, w), dtype=torch.float64)
    ksw = torch.from_numpy(np.asarray(ks, np.float64))[..., 0] if quant else ones
    vsw = torch.from_numpy(np.asarray(vs, np.float64))[..., 0] if quant else ones
    plan = _plan(b, nkv, r, w, splits)
    qs = q / d ** 0.5
    if quant:
        k8c, ksc = (x.to(torch.float64) for x in T._quant_kv(kc.to(torch.float32)))
        v8c, vsc = (x.to(torch.float64) for x in T._quant_kv(vc.to(torch.float32)))
        chunk_kv = (k8c, v8c, ksc[..., 0], vsc[..., 0])
    else:
        chunk_kv = (kc, vc, torch.ones((b, nkv, s), dtype=torch.float64),
                    torch.ones((b, nkv, s), dtype=torch.float64))
    out = torch.zeros((b, nkv, r, d), dtype=torch.float64)
    rnd = _hi_lo if round_p else (lambda x: x)
    live_rows = r if counts is None else int(max(counts)) * g
    for r0 in range(0, min(r, live_rows), plan.rows):
        rr = torch.arange(r0, min(r, r0 + plan.rows))
        pos = rr // g
        qr = qs[:, :, rr]
        diag = ((qr * kc[:, :, pos]).sum(-1), vc[:, :, pos]) if quant else None
        parts = []
        for lo, hi, with_chunk in tda.verify_pieces(w, plan):
            segs = [(k[:, :, lo:hi], v[:, :, lo:hi], ksw[:, :, lo:hi], vsw[:, :, lo:hi],
                     mask[:, :, lo:hi], False, None)]
            if with_chunk:
                segs.append((*chunk_kv, None, True, diag))
            parts.append(_join(_slices(qr, segs, pos, 64 // plan.rows, rnd)))
        _, l, acc = _join(parts)
        out[:, :, rr] = acc / l[..., None]
    if counts is not None:
        live = (torch.arange(r) // g)[None, :] < torch.as_tensor(counts)[:, None]
        out = torch.where(live[:, None, :, None], out, torch.zeros((), dtype=out.dtype))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("S,G,W,counts", [(5, 1, 768, (1, 5, 0, 3)), (17, 4, 97, (1, 17, 2, 9)),
                                          (256, 1, 64, (1, 1, 5, 256)),
                                          (256, 1, 200, (1, 1, 1, 1))])
def test_kernel_with_live_counts_matches_the_plain_version(quant, S, G, W, counts):
    """The super-step's row mixes (decode 1, verify draft + 1, a prefill
    chunk, an idle 0): the emulation with the kernel's parked groups equals
    the plain version with ``counts``, whose live rows equal the call
    without it and whose parked rows are zero."""
    B, NKV, D = 4, 2, 16
    args = _verify_inputs(B, NKV, S, G, D, W, [0, 1, W - 1, W // 2], seed=S + W, quant=quant)
    q, k, v, kc, vc, mask, ks, vs = args
    counts_t = torch.tensor(counts, dtype=torch.int32)
    got = _verify_emulation(q, k, v, kc, vc, mask, ks, vs, counts=counts).numpy()
    want = _port_verify(*args, counts=counts_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    full = _port_verify(*args).numpy()
    live = (np.arange(S * G) // G)[None, :] < np.asarray(counts)[:, None]
    np.testing.assert_array_equal(want.transpose(0, 2, 1, 3)[live],
                                  full.transpose(0, 2, 1, 3)[live])
    assert not want.transpose(0, 2, 1, 3)[~live].any()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("S,G,W,splits", [(3, 1, 16, None), (5, 1, 768, None),
                                          (2, 8, 200, None), (17, 1, 96, 13), (3, 4, 97, 3),
                                          (65, 1, 4096, None), (2, 1, 4096, None),
                                          (5, 8, 1000, 7)])
def test_kernel_tiles_splits_and_merge_match_the_plain_version(quant, S, G, W, splits):
    """The bf16 kernel's algebra (row groups of 16 / 32 / 64 rows whose
    warps split the 16-key slices, tile-aligned window pieces from
    ``verify_plan`` or asked for: more pieces than tiles, a ragged last
    piece, the chunk joined in the last) equals the plain version on f64
    inputs to the f32 rounding of its scores and softmax (the reference's;
    1e-5 relative, 1e-6 absolute), and with p as the hi/lo bf16 pair within 1e-5 of the f32 plain
    version (the f32 summation-order tolerance of the decode checks), at
    lengths 0, 1, W - 1 and on a piece edge."""
    B, NKV, D = 4, 2, 16
    c = _plan(B, NKV, S * G, W, splits).piece_len
    args = _verify_inputs(B, NKV, S, G, D, W, [0, 1, W - 1, min(c, W)], seed=W + S, quant=quant)
    q, k, v, kc, vc, mask, ks, vs = args
    exact = _verify_emulation(q, k, v, kc, vc, mask, ks, vs, splits).numpy()
    np.testing.assert_allclose(exact, _port_verify(*args).numpy(), rtol=1e-5, atol=1e-6)
    got = _verify_emulation(q, k, v, kc, vc, mask, ks, vs, splits, round_p=True).numpy()
    assert np.isfinite(got).all()
    f32 = [None if a is None else (a.astype(np.float32) if a.dtype == np.float64 else a)
           for a in args]
    want = _port_verify(*f32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("S,G,W,splits", [(66, 1, 64, None), (40, 2, 130, 2),
                                          (256, 1, 48, None), (128, 1, 200, 3)])
def test_kernel_past_64_rows_matches_the_reference_lines(quant, S, G, W, splits):
    """Past the old cap of 65 positions: several row groups of 64 rows a
    (slot, head), each attending every piece, up to the prefill chunk
    (256).  The f64 emulation against the JAX attention lines and the
    plain version, both with f32 scores and softmax: 1e-5 relative and
    absolute (chunk rows near the int8 clip hold values of 40)."""
    B, NKV, D = 2, 2, 16
    args = _verify_inputs(B, NKV, S, G, D, W, [0, W - 1], seed=S + W, quant=quant,
                          near_clip=quant)
    q, k, v, kc, vc, mask, ks, vs = args
    got = _verify_emulation(q, k, v, kc, vc, mask, ks, vs, splits).numpy()
    np.testing.assert_allclose(got, _port_verify(*args).numpy(), rtol=1e-5, atol=1e-5)
    want = np.asarray(_jverify_chain(*(None if a is None else jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,nkv,r,w", [(4, 32, 5, 768), (4, 32, 65, 768), (4, 32, 256, 4096),
                                       (1, 1, 1, 1), (3, 2, 17, 97), (8, 8, 520, 4096),
                                       (2, 4, 33, 63), (4, 32, 2, 16)])
@pytest.mark.parametrize("blocks", [None, 1, 7, 10_000])
def test_verify_plan_covers_every_key_and_row_once(b, nkv, r, w, blocks):
    """The plan's pieces cover the window's positions exactly once, in
    whole 64-key tiles but the last, which is non-empty and alone attends
    the chunk; its row groups cover the rows; it is a function of the
    shapes (what the C call refuses otherwise: rows of 16 / 32 / 64, the
    piece a multiple of 64, splits * piece >= W > (splits - 1) * piece)."""
    plan = tda.verify_plan(b, nkv, r, w, blocks)
    assert plan == tda.verify_plan(b, nkv, r, w, blocks)
    assert plan.rows in tda.VERIFY_ROWS and plan.row_groups == -(-r // plan.rows)
    assert (plan.row_groups - 1) * plan.rows < r <= plan.row_groups * plan.rows
    assert plan.piece_len % tda.VERIFY_TILE == 0
    assert plan.splits * plan.piece_len >= w > (plan.splits - 1) * plan.piece_len
    pieces = tda.verify_pieces(w, plan)
    covered = [p for lo, hi, _ in pieces for p in range(lo, hi)]
    assert covered == list(range(w))
    assert all(hi > lo for lo, hi, _ in pieces)
    assert [c for _, _, c in pieces] == [False] * (len(pieces) - 1) + [True]


def test_row_tile_and_refusals():
    """The widest chunk the kernel takes, 256 positions (the prefill
    chunk) x G 8 = 2048 query rows, has its plain answer; 66 positions,
    one past the old cap, is taken; more than 256 positions, rows that are
    not S x G with G in 1, 2, 4, 8, and other head dims are refused."""
    t = lambda *sh: torch.zeros(sh)
    mask = torch.zeros((1, 1, 16))
    kv = torch.ones((1, 2, 16, 16), dtype=torch.float64)
    for s, g in ((256, 8), (66, 1)):
        q = torch.from_numpy(np.random.default_rng(s).standard_normal((1, 2, s * g, 16)))
        chunk = torch.ones((1, 2, s, 16), dtype=torch.float64)
        out = tda.verify_attention_dense(q, kv, kv, chunk, chunk, mask)
        assert out.shape == q.shape
        torch.testing.assert_close(out, torch.ones_like(out))  # every value row is ones
    for q, kc, needle in ((t(1, 2, 6, 16), t(1, 2, 4, 16), "query rows"),
                          (t(1, 2, 3 * 16, 16), t(1, 2, 3, 16), "query rows"),
                          (t(1, 2, 257, 16), t(1, 2, 257, 16), "chunk positions"),
                          (t(1, 2, 4, 24), t(1, 2, 4, 24), "takes D")):
        with pytest.raises(ValueError, match=needle):
            tda.verify_attention_dense(q, t(1, 2, 16, q.shape[-1]), t(1, 2, 16, q.shape[-1]),
                                       kc, kc, mask)
    meta = [x.to("meta") for x in (t(1, 2, 4, 16), t(1, 2, 16, 16), t(1, 2, 16, 16),
                                   t(1, 2, 2, 16), t(1, 2, 2, 16), mask)]
    with pytest.raises(ValueError, match="unsupported device"):
        tda.verify_attention_dense(*meta)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_block_verify_deferred_matches_the_reference(quant):
    """One decoder layer: the port's ``_block_verify_deferred`` (the plain
    verify attention inside) against the JAX one, f64, a 5-position chunk
    over a 24-wide window with lengths 0, 7 and 24."""
    jcfg, tcfg, jp, tp = _models("gqa")
    B, S, W = 3, 5, 24
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, jcfg.hidden_size))
    lengths = np.array([0, 7, 24])
    pos = lengths[:, None] + np.arange(S)[None, :]
    mask = np.where(np.arange(W)[None, :] < lengths[:, None], 0.0, -1e9).astype(np.float32)
    mask = mask[:, None, None]
    shape = (B, jcfg.num_kv_heads, W, jcfg.head_dim)
    if quant:
        kv = (rng.integers(-127, 128, shape).astype(np.int8),
              (rng.random(shape[:-1] + (1,)) * 0.01).astype(np.float32))
        ck, cv = kv, (kv[0][::-1].copy(), kv[1][::-1].copy())
    else:
        ck, cv = rng.standard_normal((2,) + shape)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    jcos, jsin = J.rope_cos_sin(jnp.asarray(pos), jcfg, jnp.float32)
    # The reference takes the in-chunk causal bias as an argument.
    qpos = jnp.arange(S)
    chunk_bias = jnp.where(qpos[:, None] >= qpos[None, :], 0.0, -1e9).astype(jnp.float32)
    jy, jk, jv = J._block_verify_deferred(
        jnp.asarray(x), jlp, jax.tree.map(jnp.asarray, ck), jax.tree.map(jnp.asarray, cv),
        jcos, jsin, jnp.asarray(mask), chunk_bias[None, None, None], jcfg, window=W)
    tcos, tsin = T.rope_cos_sin(torch.from_numpy(pos), tcfg)
    to_t = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(z)) for z in a) \
        if isinstance(a, tuple) else torch.from_numpy(np.ascontiguousarray(a))
    ty, tk, tv, tq = T._block_verify_deferred(
        torch.from_numpy(x), T._layer(tp["layers"], 0), to_t(ck), to_t(cv), tcos, tsin,
        torch.from_numpy(mask), tcfg, window=W)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    # The int8 cache's chunk comes back quantized once, as the commit stores it.
    if quant:
        want = (*T._quant_kv(tk), *T._quant_kv(tv))
        for got, w in zip(tq, want):
            assert torch.equal(got, w)
    else:
        assert tq is None


# -- verify_ragged ---------------------------------------------------------------


_jprefill = jax.jit(J.prefill, static_argnums=(2,), static_argnames=("dtype",))
_jinsert = jax.jit(J.insert_sequence)
_jverify = jax.jit(J.verify_ragged, static_argnums=(3,), static_argnames=("dtype", "window"))


def _ragged_pair(kind, quant):
    """Both caches with slot 0 at length 7 and slot 2 at 62 (its verify
    chunk spills past capacity 64), slot 1 empty."""
    jcfg, tcfg, jp, tp = _models(kind)
    if quant:
        jc, tc = J.QuantRaggedKVCache.create(jcfg, 3), T.QuantRaggedKVCache.create(tcfg, 3)
    else:
        jc = J.RaggedKVCache.create(jcfg, 3, jnp.float64)
        tc = T.RaggedKVCache.create(tcfg, 3, torch.float64)
    for slot, n in ((0, 7), (2, 62)):
        ids = np.zeros((1, 64), np.int32)
        ids[0, :n] = np.random.default_rng(slot).integers(0, 256, n)
        _, jseq = _jprefill(jp, jnp.asarray(ids), jcfg, dtype=jnp.float64)
        _, tseq = T.prefill(tp, torch.from_numpy(ids).long(), tcfg, dtype=torch.float64)
        jc = _jinsert(jc, jseq, jnp.int32(slot), jnp.int32(n))
        tc = T.insert_sequence(tc, tseq, slot, n)
    return jc, tc


@pytest.mark.parametrize("cache", ["dense", "int8"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_verify_ragged_matches_the_reference(kind, cache):
    quant = cache == "int8"
    jcfg, tcfg, jp, tp = _models(kind)
    jc, tc = _ragged_pair(kind, quant)
    toks = np.random.default_rng(9).integers(0, 256, (3, 5)).astype(np.int32)
    active = np.array([True, False, True])
    jl, jc = _jverify(jp, jnp.asarray(toks), jc, jcfg, dtype=jnp.float64, window=64,
                      active=jnp.asarray(active))
    tl, tc = T.verify_ragged(tp, torch.from_numpy(toks).long(), tc, tcfg, torch.float64,
                             window=64, active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tl.argmax(-1).tolist() == np.asarray(jnp.argmax(jl, -1)).tolist()
    assert tc.lengths.tolist() == [7, 0, 62] == np.asarray(jc.lengths).tolist()
    for name, jx, tx in zip(jc._fields, jc, tc):
        jx, tx = np.asarray(jx), tx.numpy()
        if jx.dtype == np.int8:
            # an int8 code may sit on a rounding boundary: at most one step
            assert np.abs(tx.astype(int) - jx.astype(int)).max() <= 1, name
        else:
            np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-7, err_msg=name)
    # the inactive row and the positions past capacity were never written
    buf = (tc.k8 if quant else tc.k).numpy()
    assert not buf[:, 1].any()


def test_commit_chunk_drops_past_capacity_and_parks_inactive_rows():
    """The drop-scatter of ``_commit_chunk`` against the reference's on a
    bare buffer: a row at T - 2 keeps two positions and drops two; a
    parked row and a row at capacity write nothing."""
    L, B, H, Tn, D, S = 2, 4, 2, 8, 3, 4
    rng = np.random.default_rng(0)
    buf = rng.standard_normal((L, B, H, Tn, D))
    vals = rng.standard_normal((L, B, S, H, D))
    lengths = np.array([Tn - 2, 1, Tn, 0], np.int32)
    active = np.array([True, True, True, False])
    jc = J._commit_chunk(J.RaggedKVCache(jnp.asarray(buf), jnp.asarray(buf),
                                         jnp.asarray(lengths)),
                         jnp.asarray(vals), jnp.asarray(vals), jnp.asarray(lengths), False,
                         jnp.asarray(active))
    tc = T.RaggedKVCache(torch.from_numpy(buf.copy()), torch.from_numpy(buf.copy()),
                         torch.from_numpy(lengths))
    T._commit_chunk(tc, torch.from_numpy(vals), torch.from_numpy(vals),
                    torch.from_numpy(lengths), False, torch.from_numpy(active))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.k.numpy()[:, 2:], buf[:, 2:])


# -- the engine ------------------------------------------------------------------


def _engine(draft_tokens=4, adaptive=True, quant=False, **kw):
    _, tcfg, _, tp = _models(quant=quant)
    return TG.GenerationEngine(
        tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu",
        speculative=tsp.SpeculativeConfig(enabled=True, draft_tokens=draft_tokens,
                                          ngram_min=1, ngram_max=4, adaptive=adaptive),
        **kw)


def _oracle(engine, refs):
    """A drafter that proposes the known greedy continuation."""

    def propose(slot, budget):
        ref = refs[tuple(slot.history[:slot.prompt_len].tolist())]
        g = len(slot.generated)
        return ref[g:g + budget]

    engine._propose = propose


def _run(engine, jobs):
    engine.start()
    try:
        futs = [engine.submit(p, n, **kw) for p, n, kw in jobs]
        return [f.result(timeout=120).tolist() for f in futs]
    finally:
        engine.shutdown()


REPEAT = [1, 2, 3] * 5


def test_engine_with_slot_churn_matches_generate_greedy():
    """Five requests on two slots, repetitive and random prompts: every
    stream equals greedy decode, and the verify path ran."""
    jobs = [(REPEAT, 10, {}), ([5, 9, 2], 6, {}), ([7, 1, 4, 8, 3], 9, {}), ([42], 4, {}),
            ([10, 20, 30, 40, 50, 60, 70], 5, {})]
    engine = _engine()
    outs = _run(engine, jobs)
    assert outs == [_ref(tuple(p), n) for p, n, _ in jobs]
    assert engine.spec_verify_ticks > 0
    assert engine.dispatches_total["verify"] == engine.spec_verify_ticks


def test_oracle_drafter_takes_fewer_verify_ticks_than_tokens():
    prompt, n = [5, 9, 2], 12
    ref = _ref(tuple(prompt), n)
    engine = _engine()
    _oracle(engine, {tuple(prompt): ref})
    assert _run(engine, [(prompt, n, {})]) == [ref]
    # 11 tokens after the prefill's: two verify ticks of 4 + 1, one plain tick
    assert engine.spec_verify_ticks < engine.decode_forwards < n - 1
    assert engine.spec_accepted_tokens == engine.spec_proposed_tokens > 0


def test_eos_inside_an_accepted_run_stops_exactly():
    prompt = [5, 9, 2]
    ref = _ref(tuple(prompt), 8)
    eos = ref[4]
    engine = _engine()
    _oracle(engine, {tuple(prompt): ref})
    out = _run(engine, [(prompt, 8, {"eos_id": eos})])[0]
    assert out == ref[:ref.index(eos) + 1]


def test_adaptive_collapse_parks_a_wrong_drafter():
    prompt, n = [5, 9, 2], 14
    ref = _ref(tuple(prompt), n)
    engine = _engine()
    engine._propose = lambda slot, budget: [(ref[len(slot.generated)] + 1) % 256]
    assert _run(engine, [(prompt, n, {})]) == [ref]
    assert engine.spec_accepted_tokens == 0
    assert 0 < engine.spec_proposed_tokens < n - 1


@functools.lru_cache(maxsize=None)
def _jax_sampled(prompt: tuple, n: int, seed: int) -> list:
    jcfg, _, jp, _ = _models()
    eng = JaxEngine(jp, jcfg, max_slots=2, dtype=jnp.float64)
    eng.start(warmup=False)
    try:
        return eng.generate(list(prompt), n, temperature=0.9, top_k=4, top_p=0.95,
                            seed=seed, timeout=300).tolist()
    finally:
        eng.shutdown()


def test_a_sampling_slot_falls_back_and_stays_reproducible():
    """A tick with a sampling slot is the plain step: the seeded stream
    equals the JAX engine's and the plain port engine's, with a greedy
    request beside it that still matches greedy decode."""
    kw = dict(temperature=0.9, top_k=4, top_p=0.95, seed=1234)
    want = _jax_sampled((5, 9, 2), 7, 1234)
    _, tcfg, _, tp = _models()
    plain = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu")
    assert _run(plain, [([5, 9, 2], 7, kw)]) == [want]
    engine = _engine()
    alone = _run(engine, [([5, 9, 2], 7, kw)])
    assert alone == [want] and engine.spec_verify_ticks == 0
    engine = _engine()
    both = _run(engine, [([5, 9, 2], 7, kw), (REPEAT, 6, {})])
    assert both == [want, _ref(tuple(REPEAT), 6)]


def test_speculation_with_the_prefix_cache():
    prompt = list(range(2, 22))
    ref = _ref(tuple(prompt), 6)
    engine = _engine(prefix_cache=tpc.PrefixCacheConfig(enabled=True, budget_bytes=1 << 22,
                                                         chunk_tokens=8))
    _oracle(engine, {tuple(prompt): ref})
    engine.start()
    try:
        assert engine.generate(prompt, 6).tolist() == ref
        assert engine.generate(prompt, 6).tolist() == ref
    finally:
        engine.shutdown()
    assert engine.prefix_hits == 1 and engine.prefix_cached_tokens == 16
    assert engine.spec_accepted_tokens > 0


def _jax_int8kv_greedy(prompt, n):
    """Greedy tokens through the reference's int8 KV path: a bucket-padded
    prefill inserted into a quant cache, then ``decode_ragged`` steps."""
    jcfg, _, jpq, _ = _models(quant=True)
    ids = np.zeros((1, 16 if len(prompt) <= 16 else 32), np.int32)
    ids[0, :len(prompt)] = prompt
    logits, seq = _jprefill(jpq, jnp.asarray(ids), jcfg, dtype=jnp.float64)
    cache = _jinsert(J.QuantRaggedKVCache.create(jcfg, 1), seq, jnp.int32(0),
                     jnp.int32(len(prompt)))
    decode = jax.jit(J.decode_ragged, static_argnums=(3,), static_argnames=("dtype", "window"))
    out = [int(jnp.argmax(logits[0, len(prompt) - 1]))]
    while len(out) < n:
        lg, cache = decode(jpq, jnp.asarray([[out[-1]]], jnp.int32), cache, jcfg,
                           dtype=jnp.float64, window=64)
        out.append(int(jnp.argmax(lg[0, -1])))
    return out


def test_speculation_on_the_int8_kv_cache_matches_the_plain_path():
    """int8 weights and the int8 KV cache: the speculative engine equals
    the JAX int8 path and the port's plain int8kv engine token for token
    (the verify reads earlier chunk rows through the round-trip)."""
    prompt, n = REPEAT, 10
    want = _jax_int8kv_greedy(prompt, n)
    _, tcfg, _, tpq = _models(quant=True)
    plain = TG.GenerationEngine(tpq, tcfg, max_slots=2, dtype=torch.float64, device="cpu",
                                kv_quant=True)
    assert _run(plain, [(prompt, n, {})]) == [want]
    engine = _engine(quant=True, kv_quant=True)
    assert _run(engine, [(prompt, n, {})]) == [want]
    assert engine.spec_verify_ticks > 0


def test_a_disabled_config_is_the_plain_dispatch():
    _, tcfg, _, tp = _models()
    engine = TG.GenerationEngine(tp, tcfg, max_slots=2, dtype=torch.float64, device="cpu",
                                 speculative=tsp.SpeculativeConfig(enabled=False))
    assert engine._spec is None
    calls = []
    real = engine._device_step
    engine._device_step = lambda *a: (calls.append(1), real(*a))[1]
    assert _run(engine, [(REPEAT, 5, {})]) == [_ref(tuple(REPEAT), 5)]
    assert len(calls) == 4
    assert engine.spec_verify_ticks == engine.spec_proposed_tokens == 0
    assert "verify" not in engine.dispatches_total


def test_a_join_and_a_leave_mid_stream():
    """A request joins while another streams speculatively and leaves
    before it: neither stream moves."""
    import threading

    long_p, long_n, short_p, short_n = REPEAT, 16, [7, 1, 4], 4
    refs = {tuple(long_p): _ref(tuple(long_p), long_n),
            tuple(short_p): _ref(tuple(short_p), short_n)}
    engine = _engine()
    _oracle(engine, refs)
    engine.start()
    try:
        third = threading.Event()
        slow = engine.submit(long_p, long_n,
                             on_token=lambda t: third.set() if engine.tokens_generated >= 3
                             else None)
        assert third.wait(30)
        fast = engine.submit(short_p, short_n)
        assert fast.result(timeout=60).tolist() == refs[tuple(short_p)]
        assert slow.result(timeout=60).tolist() == refs[tuple(long_p)]
    finally:
        engine.shutdown()
    assert engine.spec_verify_ticks > 0


@functools.lru_cache(maxsize=None)
def _jax_int8_weights_greedy(prompt: tuple, n: int) -> list:
    jcfg, _, jpq, _ = _models(quant=True)
    out = _jgen(jpq, jnp.asarray([prompt], jnp.int32), n, jcfg, dtype=jnp.float64)
    return np.asarray(out)[0].tolist()


@pytest.mark.parametrize("mode", ["none", "int8", "int8kv"])
def test_both_features_in_every_quantize_mode(mode):
    """The prefix cache and speculation together, in each quantize mode:
    a cold prompt, the same prompt warm (16 tokens seeded) and a
    repetitive one, token for token against the reference's greedy path
    for that mode (``generate_greedy`` on f64 or int8 weights; the int8 KV
    path stepped for int8kv)."""
    jobs = [(P, 6) for P in (list(range(2, 22)), list(range(2, 22)), REPEAT)]
    quant = mode != "none"
    if mode == "none":
        want = [_ref(tuple(p), n) for p, n in jobs]
    elif mode == "int8":
        want = [_jax_int8_weights_greedy(tuple(p), n) for p, n in jobs]
    else:
        want = [_jax_int8kv_greedy(p, n) for p, n in jobs]
    engine = _engine(quant=quant, kv_quant=mode == "int8kv",
                     prefix_cache=tpc.PrefixCacheConfig(enabled=True, budget_bytes=1 << 22,
                                                        chunk_tokens=8))
    engine.start()
    try:
        got = [engine.generate(p, n).tolist() for p, n in jobs]
    finally:
        engine.shutdown()
    assert got == want
    assert (engine.prefix_hits, engine.prefix_cached_tokens) == (1, 16)
    assert engine.spec_proposed_tokens > 0
