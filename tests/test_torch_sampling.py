"""The port's sampled step (``ops.sample_step``) against the JAX package, on
the CPU.

- ``_emulate``, a torch transcript of the two kernels of
  ``csrc/sampling.cu`` (their plan, the prep kernel's partials, the draw
  kernel's scan and its order of sums in f32, threefry and the Gumbel for
  kept ranks only, the last block's reduction) against the plain chain and
  the jitted JAX ``sample_chain_step`` / ``sample_logits``: B 1 / 4 / 5, V
  16 / 257 / 32000, four filter mixes, greedy and sampled rows mixed.
  Carry keys are exact; a token is equal or inside the rule the card is
  held to (``_within_rule``).
- The wrapper on the CPU (the plain chain) against the JAX package's
  ``sample_chain_step``, exactly, in every case.
- The edge cases of the JAX package's ``tests/test_sampling.py`` (T = 0 and
  its limit, top_k 1, top_p tiny, the p boundary and an exact tie at it,
  the first token always kept, greedy ties), top_p = 0, all-masked rows,
  NaN, +inf and -inf logits, through all three.
- The plain split-and-draw against ``jax.random``; the plan covers every
  position once; the wrapper's refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    prng as TP,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    sampling as TS,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (
    sample_step as TSS,
)
from tpumlops.models import sampling as JS

# A token of the kernels may differ from the plain chain's only where one of
# two things holds (``_within_rule``):
# - the two chosen scores lie within GUMBEL_ULPS f32 ulp: the kernel's
#   Gumbel is the device's logf of a bit-equal uniform, two logs each within
#   an ulp or two;
# - the plain exclusive mass at one of the two chosen ranks lies within
#   P_TOL of p: both sides add the softmax sum and the exclusive mass in
#   f32 over up to V terms in different orders (the kernels: four ranks a
#   thread, a warp scan, the warps, the chunks; the plain chain: softmax's
#   and cumsum's own), each side's deepest chain some 40 roundings of at
#   most 2^-24 relative, so ~5e-6 apart at worst with random rounding
#   far less; 1e-5 keeps a factor of two.
GUMBEL_ULPS = 4
P_TOL = 1e-5

MIXES = [(0.8, 50, 0.95), (1.0, 0, 1.0), (0.7, 0, 0.9), (0.8, 1, 1.0)]
NEG = np.float32(-1e30)


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_fns():
    return jax.jit(JS.sample_chain_step), jax.jit(JS.sample_logits)


def _jax_step(logits, kd, temps, tks, tps):
    """The JAX package's jitted ``sample_chain_step`` and ``sample_logits``
    (with the use half) on numpy inputs: (carry words, tokens, tokens)."""
    step, sample = _jax_fns()
    keys = jax.random.wrap_key_data(jnp.asarray(kd.astype(np.uint32)))
    args = (jnp.asarray(temps, jnp.float32), jnp.asarray(tks, jnp.int32),
            jnp.asarray(tps, jnp.float32))
    carry, tok = step(jnp.asarray(logits, jnp.float32), keys, *args)
    use = jax.vmap(lambda k: jax.random.split(k, 2))(keys)[:, 1]
    tok_use = sample(jnp.asarray(logits, jnp.float32), use, *args)
    return _kd(carry), np.asarray(tok), np.asarray(tok_use)


def _t(logits, kd, temps, tks, tps):
    return (torch.from_numpy(np.asarray(logits, np.float32)), torch.from_numpy(kd),
            torch.tensor(temps, dtype=torch.float32), torch.tensor(tks, dtype=torch.int32),
            torch.tensor(tps, dtype=torch.float32))


# -- the kernels' transcript ------------------------------------------------


def _better(v, i, bv, bi) -> bool:
    """``csrc/sampling.cu``'s rule: NaN first, then larger, then lower index."""
    vn, bn = bool(np.isnan(v)), bool(np.isnan(bv))
    if vn != bn:
        return vn
    if not vn and v != bv:
        return v > bv
    return i < bi


def _best(pairs):
    bv, bi = np.float32(-np.inf), 2**31 - 1
    for v, i in pairs:
        if _better(v, i, bv, bi):
            bv, bi = v, i
    return bv, bi


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """``warp_sum`` over the last axis (32 lanes): lane i adds lane i + off
    for off = 16 .. 1; lane 0's value."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _gumbel_at(use: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """``gumbel_of(threefry(use, (0, rank)))`` for the given ranks only."""
    a, b = TP.threefry2x32(use[0], use[1], torch.zeros_like(ranks), ranks)
    f = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(f * 1.0 + tiny, min=tiny)))


def _prep_row(x: torch.Tensor, temp: torch.Tensor):
    """The prep kernel on one row: (negated scaled values, [(greedy value,
    index, m, z)] a block).  A block's thread t holds positions lo + j *
    THREADS + t; z adds a thread's items in j order, then ``warp_sum``,
    then the warps in order."""
    v = x.shape[0]
    chunk, splits = TSS.sample_plan(v)
    t = torch.clamp(temp, min=1e-6)
    scaled = x / t
    pad = splits * chunk - v
    s = torch.cat([scaled, torch.full((pad,), -np.inf)]).view(splits, TSS.ITEMS, TSS.THREADS)
    valid = (torch.arange(splits * chunk) < v).view(splits, TSS.ITEMS, TSS.THREADS)
    m = torch.where(valid, s, torch.tensor(-np.inf)).amax(dim=(1, 2))  # NaN first
    z = torch.zeros((splits, TSS.THREADS))
    for j in range(TSS.ITEMS):
        e = torch.exp(s[:, j, :] - m[:, None])
        z = torch.where(valid[:, j, :], z + e, z)
    zw = _warp_sum(z.view(splits, TSS.THREADS // 32, 32))
    zb = zw[:, 0]
    for w in range(1, TSS.THREADS // 32):
        zb = zb + zw[:, w]
    parts = []
    for c in range(splits):
        blk = x[c * chunk:(c + 1) * chunk]
        i = int(torch.argmax(blk))  # NaN first, lowest index: better()'s rule
        parts.append((blk[i].numpy(), c * chunk + i, m[c], zb[c]))
    return -scaled, parts


def _draw_row(neg_sorted, order, parts, use, temp, k, p):
    """The draw kernel on one sampled row: the choice (a rank).  Chunk c's
    thread t holds ranks lo + 4t + j (ITEMS = 4)."""
    v = neg_sorted.shape[0]
    chunk, splits = TSS.sample_plan(v)
    keff = v if k <= 0 else k
    p = torch.clamp(torch.tensor(p, dtype=torch.float32), 0.0, 1.0)
    ms = torch.stack([q[2] for q in parts])
    M = ms.amax()
    lanes = torch.zeros(32)
    for j, q in enumerate(parts):
        if q[2] != -np.inf:
            lanes[j % 32] = lanes[j % 32] + q[3] * torch.exp(q[2] - M)
    Z = _warp_sum(lanes)
    s_all = -neg_sorted
    aggs, partials = [], []
    for c in range(splits):
        lo, rem = c * chunk, min(chunk, v - c * chunk)
        if lo >= keff:
            partials.append((NEG, lo))
            continue
        s = torch.cat([s_all[lo:lo + rem], torch.zeros(chunk - rem)]).view(TSS.THREADS, TSS.ITEMS)
        valid = (torch.arange(chunk) < rem).view(TSS.THREADS, TSS.ITEMS)
        x = torch.zeros((TSS.THREADS, TSS.ITEMS))
        run = torch.zeros(TSS.THREADS)
        for j in range(TSS.ITEMS):
            x[:, j] = run
            run = torch.where(valid[:, j], run + torch.exp(s[:, j] - M), run)
        inc = run.view(TSS.THREADS // 32, 32)
        for off in (1, 2, 4, 8, 16):
            inc = torch.cat([inc[:, :off], inc[:, off:] + inc[:, :-off]], dim=1)
        excl = torch.cat([torch.zeros(TSS.THREADS // 32, 1), inc[:, :-1]], dim=1)
        wpre, agg = torch.zeros(TSS.THREADS // 32), torch.zeros(())
        for w in range(TSS.THREADS // 32):
            wpre[w + 1:] = wpre[w + 1:] + inc[w, 31]
            agg = agg + inc[w, 31]
        aggs.append(agg)
        pre = torch.zeros(32)
        for j in range(c):
            pre[j % 32] = pre[j % 32] + aggs[j]
        P = _warp_sum(pre)
        tex = (wpre[:, None] + excl).reshape(TSS.THREADS, 1)
        mass = (P + (tex + x)) / Z
        ranks = lo + torch.arange(chunk).view(TSS.THREADS, TSS.ITEMS)
        kept = valid & (ranks < keff) & (mass < p)
        masked = valid & ~kept
        fm = int(ranks[masked].min()) if bool(masked.any()) else 2**31 - 1
        kr = ranks[kept]
        scores = s[kept] + _gumbel_at(use, kr.to(torch.int64))
        bv, bi = _best(zip(scores.numpy(), kr.tolist()))
        if fm != 2**31 - 1 and _better(NEG, fm, bv, bi):
            bv, bi = NEG, fm
        partials.append((bv, bi))
    return _best(partials)[1]


def _emulate(logits, keys, temps, tks, tps):
    """The two kernels and the sort, row by row: (carry, tokens int32)."""
    carry, use = TP.split_keys(keys)
    toks = []
    for b in range(logits.shape[0]):
        neg, parts = _prep_row(logits[b].to(torch.float32), temps[b])
        greedy = _best((q[0], q[1]) for q in parts)[1]
        if not bool(temps[b] > 0):
            toks.append(greedy)
            continue
        neg_sorted, order = torch.sort(neg, stable=True)
        choice = _draw_row(neg_sorted, order, parts, use[b], temps[b], int(tks[b]),
                           float(tps[b]))
        toks.append(int(order[choice]))
    return carry, torch.tensor(toks, dtype=torch.int32)


def _within_rule(logits, keys, temps, tks, tps, got, want) -> bool:
    """Every row of ``got`` equals ``want`` (the plain chain's tokens) or
    differs inside the rule: the plain scores at the two chosen ranks within
    GUMBEL_ULPS ulp, or the plain exclusive mass at one of them within P_TOL
    of p.  A greedy row must be equal."""
    _, use = TP.split_keys(keys)
    _, order, masked = TSS.filter_logits(logits, temps, tks, tps)
    t = torch.clamp(temps, min=1e-6)[:, None]
    sorted_logits = -torch.sort(-(logits.to(torch.float32) / t), dim=-1, stable=True)[0]
    probs = torch.softmax(sorted_logits, dim=-1)
    mass = torch.cumsum(probs, dim=-1) - probs
    scores = masked + TP.gumbel(use, (logits.shape[1],))
    for b in torch.nonzero(got != want).flatten().tolist():
        if not bool(temps[b] > 0):
            return False
        ca = int(torch.nonzero(order[b] == int(got[b]))[0, 0])
        cb = int(torch.nonzero(order[b] == int(want[b]))[0, 0])
        sa, sb = scores[b, ca].numpy(), scores[b, cb].numpy()
        ulp = np.spacing(np.maximum(np.abs(sa), np.abs(sb)).astype(np.float32))
        p = float(torch.clamp(tps[b], 0.0, 1.0))
        if abs(float(sa) - float(sb)) <= GUMBEL_ULPS * ulp:
            continue
        if min(abs(float(mass[b, ca]) - p), abs(float(mass[b, cb]) - p)) <= P_TOL:
            continue
        return False
    return True


def _check_all(logits, kd, temps, tks, tps):
    """JAX, the wrapper on the CPU and the kernels' transcript on the same
    inputs: carry keys equal everywhere, the wrapper's tokens equal JAX's,
    the transcript's equal or inside the rule.  Returns the tokens."""
    jcarry, jtok, jtok_use = _jax_step(logits, kd, temps, tks, tps)
    args = _t(logits, kd, temps, tks, tps)
    carry, tok = TS.sample_chain_step(*args)
    np.testing.assert_array_equal(carry.numpy(), jcarry)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_array_equal(jtok_use, jtok)
    assert tok.dtype == torch.int32 and carry.dtype == torch.int64
    ecarry, etok = _emulate(*args)
    assert torch.equal(ecarry, carry)
    assert _within_rule(*args, etok, tok), (etok.tolist(), tok.tolist())
    assert _within_rule(*args, etok, torch.from_numpy(jtok.astype(np.int32)))
    return tok.tolist()


# -- the transcript and the wrapper against JAX -------------------------------


@pytest.mark.parametrize("mix", MIXES, ids=lambda m: "T{}-k{}-p{}".format(*m))
@pytest.mark.parametrize("V", [16, 257, 32000])
@pytest.mark.parametrize("B", [1, 4, 5])
def test_kernels_transcript_and_wrapper_match_jax(B, V, mix):
    rng = np.random.default_rng(B * 1000 + V)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    kd = _kd(jax.random.split(jax.random.key(B + V), B))
    T, k, p = mix
    temps = [0.0 if b % 3 == 1 else T for b in range(B)]  # greedy rows among sampled
    toks = _check_all(logits, kd, temps, [k] * B, [p] * B)
    for b in range(B):
        if temps[b] == 0.0 or k == 1:
            assert toks[b] == int(np.argmax(logits[b]))
        elif k > 0:
            assert toks[b] in np.argsort(-logits[b], kind="stable")[:k]


# -- the JAX package's edge cases (tests/test_sampling.py) --------------------


LOGITS = np.asarray([[0.1, 3.0, 2.0, -1.0, 0.5],
                     [5.0, -2.0, 4.9, 0.0, 1.0],
                     [-3.0, -3.0, -2.0, -9.0, -2.5]], np.float32)
GREEDY = LOGITS.argmax(-1).tolist()


def _seed_keys(seeds, n=1):
    """Row i: the first of ``n`` keys split from ``key(seeds[i])``, as the
    JAX tests draw one row a seed."""
    return np.concatenate([_kd(jax.random.split(jax.random.key(s), n))[:1] for s in seeds])


def _rows(logits, n):
    return np.repeat(np.asarray(logits, np.float32), n, axis=0)


def test_temperature_zero_and_limit_equal_greedy():
    b = LOGITS.shape[0]
    kd = _kd(jax.random.split(jax.random.key(0), b))
    assert _check_all(LOGITS, kd, [0.0] * b, [0] * b, [1.0] * b) == GREEDY
    for seed in range(8):
        kd = _kd(jax.random.split(jax.random.key(seed), b))
        assert _check_all(LOGITS, kd, [1e-6] * b, [0] * b, [1.0] * b) == GREEDY


@pytest.mark.parametrize("temp", [0.5, 1.0, 10.0, 100.0])
def test_top_k_one_equals_greedy_at_any_temperature(temp):
    b = LOGITS.shape[0]
    for seed in range(4):
        kd = _kd(jax.random.split(jax.random.key(seed), b))
        assert _check_all(LOGITS, kd, [temp] * b, [1] * b, [1.0] * b) == GREEDY


def test_top_p_tiny_equals_greedy():
    b = LOGITS.shape[0]
    for seed in range(4):
        kd = _kd(jax.random.split(jax.random.key(seed), b))
        assert _check_all(LOGITS, kd, [10.0] * b, [0] * b, [1e-9] * b) == GREEDY


def test_top_p_boundary_keeps_smallest_covering_set():
    logits = np.log(np.asarray([[0.6, 0.4, 1e-9, 1e-9, 1e-9]], np.float32))
    kd = _seed_keys(range(64))
    below = _check_all(_rows(logits, 64), kd, [1.0] * 64, [0] * 64, [0.5] * 64)
    above = _check_all(_rows(logits, 64), kd, [1.0] * 64, [0] * 64, [0.95] * 64)
    assert set(below) == {0}
    assert set(above) == {0, 1}


def test_top_p_exact_tie_at_the_boundary():
    logits = np.asarray([[2.0, 2.0, -40.0, -40.0, -40.0]], np.float32)
    kd = _seed_keys(range(32))
    assert set(_check_all(_rows(logits, 32), kd, [1.0] * 32, [0] * 32, [0.5] * 32)) == {0}


def test_top_p_first_token_always_survives():
    logits = np.asarray([[2.0, 1.0, 0.0, -1.0, -2.0]], np.float32)
    assert _check_all(logits, _seed_keys([0]), [5.0], [0], [1e-30]) == [0]


def test_greedy_tie_is_deterministic_across_paths():
    logits = np.asarray([[1.5, 1.5, 0.0, 1.5, -1.0]] * 2, np.float32)
    assert _check_all(logits, _seed_keys([0, 0]), [0.0, 3.0], [0, 1], [1.0, 1.0]) == [0, 0]


def test_top_p_zero_and_all_masked_rows_take_the_top_rank():
    # p = 0 masks every rank (mass 0 is not < 0), so the draw takes rank 0;
    # so do rows whose softmax is NaN (all -inf, or +inf present), whatever
    # their filter.
    logits = np.asarray([[0.3, 2.0, 1.0, 2.0, -1.0],
                         [-np.inf] * 5,
                         [0.5, np.inf, 2.0, np.inf, -np.inf],
                         [0.5, np.inf, 2.0, np.inf, -np.inf]], np.float32)
    toks = _check_all(logits, _seed_keys(range(4)), [1.0, 1.0, 1.0, 0.0], [0, 0, 3, 0],
                      [0.0, 1.0, 0.9, 1.0])
    assert toks == [1, 0, 1, 1]


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_nan_and_infinite_logits_follow_the_reference(temp):
    # A NaN logit: greedy takes the first NaN (argmax's rule); a sampled
    # row's softmax is NaN everywhere, every rank is masked, and rank 0 is
    # the largest non-NaN logit (argsort(-scaled) puts NaN last).  -inf
    # logits take no mass and are never drawn while a finite one is kept.
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 257)) * 3).astype(np.float32)
    logits[0, [7, 100]] = np.nan
    logits[1, ::2] = -np.inf
    logits[2, 5] = np.nan
    logits[2, 6] = np.inf
    logits[3, 1:] = -np.inf
    toks = _check_all(logits, _seed_keys(range(4)), [temp] * 4, [0, 0, 40, 0],
                      [1.0, 0.9, 0.95, 0.5])
    finite = np.where(np.isnan(logits[0]), -np.inf, logits[0])
    assert toks[0] == (7 if temp == 0.0 else int(np.argmax(finite)))
    assert toks[1] % 2 == 1
    assert toks[3] == 0


# -- the plain split-and-draw, the plan, the refusals -------------------------


def _masked_case(rng, B, V):
    x = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    x[0] = -1e30  # a row masked everywhere
    x[1, 5:] = -1e30  # a top-k mask
    if B > 2:
        x[2] = 0.25  # a row of exact ties
    return x


@pytest.mark.parametrize("V", [16, 32000])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**63 - 1])
def test_plain_split_and_draw_matches_jax_random(V, seed):
    rng = np.random.default_rng(V + seed % 1000)
    masked = _masked_case(rng, 4, V)
    jkeys = jax.random.split(jax.random.key(seed), 4)
    carry, use = TP.split_keys(torch.from_numpy(_kd(jkeys)))
    choice = TP.categorical(use, torch.from_numpy(masked))
    pairs = jax.vmap(lambda k: jax.random.split(k, 2))(jkeys)
    jcarry, juse = pairs[:, 0], pairs[:, 1]
    g = jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(juse)
    jchoice = jnp.argmax(jnp.asarray(masked) + g, axis=-1)
    np.testing.assert_array_equal(carry.numpy(), _kd(jcarry))
    np.testing.assert_array_equal(use.numpy(), _kd(juse))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))
    assert choice.dtype == torch.int64 and int(choice[0]) == 0 and int(choice[1]) < 5


@pytest.mark.parametrize("V", [1, 16, 255, 256, 257, 1023, 1024, 1025, 4097, 32000, 32001,
                               128000, 128256])
def test_sample_plan_covers_every_position_once(V):
    chunk, splits = TSS.sample_plan(V)
    assert chunk == TSS.THREADS * TSS.ITEMS and (splits - 1) * chunk < V <= splits * chunk
    c = np.arange(splits)[:, None, None]
    j = np.arange(TSS.ITEMS)[None, :, None]
    t = np.arange(TSS.THREADS)[None, None, :]
    prep = (c * chunk + j * TSS.THREADS + t).ravel()  # the prep kernel's striped items
    draw = (c * chunk + t * TSS.ITEMS + j).ravel()  # the draw kernel's blocked ranks
    for pos in (prep, draw):
        np.testing.assert_array_equal(np.sort(pos[pos < V]), np.arange(V))


def _meta(b=2, v=8, **bad):
    args = dict(logits=torch.zeros((b, v), dtype=torch.float32, device="meta"),
                keys=torch.zeros((b, 2), dtype=torch.int64, device="meta"),
                temperature=torch.zeros((b,), dtype=torch.float32, device="meta"),
                top_k=torch.zeros((b,), dtype=torch.int32, device="meta"),
                top_p=torch.zeros((b,), dtype=torch.float32, device="meta"))
    args.update(bad)
    return args


@pytest.mark.parametrize("bad, match", [
    ({}, "unsupported device"),
    ({"logits": torch.zeros((2, 8), dtype=torch.float16, device="meta")}, "f32 or bf16"),
    ({"logits": torch.zeros((2, 16), device="meta")[:, ::2]}, "unit-stride"),
    ({"logits": torch.zeros((2, 8, 1), device="meta")}, r"\[B, V\]"),
    ({"keys": torch.zeros((2, 2), dtype=torch.int32, device="meta")}, "keys must be int64"),
    ({"keys": torch.zeros((3, 2), dtype=torch.int64, device="meta")}, "keys must be int64"),
    ({"temperature": torch.zeros((2,), dtype=torch.float64, device="meta")}, "temperature"),
    ({"top_k": torch.zeros((2,), dtype=torch.int64, device="meta")}, "top_k"),
    ({"top_p": torch.zeros((3,), dtype=torch.float32, device="meta")}, "top_p"),
    ({"top_p": torch.zeros((2,), dtype=torch.float32)}, "top_p"),
], ids=["meta", "f16", "strided", "rank3", "keys-i32", "keys-rows", "temp-f64", "topk-i64",
        "topp-rows", "topp-cpu"])
def test_sample_step_refuses_what_the_kernels_do_not_take(bad, match):
    x = torch.zeros((2, 8), dtype=torch.float32)
    keys = torch.zeros((2, 2), dtype=torch.int64)
    params = (torch.ones(2), torch.zeros(2, dtype=torch.int32), torch.ones(2))
    carry, tok = TSS.sample_step(x, keys, *params)  # the CPU takes the plain chain
    assert carry.shape == (2, 2) and tok.shape == (2,) and tok.dtype == torch.int32
    with pytest.raises(ValueError, match=match):
        TSS.sample_step(**_meta(**bad))
