"""The port's threefry PRNG and key-based sampling against ``jax.random``
and the JAX package's ``models/sampling.py``, on the CPU.

``key(seed)`` must give the key ``jax.random.key(seed)`` gives with 64-bit
integers disabled, as the JAX package serves, for the same seed.  The
other functions take key words and run with 64-bit integers enabled, as
the f64 engine tests run JAX.  Splits, folds, bits and uniforms must be
bit-identical.  Gumbels go through two ``log`` calls, each of which may
round one ulp apart between torch and XLA, so they must agree within 2
f32 ulp of ``max(|g|, 1)``.  Sampling draws must give the reference's
tokens exactly, for the same logits and the same key words
(``jax.random.key_data``).
"""

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
from tpumlops.models import sampling as JS

SEEDS = [0, 7, 2**31 - 1, 2**32 + 5, 2**63 - 1]
SHAPES = [(1,), (3, 7), (2, 256)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps this module from crowding tests that run
    beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _serving_key(seed: int):
    """``jax.random.key(seed)`` as the JAX package serves it (64-bit
    integers disabled), as a key usable with them enabled."""
    jax.config.update("jax_enable_x64", False)
    try:
        words = np.asarray(jax.random.key_data(jax.random.key(seed)))
    finally:
        jax.config.update("jax_enable_x64", True)
    return jax.random.wrap_key_data(jnp.asarray(words, dtype=jnp.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax_serving_key_for_the_same_seed(seed):
    """Every seed the server accepts, those of 2**32 and more included,
    gives the key a JAX replica derives from the same seed."""
    np.testing.assert_array_equal(TP.key(seed).numpy(), _kd(_serving_key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_match_jax(seed):
    jk = _serving_key(seed)
    # Keys with a nonzero high word too, which key(seed) never makes.
    for jkey in (jk, jax.random.key(seed)):
        tk = torch.from_numpy(_kd(jkey))
        for num in (2, 3, 8):
            np.testing.assert_array_equal(TP.split(tk, num).numpy(),
                                          _kd(jax.random.split(jkey, num)))
        for data in (0, 1, 12345, 2**32 - 1):
            np.testing.assert_array_equal(TP.fold_in(tk, data).numpy(),
                                          _kd(jax.random.fold_in(jkey, data)))
    # A batch of keys at once, as the engine splits every slot's key.
    batch = jax.random.split(jk, 4)
    carry, use = TS.split_keys(torch.from_numpy(_kd(batch)))
    jc, ju = JS.split_keys(batch)
    np.testing.assert_array_equal(carry.numpy(), _kd(jc))
    np.testing.assert_array_equal(use.numpy(), _kd(ju))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_draws_what_jax_random_categorical_draws(seed):
    """``categorical`` (the plain draw of the sampled chain and of the
    fused sampling kernel's plain version) picks each row's
    ``jax.random.categorical`` token, masked slots included."""
    keys = jax.random.split(_serving_key(seed), 4)
    logits = np.random.default_rng(seed % 2**32).normal(size=(4, 1000)).astype(np.float32) * 3
    logits[1, 20:] = -1e30
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
    got = TP.categorical(torch.from_numpy(_kd(keys)), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed, shape):
    jk = _serving_key(seed)
    want = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(TP.random_bits(TP.key(seed), shape).numpy(), want)
    # Row b of a batch of keys draws what key b draws alone.
    keys = jax.random.split(jk, 3)
    rows = TP.random_bits(torch.from_numpy(_kd(keys)), shape).numpy()
    for b in range(3):
        ref = np.asarray(jax.random.bits(keys[b], shape, dtype=jnp.uint32))
        np.testing.assert_array_equal(rows[b], ref.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal_and_gumbel_within_2_ulp(seed):
    jk, tk = _serving_key(seed), TP.key(seed)
    shape = (4, 32000)
    ju = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32))
    tu = TP.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    tiny = np.finfo(np.float32).tiny
    ju = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32, minval=tiny))
    tu = TP.uniform(tk, shape, minval=tiny).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    jg = np.asarray(jax.random.gumbel(jk, shape, dtype=jnp.float32))
    tg = TP.gumbel(tk, shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert np.all(np.abs(tg - jg) <= 2 * ulp)


_j_sample = jax.jit(JS.sample_logits)
_j_chain = jax.jit(JS.sample_chain_step)


def _sampling_case(rng, B, V):
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[0, 3] = logits[0, 11] = logits[0].max() + 1.0  # a tie at the top
    temp = rng.choice([0.0, 0.6, 1.0, 1.4], B).astype(np.float32)
    temp[0], temp[1] = 0.0, 0.8  # a greedy and a sampled row always
    top_k = rng.choice([0, 1, 5, 40], B).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5], B).astype(np.float32)
    return logits, temp, top_k, top_p


@pytest.mark.parametrize("B,V", [(4, 64), (6, 1000)])
def test_sample_logits_draws_the_reference_tokens(B, V):
    rng = np.random.default_rng(B * V)
    logits, temp, top_k, top_p = _sampling_case(rng, B, V)
    targs = (torch.from_numpy(temp), torch.from_numpy(top_k), torch.from_numpy(top_p))
    jargs = (jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p))
    sampled = set()
    for seed in range(24):
        keys = jax.random.split(jax.random.key(seed), B)
        want = np.asarray(_j_sample(jnp.asarray(logits), keys, *jargs))
        got = TS.sample_logits(torch.from_numpy(logits), torch.from_numpy(_kd(keys)),
                               *targs).numpy()
        np.testing.assert_array_equal(got, want)
        sampled.add(int(got[1]))
    assert len(sampled) > 1  # the sampled row really draws


def test_sample_chain_step_matches_the_reference():
    rng = np.random.default_rng(3)
    B, V = 5, 300
    logits, temp, top_k, top_p = _sampling_case(rng, B, V)
    jkeys = jax.random.split(jax.random.key(99), B)
    tkeys = torch.from_numpy(_kd(jkeys))
    for _step in range(6):
        jkeys, jt = _j_chain(jnp.asarray(logits), jkeys, jnp.asarray(temp),
                             jnp.asarray(top_k), jnp.asarray(top_p))
        tkeys, tt = TS.sample_chain_step(torch.from_numpy(logits), tkeys,
                                         torch.from_numpy(temp), torch.from_numpy(top_k),
                                         torch.from_numpy(top_p))
        np.testing.assert_array_equal(tkeys.numpy(), _kd(jkeys))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("S", [1, 2, 5])
def test_speculative_accept_matches_the_reference(S):
    rng = np.random.default_rng(S)
    B = 8
    greedy = rng.integers(0, 6, (B, S)).astype(np.int32)
    tokens = rng.integers(0, 6, (B, S)).astype(np.int32)
    # Drafts that agree with greedy for a random prefix length.
    for b in range(B):
        agree = rng.integers(0, S)
        tokens[b, 1:1 + agree] = greedy[b, :agree]
    draft_len = rng.integers(0, S, B).astype(np.int32)
    ja, jn = JS.speculative_accept(jnp.asarray(tokens), jnp.asarray(greedy),
                                   jnp.asarray(draft_len))
    ta, tn = TS.speculative_accept(torch.from_numpy(tokens), torch.from_numpy(greedy),
                                   torch.from_numpy(draft_len))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert ta.dtype == tn.dtype == torch.int32
