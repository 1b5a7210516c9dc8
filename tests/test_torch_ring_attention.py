"""Ring attention and the flash kernel's log-sum-exp in the port against
the JAX package, on the CPU.

- The plain flash with ``return_lse=True`` against an f64 log-sum-exp of
  the scores, causal or not, with a query offset, grouped K/V heads, a key
  bias and rows with no visible key (``kv_len`` 0: ``-inf``), and against
  ``flash_attention_reference``'s own output (unchanged by the flag).
- ``ring_attention`` at sp 2 and 4 (spawned gloo worlds, ``torch_world``),
  causal and not, grouped K/V heads, a prompt padded to a length the ring
  splits: the plain ring (the reference's online softmax, f64) against the
  JAX ``ring_attention_sharded`` on the host mesh in f64 (``RING_F64_TOL``),
  and the ring through the plain flash with its log-sum-exp (the card's
  path; the plain flash's softmax is f32) within ``RING_FLASH_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world as W
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (  # noqa: E501
    flash_attention as fa,
)
from tpumlops.models.partition import build_serving_mesh
from tpumlops.ops.ring_attention import ring_attention_sharded

RING_F64_TOL = dict(rtol=1e-12, atol=1e-13)  # the same f64 online softmax
RING_FLASH_TOL = dict(rtol=1e-5, atol=1e-6)  # each block's softmax in f32
LSE_F64_TOL = dict(rtol=1e-12, atol=1e-12)
LSE_F32_TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _lse_f64(q, k, causal, kv_len, q_offset, bias, scale):
    """log-sum-exp of the visible keys' scores in numpy f64."""
    b, h, s, d = q.shape
    nkv, t = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), h // nkv, axis=1)
    sc = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) * scale
    if bias is not None:
        sc = sc + bias.astype(np.float64)[:, None, None, :]
    valid = np.ones((s, t), bool)
    if kv_len is not None:
        valid &= np.arange(t)[None, :] < kv_len
    if causal:
        valid &= np.arange(t)[None, :] <= (q_offset + np.arange(s))[:, None]
    sc = np.where(valid, sc, -np.inf)
    mx = sc.max(-1, keepdims=True)
    safe = np.where(np.isfinite(mx), mx, 0.0)
    with np.errstate(divide="ignore"):
        return (safe + np.log(np.exp(sc - safe).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", [
    dict(causal=False, kv_len=None, q_offset=0, bias=False, s=24, t=24),
    dict(causal=True, kv_len=None, q_offset=0, bias=False, s=24, t=24),
    dict(causal=True, kv_len=30, q_offset=16, bias=False, s=8, t=40),
    dict(causal=False, kv_len=7, q_offset=0, bias=True, s=5, t=19),
    dict(causal=False, kv_len=0, q_offset=0, bias=False, s=6, t=10),
    dict(causal=True, kv_len=0, q_offset=3, bias=False, s=4, t=10),
], ids=["dense", "causal", "offset_kvlen", "bias_kvlen", "no_key", "no_key_causal"])
def test_plain_flash_lse_matches_an_f64_logsumexp(dtype, case):
    """The log-sum-exp a row reports is that of its visible keys' scaled
    scores; a row with none (kv_len 0) reports -inf and keeps its output
    (the mean of V); the output is the one ``return_lse=False`` gives."""
    rng = np.random.default_rng(3)
    s, t, h, nkv, d = case["s"], case["t"], 4, 2, 16
    q = rng.standard_normal((2, h, s, d))
    k = rng.standard_normal((2, nkv, t, d))
    v = rng.standard_normal((2, nkv, t, d))
    bias = rng.standard_normal((2, t)).astype(np.float32) if case["bias"] else None
    scale = 0.3
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    tb = torch.from_numpy(bias) if bias is not None else None
    kw = dict(causal=case["causal"], kv_len=case["kv_len"], scale=scale, bias=tb,
              q_offset=case["q_offset"])
    out, lse = fa.flash_attention(tq, tk, tv, return_lse=True, **kw)
    assert lse.shape == (2, h, s) and lse.dtype == dtype
    torch.testing.assert_close(out, fa.flash_attention_reference(tq, tk, tv, **kw),
                               rtol=0, atol=0)
    want = _lse_f64(tq.double().numpy(), tk.double().numpy(), case["causal"],
                    case["kv_len"], case["q_offset"], bias, scale)
    tol = LSE_F64_TOL if dtype == torch.float64 else LSE_F32_TOL
    np.testing.assert_allclose(lse.double().numpy(), want, **tol)
    if case["kv_len"] == 0:
        assert np.isneginf(lse.numpy()).all()
        mean_v = np.repeat(tv.double().numpy(), h // nkv, axis=1).mean(axis=2, keepdims=True)
        np.testing.assert_allclose(out.double().numpy(), np.broadcast_to(mean_v, out.shape),
                                   rtol=1e-6, atol=1e-6)


def test_lse_refusals_stay_those_of_the_kernel():
    """``return_lse`` adds no path around the wrapper's checks: an offset
    chunk past the keys still raises."""
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 2, 6, 16)
    with pytest.raises(ValueError, match="outside the"):
        fa.flash_attention(q, k, k, causal=True, q_offset=4, return_lse=True)


# -- the ring ----------------------------------------------------------------------


def _cases():
    """(q, k, v, causal, real rows) global f64 inputs: GQA heads (4 query,
    2 K/V), 32 positions; the last case holds 27 real rows and a padded
    tail of large garbage, which no real row may see under causal."""
    rng = np.random.default_rng(11)
    b, h, nkv, s, d = 1, 4, 2, 32, 8
    out = []
    for causal in (True, False):
        q = rng.standard_normal((b, h, s, d))
        k = rng.standard_normal((b, nkv, s, d))
        v = rng.standard_normal((b, nkv, s, d))
        out.append((q, k, v, causal, s))
    L = 27
    q, k, v = (rng.standard_normal((b, n, s, d)) for n in (h, nkv, nkv))
    for x in (q, k, v):
        x[:, :, L:] = 1e3 * rng.standard_normal(x[:, :, L:].shape)
    out.append((q, k, v, True, L))
    return out


_RING: dict = {}


def _ring_world(sp):
    if sp not in _RING:
        cases = [(q, k, v, causal) for q, k, v, causal, _ in _cases()]
        _RING[sp] = W.run(W.ring_case, sp, cases, timeout=120)
    return _RING[sp]


def _jax_ring(sp, q, k, v, causal):
    """The JAX ring on its host mesh, in f64; it takes matching heads, so
    the K/V heads are repeated for it."""
    g = q.shape[1] // k.shape[1]
    mesh = build_serving_mesh({"sp": sp})
    out = ring_attention_sharded(jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=1)),
                                 jnp.asarray(np.repeat(v, g, axis=1)), mesh, causal=causal)
    return np.asarray(out)


@pytest.mark.parametrize("case", [0, 1, 2], ids=["causal", "full", "padded"])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_the_jax_ring(sp, case):
    q, k, v, causal, real = _cases()[case]
    want = _jax_ring(sp, q, k, v, causal)
    for r, got in enumerate(_ring_world(sp)):
        got = got[case]
        np.testing.assert_allclose(got["plain"][:, :, :real], want[:, :, :real],
                                   **RING_F64_TOL, err_msg=f"rank {r} plain")
        np.testing.assert_allclose(got["flash"][:, :, :real], want[:, :, :real],
                                   **RING_FLASH_TOL, err_msg=f"rank {r} flash")
        # every rank gathers the same whole output
        np.testing.assert_array_equal(got["plain"], _ring_world(sp)[0][case]["plain"])


def test_a_ring_of_one_is_plain_attention():
    """No group (sp 1): one block, the diagonal; the flash path is then one
    flash call and the plain ring the reference's single step."""
    from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.ops import (  # noqa: E501
        ring_attention as R,
    )

    q, k, v, causal, _ = _cases()[0]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = _jax_ring(1, q, k, v, causal)
    np.testing.assert_allclose(R.ring_attention(tq, tk, tv, None, causal).numpy(), want,
                               **RING_F64_TOL)
    np.testing.assert_allclose(R.ring_attention_flash(tq, tk, tv, None, causal).numpy(), want,
                               **RING_FLASH_TOL)
    with pytest.raises(ValueError, match="shards disagree"):
        R.ring_attention(tq, tk[:, :, :5], tv[:, :, :5], None, causal)
