"""The port's four serving-path ops against the JAX package's Pallas kernels.

Each op of ``miner_tpu_torch.ops`` takes its plain PyTorch version for a CPU
tensor; here it is held against the JAX Pallas kernel it replaces, run in
interpret mode on the same numpy inputs, in float32. The tolerances are
float32 summation-order noise (about 1e-5 of the values' scale). The CUDA
kernels themselves are held against these plain versions on a card in
``test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from miner_tpu.ops.add_ln import fused_dropout_add_ln as jax_add_ln
from miner_tpu.ops.lookup_score import lookup_score_fused as jax_lookup_score
from miner_tpu.ops.mha import fused_mha as jax_fused_mha
from miner_tpu.ops.poly_attention import poly_attention_fused as jax_poly
from miner_tpu_torch.ops import (
    fused_dropout_add_ln,
    fused_mha,
    lookup_score_fused,
    poly_attention_fused,
)

T = torch.from_numpy


def _mha_inputs(rng, N=3, L=32, H=2, Dh=32):
    qkv = (rng.normal(size=(N, L, 3 * H * Dh)) * 0.5).astype(np.float32)
    mask = np.ones((N, L), np.int32)
    mask[1, 20:] = 0  # padded keys
    mask[2, :] = 0  # a fully masked row: the mean of V, never NaN
    return qkv, mask, H


@pytest.mark.parametrize("seqs", [1, 4])
def test_mha_matches_pallas_kernel(rng, seqs):
    qkv, mask, H = _mha_inputs(rng)
    want = np.asarray(jax_fused_mha(jnp.asarray(qkv), jnp.asarray(mask),
                                    jnp.zeros((1,), jnp.int32), H, 0.0, True,
                                    seqs))
    got = fused_mha(T(qkv), T(mask), H, 0.0, seqs).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mha_fully_masked_row_is_mean_of_values(rng):
    qkv, mask, H = _mha_inputs(rng)
    got = fused_mha(T(qkv), T(mask), H).numpy()
    D = qkv.shape[-1] // 3
    mean_v = qkv[2, :, 2 * D:].mean(axis=0)
    np.testing.assert_allclose(got[2], np.broadcast_to(mean_v, got[2].shape),
                               rtol=1e-5, atol=1e-6)


def test_add_ln_matches_pallas_kernel(rng):
    Tn, D = 24, 64
    x = rng.normal(size=(Tn, D)).astype(np.float32)
    h = rng.normal(size=(Tn, D)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    want = np.asarray(jax_add_ln(jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(scale), jnp.asarray(bias),
                                 jnp.zeros((1,), jnp.int32), 0.0, 1e-5, True))
    got = fused_dropout_add_ln(T(x), T(h), T(scale), T(bias), 0.0, 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_bias", [True, False])
def test_poly_attention_matches_pallas_kernel(rng, with_bias):
    B, H, D, P, K = 4, 10, 32, 24, 6
    emb = rng.normal(size=(B, H, D)).astype(np.float32)
    w = (rng.normal(size=(D, P)) * 0.1).astype(np.float32)
    codes = (rng.normal(size=(K, P)) * 0.1).astype(np.float32)
    mask = (rng.random((B, H)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    bias = (rng.normal(size=(B, H)) * 0.1).astype(np.float32) if with_bias else None
    want = np.asarray(jax_poly(jnp.asarray(emb), jnp.asarray(w),
                               jnp.asarray(codes), jnp.asarray(mask),
                               None if bias is None else jnp.asarray(bias), True))
    got = poly_attention_fused(T(emb), T(w), T(codes), T(mask),
                               None if bias is None else T(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lookup_score_matches_pallas_kernel(rng):
    # D = 128 so the JAX package takes its Pallas kernel (its per-row DMA
    # needs the 128-lane tile); C = 13 is no multiple of the kernel's 8
    N, D, B, C, K = 40, 128, 3, 13, 5
    cache = rng.normal(size=(N, D)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, C)).astype(np.int32)
    interests = rng.normal(size=(B, K, D)).astype(np.float32)
    want = np.asarray(jax_lookup_score(jnp.asarray(cache), jnp.asarray(idx),
                                       jnp.asarray(interests), interpret=True))
    got = lookup_score_fused(T(cache), T(idx), T(interests)).numpy()
    assert got.shape == (B, C, K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_lookup_score_rows_past_the_cache_are_nan_as_in_jax(rng):
    """An index at or past N scores NaN in the port's plain version, as the
    JAX reference's ``jnp.take`` fills it; the other rows agree."""
    N, D, B, C, K = 30, 16, 2, 6, 3
    cache = rng.normal(size=(N, D)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, C)).astype(np.int32)
    idx[0, 1], idx[1, 4] = N, N + 7
    interests = rng.normal(size=(B, K, D)).astype(np.float32)
    want = np.asarray(jax_lookup_score(jnp.asarray(cache), jnp.asarray(idx),
                                       jnp.asarray(interests)))
    got = lookup_score_fused(T(cache), T(idx), T(interests)).numpy()
    assert np.isnan(want[0, 1]).all() and np.isnan(want[1, 4]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # NaN where NaN


# ------------------------------------------------------------- backwards
# The port's plain backward formulas against the Pallas backward kernels
# (interpret mode) and, for poly-attention, against jax.grad through the
# JAX package's custom_vjp. Rate 0: the TPU's dropout bits cannot be
# reproduced (test_torch_kernels.py tests the port's dropout). Tolerance:
# float32 summation-order noise, 1e-5 of the values' scale.

from miner_tpu.ops.add_ln import _call_bwd as jax_add_ln_bwd  # noqa: E402
from miner_tpu.ops.mha import _call_bwd as jax_mha_bwd  # noqa: E402
from miner_tpu_torch.ops import add_ln, mha  # noqa: E402


@pytest.mark.parametrize("seqs", [1, 4])
def test_mha_backward_matches_pallas_kernel(rng, seqs):
    """Padded keys, and a fully masked row (sequence 2)."""
    qkv, mask, H = _mha_inputs(rng)
    dout = rng.normal(size=qkv.shape[:2] + (qkv.shape[2] // 3,)).astype(np.float32)
    want = np.asarray(jax_mha_bwd(jnp.asarray(qkv), jnp.asarray(mask),
                                  jnp.zeros((1,), jnp.int32), jnp.asarray(dout),
                                  H, 0.0, True, seqs))
    got = mha.mha_backward(T(qkv), T(mask), T(dout), H, 0.0, 0, seqs).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mha_fully_masked_row_gradient_reaches_masked_values(rng):
    """A fully masked row has a uniform P over all L keys, so every key's
    dV, masked or not, is the mean of dO over the queries, as in JAX."""
    qkv, mask, H = _mha_inputs(rng)
    N, L, D3 = qkv.shape
    D = D3 // 3
    dout = rng.normal(size=(N, L, D)).astype(np.float32)
    dv = mha.mha_backward(T(qkv), T(mask), T(dout), H).numpy()[2, :, 2 * D:]
    np.testing.assert_allclose(dv, np.broadcast_to(dout[2].mean(0), dv.shape),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(dv).max() > 0


def test_add_ln_backward_matches_pallas_kernel(rng):
    """24 rows: the JAX kernel blocks rows by multiples of 8."""
    Tn, D = 24, 64
    x, h, dy = (rng.normal(size=(Tn, D)).astype(np.float32) for _ in range(3))
    scale = (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    want = jax_add_ln_bwd(jnp.asarray(x), jnp.asarray(h), jnp.asarray(scale),
                          jnp.zeros((1,), jnp.int32), jnp.asarray(dy), 0.0, 1e-5,
                          True)
    got = add_ln.add_ln_backward(T(x), T(h), T(scale), T(dy), 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_add_ln_backward_takes_any_row_count(rng):
    """13 rows (no multiple of 8, which the port does not need): the
    formulas equal autograd of the plain forward."""
    x, h, dy = (torch.from_numpy(rng.normal(size=(13, 48)).astype(np.float32))
                for _ in range(3))
    leaves = [x.clone().requires_grad_(), h.clone().requires_grad_(),
              torch.from_numpy((1 + 0.1 * rng.normal(size=48)).astype(np.float32)
                               ).requires_grad_(),
              torch.zeros(48, requires_grad=True)]
    add_ln.add_ln_reference(*leaves, 1e-5).backward(dy)
    got = add_ln.add_ln_backward(x, h, leaves[2].detach(), dy, 1e-5)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_bias", [True, False])
def test_poly_attention_gradients_match_jax(rng, with_bias):
    """Gradients of emb, W, codes (and the bias, through which the category
    embedding trains) against jax.grad of the JAX package's fused op."""
    import jax

    B, H, D, P, K = 4, 10, 32, 24, 6
    emb = rng.normal(size=(B, H, D)).astype(np.float32)
    w = (rng.normal(size=(D, P)) * 0.1).astype(np.float32)
    codes = (rng.normal(size=(K, P)) * 0.1).astype(np.float32)
    mask = (rng.random((B, H)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    bias = (rng.normal(size=(B, H)) * 0.1).astype(np.float32)
    weight = rng.normal(size=(B, K, D)).astype(np.float32)
    args = [emb, w, codes] + ([bias] if with_bias else [])

    def loss(*a):
        b = a[3] if with_bias else None
        return jnp.sum(jax_poly(a[0], a[1], a[2], jnp.asarray(mask), b, True) * weight)

    want = jax.grad(loss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    leaves = [T(a).requires_grad_() for a in args]
    out = poly_attention_fused(leaves[0], leaves[1], leaves[2], T(mask),
                               leaves[3] if with_bias else None)
    (out * T(weight)).sum().backward()
    for leaf, w_ in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w_),
                                   rtol=1e-5, atol=1e-5)
