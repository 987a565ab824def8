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
