"""Fused cache lookup + candidate scoring, forward: CUDA kernel + plain.

Counterpart of ``miner_tpu/ops/lookup_score.py:lookup_score_fused``: given a
(N, D) news-embedding cache, (B, C) candidate rows and (B, K, D) interests,
the per-interest scores (B, C, K), without building the (B, C, D) gather.

The kernel is ``csrc/lookup_score_fwd.cu``. It reads the cache in its own
type (float32 or bfloat16), accumulates in fp32 and writes the interests'
type, as the TPU kernel's fp32 route does. The int8 cache (``Int8Rows``) is
not ported yet. The op has no gradient, in the JAX package either: on the
card it raises when an input requires grad under grad mode, so a gradient
is never dropped quietly.
"""
from __future__ import annotations

import ctypes

import torch

from miner_tpu_torch.ops import common

_TILE = 64  # candidates per block, as in the kernel
_MAX_SMEM = 227 * 1024
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def lookup_score_reference(cache: torch.Tensor, cand_idx: torch.Tensor,
                           interests: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, then an fp32 product."""
    cand = cache.index_select(0, cand_idx.reshape(-1)).reshape(
        *cand_idx.shape, cache.shape[1])
    out = torch.einsum("bcd,bkd->bck", cand.float(), interests.float())
    return out.to(interests.dtype)


def lookup_score_fused(cache: torch.Tensor, cand_idx: torch.Tensor,
                       interests: torch.Tensor) -> torch.Tensor:
    """(B, C, K) scores. A CPU tensor takes :func:`lookup_score_reference`;
    a CUDA tensor launches the kernel (cache and interests float32 or
    bfloat16, cand_idx int32) or raises."""
    if cache.dim() != 2 or cand_idx.dim() != 2 or interests.dim() != 3:
        raise ValueError("cache must be (N, D), cand_idx (B, C), interests (B, K, D)")
    N, D = cache.shape
    B, C = cand_idx.shape
    K = interests.shape[1]
    if tuple(interests.shape) != (B, K, D):
        raise ValueError(f"interests has shape {tuple(interests.shape)}, "
                         f"expected {(B, K, D)}")
    if cache.device.type == "cpu":
        return lookup_score_reference(cache, cand_idx, interests)
    common.require_cuda(cache, "lookup_score_fused")
    if torch.is_grad_enabled() and (cache.requires_grad or interests.requires_grad):
        raise RuntimeError("lookup_score_fused has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    dev = cache.device
    common.check_tensor("cache", cache, dev, tuple(common.DTYPE_CODES))
    common.check_tensor("cand_idx", cand_idx, dev, (torch.int32,))
    common.check_tensor("interests", interests, dev, tuple(common.DTYPE_CODES))
    smem = 4 * K * (D + 1) + cache.element_size() * _TILE * D
    if smem > _MAX_SMEM:
        raise ValueError(f"lookup shapes need {smem} bytes of shared memory "
                         f"per block, more than {_MAX_SMEM}")
    out = torch.empty((B, C, K), dtype=interests.dtype, device=dev)
    fn = common.kernel_function("lookup_score_fwd", "lookup_score_fwd", _ARGTYPES)
    common.launch("lookup_score_fwd", fn, cache.data_ptr(), cand_idx.data_ptr(),
                  interests.data_ptr(), out.data_ptr(), N, B, C, K, D,
                  common.DTYPE_CODES[cache.dtype],
                  common.DTYPE_CODES[interests.dtype], dev.index,
                  common.stream_of(cache))
    lookup_score_fused.launches += 1
    return out


lookup_score_fused.launches = 0
