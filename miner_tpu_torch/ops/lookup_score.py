"""Fused cache lookup + candidate scoring, forward: CUDA kernel + plain.

Counterpart of ``miner_tpu/ops/lookup_score.py:lookup_score_fused``: given a
(N, D) news-embedding cache, (B, C) candidate rows and (B, K, D) interests,
the per-interest scores (B, C, K), without building the (B, C, D) gather.

The kernel is ``csrc/lookup_score_fwd.cu``. It reads the cache in its own
type (float32 or bfloat16), accumulates in fp32 and writes the interests'
type, as the TPU kernel's fp32 route does. :func:`plan` names its route: a
bfloat16 cache with bfloat16 interests and D a multiple of 16 runs on the
tensor cores (both 16-byte aligned), every other pair on the CUDA cores;
neither falls back to the plain version. The int8 cache (``Int8Rows``) is
not ported yet. The op has no gradient, in the JAX package either: on the
card it raises when an input requires grad under grad mode, so a gradient
is never dropped quietly.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from miner_tpu_torch.ops import common

TILE = 64  # candidates a tile, as in the kernel
MAX_RUN = 16  # the most tiles a block scores
SM_SMEM = 228 * 1024  # shared memory of an SM (H100), 1 KB of it kept per block
_MAX_SMEM = 227 * 1024
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)


@functools.lru_cache(maxsize=None)
def _smem_bytes(K: int, D: int, cache_code: int, interests_code: int, tiles: int) -> int:
    """Shared memory a block of the kernel takes at these shapes, types and
    run of tiles, from the kernel's own layout."""
    return common.kernel_function(
        "lookup_score_fwd", "lookup_score_smem_bytes", (ctypes.c_int,) * 5,
        ctypes.c_longlong)(K, D, cache_code, interests_code, tiles)


def plan(B: int, C: int, K: int, D: int, cache_dtype: torch.dtype,
         interests_dtype: torch.dtype, sms: int = 132):
    """(route, tiles a block, shared-memory bytes a block) of a launch on a
    card of ``sms`` SMs: "tensor_core" for a bfloat16 cache and bfloat16
    interests with D a multiple of 16, else "cuda_core". A block's run of
    tiles is the shortest (up to :data:`MAX_RUN`) that makes the grid about
    one wave of the blocks the SMs hold. Raises on a type the kernel does
    not take or shapes that do not fit in shared memory."""
    for what, dt in (("cache", cache_dtype), ("interests", interests_dtype)):
        if dt not in common.DTYPE_CODES:
            raise TypeError(f"{what} has dtype {dt}, expected one of "
                            f"{list(common.DTYPE_CODES)}")
    tensor_core = (cache_dtype == interests_dtype == torch.bfloat16
                   and D % 16 == 0)
    size = lambda n: _smem_bytes(K, D, common.DTYPE_CODES[cache_dtype],
                                 common.DTYPE_CODES[interests_dtype], n)
    ntiles = -(-C // TILE)
    per_sm = max(1, SM_SMEM // (size(MAX_RUN) + 1024))
    tiles = min(MAX_RUN, ntiles, max(1, -(-B * ntiles // (per_sm * sms))))
    smem = size(tiles)
    if smem > _MAX_SMEM:
        raise ValueError(f"lookup shapes K={K}, D={D} need {smem} bytes of "
                         f"shared memory per block, more than {_MAX_SMEM}")
    return ("tensor_core" if tensor_core else "cuda_core"), tiles, smem


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lookup_score_reference(cache: torch.Tensor, cand_idx: torch.Tensor,
                           interests: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, then an fp32 product. A candidate whose
    index lies outside [0, N) scores NaN, as in the kernel. Past N that is
    what the JAX package's ``jnp.take`` gives; a negative index it wraps
    instead (ROADMAP Queue 3)."""
    N = cache.shape[0]
    idx = cand_idx.clamp(0, N - 1)
    cand = cache.index_select(0, idx.reshape(-1)).reshape(*cand_idx.shape, cache.shape[1])
    out = torch.einsum("bcd,bkd->bck", cand.float(), interests.float())
    # in place, and no test of the indices on the host: a card would wait for it
    out.masked_fill_((idx != cand_idx)[..., None], float("nan"))
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
    return _launch(cache, cand_idx, interests)


def _launch(cache, cand_idx, interests) -> torch.Tensor:
    common.require_cuda(cache, "lookup_score_fused")
    N, D = cache.shape
    B, C = cand_idx.shape
    K = interests.shape[1]
    if torch.is_grad_enabled() and (cache.requires_grad or interests.requires_grad):
        raise RuntimeError("lookup_score_fused has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    dev = cache.device
    common.check_tensor("cache", cache, dev, tuple(common.DTYPE_CODES))
    common.check_tensor("cand_idx", cand_idx, dev, (torch.int32,))
    common.check_tensor("interests", interests, dev, tuple(common.DTYPE_CODES))
    route, tiles, _ = plan(B, C, K, D, cache.dtype, interests.dtype, _sms(dev.index))
    if route == "tensor_core":  # 16-byte copies of rows and interests
        common.check_aligned("cache", cache)
        common.check_aligned("interests", interests)
    out = torch.empty((B, C, K), dtype=interests.dtype, device=dev)
    fn = common.kernel_function("lookup_score_fwd", "lookup_score_fwd", _ARGTYPES)
    common.launch("lookup_score_fwd", fn, cache.data_ptr(), cand_idx.data_ptr(),
                  interests.data_ptr(), out.data_ptr(), N, B, C, K, D,
                  common.DTYPE_CODES[cache.dtype],
                  common.DTYPE_CODES[interests.dtype], tiles, dev.index,
                  common.stream_of(cache))
    lookup_score_fused.launches += 1
    return out


lookup_score_fused.launches = 0
