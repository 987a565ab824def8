"""Fused cache lookup + candidate scoring, forward: CUDA kernel + plain.

Counterpart of ``miner_tpu/ops/lookup_score.py:lookup_score_fused``: given a
(N, D) news-embedding cache, (B, C) candidate rows and (B, K, D) interests,
the per-interest scores (B, C, K), without building the (B, C, D) gather.
An index in [-N, 0) takes row N + index and one outside [-N, N) scores
NaN, as the JAX package's ``jnp.take`` gives them.

The kernel is ``csrc/lookup_score_fwd.cu``. It reads the cache in its own
type (float32, bfloat16, or int8 rows with a float32 scale each, an
``Int8Rows``), accumulates in fp32, multiplies an int8 row's sums by its
scale and writes the interests' type, as the TPU kernel's fp32 route does.
:func:`plan` names its route: bfloat16 interests with a bfloat16 cache
and D a multiple of 16, or an int8 cache and D a multiple of 32, run on
the tensor cores (both 16-byte aligned), every other pair on the CUDA
cores, in tiles of 32 candidates where 64 do not fit in shared memory
(float32 rows at the PLM's D = 768); neither falls back to the plain version. The op has no gradient, in the JAX package either: on the
card it raises when an input requires grad under grad mode, so a gradient
is never dropped quietly.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from miner_tpu_torch.ops import common
from miner_tpu_torch.parallel.news_cache import Int8Rows, ShardedRows, gather_rows

TILE = 64  # candidates a tile, as in the kernel
SMALL_TILE = 32  # the CUDA cores' tile where 64 candidates do not fit
# candidates a tile of each route
TILES = {"tensor_core": TILE, "cuda_core": TILE, "cuda_core_32": SMALL_TILE}
MAX_RUN = 16  # the most tiles a block scores
SM_SMEM = 228 * 1024  # shared memory of an SM (H100), 1 KB of it kept per block
_MAX_SMEM = 227 * 1024
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 10 + (ctypes.c_void_p,)
# the kernel's cache types: its interests' types and int8 rows
CACHE_CODES = {**common.DTYPE_CODES, torch.int8: common.INT8_CODE}


@functools.lru_cache(maxsize=None)
def _smem_bytes(K: int, D: int, cache_code: int, interests_code: int, tiles: int,
                tile: int = TILE) -> int:
    """Shared memory a block of the kernel takes at these shapes, types and
    run of tiles of ``tile`` candidates, from the kernel's own layout."""
    return common.kernel_function(
        "lookup_score_fwd", "lookup_score_smem_bytes", (ctypes.c_int,) * 6,
        ctypes.c_longlong)(K, D, cache_code, interests_code, tiles, tile)


def plan(B: int, C: int, K: int, D: int, cache_dtype: torch.dtype,
         interests_dtype: torch.dtype, sms: int = 132):
    """(route, tiles a block, shared-memory bytes a block) of a launch on a
    card of ``sms`` SMs: "tensor_core" for bfloat16 interests with a
    bfloat16 cache and D a multiple of 16 or an int8 cache and D a multiple
    of 32, else "cuda_core", or "cuda_core_32" where a tile of 64
    candidates does not fit in shared memory (:data:`TILES`). A block's
    run of tiles is the shortest (up to :data:`MAX_RUN`) that makes the grid
    about one wave of the blocks the SMs hold. Raises on a type the kernel
    does not take, or where even a 32-candidate tile does not fit, naming
    the bytes it needs."""
    for what, dt, codes in (("cache", cache_dtype, CACHE_CODES),
                            ("interests", interests_dtype, common.DTYPE_CODES)):
        if dt not in codes:
            raise TypeError(f"{what} has dtype {dt}, expected one of {list(codes)}")
    tensor_core = interests_dtype == torch.bfloat16 and (
        (cache_dtype == torch.bfloat16 and D % 16 == 0)
        or (cache_dtype == torch.int8 and D % 32 == 0))
    codes = (K, D, CACHE_CODES[cache_dtype], common.DTYPE_CODES[interests_dtype])
    route, size = "tensor_core" if tensor_core else "cuda_core", lambda n: _smem_bytes(*codes, n)
    if not tensor_core and size(1) > _MAX_SMEM:
        route, size = "cuda_core_32", lambda n: _smem_bytes(*codes, n, SMALL_TILE)
    ntiles = -(-C // TILES[route])
    per_sm = max(1, SM_SMEM // (size(MAX_RUN) + 1024))
    tiles = min(MAX_RUN, ntiles, max(1, -(-B * ntiles // (per_sm * sms))))
    smem = size(tiles)
    if smem > _MAX_SMEM:
        raise ValueError(f"lookup shapes K={K}, D={D} need {smem} bytes of "
                         f"shared memory per block, more than {_MAX_SMEM}")
    return route, tiles, smem


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows(cache):
    return cache.values if isinstance(cache, Int8Rows) else cache


def lookup_score_reference(cache, cand_idx: torch.Tensor,
                           interests: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather (the values and scales of an
    ``Int8Rows``), an fp32 product, times the row's scale. An index in
    [-N, 0) takes row N + index and one outside [-N, N) scores NaN, as in
    the kernel and in the JAX package."""
    N = _rows(cache).shape[0]
    row = torch.where(cand_idx < 0, cand_idx + N, cand_idx)
    idx = row.clamp(0, N - 1)
    cand = gather_rows(_rows(cache), idx)
    out = torch.einsum("bcd,bkd->bck", cand.float(), interests.float())
    if isinstance(cache, Int8Rows):
        out = out * gather_rows(cache.scales, idx)
    # in place, and no test of the indices on the host: a card would wait for it
    out.masked_fill_((idx != row)[..., None], float("nan"))
    return out.to(interests.dtype)


def lookup_score_fused(cache, cand_idx: torch.Tensor,
                       interests: torch.Tensor) -> torch.Tensor:
    """(B, C, K) scores from a (N, D) cache tensor or an ``Int8Rows``. A CPU
    tensor takes :func:`lookup_score_reference`; a CUDA tensor launches the
    kernel (a float32 or bfloat16 cache, or int8 rows with float32 scales;
    interests float32 or bfloat16; cand_idx int32) or raises. A table
    rank's ``ShardedRows`` scores its own shard, each index mapped to its
    local row or to the zero row, and the scores are summed over the table
    group (exact: one rank's term is not zero)."""
    if isinstance(cache, ShardedRows):
        return cache.sum(lookup_score_fused(cache.local, cache.local_index(cand_idx),
                                            interests))
    rows = _rows(cache)
    if rows.dim() != 2 or cand_idx.dim() != 2 or interests.dim() != 3:
        raise ValueError("cache must be (N, D), cand_idx (B, C), interests (B, K, D)")
    N, D = rows.shape
    B, C = cand_idx.shape
    K = interests.shape[1]
    if tuple(interests.shape) != (B, K, D):
        raise ValueError(f"interests has shape {tuple(interests.shape)}, "
                         f"expected {(B, K, D)}")
    if rows.device.type == "cpu":
        return lookup_score_reference(cache, cand_idx, interests)
    return _launch(cache, cand_idx, interests)


def _launch(cache, cand_idx, interests) -> torch.Tensor:
    rows = _rows(cache)
    common.require_cuda(rows, "lookup_score_fused")
    N, D = rows.shape
    B, C = cand_idx.shape
    K = interests.shape[1]
    if torch.is_grad_enabled() and (rows.requires_grad or interests.requires_grad):
        raise RuntimeError("lookup_score_fused has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    dev = rows.device
    scales = None
    if isinstance(cache, Int8Rows):
        common.check_tensor("cache.values", rows, dev, (torch.int8,))
        common.check_tensor("cache.scales", cache.scales, dev, (torch.float32,), (N, 1))
        scales = cache.scales.data_ptr()
    else:
        common.check_tensor("cache", rows, dev, tuple(common.DTYPE_CODES))
    common.check_tensor("cand_idx", cand_idx, dev, (torch.int32,))
    common.check_tensor("interests", interests, dev, tuple(common.DTYPE_CODES))
    route, tiles, _ = plan(B, C, K, D, rows.dtype, interests.dtype, _sms(dev.index))
    if route == "tensor_core":  # 16-byte copies of rows and interests
        common.check_aligned("cache", rows)
        common.check_aligned("interests", interests)
    out = torch.empty((B, C, K), dtype=interests.dtype, device=dev)
    fn = common.kernel_function("lookup_score_fwd", "lookup_score_fwd", _ARGTYPES)
    common.launch("lookup_score_fwd", fn, rows.data_ptr(), scales, cand_idx.data_ptr(),
                  interests.data_ptr(), out.data_ptr(), N, B, C, K, D,
                  CACHE_CODES[rows.dtype], common.DTYPE_CODES[interests.dtype], tiles,
                  TILES[route], dev.index, common.stream_of(rows))
    lookup_score_fused.launches += 1
    return out


lookup_score_fused.launches = 0
