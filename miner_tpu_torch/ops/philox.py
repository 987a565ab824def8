"""Counter-based dropout bits: Philox4x32-10 in plain PyTorch.

The TPU kernels draw their dropout bits from the TPU's hardware generator
(``pltpu.prng_random_bits``), which no other device reproduces. The port's
kernels use Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011) instead, written once in CUDA (``csrc/philox.cuh``),
once in Triton (``ops/add_ln.py``) and once here, so that the plain versions
of the kernels draw the very same masks as the kernels from the same seed.

A 64-bit seed is the key (low word, high word). Every dropout site lays out
its counter so that one element's bits depend only on (seed, its
coordinates): the forward, the backward and a rematerialised forward all
regenerate the same mask in any order, and nothing random is stored.

  * mha, element (sequence n, head h, query i, key j): word
    ``2 * bit3(i) + bit3(j)`` of philox(counter = (j', i', h, n)), where
    ``x' = (x // 16) * 8 + x % 8`` is x with bit 3 taken out. One call
    covers the four elements {i, i+8} x {j, j+8} that one lane of a
    tensor-core tile holds (``csrc/philox.cuh``), whether queries or keys
    are the tile's rows, so no two lanes compute the same call;
  * add_ln, element (row r, column c):
    word ``c % 4`` of philox(counter = (c // 4, r, 0, 0)).

An element is kept iff its 32 bits are >= floor(rate * 2**32) (as
``miner_tpu/ops/mha.py:_dropout_threshold``), and scaled by 1 / (1 - rate).

uint32 arithmetic is carried in int64 here; the 32x32 -> 64-bit products
are split into 16-bit halves so that no intermediate leaves int64's range.
"""
from __future__ import annotations

from typing import Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85  # key schedule (Weyl) increments
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def threshold(rate: float) -> int:
    """Keep iff bits >= this: P(keep) = 1 - rate over the uint32 range."""
    return min(int(rate * 4294967296.0), 4294967295)


def split_seed(seed: int) -> Tuple[int, int]:
    """The two 32-bit key words of a 64-bit seed (low, high)."""
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"dropout seed {seed} is not a 64-bit unsigned value")
    return seed & MASK32, (seed >> 32) & MASK32


def _mulhilo(m: int, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * a for a constant m < 2**32."""
    p_lo = m * (a & 0xFFFF)  # < 2**48
    p_hi = m * (a >> 16)  # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               c3: torch.Tensor, seed: int):
    """The four output words of Philox4x32-10 for counters (c0, c1, c2, c3)
    (int64 tensors holding uint32 values, broadcastable) under ``seed``."""
    k0, k1 = split_seed(seed)
    shape = torch.broadcast_shapes(c0.shape, c1.shape, c2.shape, c3.shape)
    c0, c1, c2, c3 = (c.to(torch.int64).expand(shape) for c in (c0, c1, c2, c3))
    for r in range(ROUNDS):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def _select_word(words, lane: torch.Tensor) -> torch.Tensor:
    c0, c1, c2, c3 = words
    return torch.where(lane == 0, c0, torch.where(lane == 1, c1,
                       torch.where(lane == 2, c2, c3)))


def _drop_index(x: torch.Tensor) -> torch.Tensor:
    """x with bit 3 taken out: (x // 16) * 8 + x % 8."""
    return ((x >> 4) << 3) | (x & 7)


def mha_bits(seed: int, N: int, H: int, L: int, device) -> torch.Tensor:
    """(N, H, L, L) int64 bits of the mha dropout mask, [n, h, i, j]."""
    dev = torch.device(device)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    x = ar(L)
    words = philox4x32(_drop_index(x)[None, None, None, :],
                       _drop_index(x)[None, None, :, None],
                       ar(H)[None, :, None, None], ar(N)[:, None, None, None],
                       seed)
    lane = ((x >> 3) & 1)[:, None] * 2 + ((x >> 3) & 1)[None, :]
    return _select_word(words, lane[None, None])


def add_ln_bits(seed: int, T: int, D: int, device) -> torch.Tensor:
    """(T, D) int64 bits of the add_ln dropout mask, [row, column]."""
    dev = torch.device(device)
    c = torch.arange(D, dtype=torch.int64, device=dev)
    r = torch.arange(T, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32((c >> 2)[None, :], r[:, None], zero, zero, seed)
    return _select_word(words, (c & 3)[None, :])


def keep_mask(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """Bool keep mask from dropout bits at ``rate``."""
    return bits >= threshold(rate)
