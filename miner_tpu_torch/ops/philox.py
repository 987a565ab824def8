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

n, h and r are the element's places in the whole batch, whatever part of
it one launch holds: a launch over some of the sequences, heads or rows
(a rank's, over a mesh) gives each its offset, so that it draws their
masks of the one launch over the whole batch. The offset of a launch's
rows may change along them (:data:`Offsets`: a rank's rows of a PLM call
over candidates and history together are two runs of the global rows);
the kernels take one offset a launch, so their wrappers launch once a
piece (:func:`pieces`).

An element is kept iff its 32 bits are >= floor(rate * 2**32) (as
``miner_tpu/ops/mha.py:_dropout_threshold``), and scaled by 1 / (1 - rate).

uint32 arithmetic is carried in int64 here; the 32x32 -> 64-bit products
are split into 16-bit halves so that no intermediate leaves int64's range.
"""
from __future__ import annotations

from typing import Tuple, Union

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


# A piecewise offset of a launch's rows: ((start, offset), ...), the starts
# ascending from 0; rows [start_i, start_i+1) are at their index + offset_i
# in the whole batch. An int is one offset for every row.
Offsets = Union[int, Tuple[Tuple[int, int], ...]]


def as_offsets(offset: Offsets) -> Tuple[Tuple[int, int], ...]:
    return ((0, int(offset)),) if isinstance(offset, int) else tuple(offset)


def pieces(offset: Offsets, n: int):
    """The (start, stop, offset) runs of ``n`` rows under ``offset``, the
    empty ones left out and adjacent ones of one offset merged (one rank's
    candidates and history are one run): one kernel launch each, whose row
    i (the run's row ``start + i``) is at ``i + start + offset`` in the
    whole batch."""
    runs = as_offsets(offset)
    out = []
    for i, (start, off) in enumerate(runs):
        stop = min(runs[i + 1][0] if i + 1 < len(runs) else n, n)
        if stop <= start:
            continue
        if out and out[-1][2] == off and out[-1][1] == start:
            out[-1] = (out[-1][0], stop, off)
        else:
            out.append((start, stop, off))
    return out


def scaled(offset: Offsets, k: int) -> Tuple[Tuple[int, int], ...]:
    """The offsets of the rows of ``k`` sub-rows each (a sequence's tokens,
    add_ln's rows of a PLM call) from those of the rows."""
    return tuple((start * k, off * k) for start, off in as_offsets(offset))


def row_places(offset: Offsets, n: int, device) -> torch.Tensor:
    """(n,) int64: each of ``n`` rows' place in the whole batch."""
    idx = torch.arange(n, dtype=torch.int64, device=torch.device(device))
    for start, stop, off in pieces(offset, n):
        idx[start:stop] += off
    return idx


def mha_bits(seed: int, N: int, H: int, L: int, device, seq_offset: Offsets = 0,
             head_offset: int = 0) -> torch.Tensor:
    """(N, H, L, L) int64 bits of the mha dropout mask, [n, h, i, j], for
    the sequences at ``seq_offset`` and the heads at ``head_offset`` in the
    whole batch."""
    dev = torch.device(device)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    x = ar(L)
    words = philox4x32(_drop_index(x)[None, None, None, :],
                       _drop_index(x)[None, None, :, None],
                       (ar(H) + head_offset)[None, :, None, None],
                       row_places(seq_offset, N, dev)[:, None, None, None],
                       seed)
    lane = ((x >> 3) & 1)[:, None] * 2 + ((x >> 3) & 1)[None, :]
    return _select_word(words, lane[None, None])


def add_ln_bits(seed: int, T: int, D: int, device, row_offset: Offsets = 0) -> torch.Tensor:
    """(T, D) int64 bits of the add_ln dropout mask, [row, column], for the
    rows at ``row_offset`` in the whole batch."""
    dev = torch.device(device)
    c = torch.arange(D, dtype=torch.int64, device=dev)
    r = row_places(row_offset, T, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32((c >> 2)[None, :], r[:, None], zero, zero, seed)
    return _select_word(words, (c & 3)[None, :])


def keep_mask(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """Bool keep mask from dropout bits at ``rate``."""
    return bits >= threshold(rate)
