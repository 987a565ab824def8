"""Counter-based dropout bits, Philox4x32-10, in plain PyTorch.

A frozen copy of the port's plain version (``miner_tpu_torch/ops/philox.py``)
of the bits its kernels keep or drop an element by, so that the reference
draws the same masks from the same seeds without importing the port. Two
changes, neither of the bits: the 32x32-bit products are taken as one int64
product (it wraps modulo 2**64, so its low and high words are exact), and
the mha bits are computed once per counter, not once per element (one
Philox call covers the four elements {i, i+8} x {j, j+8}).

  * mha, element (sequence n, head h, query i, key j): word
    ``2 * bit3(i) + bit3(j)`` of philox(counter = (j', i', h, n)), where
    ``x' = (x // 16) * 8 + x % 8``;
  * add_ln, element (row r, column c): word ``c % 4`` of
    philox(counter = (c // 4, r, 0, 0)).

An element is kept iff its 32 bits are >= floor(rate * 2**32).
"""
from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def philox4x32(c0, c1, c2, c3, seed: int):
    """The four output words for int64 counters holding uint32 values."""
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    shape = torch.broadcast_shapes(c0.shape, c1.shape, c2.shape, c3.shape)
    c0, c1, c2, c3 = (c.to(torch.int64).expand(shape) for c in (c0, c1, c2, c3))
    for _ in range(ROUNDS):
        p0, p1 = c0 * M0, c2 * M1
        c0, c1, c2, c3 = (((p1 >> 32) & MASK32) ^ c1 ^ k0, p1 & MASK32,
                          ((p0 >> 32) & MASK32) ^ c3 ^ k1, p0 & MASK32)
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def mha_keep(seed: int, rows: torch.Tensor, H: int, L: int, rate: float) -> torch.Tensor:
    """(n, H, L, L) keep mask of the mha dropout for the sequences at
    ``rows`` (their places in the whole batch)."""
    dev = rows.device
    x = torch.arange(L, dtype=torch.int64, device=dev)
    prime = ((x >> 4) << 3) | (x & 7)
    half = 8 * ((L - 1) >> 4) + min((L - 1) & 15, 7) + 1  # prime's largest + 1
    y = torch.arange(half, dtype=torch.int64, device=dev)
    words = philox4x32(y[None, None, None, :], y[None, None, :, None],
                       torch.arange(H, dtype=torch.int64, device=dev)[None, :, None, None],
                       rows.to(torch.int64)[:, None, None, None], seed)
    words = torch.stack(words, dim=-1) >= threshold(rate)  # (n, H, i', j', word)
    bit = (x >> 3) & 1
    lane = bit[:, None] * 2 + bit[None, :]
    return words[:, :, prime[:, None], prime[None, :], lane]


def add_ln_keep(seed: int, rows: torch.Tensor, D: int, rate: float) -> torch.Tensor:
    """(T, D) keep mask of an add_ln site for the token rows at ``rows``."""
    dev = rows.device
    c = torch.arange(D // 4, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32(c[None, :], rows.to(torch.int64)[:, None], zero, zero, seed)
    return (torch.stack(words, dim=-1) >= threshold(rate)).reshape(len(rows), D)
