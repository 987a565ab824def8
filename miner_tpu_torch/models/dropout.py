"""The randomness of one training micro-step.

The JAX package folds its train state's key with the step number
(``miner_tpu/training/trainer.py:412``), so a step's dropout is a pure
function of (seed, step). ``DropoutRNG(seed, step, device)`` keeps that
contract with two ``torch.Generator``s seeded from (seed, step):

  * a host generator draws the 64-bit seeds of the kernels' Philox dropout
    (attention probabilities, both residual add_ln sites of every layer).
    They are drawn before a layer runs and passed in as plain integers, so a
    layer rematerialised by ``torch.utils.checkpoint`` (which restores only
    the global RNG state, not an explicit generator) regenerates the same
    masks;
  * a device generator draws the masks of the sites outside any kernel
    (embedding, ``reduce_dim``, category, MoE-adaptor and SASRec dropout)
    with ``torch.rand``, and the MoE adaptor's gating noise with
    ``torch.randn`` (JAX draws it from its own "gating" stream,
    trainer.py:414), each outside any checkpointed region.

A resumed run therefore draws exactly what the interrupted one would have.

The masks do not depend on the mesh, as JAX's do not: on any mesh, a
value's mask is the one a single device draws for it at its place in the
global batch. Every rank seeds the step from ``[seed, step]``, so all draw
the same kernel seeds, and a rank's rows of a tensor (the data axis splits
the batch) take their masks of the global tensor: a site outside the
kernels draws the global shape and keeps the rank's rows (``Rows``: where
they sit; its heads too under tensor parallelism), and the kernels take the
rows' places as Philox counter offsets (``ops/philox.py``). A rank's rows of
one PLM call over candidates and history together are two runs of the
global rows (``Rows.concat``). Drawing the global shape costs each rank the
draw of the whole batch; a single device draws as it always did.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from miner_tpu_torch.ops.philox import Offsets, as_offsets, pieces, row_places


@dataclasses.dataclass(frozen=True)
class Rows:
    """Where a rank's rows of a tensor's leading axis sit in the global
    tensor: ``total`` rows there, this rank's at ``offset`` (a
    ``philox.Offsets``: each run of local rows and what it adds to their
    index)."""

    total: int
    offset: Offsets = 0

    @staticmethod
    def block(n: int, rank: int = 0, size: int = 1) -> "Rows":
        """Block ``rank`` of ``size`` equal blocks of ``n`` rows (the data
        axis's split of a batch)."""
        return Rows(n * size, rank * n)

    @staticmethod
    def concat(first: "Rows", n_first: int, second: "Rows") -> "Rows":
        """The rows of ``cat([a, b])`` from those of ``a`` (``n_first`` local
        rows at ``first``) and ``b`` (at ``second``), where the global
        tensor is ``cat`` of the global ``a`` and ``b``."""
        shift = first.total - n_first
        runs = as_offsets(first.offset) + tuple((start + n_first, off + shift)
                                                for start, off in as_offsets(second.offset))
        return Rows(first.total + second.total, runs)

    def whole(self, n: int) -> bool:
        """Whether the ``n`` local rows are the whole tensor."""
        return n == self.total and all(off == 0 for _, off in as_offsets(self.offset))

    def take(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's ``n`` rows of a global tensor ``x``."""
        runs = pieces(self.offset, n)
        if len(runs) == 1:
            start, stop, off = runs[0]
            return x[start + off:stop + off]
        return x.index_select(0, row_places(self.offset, n, x.device))


class DropoutRNG:
    def __init__(self, seed: int, step: int, device: torch.device,
                 data_rank: int = 0, data_size: int = 1):
        host_seed, device_seed = np.random.SeedSequence(
            [int(seed), int(step)]).generate_state(2, np.uint64)
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(int(host_seed))
        self.device = torch.Generator(device=device).manual_seed(int(device_seed))
        self.data_rank, self.data_size = int(data_rank), int(data_size)
        self.rows: Optional[Rows] = None

    def at(self, rows: Rows) -> "DropoutRNG":
        """This stream (the same generators) for tensors whose leading axis
        holds the rows at ``rows``, in place of a batch's data block."""
        other = copy.copy(self)
        other.rows = rows
        return other

    def rows_of(self, n: int) -> Rows:
        """Where the ``n`` rows of a tensor's leading axis sit: ``at``'s
        rows, else this rank's block of the batch over the data axis."""
        return self.rows if self.rows is not None else Rows.block(n, self.data_rank,
                                                                  self.data_size)

    def _draw(self, shape, heads: Optional[Tuple[int, int]], fn) -> torch.Tensor:
        """``fn`` (rand or randn) of the global tensor of a local ``shape``,
        and this rank's rows (and heads, ``(offset, total)`` of axis 1) of
        it."""
        n = shape[0]
        rows = self.rows_of(n)
        full = list(shape)
        full[0] = rows.total
        if heads is not None:
            full[1] = heads[1]
        if rows.whole(n) and (heads is None or heads[1] == shape[1]):
            return fn(tuple(shape), generator=self.device, device=self.device.device)
        u = rows.take(fn(tuple(full), generator=self.device, device=self.device.device), n)
        if heads is not None:
            u = u[:, heads[0]:heads[0] + shape[1]]
        return u

    def kernel_seeds(self, n: int):
        """``n`` 64-bit seeds (below 2**63) for the kernels' Philox dropout."""
        return torch.randint(0, 2 ** 63 - 1, (n,), generator=self.host).tolist()

    def dropout(self, x: torch.Tensor, rate: float,
                heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Inverted dropout, as flax's ``nn.Dropout``: kept values / (1 -
        rate); the mask of ``x``'s rows (and, given ``heads``, its heads)
        in the global tensor."""
        if rate <= 0.0:
            return x
        keep = self._draw(x.shape, heads, torch.rand) >= rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def normal(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """Standard normal draws of ``shape`` on the device, in ``dtype``
        (drawn in fp32 and rounded): this rank's rows of the global draw."""
        return self._draw(shape, None, torch.randn).to(dtype)


def dropout_active(module: torch.nn.Module, rng, rate: float) -> bool:
    """Whether ``module`` drops at ``rate`` now: in training mode
    (``module.train()``; ``eval()`` is the JAX package's
    ``deterministic=True``), with a step's ``DropoutRNG`` given (None draws
    nothing) and a rate above 0."""
    return module.training and rng is not None and rate > 0.0
