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
"""
from __future__ import annotations

import numpy as np
import torch


class DropoutRNG:
    def __init__(self, seed: int, step: int, device: torch.device):
        host_seed, device_seed = np.random.SeedSequence(
            [int(seed), int(step)]).generate_state(2, np.uint64)
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(int(host_seed))
        self.device = torch.Generator(device=device).manual_seed(int(device_seed))

    def kernel_seeds(self, n: int):
        """``n`` 64-bit seeds (below 2**63) for the kernels' Philox dropout."""
        return torch.randint(0, 2 ** 63 - 1, (n,), generator=self.host).tolist()

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Inverted dropout, as flax's ``nn.Dropout``: kept values / (1 - rate)."""
        if rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.device, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def normal(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """Standard normal draws of ``shape`` on the device, in ``dtype``
        (drawn in fp32 and rounded)."""
        return torch.randn(shape, generator=self.device,
                           device=self.device.device).to(dtype)


def dropout_active(module: torch.nn.Module, rng, rate: float) -> bool:
    """Whether ``module`` drops at ``rate`` now: in training mode
    (``module.train()``; ``eval()`` is the JAX package's
    ``deterministic=True``), with a step's ``DropoutRNG`` given (None draws
    nothing) and a rate above 0."""
    return module.training and rng is not None and rate > 0.0
