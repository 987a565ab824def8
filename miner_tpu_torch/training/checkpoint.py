"""Port-format checkpoints with true resume.

Counterpart of ``miner_tpu/training/checkpoint.py`` (Orbax directories).
A port checkpoint is one ``torch.save`` file per name under
``<run_dir>/ckpt/``: ``bestAucModel``, ``bestLossModel``, ``finalModel``
(the reference's triggers), so ``--saved_model_path train/<ts>/ckpt/
bestAucModel`` of ``config/eval_miner.txt`` names one unchanged. It holds
the fp32 parameters, the optimizer state (AdamW moments, the accumulation
counters and the partial gradient sum between updates, which optax's
MultiSteps state holds too), the micro-step, the seed every step's dropout
generators derive from, and the run's arguments.

The JAX package's Orbax checkpoints are directories, and reading them needs
its JAX stack: a directory is refused with a clear message.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

NAMES = ("bestAucModel", "bestLossModel", "finalModel")


def save(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` to ``path`` atomically (a reader never sees half a
    file)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load(path: str) -> Dict[str, Any]:
    """A port checkpoint's payload, tensors on the CPU."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package "
            "(miner_tpu), which the port cannot read without JAX. The port "
            "reads the single-file checkpoints that `python -m "
            "miner_tpu_torch train` writes under <run_dir>/ckpt/")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
