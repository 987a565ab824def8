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
its JAX stack: a directory is refused, naming ``convert_jax_checkpoint.py``
(at the repository's root, run where JAX is installed), which writes one as
a port checkpoint. A reference (MrRobot2211/miner) checkpoint comes in
through ``python -m miner_tpu_torch.tools.import_reference_checkpoint``.
A converted checkpoint holds the parameters (and for a JAX run its
arguments) but no optimizer state, which is not carried across frameworks:
``eval``, ``serve``, ``recommend`` and ``--pretrained_model_path`` take it,
``--resume_from`` refuses it (:func:`optimizer_payload`).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from miner_tpu_torch.parallel import mesh

NAMES = ("bestAucModel", "bestLossModel", "finalModel")


def save(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` to ``path`` atomically (a reader never sees half a
    file). Under a process group rank 0 writes and every rank waits for it
    at a barrier, so the file is the same whatever the number of ranks."""
    if mesh.is_writer():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    mesh.barrier()


def load(path: str) -> Dict[str, Any]:
    """A port checkpoint's payload, tensors on the CPU."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package "
            "(miner_tpu), which the port cannot read without JAX. The port "
            "reads the single-file checkpoints that `python -m "
            "miner_tpu_torch train` writes under <run_dir>/ckpt/; convert "
            f"this one where JAX is installed: python convert_jax_checkpoint.py "
            f"--ckpt {path} --out <file>")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def optimizer_payload(path: str) -> Dict[str, Any]:
    """A checkpoint's payload for ``--resume_from``: refused when it holds
    no optimizer state (converted from JAX or the reference)."""
    payload = load(path)
    if "optimizer" not in payload:
        raise ValueError(
            f"--resume_from {path}: the checkpoint was converted from "
            f"{payload.get('converted_from', 'another framework')} and holds no "
            "optimizer state (it is not carried across frameworks); start a new "
            "run from its weights with --pretrained_model_path")
    return payload
