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
A converted JAX checkpoint carries the run's training state too
(:func:`state_from_jax`): optax's AdamW moments and counts, MultiSteps'
partial gradient, the micro-step and the dropout seed, so ``--resume_from``
continues the JAX run in the port. A reference checkpoint holds parameters
alone, and so does a JAX checkpoint whose optimizer state the port cannot
carry (the reason is kept in the payload): ``eval``, ``serve``,
``recommend`` and ``--pretrained_model_path`` take them, ``--resume_from``
refuses them (:func:`optimizer_payload`).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from miner_tpu_torch.models.convert import params_from_jax
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
    no optimizer state (converted from the reference, or from a JAX
    checkpoint whose optimizer state could not be carried)."""
    payload = load(path)
    if "optimizer" not in payload:
        why = payload.get("not_resumable", "it is not carried from that framework")
        raise ValueError(
            f"--resume_from {path}: the checkpoint was converted from "
            f"{payload.get('converted_from', 'another framework')} and holds no "
            f"optimizer state ({why}); start a new run from its weights with "
            "--pretrained_model_path")
    return payload


def state_from_jax(restored: Mapping, args: Optional[Mapping] = None) -> Dict[str, Any]:
    """The training state of a port payload (``optimizer``, ``micro_step``,
    ``rng_seed``, ``grad_acc``, as ``Trainer._payload`` writes them) from a
    JAX checkpoint restored as raw nested dicts of numpy arrays (its
    ``opt_state``, ``step`` and ``rng``; trainer.py:1456-1462), or
    ``{"not_resumable": why}`` where it cannot be carried.

    The JAX optimizer (``miner_tpu/training/optim.py:make_optimizer``) is
    ``clip_by_global_norm`` then ``adamw`` (``ScaleByAdamState`` ``count``,
    ``mu``, ``nu``; the weight-decay mask's empty state; the schedule's
    ``count``), under ``--freeze_transformer`` inside ``multi_transform``
    (frozen leaves hold no moments: None), inside ``MultiSteps`` at
    accumulation above 1 (``mini_step``, ``gradient_step``,
    ``inner_opt_state``, ``acc_grads``). The moments map onto the port's
    parameter names as the parameters do (``params_from_jax``: kernels
    transposed, a ``--scan_layers`` stack unstacked), keyed by name;
    ``Optimizer.by_index`` puts them in the resumed run's parameter order.
    AdamW's step is the adam count and the port's ``updates`` the
    schedule's. ``acc_grads`` is optax's running mean of the micro-batches'
    gradients and the port's ``grad_acc`` their raw sum, so a partial
    accumulation carries ``mini_step * acc_grads`` of each leaf that has
    moments (a frozen leaf takes no gradient in the port)."""
    opt = restored.get("opt_state")
    if opt is None:
        return {"not_resumable": "the JAX checkpoint holds no opt_state"}
    multi = isinstance(opt, Mapping) and {"mini_step", "acc_grads", "inner_opt_state"} <= set(opt)
    inner = opt["inner_opt_state"] if multi else opt
    adam = _find(inner, lambda d: {"count", "mu", "nu"} <= set(d))
    schedule = _find(inner, lambda d: set(d) == {"count"})
    if len(adam) != 1 or len(schedule) != 1:
        return {"not_resumable": f"its optimizer state has {len(adam)} Adam states and "
                                 f"{len(schedule)} schedule counts where the port carries "
                                 "optax's clip + adamw + schedule chain (one of each)"}
    (adam,), (schedule,) = adam, schedule
    mu, nu = (params_from_jax(_prune(adam[k])) for k in ("mu", "nu"))
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state = {n: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]} for n in mu}
    mini = int(np.asarray(opt["mini_step"])) if multi else 0
    grad_acc = None
    if mini:
        acc = params_from_jax(_prune(opt["acc_grads"]))
        grad_acc = {n: acc[n] * mini for n in state}
    key = np.asarray(restored["rng"]).astype(np.uint64).reshape(-1)
    rng_seed = (int(args["seed"]) + 1 if args and "seed" in args
                else int(key[0]) << 32 | int(key[1]))  # jax.random.PRNGKey(seed + 1)
    return {"optimizer": {"adamw": {"state": state}, "mini_step": mini,
                          "updates": int(np.asarray(schedule["count"]))},
            "micro_step": int(np.asarray(restored["step"])), "rng_seed": rng_seed,
            "grad_acc": grad_acc}


def _find(tree, match: Callable[[Mapping], bool]) -> List[Mapping]:
    """Every mapping in ``tree`` (nested mappings and sequences) that
    ``match``es, outermost first; a match is not searched further."""
    if isinstance(tree, Mapping):
        if match(tree):
            return [tree]
        return [m for v in tree.values() for m in _find(v, match)]
    if isinstance(tree, (list, tuple)):
        return [m for v in tree for m in _find(v, match)]
    return []


def _prune(tree: Mapping) -> Dict:
    """``tree`` without its None leaves (optax's masked-out moments) and the
    mappings they leave empty."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = _prune(v)
            if v:
                out[k] = v
        elif v is not None:
            out[k] = v
    return out
