#!/usr/bin/env python3
"""Convert an Orbax checkpoint of the JAX package into a port checkpoint.

    python convert_jax_checkpoint.py --ckpt <run>/ckpt/bestAucModel --out bestAucModel.pt

Run it where JAX and orbax are installed (it imports both packages; the
port itself never imports JAX). It restores the checkpoint as raw dicts
(``miner_tpu.training.checkpoint.CheckpointManager.restore``), maps its
``params`` onto the port's module names
(``miner_tpu_torch.models.convert.params_from_jax``, which also unstacks a
``--scan_layers`` stack into ``layers.{i}``), and writes a port checkpoint
file (``miner_tpu_torch.training.checkpoint.save``) whose ``params`` load
with ``strict=True`` into the model the same flags build: ``python -m
miner_tpu_torch eval|serve|recommend --saved_model_path <out>``, on the CPU
(``--device cpu``) or the card, or ``train --pretrained_model_path <out>``.
The run's ``args.json`` (beside its ``ckpt/`` directory), where it exists,
is kept as the payload's ``args``. The training state comes too
(``miner_tpu_torch.training.checkpoint.state_from_jax``): optax's AdamW
moments and counts, MultiSteps' partial gradient, the micro-step and the
dropout seed, so ``python -m miner_tpu_torch train --resume_from <out>``
with the JAX run's flags continues it in the port. Where the optimizer
state cannot be carried (a checkpoint without one, or another optimizer
than the JAX package's), the result holds the parameters and the reason,
and ``--resume_from`` refuses it with that reason.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def convert(ckpt: str):
    """The port's payload of the Orbax checkpoint at ``ckpt``."""
    import jax

    from miner_tpu.training.checkpoint import CheckpointManager

    path = os.path.normpath(ckpt)
    restored = CheckpointManager(os.path.dirname(path) or ".").restore(os.path.basename(path))
    args = None
    args_json = os.path.join(os.path.dirname(os.path.dirname(path)), "args.json")
    if os.path.isfile(args_json):
        with open(args_json) as f:
            args = json.load(f)
    return payload_of(jax.device_get(restored), args)


def payload_of(restored, args=None):
    """The port's payload of a JAX checkpoint restored as raw nested dicts
    of numpy arrays (a whole training state, or its parameters alone), with
    the run's arguments when known."""
    from miner_tpu_torch.models.convert import params_from_jax
    from miner_tpu_torch.training.checkpoint import state_from_jax

    whole = "params" in restored
    payload = {"params": params_from_jax(restored["params"] if whole else restored),
               "converted_from": "the JAX package"}
    payload.update(state_from_jax(restored, args) if whole
                   else {"not_resumable": "the JAX checkpoint holds parameters alone"})
    if args is not None:
        payload["args"] = args
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--ckpt", required=True,
                    help="an Orbax checkpoint directory written by `python -m miner_tpu train`")
    ap.add_argument("--out", required=True, help="the port checkpoint file to write")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from miner_tpu_torch.training import checkpoint

    payload = convert(args.ckpt)
    checkpoint.save(args.out, payload)
    print(f"converted {len(payload['params'])} tensors from {args.ckpt} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
