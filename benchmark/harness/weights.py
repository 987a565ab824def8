"""The weights of a run, made on the device from the seed.

One ``torch.Generator`` on the run's device draws every parameter's
standard normals in one call; each parameter is a slice of them times its
standard deviation plus its mean (``reference/*.py:param_specs``). The
program and the reference get the same float32 values from the same seed.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], float, float]


def make(specs: Sequence[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape, mean, std), piece in zip(specs, torch.split(flat, sizes)):
        out[name] = piece.view(shape).mul_(std).add_(mean)
    return out


def on_device(trainer, weights: Dict[str, torch.Tensor]):
    """The trainer's model built with no weights of its own (on the meta
    device), put on the trainer's device and loaded with ``weights``
    (strict: every name and shape the model has)."""
    with torch.device("meta"):
        model = trainer.build_model()
    model = model.to_empty(device=trainer.device)
    model.load_state_dict(weights, strict=True)
    return model
