"""Small shared utilities: bucketing, rounding, cosine similarity, devices."""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from miner_tpu_torch.parallel.mesh import local_world_size, ranks_have_own_cards


def candidate_bucket(n: int, minimum: int = 16) -> int:
    """Next power of two >= max(n, minimum). Shared by the serving layer
    (slate/batch padding) and the trainer's corpus top-k, so the number of
    distinct request shapes stays at log2(corpus)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pairwise_cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                               zero_diagonal: bool = False) -> torch.Tensor:
    """Batched pairwise cosine similarity: (B, M, D), (B, N, D) -> (B, M, N);
    with ``zero_diagonal`` (M == N) the diagonal is 0 (the disagreement
    regularizer).

    The norm is clamped at 1e-12, as in the JAX package: the category pad
    row is exactly zero, and an unclamped division would turn every padded
    history slot into NaN."""
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
    sim = torch.einsum("bmd,bnd->bmn", x, y)
    if zero_diagonal:
        if x.shape[1] != y.shape[1]:
            raise ValueError("zero_diagonal requires M == N")
        eye = torch.eye(x.shape[1], dtype=torch.bool, device=sim.device)
        sim = torch.where(eye, 0.0, sim)
    return sim


def resolve_device(name: Optional[str]) -> torch.device:
    """The device named by ``--device``; unset means ``cuda``. Asking for
    a card that is not there raises: the port never carries on quietly on
    the CPU. Under a process group a card without an index is the rank's
    own, ``cuda:LOCAL_RANK``, where each rank has one, and ``cuda:0`` where
    the ranks share it (``parallel.mesh.ranks_have_own_cards``)."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        own = ranks_have_own_cards(local_world_size(), name)
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) if own else 0)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name or 'cuda (default)'} asks for a CUDA card, but "
            "torch.cuda.is_available() is False; pass --device cpu to run "
            "the plain PyTorch versions of the kernels on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported --device {name!r} (use cuda or cpu)")
    return device
