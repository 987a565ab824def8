"""Batches on the ``data`` axis, parameters replicated.

Counterpart of ``miner_tpu/parallel/sharding.py``. Every rank computes the
same global host batch (the samplers are pure functions of (seed, epoch),
so no data service is needed) and feeds only its rows to the model:
:func:`shard_batch` slices them on the host, before any copy to the device.
Ranks that differ only in their model or table coordinates take the same
rows. :func:`gather_rows` gives every rank the whole batch of a per-rank
result (JAX's replicated ``out_shardings``), and :func:`replicate` makes
sure every rank starts from rank 0's parameters.

The collectives are written with ``all_reduce`` and ``broadcast`` alone,
which gloo offers for CUDA tensors (it has no ``all_gather`` for them), so
that ranks sharing one card run them too.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from miner_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def process_row_range(mesh: Mesh, n_rows: int) -> tuple[int, int]:
    """The rows [start, stop) of an ``n_rows`` batch that this rank owns:
    the data axis splits them into equal contiguous blocks in data-rank
    order (ranks differing only in model or table coordinates own the same
    block, as JAX's deduped spans). Raises when ``n_rows`` does not divide
    by the data size."""
    data = mesh.shape[DATA_AXIS]
    if n_rows % data:
        raise ValueError(f"a batch of {n_rows} rows does not divide by the mesh's "
                         f"data size {data}")
    per = n_rows // data
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a host batch: every array with a leading (batch)
    dimension sliced by :func:`process_row_range`, scalars (``valid``) as
    they are. The batch itself with a data size of 1."""
    if mesh.shape[DATA_AXIS] == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = v
        else:
            start, stop = process_row_range(mesh, len(v))
            out[k] = v[start:stop]
    return out


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole batch of a per-rank (rows, ...) tensor, the data group's
    blocks in data-rank order, on every rank: an ``all_reduce`` of a zero
    buffer in which each rank fills its block (exact: one term a value is
    not zero). ``x`` itself with a data size of 1."""
    if mesh.data_group is None:
        return x
    data = mesh.shape[DATA_AXIS]
    n = x.shape[0]
    full = torch.zeros((data * n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    full[mesh.data_rank * n:(mesh.data_rank + 1) * n] = x
    dist.all_reduce(full, group=mesh.data_group)
    return full


def every_rank(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on all of them) on every rank of
    ``group``, in group-rank order: each broadcast in turn, its bytes as
    they are."""
    mine, parts = dist.get_rank(group), []
    for r in range(dist.get_world_size(group)):
        x = t.detach().clone() if r == mine else torch.empty_like(t)
        dist.broadcast(x, dist.get_global_rank(group, r), group=group)
        parts.append(x)
    return parts


def replicate(module: torch.nn.Module) -> None:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank. Every rank builds them from the same seed (or file), so this is a
    check as much as a copy: raises on every rank when any rank's bytes
    differed from rank 0's. Nothing to do without a process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    tensors = [t for _, t in module.named_parameters()] + [t for _, t in module.named_buffers()]
    device = tensors[0].device if tensors else torch.device("cpu")
    differ = torch.zeros((), dtype=torch.int32, device=device)
    with torch.no_grad():
        for t in tensors:
            got = t.detach().clone()
            dist.broadcast(got, src=0)
            if not torch.equal(got, t):
                differ += 1
                t.copy_(got)
    dist.all_reduce(differ)
    if int(differ):
        raise RuntimeError(
            f"{int(differ)} parameter or buffer tensors differed between ranks before "
            "their broadcast from rank 0: every rank must build the model from the "
            "same seed and files")
