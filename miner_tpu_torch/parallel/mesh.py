"""The device mesh of the port: one process a rank, one rank a mesh device.

Counterpart of ``miner_tpu/parallel/mesh.py``. The mesh has the JAX
package's three axes:

  * ``data``: the batch axis. Each rank takes its rows of every global
    batch (``parallel/sharding.py``); at each optimizer update the
    gradients are summed over the ranks that share the model and table
    coordinates (the data group, ``training/optim.py``);
  * ``model``: tensor and expert parallelism (``parallel/tp.py``): the
    transformer layers' products and the MoE experts shard over the ranks
    that share the data and table coordinates (the model group), and their
    partial results are summed over it;
  * ``table``: the news-embedding cache's rows shard over it
    (``parallel/news_cache.py``); a cached score is summed over the ranks
    that share the data and model coordinates (the table group).

Ranks are laid out as JAX lays out its devices:
``arange(world).reshape(data, model, table)``, so rank r has coordinates
``unravel_index(r, (data, model, table))``.

``maybe_initialize_distributed`` starts the process group when a launcher
(``python -m torch.distributed.run``) has set ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``. Its backend follows the placement,
decided before the group starts from the ranks on each host
(``LOCAL_WORLD_SIZE``) and its cards: NCCL where every rank has a card of
its own, gloo where ranks share a card or run on the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TABLE_AXIS = "table"
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")

_log = logging.getLogger("miner_tpu_torch")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining ranks on the data axis
    table: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        table = max(1, self.table)
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // (table * model)
        if data * model * table != n_devices:
            raise ValueError(
                f"mesh {data}x{model}x{table} does not cover "
                f"{n_devices} devices"
            )
        return data, model, table


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0, or the only one."""
    return this_rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def local_world_size() -> int:
    """The ranks on this host: the launcher's ``LOCAL_WORLD_SIZE``, else
    the world's (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE") or world_size())


def ranks_have_own_cards(local_world: int, device: Optional[str] = None) -> bool:
    """Whether each of the ``local_world`` ranks of this host gets a card of
    its own: a CUDA device asked for (``--device`` unset or cuda) and at
    least ``local_world`` cards on the host."""
    wants_card = torch.device(device or "cuda").type == "cuda"
    return (wants_card and torch.cuda.is_available()
            and local_world <= torch.cuda.device_count())


def backend_for(local_world: int, device: Optional[str] = None) -> str:
    """The collective backend of a group with ``local_world`` ranks on each
    host: ``nccl`` where each rank has a card of its own, ``gloo`` where
    ranks share a card (NCCL refuses two ranks on one device) or run on
    the CPU."""
    return "nccl" if ranks_have_own_cards(local_world, device) else "gloo"


def maybe_initialize_distributed(device: Optional[str] = None,
                                 timeout: Optional[datetime.timedelta] = None
                                 ) -> Optional[str]:
    """Start the process group when the launcher's environment is present
    (``LAUNCHER_ENV``; the port's counterpart of JAX's
    ``COORDINATOR_ADDRESS``), with :func:`backend_for`'s backend and the
    collectives' ``timeout`` (the backend's default when None), and set
    each rank's card first where ranks have their own. Returns the backend
    (that of a group already started), or None without a launcher."""
    if dist.is_initialized():
        return dist.get_backend()
    if not all(os.environ.get(k) for k in LAUNCHER_ENV):
        return None
    world = int(os.environ["WORLD_SIZE"])
    backend = backend_for(int(os.environ.get("LOCAL_WORLD_SIZE") or world), device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world,
                            **({} if timeout is None else {"timeout": timeout}))
    if dist.get_rank() == 0:
        _log.warning("process group: %d ranks, backend %s (%s)", world, backend,
                     "a card a rank" if backend == "nccl" else
                     "ranks share a card" if torch.device(device or "cuda").type == "cuda"
                     else "CPU")
    return backend


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """This rank's place in the (data, model, table) mesh over the process
    group's ranks (one rank, all axes 1, without a group) and the process
    groups the port sums over: ``data_group``, the ranks that share this
    rank's model and table coordinates, ``table_group``, those that share
    its data and model coordinates, and ``model_group``, those that share
    its data and table coordinates; and ``row_group``, the ranks that share
    its data coordinate (and so its rows: the replicas of a replicated
    parameter's gradient), rooted at ``row_root``. None where the group is
    this rank alone. ``MeshConfig.resolve`` raises JAX's ``ValueError`` for
    a mesh that does not cover the ranks. Given ``world`` and ``rank``
    (another rank's place, or a layout without processes) it makes no
    groups."""

    def __init__(self, cfg: MeshConfig = MeshConfig(), world: Optional[int] = None,
                 rank: Optional[int] = None):
        groups = world is None and dist.is_initialized()
        world = world_size() if world is None else world
        data, model, table = cfg.resolve(world)
        self.shape: Dict[str, int] = {DATA_AXIS: data, MODEL_AXIS: model, TABLE_AXIS: table}
        self.rank = this_rank() if rank is None else rank
        grid = np.arange(world).reshape(data, model, table)
        self.data_rank, self.model_rank, self.table_rank = (
            int(c) for c in np.unravel_index(self.rank, grid.shape))
        # the global ranks of table coordinate 0 in this rank's table group,
        # and of model and table coordinates 0 among the ranks of its rows
        self.table_root = self.rank - self.table_rank
        self.row_root = int(grid[self.data_rank, 0, 0])
        self.data_group = self.table_group = self.model_group = self.row_group = None
        if groups:
            self.data_group = self._group([grid[:, m, t] for m in range(model)
                                           for t in range(table)])
            self.table_group = self._group([grid[d, m, :] for d in range(data)
                                            for m in range(model)])
            self.model_group = self._group([grid[d, :, t] for d in range(data)
                                            for t in range(table)])
            self.row_group = (self._group([grid[d].reshape(-1) for d in range(data)])
                              if model > 1 else self.table_group)

    def _group(self, members):
        """Every rank creates every group of more than one rank, in the same
        order (``new_group`` is collective); returns this rank's."""
        mine = None
        for ranks in members:
            if len(ranks) < 2:
                continue
            group = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                mine = group
        return mine

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at data {self.data_rank}, "
                f"model {self.model_rank}, table {self.table_rank})")
