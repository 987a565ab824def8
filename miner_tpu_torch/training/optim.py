"""Optimizer: global-norm clip, AdamW with decay groups, linear warmup,
gradient accumulation.

Counterpart of ``miner_tpu/training/optim.py:make_optimizer``, which chains
``optax.clip_by_global_norm``, ``optax.adamw`` with ``default_decay_mask``
and ``linear_warmup_schedule``, inside ``optax.MultiSteps``. The port keeps
each semantic:

  * the decay mask as two parameter groups: no decay for rank < 2, or for a
    name ending in bias / LayerNorm (so embedding tables decay, as in the
    reference);
  * ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8), whose decoupled
    decay ``p * (1 - lr * wd)`` equals optax's ``-lr * wd * p`` term;
  * optax's clip, ``g`` when the global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (not ``clip_grad_norm_``, whose ``+1e-6``
    differs);
  * MultiSteps' accumulation: the mean of k micro-batch gradients, clipped
    once, one AdamW update. The schedule counts updates, not micro-batches,
    and the first update runs at the schedule's value for 0 (lr 0 under
    warmup), as optax's count starts at 0;
  * over a mesh's data axis (``grad_group``, the ranks that share this
    rank's model and table coordinates): each rank's accumulated gradient
    is its share of the global batch's, and at the update they are summed
    over the group (one ``all_reduce`` a bucket of flattened fp32 gradients)
    before the division and the clip, so the clip sees the global gradient,
    as optax's over a sharded gradient does. Ranks that share rows (the
    table axis's replicas, ``replica_group``) compute the same gradients
    but for the order of the card's atomic adds, so they take the sum of
    their group's first rank (``replica_root``, a broadcast), and every
    rank applies the same update, bit for bit. No
    ``DistributedDataParallel``: its hooks would reduce every micro-batch,
    where MultiSteps sums once an update;
  * over a mesh's model axis (``parallel/tp.py``) a sharded leaf
    (``sharded``: its name) holds the rank's share: its squares are summed
    over the model group (``model_group``) for the global norm, and a
    replicated leaf's counted once; the replicas of a sharded leaf's share
    are the table group's (``shard_replica_group``), those of a replicated
    leaf every rank of the same rows (``replica_group``). AdamW's moments of
    a share stay on its rank.

Frozen parameters (``requires_grad`` False, ``--freeze_transformer``) are
left out, as optax's ``set_to_zero`` leaves them out of the clipped norm. A
trainable parameter that no micro-batch's loss reached (the lstm combine's
last backward cell never sees a recurrent state) takes a zero gradient, as
optax updates every leaf: its moments decay and weight decay applies, where
``torch.optim.AdamW`` would skip it.
"""
from __future__ import annotations

import math
import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

_NO_DECAY = re.compile(r"(bias|scale|\bln\b|layer_norm|layernorm)", re.IGNORECASE)
BUCKET = 1 << 24  # fp32 gradient elements a bucket of the sum over the data group (64 MB)


def linear_warmup_schedule(learning_rate: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """Linear 0 -> lr over warmup, then linear lr -> 0 at total_steps."""
    return lambda step: scheduled_lr_value(learning_rate, warmup_steps,
                                           total_steps, step)


def scheduled_lr_value(learning_rate: float, warmup_steps: int,
                       total_steps: int, step: int) -> float:
    """The learning rate of optimizer update ``step`` (0-based)."""
    if step < warmup_steps:
        return learning_rate * min(step / max(warmup_steps, 1), 1.0)
    return learning_rate * max(
        (total_steps - step) / max(total_steps - warmup_steps, 1), 0.0)


def warmup_steps_from_ratio(total_steps: int, warmup_ratio: float,
                            warmup_steps: Optional[int] = None) -> int:
    if warmup_steps is not None:
        return warmup_steps
    return math.ceil(total_steps * warmup_ratio)


def decays(name: str, p: torch.Tensor) -> bool:
    """``default_decay_mask``: decay everything but rank-<2 leaves, biases
    and LayerNorm parameters."""
    return p.dim() >= 2 and not _NO_DECAY.search(name.rsplit(".", 1)[-1])


def decay_groups(named: Iterable[Tuple[str, torch.nn.Parameter]],
                 weight_decay: float) -> List[Dict]:
    decay, no_decay = [], []
    for name, p in named:
        if p.requires_grad:
            (decay if decays(name, p) else no_decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


class Optimizer:
    """Call :meth:`step` after every micro-batch's ``backward()``: every
    ``accum_steps``-th call applies one update from the mean gradient."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 learning_rate: float, total_steps: int, warmup_steps: int,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 accum_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_group=None, replica_group=None,
                 replica_root: int = 0, sharded=frozenset(), model_group=None,
                 shard_replica_group=None, shard_replica_root: int = 0):
        named_params = list(named_params)
        groups = decay_groups(named_params, weight_decay)
        self.params = [p for g in groups for p in g["params"]]
        name_of = {id(p): n for n, p in named_params}
        # the parameters' names in the optimizer's order (its state's keys)
        self.names = [name_of[id(p)] for p in self.params]
        self.sharded = [n in sharded for n in self.names]
        self.model_group = model_group
        self.shard_replica_group, self.shard_replica_root = (shard_replica_group,
                                                             shard_replica_root)
        self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps)
        self.schedule = linear_warmup_schedule(learning_rate, warmup_steps,
                                               total_steps)
        self.max_grad_norm = max_grad_norm
        self.accum_steps = max(1, accum_steps)
        self.mini_step = 0  # micro-batches accumulated towards the next update
        self.updates = 0
        self.grad_group, self.replica_group, self.replica_root = (grad_group, replica_group,
                                                                  replica_root)
        # each update's sum over the data group (and broadcast to the replicas)
        self.sum_seconds: List[float] = []
        # the last update's global gradient norm, before the clip (on the device)
        self.grad_norm: Optional[torch.Tensor] = None

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.updates)

    def step(self) -> bool:
        """Count one micro-batch; on the k-th, update. True if it updated."""
        self.mini_step += 1
        if self.mini_step < self.accum_steps:
            return False
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        shards = [g for g, s in zip(grads, self.sharded) if s]
        whole = [g for g, s in zip(grads, self.sharded) if not s]
        with torch.no_grad():
            if shards:
                self.sum_seconds.append(
                    sum_over(whole, self.grad_group, self.replica_group, self.replica_root)
                    + sum_over(shards, self.grad_group, self.shard_replica_group,
                               self.shard_replica_root))
            elif self.grad_group is not None or self.replica_group is not None:
                self.sum_seconds.append(sum_over(grads, self.grad_group, self.replica_group,
                                                 self.replica_root))
            if self.accum_steps > 1:
                for g in grads:
                    g.div_(self.accum_steps)
            if self.model_group is None:
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            else:  # the shares' squares summed over the model group
                dev = grads[0].device
                norm = torch.sqrt(_squares(shards, dev, self.model_group) + _squares(whole, dev))
            self.grad_norm = norm
            below = norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(below, g, g / norm * self.max_grad_norm))
        lr = self.lr()
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.mini_step = 0
        self.updates += 1
        return True

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "updates": self.updates}

    def by_index(self, state: Dict) -> Dict:
        """``state`` whose AdamW moments are keyed by parameter name (a
        checkpoint converted from JAX, ``checkpoint.state_from_jax``) as
        :meth:`state_dict` gives it: in this optimizer's order, with its
        groups. Raises ``ValueError`` where the names are not this
        optimizer's trainable parameters."""
        named = state["adamw"]["state"]
        if set(named) != set(self.names):
            missing = sorted(set(self.names) - set(named))[:5]
            extra = sorted(set(named) - set(self.names))[:5]
            raise ValueError(
                "the checkpoint's optimizer state is not over this run's trainable "
                "parameters (the model flags and --freeze_transformer must be the "
                f"checkpointed run's): missing {missing}, unexpected {extra}")
        adamw = {"state": {i: named[n] for i, n in enumerate(self.names)},
                 "param_groups": self.adamw.state_dict()["param_groups"]}
        return dict(state, adamw=adamw)

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])


def _squares(grads: List[torch.Tensor], device, group=None) -> torch.Tensor:
    """The sum of the squares of ``grads`` (an fp32 scalar on ``device``),
    summed over ``group`` when given."""
    if grads:
        total = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]).square().sum()
    else:
        total = torch.zeros((), dtype=torch.float32, device=device)
    if group is not None:
        total = total.clone()
        dist.all_reduce(total, group=group)
    return total


def sum_over(tensors: List[torch.Tensor], group, replicas=None, root: int = 0) -> float:
    """Sum same-typed ``tensors`` over ``group`` in place (none: as they
    are), then give ``replicas`` the sums of their rank ``root`` (a global
    rank), flattened into buckets of up to :data:`BUCKET` elements (a tensor
    larger than that is a bucket of its own): one ``all_reduce`` and one
    ``broadcast`` a bucket. Returns the seconds it took, the device
    synchronized before and after."""
    sync = tensors and tensors[0].is_cuda
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    bucket: List[torch.Tensor] = []
    size = 0
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel()
        if size >= BUCKET or i == len(tensors) - 1:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            if group is not None:
                dist.all_reduce(flat, group=group)
            if replicas is not None:
                dist.broadcast(flat, root, group=replicas)
            offset = 0
            for b in bucket:
                b.copy_(flat[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
            bucket, size = [], 0
    if sync:
        torch.cuda.synchronize()
    return time.perf_counter() - t0
