"""Tensor and expert parallelism over the mesh's ``model`` axis.

Counterpart of ``miner_tpu/parallel/tp.py``, whose ``_RULES`` place the
parameters (its :func:`tp_param_shardings`):

  * ``qkv`` and ``ffn_in`` are column-parallel: each rank of the model
    group (the ranks that share this rank's data and table coordinates)
    holds its share of their output features and of their biases;
  * ``attention/out`` and ``ffn_out`` are row-parallel: each rank holds its
    share of their input features, the bias whole;
  * the MoE adaptor's ``experts/kernel`` (E, D_in, D_out) and
    ``experts/bias`` (E, D_in) shard on the expert axis;
  * everything else is replicated, and so is a leaf whose sharded dimension
    does not divide by the model size.

The rules reach every ``TransformerLayer`` (the roberta / bert towers,
UnBERT's two stacks, UniSRec's SASRec tail) and the Fastformer layers'
``ffn_in`` / ``ffn_out``.

The port differs from JAX in one place, on purpose: ``qkv`` is split by
head. Rank m takes the Q, K and V features of heads [m H/W, (m+1) H/W) out
of the ``[Q | K | V]`` layout (JAX's column split would give it a
contiguous third of them), and ``attention/out`` the input features of the
same heads, so that the mha kernels run on the rank's own heads, a local
(N, L, 3D/W) with H/W heads, their dropout drawn at the heads' places
(``head_offset``). Where H does not divide by W the layer's attention is
replicated, as a non-dividing leaf is in JAX. The math is JAX's: GSPMD
reshards its layout to the same function.

JAX lets XLA place the collectives; here they are Megatron's pair of
conjugate operators over the model group: :func:`copy_to_model` (identity
forward, all-reduce backward) before a column-parallel product, and
:func:`reduce_from_model` (all-reduce forward, identity backward) after a
row-parallel one, whose bias is added once, after the sum. A
transformer layer runs 2 all-reduces forward and 2 backward; the experts'
gated mixture is summed over the group the same way. LayerNorm and add_ln
run on the summed, full rows, the same on every rank of the group.

Parameters are sharded after the model is whole (built, loaded, checked
equal over the ranks): :func:`shard_` replaces each sharded parameter by
the rank's share and returns the specs; :func:`full_state_dict` gathers
them back (a checkpoint holds full tensors whatever the mesh) and
:func:`local_state_dict` takes a rank's share of full ones. The
collectives are broadcasts and all-reduces, which gloo offers for CUDA
tensors, so ranks sharing one card run them too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import torch
import torch.distributed as dist

from miner_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from miner_tpu_torch.parallel.sharding import every_rank


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a leaf splits over the model group: axis ``dim`` is ``parts``
    equal blocks (qkv's Q, K and V: 3), each cut into ``size`` equal
    shares; rank ``rank`` holds share ``rank`` of every block."""

    dim: int
    parts: int
    rank: int
    size: int

    def local(self, full: torch.Tensor) -> torch.Tensor:
        return torch.cat([blk.chunk(self.size, self.dim)[self.rank]
                          for blk in full.chunk(self.parts, self.dim)], self.dim).contiguous()

    def full(self, shares: List[torch.Tensor]) -> torch.Tensor:
        """The full leaf from every rank's share, in model-rank order."""
        return torch.cat([torch.cat([s.chunk(self.parts, self.dim)[p] for s in shares],
                                    self.dim) for p in range(self.parts)], self.dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model ``group`` (the
    input of a column-parallel product: each rank's gradient is the share
    of its columns)."""
    return _CopyToModel.apply(x, group) if torch.is_grad_enabled() and x.requires_grad else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the model ``group`` (the output of a row-parallel
    product); its gradient as it is."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def shard_(model: torch.nn.Module, mesh: Mesh) -> Dict[str, Shard]:
    """Shard ``model``'s parameters over ``mesh``'s model group in place and
    tell its layers to run their parallel forward; returns {parameter
    name: its ``Shard``} (empty with a model size of 1), kept as
    ``model.tp_specs``."""
    from miner_tpu_torch.models.fastformer import FastformerLayer
    from miner_tpu_torch.models.news_encoder import MoEAdaptor
    from miner_tpu_torch.models.plm import TransformerLayer

    W, m, group = mesh.shape[MODEL_AXIS], mesh.model_rank, mesh.model_group
    specs: Dict[str, Shard] = {}
    if W == 1:
        model.tp_specs = specs
        return specs

    def place(prefix: str, module: torch.nn.Module, name: str, dim: int, parts: int = 1):
        p = getattr(module, name)
        spec = Shard(dim, parts, m, W)
        p.data = spec.local(p.data)
        specs[f"{prefix}{name}"] = spec

    def ffn(prefix: str, layer) -> None:
        if layer.ffn_in.out_features % W:
            return
        place(f"{prefix}ffn_in.", layer.ffn_in, "weight", 0)
        place(f"{prefix}ffn_in.", layer.ffn_in, "bias", 0)
        place(f"{prefix}ffn_out.", layer.ffn_out, "weight", 1)
        layer.ffn_in.parallel, layer.ffn_out.parallel = "column", "row"
        layer.ffn_in.group = layer.ffn_out.group = group

    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, TransformerLayer):
            att = module.attention
            if att.num_heads % W == 0:
                place(f"{prefix}attention.qkv.", att.qkv, "weight", 0, 3)
                place(f"{prefix}attention.qkv.", att.qkv, "bias", 0, 3)
                place(f"{prefix}attention.out.", att.out, "weight", 1)
                att.qkv.parallel, att.out.parallel = "column", "row"
                att.qkv.group = att.out.group = group
                att.head_offset = m * att.num_heads // W
                att.num_heads //= W
            ffn(prefix, module)
        elif isinstance(module, FastformerLayer):
            ffn(prefix, module)
        elif isinstance(module, MoEAdaptor) and module.experts.kernel.shape[0] % W == 0:
            place(f"{prefix}experts.", module.experts, "kernel", 0)
            place(f"{prefix}experts.", module.experts, "bias", 0)
            module.experts_share = (m * module.experts.kernel.shape[0], group)
    model.tp_specs = specs
    return specs


def specs_of(model: torch.nn.Module) -> Dict[str, Shard]:
    """The ``Shard`` of each sharded parameter of ``model`` (none unsharded)."""
    return getattr(model, "tp_specs", {})


def gather(t: torch.Tensor, spec: Shard, group) -> torch.Tensor:
    """The full leaf of this rank's share ``t``, from every rank's share
    over the model ``group`` (exact bytes)."""
    return spec.full(every_rank(t, group))


def full_state_dict(model: torch.nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter gathered whole
    (a collective over the model group: every rank calls it)."""
    state = model.state_dict()
    specs = specs_of(model)
    return {k: gather(v, specs[k], mesh.model_group) if k in specs else v
            for k, v in state.items()}


def local_state_dict(state: Mapping[str, torch.Tensor], specs: Mapping[str, Shard]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shares of a state dict of full tensors."""
    return {k: specs[k].local(v) if k in specs else v for k, v in state.items()}


def full_optimizer_state(state: Dict, names: List[str], specs: Mapping[str, Shard],
                         group) -> Dict:
    """An ``Optimizer.state_dict()`` whose AdamW moments of sharded leaves
    (``names``: the optimizer's parameter names in order) are gathered
    whole over the model ``group``."""
    return _map_moments(state, names, specs, lambda t, spec: gather(t, spec, group))


def local_optimizer_state(state: Dict, names: List[str], specs: Mapping[str, Shard]) -> Dict:
    """This rank's shares of an ``Optimizer.state_dict()`` of full moments."""
    return _map_moments(state, names, specs, lambda t, spec: spec.local(t))


def _map_moments(state: Dict, names: List[str], specs: Mapping[str, Shard], fn) -> Dict:
    if not specs:
        return state
    adamw = dict(state["adamw"])
    moments = {}
    for i, s in adamw["state"].items():
        spec = specs.get(names[int(i)])
        moments[i] = {k: fn(v, spec) if spec is not None and torch.is_tensor(v) and v.dim()
                      else v for k, v in s.items()}
    adamw["state"] = moments
    return dict(state, adamw=adamw)
