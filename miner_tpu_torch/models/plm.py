"""A BERT/RoBERTa-family pretrained-language-model tower in PyTorch.

Counterpart of ``miner_tpu/models/plm.py``: one fused QKV projection per
layer, post-LN blocks, static position ids ``arange(L) + position_offset``
(plm.py:381), exact or tanh GELU per ``gelu_approx``. Every attention goes
through the mha op and every post-LN site (``attention_ln``, ``ffn_ln``)
through the add_ln op, so on the card the tower runs the port's kernels.
A ``TransformerLayer`` of ``PLMConfig(fused=False)`` runs JAX's unfused
layer instead, plain products under an additive bias: UniSRec's SASRec
stack, which JAX never sends to Pallas (unisrec.py:29-43).

Parameter names follow the JAX tree (``layer_{i}`` becomes ``layers.{i}``)
so ``models.convert.params_from_jax`` can carry weights over.

Mixed precision as flax does it: parameters stay fp32 masters, and the
tower computes in its ``dtype`` (``--compute_dtype``): embedding rows are
cast to it after the lookup and every ``Dense`` casts its weight to its
input's type at use. LayerNorm parameters and statistics stay fp32. Serving
may also cast the parameters once (:func:`cast_to_compute_`): casting once
or at each use gives the same values.

Dropout, in training mode only (``train()``; ``eval()`` is the JAX
package's ``deterministic=True``): ``hidden_dropout`` after the embedding
LayerNorm (plm.py:400) and on the residual branch of both add_ln sites of
every layer (in the add_ln kernel), ``attention_dropout`` on the attention
probabilities (in the mha kernel). ``remat`` rematerialises each layer in
the backward with ``torch.utils.checkpoint`` and keeps what JAX's
``nn.remat`` keeps (plm.py:430-452, :class:`Remat`): the attention context
and the softmax statistics of the mha forward (JAX's ``"attn_ctx"``; the
port's backward kernel reads both), so the recompute launches no mha
forward; under ``remat_policy="dots"`` also the output of every product
with no batch dims (qkv, out, ffn_in, ffn_out; JAX's
``dots_with_no_batch_dims_saveable``), so it runs no matmul either. The
rest (the add_ln sites, GELU, the weight casts) is recomputed under both.
The layer's kernel seeds are drawn before it and passed in, so the
recompute draws the same masks. Over a mesh a rank's sequences take their
masks at their places in the global batch (``DropoutRNG.rows_of``: the
kernels' ``seq_offset`` and ``row_offset``).

Under tensor parallelism (``parallel/tp.py``) a layer holds its rank's
share of ``qkv`` and ``ffn_in`` (column-parallel) and of ``out`` and
``ffn_out`` (row-parallel): each ``Dense`` knows its part (``parallel``)
and runs the model group's collective itself, and the attention runs the
rank's heads (``num_heads``, ``head_offset``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.ops.add_ln import fused_dropout_add_ln
from miner_tpu_torch.ops.mha import fused_mha
from miner_tpu_torch.ops.philox import Offsets, scaled
from miner_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

REMAT_POLICIES = ("", "dots")


@dataclasses.dataclass(frozen=True)
class PLMConfig:
    """Architecture hyperparameters for the transformer tower.

    ``position_offset`` encodes the RoBERTa convention where position ids
    start at ``pad_token_id + 1`` (=2 for roberta-base); BERT uses 0.
    """

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 1
    position_offset: int = 2
    initializer_range: float = 0.02
    # rematerialise every layer in the backward (--remat), saving the
    # attention context, and with "dots" every product (--remat_policy)
    remat: bool = False
    remat_policy: str = ""
    # tanh-approximate gelu; the trainer turns it on for bf16 compute
    gelu_approx: bool = False
    # the mha and add_ln kernels (True), or the unfused layer of plain
    # products under an additive bias of any broadcastable shape (False;
    # JAX's path with fused_attention and fused_ln off, plm.py:215-236)
    fused: bool = True

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} (use '' or 'dots')")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def roberta_base() -> "PLMConfig":
        return PLMConfig()

    @staticmethod
    def bert_base() -> "PLMConfig":
        return PLMConfig(vocab_size=30522, max_position_embeddings=512,
                         type_vocab_size=2, layer_norm_eps=1e-12,
                         pad_token_id=0, position_offset=0)

    @staticmethod
    def tiny(vocab_size: int = 1024) -> "PLMConfig":
        """A small config for tests (CPU-friendly)."""
        return PLMConfig(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                         num_heads=4, intermediate_size=128,
                         max_position_embeddings=256, type_vocab_size=2,
                         pad_token_id=0, position_offset=0)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 ``weight`` (gamma) and ``bias`` (beta) and fp32
    statistics; the output comes back in the input's type."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Remat:
    """What one rematerialised layer call keeps of its forward for its
    recompute (``--remat``): a slot for each kept op, in call order. The
    forward (the first run) fills each slot with the op's outputs; the
    recompute (each later run) hands them back in the same order, so the
    op runs no kernel and no product again. Each op's autograd Function
    saves the same tensors in both runs, as ``torch.utils.checkpoint``
    requires. ``dots`` keeps the products' outputs as well as the mha
    forward's."""

    def __init__(self, dots: bool):
        self.dots = dots
        self.slots: List[list] = []
        self.at: Optional[int] = None

    def run(self, layer: nn.Module, *args) -> torch.Tensor:
        self.at = 0 if self.slots else None  # None: the first run, filling slots
        return layer(*args, remat=self)

    def slot(self) -> list:
        if self.at is None:
            self.slots.append([])
            return self.slots[-1]
        self.at += 1
        return self.slots[self.at - 1]


class _KeptLinear(torch.autograd.Function):
    """``F.linear`` whose output a rematerialised layer keeps (``--remat
    --remat_policy dots``): the first run computes it into the slot, the
    recompute returns the kept one; the backward is linear's (the input's
    and the weight's gradients by one product each, the bias's a sum)."""

    @staticmethod
    def forward(ctx, x, weight, bias, kept):
        if not kept:
            kept.append(F.linear(x, weight, bias))
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return kept[0].detach()

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = (g2 @ weight).reshape(x.shape) if ctx.needs_input_grad[0] else None
        gw = g2.t() @ x.reshape(-1, x.shape[-1]) if ctx.needs_input_grad[1] else None
        gb = g2.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb, None


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's type: the fp32 master weight
    is cast at use, as flax's ``Dense(dtype=...)`` does. Under ``--remat
    --remat_policy dots`` its output is kept for the recompute (``remat``).
    Under tensor parallelism ``parallel`` is ``"column"`` (the rank's output
    features: the input's gradient summed over the model ``group``) or
    ``"row"`` (the rank's input features: the output summed over the group,
    then the bias added once)."""

    parallel: Optional[str] = None
    group = None

    def forward(self, x: torch.Tensor, remat: Optional[Remat] = None) -> torch.Tensor:
        if self.parallel == "column":
            x = copy_to_model(x, self.group)
        row = self.parallel == "row"
        bias = None if self.bias is None or row else self.bias.to(x.dtype)
        if remat is not None and remat.dots:
            y = _KeptLinear.apply(x, self.weight.to(x.dtype), bias, remat.slot())
        else:
            y = F.linear(x, self.weight.to(x.dtype), bias)
        if row:
            y = reduce_from_model(y, self.group)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)
        return y


class AddLN(LayerNorm):
    """``LN(x + dropout(h))`` through the fused add_ln op (a post-LN site)."""

    def forward(self, x: torch.Tensor, h: torch.Tensor, rate: float = 0.0,
                seed: int = 0, seq_offset: Offsets = 0) -> torch.Tensor:
        """``seq_offset``: the places of x's sequences (its leading axis) in
        the global batch."""
        n = self.weight.shape[0]
        tokens = x.numel() // (n * x.shape[0])  # rows of add_ln a sequence
        y = fused_dropout_add_ln(x.reshape(-1, n), h.reshape(-1, n),
                                 self.weight, self.bias, rate, self.eps, seed,
                                 scaled(seq_offset, tokens))
        return y.reshape(x.shape)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection: through the
    mha op (``forward``) or JAX's unfused products (``plain``). Under
    tensor parallelism it runs ``num_heads`` of ``total_heads`` heads,
    from ``head_offset`` on."""

    def __init__(self, cfg: PLMConfig):
        super().__init__()
        self.num_heads = self.total_heads = cfg.num_heads
        self.head_offset = 0
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, rate: float = 0.0,
                seed: int = 0, remat: Optional[Remat] = None,
                seq_offset: Offsets = 0) -> torch.Tensor:
        ctx = fused_mha(self.qkv(x, remat), mask, self.num_heads, rate, 1, seed,
                        None if remat is None else remat.slot(), seq_offset, self.head_offset)
        return self.out(ctx, remat)

    def plain(self, x: torch.Tensor, bias: torch.Tensor, rate: float = 0.0,
              rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """JAX's unfused attention (plm.py:215-236): logits in fp32 scaled
        by an fp32 1/sqrt(Dh), plus the additive ``bias`` (any shape that
        broadcasts to (B, heads, L, L)); an fp32 softmax cast to x's type;
        dropout at ``rate`` on the probabilities; the context."""
        B, L, _ = x.shape
        H = self.num_heads
        qkv = self.qkv(x)
        D = qkv.shape[-1] // 3  # this rank's heads' features
        q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, L, H, D // H).transpose(1, 2)
                   for i in range(3))
        scale = 1.0 / torch.sqrt(torch.tensor(float(D // H), device=x.device))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale + bias.float()
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        if rate > 0.0:
            heads = None if H == self.total_heads else (self.head_offset, self.total_heads)
            probs = rng.dropout(probs, rate, heads)
        return self.out(torch.matmul(probs, v).transpose(1, 2).reshape(B, L, D))


class TransformerLayer(nn.Module):
    """Post-LN block (BERT layout: attn -> add&LN -> FFN -> add&LN).

    ``cfg.fused`` picks the path, as JAX's ``fused_attention`` / ``fused_ln``
    do: the mha and add_ln kernels under a (B, L) key mask, or the unfused
    layer (plm.py:309-327) under an additive bias, with dropout drawn from
    the step's ``DropoutRNG`` (so it is never rematerialised) and
    ``LN(x + dropout(h))`` summed in x's type with fp32 statistics. Both
    keep the same parameter names."""

    SEEDS = 3  # kernel dropout seeds per layer: attention, attention_ln, ffn_ln

    def __init__(self, cfg: PLMConfig):
        super().__init__()
        self.fused = cfg.fused
        self.attention_dropout = cfg.attention_dropout
        self.hidden_dropout = cfg.hidden_dropout
        self.attention = SelfAttention(cfg)
        ln = AddLN if cfg.fused else LayerNorm
        self.attention_ln = ln(cfg.hidden_size, cfg.layer_norm_eps)
        self.ffn_in = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.ffn_ln = ln(cfg.hidden_size, cfg.layer_norm_eps)
        self.gelu = "tanh" if cfg.gelu_approx else "none"

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                seeds: Optional[Sequence[int]] = None, offset: Offsets = 0,
                rng: Optional[DropoutRNG] = None,
                remat: Optional[Remat] = None) -> torch.Tensor:
        """Fused: ``mask`` (B, L) int32 and ``seeds`` (three kernel seeds)
        turn dropout on, None is deterministic; ``offset``: the places of
        the B sequences in the global batch (their masks' place);
        ``remat``: the record of a rematerialised call. Unfused: ``mask``
        is the additive bias and ``rng`` draws the dropout in training
        mode."""
        if not self.fused:
            return self._plain(x, mask, rng)
        p_attn = p_hid = 0.0
        s_attn = s_ln1 = s_ln2 = 0
        if seeds is not None:
            p_attn, p_hid = self.attention_dropout, self.hidden_dropout
            s_attn, s_ln1, s_ln2 = seeds
        x = self.attention_ln(x, self.attention(x, mask, p_attn, s_attn, remat, offset), p_hid,
                              s_ln1, offset)
        h = self.ffn_out(F.gelu(self.ffn_in(x, remat), approximate=self.gelu), remat)
        return self.ffn_ln(x, h, p_hid, s_ln2, offset)

    def _plain(self, x: torch.Tensor, bias: torch.Tensor,
               rng: Optional[DropoutRNG]) -> torch.Tensor:
        p_attn = self.attention_dropout if dropout_active(
            self, rng, self.attention_dropout) else 0.0
        p_hid = self.hidden_dropout if dropout_active(self, rng, self.hidden_dropout) else 0.0

        def drop(h):
            return rng.dropout(h, p_hid) if p_hid > 0.0 else h

        x = self.attention_ln(x + drop(self.attention.plain(x, bias, p_attn, rng)))
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate=self.gelu))
        return self.ffn_ln(x + drop(h))


class Embeddings(nn.Module):
    def __init__(self, cfg: PLMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden_dropout = cfg.hidden_dropout
        self.position_offset = cfg.position_offset
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        L = input_ids.shape[1]
        dt = self.dtype
        position_ids = torch.arange(L, device=input_ids.device) + self.position_offset
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(position_ids)[None].to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        x = self.ln(x)
        if dropout_active(self, rng, self.hidden_dropout):
            x = rng.dropout(x, self.hidden_dropout)
        return x


class TransformerPLM(nn.Module):
    """The full encoder tower on the kernels (``cfg.fused``). Returns the
    last hidden states (B, L, D) in ``dtype``."""

    def __init__(self, cfg: PLMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if not cfg.fused:
            raise ValueError("the PLM tower runs the mha and add_ln kernels; the "
                             "unfused layer is for stacks that call it directly")
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, dtype)
        self.layers = nn.ModuleList(TransformerLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        cfg = self.cfg
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids, rng)
        mask = attention_mask.to(torch.int32).contiguous()
        dropping = dropout_active(self, rng, max(cfg.hidden_dropout,
                                                 cfg.attention_dropout))
        remat = cfg.remat and self.training and torch.is_grad_enabled()
        offset = rng.rows_of(x.shape[0]).offset if dropping else 0
        for layer in self.layers:
            seeds = rng.kernel_seeds(layer.SEEDS) if dropping else None
            if remat:
                # the seeds are arguments, so the recompute drops the same
                # elements; no global RNG state is read inside the layer
                x = checkpoint(Remat(cfg.remat_policy == "dots").run, layer, x, mask, seeds,
                               offset, use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, mask, seeds, offset)
        return x


def normal_init_(module: nn.Module, std: float, generator: torch.Generator) -> None:
    """N(0, std) for every Linear and Embedding weight under ``module``,
    zero Linear biases, LayerNorm ones/zeros: the JAX package's
    ``dense_init`` scheme."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
        if isinstance(m, nn.Linear) and m.bias is not None:
            nn.init.zeros_(m.bias)
        if isinstance(m, LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at 2 sigma, rescaled to
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def cast_to_compute_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter to the compute type except LayerNorm's, which
    stay fp32 (the add_ln kernel takes fp32 gamma and beta), and those under
    a module whose ``fp32_params`` is True (the lstm combine: flax computes
    its cells in fp32 from fp32 parameters, whatever the compute type)."""
    keep = {id(p) for m in module.modules() if getattr(m, "fp32_params", False)
            for p in m.parameters()}
    for m in module.modules():
        if isinstance(m, LayerNorm):
            continue
        for p in m.parameters(recurse=False):
            if id(p) not in keep:
                p.data = p.data.to(dtype)
    return module
