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
the backward with ``torch.utils.checkpoint`` (JAX: ``nn.remat``,
plm.py:430-452); the layer's kernel seeds are drawn before it and passed
in, so the recompute draws the same masks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.ops.add_ln import fused_dropout_add_ln
from miner_tpu_torch.ops.mha import fused_mha


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
    # rematerialise every layer in the backward (--remat)
    remat: bool = False
    # tanh-approximate gelu; the trainer turns it on for bf16 compute
    gelu_approx: bool = False
    # the mha and add_ln kernels (True), or the unfused layer of plain
    # products under an additive bias of any broadcastable shape (False;
    # JAX's path with fused_attention and fused_ln off, plm.py:215-236)
    fused: bool = True

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


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's type: the fp32 master weight
    is cast at use, as flax's ``Dense(dtype=...)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class AddLN(LayerNorm):
    """``LN(x + dropout(h))`` through the fused add_ln op (a post-LN site)."""

    def forward(self, x: torch.Tensor, h: torch.Tensor, rate: float = 0.0,
                seed: int = 0) -> torch.Tensor:
        n = self.weight.shape[0]
        y = fused_dropout_add_ln(x.reshape(-1, n), h.reshape(-1, n),
                                 self.weight, self.bias, rate, self.eps, seed)
        return y.reshape(x.shape)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection: through the
    mha op (``forward``) or JAX's unfused products (``plain``)."""

    def __init__(self, cfg: PLMConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, rate: float = 0.0,
                seed: int = 0) -> torch.Tensor:
        return self.out(fused_mha(self.qkv(x), mask, self.num_heads, rate, 1, seed))

    def plain(self, x: torch.Tensor, bias: torch.Tensor, rate: float = 0.0,
              rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """JAX's unfused attention (plm.py:215-236): logits in fp32 scaled
        by an fp32 1/sqrt(Dh), plus the additive ``bias`` (any shape that
        broadcasts to (B, heads, L, L)); an fp32 softmax cast to x's type;
        dropout at ``rate`` on the probabilities; the context."""
        B, L, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x)
        q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, L, H, D // H).transpose(1, 2)
                   for i in range(3))
        scale = 1.0 / torch.sqrt(torch.tensor(float(D // H), device=x.device))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale + bias.float()
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        if rate > 0.0:
            probs = rng.dropout(probs, rate)
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
                seeds: Optional[Sequence[int]] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Fused: ``mask`` (B, L) int32 and ``seeds`` (three kernel seeds)
        turn dropout on, None is deterministic. Unfused: ``mask`` is the
        additive bias and ``rng`` draws the dropout in training mode."""
        if not self.fused:
            return self._plain(x, mask, rng)
        p_attn = p_hid = 0.0
        s_attn = s_ln1 = s_ln2 = 0
        if seeds is not None:
            p_attn, p_hid = self.attention_dropout, self.hidden_dropout
            s_attn, s_ln1, s_ln2 = seeds
        x = self.attention_ln(x, self.attention(x, mask, p_attn, s_attn), p_hid, s_ln1)
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate=self.gelu))
        return self.ffn_ln(x, h, p_hid, s_ln2)

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
        for layer in self.layers:
            seeds = rng.kernel_seeds(layer.SEEDS) if dropping else None
            if remat:
                # the seeds are arguments, so the recompute drops the same
                # elements; no global RNG state is read inside the layer
                x = checkpoint(layer, x, mask, seeds, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, mask, seeds)
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
    stay fp32 (the add_ln kernel takes fp32 gamma and beta)."""
    for m in module.modules():
        if isinstance(m, LayerNorm):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module
