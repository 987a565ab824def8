"""A BERT/RoBERTa-family pretrained-language-model tower in PyTorch.

Counterpart of ``miner_tpu/models/plm.py``: one fused QKV projection per
layer, post-LN blocks, static position ids ``arange(L) + position_offset``
(plm.py:381), exact or tanh GELU per ``gelu_approx``. Every attention goes
through the mha op and every post-LN site (``attention_ln``, ``ffn_ln``)
through the add_ln op, so on the card the tower runs the port's kernels.

Parameter names follow the JAX tree (``layer_{i}`` becomes ``layers.{i}``)
so ``models.convert.miner_params_from_jax`` can carry weights over. LayerNorm
parameters stay fp32 when the rest of the model is cast to the compute type
(:func:`cast_to_compute_`), as the JAX package keeps fp32 masters and fp32
LayerNorm statistics. This slice is inference only: dropout comes with the
training slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    pad_token_id: int = 1
    position_offset: int = 2
    initializer_range: float = 0.02
    # tanh-approximate gelu; the trainer turns it on for bf16 compute
    gelu_approx: bool = False

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


class AddLN(LayerNorm):
    """``LN(x + h)`` through the fused add_ln op (a post-LN site)."""

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        n = self.weight.shape[0]
        y = fused_dropout_add_ln(x.reshape(-1, n), h.reshape(-1, n),
                                 self.weight, self.bias, 0.0, self.eps)
        return y.reshape(x.shape)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection."""

    def __init__(self, cfg: PLMConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.out(fused_mha(self.qkv(x), mask, self.num_heads))


class TransformerLayer(nn.Module):
    """Post-LN block (BERT layout: attn -> add&LN -> FFN -> add&LN)."""

    def __init__(self, cfg: PLMConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.attention_ln = AddLN(cfg.hidden_size, cfg.layer_norm_eps)
        self.ffn_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ffn_ln = AddLN(cfg.hidden_size, cfg.layer_norm_eps)
        self.gelu = "tanh" if cfg.gelu_approx else "none"

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attention_ln(x, self.attention(x, mask))
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate=self.gelu))
        return self.ffn_ln(x, h)


class Embeddings(nn.Module):
    def __init__(self, cfg: PLMConfig):
        super().__init__()
        self.position_offset = cfg.position_offset
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        position_ids = torch.arange(L, device=input_ids.device) + self.position_offset
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)[None]
             + self.token_type_embeddings(token_type_ids))
        return self.ln(x)


class TransformerPLM(nn.Module):
    """The full encoder tower. Returns the last hidden states (B, L, D)."""

    def __init__(self, cfg: PLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(TransformerLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        mask = attention_mask.to(torch.int32).contiguous()
        for layer in self.layers:
            x = layer(x, mask)
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
