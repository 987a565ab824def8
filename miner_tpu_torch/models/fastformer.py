"""Fastformer additive-attention user encoder.

Counterpart of ``miner_tpu/models/fastformer.py``: a 2-layer Fastformer
(hidden 256, 16 heads, intermediate 256) runs over the clicked-news
representations, a tanh-MLP attention pooler makes one user vector, and a
candidate's score is its dot product with it. Per layer:

  mixed = fastformer_attention(q = W_q x, k = W_k x)     # the op, ops/
  x     = LN(x + dropout(attn_out(W_t mixed + q)))
  x     = LN(x + dropout(ffn_out(gelu(ffn_in(x)))))

What the JAX package does, kept here:

  * the user encoder computes in float32 whatever ``--compute_dtype`` says:
    the trainer builds it without a dtype, so a bf16 history row added to
    the fp32 position table is promoted, and the logits of bf16 candidates
    against the fp32 user vector come out fp32. Only the news encoder
    computes in bf16;
  * masked positions get -10000 in the attention (``MASK_FILL``), so a fully
    masked history runs the attention softmax over every position as if
    none were masked, and the pooler, ``exp(a) * mask / (sum + 1e-8)`` with
    no max subtracted and no softmax, makes it a zero user vector;
  * exact GELU, LayerNorm eps 1e-12 in fp32, positions ``arange(L)`` with no
    RoBERTa offset;
  * dropout at ``hidden_dropout`` (``--dropout``) after the embedding
    LayerNorm, after ``attn_out`` and after ``ffn_out``, in training mode,
    with masks from the step's ``DropoutRNG``. (The JAX config's
    ``attention_dropout`` is never read there, so the port has none.)

``FastSelfAttention`` always calls ``fastformer_attention_fused``: the op
runs its plain version on the CPU and the kernel on the card. Submodule names
follow the JAX tree (``fast_attn.layers.{i}.self_attn.query``...) so
``models.convert.params_from_jax`` carries weights over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.models.news_encoder import NewsEncoder
from miner_tpu_torch.models.plm import Dense, LayerNorm, normal_init_
from miner_tpu_torch.ops.fastformer_attn import fastformer_attention_fused


@dataclasses.dataclass(frozen=True)
class FastformerConfig:
    hidden_size: int = 256
    num_heads: int = 16
    intermediate_size: int = 256
    num_layers: int = 2
    hidden_dropout: float = 0.2
    layer_norm_eps: float = 1e-12
    max_position_embeddings: int = 256
    initializer_range: float = 0.02


class FastSelfAttention(nn.Module):
    def __init__(self, cfg: FastformerConfig):
        super().__init__()
        D, h = cfg.hidden_size, cfg.num_heads
        self.num_heads = h
        self.query = Dense(D, D)
        self.key = Dense(D, D)
        self.query_att_kernel = nn.Parameter(torch.empty(D, h))
        self.query_att_bias = nn.Parameter(torch.zeros(h))
        self.key_att_kernel = nn.Parameter(torch.empty(D, h))
        self.key_att_bias = nn.Parameter(torch.zeros(h))
        self.transform = Dense(D, D)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, L, D), mask (B, L) int32 validity."""
        q, k = self.query(x), self.key(x)
        mixed = fastformer_attention_fused(q, k, self.query_att_kernel,
                                           self.query_att_bias,
                                           self.key_att_kernel,
                                           self.key_att_bias, mask, self.num_heads)
        return self.transform(mixed) + q


class FastformerLayer(nn.Module):
    def __init__(self, cfg: FastformerConfig):
        super().__init__()
        D = cfg.hidden_size
        self.dropout = cfg.hidden_dropout
        self.self_attn = FastSelfAttention(cfg)
        self.attn_out = Dense(D, D)
        self.attn_ln = LayerNorm(D, cfg.layer_norm_eps)
        self.ffn_in = Dense(D, cfg.intermediate_size)
        self.ffn_out = Dense(cfg.intermediate_size, D)
        self.ffn_ln = LayerNorm(D, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        dropping = dropout_active(self, rng, self.dropout)
        attn = self.attn_out(self.self_attn(x, mask))
        if dropping:
            attn = rng.dropout(attn, self.dropout)
        x = self.attn_ln(x + attn)
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate="none"))
        if dropping:
            h = rng.dropout(h, self.dropout)
        return self.ffn_ln(x + h)


class AttentionPooling(nn.Module):
    """tanh-MLP pooling with the reference's arithmetic: masked ``exp``
    weights over their sum + 1e-8 (a zero vector for a fully masked row)."""

    def __init__(self, cfg: FastformerConfig):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.hidden_size)
        self.fc2 = Dense(cfg.hidden_size, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        alpha = torch.exp(self.fc2(torch.tanh(self.fc1(x))).float())
        alpha = alpha * mask.float()[..., None]
        alpha = alpha / (alpha.sum(dim=1, keepdim=True) + 1e-8)
        return torch.einsum("bld,bl->bd", x.float(), alpha[..., 0])


class Fastformer(nn.Module):
    """The user encoder: position embeddings, the layers, the pooler;
    float32 throughout."""

    def __init__(self, cfg: FastformerConfig = FastformerConfig()):
        super().__init__()
        self.cfg = cfg
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(FastformerLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = AttentionPooling(cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, initializer_range) weights, zero biases, as the JAX init."""
        std = self.cfg.initializer_range
        normal_init_(self, std, generator)
        for layer in self.layers:
            att = layer.self_attn
            for w in (att.query_att_kernel, att.key_att_kernel):
                nn.init.normal_(w, 0.0, std, generator=generator)
            nn.init.zeros_(att.query_att_bias)
            nn.init.zeros_(att.key_att_bias)

    def forward(self, input_embs: torch.Tensor, attention_mask: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """input_embs (B, L, D) in any type, attention_mask (B, L) -> (B, D)
        float32."""
        L = input_embs.shape[1]
        x = self.ln(input_embs.float() + self.position_embeddings.weight[:L])
        if dropout_active(self, rng, self.cfg.hidden_dropout):
            x = rng.dropout(x, self.cfg.hidden_dropout)
        mask = attention_mask.to(torch.int32).contiguous()
        for layer in self.layers:
            x = layer(x, mask, rng)
        return self.pooler(x, mask)


class FastformerUserModel(nn.Module):
    """Two towers: the shared news encoder and the Fastformer user encoder.
    Scores are logits only (no interests); ``news_encoder.embed_dim`` must
    equal ``cfg.hidden_size``."""

    def __init__(self, news_encoder: NewsEncoder,
                 cfg: FastformerConfig = FastformerConfig()):
        super().__init__()
        if news_encoder.embed_dim != cfg.hidden_size:
            raise ValueError(f"news embeddings of {news_encoder.embed_dim} do not "
                             f"fit a Fastformer of hidden {cfg.hidden_size}")
        self.news_encoder = news_encoder
        self.fast_attn = Fastformer(cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.news_encoder.reset_parameters(generator)
        self.fast_attn.reset_parameters(generator)

    def encode_news(self, title_ids, title_mask, sapo_ids=None, sapo_mask=None,
                    rng: Optional[DropoutRNG] = None):
        """Encode a flat (N, L) batch of news: the cache-fill entry point."""
        return self.news_encoder(title_ids, title_mask, sapo_ids, sapo_mask, rng)

    def tail(self, cand_repr: torch.Tensor, his_repr: torch.Tensor,
             his_mask: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """User encoding and scoring from news representations: (B, C)
        float32 logits."""
        user = self.fast_attn(his_repr, his_mask, rng)
        return torch.einsum("bcd,bd->bc", cand_repr.float(), user)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """(B, C) logits for a model batch (``NewsTable.lookup``)."""
        cand_repr, his_repr = self.news_encoder.encode_batch(batch, rng)
        return self.tail(cand_repr, his_repr, batch["his_mask"], rng)
