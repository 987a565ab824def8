"""Poly-attention multi-interest extraction and target-aware aggregation.

Counterpart of ``miner_tpu/models/poly_attention.py``:

  * ``PolyAttention``: K learned context codes attend over the clicked-news
    history; ``tanh(e_h W)`` projected onto the codes gives per-code logits,
    shifted by the category bias (its mean over candidates,
    poly_attention.py:94-96); masked slots get -1e9, or under
    ``legacy_mask`` (``--legacy_poly_mask``) the reference's 1e-30 in place
    of logits + bias, so that pads keep a weight (poly_attention.py:54-55;
    a user with no clicks gets the mean of all H rows, pads included);
    softmax over history; weighted sum of history representations ->
    (B, K, D). Both fills run through the poly-attention op (the port's
    kernel on the card, the fill a launch argument), where the JAX package
    sends the legacy fill down its XLA path.
  * ``TargetAwareAttention``: ``softmax(key @ gelu(W q)^T)`` weights over the
    K interest scores, summed -> (B, C), with exact GELU.

Both compute in the model's ``dtype`` as flax's ``.astype(self.dtype)`` and
``Dense(dtype=...)`` do, whatever type their inputs come in: under the lstm
combine the news vectors are fp32 in a bf16 model, and then poly-attention
runs in fp32 on parameters rounded to bf16, the target-aware projection in
bf16, and its product with the fp32 candidates in fp32 (JAX's promotion).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from miner_tpu_torch.models.plm import Dense, lecun_normal_
from miner_tpu_torch.ops.poly_attention import LEGACY_FILL, NEG_INF, poly_attention_fused


class PolyAttention(nn.Module):
    def __init__(self, embed_dim: int, num_context_codes: int,
                 context_code_dim: int, legacy_mask: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_fill = LEGACY_FILL if legacy_mask else NEG_INF
        self.dtype = dtype
        self.proj_kernel = nn.Parameter(torch.empty(embed_dim, context_code_dim))
        self.context_codes = nn.Parameter(
            torch.empty(num_context_codes, context_code_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        D, P = self.proj_kernel.shape
        K = self.context_codes.shape[0]
        lecun_normal_(self.proj_kernel.data, D, generator)
        # Xavier-uniform with tanh gain (5/3), as the reference inits the codes
        bound = (5.0 / 3.0) * math.sqrt(6.0 / (K + P))
        nn.init.uniform_(self.context_codes, -bound, bound, generator=generator)

    def forward(self, embeddings: torch.Tensor, attn_mask: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """embeddings (B, H, D), attn_mask (B, H), bias (B, H, C) or None."""
        if bias is not None:
            bias = bias.mean(dim=-1).float().contiguous()
        dt = embeddings.dtype
        return poly_attention_fused(
            embeddings.contiguous(), self.proj_kernel.to(self.dtype).to(dt),
            self.context_codes.to(self.dtype).to(dt),
            attn_mask.to(torch.int32).contiguous(), bias, self.mask_fill)


class TargetAwareAttention(nn.Module):
    """Candidate-aware aggregation of the K per-interest matching scores."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(embed_dim, embed_dim, bias=False)
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.proj.weight.data, self.proj.in_features, generator)

    def project(self, query: torch.Tensor) -> torch.Tensor:
        """(B, K, D) interests -> the (B, K, D) vectors each candidate is
        dotted with, in the model's type."""
        return F.gelu(self.proj(query.to(self.dtype)))

    def weigh(self, logits: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """(B, C, K) candidate logits and per-interest scores -> (B, C)."""
        weights = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        return torch.sum(weights * value, dim=-1)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        """query (B, K, D) interests, key (B, C, D) candidates, value
        (B, C, K) per-interest scores -> (B, C)."""
        proj = self.project(query)
        proj = proj.to(torch.promote_types(proj.dtype, key.dtype))
        return self.weigh(torch.einsum("bcd,bkd->bck", key, proj), value)
