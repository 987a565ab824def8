"""MINER: multi-interest matching network for news recommendation.

Counterpart of ``miner_tpu/models/miner.py``: a shared news encoder, an
optional category bias (pairwise cosine between history and candidate
category embeddings), poly-attention extracting K interest vectors, and
candidate-interest dot-product scores aggregated by ``max``, ``mean`` or
``weighted`` (target-aware attention). The serving path uses the granular
methods so the candidate gather and per-interest scoring can run in the
lookup+score op directly against the news-embedding cache; training calls
the model on a batch (``forward``), which encodes candidates and history
in one PLM call per field (``NewsEncoder.encode_batch``; JAX
``encode_all_news``, miner.py:112-136) and runs the tail. In training mode
the category embeddings take dropout at ``dropout`` (``--dropout``,
miner.py:91,145-150), with masks from the step's ``DropoutRNG``; the model
computes in ``dtype`` with fp32 parameters.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.models.news_encoder import NewsEncoder
from miner_tpu_torch.models.poly_attention import PolyAttention, TargetAwareAttention
from miner_tpu_torch.ops.lookup_score import lookup_score_fused
from miner_tpu_torch.parallel.news_cache import gathered_dtype
from miner_tpu_torch.utils import pairwise_cosine_similarity


class CategoryEmbedding(nn.Module):
    """Category embedding whose pad row is exactly zero (miner.py:57).
    ``pretrained`` (a (num_categories, embed_dim) array) seeds the table."""

    def __init__(self, num_categories: int, embed_dim: int, pad_id: int,
                 pretrained: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad_id = pad_id
        self.dtype = dtype
        self.pretrained = pretrained
        self.weight = nn.Parameter(torch.empty(num_categories, embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.pretrained is not None:
            self.weight.data.copy_(torch.as_tensor(self.pretrained, dtype=torch.float32))
        else:
            nn.init.normal_(self.weight, 0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight).to(self.dtype)
        return torch.where((ids != self.pad_id)[..., None], out, 0.0)


class Miner(nn.Module):
    def __init__(self, news_encoder: NewsEncoder, use_category_bias: bool = True,
                 num_context_codes: int = 32, context_code_dim: int = 200,
                 score_type: str = "weighted", num_categories: int = 0,
                 category_embed_dim: int = 100, category_pad_id: int = 0,
                 category_embed: Optional[np.ndarray] = None,
                 legacy_mask: bool = False, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if score_type not in ("max", "mean", "weighted"):
            raise ValueError(f"invalid score_type {score_type!r}")
        self.news_encoder = news_encoder
        self.use_category_bias = use_category_bias
        self.score_type = score_type
        self.dropout = dropout
        embed_dim = news_encoder.embed_dim
        if use_category_bias:
            cat_dim = (category_embed.shape[1] if category_embed is not None
                       else category_embed_dim)
            self.category_embedding = CategoryEmbedding(
                num_categories, cat_dim, category_pad_id, category_embed, dtype)
        self.poly_attn = PolyAttention(embed_dim, num_context_codes,
                                       context_code_dim, legacy_mask, dtype)
        if score_type == "weighted":
            self.target_aware_attn = TargetAwareAttention(embed_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with the JAX package's schemes
        (the numbers differ from JAX's: its PRNG is another one)."""
        self.news_encoder.reset_parameters(generator)
        if self.use_category_bias:
            self.category_embedding.reset_parameters(generator)
        self.poly_attn.reset_parameters(generator)
        if self.score_type == "weighted":
            self.target_aware_attn.reset_parameters(generator)

    def encode_news(self, title_ids, title_mask, sapo_ids=None, sapo_mask=None,
                    rng: Optional[DropoutRNG] = None):
        """Encode a flat (N, L) batch of news: the cache-fill entry point."""
        return self.news_encoder(title_ids, title_mask, sapo_ids, sapo_mask, rng)

    def category_bias_from_ids(self, his_category: torch.Tensor,
                               cand_category: torch.Tensor,
                               rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """(B, H, C) pairwise category cosine."""
        his = self.category_embedding(his_category)
        cand = self.category_embedding(cand_category)
        if dropout_active(self, rng, self.dropout):
            his, cand = rng.dropout(his, self.dropout), rng.dropout(cand, self.dropout)
        return pairwise_cosine_similarity(his, cand)

    def interests_from_history(self, his_repr: torch.Tensor,
                               his_mask: torch.Tensor,
                               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, K, D) multi-interest vectors via poly-attention."""
        return self.poly_attn(his_repr, his_mask, bias)

    def aggregate_matching(self, interests: torch.Tensor, scores: torch.Tensor,
                           cand_repr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C) final matching scores from (B, C, K) per-interest scores."""
        if self.score_type == "max":
            return scores.max(dim=-1).values
        if self.score_type == "mean":
            return scores.mean(dim=-1)
        return self.target_aware_attn(interests, cand_repr, scores)

    def matching_from_cache(self, cache, cand_idx: torch.Tensor,
                            interests: torch.Tensor) -> torch.Tensor:
        """(B, C) matching scores of (B, C) rows of the news-embedding cache
        (a tensor or ``Int8Rows``) without gathering them: the per-interest
        scores and, for the weighted score, the target-aware logits (the
        candidate rows dotted with the projected interests) both come from
        the lookup+score op, which reads the rows in the cache's own type."""
        scores = lookup_score_fused(cache, cand_idx, interests)
        if self.score_type != "weighted":
            return self.aggregate_matching(interests, scores)
        proj = self.target_aware_attn.project(interests)
        # JAX's promotion: the product with fp32 rows (the lstm combine's) is fp32
        proj = proj.to(torch.promote_types(proj.dtype, gathered_dtype(cache)))
        return self.target_aware_attn.weigh(lookup_score_fused(cache, cand_idx, proj),
                                            scores)

    def tail(self, cand_repr: torch.Tensor, his_repr: torch.Tensor,
             cand_category: torch.Tensor, his_category: torch.Tensor,
             his_mask: torch.Tensor, rng: Optional[DropoutRNG] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything after the news towers: category bias, poly-attention
        and scoring. Returns (interests (B, K, D), matching (B, C))."""
        bias = None
        if self.use_category_bias:
            bias = self.category_bias_from_ids(his_category, cand_category, rng)
        interests = self.interests_from_history(his_repr, his_mask, bias)
        scores = torch.einsum("bcd,bkd->bck", cand_repr, interests)
        return interests, self.aggregate_matching(interests, scores, cand_repr)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(interests (B, K, D), matching scores (B, C)) for a model batch
        (``NewsTable.lookup``)."""
        cand_repr, his_repr = self.news_encoder.encode_batch(batch, rng)
        return self.tail(cand_repr, his_repr, batch["cand_category"],
                         batch["his_category"], batch["his_mask"], rng)
