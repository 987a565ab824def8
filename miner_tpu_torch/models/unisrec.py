"""UniSRec: a SASRec-style sequential recommender over a MoE-adapted news
tower.

Counterpart of ``miner_tpu/models/unisrec.py``: the history's news
representations (``NewsEncoderMoe``, 300 wide) get learned position
embeddings, an fp32 LayerNorm and dropout, then run through a 2-layer
causal transformer (hidden 300, 2 heads of 150, inner 256, dropout 0.5 /
0.5, LayerNorm eps 1e-12, exact GELU); the user vector is its output at
position 0, and a candidate's score is its dot product with it.

What the JAX package does, kept here:

  * the SASRec layers take the unfused path (``PLMConfig(fused=False)``):
    JAX never sends them to Pallas (``sasrec_encoder_cfg`` leaves both
    kernel flags off), their mask is causal per query and their Dh is 150;
  * the mask is ``where(valid[:, None, None, :] & tril, 0, -10000)`` in
    fp32, added to the logits. Query 0 attends key 0 alone, so with the
    default clicks-first rows the score depends on the first history slot
    only; under ``--legacy_history_layout`` a short history puts a pad
    there, every key of row 0 then carries the same -10000, and row 0
    attends over all slots, later ones included, by their raw logits;
  * the tail computes in fp32 whatever ``--compute_dtype`` says: the
    trainer builds ``UniSRec`` without a dtype (trainer.py:301), so a bf16
    history row added to the fp32 position table is promoted, and bf16
    candidates are dotted with the fp32 user vector in fp32.

``forward`` encodes the candidates and the history in one news-encoder
call (unisrec.py:95-111); ``tail`` is the vanilla interface the cached
scoring calls. (JAX's ``__call__`` passes the titles alone, so under
``--use_sapo --combine_type linear`` its init fails; here that call takes
the sapo too, as the cache fill does in both packages.) Submodule names
follow the JAX tree (``trm_layer_{i}`` becomes ``trm_layers.{i}``).
Training freezes all but the MoE adaptor; the trainer applies that.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.models.news_encoder import NewsEncoderMoe
from miner_tpu_torch.models.plm import LayerNorm, PLMConfig, TransformerLayer, normal_init_

MASK_FILL = -10000.0


def sasrec_encoder_cfg(hidden_size: int = 300) -> PLMConfig:
    """The sequential encoder's config (unisrec.py:29-43): the reference's
    hard-coded hyperparameters, hidden following the news encoder's
    output, on the unfused layer path."""
    return PLMConfig(vocab_size=1, hidden_size=hidden_size, num_layers=2, num_heads=2,
                     intermediate_size=256, max_position_embeddings=50,
                     layer_norm_eps=1e-12, hidden_dropout=0.5, attention_dropout=0.5,
                     fused=False)


class UniSRec(nn.Module):
    def __init__(self, news_encoder: NewsEncoderMoe, max_his_len: int = 50):
        super().__init__()
        cfg = sasrec_encoder_cfg(news_encoder.embed_dim)
        self.cfg = cfg
        self.news_encoder = news_encoder
        self.position_embedding = nn.Embedding(max_his_len, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.trm_layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX's initialisers: N(0, 0.02) for every Linear and Embedding
        (the position table's ``normal(0.02)`` among them), LayerNorm ones
        and zeros, then the adaptor's zeros and N(0, 0.02) experts."""
        normal_init_(self, self.cfg.initializer_range, generator)
        self.news_encoder.moe_adaptor.reset_parameters(generator,
                                                       self.cfg.initializer_range)

    def encode_news(self, title_ids, title_mask, sapo_ids=None, sapo_mask=None,
                    rng: Optional[DropoutRNG] = None):
        """Encode a flat (N, L) batch of news: the cache-fill entry point."""
        return self.news_encoder(title_ids, title_mask, sapo_ids, sapo_mask, rng)

    def tail(self, cand_repr: torch.Tensor, his_repr: torch.Tensor,
             his_mask: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """The causal encoder over (B, H, D) history rows and the dot scores
        of (B, C, D) candidates: (B, C) float32 logits."""
        H = his_repr.shape[1]
        x = self.ln(his_repr + self.position_embedding.weight[:H])  # fp32
        rate = self.cfg.hidden_dropout
        if dropout_active(self, rng, rate):
            x = rng.dropout(x, rate)
        valid = his_mask.bool()
        causal = torch.ones(H, H, dtype=torch.bool, device=x.device).tril()
        bias = torch.where(valid[:, None, None, :] & causal, 0.0, MASK_FILL)
        for layer in self.trm_layers:
            x = layer(x, bias, rng=rng)
        user = x[:, 0]  # position 0 (model_unisrec.py:543)
        return torch.einsum("bcd,bd->bc", cand_repr.float(), user)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """(B, C) logits for a model batch (``NewsTable.lookup``): candidates
        and history through the news encoder together, then ``tail``."""
        cand_repr, his_repr = self.news_encoder.encode_batch(batch, rng)
        return self.tail(cand_repr, his_repr, batch["his_mask"], rng)
