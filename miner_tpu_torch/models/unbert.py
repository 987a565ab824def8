"""UnBERT: a single-tower cross-encoder for news recommendation.

Counterpart of ``miner_tpu/models/unbert.py`` (reference:
src/model/model_unbert.py:18-289):

  * the candidate title and the user's clicked titles are packed into one
    token sequence ``[CLS] cand [SEP] hist_1 .. hist_n [SEP]``
    (``data/unbert_packing.py``) with per-news *news-segment* embeddings (64
    segments) added to the word, position and token-type embeddings; the
    positions are ``arange(L)``, with no ``position_offset``;
  * a word-level transformer encodes the packed sequence;
  * the news-level sequence is made by ``news_mode``: ``nseg`` gathers the
    hidden states at ``sentence_ids``; ``mean`` averages each news' token
    span [sentence_ids[i], sentence_ids[i+1]) (the (B, S, L) membership mask
    times the hidden states, over the mask's sum + 1e-6); ``attention``
    weights every token by a two-layer sigmoid MLP over the flattened
    sequence first, and scales the hidden states in place, so the
    word-level CLS is weighted too, as the reference does;
  * a second transformer of ``num_news_layers`` layers encodes the news
    sequence;
  * the head projects the word-level and news-level CLS states, concatenated,
    to 2 logits and returns ``logits[:, 1]`` as the click score.

Both transformers are stacks of the port's ``plm.TransformerLayer``, so
every attention runs the mha op and every post-LN site the add_ln op: on the
card, the port's kernels, at L = 300 for the word level and L = 3 +
hist_max_len (23) for the news level. A layer's three kernel dropout seeds
are drawn from the step's ``DropoutRNG`` before it runs, word layers first,
as ``TransformerPLM`` draws them. No layer is rematerialised whatever
``--remat`` says: the JAX package's ``UNBert`` calls ``TransformerLayer``
directly and never wraps it in ``nn.remat`` (``miner_tpu/models/unbert.py``,
``miner_tpu/models/plm.py:424-452``), and rematerialising would change
memory and time, not the numbers.

Parameter names follow the JAX tree (``word_layer_{i}`` becomes
``word_layers.{i}``, ``news_layer_{i}`` ``news_layers.{i}``), so
``models.convert.params_from_jax`` carries weights over.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from miner_tpu_torch.data.unbert_packing import SEQ_MAX_LEN
from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.models.plm import Dense, LayerNorm, PLMConfig, TransformerLayer

NUM_NEWS_SEGMENTS = 64
NEWS_MODES = ("nseg", "mean", "attention")


def segment_weights(sentence_ids: torch.Tensor, sentence_mask: torch.Tensor,
                    input_mask: torch.Tensor, L: int) -> torch.Tensor:
    """(B, S, L) boolean membership: token t belongs to news i iff
    sentence_ids[i] <= t < sentence_ids[i+1] (the next *valid* sentence,
    else the end of the sequence), news i is valid and token t is attended."""
    starts = sentence_ids.long()
    smask = sentence_mask.bool()
    B = starts.shape[0]
    next_start = torch.cat([starts[:, 1:], starts.new_full((B, 1), L)], dim=1)
    next_valid = torch.cat([smask[:, 1:], smask.new_zeros((B, 1))], dim=1)
    ends = torch.where(next_valid, next_start, L)
    pos = torch.arange(L, device=starts.device)
    member = (pos[None, None, :] >= starts[:, :, None]) & (pos[None, None, :] < ends[:, :, None])
    return member & smask[:, :, None] & input_mask.bool()[:, None, :]


class UNBert(nn.Module):
    """``forward(batch, rng)``: click scores (B,) in ``dtype`` from the
    packed features of ``data.unbert_packing.FEATURES``, (B, L) and (B, S).
    ``seq_len`` is the packed length L, which sizes ``att_mapping_in`` and
    ``att_mapping_out`` in the ``attention`` mode."""

    def __init__(self, cfg: PLMConfig, num_news_layers: Optional[int] = None,
                 news_mode: str = "nseg", dtype: torch.dtype = torch.float32,
                 seq_len: int = SEQ_MAX_LEN):
        super().__init__()
        if news_mode not in NEWS_MODES:
            raise ValueError(f"unknown news_mode {news_mode!r}")
        D = cfg.hidden_size
        self.cfg = cfg
        self.news_mode = news_mode
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, D)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, D)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, D)
        self.news_segment_embeddings = nn.Embedding(NUM_NEWS_SEGMENTS, D)
        self.emb_ln = LayerNorm(D, cfg.layer_norm_eps)
        self.word_layers = nn.ModuleList(TransformerLayer(cfg)
                                         for _ in range(cfg.num_layers))
        if news_mode == "attention":
            self.att_mapping_in = Dense(seq_len * D, 128)
            self.att_mapping_out = Dense(128, seq_len)
        self.news_layers = nn.ModuleList(TransformerLayer(cfg)
                                         for _ in range(num_news_layers or cfg.num_layers))
        self.score_head = Dense(2 * D, 2)

    def _encode(self, layers: nn.ModuleList, x: torch.Tensor, mask: torch.Tensor,
                rng: Optional[DropoutRNG]) -> torch.Tensor:
        cfg = self.cfg
        mask = mask.to(torch.int32).contiguous()
        dropping = dropout_active(self, rng, max(cfg.hidden_dropout, cfg.attention_dropout))
        offset = rng.rows_of(x.shape[0]).offset if dropping else 0
        for layer in layers:
            x = layer(x, mask, rng.kernel_seeds(layer.SEEDS) if dropping else None, offset)
        return x

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        input_ids = batch["input_ids"]
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos)[None].to(dt)
             + self.token_type_embeddings(batch["segment_ids"]).to(dt)
             + self.news_segment_embeddings(batch["news_segment_ids"]).to(dt))
        x = self.emb_ln(x)
        if dropout_active(self, rng, cfg.hidden_dropout):
            x = rng.dropout(x, cfg.hidden_dropout)
        x = self._encode(self.word_layers, x, batch["input_mask"], rng)

        if self.news_mode == "nseg":
            # the hidden state at each sentence id (upstream: the first S
            # positions, data/unbert_packing.py)
            idx = batch["sentence_ids"].long()[..., None].expand(-1, -1, x.shape[-1])
            news_seq = torch.gather(x, 1, idx)
        else:
            member = segment_weights(batch["sentence_ids"], batch["sentence_mask"],
                                     batch["input_mask"], L).to(x.dtype)
            w = member
            if self.news_mode == "attention":
                tok_w = self.att_mapping_out(
                    torch.sigmoid(self.att_mapping_in(x.reshape(x.shape[0], -1))))
                x = x * tok_w[..., None]
                w = member * tok_w[:, None, :]
            # attention: the scaled states summed over the member mask, over
            # the sum of the weights
            news_seq = torch.bmm(member, x) / (w.sum(-1, keepdim=True) + 1e-6)
        y = self._encode(self.news_layers, news_seq.contiguous(), batch["sentence_mask"], rng)
        logits = self.score_head(torch.cat([x[:, 0], y[:, 0]], dim=-1))
        return logits[:, 1]
