"""News encoder: PLM tower -> fixed-size news representation.

Counterpart of ``miner_tpu/models/news_encoder.py:NewsEncoder``: title (and
sapo) token ids run through the shared PLM, the CLS representation is taken,
an optional ``reduce_dim`` linear maps it to ``word_embed_dim``, and the
``linear`` combine maps [title, sapo] to one vector. In training mode
``reduce_dim``'s output takes dropout at ``dropout`` (``--dropout``,
news_encoder.py:95,122), its mask drawn from the step's ``DropoutRNG``. The
``lstm`` and ``pre-concat`` combines are not ported yet (ROADMAP Queue 1,
the other combines).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.models.plm import Dense, PLMConfig, TransformerPLM


class NewsEncoder(nn.Module):
    def __init__(self, plm_cfg: PLMConfig, apply_reduce_dim: bool = True,
                 word_embed_dim: int = 256, use_sapo: bool = True,
                 combine_type: str = "linear", dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_sapo and combine_type != "linear":
            raise NotImplementedError(
                f"--combine_type {combine_type!r} is not ported yet (ROADMAP Queue 1: the other combines); "
                "the port has the linear title/sapo combine")
        self.plm_cfg = plm_cfg
        self.use_sapo = use_sapo
        self.dropout = dropout
        self.plm = TransformerPLM(plm_cfg, dtype)
        base = word_embed_dim if apply_reduce_dim else plm_cfg.hidden_size
        self.reduce_dim = (Dense(plm_cfg.hidden_size, word_embed_dim)
                           if apply_reduce_dim else None)
        self.linear_combine = Dense(2 * base, base) if use_sapo else None
        self.embed_dim = base

    def _field_repr(self, ids: torch.Tensor, mask: torch.Tensor,
                    rng: Optional[DropoutRNG]) -> torch.Tensor:
        repr_ = self.plm(ids, mask, rng=rng)[:, 0, :]
        if self.reduce_dim is not None:
            repr_ = self.reduce_dim(repr_)
            if dropout_active(self, rng, self.dropout):
                repr_ = rng.dropout(repr_, self.dropout)
        return repr_

    def forward(self, title_ids: torch.Tensor, title_mask: torch.Tensor,
                sapo_ids: Optional[torch.Tensor] = None,
                sapo_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        title_repr = self._field_repr(title_ids, title_mask, rng)
        if not self.use_sapo:
            return title_repr
        sapo_repr = self._field_repr(sapo_ids, sapo_mask, rng)
        return self.linear_combine(torch.cat([title_repr, sapo_repr], dim=-1))

    def encode_batch(self, batch: Dict[str, torch.Tensor],
                     rng: Optional[DropoutRNG] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One PLM call per field over a model batch's candidates and
        history concatenated (``encode_all_news``, miner.py:112-136):
        (cand_repr (B, C, D), his_repr (B, H, D))."""
        B, C = batch["cand_title"].shape[:2]
        H = batch["his_title"].shape[1]

        def both(name):  # (B, C, L) and (B, H, L) -> (B*(C+H), L)
            return torch.cat([batch[f"cand_{name}"].flatten(0, 1),
                              batch[f"his_{name}"].flatten(0, 1)])

        sapo = sapo_mask = None
        if self.use_sapo and "cand_sapo" in batch:
            sapo, sapo_mask = both("sapo"), both("sapo_mask")
        reprs = self(both("title"), both("title_mask"), sapo, sapo_mask, rng)
        return (reprs[:B * C].reshape(B, C, -1), reprs[B * C:].reshape(B, H, -1))
