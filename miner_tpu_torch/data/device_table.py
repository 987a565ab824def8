"""NewsTable: the tokenized news corpus as tensors on the device.

Counterpart of ``miner_tpu/data/device_table.py``: requests carry int32 row
indices, and the token rows are gathered on the device from this table.
Token masks are ``ids != pad_token_id`` and the history mask is
``category != category pad`` (reference: src/entities.py:391-400).
``lookup`` builds exactly the model batch the JAX package's ``lookup``
(device_table.py:60) builds, from (B, C) candidate and (B, H) history rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from miner_tpu_torch.data.news_store import NewsStore


@dataclasses.dataclass
class NewsTable:
    title: torch.Tensor  # (V*N, Lt) int32
    sapo: Optional[torch.Tensor]  # (V*N, Ls) int32 or None
    category: torch.Tensor  # (V*N,) int32
    pad_token_id: int
    category_pad_id: int

    @staticmethod
    def from_store(store: NewsStore, use_sapo: bool = True,
                   combine_type: str = "linear",
                   device: torch.device = torch.device("cpu")) -> "NewsTable":
        if combine_type == "pre-concat":
            title, sapo = store.flat_title_preconcat(), None
        else:
            title = store.flat_title()
            sapo = store.flat_sapo() if use_sapo else None
        put = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        return NewsTable(
            title=put(title),
            sapo=put(sapo) if sapo is not None else None,
            category=put(store.flat_category()),
            pad_token_id=store.pad_token_id,
            category_pad_id=store.category_pad_id,
        )

    def _gather_field(self, table: torch.Tensor, idx: torch.Tensor):
        ids = table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
        return ids, (ids != self.pad_token_id).to(torch.int32)

    def lookup_candidates(self, cand_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, C) global rows -> the candidate half of a model batch."""
        batch: Dict[str, torch.Tensor] = {}
        batch["cand_title"], batch["cand_title_mask"] = self._gather_field(
            self.title, cand_idx)
        if self.sapo is not None:
            batch["cand_sapo"], batch["cand_sapo_mask"] = self._gather_field(
                self.sapo, cand_idx)
        batch["cand_category"] = self.category[cand_idx.long()]
        return batch

    def lookup(self, cand_idx: torch.Tensor, his_idx: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """cand_idx (B, C), his_idx (B, H) global rows -> model batch."""
        batch = self.lookup_candidates(cand_idx)
        batch["his_title"], batch["his_title_mask"] = self._gather_field(
            self.title, his_idx)
        if self.sapo is not None:
            batch["his_sapo"], batch["his_sapo_mask"] = self._gather_field(
                self.sapo, his_idx)
        batch["his_category"] = self.category[his_idx.long()]
        batch["his_mask"] = (batch["his_category"]
                             != self.category_pad_id).to(torch.int32)
        return batch
