"""NewsTable: the tokenized news corpus as tensors on the device.

Counterpart of ``miner_tpu/data/device_table.py``: requests carry int32 row
indices, and the token rows are gathered on the device from this table.
Token masks are ``ids != pad_token_id`` and the history mask is
``category != category pad`` (reference: src/entities.py:391-400).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
