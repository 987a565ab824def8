"""The news-embedding cache, on one device.

Counterpart of ``miner_tpu/parallel/news_cache.py``: the news encoder runs
once over the whole corpus, producing a (N, D) table of news embeddings;
each serving request then gathers rows from it and runs only the model's
tail (zero PLM calls per request). ``CacheFiller`` encodes the corpus in
chunks of 512 news with a Python loop (the JAX package's ``lax.scan``).
Mesh placement, the int8 cache (``Int8Rows``) and ``save_cache`` /
``load_cache`` are not ported yet (ROADMAP Queue 1, items 3 and 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from miner_tpu_torch.data.device_table import NewsTable


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (R, ...) table for an index tensor of any shape."""
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


@dataclasses.dataclass
class NewsEmbeddingCache:
    embeddings: torch.Tensor  # (R, D) in the compute type
    category: torch.Tensor  # (R,) int32
    category_pad_id: int

    @property
    def num_rows(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]


class CacheFiller:
    """Encodes the whole news table in chunks of ``batch_size`` rows.

    ``encode_fn(title, title_mask, sapo, sapo_mask) -> (n, D)``; each news
    is encoded on its own, so the last, shorter chunk needs no padding."""

    def __init__(self, encode_fn: Callable[..., torch.Tensor],
                 batch_size: int = 512):
        self.encode_fn = encode_fn
        self.batch_size = batch_size

    def fill(self, table: NewsTable) -> NewsEmbeddingCache:
        R = table.title.shape[0]
        chunks = []
        with torch.inference_mode():
            for start in range(0, R, self.batch_size):
                t = table.title[start:start + self.batch_size]
                tm = (t != table.pad_token_id).to(torch.int32)
                s = sm = None
                if table.sapo is not None:
                    s = table.sapo[start:start + self.batch_size]
                    sm = (s != table.pad_token_id).to(torch.int32)
                chunks.append(self.encode_fn(t, tm, s, sm))
        return NewsEmbeddingCache(embeddings=torch.cat(chunks),
                                  category=table.category,
                                  category_pad_id=table.category_pad_id)
