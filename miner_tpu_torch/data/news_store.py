"""NewsStore: the tokenized news corpus as fixed-shape numpy tables.

The port's own copy of ``miner_tpu/data/news_store.py`` (the port imports
nothing of the JAX package); it must give the same ``id_to_row`` and token
tables. It replaces the reference's per-`News`-object dictionaries
(reference: src/reader.py:89-133, src/entities.py:15-66). The whole corpus is
tokenized once into padded int32 arrays; every later stage (the device-side
gather, the embedding cache) works with row indices instead of Python
objects.

Layout: ``title``/``sapo`` are (V, N, L) where V = 1 + number of augmentation
variants (variant 0 is "vanilla") and row 0 of every variant is the pad news
([CLS, EOS/SEP] only, category "pad" — reference: src/reader.py:101-108).
A *global index* ``v * N + row`` addresses a (variant, news) pair in the
flattened (V*N, L) view used on device.

Augmentation files follow the reference naming convention
``{aug}_news.tsv`` next to ``news.tsv`` (reference: src/reader.py:83).
"""
from __future__ import annotations

import csv
import dataclasses
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from miner_tpu_torch import constants
from miner_tpu_torch.data.tokenization import Tokenizer


@dataclasses.dataclass
class NewsStore:
    title: np.ndarray  # (V, N, Lt) int32, padded with pad_token_id
    sapo: np.ndarray  # (V, N, Ls) int32
    category: np.ndarray  # (V, N) int32
    id_to_row: Dict[str, int]  # news id -> row (shared across variants)
    variants: List[str]  # ["vanilla", aug1, ...]
    pad_token_id: int
    category_pad_id: int

    PAD_ROW = 0

    @property
    def num_variants(self) -> int:
        return self.title.shape[0]

    @property
    def num_news(self) -> int:
        return self.title.shape[1]

    def global_index(self, variant: int, row) -> np.ndarray:
        return variant * self.num_news + np.asarray(row)

    def flat_title(self) -> np.ndarray:
        return self.title.reshape(-1, self.title.shape[-1])

    def flat_sapo(self) -> np.ndarray:
        return self.sapo.reshape(-1, self.sapo.shape[-1])

    def flat_category(self) -> np.ndarray:
        return self.category.reshape(-1)

    def flat_title_preconcat(self) -> np.ndarray:
        """Title + sapo[1:] concatenation for the ``pre-concat`` combine
        (reference: src/entities.py:384-386), fixed width Lt + Ls - 1."""
        V, N, Lt = self.title.shape
        Ls = self.sapo.shape[-1]
        out = np.full((V * N, Lt + Ls - 1), self.pad_token_id, dtype=np.int32)
        flat_t = self.flat_title()
        flat_s = self.flat_sapo()
        t_len = (flat_t != self.pad_token_id).sum(axis=1)
        for i in range(out.shape[0]):
            tl = t_len[i]
            out[i, :tl] = flat_t[i, :tl]
            s = flat_s[i, 1:]
            s = s[s != self.pad_token_id]
            out[i, tl : tl + len(s)] = s
        return out

    @staticmethod
    def from_tsv(
        news_path: str,
        tokenizer: Tokenizer,
        category2id: Dict[str, int],
        max_title_length: int,
        max_sapo_length: int,
        augmentations: Optional[Sequence[str]] = None,
    ) -> "NewsStore":
        variants = ["vanilla"] + list(augmentations or [])
        paths = [news_path] + [
            re.sub(r"news\.tsv", f"{aug}_news.tsv", news_path)
            for aug in (augmentations or [])
        ]

        # First pass over the vanilla file fixes the row order and id map.
        rows: List[str] = []
        with open(news_path, newline="", encoding="utf-8") as f:
            for line in csv.reader(f, delimiter="\t"):
                if line:
                    rows.append(line[constants.NEWS_ID])
        id_to_row = {nid: i + 1 for i, nid in enumerate(rows)}  # 0 = pad news
        N = len(rows) + 1
        V = len(variants)

        pad_id = tokenizer.pad_token_id
        cat_pad = category2id[constants.PAD_TOKEN]
        cat_unk = category2id[constants.UNK_TOKEN]

        title = np.full((V, N, max_title_length), pad_id, dtype=np.int32)
        sapo = np.full((V, N, max_sapo_length), pad_id, dtype=np.int32)
        category = np.full((V, N), cat_pad, dtype=np.int32)

        # Pad news: [CLS, EOS or PAD] (reference: src/reader.py:101-108).
        closer = (
            tokenizer.eos_token_id
            if tokenizer.eos_token_id is not None
            else tokenizer.pad_token_id
        )
        pad_tokens = [tokenizer.cls_token_id, closer]
        for v in range(V):
            title[v, 0, : len(pad_tokens)] = pad_tokens
            sapo[v, 0, : len(pad_tokens)] = pad_tokens

        for v, path in enumerate(paths):
            with open(path, newline="", encoding="utf-8") as f:
                for line in csv.reader(f, delimiter="\t"):
                    if not line:
                        continue
                    nid = line[constants.NEWS_ID]
                    row = id_to_row.get(nid)
                    if row is None:  # aug file with extra news: ignore
                        continue
                    t = tokenizer.encode(line[constants.TITLE], max_title_length)
                    s = tokenizer.encode(line[constants.SAPO], max_sapo_length)
                    title[v, row, : len(t)] = t
                    sapo[v, row, : len(s)] = s
                    category[v, row] = category2id.get(line[constants.CATEGORY], cat_unk)

        return NewsStore(
            title=title,
            sapo=sapo,
            category=category,
            id_to_row=id_to_row,
            variants=variants,
            pad_token_id=pad_id,
            category_pad_id=cat_pad,
        )
