"""The corpus as the references read it: the raw MIND-format files, parsed
and tokenized here again, never taken from the program."""
from __future__ import annotations

import csv
import json
from typing import Dict, List, Sequence

import numpy as np

from reference.tokenizer import PAD, HashTokenizer


class Corpus:
    """``news.tsv`` and ``behaviors.tsv`` of one run. News row ``r`` is the
    ``r``-th line of ``news.tsv`` counted from 1; row 0 is the pad news."""

    def __init__(self, news_path: str, behaviors_path: str, category2id: Dict[str, int],
                 vocab_size: int):
        self.lines: List[List[str]] = []
        with open(news_path, newline="", encoding="utf-8") as f:
            self.lines = [row for row in csv.reader(f, delimiter="\t") if row]
        self.row_of = {row[0]: i + 1 for i, row in enumerate(self.lines)}
        self.category2id = category2id
        self.tokenizer = HashTokenizer(vocab_size)
        self.behaviors_path = behaviors_path
        self._impressions = None

    @classmethod
    def from_paths(cls, paths: Dict[str, str], vocab_size: int) -> "Corpus":
        """The corpus of a run's files (``news``, ``behaviors``,
        ``category2id``)."""
        with open(paths["category2id"]) as f:
            return cls(paths["news"], paths["behaviors"], json.load(f), vocab_size)

    @property
    def num_rows(self) -> int:
        return len(self.lines) + 1

    def tokens(self, rows: np.ndarray, field: int, length: int) -> np.ndarray:
        """(len(rows), length) token ids of a field (1 title, 3 abstract);
        the pad news is ``[CLS, PAD]``."""
        out = np.full((len(rows), length), PAD, np.int64)
        for i, r in enumerate(np.asarray(rows).reshape(-1)):
            ids = ([1, PAD] if r == 0 else
                   self.tokenizer.encode(self.lines[r - 1][field], length))
            out[i, :len(ids)] = ids
        return out

    def categories(self, rows: np.ndarray) -> np.ndarray:
        pad, unk = self.category2id["pad"], self.category2id["unk"]
        flat = [pad if r == 0 else self.category2id.get(self.lines[r - 1][2], unk)
                for r in np.asarray(rows).reshape(-1)]
        return np.asarray(flat, np.int64).reshape(np.shape(rows))

    def impressions(self) -> List[dict]:
        """Each behaviors line: its history rows, clicked and skipped rows."""
        if self._impressions is None:
            out = []
            with open(self.behaviors_path, newline="", encoding="utf-8") as f:
                for row in csv.reader(f, delimiter="\t"):
                    if not row:
                        continue
                    hist = [self.row_of[n] for n in row[3].split() if n in self.row_of]
                    pos, neg = [], []
                    for b in row[4].split():
                        nid, _, label = b.rpartition("-")
                        (pos if label == "1" else neg).append(self.row_of.get(nid, 0))
                    out.append({"history": hist, "pos": pos, "neg": neg})
            self._impressions = out
        return self._impressions


def history_row(rows: Sequence[int], length: int) -> np.ndarray:
    """Clicks first, cut to ``length``, padded with the pad news."""
    out = np.zeros(length, np.int64)
    rows = list(rows)[:length]
    out[:len(rows)] = rows
    return out
