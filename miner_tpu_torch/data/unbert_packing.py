"""UnBERT cross-encoder sequence packing.

The port's own copy of ``miner_tpu/data/unbert_packing.py`` (the port
imports nothing of the JAX package; the tests hold the two equal, block
for block). Behavioral contract, after the reference's
``MindDataset.pack_bert_features`` (reference: src/entities.py:617-669):

  * layout: ``[CLS] cand_title [SEP] hist_1 .. hist_n [SEP]`` with
    ``seq_max_len=300``, per-news title truncation to ``news_max_len=20``,
    ``hist_max_len=20`` clicked news;
  * news_segment_ids: 0 for specials, 1 for the candidate, i+2 for the i-th
    history news;
  * token-type (segment) ids: 0 over ``[CLS] cand [SEP]``, 1 over the rest;
  * sentence_ids are sequential ``0..(3+n-1)``: the reference gathers the
    FIRST S hidden states for the news-level encoder, not news-start
    positions (an upstream quirk reproduced here);
  * sentence padding to ``3 + hist_max_len``; sentence_segment_ids
    ``[0,0,0,1,1,...]``;
  * train draws ONE random candidate per visit and each sample is visited 5
    times per epoch (reference: src/entities.py:671-720); eval packs every
    candidate of an impression, deterministically.

Packing runs on the host: a batch in one call of the port's copy of the
native C++ packer (``data/native.py``, ``csrc/host/miner_data.cpp``), or
row by row in numpy, which the C++ packer equals bit for bit. ``pack_rows``
and ``PackedBlock.materialize`` take the samplers' ``backend`` (``"auto"``,
the default, takes the native packer where it builds, as the JAX package's
``pack_rows`` does; ``samplers.use_native``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from miner_tpu_torch.data import native
from miner_tpu_torch.data.behaviors import BehaviorsLog
from miner_tpu_torch.data.news_store import NewsStore
from miner_tpu_torch.data.samplers import use_native

SEQ_MAX_LEN = 300
NEWS_MAX_LEN = 20
HIST_MAX_LEN = 20
OVERSAMPLE = 5  # reference: 5x per-epoch candidate resampling
# the packed features the model reads (the rest of a row is sentence
# segments, which the model does not use, and the label / impression id)
FEATURES = ("input_ids", "input_mask", "segment_ids", "news_segment_ids",
            "sentence_ids", "sentence_mask")


@dataclasses.dataclass
class UnbertPacker:
    store: NewsStore
    cls_id: int
    sep_id: int
    pad_id: int
    seq_max_len: int = SEQ_MAX_LEN
    news_max_len: int = NEWS_MAX_LEN
    hist_max_len: int = HIST_MAX_LEN
    # pads-first history rows (the reference's layout, src/reader.py:154):
    # pad entries are packed as real 2-token sentences instead of
    # terminating the history scan (see pack_one)
    legacy_layout: bool = False

    def __post_init__(self):
        flat = self.store.flat_title()
        self._tokens = flat
        self._lens = np.minimum(
            (flat != self.store.pad_token_id).sum(axis=1), self.news_max_len
        ).astype(np.int32)
        if self.legacy_layout:
            # The reference's pad news title is exactly 2 tokens
            # ([CLS, EOS] or [CLS, PAD], reference: src/reader.py:101-108)
            # and its packer takes title[:news_max_len] verbatim: the
            # !=pad length undercounts when the closer IS the pad token.
            N = self.store.num_news
            for v in range(self.store.num_variants):
                self._lens[v * N] = min(2, self.news_max_len)

    @property
    def sentence_max_len(self) -> int:
        return 3 + self.hist_max_len

    def _title(self, row: int) -> np.ndarray:
        return self._tokens[row, : self._lens[row]]

    def pack_one(self, cand_row: int, hist_rows: np.ndarray) -> Dict[str, np.ndarray]:
        L = self.seq_max_len
        curr = self._title(cand_row)

        hist_tokens = []
        hist_segs = []
        n_sent = 3
        for i, r in enumerate(hist_rows[: self.hist_max_len]):
            if r == 0 and not self.legacy_layout:
                # pad news terminates a clicks-first row. Under the
                # reference's pads-first layout (legacy_layout) pads are
                # packed as real sentences: the reference iterates
                # clicked_news[:hist_max_len] unconditionally (reference:
                # src/entities.py:627-632), so a short history really does
                # fill the packed sequence with [CLS, EOS] pad sentences.
                break
            ids = self._title(int(r))
            hist_tokens.append(ids)
            hist_segs.append(np.full(len(ids), i + 2, dtype=np.int32))
            n_sent += 1
        hist_flat = (
            np.concatenate(hist_tokens) if hist_tokens else np.zeros(0, np.int32)
        )
        seg_flat = (
            np.concatenate(hist_segs) if hist_segs else np.zeros(0, np.int32)
        )
        tmp_hist_len = L - len(curr) - 3
        hist_flat = hist_flat[:tmp_hist_len]
        seg_flat = seg_flat[:tmp_hist_len]

        n = len(curr) + len(hist_flat) + 3
        input_ids = np.full(L, self.pad_id, dtype=np.int32)
        input_ids[0] = self.cls_id
        input_ids[1 : 1 + len(curr)] = curr
        input_ids[1 + len(curr)] = self.sep_id
        input_ids[2 + len(curr) : 2 + len(curr) + len(hist_flat)] = hist_flat
        input_ids[n - 1] = self.sep_id

        input_mask = np.zeros(L, dtype=np.int32)
        input_mask[:n] = 1

        segment_ids = np.zeros(L, dtype=np.int32)
        segment_ids[2 + len(curr) : n] = 1

        news_segment_ids = np.zeros(L, dtype=np.int32)
        news_segment_ids[1 : 1 + len(curr)] = 1
        news_segment_ids[2 + len(curr) : 2 + len(curr) + len(seg_flat)] = seg_flat

        S = self.sentence_max_len
        sentence_ids = np.zeros(S, dtype=np.int32)
        sentence_ids[:n_sent] = np.arange(n_sent)
        sentence_mask = np.zeros(S, dtype=np.int32)
        sentence_mask[:n_sent] = 1
        sentence_segment_ids = np.zeros(S, dtype=np.int32)
        sentence_segment_ids[3:n_sent] = 1

        return {
            "input_ids": input_ids,
            "input_mask": input_mask,
            "segment_ids": segment_ids,
            "news_segment_ids": news_segment_ids,
            "sentence_ids": sentence_ids,
            "sentence_mask": sentence_mask,
            "sentence_segment_ids": sentence_segment_ids,
        }


def pack_rows(packer: UnbertPacker, cand: np.ndarray, hist: np.ndarray,
              backend: str = "auto") -> Dict[str, np.ndarray]:
    """Pack (R,) candidate rows x (R, H) history rows (clicks first, or
    pads first under ``legacy_layout``) into the model's feature arrays,
    (R, seq_max_len) and (R, 3 + hist_max_len): the native C++ packer, or
    the numpy reference row by row (``backend``, as the samplers')."""
    p = packer
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    hist = np.ascontiguousarray(hist, dtype=np.int32)
    if use_native(backend):
        return native.pack_unbert(
            p._tokens, p._lens, cand, hist,
            p.seq_max_len, p.news_max_len, p.hist_max_len,
            p.cls_id, p.sep_id, p.pad_id, legacy_layout=p.legacy_layout,
        )
    rows = [p.pack_one(int(c), h) for c, h in zip(cand, hist)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


class PackedBlock:
    """Lazy UnBERT feature block: stores per-row (candidate, history-pointer)
    indices and packs token features *per batch* via ``materialize``.

    This keeps host memory O(batch) instead of O(epoch x seq_max_len)
    (reference: src/entities.py:617-720 packs per ``__getitem__``).
    ``Batcher`` takes it as it takes a ``SampleBlock``.
    """

    def __init__(self, packer: UnbertPacker, history: np.ndarray,
                 cand_rows: np.ndarray, hist_ptr: np.ndarray,
                 label: np.ndarray, impression_id: np.ndarray):
        self.packer = packer
        self.history = history
        self.cand_rows = cand_rows.astype(np.int32)
        self.hist_ptr = hist_ptr.astype(np.int32)
        self.label = label.astype(np.float32)
        self.impression_id = impression_id.astype(np.int32)

    def __len__(self) -> int:
        return len(self.cand_rows)

    def materialize(self, idx: np.ndarray, backend: str = "auto") -> Dict[str, np.ndarray]:
        # BehaviorsLog rows are clicks-first (pads appended) by default, so
        # the packer's first-hist_max_len slice sees real clicks and stops
        # at the first pad. Under --legacy_history_layout the rows are
        # pads-first and the packer includes pad sentences, as the reference
        # does (src/reader.py:154 prepends pads; src/entities.py:627-632
        # packs clicked_news[:hist_max_len] unconditionally).
        out = pack_rows(self.packer, self.cand_rows[idx],
                        self.history[self.hist_ptr[idx]], backend)
        out["label"] = self.label[idx]
        out["impression_id"] = self.impression_id[idx]
        return out

    def to_dict(self) -> Dict[str, np.ndarray]:
        """Materialize every row at once (tests / tiny fixtures only)."""
        return self.materialize(np.arange(len(self)))


class UnbertTrainSampler:
    """5x-oversampled random-candidate selection over train events.

    Candidate selection is vectorized numpy; the marginal distribution
    matches the reference's shuffle-then-pick (reference:
    src/entities.py:671-720): each visit draws the positive (in a random
    augmentation variant) with probability 1/(npratio+1), otherwise a
    uniformly-random negative. The draws come from
    ``np.random.default_rng((seed, epoch, 7))`` in the JAX package's order,
    so the blocks are equal to its. Token packing is deferred to
    ``PackedBlock.materialize`` per batch.
    """

    def __init__(self, log: BehaviorsLog, store: NewsStore, packer: UnbertPacker,
                 npratio: int, seed: int = 0):
        self.log = log
        self.store = store
        self.packer = packer
        self.npratio = npratio
        self.seed = seed

    def __len__(self) -> int:
        return OVERSAMPLE * self.log.num_events

    def sample_epoch(self, epoch: int) -> PackedBlock:
        rng = np.random.default_rng((self.seed, epoch, 7))
        log, store = self.log, self.store
        N, V = store.num_news, store.num_variants
        total = len(self)
        C = self.npratio + 1
        e = np.arange(total) // OVERSAMPLE

        variant = (rng.integers(0, V, size=total) if V > 1
                   else np.zeros(total, dtype=np.int64))
        slot = rng.integers(0, C, size=total)
        neg_count = (log.neg_offsets[e + 1] - log.neg_offsets[e]).astype(np.int64)
        # slots: [positive, neg_1..neg_k, pad...] with k = min(#negs, npratio)
        k = np.minimum(neg_count, self.npratio)
        is_pos = slot == 0
        is_neg = (slot >= 1) & (slot <= k)
        neg_pick = rng.integers(0, np.maximum(neg_count, 1), size=total)
        if len(log.neg_flat):
            neg_rows = log.neg_flat[
                np.minimum(log.neg_offsets[e] + neg_pick, len(log.neg_flat) - 1)
            ]
        else:  # no negatives anywhere in the log: is_neg is all-False
            neg_rows = np.zeros(total, dtype=np.int64)
        cand = np.where(is_pos, variant * N + log.pos_row[e],
                        np.where(is_neg, neg_rows, 0)).astype(np.int32)
        label = is_pos.astype(np.float32)
        return PackedBlock(
            self.packer, log.history, cand, log.hist_ptr[e], label,
            log.impression_id[e],
        )


class UnbertEvalSampler:
    """One packed row per eval candidate (deterministic)."""

    def __init__(self, log: BehaviorsLog, store: NewsStore, packer: UnbertPacker):
        self.log = log
        self.store = store
        self.packer = packer

    def sample_all(self) -> PackedBlock:
        log = self.log
        counts = np.diff(log.eval_offsets)
        return PackedBlock(
            self.packer, log.history,
            log.eval_cand_flat.astype(np.int32),
            np.repeat(log.eval_hist_ptr, counts),
            log.eval_label_flat.astype(np.float32),
            np.repeat(log.eval_impression_id, counts),
        )
