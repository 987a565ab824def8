"""Samplers: behaviors log -> fixed-shape index samples, fully seeded.

These replace the reference's Dataset/DatasetOnline ``__getitem__`` logic
(reference: src/entities.py:181-348) with vectorized, reproducible numpy —
each epoch's randomness comes from an explicit ``np.random.Generator`` so
multi-host shards can derive identical sample streams from (seed, epoch).

Modes (behavioral contracts):

  * offline base (reference: src/reader.py:135-183): one sample per positive;
    candidates = positive (random augmentation variant if augmentations are
    loaded) + npratio sampled negatives, shuffled; label one-hot.
  * online base (reference: src/entities.py:256-272): same, but re-sampled
    every epoch.
  * hard (``--augmentation_mode hard``): with augmentations loaded, the
    first 1 to min(V, npratio) - 1 slots are distinct variants of the
    positive, only the first of them labelled 1, and the rest negatives;
    then shuffled.
  * pretrain: the vanilla positive, every augmentation variant of it, then
    npratio negatives (``PretrainSampler``).
  * eval (reference: src/reader.py:351-379): one row per candidate of every
    impression containing both classes.

All emitted indices are *global* NewsStore indices (variant*N + row); pad
news = 0.

The port's own copy of ``miner_tpu/data/samplers.py``, with its two paths.
The train samplers take JAX's ``backend``: ``"native"`` draws an epoch in
one call of the port's copy of the native C++ sampler (``data/native.py``,
``csrc/host/miner_data.cpp``), per event from (seed, epoch, event);
``"numpy"`` loops over the events in Python, >100x slower, from
``np.random.default_rng((seed, epoch))``; ``"auto"`` (the default, as in
JAX) takes the native path where the library builds and loads, else warns
once and takes numpy. The two paths keep the same invariants but not the
same draws. ``"native"`` raises where the library is unavailable, and
``MINER_TPU_NO_NATIVE`` switches it off. The pretrain and eval samplers are
numpy only, as in JAX. The tests hold each path equal to the JAX package's
same path, draw for draw.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from miner_tpu_torch.data import native
from miner_tpu_torch.data.behaviors import BehaviorsLog
from miner_tpu_torch.data.news_store import NewsStore

log_ = logging.getLogger(__name__)
BACKENDS = ("auto", "native", "numpy")
_warned_fallback = False


@dataclasses.dataclass
class SampleBlock:
    """A fixed-shape block of samples (one epoch or the eval set)."""

    cand: np.ndarray  # (E, C) int32 global indices
    his: np.ndarray  # (E, H) int32 global indices (vanilla variant)
    label: np.ndarray  # (E, C) float32 one-hot / binary
    impression_id: np.ndarray  # (E,) int32

    def __len__(self) -> int:
        return len(self.cand)


def use_native(backend: str) -> bool:
    """Whether ``backend`` takes the native path: ``"native"`` raises when
    the library is unavailable, ``"auto"`` warns once and takes numpy."""
    if backend == "numpy":
        return False
    ok = native.native_available()
    if backend == "native" and not ok:
        raise RuntimeError("native sampler requested but unavailable")
    if not ok:
        # a quiet fallback eats a >100x slower per-event Python loop every
        # epoch: warn loudly, once
        global _warned_fallback
        if not _warned_fallback:
            _warned_fallback = True
            log_.warning(
                "native data plane unavailable: falling back to the numpy "
                "sampler and packer (>100x slower per epoch). Check that g++ "
                "builds miner_tpu_torch/csrc/host/miner_data.cpp and that "
                "MINER_TPU_NO_NATIVE is unset.")
    return ok


def _sample_negatives(
    negs: np.ndarray, k: int, rng: np.random.Generator
) -> np.ndarray:
    """k negatives: without replacement when enough, else all + pad(0)
    (reference: src/reader.py:437-441)."""
    if len(negs) >= k:
        return rng.choice(negs, size=k, replace=False)
    out = np.zeros(k, dtype=np.int64)
    out[: len(negs)] = negs
    return out


class _BaseTrainSampler:
    def __init__(
        self,
        log: BehaviorsLog,
        store: NewsStore,
        npratio: int,
        seed: int = 0,
        mode: str = "base",
        backend: str = "auto",
    ):
        if mode not in ("base", "hard"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown sampler backend {backend!r}")
        self.log = log
        self.store = store
        self.npratio = npratio
        self.seed = seed
        self.mode = mode
        self.backend = backend
        self.num_variants = store.num_variants

    def _history_gidx(self) -> np.ndarray:
        # variant 0 -> global index == row
        return self.log.history[self.log.hist_ptr]

    def sample_epoch(self, epoch: int) -> SampleBlock:
        if use_native(self.backend):
            cand, label = native.sample_epoch(
                self.seed, epoch, self.mode, self.log.num_events,
                self.npratio + 1, self.num_variants, self.store.num_news,
                self.log.pos_row, self.log.neg_flat, self.log.neg_offsets,
            )
            return SampleBlock(
                cand=cand,
                his=self._history_gidx().astype(np.int32),
                label=label,
                impression_id=self.log.impression_id.copy(),
            )
        return self._sample_epoch_numpy(epoch)

    def _sample_epoch_numpy(self, epoch: int) -> SampleBlock:
        rng = np.random.default_rng((self.seed, epoch))
        E = self.log.num_events
        C = self.npratio + 1
        N = self.store.num_news
        V = self.num_variants

        cand = np.zeros((E, C), dtype=np.int64)
        label = np.zeros((E, C), dtype=np.float32)

        for e in range(E):
            negs = self.log.negatives(e)
            pos = int(self.log.pos_row[e])
            if self.mode == "hard" and V > 1:
                cap = min(V, self.npratio)
                num_pick = int(rng.integers(1, cap)) if cap > 1 else 1
                picks = np.sort(rng.choice(V, size=num_pick, replace=False))
                row = np.empty(C, dtype=np.int64)
                row[:num_pick] = picks * N + pos
                row[num_pick:] = _sample_negatives(negs, C - num_pick, rng)
            else:
                variant = int(rng.integers(0, V)) if V > 1 else 0
                row = np.empty(C, dtype=np.int64)
                row[0] = variant * N + pos
                row[1:] = _sample_negatives(negs, self.npratio, rng)
            lab = np.zeros(C, dtype=np.float32)
            lab[0] = 1.0
            perm = rng.permutation(C)
            cand[e] = row[perm]
            label[e] = lab[perm]

        return SampleBlock(
            cand=cand.astype(np.int32),
            his=self._history_gidx().astype(np.int32),
            label=label,
            impression_id=self.log.impression_id.copy(),
        )


class OfflineSampler(_BaseTrainSampler):
    """Sampled once at construction; every epoch reuses the same block."""

    def __init__(self, log, store, npratio, seed=0, mode="base", backend="auto"):
        super().__init__(log, store, npratio, seed, mode, backend)
        self._block = super().sample_epoch(0)

    def sample_epoch(self, epoch: int) -> SampleBlock:
        return self._block


class OnlineSampler(_BaseTrainSampler):
    """Re-samples every epoch (reference's DatasetOnline)."""


class PretrainSampler:
    """Candidate-only blocks for contrastive news-encoder pretraining: the
    vanilla positive and each of its augmentation variants, then npratio
    negatives."""

    def __init__(self, log: BehaviorsLog, store: NewsStore, npratio: int, seed: int = 0):
        self.log = log
        self.store = store
        self.npratio = npratio
        self.seed = seed

    @property
    def num_candidates(self) -> int:
        return self.store.num_variants + self.npratio

    def sample_epoch(self, epoch: int) -> SampleBlock:
        rng = np.random.default_rng((self.seed, epoch))
        log = self.log
        E = log.num_events
        N = self.store.num_news
        V = self.store.num_variants
        C = self.num_candidates

        cand = np.zeros((E, C), dtype=np.int64)
        cand[:, :V] = (np.arange(V)[None, :] * N
                       + log.pos_row[:E, None].astype(np.int64))
        # npratio negatives per event without replacement, vectorised over
        # the ragged pools: random keys sorted within each event's segment,
        # the first npratio kept (short pools keep all and pad with 0)
        counts = np.diff(log.neg_offsets).astype(np.int64)
        total = int(counts.sum())
        if total:
            seg = np.repeat(np.arange(E), counts)
            order = np.lexsort((rng.random(total), seg))
            pos_in_seg = np.arange(total) - np.repeat(log.neg_offsets[:-1], counts)
            take = pos_in_seg < self.npratio
            cand[seg[order][take], V + pos_in_seg[take]] = log.neg_flat[order][take]

        return SampleBlock(
            cand=cand.astype(np.int32),
            his=np.zeros((E, 0), dtype=np.int32),
            label=np.zeros((E, C), dtype=np.float32),
            impression_id=self.log.impression_id.copy(),
        )


class EvalSampler:
    """One row per candidate (the reference's slow-eval layout)."""

    def __init__(self, log: BehaviorsLog):
        self.log = log

    def sample_all(self) -> SampleBlock:
        log = self.log
        # bulk expansion: one row per candidate, history/impression repeated
        # per group (no per-impression Python loop — at MIND-large scale the
        # eval set is millions of candidate rows)
        counts = np.diff(log.eval_offsets)
        return SampleBlock(
            cand=log.eval_cand_flat.reshape(-1, 1).astype(np.int32),
            his=log.history[np.repeat(log.eval_hist_ptr, counts)].astype(np.int32),
            label=log.eval_label_flat.reshape(-1, 1).astype(np.float32),
            impression_id=np.repeat(log.eval_impression_id, counts).astype(np.int32),
        )
