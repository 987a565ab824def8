"""Impression-grouped evaluators.

Behavioral contract follows the reference evaluators (reference:
src/evaluation.py:87-175):

  * ``FastEvaluator``: fixed-size (1+npratio) eval batches; probabilities via
    softmax over the candidate row; targets taken directly in dataset order.
  * ``ImpressionEvaluator`` (the reference's ``SlowEvaluator``): per-candidate
    sigmoid probabilities grouped by impression id, both targets and
    predictions sorted by impression id; ``save_predictions`` dumps a
    ``preds.pkl`` with the same dict layout for notebook compatibility.

Grouping happens host-side in numpy: the device produces a flat score vector
per batch; the O(N) group-by is not worth a device round trip.

The port's own copy of ``miner_tpu/evaluation/evaluator.py``
(the port imports nothing of the JAX package); the tests hold the two
equal.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from miner_tpu_torch.evaluation.metrics import compute_scores


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def _softmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class FastEvaluator:
    """Eval over train-format batches: one (1+npratio) row per sample."""

    def __init__(self, targets: Sequence[Sequence[int]]):
        self.targets: List[List[int]] = [list(t) for t in targets]
        self.prob_predictions: List[List[float]] = []

    def eval_batch(self, logits: np.ndarray, impression_ids: np.ndarray | None = None,
                   valid: int | None = None):
        probs = _softmax(np.asarray(logits))
        if valid is not None:
            probs = probs[:valid]
        self.prob_predictions.extend(probs.tolist())

    def compute_scores(self, metrics: Sequence[str], save_result: bool = False,
                       path: str | None = None) -> Dict[str, float]:
        n = min(len(self.targets), len(self.prob_predictions))
        return compute_scores(
            self.targets[:n], self.prob_predictions[:n], metrics, save_result, path
        )


class ImpressionEvaluator:
    """Eval over per-candidate rows grouped by impression id.

    Accumulation and grouping are bulk numpy (array chunks + one stable
    argsort at scoring time) — no per-row Python, so MIND-large eval sets
    (millions of candidate rows) stay off the host's critical path.
    """

    def __init__(self, targets_by_impression: Dict[int, List[int]]):
        # Sorted by impression id, matching the reference's sorted() grouping.
        self._sorted_ids = sorted(targets_by_impression)
        self.targets: List[List[int]] = [targets_by_impression[i] for i in self._sorted_ids]
        self._prob_chunks: List[np.ndarray] = []
        self._id_chunks: List[np.ndarray] = []

    @property
    def prob_predictions(self) -> List[float]:
        if not self._prob_chunks:
            return []
        return np.concatenate(self._prob_chunks).tolist()

    @property
    def impression_ids(self) -> List[int]:
        if not self._id_chunks:
            return []
        return np.concatenate(self._id_chunks).tolist()

    def eval_batch(self, logits: np.ndarray, impression_ids: np.ndarray,
                   valid: int | None = None):
        logits = np.asarray(logits).reshape(-1)
        impression_ids = np.asarray(impression_ids).reshape(-1)
        if valid is not None:
            logits = logits[:valid]
            impression_ids = impression_ids[:valid]
        self._prob_chunks.append(_sigmoid(logits))
        self._id_chunks.append(impression_ids.astype(np.int64))

    def _grouped(self) -> Tuple[np.ndarray, List[np.ndarray]]:
        """(group impression ids, per-group score arrays), groups sorted by
        impression id; a stable sort keeps within-impression batch order
        (the reference's dict-append order)."""
        if not self._prob_chunks:
            return np.empty((0,), np.int64), []
        probs = np.concatenate(self._prob_chunks)
        ids = np.concatenate(self._id_chunks)
        order = np.argsort(ids, kind="stable")
        ids, probs = ids[order], probs[order]
        boundaries = np.flatnonzero(np.diff(ids)) + 1
        group_ids = np.concatenate([ids[:1], ids[boundaries]])
        return group_ids, np.split(probs, boundaries)

    def _grouped_predictions(self) -> List[List[float]]:
        return [g.tolist() for g in self._grouped()[1]]

    def compute_scores(self, metrics: Sequence[str], save_result: bool = False,
                       path: str | None = None) -> Dict[str, float]:
        preds = self._grouped_predictions()
        return compute_scores(self.targets, preds, metrics, save_result, path)

    def save_predictions(self, path: str):
        pred_dict = {"pred": self.prob_predictions, "impression_id": self.impression_ids}
        with open(os.path.join(path, "preds.pkl"), "wb") as f:
            pickle.dump(pred_dict, f)

    def save_ranking(self, path: str, filename: str = "prediction.txt"):
        """Write the MIND-leaderboard submission format.

        One line per impression, sorted by impression id:
        ``<impression_id> [r1,r2,...]`` where ``rj`` is the 1-based rank of
        the j-th candidate (1 = highest score), candidates in their original
        impression order. This is the official MIND challenge format; the
        reference has no equivalent writer (its preds.pkl requires notebook
        post-processing to submit).
        """
        group_ids, groups = self._grouped()
        if not groups:
            raise ValueError("no predictions accumulated")
        out = os.path.join(path, filename)
        with open(out, "w") as f:
            for imp_id, group in zip(group_ids, groups):
                # rank 1 = best; double-argsort converts scores to ranks
                ranks = (-group).argsort(kind="stable").argsort() + 1
                f.write(f"{int(imp_id)} [{','.join(map(str, ranks.tolist()))}]\n")
        return out
