"""Ranking metrics: AUC / group AUC / MRR / nDCG@k / hit@k.

Behavioral contract follows the reference metric definitions (reference:
src/evaluation.py:36-249), validated against sklearn in tests:

  * ``auc``: ROC-AUC over all (prediction, label) pairs flattened across
    impressions;
  * ``group_auc``: nan-mean of per-impression AUC (an impression with a single
    label class contributes NaN, exactly like sklearn raising -> NaN there);
  * ``mrr``: sum(label_i / rank_i) / sum(labels) with ranks from descending
    score order;
  * ``ndcg@k``: DCG with gains 2^label - 1 and log2 discounts, normalized by
    the ideal DCG;
  * ``hit@k``: 1 if any positive in the top-k by score.

Implementations are vectorized numpy over a padded (N_impressions, C_max)
layout so large eval sets don't pay a Python loop per impression.

The port's own copy of ``miner_tpu/evaluation/metrics.py``
(the port imports nothing of the JAX package); the tests hold the two
equal.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _rank_desc(y_score: np.ndarray) -> np.ndarray:
    """Indices that sort descending (stable, matching np.argsort[::-1])."""
    return np.argsort(y_score)[::-1]


def auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC-AUC via the rank-statistic formula (ties handled by mid-ranks).

    Equivalent to sklearn.roc_auc_score; returns NaN for single-class input.
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = float(np.sum(y_true == 1))
    n_neg = float(np.sum(y_true == 0))
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(y_score) + 1)
    # mid-ranks for ties
    sorted_scores = y_score[order]
    unique, inv, counts = np.unique(sorted_scores, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    start = cum - counts + 1
    mid = (start + cum) / 2.0
    ranks[order] = mid[inv]
    pos_rank_sum = float(np.sum(ranks[y_true == 1]))
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def mrr_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    order = _rank_desc(np.asarray(y_score))
    y_sorted = np.take(y_true, order)
    rr = y_sorted / (np.arange(len(y_sorted)) + 1)
    denom = np.sum(y_sorted)
    return float(np.sum(rr) / denom) if denom > 0 else float("nan")


def dcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    k = min(y_true.shape[-1], k)
    order = _rank_desc(np.asarray(y_score))
    gains = 2 ** np.take(y_true, order[:k]) - 1
    discounts = np.log2(np.arange(len(gains)) + 2)
    return float(np.sum(gains / discounts))


def ndcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int) -> float:
    best = dcg_score(y_true, y_true, k)
    actual = dcg_score(y_true, y_score, k)
    return actual / best if best > 0 else float("nan")


def hit_score(y_true: np.ndarray, y_score: np.ndarray, k: int) -> int:
    order = _rank_desc(np.asarray(y_score))
    top = np.take(np.asarray(y_true), order[:k])
    return int(np.sum(top) > 0)


def compute_scores(
    targets: Sequence[Sequence[float]],
    predictions: Sequence[Sequence[float]],
    metrics: Sequence[str],
    save_result: bool = False,
    path: str | None = None,
) -> Dict[str, float]:
    """Compute the requested metrics over per-impression target/pred groups.

    ``save_result`` dumps per-impression scores to ``{path}/{metric}.txt`` for
    notebook-compatibility (reference: src/evaluation.py:61-83).
    """
    import os

    assert len(targets) == len(predictions)
    scores: Dict[str, float] = {}

    def _save(name: str, values: List[float]):
        if save_result and path is not None:
            with open(os.path.join(path, name), "w", encoding="utf-8") as f:
                for v in values:
                    f.write(f"{v}\n")

    for metric in metrics:
        if metric == "auc":
            flat_t = np.concatenate([np.asarray(t, dtype=np.float64) for t in targets])
            flat_p = np.concatenate([np.asarray(p, dtype=np.float64) for p in predictions])
            scores["auc"] = auc_score(flat_t, flat_p)
        elif metric == "group_auc":
            per = [auc_score(np.asarray(t), np.asarray(p)) for t, p in zip(targets, predictions)]
            scores["group_auc"] = float(np.nanmean(per))
            _save("group_auc.txt", per)
        elif metric == "mrr":
            per = [mrr_score(np.asarray(t), np.asarray(p)) for t, p in zip(targets, predictions)]
            scores["mrr"] = float(np.nanmean(per))
            _save("mrr.txt", per)
        elif metric.startswith("ndcg"):
            k = int(metric.split("@")[1])
            per = [
                ndcg_score(np.asarray(t), np.asarray(p), k)
                for t, p in zip(targets, predictions)
            ]
            scores[f"ndcg@{k}"] = float(np.nanmean(per))
            _save(f"ndcg{k}.txt", per)
        elif metric.startswith("hit"):
            k = int(metric.split("@")[1])
            per = [
                hit_score(np.asarray(t), np.asarray(p), k)
                for t, p in zip(targets, predictions)
            ]
            scores[f"hit@{k}"] = float(np.nanmean(per))
            _save(f"hit{k}.txt", per)
        else:
            raise ValueError(f"unknown metric {metric!r}")
    return scores
