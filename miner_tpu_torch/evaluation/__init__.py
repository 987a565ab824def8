from miner_tpu_torch.evaluation.metrics import (
    auc_score,
    mrr_score,
    ndcg_score,
    hit_score,
    compute_scores,
)
from miner_tpu_torch.evaluation.evaluator import ImpressionEvaluator, FastEvaluator

__all__ = [
    "auc_score",
    "mrr_score",
    "ndcg_score",
    "hit_score",
    "compute_scores",
    "ImpressionEvaluator",
    "FastEvaluator",
]
