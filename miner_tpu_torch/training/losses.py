"""Loss functions, fp32 throughout.

Counterpart of ``miner_tpu/training/losses.py`` (all six functions):

  * ``miner_loss``: cross-entropy over the (1+npratio) candidate logits with
    the argmax of the one-hot label row as target, plus the disagreement
    regularizer, the mean pairwise cosine among the K interest vectors with
    a zeroed diagonal (reference: src/loss.py:27-44);
  * ``vanilla_loss``: plain cross-entropy; 2-D labels by argmax, 1-D integer
    labels as they are;
  * eval losses: ``-(logsigmoid(logits) * labels).sum()`` (+ disagreement for
    MINER), with ``row_mask`` excluding the padded rows of a tail batch (the
    Batcher repeats row 0 to fill it);
  * ``pretrain_contrastive`` and ``binary_cross_entropy_with_logits``, for the
    pretraining and UnBERT slices.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from miner_tpu_torch.utils import pairwise_cosine_similarity


def _expand(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return m.float().reshape(m.shape + (1,) * (like.dim() - m.dim()))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer targets, computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[:, None])[:, 0].mean()


def disagreement(interests: torch.Tensor,
                 row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean pairwise cosine among the K interest vectors (diagonal zeroed);
    ``row_mask`` (B,) excludes padded tail-batch rows from the mean."""
    f = interests.float()
    cos = pairwise_cosine_similarity(f, f, zero_diagonal=True)
    if row_mask is None:
        return cos.mean()
    m = row_mask.float()
    per_row = cos.mean(dim=tuple(range(1, cos.dim())))
    return (per_row * m).sum() / torch.clamp(m.sum(), min=1.0)


def miner_loss(interests: torch.Tensor, logits: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """CE + disagreement; ``labels`` is the one-hot (B, C) click indicator."""
    return cross_entropy(logits, labels.argmax(dim=-1)) + disagreement(interests)


def vanilla_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    targets = labels.argmax(dim=-1) if labels.dim() > 1 else labels
    return cross_entropy(logits, targets)


def logsigmoid_eval_loss(logits: torch.Tensor, labels: torch.Tensor,
                         row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    terms = F.logsigmoid(logits.float()) * labels.float()
    if row_mask is not None:
        terms = terms * _expand(row_mask, terms)
    return -terms.sum()


def miner_eval_loss(interests: torch.Tensor, logits: torch.Tensor,
                    labels: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return (logsigmoid_eval_loss(logits, labels, row_mask)
            + disagreement(interests, row_mask))


def pretrain_contrastive(embs: torch.Tensor, num_augmentations: int = 3,
                         row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slot 0 the vanilla positive, slots 1..1+A its augmentations, the rest
    negatives: -(sum cos(positive, negatives) + 0.001 sum cos(positive,
    augmentations))."""
    positive = embs[:, :1, :]
    augmentations = embs[:, 1:1 + num_augmentations, :]
    negatives = embs[:, 1 + num_augmentations:, :]
    main = pairwise_cosine_similarity(positive, negatives)
    aug = pairwise_cosine_similarity(positive, augmentations)
    if row_mask is not None:
        main = main * _expand(row_mask, main).to(main.dtype)
        aug = aug * _expand(row_mask, aug).to(aug.dtype)
    return -(main.sum() + 0.001 * aug.sum())


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    """Mean BCE for single-logit models."""
    x, y = logits.float(), labels.float()
    return (torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()
