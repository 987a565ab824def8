"""A run with its timed path broken underneath comes out not correct: each
fault a cell can have, planted in the port while the tiny cells run on the
CPU (the harness's look for a card skipped). One card has no exchange
between cards to leave out; a stateless reranker has no state to leave
unchanged."""
import numpy as np
import pytest
from conftest import run_cell

from miner_tpu_torch.training import losses, optim
from miner_tpu_torch.training.trainer import Trainer


def _unchanged_step(self):
    """An update that counts and clears the gradients and moves nothing."""
    self.mini_step += 1
    if self.mini_step < self.accum_steps:
        return False
    self.adamw.zero_grad(set_to_none=True)
    self.mini_step = 0
    self.updates += 1
    return True


def _half_batch(original):
    def apply(self, model, table, batch, rng=None):
        half = {k: (v[: len(v) // 2] if isinstance(v, np.ndarray) and v.ndim else v)
                for k, v in batch.items()}
        return original(self, model, table, half, rng)
    return apply


def _altered_loss(original):
    return lambda *a, **k: original(*a, **k) + 0.05


TRAIN_FAULTS = {
    "state_unchanged": (optim.Optimizer, "step", lambda f: _unchanged_step),
    "half_batch": (Trainer, "_apply_and_loss", _half_batch),
    "answer_altered": (losses, "miner_loss", _altered_loss),
}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_training_fault_is_not_correct(tiny_root, monkeypatch, fault):
    owner, name, make = TRAIN_FAULTS[fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    rc, result = run_cell(tiny_root, "tiny-train", seed=2 ** 31 + 301)
    assert rc == 0 and result["correct"] is False
    failed = [k for k, c in result["check"].items() if c["value"] > c["limit"]]
    assert failed, result["check"]


def _scores_altered(original):
    def serve(self, *a, **k):
        out = original(self, *a, **k)
        out[:, 0] += 1.0
        return out
    return serve


def _half_rows(original):
    """The second half of each request's candidates left out, the mean of the
    rest in their place."""
    def serve(self, model, packer, cand_idx, his_idx):
        out = original(self, model, packer, cand_idx, his_idx)
        for i, real in enumerate(np.count_nonzero(cand_idx, axis=1)):
            kept = (real + 1) // 2
            out[i, kept:real] = out[i, :kept].mean()
        return out
    return serve


RERANK_FAULTS = {"answer_altered": _scores_altered, "half_batch": _half_rows}


@pytest.mark.parametrize("fault", sorted(RERANK_FAULTS))
def test_reranking_fault_is_not_correct(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(Trainer, "serve_scores_unbert",
                        RERANK_FAULTS[fault](Trainer.serve_scores_unbert))
    rc, result = run_cell(tiny_root, "tiny-rerank", seed=2 ** 31 + 302)
    assert rc == 0 and result["correct"] is False
