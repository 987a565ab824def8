"""The port's training over a mesh of ranks against one rank and against JAX.

Ranks are CPU processes on gloo (``tests/_torch_mesh_worker.py``), one
intra-op thread each, started in the background when the module's fixture
is first used; the one-rank runs go on in this process meanwhile. Every run
is float32 with every dropout at 0 (``--dropout 0`` and the PLM's config
rates), so that a W-rank run computes the one-rank run's updates: its
losses and first update's gradients to the JAX package's multihost
tolerance (rtol 1e-5, atol 5e-7; ``tests/test_multihost.py``), its
parameters to what Adam's amplification of summation order allows
(``_assert_ranks_match_one``), the ranks' parameters bit for bit. 3 updates
of accumulation 2 (``tests/_multihost_worker.py``'s 3 steps), at lr 1e-3 but
for the Miner:

  * the Miner over ``--mesh_data 2`` against one rank, and against the JAX
    trainer on its 8-device virtual mesh from the same converted init
    (``assert_runs_match`` of ``test_torch_his_cache.py``, at its
    optimizer's settings);
  * the pretrain kind, whose contrastive loss is a sum over rows (a rank's
    share is its own sum, not a mean);
  * Fastformer and UnBERT, briefly;
  * cached-history training (``--his_cache_refresh 2
    --his_cache_warmup_steps 1``) over a 2 x 2 mesh (``--mesh_data 2
    --mesh_table 2``, 4 ranks): the history cache row-sharded over the table
    axis, rebuilt at JAX's micro-steps.
"""
import os

import numpy as np
import pytest
import torch

from miner_tpu_torch.config import make_parser
from miner_tpu_torch.training.trainer import Trainer
from tests._torch_mesh_worker import Ranks, record
from tests.fixture_data import make_fixture
from tests.test_torch_his_cache import (  # noqa: F401 (no_dropout: a fixture)
    _initial_params,
    assert_runs_match,
    no_dropout,
    train_both,
)
from miner_tpu.config import make_parser as jax_parser
import miner_tpu.training.trainer as jax_trainer
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.training import checkpoint

AUGS = ("changed_topic_text", "enhanced_text")
MINER = ("--model_name", "Miner", "--apply_reduce_dim", "--use_sapo", "--use_category_bias",
         "--word_embed_dim", "32", "--category_embed_dim", "8", "--num_context_codes", "4",
         "--context_code_dim", "16", "--score_type", "weighted")
# the families, each (mode, flags, train behaviors, accumulation)
FAMILIES = {
    "pretrain": ("pretrain", ("--model_name", "Miner", "--apply_reduce_dim", "--use_sapo",
                              "--word_embed_dim", "32", "--augmentations", *AUGS),
                 "short.tsv", 2),
    "fastformer": ("train_fastformer", ("--model_name", "fastformer", "--apply_reduce_dim",
                                        "--use_sapo", "--word_embed_dim", "32"), "short.tsv", 2),
    "unbert": ("train_fastformer", ("--model_name", "unbert"), "two.tsv", 1),
    "his_cache": ("train", MINER + ("--his_cache_refresh", "2", "--his_cache_warmup_steps",
                                    "1"), "behaviors.tsv", 2),
}
# the optimizer of test_torch_his_cache.train_both, whose runs of the Miner
# match JAX's to assert_runs_match's tolerance
JAX_OPTIMIZER = ("--max_grad_norm", "0.05", "--learning_rate", "2e-3", "--weight_decay", "0.05",
                 "--warmup_steps", "2")
WORLD = {"his_cache": 4}
MESH = {"his_cache": ("--mesh_data", "2", "--mesh_table", "2")}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _common(fixture, mode, behaviors, accum):
    return [mode, "--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--npratio", "3",
            "--compute_dtype", "float32", "--dropout", "0",
            "--gradient_accumulation_steps", str(accum), "--learning_rate", "1e-3",
            "--max_grad_norm", "1.0", "--weight_decay", "0.01", "--warmup_steps", "0",
            "--train_batch_size", "8", "--num_train_epochs", "1", "--logging_steps", "100",
            "--train_behaviors_path", os.path.join(fixture, behaviors),
            "--train_news_path", os.path.join(fixture, "news.tsv"), "--device", "cpu"]


def _family_argv(fixture, family, out):
    mode, flags, behaviors, accum = FAMILIES[family]
    return [*_common(fixture, mode, behaviors, accum), *flags, "--train_path", out]


def _write_head(fixture, name, positives):
    """The first lines of the fixture's behaviors with at least
    ``positives`` clicks and fewer than ``positives`` + 8 (a micro-batch of
    8 a click: exactly ``positives`` // 8 micro-batches)."""
    lines, n = [], 0
    for line in open(os.path.join(fixture, "behaviors.tsv")):
        if n >= positives:
            break
        lines.append(line)
        n += sum(c.endswith("-1") for c in line.split("\t")[4].split())
    with open(os.path.join(fixture, name), "w") as f:
        f.writelines(lines)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The fixture (6 micro-batches of 8 in ``short.tsv``: 3 updates at
    accumulation 2; UnBERT two lines), JAX's initial Miner weights as a port
    checkpoint, and the mesh runs started: the Miner from those weights and
    the pretrain, Fastformer and UnBERT kinds on 2 ranks, cached history on
    4."""
    root = tmp_path_factory.mktemp("torch_mesh_train")
    fixture = make_fixture(str(root / "fx"), num_lines=40, augmentations=AUGS)
    _write_head(fixture, "short.tsv", 48)
    with open(os.path.join(fixture, "behaviors.tsv")) as f, \
            open(os.path.join(fixture, "two.tsv"), "w") as g:
        g.writelines(f.readlines()[:2])
    jt = jax_trainer.Trainer(jax_parser().parse_args(_common(fixture, "train", "short.tsv", 2)
                                                     + list(MINER)))
    params = _initial_params(jt, jt._load_store(os.path.join(fixture, "news.tsv")), "Miner")
    init = str(root / "init.pt")
    checkpoint.save(init, {"params": params_from_jax(params)})
    runs = {}
    miner = [*_common(fixture, "train", "short.tsv", 2), *MINER, *JAX_OPTIMIZER,
             "--pretrained_model_path", init, "--train_path", str(root / "Miner"),
             "--mesh_data", "2"]
    jobs = [{"argv": miner, "out": str(root / "Miner" / "r"), "no_plm_dropout": True}]
    for family in ("pretrain", "fastformer", "unbert"):
        jobs.append({"argv": _family_argv(fixture, family, str(root / family)) + [
            "--mesh_data", "2"], "out": str(root / family / "r"), "no_plm_dropout": True})
    runs["two"] = Ranks(jobs, 2, str(root / "two"))
    his = {"argv": _family_argv(fixture, "his_cache", str(root / "his_cache")) + list(
        MESH["his_cache"]), "out": str(root / "his_cache" / "r"), "no_plm_dropout": True}
    runs["four"] = Ranks([his], 4, str(root / "four"))
    return dict(root=root, fixture=fixture, params=params, runs=runs)


def _mesh_result(mesh_runs, family):
    world = WORLD.get(family, 2)
    results = mesh_runs["runs"]["four" if world == 4 else "two"].wait()
    return results[str(mesh_runs["root"] / family / "r")]


def _one_rank(argv):
    """A one-rank ``train()`` in this process: what ``record`` records, the
    final parameters and the history-cache rebuilds."""
    tt = Trainer(make_parser().parse_args(argv))
    rec = record(tt)
    run = tt.train()
    caches = rec.pop("caches")
    return dict(rec, params=run.model.state_dict(),
                fills=caches[0].fills if caches and caches[0] else [])


def _assert_ranks_match_one(ranks, one):
    """Every rank holds rank 0's parameters bit for bit, and the history
    cache was rebuilt at the one-rank run's micro-steps. The global losses
    and the first update's gradients (the ranks' shares summed over the
    data group, divided and clipped) and their global norm before the clip
    (a sum off by a factor changes it, where the clip hides the factor
    from the clipped gradients) match the one-rank run's to the JAX
    package's multihost tolerance, rtol 1e-5, atol 5e-7: they differ by
    fp32 summation order alone (measured: the Miner's gradients by 2e-10,
    the pretrain kind's, whose loss is a sum, by 2e-8). From there Adam
    amplifies it: an element whose gradient is near zero moves by up to lr
    an update whatever its rounding (measured: the parameters after 3
    updates differ by up to 2.4e-5 for Fastformer, 3.3e-6 for the Miner),
    so the parameters are held to ``assert_runs_match``'s 1e-4, 3% of the
    3e-3 that 3 updates at lr 1e-3 can move an element (under 2% at the
    Miner's lr 2e-3)."""
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    got = ranks[0]
    assert got["fills"] == one["fills"]
    assert len(got["losses"]) == len(one["losses"]) and len(got["grads"]) == len(one["grads"])
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5, atol=5e-7)
    assert len(got["grad_norms"]) == len(one["grad_norms"])
    np.testing.assert_allclose(got["grad_norms"][0], one["grad_norms"][0], rtol=1e-5, atol=5e-7)
    assert got["grads"][0].keys() == one["grads"][0].keys()
    for k, want in one["grads"][0].items():
        np.testing.assert_allclose(got["grads"][0][k].numpy(), want.numpy(), rtol=1e-5,
                                   atol=5e-7, err_msg=k)
    assert got["params"].keys() == one["params"].keys()
    moved = 0
    for k, want in one["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
        moved += int(not torch.equal(got["params"][k], want))
    assert moved  # trained: not every tensor is the initial one on both sides


def test_two_ranks_train_the_miner_as_one_rank_and_as_jax_on_eight_devices(
        mesh_runs, tmp_path, no_dropout):
    """``--mesh_data 2``: each rank's 4 rows of every micro-batch of 8, the
    gradients summed over the ranks at each of 3 updates. The same losses
    and parameters as one rank, and as the JAX trainer on its 8-device
    virtual mesh from the same initial weights (the micro-steps' losses to
    1e-5, the parameters to ``assert_runs_match``'s 1e-4), with the
    optimizer of ``train_both`` (clip 0.05, lr 2e-3 after 2 warmup updates)."""
    fixture = mesh_runs["fixture"]
    r = train_both(fixture, str(tmp_path), "Miner", "--num_train_epochs", "1",
                   "--train_behaviors_path", os.path.join(fixture, "short.tsv"),
                   params=mesh_runs["params"])
    assert len(r["jax_losses"]) == 6  # 3 updates of 2 micro-batches
    ranks = _mesh_result(mesh_runs, "Miner")
    one = [*_common(fixture, "train", "short.tsv", 2), *MINER, *JAX_OPTIMIZER,
           "--pretrained_model_path", str(mesh_runs["root"] / "init.pt"),
           "--train_path", str(tmp_path / "one")]
    _assert_ranks_match_one(ranks, _one_rank(one))
    assert_runs_match(dict(r, port_losses=ranks[0]["losses"], port_params=ranks[0]["params"]))


@pytest.mark.parametrize("family", ["pretrain", "fastformer", "unbert", "his_cache"])
def test_a_mesh_trains_each_kind_as_one_rank(mesh_runs, tmp_path, no_dropout, family):
    """Two ranks on the data axis against one rank: the pretrain kind (a sum
    loss: averaged shares would halve its gradient), Fastformer and UnBERT
    (mean losses); and cached-history training on a 2 x 2 mesh of 4 ranks,
    the history cache row-sharded over the table axis and rebuilt at the
    one-rank run's micro-steps (JAX's rule)."""
    one = _one_rank(_family_argv(mesh_runs["fixture"], family, str(tmp_path)))
    ranks = _mesh_result(mesh_runs, family)
    assert len(ranks) == WORLD.get(family, 2)
    _assert_ranks_match_one(ranks, one)
    if family == "his_cache":
        assert one["fills"] == [2, 4, 8]
