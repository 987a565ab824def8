"""The port's UnBERT cross-encoder against the JAX package's.

The packer and both samplers bit for bit; the model's forward in all three
news modes and its loss gradients on weights carried over with
``params_from_jax``; training micro-steps of both trainers on the same
batches; the standalone ``eval`` of a port checkpoint against the JAX
package's ``_run_eval`` UnBERT branch; slates of the ``ScoringService``
against ``serve_scores_unbert``; the refusals of a cross-encoder; and the
CLI end to end (``train_fastformer`` -> ``eval_fastformer`` from
``bestAucModel`` -> ``recommend``). Float32, dropout off unless a test says
otherwise; each tolerance is stated where it is used.
"""
import dataclasses as dc
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from miner_tpu.config import make_parser as jax_parser
from miner_tpu.data import native as jax_native
from miner_tpu.data import unbert_packing as jax_packing
from miner_tpu.observability.logging import RunLogger as JaxRunLogger
from miner_tpu.training import losses as jax_losses
from miner_tpu.training.optim import make_optimizer
from miner_tpu.training.train_state import TrainState
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.cli import main as cli_main
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data import unbert_packing
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.serving import ScoringService
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

HIS = 5
FIELDS = ("input_ids", "input_mask", "segment_ids", "news_segment_ids",
          "sentence_ids", "sentence_mask", "sentence_segment_ids")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: the tier-1 suite
    (ROADMAP.md) runs six xdist workers on one CPU, where each worker's
    intra-op threads oversubscribe it and the many small ops of the plain
    Philox dropout (the PLM in training mode) slow by two orders of
    magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags(fixture, *extra):
    """The tiny UnBERT (2 word and 2 news layers of width 64), float32."""
    return [
        "--model_name", "unbert", "--pretrained_tokenizer", "hash:1000",
        "--user2id_path", os.path.join(fixture, "user2id.json"),
        "--category2id_path", os.path.join(fixture, "category2id.json"),
        "--max_title_length", "16", "--max_sapo_length", "24",
        "--his_length", str(HIS), "--seed", "3", "--plm_preset", "tiny",
        "--npratio", "3", "--eval_batch_size", "16", "--compute_dtype", "float32",
        "--metrics", "auc", "group_auc", "mrr", "ndcg@5", *extra]


def _paths(fixture, train_behaviors=None):
    beh, news = (os.path.join(fixture, f) for f in ("behaviors.tsv", "news.tsv"))
    return ["--train_behaviors_path", train_behaviors or beh, "--train_news_path", news,
            "--eval_behaviors_path", beh, "--eval_news_path", news]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_unbert")), num_lines=12)


@pytest.fixture(scope="module")
def pair(fixture_dir):
    """(JAX trainer, port trainer, JAX store, port store), the stores with
    the fixture's augmented variant, so the train sampler draws variants."""
    argv = ["train_fastformer", *_flags(fixture_dir), *_paths(fixture_dir)]
    jt = JaxTrainer(jax_parser().parse_args(argv))
    tt = Trainer(make_parser().parse_args([*argv, "--device", "cpu"]))
    news = os.path.join(fixture_dir, "news.tsv")
    js = jt._load_store(news, ["enhanced_text"])
    ts = tt._load_store(news, ["enhanced_text"])
    return jt, tt, js, ts


# ------------------------------------------------------------------ packer
HISTORIES = {
    "short": [3, 5, 0, 0, 0, 0, 0, 0],
    "overlong": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                 1, 2],
    "no_clicks": [0] * 8,
}


@pytest.mark.parametrize("legacy", [False, True], ids=["clicks_first", "legacy"])
@pytest.mark.parametrize("case,backend", [(c, "numpy") for c in sorted(HISTORIES)]
                         + [(c, "native") for c in sorted(HISTORIES)],
                         ids=sorted(HISTORIES) + [f"{c}-native" for c in sorted(HISTORIES)])
def test_pack_rows_bit_equal_to_jax_numpy(pair, monkeypatch, legacy, case, backend):
    """Every packed field, bit for bit, against the JAX package's
    ``pack_rows`` on the same path: its numpy packer (its native packer
    switched off) against the port's at ``backend="numpy"``, and its native
    packer against the port's copy (``-native``); at the default geometry
    (300 tokens, titles of 20, 20 clicks) and a short one (40 tokens, 8, 5)
    where the over-long history overflows the row; clicks-first rows and,
    under ``legacy_layout``, pads-first rows with 2-token pad sentences."""
    jt, tt, js, ts = pair
    if backend == "numpy":
        monkeypatch.setattr(jax_native, "native_available", lambda: False)
    else:
        assert jax_native.native_available()
    his = np.asarray(HISTORIES[case], np.int32)
    if legacy:
        n = int((his != 0).sum())
        his = np.concatenate([np.zeros(len(his) - n, np.int32), his[his != 0]])
    cand = np.array([4, 13, 0], np.int32)  # a variant row (13 = 12 + 1) and the pad news
    hist = np.stack([his, his[::-1].copy(), his])
    for geometry in ({}, dict(seq_max_len=40, news_max_len=8, hist_max_len=5)):
        ids = dict(cls_id=1, sep_id=2, pad_id=0, legacy_layout=legacy, **geometry)
        want = jax_packing.pack_rows(jax_packing.UnbertPacker(js, **ids), cand, hist)
        got = unbert_packing.pack_rows(unbert_packing.UnbertPacker(ts, **ids), cand, hist,
                                       backend)
        assert set(got) == set(want) == set(FIELDS)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("which", ["train_epoch0", "train_epoch1", "eval"])
def test_samplers_give_the_blocks_of_jax(pair, fixture_dir, which):
    """``UnbertTrainSampler.sample_epoch(0|1)`` (draws from (seed, epoch, 7),
    over the store's two variants) and ``UnbertEvalSampler.sample_all()``:
    every field of the block and of its packed rows equal to JAX's."""
    jt, tt, js, ts = pair
    beh = os.path.join(fixture_dir, "behaviors.tsv")
    from miner_tpu.data.behaviors import BehaviorsLog as JaxLog

    jlog = JaxLog.from_tsv(beh, js, jt.user2id, HIS)
    tlog = tt._load_log(beh, ts)
    jpack, tpack = jt._unbert_packer(js), tt._unbert_packer(ts)
    if which == "eval":
        want = jax_packing.UnbertEvalSampler(jlog, js, jpack).sample_all()
        got = unbert_packing.UnbertEvalSampler(tlog, ts, tpack).sample_all()
    else:
        epoch = int(which[-1])
        want = jax_packing.UnbertTrainSampler(jlog, js, jpack, 3, seed=3).sample_epoch(epoch)
        got = unbert_packing.UnbertTrainSampler(tlog, ts, tpack, 3, seed=3).sample_epoch(epoch)
        assert (got.cand_rows >= ts.num_news).any()  # the variant was drawn
    assert len(got) == len(want) > 0
    for f in ("cand_rows", "hist_ptr", "label", "impression_id"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    a, b = got.to_dict(), want.to_dict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------------- model
def _models(fixture_dir, mode, *extra):
    """The JAX UNBert with its dropout at 0, its parameters from the seed,
    and the port's UNBert holding them; plus packed rows of the fixture."""
    argv = ["train_fastformer", *_flags(fixture_dir, "--unbert_news_mode", mode, *extra),
            *_paths(fixture_dir)]
    jt = JaxTrainer(jax_parser().parse_args(argv))
    tt = Trainer(make_parser().parse_args([*argv, "--device", "cpu"]))
    news = os.path.join(fixture_dir, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    jmodel, kind = jt.build_model(js)
    assert kind == "unbert"
    jmodel = jmodel.clone(cfg=dc.replace(jmodel.cfg, hidden_dropout=0.0,
                                         attention_dropout=0.0))
    block = tt._train_sampler(tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts),
                              ts).sample_epoch(0)
    feat = block.materialize(np.arange(4))
    params = jt._init_params_for_kind(jmodel, kind, None, feat)
    model = tt.build_model()
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jt, tt, jmodel, params, model.eval(), feat


def _jax_feat(feat):
    return {k: jnp.asarray(feat[k]) for k in unbert_packing.FEATURES}


def _torch_feat(feat):
    return {k: torch.as_tensor(feat[k]) for k in unbert_packing.FEATURES}


@pytest.mark.parametrize("mode", ["nseg", "mean", "attention"])
def test_forward_matches_jax_in_every_news_mode(fixture_dir, mode):
    """Click scores of 4 packed rows (L = 300, S = 23) on the same weights:
    float32 summation order through 4 layers, 1e-5 of the scores' scale.
    The attention mode also holds ``att_mapping_in`` (300 * 64 -> 128)."""
    _, _, jmodel, params, model, feat = _models(fixture_dir, mode)
    want = np.asarray(jmodel.apply({"params": params}, _jax_feat(feat), deterministic=True))
    with torch.no_grad():
        got = model(_torch_feat(feat)).numpy()
    assert got.shape == want.shape == (4,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_loss_and_every_gradient_match_jax_grad(fixture_dir):
    """The training loss (BCE with logits, nseg) and the gradient of every
    parameter against ``jax.grad``: the loss to 1e-6; each gradient to
    1e-4 of its own largest magnitude plus 1e-6 of the largest over all
    (float32 sums of 4 layers forward and back taken in other orders)."""
    _, _, jmodel, params, model, feat = _models(fixture_dir, "nseg")
    label = feat["label"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, _jax_feat(feat), deterministic=True)
        return jax_losses.binary_cross_entropy_with_logits(logits, jnp.asarray(label))

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(jax.device_get(grads))
    from miner_tpu_torch.training import losses

    loss = losses.binary_cross_entropy_with_logits(model(_torch_feat(feat)),
                                                   torch.as_tensor(label))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    overall = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        tol = 1e-4 * float(g.abs().max()) + 1e-6 * overall
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=0, atol=tol, err_msg=n)


N_STEPS, ACCUM, TOTAL, WARMUP = 4, 2, 2, 1


def test_training_micro_steps_match_jax(fixture_dir):
    """Four micro-steps of batch 8 (the JAX mesh's 8 CPU devices) at
    accumulation 2 (2 updates, a clip that triggers) of JAX's ``_make_train_step`` and the port's ``train_step`` on
    the same shuffled packed batches from the same weights, dropout off:
    the loss trajectories agree to 1e-5, the tolerance of
    tests/test_torch_training.py (float32 summation order)."""
    jt, tt, jmodel, params, model, _ = _models(
        fixture_dir, "nseg", "--gradient_accumulation_steps", str(ACCUM),
        "--max_grad_norm", "0.05", "--learning_rate", "2e-3", "--weight_decay", "0.05",
        "--train_batch_size", "8")
    ts = tt._load_store(os.path.join(fixture_dir, "news.tsv"))
    block = tt._train_sampler(tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts),
                              ts).sample_epoch(0)
    batches = list(Batcher(8, drop_last=True, shuffle=True, seed=3).batches(block))[:N_STEPS]
    assert len(batches) == N_STEPS
    tx = make_optimizer(params, learning_rate=2e-3, total_steps=TOTAL, warmup_steps=WARMUP,
                        weight_decay=0.05, max_grad_norm=0.05, accum_steps=ACCUM)
    from miner_tpu.parallel.sharding import replicate_tree, shard_batch

    state = replicate_tree(jt.mesh, TrainState.create(params, tx, jax.random.PRNGKey(4)))
    step = jt._make_train_step(jmodel, "unbert", None)
    opt = tt.make_optimizer(model, TOTAL, WARMUP)
    jax_l, port_l = [], []
    for i, b in enumerate(batches):
        state, loss = step(state, shard_batch(jt.mesh, {k: v for k, v in b.items()
                                                         if k != "valid"}))
        jax_l.append(float(loss))
        port_l.append(float(tt.train_step(model, None, b, opt, i)))
    assert opt.updates == N_STEPS // ACCUM
    assert jax_l[0] != jax_l[-1]
    np.testing.assert_allclose(port_l, jax_l, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_weights(fixture_dir, tmp_path_factory):
    """The JAX UNBert's parameters from the seed, and the port checkpoint
    holding them (a ``finalModel``-style file of ``params`` alone)."""
    jt, tt, jmodel, params, model, _ = _models(fixture_dir, "nseg")
    path = str(tmp_path_factory.mktemp("unbert_ckpt") / "fromJax")
    checkpoint.save(path, {"params": model.state_dict()})
    return jt, jmodel, params, path


def test_standalone_eval_of_a_checkpoint_matches_jax_run_eval(jax_weights, fixture_dir,
                                                             tmp_path):
    """``eval_fastformer`` of a port checkpoint through the CLI against the
    JAX package's ``_run_eval`` UnBERT branch (the one its ``train`` runs;
    its standalone ``eval`` raises for UnBERT) on the same parameters:
    every metric to 1e-6, the summed eval loss to 1e-5 (float32)."""
    jt, jmodel, params, path = jax_weights
    beh = os.path.join(fixture_dir, "behaviors.tsv")
    argv = ["eval_fastformer", *_flags(fixture_dir), "--device", "cpu",
            "--eval_behaviors_path", beh,
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--eval_path", str(tmp_path / "port"), "--saved_model_path", path,
            "--fast_eval"]  # ignored by a cross-encoder, as in JAX
    assert cli_main(argv) == 0
    (csv_path,) = glob.glob(str(tmp_path / "port" / "*" / "eval.csv"))
    header, row = [r.split(",") for r in open(csv_path).read().splitlines()]
    got = {k: float(v) for k, v in zip(header[3:], row[3:])}
    from miner_tpu.data.behaviors import BehaviorsLog as JaxLog

    js = jt._load_store(os.path.join(fixture_dir, "news.tsv"))
    jt._eval_store_for_unbert = js
    jlog = JaxLog.from_tsv(beh, js, jt.user2id, HIS)
    want, want_loss = jt._run_eval(jt._make_eval_step(jmodel, "unbert", None), params, jlog,
                                   JaxRunLogger(str(tmp_path / "jax"), "eval"), 0, 0)
    assert set(got) == set(want) == {"auc", "group_auc", "mrr", "ndcg@5"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(row[2]), want_loss, rtol=1e-5)


def _serve_argv(fixture, *extra):
    return ["serve", *_flags(fixture), "--device", "cpu", "--eval_news_path",
            os.path.join(fixture, "news.tsv"), *extra]


def test_scoring_service_slates_match_jax_serve_scores_unbert(jax_weights, fixture_dir):
    """Two coalesced slates through the ``ScoringService`` (the port's
    weights from ``params_from_jax``) against the JAX package's
    ``serve_scores_unbert`` on the same parameters and rows: within 5e-4 of
    the scores' scale (float32 both; the margin covers the summation
    orders of two libraries)."""
    jt, jmodel, params, _ = jax_weights
    service = ScoringService(Trainer(make_parser().parse_args(_serve_argv(fixture_dir))),
                             state_dict=params_from_jax(jax.device_get(params)))
    try:
        store = service.ctx.store
        history = [["N1", "N3"], ["N2", "N4", "N5", "N6", "N7", "N8", "N9"]]
        slates = [["N7", "N8", "N2"], ["N1", "N10", "N11", "N3"]]
        got = [dict(service.score(h, c)) for h, c in zip(history, slates)]
        his = np.stack([service._prepare(h, c, None)[1] for h, c in zip(history, slates)])
        cand = np.zeros((2, 4), np.int32)
        for i, c in enumerate(slates):
            cand[i, :len(c)] = [store.id_to_row[n] for n in c]
        want = jt.serve_scores_unbert(jmodel, params, jt._unbert_packer(jt._load_store(
            os.path.join(fixture_dir, "news.tsv"))), cand, his)
        for i, c in enumerate(slates):
            scores = [s for _, s in service.score(history[i], c)]
            assert scores == sorted(scores, reverse=True)
            g = np.array([got[i][n] for n in c])
            np.testing.assert_allclose(g, want[i, :len(c)], rtol=0,
                                       atol=5e-4 * np.abs(want).max())
    finally:
        service.close()


def test_cross_encoder_refusals(fixture_dir):
    """A whole-corpus request names the cross-encoder; a slate above
    --serve_max_slate is refused; the warm-up runs the slate path's batch
    buckets (1 and 2) and no top-k."""
    service = ScoringService(Trainer(make_parser().parse_args(
        _serve_argv(fixture_dir, "--serve_max_slate", "3"))))
    try:
        assert service.batcher.topk_fn is None and service.ctx.cache is None
        with pytest.raises(ValueError, match="cross-encoder"):
            service.score(["N1"], None, topk=3)
        with pytest.raises(ValueError, match="serve_max_slate=3"):
            service.score(["N1"], ["N2", "N3", "N4", "N5"])
        assert len(service.score(["N1"], ["N2", "N3", "N4"])) == 3
        assert service.warmup([3], topk=4, max_b=2) == 2
    finally:
        service.close()


# ------------------------------------------------------------ CLI end to end
@pytest.fixture(scope="module")
def cli_run(fixture_dir, tmp_path_factory):
    """``train_fastformer`` with dropout on (the PLM's 0.1) over the first
    behaviors line (the plain Philox dropout of 300-token rows is slow on
    the CPU), eval over the whole fixture, accumulation 2."""
    out = str(tmp_path_factory.mktemp("torch_unbert_cli"))
    short = os.path.join(out, "behaviors_short.tsv")
    with open(os.path.join(fixture_dir, "behaviors.tsv")) as f:
        lines = f.readlines()[:1]
    with open(short, "w") as f:
        f.writelines(lines)
    argv = ["train_fastformer", *_flags(fixture_dir), *_paths(fixture_dir, short),
            "--device", "cpu", "--train_batch_size", "4", "--num_train_epochs", "1",
            "--gradient_accumulation_steps", "2", "--learning_rate", "1e-3",
            "--train_path", os.path.join(out, "train"), "--remat"]
    assert cli_main(argv) == 0
    (run_dir,) = glob.glob(os.path.join(out, "train", "*"))
    return out, run_dir


def test_cli_train_then_eval_reproduces_the_best_auc(cli_run, fixture_dir):
    out, rd = cli_run
    for name in checkpoint.NAMES:
        assert os.path.isfile(os.path.join(rd, "ckpt", name)), name
    payload = checkpoint.load(os.path.join(rd, "ckpt", "finalModel"))
    assert payload["micro_step"] > 0
    assert any(k.startswith("news_layers.1.") for k in payload["params"])
    rows = [r.split(",") for r in open(os.path.join(rd, "eval.csv")).read().splitlines()]
    assert rows[0] == ["epoch", "step", "loss", "auc", "group_auc", "mrr", "ndcg@5"]
    argv = ["eval_fastformer", *_flags(fixture_dir), "--device", "cpu",
            "--eval_behaviors_path", os.path.join(fixture_dir, "behaviors.tsv"),
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--eval_path", os.path.join(out, "eval"),
            "--saved_model_path", os.path.join(rd, "ckpt", "bestAucModel")]
    scores = Trainer(make_parser().parse_args(argv)).eval()
    # the end-of-epoch eval of the training run, bit for bit (eval.csv
    # holds each float's repr)
    assert scores["auc"] == max(float(r[3]) for r in rows[1:])
    assert all(np.isfinite(v) for v in scores.values())


@pytest.mark.parametrize("candidates", [["N7", "N8", "N2", "N5"], None],
                         ids=["slate", "whole_corpus"])
def test_cli_recommend_ranks_slates_and_refuses_the_corpus(cli_run, fixture_dir, capsys,
                                                          candidates):
    _, rd = cli_run
    argv = ["recommend", *_flags(fixture_dir), "--device", "cpu",
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--saved_model_path", os.path.join(rd, "ckpt", "finalModel"),
            "--user_history", "N1", "N3", "--topk", "3"]
    if candidates is None:
        with pytest.raises(ValueError, match="cross-encoder"):
            cli_main(argv)
        return
    assert cli_main([*argv, "--candidates", *candidates]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    scores = [float(ln.split("\t")[1]) for ln in lines]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    assert {ln.split("\t")[0] for ln in lines} <= set(candidates)

