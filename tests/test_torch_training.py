"""The port's training slice against the JAX package's.

Host-side pieces (losses, the cosine with a zeroed diagonal, behaviors log,
samplers, batcher, table lookup) must agree exactly or to float32 rounding;
the optimizer (clip, AdamW with the decay mask, warmup schedule, MultiSteps
accumulation) against ``make_optimizer`` over 12 updates; then 20 training
micro-steps of the tiny Miner on fixture batches from the same weights,
JAX's ``_make_train_step`` against the port's ``Trainer.train_step``, and the
cached eval after them. Both run in float32 with dropout off; every op of
the port runs its plain version on the CPU. Also: the CLI end to end
(``train``, ``eval`` from ``bestAucModel``, serving from ``finalModel``),
an exact ``--resume_from``, remat with dropout, and the refusals of flags
whose paths come later.
"""
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from miner_tpu.config import make_parser as jax_parser
from miner_tpu.data.batcher import Batcher as JaxBatcher
from miner_tpu.data.samplers import EvalSampler as JaxEvalSampler
from miner_tpu.data.samplers import OfflineSampler as JaxOfflineSampler
from miner_tpu.data.samplers import OnlineSampler as JaxOnlineSampler
from miner_tpu.observability.logging import RunLogger as JaxRunLogger
from miner_tpu.training import losses as jax_losses
from miner_tpu.training.optim import make_optimizer
from miner_tpu.training.train_state import TrainState
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu.utils import pairwise_cosine_similarity as jax_cosine
from miner_tpu_torch.cli import main as cli_main
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import EvalSampler, OfflineSampler, OnlineSampler
from miner_tpu_torch.models.convert import miner_params_from_jax
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.observability.logging import RunLogger
from miner_tpu_torch.parallel.news_cache import CacheFiller
from miner_tpu_torch.training import checkpoint, losses
from miner_tpu_torch.training.optim import Optimizer, scheduled_lr_value
from miner_tpu_torch.training.trainer import Trainer
from miner_tpu_torch.utils import pairwise_cosine_similarity
from tests.fixture_data import make_fixture

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: the tier-1 suite
    (ROADMAP.md) runs six xdist workers on one CPU, where each worker's
    intra-op threads oversubscribe it and the many small ops of the plain Philox dropout
    (the PLM in training mode) slow by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags(fixture, out=None, *extra):
    """tests/test_e2e.py's flag set, float32."""
    flags = [
        "--model_name", "Miner", "--pretrained_tokenizer", "hash:1000",
        "--user2id_path", os.path.join(fixture, "user2id.json"),
        "--category2id_path", os.path.join(fixture, "category2id.json"),
        "--max_title_length", "16", "--max_sapo_length", "24",
        "--his_length", "5", "--seed", "7", "--plm_preset", "tiny",
        "--apply_reduce_dim", "--use_sapo", "--use_category_bias",
        "--word_embed_dim", "32", "--category_embed_dim", "8",
        "--num_context_codes", "4", "--context_code_dim", "16",
        "--score_type", "weighted", "--npratio", "3",
        "--eval_batch_size", "16", "--compute_dtype", "float32",
        "--metrics", "auc", "group_auc", "mrr", "ndcg@5",
    ]
    return flags + list(extra)


def _train_flags(fixture, out, *extra):
    return ["train", *_flags(fixture),
            "--train_behaviors_path", os.path.join(fixture, "behaviors.tsv"),
            "--train_news_path", os.path.join(fixture, "news.tsv"),
            "--train_batch_size", "8", "--learning_rate", "1e-3",
            "--logging_steps", "2", "--train_path", os.path.join(out, "train"),
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_train")), num_lines=40)


# ---------------------------------------------------------------- losses
def _loss_inputs(rng, B=5, C=4, K=3, D=8):
    interests = rng.normal(size=(B, K, D)).astype(np.float32)
    logits = rng.normal(size=(B, C)).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    row_mask = np.array([1, 1, 1, 0, 0], bool)
    embs = rng.normal(size=(B, 7, D)).astype(np.float32)
    return interests, logits, labels, row_mask, embs


LOSS_CASES = {
    "cross_entropy": lambda m, i, lg, lb, rm, e: m.cross_entropy(lg, lb.argmax(-1)),
    "disagreement": lambda m, i, lg, lb, rm, e: m.disagreement(i),
    "disagreement_row_mask": lambda m, i, lg, lb, rm, e: m.disagreement(i, rm),
    "miner_loss": lambda m, i, lg, lb, rm, e: m.miner_loss(i, lg, lb),
    "vanilla_loss_onehot": lambda m, i, lg, lb, rm, e: m.vanilla_loss(lg, lb),
    "vanilla_loss_ints": lambda m, i, lg, lb, rm, e: m.vanilla_loss(lg, lb.argmax(-1)),
    "logsigmoid_eval_loss": lambda m, i, lg, lb, rm, e: m.logsigmoid_eval_loss(lg, lb, rm),
    "miner_eval_loss": lambda m, i, lg, lb, rm, e: m.miner_eval_loss(i, lg, lb, rm),
    "pretrain_contrastive": lambda m, i, lg, lb, rm, e: m.pretrain_contrastive(e, 3),
    "pretrain_contrastive_row_mask":
        lambda m, i, lg, lb, rm, e: m.pretrain_contrastive(e, 3, rm),
    "binary_cross_entropy": lambda m, i, lg, lb, rm, e: m.binary_cross_entropy_with_logits(lg, lb),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(rng, name):
    """Every loss of losses.py on the same arrays (float32 rounding)."""
    args = _loss_inputs(rng)
    want = float(LOSS_CASES[name](jax_losses, *map(jnp.asarray, args)))
    got = float(LOSS_CASES[name](losses, *map(T, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cosine_zero_diagonal_matches_jax(rng):
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    x[0, 1] = 0  # a zero row: clamped norm, no NaN
    want = np.asarray(jax_cosine(jnp.asarray(x), jnp.asarray(x), zero_diagonal=True))
    got = pairwise_cosine_similarity(T(x), T(x), zero_diagonal=True).numpy()
    assert np.isfinite(got).all() and (np.diagonal(got, axis1=1, axis2=2) == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ data
@pytest.fixture(scope="module")
def logs(fixture_dir):
    """(JAX trainer, port trainer, JAX store+log, port store+log)."""
    jt = JaxTrainer(jax_parser().parse_args(["train", *_flags(fixture_dir)]))
    tt = Trainer(make_parser().parse_args(["train", *_flags(fixture_dir),
                                           "--device", "cpu"]))
    beh, news = (os.path.join(fixture_dir, f) for f in ("behaviors.tsv", "news.tsv"))
    js = jt._load_store(news)
    ts = tt._load_store(news)
    from miner_tpu.data.behaviors import BehaviorsLog as JaxLog

    jlog = JaxLog.from_tsv(beh, js, jt.user2id, 5)
    return jt, tt, (js, jlog), (ts, tt._load_log(beh, ts))


def _assert_blocks_equal(a, b):
    for f in ("cand", "his", "label", "impression_id"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_behaviors_log_matches_jax(logs):
    _, _, (_, jlog), (_, tlog) = logs
    for field in ("user", "history", "hist_ptr", "pos_row", "impression_id",
                  "neg_flat", "neg_offsets", "eval_hist_ptr", "eval_user",
                  "eval_impression_id", "eval_cand_flat", "eval_label_flat",
                  "eval_offsets"):
        np.testing.assert_array_equal(getattr(tlog, field), getattr(jlog, field))
    assert tlog.eval_targets_by_impression() == jlog.eval_targets_by_impression()


@pytest.mark.parametrize("online", [True, False])
def test_samplers_and_batcher_match_jax_numpy_path(logs, online):
    """Exactly equal to the JAX package's numpy sampler (backend="numpy";
    its native sampler draws otherwise), over two epochs, and the shuffled
    batches with their padded tails."""
    _, _, (js, jlog), (ts, tlog) = logs
    jcls, tcls = ((JaxOnlineSampler, OnlineSampler) if online
                  else (JaxOfflineSampler, OfflineSampler))
    js_ = jcls(jlog, js, 3, seed=7, backend="numpy")
    ts_ = tcls(tlog, ts, 3, seed=7)
    for epoch in (0, 1):
        jb, tb = js_.sample_epoch(epoch), ts_.sample_epoch(epoch)
        _assert_blocks_equal(tb, jb)
        for drop_last, shuffle in ((True, True), (False, False)):
            jbat = JaxBatcher(6, drop_last=drop_last, shuffle=shuffle, seed=7)
            tbat = Batcher(6, drop_last=drop_last, shuffle=shuffle, seed=7)
            pairs = list(zip(jbat.batches(jb, epoch), tbat.batches(tb, epoch)))
            assert len(pairs) == jbat.num_batches(len(jb)) > 0
            for a, b in pairs:
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k])
    _assert_blocks_equal(EvalSampler(tlog).sample_all(), JaxEvalSampler(jlog).sample_all())


def test_table_lookup_matches_jax(logs, rng):
    jt, tt, (js, _), (ts, _) = logs
    jtable, ttable = jt._host_table(js), tt._make_table(ts)
    cand = rng.integers(0, js.num_news, size=(3, 4)).astype(np.int32)
    his = rng.integers(0, js.num_news, size=(3, 5)).astype(np.int32)
    from miner_tpu.data.device_table import NewsTable as JaxTable

    want = JaxTable.lookup(jtable, jnp.asarray(cand), jnp.asarray(his))
    got = ttable.lookup(T(cand), T(his))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------- optimizer
def test_optimizer_matches_optax(rng):
    """12 updates at accumulation 3 (36 micro-steps), a clip that triggers,
    warmup then decay, and biases / LayerNorm / rank-1 leaves that must not
    decay: the same parameters as make_optimizer to float32 noise, and the
    learning rates of scheduled_lr_value (optax's count from 0)."""
    shapes = {"dense": {"kernel": (4, 3), "bias": (3,)},
              "emb": {"embedding": (5, 4)}, "ln": {"scale": (4,), "bias": (4,)}}
    names = {("dense", "kernel"): "dense.weight", ("dense", "bias"): "dense.bias",
             ("emb", "embedding"): "emb.weight", ("ln", "scale"): "ln.weight",
             ("ln", "bias"): "ln.bias"}
    init = {m: {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in shapes.items()}
    grads = [{m: {k: (3 * rng.normal(size=s)).astype(np.float32)
                  for k, s in leaves.items()} for m, leaves in shapes.items()}
             for _ in range(36)]
    lr, total, warmup, wd, clip = 1e-2, 12, 3, 0.1, 0.5

    params = jax.tree_util.tree_map(jnp.asarray, init)
    tx = make_optimizer(params, learning_rate=lr, total_steps=total,
                        warmup_steps=warmup, weight_decay=wd, max_grad_norm=clip,
                        accum_steps=3)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)

    named = {names[(m, k)]: torch.nn.Parameter(T(v.T.copy() if k == "kernel" else v))
             for m, leaves in init.items() for k, v in leaves.items()}
    opt = Optimizer(named.items(), learning_rate=lr, total_steps=total,
                    warmup_steps=warmup, weight_decay=wd, max_grad_norm=clip,
                    accum_steps=3)
    applied = []
    for g in grads:
        for (m, k), name in names.items():
            gk = T(g[m][k].T.copy() if k == "kernel" else g[m][k])
            p = named[name]
            p.grad = gk if p.grad is None else p.grad + gk
        lr_next = opt.lr()
        if opt.step():
            applied.append(lr_next)
    assert opt.updates == 12
    assert applied == [scheduled_lr_value(lr, warmup, total, u) for u in range(12)]
    assert applied[0] == 0.0
    for (m, k), name in names.items():
        want = np.asarray(params[m][k])
        got = named[name].detach().numpy()
        np.testing.assert_allclose(got.T if k == "kernel" else got, want,
                                   rtol=1e-5, atol=1e-6)


# ------------------------------------------------- 20 micro-steps vs JAX
N_STEPS, ACCUM, TOTAL, WARMUP = 20, 2, 10, 2


@pytest.fixture(scope="module")
def trained(fixture_dir, tmp_path_factory):
    """Both packages train the same tiny Miner (float32, dropout 0) for 20
    micro-steps at accumulation 2 with a clip that triggers, on the same
    batches. Returns what the tests compare."""
    flags = [*_flags(fixture_dir), "--eval_behaviors_path",
             os.path.join(fixture_dir, "behaviors.tsv"), "--eval_news_path",
             os.path.join(fixture_dir, "news.tsv"), "--dropout", "0",
             "--gradient_accumulation_steps", str(ACCUM), "--max_grad_norm", "0.05",
             "--learning_rate", "2e-3", "--weight_decay", "0.05",
             "--train_batch_size", "8"]
    jt = JaxTrainer(jax_parser().parse_args(["train", *flags]))
    tt = Trainer(make_parser().parse_args(["train", *flags, "--device", "cpu"]))
    news = os.path.join(fixture_dir, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    tlog = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts)
    sampler = OnlineSampler(tlog, ts, 3, seed=7)
    batcher = Batcher(8, drop_last=True, shuffle=True, seed=7)
    batches = [b for epoch in range(3)
               for b in batcher.batches(sampler.sample_epoch(epoch), epoch)]
    assert len(batches) >= N_STEPS

    # the JAX model with every dropout at 0 (the PLM's rates are config
    # fields, not flags)
    import dataclasses as dc

    jmodel, kind = jt.build_model(js)
    plm = dc.replace(jmodel.news_encoder.plm_cfg, hidden_dropout=0.0,
                     attention_dropout=0.0)
    jmodel = jmodel.clone(news_encoder=jmodel.news_encoder.clone(plm_cfg=plm))
    example = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = jt._init_params_for_kind(jmodel, kind, jt._host_table(js), example)
    jtable = jt._make_table(js)
    tx = make_optimizer(params, learning_rate=2e-3, total_steps=TOTAL,
                        warmup_steps=WARMUP, weight_decay=0.05, max_grad_norm=0.05,
                        accum_steps=ACCUM)
    from miner_tpu.parallel.sharding import replicate_tree, shard_batch

    state = replicate_tree(jt.mesh, TrainState.create(params, tx,
                                                      jax.random.PRNGKey(8)))
    step = jt._make_train_step(jmodel, kind, jtable)

    model = tt.build_model()
    model.load_state_dict(miner_params_from_jax(jax.device_get(params)), strict=True)
    model.eval()  # the port's dropout off (gradients flow as in training)
    ttable = tt._make_table(ts)
    opt = tt.make_optimizer(model, TOTAL, WARMUP)

    jax_l, port_l = [], []
    for i in range(N_STEPS):
        b = batches[i]
        state, loss = step(state, shard_batch(jt.mesh, {k: v for k, v in b.items()
                                                         if k != "valid"}))
        jax_l.append(float(loss))
        port_l.append(float(tt.train_step(model, ttable, b, opt, i)))
    assert opt.updates == N_STEPS // ACCUM
    return dict(jt=jt, tt=tt, jmodel=jmodel, kind=kind, state=state,
                jtable=jtable, model=model, ttable=ttable, js=js, ts=ts,
                jax_losses=jax_l, port_losses=port_l,
                out=str(tmp_path_factory.mktemp("trained_eval")))


def test_twenty_micro_steps_match_jax(trained):
    """Loss trajectories (float32 summation-order noise, 1e-5) and final
    parameters: Adam normalises each gradient element, so an element whose
    gradient is near zero moves by up to lr (2e-3) per update whatever its
    rounding; after 10 updates the parameters agree to 1e-4 absolute, 0.5%
    of the 2e-2 the updates can move them (measured: 4.9e-5)."""
    np.testing.assert_allclose(trained["port_losses"], trained["jax_losses"],
                               rtol=1e-5, atol=1e-5)
    assert trained["jax_losses"][0] != trained["jax_losses"][-1]
    want = miner_params_from_jax(jax.device_get(trained["state"].params))
    got = trained["model"].state_dict()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_cached_eval_after_training_matches_jax(trained):
    """auc, group_auc, mrr, ndcg@5 and the eval loss of the port's
    ``_run_eval`` (news-embedding cache) against JAX's on the final weights
    of each (float32 noise; the eval loss, a sum over 40 impressions' rows,
    to 2e-4, the parameters' own agreement after 20 steps)."""
    jt, tt = trained["jt"], trained["tt"]
    beh = jt.args.eval_behaviors_path
    from miner_tpu.data.behaviors import BehaviorsLog as JaxLog

    jlog = JaxLog.from_tsv(beh, trained["js"], jt.user2id, 5)
    jlogger = JaxRunLogger(os.path.join(trained["out"], "jax"), "eval")
    want, want_loss = jt._run_eval(
        jt._make_eval_step(trained["jmodel"], trained["kind"], trained["jtable"]),
        trained["state"].params, jlog, jlogger, 0, 0,
        cached_ctx=(trained["jmodel"], trained["kind"], trained["jtable"]))
    tlog = tt._load_log(beh, trained["ts"])
    got, got_loss = tt._run_eval(trained["model"], trained["ttable"], trained["ts"],
                                 tlog, RunLogger(os.path.join(trained["out"], "port"),
                                                 "eval"), 0, 0)
    assert set(got) == set(want) == {"auc", "group_auc", "mrr", "ndcg@5"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-4)


# ------------------------------------------------------- CLI end to end
@pytest.fixture(scope="module")
def cli_run(fixture_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_cli"))
    argv = _train_flags(fixture_dir, out, "--eval_behaviors_path",
                        os.path.join(fixture_dir, "behaviors.tsv"),
                        "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
                        "--num_train_epochs", "2", "--remat",
                        "--gradient_accumulation_steps", "2")
    assert cli_main(argv) == 0
    (run_dir,) = glob.glob(os.path.join(out, "train", "*"))
    return out, run_dir


def test_cli_train_writes_the_run_dir(cli_run):
    _, rd = cli_run
    for name in ("args.json", "loss.csv", "eval.csv", "epoch.csv", "log/all.log"):
        assert os.path.exists(os.path.join(rd, name)), name
    for name in checkpoint.NAMES:
        assert os.path.isfile(os.path.join(rd, "ckpt", name)), name
    rows = open(os.path.join(rd, "eval.csv")).read().splitlines()
    assert rows[0].split(",") == ["epoch", "step", "loss", "auc", "group_auc",
                                  "mrr", "ndcg@5"]
    assert len(rows) == 3 and all(np.isfinite(float(v)) for r in rows[1:]
                                  for v in r.split(","))
    payload = checkpoint.load(os.path.join(rd, "ckpt", "finalModel"))
    assert payload["micro_step"] > 0 and payload["args"]["remat"] is True


def test_cli_eval_from_best_auc_model(cli_run, fixture_dir):
    out, rd = cli_run
    argv = ["eval", *_flags(fixture_dir), "--device", "cpu",
            "--eval_behaviors_path", os.path.join(fixture_dir, "behaviors.tsv"),
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--eval_path", os.path.join(out, "eval"), "--save_eval_result",
            "--saved_model_path", os.path.join(rd, "ckpt", "bestAucModel")]
    assert cli_main(argv) == 0
    scores = Trainer(make_parser().parse_args(argv)).eval()
    assert set(scores) == {"auc", "group_auc", "mrr", "ndcg@5"}
    assert all(np.isfinite(v) for v in scores.values())
    assert glob.glob(os.path.join(out, "eval", "*", "preds.pkl"))
    # the best-auc eval of the training run, reproduced from its checkpoint
    rows = [r.split(",") for r in open(os.path.join(rd, "eval.csv")).read().splitlines()]
    best = max(float(r[3]) for r in rows[1:])
    np.testing.assert_allclose(scores["auc"], best, rtol=1e-6)


def test_serve_scores_from_final_model(cli_run, fixture_dir):
    _, rd = cli_run
    args = make_parser().parse_args(
        ["serve", *_flags(fixture_dir), "--device", "cpu", "--eval_news_path",
         os.path.join(fixture_dir, "news.tsv"), "--saved_model_path",
         os.path.join(rd, "ckpt", "finalModel")])
    trainer = Trainer(args)
    ctx = trainer.serving_context()
    state = checkpoint.load(os.path.join(rd, "ckpt", "finalModel"))["params"]
    for k, v in ctx.model.state_dict().items():
        assert torch.equal(v, state[k]), k  # float32: restored as saved
    cand = np.array([[1, 2, 3, 0]], np.int32)
    his = np.array([[4, 5, 0, 0, 0]], np.int32)
    scores = trainer.serve_scores(ctx.model, ctx.cache, cand, his)
    assert scores.shape == (1, 4) and np.isfinite(scores).all()
    fresh = Trainer(make_parser().parse_args(
        ["serve", *_flags(fixture_dir), "--device", "cpu", "--eval_news_path",
         os.path.join(fixture_dir, "news.tsv")]))
    fctx = fresh.serving_context()
    assert not np.allclose(fresh.serve_scores(fctx.model, fctx.cache, cand, his), scores)


def test_resume_from_is_exact(fixture_dir, tmp_path):
    """With dropout on and accumulation 3 (the epoch ends mid-accumulation):
    one epoch, then --resume_from its finalModel for the second, ends at
    the parameters of two uninterrupted epochs (--max_steps fixes the
    schedule's total for both)."""
    common = ["--max_steps", "4", "--gradient_accumulation_steps", "3",
              "--dropout", "0.2", "--online", "1"]

    def run(out, epochs, *extra):
        argv = _train_flags(fixture_dir, str(out), "--num_train_epochs", str(epochs),
                            *common, *extra)
        return Trainer(make_parser().parse_args(argv)).train()

    whole = run(tmp_path / "whole", 2)
    first = run(tmp_path / "first", 1)
    assert first.step % 3 != 0  # the checkpoint holds a partial gradient sum
    resumed = run(tmp_path / "resumed", 2, "--resume_from",
                  os.path.join(first.run_dir, "ckpt", "finalModel"))
    assert resumed.step == whole.step == 2 * first.step
    want = whole.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k


# ------------------------------------------------------- remat, dropout
def test_remat_gives_the_same_gradients_with_dropout(fixture_dir):
    """One micro-batch at dropout 0.2 / 0.1 with and without --remat: the
    kernels' seeds are drawn outside each rematerialised layer, so the
    recompute drops the same elements and the gradients are equal."""
    grads = []
    for extra in ((), ("--remat",)):
        tt = Trainer(make_parser().parse_args(
            _train_flags(fixture_dir, "/nonexistent", *extra)))
        store = tt._load_store(os.path.join(fixture_dir, "news.tsv"))
        log = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), store)
        batch = next(Batcher(8).batches(OnlineSampler(log, store, 3, seed=7).sample_epoch(0)))
        model = tt.build_model().train()
        assert model.news_encoder.plm.cfg.remat == bool(extra)
        loss, _ = tt._apply_and_loss(model, tt._make_table(store), batch, True,
                                     DropoutRNG(8, 3, "cpu"))
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-7, msg=n)
    assert any(g.abs().sum() > 0 for g in grads[0].values())


def test_dropout_is_a_function_of_seed_and_step(fixture_dir):
    """The same (seed, micro-step) draws the same forward; another step
    draws another; eval() draws none."""
    tt = Trainer(make_parser().parse_args(_train_flags(fixture_dir, "/nonexistent")))
    store = tt._load_store(os.path.join(fixture_dir, "news.tsv"))
    log = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), store)
    batch = next(Batcher(8).batches(OnlineSampler(log, store, 3, seed=7).sample_epoch(0)))
    table = tt._make_table(store)
    model = tt.build_model().train()
    with torch.no_grad():
        run = lambda step: tt._apply_and_loss(model, table, batch, True,
                                              DropoutRNG(8, step, "cpu"))[1]
        a, b, c = run(0), run(0), run(1)
        model.eval()
        d, e = run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)


def test_serve_scores_unchanged_by_the_one_time_cast(fixture_dir):
    """bf16 serving casts the parameters once; the training model casts
    fp32 masters at each use. Both give the same bf16 values, so the same
    scores, bit for bit."""
    args = make_parser().parse_args(
        ["serve", *_flags(fixture_dir), "--device", "cpu", "--compute_dtype",
         "bfloat16", "--eval_news_path", os.path.join(fixture_dir, "news.tsv")])
    trainer = Trainer(args)
    ctx = trainer.serving_context()
    assert ctx.model.poly_attn.proj_kernel.dtype == torch.bfloat16
    model = trainer.build_model().eval()  # fp32 masters, bf16 compute
    assert model.poly_attn.proj_kernel.dtype == torch.float32
    cache = CacheFiller(model.encode_news).fill(ctx.table)
    assert torch.equal(cache.embeddings, ctx.cache.embeddings)
    cand = np.array([[1, 2, 3, 0], [5, 6, 0, 0]], np.int32)
    his = np.array([[4, 5, 7, 0, 0], [1, 0, 0, 0, 0]], np.int32)
    np.testing.assert_array_equal(trainer.serve_scores(model, cache, cand, his),
                                  trainer.serve_scores(ctx.model, ctx.cache, cand, his))


# ------------------------------------------------------ flags and configs
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_and_eval_configs_parse_unchanged():
    p = make_parser()
    t = p.parse_args(["train", "@" + os.path.join(REPO, "config", "train_miner.txt")])
    assert (t.plm_preset, t.train_batch_size, t.gradient_accumulation_steps,
            t.npratio, t.his_length, t.dropout, t.online) == (
        "roberta_base", 16, 8, 4, 50, 0.2, 1)
    assert t.remat and t.compute_dtype == "bfloat16" and t.evaluation_info == ["metrics"]
    e = p.parse_args(["eval", "@" + os.path.join(REPO, "config", "eval_miner.txt")])
    assert e.saved_model_path == "train/REPLACE_TIMESTAMP/ckpt/bestAucModel"
    assert e.save_eval_result and e.metrics[-1] == "hit@10"


@pytest.mark.parametrize("extra, match", [
    (["--his_cache_refresh", "2"], "cached-history training"),
    (["--combine_type", "lstm"], "the other combines"),
    (["--param_dtype", "bfloat16"], "float32"),
])
def test_training_flags_of_later_slices_are_refused(fixture_dir, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        Trainer(make_parser().parse_args(_train_flags(fixture_dir, "/nonexistent",
                                                      *extra)))


def test_orbax_checkpoint_directory_is_refused(fixture_dir, tmp_path):
    orbax = tmp_path / "ckpt" / "bestAucModel"
    orbax.mkdir(parents=True)
    trainer = Trainer(make_parser().parse_args(
        ["serve", *_flags(fixture_dir), "--device", "cpu", "--eval_news_path",
         os.path.join(fixture_dir, "news.tsv"), "--saved_model_path", str(orbax)]))
    with pytest.raises(ValueError, match="Orbax"):
        trainer.serving_context()


def _eval_trainer(fixture_dir, *extra):
    return Trainer(make_parser().parse_args(
        ["eval", *_flags(fixture_dir), "--device", "cpu", "--eval_behaviors_path",
         os.path.join(fixture_dir, "behaviors.tsv"), "--eval_news_path",
         os.path.join(fixture_dir, "news.tsv"), *extra]))


def test_cached_and_per_impression_eval_agree(fixture_dir, tmp_path):
    """The news-embedding cache changes throughput, not scores: --cached_eval
    and --no-cached_eval give the same metrics and loss (float32 noise);
    --fast_eval scores train-format rows."""
    out = {}
    for flag in ("--cached_eval", "--no-cached_eval", "--fast_eval"):
        tt = _eval_trainer(fixture_dir, flag)
        store = tt._load_store(tt.args.eval_news_path)
        model = tt.build_model().eval()
        out[flag] = tt._run_eval(model, tt._make_table(store), store,
                                 tt._load_log(tt.args.eval_behaviors_path, store),
                                 RunLogger(str(tmp_path), "eval"), 0, 0)
    (a, la), (b, lb) = out["--cached_eval"], out["--no-cached_eval"]
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    fast, fast_loss = out["--fast_eval"]
    assert set(fast) == set(a) and np.isfinite(list(fast.values()) + [fast_loss]).all()


def test_freeze_transformer_trains_only_the_rest(fixture_dir):
    tt = Trainer(make_parser().parse_args(
        _train_flags(fixture_dir, "/nonexistent", "--freeze_transformer")))
    store = tt._load_store(os.path.join(fixture_dir, "news.tsv"))
    log = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), store)
    batch = next(Batcher(8).batches(OnlineSampler(log, store, 3, seed=7).sample_epoch(0)))
    model = tt.build_model().train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tt.make_optimizer(model, total_updates=4, warmup=0)
    tt.train_step(model, tt._make_table(store), batch, opt, 0)
    assert opt.updates == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) == k.startswith("news_encoder.plm."), k
