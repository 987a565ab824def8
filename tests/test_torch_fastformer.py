"""The port's Fastformer family against the JAX package's.

The op (the plain version every CPU tensor takes) against the Pallas kernel
run in interpret mode and against the XLA reference, with its gradients;
the ``Fastformer`` user encoder and ``FastformerUserModel`` on weights
carried over with ``params_from_jax``; the bf16-compute model, whose user
encoder stays float32; 20 training micro-steps of both trainers with
``--freeze_transformer`` on the same batches, the cached eval after them,
and ``serve_scores``; the CLI end to end (``train_fastformer``,
``eval_fastformer``, ``recommend``); dropout as a pure function of
(seed, step). Float32 unless a test says otherwise; each tolerance is
stated where it is used.
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
from miner_tpu.models.fastformer import Fastformer as JaxFastformer
from miner_tpu.models.fastformer import FastformerConfig as JaxFastformerConfig
from miner_tpu.observability.logging import RunLogger as JaxRunLogger
from miner_tpu.ops.fastformer_attn import (
    fastformer_attention_fused as jax_ff_fused,
    fastformer_attention_reference as jax_ff_reference,
)
from miner_tpu.training.optim import make_optimizer
from miner_tpu.training.train_state import TrainState
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.cli import main as cli_main
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import OnlineSampler
from miner_tpu_torch.models import Fastformer, FastformerConfig, FastformerUserModel
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.observability.logging import RunLogger
from miner_tpu_torch.ops import fastformer_attention_fused, launch_counts
from miner_tpu_torch.ops.fastformer_attn import fastformer_attention_reference
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

T = torch.from_numpy
HIS = 5


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


def _flags(fixture, *extra):
    """The tiny Fastformer: D = 32 news embeddings, so 16 heads of head
    dim 2 (trainer.py:286), float32."""
    return [
        "--model_name", "fastformer", "--pretrained_tokenizer", "hash:1000",
        "--user2id_path", os.path.join(fixture, "user2id.json"),
        "--category2id_path", os.path.join(fixture, "category2id.json"),
        "--max_title_length", "16", "--max_sapo_length", "24",
        "--his_length", str(HIS), "--seed", "7", "--plm_preset", "tiny",
        "--apply_reduce_dim", "--use_sapo", "--word_embed_dim", "32",
        "--npratio", "3", "--eval_batch_size", "16", "--compute_dtype", "float32",
        "--metrics", "auc", "group_auc", "mrr", "ndcg@5", *extra]


def _data_flags(fixture):
    beh, news = (os.path.join(fixture, f) for f in ("behaviors.tsv", "news.tsv"))
    return ["--train_behaviors_path", beh, "--train_news_path", news,
            "--eval_behaviors_path", beh, "--eval_news_path", news]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_ff")), num_lines=40)


# --------------------------------------------------------------------- op
def _op_inputs(rng, B, L, D, h):
    q, k = (rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(2))
    wqa, wka = ((rng.normal(size=(D, h)) * 0.3).astype(np.float32) for _ in range(2))
    bqa, bka = ((rng.normal(size=(h,)) * 0.1).astype(np.float32) for _ in range(2))
    mask = np.ones((B, L), np.int32)
    mask[0, L // 2:] = 0  # padded positions
    mask[-1, :] = 0  # a fully masked row: a softmax over every position
    return q, k, wqa, bqa, wka, bka, mask


@pytest.mark.parametrize("B, L, D, h", [(4, 8, 32, 4), (2, 50, 256, 16)])
def test_op_matches_pallas_kernel_and_reference(rng, B, L, D, h):
    """The port's plain version against the Pallas kernel (interpreted) and
    the XLA reference: float32 summation order only, 1e-5."""
    args = _op_inputs(rng, B, L, D, h)
    got = fastformer_attention_fused(*map(T, args), h).numpy()
    assert np.isfinite(got).all() and np.abs(got[-1]).sum() > 0
    for want in (jax_ff_fused(*map(jnp.asarray, args), h, True),
                 jax_ff_reference(*map(jnp.asarray, args), h)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_op_gradients_match_jax_vjp(rng):
    """Gradients of q, k, wqa, bqa, wka and bka against ``jax.vjp`` of the
    custom_vjp (kernel forward, the reference's VJP): float32, 1e-5 of
    each gradient's scale."""
    B, L, D, h = 3, 8, 32, 4
    *xs, mask = _op_inputs(rng, B, L, D, h)
    cot = rng.normal(size=(B, L, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_ff_fused(*a, jnp.asarray(mask), h, True),
                     *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(cot))
    leaves = [T(x).requires_grad_() for x in xs]
    fastformer_attention_fused(*leaves, T(mask), h).backward(T(cot))
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_op_on_the_cpu_is_the_plain_version_and_launches_nothing(rng):
    args = list(map(T, _op_inputs(rng, 2, 6, 32, 16)))  # head dim 2
    before = launch_counts()
    got = fastformer_attention_fused(*args, 16)
    assert launch_counts() == before
    assert torch.equal(got, fastformer_attention_reference(*args, 16))
    with pytest.raises(ValueError, match="divide"):
        fastformer_attention_fused(*args, 5)


# ----------------------------------------------------------------- models
def _ff_cfgs(**kw):
    common = dict(hidden_size=32, num_heads=16, intermediate_size=32,
                  num_layers=2, max_position_embeddings=16, **kw)
    return JaxFastformerConfig(**common), FastformerConfig(**common)


@pytest.mark.parametrize("use_fused", [False, True])
def test_fastformer_matches_jax(rng, use_fused):
    """The user encoder on carried-over weights, loaded strictly, against
    JAX's fused and unfused paths; a row with an empty history pools to a
    zero vector in both (float32, 2e-5)."""
    jcfg, tcfg = _ff_cfgs()
    x = rng.normal(size=(3, 6, 32)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1] * 6, [0] * 6], np.int32)
    jmodel = JaxFastformer(jcfg, use_fused=use_fused)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, mask)["params"]
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x, mask))
    model = Fastformer(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = model.eval()(T(x), T(mask)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    assert not got[2].any() and not want[2].any()


def test_carry_over_keeps_the_attention_kernels_layout():
    jcfg, tcfg = _ff_cfgs()
    x = np.zeros((1, 4, 32), np.float32)
    params = JaxFastformer(jcfg).init(jax.random.PRNGKey(1), x, np.ones((1, 4)))["params"]
    state = params_from_jax(jax.device_get(params))
    assert state["layers.1.self_attn.query_att_kernel"].shape == (32, 16)
    np.testing.assert_array_equal(
        state["layers.0.self_attn.query.weight"].numpy(),
        np.asarray(params["layer_0"]["self_attn"]["query"]["kernel"]).T)
    assert set(state) == set(Fastformer(tcfg).state_dict())


# -------------------------------------------------- trainers on a fixture
@pytest.fixture(scope="module")
def pair(fixture_dir):
    """The JAX and port trainers of the tiny Fastformer, and a batch."""
    flags = [*_flags(fixture_dir), *_data_flags(fixture_dir)]
    jt = JaxTrainer(jax_parser().parse_args(["train_fastformer", *flags]))
    tt = Trainer(make_parser().parse_args(["train_fastformer", *flags,
                                           "--device", "cpu"]))
    news = os.path.join(fixture_dir, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    tlog = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts)
    batch = next(Batcher(8).batches(OnlineSampler(tlog, ts, 3, seed=7).sample_epoch(0)))
    return jt, tt, js, ts, batch


def _jax_model_and_params(jt, js, batch, dropout=0.0):
    """JAX's model with the PLM's own dropout rates at ``dropout`` (they
    are config fields, not flags) and its initial parameters from the
    seed."""
    jmodel, kind = jt.build_model(js)
    plm = dc.replace(jmodel.news_encoder.plm_cfg, hidden_dropout=dropout,
                     attention_dropout=dropout)
    jmodel = jmodel.clone(news_encoder=jmodel.news_encoder.clone(plm_cfg=plm))
    key = jax.random.PRNGKey(jt.args.seed)
    model_batch = jt._host_table(js).lookup(jnp.asarray(batch["cand_idx"]),
                                            jnp.asarray(batch["his_idx"]))
    # _init_params_for_kind's init, jitted (op-by-op dispatch is slow)
    init = jax.jit(lambda b: jmodel.init({"params": key, "dropout": key}, b))
    return jmodel, kind, init(model_batch)["params"]


def _jax_logits(jmodel, params, jtable, batch):
    """JAX's logits of a batch, jitted (op-by-op dispatch is slow)."""
    fn = jax.jit(lambda p, c, h: jmodel.apply({"params": p}, jtable.lookup(c, h)))
    return fn(params, jnp.asarray(batch["cand_idx"]), jnp.asarray(batch["his_idx"]))


def test_model_on_a_batch_matches_jax(pair):
    """FastformerUserModel's forward (one PLM call per field, the user
    encoder, the dot) on a fixture batch: float32 through a tiny PLM and two
    Fastformer layers, 1e-4 relative."""
    jt, tt, js, ts, batch = pair
    jmodel, kind, params = _jax_model_and_params(jt, js, batch)
    assert kind == "vanilla"
    jtable = jt._make_table(js)
    want = np.asarray(_jax_logits(jmodel, params, jtable, batch))
    model = tt.build_model()
    assert isinstance(model, FastformerUserModel)
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.no_grad():
        _, got = tt._apply_and_loss(model.eval(), tt._make_table(ts), batch, False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_bf16_compute_keeps_the_user_encoder_in_float32(fixture_dir):
    """At --compute_dtype bfloat16 only the news encoder computes in bf16:
    the logits are float32 and agree with JAX's within bf16 rounding of the
    news representations (2**-7 relative through the tiny PLM; 2e-2 of the
    logits' scale), and serving casts only the news tower."""
    flags = [*_flags(fixture_dir), *_data_flags(fixture_dir),
             "--compute_dtype", "bfloat16"]
    jt = JaxTrainer(jax_parser().parse_args(["train", *flags]))
    tt = Trainer(make_parser().parse_args(["train", *flags, "--device", "cpu"]))
    news = os.path.join(fixture_dir, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    tlog = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts)
    batch = next(Batcher(8).batches(OnlineSampler(tlog, ts, 3, seed=7).sample_epoch(0)))
    jmodel, _, params = _jax_model_and_params(jt, js, batch)
    want = _jax_logits(jmodel, params, jt._make_table(js), batch)
    assert want.dtype == jnp.float32
    model = tt.build_model()
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.no_grad():
        _, got = tt._apply_and_loss(model.eval(), tt._make_table(ts), batch, False)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-2 * max(1e-3, np.abs(want).max()))
    ctx = Trainer(make_parser().parse_args(
        ["serve", *_flags(fixture_dir), "--compute_dtype", "bfloat16",
         "--device", "cpu", "--eval_news_path", news])).serving_context()
    assert ctx.cache.embeddings.dtype == torch.bfloat16
    assert ctx.model.news_encoder.reduce_dim.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ctx.model.fast_attn.parameters())


# ------------------------------------------------- 20 micro-steps vs JAX
N_STEPS, ACCUM, TOTAL, WARMUP = 20, 2, 10, 2


@pytest.fixture(scope="module")
def trained(fixture_dir, tmp_path_factory):
    """Both packages train the same tiny Fastformer (float32, dropout 0,
    --freeze_transformer) for 20 micro-steps at accumulation 2 with a clip
    that triggers, on the same batches."""
    flags = [*_flags(fixture_dir), *_data_flags(fixture_dir), "--dropout", "0",
             "--freeze_transformer", "--gradient_accumulation_steps", str(ACCUM),
             "--max_grad_norm", "0.05", "--learning_rate", "2e-3",
             "--weight_decay", "0.05", "--train_batch_size", "8"]
    jt = JaxTrainer(jax_parser().parse_args(["train_fastformer", *flags]))
    tt = Trainer(make_parser().parse_args(["train_fastformer", *flags,
                                           "--device", "cpu"]))
    news = os.path.join(fixture_dir, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    tlog = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts)
    sampler = OnlineSampler(tlog, ts, 3, seed=7)
    batcher = Batcher(8, drop_last=True, shuffle=True, seed=7)
    batches = [b for epoch in range(3)
               for b in batcher.batches(sampler.sample_epoch(epoch), epoch)]
    assert len(batches) >= N_STEPS
    jmodel, kind, params = _jax_model_and_params(jt, js, batches[0])
    jtable = jt._make_table(js)
    tx = make_optimizer(params, learning_rate=2e-3, total_steps=TOTAL,
                        warmup_steps=WARMUP, weight_decay=0.05, max_grad_norm=0.05,
                        accum_steps=ACCUM, trainable_pred=jt._trainable_pred())
    from miner_tpu.parallel.sharding import replicate_tree, shard_batch

    state = replicate_tree(jt.mesh, TrainState.create(params, tx,
                                                      jax.random.PRNGKey(8)))
    step = jt._make_train_step(jmodel, kind, jtable)

    model = tt.build_model()
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
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
                initial=initial, jax_losses=jax_l, port_losses=port_l,
                out=str(tmp_path_factory.mktemp("ff_trained_eval")))


def test_twenty_micro_steps_match_jax(trained):
    """Losses to 1e-5 (float32 summation order) and final parameters to
    1e-4 absolute (Adam moves a near-zero gradient's element by up to lr
    per update whatever its rounding: 0.5% of the 2e-2 ten updates can
    move it); the PLM, frozen in both, is bit-identical to its start."""
    np.testing.assert_allclose(trained["port_losses"], trained["jax_losses"],
                               rtol=1e-5, atol=1e-5)
    assert trained["jax_losses"][0] != trained["jax_losses"][-1]
    want = params_from_jax(jax.device_get(trained["state"].params))
    got = trained["model"].state_dict()
    assert want.keys() == got.keys()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
        same = torch.equal(got[k], trained["initial"][k])
        assert same == k.startswith("news_encoder.plm."), k
        moved += not same
    assert moved > 0


def test_cached_eval_after_training_matches_jax(trained):
    """Metrics and the logsigmoid eval loss of the port's cached
    ``_run_eval`` against JAX's on the final weights of each (float32; the
    loss, a sum over 40 impressions, to 2e-4)."""
    jt, tt = trained["jt"], trained["tt"]
    beh = jt.args.eval_behaviors_path
    from miner_tpu.data.behaviors import BehaviorsLog as JaxLog

    jlog = JaxLog.from_tsv(beh, trained["js"], jt.user2id, HIS)
    want, want_loss = jt._run_eval(
        jt._make_eval_step(trained["jmodel"], trained["kind"], trained["jtable"]),
        trained["state"].params, jlog,
        JaxRunLogger(os.path.join(trained["out"], "jax"), "eval"), 0, 0,
        cached_ctx=(trained["jmodel"], trained["kind"], trained["jtable"]))
    got, got_loss = tt._run_eval(
        trained["model"], trained["ttable"], trained["ts"],
        tt._load_log(beh, trained["ts"]),
        RunLogger(os.path.join(trained["out"], "port"), "eval"), 0, 0)
    assert set(got) == set(want) == {"auc", "group_auc", "mrr", "ndcg@5"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-4)


def test_serve_scores_match_jax(trained, fixture_dir):
    """Slate scores and the whole-corpus top-k from the news-embedding
    cache on the trained weights, against JAX's ``serve_scores`` and
    ``serve_topk`` (float32, 1e-4 relative)."""
    jt = trained["jt"]
    base = [*_flags(fixture_dir), "--eval_news_path",
            os.path.join(fixture_dir, "news.tsv")]
    jserve = JaxTrainer(jax_parser().parse_args(["serve", *base]))
    tserve = Trainer(make_parser().parse_args(["serve", *base, "--device", "cpu"]))
    params = trained["state"].params
    jmodel, jkind = trained["jmodel"], trained["kind"]
    jcache = jt._build_eval_cache(jmodel, params, trained["jtable"])
    ctx = tserve.serving_context(params_from_jax(jax.device_get(params)))
    np.testing.assert_allclose(ctx.cache.embeddings.numpy(),
                               np.asarray(jcache.embeddings), rtol=1e-4, atol=2e-5)
    cand = np.zeros((2, 16), np.int32)
    cand[0, :5], cand[1, :9] = [1, 2, 3, 5, 8], np.arange(3, 12)
    his = np.zeros((2, HIS), np.int32)
    his[0, :3] = [3, 7, 11]  # row 1 is an empty history: all logits 0
    want = jserve.serve_scores(jmodel, jkind, params, jcache, cand, his)
    got = tserve.serve_scores(ctx.model, ctx.cache, cand, his)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    assert not got[1].any()
    n = ctx.store.num_news
    want_vals, want_rows = jserve.serve_topk(jmodel, jkind, params, jcache, his[:1],
                                             4, num_news=n)
    vals, rows = tserve.serve_topk(ctx.model, ctx.cache, his[:1], 4)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-4, atol=2e-5)


# ------------------------------------------------------- CLI end to end
@pytest.fixture(scope="module")
def cli_run(fixture_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ff_cli"))
    argv = ["train_fastformer", *_flags(fixture_dir), *_data_flags(fixture_dir),
            "--train_batch_size", "8", "--learning_rate", "1e-3",
            "--num_train_epochs", "1", "--gradient_accumulation_steps", "2",
            "--freeze_transformer", "--remat", "--logging_steps", "2",
            "--train_path", os.path.join(out, "train"), "--device", "cpu"]
    assert cli_main(argv) == 0
    (run_dir,) = glob.glob(os.path.join(out, "train", "*"))
    return out, run_dir


def test_cli_train_fastformer_then_eval_fastformer(cli_run, fixture_dir):
    """``train_fastformer`` writes the run dir and checkpoints (loss and
    metrics in eval.csv); ``eval_fastformer`` from ``bestAucModel``
    reproduces the run's best auc."""
    out, rd = cli_run
    rows = [r.split(",") for r in open(os.path.join(rd, "eval.csv")).read().splitlines()]
    assert rows[0] == ["epoch", "step", "loss", "auc", "group_auc", "mrr", "ndcg@5"]
    assert len(rows) == 2 and all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    for name in checkpoint.NAMES:
        assert os.path.isfile(os.path.join(rd, "ckpt", name)), name
    payload = checkpoint.load(os.path.join(rd, "ckpt", "finalModel"))
    assert any(k.startswith("fast_attn.layers.1.self_attn.") for k in payload["params"])
    argv = ["eval_fastformer", *_flags(fixture_dir), "--device", "cpu",
            "--eval_behaviors_path", os.path.join(fixture_dir, "behaviors.tsv"),
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--eval_path", os.path.join(out, "eval"),
            "--saved_model_path", os.path.join(rd, "ckpt", "bestAucModel")]
    assert cli_main(argv) == 0
    scores = Trainer(make_parser().parse_args(argv)).eval()
    best = max(float(r[3]) for r in rows[1:])
    np.testing.assert_allclose(scores["auc"], best, rtol=1e-6)


@pytest.mark.parametrize("candidates", [["N2", "N5", "N7", "N9"], None])
def test_cli_recommend_from_final_model(cli_run, fixture_dir, capsys, candidates):
    """A slate, and the whole corpus (no --candidates), ranked from the
    ``finalModel`` of ``train_fastformer``."""
    _, rd = cli_run
    argv = ["recommend", *_flags(fixture_dir), "--device", "cpu",
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--saved_model_path", os.path.join(rd, "ckpt", "finalModel"),
            "--user_history", "N1", "N3", "--topk", "3"]
    if candidates:
        argv += ["--candidates", *candidates]
    assert cli_main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    ids = [ln.split("\t")[0] for ln in lines]
    scores = [float(ln.split("\t")[1]) for ln in lines]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    assert set(ids) <= set(candidates or [f"N{i}" for i in range(12)])


# ------------------------------------------------------------- dropout
def test_dropout_is_a_function_of_seed_and_step(pair):
    """At --dropout 0.2 (the Fastformer's three sites, the news encoder's
    reduce_dim and the PLM's kernels' sites) the same (seed, micro-step)
    draws the same forward, another step another, eval() none."""
    _, tt, _, ts, batch = pair
    table = tt._make_table(ts)
    model = tt.build_model().train()
    assert model.fast_attn.cfg.hidden_dropout == 0.2
    with torch.no_grad():
        run = lambda step: tt._apply_and_loss(model, table, batch, True,
                                              DropoutRNG(8, step, "cpu"))[1]
        a, b, c = run(0), run(0), run(1)
        model.eval()
        d, e = run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)


def test_train_fastformer_config_parses_and_refusals(fixture_dir):
    """config/train_fastformer.txt, config/train_unbert.txt and
    config/train_unisrec.txt parse unchanged; train_fastformer runs train's
    refusals; UnBERT and UniSRec take their kinds (tests/test_torch_unbert.py,
    tests/test_torch_unisrec.py)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a = make_parser().parse_args(
        ["train_fastformer", "@" + os.path.join(repo, "config", "train_fastformer.txt")])
    assert (a.model_name, a.plm_preset, a.word_embed_dim, a.train_batch_size,
            a.gradient_accumulation_steps, a.dropout) == (
        "fastformer", "roberta_base", 256, 16, 8, 0.2)
    assert a.freeze_transformer and a.remat and a.compute_dtype == "bfloat16"
    with pytest.raises(NotImplementedError, match="cached-history training"):
        Trainer(make_parser().parse_args(
            ["train_fastformer", *_flags(fixture_dir), "--device", "cpu",
             "--his_cache_refresh", "2"]))
    u = make_parser().parse_args(
        ["train_fastformer", "@" + os.path.join(repo, "config", "train_unbert.txt")])
    assert (u.model_name, u.plm_preset, u.augmentation_mode, u.train_batch_size,
            u.gradient_accumulation_steps, u.npratio, u.unbert_news_mode) == (
        "unbert", "bert_base", "unbert", 16, 8, 4, "nseg")
    assert u.remat and u.compute_dtype == "bfloat16" and u.unbert_news_layers is None
    assert Trainer(make_parser().parse_args(
        ["eval_fastformer", *_flags(fixture_dir), "--device", "cpu",
         "--model_name", "unbert"])).kind == "unbert"
    s = make_parser().parse_args(
        ["train_fastformer", "@" + os.path.join(repo, "config", "train_unisrec.txt")])
    assert (s.model_name, s.plm_preset, s.combine_type, s.max_title_length,
            s.max_sapo_length, s.his_length, s.npratio, s.train_batch_size,
            s.learning_rate, s.dropout, s.compute_dtype) == (
        "unisrec", "bert_base", "pre-concat", 32, 128, 50, 4, 16, 1e-3, 0.2, "bfloat16")
    assert s.remat and not s.use_sapo and not s.unisrec_train_all
    assert Trainer(make_parser().parse_args(
        ["eval_fastformer", *_flags(fixture_dir), "--device", "cpu",
         "--model_name", "unisrec"])).kind == "vanilla"
