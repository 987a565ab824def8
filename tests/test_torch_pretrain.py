"""The port's pretraining, augmented training and warm starts against the
JAX package's.

The ``hard`` sampler mode and ``PretrainSampler`` must equal the JAX
package's numpy path array for array; the pretrain kind (the news encoder
alone, on ``pretrain_contrastive``) must take JAX's micro-steps on the same
batches from the same weights (float32, dropout 0: losses to 1e-5, the
parameters to Adam's amplified float32 noise), and
its eval total over a ragged last batch must equal JAX's. Then the chain
the shipped configs run, through the CLI on the CPU: ``pretrain``, a
``train`` in the hard mode warm-started from its ``finalModel`` at learning
rate 0 (the grafted encoder kept bit for bit), and ``recommend`` from the
persisted int8 cache; a whole-model warm start; a checkpoint that fits
neither refused; and the shipped configs parse and build a trainer.
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
from miner_tpu.data.batcher import Batcher as JaxBatcher
from miner_tpu.data.behaviors import BehaviorsLog as JaxLog
from miner_tpu.data.samplers import OfflineSampler as JaxOfflineSampler
from miner_tpu.data.samplers import OnlineSampler as JaxOnlineSampler
from miner_tpu.data.samplers import PretrainSampler as JaxPretrainSampler
from miner_tpu.observability.logging import RunLogger as JaxRunLogger
from miner_tpu.training.optim import make_optimizer
from miner_tpu.training.train_state import TrainState
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.cli import main as cli_main
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import OfflineSampler, OnlineSampler, PretrainSampler
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.observability.logging import RunLogger
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

AUGS = ("changed_topic_text", "enhanced_text")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs, as in
    tests/test_torch_training.py: six xdist workers share the CPU, and the
    PLM's plain Philox dropout is many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_pretrain")), num_lines=30,
                        augmentations=AUGS)


def _flags(fixture, *extra):
    """The tiny news encoder of tests/test_torch_training.py, float32."""
    return ["--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--apply_reduce_dim", "--use_sapo",
            "--word_embed_dim", "32", "--npratio", "3", "--compute_dtype", "float32",
            "--eval_batch_size", "16", *extra]


def _data(fixture, train=True):
    beh, news = (os.path.join(fixture, f) for f in ("behaviors.tsv", "news.tsv"))
    flags = ["--eval_behaviors_path", beh, "--eval_news_path", news]
    if train:
        flags += ["--train_behaviors_path", beh, "--train_news_path", news]
    return flags


MINER = ("--use_category_bias", "--category_embed_dim", "8", "--num_context_codes", "4",
         "--context_code_dim", "16", "--score_type", "weighted")


# --------------------------------------------------------------- samplers
@pytest.fixture(scope="module")
def stores(fixture_dir):
    """(JAX store and log, port store and log) with the augmented variants."""
    jt = JaxTrainer(jax_parser().parse_args(["train", *_flags(fixture_dir)]))
    tt = Trainer(make_parser().parse_args(["train", *_flags(fixture_dir), "--device", "cpu"]))
    beh, news = (os.path.join(fixture_dir, f) for f in ("behaviors.tsv", "news.tsv"))
    js, ts = jt._load_store(news, AUGS), tt._load_store(news, AUGS)
    assert ts.num_variants == js.num_variants == 3
    return (js, JaxLog.from_tsv(beh, js, jt.user2id, 5)), (ts, tt._load_log(beh, ts))


@pytest.mark.parametrize("which", ["hard_online", "hard_offline", "pretrain",
                                   "hard_online-native", "hard_offline-native"])
def test_hard_and_pretrain_samplers_match_jax_numpy_path(stores, which):
    """Two epochs of blocks, and their shuffled batches, equal to the JAX
    package's array for array on the same path: numpy (``backend="numpy"``;
    the pretrain sampler has no other), and for the hard mode over V = 3
    variants the two copies of the native C++ sampler (``-native``)."""
    (js, jlog), (ts, tlog) = stores
    if which == "pretrain":
        jsam, tsam = JaxPretrainSampler(jlog, js, 3, seed=7), PretrainSampler(tlog, ts, 3, seed=7)
    else:
        backend = "native" if which.endswith("-native") else "numpy"
        jcls, tcls = ((JaxOnlineSampler, OnlineSampler) if which.startswith("hard_online")
                      else (JaxOfflineSampler, OfflineSampler))
        jsam = jcls(jlog, js, 3, seed=7, mode="hard", backend=backend)
        tsam = tcls(tlog, ts, 3, seed=7, mode="hard", backend=backend)
    for epoch in (0, 1):
        jb, tb = jsam.sample_epoch(epoch), tsam.sample_epoch(epoch)
        for f in ("cand", "his", "label", "impression_id"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
        pairs = list(zip(JaxBatcher(6, shuffle=True, seed=7).batches(jb, epoch),
                         Batcher(6, shuffle=True, seed=7).batches(tb, epoch)))
        assert pairs
        for a, b in pairs:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])
    if which == "pretrain":  # the positive, its two variants, 3 negatives
        assert tb.cand.shape[1] == 6 and (tb.cand[:, :3] // ts.num_news == [0, 1, 2]).all()
    else:  # variants of the positive beside the negatives
        assert (tb.cand >= ts.num_news).any()


# ------------------------------------------------- micro-steps vs JAX
N_STEPS, ACCUM, TOTAL, WARMUP = 12, 2, 6, 1


@pytest.fixture(scope="module")
def pretrained(fixture_dir, tmp_path_factory):
    """Both packages pretrain the same tiny news encoder (float32, dropout
    0) for 12 micro-steps at accumulation 2, with a clip that triggers, on
    the same batches."""
    flags = [*_flags(fixture_dir), *_data(fixture_dir), "--augmentations", *AUGS,
             "--dropout", "0", "--gradient_accumulation_steps", str(ACCUM),
             "--max_grad_norm", "0.05", "--learning_rate", "2e-3", "--weight_decay", "0.05",
             "--train_batch_size", "8"]
    jt = JaxTrainer(jax_parser().parse_args(["pretrain", *flags]))
    tt = Trainer(make_parser().parse_args(["pretrain", "--model_name", "Miner", *flags,
                                           "--device", "cpu"]))
    assert jt.model_name == tt.kind == "pretrain"
    news = os.path.join(fixture_dir, "news.tsv")
    js, ts = jt._load_store(news, AUGS), tt._load_store(news, AUGS)
    jt._num_augs = tt._num_augs = ts.num_variants - 1
    tlog = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts)
    sampler = PretrainSampler(tlog, ts, 3, seed=7)
    batcher = Batcher(8, drop_last=True, shuffle=True, seed=7)
    batches = [b for epoch in range(3) for b in batcher.batches(sampler.sample_epoch(epoch), epoch)]
    assert len(batches) >= N_STEPS

    jmodel, kind = jt.build_model(js)
    assert kind == "pretrain"
    plm = dc.replace(jmodel.plm_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    jmodel = jmodel.clone(plm_cfg=plm)
    example = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = jt._init_params_for_kind(jmodel, kind, jt._host_table(js), example)
    jtable = jt._make_table(js)
    tx = make_optimizer(params, learning_rate=2e-3, total_steps=TOTAL, warmup_steps=WARMUP,
                        weight_decay=0.05, max_grad_norm=0.05, accum_steps=ACCUM)
    from miner_tpu.parallel.sharding import replicate_tree, shard_batch

    state = replicate_tree(jt.mesh, TrainState.create(params, tx, jax.random.PRNGKey(8)))
    step = jt._make_train_step(jmodel, kind, jtable)

    model = tt.build_model()
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
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
    return dict(jt=jt, tt=tt, jmodel=jmodel, state=state, jtable=jtable, model=model,
                ttable=ttable, js=js, ts=ts, tlog=tlog, jax_losses=jax_l, port_losses=port_l,
                out=str(tmp_path_factory.mktemp("pretrain_eval")))


def test_pretrain_micro_steps_match_jax(pretrained):
    """Losses to 1e-5 (float32 summation order) and the parameters to 5e-4
    absolute after 6 updates: Adam normalises each gradient element, so an
    element whose gradient is near zero moves by up to lr (2e-3) an update
    whatever its rounding, 1.2e-2 in all; measured 1.9e-4 on 2 of 8,192
    elements of one matrix (1.0e-4 at lr 1e-3: it scales with lr, as that
    noise does), every other element within 1e-4. The bare JAX
    ``NewsEncoder`` tree converts to the port's encoder state dict."""
    np.testing.assert_allclose(pretrained["port_losses"], pretrained["jax_losses"],
                               rtol=1e-5, atol=1e-5)
    assert pretrained["jax_losses"][0] != pretrained["jax_losses"][-1]
    want = params_from_jax(jax.device_get(pretrained["state"].params))
    got = pretrained["model"].state_dict()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=5e-4,
                                   err_msg=k)


def test_pretrain_eval_total_matches_jax(pretrained):
    """The contrastive loss summed over the eval behaviors in batches of 16,
    the last one ragged (its padded rows masked), from the same final
    weights' conversion: float32 noise (1e-5)."""
    jt, tt = pretrained["jt"], pretrained["tt"]
    jlog = JaxLog.from_tsv(jt.args.eval_behaviors_path, pretrained["js"], jt.user2id, 5)
    jblock = JaxPretrainSampler(jlog, pretrained["js"], 3, seed=7).sample_epoch(0)
    tblock = PretrainSampler(pretrained["tlog"], pretrained["ts"], 3, seed=7).sample_epoch(0)
    assert len(tblock) % 16 != 0
    params = pretrained["state"].params
    want = jt._run_pretrain_eval(
        jt._make_pretrain_eval_step(pretrained["jmodel"], pretrained["jtable"], 2), params,
        jblock, JaxRunLogger(os.path.join(pretrained["out"], "jax"), "eval"), 0, 0)
    model = tt.build_model()
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    got = tt._run_pretrain_eval(model, pretrained["ttable"], tblock, 2,
                                RunLogger(os.path.join(pretrained["out"], "port"), "eval"),
                                0, 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------- the chain through the CLI
@pytest.fixture(scope="module")
def chain(fixture_dir, tmp_path_factory):
    """``pretrain``, then a hard-mode ``train`` warm-started from its
    ``finalModel`` at learning rate 0, then ``recommend`` twice from a
    persisted int8 cache: the CLI on the CPU, with dropout on."""
    out = str(tmp_path_factory.mktemp("torch_chain"))
    assert cli_main(["pretrain", *_flags(fixture_dir), *_data(fixture_dir),
                     "--augmentations", *AUGS, "--train_batch_size", "8",
                     "--evaluation_info", "loss", "metrics", "--logging_steps", "2",
                     "--train_path", os.path.join(out, "pretrain"), "--device", "cpu"]) == 0
    (pre,) = glob.glob(os.path.join(out, "pretrain", "*"))
    assert cli_main(["train", *_flags(fixture_dir), *MINER, *_data(fixture_dir),
                     "--augmentations", *AUGS, "--augmentation_mode", "hard",
                     "--train_batch_size", "8", "--learning_rate", "0",
                     "--pretrained_model_path", os.path.join(pre, "ckpt", "finalModel"),
                     "--train_path", os.path.join(out, "train"), "--device", "cpu"]) == 0
    (run,) = glob.glob(os.path.join(out, "train", "*"))
    cache = os.path.join(out, "serve_cache.npz")
    served = [cli_main(["recommend", *_flags(fixture_dir), *MINER, *_data(fixture_dir, False),
                        "--saved_model_path", os.path.join(run, "ckpt", "finalModel"),
                        "--serve_cache_path", cache, "--serve_cache_int8", "--user_history",
                        "N1", "N3", "--topk", "4", "--device", "cpu"]) for _ in range(2)]
    return pre, run, cache, served


def test_pretrain_cli_writes_its_loss_and_best_loss_model(chain):
    """eval.csv has the loss and no ranking metric (asked for, they are
    ignored with a warning); bestLossModel and finalModel, no bestAucModel."""
    pre = chain[0]
    rows = open(os.path.join(pre, "eval.csv")).read().splitlines()
    assert rows[0] == "epoch,step,loss" and len(rows) == 2
    assert np.isfinite(float(rows[1].split(",")[2]))
    assert sorted(os.listdir(os.path.join(pre, "ckpt"))) == ["bestLossModel", "finalModel"]
    assert "has no effect for pretrain" in open(os.path.join(pre, "log", "all.log")).read()
    params = checkpoint.load(os.path.join(pre, "ckpt", "finalModel"))["params"]
    assert not any(k.startswith("news_encoder.") for k in params)  # the encoder alone


def test_warm_start_at_lr0_keeps_the_grafted_encoder(chain):
    pre, run = chain[:2]
    enc = checkpoint.load(os.path.join(pre, "ckpt", "finalModel"))["params"]
    miner = checkpoint.load(os.path.join(run, "ckpt", "finalModel"))["params"]
    assert {f"news_encoder.{k}" for k in enc} < set(miner)
    for k, v in enc.items():
        assert torch.equal(miner[f"news_encoder.{k}"], v), k
    assert "warm-started news_encoder" in open(os.path.join(run, "log", "all.log")).read()


def test_recommend_from_the_persisted_int8_cache(chain, capsys):
    """Both ``recommend`` runs rank from the same int8 cache: the first
    writes it, the second reads it."""
    cache, served = chain[2:]
    assert served == [0, 0] and os.path.exists(cache)
    with np.load(cache) as z:
        meta = bytes(z["meta"]).decode()
        assert z["embeddings"].dtype == np.int8 and '"serve_cache_int8": true' in meta


def test_standalone_pretrain_eval_returns_the_loss(chain, fixture_dir, tmp_path):
    pre = chain[0]
    scores = Trainer(make_parser().parse_args(
        ["eval", *_flags(fixture_dir), *_data(fixture_dir, False), "--model_name", "pretrain",
         "--saved_model_path", os.path.join(pre, "ckpt", "finalModel"),
         "--eval_path", str(tmp_path), "--device", "cpu"])).eval()
    assert list(scores) == ["loss"] and np.isfinite(scores["loss"])


def _miner_trainer(fixture_dir, *extra):
    return Trainer(make_parser().parse_args(
        ["train", *_flags(fixture_dir), *MINER, *_data(fixture_dir), "--device", "cpu",
         *extra]))


def test_whole_model_warm_start_loads_every_parameter(chain, fixture_dir):
    run = chain[1]
    path = os.path.join(run, "ckpt", "finalModel")
    tt = _miner_trainer(fixture_dir, "--pretrained_model_path", path, "--seed", "8")
    model = tt.build_model()
    tt._warm_start(model, path, RunLogger(os.path.join(run, "again"), "train").logger)
    want = checkpoint.load(path)["params"]
    got = model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_warm_start_refuses_a_checkpoint_that_fits_neither(fixture_dir, tmp_path):
    tt = _miner_trainer(fixture_dir)
    model = tt.build_model()
    path = str(tmp_path / "other")
    params = dict(model.state_dict())
    params.pop("poly_attn.context_codes")
    params["extra.weight"] = torch.zeros(1)
    checkpoint.save(path, {"params": params})
    log = RunLogger(str(tmp_path / "run"), "train").logger
    with pytest.raises(ValueError, match=r"missing \['poly_attn.context_codes'\], "
                                         r"unexpected \['extra.weight'\]"):
        tt._warm_start(model, path, log)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        tt._warm_start(model, str(tmp_path / "orbax"), log)


@pytest.mark.parametrize("mode, config", [
    ("pretrain", "pretrain_miner.txt"), ("train", "train_miner_aug_online.txt"),
    ("train", "train_miner_hard.txt")])
def test_shipped_configs_parse_and_build_a_trainer(fixture_dir, mode, config):
    """The configs of the pretrain -> finetune chain as they ship: the
    pretrain subcommand takes the pretrain kind whatever --model_name says,
    the augmentations and the hard mode are taken, nothing is refused."""
    args = make_parser().parse_args(
        [mode, "@" + os.path.join(REPO, "config", config), "--device", "cpu",
         "--user2id_path", os.path.join(fixture_dir, "user2id.json"),
         "--category2id_path", os.path.join(fixture_dir, "category2id.json")])
    tt = Trainer(args)
    assert args.plm_preset == "roberta_base" and args.compute_dtype == "bfloat16" and args.remat
    if mode == "pretrain":
        assert tt.kind == "pretrain" and args.augmentations == [*AUGS[:1], AUGS[1],
                                                                  "semi_enhanced_text"]
        assert args.train_batch_size == 16 and args.evaluation_info == ["loss"]
        forced = Trainer(make_parser().parse_args(
            [mode, "@" + os.path.join(REPO, "config", config), "--device", "cpu",
             "--model_name", "Miner", "--user2id_path", args.user2id_path,
             "--category2id_path", args.category2id_path]))
        assert forced.kind == "pretrain"
    else:
        assert tt.kind == "miner" and args.augmentations == list(AUGS)
        assert args.augmentation_mode == ("hard" if "hard" in config else "base")
