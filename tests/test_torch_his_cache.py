"""The port's cached-history training (``--his_cache_refresh``) against the
JAX package's.

With a fresh cache, the candidates' encoding + the history rows gathered
from the cache + the tail equals the full forward, the port's and JAX's
(the port's counterpart of ``tests/test_his_cache.py``); both trainers'
``train()`` run twenty micro-steps of the tiny Miner, Fastformer and UniSRec
under ``--his_cache_refresh 2 --his_cache_warmup_steps 1
--gradient_accumulation_steps 2`` on the same batches from the same weights:
the same losses, the same micro-steps on the full history and on the cache,
the cache rebuilt at the same micro-steps, the same final parameters; so
after a ``--resume_from`` in the middle of a refresh interval; the warmup
micro-steps bit-equal to a plain run of the port, with dropout on; UnBERT
and the pretrain kind warn and train as usual.

Float32 with every dropout at 0 unless a test says otherwise: ``--dropout
0``, and the PLM's and UniSRec's SASRec rates (config fields, not flags)
zeroed by patching the config functions of both packages. Both trainers
build their samplers at their defaults (``backend="auto"``: the native C++
sampler of each package where g++ builds it, numpy on both where it does
not), so the two draw the same epochs either way. The
UniSRec gating noise is one numpy array a shape on both sides, patched
into ``jax.random.normal`` and ``DropoutRNG.normal``.
"""
import dataclasses as dc
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import miner_tpu.models.unisrec as jax_unisrec
import miner_tpu.training.trainer as jax_trainer
import miner_tpu_torch.models.unisrec as port_unisrec
import miner_tpu_torch.training.trainer as port_trainer
from miner_tpu.config import make_parser as jax_parser
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import OnlineSampler
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import HistoryCache, Trainer
from tests.fixture_data import make_fixture

T = torch.from_numpy
HIS, NPRATIO, BATCH, EXPERTS = 5, 3, 8, 8


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


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_his_cache")), num_lines=40)


def _common(fixture):
    return ["--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--max_title_length", "16", "--max_sapo_length", "24",
            "--his_length", str(HIS), "--seed", "7", "--plm_preset", "tiny",
            "--npratio", str(NPRATIO), "--eval_batch_size", "16",
            "--compute_dtype", "float32", "--metrics", "auc"]


# the tiny models of tests/test_torch_training.py, test_torch_fastformer.py
# (its towers frozen, as train_fastformer.txt ships) and test_torch_unisrec.py
FAMILIES = {
    "Miner": ("train", ["--model_name", "Miner", "--apply_reduce_dim", "--use_sapo",
                        "--use_category_bias", "--word_embed_dim", "32",
                        "--category_embed_dim", "8", "--num_context_codes", "4",
                        "--context_code_dim", "16", "--score_type", "weighted"]),
    "fastformer": ("train_fastformer", ["--model_name", "fastformer", "--apply_reduce_dim",
                                        "--use_sapo", "--word_embed_dim", "32",
                                        "--freeze_transformer"]),
    "unisrec": ("train_fastformer", ["--model_name", "unisrec", "--combine_type",
                                     "pre-concat"]),
}
CACHED = ("--his_cache_refresh", "2", "--his_cache_warmup_steps", "1")
ACCUM, EPOCHS = 2, 2  # 10 micro-batches of 8 an epoch: 20 micro-steps, 10 updates
# JAX's rule (trainer.py:759-766) at warmup 1 x 2 and refresh 2 x 2
# micro-steps: full history at 0-1, the cache built at 2 and rebuilt at every
# multiple of 4
JAX_RULE_FILLS = [2, 4, 8, 12, 16]


def _flags(fixture, family, *extra):
    mode, flags = FAMILIES[family]
    return [mode, *_common(fixture), *flags, *extra]


def _no_dropout_cfg(make):
    return lambda *a, **k: dc.replace(make(*a, **k), hidden_dropout=0.0,
                                      attention_dropout=0.0)


def _noise():
    """UniSRec's gating noise by shape: a full-history micro-batch's
    B x (C + H) news, a cached one's B x C candidates."""
    rng = np.random.default_rng(11)
    return {(n, EXPERTS): rng.normal(size=(n, EXPERTS)).astype(np.float32)
            for n in (BATCH * (NPRATIO + 1 + HIS), BATCH * (NPRATIO + 1))}


@pytest.fixture
def no_dropout(monkeypatch):
    """Every dropout rate of both packages at 0, the UniSRec gating noise
    substituted."""
    noise = _noise()
    normal = jax.random.normal

    def jax_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) in noise:
            return jnp.asarray(noise[tuple(shape)], dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax_trainer, "plm_config", _no_dropout_cfg(jax_trainer.plm_config))
    monkeypatch.setattr(port_trainer, "plm_config", _no_dropout_cfg(port_trainer.plm_config))
    for module in (jax_unisrec, port_unisrec):
        monkeypatch.setattr(module, "sasrec_encoder_cfg",
                            _no_dropout_cfg(module.sasrec_encoder_cfg))
    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(DropoutRNG, "normal",
                        lambda self, shape, dtype: T(noise[tuple(shape)]).to(dtype))


def _initial_params(jt, store, family):
    """JAX's initial parameters from the seed (as its ``train()`` makes
    them); UniSRec's adaptor gates and expert biases, zero at init,
    randomised so that the gating is exercised."""
    model, kind = jt.build_model(store)
    example = {"cand_idx": jnp.zeros((BATCH, NPRATIO + 1), jnp.int32),
               "his_idx": jnp.zeros((BATCH, HIS), jnp.int32)}
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jt._init_params_for_kind(model, kind, jt._host_table(store), example)))
    if family == "unisrec":
        rng = np.random.default_rng(5)
        moe = params["news_encoder"]["moe_adaptor"]
        for name in ("w_gate", "w_noise"):
            moe[name] = (rng.normal(size=moe[name].shape) * 0.3).astype(np.float32)
        moe["experts"]["bias"] = (rng.normal(size=moe["experts"]["bias"].shape) * 0.3
                                  ).astype(np.float32)
    return params


def _record_jax(jt, events):
    """JAX's trainer with its step functions and its cache builder
    recording, in order, ("full" | "cached", loss) per micro-step and
    ("fill", None) per cache build; its sampler on the numpy path."""
    def recording(make, tag):
        def make_(*a, **k):
            step = make(*a, **k)

            def run(*args):
                state, loss = step(*args)
                events.append((tag, float(loss)))
                return state, loss
            return run
        return make_

    build = jt._build_eval_cache

    def build_(*a, **k):
        events.append(("fill", None))
        return build(*a, **k)

    jt._make_train_step = recording(jt._make_train_step, "full")
    jt._make_cached_his_train_step = recording(jt._make_cached_his_train_step, "cached")
    jt._build_eval_cache = build_


def _jax_run(events):
    """(tags, losses, fills) of a recorded JAX run: the micro-steps' kinds
    and losses, and the micro-step (counted from the run's first) before
    which each cache build came."""
    tags, losses, fills = [], [], []
    for tag, loss in events:
        if tag == "fill":
            fills.append(len(tags))
        else:
            tags.append(tag)
            losses.append(loss)
    return tags, losses, fills


def train_both(fixture, out, family, *extra, params=None, resume=None):
    """Both trainers' ``train()`` on the same flags (``extra`` appended),
    from the same weights (``params``, a JAX tree, default JAX's initial
    ones; the port warm-starts from them) or resumed from ``resume`` (the
    JAX and port run directories of an earlier call). Returns JAX's and the
    port's micro-step kinds, losses, cache builds (micro-steps, from the
    run's first) and final parameters (a port state dict), and both run
    directories."""
    common = [*_flags(fixture, family, "--dropout", "0", "--gradient_accumulation_steps",
                      str(ACCUM), "--max_grad_norm", "0.05", "--learning_rate", "2e-3",
                      "--weight_decay", "0.05", "--warmup_steps", "2",
                      "--train_batch_size", str(BATCH),
                      "--logging_steps", "100", "--num_train_epochs", str(EPOCHS),
                      "--train_behaviors_path", os.path.join(fixture, "behaviors.tsv"),
                      "--train_news_path", os.path.join(fixture, "news.tsv")), *extra]
    jax_extra, port_extra = [], []
    if resume:
        jax_extra = ["--resume_from", os.path.join(resume[0], "ckpt", "finalModel")]
        port_extra = ["--resume_from", os.path.join(resume[1], "ckpt", "finalModel")]
    jt = jax_trainer.Trainer(jax_parser().parse_args(
        [*common, "--train_path", os.path.join(out, "jax"), *jax_extra]))
    if params is None:
        params = _initial_params(jt, jt._load_store(jt.args.train_news_path), family)
    jt._init_params_for_kind = lambda *a, **k: jax.tree_util.tree_map(jnp.asarray, params)
    events = []
    _record_jax(jt, events)
    state = jt.train()
    tags, losses, fills = _jax_run(events)

    init = os.path.join(out, "port_init.pt")
    checkpoint.save(init, {"params": params_from_jax(params)})
    tt = Trainer(make_parser().parse_args(
        [*common, "--device", "cpu", "--train_path", os.path.join(out, "port"),
         "--pretrained_model_path", init, *port_extra]))
    caches, port_losses = [], []
    make_cache, train_step = tt.make_history_cache, tt.train_step
    tt.make_history_cache = lambda *a: caches.append(make_cache(*a)) or caches[-1]

    def recorded_step(*a):
        loss = train_step(*a)
        port_losses.append(float(loss))
        return loss

    tt.train_step = recorded_step
    run = tt.train()
    (cache,) = caches
    start = run.step - len(port_losses)
    port_tags = ["cached" if cache and cache.cached(start + i) else "full"
                 for i in range(len(port_losses))]
    (jax_dir,) = glob.glob(os.path.join(out, "jax", "*"))
    return dict(jax_tags=tags, jax_losses=losses, jax_fills=fills,
                jax_tree=jax.device_get(state.params),
                jax_params=params_from_jax(jax.device_get(state.params)),
                port_tags=port_tags, port_losses=port_losses,
                port_fills=[s - start for s in (cache.fills if cache else [])],
                port_params=run.model.state_dict(), start=start, initial=params,
                dirs=(jax_dir, run.run_dir))


def assert_runs_match(r, loss_rtol=1e-5, param_atol=1e-4):
    """The same micro-step kinds and cache builds; losses to ``loss_rtol``
    (float32 summation order) and final parameters to ``param_atol``
    absolute (Adam moves an element whose gradient is near zero by up to
    lr = 2e-3 an update whatever its rounding: 1e-4 is 0.5% of what ten
    updates can move it)."""
    assert r["port_tags"] == r["jax_tags"]
    assert r["port_fills"] == r["jax_fills"]
    np.testing.assert_allclose(r["port_losses"], r["jax_losses"], rtol=loss_rtol, atol=1e-5)
    assert r["jax_losses"][0] != r["jax_losses"][-1]
    want, got = r["jax_params"], r["port_params"]
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=param_atol, err_msg=k)


# ------------------------------------------------ the cached forward
def _pair(fixture, family):
    jt = jax_trainer.Trainer(jax_parser().parse_args(_flags(fixture, family)))
    tt = Trainer(make_parser().parse_args([*_flags(fixture, family), "--device", "cpu"]))
    news = os.path.join(fixture, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    tlog = tt._load_log(os.path.join(fixture, "behaviors.tsv"), ts)
    batch = next(Batcher(BATCH).batches(OnlineSampler(tlog, ts, NPRATIO, seed=7).sample_epoch(0)))
    return jt, tt, js, ts, batch


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cached_forward_equals_the_full_forward(fixture_dir, family, no_dropout):
    """Eval mode, a cache fresh from the weights: the cached micro-batch's
    logits (``_cached_his_loss``: the candidates through the encoder, the
    history rows from ``fill_history_cache``, the tail) equal the port's
    full forward and JAX's (float32 summation order: 1e-5 of the logits'
    scale), and its loss the full one's."""
    jt, tt, js, ts, batch = _pair(fixture_dir, family)
    jmodel, kind = jt.build_model(js)
    params = _initial_params(jt, js, family)
    jtable = jt._make_table(js)
    out = jax.jit(lambda p, c, h: jmodel.apply({"params": p}, jtable.lookup(c, h)))(
        params, jnp.asarray(batch["cand_idx"]), jnp.asarray(batch["his_idx"]))
    want = np.asarray(out[1] if kind == "miner" else out)
    model = tt.build_model()
    model.load_state_dict(params_from_jax(params), strict=True)
    model.eval()
    ttable = tt._make_table(ts)
    with torch.no_grad():
        full_loss, full = tt._apply_and_loss(model, ttable, batch)
        emb = tt.fill_history_cache(model, ttable)
        assert not model.training and emb.shape[0] == ts.num_news
        loss, cached = tt._cached_his_loss(model, ttable, batch, emb)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(full.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(cached.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(cached.numpy(), full.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(float(loss), float(full_loss), rtol=1e-5)


# --------------------------------------------- twenty micro-steps vs JAX
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_twenty_cached_micro_steps_match_jax(fixture_dir, tmp_path, family, no_dropout):
    """Twenty micro-steps (two epochs of ten) under --his_cache_refresh 2
    --his_cache_warmup_steps 1 at accumulation 2: the first two on the full
    history, the rest on the cache, built at micro-steps 2, 4, 8, 12 and
    16 (JAX's rule) in both packages, the same losses and final weights.
    UniSRec trains its adaptor alone; the Fastformer's towers are frozen.
    UniSRec's losses are held to 1e-4 relative, not 1e-5: its logits reach
    the tens after a few adaptor updates, and turn its parameters' float32
    noise (8e-7 absolute after the ten updates, measured) into up to 5e-5
    of the loss, as much with the cache as in the same loops without it;
    at learning rate 0 its losses agree to 1.6e-6 (measured)."""
    r = train_both(fixture_dir, str(tmp_path), family, *CACHED)
    assert r["jax_fills"] == JAX_RULE_FILLS
    assert r["jax_tags"] == ["full"] * 2 + ["cached"] * 18
    assert_runs_match(r, 1e-4 if family == "unisrec" else 1e-5)


def test_refills_after_a_mid_interval_resume_match_jax(fixture_dir, tmp_path, no_dropout):
    """The Miner for one epoch (micro-steps 0-9, cache built at 2, 4, 8),
    then --resume_from its finalModel for the second: both packages start
    the resumed run without a cache, build it at micro-step 10 (mid-way
    through the interval 8-11) and rebuild it at 12 and 16; the resumed
    runs' losses agree as above, and their final weights to 2e-4: each
    package resumes from its own first run's checkpoint, and the two
    already differ by up to 1e-4 (the first runs' agreement), to which the
    second epoch adds its own."""
    first = train_both(fixture_dir, str(tmp_path / "first"), "Miner", *CACHED,
                       "--num_train_epochs", "1")
    assert first["jax_fills"] == first["port_fills"] == [2, 4, 8]
    assert_runs_match(first)
    resumed = train_both(fixture_dir, str(tmp_path / "resumed"), "Miner", *CACHED,
                         params=first["initial"], resume=first["dirs"])
    assert resumed["start"] == 10
    assert [resumed["start"] + s for s in resumed["jax_fills"]] == [10, 12, 16]
    assert resumed["jax_tags"] == ["cached"] * 10
    assert_runs_match(resumed, param_atol=2e-4)


# ------------------------------------------------------ port-only checks
def test_warmup_micro_steps_are_bit_equal_to_a_plain_run(fixture_dir):
    """With dropout on (0.2, and the PLM's 0.1) and accumulation 2: the two
    warmup micro-steps of --his_cache_refresh 2 --his_cache_warmup_steps 1
    give a plain run's losses and weights bit for bit; the third builds the
    cache first, without touching the model's mode or the micro-step's
    dropout stream (its loss equals the cached loss of a copy of the model
    with the cache built beforehand), and differs from the plain run's."""
    args = make_parser().parse_args([
        *_flags(fixture_dir, "Miner", "--device", "cpu", "--dropout", "0.2",
                "--gradient_accumulation_steps", "2", "--learning_rate", "1e-3")])
    tt = Trainer(args)
    store = tt._load_store(os.path.join(fixture_dir, "news.tsv"))
    log = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), store)
    batches = list(Batcher(BATCH).batches(OnlineSampler(log, store, NPRATIO, seed=7)
                                          .sample_epoch(0)))[:3]
    table = tt._make_table(store)
    runs = []
    for cache in (None, HistoryCache(2, 1, 2)):
        model = tt.build_model().train()
        opt = tt.make_optimizer(model, 4, 0)
        losses = [tt.train_step(model, table, batches[i], opt, i, cache) for i in range(2)]
        runs.append((model, opt, cache, losses))
    (plain, plain_opt, _, plain_l), (model, opt, cache, cached_l) = runs
    assert opt.updates == plain_opt.updates == 1 and cache.fills == []
    assert all(torch.equal(a, b) for a, b in zip(plain_l, cached_l))
    for (k, v), w in zip(model.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(v, w), k
    twin = tt.build_model()
    twin.load_state_dict(model.state_dict())
    twin.train()
    emb = tt.fill_history_cache(twin, table)
    want, _ = tt._cached_his_loss(twin, table, batches[2], emb,
                                  DropoutRNG(args.seed + 1, 2, "cpu"))
    got = tt.train_step(model, table, batches[2], opt, 2, cache)
    assert cache.fills == [2] and model.training and twin.training
    assert torch.equal(got, want.detach())
    assert not torch.equal(got, tt.train_step(plain, table, batches[2], plain_opt, 2))


@pytest.mark.parametrize("mode, family, extra", [
    ("train_fastformer", "unbert", ()),
    ("pretrain", "pretrain", ()),
    ("train", "Miner", ("--his_cache_refresh", "0")),
])
def test_kinds_without_a_cache_warn_and_train(fixture_dir, tmp_path, monkeypatch, mode,
                                              family, extra):
    """UnBERT and the pretrain kind with --his_cache_refresh 2, and the
    Miner with --his_cache_warmup_steps 1 and no refresh, log JAX's
    warnings (trainer.py:694-700) and train one epoch as usual, every
    micro-step on the full path."""
    monkeypatch.setattr(port_trainer, "plm_config", _no_dropout_cfg(port_trainer.plm_config))
    flags = ["--model_name", family, "--apply_reduce_dim", "--use_sapo",
             "--word_embed_dim", "32"]
    refresh = ("--his_cache_refresh", "2") if not extra else extra
    argv = [mode, *_common(fixture_dir), *flags, "--device", "cpu", "--dropout", "0",
            "--train_batch_size", "16", "--num_train_epochs", "1", "--max_sapo_length", "8",
            "--his_cache_warmup_steps", "1", *refresh,
            "--train_behaviors_path", os.path.join(fixture_dir, "behaviors.tsv"),
            "--train_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--train_path", str(tmp_path)]
    tt = Trainer(make_parser().parse_args(argv))
    cached = []
    train_step = tt.train_step
    tt.train_step = lambda *a: cached.append(a[5]) or train_step(*a)
    run = tt.train()
    assert run.step == len(cached) > 0 and cached == [None] * run.step
    text = open(os.path.join(run.run_dir, "log", "all.log")).read()
    want = ("--his_cache_warmup_steps has no effect without --his_cache_refresh" if extra
            else f"--his_cache_refresh ignored for model kind {tt.kind!r}")
    assert want in text
