"""The port's UniSRec family against the JAX package's.

The MoE adaptor and ``NewsEncoderMoe`` (eval mode, and in training mode with
the gating noise substituted), the carry-over of the rank-3 expert kernel;
the pre-concat table through ``NewsEncoder`` and ``NewsEncoderMoe``;
``UniSRec.tail`` and ``forward`` under both history layouts, with a
no-click user, a legacy-layout short history (the fully masked position-0
row) and two clicks-first histories that differ only past slot 0; bf16
compute with the tail in float32; 20 training micro-steps of both trainers
under the MoE-only freeze and under ``--unisrec_train_all``, the cached
eval after them, ``serve_scores`` and ``serve_topk``; the CLI end to end
(``train_fastformer``, ``eval_fastformer``, ``recommend``). Float32 with
dropout off unless a test says otherwise; each tolerance is stated where it
is used.

The gating noise of training mode is drawn by JAX from its "gating" stream
and by the port from ``DropoutRNG.normal``: the training comparisons
substitute one numpy array for both, by patching ``jax.random.normal`` for
the (N, experts) draw while JAX's step is traced, and ``DropoutRNG.normal``.
"""
import dataclasses as dc
import glob
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import miner_tpu.models.unisrec as jax_unisrec
import miner_tpu_torch.models.unisrec as port_unisrec
import miner_tpu_torch.training.trainer as port_trainer
from miner_tpu.config import make_parser as jax_parser
from miner_tpu.models.news_encoder import MoEAdaptor as JaxMoEAdaptor
from miner_tpu.observability.logging import RunLogger as JaxRunLogger
from miner_tpu.training.optim import make_optimizer
from miner_tpu.training.train_state import TrainState
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.cli import main as cli_main
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import OnlineSampler
from miner_tpu_torch.models import MoEAdaptor, NewsEncoderMoe, UniSRec
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.observability.logging import RunLogger
from miner_tpu_torch.serving import history_row
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

T = torch.from_numpy
HIS, EXPERTS = 5, 8


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: the tier-1 suite runs
    six xdist workers on one CPU, where each worker's intra-op threads
    oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags(fixture, *extra):
    """The tiny UniSRec: a 64-wide PLM over pre-concatenated titles (16 +
    24 - 1 = 39 tokens), the 8-expert adaptor to 300, the SASRec tail of 2
    heads of 150 over 5 history slots; float32."""
    return [
        "--model_name", "unisrec", "--pretrained_tokenizer", "hash:1000",
        "--user2id_path", os.path.join(fixture, "user2id.json"),
        "--category2id_path", os.path.join(fixture, "category2id.json"),
        "--max_title_length", "16", "--max_sapo_length", "24",
        "--his_length", str(HIS), "--seed", "7", "--plm_preset", "tiny",
        "--combine_type", "pre-concat", "--npratio", "3", "--eval_batch_size", "16",
        "--compute_dtype", "float32", "--metrics", "auc", "group_auc", "mrr", "ndcg@5",
        *extra]


def _data_flags(fixture):
    beh, news = (os.path.join(fixture, f) for f in ("behaviors.tsv", "news.tsv"))
    return ["--train_behaviors_path", beh, "--train_news_path", news,
            "--eval_behaviors_path", beh, "--eval_news_path", news]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_unisrec")), num_lines=40)


def _randomize_moe(params, rng):
    """Non-zero gates and expert biases (JAX initialises them to zero), so
    that the gating and the whitening shift are exercised."""
    p = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    moe = p
    for key in ("news_encoder", "moe_adaptor"):  # a UniSRec, encoder or adaptor tree
        moe = moe.get(key, moe)
    for name in ("w_gate", "w_noise"):
        moe[name] = (rng.normal(size=moe[name].shape) * 0.3).astype(np.float32)
    moe["experts"]["bias"] = (rng.normal(size=moe["experts"]["bias"].shape) * 0.3
                              ).astype(np.float32)
    return p


# ---------------------------------------------------------------- adaptor
@pytest.mark.parametrize("train", [False, True])
def test_moe_adaptor_matches_jax(rng, train):
    """``MoEAdaptor`` on carried-over weights, loaded strictly: the rank-3
    (E, D_in, D_out) expert kernel keeps its name and axis order through
    ``params_from_jax``. In eval mode, and in training mode (dropout 0) with
    the same gating noise substituted on both sides (float32, 1e-5)."""
    x = rng.normal(size=(6, 40)).astype(np.float32)
    jmodel = JaxMoEAdaptor(n_experts=EXPERTS, out_dim=24, dropout=0.0)
    params = _randomize_moe(jmodel.init(jax.random.PRNGKey(0), x)["params"], rng)
    state = params_from_jax(params)
    assert state["experts.kernel"].shape == (EXPERTS, 40, 24)
    assert state["w_gate"].shape == state["w_noise"].shape == (40, EXPERTS)
    model = MoEAdaptor(40, EXPERTS, 24, dropout=0.0)
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(model.experts.kernel.detach().numpy(),
                                  params["experts"]["kernel"])
    noise = rng.normal(size=(6, EXPERTS)).astype(np.float32)
    if train:
        normal = jax.random.normal
        jax.random.normal = lambda key, shape, dtype: jnp.asarray(noise, dtype)
        try:
            want = jmodel.apply({"params": params}, x, deterministic=False,
                                rngs={"gating": jax.random.PRNGKey(1),
                                      "dropout": jax.random.PRNGKey(2)})
        finally:
            jax.random.normal = normal
        rng_ = DropoutRNG(0, 0, "cpu")
        rng_.normal = lambda shape, dtype: T(noise).to(dtype)
        got = model.train()(T(x), rng_)
    else:
        want = jmodel.apply({"params": params}, x)
        got = model.eval()(T(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if train:  # the noise moved the gates
        assert not np.allclose(np.asarray(want), np.asarray(jmodel.apply({"params": params}, x)))


# -------------------------------------------------- trainers on a fixture
def _pair(fixture_dir, *extra):
    flags = [*_flags(fixture_dir, *extra), *_data_flags(fixture_dir)]
    jt = JaxTrainer(jax_parser().parse_args(["train_fastformer", *flags]))
    tt = Trainer(make_parser().parse_args(["train_fastformer", *flags, "--device", "cpu"]))
    news = os.path.join(fixture_dir, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    tlog = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts)
    batch = next(Batcher(8).batches(OnlineSampler(tlog, ts, 3, seed=7).sample_epoch(0)))
    return jt, tt, js, ts, batch


@pytest.fixture(scope="module")
def pair(fixture_dir):
    """The JAX and port trainers of the tiny UniSRec, and a batch."""
    return _pair(fixture_dir)


@pytest.fixture(scope="module")
def models(pair):
    """JAX's tiny UniSRec with the adaptor's gates and biases randomised,
    its parameters, and the port's model on them in eval mode."""
    jt, tt, js, _, batch = pair
    jmodel, kind, params = _jax_model_and_params(jt, js, batch, np.random.default_rng(5))
    return jmodel, kind, params, _port_model(tt, params).eval()


def _jax_model_and_params(jt, js, batch, rng=None):
    """JAX's model with the PLM's dropout rates at 0 (config fields, not
    flags) and its initial parameters from the seed, the adaptor's gates
    and biases randomised when ``rng`` is given."""
    jmodel, kind = jt.build_model(js)
    plm = dc.replace(jmodel.news_encoder.plm_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    jmodel = jmodel.clone(news_encoder=jmodel.news_encoder.clone(plm_cfg=plm))
    key = jax.random.PRNGKey(jt.args.seed)
    model_batch = jt._host_table(js).lookup(jnp.asarray(batch["cand_idx"]),
                                            jnp.asarray(batch["his_idx"]))
    init = jax.jit(lambda b: jmodel.init({"params": key, "dropout": key, "gating": key}, b))
    params = init(model_batch)["params"]
    if rng is not None:
        params = _randomize_moe(params, rng)
    return jmodel, kind, params


def _jax_logits(jmodel, params, jtable, batch):
    fn = jax.jit(lambda p, c, h: jmodel.apply({"params": p}, jtable.lookup(c, h)))
    return fn(params, jnp.asarray(batch["cand_idx"]), jnp.asarray(batch["his_idx"]))


def _jax_tail(jmodel):
    """JAX's ``tail``, jitted: (params, cand_repr, his_repr, his_mask) ->
    logits."""
    return jax.jit(lambda p, c, h, m: jmodel.apply({"params": p}, c, h, None, None, m,
                                                   method=type(jmodel).tail))


def _port_model(tt, params):
    model = tt.build_model()
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def test_carry_over_loads_the_whole_tree_strictly(pair, models):
    """``params_from_jax`` of JAX's whole UniSRec tree loads strictly:
    ``trm_layer_{i}`` -> ``trm_layers.{i}``, the fused qkv (300, 900)
    kernel -> a (900, 300) weight, the adaptor's leaves as they are."""
    tt = pair[1]
    _, kind, params, _ = models
    assert kind == "vanilla" and tt.kind == "vanilla"
    state = params_from_jax(params)
    assert set(state) == set(tt.build_model().state_dict())
    np.testing.assert_array_equal(state["trm_layers.1.attention.qkv.weight"].numpy(),
                                  np.asarray(params["trm_layer_1"]["attention"]["qkv"]["kernel"]).T)
    assert state["news_encoder.moe_adaptor.experts.kernel"].shape == (EXPERTS, 64, 300)
    assert state["position_embedding.weight"].shape == (HIS, 300)


def test_weight_decay_mask_matches_jax(models):
    """``optim.decays`` on the port's names gives JAX's
    ``default_decay_mask`` on its tree: the rank-3 expert kernel, the gates
    and the position table decay; the (E, D_in) expert bias, LayerNorms and
    biases do not."""
    from miner_tpu.training.optim import default_decay_mask
    from miner_tpu_torch.training.optim import decays

    _, _, params, model = models
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                  default_decay_mask(params), params)
    want = {k: bool(v.flatten()[0]) for k, v in params_from_jax(mask).items()}
    got = {n: decays(n, p) for n, p in model.named_parameters()}
    assert got == want
    moe = "news_encoder.moe_adaptor."
    assert got[moe + "experts.kernel"] and got[moe + "w_gate"] and got[moe + "w_noise"]
    assert got["position_embedding.weight"] and not got[moe + "experts.bias"]


@pytest.mark.parametrize("model_name", ["fastformer", "unisrec"])
def test_preconcat_table_and_encoders_match_jax(fixture_dir, model_name, rng):
    """Under ``--combine_type pre-concat`` the table holds title + sapo[1:]
    (16 + 24 - 1 = 39 tokens), equal to JAX's, and ``NewsEncoder`` (the
    Fastformer's, with --use_sapo --apply_reduce_dim) and ``NewsEncoderMoe``
    encode it as JAX's do: the title branch alone (float32, 1e-4 relative)."""
    extra = ("--model_name", model_name, "--use_sapo") + (
        ("--apply_reduce_dim", "--word_embed_dim", "32") if model_name == "fastformer" else ())
    jt, tt, js, ts, batch = _pair(fixture_dir, *extra)
    jtable, ttable = jt._make_table(js), tt._make_table(ts)
    assert ttable.sapo is None and ttable.title.shape[1] == 39
    np.testing.assert_array_equal(ttable.title.numpy(), np.asarray(jtable.title))
    jmodel, _, params = _jax_model_and_params(jt, js, batch, rng if model_name == "unisrec" else None)
    model = _port_model(tt, params).eval()
    assert model.news_encoder.linear_combine is None
    rows = np.arange(1, ts.num_news, dtype=np.int32)
    ids, mask = jtable.title[rows], (jtable.title[rows] != jtable.pad_token_id).astype(jnp.int32)
    want = jax.jit(lambda p, i, m: jmodel.apply({"params": p}, i, m,
                                                method=type(jmodel).encode_news))(
        params, ids, mask)
    with torch.no_grad():
        got = model.encode_news(T(np.array(ids)), T(np.array(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


def test_news_encoder_moe_linear_combine_matches_jax(rng):
    """``NewsEncoderMoe`` with --use_sapo and the linear combine: each
    field's CLS vector through the adaptor, then ``linear_combine`` of the
    pair (float32, 1e-4 relative)."""
    from miner_tpu.models.news_encoder import NewsEncoderMoe as JaxMoe
    from miner_tpu.models.plm import PLMConfig as JaxPLMConfig
    from miner_tpu_torch.models import PLMConfig

    jenc = JaxMoe(plm_cfg=dc.replace(JaxPLMConfig.tiny(), hidden_dropout=0.0,
                                     attention_dropout=0.0),
                  use_sapo=True, combine_type="linear", n_experts=4, adaptor_out_dim=24)
    t = rng.integers(1, 1000, size=(5, 12)).astype(np.int32)
    s = rng.integers(1, 1000, size=(5, 20)).astype(np.int32)
    tm, sm = np.ones_like(t), (np.arange(20)[None] < np.array([[20], [3], [9], [20], [1]])
                               ).astype(np.int32)
    params = _randomize_moe(jax.jit(jenc.init)(jax.random.PRNGKey(3), t, tm, s, sm)["params"],
                            rng)
    want = jax.jit(jenc.apply)({"params": params}, t, tm, s, sm)
    enc = NewsEncoderMoe(PLMConfig.tiny(), use_sapo=True, combine_type="linear", n_experts=4,
                         adaptor_out_dim=24)
    enc.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = enc.eval()(T(t), T(tm), T(s), T(sm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


def _histories(layout):
    """(4, 5) history masks: a full history, a short one (2 clicks: slots
    0-1 clicks-first, 3-4 pads-first), a no-click user, one click."""
    rows = [history_row(list(range(1, n + 1)), HIS, layout == "legacy") for n in (5, 2, 0, 1)]
    return (np.stack(rows) != 0).astype(np.int32)


@pytest.mark.parametrize("layout", ["clicks_first", "legacy"])
def test_tail_matches_jax_under_both_layouts(models, rng, layout):
    """``UniSRec.tail`` on the same (B, C, D) candidates and (B, H, D)
    history rows against JAX's ``tail``, with a full history, a short one,
    a no-click user (every key at -10000: row 0 attends all slots by its
    raw logits) and a single click; under the legacy layout the short
    history's position 0 is a pad, a fully masked row 0 (float32, 1e-4
    relative)."""
    jmodel, _, params, model = models
    his_mask = _histories(layout)
    assert his_mask[2].sum() == 0 and (his_mask[1, 0] == 0) == (layout == "legacy")
    cand = rng.normal(size=(4, 3, 300)).astype(np.float32)
    his = rng.normal(size=(4, HIS, 300)).astype(np.float32)
    want = _jax_tail(jmodel)(params, cand, his, his_mask)
    with torch.no_grad():
        got = model.tail(T(cand), T(his), T(his_mask))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


def test_clicks_first_score_reads_the_first_slot_alone(models, rng):
    """Under the causal mask query 0 attends key 0 alone, so two
    clicks-first histories that differ only past slot 0 score the same, in
    the port and in JAX; under the legacy layout a fully masked row 0
    attends every slot, so changing a later slot moves its score."""
    jmodel, _, params, model = models
    cand = np.repeat(rng.normal(size=(1, 3, 300)).astype(np.float32), 2, axis=0)
    his = np.repeat(rng.normal(size=(1, HIS, 300)).astype(np.float32), 2, axis=0)
    his[1, 1:] = rng.normal(size=(HIS - 1, 300))
    jax_tail = _jax_tail(jmodel)
    tail = lambda m: (model.tail(T(cand), T(his), T(m)).detach().numpy(),
                      np.asarray(jax_tail(params, cand, his, m)))
    for scores in tail(np.ones((2, HIS), np.int32)):
        np.testing.assert_allclose(scores[0], scores[1], rtol=1e-5, atol=1e-6)
    legacy = np.array([[0, 0, 0, 1, 1]] * 2, np.int32)
    got, want = tail(legacy)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    assert np.abs(got[0] - got[1]).max() > 1e-3


@pytest.mark.parametrize("layout", ["clicks_first", "legacy"])
def test_forward_on_a_batch_matches_jax(fixture_dir, rng, layout):
    """``UniSRec.forward`` on a fixture batch (one news-encoder call over
    candidates and history, then the tail) against JAX's, under both
    history layouts (float32, 1e-4 relative)."""
    extra = ("--legacy_history_layout",) if layout == "legacy" else ()
    jt, tt, js, ts, batch = _pair(fixture_dir, *extra)
    jmodel, _, params = _jax_model_and_params(jt, js, batch, rng)
    want = np.asarray(_jax_logits(jmodel, params, jt._make_table(js), batch))
    model = _port_model(tt, params)
    assert isinstance(model, UniSRec)
    with torch.no_grad():
        _, got = tt._eval_outputs(model.eval(), tt._make_table(ts), None, batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_bf16_compute_keeps_the_tail_in_float32(fixture_dir, rng):
    """At --compute_dtype bfloat16 the news encoder (PLM and adaptor)
    computes in bf16 and the SASRec tail in float32: the logits are
    float32 and agree with JAX's within bf16 rounding of the news vectors
    (2e-2 of the logits' scale); serving casts the news encoder alone."""
    jt, tt, js, ts, batch = _pair(fixture_dir, "--compute_dtype", "bfloat16")
    jmodel, _, params = _jax_model_and_params(jt, js, batch, rng)
    want = _jax_logits(jmodel, params, jt._make_table(js), batch)
    assert want.dtype == jnp.float32
    model = _port_model(tt, params)
    with torch.no_grad():
        cand, his = model.news_encoder.encode_batch(tt._make_table(ts).lookup(
            tt._index(batch["cand_idx"]), tt._index(batch["his_idx"])))
        _, got = tt._eval_outputs(model.eval(), tt._make_table(ts), None, batch)
    assert cand.dtype == his.dtype == torch.bfloat16 and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-2 * max(1e-3, np.abs(want).max()))
    ctx = Trainer(make_parser().parse_args(
        ["serve", *_flags(fixture_dir), "--compute_dtype", "bfloat16", "--device", "cpu",
         "--eval_news_path", os.path.join(fixture_dir, "news.tsv")])).serving_context()
    assert ctx.cache.embeddings.dtype == torch.bfloat16
    assert ctx.model.news_encoder.moe_adaptor.experts.kernel.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for n, p in ctx.model.named_parameters()
               if not n.startswith("news_encoder."))


# ------------------------------------------------- 20 micro-steps vs JAX
N_STEPS, ACCUM, TOTAL, WARMUP = 20, 2, 10, 2


def _no_dropout_cfg(make):
    return lambda *a, **k: dc.replace(make(*a, **k), hidden_dropout=0.0,
                                      attention_dropout=0.0)


@pytest.fixture(scope="module", params=["moe_only", "train_all"])
def trained(request, fixture_dir, tmp_path_factory):
    """Both packages train the same tiny UniSRec (float32, every dropout 0,
    the same gating noise) for 20 micro-steps at accumulation 2 with a clip
    that triggers, on the same batches: under the MoE-only freeze, or with
    ``--unisrec_train_all``. The SASRec dropout rates (hard-coded in both
    packages' ``sasrec_encoder_cfg``) and the port's PLM rates are zeroed
    by patching the config functions; JAX's PLM rates by its config."""
    extra = ("--unisrec_train_all",) if request.param == "train_all" else ()
    flags = [*_flags(fixture_dir, *extra), *_data_flags(fixture_dir), "--dropout", "0",
             "--gradient_accumulation_steps", str(ACCUM), "--max_grad_norm", "0.05",
             "--learning_rate", "2e-3", "--weight_decay", "0.05", "--train_batch_size", "8"]
    rng = np.random.default_rng(11)
    noise = rng.normal(size=(8 * (4 + HIS), EXPERTS)).astype(np.float32)
    normal = jax.random.normal

    def jax_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_unisrec, "sasrec_encoder_cfg", _no_dropout_cfg(jax_unisrec.sasrec_encoder_cfg))
        mp.setattr(port_unisrec, "sasrec_encoder_cfg", _no_dropout_cfg(port_unisrec.sasrec_encoder_cfg))
        mp.setattr(port_trainer, "plm_config", _no_dropout_cfg(port_trainer.plm_config))
        mp.setattr(jax.random, "normal", jax_normal)
        mp.setattr(DropoutRNG, "normal", lambda self, shape, dtype: T(noise).to(dtype))
        jt = JaxTrainer(jax_parser().parse_args(["train_fastformer", *flags]))
        tt = Trainer(make_parser().parse_args(["train_fastformer", *flags, "--device", "cpu"]))
        news = os.path.join(fixture_dir, "news.tsv")
        js, ts = jt._load_store(news), tt._load_store(news)
        tlog = tt._load_log(os.path.join(fixture_dir, "behaviors.tsv"), ts)
        sampler = OnlineSampler(tlog, ts, 3, seed=7)
        batcher = Batcher(8, drop_last=True, shuffle=True, seed=7)
        batches = [b for epoch in range(3)
                   for b in batcher.batches(sampler.sample_epoch(epoch), epoch)]
        assert len(batches) >= N_STEPS
        jmodel, kind, params = _jax_model_and_params(jt, js, batches[0], rng)
        jtable = jt._make_table(js)
        tx = make_optimizer(params, learning_rate=2e-3, total_steps=TOTAL,
                            warmup_steps=WARMUP, weight_decay=0.05, max_grad_norm=0.05,
                            accum_steps=ACCUM, trainable_pred=jt._trainable_pred())
        from miner_tpu.parallel.sharding import replicate_tree, shard_batch

        state = replicate_tree(jt.mesh, TrainState.create(params, tx, jax.random.PRNGKey(8)))
        step = jt._make_train_step(jmodel, kind, jtable)
        model = _port_model(tt, params)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        model.train()  # the gating noise on; every dropout rate is 0
        ttable = tt._make_table(ts)
        opt = tt.make_optimizer(model, TOTAL, WARMUP)
        jax_l, port_l, plm_grads = [], [], []
        for i in range(N_STEPS):
            b = batches[i]
            state, loss = step(state, shard_batch(jt.mesh, {k: v for k, v in b.items()
                                                             if k != "valid"}))
            jax_l.append(float(loss))
            port_l.append(float(tt.train_step(model, ttable, b, opt, i)))
            if i % ACCUM == 0:  # mid-accumulation: the gradient sums are there
                plm_grads.append(model.news_encoder.plm.embeddings.word_embeddings.weight.grad)
    assert opt.updates == N_STEPS // ACCUM
    return dict(mode=request.param, jt=jt, tt=tt, jmodel=jmodel, kind=kind, state=state,
                jtable=jtable, model=model, ttable=ttable, js=js, ts=ts, initial=initial,
                jax_losses=jax_l, port_losses=port_l, plm_grads=plm_grads,
                out=str(tmp_path_factory.mktemp("unisrec_trained")))


def test_twenty_micro_steps_match_jax(trained):
    """Losses to 1e-5 (float32 summation order) and final parameters to
    1e-4 absolute (Adam moves a near-zero gradient's element by up to lr
    per update whatever its rounding). Under the MoE-only freeze every
    other tensor is bit-identical to its start and the PLM never got a
    gradient (no backward through it); under --unisrec_train_all the PLM
    moved too."""
    np.testing.assert_allclose(trained["port_losses"], trained["jax_losses"],
                               rtol=1e-5, atol=1e-5)
    assert trained["jax_losses"][0] != trained["jax_losses"][-1]
    want = params_from_jax(jax.device_get(trained["state"].params))
    got = trained["model"].state_dict()
    assert want.keys() == got.keys()
    moved = set()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
        if not torch.equal(got[k], trained["initial"][k]):
            moved.add(k)
    moe = {k for k in want if "moe" in k}
    if trained["mode"] == "moe_only":
        assert moved == moe
        assert all(g is None for g in trained["plm_grads"])
    else:
        assert moe < moved and any(k.startswith("news_encoder.plm.") for k in moved)
        assert all(g is not None for g in trained["plm_grads"])


def test_cached_eval_after_training_matches_jax(trained):
    """Metrics and the logsigmoid eval loss of the port's cached
    ``_run_eval`` against JAX's on the final weights of each (float32;
    metrics 1e-5, the loss, a sum over 40 impressions, 2e-4)."""
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
        trained["model"], trained["ttable"], trained["ts"], tt._load_log(beh, trained["ts"]),
        RunLogger(os.path.join(trained["out"], "port"), "eval"), 0, 0)
    assert set(got) == set(want) == {"auc", "group_auc", "mrr", "ndcg@5"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-4, atol=1e-6)


def test_serve_scores_and_topk_match_jax(trained, fixture_dir):
    """Slate scores and the whole-corpus top-k from the news-embedding
    cache on the trained weights against JAX's ``serve_scores`` and
    ``serve_topk`` (float32, 1e-4 relative); a no-click user included."""
    jt = trained["jt"]
    base = [*_flags(fixture_dir), "--eval_news_path", os.path.join(fixture_dir, "news.tsv")]
    jserve = JaxTrainer(jax_parser().parse_args(["serve", *base]))
    tserve = Trainer(make_parser().parse_args(["serve", *base, "--device", "cpu"]))
    params = trained["state"].params
    jmodel, jkind = trained["jmodel"], trained["kind"]
    jcache = jt._build_eval_cache(jmodel, params, trained["jtable"])
    ctx = tserve.serving_context(params_from_jax(jax.device_get(params)))
    np.testing.assert_allclose(ctx.cache.embeddings.numpy(), np.asarray(jcache.embeddings),
                               rtol=1e-4, atol=2e-5)
    cand = np.zeros((2, 16), np.int32)
    cand[0, :5], cand[1, :9] = [1, 2, 3, 5, 8], np.arange(3, 12)
    his = np.zeros((2, HIS), np.int32)
    his[0, :3] = [3, 7, 11]  # row 1 has no clicks
    want = jserve.serve_scores(jmodel, jkind, params, jcache, cand, his)
    got = tserve.serve_scores(ctx.model, ctx.cache, cand, his)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    n = ctx.store.num_news
    want_vals, want_rows = jserve.serve_topk(jmodel, jkind, params, jcache, his, 4, num_news=n)
    vals, rows = tserve.serve_topk(ctx.model, ctx.cache, his, 4)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-4, atol=2e-5)


# ------------------------------------------------------- CLI end to end
@pytest.fixture(scope="module")
def cli_run(fixture_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("unisrec_cli"))
    argv = ["train_fastformer", *_flags(fixture_dir), *_data_flags(fixture_dir),
            "--train_batch_size", "8", "--learning_rate", "1e-3", "--num_train_epochs", "1",
            "--gradient_accumulation_steps", "2", "--remat", "--logging_steps", "2",
            "--train_path", os.path.join(out, "train"), "--device", "cpu"]
    assert cli_main(argv) == 0
    (run_dir,) = glob.glob(os.path.join(out, "train", "*"))
    return out, run_dir


def test_cli_train_fastformer_then_eval_fastformer(cli_run, fixture_dir):
    """``train_fastformer`` with UniSRec writes the run dir and checkpoints;
    only the MoE adaptor moved from the seed's weights; ``eval_fastformer``
    from ``bestAucModel`` reproduces the run's best auc."""
    out, rd = cli_run
    rows = [r.split(",") for r in open(os.path.join(rd, "eval.csv")).read().splitlines()]
    assert rows[0] == ["epoch", "step", "loss", "auc", "group_auc", "mrr", "ndcg@5"]
    assert len(rows) == 2 and all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    for name in checkpoint.NAMES:
        assert os.path.isfile(os.path.join(rd, "ckpt", name)), name
    saved = checkpoint.load(os.path.join(rd, "ckpt", "finalModel"))["params"]
    initial = Trainer(make_parser().parse_args(
        ["train_fastformer", *_flags(fixture_dir), "--device", "cpu"])).build_model().state_dict()
    moved = {k for k in initial if not torch.equal(saved[k], initial[k])}
    assert moved and all("moe" in k for k in moved)
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
    ``finalModel`` with ``--model_name unisrec``."""
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
    scores = [float(ln.split("\t")[1]) for ln in lines]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    assert {ln.split("\t")[0] for ln in lines} <= set(candidates or [f"N{i}" for i in range(12)])


@pytest.mark.parametrize("int8", [False, True], ids=["bfloat16", "int8"])
def test_persisted_serving_cache_reloads_bit_equal(cli_run, fixture_dir, tmp_path, capsys,
                                                   int8):
    """``--serve_cache_path`` on the ``finalModel``: the first start encodes
    the corpus and persists it, the second loads it (bf16 rows, or int8
    with ``--serve_cache_int8``) and scores slates and the corpus top-k bit
    for bit as the first did."""
    _, rd = cli_run
    argv = ["serve", *_flags(fixture_dir, "--compute_dtype", "bfloat16"), "--device", "cpu",
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv"),
            "--saved_model_path", os.path.join(rd, "ckpt", "finalModel"),
            "--serve_cache_path", str(tmp_path / "cache.npz"),
            *(["--serve_cache_int8"] if int8 else [])]
    cand = np.array([[1, 2, 3, 5], [4, 6, 7, 8]], np.int32)
    his = np.array([[3, 7, 11, 0, 0], [0] * HIS], np.int32)
    out = []
    for word in ("persisted", "loaded"):
        tt = Trainer(make_parser().parse_args(argv))
        ctx = tt.serving_context()
        assert f"serving cache {word}" in capsys.readouterr().out
        assert ctx.cache.quantized == int8
        out.append((tt.serve_scores(ctx.model, ctx.cache, cand, his),
                    *tt.serve_topk(ctx.model, ctx.cache, his, 4)))
    for a, b in zip(*out):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def test_int8_serve_scores_match_jax(fixture_dir):
    """JAX's serving with --serve_cache_int8 against the port's on the same
    weights and the same int8 cache (JAX's, whose rows the port dequantizes
    at the gather), float32: slates and the corpus top-k within float32
    summation-order noise (1e-4 relative)."""
    from miner_tpu_torch.parallel.news_cache import Int8Rows, NewsEmbeddingCache

    argv = ["serve", *_flags(fixture_dir), "--serve_cache_int8",
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv")]
    jt = JaxTrainer(jax_parser().parse_args(argv))
    jctx = jt.serving_context()
    tt = Trainer(make_parser().parse_args([*argv, "--device", "cpu"]))
    ctx = tt.serving_context(params_from_jax(jax.device_get(jctx.params)))
    assert jctx.cache.quantized and ctx.cache.quantized
    q = jctx.cache.embeddings
    cache = NewsEmbeddingCache(Int8Rows(T(np.array(q.values)), T(np.array(q.scales)),
                                        q.dequant_dtype), ctx.cache.category,
                               ctx.cache.category_pad_id)
    cand = np.array([[1, 2, 3, 5, 8, 0], [3, 4, 5, 6, 7, 9]], np.int32)
    his = np.array([[3, 7, 11, 0, 0], [2, 0, 0, 0, 0]], np.int32)
    want = jt.serve_scores(jctx.model, jctx.kind, jctx.params, jctx.cache, cand, his)
    got = tt.serve_scores(ctx.model, cache, cand, his)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    want_vals, want_rows = jt.serve_topk(jctx.model, jctx.kind, jctx.params, jctx.cache,
                                         his, 4, num_news=jctx.store.num_news)
    vals, rows = tt.serve_topk(ctx.model, cache, his, 4)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-4, atol=2e-5)


def test_pretrain_encoder_warm_start_is_refused(cli_run, fixture_dir, tmp_path):
    """--pretrained_model_path takes a whole UniSRec checkpoint (the CLI
    run's ``finalModel`` loads); a pretrain run's news encoder does not fit
    ``NewsEncoderMoe`` and is refused, as the JAX trainer refuses it."""
    _, rd = cli_run
    base = ["train_fastformer", *_flags(fixture_dir), *_data_flags(fixture_dir), "--device", "cpu"]
    tt = Trainer(make_parser().parse_args(base))
    log = logging.getLogger("test_torch_unisrec")
    tt._warm_start(tt.build_model(), os.path.join(rd, "ckpt", "finalModel"), log)
    pre = Trainer(make_parser().parse_args(
        ["pretrain", *_flags(fixture_dir), *_data_flags(fixture_dir), "--device", "cpu"]))
    path = str(tmp_path / "encoder")
    checkpoint.save(path, {"params": pre.build_model().state_dict()})
    with pytest.raises(ValueError, match="neither the whole model nor its news encoder"):
        tt._warm_start(tt.build_model(), path, log)


@pytest.mark.parametrize("extra", [(), ("--freeze_transformer",), ("--unisrec_train_all",),
                                   ("--unisrec_train_all", "--freeze_transformer")])
def test_freeze_matches_jax_trainable_pred(fixture_dir, extra):
    """Which tensors train: the MoE adaptor alone unless
    --unisrec_train_all, which then falls through to --freeze_transformer
    (the PLM frozen), as JAX's ``_trainable_pred`` decides on the same
    names."""
    flags = ["train_fastformer", *_flags(fixture_dir, *extra), *_data_flags(fixture_dir)]
    pred = JaxTrainer(jax_parser().parse_args(flags))._trainable_pred()
    tt = Trainer(make_parser().parse_args([*flags, "--device", "cpu"]))
    model = tt.build_model()
    tt.make_optimizer(model, 10, 1)
    got = {n: p.requires_grad for n, p in model.named_parameters()}
    want = {n: pred is None or pred(n.replace(".", "/")) for n in got}
    assert got == want and any(got.values()) and ("--unisrec_train_all" in extra
                                                   or not all(got.values()))


def test_dropout_and_gating_noise_are_a_function_of_seed_and_step(pair):
    """In training mode (SASRec dropout 0.5, the adaptor's 0.2, the PLM's
    kernels' sites, the gating noise) the same (seed, micro-step) draws the
    same forward, another step another, eval() none."""
    _, tt, _, ts, batch = pair
    table = tt._make_table(ts)
    model = tt.build_model().train()
    assert model.cfg.hidden_dropout == model.cfg.attention_dropout == 0.5
    with torch.no_grad():
        run = lambda step: tt._apply_and_loss(model, table, batch,
                                              DropoutRNG(8, step, "cpu"))[1]
        a, b, c = run(0), run(0), run(1)
        model.eval()
        d, e = run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)
