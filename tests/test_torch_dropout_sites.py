"""The port drops where the JAX package drops, at the same rates.

Every dropout flag of the tiny preset gets a rate of its own, so that a
rate names its site: the PLM's hidden and attention rates (config fields,
set through each trainer's ``plm_config``), ``--dropout`` (the news
encoder's ``reduce_dim``, the category embeddings, UniSRec's MoE adaptor,
Fastformer's layers), ``--lstm_dropout`` with ``--lstm_num_layers 2``, and
UniSRec's sequential encoder's hidden and attention rates (its
``sasrec_encoder_cfg``). One training-mode forward of each family runs
through each package on the CPU, recording every dropout application's
(rate, element count):

- JAX with ``--no-fused_kernels``, so that every site is a flax
  ``nn.Dropout`` (intercepted here; nothing in ``miner_tpu/`` changes);
- the port on its plain versions: ``DropoutRNG.dropout`` and the rate
  arguments of the plain mha (``mha_reference``: its (N, heads, L, L)
  probabilities) and add_ln (``add_ln_reference``: its h).

The two multisets are equal for every family: the same sites, at the same
rates, over tensors of the same sizes.
"""
import collections
import dataclasses as dc
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import miner_tpu.models.unisrec as jax_unisrec
import miner_tpu.training.trainer as jax_trainer
import miner_tpu_torch.models.unisrec as port_unisrec
import miner_tpu_torch.ops.add_ln as port_add_ln
import miner_tpu_torch.ops.mha as port_mha
import miner_tpu_torch.training.trainer as port_trainer
from miner_tpu.config import make_parser as jax_parser
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import OnlineSampler, PretrainSampler
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

# a rate a site: the PLM's hidden and attention dropout, --dropout,
# --lstm_dropout, the sequential encoder's hidden and attention dropout
PLM_HIDDEN, PLM_ATTENTION, DROPOUT, LSTM_DROPOUT = 0.11, 0.13, 0.17, 0.19
SASREC_HIDDEN, SASREC_ATTENTION = 0.23, 0.29
AUGS = ("enhanced_text",)

MINER = ("--model_name", "Miner", "--apply_reduce_dim", "--use_sapo", "--use_category_bias",
         "--word_embed_dim", "32", "--category_embed_dim", "8", "--num_context_codes", "4",
         "--context_code_dim", "16", "--score_type", "weighted")
FAMILIES = {
    "miner-linear": ("train", MINER + ("--combine_type", "linear")),
    "miner-lstm": ("train", MINER + ("--combine_type", "lstm", "--lstm_num_layers", "2",
                                     "--lstm_dropout", str(LSTM_DROPOUT))),
    "fastformer": ("train_fastformer", ("--model_name", "fastformer", "--apply_reduce_dim",
                                        "--use_sapo", "--word_embed_dim", "32")),
    "unbert": ("train_fastformer", ("--model_name", "unbert")),
    "unisrec": ("train_fastformer", ("--model_name", "unisrec", "--combine_type",
                                     "pre-concat")),
    "pretrain": ("pretrain", ("--model_name", "Miner", "--apply_reduce_dim", "--use_sapo",
                              "--word_embed_dim", "32", "--augmentations", *AUGS)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs (the PLM's plain Philox
    dropout: many small ops, slowed by oversubscription under xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("drop_fx")), num_lines=8)


@pytest.fixture
def rates(monkeypatch):
    """Both packages' PLM and sequential-encoder rates set to the sites'."""
    def plm(make):
        return lambda *a, **k: dc.replace(make(*a, **k), hidden_dropout=PLM_HIDDEN,
                                          attention_dropout=PLM_ATTENTION)

    def sasrec(make):
        return lambda *a, **k: dc.replace(make(*a, **k), hidden_dropout=SASREC_HIDDEN,
                                          attention_dropout=SASREC_ATTENTION)

    for mod in (jax_trainer, port_trainer):
        monkeypatch.setattr(mod, "plm_config", plm(mod.plm_config))
    for mod in (jax_unisrec, port_unisrec):
        monkeypatch.setattr(mod, "sasrec_encoder_cfg", sasrec(mod.sasrec_encoder_cfg))


def _argv(fixture, family):
    mode, flags = FAMILIES[family]
    return [mode, "--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--npratio", "3",
            "--compute_dtype", "float32", "--dropout", str(DROPOUT),
            "--train_behaviors_path", os.path.join(fixture, "behaviors.tsv"),
            "--train_news_path", os.path.join(fixture, "news.tsv"), *flags]


def _batch(tt, ts, fixture, family):
    """A training batch of the family (the port's samplers), fed to both
    packages."""
    log = tt._load_log(os.path.join(fixture, "behaviors.tsv"), ts)
    if family == "unbert":
        return tt._train_sampler(log, ts).sample_epoch(0).materialize(np.arange(2))
    sampler = (PretrainSampler if family == "pretrain" else OnlineSampler)(log, ts, 3, seed=7)
    return next(Batcher(4).batches(sampler.sample_epoch(0)))


def _jax_sites(monkeypatch, fixture, family, batch):
    """(rate, elements) of every dropout JAX applies in one training-mode
    forward of the family (recorded as ``jax.jit`` traces it)."""
    seen = []
    call = fnn.Dropout.__call__

    def recording(self, inputs, deterministic=None, rng=None):
        if not fnn.merge_param("deterministic", self.deterministic, deterministic) and \
                self.rate > 0.0:
            seen.append((round(float(self.rate), 6), int(np.prod(inputs.shape))))
        return call(self, inputs, deterministic=deterministic, rng=rng)

    monkeypatch.setattr(fnn.Dropout, "__call__", recording)
    jt = jax_trainer.Trainer(jax_parser().parse_args([*_argv(fixture, family),
                                                      "--no-fused_kernels"]))
    augs = AUGS if family == "pretrain" else ()
    store = jt._load_store(os.path.join(fixture, "news.tsv"), *((augs,) if augs else ()))
    jt._num_augs = store.num_variants - 1
    model, kind = jt.build_model(store)
    table = None if kind == "unbert" else jt._make_table(store)
    example = {k: jnp.asarray(v) for k, v in batch.items()
               if np.asarray(v).dtype.kind in "biuf"}
    key = jax.random.PRNGKey(7)
    # the parameters' shapes suffice: the forward is traced, not run
    params = jax.eval_shape(lambda: jt._init_params_for_kind(
        model, kind, None if kind == "unbert" else jt._host_table(store), example))
    seen.clear()  # the init's trace is not the forward
    jax.jit(lambda p, b: jt._apply_and_loss(model, kind, p, table, b, train=True,
                                            rngs={"dropout": key, "gating": key})[0]
            ).lower(params, example)
    monkeypatch.setattr(fnn.Dropout, "__call__", call)
    return seen


def _port_sites(monkeypatch, tt, ts, batch):
    """(rate, elements) of every dropout the port applies in one
    training-mode forward on the CPU, from its own init."""
    seen = []
    drop, mha, add_ln = DropoutRNG.dropout, port_mha.mha_reference, port_add_ln.add_ln_reference

    def dropout(self, x, rate, heads=None):
        if rate > 0.0:
            seen.append((round(float(rate), 6), x.numel()))
        return drop(self, x, rate, heads)

    def mha_reference(qkv, mask, num_heads, seqs=1, dropout_rate=0.0, *a, **k):
        if dropout_rate > 0.0:
            N, L = mask.shape
            seen.append((round(float(dropout_rate), 6), N * num_heads * L * (L // seqs)))
        return mha(qkv, mask, num_heads, seqs, dropout_rate, *a, **k)

    def add_ln_reference(x, h, scale, bias, eps, rate=0.0, *a, **k):
        if rate > 0.0:
            seen.append((round(float(rate), 6), h.numel()))
        return add_ln(x, h, scale, bias, eps, rate, *a, **k)

    monkeypatch.setattr(DropoutRNG, "dropout", dropout)
    monkeypatch.setattr(port_mha, "mha_reference", mha_reference)
    monkeypatch.setattr(port_add_ln, "add_ln_reference", add_ln_reference)
    model = tt.build_model().train()
    table = None if tt.kind == "unbert" else tt._make_table(ts)
    with torch.no_grad():
        loss, _ = tt._apply_and_loss(model, table, batch, DropoutRNG(7, 0, "cpu"))
    assert torch.isfinite(loss)
    return seen


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_drops_where_jax_drops(monkeypatch, rates, fixture_dir, family):
    tt = Trainer(make_parser().parse_args([*_argv(fixture_dir, family), "--device", "cpu"]))
    augs = AUGS if family == "pretrain" else ()
    ts = tt._load_store(os.path.join(fixture_dir, "news.tsv"), *((augs,) if augs else ()))
    tt._num_augs = ts.num_variants - 1
    batch = _batch(tt, ts, fixture_dir, family)
    want = _jax_sites(monkeypatch, fixture_dir, family, batch)
    got = _port_sites(monkeypatch, tt, ts, batch)
    # every rate of the family is applied somewhere
    expected = {PLM_HIDDEN, PLM_ATTENTION}
    expected |= {DROPOUT} if family != "unbert" else set()
    expected |= {LSTM_DROPOUT} if family == "miner-lstm" else set()
    expected |= {SASREC_HIDDEN, SASREC_ATTENTION} if family == "unisrec" else set()
    assert {r for r, _ in want} == expected, sorted(want)
    got, want = collections.Counter(got), collections.Counter(want)
    assert got == want, (sorted(got.items()), sorted(want.items()))
