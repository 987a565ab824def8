"""The port's own random init (``Trainer.build_model()``) held against the
JAX package's (``model.init`` through its trainer's
``_init_params_for_kind``), family by family, at the tiny preset and the
``hash:1000`` tokenizer.

Every other parity test carries JAX's init across (``params_from_jax``);
this one compares the two schemes themselves, leaf by leaf under the
port's names:

- the key sets are equal;
- a leaf JAX sets to a constant (zeros, ones) is equal exactly;
- a random leaf of at least ``MIN_N`` elements has a standard deviation
  within ``SE_TOL`` standard errors of JAX's (the relative standard error of
  the difference of two sample deviations of n draws is about
  1 / sqrt(n)), a mean within as many of zero apart, and the same bound:
  where flax truncates at two of its pre-truncation sigmas (lecun_normal,
  max |w| <= 2.27 times the sample deviation) or draws uniformly (1.73
  times), the port's leaf keeps within the same bound, and where flax draws
  an untruncated normal, the port's leaf passes it too. The bound is read
  against the sample deviation, so it carries two of that deviation's
  relative standard errors (1 / sqrt(2 n)) of slack: an untruncated normal
  of 256 draws stays under it with probability 0.03, of 512 with 0.0003.

Smaller random leaves (the PLM's token-type table of one or two rows,
Fastformer's 1-wide pooler head) are listed and skipped: too few draws to
tell a scheme. At these flags each family compares 12-47 random leaves and
20-48 constant ones.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import miner_tpu.training.trainer as jax_trainer
from miner_tpu.config import make_parser as jax_parser
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

MIN_N = 256
SE_TOL = 4.0
# flax's truncated normal (lecun_normal, variance_scaling "truncated_normal")
# cuts at 2 of its sigmas, which it rescales by 1 / 0.8796 so that the
# truncated draws keep the variance: max |w| <= 2 / 0.8796 = 2.274 sample
# deviations; a uniform draw stays within sqrt(3) = 1.732
TRUNC_RATIO = 2.0 / 0.87962566103423978

MINER = ("--model_name", "Miner", "--apply_reduce_dim", "--use_sapo", "--use_category_bias",
         "--word_embed_dim", "64", "--category_embed_dim", "48", "--num_context_codes", "8",
         "--context_code_dim", "32", "--score_type", "weighted")
FAMILIES = {
    "miner-linear": ("train", MINER + ("--combine_type", "linear")),
    "miner-lstm": ("train", MINER + ("--combine_type", "lstm", "--lstm_num_layers", "2")),
    "fastformer": ("train_fastformer", ("--model_name", "fastformer", "--apply_reduce_dim",
                                        "--use_sapo", "--word_embed_dim", "64")),
    "unbert": ("train_fastformer", ("--model_name", "unbert")),
    "unisrec": ("train_fastformer", ("--model_name", "unisrec", "--combine_type",
                                     "pre-concat")),
    "pretrain": ("pretrain", ("--model_name", "Miner", "--apply_reduce_dim", "--use_sapo",
                              "--word_embed_dim", "64", "--augmentations", "enhanced_text")),
}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("init_fx")), num_lines=8)


def _argv(fixture, family):
    mode, flags = FAMILIES[family]
    return [mode, "--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--npratio", "3",
            "--compute_dtype", "float32",
            "--train_behaviors_path", os.path.join(fixture, "behaviors.tsv"),
            "--train_news_path", os.path.join(fixture, "news.tsv"), *flags]


def _jax_init(fixture, family):
    """JAX's initial parameters of the family, through its trainer's
    ``_init_params_for_kind`` (jitted: op-by-op dispatch is slow)."""
    argv = _argv(fixture, family)
    jt = jax_trainer.Trainer(jax_parser().parse_args(argv))
    augs = ("enhanced_text",) if family == "pretrain" else ()
    store = jt._load_store(os.path.join(fixture, "news.tsv"), *((augs,) if augs else ()))
    if family == "pretrain":
        jt._num_augs = len(augs)
    model, kind = jt.build_model(store)
    if kind == "unbert":
        tt = Trainer(make_parser().parse_args([*argv, "--device", "cpu"]))
        ts = tt._load_store(os.path.join(fixture, "news.tsv"))
        block = tt._train_sampler(tt._load_log(os.path.join(fixture, "behaviors.tsv"), ts),
                                  ts).sample_epoch(0)
        example, table = block.materialize(np.arange(2)), None
    else:
        example = {"cand_idx": jnp.zeros((2, 4), jnp.int32),
                   "his_idx": jnp.zeros((2, 5), jnp.int32)}
        table = jt._host_table(store)
    params = jax.jit(lambda: jt._init_params_for_kind(model, kind, table, example))()
    return params_from_jax(jax.device_get(params))


def _port_init(fixture, family):
    tt = Trainer(make_parser().parse_args([*_argv(fixture, family), "--device", "cpu"]))
    return {k: v.detach() for k, v in tt.build_model().state_dict().items()}


def _stats(t):
    x = t.double().flatten()
    std = float(x.std(unbiased=False))
    return float(x.mean()), std, float(x.abs().max()) / std if std > 0 else 0.0


def compare_inits(want, got):
    """(constant leaves, random leaves compared, small random leaves
    skipped, mismatches): each mismatch (name, what, JAX's, the port's)."""
    assert sorted(got) == sorted(want)
    constant, compared, small, bad = [], [], [], []
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if bool((w == w.flatten()[0]).all()):
            constant.append(k)
            if not torch.equal(g.to(w.dtype), w):
                bad.append((k, "constant", float(w.flatten()[0]), _stats(g)))
            continue
        n = w.numel()
        if n < MIN_N:
            small.append(k)
            continue
        compared.append(k)
        (wm, ws, wr), (gm, gs, gr) = _stats(w), _stats(g)
        if abs(gs / ws - 1.0) > SE_TOL / math.sqrt(n):
            bad.append((k, "std", ws, gs))
        if abs(gm - wm) > SE_TOL * ws * math.sqrt(2.0 / n):
            bad.append((k, "mean", wm, gm))
        bound = TRUNC_RATIO * (1.0 + 2.0 / math.sqrt(2.0 * n))
        if (wr <= bound) != (gr <= bound):
            bad.append((k, "bound (max |w| / std)", wr, gr))
    return constant, compared, small, bad


# schemes the port keeps apart from JAX's on purpose: (family, leaf) ->
# the reason; none
KEPT = {}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_init_matches_jax_scheme(fixture_dir, family):
    want, got = _jax_init(fixture_dir, family), _port_init(fixture_dir, family)
    constant, compared, small, bad = compare_inits(want, got)
    assert compared and constant  # both kinds of leaf at this size
    assert not [b for b in bad if (family, b[0]) not in KEPT], (bad, small)
