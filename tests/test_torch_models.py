"""The port's models against the JAX package's, on the same weights.

The JAX modules are initialised from a seed, their parameter trees are
carried over with ``miner_params_from_jax`` and loaded strictly into the
port's modules, and both run the same numpy inputs in float32 with dropout
off. Tolerances are float32 summation-order noise through a few layers.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

import jax

from miner_tpu.models.miner import Miner as JaxMiner
from miner_tpu.models.news_encoder import NewsEncoder as JaxNewsEncoder
from miner_tpu.models.plm import PLMConfig as JaxPLMConfig
from miner_tpu.models.plm import TransformerPLM as JaxPLM
from miner_tpu_torch.models import Miner, NewsEncoder, PLMConfig, TransformerPLM
from miner_tpu_torch.models.convert import miner_params_from_jax

VOCAB, LT, LS = 100, 12, 16
TOL = dict(rtol=1e-4, atol=2e-5)
T = torch.from_numpy


def _cfgs(offset: int = 0, gelu_approx: bool = False):
    kw = dict(position_offset=offset, pad_token_id=max(0, offset - 1),
              gelu_approx=gelu_approx)
    return (dc.replace(JaxPLMConfig.tiny(VOCAB), **kw),
            dc.replace(PLMConfig.tiny(VOCAB), **kw))


def _tokens(rng, n, L):
    ids = rng.integers(4, VOCAB, size=(n, L)).astype(np.int32)
    lengths = rng.integers(2, L + 1, size=(n,))
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _load(module, params):
    result = module.load_state_dict(miner_params_from_jax(jax.device_get(params)),
                                    strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return module.eval()


@pytest.mark.parametrize("offset, gelu_approx", [(0, False), (2, True)])
def test_transformer_plm_matches_jax(rng, offset, gelu_approx):
    jcfg, tcfg = _cfgs(offset, gelu_approx)
    ids, mask = _tokens(rng, 3, LS)
    jplm = JaxPLM(jcfg)
    params = jplm.init(jax.random.PRNGKey(0), ids, mask)["params"]
    want = np.asarray(jplm.apply({"params": params}, ids, mask))
    with torch.no_grad():
        got = _load(TransformerPLM(tcfg), params)(T(ids), T(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_news_encoder_matches_jax(rng):
    jcfg, tcfg = _cfgs()
    t, tm = _tokens(rng, 5, LT)
    s, sm = _tokens(rng, 5, LS)
    jenc = JaxNewsEncoder(plm_cfg=jcfg, word_embed_dim=16, dropout=0.0)
    params = jenc.init(jax.random.PRNGKey(1), t, tm, s, sm)["params"]
    want = np.asarray(jenc.apply({"params": params}, t, tm, s, sm))
    with torch.no_grad():
        enc = _load(NewsEncoder(tcfg, word_embed_dim=16), params)
        got = enc(T(t), T(tm), T(s), T(sm)).numpy()
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, want, **TOL)


def _miner_pair(score_type: str):
    jcfg, tcfg = _cfgs()
    common = dict(use_category_bias=True, num_context_codes=4,
                  context_code_dim=8, score_type=score_type,
                  num_categories=6, category_embed_dim=5, category_pad_id=0)
    jax_model = JaxMiner(
        news_encoder=JaxNewsEncoder(plm_cfg=jcfg, word_embed_dim=16, dropout=0.0),
        dropout=0.0, **common)
    return jax_model, Miner(NewsEncoder(tcfg, word_embed_dim=16), **common)


@pytest.mark.parametrize("score_type", ["max", "mean", "weighted"])
def test_miner_encode_and_tail_match_jax(rng, score_type):
    B, C, H = 2, 3, 5
    jax_model, model = _miner_pair(score_type)
    batch = {}
    for side, n in (("cand", C), ("his", H)):
        for field, L in (("title", LT), ("sapo", LS)):
            ids, mask = _tokens(rng, B * n, L)
            batch[f"{side}_{field}"] = ids.reshape(B, n, L)
            batch[f"{side}_{field}_mask"] = mask.reshape(B, n, L)
    batch["cand_category"] = rng.integers(1, 6, size=(B, C)).astype(np.int32)
    his_cat = rng.integers(1, 6, size=(B, H)).astype(np.int32)
    his_cat[:, 3:] = 0  # padded history slots: pad category, pad news
    batch["his_category"] = his_cat
    batch["his_mask"] = (his_cat != 0).astype(np.int32)
    params = jax_model.init(jax.random.PRNGKey(2), batch)["params"]
    model = _load(model, params)

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    enc_args = [flat(batch[k]) for k in ("his_title", "his_title_mask",
                                         "his_sapo", "his_sapo_mask")]
    want_his = np.asarray(jax_model.apply({"params": params}, *enc_args,
                                          method=JaxMiner.encode_news))
    cand_repr = np.random.default_rng(3).normal(size=(B, C, 16)).astype(np.float32)
    his_repr = np.array(want_his).reshape(B, H, 16)  # a writable copy
    tail_args = (cand_repr, his_repr, batch["cand_category"], his_cat,
                 batch["his_mask"])
    want_int, want_match = jax_model.apply({"params": params}, *tail_args,
                                           method=JaxMiner.tail)
    with torch.no_grad():
        got_his = model.encode_news(*map(T, enc_args)).numpy()
        got_int, got_match = model.tail(*map(T, tail_args))
    np.testing.assert_allclose(got_his, want_his, **TOL)
    assert np.isfinite(got_match.numpy()).all()
    np.testing.assert_allclose(got_int.numpy(), np.asarray(want_int), **TOL)
    np.testing.assert_allclose(got_match.numpy(), np.asarray(want_match), **TOL)


def test_category_pad_row_is_exactly_zero_and_bias_finite():
    _, model = _miner_pair("weighted")
    model.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 2, 0]])
    emb = model.category_embedding(ids)
    assert torch.equal(emb[0, 0], torch.zeros(5)) and emb[0, 1].abs().sum() > 0
    bias = model.category_bias_from_ids(ids, torch.tensor([[1, 0]]))
    assert torch.isfinite(bias).all() and bias[0, 0].abs().sum() == 0


def test_carry_over_layouts():
    """Dense kernels transpose, the fused qkv keeps q|k|v row order, Embed
    and LayerNorm tables rename, the layer stack re-indexes."""
    qkv = np.arange(6 * 2, dtype=np.float32).reshape(2, 6)
    state = miner_params_from_jax({
        "plm": {"layer_3": {"attention": {"qkv": {"kernel": qkv,
                                                  "bias": np.zeros(6)}},
                            "ffn_ln": {"scale": np.ones(2), "bias": np.zeros(2)}},
                "embeddings": {"word_embeddings": {"embedding": np.ones((4, 2))}}},
        "poly_attn": {"proj_kernel": np.ones((2, 3))},
    })
    assert sorted(state) == [
        "plm.embeddings.word_embeddings.weight",
        "plm.layers.3.attention.qkv.bias", "plm.layers.3.attention.qkv.weight",
        "plm.layers.3.ffn_ln.bias", "plm.layers.3.ffn_ln.weight",
        "poly_attn.proj_kernel"]
    np.testing.assert_array_equal(state["plm.layers.3.attention.qkv.weight"].numpy(),
                                  qkv.T)
    assert state["poly_attn.proj_kernel"].shape == (2, 3)
