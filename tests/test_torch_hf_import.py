"""The port's weight import against transformers and the JAX package.

A locally built random-init ``transformers.BertModel`` (no download),
saved as ``pytorch_model.bin`` (bare and under a ``bert.`` prefix) and as
``model.safetensors``: the port's ``TransformerPLM`` with the weights
imported reproduces ``BertModel``'s hidden states, and its weights equal
JAX's ``load_into_params`` result carried over. UniSRec artifacts, in
RecBole's layout and the full reference layout (written by the JAX
package's ``export_unisrec_state_dict``), graft into the port's
``UniSRec`` as ``load_unisrec_pretrained`` grafts them into JAX's tree;
the history-layout gate and shape checks refuse what JAX refuses. The
trainer applies ``--hf_checkpoint``, a local ``--pretrained_embedding``
and ``--unisrec_pretrained_path`` in JAX's order.
"""
import functools
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from miner_tpu.models import hf_import as jax_hf
from miner_tpu.models.news_encoder import NewsEncoderMoe as JaxNewsEncoderMoe
from miner_tpu.models.plm import PLMConfig as JaxPLMConfig
from miner_tpu.models.plm import TransformerPLM as JaxTransformerPLM
from miner_tpu.models.unisrec import UniSRec as JaxUniSRec
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.models import NewsEncoderMoe, PLMConfig, TransformerPLM, UniSRec
from miner_tpu_torch.models import hf_import
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

HF_SHAPE = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
                layer_norm_eps=1e-12, pad_token_id=0, position_offset=0)


def _bert(seed, **shape):
    from transformers import BertConfig, BertModel

    cfg = BertConfig(vocab_size=shape["vocab_size"], hidden_size=shape["hidden_size"],
                     num_hidden_layers=shape["num_layers"],
                     num_attention_heads=shape["num_heads"],
                     intermediate_size=shape["intermediate_size"],
                     max_position_embeddings=shape["max_position_embeddings"],
                     type_vocab_size=shape["type_vocab_size"], pad_token_id=0)
    torch.manual_seed(seed)
    return BertModel(cfg).eval()


def _save(model, d, fmt):
    """``model``'s state dict into the directory ``d`` as ``fmt``."""
    os.makedirs(d, exist_ok=True)
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(sd, os.path.join(d, "model.safetensors"))
    else:
        if fmt == "prefixed_bin":  # as BertFor* models save it
            sd = {f"bert.{k}": v for k, v in sd.items()}
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    return d


@pytest.fixture(scope="module")
def hf_model():
    return _bert(0, **HF_SHAPE)


@pytest.mark.parametrize("fmt", ["bin", "prefixed_bin", "safetensors"])
def test_imported_plm_matches_transformers_and_jax(hf_model, tmp_path, rng, fmt):
    """The imported tower's hidden states against ``BertModel``'s at every
    valid position (float32, 2e-4, the JAX package's own tolerance for this
    check), and its weights equal JAX's ``load_into_params`` tree carried
    over (bit for bit: the same copies, QKV fused q|k|v)."""
    d = _save(hf_model, str(tmp_path / fmt), fmt)
    plm = TransformerPLM(PLMConfig(**HF_SHAPE)).eval()
    hf_import.load_plm_into(plm, d)
    ids = rng.integers(1, 500, size=(3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[0, 8:] = 0
    with torch.no_grad():
        got = plm(torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
        want = hf_model(input_ids=torch.as_tensor(ids),
                        attention_mask=torch.as_tensor(mask)).last_hidden_state.numpy()
    np.testing.assert_allclose(got[0, :8], want[0, :8], atol=2e-4)
    np.testing.assert_allclose(got[1:], want[1:], atol=2e-4)
    jplm = JaxTransformerPLM(JaxPLMConfig(**HF_SHAPE))
    x = jnp.ones((1, 4), jnp.int32)
    jparams = jplm.init(jax.random.PRNGKey(0), x, x)["params"]
    want = params_from_jax(jax.device_get(jax_hf.load_into_params(jparams, d, plm_prefix="")))
    got = plm.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    q = hf_model.state_dict()["encoder.layer.1.attention.self.query.weight"]
    assert torch.equal(got["layers.1.attention.qkv.weight"][:32], q)


def test_plm_shape_mismatch_raises_naming_the_key(hf_model, tmp_path):
    d = _save(hf_model, str(tmp_path / "ckpt"), "bin")
    plm = TransformerPLM(PLMConfig(**{**HF_SHAPE, "hidden_size": 64}))
    with pytest.raises(ValueError, match=r"shape mismatch at plm\.embeddings"):
        hf_import.load_plm_into(plm, d)
    with pytest.raises(FileNotFoundError, match="no model weights"):
        hf_import.load_plm_into(plm, str(tmp_path))


# ------------------------------------------------------------ UniSRec .pth
H, D, E, PLM_D = 5, 24, 4, 64


@functools.lru_cache(maxsize=None)
def _jax_unisrec(seed, out_dim=D, experts=E, vocab=1024):
    """JAX's tiny UniSRec (by default the adaptor 64 -> 24 over 4 experts;
    5 history slots) and parameters from ``seed`` (cached: the callers only
    read them)."""
    model = JaxUniSRec(news_encoder=JaxNewsEncoderMoe(
        plm_cfg=JaxPLMConfig.tiny(vocab), adaptor_out_dim=out_dim, n_experts=experts),
        max_his_len=H)
    rng = np.random.default_rng(seed)
    B, C, L = 2, 3, 8
    batch = {"cand_title": rng.integers(1, 1000, size=(B, C, L)).astype(np.int32),
             "cand_title_mask": np.ones((B, C, L), np.int32),
             "his_title": rng.integers(1, 1000, size=(B, H, L)).astype(np.int32),
             "his_title_mask": np.ones((B, H, L), np.int32),
             "his_mask": np.ones((B, H), np.int32)}
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(seed),
                                  "gating": jax.random.PRNGKey(seed + 1)}, batch)["params"]
    return jax.device_get(params)


def _port_unisrec(params):
    model = UniSRec(NewsEncoderMoe(PLMConfig.tiny(), adaptor_out_dim=D, n_experts=E),
                    max_his_len=H)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _recbole(seed, pos_rows=H):
    """A RecBole-layout UniSRec state dict: the sequential encoder, its
    position table and LayerNorm, the adaptor's experts and gates, and a
    key neither model has."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)
    sd = {"position_embedding.weight": r(pos_rows, D), "LayerNorm.weight": r(D),
          "LayerNorm.bias": r(D), "some.unrelated.key": r(3)}
    for i in range(2):
        p = f"trm_encoder.layer.{i}."
        for nm in ("query", "key", "value", "dense"):
            sd[p + f"multi_head_attention.{nm}.weight"] = r(D, D)
            sd[p + f"multi_head_attention.{nm}.bias"] = r(D)
        for nm in ("multi_head_attention.LayerNorm", "feed_forward.LayerNorm"):
            sd[p + nm + ".weight"], sd[p + nm + ".bias"] = r(D), r(D)
        sd[p + "feed_forward.dense_1.weight"], sd[p + "feed_forward.dense_1.bias"] = r(256, D), r(256)
        sd[p + "feed_forward.dense_2.weight"], sd[p + "feed_forward.dense_2.bias"] = r(D, 256), r(D)
    for e in range(E):
        sd[f"moe_adaptor.experts.{e}.bias"] = r(PLM_D)
        sd[f"moe_adaptor.experts.{e}.lin.weight"] = r(D, PLM_D)
    sd["moe_adaptor.w_gate"], sd["moe_adaptor.w_noise"] = r(PLM_D, E), r(PLM_D, E)
    return sd


def _full(params, history_layout="clicks_first"):
    """The JAX package's full reference-layout export of ``params``."""
    return {k: torch.from_numpy(np.array(v)) for k, v in jax_hf.export_unisrec_state_dict(
        params, plm_name="roberta", history_layout=history_layout).items()}


def _assert_state_equal(model, params):
    want = params_from_jax(params)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("layout", ["recbole", "full"])
def test_load_unisrec_pretrained_matches_jax(tmp_path, layout):
    """Both artifact layouts graft into the port's ``UniSRec`` exactly as
    into JAX's tree (every tensor bit-equal after carrying JAX's merged
    tree over; the same count). RecBole's leaves the news tower alone and
    ignores the unrelated key; the full layout replaces the tower too."""
    params = _jax_unisrec(0)
    sd = _recbole(1) if layout == "recbole" else _full(_jax_unisrec(7))
    path = str(tmp_path / f"{layout}.pth")
    torch.save(sd, path)
    merged, n_want = jax_hf.load_unisrec_pretrained(params, path)
    model = _port_unisrec(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = hf_import.load_unisrec_pretrained(model, path)
    assert n == n_want > 0
    _assert_state_equal(model, merged)
    plm_moved = any(not torch.equal(v, before[k]) for k, v in model.state_dict().items()
                    if k.startswith("news_encoder.plm."))
    assert plm_moved == (layout == "full")
    if layout == "recbole":
        kernel = model.news_encoder.moe_adaptor.experts.kernel.detach()
        assert torch.equal(kernel[2], sd["moe_adaptor.experts.2.lin.weight"].T)
        qkv = model.trm_layers[0].attention.qkv.weight.detach()
        assert torch.equal(qkv[D:2 * D], sd["trm_encoder.layer.0.multi_head_attention.key.weight"])


@pytest.mark.parametrize("marker, legacy, force, match", [
    ("clicks_first", True, False, "history layout"),
    ("legacy", False, False, "history layout"),
    (None, False, False, "legacy_history_layout"),
    ("clicks_first", False, False, None),
    ("legacy", True, False, None),
    (None, True, False, None),
    (None, False, True, None),
    ("clicks_first", True, True, None),
])
def test_full_layout_gate_matches_jax(tmp_path, marker, legacy, force, match):
    """A full-layout artifact carries its history layout (or none, a
    reference-trained one): the port refuses it, or loads it, where JAX
    does, with the same key words in the message."""
    params = _jax_unisrec(0)
    path = str(tmp_path / "full.pth")
    torch.save(_full(_jax_unisrec(3), marker), path)
    model = _port_unisrec(params)
    if match is None:
        merged, n_want = jax_hf.load_unisrec_pretrained(params, path, legacy, force)
        assert hf_import.load_unisrec_pretrained(model, path, legacy, force) == n_want
        _assert_state_equal(model, merged)
        return
    with pytest.raises(ValueError, match=match):
        jax_hf.load_unisrec_pretrained(params, path, legacy, force)
    with pytest.raises(ValueError, match=match):
        hf_import.load_unisrec_pretrained(model, path, legacy, force)


def test_unisrec_shape_mismatch_raises(tmp_path):
    """A position table of 7 rows against the model's 5: both packages
    raise, naming the tensor; the model is left as it was."""
    params = _jax_unisrec(0)
    path = str(tmp_path / "bad.pth")
    torch.save(_recbole(1, pos_rows=7), path)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_hf.load_unisrec_pretrained(params, path)
    model = _port_unisrec(params)
    with pytest.raises(ValueError, match="shape mismatch at position_embedding"):
        hf_import.load_unisrec_pretrained(model, path)
    _assert_state_equal(model, params)


@pytest.mark.parametrize("name", ["miner", "fastformer", "unbert", "unisrec"])
def test_layout_gate_of_position_sensitive_models_matches_jax(name):
    assert hf_import.POSITION_SENSITIVE_MODELS == jax_hf.POSITION_SENSITIVE_MODELS
    assert hf_import.HISTORY_LAYOUT_MARKER == jax_hf.HISTORY_LAYOUT_MARKER
    refused = name in hf_import.POSITION_SENSITIVE_MODELS
    for legacy, force in ((False, False), (True, False), (False, True)):
        raises = refused and not legacy and not force
        for fn in (jax_hf.check_history_layout_for_transfer,
                   hf_import.check_history_layout_for_transfer):
            if raises:
                with pytest.raises(ValueError, match="legacy_history_layout"):
                    fn(name, legacy, force)
            else:
                fn(name, legacy, force)


# ----------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_hf")), num_lines=12)


@pytest.fixture(scope="module")
def tiny_hf_dir(tmp_path_factory):
    """A BertModel at the tiny preset's shapes over the hash tokenizer's
    1,000 ids, saved as ``pytorch_model.bin``."""
    shape = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=256, type_vocab_size=2)
    return _save(_bert(1, **shape), str(tmp_path_factory.mktemp("tiny_hf")), "bin")


def _train_flags(fixture, name, *extra):
    flags = ["--model_name", name, "--pretrained_tokenizer", "hash:1000",
             "--user2id_path", os.path.join(fixture, "user2id.json"),
             "--category2id_path", os.path.join(fixture, "category2id.json"),
             "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", str(H),
             "--seed", "7", "--plm_preset", "tiny", "--compute_dtype", "float32",
             "--train_behaviors_path", os.path.join(fixture, "behaviors.tsv"),
             "--train_news_path", os.path.join(fixture, "news.tsv")]
    if name == "unisrec":
        flags += ["--combine_type", "pre-concat"]
    return ["pretrain" if name == "pretrain" else "train", *flags, *extra]


@pytest.mark.parametrize("name, flag", [("miner", "--hf_checkpoint"),
                                        ("fastformer", "--pretrained_embedding"),
                                        ("unisrec", "--hf_checkpoint"),
                                        ("pretrain", "--pretrained_embedding")])
def test_trainer_imports_hf_weights_into_the_plm(fixture_dir, tiny_hf_dir, name, flag):
    """``--hf_checkpoint`` and a local ``--pretrained_embedding`` land in
    the PLM of every kind JAX gives them to (the pretrain kind's ``plm``,
    else ``news_encoder.plm``), equal to JAX's graft carried over; the rest
    of the model keeps its weights from the seed."""
    argv = _train_flags(fixture_dir, name, flag, tiny_hf_dir)
    tt = Trainer(make_parser().parse_args([*argv, "--device", "cpu"]))
    plm = (lambda m: m.plm) if name == "pretrain" else (lambda m: m.news_encoder.plm)
    got, fresh = tt.initial_model(), tt.build_model()
    want = params_from_jax(jax_hf.convert_plm_params(tiny_hf_dir, 2))  # JAX's graft
    assert plm(got).state_dict().keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(plm(got).state_dict()[k], v), k
    rest = [k for k in fresh.state_dict() if ".plm." not in f".{k}"]
    assert all(torch.equal(got.state_dict()[k], fresh.state_dict()[k]) for k in rest)
    assert bool(rest) == (name != "pretrain")  # the pretrain kind is its encoder alone


def test_hub_name_warns_and_unbert_takes_no_hf_weights(fixture_dir, tiny_hf_dir, caplog):
    """A ``--pretrained_embedding`` that is no local directory (a hub name)
    only warns; UnBERT takes no HF weights, as in JAX, and says so."""
    tt = Trainer(make_parser().parse_args(
        [*_train_flags(fixture_dir, "unisrec", "--pretrained_embedding", "bert-base-uncased"),
         "--device", "cpu"]))
    with caplog.at_level(logging.WARNING, logger="miner_tpu_torch"):
        model = tt.initial_model()
    assert "not a local checkpoint directory" in caplog.text
    assert all(torch.equal(v, tt.build_model().state_dict()[k])
               for k, v in model.state_dict().items())
    caplog.clear()
    ub = Trainer(make_parser().parse_args(
        [*_train_flags(fixture_dir, "unbert", "--hf_checkpoint", tiny_hf_dir), "--device", "cpu"]))
    with caplog.at_level(logging.WARNING, logger="miner_tpu_torch"):
        ub.initial_model()
    assert "not imported into UnBERT" in caplog.text


def test_trainer_grafts_in_jax_order(fixture_dir, tiny_hf_dir, tmp_path):
    """``--hf_checkpoint`` first, then ``--unisrec_pretrained_path``: a
    full-layout artifact's tower replaces the HF one (as JAX's order gives
    it); a RecBole one leaves the HF tower and grafts the adaptor and the
    sequential encoder; then one micro-batch trains."""
    tt = Trainer(make_parser().parse_args(
        [*_train_flags(fixture_dir, "unisrec", "--hf_checkpoint", tiny_hf_dir), "--device", "cpu"]))
    hf_plm = tt.initial_model().news_encoder.plm.state_dict()
    params = _jax_unisrec(9, out_dim=300, experts=8, vocab=1000)
    full = params_from_jax(params)
    path = str(tmp_path / "full.pth")
    torch.save(_full(params), path)  # the JAX package's export, clicks-first
    for artifact, plm_from_artifact in ((path, True), (_recbole_for(tt, tmp_path), False)):
        tt.args.unisrec_pretrained_path = artifact
        model = tt.initial_model()
        for k, v in model.news_encoder.plm.state_dict().items():
            want = full[f"news_encoder.plm.{k}"] if plm_from_artifact else hf_plm[k]
            assert torch.equal(v, want), k
        if plm_from_artifact:
            assert all(torch.equal(model.state_dict()[k], full[k]) for k in full)
    from miner_tpu_torch.data.batcher import Batcher
    from miner_tpu_torch.data.samplers import OnlineSampler

    store = tt._load_store(tt.args.train_news_path)
    log = tt._load_log(tt.args.train_behaviors_path, store)
    batch = next(Batcher(2).batches(OnlineSampler(log, store, 4, seed=7).sample_epoch(0)))
    opt = tt.make_optimizer(model.train(), 10, 1)
    assert torch.isfinite(tt.train_step(model, tt._make_table(store), batch, opt, 0))


def _recbole_for(tt, tmp_path):
    """A RecBole-layout artifact at the trainer's UniSRec shapes (300-wide
    tail over a 64-wide tower, 8 experts)."""
    g = torch.Generator().manual_seed(4)
    model = tt.build_model()
    sd = {"position_embedding.weight": torch.randn(H, 300, generator=g),
          "moe_adaptor.w_gate": torch.randn(64, 8, generator=g)}
    for e in range(8):
        sd[f"moe_adaptor.experts.{e}.bias"] = torch.randn(64, generator=g)
        sd[f"moe_adaptor.experts.{e}.lin.weight"] = torch.randn(300, 64, generator=g)
    path = str(tmp_path / "recbole.pth")
    torch.save(sd, path)
    assert hf_import.load_unisrec_pretrained(model, path) == 4
    return path
