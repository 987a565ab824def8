"""Checkpoints into and out of the port, held against the JAX package.

Reference state dicts (MrRobot2211/miner's layout): for the Miner (linear
combine), the Fastformer, UnBERT and UniSRec, a reference state dict is
made from seeded JAX parameters by the JAX package's ``export_*``; the
port's import must equal ``params_from_jax`` of the JAX package's import
tensor for tensor, and the port's export of the same weights must equal the
JAX package's export key for key, bit for bit. The lstm combine and the
history-layout gate are refused with the JAX package's words. The port's two
tools (``python -m miner_tpu_torch.tools.import_reference_checkpoint`` /
``export_to_reference``) write files that load strictly.

Orbax to port: a one-epoch JAX run of the tiny Miner (float32) with and
without ``--scan_layers`` goes through ``convert_jax_checkpoint.py``; the
port's ``eval --device cpu`` of the result gives the metrics of JAX's
end-of-epoch eval of the same weights, and the result carries the run's
training state. Resume: a two-epoch JAX run (float32, every dropout at 0)
is checkpointed at the end of its first epoch, converted, and resumed in the
port with ``--resume_from`` for the second; the port's micro-step losses
equal JAX's continuation to rtol 1e-5 / atol 1e-5 and its final parameters
JAX's to atol 1e-4 (the tolerances of the port's cross-framework and
mesh resume tests, ``tests/test_torch_his_cache.py`` and
``tests/test_torch_tp.py``: float32 in another summation order, amplified by
Adam), at an update boundary under ``--scan_layers``, mid-accumulation, and
under ``--freeze_transformer`` (whose frozen tensors stay bit for bit).
What cannot be carried is refused with its reason: a checkpoint of
parameters alone, another optimizer's state, and moments over other
trainable parameters than the resumed run's.
"""
import csv
import dataclasses as dc
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_checkpoint
import miner_tpu.training.trainer as jax_trainer
import miner_tpu_torch.training.trainer as port_trainer
from miner_tpu.config import make_parser as jax_parser
from miner_tpu.models import FastformerUserModel, Miner, NewsEncoder, UniSRec
from miner_tpu.models import hf_import as jax_hf
from miner_tpu.models.fastformer import FastformerConfig
from miner_tpu.models.news_encoder import NewsEncoderMoe
from miner_tpu.models.plm import PLMConfig
from miner_tpu.models.unbert import UNBert
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.models import hf_import
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.tools import export_to_reference, import_reference_checkpoint
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture


def _batch(cfg, sapo: bool):
    B, C, H, L = 2, 3, 4, 8
    rng = np.random.default_rng(0)
    ids = lambda shape: jnp.asarray(rng.integers(1, cfg.vocab_size, size=shape)  # noqa: E731
                                    .astype(np.int32))
    ones = lambda shape: jnp.ones(shape, jnp.int32)  # noqa: E731
    batch = {"cand_title": ids((B, C, L)), "cand_title_mask": ones((B, C, L)),
             "his_title": ids((B, H, L)), "his_title_mask": ones((B, H, L)),
             "cand_category": ids((B, C)) % 7, "his_category": ids((B, H)) % 7,
             "his_mask": ones((B, H))}
    if sapo:
        batch.update(cand_sapo=ids((B, C, L)), cand_sapo_mask=ones((B, C, L)),
                     his_sapo=ids((B, H, L)), his_sapo_mask=ones((B, H, L)))
    return batch


def _miner():
    cfg = PLMConfig.tiny()
    enc = NewsEncoder(plm_cfg=cfg, apply_reduce_dim=True, word_embed_dim=32,
                      use_sapo=True, combine_type="linear")
    model = Miner(news_encoder=enc, use_category_bias=True, num_context_codes=4,
                  context_code_dim=16, score_type="weighted", num_categories=7,
                  category_embed_dim=8, category_pad_id=0)
    return model.init(jax.random.PRNGKey(0), _batch(cfg, True))["params"]


def _fastformer():
    cfg = PLMConfig.tiny()
    enc = NewsEncoder(plm_cfg=cfg, apply_reduce_dim=True, word_embed_dim=32,
                      use_sapo=True, combine_type="linear")
    fcfg = FastformerConfig(hidden_size=32, num_heads=4, intermediate_size=32,
                            max_position_embeddings=16)
    model = FastformerUserModel(news_encoder=enc, cfg=fcfg)
    return model.init(jax.random.PRNGKey(1), _batch(cfg, True))["params"]


def _unbert():
    from miner_tpu.data.unbert_packing import SEQ_MAX_LEN

    cfg = dc.replace(PLMConfig.tiny(), type_vocab_size=2,
                     max_position_embeddings=SEQ_MAX_LEN + 2)
    model = UNBert(cfg=cfg, num_news_layers=1, news_mode="attention")
    B, L, S = 2, 32, 4
    rng = np.random.default_rng(0)
    feat = {"input_ids": jnp.asarray(rng.integers(1, cfg.vocab_size, size=(B, L))
                                     .astype(np.int32)),
            "input_mask": jnp.ones((B, L), jnp.int32),
            "segment_ids": jnp.zeros((B, L), jnp.int32),
            "news_segment_ids": jnp.zeros((B, L), jnp.int32),
            "sentence_ids": jnp.asarray(np.tile(np.arange(S, dtype=np.int32) * 4, (B, 1))),
            "sentence_mask": jnp.ones((B, S), jnp.int32)}
    return model.init(jax.random.PRNGKey(2), feat)["params"]


def _unisrec():
    cfg = PLMConfig.tiny()
    enc = NewsEncoderMoe(plm_cfg=cfg, use_sapo=False, combine_type="pre-concat",
                         n_experts=3, adaptor_out_dim=24)
    model = UniSRec(news_encoder=enc, max_his_len=4)
    batch = {k: v for k, v in _batch(cfg, False).items() if "category" not in k}
    return model.init({"params": jax.random.PRNGKey(3), "gating": jax.random.PRNGKey(4)},
                      batch)["params"]


# family: (JAX params, JAX convert, JAX export, port convert, port export)
FAMILIES = {
    "miner": (_miner, lambda sd: jax_hf.convert_miner_state_dict(sd, 2),
              jax_hf.export_miner_state_dict,
              lambda sd: hf_import.convert_miner_state_dict(sd, 2),
              hf_import.export_miner_state_dict),
    "fastformer": (_fastformer, lambda sd: jax_hf.convert_fastformer_state_dict(sd, 2),
                   jax_hf.export_fastformer_state_dict,
                   lambda sd: hf_import.convert_fastformer_state_dict(sd, 2),
                   hf_import.export_fastformer_state_dict),
    "unbert": (_unbert, jax_hf.convert_unbert_state_dict, jax_hf.export_unbert_state_dict,
               hf_import.convert_unbert_state_dict, hf_import.export_unbert_state_dict),
    "unisrec": (_unisrec, lambda sd: jax_hf.convert_unisrec_model_state_dict(sd, 2),
                jax_hf.export_unisrec_state_dict,
                lambda sd: hf_import.unisrec_model_state_dict(sd, 2),
                hf_import.export_unisrec_state_dict),
}


@pytest.fixture(scope="module")
def weights():
    """Per family: the JAX parameters (numpy) and JAX's reference export."""
    out = {}
    for name, (init, _, export, _, _) in FAMILIES.items():
        params = jax.tree_util.tree_map(np.asarray, init())
        out[name] = params, export(params)
    return out


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_equals_jax_import(weights, family):
    """A reference state dict into the port: params_from_jax of the JAX
    package's import, tensor for tensor (the history marker aside, which
    ``load_unisrec_pretrained`` pops)."""
    _, jax_convert, _, port_convert, _ = FAMILIES[family]
    sd = {k: v for k, v in weights[family][1].items() if k != hf_import.HISTORY_LAYOUT_MARKER}
    want = params_from_jax(jax_convert(sd))
    got = port_convert(_torch_sd(sd))
    assert got.keys() == want.keys() and len(got) > 20
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k].contiguous(), v), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_equals_jax_export(weights, family):
    """The port's weights (params_from_jax of the JAX tree) out to the
    reference: the JAX package's export, key for key, bit for bit."""
    params, want = weights[family]
    got = FAMILIES[family][4](params_from_jax(params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_lstm_combine_is_refused_in_the_words_of_jax():
    with pytest.raises(ValueError) as want:
        jax_hf.convert_miner_state_dict({"news_encoder.lstm.weight_ih_l0": np.zeros((4, 4))},
                                        num_layers=1)
    with pytest.raises(ValueError) as got:
        hf_import.convert_miner_state_dict(
            {"news_encoder.lstm.weight_ih_l0": torch.zeros(4, 4)}, num_layers=1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_hf.export_miner_state_dict({"news_encoder": {"lstm_combine": {}}})
    with pytest.raises(ValueError) as got:
        hf_import.export_miner_state_dict(
            {"news_encoder.lstm_combine.cells.0.ii.weight": torch.zeros(4, 4)})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", ["fastformer", "unbert", "unisrec"])
def test_history_layout_gate_is_jax_s(family):
    with pytest.raises(ValueError) as want:
        jax_hf.check_history_layout_for_transfer(family, False)
    with pytest.raises(ValueError) as got:
        hf_import.check_history_layout_for_transfer(family, False)
    assert str(got.value) == str(want.value)
    hf_import.check_history_layout_for_transfer(family, True)
    hf_import.check_history_layout_for_transfer("miner", False)


def test_tools_round_trip(weights, tmp_path):
    """import_reference_checkpoint on a bare reference state dict writes a
    port checkpoint of the port's names (no optimizer state);
    export_to_reference of it writes the reference file back, bit for
    bit."""
    sd = weights["miner"][1]
    ref = tmp_path / "bestAucModel.pt"
    torch.save(_torch_sd(sd), ref)
    port = tmp_path / "converted"
    import_reference_checkpoint.main(["--torch_ckpt", str(ref), "--num_layers", "2",
                                      "--out", str(port)])
    payload = checkpoint.load(str(port))
    assert "optimizer" not in payload
    want = params_from_jax(jax_hf.convert_miner_state_dict(sd, 2))
    assert payload["params"].keys() == want.keys()
    back = tmp_path / "exported.pt"
    export_to_reference.main(["--ckpt", str(port), "--out", str(back)])
    got = torch.load(back, weights_only=True)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError, match="position-sensitive"):
        import_reference_checkpoint.main(["--torch_ckpt", str(ref), "--model_name",
                                          "unisrec", "--out", str(port)])


# -------------------------------------------------------------- Orbax -> port
@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("convert")), num_lines=16)


def _flags(fixture, *extra):
    """tests/test_e2e.py's tiny Miner, float32, one epoch, evaluated on its
    own behaviors."""
    return ["--model_name", "Miner", "--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--eval_behaviors_path", os.path.join(fixture, "behaviors.tsv"),
            "--eval_news_path", os.path.join(fixture, "news.tsv"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--apply_reduce_dim", "--use_sapo",
            "--use_category_bias", "--word_embed_dim", "32", "--category_embed_dim", "8",
            "--num_context_codes", "4", "--context_code_dim", "16", "--score_type",
            "weighted", "--npratio", "3", "--eval_batch_size", "16",
            "--compute_dtype", "float32", "--metrics", "auc", "group_auc", "mrr",
            "ndcg@5", *extra]


@pytest.mark.parametrize("scan", [False, True])
def test_orbax_checkpoint_evaluates_in_the_port_as_in_jax(fixture_dir, tmp_path, scan):
    """JAX trains one epoch (with --scan_layers: its PLM's layers stacked
    under ``layers``) and evaluates at its end into bestAucModel; the
    converted checkpoint, evaluated by the port on the CPU, gives the same
    metrics to 1e-5 (float32 logits, summed in another order); the
    conversion keeps the run's arguments; --resume_from refuses it."""
    scan_flag = ["--scan_layers"] if scan else []
    JaxTrainer(jax_parser().parse_args([
        "train", *_flags(fixture_dir, *scan_flag),
        "--train_behaviors_path", os.path.join(fixture_dir, "behaviors.tsv"),
        "--train_news_path", os.path.join(fixture_dir, "news.tsv"),
        "--train_batch_size", "8", "--num_train_epochs", "1", "--learning_rate", "1e-3",
        "--train_path", str(tmp_path / "jax")])).train()
    (run,) = glob.glob(str(tmp_path / "jax" / "*"))
    with open(os.path.join(run, "eval.csv")) as f:
        want = {k: float(v) for k, v in list(csv.DictReader(f))[-1].items()
                if k not in ("epoch", "step", "loss") and v != ""}
    out = str(tmp_path / "bestAucModel.pt")
    assert convert_jax_checkpoint.main(["--ckpt", os.path.join(run, "ckpt", "bestAucModel"),
                                        "--out", out]) == 0
    payload = checkpoint.load(out)
    assert payload["args"]["scan_layers"] == scan
    assert "news_encoder.plm.layers.1.attention.qkv.weight" in payload["params"]
    got = Trainer(make_parser().parse_args([
        "eval", *_flags(fixture_dir), "--saved_model_path", out, "--device", "cpu",
        "--eval_path", str(tmp_path / "eval")])).eval()
    assert set(want) <= set(got) and "auc" in want
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-5), k
    # the run's training state came too (resumed against JAX below)
    assert payload["micro_step"] == 4 and payload["rng_seed"] == 8
    assert payload["optimizer"]["adamw"]["state"].keys() == payload["params"].keys()


# ---------------------------------------------------------- JAX -> port resume
# the micro-step of the kept checkpoint (of 4 micro-batches of 8 an epoch,
# the fixture's 32 train events), the accumulation and the JAX run's other
# flags: the first epoch's end at an update boundary (MultiSteps' mini_step
# 0); an eval at micro-step 5, two micro-batches into an accumulation of
# three (where a copied running mean would be half the sum), mid-epoch; the
# first epoch's end without MultiSteps
RESUME = {
    "update_boundary_scan_layers": (4, 2, ("--scan_layers",)),
    "mid_accumulation": (5, 3, ("--eval_steps", "5")),
    "freeze_transformer": (4, 1, ("--freeze_transformer",)),
}


def _no_dropout_cfg(make):
    return lambda *a, **k: dc.replace(make(*a, **k), hidden_dropout=0.0,
                                      attention_dropout=0.0)


def _losses(run_dir):
    with open(os.path.join(run_dir, "loss.csv")) as f:
        return {int(r["step"]): float(r["loss"]) for r in csv.DictReader(f)}


@pytest.mark.parametrize("case", sorted(RESUME))
def test_a_converted_jax_checkpoint_resumes_as_jax_continues(fixture_dir, tmp_path,
                                                             monkeypatch, case):
    """JAX trains two epochs and its state at the eval of micro-step 4 or 5
    is kept as a checkpoint; converted, the port resumes it for
    the second epoch: each micro-step's loss and the final parameters are
    JAX's. The carried state: AdamW's moments and step, the schedule's
    count, MultiSteps' partial sum (``mini_step`` times optax's running
    mean), the micro-step and the dropout seed."""
    for module in (jax_trainer, port_trainer):
        monkeypatch.setattr(module, "plm_config", _no_dropout_cfg(module.plm_config))
    AT, accum, extra = RESUME[case]
    maybe_checkpoint = JaxTrainer._maybe_checkpoint

    def keep_at(self, ckpt, state, *rest):  # every eval's state, whether it improved or not
        if int(state.step) == AT:
            ckpt.save("resume_point", jax_trainer._ckpt_payload(state))
        return maybe_checkpoint(self, ckpt, state, *rest)

    monkeypatch.setattr(JaxTrainer, "_maybe_checkpoint", keep_at)
    flags = [*_flags(fixture_dir, "--gradient_accumulation_steps", str(accum), *extra),
             "--train_behaviors_path", os.path.join(fixture_dir, "behaviors.tsv"),
             "--train_news_path", os.path.join(fixture_dir, "news.tsv"),
             "--train_batch_size", "8", "--num_train_epochs", "2",
             "--learning_rate", "1e-3", "--dropout", "0", "--logging_steps", "1"]
    JaxTrainer(jax_parser().parse_args(["train", *flags,
                                        "--train_path", str(tmp_path / "jax")])).train()
    (run,) = glob.glob(str(tmp_path / "jax" / "*"))
    out = str(tmp_path / "resume_point.pt")
    assert convert_jax_checkpoint.main(["--ckpt", os.path.join(run, "ckpt", "resume_point"),
                                        "--out", out]) == 0
    payload = checkpoint.load(out)
    opt = payload["optimizer"]
    assert payload["micro_step"] == AT and payload["rng_seed"] == 8
    assert (opt["updates"], opt["mini_step"]) == (AT // accum, AT % accum)
    assert (payload["grad_acc"] is None) == (AT % accum == 0)
    frozen = {k for k in payload["params"] if ".plm." in k} if "freeze" in case else set()
    assert opt["adamw"]["state"].keys() == payload["params"].keys() - frozen
    assert bool(frozen) == ("freeze" in case)
    train = ["train", *flags, "--device", "cpu", "--resume_from", out]
    if frozen:  # moments over other trainable parameters: refused, named
        unfrozen = [f for f in train if f != "--freeze_transformer"]
        with pytest.raises(ValueError, match="not over this run's trainable parameters"):
            Trainer(make_parser().parse_args([*unfrozen, "--train_path",
                                               str(tmp_path / "refused")])).train()
    resumed = Trainer(make_parser().parse_args([*train, "--train_path",
                                                str(tmp_path / "port")])).train()
    assert resumed.step == 8
    want, got = _losses(run), _losses(resumed.run_dir)
    assert sorted(got) == [s for s in sorted(want) if s > AT] and len(got) == 8 - AT
    np.testing.assert_allclose([got[s] for s in sorted(got)], [want[s] for s in sorted(got)],
                               rtol=1e-5, atol=1e-5)
    final = convert_jax_checkpoint.convert(os.path.join(run, "ckpt", "finalModel"))["params"]
    state = resumed.model.state_dict()
    assert state.keys() == final.keys()
    for k, v in final.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0, atol=1e-4, err_msg=k)
    for k in frozen:
        assert torch.equal(state[k], payload["params"][k]), k


def test_what_cannot_be_carried_is_refused(fixture_dir, tmp_path, weights):
    """A JAX checkpoint of parameters alone, or one whose optimizer is not
    the JAX package's clip + adamw chain (an SGD-with-momentum state here),
    converts for eval and serving, and ``--resume_from`` refuses it with
    the reason."""
    params = weights["miner"][0]
    sgd = {"params": params, "step": np.int32(4), "rng": np.array([0, 8], np.uint32),
           "opt_state": [None, {"trace": params}]}
    cases = {"parameters alone": convert_jax_checkpoint.payload_of(params),
             "0 Adam states": convert_jax_checkpoint.payload_of(sgd)}
    for why, payload in cases.items():
        assert "optimizer" not in payload and why in payload["not_resumable"]
        path = str(tmp_path / "converted.pt")
        checkpoint.save(path, payload)
        with pytest.raises(ValueError, match=f"holds no optimizer state \\(.*{why}"):
            Trainer(make_parser().parse_args([
                "train", *_flags(fixture_dir), "--device", "cpu",
                "--train_behaviors_path", os.path.join(fixture_dir, "behaviors.tsv"),
                "--train_news_path", os.path.join(fixture_dir, "news.tsv"),
                "--train_batch_size", "8", "--train_path", str(tmp_path / "port"),
                "--resume_from", path])).train()
