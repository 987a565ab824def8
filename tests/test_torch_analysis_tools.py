"""The port's analysis tools (``miner_tpu_torch/tools``: warmstart_ab,
unisrec_contract, unisrec_diag, quality_trajectory) held against the JAX
package's ``tools/``.

- The trainer argvs of ``warmstart_ab`` (both artifacts, warm and cold) and
  of ``unisrec_contract`` (stage A, the baseline, stage C), parsed by the
  port's ``make_parser`` on ``--device cpu``, equal JAX's, parsed by JAX's,
  on every key both have (the JAX tools run with their ``Trainer`` replaced
  by a recorder).
- ``export_hf_checkpoint`` (a pretrain run's ``plm.*`` root and a whole
  model's ``news_encoder.plm.*``) and ``export_recbole`` of a port
  checkpoint write the keys and the bits JAX's write from an Orbax
  checkpoint of the same parameters (``miner_params_from_jax``).
- ``unisrec_diag.make_batch`` draws JAX's batch byte for byte, and ``run``
  in deterministic training from JAX's init gives JAX's final loss (1e-4
  relative) and holdout accuracy after 10 steps, in each mode.
- The trajectory leg at dropout 0 from a shared init gives, step for step,
  the loss and the gradient norm before the clip of a loop of the JAX
  pieces ``run_jax_leg`` calls (1e-5 relative); ``analyze`` gives JAX's
  report with the leg names mapped.
- ``run_jax_warmstart_legs.py`` (the JAX package's arms and donor from
  the port tool's corpus) builds, with JAX's ``Trainer`` recording, the
  argvs the port's ``warmstart_ab`` builds for its donor and each seed's
  warm and cold runs, on every shared key, the warm ones with the given
  donor as ``--pretrained_embedding``.
- Each tool's ``main`` runs end to end on ``--device cpu`` at the smallest
  size; ``warmstart_ab`` writes no report unless asked, prints its donor's
  eval (trained or reused), and tallies learned arms with ``--tally``.
"""
import dataclasses as dc
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import miner_tpu_torch.training.trainer as port_trainer
from miner_tpu_torch.config import make_parser as port_parser
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.tools import quality_trajectory, unisrec_contract, unisrec_diag
from miner_tpu_torch.tools import warmstart_ab
from miner_tpu_torch.training import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --no-fused_kernels: the JAX tools pass it with float32; the port's CPU leg
# passes it too (leg_extra), and --device, which JAX's parser lacks
DEVICE = {"device"}
EVAL_CSV = "epoch,step,auc,group_auc,mrr,ndcg@5,ndcg@10\n0,1,0.5,0.5,0.5,0.5,0.5\n"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: the tier-1 suite runs six
    xdist workers on one CPU, where each worker's intra-op threads
    oversubscribe it and the many small ops of the plain Philox dropout
    slow by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_dropout_cfg(make):
    return lambda *a, **k: dc.replace(make(*a, **k), hidden_dropout=0.0,
                                      attention_dropout=0.0)


def _common(jax_ns, port_ns, skip=()):
    j, p = vars(jax_ns), vars(port_ns)
    keys = sorted((set(j) & set(p)) - set(skip))
    return keys, {k: (j[k], p[k]) for k in keys if j[k] != p[k]}


def _rebase(jax_ns, port_ns, jax_root, port_root):
    """Each path of the port's run under its tool's --out, checked against
    JAX's under its own, then set to JAX's."""
    for k, v in vars(port_ns).items():
        if isinstance(v, str) and v.startswith(port_root):
            assert os.path.relpath(v, port_root) == \
                os.path.relpath(getattr(jax_ns, k), jax_root), k
            setattr(port_ns, k, getattr(jax_ns, k))


def _fake_run(run_dir_root, seen, parse):
    """A trainer stand-in: records the parsed argv and writes what the
    tools read back (a run directory with ``eval.csv`` and a
    ``finalModel``)."""
    def train(args):
        seen.append(args)
        rd = os.path.join(run_dir_root(args), "20000101-000000")
        os.makedirs(os.path.join(rd, "ckpt"), exist_ok=True)
        open(os.path.join(rd, "ckpt", "finalModel"), "w").close()
        with open(os.path.join(rd, "eval.csv"), "w") as f:
            f.write(EVAL_CSV)
        return 1.0
    return lambda argv: train(parse(argv))


class _JaxRecorder:
    seen = []

    def __init__(self, args):
        self.args = args
        _JaxRecorder.seen.append(args)

    def train(self):
        rd = os.path.join(self.args.train_path, "20000101-000000")
        os.makedirs(os.path.join(rd, "ckpt", "finalModel"), exist_ok=True)
        with open(os.path.join(rd, "eval.csv"), "w") as f:
            f.write(EVAL_CSV)


@pytest.fixture
def jax_recorder(monkeypatch):
    import miner_tpu.training.trainer as jax_trainer

    _JaxRecorder.seen = []
    monkeypatch.setattr(jax_trainer, "Trainer", _JaxRecorder)
    return _JaxRecorder


# ---------------------------------------------------------------- argvs
CORPUS = ["--events", "40", "--news", "60", "--eval_lines", "8"]


@pytest.mark.parametrize("artifact", ["contrastive", "domain"])
def test_warmstart_argv_matches_jax(tmp_path, monkeypatch, jax_recorder, artifact):
    """The artifact's run and each seed's warm and cold runs."""
    from tools import warmstart_ab as jax_ws

    flags = ["--artifact", artifact, "--seeds", "13", "14", *CORPUS]
    monkeypatch.setattr(jax_ws, "export_hf_checkpoint", lambda ckpt, d: d)
    monkeypatch.setattr(sys, "argv", ["warmstart_ab.py", "--out", str(tmp_path / "jax"),
                                      "--report", str(tmp_path / "jax.md"), *flags])
    jax_ws.main()
    port_seen = []
    monkeypatch.setattr(warmstart_ab, "run_cli", _fake_run(
        lambda a: a.train_path, port_seen, lambda argv: port_parser().parse_args(argv)))
    monkeypatch.setattr(warmstart_ab, "export_hf_checkpoint", lambda ckpt, d: d)
    report = str(tmp_path / "port.md")
    warmstart_ab.main(["--out", str(tmp_path / "port"), "--device", "cpu", "--report", report,
                       *flags])
    with open(report) as f:  # asked for: the rows appended
        assert f.read().count(" seed=1") == 4
    jax_seen = jax_recorder.seen
    assert len(jax_seen) == len(port_seen) == 5
    for j, p in zip(jax_seen, port_seen):
        _rebase(j, p, str(tmp_path / "jax"), str(tmp_path / "port"))
        keys, diff = _common(j, p, DEVICE)
        assert len(keys) > 50 and not diff, diff
        assert p.device == "cpu" and p.compute_dtype == "float32" and p.fused_kernels is False
    assert [ns.mode for ns in port_seen] == (["pretrain"] if artifact == "contrastive"
                                             else ["train"]) + ["train"] * 4
    assert [bool(ns.pretrained_embedding) for ns in port_seen[1:]] == [True, False] * 2


def test_jax_warmstart_legs_argv_matches_port(tmp_path, monkeypatch, jax_recorder):
    """JAX's donor (``--train_donor``) and its arms from a given donor
    (``--donor``), on the corpus the port's tool wrote: the port's argvs on
    every shared key; the runs under their own directories."""
    import run_jax_warmstart_legs as legs
    from tools import warmstart_ab as jax_ws

    out = str(tmp_path / "ws")
    port_seen = []
    monkeypatch.setattr(warmstart_ab, "run_cli", _fake_run(
        lambda a: a.train_path, port_seen, lambda argv: port_parser().parse_args(argv)))
    monkeypatch.setattr(warmstart_ab, "export_hf_checkpoint", lambda ckpt, d: d)
    warmstart_ab.main(["--out", out, "--artifact", "domain", "--device", "cpu",
                       "--seeds", "13", "14", *CORPUS])
    monkeypatch.setattr(jax_ws, "export_hf_checkpoint", lambda ckpt, d: d)
    donor = str(tmp_path / "donor")
    res = legs.main(["--out", out, "--train_donor", "--seeds"])
    assert res["hf_dir"] == os.path.join(out, "jax_hf_domain")
    rows = legs.main(["--out", out, "--donor", donor, "--label", "x", "--seeds", "13", "14"])
    assert [r[0] for r in rows["rows"]] == ["jax-x_warm seed=13", "jax_cold seed=13",
                                            "jax-x_warm seed=14", "jax_cold seed=14"]
    jax_seen = jax_recorder.seen
    assert len(jax_seen) == len(port_seen) == 5
    runs = ["domain_pre", "warm-domain_13", "cold_13", "warm-domain_14", "cold_14"]
    jax_runs = ["jax_domain_pre", "jax-x_warm_13", "jax_cold_13", "jax-x_warm_14",
                "jax_cold_14"]
    for j, p, run, jax_run in zip(jax_seen, port_seen, runs, jax_runs):
        keys, diff = _common(j, p, DEVICE | {"train_path", "pretrained_embedding"})
        assert len(keys) > 50 and not diff, diff
        assert p.train_path == os.path.join(out, run, "train")
        assert j.train_path == os.path.join(out, jax_run, "train")
        assert j.pretrained_embedding == (os.path.abspath(donor) if p.pretrained_embedding
                                          else None)
    assert jax_seen[0].train_news_path == os.path.join(out, "domain_data", "news.tsv")
    assert jax_seen[1].train_news_path == os.path.join(out, "data", "news.tsv")


def test_unisrec_contract_argv_matches_jax(tmp_path, monkeypatch, jax_recorder):
    """Stage A (warm-started), the stage C baseline at lr 0 and stage C."""
    from tools import unisrec_contract as jax_contract

    flags = ["--plm_preset", "tiny", "--stage_c_baseline", "--stage_a_epochs", "1",
             "--stage_c_epochs", "1", "--stage_a_pretrained_embedding", "hf", "--batch", "8",
             *CORPUS]
    monkeypatch.setattr(jax_contract, "export_recbole", lambda ckpt, pth: 7)
    monkeypatch.setattr(sys, "argv", ["unisrec_contract.py", "--out", str(tmp_path / "jax"),
                                      *flags])
    monkeypatch.setattr(jax_contract, "PLM_PRESET", jax_contract.PLM_PRESET)
    jax_contract.main()
    port_seen = []
    monkeypatch.setattr(unisrec_contract, "run_stage", _fake_run(
        lambda a: a.train_path, port_seen, lambda argv: port_parser().parse_args(argv)))
    monkeypatch.setattr(unisrec_contract, "export_recbole", lambda ckpt, pth: 7)
    res = unisrec_contract.main(["--out", str(tmp_path / "port"), "--device", "cpu", *flags])
    assert res["exported"] == 7 and sorted(res) == ["a", "baseline", "c", "exported"]
    jax_seen = jax_recorder.seen
    assert len(jax_seen) == len(port_seen) == 3
    for j, p in zip(jax_seen, port_seen):
        _rebase(j, p, str(tmp_path / "jax"), str(tmp_path / "port"))
        keys, diff = _common(j, p, DEVICE)
        assert len(keys) > 50 and not diff, diff
        assert p.device == "cpu" and p.model_name == "unisrec"
    assert [ns.learning_rate for ns in port_seen] == [3e-4, 0.0, 1e-4]
    assert port_seen[0].unisrec_train_all and not port_seen[2].unisrec_train_all


# ---------------------------------------------------------------- exports
@pytest.fixture(scope="module")
def jax_unisrec_params():
    """JAX's init of the diagnostic's UniSRec (tools/unisrec_diag.py:106-113)
    at SASRec dropout 0.5: a whole model whose tower sits under
    ``news_encoder.plm``, whose news encoder roots at ``plm``."""
    return _jax_init(0.5)


def _jax_init(seq_dropout, seed=0):
    import jax

    import miner_tpu.models.unisrec as uni
    from miner_tpu.models.news_encoder import NewsEncoderMoe
    from miner_tpu.models.plm import PLMConfig
    from tools import unisrec_diag as jax_diag

    orig = uni.sasrec_encoder_cfg
    uni.sasrec_encoder_cfg = lambda h=300: dc.replace(
        orig(h), hidden_dropout=seq_dropout, attention_dropout=seq_dropout)
    try:
        model = uni.UniSRec(news_encoder=NewsEncoderMoe(
            plm_cfg=PLMConfig.tiny(vocab_size=jax_diag.VOCAB)), max_his_len=jax_diag.H)
        batch, _ = jax_diag.make_batch(np.random.default_rng(seed))
        params = model.init({"params": jax.random.PRNGKey(seed),
                             "dropout": jax.random.PRNGKey(1),
                             "gating": jax.random.PRNGKey(2)},
                            batch, deterministic=True)["params"]
    finally:
        uni.sasrec_encoder_cfg = orig
    return jax.device_get(params)


def _both_checkpoints(tmp_path, params, name):
    from miner_tpu.training.checkpoint import CheckpointManager

    manager = CheckpointManager(str(tmp_path / "orbax"))
    manager.save(name, {"params": params})
    manager.wait()
    port = str(tmp_path / f"{name}.pt")
    checkpoint.save(port, {"params": params_from_jax(params)})
    return os.path.join(str(tmp_path / "orbax"), name), port


def _assert_bit_equal(jax_file, port_file):
    want, got = torch.load(jax_file), torch.load(port_file)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    return len(want)


@pytest.mark.parametrize("root", ["plm", "news_encoder.plm"])
def test_export_hf_checkpoint_bit_equal_to_jax(tmp_path, jax_unisrec_params, root):
    from tools import warmstart_ab as jax_ws

    params = jax_unisrec_params["news_encoder"] if root == "plm" else jax_unisrec_params
    jax_ckpt, port_ckpt = _both_checkpoints(tmp_path, params, "finalModel")
    jax_ws.export_hf_checkpoint(jax_ckpt, str(tmp_path / "hf_jax"))
    warmstart_ab.export_hf_checkpoint(port_ckpt, str(tmp_path / "hf_port"))
    n = _assert_bit_equal(str(tmp_path / "hf_jax" / "pytorch_model.bin"),
                          str(tmp_path / "hf_port" / "pytorch_model.bin"))
    assert n == 5 + 2 * 16  # the embeddings and two BERT layers


def test_export_recbole_bit_equal_to_jax(tmp_path, jax_unisrec_params):
    from tools import unisrec_contract as jax_contract

    jax_ckpt, port_ckpt = _both_checkpoints(tmp_path, jax_unisrec_params, "finalModel")
    n_jax = jax_contract.export_recbole(jax_ckpt, str(tmp_path / "jax.pth"))
    n_port = unisrec_contract.export_recbole(port_ckpt, str(tmp_path / "port.pth"))
    assert n_port == n_jax == _assert_bit_equal(str(tmp_path / "jax.pth"),
                                                str(tmp_path / "port.pth"))


# ---------------------------------------------------------------- unisrec_diag
def test_diag_make_batch_byte_equal():
    from tools import unisrec_diag as jax_diag

    jr, pr = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):  # the generators stay in step
        (jb, jl), (pb, pl) = jax_diag.make_batch(jr), unisrec_diag.make_batch(pr)
        assert sorted(jb) == sorted(pb)
        for k in jb:
            a = np.asarray(jb[k])
            assert a.dtype == pb[k].dtype and a.shape == pb[k].shape, k
            assert a.tobytes() == pb[k].tobytes(), k
        assert np.asarray(jl).tobytes() == pl.tobytes()


@pytest.mark.parametrize("mode", unisrec_diag.MODES)
def test_diag_run_matches_jax(mode):
    """Deterministic training from JAX's init, 10 steps (``reattach``: 10 of
    bypass, then 10 of the whole model)."""
    from tools import unisrec_diag as jax_diag

    jax_loss, jax_acc = jax_diag.run(0.5, True, 1e-3, 10, mode=mode)
    loss, acc = unisrec_diag.run(0.5, True, 1e-3, 10, mode=mode, device="cpu",
                                 init_state=params_from_jax(_jax_init(0.5)))
    assert abs(loss - jax_loss) <= 1e-4 * abs(jax_loss), (loss, jax_loss)
    assert acc == jax_acc


# ---------------------------------------------------------------- trajectory
def _jax_trajectory(data_dir, init_seed, steps):
    """A loop of the pieces of the JAX tool's ``run_jax_leg``
    (tools/quality_trajectory.py:236-274) at the tiny preset, deterministic:
    its per-step loss and global gradient norm, and its init."""
    import jax
    import jax.numpy as jnp
    import optax

    from miner_tpu.config import plm_config
    from miner_tpu.data import BehaviorsLog, HashTokenizer, NewsStore
    from miner_tpu.data.batcher import Batcher
    from miner_tpu.data.device_table import NewsTable
    from miner_tpu.data.samplers import OfflineSampler
    from miner_tpu.models import Miner, NewsEncoder
    from miner_tpu.training import losses
    from miner_tpu.training.optim import make_optimizer

    g = quality_trajectory.geometry(init_seed, preset="tiny")
    tok = HashTokenizer(vocab_size=g["VOCAB"])
    cat2id = json.load(open(os.path.join(data_dir, "category2id.json")))
    user2id = json.load(open(os.path.join(data_dir, "user2id.json")))
    store = NewsStore.from_tsv(os.path.join(data_dir, "news.tsv"), tok, cat2id, g["LT"], 24)
    log = BehaviorsLog.from_tsv(os.path.join(data_dir, "behaviors.tsv"), store, user2id, g["H"])
    table = NewsTable.from_store(store, use_sapo=True)
    sampler = OfflineSampler(log, store, g["NPRATIO"], seed=init_seed)
    batcher = Batcher(g["BATCH"], drop_last=True, shuffle=True, seed=init_seed)
    encoder = NewsEncoder(plm_cfg=plm_config("tiny", vocab_size=g["VOCAB"]),
                          apply_reduce_dim=True, word_embed_dim=g["D_WORD"], use_sapo=True,
                          combine_type="linear", dropout=0.2, dtype=jnp.float32)
    model = Miner(news_encoder=encoder, use_category_bias=True, num_context_codes=g["K"],
                  context_code_dim=g["P_DIM"], score_type="weighted", dropout=0.2,
                  num_categories=int(store.flat_category().max()) + 1,
                  category_embed_dim=g["D_CAT"], category_pad_id=store.category_pad_id,
                  dtype=jnp.float32)
    ex = next(batcher.batches(sampler.sample_epoch(0)))
    params = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        table.lookup(jnp.asarray(ex["cand_idx"]),
                                     jnp.asarray(ex["his_idx"])))["params"]
    init = jax.device_get(params)
    total = batcher.num_batches(log.num_events) * g["EPOCHS"]
    tx = make_optimizer(params, learning_rate=g["LR"], total_steps=total,
                        warmup_steps=int(total * g["WARMUP_RATIO"]), weight_decay=g["WD"],
                        max_grad_norm=g["CLIP"])
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, cand_idx, his_idx, label):
        mb = table.lookup(cand_idx, his_idx)

        def loss_fn(p):
            interests, logits = model.apply({"params": p}, mb, deterministic=True)
            return losses.miner_loss(interests, logits, label)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, optax.global_norm(grads)

    rows = []
    for epoch in range(g["EPOCHS"]):
        for batch in batcher.batches(sampler.sample_epoch(epoch), epoch):
            if len(rows) == steps:
                return rows, init
            params, opt_state, loss, gnorm = train_step(
                params, opt_state, jnp.asarray(batch["cand_idx"]),
                jnp.asarray(batch["his_idx"]), jnp.asarray(batch["label"]))
            rows.append({"step": len(rows), "loss": float(loss), "gnorm": float(gnorm)})
    return rows, init


@pytest.fixture(scope="module")
def traj_corpus(tmp_path_factory):
    from miner_tpu_torch.tools.synth_mind import make_synth_mind

    root = str(tmp_path_factory.mktemp("traj") / "data")
    make_synth_mind(root, n_news=120, n_train_lines=120, n_users=24, n_eval_lines=6,
                    hist_len=(20, 24))
    return root


def _float64_gnorm(data_dir, init_seed, ckpt):
    """The first step's gradient norm of the leg's model in float64 on the
    leg's first batch: the exact norm, to float32's rounding."""
    from miner_tpu_torch.data.batcher import Batcher
    from miner_tpu_torch.data.samplers import OfflineSampler
    from miner_tpu_torch.training import losses

    g = quality_trajectory.geometry(init_seed, preset="tiny")
    store, log, _, table = quality_trajectory.load_data(data_dir, g, torch.device("cpu"))
    model = quality_trajectory.initial_model(store, g, init_seed, ckpt).double()
    batch = next(Batcher(g["BATCH"], drop_last=True, shuffle=True, seed=init_seed).batches(
        OfflineSampler(log, store, g["NPRATIO"], seed=init_seed).sample_epoch(0), 0))
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    interests, logits = model(table.lookup(idx(batch["cand_idx"]), idx(batch["his_idx"])))
    losses.miner_loss(interests, logits, torch.as_tensor(batch["label"])).backward()
    return float(torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters())))


def test_trajectory_leg_matches_jax_loop(tmp_path, traj_corpus):
    """Five steps from JAX's init (carried into a port checkpoint), dropout
    off: each step's loss within 1e-5 of JAX's, and its gradient norm
    before the clip within 1e-5 of the exact one (float64, step 0) and 1e-4
    of JAX's. At this init the interests are nearly parallel and the
    disagreement term's gradient cancels: JAX's float32 gradient lies 2e-4
    (relative) off the float64 one and its norm 1.4-2.0e-5 off the port's,
    whose gradient lies within 4e-6 of float64's."""
    want, init = _jax_trajectory(traj_corpus, 301, 5)
    ckpt = str(tmp_path / "init.pt")
    checkpoint.save(ckpt, {"params": params_from_jax(init)})
    got = quality_trajectory.run_leg(traj_corpus, str(tmp_path), "port-A", 301, ckpt, "cpu",
                                     preset="tiny", max_steps=5, deterministic=True,
                                     eval_=False)
    assert len(want) == 5 and [r["step"] for r in got["log"]] == [0, 1, 2, 3, 4]
    for w, r in zip(want, got["log"]):
        assert abs(r["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (r, w)
        assert abs(r["gnorm"] - w["gnorm"]) <= 1e-4 * abs(w["gnorm"]), (r, w)
    exact = _float64_gnorm(traj_corpus, 301, ckpt)
    assert abs(got["log"][0]["gnorm"] - exact) <= 1e-5 * exact, (got["log"][0], exact)
    with open(quality_trajectory.log_path(str(tmp_path), "port-A")) as f:
        assert [json.loads(line) for line in f] == got["log"]


def test_analyze_matches_jax(tmp_path):
    from tools import quality_trajectory as jax_traj

    rng = np.random.default_rng(0)
    base = 1.6 - np.linspace(0, 0.5, 160)
    noise = {"A": rng.normal(0, 1e-3, 160), "B": rng.normal(0, 0.05, 160)}
    names = {"torch-A": "port-A", "torch-B": "port-B", "jax-A": "jax-A", "jax-B": "jax-B"}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    for jax_leg, port_leg in names.items():
        curve = base + noise[jax_leg[-1]] * (2 if jax_leg.startswith("jax") else 1)
        n = 150 if jax_leg == "jax-B" else 160
        for side, leg in (("jax", jax_leg), ("port", port_leg)):
            with open(os.path.join(str(tmp_path / side), f"steps_{leg}.jsonl"), "w") as f:
                for i, v in enumerate(curve[:n]):
                    f.write(json.dumps({"step": i, "loss": float(v), "gnorm": 1.0}) + "\n")
            if leg != "jax-B":
                with open(os.path.join(str(tmp_path / side), f"result_{leg}.json"), "w") as f:
                    json.dump({"leg": leg, "scores": {"auc": len(jax_leg) / 10}}, f)
    want = jax_traj.analyze(str(tmp_path / "jax"), ["torch-A", "jax-A", "torch-B", "jax-B"])
    got = quality_trajectory.analyze(str(tmp_path / "port"))

    def mapped(report):
        text = json.dumps(report, sort_keys=True)
        for jax_leg, port_leg in names.items():
            text = text.replace(jax_leg, port_leg)
        return json.loads(text.replace("within-torch", "within-port"))

    assert got == mapped(want) and len(got["divergence"]) == 4
    with open(os.path.join(str(tmp_path / "port"), "analysis.json")) as f:
        assert json.load(f) == got


# ---------------------------------------------------------------- mains
def test_warmstart_main_on_cpu(tmp_path, monkeypatch, capsys):
    """The domain artifact, one seed: the donor (its eval printed), its
    export (the donor's tower bit for bit), warm and cold; no report written
    unless asked; a second call reuses the donor and prints its eval again;
    ``--tally`` counts the arms."""
    monkeypatch.setattr(port_trainer, "plm_config", _no_dropout_cfg(port_trainer.plm_config))
    monkeypatch.chdir(tmp_path)
    before = set(os.listdir(REPO))
    res = warmstart_ab.main(["--out", str(tmp_path / "ws"), "--artifact", "domain",
                             "--seeds", "3", "--events", "24", "--news", "60",
                             "--eval_lines", "6", "--pretrain_epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(res["donor"]) == 1  # one epoch
    line = warmstart_ab.donor_line(res["donor"])
    assert line.startswith(f"donor eval auc {res['donor'][0]['auc']:.4f}, group_auc ")
    assert "domain pretrain done" in out and out.count(line) == 2  # and the table's header
    assert [r[0] for r in res["rows"]] == ["warm-domain seed=3", "cold seed=3"]
    assert "| warm-domain seed=3 |" in out and "| cold seed=3 |" in out
    assert all(0.0 <= r[1]["auc"] <= 1.0 for r in res["rows"])
    assert set(os.listdir(REPO)) == before and not glob.glob(str(tmp_path / "*.md"))
    assert not glob.glob(str(tmp_path / "ws" / "*.md"))
    # the donor's tower, as the warm run's trainer imports it
    from miner_tpu_torch.models.hf_import import _load_state_dict

    donor = glob.glob(str(tmp_path / "ws" / "domain_pre" / "train" / "*" / "ckpt" /
                          "finalModel"))[0]
    sd = _load_state_dict(res["hf_dir"])
    plm = {k: v for k, v in checkpoint.load(donor)["params"].items()
           if k.startswith("news_encoder.plm.")}
    assert torch.equal(sd["bert.embeddings.word_embeddings.weight"],
                       plm["news_encoder.plm.embeddings.word_embeddings.weight"])
    again = warmstart_ab.main(["--out", str(tmp_path / "ws"), "--artifact", "domain",
                               "--events", "24", "--news", "60", "--eval_lines", "6",
                               "--device", "cpu", "--arms"])
    assert again["donor"] == res["donor"] and not again["rows"]
    assert "domain pretrain reused" in capsys.readouterr().out
    counts = warmstart_ab.main(["--tally", str(tmp_path / "ws")])
    ws = str(tmp_path / "ws")
    assert counts["groups"] == {f"{ws}/{label}": {3: row[1]["auc"]} for label, row in
                                zip(("warm-domain", "cold"), res["rows"])}
    assert list(counts["fisher"]) == [(f"{ws}/cold", f"{ws}/warm-domain")]


def test_unisrec_contract_main_on_cpu(tmp_path, monkeypatch, capsys):
    """Stages A, B and C and the baseline, an epoch each, tiny tower: the
    export holds every tensor of the model, and the baseline (lr 0) scores
    what the artifact scores."""
    monkeypatch.setattr(port_trainer, "plm_config", _no_dropout_cfg(port_trainer.plm_config))
    res = unisrec_contract.main(["--out", str(tmp_path), "--plm_preset", "tiny",
                                 "--events", "24", "--news", "60", "--eval_lines", "6",
                                 "--stage_a_epochs", "1", "--stage_c_epochs", "1",
                                 "--batch", "8", "--stage_c_baseline", "--dtype", "fp32",
                                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "stage B: exported" in out and "stage C (MoE-only freeze" in out
    a = checkpoint.load(os.path.join(res["a"]["run_dir"], "ckpt", "finalModel"))["params"]
    # every tensor of the model: each layer's fused qkv split in three, the
    # experts unstacked, and the layout marker
    n_experts = a["news_encoder.moe_adaptor.experts.kernel"].shape[0]
    n_layers = len({k.split(".")[3] for k in a if k.startswith("news_encoder.plm.layers.")}
                   ) + len({k.split(".")[1] for k in a if k.startswith("trm_layers.")})
    assert res["exported"] == len(a) + 4 * n_layers - 2 + 2 * n_experts + 1
    base = checkpoint.load(os.path.join(res["baseline"]["run_dir"], "ckpt", "finalModel"))
    for k, v in base["params"].items():  # lr 0: the artifact's weights, moved by nothing
        assert torch.equal(v, a[k]), k
    assert all(0.0 <= float(r["auc"]) <= 1.0 for r in res["c"]["rows"].values())


def _tower_without_dropout(monkeypatch):
    """The PLM's dropout off (its plain Philox draw on the CPU costs seconds
    a step); the other dropout sites and the gating noise stay."""
    from miner_tpu_torch import config
    from miner_tpu_torch.models.plm import PLMConfig

    tiny = PLMConfig.tiny
    monkeypatch.setattr(PLMConfig, "tiny", staticmethod(
        lambda vocab_size=1024: dc.replace(tiny(vocab_size), hidden_dropout=0.0,
                                           attention_dropout=0.0)))
    monkeypatch.setattr(config, "plm_config", _no_dropout_cfg(config.plm_config))


def test_unisrec_diag_main_on_cpu(monkeypatch, capsys):
    """The six variants at one step each; the tail's dropout as asked."""
    _tower_without_dropout(monkeypatch)
    built = []
    real = unisrec_diag.build_model
    monkeypatch.setattr(unisrec_diag, "build_model",
                        lambda rate: built.append(real(rate)) or built[-1])
    rows = unisrec_diag.main(["--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "chance acc = 0.20" in out and len(rows) == 6
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["acc"] <= 1.0 for r in rows)
    assert [m.cfg.hidden_dropout for m in built] == [0.5, 0.1, 0.0, 0.5, 0.5, 0.5]
    assert [m.trm_layers[0].attention_dropout for m in built] == \
        [0.5, 0.1, 0.0, 0.5, 0.5, 0.5]
    from miner_tpu_torch.models.unisrec import sasrec_encoder_cfg
    assert sasrec_encoder_cfg().hidden_dropout == 0.5  # put back


def test_quality_trajectory_main_on_cpu(tmp_path, monkeypatch):
    """Both port legs at the tiny preset from one init: the same first
    step (same init, same batch, dropout apart: at step 0 a loss within the
    dropout's reach), the logs, the results, the analysis; and the shared
    init exported in the reference layout."""
    _tower_without_dropout(monkeypatch)
    args = ["--out", str(tmp_path), "--preset", "tiny", "--events", "120", "--news", "80",
            "--eval_lines", "6", "--max_steps", "3", "--device", "cpu"]
    runs = quality_trajectory.main(args)
    a, b = runs["port-A"]["log"], runs["port-B"]["log"]
    assert len(a) == len(b) == 3 and a[0]["loss"] != b[0]["loss"]
    assert abs(a[0]["loss"] - b[0]["loss"]) < 0.5
    assert set(runs["analysis"]["divergence"]) == {"port-A vs port-B"}
    for leg in ("port-A", "port-B"):
        with open(quality_trajectory.result_path(str(tmp_path), leg)) as f:
            assert set(json.load(f)["scores"]) == {"auc", "group_auc", "mrr"}
    ref = str(tmp_path / "init_ref.pt")
    assert quality_trajectory.main(args + ["--export_init", ref])["exported"] > 0
    from miner_tpu_torch.models.hf_import import convert_miner_state_dict

    state = convert_miner_state_dict(torch.load(ref), num_layers=2)
    model = quality_trajectory.initial_model(
        quality_trajectory.load_data(str(tmp_path / "data"), quality_trajectory.geometry(
            301, preset="tiny"), torch.device("cpu"))[0],
        quality_trajectory.geometry(301, preset="tiny"), 301)
    own = model.state_dict()
    assert set(state) == set(own) and all(torch.equal(state[k], own[k]) for k in own)
    with pytest.raises(SystemExit):
        quality_trajectory.main(args + ["--legs", "jax-A"])
