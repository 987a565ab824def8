"""Tensor and expert parallelism (``--mesh_model``), dropout that does not
depend on the mesh, and serving over a mesh, against one rank and JAX.

In-process: the leaves the port shards over the model axis
(``parallel/tp.py``) against those JAX's ``tp_param_shardings`` shards, for
the Miner, Fastformer, UnBERT and UniSRec at the tiny size; the plain
dropout bits with offsets (``ops/philox.py``) against slices of the whole
batch's; a table-sharded serving cache saved and loaded across table sizes.

Over CPU processes on gloo (``tests/_torch_mesh_worker.py``, started in the
background when the module's fixture is first used), against one rank in
this process:

  * the Miner at ``--mesh_model 2`` and ``--mesh_data 2 --mesh_model 2``
    (float32, every dropout 0, 3 updates of accumulation 2): the losses and
    gradients to JAX's ``test_tp`` tolerance (rtol 1e-4, atol 1e-5), the
    parameters to the data axis's 1e-4 absolute; the ``--mesh_model 2``
    run also against the JAX trainer at ``--mesh_data 2 --mesh_model 4`` on
    its 8 virtual devices from the same converted init;
  * UniSRec's experts sharded (``--mesh_model 2``);
  * the fault a mesh once had: at ``--dropout 0.2`` with the PLM's rates
    on, ``--mesh_data 2`` and ``--mesh_model 2`` give one rank's losses and
    first update's gradients to the multihost tolerance (rtol 1e-5, atol
    5e-7): every mask is the rank's rows (and heads) of one rank's;
  * ``eval --mesh_model 2`` of the TP run's ``finalModel`` (a full-width
    checkpoint) gives the one-rank eval of the same file;
  * ``serve`` (the replies of rank 0's ``ScoringService``, the other rank
    following its device calls) and ``recommend`` over ``--mesh_table 2``
    give one rank's replies bit for bit; the serve job persists its
    table-sharded cache, which one rank then loads;
  * ``serve`` and ``recommend`` over ``--mesh_data 2`` (every call of one
    request padded to two rows, a rank's row each) give one rank's replies
    bit for bit, and over ``--mesh_model 2`` to the TP tolerance; so does
    UnBERT's reranking (``serve_scores_unbert``, the packed rows of a
    slate split over the data axis, the towers over the model axis);
  * cached-history training (``--his_cache_refresh 2
    --his_cache_warmup_steps 1``) at ``--mesh_model 2``: the cache rebuilt
    at the one-rank run's micro-steps from the sharded encoder, the losses,
    gradients and parameters to the TP tolerance.
"""
import dataclasses as dc
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import miner_tpu.training.trainer as jax_trainer
from miner_tpu.config import make_parser as jax_parser
from miner_tpu.parallel import mesh as jax_mesh
from miner_tpu.parallel.tp import tp_param_shardings
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.ops import philox
from miner_tpu_torch.parallel import mesh as port_mesh
from miner_tpu_torch.parallel import tp
from miner_tpu_torch.parallel.news_cache import load_cache
from miner_tpu_torch.serving import ScoringService
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import Trainer
from tests._torch_mesh_worker import Ranks
from tests.fixture_data import make_fixture
from tests.test_torch_mesh import _argv
from tests.test_torch_his_cache import _initial_params, _record_jax, _jax_run  # noqa: F401
from tests.test_torch_mesh_train import (
    AUGS,
    JAX_OPTIMIZER,
    MINER,
    _common,
    _family_argv,
    _one_rank,
    _write_head,
)

# JAX's test_tp tolerance for a model-sharded run against the unsharded one
TP_RTOL, TP_ATOL = 1e-4, 1e-5
UNISREC = ("--model_name", "unisrec", "--combine_type", "pre-concat")
# the other kinds trained over the model axis (test_torch_mesh_train's
# flags): train_fastformer's Fastformer (its layers' feed-forward sharded)
# and UnBERT (both towers), and pretrain
KINDS = ("pretrain", "fastformer", "unbert")
DROPOUT = ("--dropout", "0.2")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_plm_dropout(monkeypatch):
    import miner_tpu_torch.training.trainer as port_trainer

    make = port_trainer.plm_config
    monkeypatch.setattr(port_trainer, "plm_config", lambda *a, **k: dc.replace(
        make(*a, **k), hidden_dropout=0.0, attention_dropout=0.0))


def _train(fixture, out, *extra, accum=2, behaviors="short.tsv"):
    return [*_common(fixture, "train", behaviors, accum), *MINER, *extra, "--train_path", out]


def _serve_argv(fixture, mode, checkpoint_path, *extra):
    return _argv(fixture, mode, "--saved_model_path", checkpoint_path, *extra)


REQUESTS = [[["N1", "N3", "N5"], ["N7", "N8", "N2", "N11"], None],
            [["N2"], None, 5],
            [["N4", "N9", "N0", "N6", "N10", "N3"], None, None]]
# UnBERT reranks slates only (no corpus cache)
UNBERT_REQUESTS = [[["N1", "N3", "N5"], ["N7", "N8", "N2", "N11"], None],
                   [["N2"], ["N4", "N9"], 1],
                   [["N4", "N9", "N0", "N6", "N10", "N3"], ["N5", "N1", "N10"], None]]
UNBERT = ("--model_name", "unbert")
# serving over the data and the model axes, each job's mesh flags
SERVE_AXES = {"data": ("--mesh_data", "2"), "model": ("--mesh_model", "2")}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The fixture (``short.tsv``: 6 micro-batches of 8), JAX's initial
    Miner weights as a port checkpoint, a finalModel of one rank for the
    serving jobs and a one-rank serving cache of it; then the mesh runs
    started: two ranks (the Miner on the model axis, with dropout on the
    data and the model axis, UniSRec's experts, the TP eval, serve and
    recommend on the table axis), and four (the Miner over ``--mesh_data
    2 --mesh_model 2``)."""
    root = tmp_path_factory.mktemp("torch_tp")
    fixture = make_fixture(str(root / "fx"), num_lines=40, augmentations=AUGS)
    _write_head(fixture, "short.tsv", 48)
    with open(os.path.join(fixture, "behaviors.tsv")) as f, \
            open(os.path.join(fixture, "two.tsv"), "w") as g:
        g.writelines(f.readlines()[:2])
    with open(os.path.join(fixture, "behaviors.tsv")) as f, \
            open(os.path.join(fixture, "eval.tsv"), "w") as g:
        g.writelines(f.readlines()[:22])
    _write_head(fixture, "one.tsv", 16)  # 2 micro-batches: one update
    jt = jax_trainer.Trainer(jax_parser().parse_args(_train(fixture, str(root / "jinit"))))
    params = _initial_params(jt, jt._load_store(os.path.join(fixture, "news.tsv")), "Miner")
    init = str(root / "init.pt")
    checkpoint.save(init, {"params": params_from_jax(params)})
    served = str(root / "served.pt")
    checkpoint.save(served, {"params": params_from_jax(params)})
    one_cache = str(root / "one_cache.npz")
    ScoringService(Trainer(make_parser().parse_args(_serve_argv(
        fixture, "serve", served, "--serve_cache_path", one_cache)))).close()
    unbert = str(root / "unbert.pt")  # UnBERT's initial weights from --seed
    checkpoint.save(unbert, {"params": Trainer(make_parser().parse_args(_serve_argv(
        fixture, "serve", served, *UNBERT))).build_model().state_dict()})
    miner_tp = [*_train(fixture, str(root / "tp"), *JAX_OPTIMIZER, "--pretrained_model_path",
                        init), "--mesh_model", "2"]
    jobs = [{"argv": miner_tp, "out": str(root / "tp" / "r"), "no_plm_dropout": True},
            {"argv": [*miner_tp[:-4], "--train_path", str(root / "resumed"), "--mesh_model",
                      "2"], "out": str(root / "resumed" / "r"), "no_plm_dropout": True,
             "resume_glob": str(root / "tp" / "*" / "ckpt" / "finalModel")}]
    for axis in ("data", "model"):
        jobs.append({"argv": [*_train(fixture, str(root / f"drop_{axis}"), *DROPOUT,
                                      behaviors="one.tsv"), f"--mesh_{axis}", "2"],
                     "out": str(root / f"drop_{axis}" / "r")})
    jobs.append({"argv": [*_train(fixture, str(root / "ep")), *UNISREC, "--mesh_model", "2"],
                 "out": str(root / "ep" / "r"), "no_plm_dropout": True})
    for family in KINDS:
        jobs.append({"argv": [*_family_argv(fixture, family, str(root / family)),
                              "--mesh_model", "2"],
                     "out": str(root / family / "r"), "no_plm_dropout": True})
    table = ("--mesh_table", "2")
    jobs.append({"argv": _serve_argv(fixture, "serve", served, *table, "--serve_cache_path",
                                     str(root / "sharded_cache.npz")),
                 "out": str(root / "serve"), "requests": REQUESTS})
    jobs.append({"argv": _serve_argv(fixture, "serve", served, *table, "--serve_cache_path",
                                     one_cache),
                 "out": str(root / "serve_loaded"), "requests": REQUESTS})
    jobs.append({"argv": _serve_argv(fixture, "recommend", served, *table, "--user_history",
                                     "N1", "N3", "--candidates", "N7", "N8", "N2"),
                 "out": str(root / "recommend")})
    for axis, flags in SERVE_AXES.items():
        jobs.append({"argv": _serve_argv(fixture, "serve", served, *flags),
                     "out": str(root / f"serve_{axis}"), "requests": REQUESTS})
        jobs.append({"argv": _serve_argv(fixture, "recommend", served, *flags,
                                         "--user_history", "N1", "N3"),
                     "out": str(root / f"recommend_{axis}")})
        jobs.append({"argv": _serve_argv(fixture, "serve", unbert, *UNBERT, *flags),
                     "out": str(root / f"unbert_{axis}"), "requests": UNBERT_REQUESTS})
    jobs.append({"argv": [*_family_argv(fixture, "his_cache", str(root / "his_cache_tp")),
                          "--mesh_model", "2"],
                 "out": str(root / "his_cache_tp" / "r"), "no_plm_dropout": True})
    two = Ranks(jobs, 2, str(root / "two"))
    four = Ranks([{"argv": [*_train(fixture, str(root / "tp4"), *JAX_OPTIMIZER,
                                    "--pretrained_model_path", init), "--mesh_data", "2",
                            "--mesh_model", "2"],
                   "out": str(root / "tp4" / "r"), "no_plm_dropout": True}], 4,
                 str(root / "four"))
    return dict(root=root, fixture=fixture, params=params, init=init, served=served,
                one_cache=one_cache, unbert=unbert, two=two, four=four)


def _result(tp_runs, name, world=2):
    return (tp_runs["four" if world == 4 else "two"].wait()
            [str(tp_runs["root"] / name / "r") if name in ("tp", "tp4", "drop_data",
                                                          "drop_model", "ep", "resumed",
                                                          "his_cache_tp", *KINDS)
             else str(tp_runs["root"] / name)])


def _assert_tp_matches(ranks, one, params=True):
    """Every rank's gathered parameters equal rank 0's bit for bit; the
    losses, the first update's gradients and their norm before the clip
    match the one-rank run's to JAX's TP tolerance (the partial products
    summed over the model group differ from one rank's by fp32 summation
    order; later updates' norms follow parameters Adam has already moved
    apart, as on the data axis); the parameters after the updates to
    ``assert_runs_match``'s 1e-4 absolute, as the data axis's tests hold
    them: Adam moves an element whose gradient is near zero by up to lr an
    update whatever its rounding (measured here: 3.9e-5 on 4 of 8,192
    elements of a layer's ``ffn_out`` after 3 updates at lr 2e-3). Without
    ``params`` the parameters after the updates are held only to be equal
    over the ranks."""
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=TP_RTOL, atol=TP_ATOL)
    assert len(got["grad_norms"]) == len(one["grad_norms"])
    np.testing.assert_allclose(got["grad_norms"][0], one["grad_norms"][0], rtol=TP_RTOL)
    assert got["grads"][0].keys() == one["grads"][0].keys()
    for k, want in one["grads"][0].items():
        np.testing.assert_allclose(got["grads"][0][k].numpy(), want.numpy(), rtol=TP_RTOL,
                                   atol=TP_ATOL, err_msg=k)
    assert got["params"].keys() == one["params"].keys()
    if not params:
        return
    moved = 0
    for k, want in one["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
        moved += int(not torch.equal(got["params"][k], want))
    assert moved


# ------------------------------------------------------------ in-process
def _jax_sharded(jt, store, batch_example, kind_params=None):
    """The port names of the leaves JAX's ``tp_param_shardings`` shards over
    a model axis of 2 (of its 8 virtual devices)."""
    model, kind = jt.build_model(store)
    shapes = kind_params or jax.eval_shape(
        lambda: jt._init_params_for_kind(model, kind, jt._host_table(store), batch_example))
    jm = jax_mesh.make_mesh(jax_mesh.MeshConfig(4, 1, 2))
    shardings = tp_param_shardings(shapes, jm)
    flags = jax.tree_util.tree_map(
        lambda s, sh: np.full(s.shape, float(any(a == "model" for a in sh.spec)), np.float32),
        shapes, shardings)
    return {k for k, v in params_from_jax(flags).items() if bool(v.all()) and v.numel()}


FAMILY_FLAGS = {
    "Miner": ("train", MINER),
    "fastformer": ("train_fastformer", ("--model_name", "fastformer", "--apply_reduce_dim",
                                        "--use_sapo", "--word_embed_dim", "32")),
    "unisrec": ("train_fastformer", UNISREC),
    "unbert": ("train_fastformer", ("--model_name", "unbert")),
}
# leaves JAX shards and the port replicates: none at the tiny size, whose
# every attention's heads divide by 2 (the port splits qkv by head)
HEAD_RULE_REPLICATED = {family: set() for family in FAMILY_FLAGS}


@pytest.mark.parametrize("family", list(FAMILY_FLAGS))
def test_the_ports_sharded_leaves_are_jaxs(tmp_path, family):
    """``tp.shard_`` at a model size of 2 shards the leaves that JAX's
    ``tp_param_shardings`` shards (mapped through ``models/convert.py``),
    but those the head rule replicates (listed), and each share is its
    rank's of the whole leaf: the shares of the two ranks make it again."""
    fixture = make_fixture(str(tmp_path / "fx"), num_lines=8)
    mode, flags = FAMILY_FLAGS[family]
    argv = [*_common(fixture, mode, "behaviors.tsv", 1)[:-2], *flags, "--train_path",
            str(tmp_path / "run")]
    jt = jax_trainer.Trainer(jax_parser().parse_args(argv))
    store = jt._load_store(os.path.join(fixture, "news.tsv"))
    example = {"cand_idx": jnp.zeros((2, 4), jnp.int32), "his_idx": jnp.zeros((2, 5), jnp.int32)}
    shapes = None
    if family == "unbert":
        tt = Trainer(make_parser().parse_args([*argv, "--device", "cpu"]))
        ts = tt._load_store(os.path.join(fixture, "news.tsv"))
        block = tt._train_sampler(tt._load_log(os.path.join(fixture, "behaviors.tsv"), ts),
                                  ts).sample_epoch(0)
        model, kind = jt.build_model(store)
        feat = block.materialize(np.arange(2))
        shapes = jax.eval_shape(lambda: jt._init_params_for_kind(model, kind, None, feat))
    want = _jax_sharded(jt, store, example, shapes)
    assert want  # JAX shards something at this size
    port = Trainer(make_parser().parse_args([*argv, "--device", "cpu"]))
    whole = port.build_model().state_dict()
    shares = []
    for rank in range(2):
        model = port.build_model()
        m = port_mesh.Mesh(port_mesh.MeshConfig(1, 1, 2), world=2, rank=rank)
        specs = tp.shard_(model, m)
        shares.append((model.state_dict(), specs))
    got = set(shares[0][1])
    assert got == want - HEAD_RULE_REPLICATED[family]
    for name, spec in shares[0][1].items():
        full = spec.full([shares[0][0][name], shares[1][0][name]])
        assert torch.equal(full, whole[name]), name
        assert shares[0][0][name].shape != whole[name].shape


@pytest.mark.parametrize("pieces", [((0, 0),), ((0, 5),), ((0, 3), (4, 9))])
def test_offset_bits_are_slices_of_the_whole_batchs(pieces):
    """``mha_bits`` and ``add_ln_bits`` of a launch over some sequences,
    heads or rows at their offsets (one run or two) equal those rows of the
    bits of the whole batch, bit for bit; offset 0 is the old layout."""
    # adjacent runs of one offset (one rank's candidates and history) merge
    assert philox.pieces(((0, 0), (5, 0)), 9) == [(0, 9, 0)]
    N, H, L, seed = 7, 4, 20, 2 ** 40 + 3
    whole = philox.mha_bits(seed, 16, H, L, "cpu")
    places = philox.row_places(pieces, N, "cpu")
    got = philox.mha_bits(seed, N, 2, L, "cpu", seq_offset=pieces, head_offset=2)
    assert torch.equal(got, whole[places][:, 2:4])
    D = 24  # add_ln's rows: 3 tokens of each of the N sequences
    whole_ln = philox.add_ln_bits(seed, 16 * 3, D, "cpu")
    got_ln = philox.add_ln_bits(seed, N * 3, D, "cpu", philox.scaled(pieces, 3))
    rows = (places[:, None] * 3 + torch.arange(3)).reshape(-1)
    assert torch.equal(got_ln, whole_ln[rows])


def test_a_sharded_cache_round_trips(tp_runs, tmp_path):
    """The cache the table-sharded serve job persisted is one rank's file
    (the true rows gathered): it loads on one rank, array for array equal to
    the one-rank cache, and the one-rank file served the other serve job
    (each rank keeping its shard) with the one-rank replies."""
    _result(tp_runs, "serve_loaded")  # waits for the ranks
    tt = Trainer(make_parser().parse_args(_serve_argv(
        tp_runs["fixture"], "serve", tp_runs["served"], "--serve_cache_path",
        tp_runs["one_cache"])))
    fingerprint = tt._serving_cache_fingerprint()
    one = load_cache(tp_runs["one_cache"], fingerprint)
    sharded = load_cache(str(tp_runs["root"] / "sharded_cache.npz"), fingerprint)
    assert one is not None and sharded is not None
    assert torch.equal(one.embeddings, sharded.embeddings)
    assert torch.equal(one.category, sharded.category)
    with np.load(tp_runs["one_cache"]) as a, np.load(str(tp_runs["root"] /
                                                       "sharded_cache.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------- the mesh runs
def test_the_model_axis_trains_the_miner_as_one_rank_and_as_jax(tp_runs, tmp_path,
                                                                monkeypatch):
    """``--mesh_model 2``: each rank holds half of every layer's heads and
    feed-forward features, the products' partial sums all-reduced over the
    two. The same losses and parameters as one rank to JAX's TP tolerance,
    the gradients and their norm before the clip too; and as the JAX trainer at
    ``--mesh_data 2 --mesh_model 4`` on its 8 virtual devices from the same
    initial weights."""
    _no_plm_dropout(monkeypatch)
    fixture = tp_runs["fixture"]
    one = _one_rank(_train(fixture, str(tmp_path / "one"), *JAX_OPTIMIZER,
                           "--pretrained_model_path", tp_runs["init"]))
    ranks = _result(tp_runs, "tp")
    _assert_tp_matches(ranks, one)
    # JAX at --mesh_data 2 --mesh_model 4, from the same weights
    from tests.test_torch_his_cache import _no_dropout_cfg

    monkeypatch.setattr(jax_trainer, "plm_config", _no_dropout_cfg(jax_trainer.plm_config))
    jt = jax_trainer.Trainer(jax_parser().parse_args(_train(
        fixture, str(tmp_path / "jax"), *JAX_OPTIMIZER, "--mesh_data", "2", "--mesh_model", "4")))
    params = tp_runs["params"]
    jt._init_params_for_kind = lambda *a, **k: jax.tree_util.tree_map(jnp.asarray, params)
    events = []
    _record_jax(jt, events)
    state = jt.train()
    _, jax_losses, _ = _jax_run(events)
    np.testing.assert_allclose(ranks[0]["losses"], jax_losses, rtol=1e-5, atol=1e-5)
    want = params_from_jax(jax.device_get(state.params))
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_data_and_model_axes_train_the_miner_as_one_rank(tp_runs, tmp_path, monkeypatch):
    """``--mesh_data 2 --mesh_model 2`` over 4 ranks: each data rank's rows,
    each model rank's heads and features; the same losses and parameters as
    one rank to JAX's TP tolerance."""
    _no_plm_dropout(monkeypatch)
    one = _one_rank(_train(tp_runs["fixture"], str(tmp_path / "one"), *JAX_OPTIMIZER,
                           "--pretrained_model_path", tp_runs["init"]))
    ranks = _result(tp_runs, "tp4", world=4)
    assert len(ranks) == 4
    _assert_tp_matches(ranks, one)


def test_the_experts_shard_and_train_as_one_rank(tp_runs, tmp_path, monkeypatch):
    """UniSRec at ``--mesh_model 2``: each rank holds 4 of the adaptor's 8
    experts (and half of the PLM's and the SASRec layers' heads and
    features); the gated mixture's shares summed over the two. The same
    losses and parameters as one rank (the adaptor alone trains)."""
    _no_plm_dropout(monkeypatch)
    one = _one_rank(_train(tp_runs["fixture"], str(tmp_path / "one"), *UNISREC))
    ranks = _result(tp_runs, "ep")
    _assert_tp_matches(ranks, one)


@pytest.mark.parametrize("family", KINDS)
def test_the_model_axis_trains_each_kind_as_one_rank(tp_runs, tmp_path, monkeypatch, family):
    """``pretrain``, ``train_fastformer`` (Fastformer: the PLM's layers and
    the user encoder's feed-forward sharded) and UnBERT (its word and news
    towers) at ``--mesh_model 2`` against one rank: the losses, the first
    update's gradients and norm. Not the parameters after 3 updates at lr
    1e-3: the pretrain kind's contrastive sum moved one element of 8,192 in
    a layer's ``ffn_in`` by 2.8e-4 (Adam's step for a gradient near zero,
    whose sign the summation order decides)."""
    _no_plm_dropout(monkeypatch)
    one = _one_rank(_family_argv(tp_runs["fixture"], family, str(tmp_path)))
    _assert_tp_matches(_result(tp_runs, family), one, params=False)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_dropout_does_not_depend_on_the_mesh(tp_runs, tmp_path, axis):
    """The fault a mesh once had: at ``--dropout 0.2`` with the PLM's own
    rates on (attention and hidden dropout in the mha and add_ln kernels'
    plain versions, the embedding, ``reduce_dim`` and category dropout
    outside them), ``--mesh_data 2`` and ``--mesh_model 2`` give one rank's
    losses and first update's gradients to the multihost tolerance: every
    rank's masks are its rows (and heads) of one rank's."""
    one = _one_rank(_train(tp_runs["fixture"], str(tmp_path / "one"), *DROPOUT,
                           behaviors="one.tsv"))
    ranks = _result(tp_runs, f"drop_{axis}")
    assert len(one["losses"]) == 2 and len(one["grads"]) == 1
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5, atol=5e-7)
    np.testing.assert_allclose(ranks[0]["grad_norms"], one["grad_norms"], rtol=1e-5, atol=5e-7)
    for k, want in one["grads"][0].items():
        np.testing.assert_allclose(ranks[0]["grads"][0][k].numpy(), want.numpy(), rtol=1e-5,
                                   atol=5e-7, err_msg=k)


def test_a_tp_final_model_evaluates_on_one_rank_as_the_tp_eval(tp_runs, tmp_path,
                                                               monkeypatch):
    """The TP run's ``finalModel`` holds full tensors: it loads on one rank,
    whose eval gives the TP eval's scores (rank 0 and 1 of ``eval
    --mesh_model 2``, run in the background after the serving jobs) to
    fp32 summation order."""
    ranks = _result(tp_runs, "tp")
    (final,) = glob.glob(str(tp_runs["root"] / "tp" / "*" / "ckpt" / "finalModel"))
    payload = checkpoint.load(final)
    for k, v in ranks[0]["params"].items():
        assert torch.equal(payload["params"][k], v), k
    argv = _argv(tp_runs["fixture"], "eval", "--saved_model_path", final)
    one = Trainer(make_parser().parse_args([*argv, "--eval_path", str(tmp_path / "one")])).eval()
    tp_eval = Ranks([{"argv": [*argv, "--eval_path", str(tmp_path / "tp"), "--mesh_model", "2"],
                      "out": str(tmp_path / "tp_eval")}], 2, str(tmp_path / "ranks"))
    got = tp_eval.wait()[str(tmp_path / "tp_eval")]
    assert got[0]["scores"] == got[1]["scores"]
    for k, v in one.items():
        assert got[0]["scores"][k] == pytest.approx(v, rel=1e-5), k


def test_a_tp_run_resumes_from_its_full_width_checkpoint(tp_runs):
    """``--resume_from`` at ``--mesh_model 2`` takes each rank's shares of a
    full-width checkpoint's parameters and AdamW moments: resumed from the
    TP run's ``finalModel`` (its epoch done, no micro-step left), the run
    writes the same checkpoint back, the shares gathered again, bit for
    bit."""
    _result(tp_runs, "resumed")
    root = tp_runs["root"]
    (a,) = glob.glob(str(root / "tp" / "*" / "ckpt" / "finalModel"))
    (b,) = glob.glob(str(root / "resumed" / "*" / "ckpt" / "finalModel"))
    first, again = checkpoint.load(a), checkpoint.load(b)
    assert first["micro_step"] == again["micro_step"] == 6
    assert first["params"].keys() == again["params"].keys()
    for k, v in first["params"].items():
        assert torch.equal(again["params"][k], v), k
    want, got = first["optimizer"], again["optimizer"]
    assert (want["updates"], want["mini_step"]) == (got["updates"], got["mini_step"]) == (3, 0)
    assert want["adamw"]["state"].keys() == got["adamw"]["state"].keys()
    for i, s in want["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["adamw"]["state"][i][k], v), (i, k)


def test_serving_over_the_table_axis_replies_as_one_rank(tp_runs):
    """``serve`` and ``recommend`` over ``--mesh_table 2``: rank 0's
    service coalesces the requests and every device call runs on both
    ranks (rank 1 follows it, each gather and lookup+score summed over the
    two shards): the replies equal one rank's bit for bit, from a fresh
    cache and from the one-rank cache file; ``recommend``'s ranking too."""
    one = Trainer(make_parser().parse_args(_serve_argv(tp_runs["fixture"], "serve",
                                                       tp_runs["served"])))
    service = ScoringService(one)
    try:
        want = [service.score(*r) for r in REQUESTS]
    finally:
        service.close()
    for name in ("serve", "serve_loaded"):
        got = _result(tp_runs, name)
        assert got[0]["replies"] == want, name
        assert got[1]["calls"] >= len(REQUESTS)
    rec = Trainer(make_parser().parse_args(_serve_argv(
        tp_runs["fixture"], "recommend", tp_runs["served"], "--user_history", "N1", "N3",
        "--candidates", "N7", "N8", "N2"))).recommend()
    got = _result(tp_runs, "recommend")
    assert got[0]["results"] == got[1]["results"] == rec


def _one_rank_replies(argv, requests):
    service = ScoringService(Trainer(make_parser().parse_args(argv)))
    try:
        return [service.score(*r) for r in requests]
    finally:
        service.close()


def _assert_replies(got, want, exact):
    """Each reply's ranking of (news id, score): bit for bit, or (over the
    model axis, whose products sum their shares in another order) the same
    news to the TP tolerance, in the same order but where two scores tie
    within it."""
    if exact:
        assert got == want
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(n for n, _ in g) == sorted(n for n, _ in w)
        scores = dict(g)
        np.testing.assert_allclose([scores[n] for n, _ in w], [s for _, s in w],
                                   rtol=TP_RTOL, atol=TP_ATOL)
        for (a, x), (b, y) in zip(g, w):
            assert a == b or abs(x - y) <= TP_ATOL + TP_RTOL * abs(y)


@pytest.mark.parametrize("axis", list(SERVE_AXES))
def test_serving_over_the_data_and_model_axes_replies_as_one_rank(tp_runs, axis):
    """``serve`` (slates and corpus top-k, each call one request: over the
    data axis padded to two rows, rank 0 scoring the request's and rank 1
    the pad's) and ``recommend`` over ``--mesh_data 2`` give one rank's
    replies bit for bit; over ``--mesh_model 2`` (each rank half of every
    layer's heads and features, rank 1 following rank 0's calls) to the TP
    tolerance."""
    fixture, served = tp_runs["fixture"], tp_runs["served"]
    want = _one_rank_replies(_serve_argv(fixture, "serve", served), REQUESTS)
    got = _result(tp_runs, f"serve_{axis}")
    _assert_replies(got[0]["replies"], want, exact=axis == "data")
    assert got[1]["calls"] == len(REQUESTS)
    rec = Trainer(make_parser().parse_args(_serve_argv(
        fixture, "recommend", served, "--user_history", "N1", "N3"))).recommend()
    got = _result(tp_runs, f"recommend_{axis}")
    assert got[0]["results"] == got[1]["results"]
    assert len(rec) == 10  # the corpus top-k (--topk's default)
    _assert_replies([got[0]["results"]], [rec], exact=axis == "data")


@pytest.mark.parametrize("axis", list(SERVE_AXES))
def test_unbert_reranks_over_a_mesh_as_one_rank(tp_runs, axis):
    """UnBERT's ``serve_scores_unbert`` over ``--mesh_data 2`` (a call's
    packed (candidate, history) rows split over the ranks, the pad row's
    too) gives one rank's replies bit for bit, and over ``--mesh_model 2``
    (its word and news towers sharded) to the TP tolerance."""
    want = _one_rank_replies(_serve_argv(tp_runs["fixture"], "serve", tp_runs["unbert"],
                                         *UNBERT), UNBERT_REQUESTS)
    assert [len(r) for r in want] == [4, 1, 3]
    got = _result(tp_runs, f"unbert_{axis}")
    _assert_replies(got[0]["replies"], want, exact=axis == "data")
    assert got[1]["calls"] == len(UNBERT_REQUESTS)


def test_cached_history_trains_over_the_model_axis_as_one_rank(tp_runs, tmp_path,
                                                               monkeypatch):
    """``--his_cache_refresh 2 --his_cache_warmup_steps 1`` at ``--mesh_model
    2``: every rank encodes the cache with its shares of the PLM (the
    products summed over the model group), rebuilt at JAX's micro-steps (2,
    4 and 8, as one rank); the losses of all 10 micro-steps (the cached
    ones read the rebuilt caches), the first update's gradients and their
    norm as one rank's to the TP tolerance, the ranks' parameters equal.
    Not the parameters after 5 updates at lr 1e-3, as for the kinds above:
    Adam moved one element of 2,048 of ``linear_combine.weight`` by
    1.0e-4 (a gradient near zero, whose sign the summation order decides)."""
    _no_plm_dropout(monkeypatch)
    one = _one_rank(_family_argv(tp_runs["fixture"], "his_cache", str(tmp_path)))
    ranks = _result(tp_runs, "his_cache_tp")
    assert one["fills"] == [2, 4, 8] and ranks[0]["fills"] == ranks[1]["fills"] == one["fills"]
    assert len(one["losses"]) == 10
    _assert_tp_matches(ranks, one, params=False)
