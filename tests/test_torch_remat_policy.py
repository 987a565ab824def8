"""``--remat`` and ``--remat_policy`` in both packages.

Refusal: the JAX package raises in ``plm_config`` (``miner_tpu/config.py``)
for ``--remat_policy`` without ``--remat``, which ``Trainer.build_model``
reaches in every subcommand that builds a model; the port raises the same
``ValueError`` when its ``Trainer`` is made. With ``--remat`` both take it.

What remat saves: the port's ``--remat`` keeps each layer's mha forward
outputs for its recompute (JAX's ``"attn_ctx"``; ``models/plm.py:Remat``),
so the backward runs no mha forward (the plain forward's calls are
counted), and ``--remat_policy dots`` also keeps every product with no
batch dims, so its recompute runs no matmul (a dispatch mode counts the
``aten.mm`` / ``aten.addmm`` the backward executes). The gradients of a
micro-step (dropout on) are the same under no remat and both policies, and
under ``dots`` those of the JAX package's ``--remat --remat_policy dots``
step (float32, dropout off) within float32 noise.
"""
import collections
import dataclasses as dc
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from miner_tpu.config import make_parser as jax_parser
from miner_tpu.config import plm_config as jax_plm_config
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import OnlineSampler
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.ops import mha
from miner_tpu_torch.training import trainer as port_trainer
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

REFUSAL = ("--remat_policy 'dots' has no effect without --remat; pass --remat "
           "(or drop --remat_policy)")
SUBCOMMANDS = {"train": (), "train_fastformer": (), "pretrain": (), "eval": (), "serve": (),
               "recommend": ("--user_history", "N1")}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("remat_policy")), num_lines=8)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (the PLM's plain Philox dropout under six xdist
    workers; see tests/test_torch_training.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_trainer(fixture, mode, *extra):
    return Trainer(make_parser().parse_args([
        mode, "--pretrained_tokenizer", "hash:1000", "--plm_preset", "tiny",
        "--user2id_path", os.path.join(fixture, "user2id.json"),
        "--category2id_path", os.path.join(fixture, "category2id.json"),
        "--device", "cpu", "--remat_policy", "dots", *extra]))


def _build(package, fixture, remat):
    """What each package builds from --remat_policy dots (and --remat)."""
    if package == "jax":
        return jax_plm_config("tiny", vocab_size=1000, remat=remat, remat_policy="dots")
    return _port_trainer(fixture, "train", *(["--remat"] if remat else []))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_remat_policy_without_remat_is_refused(fixture_dir, package):
    with pytest.raises(ValueError) as err:
        _build(package, fixture_dir, remat=False)
    assert str(err.value) == REFUSAL


@pytest.mark.parametrize("package", ["jax", "port"])
def test_remat_policy_with_remat_is_taken(fixture_dir, package):
    built = _build(package, fixture_dir, remat=True)
    if package == "jax":
        assert built.remat and built.remat_policy == "dots"
    else:
        assert built.args.remat and built.args.remat_policy == "dots"


@pytest.mark.parametrize("mode", SUBCOMMANDS)
def test_every_subcommand_of_the_port_refuses_it(fixture_dir, mode):
    with pytest.raises(ValueError, match="has no effect without --remat"):
        _port_trainer(fixture_dir, mode, *SUBCOMMANDS[mode])
    taken = _port_trainer(fixture_dir, mode, "--remat", *SUBCOMMANDS[mode])
    assert taken.args.remat_policy == "dots"


# ------------------------------------------------------- what remat saves
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
POLICIES = {"none": (), "remat": ("--remat",), "dots": ("--remat", "--remat_policy", "dots")}


MHA = "mha forward"


class _Executed(TorchDispatchMode):
    """Counts the operators that run below autograd, and (``MHA``) the
    calls of the mha op's forward (on the CPU its plain version, which a
    kept context spares)."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.counts = collections.Counter()
        reference = mha.mha_reference

        def counted(*a, **k):
            self.counts[MHA] += 1
            return reference(*a, **k)

        monkeypatch.setattr(mha, "mha_reference", counted)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _flags(fixture, *extra):
    """The tiny Miner of tests/test_torch_training.py, float32, dropout on
    outside the PLM too."""
    return ["train", "--model_name", "Miner", "--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--apply_reduce_dim", "--use_sapo",
            "--use_category_bias", "--word_embed_dim", "32", "--category_embed_dim", "8",
            "--num_context_codes", "4", "--context_code_dim", "16", "--score_type",
            "weighted", "--npratio", "3", "--compute_dtype", "float32",
            "--train_batch_size", "8", *extra]


def _batch(tt, fixture):
    store = tt._load_store(os.path.join(fixture, "news.tsv"))
    log = tt._load_log(os.path.join(fixture, "behaviors.tsv"), store)
    batch = next(Batcher(8).batches(OnlineSampler(log, store, 3, seed=7).sample_epoch(0)))
    return store, batch


def _port_step(fixture, policy, *extra):
    """One micro-step of the port (train mode, seeds from step 3): the
    loss, every gradient, the operators its forward and its backward ran
    and their mha forwards."""
    tt = Trainer(make_parser().parse_args(_flags(fixture, "--device", "cpu",
                                                 *POLICIES[policy], *extra)))
    store, batch = _batch(tt, fixture)
    model = tt.build_model().train()
    assert model.news_encoder.plm.cfg.remat == (policy != "none")
    table = tt._make_table(store)
    with pytest.MonkeyPatch.context() as mp, _Executed(mp) as fwd:
        loss, _ = tt._apply_and_loss(model, table, batch, DropoutRNG(8, 3, "cpu"))
    with pytest.MonkeyPatch.context() as mp, _Executed(mp) as bwd:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads, fwd.counts, bwd.counts


@pytest.fixture(scope="module")
def port_steps(fixture_dir):
    return {policy: _port_step(fixture_dir, policy, "--dropout", "0.2")
            for policy in POLICIES}


@pytest.mark.parametrize("policy", ["remat", "dots"])
def test_remat_policies_give_the_gradients_of_no_remat(port_steps, policy):
    """PLM dropout 0.1, the rest 0.2: the kernel seeds are drawn outside
    each layer, so the recompute drops the same elements; only the order of
    float32 sums may differ."""
    loss, grads = port_steps["none"][:2]
    got_loss, got = port_steps[policy][:2]
    assert got_loss == pytest.approx(loss, rel=1e-6)
    assert got.keys() == grads.keys() and len(grads) > 10
    for n, g in grads.items():
        torch.testing.assert_close(got[n], g, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("policy", ["none", "remat", "dots"])
def test_the_backward_runs_no_mha_forward(port_steps, policy):
    """Each layer's mha forward runs once, in the forward: remat keeps its
    context and statistics (JAX's "attn_ctx"), so the recompute takes the
    kept ones; a whole-layer checkpoint would run it again."""
    fwd, bwd = port_steps[policy][2:]
    assert fwd[MHA] > 0
    assert bwd[MHA] == 0


def test_dots_recompute_runs_no_matmul(port_steps):
    """The backward's products with no batch dims: no remat runs the
    gradients' alone; --remat also recomputes a layer's four (qkv, out,
    ffn_in, ffn_out) at each layer call; --remat_policy dots saves them, so
    its backward runs the gradients' alone, as with no remat."""
    count = lambda policy, counts: sum(port_steps[policy][counts][op] for op in MM)  # noqa: E731
    layer_calls = port_steps["none"][2][MHA]
    assert count("none", 2) == count("remat", 2) == count("dots", 2) > 0
    assert count("remat", 3) == count("none", 3) + 4 * layer_calls
    assert count("dots", 3) == count("none", 3)


def test_dots_step_matches_jax(fixture_dir, monkeypatch):
    """--remat --remat_policy dots in both packages, float32, every dropout
    off, one micro-step from the same weights: the loss to 1e-5 and every
    gradient (JAX's tree through params_from_jax) to 1e-3 of its own
    largest magnitude plus 1e-6 of the largest over all: float32 sums of a
    loss whose gradients cancel (the linear combine's reach 3.6e-4 of their
    scale, the same with no remat in either package)."""
    flags = _flags(fixture_dir, *POLICIES["dots"], "--dropout", "0")
    jt = JaxTrainer(jax_parser().parse_args(flags))
    news = os.path.join(fixture_dir, "news.tsv")
    js = jt._load_store(news)
    jmodel, kind = jt.build_model(js)
    plm = dc.replace(jmodel.news_encoder.plm_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    assert plm.remat and plm.remat_policy == "dots"
    jmodel = jmodel.clone(news_encoder=jmodel.news_encoder.clone(plm_cfg=plm))

    # the port's PLM with its rates at 0, in train mode, so that remat runs
    build = port_trainer.plm_config
    monkeypatch.setattr(port_trainer, "plm_config", lambda *a, **k: dc.replace(
        build(*a, **k), hidden_dropout=0.0, attention_dropout=0.0))
    tt = Trainer(make_parser().parse_args([*flags, "--device", "cpu"]))
    store, batch = _batch(tt, fixture_dir)
    example = {k: jnp.asarray(v) for k, v in batch.items() if k != "valid"}
    params = jt._init_params_for_kind(jmodel, kind, jt._host_table(js), example)
    jtable = jt._make_table(js)

    def loss_fn(p):
        return jt._apply_and_loss(jmodel, kind, p, jtable, example, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0),
                                        "gating": jax.random.PRNGKey(1)})[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(jax.device_get(jgrads))

    model = tt.build_model().train()
    assert model.news_encoder.plm.cfg.remat_policy == "dots"
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    loss, _ = tt._apply_and_loss(model, tt._make_table(store), batch,
                                 DropoutRNG(8, 0, "cpu"))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert got.keys() == want.keys()
    overall = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        tol = 1e-3 * float(w.abs().max()) + 1e-6 * overall
        assert float((got[n] - w).abs().max()) <= tol, n
