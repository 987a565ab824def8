"""The port's mesh (``miner_tpu_torch/parallel``) against the JAX package's,
its sharded cached eval, its dropout over a mesh and its refusals.

In-process: the mesh arithmetic (``MeshConfig.resolve``, error texts word
for word) and the rows each rank owns, against JAX's ``make_mesh`` on the
8-device virtual CPU mesh; the collective backend chosen by placement; a
rank's dropout masks, its rows (and heads) of one rank's; the table
shard's index map; and the refusals. Over CPU
processes on gloo (``tests/_torch_mesh_worker.py``): ``eval --mesh_table 2``
equals one rank's eval bit for bit (the cache row-sharded, each score
summed over the table group), and ``eval --mesh_data 2`` over an eval log
whose last batch is padded gives one rank's metrics.
"""
import glob
import os
import pickle

import numpy as np
import pytest
import torch

import miner_tpu.parallel.mesh as jax_mesh
import miner_tpu.parallel.sharding as jax_sharding
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.models.dropout import DropoutRNG, Rows
from miner_tpu_torch.parallel import mesh as port_mesh
from miner_tpu_torch.parallel import sharding
from miner_tpu_torch.parallel.news_cache import ShardedRows
from miner_tpu_torch.training.trainer import Trainer
from tests._torch_mesh_worker import Ranks
from tests.fixture_data import make_fixture

MINER = ["--model_name", "Miner", "--apply_reduce_dim", "--use_sapo", "--use_category_bias",
         "--word_embed_dim", "32", "--category_embed_dim", "8", "--num_context_codes", "4",
         "--context_code_dim", "16", "--score_type", "weighted"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the arithmetic
@pytest.mark.parametrize("data", [-1, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("table, model", [(1, 1), (2, 1), (1, 2), (2, 2), (0, 4)])
def test_mesh_config_resolves_as_jax(data, table, model):
    """``MeshConfig.resolve`` over the grid at 1, 2, 4 and 8 ranks: the same
    shape as JAX's, or the same ``ValueError`` text."""
    for n in (1, 2, 4, 8):
        port, jax_cfg = port_mesh.MeshConfig(data, table, model), jax_mesh.MeshConfig(
            data, table, model)
        try:
            want = jax_cfg.resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                port.resolve(n)
            assert str(got.value) == str(e)
        else:
            assert port.resolve(n) == want


@pytest.mark.parametrize("data, table, model", [(8, 1, 1), (4, 1, 2), (2, 2, 2), (2, 1, 4)])
def test_each_rank_owns_the_rows_jax_gives_its_device(data, table, model):
    """Rank i of an 8-rank mesh owns the rows of a 16-row batch that JAX's
    ``batch_sharding`` gives device i of ``make_mesh`` on the 8-device
    virtual mesh (ranks are laid out as JAX's devices:
    ``reshape(data, model, table)``), and has JAX's coordinates."""
    import jax

    jm = jax_mesh.make_mesh(jax_mesh.MeshConfig(data, table, model))
    rows = jax_sharding.batch_sharding(jm, 1).devices_indices_map((16,))
    for i, device in enumerate(jax.devices()):
        m = port_mesh.Mesh(port_mesh.MeshConfig(data, table, model), world=8, rank=i)
        (want,) = rows[device]
        assert sharding.process_row_range(m, 16) == (want.start or 0, want.stop or 16)
        coords = tuple(int(c) for c in np.argwhere(jm.devices == device)[0])
        assert (m.data_rank, m.model_rank, m.table_rank) == coords
        batch = {"x": np.arange(16), "valid": np.int32(16)}
        got = sharding.shard_batch(m, batch)
        np.testing.assert_array_equal(got["x"], np.arange(16)[want])
        assert got["valid"] == 16


def test_the_backend_follows_the_placement(monkeypatch):
    """NCCL where every rank has a card of its own, gloo where ranks share
    one or run on the CPU; decided from the ranks on a host and its cards,
    with no group started; no launcher, no group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert port_mesh.backend_for(4) == "nccl" and port_mesh.backend_for(2, "cuda") == "nccl"
    assert port_mesh.backend_for(8) == "gloo"  # two ranks a card
    assert port_mesh.backend_for(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_mesh.backend_for(2) == "gloo"
    for k in port_mesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert port_mesh.maybe_initialize_distributed("cpu") is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("size", [2, 4])
def test_a_ranks_masks_are_its_rows_of_one_ranks(size):
    """A rank's masks are its rows of one rank's: each data rank of a step
    draws the kernel seeds one rank draws and, outside the kernels, the
    mask of its block of the batch's rows (its heads too under tensor
    parallelism), and its two runs of the rows of a PLM call over
    candidates and history together (``Rows.concat``); the gating noise
    likewise. One rank's sequence is still ``[seed, step]``."""
    cpu = torch.device("cpu")
    B, C, H, D = 8, 3, 5, 6
    one = DropoutRNG(8, 3, cpu)
    host, device = np.random.SeedSequence([8, 3]).generate_state(2, np.uint64)
    assert one.host.initial_seed() == int(host) and one.device.initial_seed() == int(device)
    x, probs = torch.ones(B, 4, D), torch.ones(B, 4, 7, 7)
    seeds, want = one.kernel_seeds(3), one.dropout(x, 0.2)
    want_heads = one.dropout(probs, 0.3)
    want_cat = one.at(Rows.concat(one.rows_of(B * C), B * C, one.rows_of(B * H))).dropout(
        torch.ones(B * (C + H), D), 0.2)
    want_noise = one.normal((B, 8), torch.float32)
    n = B // size
    for rank in range(size):
        r = DropoutRNG(8, 3, cpu, rank, size)
        assert r.kernel_seeds(3) == seeds
        assert torch.equal(r.dropout(x[:n], 0.2), want[rank * n:(rank + 1) * n])
        heads = r.dropout(probs[:n, :2], 0.3, heads=(2, 4))
        assert torch.equal(heads, want_heads[rank * n:(rank + 1) * n, 2:4])
        rows = r.at(Rows.concat(r.rows_of(n * C), n * C, r.rows_of(n * H)))
        got = rows.dropout(torch.ones(n * (C + H), D), 0.2)
        cand = want_cat[rank * n * C:(rank + 1) * n * C]
        his = want_cat[B * C + rank * n * H:B * C + (rank + 1) * n * H]
        assert torch.equal(got, torch.cat([cand, his]))
        assert torch.equal(r.normal((n, 8), torch.float32),
                           want_noise[rank * n:(rank + 1) * n])


def test_a_table_shard_maps_indices_to_its_rows_or_the_zero_row():
    """R = 5 rows over 2 shards of 3 (the table padded to 6): rank 1 keeps
    rows 3, 4 and the pad row; an index in [-5, 0) wraps; another shard's
    row maps to the zero row (3); an index outside [-5, 5) to row 4, out of
    the local table, on rank 0 only (NaN scores there, zeros elsewhere)."""
    idx = torch.tensor([[0, 2, 3, 4, -1, -5, 5, -6]], dtype=torch.int32)
    r0 = ShardedRows(torch.zeros(4, 2), 0, 3, 5, None).local_index(idx)
    r1 = ShardedRows(torch.zeros(4, 2), 3, 3, 5, None).local_index(idx)
    assert r0.tolist() == [[0, 2, 3, 3, 3, 0, 4, 4]] and r0.dtype == torch.int32
    assert r1.tolist() == [[3, 3, 0, 1, 1, 3, 2, 3]]  # 5: the pad row, zero


# ------------------------------------------------------------- the refusals
@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mesh")
    fixture = make_fixture(str(root / "fx"), num_lines=40)
    # 22 lines, 84 candidates: the eval's last batch of 16 rows is padded
    with open(os.path.join(fixture, "behaviors.tsv")) as f, \
            open(os.path.join(fixture, "eval.tsv"), "w") as g:
        g.writelines(f.readlines()[:22])
    return fixture


def _argv(fixture, mode="eval", *extra):
    return [mode, "--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--npratio", "3",
            "--compute_dtype", "float32", "--eval_batch_size", "16", "--device", "cpu",
            "--eval_news_path", os.path.join(fixture, "news.tsv"),
            "--eval_behaviors_path", os.path.join(fixture, "eval.tsv"), *MINER, *extra]


def test_refusals(fixture_dir, tmp_path):
    """A mesh that does not cover the ranks gives JAX's text (``--mesh_data
    2`` without a launcher too, where it was once ignored); a batch that
    does not divide by the data size raises, naming both."""
    with pytest.raises(ValueError) as want:
        jax_mesh.MeshConfig(2, 1, 1).resolve(1)
    with pytest.raises(ValueError) as got:
        Trainer(make_parser().parse_args(_argv(fixture_dir, "eval", "--mesh_data", "2")))
    assert str(got.value) == str(want.value) == "mesh 2x1x1 does not cover 1 devices"
    with pytest.raises(ValueError, match="does not cover 4 devices"):
        port_mesh.Mesh(port_mesh.MeshConfig(3, 1, 1), world=4, rank=0)
    m = port_mesh.Mesh(port_mesh.MeshConfig(2), world=2, rank=1)
    with pytest.raises(ValueError, match="batch of 3 rows does not divide by the mesh's "
                                         "data size 2"):
        sharding.shard_batch(m, {"x": np.zeros(3)})


# ---------------------------------------------------------- the mesh evals
@pytest.fixture(scope="module")
def mesh_evals(fixture_dir, tmp_path_factory):
    """``eval`` of the seed's random weights from the news-embedding cache
    over 2 ranks: ``--mesh_table 2`` (the cache row-sharded) and
    ``--mesh_data 2`` (8 rows of each eval batch a rank), with the
    predictions saved; started in the background."""
    root = tmp_path_factory.mktemp("torch_mesh_evals")
    jobs = [{"argv": _argv(fixture_dir, "eval", "--save_eval_result", "--eval_path",
                           str(root / axis), f"--mesh_{axis}", "2"), "out": str(root / axis)}
            for axis in ("table", "data")]
    return root, Ranks(jobs, 2, str(root / "ranks"))


def _run_files(path):
    (run,) = glob.glob(os.path.join(path, "*"))
    with open(os.path.join(run, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    header, row = [r.split(",") for r in open(os.path.join(run, "eval.csv")).read().splitlines()]
    return preds, dict(zip(header, row))


@pytest.mark.parametrize("axis", ["table", "data"])
def test_mesh_eval_gives_one_ranks_eval(mesh_evals, fixture_dir, tmp_path, axis):
    """The table axis: the same scores, eval loss and predictions as one
    rank bit for bit (each row gathered, and each lookup+score summed, from
    the one shard holding it). The data axis: each rank scores its rows of
    every batch, the last batch padded; the gathered logits give one rank's
    metrics and loss to fp32 summation order. Both ranks return the same
    scores; rank 0 alone wrote the run's files."""
    root, ranks = mesh_evals
    one = Trainer(make_parser().parse_args(_argv(
        fixture_dir, "eval", "--save_eval_result", "--eval_path", str(tmp_path)))).eval()
    got = ranks.wait()[str(root / axis)]
    assert got[0]["scores"] == got[1]["scores"]
    (got_preds, got_csv), (want_preds, want_csv) = _run_files(root / axis), _run_files(tmp_path)
    assert got_preds["impression_id"] == want_preds["impression_id"]
    # the 84 candidates of 22 impressions: 5 batches of 16 rows, then 4 padded to 16
    assert len(want_preds["pred"]) == 84 and set(got_csv) == set(want_csv)
    if axis == "table":
        assert got[0]["scores"] == one and got_csv == want_csv
        for a, b in zip(got_preds["pred"], want_preds["pred"]):
            np.testing.assert_array_equal(a, b)
    else:
        for k, v in one.items():
            assert got[0]["scores"][k] == pytest.approx(v, rel=1e-6), k
        assert float(got_csv["loss"]) == pytest.approx(float(want_csv["loss"]), rel=1e-5)
        for a, b in zip(got_preds["pred"], want_preds["pred"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_two_hosts_of_two_ranks_take_nccl_and_their_local_cards(monkeypatch):
    """Under ``torch.distributed.run`` on two hosts of two cards, two ranks
    each (WORLD_SIZE 4, LOCAL_WORLD_SIZE 2), a rank's card is its own:
    the group starts on NCCL with the rank on ``cuda:LOCAL_RANK`` and the
    device resolves there, though the world outnumbers a host's cards."""
    from miner_tpu_torch.utils import resolve_device

    dist = torch.distributed
    for k, v in (("RANK", "3"), ("WORLD_SIZE", "4"), ("LOCAL_RANK", "1"),
                 ("LOCAL_WORLD_SIZE", "2"), ("MASTER_ADDR", "host0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    started, cards = {}, []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **k: started.update(
        k, backend=backend))
    monkeypatch.setattr(dist, "get_rank", lambda *a: 3)
    assert port_mesh.maybe_initialize_distributed() == "nccl"
    assert started == {"backend": "nccl", "rank": 3, "world_size": 4} and cards == [1]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    assert resolve_device(None) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")  # four ranks on a host of two cards
    assert port_mesh.backend_for(port_mesh.local_world_size()) == "gloo"
    assert resolve_device("cuda") == torch.device("cuda", 0)
