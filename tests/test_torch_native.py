"""The port's native data plane (``miner_tpu_torch/data/native.py`` over its
copy of the C++ source, ``csrc/host/miner_data.cpp``) against the JAX
package's (``miner_tpu/data/native.py`` over ``native/miner_data.cpp``).

  * draws: the port's ``sample_epoch`` equals JAX's bit for bit, modes base
    and hard, V = 1 and 4 variants, seeds 0, 7 and 2**63 + 5 (masked to 64
    bits on both sides), epochs 0 and 1; ``pack_unbert`` equals JAX's in the
    clicks-first and the legacy (pads-first) layouts;
  * native against numpy: the native packer equals the port's numpy packer,
    and the native sampler keeps the numpy sampler's invariants (as
    ``tests/test_native.py`` holds JAX's);
  * the ``backend`` rules: ``native`` raises where the library is
    unavailable (``MINER_TPU_NO_NATIVE``), ``auto`` warns once and takes
    numpy, and the call counters count native calls alone;
  * over a mesh: every data rank samples the same global epoch, so a rank's
    rows of a native epoch's batches are its rows of the one-rank batches;
  * the build: processes that build at the same time into one directory
    each load a whole library.
"""
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from miner_tpu.data import native as jax_native
from miner_tpu_torch.data import HashTokenizer, NewsStore
from miner_tpu_torch.data import native, samplers
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.behaviors import BehaviorsLog
from miner_tpu_torch.data.samplers import OfflineSampler, OnlineSampler
from miner_tpu_torch.data.unbert_packing import UnbertPacker, pack_rows
from miner_tpu_torch.parallel.mesh import Mesh, MeshConfig
from miner_tpu_torch.parallel.sharding import shard_batch
from tests.fixture_data import make_fixture

SEEDS = (0, 7, 2 ** 63 + 5)


@pytest.fixture(scope="module")
def log_arrays():
    """A synthetic train log: 600 events over 400 news, 0 to 29 negatives an
    event (some fewer than the candidates, which pads)."""
    rng = np.random.default_rng(0)
    E, N = 600, 400
    counts = rng.integers(0, 30, E)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (E, N, rng.integers(1, N, E).astype(np.int32),
            rng.integers(1, N, int(offsets[-1])).astype(np.int32), offsets)


@pytest.fixture(scope="module")
def store_and_log(tmp_path_factory):
    import json

    d = make_fixture(str(tmp_path_factory.mktemp("native_fix")), num_lines=25,
                     augmentations=("enhanced_text", "changed_topic_text"))
    tok = HashTokenizer(vocab_size=1000)
    cat2id = json.load(open(os.path.join(d, "category2id.json")))
    user2id = json.load(open(os.path.join(d, "user2id.json")))
    store = NewsStore.from_tsv(os.path.join(d, "news.tsv"), tok, cat2id, 16, 24,
                               augmentations=["enhanced_text", "changed_topic_text"])
    log = BehaviorsLog.from_tsv(os.path.join(d, "behaviors.tsv"), store, user2id, 5)
    return store, log


def test_both_libraries_are_built():
    assert native.native_available() and jax_native.native_available()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().name.startswith(f"libminer_data.v{native.ABI_VERSION}.")


@pytest.mark.parametrize("mode", ["base", "hard"])
@pytest.mark.parametrize("V", [1, 4])
def test_sample_epoch_is_jax_s_bit_for_bit(log_arrays, mode, V):
    E, N, pos, negs, offsets = log_arrays
    before = native.sample_epoch.calls
    for seed in SEEDS:
        for epoch in (0, 1):
            for C in (5, 11):
                want = jax_native.sample_epoch(seed, epoch, mode, E, C, V, N, pos, negs, offsets)
                got = native.sample_epoch(seed, epoch, mode, E, C, V, N, pos, negs, offsets)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == (E, C)
                    np.testing.assert_array_equal(g, w, err_msg=f"{seed} {epoch} {C}")
                if mode == "hard" and V > 1:  # several variants of the positive drawn
                    assert ((got[0] >= N) & (got[1] == 0)).any()
    assert native.sample_epoch.calls == before + len(SEEDS) * 4
    # int64 inputs convert, as the C side takes int32
    got = native.sample_epoch(7, 0, mode, E, 5, V, N, pos.astype(np.int64),
                              negs.astype(np.int64), offsets.astype(np.int64))
    want = jax_native.sample_epoch(7, 0, mode, E, 5, V, N, pos, negs, offsets)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("legacy", [False, True], ids=["clicks_first", "legacy"])
def test_pack_unbert_is_jax_s_bit_for_bit(legacy):
    rng = np.random.default_rng(1)
    R, Lt, H = 40, 24, 30
    tokens = rng.integers(3, 1000, (R, Lt)).astype(np.int32)
    lens = rng.integers(1, 21, R).astype(np.int32)
    cand = rng.integers(0, R, 64).astype(np.int32)
    hist = rng.integers(0, R, (64, H)).astype(np.int32)
    hist[::3, 5:] = 0  # short histories, pads after the clicks
    if legacy:
        hist = np.sort(hist, axis=1)  # pads first
    for geometry in ((300, 20, 20), (40, 8, 5)):
        want = jax_native.pack_unbert(tokens, np.minimum(lens, geometry[1]), cand, hist,
                                      *geometry, 1, 2, 0, legacy_layout=legacy)
        got = native.pack_unbert(tokens, np.minimum(lens, geometry[1]), cand, hist,
                                 *geometry, 1, 2, 0, legacy_layout=legacy)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("legacy", [False, True], ids=["clicks_first", "legacy"])
def test_native_packer_equals_numpy_packer(store_and_log, legacy):
    store, log = store_and_log
    packer = UnbertPacker(store, cls_id=1, sep_id=2, pad_id=0, legacy_layout=legacy)
    hist = log.history[log.hist_ptr]
    if legacy:
        hist = np.sort(hist, axis=1)
    cand = np.concatenate([log.pos_row, log.pos_row + store.num_news, [0]])
    hist = np.concatenate([hist, hist, hist[:1]])
    before = native.pack_unbert.calls
    got = pack_rows(packer, cand, hist, backend="native")
    assert native.pack_unbert.calls == before + 1
    want = pack_rows(packer, cand, hist, backend="numpy")
    assert native.pack_unbert.calls == before + 1
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["base", "hard"])
def test_native_sampler_keeps_the_numpy_invariants(store_and_log, mode):
    """One label 1 a row, at a variant of the event's positive; the other
    candidates negatives of the event, pad, or (hard) other variants of the
    positive, in distinct slots; deterministic in (seed, epoch), another
    epoch another draw; the history and impression ids as numpy's."""
    store, log = store_and_log
    N, V = store.num_news, store.num_variants
    assert V == 3
    a = OnlineSampler(log, store, 4, seed=3, mode=mode, backend="native")
    b = OnlineSampler(log, store, 4, seed=3, mode=mode, backend="numpy")
    blk, ref = a.sample_epoch(0), b.sample_epoch(0)
    assert blk.cand.shape == ref.cand.shape and blk.cand.dtype == ref.cand.dtype
    np.testing.assert_array_equal(blk.his, ref.his)
    np.testing.assert_array_equal(blk.impression_id, ref.impression_id)
    assert (blk.label.sum(axis=1) == 1).all()
    variants = set()
    for e in range(log.num_events):
        row, lab = blk.cand[e], blk.label[e]
        pos = int(np.argmax(lab))
        assert row[pos] % N == log.pos_row[e] and row[pos] // N < V
        variants.add(int(row[pos] // N))
        negs = set(log.negatives(e).tolist()) | {0}
        for c in range(len(row)):
            if c != pos:
                assert row[c] in negs or (mode == "hard" and row[c] % N == log.pos_row[e])
        real = row[row != 0]
        assert len(set(real.tolist())) == len(real)
    assert variants == set(range(V))
    np.testing.assert_array_equal(a.sample_epoch(0).cand, blk.cand)
    assert not np.array_equal(a.sample_epoch(1).cand, blk.cand)
    assert np.array_equal(OfflineSampler(log, store, 4, seed=3, mode=mode,
                                         backend="native").sample_epoch(1).cand, blk.cand)


def test_backend_rules(store_and_log, monkeypatch, caplog):
    store, log = store_and_log
    with pytest.raises(ValueError, match="unknown sampler backend"):
        OnlineSampler(log, store, 4, backend="c++")
    monkeypatch.setenv("MINER_TPU_NO_NATIVE", "1")
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="native sampler requested but unavailable"):
        OnlineSampler(log, store, 4, backend="native").sample_epoch(0)
    monkeypatch.setattr(samplers, "_warned_fallback", False)
    before = native.call_counts()
    with caplog.at_level(logging.WARNING, logger=samplers.__name__):
        auto = OnlineSampler(log, store, 4, seed=3).sample_epoch(0)
        OnlineSampler(log, store, 4, seed=3).sample_epoch(1)
    warnings = [r for r in caplog.records if "falling back to the numpy" in r.message]
    assert len(warnings) == 1
    np.testing.assert_array_equal(
        auto.cand, OnlineSampler(log, store, 4, seed=3, backend="numpy").sample_epoch(0).cand)
    assert native.call_counts() == before
    monkeypatch.delenv("MINER_TPU_NO_NATIVE")
    assert native.native_available()
    np.testing.assert_array_equal(
        OnlineSampler(log, store, 4, seed=3).sample_epoch(0).cand,
        OnlineSampler(log, store, 4, seed=3, backend="native").sample_epoch(0).cand)
    assert native.call_counts()["sample_epoch"] == before["sample_epoch"] + 2


@pytest.mark.parametrize("data", [2, 4])
def test_a_data_rank_takes_its_rows_of_the_one_rank_epoch(store_and_log, data):
    """Each rank draws the epoch itself (the native draws depend on (seed,
    epoch, event) alone) and feeds its rows of each global batch: the
    concatenated ranks' rows are the one-rank batches, epoch after epoch."""
    store, log = store_and_log
    bat = Batcher(8, drop_last=True, shuffle=True, seed=3)
    one = Mesh(MeshConfig(1), world=1, rank=0)
    for epoch in (0, 1):
        whole = list(bat.batches(OnlineSampler(log, store, 4, seed=3, mode="hard",
                                               backend="native").sample_epoch(epoch), epoch))
        assert whole
        per_rank = []
        for r in range(data):
            mesh = Mesh(MeshConfig(data), world=data, rank=r)
            block = OnlineSampler(log, store, 4, seed=3, mode="hard",
                                  backend="native").sample_epoch(epoch)
            per_rank.append([shard_batch(mesh, b) for b in bat.batches(block, epoch)])
        for i, b in enumerate(whole):
            assert shard_batch(one, b) is b
            for k in ("cand_idx", "his_idx", "label"):
                got = np.concatenate([per_rank[r][i][k] for r in range(data)])
                np.testing.assert_array_equal(got, b[k], err_msg=k)


def test_processes_building_together_each_load_a_whole_library(tmp_path):
    """Three processes build into one empty directory at once (as the test
    workers may): each compiles to a name of its own and moves it into
    place, and each loads a library whose draws are JAX's."""
    code = ("import sys; from pathlib import Path; import numpy as np; "
            "from miner_tpu_torch.data import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); "
            "c, _ = native.sample_epoch(5, 0, 'base', 3, 2, 1, 10, np.array([1, 2, 3]), "
            "np.array([4, 5, 6, 7]), np.array([0, 1, 3, 4])); print(c.tolist())")
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    env.pop("MINER_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    want, _ = jax_native.sample_epoch(5, 0, "base", 3, 2, 1, 10, np.array([1, 2, 3]),
                                      np.array([4, 5, 6, 7]), np.array([0, 1, 3, 4]))
    assert {o for o, _ in outs} == {f"{want.tolist()}\n"}
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
