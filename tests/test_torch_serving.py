"""The port's serving slice as a whole against the JAX package's.

The JAX ``Trainer(args).serving_context()`` builds the fixture corpus, a
randomly initialised Miner and its news-embedding cache; the port's
``Trainer`` (``--device cpu``, so every op runs its plain version) gets the
same weights through ``miner_params_from_jax``. The caches, slate scores,
whole-corpus top-k and one HTTP round trip must agree within float32
summation-order noise. Also: the port's package imports neither JAX nor the
JAX package, the CLI parses ``config/serve_miner.txt``, and the flags this
slice cannot honour are refused.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

from miner_tpu.config import make_parser as jax_parser
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.models.convert import miner_params_from_jax
from miner_tpu_torch.serving import MicroBatcher, ScoringService, make_http_server
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=2e-5)
HIS = 5


def _base(fixture):
    return [
        "--model_name", "Miner",
        "--pretrained_tokenizer", "hash:1000",
        "--user2id_path", os.path.join(fixture, "user2id.json"),
        "--category2id_path", os.path.join(fixture, "category2id.json"),
        "--eval_news_path", os.path.join(fixture, "news.tsv"),
        "--max_title_length", "16", "--max_sapo_length", "24",
        "--his_length", str(HIS), "--seed", "7", "--plm_preset", "tiny",
        "--apply_reduce_dim", "--use_sapo", "--use_category_bias",
        "--word_embed_dim", "32", "--category_embed_dim", "8",
        "--num_context_codes", "4", "--context_code_dim", "16",
        "--score_type", "weighted", "--compute_dtype", "float32",
    ]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    fixture = make_fixture(str(tmp_path_factory.mktemp("torch_serve")),
                           num_news=20, num_lines=4)
    base = _base(fixture)
    jt = JaxTrainer(jax_parser().parse_args(["serve", *base]))
    jctx = jt.serving_context()
    state = miner_params_from_jax(jax.device_get(jctx.params))
    tt = Trainer(make_parser().parse_args(
        ["serve", *base, "--device", "cpu", "--port", "0"]))
    service = ScoringService(tt, state_dict=state)
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield jt, jctx, service, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    service.close()
    thread.join(timeout=5)


def _requests(num_news, rng):
    """A bucketed (B=2, C=16) slate batch: a few candidates, then the pad
    news; history rows with padded slots."""
    cand = np.zeros((2, 16), np.int32)
    cand[0, :5] = rng.choice(np.arange(1, num_news), 5, replace=False)
    cand[1, :9] = rng.choice(np.arange(1, num_news), 9, replace=False)
    his = np.zeros((2, HIS), np.int32)
    his[0, :3] = [3, 7, 11]
    his[1, :5] = [1, 2, 4, 8, 16]
    return cand, his


def test_news_store_tables_match_jax(pair):
    _, jctx, service, _ = pair
    js, ts = jctx.store, service.ctx.store
    assert ts.id_to_row == js.id_to_row
    for name in ("title", "sapo", "category"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


def test_cache_embeddings_match_jax(pair):
    _, jctx, service, _ = pair
    want = np.asarray(jctx.cache.embeddings)
    got = service.ctx.cache.embeddings.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(service.ctx.cache.category.numpy(),
                                  np.asarray(jctx.cache.category))


def test_serve_scores_match_jax(pair, rng):
    jt, jctx, service, _ = pair
    cand, his = _requests(jctx.store.num_news, rng)
    want = jt.serve_scores(jctx.model, jctx.kind, jctx.params, jctx.cache, cand, his)
    ctx = service.ctx
    got = service.trainer.serve_scores(ctx.model, ctx.cache, cand, his)
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_serve_topk_matches_jax(pair, rng):
    jt, jctx, service, _ = pair
    _, his = _requests(jctx.store.num_news, rng)
    n = jctx.store.num_news
    want_vals, want_rows = jt.serve_topk(jctx.model, jctx.kind, jctx.params,
                                         jctx.cache, his, 6, num_news=n)
    ctx = service.ctx
    vals, rows = service.trainer.serve_topk(ctx.model, ctx.cache, his, 6)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(vals, want_vals, **TOL)
    assert (rows > 0).all()  # the pad news never enters the ranking


def test_http_round_trip_ranks_as_jax(pair):
    jt, jctx, service, url = pair
    history, candidates = ["N1", "N3", "N5"], ["N7", "N8", "N2", "N12", "N0"]
    req = urllib.request.Request(
        url + "/score", data=json.dumps({"history": history,
                                         "candidates": candidates}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200
        got = json.loads(r.read())["results"]
    row = jctx.store.id_to_row
    cand = np.zeros((1, 16), np.int32)
    cand[0, :5] = [row[n] for n in candidates]
    his = np.zeros((1, HIS), np.int32)
    his[0, :3] = [row[n] for n in history]
    want = jt.serve_scores(jctx.model, jctx.kind, jctx.params, jctx.cache,
                           cand, his)[0, :5]
    order = np.argsort(-want)
    assert [nid for nid, _ in got] == [candidates[i] for i in order]
    np.testing.assert_allclose([s for _, s in got], want[order], **TOL)


def test_port_imports_no_jax():
    code = ("import sys, miner_tpu_torch, miner_tpu_torch.serving, "
            "miner_tpu_torch.training.trainer, miner_tpu_torch.cli, "
            "miner_tpu_torch.evaluation, miner_tpu_torch.training.optim, "
            "miner_tpu_torch.training.checkpoint, miner_tpu_torch.ops.philox; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'miner_tpu' or m.startswith('miner_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_serve_config_parses_unchanged():
    args = make_parser().parse_args(
        ["serve", "@" + os.path.join(REPO, "config", "serve_miner.txt")])
    assert (args.plm_preset, args.max_title_length, args.max_sapo_length) == (
        "roberta_base", 32, 128)
    assert (args.his_length, args.num_context_codes, args.context_code_dim,
            args.word_embed_dim, args.score_type) == (50, 32, 200, 256, "weighted")
    assert args.use_category_bias and args.use_sapo and args.apply_reduce_dim
    assert args.compute_dtype == "bfloat16" and args.device is None


def _option_strings(parser):
    """Each subcommand's option strings."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {s for act in p._actions for s in act.option_strings}
            for name, p in sub.choices.items()}


def test_every_jax_option_is_accepted_by_the_port():
    """The port takes the JAX package's flags: it has every subcommand of
    the JAX parser, and each one's option strings are a subset of the
    port's for the same subcommand."""
    jax_opts, port_opts = _option_strings(jax_parser()), _option_strings(make_parser())
    assert set(jax_opts) <= set(port_opts)
    missing = {name: sorted(opts - port_opts[name]) for name, opts in jax_opts.items()}
    assert missing == {name: [] for name in missing}
    args = make_parser().parse_args(
        ["serve", "@" + os.path.join(REPO, "config", "serve_miner.txt"),
         "--serve_max_slate", "64"])
    assert args.serve_max_slate == 64


def _args(tmp_path, *extra):
    fixture = make_fixture(str(tmp_path), num_news=4, num_lines=2)
    return make_parser().parse_args(["serve", *_base(fixture), *extra])


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Trainer(_args(tmp_path))  # --device unset means cuda


@pytest.mark.parametrize("extra, match", [
    (["--combine_type", "lstm"], "combine_type"),
])
def test_unported_flags_are_refused(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        Trainer(_args(tmp_path, "--device", "cpu", *extra))


def test_no_fused_kernels_on_a_card_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="always runs the port's kernels"):
        Trainer(_args(tmp_path, "--no-fused_kernels"))


def test_legacy_poly_mask_is_refused(tmp_path):
    trainer = Trainer(_args(tmp_path, "--device", "cpu", "--legacy_poly_mask"))
    with pytest.raises(NotImplementedError, match="legacy_poly_mask"):
        trainer.build_model()


def test_same_seed_same_weights_on_any_device(tmp_path):
    a = Trainer(_args(tmp_path, "--device", "cpu")).build_model().state_dict()
    b = Trainer(_args(tmp_path, "--device", "cpu")).build_model().state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_microbatcher_coalesces_queued_requests():
    calls, release = [], threading.Event()

    def score_fn(cand_idx, his_idx):
        calls.append(cand_idx.shape)
        if len(calls) == 1:
            assert release.wait(10)
        return cand_idx * 2.0 + his_idx.sum(axis=1, keepdims=True)

    mb = MicroBatcher(score_fn, his_length=3, max_batch=8, max_wait_ms=50)
    results = {}

    def submit(i):
        cand = list(range(10 * i + 1, 10 * i + 3 + i))
        results[i] = (cand, mb.submit(cand, np.full((3,), i, np.int32)))

    threads = [threading.Thread(target=submit, args=(0,))]
    threads[0].start()
    deadline = time.monotonic() + 10
    while not calls and time.monotonic() < deadline:
        time.sleep(0.001)
    threads += [threading.Thread(target=submit, args=(i,)) for i in range(1, 5)]
    for t in threads[1:]:
        t.start()
    while mb._q.qsize() < 4 and time.monotonic() < deadline:
        time.sleep(0.001)
    release.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert len(calls) == 2 and calls[1][0] >= 4  # four requests, one call
    for i, (cand, got) in results.items():
        np.testing.assert_array_equal(got, np.asarray(cand) * 2.0 + 3 * i)
    assert mb.requests == 5 and mb.device_batches == 2
    mb.close()


def test_microbatcher_propagates_errors_and_survives():
    calls = {"n": 0}

    def boom_once(cand_idx, his_idx):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("kaboom")
        return cand_idx.astype(np.float64)

    mb = MicroBatcher(boom_once, his_length=2, max_batch=4, max_wait_ms=0)
    with pytest.raises(RuntimeError, match="kaboom"):
        mb.submit([1, 2], np.zeros((2,), np.int32))
    np.testing.assert_array_equal(mb.submit([3], np.zeros((2,), np.int32)), [3.0])
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit([3], np.zeros((2,), np.int32))
