"""The port's int8 news-embedding cache and persisted serving cache against
the JAX package's.

``quantize_rows`` must give JAX's int8 values and scales bit for bit;
``gather_rows`` and the plain lookup+score over ``Int8Rows`` must give
JAX's numbers (float32: summation order only; bfloat16: JAX rounds the
product and then the scaled score in bf16, the port rounds once, so the
two differ by up to 2**-7 of the score plus 2**-8 of the row scale times
the dot of the magnitudes); indices in [-N, 0) wrap and those outside
[-N, N) score NaN, as ``jnp.take`` gives them. ``load_cache`` reads the
files of JAX's ``save_cache`` (bf16 as raw uint16 bits, no ``ml_dtypes``),
a port round trip holds, and a fingerprint that differs in any key (the
int8 flag included) is refused. ``serving_context`` with
``--serve_cache_path`` persists its cache and loads it at the next start
without encoding the corpus; the int8 serving path scores as JAX's does on
the same int8 cache and converted weights. Everything runs on the CPU,
where each op takes its plain version.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from miner_tpu.config import make_parser as jax_parser
from miner_tpu.ops.lookup_score import lookup_score_reference as jax_lookup
from miner_tpu.parallel import news_cache as jax_cache
from miner_tpu.training.trainer import Trainer as JaxTrainer
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.models.convert import miner_params_from_jax
from miner_tpu_torch.ops.lookup_score import lookup_score_fused, lookup_score_reference
from miner_tpu_torch.parallel.news_cache import (
    Int8Rows,
    NewsEmbeddingCache,
    gather_rows,
    load_cache,
    quantize_rows,
    save_cache,
)
from miner_tpu_torch.training import checkpoint
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

T = torch.from_numpy
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _table(rng, N=40, D=24, dtype="float32"):
    """(N, D) rows of mixed scales, an all-zero pad row 0, and a row of
    absmax 127 (scale 1) whose other values are halves (ties: rounding half
    to even is exercised), as numpy in ``dtype``."""
    emb = rng.normal(size=(N, D)) * rng.uniform(0.01, 3.0, size=(N, 1))
    emb[0] = 0.0
    emb[1, 0] = 127.0
    emb[1, 1:] = np.arange(D - 1) % 8 - 3.5
    return emb.astype(DTYPES[dtype][0])


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return T(a.view(np.int16).copy()).view(torch.bfloat16)
    return T(np.ascontiguousarray(a))


def _jax_int8(q):
    """A JAX ``Int8Rows`` -> the port's."""
    return Int8Rows(T(np.array(q.values)), T(np.array(q.scales)), q.dequant_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax_bit_for_bit(rng, dtype):
    emb = _table(rng, dtype=dtype)
    want = jax_cache.quantize_rows(jnp.asarray(emb))
    got = quantize_rows(_to_torch(emb))
    assert got.values.dtype == torch.int8 and got.scales.shape == (40, 1)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.dequant_dtype == want.dequant_dtype == dtype
    assert got.scales[0].item() == 1.0 and not got.values[0].any()  # the pad row


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_of_int8_rows_matches_jax(rng, dtype):
    """Dequantized as q.to(dt) * s.to(dt), the same rounding in both: equal."""
    q = jax_cache.quantize_rows(jnp.asarray(_table(rng, dtype=dtype)))
    idx = rng.integers(0, 40, size=(3, 7)).astype(np.int32)
    want = np.asarray(jax_cache.gather_rows(q, jnp.asarray(idx)).astype(jnp.float32))
    got = gather_rows(_jax_int8(q), T(idx))
    assert got.dtype == DTYPES[dtype][2] and got.shape == (3, 7, 24)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_lookup_matches_jax_reference(rng, dtype):
    """The port's plain int8 lookup (and the op, which takes it on the CPU)
    against ``miner_tpu.ops.lookup_score.lookup_score_reference(Int8Rows)``.
    float32: rtol 1e-5 (summation order). bfloat16: JAX rounds the einsum
    and then the product with the scale in bf16, the port rounds the fp32
    result once: within 2**-7 of the score's magnitude plus one bf16 step
    of the row's scale times its dot of magnitudes."""
    q = jax_cache.quantize_rows(jnp.asarray(_table(rng, dtype=dtype)))
    idx = rng.integers(0, 40, size=(3, 9)).astype(np.int32)
    interests = rng.normal(size=(3, 5, 24)).astype(DTYPES[dtype][0])
    want = np.asarray(jax_lookup(q, jnp.asarray(idx), jnp.asarray(interests)).astype(jnp.float32))
    cache = _jax_int8(q)
    got = lookup_score_fused(cache, T(idx), _to_torch(interests))
    assert got.dtype == DTYPES[dtype][2] and got.shape == (3, 9, 5)
    np.testing.assert_array_equal(got.numpy() if dtype == "float32" else got.float().numpy(),
                                  lookup_score_reference(cache, T(idx), _to_torch(interests))
                                  .float().numpy())
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        return
    q_abs = np.abs(np.asarray(q.values, np.float32))[idx]  # (3, 9, 24)
    i_abs = np.abs(interests.astype(np.float32))
    dots = np.einsum("bcd,bkd->bck", q_abs, i_abs) * np.asarray(q.scales)[idx]
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * dots
    assert (np.abs(got.float().numpy() - want) <= tol).all()


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_negative_indices_wrap_as_in_jax(rng, int8):
    """``jnp.take`` wraps an index in [-N, 0) to N + index and fills one
    below -N, at N or past it (NaN scores); the port's plain version, which
    the op takes on the CPU, does the same, for float and int8 caches."""
    N = 30
    emb = _table(rng, N=N)
    idx = rng.integers(0, N, size=(2, 8)).astype(np.int32)
    idx[0, :4] = [-1, -N, -N - 1, N]
    idx[1, 5:] = [-7, N + 7, -2 ** 31]
    interests = rng.normal(size=(2, 3, 24)).astype(np.float32)
    jcache = jax_cache.quantize_rows(jnp.asarray(emb)) if int8 else jnp.asarray(emb)
    want = np.asarray(jax_lookup(jcache, jnp.asarray(idx), jnp.asarray(interests)))
    cache = _jax_int8(jcache) if int8 else T(emb)
    got = lookup_score_fused(cache, T(idx), T(interests)).numpy()
    nan = np.isnan(want).all(-1)
    assert nan.tolist() == [[False, False, True, True] + [False] * 4,
                            [False] * 5 + [False, True, True]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # NaN where NaN


# ------------------------------------------------------------- cache files
def _cache(rng, kind, N=20, D=16):
    emb = _table(rng, N=N, D=D, dtype="float32" if kind == "float32" else "bfloat16")
    cat = rng.integers(0, 5, size=N).astype(np.int32)
    return emb, cat


FP = {"news_sha": "abc", "ckpt_sha": "def", "serve_cache_int8": False}


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_load_cache_reads_jax_files(rng, tmp_path, kind):
    emb, cat = _cache(rng, kind)
    jemb = jax_cache.quantize_rows(jnp.asarray(emb)) if kind == "int8" else jnp.asarray(emb)
    path = str(tmp_path / "cache.npz")
    jax_cache.save_cache(jax_cache.NewsEmbeddingCache(jemb, jnp.asarray(cat), 0), path,
                         len(cat), FP)
    got = load_cache(path, FP)
    np.testing.assert_array_equal(got.category.numpy(), cat)
    assert got.category_pad_id == 0
    if kind == "int8":
        assert got.quantized and got.embeddings.dequant_dtype == "bfloat16"
        np.testing.assert_array_equal(got.embeddings.values.numpy(), np.asarray(jemb.values))
        np.testing.assert_array_equal(got.embeddings.scales.numpy(), np.asarray(jemb.scales))
    else:
        assert got.embeddings.dtype == torch.bfloat16
        assert torch.equal(got.embeddings, _to_torch(emb))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_cache_round_trip_and_jax_reads_it(rng, tmp_path, kind):
    """save_cache then load_cache gives the same tensors bit for bit; the
    file is in the JAX package's layout (its load_cache reads it); the
    write leaves no temporary file behind."""
    emb, cat = _cache(rng, kind)
    rows = _to_torch(emb)
    cache = NewsEmbeddingCache(quantize_rows(rows) if kind == "int8" else rows, T(cat), 0)
    path = str(tmp_path / "cache.npz")
    save_cache(cache, path, len(cat), FP)
    assert os.listdir(tmp_path) == ["cache.npz"]
    got = load_cache(path, FP)
    arrays = lambda c: ((c.embeddings.values, c.embeddings.scales) if c.quantized
                        else (c.embeddings,)) + (c.category,)
    assert got.quantized == cache.quantized
    assert all(torch.equal(a, b) for a, b in zip(arrays(got), arrays(cache)))
    jgot = jax_cache.load_cache(path, FP)
    want = cache.embeddings.values if kind == "int8" else cache.embeddings.float()
    jvals = jgot.embeddings.values if kind == "int8" else jgot.embeddings.astype(jnp.float32)
    np.testing.assert_array_equal(np.asarray(jvals), want.numpy())


def test_load_cache_refuses_another_fingerprint_or_no_file(rng, tmp_path):
    emb, cat = _cache(rng, "bfloat16")
    path = str(tmp_path / "cache.npz")
    assert load_cache(path, FP) is None
    save_cache(NewsEmbeddingCache(_to_torch(emb), T(cat), 0), path, len(cat), FP)
    assert load_cache(path, FP) is not None
    for key, value in (("ckpt_sha", "other"), ("serve_cache_int8", True), ("new_key", 1)):
        assert load_cache(path, dict(FP, **{key: value})) is None, key


# --------------------------------------------------------------- serving
def _serve_flags(fixture, *extra):
    return ["serve", "--model_name", "Miner", "--pretrained_tokenizer", "hash:1000",
            "--user2id_path", os.path.join(fixture, "user2id.json"),
            "--category2id_path", os.path.join(fixture, "category2id.json"),
            "--eval_news_path", os.path.join(fixture, "news.tsv"),
            "--max_title_length", "16", "--max_sapo_length", "24", "--his_length", "5",
            "--seed", "7", "--plm_preset", "tiny", "--apply_reduce_dim", "--use_sapo",
            "--use_category_bias", "--word_embed_dim", "32", "--category_embed_dim", "8",
            "--num_context_codes", "4", "--context_code_dim", "16", "--score_type",
            "weighted", "--compute_dtype", "float32", *extra]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port checkpoint of the tiny Miner, and the fixture it serves."""
    root = str(tmp_path_factory.mktemp("torch_cache"))
    fixture = make_fixture(os.path.join(root, "data"), num_news=20, num_lines=4)
    trainer = Trainer(make_parser().parse_args([*_serve_flags(fixture), "--device", "cpu"]))
    ckpt = os.path.join(root, "ckpt", "finalModel")
    checkpoint.save(ckpt, {"params": trainer.build_model().state_dict()})
    return fixture, ckpt, root


def _requests(rng, num_news):
    cand = rng.integers(1, num_news, size=(3, 16)).astype(np.int32)
    cand[2, 6:] = 0
    his = rng.integers(0, num_news, size=(3, 5)).astype(np.int32)
    his[1, 2:] = 0
    return cand, his


@pytest.mark.parametrize("int8", [False, True], ids=["bfloat16", "int8"])
def test_serving_context_loads_its_persisted_cache(served, tmp_path, monkeypatch, rng, int8):
    """The first start encodes the corpus and persists it; the second calls
    ``encode_news`` zero times, holds the same cache and gives the same
    scores bit for bit; a start with the int8 flag flipped, or from another
    checkpoint, finds the fingerprint changed and encodes again."""
    fixture, ckpt, _ = served
    path = str(tmp_path / "serve_cache.npz")
    flags = _serve_flags(fixture, "--device", "cpu", "--compute_dtype", "bfloat16",
                         "--saved_model_path", ckpt, "--serve_cache_path", path,
                         *(["--serve_cache_int8"] if int8 else []))
    from miner_tpu_torch.models.miner import Miner

    calls = []
    encode = Miner.encode_news
    monkeypatch.setattr(Miner, "encode_news", lambda *a, **k: calls.append(1) or encode(*a, **k))
    cand, his = _requests(rng, 21)
    runs = []
    for _ in range(2):
        calls.clear()
        trainer = Trainer(make_parser().parse_args(flags))
        ctx = trainer.serving_context()
        runs.append((len(calls), ctx.cache, trainer.serve_scores(ctx.model, ctx.cache, cand, his)))
    (fresh_calls, c0, s0), (loaded_calls, c1, s1) = runs
    assert fresh_calls > 0 and loaded_calls == 0 and os.path.exists(path)
    assert c0.quantized == c1.quantized == int8
    np.testing.assert_array_equal(s0, s1)
    assert np.isfinite(s0).all()
    calls.clear()
    flipped = [f for f in flags if f != "--serve_cache_int8"] + ([] if int8 else
                                                                ["--serve_cache_int8"])
    Trainer(make_parser().parse_args(flipped)).serving_context()
    assert calls, "a cache of the other type must not be served"
    calls.clear()
    os.utime(ckpt, ns=(os.stat(ckpt).st_atime_ns, os.stat(ckpt).st_mtime_ns + 10 ** 9))
    Trainer(make_parser().parse_args(flags)).serving_context()
    assert calls, "a checkpoint written since must not be served the old cache"


def test_serve_cache_path_needs_a_checkpoint(served, tmp_path, capsys):
    fixture, _, _ = served
    path = str(tmp_path / "serve_cache.npz")
    Trainer(make_parser().parse_args(_serve_flags(
        fixture, "--device", "cpu", "--serve_cache_path", path))).serving_context()
    assert "--serve_cache_path ignored" in capsys.readouterr().out
    assert not os.path.exists(path)


def test_int8_serve_scores_match_jax(served, rng):
    """JAX's serving with --serve_cache_int8 (its int8 cache, scored by the
    XLA reference) against the port's on the same weights and the same
    int8 cache, float32: slates and the corpus top-k within float32
    summation-order noise."""
    fixture, _, _ = served
    flags = _serve_flags(fixture, "--serve_cache_int8")
    jt = JaxTrainer(jax_parser().parse_args(flags))
    jctx = jt.serving_context()
    assert jctx.cache.quantized
    tt = Trainer(make_parser().parse_args([*flags, "--device", "cpu"]))
    ctx = tt.serving_context(miner_params_from_jax(jax.device_get(jctx.params)))
    assert ctx.cache.quantized
    # the same int8 cache for both: the port's own rounds the port's rows,
    # which differ from JAX's by float32 noise (quantization is held to
    # JAX's bit for bit on the same rows above)
    cache = NewsEmbeddingCache(_jax_int8(jctx.cache.embeddings), ctx.cache.category,
                               ctx.cache.category_pad_id)
    np.testing.assert_allclose(ctx.cache.embeddings.scales.numpy(),
                               np.asarray(jctx.cache.embeddings.scales), rtol=1e-4)
    cand, his = _requests(rng, jctx.store.num_news)
    want = jt.serve_scores(jctx.model, jctx.kind, jctx.params, jctx.cache, cand, his)
    got = tt.serve_scores(ctx.model, cache, cand, his)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    n = jctx.store.num_news
    want_vals, want_rows = jt.serve_topk(jctx.model, jctx.kind, jctx.params, jctx.cache,
                                         his, 6, num_news=n)
    vals, rows = tt.serve_topk(ctx.model, cache, his, 6)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-4, atol=2e-5)
