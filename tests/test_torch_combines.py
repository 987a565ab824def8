"""The port's ``lstm`` combine and ``--legacy_poly_mask`` against the JAX
package's.

``BiLSTMCombine`` against flax's ``_BiLSTMCombine`` at one and two layers,
on float32 and bfloat16 inputs (float32 out either way: flax promotes the
cell's inputs to its float32 parameters), its parameter names
(``OptimizedLSTMCell_{j}``, bound to the combine), its dropout between
layers only, and the reference arithmetic kept on purpose in both packages:
the backward half of the result reads the sapo alone (ROADMAP Queue 3). A
Miner with ``--combine_type lstm`` carried over by ``params_from_jax``
against JAX's forward (an odd ``--word_embed_dim``, float32 and bfloat16),
and its bf16 serving cast keeping the cells in float32. The legacy 1e-30
fill: ``poly_attention_reference(..., mask_fill=1e-30)`` and the port's
``PolyAttention(legacy_mask=True)`` against JAX's, with a bias, masked slots
and a row with no clicks; twenty training micro-steps of the lstm Miner
under ``--legacy_poly_mask`` against JAX's ``train()``, and its cached
serving scores. Float32 with dropout off unless a test says otherwise;
each tolerance is stated where it is used.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import miner_tpu.training.trainer as jax_trainer
from miner_tpu.config import make_parser as jax_parser
from miner_tpu.models.news_encoder import _BiLSTMCombine
from miner_tpu.models.poly_attention import PolyAttention as JaxPolyAttention
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.data.batcher import Batcher
from miner_tpu_torch.data.samplers import OnlineSampler
from miner_tpu_torch.models.convert import params_from_jax
from miner_tpu_torch.models.dropout import DropoutRNG
from miner_tpu_torch.models.news_encoder import BiLSTMCombine
from miner_tpu_torch.models.poly_attention import PolyAttention
from miner_tpu_torch.ops.poly_attention import LEGACY_FILL, poly_attention_reference
from miner_tpu_torch.parallel.news_cache import CacheFiller
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture
from tests.test_torch_his_cache import _common, no_dropout, train_both  # noqa: F401

T = torch.from_numpy
LSTM = ("--combine_type", "lstm", "--lstm_num_layers", "2")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: the tier-1 suite
    (ROADMAP.md) runs six xdist workers on one CPU, where each worker's
    intra-op threads oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("torch_combines")), num_lines=40)


# ------------------------------------------------------------- the combine
def _combines(num_layers, hidden=8, d_in=10, seed=0):
    """JAX's combine with its initial parameters moved off init (biases
    non-zero), and the port's on them."""
    rng = np.random.default_rng(seed)
    jmod = _BiLSTMCombine(hidden, num_layers=num_layers)
    x = jnp.zeros((2, d_in))
    params = jmod.init(jax.random.PRNGKey(seed), x, x)["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.3 * rng.normal(size=a.shape)).astype(np.float32), params)
    port = BiLSTMCombine(d_in, hidden, num_layers)
    port.load_state_dict(params_from_jax(params), strict=True)
    return jmod, params, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_bilstm_combine_matches_jax(rng, num_layers, dtype):
    """flax names the cells ``OptimizedLSTMCell_0`` ... ``_{2L-1}``, each
    with ii/if/ig/io kernels (in, H) and hi/hf/hg/ho kernels (H, H) with
    biases; the port carries them over whole. On the same inputs (float32,
    or the same values in bfloat16) both return float32 (B, 2H) equal to
    float32 summation order (1e-6)."""
    jmod, params, port = _combines(num_layers)
    assert sorted(params) == [f"OptimizedLSTMCell_{j}" for j in range(2 * num_layers)]
    cell = params["OptimizedLSTMCell_0"]
    assert sorted(cell) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert set(cell["ii"]) == {"kernel"} and set(cell["hi"]) == {"kernel", "bias"}
    title = rng.normal(size=(6, 10)).astype(np.float32)
    sapo = rng.normal(size=(6, 10)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmod.apply({"params": params}, jnp.asarray(title, jdt), jnp.asarray(sapo, jdt))
    got = port(T(title).to(tdt), T(sapo).to(tdt))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got.shape == (6, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_backward_half_reads_the_sapo_alone(rng, package):
    """The reference's arithmetic, kept on purpose (ROADMAP Queue 3):
    flax's ``nn.RNN(reverse=True)`` keeps ``keep_order=False``, so the
    result's backward half is the backward cell after one step over the
    sapo alone. Another title leaves it bit-identical (one layer) and moves
    the forward half; another sapo moves both."""
    jmod, params, port = _combines(1, seed=3)
    run = ((lambda t, s: np.asarray(jmod.apply({"params": params}, jnp.asarray(t),
                                               jnp.asarray(s))))
           if package == "jax" else (lambda t, s: port(T(t), T(s)).detach().numpy()))
    title, sapo, other = (rng.normal(size=(4, 10)).astype(np.float32) for _ in range(3))
    base, new_title, new_sapo = run(title, sapo), run(other, sapo), run(title, other)
    np.testing.assert_array_equal(new_title[:, 8:], base[:, 8:])
    moved = lambda a, b: np.abs(a - b).max(axis=1)  # noqa: E731
    assert (moved(new_title[:, :8], base[:, :8]) > 1e-2).all()
    assert (moved(new_sapo[:, :8], base[:, :8]) > 1e-2).all()
    assert (moved(new_sapo[:, 8:], base[:, 8:]) > 1e-2).all()


def test_lstm_dropout_runs_between_layers_only(rng):
    """--lstm_dropout drops the next layer's input in training mode with a
    step's ``DropoutRNG``, never the last layer's output (torch's and the
    reference's semantics): one layer is unchanged by it, two are not; eval
    mode draws nothing."""
    title, sapo = (T(rng.normal(size=(4, 10)).astype(np.float32)) for _ in range(2))
    for layers, moved in ((1, False), (2, True)):
        _, _, port = _combines(layers)
        port.dropout = 0.5
        want = port.eval()(title, sapo)
        assert torch.equal(port(title, sapo, DropoutRNG(1, 0, "cpu")), want)
        got = port.train()(title, sapo, DropoutRNG(1, 0, "cpu"))
        assert torch.equal(got, want) != moved


# --------------------------------------------------------------- the Miner
def _miner_flags(fixture, *extra):
    """The tiny Miner of tests/test_torch_training.py under the lstm combine
    of two layers, word_embed_dim 33: news vectors of (33 // 2) * 2 = 32."""
    return ["train", *_common(fixture), "--model_name", "Miner", "--apply_reduce_dim",
            "--use_sapo", "--use_category_bias", "--word_embed_dim", "33",
            "--category_embed_dim", "8", "--num_context_codes", "4",
            "--context_code_dim", "16", "--score_type", "weighted", *LSTM, *extra]


def _miner_pair(fixture, *extra):
    """JAX's lstm Miner (its fused paths, which on the CPU run the XLA
    references the port's kernels follow) with its initial parameters, the
    port's carried over, and a batch."""
    jt = jax_trainer.Trainer(jax_parser().parse_args(
        [*_miner_flags(fixture, *extra), "--fused_kernels"]))
    tt = Trainer(make_parser().parse_args([*_miner_flags(fixture, *extra), "--device", "cpu"]))
    news = os.path.join(fixture, "news.tsv")
    js, ts = jt._load_store(news), tt._load_store(news)
    tlog = tt._load_log(os.path.join(fixture, "behaviors.tsv"), ts)
    batch = next(Batcher(8).batches(OnlineSampler(tlog, ts, 3, seed=7).sample_epoch(0)))
    jmodel, kind = jt.build_model(js)
    example = {k: jnp.asarray(batch[k]) for k in ("cand_idx", "his_idx")}
    params = jax.device_get(jt._init_params_for_kind(jmodel, kind, jt._host_table(js),
                                                     example))
    model = tt.build_model()
    model.load_state_dict(params_from_jax(params), strict=True)
    return jt, tt, js, ts, jmodel, params, model.eval(), batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_miner_forward_matches_jax(fixture_dir, dtype):
    """The whole JAX tree loads strictly (its four cells under
    ``news_encoder.lstm_combine.cells``); the news vectors are float32 of
    width 32 in either compute type, and the interests and scores equal
    JAX's: float32 to 1e-5 of their scale (summation order), bfloat16 to
    2e-2 (the two packages round the PLM's bf16 intermediates at other
    places)."""
    jt, tt, js, ts, jmodel, params, model, batch = _miner_pair(
        fixture_dir, "--compute_dtype", dtype)
    assert model.news_encoder.embed_dim == 32
    assert sorted(params["news_encoder"]["lstm_combine"]) == [
        f"OptimizedLSTMCell_{j}" for j in range(4)]
    jtable, ttable = jt._make_table(js), tt._make_table(ts)
    c, h = (jnp.asarray(batch[k]) for k in ("cand_idx", "his_idx"))
    interests, logits = jax.jit(lambda p: jmodel.apply({"params": p}, jtable.lookup(c, h)))(
        params)
    with torch.no_grad():
        cand, his = model.news_encoder.encode_batch(
            ttable.lookup(T(batch["cand_idx"]), T(batch["his_idx"])))
        got_i, got_l = model(ttable.lookup(T(batch["cand_idx"]), T(batch["his_idx"])))
    assert cand.dtype == his.dtype == got_i.dtype == torch.float32 and cand.shape[-1] == 32
    rel = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((got_i, interests), (got_l, logits)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * max(1.0, np.abs(want).max()))


def test_bf16_serving_cast_keeps_the_lstm_cells_fp32(fixture_dir):
    """bf16 serving casts the parameters once, but not the LSTM cells',
    which flax computes in float32 from float32 parameters: the cache and
    the scores equal a float32-master model's bit for bit."""
    argv = ["serve", *_miner_flags(fixture_dir)[1:], "--device", "cpu", "--compute_dtype",
            "bfloat16", "--eval_news_path", os.path.join(fixture_dir, "news.tsv")]
    trainer = Trainer(make_parser().parse_args(argv))
    ctx = trainer.serving_context()
    lstm = ctx.model.news_encoder.lstm_combine
    assert all(p.dtype == torch.float32 for p in lstm.parameters())
    assert ctx.model.news_encoder.reduce_dim.weight.dtype == torch.bfloat16
    assert ctx.cache.embeddings.dtype == torch.float32
    model = trainer.build_model().eval()
    cache = CacheFiller(model.encode_news).fill(ctx.table)
    assert torch.equal(cache.embeddings, ctx.cache.embeddings)
    cand = np.array([[1, 2, 3, 0], [5, 6, 0, 0]], np.int32)
    his = np.array([[4, 5, 7, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    np.testing.assert_array_equal(trainer.serve_scores(model, cache, cand, his),
                                  trainer.serve_scores(ctx.model, ctx.cache, cand, his))


# ------------------------------------------------------- the legacy fill
def test_legacy_fill_matches_jax_poly_attention(rng):
    """JAX's ``PolyAttention(legacy_mask=True)`` (a masked slot's logit is
    1e-30 in place of logits + bias) against ``poly_attention_reference``
    with ``mask_fill=1e-30`` and the port's module with ``legacy_mask``, a
    category bias of 3 candidates, partly masked rows and a row with no
    clicks, which gets the mean of all H rows, pads included (float32
    summation order, 1e-6). The -1e9 fill differs wherever a row is partly
    masked."""
    B, H, D, K, P, C = 4, 6, 8, 3, 5, 3
    emb = rng.normal(size=(B, H, D)).astype(np.float32)
    mask = np.ones((B, H), np.int32)
    mask[0, 4:], mask[1, 1:], mask[2] = 0, 0, 0
    bias = rng.normal(size=(B, H, C)).astype(np.float32)
    jmod = JaxPolyAttention(K, P, legacy_mask=True)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(bias))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(emb), jnp.asarray(mask),
                                 jnp.asarray(bias)))
    w, codes = torch.tensor(params["proj_kernel"]), torch.tensor(params["context_codes"])
    got = poly_attention_reference(T(emb), w, codes, T(mask), T(bias).mean(-1),
                                   mask_fill=LEGACY_FILL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    port = PolyAttention(D, K, P, legacy_mask=True)
    port.load_state_dict(params_from_jax(params), strict=True)
    np.testing.assert_allclose(port(T(emb), T(mask), T(bias)).detach().numpy(), want,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(want[2], np.broadcast_to(emb[2].mean(0), (K, D)), atol=1e-6)
    masked = poly_attention_reference(T(emb), w, codes, T(mask), T(bias).mean(-1)).numpy()
    assert np.abs(masked[:2] - want[:2]).max() > 1e-3
    np.testing.assert_allclose(masked[2:], want[2:], rtol=0, atol=1e-6)


def test_twenty_micro_steps_lstm_legacy_match_jax(fixture_dir, tmp_path, no_dropout):
    """The lstm Miner (two layers, word_embed_dim 32) under
    --legacy_poly_mask: twenty micro-steps of both ``train()`` loops on the
    same batches from the same weights, every one on the full history;
    losses to 1e-5 and weights to 1e-4 (as tests/test_torch_his_cache.py
    states). Then the cached serving scores of JAX's trained weights, a
    no-click user included, in both packages: 1e-4 relative (float32)."""
    r = train_both(fixture_dir, str(tmp_path), "Miner", *LSTM, "--legacy_poly_mask")
    assert r["jax_tags"] == r["port_tags"] == ["full"] * 20 and r["jax_fills"] == []
    np.testing.assert_allclose(r["port_losses"], r["jax_losses"], rtol=1e-5, atol=1e-5)
    assert r["jax_losses"][0] != r["jax_losses"][-1]
    for k, want in r["jax_params"].items():
        np.testing.assert_allclose(r["port_params"][k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    assert any(k.startswith("news_encoder.lstm_combine.cells.3.") for k in r["jax_params"])
    base = ["serve", *_common(fixture_dir), "--model_name", "Miner", "--apply_reduce_dim",
            "--use_sapo", "--use_category_bias", "--word_embed_dim", "32",
            "--category_embed_dim", "8", "--num_context_codes", "4", "--context_code_dim",
            "16", "--score_type", "weighted", *LSTM, "--legacy_poly_mask",
            "--eval_news_path", os.path.join(fixture_dir, "news.tsv")]
    jax_base = [w for w in base if w not in LSTM[2:]]  # JAX's serve parser lacks the depth
    jserve = jax_trainer.Trainer(jax_parser().parse_args(jax_base))
    jserve.args.lstm_num_layers = 2  # its build_model reads it with getattr
    tserve = Trainer(make_parser().parse_args([*base, "--device", "cpu"]))
    store = jserve._load_store(jserve.args.eval_news_path)
    jmodel, kind = jserve.build_model(store)
    params = jax.tree_util.tree_map(jnp.asarray, r["jax_tree"])
    jcache = jserve._build_eval_cache(jmodel, params, jserve._make_table(store))
    ctx = tserve.serving_context(params_from_jax(r["jax_tree"]))
    cand = np.zeros((3, 8), np.int32)
    cand[0, :5], cand[1, :7], cand[2, :3] = [1, 2, 3, 5, 8], np.arange(3, 10), [4, 6, 9]
    his = np.zeros((3, 5), np.int32)
    his[0, :3], his[2, :5] = [3, 7, 11], [1, 2, 4, 6, 8]  # row 1 has no clicks
    want = jserve.serve_scores(jmodel, kind, params, jcache, cand, his)
    got = tserve.serve_scores(ctx.model, ctx.cache, cand, his)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
