"""The FLOP and byte counts behind ``mfu.*`` and ``*_roofline.*`` against
the hand counts, and the roofline against ``chip_smoke.py:bound_ms``'s
arithmetic."""
import json
import math
import os
from types import SimpleNamespace

import pytest

from harness import flops, spec

MINER = spec.cell("miner-train").config
with open(os.path.join(spec.BENCH_DIR, "configs", "unbert-bert-base.json")) as f:
    UNBERT = json.load(f)


def test_miner_micro_batch_flops_match_the_hand_count():
    # 880 news; per news 12 layers at L = 32 and 128: 14.16 MFLOP a token in
    # the products, 4 L^2 768 a sequence in attention; x 3 for the backward
    assert flops.miner_micro_batch_flops(MINER) == pytest.approx(7.345e13, rel=1e-3)


def test_products_with_the_recompute():
    ops, nbytes = flops.miner_products(MINER)
    assert ops == pytest.approx(9.57e13, rel=1e-3)
    assert ops / nbytes > 300  # bound by operations, as products of these sizes are


def test_unbert_row_flops():
    word = 12 * (300 * 2 * 768 * 9216 + 4 * 300 ** 2 * 768)
    news = 12 * (23 * 2 * 768 * 9216 + 4 * 23 ** 2 * 768)
    assert flops.unbert_row_flops(UNBERT) == pytest.approx(word + news + 2 * 2 * 768 * 2)


@pytest.mark.parametrize("nbytes,ops", [(1e9, 1e11), (1e8, 1e13), (4.1e6, 7.1e9)])
def test_bound_is_chip_smokes_arithmetic(nbytes, ops):
    t_bytes, t_ops = nbytes / 3.35e12, ops / 989e12  # chip_smoke.py:bound_ms
    got, which = flops.bound_s(ops, nbytes, "bfloat16")
    assert got == pytest.approx(max(t_bytes, t_ops))
    assert which == ("bytes" if t_bytes >= t_ops else "operations")


def test_mha_work_counts_each_byte_once():
    w = flops.mha_work(MINER, 880, 128)
    fwd_ops, fwd_bytes = w["forward"]
    assert fwd_ops == pytest.approx(880 * 12 * 4 * 128 ** 2 * 768)
    assert fwd_bytes == pytest.approx(880 * 12 * (2 * 4 * 128 * 768 + 4 * 128))
    assert w["backward"][0] == pytest.approx(2 * fwd_ops)


def _train_ctx(kernels, window_s, busy_s=1.0, micro_batches=4):
    return SimpleNamespace(kind="train", cfg={**MINER}, micro_batches=micro_batches,
                           trace={"kernels": kernels, "window_s": window_s, "busy_s": busy_s},
                           spans=None, updated=[])


def test_readers_give_shares_of_their_bounds():
    cell = spec.cell("miner-train")
    kernels = {"nvjet_tst_192x192_bias_TNN": (0.6, 100), "mha_fwd_bf16<64>": (0.04, 96),
               "void mha_bwd_bf16<64>": (0.08, 96), "add_ln_fwd": (0.05, 384)}
    ctx = _train_ctx(kernels, window_s=1.2)
    gemm = cell.readers["gemm_roofline.train"].read(ctx)
    bound = 4 * 9.57e13 / 989e12
    assert gemm == pytest.approx(100 * bound / 0.6, rel=1e-3)
    mfu = cell.readers["mfu.train"].read(ctx)
    assert mfu == pytest.approx(100 * 4 * 7.345e13 / (1.2 * 989e12), rel=1e-3)
    assert 0 < cell.readers["mha_roofline.train"].read(ctx) < 100
    assert cell.readers["device_idle_pct.train"].read(ctx) == pytest.approx(100 * (1 - 1 / 1.2))


def test_readers_return_nothing_when_there_is_nothing_to_read():
    cell = spec.cell("miner-train")
    ctx = _train_ctx({"add_ln_fwd": (0.05, 384)}, window_s=1.0)
    assert cell.readers["gemm_roofline.train"].read(ctx) is None
    assert cell.readers["mha_roofline.train"].read(ctx) is None
    ctx.trace = None
    assert all(cell.readers[m].read(ctx) is None for m in ("mfu.train", "device_idle_pct.train"))
    from tiny import RERANK_METRICS

    assert all(spec.reader(name).read(ctx) is None for name in RERANK_METRICS)
    assert not math.isnan(flops.peak_flops("bfloat16"))
