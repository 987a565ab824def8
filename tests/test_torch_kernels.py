"""The port's kernel wrappers: dispatch, argument checks, and, on a card,
each CUDA or Triton kernel against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so the card-only tests
run on a machine without them (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Here, without a card, those tests skip from inside (``gpu`` marker).
Tolerance on the card: float32 differs by summation order only (1e-4 of the
values' scale); bfloat16 by the rounding of the output and of the
intermediates the kernels round (2**-6 of the scale, a few ulps).
"""
import numpy as np
import pytest
import torch

from miner_tpu_torch.ops import (
    add_ln,
    common,
    fused_dropout_add_ln,
    fused_mha,
    launch_counts,
    lookup_score,
    mha,
    poly_attention,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _mha_inputs(rng, N=3, L=32, H=2, Dh=32):
    qkv = (rng.normal(size=(N, L, 3 * H * Dh)) * 0.5).astype(np.float32)
    mask = np.ones((N, L), np.int32)
    mask[1, 20:] = 0  # padded keys
    mask[2, :] = 0  # a fully masked row: the mean of V, never NaN
    return qkv, mask, H


def test_cpu_tensors_never_count_as_kernel_launches(rng):
    before = launch_counts()
    qkv, mask, H = _mha_inputs(rng)
    fused_mha(torch.from_numpy(qkv), torch.from_numpy(mask), H)
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    fused_dropout_add_ln(x, x, torch.ones(16), torch.zeros(16))
    assert launch_counts() == before


@pytest.mark.parametrize("op", ["mha", "add_ln"])
def test_dropout_is_refused_until_the_training_slice(rng, op):
    with pytest.raises(NotImplementedError, match="training slice"):
        if op == "mha":
            qkv, mask, H = _mha_inputs(rng)
            fused_mha(torch.from_numpy(qkv), torch.from_numpy(mask), H,
                      dropout_rate=0.1)
        else:
            x = torch.zeros(8, 16)
            fused_dropout_add_ln(x, x, torch.ones(16), torch.zeros(16), rate=0.1)


@pytest.mark.parametrize("bad, match", [
    (torch.zeros(4, 8, dtype=torch.float16), "dtype"),
    (torch.zeros(4, 9), "shape"),
    (torch.zeros(8, 4).t(), "contiguous"),
])
def test_check_tensor_refuses_what_kernels_do_not_take(bad, match):
    with pytest.raises((TypeError, ValueError), match=match):
        common.check_tensor("x", bad, torch.device("cpu"),
                            (torch.float32, torch.bfloat16), (4, 8))


def test_library_name_follows_the_source():
    a = common.library_path("mha_fwd")
    assert a.parent == common.BUILD_DIR and a.name.startswith("libmha_fwd.")
    assert a == common.library_path("mha_fwd")
    assert a != common.library_path("lookup_score_fwd")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mha", "mha_seqs4", "add_ln", "poly", "lookup"])
def test_kernel_matches_plain_on_card(rng, op, dtype):
    dev = _card()
    put = lambda a: torch.as_tensor(a).to(dev)
    cast = lambda a: put(a).to(dtype)
    before = launch_counts()
    if op.startswith("mha"):
        seqs = 4 if op == "mha_seqs4" else 1
        qkv, mask, H = _mha_inputs(rng, N=4, L=40, H=2, Dh=64)
        args = (cast(qkv), put(mask), H)
        got = mha.fused_mha(*args, seqs=seqs)
        want = mha.mha_reference(*args, seqs=seqs)
        name = "mha_fwd"
    elif op == "add_ln":
        x, h = cast(rng.normal(size=(37, 96))), cast(rng.normal(size=(37, 96)))
        g, b = torch.ones(96, device=dev), torch.zeros(96, device=dev)
        got = add_ln.fused_dropout_add_ln(x, h, g, b, 0.0, 1e-5)
        want = add_ln.add_ln_reference(x, h, g, b, 1e-5)
        name = "add_ln_fwd"
    elif op == "poly":
        args = (cast(rng.normal(size=(3, 10, 32))),
                cast(rng.normal(size=(32, 24)) * 0.1),
                cast(rng.normal(size=(6, 24)) * 0.1),
                put((rng.random((3, 10)) > 0.3).astype(np.int32)),
                put(rng.normal(size=(3, 10)).astype(np.float32)))
        got = poly_attention.poly_attention_fused(*args)
        want = poly_attention.poly_attention_reference(*args)
        name = "poly_attention_fwd"
    else:
        args = (cast(rng.normal(size=(50, 64))),
                put(rng.integers(0, 50, size=(3, 70)).astype(np.int32)),
                cast(rng.normal(size=(3, 5, 64))))
        got = lookup_score.lookup_score_fused(*args)
        want = lookup_score.lookup_score_reference(*args)
        name = "lookup_score_fwd"
    torch.cuda.synchronize()
    assert launch_counts()[name] == before[name] + 1
    scale = max(1.0, want.float().abs().max().item())
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    dev = _card()
    qkv = torch.zeros(2, 8, 3 * 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):  # 48 / 2 heads = 24
        mha.fused_mha(qkv, torch.ones(2, 8, dtype=torch.int32, device=dev), 2)
    with pytest.raises(TypeError, match="dtype"):
        mha.fused_mha(qkv, torch.ones(2, 8, dtype=torch.int64, device=dev), 3)
