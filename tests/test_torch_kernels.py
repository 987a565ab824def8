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
import ctypes

import numpy as np
import pytest
import torch

from miner_tpu_torch.ops import (
    add_ln,
    common,
    fastformer_attn,
    fused_dropout_add_ln,
    fused_mha,
    launch_counts,
    lookup_score,
    mha,
    philox,
    poly_attention,
)
from miner_tpu_torch.parallel.news_cache import Int8Rows, quantize_rows


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


def test_philox_known_answers():
    """Philox4x32-10 against the published known-answer vectors
    (Random123's kat_vectors)."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        words = philox.philox4x32(*(torch.tensor([c]) for c in ctr),
                                  key[0] | key[1] << 32)
        assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("site", ["mha", "add_ln"])
def test_dropout_keep_rate_is_one_minus_rate(site):
    """10**6 draws: the keep rate lies within 4 sigma of 1 - rate."""
    rate, n = 0.1, 10 ** 6
    if site == "mha":
        bits = philox.mha_bits(7, 61, 4, 64, "cpu")  # 999,424 draws
    else:
        bits = philox.add_ln_bits(7, 1000, 1000, "cpu")
    keep = philox.keep_mask(bits, rate).double()
    sigma = (rate * (1 - rate) / keep.numel()) ** 0.5
    assert abs(keep.mean().item() - (1 - rate)) < 4 * sigma
    assert keep.numel() >= 0.99 * n


def test_mha_dropout_layout_gives_one_call_per_lane_block():
    """One Philox call covers {i, i+8} x {j, j+8} of a 16 x 16 block (the
    four values one tensor-core lane holds), words in the order (i, j),
    (i, j+8), (i+8, j), (i+8, j+8); and no two elements share a word."""
    seed, N, H, L = 2 ** 35 + 3, 2, 3, 48
    bits = philox.mha_bits(seed, N, H, L, "cpu")
    for n, h, i, j in [(0, 0, 0, 0), (1, 2, 21, 5), (0, 1, 34, 39), (1, 0, 7, 32)]:
        i0, j0 = i - (i & 8), j - (j & 8)
        words = philox.philox4x32(
            *(torch.tensor([c]) for c in ((j0 >> 4) * 8 + j0 % 8,
                                          (i0 >> 4) * 8 + i0 % 8, h, n)), seed)
        got = [bits[n, h, i0, j0], bits[n, h, i0, j0 + 8], bits[n, h, i0 + 8, j0],
               bits[n, h, i0 + 8, j0 + 8]]
        assert [int(w) for w in got] == [int(w) for w in words]
    x = torch.arange(L)
    c, b = (x >> 4) * 8 + x % 8, (x >> 3) & 1  # x without bit 3, bit 3
    use = (c[None, :] * 64 + c[:, None]) * 4 + b[:, None] * 2 + b[None, :]
    assert torch.unique(use).numel() == L * L  # (counter, word) of (i, j)


def test_add_ln_dropout_layout_gives_one_call_per_four_columns():
    """Columns 4q .. 4q + 3 of a row are the four words of one Philox call
    (counter (q, row, 0, 0)): the backward kernel's 8-column bf16 vector
    takes two calls and uses every word."""
    seed, T, D = 2 ** 36 + 5, 7, 40
    bits = philox.add_ln_bits(seed, T, D, "cpu")
    for r, q in [(0, 0), (3, 5), (6, 9)]:
        words = philox.philox4x32(*(torch.tensor([c]) for c in (q, r, 0, 0)), seed)
        assert [int(b) for b in bits[r, 4 * q:4 * q + 4]] == [int(w) for w in words]


@pytest.mark.parametrize("site", ["mha", "add_ln"])
def test_dropout_mask_is_a_function_of_the_seed(site):
    draw = ((lambda s: philox.mha_bits(s, 3, 2, 16, "cpu")) if site == "mha"
            else (lambda s: philox.add_ln_bits(s, 40, 24, "cpu")))
    assert torch.equal(draw(11), draw(11))
    assert not torch.equal(philox.keep_mask(draw(11), 0.5),
                           philox.keep_mask(draw(2 ** 40 + 11), 0.5))


@pytest.mark.parametrize("op", ["mha", "add_ln"])
def test_plain_backward_with_dropout_is_autograd_of_plain_forward(rng, op):
    """At rate 0.2 the backward formulas equal autograd of the plain
    forward under the same seed's mask (float32 rounding, 1e-6). The
    attention rows here all hold a key: for a fully masked row the formulas
    give Q and K a gradient from the uniform P, as the TPU kernel does,
    where the forward does not depend on them."""
    if op == "mha":
        qkv, mask, H = _mha_inputs(rng)
        mask[2, :3] = 1
        dout = rng.normal(size=(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))
        dout = torch.from_numpy(dout.astype(np.float32))
        t = torch.from_numpy(qkv).requires_grad_()
        mha.mha_reference(t, torch.from_numpy(mask), H, 1, 0.2, 99).backward(dout)
        got = [mha.mha_backward_reference(torch.from_numpy(qkv),
                                          torch.from_numpy(mask), dout, H, 1,
                                          0.2, 99)]
        want = [t.grad]
    else:
        x, h, dy = (torch.from_numpy(rng.normal(size=(13, 40)).astype(np.float32))
                    for _ in range(3))
        g = torch.from_numpy((1 + 0.1 * rng.normal(size=40)).astype(np.float32))
        leaves = [a.clone().requires_grad_() for a in (x, h, g, torch.zeros(40))]
        add_ln.add_ln_reference(*leaves, 1e-5, 0.2, 99).backward(dy)
        got = add_ln.add_ln_backward_reference(x, h, g, dy, 1e-5, 0.2, 99)
        want = [leaf.grad for leaf in leaves]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad, match", [
    (torch.zeros(4, 8, dtype=torch.float16), "dtype"),
    (torch.zeros(4, 9), "shape"),
    (torch.zeros(8, 4).t(), "contiguous"),
])
def test_check_tensor_refuses_what_kernels_do_not_take(bad, match):
    with pytest.raises((TypeError, ValueError), match=match):
        common.check_tensor("x", bad, torch.device("cpu"),
                            (torch.float32, torch.bfloat16), (4, 8))


def test_check_aligned_refuses_a_view_off_a_16_byte_boundary():
    """The bf16 mha kernels copy rows in 16-byte pieces."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    common.check_aligned("x", base)
    with pytest.raises(ValueError, match="16-byte"):
        common.check_aligned("x", base[1:])


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


def _ff_inputs(rng, B, L, D, h):
    """Fastformer attention inputs with a padded row and a fully masked
    one."""
    q, k = (rng.normal(size=(B, L, D)) for _ in range(2))
    wqa, wka = (rng.normal(size=(D, h)) * 0.3 for _ in range(2))
    bqa, bka = (rng.normal(size=(h,)) * 0.1 for _ in range(2))
    mask = np.ones((B, L), np.int32)
    mask[0, L // 2:] = 0
    mask[-1, :] = 0
    return [q, k, wqa, bqa, wka, bka], mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, L, D, h", [(16, 50, 256, 16), (3, 5, 32, 16),
                                        (2, 256, 256, 16)])
def test_fastformer_kernel_matches_plain_on_card(rng, B, L, D, h, dtype):
    """The training shape, head dim 2 (the tiny CPU-test geometry) and the
    longest history the shared memory is sized for, with fully masked
    rows; fp32 weights are cast to q's type by the wrapper."""
    dev = _card()
    xs, mask = _ff_inputs(rng, B, L, D, h)
    q, k = (torch.as_tensor(x, device=dev).to(dtype) for x in xs[:2])
    weights = [torch.as_tensor(x, device=dev).float() for x in xs[2:]]
    mask = torch.as_tensor(mask, device=dev)
    before = launch_counts()
    got = fastformer_attn.fastformer_attention_fused(q, k, *weights, mask, h)
    want = fastformer_attn.fastformer_attention_reference(q, k, *weights, mask, h)
    torch.cuda.synchronize()
    assert launch_counts()["fastformer_attn_fwd"] == before["fastformer_attn_fwd"] + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    dev = _card()
    qkv = torch.zeros(2, 8, 3 * 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):  # 48 / 2 heads = 24
        mha.fused_mha(qkv, torch.ones(2, 8, dtype=torch.int32, device=dev), 2)
    with pytest.raises(TypeError, match="dtype"):
        mha.fused_mha(qkv, torch.ones(2, 8, dtype=torch.int64, device=dev), 3)
    ff = fastformer_attn.fastformer_attention_fused
    q = torch.zeros(2, 6, 32, device=dev)
    w, b = torch.zeros(32, 4, device=dev), torch.zeros(4, device=dev)
    mask = torch.ones(2, 6, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):  # float16 q
        ff(q.half(), q.half(), w, b, w, b, mask, 4)
    with pytest.raises(TypeError, match="dtype"):  # k of another type than q
        ff(q, q.bfloat16(), w, b, w, b, mask, 4)
    with pytest.raises(TypeError, match="dtype"):
        ff(q, q, w, b, w, b, mask.long(), 4)
    with pytest.raises(ValueError, match="shape"):
        ff(q, q, w[:16], b, w, b, mask, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ff(q, q.transpose(0, 1).contiguous().transpose(0, 1), w, b, w, b, mask, 4)
    with pytest.raises(ValueError, match="shared memory"):
        long = torch.zeros(1, 16384, 32, device=dev)  # (L, h) scores: 256 KB
        ff(long, long, w, b, w, b, torch.ones(1, 16384, dtype=torch.int32, device=dev), 4)


def _tol(dtype, want):
    scale = max(1.0, want.float().abs().max().item())
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale


def _assert_mha_grad_close(got, want, H, dtype):
    """dqkv's dq, dk and dv, each element within the tolerance of the
    largest |dq|, |dk| or |dv| of its (sequence, head), as chip_smoke.py
    holds them: a short sequence's dv outgrows a long one's gradient, so one
    scale for the batch would hide a wrong dq or dk."""
    N, L, D3 = want.shape
    shape = (N, L, 3, H, D3 // 3 // H)
    err = (got.float() - want.float()).abs().view(shape).amax(dim=(1, 4))  # (N, 3, H)
    scale = want.float().abs().view(shape).amax(dim=(1, 2, 4))  # (N, H)
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale[:, None]
    assert (err <= tol).all(), f"err / tol, [sequence, part, head]: {err / tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mha", "mha_seqs4", "mha_2_key_tiles", "add_ln"])
def test_backward_kernel_matches_plain_on_card(rng, op, dtype, rate):
    """The backward kernels against the plain backward formulas (mha: one
    key tile at L=40; at L=160 both types sum dQ over two key tiles, bf16
    in an fp32 scratch row, fp32 in its own output)."""
    dev = _card()
    before = launch_counts()
    if op.startswith("mha"):
        seqs = 4 if op == "mha_seqs4" else 1
        L = 160 if op == "mha_2_key_tiles" else 40
        qkv, mask, H = _mha_inputs(rng, N=4, L=L, H=2, Dh=64)
        qkv = torch.as_tensor(qkv, device=dev).to(dtype)
        mask = torch.as_tensor(mask, device=dev)
        dout = torch.as_tensor(rng.normal(size=(4, L, 128)), device=dev).to(dtype)
        out, stats = mha._launch_fwd(qkv, mask, H, seqs, rate, 5, True)
        got = [mha.mha_backward(qkv, mask, dout, H, rate, 5, seqs, out, stats)]
        want = [mha.mha_backward_reference(qkv, mask, dout, H, seqs, rate, 5)]
        name = "mha_bwd"
    else:
        x, h, dy = (torch.as_tensor(rng.normal(size=(37, 96)), device=dev).to(dtype)
                    for _ in range(3))
        g = torch.as_tensor(1 + 0.1 * rng.normal(size=96), device=dev).float()
        got = add_ln.add_ln_backward(x, h, g, dy, 1e-5, rate, 5)
        want = add_ln.add_ln_backward_reference(x, h, g, dy, 1e-5, rate, 5)
        name = "add_ln_bwd"
    torch.cuda.synchronize()
    assert launch_counts()[name] == before[name] + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        if name == "mha_bwd":
            _assert_mha_grad_close(a, b, H, dtype)
        else:
            assert (a.float() - b.float()).abs().max().item() <= _tol(dtype, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 32, 64])
@pytest.mark.parametrize("L", [32, 40, 128, 160, 300])
def test_mha_tiling_matches_plain_on_card(rng, L, Dh, dtype, rate):
    """Forward and backward against the plain versions over the kernels'
    tilings: one key tile of several heads per block (32, 40: a ragged
    tile), the sapo shape (128), several key tiles and query passes (160,
    300); each with a padded row, a fully masked row (the mean of V) and
    the block-diagonal band (seqs = 4) on a second call."""
    dev = _card()
    H = 3
    qkv, mask, _ = _mha_inputs(rng, N=3, L=L, H=H, Dh=Dh)
    mask[1, L // 2:] = 0
    qkv = torch.as_tensor(qkv, device=dev).to(dtype)
    mask = torch.as_tensor(mask, device=dev)
    dout = torch.as_tensor(rng.normal(size=(3, L, H * Dh)), device=dev).to(dtype)
    for seqs in (1, 4):
        out, stats = mha._launch_fwd(qkv, mask, H, seqs, rate, 9, True)
        want = mha.mha_reference(qkv, mask, H, seqs, rate, 9)
        assert out.dtype == dtype and torch.isfinite(out).all()
        assert (out.float() - want.float()).abs().max().item() <= _tol(dtype, want)
        got = mha.mha_backward(qkv, mask, dout, H, rate, 9, seqs, out, stats)
        want = mha.mha_backward_reference(qkv, mask, dout, H, seqs, rate, 9)
        assert got.dtype == dtype and torch.isfinite(got).all()
        _assert_mha_grad_close(got, want, H, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_alignment_rule_on_card(rng, dtype):
    """A qkv view 4 bytes off a 16-byte boundary: the fp32 kernels (4-byte
    loads) take it, the bf16 ones (16-byte copies) refuse it."""
    dev = _card()
    qkv, mask, H = _mha_inputs(rng, N=3, L=24, H=2, Dh=16)
    flat = torch.as_tensor(qkv, device=dev).to(dtype).flatten()
    view = torch.cat([flat[:4 // flat.element_size()], flat]).narrow(
        0, 4 // flat.element_size(), flat.numel()).view(qkv.shape)
    mask = torch.as_tensor(mask, device=dev)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="16-byte"):
            mha.fused_mha(view, mask, H)
        return
    got = mha.fused_mha(view, mask, H)
    want = mha.mha_reference(view, mask, H)
    assert (got - want).abs().max().item() <= _tol(dtype, want)


def _mha_dropped(qkv, mask, H, rate, seed):
    """(N, H, L, L) bool: where the forward kernel's output weights are 0.
    V is set to one-hot rows, one launch per block of Dh keys, so each
    output row is a row of dropped probabilities."""
    N, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    zero = torch.empty((N, H, L, L), dtype=torch.bool, device=qkv.device)
    for k0 in range(0, L, Dh):
        nb = min(Dh, L - k0)
        probe = qkv.clone().view(N, L, 3, H, Dh)
        probe[:, :, 2] = 0
        j = torch.arange(nb, device=qkv.device)
        probe[:, k0 + j, 2, :, j] = 1
        out = mha.fused_mha(probe.view(N, L, -1), mask, H, rate, 1, seed)
        zero[..., k0:k0 + nb] = (out.view(N, L, H, Dh)[..., :nb] == 0).permute(0, 2, 1, 3)
    return zero


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mha", "mha_3_key_tiles", "add_ln"])
def test_dropout_mask_matches_plain_on_card(rng, op, dtype):
    """The kernels' dropout zeros lie exactly where the plain version's
    Philox mask drops: for mha V is one-hot, so each output row is the row
    of dropped probabilities (L = 32: one key tile; L = 160: three key
    tiles and two query passes of the forward); for add_ln dh is zero where
    h was dropped."""
    dev = _card()
    rate, seed = 0.3, 2 ** 33 + 17
    if op.startswith("mha"):
        N, H = 3, 2
        L, Dh = (160, 64) if op == "mha_3_key_tiles" else (32, 32)
        qkv = torch.as_tensor(rng.normal(size=(N, L, 3 * H * Dh)) * 0.5,
                              device=dev).to(dtype)
        mask = torch.ones((N, L), dtype=torch.int32, device=dev)
        keep = philox.keep_mask(philox.mha_bits(seed, N, H, L, dev), rate)
        assert torch.equal(_mha_dropped(qkv, mask, H, rate, seed), ~keep)
        got = mha.fused_mha(qkv, mask, H, rate, 1, seed)
        want = mha.mha_reference(qkv, mask, H, 1, rate, seed)
    else:
        x, h, dy = (torch.as_tensor(rng.normal(size=(37, 96)), device=dev).to(dtype)
                    for _ in range(3))
        g, b = torch.ones(96, device=dev), torch.zeros(96, device=dev)
        keep = philox.keep_mask(philox.add_ln_bits(seed, 37, 96, dev), rate)
        _, dh, _, _ = add_ln.add_ln_backward(x, h, g, dy, 1e-5, rate, seed)
        assert torch.equal(dh != 0, keep)
        got = add_ln.fused_dropout_add_ln(x, h, g, b, rate, 1e-5, seed)
        want = add_ln.add_ln_reference(x, h, g, b, 1e-5, rate, seed)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [16, 32, 64])
@pytest.mark.parametrize("L", [23, 159, 300])
def test_fp32_mha_at_lengths_off_the_tiles_on_card(rng, L, Dh):
    """The split-TF32 fp32 kernels, forward and backward with dropout 0.1,
    at lengths off the 16-row tiles: UnBERT's 23 sentences (one key tile,
    several heads a block), UniSRec's 159 (a 31-row query tile, a 31-key
    tile) and UnBERT's 300 (three query passes, three key tiles of the
    backward); a padded and a fully masked row, the block-diagonal band
    where L divides (300: 4, 159: 3); the dropout mask bit for bit."""
    dev = _card()
    H, rate, seed = 3, 0.1, 2 ** 35 + L
    qkv, mask, _ = _mha_inputs(rng, N=3, L=L, H=H, Dh=Dh)
    mask[1, L // 2:] = 0
    qkv = torch.as_tensor(qkv, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    dout = torch.as_tensor(rng.normal(size=(3, L, H * Dh)).astype(np.float32), device=dev)
    before = launch_counts()
    bands = [1] + [s for s in (4, 3) if L % s == 0][:1]
    for seqs in bands:
        out, stats = mha._launch_fwd(qkv, mask, H, seqs, rate, seed, True)
        want = mha.mha_reference(qkv, mask, H, seqs, rate, seed)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        assert (out - want).abs().max().item() <= _tol(torch.float32, want)
        got = mha.mha_backward(qkv, mask, dout, H, rate, seed, seqs, out, stats)
        want = mha.mha_backward_reference(qkv, mask, dout, H, seqs, rate, seed)
        assert torch.isfinite(got).all()
        _assert_mha_grad_close(got, want, H, torch.float32)
    torch.cuda.synchronize()
    assert launch_counts()["mha_bwd"] == before["mha_bwd"] + len(bands)
    # zero weights: dropped, or masked in a row that has a valid key (a
    # fully masked row is uniform over its keys)
    keep = philox.keep_mask(philox.mha_bits(seed, 3, H, L, dev), rate)
    valid = mask.bool()
    masked = ~valid & valid.any(-1, keepdim=True)
    assert torch.equal(_mha_dropped(qkv, mask, H, rate, seed),
                       ~keep | masked[:, None, None, :])


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mha", "add_ln", "poly", "poly_legacy", "ff"])
def test_gradients_through_functions_match_plain_on_card(rng, op):
    """A loss through each op's autograd Function on the card has the
    gradients of the same loss through the plain version (float32, 1e-4 of
    the gradients' scale): no gradient is cut. Poly-attention also under
    the legacy 1e-30 fill, which its backward recomputes with."""
    dev = _card()
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    if op == "mha":
        qkv, mask, H = _mha_inputs(rng, N=3, L=40, H=2, Dh=32)
        mask[2, :4] = 1
        inputs, mask = [put(qkv)], put(mask).to(torch.int32)
        kernel = lambda q: mha.fused_mha(q, mask, H, 0.1, 1, 3)
        plain = lambda q: mha.mha_reference(q, mask, H, 1, 0.1, 3)
    elif op == "add_ln":
        inputs = [put(rng.normal(size=(37, 96))), put(rng.normal(size=(37, 96))),
                  put(1 + 0.1 * rng.normal(size=96)), put(0.1 * rng.normal(size=96))]
        kernel = lambda *a: add_ln.fused_dropout_add_ln(*a, 0.1, 1e-5, 3)
        plain = lambda *a: add_ln.add_ln_reference(*a, 1e-5, 0.1, 3)
    elif op.startswith("poly"):
        mask = put(rng.random((3, 10)) > 0.3).to(torch.int32)
        fill = poly_attention.LEGACY_FILL if op == "poly_legacy" else poly_attention.NEG_INF
        inputs = [put(rng.normal(size=(3, 10, 32))), put(rng.normal(size=(32, 24)) * 0.1),
                  put(rng.normal(size=(6, 24)) * 0.1), put(rng.normal(size=(3, 10)))]
        kernel = lambda e, w, c, b: poly_attention.poly_attention_fused(e, w, c, mask, b, fill)
        plain = lambda e, w, c, b: poly_attention.poly_attention_reference(e, w, c, mask, b,
                                                                           fill)
    else:  # Fastformer attention: q, k and the four attention weights
        xs, mask = _ff_inputs(rng, 3, 12, 64, 16)
        inputs, mask = [put(x) for x in xs], put(mask).to(torch.int32)
        kernel = lambda *a: fastformer_attn.fastformer_attention_fused(*a, mask, 16)
        plain = lambda *a: fastformer_attn.fastformer_attention_reference(*a, mask, 16)
    weight = None
    grads = []
    for fn in (kernel, plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        assert out.grad_fn is not None
        if weight is None:
            weight = torch.randn(out.shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(0))
        (out * weight).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= _tol(torch.float32, want)


@pytest.mark.gpu
def test_lookup_score_refuses_gradients_on_card():
    dev = _card()
    cache = torch.randn(10, 16, device=dev, requires_grad=True)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        lookup_score.lookup_score_fused(cache, idx, torch.randn(2, 4, 16, device=dev))
    with torch.no_grad():
        assert lookup_score.lookup_score_fused(
            cache, idx, torch.randn(2, 4, 16, device=dev)).shape == (2, 3, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [96, 768])
def test_add_ln_backward_kernel_widths_on_card(rng, D, dtype, rate):
    """The CUDA backward at the model's width (768: three 16-byte vectors a
    lane in bf16, six in fp32) and a narrow one (96: most lanes idle), over
    1,001 rows (not a multiple of the 4 rows a block takes at a time, nor of
    its persistent grid): dx, dh, dgamma, dbeta against the plain backward,
    and dh's zeros exactly where the plain Philox mask drops."""
    dev = _card()
    T, seed = 1001, 2 ** 34 + D
    x, h, dy = (torch.as_tensor(rng.normal(size=(T, D)), device=dev).to(dtype)
                for _ in range(3))
    g = torch.as_tensor(1 + 0.1 * rng.normal(size=D), device=dev).float()
    before = launch_counts()["add_ln_bwd"]
    got = add_ln.add_ln_backward(x, h, g, dy, 1e-5, rate, seed)
    want = add_ln.add_ln_backward_reference(x, h, g, dy, 1e-5, rate, seed)
    torch.cuda.synchronize()
    assert launch_counts()["add_ln_bwd"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= _tol(dtype, b)
    if rate:
        keep = philox.keep_mask(philox.add_ln_bits(seed, T, D, dev), rate)
        assert torch.equal(got[1] != 0, keep)
    else:
        assert (got[1] != 0).all()


@pytest.mark.gpu
def test_add_ln_backward_parameter_sums_at_the_train_shape_on_card(rng):
    """dgamma and dbeta over the sapo training shape (T = 112,640 rows of
    768, bf16, dropout 0.1) against the same sums in float64. The kernel
    sums in fp32 in another order (each lane over its rows, then the
    block's warps, then the blocks): its error is a few fp32 roundings of
    the partial sums, far under 1e-6 of the sum of the terms' magnitudes;
    one row left out would move a column by ~1/T = 9e-6 of it."""
    dev = _card()
    T, D, rate, seed = 880 * 128, 768, 0.1, 2 ** 43 + 128
    gen = torch.Generator(device=dev).manual_seed(5)
    x, h, dy = (torch.randn(T, D, device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(3))
    g = 1 + 0.1 * torch.randn(D, device=dev, generator=gen)
    _, _, dgamma, dbeta = add_ln.add_ln_backward(x, h, g, dy, 1e-5, rate, seed)
    keep = philox.keep_mask(philox.add_ln_bits(seed, T, D, dev), rate)
    s = x.double() + torch.where(keep, h.double() / (1 - rate), 0.0)
    del keep
    s = s - s.mean(dim=-1, keepdim=True)
    xhat = s * torch.rsqrt(s.square().mean(dim=-1, keepdim=True) + 1e-5)
    del s
    terms = dy.double() * xhat
    for got, want, mag in ((dgamma, terms.sum(0), terms.abs().sum(0)),
                           (dbeta, dy.double().sum(0), dy.double().abs().sum(0))):
        err = (got.double() - want).abs()
        assert (err <= 1e-6 * mag).all(), f"worst err / magnitude {(err / mag).max()}"


@pytest.mark.gpu
def test_add_ln_backward_refuses_what_it_does_not_take():
    """D a multiple of 8 (bf16) or 4 (fp32) up to 1024; no fallback."""
    dev = _card()
    g = lambda D: torch.ones(D, device=dev)
    for dtype, D in ((torch.bfloat16, 100), (torch.float32, 98), (torch.bfloat16, 1032)):
        x = torch.zeros(5, D, device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="multiple of"):
            add_ln.add_ln_backward(x, x, g(D), x, 1e-5)
    x = torch.zeros(5 * 96 + 4, device=dev, dtype=torch.bfloat16)[4:].view(5, 96)
    with pytest.raises(ValueError, match="16-byte"):
        add_ln.add_ln_backward(x, x, g(96), x, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_poly_attention_main_shape_on_card(rng, dtype):
    """H = 50, D = 256, P = 200, K = 32 (H pads to 64 mma rows, P to 208
    columns in bf16), with a user of no clicks and one of a single click:
    against the plain version, and the no-click row is the mean of the 50
    real history rows (the finite -1e9 fill), never NaN and never a mean
    over the padding."""
    dev = _card()
    B, H, D, P, K = 6, 50, 256, 200, 32
    emb = torch.as_tensor(rng.normal(size=(B, H, D)), device=dev).to(dtype)
    w = torch.as_tensor(rng.normal(size=(D, P)) / 16, device=dev).to(dtype)
    codes = torch.as_tensor(rng.normal(size=(K, P)) / 4, device=dev).to(dtype)
    lengths = torch.tensor([50, 0, 1, 37, 12, 50], device=dev)
    mask = (torch.arange(H, device=dev)[None] < lengths[:, None]).to(torch.int32)
    bias = torch.as_tensor(rng.normal(size=(B, H)), device=dev).float()
    before = launch_counts()["poly_attention_fwd"]
    got = poly_attention.poly_attention_fused(emb, w, codes, mask, bias)
    want = poly_attention.poly_attention_reference(emb, w, codes, mask, bias)
    torch.cuda.synchronize()
    assert launch_counts()["poly_attention_fwd"] == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    mean = emb[1].float().mean(dim=0).expand(K, D)
    assert (got[1].float() - mean).abs().max().item() <= _tol(dtype, mean)
    assert (got[2].float() - emb[2, 0].float()).abs().max().item() <= _tol(dtype, emb[2, 0])


@pytest.mark.gpu
def test_poly_attention_refuses_bf16_shapes_off_the_tiles():
    """The bf16 kernel takes D a multiple of 16 and P of 8; fp32 any."""
    dev = _card()
    for D, P in ((40, 24), (32, 20)):
        emb = torch.zeros(2, 5, D, device=dev, dtype=torch.bfloat16)
        w = torch.zeros(D, P, device=dev, dtype=torch.bfloat16)
        codes = torch.zeros(3, P, device=dev, dtype=torch.bfloat16)
        mask = torch.ones(2, 5, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="multiple of"):
            poly_attention.poly_attention_fused(emb, w, codes, mask)
        out = poly_attention.poly_attention_fused(emb.float(), w.float(), codes.float(), mask)
        assert out.shape == (2, 3, D) and torch.isfinite(out).all()


def _poly_fp32_inputs(rng, dev, B, H, D, P, K, put=None):
    """fp32 poly-attention inputs scaled as chip_smoke.py makes them; row 1
    (when there is one) has no click, the rest a random length."""
    put = put or (lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev))
    lengths = rng.integers(1, H + 1, size=B)
    lengths[1:2] = 0
    mask = torch.as_tensor((np.arange(H)[None] < lengths[:, None]).astype(np.int32),
                           device=dev)
    return (put(rng.normal(size=(B, H, D))), put(rng.normal(size=(D, P)) / 16),
            put(rng.normal(size=(K, P)) / 4), mask,
            torch.as_tensor(rng.normal(size=(B, H)), device=dev).float())


def _c_smem_bytes(H, D, P, K, dtype):
    """The bytes a CTA takes in the layout the kernel's launch chooses."""
    return common.kernel_function("poly_attention_fwd", "poly_attention_smem_bytes",
                                  (ctypes.c_int,) * 5, ctypes.c_longlong)(
                                      H, D, P, K, common.DTYPE_CODES[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("D, P, K", [(256, 200, 32), (252, 196, 3), (250, 198, 32),
                                     (768, 200, 32), (766, 198, 3)])
@pytest.mark.parametrize("H", [1, 50, 64])
@pytest.mark.parametrize("B", [1, 16, 32, 64, 133])
def test_poly_attention_fp32_cluster_matches_plain_on_card(rng, B, H, D, P, K):
    """The fp32 route (split TF32) at the batches the paths give it and
    past one wave of the card (133 rows), one history row to the padding's
    64, at the main shape (3 CTAs a row), at D and P multiples of 4 off the
    8-column pieces (16-byte copies, the last piece zero-filled) and off 4
    (4-byte copies), with 3 codes (K padded to 16), and at the PLM's D =
    768 (a Miner without --apply_reduce_dim: 8 CTAs a row, D split across
    them from H = 50); a no-click row is the mean of its H rows."""
    dev = _card()
    args = _poly_fp32_inputs(rng, dev, B, H, D, P, K)
    nc, split, smem = poly_attention.plan(H, D, P, K, torch.float32)
    assert (nc, split) == ((8, H > 1) if D > 512 else (3, False))
    assert smem == _c_smem_bytes(H, D, P, K, torch.float32)
    before = launch_counts()["poly_attention_fwd"]
    got = poly_attention.poly_attention_fused(*args)
    want = poly_attention.poly_attention_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["poly_attention_fwd"] == before + 1
    assert got.shape == (B, K, D) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= _tol(torch.float32, want)
    if B > 1:
        mean = args[0][1].mean(dim=0).expand(K, D)
        assert (got[1] - mean).abs().max().item() <= _tol(torch.float32, mean)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [256, 768])
def test_poly_attention_fp32_views_off_16_bytes_on_card(rng, D):
    """emb, W and the codes as views 4 bytes past a 16-byte boundary at the
    main shape and at D = 768 (D split): the launch takes 4-byte copies,
    and the result is the aligned tensors' bit for bit."""
    dev = _card()

    def off(a):
        a = np.asarray(a, np.float32)
        base = torch.empty(a.size + 1, device=dev)
        view = base[1:].view(a.shape)
        view.copy_(torch.as_tensor(a))
        assert view.data_ptr() % 16 == 4
        return view

    args = _poly_fp32_inputs(rng, dev, 8, 50, D, 200, 32, off)
    got = poly_attention.poly_attention_fused(*args)
    aligned = poly_attention.poly_attention_fused(*(a.clone() for a in args))
    want = poly_attention.poly_attention_reference(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= _tol(torch.float32, want)
    assert torch.equal(got, aligned)


@pytest.mark.gpu
def test_poly_attention_fp32_plan_on_card(rng):
    """The plan is the launch's own layout, from the shapes alone: the main
    shape takes 3 CTAs a row (200,960 bytes a CTA); H = 64, D = 256, P =
    256, K = 64 and D = 512, P = 400 take 8, where a third of W's columns
    does not fit beside emb whole (a row of 8 against its plain version);
    D = 768 at the main H, P, K takes 8 with D split (199,424 bytes); at H
    = 64, D = 768, P = 256, K = 64 none fits and the launch raises (no
    fallback)."""
    dev = _card()
    f32 = torch.float32
    for shape, want in (((50, 256, 200, 32), (3, False, 200_960)),
                        ((64, 256, 256, 64), (8, False, 177_920)),
                        ((16, 512, 400, 8), (8, False, 167_360)),
                        ((50, 768, 200, 32), (8, True, 199_424))):
        assert poly_attention.plan(*shape, f32) == want
        assert _c_smem_bytes(*shape, f32) == want[2]
    args = _poly_fp32_inputs(rng, dev, 3, 16, 512, 400, 8)
    before = launch_counts()["poly_attention_fwd"]
    got = poly_attention.poly_attention_fused(*args)
    want = poly_attention.poly_attention_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["poly_attention_fwd"] == before + 1
    assert (got - want).abs().max().item() <= _tol(torch.float32, want)
    big = _poly_fp32_inputs(rng, dev, 2, 64, 768, 256, 64)
    with pytest.raises(ValueError, match="shared memory"):
        poly_attention.poly_attention_fused(*big)


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["mask", "legacy"])
@pytest.mark.parametrize("B", [1, 16, 32, 64])
def test_poly_attention_bf16_dsplit_matches_plain_on_card(rng, B, fill):
    """bf16 at the PLM's D = 768 (a Miner without --apply_reduce_dim: 8
    CTAs a row, D split, the partial proj summed over the cluster in rank
    order before tanh) at the batches the paths give it, under the -1e9
    and the legacy 1e-30 fill: against the plain version; a no-click row
    is the mean of its 50 rows; and each row's result is the same bit for
    bit whatever batch it is launched in."""
    dev = _card()
    H, D, P, K = 50, 768, 200, 32
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).to(torch.bfloat16)
    emb, w, codes, mask, bias = _poly_fp32_inputs(rng, dev, B, H, D, P, K, put)
    args = (emb, w, codes, mask, bias) + ((poly_attention.LEGACY_FILL,) if fill == "legacy"
                                          else ())
    assert poly_attention.plan(H, D, P, K, torch.bfloat16) == (8, True, 139_008)
    assert _c_smem_bytes(H, D, P, K, torch.bfloat16) == 139_008
    before = launch_counts()["poly_attention_fwd"]
    got = poly_attention.poly_attention_fused(*args)
    want = poly_attention.poly_attention_reference(*args)
    alone = [poly_attention.poly_attention_fused(emb[r:r + 1], w, codes, mask[r:r + 1],
                                                 bias[r:r + 1], *args[5:])
             for r in range(min(B, 3))]
    torch.cuda.synchronize()
    assert launch_counts()["poly_attention_fwd"] == before + 1 + len(alone)
    assert got.shape == (B, K, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(torch.bfloat16, want)
    for r, row in enumerate(alone):
        assert torch.equal(got[r:r + 1], row)
    if B > 1:
        mean = emb[1].float().mean(dim=0).expand(K, D)
        assert (got[1].float() - mean).abs().max().item() <= _tol(torch.bfloat16, mean)


@pytest.mark.gpu
def test_poly_attention_bf16_plan_on_card(rng):
    """The bf16 plan is the launch's own layout, from the shapes alone: 4
    CTAs a row at the main shape (105,728 bytes a CTA) and at D = 768 with
    3 codes (232,192: it still fits); 8 with D split at D = 768, P = 200,
    K = 32 (139,008) and H = 64, P = 256, K = 64 (184,064; a launch against
    its plain version); none at P = 1024, where the launch raises (no
    fallback)."""
    dev = _card()
    bf16 = torch.bfloat16
    for shape, want in (((50, 256, 200, 32), (4, False, 105_728)),
                        ((50, 768, 200, 3), (4, False, 232_192)),
                        ((50, 768, 200, 32), (8, True, 139_008)),
                        ((64, 768, 256, 64), (8, True, 184_064))):
        assert poly_attention.plan(*shape, bf16) == want
        assert _c_smem_bytes(*shape, bf16) == want[2]
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).to(bf16)
    args = _poly_fp32_inputs(rng, dev, 3, 64, 768, 256, 64, put)
    got = poly_attention.poly_attention_fused(*args)
    want = poly_attention.poly_attention_reference(*args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _tol(bf16, want)
    big = _poly_fp32_inputs(rng, dev, 2, 64, 768, 1024, 64, put)
    with pytest.raises(ValueError, match="shared memory"):
        poly_attention.poly_attention_fused(*big)


def test_poly_plan_refuses_a_cta_that_does_not_fit(monkeypatch):
    """The plan takes the first layout whose CTA fits, in the kernel's own
    order (its sizes stand-ins here, asked for with emb's type code): fp32
    3 CTAs a row, else 8, else 8 with D split; bf16 4, else 8 with D
    split. Where none fits it raises: no fallback."""
    f32, bf16 = common.DTYPE_CODES[torch.float32], common.DTYPE_CODES[torch.bfloat16]
    asked = []
    sizes = {(f32, 3, False): 300, (f32, 8, False): 250, (f32, 8, True): 200,
             (bf16, 4, False): 260, (bf16, 8, True): 220}

    def layout_bytes(H, D, P, K, code, nc, split):
        asked.append((code, nc, split))
        return sizes[code, nc, split] * D

    monkeypatch.setattr(poly_attention, "_layout_bytes", layout_bytes)
    assert poly_attention.plan(50, 256, 200, 32, torch.float32) == (3, False, 76_800)
    assert poly_attention.plan(50, 900, 200, 32, torch.float32) == (8, False, 225_000)
    assert poly_attention.plan(50, 1000, 200, 32, torch.float32) == (8, True, 200_000)
    assert poly_attention.plan(50, 256, 200, 32, torch.bfloat16) == (4, False, 66_560)
    assert poly_attention.plan(50, 900, 200, 32, torch.bfloat16) == (8, True, 198_000)
    assert asked == [(f32, 3, False), (f32, 3, False), (f32, 8, False), (f32, 3, False),
                     (f32, 8, False), (f32, 8, True), (bf16, 4, False), (bf16, 4, False),
                     (bf16, 8, True)]
    with pytest.raises(ValueError, match="shared memory"):
        poly_attention.plan(50, 1200, 200, 32, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        poly_attention.plan(50, 1100, 200, 32, torch.bfloat16)


# ---------------------------------------------------------------- lookup+score
@pytest.mark.parametrize("cache_dt, int_dt, D, route", [
    (torch.bfloat16, torch.bfloat16, 256, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 40, "cuda_core"),  # D off the 16-column tiles
    (torch.float32, torch.float32, 256, "cuda_core"),  # TF32 would fail fp32's tolerance
    (torch.bfloat16, torch.float32, 256, "cuda_core"),
    (torch.float32, torch.bfloat16, 256, "cuda_core"),
    (torch.int8, torch.bfloat16, 256, "tensor_core"),  # int8 rows widened to bf16
    (torch.int8, torch.bfloat16, 48, "cuda_core"),  # the int8 tensor-core route takes 32 columns at a time
    (torch.int8, torch.float32, 256, "cuda_core"),
])
def test_lookup_plan_picks_the_route_by_types_and_width(monkeypatch, cache_dt, int_dt, D,
                                                        route):
    """The route follows the types and D; the size is the kernel's own (here
    a stand-in for the library), asked for with the inputs' type codes (int8
    rows with the kernel's own code, ``common.INT8_CODE``)."""
    asked = []
    monkeypatch.setattr(lookup_score, "_smem_bytes",
                        lambda *a: asked.append(a) or 50_000 + a[-1])
    got, tiles, smem = lookup_score.plan(32, 4096, 32, D, cache_dt, int_dt)
    assert got == route and smem == 50_000 + tiles
    codes = (lookup_score.CACHE_CODES[cache_dt], common.DTYPE_CODES[int_dt])
    assert {a[:4] for a in asked} == {(32, D, *codes)}


def test_lookup_plan_sizes_runs_to_a_wave_and_refuses_what_does_not_fit(monkeypatch):
    """A block's run of tiles is the shortest that makes the grid one wave
    of 132 SMs, within the tiles there are and at most MAX_RUN: two blocks
    an SM where a block takes ~90 KB (bf16 on the tensor cores at K = 32,
    D = 256), one where it takes ~150 KB (fp32 on the CUDA cores). A
    float16 input and a block larger than shared memory are refused."""
    for base, B, C, tiles in ((90_000, 32, 16, 1), (90_000, 64, 1, 1), (90_000, 1, 4096, 1),
                              (90_000, 32, 4096, 8), (150_000, 32, 4096, 16),
                              (90_000, 8, 262144, lookup_score.MAX_RUN)):
        monkeypatch.setattr(lookup_score, "_smem_bytes",
                            lambda K, D, c, i, n, base=base: base + 256 * n)
        assert lookup_score.plan(B, C, 32, 256, torch.bfloat16, torch.bfloat16)[1] == tiles
    with pytest.raises(TypeError, match="dtype"):
        lookup_score.plan(32, 16, 32, 256, torch.float16, torch.bfloat16)
    monkeypatch.setattr(lookup_score, "_smem_bytes", lambda *a: 228 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        lookup_score.plan(32, 16, 512, 256, torch.float32, torch.float32)


def _lookup_case(rng, dev, N, B, C, K, D, cache_dt, int_dt):
    """A cache of N rows (``cache_dt`` int8: an ``Int8Rows`` quantized from
    bf16 rows, as a serving cache is), (B, C) rows and (B, K, D) interests."""
    cache = torch.as_tensor(rng.normal(size=(N, D)), device=dev)
    if cache_dt == torch.int8:
        cache = quantize_rows(cache.to(torch.bfloat16))
    else:
        cache = cache.to(cache_dt)
    idx = torch.as_tensor(rng.integers(0, N, size=(B, C)).astype(np.int32), device=dev)
    interests = torch.as_tensor(rng.normal(size=(B, K, D)), device=dev).to(int_dt)
    return cache, idx, interests


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 16, 100, 4096])
@pytest.mark.parametrize("cache_dt, int_dt", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_lookup_score_routes_match_plain_on_card(rng, cache_dt, int_dt, C):
    """Both routes at the serving width (K = 32, D = 256) over one
    candidate, a slate, a count off the 64-candidate tile and a corpus
    top-k, one launch each, within the tolerance of the output's type."""
    dev = _card()
    args = _lookup_case(rng, dev, 5000, 3, C, 32, 256, cache_dt, int_dt)
    before = launch_counts()["lookup_score_fwd"]
    got = lookup_score.lookup_score_fused(*args)
    want = lookup_score.lookup_score_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["lookup_score_fwd"] == before + 1
    assert got.dtype == int_dt and got.shape == (3, C, 32) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(int_dt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, B, C, tiles", [
    (torch.float32, 3, 700, 1), (torch.bfloat16, 3, 700, 1),
    (torch.float32, 30, 700, 3), (torch.bfloat16, 60, 700, 3),
    (torch.float32, 62, 2000, 16), (torch.bfloat16, 124, 2000, 16)])
def test_lookup_score_runs_match_plain_on_card(rng, dtype, B, C, tiles):
    """Runs of one tile, of three (700 candidates are 11 tiles, the last of
    60: the row's last run is short) and of 16 (two runs a row, the last
    tile of 16 candidates), reached through B and C as the plan sizes runs
    to one wave of an H100's 132 SMs."""
    dev = _card()
    args = _lookup_case(rng, dev, 3000, B, C, 32, 256, dtype, dtype)
    assert lookup_score.plan(B, C, 32, 256, dtype, dtype,
                             lookup_score._sms(dev.index))[1] == tiles
    got = lookup_score.lookup_score_fused(*args)
    want = lookup_score.lookup_score_reference(*args)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)


def _c_lookup_smem_bytes(K, D, cache_dt, int_dt, tiles):
    return lookup_score._smem_bytes(K, D, lookup_score.CACHE_CODES[cache_dt],
                                    common.DTYPE_CODES[int_dt], tiles)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 10, 100, 4096])
@pytest.mark.parametrize("cache_dt", [torch.bfloat16, torch.int8])
def test_lookup_score_at_the_plm_width_on_card(rng, cache_dt, C):
    """The PLM's D = 768 (a Miner without --apply_reduce_dim) with bf16
    interests: a bf16 cache takes one gather buffer (two need ~251 KB a
    block: 157,184 bytes at runs of 16 tiles), an int8 cache still two;
    over one candidate, a slate, a count off the tile and a corpus top-k
    (runs of several tiles, each gathered after the last is scored),
    against the plain version. (An fp32 cache at D = 768 takes tiles of 32
    candidates: ``test_lookup_score_fp32_at_the_plm_width_on_card``.)"""
    dev = _card()
    bf16 = torch.bfloat16
    if cache_dt == bf16:
        assert _c_lookup_smem_bytes(32, 768, bf16, bf16, 16) == 157_184
    assert _c_lookup_smem_bytes(32, 768, cache_dt, bf16, 16) <= 227 * 1024
    args = _lookup_case(rng, dev, 5000, 3, C, 32, 768, cache_dt, bf16)
    before = launch_counts()["lookup_score_fwd"]
    got = lookup_score.lookup_score_fused(*args)
    want = lookup_score.lookup_score_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["lookup_score_fwd"] == before + 1
    assert got.shape == (3, C, 32) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(bf16, want)


def test_lookup_plan_takes_32_candidate_tiles_where_64_do_not_fit(monkeypatch):
    """fp32 rows at the PLM's D = 768 (the lstm combine without
    --apply_reduce_dim): a 64-candidate tile in two buffers needs ~500 KB a
    block, so the CUDA cores take tiles of 32 (runs counted in them), the
    library asked for their size; a shape where even those do not fit is
    refused, naming the bytes it needs. The sizes stand in for the
    library's: 98,816 bytes of interests, 98,304 a buffer of 32 fp32 rows,
    one buffer (runs of 16 tiles)."""
    asked = []

    def size(K, D, c, i, n, tile=lookup_score.TILE):
        asked.append(tile)
        return 98_816 + (4 if tile == 64 else 1) * 98_304 + 128 * n

    monkeypatch.setattr(lookup_score, "_smem_bytes", size)
    f32 = torch.float32
    route, tiles, smem = lookup_score.plan(32, 4096, 32, 768, f32, f32)
    assert route == "cuda_core_32" and lookup_score.TILES[route] == 32
    assert smem == size(32, 768, 0, 0, tiles, 32) <= 227 * 1024
    assert tiles == lookup_score.MAX_RUN and set(asked) == {64, 32}
    assert lookup_score.plan(64, 1, 32, 768, f32, f32)[:2] == ("cuda_core_32", 1)
    # bf16 rows with bf16 interests keep the tensor cores' 64-candidate tile
    monkeypatch.setattr(lookup_score, "_smem_bytes", lambda *a: 157_184)
    assert lookup_score.plan(32, 4096, 32, 768, torch.bfloat16, torch.bfloat16)[0] == \
        "tensor_core"
    monkeypatch.setattr(lookup_score, "_smem_bytes", lambda *a: 300_000 + 7 * len(a))
    with pytest.raises(ValueError, match="need 300042 bytes of shared memory"):
        lookup_score.plan(32, 4096, 32, 768, f32, f32)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 10, 100, 4096])
@pytest.mark.parametrize("int_dt", [torch.float32, torch.bfloat16])
def test_lookup_score_fp32_at_the_plm_width_on_card(rng, int_dt, C):
    """fp32 rows at the PLM's D = 768 (the lstm combine's news vectors
    without --apply_reduce_dim, a cached eval's and a corpus top-k's): the
    CUDA cores in 32-candidate tiles, one buffer (~203 KB a block at runs
    of 16), over one candidate, a slate, a count off the tile, an eval
    batch of 64 rows and a corpus top-k, against the plain version."""
    dev = _card()
    f32 = torch.float32
    assert lookup_score.plan(32, C, 32, 768, f32, int_dt)[0] == "cuda_core_32"
    assert _c_lookup_smem_bytes(32, 768, f32, f32, 16) > 227 * 1024  # 64 candidates
    assert lookup_score._smem_bytes(32, 768, 0, 0, 16, 32) <= 227 * 1024
    for B in (3, 64):
        args = _lookup_case(rng, dev, 5000, B, C, 32, 768, f32, int_dt)
        before = launch_counts()["lookup_score_fwd"]
        got = lookup_score.lookup_score_fused(*args)
        want = lookup_score.lookup_score_reference(*args)
        torch.cuda.synchronize()
        assert launch_counts()["lookup_score_fwd"] == before + 1
        assert got.dtype == int_dt and got.shape == (B, C, 32) and torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max().item() <= _tol(int_dt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("K, D", [(5, 64), (5, 256), (40, 48), (33, 40), (7, 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_score_odd_widths_match_plain_on_card(rng, K, D, dtype):
    """K off the 8-row pieces and past one 32-interest chunk; D off the
    16-column tiles (bf16 then takes the CUDA cores) and off the 16-byte
    copies (D = 30: element by element)."""
    dev = _card()
    args = _lookup_case(rng, dev, 300, 4, 150, K, D, dtype, dtype)
    got = lookup_score.lookup_score_fused(*args)
    want = lookup_score.lookup_score_reference(*args)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt, int_dt", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.int8, torch.bfloat16), (torch.int8, torch.float32)])
def test_lookup_score_out_of_range_rows_are_nan_on_card(rng, cache_dt, int_dt):
    """An index in [-N, 0) scores row N + index, as the JAX package's
    ``jnp.take`` wraps it; one below -N or at or past N gives NaN for that
    candidate's K scores; every other score is exact."""
    dev = _card()
    N = 200
    cache, idx, interests = _lookup_case(rng, dev, N, 2, 130, 32, 256, cache_dt, int_dt)
    bad = torch.zeros_like(idx, dtype=torch.bool)
    rows = idx.clone()
    for b, c, v in ((0, 0, -1), (0, 1, -N), (1, 70, -7)):  # wrapped: rows N - 1, 0, N - 7
        idx[b, c], rows[b, c] = v, v + N
    for b, c, v in ((0, 63, N), (0, 64, N + 5000), (1, 129, -(2 ** 31)), (1, 5, -N - 1)):
        idx[b, c] = v
        bad[b, c] = True
    got = lookup_score.lookup_score_fused(cache, idx, interests)
    want = lookup_score.lookup_score_reference(cache, rows.clamp(0, N - 1), interests)
    assert torch.isnan(got[bad]).all()
    assert torch.isfinite(got[~bad]).all()
    err = (got[~bad].float() - want[~bad].float()).abs().max().item()
    assert err <= _tol(int_dt, want[~bad])
    assert torch.equal(torch.isnan(lookup_score.lookup_score_reference(cache, idx, interests)),
                       torch.isnan(got))


@pytest.mark.gpu
@pytest.mark.parametrize("int_dt, B, C, K, D", [
    (torch.bfloat16, 32, 16, 32, 256),  # a serving slate, tensor cores
    (torch.bfloat16, 32, 4096, 32, 256),  # the corpus top-k
    (torch.float32, 32, 4096, 32, 256),  # fp32 interests: the CUDA cores
    (torch.bfloat16, 64, 1, 32, 256),  # an eval batch
    (torch.bfloat16, 4, 150, 5, 96),  # D a multiple of 32 off the 64-column ones
    (torch.bfloat16, 4, 150, 5, 48),  # D off the 32-column steps: the CUDA cores
    (torch.float32, 4, 150, 33, 30),  # D off the 16-byte copies: element by element
])
def test_lookup_score_int8_route_matches_plain_on_card(rng, int_dt, B, C, K, D):
    """int8 rows with a float32 scale each (``Int8Rows``), one launch each,
    against the plain version (an fp32 product of the same int8 values,
    times the scale, rounded once): the same function up to summation
    order, within the tolerance of the output's type."""
    dev = _card()
    args = _lookup_case(rng, dev, 5000, B, C, K, D, torch.int8, int_dt)
    before = launch_counts()["lookup_score_fwd"]
    got = lookup_score.lookup_score_fused(*args)
    want = lookup_score.lookup_score_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["lookup_score_fwd"] == before + 1
    assert got.dtype == int_dt and got.shape == (B, C, K) and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(int_dt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("int_dt", [torch.bfloat16, torch.float32])
def test_lookup_score_int8_is_bit_equal_across_launches_on_card(rng, int_dt):
    """Each score is one block's fixed sum: two launches agree bit for bit."""
    dev = _card()
    args = _lookup_case(rng, dev, 5000, 32, 4096, 32, 256, torch.int8, int_dt)
    assert torch.equal(lookup_score.lookup_score_fused(*args),
                       lookup_score.lookup_score_fused(*args))


@pytest.mark.gpu
def test_lookup_score_refuses_what_its_routes_do_not_take():
    """No fallback: float16 and int64 indices are refused, and so is a
    bf16 cache off a 16-byte boundary on the tensor-core route, a bare int8
    tensor (no scales) and int8 rows with scales of the wrong shape. At the
    corpus top-k the plan, sized by the kernel's own layout, is one wave:
    runs of 8 tiles, two blocks an SM."""
    dev = _card()
    cache = torch.zeros(10, 64, device=dev, dtype=torch.bfloat16)
    idx = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    interests = torch.zeros(2, 4, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        lookup_score.lookup_score_fused(cache.half(), idx, interests)
    with pytest.raises(TypeError, match="dtype"):
        lookup_score.lookup_score_fused(cache, idx.long(), interests)
    shifted = torch.zeros(10 * 64 + 4, device=dev, dtype=torch.bfloat16)[4:].view(10, 64)
    with pytest.raises(ValueError, match="16-byte"):
        lookup_score.lookup_score_fused(shifted, idx, interests)
    with pytest.raises(TypeError, match="dtype"):  # int8 rows without their scales
        lookup_score.lookup_score_fused(cache.to(torch.int8), idx, interests)
    rows = quantize_rows(cache)
    with pytest.raises(ValueError, match="shape"):
        lookup_score.lookup_score_fused(Int8Rows(rows.values, rows.scales.view(1, 10)), idx,
                                        interests)
    route, tiles, smem = lookup_score.plan(32, 4096, 32, 256, torch.bfloat16,
                                           torch.bfloat16, lookup_score._sms(dev.index))
    assert (route, tiles) == ("tensor_core", 8) and 2 * (smem + 1024) <= lookup_score.SM_SMEM


# ----------------------------------------------------------- Fastformer attention
def test_fastformer_plan_spreads_a_row_over_a_cluster(monkeypatch):
    """Four CTAs a row at the model's shapes; eight when a quarter of a long
    row does not fit in shared memory; refused when an eighth does not
    either. The size is the kernel's own (here a stand-in for the library
    that grows with a CTA's rows), asked for with q's type code."""
    asked = set()

    def size(L, D, h, nc, code):
        asked.add(code)
        return 40_000 + -(-L // nc) * D * 8

    monkeypatch.setattr(fastformer_attn, "_smem_bytes", size)
    assert fastformer_attn.plan(50, 256, 16, torch.float32) == (4, size(50, 256, 16, 4, 0))
    assert fastformer_attn.plan(256, 256, 16, torch.bfloat16)[0] == 4
    assert fastformer_attn.plan(512, 256, 16, torch.float32)[0] == 8
    assert asked == {common.DTYPE_CODES[torch.float32], common.DTYPE_CODES[torch.bfloat16]}
    with pytest.raises(ValueError, match="shared memory"):
        fastformer_attn.plan(16384, 32, 4, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, L, D, h", [(3, 1, 256, 16), (4, 7, 32, 16), (5, 50, 96, 12),
                                        (3, 33, 80, 20), (2, 512, 256, 16)])
def test_fastformer_row_slices_match_plain_on_card(rng, B, L, D, h, dtype):
    """One position (three of four CTAs own no rows); fewer positions than
    a row's CTAs hold evenly; 12 heads (padded to 16 in the score pass) and
    20 (two passes, the second a partial one); a row long enough to take 8
    CTAs. Each with a padded and a fully masked row."""
    dev = _card()
    xs, mask = _ff_inputs(rng, B, L, D, h)
    q, k = (torch.as_tensor(x, device=dev).to(dtype) for x in xs[:2])
    weights = [torch.as_tensor(x, device=dev).float() for x in xs[2:]]
    mask = torch.as_tensor(mask, device=dev)
    got = fastformer_attn.fastformer_attention_fused(q, k, *weights, mask, h)
    want = fastformer_attn.fastformer_attention_reference(q, k, *weights, mask, h)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, L, cluster", [
    (torch.float32, 50, 4), (torch.bfloat16, 50, 4),
    (torch.float32, 512, 8), (torch.bfloat16, 1024, 8)])
def test_fastformer_cluster_sizes_match_plain_on_card(rng, dtype, L, cluster):
    """The training shape, at the 4 CTAs a row the plan gives it, and a row
    long enough to take 8 (a quarter of 512 bf16 rows still fits): the same
    result within the tolerance, and bit for bit from run to run (partials
    summed in rank order)."""
    dev = _card()
    assert fastformer_attn.plan(L, 256, 16, dtype)[0] == cluster
    xs, mask = _ff_inputs(rng, 16, L, 256, 16)
    q, k = (torch.as_tensor(x, device=dev).to(dtype) for x in xs[:2])
    weights = [torch.as_tensor(x, device=dev).to(dtype) for x in xs[2:]]
    mask = torch.as_tensor(mask, device=dev)
    got = fastformer_attn.fastformer_attention_fused(q, k, *weights, mask, 16)
    again = fastformer_attn.fastformer_attention_fused(q, k, *weights, mask, 16)
    want = fastformer_attn.fastformer_attention_reference(q, k, *weights, mask, 16)
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)


@pytest.mark.gpu
def test_fastformer_bf16_rounds_where_the_reference_rounds_on_card(rng):
    """bf16 at the training shape against the reference (which rounds
    scores, weights, pooled vectors and u to bf16) and against the same
    function with every intermediate kept in fp32: the kernel must sit
    with the first, closer than the bf16 tolerance to it."""
    dev = _card()
    xs, mask = _ff_inputs(rng, 16, 50, 256, 16)
    q, k = (torch.as_tensor(x, device=dev).to(torch.bfloat16) for x in xs[:2])
    weights = [torch.as_tensor(x, device=dev).to(torch.bfloat16) for x in xs[2:]]
    mask = torch.as_tensor(mask, device=dev)
    got = fastformer_attn.fastformer_attention_fused(q, k, *weights, mask, 16).float()
    want = fastformer_attn.fastformer_attention_reference(q, k, *weights, mask, 16).float()
    unrounded = fastformer_attn.fastformer_attention_reference(
        q.float(), k.float(), *(w.float() for w in weights), mask, 16)
    err = (got - want).abs().max().item()
    assert err <= _tol(torch.bfloat16, want)
    assert err < (got - unrounded).abs().max().item()


# ------------------------------------------------ UnBERT's shapes on the card
def _unbert_mask(N, L):
    """Rows of UnBERT's packed lengths: full, one ending inside the last
    partial key tile (and the last query pass), one ending mid-sequence and
    a short one."""
    ends = [L, L - 7, L // 2 + 3, 5][:N]
    return (np.arange(L)[None] < np.asarray(ends)[:, None]).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [300, 23])
def test_mha_at_unbert_shapes_on_card(rng, L, dtype, rate):
    """UnBERT's attention shapes, 12 heads of Dh = 64, N = 4: the word level
    (L = 300: three query passes of 128, the last holding 44 rows; five key
    tiles of 64, the last holding 44; the bf16 backward's dQ summed over
    three key tiles of 128 in its fp32 scratch) and the news level (L =
    23, 3 + 20 sentences: several heads per block, a ragged 16-row block).
    Forward and backward against the plain versions, with the mask of one
    row ending inside the last partial tile."""
    dev = _card()
    N, H, Dh = 4, 12, 64
    qkv = torch.as_tensor(rng.normal(size=(N, L, 3 * H * Dh)) * 0.5, device=dev).to(dtype)
    mask = torch.as_tensor(_unbert_mask(N, L), device=dev)
    dout = torch.as_tensor(rng.normal(size=(N, L, H * Dh)), device=dev).to(dtype)
    before = launch_counts()
    out, stats = mha._launch_fwd(qkv, mask, H, 1, rate, 2 ** 35 + L, True)
    want = mha.mha_reference(qkv, mask, H, 1, rate, 2 ** 35 + L)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    got = mha.mha_backward(qkv, mask, dout, H, rate, 2 ** 35 + L, 1, out, stats)
    want = mha.mha_backward_reference(qkv, mask, dout, H, 1, rate, 2 ** 35 + L)
    torch.cuda.synchronize()
    assert launch_counts()["mha_fwd"] == before["mha_fwd"] + 1
    assert launch_counts()["mha_bwd"] == before["mha_bwd"] + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    _assert_mha_grad_close(got, want, H, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_ln_at_the_unbert_train_shape_on_card(rng, dtype):
    """add_ln forward (Triton) and backward (CUDA) at a UnBERT training
    micro-batch's word level, T = 16 x 300 = 4,800 rows of 768, with
    dropout 0.1, against the plain versions."""
    dev = _card()
    T, D, rate, seed = 4800, 768, 0.1, 2 ** 36 + 1
    x, h, dy = (torch.as_tensor(rng.normal(size=(T, D)), device=dev).to(dtype)
                for _ in range(3))
    g = torch.as_tensor(1 + 0.1 * rng.normal(size=D), device=dev).float()
    b = torch.as_tensor(0.1 * rng.normal(size=D), device=dev).float()
    got = add_ln.fused_dropout_add_ln(x, h, g, b, rate, 1e-12, seed)
    want = add_ln.add_ln_reference(x, h, g, b, 1e-12, rate, seed)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    for a, w in zip(add_ln.add_ln_backward(x, h, g, dy, 1e-12, rate, seed),
                    add_ln.add_ln_backward_reference(x, h, g, dy, 1e-12, rate, seed)):
        assert torch.isfinite(a).all()
        assert (a.float() - w.float()).abs().max().item() <= _tol(dtype, w)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["nseg", "mean", "attention"])
def test_unbert_forward_on_card_matches_cpu(rng, mode):
    """The tiny ``UNBert`` (2 + 2 layers of width 64, 4 heads of Dh = 16) in
    float32 over 3 packed rows of 300 tokens and 23 sentences: on the card
    through the mha and add_ln kernels, on the CPU through the plain
    versions; same weights; scores within 1e-4 of their scale."""
    import dataclasses as dc

    from miner_tpu_torch.models import PLMConfig, UNBert
    from miner_tpu_torch.models.plm import normal_init_

    dev = _card()
    cfg = dc.replace(PLMConfig.tiny(), max_position_embeddings=300)
    model = UNBert(cfg, news_mode=mode).eval()
    normal_init_(model, 0.02, torch.Generator().manual_seed(0))
    B, L, S = 3, 300, 23
    lengths, n_sent = np.array([300, 211, 40]), np.array([23, 17, 6])
    pos, spos = np.arange(L)[None], np.arange(S)[None]
    feat = {"input_ids": rng.integers(3, cfg.vocab_size, size=(B, L)),
            "input_mask": pos < lengths[:, None],
            "segment_ids": (pos >= 12) & (pos < lengths[:, None]),
            "news_segment_ids": np.minimum(pos // 10, 63),
            "sentence_ids": np.where(spos < n_sent[:, None], spos, 0),
            "sentence_mask": spos < n_sent[:, None]}
    feat = {k: torch.as_tensor(np.asarray(v, np.int64 if k.endswith("ids") else np.int32))
            for k, v in feat.items()}
    with torch.no_grad():
        want = model(feat)
        before = launch_counts()
        got = model.to(dev)({k: v.to(dev) for k, v in feat.items()}).cpu()
    counts = launch_counts()
    assert counts["mha_fwd"] - before["mha_fwd"] == 4  # 2 word + 2 news layers
    assert counts["add_ln_fwd"] - before["add_ln_fwd"] == 8
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


# ------------------------------------- UniSRec's pre-concat titles on the card
PRECONCAT_L = 159  # 32 title + 128 sapo - 1 tokens (NewsTable's pre-concat)


def _preconcat_mask(N, L=PRECONCAT_L):
    """Full rows and rows ending inside the last key tile of 64 (keys 128 to
    158: 31 keys), inside the second query tile of 128 (31 rows) and early."""
    ends = [L, L - 9, 140, 40][:N]
    return (np.arange(L)[None] < np.asarray(ends)[:, None]).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_at_the_preconcat_length_on_card(rng, dtype, rate):
    """bert-base's attention, 12 heads of Dh = 64, over UniSRec's
    pre-concatenated titles, L = 159: the forward's second query tile holds
    31 rows and its third key tile 31 keys; the bf16 backward sums dQ over
    two key tiles of 128 in its fp32 scratch, the second of 31 keys; masks
    end inside the last tile. Forward and backward against the plain
    versions, one launch each."""
    dev = _card()
    N, H, Dh, L = 4, 12, 64, PRECONCAT_L
    qkv = torch.as_tensor(rng.normal(size=(N, L, 3 * H * Dh)) * 0.5, device=dev).to(dtype)
    mask = torch.as_tensor(_preconcat_mask(N), device=dev)
    dout = torch.as_tensor(rng.normal(size=(N, L, H * Dh)), device=dev).to(dtype)
    seed = 2 ** 37 + L
    before = launch_counts()
    out, stats = mha._launch_fwd(qkv, mask, H, 1, rate, seed, True)
    want = mha.mha_reference(qkv, mask, H, 1, rate, seed)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    got = mha.mha_backward(qkv, mask, dout, H, rate, seed, 1, out, stats)
    want = mha.mha_backward_reference(qkv, mask, dout, H, 1, rate, seed)
    torch.cuda.synchronize()
    assert launch_counts()["mha_fwd"] == before["mha_fwd"] + 1
    assert launch_counts()["mha_bwd"] == before["mha_bwd"] + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    _assert_mha_grad_close(got, want, H, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_dropout_mask_at_the_preconcat_length_on_card(rng, dtype):
    """At L = 159 the forward kernel's dropout zeros lie exactly where the
    plain Philox mask drops or the key mask ends (rows ending inside the
    31-key tile), bit for bit, and the inference launch (no softmax
    statistics) agrees with the plain version."""
    dev = _card()
    N, H, Dh, L, rate, seed = 4, 2, 64, PRECONCAT_L, 0.3, 2 ** 38 + 5
    qkv = torch.as_tensor(rng.normal(size=(N, L, 3 * H * Dh)) * 0.5, device=dev).to(dtype)
    mask = torch.as_tensor(_preconcat_mask(N), device=dev)
    keep = philox.keep_mask(philox.mha_bits(seed, N, H, L, dev), rate)
    want_zero = ~(keep & mask.bool()[:, None, None, :])
    assert torch.equal(_mha_dropped(qkv, mask, H, rate, seed), want_zero)
    got = mha.fused_mha(qkv, mask, H)
    want = mha.mha_reference(qkv, mask, H)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_ln_at_a_row_count_off_the_block_on_card(rng, dtype):
    """add_ln forward (Triton, blocks of 4 rows of 768) and backward (CUDA)
    at T = 7 x 159 = 1,113 rows, not a multiple of the row block, with
    dropout 0.1: against the plain versions, dh's zeros bit for bit where
    the Philox mask drops."""
    dev = _card()
    T, D, rate, seed = 7 * PRECONCAT_L, 768, 0.1, 2 ** 39 + 3
    x, h, dy = (torch.as_tensor(rng.normal(size=(T, D)), device=dev).to(dtype)
                for _ in range(3))
    g = torch.as_tensor(1 + 0.1 * rng.normal(size=D), device=dev).float()
    b = torch.as_tensor(0.1 * rng.normal(size=D), device=dev).float()
    got = add_ln.fused_dropout_add_ln(x, h, g, b, rate, 1e-12, seed)
    want = add_ln.add_ln_reference(x, h, g, b, 1e-12, rate, seed)
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    grads = add_ln.add_ln_backward(x, h, g, dy, 1e-12, rate, seed)
    keep = philox.keep_mask(philox.add_ln_bits(seed, T, D, dev), rate)
    assert torch.equal(grads[1] != 0, keep)
    for a, w in zip(grads, add_ln.add_ln_backward_reference(x, h, g, dy, 1e-12, rate, seed)):
        assert torch.isfinite(a).all()
        assert (a.float() - w.float()).abs().max().item() <= _tol(dtype, w)


@pytest.mark.gpu
@pytest.mark.parametrize("legacy", [False, True])
def test_unisrec_forward_on_card_matches_cpu(rng, legacy):
    """The tiny ``UniSRec`` (a 2-layer tower of width 64, the adaptor to
    300, the SASRec tail) in float32 over pre-concatenated titles of 159
    tokens, 2 users of 1 + 3 candidates and 5 history slots (a no-click
    user; clicks first, or pads first): on the card through the mha and
    add_ln kernels (the tail's plain products on cuBLAS), on the CPU
    through the plain versions; same weights; scores within 1e-4 of their
    scale."""
    from miner_tpu_torch.models import NewsEncoderMoe, PLMConfig, UniSRec

    dev = _card()
    model = UniSRec(NewsEncoderMoe(PLMConfig.tiny()), max_his_len=5).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.news_encoder.moe_adaptor.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    B, C, H, L = 2, 4, 5, PRECONCAT_L
    his_mask = np.array([[0, 0, 1, 1, 1] if legacy else [1, 1, 1, 0, 0], [0] * 5], np.int32)
    batch = {"cand_title": rng.integers(1, 1000, size=(B, C, L)),
             "cand_title_mask": np.broadcast_to(_preconcat_mask(4), (B, C, L)),
             "his_title": rng.integers(1, 1000, size=(B, H, L)),
             "his_title_mask": np.broadcast_to(_preconcat_mask(1), (B, H, L)),
             "his_mask": his_mask}
    batch = {k: torch.as_tensor(np.ascontiguousarray(v).astype(np.int32)) for k, v in batch.items()}
    with torch.no_grad():
        want = model(batch)
        before = launch_counts()
        got = model.to(dev)({k: v.to(dev) for k, v in batch.items()}).cpu()
    counts = launch_counts()
    assert counts["mha_fwd"] - before["mha_fwd"] == 2  # one tower call of 2 layers
    assert counts["add_ln_fwd"] - before["add_ln_fwd"] == 4
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


# ----------------------------------------------- the legacy poly-attention fill
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_poly_attention_legacy_fill_on_card(rng, dtype):
    """--legacy_poly_mask at the main shape (H = 50, D = 256, P = 200, K =
    32): a masked slot's logit is the launch's 1e-30 in place of logits +
    bias. Against the plain version with the same fill; a user with no
    clicks gets the mean of all 50 rows (the bf16 kernel's rows past H,
    padding to 64, still get no weight); a partly masked row gives its pads
    a weight, so it differs from the -1e9 fill's."""
    dev = _card()
    B, H, D, P, K = 6, 50, 256, 200, 32
    emb = torch.as_tensor(rng.normal(size=(B, H, D)), device=dev).to(dtype)
    w = torch.as_tensor(rng.normal(size=(D, P)) / 16, device=dev).to(dtype)
    codes = torch.as_tensor(rng.normal(size=(K, P)) / 4, device=dev).to(dtype)
    lengths = torch.tensor([50, 0, 1, 37, 12, 50], device=dev)
    mask = (torch.arange(H, device=dev)[None] < lengths[:, None]).to(torch.int32)
    bias = torch.as_tensor(rng.normal(size=(B, H)), device=dev).float()
    fill = poly_attention.LEGACY_FILL
    before = launch_counts()["poly_attention_fwd"]
    got = poly_attention.poly_attention_fused(emb, w, codes, mask, bias, fill)
    want = poly_attention.poly_attention_reference(emb, w, codes, mask, bias, fill)
    masked = poly_attention.poly_attention_fused(emb, w, codes, mask, bias)
    torch.cuda.synchronize()
    assert launch_counts()["poly_attention_fwd"] == before + 2
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    mean = emb[1].float().mean(dim=0).expand(K, D)
    assert (got[1].float() - mean).abs().max().item() <= _tol(dtype, mean)
    for row in (2, 3, 4):  # partly masked: the pads take a weight
        assert (got[row].float() - masked[row].float()).abs().max().item() > 1e-2
    for row in (0, 5):  # no pads: the fill never enters
        assert torch.equal(got[row], masked[row])


# ------------------- the PLM kernels at a cached-history micro-batch (N = 80)
CACHED_N = 16 * 5  # train_miner.txt's micro-batch of 16 x (1 + 4) candidates


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [32, 128])
def test_plm_kernels_at_the_cached_candidate_batch_on_card(rng, L, dtype):
    """Under --his_cache_refresh the PLM sees a micro-batch's candidates
    alone: 80 sequences of titles (32) or sapos (128), roberta-base's 12
    heads of 64, dropout 0.1. mha forward and backward and add_ln forward
    and backward (80 L rows of 768) against their plain versions, one
    launch each; the mha backward per (sequence, head), dh's zeros bit for
    bit where the add_ln Philox mask drops."""
    dev = _card()
    N, H, Dh, rate = CACHED_N, 12, 64, 0.1
    qkv = torch.as_tensor(rng.normal(size=(N, L, 3 * H * Dh)) * 0.5, device=dev).to(dtype)
    lengths = torch.as_tensor(rng.integers(1, L + 1, size=N), device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).to(torch.int32)
    dout = torch.as_tensor(rng.normal(size=(N, L, H * Dh)), device=dev).to(dtype)
    seed = 2 ** 36 + L
    before = launch_counts()
    out, stats = mha._launch_fwd(qkv, mask, H, 1, rate, seed, True)
    want = mha.mha_reference(qkv, mask, H, 1, rate, seed)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    got = mha.mha_backward(qkv, mask, dout, H, rate, seed, 1, out, stats)
    _assert_mha_grad_close(got, mha.mha_backward_reference(qkv, mask, dout, H, 1, rate, seed),
                           H, dtype)
    T, D = N * L, H * Dh
    x, h, dy = (torch.as_tensor(rng.normal(size=(T, D)), device=dev).to(dtype)
                for _ in range(3))
    g = torch.as_tensor(1 + 0.1 * rng.normal(size=D), device=dev).float()
    b = torch.as_tensor(0.1 * rng.normal(size=D), device=dev).float()
    y = add_ln.fused_dropout_add_ln(x, h, g, b, rate, 1e-5, seed)
    want = add_ln.add_ln_reference(x, h, g, b, 1e-5, rate, seed)
    assert (y.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    grads = add_ln.add_ln_backward(x, h, g, dy, 1e-5, rate, seed)
    keep = philox.keep_mask(philox.add_ln_bits(seed, T, D, dev), rate)
    assert torch.equal(grads[1] != 0, keep)
    for a, w in zip(grads, add_ln.add_ln_backward_reference(x, h, g, dy, 1e-5, rate, seed)):
        assert torch.isfinite(a).all()
        assert (a.float() - w.float()).abs().max().item() <= _tol(dtype, w)
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in ("mha_fwd", "mha_bwd", "add_ln_fwd", "add_ln_bwd"):
        assert counts[name] == before[name] + 1, name


# ------------------------------------------------ --remat: the saved context
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["", "dots"])
def test_remat_saves_the_mha_kernel_s_context_on_card(rng, monkeypatch, policy, dtype):
    """The tiny PLM (2 layers of 4 heads of 16) on the card with --remat,
    dropout on, in both policies: a forward and backward launch mha_fwd
    once a layer (the recompute takes the saved context and statistics),
    mha_bwd once a layer, and never the plain version (it raises here); the
    gradients equal those of the same step with no remat (to 1e-6: the
    same kernels on the same inputs, sums in the same order)."""
    import dataclasses as dc

    from miner_tpu_torch.models import PLMConfig
    from miner_tpu_torch.models.dropout import DropoutRNG
    from miner_tpu_torch.models.plm import TransformerPLM, normal_init_

    dev = _card()
    ids = torch.as_tensor(rng.integers(1, 1000, size=(6, 32)), device=dev)
    mask = torch.ones_like(ids)
    mask[1, 20:] = 0
    grads = []
    for remat in (False, True):
        cfg = dc.replace(PLMConfig.tiny(), remat=remat, remat_policy=policy if remat else "")
        plm = TransformerPLM(cfg, dtype)
        normal_init_(plm, 0.02, torch.Generator().manual_seed(0))
        plm = plm.to(dev).train()
        with monkeypatch.context() as m:
            m.setattr(mha, "mha_reference", None)  # a call of the plain version raises
            before = launch_counts()
            out = plm(ids, mask, rng=DropoutRNG(5, 1, dev))
            out.float().square().mean().backward()
            torch.cuda.synchronize()
            after = launch_counts()
        assert after["mha_fwd"] - before["mha_fwd"] == cfg.num_layers
        assert after["mha_bwd"] - before["mha_bwd"] == cfg.num_layers
        grads.append({n: p.grad for n, p in plm.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-7, msg=n)


def _heads_of(qkv, H, h0, h1):
    """The Q, K and V features of heads [h0, h1) of a (N, L, 3 H Dh) qkv,
    in the [Q | K | V] layout: what a rank of the model axis holds."""
    N, L, D3 = qkv.shape
    return qkv.view(N, L, 3, H, D3 // 3 // H)[:, :, :, h0:h1].reshape(N, L, -1).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mha", "add_ln"])
def test_offset_launches_are_slices_of_the_whole_launch_on_card(rng, op, dtype):
    """A launch over some sequences (two runs of them, one launch each) and
    heads of a batch, or some of its rows, at their offsets in the batch,
    gives those sequences', heads' or rows' slice of the whole batch's
    launch bit for bit, forward and backward, dropout included, as a rank
    of a mesh does; and agrees with the plain version at the same offsets
    (add_ln's mask bit for bit)."""
    dev = _card()
    rate, seed = 0.2, 2 ** 36 + 9
    offset = ((0, 1), (3, 3))  # local sequences 0-2 are 1-3 of the batch, 3-4 are 6-7
    pick = philox.row_places(offset, 5, dev)
    if op == "mha":
        N, L, H, Dh = 8, 64, 4, 32
        qkv = torch.as_tensor(rng.normal(size=(N, L, 3 * H * Dh)) * 0.5, device=dev).to(dtype)
        mask = torch.ones((N, L), dtype=torch.int32, device=dev)
        mask[2, 40:] = 0
        dout = torch.as_tensor(rng.normal(size=(N, L, H * Dh)), device=dev).to(dtype)
        out, stats = mha._launch_fwd(qkv, mask, H, 1, rate, seed, True)
        dqkv = mha.mha_backward(qkv, mask, dout, H, rate, seed, 1, out, stats)
        local = _heads_of(qkv[pick], H, 2, 4)
        before = launch_counts()
        got, got_stats = mha._launch_fwd(local, mask[pick].contiguous(), 2, 1, rate, seed,
                                         True, offset, 2)
        ldout = dout[pick].view(5, L, H, Dh)[:, :, 2:4].reshape(5, L, -1).contiguous()
        got_d = mha.mha_backward(local, mask[pick].contiguous(), ldout, 2, rate, seed, 1,
                                 got, got_stats, offset, 2)
        torch.cuda.synchronize()
        after = launch_counts()
        assert (after["mha_fwd"] - before["mha_fwd"], after["mha_bwd"] - before["mha_bwd"]) \
            == (2, 2)
        assert torch.equal(got, out[pick].view(5, L, H, Dh)[:, :, 2:4].reshape(5, L, -1))
        assert torch.equal(got_stats, stats[pick][:, 2:4])
        assert torch.equal(got_d, _heads_of(dqkv[pick], H, 2, 4))
        want = mha.mha_reference(local, mask[pick], 2, 1, rate, seed, offset, 2)
        assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)
    else:
        T, D = 8 * 12, 96  # 8 sequences of 12 rows
        x, h, dy = (torch.as_tensor(rng.normal(size=(T, D)), device=dev).to(dtype)
                    for _ in range(3))
        g = torch.as_tensor(1 + 0.1 * rng.normal(size=D), device=dev).float()
        b = torch.zeros(D, device=dev)
        rows = (pick[:, None] * 12 + torch.arange(12, device=dev)).reshape(-1)
        rows_offset = philox.scaled(offset, 12)
        y = add_ln.fused_dropout_add_ln(x, h, g, b, rate, 1e-5, seed)
        dx, dh, _, _ = add_ln.add_ln_backward(x, h, g, dy, 1e-5, rate, seed)
        before = launch_counts()
        got = add_ln.fused_dropout_add_ln(x[rows], h[rows], g, b, rate, 1e-5, seed,
                                          rows_offset)
        got_dx, got_dh, _, _ = add_ln.add_ln_backward(x[rows], h[rows], g, dy[rows], 1e-5,
                                                      rate, seed, rows_offset)
        torch.cuda.synchronize()
        after = launch_counts()
        assert (after["add_ln_fwd"] - before["add_ln_fwd"],
                after["add_ln_bwd"] - before["add_ln_bwd"]) == (2, 2)
        assert torch.equal(got, y[rows]) and torch.equal(got_dx, dx[rows])
        assert torch.equal(got_dh, dh[rows])
        keep = philox.keep_mask(philox.add_ln_bits(seed, 5 * 12, D, dev, rows_offset), rate)
        assert torch.equal(got_dh != 0, keep)
        want = add_ln.add_ln_reference(x[rows], h[rows], g, b, 1e-5, rate, seed, rows_offset)
        assert (got.float() - want.float()).abs().max().item() <= _tol(dtype, want)
