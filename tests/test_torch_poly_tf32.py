"""The float32 poly-attention kernel's arithmetic, emulated on the CPU.

On the card the fp32 route of ``csrc/poly_attention_fwd.cu`` spreads a
batch row over a cluster of NC CTAs (3; 8 where a third of W does not
fit; 8 with D split where emb whole does not fit) and runs its three products
on the tensor cores in split TF32 (each operand x = hi + lo,
a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, one ``mma.sync.m16n8k8`` each,
k-steps of 8 in order; ``tests/test_torch_tf32.py`` emulates one product
bit for bit). Per row, with H padded to 16 rows, D to
8 columns and P to 8-column pieces, all padding zero:

    proj      = tanh(emb @ W)                      fp32, CTA r: its pieces of P;
                even and odd k-steps in two accumulators, added at the end
                (D split: CTA r's product over its pieces of D, for all of P,
                the partials summed in rank order before tanh)
    partial_r = proj[:, pieces r] @ codes[:, pieces r]^T
    logits    = ((0 + partial_0) + partial_1 + ...) + bias, in rank order;
                masked slots -> mask_fill; rows past H -> -inf
    weights   = softmax over H, fp32
    out       = weights^T @ emb                    (K, D)

This file emulates that chain in torch and holds it to the kernel's fp32
tolerance, 1e-4 of the output's scale (``chip_smoke.REL_TOL``,
``tests/test_torch_kernels.py:_tol``), against a float64 chain and against
the JAX package's ``poly_attention_fused`` in interpret mode (its Pallas
kernel on the CPU) or, under the legacy 1e-30 fill, which the Pallas
kernel does not take, JAX's XLA path (``PolyAttention(legacy_mask=True)``'s
math). It also records that one TF32 pass a product would miss that
tolerance at these shapes. Nothing here is on the card's path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miner_tpu.models.poly_attention import poly_attention_scores as jax_poly_scores
from miner_tpu.ops.poly_attention import poly_attention_fused as jax_poly
from miner_tpu_torch.ops.poly_attention import LEGACY_FILL, NEG_INF
from tests.test_torch_tf32 import REL_TOL, product

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: the tier-1 suite
    (ROADMAP.md) runs six xdist workers on one CPU, where each worker's
    intra-op threads oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"main": (4, 50, 256, 200, 32),  # B, H, D, P, K of the main path
          "off_tile": (3, 5, 40, 24, 3),  # D, P off the pieces; 3 pieces for 8 CTAs
          "plm_width": (4, 50, 768, 200, 32)}  # D = the PLM's, no --apply_reduce_dim
# (CTAs a row, D split) the kernel takes at each shape (ops/poly_attention.py:plan)
KERNEL_PLAN = {"main": (3, False), "off_tile": (3, False), "plm_width": (8, True)}
PLANS = {"3": (3, False), "8": (8, False), "8_split": (8, True)}
FILLS = {"masked": NEG_INF, "legacy": LEGACY_FILL}


def _inputs(shape: str):
    """emb, w, codes, mask, bias as numpy float32 / int32, scaled as
    chip_smoke.py's poly cases make them; row 0 holds every click, row 1
    none (the no-click user), row 2 half of H, the rest a random length."""
    B, H, D, P, K = SHAPES[shape]
    rng = np.random.default_rng(H * D + P)
    emb = rng.normal(size=(B, H, D)).astype(np.float32)
    w = (rng.normal(size=(D, P)) / 16).astype(np.float32)
    codes = (rng.normal(size=(K, P)) / 4).astype(np.float32)
    lengths = rng.integers(1, H + 1, size=B)
    lengths[:3] = H, 0, H // 2
    mask = (np.arange(H)[None] < lengths[:, None]).astype(np.int32)
    bias = rng.normal(size=(B, H)).astype(np.float32)
    return emb, w, codes, mask, bias


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def proj_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernel's proj product takes it: the even and the odd
    k-steps of 8 in two accumulators, added at the end."""
    steps = torch.arange(a.shape[-1]).view(-1, 8)
    even, odd = steps[0::2].flatten(), steps[1::2].flatten()
    acc = product(a[..., even], b[even], passes)
    return acc + product(a[..., odd], b[odd], passes) if len(odd) else acc


def emulate(emb, w, codes, mask, bias, fill, plan, passes=3) -> torch.Tensor:
    """(B, K, D) as the fp32 kernel computes it with ``plan`` = (CTAs a
    row, D split)."""
    nc, split = plan
    emb, w, codes, bias = (torch.from_numpy(a) for a in (emb, w, codes, bias))
    mask = torch.from_numpy(mask).bool()
    B, H, D = emb.shape
    K, P = codes.shape
    Hp, Kp, Dp = -(-H // 16) * 16, -(-K // 16) * 16, -(-D // 8) * 8
    np8 = -(-P // 8)
    e, wp = _pad(emb, Hp, Dp), _pad(w, Dp, 8 * np8)
    if split:  # CTA r's partial proj over its pieces of D, summed in rank order
        nd8 = Dp // 8
        acc = torch.zeros(B, Hp, 8 * np8)
        for r in range(nc):
            lo, hi = 8 * (r * nd8 // nc), 8 * ((r + 1) * nd8 // nc)
            if hi > lo:
                acc = acc + proj_product(e[..., lo:hi], wp[lo:hi], passes)
        proj = torch.tanh(acc)
    else:
        proj = torch.tanh(proj_product(e, wp, passes))  # (B, Hp, 8 np8)
    cp = _pad(codes, Kp, 8 * np8)
    acc = torch.zeros(B, Hp, Kp)
    for r in range(nc):  # CTA r's pieces of P, partials summed in rank order
        lo, hi = 8 * (r * np8 // nc), 8 * ((r + 1) * np8 // nc)
        part = (product(proj[..., lo:hi], cp[:, lo:hi].T, passes) if hi > lo
                else torch.zeros(B, Hp, Kp))
        acc = acc + part
    logits = torch.where(mask[..., None], acc[:, :H] + bias[..., None],
                         torch.tensor(fill, dtype=torch.float32))
    logits = torch.cat([logits, torch.full((B, Hp - H, Kp), -torch.inf)], dim=1)
    weights = torch.softmax(logits, dim=1)  # over H, fp32
    out = product(weights.transpose(1, 2), e, passes)  # (B, Kp, Dp)
    return out[:, :K, :D]


def float64_chain(emb, w, codes, mask, bias, fill) -> torch.Tensor:
    emb, w, codes, bias = (torch.from_numpy(a).double() for a in (emb, w, codes, bias))
    proj = torch.tanh(emb @ w)
    logits = torch.einsum("bhp,kp->bkh", proj, codes) + bias[:, None, :]
    logits = torch.where(torch.from_numpy(mask).bool()[:, None, :], logits,
                         torch.tensor(fill, dtype=torch.float64))
    return torch.einsum("bkh,bhd->bkd", torch.softmax(logits, dim=-1), emb)


def jax_chain(emb, w, codes, mask, bias, fill) -> np.ndarray:
    """The JAX package in fp32 on the CPU: its Pallas kernel in interpret
    mode, or under the legacy fill its XLA path (the kernel takes no fill)."""
    emb_j, w_j, codes_j, mask_j, bias_j = (jnp.asarray(a) for a in (emb, w, codes, mask, bias))
    if fill == NEG_INF:
        return np.asarray(jax_poly(emb_j, w_j, codes_j, mask_j, bias_j, True))
    weights = jax_poly_scores(jnp.tanh(emb_j @ w_j), codes_j, mask_j, bias_j, True)
    return np.asarray(jnp.einsum("bkh,bhd->bkd", weights, emb_j))


def _rel_err(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.array(want)).double()
    return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_tf32_chain_holds_the_fp32_tolerance(shape, fill, plan):
    args = _inputs(shape) + (FILLS[fill],)
    got = emulate(*args, PLANS[plan])
    assert torch.isfinite(got).all()
    assert _rel_err(got, float64_chain(*args)) <= REL_TOL


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_tf32_chain_matches_jax(shape, fill):
    args = _inputs(shape) + (FILLS[fill],)
    assert _rel_err(emulate(*args, KERNEL_PLAN[shape]), jax_chain(*args)) <= REL_TOL


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_no_click_row_is_the_mean_of_the_history(shape, fill):
    """Row 1 has no click: every real slot holds the finite fill, so its
    interests are the mean of the H real rows; the rows padding H to 16
    take no weight."""
    args = _inputs(shape) + (FILLS[fill],)
    emb = args[0]
    mean = torch.from_numpy(emb[1]).double().mean(0).expand(SHAPES[shape][4], -1)
    assert _rel_err(emulate(*args, KERNEL_PLAN[shape])[1], mean) <= REL_TOL


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_one_tf32_pass_misses_the_fp32_tolerance(shape, fill):
    """Why the kernel takes three passes: the same chain with one TF32 pass
    a product (operands rounded to TF32) misses 1e-4 of the scale."""
    args = _inputs(shape) + (FILLS[fill],)
    assert _rel_err(emulate(*args, KERNEL_PLAN[shape], passes=1),
                    float64_chain(*args)) > REL_TOL
