"""The float32 mha kernels' arithmetic, emulated on the CPU.

On the card the fp32 attention kernels (``csrc/mha_fwd.cu``,
``csrc/mha_bwd.cu``) run their products on the tensor cores in split TF32
(``csrc/tensor_core.cuh``): each operand x = hi + lo with hi = x rounded to
TF32, nearest with ties away (as ``cvt.rna``), and lo = x - hi in fp32,
which the tensor cores read as TF32 by dropping its 13 low bits; and
a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, one ``mma.sync.m16n8k8`` each, in
that order into fp32 accumulators. This file emulates that bit for bit in
torch (rounding by integer operations on the float's bits) at mha's shapes
and holds it to the kernels' fp32 tolerance, 1e-4 of the values' scale,
against a float64 reference; one TF32 pass must miss that tolerance, which
is why the kernels take three. It also checks, on the PTX fragment layouts,
that an m16n8k8 C tile read as {c0, c2, c1, c3} is the A fragment of its 8
columns taken in the order (2t, 2t+1), the permutation the kernels use to
feed P (and the backward's Pd^T, dS^T) to the next product in registers.
Nothing here is on the card's path.
"""
import numpy as np
import pytest
import torch

REL_TOL = 1e-4  # chip_smoke.REL_TOL[torch.float32], tests/test_torch_kernels.py:_tol


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10-bit mantissa, nearest with ties away
    from zero: PTX ``cvt.rna.tf32.f32``. Adding half an ulp of TF32 to the
    magnitude bits and clearing the 13 low bits rounds the magnitude half
    up, whatever the sign; a carry into the exponent is the right result."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_operand(x: torch.Tensor) -> torch.Tensor:
    """An fp32 value as the tensor cores read a TF32 operand: its 13 low
    bits dropped (rounding toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """hi (a TF32 value) and lo = x - hi (exact in fp32), as the kernels
    split an operand."""
    hi = tf32_rna(x)
    return hi, x - hi


def mma_tf32(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a @ b over one k-step of 8 on TF32 operands: the products of
    TF32 values are exact in float64, and the sum is rounded into the fp32
    accumulator."""
    return (acc.double() + tf32_operand(a).double() @ tf32_operand(b).double()).float()


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b (float32, k a multiple of 8) as the kernels' mma.sync loop
    computes it: k-steps of 8 in order, each split-TF32 step adding
    a_lo b_hi, a_hi b_lo, a_hi b_hi (passes = 3), or one TF32 pass."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ah, al = split_tf32(a[..., k0:k0 + 8])
        bh, bl = split_tf32(b[..., k0:k0 + 8, :])
        if passes == 3:
            acc = mma_tf32(acc, al, bh)
            acc = mma_tf32(acc, ah, bl)
        acc = mma_tf32(acc, ah, bh)
    return acc


def _heads(L: int, N=4, H=2, Dh=64):
    """q, k, v (N, H, L, Dh) and the probabilities P (float32) at mha's
    shapes, values scaled as tests/test_torch_kernels.py:_mha_inputs makes
    them (normal x 0.5; a padded row, a fully masked row)."""
    rng = np.random.default_rng(L)
    qkv = (rng.normal(size=(N, L, 3 * H * Dh)) * 0.5).astype(np.float32)
    mask = np.ones((N, L), bool)
    mask[1, 20:] = False
    mask[2, :] = False
    q, k, v = torch.from_numpy(qkv).view(N, L, 3, H, Dh).permute(2, 0, 3, 1, 4)
    s = (q.double() @ k.double().transpose(-1, -2)) / Dh ** 0.5
    s = torch.where(torch.from_numpy(mask)[:, None, None, :], s, -1e9)
    return q.contiguous(), k.contiguous(), v.contiguous(), torch.softmax(s, -1).float()


def _operands(what: str, L: int):
    q, k, v, p = _heads(L)
    return (q, k.transpose(-1, -2)) if what == "QK^T" else (p, v)


def _rel_err(what: str, L: int, passes: int) -> float:
    a, b = _operands(what, L)
    want = a.double() @ b.double()
    got = product(a, b, passes).double()
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def test_tf32_rounding_is_nearest_with_ties_away():
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 2 - 2 ** -23, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 2.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    hi, lo = split_tf32(x)
    assert torch.equal(tf32_operand(hi), hi) and torch.equal(hi + lo, x)
    # as the tensor cores read it, the split keeps ~21 bits of x
    assert ((hi.double() + tf32_operand(lo).double() - x.double()).abs()
            <= 2.0 ** -21 * x.double().abs()).all()


@pytest.mark.parametrize("L", [128, 300])
@pytest.mark.parametrize("what", ["QK^T", "PV"])
def test_split_tf32_products_hold_the_fp32_tolerance(what, L):
    assert _rel_err(what, L, passes=3) <= REL_TOL


@pytest.mark.parametrize("L", [128, 300])
@pytest.mark.parametrize("what", ["QK^T", "PV"])
def test_one_tf32_pass_misses_the_fp32_tolerance(what, L):
    assert _rel_err(what, L, passes=1) > REL_TOL


def _mma_m16n8k8(a_frag: np.ndarray, b_frag: np.ndarray) -> np.ndarray:
    """The product of one m16n8k8 from its lanes' fragments, by the PTX
    layouts (lane = 4 g + t): A a0 (g, t), a1 (g+8, t), a2 (g, t+4),
    a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g). Returns the (32, 4) C
    fragments: c[e] (g, 2t+e), c[2+e] (g+8, 2t+e)."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frag[lane]
        B[t, g], B[t + 4, g] = b_frag[lane]
    C = A @ B
    return np.array([[C[g + 8 * (x >> 1), 2 * (lane % 4) + (x & 1)] for x in range(4)]
                     for lane in range(32) for g in [lane // 4]])


def test_c_tile_is_an_a_fragment_with_its_columns_permuted():
    """P's C tile (16 rows x 8 keys), read as {c0, c2, c1, c3}, with V's
    rows read as (2t, 2t + 1) for B, gives P V: what the forward's PV and
    the backward's dV, dK take from registers with no shuffle."""
    rng = np.random.default_rng(0)
    P, V = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    c = np.array([[P[lane // 4 + 8 * (x >> 1), 2 * (lane % 4) + (x & 1)] for x in range(4)]
                  for lane in range(32)])
    a = c[:, [0, 2, 1, 3]]
    b = np.array([[V[2 * (lane % 4), lane // 4], V[2 * (lane % 4) + 1, lane // 4]]
                  for lane in range(32)])
    got = _mma_m16n8k8(a, b)
    want = P @ V
    want_frag = np.array([[want[lane // 4 + 8 * (x >> 1), 2 * (lane % 4) + (x & 1)]
                           for x in range(4)] for lane in range(32)])
    np.testing.assert_allclose(got, want_frag, rtol=1e-12, atol=1e-12)
