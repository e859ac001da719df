"""The wide route's 3xTF32 arithmetic, emulated on the CPU.

`csrc/pairwise_l2.cu` computes the cross term q·pᵀ of f32 operands on
the tensor cores from a split a = hi + lo, hi = rna_tf32(a),
lo = rna_tf32(a − hi), summing hi·hi + hi·lo + lo·hi per term (the
lo·lo product and the split's residue are dropped). Its norms are the
plain version's, so the wide route differs from the plain version in
the cross term alone. These tests check, without the card:

  * the split: hi and lo are TF32 values (low 13 mantissa bits zero),
    a − hi is exact in f32, and |a − hi − lo| ≤ 2⁻²²|a|;
  * the per-term bound of the three products against the exact product,
    |ab − (hi_a hi_b + hi_a lo_b + lo_a hi_b)| ≤ 3·2⁻²²(1 + 2⁻⁹)|a||b|,
    summed over the row: the cross term is within that bound times
    Σ|a_k b_k| of the f64 product;
  * the stated bound of the wide route: with the three products taken
    in f64 and the cross term rounded once to f32, the squared distance
    (|q|² + |p|²) − 2·cross, clamped at 0, is within the expansion
    ceiling 8·2⁻²⁴·(max|q|² + max|p|²) of the same norms with the f64
    product q·pᵀ, at D ∈ {16, 64, 128} on random seeds.

The tensor cores' own summation order is not emulated: the card's tests
(`tests/test_torch_cuda.py`) and chip_smoke.py hold the kernel to the
same ceiling.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import pairwise_l2 as pw

U = 2.0**-24


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as `cvt.rna.tf32.f32` does: add half of the
    dropped 13 bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = rna_tf32(a)
    return hi, rna_tf32(a - hi)


def _case(seed: int, m: int, n: int, d: int):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    # scaled rows and shared rows: magnitudes over 2^±6, zero distances
    q[: m // 4] *= 2.0 ** float(rng.integers(-6, 7))
    p[: min(m, n) // 2] = q[: min(m, n) // 2]
    return q, p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_is_tf32_and_exact_to_2_pow_minus_22(seed):
    q, _ = _case(seed, 256, 8, 64)
    hi, lo = split(q)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    # a − hi is exact in f32 (Sterbenz), so the residue is lo's rounding
    a64, hi64, lo64 = q.double(), hi.double(), lo.double()
    assert torch.equal((q - hi).double(), a64 - hi64)
    assert ((a64 - hi64 - lo64).abs() <= 2.0**-22 * a64.abs()).all()


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_products_within_stated_bound(seed, d):
    q, p = _case(seed, 64, 96, d)
    (qh, ql), (ph, pl) = split(q), split(p)
    qh, ql, ph, pl = (t.double() for t in (qh, ql, ph, pl))
    q64, p64 = q.double(), p.double()
    cross3 = qh @ ph.T + qh @ pl.T + ql @ ph.T  # the three products, f64
    exact = q64 @ p64.T
    per_term = 3 * 2.0**-22 * (1 + 2.0**-9)
    assert ((cross3 - exact).abs() <= per_term * (q64.abs() @ p64.abs().T)).all()

    # the wide route's squared distance: the plain version's norms, the
    # cross term rounded once to f32, against the same norms with the
    # f64 product
    qn = pw.pairwise_plain(q, torch.zeros(1, d))[:, 0]  # |q|², plain order
    pn = pw.pairwise_plain(p, torch.zeros(1, d))[:, 0]
    got = torch.clamp((qn[:, None] + pn[None, :]) - 2.0 * cross3.float(), min=0.0)
    ref = torch.clamp(qn.double()[:, None] + pn.double()[None, :] - 2.0 * exact,
                      min=0.0)
    ceiling = 8 * U * float((q * q).sum(1).max() + (p * p).sum(1).max())
    assert float((got.double() - ref).abs().max()) <= ceiling
