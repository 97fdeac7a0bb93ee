"""K1 and K2 (fused joint forward and backward), K3 and K4 (alpha and
beta recursions) and K5 (window gather) on the card against their plain
PyTorch versions.
Skipped without CUDA; on a card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda

Tolerances: K1 compares bf16-input joints whose float32 sums run in
another order (atol 2e-3, rtol 1e-3); K3 compares float32 log-semiring
scans grouped differently (atol 1e-3, rtol 1e-5 on NLLs of O(10^2-10^3)).
K2: each gradient within 5e-3 relative L2 error — dl is rounded to bf16 in
both versions, but the logits it comes from differ in their last float32
bits, so a few dl values round to the neighbouring bf16 (2^-8 relative),
and fp32 atomics sum in a varying order.  K4: the gradients are
exp(alpha + lp + beta - ll) with exponents summed from O(10^2-10^3)
log-probs in another order, so atol 1e-4, rtol 3e-3.  K5 copies values:
bit-equal.
"""

import math

import pytest
import torch

from rnnt_tpu_torch.ops.lattice_pallas import (
    K3, K4, alpha_forward, alpha_plain, beta_backward, beta_plain)
from rnnt_tpu_torch.ops.transducer import NEG
from rnnt_tpu_torch.ops.transducer_pallas import (
    K1, K2, fused_joint_backward, fused_joint_bwd_plain, fused_joint_outputs,
    fused_joint_outputs_plain)
from rnnt_tpu_torch.ops.window_gather import K5, gather_windows, gather_windows_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, atol, rtol):
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= atol + rtol * want.abs()).all(), \
        float((got - want).abs().max())


@pytest.mark.parametrize("shape", [
    (2, 19, 7, 64, 48),        # one partial V chunk
    (1, 5, 130, 100, 1000),    # H % 8 != 0: scalar h staging
    (2, 9, 5, 36, 37),         # V % 8 != 0: W staged without cp.async
    (3, 33, 65, 1024, 1024),   # the eval widths, ragged row tiles
    (1, 7, 9, 2048, 256),      # H too wide for 64-row tiles: 32-row tiles
])
def test_k1_matches_plain(cuda, shape):
    B, T, U1, H, V = shape
    g = torch.Generator().manual_seed(sum(shape))
    enc = (torch.randn(B, T, H, generator=g) * 0.5).to(torch.bfloat16).to(cuda)
    pred = (torch.randn(B, U1, H, generator=g) * 0.5).to(torch.bfloat16).to(cuda)
    w = (torch.randn(H, V, generator=g) / math.sqrt(H)).to(torch.bfloat16).to(cuda)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda)
    labels = torch.randint(0, V - 1, (B, U1), generator=g,
                           dtype=torch.int32).to(cuda)
    before = K1.launches
    got = fused_joint_outputs(enc, pred, w, b, labels, V - 1)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    for x, y in zip(got, fused_joint_outputs_plain(enc, pred, w, b, labels, V - 1)):
        _close(x, y, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("shape", [(3, 40, 17), (2, 150, 31), (2, 64, 300),
                                   (4, 504, 65)])
def test_k3_matches_plain(cuda, shape):
    B, T, U1 = shape
    g = torch.Generator().manual_seed(sum(shape))
    lpb = torch.randn(B, T, U1, generator=g) - 1.5
    lpl = torch.randn(B, T, U1, generator=g) - 1.5
    u_lens = torch.randint(1, U1, (B,), generator=g, dtype=torch.int32)
    t_lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lpl = torch.where(torch.arange(U1)[None, None, :] < u_lens[:, None, None],
                      lpl, torch.full_like(lpl, NEG))
    args = [x.to(cuda) for x in (lpb, lpl, t_lens, u_lens)]
    before = K3.launches
    nll, alpha = alpha_forward(*args)
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    nll_p, alpha_p = alpha_plain(*args)
    _close(nll, nll_p, atol=1e-3, rtol=1e-5)
    live = alpha_p > NEG / 2
    _close(alpha[live], alpha_p[live], atol=1e-3, rtol=1e-5)
    assert (alpha[~live] <= NEG / 2).all()


def _joint_case(shape, cuda, seed):
    B, T, U1, H, V = shape
    g = torch.Generator().manual_seed(seed)
    enc = (torch.randn(B, T, H, generator=g) * 0.5).to(torch.bfloat16).to(cuda)
    pred = (torch.randn(B, U1, H, generator=g) * 0.5).to(torch.bfloat16).to(cuda)
    w = (torch.randn(H, V, generator=g) / math.sqrt(H)).to(torch.bfloat16).to(cuda)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda)
    labels = torch.randint(0, V - 1, (B, U1), generator=g,
                           dtype=torch.int32).to(cuda)
    return [enc, pred, w, b, labels, V - 1]


def _rel_l2(got, want):
    assert torch.isfinite(got).all()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("shape,clamp", [
    ((2, 19, 7, 64, 48), -1.0),       # one partial V chunk
    ((1, 5, 13, 100, 1000), -1.0),    # H % 8 != 0: scalar h loads
    ((2, 9, 5, 36, 37), 0.05),        # V % 8 != 0, clamp on
    ((3, 33, 65, 1024, 1024), -1.0),  # the eval widths, ragged patches
    ((128, 16, 16, 1024, 1024), 0.01),  # the banded patches, clamp on
])
def test_k2_matches_plain(cuda, shape, clamp):
    B, T, U1, H, V = shape
    args = _joint_case(shape, cuda, sum(shape))
    lse = fused_joint_outputs_plain(*args)[0]
    g = torch.Generator().manual_seed(1)
    g_blank, g_label = (torch.randn(B, T, U1, generator=g).to(cuda) * 0.3
                        for _ in range(2))
    g_lse = -(g_blank + g_label)
    before = K2.launches
    got = fused_joint_backward(*args, lse, g_blank, g_label, g_lse, clamp)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    want = fused_joint_bwd_plain(*args, lse, g_blank, g_label, g_lse, clamp)
    for name, x, y in zip(("denc", "dpred", "dW", "db"), got, want):
        assert _rel_l2(x, y) < 5e-3, (name, _rel_l2(x, y))


@pytest.mark.parametrize("shape", [(3, 40, 17), (2, 150, 31), (2, 64, 300),
                                   (4, 504, 65)])
def test_k4_matches_plain(cuda, shape):
    B, T, U1 = shape
    g = torch.Generator().manual_seed(sum(shape))
    lpb = torch.randn(B, T, U1, generator=g) - 1.5
    lpl = torch.randn(B, T, U1, generator=g) - 1.5
    u_lens = torch.randint(0, U1, (B,), generator=g, dtype=torch.int32)
    t_lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lpl = torch.where(torch.arange(U1)[None, None, :] < u_lens[:, None, None],
                      lpl, torch.full_like(lpl, NEG))
    cot = torch.randn(B, generator=g)
    args = [x.to(cuda) for x in (lpb, lpl, t_lens, u_lens)]
    nll, alpha = alpha_plain(*args)
    before = K4.launches
    got = beta_backward(*args[:2], alpha, *args[2:], nll, cot.to(cuda))
    torch.cuda.synchronize()
    assert K4.launches == before + 1
    want = beta_plain(*args[:2], alpha, *args[2:], nll, cot.to(cuda))
    for x, y in zip(got, want):
        _close(x, y, atol=1e-4, rtol=3e-3)


@pytest.mark.parametrize("B,L,N,width,lo,hi", [
    (4, 165120, 1282, 256, 0, 165120),     # chorus rows (L + pad)
    (4, 164096, 2564, 128, 0, 164096),     # resample
    (4, 164080, 1282, 128, -300, 164500),  # trim; clipped starts
    (4, 164080, 639, 512, 0, 163568),      # time-stretch frames
    (3, 1000, 17, 256, -50, 1100),         # N % 8 != 0, windows past L
    (1, 1, 3, 128, -2, 3),                 # a one-sample row
])
def test_k5_matches_plain(cuda, B, L, N, width, lo, hi):
    g = torch.Generator().manual_seed(L + N)
    x = torch.randn(B, L, generator=g).to(cuda)
    starts = torch.randint(lo, hi, (B, N), generator=g, dtype=torch.int32).to(cuda)
    before = K5.launches
    got = gather_windows(x, starts, width)
    torch.cuda.synchronize()
    assert K5.launches == before + 1
    assert torch.equal(got, gather_windows_plain(x, starts, width))


def test_wrappers_check_inputs(cuda):
    x = torch.zeros((1, 4, 3), device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        alpha_forward(x, x, lens.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        alpha_forward(x.transpose(1, 2).contiguous().transpose(1, 2), x, lens, lens)
    bf = torch.zeros((1, 4, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fused_joint_outputs(bf.float(), bf, bf[0].T.contiguous(), x[0, 0],
                            lens.view(1, 1), 0)
    with pytest.raises(ValueError, match="dtype"):
        gather_windows(x[0], lens.view(1, 1).long(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        gather_windows(x[0].T.contiguous().T, lens.repeat(4).view(4, 1), 128)
