"""K1 and K2 (fused joint forward and backward), K3 and K4 (alpha and
beta recursions), K5 (window gather) and K6 and K7 (the T-sharded chain's
alpha and beta stages) on the card against their plain PyTorch versions.
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
bit-equal.  K1 and K2 on a vocabulary slice (``v0``) take the same
tolerances.  K6 and K7 take K3's and K4's tolerances, and on one shard at
t0 = 0 equal K3 and K4 bit for bit (one sweep).  K2's softmax formed
against K1's lse sums to 1 within 1e-5 (both kernels round h by one
device function and sum the same logits).  K1 and K2 with the ReLU joint
take the tanh cases' tolerances against their plain versions; the exact
loss through them against the chunked path's within 1e-4 relative (float32
sums in another order) and its gradients within 2e-2 relative L2 (the
chunked path's autograd rounds d(loss)/dh to bf16 where K2 rounds dl).
"""

import math

import pytest
import torch

from rnnt_tpu_torch.ops.lattice_pallas import (
    K3, K4, K6, K7, alpha_chain_forward, alpha_chain_plain, alpha_forward,
    alpha_plain, beta_backward, beta_chain_backward, beta_chain_plain, beta_plain)
from rnnt_tpu_torch.ops.transducer import NEG
from rnnt_tpu_torch.ops.transducer_pallas import (
    K1, K2, fused_joint_backward, fused_joint_bwd_plain, fused_joint_forward,
    fused_joint_outputs, fused_joint_outputs_plain)
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
    (2, 19, 7, 64, 48),        # one partial V tile
    (1, 5, 130, 100, 1000),    # H % 8 != 0: enc, pred, W zero-padded
    (2, 9, 5, 36, 37),         # H, V % 8 != 0: columns past V out of the sum
    (3, 33, 65, 1024, 1024),   # the eval widths, ragged row tiles
    (1, 7, 9, 2048, 256),      # scaled_tp's joint width, one V tile
    (2, 32, 17, 2048, 1024),   # scaled_tp's joint width, four V tiles
    (128, 16, 16, 1024, 1024),  # the banded patches of the pruned loss
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


# The lattices K3 and K4 are held to: (shape, t_lens or None for random,
# banded).  Besides the first four, the wavefront's edges: U1 = 1 (u_len 0),
# T = 1, one column past a warp, U1 = 257, U_MAX = 1024, U1 > T, t_lens
# mixing 1, T and values between, and a lattice from banded_to_full (mostly
# NEG, as in the flagship's pruned step).
LATTICE_CASES = [
    ((3, 40, 17), None, False), ((2, 150, 31), None, False),
    ((2, 64, 300), None, False), ((4, 504, 65), None, False),
    ((3, 9, 1), None, False), ((2, 1, 9), [1, 1], False),
    ((2, 40, 33), None, False), ((2, 60, 257), None, False),
    ((1, 30, 1024), None, False), ((2, 20, 300), None, False),
    ((4, 50, 40), [1, 50, 17, 33], False), ((4, 120, 65), [120, 97, 64, 30], True),
]
LATTICE_IDS = ["x".join(map(str, c[0])) + ("-lens" if c[1] else "") + ("-banded" if c[2] else "")
               for c in LATTICE_CASES]


def _lattice_inputs(shape, t_lens, banded, u_lo, g):
    """(lp_blank, lp_label, t_lens, u_lens) on the CPU from generator g:
    u_lens in [u_lo, U1), lp_label NEG at u >= u_len.  ``banded`` builds
    both log-probs with banded_to_full from a 16-wide band whose start
    climbs from 0 to u_len - 15 over the sample's t_len rows."""
    from rnnt_tpu_torch.ops.transducer_pruned import banded_to_full

    B, T, U1 = shape
    lpb = torch.randn(B, T, U1, generator=g) - 1.5
    lpl = torch.randn(B, T, U1, generator=g) - 1.5
    u_lens = torch.randint(min(u_lo, U1 - 1), U1, (B,), generator=g, dtype=torch.int32)
    t_rand = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    t_lens = t_rand if t_lens is None else torch.tensor(t_lens, dtype=torch.int32)
    if banded:
        S = 16
        t = torch.arange(T)[None, :]
        top = (u_lens.long() - S + 1).clamp(min=0)[:, None]
        bounds = (t * top // (t_lens.long()[:, None] - 1).clamp(min=1)).clamp(max=top)
        lpb = banded_to_full(lpb[:, :, :S].contiguous(), bounds, U1)
        lpl = banded_to_full(lpl[:, :, :S].contiguous(), bounds, U1)
    lpl = torch.where(torch.arange(U1)[None, None, :] < u_lens[:, None, None],
                      lpl, torch.full_like(lpl, NEG))
    return lpb, lpl, t_lens, u_lens


@pytest.mark.parametrize("shape,t_lens,banded", LATTICE_CASES, ids=LATTICE_IDS)
def test_k3_matches_plain(cuda, shape, t_lens, banded):
    g = torch.Generator().manual_seed(sum(shape))
    args = [x.to(cuda) for x in _lattice_inputs(shape, t_lens, banded, 1, g)]
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
    ((2, 19, 7, 64, 48), -1.0),       # one partial tile of V and of H
    ((1, 5, 13, 100, 1000), -1.0),    # H % 8 != 0: enc, pred, W zero-padded
    ((2, 9, 5, 36, 37), 0.05),        # H, V % 8 != 0, clamp on
    ((3, 33, 65, 1024, 1024), -1.0),  # the eval widths, ragged patches
    ((128, 16, 16, 1024, 1024), 0.01),  # the banded patches, clamp on
    ((2, 32, 17, 2048, 1024), -1.0),  # scaled_tp's joint width
    ((2, 32, 17, 2048, 1024), 0.01),
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


@pytest.mark.parametrize("shape", [
    (2, 19, 7, 64, 48),        # 24-wide slices: one partial V tile each
    (1, 5, 13, 100, 1000),     # 500-wide slices: V % 8 != 0, zero-padded
    (2, 32, 17, 2048, 1024),   # scaled_tp's joint on its 2 model ranks
])
def test_k1_k2_on_vocabulary_slices(cuda, shape):
    """K1 and K2 with v0 on two halves of V (the blank on the second, label
    0 on the first) against their plain versions, and merged (lse by
    logsumexp, blank and label summed; K2 from the merged lse, dW
    concatenated, denc summed) against the whole V."""
    B, T, U1, H, V = shape
    enc, pred, w, b, labels, blank = _joint_case(shape, cuda, sum(shape) + 1)
    labels[:, -1] = 0
    g = torch.Generator().manual_seed(2)
    gb, gl = (torch.randn(B, T, U1, generator=g).to(cuda) * 0.3 for _ in range(2))
    gs = -(gb + gl)
    whole = fused_joint_outputs(enc, pred, w, b, labels, blank)
    Vs = V // 2
    halves = [(enc, pred, w[:, v0:v0 + Vs].contiguous(), b[v0:v0 + Vs].contiguous(), labels,
               blank, v0) for v0 in (0, Vs)]
    outs = []
    for sl in halves:
        got = fused_joint_forward(*sl)
        for x, y in zip(got, fused_joint_outputs_plain(*sl)):
            _close(x, y, 2e-3, 1e-3)
        outs.append(got)
    assert torch.equal(outs[0][1], torch.zeros_like(outs[0][1]))  # the blank is on 1
    lse = torch.logsumexp(torch.stack([o[0] for o in outs]), dim=0)
    _close(lse, whole[0], 2e-3, 1e-3)
    for i in (1, 2):
        _close(outs[0][i] + outs[1][i], whole[i], 2e-3, 1e-3)
    grads = []
    for sl in halves:
        got = fused_joint_backward(*sl[:-1], lse, gb, gl, gs, -1.0, sl[-1])
        want = fused_joint_bwd_plain(*sl[:-1], lse, gb, gl, gs, -1.0, sl[-1])
        for name, x, y in zip(("denc", "dpred", "dW", "db"), got, want):
            assert _rel_l2(x, y) < 5e-3, (name, _rel_l2(x, y))
        grads.append(got)
    want = fused_joint_backward(enc, pred, w, b, labels, blank, whole[0], gb, gl, gs)
    assert _rel_l2(grads[0][0] + grads[1][0], want[0]) < 5e-3
    assert _rel_l2(torch.cat([grads[0][2], grads[1][2]], 1), want[2]) < 5e-3


def test_k1_k2_softmax_sums_to_one(cuda):
    """K2 fed K1's lse, with g_lse one-hot at a single row and the other
    cotangents zero: its db is that row's softmax, exp(logits - lse), so it
    sums to 1 only if K1 and K2 form the same h and logits.  8 rows spread
    over the row tiles, at the eval widths; within 1e-5."""
    args = _joint_case((2, 40, 33, 1024, 1024), cuda, 8)
    lse = fused_joint_outputs(*args)[0]
    zeros = torch.zeros_like(lse)
    n = lse.numel()
    for row in (0, 127, 128, 1000, 1331, 1792, n - 129, n - 1):
        g_lse = torch.zeros_like(lse)
        g_lse.view(-1)[row] = 1.0
        db = fused_joint_backward(*args, lse, zeros, zeros, g_lse)[3]
        assert abs(float(db.double().sum()) - 1.0) <= 1e-5, row


@pytest.mark.parametrize("shape,t_lens,banded", LATTICE_CASES, ids=LATTICE_IDS)
def test_k4_matches_plain(cuda, shape, t_lens, banded):
    B = shape[0]
    g = torch.Generator().manual_seed(sum(shape))
    args = [x.to(cuda) for x in _lattice_inputs(shape, t_lens, banded, 0, g)]
    cot = torch.randn(B, generator=g)
    nll, alpha = alpha_plain(*args)
    before = K4.launches
    got = beta_backward(*args[:2], alpha, *args[2:], nll, cot.to(cuda))
    torch.cuda.synchronize()
    assert K4.launches == before + 1
    want = beta_plain(*args[:2], alpha, *args[2:], nll, cot.to(cuda))
    for x, y in zip(got, want):
        _close(x, y, atol=1e-4, rtol=3e-3)


# The chains K6 and K7 are held to: (lattice, shards, t_lens, banded).  None
# takes t_lens that end inside a later shard, at the edge of a shard, before
# the last shard and at T (chain_lens).  Besides the first three, the
# wavefront's edges on a shard: U1 = 1, 1-row shards, shards of 33 and 257
# rows, U1 > rows, U1 = 1024 (two columns a lane), samples with no live row
# in later shards and with t_len - 1 at a shard's first row, and lattices
# from banded_to_full.
CHAIN_CASES = [
    ((4, 40, 17), 2, None, False), ((4, 150, 31), 3, None, False),
    ((4, 64, 300), 4, None, False), ((3, 9, 1), 3, None, False),
    ((4, 5, 9), 5, [1, 2, 5, 3], False), ((2, 66, 33), 2, None, False),
    ((2, 514, 65), 2, None, False), ((2, 40, 1024), 2, None, False),
    ((4, 48, 20), 3, [1, 16, 17, 48], False), ((4, 120, 65), 2, [120, 97, 64, 30], True),
    ((4, 504, 65), 2, None, True),
]
CHAIN_IDS = ["x".join(map(str, c[0])) + f"-{c[1]}" + ("-lens" if c[2] else "")
             + ("-banded" if c[3] else "") for c in CHAIN_CASES]


def chain_lens(T, n, B):
    rows = -(-T // n)
    return [rows + rows // 2, rows, rows // 2, T][:B]


@pytest.mark.parametrize("shape,n,t_lens,banded", CHAIN_CASES, ids=CHAIN_IDS)
def test_k6_k7_match_plain_on_every_shard(cuda, shape, n, t_lens, banded):
    """The chain of n shards at their t0, each shard's carry from the
    previous (K6) or next (K7) shard's kernel, against the plain stages on
    the same inputs; the shards' ll parts sum to the plain NLL."""
    B, T, U1 = shape
    g = torch.Generator().manual_seed(sum(shape))
    lens = chain_lens(T, n, B) if t_lens is None else t_lens
    lpb, lpl, t_lens, u_lens = [x.to(cuda) for x in _lattice_inputs(shape, lens, banded, 0, g)]
    rows = -(-T // n)
    blocks = [(s * rows, lpb[:, s * rows:(s + 1) * rows].contiguous(),
               lpl[:, s * rows:(s + 1) * rows].contiguous()) for s in range(n)]
    carry = torch.full((B, U1), NEG, device=cuda)
    alphas, ll = [], 0.0
    for t0, b, l in blocks:
        before = K6.launches
        got = alpha_chain_forward(b, l, t_lens, u_lens, t0, carry)
        torch.cuda.synchronize()
        assert K6.launches == before + 1
        want = alpha_chain_plain(b, l, t_lens, u_lens, t0, carry)
        for x, y in (got[0], want[0]), (got[2], want[2]):
            live = y > NEG / 2
            _close(x[live], y[live], atol=1e-3, rtol=1e-5)
            assert (x[~live] <= NEG / 2).all()
        _close(got[1], want[1], atol=1e-3, rtol=1e-5)
        alphas.append(got[0])
        ll, carry = ll + got[1], got[2]
    _close(-ll, alpha_plain(lpb, lpl, t_lens, u_lens)[0], atol=1e-3, rtol=1e-5)
    cot = torch.randn(B, generator=g).to(cuda)
    carry = torch.full((B, U1), NEG, device=cuda)
    for (t0, b, l), a in reversed(list(zip(blocks, alphas))):
        args = (b, l, a, t_lens, u_lens, ll, cot, t0, carry)
        before = K7.launches
        got = beta_chain_backward(*args)
        torch.cuda.synchronize()
        assert K7.launches == before + 1
        want = beta_chain_plain(*args)
        for x, y in zip(got[:2], want[:2]):
            _close(x, y, atol=1e-4, rtol=3e-3)
        live = want[2] > NEG / 2
        _close(got[2][live], want[2][live], atol=1e-4, rtol=3e-3)
        assert (got[2][~live] <= NEG / 2).all()
        carry = got[2]


@pytest.mark.parametrize("shape,t_lens,banded", LATTICE_CASES, ids=LATTICE_IDS)
def test_k6_k7_on_one_shard_are_k3_k4(cuda, shape, t_lens, banded):
    """One shard at t0 = 0 is the whole lattice, and K6/K7 run K3/K4's
    sweep: K6 with a carry_in that the seed overrides gives K3's alpha and
    negated NLL, and K7 with ll = -nll (its carry_in unread) K4's
    gradients, bit for bit."""
    B, _, U1 = shape
    g = torch.Generator().manual_seed(sum(shape))
    args = [x.to(cuda) for x in _lattice_inputs(shape, t_lens, banded, 0, g)]
    junk = torch.randn(B, U1, generator=g).to(cuda)
    cot = torch.randn(B, generator=g).to(cuda)
    nll, alpha = alpha_forward(*args)
    alphas, ll, _ = alpha_chain_forward(*args, 0, junk)
    torch.cuda.synchronize()
    assert torch.equal(alphas, alpha) and torch.equal(ll, -nll)
    want = beta_backward(*args[:2], alpha, *args[2:], nll, cot)
    got = beta_chain_backward(*args[:2], alpha, *args[2:], -nll, cot, 0, junk)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("shape", [
    (2, 19, 7, 64, 48),          # one partial V tile
    (2, 9, 5, 36, 37),           # H, V % 8 != 0
    (4, 201, 65, 640, 1025),     # parakeet_rnnt_0.6b's joint and a 16 s row
])
def test_k1_k2_relu_match_plain(cuda, shape):
    """K1 and K2 with act = relu against their plain versions."""
    B, T, U1, H, V = shape
    args = _joint_case(shape, cuda, sum(shape) + 3)
    got = fused_joint_forward(*args, act="relu")
    want = fused_joint_outputs_plain(*args, act="relu")
    for x, y in zip(got, want):
        _close(x, y, atol=2e-3, rtol=1e-3)
    g = torch.Generator().manual_seed(4)
    g_blank, g_label = (torch.randn(B, T, U1, generator=g).to(cuda) * 0.3 for _ in range(2))
    cot = (want[0], g_blank, g_label, -(g_blank + g_label))
    got = fused_joint_backward(*args, *cot, act="relu")
    want = fused_joint_bwd_plain(*args, *cot, act="relu")
    for name, x, y in zip(("denc", "dpred", "dW", "db"), got, want):
        assert _rel_l2(x, y) < 5e-3, (name, _rel_l2(x, y))


def test_relu_joint_loss_matches_chunked(cuda):
    """The exact loss of a ReLU joint (parakeet_rnnt_0.6b's widths: audio
    1024 and text 640 projected to 640, 1025 classes) through K1-K4 against
    the chunked path, loss and every gradient."""
    from rnnt_tpu_torch.models.joint import Joint, JointSpec
    from rnnt_tpu_torch.ops.transducer import transducer_loss
    from rnnt_tpu_torch.ops.transducer_pallas import transducer_loss_pallas

    B, T, U = 4, 60, 16
    g = torch.Generator().manual_seed(5)
    joint = Joint(JointSpec(1024, 640, 640, 1025, "relu"), g).to(cuda)
    audio = torch.randn(B, T, 1024, generator=g).to(torch.bfloat16).to(cuda)
    text = torch.randn(B, U + 1, 640, generator=g).to(torch.bfloat16).to(cuda)
    targets = torch.randint(0, 1024, (B, U), generator=g).to(cuda)
    t_lens = torch.tensor([60, 51, 40, 33], device=cuda)
    u_lens = torch.tensor([16, 12, 9, 1], device=cuda)
    results = []
    for fn, kw in ((transducer_loss_pallas, {}), (transducer_loss, {"chunk_size": 16})):
        a, t = audio.clone().requires_grad_(), text.clone().requires_grad_()
        loss = fn(joint, a, t, targets, t_lens, u_lens, 1024, **kw)
        params = [a, t] + list(joint.parameters())
        results.append((loss.detach(), torch.autograd.grad(loss, params)))
    (lk, gk), (lc, gc) = results
    assert abs(float(lk - lc)) <= 1e-4 * abs(float(lc)), (float(lk), float(lc))
    for x, y in zip(gk, gc):
        assert _rel_l2(x.float(), y.float()) < 2e-2


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
