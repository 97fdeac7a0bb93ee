"""The multi-tensor norm and AdamW kernels (``csrc/sq_norms.cu``,
``csrc/adamw_update.cu``) on the card against their plain PyTorch versions
(``ops/multi_tensor.py``).  Skipped without CUDA; on a card:

    python -m pytest tests/test_torch_cuda_multi_tensor.py -m cuda --noconftest

Tolerances.  ``sq_norms`` sums each block's squares in a fixed tree and the
blocks' partials in a fixed order, where the plain loop sums a leaf at a
time: float32 sums in another order, within 1e-5 relative; two runs of the
kernel are bit-equal (no atomics).  ``adamw_update`` does the plain loop's
float32 operations in its order, but nvcc contracts the moment updates, the
decay and the step into FMAs (one rounding where PyTorch's separate kernels
round twice): p, mu and nu within 1e-5 relative plus 1e-6 of the tensor's
largest magnitude (a moment whose two terms nearly cancel keeps an absolute
error of one rounding of the terms), over 3 steps.
"""

import math

import pytest
import torch

from rnnt_tpu_torch.ops import multi_tensor as mt
from rnnt_tpu_torch.parallel import mesh as tmesh
from rnnt_tpu_torch.train.optim import AdamWClip

pytestmark = pytest.mark.cuda

RTOL, ATOL_SCALE, NORM_RTOL = 1e-5, 1e-6, 1e-5
SIZES = {
    "ragged": [3, 7, 4097, 16385, 8191, 2, 8193, 16383, 1, 0, 100003],
    "over_a_launch": [1 + (i * 37) % 300 for i in range(1500)],
    "large": [4 * 1024 * 1024 + 3, 1024 * 1024, 640 * 1025, 5],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available")
    return torch.device("cuda")


def _close(name, got, want):
    assert torch.isfinite(got).all(), name
    atol = ATOL_SCALE * float(want.abs().max()) if want.numel() else 0.0
    err = (got - want).abs()
    assert (err <= atol + RTOL * want.abs()).all(), (name, float(err.max()))


def _leaves(sizes, device, seed, offset=0, scale=1.0):
    """Random float32 leaves; with ``offset`` > 0 each is a view into a
    flat tensor at that many elements past 16-byte alignment (the kernels'
    scalar path)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for n in sizes:
        flat = torch.randn(n + offset, generator=g, device=device) * scale
        out.append(flat[offset:])
    return out


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", list(SIZES))
def test_sq_norms_matches_plain_and_repeats_bit_equal(cuda, case, offset):
    sizes = SIZES[case]
    leaves = _leaves(sizes, cuda, 0, offset)
    groups = [(i * 7) % 5 for i in range(len(sizes))]
    mt.SQ_NORMS.launches = 0
    got = mt.sq_norms(leaves, groups, 6)
    again = mt.sq_norms(leaves, groups, 6)
    torch.cuda.synchronize()
    want = mt.sq_norms_plain(leaves, groups, 6)
    assert got.shape == (6,) and float(got[5]) == 0.0
    torch.testing.assert_close(got, want, rtol=NORM_RTOL, atol=0.0)
    assert torch.equal(got, again)
    per_call = math.ceil(sum(n > 0 for n in sizes) / mt.NORM_CAP)
    assert mt.SQ_NORMS.launches == 2 * per_call


def test_squared_norms_sharded_layout(cuda):
    """``squared_norms`` with sharded leaves (no mesh: no all-reduce) on the
    card against the CPU's per-leaf sums."""
    names = [f"{s}.l{i}" for i, s in enumerate(["encoder"] * 5 + ["predictor"] * 3
                                                + ["joint"] * 4)]
    leaves = _leaves([(i * 997) % 5000 + 1 for i in range(len(names))], cuda, 1)
    layout = {n: 0 for i, n in enumerate(names) if i % 3 == 0}
    got = tmesh.squared_norms(dict(zip(names, leaves)), layout, None)
    want = tmesh.squared_norms({n: t.cpu() for n, t in zip(names, leaves)}, layout, None)
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=NORM_RTOL, atol=0.0)


def _hyper(step, max_norm):
    return mt.AdamWHyper(lr=1e-3 * (step + 1), bc1=1 - 0.9 ** (step + 1),
                         bc2=1 - 0.999 ** (step + 1), b1=0.9, b2=0.999, eps=1e-8,
                         weight_decay=0.01, max_norm=max_norm)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("max_norm", [1e-2, 1e9], ids=["clip", "no-clip"])
@pytest.mark.parametrize("case", ["ragged", "over_a_launch"])
def test_adamw_update_matches_plain(cuda, case, max_norm, offset):
    sizes = SIZES[case]
    p = _leaves(sizes, cuda, 2, offset)
    m, v = _leaves(sizes, cuda, 3, offset, 0.01), _leaves(sizes, cuda, 4, offset, 0.01)
    v = [x.abs_() for x in v]
    ref = [[x.clone() for x in t] for t in (p, m, v)]
    mt.ADAMW_UPDATE.launches = 0
    for step in range(3):
        grads = _leaves(sizes, cuda, 10 + step, offset)
        g_norm = mt.global_norm(grads)
        assert (float(g_norm) >= max_norm) == (max_norm < 1)
        mt.adamw_update(p, grads, m, v, g_norm, _hyper(step, max_norm))
        mt.adamw_update_plain(ref[0], grads, ref[1], ref[2], g_norm, _hyper(step, max_norm))
    torch.cuda.synchronize()
    for what, got, want in zip("p mu nu".split(), (p, m, v), ref):
        for i, (a, b) in enumerate(zip(got, want)):
            _close(f"{what}[{i}]", a, b)
    assert mt.ADAMW_UPDATE.launches == 3 * math.ceil(sum(n > 0 for n in sizes) / mt.UPDATE_CAP)


def _opt(k):
    return AdamWClip(lambda s: 1e-3 * (s + 1), b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.01, max_norm=0.5, accumulate_steps=k)


@pytest.mark.parametrize("k", [1, 2], ids=["single", "accumulate2"])
def test_optimizer_on_card_matches_cpu_and_takes_restored_moments(cuda, k):
    """``AdamWClip`` on the card (norm and update kernels) against the same
    calls on the CPU (plain loops), 4 calls; after the 2nd the state's mu
    and nu are replaced by new tensors (a restored checkpoint), which the
    next update must write and the old ones not see."""
    sizes = SIZES["ragged"]
    names = [f"encoder.l{i}" for i in range(len(sizes))]
    params = dict(zip(names, _leaves(sizes, cuda, 5)))
    cpu_params = {n: t.cpu().clone() for n, t in params.items()}
    opt = _opt(k)
    state, cpu_state = opt.init(params), opt.init(cpu_params)
    old = None
    for call in range(4):
        grads = dict(zip(names, _leaves(sizes, cuda, 20 + call)))
        state = opt.update(params, grads, state)
        cpu_state = opt.update(cpu_params, {n: g.cpu() for n, g in grads.items()}, cpu_state)
        if call == 1:
            old = {n: (t.clone(), t) for n, t in state.mu.items()}
            state.mu = {n: t.clone() for n, t in state.mu.items()}
            state.nu = {n: t.clone() for n, t in state.nu.items()}
    torch.cuda.synchronize()
    assert state.count == cpu_state.count == 4 // k
    for n in names:
        _close(f"p {n}", params[n].cpu(), cpu_params[n])
        _close(f"mu {n}", state.mu[n].cpu(), cpu_state.mu[n])
        _close(f"nu {n}", state.nu[n].cpu(), cpu_state.nu[n])
        before, held = old[n]
        assert torch.equal(before, held)


def test_update_refuses_what_it_cannot_take(cuda):
    p = [torch.zeros(8, device=cuda)]
    h = _hyper(0, 1.0)
    with pytest.raises(ValueError, match="g_norm"):
        mt.adamw_update(p, p, p, p, torch.zeros((), device="cpu"), h)
    with pytest.raises(ValueError, match="contiguous"):
        q = [torch.zeros(4, 4, device=cuda).t()]
        mt.adamw_update(q, q, q, q, torch.zeros((), device=cuda), h)
    with pytest.raises(ValueError, match="float32"):
        mt.sq_norms([torch.zeros(8, device=cuda, dtype=torch.bfloat16)], [0], 1)
