"""The port's pruned RNN-T loss (ops/transducer_pruned.py) against
rnnt_tpu's, fp32 on the CPU: the simple joint, the occupancy, the band
starts (equal ints), the band expansion, the warmup objective and the
pruned loss, values and gradients.  The port's banded joint is the fused
path (the kernels' plain versions on the CPU); JAX's CPU path is chunked,
which equals its fused path when the band is a multiple of 8.

Tolerance: values within rtol 1e-4 (atol 1e-5 for entries near zero), the
PARITY.md standard.  Gradients of whole losses within 1e-4 relative L2
error per tensor: an entry such as a bias gradient sums ~10^3 lattice terms
of O(1) that cancel, so float32 summation order alone moves it by ~1e-4 of
its own size.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.models.joint import JointSpec, joint_init  # noqa: E402
from rnnt_tpu.ops import transducer_pruned as jpr  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import load_jax_params  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.ops import transducer_pruned as tpr  # noqa: E402
from rnnt_tpu_torch.ops.transducer import transducer_loss  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_L2 = 1e-4


def _assert_rel_l2(got, want):
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= GRAD_REL_L2, err


def _case(B=2, T=37, U=12, H=32, V=16, seed=0):
    kw = dict(audio_features=-1, text_features=-1, hidden_features=H,
              num_classes=V)
    params = jax.tree.map(np.asarray, joint_init(jax.random.PRNGKey(seed),
                                                 JointSpec(**kw), simple=True))
    rng = np.random.RandomState(seed)
    audio = (rng.randn(B, T, H) * 0.5).astype(np.float32)
    text = (rng.randn(B, U + 1, H) * 0.5).astype(np.float32)
    targets = rng.randint(0, V - 1, size=(B, U)).astype(np.int32)
    t_lens = np.array([T, T - 6][:B], np.int32)
    u_lens = np.array([U, U - 4][:B], np.int32)
    joint = load_jax_params(tjoint.Joint(tjoint.JointSpec(**kw),
                                         torch.Generator().manual_seed(0),
                                         simple=True), params)
    return params, joint, audio, text, targets, t_lens, u_lens


def _grad_arrays(joint, audio, text):
    return ([p.grad.numpy() for _, p in sorted(joint.named_parameters())]
            + [audio.grad.numpy(), text.grad.numpy()])


def _jax_grad_arrays(gp, ga, gt):
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]}
    return [flat[k] for k in sorted(flat)] + [np.asarray(ga), np.asarray(gt)]


def _run_both(jax_loss, torch_loss, case):
    """Value and gradients (joint params, audio, text) of a mean loss."""
    params, joint, audio, text, targets, t_lens, u_lens = case
    rest = [jnp.asarray(x) for x in (targets, t_lens, u_lens)]
    want, (gp, ga, gt) = jax.jit(jax.value_and_grad(
        lambda p, a, x: jax_loss(p, a, x, *rest), argnums=(0, 1, 2)))(
            params, jnp.asarray(audio), jnp.asarray(text))
    a = torch.tensor(audio, requires_grad=True)
    x = torch.tensor(text, requires_grad=True)
    got = torch_loss(joint, a, x, *[torch.from_numpy(v) for v in (targets, t_lens, u_lens)])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for g, w in zip(_grad_arrays(joint, a, x), _jax_grad_arrays(gp, ga, gt)):
        _assert_rel_l2(g, w)
    return float(got.detach())


def test_simple_joint_log_probs_match_jax():
    params, joint, audio, text, targets, t_lens, u_lens = _case(seed=1)
    rng = np.random.RandomState(5)
    cot = [rng.randn(2, 37, 13).astype(np.float32) for _ in range(2)]

    def jf(sp, a, x):
        lpb, lpl = jpr.simple_joint_log_probs(sp, a, x, jnp.asarray(targets),
                                              jnp.asarray(u_lens), 15)
        return jnp.sum(lpb * cot[0]) + jnp.sum(jnp.where(lpl > -1e29, lpl, 0) * cot[1]), (lpb, lpl)

    (_, want), (gp, ga, gt) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        params["simple"], jnp.asarray(audio), jnp.asarray(text))
    a = torch.tensor(audio, requires_grad=True)
    x = torch.tensor(text, requires_grad=True)
    lpb, lpl = tpr.simple_joint_log_probs(joint.simple, a, x, torch.from_numpy(targets),
                                          torch.from_numpy(u_lens), 15)
    (torch.sum(lpb * torch.from_numpy(cot[0]))
     + torch.sum(torch.where(lpl > -1e29, lpl, 0) * torch.from_numpy(cot[1]))).backward()
    for g, w in zip((lpb, lpl), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    got_g = [p.grad.numpy() for _, p in sorted(joint.simple.named_parameters())]
    for g, w in zip(got_g + [a.grad.numpy(), x.grad.numpy()],
                    _jax_grad_arrays(gp, ga, gt)):
        np.testing.assert_allclose(g, w, **TOL)


def test_nll_with_occupancy_matches_jax():
    rng = np.random.RandomState(2)
    B, T, U1 = 3, 20, 7
    lpb = (rng.randn(B, T, U1) - 1.5).astype(np.float32)
    lpl = (rng.randn(B, T, U1) - 1.5).astype(np.float32)
    t_lens = np.array([20, 15, 9], np.int32)
    u_lens = np.array([6, 0, 3], np.int32)
    lpl = np.where(np.arange(U1)[None, None] < u_lens[:, None, None], lpl,
                   -1e30).astype(np.float32)
    g = np.array([1.0, 0.5, 2.0], np.float32)

    def jf(a, b):
        losses, gamma = jpr.nll_with_occupancy(a, b, jnp.asarray(t_lens),
                                               jnp.asarray(u_lens))
        return jnp.sum(losses * g), (losses, gamma)

    (_, (wl, wg)), wgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(lpb), jnp.asarray(lpl))
    a = torch.tensor(lpb, requires_grad=True)
    b = torch.tensor(lpl, requires_grad=True)
    losses, gamma = tpr.nll_with_occupancy(a, b, torch.from_numpy(t_lens),
                                           torch.from_numpy(u_lens))
    assert not gamma.requires_grad
    (losses * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(wg), **TOL)
    for x, w in zip((a.grad, b.grad), wgrads):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("band", [4, 8, 16])
def test_prune_bounds_equal_jax(band):
    rng = np.random.RandomState(band)
    B, n_t, U1 = 4, 9, 21
    gamma = rng.rand(B, n_t, U1).astype(np.float32) ** 4
    t_lens = np.array([9, 7, 3, 1], np.int32)
    u_lens = np.array([20, 12, 15, 0], np.int32)
    want = np.asarray(jpr.prune_bounds(jnp.asarray(gamma), jnp.asarray(t_lens),
                                       jnp.asarray(u_lens), band))
    got = tpr.prune_bounds(torch.from_numpy(gamma), torch.from_numpy(t_lens),
                           torch.from_numpy(u_lens), band)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_banded_to_full_matches_jax():
    rng = np.random.RandomState(3)
    B, T, S, U1 = 2, 11, 4, 9
    lp = rng.randn(B, T, S).astype(np.float32)
    bounds = np.sort(rng.randint(0, U1 - S + 1, size=(B, T)), axis=1).astype(np.int32)
    cot = rng.randn(B, T, U1).astype(np.float32)
    f = lambda x: jnp.sum(jpr.banded_to_full(x, jnp.asarray(bounds), U1) * cot)  # noqa: E731
    want = np.asarray(jpr.banded_to_full(jnp.asarray(lp), jnp.asarray(bounds), U1))
    want_g = np.asarray(jax.grad(f)(jnp.asarray(lp)))
    x = torch.tensor(lp, requires_grad=True)
    got = tpr.banded_to_full(x, torch.from_numpy(bounds), U1)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(x.grad.numpy(), want_g, **TOL)


def test_pruned_warmup_loss_matches_jax():
    _run_both(lambda p, a, x, *r: jpr.pruned_warmup_loss(p, a, x, *r, 15, chunk_size=8),
              lambda j, a, x, *r: tpr.pruned_warmup_loss(j, a, x, *r, 15, chunk_size=8),
              _case(seed=2))


@pytest.mark.parametrize("clamp", [-1.0, 0.5])
def test_pruned_transducer_loss_matches_jax(clamp):
    """Band 8 (JAX's chunked and fused paths agree there), 37 frames: three
    band tiles, the last one partial."""
    kw = dict(band=8, simple_scale=0.5, pruned_scale=1.0, grad_clamp=clamp)
    loss = _run_both(lambda p, a, x, *r: jpr.pruned_transducer_loss(p, a, x, *r, 15, **kw),
                     lambda j, a, x, *r: tpr.pruned_transducer_loss(j, a, x, *r, 15, **kw),
                     _case(seed=3))
    assert np.isfinite(loss) and loss < 1e5


def test_full_band_equals_exact_loss():
    """A band covering the whole lattice gives the exact NLL."""
    params, joint, audio, text, targets, t_lens, u_lens = _case(U=5, seed=4)
    args = (joint, torch.from_numpy(audio), torch.from_numpy(text),
            torch.from_numpy(targets), torch.from_numpy(t_lens),
            torch.from_numpy(u_lens), 15)
    with torch.no_grad():
        pruned = tpr.pruned_transducer_loss(*args, band=8, simple_scale=0.0,
                                            reduction="none")
        exact = transducer_loss(*args, chunk_size=8, reduction="none")
    np.testing.assert_allclose(pruned.numpy(), exact.numpy(), **TOL)
