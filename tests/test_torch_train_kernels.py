"""The plain versions of K4 (beta recursion) and K2 (fused joint backward),
and the autograd Functions over them, against rnnt_tpu's gradients, fp32
on the CPU.  The JAX Pallas kernels run in interpret mode, as
tests/test_lattice_pallas.py and tests/test_transducer_pallas.py run them.

Tolerance: gradients within rtol 1e-4 (atol 1e-6 for entries near zero),
the PARITY.md standard for loss and gradients.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.ops import transducer_pallas as jtp  # noqa: E402
from rnnt_tpu.ops.lattice_pallas import transducer_alpha_loss_fast as jax_fast  # noqa: E402
from rnnt_tpu.ops.transducer import transducer_alpha_loss as jax_scan  # noqa: E402
from rnnt_tpu.ops.transducer import transducer_loss_from_logits as jax_oracle  # noqa: E402
from rnnt_tpu_torch.ops import lattice_pallas as tlat  # noqa: E402
from rnnt_tpu_torch.ops import transducer_pallas as ttp  # noqa: E402
from rnnt_tpu_torch.ops.transducer import (  # noqa: E402
    NEG, clamp_grads, lattice_nll, transducer_loss_from_logits)

TOL = dict(rtol=1e-4, atol=1e-6)


def _lattice(B, T, U1, seed=0):
    """Lattice log-probs with t_len < T, a u_len of 0, B not a multiple of 8."""
    rng = np.random.RandomState(seed)
    lpb = (rng.randn(B, T, U1) - 1.5).astype(np.float32)
    lpl = (rng.randn(B, T, U1) - 1.5).astype(np.float32)
    u_lens = rng.randint(1, U1, size=(B,)).astype(np.int32)
    u_lens[1] = 0
    t_lens = rng.randint(U1, T + 1, size=(B,)).astype(np.int32)
    t_lens[0] = T - 3
    lpl = np.where(np.arange(U1)[None, None, :] < u_lens[:, None, None],
                   lpl, NEG).astype(np.float32)
    g = (rng.rand(B) + 0.5).astype(np.float32)
    return lpb, lpl, t_lens, u_lens, g


def _jax_grads(fn, lpb, lpl, t_lens, u_lens, g):
    def f(a, b):
        return jnp.sum(fn(a, b, jnp.asarray(t_lens), jnp.asarray(u_lens))
                       * jnp.asarray(g))
    return [np.asarray(x) for x in jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(lpb), jnp.asarray(lpl))]


def _torch_grads(lpb, lpl, t_lens, u_lens, g):
    a = torch.tensor(lpb, requires_grad=True)
    b = torch.tensor(lpl, requires_grad=True)
    nll = tlat.transducer_alpha_loss_fast(a, b, torch.from_numpy(t_lens),
                                          torch.from_numpy(u_lens))
    (nll * torch.from_numpy(g)).sum().backward()
    return nll.detach().numpy(), a.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("jax_fn", [jax_fast, jax_scan], ids=["pallas", "scan"])
def test_k4_autograd_matches_jax(jax_fn):
    """d(sum g * nll)/d(lp) through K3 + K4's plain versions against
    jax.grad of the Pallas fast path (interpret mode) and of the scan."""
    case = _lattice(3, 21, 6, seed=1)
    want = _jax_grads(jax_fn, *case)
    nll, *got = _torch_grads(*case)
    np.testing.assert_allclose(
        nll, np.asarray(jax_scan(*map(jnp.asarray, case[:4]))), rtol=1e-4)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, **TOL)
    assert tlat.K4.launches == 0  # CPU tensors never reach the kernel


def test_beta_plain_matches_pallas_beta_kernel():
    """beta_plain against the TPU K4 itself (``_beta_unpadded``, interpret
    mode) with a cotangent that is not all ones."""
    from rnnt_tpu.ops.lattice_pallas import _alpha_unpadded, _beta_unpadded

    lpb, lpl, t_lens, u_lens, g = _lattice(5, 18, 9, seed=2)
    j = [jnp.asarray(x) for x in (lpb, lpl, t_lens, u_lens)]
    losses, alphas = _alpha_unpadded(*j)
    want = _beta_unpadded(j[0], j[1], alphas, j[2], j[3], losses, jnp.asarray(g))
    t = [torch.from_numpy(x) for x in (lpb, lpl, t_lens, u_lens)]
    nll, alpha = tlat.alpha_forward(*t)
    got = tlat.beta_backward(t[0], t[1], alpha, t[2], t[3], nll,
                             torch.from_numpy(g))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_lattice_nll_matches_float64_autograd():
    """On the CPU, lattice_nll (the alpha forward, the beta pass as its
    backward, both in float64) equals torch autograd of the plain alpha
    recursion in float64, chip_smoke.py's lattice reference."""
    import chip_smoke

    case = _lattice(3, 12, 5, seed=3)
    t = [torch.tensor(x, requires_grad=i < 2) for i, x in enumerate(case[:4])]
    g = torch.from_numpy(case[4])
    a = lattice_nll(*t)
    b = chip_smoke.lattice_nll_reference(*t)
    ga = torch.autograd.grad((a * g).sum(), t[:2])
    gb = torch.autograd.grad((b * g).sum(), t[:2])
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-9)


# ------------------------------- K2 -------------------------------

def _joint(B=3, T=9, U1=5, H=32, V=16, seed=0):
    rng = np.random.RandomState(seed)
    enc = (rng.randn(B, T, H) * 0.5).astype(np.float32)
    pred = (rng.randn(B, U1, H) * 0.5).astype(np.float32)
    w = (rng.randn(H, V) / np.sqrt(H)).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V - 1, size=(B, U1)).astype(np.int32)
    cot = [(rng.randn(B, T, U1) * 0.3).astype(np.float32) for _ in range(3)]
    return enc, pred, w, b, labels, cot


def _jax_vjp(enc, pred, w, b, labels, cot, clamp):
    """VJP of the TPU fused joint (interpret mode) on its padded lattice."""
    B, T, H = enc.shape
    U1, V = pred.shape[1], w.shape[1]
    T_pad = -(-T // jtp.T_TILE) * jtp.T_TILE
    u_tile, U_pad = jtp._pick_u(U1)
    pad3 = lambda x, tp, up: np.pad(x, ((0, 0), (0, tp), (0, up)))  # noqa: E731
    lab_oh = jax.nn.one_hot(np.pad(labels, ((0, 0), (0, U_pad - U1))), V)
    blank_oh = jax.nn.one_hot(V - 1, V)

    def f(e, p, ww, bb):
        return jtp.fused_joint_outputs(e, p, ww, bb, lab_oh, blank_oh, u_tile,
                                       clamp)

    _, vjp = jax.vjp(f, jnp.asarray(pad3(enc, T_pad - T, 0)),
                     jnp.asarray(pad3(pred, U_pad - U1, 0)), jnp.asarray(w),
                     jnp.asarray(b))
    # Cotangents of (lse, blank, label); zero on the padding.
    gs = tuple(jnp.asarray(pad3(c, T_pad - T, U_pad - U1)) for c in cot)
    denc, dpred, dw, db = vjp(gs)
    return [np.asarray(denc)[:, :T], np.asarray(dpred)[:, :U1], np.asarray(dw),
            np.asarray(db)]


@pytest.mark.parametrize("shape", [
    (3, 9, 5, 32, 16),
    (1, 3, 5, 2048, 64),  # scaled_tp's joint width (hidden_features 2048)
    (2, 5, 4, 20, 37),    # H and V not multiples of 8
])
@pytest.mark.parametrize("clamp", [-1.0, 0.05])
def test_k2_plain_matches_jax_vjp(clamp, shape):
    """fused_joint_bwd_plain and the autograd Function against the VJP of
    the TPU fused joint (interpret mode), with and without the clamp; blank
    is the last class."""
    B, T, U1, H, V = shape
    enc, pred, w, b, labels, cot = _joint(B, T, U1, H, V, seed=1)
    want = _jax_vjp(enc, pred, w, b, labels, cot, clamp)
    t = [torch.tensor(x, requires_grad=True) for x in (enc, pred, w, b)]
    outs = ttp.fused_joint_outputs(*t, torch.from_numpy(labels), V - 1, clamp)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    for x, y in zip(t, want):
        np.testing.assert_allclose(x.grad.numpy(), y, **TOL)
    lse = outs[0].detach()
    direct = ttp.fused_joint_bwd_plain(
        *[x.detach() for x in t], torch.from_numpy(labels), V - 1, lse,
        torch.from_numpy(cot[1]), torch.from_numpy(cot[2]),
        torch.from_numpy(cot[0]), clamp)
    for x, y in zip(direct, want):
        np.testing.assert_allclose(x.numpy(), y, **TOL)
    assert ttp.K2.launches == 0


def test_k2_matches_autograd_of_plain_k1():
    """Without a clamp, K2's plain version is the gradient of K1's plain
    version as torch autograd takes it."""
    enc, pred, w, b, labels, cot = _joint(B=2, T=7, U1=4, H=24, V=12, seed=2)
    lab = torch.from_numpy(labels)
    grads = []
    for fn in (ttp.fused_joint_outputs, ttp.fused_joint_outputs_plain):
        t = [torch.tensor(x, requires_grad=True) for x in (enc, pred, w, b)]
        torch.autograd.backward(fn(*t, lab, 11), [torch.from_numpy(c) for c in cot])
        grads.append([x.grad.numpy() for x in t])
    for x, y in zip(*grads):
        np.testing.assert_allclose(x, y, **TOL)


def test_clamp_grads_and_oracle_match_jax():
    """clamp_grads clamps the cotangent only; the full-logits oracle with a
    clamp gives JAX's value and logits gradient."""
    rng = np.random.RandomState(4)
    B, T, U, V = 2, 6, 3, 9
    logits = (rng.randn(B, T, U + 1, V) * 2).astype(np.float32)
    targets = rng.randint(0, V - 1, size=(B, U)).astype(np.int32)
    t_lens = np.array([T, T - 2], np.int32)
    u_lens = np.array([U, 1], np.int32)
    x = torch.tensor(logits, requires_grad=True)
    assert torch.equal(clamp_grads(x, 0.1), x)
    jfn = lambda lg: jax_oracle(lg, jnp.asarray(targets), jnp.asarray(t_lens),  # noqa: E731
                                jnp.asarray(u_lens), V - 1, grad_clamp=0.02)
    want, want_g = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(logits))
    got = transducer_loss_from_logits(x, torch.from_numpy(targets),
                                      torch.from_numpy(t_lens),
                                      torch.from_numpy(u_lens), V - 1,
                                      grad_clamp=0.02)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **TOL)
    assert float(x.grad.abs().max()) <= 0.02 + 1e-9


def test_chip_smoke_reference_joint_is_k2_formula():
    """chip_smoke.py's gradient reference for the fused joint (plain PyTorch
    under autograd, rounded where K1 and K2 round) gives what the fused
    joint's autograd Function gives on the CPU, bf16 operands, so that on
    the card the two differ only by the kernels' own arithmetic."""
    import chip_smoke

    enc, pred, w, b, labels, cot = _joint(B=2, T=7, U1=4, H=24, V=12, seed=5)
    lab = torch.from_numpy(labels)
    grads, outs = [], []
    for fn in (ttp.fused_joint_outputs, chip_smoke.joint_outputs_reference):
        t = [torch.tensor(x, requires_grad=True) for x in (enc, pred, w)]
        t = [x.to(torch.bfloat16).detach().requires_grad_() for x in t]
        t.append(torch.tensor(b, requires_grad=True))
        o = fn(*t, lab, 11)
        torch.autograd.backward(o, [torch.from_numpy(c) for c in cot])
        outs.append([x.detach().numpy() for x in o])
        grads.append([x.grad.float().numpy() for x in t])
    for x, y in zip(*outs):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
    for x, y in zip(*grads):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
