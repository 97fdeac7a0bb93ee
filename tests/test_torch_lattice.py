"""The plain version of K3 (the alpha recursion) against rnnt_tpu's scan and
its Pallas alpha kernel (interpret mode, called directly as
tests/test_lattice_pallas.py does), fp32 on the CPU.

Tolerance rtol = atol = 1e-4: the row scans combine in different orders.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.ops.lattice_pallas import _alpha_unpadded  # noqa: E402
from rnnt_tpu.ops.transducer import lattice_log_probs as jax_lattice_log_probs  # noqa: E402
from rnnt_tpu.ops.transducer import transducer_alpha_loss  # noqa: E402
from rnnt_tpu_torch.ops import lattice_pallas as tlat  # noqa: E402
from rnnt_tpu_torch.ops.transducer import (  # noqa: E402
    NEG, lattice_log_probs, lattice_nll)

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(3, 40, 17), (2, 150, 31)]


def _case(B, T, U1, seed=0):
    rng = np.random.RandomState(seed)
    lpb = (rng.randn(B, T, U1) - 1.5).astype(np.float32)
    lpl = (rng.randn(B, T, U1) - 1.5).astype(np.float32)
    u_lens = rng.randint(1, U1, size=(B,)).astype(np.int32)
    t_lens = rng.randint(U1, T + 1, size=(B,)).astype(np.int32)
    u_mask = np.arange(U1)[None, :] < u_lens[:, None]
    lpl = np.where(u_mask[:, None, :], lpl, NEG).astype(np.float32)
    return lpb, lpl, t_lens, u_lens


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_lattice_log_probs_matches_jax():
    """Full-logits reduction: blank is the last class, the final column's
    label is a dummy 0, labels at u >= u_len are NEG."""
    rng = np.random.RandomState(3)
    B, T, U, V = 2, 7, 5, 11
    logits = rng.randn(B, T, U + 1, V).astype(np.float32) * 3
    targets = rng.randint(0, V - 1, size=(B, U)).astype(np.int32)
    u_lens = np.array([U, 2], np.int32)
    want = jax_lattice_log_probs(jnp.asarray(logits), jnp.asarray(targets),
                                 jnp.asarray(u_lens), V - 1)
    got = lattice_log_probs(*_torch(logits, targets, u_lens), V - 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert (got[1][1, :, 2:] == NEG).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_alpha_matches_jax_scan(shape):
    case = _case(*shape)
    want = np.asarray(jax.jit(transducer_alpha_loss)(*map(jnp.asarray, case)))
    got = tlat.transducer_alpha_loss_fast(*_torch(*case))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(lattice_nll(*_torch(*case)).numpy(), want, **TOL)
    assert tlat.K3.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_alpha_matches_pallas_kernel(shape):
    """NLL and alpha on reachable cells against the TPU kernel itself
    (``_alpha_unpadded`` is what ``transducer_alpha_loss_fast`` runs)."""
    case = _case(*shape, seed=1)
    want_nll, want_alpha = map(np.asarray,
                               _alpha_unpadded(*map(jnp.asarray, case)))
    nll, alpha = tlat.alpha_forward(*_torch(*case))
    np.testing.assert_allclose(nll.numpy(), want_nll, **TOL)
    reach = want_alpha > NEG / 2
    t_lens, u_lens = case[2], case[3]
    B, T, U1 = shape
    tt, uu = np.meshgrid(np.arange(T), np.arange(U1), indexing="ij")
    live = (tt[None] < t_lens[:, None, None]) & (uu[None] <= u_lens[:, None, None])
    assert reach[live].all()
    np.testing.assert_allclose(alpha.numpy()[live], want_alpha[live], **TOL)
    assert (alpha.numpy()[~reach] <= NEG / 2).all()
