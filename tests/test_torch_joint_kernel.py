"""The plain version of K1 (fused joint forward) and the port's exact NLL
against rnnt_tpu's Pallas fused joint (interpret mode) and chunked loss,
fp32 on the CPU.  Non-aligned T and U exercise the TPU path's padding; the
U1 > 128 case its multi-tile grid.

Tolerance rtol = atol = 1e-4, as tests/test_transducer_pallas.py uses.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.models.joint import JointSpec, joint_init  # noqa: E402
from rnnt_tpu.ops import transducer_pallas as jtp  # noqa: E402
from rnnt_tpu.ops.transducer import transducer_loss as jax_chunked  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import load_jax_params  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.ops import transducer_pallas as ttp  # noqa: E402
from rnnt_tpu_torch.ops.transducer import transducer_loss  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _case(B, T, U, H, V, seed, proj=False):
    kw = dict(audio_features=H if proj else -1, text_features=H if proj else -1,
              hidden_features=H, num_classes=V)
    params = jax.tree.map(np.asarray, joint_init(jax.random.PRNGKey(seed),
                                                 JointSpec(**kw)))
    rng = np.random.RandomState(seed)
    audio = (rng.randn(B, T, H) * 0.5).astype(np.float32)
    text = (rng.randn(B, U + 1, H) * 0.5).astype(np.float32)
    targets = rng.randint(0, V - 1, size=(B, U)).astype(np.int32)
    t_lens = np.array([T, T - 5][:B], np.int32)
    u_lens = np.array([U, U - 3][:B], np.int32)
    joint = load_jax_params(
        tjoint.Joint(tjoint.JointSpec(**kw), torch.Generator().manual_seed(0)),
        params)
    return params, joint, audio, text, targets, t_lens, u_lens


@pytest.mark.parametrize("shape", [(2, 19, 6, 64, 128), (2, 12, 140, 32, 48)])
def test_plain_fused_outputs_match_pallas_kernel(shape):
    """lse / blank / label against the TPU kernel's outputs on its padded
    lattice, sliced back."""
    B, T, U, H, V = shape
    params, _, audio, text, targets, _, _ = _case(B, T, U, H, V, seed=1)
    U1 = U + 1
    T_pad = -(-T // jtp.T_TILE) * jtp.T_TILE
    u_tile, U_pad = jtp._pick_u(U1)
    labels = np.concatenate([targets, np.zeros((B, 1), np.int32)], axis=1)
    labels_pad = np.pad(labels, ((0, 0), (0, U_pad - U1)))
    want = jtp.fused_joint_outputs(
        jnp.asarray(np.pad(audio, ((0, 0), (0, T_pad - T), (0, 0)))),
        jnp.asarray(np.pad(text, ((0, 0), (0, U_pad - U1), (0, 0)))),
        jnp.asarray(params["out"]["w"]), jnp.asarray(params["out"]["b"]),
        jax.nn.one_hot(labels_pad, V), jax.nn.one_hot(V - 1, V), u_tile)
    got = ttp.fused_joint_outputs(
        torch.from_numpy(audio), torch.from_numpy(text),
        torch.from_numpy(np.array(params["out"]["w"])),
        torch.from_numpy(np.array(params["out"]["b"])),
        torch.from_numpy(labels), V - 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :T, :U1], **TOL)
    assert ttp.K1.launches == 0  # CPU tensors never reach the kernel


def _torch_args(joint, audio, text, targets, t_lens, u_lens, V):
    return (joint, torch.from_numpy(audio), torch.from_numpy(text),
            torch.from_numpy(targets), torch.from_numpy(t_lens),
            torch.from_numpy(u_lens), V - 1)


def test_exact_nll_matches_jax_pallas():
    """The port's K1-path NLL against the JAX Pallas loss (non-aligned T
    and U, side projections on)."""
    B, T, U, H, V = 2, 19, 6, 64, 128
    params, joint, audio, text, targets, t_lens, u_lens = _case(
        B, T, U, H, V, seed=2, proj=True)
    want = np.asarray(jtp.transducer_loss_pallas(
        params, jnp.asarray(audio), jnp.asarray(text), jnp.asarray(targets),
        jnp.asarray(t_lens), jnp.asarray(u_lens), V - 1, reduction="none"))
    targs = _torch_args(joint, audio, text, targets, t_lens, u_lens, V)
    with torch.no_grad():
        got = ttp.transducer_loss_pallas(*targs, reduction="none")
        got_mean = ttp.transducer_loss_pallas(*targs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(got_mean), float(want.mean()), **TOL)


@pytest.mark.parametrize("shape", [(2, 19, 6, 64, 128), (2, 12, 140, 32, 48)])
def test_exact_nll_matches_jax_chunked(shape):
    """Both port paths (K1 plain + alpha, chunked + alpha) against the JAX
    chunked loss, U1 > 128 included."""
    B, T, U, H, V = shape
    params, joint, audio, text, targets, t_lens, u_lens = _case(
        B, T, U, H, V, seed=3)
    jfn = jax.jit(lambda *a: jax_chunked(*a, V - 1, chunk_size=8,
                                         reduction="none"))
    want = np.asarray(jfn(params, jnp.asarray(audio), jnp.asarray(text),
                          jnp.asarray(targets), jnp.asarray(t_lens),
                          jnp.asarray(u_lens)))
    targs = _torch_args(joint, audio, text, targets, t_lens, u_lens, V)
    with torch.no_grad():
        got_fused = ttp.transducer_loss_pallas(*targs, reduction="none")
        got_chunked = transducer_loss(*targs, chunk_size=8, reduction="none")
    np.testing.assert_allclose(got_fused.numpy(), want, **TOL)
    np.testing.assert_allclose(got_chunked.numpy(), want, **TOL)
