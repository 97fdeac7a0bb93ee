"""rnnt_tpu_torch models against rnnt_tpu on narrow specs, fp32 on the CPU:
encoder (lookahead block, instance_affine and batch norm), conv predictor,
joint, and the from_jax / to_jax weight round trip.

Same ``rnnt_init`` weights (carried by compat/jax_params) and seeded numpy
inputs through both packages; tolerance rtol = atol = 1e-4 (float32 sums
over up to K*Cin terms, taken in different orders).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.models import encoder as jenc  # noqa: E402
from rnnt_tpu.models import joint as jjoint  # noqa: E402
from rnnt_tpu.models import predictor as jpred  # noqa: E402
from rnnt_tpu.models import rnnt as jrnnt  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import (  # noqa: E402
    flatten_tree, from_jax, load_jax_params, to_jax)
from rnnt_tpu_torch.models import encoder as tenc  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.models import predictor as tpred  # noqa: E402
from rnnt_tpu_torch.models import rnnt as trnnt  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GEN = torch.Generator().manual_seed(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _enc_specs(norm_type):
    blocks = [dict(kernel_size=5, in_channels=32, out_channels=32, dropout=0.1,
                   num_sub_blocks=2, norm_type=norm_type, additional_context=2),
              dict(kernel_size=7, in_channels=32, out_channels=48, dropout=0.1,
                   num_sub_blocks=3, norm_type=norm_type)]
    kw = dict(input_features=20, prologue_kernel_size=5, epilogue_features=40,
              epilogue_kernel_size=9, output_features=64, norm_type=norm_type)
    return (jenc.EncoderSpec(blocks=tuple(jenc.JasperBlockSpec(**b) for b in blocks), **kw),
            tenc.EncoderSpec(blocks=tuple(tenc.JasperBlockSpec(**b) for b in blocks), **kw))


def _randomize_norms(params, state, seed):
    """Non-trivial affine params and running stats (init is ones/zeros)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: a + rng.randn(*a.shape).astype(np.float32) * 0.1,
                          params)
    state = jax.tree.map(lambda a: np.abs(a + rng.randn(*a.shape).astype(np.float32) * 0.3),
                         state)
    return params, state


@pytest.mark.parametrize("norm_type", ["instance_affine", "batch"])
def test_encoder_matches_jax(norm_type):
    js, ts = _enc_specs(norm_type)
    params, state = _randomize_norms(
        *_np(jenc.encoder_init(jax.random.PRNGKey(1), js)), seed=1)
    x = np.random.RandomState(2).randn(2, 60, 20).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jenc.encoder_apply(p, s, x, js))(
        params, state, jnp.asarray(x))
    enc = load_jax_params(tenc.Encoder(ts, GEN), params, state)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    # Lookahead trims the output: T' is below the stride-2 length of 30.
    assert got.shape == want.shape == (2, tenc.encoder_out_len(60, ts), 64)
    assert got.shape[1] < 30
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lens = np.array([60, 33, 1], np.int32)
    np.testing.assert_array_equal(
        tenc.encoder_out_len(torch.from_numpy(lens), ts).numpy(),
        np.asarray(jenc.encoder_out_len(jnp.asarray(lens), js)))


def test_encoder_bf16_keeps_dtype_and_matches_jax():
    """bf16 activations with float32 weights: every conv, norm and 1x1 conv
    casts back to bf16 in both packages (float32 sums inside), so the
    outputs agree to bf16 resolution over a few layers."""
    js, ts = _enc_specs("instance_affine")
    params, state = _randomize_norms(
        *_np(jenc.encoder_init(jax.random.PRNGKey(8), js)), seed=8)
    x = np.random.RandomState(8).randn(2, 40, 20).astype(np.float32)
    want, _ = jenc.encoder_apply(params, state, jnp.asarray(x, jnp.bfloat16), js)
    enc = load_jax_params(tenc.Encoder(ts, GEN), params, state)
    with torch.no_grad():
        got = enc(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_flagship_lookahead_trim():
    """base_convjs at its 1024-frame bucket: the block-1 lookahead trims the
    encoder output to T' = 504, not 512, in both packages."""
    from rnnt_tpu.config import config as jconfig
    from rnnt_tpu_torch.config import config as tconfig

    path = tconfig.resolve_config("base_convjs")
    jspec = jconfig.build_model_spec(jconfig.load_config(path)).encoder
    tspec = tconfig.build_model_spec(tconfig.load_config(path)).encoder
    assert tenc.encoder_out_len(1024, tspec) == 504
    assert int(jenc.encoder_out_len(jnp.int32(1024), jspec)) == 504


def test_conv_predictor_matches_jax():
    kw = dict(num_symbols=30, output_dim=48, symbol_embedding_dim=32)
    params = _np(jpred.conv_predictor_init(jax.random.PRNGKey(3),
                                           jpred.ConvPredictorSpec(**kw)))
    tokens = np.random.RandomState(3).randint(0, 30, size=(2, 11)).astype(np.int32)
    want = jax.jit(lambda p, t: jpred.conv_predictor_apply(
        p, t, jpred.ConvPredictorSpec(**kw)))(params, jnp.asarray(tokens))
    pred = load_jax_params(tpred.ConvPredictor(tpred.ConvPredictorSpec(**kw), GEN),
                           params)
    with torch.no_grad():
        got = pred(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("proj", [False, True])
def test_joint_matches_jax(proj):
    kw = dict(audio_features=24 if proj else -1, text_features=20 if proj else -1,
              hidden_features=32, num_classes=40)
    params = _np(jjoint.joint_init(jax.random.PRNGKey(4), jjoint.JointSpec(**kw),
                                   simple=proj))
    joint = load_jax_params(tjoint.Joint(tjoint.JointSpec(**kw), GEN, simple=proj),
                            params)
    rng = np.random.RandomState(4)
    a = rng.randn(2, 5, 24 if proj else 32).astype(np.float32)
    t = rng.randn(2, 3, 20 if proj else 32).astype(np.float32)
    with torch.no_grad():
        got = tjoint.joint_apply(joint, torch.from_numpy(a), torch.from_numpy(t))
        got_w = tjoint.joint_window(joint, torch.from_numpy(a),
                                    torch.from_numpy(t[:, 0]))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jjoint.joint_apply(params, a, t)), **TOL)
    np.testing.assert_allclose(
        got_w.numpy(), np.asarray(jjoint.joint_window(params, a, t[:, 0])), **TOL)


def _tiny_rnnt_specs(loss_impl):
    js, ts = _enc_specs("batch")
    pk = dict(num_symbols=40, output_dim=64, symbol_embedding_dim=32)
    jk = dict(audio_features=-1, text_features=-1, hidden_features=64,
              num_classes=40)
    return (jrnnt.RNNTSpec(js, jpred.ConvPredictorSpec(**pk), jjoint.JointSpec(**jk),
                           loss_impl=loss_impl),
            trnnt.RNNTSpec(ts, tpred.ConvPredictorSpec(**pk), tjoint.JointSpec(**jk),
                           loss_impl=loss_impl))


@pytest.mark.parametrize("loss_impl", ["auto", "pruned"])
def test_from_jax_to_jax_round_trip(loss_impl):
    """Every leaf survives JAX -> port -> JAX bit for bit, the structure
    (empty norm dicts, simple heads when present) included."""
    jspec, tspec = _tiny_rnnt_specs(loss_impl)
    params, state = _randomize_norms(
        *_np(jrnnt.rnnt_init(jax.random.PRNGKey(5), jspec)), seed=5)
    model = from_jax(params, state, tspec)
    assert hasattr(model.joint, "simple") == (loss_impl == "pruned")
    p2, s2 = to_jax(model)
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(p2) + jax.tree.leaves(s2),
                    jax.tree.leaves(params) + jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(v.size for v in flatten_tree(params).values())


def test_port_init_runs_through_jax():
    """The port's own seeded init, written out through to_jax, drives the
    JAX encoder to the port's output."""
    jspec, tspec = _tiny_rnnt_specs("auto")
    model = trnnt.rnnt_init(tspec, seed=7)
    params, state = to_jax(model)
    x = np.random.RandomState(7).randn(1, 40, 20).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jenc.encoder_apply(p, s, x, jspec.encoder))(
        params["encoder"], state["encoder"], jnp.asarray(x))
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
