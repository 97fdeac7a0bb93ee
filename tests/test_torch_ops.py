"""rnnt_tpu_torch ops against rnnt_tpu: norms, causal conv, conv length
arithmetic, featurizer and wire-audio decoding, fp32 on the CPU.

Same seeded numpy inputs through both packages; tolerance rtol = atol =
1e-5 (float32 sums taken in different orders).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.ops import causal_conv as jconv  # noqa: E402
from rnnt_tpu.ops import norm as jnorm  # noqa: E402
from rnnt_tpu.ops import stft as jstft  # noqa: E402
from rnnt_tpu.train import step as jstep  # noqa: E402
from rnnt_tpu.data.dataset import mulaw_encode  # noqa: E402
from rnnt_tpu_torch.ops import causal_conv as tconv  # noqa: E402
from rnnt_tpu_torch.ops import norm as tnorm  # noqa: E402
from rnnt_tpu_torch.ops import stft as tstft  # noqa: E402
from rnnt_tpu_torch.train import step as tstep  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("norm_type", ["batch", "instance", "instance_affine"])
def test_norm_matches_jax(norm_type):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 17, 8) * 2 + 1).astype(np.float32)
    scale = rng.randn(8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    mean = rng.randn(8).astype(np.float32)
    var = rng.rand(8).astype(np.float32) + 0.5
    params = {} if norm_type == "instance" else {"scale": scale, "bias": bias}
    state = {"mean": mean, "var": var} if norm_type == "batch" else {}
    want, _ = jnorm.norm_apply(params, state, jnp.asarray(x), norm_type,
                               training=False)
    got = tnorm.norm_apply(_t(x), norm_type, _t(scale), _t(bias), _t(mean),
                           _t(var))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_instance_norm_counts_padding():
    """Statistics span the whole padded time axis, zeros included."""
    x = np.zeros((1, 8, 2), np.float32)
    x[0, :4] = np.arange(8, dtype=np.float32).reshape(4, 2)
    want, _ = jnorm.norm_apply({}, {}, jnp.asarray(x), "instance", False)
    got = tnorm.norm_apply(_t(x), "instance")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(got[0, 4:].abs().sum())) > 0  # padding is normalized too


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 16).astype(np.float32) * 3
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    want = jnorm.layer_norm_apply({"scale": scale, "bias": bias}, jnp.asarray(x))
    got = tnorm.layer_norm_apply(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,s,d,ctx", [(3, 1, 1, 0), (11, 2, 1, 0),
                                       (5, 1, 2, 0), (11, 1, 1, 2),
                                       (7, 2, 2, 3)])
def test_causal_conv_matches_jax(k, s, d, ctx):
    spec_j = jconv.ConvSpec(6, 10, k, s, d, additional_context=ctx)
    spec_t = tconv.ConvSpec(6, 10, k, s, d, additional_context=ctx)
    params = jax.tree.map(np.asarray,
                          jconv.causal_conv_init(jax.random.PRNGKey(k), spec_j))
    x = np.random.RandomState(k).randn(2, 37, 6).astype(np.float32)
    want = jconv.causal_conv_apply(params, jnp.asarray(x), spec_j)
    got = tconv.causal_conv_apply(_t(params["w"]), _t(params["b"]), _t(x), spec_t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv1x1_matches_jax():
    params = jax.tree.map(np.asarray,
                          jconv.conv1x1_init(jax.random.PRNGKey(3), 12, 7))
    x = np.random.RandomState(3).randn(2, 9, 12).astype(np.float32)
    want = jconv.conv1x1_apply(params, jnp.asarray(x))
    got = tconv.conv1x1_apply(_t(params["w"]), _t(params["b"]), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,s,d,ctx", [(11, 2, 1, 0), (29, 1, 2, 0),
                                       (11, 1, 1, 2)])
def test_causal_conv_out_len_matches_jax(k, s, d, ctx):
    spec_j = jconv.ConvSpec(1, 1, k, s, d, additional_context=ctx)
    spec_t = tconv.ConvSpec(1, 1, k, s, d, additional_context=ctx)
    lens = np.array([0, 1, 5, 100, 1023, 1024], np.int32)
    want = np.asarray(jconv.causal_conv_out_len(jnp.asarray(lens), spec_j))
    got = tconv.causal_conv_out_len(_t(lens), spec_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert [tconv.causal_conv_out_len(int(n), spec_t) for n in lens] == list(want)


@pytest.mark.parametrize("log_mode,num_mels,mean", [
    ("piecewise", 0, 15.0), ("old_piecewise", 0, 15.0), ("log", 0, -3.0),
    ("old_piecewise", 16, 15.0)])
def test_featurizer_matches_jax(log_mode, num_mels, mean):
    kw = dict(log_mode=log_mode, num_mels=num_mels, mean=mean, invstddev=0.25)
    rng = np.random.RandomState(4)
    wav = (rng.randn(2, 4000) * 0.1).astype(np.float32)
    want = jstft.make_featurizer(jstft.FeaturizerSpec(**kw))(jnp.asarray(wav))
    got = tstft.make_featurizer(tstft.FeaturizerSpec(**kw))(_t(wav))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_featurizer_per_channel_stats():
    mean = tuple(np.linspace(10, 20, 201).tolist())
    inv = tuple(np.linspace(0.1, 0.3, 201).tolist())
    wav = (np.random.RandomState(5).randn(1, 2000) * 0.1).astype(np.float32)
    want = jstft.make_featurizer(jstft.FeaturizerSpec(mean=mean, invstddev=inv))(
        jnp.asarray(wav))
    got = tstft.make_featurizer(tstft.FeaturizerSpec(mean=mean, invstddev=inv))(
        _t(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("wire", ["int16", "mulaw", "float32"])
def test_decode_wire_audio_matches_jax(wire):
    audio = (np.random.RandomState(6).randn(2, 500) * 0.3).astype(np.float32)
    if wire == "int16":
        audio = np.clip(np.rint(audio * 16384.0), -32768, 32767).astype(np.int16)
    elif wire == "mulaw":
        audio = mulaw_encode(audio)
    want = jstep.decode_wire_audio(jnp.asarray(audio))
    got = tstep.decode_wire_audio(_t(audio))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_feature_lens_from_samples_matches_jax():
    lens = np.array([0, 100, 399, 400, 401, 16000, 160000], np.int32)
    for center in (False, True):
        js = jstft.FeaturizerSpec(center=center)
        ts = tstft.FeaturizerSpec(center=center)
        want = jstep.feature_lens_from_samples(jnp.asarray(lens), js)
        got = tstep.feature_lens_from_samples(_t(lens), ts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
