"""Streaming inference of rnnt_tpu_torch against rnnt_tpu on the CPU, with
the same weights (compat/jax_params.from_jax) and inputs (numpy seeds):
fp32 within 1e-5 of each tensor's scale (its largest magnitude, at least
1: a chunk of three encoder frames through an instance norm amplifies
summation-order differences, 2.3e-5 in a carry of magnitude 4.2), tokens
exact.

* ``FeatureStreamer``: each feed's frames, for feeds of 3200, 1000 and 17
  samples;
* ``causal_conv_streaming``: outputs and carries over a sequence of chunk
  lengths, odd ones at stride 2, at dilation 2 and with lookahead;
* ``Encoder.streaming`` chunk by chunk, with batch norm and with
  instance_affine (chunk-local statistics, as in JAX);
* ``greedy_decode_incremental`` across three chunks with the carry;
* ``StreamingSession`` against JAX's on a small fullcausal spec and a
  narrow base_convjs-shaped instance_affine spec with lookahead;
* with batch norm the port's streamed tokens and encoder frames equal its
  offline ones;
* the port's pool equals its single sessions: paces, late arrival, slot
  reuse.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rnnt_tpu.decode import greedy as jgreedy  # noqa: E402
from rnnt_tpu.decode.streaming import StreamingSession as JStreamingSession  # noqa: E402
from rnnt_tpu.models import encoder as jenc  # noqa: E402
from rnnt_tpu.models import joint as jjoint  # noqa: E402
from rnnt_tpu.models import predictor as jpred  # noqa: E402
from rnnt_tpu.models import rnnt as jrnnt  # noqa: E402
from rnnt_tpu.ops import causal_conv as jconv  # noqa: E402
from rnnt_tpu.ops import stft as jstft  # noqa: E402
from rnnt_tpu_torch.compat.jax_params import from_jax, load_jax_params  # noqa: E402
from rnnt_tpu_torch.decode import greedy as tgreedy  # noqa: E402
from rnnt_tpu_torch.decode.streaming import (  # noqa: E402
    StreamingSession, StreamingSessionPool)
from rnnt_tpu_torch.models import encoder as tenc  # noqa: E402
from rnnt_tpu_torch.models import joint as tjoint  # noqa: E402
from rnnt_tpu_torch.models import predictor as tpred  # noqa: E402
from rnnt_tpu_torch.models import rnnt as trnnt  # noqa: E402
from rnnt_tpu_torch.ops import causal_conv as tconv  # noqa: E402
from rnnt_tpu_torch.ops import stft as tstft  # noqa: E402

GEN = torch.Generator().manual_seed(0)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    if want.size:
        err, scale = np.abs(got - want).max(), max(1.0, float(np.abs(want).max()))
        assert err <= 1e-5 * scale, (err, scale)


# Encoders: the fullcausal spec of tests/test_streaming_session.py, and a
# narrow base_convjs (instance_affine, lookahead 2 in the first block).
ENCODERS = {
    "fullcausal": dict(
        enc=dict(input_features=201, norm_type="batch", prologue_kernel_size=11,
                 prologue_stride=2, epilogue_features=32, epilogue_kernel_size=9,
                 epilogue_dilation=2, output_features=48),
        blocks=[dict(kernel_size=5, in_channels=32, out_channels=32, dropout=0.0,
                     num_sub_blocks=2, norm_type="batch")]),
    "convjs_narrow": dict(
        enc=dict(input_features=201, norm_type="instance_affine",
                 prologue_kernel_size=11, prologue_stride=2, epilogue_features=40,
                 epilogue_kernel_size=29, epilogue_dilation=2, output_features=48),
        blocks=[dict(kernel_size=11, in_channels=24, out_channels=24, dropout=0.0,
                     num_sub_blocks=2, norm_type="instance_affine",
                     additional_context=2),
                dict(kernel_size=13, in_channels=24, out_channels=32, dropout=0.0,
                     num_sub_blocks=2, norm_type="instance_affine")]),
}
PRED = dict(num_symbols=64, output_dim=48, symbol_embedding_dim=24, dropout=0.0)
JOINT = dict(audio_features=-1, text_features=-1, hidden_features=48, num_classes=64)


def _spec(pkg_enc, pkg_pred, pkg_joint, pkg_rnnt, name):
    e = ENCODERS[name]
    enc = pkg_enc.EncoderSpec(
        blocks=tuple(pkg_enc.JasperBlockSpec(**b) for b in e["blocks"]), **e["enc"])
    return pkg_rnnt.RNNTSpec(encoder=enc, predictor=pkg_pred.ConvPredictorSpec(**PRED),
                             joint=pkg_joint.JointSpec(**JOINT))


def _model(name, seed, blank_bias=0.6):
    """(JAX spec, JAX params, JAX state, port spec, port model): JAX init,
    batch-norm statistics drawn in [0.5, 1.5] and the blank bias set
    (tests/test_streaming_session.py).  The untrained models emit nothing
    or at the per-frame cap; 0.6 to 1.0 makes them emit a few tokens."""
    jspec = _spec(jenc, jpred, jjoint, jrnnt, name)
    tspec = _spec(tenc, tpred, tjoint, trnnt, name)
    params, state = jax.tree.map(np.array, jrnnt.rnnt_init(jax.random.PRNGKey(seed), jspec))
    rng = np.random.RandomState(seed + 5)
    state = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    params["joint"]["out"]["b"][jspec.joint.blank_idx] = blank_bias
    return jspec, params, state, tspec, from_jax(params, state, tspec)


def _wave(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32) * 0.2
            + np.sin(2 * np.pi * 500 * np.arange(n) / 16000).astype(np.float32) * 0.3)


@pytest.mark.parametrize("feed", [3200, 1000, 17])
def test_feature_streamer_matches_jax(feed):
    wave = _wave(feed, 7000)
    js = jstft.FeatureStreamer(jstft.FeaturizerSpec())
    ts = tstft.FeatureStreamer(tstft.FeaturizerSpec())
    assert ts.spec.overlap == js.spec.overlap == 240
    got_frames = []
    for i in range(0, len(wave), feed):
        want, got = js.process(wave[i:i + feed]), ts.process(wave[i:i + feed])
        assert (want is None) == (got is None), i
        if got is not None:
            assert got.device.type == "cpu" and got.dtype == torch.float32
            _close(got, np.asarray(want))
            got_frames.append(_np(got))
    # The streamed frames are the whole utterance's.
    full = tstft.make_featurizer(tstft.FeaturizerSpec())(torch.from_numpy(wave))
    _close(np.concatenate(got_frames), _np(full)[:sum(map(len, got_frames))])
    with pytest.raises(ValueError, match="not streamable"):
        tstft.FeatureStreamer(tstft.FeaturizerSpec(center=True))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=11, stride=2),
    dict(kernel_size=5, dilation=2),
    dict(kernel_size=11, additional_context=2),
], ids=["stride2", "dilation2", "lookahead2"])
def test_causal_conv_streaming_matches_jax(kw):
    jspec, tspec = jconv.ConvSpec(6, 10, **kw), tconv.ConvSpec(6, 10, **kw)
    assert tconv.causal_conv_state_len(tspec) == jconv.causal_conv_state_len(jspec)
    params = jax.tree.map(np.array, jconv.causal_conv_init(jax.random.PRNGKey(1), jspec))
    conv = load_jax_params(tconv.CausalConv(tspec, GEN), params)
    rng = np.random.RandomState(2)
    jstate = jconv.streaming_init_state(2, jspec)
    tstate = tconv.streaming_init_state(2, tspec)
    for n in (7, 1, 4, 3, 0, 10, 5):
        x = rng.randn(2, n, 6).astype(np.float32)
        jy, jstate = jconv.causal_conv_streaming(params, jnp.asarray(x), jstate, jspec)
        ty, tstate = conv.streaming(torch.from_numpy(x), tstate)
        assert ty.shape == jy.shape and tstate.shape == jstate.shape, n
        _close(ty, np.asarray(jy))
        _close(tstate, np.asarray(jstate))


@pytest.mark.parametrize("name", ["fullcausal", "convjs_narrow"])
def test_encoder_streaming_matches_jax(name):
    jspec, params, state, tspec, model = _model(name, 0)
    rng = np.random.RandomState(3)
    jstates = jenc.encoder_streaming_init_state(2, jspec.encoder)
    tstates = tenc.encoder_streaming_init_state(2, tspec.encoder)
    assert [s.shape for s in tstates] == [s.shape for s in jstates]
    japply = jax.jit(lambda x, s: jenc.encoder_streaming_apply(
        params["encoder"], state["encoder"], x, s, jspec.encoder))
    n_out = 0
    with torch.inference_mode():
        for n in (20, 7, 1, 13, 20):
            x = rng.randn(2, n, 201).astype(np.float32)
            jy, jstates = japply(jnp.asarray(x), jstates)
            ty, tstates = model.encoder.streaming(torch.from_numpy(x), tstates)
            assert ty.shape == jy.shape, n
            n_out += ty.shape[1]
            _close(ty, np.asarray(jy))
            for t, j in zip(tstates, jstates):
                _close(t, np.asarray(j))
    assert n_out > 0


@pytest.mark.parametrize("blank_bias", [2.0, 0.0])
def test_greedy_decode_incremental_matches_jax(blank_bias):
    jspec, params, _, tspec, model = _model("fullcausal", 1, blank_bias)
    dec = jax.tree.map(jnp.asarray, {"predictor": params["predictor"],
                                     "joint": params["joint"]})
    rng = np.random.RandomState(4)
    jcarry = jgreedy.decode_init_carry(dec, jspec.predictor, jspec.joint, 3)
    tcarry = tgreedy.decode_init_carry(model.predictor, tspec.predictor, tspec.joint, 3)
    _close(tcarry[0], np.asarray(jcarry[0]))
    jdecode = jax.jit(lambda a, tl, c: jgreedy.greedy_decode_incremental(
        dec, a, tl, jspec.predictor, jspec.joint, max_tokens=24, carry=c))
    emitted = 0
    with torch.inference_mode():
        for T in (9, 4, 12):
            audio = rng.randn(3, T, 48).astype(np.float32)
            t_lens = np.array([T, T - 1, T], np.int32)
            jtok, jn, jcarry = jdecode(jnp.asarray(audio), jnp.asarray(t_lens), jcarry)
            ttok, tn, tcarry = tgreedy.greedy_decode_incremental(
                model.predictor, model.joint, torch.from_numpy(audio),
                torch.from_numpy(t_lens), tspec.predictor, tspec.joint,
                max_tokens=24, carry=tcarry)
            np.testing.assert_array_equal(_np(tn), np.asarray(jn))
            np.testing.assert_array_equal(_np(ttok), np.asarray(jtok))
            _close(tcarry[0], np.asarray(jcarry[0]))
            np.testing.assert_array_equal(_np(tcarry[1][0]), np.asarray(jcarry[1][0]))
            np.testing.assert_array_equal(_np(tcarry[1][1]), np.asarray(jcarry[1][1]))
            emitted += int(_np(tn).sum())
    assert emitted > 0


@pytest.mark.parametrize("name,seed,blank_bias,feeds", [
    ("fullcausal", 0, 0.6, (3200,)),
    ("convjs_narrow", 1, 1.0, (3200, 1700, 150, 4100)),
])
def test_streaming_session_matches_jax(name, seed, blank_bias, feeds):
    jspec, params, state, _, model = _model(name, seed, blank_bias)
    fspec = jstft.FeaturizerSpec()
    wave = _wave(0, 16000)
    js = JStreamingSession(params, state, jspec, fspec)
    ts = StreamingSession(model, tstft.FeaturizerSpec())
    i, k = 0, 0
    while i < len(wave):
        n = feeds[k % len(feeds)]
        assert ts.feed(wave[i:i + n]) == js.feed(wave[i:i + n]), i
        i, k = i + n, k + 1
    assert ts.encoder_frames_emitted == js.encoder_frames_emitted > 0
    assert ts.tokens() == js.tokens()
    assert len(ts.tokens()) > 0


def test_streamed_equals_offline_with_batch_norm():
    _, _, _, tspec, model = _model("fullcausal", 0)
    fspec = tstft.FeaturizerSpec()
    wave = _wave(0, 16000)
    session = StreamingSession(model, fspec)
    streamer = tstft.FeatureStreamer(fspec)
    states = tenc.encoder_streaming_init_state(1, tspec.encoder)
    frames = []
    with torch.inference_mode():
        for i in range(0, len(wave), 3200):
            session.feed(wave[i:i + 3200])
            feats = streamer.process(wave[i:i + 3200])
            if feats is not None:
                y, states = model.encoder.streaming(feats[None], states)
                frames.append(y)
        n = session.encoder_frames_emitted
        enc = model.encoder(tstft.make_featurizer(fspec)(torch.from_numpy(wave))[None])
        streamed = torch.cat(frames, dim=1)
        assert streamed.shape[1] == n > 0 and enc.shape[1] >= n
        _close(streamed, _np(enc[:, :n]))
        tokens, counts = tgreedy.greedy_decode(
            model.predictor, model.joint, enc[:, :n], torch.tensor([n]),
            tspec.predictor, tspec.joint, max_tokens=64)
    offline = [int(t) for t in tokens[0, : int(counts[0])]]
    assert offline == session.tokens() and len(offline) > 0


def test_pool_matches_single_sessions():
    """Streams multiplexed on the pool (different paces, a late arrival,
    padded sub-batches, lane gather and scatter) emit exactly what
    dedicated sessions emit; a reused slot starts clean."""
    _, _, _, _, model = _model("fullcausal", 0)
    fspec = tstft.FeaturizerSpec()
    rng = np.random.RandomState(3)
    waves = [rng.randn(12800).astype(np.float32) * 0.3 for _ in range(3)]

    expected = []
    for w in waves:
        s = StreamingSession(model, fspec)
        for i in range(0, len(w), 3200):
            s.feed(w[i:i + 3200])
        expected.append(s.tokens())
    assert any(expected)

    pool = StreamingSessionPool(model, fspec, slots=4, chunk_seconds=0.2)
    slots = [pool.open() for _ in range(3)]
    # Stream 0 feeds 200 ms at a time, stream 1 400 ms, stream 2 starts late.
    pos, step_sizes = [0, 0, 0], [3200, 6400, 3200]
    for tick in range(10):
        for j in range(3):
            if j == 2 and tick < 2:
                continue
            lo, hi = pos[j], min(pos[j] + step_sizes[j], len(waves[j]))
            if lo < hi:
                pool.feed(slots[j], waves[j][lo:hi])
                pos[j] = hi
        pool.pump()
    for j in range(3):
        assert pool.tokens(slots[j]) == expected[j], j

    st = pool.stats()
    assert st["device_steps"] > 0
    assert st["active_slots"] == 3 and st["slots"] == 4
    assert st["max_batched_lanes"] >= 2 and st["mean_batched_lanes"] >= 1.0
    assert st["tokens_emitted"] == sum(len(e) for e in expected)

    # Exhaust the free slots so close/open recycles stream 0's lane; replay
    # stream 1's audio there and get stream 1's tokens.
    pool.open()
    with pytest.raises(RuntimeError, match="slots in use"):
        pool.open()
    pool.close(slots[0])
    s_new = pool.open()
    assert s_new == slots[0]
    for i in range(0, len(waves[1]), 3200):
        pool.feed(s_new, waves[1][i:i + 3200])
        pool.pump()
    assert pool.tokens(s_new) == expected[1]
