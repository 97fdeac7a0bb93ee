"""The rewrites of a causal conv in ``ops/causal_conv.py`` ``conv1d_valid``.

Outside float32, a stride-1 conv with dilation d > 1 runs as one
undilated conv over the input's d phases, and one of more than
``MAX_TAPS`` taps as a conv of fewer taps over its tap groups stacked in
the channels.  Both are held in float64 against a direct
``F.conv1d(dilation=d)``: the output and the gradients of x, w and b in
batch mode (``conv1d_valid``, ``causal_conv_apply``), and the output
streamed over uneven chunks (``causal_conv_streaming``); ``FOLDS`` counts
the folded calls, one per encoder pass, none in float32.
"""

import dataclasses
import itertools

import pytest
import torch
import torch.nn.functional as F

from rnnt_tpu_torch.config.config import build_model_spec, load_config, resolve_config
from rnnt_tpu_torch.models.encoder import Encoder, encoder_streaming_init_state
from rnnt_tpu_torch.ops import causal_conv as cc

TOL = dict(rtol=1e-11, atol=1e-11)  # float64; the fold sums in another order
CIN, COUT = 5, 6


def _direct(w, b, x, left_pad: int, d: int):
    """The unfolded conv: a zero left pad, then one dilated ``F.conv1d``."""
    x = F.pad(x, (0, 0, left_pad, 0))
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, dilation=d).transpose(1, 2)


def _tensor(*shape, seed: int):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64, requires_grad=True)


# K > MAX_TAPS (15) also stacks the taps: 16 in 2 groups of 8, 25 and 29 in
# 2 groups of 13 and 15 with a zero tap.
CASES = [c for c in itertools.product(("conv1d_valid", "causal_conv_apply"),
                                      (1, 2, 3), (1, 5, 16, 29), ("even", "odd"), (0, 2))
         # conv1d_valid takes no lookahead; it cannot exceed the causal pad
         if not (c[0] == "conv1d_valid" and c[4]) and c[4] <= (c[2] - 1) * c[1]]


@pytest.mark.parametrize("fn,d,k,parity,ctx", CASES)
def test_fold_matches_dilated_conv(fn, d, k, parity, ctx):
    spec = cc.ConvSpec(CIN, COUT, k, 1, d, additional_context=ctx).validate()
    w, b = _tensor(k, CIN, COUT, seed=k), _tensor(COUT, seed=d)
    T = 4 * d + 12 + (d * (k - 1) if fn == "conv1d_valid" else 0)  # several frames a phase
    T += T % 2 != (parity == "odd")
    if fn == "conv1d_valid":  # unpadded: the input covers the taps
        ours = lambda: cc.conv1d_valid(w, b, x, 1, d)  # noqa: E731
        left_pad, out_len = 0, T - d * (k - 1)
    else:
        ours = lambda: cc.causal_conv_apply(w, b, x, spec)  # noqa: E731
        left_pad, out_len = spec.left_padding, T - ctx
    x = _tensor(3, T, CIN, seed=T)
    g = torch.randn(3, out_len, COUT, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    got, want = ours(), _direct(w, b, x, left_pad, d)
    assert got.shape == want.shape == (3, out_len, COUT)
    torch.testing.assert_close(got, want, **TOL)
    for name, a, e in zip(("x", "w", "b"), torch.autograd.grad(got, (x, w, b), g),
                          torch.autograd.grad(want, (x, w, b), g)):
        torch.testing.assert_close(a, e, **TOL, msg=lambda m: f"grad of {name}: {m}")


@pytest.mark.parametrize("d,k,chunks", list(itertools.product(
    (1, 2, 3), (5, 25), ((1, 3, 7, 16), (16, 7, 3, 1)))))
def test_streaming_over_uneven_chunks_matches_batch(d, k, chunks):
    spec = cc.ConvSpec(CIN, COUT, k, 1, d).validate()
    with torch.no_grad():
        w, b = _tensor(k, CIN, COUT, seed=k), _tensor(COUT, seed=d)
        x = _tensor(2, 3 * sum(chunks), CIN, seed=d + k)
        state, ys, t = cc.streaming_init_state(2, spec, torch.float64), [], 0
        for n in chunks * 3:
            y, state = cc.causal_conv_streaming(w, b, x[:, t:t + n], state, spec)
            assert y.shape == (2, n, COUT) and state.shape == (2, spec.padding, CIN)
            ys.append(y)
            t += n
        streamed = torch.cat(ys, dim=1)
        torch.testing.assert_close(streamed, cc.causal_conv_apply(w, b, x, spec), **TOL)
        torch.testing.assert_close(streamed, _direct(w, b, x, spec.left_padding, d), **TOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stride,d,k,folds", [(1, 1, 5, 0), (1, 2, 5, 1), (1, 3, 5, 1),
                                              (1, 1, 29, 0), (2, 1, 5, 0), (2, 2, 5, 0)])
def test_folds_counts_dilated_stride_1_calls(stride, d, k, folds, dtype):
    """A float32 conv runs the one call; a strided dilated conv (no config
    has one) too."""
    w, b = _tensor(k, CIN, COUT, seed=0), _tensor(COUT, seed=1)
    x = _tensor(2, 70, CIN, seed=2).to(dtype)
    before = cc.FOLDS
    y = cc.conv1d_valid(w, b, x, stride, d)
    assert y.dtype == dtype
    assert cc.FOLDS - before == (folds if dtype != torch.float32 else 0)
    torch.testing.assert_close(
        y, F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0).to(dtype), b.to(dtype),
                    stride=stride, dilation=d).transpose(1, 2),
        **(TOL if dtype == torch.float64 else dict(rtol=1e-5, atol=1e-5)))


@pytest.mark.parametrize("epilogue_dilation,folds", [(2, 1), (1, 0)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["train", "streaming"])
def test_folds_once_per_encoder_pass(mode, dtype, epilogue_dilation, folds):
    """tiny_conv's encoder has one dilated conv, the epilogue (2 in every
    config): a pass outside float32 folds it once, batch or streamed;
    without the dilation, or in float32, nothing folds."""
    tiny = build_model_spec(load_config(resolve_config("tiny_conv"))).encoder
    spec = dataclasses.replace(tiny, epilogue_dilation=epilogue_dilation)
    enc = Encoder(spec, torch.Generator().manual_seed(0)).to(dtype)
    x = torch.randn(2, 64, spec.input_features, generator=torch.Generator().manual_seed(1),
                    dtype=dtype)
    before = cc.FOLDS
    if mode == "train":
        y = enc(x, training=True)
        y.sum().backward()
    else:
        with torch.inference_mode():
            y, _ = enc.eval().streaming(x, encoder_streaming_init_state(2, spec, dtype))
    assert y.shape[1] > 0
    assert cc.FOLDS - before == (folds if dtype != torch.float32 else 0)
