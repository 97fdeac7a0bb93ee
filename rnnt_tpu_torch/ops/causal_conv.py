"""Causal 1-D convolution and the 1x1 (per-frame linear) convolution.

Port of ``rnnt_tpu/ops/causal_conv.py``, batch mode and streaming: a
streaming step concatenates the carry state ((k-1)d - s + 1 frames at
start) with the chunk, convolves it unpadded and keeps the frames it did
not consume as the next carry, whose length changes when a chunk's
length is not a multiple of the stride.  Public functions
keep the JAX layout — activations (B, T, C), conv weights (K, Cin, Cout),
linear weights (in, out) — and transpose internally to torch's (B, C, T)
and (Cout, Cin, K).  A left pad of ``(k-1)d - s + 1 - additional_context``
zeros makes output t see inputs <= t plus a bounded lookahead.

Dtypes follow the JAX package: a conv casts its weights to the input
dtype and its output back to it; ``linear_apply`` (conv1x1) accumulates in
float32, adds the bias in float32, then casts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from rnnt_tpu_torch.utils import uniform


class ConvSpec(NamedTuple):
    """Static description of one causal conv layer."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    # Bounded future lookahead, subtracted from the left pad.
    additional_context: int = 0

    @property
    def padding(self) -> int:
        return (self.kernel_size - 1) * self.dilation - self.stride + 1

    @property
    def left_padding(self) -> int:
        return self.padding - self.additional_context

    def validate(self) -> "ConvSpec":
        if self.additional_context < 0:
            raise ValueError("additional_context must be non-negative")
        if self.additional_context > self.padding:
            raise ValueError("additional_context can't exceed the causal padding")
        return self


def causal_conv_state_len(spec: ConvSpec) -> int:
    """Length of the streaming carry state: (k-1)*d - s + 1 frames."""
    return spec.padding


def causal_conv_out_len(in_len, spec: ConvSpec):
    """Output length for an input length; ints or integer tensors (floor
    division, as in the JAX package)."""
    numer = in_len + spec.left_padding - spec.dilation * (spec.kernel_size - 1) - 1
    return numer // spec.stride + 1


FOLDS = 0  # dilated convs run by phases (``conv1d_valid``); callers diff it
# The most taps a conv runs with as it is.  Without benchmark mode, cuDNN 9.2
# on an H100 serves all three passes of the encoders' 11- and 13-tap convs on
# tensor-core engines, and runs the weight gradient of every conv of 17, 25 or
# 29 taps at 384-1024 channels (and the input gradient at 384-512) on legacy
# engines at 9-23 TFLOP/s; stacked to 9, 13 and 15 taps they return to
# tensor-core ones.  14-16 taps are unmeasured (PERF.md).
MAX_TAPS = 15


def conv1d_valid(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Unpadded conv: x (B, T, Cin), w (K, Cin, Cout) -> (B, T', Cout).

    Outside float32, two rewrites keep a stride-1 conv on cuDNN's
    tensor-core engines, each with the same products, summed in another
    order: a conv with dilation d > 1 runs folded into its d phases
    (``_conv1d_phases``), an undilated one of K > ``MAX_TAPS`` taps on its
    taps in g = ceil(K / MAX_TAPS) groups stacked in the channels
    (``_stack_taps``).  Stacking also rounds x's gradient once more: autograd
    sums the g groups' gradients, each already rounded to x's dtype, where
    the one call rounds their sum once.

    The dtype stands in for the input's size, which is what decides
    whether the rewrites pay: training and ``evaluate`` / greedy / beam
    search run whole utterances in bf16 and take them; the streaming pool
    (``cli.serve``) and exported bundles run short chunks in float32, and
    the predictor's convs run float32, and all of these keep the one call.
    At a chunk's size the rewrites' copies and launches cost more than
    they save, in bf16 too, and with TF32 off cuDNN has no tensor-core
    engine for float32 anyway (PERF.md).  The dtype is read where a size
    could not be: under ``torch.export`` the time axis is symbolic."""
    rewrite = stride == 1 and x.dtype != torch.float32
    if rewrite and dilation > 1:
        return _conv1d_phases(w, b, x, dilation)
    if rewrite and w.shape[0] > MAX_TAPS:
        w, x = _stack_taps(w, x, -(-w.shape[0] // MAX_TAPS))
    else:
        w = w.permute(2, 1, 0).to(x.dtype)
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, dilation=dilation)
    y = y + b.to(y.dtype)[:, None]
    return y.transpose(1, 2).to(x.dtype)


def _conv1d_phases(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                   d: int) -> torch.Tensor:
    """Output frame d*m + r reads only input frames of residue r mod d: x,
    zero-padded on the right to a multiple of d, its phases moved into the
    batch, goes through one undilated conv with the same K taps, and the
    phases are interleaved back."""
    global FOLDS
    FOLDS += 1
    B, L, C = x.shape
    out_len = L - d * (w.shape[0] - 1)
    m = (L + d - 1) // d  # frames a phase
    if m * d != L:
        x = F.pad(x, (0, 0, 0, m * d - L))
    x = x.reshape(B, m, d, C).transpose(1, 2).reshape(B * d, m, C)
    y = conv1d_valid(w, b, x)  # (B * d, m - K + 1, Cout)
    y = y.reshape(B, d, -1, y.shape[-1]).transpose(1, 2).reshape(B, -1, y.shape[-1])
    return y[:, :out_len]


def _stack_taps(w: torch.Tensor, x: torch.Tensor, g: int):
    """An undilated stride-1 conv of K taps as one of k = ceil(K / g) taps
    over g * Cin channels: channel q*Cin + c of the input is x[t + q*k, c],
    and tap r of the weight there is w[q*k + r, c] (zero past K).  Returns
    the weight as torch's (Cout, g * Cin, k), copied once (with the cast to
    x's dtype) into the (Cout, k, g * Cin) memory order that cuDNN reads
    with the channels-last input, and the stacked input."""
    K, C, Cout = w.shape
    k = -(-K // g)
    n = x.shape[1] - K + 1  # output frames
    if g * k > K:
        w = F.pad(w, (0, 0, 0, 0, 0, g * k - K))
        x = F.pad(x, (0, 0, 0, g * k - K))
    ws = torch.empty((Cout, k, g, C), dtype=x.dtype, device=w.device)
    ws.copy_(w.reshape(g, k, C, Cout).permute(3, 1, 0, 2))
    x = torch.cat([x[:, q * k:q * k + n + k - 1] for q in range(g)], dim=2)
    return ws.view(Cout, k, g * C).transpose(1, 2), x


def causal_conv_apply(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      spec: ConvSpec) -> torch.Tensor:
    """Batch-mode forward, zero left pad only.  x: (B, T, Cin)."""
    x = F.pad(x, (0, 0, spec.left_padding, 0))
    return conv1d_valid(w, b, x, spec.stride, spec.dilation)


def causal_conv_streaming(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                          state: torch.Tensor, spec: ConvSpec):
    """Streaming forward: x (B, chunk, Cin), state (B, S, Cin) ->
    (y (B, T', Cout), new_state).  A step too short for one output frame
    returns no frame and keeps everything as the carry."""
    full = torch.cat([state, x], dim=1)
    y_len = (full.shape[1] - spec.dilation * (spec.kernel_size - 1) - 1) // spec.stride + 1
    if y_len <= 0:
        return full.new_zeros((full.shape[0], 0, spec.out_channels)), full
    y = conv1d_valid(w, b, full, spec.stride, spec.dilation)
    return y, full[:, y_len * spec.stride:]


def streaming_init_state(batch_size: int, spec: ConvSpec, dtype=torch.float32,
                         device="cpu") -> torch.Tensor:
    """Zero carry state (B, (k-1)*d - s + 1, Cin)."""
    return torch.zeros((batch_size, causal_conv_state_len(spec), spec.in_channels),
                       dtype=dtype, device=device)


def linear_apply(w: torch.Tensor, b: torch.Tensor | None,
                 x: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w (in, out) + b: products of the input-dtype values
    summed in float32, bias added in float32, result cast to x's dtype."""
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


conv1x1_apply = linear_apply


class CausalConv(nn.Module):
    """Parameters ``w`` (K, Cin, Cout) and ``b`` (Cout,), Kaiming-uniform
    with bound 1/sqrt(Cin*K) like ``causal_conv_init``."""

    def __init__(self, spec: ConvSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec.validate()
        bound = 1.0 / math.sqrt(spec.in_channels * spec.kernel_size)
        self.w = nn.Parameter(uniform(
            (spec.kernel_size, spec.in_channels, spec.out_channels), bound,
            generator))
        self.b = nn.Parameter(uniform((spec.out_channels,), bound, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return causal_conv_apply(self.w, self.b, x, self.spec)

    def streaming(self, x: torch.Tensor, state: torch.Tensor):
        return causal_conv_streaming(self.w, self.b, x, state, self.spec)


class Linear(nn.Module):
    """Parameters ``w`` (in, out) and optional ``b`` (out,), bound
    1/sqrt(in) — the JAX ``conv1x1_init`` / ``_linear_init``."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator,
                 bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(uniform((in_dim, out_dim), bound, generator))
        self.b = (nn.Parameter(uniform((out_dim,), bound, generator))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply(self.w, self.b, x)
