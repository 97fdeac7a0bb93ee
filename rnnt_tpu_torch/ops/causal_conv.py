"""Causal 1-D convolution and the 1x1 (per-frame linear) convolution.

Port of ``rnnt_tpu/ops/causal_conv.py`` (batch mode).  Public functions
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


def causal_conv_out_len(in_len, spec: ConvSpec):
    """Output length for an input length; ints or integer tensors (floor
    division, as in the JAX package)."""
    numer = in_len + spec.left_padding - spec.dilation * (spec.kernel_size - 1) - 1
    return numer // spec.stride + 1


def conv1d_valid(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Unpadded conv: x (B, T, Cin), w (K, Cin, Cout) -> (B, T', Cout)."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0).to(x.dtype),
                 stride=stride, dilation=dilation)
    y = y + b.to(y.dtype)[:, None]
    return y.transpose(1, 2).to(x.dtype)


def causal_conv_apply(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      spec: ConvSpec) -> torch.Tensor:
    """Batch-mode forward, zero left pad only.  x: (B, T, Cin)."""
    x = F.pad(x, (0, 0, spec.left_padding, 0))
    return conv1d_valid(w, b, x, spec.stride, spec.dilation)


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
