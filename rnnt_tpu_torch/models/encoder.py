"""Jasper-style causal convolutional audio encoder (batch mode, eval).

Port of ``rnnt_tpu/models/encoder.py``: a stride-2 prologue conv, Jasper
blocks (causal convs + norm + exact-erf GELU, a 1x1-conv residual added
before the last sub-block's activation), a dilated epilogue conv and a 1x1
output conv.  Activations are (B, T, C).

A sub-block with ``additional_context > 0`` shortens its output by that
many frames; the residual is cut to the surviving frames, as in the JAX
package (at the flagship's 1024-frame bucket the encoder gives T' = 504,
not 512).  In training, dropout follows each GELU of a Jasper block (the
JAX package's uint16 threshold mask, ``dropout``) and batch norms use
batch statistics, putting their new running statistics into ``new_state``.

Module attribute names mirror the JAX params pytree, so
``compat/jax_params.py`` maps ``encoder/blocks/0/convs/1/w`` to
``encoder.blocks.0.convs.1.w`` one to one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from rnnt_tpu_torch.ops.causal_conv import (
    CausalConv,
    ConvSpec,
    Linear,
    causal_conv_out_len,
)
from rnnt_tpu_torch.ops.norm import Norm


@dataclass(frozen=True)
class JasperBlockSpec:
    kernel_size: int
    in_channels: int
    out_channels: int
    dropout: float
    num_sub_blocks: int
    norm_type: str = "batch"
    additional_context: int = 0

    def conv_spec(self, i: int) -> ConvSpec:
        cin = self.in_channels if i == 0 else self.out_channels
        return ConvSpec(cin, self.out_channels, self.kernel_size, 1, 1,
                        additional_context=self.additional_context)


@dataclass(frozen=True)
class EncoderSpec:
    input_features: int = 80
    prologue_kernel_size: int = 11
    prologue_stride: int = 2
    prologue_dilation: int = 1
    blocks: tuple[JasperBlockSpec, ...] = ()
    epilogue_features: int = 896
    epilogue_kernel_size: int = 29
    epilogue_stride: int = 1
    epilogue_dilation: int = 2
    output_features: int = 1024
    norm_type: str = "batch"

    @property
    def prologue_spec(self) -> ConvSpec:
        first = self.blocks[0].in_channels if self.blocks else self.epilogue_features
        return ConvSpec(self.input_features, first, self.prologue_kernel_size,
                        self.prologue_stride, self.prologue_dilation)

    @property
    def epilogue_spec(self) -> ConvSpec:
        last = self.blocks[-1].out_channels if self.blocks else self.prologue_spec.out_channels
        return ConvSpec(last, self.epilogue_features, self.epilogue_kernel_size,
                        self.epilogue_stride, self.epilogue_dilation)

    def conv_specs(self) -> list[ConvSpec]:
        specs = [self.prologue_spec]
        for b in self.blocks:
            specs.extend(b.conv_spec(i) for i in range(b.num_sub_blocks))
        specs.append(self.epilogue_spec)
        return specs


def encoder_out_len(in_len, spec: EncoderSpec):
    """Replay the conv length arithmetic; ints or integer tensors."""
    out = in_len
    for cs in spec.conv_specs():
        out = causal_conv_out_len(out, cs)
    return out


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with the JAX package's uint16 threshold mask: keep
    where 16 random bits < round((1 - rate) * 65536), rescale by that
    quantized keep share, so E[y] = x exactly.  The bits come from
    ``generator`` (on x's device); they cannot equal JAX's.  An identity
    outside training, at rate 0, or without a generator."""
    if not training or rate == 0.0 or generator is None:
        return x
    thresh = int(round((1.0 - rate) * 65536.0))
    keep = thresh / 65536.0
    bits = torch.randint(0, 65536, x.shape, generator=generator,
                         device=x.device, dtype=torch.int32)
    return torch.where(bits < thresh, x * (1.0 / keep),
                       torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


class JasperBlock(nn.Module):
    def __init__(self, b: JasperBlockSpec, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(
            CausalConv(b.conv_spec(i), generator) for i in range(b.num_sub_blocks))
        self.norms = nn.ModuleList(
            Norm(b.out_channels, b.norm_type) for _ in range(b.num_sub_blocks))
        self.residual_conv = Linear(b.in_channels, b.out_channels, generator)
        self.residual_norm = Norm(b.out_channels, b.norm_type)
        self.rate = b.dropout

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None,
                new_state: dict | None = None) -> torch.Tensor:
        residual = self.residual_norm(self.residual_conv(x), training, new_state)
        last = len(self.convs) - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = norm(conv(x), training, new_state)
            if i == last:
                # Lookahead shortens x; align the residual to the surviving frames.
                x = x + residual[:, : x.shape[1], :]
            x = dropout(_gelu(x), self.rate, training, generator)
        return x


class Encoder(nn.Module):
    """(B, T, input_features) -> (B, T', output_features)."""

    def __init__(self, spec: EncoderSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        self.prologue = nn.ModuleDict({
            "conv": CausalConv(spec.prologue_spec, generator),
            "norm": Norm(spec.prologue_spec.out_channels, spec.norm_type)})
        self.blocks = nn.ModuleList(JasperBlock(b, generator) for b in spec.blocks)
        self.epilogue = nn.ModuleDict({
            "conv": CausalConv(spec.epilogue_spec, generator),
            "norm": Norm(spec.epilogue_features, spec.norm_type)})
        self.out = Linear(spec.epilogue_features, spec.output_features, generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None,
                new_state: dict | None = None) -> torch.Tensor:
        x = _gelu(self.prologue["norm"](self.prologue["conv"](x), training,
                                        new_state))
        for block in self.blocks:
            x = block(x, training, generator, new_state)
        x = _gelu(self.epilogue["norm"](self.epilogue["conv"](x), training,
                                        new_state))
        return self.out(x)
