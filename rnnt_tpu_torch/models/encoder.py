"""Jasper-style causal convolutional audio encoder.

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

On a tensor-parallel mesh (``parallel/mesh.shard_params``) ``out`` holds
this rank's columns of H and runs column-parallel (``tp_mesh`` set): its
input's gradient is summed over the model group and its output gathered
whole, so the encoder returns (B, T', H) on every model rank.

Module attribute names mirror the JAX params pytree, so
``compat/jax_params.py`` maps ``encoder/blocks/0/convs/1/w`` to
``encoder.blocks.0.convs.1.w`` one to one.

``Encoder.streaming`` runs a chunk with one carry state per causal conv
(``encoder_streaming_init_state``), in inference mode: norms read their
running statistics.  Instance norms take their statistics over the chunk,
so only batch norm makes the streamed frames equal the batch-mode ones;
the JAX package makes the same trade.
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
    streaming_init_state,
)
from rnnt_tpu_torch.ops.norm import Norm
from rnnt_tpu_torch.parallel.mesh import column_parallel
from rnnt_tpu_torch.utils import batch_draw


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


def encoder_streaming_init_state(batch_size: int, spec: EncoderSpec,
                                 dtype=torch.float32, device="cpu") -> tuple:
    """Zero carry states, one per causal conv, (B, (k-1)d - s + 1, Cin)."""
    return tuple(streaming_init_state(batch_size, cs, dtype, device)
                 for cs in spec.conv_specs())


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with the JAX package's uint16 threshold mask: keep
    where 16 random bits < round((1 - rate) * 65536), rescale by that
    quantized keep share, so E[y] = x exactly.  The bits come from
    ``generator`` (on x's device; a ``RowGenerator`` draws them at the
    global batch's shape); they cannot equal JAX's.  An identity outside
    training, at rate 0, or without a generator."""
    if not training or rate == 0.0 or generator is None:
        return x
    thresh = int(round((1.0 - rate) * 65536.0))
    keep = thresh / 65536.0
    bits = batch_draw(generator, x.shape[0], lambda g, n: torch.randint(
        0, 65536, (n, *x.shape[1:]), generator=g, device=x.device,
        dtype=torch.int32))
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

    tp_mesh = None  # the mesh when ``out`` holds this rank's columns

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
        return column_parallel(self.out, x, self.tp_mesh)

    def streaming(self, x: torch.Tensor, conv_states: tuple):
        """One chunk x (B, T, input_features) -> (y (B, T', output_features),
        new_conv_states).  A chunk that leaves no frame after some conv
        returns no frame, and the later convs keep their carries."""
        states = list(conv_states)
        k = 0

        def conv(c, xx):
            nonlocal k
            y, states[k] = c.streaming(xx, states[k])
            k += 1
            return y

        def no_frame():
            return (x.new_zeros((x.shape[0], 0, self.spec.output_features)),
                    tuple(states))

        x = conv(self.prologue["conv"], x)
        if x.shape[1] == 0:
            return no_frame()
        x = _gelu(self.prologue["norm"](x))
        for block in self.blocks:
            residual = block.residual_norm(block.residual_conv(x))
            last = len(block.convs) - 1
            for i, (c, norm) in enumerate(zip(block.convs, block.norms)):
                x = conv(c, x)
                if x.shape[1] == 0:
                    return no_frame()
                x = norm(x)
                if i == last:
                    x = x + residual[:, : x.shape[1], :]
                x = _gelu(x)
        x = conv(self.epilogue["conv"], x)
        if x.shape[1] == 0:
            return no_frame()
        x = _gelu(self.epilogue["norm"](x))
        return self.out(x), tuple(states)
