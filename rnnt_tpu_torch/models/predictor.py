"""RNN-T prediction (text-side) network: the conv predictor.

Port of ``rnnt_tpu/models/predictor.py:38-143``: embedding -> LayerNorm ->
CausalConv(k=3) -> GELU -> CausalConv(k=5) -> GELU -> Linear -> LayerNorm,
stateless with a 7-token receptive field.  In training, dropout (the
encoder's uint16 threshold mask) follows each GELU.

``LSTMPredictorSpec`` is kept so that configs naming an LSTM predictor
build the same spec as the JAX package; the LSTM module itself is not
ported yet and building one raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from rnnt_tpu_torch.models.encoder import dropout
from rnnt_tpu_torch.ops.causal_conv import CausalConv, ConvSpec, Linear
from rnnt_tpu_torch.ops.norm import LayerNorm


@dataclass(frozen=True)
class ConvPredictorSpec:
    num_symbols: int
    output_dim: int
    symbol_embedding_dim: int
    dropout: float = 0.0

    @property
    def conv1_spec(self) -> ConvSpec:
        d = self.symbol_embedding_dim
        return ConvSpec(d, d, kernel_size=3, stride=1, dilation=1)

    @property
    def conv2_spec(self) -> ConvSpec:
        d = self.symbol_embedding_dim
        return ConvSpec(d, d, kernel_size=5, stride=1, dilation=1)

    @property
    def receptive_field(self) -> int:
        """Tokens of context needed for one output position: (3-1)+(5-1)+1."""
        return 7


@dataclass(frozen=True)
class LSTMPredictorSpec:
    num_symbols: int
    output_dim: int
    symbol_embedding_dim: int
    num_lstm_layers: int
    lstm_hidden_dim: int
    lstm_layer_norm: bool = False
    lstm_layer_norm_epsilon: float = 1e-5
    lstm_dropout: float = 0.0


class ConvPredictor(nn.Module):
    """tokens (B, U) int -> features (B, U, output_dim)."""

    def __init__(self, spec: ConvPredictorSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        self.embedding = nn.Parameter(torch.randn(
            (spec.num_symbols, spec.symbol_embedding_dim), generator=generator))
        self.input_ln = LayerNorm(spec.symbol_embedding_dim)
        self.conv1 = CausalConv(spec.conv1_spec, generator)
        self.conv2 = CausalConv(spec.conv2_spec, generator)
        self.linear = Linear(spec.symbol_embedding_dim, spec.output_dim, generator)
        self.output_ln = LayerNorm(spec.output_dim)

    def forward(self, tokens: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        rate = self.spec.dropout
        x = self.input_ln(self.embedding[tokens.long()])
        x = dropout(F.gelu(self.conv1(x), approximate="none"), rate, training,
                    generator)
        x = dropout(F.gelu(self.conv2(x), approximate="none"), rate, training,
                    generator)
        return self.output_ln(self.linear(x))


def make_predictor(spec, generator: torch.Generator) -> nn.Module:
    if isinstance(spec, ConvPredictorSpec):
        return ConvPredictor(spec, generator)
    if isinstance(spec, LSTMPredictorSpec):
        raise NotImplementedError(
            "the LSTM predictor is not ported to rnnt_tpu_torch yet")
    raise TypeError(f"unknown predictor spec: {type(spec)}")
