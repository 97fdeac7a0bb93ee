"""RNN-T prediction (text-side) networks: conv and layer-normed LSTM.

Port of ``rnnt_tpu/models/predictor.py``.

* ``ConvPredictor`` (``:38-143``): embedding -> LayerNorm -> CausalConv(k=3)
  -> GELU -> CausalConv(k=5) -> GELU -> Linear -> LayerNorm, stateless with
  a 7-token receptive field.  In training, dropout (the encoder's uint16
  threshold mask) follows each GELU.
* ``LSTMPredictor`` (``:146-233``): embedding -> LayerNorm -> N LSTM layers
  -> Linear -> LayerNorm, carrying (h, c) per layer.  Each layer's input
  projection ``x2g`` is one product over the whole sequence; the recurrence
  is a Python loop over U with ``p2g`` each step.  With layer norm,
  ``g_norm`` normalizes all 4H gates before the i, f, c, o split, and
  ``c_norm`` normalizes the new cell before ``h = o * tanh(c)`` (the normed
  cell is the carried state); ``x2g`` then has no bias.  The norms use eps
  1e-5 (``ops/norm.py``), not the spec's unused
  ``lstm_layer_norm_epsilon``.  In training, dropout at ``lstm_dropout``
  follows every layer, the last included.

On a tensor-parallel mesh (``parallel/mesh.shard_params``) either one's
``linear`` holds this rank's columns of the output and runs
column-parallel (``tp_mesh`` set), the whole output gathered before
``output_ln``.

``predictor_apply`` is the full-sequence features of either (the training
lattice and rescoring); decode steps them through
``decode/greedy.make_predictor_stepper``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from rnnt_tpu_torch.models.encoder import dropout
from rnnt_tpu_torch.ops.causal_conv import CausalConv, ConvSpec, Linear
from rnnt_tpu_torch.ops.norm import LayerNorm
from rnnt_tpu_torch.parallel.mesh import column_parallel


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

    tp_mesh = None  # the mesh when ``linear`` holds this rank's columns

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
        return self.output_ln(column_parallel(self.linear, x, self.tp_mesh))


class LSTMLayer(nn.Module):
    """One LSTM layer: parameters ``x2g.w`` (+ ``x2g.b`` without layer
    norm), ``p2g.w`` and, with layer norm, ``c_norm`` and ``g_norm``."""

    def __init__(self, input_dim: int, hidden_dim: int, layer_norm: bool,
                 generator: torch.Generator):
        super().__init__()
        self.x2g = Linear(input_dim, 4 * hidden_dim, generator, bias=not layer_norm)
        self.p2g = Linear(hidden_dim, 4 * hidden_dim, generator, bias=False)
        if layer_norm:
            self.c_norm = LayerNorm(hidden_dim)
            self.g_norm = LayerNorm(4 * hidden_dim)

    def forward(self, x: torch.Tensor, state: dict):
        """x (B, U, D), state {"h", "c"} (B, H) -> (hs (B, U, H), new state)."""
        gated = self.x2g(x)
        h, c = state["h"], state["c"]
        layer_norm = hasattr(self, "g_norm")
        hs = []
        for u in range(gated.shape[1]):
            gates = gated[:, u] + self.p2g(h)
            if layer_norm:
                gates = self.g_norm(gates)
            i_g, f_g, c_g, o_g = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f_g) * c + torch.sigmoid(i_g) * torch.tanh(c_g)
            if layer_norm:
                c = self.c_norm(c)
            h = torch.sigmoid(o_g) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1), {"h": h, "c": c}


class LSTMPredictor(nn.Module):
    """tokens (B, U) int [+ state] -> (features (B, U, output_dim), state);
    the state is a tuple of {"h", "c"} (B, lstm_hidden_dim) per layer."""

    tp_mesh = None  # as ConvPredictor's

    def __init__(self, spec: LSTMPredictorSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        H = spec.lstm_hidden_dim
        self.layers = nn.ModuleList(
            LSTMLayer(spec.symbol_embedding_dim if i == 0 else H, H,
                      spec.lstm_layer_norm, generator)
            for i in range(spec.num_lstm_layers))
        self.embedding = nn.Parameter(torch.randn(
            (spec.num_symbols, spec.symbol_embedding_dim), generator=generator))
        self.input_ln = LayerNorm(spec.symbol_embedding_dim)
        self.linear = Linear(H, spec.output_dim, generator)
        self.output_ln = LayerNorm(spec.output_dim)

    def init_state(self, batch: int, device="cpu") -> tuple:
        """Zero (h, c) for every layer."""
        zeros = lambda: torch.zeros((batch, self.spec.lstm_hidden_dim),  # noqa: E731
                                    device=device)
        return tuple({"h": zeros(), "c": zeros()} for _ in self.layers)

    def forward(self, tokens: torch.Tensor, state: tuple | None = None,
                training: bool = False, generator: torch.Generator | None = None):
        if state is None:
            state = self.init_state(tokens.shape[0], tokens.device)
        x = self.input_ln(self.embedding[tokens.long()])
        new_state = []
        for layer, s in zip(self.layers, state):
            x, s = layer(x, s)
            x = dropout(x, self.spec.lstm_dropout, training, generator)
            new_state.append(s)
        return (self.output_ln(column_parallel(self.linear, x, self.tp_mesh)),
                tuple(new_state))


def make_predictor(spec, generator: torch.Generator) -> nn.Module:
    if isinstance(spec, ConvPredictorSpec):
        return ConvPredictor(spec, generator)
    if isinstance(spec, LSTMPredictorSpec):
        return LSTMPredictor(spec, generator)
    raise TypeError(f"unknown predictor spec: {type(spec)}")


def predictor_apply(predictor: nn.Module, tokens: torch.Tensor,
                    training: bool = False,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Full-sequence features (B, U, output_dim) of either predictor from
    its zero state (``rnnt_tpu/models/predictor.py:246-254``)."""
    if isinstance(predictor, LSTMPredictor):
        return predictor(tokens, None, training, generator)[0]
    return predictor(tokens, training, generator)
