"""FastConformer encoder: NeMo's ConformerEncoder as parakeet-rnnt-0.6b
configures it (Rekesh et al., arXiv:2305.05084), for training and greedy
eval.

* Subsampling (``dw_striding``, 8x): ``Conv2d(1 -> C, 3, stride 2, pad
  1)`` and ReLU, then twice a depthwise ``Conv2d(C, 3, stride 2, pad 1)``,
  a pointwise ``Conv2d(C -> C, 1)`` and ReLU, over (B, 1, T, F); the result
  flattened channel-major to (B, T', C * F') and projected to ``d_model``.
  Lengths: ``L <- floor((L + 2 - 3) / 2) + 1`` per stage.
* ``x * sqrt(d_model)`` (xscaling) and a sinusoidal table of the relative
  positions ``L' - 1 ... -(L' - 1)`` of the padded length L'.
* ``num_layers`` macaron layers over a float32 residual stream r:
  ``r += FF1(LN(r)) / 2``, ``r += MHSA(LN(r))``, ``r += Conv(LN(r))``,
  ``r += FF2(LN(r)) / 2``, ``r = LN(r)``; FF is Linear(d, 4d), SiLU,
  Linear(4d, d).
* MHSA, Transformer-XL style with untied per-layer biases ``pos_u`` and
  ``pos_v`` (heads, d_k): scores ``((q + u) k^T + rel_shift((q + v)
  pos^T)) / sqrt(d_k)``, ``pos`` a bias-free linear layer over the table;
  pairs with a padded query or key get -10000 before the softmax, and a
  padded query's output is 0 before ``out``.  The core runs through
  ``F.scaled_dot_product_attention`` with the scaled, masked position term
  as its float bias, on an explicitly chosen backend: memory-efficient on
  CUDA (it takes the bias's gradient), the math backend on the CPU.  A
  backend that cannot take the call raises; nothing falls back.  The
  position term and the core run in float32 whatever the activations'
  dtype (q, k and v cast up, the output cast back): on an H100 the
  memory-efficient backend's bf16 backward left the position projections'
  gradients of the first layers far noisier than bf16 products do against
  a float32 reference (PERF.md), and the step waits on the host, not on
  these products.  The math backend on bf16 inputs (it computes in float32
  too) took 5 % less device time a layer but 29 more kernels a call, and
  was no faster end to end (PERF.md).
* Conv module: pointwise Linear(d, 2d), GLU, padded frames set to 0, a
  depthwise conv of ``conv_kernel_size`` taps (centred, with bias), batch
  norm over every (B, T') position (``ops/norm.py``), SiLU, pointwise
  Linear(d, d).

Precision: the products run in the activations' dtype (bf16 under the
bf16 path) with float32 accumulation, the residual stream, layer norms,
batch norm and the softmax's statistics in float32.  Dropout is not
modelled (the port's configurations that use this encoder train without
it).  Parameters are named ``*.w`` / ``*.b`` (2-D convolutions stored as
(9, Cin / groups, Cout)), ``*.scale`` / ``*.bias`` and ``pos_u.bias`` /
``pos_v.bias`` (zeros, as NeMo initializes them).

The encoder opens a ``subsample`` span, and per layer ``feed_forward``
(twice), ``attention`` and ``conv_module`` spans (``train/profiling.py``).
``ATTN_CALLS`` counts the attention cores run and ``ATTN_BACKEND`` names
the SDPA backend of the last one; callers diff the count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from rnnt_tpu_torch.ops.causal_conv import Linear
from rnnt_tpu_torch.ops.norm import LayerNorm, Norm
from rnnt_tpu_torch.train.profiling import span
from rnnt_tpu_torch.utils import uniform

ATTN_CALLS = 0     # attention cores run; callers diff it
ATTN_BACKEND = ""  # the SDPA backend of the last core: "efficient" or "math"
MASKED = -10000.0  # the score of a pair with a padded query or key (NeMo's)
_LN_EPS = 1e-5


@dataclass(frozen=True)
class FastConformerSpec:
    input_features: int
    d_model: int
    num_layers: int
    num_heads: int
    ff_expansion_factor: int
    conv_kernel_size: int
    subsampling_factor: int
    subsampling_conv_channels: int
    xscaling: bool = True

    @property
    def output_features(self) -> int:
        return self.d_model

    @property
    def stages(self) -> int:
        """Stride-2 stages of the subsampling."""
        n = int(round(math.log2(self.subsampling_factor)))
        if 2 ** n != self.subsampling_factor or n < 1:
            raise ValueError(f"encoder.subsampling_factor={self.subsampling_factor} "
                             "is not a power of 2")
        return n

    def out_len(self, n):
        """Frames after the subsampling; ints or integer tensors."""
        for _ in range(self.stages):
            n = (n - 1) // 2 + 1
        return n


class Conv2dParams(nn.Module):
    """A 3x3 2-D convolution's ``w`` (9, Cin / groups, Cout) and ``b``
    (Cout,), bound 1/sqrt(9 Cin / groups)."""

    def __init__(self, cin_per_group: int, cout: int, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(9 * cin_per_group)
        self.w = nn.Parameter(uniform((9, cin_per_group, cout), bound, generator))
        self.b = nn.Parameter(uniform((cout,), bound, generator))

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """x (B, Cin, T, F) -> (B, Cout, ceil(T / 2), ceil(F / 2))."""
        _, cin, cout = self.w.shape
        w = self.w.permute(2, 1, 0).reshape(cout, cin, 3, 3).to(x.dtype)
        return F.conv2d(x, w, self.b.to(x.dtype), stride=2, padding=1, groups=groups)


def linear(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin`` in x's dtype: one product summed in float32 (cuBLAS), its
    output and bias in x's dtype."""
    b = None if lin.b is None else lin.b.to(x.dtype)
    return F.linear(x, lin.w.t().to(x.dtype), b)


def layer_norm(norm: LayerNorm, r: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Layer norm of the float32 stream, cast to the compute dtype."""
    return F.layer_norm(r, r.shape[-1:], norm.scale, norm.bias, _LN_EPS).to(dtype)


class Subsampling(nn.Module):
    """dw_striding: (B, T, F) features -> (B, T', d_model)."""

    def __init__(self, spec: FastConformerSpec, generator: torch.Generator):
        super().__init__()
        C = spec.subsampling_conv_channels
        self.conv0 = Conv2dParams(1, C, generator)
        self.dw = nn.ModuleList(Conv2dParams(1, C, generator) for _ in range(spec.stages - 1))
        self.pw = nn.ModuleList(Linear(C, C, generator) for _ in range(spec.stages - 1))
        f = spec.out_len(spec.input_features)
        self.out = Linear(C * f, spec.d_model, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = F.relu(self.conv0(x[:, None]))
        for dw, pw in zip(self.dw, self.pw):
            x = dw(x, groups=x.shape[1])
            w = pw.w.t().to(x.dtype)[:, :, None, None]
            x = F.relu(F.conv2d(x, w, pw.b.to(x.dtype)))
        x = x.transpose(1, 2).reshape(B, x.shape[2], -1)  # channel-major (C, F')
        return linear(self.out, x)


class FeedForward(nn.Module):
    def __init__(self, d: int, expansion: int, generator: torch.Generator):
        super().__init__()
        self.lin1 = Linear(d, d * expansion, generator)
        self.lin2 = Linear(d * expansion, d, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.lin2, F.silu(linear(self.lin1, x)))


class HeadBias(nn.Module):
    """An untied positional bias ``bias`` (heads, d_k), zeros."""

    def __init__(self, heads: int, dk: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros((heads, dk)))


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T - 1) scores against the relative positions T - 1 ...
    -(T - 1) -> (B, H, T, T) with [i, j] at relative position i - j
    (Transformer-XL's shift: a zero column, a view, the first row off)."""
    B, H, T, P = x.shape
    x = F.pad(x, (1, 0)).view(B, H, P + 1, T)[:, :, 1:].view(B, H, T, P)
    return x[..., :T]


def relative_positions(T: int, d: int, device) -> torch.Tensor:
    """(2T - 1, d) float32: row p is relative position T - 1 - p, its even
    features sin(pos / 10000^(2i / d)) and odd ones the cosine."""
    pos = torch.arange(T - 1, -T, -1, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((2 * T - 1, d), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def sdpa_backend(device: torch.device):
    """(the backend the attention core runs on, its name)."""
    from torch.nn.attention import SDPBackend

    if device.type == "cuda":
        return SDPBackend.EFFICIENT_ATTENTION, "efficient"
    return SDPBackend.MATH, "math"


def attention_core(q, k, v, bias, scale: float) -> torch.Tensor:
    """softmax(q k^T scale + bias) v on the device's chosen backend alone."""
    global ATTN_CALLS, ATTN_BACKEND
    from torch.nn.attention import sdpa_kernel

    backend, name = sdpa_backend(q.device)
    with sdpa_kernel([backend]):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)
    ATTN_CALLS += 1
    ATTN_BACKEND = name
    return out


class RelPositionAttention(nn.Module):
    def __init__(self, d: int, heads: int, generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.q = Linear(d, d, generator)
        self.k = Linear(d, d, generator)
        self.v = Linear(d, d, generator)
        self.out = Linear(d, d, generator)
        self.pos = Linear(d, d, generator, bias=False)
        self.pos_u = HeadBias(heads, d // heads)
        self.pos_v = HeadBias(heads, d // heads)

    def forward(self, x, pos_emb, pair_valid, valid) -> torch.Tensor:
        """x (B, T, d), pos_emb (2T - 1, d) float32, pair_valid (B, 1, T, T)
        and valid (B, T) bool."""
        B, T, d = x.shape
        H = self.heads
        dk = d // H

        def heads(t):
            return t.view(t.shape[0], -1, H, dk).transpose(1, 2)

        q, k, v = (heads(linear(lin, x)).float() for lin in (self.q, self.k, self.v))
        p = heads(linear(self.pos, pos_emb[None]))                      # (1, H, 2T-1, dk)
        u = self.pos_u.bias[None, :, None, :]
        w = self.pos_v.bias[None, :, None, :]
        scale = 1.0 / math.sqrt(dk)
        bd = rel_shift(torch.matmul(q + w, p.transpose(-1, -2)))        # (B, H, T, T)
        bias = torch.where(pair_valid, bd * scale, torch.full((), MASKED, device=x.device))
        o = attention_core(q + u, k, v, bias, scale).to(x.dtype)
        o = o.transpose(1, 2).reshape(B, T, d) * valid[:, :, None].to(x.dtype)
        return linear(self.out, o)


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int, generator: torch.Generator):
        super().__init__()
        self.pw1 = Linear(d, 2 * d, generator)
        bound = 1.0 / math.sqrt(kernel)
        self.dw = nn.Module()
        self.dw.w = nn.Parameter(uniform((kernel, 1, d), bound, generator))
        self.dw.b = nn.Parameter(uniform((d,), bound, generator))
        self.norm = Norm(d, "batch")
        self.pw2 = Linear(d, d, generator)

    def forward(self, x, valid, training: bool, new_state: dict | None) -> torch.Tensor:
        x = F.glu(linear(self.pw1, x), dim=-1) * valid[:, :, None].to(x.dtype)
        K = self.dw.w.shape[0]
        w = self.dw.w.permute(2, 1, 0).to(x.dtype)                      # (d, 1, K)
        x = F.conv1d(x.transpose(1, 2), w, self.dw.b.to(x.dtype), padding=(K - 1) // 2,
                     groups=x.shape[-1]).transpose(1, 2)
        x = self.norm(x, training, new_state)
        return linear(self.pw2, F.silu(x))


class ConformerLayer(nn.Module):
    def __init__(self, spec: FastConformerSpec, generator: torch.Generator):
        super().__init__()
        d = spec.d_model
        self.norm_ff1 = LayerNorm(d)
        self.ff1 = FeedForward(d, spec.ff_expansion_factor, generator)
        self.norm_att = LayerNorm(d)
        self.att = RelPositionAttention(d, spec.num_heads, generator)
        self.norm_conv = LayerNorm(d)
        self.conv = ConvModule(d, spec.conv_kernel_size, generator)
        self.norm_ff2 = LayerNorm(d)
        self.ff2 = FeedForward(d, spec.ff_expansion_factor, generator)
        self.norm_out = LayerNorm(d)

    def forward(self, r, dtype, pos_emb, pair_valid, valid, training, new_state):
        with span("feed_forward"):
            r = r + 0.5 * self.ff1(layer_norm(self.norm_ff1, r, dtype)).float()
        with span("attention"):
            r = r + self.att(layer_norm(self.norm_att, r, dtype), pos_emb, pair_valid,
                             valid).float()
        with span("conv_module"):
            r = r + self.conv(layer_norm(self.norm_conv, r, dtype), valid, training,
                              new_state).float()
        with span("feed_forward"):
            r = r + 0.5 * self.ff2(layer_norm(self.norm_ff2, r, dtype)).float()
        return F.layer_norm(r, r.shape[-1:], self.norm_out.scale, self.norm_out.bias, _LN_EPS)


class FastConformer(nn.Module):
    """(B, T, input_features) features and their frame counts -> (B, T',
    d_model) in the features' dtype."""

    def __init__(self, spec: FastConformerSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        self.pre_encode = Subsampling(spec, generator)
        self.layers = nn.ModuleList(ConformerLayer(spec, generator)
                                    for _ in range(spec.num_layers))

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None,
                new_state: dict | None = None,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
        """``lengths`` (B,) are the valid feature frames (all when None);
        ``generator`` is unused (no dropout)."""
        dtype = x.dtype
        with span("subsample"):
            x = self.pre_encode(x)
        B, T, d = x.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long, device=x.device)
        else:
            lengths = self.spec.out_len(lengths.to(x.device).long())
        valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        pair_valid = (valid[:, :, None] & valid[:, None, :])[:, None]
        r = x.float() * (math.sqrt(d) if self.spec.xscaling else 1.0)
        pos_emb = relative_positions(T, d, x.device)
        for layer in self.layers:
            r = layer(r, dtype, pos_emb, pair_valid, valid, training, new_state)
        return r.to(dtype)
