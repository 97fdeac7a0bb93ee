"""Normalization layers over (B, T, C) activations.

Port of ``rnnt_tpu/ops/norm.py``: batch norm (running statistics in eval;
batch statistics over (B, T) in training, with the running statistics
moved by momentum 0.1 towards the batch mean and the *unbiased* batch
variance), instance norm and affine instance norm over the time axis, and
layer norm over the feature axis.  Statistics are computed in float32
whatever the activation dtype, then cast back.

As in the JAX package, the new running statistics are returned, not
written: ``Norm.forward`` in training puts them into a caller's
``new_state`` dict under the module's ``state_key``, and the train step
commits them after the update.

Instance norms take their statistics over the whole padded time axis,
padding included — the JAX package does the same and the port matches it
rather than masking.

On several data ranks (``batch_stats_over(group)``, which the train step
enters with its mesh's data group) a training-mode batch norm takes its
statistics over the global batch, as JAX's jit does over a data-sharded
batch (``rnnt_tpu/ops/norm.py:45-56``): two passes, the per-channel sums
and the count all-reduced first, then the sums of squared deviations from
the global mean (``jnp.var``'s arithmetic; the one-pass E[x^2] - E[x]^2
can lose it in float32).  Both all-reduces are autograd Functions whose
backward all-reduces too, so each rank's gradient takes the other ranks'
uses of the shared statistics; the unbiased running variance uses the
global count.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from rnnt_tpu_torch.parallel.mesh import all_reduce_both

_EPS = 1e-5
_MOMENTUM = 0.1  # torch BatchNorm default: new = (1-m)*old + m*batch
NORM_TYPES = ("batch", "instance", "instance_affine")


def norm_apply(x: torch.Tensor, norm_type: str, scale=None, bias=None,
               mean=None, var=None) -> torch.Tensor:
    """x: (B, T, C).  ``mean``/``var`` are the running statistics (batch norm
    only); ``scale``/``bias`` the affine parameters where the type has them."""
    xf = x.float()
    if norm_type == "batch":
        y = (xf - mean.float()) * torch.rsqrt(var.float() + _EPS)
        y = y * scale.float() + bias.float()
        return y.to(x.dtype)
    if norm_type not in NORM_TYPES:
        raise ValueError(f"unknown norm_type: {norm_type}")
    m = xf.mean(dim=1, keepdim=True)
    v = xf.var(dim=1, keepdim=True, unbiased=False)
    y = (xf - m) * torch.rsqrt(v + _EPS)
    if norm_type == "instance_affine":
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


_stats_group = None  # the process group batch statistics span (None: this rank)


@contextlib.contextmanager
def batch_stats_over(group):
    """Inside, training-mode batch norms take their statistics over the
    batch rows of every rank of ``group`` (None: this rank's rows)."""
    global _stats_group
    prev, _stats_group = _stats_group, group
    try:
        yield
    finally:
        _stats_group = prev


def batch_norm_train(x: torch.Tensor, scale, bias, mean, var, group=None):
    """Training-mode batch norm over (B, T): (y, new_mean, new_var); over
    the (B, T) of every rank of ``group`` when one is given."""
    xf = x.float()
    if group is None:
        m = xf.mean(dim=(0, 1))
        v = xf.var(dim=(0, 1), unbiased=False)
        n = x.shape[0] * x.shape[1]
        unbiased = v * (n / max(n - 1, 1))
    else:
        C = x.shape[-1]
        sums = all_reduce_both(torch.cat([xf.sum(dim=(0, 1)),
                                          xf.new_full((1,), x.shape[0] * x.shape[1])]), group)
        n = sums[C].detach()
        m = sums[:C] / n
        v = all_reduce_both(torch.sum((xf - m) ** 2, dim=(0, 1)), group) / n
        unbiased = v * (n / (n - 1).clamp_min(1))
    new_mean = (1 - _MOMENTUM) * mean.float() + _MOMENTUM * m
    new_var = (1 - _MOMENTUM) * var.float() + _MOMENTUM * unbiased
    y = (xf - m) * torch.rsqrt(v + _EPS)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype), new_mean.detach(), new_var.detach()


class Norm(nn.Module):
    """Parameters ``scale``/``bias`` (batch, instance_affine) and buffers
    ``mean``/``var`` (batch) — the JAX ``norm_init`` params and state.
    ``state_key`` is the module's dotted name in the model (set by
    ``RNNT``), the prefix of its entries in a ``new_state`` dict."""

    state_key = ""

    def __init__(self, num_channels: int, norm_type: str):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"unknown norm_type: {norm_type}")
        self.norm_type = norm_type
        if norm_type in ("batch", "instance_affine"):
            self.scale = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))
        if norm_type == "batch":
            self.register_buffer("mean", torch.zeros(num_channels))
            self.register_buffer("var", torch.ones(num_channels))

    def forward(self, x: torch.Tensor, training: bool = False,
                new_state: dict | None = None) -> torch.Tensor:
        if training and self.norm_type == "batch":
            y, m, v = batch_norm_train(x, self.scale, self.bias, self.mean,
                                       self.var, _stats_group)
            if new_state is not None:
                new_state[f"{self.state_key}.mean"] = m
                new_state[f"{self.state_key}.var"] = v
            return y
        return norm_apply(x, self.norm_type, getattr(self, "scale", None),
                          getattr(self, "bias", None),
                          getattr(self, "mean", None),
                          getattr(self, "var", None))


def layer_norm_apply(x: torch.Tensor, scale, bias) -> torch.Tensor:
    """LayerNorm over the trailing feature axis (eps 1e-5), f32 statistics."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - m) * torch.rsqrt(v + _EPS)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_apply(x, self.scale, self.bias)
