"""RNN-T model assembly: encoder + predictor + joint.

Port of ``rnnt_tpu/models/rnnt.py``.  ``RNNT`` holds the three modules
under the JAX params' top-level names; ``rnnt_forward`` runs the predictor
on blank-prepended targets and the encoder on features, in eval or in
training mode (dropout from an explicit generator, batch statistics), and
returns the new batch-norm state as the JAX ``rnnt_forward`` does; the two
run in ``predictor`` and ``encoder`` spans (``train/profiling.py``).

The encoder is the spec's kind: the Jasper encoder (``EncoderSpec``) or the
FastConformer (``models/fastconformer.py``, ``FastConformerSpec``), which
takes the feature frames' counts for its attention mask.
``refuse_unsupported`` names the keys of a model that a path does not run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch
from torch import nn

from rnnt_tpu_torch.models.encoder import Encoder, EncoderSpec
from rnnt_tpu_torch.models.fastconformer import FastConformer, FastConformerSpec
from rnnt_tpu_torch.models.joint import Joint, JointSpec
from rnnt_tpu_torch.models.predictor import (
    ConvPredictorSpec,
    LSTMPredictorSpec,
    RNNPredictorSpec,
    make_predictor,
    predictor_apply,
)
from rnnt_tpu_torch.ops.norm import Norm
from rnnt_tpu_torch.train.profiling import span


@dataclass(frozen=True)
class RNNTSpec:
    encoder: Union[EncoderSpec, FastConformerSpec]
    predictor: Union[ConvPredictorSpec, LSTMPredictorSpec, RNNPredictorSpec]
    joint: JointSpec
    loss_chunk_size: int = 16
    loss_impl: str = "auto"  # auto | chunked | pallas | pruned
    pruned_band: int = 16
    pruned_simple_scale: float = 0.5
    pruned_scale: float = 1.0
    grad_clamp: float = -1.0
    lattice_shard_t: bool = False

    @property
    def blank_idx(self) -> int:
        return self.joint.blank_idx


class RNNT(nn.Module):
    """Seeded init with the ``*_init`` distributions of the JAX package:
    Kaiming-uniform convs and linears, normal embedding, unit norms.
    Parameters are created float32 on the CPU; move with ``.to(device)``.
    ``tp_layout`` is {parameter name: sharded dim} once
    ``parallel/mesh.shard_params`` has cut it to a rank's shards."""

    tp_layout: dict = {}

    def __init__(self, spec: RNNTSpec, generator: torch.Generator,
                 simple: bool | None = None):
        super().__init__()
        self.spec = spec
        self.encoder = make_encoder(spec.encoder, generator)
        self.predictor = make_predictor(spec.predictor, generator)
        if simple is None:
            simple = spec.loss_impl == "pruned"
        self.joint = Joint(spec.joint, generator, simple=simple)
        for name, m in self.named_modules():
            if isinstance(m, Norm):
                m.state_key = name

    def norm_state(self) -> dict:
        """The batch-norm running statistics, by buffer name."""
        return {k: v for k, v in self.named_buffers()}

    @torch.no_grad()
    def commit_norm_state(self, new_state: dict) -> None:
        """Write new running statistics (from a training forward) into the
        buffers."""
        buffers = dict(self.named_buffers())
        for k, v in new_state.items():
            buffers[k].copy_(v)


def make_encoder(spec, generator: torch.Generator) -> nn.Module:
    if isinstance(spec, FastConformerSpec):
        return FastConformer(spec, generator)
    return Encoder(spec, generator)


def refuse_unsupported(spec: RNNTSpec, path: str) -> None:
    """Raise, naming the config key, when ``spec`` uses what ``path`` (a
    few words naming the path) does not run: the FastConformer encoder or
    a ReLU joint, which only training, the exact losses and greedy eval
    take."""
    if isinstance(spec.encoder, FastConformerSpec):
        raise ValueError(f"encoder.kind='fastconformer' is not supported by {path}")
    if spec.joint.activation != "tanh":
        raise ValueError(f"joint.activation={spec.joint.activation!r} is not supported "
                         f"by {path}")


def rnnt_init(spec: RNNTSpec, seed: int = 0, device="cpu") -> RNNT:
    """A freshly initialized model on ``device`` (weights drawn on the CPU
    from ``torch.Generator().manual_seed(seed)``, so equal on every device)."""
    model = RNNT(spec, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def resolve_loss_impl(impl: str, device: torch.device) -> str:
    """'auto' -> the hand-written kernels (K1 + K3 forward, K2 + K4
    backward) on CUDA, the plain chunked path on the CPU."""
    if impl == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "chunked"
    return impl


def prepend_blank(targets: torch.Tensor, blank_idx: int) -> torch.Tensor:
    """(B, U) -> (B, U+1) with the blank symbol first."""
    col = torch.full((targets.shape[0], 1), blank_idx, dtype=targets.dtype,
                     device=targets.device)
    return torch.cat([col, targets], dim=1)


def rnnt_forward(model: RNNT, features: torch.Tensor, targets: torch.Tensor,
                 *, training: bool = False,
                 generator: torch.Generator | None = None,
                 feat_lens: torch.Tensor | None = None):
    """Encoder + predictor.  Returns (audio (B, T', H), text (B, U+1, H),
    new_state): the batch-norm running statistics after this forward (the
    current ones outside training).  A generator of None turns dropout off,
    as ``rng=None`` does in JAX.  ``feat_lens`` are the valid feature
    frames, which the FastConformer masks its attention by."""
    with span("predictor"):
        text = predictor_apply(model.predictor,
                               prepend_blank(targets, model.spec.blank_idx),
                               training, generator)
    new_state: dict = {}
    with span("encoder"):
        audio = model.encoder(features, training, generator, new_state, lengths=feat_lens)
    return audio, text, {**model.norm_state(), **new_state}
