"""Additive RNN-T joint network.

Port of ``rnnt_tpu/models/joint.py``: optional per-side projections
(disabled when configured <= 0), broadcast add over the lattice, the
spec's activation (``tanh``, or ``relu`` as NeMo's RNN-T joint has it), a
linear layer to ``num_classes``; blank is the last class.  The factored
``simple`` heads of the pruned loss (ops/transducer_pruned.py) are
carried when present.

On a tensor-parallel mesh (``parallel/mesh.shard_params``) ``out`` and the
simple heads hold this rank's columns of V (``tp_mesh`` set); the losses
then run the V-sharded joint of ``parallel/partition.py``.  Decoding and
``joint_apply`` take a whole joint.

``joint_apply`` materializes (B, T, U, V) logits and is for tests only;
the eval loss runs the joint chunk-wise (ops/transducer.py) or fused in
the K1 kernel (ops/transducer_pallas.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from rnnt_tpu_torch.ops.causal_conv import Linear


@dataclass(frozen=True)
class JointSpec:
    audio_features: int
    text_features: int
    hidden_features: int
    num_classes: int
    activation: str = "tanh"  # tanh | relu

    @property
    def blank_idx(self) -> int:
        return self.num_classes - 1


ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def activation_fn(name: str):
    """The joint activation called ``name``."""
    if name not in ACTIVATIONS:
        raise ValueError(f"joint.activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {name!r}")
    return ACTIVATIONS[name]


class Joint(nn.Module):
    tp_mesh = None  # the mesh when ``out`` and the heads hold this rank's V

    def __init__(self, spec: JointSpec, generator: torch.Generator,
                 simple: bool = False):
        super().__init__()
        self.spec = spec
        self.act = activation_fn(spec.activation)
        self.out = Linear(spec.hidden_features, spec.num_classes, generator)
        if spec.audio_features > 0:
            self.audio_proj = Linear(spec.audio_features, spec.hidden_features,
                                     generator)
        if spec.text_features > 0:
            self.text_proj = Linear(spec.text_features, spec.hidden_features,
                                    generator)
        if simple:
            da = spec.audio_features if spec.audio_features > 0 else spec.hidden_features
            dt = spec.text_features if spec.text_features > 0 else spec.hidden_features
            self.simple = nn.ModuleDict({
                "am": Linear(da, spec.num_classes, generator),
                "lm": Linear(dt, spec.num_classes, generator)})


def project_sides(joint: Joint, audio: torch.Tensor, text: torch.Tensor):
    """Apply the optional per-side projections (no lattice yet)."""
    if hasattr(joint, "audio_proj"):
        audio = joint.audio_proj(audio)
    if hasattr(joint, "text_proj"):
        text = joint.text_proj(text)
    return audio, text


def joint_apply(joint: Joint, audio: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """audio (B, T, H) + text (B, U, H) -> logits (B, T, U, V)."""
    audio, text = project_sides(joint, audio, text)
    return joint.out(joint.act(audio[:, :, None, :] + text[:, None, :, :]))


def joint_single(joint: Joint, audio_frame: torch.Tensor,
                 text_frame: torch.Tensor) -> torch.Tensor:
    """One (t, u) per lane: (B, H) + (B, H) -> (B, V)."""
    audio_frame, text_frame = project_sides(joint, audio_frame, text_frame)
    return joint.out(joint.act(audio_frame + text_frame))


def joint_window(joint: Joint, audio_frames: torch.Tensor,
                 text_frame: torch.Tensor) -> torch.Tensor:
    """W audio frames against one text feature per lane:
    (B, W, H) + (B, H) -> (B, W, V)."""
    audio_frames, text_frame = project_sides(joint, audio_frames, text_frame)
    return joint.out(joint.act(audio_frames + text_frame[:, None, :]))
