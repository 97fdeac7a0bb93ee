"""Additive RNN-T joint network.

Port of ``rnnt_tpu/models/joint.py``: optional per-side projections
(disabled when configured <= 0), broadcast add over the lattice, tanh, a
linear layer to ``num_classes``; blank is the last class.  The factored
``simple`` heads of the pruned loss (ops/transducer_pruned.py) are
carried when present.

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

    @property
    def blank_idx(self) -> int:
        return self.num_classes - 1


class Joint(nn.Module):
    def __init__(self, spec: JointSpec, generator: torch.Generator,
                 simple: bool = False):
        super().__init__()
        self.spec = spec
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
    return joint.out(torch.tanh(audio[:, :, None, :] + text[:, None, :, :]))


def joint_window(joint: Joint, audio_frames: torch.Tensor,
                 text_frame: torch.Tensor) -> torch.Tensor:
    """W audio frames against one text feature per lane:
    (B, W, H) + (B, H) -> (B, W, V)."""
    audio_frames, text_frame = project_sides(joint, audio_frames, text_frame)
    return joint.out(torch.tanh(audio_frames + text_frame[:, None, :]))
