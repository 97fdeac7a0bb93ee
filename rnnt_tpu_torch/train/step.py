"""Eval forward and the exact eval loss over raw-audio batches.

Port of the evaluation half of ``rnnt_tpu/train/step.py``: wire audio is
decoded and featurized on the device, features are cast to the compute
dtype (bf16 or fp32), the encoder runs, and the loss dispatches on
``loss_impl``: ``pallas`` is K1 + K3 (ops/transducer_pallas.py), ``chunked``
the chunked joint + the alpha recursion (ops/transducer.py), ``auto`` the
first on CUDA and the second on the CPU.  The training step belongs to the
next slice.
"""

from __future__ import annotations

import numpy as np
import torch

from rnnt_tpu_torch.data.dataset import MULAW_PRESCALE, WIRE_SCALE
from rnnt_tpu_torch.models.encoder import encoder_out_len
from rnnt_tpu_torch.models.rnnt import RNNT, RNNTSpec, resolve_loss_impl, rnnt_forward
from rnnt_tpu_torch.ops.stft import FeaturizerSpec, make_featurizer
from rnnt_tpu_torch.ops.transducer import transducer_loss
from rnnt_tpu_torch.ops.transducer_pallas import transducer_loss_pallas


def compute_dtype(precision: str) -> torch.dtype:
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"precision must be bf16|fp32, got {precision!r}")
    return torch.bfloat16 if precision == "bf16" else torch.float32


def decode_wire_audio(audio: torch.Tensor) -> torch.Tensor:
    """Wire-format audio to float32: uint8 mu-law, int16 at WIRE_SCALE,
    float passes through."""
    if audio.dtype == torch.uint8:
        y = (audio.float() - 128.0) * (1.0 / 127.0)
        mag = (torch.pow(256.0, y.abs()) - 1.0) * (1.0 / 255.0)
        return torch.sign(y) * mag * (1.0 / MULAW_PRESCALE)
    if not audio.dtype.is_floating_point:
        return audio.float() * (1.0 / WIRE_SCALE)
    return audio


def feature_lens_from_samples(audio_lens: torch.Tensor,
                              fspec: FeaturizerSpec) -> torch.Tensor:
    """Frames per utterance (floor division, clamped at 0), int32."""
    if fspec.center:
        n = audio_lens // fspec.hop_length + 1
    else:
        n = (audio_lens - fspec.n_fft) // fspec.hop_length + 1
    return torch.clamp(n, min=0).to(torch.int32)


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch (data/dataset.py BatchIterator) -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_eval_forward(spec: RNNTSpec, fspec: FeaturizerSpec,
                      precision: str = "bf16"):
    """``forward(model, batch) -> (audio (B, T', H), t_lens (B,))``."""
    featurize = make_featurizer(fspec)
    dtype = compute_dtype(precision)

    def forward(model: RNNT, batch: dict):
        feats = featurize(decode_wire_audio(batch["audio"])).to(dtype)
        feat_lens = feature_lens_from_samples(batch["audio_lens"], fspec)
        return model.encoder(feats), encoder_out_len(feat_lens, spec.encoder)

    return forward


def make_loss_fn(spec: RNNTSpec, fspec: FeaturizerSpec, precision: str = "bf16"):
    """``loss_fn(model, batch) -> mean exact transducer NLL`` (eval mode).

    ``loss_impl`` auto, pallas or chunked; the pruned losses are not
    ported yet and raise."""
    if spec.loss_impl not in ("auto", "pallas", "chunked"):
        raise NotImplementedError(
            f"loss_impl {spec.loss_impl!r} is not ported to rnnt_tpu_torch yet")
    featurize = make_featurizer(fspec)
    dtype = compute_dtype(precision)

    def loss_fn(model: RNNT, batch: dict) -> torch.Tensor:
        feats = featurize(decode_wire_audio(batch["audio"])).to(dtype)
        feat_lens = feature_lens_from_samples(batch["audio_lens"], fspec)
        audio, text = rnnt_forward(model, feats, batch["targets"])
        t_lens = encoder_out_len(feat_lens, spec.encoder)
        args = (model.joint, audio, text, batch["targets"], t_lens,
                batch["target_lens"], spec.blank_idx)
        if resolve_loss_impl(spec.loss_impl, audio.device) == "pallas":
            return transducer_loss_pallas(*args)
        return transducer_loss(*args, chunk_size=spec.loss_chunk_size)

    return loss_fn
