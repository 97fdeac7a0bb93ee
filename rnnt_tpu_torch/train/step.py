"""The train step, the eval forward and the loss over raw-audio batches.

Port of ``rnnt_tpu/train/step.py``, in its order: wire audio is decoded on
the device; in training, device augmentation (``device_augment``: True for
the chorus / compressor / noise / peak half, "full" for the whole recipe
with new lens, data/augment_device.py) runs on it; it is featurized;
in training, SpecAugment masks the features (``spec_augment``); features
are cast to the compute dtype (bf16 or fp32); the frame counts come from
the (new) lens; the encoder and predictor run (in training with dropout
and batch-norm batch statistics); and the loss dispatches on
``loss_impl``:

* ``pallas`` — K1 + K3 forward, K2 + K4 backward (ops/transducer_pallas.py);
* ``chunked`` — the chunked joint under checkpoint + the lattice DP
  (ops/transducer.py);
* ``auto`` — the first on CUDA, the second on the CPU;
* ``pruned`` / ``pruned_warmup`` — ops/transducer_pruned.py.

``make_train_step`` returns ``step(state, batch, generator) -> (state,
metrics)``: loss, gradient, global and per-submodel gradient norms (before
the clip), the optimizer update and the new batch-norm statistics.  One
generator per step draws, in this order, the device augmentation, the
SpecAugment masks and the dropout bits, so a resumed run draws what a
straight one does; with no generator none of the three runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rnnt_tpu_torch.data import augment, augment_device
from rnnt_tpu_torch.data.dataset import MULAW_PRESCALE, WIRE_SCALE
from rnnt_tpu_torch.models.encoder import encoder_out_len
from rnnt_tpu_torch.models.rnnt import RNNT, RNNTSpec, resolve_loss_impl, rnnt_forward
from rnnt_tpu_torch.ops.stft import FeaturizerSpec, make_featurizer
from rnnt_tpu_torch.ops.transducer import transducer_loss
from rnnt_tpu_torch.ops.transducer_pallas import transducer_loss_pallas
from rnnt_tpu_torch.ops.transducer_pruned import (
    pruned_transducer_loss,
    pruned_warmup_loss,
)
from rnnt_tpu_torch.train.optim import OptState

LOSS_IMPLS = ("auto", "pallas", "chunked", "pruned", "pruned_warmup")
SUBMODELS = ("encoder", "predictor", "joint")


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


def make_loss_fn(spec: RNNTSpec, fspec: FeaturizerSpec, precision: str = "bf16",
                 spec_augment: bool = False,
                 device_augment: bool | str = False):
    """``loss_fn(model, batch, *, training=False, generator=None,
    new_state=None) -> mean loss``; in training the new batch-norm
    statistics go into ``new_state`` when a dict is given, and with a
    generator the augmentations run."""
    if spec.loss_impl not in LOSS_IMPLS:
        raise ValueError(f"unknown loss_impl {spec.loss_impl!r}")
    if device_augment not in (False, True, "full"):
        raise ValueError(f"device_augment must be False|True|'full', "
                         f"got {device_augment!r}")
    featurize = make_featurizer(fspec)
    dtype = compute_dtype(precision)

    def loss_fn(model: RNNT, batch: dict, *, training: bool = False,
                generator: torch.Generator | None = None,
                new_state: dict | None = None) -> torch.Tensor:
        wave = decode_wire_audio(batch["audio"])
        audio_lens = batch["audio_lens"]
        augmenting = training and generator is not None
        if device_augment and augmenting:
            B, L = wave.shape
            if device_augment == "full":
                draws = augment_device.device_augment_full_draws(
                    generator, B, L, device=wave.device)
                wave, audio_lens = augment_device.device_augment_full_apply(
                    draws, wave, audio_lens, fspec.sample_rate)
            else:
                draws = augment_device.device_augment_draws(
                    generator, B, L, device=wave.device)
                wave = augment_device.device_augment_apply(
                    draws, wave, audio_lens, fspec.sample_rate)
        feats = featurize(wave)
        if spec_augment and augmenting:
            draws = augment.spec_augment_draws(generator, *feats.shape,
                                               device=feats.device)
            feats = augment.spec_augment_apply(feats, draws)
        feats = feats.to(dtype)
        feat_lens = feature_lens_from_samples(audio_lens, fspec)
        audio, text, state = rnnt_forward(model, feats, batch["targets"],
                                          training=training, generator=generator)
        if new_state is not None:
            new_state.update(state)
        t_lens = encoder_out_len(feat_lens, spec.encoder)
        args = (model.joint, audio, text, batch["targets"], t_lens,
                batch["target_lens"], spec.blank_idx)
        if spec.loss_impl == "pruned_warmup":
            return pruned_warmup_loss(
                *args, simple_scale=spec.pruned_simple_scale,
                chunk_size=spec.loss_chunk_size, grad_clamp=spec.grad_clamp)
        if spec.loss_impl == "pruned":
            return pruned_transducer_loss(
                *args, band=spec.pruned_band,
                simple_scale=spec.pruned_simple_scale,
                pruned_scale=spec.pruned_scale, grad_clamp=spec.grad_clamp)
        if resolve_loss_impl(spec.loss_impl, audio.device) == "pallas":
            return transducer_loss_pallas(*args, grad_clamp=spec.grad_clamp)
        return transducer_loss(*args, chunk_size=spec.loss_chunk_size,
                               grad_clamp=spec.grad_clamp)

    return loss_fn


@dataclass
class TrainState:
    """The model (parameters and batch-norm statistics), the optimizer
    state and the number of steps taken."""
    model: RNNT
    opt_state: OptState
    step: int = 0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, float32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def make_train_step(spec: RNNTSpec, fspec: FeaturizerSpec, optimizer,
                    precision: str = "bf16", spec_augment: bool = False,
                    device_augment: bool | str = False):
    """``step(state, batch, generator) -> (state, metrics)``.  ``batch``
    holds tensors on the model's device; ``generator`` (on that device, or
    None for no augmentation and no dropout) draws the augmentations and
    the dropout bits.  Metrics are 0-d tensors: loss, grad_norm (before the
    clip), total_target_len and grad_norm/{encoder,predictor,joint}."""
    loss_fn = make_loss_fn(spec, fspec, precision, spec_augment=spec_augment,
                           device_augment=device_augment)

    def step(state: TrainState, batch: dict, generator):
        model = state.model
        names, params = zip(*model.named_parameters())
        new_norm: dict = {}
        loss = loss_fn(model, batch, training=True, generator=generator,
                       new_state=new_norm)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(params, grads)]
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads),
                   "total_target_len": batch["target_lens"].sum()}
        for sub in SUBMODELS:
            metrics[f"grad_norm/{sub}"] = global_norm(
                [g for n, g in zip(names, grads) if n.split(".")[0] == sub])
        opt_state = optimizer.update(dict(zip(names, params)),
                                     dict(zip(names, grads)), state.opt_state)
        model.commit_norm_state(new_norm)
        return TrainState(model, opt_state, state.step + 1), metrics

    return step
