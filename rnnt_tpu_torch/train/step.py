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
* ``auto`` — the first on CUDA, the second on the CPU, on one rank and on
  a tensor-parallel mesh alike;
* ``pruned`` / ``pruned_warmup`` — ops/transducer_pruned.py.

``make_train_step`` returns ``step(state, batch, generator) -> (state,
metrics)``: loss, gradient, global and per-submodel gradient norms (before
the clip), the optimizer update and the new batch-norm statistics.  One
generator per step draws, in this order, the device augmentation, the
SpecAugment masks and the dropout bits, so a resumed run draws what a
straight one does; with no generator none of the three runs.

On a mesh (parallel/mesh.py) each rank's batch is its rows of the global
batch.  Every draw is made at the global batch's shape from the same
generator on every rank and sliced to the rank's rows (``RowGenerator``),
so a d-rank step computes what the 1-rank step does, and the model ranks of
one data row run identical encoders.  With ``lattice_shard_t`` and a
``model`` axis larger than 1 the loss runs the T-sharded lattice (the
chunked joint on the rank's T block, K6 and K7), and the gradients are
summed over the model group (each model rank back-propagates only its T
block of a loss the group shares) and averaged over the data group.
Otherwise a model axis is tensor-parallel (``parallel/mesh.shard_params``
cut the model): the sharded layers' collectives leave every replicated
gradient the same on the model ranks, up to the order of float sums
(cuDNN's weight-gradient algorithms and atomic adds need not give the
same bits on two ranks), and every sharded one its rank's own.  The replicated
gradients are averaged over the world, which keeps the replicas bit-equal
where GSPMD holds one logical array; the sharded ones over the data group.
The global and per-submodel norms (and the clip's) count each sharded
gradient once (``parallel/mesh.squared_norms``).  On several data ranks,
batch norms take their statistics over the data group
(``ops/norm.batch_stats_over``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rnnt_tpu_torch.data import augment, augment_device
from rnnt_tpu_torch.data.dataset import MULAW_PRESCALE, WIRE_SCALE
from rnnt_tpu_torch.models.encoder import encoder_out_len
from rnnt_tpu_torch.models.rnnt import RNNT, RNNTSpec, resolve_loss_impl, rnnt_forward
from rnnt_tpu_torch.ops.norm import batch_stats_over
from rnnt_tpu_torch.ops.stft import FeaturizerSpec, make_featurizer
from rnnt_tpu_torch.ops.transducer import transducer_loss
from rnnt_tpu_torch.ops.transducer_pallas import transducer_loss_pallas
from rnnt_tpu_torch.ops.transducer_pruned import (
    pruned_transducer_loss,
    pruned_warmup_loss,
)
from rnnt_tpu_torch.parallel.mesh import all_reduce_sum, squared_norms
from rnnt_tpu_torch.train.optim import OptState
from rnnt_tpu_torch.train.profiling import span
from rnnt_tpu_torch.utils import RowGenerator, batch_draw

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
                 device_augment: bool | str = False, mesh=None):
    """``loss_fn(model, batch, *, training=False, generator=None,
    new_state=None) -> mean loss``; in training the new batch-norm
    statistics go into ``new_state`` when a dict is given, and with a
    generator (or a ``RowGenerator``) the augmentations run.  ``mesh`` is
    read only under ``spec.lattice_shard_t``: the loss then takes the
    chunked joint and, when the mesh's ``model`` axis is larger than 1, the
    T-sharded lattice (``rnnt_tpu/train/step.py:70-77,129-142``).  A
    V-sharded joint (``model.joint.tp_mesh``) runs whichever path the
    loss resolves to on its slice of V: K1 and K2 for ``pallas``, the
    chunked joint of ``parallel/partition.py`` for ``chunked``."""
    if spec.loss_impl not in LOSS_IMPLS:
        raise ValueError(f"unknown loss_impl {spec.loss_impl!r}")
    if spec.loss_impl == "pruned" and spec.lattice_shard_t:
        raise ValueError("lattice_shard_t does not compose with "
                         "loss_impl='pruned' (the banded lattice is already "
                         "O(T*band) per rank)")
    tshard_mesh = mesh if spec.lattice_shard_t else None
    if device_augment not in (False, True, "full"):
        raise ValueError(f"device_augment must be False|True|'full', "
                         f"got {device_augment!r}")
    featurize = make_featurizer(fspec)
    dtype = compute_dtype(precision)

    def loss_fn(model: RNNT, batch: dict, *, training: bool = False,
                generator: torch.Generator | None = None,
                new_state: dict | None = None) -> torch.Tensor:
        with span("featurize"):
            wave = decode_wire_audio(batch["audio"])
            audio_lens = batch["audio_lens"]
            augmenting = training and generator is not None
            if device_augment and augmenting:
                B, L = wave.shape
                if device_augment == "full":
                    draws = batch_draw(generator, B, lambda g, n: (
                        augment_device.device_augment_full_draws(
                            g, n, L, device=wave.device)))
                    wave, audio_lens = augment_device.device_augment_full_apply(
                        draws, wave, audio_lens, fspec.sample_rate)
                else:
                    draws = batch_draw(generator, B, lambda g, n: (
                        augment_device.device_augment_draws(
                            g, n, L, device=wave.device)))
                    wave = augment_device.device_augment_apply(
                        draws, wave, audio_lens, fspec.sample_rate)
            feats = featurize(wave)
            if spec_augment and augmenting:
                B, T, F = feats.shape
                draws = batch_draw(generator, B, lambda g, n: augment.spec_augment_draws(
                    g, n, T, F, device=feats.device))
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
        with span("loss"):
            if spec.loss_impl == "pruned_warmup":
                return pruned_warmup_loss(
                    *args, simple_scale=spec.pruned_simple_scale,
                    chunk_size=spec.loss_chunk_size, grad_clamp=spec.grad_clamp)
            if spec.loss_impl == "pruned":
                return pruned_transducer_loss(
                    *args, band=spec.pruned_band,
                    simple_scale=spec.pruned_simple_scale,
                    pruned_scale=spec.pruned_scale, grad_clamp=spec.grad_clamp)
            if tshard_mesh is None and resolve_loss_impl(spec.loss_impl, audio.device) == "pallas":
                return transducer_loss_pallas(*args, grad_clamp=spec.grad_clamp)
            return transducer_loss(*args, chunk_size=spec.loss_chunk_size,
                                   grad_clamp=spec.grad_clamp, mesh=tshard_mesh)

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


def sync_grads(grads: list, scale: float, group=None) -> list:
    """The gradients summed over ``group`` (every rank when None) and
    scaled, as one flat all-reduce."""
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    flat.mul_(scale)
    return [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)]


def sync_tp_grads(names, grads: list, layout: dict, mesh) -> list:
    """Averaged gradients of a tensor-parallel (or data-parallel) mesh: the
    replicated ones over the world, the sharded ones (``layout``) over the
    data group."""
    out = list(grads)
    for sharded, scale, group in ((False, 1.0 / mesh.world, None),
                                  (True, 1.0 / mesh.data, mesh.data_group)):
        idx = [i for i, n in enumerate(names) if (n in layout) == sharded]
        if idx and (not sharded or mesh.data > 1):
            for i, g in zip(idx, sync_grads([grads[i] for i in idx], scale, group)):
                out[i] = g
    return out


def make_train_step(spec: RNNTSpec, fspec: FeaturizerSpec, optimizer,
                    precision: str = "bf16", spec_augment: bool = False,
                    device_augment: bool | str = False, mesh=None):
    """``step(state, batch, generator) -> (state, metrics)``.  ``batch``
    holds tensors on the model's device (on a ``mesh``, the rank's rows of
    the global batch); ``generator`` (on that device, or None for no
    augmentation and no dropout) draws the augmentations and the dropout
    bits.  Metrics are 0-d tensors of the global batch: loss, grad_norm
    (before the clip), total_target_len and
    grad_norm/{encoder,predictor,joint}.  The step runs in a
    ``train_step`` span with the state's step number, split into
    ``forward``, ``backward``, ``grad_norm`` and ``optimizer``
    (``train/profiling.py``)."""
    loss_fn = make_loss_fn(spec, fspec, precision, spec_augment=spec_augment,
                           device_augment=device_augment, mesh=mesh)
    multi = mesh is not None and mesh.world > 1
    # Each model rank of a T-sharded loss holds a part of the gradient, summed
    # over the world; any other gradient is complete on its model rank.
    tshard = multi and spec.lattice_shard_t and mesh.model > 1
    stats_group = mesh.data_group if multi and mesh.data > 1 else None

    def step(state: TrainState, batch: dict, generator):
        with span("train_step", step=state.step):
            model = state.model
            names, params = zip(*model.named_parameters())
            if multi and mesh.data > 1 and generator is not None:
                B = batch["target_lens"].shape[0]
                generator = RowGenerator(generator, mesh.data_rank * B, mesh.data * B)
            new_norm: dict = {}
            with span("forward"), batch_stats_over(stats_group):
                loss = loss_fn(model, batch, training=True, generator=generator,
                               new_state=new_norm)
            with span("backward"):
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g.float()
                         for p, g in zip(params, grads)]
            loss, target_len = loss.detach(), batch["target_lens"].sum()
            layout = getattr(model, "tp_layout", {})
            if tshard:
                grads = sync_grads(grads, 1.0 / mesh.data)
            elif multi:
                grads = sync_tp_grads(names, grads, layout, mesh)
            if multi:
                both = all_reduce_sum(torch.stack([loss.float(), target_len.float()]))
                loss = both[0] / mesh.world  # the model ranks' losses are equal
                target_len = torch.round(both[1] / mesh.model).long()
            named = dict(zip(names, grads))
            with span("grad_norm"):
                sq = squared_norms(named, layout, mesh)
                metrics = {"loss": loss, "grad_norm": torch.sqrt(sum(sq.values())),
                           "total_target_len": target_len}
                for sub in SUBMODELS:
                    metrics[f"grad_norm/{sub}"] = torch.sqrt(sq.get(sub, torch.zeros(())))
            with span("optimizer"):
                opt_state = optimizer.update(
                    dict(zip(names, params)), named, state.opt_state,
                    norm=lambda gs: torch.sqrt(sum(squared_norms(gs, layout, mesh).values())))
                model.commit_norm_state(new_norm)
            return TrainState(model, opt_state, state.step + 1), metrics

    return step
