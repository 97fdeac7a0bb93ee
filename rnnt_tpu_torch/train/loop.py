"""The training loop and the evaluation pass.

Port of ``rnnt_tpu/train/loop.py``:

* ``evaluate`` — ``run_eval`` with the setup at ``:319-334``: for each eval
  batch, the exact eval loss (a pruned training objective is scored with
  the chunked exact loss), the eval forward and the batched greedy decode,
  then corpus WER against the references.
* ``train`` — ``train`` at ``:149-498`` on one process: the augmentor
  chosen as at ``:173-203`` (host recipe, device recipe or both), the
  staging as at ``:280-318`` (the on-card corpus cache of
  data/device_cache.py under ``staging: auto`` or ``device`` when there is
  no host augmentor and the corpus fits its budget, else batches streamed
  from a ``BatchIterator`` with the data's worker pool behind a
  ``PrefetchIterator``), epochs in the cache's or the iterator's order
  (seed = epoch), the pruned-warmup switch by step, metrics to
  ``metrics.jsonl`` and stdout every ``log_steps``, the NaN guard with its
  emergency checkpoint, periodic eval and checkpoints, a final checkpoint,
  and the last WER returned.  Each step's record in ``metrics.jsonl`` also
  holds ``launches/<kernel>``, the hand-written kernels' launches in that
  step (0 on the CPU, where their plain versions run).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from rnnt_tpu_torch.config.config import (
    Config,
    build_featurizer_spec,
    build_model_spec,
    save_config,
)
from rnnt_tpu_torch.data.augment import build_augmentor, default_augmentor
from rnnt_tpu_torch.data.augment_device import (
    DEVICE_SIDE_KINDS,
    DEVICE_SIDE_KINDS_FULL,
    host_only_default_augmentor,
    warn_stripped_param_mismatch,
)
from rnnt_tpu_torch.data.dataset import BatchIterator, Buckets, synthetic_dataset
from rnnt_tpu_torch.data.device_cache import DeviceSampleCache, gather_rows
from rnnt_tpu_torch.data.pipeline import PrefetchIterator
from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer
from rnnt_tpu_torch.decode.greedy import greedy_decode
from rnnt_tpu_torch.models.rnnt import RNNT, rnnt_init
from rnnt_tpu_torch.ops.kernels import launch_counts
from rnnt_tpu_torch.train import checkpoint as ckpt
from rnnt_tpu_torch.train.metrics import wer
from rnnt_tpu_torch.train.optim import make_optimizer
from rnnt_tpu_torch.train.step import (
    TrainState,
    batch_to_device,
    make_eval_forward,
    make_loss_fn,
    make_train_step,
)
from rnnt_tpu_torch.utils import resolve_device


def _load_tokenizer(cfg: Config) -> UnigramTokenizer:
    if cfg.tokenizer.spm_model:
        return UnigramTokenizer.from_file(cfg.tokenizer.spm_model)
    if cfg.tokenizer.vocab_json:
        return UnigramTokenizer.from_vocab_json(cfg.tokenizer.vocab_json)
    raise ValueError("config.tokenizer needs spm_model or vocab_json")


def _load_datasets(cfg: Config):
    """(train, eval) row datasets.  Only the synthetic corpus is ported."""
    dc = cfg.data
    if dc.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {dc.dataset!r} is not ported to rnnt_tpu_torch yet; "
            "use data.dataset=synthetic")
    train = synthetic_dataset(dc.synthetic_size, dc.synthetic_seconds,
                              seed=0, max_words=dc.synthetic_max_words)
    if dc.eval_on_train:
        return train, train
    evals = synthetic_dataset(max(dc.synthetic_size // 8, 8),
                              dc.synthetic_seconds, seed=1,
                              max_words=dc.synthetic_max_words)
    return train, evals


def eval_batches(cfg: Config, tokenizer: UnigramTokenizer, *,
                 batch_size: int | None = None,
                 max_batches: int | None = None) -> BatchIterator:
    """The eval stream ``evaluate`` scores by default."""
    tc = cfg.training
    fspec = build_featurizer_spec(cfg)
    _, eval_ds = _load_datasets(cfg)
    bs = batch_size or tc.global_batch_size
    return BatchIterator(
        eval_ds, tokenizer,
        Buckets.from_frames(tc.frame_buckets, tc.token_buckets, fspec),
        batch_size=bs, shuffle=False, drop_last=False,
        max_batches=max_batches or max(tc.eval_max_elements // bs, 1),
        wire_dtype=cfg.data.wire_dtype)


def evaluate(cfg: Config, model: RNNT, *, device=None, batches=None,
             batch_size: int | None = None,
             max_batches: int | None = None) -> dict:
    """Score ``model`` (already on ``device``) on the eval stream, or on the
    given numpy ``batches``.  Runs on CUDA unless ``device="cpu"``.

    Returns {"nll": mean exact NLL over batches, "wer", "utterances",
    "audio_seconds", "seconds", "loss_seconds", "decode_seconds"}: wall
    seconds of the whole pass, of the exact loss (featurize, encoder,
    predictor, joint and lattice) and of eval forward + greedy decode.
    Each phase ends by reading its result on the host, which waits for the
    card, so the phase times need no extra synchronization."""
    dev = resolve_device(device)
    tc = cfg.training
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    if batches is None:
        batches = eval_batches(cfg, tokenizer, batch_size=batch_size,
                               max_batches=max_batches)
    eval_forward = make_eval_forward(spec, fspec, tc.precision)
    exact_spec = (dataclasses.replace(spec, loss_impl="chunked")
                  if spec.loss_impl == "pruned" else spec)
    eval_loss = make_loss_fn(exact_spec, fspec, tc.precision)
    max_tokens = max(tc.token_buckets)

    originals, decoded, losses = [], [], []
    audio_seconds = loss_seconds = decode_seconds = 0.0
    t0 = time.time()
    with torch.inference_mode():
        for eb in batches:
            sb = batch_to_device(eb, dev)
            t_loss = time.time()
            losses.append(float(eval_loss(model, sb)))
            t_decode = time.time()
            loss_seconds += t_decode - t_loss
            audio, t_lens = eval_forward(model, sb)
            tokens, counts = greedy_decode(
                model.predictor, model.joint, audio, t_lens, spec.predictor,
                spec.joint, max_tokens=max_tokens)
            tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
            decode_seconds += time.time() - t_decode
            audio_seconds += float(np.sum(eb["audio_lens"])) / fspec.sample_rate
            for i in range(len(counts)):
                if eb["target_lens"][i] == 0:
                    continue
                originals.append(tokenizer.decode(
                    eb["targets"][i, : eb["target_lens"][i]]))
                decoded.append(tokenizer.decode(tokens[i, : counts[i]]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"nll": float(np.mean(losses)) if losses else float("nan"),
            "wer": wer(originals, decoded) if originals else float("nan"),
            "utterances": len(originals), "audio_seconds": audio_seconds,
            "seconds": time.time() - t0, "loss_seconds": loss_seconds,
            "decode_seconds": decode_seconds}


class MetricsLogger:
    """metrics.jsonl (and TensorBoard when tensorboardX is installed)."""

    def __init__(self, output_dir: Path):
        self.writer = None
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(logdir=str(output_dir))
        except ImportError:
            pass
        self.jsonl = open(output_dir / "metrics.jsonl", "a")

    def log(self, step: int, scalars: dict) -> None:
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, step)
        self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.jsonl.close()


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The generator of one step (augmentation draws, then dropout), on
    ``device``: seeded from the run seed and the step (the reference folds
    the step into its key), so a resumed run draws what an uninterrupted
    one would."""
    return torch.Generator(device=device).manual_seed(
        (42 + 1009 * seed) * 1_000_003 + step)


def _check_ported(cfg: Config) -> None:
    if cfg.mesh.data > 1 or cfg.mesh.model > 1:
        raise NotImplementedError(
            f"a mesh of data={cfg.mesh.data}, model={cfg.mesh.model} is not "
            "ported to rnnt_tpu_torch yet (multi-GPU is slice 4); use one card")


def select_augmentor(cfg: Config, make_augmentor=None):
    """The host augmentor of a run (None for none), as the reference picks
    it: the ``make_augmentor`` hook; else the ``data.augmentations`` list,
    without the kinds the device recipe runs when ``data.augment_device`` is
    on (a warning for each stripped op whose settings differ); else nothing
    on the host under ``augment_device: full``, the length-changing ops
    under ``augment_device: true``, the whole default recipe otherwise."""
    dc = cfg.data
    if not dc.augment:
        return None
    if make_augmentor is not None:
        return make_augmentor(cfg)
    full = dc.augment_device == "full"
    if dc.augmentations:
        aug_cfgs = dc.augmentations
        if dc.augment_device:
            skip = DEVICE_SIDE_KINDS_FULL if full else DEVICE_SIDE_KINDS
            warn_stripped_param_mismatch(
                [c for c in aug_cfgs if c.get("kind") in skip])
            aug_cfgs = [c for c in aug_cfgs if c.get("kind") not in skip]
        return build_augmentor(aug_cfgs) if aug_cfgs else None
    if full:
        return None
    if dc.augment_device:
        return host_only_default_augmentor()
    return default_augmentor()


def build_cache(cfg: Config, train_ds, tokenizer, buckets, fspec, augmentor,
                device) -> DeviceSampleCache | None:
    """The on-card corpus cache the run trains from, or None to stream:
    ``staging: auto`` caches when there is no host augmentor and the
    corpus fits ``device_cache_budget_mb``; ``device`` insists (raises with
    a host augmentor or over the budget); ``stream`` never caches."""
    dc = cfg.data
    if dc.staging not in ("auto", "stream", "device"):
        raise ValueError(f"data.staging must be auto|stream|device, "
                         f"got {dc.staging!r}")
    if dc.staging == "device" and augmentor is not None:
        raise ValueError("data.staging: device requires no host-side "
                         "augmentation (set data.augment_device: full "
                         "or data.augment: false)")
    if dc.staging == "stream" or augmentor is not None:
        return None
    cache = DeviceSampleCache.build(
        train_ds, tokenizer, buckets, wire_dtype=dc.wire_dtype,
        budget_bytes=dc.device_cache_budget_mb << 20,
        sample_rate=fspec.sample_rate, num_workers=dc.num_workers,
        device=device)
    if cache is None:
        if dc.staging == "device":
            raise ValueError(f"data.staging: device — corpus exceeds "
                             f"device_cache_budget_mb={dc.device_cache_budget_mb}")
        print("note: corpus exceeds device_cache_budget_mb; streaming batches")
    else:
        print(f"device sample cache: {cache.n_samples} samples, "
              f"{cache.nbytes() / 2**20:.1f} MiB on {device}")
    return cache


def train(cfg: Config, *, output_base: str | Path = "experiments",
          resume: str | None = None, max_steps: int | None = None,
          device=None, make_augmentor=None) -> float:
    """Train per ``cfg`` on one card (CUDA unless ``device="cpu"``); return
    the last eval WER.

    Every ``data.augment`` / ``augment_device`` / ``staging`` /
    ``training.spec_augment`` setting runs as in the reference;
    ``make_augmentor(cfg)``, when given, builds the host augmentor.  A data
    or model mesh larger than 1 and a non-synthetic dataset raise.  A run
    writes ``<output_base>/<model>/run-N`` with config.yaml, metrics.jsonl
    and ``checkpoint_step_<step>`` directories."""
    dev = resolve_device(device)
    _check_ported(cfg)
    tc = cfg.training
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    train_ds, _ = _load_datasets(cfg)
    buckets = Buckets.from_frames(tc.frame_buckets, tc.token_buckets, fspec)
    augmentor = select_augmentor(cfg, make_augmentor)
    device_augment = cfg.data.augment and cfg.data.augment_device
    cache = build_cache(cfg, train_ds, tokenizer, buckets, fspec, augmentor, dev)

    output_dir = ckpt.next_run_dir(output_base, cfg.model_name)
    save_config(cfg, output_dir / "config.yaml")
    print(f"Output directory: {output_dir}")
    steps_per_epoch = max(len(train_ds) // tc.global_batch_size, 1)
    total_steps = tc.total_steps or steps_per_epoch * tc.num_epochs
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)

    optimizer, sched = make_optimizer(tc, total_steps)
    model = rnnt_init(spec, seed=tc.seed, device=dev)
    for k in ("encoder", "predictor", "joint"):
        n = sum(p.numel() for p in getattr(model, k).parameters())
        print(f"Number of {k} parameters: {n:,}")
    state = TrainState(model, optimizer.init(dict(model.named_parameters())), 0)
    if resume:
        opt_state, step = ckpt.restore(resume, model)
        state = TrainState(model, opt_state, step)
        print(f"Resumed from {resume} at step {step}")

    step_fn = make_train_step(spec, fspec, optimizer, tc.precision,
                              spec_augment=tc.spec_augment,
                              device_augment=device_augment)
    # k2-style pruned warmup: the exact loss (+ simple heads) for the first
    # pruned_warmup_steps, then the banded loss; chosen by step, so resume
    # picks the right one.
    warm_fn, warmup_until = None, 0
    if spec.loss_impl == "pruned" and tc.pruned_warmup_steps > 0:
        warmup_until = tc.pruned_warmup_steps
        warm_fn = make_train_step(
            dataclasses.replace(spec, loss_impl="pruned_warmup"), fspec,
            optimizer, tc.precision, spec_augment=tc.spec_augment,
            device_augment=device_augment)

    logger = MetricsLogger(output_dir)
    last_wer = float("nan")
    pending: list = []  # (step, metrics of 0-d tensors, kernel launches)
    t_log = time.time()
    audio_secs = 0.0

    def flush(epoch: int) -> None:
        nonlocal pending, t_log, audio_secs
        if not pending:
            return
        last_loss = float(pending[-1][1]["loss"])  # waits for the card
        dt = time.time() - t_log
        if not np.isfinite(last_loss):
            ckpt.save(output_dir, state, cfg)
            raise FloatingPointError(
                f"non-finite loss {last_loss} at step {pending[-1][0]}; "
                f"emergency checkpoint saved to {output_dir}")
        for s, m, launched in pending:
            scalars = {"loss/train": float(m["loss"]),
                       "total_norm/train": float(m["grad_norm"]),
                       "learning_rate": sched(s - 1),
                       "input_length/train": int(m["total_target_len"]),
                       "epoch": epoch}
            scalars.update({f"total_norm/{k.split('/', 1)[1]}": float(v)
                            for k, v in m.items() if k.startswith("grad_norm/")})
            scalars.update({f"launches/{k}": n for k, n in launched.items()})
            logger.log(s, scalars)
        sps = len(pending) / dt if dt > 0 else 0.0
        asps = audio_secs / dt if dt > 0 else 0.0
        print(f"step {pending[-1][0]}: loss={last_loss:.3f} "
              f"grad_norm={float(pending[-1][1]['grad_norm']):.3f} "
              f"{sps:.2f} steps/s {asps:.1f} audio-s/s")
        logger.log(pending[-1][0], {"steps_per_sec": sps,
                                    "audio_seconds_per_sec": asps,
                                    "step_seconds": dt / len(pending)})
        pending, audio_secs, t_log = [], 0.0, time.time()

    def run_eval() -> None:
        nonlocal last_wer, t_log
        model.eval()
        res = evaluate(cfg, model, device=dev, batch_size=tc.global_batch_size)
        model.train()
        t_log = time.time()
        if res["utterances"]:
            last_wer = res["wer"]
            logger.log(state.step, {"wer/eval": last_wer,
                                    "loss/eval_exact": res["nll"]})
            print(f"eval wer at step {state.step}: {last_wer:.4f} "
                  f"(exact nll {res['nll']:.3f})")

    def epoch_batches(epoch: int):
        """(batch on the device, its audio seconds) of one epoch: rows
        gathered from the cache in its order, or streamed batches."""
        if cache is not None:
            for gi, idx in cache.epoch_batches(tc.global_batch_size, seed=epoch):
                yield (gather_rows(cache.groups[gi], idx),
                       cache.batch_audio_seconds(gi, idx))
            return
        it = BatchIterator(train_ds, tokenizer, buckets,
                           batch_size=tc.global_batch_size,
                           augmentor=augmentor, shuffle=True, seed=epoch,
                           num_workers=cfg.data.num_workers,
                           worker_mode=cfg.data.worker_mode,
                           wire_dtype=cfg.data.wire_dtype)
        for batch in PrefetchIterator(it, depth=4):
            yield (batch_to_device(batch, dev),
                   float(batch["audio_lens"].sum()) / fspec.sample_rate)

    model.train()
    done = state.step >= total_steps
    for epoch in range(max(tc.num_epochs, 1)):
        if done:
            break
        for batch, seconds in epoch_batches(epoch):
            fn = warm_fn if warm_fn is not None and state.step < warmup_until else step_fn
            before = launch_counts()
            state, metrics = fn(state, batch, step_generator(dev, tc.seed, state.step))
            launched = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
            audio_secs += seconds
            pending.append((state.step, metrics, launched))
            if state.step % tc.log_steps == 0:
                flush(epoch)
            if state.step % tc.eval_steps == 0 or state.step == total_steps:
                flush(epoch)
                run_eval()
            if state.step % tc.checkpoint_steps == 0:
                ckpt.save(output_dir, state, cfg)
            if state.step >= total_steps:
                done = True
                break

    flush(max(tc.num_epochs, 1) - 1)
    if np.isnan(last_wer):
        run_eval()
    ckpt.save(output_dir, state, cfg)
    logger.close()
    return last_wer
