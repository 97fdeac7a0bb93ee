"""The training loop and the evaluation pass.

Port of ``rnnt_tpu/train/loop.py``:

* ``evaluate`` — ``run_eval`` with the setup at ``:319-334``: for each eval
  batch, the exact eval loss (a pruned training objective is scored with
  the chunked exact loss), the eval forward and the batched greedy decode,
  then corpus WER against the references.
* ``train`` — ``train`` at ``:149-498`` on its streamed single-process
  path: epochs over a shuffled ``BatchIterator`` (seed = epoch) behind a
  ``PrefetchIterator``, the pruned-warmup switch by step, metrics to
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
from rnnt_tpu_torch.data.dataset import BatchIterator, Buckets, synthetic_dataset
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
    """The dropout generator of one step, on ``device``: seeded from the run
    seed and the step (the reference folds the step into its key), so a
    resumed run draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed(
        (42 + 1009 * seed) * 1_000_003 + step)


def _check_ported(cfg: Config) -> None:
    dc = cfg.data
    if dc.staging not in ("auto", "stream", "device"):
        raise ValueError(f"data.staging must be auto|stream|device, "
                         f"got {dc.staging!r}")
    if dc.staging == "device":
        raise NotImplementedError(
            "data.staging: device (the on-card corpus cache) is not ported to "
            "rnnt_tpu_torch yet: slice 3; use staging auto or stream")
    if cfg.mesh.data > 1 or cfg.mesh.model > 1:
        raise NotImplementedError(
            f"a mesh of data={cfg.mesh.data}, model={cfg.mesh.model} is not "
            "ported to rnnt_tpu_torch yet (multi-GPU is slice 4); use one card")
    if dc.augment:
        raise NotImplementedError(
            "data.augment (host augmentation and device augmentation, K5) is "
            "not ported to rnnt_tpu_torch yet: slice 3; set data.augment=false")


def train(cfg: Config, *, output_base: str | Path = "experiments",
          resume: str | None = None, max_steps: int | None = None,
          device=None) -> float:
    """Train per ``cfg`` on one card (CUDA unless ``device="cpu"``); return
    the last eval WER.

    Batches stream from the host: ``data.staging: auto`` streams, since the
    device-resident corpus cache is slice 3 (``staging: device`` raises), as
    do a data or model mesh larger than 1, data augmentation and a
    non-synthetic dataset.  A run writes ``<output_base>/<model>/run-N`` with
    config.yaml, metrics.jsonl and ``checkpoint_step_<step>`` directories."""
    dev = resolve_device(device)
    _check_ported(cfg)
    tc = cfg.training
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    train_ds, _ = _load_datasets(cfg)
    buckets = Buckets.from_frames(tc.frame_buckets, tc.token_buckets, fspec)

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
                              spec_augment=tc.spec_augment)
    # k2-style pruned warmup: the exact loss (+ simple heads) for the first
    # pruned_warmup_steps, then the banded loss; chosen by step, so resume
    # picks the right one.
    warm_fn, warmup_until = None, 0
    if spec.loss_impl == "pruned" and tc.pruned_warmup_steps > 0:
        warmup_until = tc.pruned_warmup_steps
        warm_fn = make_train_step(
            dataclasses.replace(spec, loss_impl="pruned_warmup"), fspec,
            optimizer, tc.precision, spec_augment=tc.spec_augment)

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

    model.train()
    done = state.step >= total_steps
    for epoch in range(max(tc.num_epochs, 1)):
        if done:
            break
        it = BatchIterator(train_ds, tokenizer, buckets,
                           batch_size=tc.global_batch_size, shuffle=True,
                           seed=epoch, wire_dtype=cfg.data.wire_dtype)
        for batch in PrefetchIterator(it, depth=4):
            fn = warm_fn if warm_fn is not None and state.step < warmup_until else step_fn
            before = launch_counts()
            state, metrics = fn(state, batch_to_device(batch, dev),
                                step_generator(dev, tc.seed, state.step))
            launched = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
            audio_secs += float(batch["audio_lens"].sum()) / fspec.sample_rate
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
