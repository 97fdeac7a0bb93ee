"""The evaluation pass: exact transducer NLL and greedy-decode WER.

Port of the eval half of ``rnnt_tpu/train/loop.py`` (``run_eval`` with the
setup at ``:319-334``): for each eval batch, the exact eval loss (a pruned
training objective is scored with the chunked exact loss), the eval
forward and the batched greedy decode, then corpus WER against the
references.  The training loop belongs to the next slice.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rnnt_tpu_torch.config.config import Config, build_featurizer_spec, build_model_spec
from rnnt_tpu_torch.data.dataset import BatchIterator, Buckets, synthetic_dataset
from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer
from rnnt_tpu_torch.decode.greedy import greedy_decode
from rnnt_tpu_torch.models.rnnt import RNNT
from rnnt_tpu_torch.train.metrics import wer
from rnnt_tpu_torch.train.step import batch_to_device, make_eval_forward, make_loss_fn
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
