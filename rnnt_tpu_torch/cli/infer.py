"""Infer CLI: ``python -m rnnt_tpu_torch.cli.infer <checkpoint_dir> <wav>``.

Port of ``rnnt_tpu/cli/infer.py``: decode one 16-bit WAV file (mono, or
channels averaged) at the featurizer's sample rate and print the text.
Offline, the eval forward (``train/step.make_eval_forward``, at the
config's precision) and greedy decode of at most 400 tokens; with
``--streaming``, chunks of ``--chunk-ms`` through a ``StreamingSession``.
Runs on CUDA unless ``--device cpu``; without CUDA it raises.
``--set key.path=value`` overrides the checkpoint's config.
"""

from __future__ import annotations

import argparse
import wave

import numpy as np
import torch

from rnnt_tpu_torch.compat.jax_params import find_config, load_checkpoint
from rnnt_tpu_torch.config.config import (
    apply_overrides, build_featurizer_spec, build_model_spec, load_config)
from rnnt_tpu_torch.decode.greedy import greedy_decode
from rnnt_tpu_torch.decode.streaming import StreamingSession
from rnnt_tpu_torch.train.loop import _load_tokenizer
from rnnt_tpu_torch.train.step import make_eval_forward
from rnnt_tpu_torch.utils import resolve_device


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """A 16-bit WAV file as float32 samples in [-1, 1) and its rate."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit samples, got "
                             f"{8 * w.getsampwidth()}-bit")
        sr, ch = w.getframerate(), w.getnchannels()
        raw = w.readframes(w.getnframes())
    data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="checkpoint directory")
    ap.add_argument("wav")
    ap.add_argument("--config", default=None,
                    help="config yaml (default: next to checkpoint)")
    ap.add_argument("--streaming", action="store_true",
                    help="decode chunk by chunk through the streaming session")
    ap.add_argument("--chunk-ms", type=int, default=200)
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = apply_overrides(load_config(args.config or find_config(args.checkpoint)),
                          args.overrides)
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    model = load_checkpoint(args.checkpoint, spec, dev)

    audio, sr = read_wav(args.wav)
    if sr != fspec.sample_rate:
        raise ValueError(f"expected {fspec.sample_rate} Hz input, got {sr}")

    if args.streaming:
        session = StreamingSession(model, fspec)
        chunk = int(sr * args.chunk_ms / 1000)
        for i in range(0, len(audio), chunk):
            session.feed(audio[i:i + chunk])
        ids = session.tokens()
    else:
        forward = make_eval_forward(spec, fspec, cfg.training.precision)
        batch = {"audio": torch.from_numpy(audio[None, :]).to(dev),
                 "audio_lens": torch.tensor([len(audio)], dtype=torch.int32, device=dev)}
        with torch.inference_mode():
            enc, t_lens = forward(model, batch)
            tokens, counts = greedy_decode(
                model.predictor, model.joint, enc, t_lens, spec.predictor,
                spec.joint, max_tokens=400)
        ids = tokens[0, : int(counts[0])].cpu().tolist()
    text = tokenizer.decode(ids)
    print(text)
    return text


if __name__ == "__main__":
    main()
