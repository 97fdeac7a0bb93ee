"""Hyperparameter search:
``python -m rnnt_tpu_torch.cli.sweep --config <name or yaml> --trials N``.

Port of ``rnnt_tpu/cli/sweep.py``: the same search space (gradient clip,
the transducer gradient clamp, learning rate, predictor dropout), the same
sampler (random, and after some history half the time a jitter around a
top-half trial) and the same JSONL study (``--study``), so a study either
package wrote resumes in the other.  Each trial trains with
``train.loop.train(cfg, max_steps=...)`` on the card unless ``--device
cpu`` (without CUDA it raises) and scores the returned eval WER; a trial
that raises, or returns NaN, scores ``inf``.  ``--output-base`` holds the
trials' run directories (``<model>_sweep<i>/run-N``).
"""

from __future__ import annotations

import argparse
import json
import math
import random
from pathlib import Path

import torch

from rnnt_tpu_torch.config.config import load_config, resolve_config
from rnnt_tpu_torch.train.loop import train
from rnnt_tpu_torch.utils import resolve_device

# The JAX package's space: its reference's tuned knobs plus learning rate.
SPACE = {
    "training.clip_grad_norm": ("log", 0.5, 50.0),
    "training.rnnt_grad_clamp": ("log", 0.01, 10.0),
    "training.optimizer.lr": ("log", 5e-5, 2e-3),
    "predictor.dropout": ("uniform", 0.0, 0.5),
}


def _set_path(cfg, dotted: str, value):
    obj = cfg
    *parents, leaf = dotted.split(".")
    for p in parents:
        obj = getattr(obj, p)
    setattr(obj, leaf, type(getattr(obj, leaf))(value))


def _sample(rng: random.Random, prior: list[dict]) -> dict:
    """Random sample; with history, half the time a jitter around a
    top-half trial."""
    good = sorted((t for t in prior if math.isfinite(t["wer"])),
                  key=lambda t: t["wer"])[: max(len(prior) // 2, 1)]
    params = {}
    for key, (kind, lo, hi) in SPACE.items():
        if good and rng.random() < 0.5:
            base = rng.choice(good)["params"][key]
            jitter = rng.uniform(0.8, 1.25) if kind == "log" else rng.uniform(-0.05, 0.05)
            val = base * jitter if kind == "log" else base + jitter
        elif kind == "log":
            val = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        else:
            val = rng.uniform(lo, hi)
        params[key] = min(max(val, lo), hi)
    return params


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="tiny_conv",
                    help="config name (in rnnt_tpu_torch/config/configs) or yaml path")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--study", default="sweep_trials.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output-base", default="experiments")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # as cli.train sets them
    torch.backends.cudnn.allow_tf32 = False

    study_path = Path(args.study)
    trials = []
    if study_path.exists():
        trials = [json.loads(line) for line in study_path.read_text().splitlines()
                  if line.strip()]
        print(f"resuming study with {len(trials)} prior trials")

    rng = random.Random(args.seed + len(trials))
    for i in range(len(trials), args.trials):
        params = _sample(rng, trials)
        cfg = load_config(resolve_config(args.config))
        for k, v in params.items():
            _set_path(cfg, k, v)
        cfg.model_name = f"{cfg.model_name}_sweep{i}"
        print(f"trial {i}: {params}")
        try:
            wer = float(train(cfg, output_base=args.output_base,
                              max_steps=args.max_steps, device=dev))
            if math.isnan(wer):
                wer = float("inf")
        except Exception as e:  # a failed trial scores inf
            print(f"trial {i} failed: {type(e).__name__}: {e}")
            wer = float("inf")
        trial = {"trial": i, "params": params, "wer": wer}
        trials.append(trial)
        with open(study_path, "a") as f:
            f.write(json.dumps(trial) + "\n")
        print(f"trial {i}: wer={wer}")

    finite = [t for t in trials if math.isfinite(t["wer"])]
    if finite:
        best = min(finite, key=lambda t: t["wer"])
        print(f"best: trial {best['trial']} wer={best['wer']} {best['params']}")
    return trials


if __name__ == "__main__":
    main()
