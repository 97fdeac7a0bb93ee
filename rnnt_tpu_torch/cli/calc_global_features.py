"""Global feature statistics:
``python -m rnnt_tpu_torch.cli.calc_global_features --config <name or yaml>``.

Port of ``rnnt_tpu/cli/calc_global_features.py``: the training set's
utterances, one at a time, through the config's featurizer with its
normalization off (``mean=0, invstddev=1``), on the card unless
``--device cpu`` (without CUDA it raises); per-channel sums and squared
sums accumulate in float64 on the host, and the means and inverse
standard deviations go to ``--out`` as ``{"means": [...], "invstddev":
[...]}``, the JSON ``featurizer.global_stats`` reads.  ``--histograms
DIR`` also counts every channel's values over log-spaced bins and writes
``DIR/histograms.json`` and, when matplotlib imports,
``log_channel_<c>_histogram.png`` for the first ``--histogram-pngs``
channels (-1: all).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from rnnt_tpu_torch.config.config import build_featurizer_spec, load_config, resolve_config
from rnnt_tpu_torch.ops.stft import make_featurizer
from rnnt_tpu_torch.train.loop import _load_datasets
from rnnt_tpu_torch.utils import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="base_convjs",
                    help="config name (in rnnt_tpu_torch/config/configs) or yaml path")
    ap.add_argument("--out", default="global_features.json")
    ap.add_argument("--max-utterances", type=int, default=2000)
    ap.add_argument("--histograms", default=None, metavar="DIR",
                    help="also accumulate per-channel log-spaced value histograms "
                         "and write histograms.json (+ PNGs) into DIR")
    ap.add_argument("--histogram-bins", type=int, default=500)
    ap.add_argument("--histogram-pngs", type=int, default=1,
                    help="render PNGs for the first N channels (-1 = all; "
                         "histograms.json always has every channel)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config(resolve_config(args.config))
    # Raw feature statistics: the featurizer's normalization is off.
    fspec = dataclasses.replace(build_featurizer_spec(cfg), mean=0.0, invstddev=1.0)
    featurize = make_featurizer(fspec)
    train_ds, _ = _load_datasets(cfg)
    n_bins = fspec.num_bins
    total = np.zeros(n_bins, np.float64)
    total_sq = np.zeros(n_bins, np.float64)
    count = 0

    hist = edges = None
    if args.histograms:
        edges = np.logspace(np.log10(1e-9), np.log10(1e4), args.histogram_bins + 1)
        hist = np.zeros((n_bins, args.histogram_bins), np.int64)

    n = min(len(train_ds), args.max_utterances)
    t0 = time.time()
    with torch.inference_mode():
        for i in range(n):
            audio = np.asarray(train_ds[int(i)]["audio"]["array"], np.float32)
            if fspec.num_frames(len(audio)) == 0:
                continue
            feats = featurize(torch.from_numpy(audio).to(dev)).cpu().numpy()  # (frames, bins)
            total += feats.sum(axis=0)
            total_sq += (feats ** 2).sum(axis=0)
            count += feats.shape[0]
            if hist is not None:
                idx = np.clip(np.digitize(feats, edges) - 1, 0, args.histogram_bins - 1)
                for c in range(n_bins):
                    hist[c] += np.bincount(idx[:, c], minlength=args.histogram_bins)
            if (i + 1) % 200 == 0:
                print(f"{i + 1}/{n} utterances, {count} frames")
    seconds = time.time() - t0

    mean = total / count
    var = total_sq / count - mean ** 2
    invstddev = 1.0 / np.sqrt(np.maximum(var, 1e-10))
    with open(args.out, "w") as f:
        json.dump({"means": mean.tolist(), "invstddev": invstddev.tolist()}, f)
    print(f"wrote {args.out}: {count} frames over {n} utterances in {seconds:.2f} s "
          f"on {dev} ({n / max(seconds, 1e-9):.1f} utterances/s)")
    if hist is not None:
        _write_histograms(args.histograms, hist, edges, n_pngs=args.histogram_pngs)
    return {"means": mean, "invstddev": invstddev, "frames": count, "utterances": n,
            "seconds": seconds}


def _write_histograms(out_dir: str, hist: np.ndarray, edges: np.ndarray,
                      n_pngs: int = -1) -> None:
    """histograms.json (counts and edges) and one PNG per channel, named
    ``log_channel_<c>_histogram.png``, when matplotlib is installed."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "histograms.json"), "w") as f:
        json.dump({"log_bin_edges": edges.tolist(), "counts": hist.tolist()}, f)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"wrote {out_dir}/histograms.json (matplotlib unavailable — "
              f"skipping PNGs)")
        return
    centers = (edges[:-1] + edges[1:]) / 2
    widths = np.diff(edges)
    n = hist.shape[0] if n_pngs < 0 else min(n_pngs, hist.shape[0])
    for c in range(n):
        plt.figure(figsize=(10, 6))
        plt.bar(centers, hist[c], align="center", width=widths, edgecolor="black")
        plt.xscale("log")
        plt.title(f"Logarithmic Histogram of Channel {c} Values")
        plt.xlabel("Value (log scale)")
        plt.ylabel("Count")
        plt.savefig(os.path.join(out_dir, f"log_channel_{c}_histogram.png"))
        plt.close()
    print(f"wrote {out_dir}: histograms.json + {n} PNGs")


if __name__ == "__main__":
    main()
