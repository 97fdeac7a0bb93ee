"""A copy of the benchmark in a temporary directory with a tiny
configuration (the port's ``tiny_conv``) and a tiny training mix, for runs
on the CPU with the port's plain paths."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# Several test workers share the host's cores.
THREADS = 2
torch.set_num_threads(THREADS)

TRAINING_KEYS = ("precision", "clip_grad_norm", "loss_impl", "optimizer",
                 "lr_schedule", "frame_buckets", "token_buckets")
MODEL_KEYS = ("num_text_tokens", "num_total_symbols", "blank_idx", "featurizer",
              "predictor", "encoder", "joint")


def tiny_conf(port_yaml="tiny_conv", overrides=()) -> dict:
    from rnnt_tpu_torch.config.config import (
        apply_overrides, config_to_dict, load_config, resolve_config)

    ov = ["training.loss_impl=auto", "training.lr_schedule.total_steps=1000",
          "training.frame_buckets=[256]", "training.token_buckets=[16]", *overrides]
    d = json.loads(json.dumps(config_to_dict(
        apply_overrides(load_config(resolve_config(port_yaml)), ov))))
    model = {k: d[k] for k in MODEL_KEYS}
    model["training"] = {k: d["training"][k] for k in TRAINING_KEYS}
    return {"name": "tiny", "source": "tests", "port_yaml": port_yaml, "reference": "jasper",
            "overrides": ov, "changed": {}, "reduced": [], "model": model}


MIX = {"kind": "train", "batch": 4, "seconds": [1.0, 2.0], "frame_bucket": 256,
       "token_bucket": 16, "token_buckets": [16], "tokens_per_second": 4.0,
       "cache_rows": 16, "check_steps": 3, "reference_rows": 2, "trace_seconds": 0.3}
LIMITS = {"loss_gap": 4e-4, "grad_gap": 0.08, "change_gap": 0.04,
          "grad_gap_own": 0.08, "change_gap_own": 0.05}
CELL = "train-t.tiny"


@pytest.fixture
def tiny_bench(tmp_path):
    """(root of a benchmark copy, its BENCHMARK dict) with the cell
    train-t.tiny."""
    root = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "configs" / "tiny.json").write_text(json.dumps(tiny_conf()))
    (root / "traffic" / "train-t.json").write_text(json.dumps(MIX))
    (root / "cells" / f"{CELL}.json").write_text(json.dumps({"limits": LIMITS}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "benchmark/configs/tiny.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny", "traffic": "train-t",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [CELL]
    return root, bench


def run_cell(root, bench, cell, seed=7, seconds=1.0, trace=0, capsys=None):
    """Run a cell on the CPU; (exit code, the result's dict or None)."""
    from benchmark import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", bench=bench, root=root)
    if capsys is None:
        return rc, None
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 and out else None)
