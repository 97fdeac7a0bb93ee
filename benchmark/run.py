#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed on the card, the cell's shapes
warmed up) counts as ``setup_s``; the window then runs for ``--seconds``;
with ``--trace 1`` the profiler covers the window's first seconds and the
per-layer metrics are reported instead of the end-to-end ones.  After the
window the program's state is freed and the plain reference checks what
the timed path produced.  The last lines on standard error are the
numbers compared, each with its limit; the last line on standard output is
the result's JSON.  Exits 2 without a result when the cell's cards are
not there, and 3 when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402


def card_limits() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None, *, device=None, bench: dict | None = None, root: Path = core.ROOT) -> int:
    started = core.process_start()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = core.REPO / "build" / "benchmark_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    # One host thread for the host's tensor work: the timed paths only
    # launch and wait, and idle worker threads spinning on a shared host
    # add noise.
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if bench is None:
        bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cell = core.Cell(args.workload, bench, root)

    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if device is None:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{cell.name} needs {chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda")
        print(f"card: {card_limits()}", file=sys.stderr)
    device = torch.device(device)
    drv = cell.driver()
    run = core.Run(cell, args.seed, args.seconds, bool(args.trace), device, started)
    state = drv.setup(run)
    drv.window(run, state)
    run.stop_trace()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    readings, attempted, failed = drv.check(run, state)
    found = core.forbidden_modules()
    if found:
        print(f"JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    ok, compared = core.judge(readings, cell.limits)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    line = core.result_line(run, ok, attempted, failed, compared, info)
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
