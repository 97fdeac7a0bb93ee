"""Profiling helpers: torch.profiler traces and a synchronizing timer.

The port's counterpart of ``rnnt_tpu/train/profiling.py`` (which wraps
``jax.profiler`` and ``block_until_ready``): ``trace(log_dir)`` records the
host's ops and, on a card, its kernels, and writes a Chrome trace
(gzipped JSON, which Perfetto reads) into ``log_dir``; ``start_trace`` /
``stop_trace`` are its two halves, for a trace that spans loop
iterations (``cli.train --profile``); ``time_fn`` waits for the card
before reading the clock.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile


def _activities(device) -> list:
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])


def start_trace(device=None) -> profile:
    """A running profiler: the host's ops, and CUDA's kernels when
    ``device`` (default: CUDA when there is a card) is a card."""
    prof = profile(activities=_activities(device))
    prof.start()
    return prof


def stop_trace(prof: profile, log_dir: str | Path, name: str = "trace") -> Path:
    """Stop ``prof`` and write its Chrome trace as ``log_dir/<name>.json.gz``."""
    prof.stop()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.json.gz"
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(log_dir: str | Path = "rnnt_tpu_torch_trace", device=None, name: str = "trace"):
    """Profile the block; yields the profiler, whose ``key_averages()``
    reads as usual once the block has ended and the trace is written."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        stop_trace(prof, log_dir, name)


def _cuda_devices(out) -> set:
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*map(_cuda_devices, out)) if out else set()
    return set()


def _wait(out) -> None:
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, **kwargs) -> float:
    """Mean wall-clock seconds per call of ``fn(*args, **kwargs)``, waiting
    for the cards of the tensors it returns (in tuples, lists and dicts)
    after the warm-up and after the timed calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _wait(out)
    return (time.perf_counter() - t0) / iters
