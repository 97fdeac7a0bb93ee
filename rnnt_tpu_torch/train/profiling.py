"""Profiling: the port's spans, torch.profiler traces and a synchronizing
timer.

The port's counterpart of ``rnnt_tpu/train/profiling.py`` (which wraps
``jax.profiler`` and ``block_until_ready``): ``trace(log_dir)`` records the
host's ops and, on a card, its kernels, and writes a Chrome trace
(gzipped JSON, which Perfetto reads) into ``log_dir``; ``start_trace`` /
``stop_trace`` are its two halves, for a trace that spans loop
iterations (``cli.train --profile``); ``time_fn`` waits for the card
before reading the clock.

``span(name)`` marks where the program's work happens.  Off (the
default) it returns one shared object that does nothing.  Between
``start_spans()`` and ``stop_spans()`` each span is recorded in memory as
a ``Span`` on the ``time.time_ns()`` clock, the clock of the profiler's
event timestamps, so a trace's kernels can be joined to the span their
launch happened in.  While a trace of ``start_trace`` runs, each span
also opens a ``record_function`` range of its name in that trace.  The
spans:

* ``gather`` (``data/device_cache.py``): a cached batch's rows gathered;
* ``train_step`` (``train/step.py``): one training step, with
  ``forward`` (its children ``featurize``: wire decode, augmentation,
  featurizer, SpecAugment and cast; ``encoder`` and ``predictor``,
  ``models/rnnt.py``; and ``loss``, the transducer loss), ``backward``
  (the gradients and their float / zero fill; autograd's device thread
  launches the backward's kernels while this span waits), ``grad_norm``
  (the reported norms) and ``optimizer`` (the clip's norm, AdamW and the
  batch-norm statistics);
* ``launch <kernel>`` (``ops/kernels.py``): one hand-written kernel's
  launch;
* ``step N``, ``data`` and ``bookkeeping`` (``train/loop.py``): a step of
  ``cli.train``'s loop and its parts beside ``train_step``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index, in the list
    ``stop_spans`` returns, of the span enclosing it on its thread (None
    for none); ``step`` the training step's number (the steps the state
    had taken before it, ``TrainState.step``) that the latest
    ``span(..., step=n)`` set, shared by every span of that step on any
    thread; ``thread`` the OS thread id (the profiler's ``tid``);
    ``end_ns`` None for a span still open at the stop."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    step: int | None
    thread: int


class _Off:
    """The span of a program with spans off: it does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """What ``span`` does while on: ``rows`` (None when not recording)
    collects ``[name, start, end, parent row, step, thread]``; ``ranges``
    opens a ``record_function`` for each span; ``open`` holds each
    thread's innermost open row."""

    def __init__(self):
        self.rows: list | None = None
        self.ranges = False
        self.step: int | None = None
        self.open: dict = {}


_REC = _Recorder()
_on: _Recorder | None = None  # _REC while spans record or ranges open


class _Open:
    __slots__ = ("name", "step", "row", "range")

    def __init__(self, name: str, step):
        self.name, self.step = name, step

    def __enter__(self):
        rec = _REC
        if self.step is not None:
            rec.step = self.step
        tid = threading.get_native_id()
        self.row = row = [self.name, 0, None, rec.open.get(tid), rec.step, tid]
        rec.open[tid] = row
        if rec.rows is not None:
            rec.rows.append(row)
        self.range = None
        if rec.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        row[1] = time.time_ns()
        return None

    def __exit__(self, *exc):
        row = self.row
        row[2] = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _REC.open[row[5]] = row[3]
        return False


def span(name: str, step: int | None = None):
    """A context manager marking ``name``'s work; ``step`` (the training
    step's number) is given by the span that opens a step and holds for
    every span after it until the next.  With spans off: one shared
    object that does nothing."""
    if _on is None:
        return _OFF
    return _Open(name, step)


def _switch() -> None:
    global _on
    _on = _REC if _REC.rows is not None or _REC.ranges else None


def start_spans() -> None:
    """Record every span from now on (``stop_spans`` returns them)."""
    if _REC.rows is not None:
        raise RuntimeError("spans are already recording")
    _REC.rows, _REC.step = [], None
    _switch()


def stop_spans() -> list[Span]:
    """Stop recording; the spans recorded since ``start_spans``, in the
    order they opened (none when not recording)."""
    rows, _REC.rows = _REC.rows or [], None
    _switch()
    index = {id(r): i for i, r in enumerate(rows)}
    return [Span(n, t0, t1, None if p is None else index.get(id(p)), s, tid)
            for n, t0, t1, p, s, tid in rows]


def _activities(device) -> list:
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])


def start_trace(device=None) -> profile:
    """A running profiler: the host's ops, and CUDA's kernels when
    ``device`` (default: CUDA when there is a card) is a card."""
    prof = profile(activities=_activities(device))
    prof.start()
    _REC.ranges = True
    _switch()
    return prof


def stop_trace(prof: profile, log_dir: str | Path, name: str = "trace") -> Path:
    """Stop ``prof`` and write its Chrome trace as ``log_dir/<name>.json.gz``."""
    _REC.ranges = False
    _switch()
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
