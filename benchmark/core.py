"""What every cell shares: finding a cell's files by name, the run's
clock and counters, the profiler's reading, the per-layer readers and the
result line.

A cell of ``BENCHMARK.json`` names a configuration (its JSON under
``benchmark/configs``) and a traffic mix (``benchmark/traffic/<mix>.json``,
whose ``kind`` names the driver ``benchmark/drivers/<kind>.py``); its
limits are in ``benchmark/cells/<cell>.json``; each per-layer metric is
read by ``benchmark/layers/<metric>.py``; a configuration's ``reference``
key names its architecture, whose plain model is
``benchmark/reference/<arch>.py`` and whose operation count is
``benchmark/cost/<arch>.py``.  Nothing here names a cell, a
configuration, an architecture or a metric, so a new one is new files and
an entry.
"""

from __future__ import annotations

import contextlib
import heapq
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rnnt_tpu")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux /proc), or
    now where that is not readable."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Cell:
    """One entry of ``workloads`` with its configuration, mix, limits and
    metrics, read from ``bench`` (BENCHMARK.json's dict) under ``root``."""

    def __init__(self, name: str, bench: dict, root: Path = ROOT):
        self.name = name
        self.root = root
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry
        cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.conf = json.loads((root.parent / cfg_entry["file"]).read_text())
        self.mix = json.loads((root / "traffic" / f"{entry['traffic']}.json").read_text())
        self.limits = json.loads((root / "cells" / f"{name}.json").read_text())["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def driver(self):
        kind = self.mix["kind"]
        path = self.root / "drivers" / f"{kind}.py"
        return load_file(f"benchmark_driver_{kind}", path)

    def architecture(self, part: str):
        """The configuration's architecture's module under ``part``
        (``reference`` or ``cost``): ``benchmark/<part>/<arch>.py``."""
        arch = self.conf.get("reference")
        if not arch:
            raise SystemExit(f"configuration {self.entry['config']!r} has no 'reference' "
                             "key naming its architecture")
        path = self.root / part / f"{arch}.py"
        if not path.is_file():
            raise SystemExit(f"configuration {self.entry['config']!r} names the "
                             f"architecture {arch!r}, but {path} is missing")
        return load_file(f"benchmark_{part}_{arch}", path)


def load_file(modname: str, path: Path):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_layer(root: Path, name: str, run) -> float | None:
    path = root / "layers" / f"{name}.py"
    return load_file(f"benchmark_layer_{name}", path).read(run)


class Run:
    """A run's settings, clock and counters.  A driver adds to
    ``counters`` (cumulative counts) and ``values`` (readings), calls
    ``window_started`` and then ``tick`` as its window goes, so that with
    ``--trace 1`` the profiler covers the first ``trace_seconds``; the
    rest of the window runs untraced (``untraced``)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, started: float):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.started = device, started
        self.kind = cell.mix["kind"]
        self.counters: dict = {}
        self.values: dict = {}
        self.snapshot = None       # (counters at trace start, at trace stop)
        self.traced: dict | None = None
        self._prof = None
        self._trace_end = None
        self._untraced = None      # (perf_counter, counters) once the trace stopped
        self.setup_s = None
        self.spans: list = []

    def window_started(self) -> None:
        self.setup_s = time.time() - self.started
        if not self.trace:
            return
        from torch.profiler import ProfilerActivity, profile

        # The card's activity only: tracing the host's operations too slows
        # a host-bound step several times over.  The benchmark's own spans
        # (``span``) say what the host was doing.
        acts = [ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t_trace = time.time_ns()
        self._trace_end = time.perf_counter() + min(self.seconds,
                                                    self.cell.mix.get("trace_seconds", 4))
        self._snap0 = dict(self.counters)

    def tick(self) -> None:
        if self._prof is not None and time.perf_counter() >= self._trace_end:
            self.stop_trace()

    def stop_trace(self) -> None:
        if self._prof is None:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.snapshot = (self._snap0, dict(self.counters))
        self.traced = summarize(prof, self._t_trace, t1, self.spans)
        # The profiler's teardown and the summary above are the harness's
        # own cost: what follows is timed apart from them.
        self._untraced = (time.perf_counter(), dict(self.counters))

    def untraced(self, key: str, end: float) -> tuple[float, float] | None:
        """(the counter's growth, seconds) from the trace's stop to ``end``
        (``time.perf_counter()``), or None where the trace did not stop
        before ``end``."""
        if self._untraced is None or self._untraced[0] >= end:
            return None
        t, snap = self._untraced
        return self.counters.get(key, 0) - snap.get(key, 0), end - t

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own, on the profiler's clock."""
        if self._prof is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name, True))

    def delta(self, key: str) -> float:
        a, b = self.snapshot
        return b.get(key, 0) - a.get(key, 0)


def summarize(prof, t0_ns: int, t1_ns: int, spans=()) -> dict:
    """Over the traced window [t0_ns, t1_ns] (the profiler's clock, which is
    ``time.time_ns()``): device busy seconds (the union of the device's
    activity), kernel launches, device time by kernel name, and the idle
    gaps named by the benchmark's span running at their middle (and, on the
    CPU, the host operation the profiler recorded there)."""
    from torch.autograd import DeviceType

    dev, host = [], list(spans)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():  # a host span's shadow on the device
                continue
            dev.append((max(e.start_ns(), t0_ns), min(e.start_ns() + e.duration_ns(), t1_ns),
                        e.name()))
        elif e.duration_ns() > 0:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                         e.is_user_annotation()))
    dev = sorted(d for d in dev if d[1] > d[0])
    by_name: dict[str, float] = {}
    kernels = 0
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e9
        if not n.startswith(("Memcpy", "Memset")):
            kernels += 1
    busy, gaps, last, cur = 0.0, [], t0_ns, None
    for s, t, _ in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += (cur[1] - cur[0]) / 1e9
            if s > last:
                gaps.append((last, s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
        last = max(last, t)
    if cur is not None:
        busy += (cur[1] - cur[0]) / 1e9
    if t1_ns > last:
        gaps.append((last, t1_ns))
    gaps.sort(key=lambda g: g[0] + g[1])
    mids = [(g0 + g1) / 2 for g0, g1 in gaps]
    names = zip(_covering([h for h in host if h[3]], mids),
                _covering([h for h in host if not h[3]], mids))
    named: dict[str, float] = {}
    for (g0, g1), (span, op) in zip(gaps, names):
        key = span or "outside the benchmark's spans"
        if op:
            key += f" / {op}"
        named[key] = named.get(key, 0.0) + (g1 - g0) / 1e9
    return {"busy_s": busy, "window_s": (t1_ns - t0_ns) / 1e9, "kernels": kernels,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1])[:10]}


def _covering(events, times) -> list:
    """For each of the increasing ``times``, the name of the latest-started
    event still running then (the innermost, on one thread), or None."""
    events = sorted(events)
    out, active, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            heapq.heappush(active, (-events[i][0], events[i][1], events[i][2]))
            i += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][2] if active else None)
    return out


def result_line(run: Run, correct: bool, attempted: int, failed: int,
                compared: dict, device_info: dict) -> dict:
    """The result's dict; ``compared`` ({name: (value, limit)}) comes last."""
    metrics = {}
    cell = run.cell
    wanted = cell.per_layer if run.trace else cell.end_to_end
    for m in wanted:
        name = m["name"]
        if run.trace:
            value = read_layer(cell.root, name, run)
        elif name == "setup_s":
            value = run.setup_s
        else:
            value = run.values.get(name)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device_info}
    if run.trace and run.traced is not None:
        out["device"] = {**device_info, "busy_s": run.traced["busy_s"],
                         "window_s": run.traced["window_s"]}
        out["breakdown"] = {"device_ops": [[n, s] for n, s in run.traced["device_ops"][:10]],
                            "idle_gaps": [[n, s] for n, s in run.traced["idle_gaps"]]}
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each reading against its limit: correct when every one is finite and
    at most its limit."""
    compared = {k: (readings[k], limits[k]) for k in limits}
    ok = all(isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
             for v, lim in compared.values())
    return ok, compared
