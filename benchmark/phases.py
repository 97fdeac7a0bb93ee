#!/usr/bin/env python3
"""The training step's device time by phase, read from the program's own
spans (``rnnt_tpu_torch/train/profiling.py``) and a trace of the card over
the same window, and what recording those spans costs.  The benchmark's
runs do not run this: it is the study the per-phase readings of PERF.md
come from, and ``attribute`` is what ``core.summarize`` would call once
``core.Run`` turns the program's spans on with its trace.

    python3 benchmark/phases.py --workload train-b32.base_convjs --seed <n> \\
            --seconds 20 --cost-windows 4 --cost-seconds 20

A traced window (the cell's own, traced as ``--trace 1`` traces it, with
the program's spans recording while the trace runs) prints one JSON line:
for each phase the card's busy ms a step (the union of the device
intervals of the operations launched inside its spans, over the steps
whose spans all lie inside the trace), the host ms a step of each span,
the idle seconds named by the innermost program span running at each
gap's middle, and the clock check: how far each K1 launch's runtime event
lies outside its ``launch joint_fwd`` span.  Then ``--cost-windows``
untraced windows of the same state, in turns without and with spans
recording (off, on, on, off, ...), print one line each with the ms a
step.

An operation finds its span through its launch: the kernel's correlation
id leads to the runtime call that launched it (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaLaunchKernelExC``, ``cudaMemsetAsync``, ...),
and that call's start to the spans running then, on any thread: the
backward's kernels are launched by autograd's device thread while the
main thread waits in ``backward``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("OMP_NUM_THREADS", "1")  # as benchmark/run.py

from benchmark import core  # noqa: E402
from benchmark.layers._common import KERNEL_NAMES  # noqa: E402

# Per-phase readings and the spans each reads (with their children).
PHASES = {"fwd_ms.train": ("forward",), "bwd_ms.train": ("backward",),
          "optim_ms.train": ("grad_norm", "optimizer"), "gather_ms.train": ("gather",)}
PHASE_OF = {span: metric for metric, spans in PHASES.items() for span in spans}
OUTSIDE = "outside the program's spans"


def kineto_events(prof, t0_ns: int, t1_ns: int) -> tuple[list, dict]:
    """From a stopped torch profiler: the card's operations clipped to
    [t0_ns, t1_ns], as sorted (start, end, name, correlation id), and the
    host's runtime and driver calls, {correlation id: (start, end)}."""
    from torch.autograd import DeviceType

    dev, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():  # a host range's shadow on the device
                continue
            s, t = max(e.start_ns(), t0_ns), min(e.start_ns() + e.duration_ns(), t1_ns)
            if t > s:
                dev.append((s, t, e.name(), e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            calls[e.correlation_id()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    return sorted(dev), calls


def covering(spans, times) -> list[list[int]]:
    """For each of the increasing ``times``, the indices of the spans (any
    thread) running then, in the order they started: the last is the
    innermost, and on one thread the others are its ancestors."""
    order = sorted(range(len(spans)), key=lambda i: spans[i].start_ns)
    out, active, k = [], [], 0
    for t in times:
        while k < len(order) and spans[order[k]].start_ns <= t:
            active.append(order[k])
            k += 1
        active = [i for i in active if spans[i].end_ns >= t]
        out.append(list(active))
    return out


def union_ns(intervals) -> int:
    total, cur = 0, None
    for s, t in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    return total + (cur[1] - cur[0] if cur is not None else 0)


def attribute(spans, dev, calls, t0_ns: int, t1_ns: int) -> dict:
    """Per-phase busy ms a step and idle seconds by span path, from the
    program's spans and the card's operations (``kineto_events``) over
    the window [t0_ns, t1_ns].  A step counts when every span of it lies
    inside the window; off the card (no operations) every reading is
    None."""
    spans = [s if s.end_ns is not None else s._replace(end_ns=t1_ns) for s in spans]
    bounds: dict = {}
    for s in spans:
        if s.step is not None:
            a, b = bounds.get(s.step, (s.start_ns, s.end_ns))
            bounds[s.step] = (min(a, s.start_ns), max(b, s.end_ns))
    stepped = {s.step for s in spans if s.name == "train_step"}
    steps = {n for n, (a, b) in bounds.items() if a >= t0_ns and b <= t1_ns and n in stepped}
    n = len(steps)
    out = {"steps": n, "spans": len(spans), "ops": len(dev), **{m: None for m in PHASES}}
    host: dict = {}
    for s in spans:
        if s.step in steps:
            host[s.name] = host.get(s.name, 0) + (s.end_ns - s.start_ns)
    out["host_ms"] = {k: v / 1e6 / n for k, v in sorted(host.items())} if n else {}
    if not dev:
        return out
    launched = sorted((calls[c][0], i) for i, (_, _, _, c) in enumerate(dev) if c in calls)
    where = dict(zip((i for _, i in launched), covering(spans, [t for t, _ in launched])))
    by_phase: dict = {m: [] for m in PHASES}
    in_steps, found = [], []
    for i, (s, t, _, _) in enumerate(dev):
        cover = where.get(i)
        if not cover:
            continue
        found.append((s, t))
        if spans[cover[-1]].step not in steps:
            continue
        in_steps.append((s, t))
        phase = next((PHASE_OF[spans[j].name] for j in cover if spans[j].name in PHASE_OF),
                     None)
        if phase is not None:
            by_phase[phase].append((s, t))
    busy = union_ns((s, t) for s, t, _, _ in dev)
    out.update({m: union_ns(v) / 1e6 / n if n else None for m, v in by_phase.items()})
    out["step_busy_ms"] = union_ns(in_steps) / 1e6 / n if n else None
    out["phase_share_pct"] = (100.0 * sum(union_ns(v) for v in by_phase.values())
                              / union_ns(in_steps)) if in_steps else None
    out["found_share_pct"] = 100.0 * union_ns(found) / busy if busy else None
    out["joined_ops"] = len(launched)
    out["idle_s"], out["outside_gaps"] = idle_by_path(spans, dev, t0_ns, t1_ns)
    return out


def idle_by_path(spans, dev, t0_ns: int, t1_ns: int) -> tuple[dict, list]:
    """The window's idle seconds, each gap named by the spans running at
    its middle, outermost first (``train_step/optimizer``; a span of
    autograd's device thread after the ``backward`` it runs in); and the 5
    longest gaps outside every span, each as (ms from the window's start,
    ms long, the span that ended last before its middle, the next to
    start)."""
    gaps, last = [], t0_ns
    for s, t, _, _ in dev:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if t1_ns > last:
        gaps.append((last, t1_ns))
    gaps.sort(key=lambda g: g[0] + g[1])
    named: dict = {}
    outside = []
    for (g0, g1), cover in zip(gaps, covering(spans, [(g0 + g1) / 2 for g0, g1 in gaps])):
        key = "/".join(spans[j].name for j in cover) if cover else OUTSIDE
        named[key] = named.get(key, 0.0) + (g1 - g0) / 1e9
        if not cover:
            mid = (g0 + g1) / 2
            before = max((s for s in spans if s.end_ns < mid), key=lambda s: s.end_ns,
                         default=None)
            after = min((s for s in spans if s.start_ns > mid), key=lambda s: s.start_ns,
                        default=None)
            outside.append(((g0 - t0_ns) / 1e6, (g1 - g0) / 1e6,
                            before and f"{before.name} {before.step}",
                            after and f"{after.name} {after.step}"))
    outside.sort(key=lambda g: -g[1])
    return dict(sorted(named.items(), key=lambda kv: -kv[1])), outside[:5]


def clock_check(spans, dev, calls, kernel: str, pattern: str) -> dict | None:
    """How far the runtime call of each launch of ``kernel``'s device
    functions (``pattern``) lies outside the ``launch <kernel>`` span
    nearest it, in ns (0 when inside), and how far after the span's start
    it began."""
    pat, name = re.compile(pattern), f"launch {kernel}"
    mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name and s.end_ns)
    outside, lead = [], []
    for _, _, op, c in dev:
        if not pat.search(op) or c not in calls or not mine:
            continue
        a, b = calls[c]
        s0, s1 = min(mine, key=lambda se: max(se[0] - a, b - se[1], 0))
        outside.append(max(s0 - a, b - s1, 0))
        lead.append(a - s0)
    if not outside:
        return None
    return {"launches": len(outside), "worst_outside_ns": max(outside),
            "lead_ns_min": min(lead), "lead_ns_max": max(lead)}


class PhaseRun(core.Run):
    """A run whose trace also records the program's spans and keeps the
    per-phase readings (``phases``) of the traced window."""

    phases: dict | None = None

    def window_started(self) -> None:
        from rnnt_tpu_torch.train import profiling

        super().window_started()
        if self._prof is not None:
            profiling.start_spans()

    def stop_trace(self) -> None:
        from rnnt_tpu_torch.train import profiling

        prof = self._prof
        if prof is None:
            return
        spans = profiling.stop_spans()
        super().stop_trace()
        t0 = self._t_trace
        t1 = t0 + round(self.traced["window_s"] * 1e9)
        dev, calls = kineto_events(prof, t0, t1)
        self.program_spans = spans
        self.phases = attribute(spans, dev, calls, t0, t1)
        self.phases["clock_k1"] = clock_check(spans, dev, calls, "joint_fwd",
                                              KERNEL_NAMES["joint_fwd"])
        # This reading is the study's own cost, like the profiler's teardown.
        self._untraced = (time.perf_counter(), dict(self.counters))


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv=None, *, device=None, bench: dict | None = None, root: Path = core.ROOT) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--cost-windows", type=int, default=0)
    ap.add_argument("--cost-seconds", type=float, default=20.0)
    a = ap.parse_args(argv)
    import torch

    from rnnt_tpu_torch.train import profiling

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if bench is None:
        bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cell = core.Cell(a.workload, bench, root)
    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA card", file=sys.stderr)
            return 2
        device = "cuda"
        from benchmark.run import card_limits

        print(f"card: {card_limits()}", file=sys.stderr)
    device = torch.device(device)
    drv = cell.driver()
    run = PhaseRun(cell, a.seed, a.seconds, True, device, core.process_start())
    st = drv.setup(run)
    drv.window(run, st)
    run.stop_trace()
    layers = {m["name"]: core.read_layer(cell.root, m["name"], run) for m in cell.per_layer}
    emit(study="phases", cell=cell.name, seed=a.seed, device=str(device),
         busy_s=run.traced["busy_s"], window_s=run.traced["window_s"],
         breakdown_idle=run.traced["idle_gaps"], layers=layers, **run.phases)
    print(f"phases: fwd+bwd+optim+gather {run.phases.get('phase_share_pct')} % of the "
          f"counted steps' busy time; {run.phases.get('found_share_pct')} % of the "
          "window's busy time found a launching span", file=sys.stderr)
    for k in range(a.cost_windows):
        on = k % 4 in (1, 2)
        r = core.Run(cell, a.seed, a.cost_seconds, False, device, time.time())
        if on:
            profiling.start_spans()
        try:
            drv.window(r, st)
        finally:
            recorded = len(profiling.stop_spans()) if on else 0
        steps = r.counters["steps"]
        secs = r.counters["audio_s"] / r.values["train_audio_per_s"]
        emit(study="span_cost", cell=cell.name, seed=a.seed, window=k,
             spans="on" if on else "off", steps=steps, spans_recorded=recorded,
             ms_per_step=1e3 * secs / steps, train_audio_per_s=r.values["train_audio_per_s"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
