"""``benchmark/phases.py``: device operations joined to the program's
spans, on synthetic profiler events and in a tiny traced run on the CPU."""

from __future__ import annotations

import json

import pytest

from benchmark import phases
from benchmark.tests.conftest import CELL
from rnnt_tpu_torch.train.profiling import Span

MAIN, AUTOGRAD = 100, 200
WINDOW = (0, 1000)


def _step(n, at, spans):
    """Spans of step ``n`` starting at ``at`` (ns), in opening order:
    gather 0-10, train_step 10-100 > forward 10-40 > loss 30-40 > launch
    joint_fwd 32-36, backward 40-70 (autograd's launch joint_bwd 50-55),
    grad_norm 70-80, optimizer 80-100."""
    def add(name, a, b, parent, thread=MAIN):
        spans.append(Span(name, at + a, at + b, parent, n, thread))
        return len(spans) - 1

    add("gather", 0, 10, None)
    root = add("train_step", 10, 100, None)
    fwd = add("forward", 10, 40, root)
    loss = add("loss", 30, 40, fwd)
    add("launch joint_fwd", 32, 36, loss)
    add("backward", 40, 70, root)
    add("launch joint_bwd", 50, 55, None, AUTOGRAD)
    add("grad_norm", 70, 80, root)
    add("optimizer", 80, 100, root)


def _events():
    """Steps 1 and 2 inside the window, step 3 straddling its end; each
    step launches one operation a phase, each running for 10 ns after its
    launch, and K1 inside its launch span."""
    spans = []
    for n, at in ((1, 0), (2, 200), (3, 950)):
        _step(n, at, spans)
    dev, calls, corr = [], {}, 0
    for at in (0, 200, 950):
        for launch, name in ((5, "gather_kernel"), (20, "conv_fwd"),
                             (33, "sm90::gemm_kernel<(anonymous namespace)::LsePass>"),
                             (52, "dgrad_engine"), (75, "reduce_kernel"),
                             (90, "adam_elementwise")):
            corr += 1
            calls[corr] = (at + launch, at + launch + 1)
            s = at + launch + 100
            if s < WINDOW[1]:  # the trace clips step 3's operations away
                dev.append((s, s + 10, name, corr))
    return spans, sorted(dev), calls


def test_operations_find_their_phase_through_their_launch():
    spans, dev, calls = _events()
    got = phases.attribute(spans, dev, calls, *WINDOW)
    assert got["steps"] == 2  # step 3 straddles the window's end
    assert got["fwd_ms.train"] == pytest.approx(20e-6)  # two ops of 10 ns a step
    assert got["bwd_ms.train"] == pytest.approx(10e-6)  # launched on autograd's thread
    assert got["optim_ms.train"] == pytest.approx(20e-6)
    assert got["gather_ms.train"] == pytest.approx(10e-6)
    assert got["step_busy_ms"] == pytest.approx(60e-6)
    assert got["phase_share_pct"] == pytest.approx(100.0)
    assert got["found_share_pct"] == pytest.approx(100.0)
    assert got["host_ms"]["train_step"] == pytest.approx(90e-6)


def test_an_operation_without_a_launch_or_a_span_is_not_found():
    spans, dev, calls = _events()
    dev.append((500, 520, "orphan", 999))  # no runtime call
    calls[1000] = (600, 601)  # a runtime call outside every span
    dev.append((700, 720, "memset", 1000))
    got = phases.attribute(spans, sorted(dev), calls, *WINDOW)
    assert got["fwd_ms.train"] == pytest.approx(20e-6)
    assert got["found_share_pct"] == pytest.approx(100.0 * 120 / 160)


def test_idle_gaps_are_named_by_the_innermost_span_path():
    spans = []
    _step(1, 0, spans)
    # the card busy 0-85 and 95-1000: the gap 85-95 falls in the optimizer
    dev = [(0, 85, "a", 1), (95, 1000, "b", 2)]
    calls = {1: (5, 6), 2: (90, 91)}
    got = phases.attribute(spans, dev, calls, *WINDOW)
    assert got["idle_s"] == {"train_step/optimizer": pytest.approx(10e-9)}
    dev = [(0, 45, "a", 1), (60, 1000, "b", 2)]  # 45-60: backward, then K2's launch
    got = phases.attribute(spans, dev, calls, *WINDOW)
    assert got["idle_s"] == {"train_step/backward/launch joint_bwd": pytest.approx(15e-9)}
    got = phases.attribute(spans, [(0, 500, "a", 1)], calls, *WINDOW)
    assert got["idle_s"] == {phases.OUTSIDE: pytest.approx(500e-9)}
    assert got["outside_gaps"] == [(500e-6, 500e-6, "train_step 1", None)]


def test_the_clock_check_measures_k1_launches_against_their_span():
    spans, dev, calls = _events()
    got = phases.clock_check(spans, dev, calls, "joint_fwd",
                             phases.KERNEL_NAMES["joint_fwd"])
    assert got == {"launches": 2, "worst_outside_ns": 0, "lead_ns_min": 1, "lead_ns_max": 1}
    k1 = next(c for _, _, n, c in dev if "LsePass" in n)
    calls[k1] = (calls[k1][0] + 10, calls[k1][1] + 10)
    assert phases.clock_check(spans, dev, calls, "joint_fwd",
                              phases.KERNEL_NAMES["joint_fwd"])["worst_outside_ns"] == 8


class _Event:
    def __init__(self, name, start, dur, corr, device, annotation=False):
        from torch.autograd import DeviceType

        self._v = (name, start, dur, corr, DeviceType.CUDA if device else DeviceType.CPU,
                   annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_kineto_events_join_kernels_to_runtime_calls_by_correlation_id():
    events = [_Event("cudaLaunchKernel", 10, 2, 7, False),
              _Event("Activity Buffer Request", 11, 5, 0, False),
              _Event("aten::mm", 9, 6, 3, False),
              _Event("gemm", 20, 30, 7, True),
              _Event("train_step", 20, 30, 0, True, annotation=True),
              _Event("late", 90, 30, 8, True)]
    prof = type("P", (), {})()
    prof.profiler = type("K", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    dev, calls = phases.kineto_events(prof, 0, 100)
    assert dev == [(20, 50, "gemm", 7), (90, 100, "late", 8)]
    assert calls == {7: (10, 12)}


def test_a_traced_tiny_run_reads_phases_and_span_costs(tiny_bench, capsys):
    root, bench = tiny_bench
    assert phases.main(["--workload", CELL, "--seed", "3", "--seconds", "1.0",
                        "--cost-windows", "2", "--cost-seconds", "0.3"],
                       device="cpu", bench=bench, root=root) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    traced, costs = lines[0], lines[1:]
    assert traced["steps"] >= 1 and traced["host_ms"]["train_step"] > 0
    # Off the card there is no device operation to attribute.
    assert all(traced[m] is None for m in phases.PHASES) and traced["ops"] == 0
    assert {"idle_pct.train", "k1_roofline", "k2_roofline", "mfu.train"} <= set(traced["layers"])
    assert [c["spans"] for c in costs] == ["off", "on"]
    assert costs[0]["spans_recorded"] == 0 and costs[1]["spans_recorded"] > 0
    assert all(c["steps"] >= 1 and c["ms_per_step"] > 0 for c in costs)
