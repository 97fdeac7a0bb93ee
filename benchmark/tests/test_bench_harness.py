"""The harness on the CPU at tiny sizes: its cost arithmetic, what a run
loads, cells added as data, and ``correct`` coming out false when the
timed path is broken or a lower precision stands in for it."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.cost import roofline
from benchmark.tests.conftest import CELL, REPO, THREADS, run_cell


def test_kernel_bounds_pinned():
    """chip_smoke.py's bounds at the eval lattice (PERF.md's K1/K2 rows)."""
    assert round(roofline.k1_bound_ms(4, 504, 65, 1024, 1024), 4) == 0.2779
    assert round(roofline.k2_bound_ms(4, 504, 65, 1024, 1024), 4) == 0.8336


@pytest.mark.parametrize("work,dense", [(roofline.k1_work_ms, roofline.k1_bound_ms),
                                        (roofline.k2_work_ms, roofline.k2_bound_ms)])
def test_kernel_bounds_count_the_needed_lattice(work, dense):
    """Rows at their unpadded (t, u + 1) need less than the padded lattice,
    and a batch of full rows needs what the dense bound says."""
    t, u1 = [291, 400, 504], [25, 33, 65]
    need = work(sum(a * b for a, b in zip(t, u1)), sum(t), sum(u1), 1024, 1024)
    assert need == pytest.approx(2.0 * sum(a * b for a, b in zip(t, u1)) * 1024 * 1024
                                 * (1 if work is roofline.k1_work_ms else 3)
                                 / roofline.PEAK_BF16_FLOPS * 1e3, rel=1e-12)
    assert need < dense(3, 504, 65, 1024, 1024)
    assert work(3 * 504 * 65, 3 * 504, 3 * 65, 1024, 1024) == dense(3, 504, 65, 1024, 1024)


def test_train_step_flops_by_hand():
    conf = json.loads((REPO / "benchmark/configs/base_convjs.json").read_text())["model"]
    enc = conf["encoder"]
    fwd, t = roofline.encoder_flops(enc, 1024)
    assert t == 504  # the flagship's 1024-frame bucket, PERF.md
    # by hand: 2 x frames x cin x cout x k over every convolution
    by_hand = 2 * 512 * 201 * 256 * 11 + 2 * 512 * 1024 * 512
    lens, n = [512], 512
    for blk in enc["blocks"]:
        by_hand += 2 * n * blk["in_channels"] * blk["out_channels"]
        for i in range(blk["num_sub_blocks"]):
            n -= blk.get("additional_context", 0)
            cin = blk["in_channels"] if i == 0 else blk["out_channels"]
            by_hand += 2 * n * cin * blk["out_channels"] * blk["kernel_size"]
        lens.append(n)
    by_hand += 2 * n * 512 * 512 * 29 - 2 * 512 * 1024 * 512 + 2 * n * 512 * 1024
    assert fwd == pytest.approx(by_hand, rel=1e-12)
    step = roofline.train_step_flops(conf, [1024], [40])
    joint = 3 * 2 * 504 * 41 * 1024 * 1024
    assert step > joint and step == pytest.approx(
        joint + 3 * fwd - 2 * 512 * 201 * 256 * 11 + 2 * 1024 * 402 * 400
        + 3 * 2 * 41 * (512 * 512 * 8 + 512 * 1024), rel=1e-12)


GUARD = """
import json, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
from pathlib import Path
import conftest
root, bench = Path({root!r}), json.loads(Path({bench!r}).read_text())
rc, _ = conftest.run_cell(root, bench, {cell!r}, seconds=0.5)
print(json.dumps({{"rc": rc, "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax(tiny_bench, tmp_path):
    root, bench = tiny_bench
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    code = GUARD.format(repo=str(REPO), tests=str(REPO / "benchmark/tests"), root=str(root),
                        bench=str(tmp_path / "bench.json"), cell=CELL)
    env = {**os.environ, "OMP_NUM_THREADS": str(THREADS)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert not {"jax", "jaxlib", "flax", "rnnt_tpu"} & set(got["modules"])
    assert "rnnt_tpu_torch" in got["modules"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = eval(out.stdout)
    assert not {"rnnt_tpu_torch", "rnnt_tpu", "jax"} & set(mods)


def test_a_run_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "train-b32.base_convjs", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_added_as_files(tiny_bench, capsys):
    """A new mix, a new per-layer metric and a new cell are new files and
    new entries: no file of the benchmark changes."""
    root, bench = tiny_bench
    before = digests(root)
    mix = json.loads((root / "traffic" / "train-t.json").read_text())
    (root / "traffic" / "train-t2.json").write_text(json.dumps({**mix, "batch": 2}))
    (root / "cells" / "train-t2.tiny.json").write_text(
        (root / "cells" / f"{CELL}.json").read_text())
    (root / "layers" / "steps.train.py").write_text(
        "def read(run):\n    return float(run.counters['steps']) if run.kind == 'train' else None\n")
    bench["workloads"].append({"name": "train-t2.tiny", "config": "tiny", "traffic": "train-t2",
                               "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_audio_per_s", "workloads": ["train-t2.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_audio_per_s":
            m["workloads"].append("train-t2.tiny")
    after = digests(root)
    assert all(after[p] == h for p, h in before.items())
    rc, line = run_cell(root, bench, "train-t2.tiny", seconds=0.5, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["steps.train"]["value"] >= 1


def test_a_traced_run_times_mfu_apart_from_the_trace(tiny_bench, capsys):
    """The trace stops after the mix's ``trace_seconds``; the step's share
    of the peak comes from the steps after it, the idle share from the
    trace."""
    root, bench = tiny_bench
    rc, line = run_cell(root, bench, CELL, seconds=3.0, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"], line
    assert line["metrics"]["mfu.train"]["value"] > 0
    assert 0 <= line["metrics"]["idle_pct.train"]["value"] <= 100
    assert 0.3 <= line["device"]["window_s"] < 3.0


def test_untraced_counts_from_the_trace_stop():
    from benchmark import core

    run = core.Run.__new__(core.Run)
    run.counters, run._untraced = {"flops": 10.0}, None
    assert run.untraced("flops", 5.0) is None
    run._untraced = (2.0, {"flops": 4.0})
    assert run.untraced("flops", 5.0) == (6.0, 3.0)
    assert run.untraced("flops", 2.0) is None


# The faults a cell can have, planted under the timed path.
@pytest.mark.parametrize("fault", faults.FAULTS["train"])
def test_a_fault_is_not_correct(tiny_bench, capsys, monkeypatch, fault):
    root, bench = tiny_bench
    rc, line = run_cell(root, bench, CELL, seconds=0.5, capsys=capsys)
    assert rc == 0 and line["correct"], line
    fault(monkeypatch.setattr)
    rc, line = run_cell(root, bench, CELL, seconds=0.5, capsys=capsys)
    assert rc == 0 and not line["correct"], line


def test_the_control_is_not_correct(tiny_bench):
    """The reference in the next precision down, in the program's place,
    fails one of the cell's numbers."""
    from benchmark import core

    root, bench = tiny_bench
    c = core.Cell(CELL, bench, root)
    drv = c.driver()
    run = core.Run(c, 11, 2.0, False, torch.device("cpu"), 0.0)
    st = drv.setup(run)
    drv.window(run, st)
    drv.check(run, st)
    ok, _ = core.judge(drv.control(run, st), c.limits)
    assert not ok


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of each cell on the card (the chip's own check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w["name"],
                              "--seed", "5", "--seconds", "3"], capture_output=True,
                             text=True, timeout=900, cwd=REPO)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
