"""The harness on the CPU at tiny sizes: its cost arithmetic, what a run
loads, cells added as data, and ``correct`` coming out false when the
timed path is broken or a lower precision stands in for it."""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.cost import jasper as jasper_cost
from benchmark.cost import roofline
from benchmark.tests.conftest import CELL, LIMITS, REPO, THREADS, run_cell, tiny_conf


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
    fwd, t = jasper_cost.encoder_flops(enc, 1024)
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
    step = jasper_cost.train_step_flops(conf, [1024], [40])
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
    """Every architecture's reference and operation count, and what they
    share, import nothing of the program."""
    code = ("import importlib, pkgutil, sys; sys.path.insert(0, %r)\n"
            "import benchmark.cost, benchmark.reference\n"
            "for pkg in (benchmark.reference, benchmark.cost):\n"
            "    for m in pkgutil.iter_modules(pkg.__path__):\n"
            "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
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


# An architecture of its own as new files: the Jasper encoder with
# base_sp_lstm's layer-normed LSTM predictor and centred 80-mel front end,
# composed from the shared pieces.
ARCH_REFERENCE = '''"""Jasper encoder, layer-normed LSTM predictor, centred mel front end."""
from benchmark.reference import common, jasper

num_frames = common.num_frames
encoder_out_len = jasper.encoder_out_len


def rows_nll(P, model, wave, lens, targets, target_lens, quant=None):
    blank = model["num_total_symbols"] - 1
    t_lens = encoder_out_len(num_frames(lens, model["featurizer"]), model)
    feats = common.featurize(wave, model["featurizer"])
    audio = jasper.encoder(P, model["encoder"], feats, quant)
    text = common.predictor(P, model["predictor"], targets, blank, quant)
    logits = common.joint_logits(P, audio, text, quant)
    return common.nll(*common.lattice_log_probs(logits, targets.long(), blank), t_lens,
                      target_lens)
'''
ARCH_COST = '''"""Operations of the Jasper / LSTM / mel training step."""
from benchmark.cost import jasper, roofline


def train_step_flops(model, frames, tokens):
    total = 0.0
    for f, u in zip(frames, tokens):
        enc, t = jasper.encoder_train_flops(model["encoder"], int(f))
        total += (enc + roofline.featurizer_flops(model["featurizer"], int(f))
                  + roofline.predictor_flops(model["predictor"], int(u) + 1)
                  + roofline.joint_flops(model, t, int(u) + 1))
    return total
'''


def lstm_mel_conf() -> dict:
    """A tiny configuration of base_sp_lstm's predictor and front end
    (its YAML's values) on tiny_conv's encoder widths."""
    from rnnt_tpu_torch.config.config import load_config, resolve_config

    sp = load_config(resolve_config("base_sp_lstm"))
    fz, pr = sp.featurizer, sp.predictor
    assert (fz.kind, fz.center, pr.kind, pr.lstm_layer_norm) == ("mel", True, "lstm", True)
    conf = tiny_conf(overrides=[
        f"featurizer.kind={fz.kind}", f"featurizer.n_fft={fz.n_fft}",
        f"featurizer.num_mels={fz.num_mels}", f"featurizer.center={str(fz.center).lower()}",
        f"encoder.input_features={sp.encoder.input_features}",
        f"predictor.kind={pr.kind}", f"predictor.num_lstm_layers={pr.num_lstm_layers}",
        f"predictor.lstm_layer_norm={str(pr.lstm_layer_norm).lower()}",
        "predictor.lstm_hidden_dim=128"])
    return {**conf, "name": "tiny_lstm", "reference": "jasper_lstm_mel"}


def add_lstm_mel_cell(root, bench) -> str:
    """New files and entries only: the configuration, its architecture's
    reference and cost, the cell's limits (the tiny Jasper cell's)."""
    cell = "train-t.tiny_lstm"
    (root / "configs" / "tiny_lstm.json").write_text(json.dumps(lstm_mel_conf()))
    (root / "reference" / "jasper_lstm_mel.py").write_text(ARCH_REFERENCE)
    (root / "cost" / "jasper_lstm_mel.py").write_text(ARCH_COST)
    (root / "cells" / f"{cell}.json").write_text(json.dumps({"limits": LIMITS}))
    bench["configs"].append({"name": "tiny_lstm", "source": "tests",
                             "file": "benchmark/configs/tiny_lstm.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": cell, "config": "tiny_lstm", "traffic": "train-t",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    return cell


def test_an_architecture_added_as_files(tiny_bench, capsys, monkeypatch):
    """A configuration with another predictor and front end, and an
    architecture module of its own, runs through ``drivers/train.py`` with
    new files and entries only: correct, with every per-layer metric read,
    and not correct under the half-batch and unchanged-state faults or
    with the fp8 control in the program's place."""
    from benchmark import core

    root, bench = tiny_bench
    before = digests(root)
    cell = add_lstm_mel_cell(root, bench)
    after = digests(root)
    assert all(after[p] == h for p, h in before.items())
    rc, line = run_cell(root, bench, cell, seconds=3.0, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"], line
    # K1 and K2 launch only on the card; their rooflines have nothing to read here.
    assert set(line["metrics"]) == {"mfu.train", "idle_pct.train"}
    c = core.Cell(cell, bench, root)
    drv = c.driver()
    run = core.Run(c, 11, 0.5, False, torch.device("cpu"), 0.0)
    st = drv.setup(run)
    drv.window(run, st)
    drv.check(run, st)
    ok, _ = core.judge(drv.control(run, st), c.limits)
    assert not ok
    for fault in faults.FAULTS["train"]:
        with monkeypatch.context() as m:
            fault(m.setattr)
            rc, line = run_cell(root, bench, cell, seconds=0.5, capsys=capsys)
        assert rc == 0 and not line["correct"], (fault.__name__, line)


@pytest.mark.parametrize("arch", [None, "no_such_arch"])
def test_an_architecture_is_found_by_name(tiny_bench, arch):
    """A configuration without the ``reference`` key, or naming an
    architecture with no module, stops the run with a message naming it."""
    from benchmark import core

    root, bench = tiny_bench
    conf = json.loads((root / "configs" / "tiny.json").read_text())
    conf.pop("reference")
    if arch:
        conf["reference"] = arch
    (root / "configs" / "tiny.json").write_text(json.dumps(conf))
    with pytest.raises(SystemExit, match=arch or "no 'reference' key"):
        core.Cell(CELL, bench, root).architecture("reference")


# The parent's readings of the tiny Jasper run (seed 7, two host threads)
# and of the flagship's operation count, taken before each architecture's
# reference and count moved into modules of their own: the move changes
# no bit of either.  The compared readings also hold the program's own
# arithmetic on the CPU.
PINNED_FLOPS = {(1024, 64): 338631131136.0, (1001, 40): 255928013376.0,
                (700, 25): 145610340096.0, (613, 33): 142064515392.0,
                (402, 24): 81154220160.0}
PINNED_REFERENCE = {"losses": [527.5246734619141, 532.1856994628906, 530.5303955078125],
                    "grad": 30.475744665351325, "raw": 2653.228943336137,
                    "change": 0.7123644286803028}
PINNED_COMPARED = {"loss_gap": 8.858506639853385e-05, "grad_gap": 0.0017411536502705462,
                   "grad_gap_own": 0.0036985832050695877,
                   "change_gap": 0.004278613705349708,
                   "change_gap_own": 0.005150672579096109}


def test_the_jasper_numbers_are_pinned(tiny_bench):
    from benchmark import core

    model = json.loads((REPO / "benchmark/configs/base_convjs.json").read_text())["model"]
    for (f, u), want in PINNED_FLOPS.items():
        assert jasper_cost.train_step_flops(model, [f], [u]) == want
    assert jasper_cost.train_step_flops(model, *zip(*PINNED_FLOPS)) == 963388220160.0
    root, bench = tiny_bench
    torch.set_num_threads(THREADS)
    c = core.Cell(CELL, bench, root)
    drv = c.driver()
    run = core.Run(c, 7, 0.5, False, torch.device("cpu"), 0.0)
    st = drv.setup(run)
    drv.window(run, st)
    got, _, _ = drv.check(run, st)
    r = st["reference"]
    assert {"losses": r["losses"], "grad": math.fsum(r["grad_norms"].values()),
            "raw": math.fsum(r["raw_grad_norms"].values()),
            "change": math.fsum(r["change"].values())} == PINNED_REFERENCE
    assert {k: got[k] for k in PINNED_COMPARED} == PINNED_COMPARED


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


def test_mfu_reads_nothing_when_no_step_follows_the_trace():
    """A window that the trace's teardown outlasts has no untraced step:
    ``mfu.train`` is left out, not read as 0."""
    from benchmark import core

    run = core.Run.__new__(core.Run)
    run.kind, run.cell = "train", None
    run.values = {"untraced_flops": 0.0, "untraced_s": 0.4}
    assert core.read_layer(REPO / "benchmark", "mfu.train", run) is None
    run.values["untraced_flops"] = 1e12
    assert core.read_layer(REPO / "benchmark", "mfu.train", run) > 0


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
