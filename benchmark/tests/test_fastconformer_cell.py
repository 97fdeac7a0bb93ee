"""A FastConformer-Transducer cell on the CPU at tiny widths of the
parakeet-rnnt-0.6b shape, through the harness's files only
(``reference/fastconformer.py``, ``cost/fastconformer.py``): it runs
correct against the plain reference, and its fp8 control and the two
faults do not; and the full configuration's operation count, pinned."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import faults
from benchmark.cost import fastconformer as fc_cost
from benchmark.tests.conftest import LIMITS, MIX, REPO, run_cell, tiny_conf
from benchmark.tests.test_bench_harness import digests

# parakeet_rnnt_0.6b's YAML at tiny widths: every kind, kernel, factor and
# the front end as published; d_model 64 in 2 heads, 2 layers, 16
# subsampling channels, a 32-wide LSTM and joint, 40 pieces + blank.
TINY = ["encoder.d_model=64", "encoder.num_layers=2", "encoder.num_heads=2",
        "encoder.subsampling_conv_channels=16", "predictor.symbol_embedding_dim=32",
        "predictor.lstm_hidden_dim=32", "predictor.output_dim=32",
        "joint.audio_features=64", "joint.text_features=32", "joint.hidden_features=32",
        "num_text_tokens=40", "num_total_symbols=41", "blank_idx=40",
        "training.precision=fp32"]
CELL = "train-t.tiny_fc"


def add_fastconformer_cell(root, bench) -> str:
    """New files and entries only: the configuration (architecture
    ``fastconformer``), a mix whose reference takes the whole batch (batch
    norm couples the rows) and the tiny Jasper cell's limits."""
    conf = {**tiny_conf("parakeet_rnnt_0.6b", TINY), "name": "tiny_fc",
            "reference": "fastconformer"}
    (root / "configs" / "tiny_fc.json").write_text(json.dumps(conf))
    (root / "traffic" / "train-tfc.json").write_text(json.dumps(
        {**MIX, "reference_rows": MIX["batch"]}))
    (root / "cells" / f"{CELL}.json").write_text(json.dumps({"limits": LIMITS}))
    bench["configs"].append({"name": "tiny_fc", "source": "tests",
                             "file": "benchmark/configs/tiny_fc.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_fc", "traffic": "train-tfc",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return CELL


def test_a_fastconformer_cell_added_as_files(tiny_bench, capsys, monkeypatch):
    from benchmark import core

    root, bench = tiny_bench
    before = digests(root)
    cell = add_fastconformer_cell(root, bench)
    after = digests(root)
    assert all(after[p] == h for p, h in before.items())
    rc, line = run_cell(root, bench, cell, seconds=2.0, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"], line
    # K1, K2 and the memory-efficient attention run only on the card.
    assert set(line["metrics"]) == {"mfu.train", "idle_pct.train"}
    c = core.Cell(cell, bench, root)
    drv = c.driver()
    run = core.Run(c, 11, 0.3, False, torch.device("cpu"), 0.0)
    st = drv.setup(run)
    drv.window(run, st)
    drv.check(run, st)
    ok, _ = core.judge(drv.control(run, st), c.limits)
    assert not ok
    for fault in faults.FAULTS["train"]:
        with monkeypatch.context() as m:
            fault(m.setattr)
            rc, line = run_cell(root, bench, cell, seconds=0.3, capsys=capsys)
        assert rc == 0 and not line["correct"], (fault.__name__, line)


# Operations of one training step of the full configuration over one
# utterance of (frames, tokens): 12 s, 14 s and 16 s at 4 tokens a second.
PINNED_FLOPS = {(1201, 48): 605474921376.0, (1401, 56): 713872591776.0,
                (1601, 64): 824581942176.0}


@pytest.mark.parametrize("frames,tokens", sorted(PINNED_FLOPS))
def test_train_step_flops_pinned(frames, tokens):
    model = json.loads((REPO / "benchmark/configs/parakeet_rnnt_0.6b.json").read_text())["model"]
    assert fc_cost.train_step_flops(model, [frames], [tokens]) == PINNED_FLOPS[frames, tokens]
