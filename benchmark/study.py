#!/usr/bin/env python3
"""The chip studies a cell's limits were set from; the benchmark's runs
do not run them.

    python3 benchmark/study.py readings --workload <cell> --seeds 1,2,... \
            --control-seeds 1,2,3 --seconds 20
        per seed, the numbers ``correct`` compares from the program (a run's
        set-up, a window and its check) and, on the control seeds, from the
        control (the reference in the next precision down in the program's
        place); with them the readings the cell's driver gives beside its
        compared numbers (``drivers/<kind>.py compare``)
    python3 benchmark/study.py faults --workload <cell> --seeds 1,2,3 --seconds 2
        the same numbers with each of the cell's faults (``faults.py``) planted

Each prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("OMP_NUM_THREADS", "1")  # as benchmark/run.py

import torch  # noqa: E402

from benchmark import core, faults  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def make_run(cell, seed, seconds):
    return core.Run(cell, seed, seconds, False, torch.device("cuda"), time.time())


def readings(cell, seeds, control_seeds, seconds, tag="program"):
    drv = cell.driver()
    for seed in sorted(set(seeds) | set(control_seeds)):
        run = make_run(cell, seed, seconds)
        st = drv.setup(run)
        drv.window(run, st)
        got, attempted, failed = drv.check(run, st)
        emit(study="readings", cell=cell.name, seed=seed, side=tag,
             attempted=attempted, failed=failed, **got)
        if seed in control_seeds:
            emit(study="readings", cell=cell.name, seed=seed, side="control",
                 **drv.control(run, st))
        del st
        torch.cuda.empty_cache()


def fault_readings(cell, seeds, seconds):
    """The numbers ``correct`` compares with each of the cell's faults
    planted (one process a fault, so that nothing stays patched)."""
    import subprocess

    for fault in faults.FAULTS[cell.mix["kind"]]:
        code = ("import sys; sys.path.insert(0, %r); from benchmark import study, faults, core; "
                "import json; faults.%s(setattr); "
                "study.readings(core.Cell(%r, json.loads((core.REPO / 'BENCHMARK.json')"
                ".read_text())), %r, [], %r, tag=%r)"
                % (str(core.REPO), fault.__name__, cell.name, seeds, seconds, fault.__name__))
        subprocess.run([sys.executable, "-c", code], check=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("readings", "faults"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    a = ap.parse_args()
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = core.Cell(a.workload, json.loads((core.REPO / "BENCHMARK.json").read_text()))
    print(f"card: {__import__('benchmark.run', fromlist=['card_limits']).card_limits()}",
          file=sys.stderr)
    if a.what == "readings":
        readings(cell, ints(a.seeds), ints(a.control_seeds), a.seconds)
    else:
        fault_readings(cell, ints(a.seeds), a.seconds)


if __name__ == "__main__":
    main()
