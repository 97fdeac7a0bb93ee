"""The training step's useful operations (``cost/roofline.py``
``train_step_flops``) over the seconds they took at the bf16 peak, in %,
over the window's steps after the trace stopped: the traced steps run
under the profiler, and its teardown is the harness's own cost."""

from benchmark.cost.roofline import PEAK_BF16_FLOPS


def read(run):
    if run.kind != "train" or not run.values.get("untraced_s"):
        return None
    return 100.0 * run.values["untraced_flops"] / (run.values["untraced_s"] * PEAK_BF16_FLOPS)
