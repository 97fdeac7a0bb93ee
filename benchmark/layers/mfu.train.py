"""The training step's useful operations (``benchmark/cost/<arch>.py``
``train_step_flops``) over the seconds they took at the bf16 peak, in %,
over the window's steps after the trace stopped: the traced steps run
under the profiler, and its teardown is the harness's own cost.  A window
that ends before a step follows the trace has nothing to read."""

from benchmark.cost.roofline import PEAK_BF16_FLOPS


def read(run):
    if run.kind != "train" or not run.values.get("untraced_flops"):
        return None
    return 100.0 * run.values["untraced_flops"] / (run.values["untraced_s"] * PEAK_BF16_FLOPS)
