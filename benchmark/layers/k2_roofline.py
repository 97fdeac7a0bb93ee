"""K2's share of its roofline in the training step (``csrc/joint_bwd.cu``)."""

from benchmark.cost.roofline import k2_work_ms
from benchmark.layers._common import roofline_pct


def read(run):
    return roofline_pct(run, "joint_bwd", k2_work_ms)
