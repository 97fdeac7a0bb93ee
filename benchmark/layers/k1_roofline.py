"""K1's share of its roofline in the training step (``csrc/joint_fwd.cu``)."""

from benchmark.cost.roofline import k1_work_ms
from benchmark.layers._common import roofline_pct


def read(run):
    return roofline_pct(run, "joint_fwd", k1_work_ms)
