"""The attention core's share of its roofline in the training step: the
bound for the work the traced steps' rows need (``cost/fastconformer.py``
``attn_work`` per layer and row at its unpadded t: operations at the bf16
peak or bytes at the HBM bandwidth, the larger, a layer's call over the
batch at a time), over the device time of the SDPA kernels in the traced
window.  The memory-efficient backend's kernels are CUTLASS's
``fmha_cutlassF`` (forward) and ``fmha_cutlassB`` (backward).  A run whose
program ran no attention core has nothing to read."""

import re

from benchmark.cost.fastconformer import attn_work
from benchmark.cost.roofline import PEAK_BF16_FLOPS, PEAK_BYTES

SDPA_KERNELS = re.compile(r"fmha_cutlass[FB]")


def read(run):
    if run.kind != "train" or not run.traced:
        return None
    try:
        from rnnt_tpu_torch.models import fastconformer
    except ImportError:
        return None
    enc = run.cell.conf["model"]["encoder"]
    steps = int(run.delta("steps"))
    secs = sum(s for n, s in run.traced["device_ops"] if SDPA_KERNELS.search(n))
    if fastconformer.ATTN_CALLS <= 0 or enc.get("kind") != "fastconformer" or steps <= 0 \
            or secs <= 0:
        return None
    t = run.values["row_t"]
    first = int(run.snapshot[0].get("steps", 0))
    bound = 0.0
    for idx in run.values["batches"][first: first + steps]:
        flops = nbytes = 0.0
        for row_t in t[idx]:
            f, b = attn_work(enc["d_model"], enc["num_heads"], int(row_t))
            flops, nbytes = flops + f, nbytes + b
        bound += enc["num_layers"] * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    return 100.0 * bound / secs
