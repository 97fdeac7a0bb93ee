"""Helpers the readers share."""

from __future__ import annotations

import re

# The hand-written kernels' device functions (chip_smoke.py's TRACE_GROUPS).
KERNEL_NAMES = {"joint_fwd": r"gemm_kernel<[^>]*LsePass>|::fwd_h_kernel\(",
                "joint_bwd": r"gemm_kernel<[^>]*(DlPass|DhPass|DwPass)>|::h_kernel\("}


def device_seconds(run, kernel: str) -> float:
    pat = re.compile(KERNEL_NAMES[kernel])
    return sum(s for n, s in run.traced["device_ops"] if pat.search(n))


def idle_pct(run, kind: str):
    if run.kind != kind or not run.traced or run.traced["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.traced["busy_s"] / run.traced["window_s"])


def roofline_pct(run, kernel: str, work_ms):
    """The kernel's bound for the work the traced steps' batches need
    (``cost/roofline.py``, each row at its unpadded (t, u + 1)), once a
    launch, over its device time in the traced window."""
    if run.kind != "train" or not run.traced:
        return None
    launches = run.delta(f"launches.{kernel}")
    steps = int(run.delta("steps"))
    secs = device_seconds(run, kernel)
    if launches <= 0 or steps <= 0 or secs <= 0:
        return None
    model = run.cell.conf["model"]
    H, V = model["joint"]["hidden_features"], model["num_total_symbols"]
    t, u1 = run.values["row_t"], run.values["row_u1"]
    first = int(run.snapshot[0].get("steps", 0))
    bound = 0.0
    for idx in run.values["batches"][first: first + steps]:
        bound += work_ms(float((t[idx] * u1[idx]).sum()), float(t[idx].sum()),
                         float(u1[idx].sum()), H, V)
    return 100.0 * bound * (launches / steps) / (secs * 1e3)
