#!/usr/bin/env python3
"""Prove that the PyTorch port runs on one NVIDIA card (H100, sm_90a).

Run ``python3 chip_smoke.py`` (no arguments) from the repository root:

1. print the card (``nvidia-smi`` name and power limit) and stop with a
   nonzero exit when CUDA is missing;
2. build the hand-written kernels from ``rnnt_tpu_torch/csrc`` with nvcc,
   one process per source, all started together;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main paths' shapes — K1 and K2 at the eval shape and at the
   banded patches of the pruned loss (K2 with and without the gradient
   clamp), K3 and K4 at the eval shape and at a long-label shape, K5 at the
   four calls one flagship ``device_augment_full`` makes (recorded from a
   call on a full-width batch: chorus, resample, trim, time-stretch frames)
   and at edge cases — with the tolerances stated below, timed with CUDA
   events (median after warm-up) beside the least time the card could take
   and, for K5, one ``torch.gather`` call computing the same function;
3b. augmentation phase (slice 3): ``device_augment_full`` on one
   full-width batch from a fixed generator, through K5 and with K5's plain
   version in its place: identical audio and lens, lens in (0, L], zero
   past the lens, finite; ms per call and K5 launches per call (4);
4. path phase (slice 1): the full-width ``base_convjs`` model (random
   weights from a seed, ``training.loss_impl=auto``, synthetic 10 s
   utterances, an in-code 1023-piece vocabulary) through
   ``rnnt_tpu_torch.cli.eval.main`` and ``rnnt_tpu_torch.train.loop.evaluate``;
   the kernels' launch counts are set to 0 before and read after; one
   batch's NLL is recomputed through the plain path and must agree;
5. train phase (slices 2 and 3): ``rnnt_tpu_torch.cli.train.main`` on
   full-width ``base_convjs`` with the flagship's own data settings
   (``augment: true, augment_device: full, staging: auto``: the corpus
   cached on the card, the whole augmentation recipe in the step; flagship
   pruned loss with 2 warmup steps; batch 4 of synthetic 10 s utterances):
   steps 1-2 (warmup loss), then a resume for steps 3-4 (banded loss), then
   2 steps of the exact loss (``loss_impl=auto``); then 2 exact steps with
   augmentation off, and 2 steps with the host recipe in 2 worker threads
   and SpecAugment (``augment_device=false, num_workers=2,
   spec_augment=true``: streamed); K1-K4 must launch in every step and K5
   4 times in each device-augmented step and never otherwise (the loop logs
   each step's launches to metrics.jsonl; counts also set to 0 before each
   run and read after); each step's loss, gradient norm, seconds and
   audio-s/s are printed and must be finite; the cache's line must be
   printed where the corpus is cached; ``cli.eval`` reads the trained
   checkpoint;
6. gradient check: one full-width bf16 batch, dropout off, loss and every
   parameter gradient through the kernels against plain references, for
   the exact loss and the banded pruned loss: the same loss functions with
   K1-K4 swapped for plain PyTorch under autograd (rounded where the
   kernels round, the alpha recursion in float64), and for the exact loss
   also the bf16 chunked joint under autograd;
7. print a ``{"kernels": [...]}`` line, then, last, the ``{"ok": true, ...}``
   line.

``--profile DIR`` adds torch.profiler traces of two eval batches (after
the path phase) and of three banded train steps without and with device
augmentation (after the gradient check): device time by kernel, the card's
busy and idle share, and ``DIR/eval_trace.json.gz``,
``DIR/train_trace.json.gz`` and ``DIR/train_aug_trace.json.gz``.

Every check raises on failure, so a failed phase exits nonzero before the
last line.  float32 matmuls and cuDNN convs run without TF32 here (both
``allow_tf32`` flags are set False) so that fp32 comparisons mean fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# Tolerances.  K1: float32 sums over H = 1024 bf16 products in another
# order than cuBLAS, plus an online logsumexp.  K3: the log-semiring scan
# regrouped; NLLs are O(10^3), so rtol dominates.
K1_TOL = dict(atol=2e-3, rtol=1e-3)
K3_TOL = dict(atol=1e-3, rtol=1e-5)
PATH_NLL_RTOL = 1e-3
# K2: each output within this relative L2 error.  dl is rounded to bf16 in
# both versions (as the TPU kernel rounds it), but the logits it comes from
# differ in their last float32 bits, so a few dl values land on the
# neighbouring bf16 (2^-8 relative); fp32 atomics sum in a varying order.
K2_REL_L2 = 5e-3
# K4: exp(alpha + lp + beta - ll) with exponents summed from O(10^2-10^3)
# log-probs in another order.
K4_TOL = dict(atol=1e-4, rtol=3e-3)
# Gradient check of the whole model, loss within PATH_NLL_RTOL.  The
# references are the same losses with K1-K4 swapped for plain PyTorch under
# autograd that rounds where the kernels round (bf16 h forward, bf16 dl
# backward, 1 - h^2 of the rounded h) with the alpha recursion in float64;
# on the CPU, where the wrappers run their plain versions, it gives the
# same gradients (tests/test_torch_train_kernels.py).  On the card what is
# left is summation order, K2's atomics and the float32 lattice (K4's
# rtol 3e-3).  The gradients the kernels produce — at the joint's inputs
# (the encoder's and the predictor's outputs) and the joint's parameters —
# are held within JOINT_REL_L2, K2's own tolerance.  The encoder's and the
# predictor's parameters are held within GRAD_REL_L2: the encoder's bf16
# backward grows a difference at its output ~5x by its first conv (the
# witness in grad_phase sends both cotangents back through one encoder
# graph: 2.71e-3 at the output gave 1.33e-2 at encoder.prologue.conv.w on
# an H100, the whole model's gap there, and one cotangent sent twice gave
# 0).  The second
# reference for the exact loss is the naive plain path, the chunked joint
# differentiated on bf16 tensors, which also rounds dh and the tanh
# derivative per element where K2 keeps them in float32 (joint inputs
# 4.1e-3 and 4.7e-3 apart on the CPU, tiny_conv).  A parameter's error is
# taken relative to its reference gradient's norm, floored at GRAD_FLOOR x
# the model's global gradient norm: the biases of the convs in front of
# instance norms have a zero gradient in exact arithmetic, so only
# round-off is left there.
JOINT_REL_L2 = 5e-3
JOINT_BF16_REL_L2 = 1e-2
GRAD_REL_L2 = 2e-2
GRAD_FLOOR = 1e-3

EVAL_SHAPE = dict(B=4, T=504, U1=65, H=1024, V=1024)
K3_LONG = dict(B=4, T=1000, U1=257)
BANDED_SHAPE = dict(B=128, T=16, U1=16, H=1024, V=1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time per call of ``fn``'s kernels (torch.profiler), after
    a warm-up call: for kernels so short that CUDA events around one call
    time its launch from Python, not the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    return sum(t.end - t.start for t in spans) / reps / 1e3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return the
    largest absolute error."""
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values out of "
            f"tolerance (max abs err {float(err.max()):.3e})")
    return float(err.max())


# ------------------------------- kernels -------------------------------

def k1_inputs(B, T, U1, H, V, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    enc = (torch.randn(B, T, H, generator=g) * 0.5).to(torch.bfloat16)
    pred = (torch.randn(B, U1, H, generator=g) * 0.5).to(torch.bfloat16)
    w = (torch.randn(H, V, generator=g) / math.sqrt(H)).to(torch.bfloat16)
    b = torch.randn(V, generator=g) * 0.1
    labels = torch.randint(0, V - 1, (B, U1), generator=g, dtype=torch.int32)
    labels[:, -1] = 0
    return [x.to(device) for x in (enc, pred, w, b, labels)] + [V - 1]


def k1_bound_ms(B, T, U1, H, V) -> float:
    flops = 2.0 * B * T * U1 * H * V
    nbytes = 2 * (B * T * H + B * U1 * H + H * V) + 4 * V + 4 * B * U1 + 3 * 4 * B * T * U1
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def k3_inputs(B, T, U1, device, seed=0):
    from rnnt_tpu_torch.ops.transducer import NEG

    g = torch.Generator().manual_seed(seed)
    lpb = torch.randn(B, T, U1, generator=g) - 1.5
    lpl = torch.randn(B, T, U1, generator=g) - 1.5
    u_lens = torch.randint(1, U1, (B,), generator=g, dtype=torch.int32)
    t_lens = torch.randint(min(U1, T), T + 1, (B,), generator=g, dtype=torch.int32)
    u_mask = torch.arange(U1)[None, :] < u_lens[:, None]
    lpl = torch.where(u_mask[:, None, :], lpl, torch.full_like(lpl, NEG))
    return [x.to(device) for x in (lpb, lpl, t_lens, u_lens)]


def k3_bound(B, T, U1) -> tuple[float, str]:
    """(ms, what bounds it): lp_blank and lp_label read and alpha written
    once, against one log-sum-exp per cell (2 exp, 1 log, 4 add/max) on
    the float32 units."""
    nbytes = 3 * 4 * B * T * U1 + 3 * 4 * B
    ops = 7.0 * B * T * U1
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_k3(nll, alpha, nll_p, alpha_p, t_lens, u_lens) -> float:
    from rnnt_tpu_torch.ops.transducer import NEG

    err = check_close("K3 nll", nll, nll_p, **K3_TOL)
    B, T, U1 = alpha.shape
    tt = torch.arange(T, device=alpha.device)[None, :, None]
    uu = torch.arange(U1, device=alpha.device)[None, None, :]
    live = (tt < t_lens.long()[:, None, None]) & (uu <= u_lens.long()[:, None, None])
    err = max(err, check_close("K3 alpha (reachable cells)", alpha[live],
                               alpha_p[live], **K3_TOL))
    dead = alpha_p <= NEG / 2
    if not bool((alpha[dead] <= NEG / 2).all()):
        raise AssertionError("K3: a log-zero cell of the plain alpha is live")
    return err


def kernel_phase(device, shape=EVAL_SHAPE, banded=BANDED_SHAPE, long_case=K3_LONG,
                 reps=20) -> dict:
    from rnnt_tpu_torch.ops.lattice_pallas import alpha_forward, alpha_plain
    from rnnt_tpu_torch.ops.transducer_pallas import (
        fused_joint_outputs, fused_joint_outputs_plain)

    out = {}
    for tag, dims in (("eval", shape), ("banded", banded)):
        args = k1_inputs(**dims, device=device)
        got = fused_joint_outputs(*args)
        want = fused_joint_outputs_plain(*args)
        err = max(check_close(f"K1 {tag} {n}", g, w, **K1_TOL)
                  for n, g, w in zip(("lse", "blank", "label"), got, want))
        m = dict(
            max_abs_err=err, ms=cuda_ms(lambda: fused_joint_outputs(*args), reps),
            plain_ms=cuda_ms(lambda: fused_joint_outputs_plain(*args), 3, warmup=1),
            bound_ms=k1_bound_ms(**dims), bound_by="operations",
            shape="B={B} T={T} U1={U1} H={H} V={V}".format(**dims))
        del args, got, want
        log(f"K1 {tag} ok {dims}: max abs err {err:.3e}, {m['ms']:.4f} ms "
            f"(plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms)")
        if tag == "eval":
            out["K1"] = m
        else:
            out["K1"]["banded_case"] = m

    for tag, dims in (("eval", dict(B=shape["B"], T=shape["T"], U1=shape["U1"])),
                      ("long", long_case)):
        k3 = k3_inputs(**dims, device=device)
        nll, alpha = alpha_forward(*k3)
        nll_p, alpha_p = alpha_plain(*k3)
        err = check_k3(nll, alpha, nll_p, alpha_p, k3[2], k3[3])
        ms = cuda_ms(lambda: alpha_forward(*k3), reps)
        plain_ms = cuda_ms(lambda: alpha_plain(*k3), 2, warmup=1)
        bound_ms, bound_by = k3_bound(**dims)
        log(f"K3 {tag} ok {dims}: max abs err {err:.3e}, {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms)")
        m = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, shape="B={B} T={T} U1={U1}".format(**dims))
        if tag == "eval":
            out["K3"] = m
        else:
            out["K3"]["long_case"] = m
    return out


def k2_bound_ms(B, T, U1, H, V) -> float:
    """Three products of 2*N*H*V flops (N = B*T*U1) on the bf16 tensor
    cores, against every input read and every output written once."""
    n = B * T * U1
    flops = 6.0 * n * H * V
    nbytes = (2 * (B * T * H + B * U1 * H + H * V) + 4 * V + 4 * B * U1 + 4 * 4 * n
              + 4 * (B * T * H + B * U1 * H + H * V + V))
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def k4_bound(lp_blank, t_lens) -> tuple[float, str]:
    """(ms, what bounds it) for this run's data: lp_blank, lp_label and
    alpha read for the t_len rows each sample has, both gradients written
    in full; against one log-sum-exp and two exps per live cell."""
    B, T, U1 = lp_blank.shape
    live = float(t_lens.sum()) * U1
    nbytes = 3 * 4 * live + 2 * 4 * B * T * U1 + 4 * 4 * B
    ops = 12.0 * live
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def train_kernel_phase(device, shape=EVAL_SHAPE, banded=BANDED_SHAPE,
                       long_case=K3_LONG, reps=20) -> dict:
    """K2 and K4 against their plain versions, timed."""
    from rnnt_tpu_torch.ops.lattice_pallas import alpha_plain, beta_backward, beta_plain
    from rnnt_tpu_torch.ops.transducer_pallas import (
        fused_joint_backward, fused_joint_bwd_plain, fused_joint_outputs_plain)

    out = {}
    for tag, dims in (("eval", shape), ("banded", banded)):
        args = k1_inputs(**dims, device=device)
        lse = fused_joint_outputs_plain(*args)[0]
        g = torch.Generator().manual_seed(1)
        gb, gl = (torch.randn(dims["B"], dims["T"], dims["U1"], generator=g).to(device)
                  * 0.3 for _ in range(2))
        cot = (lse, gb, gl, -(gb + gl))
        err = 0.0
        for clamp in (-1.0, 0.01):
            got = fused_joint_backward(*args, *cot, clamp)
            want = fused_joint_bwd_plain(*args, *cot, clamp)
            for n, x, y in zip(("denc", "dpred", "dW", "db"), got, want):
                e = rel_l2(x, y)
                if not (e <= K2_REL_L2 and bool(torch.isfinite(x).all())):
                    raise AssertionError(f"K2 {tag} clamp={clamp} {n}: relative "
                                         f"L2 error {e:.3e} > {K2_REL_L2}")
                err = max(err, float((x - y).abs().max()))
        del got, want
        m = dict(max_abs_err=err,
                 ms=cuda_ms(lambda: fused_joint_backward(*args, *cot), reps),
                 plain_ms=cuda_ms(lambda: fused_joint_bwd_plain(*args, *cot), 3, warmup=1),
                 bound_ms=k2_bound_ms(**dims), bound_by="operations",
                 shape="B={B} T={T} U1={U1} H={H} V={V}".format(**dims))
        log(f"K2 {tag} ok {dims} (clamp off and 0.01): max abs err {err:.3e}, "
            f"{m['ms']:.4f} ms (plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms)")
        if tag == "eval":
            out["K2"] = m
        else:
            out["K2"]["banded_case"] = m
        del args, lse, cot

    for tag, dims in (("eval", dict(B=shape["B"], T=shape["T"], U1=shape["U1"])),
                      ("long", long_case)):
        k4 = k3_inputs(**dims, device=device)
        nll, alpha = alpha_plain(*k4)
        g = torch.ones_like(nll)
        args = (k4[0], k4[1], alpha, k4[2], k4[3], nll, g)
        got = beta_backward(*args)
        want = beta_plain(*args)
        err = max(check_close(f"K4 {n}", x, y, **K4_TOL)
                  for n, x, y in zip(("glpb", "glpl"), got, want))
        bound_ms, bound_by = k4_bound(k4[0], k4[2])
        m = dict(max_abs_err=err, ms=cuda_ms(lambda: beta_backward(*args), reps),
                 plain_ms=cuda_ms(lambda: beta_plain(*args), 2, warmup=1),
                 bound_ms=bound_ms, bound_by=bound_by,
                 shape="B={B} T={T} U1={U1}".format(**dims))
        log(f"K4 {tag} ok {dims}: max abs err {err:.3e}, {m['ms']:.4f} ms "
            f"(plain {m['plain_ms']:.4f} ms, bound {bound_ms:.6f} ms)")
        if tag == "eval":
            out["K4"] = m
        else:
            out["K4"]["long_case"] = m
    return out


# ------------------------- K5 and the augmentation -------------------------

K5_LENS_FRACTION = (1.0, 0.93, 0.8, 0.65)   # the batch's lens, of L


def augment_batch(L: int, device, seed: int = 0):
    """(audio (4, L) float32, lens (4,) int32) on ``device``: noise with a
    few tones, zero past the lens."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor([int(L * f) for f in K5_LENS_FRACTION], dtype=torch.int32)
    t = torch.arange(L, dtype=torch.float32) / 16000.0
    audio = 0.05 * torch.randn(len(lens), L, generator=g)
    for f in (220.0, 1330.0, 3100.0):
        audio += 0.05 * torch.sin(2 * math.pi * f * t)
    audio = torch.where(torch.arange(L)[None, :] < lens[:, None], audio, 0.0)
    return audio.to(device), lens.to(device)


@contextlib.contextmanager
def k5_calls(record: list | None = None, plain: bool = False):
    """Inside: the device augmentation's window gathers are recorded as
    (name, x, starts, width) in ``record`` and/or run on K5's plain
    version."""
    from rnnt_tpu_torch.data import augment_device as ad
    from rnnt_tpu_torch.ops.window_gather import gather_windows_plain

    names = iter(("time-stretch frames", "resample", "trim", "chorus"))
    inner = gather_windows_plain if plain else ad.gather_windows
    saved = ad.gather_windows

    def call(x, starts, width):
        if record is not None:
            record.append((next(names), x.clone(), starts.clone(), width))
        return inner(x, starts, width)

    ad.gather_windows = call
    try:
        yield
    finally:
        ad.gather_windows = saved


def k5_bound(x, starts, width) -> tuple[float, str]:
    """(ms, "bytes"): x and the starts read once and the output written
    once at the card's memory rate; K5 does no arithmetic."""
    B, L = x.shape
    N = starts.shape[1]
    nbytes = 4 * B * L + 4 * B * N + 4 * B * N * width
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def k5_edge_cases(device):
    """(name, x, starts, width): negative starts, starts >= L, windows past
    L, N not a multiple of 8, a one-sample row."""
    g = torch.Generator().manual_seed(5)
    cases = []
    for name, B, L, N, width, lo, hi in (
            ("clipped starts", 3, 5000, 37, 256, -400, 5400),
            ("past L", 2, 3000, 13, 512, 2600, 3000),
            ("N % 8 != 0", 4, 20000, 1001, 128, 0, 20000),
            ("one-sample row", 2, 1, 5, 128, -3, 4)):
        x = torch.randn(B, L, generator=g).to(device)
        starts = torch.randint(lo, hi, (B, N), generator=g, dtype=torch.int32).to(device)
        cases.append((name, x, starts, width))
    return cases


def k5_phase(device, L: int, reps: int = 50, timer=None) -> dict:
    """K5 against its plain version (bit-equal) at the four calls one
    flagship ``device_augment_full`` makes and at edge cases; times of the
    flagship calls (K5, plain, and one ``torch.gather`` on the zero-padded
    row with a prebuilt (B, N * width) index, which the port never calls)
    and their bound.  ``ms``, ``plain_ms`` and ``library_ms`` are device
    time (``device_ms``; ``timer`` replaces it); ``event_ms`` is CUDA
    events around one call, the Python launch included.  The entry's
    headline numbers are sums over the four calls: one device-augmented
    step's worth."""
    timer = timer or device_ms
    import torch.nn.functional as F

    from rnnt_tpu_torch.data.augment_device import device_augment_full
    from rnnt_tpu_torch.ops.window_gather import gather_windows, gather_windows_plain

    audio, lens = augment_batch(L, device)
    calls: list = []
    with k5_calls(record=calls, plain=True):
        device_augment_full(torch.Generator(device=device).manual_seed(0), audio, lens)
    if len(calls) != 4:
        raise AssertionError(f"device_augment_full made {len(calls)} window gathers, not 4")
    out = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               event_ms=0.0, bound_by="bytes", cases=[])
    cases = [(c, True) for c in calls] + [(c, False) for c in k5_edge_cases(device)]
    for (name, x, starts, width), timed in cases:
        got = gather_windows(x, starts, width)
        want = gather_windows_plain(x, starts, width)
        sync(device)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"K5 {name}: not bit-equal to its plain version "
                                 f"(max abs err {float((got - want).abs().max()):.3e})")
        B, Lx = x.shape
        shape = f"B={B} L={Lx} N={starts.shape[1]} width={width}"
        if not timed:
            log(f"K5 {name} ok ({shape}): bit-equal to plain")
            continue
        xp = F.pad(x, (0, width))
        idx = (starts.long().clamp(0, Lx - 1)[:, :, None]
               + torch.arange(width, device=x.device)).reshape(B, -1)
        m = dict(name=name, shape=shape,
                 ms=timer(lambda: gather_windows(x, starts, width), reps),
                 plain_ms=timer(lambda: gather_windows_plain(x, starts, width), reps),
                 library_ms=timer(lambda: torch.gather(xp, 1, idx), reps),
                 event_ms=cuda_ms(lambda: gather_windows(x, starts, width), reps))
        m["bound_ms"], _ = k5_bound(x, starts, width)
        log(f"K5 {name} ok ({shape}): bit-equal, device {m['ms']:.4f} ms (plain "
            f"{m['plain_ms']:.4f} ms, torch.gather {m['library_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.5f} ms; events around one call {m['event_ms']:.4f} ms)")
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "event_ms"):
            out[k] += m[k]
        out["cases"].append(m)
    out["shape"] = "; ".join(f"{c['name']} {c['shape']}" for c in out["cases"])
    return out


def augment_phase(device, k5, L: int, reps: int = 5, timer=None) -> dict:
    """``device_augment_full`` on one full-width batch from a fixed
    generator, through K5 and with K5's plain version: identical audio and
    lens, lens in (0, L], zero past the lens, finite; ms per call (CUDA
    events: host-bound, so wall time), its device time (``timer``,
    default ``device_ms``) and K5's launches per call (``k5``, the kernel,
    or None on the CPU)."""
    timer = timer or device_ms
    from rnnt_tpu_torch.data.augment_device import device_augment_full

    audio, lens = augment_batch(L, device, seed=1)

    def run():
        return device_augment_full(torch.Generator(device=device).manual_seed(7),
                                   audio, lens)

    def count():
        return k5.launches if k5 is not None else 4

    if k5 is not None:
        k5.launches = 0
    got, got_lens = run()
    sync(device)
    per_call = count()
    with k5_calls(plain=True):
        want, want_lens = run()
        plain_ms = cuda_ms(run, reps)
    if count() != per_call:
        raise AssertionError("K5 launched while its plain version was in place")
    if not (torch.equal(got, want) and torch.equal(got_lens, want_lens)):
        raise AssertionError("device_augment_full differs through K5 and its plain version "
                             f"(max abs err {float((got - want).abs().max()):.3e})")
    if not (bool(((got_lens > 0) & (got_lens <= L)).all()) and bool(torch.isfinite(got).all())):
        raise AssertionError(f"device_augment_full: lens {got_lens.tolist()} or non-finite audio")
    past = torch.arange(L, device=got.device)[None, :] >= got_lens[:, None]
    if bool((got[past] != 0).any()):
        raise AssertionError("device_augment_full: audio past its lens is not zero")
    ms = cuda_ms(run, reps)
    dev_ms = timer(run, reps)
    if per_call != 4:
        raise AssertionError(f"K5 launched {per_call} times in one device_augment_full, not 4")
    log(f"device_augment_full (B={audio.shape[0]}, L={L}): identical through K5 and its "
        f"plain version; lens {lens.tolist()} -> {got_lens.tolist()}; {ms:.3f} ms per call "
        f"(plain gathers {plain_ms:.3f} ms), device time {dev_ms:.3f} ms; K5 launches per "
        f"call {per_call}")
    return dict(ms=ms, plain_ms=plain_ms, device_ms=dev_ms, k5_per_call=per_call,
                lens=got_lens.tolist())


# --------------------------------- path ---------------------------------

PATH_OVERRIDES = ["training.loss_impl=auto", "training.global_batch_size=4",
                  "data.dataset=synthetic", "data.synthetic_seconds=10",
                  "data.synthetic_size=96", "tokenizer.spm_model=''"]


def path_phase(workdir: Path, device, kernels, config="base_convjs",
               overrides=PATH_OVERRIDES, expect_t=504, expect_u1=65) -> dict:
    """Drive the port's eval path on ``device``; return its numbers."""
    from rnnt_tpu_torch.cli import eval as cli_eval
    from rnnt_tpu_torch.compat.jax_params import save_checkpoint
    from rnnt_tpu_torch.config.config import (
        apply_overrides, build_featurizer_spec, build_model_spec, load_config,
        resolve_config)
    from rnnt_tpu_torch.data.dataset import synthetic_piece_table
    from rnnt_tpu_torch.models.encoder import encoder_out_len
    from rnnt_tpu_torch.models.rnnt import rnnt_forward, rnnt_init
    from rnnt_tpu_torch.ops.stft import make_featurizer
    from rnnt_tpu_torch.ops.transducer import (
        joint_lattice_log_probs, transducer_alpha_loss)
    from rnnt_tpu_torch.ops.transducer_pallas import transducer_loss_pallas
    from rnnt_tpu_torch.train import loop
    from rnnt_tpu_torch.train import step

    vocab = workdir / "vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    cfg = apply_overrides(load_config(resolve_config(config)),
                          list(overrides) + [f"tokenizer.vocab_json={vocab}"])
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    model = rnnt_init(spec, seed=0, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = save_checkpoint(workdir / "ckpt", cfg, model)
    log(f"model {config}: {n_params:,} parameters, checkpoint {ckpt.name}/")

    for k in kernels:
        k.launches = 0
    cli = cli_eval.main([str(ckpt), "--batch-size", "4", "--max-elements", "12",
                         "--device", str(device)])
    res = loop.evaluate(cfg, model, device=device, batch_size=4, max_batches=3)
    launches = {k.name: k.launches for k in kernels}
    log(f"cli.eval WER {cli['wer']:.4f} over {cli['utterances']} utterances; "
        f"evaluate: exact NLL {res['nll']:.4f}, WER {res['wer']:.4f}, "
        f"{res['audio_seconds'] / res['seconds']:.2f} audio-s/s "
        f"({res['audio_seconds']:.1f} s of audio in {res['seconds']:.2f} s: "
        f"exact loss {res['loss_seconds']:.3f} s, forward + greedy decode "
        f"{res['decode_seconds']:.3f} s); launches {launches}")
    if not (math.isfinite(res["nll"]) and math.isfinite(res["wer"])
            and math.isfinite(cli["wer"])):
        raise AssertionError(f"non-finite eval result {res} / {cli}")
    if cli["wer"] != res["wer"]:
        raise AssertionError(f"cli.eval WER {cli['wer']} != evaluate WER {res['wer']}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the eval path: {missing}")

    # One batch through the plain path (chunked joint + plain alpha).
    tokenizer = loop._load_tokenizer(cfg)
    batch = next(iter(loop.eval_batches(cfg, tokenizer, batch_size=4, max_batches=1)))
    with torch.inference_mode():
        sb = step.batch_to_device(batch, device)
        feats = make_featurizer(fspec)(step.decode_wire_audio(sb["audio"]))
        feats = feats.to(step.compute_dtype(cfg.training.precision))
        audio, text, _ = rnnt_forward(model, feats, sb["targets"])
        t_lens = encoder_out_len(
            step.feature_lens_from_samples(sb["audio_lens"], fspec), spec.encoder)
        if (audio.shape[1], text.shape[1]) != (expect_t, expect_u1):
            raise AssertionError(f"eval shapes T'={audio.shape[1]} U1={text.shape[1]}, "
                                 f"expected {expect_t}, {expect_u1}")
        args = (model.joint, audio, text, sb["targets"], t_lens, sb["target_lens"],
                spec.blank_idx)
        nll_path = float(transducer_loss_pallas(*args))
        lpb, lpl = joint_lattice_log_probs(*args[:4], sb["target_lens"], spec.blank_idx,
                                           spec.loss_chunk_size)
        nll_plain = float(transducer_alpha_loss(lpb, lpl, t_lens, sb["target_lens"]).mean())
    if not abs(nll_path - nll_plain) <= PATH_NLL_RTOL * abs(nll_plain):
        raise AssertionError(f"eval NLL {nll_path} vs plain path {nll_plain}")
    log(f"one batch: NLL {nll_path:.4f} (kernels) vs {nll_plain:.4f} (plain) "
        f"at T'={audio.shape[1]}, U1={text.shape[1]}")
    return dict(launches=launches, nll=res["nll"], wer=res["wer"],
                audio_s_per_s=res["audio_seconds"] / res["seconds"],
                n_params=n_params, cfg=cfg, model=model)


TRAIN_OVERRIDES = ["data.dataset=synthetic",
                   "data.synthetic_seconds=10", "data.synthetic_size=96",
                   "training.global_batch_size=4", "training.pruned_warmup_steps=2",
                   "training.log_steps=1", "training.eval_max_elements=8",
                   "tokenizer.spm_model=''"]


def _read_steps(run_dir: Path) -> list[dict]:
    """Per-step records of a run's metrics.jsonl (log_steps = 1): loss,
    gradient norm, seconds, audio-s/s and the kernels' launches in the step."""
    rows: dict[int, dict] = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        r = json.loads(line)
        rows.setdefault(r["step"], {}).update(r)
    return [dict(step=s, loss=r["loss/train"], grad_norm=r["total_norm/train"],
                 seconds=r["step_seconds"], audio_s_per_s=r["audio_seconds_per_sec"],
                 launches={k.split("/", 1)[1]: n for k, n in r.items()
                           if k.startswith("launches/")})
            for s, r in sorted(rows.items()) if "loss/train" in r]


def train_phase(workdir: Path, device, kernels, config="base_convjs",
                overrides=TRAIN_OVERRIDES, warmup_steps=2) -> dict:
    """Drive the port's training path through cli.train and cli.eval."""
    from rnnt_tpu_torch.cli import eval as cli_eval
    from rnnt_tpu_torch.cli import train as cli_train
    from rnnt_tpu_torch.data.dataset import synthetic_piece_table

    vocab = workdir / "train_vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    exp = workdir / "exp"
    base = ["--config", config, "--output-base", str(exp), "--device", str(device)]
    for o in list(overrides) + [f"tokenizer.vocab_json={vocab}"]:
        base += ["--set", o]
    runs = {}
    k5 = "window_gather" if any(k.name == "window_gather" for k in kernels) else None

    def run(tag, key, extra, k5_per_step: int, cached: bool):
        """One cli.train run: every kernel but K5 launched in every step,
        K5 ``k5_per_step`` times in every step, the cache's line printed
        exactly when ``cached``."""
        for k in kernels:
            k.launches = 0
        t = time.time()
        out = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
            final_wer = cli_train.main(base + extra)
        sync(device)
        secs = time.time() - t
        launches = {k.name: k.launches for k in kernels}
        cache_line = next((ln for ln in out.getvalue().splitlines()
                           if ln.startswith("device sample cache:")), None)
        if (cache_line is not None) != cached:
            raise AssertionError(f"{tag}: cache line {cache_line!r}, expected "
                                 f"{'one' if cached else 'none'}")
        run_dir = max((exp / model_name).glob("run-*"), key=lambda p: int(p.name[4:]))
        steps = _read_steps(run_dir)
        for st in steps:
            log(f"  {tag} step {st['step']}: loss {st['loss']:.4f}, grad norm "
                f"{st['grad_norm']:.4f}, {st['seconds']:.4f} s, "
                f"{st['audio_s_per_s']:.2f} audio-s/s, launches {st['launches']}")
            if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
                raise AssertionError(f"{tag}: non-finite step {st}")
            missing = [k.name for k in kernels if k.name != k5 and not st["launches"].get(k.name)]
            if missing:
                raise AssertionError(f"{tag} step {st['step']}: kernels not "
                                     f"launched: {missing}")
            if k5 is not None and st["launches"].get(k5) != k5_per_step:
                raise AssertionError(f"{tag} step {st['step']}: K5 launched "
                                     f"{st['launches'].get(k5)} times, expected {k5_per_step}")
        log(f"{tag}: {len(steps)} steps, final WER {final_wer:.4f}, {secs:.1f} s "
            f"(with start-up and eval); launches in the run {launches}"
            + (f"; {cache_line}" if cache_line else "; batches streamed"))
        runs[key] = dict(launches=launches, steps=steps, run_dir=run_dir, seconds=secs,
                         cache=cache_line)

    from rnnt_tpu_torch.config.config import load_config, resolve_config
    model_name = load_config(resolve_config(config)).model_name
    # The flagship's data settings: augment true, augment_device full,
    # staging auto (the corpus cached on the card).
    run("pruned warmup (steps 1-2)", "pruned_warmup", ["--max-steps", str(warmup_steps)],
        4, True)
    first = runs["pruned_warmup"]["run_dir"]
    run("pruned banded (steps 3-4)", "pruned",
        ["--max-steps", str(2 * warmup_steps), "--resume",
         str(first / f"checkpoint_step_{warmup_steps}")], 4, True)
    run("exact loss_impl=auto", "auto",
        ["--max-steps", "2", "--set", "training.loss_impl=auto"], 4, True)
    run("exact loss_impl=auto, augmentation off", "auto_no_augment",
        ["--max-steps", "2", "--set", "training.loss_impl=auto",
         "--set", "data.augment=false"], 0, True)
    run("host recipe in 2 threads + SpecAugment (pruned warmup)", "host_augment",
        ["--max-steps", "2", "--set", "data.augment_device=false",
         "--set", "data.num_workers=2", "--set", "training.spec_augment=true"], 0, False)
    ckpt = runs["pruned"]["run_dir"] / f"checkpoint_step_{2 * warmup_steps}"
    res = cli_eval.main([str(ckpt), "--device", str(device), "--batch-size", "4",
                         "--max-elements", "8"])
    log(f"cli.eval on {ckpt.name}: WER {res['wer']:.4f} over {res['utterances']} utterances")
    if not math.isfinite(res["wer"]):
        raise AssertionError(f"cli.eval WER {res['wer']} on the trained checkpoint")
    total = {k.name: sum(r["launches"][k.name] for r in runs.values()) for k in kernels}
    per_step = {impl: {k.name: [st["launches"][k.name] for st in r["steps"]]
                       for k in kernels} for impl, r in runs.items()}
    return dict(runs=runs, launches=total, per_step=per_step,
                overrides=list(overrides), vocab=vocab, config=config)


def _train_setup(device, train: dict):
    """(cfg, spec, fspec, model, one eval batch on ``device``) of the train
    phase's configuration with augmentation off, the model fresh from seed
    0."""
    from rnnt_tpu_torch.config.config import (
        apply_overrides, build_featurizer_spec, build_model_spec, load_config,
        resolve_config)
    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.train import loop, step

    cfg = apply_overrides(load_config(resolve_config(train["config"])),
                          train["overrides"] + ["data.augment=false",
                                                f"tokenizer.vocab_json={train['vocab']}"])
    spec = build_model_spec(cfg)
    model = rnnt_init(spec, seed=0, device=device)
    tokenizer = loop._load_tokenizer(cfg)
    batch = next(iter(loop.eval_batches(cfg, tokenizer, batch_size=4, max_batches=1)))
    return cfg, spec, build_featurizer_spec(cfg), model, step.batch_to_device(batch, device)


class _Tee(io.TextIOBase):
    """Write to several text streams at once."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


class _RoundBF16(torch.autograd.Function):
    """Forward: round to bf16 (kept in float32); backward: the identity."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


class _TanhBF16(torch.autograd.Function):
    """tanh rounded to bf16 (kept in float32); backward g (1 - h^2) from
    the rounded h, as K2 forms it."""

    @staticmethod
    def forward(ctx, x):
        h = torch.tanh(x).to(torch.bfloat16).float()
        ctx.save_for_backward(h)
        return h

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return g * (1.0 - h * h)


class _RoundGradBF16(torch.autograd.Function):
    """Forward: the identity; backward: the cotangent rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def joint_outputs_reference(enc, pred, w, b, labels, blank: int,
                            grad_clamp: float = -1.0):
    """``fused_joint_outputs`` in plain PyTorch under autograd, rounded where
    K1 and K2 round and nowhere else: the bf16 sum before tanh and h in the
    forward, dl (the logits' cotangent) in bf16 for the dh and dW products;
    dh, 1 - h^2 (of the rounded h) and every sum in float32."""
    if grad_clamp > 0:
        raise ValueError("the reference joint takes no gradient clamp")
    s = _RoundBF16.apply(enc.float()[:, :, None, :] + pred.float()[:, None, :, :])
    h = _TanhBF16.apply(s)
    logits = _RoundGradBF16.apply(h @ w.float()) + b.float()
    B, T, U1, _ = logits.shape
    idx = labels.long()[:, None, :, None].expand(B, T, U1, 1)
    return (torch.logsumexp(logits, dim=-1), logits[..., blank],
            torch.gather(logits, 3, idx)[..., 0])


def lattice_nll_reference(lp_blank, lp_label, t_lens, u_lens):
    """The lattice NLL by autograd of the plain alpha recursion in float64."""
    from rnnt_tpu_torch.ops.transducer import transducer_alpha_loss

    return transducer_alpha_loss(lp_blank.double(), lp_label.double(),
                                 t_lens, u_lens).float()


def nll_with_occupancy_reference(lp_blank, lp_label, t_lens, u_lens):
    """(losses, gamma) of ``nll_with_occupancy`` by autograd of the plain
    alpha recursion: gamma = -d(losses)/d(lp_label)."""
    losses = lattice_nll_reference(lp_blank, lp_label, t_lens, u_lens)
    gamma = -torch.autograd.grad(losses.sum(), lp_label, retain_graph=True)[0]
    return losses, gamma.detach()


@contextlib.contextmanager
def reference_leaves(bounds: list):
    """Run the losses of ops/transducer_pallas.py and ops/transducer_pruned.py
    on ``joint_outputs_reference`` and the autograd of the plain alpha
    recursion instead of K1-K4; ``prune_bounds`` returns ``bounds.pop(0)``
    (the kernel run's band starts, so both runs score the same band)."""
    from rnnt_tpu_torch.ops import transducer_pallas as tp
    from rnnt_tpu_torch.ops import transducer_pruned as tpr

    saved = (tp.fused_joint_outputs, tp.lattice_nll, tpr.lattice_nll,
             tpr.nll_with_occupancy, tpr.prune_bounds)
    tp.fused_joint_outputs = joint_outputs_reference
    tp.lattice_nll = tpr.lattice_nll = lattice_nll_reference
    tpr.nll_with_occupancy = nll_with_occupancy_reference
    tpr.prune_bounds = lambda *a: bounds.pop(0)
    try:
        yield
    finally:
        (tp.fused_joint_outputs, tp.lattice_nll, tpr.lattice_nll,
         tpr.nll_with_occupancy, tpr.prune_bounds) = saved


def grad_phase(device, kernels, train: dict) -> dict:
    """Loss and every parameter gradient of one full-width bf16 batch
    (dropout off) through the kernels against plain references, for the
    exact loss (``transducer_loss_pallas``) and the banded pruned loss
    (``pruned_transducer_loss``)."""
    from rnnt_tpu_torch.models.encoder import encoder_out_len
    from rnnt_tpu_torch.models.rnnt import rnnt_forward
    from rnnt_tpu_torch.ops import transducer_pruned as tpr
    from rnnt_tpu_torch.ops.stft import make_featurizer
    from rnnt_tpu_torch.ops.transducer import joint_lattice_log_probs
    from rnnt_tpu_torch.ops.transducer_pallas import transducer_loss_pallas
    from rnnt_tpu_torch.train import step

    cfg, spec, fspec, model, sb = _train_setup(device, train)
    names, params = zip(*model.named_parameters())

    def loss_and_grads(fn):
        feats = make_featurizer(fspec)(step.decode_wire_audio(sb["audio"]))
        feats = feats.to(step.compute_dtype(cfg.training.precision))
        audio, text, _ = rnnt_forward(model, feats, sb["targets"], training=True)
        t_lens = encoder_out_len(
            step.feature_lens_from_samples(sb["audio_lens"], fspec), spec.encoder)
        loss = fn(model.joint, audio, text, sb["targets"], t_lens, sb["target_lens"],
                  spec.blank_idx)
        *grads, d_audio, d_text = torch.autograd.grad(
            loss, (*params, audio, text), allow_unused=True)
        return float(loss.detach()), grads, (d_audio, d_text)

    def param_errors(what, grads_k, grads_p):
        """[(relative L2 error, name)] of each parameter with a reference
        gradient, the norm floored at GRAD_FLOOR x the global norm."""
        floor = GRAD_FLOOR * float(step.global_norm([g for g in grads_p if g is not None]))
        errs = []
        for n, gk, gp in zip(names, grads_k, grads_p):
            if gp is None or float(gp.float().norm()) == 0.0:
                if gk is not None and float(gk.float().norm()) != 0.0:
                    raise AssertionError(f"{what}: {n}: gradient on the kernel path only")
                continue
            errs.append((float((gk.float() - gp.float()).norm())
                         / max(float(gp.float().norm()), floor), n))
        return sorted(errs, reverse=True)

    def compare(what, kernel, reference, joint_limit, limit):
        """The joint's inputs' and parameters' gradients within
        ``joint_limit``, the encoder's and the predictor's within ``limit``."""
        (loss_k, grads_k, outs_k), (loss_p, grads_p, outs_p) = kernel, reference
        if not abs(loss_k - loss_p) <= PATH_NLL_RTOL * abs(loss_p):
            raise AssertionError(f"{what}: loss {loss_k} (kernels) vs {loss_p}")
        near = [(rel_l2(gk, gp), n) for n, gk, gp in
                zip(("d encoder output", "d predictor output"), outs_k, outs_p)]
        far = []
        for e, n in param_errors(what, grads_k, grads_p):
            (near if n.startswith("joint.") else far).append((e, n))
        for group, lim in ((near, joint_limit), (far, limit)):
            bad = [(e, n) for e, n in group if not e <= lim]
            if bad:
                raise AssertionError(f"{what}: gradient relative L2 error above {lim}: "
                                     + ", ".join(f"{n} {e:.3e}" for e, n in bad))
        near.sort(reverse=True)
        log(f"gradient check, {what}: loss {loss_k:.4f} (kernels) vs {loss_p:.4f}; "
            f"joint inputs and parameters within relative L2 {joint_limit}, worst "
            + ", ".join(f"{n} {e:.2e}" for e, n in near[:3])
            + f"; {len(far)} encoder and predictor parameters within {limit}, worst "
            + ", ".join(f"{n} {e:.2e}" for e, n in far[:3]))
        return dict(loss=loss_k, loss_reference=loss_p, joint_worst=near[:3],
                    worst=far[:3])

    def encoder_backward_witness(d_audio_k, d_audio_r):
        """The kernels' and the reference's d loss / d encoder output sent
        back through one and the same encoder graph: the parameters' errors
        that the encoder's bf16 backward makes of that difference alone,
        and of none (the reference's sent back twice)."""
        feats = make_featurizer(fspec)(step.decode_wire_audio(sb["audio"]))
        feats = feats.to(step.compute_dtype(cfg.training.precision))
        audio = rnnt_forward(model, feats, sb["targets"], training=True)[0]

        def back(d):
            return torch.autograd.grad(audio, params, d, retain_graph=True,
                                       allow_unused=True)

        ref = back(d_audio_r)
        diff = param_errors("encoder witness", back(d_audio_k), ref)
        again = param_errors("encoder witness", back(d_audio_r), ref)
        log(f"encoder backward alone: d encoder output {rel_l2(d_audio_k, d_audio_r):.2e} "
            "apart gives parameter errors " + ", ".join(f"{n} {e:.2e}" for e, n in diff[:3])
            + f"; the same cotangent twice: worst {again[0][1]} {again[0][0]:.2e}")
        return dict(worst=diff[:3], repeat_worst=again[0])

    def plain(fn):
        before = [k.launches for k in kernels]
        out = loss_and_grads(fn)
        if [k.launches for k in kernels] != before:
            raise AssertionError("a kernel launched in a plain reference")
        return out

    out = {}
    exact_k = loss_and_grads(transducer_loss_pallas)
    with reference_leaves([]):
        exact_r = plain(transducer_loss_pallas)
    out["exact"] = compare("exact loss vs the kernels' rounding in plain autograd",
                           exact_k, exact_r, JOINT_REL_L2, GRAD_REL_L2)
    out["encoder_witness"] = encoder_backward_witness(exact_k[2][0], exact_r[2][0])
    del exact_r
    out["exact_bf16"] = compare(
        "exact loss vs the bf16 chunked joint under autograd", exact_k,
        plain(lambda *a: lattice_nll_reference(
            *joint_lattice_log_probs(*a[:4], a[5], a[6], spec.loss_chunk_size),
            a[4], a[5]).mean()),
        JOINT_BF16_REL_L2, GRAD_REL_L2)
    del exact_k

    def pruned(*a):
        return tpr.pruned_transducer_loss(
            *a, band=spec.pruned_band, simple_scale=spec.pruned_simple_scale,
            pruned_scale=spec.pruned_scale)

    bounds, prune_bounds = [], tpr.prune_bounds

    def recording(*a):
        bounds.append(prune_bounds(*a))
        return bounds[-1]

    tpr.prune_bounds = recording
    try:
        pruned_k = loss_and_grads(pruned)
    finally:
        tpr.prune_bounds = prune_bounds
    with reference_leaves(bounds):
        pruned_r = plain(pruned)
    out["pruned"] = compare("banded pruned loss vs the kernels' rounding in plain "
                            "autograd", pruned_k, pruned_r, JOINT_REL_L2, GRAD_REL_L2)
    return out


def report_trace(prof, wall_s: float, what: str, out: Path, top: int = 15,
                 kind=torch.autograd.DeviceType.CUDA) -> float:
    """Print the device time by kernel (events of ``kind``) and the device's
    busy and idle share of ``wall_s``; write the gzipped Chrome trace to
    ``out``.gz.  Returns the idle share in percent."""
    kernels = [e for e in prof.events() if e.device_type == kind]
    if not kernels:
        raise AssertionError("the profiler saw no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    idle = 100 - busy_us / 1e4 / wall_s
    log(f"profile: {what}, {wall_s:.3f} s wall (traced), {len(kernels)} kernels, "
        f"device busy {busy_us / 1e3:.2f} ms = {busy_us / 1e4 / wall_s:.1f} % of wall, "
        f"idle {idle:.1f} %")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:110]}")
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    with open(out, "rb") as src, gzip.open(f"{out}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    out.unlink()
    log(f"trace written to {out}.gz")
    return idle


def _activities(device):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def profile_phase(cfg, model, device, out_dir: Path) -> None:
    """Trace one ``evaluate`` pass over 2 batches with torch.profiler."""
    from torch.profiler import profile

    from rnnt_tpu_torch.train import loop

    tokenizer = loop._load_tokenizer(cfg)
    batches = list(loop.eval_batches(cfg, tokenizer, batch_size=4, max_batches=2))
    loop.evaluate(cfg, model, device=device, batches=batches[:1])  # warm-up
    with profile(activities=_activities(device)) as prof:
        res = loop.evaluate(cfg, model, device=device, batches=batches)
    report_trace(prof, res["seconds"],
                 f"eval, {len(batches)} batches (exact loss {res['loss_seconds']:.3f} s, "
                 f"forward + greedy decode {res['decode_seconds']:.3f} s)",
                 out_dir / "eval_trace.json")


def profile_train_phase(device, train: dict, out_dir: Path, steps: int = 3,
                        kind=torch.autograd.DeviceType.CUDA,
                        device_augment=False) -> None:
    """Trace ``steps`` train steps of the banded pruned loss (after 2
    warm-up steps) at full width with torch.profiler, with or without
    device augmentation: device time by kernel and the idle share of the
    steps' wall time."""
    import dataclasses

    from torch.profiler import profile

    from rnnt_tpu_torch.train import loop, step
    from rnnt_tpu_torch.train.optim import make_optimizer

    cfg, spec, fspec, model, _ = _train_setup(device, train)
    tc = cfg.training
    it = loop.BatchIterator(
        loop._load_datasets(cfg)[0], loop._load_tokenizer(cfg),
        loop.Buckets.from_frames(tc.frame_buckets, tc.token_buckets, fspec),
        batch_size=tc.global_batch_size, seed=0, wire_dtype=cfg.data.wire_dtype)
    batches = [step.batch_to_device(b, device) for b, _ in zip(it, range(steps + 2))]
    optimizer, _ = make_optimizer(tc, 100)
    fn = step.make_train_step(dataclasses.replace(spec, loss_impl="pruned"), fspec,
                              optimizer, tc.precision, device_augment=device_augment)
    state = step.TrainState(model, optimizer.init(dict(model.named_parameters())))
    for b in batches[:2]:
        state, m = fn(state, b, loop.step_generator(device, 0, state.step))
    sync(device)
    t0 = time.time()
    with profile(activities=_activities(device)) as prof:
        for b in batches[2:]:
            state, m = fn(state, b, loop.step_generator(device, 0, state.step))
            float(m["loss"])
    wall = time.time() - t0
    audio = sum(float(b["audio_lens"].sum()) for b in batches[2:]) / fspec.sample_rate
    what = "device augmentation full" if device_augment else "augmentation off"
    report_trace(prof, wall, f"{steps} train steps (pruned, banded, {what}; {audio:.1f} s "
                 f"of audio, {audio / wall:.2f} audio-s/s traced)",
                 out_dir / ("train_aug_trace.json" if device_augment else "train_trace.json"),
                 kind=kind)


def main() -> None:
    ap = argparse.ArgumentParser(description="PyTorch port smoke run on one card")
    ap.add_argument("--profile", metavar="DIR", type=Path, default=None,
                    help="also trace two eval batches and three train steps with "
                         "torch.profiler, print device time by kernel and the idle "
                         "share, and write DIR/{eval,train}_trace.json.gz")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs an NVIDIA card")
    if not (REPO / "rnnt_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(rnnt_tpu_torch/ is missing)")
    sys.path.insert(0, str(REPO))
    from rnnt_tpu_torch.config.config import (
        build_featurizer_spec, load_config, resolve_config)
    from rnnt_tpu_torch.ops.kernels import build_all
    from rnnt_tpu_torch.ops.lattice_pallas import K3, K4
    from rnnt_tpu_torch.ops.transducer_pallas import K1, K2
    from rnnt_tpu_torch.ops.window_gather import K5

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}; TF32 off for fp32 matmuls and convs")

    t0 = time.time()
    kernels = [K1, K2, K3, K4, K5]
    secs = build_all(kernels)
    log(f"built {[k.name for k in kernels]} in {secs:.1f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    # The flagship bucket the synthetic 10 s utterances land in: 1024 frames.
    L = build_featurizer_spec(load_config(resolve_config("base_convjs"))).samples_for_frames(1024)
    measured = kernel_phase(device)
    measured.update(train_kernel_phase(device))
    measured["K5"] = k5_phase(device, L)
    augment = augment_phase(device, K5, L)
    with tempfile.TemporaryDirectory() as tmp:
        path = path_phase(Path(tmp), device, [K1, K3])
        if args.profile is not None:
            profile_phase(path["cfg"], path["model"], device, args.profile)
        del path["model"]
        train = train_phase(Path(tmp), device, kernels)
        grad_phase(device, kernels, train)
        if args.profile is not None:
            profile_train_phase(device, train, args.profile)
            profile_train_phase(device, train, args.profile, device_augment="full")

    entries = []
    for key, k in (("K1", K1), ("K2", K2), ("K3", K3), ("K4", K4), ("K5", K5)):
        m = measured[key]
        extra = {c: m[c] for c in ("long_case", "banded_case", "cases") if c in m}
        if k.name in path["launches"]:
            extra["eval_launches"] = path["launches"][k.name]
        entries.append(dict(
            name=f"{key} {k.name}", route="cuda",
            source=f"rnnt_tpu_torch/csrc/{k.name}.cu", replaces=k.replaces,
            launches=train["launches"][k.name],
            launches_per_step={impl: c[k.name] for impl, c in train["per_step"].items()},
            max_abs_err=m["max_abs_err"],
            ms=m["ms"], kernel_ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=m.get("library_ms"),
            library_note=("torch.gather on the zero-padded rows with a prebuilt index; "
                          "K5's ms, plain_ms and library_ms are device time from "
                          "torch.profiler summed over the 4 calls of one step"
                          if "library_ms" in m
                          else "no single PyTorch call computes this function"),
            shape=m["shape"], **extra))
    entries[-1]["augment_call"] = augment
    log(f"total {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
