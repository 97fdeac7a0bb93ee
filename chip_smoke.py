#!/usr/bin/env python3
"""Prove that the PyTorch port runs on one NVIDIA card (H100, sm_90a).

Run ``python3 chip_smoke.py`` (no arguments) from the repository root:

1. print the card (``nvidia-smi`` name and power limit) and stop with a
   nonzero exit when CUDA is missing;
2. build the hand-written kernels from ``rnnt_tpu_torch/csrc`` with nvcc,
   one process per source, all started together;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main paths' shapes — K1 and K2 at the eval shape, at the
   banded patches of the pruned loss (K2 with and without the gradient
   clamp) and at scaled_tp's joint width (2, 32, 17, 2048, 1024), K1 also
   at two shapes whose H or V is not a multiple of 8, K3 and K4 at the
   eval shape and at a long-label shape, K5 at the
   four calls one flagship ``device_augment_full`` makes (recorded from a
   call on a full-width batch: chorus, resample, trim, time-stretch frames)
   and at edge cases — with the tolerances stated below, timed with CUDA
   events (median after warm-up) beside the least time the card could take
   and, for K5, one ``torch.gather`` call computing the same function; K1
   and K2 with their device time split by kernel (K1's h and lse passes,
   K2's h, dl, dh and dW passes; torch.profiler), their TFLOP/s, and a
   GEMM yardstick (``gemm_ms``: their bare products as ``torch.matmul``,
   which the port never calls); K2 fed K1's lse with one row's g_lse set,
   whose db (that row's softmax) must sum to 1 within 1e-5, at 8 rows; K3
   and K4 also with
   their device time (torch.profiler) and a critical-path bound: their
   number of anti-diagonals x the latency of one dependent LSE step of
   the kernels' own LSE, timed on a one-warp chain (``rnnt_lse_chain``);
   then K1 and K2 on vocabulary slices (slice 12): scaled_tp's joint at
   (2, 32, 17, 2048, 1024), at the banded loss's patches (128, 16, 16,
   2048, 1024) and at the tp case's own lattice (4, 512, 65, 2048, 1024),
   each cut into two 512-wide slices at v0 = 0 and 512 (the blank on the
   second, label 0 on the first), each slice against its plain version
   (K1_TOL, K2_REL_L2) and timed beside its bound, the slices' K1 outputs
   merged (lse by logsumexp, blank and label summed) against whole-V K1
   and its plain version, and K2 from the merged lse (dW concatenated,
   denc and dpred summed) against whole-V K2 and its plain version; K3
   and K4 against their plain versions on the tp case's (4, 512, 65)
   lattice;
3a. chain phase (slice 4): K6 and K7 on every shard of the eval lattice
   (4, 504, 65) cut into 2 shards and the long lattice (4, 1000, 257) cut
   into 4, each shard at its global row offset with the previous (K6) or
   next (K7) shard's carry and t_lens that end inside, at the edge of and
   before a shard, against their plain versions; the chain of shards
   against K3 + K4 on the whole lattice; per shard the burst time (20
   back-to-back launches of the C entry point between two events), the
   device time (torch.profiler) and the events time around one wrapper
   call, beside the bytes bound and a critical-path bound (the shard's
   diagonals x one LSE step);
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
4a. serve phase (slice 10; no transducer kernel on this path, so K1-K7
   must launch 0 times in it): StreamingSessions on full-width
   ``base_convjs_fullcausal`` (batch norm; random weights from seed 0,
   batch-norm statistics drawn in [0.5, 1.5]) fed 0.2 s chunks, against
   offline featurize + encoder + greedy decode over the same encoder
   frames: equal tokens at blank bias 0.25 (10 s, about a token a frame)
   and at 0 (4 s, emitting at the per-frame cap), a case with no token a
   failure, the streamed encoder frames within
   SERVE_STREAM_REL of the offline output's scale, the smallest top-2
   logit margin printed; the pool at the load of the JAX package's serving
   benchmark (``bench.py`` ``bench_serve``: full-width ``base_convjs``,
   random weights from seed 0, 16 streams of 10 s, 0.2 s chunks, 2 warm-up
   chunks): audio-s/s, step p50/p99, batched lanes, tokens, host syncs a
   pump, streams 0-2 equal to dedicated sessions; ``python -m
   rnnt_tpu_torch.cli.serve`` on a checkpoint of that model, 4 concurrent
   HTTP clients of 2 s (one at 48 kHz), /text, the 503 past the slots,
   DELETE, /stats (device steps >= 1, mean batched lanes > 1); a
   ``{"serve": ...}`` line before the kernels line;
4b. decode phase (slice 11) on full-width ``base_convjs`` (random weights
   from seed 0, the bf16 eval forward): beam 8 with the defaults at
   ``bench.py`` ``bench_beam``'s load (16 synthetic 10 s utterances,
   ``max_tokens`` 200): audio-s/s, ms a call, expansion rounds, host syncs
   and kernel launches a call, counts <= 200, every returned score >= the
   width-1 raw run's (the greedy guard); at blank bias DECODE_BIAS on 4
   utterances, width 1 (raw ranking, no merge, no guard) equal to
   greedy_decode and width 4 with window 8 equal to window 1, tokens
   emitted but fewer than the buffer, the smallest top-2 margin printed;
   ``beam_decode_nbest`` (width 8 + greedy: 9 candidates) and
   ``marginal_rescore`` on 4 utterances, K1-K7's counts set to 0 before the
   rescore: K3 launched and no other kernel, the NLLs within RESCORE_RTOL
   of the plain alpha on the same log-probs, the picks the plain minimum
   within RESCORE_RTOL, the lattice's shape, the rescore's ms and K3's
   device ms at that shape beside its bounds;
4c. LSTM phase (slice 11): ``cli.train`` 2 steps on full-width
   ``base_sp_lstm`` (80-mel, 2 x 1024 layer-normed LSTM; its data
   settings, synthetic 10 s utterances, batch 4): K1-K4 in every step,
   K5-K7 never, loss and gradient norm finite; ``cli.eval`` on its
   checkpoint greedy and ``--beam 4 --rescore``, finite WERs; streamed
   against offline on ``base_sp_lstm`` with batch norm and an uncentred
   featurizer (LSTM_STREAM_OVERRIDES) at blank bias LSTM_STREAM_BIAS, as
   in 4a; a ``{"decode": ...}`` line (4b and 4c) before the kernels line;
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
6b. multi-rank phase (slice 4): ``python -m torch.distributed.run
   --nproc-per-node 2 -m rnnt_tpu_torch.cli.train`` on full-width
   ``base_convjs`` with the YAML's data settings, 2 ranks sharing this
   card over gloo (``--device cuda:0 --dist-backend gloo``), 2 steps: the
   T-sharded lattice (``lattice_shard_t=true, mesh.model=2``; K6 and K7
   once per step on each rank, K3/K4 never; rank 0's eval through K1 +
   K3) against 1 rank with the chunked loss, and the data-parallel
   flagship (``mesh.data=2``, 1 pruned-warmup step and 1 banded step; K1-K5
   on each rank) against 1 rank; the tensor-parallel joint (slice 12):
   full-width ``scaled_tp`` (202,905,216 parameters; synthetic 10 s
   utterances, the batch cut from 16 to 4 to bound the phase's time) on
   ``mesh.data=1 mesh.model=2``, 2 steps, each rank holding V / 2 of the
   joint and H / 2 of ``encoder.out`` and ``predictor.linear`` (the count
   it prints is read back), K1-K4 once per step on each rank and K5-K7
   never, every rank's replicated parameters bit-equal after the steps
   (cli.train's line, read back); the same with the pruned loss (1 warmup
   step and 1 banded step, K1 and K2 on V slices in both); batch norm over
   the data group (slice 12): full-width
   ``base_convjs_fullcausal`` on ``mesh.data=2``, 1 step, K1-K4 once a
   rank; each step's loss and gradient norm within the stated tolerances;
   then what the transport costs: a carry row per hop, the log-likelihood
   all-reduce and the flat gradient all-reduce over gloo, and the
   tensor-parallel joint's collectives at scaled_tp's shapes (the lse
   merge, K2's denc and dpred all-reduce, encoder.out's gather and its
   input gradient's all-reduce; ``--exchange``, one rank of that
   measurement);
7. print the card's name and power limit, a ``{"multi_rank": ...}`` line,
   a ``{"serve": ...}`` line, a ``{"decode": ...}`` line, a
   ``{"kernels": [...]}`` line (K1-K7; K1's and K2's entries with their
   slice cases and launches per tensor-parallel step, K3's with its
   rescoring case), then, last, the ``{"ok": true, ...}`` line.

``--profile DIR`` adds torch.profiler traces of two eval batches (after
the path phase) and of three banded train steps without and with device
augmentation (after the gradient check), and of five pool pumps at the
serving load (in the serve phase): device time by kernel and by group
(K1-K7, cuDNN's convolutions, the rest) per batch, step or pump, the
card's busy and idle share, and ``DIR/eval_trace.json.gz``,
``DIR/train_trace.json.gz``, ``DIR/train_aug_trace.json.gz`` and
``DIR/serve_pool_trace.json.gz``.
``--parent-lattice DIR`` builds another tree's K3, K4, K6 and K7 sources
from DIR (``alpha_fwd.cu``, ``beta_bwd.cu``, ``alpha_chain.cu``,
``beta_chain.cu`` and their headers) with the same flags and times them in
turns with this tree's (other, this, this, other): K3 and K4 at the eval
and long shapes, K6 and K7 on every shard of both chain cases, after
checking both trees against the plain versions.
``--parent-joint DIR`` (repeatable) does the same for another tree's K1
(``joint_fwd.cu`` and its headers, called through that tree's own C
signature) at the eval and banded shapes.

Every check raises on failure, so a failed phase exits nonzero before the
last line.  float32 matmuls and cuDNN convs run without TF32 here (both
``allow_tf32`` flags are set False) so that fp32 comparisons mean fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gzip
import io
import json
import math
import os
import re
import shutil
import signal
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
    return sum(device_ms_by_kernel(fn, reps).values())


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


def lse_step_ms(device, n: int = 4096, reps: int = 5) -> float:
    """Milliseconds of one dependent step x = lse(x + a, b) of the lattice
    kernels' own LSE (``rnnt_lse_chain`` in alpha_fwd.cu: one warp, n
    steps): (time of 2n steps - time of n steps) / n, CUDA events, so the
    launch cancels.  The critical-path bound of K3 and K4 is this x their
    number of diagonals.  On the CPU (a rehearsal) it is 0."""
    if torch.device(device).type != "cuda":
        return 0.0
    from rnnt_tpu_torch.ops.lattice_pallas import K3

    fn = K3.entry("rnnt_lse_chain", [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty(32, device=device)

    def chain(steps):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if fn(-0.5, -1.0, steps, ctypes.c_void_p(out.data_ptr()), stream) != 0:
            raise RuntimeError("rnnt_lse_chain: CUDA error at launch")

    ms = (cuda_ms(lambda: chain(2 * n), reps) - cuda_ms(lambda: chain(n), reps)) / n
    if not (bool(torch.isfinite(out).all()) and ms > 0):
        raise AssertionError(f"lse chain: {ms} ms a step, finite {torch.isfinite(out).all()}")
    return ms


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


# K1 at scaled_tp's joint width (`hidden_features: 2048`), and shapes whose H
# or V is not a multiple of 8 (enc, pred and W zero-padded by the wrapper).
K1_WIDE = dict(B=2, T=32, U1=17, H=2048, V=1024)
K1_ODD = (dict(B=2, T=9, U1=5, H=36, V=37), dict(B=1, T=5, U1=130, H=100, V=1000))
# K2's softmax from K1's lse: each probed row's probabilities sum to 1
# within this (both kernels round h by one device function).
K1_K2_SUM_ATOL = 1e-5


def k1_gemm_ms(B, T, U1, H, V, device, reps: int) -> float:
    """The GEMM yardstick: K1's product h.W as one bare torch.matmul on
    bf16 (B*T*U1, H) x (H, V).  Timed beside K1, never called by the port."""
    g = torch.Generator().manual_seed(2)
    h = torch.randn(B * T * U1, H, generator=g).to(torch.bfloat16).to(device)
    w = torch.randn(H, V, generator=g).to(torch.bfloat16).to(device)
    return cuda_ms(lambda: torch.matmul(h, w), reps)


def k1_k2_softmax_sums(device, dims=EVAL_SHAPE, probes: int = 8) -> float:
    """K2 fed K1's lse with g_lse one-hot at one row and the other
    cotangents zero: its db is that row's softmax.  For ``probes`` rows
    spread over the row tiles, |db.sum() - 1| <= K1_K2_SUM_ATOL; returns
    the largest gap."""
    from rnnt_tpu_torch.ops.transducer_pallas import fused_joint_backward, fused_joint_forward

    args = k1_inputs(**dims, device=device)
    lse = fused_joint_forward(*args)[0]
    n = lse.numel()
    zeros = torch.zeros_like(lse)
    gap = 0.0
    for i in range(probes):
        row = min(n - 1, i * (n // probes) + 77 * i)
        g_lse = torch.zeros_like(lse)
        g_lse.view(-1)[row] = 1.0
        db = fused_joint_backward(*args, lse, zeros, zeros, g_lse)[3]
        gap = max(gap, abs(float(db.double().sum()) - 1.0))
    if not gap <= K1_K2_SUM_ATOL:
        raise AssertionError(f"K1/K2: a row's softmax from K1's lse sums to 1 +- {gap:.3e} "
                             f"> {K1_K2_SUM_ATOL}")
    log(f"K1/K2 ok {dims}: K2's softmax against K1's lse sums to 1 within {gap:.3e} "
        f"over {probes} rows")
    return gap


def kernel_phase(device, shape=EVAL_SHAPE, banded=BANDED_SHAPE, long_case=K3_LONG,
                 wide=K1_WIDE, odd=K1_ODD, reps=20) -> dict:
    from rnnt_tpu_torch.ops.lattice_pallas import alpha_forward, alpha_plain
    from rnnt_tpu_torch.ops.transducer_pallas import (
        fused_joint_outputs, fused_joint_outputs_plain)

    out = {}
    for dims in odd:
        args = k1_inputs(**dims, device=device)
        err = max(check_close(f"K1 odd {dims} {n}", g, w, **K1_TOL)
                  for n, g, w in zip(("lse", "blank", "label"), fused_joint_outputs(*args),
                                     fused_joint_outputs_plain(*args)))
        log(f"K1 odd ok {dims}: max abs err {err:.3e}")
    for tag, dims in (("eval", shape), ("banded", banded), ("wide", wide)):
        args = k1_inputs(**dims, device=device)
        got = fused_joint_outputs(*args)
        want = fused_joint_outputs_plain(*args)
        err = max(check_close(f"K1 {tag} {n}", g, w, **K1_TOL)
                  for n, g, w in zip(("lse", "blank", "label"), got, want))
        del got, want
        call = lambda: fused_joint_outputs(*args)  # noqa: E731
        m = dict(
            max_abs_err=err, ms=cuda_ms(call, reps),
            plain_ms=cuda_ms(lambda: fused_joint_outputs_plain(*args), 3, warmup=1),
            bound_ms=k1_bound_ms(**dims), bound_by="operations",
            shape="B={B} T={T} U1={U1} H={H} V={V}".format(**dims))
        if torch.device(device).type == "cuda":
            m["passes_ms"] = device_ms_by_kernel(call, reps)
            m["device_ms"] = sum(m["passes_ms"].values())
        m["gemm_ms"] = k1_gemm_ms(**dims, device=device, reps=reps)
        m["gemm_note"] = ("gemm_ms: h.W as one bare torch.matmul on bf16 (N, H) x (H, V), "
                          "a yardstick the port never calls")
        flops = 2.0 * dims["B"] * dims["T"] * dims["U1"] * dims["H"] * dims["V"]
        m["tflops"] = flops / (m.get("device_ms", m["ms"]) * 1e-3) / 1e12
        del args
        passes = ", ".join(f"{k} {v:.4f}" for k, v in m.get("passes_ms", {}).items())
        log(f"K1 {tag} ok {dims}: max abs err {err:.3e}, {m['ms']:.4f} ms (device "
            f"{m.get('device_ms', float('nan')):.4f} ms = {m['tflops']:.1f} TFLOP/s; plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms, gemm yardstick "
            f"{m['gemm_ms']:.4f} ms); device ms by kernel: {passes}")
        if tag == "eval":
            out["K1"] = m
        else:
            out["K1"][f"{tag}_case"] = m
    out["K1"]["k1_k2_softmax_gap"] = k1_k2_softmax_sums(device, shape)

    lse_ms = lse_step_ms(device)
    log(f"one dependent LSE step (x = lse(x + a, b), lattice::lse): {lse_ms * 1e6:.2f} ns")
    for tag, dims in (("eval", dict(B=shape["B"], T=shape["T"], U1=shape["U1"])),
                      ("long", long_case)):
        k3 = k3_inputs(**dims, device=device)
        nll, alpha = alpha_forward(*k3)
        nll_p, alpha_p = alpha_plain(*k3)
        err = check_k3(nll, alpha, nll_p, alpha_p, k3[2], k3[3])
        ms = cuda_ms(lambda: alpha_forward(*k3), reps)
        dev_ms = device_ms(lambda: alpha_forward(*k3), reps)
        plain_ms = cuda_ms(lambda: alpha_plain(*k3), 1, warmup=0)  # host-bound: one call
        bound_ms, bound_by = k3_bound(**dims)
        path_ms = (dims["T"] + dims["U1"] - 1) * lse_ms
        log(f"K3 {tag} ok {dims}: max abs err {err:.3e}, {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms; plain {plain_ms:.4f} ms, bytes bound {bound_ms:.6f} ms, "
            f"critical-path bound {path_ms:.4f} ms = {dims['T'] + dims['U1'] - 1} "
            f"diagonals x {lse_ms * 1e6:.1f} ns)")
        m = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, critical_path_ms=path_ms,
                 lse_step_ns=lse_ms * 1e6, shape="B={B} T={T} U1={U1}".format(**dims))
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


def kernel_name(name: str) -> str:
    """A device kernel's profiler name cut to its function and template
    arguments: ``void sm90::gemm_kernel<(anonymous namespace)::DlPass>(...)``
    -> ``gemm_kernel<DlPass>``."""
    s = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    s = s.removeprefix("void ")
    base, _, args = s.partition("<")
    return (base.split("::")[-1] + (f"<{args}" if args else ""))[:60]


def device_ms_by_kernel(fn, reps: int = 10) -> dict[str, float]:
    """{kernel name: mean device ms per call of ``fn``} (torch.profiler),
    after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then reports no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = kernel_name(e.name)
            by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start)
        if by_name:
            return {k: v / reps / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    raise AssertionError("the profiler saw no device activity in 3 sessions")


def k2_case(dims, device):
    """K1's inputs at ``dims`` plus K2's saved lse and three cotangents."""
    from rnnt_tpu_torch.ops.transducer_pallas import fused_joint_outputs_plain

    args = k1_inputs(**dims, device=device)
    lse = fused_joint_outputs_plain(*args)[0]
    g = torch.Generator().manual_seed(1)
    gb, gl = (torch.randn(dims["B"], dims["T"], dims["U1"], generator=g).to(device) * 0.3
              for _ in range(2))
    return args, (lse, gb, gl, -(gb + gl))


def k2_gemm_ms(B, T, U1, H, V, device, reps: int) -> float:
    """The GEMM yardstick: K2's three bare products (h.W, dl.W^T, h^T.dl)
    as torch.matmul on bf16 operands of K2's shapes.  Timed beside K2, never
    called by the port."""
    g = torch.Generator().manual_seed(2)
    n = B * T * U1
    h = torch.randn(n, H, generator=g).to(torch.bfloat16).to(device)
    dl = torch.randn(n, V, generator=g).to(torch.bfloat16).to(device)
    w = torch.randn(H, V, generator=g).to(torch.bfloat16).to(device)

    def run():
        torch.matmul(h, w)
        torch.matmul(dl, w.T)
        torch.matmul(h.T, dl)

    return cuda_ms(run, reps)


# K2 at scaled_tp's joint width (`hidden_features: 2048`).
K2_WIDE = dict(B=2, T=32, U1=17, H=2048, V=1024)


def k2_phase(device, cases=(("eval", EVAL_SHAPE), ("banded", BANDED_SHAPE),
                            ("wide", K2_WIDE)), reps=20) -> dict:
    """K2 against its plain version at each case, clamp off and at 0.01,
    each output within K2_REL_L2; timed (CUDA events), its device time
    split by kernel (the passes), the GEMM yardstick and the TFLOP/s of
    its three products.  The first case's numbers are the entry, the
    others ``<tag>_case``."""
    from rnnt_tpu_torch.ops.transducer_pallas import fused_joint_backward, fused_joint_bwd_plain

    out = {}
    for tag, dims in cases:
        args, cot = k2_case(dims, device)
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
        call = lambda: fused_joint_backward(*args, *cot)  # noqa: E731
        m = dict(max_abs_err=err, ms=cuda_ms(call, reps),
                 plain_ms=cuda_ms(lambda: fused_joint_bwd_plain(*args, *cot), 3, warmup=1),
                 bound_ms=k2_bound_ms(**dims), bound_by="operations",
                 shape="B={B} T={T} U1={U1} H={H} V={V}".format(**dims))
        if torch.device(device).type == "cuda":
            m["passes_ms"] = device_ms_by_kernel(call)
        m["gemm_ms"] = k2_gemm_ms(**dims, device=device, reps=reps)
        m["gemm_note"] = ("gemm_ms: its three bare products as torch.matmul, a yardstick "
                          "the port never calls")
        flops = 6.0 * dims["B"] * dims["T"] * dims["U1"] * dims["H"] * dims["V"]
        m["tflops"] = flops / (m["ms"] * 1e-3) / 1e12
        passes = ", ".join(f"{k} {v:.4f}" for k, v in m.get("passes_ms", {}).items())
        log(f"K2 {tag} ok {dims} (clamp off and 0.01): max abs err {err:.3e}, "
            f"{m['ms']:.4f} ms = {m['tflops']:.1f} TFLOP/s (plain {m['plain_ms']:.4f} ms, "
            f"bound {m['bound_ms']:.4f} ms, gemm yardstick {m['gemm_ms']:.4f} ms); "
            f"device ms by kernel: {passes}")
        if not out:
            out = m
        else:
            out[f"{tag}_case"] = m
        del args, cot
    return out


def train_kernel_phase(device, shape=EVAL_SHAPE, banded=BANDED_SHAPE,
                       long_case=K3_LONG, reps=20) -> dict:
    """K2 (``k2_phase``) and K4 against their plain versions, timed."""
    from rnnt_tpu_torch.ops.lattice_pallas import alpha_plain, beta_backward, beta_plain

    out = {"K2": k2_phase(device, (("eval", shape), ("banded", banded), ("wide", K2_WIDE)),
                          reps)}
    lse_ms = lse_step_ms(device)
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
        diagonals = int(k4[2].max()) + dims["U1"] - 1  # the longest sample's
        m = dict(max_abs_err=err, ms=cuda_ms(lambda: beta_backward(*args), reps),
                 device_ms=device_ms(lambda: beta_backward(*args), reps),
                 plain_ms=cuda_ms(lambda: beta_plain(*args), 1, warmup=0),  # one call
                 bound_ms=bound_ms, bound_by=bound_by,
                 critical_path_ms=diagonals * lse_ms, lse_step_ns=lse_ms * 1e6,
                 shape="B={B} T={T} U1={U1}".format(**dims))
        log(f"K4 {tag} ok {dims}: max abs err {err:.3e}, {m['ms']:.4f} ms (device "
            f"{m['device_ms']:.4f} ms; plain {m['plain_ms']:.4f} ms, bytes bound "
            f"{bound_ms:.6f} ms, critical-path bound {m['critical_path_ms']:.4f} ms = "
            f"{diagonals} diagonals x {lse_ms * 1e6:.1f} ns)")
        if tag == "eval":
            out["K4"] = m
        else:
            out["K4"]["long_case"] = m
    return out


# ----------------------- K1 and K2 on a vocabulary slice -----------------------

def slice_case(device, dims, parts=2, reps=20) -> dict:
    """K1 and K2 on each vocabulary slice of ``dims`` as ``parts`` model
    ranks run them (V / parts wide at v0 = 0, V / parts, ...; k1_inputs
    puts the blank on the last slice and every last column's label 0 on
    the first) against their plain versions on the same slice (K1_TOL;
    K2_REL_L2, clamp off and at 0.01), timed beside the slice's bound; the
    slices' K1 outputs merged (lse by logsumexp, blank and label summed, as
    parallel/partition.py merges them) against whole-V K1 (K1_TOL) and
    against the plain version's whole-V outputs (K1_TOL), and K2 on each
    slice from the merged lse: concatenated dW and db, summed denc and
    dpred, against whole-V K2 and the whole-V plain version (K2_REL_L2).
    Calls here are not the main path's."""
    from rnnt_tpu_torch.ops.transducer_pallas import (
        fused_joint_backward, fused_joint_bwd_plain, fused_joint_forward,
        fused_joint_outputs_plain)

    args, cot = k2_case(dims, device)
    enc, pred, w, b, labels, blank = args
    Vs = dims["V"] // parts
    sdims = dict(dims, V=Vs)
    whole = fused_joint_forward(*args)
    whole_plain = fused_joint_outputs_plain(*args)
    slices, outs = [], []
    for i in range(parts):
        v0 = i * Vs
        sl = (enc, pred, w[:, v0:v0 + Vs].contiguous(), b[v0:v0 + Vs].contiguous(), labels,
              blank, v0)
        got = fused_joint_forward(*sl)
        err1 = max(check_close(f"K1 slice v0={v0} {n}", g, x, **K1_TOL)
                   for n, g, x in zip(("lse", "blank", "label"), got,
                                      fused_joint_outputs_plain(*sl)))
        outs.append((sl, got))
        call = lambda: fused_joint_forward(*sl)  # noqa: E731
        slices.append(dict(v0=v0, k1=dict(
            max_abs_err=err1, ms=cuda_ms(call, reps),
            plain_ms=cuda_ms(lambda: fused_joint_outputs_plain(*sl), 3, warmup=1),
            bound_ms=k1_bound_ms(**sdims), bound_by="operations")))
        if torch.device(device).type == "cuda":
            slices[-1]["k1"]["device_ms"] = device_ms(call, reps)
    lse = torch.logsumexp(torch.stack([o[1][0] for o in outs]), dim=0)
    merged = (lse, sum(o[1][1] for o in outs), sum(o[1][2] for o in outs))
    merged_err = max(check_close(f"K1 merged slices {n} against {ref}", g, x, **K1_TOL)
                     for ref, want in (("whole-V K1", whole), ("whole-V plain", whole_plain))
                     for n, g, x in zip(("lse", "blank", "label"), merged, want))
    del whole_plain
    gb, gl, gs = cot[1:]
    want = fused_joint_backward(*args, whole[0], gb, gl, gs)
    want_plain = fused_joint_bwd_plain(*args, whole[0], gb, gl, gs)
    grads = []
    for (sl, _), m in zip(outs, slices):
        v0 = sl[-1]
        err2 = 0.0
        for clamp in (-1.0, 0.01):
            got = fused_joint_backward(*sl[:-1], lse, gb, gl, gs, clamp, v0)
            ref = fused_joint_bwd_plain(*sl[:-1], lse, gb, gl, gs, clamp, v0)
            for n, x, y in zip(("denc", "dpred", "dW", "db"), got, ref):
                e = rel_l2(x, y)
                if not (e <= K2_REL_L2 and bool(torch.isfinite(x).all())):
                    raise AssertionError(f"K2 slice v0={v0} clamp={clamp} {n}: relative "
                                         f"L2 error {e:.3e} > {K2_REL_L2}")
                err2 = max(err2, float((x - y).abs().max()))
            if clamp < 0:
                grads.append(got)
            del ref
        call = lambda: fused_joint_backward(*sl[:-1], lse, gb, gl, gs, -1.0, v0)  # noqa: E731
        m["k2"] = dict(
            max_abs_err=err2, ms=cuda_ms(call, reps),
            plain_ms=cuda_ms(lambda: fused_joint_bwd_plain(*sl[:-1], lse, gb, gl, gs, -1.0,
                                                           v0), 3, warmup=1),
            bound_ms=k2_bound_ms(**sdims), bound_by="operations")
        if torch.device(device).type == "cuda":
            m["k2"]["device_ms"] = device_ms(call, reps)
    merged_grads = (sum(g[0] for g in grads), sum(g[1] for g in grads),
                    torch.cat([g[2] for g in grads], 1), torch.cat([g[3] for g in grads]))
    merged_k2 = {}
    for ref, whole_grads in (("whole-V K2", want), ("whole-V plain", want_plain)):
        for n, x, y in zip(("denc", "dpred", "dW", "db"), merged_grads, whole_grads):
            e = rel_l2(x, y)
            merged_k2[n] = max(merged_k2.get(n, 0.0), e)
            if not e <= K2_REL_L2:
                raise AssertionError(f"K2 merged slices {n}: relative L2 {e:.3e} against "
                                     f"{ref} > {K2_REL_L2}")
    for m in slices:
        k1, k2 = m["k1"], m["k2"]
        log(f"K1/K2 slice v0={m['v0']} of {dims} (V {Vs}) ok: K1 max abs err "
            f"{k1['max_abs_err']:.3e}, {k1['ms']:.4f} ms (device "
            f"{k1.get('device_ms', float('nan')):.4f}; plain {k1['plain_ms']:.4f}, bound "
            f"{k1['bound_ms']:.4f}); K2 max abs err {k2['max_abs_err']:.3e}, "
            f"{k2['ms']:.4f} ms (device {k2.get('device_ms', float('nan')):.4f}; plain "
            f"{k2['plain_ms']:.4f}, bound {k2['bound_ms']:.4f})")
    log(f"K1 slices merged = whole V (K1 and plain) within {merged_err:.3e}; K2 from the "
        "merged lse against whole-V K2 and plain: "
        + ", ".join(f"{n} rel L2 {e:.2e}" for n, e in merged_k2.items()))
    return dict(shape="B={B} T={T} U1={U1} H={H} V={V}".format(**dims), parts=parts,
                slices=slices, k1_merged_max_abs_err=merged_err, k2_merged_rel_l2=merged_k2)


def lattice_case(device, dims) -> dict:
    """K3 and K4 on a (B, T, U1) lattice against their plain versions
    (K3_TOL, K4_TOL); not timed."""
    from rnnt_tpu_torch.ops.lattice_pallas import (
        alpha_forward, alpha_plain, beta_backward, beta_plain)

    k3 = k3_inputs(**dims, device=device)
    nll, alpha = alpha_forward(*k3)
    nll_p, alpha_p = alpha_plain(*k3)
    err3 = check_k3(nll, alpha, nll_p, alpha_p, k3[2], k3[3])
    args = (k3[0], k3[1], alpha_p, k3[2], k3[3], nll_p, torch.ones_like(nll_p))
    err4 = max(check_close(f"K4 {n}", x, y, **K4_TOL)
               for n, x, y in zip(("glpb", "glpl"), beta_backward(*args), beta_plain(*args)))
    log(f"K3/K4 ok {dims}: max abs err {err3:.3e} / {err4:.3e}")
    return dict(shape="B={B} T={T} U1={U1}".format(**dims), k3_max_abs_err=err3,
                k4_max_abs_err=err4)


def slice_phase(device, cases) -> dict:
    """``slice_case`` for each (tag, dims) of ``cases``; ``lattice_case`` on
    the lattice of the one tagged ``tp`` (the tensor-parallel step's)."""
    out = {tag: slice_case(device, dims) for tag, dims in cases}
    if "tp" in out:
        dims = dict(cases)["tp"]
        out["tp"]["lattice"] = lattice_case(device, {k: dims[k] for k in ("B", "T", "U1")})
    return out


# ------------------------- K6 and K7: the T-sharded chain -------------------------

# (tag, lattice, shards): the eval lattice cut into 2 shards, the long one into 4.
CHAIN_CASES = (("eval", dict(B=4, T=504, U1=65), 2), ("long", K3_LONG, 4))


def chain_lens(T: int, n: int, t_lens):
    """t_lens that end inside a later shard, at the edge of a shard (its
    last row), before the last shard, and at T."""
    rows = -(-T // n)
    ends = [rows + rows // 2, rows * (n // 2), rows // 2, T]
    return torch.tensor(ends[: len(t_lens)], dtype=torch.int32, device=t_lens.device)


def chain_bound(B, T, U1, t_lens, t0: int, kernel: str) -> tuple[float, str]:
    """(ms, what bounds it) of one shard of T rows at global row t0: K6
    reads lp_blank and lp_label and writes alpha, all rows, against one
    log-sum-exp per cell; K7 reads lp_blank, lp_label and alpha for this
    shard's rows below each sample's t_len and writes both gradients in
    full, against one log-sum-exp and two exps per live cell.  The (B, U)
    carry rows and (B,) vectors are counted too."""
    live = float((t_lens.long() - t0).clamp(0, T).sum()) * U1
    if kernel == "K6":
        nbytes, ops = 3 * 4 * B * T * U1 + 2 * 4 * B * U1 + 3 * 4 * B, 7.0 * B * T * U1
    else:
        nbytes = 3 * 4 * live + 2 * 4 * B * T * U1 + 2 * 4 * B * U1 + 4 * 4 * B
        ops = 12.0 * live
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_live(name, got, want, tol) -> float:
    """check_close on the cells whose plain value is not log-zero; the
    log-zero cells must stay log-zero."""
    from rnnt_tpu_torch.ops.transducer import NEG

    live = want > NEG / 2
    if not bool((got[~live] <= NEG / 2).all()):
        raise AssertionError(f"{name}: a log-zero cell of the plain version is live")
    return check_close(name, got[live], want[live], **tol)


def chain_inputs(dims, n: int, device):
    """(lp_blank, lp_label, t_lens, u_lens, shards) of a chain case: the
    lattice of ``k3_inputs`` (seed 3) with ``chain_lens``' t_lens, and its
    n shards [(t0, lp_blank rows, lp_label rows)]."""
    lpb, lpl, t_lens, u_lens = k3_inputs(**dims, device=device, seed=3)
    t_lens = chain_lens(dims["T"], n, t_lens)
    rows = -(-dims["T"] // n)
    return lpb, lpl, t_lens, u_lens, [
        (s * rows, lpb[:, s * rows:(s + 1) * rows].contiguous(),
         lpl[:, s * rows:(s + 1) * rows].contiguous()) for s in range(n)]


def chain_path_ms(rows: int, U1: int, t_lens, t0: int, kernel: str, lse_ms: float) -> float:
    """The critical-path bound of one shard: its dependent LSEs, one a
    diagonal (rows + U1 - 1 for K6; for K7 the live rows of the sample
    with the most, clamp(t_len - t0, 0, rows), + U1 - 1, and none when no
    row is live) x one LSE step (``lse_step_ms``)."""
    if kernel == "K7":
        rows = int((t_lens.long() - t0).clamp(0, rows).max())
        if rows == 0:
            return 0.0
    return (rows + U1 - 1) * lse_ms


def c_call(fn, *args) -> None:
    """Call a kernel's C entry point on the current stream (tensors become
    their data pointers); raise on a CUDA error.  Not counted."""
    from rnnt_tpu_torch.ops.kernels import ptr

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if fn(*[ptr(a) if isinstance(a, torch.Tensor) else a for a in args], stream) != 0:
        raise RuntimeError("CUDA error at launch")


def chain_kernel_phase(device, cases=CHAIN_CASES, reps=20) -> dict:
    """K6 and K7 on every shard of the eval lattice (2 shards) and the long
    lattice (4 shards), each shard at its nonzero t0 with the previous
    shard's carry and t_lens that end inside, at the edge of and before a
    shard: against their plain versions (K3_TOL, K4_TOL), then the chain of
    shards against K3 + K4 on the whole lattice.  Times per shard: burst
    (``burst_ms`` of the C entry point), device (torch.profiler) and events
    around one wrapper call, beside the bytes bound, the critical-path
    bound and the plain version's time."""
    from rnnt_tpu_torch.ops.lattice_pallas import (
        K6, K7, alpha_chain_forward, alpha_chain_plain, alpha_forward, beta_backward,
        beta_chain_backward, beta_chain_plain)
    from rnnt_tpu_torch.ops.transducer import NEG

    on_card = torch.device(device).type == "cuda"
    lse_ms = lse_step_ms(device)
    out = {}
    for tag, dims, n in cases:
        lpb, lpl, t_lens, u_lens, shards = chain_inputs(dims, n, device)
        B, T, U1 = lpb.shape
        rows = shards[0][1].shape[1]
        err6 = err7 = 0.0
        per_shard = []
        carry = torch.full((B, U1), NEG, device=device)
        alphas, lls, carries_in = [], [], []
        for t0, b, l in shards:
            carries_in.append(carry)
            got = alpha_chain_forward(b, l, t_lens, u_lens, t0, carry)
            want = alpha_chain_plain(b, l, t_lens, u_lens, t0, carry)
            err6 = max(err6, check_live(f"K6 {tag} t0={t0} alpha", got[0], want[0], K3_TOL),
                       check_close(f"K6 {tag} t0={t0} ll", got[1], want[1], **K3_TOL),
                       check_live(f"K6 {tag} t0={t0} carry", got[2], want[2], K3_TOL))
            alphas.append(got[0])
            lls.append(got[1])
            carry = got[2]
        ll = sum(lls)
        g = torch.ones_like(ll)
        grads = [None] * n
        carry = torch.full((B, U1), NEG, device=device)
        for s in reversed(range(n)):
            t0, b, l = shards[s]
            args = (b, l, alphas[s], t_lens, u_lens, ll, g, t0, carry)
            got = beta_chain_backward(*args)
            want = beta_chain_plain(*args)
            err7 = max(err7, check_close(f"K7 {tag} t0={t0} glpb", got[0], want[0], **K4_TOL),
                       check_close(f"K7 {tag} t0={t0} glpl", got[1], want[1], **K4_TOL),
                       check_live(f"K7 {tag} t0={t0} carry", got[2], want[2], K4_TOL))
            grads[s] = got[:2]
            R = b.shape[1]

            def call6():
                return alpha_chain_forward(b, l, t_lens, u_lens, t0, carries_in[s])

            def call7():
                return beta_chain_backward(*args)

            m = dict(t0=t0, rows=R, k6_ms=cuda_ms(call6, reps), k7_ms=cuda_ms(call7, reps),
                     # the plain stages are Python loops of small launches (host
                     # time, 0.4-0.9 s a shard): one call each
                     k6_plain_ms=cuda_ms(lambda: alpha_chain_plain(b, l, t_lens, u_lens, t0,
                                                                   carries_in[s]), 1, warmup=0),
                     k7_plain_ms=cuda_ms(lambda: beta_chain_plain(*args), 1, warmup=0))
            if on_card:
                o6 = [torch.empty_like(b), torch.empty_like(ll), torch.empty_like(carry)]
                o7 = [torch.empty_like(b), torch.empty_like(b), torch.empty_like(carry)]
                m["k6_burst_ms"] = burst_ms(lambda: c_call(
                    K6.fn(), b, l, t_lens, u_lens, carries_in[s], *o6, B, R, U1, t0))
                m["k7_burst_ms"] = burst_ms(lambda: c_call(
                    K7.fn(), b, l, alphas[s], t_lens, u_lens, ll, g, carry, *o7, B, R, U1, t0))
                m["k6_device_ms"] = device_ms(call6, reps)
                m["k7_device_ms"] = device_ms(call7, reps)
            for k in ("k6", "k7"):
                bound = chain_bound(B, R, U1, t_lens, t0, k.upper())
                m[f"{k}_bound_ms"], m[f"{k}_bound_by"] = bound
                m[f"{k}_path_ms"] = chain_path_ms(R, U1, t_lens, t0, k.upper(), lse_ms)
            per_shard.insert(0, m)
            carry = got[2]
        # The chain against K3 + K4 on the whole lattice.
        nll, alpha_full = alpha_forward(lpb, lpl, t_lens, u_lens)
        check_k3(-ll, torch.cat(alphas, 1), nll, alpha_full, t_lens, u_lens)
        glpb, glpl = beta_backward(lpb, lpl, alpha_full, t_lens, u_lens, nll, g)
        for nm, x, y in (("glpb", torch.cat([gb for gb, _ in grads], 1), glpb),
                         ("glpl", torch.cat([gl for _, gl in grads], 1), glpl)):
            check_close(f"chain {tag}: K7 {nm} vs K4's", x, y, **K4_TOL)
        chain = dict(k6_ms=sum(m["k6_ms"] for m in per_shard),
                     k7_ms=sum(m["k7_ms"] for m in per_shard),
                     k3_ms=cuda_ms(lambda: alpha_forward(lpb, lpl, t_lens, u_lens), reps),
                     k4_ms=cuda_ms(lambda: beta_backward(lpb, lpl, alpha_full, t_lens,
                                                          u_lens, nll, g), reps))
        if on_card:
            for k in ("k6", "k7"):
                for what in ("burst", "device"):
                    chain[f"{k}_{what}_ms"] = sum(m[f"{k}_{what}_ms"] for m in per_shard)
        nan = float("nan")
        log(f"K6/K7 {tag} ok {dims} in {n} shards of {rows} rows, t_lens "
            f"{t_lens.tolist()}: max abs err K6 {err6:.3e}, K7 {err7:.3e}; the chain "
            "matches K3 + K4 on the whole lattice; per shard (t0: K6 / K7 ms burst, "
            "device, events; bounds bytes and critical path; plain) "
            + "; ".join(f"{m['t0']}: {m.get('k6_burst_ms', nan):.4f} / "
                        f"{m.get('k7_burst_ms', nan):.4f} burst, "
                        f"{m.get('k6_device_ms', nan):.4f} / {m.get('k7_device_ms', nan):.4f} "
                        f"device, {m['k6_ms']:.4f} / {m['k7_ms']:.4f} events (bound "
                        f"{m['k6_bound_ms']:.6f} / {m['k7_bound_ms']:.6f} bytes, "
                        f"{m['k6_path_ms']:.4f} / {m['k7_path_ms']:.4f} path; plain "
                        f"{m['k6_plain_ms']:.2f} / {m['k7_plain_ms']:.2f})"
                        for m in per_shard)
            + f"; library ms: none; chain K6 {chain.get('k6_burst_ms', nan):.4f} + K7 "
            f"{chain.get('k7_burst_ms', nan):.4f} ms burst ({chain['k6_ms']:.4f} + "
            f"{chain['k7_ms']:.4f} events) against K3 {chain['k3_ms']:.4f} + K4 "
            f"{chain['k4_ms']:.4f} ms events on the whole lattice")
        out[tag] = dict(err6=err6, err7=err7, shards=per_shard, chain=chain, n=n,
                        lse_step_ns=lse_ms * 1e6,
                        shape=f"B={B} T={rows} U1={U1} (T={T} in {n} shards)")
    return out


def burst_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of (CUDA events around n back-to-back calls) / n:
    the host's launch cost hides behind the queue, so this is device time."""
    return cuda_ms(lambda: [fn() for _ in range(n)], reps) / n


def build_other_tree(parent: Path, kernels) -> dict:
    """{kernel name: (C entry of ``parent/<name>.cu``, this tree's)}: each
    kernel's source from another tree, built with this tree's flags (one
    nvcc each, all started together) against that tree's headers beside
    it, with this tree's C signature."""
    from rnnt_tpu_torch.ops.kernels import BUILD_DIR, NVCC_FLAGS, nvcc_path

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        out = BUILD_DIR / f"other_{parent.name}_{k.name}.so"
        procs.append((k, out, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(parent / f"{k.name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for k, out, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {parent / k.name}.cu:\n{text}")
        fn = getattr(ctypes.CDLL(str(out)), k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        libs[k.name] = (fn, k.fn())
    return libs


def turns(runs: dict) -> dict:
    """{f"{who}_{what}": [burst ms, burst ms]} of runs {who: {what: fn}}
    for who in ("other", "this"), timed in turns: other, this, this,
    other."""
    times = {f"{who}_{what}": [] for who, fns in runs.items() for what in fns}
    for who in ("other", "this", "this", "other"):
        for what, fn in runs[who].items():
            times[f"{who}_{what}"].append(burst_ms(fn))
    return times


def parent_lattice_phase(device, parent: Path) -> dict:
    """K3, K4, K6 and K7 of another tree (``parent/alpha_fwd.cu``,
    ``beta_bwd.cu``, ``alpha_chain.cu`` and ``beta_chain.cu`` with that
    tree's headers beside them) built with the same flags, checked against
    this tree's plain versions (K3_TOL, K4_TOL) and timed in turns with
    this tree's (other, this, this, other): K3 and K4 at the eval and long
    shapes, K6 and K7 on every shard of CHAIN_CASES with the plain chain's
    carries, the same C entry points on the same buffers, ``burst_ms``.
    Calls here are not counted."""
    from rnnt_tpu_torch.ops.lattice_pallas import (
        K3, K4, K6, K7, alpha_chain_plain, alpha_plain, beta_chain_plain, beta_plain)
    from rnnt_tpu_torch.ops.transducer import NEG

    libs = build_other_tree(parent, (K3, K4, K6, K7))
    out = {}
    for tag, dims in (("eval", dict(B=4, T=504, U1=65)), ("long", K3_LONG)):
        lpb, lpl, t_lens, u_lens = k3_inputs(**dims, device=device)
        B, T, U = lpb.shape
        nll_p, alpha_p = alpha_plain(lpb, lpl, t_lens, u_lens)
        g = torch.ones_like(nll_p)
        want = beta_plain(lpb, lpl, alpha_p, t_lens, u_lens, nll_p, g)
        nll, alpha = torch.empty_like(nll_p), torch.empty_like(lpb)
        glpb, glpl = torch.empty_like(lpb), torch.empty_like(lpb)
        runs, errs = {}, {}
        for who, i in (("other", 0), ("this", 1)):
            k3, k4 = libs["alpha_fwd"][i], libs["beta_bwd"][i]
            run3 = lambda k3=k3: c_call(k3, lpb, lpl, t_lens, u_lens, alpha, nll, B, T, U)
            run4 = lambda k4=k4: c_call(k4, lpb, lpl, alpha_p, t_lens, u_lens, nll_p, g,
                                        glpb, glpl, B, T, U)
            run3()
            run4()
            sync(device)
            errs[who] = (check_k3(nll, alpha, nll_p, alpha_p, t_lens, u_lens),
                         max(check_close(f"{who} K4 {tag} {n}", x, y, **K4_TOL)
                             for n, x, y in zip(("glpb", "glpl"), (glpb, glpl), want)))
            runs[who] = dict(k3=run3, k4=run4)
        times = turns(runs)
        out[tag] = dict(times, errs=errs)
        log(f"K3/K4 {tag} {dims} against {parent}: both right (max abs err K3 / K4: "
            f"other {errs['other'][0]:.3e} / {errs['other'][1]:.3e}, this "
            f"{errs['this'][0]:.3e} / {errs['this'][1]:.3e}); ms (other, this, "
            f"this, other): K3 {times['other_k3'][0]:.4f}, {times['this_k3'][0]:.4f}, "
            f"{times['this_k3'][1]:.4f}, {times['other_k3'][1]:.4f}; K4 "
            f"{times['other_k4'][0]:.4f}, {times['this_k4'][0]:.4f}, "
            f"{times['this_k4'][1]:.4f}, {times['other_k4'][1]:.4f}; this tree "
            f"{min(times['other_k3']) / max(times['this_k3']):.2f}x (K3) and "
            f"{min(times['other_k4']) / max(times['this_k4']):.2f}x (K4) faster")

    out["chain"] = {}
    for tag, dims, n in CHAIN_CASES:
        lpb, lpl, t_lens, u_lens, shards = chain_inputs(dims, n, device)
        B, _, U1 = lpb.shape
        # The plain chain: each shard's carry in and outputs, both ways.
        fwd, bwd = [], [None] * n
        carry = torch.full((B, U1), NEG, device=device)
        for t0, b, l in shards:
            fwd.append((carry, alpha_chain_plain(b, l, t_lens, u_lens, t0, carry)))
            carry = fwd[-1][1][2]
        ll = sum(w[1] for _, w in fwd)
        g = torch.ones_like(ll)
        carry = torch.full((B, U1), NEG, device=device)
        for s in reversed(range(n)):
            t0, b, l = shards[s]
            bwd[s] = (carry, beta_chain_plain(b, l, fwd[s][1][0], t_lens, u_lens, ll, g, t0,
                                              carry))
            carry = bwd[s][1][2]
        per_shard = []
        for s, (t0, b, l) in enumerate(shards):
            rows = b.shape[1]
            (c6, want6), (c7, want7) = fwd[s], bwd[s]
            o6 = [torch.empty_like(b), torch.empty_like(ll), torch.empty_like(c6)]
            o7 = [torch.empty_like(b), torch.empty_like(b), torch.empty_like(c7)]
            runs, errs = {}, {}
            for who, i in (("other", 0), ("this", 1)):
                k6, k7 = libs["alpha_chain"][i], libs["beta_chain"][i]
                run6 = lambda k6=k6: c_call(k6, b, l, t_lens, u_lens, c6, *o6, B, rows, U1, t0)
                run7 = lambda k7=k7: c_call(k7, b, l, want6[0], t_lens, u_lens, ll, g, c7, *o7,
                                            B, rows, U1, t0)
                run6()
                run7()
                sync(device)
                name = f"{who} {tag} t0={t0}"
                errs[who] = (
                    max(check_live(f"{name} K6 alpha", o6[0], want6[0], K3_TOL),
                        check_close(f"{name} K6 ll", o6[1], want6[1], **K3_TOL),
                        check_live(f"{name} K6 carry", o6[2], want6[2], K3_TOL)),
                    max(check_close(f"{name} K7 glpb", o7[0], want7[0], **K4_TOL),
                        check_close(f"{name} K7 glpl", o7[1], want7[1], **K4_TOL),
                        check_live(f"{name} K7 carry", o7[2], want7[2], K4_TOL)))
                runs[who] = dict(k6=run6, k7=run7)
            per_shard.append(dict(t0=t0, rows=rows, errs=errs, **turns(runs)))
        out["chain"][tag] = per_shard
        log(f"K6/K7 {tag} {dims} in {n} shards against {parent}: both right on every "
            "shard; burst ms (other, this, this, other) per shard "
            + "; ".join(
                f"t0={m['t0']}: K6 " + ", ".join(f"{x:.4f}" for x in (
                    m["other_k6"][0], m["this_k6"][0], m["this_k6"][1], m["other_k6"][1]))
                + " K7 " + ", ".join(f"{x:.4f}" for x in (
                    m["other_k7"][0], m["this_k7"][0], m["this_k7"][1], m["other_k7"][1]))
                + f" (this tree {min(m['other_k6']) / max(m['this_k6']):.1f}x / "
                f"{min(m['other_k7']) / max(m['this_k7']):.1f}x faster)"
                for m in per_shard))
    return out


def joint_fwd_arity(source: Path) -> int:
    """The number of parameters of ``rnnt_joint_fwd`` in a joint_fwd.cu:
    15 for the earlier single-kernel design (enc, pred, w, bias, labels,
    lse, blank, label, B, T, U1, H, V, blank, stream), 17 for the h pass +
    wgmma design (h workspace, Hp and Vp added), 18 since the vocabulary
    offset v0 (added after blank)."""
    text = source.read_text()
    m = re.search(r'extern "C" int rnnt_joint_fwd\(([^)]*)\)', text)
    if m is None:
        raise RuntimeError(f"{source}: no rnnt_joint_fwd entry point")
    return len(m.group(1).split(","))


def build_joint_fwd_trees(dirs: list[Path]) -> list[tuple[str, int, object]]:
    """[(name, arity, C entry point)]: this tree's K1 first, then K1 of each
    other tree (``DIR/joint_fwd.cu`` with that tree's headers beside it),
    built with the same flags, one nvcc each, all started together."""
    from rnnt_tpu_torch.ops.kernels import BUILD_DIR, NVCC_FLAGS, nvcc_path
    from rnnt_tpu_torch.ops.transducer_pallas import K1

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, d in enumerate(dirs):
        out = BUILD_DIR / f"other_{i}_{d.name}_joint_fwd.so"
        procs.append((d, out, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(d / "joint_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = [("this", 18, K1.fn())]
    for d, out, proc in procs:
        build_log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {d}/joint_fwd.cu:\n{build_log}")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  {d}/joint_fwd.cu: {line.strip()}")
        arity = joint_fwd_arity(d / "joint_fwd.cu")
        if arity not in (15, 17, 18):
            raise RuntimeError(f"{d}/joint_fwd.cu: rnnt_joint_fwd takes {arity} arguments")
        fn = getattr(ctypes.CDLL(str(out)), "rnnt_joint_fwd")
        fn.argtypes = {18: K1.argtypes,
                       17: [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                       15: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}[arity]
        fn.restype = ctypes.c_int
        fns.append((str(d), arity, fn))
    return fns


def joint_fwd_call(fn, arity: int, inputs: list, h_ws, outs):
    """A callable launching one tree's K1 entry point (``arity`` as
    ``joint_fwd_arity``) on ``inputs`` (``k1_inputs``, H and V multiples of
    8, so both designs take the same buffers), the workspace and the three
    outputs, on the current stream; raises on a CUDA error."""
    from rnnt_tpu_torch.ops.kernels import ptr

    enc, pred, w, b, labels, blank = inputs
    (B, T, H), U1, V = enc.shape, pred.shape[1], w.shape[1]
    assert H % 8 == 0 and V % 8 == 0
    if arity == 15:
        args = (enc, pred, w, b, labels, *outs, B, T, U1, H, V, blank)
    else:
        args = (enc, pred, w, b, labels, h_ws, *outs, B, T, U1, H, V, V, blank)
        args += (0,) if arity == 18 else ()
    c_args = [ptr(a) if isinstance(a, torch.Tensor) else a for a in args]

    def run():
        if fn(*c_args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) != 0:
            raise RuntimeError("CUDA error at launch")
    return run


def parent_joint_phase(device, parents: list[Path]) -> dict:
    """K1 of other trees (``build_joint_fwd_trees``), called through each
    tree's own C signature, checked against this tree's plain version
    (K1_TOL) and timed in turns with this tree's K1 (other, this, this,
    other) at the eval and banded shapes: ``burst_ms`` of the C entry points
    on the same buffers.  Calls here are not counted."""
    from rnnt_tpu_torch.ops.transducer_pallas import fused_joint_outputs_plain

    fns = build_joint_fwd_trees(parents)
    out = {}
    for tag, dims in (("eval", EVAL_SHAPE), ("banded", BANDED_SHAPE)):
        inputs = k1_inputs(**dims, device=device)
        want = fused_joint_outputs_plain(*inputs)
        outs = [torch.empty_like(want[0]) for _ in range(3)]
        h_ws = torch.empty((want[0].numel(), dims["H"]), dtype=torch.bfloat16, device=device)
        runs, res, copies = {}, {}, {}
        for who, arity, fn in fns:
            runs[who] = joint_fwd_call(fn, arity, inputs, h_ws, outs)
            runs[who]()
            sync(device)
            copies[who] = [o.clone() for o in outs]
            res[who] = dict(max_abs_err=max(
                check_close(f"{who} K1 {tag} {n}", g, x, **K1_TOL)
                for n, g, x in zip(("lse", "blank", "label"), outs, want)))
            res[who]["bit_equal_to_this"] = all(
                torch.equal(a, c) for a, c in zip(copies[who], copies["this"]))
        for who, _, _ in fns[1:]:
            times = {"other": [], "this": []}
            for turn in ("other", "this", "this", "other"):
                times[turn].append(burst_ms(runs[who if turn == "other" else "this"]))
            res[who].update(ms=times["other"], this_ms=times["this"])
            log(f"K1 {tag} {dims} against {who}: both right (max abs err other "
                f"{res[who]['max_abs_err']:.3e}, this {res['this']['max_abs_err']:.3e}; "
                f"bit-equal outputs: {res[who]['bit_equal_to_this']}); ms "
                f"(other, this, this, other): {times['other'][0]:.4f}, "
                f"{times['this'][0]:.4f}, {times['this'][1]:.4f}, {times['other'][1]:.4f}; "
                f"this tree {min(times['other']) / max(times['this']):.2f}x faster")
        out[tag] = res
        del inputs, outs, h_ws, want
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


# ------------------------------- serving -------------------------------

# Streamed encoder frames against the offline encoder over the same frames,
# fp32 with TF32 off: the largest absolute difference relative to the
# offline output's largest magnitude.  The streamed convs see other lengths
# than the offline ones, so cuDNN may pick other algorithms and sum in
# another order; batch norm with frozen statistics is otherwise exact.
SERVE_STREAM_REL = 1e-4


def serve_cfg(workdir: Path, config: str, overrides=()):
    from rnnt_tpu_torch.config.config import (
        apply_overrides, build_featurizer_spec, build_model_spec, load_config,
        resolve_config)
    from rnnt_tpu_torch.data.dataset import synthetic_piece_table

    vocab = workdir / "serve_vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    cfg = apply_overrides(load_config(resolve_config(config)),
                          ["tokenizer.spm_model=''", *overrides, f"tokenizer.vocab_json={vocab}"])
    return cfg, build_model_spec(cfg), build_featurizer_spec(cfg)


def smallest_margin(model, enc: torch.Tensor, hyp: list, cap: int = 256) -> float:
    """The smallest top-2 logit gap over every frame of ``enc`` (1, n, H)
    against the predictor feature of every prefix of the hypothesis (the
    first ``cap``): a lower bound on the margins the greedy decode saw."""
    from rnnt_tpu_torch.decode.greedy import make_predictor_stepper
    from rnnt_tpu_torch.models.joint import joint_window

    spec = model.spec
    feat, state, step = make_predictor_stepper(model.predictor, spec.predictor,
                                               spec.blank_idx, 1, enc.device)
    best = math.inf
    for k in range(min(len(hyp), cap) + 1):
        top2 = joint_window(model.joint, enc, feat).topk(2, dim=-1).values
        best = min(best, float((top2[..., 0] - top2[..., 1]).min()))
        if k < len(hyp):
            feat, state = step(state, torch.tensor([hyp[k]], device=enc.device))
    return best


# Streamed against offline: (blank bias, seconds of audio, the session's
# max_tokens_per_chunk).  At 0.25 the untrained model emits about one token
# a frame (521 in 10 s on an H100, up to 64 in a chunk; 2 at 0.5, none from
# 1.0 up: scripts/blank_bias_sweep.py, PERF.md §6); at 0 it emits at the
# per-frame cap of 10.  A chunk budget of 128 (above the 100 that a chunk's
# 10 encoder frames can take) keeps the budget from cutting a chunk short,
# so streamed must equal offline token for token.  A case that decodes no
# token fails.
STREAM_CASES = ((0.25, 10.0, 128), (0.0, 4.0, 128))


def stream_offline_check(workdir: Path, device, config="base_convjs_fullcausal",
                         overrides=(), cases=STREAM_CASES, chunk_s=0.2) -> dict:
    """StreamingSessions fed audio in ``chunk_s`` pieces against offline
    featurize + encoder + greedy decode over the same encoder frames, on a
    batch-norm model (random weights from seed 0, batch-norm statistics
    drawn in [0.5, 1.5]) at each case's blank bias; and the streamed
    encoder frames (FeatureStreamer + Encoder.streaming, the session's
    chunking) against the offline encoder."""
    from rnnt_tpu_torch.decode.greedy import greedy_decode
    from rnnt_tpu_torch.decode.streaming import StreamingSession
    from rnnt_tpu_torch.models.encoder import encoder_streaming_init_state
    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.ops.stft import FeatureStreamer, make_featurizer

    import numpy as np

    _, spec, fspec = serve_cfg(workdir, config, overrides)
    if spec.encoder.norm_type != "batch":
        raise ValueError(f"{config}: streamed equals offline only with batch norm")
    model = rnnt_init(spec, seed=0, device=device)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for buf in model.buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    rng = np.random.RandomState(0)
    n = int(max(c[1] for c in cases) * fspec.sample_rate)
    wave = (rng.randn(n).astype(np.float32) * 0.2
            + np.sin(2 * np.pi * 500 * np.arange(n) / fspec.sample_rate).astype(np.float32) * 0.3)
    step = int(chunk_s * fspec.sample_rate)

    streamer = FeatureStreamer(fspec, device)
    states = encoder_streaming_init_state(1, spec.encoder, device=device)
    frames = []
    with torch.inference_mode():
        for i in range(0, n, step):
            feats = streamer.process(wave[i:i + step])
            if feats is not None:
                y, states = model.encoder.streaming(feats[None], states)
                frames.append(y)
        streamed = torch.cat(frames, dim=1)
        enc = model.encoder(make_featurizer(fspec)(torch.from_numpy(wave).to(device))[None])
        if not 0 < streamed.shape[1] <= enc.shape[1]:
            raise AssertionError(f"{streamed.shape[1]} streamed, {enc.shape[1]} offline "
                                 "encoder frames")
        err = float((streamed - enc[:, :streamed.shape[1]]).abs().max())
        scale = float(enc[:, :streamed.shape[1]].abs().max())
    out = dict(config=config, chunk_s=chunk_s, encoder_frames=streamed.shape[1],
               enc_max_abs_err=err, enc_scale=scale, cases=[])
    log(f"serve/stream: {config}, {n / fspec.sample_rate:g} s in {chunk_s:g} s chunks: "
        f"{streamed.shape[1]} encoder frames streamed vs offline, max abs err {err:.3e} "
        f"(scale {scale:.3f})")
    if not err <= SERVE_STREAM_REL * max(scale, 1.0):
        raise AssertionError(f"streamed encoder frames {err:.3e} from offline "
                             f"(limit {SERVE_STREAM_REL} x {max(scale, 1.0):.3f})")

    for bias, seconds, budget in cases:
        with torch.no_grad():
            model.joint.out.b[spec.blank_idx] = bias
        session = StreamingSession(model, fspec, max_tokens_per_chunk=budget)
        m = int(seconds * fspec.sample_rate)
        per_chunk = []
        t0 = time.perf_counter()
        for i in range(0, m, step):
            per_chunk.append(len(session.feed(wave[i:i + step])[0]))
        stream_s = time.perf_counter() - t0
        n_enc = session.encoder_frames_emitted
        with torch.inference_mode():
            tokens, counts = greedy_decode(
                model.predictor, model.joint, enc[:, :n_enc],
                torch.tensor([n_enc], device=device), spec.predictor, spec.joint,
                max_tokens=budget * len(per_chunk))
            offline = tokens[0, : int(counts[0])].tolist()
            margin = smallest_margin(model, enc[:, :n_enc], offline)
        got = session.tokens()
        case = dict(blank_bias=bias, seconds=seconds, max_tokens_per_chunk=budget,
                    encoder_frames=n_enc, tokens=len(got), max_tokens_in_a_chunk=max(per_chunk),
                    min_top2_margin=margin, session_audio_s_per_s=seconds / stream_s)
        out["cases"].append(case)
        log(f"serve/stream: blank bias {bias:g}, {seconds:g} s: {n_enc} encoder frames, "
            f"{len(got)} tokens streamed ({max(per_chunk)} at most in a chunk of budget "
            f"{budget}), {len(offline)} offline; smallest top-2 logit margin {margin:.4e}; "
            f"session {seconds / stream_s:.2f} audio-s/s")
        if got != offline:
            raise AssertionError(f"streamed tokens {got[:40]} != offline {offline[:40]} "
                                 f"(smallest margin {margin:.3e})")
        if not got:
            raise AssertionError(f"{config} at blank bias {bias:g}: 0 tokens streamed and "
                                 "offline, so their equality would show nothing")
    return out


def count_syncs(fn, device):
    """Host-device synchronisations made by ``fn()`` (CUDA's sync debug
    mode, one warning each); None off the card."""
    import warnings

    if torch.device(device).type != "cuda":
        fn()
        return None
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def pool_load_check(device, kernels, model, fspec, config="base_convjs", slots=16,
                    seconds=10.0, chunk_s=0.2, check_streams=3,
                    profile: Path | None = None) -> dict:
    """The load of the JAX package's serving benchmark (bench.py
    ``bench_serve``): ``slots`` streams of ``seconds`` of randn x 0.05 audio
    (RandomState(0)) on one StreamingSessionPool of ``model``, ``chunk_s``
    chunks, 2 warm-up chunks outside the timing.  Streams 0 to
    ``check_streams`` - 1 against dedicated StreamingSessions fed the
    pool's chunks."""
    from rnnt_tpu_torch.decode.streaming import StreamingSession, StreamingSessionPool

    import numpy as np

    pool = StreamingSessionPool(model, fspec, slots=slots, chunk_seconds=chunk_s)
    rng = np.random.RandomState(0)
    audio = rng.randn(slots, int(seconds * fspec.sample_rate)).astype(np.float32) * 0.05
    handles = [pool.open() for _ in range(slots)]
    step = int(chunk_s * fspec.sample_rate)
    n_chunks = audio.shape[1] // step

    for c in range(2):
        for i, h in enumerate(handles):
            pool.feed(h, audio[i, c * step: (c + 1) * step])
    if not pool.pump():
        raise AssertionError("the warm-up pump did no work")
    pool._pump_ms.clear()
    pool._pump_lanes.clear()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for c in range(2, n_chunks):
        for i, h in enumerate(handles):
            pool.feed(h, audio[i, c * step: (c + 1) * step])
        pool.pump()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    stats = pool.stats()
    audio_seconds = slots * chunk_s * (n_chunks - 2)
    steps = n_chunks - 1  # chunks the pool stepped: the last needs the next one's overlap

    # Dedicated sessions fed exactly the pool's chunks (chunk + overlap,
    # then one chunk at a time): instance norms see the same frames.
    need = pool.chunk_samples + fspec.overlap
    matches = []
    for i in range(check_streams):
        session = StreamingSession(model, fspec)
        session.feed(audio[i, :need])
        for j in range(1, steps):
            session.feed(audio[i, need + (j - 1) * pool.chunk_samples:
                                need + j * pool.chunk_samples])
        got = pool.tokens(handles[i])
        if session.tokens() != got:
            raise AssertionError(f"pool stream {i}: {got[:40]} != its session's "
                                 f"{session.tokens()[:40]}")
        matches.append(len(got))

    # Host syncs of one pump over every lane (fresh audio, after the checks).
    more = np.random.RandomState(1).randn(slots, 8 * step).astype(np.float32) * 0.05
    for i, h in enumerate(handles):
        pool.feed(h, more[i, :step])
    syncs = count_syncs(pool.pump, device)
    out = dict(config=config, slots=slots, seconds=seconds, chunk_s=chunk_s,
               audio_s_per_s=audio_seconds / dt, wall_s=dt, pumps=stats["device_steps"],
               step_ms_p50=stats["step_ms_p50"], step_ms_p99=stats["step_ms_p99"],
               mean_batched_lanes=stats["mean_batched_lanes"],
               max_batched_lanes=stats["max_batched_lanes"],
               tokens_emitted=stats["tokens_emitted"], syncs_per_pump=syncs,
               kernel_launches=launches, checked_streams_tokens=matches)
    log(f"serve/pool: {config}, {slots} streams x {seconds:g} s, {chunk_s:g} s chunks: "
        f"{out['audio_s_per_s']:.2f} audio-s/s ({audio_seconds:.1f} s of audio in "
        f"{dt:.3f} s), {stats['device_steps']} pumps, step p50 {stats['step_ms_p50']} ms, "
        f"p99 {stats['step_ms_p99']} ms, mean batched lanes {stats['mean_batched_lanes']}, "
        f"{stats['tokens_emitted']} tokens, {syncs} host syncs a pump; K1-K7 launches "
        f"{launches}; streams 0-{check_streams - 1} equal their sessions "
        f"({matches} tokens)")
    if any(launches.values()):
        raise AssertionError(f"a transducer kernel ran on the serving path: {launches}")
    if profile is not None:
        from torch.profiler import profile as torch_profile

        pumps = 5
        with torch_profile(activities=_activities(device)) as prof:
            t0 = time.perf_counter()
            for c in range(1, 1 + pumps):
                for i, h in enumerate(handles):
                    pool.feed(h, more[i, c * step: (c + 1) * step])
                pool.pump()
            wall = time.perf_counter() - t0
        out["profile_idle_pct"] = report_trace(
            prof, wall, f"{pumps} pool pumps ({slots} lanes, {chunk_s:g} s chunks)",
            profile / "serve_pool_trace.json", per=pumps, per_what="pump",
            kind=(torch.autograd.DeviceType.CUDA if torch.device(device).type == "cuda"
                  else torch.autograd.DeviceType.CPU))
    return out


@contextlib.contextmanager
def serve_process(workdir: Path, cfg, model, slots: int):
    """``python -m rnnt_tpu_torch.cli.serve`` on a checkpoint of ``model``
    (written by compat/jax_params.save_checkpoint) with ``slots`` slots on
    a free port, on the card unless ``model`` lies on the CPU.  Yields
    {"proc", "port"}; on leaving, SIGINT (then SIGKILL) stops it and its
    output lands under "log"."""
    from rnnt_tpu_torch.compat.jax_params import save_checkpoint

    ckpt = save_checkpoint(workdir / "serve_ckpt", cfg, model)
    srv = dict(port=free_port(), log="")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    cmd = [sys.executable, "-m", "rnnt_tpu_torch.cli.serve", str(ckpt),
           "--port", str(srv["port"]), "--slots", str(slots)]
    if next(model.parameters()).device.type != "cuda":  # the CLI's default is the card
        cmd += ["--device", "cpu"]
    srv["proc"] = proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env,
        start_new_session=True)
    srv["started"] = time.perf_counter()
    try:
        yield srv
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            srv["log"] = proc.communicate(timeout=20)[0]
        except subprocess.TimeoutExpired:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            srv["log"] = proc.communicate()[0]


def serve_request(srv: dict, method: str, path: str, data=None, headers=None):
    import urllib.request

    r = urllib.request.Request(f"http://127.0.0.1:{srv['port']}{path}", data=data,
                               method=method, headers=headers or {})
    return json.loads(urllib.request.urlopen(r, timeout=120).read())


def wait_for_server(srv: dict, timeout=300) -> float:
    """Seconds from the server's start until it first answers /stats."""
    proc = srv["proc"]
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"cli.serve exited {proc.returncode}:\n"
                                 + proc.communicate()[0][-4000:])
        try:
            serve_request(srv, "GET", "/stats")
            return time.perf_counter() - srv["started"]
        except OSError:
            if time.perf_counter() - srv["started"] > timeout:
                raise AssertionError(f"cli.serve did not answer in {timeout} s")
            time.sleep(0.5)


def server_check(srv: dict, clients=4, seconds=2.0, chunk_s=0.2, timeout=300) -> dict:
    """Drive the server of ``serve_process`` with ``clients`` slots:
    ``clients`` concurrent HTTP clients each stream ``seconds`` (client 0
    at 48 kHz), /text, the 503 of a session past the slots, DELETE,
    /stats."""
    import threading
    import urllib.error

    import numpy as np

    def req(method, path, data=None, headers=None):
        return serve_request(srv, method, path, data, headers)

    sids, errors, feeds_ms = [None] * clients, [], []

    def client(ci):
        try:
            sid = req("POST", "/session")["session"]
            sids[ci] = sid
            rng = np.random.RandomState(100 + ci)
            rate = 48000 if ci == 0 else 16000
            step = int(chunk_s * rate)
            last = None
            for _ in range(int(seconds / chunk_s)):
                pcm = (rng.randn(step) * 3000).astype(np.int16)
                t0 = time.perf_counter()
                last = req("POST", f"/feed/{sid}", pcm.tobytes(),
                           headers={"X-Sample-Rate": str(rate)})
                feeds_ms.append((time.perf_counter() - t0) * 1e3)
                if set(last) != {"new_tokens", "text"}:
                    raise AssertionError(f"feed answered {last}")
            if req("GET", f"/text/{sid}")["text"] != last["text"]:
                raise AssertionError("/text differs from the last feed's text")
        except Exception as e:  # re-raised below
            errors.append((ci, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    load_s = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors}")
    try:
        req("POST", "/session")
        raise AssertionError(f"a session past {clients} slots was accepted")
    except urllib.error.HTTPError as e:
        if e.code != 503:
            raise
    texts = [req("DELETE", f"/session/{sid}")["text"] for sid in sids]
    stats = req("GET", "/stats")
    out = dict(clients=clients, seconds_each=seconds, load_s=load_s,
               feed_ms_p50=statistics.median(feeds_ms), feed_ms_max=max(feeds_ms),
               text_chars=[len(t) for t in texts], stats=stats)
    log(f"serve/server: {clients} clients x {seconds:g} s (client 0 at 48 kHz) in "
        f"{load_s:.2f} s, feed round trip p50 {out['feed_ms_p50']:.1f} ms (max "
        f"{out['feed_ms_max']:.1f}); 503 past {clients} slots; /stats {stats}")
    if stats["active_slots"] != 0 or stats["device_steps"] < 1:
        raise AssertionError(f"/stats after the clients: {stats}")
    if not stats["mean_batched_lanes"] > 1:
        raise AssertionError(f"no pump batched two clients: {stats}")
    return out


def serve_phase(workdir: Path, device, kernels, profile: Path | None = None,
                pool_config="base_convjs", pool_overrides=(), stream=None, pool=None,
                server=None) -> dict:
    """The serving path on ``device``: cli.serve is started on a checkpoint
    of the pool's model (random weights from seed 0) and comes up while
    streamed is held against offline; once it answers (idle from then on),
    the pool runs at the serving benchmark's load, then the server's HTTP
    clients.  ``stream``, ``pool`` and ``server`` override the three
    checks' arguments (a smaller rehearsal on the CPU)."""
    from rnnt_tpu_torch.models.rnnt import rnnt_init

    t0 = time.perf_counter()
    cfg, spec, fspec = serve_cfg(workdir, pool_config, pool_overrides)
    model = rnnt_init(spec, seed=0, device=device)
    res = {}
    with serve_process(workdir, cfg, model, (server or {}).get("clients", 4)) as srv:
        res["stream"] = stream_offline_check(workdir, device, **(stream or {}))
        up_s = wait_for_server(srv)
        log(f"serve/server: answering {up_s:.1f} s after its start (the stream check "
            f"ran meanwhile); the pool is timed with it idle")
        res["pool"] = pool_load_check(device, kernels, model, fspec, config=pool_config,
                                      profile=profile, **(pool or {}))
        res["server"] = server_check(srv, **(server or {})) | dict(up_s=up_s)
    banner = next((ln for ln in srv["log"].splitlines() if ln.startswith("serving on")), "")
    res["server"]["banner"] = banner
    res["seconds"] = time.perf_counter() - t0
    log(f"serve phase: {res['seconds']:.1f} s; the server printed: {banner or 'nothing'}")
    return res


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
                           if k.startswith("launches/")},
                 by_rank={k.split("/", 1)[1]: n for k, n in r.items()
                          if k.startswith("launches_by_rank/")})
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


# ------------------------- decode: beam and rescoring -------------------------

# The rescoring NLLs (K3 on the B x C candidate lattices) against the plain
# alpha recursion on the same log-probs, relative, as PATH_NLL_RTOL holds
# the eval path's NLL: float32 log-sum-exps of O(10^3) in another order
# (1.7e-6 read on an H100, PERF.md §6).
RESCORE_RTOL = 1e-3
# Scores of the beam's greedy guard against a separate K = 1 raw run: the
# same computation, so equal up to float32 rounding of the comparison.
GUARD_RTOL = 1e-5
# Blank biases at which the untrained full-width models (seed 0) emit some
# tokens, but fewer than the buffer holds, read off
# scripts/blank_bias_sweep.py on an H100 (PERF.md §6): base_convjs at
# bench_beam's load, 4 utterances, 49-94 of 200 at 1.0 (200 at 0.5, 0-23 at
# 1.25); base_sp_lstm (batch norm, uncentred), 10 s, 8 tokens at 1.0.
DECODE_BIAS = 1.0
LSTM_STREAM_BIAS = 1.0


def kernel_stats(fn, device):
    """(kernels launched, device busy ms) in one call of ``fn``
    (torch.profiler); (None, None) off the card."""
    if torch.device(device).type != "cuda":
        fn()
        return None, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), busy_us(kernels) / 1e3


def bench_beam_audio(fspec, device, batch: int, seconds: float):
    """``bench.py`` ``bench_beam``'s batch (``_synthetic_batch``): ``batch``
    utterances of randn x 0.1 (RandomState(0)), ``seconds`` rounded up to
    whole frames, full lens."""
    import numpy as np

    samples = fspec.samples_for_frames(fspec.num_frames(int(seconds * fspec.sample_rate)))
    wave = np.random.RandomState(0).randn(batch, samples).astype(np.float32) * 0.1
    return {"audio": torch.from_numpy(wave).to(device),
            "audio_lens": torch.full((batch,), samples, dtype=torch.int32, device=device)}


@contextlib.contextmanager
def blank_bias(model, bias: float):
    """The joint's blank output bias set to ``bias`` inside the block."""
    b = model.joint.out.b
    old = float(b[model.spec.blank_idx])
    with torch.no_grad():
        b[model.spec.blank_idx] = bias
    try:
        yield
    finally:
        with torch.no_grad():
            b[model.spec.blank_idx] = old


def top_k_tie_check(device, rows: int, k: int, vocab: int) -> int:
    """decode/beam.py ``top_k`` on the device against numpy's stable
    argsort on a (rows, k + k * vocab) pool of a few distinct values
    (NEG among them), where nearly every entry ties: the same indices, the
    lower first among equals (``lax.top_k``'s rule).  Returns the ties
    among the picked entries."""
    import numpy as np

    from rnnt_tpu_torch.decode.beam import NEG, top_k

    rng = np.random.RandomState(3)
    levels = np.array([NEG, -7.5, -3.25, -3.0, 0.0], np.float32)
    pool = levels[rng.randint(0, len(levels), (rows, k + k * vocab))]
    want = np.argsort(-pool, axis=1, kind="stable")[:, :k]
    _, got = top_k(torch.from_numpy(pool).to(device), k)
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("top_k on the device broke a tie out of index order")
    picked = np.take_along_axis(pool, want, axis=1)
    return int((picked[:, 1:] == picked[:, :-1]).sum())


def decode_phase(workdir: Path, device, kernels, lse_ns: float, config="base_convjs",
                 batch=16, seconds=10.0, max_tokens=200, beam=8, check_utts=4,
                 rescore_utts=4, bias=DECODE_BIAS, reps=2) -> dict:
    """Beam search and N-best rescoring on the full-width ``config`` (random
    weights from seed 0, the eval forward at the config's precision):

    * beam ``beam`` with the defaults at ``bench_beam``'s load (``batch``
      utterances of ``seconds``, ``max_tokens``): audio-s/s and wall ms a
      call (``reps`` calls after a warm-up one), expansion rounds and window
      iterations, host syncs (CUDA's sync debug mode) and kernel launches
      a call; counts <= max_tokens and every returned path score >= the
      width-1 raw run's (the greedy guard);
    * at blank bias ``bias``, on ``check_utts`` utterances: width 1 with raw
      ranking, no merge and no guard equal to greedy_decode, width 4 with
      ``frames_per_step`` 8 equal to 1, tokens emitted but fewer than the
      buffer; the smallest top-2 margin along utterance 0's greedy path;
    * at that bias, ``beam_decode_nbest`` (``beam`` + the greedy chain)
      and ``marginal_rescore`` on ``rescore_utts`` utterances, the kernels'
      counts set to 0 before the rescore and read after: K3 launched, no
      other kernel; the NLLs within RESCORE_RTOL of the plain alpha on the
      same log-probs (finite entries; the same entries finite); the pick's
      plain NLL the plain minimum within RESCORE_RTOL; the lattice's shape,
      the rescore's wall ms, K3's device ms at that shape beside its bytes
      and critical-path bounds (diagonals x ``lse_ns``)."""
    from rnnt_tpu_torch.decode.beam import beam_decode, beam_decode_nbest, beam_search_final
    from rnnt_tpu_torch.decode.greedy import greedy_decode
    from rnnt_tpu_torch.decode.rescore import marginal_rescore, rescore_lattice_inputs
    from rnnt_tpu_torch.models.rnnt import rnnt_init
    from rnnt_tpu_torch.ops.lattice_pallas import alpha_forward
    from rnnt_tpu_torch.ops.transducer import joint_lattice_log_probs, transducer_alpha_loss
    from rnnt_tpu_torch.train.step import make_eval_forward

    t_phase = time.perf_counter()
    cfg, spec, fspec = serve_cfg(workdir, config)
    ties = top_k_tie_check(device, batch, beam, spec.joint.num_classes)
    model = rnnt_init(spec, seed=0, device=device)
    dec, specs = (model.predictor, model.joint), (spec.predictor, spec.joint)
    blank = spec.blank_idx
    out = dict(config=config, batch=batch, seconds=seconds, beam=beam, max_tokens=max_tokens,
               top_k_ties=ties)
    with torch.inference_mode():
        audio, t_lens = make_eval_forward(spec, fspec, cfg.training.precision)(
            model, bench_beam_audio(fspec, device, batch, seconds))

        # ---- beam at bench_beam's load, the defaults ----
        def beam_call():
            return beam_decode(*dec, audio, t_lens, *specs, beam_width=beam,
                               max_tokens=max_tokens)

        tokens, counts, scores = beam_call()  # warm-up
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            tokens, counts, scores = beam_call()
        sync(device)
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        syncs = count_syncs(beam_call, device)
        launches, busy_ms = kernel_stats(beam_call, device)
        search = beam_search_final(*dec, audio, t_lens, *specs, beam_width=beam,
                                   max_tokens=max_tokens)
        guard = beam_search_final(*dec, audio, t_lens, *specs, beam_width=1,
                                  max_tokens=max_tokens, merge_paths=False,
                                  search_norm=False)
        _, raw_n, raw_scores = beam_decode(*dec, audio, t_lens, *specs, beam_width=1,
                                           max_tokens=max_tokens, length_norm=False,
                                           merge_paths=False, search_norm=False,
                                           greedy_guard=False)
    out["beam"] = dict(
        audio_s_per_s=batch * seconds / (wall_ms / 1e3), wall_ms=wall_ms,
        rounds=search.rounds + guard.rounds, iterations=search.iterations + guard.iterations,
        loop_syncs=search.syncs + guard.syncs, host_syncs=syncs, kernel_launches=launches,
        device_busy_ms=busy_ms,
        encoder_frames=int(t_lens.max()), tokens=counts.tolist(), raw_tokens=raw_n.tolist())
    log(f"decode/top_k: a ({batch}, {beam} + {beam} x {spec.joint.num_classes}) pool of 5 "
        f"values, {ties} ties "
        f"among the picks: the indices of numpy's stable argsort")
    log(f"decode/beam: {config}, {batch} x {seconds:g} s, width {beam}, max_tokens "
        f"{max_tokens}: {out['beam']['audio_s_per_s']:.2f} audio-s/s, {wall_ms:.1f} ms a call "
        f"({int(t_lens.max())} encoder frames); per call {out['beam']['rounds']} expansion "
        f"rounds over {out['beam']['iterations']} window iterations (width {beam} + the "
        f"width-1 guard), {syncs} host syncs ({out['beam']['loop_syncs']} by the loops' "
        f"exit tests), {launches} kernel launches, the card busy {busy_ms} ms of a traced "
        f"call; tokens {counts.tolist()}")
    if not bool((counts <= max_tokens).all()):
        raise AssertionError(f"beam counts {counts.tolist()} exceed {max_tokens}")
    slack = GUARD_RTOL * raw_scores.abs()
    if not bool((scores >= raw_scores - slack).all()):
        raise AssertionError(f"beam scores {scores.tolist()} below the width-1 raw run's "
                             f"{raw_scores.tolist()}")

    # ---- exactness checks where the model emits, below the buffer ----
    a4, tl4 = audio[:check_utts], t_lens[:check_utts]
    with torch.inference_mode(), blank_bias(model, bias):
        g_tok, g_n = greedy_decode(*dec, a4, tl4, *specs, max_tokens=max_tokens)
        b_tok, b_n, _ = beam_decode(*dec, a4, tl4, *specs, beam_width=1, max_tokens=max_tokens,
                                    length_norm=False, merge_paths=False, search_norm=False,
                                    greedy_guard=False)
        w8 = beam_decode(*dec, a4, tl4, *specs, beam_width=4, max_tokens=max_tokens,
                         frames_per_step=8)
        w1 = beam_decode(*dec, a4, tl4, *specs, beam_width=4, max_tokens=max_tokens,
                         frames_per_step=1)
        hyp = g_tok[0, :int(g_n[0])].tolist()
        margin = smallest_margin(model, a4[:1, :int(tl4[0])], hyp)
    out["checks"] = dict(blank_bias=bias, utterances=check_utts, greedy_tokens=g_n.tolist(),
                         beam4_tokens=w8[1].tolist(), min_top2_margin=margin)
    log(f"decode/checks at blank bias {bias:g}, {check_utts} utterances: width 1 (raw) "
        f"{b_n.tolist()} tokens vs greedy {g_n.tolist()}; width 4 window 8 {w8[1].tolist()} "
        f"vs window 1 {w1[1].tolist()}; smallest top-2 margin on utterance 0's greedy "
        f"path {margin:.4e}")
    if not (torch.equal(b_n, g_n) and torch.equal(b_tok, g_tok)):
        raise AssertionError("width-1 beam differs from greedy decode")
    if not (torch.equal(w8[1], w1[1]) and torch.equal(w8[0], w1[0])):
        raise AssertionError("width-4 beam: window 8 differs from window 1")
    for name, n in (("greedy", g_n), ("width 4", w8[1])):
        if not (int(n.sum()) > 0 and int(n.max()) < max_tokens):
            raise AssertionError(f"{name} at blank bias {bias}: tokens {n.tolist()}, need "
                                 f"some and fewer than {max_tokens} for the checks to mean "
                                 "something")

    # ---- N-best marginal rescoring (K3 on B x C lattices) ----
    ar, tlr = audio[:rescore_utts], t_lens[:rescore_utts]
    chunk = cfg.training.loss_chunk_size
    with torch.inference_mode(), blank_bias(model, bias):
        toks, cnts, _ = beam_decode_nbest(*dec, ar, tlr, *specs, beam_width=beam,
                                          max_tokens=max_tokens)
        for k in kernels:
            k.launches = 0
        sync(device)
        t0 = time.perf_counter()
        best_t, best_n, nll = marginal_rescore(*dec, ar, tlr, toks, cnts, *specs,
                                               chunk_size=chunk)
        sync(device)
        rescore_ms = (time.perf_counter() - t0) * 1e3
        rs_launches = {k.name: k.launches for k in kernels}
        ac, text, tgt, tlc, ul = rescore_lattice_inputs(model.predictor, ar, tlr, toks, cnts,
                                                        blank)
        lpb, lpl = joint_lattice_log_probs(model.joint, ac, text, tgt, ul, blank, chunk)
        t0 = time.perf_counter()
        plain = transducer_alpha_loss(lpb, lpl, tlc, ul).reshape(nll.shape)
        sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        k3_args = (lpb.contiguous(), lpl.contiguous(), tlc.to(torch.int32).contiguous(),
                   ul.to(torch.int32).contiguous())
        k3_ms = (device_ms(lambda: alpha_forward(*k3_args))
                 if torch.device(device).type == "cuda" else None)
    BC, T, U1 = lpb.shape
    bytes_ms, bound_by = k3_bound(BC, T, U1)
    path_ms = (T + U1 - 1) * lse_ns * 1e-6
    fin = torch.isfinite(plain)
    rel = float(((nll - plain).abs() / plain.abs())[fin].max()) if bool(fin.any()) else math.nan
    rows = torch.arange(nll.shape[0], device=nll.device)
    pick = nll.argmin(dim=1)
    pick_gap = float(((plain[rows, pick] - plain.min(dim=1).values)
                      / plain.min(dim=1).values.abs()).max())
    out["rescore"] = dict(
        lattice=[BC, T, U1], utterances=rescore_utts, candidates=nll.shape[1],
        u_lens=cnts.tolist(), wall_ms=rescore_ms, launches=rs_launches, max_rel_err=rel,
        pick_gap=pick_gap, k3_device_ms=k3_ms, k3_bound_ms=bytes_ms, k3_bound_by=bound_by,
        k3_critical_path_ms=path_ms, plain_alpha_ms=plain_ms, finite=int(fin.sum()),
        picked=pick.tolist())
    log(f"decode/rescore: {rescore_utts} utterances x {nll.shape[1]} candidates (width "
        f"{beam} + greedy) = lattice ({BC}, {T}, {U1}), candidate tokens {cnts.tolist()}: "
        f"{rescore_ms:.1f} ms wall, launches {rs_launches}; NLLs within {rel:.2e} of the "
        f"plain alpha over {int(fin.sum())} finite entries; picks {pick.tolist()} "
        f"(their plain NLL {pick_gap:.2e} above the plain minimum); K3 device "
        f"{k3_ms if k3_ms is None else f'{k3_ms:.4f}'} ms at this shape, bytes bound "
        f"{bytes_ms:.6f} ms, critical path {path_ms:.4f} ms ({T + U1 - 1} diagonals x "
        f"{lse_ns:.1f} ns); plain alpha {plain_ms:.1f} ms")
    k3 = next(k for k in kernels if k.name == "alpha_fwd")
    others = {n: c for n, c in rs_launches.items() if n != k3.name and c}
    if torch.device(device).type == "cuda" and (rs_launches[k3.name] < 1 or others):
        raise AssertionError(f"rescoring launched {rs_launches}: K3 and only K3 expected")
    if not torch.equal(fin, torch.isfinite(nll)):
        raise AssertionError("rescoring and the plain alpha disagree on which NLLs are finite")
    if not rel <= RESCORE_RTOL:
        raise AssertionError(f"rescoring NLLs {rel:.3e} from the plain alpha")
    if not pick_gap <= RESCORE_RTOL:
        raise AssertionError(f"a pick's plain NLL is {pick_gap:.3e} above the minimum")
    if not (torch.equal(best_n, cnts[rows, pick]) and torch.equal(best_t, toks[rows, pick])):
        raise AssertionError("marginal_rescore returned another candidate than its argmin")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"decode phase: {out['seconds']:.1f} s")
    return out


LSTM_CONFIG = "base_sp_lstm"
LSTM_TRAIN_OVERRIDES = ["data.dataset=synthetic", "data.synthetic_seconds=10",
                        "data.synthetic_size=16", "training.global_batch_size=4",
                        "training.log_steps=1", "training.eval_max_elements=8",
                        "tokenizer.spm_model=''"]
# Streamed equals offline exactly with frozen batch-norm statistics and an
# uncentred featurizer (a centred one reflects each chunk's edges); the
# LSTM config's instance norms and centred mel frames are swapped for these.
LSTM_STREAM_OVERRIDES = ("encoder.norm_type=batch", "featurizer.center=false")


def lstm_phase(workdir: Path, device, kernels, config=LSTM_CONFIG,
               overrides=LSTM_TRAIN_OVERRIDES, steps=2, eval_batch=4, eval_elements=8,
               stream=None) -> dict:
    """The LSTM predictor through the port's entry points on ``device``:
    ``cli.train`` ``steps`` steps on ``config`` (its data settings,
    synthetic 10 s utterances, the in-code vocabulary; K1-K4 launched in
    every step, K5-K7 never; loss and gradient norm finite), ``cli.eval``
    on its checkpoint greedy and with ``--beam 4 --rescore`` (finite
    WERs), and streamed against offline on ``config`` with
    LSTM_STREAM_OVERRIDES (``stream_offline_check``; ``stream`` overrides
    its arguments)."""
    from rnnt_tpu_torch.cli import eval as cli_eval
    from rnnt_tpu_torch.cli import train as cli_train
    from rnnt_tpu_torch.config.config import load_config, resolve_config
    from rnnt_tpu_torch.data.dataset import synthetic_piece_table

    t_phase = time.perf_counter()
    vocab = workdir / "lstm_vocab.json"
    vocab.write_text(json.dumps(synthetic_piece_table()))
    exp = workdir / "lstm_exp"
    args = ["--config", config, "--output-base", str(exp), "--device", str(device),
            "--max-steps", str(steps)]
    for o in list(overrides) + [f"tokenizer.vocab_json={vocab}"]:
        args += ["--set", o]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    final_wer = cli_train.main(args)
    sync(device)
    train_s = time.perf_counter() - t0
    run_dir = _latest_run(exp, load_config(resolve_config(config)).model_name)
    rows = _read_steps(run_dir)
    lattice = {"joint_fwd", "joint_bwd", "alpha_fwd", "beta_bwd"}
    for st in rows:
        log(f"lstm/train step {st['step']}: loss {st['loss']:.4f}, grad norm "
            f"{st['grad_norm']:.4f}, {st['seconds']:.4f} s, {st['audio_s_per_s']:.2f} "
            f"audio-s/s, launches {st['launches']}")
        if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
            raise AssertionError(f"lstm: non-finite step {st}")
        if torch.device(device).type == "cuda":
            bad = {k: n for k, n in st["launches"].items()
                   if (k in lattice) != bool(n)}
            if bad:
                raise AssertionError(f"lstm step {st['step']}: K1-K4 must launch and "
                                     f"K5-K7 must not, got {st['launches']}")
    if len(rows) != steps:
        raise AssertionError(f"lstm: {len(rows)} steps logged, expected {steps}")
    ckpt = run_dir / f"checkpoint_step_{steps}"
    evals = {}
    for tag, extra in (("greedy", []), ("beam4_rescore", ["--beam", "4", "--rescore"])):
        t0 = time.perf_counter()
        res = cli_eval.main([str(ckpt), "--device", str(device), "--batch-size",
                             str(eval_batch), "--max-elements", str(eval_elements), *extra])
        evals[tag] = dict(wer=res["wer"], utterances=res["utterances"],
                          seconds=time.perf_counter() - t0)
        log(f"lstm/cli.eval {tag}: WER {res['wer']:.4f} over {res['utterances']} utterances "
            f"in {evals[tag]['seconds']:.1f} s")
        if not math.isfinite(res["wer"]):
            raise AssertionError(f"lstm cli.eval {tag}: WER {res['wer']}")
    stream = stream_offline_check(workdir, device, **(stream or dict(
        config=config, overrides=LSTM_STREAM_OVERRIDES,
        cases=((LSTM_STREAM_BIAS, 10.0, 64),))))
    out = dict(config=config, final_wer=final_wer, train_s=train_s,
               steps=[{k: st[k] for k in ("step", "loss", "grad_norm", "seconds",
                                          "audio_s_per_s", "launches")} for st in rows],
               eval=evals, stream=stream, seconds=time.perf_counter() - t_phase)
    log(f"lstm phase: {out['seconds']:.1f} s (cli.train {train_s:.1f} s with start-up and "
        f"its eval)")
    return out


# ----------------------------- multi-rank training -----------------------------

RANK_TIMEOUT = 600  # seconds for one torch.distributed.run of cli.train
# Step for step agreement of a 2-rank run with the 1-rank run, relative, in
# the loss and the global gradient norm (see multi_rank_phase): about 10x
# the gaps measured on an H100 (700 W).  T-sharded: loss 1.1e-6, gradient
# norm 6.3e-7 at step 1 (the same weights; the model ranks' partial bf16
# encoder gradients summed) and 9.3e-4 at step 2, whose weights differ by
# the sign Adam's first update gives the round-off gradients of the conv
# biases in front of instance norms (on the CPU in float32 both steps
# agree exactly, tests/test_torch_distributed.py).  Data-parallel: loss
# up to 3.7e-6, gradient norm 1.6e-4 at step 1 (each rank's bf16
# convolutions run on 2 rows instead of 4, so cuDNN may sum in another
# order) and 3.6e-5 to 7.7e-4 at step 2 over three runs (the same Adam
# sign noise).
TSHARD_RTOL = dict(loss=1e-5, grad_norm=1e-2)
DP_RTOL = dict(loss=5e-5, grad_norm=1e-2)


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_ranks(n: int, args: list, log_path: Path, timeout: int = RANK_TIMEOUT) -> None:
    """``python -m torch.distributed.run --nproc-per-node n -m
    rnnt_tpu_torch.cli.train *args``, its output to ``log_path``; raises
    when a rank fails or the run outlasts ``timeout`` (its whole process
    group is killed either way)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", "rnnt_tpu_torch.cli.train", *args]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=REPO, env=env, start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        out = None
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    if out is None:
        proc.communicate()
        raise AssertionError(f"{n}-rank cli.train outlasted {timeout} s")
    log_path.write_text(out)
    if proc.returncode != 0:
        raise AssertionError(f"{n}-rank cli.train exited {proc.returncode}:\n"
                             + "\n".join(out.splitlines()[-40:]))


def exchange_worker(n_grad: int, backend: str, tp: str | None = None, hops: int = 200,
                    reps: int = 5) -> None:
    """One rank of ``exchange_phase`` (run under torch.distributed.run):
    gloo ranks share cuda:0, NCCL ranks take cuda:LOCAL_RANK; host-timed,
    each measurement ending on the host.  Ranks 0 and 1 pass the carry
    rows; rank 0 prints one JSON line.  ``tp`` ("B,T,U1,H,C": the joint's
    lattice, its width and encoder.out's input width) adds the
    tensor-parallel joint's collectives over all the ranks as one model
    group (``tp_dims``)."""
    import torch.distributed as dist

    from rnnt_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh, recv_row, send_row

    dev = torch.device("cuda", 0 if backend == "gloo" else int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    mesh = make_mesh(1, dist.get_world_size())
    rank = mesh.rank
    out = {}
    for U in (65, 257):
        row = torch.randn(4, U, device=dev)

        def round_trip(row):
            if rank == 0:
                send_row(row, 1, mesh)
                return recv_row(row, 1, mesh)
            if rank == 1:
                row = recv_row(row, 0, mesh)
                send_row(row, 0, mesh)
            return row

        for _ in range(10):
            row = round_trip(row)
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(hops):
            row = round_trip(row)
        torch.cuda.synchronize()
        out[f"hop_ms_U{U}"] = (time.perf_counter() - t) / (2 * hops) * 1e3
    ll = torch.randn(4, device=dev)

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    out["ll_all_reduce_ms"] = timed(lambda: all_reduce_sum(ll), hops)
    flat = torch.randn(n_grad, device=dev)
    out["grad_all_reduce_ms"] = timed(lambda: all_reduce_sum(flat), reps)
    out.update(grad_floats=n_grad, backend=backend, ranks=mesh.world)
    if tp is not None:
        out["tp"] = tp_collectives(mesh, dev, *map(int, tp.split(",")), reps=reps,
                                   timed=timed)
    if rank == 0:
        print(json.dumps({"exchange": out}), flush=True)
    dist.destroy_process_group()


def tp_collectives(mesh, dev, B: int, T: int, U1: int, H: int, C: int, reps: int,
                   timed) -> dict:
    """Milliseconds of each collective one tensor-parallel step makes over
    its model group (``mesh`` with every rank on the model axis), at the
    joint's lattice (B, T, U1), width H and encoder.out's input width C:
    the lse merge (an all-reduce of the max, then of the (3, B, T, U1)
    sums), the all-reduce of K2's denc and dpred (float32), encoder.out's
    all-gather of (B, T, H / m) and the all-reduce of its input's gradient
    (B, T, C), both in bf16; the predictor's are the same over U1 rows in
    place of T (not timed)."""
    import torch.distributed as dist

    from rnnt_tpu_torch.parallel.mesh import all_gather_dim, all_reduce_max, all_reduce_sum

    lse = torch.randn(B, T, U1, device=dev)
    sums = torch.randn(3, B, T, U1, device=dev)
    grads = torch.randn(B * (T + U1) * H, device=dev)
    half = torch.randn(B, T, H // mesh.model, device=dev).to(torch.bfloat16)
    x_grad = torch.randn(B, T, C, device=dev).to(torch.bfloat16)
    out = dict(shape=f"B={B} T={T} U1={U1} H={H} C={C}", backend=dist.get_backend(),
               lse_merge_ms=timed(lambda: (all_reduce_max(lse, mesh),
                                           all_reduce_sum(sums, mesh.model_group)), reps),
               denc_dpred_all_reduce_ms=timed(
                   lambda: all_reduce_sum(grads, mesh.model_group), reps),
               encoder_gather_ms=timed(lambda: all_gather_dim(half, 2, mesh), reps),
               encoder_input_grad_ms=timed(
                   lambda: all_reduce_sum(x_grad, mesh.model_group), reps))
    out["step_ms"] = sum(v for k, v in out.items() if k.endswith("_ms"))
    return out


def tp_lattice(vocab: Path) -> dict:
    """The tp case's joint as K1 and K2 take it, (B, T, U1, H, V): batch 4,
    T' of its 10 s bucket (1024 frames), U1 of the 64-token bucket,
    scaled_tp's H and V; C, encoder.out's input width, beside them."""
    from rnnt_tpu_torch.config.config import (
        apply_overrides, build_model_spec, load_config, resolve_config)
    from rnnt_tpu_torch.models.encoder import encoder_out_len

    cfg = apply_overrides(load_config(resolve_config(TP_CONFIG)),
                          TP_OVERRIDES + [f"tokenizer.vocab_json={vocab}"])
    spec = build_model_spec(cfg)
    return dict(B=4, T=encoder_out_len(1024, spec.encoder), U1=65,
                H=spec.joint.hidden_features, V=spec.joint.num_classes,
                C=spec.encoder.epilogue_features)


def tp_dims(vocab: Path) -> str:
    """"B,T,U1,H,C" of the tp case's joint (``tp_lattice``)."""
    return "{B},{T},{U1},{H},{C}".format(**tp_lattice(vocab))


def flagship_params(train: dict) -> int:
    """The number of parameters (the flat gradient's length) of the train
    phase's flagship configuration, pruned loss heads included."""
    from rnnt_tpu_torch.config.config import (
        apply_overrides, build_model_spec, load_config, resolve_config)
    from rnnt_tpu_torch.models.rnnt import rnnt_init

    cfg = apply_overrides(load_config(resolve_config(train["config"])),
                          train["overrides"] + [f"tokenizer.vocab_json={train['vocab']}"])
    return sum(p.numel() for p in rnnt_init(build_model_spec(cfg)).parameters())


def exchange_phase(workdir: Path, n_grad: int, ranks: int = 2, backend: str = "gloo",
                   tp: str | None = None) -> dict:
    """What the multi-rank layer's transport costs: one (4, U) carry row per
    hop between ranks 0 and 1 (U = 65 and 257; over gloo through pinned
    host memory), the (4,) log-likelihood all-reduce, and the flat gradient
    all-reduce of ``n_grad`` float32 values; gloo ranks share this card,
    NCCL ranks take one card each.  ``tp`` (``tp_dims``) adds the
    tensor-parallel joint's collectives (``tp_collectives``)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(ranks),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           str(REPO / "chip_smoke.py"), "--exchange", str(n_grad),
           "--exchange-backend", backend] + (["--exchange-tp", tp] if tp else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=RANK_TIMEOUT)
    (workdir / "exchange.log").write_text(out.stdout + out.stderr)
    line = next((x for x in out.stdout.splitlines() if x.startswith('{"exchange"')), None)
    if out.returncode != 0 or line is None:
        raise AssertionError(f"exchange phase exited {out.returncode}:\n"
                             + "\n".join((out.stdout + out.stderr).splitlines()[-30:]))
    res = json.loads(line)["exchange"]
    where = "this card" if backend == "gloo" else "a card each"
    log(f"{backend} between {ranks} ranks on {where}: one carry row per hop "
        f"{res['hop_ms_U65']:.4f} ms (4 x 65) / {res['hop_ms_U257']:.4f} ms (4 x 257), "
        f"the (4,) ll all-reduce {res['ll_all_reduce_ms']:.4f} ms, the flat gradient "
        f"all-reduce of {n_grad:,} floats {res['grad_all_reduce_ms']:.1f} ms")
    if "tp" in res:
        t = res["tp"]
        log(f"{backend} tensor-parallel joint's collectives over {ranks} model ranks at "
            f"{t['shape']}: lse merge {t['lse_merge_ms']:.3f} ms, denc + dpred all-reduce "
            f"{t['denc_dpred_all_reduce_ms']:.3f} ms, encoder.out gather "
            f"{t['encoder_gather_ms']:.3f} ms, its input gradient's all-reduce "
            f"{t['encoder_input_grad_ms']:.3f} ms: {t['step_ms']:.3f} ms a step")
    return res


def other_card_phase(card: int) -> None:
    """K1-K7 on tensors of ``cuda:card`` while cuda:0 stays the current
    device: each launch must run on its tensors' card, and agree there with
    its plain version (the stated tolerances)."""
    from rnnt_tpu_torch.ops.lattice_pallas import (
        alpha_chain_forward, alpha_chain_plain, alpha_forward, alpha_plain, beta_backward,
        beta_chain_backward, beta_chain_plain, beta_plain)
    from rnnt_tpu_torch.ops.transducer import NEG
    from rnnt_tpu_torch.ops.transducer_pallas import (
        fused_joint_backward, fused_joint_bwd_plain, fused_joint_outputs,
        fused_joint_outputs_plain)
    from rnnt_tpu_torch.ops.window_gather import gather_windows, gather_windows_plain

    dev = torch.device("cuda", card)
    if torch.cuda.current_device() == card:
        raise AssertionError(f"cuda:{card} must not be the current device here")
    args = k1_inputs(B=2, T=33, U1=17, H=1024, V=1024, device=dev)
    lse, *_ = outs = fused_joint_outputs(*args)
    for n, g, w in zip(("lse", "blank", "label"), outs, fused_joint_outputs_plain(*args)):
        check_close(f"cuda:{card} K1 {n}", g, w, **K1_TOL)
    cot = [torch.randn_like(lse) * 0.3 for _ in range(2)]
    cot = (lse, cot[0], cot[1], -(cot[0] + cot[1]))
    for n, x, y in zip(("denc", "dpred", "dW", "db"), fused_joint_backward(*args, *cot),
                       fused_joint_bwd_plain(*args, *cot)):
        if not rel_l2(x, y) <= K2_REL_L2:
            raise AssertionError(f"cuda:{card} K2 {n}: relative L2 {rel_l2(x, y):.3e}")
    lpb, lpl, t_lens, u_lens = k3_inputs(B=4, T=64, U1=17, device=dev)
    nll, alpha = alpha_forward(lpb, lpl, t_lens, u_lens)
    check_k3(nll, alpha, *alpha_plain(lpb, lpl, t_lens, u_lens), t_lens, u_lens)
    g = torch.ones_like(nll)
    for n, x, y in zip(("glpb", "glpl"), beta_backward(lpb, lpl, alpha, t_lens, u_lens, nll, g),
                       beta_plain(lpb, lpl, alpha, t_lens, u_lens, nll, g)):
        check_close(f"cuda:{card} K4 {n}", x, y, **K4_TOL)
    b, lb = lpb[:, 32:].contiguous(), lpl[:, 32:].contiguous()
    carry = torch.full((4, 17), NEG, device=dev)
    got = alpha_chain_forward(b, lb, t_lens, u_lens, 32, alpha[:, 31] + lpb[:, 31])
    want = alpha_chain_plain(b, lb, t_lens, u_lens, 32, alpha[:, 31] + lpb[:, 31])
    check_live(f"cuda:{card} K6 alpha", got[0], want[0], K3_TOL)
    ll = -nll
    for n, x, y in zip(("glpb", "glpl"),
                       beta_chain_backward(b, lb, got[0], t_lens, u_lens, ll, g, 32, carry),
                       beta_chain_plain(b, lb, got[0], t_lens, u_lens, ll, g, 32, carry)):
        check_close(f"cuda:{card} K7 {n}", x, y, **K4_TOL)
    x = torch.randn(3, 5000, device=dev)
    starts = torch.randint(-100, 5100, (3, 37), dtype=torch.int32, device=dev)
    if not torch.equal(gather_windows(x, starts, 256), gather_windows_plain(x, starts, 256)):
        raise AssertionError(f"cuda:{card} K5 differs from its plain version")
    torch.cuda.synchronize(dev)
    log(f"cuda:{card} (cuda:0 current): K1-K7 launched on the tensors' card and agree "
        "with their plain versions")


def _latest_run(exp: Path, model_name: str) -> Path:
    return max((exp / model_name).glob("run-*"), key=lambda p: int(p.name[4:]))


# The tensor-parallel case: scaled_tp at full width (202,905,216 parameters)
# on its 2 model ranks, synthetic 10 s utterances; the batch is cut from the
# YAML's 16 to 4 to bound the phase's time.  The batch-norm case:
# base_convjs_fullcausal (batch norm everywhere) on 2 data ranks, 1 step.
TP_CONFIG, BN_CONFIG = "scaled_tp", "base_convjs_fullcausal"
TP_OVERRIDES = ["data.dataset=synthetic", "data.synthetic_seconds=10",
                "data.synthetic_size=16", "training.global_batch_size=4",
                "training.log_steps=1", "training.eval_max_elements=4",
                "tokenizer.spm_model=''"]
# The pruned objective on the same mesh: 1 warmup step (the exact loss and
# the simple joint on V slices), then 1 banded step (K1 and K2 on V slices of
# the band's patches).
TP_PRUNED = ["training.loss_impl=pruned", "training.pruned_warmup_steps=1"]
REPLICA_LINE = re.compile(r"replicated parameters bit-equal on the (\d+) ranks at step (\d+)")
TP_LINE = re.compile(r"tensor parallel over (\d+) model ranks: (\d+) tensors sharded "
                     r"\(([\d,]+) parameters on each rank\); each rank holds ([\d,]+)")


def multi_rank_phase(workdir: Path, device, train: dict, cards: int = 1,
                     cases=("tshard", "data_parallel", "tp", "tp_pruned", "bn")) -> dict:
    """The multi-rank layer through ``torch.distributed.run`` and cli.train,
    each run against the same config on 1 rank in this process.  On one
    card 2 ranks share it over gloo (``--device cuda:0 --dist-backend
    gloo``); with ``cards`` > 1, one rank per card over NCCL (``--device
    cuda``, each rank on ``cuda:LOCAL_RANK``).

    * ``tshard``: full-width ``base_convjs`` with the YAML's data settings
      (corpus cached on each rank's card, ``augment_device: full``: K5 on
      every rank), 2 steps, ``lattice_shard_t=true``, ``mesh.model=2`` and
      ``mesh.data=cards // 2`` (at least 1), with ``loss_impl=auto`` (the
      T-sharded loss takes the chunked joint whatever the loss_impl, as in
      the reference, while rank 0's eval scores the exact NLL through K1 +
      K3), against 1 rank with ``loss_impl=chunked`` (the chunked joint, K3
      and K4 on the whole lattice): K6 and K7 once per step on each rank,
      K3 and K4 never;
    * ``data_parallel``: the same flagship with ``mesh.data`` = the ranks,
      the pruned loss with 1 warmup step and 1 banded step: K1-K5 on each
      rank in each step;
    * ``tp``: full-width ``scaled_tp`` (TP_OVERRIDES, its own data
      settings: the host recipe) on ``mesh.data=1 mesh.model=2``, 2 steps:
      each rank holds V / 2 of the joint and H / 2 of ``encoder.out`` and
      ``predictor.linear``; K1-K4 once per step on each rank (K1 and K2 on
      the rank's slice), K5-K7 never; rank 0's eval on the gathered model;
      every rank's replicated parameters bit-equal at the final save (the
      line cli.train prints after comparing their digests);
    * ``tp_pruned``: the same with the pruned loss (TP_PRUNED), 1 warmup
      and 1 banded step: K1 and K2 once per step on each rank, K3 and K4
      in each;
    * ``bn``: full-width ``base_convjs_fullcausal`` (batch norm) on
      ``mesh.data`` = the ranks, 1 step: statistics over the data group.

    Each step's loss and gradient norm must agree within TSHARD_RTOL /
    DP_RTOL; metrics.jsonl (rank 0's) is read once per run."""
    from rnnt_tpu_torch.cli import train as cli_train
    from rnnt_tpu_torch.config.config import load_config, resolve_config

    exp = workdir / "exp_ranks"
    on_card = torch.device(device).type == "cuda"
    n = max(cards, 2)
    ranks = (["--device", "cpu"] if not on_card
             else ["--device", "cuda:0", "--dist-backend", "gloo"] if cards == 1
             else ["--device", "cuda"])
    flagship = (train["config"], train["overrides"])
    tp = train.get("tp", (TP_CONFIG, TP_OVERRIDES))
    bn = train.get("bn", (BN_CONFIG, TP_OVERRIDES))
    kernels_once = dict(joint_fwd=1, joint_bwd=1, alpha_fwd=1, beta_bwd=1, window_gather=0,
                        alpha_chain=0, beta_chain=0)
    table = {
        "tshard": (flagship, 2,
                   ["training.loss_impl=auto", "training.lattice_shard_t=true",
                    "mesh.model=2", f"mesh.data={n // 2}"],
                   ["training.loss_impl=chunked"], TSHARD_RTOL,
                   dict(alpha_chain=1, beta_chain=1, alpha_fwd=0, beta_bwd=0, joint_fwd=0,
                        joint_bwd=0, window_gather=4)),
        "data_parallel": (flagship, 2, ["training.pruned_warmup_steps=1", f"mesh.data={n}"],
                          ["training.pruned_warmup_steps=1"], DP_RTOL,
                          dict(joint_fwd=None, joint_bwd=None, alpha_fwd=None, beta_bwd=None,
                               window_gather=4, alpha_chain=0, beta_chain=0)),
        "tp": (tp, 2, [f"mesh.data={n // 2}", "mesh.model=2"],
               ["mesh.data=1", "mesh.model=1"], DP_RTOL, kernels_once),
        "tp_pruned": ((tp[0], tp[1] + TP_PRUNED), 2, [f"mesh.data={n // 2}", "mesh.model=2"],
                      ["mesh.data=1", "mesh.model=1"], DP_RTOL,
                      dict(kernels_once, alpha_fwd=None, beta_bwd=None)),
        "bn": (bn, 1, [f"mesh.data={n}", "mesh.model=1"], ["mesh.data=1", "mesh.model=1"],
               DP_RTOL, kernels_once),
    }
    if on_card:
        torch.cuda.empty_cache()
    out = {}
    for key in cases:
        (config, overrides), steps, many, one, rtol, expect = table[key]
        model_name = load_config(resolve_config(config)).model_name
        base = ["--config", config, "--output-base", str(exp), "--max-steps", str(steps)]
        for o in overrides + [f"tokenizer.vocab_json={train['vocab']}"]:
            base += ["--set", o]
        t = time.time()
        log_path = workdir / f"{key}_ranks.log"
        run_ranks(n, base + [x for o in many for x in ("--set", o)] + ranks, log_path)
        secs = time.time() - t
        run2 = _latest_run(exp, model_name)
        steps2 = _read_steps(run2)
        records = [json.loads(x) for x in (run2 / "metrics.jsonl").read_text().splitlines()]
        evals = [r for r in records if "wer/eval" in r]
        t = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_train.main(base + [x for o in one for x in ("--set", o)]
                           + ["--device", str(device)])
        secs1 = time.time() - t
        steps1 = _read_steps(_latest_run(exp, model_name))
        want_steps = list(range(1, steps + 1))
        if [s["step"] for s in steps2] != want_steps or [s["step"] for s in steps1] != want_steps:
            raise AssertionError(f"{key}: steps {steps2} / {steps1}")
        gaps = []
        for s2, s1 in zip(steps2, steps1):
            gap = {k: abs(s2[k] - s1[k]) / abs(s1[k]) for k in ("loss", "grad_norm")}
            gaps.append(gap)
            log(f"  {key} step {s2['step']}: {n} ranks loss {s2['loss']:.6f} grad norm "
                f"{s2['grad_norm']:.6f} ({s2['seconds']:.3f} s, {s2['audio_s_per_s']:.2f} "
                f"audio-s/s); 1 rank {s1['loss']:.6f} / {s1['grad_norm']:.6f} "
                f"({s1['seconds']:.3f} s); relative gaps {gap['loss']:.2e} / "
                f"{gap['grad_norm']:.2e}; launches per rank {s2['by_rank']}")
            bad = [k for k in gap if not gap[k] <= rtol[k]]
            if bad or not (math.isfinite(s2["loss"]) and math.isfinite(s2["grad_norm"])):
                raise AssertionError(f"{key} step {s2['step']}: {n} ranks {s2} vs 1 rank {s1}, "
                                     f"relative gaps {gap} over {rtol}")
            for name, want in expect.items() if on_card else ():
                got = s2["by_rank"].get(name)
                if got is None or len(got) != n or any(
                        (c == 0) if want is None else (c != want) for c in got):
                    raise AssertionError(f"{key} step {s2['step']}: {name} launched "
                                         f"{got} times on the {n} ranks, expected "
                                         f"{'some' if want is None else want} on each")
        if len(evals) != 1 or not math.isfinite(evals[0]["wer/eval"]):
            raise AssertionError(f"{key}: rank 0's evals {evals}")
        ev = {k.split("/", 1)[1]: c for k, c in evals[0].items()
              if k.startswith("eval_launches/")}
        if on_card and key == "tshard" and not (ev.get("joint_fwd") and ev.get("alpha_fwd")):
            raise AssertionError(f"tshard: rank 0's eval launched {ev}, expected K1 and K3")
        log(f"{key}: {n} ranks in {secs:.1f} s, 1 rank in {secs1:.1f} s (start-up, cache, "
            f"{steps} step(s), rank 0's eval); metrics.jsonl steps "
            f"{[s['step'] for s in steps2]}, rank 0's eval WER {evals[0]['wer/eval']:.4f} "
            f"with launches {ev}")
        out[key] = dict(steps2=steps2, steps1=steps1, gaps=gaps, seconds=secs,
                        seconds_one_rank=secs1, eval_launches=ev)
        if key.startswith("tp"):
            said = log_path.read_text()
            if not any(int(r[0]) == n and int(r[1]) == steps
                       for r in REPLICA_LINE.findall(said)):
                raise AssertionError(f"{key}: no line saying the replicated parameters are "
                                     f"bit-equal on the {n} ranks at step {steps} in "
                                     f"{log_path}")
            log(f"{key}: replicated parameters bit-equal on the {n} ranks after {steps} steps")
        if key == "tp":
            m = TP_LINE.search(said)
            if m is None or int(m.group(1)) != 2:
                raise AssertionError(f"tp: no line saying what each rank holds in {log_path}")
            out[key]["sharded"] = dict(tensors=int(m.group(2)),
                                       sharded_per_rank=int(m.group(3).replace(",", "")),
                                       held_per_rank=int(m.group(4).replace(",", "")))
            log(f"tp: each rank holds {out[key]['sharded']['held_per_rank']:,} parameters, "
                f"{out[key]['sharded']['sharded_per_rank']:,} of them its shards of "
                f"{m.group(2)} tensors")
    return out


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
                            grad_clamp: float = -1.0, mesh=None):
    """``fused_joint_outputs`` in plain PyTorch under autograd, rounded where
    K1 and K2 round and nowhere else: the bf16 sum before tanh and h in the
    forward, dl (the logits' cotangent) in bf16 for the dh and dW products;
    dh, 1 - h^2 (of the rounded h) and every sum in float32.  A whole
    joint only (no mesh)."""
    if grad_clamp > 0 or mesh is not None:
        raise ValueError("the reference joint takes no gradient clamp and no mesh")
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


# Device kernels grouped by what they belong to, first match wins: the
# hand-written kernels by function name, cuDNN's convolutions by theirs.
TRACE_GROUPS = (("K1", r"gemm_kernel<[^>]*LsePass>|::fwd_h_kernel\("),
                ("K2", r"gemm_kernel<[^>]*(DlPass|DhPass|DwPass)>|::h_kernel\("),
                ("K3", r"alpha_sweep<\d+, *(false|\(bool\)0)>"),
                ("K4", r"beta_sweep<\d+, *(false|\(bool\)0)>"),
                ("K5", r"window_gather_kernel"), ("K6/K7", r"_sweep<\d+, *(true|\(bool\)1)>"),
                ("convolutions", r"(?i)conv|cudnn|fprop|dgrad|wgrad"))


def busy_us(kernels) -> float:
    """Microseconds in which at least one of the profiler's device events
    ``kernels`` ran (their union)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        return 0.0
    total, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + cur_e - cur_s


def report_trace(prof, wall_s: float, what: str, out: Path, top: int = 15,
                 kind=torch.autograd.DeviceType.CUDA, per: int = 1,
                 per_what: str = "trace") -> float:
    """Print the device time by kernel (events of ``kind``), by group
    (TRACE_GROUPS) divided by ``per`` (the steps or batches traced), and the
    device's busy and idle share of ``wall_s``; write the gzipped Chrome
    trace to ``out``.gz.  Returns the idle share in percent."""
    kernels = [e for e in prof.events() if e.device_type == kind]
    if not kernels:
        raise AssertionError("the profiler saw no device activity")
    busy = busy_us(kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    idle = 100 - busy / 1e4 / wall_s
    log(f"profile: {what}, {wall_s:.3f} s wall (traced), {len(kernels)} kernels, "
        f"device busy {busy / 1e3:.2f} ms = {busy / 1e4 / wall_s:.1f} % of wall, "
        f"idle {idle:.1f} %")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:110]}")
    groups: dict[str, list] = {}
    for name, (us, n) in by_name.items():
        g = next((k for k, pat in TRACE_GROUPS if re.search(pat, name)), "other")
        acc = groups.setdefault(g, [0.0, 0])
        acc[0] += us
        acc[1] += n
    log(f"  by group, per {per_what} (device ms, launches): " + ", ".join(
        f"{g} {us / 1e3 / per:.3f} ms {n / per:.0f}x"
        for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
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
                 out_dir / "eval_trace.json", per=len(batches), per_what="batch")


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
                 kind=kind, per=steps, per_what="step")


def multi_card_main(cards: int, smi: str, cases: tuple | None = None) -> None:
    """``--cards N``: the multi-rank layer across N cards of this machine,
    one rank per card over NCCL; prints a ``{"multi_card": ...}`` line.
    With ``cases``, only those multi-rank cases run (no kernel checks on
    the other cards, no transport costs)."""
    if torch.cuda.device_count() < cards or cards < 2:
        sys.exit(f"chip_smoke: --cards {cards} needs 2 or more cards, this machine has "
                 f"{torch.cuda.device_count()}")
    from rnnt_tpu_torch.data.dataset import synthetic_piece_table

    t0 = time.time()
    for card in range(1, cards) if cases is None else ():
        other_card_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "train_vocab.json"
        vocab.write_text(json.dumps(synthetic_piece_table()))
        train = dict(config="base_convjs", overrides=list(TRAIN_OVERRIDES), vocab=vocab)
        ranks = multi_rank_phase(Path(tmp), torch.device("cuda"), train, cards=cards,
                                 **({} if cases is None else {"cases": cases}))
        exchange = (exchange_phase(Path(tmp), flagship_params(train), ranks=cards,
                                   backend="nccl") if cases is None else None)
    log(f"total {time.time() - t0:.1f} s")
    print(smi.strip())
    print(json.dumps({"multi_card": dict(
        exchange=exchange, **{key: dict(gaps=r["gaps"], eval_launches=r["eval_launches"],
                                        steps=[{k: s[k] for k in ("step", "loss", "grad_norm",
                                                                  "seconds", "by_rank")}
                                               for s in r["steps2"]])
                              for key, r in ranks.items()})}))


def main() -> None:
    ap = argparse.ArgumentParser(description="PyTorch port smoke run on one card")
    ap.add_argument("--exchange", metavar="N_GRAD", type=int, default=None,
                    help=argparse.SUPPRESS)  # one rank of exchange_phase
    ap.add_argument("--exchange-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--exchange-tp", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cards", type=int, default=None,
                    help="instead of the one-card run: the multi-rank layer on N cards "
                         "of this machine, one rank per card over NCCL (K1-K7 on each "
                         "other card, the T-sharded and data-parallel steps against 1 "
                         "rank, NCCL's transport costs)")
    ap.add_argument("--cases", default=None,
                    help="with --cards: only these multi-rank cases, comma-separated "
                         "(tshard, data_parallel, tp, tp_pruned, bn)")
    ap.add_argument("--parent-lattice", metavar="DIR", type=Path, default=None,
                    help="also build alpha_fwd.cu, beta_bwd.cu, alpha_chain.cu and "
                         "beta_chain.cu of another tree from DIR (with its headers) and "
                         "time them in turns with this tree's K3, K4, K6 and K7")
    ap.add_argument("--parent-joint", metavar="DIR", type=Path, action="append", default=[],
                    help="also build joint_fwd.cu of another tree from DIR (with its "
                         "headers; repeatable) and time it in turns with this tree's K1")
    ap.add_argument("--profile", metavar="DIR", type=Path, default=None,
                    help="also trace two eval batches, five serving pumps and three "
                         "train steps with torch.profiler, print device time by kernel "
                         "and the idle share, and write DIR/*_trace.json.gz")
    args = ap.parse_args()
    if args.exchange is not None:
        sys.path.insert(0, str(REPO))
        return exchange_worker(args.exchange, args.exchange_backend, args.exchange_tp)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs an NVIDIA card")
    if not (REPO / "rnnt_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(rnnt_tpu_torch/ is missing)")
    sys.path.insert(0, str(REPO))
    from rnnt_tpu_torch.config.config import (
        build_featurizer_spec, load_config, resolve_config)
    from rnnt_tpu_torch.data.dataset import synthetic_piece_table
    from rnnt_tpu_torch.ops.kernels import build_all
    from rnnt_tpu_torch.ops.lattice_pallas import K3, K4, K6, K7
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
    secs = build_all(kernels + [K6, K7])  # once, before any rank starts
    log(f"built {[k.name for k in kernels + [K6, K7]]} in {secs:.1f} s")
    for k in kernels + [K6, K7]:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  {k.name}: {line.strip()}")
    if args.cards is not None:
        return multi_card_main(args.cards, smi,
                               tuple(args.cases.split(",")) if args.cases else None)

    # The flagship bucket the synthetic 10 s utterances land in: 1024 frames.
    L = build_featurizer_spec(load_config(resolve_config("base_convjs"))).samples_for_frames(1024)
    measured = kernel_phase(device)
    measured.update(train_kernel_phase(device))
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "tp_vocab.json"
        vocab.write_text(json.dumps(synthetic_piece_table()))
        tp_joint = {k: v for k, v in tp_lattice(vocab).items() if k != "C"}
    # scaled_tp's joint on its 2 model ranks: the kernel phase's wide shape,
    # the banded loss's patches at H 2048, and the tp case's own lattice.
    slices = slice_phase(device, (("wide", K1_WIDE), ("banded", dict(BANDED_SHAPE, H=2048)),
                                  ("tp", tp_joint)))
    chain = chain_kernel_phase(device)
    if args.parent_lattice is not None:
        other = parent_lattice_phase(device, args.parent_lattice.resolve())
        for key in ("k3", "k4"):
            measured[key.upper()]["other_tree"] = {
                t: {f"{key}_ms": other[t][f"other_{key}"],
                    f"this_{key}_ms": other[t][f"this_{key}"]} for t in ("eval", "long")}
        for tag, shards in other["chain"].items():
            chain[tag]["other_tree"] = [
                {k: m[k] for k in ("t0", "rows", "other_k6", "this_k6", "other_k7", "this_k7")}
                for m in shards]
    if args.parent_joint:
        other = parent_joint_phase(device, [d.resolve() for d in args.parent_joint])
        measured["K1"]["other_tree"] = other
    measured["K5"] = k5_phase(device, L)
    augment = augment_phase(device, K5, L)
    with tempfile.TemporaryDirectory() as tmp:
        path = path_phase(Path(tmp), device, [K1, K3])
        if args.profile is not None:
            profile_phase(path["cfg"], path["model"], device, args.profile)
        del path["model"]
        serve = serve_phase(Path(tmp), device, kernels + [K6, K7], args.profile)
        decode = decode_phase(Path(tmp), device, kernels + [K6, K7],
                              measured["K3"]["lse_step_ns"])
        decode["lstm"] = lstm_phase(Path(tmp), device, kernels + [K6, K7])
        train = train_phase(Path(tmp), device, kernels)
        grad_phase(device, kernels, train)
        ranks = multi_rank_phase(Path(tmp), device, train)
        ranks["exchange"] = exchange_phase(Path(tmp), flagship_params(train),
                                           tp=tp_dims(train["vocab"]))
        if args.profile is not None:
            profile_train_phase(device, train, args.profile)
            profile_train_phase(device, train, args.profile, device_augment="full")

    entries = []
    for key, k in (("K1", K1), ("K2", K2), ("K3", K3), ("K4", K4), ("K5", K5)):
        m = measured[key]
        extra = {c: m[c] for c in ("long_case", "banded_case", "wide_case", "cases",
                                   "passes_ms", "gemm_ms", "tflops", "device_ms",
                                   "critical_path_ms", "lse_step_ns", "other_tree",
                                   "k1_k2_softmax_gap")
                 if c in m}
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
                          else "no single PyTorch call computes this function"
                          + (f"; {m['gemm_note']}" if "gemm_note" in m else "")),
            shape=m["shape"], **extra))
    entries[-1]["augment_call"] = augment
    for e, k in zip(entries[:2], ("k1", "k2")):
        e["slice_cases"] = {tag: dict(
            shape=c["shape"], parts=c["parts"],
            slices=[dict(v0=m["v0"], **m[k]) for m in c["slices"]],
            merged=(dict(max_abs_err=c["k1_merged_max_abs_err"]) if k == "k1"
                    else dict(rel_l2=c["k2_merged_rel_l2"]))) for tag, c in slices.items()}
        for case in ("tp", "tp_pruned"):
            e["launches_per_step"][f"{case} (per rank)"] = [
                st["by_rank"][e["name"].split()[1]] for st in ranks[case]["steps2"]]
    for e in entries[2:4]:
        e["tp_lattice_case"] = dict(shape=slices["tp"]["lattice"]["shape"], max_abs_err=(
            slices["tp"]["lattice"][f"{e['name'][:2].lower()}_max_abs_err"]))
        for case in ("tp", "tp_pruned"):
            e["launches_per_step"][f"{case} (per rank)"] = [
                st["by_rank"][e["name"].split()[1]] for st in ranks[case]["steps2"]]
    rs = decode["rescore"]
    next(e for e in entries if e["name"].startswith("K3"))["rescore_case"] = dict(
        shape="B*C={} T={} U1={}".format(*rs["lattice"]), device_ms=rs["k3_device_ms"],
        bound_ms=rs["k3_bound_ms"], bound_by=rs["k3_bound_by"],
        critical_path_ms=rs["k3_critical_path_ms"], plain_ms=rs["plain_alpha_ms"],
        launches=rs["launches"]["alpha_fwd"], max_rel_err=rs["max_rel_err"])
    tsteps = ranks["tshard"]["steps2"]
    for key, k, plain in (("K6", K6, "k6"), ("K7", K7, "k7")):
        ev, lg = chain["eval"], chain["long"]
        by_rank = [s["by_rank"][k.name] for s in tsteps]
        entries.append(dict(
            name=f"{key} {k.name}", route="cuda", source=f"rnnt_tpu_torch/csrc/{k.name}.cu",
            replaces=k.replaces, launches=sum(map(sum, by_rank)),
            launches_per_step={"tshard (per rank)": by_rank},
            max_abs_err=max(ev[f"err{key[1]}"], lg[f"err{key[1]}"]),
            ms=statistics.mean(m[f"{plain}_ms"] for m in ev["shards"]),
            plain_ms=statistics.mean(m[f"{plain}_plain_ms"] for m in ev["shards"]),
            bound_ms=statistics.mean(m[f"{plain}_bound_ms"] for m in ev["shards"]),
            bound_by=ev["shards"][0][f"{plain}_bound_by"], library_ms=None,
            library_note="no single PyTorch call computes this function",
            burst_ms=statistics.mean(m[f"{plain}_burst_ms"] for m in ev["shards"]),
            device_ms=statistics.mean(m[f"{plain}_device_ms"] for m in ev["shards"]),
            critical_path_ms=statistics.mean(m[f"{plain}_path_ms"] for m in ev["shards"]),
            lse_step_ns=ev["lse_step_ns"],
            shape=ev["shape"] + "; ms (events), burst_ms, device_ms, plain_ms, bound_ms and "
                  "critical_path_ms are means over the shards",
            shards={tag: c["shards"] for tag, c in chain.items()},
            chain={tag: c["chain"] for tag, c in chain.items()}, long_case=lg["shape"],
            **({"other_tree": {tag: [{k: m[k] for k in ("t0", "rows", f"other_{plain}",
                                                          f"this_{plain}")}
                                     for m in c["other_tree"]] for tag, c in chain.items()}}
               if "other_tree" in ev else {})))
    multi = {key: dict(gaps=r["gaps"], seconds=r["seconds"], eval_launches=r["eval_launches"],
                       seconds_one_rank=r["seconds_one_rank"],
                       steps=[{k: s[k] for k in ("step", "loss", "grad_norm", "seconds")}
                              for s in r["steps2"]],
                       steps_one_rank=[{k: s[k] for k in ("step", "loss", "grad_norm",
                                                          "seconds")} for s in r["steps1"]],
                       **({"sharded": r["sharded"]} if "sharded" in r else {}))
             for key, r in ranks.items() if key != "exchange"}
    multi["exchange"] = ranks["exchange"]
    log(f"total {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"multi_rank": multi}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"decode": decode}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
