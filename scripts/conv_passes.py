#!/usr/bin/env python3
"""Time each convolution of a training step pass by pass, as one
``F.conv1d`` and as the port runs it, and name the kernels each pass runs.

    python3 scripts/conv_passes.py [--config base_convjs] [--batch 32]
        [--frames 1024] [--tokens 65] [--dtype bf16] [--reps 20] [--json PATH]

Every distinct convolution of the config's encoder (and its predictor's
two) is built at the shapes one training step gives it: batch ``--batch``
in the ``--frames`` bucket, the targets padded to ``--tokens``, encoder
activations in ``--dtype`` (a training step's bf16; fp32 is the streaming
pool's and the bundles' dtype; the predictor's are always float32),
float32 weights cast in the call, TF32 off as ``cli.train`` sets it.  For
each it times three passes with CUDA events (median of ``--reps``): the
forward, the input gradient and the weight gradient (each
``torch.autograd.grad`` of the forward's graph for x or for w and b
alone, so that each launches its own cuDNN call), and names the kernels
of each pass with their device ms (torch.profiler).  The prologue's input
needs no gradient in training (it is the featurizer's output), so its
input-gradient row is not part of a step.

Variants: ``direct`` is one ``F.conv1d`` with the conv's stride and
dilation; ``port`` is ``ops/causal_conv.py`` ``conv1d_valid``.  Every
printed table and every ``--json`` row names the card and its power
limit.  Runs only on a CUDA card: anywhere else it exits with status 2.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rnnt_tpu_torch.config.config import build_model_spec, load_config, resolve_config  # noqa: E402
from rnnt_tpu_torch.ops.causal_conv import ConvSpec, causal_conv_out_len, conv1d_valid  # noqa: E402


def direct(w, b, x, cs):
    """One F.conv1d with the stride and dilation."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0).to(x.dtype),
                 stride=cs.stride, dilation=cs.dilation)
    return (y + b.to(y.dtype)[:, None]).transpose(1, 2)


def port(w, b, x, cs):
    return conv1d_valid(w, b, x, cs.stride, cs.dilation)


VARIANTS = {"direct": direct, "port": port}


def time_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` between two CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def kernels(fn, reps: int = 3) -> dict[str, float]:
    """{kernel: device ms a call} over ``reps`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then reports no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        if out:
            return {k: v / reps / 1e3 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}
    return {"(no device events in 3 sessions)": 0.0}


def convs(spec, frames, tokens):
    """(layer, ConvSpec, unpadded input length, needs input grad, count)
    of one training step, equal shapes merged."""
    rows, T = [], frames
    enc = spec.encoder
    named = [("prologue", enc.prologue_spec)]
    for i, blk in enumerate(enc.blocks):
        named += [(f"block{i + 1}.{j}", blk.conv_spec(j)) for j in range(blk.num_sub_blocks)]
    named.append(("epilogue", enc.epilogue_spec))
    for name, cs in named:
        L = T + cs.left_padding
        rows.append([name, cs, L, name != "prologue", 1])
        T = causal_conv_out_len(T, cs)
    if getattr(spec.predictor, "conv1_spec", None) is not None:
        for name, cs in (("predictor.conv1", spec.predictor.conv1_spec),
                         ("predictor.conv2", spec.predictor.conv2_spec)):
            rows.append([name, cs, tokens + cs.left_padding, True, 1])
    merged = []
    for r in rows:
        same = [m for m in merged if m[1] == r[1] and m[2] == r[2]]
        if same:
            same[0][0] += f", {r[0]}"
            same[0][4] += 1
        else:
            merged.append(r)
    return merged


def flops(cs: ConvSpec, B: int, L: int) -> float:
    out = (L - cs.dilation * (cs.kernel_size - 1) - 1) // cs.stride + 1
    return 2.0 * B * out * cs.in_channels * cs.out_channels * cs.kernel_size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="base_convjs")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--tokens", type=int, default=65, help="the predictor's U + 1")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="the encoder activations' dtype")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_passes.py times cuDNN's kernels on a CUDA card; none is "
              "visible here", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().replace("\n", "; ")
    stack = dict(card=card, device=torch.cuda.get_device_name(dev), torch=torch.__version__,
                 cudnn=torch.backends.cudnn.version())
    print(f"card: {card}; torch {stack['torch']}, cuDNN {stack['cudnn']}; "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}")
    spec = build_model_spec(load_config(resolve_config(args.config)))
    B = args.batch
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    print(f"{args.config}, batch {B}, {args.frames} frames, {args.dtype}")
    print("| layer | convs | (Cin, Cout, K, s, d) | L | variant | pass | ms | TFLOP/s | kernels (device ms a call) |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for name, cs, L, needs_dx, count in convs(spec, args.frames, args.tokens):
        bound = 1.0 / math.sqrt(cs.in_channels * cs.kernel_size)
        w = ((torch.rand(cs.kernel_size, cs.in_channels, cs.out_channels, generator=g,
                         device=dev) * 2 - 1) * bound).requires_grad_()
        b = ((torch.rand(cs.out_channels, generator=g, device=dev) * 2 - 1) * bound).requires_grad_()
        # The predictor's convs run in float32 in a step (its embedding's dtype).
        bf16 = args.dtype == "bf16" and not name.startswith("predictor")
        x = torch.randn(B, L, cs.in_channels, generator=g, device=dev).to(
            torch.bfloat16 if bf16 else torch.float32)
        x.requires_grad_()
        ref = None
        for vname, fn in VARIANTS.items():
            y = fn(w, b, x, cs)
            if ref is None:
                ref = y.detach().float()
            gap = float((y.detach().float() - ref).abs().max() / ref.abs().max())
            gy = torch.randn(y.shape, generator=g, device=dev).to(y.dtype)
            passes = {
                "forward": lambda: fn(w, b, x, cs),
                "input grad": lambda: torch.autograd.grad(y, x, gy, retain_graph=True),
                "weight grad": lambda: torch.autograd.grad(y, (w, b), gy, retain_graph=True),
            }
            for pname, p in passes.items():
                ms = time_ms(p, args.reps)
                ks = kernels(p)
                tflops = flops(cs, B, L) / ms / 1e9
                row = dict(stack, config=args.config, batch=B, dtype=args.dtype, layer=name,
                           convs=count, spec=list(cs[:5]), L=L, variant=vname, passname=pname,
                           ms=ms, tflops=tflops, in_step=needs_dx or pname != "input grad",
                           rel_gap=gap, kernels=ks)
                out.append(row)
                top = "; ".join(f"{k[:70]} {v:.4f}" for k, v in list(ks.items())[:3])
                tag = vname if vname == "direct" else f"{vname} (gap {gap:.1e})"
                print(f"| {name} | {count} | {tuple(cs[:5])} | {L} | {tag} | {pname}"
                      f"{'' if row['in_step'] else ' (not in a step)'} | {ms:.4f} | "
                      f"{tflops:.1f} | {top} |", flush=True)
            del y
    step = {}
    for r in out:
        if r["in_step"]:
            key = (r["layer"], r["variant"])
            step[key] = step.get(key, 0.0) + r["ms"] * r["convs"]
    print(f"ms a step by layer and variant (sum of its passes x its convs; {card}):")
    for (layer, variant), ms in step.items():
        print(f"  {layer} [{variant}]: {ms:.3f}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
