#!/usr/bin/env python3
"""Prove that the PyTorch port runs on one NVIDIA card (H100, sm_90a).

Run ``python3 chip_smoke.py`` (no arguments) from the repository root:

1. print the card (``nvidia-smi`` name and power limit) and stop with a
   nonzero exit when CUDA is missing;
2. build the hand-written kernels from ``rnnt_tpu_torch/csrc`` with nvcc,
   one process per source, all started together;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the eval path's shapes (and K3 at a long-label shape), with the
   tolerances stated below, timed with CUDA events (median after warm-up)
   beside the least time the card could take;
4. path phase: the full-width ``base_convjs`` model (random weights from a
   seed, ``training.loss_impl=auto``, synthetic 10 s utterances, an in-code
   1023-piece vocabulary) through ``rnnt_tpu_torch.cli.eval.main`` and
   ``rnnt_tpu_torch.train.loop.evaluate``; the kernels' launch counts are
   set to 0 before and read after; one batch's NLL is recomputed through
   the plain path and must agree;
5. print a ``{"kernels": [...]}`` line, then, last, the ``{"ok": true, ...}``
   line.

``--profile DIR`` adds, after the path phase, a torch.profiler trace of
two eval batches: device time by kernel, the card's busy and idle share,
and ``DIR/eval_trace.json.gz``.

Every check raises on failure, so a failed phase exits nonzero before the
last line.  float32 matmuls and cuDNN convs run without TF32 here (both
``allow_tf32`` flags are set False) so that fp32 comparisons mean fp32.
"""

from __future__ import annotations

import argparse
import gzip
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

EVAL_SHAPE = dict(B=4, T=504, U1=65, H=1024, V=1024)
K3_LONG = dict(B=4, T=1000, U1=257)


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


def kernel_phase(device, shape=EVAL_SHAPE, long_case=K3_LONG, reps=20) -> dict:
    from rnnt_tpu_torch.ops.lattice_pallas import alpha_forward, alpha_plain
    from rnnt_tpu_torch.ops.transducer_pallas import (
        fused_joint_outputs, fused_joint_outputs_plain)

    out = {}
    args = k1_inputs(**shape, device=device)
    got = fused_joint_outputs(*args)
    want = fused_joint_outputs_plain(*args)
    err = max(check_close(f"K1 {n}", g, w, **K1_TOL)
              for n, g, w in zip(("lse", "blank", "label"), got, want))
    out["K1"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: fused_joint_outputs(*args), reps),
        plain_ms=cuda_ms(lambda: fused_joint_outputs_plain(*args), 3, warmup=1),
        bound_ms=k1_bound_ms(**shape), bound_by="operations",
        shape="B={B} T={T} U1={U1} H={H} V={V}".format(**shape))
    del args, got, want
    log(f"K1 ok: max abs err {err:.3e}, {out['K1']['ms']:.4f} ms "
        f"(plain {out['K1']['plain_ms']:.4f} ms, bound {out['K1']['bound_ms']:.4f} ms)")

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
        audio, text = rnnt_forward(model, feats, sb["targets"])
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


def profile_phase(cfg, model, device, out_dir: Path, top: int = 15,
                  kind=torch.autograd.DeviceType.CUDA) -> None:
    """Trace one ``evaluate`` pass over 2 batches with torch.profiler: print
    the device time by kernel (events of ``kind``), the device's busy and
    idle share of the traced wall time, and write the Chrome trace to
    ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from rnnt_tpu_torch.train import loop

    tokenizer = loop._load_tokenizer(cfg)
    batches = list(loop.eval_batches(cfg, tokenizer, batch_size=4, max_batches=2))
    loop.evaluate(cfg, model, device=device, batches=batches[:1])  # warm-up
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        res = loop.evaluate(cfg, model, device=device, batches=batches)
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
    wall_s = res["seconds"]
    log(f"profile: {len(batches)} batches, {wall_s:.3f} s wall (traced; exact loss "
        f"{res['loss_seconds']:.3f} s, forward + greedy decode "
        f"{res['decode_seconds']:.3f} s), {len(kernels)} kernels, device busy "
        f"{busy_us / 1e3:.2f} ms = {busy_us / 1e4 / wall_s:.1f} % of wall, idle "
        f"{100 - busy_us / 1e4 / wall_s:.1f} %")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:110]}")
    out_dir.mkdir(parents=True, exist_ok=True)
    raw = out_dir / "eval_trace.json"
    prof.export_chrome_trace(str(raw))
    with open(raw, "rb") as src, gzip.open(f"{raw}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    raw.unlink()
    log(f"trace written to {raw}.gz")


def main() -> None:
    ap = argparse.ArgumentParser(description="PyTorch port smoke run on one card")
    ap.add_argument("--profile", metavar="DIR", type=Path, default=None,
                    help="also trace two eval batches with torch.profiler, print "
                         "device time by kernel and the idle share, and write "
                         "DIR/eval_trace.json.gz")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs an NVIDIA card")
    if not (REPO / "rnnt_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(rnnt_tpu_torch/ is missing)")
    sys.path.insert(0, str(REPO))
    from rnnt_tpu_torch.ops.kernels import build_all
    from rnnt_tpu_torch.ops.lattice_pallas import K3
    from rnnt_tpu_torch.ops.transducer_pallas import K1

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
    kernels = [K1, K3]
    secs = build_all(kernels)
    log(f"built {[k.name for k in kernels]} in {secs:.1f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    measured = kernel_phase(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = path_phase(Path(tmp), device, kernels)
        if args.profile is not None:
            profile_phase(path["cfg"], path["model"], device, args.profile)

    entries = []
    for key, k in (("K1", K1), ("K3", K3)):
        m = measured[key]
        entries.append(dict(
            name=f"{key} {k.name}", route="cuda",
            source=f"rnnt_tpu_torch/csrc/{k.name}.cu", replaces=k.replaces,
            launches=path["launches"][k.name], max_abs_err=m["max_abs_err"],
            ms=m["ms"], kernel_ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=None,
            library_note="no single PyTorch call computes this function",
            shape=m["shape"], **({"long_case": m["long_case"]} if "long_case" in m else {})))
    log(f"total {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
