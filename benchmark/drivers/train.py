"""Training: the port's ``make_train_step`` over batches gathered from its
on-card corpus cache (``data/device_cache.py``), with TF32 off as
``cli.train`` sets it, no dropout and no augmentation (the step is called
without a generator).

The configuration's architecture (``core.Cell.architecture``) gives the
plain reference (``benchmark/reference/<arch>.py``: frames, encoder
lengths and each row's NLL) and the operation count
(``benchmark/cost/<arch>.py``).  Set-up builds the one train state, caches
``cache_rows`` utterances of the mix on the card, and drives the state
through its first ``check_steps`` steps by the window's own call over the
first batches of the first epoch (rows all different); those steps also
warm every shape up.  The window goes on with the same state.  The
reference follows the check steps from the same weights and rows: each
step's loss, the first gradient as the optimizer took it (its first moment
after one step over 1 - beta1), and the parameters' change over the check
steps, each of the last two by the worst leaf: the gap of the leaf's norms
over the larger of the reference's norm of that leaf and of the median
leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's (biases
that a following instance norm cancels) move by rounding only and are
left out of both.

The window records each step's rows, so that the per-layer readers can
count the work the traced steps' lattices need, and the flops and
seconds after the trace stopped (``mfu.train``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import port, workload
from benchmark.reference.common import adamw_step, strict_fp32


def setup(run):
    from rnnt_tpu_torch.config.config import build_featurizer_spec, build_model_spec
    from rnnt_tpu_torch.data.device_cache import DeviceSampleCache, make_cached_train_step
    from rnnt_tpu_torch.ops.kernels import launch_counts
    from rnnt_tpu_torch.train.optim import make_optimizer
    from rnnt_tpu_torch.train.step import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix, conf, dev = run.cell.mix, run.cell.conf, run.device
    ref, cost = run.cell.architecture("reference"), run.cell.architecture("cost")
    B = mix["batch"]
    cfg = port.load_config(conf, [f"training.global_batch_size={B}"])
    tc = cfg.training
    model, weights = port.build_model(cfg, run.seed, dev)
    spec, fspec = build_model_spec(cfg), build_featurizer_spec(cfg)
    optimizer, _ = make_optimizer(tc, tc.lr_schedule.total_steps)
    state = TrainState(model, optimizer.init(dict(model.named_parameters())))
    step = make_cached_train_step(make_train_step(spec, fspec, optimizer, tc.precision))

    g = torch.Generator(device=dev).manual_seed(run.seed + 1)
    fz = conf["model"]["featurizer"]
    S = workload.samples_for_frames(mix["frame_bucket"], fz)
    U = mix["token_bucket"]
    lens, counts = workload.utterances(mix, mix["cache_rows"], run.seed)
    group = {"audio": workload.wire_audio(lens, S, g, dev),
             "audio_lens": torch.as_tensor(lens, dtype=torch.int32, device=dev),
             "targets": workload.transcripts(counts, U, conf["model"]["num_text_tokens"], g, dev),
             "target_lens": torch.as_tensor(counts, dtype=torch.int32, device=dev)}
    cache = DeviceSampleCache([group], [lens.astype(np.int32)])
    frames = ref.num_frames(lens, fz)
    flops = np.array([cost.train_step_flops(conf["model"], [f], [u])
                      for f, u in zip(frames, counts)])
    # Each row's unpadded lattice (t, u + 1): the work K1 and K2 need.
    run.values["row_t"] = ref.encoder_out_len(frames, conf["model"]).astype(np.int64)
    run.values["row_u1"] = counts.astype(np.int64) + 1

    def batches():
        epoch = 0
        while True:
            yield from cache.epoch_batches(B, seed=(run.seed * 1009 + epoch) % 2 ** 32)
            epoch += 1

    it = batches()
    K = mix["check_steps"]
    rows, losses, grad_norms, b1 = [], [], None, conf["model"]["training"]["optimizer"]["betas"][0]
    for k in range(K):
        gi, idx = next(it)
        rows.append(idx)
        state, metrics = step(state, cache.groups[gi], idx, None)
        losses.append(metrics["loss"])
        if k == 0:
            grad_norms = {n: torch.linalg.vector_norm(m / (1 - b1))
                          for n, m in state.opt_state.mu.items()}
    with torch.no_grad():
        change = {n: torch.linalg.vector_norm(p.float() - weights[n])
                  for n, p in model.named_parameters()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"state": state, "step": step, "cache": cache, "it": it, "weights": weights,
            "ref": ref, "rows": rows, "losses": [float(x) for x in losses],
            "grad_norms": {n: float(v) for n, v in grad_norms.items()},
            "change": {n: float(v) for n, v in change.items()},
            "flops": flops, "launch_counts": launch_counts}


def window(run, st):
    cache, step, it = st["cache"], st["step"], st["it"]
    state, flops = st["state"], st["flops"]
    c = run.counters
    c.update(steps=0, audio_s=0.0, flops=0.0)
    batches = run.values["batches"] = []
    kc = st["launch_counts"]
    run.window_started()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        gi, idx = next(it)
        with run.span("train step"):
            state, _ = step(state, cache.groups[gi], idx, None)
        c["steps"] += 1
        batches.append(idx)
        c["audio_s"] += cache.batch_audio_seconds(gi, idx)
        c["flops"] += float(flops[idx].sum())
        for name, n in kc().items():
            c[f"launches.{name}"] = n
        run.tick()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    end = time.perf_counter()
    elapsed = end - t0
    run.values["train_audio_per_s"] = c["audio_s"] / elapsed
    untraced = run.untraced("flops", end)
    if untraced is not None:
        run.values["untraced_flops"], run.values["untraced_s"] = untraced
    st["state"] = state
    print(f"train: {c['steps']} steps, {c['audio_s']:.1f} audio-s in {elapsed:.3f} s",
          file=__import__("sys").stderr)


def reference_steps(run, st, quant=None):
    """The reference's losses, first clipped gradient and change over the
    check steps (float32, TF32 off; ``quant`` rounds its products)."""
    conf, mix, ref = run.cell.conf, run.cell.mix, st["ref"]
    model = conf["model"]
    tr = model["training"]
    opt = {"lr": tr["optimizer"]["lr"], "b1": tr["optimizer"]["betas"][0],
           "b2": tr["optimizer"]["betas"][1], "eps": tr["optimizer"]["eps"],
           "weight_decay": tr["optimizer"]["weight_decay"], "clip": tr["clip_grad_norm"],
           "warmup_steps": tr["lr_schedule"]["warmup_steps"],
           "min_lr_ratio": tr["lr_schedule"]["min_lr_ratio"],
           "total_steps": tr["lr_schedule"]["total_steps"]}
    P = {n: v.clone().requires_grad_(True) for n, v in st["weights"].items()}
    p0 = {n: v.detach().clone() for n, v in P.items()}
    group = st["rows_data"]
    B = mix["batch"]
    block = mix.get("reference_rows", 8)
    state = {"count": 0, "mu": {}, "nu": {}}
    names = [n for n in P if not (n.endswith(".mean") or n.endswith(".var"))]
    losses, first = [], None
    for k in range(len(st["rows"])):
        grads = {n: torch.zeros_like(P[n]) for n in names}
        total = 0.0
        for s in range(0, B, block):
            rows = slice(k * B + s, k * B + min(s + block, B))
            wave = group["audio"][rows].float() / workload.WIRE_SCALE
            loss = ref.rows_nll(P, model, wave, group["audio_lens"][rows].long(),
                                group["targets"][rows], group["target_lens"][rows].long(),
                                quant).sum() / B
            gs = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
            for n, gr in zip(names, gs):
                if gr is not None:
                    grads[n] += gr
            total += float(loss.detach())
        losses.append(total)
        params = {n: P[n].data for n in names}
        clipped = adamw_step(params, grads, state, opt)
        if k == 0:
            first = {n: float(torch.linalg.vector_norm(clipped[n])) for n in names}
            raw = {n: float(torch.linalg.vector_norm(grads[n])) for n in names}
    change = {n: float(torch.linalg.vector_norm(P[n].detach() - p0[n])) for n in names}
    return {"losses": losses, "grad_norms": first, "raw_grad_norms": raw, "change": change}


def leaf_gaps(prog: dict, refv: dict, keep, floor: bool = True) -> dict:
    """Each kept leaf's gap of norms over the reference's norm of that leaf
    or, with ``floor``, of the median leaf where that is larger."""
    med = float(np.median([refv[n] for n in keep])) if floor else 0.0
    return {n: abs(prog[n] - refv[n]) / max(refv[n], med) for n in keep}


def compare(prog: dict, refr: dict) -> dict:
    """The compared numbers: the losses' gap; the gradient's and the
    change's worst leaf, over the larger of its reference norm and the
    median leaf's (``*_gap``) and over its own reference norm alone
    (``*_gap_own``, which a small leaf far off cannot pass); and, for the
    look, the name of the leaf that sets each ``*_gap_own``."""
    raw = refr["raw_grad_norms"]
    med = float(np.median(list(raw.values())))
    keep = [n for n in raw if raw[n] >= 1e-3 * med]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"]))}
    for key, norms in (("grad", "grad_norms"), ("change", "change")):
        out[f"{key}_gap"] = max(leaf_gaps(prog[norms], refr[norms], keep).values())
        own = leaf_gaps(prog[norms], refr[norms], keep, floor=False)
        worst = max(own, key=own.get)
        out[f"{key}_gap_own"], out[f"{key}_leaf_own"] = own[worst], worst
    return out


def keep_rows(st) -> None:
    """Copy the check steps' rows out of the cache, then free the program."""
    g = st["cache"].groups[0]
    idx = torch.as_tensor(np.concatenate(st["rows"]), device=g["audio"].device).long()
    st["rows_data"] = {k: v.index_select(0, idx) for k, v in g.items()}
    for k in ("state", "step", "cache", "it"):
        st.pop(k, None)


def check(run, st):
    keep_rows(st)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    with strict_fp32():
        st["reference"] = reference_steps(run, st)
    return compare(st, st["reference"]), run.counters["steps"], 0


def control(run, st, quant="fp8"):
    """The control's readings: the reference computed with ``quant``
    products, in the program's place."""
    with strict_fp32():
        return compare(reference_steps(run, st, quant), st["reference"])
