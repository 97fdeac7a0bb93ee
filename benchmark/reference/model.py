"""Plain float32 reference of the Jasper-encoder / conv-predictor RNN-T.

It reads the configuration's ``model`` block (``benchmark/configs``) and a
dict of parameters by their dotted names, and computes:

* ``featurize``: frames of ``n_fft`` samples every ``hop`` samples, a
  periodic Hann window, the power of the real FFT, and the configured log
  compression (``spectrogram``: log above 0.01 and the continuing line of
  slope 50 below; ``old_piecewise``: the power times 32767^2, log above e
  and divided by e below), then ``(x - mean) * invstddev``;
* ``encoder``: causal convolutions (left pad ``(k-1)d - s + 1`` less the
  block's lookahead), norms over the time axis (instance, padding
  included) or by running statistics (batch), exact GELU, a 1x1 residual
  added before each block's last activation and cut to its surviving
  frames, a dilated epilogue and a 1x1 output;
* ``predictor``: embedding, layer norm, causal convolutions of 3 and 5,
  GELU, a linear layer and a layer norm over blank-prepended targets;
* ``joint_logits``: ``out(tanh(audio_t + text_u))``, blank the last class;
* ``nll``: the exact transducer NLL by the alpha recursion, one
  anti-diagonal at a time, differentiable by autograd;
* ``adamw_step``: clip by the global norm, then AdamW with bias
  correction by the update count, eps outside the square root, decoupled
  weight decay and the warmup-cosine learning rate.

``quant`` ("bf16" or "fp8") rounds both operands of every product and
convolution to that type and back, everything else staying float32: the
lower-precision controls.  Training-mode batch norm is not modelled (the
training cells' configurations use instance norms), nor dropout or
augmentation, which the benchmark turns off.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG = -1e30
_EPS = 1e-5
_QUANT = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


@contextlib.contextmanager
def strict_fp32():
    """Inside, float32 products run without TF32; the flags the program
    runs with are restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def q(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant is None:
        return x
    if quant == "fp8":
        x = x.clamp(-448.0, 448.0)
    return x.to(_QUANT[quant]).float()


def featurize(wave: torch.Tensor, fz: dict) -> torch.Tensor:
    """wave (B, L) float32 -> (B, frames, n_fft // 2 + 1)."""
    n_fft, hop, win = fz["n_fft"], fz["hop_length"], fz["win_length"]
    frames = wave.unfold(-1, n_fft, hop)
    n = torch.arange(win, device=wave.device, dtype=torch.float64)
    hann = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win))
    window = torch.zeros(n_fft, dtype=torch.float64, device=wave.device)
    left = (n_fft - win) // 2
    window[left:left + win] = hann
    spec = torch.fft.rfft(frames * window.float(), n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    if fz["kind"] == "spectrogram":
        cutoff, slope = 10e-3, 50.0
        feats = torch.where(power > cutoff, torch.log(power.clamp(min=cutoff)),
                            slope * power + (math.log(cutoff) - slope * cutoff))
    elif fz["kind"] == "old_piecewise":
        x = (power + 1e-6) * 32767.0 ** 2
        feats = torch.where(x > math.e, torch.log(x.clamp(min=math.e)), x / math.e)
    else:
        raise ValueError(f"featurizer kind {fz['kind']!r} is not modelled")
    mean = torch.as_tensor(fz["mean"], dtype=torch.float32, device=wave.device)
    inv = torch.as_tensor(fz["invstddev"], dtype=torch.float32, device=wave.device)
    return (feats - mean) * inv


def num_frames(samples, fz: dict):
    return (samples - fz["n_fft"]) // fz["hop_length"] + 1


def conv(x, w, b, k, s=1, d=1, look=0, quant=None):
    """x (B, T, Cin), w (K, Cin, Cout) -> (B, T', Cout), causal."""
    pad = (k - 1) * d - s + 1 - look
    y = F.conv1d(F.pad(q(x, quant).transpose(1, 2), (pad, 0)),
                 q(w, quant).permute(2, 1, 0), stride=s, dilation=d)
    return y.transpose(1, 2) + b


def linear(x, w, b, quant=None):
    return torch.matmul(q(x, quant), q(w, quant)) + b


def norm(x, P, name, kind):
    if kind == "batch":
        y = (x - P[f"{name}.mean"]) / torch.sqrt(P[f"{name}.var"] + _EPS)
        return y * P[f"{name}.scale"] + P[f"{name}.bias"]
    m = x.mean(dim=1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=1, keepdim=True)
    y = (x - m) / torch.sqrt(v + _EPS)
    if kind == "instance_affine":
        y = y * P[f"{name}.scale"] + P[f"{name}.bias"]
    return y


def layer_norm(x, P, name):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + _EPS) * P[f"{name}.scale"] + P[f"{name}.bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def encoder(P, enc: dict, x, quant=None):
    kind = enc["norm_type"]
    p = "encoder.prologue"
    x = gelu(norm(conv(x, P[f"{p}.conv.w"], P[f"{p}.conv.b"], enc["prologue_kernel_size"],
                       enc["prologue_stride"], enc.get("prologue_dilation", 1), quant=quant),
                  P, f"{p}.norm", kind))
    for i, blk in enumerate(enc["blocks"]):
        p = f"encoder.blocks.{i}"
        bkind = blk.get("norm_type") or kind
        res = norm(linear(x, P[f"{p}.residual_conv.w"], P[f"{p}.residual_conv.b"], quant),
                   P, f"{p}.residual_norm", bkind)
        n = blk["num_sub_blocks"]
        for j in range(n):
            x = norm(conv(x, P[f"{p}.convs.{j}.w"], P[f"{p}.convs.{j}.b"], blk["kernel_size"],
                          look=blk.get("additional_context", 0), quant=quant),
                     P, f"{p}.norms.{j}", bkind)
            if j == n - 1:
                x = x + res[:, : x.shape[1]]
            x = gelu(x)
    p = "encoder.epilogue"
    x = gelu(norm(conv(x, P[f"{p}.conv.w"], P[f"{p}.conv.b"], enc["epilogue_kernel_size"],
                       enc.get("epilogue_stride", 1), enc.get("epilogue_dilation", 2),
                       quant=quant), P, f"{p}.norm", kind))
    return linear(x, P["encoder.out.w"], P["encoder.out.b"], quant)


def encoder_out_len(frames, enc: dict):
    def out(n, k, s, d, look):
        return (n + (k - 1) * d - s + 1 - look - d * (k - 1) - 1) // s + 1

    n = out(frames, enc["prologue_kernel_size"], enc["prologue_stride"],
            enc.get("prologue_dilation", 1), 0)
    for blk in enc["blocks"]:
        for _ in range(blk["num_sub_blocks"]):
            n = out(n, blk["kernel_size"], 1, 1, blk.get("additional_context", 0))
    return out(n, enc["epilogue_kernel_size"], enc.get("epilogue_stride", 1),
               enc.get("epilogue_dilation", 2), 0)


def predictor(P, tokens, blank: int, quant=None):
    """tokens (B, U) -> (B, U+1, output_dim) over [blank] + tokens."""
    col = torch.full((tokens.shape[0], 1), blank, dtype=torch.long, device=tokens.device)
    full = torch.cat([col, tokens.long()], dim=1)
    x = layer_norm(P["predictor.embedding"][full], P, "predictor.input_ln")
    x = gelu(conv(x, P["predictor.conv1.w"], P["predictor.conv1.b"], 3, quant=quant))
    x = gelu(conv(x, P["predictor.conv2.w"], P["predictor.conv2.b"], 5, quant=quant))
    x = linear(x, P["predictor.linear.w"], P["predictor.linear.b"], quant)
    return layer_norm(x, P, "predictor.output_ln")


def joint_logits(P, audio, text, quant=None):
    """audio (B, T, H), text (B, U1, H) -> logits (B, T, U1, V)."""
    h = torch.tanh(audio[:, :, None, :] + text[:, None, :, :])
    return linear(h, P["joint.out.w"], P["joint.out.b"], quant)


def lattice_log_probs(logits, targets, blank: int):
    """(lp_blank, lp_label) (B, T, U1): the label column u holds
    targets[u], NEG past the targets."""
    lse = torch.logsumexp(logits, dim=-1)
    B, T, U1, _ = logits.shape
    lab = torch.zeros((B, U1), dtype=torch.long, device=logits.device)
    lab[:, : U1 - 1] = targets[:, : U1 - 1]
    lp_label = logits.gather(-1, lab[:, None, :, None].expand(B, T, U1, 1))[..., 0] - lse
    return logits[..., blank] - lse, lp_label


def nll(lp_blank, lp_label, t_lens, u_lens):
    """Per-row NLL: alpha over anti-diagonals n = t + u."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    u = torch.arange(U1, device=dev)
    n_diag = T + U1 - 1
    n = torch.arange(n_diag, device=dev)
    t = n[:, None] - u[None, :]                               # (N, U1)
    ok = (t >= 0) & (t < T)
    tc = t.clamp(0, T - 1)
    valid_lab = u[None, :] < u_lens[:, None]                  # (B, U1)
    e = torch.where(valid_lab[:, None, :], lp_label, torch.full_like(lp_label, NEG))
    bs = torch.where(ok, lp_blank[:, tc, u[None, :]], torch.full_like(lp_blank[:, tc, u[None, :]], NEG))
    es = torch.where(ok, e[:, tc, u[None, :]], torch.full_like(bs, NEG))
    alpha = torch.full((B, U1), NEG, device=dev)
    alpha = torch.where(u[None, :] == 0, torch.zeros_like(alpha), alpha)
    finals = [alpha]
    for k in range(1, n_diag):
        stay = alpha + bs[:, k - 1]
        move = torch.cat([torch.full_like(alpha[:, :1], NEG), (alpha + es[:, k - 1])[:, :-1]], 1)
        alpha = torch.where(ok[k][None, :], torch.logaddexp(stay, move),
                            torch.full_like(alpha, NEG))
        finals.append(alpha)
    A = torch.stack(finals, 1)                                # (B, N, U1)
    rows = torch.arange(B, device=dev)
    last = (t_lens - 1 + u_lens).long()
    return -(A[rows, last, u_lens.long()] + bs[rows, last, u_lens.long()])


def lr_at(count: int, opt: dict) -> float:
    """The learning rate of the update after ``count`` updates: linear warmup
    over ``warmup_steps`` counting from 1, then a cosine to
    ``lr * min_lr_ratio`` over ``total_steps``."""
    s, w = count + 1, max(1, opt["warmup_steps"])
    if s <= w:
        return opt["lr"] * s / w
    prog = min(max((s - w) / max(1, opt["total_steps"] - w), 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * ((1 - r) * 0.5 * (1 + math.cos(math.pi * prog)) + r)


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, opt: dict) -> dict:
    """One clipped AdamW update of ``params`` in place; returns the clipped
    gradients.  ``state`` holds ``count``, ``mu`` and ``nu``."""
    norm_ = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = opt["clip"] / norm_ if norm_ >= opt["clip"] else 1.0
    count = state["count"] + 1
    b1, b2 = opt["b1"], opt["b2"]
    lr = lr_at(state["count"], opt)
    clipped = {}
    for k, p in params.items():
        g = (grads[k].double() * scale).float()
        clipped[k] = g
        mu = state["mu"].setdefault(k, torch.zeros_like(p))
        nu = state["nu"].setdefault(k, torch.zeros_like(p))
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g * g * (1 - b2))
        upd = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count)) + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
    state["count"] = count
    return clipped
