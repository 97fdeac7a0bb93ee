"""The plain pieces every architecture's reference shares (float32).

It reads the configuration's ``model`` block (``benchmark/configs``) and a
dict of parameters by their dotted names, and computes:

* ``featurize``: frames of ``n_fft`` samples every ``hop`` samples (with
  ``center``, after a reflect pad of ``n_fft // 2`` on both sides), a
  periodic Hann window of ``win_length`` centred in the frame, the power of
  the real FFT, for ``mel`` the product with an HTK-scale triangular
  filterbank (torchaudio ``MelSpectrogram``'s defaults: 0 Hz to half the
  sample rate, no area normalization), and the configured log compression
  (``spectrogram``: log above 0.01 and the continuing line of slope 50
  below; ``old_piecewise`` and ``mel``: the power times 32767^2, log above
  e and divided by e below), then ``(x - mean) * invstddev``;
* ``num_frames``: the frames of an utterance of so many samples;
* ``predictor``: over blank-prepended targets, an embedding and a layer
  norm, then either causal convolutions of 3 and 5 with GELU (``conv``) or
  LSTM layers (``lstm``: ``x2g`` over the whole sequence, ``p2g`` on the
  carried output each step; with layer norm, ``x2g`` has no bias, a layer
  norm over all four gates before the i, f, c, o split and one over the
  new cell, which is carried), then a linear layer and a layer norm;
* ``joint_logits``: ``out(tanh(audio_t + text_u))``, blank the last class;
* ``nll``: the exact transducer NLL by the alpha recursion, one
  anti-diagonal at a time, differentiable by autograd;
* ``adamw_step``: clip by the global norm, then AdamW with bias
  correction by the update count, eps outside the square root, decoupled
  weight decay and the warmup-cosine learning rate.

``quant`` ("bf16" or "fp8") rounds both operands of every product and
convolution to that type and back, everything else staying float32: the
lower-precision controls.  Dropout is not modelled: the benchmark turns it
off.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG = -1e30
EPS = 1e-5
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


def mel_filterbank(fz: dict, device) -> torch.Tensor:
    """(n_fft // 2 + 1, num_mels) float32: triangles evenly spaced on the
    HTK mel scale, m = 2595 log10(1 + f / 700), from 0 Hz to half the
    sample rate, each rising from its left neighbour's centre to 1 at its
    own and falling to 0 at its right neighbour's."""
    bins, sr = fz["n_fft"] // 2 + 1, fz["sample_rate"]
    freqs = torch.linspace(0.0, float(sr // 2), bins, dtype=torch.float64)
    top = 2595.0 * math.log10(1.0 + (sr / 2.0) / 700.0)
    pts = 700.0 * (10.0 ** (torch.linspace(0.0, top, fz["num_mels"] + 2,
                                           dtype=torch.float64) / 2595.0) - 1.0)
    lo, mid, hi = pts[:-2], pts[1:-1], pts[2:]
    rise = (freqs[:, None] - lo) / (mid - lo)
    fall = (hi - freqs[:, None]) / (hi - mid)
    return torch.minimum(rise, fall).clamp(min=0.0).float().to(device)


def featurize(wave: torch.Tensor, fz: dict) -> torch.Tensor:
    """wave (B, L) float32 -> (B, frames, bins): ``n_fft // 2 + 1`` bins,
    or ``num_mels`` for ``mel``."""
    n_fft, hop, win = fz["n_fft"], fz["hop_length"], fz["win_length"]
    if fz["center"]:
        wave = F.pad(wave[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = wave.unfold(-1, n_fft, hop)
    n = torch.arange(win, device=wave.device, dtype=torch.float64)
    hann = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win))
    window = torch.zeros(n_fft, dtype=torch.float64, device=wave.device)
    left = (n_fft - win) // 2
    window[left:left + win] = hann
    spec = torch.fft.rfft(frames * window.float(), n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    if fz["kind"] == "mel":
        power = torch.matmul(power, mel_filterbank(fz, wave.device))
    if fz["kind"] == "spectrogram":
        cutoff, slope = 10e-3, 50.0
        feats = torch.where(power > cutoff, torch.log(power.clamp(min=cutoff)),
                            slope * power + (math.log(cutoff) - slope * cutoff))
    elif fz["kind"] in ("old_piecewise", "mel"):
        x = (power + 1e-6) * 32767.0 ** 2
        feats = torch.where(x > math.e, torch.log(x.clamp(min=math.e)), x / math.e)
    else:
        raise ValueError(f"featurizer kind {fz['kind']!r} is not modelled")
    mean = torch.as_tensor(fz["mean"], dtype=torch.float32, device=wave.device)
    inv = torch.as_tensor(fz["invstddev"], dtype=torch.float32, device=wave.device)
    return (feats - mean) * inv


def num_frames(samples, fz: dict):
    if fz["center"]:
        return samples // fz["hop_length"] + 1
    return (samples - fz["n_fft"]) // fz["hop_length"] + 1


def conv(x, w, b, k, s=1, d=1, look=0, quant=None):
    """x (B, T, Cin), w (K, Cin, Cout) -> (B, T', Cout), causal."""
    pad = (k - 1) * d - s + 1 - look
    y = F.conv1d(F.pad(q(x, quant).transpose(1, 2), (pad, 0)),
                 q(w, quant).permute(2, 1, 0), stride=s, dilation=d)
    return y.transpose(1, 2) + b


def linear(x, w, b, quant=None):
    y = torch.matmul(q(x, quant), q(w, quant))
    return y if b is None else y + b


def layer_norm(x, P, name):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + EPS) * P[f"{name}.scale"] + P[f"{name}.bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def lstm_layer(P, p: str, x, hidden: int, normed: bool, quant=None):
    """One LSTM layer ``p`` over x (B, U, D) from a zero state -> (B, U, hidden)."""
    gated = linear(x, P[f"{p}.x2g.w"], P.get(f"{p}.x2g.b"), quant)
    h = c = torch.zeros((x.shape[0], hidden), device=x.device)
    hs = []
    for u in range(x.shape[1]):
        gates = gated[:, u] + linear(h, P[f"{p}.p2g.w"], None, quant)
        if normed:
            gates = layer_norm(gates, P, f"{p}.g_norm")
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        if normed:
            c = layer_norm(c, P, f"{p}.c_norm")
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def predictor(P, pred: dict, tokens, blank: int, quant=None):
    """tokens (B, U) -> (B, U+1, output_dim) over [blank] + tokens, by the
    configuration's ``predictor.kind``."""
    col = torch.full((tokens.shape[0], 1), blank, dtype=torch.long, device=tokens.device)
    full = torch.cat([col, tokens.long()], dim=1)
    x = layer_norm(P["predictor.embedding"][full], P, "predictor.input_ln")
    if pred["kind"] == "conv":
        x = gelu(conv(x, P["predictor.conv1.w"], P["predictor.conv1.b"], 3, quant=quant))
        x = gelu(conv(x, P["predictor.conv2.w"], P["predictor.conv2.b"], 5, quant=quant))
    elif pred["kind"] == "lstm":
        for i in range(pred["num_lstm_layers"]):
            x = lstm_layer(P, f"predictor.layers.{i}", x, pred["lstm_hidden_dim"],
                           pred["lstm_layer_norm"], quant)
    else:
        raise ValueError(f"predictor kind {pred['kind']!r} is not modelled")
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
