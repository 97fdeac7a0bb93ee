"""Plain float32 reference of a FastConformer-Transducer (NVIDIA's
parakeet-rnnt-0.6b: NeMo's ConformerEncoder with dw_striding subsampling,
an RNN-T decoder of plain LSTM layers and a ReLU joint), written from
NeMo's published equations and independent of the program under test.

Departures from NeMo, all of them the benchmark's settings: no dropout,
no dither and no SpecAugment (the cell trains without them); the
optimizer is the harness's AdamW (``common.adamw_step``) in place of
NeMo's Noam schedule; batch norm's running statistics are not followed
(the training forward reads batch statistics only).

* ``featurize``: pre-emphasis ``y[0] = x[0]``, ``y[n] = x[n] - 0.97
  x[n-1]``, samples at or past the row's length zeroed; frames of
  ``n_fft`` samples every ``hop`` after ``n_fft // 2`` zeros on both sides;
  a symmetric Hann window of ``win_length`` (``0.5 - 0.5 cos(2 pi n / (N -
  1))``) centred in the frame; the power of the real FFT; a Slaney-scale,
  Slaney-normalised triangular filterbank from 0 Hz to half the sample
  rate; ``log(x + 2**-24)``; per feature, the mean over the row's valid
  frames (``samples // hop + 1``) subtracted and (unbiased std + 1e-5)
  divided out, frames past the valid ones 0;
* ``encoder_out_len``: ``floor((L + 2 - 3) / 2) + 1``, once per stride-2
  stage;
* ``encoder``: the subsampling convolutions (3x3, stride 2, padding 1;
  ReLU; depthwise then pointwise), flattened channel-major and projected;
  ``x * sqrt(d)``; each layer ``r += FF1/2``, ``r += MHSA``, ``r += Conv``,
  ``r += FF2/2``, ``r = LN(r)`` with every sub-layer on ``LN(r)``.
  Attention by explicit products and softmax: ``ac = (q + u) k^T``, ``bd[i,
  j] = (q_i + v) . pos[(T - 1) - (i - j)]`` by indexing the projected table
  of relative positions ``T - 1 ... -(T - 1)``, scores ``(ac + bd) /
  sqrt(d_k)``, pairs with a padded query or key set to -10000 before the
  softmax and their weights to 0 after it.  The conv module: pointwise,
  GLU, padded frames 0, a depthwise convolution as a sum of shifted frames,
  batch statistics over every (row, frame) position, SiLU, pointwise.
  Each layer is checkpointed, so that the whole batch fits on one card;
* ``predictor``: the embedding (the blank's row a zero vector) through
  LSTM layers written as their gate equations (i, f, g, o; both biases);
* the joint ``out(relu(audio_proj(a) + text_proj(t)))`` in blocks of rows,
  and the lattice's NLL of ``common.py``.

Parameters are read by the program's names: 2-D convolution weights are
(9, Cin / groups, Cout) with tap ``3 kh + kw``; linear weights (in, out);
depthwise conv weights (K, 1, C).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import lattice_log_probs, layer_norm, linear, nll, q

PREEMPH = 0.97
LOG_GUARD = 2.0 ** -24
STD_EPS = 1e-5
BN_EPS = 1e-5
MASKED = -10000.0
JOINT_ROWS = 8


def num_frames(samples, fz: dict):
    return samples // fz["hop_length"] + 1


def slaney_filterbank(fz: dict, device) -> torch.Tensor:
    """(n_fft // 2 + 1, num_mels): mel m(f) = 3 f / 200 below 1000 Hz and
    15 + 27 ln(f / 1000) / ln(6.4) above; num_mels + 2 points evenly spaced
    in mel from 0 to sr / 2; triangle k rises from point k to 1 at point
    k + 1 and falls to 0 at point k + 2, times 2 / (f[k + 2] - f[k])."""
    sr, bins, mels = fz["sample_rate"], fz["n_fft"] // 2 + 1, fz["num_mels"]
    brk = 15.0
    step = 27.0 / math.log(6.4)

    def mel(f):
        return 3.0 * f / 200.0 if f < 1000.0 else brk + step * math.log(f / 1000.0)

    def hz(m):
        return 200.0 * m / 3.0 if m < brk else 1000.0 * math.exp((m - brk) / step)

    top = mel(sr / 2.0)
    pts = [hz(top * i / (mels + 1)) for i in range(mels + 2)]
    fb = np.zeros((bins, mels), np.float64)
    for b in range(bins):
        f = b * (sr / 2.0) / (bins - 1)
        for k in range(mels):
            lo, mid, hi = pts[k], pts[k + 1], pts[k + 2]
            w = min((f - lo) / (mid - lo), (hi - f) / (hi - mid))
            fb[b, k] = max(w, 0.0) * 2.0 / (hi - lo)
    return torch.tensor(fb, dtype=torch.float32, device=device)


def featurize(wave: torch.Tensor, lens: torch.Tensor, fz: dict) -> torch.Tensor:
    """wave (B, L) float32, lens (B,) samples -> (B, frames, num_mels)."""
    n_fft, hop, win = fz["n_fft"], fz["hop_length"], fz["win_length"]
    B, L = wave.shape
    dev = wave.device
    shifted = torch.zeros_like(wave)
    shifted[:, 1:] = wave[:, :-1]
    y = wave - PREEMPH * shifted
    y = y * (torch.arange(L, device=dev)[None, :] < lens[:, None]).float()
    y = torch.cat([torch.zeros((B, n_fft // 2), device=dev), y,
                   torch.zeros((B, n_fft // 2), device=dev)], dim=1)
    frames = y.unfold(-1, n_fft, hop)                       # (B, N, n_fft)
    n = torch.arange(win, dtype=torch.float64, device=dev)
    window = torch.zeros(n_fft, dtype=torch.float64, device=dev)
    left = (n_fft - win) // 2
    window[left:left + win] = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (win - 1))
    spec = torch.fft.rfft(frames * window.float(), n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    feats = torch.log(torch.matmul(power, slaney_filterbank(fz, dev)) + LOG_GUARD)
    count = num_frames(lens, fz)
    valid = (torch.arange(feats.shape[1], device=dev)[None, :] < count[:, None]).float()
    valid = valid[:, :, None]
    k = count.float()[:, None, None]
    mean = (feats * valid).sum(dim=1, keepdim=True) / k
    std = torch.sqrt((((feats - mean) * valid) ** 2).sum(dim=1, keepdim=True) / (k - 1))
    return (feats - mean) / (std + STD_EPS) * valid


def encoder_out_len(frames, model: dict):
    n = frames
    for _ in range(int(round(math.log2(model["encoder"]["subsampling_factor"])))):
        n = (n + 2 - 3) // 2 + 1
    return n


def conv3x3(x, w, b, groups: int, quant=None):
    """x (B, Cin, T, F), w (9, Cin / groups, Cout) -> stride 2, padding 1."""
    cout = w.shape[2]
    kernel = w.permute(2, 1, 0).reshape(cout, w.shape[1], 3, 3)
    return F.conv2d(q(x, quant), q(kernel, quant), b, stride=2, padding=1, groups=groups)


def subsample(P, enc: dict, x, quant=None):
    p = "encoder.pre_encode"
    x = torch.relu(conv3x3(x[:, None], P[f"{p}.conv0.w"], P[f"{p}.conv0.b"], 1, quant))
    i = 0
    while f"{p}.dw.{i}.w" in P:
        x = conv3x3(x, P[f"{p}.dw.{i}.w"], P[f"{p}.dw.{i}.b"], x.shape[1], quant)
        x = torch.einsum("bctf,cd->bdtf", q(x, quant), q(P[f"{p}.pw.{i}.w"], quant))
        x = torch.relu(x + P[f"{p}.pw.{i}.b"][None, :, None, None])
        i += 1
    B, C, T, Fr = x.shape
    x = x.permute(0, 2, 1, 3).reshape(B, T, C * Fr)
    return linear(x, P[f"{p}.out.w"], P[f"{p}.out.b"], quant)


def positions(T: int, d: int, device) -> torch.Tensor:
    """(2T - 1, d): row p is relative position T - 1 - p."""
    rel = torch.arange(T - 1, -T, -1, dtype=torch.float64, device=device)
    i = torch.arange(d // 2, dtype=torch.float64, device=device)
    angle = rel[:, None] / torch.pow(10000.0, 2.0 * i / d)[None, :]
    pe = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(2 * T - 1, d)
    return pe.float()


def silu(x):
    return x * torch.sigmoid(x)


def feed_forward(P, p: str, x, quant):
    h = silu(linear(x, P[f"{p}.lin1.w"], P[f"{p}.lin1.b"], quant))
    return linear(h, P[f"{p}.lin2.w"], P[f"{p}.lin2.b"], quant)


def attention(P, p: str, x, pe, valid, heads: int, quant):
    B, T, d = x.shape
    dk = d // heads

    def split(t):
        return t.reshape(t.shape[0], -1, heads, dk).transpose(1, 2)

    qh = split(linear(x, P[f"{p}.q.w"], P[f"{p}.q.b"], quant))
    kh = split(linear(x, P[f"{p}.k.w"], P[f"{p}.k.b"], quant))
    vh = split(linear(x, P[f"{p}.v.w"], P[f"{p}.v.b"], quant))
    ph = split(linear(pe[None], P[f"{p}.pos.w"], None, quant))[0]       # (H, 2T-1, dk)
    qu = qh + P[f"{p}.pos_u.bias"][None, :, None, :]
    qv = qh + P[f"{p}.pos_v.bias"][None, :, None, :]
    ac = torch.matmul(q(qu, quant), q(kh, quant).transpose(-1, -2))
    full = torch.matmul(q(qv, quant), q(ph, quant).transpose(-1, -2))  # (B, H, T, 2T-1)
    i = torch.arange(T, device=x.device)
    index = (T - 1) - (i[:, None] - i[None, :])                        # (T, T)
    bd = torch.gather(full, -1, index[None, None].expand(B, heads, T, T))
    pair = (valid[:, :, None] & valid[:, None, :])[:, None]
    scores = ((ac + bd) / math.sqrt(dk)).masked_fill(~pair, MASKED)
    weights = torch.softmax(scores, dim=-1).masked_fill(~pair, 0.0)
    out = torch.matmul(q(weights, quant), q(vh, quant))
    out = out.transpose(1, 2).reshape(B, T, d)
    return linear(out, P[f"{p}.out.w"], P[f"{p}.out.b"], quant)


def conv_module(P, p: str, x, valid, quant):
    h = linear(x, P[f"{p}.pw1.w"], P[f"{p}.pw1.b"], quant)
    d = h.shape[-1] // 2
    h = h[..., :d] * torch.sigmoid(h[..., d:]) * valid[:, :, None].float()
    w = q(P[f"{p}.dw.w"], quant)                                      # (K, 1, d)
    K = w.shape[0]
    T = h.shape[1]
    hp = F.pad(q(h, quant), (0, 0, (K - 1) // 2, (K - 1) // 2))
    y = sum(hp[:, k:k + T] * w[k, 0] for k in range(K)) + P[f"{p}.dw.b"]
    m = y.mean(dim=(0, 1))
    v = ((y - m) ** 2).mean(dim=(0, 1))
    y = (y - m) / torch.sqrt(v + BN_EPS) * P[f"{p}.norm.scale"] + P[f"{p}.norm.bias"]
    return linear(silu(y), P[f"{p}.pw2.w"], P[f"{p}.pw2.b"], quant)


def layer(P, p: str, r, pe, valid, heads: int, quant):
    r = r + 0.5 * feed_forward(P, f"{p}.ff1", layer_norm(r, P, f"{p}.norm_ff1"), quant)
    r = r + attention(P, f"{p}.att", layer_norm(r, P, f"{p}.norm_att"), pe, valid, heads,
                      quant)
    r = r + conv_module(P, f"{p}.conv", layer_norm(r, P, f"{p}.norm_conv"), valid, quant)
    r = r + 0.5 * feed_forward(P, f"{p}.ff2", layer_norm(r, P, f"{p}.norm_ff2"), quant)
    return layer_norm(r, P, f"{p}.norm_out")


def encoder(P, enc: dict, feats, frames, quant=None):
    x = subsample(P, enc, feats, quant)
    B, T, d = x.shape
    t_lens = encoder_out_len(frames, {"encoder": enc})
    valid = torch.arange(T, device=x.device)[None, :] < t_lens[:, None]
    r = x * math.sqrt(d) if enc["xscaling"] else x
    pe = positions(T, d, x.device)
    for i in range(enc["num_layers"]):
        r = checkpoint(layer, P, f"encoder.layers.{i}", r, pe, valid, enc["num_heads"], quant,
                       use_reentrant=False)
    return r


def predictor(P, pred: dict, tokens, blank: int, quant=None):
    """tokens (B, U) -> (B, U + 1, hidden) over [blank] + tokens."""
    col = torch.full((tokens.shape[0], 1), blank, dtype=torch.long, device=tokens.device)
    full = torch.cat([col, tokens.long()], dim=1)
    x = P["predictor.embedding"][full] * (full != blank)[..., None].float()
    H = pred["lstm_hidden_dim"]
    for i in range(pred["num_lstm_layers"]):
        p = f"predictor.layers.{i}"
        h = c = torch.zeros((x.shape[0], H), device=x.device)
        gx = linear(x, P[f"{p}.x2g.w"], P[f"{p}.x2g.b"], quant)
        outs = []
        for u in range(x.shape[1]):
            g = gx[:, u] + linear(h, P[f"{p}.p2g.w"], P[f"{p}.p2g.b"], quant)
            ig, fg, gg, og = g.split(H, dim=-1)
            c = torch.sigmoid(fg) * c + torch.sigmoid(ig) * torch.tanh(gg)
            h = torch.sigmoid(og) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, dim=1)
    return x


def joint_nll(P, audio, text, targets, t_lens, u_lens, blank: int, quant):
    a = linear(audio, P["joint.audio_proj.w"], P["joint.audio_proj.b"], quant)
    t = linear(text, P["joint.text_proj.w"], P["joint.text_proj.b"], quant)
    h = torch.relu(a[:, :, None, :] + t[:, None, :, :])
    logits = linear(h, P["joint.out.w"], P["joint.out.b"], quant)
    return nll(*lattice_log_probs(logits, targets.long(), blank), t_lens, u_lens)


def rows_nll(P, model: dict, wave, lens, targets, target_lens, quant=None):
    """wave (B, L) float32 (the int16 wire rows over their scale), lens (B,)
    samples, targets (B, U), target_lens (B,) -> each row's NLL (B,).  The
    whole batch goes through the encoder together: batch norm's statistics
    couple its rows."""
    blank = model["num_total_symbols"] - 1
    frames = num_frames(lens, model["featurizer"])
    t_lens = encoder_out_len(frames, model)
    audio = encoder(P, model["encoder"], featurize(wave, lens, model["featurizer"]), frames,
                    quant)
    text = predictor(P, model["predictor"], targets, blank, quant)
    out = []
    for s in range(0, audio.shape[0], JOINT_ROWS):
        rows = slice(s, s + JOINT_ROWS)
        out.append(checkpoint(joint_nll, P, audio[rows], text[rows], targets[rows],
                              t_lens[rows], target_lens[rows], blank, quant,
                              use_reentrant=False))
    return torch.cat(out)
