"""Plain float32 reference of the Jasper-encoder RNN-T (jakepoz/rnnt's
causal-convolution encoder), with the predictor and front end its
configuration names (``common.py``).

* ``encoder``: causal convolutions (left pad ``(k-1)d - s + 1`` less the
  block's lookahead), norms over the time axis (instance, padding
  included) or by running statistics (batch), exact GELU, a 1x1 residual
  added before each block's last activation and cut to its surviving
  frames, a dilated epilogue and a 1x1 output;
* ``encoder_out_len``: the encoder's output frames for so many input
  frames;
* ``rows_nll``: a block of rows' waves to each row's NLL, through the
  featurizer, the encoder, the predictor, the joint and the lattice.

Training-mode batch norm is not modelled (the training cells'
configurations use instance norms).
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (
    EPS, conv, featurize, gelu, joint_logits, lattice_log_probs, linear, nll, num_frames,
    predictor)


def norm(x, P, name, kind):
    if kind == "batch":
        y = (x - P[f"{name}.mean"]) / torch.sqrt(P[f"{name}.var"] + EPS)
        return y * P[f"{name}.scale"] + P[f"{name}.bias"]
    m = x.mean(dim=1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=1, keepdim=True)
    y = (x - m) / torch.sqrt(v + EPS)
    if kind == "instance_affine":
        y = y * P[f"{name}.scale"] + P[f"{name}.bias"]
    return y


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


def encoder_out_len(frames, model: dict):
    def out(n, k, s, d, look):
        return (n + (k - 1) * d - s + 1 - look - d * (k - 1) - 1) // s + 1

    enc = model["encoder"]
    n = out(frames, enc["prologue_kernel_size"], enc["prologue_stride"],
            enc.get("prologue_dilation", 1), 0)
    for blk in enc["blocks"]:
        for _ in range(blk["num_sub_blocks"]):
            n = out(n, blk["kernel_size"], 1, 1, blk.get("additional_context", 0))
    return out(n, enc["epilogue_kernel_size"], enc.get("epilogue_stride", 1),
               enc.get("epilogue_dilation", 2), 0)


def rows_nll(P, model: dict, wave, lens, targets, target_lens, quant=None):
    """wave (B, L) float32 (the int16 wire rows over their scale), lens (B,)
    samples, targets (B, U), target_lens (B,) -> each row's NLL (B,)."""
    blank = model["num_total_symbols"] - 1
    t_lens = encoder_out_len(num_frames(lens, model["featurizer"]), model)
    audio = encoder(P, model["encoder"], featurize(wave, model["featurizer"]), quant)
    text = predictor(P, model["predictor"], targets, blank, quant)
    lp_b, lp_l = lattice_log_probs(joint_logits(P, audio, text, quant), targets.long(), blank)
    return nll(lp_b, lp_l, t_lens, target_lens)
