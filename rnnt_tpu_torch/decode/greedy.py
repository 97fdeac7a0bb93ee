"""Batched greedy transducer decode with the conv predictor.

Port of ``rnnt_tpu/decode/greedy.py`` (conv predictor): a Python ``while``
loop over batched tensor ops in place of ``lax.while_loop``.  Each lane
carries its own frame pointer; at most ``max_symbols_per_step`` (10)
emissions per frame; blank advances time.

* The predictor step evaluates a right-aligned 7-token window with valid
  (unpadded) convs; positions before the history starts are zeroed after
  embedding + LayerNorm and after conv1, reproducing the causal conv's zero
  left padding, so the feature equals the full-sequence predictor's.
* Blank skip: each iteration scores W = 8 frames against the current
  predictor feature in one joint call and emits at the first non-blank
  frame or skips the window — the same tokens as W = 1, because the
  predictor state does not change across a run of blanks.
* ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does.
* ``greedy_decode_incremental`` takes and returns the cross-chunk carry
  (the predictor feature and its token window) that a streaming session
  keeps between chunks; ``greedy_decode`` is the same loop from the fresh
  carry of ``decode_init_carry``.

The LSTM predictor's stepper is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnnt_tpu_torch.models.joint import Joint, JointSpec, joint_window
from rnnt_tpu_torch.models.predictor import ConvPredictor, ConvPredictorSpec
from rnnt_tpu_torch.ops.causal_conv import conv1d_valid


def conv_window_features(pred: ConvPredictor, window: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Feature (B, D) at the last position of a right-aligned token window
    (B, R); ``valid`` (B,) counts the real trailing positions (>= 1)."""
    R = pred.spec.receptive_field
    x = pred.input_ln(pred.embedding[window])

    def seq_mask(xx, offset):
        pos = offset + torch.arange(xx.shape[1], device=xx.device)
        keep = pos[None, :] >= (R - valid[:, None])
        return torch.where(keep[:, :, None], xx, torch.zeros_like(xx))

    x = seq_mask(x, 0)
    x = F.gelu(conv1d_valid(pred.conv1.w, pred.conv1.b, x), approximate="none")
    x = seq_mask(x, 2)
    x = F.gelu(conv1d_valid(pred.conv2.w, pred.conv2.b, x), approximate="none")
    return pred.output_ln(pred.linear(x[:, -1, :]))


def decode_init_carry(predictor: ConvPredictor, predictor_spec,
                      joint_spec: JointSpec, batch: int, device="cpu"):
    """The carry a stream starts from: (pred_feat (B, D), (window (B, R),
    valid (B,))) — the blank-only window's feature and its state."""
    if not isinstance(predictor_spec, ConvPredictorSpec):
        raise NotImplementedError(
            "greedy decode with an LSTM predictor is not ported yet")
    R = predictor_spec.receptive_field
    window = torch.full((batch, R), joint_spec.blank_idx, dtype=torch.long,
                        device=device)
    valid = torch.ones((batch,), dtype=torch.long, device=device)
    return conv_window_features(predictor, window, valid), (window, valid)


def greedy_decode(predictor: ConvPredictor, joint: Joint, audio: torch.Tensor,
                  t_lens: torch.Tensor, predictor_spec, joint_spec: JointSpec,
                  *, max_tokens: int = 200, max_symbols_per_step: int = 10,
                  carry=None, frames_per_step: int = 8):
    """audio (B, T, H) encoder output, t_lens (B,) -> (tokens (B, max_tokens)
    int32, counts (B,) int32); tokens[b, :counts[b]] is the hypothesis."""
    tokens, counts, _ = greedy_decode_incremental(
        predictor, joint, audio, t_lens, predictor_spec, joint_spec,
        max_tokens=max_tokens, max_symbols_per_step=max_symbols_per_step,
        carry=carry, frames_per_step=frames_per_step)
    return tokens, counts


def greedy_decode_incremental(predictor: ConvPredictor, joint: Joint,
                              audio: torch.Tensor, t_lens: torch.Tensor,
                              predictor_spec, joint_spec: JointSpec, *,
                              max_tokens: int = 200,
                              max_symbols_per_step: int = 10, carry=None,
                              frames_per_step: int = 8):
    """``greedy_decode`` that starts from ``carry`` (``decode_init_carry``
    when None) and also returns the carry after this chunk, so a stream
    continues where the chunk left off: (tokens, counts, carry)."""
    B, T, _ = audio.shape
    dev = audio.device
    if carry is None:
        carry = decode_init_carry(predictor, predictor_spec, joint_spec, B, dev)
    feat, (window, valid) = carry
    W = max(1, min(frames_per_step, T))
    blank = joint_spec.blank_idx
    R = predictor_spec.receptive_field
    rows = torch.arange(B, device=dev)
    offs = torch.arange(W, device=dev)
    t_lens = t_lens.long()

    t = torch.zeros((B,), dtype=torch.long, device=dev)
    n = torch.zeros_like(t)
    emits = torch.zeros_like(t)
    tokens = torch.full((B, max_tokens), blank, dtype=torch.int32, device=dev)

    while True:
        act = (t < t_lens) & (n < max_tokens)
        if not bool(act.any()):
            break
        pos = t[:, None] + offs[None, :]                              # (B, W)
        frames = audio[rows[:, None], pos.clamp(0, T - 1)]            # (B, W, H)
        tok_w = joint_window(joint, frames, feat).argmax(dim=-1)      # (B, W)

        # Frames past t_len act as blank; the per-frame cap forces the
        # current frame (w = 0) blank once reached.
        is_blank = (tok_w == blank) | (pos >= t_lens[:, None])
        is_blank[:, 0] |= emits >= max_symbols_per_step
        nonblank = ~is_blank
        all_blank = ~nonblank.any(dim=1)
        p = nonblank.to(torch.int32).argmax(dim=1).long()
        tok = tok_w.gather(1, p[:, None])[:, 0]

        emit = act & ~all_blank
        slot = n.clamp(0, max_tokens - 1)
        tokens[rows, slot] = torch.where(emit, tok.to(torch.int32),
                                         tokens[rows, slot])
        n = torch.where(emit, n + 1, n)
        emits = torch.where(emit, torch.where(p == 0, emits + 1, 1), 0)
        t = torch.where(emit, t + p, t + W)

        new_window = torch.cat([window[:, 1:], tok[:, None]], dim=1)
        new_valid = (valid + 1).clamp(max=R)
        stepped = conv_window_features(predictor, new_window, new_valid)
        feat = torch.where(emit[:, None], stepped, feat)
        window = torch.where(emit[:, None], new_window, window)
        valid = torch.where(emit, new_valid, valid)

    return tokens, n.to(torch.int32), (feat, (window, valid))
