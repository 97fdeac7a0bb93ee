"""Batched greedy transducer decode, and the predictor stepper that greedy,
beam and streaming decode share.

Port of ``rnnt_tpu/decode/greedy.py``: a Python ``while`` loop over batched
tensor ops in place of ``lax.while_loop``.  Each lane carries its own frame
pointer; at most ``max_symbols_per_step`` (10) emissions per frame; blank
advances time.

* ``make_predictor_stepper`` (``_make_predictor_stepper``, ``:93-122``)
  returns (feat0, state0, step).  The conv predictor's state is a
  right-aligned 7-token window and its valid length; its step evaluates the
  window with valid (unpadded) convs, positions before the history starts
  zeroed after embedding + LayerNorm and after conv1 (the causal conv's
  zero left padding), so the feature equals the full-sequence predictor's.
  The LSTM predictor's state is its per-layer {"h", "c"}; its feat0 and
  state0 are one step of blank from the zero state.
* ``tree_map`` / ``tree_where`` map over such a state (nested tuples,
  lists and dicts of tensors): a lane takes the stepped state only where
  it emitted.
* Blank skip: each iteration scores W = 8 frames against the current
  predictor feature in one joint call and emits at the first non-blank
  frame or skips the window — the same tokens as W = 1, because the
  predictor state does not change across a run of blanks.
* ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does.
* ``greedy_decode_incremental`` takes and returns the cross-chunk carry
  (the predictor feature and state) that a streaming session keeps
  between chunks; ``greedy_decode`` is the same loop from the fresh carry
  of ``decode_init_carry``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rnnt_tpu_torch.models.joint import Joint, JointSpec, joint_window
from rnnt_tpu_torch.models.predictor import (
    ConvPredictor, ConvPredictorSpec, LSTMPredictorSpec)
from rnnt_tpu_torch.ops.causal_conv import conv1d_valid


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested tuples / lists / dicts (the
    structure of ``tree``; ``rest`` share it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_where(mask: torch.Tensor, new, old):
    """Per lane (the leading axis): ``new`` where ``mask`` (N,), else ``old``."""
    return tree_map(lambda a, b: torch.where(
        mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b), new, old)


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


def predictor_step(predictor, predictor_spec):
    """``step(state, token (N,)) -> (feat (N, D), new_state)``: every lane
    advanced by one token."""
    if isinstance(predictor_spec, ConvPredictorSpec):
        R = predictor_spec.receptive_field

        def step(state, token):
            window, valid = state
            window = torch.cat([window[:, 1:], token[:, None].long()], dim=1)
            valid = (valid + 1).clamp(max=R)
            return conv_window_features(predictor, window, valid), (window, valid)

        return step
    if isinstance(predictor_spec, LSTMPredictorSpec):
        def step(state, token):
            feats, new_state = predictor(token[:, None], state)
            return feats[:, 0], new_state

        return step
    raise TypeError(f"unknown predictor spec: {type(predictor_spec)}")


def make_predictor_stepper(predictor, predictor_spec, blank: int, batch: int,
                           device="cpu"):
    """(feat0 (batch, D), state0, step) with ``step`` of ``predictor_step``:
    the conv predictor's blank-only window, or one LSTM step of blank from
    the zero state (``rnnt_tpu/decode/greedy.py:112-117``)."""
    step = predictor_step(predictor, predictor_spec)
    if isinstance(predictor_spec, ConvPredictorSpec):
        R = predictor_spec.receptive_field
        window0 = torch.full((batch, R), blank, dtype=torch.long, device=device)
        valid0 = torch.ones((batch,), dtype=torch.long, device=device)
        return conv_window_features(predictor, window0, valid0), (window0, valid0), step
    blanks = torch.full((batch,), blank, dtype=torch.long, device=device)
    feat0, state0 = step(predictor.init_state(batch, device), blanks)
    return feat0, state0, step


def decode_init_carry(predictor, predictor_spec, joint_spec: JointSpec,
                      batch: int, device="cpu"):
    """The carry a stream starts from: (pred_feat (B, D), pred_state)."""
    feat0, state0, _ = make_predictor_stepper(
        predictor, predictor_spec, joint_spec.blank_idx, batch, device)
    return feat0, state0


def greedy_decode(predictor, joint: Joint, audio: torch.Tensor,
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


def greedy_decode_incremental(predictor, joint: Joint,
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
    blank = joint_spec.blank_idx
    pred_step = predictor_step(predictor, predictor_spec)
    if carry is None:
        carry = decode_init_carry(predictor, predictor_spec, joint_spec, B, dev)
    feat, state = carry
    W = max(1, min(frames_per_step, T))
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

        # The stepped predictor only matters where a lane emitted.
        stepped_feat, stepped_state = pred_step(state, tok)
        feat = torch.where(emit[:, None], stepped_feat, feat)
        state = tree_where(emit, stepped_state, state)

    return tokens, n.to(torch.int32), (feat, state)
