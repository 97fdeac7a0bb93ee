"""The vocabulary-sharded joints: K1 and K2, the chunked joint and the
simple joint on a rank's slice of V.

Port of ``rnnt_tpu/parallel/partition.py:107-211`` (the fused joint's batch
x vocab partitioning), of the V-sharded reading of
``rnnt_tpu/ops/transducer_pruned.py:55-104`` (the simple joint) and of
``rnnt_tpu/ops/transducer.py:210-289`` (the chunked joint, whose ``h W``
and logsumexp XLA splits over V).  JAX declares the first two as GSPMD
partitioning rules (``custom_partitioning``) and lets XLA split the third;
all three run in one jitted program.  Here every model rank runs its slice
and names the collectives over the model group itself.  Each rank holds
``joint.out`` and the simple heads as (H, V / m) and (V / m,) slices
starting at global id ``v0 = model_rank * V / m``
(``parallel/mesh.shard_params``), and the combines run on cheap (B, T, U1)
scalars:

* ``fused_joint_outputs_tp`` (an autograd Function): K1 on the slice (its
  label and blank ids counted only where the slice owns them); the partial
  lse merged by logsumexp (an all-reduce of the max, then of the summed
  ``exp(lse - max)``, JAX's ``_logsumexp_merge``); the blank and label
  logits summed (the slice that owns neither gives 0).  Backward: K2 on the
  slice with the merged lse, so its softmax is the global one; denc and
  dpred summed over the model group; dW and db stay the slice's.
* ``chunked_joint_log_probs_tp``: the chunked joint's body on the slice,
  chunk by chunk under ``torch.utils.checkpoint`` (the slice's lse, and
  its blank and label logits where it owns them), merged once on the
  whole (B, T, U1) tensors by the same ``logsumexp_merge``, outside the
  checkpoints: a recompute in backward issues no collective, and a loss
  makes two in forward whatever its chunks.  Autograd carries the
  backward: the merge hands each slice's logits the global softmax, and
  ``copy_to_model`` on the joint's inputs sums denc and dpred over the
  model group;
* ``simple_joint_log_probs_tp``: ``am`` and ``lm`` on the slice, the
  normalizer's per-row maxima all-reduced by max before the exponentials,
  ``z``'s partial sums and the label and blank logits (taken where the
  slice owns the id, the counterpart of JAX's one-hot einsums at
  ``:86-100``) summed in one all-reduce.

Every rank then holds the whole (B, T, U1) lattice, and K3 and K4 run on
it replicated, as XLA leaves the lattice DP after the partitioned joint.
"""

from __future__ import annotations

import torch

from rnnt_tpu_torch.ops.transducer import NEG, chunk_logits, run_chunks
from rnnt_tpu_torch.ops.transducer_pallas import (
    _slice_ids,
    check_blank,
    fused_joint_backward,
    fused_joint_forward,
)
from rnnt_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_max,
    all_reduce_sum,
    copy_to_model,
    reduce_from_model,
)


def slice_start(w: torch.Tensor, mesh: Mesh) -> int:
    """v0, the first global id of this rank's slice of a V-sharded (H, V/m)
    weight."""
    return mesh.model_rank * w.shape[-1]


def logsumexp_merge(lse: torch.Tensor, parts: list, mesh: Mesh):
    """(lse over every slice, each of ``parts`` summed over the slices):
    ``m + log(sum exp(lse - m))`` with m the slices' max, the sums in one
    all-reduce.  Differentiable: m is detached and the sums are
    ``reduce_from_model`` (identity backward), so this rank's lse receives
    ``exp(lse - merged)`` times the merged lse's gradient, and each part the
    sum's."""
    m = all_reduce_max(lse, mesh)
    both = reduce_from_model(torch.stack([torch.exp(lse - m), *parts]), mesh)
    return m + torch.log(both[0]), list(both[1:])


class FusedJointOutputsTP(torch.autograd.Function):
    """``FusedJointOutputs`` on this rank's vocabulary slice: the merged
    outputs forward, K2 with the merged lse backward (denc and dpred summed
    over the model group, dW and db the slice's)."""

    @staticmethod
    def forward(ctx, enc, pred, w, b, labels, blank, grad_clamp, mesh):
        check_blank(blank, w.shape[1] * mesh.model)
        v0 = slice_start(w, mesh)
        lse, blank_logit, label_logit = fused_joint_forward(enc, pred, w, b, labels, blank, v0)
        lse, (blank_logit, label_logit) = logsumexp_merge(lse, [blank_logit, label_logit], mesh)
        ctx.blank, ctx.grad_clamp, ctx.v0, ctx.mesh = blank, grad_clamp, v0, mesh
        ctx.save_for_backward(enc, pred, w, b, labels, lse)
        return lse, blank_logit, label_logit

    @staticmethod
    def backward(ctx, g_lse, g_blank, g_label):
        enc, pred, w, b, labels, lse = ctx.saved_tensors
        gs = [torch.zeros_like(lse) if g is None else g.float().contiguous()
              for g in (g_blank, g_label, g_lse)]
        denc, dpred, dw, db = fused_joint_backward(
            enc, pred, w, b, labels, ctx.blank, lse, *gs, ctx.grad_clamp, ctx.v0)
        flat = all_reduce_sum(torch.cat([denc.reshape(-1), dpred.reshape(-1)]),
                              ctx.mesh.model_group)
        denc, dpred = flat[:denc.numel()].view_as(denc), flat[denc.numel():].view_as(dpred)
        return (denc.to(enc.dtype), dpred.to(pred.dtype), dw.to(w.dtype),
                db.to(b.dtype), None, None, None, None)


def fused_joint_outputs_tp(enc, pred, w, b, labels, blank: int, grad_clamp: float,
                           mesh: Mesh):
    """(lse, blank_logit, label_logit), each (B, T, U1) float32 over the
    whole vocabulary, from this rank's slice w (H, V/m) and b (V/m,);
    enc and pred whole and alike on every model rank."""
    return FusedJointOutputsTP.apply(enc, pred, w, b, labels, blank, grad_clamp, mesh)


def _chunk_outputs_tp(enc_chunk, w, b, text, local, own, blank_col, grad_clamp: float):
    """``ops.transducer._joint_chunk_log_probs`` on a slice of V: (the
    slice's lse, the blank logit where the slice holds the blank, the label
    logit where it owns the id), each (B, Tc, U1) float32, 0 where the slice
    holds no such column."""
    logits = chunk_logits(enc_chunk, w, b, text, grad_clamp)
    B, Tc, U1, _ = logits.shape
    label = torch.gather(logits, 3, local[:, None, :, None].expand(B, Tc, U1, 1))[..., 0]
    zero = logits.new_zeros(())
    return (torch.logsumexp(logits, dim=-1),
            logits[..., blank_col] if blank_col is not None else zero.expand(B, Tc, U1),
            torch.where(own[:, None, :], label, zero))


def chunked_joint_log_probs_tp(w, b, audio, text, targets, u_lens, blank: int,
                               chunk_size: int, grad_clamp: float, mesh: Mesh):
    """(lp_blank, lp_label), both (B, T, U1) float32 over the whole
    vocabulary, from this rank's slice w (H, V/m) and b (V/m,) evaluated
    ``chunk_size`` frames at a time; audio (B, T, H) and text (B, U1, H)
    side-projected, whole and alike on every model rank; targets (B, U)."""
    check_blank(blank, w.shape[1] * mesh.model)
    audio, text = copy_to_model(audio, mesh), copy_to_model(text, mesh)
    B, U1 = text.shape[:2]
    tgt = torch.cat([targets, targets.new_zeros((B, 1))], dim=1)
    local, own, blank_col = _slice_ids(tgt, blank, slice_start(w, mesh), w.shape[1])
    lse, blank_logit, label_logit = run_chunks(_chunk_outputs_tp, audio, chunk_size, w, b,
                                               text, local, own, blank_col, grad_clamp)
    lse, (blank_logit, label_logit) = logsumexp_merge(lse, [blank_logit, label_logit], mesh)
    u_mask = torch.arange(U1, device=audio.device)[None, :] < u_lens[:, None]
    return blank_logit - lse, torch.where(u_mask[:, None, :], label_logit - lse,
                                          torch.full_like(lse, NEG))


def simple_joint_log_probs_tp(simple, audio, text, targets, u_lens, blank: int,
                              mesh: Mesh):
    """``ops.transducer_pruned.simple_joint_log_probs`` with ``simple``'s
    heads holding this rank's slice of V; audio and text whole and alike
    on every model rank."""
    from rnnt_tpu_torch.ops.transducer_pruned import simple_log_probs

    audio, text = copy_to_model(audio, mesh), copy_to_model(text, mesh)
    am = audio.float() @ simple["am"].w.float() + simple["am"].b.float()
    lm = text.float() @ simple["lm"].w.float() + simple["lm"].b.float()
    am_max = all_reduce_max(am.amax(dim=-1), mesh)
    lm_max = all_reduce_max(lm.amax(dim=-1), mesh)
    pa = torch.exp(am - am_max[..., None])
    pl = torch.exp(lm - lm_max[..., None])
    B, T, V = am.shape
    U1 = text.shape[1]
    tgt = torch.cat([targets, targets.new_zeros((B, 1))], dim=1)
    local, own, blank_col = _slice_ids(tgt, blank, slice_start(simple["am"].w, mesh), V)
    zero = am.new_zeros(())
    am_lbl = torch.where(own[:, None, :], torch.gather(
        am, 2, local[:, None, :].expand(B, T, U1)), zero)
    lm_lbl = torch.where(own, torch.gather(lm, 2, local[:, :, None])[..., 0], zero)
    am_blank = am[..., blank_col] if blank_col is not None else zero.expand(B, T)
    lm_blank = lm[..., blank_col] if blank_col is not None else zero.expand(B, U1)
    parts = [torch.einsum("btv,buv->btu", pa, pl), am_lbl, lm_lbl, am_blank, lm_blank]
    flat = reduce_from_model(torch.cat([x.reshape(-1) for x in parts]), mesh)
    z, am_lbl, lm_lbl, am_blank, lm_blank = (
        x.view_as(p) for x, p in zip(flat.split([p.numel() for p in parts]), parts))
    z = torch.log(z + 1e-30) + am_max[:, :, None] + lm_max[:, None, :]
    return simple_log_probs(z, am_lbl, lm_lbl, am_blank, lm_blank, u_lens)
